"""The port's goldens on the CPU, mirroring the JAX package's
``tests/test_golden.py`` and ``tests/test_golden_md.py`` at their sizes,
iteration counts and thresholds (``isokann_tpu_torch.goldens`` holds the
exact reference solutions and the runs; ``chip_smoke.py`` runs the same
on the card).  Slow tier: ``python -m pytest -m slow
tests/test_torch_golden.py`` (~1-2 min on the CPU)."""

import numpy as np
import pytest
import torch

import isokann_tpu_torch as itt
from isokann_tpu_torch import goldens as G

pytestmark = pytest.mark.slow


@pytest.fixture(scope="module")
def doublewell():
    return G.doublewell_run("cpu")


def test_chi_matches_generator_eigenfunction(doublewell):
    _, r = doublewell
    assert r["vals"][0] == pytest.approx(1.0, abs=1e-6)
    assert 0.0 < r["vals"][1] < 1.0
    assert r["corr"] > 0.99, r


def test_koopman_eigenvalue_matches(doublewell):
    _, r = doublewell
    assert r["rate"] == pytest.approx(r["exact_rate"], rel=0.15), r


def test_chi_exit_rate_consistent(doublewell):
    _, r = doublewell
    assert np.isfinite(r["exit_rate"]) and r["exit_rate"] > 0


def test_save_load_and_girsanov_on_trained_doublewell(doublewell, tmp_path):
    iso, _ = doublewell
    iso.save(tmp_path / "dw.pt")
    loaded = itt.load(tmp_path / "dw.pt", device="cpu")
    assert torch.equal(loaded.chis(), iso.chis())
    loaded.run(5)
    itt.run_girsanov(loaded, generations=2, iter=10, kde=4, forcescale=0.5)
    assert [r["biased"] for r in loaded.girsanov_telemetry] == [True, True]
    ws = loaded.data.propfeatures
    assert isinstance(ws, itt.WeightedSamples)
    w = ws.weights[-8:].double().numpy().ravel()
    assert np.all(np.isfinite(w))
    assert abs(w.mean() - 1.0) < 4 * w.std() / np.sqrt(len(w))


def test_triplewell_multidim_subspace_golden():
    r = G.triplewell_run("cpu")
    assert r["R2"] >= 0.95 and r["R3"] >= 0.95, r
    assert r["rowsum_mean"] == pytest.approx(1.0, abs=0.05)
    assert r["rowsum_std"] < 0.1
    assert sorted(r["wells"]) == [0, 1, 2], r


def test_mueller_brown_chi_matches_eigenfunction():
    r = G.mueller_brown_run("cpu")
    assert r > 0.98, f"MB chi correlation {r:.4f}"


def test_chi_trains_to_msm_eigenfunction():
    corr, frac = G.md_chi_run("cpu")
    assert frac > 0.95
    assert corr >= 0.98, corr


def test_fresh_dynamics_reproduce_eigenfunction():
    r = G.md_fresh_run("cpu")
    assert r["frac"] > 0.9
    assert r["corr"] >= 0.97, r
    assert r["t_fresh"] > r["t_gold"] / 15.0, r
