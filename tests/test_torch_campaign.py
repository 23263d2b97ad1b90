"""The port's production tool (``tools/run_trpcage_production_torch.py``)
on the CPU, on alanine at a small nx and lag: the campaign's checkpoint
cadence and files, resume equal to the uninterrupted campaign bit for
bit, the telemetry keys of the JAX tool, the budget stop under a faked
clock, an adaptive-lag escalation through ``build_sim``, the whole
pilot -> sweep -> campaign -> analysis in one process with a relaunch
that resumes, and the tool's imports."""

import importlib.util
import json
import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import isokann_tpu as itk

import isokann_tpu_torch as itt
from isokann_tpu_torch import workflows as W

# small tensor ops: one intra-op thread each; several test workers
# share the machine and oversubscribed threads slow them 50x
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def tool():
    return _load("run_trpcage_production_torch", os.path.join(
        ROOT, "tools", "run_trpcage_production_torch.py"))


def _ala(steps):
    return itt.MDSimulation(steps=steps, device="cpu")


def _iso(steps=5):
    return itt.Iso(sim=_ala(steps), nx=4, nk=2, gen=0,
                   opt=itt.AdamRegularized())


ARGS = dict(iters=3, resamples=1, cutoff=2000)


def test_checkpoint_cadence_and_files(tool, tmp_path, monkeypatch):
    """``checkpoint_every=2`` over 5 generations: checkpoints after
    generations 2 and 4, each with the learner and ``done``,
    ``telemetry`` and ``lag_escalations``."""
    saved = []
    orig = tool.save_campaign

    def spy(iso, out, done, telemetry, results):
        saved.append(done)
        orig(iso, out, done, telemetry, results)

    monkeypatch.setattr(tool, "save_campaign", spy)
    tel = []
    _, done = tool.campaign(_iso(), 5, telemetry=tel, out=str(tmp_path),
                            checkpoint_every=2, **ARGS)
    assert done == 5 and saved == [2, 4] and len(tel) == 5
    assert sorted(os.listdir(tmp_path)) == ["campaign_checkpoint.pkl",
                                            "campaign_telemetry.json"]
    meta = json.loads((tmp_path / "campaign_telemetry.json").read_text())
    assert set(meta) == {"done", "telemetry", "lag_escalations"}
    assert meta["done"] == 4 and len(meta["telemetry"]) == 4
    iso, meta2 = tool.load_campaign(str(tmp_path), device="cpu")
    assert meta2 == meta and len(iso.data) == 4 + 4 * 1
    assert iso.data.sim.constructor["steps"] == 5


def test_resume_equals_uninterrupted(tool, tmp_path):
    """Three generations in one go against two, a checkpoint, a load and
    the third from ``start_gen``: the same data, chi, losses and
    telemetry, bit for bit (every draw comes from the learner's
    generator, whose state the checkpoint keeps)."""
    a, b = tmp_path / "a", tmp_path / "b"
    a.mkdir()
    b.mkdir()
    whole = _iso()
    tel_w = []
    tool.campaign(whole, 3, telemetry=tel_w, out=str(a), checkpoint_every=1,
                  **ARGS)
    first = _iso()
    tool.campaign(first, 2, telemetry=[], out=str(b), checkpoint_every=1,
                  **ARGS)
    del first
    iso, meta = tool.load_campaign(str(b), device="cpu")
    tel_r = meta["telemetry"]
    _, done = tool.campaign(iso, 3, telemetry=tel_r, out=str(b),
                            checkpoint_every=1, start_gen=meta["done"],
                            already_spent=tel_r[-1]["t_total"], **ARGS)
    assert done == 3
    assert torch.equal(iso.data.coords, whole.data.coords)
    assert torch.equal(iso.data.propcoords, whole.data.propcoords)
    assert torch.equal(iso.chis(), whole.chis())
    assert iso.losses == whole.losses
    strip = [{k: r[k] for k in ("gen", "n", "loss", "steps")}
             for r in tel_w]
    assert [{k: r[k] for k in ("gen", "n", "loss", "steps")}
            for r in tel_r] == strip
    assert iso.gen.get_state().equal(whole.gen.get_state())


def test_telemetry_keys_match_the_jax_tool(tool, tmp_path):
    """One generation of each tool's ``campaign`` on a Doublewell learner
    with a checkpoint: the same telemetry row keys and checkpoint keys."""
    jtool = _load("run_trpcage_production", os.path.join(
        ROOT, "tools", "run_trpcage_production.py"))
    jd, td = tmp_path / "jax", tmp_path / "port"
    jd.mkdir()
    td.mkdir()
    jtel, ttel = [], []
    jiso = itk.Iso(sim=itk.Doublewell(), nx=8, nk=2, key=0)
    jtool.campaign(jiso, 1, 2, 1, 2000, jtel, out=str(jd),
                   checkpoint_every=1)
    tiso = itt.Iso(sim=itt.Doublewell(device="cpu"), nx=8, nk=2, gen=0)
    tool.campaign(tiso, 1, 2, 1, 2000, ttel, out=str(td),
                  checkpoint_every=1)
    assert list(ttel[0]) == list(jtel[0])
    assert [type(ttel[0][k]) for k in ttel[0]] == [
        type(jtel[0][k]) for k in jtel[0]]
    jm = json.loads((jd / "campaign_telemetry.json").read_text())
    tm = json.loads((td / "campaign_telemetry.json").read_text())
    assert list(tm) == list(jm)
    assert sorted(os.listdir(td)) == sorted(os.listdir(jd))


@pytest.mark.parametrize("spent, want", [(0.0, 3), (15.0, 2)])
def test_budget_stop_under_a_faked_clock(tool, monkeypatch, spent, want):
    """Each generation takes 10 s of a faked clock and the budget is 35 s:
    the campaign stops once the time so far, the seconds already spent
    and the last generation's (the prediction of the next) pass it."""
    t = iter(range(0, 1000, 10))
    monkeypatch.setattr(tool, "time", SimpleNamespace(time=lambda: next(t)))
    iso = itt.Iso(sim=itt.Doublewell(device="cpu"), nx=8, nk=2, gen=0)
    tel = []
    _, done = tool.campaign(iso, 10, 2, 1, 2000, tel, budget_s=35.0,
                            already_spent=spent)
    assert done == want and len(tel) == want
    assert [r["t_gen"] for r in tel] == [10] * want


def test_adaptive_lag_escalates_through_build_sim(tool, monkeypatch):
    """With the training-lag eigenvalue above the headroom, every check
    escalates the lag by ``lag_factor`` through the tool's ``build_sim``
    (warm-started: the model is kept) until ``max_steps``; each
    escalation is recorded."""
    built = []

    def build(steps):
        built.append(steps)
        return _ala(steps)

    monkeypatch.setattr(tool, "build_sim", build)
    monkeypatch.setattr(W, "training_lag_headroom", lambda iso: 0.999)
    iso = _iso(5)
    model = iso.model
    results, tel = {}, []
    tool.campaign(iso, 4, telemetry=tel, adaptive_lag=True, check_every=1,
                  lag_factor=2, max_steps=20, results=results, **ARGS)
    assert built == [10, 20]
    assert [r["steps"] for r in tel] == [5, 10, 20, 20]
    assert results["lag_escalations"] == [
        dict(gen=1, eig=0.999, steps_from=5, steps_to=10),
        dict(gen=2, eig=0.999, steps_from=10, steps_to=20)]
    assert iso.data.sim.steps == 20 and iso.model is model


def test_main_runs_every_stage_and_a_relaunch_resumes(tool, tmp_path,
                                                      monkeypatch):
    """``main`` on a small alanine stand-in for trp-cage: the pilot, the
    sweep (rows on disk), the campaign with checkpoints, the analysis and
    the plots; a relaunch into the same ``--out``
    reuses the pilot and the sweep rows and resumes the campaign."""
    monkeypatch.setattr(tool, "build_sim", lambda steps: _ala(steps))
    sweeps = []
    orig = itt.Iso.lag_sweep
    monkeypatch.setattr(itt.Iso, "lag_sweep", lambda self, **kw: (
        sweeps.append(kw["steps"]), orig(self, **kw))[1])
    kw = dict(iters=3, pilot_generations=1, out=str(tmp_path),
              ladder=[4, 8], sweep_nx=4, sweep_nk=2, nx=4, nk=2,
              cktest_nx=4, cktest_nk=2, rr_nx=4, rr_nk=2, cpu=True,
              checkpoint_every=1)
    res = tool.main(generations=2, **kw)
    assert sweeps == [[4], [8]]
    files = set(os.listdir(tmp_path))
    assert {"pilot.pkl", "pilot.json", "lag_sweep_phase.json",
            "campaign_checkpoint.pkl", "campaign_telemetry.json",
            "iso_final.pkl", "results.json"} <= files
    assert res["generations"] == 2 and res["resumed_from_gen"] == 0
    assert res["steps"] in (4, 8) and len(res["lag_sweep"]) == 2
    for k in ("koopman_eigs", "rates_per_ps", "rates_resolved_rows",
              "cktest_rows", "cktest_ok"):
        assert k in res
    assert "reactive_path_error" not in res
    assert res["reactive_path_frames"] >= 0
    for k in ("plot_error", "lag_sweep_plot_error", "cktest_plot_error"):
        assert k not in res, res.get(k)
    for png in ("lag_sweep.png", "cktest.png", "training.png", "chi.png"):
        assert (tmp_path / png).read_bytes()[:4] == b"\x89PNG", png
    on_disk = json.loads((tmp_path / "results.json").read_text())
    assert on_disk["results"]["generations"] == 2
    res2 = tool.main(generations=3, **kw)
    assert sweeps == [[4], [8]]
    assert res2["resumed_from_gen"] == 2 and res2["generations"] == 3
    meta = json.loads((tmp_path / "campaign_telemetry.json").read_text())
    assert meta["done"] == 3 and [r["gen"] for r in meta["telemetry"]] == [
        0, 1, 2]


def test_tool_imports_no_jax():
    """The tool and the port, imported and driven to their entry points in
    a fresh interpreter, pull in neither jax nor the JAX package."""
    code = (
        "import importlib.util, sys\n"
        "spec = importlib.util.spec_from_file_location('t', "
        "'tools/run_trpcage_production_torch.py')\n"
        "t = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(t)\n"
        "import isokann_tpu_torch, isokann_tpu_torch.workflows\n"
        "t.DEVICE = 'cpu'\n"
        "iso = isokann_tpu_torch.Iso(sim=isokann_tpu_torch.Doublewell("
        "device='cpu'), nx=8, nk=2, gen=0)\n"
        "t.campaign(iso, 1, 2, 1, 2000, [])\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'optax', 'isokann_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
