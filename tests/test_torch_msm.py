"""Port parity of ``analysis/msm.py`` against the JAX package's copy on
the CPU: every function at 1e-10 in float64 on numpy inputs from a seed,
``ramachandran_msm`` on the committed alanine golden at 1e-6 (each
package computes the dihedrals in float32), and
``chi_msm_correlation`` on the golden."""

import numpy as np
import pytest
import torch

import isokann_tpu as itk
from isokann_tpu.analysis import msm as JM

import isokann_tpu_torch as itt
from isokann_tpu_torch.analysis import msm as PM
from isokann_tpu_torch.goldens import golden_dict, load_golden_md

torch.set_num_threads(1)


def close(got, ref, tol=1e-10):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    ok = np.isfinite(ref)
    np.testing.assert_array_equal(np.isfinite(got), ok)
    err = np.max(np.abs(got[ok] - ref[ok])) / max(np.max(np.abs(ref[ok])),
                                                  1e-300)
    assert err <= tol, f"max rel err {err:.3e} > {tol}"


def walk(seed, W=6, F=400, d=2):
    """W walkers of a 2-state-ish random walk on a 2-D torus, (W, F, d)."""
    rng = np.random.default_rng(seed)
    steps = 0.3 * rng.normal(size=(W, F, d))
    return np.mod(np.cumsum(steps, axis=1) + np.pi, 2 * np.pi) - np.pi


@pytest.mark.parametrize("periodic", [True, False])
def test_grid_assign(periodic):
    cv = walk(0).reshape(-1, 2) * 1.2
    ids, shape = PM.grid_assign(cv, -np.pi, np.pi, [7, 9], periodic)
    rids, rshape = JM.grid_assign(cv, -np.pi, np.pi, [7, 9], periodic)
    np.testing.assert_array_equal(ids, rids)
    assert shape == rshape


def test_stratified_sample():
    cv = walk(1).reshape(-1, 2)
    got = PM.stratified_sample(cv, 50, -np.pi, np.pi, 6,
                               rng=np.random.default_rng(2))
    ref = JM.stratified_sample(cv, 50, -np.pi, np.pi, 6,
                               rng=np.random.default_rng(2))
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("symmetrize,bursts", [(False, False), (True, False),
                                               (False, True)])
def test_ulam_and_eigenfunctions(symmetrize, bursts):
    cv = walk(3)
    if bursts:
        cx = cv[:, 0]
        cy = cv[:, 1:5]                           # (W, k, d) endpoints
    else:
        cx, cy = PM.trajectory_pairs(cv, 5)
        rx, ry = JM.trajectory_pairs(cv, 5)
        close(cx, rx, 0)
        close(cy, ry, 0)
    got = PM.ulam_transition_matrix(cx, cy, -np.pi, np.pi, 5,
                                    min_count=2, symmetrize=symmetrize)
    ref = JM.ulam_transition_matrix(cx, cy, -np.pi, np.pi, 5,
                                    min_count=2, symmetrize=symmetrize)
    for g, r in zip(got, ref):
        close(g, r)
    gv, ge = PM.koopman_eigenfunctions(got[0], k=3)
    rv, re = JM.koopman_eigenfunctions(ref[0], k=3)
    close(gv, rv)
    close(ge, re)
    close(PM.eigenfunction_on_samples(cv.reshape(-1, 2), got[1], ge[:, 1],
                                      -np.pi, np.pi, 5),
          JM.eigenfunction_on_samples(cv.reshape(-1, 2), ref[1], re[:, 1],
                                      -np.pi, np.pi, 5))
    close(PM.implied_timescale(gv, 0.1), JM.implied_timescale(rv, 0.1))


def test_trajectory_pairs_walkers_and_range():
    cv = walk(4)
    got = PM.trajectory_pairs(cv, 3, walkers=[0, 0, 2])
    ref = JM.trajectory_pairs(cv, 3, walkers=[0, 0, 2])
    close(got[0], ref[0], 0)
    with pytest.raises(ValueError):
        PM.trajectory_pairs(cv, 0)


def test_disconnected_trajectories():
    rng = np.random.default_rng(5)
    chi = 0.5 + 0.01 * rng.normal(size=(12, 50))
    chi[3] += 0.45                         # one isolated trajectory
    got, ginfo = PM.disconnected_trajectories(chi)
    ref, rinfo = JM.disconnected_trajectories(chi)
    np.testing.assert_array_equal(got, ref)
    assert list(got) == [3]
    for k in ("between", "within", "ratio", "z", "means"):
        close(ginfo[k], rinfo[k])


def test_anchor_identifiability():
    cv = walk(6, W=8, F=300)
    chi = np.cos(cv[..., 0])
    kw = dict(lo=-np.pi, hi=np.pi, nbins=4, n_boot=5, periodic=True,
              chi=chi)
    got = PM.anchor_identifiability(cv, 4, rng=np.random.default_rng(1), **kw)
    ref = JM.anchor_identifiability(cv, 4, rng=np.random.default_rng(1), **kw)
    for k in ("identifiability", "eigvals", "vecs", "ref", "coverage",
              "chi_corr"):
        close(got[k], ref[k])


def test_grid_ceiling_and_containment():
    cv = walk(7).reshape(-1, 2)
    rng = np.random.default_rng(8)
    chi = np.sin(cv[:, 0]) + 0.1 * rng.normal(size=len(cv))
    gc, gm = PM.grid_ceiling(chi, cv, -np.pi, np.pi, 6)
    rc, rm = JM.grid_ceiling(chi, cv, -np.pi, np.pi, 6)
    close(gc, rc)
    close(gm, rm)
    basis = np.stack([chi, np.cos(cv[:, 1])], 1)
    ref_fn = np.sin(cv[:, 0]) + 0.5 * np.cos(cv[:, 1])
    ref_fn[::17] = np.nan
    close(PM.containment_R(ref_fn, basis), JM.containment_R(ref_fn, basis))
    close(PM.containment_R(ref_fn, chi), JM.containment_R(ref_fn, chi))


@pytest.mark.parametrize("symmetrize", [True, False])
def test_tica_and_subspace_spectrum(symmetrize):
    rng = np.random.default_rng(9)
    f = np.cumsum(rng.normal(size=(600, 6)), axis=0) * 0.05
    f += 0.1 * rng.normal(size=f.shape)
    got = PM.tica(f[:-3], f[3:], dim=3, n_pca=5, symmetrize=symmetrize)
    ref = JM.tica(f[:-3], f[3:], dim=3, n_pca=5, symmetrize=symmetrize)
    for g, r in zip(got, ref):
        close(g, r, 1e-9)
    got = PM.subspace_spectrum(f[:-3, :2], f[3:, :2], symmetrize)
    ref = JM.subspace_spectrum(f[:-3, :2], f[3:, :2], symmetrize)
    for g, r in zip(got, ref):
        close(g, r, 1e-9)


@pytest.fixture(scope="module")
def golden():
    return load_golden_md()


def test_ramachandran_msm_on_golden(golden):
    """The port's phi/psi (its own topology and dihedrals) and its MSM of
    the committed xs / ys against the JAX package's, at 1e-6."""
    psim = itt.MDSimulation(steps=int(golden["lag_steps"]), device="cpu")
    jsim = itk.MDSimulation(steps=int(golden["lag_steps"]))
    xs, ys = golden["xs"], golden["ys"]
    got = PM.ramachandran_msm(psim, xs, ys, nbins=18, k=3, min_count=2)
    ref = JM.ramachandran_msm(jsim, xs, ys, nbins=18, k=3, min_count=2)
    close(got["cv_x"], ref["cv_x"], 1e-6)
    close(got["cv_y"], ref["cv_y"], 1e-6)
    np.testing.assert_array_equal(got["cells"], ref["cells"])
    for k in ("P", "counts", "eigvals", "eigvecs"):
        close(got[k], ref[k], 1e-6)
    assert got["lag_ps"] == pytest.approx(ref["lag_ps"])


def test_chi_msm_correlation_on_golden(golden):
    """A chi made of the golden eigenfunction and noise: both packages
    give the same correlation, and the golden itself correlates 1."""
    psim = itt.MDSimulation(device="cpu")
    cv = PM.phipsi(psim, golden["xs"])
    g = golden_dict(golden)
    ref_vals = PM.eigenfunction_on_samples(cv, g["cells"], g["vec"],
                                           -np.pi, np.pi, g["nbins"])
    rng = np.random.default_rng(10)
    chi = np.nan_to_num(ref_vals) + 0.02 * rng.normal(size=len(cv))
    got = PM.chi_msm_correlation(chi, cv, g)
    ref = JM.chi_msm_correlation(chi, cv, g)
    close(got, ref)
    corr, frac = PM.chi_msm_correlation(np.nan_to_num(ref_vals), cv, g)
    assert frac == 1.0 and corr == pytest.approx(1.0, abs=1e-12)
