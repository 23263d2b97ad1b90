"""The port's guided Langevin bridges (``simulators/bridge.py``) against
the JAX package's on the CPU: the periodic difference, the guide, the
bias J^T gain (z - xi) through the same two-output chi
(``weights.load_jax_params``) at 1e-5, and a 10-step bridge trajectory
fed the JAX package's draws at 1e-5; then the JAX tests' assertions
(``tests/test_enhanced_sampling.py:81-110``) and the deposits of
``bridge_simplex``, ``run_bridges`` and ``resample_picking_features``
on the port."""

import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import isokann_tpu as itk
import isokann_tpu.simulators.bridge as JB
from isokann_tpu.md.integrators import KB
from isokann_tpu.models import pairnet as jax_pairnet

import isokann_tpu_torch as itt
import isokann_tpu_torch.simulators.bridge as TB
from isokann_tpu_torch.md import integrators as I
from isokann_tpu_torch.simulators.metadynamics import frozen_chi
from isokann_tpu_torch.weights import load_jax_params

# small tensor ops: one intra-op thread each; several test workers
# share the machine and oversubscribed threads slow them 50x
torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "..", "data", "golden",
                      "ala2_vacuum_msm.npz")


def _close(got, ref, tol=1e-5):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=tol,
                               atol=tol * max(np.abs(ref).max(), 1e-30))


@pytest.fixture(scope="module")
def isos():
    """8 committed alanine frames (centered) in both packages, a
    two-output chi of the same pairnet weights (seed 12)."""
    z = np.load(GOLDEN)
    sub = np.random.default_rng(12).choice(len(z["xs"]), 8, replace=False)
    s = z["xs"][sub].reshape(8, 22, 3)
    xs = (s - s.mean(axis=1, keepdims=True)).reshape(8, 66).astype(
        np.float32)
    ys = np.repeat(xs[:, None], 2, axis=1)
    jm = jax_pairnet(n=231, nout=2, key=jax.random.PRNGKey(12))
    tm = load_jax_params(itt.pairnet(231, nout=2), jax.tree_util.tree_map(
        np.asarray, jm.params))
    jiso = itk.Iso(data=itk.SimulationData.from_coords(
        itk.MDSimulation(steps=10), xs, ys), model=jm, key=0)
    tiso = itt.Iso(data=itt.SimulationData.from_coords(
        itt.MDSimulation(steps=10, device="cpu"), torch.tensor(xs),
        torch.tensor(ys)), model=tm, gen=0)
    return jiso, tiso


def _jax_rc(jiso):
    featurizer = jiso.data.featurizer
    apply, params = jiso.model.apply, jiso.model.params
    return lambda x: apply(params, jnp.asarray(featurizer(x[None, :]),
                                               jnp.float32)[0])


@pytest.fixture(scope="module")
def nout2():
    """``tests/test_enhanced_sampling.py:96-103``'s learner on the port:
    nout 2 on a fresh alanine bootstrap, run(5)."""
    sim = itt.MDSimulation(steps=5, device="cpu")
    iso = itt.Iso(sim=sim, nx=12, nk=2, nout=2, gen=3, minibatch=0,
                  opt=itt.AdamRegularized())
    iso.run(5)
    return iso


def test_angdiff_matches_jax():
    rng = np.random.default_rng(0)
    a, b = (rng.uniform(-10, 10, 50).astype(np.float32),
            rng.uniform(-10, 10, 50).astype(np.float32))
    got = TB.angdiff(torch.tensor(a), torch.tensor(b)).numpy()
    np.testing.assert_allclose(got, np.asarray(JB.angdiff(a, b)), atol=1e-6)
    assert np.all(got >= -np.pi) and np.all(got < np.pi)


def test_linear_interpolant():
    itp = TB.LinearInterpolant([0.0, 1.0], np.array([[0.0], [1.0]]),
                               device="cpu")
    assert float(itp(0.5)[0]) == pytest.approx(0.5)
    assert float(itp(0.0)[0]) == pytest.approx(0.0)
    assert itp.tmax == 1.0
    xs, ys = [0.0, 0.3, 1.0], np.random.default_rng(1).random((3, 2))
    t3 = TB.LinearInterpolant(xs, ys, device="cpu")
    j3 = JB.LinearInterpolant(xs, ys)
    for t in (-0.5, 0.0, 0.1, 0.3, 0.65, 1.0, 1.4):
        _close(t3(t).numpy(), j3(t), tol=1e-6)


@pytest.mark.parametrize("periodic", [False, True])
def test_bias_matches_jax(isos, periodic):
    """J^T gain (z(t) - xi(x)) at two walkers and two times, at 1e-5 (and
    divided by sigma without ``withsigma``)."""
    jiso, tiso = isos
    guide = TB.LinearInterpolant([0.0, 0.02], np.eye(2), device="cpu")
    jguide = JB.LinearInterpolant([0.0, 0.02], np.eye(2))
    gain = lambda t: 2.0 + 10 * t
    glb = TB.GuidedLangevinBridge(tiso.data.sim, frozen_chi(tiso), guide,
                                  gain, periodic=periodic)
    jglb = JB.GuidedLangevinBridge(jiso.data.sim, _jax_rc(jiso), jguide,
                                   gain, periodic=periodic)
    x = tiso.data.coords[:2]
    sigma = torch.full((66,), 0.5)
    for t in (0.0, 0.013):
        got = glb.biasforce()(x, t, sigma, None)
        ref = jglb.biasforce()(jnp.asarray(x.numpy()), t, 0.5, None)
        _close(got.numpy(), ref)
        _close(glb.biasforce(withsigma=False)(x, t, sigma, None).numpy(),
               np.asarray(ref) / 0.5)


def test_bridge_trajectory_matches_jax(isos, monkeypatch):
    """A 10-step bridge (0.02 ps) from a start point, the port fed the
    JAX package's momenta and normals: every frame and weight at 1e-5."""
    jiso, tiso = isos
    sim = tiso.data.sim
    guide = TB.LinearInterpolant([0.0, sim.step * 10], np.eye(2),
                                 device="cpu")
    jguide = JB.LinearInterpolant([0.0, sim.step * 10], np.eye(2))
    glb = TB.GuidedLangevinBridge(sim, frozen_chi(tiso), guide,
                                  lambda t: 1.0)
    jglb = JB.GuidedLangevinBridge(jiso.data.sim, _jax_rc(jiso), jguide,
                                   lambda t: 1.0)
    key = jax.random.PRNGKey(5)
    kv, ki = jax.random.split(key)
    z0 = np.asarray(jax.random.normal(kv, (1, 66)))
    normals = iter([np.asarray(jax.random.normal(k, (1, 66)))
                    for k in jax.random.split(ki, 10)])
    monkeypatch.setattr(I, "maxwell_boltzmann", lambda gen, m3, T, shape:
                        torch.tensor(z0) * torch.sqrt(KB * T / m3))
    monkeypatch.setattr(I, "_normals", lambda gen, x: torch.tensor(
        next(normals)).to(x.dtype))
    x0 = tiso.data.coords[1]
    t = glb.trajectory(x0)
    jt = jglb.trajectory(jnp.asarray(x0.numpy()), key=key)
    assert t.values.shape == (10, 66) and torch.isfinite(t.values).all()
    _close(t.values.numpy(), jt.values)
    _close(t.weights.numpy(), jt.weights)


def test_bridge_trajectory_brownian(nout2):
    """A Brownian simulation's bridge: the end point and its weight."""
    sim = itt.MDSimulation(steps=5, integrator="brownian", friction=1000.0,
                           device="cpu")
    guide = TB.LinearInterpolant([0.0, sim.step * 5], np.eye(2),
                                 device="cpu")
    t = TB.GuidedLangevinBridge(sim, frozen_chi(nout2), guide).trajectory(
        nout2.data.coords[0], gen=1)
    assert t.values.shape == (1, 66) and t.weights.shape == (1,)
    assert torch.isfinite(t.values).all() and torch.isfinite(t.weights).all()


def test_bridge_trajectory_one_output(nout2):
    """The JAX test's 1-D guide through a one-output chi."""
    sim = nout2.data.sim
    iso1 = itt.Iso(data=nout2.data, model=itt.pairnet(231, gen=4), gen=4)
    guide = TB.LinearInterpolant([0.0, sim.step * 10],
                                 np.array([[0.0], [1.0]]), device="cpu")
    glb = TB.GuidedLangevinBridge(sim, frozen_chi(iso1), guide,
                                  lambda t: 1.0)
    t = glb.trajectory(sim.coords, gen=0)
    assert t.values.shape == (10, 66) and torch.isfinite(t.values).all()


def test_bridge_simplex_deposits(nout2):
    """eps=10 accepts any start; the frames with sum chi^2 < 0.9 (at most
    ``deposit``, chosen from ``gen``) join the data."""
    iso = itt.Iso(data=nout2.data, model=nout2.model, gen=5, minibatch=0)
    sim = iso.data.sim
    n0 = len(iso.data)
    t = TB.bridge_simplex(iso, ix=(0, 1), eps=10.0, T=sim.step * 5,
                          deposit=2, gen=6)
    assert t is not None and t.shape == (5, 66) and torch.isfinite(t).all()
    trans = int(((iso.chicoords(t) ** 2).sum(1) < 0.9).sum())
    assert n0 + min(trans, 1) <= len(iso.data) <= n0 + min(trans, 2)
    again = itt.Iso(data=nout2.data, model=nout2.model, gen=5, minibatch=0)
    t2 = TB.bridge_simplex(again, ix=(0, 1), eps=10.0, T=sim.step * 5,
                           deposit=2, gen=6)
    assert torch.equal(t, t2) and torch.equal(again.data.coords,
                                              iso.data.coords)


def test_bridge_simplex_without_a_start_warns(nout2):
    with pytest.warns(UserWarning, match="No starting point"):
        assert TB.bridge_simplex(nout2, eps=0.0, T=0.01) is None


def test_bias_is_frozen_at_construction(nout2):
    """A bridge built before ``iso.run`` pushes the same after it."""
    iso = itt.Iso(data=nout2.data, model=itt.pairnet(231, nout=2, gen=7),
                  gen=7, opt=itt.AdamRegularized(), minibatch=0)
    guide = TB.LinearInterpolant([0.0, 0.01], np.eye(2), device="cpu")
    bias = TB.GuidedLangevinBridge(iso.data.sim, frozen_chi(iso),
                                   guide).biasforce()
    x = iso.data.coords[:2]
    sigma = torch.ones(66)
    u0 = bias(x, 0.004, sigma, None)
    chi0 = iso.chis()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        iso.run(3)
    assert not torch.equal(iso.chis(), chi0)
    assert torch.equal(bias(x, 0.004, sigma, None), u0)


def test_run_bridges_and_picking(nout2):
    """Both corner pairs bridged and trained; farthest-point resampling
    keeps the data's size, its picked start points and features."""
    iso = itt.Iso(data=nout2.data, model=nout2.model, gen=8, minibatch=0,
                  opt=itt.AdamRegularized())
    n0, l0 = len(iso.data), len(iso.losses)
    itt.run_bridges(iso, train=2, eps=10.0, T=iso.data.sim.step * 4,
                    deposit=1, gen=9)
    assert len(iso.losses) == l0 + 2
    rows = iso.bridge_telemetry
    assert [r["ix"] for r in rows] == [(0, 1), (1, 0)]
    assert all(r["frames"] == 4 and r["finite"] for r in rows)
    assert all(r["n_new"] == min(1, r["n_transition"]) for r in rows)
    assert len(iso.data) == n0 + sum(r["n_new"] for r in rows)
    n1 = len(iso.data)
    itt.resample_picking_features(iso)
    assert len(iso.data) == n1
    assert torch.isfinite(iso.data.features).all()
    assert torch.equal(iso.data.features_of(iso.data.coords),
                       iso.data.features)
