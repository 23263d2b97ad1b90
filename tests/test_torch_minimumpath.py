"""The port's reaction paths (``analysis/minimumpath.py``:
``reactionforce``, ``reactionintegrator``, ``reactionpath_minimum``,
``reactionpath_ode``) against the JAX package's on the CPU at 1e-4: the
Doublewell learner the JAX analysis tests train (its data and weights
carried over with ``weights.load_jax_params``), and alanine frames under
shared pairnet weights."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import isokann_tpu as itk
import isokann_tpu.analysis.minimumpath as JM
from isokann_tpu.models import pairnet as jax_pairnet

import isokann_tpu_torch as itt
import isokann_tpu_torch.analysis.minimumpath as TM
from isokann_tpu_torch.weights import load_jax_params

# small tensor ops: one intra-op thread each; several test workers
# share the machine and oversubscribed threads slow them 50x
torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "..", "data", "golden",
                      "ala2_vacuum_msm.npz")


def _params(m):
    return jax.tree_util.tree_map(np.asarray, m.params)


@pytest.fixture(scope="module")
def doublewell():
    """The JAX analysis tests' trained Doublewell learner
    (``tests/test_analysis.py:21-26``) and its twin in the port."""
    jiso = itk.Iso(sim=itk.Doublewell(), nx=128, nk=8, key=0, minibatch=64,
                   opt=itk.AdamRegularized(1e-3, 1e-5))
    jiso.run(300)
    tsim = itt.Doublewell(device="cpu")
    tm = load_jax_params(itt.smallnet(1), _params(jiso.model))
    tiso = itt.Iso(data=itt.SimulationData.from_coords(
        tsim, torch.tensor(np.asarray(jiso.data.coords)),
        torch.tensor(np.asarray(jiso.data.propcoords))), model=tm, gen=0)
    return jiso, tiso


@pytest.fixture(scope="module")
def alanine():
    """8 committed alanine frames (centered) in both packages, chi the
    same pairnet(231) weights (seed 9)."""
    z = np.load(GOLDEN)
    sub = np.random.default_rng(9).choice(len(z["xs"]), 8, replace=False)
    s = z["xs"][sub].reshape(8, 22, 3)
    xs = (s - s.mean(axis=1, keepdims=True)).reshape(8, 66).astype(
        np.float32)
    ys = np.repeat(xs[:, None], 2, axis=1)
    jm = jax_pairnet(n=231, key=jax.random.PRNGKey(9))
    tm = load_jax_params(itt.pairnet(231), _params(jm))
    jiso = itk.Iso(data=itk.SimulationData.from_coords(
        itk.MDSimulation(steps=10), xs, ys), model=jm, key=0)
    tiso = itt.Iso(data=itt.SimulationData.from_coords(
        itt.MDSimulation(steps=10, device="cpu"), torch.tensor(xs),
        torch.tensor(ys)), model=tm, gen=0)
    return jiso, tiso


def _close(got, ref, tol=1e-4):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=tol,
                               atol=tol * max(np.abs(ref).max(), 1e-30))


@pytest.mark.parametrize("direction", [1, -1])
def test_reactionforce_matches_jax(alanine, direction):
    jiso, tiso = alanine
    for x in tiso.data.coords[:3]:
        got = TM.reactionforce(tiso, tiso.data.sim, x, direction, orth=0.05)
        ref = JM.reactionforce(jiso, jiso.data.sim, jnp.asarray(x.numpy()),
                               direction, orth=0.05)
        _close(got.numpy(), ref)


def test_reactionintegrator_matches_jax(doublewell):
    jiso, tiso = doublewell
    for x0, d in ((0.3, 1), (-0.2, -1)):
        got = TM.reactionintegrator(tiso, torch.tensor([x0]), steps=4,
                                    stepsize=0.05, direction=d, miniter=3)
        ref = JM.reactionintegrator(jiso, jnp.asarray([x0]), steps=4,
                                    stepsize=0.05, direction=d, miniter=3)
        _close(got.numpy(), ref)
    assert TM.reactionintegrator(tiso, torch.tensor([0.0]),
                                 steps=0).shape == (0, 1)


def test_reactionintegrator_trust_region(doublewell):
    """A move never exceeds ``maxstep`` (before the levelset step, which
    on a 1-D system does not move the point)."""
    jiso, tiso = doublewell
    got = TM.reactionintegrator(tiso, torch.tensor([1.2]), steps=3,
                                stepsize=0.5, maxstep=0.01, miniter=1)
    ref = JM.reactionintegrator(jiso, jnp.asarray([1.2]), steps=3,
                                stepsize=0.5, maxstep=0.01, miniter=1)
    _close(got.numpy(), ref)
    steps = np.abs(np.diff(np.concatenate([[1.2], got[:, 0].numpy()])))
    assert np.all(steps <= 0.01 + 1e-6)


def test_reactionpath_minimum_matches_jax(doublewell):
    """The JAX test's path (``tests/test_analysis.py:157-166``): the JAX
    package's frames at 1e-4, chi sweeping more than 0.25."""
    jiso, tiso = doublewell
    path = TM.reactionpath_minimum(tiso, torch.tensor([0.0]), steps=11,
                                   miniter=3)
    ref = JM.reactionpath_minimum(jiso, jnp.asarray([0.0]), steps=11,
                                  miniter=3)
    _close(path.numpy(), ref)
    assert path.shape[1] == 1 and torch.isfinite(path).all()
    chis = tiso.chicoords(path)[:, 0].numpy()
    assert chis.max() - chis.min() > 0.25


def test_reactionpath_minimum_draws_its_start(doublewell):
    """With no ``x0`` the start is a data point drawn from ``gen``: the
    same seed, the same path."""
    _, tiso = doublewell
    a = TM.reactionpath_minimum(tiso, steps=5, miniter=1, gen=3)
    b = TM.reactionpath_minimum(tiso, steps=5, miniter=1, gen=3)
    assert torch.equal(a, b) and torch.isfinite(a).all()


@pytest.mark.parametrize("orth,maxspeed", [(0.01, 0.2), (0.0, 5.0)])
def test_reactionpath_ode_small_matches_jax(alanine, orth, maxspeed):
    """RK4 of the reaction force on alanine, 3 frames x 2 substeps: the
    JAX package's frames at 1e-4.  (With the force's part and speeds of
    ~1 nm a unit of chi-time the stiff force field amplifies float32
    rounding: both packages part by ~1e-3 nm at maxspeed 0.5.)"""
    jiso, tiso = alanine
    x0 = tiso.data.coords[0]
    got = TM.reactionpath_ode(tiso, x0, steps=3, substeps=2, orth=orth,
                              maxspeed=maxspeed)
    ref = JM.reactionpath_ode(jiso, jnp.asarray(x0.numpy()), steps=3,
                              substeps=2, orth=orth, maxspeed=maxspeed)
    assert got.shape == (3, 66) and torch.isfinite(got).all()
    _close(got.numpy(), ref)


@pytest.mark.slow
def test_reactionpath_ode(doublewell):
    """The JAX test (``tests/test_analysis.py:169-177``) and its frames at
    1e-4."""
    jiso, tiso = doublewell
    path = TM.reactionpath_ode(tiso, torch.tensor([0.1]), steps=21,
                               orth=0.001)
    ref = JM.reactionpath_ode(jiso, jnp.asarray([0.1]), steps=21, orth=0.001)
    assert path.shape == (21, 1) and torch.isfinite(path).all()
    _close(path.numpy(), ref)
    chis = tiso.chicoords(path)[:, 0].numpy()
    assert np.sum(np.diff(chis) > 0) >= 12


def test_chilevel_minimization(doublewell):
    """The JAX test: a minimization stays on its levelset."""
    _, tiso = doublewell
    x0 = torch.tensor([0.5])
    x = TM.energyminimization_chilevel(tiso, x0, iterations=5, lr=1e-4)
    chi0 = float(tiso.chicoords(x0[None, :])[0, 0])
    chi1 = float(tiso.chicoords(x[None, :])[0, 0])
    assert abs(chi0 - chi1) < 0.05
