"""The port's effective dynamics (``simulators/effective.py``) against the
JAX package's on the CPU: the Epanechnikov table at 1e-6, the (b, A)
table of ``EffectiveSimulation`` through the same chi weights
(``weights.load_jax_params``) with b at 1e-4 relative and A at 1e-5, and
20 Euler-Maruyama steps (trajectory and bursts) fed the JAX package's
normals at 1e-5; then the JAX tests' assertions
(``tests/test_enhanced_sampling.py:113-127``)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import isokann_tpu as itk
import isokann_tpu.simulators.effective as JE
from isokann_tpu.models import pairnet as jax_pairnet

import isokann_tpu_torch as itt
import isokann_tpu_torch.simulators.effective as TE
from isokann_tpu_torch.md import integrators as I
from isokann_tpu_torch.simulators.metadynamics import frozen_chi
from isokann_tpu_torch.weights import load_jax_params

# small tensor ops: one intra-op thread each; several test workers
# share the machine and oversubscribed threads slow them 50x
torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "..", "data", "golden",
                      "ala2_vacuum_msm.npz")


def _close(got, ref, tol):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=tol,
                               atol=tol * max(np.abs(ref).max(), 1e-30))


@pytest.fixture(scope="module")
def effs():
    """``EffectiveSimulation(iso, h=0.5, dt=1e-6, steps=20)`` in both
    packages over 10 committed alanine frames (centered), chi the same
    pairnet(231) weights (seed 13)."""
    z = np.load(GOLDEN)
    sub = np.random.default_rng(13).choice(len(z["xs"]), 10, replace=False)
    s = z["xs"][sub].reshape(10, 22, 3)
    xs = (s - s.mean(axis=1, keepdims=True)).reshape(10, 66).astype(
        np.float32)
    ys = np.repeat(xs[:, None], 2, axis=1)
    jm = jax_pairnet(n=231, key=jax.random.PRNGKey(13))
    tm = load_jax_params(itt.pairnet(231), jax.tree_util.tree_map(
        np.asarray, jm.params))
    jiso = itk.Iso(data=itk.SimulationData.from_coords(
        itk.MDSimulation(steps=10), xs, ys), model=jm, key=0)
    tiso = itt.Iso(data=itt.SimulationData.from_coords(
        itt.MDSimulation(steps=10, device="cpu"), torch.tensor(xs),
        torch.tensor(ys)), model=tm, gen=0, opt=itt.AdamRegularized())
    kw = dict(h=0.5, dt=1e-6, steps=20)
    return (JE.EffectiveSimulation(jiso, **kw),
            TE.EffectiveSimulation(tiso, **kw), tiso)


def test_epanechnikov_matches_jax():
    rng = np.random.default_rng(0)
    zs = rng.random((30, 2)).astype(np.float32)
    for z in rng.random((5, 2)).astype(np.float32):
        got = TE.epanechnikov_weights(torch.tensor(zs), torch.tensor(z), 0.3)
        ref = JE.epanechnikov_weights(jnp.asarray(zs), jnp.asarray(z), 0.3)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)
    batch = TE.epanechnikov_weights(torch.tensor(zs), torch.tensor(zs[:4]),
                                    0.3)
    assert batch.shape == (4, 30) and float(batch[0, 0]) == 1.0


def test_kde_expectation():
    """The JAX test, and one query against a batch of them."""
    zs = np.linspace(0, 1, 11)[:, None]
    kde = TE.KDEExpectation(zs, zs.copy(), h=0.25, device="cpu")
    assert float(kde.marginal(torch.tensor([0.5]))[0]) == \
        pytest.approx(0.5, abs=0.05)
    assert float(kde.weight(torch.tensor([0.5]))) > 0
    jkde = JE.KDEExpectation(zs, zs.copy(), h=0.25)
    q = np.array([[0.05], [0.5], [0.93], [2.0]], np.float32)
    got = kde.marginal(torch.tensor(q))
    ref = np.stack([np.asarray(jkde.marginal(jnp.asarray(z))) for z in q])
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-6)
    assert float(kde.weight(torch.tensor([2.0]))) == 0.0


def test_table_matches_jax(effs):
    """The (b, A) table: b at 1e-4 relative, A at 1e-5, the points' chi
    at 1e-6."""
    jeff, teff, _ = effs
    assert teff.dim == jeff.dim == 1
    np.testing.assert_allclose(teff.kde.zs.numpy(), np.asarray(jeff.kde.zs),
                               atol=1e-6)
    got, ref = teff.kde.fs.numpy(), np.asarray(jeff.kde.fs)
    _close(got[:, :1], ref[:, :1], 1e-4)
    _close(got[:, 1:], ref[:, 1:], 1e-5)


def test_b_and_A_two_outputs():
    """``b_and_A`` of a two-output chi on three points against the JAX
    function point by point (b 1e-4 relative, A 1e-5); one point alone
    gives the same."""
    z = np.load(GOLDEN)
    s = z["xs"][:3].reshape(3, 22, 3)
    xs = (s - s.mean(axis=1, keepdims=True)).reshape(3, 66).astype(
        np.float32)
    jm = jax_pairnet(n=231, nout=2, key=jax.random.PRNGKey(14))
    tm = load_jax_params(itt.pairnet(231, nout=2), jax.tree_util.tree_map(
        np.asarray, jm.params))
    tiso = itt.Iso(data=itt.SimulationData.from_coords(
        itt.MDSimulation(steps=10, device="cpu"), torch.tensor(xs),
        torch.tensor(xs[:, None])), model=tm, gen=0)
    jsim = itk.MDSimulation(steps=10)
    jxi = (lambda x: jm.apply(jm.params, jnp.asarray(
        jsim.featurizer(x[None, :]), jnp.float32)[0]))
    rng = np.random.default_rng(3)
    F = rng.normal(size=(3, 66)).astype(np.float32)
    sigma = rng.uniform(0.5, 2.0, size=66).astype(np.float32)
    b, A = TE.b_and_A(frozen_chi(tiso), torch.tensor(xs), torch.tensor(F),
                      torch.tensor(sigma))
    assert b.shape == (3, 2) and A.shape == (3, 2, 2)
    for k in range(3):
        jb, jA = JE.b_and_A(jxi, jnp.asarray(xs[k]), jnp.asarray(F[k]),
                            jnp.asarray(sigma))
        _close(b[k].numpy(), jb, 1e-4)
        _close(A[k].numpy(), jA, 1e-5)
    b0, A0 = TE.b_and_A(frozen_chi(tiso), torch.tensor(xs[0]),
                        torch.tensor(F[0]), torch.tensor(sigma))
    _close(b0.numpy(), b[0].numpy(), 1e-6)
    _close(A0.numpy(), A[0].numpy(), 1e-6)


def _jax_table_sim(jeff):
    """The port's dynamics over the JAX package's table."""
    return TE.EffectiveSimulation(kde=TE.KDEExpectation(
        np.array(jeff.kde.zs), np.array(jeff.kde.fs), jeff.kde.h,
        device="cpu"), steps=jeff.steps, dt=jeff.dt)


def test_trajectory_matches_jax(effs, monkeypatch):
    """20 Euler-Maruyama steps on the same table, the port fed the JAX
    package's normals, every 2nd frame: at 1e-5."""
    jeff, teff, _ = effs
    key = jax.random.PRNGKey(6)
    normals = iter([np.asarray(jax.random.normal(k, (1,)))
                    for k in jax.random.split(key, 20)])
    monkeypatch.setattr(I, "_normals", lambda gen, x: torch.tensor(
        next(normals)).to(x.dtype).reshape(x.shape))
    got = _jax_table_sim(jeff).trajectory(steps=20, saveevery=2, dt=1e-4)
    ref = jeff.trajectory(steps=20, saveevery=2, dt=1e-4, key=key)
    assert got.shape == (10, 1)
    _close(got.numpy(), ref, 1e-5)


def test_propagate_matches_jax(effs, monkeypatch):
    """Bursts of 3 x 2 walkers over one lag (20 steps) on the same
    table, fed the JAX package's per-walker normals: at 1e-5."""
    jeff, teff, _ = effs
    key = jax.random.PRNGKey(7)
    normals = iter([np.stack([np.asarray(jax.random.normal(ki, (1,)))
                              for ki in jax.random.split(k, 6)])
                    for k in jax.random.split(key, 20)])
    monkeypatch.setattr(I, "_normals", lambda gen, x: torch.tensor(
        next(normals)).to(x.dtype).reshape(x.shape))
    x0 = np.asarray(jeff.kde.zs[:3])
    got = _jax_table_sim(jeff).propagate(x0, 2)
    ref = jeff.propagate(x0, 2, key=key)
    assert got.shape == (3, 2, 1)
    _close(got.numpy(), ref, 1e-5)


def test_effective_simulation(effs):
    """The JAX test's shapes on the port's own table."""
    _, eff, _ = effs
    traj = eff.trajectory(steps=20, gen=0)
    assert traj.shape == (20, 1) and torch.isfinite(traj).all()
    ys = eff.propagate(eff.kde.zs[:3], 2, gen=1)
    assert ys.shape == (3, 2, 1) and torch.isfinite(ys).all()
    assert eff.lagtime == pytest.approx(20 * 1e-6)
    b, L = eff.b_and_sigma(eff.coords)
    assert b.shape == (1,) and L.shape == (1, 1) and float(L[0, 0]) > 0


def test_table_is_frozen_at_construction(effs):
    """The table's xi is a frozen copy: an ``EffectiveSimulation`` built
    before ``iso.run`` moves the same after it."""
    _, eff, tiso = effs
    iso = itt.Iso(data=tiso.data, model=itt.pairnet(231, gen=15), gen=15,
                  opt=itt.AdamRegularized())
    e1 = TE.EffectiveSimulation(iso, h=0.5, dt=1e-6, steps=5)
    zs, fs = e1.kde.zs.clone(), e1.kde.fs.clone()
    chi0 = iso.chis()
    iso.run(3)
    assert not torch.equal(iso.chis(), chi0)
    assert torch.equal(e1.kde.zs, zs) and torch.equal(e1.kde.fs, fs)


@pytest.fixture(scope="module")
def effs2():
    """Both packages' ``EffectiveSimulation(iso, h=0.5, dt=1e-6,
    steps=20)`` with a two-output chi (pairnet(231, nout=2), seed 14)
    over the fixture's 10 alanine frames: the Cholesky path (K = 2)."""
    z = np.load(GOLDEN)
    sub = np.random.default_rng(13).choice(len(z["xs"]), 10, replace=False)
    s = z["xs"][sub].reshape(10, 22, 3)
    xs = (s - s.mean(axis=1, keepdims=True)).reshape(10, 66).astype(
        np.float32)
    ys = np.repeat(xs[:, None], 2, axis=1)
    jm = jax_pairnet(n=231, nout=2, key=jax.random.PRNGKey(14))
    tm = load_jax_params(itt.pairnet(231, nout=2), jax.tree_util.tree_map(
        np.asarray, jm.params))
    jiso = itk.Iso(data=itk.SimulationData.from_coords(
        itk.MDSimulation(steps=10), xs, ys), model=jm, key=0)
    tiso = itt.Iso(data=itt.SimulationData.from_coords(
        itt.MDSimulation(steps=10, device="cpu"), torch.tensor(xs),
        torch.tensor(ys)), model=tm, gen=0)
    kw = dict(h=0.5, dt=1e-6, steps=20)
    return (JE.EffectiveSimulation(jiso, **kw),
            TE.EffectiveSimulation(tiso, **kw))


def test_two_output_table_and_b_and_sigma_match_jax(effs2):
    """K = 2: the table (chi 1e-6, b 1e-4 relative, A 1e-5), then b and
    the Cholesky factor L at the table points and between them at 1e-5,
    one query against a batch of them, and L L^T = A + 1e-10 I."""
    jeff, teff = effs2
    assert teff.dim == jeff.dim == 2
    np.testing.assert_allclose(teff.kde.zs.numpy(), np.asarray(jeff.kde.zs),
                               atol=1e-6)
    got, ref = teff.kde.fs.numpy(), np.asarray(jeff.kde.fs)
    _close(got[:, :2], ref[:, :2], 1e-4)
    _close(got[:, 2:], ref[:, 2:], 1e-5)
    sim = _jax_table_sim(jeff)
    zs = np.asarray(jeff.kde.zs)
    qs = np.concatenate([zs, (zs[:-1] + zs[1:]) / 2]).astype(np.float32)
    b, L = sim.b_and_sigma(torch.tensor(qs))
    assert b.shape == (len(qs), 2) and L.shape == (len(qs), 2, 2)
    for k, q in enumerate(qs):
        jb, jL = jeff.b_and_sigma(jnp.asarray(q))
        assert np.all(np.isfinite(np.asarray(jL)))
        _close(b[k].numpy(), jb, 1e-5)
        _close(L[k].numpy(), jL, 1e-5)
    b0, L0 = sim.b_and_sigma(torch.tensor(qs[3]))
    _close(b0.numpy(), b[3].numpy(), 1e-6)
    _close(L0.numpy(), L[3].numpy(), 1e-6)
    A = sim.kde.marginal(torch.tensor(qs))[:, 2:].reshape(-1, 2, 2)
    _close((L @ L.transpose(-1, -2)).numpy(), (A + 1e-10 * torch.eye(2))
           .numpy(), 1e-5)


def test_two_output_trajectory_matches_jax(effs2, monkeypatch):
    """K = 2: 20 Euler-Maruyama steps on the same table, the port fed the
    JAX package's normals, every 2nd frame: at 1e-5."""
    jeff, _ = effs2
    key = jax.random.PRNGKey(8)
    normals = iter([np.asarray(jax.random.normal(k, (2,)))
                    for k in jax.random.split(key, 20)])
    monkeypatch.setattr(I, "_normals", lambda gen, x: torch.tensor(
        next(normals)).to(x.dtype).reshape(x.shape))
    got = _jax_table_sim(jeff).trajectory(steps=20, saveevery=2, dt=1e-4)
    ref = jeff.trajectory(steps=20, saveevery=2, dt=1e-4, key=key)
    assert got.shape == (10, 2) and np.all(np.isfinite(np.asarray(ref)))
    _close(got.numpy(), ref, 1e-5)


def test_two_output_propagate_matches_jax(effs2, monkeypatch):
    """K = 2: bursts of 3 x 2 walkers over one lag (20 steps) on the same
    table, fed the JAX package's per-walker normals: at 1e-5; the port's
    own table's bursts are finite."""
    jeff, teff = effs2
    key = jax.random.PRNGKey(9)
    normals = iter([np.stack([np.asarray(jax.random.normal(ki, (2,)))
                              for ki in jax.random.split(k, 6)])
                    for k in jax.random.split(key, 20)])
    with monkeypatch.context() as m:
        m.setattr(I, "_normals", lambda gen, x: torch.tensor(
            next(normals)).to(x.dtype).reshape(x.shape))
        x0 = np.asarray(jeff.kde.zs[:3])
        got = _jax_table_sim(jeff).propagate(x0, 2)
    ref = jeff.propagate(x0, 2, key=key)
    assert got.shape == (3, 2, 2) and np.all(np.isfinite(np.asarray(ref)))
    _close(got.numpy(), ref, 1e-5)
    own = teff.propagate(teff.kde.zs[:3], 2, gen=2)
    assert own.shape == (3, 2, 2) and torch.isfinite(own).all()


@pytest.mark.parametrize("K", [1, 2])
def test_b_and_sigma_not_positive_definite_is_nan(K):
    """Where the table's A is not positive definite, L's lower triangle
    is NaN in both packages (the port's Cholesky does not raise), its
    upper 0, b as it is."""
    A = -np.eye(K) if K == 1 else np.array([[1.0, 2.0], [2.0, 1.0]])
    zs = np.linspace(0, 1, 5)[:, None].repeat(K, axis=1)
    fs = np.concatenate([np.ones((5, K)), np.tile(A.reshape(1, -1), (5, 1))],
                        axis=1).astype(np.float32)
    sim = TE.EffectiveSimulation(kde=TE.KDEExpectation(
        zs, fs, 0.5, device="cpu"))
    jsim = JE.EffectiveSimulation(kde=JE.KDEExpectation(zs, fs, 0.5))
    q = np.full(K, 0.5, np.float32)
    b, L = sim.b_and_sigma(torch.tensor(q))
    jb, jL = jsim.b_and_sigma(jnp.asarray(q))
    jL = np.asarray(jL)
    np.testing.assert_array_equal(torch.isnan(L).numpy(), np.isnan(jL))
    assert np.isnan(jL[..., -1, 0]).all()
    assert not np.any(np.triu(np.nan_to_num(jL, nan=1.0), 1))
    assert not torch.any(torch.triu(L, 1).nan_to_num(1.0))
    _close(b.numpy(), jb, 1e-6)
