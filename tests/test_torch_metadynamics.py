"""The port's metadynamics (``simulators/metadynamics.py``) and its three
workflows (``adaptive_metadynamics``, ``run_metadynamics``,
``run_both``) against the JAX package's on the CPU: the bias potential
of the center matrix and of the grid, the bias force through the same
chi weights (``weights.load_jax_params``) at 1e-5, and 10 ABOBA steps of
a biased trajectory fed the JAX package's draws at 1e-5 in x; then the
JAX tests' assertions (``tests/test_enhanced_sampling.py:28-78``,
``tests/test_workflow.py:67-79``) on the port."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import isokann_tpu as itk
import isokann_tpu.simulators.metadynamics as JMD
from isokann_tpu.md.integrators import KB
from isokann_tpu.models import pairnet as jax_pairnet

import isokann_tpu_torch as itt
import isokann_tpu_torch.simulators.metadynamics as TMD
from isokann_tpu_torch import workflows as W
from isokann_tpu_torch.md import integrators as I
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
    """16 committed alanine frames x 2 bursts (centered) in both
    packages, chi the same pairnet(231) weights (seed 11)."""
    z = np.load(GOLDEN)
    sub = np.random.default_rng(11).choice(len(z["xs"]), 16, replace=False)
    s = z["xs"][sub].reshape(16, 22, 3)
    xs = (s - s.mean(axis=1, keepdims=True)).reshape(16, 66).astype(
        np.float32)
    t = z["ys"][sub][:, :2].reshape(16, 2, 22, 3)
    ys = (t - t.mean(axis=2, keepdims=True)).reshape(16, 2, 66).astype(
        np.float32)
    jm = jax_pairnet(n=231, key=jax.random.PRNGKey(11))
    tm = load_jax_params(itt.pairnet(231), jax.tree_util.tree_map(
        np.asarray, jm.params))
    jiso = itk.Iso(data=itk.SimulationData.from_coords(
        itk.MDSimulation(steps=10), xs, ys), model=jm, key=0)
    tiso = itt.Iso(data=itt.SimulationData.from_coords(
        itt.MDSimulation(steps=10, device="cpu"), torch.tensor(xs),
        torch.tensor(ys)), model=tm, gen=0, opt=itt.AdamRegularized())
    return jiso, tiso


@pytest.fixture(scope="module")
def md_iso():
    """The JAX tests' learner (``tests/test_enhanced_sampling.py:21-25``)
    in the port."""
    sim = itt.MDSimulation(steps=10, device="cpu")
    iso = itt.Iso(sim=sim, nx=16, nk=2, gen=0, minibatch=0,
                  opt=itt.AdamRegularized())
    iso.run(20)
    return iso


# ---- the bias ---------------------------------------------------------------

def test_state_deposit_and_potential():
    s = TMD.MetadynamicsState(np.zeros((1, 1)), capacity=8, device="cpu")
    assert float(s.bias_potential(torch.zeros(1), 1.0, 0.1)) == \
        pytest.approx(1.0)
    s.deposit(np.zeros((1, 1)))
    assert float(s.bias_potential(torch.zeros(1), 1.0, 0.1)) == \
        pytest.approx(2.0)
    s.deposit(np.zeros((20, 1)))
    assert s.count == 22 and s.capacity == 22
    s.deposit(np.zeros((1, 1)))
    assert s.count == 23 and s.capacity == 44


def test_welltempered_and_projection():
    U = torch.tensor([0.0, 1.0, 40.0])
    assert torch.equal(TMD.rescale_welltempered(U, np.inf), U)
    _close(TMD.rescale_welltempered(U, 600.0).numpy(),
           JMD.rescale_welltempered(jnp.asarray(U.numpy()), 600.0))
    assert float(TMD.rescale_welltempered(torch.tensor(1.0), 600.0)) < 1.0
    x = torch.tensor([[0.5, 0.7], [0.1, 0.3]])
    p = TMD.project_onto_simplex_hyperplane(x)
    _close(p.numpy(), JMD.project_onto_simplex_hyperplane(
        jnp.asarray(x.numpy())))
    assert torch.allclose(p.sum(-1), torch.ones(2))
    assert torch.equal(TMD.project_onto_simplex_hyperplane(x[:, :1]),
                       x[:, :1])


@pytest.mark.parametrize("d", [1, 2])
def test_bias_potential_matches_jax(d):
    """Random centers past the capacity and random queries: the masked
    sum at 1e-5, one query and a batch of them."""
    rng = np.random.default_rng(d)
    c0, c1 = rng.random((5, d)), rng.random((7, d))
    s = TMD.MetadynamicsState(torch.tensor(c0, dtype=torch.float32),
                              capacity=8)
    js = JMD.MetadynamicsState(c0, capacity=8)
    s.deposit(c1)
    js.deposit(c1)
    assert (s.count, s.capacity) == (js.count, js.capacity) == (12, 16)
    zs = rng.random((6, d)).astype(np.float32)
    ref = np.array([float(js.bias_potential(jnp.asarray(z), 0.7, 0.2))
                    for z in zs])
    _close(s.bias_potential(torch.tensor(zs), 0.7, 0.2).numpy(), ref)
    _close(float(s.bias_potential(torch.tensor(zs[0]), 0.7, 0.2)), ref[0])


@pytest.mark.parametrize("d", [1, 2])
def test_gridded_matches_jax(d):
    """The grid's multilinear interpolation at 1e-5, inside the grid and
    clamped beyond its edges; no online deposition."""
    rng = np.random.default_rng(10 + d)
    centers = rng.random((4, d))
    ranges = [np.linspace(0, 1, 11)] * d
    g = TMD.MetadynamicsStateGridded(centers, ranges, 0.8, 0.15,
                                     device="cpu")
    jg = JMD.MetadynamicsStateGridded(centers, ranges, 0.8, 0.15)
    zs = rng.uniform(-0.3, 1.3, size=(20, d)).astype(np.float32)
    ref = np.array([float(jg.bias_potential(jnp.asarray(z))) for z in zs])
    _close(g.bias_potential(torch.tensor(zs)).numpy(), ref)
    with pytest.raises(NotImplementedError):
        g.deposit(zs[:1])


def test_bias_force_matches_jax(isos):
    """-grad of the well-tempered bias through the same chi at 1e-5: one
    point and a batch of three.  The centers lie off the data's chi (the
    untrained chi spans ~0.01, so Gaussians over the data's own values
    would cancel their gradients and magnify float32 rounding)."""
    jiso, tiso = isos
    c = float(tiso.chis().mean()) + np.array([[-0.15], [0.1], [0.3]])
    md = TMD.MetadynamicsSimulation(
        tiso, height=1.0, sigma=0.2,
        mdstate=TMD.MetadynamicsState(torch.tensor(c, dtype=torch.float32)))
    jmd = JMD.MetadynamicsSimulation(jiso, height=1.0, sigma=0.2,
                                     mdstate=JMD.MetadynamicsState(c))
    x = tiso.data.coords[:3]
    ref = np.asarray(jmd(jnp.asarray(x.numpy())))
    _close(md(x).numpy(), ref)
    f0 = md(x[0])
    assert f0.shape == (66,) and torch.isfinite(f0).all()
    _close(f0.numpy(), ref[0])
    _close(float(md.bias_energy(x[0])), float(jmd.bias_energy(
        jnp.asarray(x[0].numpy()))))


def test_trajectory_matches_jax(isos, monkeypatch):
    """10 ABOBA steps from a start point, the port fed the JAX package's
    momenta and normals: the saved frames at 1e-5, the weights at 1e-5."""
    jiso, tiso = isos
    md = TMD.MetadynamicsSimulation(tiso, height=0.5, sigma=0.2)
    jmd = JMD.MetadynamicsSimulation(jiso, height=0.5, sigma=0.2)
    key = jax.random.PRNGKey(4)
    kv, ki = jax.random.split(key)
    z0 = np.asarray(jax.random.normal(kv, (1, 66)))
    normals = iter([np.asarray(jax.random.normal(k, (1, 66)))
                    for k in jax.random.split(ki, 10)])
    monkeypatch.setattr(I, "maxwell_boltzmann", lambda gen, m3, T, shape:
                        torch.tensor(z0) * torch.sqrt(KB * T / m3))
    monkeypatch.setattr(I, "_normals", lambda gen, x: torch.tensor(
        next(normals)).to(x.dtype))
    x0 = tiso.data.coords[2]
    t = md.trajectory(x0=x0, steps=10, saveevery=5)
    jt = jmd.trajectory(x0=jnp.asarray(x0.numpy()), steps=10, saveevery=5,
                        key=key)
    assert t.values.shape == (2, 66) and t.weights.shape == (2,)
    _close(t.values.numpy(), jt.values)
    _close(t.weights.numpy(), jt.weights)


def test_wt_free_energy(isos):
    jiso, tiso = isos
    md = TMD.MetadynamicsSimulation(tiso, height=1.0, sigma=0.2)
    jmd = JMD.MetadynamicsSimulation(jiso, height=1.0, sigma=0.2)
    zs = np.linspace(0, 1, 5)[:, None]
    F = md.wt_free_energy(zs)
    assert F.shape == (5,) and bool((F <= 0).all())
    _close(F.numpy(), jmd.wt_free_energy(zs))


def test_gridded_wt_free_energy(isos):
    """A 1-D grid over [0, 1] inside ``wt_free_energy``: finite, <= 0."""
    _, tiso = isos
    grid = TMD.MetadynamicsStateGridded(
        tiso.chis(), [np.linspace(0, 1, 51)], 1.0, 0.1)
    md = TMD.MetadynamicsSimulation(tiso, mdstate=grid)
    F = md.wt_free_energy(np.linspace(-0.2, 1.2, 8)[:, None])
    assert F.shape == (8,) and torch.isfinite(F).all() and (F <= 0).all()


def test_bias_is_frozen_at_construction(md_iso):
    """A bias built before ``iso.run`` is unchanged after it (the chi
    model is a frozen copy), and ``iso.run`` still trains."""
    iso = itt.Iso(data=md_iso.data, model=itt.pairnet(231), gen=1,
                  opt=itt.AdamRegularized())
    md = TMD.MetadynamicsSimulation(iso, height=1.0, sigma=0.2)
    x = iso.data.coords[:2]
    f0 = md(x)
    chi0 = iso.chis()
    iso.run(3)
    assert not torch.equal(iso.chis(), chi0)
    assert torch.equal(md(x), f0)


# ---- the JAX tests' assertions ----------------------------------------------

def test_bias_force_and_trajectory(md_iso):
    md = TMD.MetadynamicsSimulation(md_iso, height=1.0, sigma=0.2)
    x = md_iso.data.coords[0]
    f = md(x)
    assert f.shape == x.shape and torch.isfinite(f).all()
    md = TMD.MetadynamicsSimulation(md_iso, height=0.1, sigma=0.2)
    t = md.trajectory(steps=10, saveevery=5, gen=0)
    assert t.values.shape == (2, 66) and torch.isfinite(t.values).all()
    with pytest.raises(TypeError):
        md.trajectory(key=0)


def test_adaptive_metadynamics(md_iso):
    iso = itt.Iso(data=md_iso.data, model=md_iso.model, gen=2,
                  opt=itt.AdamRegularized())
    n0 = len(iso.data)
    out = W.adaptive_metadynamics(iso, deposit=5, height=0.1, sigma=0.2,
                                  gen=3)
    assert len(iso.data) == n0 + 2 and out["xnew"].shape == (2, 66)
    with pytest.raises(AssertionError, match="drifted"):
        W.adaptive_metadynamics(iso, deposit=5, maxnorm=1e-6, gen=3)


def test_metadynamics_workflow():
    """``tests/test_workflow.py:67-79`` on the port."""
    sim = itt.MDSimulation(steps=5, device="cpu")
    iso = itt.Iso(sim=sim, nx=8, nk=2, gen=3, minibatch=0,
                  opt=itt.AdamRegularized())
    iso.run(5)
    md = itt.MetadynamicsSimulation(iso, height=0.1, sigma=0.2)
    t = md.trajectory(steps=5, gen=4)
    assert torch.isfinite(t.values).all()
    itt.run_metadynamics(iso, generations=1, iter=3, deposit=5,
                         height=0.1, sigma=0.2)
    assert len(iso.losses) == 8 and len(iso.data) == 9
    itt.run_both(iso, generations=1, samples_kde=1, iter=2, deposit=5)
    assert len(iso.losses) == 12 and len(iso.data) == 11
    assert np.all(np.isfinite(iso.losses))
    for fn in (itt.run_metadynamics, itt.run_both):
        with pytest.raises(NotImplementedError, match="utils/plots.py"):
            fn(iso, generations=1, plots=[])


@pytest.mark.parametrize("make", [
    lambda: TMD.MetadynamicsState(np.zeros((2, 1))),
    lambda: TMD.MetadynamicsStateGridded(np.zeros((1, 1)),
                                         [np.linspace(0, 1, 5)], 1.0, 0.1),
    lambda: itt.LinearInterpolant([0.0, 1.0], np.eye(2)),
    lambda: itt.KDEExpectation(np.zeros((3, 1)), np.zeros((3, 2)), 0.5),
    lambda: itt.analysis.kde_mi(np.zeros(5), np.ones(5)),
])
def test_arrays_go_to_the_card(make):
    """Arrays given without a device go to the card: with no GPU that
    raises (tensors stay on their device, ``device="cpu"`` names the
    CPU)."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make()
