"""The port's free energy (``analysis/freeenergy.py``), mutual information
(``analysis/mutualinformation.py``) and committor (``analysis/
committor.py``) against the JAX package's on the CPU: the same inputs
(seeded numpy draws, committed alanine frames, the same chi weights
through ``weights.load_jax_params``), the noisy levelset dynamics fed the
JAX package's normals through ``md.integrators._normals``."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import isokann_tpu as itk
import isokann_tpu.analysis.committor as JC
import isokann_tpu.analysis.freeenergy as JF
import isokann_tpu.analysis.mutualinformation as JMI
from isokann_tpu.models import pairnet as jax_pairnet

import isokann_tpu_torch as itt
import isokann_tpu_torch.analysis.committor as TC
import isokann_tpu_torch.analysis.freeenergy as TF
import isokann_tpu_torch.analysis.mutualinformation as TMI
from isokann_tpu_torch.md import integrators as I
from isokann_tpu_torch.weights import load_jax_params

# small tensor ops: one intra-op thread each; several test workers
# share the machine and oversubscribed threads slow them 50x
torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "..", "data", "golden",
                      "ala2_vacuum_msm.npz")
NPAIRS = 231


def _center(x):
    s = x.reshape(x.shape[:-1] + (-1, 3))
    return (s - s.mean(axis=-2, keepdims=True)).reshape(x.shape)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.fixture(scope="module")
def isos():
    """40 committed alanine frames x 2 bursts (centered) in both
    packages, chi the same pairnet(231) weights (seed 7)."""
    z = np.load(GOLDEN)
    sub = np.random.default_rng(8).choice(len(z["xs"]), 40, replace=False)
    xs = _center(z["xs"][sub]).astype(np.float32)
    ys = _center(z["ys"][sub][:, :2]).astype(np.float32)
    jsim = itk.MDSimulation(steps=10)
    tsim = itt.MDSimulation(steps=10, device="cpu")
    jm = jax_pairnet(n=NPAIRS, key=jax.random.PRNGKey(7))
    tm = load_jax_params(itt.pairnet(NPAIRS), jax.tree_util.tree_map(
        np.asarray, jm.params))
    jiso = itk.Iso(data=itk.SimulationData.from_coords(jsim, xs, ys),
                   model=jm, key=0)
    tiso = itt.Iso(data=itt.SimulationData.from_coords(
        tsim, torch.tensor(xs), torch.tensor(ys)), model=tm, gen=0)
    return jiso, tiso


# ---- mutual information -----------------------------------------------------

class _Float64Numpy:
    """``jax.numpy`` with ``float32`` read as ``float64``: the JAX
    package's MI code evaluated in float64 (under ``jax.enable_x64``)."""

    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


def _jax_mi(monkeypatch, fn, *args, **kwargs):
    """The JAX package's ``fn`` in float32 as it is, and in float64."""
    ref32 = np.asarray(fn(*args, **kwargs), np.float64)
    with monkeypatch.context() as m, jax.enable_x64():
        m.setattr(JMI, "jnp", _Float64Numpy())
        ref64 = np.asarray(fn(*args, **kwargs), np.float64)
    return ref32, ref64


def _check_mi(got, ref32, ref64):
    """The port (float64 inside) within 1e-4 relative of the JAX formula
    in float64, and no farther from the JAX package's float32 result
    than that result's own float32 error plus 1e-4 relative."""
    got = np.asarray(got, np.float64)
    tol = 1e-4 * np.abs(ref64)
    assert np.all(np.abs(got - ref64) <= tol)
    assert np.all(np.abs(got - ref32) <= np.abs(ref32 - ref64) + tol)


@pytest.mark.parametrize("bandwidth", [None, 0.3])
def test_kde_mi_matches_jax(bandwidth, monkeypatch):
    rng = np.random.default_rng(1)
    x = rng.normal(size=500)
    y_ind = rng.normal(size=500)
    y_dep = x + 0.1 * rng.normal(size=500)
    mis = []
    for y in (y_ind, y_dep):
        got = float(TMI.kde_mi(torch.tensor(x), torch.tensor(y),
                               bandwidth=bandwidth))
        _check_mi(got, *_jax_mi(monkeypatch, JMI.kde_mi, x, y,
                                bandwidth=bandwidth))
        mis.append(got)
    assert mis[1] > mis[0] + 0.5


def test_mutual_information_matches_jax(isos, monkeypatch):
    """MI of the 231 features with chi (see ``_check_mi``); chunks of
    three features give the same values."""
    jiso, tiso = isos
    got = TMI.mutual_information(tiso)
    assert got.shape == (NPAIRS,) and torch.isfinite(got).all()
    _check_mi(got.numpy(), *_jax_mi(monkeypatch, JMI.mutual_information,
                                    jiso))
    monkeypatch.setattr(TMI, "_CHUNK_ELEMENTS", 3 * 40 * 100)
    np.testing.assert_array_equal(TMI.mutual_information(tiso).numpy(),
                                  got.numpy())


def test_mutual_information_doublewell():
    """The JAX test's shape on a 1-D system."""
    iso = itt.Iso(sim=itt.Doublewell(device="cpu"), nx=32, nk=4, gen=0)
    mi = itt.mutual_information(iso)
    assert mi.shape == (1,) and torch.isfinite(mi).all()


# ---- free energy ------------------------------------------------------------

def test_marginal_free_energy_matches_jax(isos):
    jiso, tiso = isos
    centers, F = TF.marginal_free_energy(tiso, nbins=20)
    jc, jF = JF.marginal_free_energy(jiso, nbins=20)
    assert len(centers) == 20 and np.nanmin(F) == 0.0
    assert np.array_equal(np.isfinite(F), np.isfinite(jF))
    fin = np.isfinite(jF)
    np.testing.assert_allclose(centers, jc, atol=1e-6)
    np.testing.assert_allclose(F[fin], jF[fin], atol=1e-6)
    chi = tiso.chis()[:, 0].numpy()
    jchi = np.asarray(jiso.chis())[:, 0]
    assert np.array_equal(np.histogram(chi, bins=20)[0],
                          np.histogram(jchi, bins=20)[0])


def test_integrate_chi_and_delta_g():
    chi = np.linspace(0, 1, 11)
    f = np.random.default_rng(2).normal(size=11)
    np.testing.assert_array_equal(TF.integrate_chi(f, chi),
                                  JF.integrate_chi(f, chi))
    assert TF.integrate_chi(np.ones(11), chi)[-1] == pytest.approx(1.0)
    chi = np.linspace(0, 1, 100)
    PMF = (chi - 0.3) ** 2
    dg = TF.delta_G(PMF, chi)
    assert dg == JF.delta_G(PMF, chi)
    assert dg == pytest.approx(0.0 - (0.5 - 0.3) ** 2, abs=5e-3)


@pytest.mark.parametrize("n", [5, 10])
def test_sample_uniform_chi_coords_matches_jax(isos, n):
    jiso, tiso = isos
    xs = TF.sample_uniform_chi_coords(tiso, n)
    ref = np.asarray(JF.sample_uniform_chi_coords(jiso, n))
    assert xs.shape == (n, 66)
    np.testing.assert_array_equal(xs.numpy(), ref)


def test_sample_uniform_chi_doublewell():
    iso = itt.Iso(sim=itt.Doublewell(device="cpu"), nx=32, nk=4, gen=0)
    assert TF.sample_uniform_chi_coords(iso, 10).shape == (10, 1)


def test_local_mean_force_matches_jax(isos):
    jiso, tiso = isos
    xs = tiso.data.coords[:12]
    c, F = TF.local_mean_force(tiso, xs, nbins=4)
    jc, jF = JF.local_mean_force(jiso, xs.numpy(), 4)
    assert c.shape == (4,) and F.shape == (4,)
    np.testing.assert_allclose(c, jc, atol=1e-6)
    assert _rel(F, jF) < 1e-4
    assert np.array_equal(TF.local_mean_force(tiso, xs, 4, False), F)


def test_constrained_free_energy_matches_jax(isos, monkeypatch):
    """10 steps from 6 levelset start points, the port fed the JAX
    package's normals: chi levels and F at 1e-4 relative."""
    jiso, tiso = isos
    xs = TF.sample_uniform_chi_coords(tiso, 6)
    key = jax.random.PRNGKey(3)
    normals = iter([np.asarray(jax.random.normal(k, tuple(xs.shape),
                                                 jnp.float32))
                    for k in jax.random.split(key, 10)])
    monkeypatch.setattr(I, "_normals", lambda gen, x: torch.tensor(
        next(normals)).to(x.dtype))
    chi, F = TF.constrained_free_energy(tiso, xs, steps=10)
    jchi, jF = JF.constrained_free_energy(jiso, xs.numpy(), steps=10,
                                          key=key)
    assert chi.shape == (6,) and np.all(np.diff(chi) >= 0)
    assert np.all(np.isfinite(F))
    np.testing.assert_allclose(chi, jchi, atol=1e-6)
    assert _rel(F, jF) < 1e-4


def test_constrained_free_energy_draws_from_gen(isos):
    """Two runs on the same generator seed agree; the noise moves F."""
    _, tiso = isos
    xs = tiso.data.coords[:4]
    a = TF.constrained_free_energy(tiso, xs, steps=3, gen=5)[1]
    b = TF.constrained_free_energy(tiso, xs, steps=3, gen=5)[1]
    c = TF.constrained_free_energy(tiso, xs, steps=3, gen=6)[1]
    assert np.array_equal(a, b) and not np.array_equal(a, c)


# ---- committor --------------------------------------------------------------

def _generator(n, seed):
    rng = np.random.default_rng(seed)
    Q = rng.uniform(0.1, 1.0, size=(n, n)) * (rng.random((n, n)) < 0.6)
    np.fill_diagonal(Q, 0.0)
    Q += np.diag(np.ones(n - 1) * 0.3, 1) + np.diag(np.ones(n - 1) * 0.3, -1)
    np.fill_diagonal(Q, -Q.sum(axis=1))
    return Q


def test_committor_three_states():
    """The JAX test's chain A <-> I <-> B, and the JAX package's values
    at 1e-10."""
    Q = np.array([[-1.0, 1.0, 0.0], [0.5, -1.0, 0.5], [0.0, 1.0, -1.0]])
    classes = np.array([2.0, 0.0, 1.0])
    c = TC.solve_committor(Q, classes)
    assert c[0] == pytest.approx(0.0, abs=1e-8)
    assert c[2] == pytest.approx(1.0, abs=1e-8)
    assert 0.4 < c[1] < 0.6
    np.testing.assert_allclose(c, JC.solve_committor(Q, classes), atol=1e-10)


@pytest.mark.parametrize("seed", [0, 1])
def test_committor_matches_jax(seed):
    Q = _generator(8, seed)
    classes = np.array([2, 0, 0, 0, 0, 0, 0, 1], dtype=float)
    A, b = TC.committor_system(Q, classes)
    jA, jb = JC.committor_system(Q, classes)
    np.testing.assert_array_equal(A.toarray(), jA.toarray())
    np.testing.assert_array_equal(b, jb)
    c = TC.solve_committor(Q, classes)
    np.testing.assert_allclose(c, JC.solve_committor(Q, classes), atol=1e-10)
    # the solution satisfies the interior rows of Q q = 0
    np.testing.assert_allclose((Q @ c)[1:-1], 0.0, atol=1e-6)
    assert c[0] == 0.0 and abs(c[-1] - 1.0) < 1e-12
