"""The rest of the port's ``sample.py`` (KDE needles, farthest-point and
aligned picking, chi extrapolation) and ``analysis/minimumpath.py``
against the JAX package's on the CPU, on the same inputs (seeded numpy
draws, the committed alanine frames) and the same chi weights carried
across with ``weights.load_jax_params``."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

import isokann_tpu as itk
import isokann_tpu.analysis.minimumpath as JM
import isokann_tpu.sample as JS
from isokann_tpu.models import pairnet as jax_pairnet
from isokann_tpu.models import smallnet as jax_smallnet

import isokann_tpu_torch as itt
import isokann_tpu_torch.analysis.minimumpath as TM
import isokann_tpu_torch.sample as TS
from isokann_tpu_torch.weights import load_jax_params

# small tensor ops: one intra-op thread each; several test workers
# share the machine and oversubscribed threads slow them 50x
torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "..", "data", "golden",
                      "ala2_vacuum_msm.npz")
NPAIRS = 231


def _params_np(params):
    return jax.tree_util.tree_map(np.asarray, params)


# --------------------------------------------------------------------------
# host selections
# --------------------------------------------------------------------------

@pytest.mark.parametrize("bandwidth", [0.02, 0.1])
def test_kde_needles_match_jax(bandwidth):
    xs = np.random.default_rng(0).beta(2.0, 5.0, size=300)
    got = TS.kde_needles(xs, 12, bandwidth=bandwidth)
    ref = JS.kde_needles(xs, 12, bandwidth=bandwidth)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12)
    ys = np.random.default_rng(1).uniform(size=500)
    iy = TS.resample_kde_needles(xs, ys, 12, bandwidth=bandwidth)
    assert np.array_equal(iy, JS.resample_kde_needles(
        xs, ys, 12, bandwidth=bandwidth))
    assert len(set(iy.tolist())) == 12


def test_picking_matches_jax():
    """The numpy max-min path against the JAX package's (its native
    helper where built): the same indices, the same distances."""
    X = np.random.default_rng(2).normal(size=(200, 5))
    picked, qs, d = TS.picking(X, 15)
    jp, jq, jd = JS.picking(X, 15)
    assert np.array_equal(qs, np.asarray(jq))
    np.testing.assert_allclose(d, np.asarray(jd), rtol=1e-12)
    np.testing.assert_array_equal(picked, X[qs])
    assert len(set(qs.tolist())) == 15
    with pytest.raises(ValueError, match="cannot pick"):
        TS.picking(X[:3], 4)


def test_picking_aligned_matches_jax():
    """Alanine-sized structures under random rotations and shifts: the
    same picks by aligned RMSD as the JAX package, distances at 1e-5 nm,
    the picked rows centered."""
    rng = np.random.default_rng(3)
    base = rng.normal(scale=0.2, size=(22, 3))
    xs = np.stack([
        ((base + rng.normal(scale=0.05, size=base.shape))
         @ Rotation.random(random_state=i).as_matrix().T
         + rng.normal(size=3)).ravel() for i in range(120)]).astype(
             np.float32)
    picked, qs, d = TS.picking_aligned(torch.tensor(xs), 10)
    jp, jq, jd = JS.picking_aligned(xs, 10)
    assert np.array_equal(qs, np.asarray(jq))
    np.testing.assert_allclose(d, np.asarray(jd), atol=1e-5)
    assert picked.dtype == torch.float32 and picked.shape == (10, 66)
    np.testing.assert_allclose(picked.numpy(), np.asarray(jp), atol=1e-6)
    np.testing.assert_allclose(picked.reshape(10, 22, 3).mean(1).numpy(),
                               0.0, atol=1e-6)


# --------------------------------------------------------------------------
# chi gradients, levelset minimization and extrapolation on alanine
# --------------------------------------------------------------------------

def _center(x):
    s = x.reshape(x.shape[:-1] + (-1, 3))
    return (s - s.mean(axis=-2, keepdims=True)).reshape(x.shape)


@pytest.fixture(scope="module")
def golden():
    """12 committed frames x 3 bursts, each frame centered: the committed
    frames lie more than 10 nm from the origin, where the float32 Gram
    trick of both packages' distances loses digits of chi's gradient."""
    z = np.load(GOLDEN)
    sub = np.random.default_rng(4).choice(len(z["xs"]), 12, replace=False)
    assert np.abs(z["xs"][sub]).max() > 10.0
    return (_center(z["xs"][sub]).astype(np.float32),
            _center(z["ys"][sub][:, :3]).astype(np.float32))


@pytest.fixture(scope="module")
def isos(golden):
    """The same data and chi weights in both packages (pairnet(231),
    LayerNorm, seed 3), at 12 committed frames x 3 bursts."""
    xs, ys = golden
    jsim = itk.MDSimulation(steps=10)
    tsim = itt.MDSimulation(steps=10, device="cpu")
    jm = jax_pairnet(n=NPAIRS, key=jax.random.PRNGKey(3))
    tm = load_jax_params(itt.pairnet(NPAIRS), _params_np(jm.params))
    jiso = itk.Iso(data=itk.SimulationData.from_coords(jsim, xs, ys),
                   model=jm, key=0)
    tiso = itt.Iso(data=itt.SimulationData.from_coords(
        tsim, torch.tensor(xs), torch.tensor(ys)), model=tm, gen=0)
    return jiso, tiso


def test_dchidx_matches_jax_grad(isos, golden):
    jiso, tiso = isos
    for x in golden[0][:4]:
        ref = np.asarray(JS.dchidx(jiso, jnp.asarray(x)))
        got = TS.dchidx(tiso, torch.tensor(x)).numpy()
        assert TS.dchidx is TM.dchidx
        np.testing.assert_allclose(got, ref, rtol=1e-5,
                                   atol=1e-5 * np.abs(ref).max())
        np.testing.assert_allclose(
            got, np.asarray(JM.dchidx(jiso, jnp.asarray(x))), rtol=1e-5,
            atol=1e-5 * np.abs(ref).max())


def test_minimize_levelset_matches_jax(isos, golden):
    """20 projected steps at lr 1e-7 (stable on a thermal frame) on chi's
    levelset through both packages' potentials: 1e-5 nm apart; chi stays
    on its level and the energy falls."""
    jiso, tiso = isos
    x0 = golden[0][0]
    got = TM.energyminimization_chilevel(tiso, torch.tensor(x0), lr=1e-7)
    ref = np.asarray(JM.energyminimization_chilevel(jiso, jnp.asarray(x0),
                                                    lr=1e-7))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5)
    sim = tiso.data.sim
    assert float(sim.potential(got[None])[0]) < float(
        sim.potential(torch.tensor(x0)[None])[0])
    chi = TM._chifun(tiso)
    assert abs(float(chi(got).detach())
               - float(chi(torch.tensor(x0)).detach())) < 1e-5
    # the generic form on the same functions
    U = lambda z: sim.potential(z[None])[0]  # noqa: E731
    np.testing.assert_allclose(
        TM.minimize_levelset(torch.tensor(x0), chi, U, lr=1e-7).numpy(),
        ref, atol=1e-5)


def test_default_lr_diverges_in_both_packages(isos, golden):
    """At the reference's default lr 1e-5 plain gradient descent is
    unstable on a bonded force field (thermal forces above 1e3
    kJ/mol/nm): both packages raise, so ``extrapolate(minimize=True)``
    keeps no alanine point in either."""
    jiso, tiso = isos
    x0 = golden[0][1]
    _, g = TM._value_and_grad(
        lambda z: tiso.data.sim.potential(z[None])[0], torch.tensor(x0))
    assert float(g.abs().max()) > 1e3
    with pytest.raises(FloatingPointError):
        JM.energyminimization_chilevel(jiso, jnp.asarray(x0))
    with pytest.raises(FloatingPointError):
        TM.energyminimization_chilevel(tiso, torch.tensor(x0))
    assert JS.extrapolate(jiso, 1, stepsize=0.01, maxskips=2).shape \
        == (0, 66)
    assert TS.extrapolate(tiso, 1, stepsize=0.01, maxskips=2).shape \
        == (0, 66)


def test_extrapolate_without_minimize_matches_jax(isos):
    """minimize=False: 2 n points, the n lowest chi pushed down and the n
    highest up, at 1e-5 nm of the JAX package's; each point's chi moved
    by about the step in its direction."""
    jiso, tiso = isos
    ref = JS.extrapolate(jiso, 2, stepsize=0.01, steps=2, minimize=False)
    got = TS.extrapolate(tiso, 2, stepsize=0.01, steps=2, minimize=False)
    assert got.shape == ref.shape == (4, 66)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)
    coords = itt.flattenfirst(tiso.data.propcoords)
    chi0 = tiso.model(itt.flattenfirst(tiso.data.propfeatures))[:, 0]
    order = np.argsort(chi0.detach().numpy())
    starts = np.concatenate([order[:2], order[::-1][:2]])
    dchi = (tiso.chicoords(got)[:, 0] - chi0[starts]).detach().numpy()
    np.testing.assert_allclose(dchi, [-0.02, -0.02, 0.02, 0.02], atol=5e-3)
    assert float((got - coords[starts]).abs().max()) > 0


# --------------------------------------------------------------------------
# extrapolation with minimization, on the Doublewell
# --------------------------------------------------------------------------

def test_jax_one_point_potential_misreads_2d_diffusions():
    """Why the minimizing extrapolation is held on the 1-D Doublewell:
    the JAX package's ``energyminimization_chilevel`` takes a Diffusion's
    energy as ``sim.potential(x[None])[0]``, its one-point potential on a
    (1, d) batch, which for d = 2 reads ``x[1]`` past the batch (JAX
    clamps the index): the Triplewell's energy is then wrong there, and
    right in the port, whose potentials take batches."""
    x = np.asarray([0.5, 1.2], np.float32)
    js, ts = itk.Triplewell(), itt.Triplewell(device="cpu")
    exact = float(js.potential(jnp.asarray(x)))
    assert abs(float(js.potential(jnp.asarray(x)[None])[0]) - exact) > 1e-2
    assert abs(float(ts.potential(torch.tensor(x)[None])[0]) - exact) < 1e-5
    dw = itk.Doublewell()
    assert abs(float(dw.potential(jnp.asarray([0.3])[None])[0])
               - float(dw.potential(jnp.asarray([0.3])))) < 1e-6


def test_extrapolate_minimize_on_doublewell_matches_jax():
    """minimize=True where the JAX package evaluates the potential of its
    one-point form correctly (1-D): the Doublewell, a smallnet chi with
    the same weights; ``addextrapolates`` adds the points."""
    rng = np.random.default_rng(5)
    xs = rng.uniform(-1.5, 1.5, size=(16, 1)).astype(np.float32)
    ys = (xs[:, None, :] + 0.1 * rng.normal(size=(16, 4, 1))).astype(
        np.float32)
    jm = jax_smallnet(1, key=jax.random.PRNGKey(6))
    tm = load_jax_params(itt.smallnet(1), _params_np(jm.params))
    jiso = itk.Iso(data=itk.SimulationData.from_coords(
        itk.Doublewell(), xs, ys), model=jm, key=0)
    tiso = itt.Iso(data=itt.SimulationData.from_coords(
        itt.Doublewell(device="cpu"), torch.tensor(xs), torch.tensor(ys)),
        model=tm, gen=0)
    ref = np.asarray(JS.extrapolate(jiso, 3, stepsize=0.05))
    got = TS.extrapolate(tiso, 3, stepsize=0.05)
    assert got.shape == ref.shape == (6, 1)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-6)
    n0 = len(tiso.data)
    TS.addextrapolates(tiso, 3, stepsize=0.05)
    assert len(tiso.data) == n0 + 6
    np.testing.assert_allclose(tiso.data.coords[n0:].numpy(), ref,
                               rtol=1e-5, atol=1e-6)
    assert TS.addextrapolates(tiso, 0) is tiso and len(tiso.data) == n0 + 6
