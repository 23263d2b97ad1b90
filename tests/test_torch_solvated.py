"""Port parity of the explicit-solvent path: rigid-water SHAKE / RATTLE,
the constrained LangevinMiddle steps over the neighbor engine, the
solute-pair default features, the cell-overflow safety net and the
learner on solvated data, against the JAX package on the same numpy
inputs (CPU)."""

import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import isokann_tpu as itk
from isokann_tpu.data import SimulationData as JaxData
from isokann_tpu.md import integrators as JI
from isokann_tpu.md import neighbor as JN

import isokann_tpu_torch as itt
from isokann_tpu_torch.md import neighbor as NB
from isokann_tpu_torch.md import neighbor_kernel as NK
from isokann_tpu_torch.md.constraints import ConstraintSet
from isokann_tpu_torch.simulators.mdsim import solute_pairs
from isokann_tpu_torch.weights import load_jax_params

# small tensor ops: one intra-op thread each; several test workers
# share the machine and oversubscribed threads slow them 50x
torch.set_num_threads(1)

KW = dict(addwater=True, padding=0.7, steps=3, dense_pairs=False)
TRPCAGE = os.path.join(os.path.dirname(__file__), "..", "out",
                       "trpcage.pdb")


@pytest.fixture(scope="module")
def jsim():
    return itk.MDSimulation(**KW)


@pytest.fixture(scope="module")
def sim():
    return itt.MDSimulation(device="cpu", **KW)


def _walkers(sim, n, scale, seed):
    x0 = sim.coords.numpy()
    rng = np.random.default_rng(seed)
    return (x0[None] + rng.normal(scale=scale, size=(n, x0.size))
            ).astype(np.float32)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / np.abs(b).max()


def test_solvated_simulation_matches_jax_setup(jsim, sim):
    """The neighbor route with rigid water: the same waters, constraint
    tables, start coordinates and solute-pair features as the JAX
    package."""
    assert sim.route == "neighbor" and not sim.system.dense_pairs
    cj, ct = jsim.constraint_set, sim.constraint_set
    assert (ct.wstart, ct.nwater, ct.iters, ct.ncons) == \
        (cj.wstart, cj.nwater, cj.iters, cj.ncons)
    assert cj.ngeneric == 0
    np.testing.assert_array_equal(ct._np["w_invm"], np.asarray(cj.w_invm))
    # the same three constraints, (0, 2) taken as (2, 0)
    lengths = dict(zip(cj._wpairs, np.asarray(cj.w_r0)))
    assert {tuple(sorted(p)): r for p, r in zip(
        ct.pairs, ct._np["w_r0"])} == lengths
    np.testing.assert_array_equal(sim.coords.numpy(),
                                  np.asarray(jsim.coords))
    assert isinstance(sim.featurizer, itt.FeaturesPairs)
    assert sim.featurizer.pairs == tuple(jsim.featurizer.pairs)
    assert len(sim.featurizer.pairs) == 22 * 21 // 2


def test_solute_pairs_draw_matches_jax():
    """Above 100 solute atoms: 100 pairs drawn by ``default_rng(0)``, as
    the JAX package draws them (trp-cage, 313 atoms)."""
    js = itk.MDSimulation(pdb=TRPCAGE, addwater=True, padding=0.4, steps=3,
                          dense_pairs=False)
    assert solute_pairs(313) == [tuple(p) for p in js.featurizer.pairs]


def test_shake_and_rattle_match_jax(jsim, sim):
    """One SHAKE projection and one RATTLE pass (on the same positions)
    from perturbed positions and random velocities: 1e-6 of the largest
    value; a step-sized displacement is projected onto the constraints."""
    x_ref = _walkers(sim, 2, 0.002, 0)
    x = x_ref + np.random.default_rng(1).normal(
        scale=0.01, size=x_ref.shape).astype(np.float32)
    v = np.random.default_rng(2).normal(size=x.shape).astype(np.float32)
    cj, ct = jsim.constraint_set, sim.constraint_set
    xs = ct.shake(torch.as_tensor(x_ref), torch.as_tensor(x))
    xs_j = np.asarray(cj.shake(jnp.asarray(x_ref), jnp.asarray(x)))
    assert _rel(xs.numpy(), xs_j) < 1e-6
    vr = ct.rattle(torch.tensor(xs_j), torch.as_tensor(v))
    vr_j = np.asarray(cj.rattle(jnp.asarray(xs_j), jnp.asarray(v)))
    assert _rel(vr.numpy(), vr_j) < 1e-6
    # a half drift (1 fs) of rigid waters with RATTLE'd thermal-scale
    # velocities is projected back to 1e-5 nm
    start = torch.as_tensor(_walkers(sim, 2, 0.0, 0))
    step = start + 0.001 * ct.rattle(start, torch.as_tensor(v))
    assert ct.max_violation(start) < 1e-6 < 1e-5 < ct.max_violation(step)
    assert ct.max_violation(ct.shake(start, step)) < 1e-5
    assert abs(ct.max_violation(x) - float(cj.max_violation(x))) < 1e-7
    solute = slice(0, 3 * ct.wstart)
    np.testing.assert_array_equal(xs.numpy()[:, solute], x[:, solute])


def test_unported_constraint_options_raise(jsim, sim):
    """HBonds and scattered waters (the generic solver) build, with the
    JAX package's constraints and classes, and SHAKE as it does."""
    from isokann_tpu.md.constraints import ConstraintSet as JaxCS
    from isokann_tpu_torch.md.solvate import water_triplets
    trip = water_triplets(sim.structure)[[0, 5, 9]]
    x0 = _walkers(sim, 2, 0.0, 0)
    x = x0 + np.random.default_rng(8).normal(
        scale=0.002, size=x0.shape).astype(np.float32)
    for which, water in (("HBonds", None), (None, trip), ("HBonds", trip)):
        ct = ConstraintSet(sim.system, which=which, water=water)
        cj = JaxCS(jsim.system, which, water=water)
        assert ct.nwater == 0 and (ct.ncons, ct.ngeneric) == \
            (cj.ncons, cj.ngeneric) > (0, 0)
        assert [list(k) for k in ct.classes] == [
            [int(np.flatnonzero((np.asarray(cj.idx_i) == a)
                                & (np.asarray(cj.idx_j) == b))[0])
             for a, b in zip(np.asarray(c[0]), np.asarray(c[1]))]
            for c in cj._classes]
        xs = ct.shake(torch.as_tensor(x0), torch.as_tensor(x)).numpy()
        xs_j = np.asarray(cj.shake(jnp.asarray(x0), jnp.asarray(x)))
        assert np.abs(xs - xs_j).max() < 1e-6


def test_noiseless_constrained_steps_match_jax(jsim, sim):
    """10 noiseless constrained LangevinMiddle steps (T = 0 in the JAX
    package, no noise in the port) over the neighbor forces, from the same
    start (rigid waters) and velocities: x to 1e-5, v to 1e-4 of the
    largest value.

    The JAX package runs in float64 here.  Its float32 run recovers the
    velocity from constrained positions of a few nm over dt/2, and its
    own rounding then moves v by ~6e-4 and x by ~3e-5 (relative) in 10
    steps of this stiff lattice start; the port carries SHAKE in the
    displacement and stays ~100 times closer to the exact result."""
    assert sim.route == "neighbor"
    xs = _walkers(sim, 2, 0.0, 3)      # rigid waters; the walkers differ
    v0 = np.random.default_rng(4).normal(scale=0.3, size=xs.shape
                                         ).astype(np.float32)
    jp = JN.NeighborPlan(jsim.system, x0=np.asarray(jsim.coords).reshape(
        -1, 3))

    def jf(z):
        return jax.vmap(lambda xi: JN.force_neighbor(
            jsim.system, xi.reshape(-1, 3), jp).reshape(-1))(z)

    with jax.enable_x64():
        run = jax.jit(lambda x, v: JI.langevin_middle(
            jf, x, v, jsim.masses3, 0.0, 1.0, 0.002, 10,
            jax.random.PRNGKey(0), constraints=jsim.constraint_set))
        x, v = run(jnp.asarray(xs, jnp.float64), jnp.asarray(v0, jnp.float64))
        x, v = np.asarray(x), np.asarray(v)
    assert x.dtype == np.float64
    n0 = NK.neighbor_sweep.launches
    xt, vt = sim._integrate(torch.as_tensor(xs), torch.as_tensor(v0), 10,
                            None)
    assert NK.neighbor_sweep.launches == n0
    assert _rel(xt.numpy(), x) < 1e-5
    assert _rel(vt.numpy(), v) < 1e-4
    assert sim.constraint_set.max_violation(xt) < 1e-5


def test_propagate_and_randx0_keep_the_constraints(sim):
    """The entry points on the neighbor route: finite frames of the right
    shapes, rigid waters held, no overflow, no kernel launch on the CPU."""
    n0 = NK.neighbor_sweep.launches
    xs = sim.randx0(2, gen=0)
    ys = sim.propagate(xs, 2, gen=1)
    assert xs.shape == (2, sim.dim) and ys.shape == (2, 2, sim.dim)
    assert bool(torch.isfinite(ys).all())
    assert sim.constraint_set.max_violation(ys) < 1e-5
    assert sim.overflows == 0 and NK.neighbor_sweep.launches == n0


def test_cell_overflow_regrows_the_plan_and_warns():
    """An undersized plan: the check warns, regrows the capacity from the
    offending frame, ignores NaN frames, and propagation goes on."""
    s = itt.MDSimulation(device="cpu", **KW)
    s.nbplan = NB.NeighborPlan(s.system, capacity=8)
    x = s.coords[None].repeat(3, 1)
    with pytest.warns(UserWarning, match="overflow"):
        s._check_cell_overflow(x)
    assert s.nbplan.C > 8 and s.overflows == 1
    assert s.nbplan.cell_div == NB.NeighborPlan(s.system).cell_div
    s._check_cell_overflow(torch.full((2, s.dim), float("nan")))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        ys = s.propagate(x[:1], 1, gen=0, steps=2)
    assert bool(torch.isfinite(ys).all()) and s.overflows == 1


def test_learner_on_solvated_data_matches_jax(jsim, sim):
    """Whole slice on shared data: the port's constrained MD makes the
    bursts (CPU), both packages featurize them with the solute pairs, and
    5 Koopman iterations from the same parameters give the same losses,
    chis and Koopman expectations (1e-5 of the largest)."""
    xs = sim.randx0(4, gen=5)
    # spread the solute over ~0.06 nm so that chi spans a range a trained
    # chi would (the shift-scale target divides by that spread)
    ns = 3 * sim.constraint_set.wstart
    kick = np.random.default_rng(7).normal(size=ns).astype(np.float32)
    xs[:, :ns] += torch.arange(4.0)[:, None] * 0.02 * torch.as_tensor(kick)
    ys = sim.propagate(xs, 2, gen=6)
    jdata = JaxData.from_coords(jsim, xs.numpy(), ys.numpy())
    data = itt.SimulationData.from_coords(sim, xs, ys)
    np.testing.assert_allclose(data.features.numpy(),
                               np.asarray(jdata.features), rtol=1e-6)
    shared = (torch.tensor(np.asarray(jdata.features)),
              torch.tensor(np.asarray(jdata.propfeatures)))
    data = itt.SimulationData.from_coords(sim, xs, ys, features=shared)
    nf = data.featuredim
    jm = jsim.defaultmodel(n=nf, key=jax.random.PRNGKey(0))
    params = jax.tree_util.tree_map(np.asarray, jm.params)
    params["layers"][0]["w"] = params["layers"][0]["w"] * 10.0
    jm.params = jax.tree_util.tree_map(jnp.asarray, params)
    jiso = itk.Iso(data=jdata, model=jm, opt=itk.AdamRegularized(), key=0,
                   shard=False)
    iso = itt.Iso(data=data, model=load_jax_params(
        sim.defaultmodel(n=nf), params), opt=itt.AdamRegularized(), gen=0)
    jiso.run(5)
    iso.run(5)
    np.testing.assert_allclose(iso.losses, jiso.losses, rtol=1e-5, atol=0)
    assert _rel(iso.chis().numpy(), jiso.chis()) < 1e-5
    assert _rel(iso.koopman().numpy(), jiso.koopman()) < 1e-5
