"""Port parity of the runtime box and the Monte Carlo barostat
(``md/barostat.py``, ``box=`` of ``md/forces.py`` and ``md/neighbor.py``):
molecule maps, energies at the static box passed as a runtime box and at
scaled boxes (dense and neighbor routes) against the JAX package and
rebuilt systems, kernel E's plain version at a scaled box against the
tensor sweep, one volume move against JAX's with the same two draws, and
NPT propagation on both routes (CPU)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import isokann_tpu as itk
from isokann_tpu.md import barostat as JB
from isokann_tpu.md import forces as JF
from isokann_tpu.md import neighbor as JN

import isokann_tpu_torch as itt
from isokann_tpu_torch.md import barostat as B
from isokann_tpu_torch.md import forces as F
from isokann_tpu_torch.md import neighbor as NB
from isokann_tpu_torch.md import neighbor_kernel as NK
from isokann_tpu_torch.md.system import build_system

# small tensor ops: one intra-op thread each; several test workers
# share the machine and oversubscribed threads slow them 50x
torch.set_num_threads(1)

# the JAX test's flexible water box (no constraints inside the NPT loop)
WATER = dict(addwater=True, padding=0.62, steps=5, rigidwater=False,
             step=0.001)
SPARSE = dict(addwater=True, padding=0.9, steps=3)


@pytest.fixture(scope="module")
def water():
    return itk.MDSimulation(**WATER), itt.MDSimulation(device="cpu", **WATER)


@pytest.fixture(scope="module")
def sparse():
    """The JAX test's sparse box (padding 0.9, 1,012 atoms), its bonds
    kept, in both packages, with its coordinates."""
    js = itk.MDSimulation(**SPARSE)
    ts = itt.MDSimulation(device="cpu", **SPARSE)
    from isokann_tpu.md.system import build_system as jax_build
    x = np.asarray(js.coords).reshape(-1, 3).astype(np.float32)
    return (jax_build(js.structure, dense_pairs=False),
            build_system(ts.structure, dense_pairs=False, device="cpu"),
            build_system(ts.structure, device="cpu"), x)


def test_molecule_map_matches_jax(water, sparse):
    js, ts = water
    mol = B.molecule_map(ts.system)
    np.testing.assert_array_equal(mol, JB.molecule_map(js.system))
    sizes = np.bincount(mol)
    assert (sizes == 3).sum() > 50 and sizes.max() == 22
    # rigid waters on the sparse path: their bonds stripped, the water
    # triplets passed as extra pairs
    from isokann_tpu_torch.md.solvate import water_triplets
    rs = itt.MDSimulation(device="cpu", dense_pairs=False, **SPARSE)
    trip = water_triplets(rs.structure)
    extra = np.concatenate([trip[:, [0, 1]], trip[:, [0, 2]]])
    np.testing.assert_array_equal(B.molecule_map(rs.system, extra),
                                  B.molecule_map(sparse[1]))


def test_dense_runtime_box_energies(water):
    """The static box passed at run time gives the static energy (1e-3 +
    1e-6|E|); a 3% larger box equals the system rebuilt with that box
    (1e-2 + 1e-5|E|, the JAX test's bounds) and the JAX package's energy
    at the same runtime box (1e-5 relative)."""
    js, ts = water
    s = ts.system
    x = ts.coords.reshape(1, -1, 3)
    e0 = float(F.potential_energy(s, x)[0])
    e1 = float(F.potential_energy(s, x, box=torch.tensor(s.box))[0])
    assert abs(e0 - e1) < 1e-3 + 1e-6 * abs(e0)
    box2 = tuple(b * 1.03 for b in s.box)
    e_tr = float(F.potential_energy(s, x, box=box2)[0])
    e_st = float(F.potential_energy(dataclasses.replace(s, box=box2), x)[0])
    assert abs(e_tr - e_st) < 1e-2 + 1e-5 * abs(e_st)
    e_j = float(JF.nonbonded_energy(js.system, jnp.asarray(x[0].numpy()),
                                    box=jnp.asarray(box2, jnp.float32)))
    e_t = float(F.nonbonded_energy(s, x, box=box2)[0])
    assert abs(e_t - e_j) < 1e-5 * abs(e_j)


@pytest.mark.parametrize("f", [0.95, 1.04])
def test_neighbor_runtime_box_matches_jax_and_rebuilt(sparse, f):
    """The neighbor route at a scaled box, on a plan with box_slack 0.12
    (the JAX test's): the nonbonded energy within 1e-5 of its summands'
    size (the energy with every charge made positive) of the JAX neighbor
    engine's, the total within 2e-3|E| + 1 of the dense system rebuilt at
    that box; analytic forces within 5e-4 max|f| + 0.5 of autograd of the
    energy; the batched wrapper (kernel E's plain version, layout at that box)
    equals the tensor sweep's forces within 1e-5 of the largest."""
    js, ts, td, x = sparse
    xt = torch.as_tensor(x)
    plan = NB.NeighborPlan(ts, x0=x, box_slack=0.12)
    jplan = JN.NeighborPlan(js, x0=x, box_slack=0.12)
    assert plan.S == jplan.S and plan.C == jplan.C
    np.testing.assert_array_equal(plan.stencil, np.asarray(jplan.stencil))
    box2 = tuple(b * f for b in ts.box)
    e_nb = float(NB.neighbor_nonbonded_energy(ts, xt, plan, box=box2))
    e_j = float(JN.neighbor_nonbonded_energy(
        js, jnp.asarray(x), jplan, box=jnp.asarray(box2, jnp.float32)))
    size = abs(float(NB.neighbor_nonbonded_energy(
        ts.replace(charges=ts.charges.abs()), xt, plan, box=box2)))
    assert abs(e_nb - e_j) < 1e-5 * size
    e_tr = float(NB.potential_energy_neighbor(ts, xt, plan, box=box2))
    e_ref = float(F.potential_energy(dataclasses.replace(td, box=box2),
                                     xt[None])[0])
    assert abs(e_tr - e_ref) < 2e-3 * abs(e_ref) + 1.0
    f_a = NB.force_neighbor(ts, xt, plan, box=box2)
    xg = xt.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(NB.potential_energy_neighbor(
        ts, xg, plan, box=box2), xg)
    scale = float(g.abs().max())
    assert float((f_a + g).abs().max()) < 5e-4 * scale + 0.5
    f_w = NB.force_flat_neighbor(ts, xt.reshape(1, -1), plan, box=box2)
    assert float((f_w.reshape(-1, 3) - f_a).abs().max()) < 1e-5 * scale
    # the layout at that box keeps every atom
    _, boxes = NK.neighbor_layout(ts, plan, xt.reshape(1, -1), box2)
    assert int(boxes[..., 3].sum()) == ts.natoms


def test_static_box_at_run_time_equals_static(sparse):
    js, ts, _, x = sparse
    xt = torch.as_tensor(x)
    plan = NB.NeighborPlan(ts, x0=x, box_slack=0.1)
    e0 = float(NB.potential_energy_neighbor(ts, xt, plan))
    e1 = float(NB.potential_energy_neighbor(ts, xt, plan,
                                            box=torch.tensor(ts.box)))
    assert abs(e0 - e1) < 1e-3 + 1e-6 * abs(e0)
    f0 = NB.force_flat_neighbor(ts, xt.reshape(1, -1), plan)
    f1 = NB.force_flat_neighbor(ts, xt.reshape(1, -1), plan, box=ts.box)
    assert torch.equal(f0, f1)


@pytest.mark.parametrize("seed", [0, 2, 3])
def test_move_matches_jax_with_the_same_draws(water, monkeypatch, seed):
    """One volume move of the dense water box: with JAX's two uniforms
    fed through the seam, the same decision, coordinates and box within
    1e-5 (relative to the largest), the same counts and step scale; the
    intramolecular geometry kept (1e-6 nm)."""
    js, ts = water
    s = ts.system
    x = ts.coords.reshape(-1, 3)
    jb = JB.MonteCarloBarostat(js.system, pressure=1.0, temp=300.0)
    tb = B.MonteCarloBarostat(s, pressure=1.0, temp=300.0)
    key = jax.random.PRNGKey(seed)
    k1, k2 = jax.random.split(key)
    u = (float(jax.random.uniform(k1, (), minval=-1.0, maxval=1.0)),
         float(jax.random.uniform(k2, ())))
    monkeypatch.setattr(B, "_uniforms", lambda gen: u)
    xj, stj = jb.move(key, jnp.asarray(x.numpy()), jb.init_state())
    xt, stt = tb.move(None, x, tb.init_state())
    assert stt[2] == int(stj[2]) == 1 and stt[3] == int(stj[3])
    assert abs(float(stt[1]) - float(stj[1])) <= 1e-6 * float(stj[1])
    np.testing.assert_allclose(stt[0].numpy(), np.asarray(stj[0]),
                               rtol=1e-5)
    xj = np.asarray(xj)
    assert np.abs(xt.numpy() - xj).max() < 1e-5 * np.abs(xj).max()
    mol = B.molecule_map(s)
    w0 = np.where(mol == mol[-1])[0]
    np.testing.assert_allclose(xt[w0[0]] - xt[w0[1]], x[w0[0]] - x[w0[1]],
                               atol=1e-6)


def test_npt_dense_dynamics_bounded(water):
    """NPT on the dense flexible water box (1 fs): moves fire, dynamics
    stay finite, the volume stays physical (the JAX test's bounds)."""
    _, ts = water
    xf, box_f, info = B.npt_langevin(ts, gen=2, steps=200, interval=20,
                                     pressure=1.0)
    assert bool(torch.isfinite(xf).all())
    assert info["attempted"] == 10 and 0 < info["accepted"] <= 10
    assert 0.6 < float(torch.prod(box_f)) / float(np.prod(ts.system.box)) \
        < 1.7


def test_npt_on_the_neighbor_route(sparse):
    """NPT through the neighbor route (kernel E's plain version at the
    box of each block): 10 moves attempted, finite, the volume within
    0.5-2x (the JAX test's bounds)."""
    _, ts, _, _ = sparse
    sim = itt.MDSimulation(device="cpu", **SPARSE)
    sim.system = ts
    sim.masses3 = torch.repeat_interleave(ts.masses, 3)
    n0 = NK.neighbor_sweep.launches
    xf, box_f, info = B.npt_langevin(sim, gen=3, steps=40, interval=4)
    assert NK.neighbor_sweep.launches == n0       # no launch on the CPU
    assert bool(torch.isfinite(xf).all()) and info["attempted"] == 10
    assert info["overflow"] == 0
    V0 = float(np.prod(ts.box))
    assert 0.5 < float(torch.prod(box_f)) / V0 < 2.0


def test_plan_rebuilt_below_its_slack_and_overflow_counted(sparse,
                                                           monkeypatch):
    """A move to a box 10% shorter on each edge, past the plan's 2%
    slack, rebuilds the plan at that box before its energies (the plan's
    box is the proposal's, and the neighbor energy there within 2e-3|E| +
    1 of the dense system rebuilt at that box); a move that stays inside
    the slack keeps the plan.  The
    barostat's overflow count at a run-time box: 0 on the box's frame,
    every atom past a cell's capacity when all sit in one cell."""
    _, ts, td, x = sparse
    xt = torch.as_tensor(x)
    V0 = float(np.prod(ts.box))
    tb = B.MonteCarloBarostat(ts, x0=xt, box_slack=0.02,
                              initial_scale=0.271 * V0)
    monkeypatch.setattr(B, "_uniforms", lambda gen: (-1.0, 0.0))
    xn, st = tb.move(None, xt, tb.init_state())
    boxn = st[0]
    assert st[3] == 1 and tb.replans == 1
    np.testing.assert_allclose(tb.plan.box, boxn.numpy(), rtol=1e-6)
    np.testing.assert_allclose(boxn.numpy(), np.asarray(ts.box) * 0.9,
                               rtol=1e-4)
    e_nb = float(tb.energy(xn, boxn))
    e_ref = float(F.potential_energy(
        dataclasses.replace(td, box=tuple(boxn.tolist())), xn[None])[0])
    assert abs(e_nb - e_ref) < 2e-3 * abs(e_ref) + 1.0
    tb2 = B.MonteCarloBarostat(ts, x0=xt, box_slack=0.02,
                               initial_scale=0.01 * V0)
    tb2.move(None, xt, tb2.init_state())
    assert tb2.replans == 0
    assert tb.overflow(xn, boxn) == 0
    assert tb.overflow(torch.zeros_like(xn), boxn) == ts.natoms - tb.plan.C
