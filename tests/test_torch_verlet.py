"""Port parity of the Verlet-list neighbor mode (``md/verlet.py``): the
plan against the JAX package's, lists complete and directed, forces
against the cell sweep and the JAX package's Verlet forces, overflow
detected, the rebuild-block integrator's diagnostics, and
``MDSimulation(neighbor_mode="verlet")`` (CPU)."""

import collections

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import isokann_tpu as itk
from isokann_tpu.md import verlet as JV

import isokann_tpu_torch as itt
from isokann_tpu_torch.md import neighbor as NB
from isokann_tpu_torch.md import neighbor_kernel as NK
from isokann_tpu_torch.md.verlet import (VerletPlan, build_lists,
                                         force_verlet, langevin_middle_verlet)

# small tensor ops: one intra-op thread each; several test workers
# share the machine and oversubscribed threads slow them 50x
torch.set_num_threads(1)

BOX = dict(addwater=True, padding=0.9, steps=3)


@pytest.fixture(scope="module")
def solvated():
    """The JAX test's box (1,012 atoms) in both packages and its
    perturbed, wrapped frame (float32)."""
    js = itk.MDSimulation(dense_pairs=False, **BOX)
    ts = itt.MDSimulation(device="cpu", dense_pairs=False, **BOX)
    rng = np.random.default_rng(1)
    x = (np.asarray(js.coords).reshape(-1, 3)
         + rng.normal(scale=0.003, size=(ts.natoms, 3)))
    box = np.asarray(ts.system.box)
    return js, ts, (x - box * np.floor(x / box)).astype(np.float32)


@pytest.fixture(scope="module")
def vplan(solvated):
    return VerletPlan(solvated[1].system, x0=solvated[2], skin=0.1)


def test_plan_matches_jax(solvated, vplan):
    js, _, x = solvated
    jp = JV.VerletPlan(js.system, x0=x, skin=0.1)
    assert (vplan.K, vplan.M, vplan.rebuild_every, vplan.rv) == \
        (jp.K, jp.M, jp.rebuild_every, jp.rv)
    np.testing.assert_array_equal(vplan.cand_cells,
                                  np.asarray(jp.cand_cells))


def test_lists_complete_and_directed(solvated, vplan):
    """Every in-cutoff pair that no hard exclusion masks is in both
    owners' rows (sampled atoms, as the JAX test), the overflow is 0, and
    each row holds the JAX package's partners."""
    js, ts, x = solvated
    s = ts.system
    lists, n_over = build_lists(vplan, s, torch.as_tensor(x)[None])
    assert int(n_over[0]) == 0
    n = s.natoms
    L = lists[0].numpy()
    have = [set(row[row < n].tolist()) for row in L]
    hard = collections.defaultdict(set)
    soft = ((s.excl_qq > 0) | (s.excl_lj > 0)).numpy()
    for (a, b), sf in zip(s.excl_idx.numpy(), soft):
        if not sf:
            hard[a].add(int(b))
            hard[b].add(int(a))
    box = np.asarray(s.box)
    rng = np.random.default_rng(2)
    for a in rng.choice(n, 40, replace=False):
        d = x - x[a]
        d -= box * np.round(d / box)
        true = set(np.nonzero((d * d).sum(1) < s.cutoff ** 2)[0].tolist())
        true -= {int(a)} | hard[int(a)]
        assert not true - have[a], a
        for b in list(true)[:5]:
            assert int(a) in have[b]
    jl, jo = JV.build_lists(JV.VerletPlan(js.system, x0=x, skin=0.1),
                            js.system, jnp.asarray(x))
    assert int(jo) == 0
    jl = np.asarray(jl)
    for a in rng.choice(n, 40, replace=False):
        assert have[a] == set(jl[a][jl[a] < n].tolist()), a


def test_force_matches_cell_sweep_and_jax(solvated, vplan):
    """Forces from the lists within 1e-5 of max|f| of the cell route
    (kernel E's plain version in the wrapper, the JAX test's bound) and of
    the JAX package's Verlet forces."""
    js, ts, x = solvated
    s = ts.system
    xt = torch.as_tensor(x)[None]
    lists, _ = build_lists(vplan, s, xt)
    f_new = force_verlet(s, xt, lists)[0].numpy()
    plan = NB.NeighborPlan(s, x0=x)
    f_ref = NB.force_flat_neighbor(s, xt.reshape(1, -1),
                                   plan)[0].numpy().reshape(-1, 3)
    scale = np.abs(f_ref).max()
    assert np.abs(f_ref - f_new).max() / scale < 1e-5
    jl, _ = JV.build_lists(JV.VerletPlan(js.system, x0=x, skin=0.1),
                           js.system, jnp.asarray(x))
    f_j = np.asarray(JV.force_verlet(js.system, jnp.asarray(x), jl))
    assert np.abs(f_j - f_new).max() / scale < 1e-5


def test_overflow_detected(solvated):
    _, ts, x = solvated
    vp = VerletPlan(ts.system, x0=x, skin=0.1, K=8)
    assert vp.K == 128                          # lane rounding
    vp.K = 8
    _, n_over = build_lists(vp, ts.system, torch.as_tensor(x)[None])
    assert int(n_over[0]) > 0


def test_langevin_middle_verlet_runs(solvated, vplan):
    """7 rigid-water steps of 2 walkers with rebuilds every 3: finite, no
    overflow, the largest displacement from a build inside skin/2;
    noiseless, the same steps as the cell route within 1e-5 of the
    coordinates."""
    _, ts, x = solvated
    s = ts.system
    x0 = torch.as_tensor(x.reshape(1, -1)).repeat(2, 1)
    v0 = torch.zeros_like(x0)
    cs = ts.constraint_set
    x0 = cs.shake(x0, x0)
    xv, _, diag = langevin_middle_verlet(
        s, vplan, x0, v0, ts.masses3, ts.temp, ts.friction, ts.step, 7,
        itt.make_generator(0), rebuild_every=3, constraints=cs)
    assert xv.shape == x0.shape and bool(torch.isfinite(xv).all())
    assert int(diag["n_over"]) == 0
    assert float(diag["max_disp"]) < vplan.skin / 2
    xn, _, _ = langevin_middle_verlet(s, vplan, x0[:1], v0[:1], ts.masses3,
                                      ts.temp, ts.friction, ts.step, 4,
                                      None, rebuild_every=2, constraints=cs)
    xc, _ = itt.md.integrators.langevin_middle(
        lambda z: NB.force_flat_neighbor(s, z, ts.nbplan), x0[:1], v0[:1],
        ts.masses3, ts.temp, ts.friction, ts.step, 4, None, cs)
    assert float((xn - xc).abs().max() / xc.abs().max()) < 1e-5


def test_verlet_rebuilds_when_an_atom_moves_half_the_skin(solvated):
    """A 0.01 nm skin and an interval longer than the run: thermal
    velocities carry an atom 0.005 nm within the first steps, so the lists
    are rebuilt before that force evaluation, every evaluation's
    displacement stays inside skin/2, and 4 noiseless rigid-water steps
    equal the cell route's within 1e-5 of the coordinates."""
    _, ts, x = solvated
    s = ts.system
    vp = VerletPlan(s, x0=x, skin=0.01)
    cs = ts.constraint_set
    x0 = torch.as_tensor(x.reshape(1, -1))
    x0 = cs.shake(x0, x0)
    v0 = ts.random_velocities(itt.make_generator(5), x0.shape)
    xv, _, diag = langevin_middle_verlet(
        s, vp, x0, v0, ts.masses3, ts.temp, ts.friction, ts.step, 4, None,
        rebuild_every=100, constraints=cs)
    assert diag["rebuilds"] > 1 and int(diag["n_over"]) == 0
    assert float(diag["max_disp"]) < vp.skin / 2
    xc, _ = itt.md.integrators.langevin_middle(
        lambda z: NB.force_flat_neighbor(s, z, ts.nbplan), x0, v0,
        ts.masses3, ts.temp, ts.friction, ts.step, 4, None, cs)
    assert float((xv - xc).abs().max() / xc.abs().max()) < 1e-5


def test_mdsimulation_verlet_mode(solvated):
    """neighbor_mode="verlet" propagates on the lists, rigid waters held,
    with the same mean displacement as the cell mode within 30% (the JAX
    test's check), its diagnostics recorded; the constructor keeps the
    mode; an unknown mode raises."""
    _, ts, _ = solvated
    sim = itt.MDSimulation(device="cpu", dense_pairs=False,
                           neighbor_mode="verlet", skin=0.1,
                           **dict(BOX, steps=6))
    x0 = sim.coords[None].repeat(3, 1)
    n0 = NK.neighbor_sweep.launches
    ys = sim.propagate(x0, 2, gen=0)
    assert ys.shape == (3, 2, sim.dim) and bool(torch.isfinite(ys).all())
    assert sim.verlet_diag["n_over"] == 0
    assert sim.verlet_diag["max_disp"] < sim.vplan.skin / 2
    assert sim.constraint_set.max_violation(ys) < 1e-4
    assert NK.neighbor_sweep.launches == n0
    simc = itt.MDSimulation(device="cpu", dense_pairs=False,
                            **dict(BOX, steps=6))
    yc = simc.propagate(x0, 2, gen=0)
    dv = float((ys - x0[:, None]).abs().mean())
    dc = float((yc - x0[:, None]).abs().mean())
    assert abs(dv - dc) / dc < 0.3
    assert sim.constructor["neighbor_mode"] == "verlet"
    assert sim.constructor["skin"] == 0.1
    with pytest.raises(ValueError):
        itt.MDSimulation(device="cpu", neighbor_mode="wat")
