"""Port parity of the cell-list engine: the ``NeighborPlan`` tables, the
cell table, the plain sweep of kernel E against the TPU kernel
``neighbor_sweep_pallas`` in interpret mode (Newton and non-Newton plans,
reaction field and erfc), the tensor sweep, the exception corrections,
the sparse bonded forces and ``force_flat_neighbor``, against the JAX
package on the same numpy inputs (CPU)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import isokann_tpu as itk
from isokann_tpu.md import neighbor as JN
from isokann_tpu.md.ewald import ewald_alpha as jax_ewald_alpha

import isokann_tpu_torch as itt
from isokann_tpu_torch.md import forces as F
from isokann_tpu_torch.md import neighbor as NB
from isokann_tpu_torch.md import neighbor_kernel as NK

# small tensor ops: one intra-op thread each; several test workers
# share the machine and oversubscribed threads slow them 50x
torch.set_num_threads(1)

PAD = 0.9      # 1012 atoms, box ~2.3 nm: the auto plan is (2, 2, 1)


@pytest.fixture(scope="module")
def sims():
    """Solvated alanine on the sparse layout: (JAX sim, port sim)."""
    kw = dict(addwater=True, padding=PAD, steps=3, dense_pairs=False)
    return itk.MDSimulation(**kw), itt.MDSimulation(device="cpu", **kw)


@pytest.fixture(scope="module")
def xb(sims):
    """Two walkers near the start, float32 (2, 3N)."""
    x0 = np.asarray(sims[0].coords)
    rng = np.random.default_rng(0)
    return (x0[None] + rng.normal(scale=0.003, size=(2, x0.size))
            ).astype(np.float32)


def _plans(sims, **kw):
    js, ts = sims
    x0 = np.asarray(js.coords).reshape(-1, 3)
    return (JN.NeighborPlan(js.system, x0=x0, **kw),
            NB.NeighborPlan(ts.system, x0=x0, **kw))


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.mark.parametrize("kw", [{}, dict(cells=(3, 3, 3)),
                                dict(cell_div=2), dict(capacity=300),
                                dict(cells=(1, 1, 1))])
def test_plan_tables_match_jax(sims, kw):
    """Grid, stencil, inverse permutations, capacity, exclusion bitmask and
    far table equal the JAX package's, field by field."""
    jp, tp = _plans(sims, **kw)
    np.testing.assert_array_equal(tp.nc, jp.nc)
    np.testing.assert_array_equal(tp.cell, jp.cell)
    assert (tp.C, tp.S, tp.newton, tp.ncells, tp.n_soft) == \
        (jp.C, jp.S, jp.newton, jp.ncells, jp.n_soft)
    assert tuple(np.atleast_1d(tp.cell_div)) == \
        tuple(np.atleast_1d(jp.cell_div))
    np.testing.assert_array_equal(tp.stencil, np.asarray(jp.stencil))
    np.testing.assert_array_equal(tp.stencil_inv,
                                  np.asarray(jp.stencil_inv))
    np.testing.assert_array_equal(tp.excl_bits, np.asarray(jp.excl_bits))
    np.testing.assert_array_equal(tp.excl_far, np.asarray(jp.excl_far))


def test_full_stencil_visits_each_neighbour_cell_once(sims):
    """The kernel's stencil: the self cell first, then each distinct cell
    once; on a Newton plan it is the half stencil and its reverse."""
    for kw in ({}, dict(cells=(3, 3, 3)), dict(cells=(5, 1, 2))):
        _, tp = _plans(sims, **kw)
        assert np.array_equal(tp.full[:, 0], np.arange(tp.ncells))
        for row in tp.full:
            assert len(set(row.tolist())) == len(row)
        if tp.newton:
            want = np.sort(np.concatenate(
                [np.arange(tp.ncells)[:, None], tp.stencil,
                 tp.stencil_inv], axis=1), axis=1)
            np.testing.assert_array_equal(np.sort(tp.full, axis=1), want)


def test_cell_table_matches_jax(sims, xb):
    jp, tp = _plans(sims)
    box = np.asarray(jp.box, np.float32)
    x = xb[0].reshape(-1, 3)
    xw = x - box * np.floor(x / box)
    jt, jd = jp.table(jnp.asarray(xw))
    tt, td = tp.table(torch.as_tensor(xw))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    assert int(td) == int(jd) == 0
    real = np.sort(tt.numpy().ravel())
    np.testing.assert_array_equal(real[real < tp.natoms],
                                  np.arange(tp.natoms))


@pytest.mark.parametrize("kw,ewald", [({}, False), ({}, True),
                                      (dict(cells=(3, 3, 3)), False),
                                      (dict(cells=(3, 3, 3)), True)])
def test_plain_sweep_matches_tpu_kernel(sims, xb, kw, ewald):
    """The plain version of kernel E against ``neighbor_sweep_pallas`` in
    interpret mode, on the auto (non-Newton, aliased z axis) plan and a
    27-cell Newton plan, reaction field and erfc: 1e-5 of max |F|."""
    js, ts = sims
    jp, tp = _plans(sims, **kw)
    assert jp.newton == bool(kw)
    jsys, alpha = js.system, None
    if ewald:
        alpha = NB.ewald_alpha(ts.system.cutoff, 5e-4)
        assert alpha == jax_ewald_alpha(js.system.cutoff, 5e-4)
        jsys = dataclasses.replace(jsys, method="PME", ewald_alpha=alpha)
    ref = np.asarray(JN.neighbor_sweep_pallas(jsys, jp, jnp.asarray(xb[:1]),
                                              interpret=True))
    out = NK.neighbor_sweep(ts.system, tp, torch.as_tensor(xb[:1]), alpha)
    assert _rel(out.numpy(), ref) < 1e-5


def test_sweep_and_force_flat_neighbor_match_jax(sims, xb):
    """The tensor sweep (energy and force), the exception corrections, the
    sparse bonded forces and the whole ``force_flat_neighbor`` (through
    the kernel wrapper's plain version) against the JAX package: 1e-5."""
    js, ts = sims
    jp, tp = _plans(sims)
    x = xb[0].reshape(-1, 3)
    jx, tx = jnp.asarray(x), torch.as_tensor(x)
    assert _rel(NB._sweep(ts.system, tp, tx, True).numpy(),
                JN._sweep(js.system, jp, jx, True)) < 1e-5
    e, je = float(NB._sweep(ts.system, tp, tx, False)), \
        float(JN._sweep(js.system, jp, jx, False))
    assert abs(e - je) / abs(je) < 1e-5
    assert _rel(NB._exception_terms(ts.system, tx[None], True)[0].numpy(),
                JN._exception_terms(js.system, jx, True)) < 1e-5
    e = float(NB._exception_terms(ts.system, tx[None], False)[0])
    je = float(JN._exception_terms(js.system, jx, False))
    assert abs(e - je) <= 1e-5 * abs(je)
    assert _rel(NB.bonded_force_sparse(ts.system, tx[None])[0].numpy(),
                JN.bonded_force_sparse(js.system, jx)) < 1e-5
    # the JAX package's force_flat_neighbor off the TPU is its
    # force_neighbor walker by walker
    out = NB.force_flat_neighbor(ts.system, torch.as_tensor(xb), tp)
    ref = np.stack([JN.force_neighbor(js.system, jnp.asarray(
        xi.reshape(-1, 3)), jp).reshape(-1) for xi in xb])
    assert _rel(out.numpy(), ref) < 1e-5
    assert _rel(NB.force_neighbor(ts.system, tx, tp).numpy(),
                ref[0].reshape(-1, 3)) < 1e-5
    e = float(NB.potential_energy_neighbor(ts.system, tx, tp))
    je = float(JN.potential_energy_neighbor(js.system, jx, jp))
    assert abs(e - je) / abs(je) < 1e-5


def test_forces_module_routes_sparse_systems(sims, xb):
    """``forces.force_flat`` and ``forces.potential_energy_flat`` send a
    ``dense_pairs=False`` system through the neighbor engine."""
    _, ts = sims
    x = torch.as_tensor(xb)
    np.testing.assert_array_equal(
        F.force_flat(ts.system, x).numpy(),
        NB.force_flat_neighbor(ts.system, x).numpy())
    e = F.potential_energy_flat(ts.system, x)
    assert e.shape == (2,)
    assert torch.allclose(e[0], NB.potential_energy_neighbor(
        ts.system, x[0].reshape(-1, 3)), rtol=1e-6)


def _with_exclusions(sys, pairs):
    """``sys`` with extra hard exclusions (i, j)."""
    idx = torch.cat([sys.excl_idx, torch.as_tensor(pairs)])
    zero = torch.zeros(len(pairs))
    return dataclasses.replace(sys, excl_idx=idx,
                               excl_qq=torch.cat([sys.excl_qq, zero]),
                               excl_lj=torch.cat([sys.excl_lj, zero]))


def test_far_partners_and_window_bit_31(sims, xb):
    """A hard exclusion 32 indices apart sets bit 31 (the int32 sign bit)
    and one beyond the window goes to the far table; the plain sweep
    masks both as the JAX tensor sweep does."""
    js, ts = sims
    n = ts.system.natoms
    x0 = np.asarray(js.coords).reshape(-1, 3)
    box = np.asarray(js.system.box)

    def near(a, b):
        d = x0[a] - x0[b]
        return np.sum((d - box * np.round(d / box)) ** 2, -1) < 0.6 ** 2

    # two water pairs within the cutoff: 32 indices apart, and 150 apart
    i = 30 + int(np.argmax(near(np.arange(30, n - 32),
                                np.arange(62, n))))
    j = 31 + int(np.argmax(near(np.arange(31, n - 150),
                                np.arange(181, n))))
    pairs = [[i, i + 32], [j, j + 150]]
    tsys = _with_exclusions(ts.system, pairs)
    jsys = dataclasses.replace(
        js.system, excl_idx=jnp.asarray(tsys.excl_idx.numpy(), jnp.int32),
        excl_qq=jnp.asarray(tsys.excl_qq.numpy()),
        excl_lj=jnp.asarray(tsys.excl_lj.numpy()))
    jp = JN.NeighborPlan(jsys, x0=x0)
    tp = NB.NeighborPlan(tsys, x0=x0)
    assert tp.excl_bits[i] < 0 and (tp.excl_far >= 0).sum() == 2
    np.testing.assert_array_equal(tp.excl_bits, np.asarray(jp.excl_bits))
    np.testing.assert_array_equal(tp.excl_far, np.asarray(jp.excl_far))
    x = xb[:1]
    ref = JN._sweep(jsys, jp, jnp.asarray(x[0].reshape(-1, 3)), True)
    out = NK.neighbor_sweep(tsys, tp, torch.as_tensor(x))
    assert _rel(out.numpy().reshape(-1, 3), ref) < 1e-5
    base = NK.neighbor_sweep(ts.system, NB.NeighborPlan(ts.system, x0=x0),
                             torch.as_tensor(x))
    assert _rel(base.numpy(), out.numpy()) > 1e-6   # the masks act


def test_overflow_and_dropped_atoms(sims, xb):
    """An undersized capacity overflows as in the JAX package; dropped
    atoms get no sweep force."""
    js, ts = sims
    jp = JN.NeighborPlan(js.system, capacity=8)
    tp = NB.NeighborPlan(ts.system, capacity=8)
    assert tp.overflow(xb) == jp.overflow(xb) > 0
    f = NK.neighbor_sweep(ts.system, tp, torch.as_tensor(xb[:1]))
    assert int((f.reshape(-1, 3).abs().sum(-1) == 0).sum()) > 0


def test_strip_rigid_water_bonded_matches_jax(sims):
    js, ts = sims
    for f in ("bond_idx", "bond_k", "bond_r0", "angle_idx", "angle_k",
              "angle_t0", "dih_idx"):
        np.testing.assert_array_equal(getattr(ts.system, f).numpy(),
                                      np.asarray(getattr(js.system, f)),
                                      err_msg=f)
    assert ts.system.bond_idx.shape[0] < ts.structure.natoms


def test_wrapper_on_other_devices_and_shapes(sims, xb):
    """A CPU tensor takes the plain version without a launch; a tensor on
    a device without the kernel raises; a wrong shape raises."""
    _, ts = sims
    n0 = NK.neighbor_sweep.launches
    NK.neighbor_sweep(ts.system, ts.nbplan, torch.as_tensor(xb))
    assert NK.neighbor_sweep.launches == n0
    with pytest.raises(NotImplementedError, match="meta"):
        NK.neighbor_sweep(ts.system, ts.nbplan,
                          torch.as_tensor(xb).to("meta"))
    with pytest.raises(ValueError):
        NK.neighbor_sweep(ts.system, ts.nbplan, torch.as_tensor(xb[:, :9]))


def test_operation_counts(sims, xb):
    """The bound's operations: 63 an unordered pair in cutoff with the
    reaction field; the kernel visits every slot pair of the full stencil
    and computes each pair in range from both sides."""
    _, ts = sims
    plan = ts.nbplan
    in_range, visited = NK.pair_counts(ts.system, plan,
                                       torch.as_tensor(xb[:1]))
    assert 0 < 2 * in_range < visited
    live = ts.system.natoms
    assert visited == live * plan.full.shape[1] * plan.C
    assert NK.step_ops(in_range) == 63 * in_range
    assert NK.kernel_ops(in_range, visited) > NK.step_ops(in_range)
    ms, by = NK.bound_ms(plan, 64, 64 * in_range)
    assert by == "operations" and ms > 0
