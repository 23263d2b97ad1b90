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
from isokann_tpu_torch.md import langevin_kernel as LK
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
    reaction field; the kernel tests the records its culling keeps (more
    than the pairs in range, fewer than every slot of the full stencil)
    and computes each pair in range from both sides."""
    _, ts = sims
    plan = ts.nbplan
    in_range, visited, culls = NK.pair_counts(ts.system, plan,
                                              torch.as_tensor(xb[:1]))
    live = ts.system.natoms
    assert 0 < 2 * in_range < visited < live * plan.full.shape[1] * plan.C
    assert culls > 0
    assert NK.step_ops(in_range) == 63 * in_range
    assert NK.kernel_ops(in_range, visited, culls) > NK.step_ops(in_range)
    ms, by = NK.bound_ms(plan, 64, 64 * in_range)
    assert by == "operations" and ms > 0


def _kernel_layout(sims, kw):
    _, ts = sims
    _, tp = _plans(sims, **kw)
    return ts.system, tp


@pytest.mark.parametrize("kw", [{}, dict(cells=(3, 3, 3)),
                                dict(capacity=8)])
def test_kernel_records_reorder_the_plans_slots(sims, xb, kw):
    """The kernel's layout holds, in each cell, exactly the atoms the plan
    keeps (a full cell drops the same atoms), ordered by serpentine
    sub-cell rank, empty slots last and padded to whole tiles; each tile's
    box bounds its live atoms and counts them."""
    sys, tp = _kernel_layout(sims, kw)
    x = torch.as_tensor(xb)
    plain, _ = NK.slot_records(sys, tp, x)
    rec, boxes = NK.kernel_records(sys, tp, x)
    T = NK.tiles(tp)
    assert rec.shape == (2, tp.ncells, T * NK.TILE, 8) and T * NK.TILE >= tp.C
    assert boxes.shape == (2, tp.ncells, T, 8)
    ids_p = plain.view(torch.int32)[..., 6]
    ids_k = rec.view(torch.int32)[..., 6]
    for b in range(2):
        for c in range(tp.ncells):
            kept = ids_p[b, c][ids_p[b, c] >= 0]
            row = ids_k[b, c]
            nl = int((row >= 0).sum())
            assert bool((row[:nl] >= 0).all()) and bool((row[nl:] < 0).all())
            assert torch.equal(torch.sort(row[:nl])[0], torch.sort(kept)[0])
    st = NK._sub_table(tp, sys.cutoff, "cpu")
    sub = torch.floor(rec[..., 0:3] * st["scale"]
                      - st["corner"][:, None, :]).long()
    sub = torch.clamp(sub, min=torch.zeros_like(st["top"]), max=st["top"])
    rank = torch.where(ids_k >= 0, st["rank"][(sub * st["stride"]).sum(-1)],
                       10 ** 9)
    assert bool((rank[..., 1:] >= rank[..., :-1]).all())
    assert sorted(st["rank"].tolist()) == list(range(len(st["rank"])))
    xyz = rec[..., 0:3].reshape(2, tp.ncells, T, NK.TILE, 3)
    live = (ids_k >= 0).reshape(2, tp.ncells, T, NK.TILE)
    np.testing.assert_array_equal(boxes[..., 3].numpy(),
                                  live.sum(-1).numpy())
    lo, hi = boxes[..., None, 0:3], boxes[..., None, 4:7]
    inside = (xyz >= lo).all(-1) & (xyz <= hi).all(-1)
    assert bool(inside[live].all())
    if kw.get("capacity") == 8:
        assert tp.overflow(xb) > 0


@pytest.mark.parametrize("kw,ewald", [({}, False), ({}, True),
                                      (dict(cells=(3, 3, 3)), False),
                                      (dict(cells=(3, 3, 3)), True)])
def test_culled_tiles_cover_every_pair(sims, xb, kw, ewald):
    """Every pair within the cutoff that the function computes lies in an
    (i tile, j tile) pair that survives the kernel's box test, and its j
    record passes the record test: the forces summed over the surviving
    records alone, in the kernel's layout, equal the plain sweep (1e-6 of
    max |F|), with the reaction field and with erfc."""
    sys, tp = _kernel_layout(sims, kw)
    alpha = NB.ewald_alpha(sys.cutoff, 5e-4) if ewald else None
    x = torch.as_tensor(xb[:1])
    rec, boxes = NK.kernel_records(sys, tp, x)
    rec, boxes = rec[0], boxes[0]
    Cp = rec.shape[1]
    keep = {s: k for s, _, k in NK.surviving_tiles(sys, tp, rec, boxes)}
    full = torch.as_tensor(tp.full, dtype=torch.long)
    acc = torch.zeros(tp.ncells * Cp, 3, dtype=torch.float64)
    n_pairs = 0
    for islot, d, r2, qiqj, rmin, epsij, _, jslot in NK._pairs(sys, tp,
                                                               rec):
        c, a, cj, bj = islot // Cp, islot % Cp, jslot // Cp, jslot % Cp
        col = (full[c] == cj[:, None]).long().argmax(1)
        ok = torch.zeros_like(c, dtype=torch.bool)
        for s in col.unique().tolist():
            m = col == s
            ok[m] = keep[s][c[m], a[m] // NK.TILE, bj[m] // NK.TILE,
                            bj[m] % NK.TILE]
        assert bool(ok.all())
        n_pairs += int(ok.sum())
        f = NK.pair_force(sys, d[ok], r2[ok], qiqj[ok], rmin[ok], epsij[ok],
                          alpha)
        acc.index_add_(0, islot[ok], f.double())
    assert n_pairs > 0
    oid = rec.view(torch.int32)[..., 6].reshape(-1).long()
    out = torch.zeros(tp.natoms + 1, 3, dtype=torch.float64)
    out[torch.where(oid >= 0, oid, tp.natoms)] = acc
    ref = NK.neighbor_sweep_plain(sys, tp, x, alpha)[0].reshape(-1, 3)
    assert _rel(out[:-1].float().numpy(), ref.numpy()) < 1e-6


def test_visited_matches_brute_force(sims, xb):
    """``pair_counts``' slot tests equal a count tile pair by tile pair:
    boxes from the live records, the box test and the record test as the
    kernel makes them, a live i slot against each record kept."""
    sys, tp = _kernel_layout(sims, {})
    x = torch.as_tensor(xb[:1])
    _, visited, culls = NK.pair_counts(sys, tp, x)
    rec, _ = NK.kernel_records(sys, tp, x)
    rec = rec[0]
    T = NK.tiles(tp)
    xyz = rec[..., 0:3].reshape(tp.ncells, T, NK.TILE, 3)
    live = (rec.view(torch.int32)[..., 6] >= 0).reshape(tp.ncells, T,
                                                         NK.TILE)
    box = torch.as_tensor(tp.box, dtype=torch.float32)
    rc2 = sys.cutoff * sys.cutoff

    def gap2(d, h):
        d = d - box * torch.round(d / box)
        return float((torch.clamp(d.abs() - h - NK.SLACK, min=0.0) ** 2)
                     .sum(-1))

    def extent(c, t):
        p = xyz[c, t][live[c, t]]
        lo, hi = p.min(0).values, p.max(0).values
        return 0.5 * (lo + hi), 0.5 * (hi - lo)

    count = tests = 0
    for c in range(tp.ncells):
        for ti in range(T):
            ni = int(live[c, ti].sum())
            if ni == 0:
                continue
            ci, hi_ = extent(c, ti)
            for cj in tp.full[c].tolist():
                tests += T
                for tj in range(T):
                    nj = int(live[cj, tj].sum())
                    if nj == 0:
                        continue
                    cj_, hj = extent(cj, tj)
                    if not gap2(ci - cj_, hi_ + hj) < rc2:
                        continue
                    tests += nj
                    for q in range(nj):
                        if gap2(ci - xyz[cj, tj, q], hi_) < rc2:
                            count += ni
    assert (visited, culls) == (count, tests)


def test_kernel_blocks_fill_the_card_at_one_walker(sims):
    """One block per (cell, 32-slot tile, walker): a cell of capacity C
    gives ceil(C / 32) tiles."""
    _, ts = sims
    plan = ts.nbplan
    assert NK.tiles(plan) == -(-plan.C // 32)
    assert NK.blocks(plan, 1) == plan.ncells * NK.tiles(plan)
    assert NK.blocks(plan, 64) == 64 * NK.blocks(plan, 1)


def _layout_by_ranking(sys, plan, x):
    """The layout kernel's algorithm for one walker (n, 3) in numpy: each
    atom's cell and sub-cell rank by the kernel's float32 operations, the
    atoms of each cell ranked in index order (a cell keeps its first C),
    the kept atoms of each (cell, sub-cell) ranked in index order, records
    at the sub-cell's offset plus that rank.  Returns the records (slots
    behind a cell's kept atoms left zero: the kernel writes none) and the
    (ncells, T * 32) mask of the slots written."""
    f32 = np.float32
    st = NK._sub_table(plan, sys.cutoff, "cpu")
    ns, rank_of = st["ns"], st["rank"].numpy()
    box, cell = plan.box.astype(f32), plan.cell.astype(f32)
    scale = (ns / plan.cell).astype(f32)
    xw = x - box * np.floor(x / box)
    cd = np.minimum(np.maximum((xw / cell).astype(np.int64), 0), plan.nc - 1)
    cid = (cd[:, 0] * plan.nc[1] + cd[:, 1]) * plan.nc[2] + cd[:, 2]
    sd = np.floor(xw * scale - (cd * ns).astype(f32)).astype(np.int64)
    sd = np.minimum(np.maximum(sd, 0), ns - 1)
    key = rank_of[(sd[:, 0] * ns[1] + sd[:, 1]) * ns[2] + sd[:, 2]]
    nsub, T = int(np.prod(ns)), NK.tiles(plan)
    cnt = np.zeros(plan.ncells, int)
    cnt2 = np.zeros((plan.ncells, nsub), int)
    rank = np.full(len(x), -1)
    for a in range(len(x)):
        c = cid[a]
        if cnt[c] < plan.C:
            rank[a] = cnt2[c, key[a]]
            cnt2[c, key[a]] += 1
        cnt[c] += 1
    start = np.cumsum(cnt2, axis=1) - cnt2
    _, tab = NK._atom_table(sys, plan, "cpu")
    tab = tab.numpy()
    rec = np.zeros((plan.ncells, T * NK.TILE, 8), f32)
    written = np.zeros((plan.ncells, T * NK.TILE), bool)
    for a in np.flatnonzero(rank >= 0):
        slot = start[cid[a], key[a]] + rank[a]
        rec[cid[a], slot] = np.concatenate([xw[a], tab[a]])
        written[cid[a], slot] = True
    return rec, written


@pytest.mark.parametrize("kw", [{}, dict(cells=(3, 3, 3)),
                                dict(capacity=8)])
def test_ranking_layout_matches_kernel_records(sims, xb, kw):
    """The layout kernel's ranking (no sort) writes exactly the live slots
    of ``kernel_records`` and gives their bits, also where full cells drop
    atoms."""
    sys, tp = _kernel_layout(sims, kw)
    rec, boxes = NK.kernel_records(sys, tp, torch.as_tensor(xb[:1]))
    want, written = _layout_by_ranking(sys, tp, xb[0].reshape(-1, 3))
    live = NK.live_slots(boxes[0]).numpy()
    np.testing.assert_array_equal(live, written)
    np.testing.assert_array_equal(rec[0].numpy()[live].view(np.int32),
                                  want[live].view(np.int32))


@pytest.mark.parametrize("kw", [{}, dict(capacity=8)])
def test_layout_bound_counts_the_kept_records(sims, xb, kw):
    """The layout's bound moves the coordinates, the per-atom table, one
    record for each atom the plan keeps and the tile boxes: no record for
    an empty slot or a dropped atom."""
    sys, tp = _kernel_layout(sims, kw)
    x = torch.as_tensor(xb)
    _, boxes = NK.kernel_records(sys, tp, x)
    kept = tp.natoms * x.shape[0] - int(NK.slot_records(sys, tp, x)[1].sum())
    assert int(boxes[..., 3].sum()) == kept
    nbytes = (x.shape[0] * (12 * tp.natoms + 32 * tp.ncells * NK.tiles(tp))
              + 32 * kept + 20 * (tp.natoms + 1))
    ms, by = NK.layout_bound_ms(tp, boxes)
    assert by == "bytes"
    assert ms == pytest.approx(1e3 * nbytes / LK.H100_HBM_BYTES_PER_S,
                               rel=1e-12)


def test_sweep_launch_checks_its_inputs(sims, xb):
    """The sweep alone takes only float32 CUDA tensors of the plan's
    shapes: CPU records, or records of another shape, raise before any
    launch."""
    _, ts = sims
    x = torch.as_tensor(xb)
    rec, boxes = NK.kernel_records(ts.system, ts.nbplan, x)
    n0 = NK.neighbor_sweep.launches
    with pytest.raises(ValueError, match="CUDA"):
        NK.neighbor_sweep.launch(ts.system, ts.nbplan, rec, boxes)
    with pytest.raises(ValueError, match="shape"):
        NK.neighbor_sweep.launch(ts.system, ts.nbplan, rec[:, :, :32],
                                 boxes)
    assert NK.neighbor_sweep.launches == n0


def test_layout_wrapper_dispatch(sims, xb):
    """On a CPU tensor ``neighbor_layout`` is ``kernel_records`` and counts
    no launch; another device raises; a wrong shape raises."""
    _, ts = sims
    x = torch.as_tensor(xb)
    n0 = NK.neighbor_layout.launches
    rec, boxes = NK.neighbor_layout(ts.system, ts.nbplan, x)
    want = NK.kernel_records(ts.system, ts.nbplan, x)
    # ids and bits are int32 bit patterns (an empty slot's id -1 is a NaN)
    assert torch.equal(rec.view(torch.int32), want[0].view(torch.int32))
    assert torch.equal(boxes, want[1])
    assert NK.neighbor_layout.launches == n0
    with pytest.raises(NotImplementedError, match="meta"):
        NK.neighbor_layout(ts.system, ts.nbplan, x.to("meta"))
    with pytest.raises(ValueError):
        NK.neighbor_layout(ts.system, ts.nbplan, x[:, :9])
