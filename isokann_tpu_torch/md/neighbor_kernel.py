"""The cell-list pair sweep of large periodic systems: the hand-written CUDA
kernel, its plain PyTorch version and the wrapper that chooses between
them.

Counterpart of ``isokann_tpu/md/neighbor.py:neighbor_sweep_pallas`` (body
``_nb_kernel_body``).  The CUDA source is ``csrc/neighbor_sweep.cu`` (two
kernels: the layout and the sweep); its header states the design and the
bound.

- ``slot_records``: the plan's cell table, in PyTorch on the walkers'
  device: wrap into the box, cell ids, a stable sort, the (cell, slot)
  table, and per slot an 8-word record in the sorted frame (x, y, z, q,
  Rmin/2, sqrt(eps), original id, exclusion bits; ids and bits as int32
  bit patterns; an empty slot has id -1 and sits at (1e3, 2e3, 3e3) nm,
  as the reference's pads).  The plain version reads these.
- ``kernel_records``: the layout kernel's function, the sweep's records:
  each cell's kept slots ordered by sub-cells of edge >= rc/2 (serpentine
  order), padded to whole 32-slot tiles, and each tile's bounding box and
  live count.  Which atoms a full cell drops is the plan's decision, as
  above.  The function is the live slots (``live_slots``) and the boxes:
  the sweep reads no other slot, and the layout kernel writes none.
- ``neighbor_sweep_plain``: the kernel's function in tensor ops, on the
  same records: for each column of the full stencil the geometry of the
  whole (ncells, C, C) block, then the TPU body's pair terms on the pairs
  within the cutoff.  The CPU tests and ``chip_smoke.py`` hold the kernel
  against it.
- ``neighbor_layout`` and ``neighbor_sweep``: the wrappers.  A CPU tensor
  takes the plain version (``kernel_records``, ``neighbor_sweep_plain``);
  a CUDA tensor launches the kernel or raises.  On the card a sweep is two
  launches of ``neighbor_sweep.cu``: the layout, then the sweep; each
  wrapper counts its own in ``.launches``.
- ``pair_counts``, ``step_ops``, ``kernel_ops``, ``bound_ms``,
  ``layout_bound_ms``, ``blocks``: the pairs and tests of a sweep (the
  sweep's culling mirrored in tensor ops by ``surviving_tiles``), the
  operation counts, the least times on an H100 and the sweep's blocks.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import langevin_kernel as LK
from .ewald import erfc_approx
from .neighbor import _SQRT_PI, NeighborPlan, _rf_consts, hard_excluded
from .system import COULOMB, MDSystem

MAX_FAR = 8              # far-partner table width the kernel takes
PAD = (1e3, 2e3, 3e3)    # coordinates of an empty slot [nm]
TILE = 32                # slots a tile, one per lane of a warp
SPLIT = 4                # warps a tile, each a share of its j tiles
SLACK = 1e-4             # culling margin of the kernel [nm]


def _atom_table(sys: MDSystem, plan: NeighborPlan, device):
    """The empty slot's coordinates (1, 3) and the (n + 1, 5) float32
    per-atom words 3-7 of a record (q, Rmin/2, sqrt(eps), id, bits), the
    last row an empty slot; cached on the plan per system (the entry holds
    the system, so its id stays unique) and device."""
    key = ("atoms", id(sys), str(torch.device(device)))
    if key not in plan._dev:
        n = plan.natoms
        tab = np.zeros((n + 1, 5), np.float32)
        tab[:n, 0] = sys.charges.detach().cpu().numpy()
        tab[:n, 1] = sys.rmin_half.detach().cpu().numpy()
        tab[:n, 2] = np.sqrt(sys.eps.detach().cpu().numpy().astype(
            np.float32))
        ids = np.append(np.arange(n, dtype=np.int32), np.int32(-1))
        tab[:, 3] = ids.view(np.float32)
        tab[:, 4] = plan.excl_bits.view(np.float32)
        plan._dev[key] = (sys, torch.tensor([PAD], device=device),
                          torch.as_tensor(tab, device=device))
    return plan._dev[key][1:]


def slot_records(sys: MDSystem, plan: NeighborPlan, xb):
    """(B, 3N) walkers -> ((B, ncells, C, 8) float32 slot records, (B,)
    overflow counts)."""
    B, n = xb.shape[0], plan.natoms
    tb = plan.on(xb.device)
    x3 = xb.reshape(B, n, 3)
    xw = x3 - tb["box"] * torch.floor(x3 / tb["box"])
    order, table, _, overflow = plan.sorted_frame(xw)
    order_pad = torch.cat([order, torch.full((B, 1), n, dtype=order.dtype,
                                             device=order.device)], dim=1)
    src = torch.gather(order_pad, 1, table.reshape(B, -1))   # sentinel n
    pad, tab = _atom_table(sys, plan, xb.device)
    atoms = torch.cat([torch.cat([xw, pad.expand(B, 1, 3)], dim=1),
                       tab.expand(B, n + 1, 5)], dim=-1)
    rec = torch.gather(atoms, 1, src[..., None].expand(-1, -1, 8))
    return rec.reshape(B, plan.ncells, plan.C, 8), overflow


# ==========================================================================
# The kernel's layout: sub-cell order, tiles and their boxes
# ==========================================================================

def _sub_table(plan: NeighborPlan, rc: float, device):
    """Sub-cells of the kernel's order: their count per axis (edge >= rc/2
    within a plan cell), each cell's corner in sub-cell units (ncells, 3),
    and the serpentine rank of each sub-cell (x slowest; y and z reverse
    on alternate rows, so consecutive sub-cells touch), cached per
    device."""
    key = ("sub", str(torch.device(device)))
    if key not in plan._dev:
        ns = np.maximum(np.floor(plan.cell / (0.5 * rc)), 1).astype(int)
        grid = np.stack(np.meshgrid(*[np.arange(k) for k in plan.nc],
                                    indexing="ij"), axis=-1).reshape(-1, 3)
        rank, order = np.zeros(ns, np.int64), 0
        for sx in range(ns[0]):
            for iy in range(ns[1]):
                sy = iy if sx % 2 == 0 else ns[1] - 1 - iy
                for iz in range(ns[2]):
                    sz = iz if (sx * ns[1] + iy) % 2 == 0 else ns[2] - 1 - iz
                    rank[sx, sy, sz] = order
                    order += 1
        plan._dev[key] = dict(
            ns=ns, scale=torch.tensor(ns / plan.cell, dtype=torch.float32,
                                      device=device),
            corner=torch.tensor(grid * ns, dtype=torch.float32,
                                device=device),
            top=torch.tensor(ns - 1, device=device),
            stride=torch.tensor([ns[1] * ns[2], ns[2], 1], device=device),
            rank=torch.tensor(rank.ravel(), dtype=torch.int32,
                              device=device))
    return plan._dev[key]


def tiles(plan: NeighborPlan) -> int:
    """Tiles of ``TILE`` slots a cell."""
    return -(-plan.C // TILE)


def blocks(plan: NeighborPlan, nwalkers: int) -> int:
    """Blocks the sweep starts for ``nwalkers`` walkers: one per (cell,
    tile, walker), of ``SPLIT`` warps."""
    return plan.ncells * tiles(plan) * int(nwalkers)


def kernel_records(sys: MDSystem, plan: NeighborPlan, xb):
    """(B, 3N) walkers -> the kernel's (B, ncells, T * 32, 8) records and
    (B, ncells, T, 8) tile boxes (lo x, y, z, live count, hi x, y, z, 0).

    The records of ``slot_records`` (the plan's kept slots, empty slots
    last), each cell's kept slots ordered by sub-cell (a stable sort of
    each cell's row, so a sub-cell's atoms keep the plan's order), padded
    with empty slots to whole tiles."""
    rec, _ = slot_records(sys, plan, xb)
    B, C, T = rec.shape[0], plan.C, tiles(plan)
    st = _sub_table(plan, sys.cutoff, rec.device)
    if T * TILE > C:
        pad, tab = _atom_table(sys, plan, rec.device)
        empty = torch.cat([pad[0], tab[-1]])
        rec = torch.cat([rec, empty.expand(B, plan.ncells, T * TILE - C, 8)],
                        dim=2)
    live = rec.view(torch.int32)[..., 6] >= 0
    sub = torch.floor(rec[..., 0:3] * st["scale"]
                      - st["corner"][:, None, :]).long()
    sub = torch.clamp(sub, min=torch.zeros_like(st["top"]), max=st["top"])
    key = torch.where(live, st["rank"][(sub * st["stride"]).sum(-1)],
                      int(np.prod(st["ns"])))
    perm = torch.sort(key, dim=-1, stable=True)[1]
    rec = torch.gather(rec, 2, perm[..., None].expand(-1, -1, -1, 8))
    xyz = rec[..., 0:3].reshape(B, plan.ncells, T, TILE, 3)
    lt = live.reshape(B, plan.ncells, T, TILE)[..., None]
    lo = torch.where(lt, xyz, torch.inf).amin(dim=3)
    hi = torch.where(lt, xyz, -torch.inf).amax(dim=3)
    boxes = torch.cat([lo, lt.sum(dim=3, dtype=torch.float32), hi,
                       torch.zeros_like(lo[..., :1])], dim=-1)
    return rec, boxes


def live_slots(boxes):
    """(..., T, 8) tile boxes -> (..., T * 32) mask of the live slots, each
    tile's first ``live count`` slots: the part of the records that the
    sweep reads."""
    lane = torch.arange(TILE, device=boxes.device)
    return (lane < boxes[..., 3:4]).flatten(-2)


def _gap2(d, h, box):
    """Squared lower bound, beyond the kernel's slack, of the minimum-image
    distance between boxes (or a box and a point) whose centres are ``d``
    apart (..., 3) with summed half widths ``h``."""
    d = d - box * torch.round(d / box)
    return (torch.clamp(d.abs() - h - SLACK, min=0.0) ** 2).sum(-1)


def surviving_tiles(sys: MDSystem, plan: NeighborPlan, rec, boxes):
    """The kernel's culling for one walker's ``kernel_records`` (rec
    (ncells, T * 32, 8), boxes (ncells, T, 8)), per full-stencil column
    s: the (ncells, T, T) mask of (i tile, j tile of cell full[c, s]) pairs
    whose boxes lie within the cutoff, and the (ncells, T, T, 32) mask of
    the j tile's records within the cutoff of the i tile's box (both
    false where a tile is empty).  Yields (s, tile mask, record mask)."""
    tb = plan.on(rec.device)
    box, rc2 = tb["box"], sys.cutoff * sys.cutoff
    T = boxes.shape[1]
    c = 0.5 * (boxes[..., 0:3] + boxes[..., 4:7])
    h = 0.5 * (boxes[..., 4:7] - boxes[..., 0:3])
    n = boxes[..., 3]
    xyz = rec[..., 0:3].reshape(-1, T, TILE, 3)
    slot = torch.arange(TILE, device=rec.device)
    for s, cj in enumerate(tb["full"].long().unbind(1)):
        near = ((_gap2(c[:, :, None] - c[cj][:, None], h[:, :, None]
                       + h[cj][:, None], box) < rc2)
                & (n[:, :, None] > 0) & (n[cj][:, None] > 0))
        keep = ((_gap2(c[:, :, None, None] - xyz[cj][:, None],
                       h[:, :, None, None], box) < rc2)
                & (slot < n[cj][:, None, :, None]) & near[..., None])
        yield s, near, keep


# ==========================================================================
# Plain PyTorch version (the kernel's function on the same records)
# ==========================================================================

def _unpack(rec):
    """Fields of (..., 8) records: coordinates (..., 3), q, Rmin/2,
    sqrt(eps), id, bits."""
    ints = rec.view(torch.int32)
    return (rec[..., 0:3], rec[..., 3], rec[..., 4], rec[..., 5],
            ints[..., 6].long(), ints[..., 7].long())


def _pairs(sys: MDSystem, plan: NeighborPlan, rec):
    """The pairs of one walker's records (ncells, C, 8) that the kernel
    computes, per full-stencil column: the minimum-image geometry of every
    (i slot, j slot) pair of the column's (ncells, C, C) block, cut to the
    pairs of two different atoms within the cutoff that no hard exclusion
    masks.  Yields (flat i slot, d (P, 3), r2, q_i q_j, Rmin_ij,
    sqrt(eps_i) sqrt(eps_j), flat j slot).  ``rec`` may hold any number
    of slots a cell (the plan's C, or the kernel's padded tiles)."""
    tb = plan.on(rec.device)
    box, ibox = tb["box"], tb["ibox"]
    rc2 = sys.cutoff * sys.cutoff
    C = rec.shape[1]
    xi, qi, rmi, sei, oidi, bitsi = _unpack(rec)
    far = torch.cat([tb["far"][:plan.natoms].long(),
                     torch.full((1, tb["far"].shape[1]), -1,
                                device=rec.device)])
    full = tb["full"].long()
    for s in range(full.shape[1]):
        recj = rec[full[:, s]]
        xj, _, _, _, oidj, _ = _unpack(recj)
        d = xi[:, :, None, :] - xj[:, None, :, :]
        d = d - box * torch.round(d * ibox)
        # one rounding per operation, in the kernel's order, so that both
        # versions draw the cutoff through the same pairs
        dx, dy, dz = d.unbind(-1)
        r2 = dx * dx + dy * dy + dz * dz + 1e-12
        keep = ((r2 < rc2) & (oidi[:, :, None] >= 0)
                & (oidj[:, None, :] >= 0)
                & (oidi[:, :, None] != oidj[:, None, :]))
        c, a, b = keep.nonzero(as_tuple=True)
        _, qj, rmj, sej, oj, bj = _unpack(recj[c, b])
        oi = oidi[c, a]
        ok = ~hard_excluded(oi, oj, bitsi[c, a], bj, far[oi])
        c, a, b = c[ok], a[ok], b[ok]
        yield (c * C + a, d[c, a, b], r2[c, a, b], qi[c, a] * qj[ok],
               rmi[c, a] + rmj[ok], sei[c, a] * sej[ok], full[c, s] * C + b)


def pair_force(sys: MDSystem, d, r2, qiqj, rmin, epsij, alpha=None):
    """The TPU body's force on atom i of pairs (P,) from d = x_i - x_j
    (P, 3), r^2 and the pair's parameters: -2 dE/d(r^2) d with LJ and the
    reaction field, or the erfc real space given ``alpha``."""
    _, krf, _ = _rf_consts(sys)
    inv_r = torch.rsqrt(r2)
    inv_r2 = inv_r * inv_r
    qq = COULOMB * qiqj
    x6 = (rmin * rmin * inv_r2) ** 3
    g_lj = 6.0 * epsij * (x6 - x6 * x6) * inv_r2
    if alpha is None:
        g_c = qq * (-0.5 * inv_r2 * inv_r) + qq * krf
    else:
        er = erfc_approx(alpha * (r2 * inv_r))
        g_c = -qq * (0.5 * er * inv_r2 * inv_r
                     + (alpha / _SQRT_PI)
                     * torch.exp(-(alpha * alpha) * r2) * inv_r2)
    return (-2.0 * (g_lj + g_c))[:, None] * d


def neighbor_sweep_plain(sys: MDSystem, plan: NeighborPlan, xb, alpha=None):
    """Sweep forces (B, 3N) -> (B, 3N), walker by walker, over the pairs
    of each full-stencil column with the TPU body's terms (reaction field,
    or the erfc real space given ``alpha``)."""
    recs, _ = slot_records(sys, plan, xb)
    n = plan.natoms
    out = []
    for rec in recs:
        # summed in float64, as the kernel sums (see its header)
        acc = torch.zeros(plan.ncells * plan.C, 3, dtype=torch.float64,
                          device=xb.device)
        for islot, d, r2, qiqj, rmin, epsij, _ in _pairs(sys, plan, rec):
            acc.index_add_(0, islot, pair_force(sys, d, r2, qiqj, rmin,
                                                epsij, alpha).double())
        oid = _unpack(rec)[4].reshape(-1)
        f = torch.zeros(n + 1, 3, dtype=xb.dtype, device=xb.device)
        f[torch.where(oid >= 0, oid, n)] = acc.to(xb.dtype)
        out.append(f[:n].reshape(-1))
    return torch.stack(out)


# ==========================================================================
# Operation counts and the bound
# ==========================================================================

# Per pair, counted from the kernel body, each rsqrt, exp, division and
# comparison as one operation: the geometry (3 differences, minimum image
# 4 a coordinate, r^2 with its epsilon 6) 21 and the cutoff test 1; the
# exclusion tests (index difference, window bit, far partner) 7; the LJ +
# reaction-field coefficient 22 (48 with the erfc real space: its
# polynomial, two exp and the Gaussian term); the force accumulation 6.
# A culling test (box against box, or a record against a box: centre
# differences, minimum image, the gaps beyond the slack, their squares
# and the comparison) 36.
_GEOM, _CUT, _EXCL, _RF, _ERFC, _ACC, _CULL = 21, 1, 7, 22, 48, 6, 36


def pair_counts(sys: MDSystem, plan: NeighborPlan, xb):
    """(in range, visited, culls), summed over the walkers of ``xb``: the
    unordered pairs within the cutoff that the function computes (not
    excluded); the (i, j) slot pairs the kernel tests, a live i slot
    against each record of a surviving j tile that passes the record
    test; and the kernel's culling tests (each live i tile against every
    tile of its stencil cells, each record of a surviving tile against the
    i tile's box)."""
    in_range = visited = culls = 0
    for rec in slot_records(sys, plan, xb)[0]:
        for islot, *_ in _pairs(sys, plan, rec):
            in_range += int(islot.shape[0])
    recs, boxes = kernel_records(sys, plan, xb)
    full = torch.as_tensor(plan.full, dtype=torch.long, device=xb.device)
    for rec, bx in zip(recs, boxes):
        n = bx[..., 3].long()                          # (ncells, T)
        for s, near, keep in surviving_tiles(sys, plan, rec, bx):
            visited += int((n[:, :, None] * keep.sum(-1)).sum())
            culls += (int((n > 0).sum()) * n.shape[1]
                      + int((near * n[full[:, s]][:, None, :]).sum()))
    return in_range // 2, visited, culls


def step_ops(in_range: int, alpha=None) -> float:
    """Operations the function needs: per unordered pair within the
    cutoff, the geometry, the tests and the coefficient once and the force
    on both atoms (63 with the reaction field)."""
    coef = _RF if alpha is None else _ERFC
    return float(in_range * (_GEOM + _CUT + _EXCL + coef + 2 * _ACC))


def kernel_ops(in_range: int, visited: int, culls: int,
               alpha=None) -> float:
    """Operations the kernel executes: the geometry and the cutoff test
    for every slot pair it visits, the rest for each ordered pair in
    range (each unordered pair twice, once from each side), and its
    culling tests."""
    coef = _RF if alpha is None else _ERFC
    return float(visited * (_GEOM + _CUT) + culls * _CULL
                 + 2 * in_range * (_EXCL + coef + _ACC))


def layout_bound_ms(plan: NeighborPlan, boxes):
    """Least time on an H100 for the layout whose output has the tile
    ``boxes`` (B, ncells, T, 8), and what bounds it: the coordinates and
    the per-atom table read once, one record written for each atom the
    cells keep (the live counts in ``boxes``) and the tile boxes written
    once, over the memory rate (its operations, a few dozen an atom, take
    far less)."""
    kept = int(boxes[..., 3].sum())
    nbytes = (boxes.shape[0] * (4 * 3 * plan.natoms
                                + 4 * 8 * plan.ncells * tiles(plan))
              + 4 * 8 * kept + 4 * 5 * (plan.natoms + 1))
    return 1e3 * nbytes / LK.H100_HBM_BYTES_PER_S, "bytes"


def bound_ms(plan: NeighborPlan, nwalkers: int, in_range: int, alpha=None):
    """Least time on an H100 for one sweep of ``nwalkers`` walkers with
    ``in_range`` unordered pairs in cutoff among them, and what bounds it:
    the operations over the FP32 peak, or the coordinates read and the
    forces written once, with the per-atom tables (q, Rmin/2, sqrt(eps),
    bits, far partners) read once, over the memory rate."""
    nbytes = (2 * 4 * 3 * plan.natoms * nwalkers
              + 4 * 4 * plan.natoms + plan.excl_far.nbytes)
    t_ops = step_ops(in_range, alpha) / LK.H100_FP32_PEAK
    t_bytes = nbytes / LK.H100_HBM_BYTES_PER_S
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


# ==========================================================================
# Wrapper: plain version on the CPU, the kernel on the card
# ==========================================================================

class NeighborLayout(LK.CudaKernel):
    """``neighbor_layout(sys, plan, xb)``: (B, 3N) walkers -> the
    kernel's (records, tile boxes), ``kernel_records``' function in the
    layout kernel of ``neighbor_sweep.cu`` (its plain version on the
    CPU).  On the card only the live slots of the records are written."""

    name, source = "neighbor_sweep", "neighbor_sweep.cu"

    def _declare(self, lib):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.neighbor_layout.argtypes = [p] * 6 + [i] * 11 + [f] * 9 + [p]
        lib.neighbor_layout.restype = i

    def __call__(self, sys: MDSystem, plan: NeighborPlan, xb):
        _check_walkers(plan, xb)
        if xb.device.type == "cpu":
            return kernel_records(sys, plan, xb)
        if xb.device.type != "cuda":
            raise NotImplementedError(f"no neighbor_layout kernel for "
                                      f"{xb.device}")
        lib = self.lib()
        B, n, T = xb.shape[0], plan.natoms, tiles(plan)
        xb = xb.contiguous()
        st = _sub_table(plan, sys.cutoff, xb.device)
        _, tab = _atom_table(sys, plan, xb.device)
        scratch = torch.empty(B, 3, n, dtype=torch.int32, device=xb.device)
        rec = torch.empty(B, plan.ncells, T * TILE, 8, dtype=torch.float32,
                          device=xb.device)
        boxes = torch.empty(B, plan.ncells, T, 8, dtype=torch.float32,
                            device=xb.device)
        stream = torch.cuda.current_stream(xb.device).cuda_stream
        err = lib.neighbor_layout(
            xb.data_ptr(), tab.data_ptr(), st["rank"].data_ptr(),
            scratch.data_ptr(), rec.data_ptr(), boxes.data_ptr(), B, n,
            plan.ncells, plan.C, T, *(int(c) for c in plan.nc),
            *(int(c) for c in st["ns"]), *(float(b) for b in plan.box),
            *(float(c) for c in plan.cell),
            *(float(c) for c in st["ns"] / plan.cell), stream)
        self._raise(err, "neighbor_layout")
        self.launches += 1
        return rec, boxes


def _check_walkers(plan: NeighborPlan, xb):
    if (xb.dtype != torch.float32 or xb.dim() != 2
            or xb.shape[1] != 3 * plan.natoms):
        raise ValueError(f"neighbor_sweep: expected float32 (B, "
                         f"{3 * plan.natoms}), got {tuple(xb.shape)} "
                         f"{xb.dtype}")


class NeighborSweep(LK.CudaKernel):
    """``neighbor_sweep(sys, plan, xb, alpha=None)``: (B, 3N) -> (B, 3N)
    full-pair sweep forces."""

    name, source = "neighbor_sweep", "neighbor_sweep.cu"

    def _declare(self, lib):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.neighbor_sweep.argtypes = ([p, p, p, p, p] + [i] * 7
                                       + [f] * 12 + [p])
        lib.neighbor_sweep.restype = i

    def __call__(self, sys: MDSystem, plan: NeighborPlan, xb, alpha=None):
        _check_walkers(plan, xb)
        if xb.device.type == "cpu":
            return neighbor_sweep_plain(sys, plan, xb, alpha)
        if xb.device.type != "cuda":
            raise NotImplementedError(f"no neighbor_sweep kernel for "
                                      f"{xb.device}")
        if plan.excl_far.shape[1] > MAX_FAR or xb.shape[0] > 65535:
            raise NotImplementedError(
                f"the neighbor_sweep kernel takes <= {MAX_FAR} far partners "
                f"and <= 65535 walkers, not {plan.excl_far.shape[1]} and "
                f"{xb.shape[0]}")
        rec, boxes = neighbor_layout(sys, plan, xb)
        return self.launch(sys, plan, rec, boxes, alpha)

    def launch(self, sys: MDSystem, plan: NeighborPlan, rec, boxes,
               alpha=None, out=None):
        """The sweep alone on ``neighbor_layout``'s output (CUDA tensors):
        (B, 3N) forces, into ``out`` if given (zeroed: the kernel writes
        only the atoms in the records)."""
        B, Tp = rec.shape[0], tiles(plan)
        want = ((B, plan.ncells, Tp * TILE, 8), (B, plan.ncells, Tp, 8),
                (B, 3 * plan.natoms))
        for name, t, shape in zip(("records", "boxes", "out"),
                                  (rec, boxes, out), want):
            if t is None and name == "out":
                continue
            if (t.device.type != "cuda" or t.dtype != torch.float32
                    or tuple(t.shape) != shape or not t.is_contiguous()):
                raise ValueError(f"neighbor_sweep.launch: {name} must be a "
                                 f"contiguous float32 CUDA tensor of shape "
                                 f"{shape}, got {tuple(t.shape)} {t.dtype} "
                                 f"on {t.device}")
        lib = self.lib()
        tb = plan.on(rec.device)
        f = out if out is not None else torch.zeros(
            B, 3 * plan.natoms, dtype=torch.float32, device=rec.device)
        _, krf, _ = _rf_consts(sys)
        a = 0.0 if alpha is None else float(alpha)
        bx, by, bz = (float(b) for b in plan.box)
        stream = torch.cuda.current_stream(rec.device).cuda_stream
        err = lib.neighbor_sweep(
            rec.data_ptr(), boxes.data_ptr(), tb["full"].data_ptr(),
            tb["far"].data_ptr(), f.data_ptr(), B, plan.natoms,
            plan.ncells, tiles(plan), plan.full.shape[1],
            plan.excl_far.shape[1], int(alpha is not None), bx, by, bz,
            1.0 / bx, 1.0 / by, 1.0 / bz, sys.cutoff * sys.cutoff, krf,
            COULOMB, a, a * a, a / _SQRT_PI, stream)
        self._raise(err, "neighbor_sweep")
        self.launches += 1
        return f


neighbor_layout = NeighborLayout()
neighbor_sweep = NeighborSweep()
