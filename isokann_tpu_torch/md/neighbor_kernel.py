"""The cell-list pair sweep of large periodic systems: the hand-written CUDA
kernel, its plain PyTorch version and the wrapper that chooses between
them.

Counterpart of ``isokann_tpu/md/neighbor.py:neighbor_sweep_pallas`` (body
``_nb_kernel_body``).  The CUDA source is ``csrc/neighbor_sweep.cu``; its
header states the design and the bound.

- ``slot_records``: the wrapper's preparation, in PyTorch on the walkers'
  device: wrap into the box, cell ids, a stable sort, the (cell, slot)
  table, and per slot an 8-word record in the sorted frame (x, y, z, q,
  Rmin/2, sqrt(eps), original id, exclusion bits; ids and bits as int32
  bit patterns; an empty slot has id -1 and sits at (1e3, 2e3, 3e3) nm,
  as the reference's pads).
- ``neighbor_sweep_plain``: the kernel's function in tensor ops, on the
  same records: for each column of the full stencil the geometry of the
  whole (ncells, C, C) block, then the TPU body's pair terms on the pairs
  within the cutoff.  The CPU tests and ``chip_smoke.py`` hold the kernel
  against it.
- ``neighbor_sweep``: the wrapper.  A CPU tensor takes the plain version;
  a CUDA tensor launches the kernel or raises.  ``neighbor_sweep.launches``
  counts the launches.
- ``step_ops``, ``kernel_ops``, ``bound_ms``: the operation counts and the
  least time on an H100.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import langevin_kernel as LK
from .neighbor import (_SQRT_PI, NeighborPlan, _rf_consts, erfc_approx,
                       hard_excluded)
from .system import COULOMB, MDSystem

MAX_CAPACITY = 1024      # one thread per slot
MAX_FAR = 8              # far-partner table width the kernel takes
PAD = (1e3, 2e3, 3e3)    # coordinates of an empty slot [nm]


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
    sqrt(eps_i) sqrt(eps_j))."""
    tb = plan.on(rec.device)
    box, ibox = tb["box"], tb["ibox"]
    rc2 = sys.cutoff * sys.cutoff
    C = plan.C
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
        c, a, oi = c[ok], a[ok], oi[ok]
        yield (c * C + a, d[c, a, b[ok]], r2[c, a, b[ok]],
               qi[c, a] * qj[ok], rmi[c, a] + rmj[ok], sei[c, a] * sej[ok])


def neighbor_sweep_plain(sys: MDSystem, plan: NeighborPlan, xb, alpha=None):
    """Sweep forces (B, 3N) -> (B, 3N), walker by walker, over the pairs
    of each full-stencil column with the TPU body's terms (reaction field,
    or the erfc real space given ``alpha``)."""
    _, krf, _ = _rf_consts(sys)
    recs, _ = slot_records(sys, plan, xb)
    n = plan.natoms
    out = []
    for rec in recs:
        # summed in float64, as the kernel sums (see its header)
        acc = torch.zeros(plan.ncells * plan.C, 3, dtype=torch.float64,
                          device=xb.device)
        for islot, d, r2, qiqj, rmin, epsij in _pairs(sys, plan, rec):
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
            w = -2.0 * (g_lj + g_c)
            acc.index_add_(0, islot, (w[:, None] * d).double())
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
_GEOM, _CUT, _EXCL, _RF, _ERFC, _ACC = 21, 1, 7, 22, 48, 6


def pair_counts(sys: MDSystem, plan: NeighborPlan, xb):
    """(in range, visited): the unordered pairs within the cutoff that the
    function computes (not excluded), and the (i, j) slot pairs the kernel
    tests, summed over the walkers of ``xb``."""
    recs, _ = slot_records(sys, plan, xb)
    in_range = visited = 0
    nfull = plan.full.shape[1]
    for rec in recs:
        live = int((_unpack(rec)[4] >= 0).sum())
        visited += live * nfull * plan.C
        for islot, *_ in _pairs(sys, plan, rec):
            in_range += int(islot.shape[0])
    return in_range // 2, visited


def step_ops(in_range: int, alpha=None) -> float:
    """Operations the function needs: per unordered pair within the
    cutoff, the geometry, the tests and the coefficient once and the force
    on both atoms (63 with the reaction field)."""
    coef = _RF if alpha is None else _ERFC
    return float(in_range * (_GEOM + _CUT + _EXCL + coef + 2 * _ACC))


def kernel_ops(in_range: int, visited: int, alpha=None) -> float:
    """Operations the kernel executes: the geometry and the cutoff test
    for every slot pair it visits, the rest for each ordered pair in
    range (each unordered pair twice, once from each side)."""
    coef = _RF if alpha is None else _ERFC
    return float(visited * (_GEOM + _CUT)
                 + 2 * in_range * (_EXCL + coef + _ACC))


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

class NeighborSweep(LK.CudaKernel):
    """``neighbor_sweep(sys, plan, xb, alpha=None)``: (B, 3N) -> (B, 3N)
    full-pair sweep forces."""

    name, source = "neighbor_sweep", "neighbor_sweep.cu"

    def _declare(self, lib):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.neighbor_sweep.argtypes = ([p, p, p, p] + [i] * 7 + [f] * 12
                                       + [p])
        lib.neighbor_sweep.restype = i

    def __call__(self, sys: MDSystem, plan: NeighborPlan, xb, alpha=None):
        if (xb.dtype != torch.float32 or xb.dim() != 2
                or xb.shape[1] != 3 * plan.natoms):
            raise ValueError(f"neighbor_sweep: expected float32 (B, "
                             f"{3 * plan.natoms}), got {tuple(xb.shape)} "
                             f"{xb.dtype}")
        if xb.device.type == "cpu":
            return neighbor_sweep_plain(sys, plan, xb, alpha)
        if xb.device.type != "cuda":
            raise NotImplementedError(f"no neighbor_sweep kernel for "
                                      f"{xb.device}")
        if plan.C > MAX_CAPACITY or plan.excl_far.shape[1] > MAX_FAR:
            raise NotImplementedError(
                f"the neighbor_sweep kernel takes a capacity <= "
                f"{MAX_CAPACITY} and <= {MAX_FAR} far partners, not "
                f"{plan.C} and {plan.excl_far.shape[1]}")
        lib = self.lib()
        rec, _ = slot_records(sys, plan, xb.contiguous())
        tb = plan.on(xb.device)
        f = torch.zeros_like(xb)
        _, krf, _ = _rf_consts(sys)
        a = 0.0 if alpha is None else float(alpha)
        bx, by, bz = (float(b) for b in plan.box)
        stream = torch.cuda.current_stream(xb.device).cuda_stream
        err = lib.neighbor_sweep(
            rec.data_ptr(), tb["full"].data_ptr(), tb["far"].data_ptr(),
            f.data_ptr(), xb.shape[0], plan.natoms, plan.ncells, plan.C,
            plan.full.shape[1], plan.excl_far.shape[1],
            int(alpha is not None), bx, by, bz, 1.0 / bx, 1.0 / by,
            1.0 / bz, sys.cutoff * sys.cutoff, krf, COULOMB, a, a * a,
            a / _SQRT_PI, stream)
        self._raise(err, "neighbor_sweep")
        self.launches += 1
        return f


neighbor_sweep = NeighborSweep()
