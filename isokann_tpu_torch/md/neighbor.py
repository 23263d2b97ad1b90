"""O(n) cell-list neighbor engine for large periodic systems: the plan,
the plain pair sweep, exception corrections and sparse bonded terms.

Counterpart of ``isokann_tpu/md/neighbor.py`` for the reaction-field
``CutoffPeriodic`` method (what the reference's "auto" rule picks for a
boxed system), for Ewald / PME (the erfc real space in the sweep, the
reciprocal sum and the exception corrections of ``md/ewald.py``) and for
LJPME (the dispersion h-term q6_i q6_j h(r) in the sweep and the
exceptions, its reciprocal sum and k = 0 term).  The
dense all-pairs path needs (n, n) tensors; this engine tiles the box into
cells of at most ``C`` atoms and sweeps cell-blocked pairs over a
precomputed stencil:

- ``NeighborPlan``: the reference's grid choice (its cost model and
  candidate grids, copied as they are so that plans equal the JAX
  package's), the deduplicated canonical stencil (``stencil``, Newton half
  offsets or all of them, and ``full``, the self cell and every distinct
  neighbour cell), the cell capacity, the hard-exclusion window bitmask
  (``excl_bits``, bit d-1 of atom i set when atom i+d is a 1-2/1-3 partner,
  d <= 32) and the far-partner table ``excl_far``; ``sorted_frame`` (a
  stable sort of the cell ids), ``table`` and ``overflow``.  ``box_slack``
  builds the stencil for cells (1 - box_slack) times as long, so that it
  stays valid while an NPT box shrinks; ``geometry`` gives the box, its
  inverse and the cell edges of the plan's box or of one given at run
  time (the grid keeps its cell counts).
- ``_sweep``: the reference's tensor sweep (energy, or forces with the
  Newton reaction through the static inverse permutation) for one walker.
- ``_exception_terms``: the sparse 1-4 corrections; hard exclusions are
  masked inside the sweep.  Under Ewald every exception pair also takes
  out the reciprocal sum's erf part (OpenMM's exception semantics).
- ``bonded_force_sparse``: analytic bonded forces (CMAP included) by
  gathers, summed per atom in a fixed order (no atomics: the same input
  gives the same bits on the card); ``strip_rigid_water_bonded`` drops
  the bond and angle terms of rigid waters.
- ``force_flat_neighbor``: batched forces, the sweep in
  ``md.neighbor_kernel.neighbor_sweep`` (the hand-written CUDA kernel on
  the card, with the erfc real space under Ewald and the dispersion term
  under LJPME; its plain version on the CPU) plus the exception
  corrections, the reciprocal forces under Ewald and the bonded terms.

Every entry point takes ``box``, the box at run time (a tensor or three
numbers) in place of the system's: the NPT barostat's volume moves.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .ewald import (erfc_approx, ewald_alpha,  # noqa: F401
                    ewald_recip_energy, ewald_recip_forces,
                    ewald_self_energy,
                    ewald_tables_for_box, ljpme_const_energy,
                    ljpme_hker_grad, ljpme_tables_for_box)
from .forces import bonded_energy, dispersion_correction_energy, torsions
from .system import COULOMB, EWALD, PERIODIC, MDSystem

WIN = 32                 # hard-exclusion window of the bitmask
_SQRT_PI = math.sqrt(math.pi)


def box_np(box):
    """A box given at run time (a tensor or three numbers) as a float64
    numpy (3,) on the host."""
    if torch.is_tensor(box):
        box = box.detach().cpu().tolist()
    return np.asarray(box, np.float64).reshape(3)


def _round_up(x, m):
    return ((x + m - 1) // m) * m


class NeighborPlan:
    """Static cell-grid data for a (box, cutoff, natoms) combination.

    ``x0`` (optional, (natoms, 3)): coordinates that size the per-cell
    capacity (``margin`` times the largest occupancy); without them a
    density heuristic is used.  ``capacity`` overrides both, ``cell_div``
    (a scalar divisor of the cutoff or a per-axis cell count) and
    ``cells`` override the grid choice.  ``box_slack``: the stencil stays
    valid for boxes down to (1 - box_slack) of the system's (NPT).
    ``cutoff`` overrides the system's (the Verlet lists' grid at cutoff +
    skin, ``md/verlet.py``)."""

    def __init__(self, sys: MDSystem, x0=None, capacity: int = None,
                 margin: float = 1.5, cell_div=None, cells=None,
                 box_slack: float = 0.0, cutoff: float = None):
        if sys.method not in PERIODIC or sys.box is None:
            raise ValueError(f"neighbor engine requires a periodic method "
                             f"{PERIODIC} with a box, not {sys.method}")
        self.box_slack = float(box_slack)
        self.box = np.asarray(sys.box, np.float64)
        self.cutoff = float(sys.cutoff if cutoff is None else cutoff)
        if not self.cutoff < float(self.box.min()) / 2:
            raise ValueError(
                f"neighbor engine requires cutoff < min(box)/2 "
                f"(cutoff={self.cutoff}, box={tuple(self.box)})")
        self.natoms = int(sys.natoms)

        def config(div):
            """Grid geometry, the deduplicated canonical offsets and the
            stencil offsets (Newton halves when no offset aliases its own
            negation).  ``div``: a scalar (cells of edge >= cutoff/div) or
            a per-axis cell count."""
            if np.ndim(div) == 1:
                nc = np.maximum(np.asarray(div, int), 1)
            else:
                nc = np.maximum(np.floor(self.box * div / self.cutoff),
                                1.0).astype(int)
            edge = self.box / nc
            Rd = np.minimum(np.ceil(self.cutoff / edge - 1e-9).astype(int),
                            nc)
            shrunk = edge * (1.0 - self.box_slack)

            def canon(o):
                """Canonical wrapped offset in [-nc//2, (nc-1)//2]."""
                return tuple(int((v + n // 2) % n - n // 2)
                             for v, n in zip(o, nc))

            offs = []
            for ox in range(-Rd[0], Rd[0] + 1):
                for oy in range(-Rd[1], Rd[1] + 1):
                    for oz in range(-Rd[2], Rd[2] + 1):
                        o = canon((ox, oy, oz))
                        sep = np.array([max(abs(o[0]) - 1, 0) * shrunk[0],
                                        max(abs(o[1]) - 1, 0) * shrunk[1],
                                        max(abs(o[2]) - 1, 0) * shrunk[2]])
                        if np.dot(sep, sep) < self.cutoff ** 2:
                            offs.append(o)
            # offsets that wrap onto the same cell (small or collapsed
            # axes) have one canonical form
            uniq = list(dict.fromkeys(offs))
            newton = all(canon([-v for v in o]) != o
                         for o in uniq if o != (0, 0, 0))
            half = [o for o in uniq if o > (0, 0, 0)] if newton else \
                   [o for o in uniq if o != (0, 0, 0)]
            return nc, edge, half, newton, uniq

        def occupancy(nc, edge):
            if x0 is None:
                return margin * self.natoms / np.prod(nc) + 8
            xw = np.asarray(x0, np.float64).reshape(-1, 3)
            xw = xw - self.box * np.floor(xw / self.box)
            cd = np.minimum((xw / edge).astype(int), nc - 1)
            cid = (cd[:, 0] * nc[1] + cd[:, 1]) * nc[2] + cd[:, 2]
            return margin * np.bincount(cid, minlength=np.prod(nc)).max()

        if cell_div is None:
            # the reference's cost model: pair-block work plus a per-block
            # overhead tuned for its TPU, over coarse / fine / collapsed
            # candidates per axis, with its capacity bound
            best = None
            PER_STEP_OVERHEAD = 40_000
            C_MAX = 768
            axis_cands = []
            for L in self.box:
                f = max(1, int(math.floor(L / self.cutoff)))
                axis_cands.append(sorted({1, f, 2 * f}))
            for nx in axis_cands[0]:
                for ny in axis_cands[1]:
                    for nz in axis_cands[2]:
                        nc, edge, half, newton, _ = config((nx, ny, nz))
                        C = _round_up(
                            max(int(math.ceil(occupancy(nc, edge))), 4), 4)
                        if C > C_MAX:
                            continue
                        steps = np.prod(nc) * (len(half) + 1)
                        work = (C * C * (len(half)
                                         * (0.5 if newton else 1.0) + 1)
                                * np.prod(nc)
                                + steps * PER_STEP_OVERHEAD)
                        if best is None or work < best[0]:
                            best = (work, (nx, ny, nz))
            if best is None:
                best = (0, tuple(2 * max(1, int(math.floor(
                    L / self.cutoff))) for L in self.box))
            cell_div = best[1]
        if cells is not None:
            cell_div = tuple(int(c) for c in cells)
        self.cell_div = cell_div

        self.nc, self.cell, half, self.newton, uniq = config(cell_div)
        self.ncells = int(np.prod(self.nc))
        grid = np.stack(np.meshgrid(*[np.arange(n) for n in self.nc],
                                    indexing="ij"), axis=-1).reshape(-1, 3)

        def cells_of(o):
            nb = (grid + list(o)) % self.nc
            return ((nb[:, 0] * self.nc[1] + nb[:, 1]) * self.nc[2]
                    + nb[:, 2]).astype(np.int32)

        cand = (np.stack([cells_of(o) for o in half], axis=1) if half
                else np.zeros((self.ncells, 0), np.int32))
        inv = np.empty_like(cand)
        for s in range(cand.shape[1]):
            inv[cand[:, s], s] = np.arange(self.ncells, dtype=np.int32)
        self.stencil = cand              # (ncells, S) neighbour cells
        self.stencil_inv = inv           # their inverse permutations
        self.S = cand.shape[1]
        # the full stencil: the self cell, then every distinct neighbour
        # cell once (each thread of the kernel sums its own atom's force)
        others = [o for o in uniq if o != (0, 0, 0)]
        self.full = np.stack([cells_of((0, 0, 0))]
                             + [cells_of(o) for o in others], axis=1)

        if capacity is None:
            capacity = int(math.ceil(occupancy(self.nc, self.cell)))
        self.C = _round_up(max(capacity, 8), 8)

        # hard exclusions (1-2/1-3) are masked inside the sweep: bit d-1 of
        # bits[i] is set iff atom i+d is a hard partner of i (1 <= d <= 32);
        # farther partners go to the narrow (n+1, E2) table, padded with -1
        eidx = sys.excl_idx.detach().cpu().numpy()
        eqq = sys.excl_qq.detach().cpu().numpy()
        elj = sys.excl_lj.detach().cpu().numpy()
        hard = (eqq == 0.0) & (elj == 0.0)
        self.n_soft = int((~hard).sum())
        bits = np.zeros(self.natoms + 1, np.int64)
        farp = [[] for _ in range(self.natoms)]
        for (a, b) in eidx[hard]:
            lo, hi = (int(a), int(b)) if a < b else (int(b), int(a))
            d = hi - lo
            if 1 <= d <= WIN:
                bits[lo] |= 1 << (d - 1)
            else:
                farp[lo].append(hi)
                farp[hi].append(lo)
        E2 = max(1, max((len(p) for p in farp), default=1))
        far = np.full((self.natoms + 1, E2), -1, np.int32)
        for a, p in enumerate(farp):
            far[a, :len(p)] = p
        # int32 with bit 31 as the sign bit, as the reference stores it
        self.excl_bits = bits.astype(np.uint32).view(np.int32)
        self.excl_far = far
        self._dev = {}

    def on(self, device) -> dict:
        """The plan's tables as tensors on ``device`` (built once per
        device)."""
        key = str(torch.device(device))
        if key not in self._dev:
            def t(a, dtype):
                return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                                       device=device)
            self._dev[key] = dict(
                stencil=t(self.stencil, torch.long),
                stencil_inv=t(self.stencil_inv, torch.long),
                full=t(self.full, torch.int32),
                bits=t(self.excl_bits, torch.int32),
                far=t(self.excl_far, torch.int32),
                box=t(self.box, torch.float32),
                ibox=t(1.0 / self.box, torch.float32),
                cell=t(self.cell, torch.float32),
                nc=t(self.nc, torch.long),
                cells=t(np.arange(self.ncells), torch.long),
                slots=t(np.arange(self.C), torch.long),
                atoms=t(np.arange(self.natoms), torch.long))
        return self._dev[key]

    def geometry(self, device, box=None) -> dict:
        """The box lengths, their inverses and the cell edges as float32
        tensors on ``device`` (``box``, ``ibox``, ``cell``) and in float64
        on the host (``box_np``, ``cell_np``): the plan's, or those of the
        box ``box`` given at run time (a tensor or three numbers; the grid
        keeps its cell counts, the edges scale with the box).  The last
        run-time box is cached."""
        if box is None:
            tb = self.on(device)
            return dict(box=tb["box"], ibox=tb["ibox"], cell=tb["cell"],
                        box_np=self.box, cell_np=self.cell)
        b = box_np(box)
        key = (str(torch.device(device)), tuple(b))
        last = self._dev.get("geometry")
        if last is None or last[0] != key:
            def t(a):
                return torch.as_tensor(a, dtype=torch.float32, device=device)
            cell = b / self.nc
            last = (key, dict(box=t(b), ibox=t(1.0 / b), cell=t(cell),
                              box_np=b, cell_np=cell))
            self._dev["geometry"] = last
        return last[1]

    def box_tensor(self, device, dtype, box=None):
        """The box lengths of ``geometry`` as a tensor of ``dtype`` on
        ``device``: its cached float32 ``box``, or for float64 walkers the
        float64 lengths, cached beside it (no host copy a call)."""
        geo = self.geometry(device, box)
        if dtype == torch.float32:
            return geo["box"]
        store = self.on(device) if box is None else geo
        key = f"box_{dtype}"
        if key not in store:
            store[key] = torch.as_tensor(geo["box_np"], dtype=dtype,
                                         device=device)
        return store[key]

    def _cell_id_np(self, x):
        xw = np.asarray(x, np.float64).reshape(-1, 3)
        xw = xw - self.box * np.floor(xw / self.box)
        cd = np.minimum((xw / self.cell).astype(int), self.nc - 1)
        return (cd[:, 0] * self.nc[1] + cd[:, 1]) * self.nc[2] + cd[:, 2]

    # ---- the cell table, on the walkers' device ---------------------------

    def cell_id(self, xw, box=None):
        """(..., n, 3) wrapped coordinates -> (..., n) cell ids (the cell
        edges of ``geometry``)."""
        tb = self.on(xw.device)
        cell = self.geometry(xw.device, box)["cell"]
        cd = torch.minimum(torch.clamp((xw / cell).to(torch.long),
                                       min=0), tb["nc"] - 1)
        return (cd[..., 0] * int(self.nc[1]) + cd[..., 1]) \
            * int(self.nc[2]) + cd[..., 2]

    def sorted_frame(self, xw, box=None):
        """The cell table in the sorted frame, for (..., n, 3) wrapped
        coordinates (in the box ``box``, as ``geometry``).  Returns
        ``(order, table, pos, overflow)``:

        - ``order`` (..., n): original index of the k-th atom after a
          stable sort by cell id;
        - ``table`` (..., ncells, C): sorted-frame index of each cell's
          atoms (start[c] + slot; sentinel n);
        - ``pos`` (..., n): flat (cell, slot) position of sorted atom k
          (ncells * C for an atom that overflowed its cell);
        - ``overflow`` (...,): atoms dropped because their cell was full.
        """
        n, C = self.natoms, self.C
        tb = self.on(xw.device)
        scid, order = torch.sort(self.cell_id(xw, box), dim=-1, stable=True)
        lead = scid.shape[:-1]
        cells = tb["cells"].expand(*lead, self.ncells).contiguous()
        start = torch.searchsorted(scid, cells, side="left")
        end = torch.searchsorted(scid, cells, side="right")
        table = start[..., None] + tb["slots"]
        table = torch.where(table < end[..., None], table, n)
        rank = tb["atoms"] - torch.searchsorted(scid, scid, side="left")
        ok = rank < C
        pos = torch.where(ok, scid * C + rank, self.ncells * C)
        return order, table, pos, torch.sum(~ok, dim=-1)

    def table(self, xw):
        """(ncells, C) original-frame atom-index table (sentinel natoms)
        and the overflow count, for (n, 3) wrapped coordinates."""
        order, table, _, dropped = self.sorted_frame(xw)
        opad = torch.cat([order, torch.full((1,), self.natoms,
                                            dtype=order.dtype,
                                            device=order.device)])
        return opad[table], dropped

    def overflow(self, x) -> int:
        """Atoms dropped by the fullest frame of ``x`` (..., 3N): must be 0
        for correct forces.  Host numpy."""
        xf = np.asarray(torch.as_tensor(x).detach().cpu().numpy()
                        ).reshape(-1, self.natoms, 3)
        worst = 0
        for xi in xf:
            occ = np.bincount(self._cell_id_np(xi), minlength=self.ncells)
            worst = max(worst, int(np.maximum(occ - self.C, 0).sum()))
        return worst


# ==========================================================================
# Pair math (the formulas of forces.nonbonded_energy, reaction field)
# ==========================================================================

def _rf_consts(sys):
    rc = sys.cutoff
    krf = (1.0 / rc ** 3) * (sys.eps_rf - 1.0) / (2.0 * sys.eps_rf + 1.0)
    crf = (1.0 / rc) * (3.0 * sys.eps_rf) / (2.0 * sys.eps_rf + 1.0)
    return rc, krf, crf


def _pair_terms(r2, qq, rmin, epsij, krf, crf):
    """Full-pair reaction-field energy and dE/d(r^2) from the squared
    distance: one rsqrt, the rest multiplies."""
    inv_r = torch.rsqrt(r2)
    inv_r2 = inv_r * inv_r
    x6 = (rmin * rmin * inv_r2) ** 3
    e_lj = epsij * (x6 * x6 - 2.0 * x6)
    g_lj = 6.0 * epsij * (x6 - x6 * x6) * inv_r2
    e_c = qq * (inv_r + krf * r2 - crf)
    g_c = qq * (-0.5 * inv_r2 * inv_r) + qq * krf
    return e_lj + e_c, g_lj + g_c


def _pair_terms_ewald(r2, qq, rmin, epsij, alpha):
    """Full-pair Ewald real-space (erfc) energy and dE/d(r^2)."""
    inv_r = torch.rsqrt(r2)
    inv_r2 = inv_r * inv_r
    x6 = (rmin * rmin * inv_r2) ** 3
    e_lj = epsij * (x6 * x6 - 2.0 * x6)
    g_lj = 6.0 * epsij * (x6 - x6 * x6) * inv_r2
    er = erfc_approx(alpha * (r2 * inv_r))
    gauss = torch.exp(-(alpha * alpha) * r2)
    e_c = qq * er * inv_r
    g_c = -qq * (0.5 * er * inv_r2 * inv_r
                 + (alpha / _SQRT_PI) * gauss * inv_r2)
    return e_lj + e_c, g_lj + g_c


def hard_excluded(oid_i, oid_j, bits_i, bits_j, far_i):
    """Hard-exclusion mask of pairs (broadcast shapes): the window bit of
    the lower-index atom, or a far-table entry of atom i.  ``far_i`` has
    the partners on its last axis."""
    dd = oid_j - oid_i
    fwd = ((dd >= 1) & (dd <= WIN)
           & (((bits_i >> torch.clamp(dd - 1, 0, 31)) & 1) == 1))
    bwd = ((dd <= -1) & (dd >= -WIN)
           & (((bits_j >> torch.clamp(-dd - 1, 0, 31)) & 1) == 1))
    return fwd | bwd | torch.any(far_i == oid_j[..., None], dim=-1)


# ==========================================================================
# The tensor sweep: energy and analytic forces of one walker
# ==========================================================================

def _sweep(sys: MDSystem, plan: NeighborPlan, x, want_force: bool,
           alpha=None, box=None):
    """Cell-blocked pair sweep over the stencil in the sorted frame, as
    the reference's: the self-cell block with an i != j mask, each (o, -o)
    offset pair once on a Newton plan with the reaction returned to the
    j-cells through the static inverse permutation.  ``x``: (natoms, 3),
    unwrapped.  ``alpha``: the Ewald real-space (erfc) Coulomb instead of
    the reaction field; LJPME adds the dispersion h-term.  ``box``: the box
    at run time.  Returns the force (natoms, 3) or the energy."""
    n = plan.natoms
    tb = plan.on(x.device)
    box = plan.box_tensor(x.device, x.dtype, box)
    rc, krf, crf = _rf_consts(sys)
    xw = x - box * torch.floor(x / box)
    order, table, pos, _ = plan.sorted_frame(xw, box)
    ljpme = sys.method == "LJPME"

    def pad_row(a, fill=0.0):
        return torch.cat([a[order], torch.full((1,) + a.shape[1:], fill,
                                               dtype=a.dtype,
                                               device=a.device)])

    xs = pad_row(xw)
    qs, rms, eps_ = (pad_row(sys.charges), pad_row(sys.rmin_half),
                     pad_row(sys.eps))
    q6s = pad_row(sys.q6) if ljpme else None
    oid = torch.cat([order, torch.full((1,), -2, dtype=order.dtype,
                                       device=x.device)])
    bits_s = pad_row(tb["bits"][:n].long(), 0)
    far_s = pad_row(tb["far"][:n].long(), -1)

    pos_i = xs[table]                                 # (ncells, C, 3)
    q_i, rm_i, ep_i = qs[table], rms[table], eps_[table]
    oid_i, bits_i, far_i = oid[table], bits_s[table], far_s[table]

    def block(tj):
        """Masked pair terms (e, g, d) of the i-blocks against ``tj``."""
        d = pos_i[:, :, None, :] - xs[tj][:, None, :, :]
        d = d - box * torch.round(d / box)            # minimum image
        r2 = torch.sum(d * d, dim=-1) + 1e-12
        excluded = hard_excluded(oid_i[:, :, None], oid[tj][:, None, :],
                                 bits_i[:, :, None], bits_s[tj][:, None, :],
                                 far_i[:, :, None, :])
        maskb = ((r2 < rc * rc)
                 & (table[:, :, None] != tj[:, None, :]) & ~excluded
                 & (tj[:, None, :] < n) & (table[:, :, None] < n))
        r2s = torch.where(maskb, r2, 1.0)
        qq = COULOMB * q_i[:, :, None] * qs[tj][:, None, :]
        rmin = rm_i[:, :, None] + rms[tj][:, None, :]
        epsij = torch.sqrt(ep_i[:, :, None] * eps_[tj][:, None, :])
        if alpha is None:
            e, g = _pair_terms(r2s, qq, rmin, epsij, krf, crf)
        else:
            e, g = _pair_terms_ewald(r2s, qq, rmin, epsij, alpha)
        if ljpme:
            # the real-space dispersion h-term (md/ewald.py)
            c6 = q6s[table][:, :, None] * q6s[tj][:, None, :]
            h, dh = ljpme_hker_grad(r2s, sys.ljpme_beta)
            e = e + c6 * h
            g = g + c6 * dh
        mask = maskb.to(x.dtype)
        return e * mask, g * mask, d

    if want_force:
        _, g0, d0 = block(table)                      # self cell
        acc = torch.sum((-2.0 * g0)[..., None] * d0, dim=2)
        for s in range(plan.S):
            tj = table[tb["stencil"][:, s]]
            _, g, d = block(tj)
            gd = (-2.0 * g)[..., None] * d
            acc = acc + torch.sum(gd, dim=2)          # force on the i-block
            if plan.newton:
                # reaction on the j-block, gathered back to its cell
                fj = -torch.sum(gd, dim=1)
                acc = acc + fj[tb["stencil_inv"][:, s]]
        # an atom dropped by a full cell (pos = ncells * C) gets no force
        acc = torch.cat([acc.reshape(-1, 3), acc.new_zeros(1, 3)])
        return acc[pos][torch.argsort(order)]

    e = 0.5 * torch.sum(block(table)[0])
    wcross = 1.0 if plan.newton else 0.5
    for s in range(plan.S):
        e = e + wcross * torch.sum(block(table[tb["stencil"][:, s]])[0])
    return e


def _per_system(sys: MDSystem, key, build):
    """``build()``, cached on ``sys`` under ``key`` (a system made by
    ``dataclasses.replace`` starts without the cache)."""
    cache = sys.__dict__.setdefault("_neighbor_cache", {})
    if key not in cache:
        cache[key] = build()
    return cache[key]


def _sum_table(sys: MDSystem, key, index_arrays, device):
    """The table of a deterministic per-atom sum: the atoms that receive
    contributions (A,), and (A, K) the positions of each atom's
    contributions in the concatenation of ``index_arrays``, padded with
    its length (a zero row)."""
    def build():
        idx = np.concatenate([a.detach().cpu().numpy() for a in index_arrays])
        order = np.argsort(idx, kind="stable")
        atoms, start, count = np.unique(idx[order], return_index=True,
                                        return_counts=True)
        k = np.arange(count.max() if len(count) else 0)
        table = np.where(k < count[:, None], start[:, None] + k, len(idx))
        table = np.append(order, len(idx))[table]
        return (torch.as_tensor(atoms, device=device),
                torch.as_tensor(table, device=device))
    return _per_system(sys, (key, str(torch.device(device))), build)


def _sum_into(x, atoms, table, vals):
    """Forces (B, n, 3) from contributions ``vals`` (B, M, 3) summed per
    atom through ``_sum_table``'s table, in a fixed order: the same bits
    for the same input on the card too (``index_add_`` there adds with
    atomics, in an order that changes from call to call)."""
    vals = torch.cat([vals, vals.new_zeros(vals.shape[0], 1, 3)], dim=1)
    f = torch.zeros_like(x)
    f[:, atoms] = vals[:, table].sum(dim=2)
    return f


def _exception_terms(sys: MDSystem, x, want_force: bool, box=None):
    """Sparse exception corrections for (B, n, 3) walkers: subtract the
    full-pair term the sweep added and add the target scaled straight
    Coulomb + LJ.  Hard (1-2/1-3) exclusions are masked inside the sweep;
    with the reaction field they contribute nothing here, so only the soft
    (1-4) pairs are computed.  Under Ewald every exception pair also takes
    out qq erf(alpha r) / r, its share of the reciprocal sum; under LJPME a
    hard pair within the cutoff adds the h-term the sweep masked (the
    k-space sum holds it).  ``box``: the box (a tensor on the walkers'
    device or three numbers), else the system's.  Returns (B, n, 3) forces
    or (B,) energies."""
    from .ewald import _box_tensor
    ewald = sys.method in EWALD
    rows = _per_system(sys, ("exceptions", ewald, str(x.device)),
                       lambda: torch.nonzero(
                           (sys.excl_qq > 0) | (sys.excl_lj > 0) | ewald
                       )[:, 0].to(x.device))
    if rows.shape[0] == 0:
        return (torch.zeros_like(x) if want_force
                else torch.zeros(x.shape[0], dtype=x.dtype, device=x.device))
    box = _box_tensor(sys, box, x.device, x.dtype)
    rc, krf, crf = _rf_consts(sys)
    i, j = sys.excl_idx[rows, 0], sys.excl_idx[rows, 1]
    eqq, elj = sys.excl_qq[rows], sys.excl_lj[rows]
    d = x[:, i] - x[:, j]
    d = d - box * torch.round(d / box)
    r2 = torch.sum(d * d, dim=-1) + 1e-12
    inv_r2 = 1.0 / r2
    r = torch.sqrt(r2)
    inv_r = 1.0 / r
    qq = COULOMB * sys.charges[i] * sys.charges[j]
    rmin = sys.rmin_half[i] + sys.rmin_half[j]
    epsij = torch.sqrt(sys.eps[i] * sys.eps[j])
    x6 = (rmin * rmin * inv_r2) ** 3
    e_lj = epsij * (x6 * x6 - 2.0 * x6)
    g_lj = 6.0 * epsij * (x6 - x6 * x6) * inv_r2
    within = (r < rc).to(x.dtype)
    if ewald:
        # per pair: + eqq qq / r (the 1-4 Coulomb), - qq erf(a r) / r (the
        # reciprocal part), - the sweep's erfc pair (soft pairs in range),
        # + the 1-4 LJ less the sweep's cut LJ
        al = sys.ewald_alpha
        soft = ((eqq > 0) | (elj > 0)).to(x.dtype)
        erf_ar = torch.special.erf(al * r)
        erfc_ar = 1.0 - erf_ar
        cut = soft * within
        if sys.method == "LJPME":
            h, dh = ljpme_hker_grad(r2, sys.ljpme_beta)
            c6 = (1.0 - soft) * within * sys.q6[i] * sys.q6[j]
        if not want_force:
            e = (qq * (eqq - erf_ar - cut * erfc_ar) * inv_r
                 + soft * (elj - within) * e_lj)
            if sys.method == "LJPME":
                e = e + c6 * h
            return torch.sum(e, dim=-1)
        two_a = 2.0 * al / _SQRT_PI * torch.exp(-(al * r) ** 2) * inv_r
        dEdr = qq * (-eqq * inv_r2 - two_a + erf_ar * inv_r2
                     + cut * (two_a + erfc_ar * inv_r2))
        g = 0.5 * dEdr * inv_r + soft * (elj - within) * g_lj
        if sys.method == "LJPME":
            g = g + c6 * dh
    else:
        e_full, g_full = _pair_terms(r2, qq, rmin, epsij, krf, crf)
        if not want_force:
            e = eqq * qq * inv_r + elj * e_lj - within * e_full
            return torch.sum(e, dim=-1)
        g = (eqq * qq * (-0.5 * inv_r2 * inv_r) + elj * g_lj
             - within * g_full)
    gd = (-2.0 * g)[..., None] * d
    atoms, table = _sum_table(sys, ("exceptions", ewald), (i, j), x.device)
    return _sum_into(x, atoms, table, torch.cat([gd, -gd], dim=1))


def _ewald_terms(sys: MDSystem, x, want_force: bool, box=None):
    """The reciprocal sums of (B, n, 3) walkers under Ewald (and LJPME's
    dispersion): forces, or the energies with the self and k = 0 terms;
    zeros for other methods.  ``box``: the box at run time."""
    if sys.method not in EWALD:
        return (torch.zeros_like(x) if want_force
                else torch.zeros(x.shape[0], dtype=x.dtype, device=x.device))
    kv, cf = ((sys.ewald_kvecs, sys.ewald_coefs) if box is None
              else ewald_tables_for_box(sys, box))
    tables = [(kv, cf, sys.charges)]
    if sys.method == "LJPME":
        kv6, cf6 = ((kv, sys.ljpme_coefs) if box is None
                    else ljpme_tables_for_box(sys, box))
        tables.append((kv6, cf6, sys.q6))
    if want_force:
        # one evaluation of the phases for both sums (the same k-vectors)
        return ewald_recip_forces(kv, [(c, q) for _, c, q in tables], x)
    e = (sum(ewald_recip_energy(k, c, q, x) for k, c, q in tables)
         + ewald_self_energy(sys.ewald_alpha, sys.charges))
    if sys.method == "LJPME":
        e = e + ljpme_const_energy(sys, box)
    return e


def _alpha(sys: MDSystem):
    """The sweep's Ewald splitting parameter, None for the reaction
    field."""
    return sys.ewald_alpha if sys.method in EWALD else None


def _beta(sys: MDSystem):
    """The sweep's dispersion splitting parameter under LJPME, else
    None."""
    return sys.ljpme_beta if sys.method == "LJPME" else None


def default_plan(sys, x):
    """Plan for an ad-hoc call, its capacity from the first walker of
    ``x`` (..., 3N)."""
    x0 = torch.as_tensor(x).detach().cpu().numpy().reshape(-1, 3)
    return NeighborPlan(sys, x0=x0[:sys.natoms])


def neighbor_nonbonded_energy(sys: MDSystem, x, plan: NeighborPlan = None,
                              box=None):
    """O(n) nonbonded energy of one walker ``x`` (natoms, 3); equals
    ``forces.nonbonded_energy`` on periodic systems (reaction field,
    Ewald / PME or LJPME).  ``box``: the box at run time (build the plan
    with a ``box_slack`` that covers its shrink)."""
    plan = plan or default_plan(sys, x)
    return (_sweep(sys, plan, x, False, _alpha(sys), box)
            + _exception_terms(sys, x[None], False, box)[0]
            + _ewald_terms(sys, x[None], False, box)[0])


def neighbor_nonbonded_force(sys: MDSystem, x, plan: NeighborPlan = None,
                             box=None):
    """O(n) analytic nonbonded forces of one walker (natoms, 3)."""
    plan = plan or default_plan(sys, x)
    return (_sweep(sys, plan, x, True, _alpha(sys), box)
            + _exception_terms(sys, x[None], True, box)[0]
            + _ewald_terms(sys, x[None], True, box)[0])


# ==========================================================================
# Sparse bonded terms: analytic forces by gathers and index_add_
# ==========================================================================

def bonded_force_sparse(sys: MDSystem, x):
    """Analytic bond, angle, torsion and CMAP forces of (B, n, 3) walkers,
    summed per atom in a fixed order (``_sum_into``)."""
    from .cmap import cmap_force_terms, has_cmap
    idx, vals = [], []
    if sys.bond_idx.shape[0]:
        i, j = sys.bond_idx[:, 0], sys.bond_idx[:, 1]
        d = x[:, i] - x[:, j]
        r = torch.sqrt(torch.sum(d * d, dim=-1) + 1e-16)
        g = (2.0 * sys.bond_k * (r - sys.bond_r0) / r)[..., None] * d
        idx += [i, j]
        vals += [-g, g]
    if sys.angle_idx.shape[0]:
        a, b, c = sys.angle_idx.unbind(1)
        u = x[:, a] - x[:, b]
        v = x[:, c] - x[:, b]
        uu = torch.sum(u * u, dim=-1) + 1e-16
        vv = torch.sum(v * v, dim=-1) + 1e-16
        uv = torch.sum(u * v, dim=-1)
        inv_norm = torch.rsqrt(uu * vv)
        cos_t = torch.clamp(uv * inv_norm, -1.0 + 1e-7, 1.0 - 1e-7)
        sin_t = torch.sqrt(1.0 - cos_t * cos_t)
        theta = torch.atan2(sin_t, cos_t)
        coef = -2.0 * sys.angle_k * (theta - sys.angle_t0) / sin_t
        cu = (coef * inv_norm)[..., None]
        cuu = (coef * cos_t / uu)[..., None]
        cvv = (coef * cos_t / vv)[..., None]
        gu = cu * v - cuu * u
        gv = cu * u - cvv * v
        idx += [a, c, b]
        vals += [-gu, -gv, gu + gv]
    if sys.dih_idx.shape[0]:
        phi, forces = torsions(x, *sys.dih_idx.unbind(1))
        dEdphi = -sys.dih_pk * sys.dih_n * torch.sin(
            sys.dih_n * phi - sys.dih_phase)
        i_, v_ = forces(dEdphi)
        idx += i_
        vals += v_
    if has_cmap(sys):
        i_, v_ = cmap_force_terms(sys, x)
        idx += i_
        vals += v_
    if not idx:
        return torch.zeros_like(x)
    atoms, table = _sum_table(sys, "bonded", idx, x.device)
    return _sum_into(x, atoms, table, torch.cat(vals, dim=1))


def strip_rigid_water_bonded(sys: MDSystem, triplets) -> MDSystem:
    """Drop the bond and angle terms that lie inside rigid waters: the
    constraints replace them (as OpenMM's ``rigidWater=True``)."""
    wat = set(int(i) for t in np.asarray(triplets) for i in t)
    bi = sys.bond_idx.cpu().numpy()
    ai = sys.angle_idx.cpu().numpy()
    keep_b = torch.as_tensor(
        [not (int(a) in wat and int(b) in wat) for a, b in bi], dtype=bool)
    keep_a = torch.as_tensor(
        [not all(int(v) in wat for v in row) for row in ai], dtype=bool)
    kb = keep_b.to(sys.bond_idx.device)
    ka = keep_a.to(sys.angle_idx.device)
    return dataclasses.replace(
        sys, bond_idx=sys.bond_idx[kb], bond_k=sys.bond_k[kb],
        bond_r0=sys.bond_r0[kb], angle_idx=sys.angle_idx[ka],
        angle_k=sys.angle_k[ka], angle_t0=sys.angle_t0[ka])


# ==========================================================================
# Whole-system entry points
# ==========================================================================

def potential_energy_neighbor(sys: MDSystem, x, plan: NeighborPlan = None,
                              box=None):
    """Total potential of one walker ``x`` (natoms, 3); ``box``: the box
    at run time."""
    return (bonded_energy(sys, x[None])[0]
            + neighbor_nonbonded_energy(sys, x, plan, box)
            + dispersion_correction_energy(sys, box))


def force_neighbor(sys: MDSystem, x, plan: NeighborPlan = None, box=None):
    """Total analytic force of one walker ``x`` (natoms, 3) through the
    tensor sweep."""
    return (bonded_force_sparse(sys, x[None])[0]
            + neighbor_nonbonded_force(sys, x, plan, box))


def tensor_sweep(sys: MDSystem, plan: NeighborPlan, xb, alpha=None,
                 beta=None, box=None):
    """The tensor sweep's forces (B, 3N) -> (B, 3N), walker by walker
    (``_sweep``, in the walkers' dtype): the sweep of a float64
    simulation, whose walkers take no kernel, as the reference's XLA
    sweep runs in the system's dtype.  ``beta`` is the system's own
    under LJPME."""
    n = sys.natoms
    return torch.stack([_sweep(sys, plan, x.reshape(n, 3), True, alpha,
                               box).reshape(-1) for x in xb])


def force_flat_neighbor(sys: MDSystem, xflat, plan: NeighborPlan = None,
                        sweep=None, box=None):
    """Batched flat-coordinate forces (..., 3N) -> (..., 3N): the pair
    sweep in ``neighbor_kernel.neighbor_sweep`` (kernel E on the card, the
    erfc real space under Ewald, the dispersion term under LJPME;
    ``sweep`` replaces it, e.g. by its plain version), plus the exception
    corrections, the reciprocal forces under Ewald and the bonded terms.
    ``box``: the box at run time (three numbers or a tensor, read to the
    host once a call for the kernel's launch)."""
    if sweep is None:
        from .neighbor_kernel import neighbor_sweep as sweep
    shape = xflat.shape
    xb = xflat.reshape(-1, 3 * sys.natoms)
    if plan is None:
        plan = default_plan(sys, xb)
    x3 = xb.reshape(xb.shape[0], sys.natoms, 3)
    if box is not None:
        box = box_np(box)
    bt = plan.box_tensor(xb.device, xb.dtype, box)
    f = (sweep(sys, plan, xb, _alpha(sys), _beta(sys), box=box
               ).reshape(x3.shape)
         + _exception_terms(sys, x3, True, bt)
         + _ewald_terms(sys, x3, True, None if box is None else bt)
         + bonded_force_sparse(sys, x3))
    return f.reshape(shape)
