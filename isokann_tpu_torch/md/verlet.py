"""Verlet-list neighbor mode: per-atom pair lists reused across steps.

Counterpart of ``isokann_tpu/md/verlet.py``, the reference's alternative
to the per-step cell sweep:

- every ``rebuild_every`` steps (sooner where an atom has moved skin/2),
  per-atom lists of the partners within ``cutoff + skin`` are built from
  a cell grid at that radius (sorts, gathers, and compactions by each
  candidate's rank among the kept ones: first the candidates within
  range, then those no hard exclusion masks);
- in between, forces are one (B, n, K) gather and elementwise pair math
  summed over K.  Every directed pair is in its owner's row, so there is
  no Newton bookkeeping; hard (1-2/1-3) exclusions are dropped at build
  time, 1-4 pairs stay full pairs and are corrected by the shared
  ``_exception_terms``, as in the sweep.

A list at radius cutoff + skin stays exact while every atom has moved
less than skin/2 since its build.  ``langevin_middle_verlet`` rebuilds
at the reference's interval and also whenever an atom reaches skin/2
(the reference's interval assumes 0.02 nm a step, which the fastest
atoms of a solvated box exceed); it returns the largest displacement
from a build at a force evaluation (``max_disp``), the list overflow
(``n_over``, must be 0) and the number of builds.  The reference
has no TPU kernel here; this is plain PyTorch on every device (the
counterpart of its XLA path).  The reference's walker and step chunks
(``ISOKANN_VERLET_*``, v5e program limits) have no counterpart: one loop
of rebuild blocks.
"""

from __future__ import annotations

import math
import warnings

import numpy as np
import torch

from . import integrators as I
from .neighbor import (NeighborPlan, _alpha, _beta, _exception_terms,
                       _ewald_terms, _pair_terms, _pair_terms_ewald,
                       _rf_consts, bonded_force_sparse)
from .system import COULOMB, EWALD, MDSystem


class VerletPlan:
    """Static data of the list builds: a cell grid at ``cutoff + skin`` and
    the per-atom capacity ``K`` (``margin`` times the densest observed
    neighbour count of ``x0``, or a uniform-density estimate, rounded up to
    a multiple of 128).  A build that finds more neighbours than K
    reports them (``n_over``): regrow K, as the cell plan's capacity."""

    def __init__(self, sys: MDSystem, x0=None, skin: float = 0.2,
                 K: int = None, margin: float = 1.3,
                 rebuild_every: int = None):
        self.skin = float(skin)
        # the minimum-image invariant bounds the radius by min(box)/2; in a
        # small box the skin is clamped
        max_skin = float(np.min(np.asarray(sys.box))) / 2 - float(sys.cutoff)
        if max_skin <= 0:
            raise ValueError(
                f"verlet lists need cutoff < min(box)/2 "
                f"(cutoff={sys.cutoff}, box={tuple(np.asarray(sys.box))})")
        if self.skin >= max_skin:
            clamped = 0.9 * max_skin
            warnings.warn(
                f"verlet skin {self.skin:.3f} nm exceeds the minimum-image "
                f"bound for this box; clamped to {clamped:.3f} nm")
            self.skin = clamped
        self.rv = float(sys.cutoff) + self.skin
        if x0 is not None:
            x0 = torch.as_tensor(x0).detach().cpu().numpy().reshape(-1, 3)
        self.plan = NeighborPlan(sys, x0=x0, cutoff=self.rv)
        self.natoms = int(sys.natoms)
        p = self.plan
        # the candidate cells of each cell: itself and both directions
        cells = np.arange(p.ncells)[:, None]
        self.cand_cells = (np.concatenate([cells, p.stencil, p.stencil_inv],
                                          axis=1) if p.newton else
                           np.concatenate([cells, p.stencil], axis=1))
        self.M = self.cand_cells.shape[1] * p.C      # candidates an atom
        if K is None:
            if x0 is not None:
                K = int(margin * self._max_true_neighbors(
                    x0, sys.charges.device))
            else:
                dens = self.natoms / float(np.prod(p.box))
                K = int(margin * dens * 4.0 / 3.0 * math.pi * self.rv ** 3)
        self.K = max(8, ((int(K) + 127) // 128) * 128)
        # the reference's interval: skin/2 of headroom over 0.02 nm a step
        # (``langevin_middle_verlet`` rebuilds sooner for a faster atom)
        self.rebuild_every = int(rebuild_every or
                                 max(1, int(self.skin / 2 / 0.02)))
        self._dev = {}

    def _max_true_neighbors(self, x0, device):
        """The most partners within ``rv`` of any atom of ``x0`` (a sample
        of 4096 atoms above that size), in float64 on ``device``."""
        box = torch.as_tensor(self.plan.box, device=device)
        x = torch.as_tensor(x0, dtype=torch.float64, device=device)
        xw = x - box * torch.floor(x / box)
        idx = (np.arange(self.natoms) if self.natoms <= 4096 else
               np.random.default_rng(0).choice(self.natoms, 4096, False))
        worst = 0
        for k in range(0, len(idx), 256):
            d = xw[None, :, :] - xw[torch.as_tensor(idx[k:k + 256],
                                                    device=device), None, :]
            d = d - box * torch.round(d / box)
            worst = max(worst, int(((d * d).sum(-1) < self.rv ** 2)
                                   .sum(-1).max()) - 1)
        return worst

    def on(self, device) -> torch.Tensor:
        """The candidate cells (ncells, S) on ``device`` (built once per
        device)."""
        key = str(torch.device(device))
        if key not in self._dev:
            self._dev[key] = torch.as_tensor(self.cand_cells,
                                             device=device)
        return self._dev[key]


def _compact(keep, vals, width, fill):
    """The entries of ``vals`` where ``keep`` (both (..., M)), in their
    order, in the first slots of (..., width) padded with ``fill``; the
    entries past ``width`` are dropped.  Each kept entry goes to its rank
    among the kept ones of its row (every written slot distinct)."""
    rank = torch.cumsum(keep, dim=-1) - 1
    dest = torch.where(keep & (rank < width), rank, width)
    out = vals.new_full(vals.shape[:-1] + (width + 1,), fill)
    out.scatter_(-1, dest, torch.where(keep, vals, fill))
    return out[..., :width]


def build_lists(vp: VerletPlan, sys: MDSystem, xw):
    """(B, n, 3) wrapped coordinates -> (lists (B, n, K) int64 partner ids
    (sentinel n) of every directed pair within ``rv`` with the hard
    exclusions dropped, in candidate order (the reference's lists); n_over
    (B,) partners that did not fit in K, which must be 0).

    The candidates within ``rv`` are compacted first, into K + 64 + E2
    slots: an atom's hard partners (its 1-2 / 1-3 atoms, within the
    bitmask window of 32 on either side or in its far table of E2) all
    fit there beside its K first partners, so the exclusion tests run on
    those slots only and give the reference's lists.  When a row has more
    candidates within ``rv`` than that, ``n_over`` counts all the extra
    as partners: positive exactly when the reference's is, larger by at
    most the row's hard partners."""
    p, n, K = vp.plan, vp.natoms, vp.K
    tb = p.on(xw.device)
    B = xw.shape[0]
    order, table, pos, _ = p.sorted_frame(xw)
    xs = torch.gather(xw, 1, order[..., None].expand(-1, -1, 3))
    xs = torch.cat([xs, xs.new_zeros(B, 1, 3)], dim=1)
    opad = torch.cat([order, order.new_full((B, 1), n)], dim=1)
    cell_of_k = torch.clamp(pos // p.C, 0, p.ncells - 1)      # (B, n)
    # candidate slots of each sorted atom's stencil cells, (B, n, M)
    cand = vp.on(xw.device)[cell_of_k]                       # (B, n, S)
    bidx = torch.arange(B, device=xw.device)[:, None, None]
    rows = table[bidx, cand].reshape(B, n, -1)
    box = tb["box"].to(xw.dtype)
    r2 = torch.zeros(rows.shape, dtype=xw.dtype, device=xw.device)
    for c in range(3):
        dc = xs[..., c][bidx, rows] - xs[:, :n, c][..., None]
        dc = dc - box[c] * torch.round(dc / box[c])
        r2 = r2 + dc * dc
    near = ((rows < n) & (r2 < vp.rv * vp.rv)
            & (rows != torch.arange(n, device=xw.device)[:, None]))
    far_i = tb["far"][:n].long()[order]                      # (B, n, E2)
    K2 = K + 64 + far_i.shape[-1]
    rows = _compact(near, rows, K2, n)
    oid_j = opad[bidx, rows]                                 # (B, n, K2)
    oid_i = order[..., None]
    bits = tb["bits"].long()                 # (n + 1,), sentinel 0
    dd = oid_j - oid_i
    fwd = ((dd >= 1) & (dd <= 32)
           & (((bits[oid_i] >> torch.clamp(dd - 1, 0, 31)) & 1) == 1))
    bwd = ((dd <= -1) & (dd >= -32)
           & (((bits[oid_j] >> torch.clamp(-dd - 1, 0, 31)) & 1) == 1))
    excluded = fwd | bwd
    for e in range(far_i.shape[-1]):
        excluded = excluded | (far_i[..., e][..., None] == oid_j)
    valid = (rows < n) & ~excluded
    extra = torch.clamp(near.sum(dim=-1) - K2, min=0)
    n_over = torch.clamp(valid.sum(dim=-1) + extra - K, min=0).sum(dim=-1)
    lists = _compact(valid, oid_j, K, n)
    # rows belong to sorted atoms: back to the original atom order
    lists = torch.gather(lists, 1, torch.argsort(order, dim=1)[..., None]
                         .expand(-1, -1, K))
    return lists, n_over


def nonbonded_force_verlet(sys: MDSystem, x, lists):
    """(B, n, 3) coordinates + (B, n, K) lists -> (B, n, 3) full-pair
    sweep forces (the exception corrections, bonded and reciprocal terms
    are added by ``force_verlet``)."""
    n = sys.natoms
    B = x.shape[0]
    box = torch.as_tensor(sys.box, dtype=x.dtype, device=x.device)
    rc, krf, crf = _rf_consts(sys)
    xw = x - box * torch.floor(x / box)
    xpad = torch.cat([xw, xw.new_zeros(B, 1, 3)], dim=1)
    bidx = torch.arange(B, device=x.device)[:, None, None]
    ds = []
    r2 = torch.zeros(lists.shape, dtype=x.dtype, device=x.device)
    for c in range(3):
        dc = xw[..., c][..., None] - xpad[..., c][bidx, lists]
        dc = dc - box[c] * torch.round(dc / box[c])
        ds.append(dc)
        r2 = r2 + dc * dc
    r2 = r2 + 1e-12
    mask = (lists < n) & (r2 < rc * rc)
    r2s = torch.where(mask, r2, 1.0)
    zero = x.new_zeros(1)
    qpad = torch.cat([sys.charges, zero])
    rmpad = torch.cat([sys.rmin_half, zero])
    epad = torch.cat([sys.eps, zero])
    qq = COULOMB * sys.charges[:, None] * qpad[lists]
    rmin = sys.rmin_half[:, None] + rmpad[lists]
    epsij = torch.sqrt(sys.eps[:, None] * epad[lists])
    if sys.method in EWALD:
        e, g = _pair_terms_ewald(r2s, qq, rmin, epsij, _alpha(sys))
        if _beta(sys) is not None:
            from .ewald import ljpme_hker_grad
            q6pad = torch.cat([sys.q6, zero])
            _, dh = ljpme_hker_grad(r2s, _beta(sys))
            g = g + sys.q6[:, None] * q6pad[lists] * dh
    else:
        e, g = _pair_terms(r2s, qq, rmin, epsij, krf, crf)
    w = (-2.0 * g) * mask.to(x.dtype)
    return torch.stack([torch.sum(w * ds[c], dim=-1) for c in range(3)],
                       dim=-1)


def force_verlet(sys: MDSystem, x, lists):
    """Total analytic force of (B, n, 3) walkers from their Verlet
    lists."""
    return (nonbonded_force_verlet(sys, x, lists)
            + _exception_terms(sys, x, True)
            + bonded_force_sparse(sys, x)
            + _ewald_terms(sys, x, True))


def langevin_middle_verlet(sys: MDSystem, vp: VerletPlan, x0, v0, masses3,
                           T, gamma, dt, nsteps: int, gen=None,
                           rebuild_every: int = None, constraints=None,
                           wrap_force=None):
    """Batched LangevinMiddle with Verlet-list reuse; ``x0``/``v0``: (B,
    3N).  Lists are rebuilt every ``rebuild_every`` steps (default: the
    plan's, the reference's interval) and, in between, before any force
    evaluation at which an atom has moved skin/2 or more since the last
    build, so each force is exact while no list overflows.  ``wrap_force``
    (e.g. the virtual-site placement) wraps the flat force function.
    Returns ``(x, v, diag)``, ``diag`` = dict(max_disp, n_over, rebuilds):
    the largest displacement of an atom from its lists' build at a force
    evaluation (< skin/2), the largest list overflow (must be 0) and the
    number of builds."""
    R = int(rebuild_every or vp.rebuild_every)
    B = x0.shape[0]
    n = sys.natoms
    box = torch.as_tensor(vp.plan.box, dtype=x0.dtype, device=x0.device)
    # walkers a build: at most 2^28 candidates (the (B, n, M) arrays)
    chunk = max(1, (1 << 28) // (n * vp.M))
    st = dict(lists=None, xref=None, disp=x0.new_zeros(()), builds=0,
              over=torch.zeros((), dtype=torch.long, device=x0.device))

    def build(x3):
        xw = x3 - box * torch.floor(x3 / box)
        built = [build_lists(vp, sys, xw[b:b + chunk])
                 for b in range(0, B, chunk)]
        st.update(lists=torch.cat([lb[0] for lb in built]), xref=x3,
                  builds=st["builds"] + 1,
                  over=torch.maximum(st["over"], torch.cat(
                      [lb[1] for lb in built]).max()))

    def force(xf):
        x3 = xf.reshape(B, n, 3)
        if st["lists"] is None:
            build(x3)
        else:
            d = x3 - st["xref"]
            d = d - box * torch.round(d / box)
            dmax = torch.sqrt((d * d).sum(-1).max())
            if float(dmax) >= vp.skin / 2:
                build(x3)
            else:
                st["disp"] = torch.maximum(st["disp"], dmax)
        return force_verlet(sys, x3, st["lists"]).reshape(xf.shape)

    x, v = x0, v0
    left = int(nsteps)
    while left > 0:
        k = min(R, left)
        st["lists"] = None
        x, v = I.langevin_middle(force if wrap_force is None
                                 else wrap_force(force), x, v, masses3, T,
                                 gamma, dt, k, gen, constraints)
        left -= k
    return x, v, dict(max_disp=st["disp"], n_over=st["over"],
                      rebuilds=st["builds"])
