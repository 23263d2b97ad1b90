"""Virtual interaction sites (massless particles): the TIP4P-Ew M point
and the sites of serialized OpenMM systems.

Counterpart of ``isokann_tpu/md/vsites.py``.  A site sits at a weighted
average of up to three parent atoms (OpenMM's Two- / ThreeParticleAverage
sites), optionally with an out-of-plane cross term (``OutOfPlaneSite``):

    x_v = w1 x1 + w2 x2 + w3 x3 + wc (x2 - x1) x (x3 - x1)

- Placement is one gather for all atoms: atom i has parents
  ``vs_gather[i]`` and weights ``vs_w[i]``, the identity ``(i, i, i), (1,
  0, 0)`` for a real atom.
- Force redistribution is the transpose, again by gathers: atom i owns the
  sites ``vs_rev[i, k]`` with weights ``vs_rev_w[i, k]`` (padded with
  itself at weight 0), so F_real[i] = F[i] (1 - is_site[i]) + sum_k
  w_rev[i, k] F[rev[i, k]].  For average sites the placement is linear
  and this is the exact chain rule; out-of-plane sites add the
  coordinate-dependent cross terms.  No scatter: the same input gives the
  same bits on the card.

How the integrators use it (``simulators/mdsim.py``): a site's mass is
replaced by 1e30 amu in the integrator masses, so it stays where it is;
every force evaluation places the sites from their parents first and
hands their forces back, and every output frame is placed.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def has_vsites(sys) -> bool:
    vi = getattr(sys, "vs_idx", None)
    return vi is not None and vi.shape[0] > 0


def _has_oop(sys) -> bool:
    wc = getattr(sys, "vs_wc", None)
    return wc is not None and wc.shape[0] > 0


def attach_vsites(system, vs_idx, vs_parents, vs_weights, vs_cross=None):
    """A copy of ``system`` with virtual sites.

    - ``vs_idx`` (nv,): the site atoms (their masses are set to 0)
    - ``vs_parents`` (nv, <= 3): parent atom indices
    - ``vs_weights`` (nv, same): weights summing to 1 (out-of-plane sites:
      (1 - w12 - w13, w12, w13))
    - ``vs_cross`` (nv,) optional: out-of-plane cross weights [1/nm]

    A site may not parent another site (raises), as in the reference."""
    vs_idx = np.asarray(vs_idx, np.int64).reshape(-1)
    nv = len(vs_idx)
    vs_parents = np.asarray(vs_parents, np.int64).reshape(nv, -1)
    vs_weights = np.asarray(vs_weights, np.float64).reshape(nv, -1)
    n = int(system.masses.shape[0])
    cross = (np.zeros(nv) if vs_cross is None
             else np.asarray(vs_cross, np.float64).reshape(-1))
    if vs_parents.shape[1] > 3:
        raise ValueError("at most 3 parents per average site")
    if np.isin(vs_parents, vs_idx).any():
        raise ValueError("virtual sites parenting other sites are not "
                         "supported")
    if (cross != 0.0).any() and vs_parents.shape[1] != 3:
        raise ValueError("out-of-plane sites need 3 parents")
    pad = 3 - vs_parents.shape[1]
    if pad:
        vs_parents = np.concatenate(
            [vs_parents, np.repeat(vs_parents[:, :1], pad, axis=1)], axis=1)
        vs_weights = np.concatenate([vs_weights, np.zeros((nv, pad))],
                                    axis=1)
    if not np.allclose(vs_weights.sum(axis=1), 1.0, atol=1e-6):
        raise ValueError("site weights must sum to 1 "
                         "(out-of-plane: pass 1 - w12 - w13 first)")

    gather = np.tile(np.arange(n, dtype=np.int64)[:, None], (1, 3))
    w = np.zeros((n, 3))
    w[:, 0] = 1.0
    gather[vs_idx] = vs_parents
    w[vs_idx] = vs_weights
    has_oop = bool((cross != 0.0).any())
    wc = np.zeros(n)
    if has_oop:
        wc[vs_idx] = cross

    owned = [[] for _ in range(n)]
    for s, (ps, ws) in enumerate(zip(vs_parents, vs_weights)):
        if has_oop and cross[s] != 0.0:
            # distinct slots: the cross-term transpose needs the parent
            # position of each reverse entry
            for slot, (p, wt) in enumerate(zip(ps, ws), start=1):
                owned[int(p)].append((int(vs_idx[s]), float(wt), slot))
            continue
        seen = {}
        for p, wt in zip(ps, ws):
            seen[int(p)] = seen.get(int(p), 0.0) + float(wt)
        for p, wt in seen.items():
            if wt != 0.0:
                owned[p].append((int(vs_idx[s]), wt, 0))
    kmax = max(1, max((len(o) for o in owned), default=0))
    rev = np.tile(np.arange(n, dtype=np.int64)[:, None], (1, kmax))
    rev_w = np.zeros((n, kmax))
    rev_slot = np.zeros((n, kmax), np.int64)
    for i, o in enumerate(owned):
        for k, (s, wt, slot) in enumerate(o):
            rev[i, k] = s
            rev_w[i, k] = wt
            rev_slot[i, k] = slot

    masses = system.masses.detach().cpu().numpy().astype(np.float64)
    masses[vs_idx] = 0.0
    dev, fdt = system.charges.device, system.charges.dtype

    def t(a, dtype=fdt):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    return dataclasses.replace(
        system, masses=t(masses), vs_idx=t(vs_idx, torch.int64),
        vs_gather=t(gather, torch.int64), vs_w=t(w),
        vs_rev=t(rev, torch.int64), vs_rev_w=t(rev_w),
        vs_wc=t(wc if has_oop else np.zeros(0)),
        vs_rev_slot=t(rev_slot if has_oop else np.zeros((0, 0)),
                      torch.int64))


def place_vsites(sys, x):
    """Site rows recomputed from their parents; x: (..., n, 3)."""
    if not has_vsites(sys):
        return x
    g = sys.vs_gather
    w = sys.vs_w.to(x.dtype)
    x1, x2, x3 = x[..., g[:, 0], :], x[..., g[:, 1], :], x[..., g[:, 2], :]
    out = w[:, 0, None] * x1 + w[:, 1, None] * x2 + w[:, 2, None] * x3
    if _has_oop(sys):
        # identity rows have x1 == x2 == x3: no cross term
        out = out + sys.vs_wc.to(x.dtype)[:, None] * torch.cross(
            x2 - x1, x3 - x1, dim=-1)
    return out


def place_vsites_flat(sys, xflat):
    """``place_vsites`` on flat coordinates (..., 3N)."""
    if not has_vsites(sys):
        return xflat
    shape = xflat.shape
    return place_vsites(sys, xflat.reshape(shape[:-1] + (-1, 3))
                        ).reshape(shape)


def redistribute_forces(sys, f, x=None):
    """J^T f of the placement; f: (..., n, 3).  Site rows of the result
    are zero.  Out-of-plane sites need the parent coordinates ``x``
    (placed or not) for their cross terms:

        F1 += (1-w12-w13) Fv - wc (d13 x Fv) - wc (Fv x d12)
        F2 += w12 Fv + wc (d13 x Fv)
        F3 += w13 Fv + wc (Fv x d12)
    """
    if not has_vsites(sys):
        return f
    rev = sys.vs_rev
    rw = sys.vs_rev_w.to(f.dtype)
    n = f.shape[-2]
    # real atoms are the identity rows of the gather (no site parents
    # itself)
    keep = (sys.vs_gather[:, 0] == torch.arange(n, device=f.device)
            ).to(f.dtype)
    out = f * keep[:, None]
    oop = _has_oop(sys)
    if oop and x is None:
        raise ValueError("out-of-plane sites: redistribute_forces needs "
                         "the coordinates")
    if oop:
        g = sys.vs_gather
        wc = sys.vs_wc.to(f.dtype)
        x1 = x[..., g[:, 0], :]
        d12_all = x[..., g[:, 1], :] - x1
        d13_all = x[..., g[:, 2], :] - x1
    for k in range(rev.shape[1]):
        s = rev[:, k]
        Fv = f[..., s, :]
        out = out + rw[:, k, None] * Fv
        if oop:
            slot = sys.vs_rev_slot[:, k][:, None]
            c2 = torch.cross(d13_all[..., s, :].expand_as(Fv), Fv, dim=-1)
            c3 = torch.cross(Fv, d12_all[..., s, :].expand_as(Fv), dim=-1)
            term = torch.where(slot == 1, -(c2 + c3),
                               torch.where(slot == 2, c2,
                                           torch.where(slot == 3, c3, 0.0)))
            out = out + wc[s][:, None] * term
    return out


def redistribute_forces_flat(sys, fflat, xflat=None):
    """``redistribute_forces`` on flat (..., 3N) forces and coordinates."""
    if not has_vsites(sys):
        return fflat
    shape = fflat.shape
    x = None if xflat is None else xflat.reshape(shape[:-1] + (-1, 3))
    return redistribute_forces(sys, fflat.reshape(shape[:-1] + (-1, 3)),
                               x).reshape(shape)
