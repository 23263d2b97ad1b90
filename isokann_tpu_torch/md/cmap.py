"""CMAP torsion-torsion correction maps (ff19SB / CHARMM class).

Counterpart of ``isokann_tpu/md/cmap.py``.  E = M_t(phi, psi): a periodic
bicubic surface over two coupled torsions, on top of the periodic
torsions.  The patches are computed on the host in float64
(``bicubic_coefs``) from the grid values with periodic centred-difference
derivatives (the CHARMM / Amber construction: C1, exact at the grid
points).  The terms are few (one per residue): the angles come from
coordinate gathers, the energy from a gather of the coefficient table.
Forces are analytic: dE/dphi and dE/dpsi from the patch polynomial times
the torsion gradient of ``forces.torsions``, summed per atom in a fixed
order.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .forces import torsions


def has_cmap(sys) -> bool:
    ci = getattr(sys, "cmap_idx", None)
    return ci is not None and ci.shape[0] > 0


# inverse bicubic basis: E(u, v) = sum_mn c[m, n] u^m v^n with c = M F M^T,
# F the 4x4 block of (values, d/du, d/dv, d2/dudv) at the patch corners,
# derivatives in cell units
_M = np.array([[1.0, 0.0, 0.0, 0.0],
               [0.0, 0.0, 1.0, 0.0],
               [-3.0, 3.0, -2.0, -1.0],
               [2.0, -2.0, 1.0, 1.0]])


def bicubic_coefs(grid):
    """(R, R) periodic grid of energies -> (R, R, 4, 4) patch coefficients
    (float64): derivatives by periodic centred differences in cell units,
    df/du = (f[i+1] - f[i-1]) / 2."""
    f = np.asarray(grid, np.float64)
    R = f.shape[0]
    if f.shape != (R, R):
        raise ValueError("CMAP grid must be square")

    def up(a, axis):
        return np.roll(a, -1, axis=axis)

    fu = (up(f, 0) - np.roll(f, 1, axis=0)) / 2.0
    fv = (up(f, 1) - np.roll(f, 1, axis=1)) / 2.0
    fuv = (up(fu, 1) - np.roll(fu, 1, axis=1)) / 2.0
    F = np.empty((R, R, 4, 4))
    # row a: (value, d/du) at u = 0 / 1; column b: (value, d/dv) at v = 0 / 1
    for a, (g, gv) in enumerate(((f, fv), (up(f, 0), up(fv, 0)),
                                 (fu, fuv), (up(fu, 0), up(fuv, 0)))):
        F[..., a, 0], F[..., a, 1] = g, up(g, 1)
        F[..., a, 2], F[..., a, 3] = gv, up(gv, 1)
    return np.einsum("ab,ijbc,dc->ijad", _M, F, _M)


def _patches(sys, phi, psi):
    """Patch coefficients (B, nc, 4, 4) and cell coordinates u, v (B, nc)
    of the angles."""
    coefs = sys.cmap_coefs
    nt, R = coefs.shape[0], coefs.shape[1]
    h = 2.0 * math.pi / R
    su = (phi + math.pi) / h
    sv = (psi + math.pi) / h
    iu = torch.clamp(torch.floor(su), 0, R - 1).long() % R
    iv = torch.clamp(torch.floor(sv), 0, R - 1).long() % R
    flat = coefs.reshape(nt * R * R, 4, 4)
    c = flat[sys.cmap_type * (R * R) + iu * R + iv]
    return c, su - iu, sv - iv, h


def _powers(u):
    one = torch.ones_like(u)
    return torch.stack([one, u, u * u, u * u * u], dim=-1)


def _angles(sys, x):
    ci = sys.cmap_idx
    phi, fphi = torsions(x, *ci[:, 0:4].unbind(1))
    psi, fpsi = torsions(x, *ci[:, 4:8].unbind(1))
    return phi, psi, fphi, fpsi


def cmap_energy(sys, x):
    """Total CMAP energy of walkers x (B, n, 3) -> (B,)."""
    if not has_cmap(sys):
        return torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
    phi, psi, _, _ = _angles(sys, x)
    c, u, v, _ = _patches(sys, phi, psi)
    e = _powers(u)[..., :, None] * c * _powers(v)[..., None, :]
    return e.sum(dim=(-1, -2, -3))


def cmap_force_terms(sys, x):
    """The CMAP forces of walkers x (B, n, 3) as per-term contributions:
    (atom index tensors, (B, m, 3) force values), for a per-atom sum."""
    if not has_cmap(sys):
        return [], []
    phi, psi, fphi, fpsi = _angles(sys, x)
    c, u, v, h = _patches(sys, phi, psi)
    zero = torch.zeros_like(u)
    du = torch.stack([zero, torch.ones_like(u), 2.0 * u, 3.0 * u * u], -1)
    dv = torch.stack([zero, torch.ones_like(v), 2.0 * v, 3.0 * v * v], -1)
    up, vp = _powers(u), _powers(v)
    dEdphi = (du[..., :, None] * c * vp[..., None, :]).sum((-1, -2)) / h
    dEdpsi = (up[..., :, None] * c * dv[..., None, :]).sum((-1, -2)) / h
    i1, v1 = fphi(dEdphi)
    i2, v2 = fpsi(dEdpsi)
    return i1 + i2, v1 + v2


def cmap_force(sys, x):
    """Analytic CMAP forces of walkers x (B, n, 3) -> (B, n, 3), summed
    per atom in a fixed order."""
    if not has_cmap(sys):
        return torch.zeros_like(x)
    from .neighbor import _sum_into, _sum_table
    idx, vals = cmap_force_terms(sys, x)
    atoms, table = _sum_table(sys, "cmap", idx, x.device)
    return _sum_into(x, atoms, table, torch.cat(vals, dim=1))
