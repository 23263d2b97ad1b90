"""Batched force-field energies in PyTorch; forces by autograd.

Counterpart of ``isokann_tpu/md/forces.py`` for the NoCutoff and
reaction-field (CutoffNonPeriodic / CutoffPeriodic) methods.  Energies in
kJ/mol; coordinates (..., natoms, 3) in nm; every term sums over the last
two axes so batches need no vmap.
"""

from __future__ import annotations

import math

import torch

from .system import COULOMB, MDSystem


def _rows(x, idx):
    """x: (B, n, 3), idx: (m,) -> (B, m, 3)."""
    return x[:, idx, :]


def bond_energy(sys: MDSystem, x):
    d = _rows(x, sys.bond_idx[:, 0]) - _rows(x, sys.bond_idx[:, 1])
    r = torch.sqrt(torch.sum(d * d, dim=-1) + 1e-16)
    return torch.sum(sys.bond_k * (r - sys.bond_r0) ** 2, dim=-1)


def angle_energy(sys: MDSystem, x):
    a, b, c = sys.angle_idx.unbind(1)
    u = _rows(x, a) - _rows(x, b)
    v = _rows(x, c) - _rows(x, b)
    cos = torch.sum(u * v, dim=-1) / torch.sqrt(
        torch.sum(u * u, dim=-1) * torch.sum(v * v, dim=-1) + 1e-16)
    theta = torch.arccos(torch.clamp(cos, -1.0 + 1e-7, 1.0 - 1e-7))
    return torch.sum(sys.angle_k * (theta - sys.angle_t0) ** 2, dim=-1)


def dihedral_energy(sys: MDSystem, x):
    """Proper + improper torsions: E = pk (1 + cos(n phi - phase))."""
    i, j, k, l = sys.dih_idx.unbind(1)
    b1 = _rows(x, j) - _rows(x, i)
    b2 = _rows(x, k) - _rows(x, j)
    b3 = _rows(x, l) - _rows(x, k)
    n1 = torch.cross(b1, b2, dim=-1)
    n2 = torch.cross(b2, b3, dim=-1)
    b2n = b2 / (torch.linalg.norm(b2, dim=-1, keepdim=True) + 1e-12)
    m1 = torch.cross(n1, b2n, dim=-1)
    xx = torch.sum(n1 * n2, dim=-1)
    yy = torch.sum(m1 * n2, dim=-1)
    phi = torch.atan2(yy, xx)
    return torch.sum(sys.dih_pk * (1.0 + torch.cos(sys.dih_n * phi
                                                   - sys.dih_phase)), dim=-1)


def nonbonded_energy(sys: MDSystem, x):
    """All-pairs LJ + Coulomb with exclusion/1-4 scale matrices.

    NoCutoff: plain 1/r Coulomb.  Cutoff methods: reaction-field Coulomb
    qq (1/r + k_rf r^2 - c_rf) and LJ for unscaled pairs within the
    cutoff; 1-4 pairs keep straight scaled Coulomb and LJ.  Periodic:
    minimum image first."""
    n = sys.natoms
    diff = x[:, :, None, :] - x[:, None, :, :]
    if sys.method == "CutoffPeriodic" and sys.box is not None:
        wrap = torch.tensor(sys.box, dtype=x.dtype, device=x.device)
        diff = diff - wrap * torch.round(diff / wrap)
    eye = torch.eye(n, dtype=x.dtype, device=x.device)
    r2 = torch.sum(diff * diff, dim=-1) + eye      # avoid 0 on the diagonal
    r = torch.sqrt(r2)
    inv_r = 1.0 / r
    rmin = sys.rmin_half[:, None] + sys.rmin_half[None, :]
    epsij = torch.sqrt(sys.eps[:, None] * sys.eps[None, :])
    x6 = (rmin * inv_r) ** 6
    elj = epsij * (x6 * x6 - 2.0 * x6)
    qq = COULOMB * sys.charges[:, None] * sys.charges[None, :]
    if sys.method == "NoCutoff":
        e = qq * inv_r * sys.qq_scale + elj * sys.lj_scale
        return 0.5 * torch.sum(e, dim=(-1, -2))
    rc = sys.cutoff
    krf = (1.0 / rc ** 3) * (sys.eps_rf - 1.0) / (2.0 * sys.eps_rf + 1.0)
    crf = (1.0 / rc) * (3.0 * sys.eps_rf) / (2.0 * sys.eps_rf + 1.0)
    within = (r < rc).to(x.dtype)
    full = (sys.qq_scale >= 0.999).to(x.dtype)
    one4 = ((sys.qq_scale > 0) & (sys.qq_scale < 0.999)).to(x.dtype)
    l_full = (sys.lj_scale >= 0.999).to(x.dtype)
    l_one4 = ((sys.lj_scale > 0) & (sys.lj_scale < 0.999)).to(x.dtype)
    e = (qq * (inv_r + krf * r2 - crf) * within * full
         + qq * sys.qq_scale * inv_r * one4
         + elj * within * l_full
         + elj * sys.lj_scale * l_one4)
    return 0.5 * torch.sum(e, dim=(-1, -2))


def dispersion_correction_energy(sys: MDSystem):
    """Isotropic long-range LJ tail E(V) = 2 pi/V (S12/9rc^9 - S6/3rc^3);
    coordinate-independent, so it adds no force."""
    if not sys.use_dispersion:
        return 0.0
    V = math.prod(sys.box)
    rc = sys.cutoff
    return (2.0 * math.pi / V) * (sys.disp_c12sum / (9.0 * rc ** 9)
                                  - sys.disp_c6sum / (3.0 * rc ** 3))


def potential_energy(sys: MDSystem, x):
    """Total potential; x: (..., natoms, 3) -> (...) kJ/mol."""
    shape = x.shape[:-2]
    xb = x.reshape(-1, sys.natoms, 3)
    e = (bond_energy(sys, xb) + angle_energy(sys, xb)
         + dihedral_energy(sys, xb) + nonbonded_energy(sys, xb)
         + dispersion_correction_energy(sys))
    return e.reshape(shape)


def potential_energy_flat(sys: MDSystem, xflat):
    """Flat-coordinate variant; xflat: (..., 3N) -> (...)."""
    return potential_energy(sys, xflat.reshape(xflat.shape[:-1]
                                               + (sys.natoms, 3)))


def force_flat(sys: MDSystem, xflat):
    """Batched forces -grad E on flat coords: (..., 3N) -> (..., 3N)."""
    with torch.enable_grad():
        x = xflat.detach().clone().requires_grad_(True)
        e = potential_energy_flat(sys, x)
        (g,) = torch.autograd.grad(e.sum(), x)
    return -g


def energy_terms(sys: MDSystem, x):
    """Per-term breakdown; x: (natoms, 3) or (B, natoms, 3)."""
    xb = x.reshape(-1, sys.natoms, 3)
    single = x.dim() == 2

    def out(e):
        return e[0] if single else e

    terms = dict(bond=out(bond_energy(sys, xb)),
                 angle=out(angle_energy(sys, xb)),
                 dihedral=out(dihedral_energy(sys, xb)),
                 nonbonded=out(nonbonded_energy(sys, xb)))
    if sys.use_dispersion:
        terms["dispersion"] = dispersion_correction_energy(sys)
    return terms
