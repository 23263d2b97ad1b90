"""Batched force-field energies in PyTorch; forces by autograd.

Counterpart of ``isokann_tpu/md/forces.py`` for the NoCutoff,
reaction-field (CutoffNonPeriodic / CutoffPeriodic) and Ewald / PME
methods (the erfc real space here, the reciprocal, self and exception
terms from ``md/ewald.py``) and OBC2 implicit solvent
(``gbsa_obc2_energy``).  Energies in
kJ/mol; coordinates (..., natoms, 3) in nm; every term sums over the last
two axes so batches need no vmap.  Systems built with
``dense_pairs=False`` route through the O(n) cell-list engine
(``md/neighbor.py``), whose forces are analytic.
"""

from __future__ import annotations

import math

import torch

from .system import COULOMB, EWALD, PERIODIC, MDSystem


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
    minimum image first.  Ewald / PME: erfc-damped Coulomb for full pairs
    within the cutoff, the cut LJ and the scaled 1-4 LJ, plus the
    reciprocal, self and exception energies (the 1-4 Coulomb lies in the
    exception term, OpenMM's exception semantics)."""
    n = sys.natoms
    diff = x[:, :, None, :] - x[:, None, :, :]
    if sys.method in PERIODIC and sys.box is not None:
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
    if sys.method in EWALD:
        from .ewald import (ewald_exception_energy, ewald_recip_energy,
                            ewald_self_energy)
        al = sys.ewald_alpha
        within = (r < sys.cutoff).to(x.dtype)
        full = (sys.qq_scale >= 0.999).to(x.dtype)
        l_full = (sys.lj_scale >= 0.999).to(x.dtype)
        l_one4 = ((sys.lj_scale > 0) & (sys.lj_scale < 0.999)).to(x.dtype)
        e = (qq * torch.special.erfc(al * r) * inv_r * within * full
             + elj * within * l_full + elj * sys.lj_scale * l_one4)
        return (0.5 * torch.sum(e, dim=(-1, -2))
                + ewald_recip_energy(sys.ewald_kvecs, sys.ewald_coefs,
                                     sys.charges, x)
                + ewald_self_energy(al, sys.charges)
                + ewald_exception_energy(sys, x, al))
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


def gbsa_obc2_energy(sys: MDSystem, x):
    """OBC2 generalized-Born + ACE surface-area implicit solvent, all
    pairs: HCT descreening integrals with the OBC tanh rescaling (alpha,
    beta, gamma = 1.0, 0.8, 4.85), the pair energy f_GB = sqrt(r^2 + BiBj
    exp(-r^2 / 4BiBj)) with eps_solvent = 78.5, and the ACE term
    28.3919551 kJ/mol/nm^2 (r + 0.14)^2 (r/B)^6.  x: (B, n, 3) -> (B,)."""
    n = sys.natoms
    offset = 0.009
    radii = sys.gb_radii
    orad = radii - offset
    sr = sys.gb_scales * orad
    eye = torch.eye(n, dtype=x.dtype, device=x.device)

    diff = x[:, :, None, :] - x[:, None, :, :]
    r2 = torch.sum(diff * diff, dim=-1) + eye
    r = torch.sqrt(r2)

    # HCT descreening integral I_ij (contribution of j to i)
    or1 = orad[:, None]
    sr2 = sr[None, :]
    L = torch.maximum(torch.abs(r - sr2), or1)
    U = r + sr2
    invL, invU = 1.0 / L, 1.0 / U
    I = 0.5 * (invL - invU + 0.25 * (r - sr2 ** 2 / r)
               * (invU ** 2 - invL ** 2) + 0.5 * torch.log(L / U) / r)
    # inside correction when atom i is engulfed: or1 < sr2 - r
    I = I + torch.where(or1 < sr2 - r, 2.0 * (1.0 / or1 - invL), 0.0)
    # only pairs where the descreening sphere reaches atom i
    I = torch.where(r + sr2 > or1, I, 0.0)
    I = I * (1.0 - eye)
    Ii = torch.sum(I, dim=-1)

    psi = Ii * orad
    B = 1.0 / (1.0 / orad
               - torch.tanh(psi - 0.8 * psi ** 2 + 4.85 * psi ** 3) / radii)
    B = torch.maximum(B, orad)

    eps_solvent = 78.5
    pref = -0.5 * COULOMB * (1.0 - 1.0 / eps_solvent)
    qq = sys.charges[:, None] * sys.charges[None, :]
    BB = B[:, :, None] * B[:, None, :]
    fgb = torch.sqrt(r2 + BB * torch.exp(-r2 / (4.0 * BB)))
    off = torch.sum(qq / fgb * (1.0 - eye), dim=(-1, -2))
    self_e = torch.sum(sys.charges ** 2 / B, dim=-1)
    e_gb = pref * (off + self_e)

    e_sa = torch.sum(28.3919551 * (radii + 0.14) ** 2 * (radii / B) ** 6,
                     dim=-1)
    return e_gb + e_sa


def bonded_energy(sys: MDSystem, xb):
    """Bonds + angles + torsions; xb: (B, natoms, 3) -> (B,)."""
    return (bond_energy(sys, xb) + angle_energy(sys, xb)
            + dihedral_energy(sys, xb))


def potential_energy(sys: MDSystem, x):
    """Total potential; x: (..., natoms, 3) -> (...) kJ/mol.  A
    ``dense_pairs=False`` system goes through the neighbor engine, walker
    by walker."""
    shape = x.shape[:-2]
    xb = x.reshape(-1, sys.natoms, 3)
    if not sys.dense_pairs:
        from .neighbor import default_plan, potential_energy_neighbor
        plan = default_plan(sys, xb[0])
        return torch.stack([potential_energy_neighbor(sys, xi, plan)
                            for xi in xb]).reshape(shape)
    e = (bonded_energy(sys, xb) + nonbonded_energy(sys, xb)
         + dispersion_correction_energy(sys))
    if sys.implicit == "obc2":
        e = e + gbsa_obc2_energy(sys, xb)
    return e.reshape(shape)


def potential_energy_flat(sys: MDSystem, xflat):
    """Flat-coordinate variant; xflat: (..., 3N) -> (...)."""
    return potential_energy(sys, xflat.reshape(xflat.shape[:-1]
                                               + (sys.natoms, 3)))


def _minus_grad(energy, xflat):
    with torch.enable_grad():
        x = xflat.detach().clone().requires_grad_(True)
        (g,) = torch.autograd.grad(energy(x).sum(), x)
    return -g


def force_flat(sys: MDSystem, xflat):
    """Batched forces -grad E on flat coords: (..., 3N) -> (..., 3N); the
    neighbor engine's analytic forces for a ``dense_pairs=False``
    system."""
    if not sys.dense_pairs:
        from .neighbor import force_flat_neighbor
        return force_flat_neighbor(sys, xflat)
    return _minus_grad(lambda x: potential_energy_flat(sys, x), xflat)


def bonded_force_flat(sys: MDSystem, xflat):
    """-grad of the bonded terms alone (bonds, angles, torsions), by
    autograd: (B, 3N) -> (B, 3N)."""
    return _minus_grad(lambda x: bonded_energy(
        sys, x.reshape(x.shape[0], sys.natoms, 3)), xflat)


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
    if sys.implicit == "obc2":
        terms["gbsa"] = out(gbsa_obc2_energy(sys, xb))
    return terms
