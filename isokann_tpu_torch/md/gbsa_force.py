"""Analytic (autograd-free) nonbonded and OBC2 forces on all pairs.

Counterpart of ``isokann_tpu/md/gbsa_force.py``: the scheme of OpenMM's
GBSAOBC kernels, the direct r-derivative plus the Born-radius chain rule
(dE/dB -> dB/dpsi -> dI/dr).  The per-pair descreening integral and its
r-derivative are ``md.gb_kernel``'s (``_descreen``), the terms kernel D's
plain version uses.  The port's "plain" and "dense" force routes
(``simulators.mdsim``) take it under NoCutoff and the reaction field,
where the reference takes autograd of the energy; it is held to autograd
of ``forces.nonbonded_energy`` + ``forces.gbsa_obc2_energy`` and to the
JAX package.  Methods: NoCutoff and the reaction field (minimum image under
CutoffPeriodic); Ewald / PME raise.

Coordinates (..., n, 3) in nm; forces in kJ/mol/nm.
"""

from __future__ import annotations

import torch

from .forces import bonded_force_flat
from .gb_kernel import OFFSET, PREF, SA, _descreen
from .system import COULOMB, EWALD, MDSystem


def _pair_geometry(sys: MDSystem, x):
    """Pair vectors d_ij = x_i - x_j (..., n, n, 3) (minimum image under
    CutoffPeriodic), r^2 and r (..., n, n) with 1 on the diagonal, and the
    off-diagonal mask."""
    if sys.method in EWALD:
        raise ValueError("the analytic forces cover NoCutoff and the "
                         "reaction field, not Ewald / PME")
    n = sys.natoms
    d = x[..., :, None, :] - x[..., None, :, :]
    if sys.method == "CutoffPeriodic" and sys.box is not None:
        box = torch.tensor(sys.box, dtype=x.dtype, device=x.device)
        d = d - box * torch.round(d / box)
    eye = torch.eye(n, dtype=x.dtype, device=x.device)
    r2 = torch.sum(d * d, dim=-1) + eye
    return d, r2, torch.sqrt(r2), 1.0 - eye


def nonbonded_force_direct(sys: MDSystem, x):
    """Analytic LJ + Coulomb (reaction field under a cutoff) forces."""
    d, r2, r, offd = _pair_geometry(sys, x)
    inv_r2 = 1.0 / r2
    inv_r = 1.0 / r
    rmin = sys.rmin_half[:, None] + sys.rmin_half[None, :]
    epsij = torch.sqrt(sys.eps[:, None] * sys.eps[None, :])
    x6 = (rmin * rmin * inv_r2) ** 3
    qq = COULOMB * sys.charges[:, None] * sys.charges[None, :]
    g_lj = 6.0 * epsij * (x6 - x6 * x6) * inv_r2
    g_c = qq * (-0.5) * inv_r2 * inv_r
    # dE/d(r^2) of each pair
    if sys.method == "NoCutoff":
        g = sys.lj_scale * g_lj + sys.qq_scale * g_c
    else:
        rc = sys.cutoff
        krf = (1.0 / rc ** 3) * (sys.eps_rf - 1.0) / (2 * sys.eps_rf + 1.0)
        within = (r < rc).to(x.dtype)
        full = (sys.qq_scale >= 0.999).to(x.dtype)
        one4 = ((sys.qq_scale > 0) & (sys.qq_scale < 0.999)).to(x.dtype)
        l_full = (sys.lj_scale >= 0.999).to(x.dtype)
        l_one4 = ((sys.lj_scale > 0) & (sys.lj_scale < 0.999)).to(x.dtype)
        g = (g_lj * (l_full * within + l_one4 * sys.lj_scale)
             + (g_c + qq * krf) * within * full
             + g_c * one4 * sys.qq_scale)
    # F_i = -sum_j 2 g_ij (x_i - x_j)
    return -2.0 * torch.sum((g * offd)[..., None] * d, dim=-2)


def obc2_force(sys: MDSystem, x):
    """Analytic OBC2 GBSA forces: the pair term's direct r-dependence and
    the chain through the Born radii."""
    d, r2, r, offd = _pair_geometry(sys, x)
    radii = sys.gb_radii
    orad = radii - OFFSET
    inv_r = 1.0 / r
    I, D = _descreen(r, inv_r, inv_r * inv_r,
                     (sys.gb_scales * orad)[None, :], orad[:, None])
    I, D = I * offd, D * offd                 # D: dI_ij/dr / r
    psi = torch.sum(I, dim=-1) * orad
    th = torch.tanh(psi - 0.8 * psi ** 2 + 4.85 * psi ** 3)
    B = torch.maximum(1.0 / (1.0 / orad - th / radii), orad)
    dBdpsi = (B * B * (1.0 - th * th) * (1.0 - 1.6 * psi + 14.55 * psi ** 2)
              / radii)

    q = sys.charges
    qq = q[:, None] * q[None, :]
    Bi, Bj = B[..., :, None], B[..., None, :]
    BB = Bi * Bj
    expo = torch.exp(-r2 / (4.0 * BB))
    f2 = r2 + BB * expo
    # the ordered double sum counts each unordered pair twice
    gpair = PREF * qq * (-0.5) / (f2 * torch.sqrt(f2)) * offd
    dEdr2 = 2.0 * gpair * (1.0 - expo / 4.0)
    dEdB = (2.0 * torch.sum(gpair * Bj * expo * (1.0 + r2 / (4.0 * BB)),
                            dim=-1)
            + PREF * (-(q ** 2) / B ** 2)
            + SA * (radii + 0.14) ** 2 * radii ** 6 / B ** 7)
    # G_ij / r = dE/dB_i dB_i/dpsi_i orad_i dI_ij/dr / r
    GdR = (dEdB * dBdpsi * orad)[..., None] * D
    w = 2.0 * dEdr2 + GdR + GdR.transpose(-1, -2)
    return -torch.sum(w[..., None] * d, dim=-2)


def force_flat_analytic(sys: MDSystem, xflat):
    """Analytic nonbonded (+ OBC2) forces plus the bonded terms
    (``forces.bonded_force_flat``), on flat coordinates (..., 3N) ->
    (..., 3N): an alternative to ``forces.force_flat`` for dense
    systems."""
    shape = xflat.shape
    xb = xflat.reshape(-1, shape[-1])
    x3 = xb.reshape(xb.shape[0], sys.natoms, 3)
    f = nonbonded_force_direct(sys, x3)
    if sys.implicit == "obc2":
        f = f + obc2_force(sys, x3)
    return (f.reshape(xb.shape) + bonded_force_flat(sys, xb)).reshape(shape)
