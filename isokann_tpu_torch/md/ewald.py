"""Ewald summation for periodic electrostatics (methods "Ewald" and "PME").

Counterpart of ``isokann_tpu/md/ewald.py`` without LJPME and without the
traced (NPT) box.  The reciprocal sum is the reference's structure-factor
formulation, exact Ewald with OpenMM's error tolerance:

    S(k) = sum_j q_j exp(i k.r_j)

as two dense (natoms, nk) cos/sin products, batched over walkers.  Those
products are ``torch.matmul`` in full float32: the phases k.x reach tens
of radians, and a TF32 product would move them by ~1e-2, so the package
turns TF32 off (``isokann_tpu_torch/__init__.py``).  The k-vector tables
are built on the host in float64, as in the reference.

The real-space erfc part rides the cutoff machinery (the dense path:
``forces.nonbonded_energy``; the O(n) path: the neighbor sweep, kernel E
on the card); this module owns the reciprocal sum, the self term and the
exclusion corrections.  Units: nm, e, kJ/mol.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .system import COULOMB


def ewald_alpha(cutoff: float, tol: float = 5e-4) -> float:
    """Ewald splitting parameter from the direct-space tolerance (OpenMM's
    rule: erfc(alpha rc) ~ tol at the cutoff)."""
    return math.sqrt(-math.log(2.0 * tol)) / cutoff


def ewald_kvectors(box, alpha: float, tol: float = 5e-4):
    """Half-space reciprocal vectors and coefficients of an orthorhombic
    box, host numpy float64: (kvecs (nk, 3) [1/nm], coefs (nk,) [kJ/mol
    per |S|^2]).  kmax_i = ceil(alpha L_i sqrt(-ln tol) / pi), the corners
    beyond the ellipsoid of those per-axis limits dropped; one of each
    +-k pair is kept and the energy doubles it."""
    box = np.asarray(box, np.float64)
    V = float(np.prod(box))
    kmax = np.maximum(np.ceil(alpha * box * math.sqrt(-math.log(tol))
                              / math.pi).astype(int), 1)
    ms = []
    for mx in range(0, kmax[0] + 1):
        ylo = -kmax[1] if mx > 0 else 0
        for my in range(ylo, kmax[1] + 1):
            zlo = -kmax[2] if (mx > 0 or my > 0) else 1
            for mz in range(zlo, kmax[2] + 1):
                ms.append((mx, my, mz))
    m = np.asarray(ms, np.float64)
    m = m[np.sum((m / kmax) ** 2, axis=1) <= 1.0 + 1e-9]
    k = 2.0 * math.pi * m / box
    k2 = np.sum(k * k, axis=1)
    coefs = ((COULOMB * 2.0 * math.pi / V)
             * np.exp(-k2 / (4.0 * alpha ** 2)) / k2)
    return k, coefs


def _structure_factors(kvecs, charges, x):
    """cos and sin of the phases (..., n, nk) of walkers ``x`` (..., n, 3)
    and the structure factors' real and imaginary parts (..., nk)."""
    phases = torch.matmul(x, kvecs.T)
    c, s = torch.cos(phases), torch.sin(phases)
    return (c, s, torch.matmul(charges, c), torch.matmul(charges, s))


def ewald_recip_energy(kvecs, coefs, charges, x):
    """Reciprocal-space energy of walkers ``x`` (..., n, 3) -> (...);
    differentiable."""
    _, _, Sc, Ss = _structure_factors(kvecs, charges, x)
    return 2.0 * torch.sum(coefs * (Sc * Sc + Ss * Ss), dim=-1)


def ewald_recip_force(kvecs, coefs, charges, x):
    """Analytic -dE/dx of ``ewald_recip_energy``, (..., n, 3): F_i = 4 q_i
    sum_k coef_k k (Sc sin(k.r_i) - Ss cos(k.r_i))."""
    c, s, Sc, Ss = _structure_factors(kvecs, charges, x)
    w = (s * (coefs * Sc)[..., None, :] - c * (coefs * Ss)[..., None, :])
    return 4.0 * charges[:, None] * torch.matmul(w, kvecs)


def ewald_self_energy(alpha, charges):
    """The Gaussian self-interaction: -C alpha / sqrt(pi) sum q^2."""
    return -COULOMB * alpha / math.sqrt(math.pi) * torch.sum(charges
                                                              * charges)


def erfc_approx(x):
    """Abramowitz & Stegun 7.1.26 erfc (abs err < 1.5e-7) from exp, mul
    and add only, as the kernels compute it."""
    t = 1.0 / (1.0 + 0.3275911 * x)
    poly = t * (0.254829592 + t * (-0.284496736 + t * (
        1.421413741 + t * (-1.453152027 + t * 1.061405429))))
    return poly * torch.exp(-x * x)


def _exception_geometry(sys, x, box):
    """Minimum-image pair vectors (B, m, 3), squared and plain distances
    (B, m) and C q_i q_j (m,) of the exception pairs of walkers ``x`` (B,
    n, 3)."""
    if box is None:
        box = torch.tensor(sys.box, dtype=x.dtype, device=x.device)
    i, j = sys.excl_idx[:, 0], sys.excl_idx[:, 1]
    d = x[:, i] - x[:, j]
    d = d - box * torch.round(d / box)
    r2 = torch.sum(d * d, dim=-1) + 1e-12
    qq = COULOMB * sys.charges[i] * sys.charges[j]
    return d, r2, torch.sqrt(r2), qq


def ewald_exception_energy(sys, x, alpha, box=None):
    """Exclusion corrections of walkers ``x`` (B, n, 3) -> (B,): for each
    exception pair the full Ewald interaction qq erf(alpha r) / r that the
    reciprocal sum holds is taken out (the real-space term masks these
    pairs) and the scaled straight-Coulomb 1-4 term added back, OpenMM's
    exception semantics.  The LJ corrections are the caller's."""
    if sys.excl_idx.shape[0] == 0:
        return torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
    _, _, r, qq = _exception_geometry(sys, x, box)
    return torch.sum(qq * (sys.excl_qq - torch.special.erf(alpha * r)) / r,
                     dim=-1)


def ewald_exception_force(sys, x, alpha, box=None):
    """Analytic -grad of ``ewald_exception_energy``, (B, n, 3)."""
    if sys.excl_idx.shape[0] == 0:
        return torch.zeros_like(x)
    d, r2, r, qq = _exception_geometry(sys, x, box)
    # E(r) = qq (scee - erf(a r)) / r
    dEdr = (-qq * (sys.excl_qq - torch.special.erf(alpha * r)) / r2
            - qq * (2.0 * alpha / math.sqrt(math.pi))
            * torch.exp(-(alpha * r) ** 2) / r)
    g = (dEdr / r)[..., None] * d
    i, j = sys.excl_idx[:, 0], sys.excl_idx[:, 1]
    f = torch.zeros_like(x)
    f.index_add_(1, i, -g)
    f.index_add_(1, j, g)
    return f
