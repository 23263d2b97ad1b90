"""Ewald summation for periodic electrostatics (methods "Ewald" and "PME")
and for the r^-6 dispersion (method "LJPME").

Counterpart of ``isokann_tpu/md/ewald.py``, with the tables of a box
given at run time (``ewald_tables_for_box``, ``ljpme_tables_for_box``:
the NPT barostat's volume moves).  The reciprocal sum is the reference's
structure-factor formulation, exact Ewald with OpenMM's error tolerance:

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


def _ktriples(sys, device):
    """The integer triples m (nk, 3) of the system's k-vectors, k = 2 pi m
    / box, as float32 on ``device`` (cached on the system)."""
    cache = sys.__dict__.setdefault("_ktriples", {})
    key = str(torch.device(device))
    if key not in cache:
        m = np.round(sys.ewald_kvecs.detach().cpu().numpy().astype(np.float64)
                     * np.asarray(sys.box) / (2.0 * math.pi))
        cache[key] = torch.as_tensor(m, dtype=torch.float32, device=device)
    return cache[key]


def _box_tensor(sys, box, device, dtype=torch.float32):
    """``box`` (a tensor or three numbers) as a (3,) tensor of ``dtype``
    on ``device``; the system's box for None (from its float64 lengths,
    so that float64 walkers see the exact box)."""
    return torch.as_tensor(sys.box if box is None else box, dtype=dtype,
                           device=device)


def ewald_tables_for_box(sys, box):
    """The reciprocal tables (kvecs (nk, 3), coefs (nk,)) of the box
    ``box`` given at run time: the build box's integer triples m with k =
    2 pi m / box, and the coefficients recomputed for that box."""
    m = _ktriples(sys, sys.ewald_kvecs.device)
    box = _box_tensor(sys, box, m.device)
    kv = 2.0 * math.pi * m / box
    k2 = torch.sum(kv * kv, dim=1)
    al = sys.ewald_alpha
    cf = ((COULOMB * 2.0 * math.pi / torch.prod(box))
          * torch.exp(-k2 / (4.0 * al * al)) / k2)
    return kv, cf


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
    return ewald_recip_forces(kvecs, [(coefs, charges)], x)


def ewald_recip_forces(kvecs, terms, x):
    """The forces of several reciprocal sums ``terms`` [(coefs (nk,),
    charges (n,))] on the same k-vectors (the Coulomb sum and LJPME's
    dispersion), (..., n, 3), from one evaluation of the phases: the sum
    over k of ``ewald_recip_force`` as two products of sin and cos with
    weighted k-vectors (..., nk, 3), so that no (n, nk) array beyond the
    phases, their cos and sin is made."""
    phases = torch.matmul(x, kvecs.T)
    c, s = torch.cos(phases), torch.sin(phases)
    f = 0.0
    for coefs, q in terms:
        ks = kvecs * (coefs * torch.matmul(q, c))[..., None]
        kc = kvecs * (coefs * torch.matmul(q, s))[..., None]
        f = f + 4.0 * q[:, None] * (torch.matmul(s, ks) - torch.matmul(c, kc))
    return f


def ewald_self_energy(alpha, charges):
    """The Gaussian self-interaction: -C alpha / sqrt(pi) sum q^2."""
    return -COULOMB * alpha / math.sqrt(math.pi) * torch.sum(charges
                                                              * charges)


# LJPME: Ewald summation of the r^-6 dispersion.  1/r^6 splits at beta
# into g6(beta r)/r^6 (real space, g6(x) = (1 + x^2 + x^4/2) e^{-x^2}) and
# h(r) = (1 - g6)/r^6, whose transform is
#   h^(k) = (pi^{3/2} beta^3 / 3) [(1 - 2 b^2) e^{-b^2}
#                                  + 2 sqrt(pi) b^3 erfc(b)],  b = k/(2 beta);
# the long-range energy is -(1/2V) sum_k h^(k) |S6(k)|^2 over amplitudes
# q6_j = sqrt(c6_jj), less the i == j self term h(0) = beta^6 / 6.  Within
# the cutoff the real space adds q6_i q6_j h(r) for every pair (the exact
# Amber-mixed LJ is computed there), so the geometric mixing acts only
# beyond the cutoff, as OpenMM's LJPME.


def ljpme_g6(x2):
    """g6 as a function of x^2: (1 + x^2 + x^4/2) e^{-x^2}."""
    return (1.0 + x2 * (1.0 + 0.5 * x2)) * torch.exp(-x2)


def ljpme_hker(r2, beta):
    """h(r) = (1 - g6(beta r)) / r^6 from r^2; below x^2 = 0.1225 the series
    beta^6 (1/6 - x^2/8 + x^4/20), free of the float32 cancellation of
    1 - g6 ~ x^6/6."""
    x2 = beta * beta * r2
    small = x2 < 0.1225
    x2s = torch.where(small, x2, 1.0)
    series = beta ** 6 * (1.0 / 6.0 - x2s / 8.0 + x2s * x2s / 20.0)
    r6 = torch.where(small, 1.0, r2) ** 3
    return torch.where(small, series, (1.0 - ljpme_g6(x2)) / r6)


def ljpme_hker_grad(r2, beta):
    """(h, dh/d(r^2)): dh/dr^2 = beta^2 u^2 e^{-u} / (2 r^6) - 3 (1 - g6) /
    r^8 with u = (beta r)^2; the series branch beta^8 (-1/8 + u/10)."""
    u = beta * beta * r2
    small = u < 0.1225
    us = torch.where(small, u, 1.0)
    h_series = beta ** 6 * (1.0 / 6.0 - us / 8.0 + us * us / 20.0)
    g_series = beta ** 8 * (-1.0 / 8.0 + us / 10.0)
    r2safe = torch.where(small, 1.0, r2)
    r6 = r2safe ** 3
    one_m_g6 = 1.0 - ljpme_g6(u)
    g_direct = (beta * beta * u * u * torch.exp(-u) / (2.0 * r6)
                - 3.0 * one_m_g6 / (r6 * r2safe))
    return (torch.where(small, h_series, one_m_g6 / r6),
            torch.where(small, g_series, g_direct))


def ljpme_hhat(k2, beta):
    """The closed form h^(k) from k^2 (a tensor; k = 0 included)."""
    k2 = torch.as_tensor(k2)
    b2 = k2 / (4.0 * beta * beta)
    b = torch.sqrt(b2)
    val = ((1.0 - 2.0 * b2) * torch.exp(-b2)
           + 2.0 * math.sqrt(math.pi) * b2 * b * torch.special.erfc(b))
    return (math.pi ** 1.5 * beta ** 3 / 3.0) * val


def ljpme_coefs(box, beta, kvecs):
    """Signed coefficients -h^(k)/(2V) of the half-space ``kvecs``, host
    numpy float64, shaped so that ``ewald_recip_energy`` / ``_force`` (2
    sum coef |S|^2, the +-k doubling) give the dispersion directly."""
    V = float(np.prod(np.asarray(box, np.float64)))
    k2 = np.sum(np.asarray(kvecs, np.float64) ** 2, axis=1)
    hh = ljpme_hhat(torch.as_tensor(k2, dtype=torch.float64), beta)
    return (-hh / (2.0 * V)).numpy()


def ljpme_tables_for_box(sys, box):
    """``ljpme_coefs`` for the box ``box`` given at run time, on the build
    box's integer triples (as ``ewald_tables_for_box``)."""
    m = _ktriples(sys, sys.ewald_kvecs.device)
    box = _box_tensor(sys, box, m.device)
    kv = 2.0 * math.pi * m / box
    k2 = torch.sum(kv * kv, dim=1)
    return kv, -ljpme_hhat(k2, sys.ljpme_beta) / (2.0 * torch.prod(box))


def ljpme_const_energy(sys, box=None):
    """The k = 0 and self terms, -(h^(0)/2V) (sum q6)^2 + (beta^6/12) sum
    q6^2; the first is the volume-dependent piece that replaces the tail
    correction."""
    beta = sys.ljpme_beta
    V = torch.prod(_box_tensor(sys, box, sys.q6.device))
    q6sum = torch.sum(sys.q6)
    h0 = math.pi ** 1.5 * beta ** 3 / 3.0
    return (-h0 / (2.0 * V) * q6sum * q6sum
            + beta ** 6 / 12.0 * torch.sum(sys.q6 * sys.q6))


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
    n, 3); ``box``: as ``_box_tensor``."""
    box = _box_tensor(sys, box, x.device, x.dtype)
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
