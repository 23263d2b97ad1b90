"""Nonbonded + OBC2 GBSA forces of medium systems: the hand-written CUDA
kernel, its plain PyTorch version, the wrapper that chooses between them,
and ``force_flat_hybrid``.

Counterpart of ``isokann_tpu/md/pallas_gb.py`` (the TPU kernel
``gb_force_pallas`` with its inner body ``_force_one_walker``; the opt-in
``_force_one_walker_tri`` computes the same function in another tiling).
The CUDA source is ``csrc/gb_force.cu``; its header states the design and
the bound.

- ``GBPlan``: the per-atom parameter tables (charge, Rmin/2, sqrt(eps),
  Born radius, offset radius, scaled radius) and the Coulomb scale grid,
  from which the LJ scales are derived (0 -> 0, >= 0.999 -> 1, else 0.5).
- ``gb_force_plain``: the same function in tensor ops on (B, A, A)
  pair tensors, in the TPU kernel's three passes and with its forms:
  Born-radius descreening sums, dE/dB sums, then the force accumulation
  with the descreening transpose term from column sums.  The CPU tests
  and ``chip_smoke.py`` hold the kernel against it.
- ``gb_force``: the wrapper.  A CPU tensor takes the plain version; a
  CUDA tensor launches the kernel or raises.  ``gb_force.launches``
  counts the launches.
- ``force_flat_hybrid``: the kernel's forces plus the bonded terms (bonds,
  angles, torsions) by autograd, as the reference's hybrid path.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import langevin_kernel as LK
from .forces import bonded_force_flat
from .system import COULOMB, MDSystem

MAX_ATOMS = 640          # one thread per atom, one block per walker
OFFSET = 0.009           # OBC offset of the Born radii [nm]
EPS_SOLVENT = 78.5
PREF = -0.5 * COULOMB * (1.0 - 1.0 / EPS_SOLVENT)
SA = -6.0 * 28.3919551   # d/dB of the ACE surface term, per (r + 0.14)^2 r^6


class GBPlan:
    """Per-atom tables and the Coulomb scale grid of one system.

    ``tab`` (6, A) float32: q | Rmin/2 | sqrt(eps) | Born radius | offset
    radius | scaled radius (zeros and 0.15 nm radii without OBC2, as the
    reference plan); ``qq_scale`` (A, A) float32 with a zero diagonal (its
    transpose goes to the card, for the kernel's coalesced column reads).
    The values are computed in float32 numpy as the reference plan does."""

    def __init__(self, sys: MDSystem):
        A = sys.natoms
        self.A = A
        self.system = sys

        def f32(t):
            return np.asarray(t.detach().cpu().numpy(), np.float32)

        q = f32(sys.charges)
        rmh = f32(sys.rmin_half)
        seps = np.sqrt(f32(sys.eps))
        self.use_gb = sys.implicit == "obc2"
        has_gb = self.use_gb and sys.gb_radii.shape[0] == A
        radii = (f32(sys.gb_radii) if has_gb
                 else np.full(A, 0.15, np.float32))
        scales = f32(sys.gb_scales) if has_gb else np.zeros(A, np.float32)
        orad = radii - np.float32(OFFSET)
        self.tab = np.stack([q, rmh, seps, radii, orad, scales * orad]
                            ).astype(np.float32)
        qq = np.asarray(f32(sys.qq_scale), np.float32).copy()
        np.fill_diagonal(qq, 0.0)
        self.qq_scale = qq
        self.use_rf = sys.method != "NoCutoff"
        self.cutoff = float(sys.cutoff)
        eps_rf = float(sys.eps_rf)
        self.krf = ((1.0 / self.cutoff ** 3) * (eps_rf - 1.0)
                    / (2 * eps_rf + 1.0))
        self.box = (tuple(float(b) for b in sys.box)
                    if sys.method == "CutoffPeriodic" and sys.box is not None
                    else None)
        self._dev = {}

    @property
    def dim(self):
        return 3 * self.A

    def on(self, device) -> dict:
        """The tables as tensors on ``device`` (built once per device)."""
        device = torch.device(device)
        key = str(device)
        if key not in self._dev:
            tab = torch.as_tensor(self.tab, device=device)
            names = ("q", "rmh", "seps", "radii", "orad", "sr")
            d = {n: tab[k] for k, n in enumerate(names)}
            d.update(tab=tab,
                     qq=torch.as_tensor(self.qq_scale, device=device),
                     qq_t=torch.as_tensor(
                         np.ascontiguousarray(self.qq_scale.T),
                         device=device))
            self._dev[key] = d
        return self._dev[key]


# Per ordered pair (i, j), the float operations the function needs, each
# transcendental (exp, log, tanh, rsqrt), division and comparison counted as
# one: the geometry (3 differences, r^2, rsqrt, r) 10, and 12 more under
# minimum image; the LJ + Coulomb coefficient 23 (33 with the reaction
# field) and its force accumulation 6.  With OBC2 also the descreening
# integral I_ij with its (L, U, ln) terms and masks 30; the GB pair term of
# dE/dB_i (exp, f, f^-3, df/dB_i) 20; the GB pair-energy derivative from
# those exp and f^-3, 11; dI_ij/dr from the (L, U, ln) terms of I_ij, 47
# (dL 6, the polynomial 31, the engulfed correction 2, mask and product 8);
# and the accumulation of the descreening transpose term, 6.  The TPU body
# computes each of these once per ordered pair (it keeps the (L, U, ln) and
# (exp, f^-3) chunks between passes).  The CUDA kernel repeats some of it
# (``kernel_ops``): the geometry in each of its three passes, the (exp,
# f^-3) terms (10) in pass 3, and there dI/dr twice with its (L, U, ln)
# terms (57 each), once for the pair seen from i and once from j.
_GEOM, _GEOM_PBC = 10, 12
_NB, _NB_RF, _ACC = 23, 33, 6
_BORN, _GB_PAIR, _GB_DR, _DI, _LU, _EXPF = 30, 20, 11, 47, 10, 10
_PER_ATOM = 40           # Born radius, dE/dB self terms, chain factor


def _ops(plan: GBPlan, geoms: int, dis: int, lus: int, expfs: int) -> float:
    pairs = plan.A * (plan.A - 1)
    geom = _GEOM + (_GEOM_PBC if plan.box is not None else 0)
    nb = (_NB_RF if plan.use_rf else _NB) + _ACC
    if not plan.use_gb:
        return float(pairs * (geom + nb))
    gb = (_BORN + _GB_PAIR + _GB_DR + dis * _DI + lus * _LU
          + expfs * _EXPF + _ACC)
    return float(pairs * (geoms * geom + nb + gb) + plan.A * _PER_ATOM)


def step_ops(plan: GBPlan) -> float:
    """Float operations per walker per force evaluation that the function
    needs (see the per-pair constants above): 153 an ordered pair with
    OBC2, 49 in vacuum with the reaction field.  ``bound_ms`` uses it."""
    return _ops(plan, geoms=1, dis=1, lus=0, expfs=0)


def kernel_ops(plan: GBPlan) -> float:
    """Float operations per walker per force evaluation as the CUDA kernel
    executes them, its repeated work included: 250 an ordered pair with
    OBC2, as ``step_ops`` in vacuum."""
    return _ops(plan, geoms=3, dis=2, lus=2, expfs=1)


def bound_ms(plan: GBPlan, nwalkers: int):
    """Least time on an H100 for one force evaluation of ``nwalkers``
    walkers, and what bounds it: operations over the FP32 peak, or the
    coordinates read and the forces written once, with the tables and
    the scale grid read once, over the memory rate."""
    ops = step_ops(plan) * nwalkers
    nbytes = 2 * 4 * nwalkers * plan.dim + plan.tab.nbytes \
        + plan.qq_scale.nbytes
    t_ops = ops / LK.H100_FP32_PEAK
    t_bytes = nbytes / LK.H100_HBM_BYTES_PER_S
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


# ==========================================================================
# Plain PyTorch version (the TPU kernel's three passes on (B, A, A) tensors)
# ==========================================================================

def _dI_dr(r, inv_r, inv_r2, srj, orad_i, invL, invU, lnLU):
    """d/dr of the descreening integral I_ij (srj of the column atom,
    orad_i of the row atom)."""
    dL = torch.where(torch.abs(r - srj) > orad_i, torch.sign(r - srj), 0.0)
    invL2, invU2 = invL * invL, invU * invU
    dI = 0.5 * (
        -invL2 * dL + invU2
        + 0.25 * ((1.0 + srj ** 2 * inv_r2) * (invU2 - invL2)
                  + (r - srj ** 2 * inv_r)
                  * (-2.0 * invU * invU2 + 2.0 * invL * invL2 * dL))
        - 0.5 * lnLU * inv_r2 + 0.5 * (dL * invL - invU) * inv_r)
    return dI + torch.where(orad_i < srj - r, 2.0 * invL2 * dL, 0.0)


def gb_force_plain(plan: GBPlan, x):
    """Nonbonded (+ OBC2) forces, (B, 3A) -> (B, 3A)."""
    tb = plan.on(x.device)
    B, A = x.shape[0], plan.A
    X = x.reshape(B, A, 3)
    col = {n: tb[n][None, :, None] for n in
           ("q", "rmh", "seps", "radii", "orad", "sr")}   # atom i (rows)
    row = {n: tb[n][None, None, :] for n in
           ("q", "rmh", "seps", "sr")}                     # atom j (lanes)
    d = X[:, :, None, :] - X[:, None, :, :]
    if plan.box is not None:
        box = torch.tensor(plan.box, dtype=x.dtype, device=x.device)
        ibox = torch.tensor([1.0 / b for b in plan.box], dtype=x.dtype,
                            device=x.device)
        d = d - box * torch.round(d * ibox)
    dx, dy, dz = d.unbind(-1)
    offd = 1.0 - torch.eye(A, dtype=x.dtype, device=x.device)
    r2 = dx * dx + dy * dy + dz * dz + (1.0 - offd)
    inv_r = torch.rsqrt(r2)
    r = r2 * inv_r

    if plan.use_gb:
        # ---- pass 1: Born-radius descreening sums ----------------------
        orad_c, radii_c, q_c = col["orad"], col["radii"], col["q"]
        srj = row["sr"]
        L = torch.maximum(torch.abs(r - srj), orad_c)
        U = r + srj
        rLU = 1.0 / (L * U)
        invL, invU = U * rLU, L * rLU
        lnLU = torch.log(L * invU)
        I = 0.5 * (invL - invU + 0.25 * (r - srj ** 2 * inv_r)
                   * (invU ** 2 - invL ** 2) + 0.5 * lnLU * inv_r)
        I = I + torch.where(orad_c < srj - r, 2.0 * (1.0 / orad_c - invL),
                            0.0)
        active = ((r + srj > orad_c).to(x.dtype) * offd
                  * (srj > 1e-8).to(x.dtype))
        Ii = torch.sum(I * active, dim=2, keepdim=True)        # (B, A, 1)

        psi = Ii * orad_c
        garg = psi - 0.8 * psi ** 2 + 4.85 * psi ** 3
        th = torch.tanh(garg)
        Bc = 1.0 / (1.0 / orad_c - th / radii_c)
        Bc = torch.maximum(Bc, orad_c)
        invB = 1.0 / Bc
        dBdpsi = Bc * Bc * (1.0 - th * th) * (
            1.0 - 1.6 * psi + 14.55 * psi ** 2) / radii_c

        # ---- pass 2: dE/dB row sums ------------------------------------
        Br, invBr = Bc.transpose(1, 2), invB.transpose(1, 2)   # (B, 1, A)
        dEdB = (PREF * (-(q_c ** 2) * invB * invB)
                + (SA * (radii_c + 0.14) ** 2 * radii_c ** 6 * invB ** 7))
        t = r2 * (0.25 * invB) * invBr
        expo = torch.exp(-t)
        f2 = r2 + Bc * Br * expo
        rsf = torch.rsqrt(f2)
        finv3 = rsf * rsf * rsf
        qqp = q_c * row["q"]
        df2dBi = Br * expo * (1.0 + t)
        dEdB = dEdB + 2.0 * torch.sum(
            PREF * qqp * (-0.5) * finv3 * df2dBi * offd, dim=2, keepdim=True)
        gchain = dEdB * dBdpsi * orad_c                         # (B, A, 1)

    # ---- pass 3: force accumulation ------------------------------------
    inv_r2 = inv_r * inv_r
    rmin = col["rmh"] + row["rmh"]
    epsij = col["seps"] * row["seps"]
    x6 = (rmin * rmin * inv_r2) ** 3
    qq = COULOMB * col["q"] * row["q"]
    qsc = tb["qq"]
    lsc = torch.where(qsc == 0.0, 0.0, torch.where(qsc >= 0.999, 1.0, 0.5))
    g_lj = 6.0 * epsij * (x6 - x6 * x6) * inv_r2
    g_c_plain = qq * (-0.5) * inv_r2 * inv_r
    if not plan.use_rf:
        w = 2.0 * (lsc * g_lj + qsc * g_c_plain)
    else:
        within = (r < plan.cutoff).to(x.dtype)
        full = (qsc >= 0.999).to(x.dtype)
        one4 = ((qsc > 0) & (qsc < 0.999)).to(x.dtype)
        l_full = (lsc >= 0.999).to(x.dtype)
        l_one4 = ((lsc > 0) & (lsc < 0.999)).to(x.dtype)
        w = 2.0 * (g_lj * (l_full * within + l_one4 * lsc)
                   + qq * ((-0.5 * inv_r2 * inv_r + plan.krf) * within
                           * full)
                   + g_c_plain * one4 * qsc)
    w = w * offd

    ft = None
    if plan.use_gb:
        dEdr2 = 2.0 * PREF * qqp * (-0.5) * finv3 * (1.0 - expo / 4.0) * offd
        w = w + 2.0 * dEdr2
        dI = _dI_dr(r, inv_r, inv_r2, srj, orad_c, invL, invU, lnLU)
        GdR = gchain * dI * active * inv_r
        w = w + GdR
        # transpose term: atom j gains sum_i GdR_ij d_ij (column sums)
        ft = torch.sum(GdR[..., None] * d, dim=1)              # (B, A, 3)

    f = -torch.sum(w[..., None] * d, dim=2)                    # (B, A, 3)
    if ft is not None:
        f = f + ft
    return f.reshape(B, 3 * A)


# ==========================================================================
# Wrapper: plain version on the CPU, the kernel on the card
# ==========================================================================

class GBForce(LK.CudaKernel):
    """``gb_force(plan, x)``: (B, 3A) -> (B, 3A) nonbonded (+ OBC2)
    forces."""

    name, source = "gb_force", "gb_force.cu"

    def _declare(self, lib):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.gb_force.argtypes = ([p, p, i, i, p, p, i, i, f, f, f, f, i]
                                 + [f] * 6 + [p])
        lib.gb_force.restype = i

    def __call__(self, plan: GBPlan, x):
        if x.dtype != torch.float32 or x.dim() != 2 or x.shape[1] != plan.dim:
            raise ValueError(f"gb_force: expected float32 (B, {plan.dim}), "
                             f"got {tuple(x.shape)} {x.dtype}")
        if x.device.type == "cpu":
            return gb_force_plain(plan, x)
        if x.device.type != "cuda":
            raise NotImplementedError(f"no gb_force kernel for {x.device}")
        if plan.A > MAX_ATOMS:
            raise NotImplementedError(f"the gb_force kernel takes <= "
                                      f"{MAX_ATOMS} atoms, not {plan.A}")
        lib = self.lib()
        x = x.contiguous()
        f = torch.empty_like(x)
        tb = plan.on(x.device)
        bx, by, bz = plan.box if plan.box is not None else (1.0, 1.0, 1.0)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.gb_force(
            x.data_ptr(), f.data_ptr(), x.shape[0], plan.A,
            tb["tab"].data_ptr(), tb["qq_t"].data_ptr(), int(plan.use_gb),
            int(plan.use_rf), plan.cutoff, plan.krf, COULOMB, PREF,
            int(plan.box is not None), bx, by, bz, 1.0 / bx, 1.0 / by,
            1.0 / bz, stream)
        self._raise(err, "gb_force")
        self.launches += 1
        return f


gb_force = GBForce()


def force_flat_hybrid(plan: GBPlan, xflat):
    """Full force on flat coordinates (..., 3A): ``gb_force`` for the
    nonbonded (+ OBC2) part plus autograd of the bonded terms."""
    shape = xflat.shape
    xb = xflat.reshape(-1, shape[-1])
    f = gb_force(plan, xb) + bonded_force_flat(plan.system, xb)
    return f.reshape(shape)
