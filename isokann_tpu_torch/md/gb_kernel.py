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
- ``gb_force_tiled``: the kernel's order in tensor ops (32-atom tiles,
  each unordered pair once in a tile pair J >= I, strict upper on the
  diagonal, the lanes' rotating column sums, per-tile-pair partial sums
  added per atom in ascending tile order).  Its rounding is the CPU's;
  the CPU tests hold it to ``gb_force_plain`` and to the JAX package's
  upper-triangle kernel.
- ``gb_force``: the wrapper.  A CPU tensor takes the plain version; a
  CUDA tensor launches the kernel or raises.  ``gb_force.launches``
  counts the launches.
- ``force_flat_hybrid``: the kernel's forces plus the bonded terms (bonds,
  angles, torsions), as the reference's hybrid path; the bonded forces are
  analytic (``forces.bonded_force_flat``) where the reference takes them
  by autograd.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import langevin_kernel as LK
from .forces import bonded_force_flat
from .system import COULOMB, MDSystem

MAX_ATOMS = 640          # 20 tiles of 32 atoms
TILE = 32
WARPS = 8                # warps a block
SMEM_LIMIT = 232448      # dynamic shared memory of a block on an H100
OFFSET = 0.009           # OBC offset of the Born radii [nm]
EPS_SOLVENT = 78.5
PREF = -0.5 * COULOMB * (1.0 - 1.0 / EPS_SOLVENT)
SA = -6.0 * 28.3919551   # d/dB of the ACE surface term, per (r + 0.14)^2 r^6


class GBPlan:
    """Per-atom tables and the Coulomb scale grid of one system.

    ``tab`` (6, A) float32: q | Rmin/2 | sqrt(eps) | Born radius | offset
    radius | scaled radius (zeros and 0.15 nm radii without OBC2, as the
    reference plan); ``qq_scale`` (A, A) float32, symmetric, with a zero
    diagonal.  The values are computed in float32 numpy as the reference
    plan does; a float64 system's plan is float64 (its walkers take the
    plain version, the reference's float64 route being its XLA forces
    over the float64 system)."""

    def __init__(self, sys: MDSystem):
        A = sys.natoms
        self.A = A
        self.system = sys
        fdt = (np.float64 if sys.charges.dtype == torch.float64
               else np.float32)

        def f32(t):
            return np.asarray(t.detach().cpu().numpy(), fdt)

        q = f32(sys.charges)
        rmh = f32(sys.rmin_half)
        seps = np.sqrt(f32(sys.eps))
        self.use_gb = sys.implicit == "obc2"
        has_gb = self.use_gb and sys.gb_radii.shape[0] == A
        radii = (f32(sys.gb_radii) if has_gb
                 else np.full(A, 0.15, fdt))
        scales = f32(sys.gb_scales) if has_gb else np.zeros(A, fdt)
        orad = radii - fdt(OFFSET)
        self.tab = np.stack([q, rmh, seps, radii, orad, scales * orad]
                            ).astype(fdt)
        qq = np.asarray(f32(sys.qq_scale), fdt).copy()
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
                     qq=torch.as_tensor(self.qq_scale, device=device))
            self._dev[key] = d
        return self._dev[key]


# Per unordered pair {i, j}, the float operations the function needs, each
# transcendental (exp, log, tanh, rsqrt), division and comparison counted as
# one.  Once a pair: the geometry (3 differences, r^2, rsqrt, r) 10, and 12
# more under minimum image; the LJ + Coulomb coefficient 23 (33 with the
# reaction field); the force accumulation 9 (c d, -c d into atom i, +c d into
# atom j).  With OBC2 also, once a pair: the GB pair term's exp, f, f^-3 and
# their common product 16; the GB pair-energy derivative dE/dr^2 from those
# 11.  And once in each direction (i by j and j by i): the descreening
# integral with its (L, U, ln) terms and masks 30; the GB pair term's df/dB
# factor and sum 2; dI/dr from the (L, U, ln) terms 47 (dL 6, the
# polynomial 31, the engulfed correction 2, mask, g dI/dr / r and its sum
# into c 8).  That is 227 an unordered pair with OBC2 (113.5 an ordered
# pair), 52 in vacuum with the reaction field.  The CUDA kernel executes
# these, and with OBC2 recomputes the pair's r^2 in pass 2 (8, +12 under
# minimum image) and its d in pass 3 (3, +12): ``kernel_ops``.
# PR 7-10 counted the function per ordered pair, each symmetric term twice:
# 153 a pair with OBC2 (``step_ops(plan, ordered=True)``).
_GEOM, _GEOM_PBC = 10, 12
_NB, _NB_RF, _ACC2 = 23, 33, 9
_BORN, _GB_SYM, _GB_DIR, _GB_DR, _DI = 30, 16, 2, 11, 47
_R2_AGAIN, _D_AGAIN = 8, 3
_PER_ATOM = 40           # Born radius, dE/dB self terms, chain factor
# the ordered-pair count of PR 7-10: geometry, LJ/Coulomb, accumulation,
# Born term, GB pair term, dE/dr^2, dI/dr, transpose accumulation
_ORD_ACC, _ORD_GB_PAIR = 6, 20


def _pairs(plan: GBPlan) -> int:
    return plan.A * (plan.A - 1) // 2


def step_ops(plan: GBPlan, ordered: bool = False) -> float:
    """Float operations per walker per force evaluation that the function
    needs (see the per-pair constants above): 227 an unordered pair with
    OBC2, 52 in vacuum with the reaction field.  ``bound_ms`` uses it.
    ``ordered=True`` gives the count of PR 7-10 (153 an ordered pair with
    OBC2), kept so that their shares of bound stay comparable."""
    geom = _GEOM + (_GEOM_PBC if plan.box is not None else 0)
    nb = _NB_RF if plan.use_rf else _NB
    if ordered:
        pairs = plan.A * (plan.A - 1)
        if not plan.use_gb:
            return float(pairs * (geom + nb + _ORD_ACC))
        return float(pairs * (geom + nb + _ORD_ACC + _BORN + _ORD_GB_PAIR
                              + _GB_DR + _DI + _ORD_ACC)
                     + plan.A * _PER_ATOM)
    per_pair = geom + nb + _ACC2
    if not plan.use_gb:
        return float(_pairs(plan) * per_pair)
    per_pair += _GB_SYM + _GB_DR + 2 * (_BORN + _GB_DIR + _DI)
    return float(_pairs(plan) * per_pair + plan.A * _PER_ATOM)


def kernel_ops(plan: GBPlan) -> float:
    """Float operations per walker per force evaluation as the CUDA kernel
    executes them: ``step_ops`` plus, with OBC2, the pair's r^2 again in
    pass 2 and its d again in pass 3 (11 an unordered pair, 35 under
    minimum image); as ``step_ops`` in vacuum (one pass)."""
    again = 0
    if plan.use_gb:
        again = _R2_AGAIN + _D_AGAIN + (2 * _GEOM_PBC if plan.box is not None
                                        else 0)
    return step_ops(plan) + float(_pairs(plan) * again)


def tiles(plan: GBPlan) -> int:
    """32-atom tiles of the kernel's layout."""
    return -(-plan.A // TILE)


def smem_bytes(plan: GBPlan, cluster: int) -> int:
    """Shared memory of one block of the kernel (``csrc/gb_force.cu``):
    13 per-atom rows, and for each of its tile pairs 3 x 64 partial sums
    and, with OBC2, the 3 x 1024-float pair cache."""
    nt = tiles(plan)
    nslot = -(-(nt * (nt + 1) // 2) // cluster)
    return 4 * (13 * nt * TILE + nslot * 192
                + (nslot * 3 * TILE * TILE if plan.use_gb else 0))


def launch_shape(plan: GBPlan):
    """(cluster, warps): 8 warps a block, and the smallest cluster of 8 or
    16 blocks whose blocks fit in shared memory (measured on an H100:
    trp-cage runs fastest at 8 x 8 from B=1 to B=16384, villin needs 16)."""
    for cluster in (8, 16):
        if smem_bytes(plan, cluster) <= SMEM_LIMIT:
            return cluster, WARPS
    raise NotImplementedError(f"no gb_force launch shape for {plan.A} "
                              f"atoms")


def blocks(plan: GBPlan, nwalkers: int):
    """(blocks, clusters) the kernel launches for ``nwalkers`` walkers: one
    cluster a walker, of ``launch_shape(plan)[0]`` blocks."""
    return int(nwalkers) * launch_shape(plan)[0], int(nwalkers)


def bound_ms(plan: GBPlan, nwalkers: int, ordered: bool = False):
    """Least time on an H100 for one force evaluation of ``nwalkers``
    walkers, and what bounds it: operations (``step_ops``) over the FP32
    peak, or the coordinates read and the forces written once, with the
    tables and the scale grid read once, over the memory rate."""
    ops = step_ops(plan, ordered) * nwalkers
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


def _pair_w(plan: GBPlan, r, inv_r, inv_r2, qq, rmin, epsij, qsc):
    """LJ + Coulomb (+ reaction field) coefficient w of pairs, with the
    LJ scale derived from the Coulomb scale ``qsc``."""
    x6 = (rmin * rmin * inv_r2) ** 3
    lsc = torch.where(qsc == 0.0, 0.0, torch.where(qsc >= 0.999, 1.0, 0.5))
    g_lj = 6.0 * epsij * (x6 - x6 * x6) * inv_r2
    g_c_plain = qq * (-0.5) * inv_r2 * inv_r
    if not plan.use_rf:
        return 2.0 * (lsc * g_lj + qsc * g_c_plain)
    dt = r.dtype
    within = (r < plan.cutoff).to(dt)
    full = (qsc >= 0.999).to(dt)
    one4 = ((qsc > 0) & (qsc < 0.999)).to(dt)
    l_full = (lsc >= 0.999).to(dt)
    l_one4 = ((lsc > 0) & (lsc < 0.999)).to(dt)
    return 2.0 * (g_lj * (l_full * within + l_one4 * lsc)
                  + qq * ((-0.5 * inv_r2 * inv_r + plan.krf) * within * full)
                  + g_c_plain * one4 * qsc)


def _lu_descreen(r, inv_r, srj, orad_i):
    """The descreening integral I_ij of atom i (offset radius ``orad_i``)
    by atom j (scaled radius ``srj``), before the activity mask, with its
    (1/L, 1/U, ln(L/U)) terms."""
    L = torch.maximum(torch.abs(r - srj), orad_i)
    U = r + srj
    rLU = 1.0 / (L * U)
    invL, invU = U * rLU, L * rLU
    lnLU = torch.log(L * invU)
    I = 0.5 * (invL - invU + 0.25 * (r - srj ** 2 * inv_r)
               * (invU ** 2 - invL ** 2) + 0.5 * lnLU * inv_r)
    I = I + torch.where(orad_i < srj - r, 2.0 * (1.0 / orad_i - invL), 0.0)
    return I, invL, invU, lnLU


def _descreen(r, inv_r, inv_r2, srj, orad_i):
    """I_ij and dI_ij/dr / r, 0 where the pair is inactive."""
    I, invL, invU, lnLU = _lu_descreen(r, inv_r, srj, orad_i)
    D = _dI_dr(r, inv_r, inv_r2, srj, orad_i, invL, invU, lnLU) * inv_r
    act = (r + srj > orad_i) & (srj > 1e-8)
    return torch.where(act, I, 0.0), torch.where(act, D, 0.0)


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
        I, invL, invU, lnLU = _lu_descreen(r, inv_r, srj, orad_c)
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
    w = _pair_w(plan, r, inv_r, inv_r2, COULOMB * col["q"] * row["q"],
                col["rmh"] + row["rmh"], col["seps"] * row["seps"],
                tb["qq"]) * offd

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
# The kernel's order in tensor ops (test-facing)
# ==========================================================================

def tile_pairs(plan: GBPlan):
    """The kernel's tile pairs (I, J), J >= I, in row-major order of the
    upper triangle (tile pair t runs on block t mod cluster)."""
    nt = tiles(plan)
    return [(i, j) for i in range(nt) for j in range(i, nt)]


def gb_force_tiled(plan: GBPlan, x):
    """Nonbonded (+ OBC2) forces, (B, 3A) -> (B, 3A), in the CUDA kernel's
    order: in tile pair (I, J) lane l owns row atom 32 I + l and at step k
    meets column atom 32 J + (l + k) mod 32 (pairs with i < j only on the
    diagonal), its row sum adding over k and its column sums travelling
    with their columns one lane down a step; each atom then adds the
    partial sums of the tile pairs that hold its tile in ascending order
    of the other tile (row, then column partial on the diagonal).  The
    pair arithmetic and the pass structure are the kernel's (the pair
    cache between the passes included)."""
    tb = plan.on(x.device)
    Bn, A, T = x.shape[0], plan.A, TILE
    nt = tiles(plan)
    Ap = nt * T
    dev, dt = x.device, x.dtype
    pairs_ij = tile_pairs(plan)
    index = {ij: t for t, ij in enumerate(pairs_ij)}
    tI = torch.tensor([i for i, _ in pairs_ij], device=dev)
    tJ = torch.tensor([j for _, j in pairs_ij], device=dev)
    lane = torch.arange(T, device=dev)

    def padded(v, fill):
        out = torch.full((Ap,), fill, dtype=dt, device=dev)
        out[:A] = v
        return out

    q, rmh, seps = (padded(tb[n], 0.0) for n in ("q", "rmh", "seps"))
    rad, orad = padded(tb["radii"], 1.0), padded(tb["orad"], 1.0)
    sr = padded(tb["sr"], 0.0)
    qq = torch.zeros(Ap, Ap, dtype=dt, device=dev)
    qq[:A, :A] = tb["qq"]
    X = torch.zeros(Bn, Ap, 3, dtype=dt, device=dev)
    X[:, :A] = x.reshape(Bn, A, 3)
    rows = tI[:, None] * T + lane[None]                   # (ntp, 32)
    diag = (tI == tJ)[:, None]
    box = (torch.tensor(plan.box, dtype=dt, device=dev)
           if plan.box is not None else None)

    def step(k):
        """Column atoms of step k, whether each pair counts, and d."""
        c = (lane + k) % T
        j = tJ[:, None] * T + c[None]
        ok = (rows < A) & (j < A) & (~diag | (c[None] > lane[None]))
        d = X[:, rows] - X[:, j]                           # (B, ntp, 32, 3)
        if box is not None:
            d = d - box * torch.round(d * (1.0 / box))
        return j, ok.expand(Bn, -1, -1), d

    def r2_of(d, ok):
        r2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] \
            + d[..., 2] * d[..., 2]
        return torch.where(ok, r2, 1.0)

    def sweep(pair_fn, nq):
        """Row and column partial sums (nq, B, ntp, 32) of pair_fn(k),
        which returns nq (row, column) contributions of step k."""
        row = torch.zeros(nq, Bn, len(pairs_ij), T, dtype=dt, device=dev)
        col = torch.zeros_like(row)
        for k in range(T):
            rk, ck = pair_fn(k)
            row = row + rk
            col = torch.roll(col + ck, -1, dims=-1)
        return row, col

    def gather(row, col):
        """(nq, B, Ap) per-atom sums in ascending tile order."""
        out = torch.zeros(row.shape[0], Bn, Ap, dtype=dt, device=dev)
        for Tt in range(nt):
            acc = torch.zeros(row.shape[0], Bn, T, dtype=dt, device=dev)
            for U in range(nt):
                t = index[(min(U, Tt), max(U, Tt))]
                if U < Tt:
                    acc = acc + col[:, :, t]
                elif U == Tt:
                    acc = acc + row[:, :, t]
                    acc = acc + col[:, :, t]
                else:
                    acc = acc + row[:, :, t]
            out[:, :, Tt * T:(Tt + 1) * T] = acc
        return out

    cache = {}
    if plan.use_gb:
        # ---- pass 1: descreening sums; the pair cache -------------------
        def born(k):
            j, ok, d = step(k)
            r2 = r2_of(d, ok)
            inv_r = torch.rsqrt(r2)
            r, inv_r2 = r2 * inv_r, inv_r * inv_r
            w = _pair_w(plan, r, inv_r, inv_r2, COULOMB * q[rows] * q[j],
                        rmh[rows] + rmh[j], seps[rows] * seps[j],
                        qq[rows, j])
            Iij, Dij = _descreen(r, inv_r, inv_r2, sr[j], orad[rows])
            Iji, Dji = _descreen(r, inv_r, inv_r2, sr[rows], orad[j])
            cache[k] = [torch.where(ok, v, 0.0) for v in (Dij, Dji, w)]
            return (torch.where(ok, Iij, 0.0)[None],
                    torch.where(ok, Iji, 0.0)[None])

        Ii = gather(*sweep(born, 1))[0]
        psi = Ii * orad
        th = torch.tanh(psi - 0.8 * psi ** 2 + 4.85 * psi ** 3)
        Bv = torch.maximum(1.0 / (1.0 / orad - th / rad), orad)
        dBdpsi = Bv * Bv * (1.0 - th * th) * (1.0 - 1.6 * psi
                                               + 14.55 * psi ** 2) / rad
        real = torch.arange(Ap, device=dev) < A
        Bv = torch.where(real, Bv, 1.0)
        invB = torch.where(real, 1.0 / Bv, 1.0)

        # ---- pass 2: dE/dB sums; w + 2 dE/dr^2 into the cache -----------
        def gb_pair(k):
            j, ok, d = step(k)
            r2 = r2_of(d, ok)
            Bi, Bj = Bv[:, rows], Bv[:, j]
            t = r2 * (0.25 * invB[:, rows]) * invB[:, j]
            expo = torch.exp(-t)
            rsf = torch.rsqrt(r2 + Bi * Bj * expo)
            pq = PREF * (q[rows] * q[j]) * (-0.5) * (rsf * rsf * rsf)
            base = torch.where(ok, pq * expo * (1.0 + t), 0.0)
            cache[k][2] = cache[k][2] + torch.where(
                ok, 2.0 * (2.0 * pq * (1.0 - expo / 4.0)), 0.0)
            return (base * Bj)[None], (base * Bi)[None]

        acc = gather(*sweep(gb_pair, 1))[0]
        ra, r3 = rad + 0.14, rad ** 3
        dEdB = (PREF * (-(q ** 2) * invB * invB)
                + SA * (ra * ra) * (r3 * r3) * (invB ** 6 * invB))
        dEdB = dEdB + 2.0 * acc
        g = torch.where(real, dEdB * dBdpsi * orad, 0.0)

    # ---- pass 3: forces ----------------------------------------------------
    def force(k):
        j, ok, d = step(k)
        if plan.use_gb:
            Dij, Dji, w = cache[k]
            c = w + g[:, rows] * Dij + g[:, j] * Dji
        else:
            r2 = r2_of(d, ok)
            inv_r = torch.rsqrt(r2)
            c = _pair_w(plan, r2 * inv_r, inv_r, inv_r * inv_r,
                        COULOMB * q[rows] * q[j], rmh[rows] + rmh[j],
                        seps[rows] * seps[j], qq[rows, j])
        e = torch.where(ok[..., None], c[..., None] * d, 0.0)
        e = e.permute(3, 0, 1, 2)
        return -e, e

    F = gather(*sweep(force, 3))                           # (3, B, Ap)
    return F.permute(1, 2, 0)[:, :A].reshape(Bn, 3 * A)


# ==========================================================================
# Wrapper: plain version on the CPU, the kernel on the card
# ==========================================================================

class GBForce(LK.CudaKernel):
    """``gb_force(plan, x)``: (B, 3A) -> (B, 3A) nonbonded (+ OBC2)
    forces, launched at ``launch_shape(plan)``."""

    name, source = "gb_force", "gb_force.cu"

    def _declare(self, lib):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.gb_force.argtypes = ([p, p, i, i, p, p, i, i, f, f, f, f, i]
                                 + [f] * 6 + [i, i, p])
        lib.gb_force.restype = i
        lib.gb_force_max_clusters.argtypes = [i, i, i, i]
        lib.gb_force_max_clusters.restype = i

    def max_clusters(self, plan: GBPlan) -> int:
        """Clusters the card holds at once at this plan's launch shape
        (CUDA's occupancy query; needs the card)."""
        return self.lib().gb_force_max_clusters(
            plan.A, int(plan.use_gb), *launch_shape(plan))

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
            tb["tab"].data_ptr(), tb["qq"].data_ptr(), int(plan.use_gb),
            int(plan.use_rf), plan.cutoff, plan.krf, COULOMB, PREF,
            int(plan.box is not None), bx, by, bz, 1.0 / bx, 1.0 / by,
            1.0 / bz, *launch_shape(plan), stream)
        self._raise(err, "gb_force")
        self.launches += 1
        return f


gb_force = GBForce()


def force_flat_hybrid(plan: GBPlan, xflat, plain: bool = False):
    """Full force on flat coordinates (..., 3A): ``gb_force`` (its plain
    version with ``plain``, as a float64 simulation asks) for the
    nonbonded (+ OBC2) part plus the analytic bonded forces."""
    shape = xflat.shape
    xb = xflat.reshape(-1, shape[-1])
    f = ((gb_force_plain if plain else gb_force)(plan, xb)
         + bonded_force_flat(plan.system, xb))
    return f.reshape(shape)
