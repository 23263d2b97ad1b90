"""Whole LangevinMiddle trajectories: the hand-written CUDA kernel, its
plain PyTorch version, and the wrappers that choose between them.

Counterpart of ``isokann_tpu/md/pallas_md.py:langevin_middle_fused`` (the
TPU kernel, with ``make_force_parts`` and ``_atan2``).  The CUDA source is
``csrc/langevin_middle.cu``; its header states the design and the bound.

- ``LangevinPlan``: the term tables (indices and parameters) and the
  integrator constants, built once from an ``MDSystem``.
- ``forces_plain`` / ``langevin_middle_plain``: the same arithmetic in
  tensor ops.  The CPU tests use them; on the card they are the reference
  the kernel is held against.
- ``forces_gather``: the kernel's force routine in tensor ops, in its
  order and with its formulas (1/r from a reciprocal square root): each
  atom's nonbonded force gathered over its partners through the dense
  pair table, then its bonded slots through its list.  Its rounding is
  the CPU's, not the card's (``rsqrtf`` is within 2 ulp, fused
  multiply-adds round once).  The CPU tests hold it to ``forces_plain``
  and to the JAX package.
- ``forces`` / ``langevin_middle``: the wrappers.  A CPU tensor takes the
  plain version; a CUDA tensor launches the kernel or raises.  Each
  wrapper counts its kernel launches in ``.launches``.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from .integrators import KB
from .system import COULOMB, MDSystem

MAX_ATOMS = 64          # the kernel's lanes own <= 2 atoms each
WARPS_PER_BLOCK = 4     # walkers per block of the kernel, one warp each
H100_FP32_PEAK = 67e12  # FLOP/s outside the tensor cores, H100 SXM, 700 W
H100_HBM_BYTES_PER_S = 3.35e12
# natoms np nb na nd use_rf | rc krf | periodic | bx by bz
GEOMETRY_ARGTYPES = [ctypes.c_int] * 6 + [ctypes.c_float] * 2 + [
    ctypes.c_int] + [ctypes.c_float] * 3


class LangevinPlan:
    """Term tables and integrator constants for one system.

    Host-side numpy tables, moved to a device on first use there:
    - ``itab`` (int32): pairs i<j (2 np) | bonds (2 nb) | angles (3 na) |
      torsions (4 nd);
    - ``ftab`` (float32, or float64 for a float64 system, whose walkers
      take the plain version): per pair qq, eps, rmin, full (np each; exclusion
      and 1-4 scales folded in) | bond k, r0 | angle k, theta0 | torsion
      pk, phase, n | 1/m per coordinate (3N) | sqrt(kB T/m) (3N);
    - ``dense`` (float32, (N, N, 4)): the pair table of kernel A, row j
      column i the (qq, eps, rmin, full) of the pair {i, j}, zero on the
      diagonal;
    - ``slot_atom`` (nslot,) and ``atom_slots`` (int32, (N, K)): kernel A
      writes each bonded term's per-atom contributions to slots (a bond's
      a, b; an angle's a, b, c; a torsion's i, j, k, l; terms in itab
      order), and sums atom a's slots in the order of row a, padded with
      the zero slot ``nslot``.
    """

    def __init__(self, sys: MDSystem, T: float, gamma: float, dt: float):
        n = sys.natoms
        self.natoms = n
        self.T, self.gamma, self.dt = float(T), float(gamma), float(dt)
        self.a = math.exp(-gamma * dt)
        self.b = math.sqrt(1.0 - self.a * self.a)

        iu, ju = np.triu_indices(n, k=1)
        q = sys.charges.detach().cpu().double().numpy()
        rmh = sys.rmin_half.detach().cpu().double().numpy()
        eps = sys.eps.detach().cpu().double().numpy()
        qqs = sys.qq_scale.detach().cpu().double().numpy()
        ljs = sys.lj_scale.detach().cpu().double().numpy()
        m = sys.masses.detach().cpu().double().numpy()

        def cpu(t):
            return t.detach().cpu().numpy()

        self.pairs = np.stack([iu, ju], axis=1).astype(np.int64)
        self.bonds = cpu(sys.bond_idx).astype(np.int64)
        self.angles = cpu(sys.angle_idx).astype(np.int64)
        self.dihs = cpu(sys.dih_idx).astype(np.int64)
        self.np, self.nb = len(self.pairs), len(self.bonds)
        self.na, self.nd = len(self.angles), len(self.dihs)

        self.nb_qq = COULOMB * q[iu] * q[ju] * qqs[iu, ju]
        self.nb_eps = np.sqrt(eps[iu] * eps[ju]) * ljs[iu, ju]
        self.nb_rmin = rmh[iu] + rmh[ju]
        self.nb_full = (qqs[iu, ju] >= 0.999).astype(np.float64)
        m3 = np.repeat(m, 3)
        self.minv = 1.0 / m3
        self.vstd = np.sqrt(KB * self.T / m3)

        self.use_rf = sys.method != "NoCutoff"
        rc = float(sys.cutoff)
        self.rc = rc
        self.krf = ((1.0 / rc ** 3) * (sys.eps_rf - 1.0)
                    / (2 * sys.eps_rf + 1.0)) if self.use_rf else 0.0
        self.box = (tuple(float(b) for b in sys.box)
                    if sys.method == "CutoffPeriodic" and sys.box is not None
                    else None)

        self.itab = np.concatenate([self.pairs.ravel(), self.bonds.ravel(),
                                    self.angles.ravel(), self.dihs.ravel()]
                                   ).astype(np.int32)
        segments = [("qq", self.nb_qq), ("eps", self.nb_eps),
                    ("rmin", self.nb_rmin), ("full", self.nb_full),
                    ("bk", cpu(sys.bond_k)), ("br0", cpu(sys.bond_r0)),
                    ("ak", cpu(sys.angle_k)), ("at0", cpu(sys.angle_t0)),
                    ("pk", cpu(sys.dih_pk)), ("phase", cpu(sys.dih_phase)),
                    ("dn", cpu(sys.dih_n)), ("minv", self.minv),
                    ("vstd", self.vstd)]
        fdt = (np.float64 if sys.charges.dtype == torch.float64
               else np.float32)
        self.ftab = np.concatenate([a for _, a in segments]).astype(fdt)

        dense = np.zeros((n, n, 4), fdt)
        for k, a in enumerate((self.nb_qq, self.nb_eps, self.nb_rmin,
                               self.nb_full)):
            dense[ju, iu, k] = dense[iu, ju, k] = a.astype(fdt)
        self.dense = dense
        self.slot_atom = np.concatenate([self.bonds.ravel(),
                                         self.angles.ravel(),
                                         self.dihs.ravel()]).astype(np.int64)
        self.nslot = len(self.slot_atom)
        lists = [np.flatnonzero(self.slot_atom == a) for a in range(n)]
        self.K = max((len(x) for x in lists), default=0)
        self.atom_slots = np.full((n, self.K), self.nslot, np.int32)
        for a, x in enumerate(lists):
            self.atom_slots[a, :len(x)] = x
        bounds = np.cumsum([0] + [len(a) for _, a in segments])
        self._slices = {name: slice(int(bounds[k]), int(bounds[k + 1]))
                        for k, (name, _) in enumerate(segments)}
        self._dev = {}

    @property
    def dim(self):
        return 3 * self.natoms

    def on(self, device) -> dict:
        """All tables as tensors on ``device`` (built once per device)."""
        device = torch.device(device)
        key = str(device)
        if key not in self._dev:
            ftab = torch.as_tensor(self.ftab, device=device)
            tabs = {name: ftab[sl] for name, sl in self._slices.items()}
            tabs.update(
                itab=torch.as_tensor(self.itab, device=device), ftab=ftab,
                dense=torch.as_tensor(self.dense, device=device),
                atom_slots=torch.as_tensor(self.atom_slots, device=device),
                pairs=torch.as_tensor(self.pairs, device=device),
                bonds=torch.as_tensor(self.bonds, device=device),
                angles=torch.as_tensor(self.angles, device=device),
                dihs=torch.as_tensor(self.dihs, device=device))
            self._dev[key] = tabs
        return self._dev[key]

    def geometry_args(self):
        """The scalar arguments shared by the C entry points that take the
        force field (``GEOMETRY_ARGTYPES``)."""
        bx, by, bz = self.box if self.box is not None else (1.0, 1.0, 1.0)
        return [ctypes.c_int(self.natoms), ctypes.c_int(self.np),
                ctypes.c_int(self.nb), ctypes.c_int(self.na),
                ctypes.c_int(self.nd), ctypes.c_int(int(self.use_rf)),
                ctypes.c_float(self.rc), ctypes.c_float(self.krf),
                ctypes.c_int(int(self.box is not None)),
                ctypes.c_float(bx), ctypes.c_float(by), ctypes.c_float(bz)]


def step_ops(plan: LangevinPlan) -> float:
    """Float operations per walker per MD step: the vector part of
    ``isokann_tpu/utils/flops.py:fused_md_flops`` (its per-row tallies of
    the same force field), without the TPU's difference-operator matmuls.
    Pair row ~36 (+9 minimum image), bond ~14, angle ~60, torsion ~130,
    integrator + noise ~20 per coordinate row (3N padded to 8)."""
    r3 = ((plan.dim + 7) // 8) * 8
    return float(plan.np * (36 + (9 if plan.box is not None else 0))
                 + plan.nb * 14 + plan.na * 60 + plan.nd * 130 + r3 * 20)


def kernel_ops(plan: LangevinPlan) -> float:
    """Float operations per walker per MD step that kernel A executes:
    ``step_ops`` with each pair computed a second time (the gather takes
    each ordered pair, from both atoms' sides) and 3 additions per bonded
    slot (each atom's list)."""
    pair = 36 + (9 if plan.box is not None else 0)
    return step_ops(plan) + float(plan.np * pair + 3 * plan.nslot)


def blocks(nwalkers: int) -> int:
    """Blocks kernel A starts for ``nwalkers`` walkers (one warp each)."""
    return -(-int(nwalkers) // WARPS_PER_BLOCK)


def bound_ms(plan: LangevinPlan, nwalkers: int, nsteps: int):
    """Least time on an H100 for ``nsteps`` steps of ``nwalkers`` walkers,
    and what bounds it: operations over the FP32 peak, or x and v read
    and written once (plus the tables) over the memory rate."""
    ops = step_ops(plan) * nwalkers * nsteps
    nbytes = 4 * 4 * nwalkers * plan.dim + plan.itab.nbytes + plan.ftab.nbytes
    t_ops, t_bytes = ops / H100_FP32_PEAK, nbytes / H100_HBM_BYTES_PER_S
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def forces_bound_ms(plan: LangevinPlan, nwalkers: int):
    """Least time on an H100 for the forces entry on ``nwalkers``
    walkers, and what bounds it: the force field's operations
    (``step_ops`` without the integrator's) over the FP32 peak, or x read
    and the forces written once (plus the tables) over the memory
    rate."""
    r3 = ((plan.dim + 7) // 8) * 8
    ops = (step_ops(plan) - r3 * 20) * nwalkers
    nbytes = 2 * 4 * nwalkers * plan.dim + plan.itab.nbytes + plan.ftab.nbytes
    t_ops, t_bytes = ops / H100_FP32_PEAK, nbytes / H100_HBM_BYTES_PER_S
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


# ==========================================================================
# Plain PyTorch version (same arithmetic as the kernel, in tensor ops)
# ==========================================================================

def pair_delta(plan: LangevinPlan, X):
    """Pair rows i < j of (B, N, 3) positions: d = x_i - x_j (B, np, 3),
    minimum-imaged when periodic, and r^2 + 1e-12 (B, np)."""
    tb = plan.on(X.device)
    d = (X.index_select(1, tb["pairs"][:, 0])
         - X.index_select(1, tb["pairs"][:, 1]))
    if plan.box is not None:
        box = torch.tensor(plan.box, dtype=X.dtype, device=X.device)
        d = d - box * torch.round(d * (1.0 / box))
    return d, torch.sum(d * d, dim=-1) + 1e-12


def _pair_forces(plan: LangevinPlan, d, r2, qq, eps, rmin, full,
                 rsqrt=False):
    """-dE/dd of pair rows (..., 3) from d = x_i - x_j, r^2 + 1e-12 and the
    pair parameters: the TPU body's LJ + Coulomb, reaction field inside
    the cutoff for unscaled pairs.  ``rsqrt`` takes 1/r from a reciprocal
    square root, as kernel A does, instead of a division and a sqrt; the
    cutoff is drawn on sqrt(r^2) either way."""
    r = torch.sqrt(r2)
    if rsqrt:
        inv_r = torch.rsqrt(r2)
        inv_r2 = inv_r * inv_r
        g_c = qq * (-0.5 * inv_r2 * inv_r)
    else:
        inv_r2 = 1.0 / r2
        g_c = qq * (-0.5 * inv_r2 / r)
    x6 = (rmin * rmin * inv_r2) ** 3
    g_lj = 6.0 * eps * (x6 - x6 * x6) * inv_r2
    if plan.use_rf:
        w = (r < plan.rc).to(d.dtype)
        rf = full > 0
        g_c = torch.where(rf, (g_c + qq * plan.krf) * w, g_c)
        g_lj = torch.where(rf, g_lj * w, g_lj)
    return -(2.0 * (g_lj + g_c))[..., None] * d


def _bonded_terms(plan: LangevinPlan, X):
    """Per-term contributions of the bonded terms of (B, N, 3) positions,
    each its term's per-atom force (B, T, 3), by the kernel's formulas:
    ``(bond a, bond b, angle a, angle b, angle c, torsion i, j, k, l)``."""
    tb = plan.on(X.device)
    a, b = tb["bonds"][:, 0], tb["bonds"][:, 1]
    d = X.index_select(1, a) - X.index_select(1, b)
    rb = torch.sqrt(torch.sum(d * d, dim=-1) + 1e-12)
    g = (2.0 * tb["bk"] * (rb - tb["br0"]) / rb)[..., None] * d
    bond = (-g, g)

    a, b, c = tb["angles"].unbind(1)
    u = X.index_select(1, a) - X.index_select(1, b)
    v = X.index_select(1, c) - X.index_select(1, b)
    uu = torch.sum(u * u, dim=-1) + 1e-12
    vv = torch.sum(v * v, dim=-1) + 1e-12
    uv = torch.sum(u * v, dim=-1)
    inv_norm = torch.rsqrt(uu * vv)
    cs = torch.clamp(uv * inv_norm, -1.0 + 1e-7, 1.0 - 1e-7)
    sn = torch.sqrt(1.0 - cs * cs)
    coef = -2.0 * tb["ak"] * (torch.arccos(cs) - tb["at0"]) / sn
    cu = (coef * inv_norm)[..., None]
    gu = cu * v - (coef * cs / uu)[..., None] * u
    gv = cu * u - (coef * cs / vv)[..., None] * v
    angle = (-gu, gu + gv, -gv)

    i, j, k, l = tb["dihs"].unbind(1)
    b1 = X.index_select(1, j) - X.index_select(1, i)
    b2 = X.index_select(1, k) - X.index_select(1, j)
    b3 = X.index_select(1, l) - X.index_select(1, k)
    n1 = torch.cross(b1, b2, dim=-1)
    n2 = torch.cross(b2, b3, dim=-1)
    n1sq = torch.sum(n1 * n1, dim=-1) + 1e-12
    n2sq = torch.sum(n2 * n2, dim=-1) + 1e-12
    b2sq = torch.sum(b2 * b2, dim=-1) + 1e-12
    b2n = torch.sqrt(b2sq)
    m1 = torch.cross(n1, b2, dim=-1) / b2n[..., None]
    phi = torch.atan2(torch.sum(m1 * n2, dim=-1), torch.sum(n1 * n2, dim=-1))
    dE = -tb["pk"] * tb["dn"] * torch.sin(tb["dn"] * phi - tb["phase"])
    g1 = (-b2n / n1sq * dE)[..., None] * n1
    g3 = (-b2n / n2sq * dE)[..., None] * n2
    p12 = (torch.sum(b1 * b2, dim=-1) / b2sq)[..., None]
    p32 = (torch.sum(b3 * b2, dim=-1) / b2sq)[..., None]
    g2 = -p12 * g1 - p32 * g3
    return bond + angle + (g1, g2 - g1, g3 - g2, -g3)


def forces_plain(plan: LangevinPlan, x):
    """Forces (B, 3N) -> (B, 3N) by the kernel's per-term formulas."""
    tb = plan.on(x.device)
    B = x.shape[0]
    X = x.reshape(B, plan.natoms, 3)
    F = torch.zeros_like(X)

    d, r2 = pair_delta(plan, X)
    g = _pair_forces(plan, d, r2, tb["qq"], tb["eps"], tb["rmin"],
                     tb["full"])
    F.index_add_(1, tb["pairs"][:, 0], g)
    F.index_add_(1, tb["pairs"][:, 1], -g)

    terms = _bonded_terms(plan, X)
    b, a, t = tb["bonds"], tb["angles"], tb["dihs"]
    atoms = (b[:, 0], b[:, 1], a[:, 0], a[:, 1], a[:, 2],
             t[:, 0], t[:, 1], t[:, 2], t[:, 3])
    # the order of the one-thread-per-walker kernel: angle a, c, then b
    order = (0, 1, 2, 4, 3, 5, 6, 7, 8)
    for k in order:
        F.index_add_(1, atoms[k], terms[k])
    return F.reshape(B, plan.dim)


def forces_gather(plan: LangevinPlan, x):
    """Forces (B, 3N) -> (B, 3N) in kernel A's order and with its pair
    formulas: atom i's nonbonded force summed over partners j = 0..N-1
    through the dense pair table (each pair from both sides, 1/r from
    ``rsqrt``), then its bonded slots in the order of ``atom_slots``."""
    tb = plan.on(x.device)
    B, n = x.shape[0], plan.natoms
    X = x.reshape(B, n, 3)
    F = torch.zeros_like(X)
    box = (torch.tensor(plan.box, dtype=X.dtype, device=X.device)
           if plan.box is not None else None)
    not_self = torch.ones(n, 1, dtype=torch.bool, device=X.device)
    for j in range(n):
        d = X - X[:, j:j + 1]
        if box is not None:
            d = d - box * torch.round(d * (1.0 / box))
        r2 = torch.sum(d * d, dim=-1) + 1e-12
        qq, eps, rmin, full = tb["dense"][j].unbind(-1)
        g = _pair_forces(plan, d, r2, qq, eps, rmin, full, rsqrt=True)
        not_self[j] = False
        F = F + torch.where(not_self, g, 0.0)
        not_self[j] = True
    terms = _bonded_terms(plan, X)
    slots = torch.cat([torch.stack(terms[0:2], dim=2).reshape(B, -1, 3),
                       torch.stack(terms[2:5], dim=2).reshape(B, -1, 3),
                       torch.stack(terms[5:9], dim=2).reshape(B, -1, 3),
                       X.new_zeros(B, 1, 3)], dim=1)
    G = slots[:, tb["atom_slots"].long()]            # (B, N, K, 3)
    for k in range(plan.K):
        F = F + G[:, :, k]
    return F.reshape(B, plan.dim)


def langevin_middle_plain(plan: LangevinPlan, x, v, nsteps: int,
                          gen: torch.Generator = None, noise: bool = True,
                          walker_offset: int = 0):
    """``nsteps`` LangevinMiddle steps with ``forces_plain``; returns new
    (x, v).  Noise is drawn from ``gen`` on the host (its stream differs
    from the kernel's Philox stream by design).

    A walker-sharded launch passes its rows as a ``_device.WalkerShard``
    generator: the host draws each step's normals for the whole batch and
    keeps these rows, so that they get what one launch of the whole batch
    gives them, as the kernel's Philox subsequence is the global walker.
    ``walker_offset`` (the kernel's argument) must then be the shard's
    start; a nonzero offset without a ``WalkerShard`` raises, since the
    whole batch is not known."""
    from .._device import WalkerShard, randn
    if _shard_offset(gen, walker_offset) and not isinstance(gen,
                                                            WalkerShard):
        raise ValueError("a nonzero walker_offset needs a WalkerShard "
                         "generator (the whole batch) in the plain version")
    tb = plan.on(x.device)
    minv, vstd = tb["minv"], tb["vstd"]
    dt, h = plan.dt, 0.5 * plan.dt
    for _ in range(int(nsteps)):
        v = v + dt * forces_plain(plan, x) * minv
        x = x + h * v
        v = plan.a * v
        if noise:
            z = randn(gen, v.shape, v.dtype, torch.device("cpu"))
            v = v + plan.b * vstd * z.to(v.device)
        x = x + h * v
    return x, v


# ==========================================================================
# Wrappers: plain version on the CPU, the kernel on the card
# ==========================================================================

def _shard_offset(gen, walker_offset: int) -> int:
    """The global index of a launch's first walker: a ``WalkerShard``'s
    start (``walker_offset`` must be 0 or that start), else
    ``walker_offset`` (>= 0)."""
    from .._device import WalkerShard
    if isinstance(gen, WalkerShard):
        if walker_offset not in (0, gen.start):
            raise ValueError(f"walker_offset {walker_offset} is not the "
                             f"WalkerShard's start {gen.start}")
        return gen.start
    if walker_offset < 0:
        raise ValueError(f"walker_offset {walker_offset} < 0")
    return int(walker_offset)


def _check(x, plan, name):
    if x.dtype != torch.float32 or x.dim() != 2 or x.shape[1] != plan.dim:
        raise ValueError(f"{name}: expected float32 (B, {plan.dim}), got "
                         f"{tuple(x.shape)} {x.dtype}")


def _check_card(x, plan, name):
    """The kernel runs on a CUDA tensor of a float32 system of <= 64
    atoms."""
    if x.device.type != "cuda":
        raise NotImplementedError(f"no {name} kernel for {x.device}")
    if plan.ftab.dtype != np.float32:
        raise ValueError(f"the {name} kernel takes a float32 plan, not "
                         f"{plan.ftab.dtype}: run the plain version")
    if plan.natoms > MAX_ATOMS:
        raise NotImplementedError(f"the {name} kernel takes <= {MAX_ATOMS} "
                                  f"atoms, not {plan.natoms}")


def _table_args(plan: LangevinPlan, tb: dict):
    """Kernel A's table pointers: itab, ftab, the dense pair table, the
    per-atom slot lists and their width K."""
    return [tb["itab"].data_ptr(), tb["ftab"].data_ptr(),
            tb["dense"].data_ptr(), tb["atom_slots"].data_ptr(),
            ctypes.c_int(plan.K)]


class CudaKernel:
    """A lazily built ``csrc`` library (``name``, ``source``) and the launch
    counter of one of its entry points.  Subclasses declare the C
    signatures in ``_declare``."""

    name = source = None

    def __init__(self):
        self.launches = 0
        self.build_seconds = 0.0
        self._lib = None

    def lib(self):
        if self._lib is None:
            from .._build import load_library
            lib, self.build_seconds = load_library(self.name, self.source)
            self._declare(lib)
            self._lib = lib
        return self._lib

    def _declare(self, lib):
        raise NotImplementedError

    @staticmethod
    def _raise(err, name):
        if err != 0:
            raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")


class _LangevinLib(CudaKernel):
    """``langevin_middle.cu``: ``lm_forces`` and ``lm_langevin_middle``."""

    name, source = "langevin_middle", "langevin_middle.cu"

    def _declare(self, lib):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.lm_forces.argtypes = [p, p, i, p, p, p, p, i] + \
            GEOMETRY_ARGTYPES + [p]
        lib.lm_forces.restype = i
        lib.lm_langevin_middle.argtypes = (
            [p, p, i, p, p, p, p, i] + GEOMETRY_ARGTYPES
            + [i, ctypes.c_ulonglong, ctypes.c_ulonglong, i, f, f, f, p])
        lib.lm_langevin_middle.restype = i


class Forces(_LangevinLib):
    """``forces(plan, x)``: (B, 3N) -> (B, 3N)."""

    def __call__(self, plan: LangevinPlan, x):
        _check(x, plan, "forces")
        if x.device.type == "cpu":
            return forces_plain(plan, x)
        _check_card(x, plan, "forces")
        lib = self.lib()
        x = x.contiguous()
        f = torch.empty_like(x)
        tb = plan.on(x.device)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.lm_forces(x.data_ptr(), f.data_ptr(), x.shape[0],
                            *_table_args(plan, tb), *plan.geometry_args(),
                            stream)
        self._raise(err, "forces")
        self.launches += 1
        return f


class LangevinMiddle(_LangevinLib):
    """``langevin_middle(plan, x, v, nsteps, gen, noise=True,
    walker_offset=0)`` -> (x, v).

    The kernel's Philox seed is drawn from ``gen``; the same generator
    state gives the same bits.  Walker w of the launch draws the noise of
    subsequence ``walker_offset`` + w, so that the ranks of a walker-
    sharded batch (each launching its rows with the same seed) draw what
    one launch of the whole batch draws, bit for bit.  A
    ``_device.WalkerShard`` generator brings its start as the offset (and
    the whole batch, which the plain version's host noise needs)."""

    def __call__(self, plan: LangevinPlan, x, v, nsteps: int,
                 gen: torch.Generator, noise: bool = True,
                 walker_offset: int = 0):
        from .._device import draw_seed
        _check(x, plan, "langevin_middle")
        _check(v, plan, "langevin_middle")
        if x.device != v.device:
            raise ValueError("x and v on different devices")
        if x.device.type == "cpu":
            return langevin_middle_plain(plan, x, v, nsteps, gen, noise,
                                         walker_offset)
        _check_card(x, plan, "langevin_middle")
        walker_offset = _shard_offset(gen, walker_offset)
        seed = draw_seed(gen)
        lib = self.lib()
        x = x.contiguous().clone()
        v = v.contiguous().clone()
        tb = plan.on(x.device)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.lm_langevin_middle(
            x.data_ptr(), v.data_ptr(), x.shape[0], *_table_args(plan, tb),
            *plan.geometry_args(), int(nsteps), seed, int(walker_offset),
            int(bool(noise)), plan.dt, plan.a, plan.b, stream)
        self._raise(err, "langevin_middle")
        self.launches += 1
        return x, v


forces = Forces()
langevin_middle = LangevinMiddle()
