"""Squared pair distances by direct differences and their gradient: the
hand-written CUDA kernels, their plain PyTorch versions, the wrappers that
choose between them, the autograd function and the bounds.

Counterpart of the fused route of ``isokann_tpu/ops/pairdists.py``: the TPU
kernels ``_sqpairdist_fwd_impl`` (C) and ``_sqpairdist_bwd_impl`` (C′)
under the ``jax.custom_vjp`` ``sqpairdist_fused``.  The CUDA source is
``csrc/sqpairdist.cu``; its header states the design and the bound.

- ``sqpairdist_fwd_plain`` / ``sqpairdist_bwd_plain``: the same functions
  in tensor ops, the forward rounded per operation in the kernel's order
  (the same bits as the kernel), the backward in float64 and rounded once.
  The CPU tests and ``chip_smoke.py`` hold the kernels against them.
- ``sqpairdist_bwd_tiled``: C′ in tensor ops in the kernel's tile-pair
  order (the kernel's bits), for the CPU tests; nothing on the main path
  calls it.
- ``sqpairdist_fwd`` / ``sqpairdist_bwd``: the wrappers.  A CPU tensor
  takes the plain version; a CUDA tensor launches the kernel or raises;
  any other device raises.  ``.launches`` counts the launches.
- ``sqpairdist_fused``: a ``torch.autograd.Function`` whose forward is the
  forward wrapper and whose backward is the backward wrapper;
  ``sqpairdist_fused_plain`` is the same function over the plain versions.
- ``step_ops`` / ``step_bytes`` / ``bound_ms``: what the functions need;
  ``kernel_bytes``: what the kernels move; ``launch_shape``: C′'s grid.
"""

from __future__ import annotations

import ctypes

import torch

from ..md import langevin_kernel as LK

MAX_WALKERS = 65535      # a grid dimension of the CUDA launch
TILE = 32                # atoms of a tile side
WARPS = 4                # warps a block of C′
SMS = 132                # streaming multiprocessors of an H100 SXM
PART_BYTES = 2 * 3 * TILE * 8   # a tile pair's row and column partial sums


# ==========================================================================
# Plain PyTorch versions
# ==========================================================================

def sqpairdist_fwd_plain(x):
    """(B, N, 3) -> (B, N, N): acc = dx*dx; acc += dy*dy; acc += dz*dz,
    with d = x_i - x_j, each a rounded float32 operation."""
    acc = None
    for k in range(3):
        c = x[..., k]
        d = c[:, :, None] - c[:, None, :]
        sq = d * d
        acc = sq if acc is None else acc + sq
    return acc


def sqpairdist_bwd_plain(x, dp):
    """(B, N, 3), (B, N, N) -> (B, N, 3): dx_i = 2 sum_j s_ij (x_i - x_j)
    with s = dp + dp^T, in float64, rounded once to x's type."""
    s = dp.double()
    s = s + s.transpose(1, 2)
    xd = x.double()
    out = []
    for k in range(3):
        c = xd[..., k]
        out.append(torch.sum(s * (c[:, :, None] - c[:, None, :]), dim=2))
    return (2.0 * torch.stack(out, dim=-1)).to(x.dtype)


def tiles(natoms: int) -> int:
    """32-atom tiles of ``natoms`` atoms."""
    return -(-natoms // TILE)


def tile_pairs(natoms: int) -> int:
    """Tile pairs (I, J), J >= I: the work items of C′."""
    nt = tiles(natoms)
    return nt * (nt + 1) // 2


def sqpairdist_bwd_tiled(x, dp):
    """C′ in the CUDA kernel's order, (B, N, 3), (B, N, N) -> (B, N, 3):
    in tile pair (I, J), J >= I, p = s_ij (x_i - x_j) in double
    (s = dp_ij + dp_ji); row atom i's partial adds p over the columns of
    each group of 8 in order and combines the four groups as (P0 + P2) +
    (P1 + P3); column atom j's partial subtracts p over the rows of each
    group of 4 in order and combines the eight groups as ((Q0 + Q4) + (Q2 +
    Q6)) + ((Q1 + Q5) + (Q3 + Q7)) (on the diagonal tile pair only the row
    partials, over all ordered pairs).  Atom 32 T + l then adds, in
    ascending order of the other tile U, the column partial of (U, T) for
    U < T and the row partial of (T, U) for U >= T; dx = 2 acc rounded to
    float.  Every operation is a rounded double operation, as the kernel's,
    so the two give the same bits."""
    Bn, N = x.shape[:2]
    nt, T = tiles(N), TILE
    Np = nt * T
    X = torch.zeros(Bn, Np, 3, dtype=torch.float64, device=x.device)
    X[:, :N] = x.double()
    S = torch.zeros(Bn, Np, Np, dtype=torch.float64, device=x.device)
    S[:, :N, :N] = dp.double()
    S = S + S.transpose(1, 2)
    P = S[..., None] * (X[:, :, None, :] - X[:, None, :, :])  # (B, i, j, 3)
    # row partials R[b, I, r, J]: 4 column groups of 8, each in order
    Pc = P.reshape(Bn, nt, T, nt, 4, 8, 3)
    acc = torch.zeros_like(Pc[..., 0, :])
    for c in range(8):
        acc = acc + Pc[..., c, :]
    R = (acc[..., 0, :] + acc[..., 2, :]) + (acc[..., 1, :] + acc[..., 3, :])
    # column partials C[b, I, J, c]: 8 row groups of 4, each in order
    Pr = P.reshape(Bn, nt, 8, 4, nt, T, 3)
    acc = torch.zeros_like(Pr[:, :, :, 0])
    for r in range(4):
        acc = acc - Pr[:, :, :, r]
    t1 = acc[:, :, 0:4] + acc[:, :, 4:8]
    t2 = t1[:, :, 0:2] + t1[:, :, 2:4]
    C = t2[:, :, 0] + t2[:, :, 1]
    # per atom, in ascending order of the other tile
    below = (torch.arange(nt, device=x.device)[None, :, None, None]
             > torch.arange(nt, device=x.device)[:, None, None, None])
    out = torch.zeros(Bn, nt, T, 3, dtype=torch.float64, device=x.device)
    for u in range(nt):
        out = out + torch.where(below[u], C[:, u], R[:, :, :, u])
    return (2.0 * out.reshape(Bn, Np, 3)[:, :N]).to(x.dtype)


# ==========================================================================
# Wrappers: plain version on the CPU, the kernel on the card
# ==========================================================================

def _check(name, x, dp=None):
    if x.dtype != torch.float32 or x.dim() != 3 or x.shape[2] != 3:
        raise ValueError(f"{name}: expected float32 (B, N, 3), got "
                         f"{tuple(x.shape)} {x.dtype}")
    B, N = x.shape[:2]
    if dp is not None and (dp.dtype != torch.float32
                           or tuple(dp.shape) != (B, N, N)
                           or dp.device != x.device):
        raise ValueError(f"{name}: expected float32 dp {(B, N, N)} on "
                         f"{x.device}, got {tuple(dp.shape)} {dp.dtype} on "
                         f"{dp.device}")
    if x.device.type not in ("cpu", "cuda"):
        raise NotImplementedError(f"no {name} kernel for {x.device}")
    if x.device.type == "cuda" and not 1 <= B <= MAX_WALKERS:
        raise NotImplementedError(f"the {name} kernel takes 1 to "
                                  f"{MAX_WALKERS} walkers, not {B}")


class _SqPairDistLib(LK.CudaKernel):
    """``sqpairdist.cu``: ``sqpairdist_fwd`` and ``sqpairdist_bwd``."""

    name, source = "sqpairdist", "sqpairdist.cu"

    def _declare(self, lib):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.sqpairdist_fwd.argtypes = [p, p, i, i, p]
        lib.sqpairdist_fwd.restype = i
        lib.sqpairdist_bwd.argtypes = [p, p, p, p, i, i, i, i, p]
        lib.sqpairdist_bwd.restype = i


class SqPairDistFwd(_SqPairDistLib):
    """``sqpairdist_fwd(x)``: (B, N, 3) -> (B, N, N) squared distances
    (kernel C)."""

    def __call__(self, x):
        _check("sqpairdist_fwd", x)
        if x.device.type == "cpu":
            return sqpairdist_fwd_plain(x)
        lib = self.lib()
        x = x.contiguous()
        B, N = x.shape[:2]
        out = torch.empty((B, N, N), dtype=x.dtype, device=x.device)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        self._raise(lib.sqpairdist_fwd(x.data_ptr(), out.data_ptr(), B, N,
                                       stream), "sqpairdist_fwd")
        self.launches += 1
        return out


def launch_shape(natoms: int, nwalkers: int):
    """C′'s launch, (blocks a walker, warps a block): one wave of two blocks
    an SM where the batch is small (up to a tile pair a warp: 48 blocks at
    B=1 and 588 atoms, 8 at B=32), else at most six tile pairs a warp (8
    blocks).  The bits do not depend on the shape."""
    most = -(-tile_pairs(natoms) // WARPS)
    return min(most, max(-(-most // 6), 2 * SMS // nwalkers)), WARPS


class SqPairDistBwd(_SqPairDistLib):
    """``sqpairdist_bwd(x, dp)``: (B, N, 3), (B, N, N) -> (B, N, 3), the
    gradient of sum(dp * sqpairdist(x)) (kernel C′: the tile-pair pass into
    a buffer of partial sums, then the per-atom pass), launched at
    ``launch_shape(N, B)``."""

    def __call__(self, x, dp):
        _check("sqpairdist_bwd", x, dp)
        if x.device.type == "cpu":
            return sqpairdist_bwd_plain(x, dp)
        lib = self.lib()
        x, dp = x.contiguous(), dp.contiguous()
        B, N = x.shape[:2]
        dx = torch.empty_like(x)
        part = torch.empty(B * tile_pairs(N) * PART_BYTES // 8,
                           dtype=torch.float64, device=x.device)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        self._raise(lib.sqpairdist_bwd(
            x.data_ptr(), dp.data_ptr(), dx.data_ptr(), part.data_ptr(), B,
            N, *launch_shape(N, B), stream), "sqpairdist_bwd")
        self.launches += 1
        return dx


sqpairdist_fwd = SqPairDistFwd()
sqpairdist_bwd = SqPairDistBwd()


class _SqPairDist(torch.autograd.Function):
    """Squared pair distances with a hand-written backward: ``fwd(x)``
    forward, ``bwd(x, dp)`` backward (the custom VJP of the reference)."""

    @staticmethod
    def forward(ctx, x, fwd, bwd):
        ctx.save_for_backward(x)
        ctx.bwd = bwd
        return fwd(x)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dp):
        (x,) = ctx.saved_tensors
        return ctx.bwd(x, dp), None, None


def sqpairdist_fused(x):
    """(B, N, 3) -> (B, N, N) through kernels C and C′ (their plain
    versions on the CPU)."""
    return _SqPairDist.apply(x, sqpairdist_fwd, sqpairdist_bwd)


def sqpairdist_fused_plain(x):
    """``sqpairdist_fused`` over the plain versions on any device: the
    yardstick of the kernel route on the card."""
    return _SqPairDist.apply(x, sqpairdist_fwd_plain, sqpairdist_bwd_plain)


# ==========================================================================
# What the functions need
# ==========================================================================

# Float operations per ordered pair (i, j): the forward's 3 differences,
# 3 squares and 2 additions; the backward's s_ij = dp_ij + dp_ji, 3
# differences, 3 products and 3 additions, and per atom the factor 2 on
# its 3 components.
_FWD_PAIR, _BWD_PAIR, _BWD_ATOM = 8, 10, 3


def step_ops(kind: str, nwalkers: int, natoms: int) -> float:
    """Float operations of one call of kernel ``kind`` ("fwd" or "bwd")."""
    pairs = nwalkers * natoms * natoms
    if kind == "fwd":
        return float(_FWD_PAIR * pairs)
    return float(_BWD_PAIR * pairs + _BWD_ATOM * nwalkers * natoms)


def step_bytes(kind: str, nwalkers: int, natoms: int) -> float:
    """Bytes of one call with each input read once and each output written
    once: x (B, N, 3) and p or dp (B, N, N) float32, plus dx for "bwd"."""
    coords = 4 * 3 * nwalkers * natoms
    square = 4 * nwalkers * natoms * natoms
    return float(coords + square + (coords if kind == "bwd" else 0))


def kernel_bytes(kind: str, nwalkers: int, natoms: int) -> float:
    """Bytes the kernel moves through device memory in one call:
    ``step_bytes``, plus for C′ its partial sums written and read back once
    (1,536 bytes a tile pair, 768 on the diagonal).  The coordinates that
    each tile pair reads again come from the L2 and are not counted."""
    if kind != "bwd":
        return step_bytes(kind, nwalkers, natoms)
    nt = tiles(natoms)
    part = (tile_pairs(natoms) - nt) * PART_BYTES + nt * PART_BYTES // 2
    return step_bytes(kind, nwalkers, natoms) + float(2 * nwalkers * part)


def bound_ms(kind: str, nwalkers: int, natoms: int):
    """Least time on an H100 for one call of kernel ``kind``, and what
    bounds it: operations over the FP32 peak or bytes over the memory
    rate."""
    t_ops = step_ops(kind, nwalkers, natoms) / LK.H100_FP32_PEAK
    t_bytes = step_bytes(kind, nwalkers, natoms) / LK.H100_HBM_BYTES_PER_S
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")
