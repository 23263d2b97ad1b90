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
- ``sqpairdist_fwd`` / ``sqpairdist_bwd``: the wrappers.  A CPU tensor
  takes the plain version; a CUDA tensor launches the kernel or raises;
  any other device raises.  ``.launches`` counts the launches.
- ``sqpairdist_fused``: a ``torch.autograd.Function`` whose forward is the
  forward wrapper and whose backward is the backward wrapper;
  ``sqpairdist_fused_plain`` is the same function over the plain versions.
- ``step_ops`` / ``step_bytes`` / ``bound_ms``: what the functions need.
"""

from __future__ import annotations

import ctypes

import torch

from ..md import langevin_kernel as LK

MAX_WALKERS = 65535      # a grid dimension of the CUDA launch


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
        lib.sqpairdist_bwd.argtypes = [p, p, p, i, i, p]
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


class SqPairDistBwd(_SqPairDistLib):
    """``sqpairdist_bwd(x, dp)``: (B, N, 3), (B, N, N) -> (B, N, 3), the
    gradient of sum(dp * sqpairdist(x)) (kernel C′)."""

    def __call__(self, x, dp):
        _check("sqpairdist_bwd", x, dp)
        if x.device.type == "cpu":
            return sqpairdist_bwd_plain(x, dp)
        lib = self.lib()
        x, dp = x.contiguous(), dp.contiguous()
        B, N = x.shape[:2]
        dx = torch.empty_like(x)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        self._raise(lib.sqpairdist_bwd(x.data_ptr(), dp.data_ptr(),
                                       dx.data_ptr(), B, N, stream),
                    "sqpairdist_bwd")
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


def bound_ms(kind: str, nwalkers: int, natoms: int):
    """Least time on an H100 for one call of kernel ``kind``, and what
    bounds it: operations over the FP32 peak or bytes over the memory
    rate."""
    t_ops = step_ops(kind, nwalkers, natoms) / LK.H100_FP32_PEAK
    t_bytes = step_bytes(kind, nwalkers, natoms) / LK.H100_HBM_BYTES_PER_S
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")
