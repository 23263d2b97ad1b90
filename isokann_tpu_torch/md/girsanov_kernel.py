"""Girsanov-weighted ABOBA trajectories under the chi-MLP optimal-control
bias: the hand-written CUDA kernel, its plain PyTorch version, and the
wrappers that choose between them.

Counterpart of ``isokann_tpu/md/pallas_md.py:aboba_girsanov_fused`` (the
TPU kernel, with ``ChiBiasPlan`` and ``make_chi_grad_fn``).  The CUDA
source is ``csrc/aboba_girsanov.cu``; its header states the design and the
bound.  It shares kernel A's warp force routine and tables
(``csrc/warp_forces.cuh``).

- ``GirsanovPlan``: kernel A's ``LangevinPlan`` tables, the ABOBA
  constants (a, famp, 1/famp, forcescale sigma^2 per coordinate) and the
  chi model's layout (sizes, LayerNorm).
- ``chi_grad_plain`` / ``aboba_girsanov_plain``: the same functions in
  tensor ops.  dchi/df comes from ``torch.autograd`` on the port's ``MLP``,
  so on the card the kernel's hand-written backward is held against
  autograd.
- ``backproject_gather``: the kernel's bias back-projection in tensor ops,
  a per-atom gather over its partners in ascending order (the plain
  version scatters with ``index_add_``).
- ``chi_grad`` / ``aboba_girsanov``: the wrappers.  A CPU tensor takes the
  plain version; a CUDA tensor launches the kernel or raises.  Each
  wrapper counts its kernel launches in ``.launches``.

The features are the distances of the kernel's own pair rows, which are
minimum-imaged under CutoffPeriodic, as the TPU kernel's are.
``FeaturesAll`` takes plain distances; for a molecule far smaller than
half its box the two agree.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from . import langevin_kernel as LK
from .integrators import KB, PSI_FLOOR

MAX_LAYERS = 8


class GirsanovPlan:
    """Kernel A's tables plus the ABOBA constants and the chi layout.

    ``gtab`` (float32): famp | 1/famp | forcescale sigma^2, 3N each, with
    famp = sqrt(kB T m (1 - a^2)), sigma^2 = 2 kB T gamma m and
    a = exp(-gamma dt), computed in float64 as the TPU kernel does."""

    def __init__(self, lplan: LK.LangevinPlan, sizes, layernorm: bool,
                 forcescale: float):
        sizes = tuple(int(s) for s in sizes)
        if sizes[0] != lplan.np:
            raise ValueError(f"chi model expects {sizes[0]} features, the "
                             f"system has {lplan.np} pair rows")
        if sizes[-1] != 1:
            raise ValueError("the in-kernel bias needs a scalar chi model")
        if len(sizes) - 1 > MAX_LAYERS:
            raise ValueError(f"at most {MAX_LAYERS} dense layers")
        self.lplan = lplan
        self.sizes = sizes
        self.layernorm = bool(layernorm)
        self.forcescale = float(forcescale)
        self.a_o = math.exp(-lplan.gamma * lplan.dt)
        m3 = 1.0 / lplan.minv
        kbt = KB * lplan.T
        self.famp = np.sqrt(kbt * m3 * (1.0 - self.a_o * self.a_o))
        self.fs_sig2 = self.forcescale * 2.0 * kbt * lplan.gamma * m3
        self.gtab = np.concatenate([self.famp, 1.0 / self.famp,
                                    self.fs_sig2]).astype(np.float32)
        self._dev = {}

    @classmethod
    def for_model(cls, lplan: LK.LangevinPlan, model, forcescale: float):
        """The plan for an ``MLP`` the kernel takes; raises otherwise."""
        if not takes_model(model, lplan.np):
            raise ValueError(f"the Girsanov kernel takes a sigmoid / "
                             f"identity MLP over {lplan.np} pair "
                             f"distances, not {model!r}")
        return cls(lplan, model.sizes, model.layernorm, forcescale)

    @property
    def dim(self):
        return self.lplan.dim

    def on(self, device) -> dict:
        """famp, inv_famp, fs_sig2 and gtab as tensors on ``device``."""
        key = str(torch.device(device))
        if key not in self._dev:
            gtab = torch.as_tensor(self.gtab, device=device)
            n = self.dim
            self._dev[key] = dict(gtab=gtab, famp=gtab[:n],
                                  inv_famp=gtab[n:2 * n],
                                  fs_sig2=gtab[2 * n:])
        return self._dev[key]

    def check(self, model):
        if (tuple(model.sizes) != self.sizes
                or bool(model.layernorm) != self.layernorm
                or model.activation != "sigmoid"
                or model.lastactivation != "identity"):
            raise ValueError("chi model does not match the Girsanov plan")

    def pack(self, model) -> torch.Tensor:
        """The kernel's parameter array: LayerNorm gamma, beta (when
        present), then each layer's (out, in) weight and its bias."""
        self.check(model)
        parts = [model.ln.weight, model.ln.bias] if self.layernorm else []
        for layer in model.layers:
            parts += [layer.weight, layer.bias]
        return torch.cat([t.detach().reshape(-1) for t in parts]).to(
            torch.float32).contiguous()

    def layout_args(self):
        """(nl, sizes as a C int array, layernorm) for the C entries."""
        nl = len(self.sizes) - 1
        return [ctypes.c_int(nl), (ctypes.c_int * (nl + 1))(*self.sizes),
                ctypes.c_int(int(self.layernorm))]


def takes_model(model, npairs: int) -> bool:
    """Whether the kernel computes this chi model: an ``MLP`` over
    ``npairs`` features with sigmoid hidden layers and an identity scalar
    output, with or without an input LayerNorm."""
    sizes = getattr(model, "sizes", None)
    return (sizes is not None and sizes[0] == npairs and sizes[-1] == 1
            and len(sizes) - 1 <= MAX_LAYERS
            and getattr(model, "activation", None) == "sigmoid"
            and getattr(model, "lastactivation", None) == "identity")


def step_ops(plan: GirsanovPlan) -> float:
    """Float operations per walker per step, counted from the kernel's
    code: kernel A's force field and integrator (``LK.step_ops``); the
    distance features once (~9 per pair, +9 minimum image); the MLP's
    forward and input-gradient passes, 2 per multiply-add each
    (4 sum n_k n_(k+1)), ~8 per hidden unit (sigmoid, its derivative),
    ~20 per feature for the LayerNorm forward and backward; the bias
    back-projection (~10 per pair); and ~10 more per coordinate for the
    bias, the log-weight and the second half-kick.  The kernel recomputes
    the distances in its backward; the bound counts them once."""
    lp = plan.lplan
    s = plan.sizes
    macs = sum(a * b for a, b in zip(s[:-1], s[1:]))
    hidden = sum(s[1:-1])
    pair = 9 + (9 if lp.box is not None else 0) + 10
    r3 = ((lp.dim + 7) // 8) * 8
    return float(LK.step_ops(lp) + 4 * macs + 8 * hidden
                 + (20 * s[0] if plan.layernorm else 0) + lp.np * pair
                 + 10 * r3)


def kernel_ops(plan: GirsanovPlan) -> float:
    """Float operations per walker per step that kernel B executes:
    ``step_ops`` with kernel A's force routine as A executes it
    (``LK.kernel_ops``: each nonbonded pair from both sides, the bonded
    slots summed per atom) and the back-projection gathered from both
    atoms' sides (the pair's d again, c d and the sum on each side: 9 more
    a pair, and 18 more under minimum image)."""
    lp = plan.lplan
    again = 9 + (18 if lp.box is not None else 0)
    return (step_ops(plan) + LK.kernel_ops(lp) - LK.step_ops(lp)
            + float(lp.np * again))


def blocks(nwalkers: int) -> int:
    """Blocks kernel B starts for ``nwalkers`` walkers (one warp each, as
    kernel A)."""
    return LK.blocks(nwalkers)


def bound_ms(plan: GirsanovPlan, nwalkers: int, nsteps: int):
    """Least time on an H100 for ``nsteps`` biased steps of ``nwalkers``
    walkers, and what bounds it: operations over the FP32 peak, or q, p
    read and written once, logw written once, and the tables and chi
    weights read once, over the memory rate."""
    ops = step_ops(plan) * nwalkers * nsteps
    nparams = sum(a * b + b for a, b in zip(plan.sizes[:-1], plan.sizes[1:]))
    nparams += 2 * plan.sizes[0] if plan.layernorm else 0
    nbytes = (4 * (4 * nwalkers * plan.dim + nwalkers + nparams)
              + plan.lplan.itab.nbytes + plan.lplan.ftab.nbytes
              + plan.gtab.nbytes)
    t_ops = ops / LK.H100_FP32_PEAK
    t_bytes = nbytes / LK.H100_HBM_BYTES_PER_S
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


# ==========================================================================
# Plain PyTorch version
# ==========================================================================

def chi_grad_plain(plan: GirsanovPlan, model, f):
    """chi (B,) and dchi/df (B, n0) at features f (B, n0), by the model's
    forward pass and ``torch.autograd``."""
    plan.check(model)
    with torch.enable_grad():
        z = f.detach().requires_grad_(True)
        chi = model(z)[:, 0]
        (g,) = torch.autograd.grad(chi.sum(), z)
    return chi.detach(), g


def aboba_girsanov_plain(plan: GirsanovPlan, model, x, p, nsteps: int,
                         b: float, qrate: float, Tmax: float,
                         gen: torch.Generator = None, noise: bool = True):
    """``nsteps`` biased ABOBA steps from positions x and momenta p
    (B, 3N); returns (q, p, logw (B,)).  The kernel's arithmetic in tensor
    ops, with the noise drawn from ``gen`` on the host (its stream differs
    from the kernel's Philox stream by design)."""
    lp = plan.lplan
    tb, gt = lp.on(x.device), plan.on(x.device)
    minv, famp = tb["minv"], gt["famp"]
    inv_famp, fs_sig2 = gt["inv_famp"], gt["fs_sig2"]
    pi, pj = tb["pairs"][:, 0], tb["pairs"][:, 1]
    B = x.shape[0]
    t2 = 0.5 * lp.dt
    c_deta = (plan.a_o + 1.0) * t2
    q = x
    logw = torch.zeros(B, dtype=x.dtype, device=x.device)
    for s in range(int(nsteps)):
        tt = torch.tensor(float(s), dtype=torch.float32) * lp.dt
        lam = torch.exp(qrate * (Tmax - tt)).to(x.device)
        eta = (torch.randn(p.shape, generator=gen, dtype=p.dtype).to(p.device)
               if noise else torch.zeros_like(p))
        q = q + t2 * p * minv                                        # A
        F = LK.forces_plain(lp, q)
        d, r2 = LK.pair_delta(lp, q.reshape(B, lp.natoms, 3))
        r = torch.sqrt(r2)
        chi, gf = chi_grad_plain(plan, model, r)
        scale = lam / torch.clamp(lam * (chi - b) + b, min=PSI_FLOOR)
        c = (gf / r)[..., None] * d
        G = torch.zeros(B, lp.natoms, 3, dtype=x.dtype, device=x.device)
        G.index_add_(1, pi, c)
        G.index_add_(1, pj, -c)
        bias = fs_sig2 * (scale[:, None] * G.reshape(B, lp.dim))
        deta = c_deta * bias * inv_famp
        logw = logw - torch.sum(eta * deta + 0.5 * deta * deta, dim=-1)
        half = t2 * (F + bias)
        p = p + half                                                 # B
        p = plan.a_o * p + famp * eta                                # O
        p = p + half                                                 # B
        q = q + t2 * p * minv                                        # A
    return q, p, logw


def backproject_gather(lp: LK.LangevinPlan, x, c):
    """sum_p c_p dr_p/dq as kernel B gathers it: atom a adds c_p (x_a - x_b)
    (minimum-imaged when periodic) over its partners b = 0..N-1 in
    ascending order, p the pair row of {a, b}.  x (B, 3N), c (B, np) ->
    (B, N, 3)."""
    B, n = x.shape[0], lp.natoms
    X = x.reshape(B, n, 3)
    pidx = np.zeros((n, n), np.int64)
    pidx[lp.pairs[:, 0], lp.pairs[:, 1]] = np.arange(lp.np)
    pidx = pidx + pidx.T
    pidx = torch.as_tensor(pidx, device=x.device)
    box = (torch.tensor(lp.box, dtype=x.dtype, device=x.device)
           if lp.box is not None else None)
    G = torch.zeros_like(X)
    for b in range(n):
        d = X - X[:, b:b + 1]
        if box is not None:
            d = d - box * torch.round(d * (1.0 / box))
        cb = c[:, pidx[:, b]]                               # (B, N)
        cb[:, b] = 0.0
        G = G + cb[..., None] * d
    return G


# ==========================================================================
# Wrappers: plain version on the CPU, the kernel on the card
# ==========================================================================

def _check_card(x, plan, name):
    if x.device.type != "cuda":
        raise NotImplementedError(f"no {name} kernel for {x.device}")
    if plan.lplan.natoms > LK.MAX_ATOMS:
        raise NotImplementedError(f"the {name} kernel takes <= "
                                  f"{LK.MAX_ATOMS} atoms, not "
                                  f"{plan.lplan.natoms}")


def _check_model(model, x, name):
    dev = next(model.parameters()).device
    if dev != x.device:
        raise ValueError(f"{name}: chi model on {dev}, walkers on "
                         f"{x.device}")


class _GirsanovLib(LK.CudaKernel):
    """``aboba_girsanov.cu``: ``ag_chi_grad`` and ``ag_aboba_girsanov``."""

    name, source = "aboba_girsanov", "aboba_girsanov.cu"

    def _declare(self, lib):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        layout = [p, i, p, i]                    # params, nl, sizes, ln
        lib.ag_chi_grad.argtypes = [p, p, p, i] + layout + [p]
        lib.ag_chi_grad.restype = i
        lib.ag_aboba_girsanov.argtypes = (
            [p, p, p, i, p, p, p, p, i] + LK.GEOMETRY_ARGTYPES + [p] + layout
            + [i, ctypes.c_ulonglong, i, f, f, f, f, f, p])
        lib.ag_aboba_girsanov.restype = i


class ChiGrad(_GirsanovLib):
    """``chi_grad(plan, model, f)``: features (B, n0) -> (chi (B,),
    dchi/df (B, n0)).  On the card this is a parity entry only."""

    def __call__(self, plan: GirsanovPlan, model, f):
        if (f.dtype != torch.float32 or f.dim() != 2
                or f.shape[1] != plan.sizes[0]):
            raise ValueError(f"chi_grad: expected float32 (B, "
                             f"{plan.sizes[0]}), got {tuple(f.shape)} "
                             f"{f.dtype}")
        if f.device.type == "cpu":
            return chi_grad_plain(plan, model, f)
        _check_card(f, plan, "chi_grad")
        _check_model(model, f, "chi_grad")
        lib = self.lib()
        f = f.contiguous()
        params = plan.pack(model)
        chi = torch.empty(f.shape[0], dtype=f.dtype, device=f.device)
        g = torch.empty_like(f)
        stream = torch.cuda.current_stream(f.device).cuda_stream
        nl, sizes, ln = plan.layout_args()
        err = lib.ag_chi_grad(f.data_ptr(), chi.data_ptr(), g.data_ptr(),
                              f.shape[0], params.data_ptr(), nl, sizes, ln,
                              stream)
        self._raise(err, "chi_grad")
        self.launches += 1
        return chi, g


class AbobaGirsanov(_GirsanovLib):
    """``aboba_girsanov(plan, model, x, p, nsteps, b, qrate, Tmax, gen,
    noise=True)`` -> (q, p, logw).

    The chi weights and b, qrate, Tmax are launch arguments: a new model
    or new scalars need no rebuild.  The kernel's Philox seed is drawn
    from ``gen``; the same generator state gives the same bits."""

    def __call__(self, plan: GirsanovPlan, model, x, p, nsteps: int,
                 b: float, qrate: float, Tmax: float,
                 gen: torch.Generator, noise: bool = True):
        LK._check(x, plan.lplan, "aboba_girsanov")
        LK._check(p, plan.lplan, "aboba_girsanov")
        if x.device != p.device:
            raise ValueError("x and p on different devices")
        if x.device.type == "cpu":
            return aboba_girsanov_plain(plan, model, x, p, nsteps, b, qrate,
                                        Tmax, gen, noise)
        _check_card(x, plan, "aboba_girsanov")
        _check_model(model, x, "aboba_girsanov")
        from .._device import draw_seed
        seed = draw_seed(gen)
        lib = self.lib()
        lp = plan.lplan
        q = x.contiguous().clone()
        p = p.contiguous().clone()
        logw = torch.empty(x.shape[0], dtype=x.dtype, device=x.device)
        params = plan.pack(model)
        tb, gt = lp.on(x.device), plan.on(x.device)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.ag_aboba_girsanov(
            q.data_ptr(), p.data_ptr(), logw.data_ptr(), x.shape[0],
            *LK._table_args(lp, tb), *lp.geometry_args(),
            gt["gtab"].data_ptr(), params.data_ptr(),
            *plan.layout_args(), int(nsteps), seed, int(bool(noise)), lp.dt,
            plan.a_o, float(b), float(qrate), float(Tmax), stream)
        self._raise(err, "aboba_girsanov")
        self.launches += 1
        return q, p, logw


chi_grad = ChiGrad()
aboba_girsanov = AbobaGirsanov()
