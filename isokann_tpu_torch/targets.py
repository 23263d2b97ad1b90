"""ISOKANN target transforms; counterpart of the 1-D shift-scale path of
``isokann_tpu/targets.py`` and of its Koopman ``expectation``."""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch


class DomainError(ValueError):
    """Raised when a target transform degenerates (constant chi) or the
    model collapses under training."""


def expectation(model, ys):
    """Monte-Carlo Koopman expectation of ``model`` over the k-axis of
    ys (n, k, f): the mean, or for ``WeightedSamples`` the Girsanov
    estimate sum_k w chi / k.  Returns (n, d)."""
    from .data import WeightedSamples

    if isinstance(ys, WeightedSamples):
        vals = model(ys.values)
        return torch.sum(vals * ys.weights[..., None], dim=-2) / vals.shape[-2]
    return torch.mean(model(ys), dim=-2)


def shiftscale_jit(ks, mask=None, n_true=None, quantile=0.0):
    """(ks - lo) / (hi - lo) with no host check (a constant chi gives
    NaN/Inf, which the training loop's finite-loss guard catches).

    ``quantile`` > 0: bounds are the (q, 1-q) order statistics of the
    rows with ``mask`` > 0 (padding sorts to +inf, indices use ``n_true``),
    and the result is clipped to [0, 1]."""
    if quantile:
        v = ks.reshape(-1)
        if mask is None:
            nt = float(v.shape[0])
            srt = torch.sort(v).values
        else:
            nt = float(n_true)
            srt = torch.sort(torch.where(mask.reshape(-1) > 0, v,
                                         torch.full_like(v, torch.inf))).values
        last = v.shape[0] - 1
        i_lo = min(max(math.floor(quantile * (nt - 1.0)), 0), last)
        i_hi = min(max(math.ceil((1.0 - quantile) * (nt - 1.0)), 0), last)
        lo, hi = srt[i_lo], srt[i_hi]
        return torch.clamp((ks - lo) / (hi - lo), 0.0, 1.0)
    lo, hi = torch.min(ks), torch.max(ks)
    return (ks - lo) / (hi - lo)


def shiftscale(ks, quantile=0.0):
    """Empirical shift-scale (ks - min) / (max - min); raises DomainError
    on a constant chi or a chi of more than one dimension."""
    if ks.dim() > 1 and ks.shape[-1] != 1:
        raise DomainError("TransformShiftscale only works with one "
                          "dimensional chi functions")
    out = shiftscale_jit(ks, quantile=quantile)
    if not bool(torch.isfinite(out).all()) or bool(
            torch.max(ks) <= torch.min(ks)):
        raise DomainError("Could not compute the shift-scale. chi function "
                          "is constant")
    return out


@dataclass
class TransformShiftscale:
    """Classical 1-D shift-scale power iteration (ISOKANN 1)."""

    quantile: float = 0.0
    fused = True

    def fused_target(self, kchi, mask=None, n_true=None):
        return shiftscale_jit(kchi, mask, n_true, self.quantile)
