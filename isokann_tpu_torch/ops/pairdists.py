"""Pairwise-distance featurisation; counterpart of the Gram-matrix path of
``isokann_tpu/ops/pairdists.py`` and of its ``pdists`` (the fused kernel
there served >= 512 atoms on the TPU and is not ported yet)."""

from __future__ import annotations

import torch


def sqpairdist(x):
    """Squared pairwise distances, (..., n, 3) -> (..., n, n), by the Gram
    trick |xi|^2 + |xj|^2 - 2 xi.xj (full f32: TF32 is off)."""
    sq = torch.sum(x * x, dim=-1)
    g = torch.matmul(x, x.transpose(-1, -2))
    return sq[..., :, None] + sq[..., None, :] - 2.0 * g


def flatpairdists(x):
    """All-pairs distances from flat coordinates:
    (..., 3 n) -> (..., n (n - 1) / 2), i < j in row-major order."""
    batch = x.shape[:-1]
    b = x.reshape(-1, x.shape[-1] // 3, 3)
    n = b.shape[1]
    i, j = torch.triu_indices(n, n, offset=1, device=x.device)
    p = sqpairdist(b)[:, i, j]
    return torch.sqrt(torch.clamp(p, min=0.0)).reshape(batch + (len(i),))


def pdists(x, pairs):
    """Distances of an explicit list of atom pairs by direct differences:
    (..., 3N), pairs (m, 2) of 0-based indices -> (..., m)."""
    batch = x.shape[:-1]
    b = x.reshape(-1, x.shape[-1] // 3, 3)
    pairs = torch.as_tensor(pairs, dtype=torch.long, device=x.device)
    d = b[:, pairs[:, 0], :] - b[:, pairs[:, 1], :]
    D = torch.sqrt(torch.clamp(torch.sum(d * d, dim=-1), min=1e-24))
    return D.reshape(batch + (pairs.shape[0],))
