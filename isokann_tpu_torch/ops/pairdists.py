"""Pairwise-distance featurisation; counterpart of
``isokann_tpu/ops/pairdists.py``.

Two routes for all-pairs distances, chosen by ``flatpairdists`` from the
atom count alone, whatever the device:

1. the Gram trick |xi|^2 + |xj|^2 - 2 xi.xj (``sqpairdist``; a full-f32
   matmul, TF32 is off) below ``FUSED_MIN_ATOMS`` atoms;
2. direct differences through kernels C and C′
   (``ops.pairdists_kernel.sqpairdist_fused``: the hand-written CUDA
   forward and backward on the card, their plain versions on the CPU) from
   ``FUSED_MIN_ATOMS`` atoms up.

The host helpers (``halfinds``, ``localpdistinds``,
``restricted_localpdistinds``) are numpy, as in the reference.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .pairdists_kernel import sqpairdist_fused

# The reference's threshold for its fused TPU kernel (measured on a TPU
# v5e: the Gram route wins below, both are HBM-bound above).  Kept as is;
# where the two routes cross on an H100 is not measured yet.
FUSED_MIN_ATOMS = 512


def sqpairdist(x):
    """Squared pairwise distances, (..., n, 3) -> (..., n, n), by the Gram
    trick |xi|^2 + |xj|^2 - 2 xi.xj (full f32: TF32 is off)."""
    sq = torch.sum(x * x, dim=-1)
    g = torch.matmul(x, x.transpose(-1, -2))
    return sq[..., :, None] + sq[..., None, :] - 2.0 * g


def pairdist(x):
    """Pairwise distances by the Gram trick, (..., n, 3) -> (..., n, n)."""
    return torch.sqrt(torch.clamp(sqpairdist(x), min=0.0))


@lru_cache(maxsize=None)
def halfinds(n: int):
    """Upper-triangular (i < j) index arrays in row-major order (numpy)."""
    iu = np.triu_indices(n, k=1)
    return np.asarray(iu[0]), np.asarray(iu[1])


@lru_cache(maxsize=None)
def _halfinds_tensor(n: int, device: torch.device):
    """``halfinds(n)`` as index tensors on ``device``."""
    i, j = halfinds(n)
    return (torch.as_tensor(i, device=device),
            torch.as_tensor(j, device=device))


def flatpairdists(x, atoms=None, use_kernel=None):
    """All-pairs distances from flat coordinates:
    (..., 3 n) -> (..., c (c - 1) / 2), i < j in row-major order, over the
    atom indices ``atoms`` (all by default; gathered first).  The fused
    route (kernels C and C′) serves c >= ``FUSED_MIN_ATOMS``, the Gram
    trick fewer; ``use_kernel`` forces one, as the reference's
    ``use_pallas``."""
    batch = x.shape[:-1]
    b = x.reshape(-1, x.shape[-1] // 3, 3)
    if atoms is not None:
        b = b[:, torch.as_tensor(np.asarray(atoms), dtype=torch.long,
                                 device=x.device), :]
    c = b.shape[1]
    if use_kernel is None:
        use_kernel = c >= FUSED_MIN_ATOMS
    p = sqpairdist_fused(b) if use_kernel else sqpairdist(b)
    i, j = _halfinds_tensor(c, x.device)
    p = torch.sqrt(torch.clamp(p[:, i, j], min=0.0))
    return p.reshape(batch + (len(i),))


def pdists(x, pairs):
    """Distances of an explicit list of atom pairs by direct differences:
    (..., 3N), pairs (m, 2) of 0-based indices -> (..., m)."""
    batch = x.shape[:-1]
    b = x.reshape(-1, x.shape[-1] // 3, 3)
    pairs = torch.as_tensor(pairs, dtype=torch.long, device=x.device)
    d = b[:, pairs[:, 0], :] - b[:, pairs[:, 1], :]
    D = torch.sqrt(torch.clamp(torch.sum(d * d, dim=-1), min=1e-24))
    return D.reshape(batch + (pairs.shape[0],))


def localpdistinds(coords, radius):
    """Pairs (npairs, 2) whose smallest distance over the frames
    ``coords`` (frames, 3N) (or one frame (3N,)) is within ``radius``;
    coincident atoms (distance 0) are left out.  Squared distances by the
    float32 Gram trick, as the reference."""
    coords = np.asarray(coords)
    if coords.ndim == 1:
        coords = coords[None, :]
    traj = torch.as_tensor(coords.reshape(coords.shape[0], -1, 3),
                           dtype=torch.float32)
    mds = sqpairdist(traj).numpy().min(axis=0)
    iu, ju = np.triu_indices(mds.shape[0], k=1)
    mask = (mds[iu, ju] > 0) & (mds[iu, ju] <= radius ** 2)
    return np.stack([iu[mask], ju[mask]], axis=1)


def restricted_localpdistinds(coords, radius, atoms):
    """``localpdistinds`` among ``atoms`` only, in global atom indices."""
    coords = np.asarray(coords)
    if coords.ndim == 1:
        coords = coords[None, :]
    atoms = np.asarray(atoms)
    sub = coords.reshape(coords.shape[0], -1, 3)[:, atoms, :]
    pairs = localpdistinds(sub.reshape(coords.shape[0], -1), radius)
    return np.stack([atoms[pairs[:, 0]], atoms[pairs[:, 1]]], axis=1)


def localpdists(coords, radius):
    """(distances (frames, npairs), pairs) of ``localpdistinds``."""
    inds = localpdistinds(coords, radius)
    x = torch.as_tensor(np.asarray(coords), dtype=torch.float32)
    return pdists(x, inds), inds
