"""Reactive paths: the Onsager-Machlup maximum-likelihood chain through
samples ordered by chi; counterpart of
``isokann_tpu/analysis/reactivepath.py`` (reference
``src/utils/reactivepath.jl``).

The aligned RMSDs of the masked pairs run batched on the samples' device
(``ops.align.aligned_rmsd``).  The shortest path runs on the host (the
host library's CSR Bellman-Ford, ``shortestpath_sparse``, as the JAX
package; scipy's in ``_shortestpath_scipy``, its plain version) or, with
``device=True``, as dense min-plus iterations in torch on the samples'
device (``bellman_ford_dense``).  Samples given as tensors stay on their
device; other arrays go to the card unless the caller names another
device through a tensor.
"""

from __future__ import annotations

import os
import warnings
from dataclasses import dataclass

import numpy as np
import torch

from .._device import as_tensor
from ..ops.align import aligned_rmsd, aligntrajectory


def _host(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


# ---- endpoint selection methods (reference :82-107) -----------------------

@dataclass
class FromToPath:
    s1: int
    s2: int


@dataclass
class QuantilePath:
    q: float = 0.05


@dataclass
class FullPath:
    pass


@dataclass
class MaxPath:
    pass


def fromto(method, xi):
    """(sources, targets) index arrays of the path ``method`` over the
    reaction coordinate ``xi``."""
    xi = _host(xi)
    if isinstance(method, QuantilePath):
        lo = np.quantile(xi, method.q)
        hi = np.quantile(xi, 1 - method.q)
        return np.flatnonzero(xi < lo), np.flatnonzero(xi > hi)
    if isinstance(method, FromToPath):
        return np.asarray([method.s1]), np.asarray([method.s2])
    if isinstance(method, FullPath):
        return np.asarray([0]), np.asarray([len(xi) - 1])
    if isinstance(method, MaxPath):
        return (np.asarray([int(np.argmin(xi))]),
                np.asarray([int(np.argmax(xi))]))
    raise TypeError(f"unknown path method {method}")


# ---- time-difference mask (reference :135-156) ------------------------------

def dtmask(xi, minjump=0.0, maxjump=1.0):
    """(i, j, dt) arrays of the pairs with minjump < xi_j - xi_i <=
    maxjump, by a sweep over the sorted values."""
    assert minjump >= 0
    xi = _host(xi)
    p = np.argsort(xi, kind="stable")
    xs = xi[p]
    n = len(xs)
    I, J, V = [], [], []
    for a in range(n):
        for b in range(a, n):
            dt = xs[b] - xs[a]
            if dt > maxjump:
                break
            if dt > minjump:
                I.append(p[a])
                J.append(p[b])
                V.append(dt)
    return (np.asarray(I, dtype=int), np.asarray(J, dtype=int),
            np.asarray(V, dtype=float))


# ---- Onsager-Machlup log-likelihood (reference :160-169) --------------------

def fin_dim_loglikelihood(dx, dt, sigma, dim):
    """log p of a jump ``dx`` in time ``dt`` of a ``dim``-dimensional
    Brownian motion of amplitude ``sigma`` (float64)."""
    dx = np.asarray(dx, dtype=np.float64)
    dt = np.asarray(dt, dtype=np.float64)
    v = dx / dt
    L = (v / sigma) ** 2 / 2
    s = (-dim / 2) * np.log(sigma ** 2 * dt * 2 * np.pi)
    return s - L * dt


# ---- shortest chain (reference :110-133) ------------------------------------

def pair_costs(xs, xi, sigma=1.0, minjump=0.0, maxjump=1.0, weights=None):
    """(i, j, cost) of the chain's edges: the pairs of ``dtmask`` and
    their raw Onsager-Machlup costs -log p (not shifted: they may be
    negative, and the chi-ordered graph is a DAG).  ``xs``: (n, 3N) rows
    on their device."""
    xs = as_tensor(xs)
    xi = _host(xi).ravel()
    assert xs.shape[0] == len(xi)
    i, j, dts = dtmask(xi, minjump, maxjump)
    if len(i) == 0:
        return i, j, np.zeros(0)
    natoms = xs.shape[1] // 3
    dxs = np.empty(len(i))
    batch = max(1, int(2e8 // max(xs.element_size() * natoms * 6, 1)))
    ti = torch.as_tensor(i, device=xs.device)
    tj = torch.as_tensor(j, device=xs.device)
    for lo in range(0, len(i), batch):
        sl = slice(lo, lo + batch)
        dxs[sl] = aligned_rmsd(xs[ti[sl]].reshape(-1, natoms, 3),
                               xs[tj[sl]].reshape(-1, natoms, 3),
                               weights=weights, flat=False
                               ).double().cpu().numpy()
    return i, j, -fin_dim_loglikelihood(dxs, dts, sigma, xs.shape[1])


def shortestchain(xs, xi, from_, to, sigma=1.0, minjump=0.0, maxjump=1.0,
                  weights=None, device=False):
    """Maximum-likelihood chain through the samples ``xs`` (n, 3N) with
    reaction coordinate ``xi`` (n,), from one of ``from_`` to one of
    ``to``.  ``device=True`` takes the min-plus route on the samples'
    device, with the costs rescaled by their largest magnitude (a positive
    factor: the same argmin path, better conditioned in float32)."""
    xs = as_tensor(xs)
    n = xs.shape[0]
    i, j, cost = pair_costs(xs, xi, sigma, minjump, maxjump, weights)
    if len(i) == 0:
        return []
    if device:
        A = np.full((n, n), np.inf)
        A[i, j] = cost / max(np.abs(cost).max(), 1e-30)
        return shortestpath_dense_device(
            torch.as_tensor(A, dtype=torch.float32, device=xs.device),
            from_, to)
    return shortestpath_sparse(n, i, j, cost, from_, to)


def shortestpath_sparse(n, i, j, w, sources, targets):
    """Host shortest path on the sparse DAG by the host library's CSR
    Bellman-Ford (``native.bellman_ford_csr_native``; the costs may be
    negative), as the JAX package routes it: the path to the nearest
    target, empty when there is none (also for no source or no target).
    ``_shortestpath_scipy`` is its plain version."""
    from scipy.sparse import coo_matrix
    from ..native import bellman_ford_csr_native

    sources = np.asarray(sources)
    targets = np.asarray(targets)
    if len(sources) == 0 or len(targets) == 0:
        return []
    A = coo_matrix((w, (i, j)), shape=(n, n)).tocsr()
    dist, parent = bellman_ford_csr_native(A.indptr, A.indices, A.data, n,
                                           sources)
    t = int(targets[np.argmin(dist[targets])])
    if not np.isfinite(dist[t]):
        return []
    path = [t]
    while parent[path[-1]] >= 0:
        path.append(int(parent[path[-1]]))
    return path[::-1]


def _shortestpath_scipy(n, i, j, w, sources, targets):
    """``shortestpath_sparse`` by scipy's Bellman-Ford: the best (source,
    target) pair's path, empty when there is none."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import bellman_ford

    sources = np.asarray(sources)
    targets = np.asarray(targets)
    if len(sources) == 0 or len(targets) == 0:
        return []
    A = coo_matrix((w, (i, j)), shape=(n, n)).tocsr()
    dists, pred = bellman_ford(A, directed=True, indices=sources,
                               return_predecessors=True)
    sub = dists[:, targets]
    si, ti = np.unravel_index(np.argmin(sub), sub.shape)
    if not np.isfinite(sub[si, ti]):
        return []
    path = [int(targets[ti])]
    while path[-1] != sources[si]:
        p = pred[si, path[-1]]
        if p < 0:
            break
        path.append(int(p))
    return path[::-1]


def bellman_ford_dense(A, sources):
    """Dense min-plus Bellman-Ford on ``A``'s device (the reference's GPU
    path, ``src/utils/reactivepath.jl:228-245``): ``A`` (n, n) costs, inf
    for a missing edge (A[i, j] = cost i -> j).  Iterates while some
    distance improves by more than 1e-8, at most n times.  Returns
    (dists, parents) on that device, -1 for no parent."""
    A = as_tensor(A)
    n = A.shape[0]
    src = torch.as_tensor(np.atleast_1d(_host(sources)).astype(np.int64),
                          device=A.device)
    d = torch.full((n,), float("inf"), dtype=torch.float32, device=A.device)
    d[src] = 0.0
    par = torch.full((n,), -1, dtype=torch.int32, device=A.device)
    it = 0
    changed = True
    while changed and it < n:
        nxt = d[:, None] + A                      # (n, n): via i to j
        pp = torch.argmin(nxt, dim=0)
        dd = torch.gather(nxt, 0, pp[None, :])[0]
        new = dd + 1e-8 < d
        d = torch.where(new, dd, d)
        par = torch.where(new, pp.to(torch.int32), par)
        changed = bool(new.any())
        it += 1
    return d, par


def shortestpath_dense_device(A, sources, targets):
    """The path of ``bellman_ford_dense`` to the nearest target (empty
    when none is reached)."""
    targets = np.atleast_1d(_host(targets))
    if len(targets) == 0:
        return []
    d, par = bellman_ford_dense(A, sources)
    d = d.cpu().numpy()
    par = par.cpu().numpy()
    t = int(targets[np.argmin(d[targets])])
    if not np.isfinite(d[t]):
        return []
    path = [t]
    while par[path[-1]] >= 0:
        path.append(int(par[path[-1]]))
    return path[::-1]


def shortestpath(A, sources, targets):
    """Shortest path through a dense cost matrix (inf = no edge) on its
    device."""
    return shortestpath_dense_device(A, np.atleast_1d(sources),
                                     np.atleast_1d(targets))


# ---- public API (reference :31-78) ------------------------------------------

def _isincreasing(ids):
    ids = np.asarray(ids)
    return np.sum(np.diff(ids) > 0) > len(ids) / 2


def reactive_path(xi, coords, sigma=1.0, minjump=0.0, maxjump=1.0,
                  method=None, normalize=False, sortincreasing=True,
                  weights=None, device=False):
    """Maximum-likelihood path ids through ``coords`` (n, 3N) ordered by
    the reaction coordinate ``xi`` (reference
    ``src/utils/reactivepath.jl:55-68``); ``device=True`` takes the
    min-plus route (``shortestchain``)."""
    method = method or QuantilePath(0.05)
    xi = _host(xi).ravel()
    coords = as_tensor(coords)
    from_, to = fromto(method, xi)
    nco = coords / coords.abs().max() if normalize else coords
    ids = shortestchain(nco, xi, from_, to, sigma=sigma, minjump=minjump,
                        maxjump=maxjump, weights=weights, device=device)
    if sortincreasing and len(ids) > 1 and not _isincreasing(xi[ids]):
        ids = ids[::-1]
    return list(ids)


def save_reactive_path(iso, coords=None, sigma=1.0, maxjump=1.0,
                       out="out/reactive_path.pdb", source=None, chi=None,
                       weights=None, fullcoords=None, **kwargs):
    """Extract the reactive path of ``iso``'s start points, align it
    (mass-weighted for an MD simulation) and write it as a PDB
    trajectory (reference ``src/utils/reactivepath.jl:31-52``).  Returns
    the path's ids; warns and writes nothing when it is empty."""
    from ..md.pdbio import write_pdb_traj

    if coords is None:
        coords = iso.data.coords
    coords = as_tensor(coords)
    if chi is None:
        chi = iso.chicoords(coords)
    chi = _host(chi).ravel()
    if weights is None and hasattr(iso.data.sim, "masses"):
        weights = iso.data.sim.masses()
    if weights is not None:
        weights = torch.as_tensor(weights, dtype=torch.float32,
                                  device=coords.device)
        if len(weights) == coords.shape[1]:   # per-coordinate -> per-atom
            weights = weights.reshape(-1, 3)[:, 0]
    source = source or iso.data.pdbfile
    fullcoords = coords if fullcoords is None else as_tensor(fullcoords)

    ids = reactive_path(chi, coords, sigma=sigma, maxjump=maxjump,
                        weights=weights, **kwargs)
    if len(ids) == 0:
        warnings.warn("The computed reactive path is empty. "
                      "Try adjusting the `sigma` parameter.")
        return ids
    sel = torch.as_tensor(ids, device=fullcoords.device)
    path = aligntrajectory(fullcoords[sel], weights=weights)
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    write_pdb_traj(out, source, path)
    return ids
