"""ISOKANN target transforms; counterpart of ``isokann_tpu/targets.py``.

The 1-D shift-scale target (``TransformShiftscale``) is tensor math on
the model's device, fused into ``Iso.run``'s loop.  The
multi-dimensional transforms (ISA, pseudo-inverse, Gram-Schmidt,
LeftRight, SVD, Pinv, Cross) work on (n, d) matrices with d <= ~5; as in
the reference they run on the host in float64 numpy/scipy, on the
float32 chi values that ``isotarget`` fetches from the device in one
transfer per Koopman iteration, and return float32 numpy (n, d).

Array convention: chi and Kchi are ``(n, d)``; the transforms that keep
the reference's ``(d, n)`` algebra transpose at the boundary.  A "model"
argument is any callable ``x -> chi`` over features ``(..., f)``
returning ``(..., d)``, as a numpy array or a tensor.
"""

from __future__ import annotations

import itertools
import logging
import math
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import scipy.linalg
import torch

_log = logging.getLogger(__name__)

# times a transform missed the stacked chi evaluation of ``isotarget``
# and fell back to a model call of its own
stacked_fallback_count = 0


class DomainError(ValueError):
    """Raised when a target transform degenerates (constant chi, singular
    subspace) or the model collapses under training."""


def _f64(a) -> np.ndarray:
    """float64 numpy of a numpy array or a tensor."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, dtype=np.float64)


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, dtype=np.float32)


# ==========================================================================
# Koopman expectation
# ==========================================================================

def expectation(model, ys):
    """Monte-Carlo Koopman expectation of ``model`` over the k-axis of
    ys (n, k, f): the mean, or for ``WeightedSamples`` the Girsanov
    estimate sum_k w chi / k.  Returns (n, d), numpy where the model
    returns numpy."""
    from .data import WeightedSamples

    if isinstance(ys, WeightedSamples):
        vals = model(ys.values)
        if isinstance(vals, np.ndarray):
            w = _f32(ys.weights)
            return np.sum(vals * w[..., None], axis=-2) / vals.shape[-2]
        return torch.sum(vals * ys.weights[..., None], dim=-2) / vals.shape[-2]
    vals = model(ys)
    if isinstance(vals, np.ndarray):
        # einsum sums the k rows in order, as np.mean does for d > 1, at
        # a fifth of its time on a strided axis
        return np.einsum("...kd->...d", vals) / vals.shape[-2]
    return torch.mean(vals, dim=-2)


def features(data):
    return data[0] if isinstance(data, tuple) else data.features


def propfeatures(data):
    return data[1] if isinstance(data, tuple) else data.propfeatures


@torch.no_grad()
def chi_kchi(model, data):
    """(chi at the start points, Kchi over the bursts) of ``data`` (a
    ``SimulationData`` or an (xs, ys) tuple)."""
    return model(features(data)), expectation(model, propfeatures(data))


@torch.no_grad()
def koopman(iso, data=None):
    data = iso.data if data is None else data
    return expectation(iso.model, propfeatures(data))


def _chi_kchi_host(iso, data=None):
    x, y = chi_kchi(iso.model, iso.data if data is None else data)
    return _f64(x), _f64(y)


# ==========================================================================
# 1-D shift-scale
# ==========================================================================

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

    def __call__(self, model, xs, ys):
        return shiftscale(torch.as_tensor(expectation(model, ys)),
                          self.quantile)

    def fused_target(self, kchi, mask=None, n_true=None):
        return shiftscale_jit(kchi, mask, n_true, self.quantile)


# ==========================================================================
# Multidimensional ISA
# ==========================================================================

def indexmap(X: np.ndarray) -> np.ndarray:
    """Inner-simplex vertex search (PCCA+ ``indexmap``): greedily pick the
    d rows of X (n x d) spanning the largest simplex."""
    X = np.asarray(X, dtype=np.float64)
    n, d = X.shape
    inds = np.zeros(d, dtype=int)
    ortho = X.copy()
    for j in range(d):
        norms = np.linalg.norm(ortho, axis=1)
        inds[j] = int(np.argmax(norms))
        v = ortho[inds[j]].copy()
        if j == 0:
            ortho = ortho - v   # translate so that the first vertex is 0
        else:
            nv = np.linalg.norm(v)
            if nv > 0:
                v /= nv
                ortho = ortho - np.outer(ortho @ v, v)
    return inds


def myisa(X: np.ndarray, whitening: bool = False) -> np.ndarray:
    """The (d, d) inner simplex transform A of the Kchi matrix X (n, d)
    (no feasibilization): ``X @ A`` are simplex memberships."""
    X = np.asarray(X, dtype=np.float64)
    try:
        if whitening:
            C = (X.T @ X) / X.shape[0]
            evals, evecs = np.linalg.eigh(C)
            W = evecs @ np.diag(evals ** -0.5) @ evecs.T
            i = indexmap(X @ W)
        else:
            i = indexmap(X)
        return np.linalg.inv(X[i, :])
    except np.linalg.LinAlgError as e:
        raise DomainError(
            "Could not compute the simplex transformation. "
            "The subspace might be singular/collapsed") from e


def fixperm(new, old):
    """Permute the columns of ``new`` (n, d) to minimize the L1 distance
    to ``old`` (brute force over the d! permutations)."""
    new = np.asarray(new)
    old = np.asarray(old)
    d = new.shape[-1]
    best, bestp = np.inf, tuple(range(d))
    for p in itertools.permutations(range(d)):
        dist = np.abs(new[:, list(p)] - old).sum()
        if dist < best:
            best, bestp = dist, p
    return new[:, list(bestp)]


@dataclass
class TransformISA:
    """Multi-dimensional target by the inner simplex algorithm; the
    default target for d > 1."""

    fused = False
    permute: bool = True
    whitening: bool = False

    def __call__(self, model, xs, ys):
        chi = _f64(model(xs))
        if chi.shape[-1] <= 1:
            raise DomainError("TransformISA does not work with one "
                              "dimensional chi functions")
        ks = _f64(expectation(model, ys))                        # (n, d)
        target = ks @ myisa(ks, self.whitening)
        if self.permute:
            target = fixperm(target, chi)
        return _f32(target)


# ==========================================================================
# Pseudo-inverse transform
# ==========================================================================

@dataclass
class TransformPseudoInv:
    """Target by approximately inverting K with the Moore-Penrose
    pseudo-inverse, in the reference's (d, n) layout."""

    fused = False
    normalize: bool = True
    direct: bool = True
    eigenvecs: bool = True
    permute: bool = True

    def __call__(self, model, xs, ys):
        chi = _f64(model(xs)).T                                  # (d, n)
        if chi.shape[0] <= 1:
            raise DomainError("TransformPseudoInv does not work with one "
                              "dimensional chi functions")
        kchi = _f64(expectation(model, ys)).T                    # (d, n)
        try:
            kchi_inv = np.linalg.pinv(kchi)
        except np.linalg.LinAlgError as e:
            raise DomainError(
                "Could not compute the pseudoinverse. "
                "The subspace might be singular/collapsed") from e
        if self.direct:
            Kinv = chi @ kchi_inv
            T = (scipy.linalg.schur(Kinv)[1] if self.eigenvecs
                 else np.eye(Kinv.shape[0]))
            target = T @ Kinv @ kchi
        else:
            K = kchi @ kchi_inv
            T = (scipy.linalg.schur(K)[1] if self.eigenvecs
                 else np.eye(K.shape[0]))
            target = T @ np.linalg.inv(K) @ kchi
        if self.normalize:
            norms = np.abs(target).sum(axis=1, keepdims=True)
            target = target / norms * target.shape[1]
        target = target.T                                        # (n, d)
        if self.permute:
            target = fixperm(target, chi.T)
        return _f32(target)


# ==========================================================================
# Stabilization wrapper
# ==========================================================================

@dataclass
class Stabilize:
    """Wraps another transform, flipping (1-D) or permuting (N-D) the
    target to match the previous one."""

    target: Any
    last: Any = None
    fused = False

    def __call__(self, model, xs, ys):
        t = _f32(self.target(model, xs, ys))
        if self.last is None:
            self.last = t
        if isinstance(self.target, TransformShiftscale):
            if float(np.abs(t - self.last).sum()) > t.size / 2:
                t = 1.0 - t
            self.last = t
            return t
        t = fixperm(t, self.last)
        self.last = t
        return t


# ==========================================================================
# Gram-Schmidt / LeftRight / SVD / Pinv / Cross (host float64)
# ==========================================================================

@dataclass
class TransformGramSchmidt:
    """Orthonormalize the Kchi columns by a thin QR with a sign fix."""

    fused = False

    def __call__(self, model, xs, ys):
        kchi = _f64(expectation(model, ys))                      # (n, d)
        q, r = np.linalg.qr(kchi)
        return _f32(q * np.sign(np.diag(r))[None, :])


def realsubspace(V: np.ndarray) -> np.ndarray:
    """Real invariant subspace from complex-conjugate eigenvector pairs."""
    V = V.copy()
    i = 0
    while i + 1 < V.shape[1]:
        if np.allclose(V[:, i], np.conj(V[:, i + 1])):
            re = np.real(V[:, i]).copy()
            im = np.imag(V[:, i + 1]).copy()
            V[:, i] = re
            V[:, i + 1] = im
            i += 2
        else:
            i += 1
    return np.real(V)


def _domsubspace_eigen(A: np.ndarray):
    vals, vecs = np.linalg.eig(A)
    order = np.argsort(-np.abs(np.real(vals)))
    vals, vecs = vals[order], vecs[:, order]
    return realsubspace(vecs), vals


def _transformleftright(L: np.ndarray, R: np.ndarray):
    """Eigen-decomposition of the Krylov-style subspace map; ``L``, ``R``:
    (n, D), a function a column."""
    D = L.shape[1]
    LR = np.hstack([R, L])
    q, r = np.linalg.qr(LR)
    qR = r[:, :D]
    qL = r[:, D:]
    A = np.linalg.lstsq(qL.T, qR.T, rcond=None)[0].T     # A = qR / qL
    vecs, vals = _domsubspace_eigen(A)
    vals = vals[:D]
    vecs = vecs[:, :D]
    target = q @ vecs
    s = np.sum(L * target, axis=0, keepdims=True)
    target = target * np.sign(s)
    target = target * np.real(vals)[None, :]
    return target * np.sqrt(target.shape[0])


def _addones(x: np.ndarray) -> np.ndarray:
    c = np.full((x.shape[0], 1), 1.0 / np.sqrt(x.shape[0]))
    return np.hstack([c, x])


@dataclass
class TransformLeftRight:
    """Dominant-eigenvector targets from the <L, R> Krylov space."""

    fused = False

    def __call__(self, model, xs, ys):
        L = _f64(model(xs))                                      # (n, d)
        R = _f64(expectation(model, ys))
        d = L.shape[1]
        return _f32(_transformleftright(_addones(L), _addones(R))[:, 1:d + 1])


def updatehistory(L: np.ndarray, l: np.ndarray) -> np.ndarray:
    """Insert the newest observations into columns 1..d of the history
    matrix; column 0 stays the constant vector."""
    n, d = l.shape
    m, h = L.shape
    if n > m:
        Lnew = np.zeros((n, h))
        Lnew[:m, :] = L
        L = Lnew
    elif n < m:
        raise ValueError("automated shrinking is not supported")
    L = L.copy()
    L[:, 0] = 1.0 / np.sqrt(L.shape[0])
    L[:, 1 + d:] = L[:, 1:-d] if d > 0 else L[:, 1:]
    L[:, 1:d + 1] = l
    return L


@dataclass
class TransformLeftRightHistory:
    """LeftRight over a history matrix of width ``hist``."""

    hist: int = 5
    L: np.ndarray = field(default=None)
    R: np.ndarray = field(default=None)
    fused = False

    def __call__(self, model, xs, ys):
        l = _f64(model(xs))                                      # (n, d)
        r = _f64(expectation(model, ys))
        n, d = l.shape
        if self.L is None:
            self.L = np.ones((0, self.hist))
            self.R = np.ones((0, self.hist))
        if not self.L.shape[1] == self.R.shape[1] >= d + 1:
            raise ValueError(f"history width {self.L.shape[1]} < d + 1")
        self.L = updatehistory(self.L, l)
        self.R = updatehistory(self.R, r)
        return _f32(_transformleftright(self.L, self.R)[:, 1:d + 1])


@dataclass
class TransformSVD:
    """DMD-like reduced operator from the SVD of chi."""

    fused = False

    def __call__(self, model, xs, ys):
        L = _f64(model(xs))                                      # (n, d)
        R = _f64(expectation(model, ys))
        d = L.shape[1]
        U, S, Vt = np.linalg.svd(L, full_matrices=False)
        H = U.T @ R @ Vt.T @ np.diag(1.0 / S)
        vals, vecs = np.linalg.eig(H)
        order = np.argsort(-np.real(vals))
        return _f32(U @ np.real(vecs[:, order][:, :d]))


@dataclass
class TransformSVDRev:
    """DMD-like variant from the SVD of Kchi."""

    fused = False

    def __call__(self, model, xs, ys):
        L = _f64(model(xs))
        R = _f64(expectation(model, ys))
        d = L.shape[1]
        U, S, Vt = np.linalg.svd(R, full_matrices=False)
        H = U.T @ R @ Vt.T @ np.diag(1.0 / S)
        vals, vecs = np.linalg.eig(H)
        return _f32(U @ np.real(vecs[:, :d]))


def rownormalize(x: np.ndarray, p: int = 2) -> np.ndarray:
    return x / np.linalg.norm(x, ord=p, axis=1, keepdims=True)


def target_pseudoinverse(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Inverse-Koopman target in rowspace; ``x``, ``y``: (d, n)."""
    if not x.shape[0] < x.shape[1]:
        raise ValueError("target_pseudoinverse needs d < n")
    kinv = x @ np.linalg.pinv(y)

    def mysort_key(c):
        a = np.real(c)
        return np.inf if a < 0.9 else a

    vals, vecs = np.linalg.eig(kinv)
    order = sorted(range(len(vals)), key=lambda i: mysort_key(vals[i]))
    vals, vecs = vals[order], vecs[:, order]
    Q = realsubspace(vecs)
    target = np.linalg.solve(Q, y)
    target = target / np.sqrt((target ** 2).sum(axis=1, keepdims=True)) * 50
    return target * np.sign((x * target).sum(axis=1, keepdims=True))


@dataclass
class TransformPinv:
    """Pinv-in-rowspace transform with a history and an optional fixed
    constant row."""

    d: int = 1
    hist: int = 2
    fixedone: bool = False
    L: np.ndarray = field(default=None)
    R: np.ndarray = field(default=None)
    fused = False

    def __post_init__(self):
        if self.hist < self.d:
            raise ValueError("TransformPinv needs hist >= d")
        rows = self.d + 1 if self.fixedone else self.d
        if self.L is None:
            self.L = np.ones((rows, self.hist))
            self.R = np.ones((rows, self.hist))

    def _updatehistory(self, x, y):
        d = x.shape[0]
        if self.L.shape[1] != x.shape[1]:
            rows = self.L.shape[0]
            self.L = np.ones((rows, x.shape[1]))
            self.R = np.ones((rows, x.shape[1]))
        # R's history rows shift from L, as the reference's do
        if self.fixedone:
            self.L[d + 1:, :] = self.L[1:-d, :]
            self.R[d + 1:, :] = self.L[1:-d, :]
            self.L[1:d + 1, :] = x
            self.R[1:d + 1, :] = y
        else:
            self.L[d:, :] = self.L[:-d, :]
            self.R[d:, :] = self.L[:-d, :]
            self.L[:d, :] = x
            self.R[:d, :] = y

    def __call__(self, model, xs, ys):
        x = _f64(model(xs)).T                                    # (d, n)
        y = _f64(expectation(model, ys)).T
        d = x.shape[0]
        self._updatehistory(x, y)
        target = target_pseudoinverse(self.L, self.R)
        target = target[1:d + 1, :] if self.fixedone else target[:d, :]
        return _f32(target.T)


# --- Rayleigh-Ritz cross-transform family ---

def rr_svd(X, Y):
    """Rayleigh-Ritz in the SVD basis of X."""
    U, S, Vt = np.linalg.svd(X, full_matrices=False)
    Kh = U.T @ Y @ Vt.T @ np.diag(1.0 / S)
    vals, vecs = np.linalg.eig(Kh)
    order = np.argsort(-np.real(vals))
    return vals[order], U @ vecs[:, order]


def rr_svd_i(X, Y):
    vals, vecs = rr_svd(Y, X)
    return 1.0 / vals[::-1], vecs[:, ::-1]


def rr_svd_si(X, Y):
    vals, vecs = rr_svd(X - Y, X)
    return 1.0 - 1.0 / vals, vecs


def rr_gev(X, Y):
    """Rayleigh-Ritz by the generalized eigenproblem (X'Y, X'X)."""
    C = X.T @ X
    M = X.T @ Y
    vals, vecs = scipy.linalg.eig(M, C)
    order = np.argsort(-np.real(vals))
    return vals[order], Y @ vecs[:, order]


def rr_cross(X, Y, alpha=1e-8, tau=1e-3, p=2.0, wmin=1e-3,
             clip_s=(1e-2, 10.0)):
    """Tikhonov-regularized Rayleigh-Ritz over accumulated (chi, Kchi)
    columns, with residual weights."""
    Q, R = np.linalg.qr(Y)
    C = X.T @ X + alpha * np.eye(X.shape[1])
    M = X.T @ Q
    T = R @ np.linalg.solve(C, M)
    vals, vecs = np.linalg.eig(T)
    order = np.argsort(-np.real(vals))
    vals, vecs = vals[order], vecs[:, order]
    V = Q @ vecs

    Lam = np.diag(vals)
    Rres = X @ vecs - (Y @ vecs) @ Lam
    residuals = np.sqrt((np.abs(Rres) ** 2).sum(axis=0))
    Ynorms = np.sqrt((np.abs(Y @ vecs) ** 2).sum(axis=0))
    Xnorms = np.sqrt((np.abs(X @ vecs) ** 2).sum(axis=0))
    eps = np.finfo(float).eps
    denom = np.abs(vals) * (Ynorms + eps) + Xnorms + eps
    relres = residuals / denom
    w = 1.0 / (1 + (relres / tau) ** p)
    w = np.clip(np.real(w), wmin, 1.0)
    s = np.clip(np.sqrt(w), clip_s[0], clip_s[1])
    return dict(vals=vals, vecs=V, res=residuals, relres=relres, weights=w,
                vecs0=V, s=s)


@dataclass
class TransformCross:
    """Accumulates past (chi, Kchi) columns; Rayleigh-Ritz target."""

    npoints: int = 0
    maxcols: int = 10
    X: np.ndarray = field(default=None)
    Y: np.ndarray = field(default=None)
    fused = False

    def __post_init__(self):
        if self.X is None:
            self.X = np.zeros((self.npoints, 0))
            self.Y = np.zeros((self.npoints, 0))

    def reset(self):
        self.X = np.zeros((self.X.shape[0], 0))
        self.Y = np.zeros((self.Y.shape[0], 0))

    def __call__(self, model, xs, ys):
        x = _f64(model(xs))                                      # (n, d)
        y = _f64(expectation(model, ys))
        N, M = y.shape
        if self.X.shape[0] != N:
            self.X = np.zeros((N, 0))
            self.Y = np.zeros((N, 0))
        if self.X.shape[1] < M or not np.array_equal(self.X[:, -M:], x):
            self.X = np.hstack([self.X, x])[:, -self.maxcols:]
            self.Y = np.hstack([self.Y, y])[:, -self.maxcols:]
        z = rr_cross(self.X, self.Y)
        t = np.real(z["vecs"][:, :M]) * np.sqrt(N)
        return _f32(t * np.sign((t * x).sum(axis=0, keepdims=True)))


# ==========================================================================
# Residual diagnostics
# ==========================================================================

def residual_linear(iso, data=None):
    """Column-wise lambda-fit residual: relative residual per chi
    dimension of Kchi ~ lambda chi."""
    f, g = (a.T for a in _chi_kchi_host(iso, data))          # (d, n)
    lam = np.mean(g / f, axis=1, keepdims=True)
    res = g - lam * f
    relres = np.linalg.norm(res, axis=1) / np.linalg.norm(g, axis=1)
    return dict(res=res, relres=relres, **{"lambda": lam})


def qr_thin(A: np.ndarray):
    return np.linalg.qr(A)


def residual_ritz(iso, data=None):
    """Ritz residuals of the approximate invariant subspace."""
    V, KV = _chi_kchi_host(iso, data)                         # (n, d)
    Q, R = qr_thin(V)
    KQ = KV @ np.linalg.inv(R)
    Kr = Q.T @ KQ
    vals, vecs = np.linalg.eig(Kr)
    order = np.argsort(np.abs(1 - vals))
    vals, vecs = vals[order], vecs[:, order]
    residues = KQ @ vecs - (Q @ vecs) * vals[None, :]
    relres = (np.linalg.norm(residues, axis=0)
              / np.linalg.norm(KQ @ vecs, axis=0))
    return dict(residues=residues, relres=relres, vals=vals, vecs=vecs, Q=Q)


def residual_subspace(V, KV=None, V_norms=False, iso=None):
    """Projection residual of KV onto span(V); ``residual_subspace(iso)``
    takes V and KV from the learner."""
    if KV is None:
        V, KV = _chi_kchi_host(V)
    V, KV = _f64(V), _f64(KV)
    Q, _ = qr_thin(V)
    res = KV - Q @ (Q.T @ KV)
    denom = np.linalg.norm(V if V_norms else KV, axis=0)
    return dict(res=res, relres=np.linalg.norm(res, axis=0) / denom)


# ==========================================================================
# Dispatch
# ==========================================================================

def isotarget(iso, target=None):
    """The training target of ``iso`` from a host-side transform.

    chi(xs) and chi(ys) are one forward pass over the concatenated rows,
    and reach the host in one transfer (with the Girsanov weights, if
    any): on the card, the one host sync of a Koopman iteration.  The
    transform's model returns those arrays for the very xs / ys objects
    it is given (the feature tensors); any other input falls back to a
    model call of its own (counted in ``stacked_fallback_count``).  A
    non-finite chi raises ``DomainError``: the model collapsed."""
    from .data import WeightedSamples, values

    t = iso.target if target is None else target
    xs = features(iso.data)
    ys_raw = propfeatures(iso.data)
    weighted = isinstance(ys_raw, WeightedSamples)
    vals = values(ys_raw)
    n, k = vals.shape[:2]
    nx = xs.shape[0]
    with torch.no_grad():
        out = iso.model(torch.cat([xs, vals.reshape(n * k, -1)], dim=0))
        d = out.shape[-1]
        flat = out.reshape(-1)
        if weighted:
            flat = torch.cat([flat, ys_raw.weights.reshape(-1).to(flat.dtype)])
        host = flat.cpu().numpy()
    chi = host[:(nx + n * k) * d].reshape(nx + n * k, d)
    if not np.all(np.isfinite(chi)):
        raise DomainError(
            "The ISOKANN model collapsed under training. Try reducing the "
            "learning rate or increasing regularization")
    chi_x = chi[:nx]
    chi_y = chi[nx:].reshape(n, k, d)

    def model(z):
        if z is xs:
            return chi_x
        if z is vals:
            return chi_y
        global stacked_fallback_count
        stacked_fallback_count += 1
        _log.debug("isotarget stacked-evaluation fallback #%d: transform "
                   "%s passed another input (shape %s)",
                   stacked_fallback_count, type(t).__name__,
                   tuple(np.shape(z)))
        with torch.no_grad():
            return _f32(iso.model(torch.as_tensor(
                z, dtype=torch.float32, device=xs.device)))

    ys = (WeightedSamples(vals, host[(nx + n * k) * d:].reshape(n, k))
          if weighted else vals)
    return t(model, xs, ys)
