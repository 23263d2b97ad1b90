"""Adaptive-sampling primitives; counterpart of ``isokann_tpu/sample.py``
(reference ``src/utils/subsample.jl``, ``src/utils/picking.jl`` and
``legacy/extrapolate.jl``).

The selections are host numpy on small 1-D chi arrays: chi-uniform
stratified picks (``subsample_uniformgrid``, ``pickclosest``), average
shifted histogram and Gaussian-KDE gap filling (``ASH``,
``resample_kde_ash``, ``kde_needles``, ``resample_kde_needles``) and
greedy farthest-point picking (``picking``).  ``picking_aligned`` takes
its aligned-RMSD distances on the data's device; chi extrapolation
(``dchidx``, ``extrapolate_x``, ``extrapolate``, ``addextrapolates``)
runs autograd there.

``pickclosest`` runs the reference's sorted sweep in Python; the JAX
package runs the same sweep in its native helper when that is built.

The greedy pick loop evaluates the density at each candidate's bin by the
truncated triangular-kernel sum, accumulated bin by bin in ascending
order, and rounds a candidate to its bin half away from zero: the
arithmetic of the JAX package's native fast path, so both packages pick
the same indices from the same chi values.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from .analysis.minimumpath import dchidx, energyminimization_chilevel


def subsample_uniformgrid(ys, n, keepedges=True, rng=None):
    """Indices such that ``ys[inds]`` approximates a uniform distribution
    on [0, 1]: the points closest to a randomly perturbed uniform grid
    (``rng``: a ``np.random.Generator``)."""
    rng = np.random.default_rng() if rng is None else rng
    ys = np.asarray(ys).ravel()
    if n <= 2:
        keepedges = False
    m = n - 2 if keepedges else n
    needles = (rng.random(m) + np.arange(m)) / m
    if keepedges:
        needles = np.concatenate([[0.0], needles, [1.0]])
    return pickclosest(ys, needles)


def pickclosest(haystack, needles):
    """Indices into ``haystack`` closest to ``needles``, without
    duplicates (a candidate is removed once matched); a sorted sweep."""
    hs = np.asarray(haystack, dtype=np.float64).ravel()
    ns = np.asarray(needles, dtype=np.float64).ravel()
    ih = np.argsort(hs, kind="stable")
    rs = _pickclosest_sorted(hs[ih], np.sort(ns))
    return ih[rs]


def _pickclosest_sorted(hs: np.ndarray, ns: np.ndarray):
    """Linear sweep over the sorted haystack and needles (reference
    ``_pickclosestloop``, ``src/utils/subsample.jl:52-76``)."""
    nh = len(hs)
    avail = np.ones(nh, dtype=bool)
    rs = []
    i = 0
    for needle in ns:
        di = abs(hs[i] - needle)
        while True:
            j = i + 1
            while j < nh and not avail[j]:
                j += 1
            if j < nh and abs(hs[j] - needle) <= di:
                di = abs(hs[j] - needle)
                i = j
            else:
                rs.append(i)
                avail[i] = False
                # step back to the previous available candidate
                k = i - 1
                while k >= 0 and not avail[k]:
                    k -= 1
                i = k
                break
        if i < 0:
            nxt = np.flatnonzero(avail)
            if len(nxt) == 0:
                break
            i = int(nxt[0])
    return np.asarray(rs, dtype=int)


class ASH:
    """1-D average-shifted-histogram density on a fixed grid: a histogram
    of bin width ``step`` smoothed with a triangular kernel of half-width
    ``m`` bins."""

    def __init__(self, xs, lo=-0.1, hi=1.1, step=0.001, m=20):
        self.lo, self.step = lo, step
        self.nbins = int(round((hi - lo) / step)) + 1
        self.m = m
        self.counts = np.zeros(self.nbins)
        self.n = 0
        self.add(np.asarray(xs, dtype=np.float64))

    def _binindex(self, x):
        idx = np.round((np.asarray(x, dtype=np.float64) - self.lo)
                       / self.step).astype(int)
        return np.clip(idx, 0, self.nbins - 1)

    def add(self, xs):
        xs = np.atleast_1d(xs)
        np.add.at(self.counts, self._binindex(xs), 1.0)
        self.n += len(xs)
        self._density = None

    @property
    def density(self):
        if getattr(self, "_density", None) is None:
            m = min(self.m, self.nbins)
            kern = 1.0 - np.abs(np.arange(-m + 1, m)) / m
            h = m * self.step
            conv = np.convolve(self.counts, kern, mode="same")
            if len(conv) != self.nbins:      # kernel longer than grid
                lo = (len(conv) - self.nbins) // 2
                conv = conv[lo:lo + self.nbins]
            self._density = conv / (self.n * h)
        return self._density

    def pdf(self, x):
        return self.density[self._binindex(x)]

    @property
    def grid(self):
        return self.lo + np.arange(self.nbins) * self.step


def kde_interior(kde: ASH):
    """Mask of grid points inside [0, 1] (the resampling domain)."""
    g = kde.grid
    return (g >= 0.0) & (g <= 1.0)


def _round_half_away(v):
    r = np.round(v)
    half = np.abs(v - np.trunc(v)) == 0.5
    return np.where(half, np.trunc(v) + np.sign(v), r)


def _greedy_picks(ys, p, counts, lo, step, window, n0, npick):
    """Pick ``npick`` candidates one at a time: the largest
    p - density(bin), then zero its p and add it to the histogram."""
    nbins = len(counts)
    ybin = np.clip(_round_half_away((ys - lo) / step).astype(np.int64), 0,
                   nbins - 1)
    h = float(window) * step
    n = float(n0)
    out = np.empty(npick, dtype=np.int64)
    for k in range(npick):
        acc = np.zeros(len(ys))
        for off in range(-window + 1, window):
            j = ybin + off
            ok = (j >= 0) & (j < nbins)
            w = 1.0 - abs(off) / window
            acc = acc + np.where(ok, w * counts[np.clip(j, 0, nbins - 1)],
                                 0.0)
        delta = p - acc / (n * h)
        bi = int(np.argmax(delta))
        out[k] = bi
        p[bi] = 0.0
        counts[ybin[bi]] += 1.0
        n += 1.0
    return out


def resample_kde_ash(xs, ys, n=10, m=20, bandwidth=None, target=None):
    """Pick n indices of ``ys`` such that ``[xs; ys[iys]]`` approaches the
    target (default uniform on [0, 1]) density: periodic closure of
    [0, 1], window growth for large gaps, greedy gap-filling.
    ``bandwidth`` is accepted for the reference's signature and unused."""
    xs = np.asarray(xs, dtype=np.float64).ravel()
    ys = np.asarray(ys, dtype=np.float64).ravel()
    target_pdf = target if callable(target) else (
        lambda y: ((0.0 <= y) & (y <= 1.0)).astype(np.float64))

    closure = np.concatenate([xs, -xs, 2.0 - xs])
    kde = ASH(closure, m=m)
    mmax = kde.nbins // 2
    while (kde.density[kde_interior(kde)].min() <= 0.1
           or kde.density.max() > 3) and m < mmax:
        m = min(int(round(m * 1.2)) + 1, mmax)
        kde = ASH(closure, m=m)

    p = np.array(target_pdf(ys), dtype=np.float64)
    return _greedy_picks(ys, p, kde.counts.copy(), kde.lo, kde.step, kde.m,
                         kde.n, n)


def kde_needles(xs, n=10, bandwidth=0.02, target=None):
    """Gaussian-KDE gap filling: ``n`` needles, each at the minimum of
    KDE - target over a 512-point grid spanning ``xs``, added to ``xs``
    before the next (reference ``src/utils/subsample.jl:106-119``)."""
    from scipy.stats import gaussian_kde

    xs = list(np.asarray(xs, dtype=np.float64).ravel())
    target_pdf = target if callable(target) else (lambda y: np.ones_like(y))
    needles = []
    grid = np.linspace(min(xs), max(xs), 512)
    for _ in range(n):
        k = gaussian_kde(np.asarray(xs),
                         bw_method=bandwidth / max(np.std(xs), 1e-9))
        c = grid[int(np.argmin(k(grid) - target_pdf(grid)))]
        needles.append(c)
        xs.append(c)
    return np.asarray(needles)


def resample_kde_needles(xs, ys, n, **kwargs):
    """Indices of ``ys`` that fill the gaps of the KDE of ``xs`` (reference
    ``src/utils/subsample.jl:92-99``)."""
    return pickclosest(ys, kde_needles(xs, n, **kwargs))


def picking(X, n, dists: Optional[Callable] = None):
    """Greedy max-min (farthest point) picking of ``n`` rows of ``X``
    (npts, d), from the row farthest from the origin.  Returns (the
    picked rows, their indices, the (npts, n) distances to them).
    ``dists(x, X)`` defaults to the squared Euclidean distance (numpy);
    a given one takes rows of ``X`` as they are and returns numpy.
    Reference ``src/utils/picking.jl:16-43``."""
    npts = X.shape[0]
    if npts < n:
        raise ValueError(f"cannot pick {n} of {npts} points")
    if dists is None:
        X = np.asarray(X)
        dists = lambda x, Xs: ((Xs - x) ** 2).sum(axis=-1)  # noqa: E731
    d = np.zeros((npts, n))
    mins = np.full(npts, np.inf)
    qs = []
    q = int(np.argmax(dists(X[0] * 0, X)))
    for i in range(n):
        qs.append(q)
        d[:, i] = dists(X[q], X)
        mins = np.minimum(mins, d[:, i])
        q = int(np.argmax(mins))
    qs = np.asarray(qs)
    picked = X[torch.as_tensor(qs, device=X.device)] \
        if isinstance(X, torch.Tensor) else X[qs]
    return picked, qs, d


def picking_aligned(x, m):
    """``picking`` of ``m`` flat (3N,) structures by aligned RMSD
    (reference ``src/utils/picking.jl:50-60``): the rows are centered in
    float64, and the distances are ``aligned_rmsd_one_to_many`` in
    float32 on their device.  Returns the centered picked rows (float32,
    on that device), their indices and the distances."""
    from .ops.align import aligned_rmsd_one_to_many

    x = torch.as_tensor(x)
    xr = x.double().reshape(x.shape[0], -1, 3)
    xc = (xr - xr.mean(dim=1, keepdim=True)).reshape(x.shape[0], -1)
    xc = xc.to(torch.float32)

    def dists(xi, Xs):
        return aligned_rmsd_one_to_many(xi, Xs).double().cpu().numpy()

    return picking(xc, m, dists=dists)


def extrapolate_x(iso, x, step, steps):
    """x += grad chi / |grad chi|^2 * step, ``steps`` times (reference
    ``legacy/extrapolate.jl:80-88``): each step moves chi by about
    ``step``."""
    x = torch.as_tensor(x, dtype=torch.float32,
                        device=iso.data.features.device)
    for _ in range(steps):
        g = dchidx(iso, x)
        x = x + g / (torch.sum(g ** 2) + 1e-12) * step
    return x


def extrapolate(iso, n, stepsize=0.1, steps=1, minimize=True, maxskips=10):
    """Points beyond chi's extrema (reference ``legacy/extrapolate.jl:
    15-78``): the bursts' end points in order of rising chi, pushed
    down by ``stepsize`` in chi until ``n`` are kept, then in order of
    falling chi pushed up until ``2 n`` are kept in all; each one
    minimized on its chi levelset where asked.  A point that diverges is
    skipped; after ``maxskips`` skips the search stops.  Returns (k, 3N),
    k <= 2 n."""
    from .data import flattenfirst

    coords = flattenfirst(iso.data.propcoords)
    with torch.no_grad():
        chi = iso.model(flattenfirst(iso.data.propfeatures))[:, 0]
    order = np.argsort(chi.cpu().numpy())
    xs = []
    skips = 0
    for perm, direction, N in [(order, -1, n), (order[::-1], 1, 2 * n)]:
        for i in perm:
            if skips > maxskips:
                break
            try:
                x = extrapolate_x(iso, coords[int(i)], direction * stepsize,
                                  steps)
                if minimize:
                    x = energyminimization_chilevel(iso, x)
                if not bool(torch.all(torch.isfinite(x))):
                    raise FloatingPointError("non-finite extrapolate")
                xs.append(x)
            except (FloatingPointError, ValueError, AssertionError):
                skips += 1
                continue
            if len(xs) == N:
                break
    if not xs:
        return coords.new_zeros((0, coords.shape[-1]))
    return torch.stack(xs)


def addextrapolates(iso, n, stepsize=0.01, steps=1, minimize=True):
    """Add ``extrapolate``'s points to the data of ``iso`` as new start
    points (reference ``legacy/extrapolate.jl:15-24``)."""
    if n == 0:
        return iso
    xs = extrapolate(iso, n, stepsize, steps, minimize=minimize)
    if len(xs):
        iso.addcoords(xs)
    return iso
