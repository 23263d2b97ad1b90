"""Adaptive-sampling primitives on the host (numpy); counterpart of
``subsample_uniformgrid``, ``pickclosest``, ``ASH``, ``resample_kde_ash``
and ``kde_interior`` in ``isokann_tpu/sample.py`` (reference
``src/utils/subsample.jl:5-177``).

``pickclosest`` runs the reference's sorted sweep in Python; the JAX
package runs the same sweep in its native helper when that is built.

The greedy pick loop evaluates the density at each candidate's bin by the
truncated triangular-kernel sum, accumulated bin by bin in ascending
order, and rounds a candidate to its bin half away from zero: the
arithmetic of the JAX package's native fast path, so both packages pick
the same indices from the same chi values.
"""

from __future__ import annotations

import numpy as np


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
