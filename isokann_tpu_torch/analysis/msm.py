"""Ulam / Markov-state-model estimates of Koopman eigenfunctions on
collective-variable grids; the port's numpy copy of
``isokann_tpu/analysis/msm.py``.

The independent ground truth that anchors a trained chi on MD systems:
a grid discretization of the transfer operator from lagged sample
pairs, whose dominant nontrivial right eigenvector is (up to an affine
map) the chi function ISOKANN learns for a 2-metastable system.

All linear algebra runs on the host in float64 (small matrices);
``phipsi`` and ``ramachandran_msm`` take phi and psi from the port's own
topology and dihedral code.
"""

from __future__ import annotations

import numpy as np


def grid_assign(cv, lo, hi, nbins, periodic=True):
    """Map CV samples to flat grid-cell ids.

    ``cv``: (n, d) samples; ``lo``/``hi``: scalars or (d,) bounds;
    ``nbins``: int or (d,) bins per dimension.  Periodic wraps out-of-range
    values (dihedral tori); otherwise they clip to the edge bins.
    Returns (ids (n,) int64, shape tuple)."""
    cv = np.asarray(cv, np.float64)
    n, d = cv.shape
    lo = np.broadcast_to(np.asarray(lo, np.float64), (d,))
    hi = np.broadcast_to(np.asarray(hi, np.float64), (d,))
    nb = np.broadcast_to(np.asarray(nbins, np.int64), (d,))
    frac = (cv - lo) / (hi - lo)
    if periodic:
        frac = frac % 1.0
    idx = np.clip((frac * nb).astype(np.int64), 0, nb - 1)
    ids = np.zeros(n, np.int64)
    for k in range(d):
        ids = ids * nb[k] + idx[:, k]
    return ids, tuple(int(b) for b in nb)


def stratified_sample(cv, n, lo, hi, nbins, rng=None, periodic=True):
    """Pick ~n sample indices spread uniformly over the occupied cells of a
    CV grid (round-robin over cells, random within each cell).  The 2-D+
    counterpart of ``sample.subsample_uniformgrid``."""
    rng = np.random.default_rng(0) if rng is None else rng
    ids, shape = grid_assign(cv, lo, hi, nbins, periodic)
    cells = {}
    for i, c in enumerate(ids):
        cells.setdefault(int(c), []).append(i)
    for members in cells.values():
        rng.shuffle(members)
    picked = []
    rounds = 0
    while len(picked) < n and rounds < max(len(m) for m in cells.values()):
        for members in cells.values():
            if rounds < len(members):
                picked.append(members[rounds])
                if len(picked) >= n:
                    break
        rounds += 1
    return np.asarray(sorted(picked), np.int64)


def ulam_transition_matrix(cv_x, cv_y, lo, hi, nbins, periodic=True,
                           min_count=1, symmetrize=False):
    """Row-stochastic Ulam matrix from lagged CV pairs.

    ``cv_x``: (n, d) start-point CVs; ``cv_y``: (n, d) or (n, k, d)
    lag-endpoint CVs (k independent endpoints per start, as produced by
    ``IsoSimulation.propagate``).  Rows are conditional distributions, so
    the estimate is unbiased for the Koopman (transfer) operator whatever
    the start-point sampling distribution — exactly the setting of
    ISOKANN's (xs, ys) data.

    ``symmetrize=True`` applies the detailed-balance count estimator
    (C + C^T before row normalization) — valid when the pairs come from
    EQUILIBRIUM trajectories of a reversible dynamics (use
    ``trajectory_pairs``), where it roughly halves the eigenvector noise;
    it is NOT valid for adaptively-resampled burst data, whose start
    distribution is not stationary.

    Returns (P (m, m) row-stochastic over occupied cells, cells (m,) flat
    ids, counts (m,) row counts)."""
    cv_x = np.asarray(cv_x, np.float64)
    cv_y = np.asarray(cv_y, np.float64)
    if cv_y.ndim == 3:
        k = cv_y.shape[1]
        cv_x = np.repeat(cv_x, k, axis=0)
        cv_y = cv_y.reshape(-1, cv_y.shape[-1])
    ix, shape = grid_assign(cv_x, lo, hi, nbins, periodic)
    iy, _ = grid_assign(cv_y, lo, hi, nbins, periodic)
    ncell = int(np.prod(shape))
    C = np.zeros((ncell, ncell))
    np.add.at(C, (ix, iy), 1.0)
    if symmetrize:
        C = C + C.T
        min_count = 2 * min_count
    rows = C.sum(axis=1)
    # occupied = cells that appear as a start at least min_count times AND
    # appear at all as an endpoint-or-start (keeps P square + substochastic
    # leakage negligible for well-sampled data)
    occ = np.where(rows >= min_count)[0]
    P = C[np.ix_(occ, occ)]
    keep = P.sum(axis=1) > 0
    occ = occ[keep]
    P = P[np.ix_(keep.nonzero()[0], keep.nonzero()[0])]
    P = P / P.sum(axis=1, keepdims=True)
    return P, occ, rows[occ]


def trajectory_pairs(cv, lag_frames, walkers=None):
    """Sliding-window lagged pairs from an ensemble of trajectories.

    ``cv``: (W, F, d) per-walker frame CVs (or any per-frame values);
    ``lag_frames``: the lag in saved-frame units; ``walkers``: optional
    walker index list — repeats are KEPT, so a bootstrap resample of
    walkers maps directly to a resampled pair set.

    Returns ``(x (n, d), y (n, d))`` with n = len(walkers) *
    (F - lag_frames)."""
    cv = np.asarray(cv)
    if walkers is None:
        walkers = np.arange(cv.shape[0])
    lag_frames = int(lag_frames)
    if not 1 <= lag_frames < cv.shape[1]:
        raise ValueError(f"lag_frames={lag_frames} outside [1, F) for "
                         f"F={cv.shape[1]} frames")
    xs = np.concatenate([cv[w, :-lag_frames] for w in walkers])
    ys = np.concatenate([cv[w, lag_frames:] for w in walkers])
    return xs, ys


def disconnected_trajectories(chi_w, z_thresh=5.0, collapse_ratio=10.0):
    """Flag kinetically disconnected trajectories from a trained chi.

    The trajectory analogue of MSM ergodic trimming (restriction to the
    largest connected set).  When ISOKANN trains on trajectory pairs
    (``data_from_trajectories``) and the ensemble contains a trajectory
    that never exchanges conformations with the rest, the slowest
    empirical mode of the sampled operator is that trajectory's
    isolation: chi collapses to its indicator — near-constant within
    every trajectory, with the isolated one pinned at the opposite end
    of [0, 1].  A CV-grid MSM on the same data typically does NOT see
    the disconnect because the outlier overlaps other trajectories in
    the projected CV space, so the two estimators silently diverge.

    ``chi_w``: (W, F) chi evaluated on each trajectory's frames
    (non-finite frames ignored).  Returns ``(flagged, info)`` where
    ``flagged`` is an int array of trajectory indices (empty when chi
    has not collapsed onto trajectory labels) and ``info`` carries the
    variance decomposition: ``between`` / ``within`` trajectory chi
    variance, their ``ratio``, and the robust ``z`` score of every
    trajectory mean.

    Detection: chi counts as trajectory-collapsed when the
    between-trajectory variance of the per-trajectory means exceeds
    ``collapse_ratio`` x the mean within-trajectory variance; flagged
    trajectories are those whose mean lies ``z_thresh`` robust
    (MAD-based) standard deviations from the median.  At most W // 4
    trajectories are flagged — a genuinely 2-state ensemble with
    metastable trajectories splits into two large groups and is NOT
    reported as disconnected."""
    chi_w = np.asarray(chi_w, np.float64)
    if chi_w.ndim != 2:
        raise ValueError(f"chi_w must be (W, F), got {chi_w.shape}")
    W = chi_w.shape[0]
    with np.errstate(invalid="ignore"):
        means = np.nanmean(chi_w, axis=1)
        within = float(np.nanmean(np.nanvar(chi_w, axis=1)))
    between = float(np.var(means))
    ratio = between / max(within, 1e-12)
    med = np.median(means)
    mad = np.median(np.abs(means - med))
    z = np.abs(means - med) / (1.4826 * mad + 1e-9)
    info = dict(between=between, within=within, ratio=ratio, z=z,
                means=means)
    if ratio < collapse_ratio:
        return np.asarray([], np.int64), info
    flagged = np.flatnonzero(z > z_thresh)
    if len(flagged) == 0 or len(flagged) > max(1, W // 4):
        return np.asarray([], np.int64), info
    return flagged.astype(np.int64), info


def koopman_eigenfunctions(P, k=2):
    """Leading right eigenvectors of a row-stochastic matrix, sorted by
    |eigenvalue| descending (f64 host eig; real parts, sign-fixed so the
    first occupied cell of each nontrivial vector is positive).

    Returns (eigvals (k,), eigvecs (m, k))."""
    vals, vecs = np.linalg.eig(P)
    order = np.argsort(-np.abs(vals))[:k]
    vals = np.real(vals[order])
    vecs = np.real(vecs[:, order])
    for j in range(1, vecs.shape[1]):
        i0 = np.argmax(np.abs(vecs[:, j]))
        if vecs[i0, j] < 0:
            vecs[:, j] = -vecs[:, j]
    return vals, vecs


def eigenfunction_on_samples(cv, cells, vec, lo, hi, nbins, periodic=True):
    """Evaluate a grid eigenfunction at CV samples: each sample gets its
    cell's value (NaN for samples in unoccupied cells)."""
    ids, shape = grid_assign(np.asarray(cv, np.float64).reshape(-1, np.shape(cv)[-1]),
                             lo, hi, nbins, periodic)
    lookup = np.full(int(np.prod(shape)), np.nan)
    lookup[cells] = vec
    return lookup[ids]


def anchor_identifiability(cv, lag_frames, lo, hi, nbins, walkers=None,
                           n_boot=30, min_count=2, periodic=False,
                           symmetrize=True, chi=None, k=None, rng=None):
    """Bootstrap eigenvector identifiability of a trajectory Ulam anchor.

    A golden anchor can only certify (or refute) a trained chi at some
    tolerance if its OWN replicas agree about the slowest nontrivial
    eigenfunction: with a near-degenerate spectrum the individual
    eigenvectors of the estimated transition matrix are not
    statistically identifiable, and any 1-D comparison against them is
    instrument noise (the trp-cage honest negative, identifiability
    ~0.3; deca-alanine by contrast is >= 0.99 — see
    tools/golden_anchor_probe.py).

    ``cv``: (W, F, d) per-walker frame CVs; ``lag_frames``: MSM lag in
    frames; ``walkers``: optional indices of usable walkers.  Resamples
    walkers with replacement ``n_boot`` times, re-estimates the
    symmetrized Ulam matrix and its psi_2, and evaluates every replica
    on the SAME pooled frames.

    Returns a dict:
    - ``identifiability``: median |corr| between bootstrap psi_2 and the
      full-data psi_2 (the selection criterion — chi-blind),
    - ``eigvals``, ``cells``, ``vecs``: the full-data estimate,
    - ``ref``: full-data psi_2 evaluated on the pooled frames
      (NaN outside occupied cells),
    - with ``chi`` (W, F): ``chi_corr`` and the walker-bootstrap
      ``chi_corr_ci95`` of |corr(chi, psi_2 replica)|.
    """
    cv = np.asarray(cv, np.float64)
    W, nF, d = cv.shape
    if walkers is None:
        walkers = np.arange(W)
    walkers = np.asarray(walkers)
    rng = np.random.default_rng(5) if rng is None else rng
    k = (d + 2) if k is None else int(k)
    cv_ok = cv[walkers].reshape(-1, d)

    def build(ids):
        cx, cy = trajectory_pairs(cv, lag_frames, ids)
        P, cells, counts = ulam_transition_matrix(
            cx, cy, lo, hi, nbins, periodic=periodic,
            min_count=min_count, symmetrize=symmetrize)
        vals, vecs = koopman_eigenfunctions(P, k=k)
        return cells, vals, vecs

    cells, vals, vecs = build(walkers)
    ref = eigenfunction_on_samples(cv_ok, cells, vecs[:, 1], lo, hi,
                                   nbins, periodic=periodic)
    fin = np.isfinite(ref)
    chi_flat = None if chi is None else \
        np.asarray(chi, np.float64)[walkers].ravel()

    ident, bcorr = [], []
    for _ in range(int(n_boot)):
        try:
            c_b, v_b, e_b = build(rng.choice(walkers, len(walkers), True))
            r_b = eigenfunction_on_samples(cv_ok, c_b, e_b[:, 1], lo, hi,
                                           nbins, periodic=periodic)
            f_b = np.isfinite(r_b) & fin
            ident.append(abs(np.corrcoef(r_b[f_b], ref[f_b])[0, 1]))
            if chi_flat is not None:
                bcorr.append(abs(np.corrcoef(chi_flat[f_b],
                                             r_b[f_b])[0, 1]))
        except Exception:
            pass
    out = dict(
        identifiability=float(np.median(ident)) if ident else float("nan"),
        n_boot_ok=len(ident), eigvals=vals, cells=cells, vecs=vecs,
        ref=ref, coverage=float(fin.mean()))
    if chi_flat is not None:
        out["chi_corr"] = float(abs(np.corrcoef(chi_flat[fin],
                                                ref[fin])[0, 1]))
        out["chi_corr_ci95"] = (
            np.percentile(bcorr, [2.5, 97.5]).tolist()
            if len(bcorr) >= 10 else None)
    return out


def grid_ceiling(chi, cv, lo, hi, nbins, periodic=False):
    """Instrument ceiling of a grid anchor: corr(chi, E[chi | cell]).

    Any grid reference is cell-constant, so for every cell-constant g,
    cov(chi, g) = cov(E[chi|cell], g) and hence
    |corr(chi, g)| <= |corr(chi, E[chi|cell])| — no grid eigenfunction
    can correlate with chi beyond this value, whatever the dynamics.
    The ratio corr/ceiling is the discretization-deconvolved agreement
    of the cell-mean chi with the eigenfunction.

    ``chi``: (n,) values at the samples; ``cv``: (n, d) their CVs.
    Returns (ceiling, cellmean_at_samples)."""
    chi = np.asarray(chi, np.float64).ravel()
    ids, shape = grid_assign(cv, lo, hi, nbins, periodic=periodic)
    ncell = int(np.prod(shape))
    ssum = np.zeros(ncell)
    scnt = np.zeros(ncell)
    np.add.at(ssum, ids, chi)
    np.add.at(scnt, ids, 1)
    cellmean = np.where(scnt > 0, ssum / np.maximum(scnt, 1), 0.0)
    return float(abs(np.corrcoef(chi, cellmean[ids])[0, 1])), cellmean[ids]


def implied_timescale(eigval, lag):
    """t_i = -lag / ln(lambda_i)."""
    with np.errstate(divide="ignore"):
        return -lag / np.log(np.clip(np.abs(eigval), 1e-300, 1.0))


def containment_R(ref, basis):
    """Multiple correlation of ``ref`` on span{1, basis columns}.

    The subspace-containment acceptance metric for multi-dimensional
    chi (is the anchor eigenfunction representable as an affine
    combination of the learned chi columns?): R = 1 means psi lies in
    the span, R = |corr| for a single column.  Non-finite ``ref``
    entries (samples in never-visited anchor cells) are dropped.

    ``ref``: (n,) anchor values; ``basis``: (n, k) chi columns.
    Returns (R, finite_fraction)."""
    ref = np.asarray(ref, np.float64).ravel()
    basis = np.asarray(basis, np.float64)
    if basis.ndim == 1:
        basis = basis[:, None]
    fin = np.isfinite(ref)
    A = np.concatenate([np.ones((int(fin.sum()), 1)), basis[fin]], axis=1)
    coef, *_ = np.linalg.lstsq(A, ref[fin], rcond=None)
    ssr = float(((ref[fin] - A @ coef) ** 2).sum())
    sst = float(((ref[fin] - ref[fin].mean()) ** 2).sum())
    if sst <= 0.0:
        return 0.0, float(fin.mean())
    return float(np.sqrt(max(0.0, 1.0 - ssr / sst))), float(fin.mean())


def subspace_spectrum(chi_x, chi_y, symmetrize=True):
    """Projected slow spectrum of a learned chi span: generalized
    eigenvalues of C_tau vs C_0 restricted to span{chi columns}, from
    lagged pairs ``(chi_x, chi_y)`` = chi evaluated at trajectory-pair
    start/end points.

    This is the variational-dominance diagnostic for multi-dimensional
    chi: each eigenvalue is the lag-autocorrelation of the best linear
    combination within the span, so comparing the ladder against an
    anchor MSM's eigenvalues shows WHICH modes the chi subspace holds
    (a containment_R failure with a dominating ladder means the
    subspace legitimately excludes the anchor's comparatively fast
    mode — see docs/evidence_round4.md, deca multi-dim study).

    Returns ``(eigvals (k,), combos (k, k), mean (k,))`` with
    eigvals sorted descending; the i-th slow combination is
    ``(chi - mean) @ combos[:, i]``."""
    chi_x = np.asarray(chi_x, np.float64)
    chi_y = np.asarray(chi_y, np.float64)
    if chi_x.ndim == 1:
        chi_x, chi_y = chi_x[:, None], chi_y[:, None]
    k = chi_x.shape[1]
    return tica(chi_x, chi_y, dim=k, n_pca=k, symmetrize=symmetrize)


def chi_msm_correlation(chi, cv_x, golden):
    """|Pearson correlation| between trained chi values and a committed MSM
    golden eigenfunction, evaluated on the chi samples.

    ``chi``: (n,) trained chi at samples; ``cv_x``: (n, d) their CVs;
    ``golden``: dict with keys cells, vec, lo, hi, nbins, periodic (as
    saved by tools/make_golden_md.py).  Samples falling in cells the
    golden never visited are dropped (reported via the second return)."""
    chi = np.asarray(chi, np.float64).ravel()
    ref = eigenfunction_on_samples(cv_x, golden["cells"], golden["vec"],
                                   golden["lo"], golden["hi"],
                                   golden["nbins"],
                                   bool(golden.get("periodic", True)))
    ok = np.isfinite(ref)
    r = np.corrcoef(chi[ok], ref[ok])[0, 1]
    return float(abs(r)), float(ok.mean())


def tica(f_x, f_y, dim=2, n_pca=10, symmetrize=True):
    """Time-lagged independent component analysis on lagged feature
    pairs — the standard linear estimator of slow collective variables
    (Perez-Hernandez et al. 2013), used here to CHOOSE the CV grid for
    Ulam ground truths on systems without known order parameters
    (ala2 has phi/psi; trp-cage does not).

    ``f_x``: (n, f) start-point features; ``f_y``: (n, f) or (n, k, f)
    lag-endpoint features.  The whitening is regularized by projecting
    onto the top ``n_pca`` variance components first (with n ~ f the
    raw generalized eigenproblem badly overfits: measured autocorr
    ~0.99 for EVERY mode on 190 features x ~2k pairs).  ``symmetrize``
    averages C_tau with its transpose (detailed-balance estimator).

    All host-side f64.  Returns ``(autocorr (dim,), components
    (f, dim), mean (f,))``; project new features with
    ``(f - mean) @ components``."""
    f_x = np.asarray(f_x, np.float64)
    f_y = np.asarray(f_y, np.float64)
    if f_y.ndim == 3:
        k = f_y.shape[1]
        f_x = np.repeat(f_x, k, axis=0)
        f_y = f_y.reshape(-1, f_y.shape[-1])
    mu = np.concatenate([f_x, f_y]).mean(axis=0)
    a, b = f_x - mu, f_y - mu
    n = len(a)
    C0 = (a.T @ a + b.T @ b) / (2.0 * n)
    Ct = (a.T @ b) / n
    if symmetrize:
        Ct = 0.5 * (Ct + Ct.T)
    s, U = np.linalg.eigh(C0)
    idx = np.argsort(-s)[:min(int(n_pca), np.sum(s > 1e-12 * s.max()))]
    W = U[:, idx] / np.sqrt(s[idx])
    M = W.T @ Ct @ W
    M = 0.5 * (M + M.T)
    lam, Z = np.linalg.eigh(M)
    order = np.argsort(-lam)[:dim]
    V = W @ Z[:, order]
    # sign convention: largest-|loading| feature positive
    for j in range(V.shape[1]):
        i0 = np.argmax(np.abs(V[:, j]))
        if V[i0, j] < 0:
            V[:, j] = -V[:, j]
    return lam[order], V, mu


def phipsi(sim, x):
    """(phi, psi) of the first residue pair of ``sim``'s peptide at flat
    coordinates x (..., 3N), in float32 as the reference computes them."""
    import torch

    from ..md.pdbio import read_pdb
    from ..md.topology import build_topology
    from ..ops.dihedrals import dihedrals_from_indices, phi_psi_indices

    phis, psis = phi_psi_indices(build_topology(read_pdb(sim.pdbfile)))
    quads = np.concatenate([phis[:1], psis[:1]], axis=0)
    x = torch.as_tensor(x, dtype=torch.float32).cpu()
    return dihedrals_from_indices(x, quads).numpy()


def ramachandran_msm(sim, xs, ys, nbins=20, k=3, min_count=1):
    """Ulam MSM of an ``MDSimulation``'s (xs (n, 3N), ys (n, k, 3N)) data
    on the (phi, psi) torus (``phipsi``).  Returns dict(P, cells, counts,
    eigvals, eigvecs, cv_x, cv_y, lo, hi, nbins, lag_ps)."""
    cv_x = phipsi(sim, xs)
    cv_y = phipsi(sim, ys)
    P, cells, counts = ulam_transition_matrix(
        cv_x, cv_y, -np.pi, np.pi, nbins, periodic=True,
        min_count=min_count)
    vals, vecs = koopman_eigenfunctions(P, k=k)
    return dict(P=P, cells=cells, counts=counts, eigvals=vals, eigvecs=vecs,
                cv_x=cv_x, cv_y=cv_y, lo=-np.pi, hi=np.pi, nbins=nbins,
                lag_ps=sim.lagtime)
