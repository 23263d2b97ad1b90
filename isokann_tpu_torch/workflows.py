"""High-level workflow runners; counterpart of the metadynamics runners
(``adaptive_metadynamics``, ``run_metadynamics``, ``run_both``),
``run_kde_dash``, ``run_girsanov`` and the lag tools (``lag_sweep``,
``rates_resolved``, ``cktest``, ``training_lag_headroom``,
``escalate_lag`` and their helpers) in ``isokann_tpu/workflows.py``.

The lag tools propagate on the simulation's device and bring chi to the
host; their fits and bootstraps are numpy float64, as in the reference.
Random draws come from a ``torch.Generator`` (``gen``: a generator or an
int seed; each tool has the reference's default seed), where the
reference takes a key.
"""

from __future__ import annotations

import copy
import inspect
import warnings

import numpy as np
import torch

from ._device import draw_seed, make_generator
from .data import SimulationData, WeightedSamples, values
from .md.integrators import optcontrol
from .simulators.metadynamics import MetadynamicsSimulation
from .targets import DomainError


def _no_plots(plots, who):
    if plots is not None:
        raise NotImplementedError(f"{who}(plots=...) needs "
                                  f"utils/plots.py, which is not ported")


def adaptive_metadynamics(iso, deposit=None, x0=None, maxnorm=20.0,
                          gen=None, **mdargs):
    """One generation of chi-metadynamics sampling (reference
    ``adaptive_metadynamics``, ``src/workflows.jl:16-24``): a biased
    trajectory of max(1, deposit // lag) lags from ``x0`` (default the
    last start point) under a new ``MetadynamicsSimulation(iso,
    **mdargs)``, a frame saved every ``deposit`` steps (default one lag);
    raises ``AssertionError`` when its last frame drifted ``maxnorm`` or
    more from ``x0``, else adds the frames as start points.  Draws from
    ``gen`` (default ``iso.gen``).  Returns dict(t, md, xnew)."""
    sim = iso.data.sim
    deposit = sim.steps if deposit is None else deposit
    if x0 is None:
        x0 = iso.data.coords[-1]
    x0 = torch.as_tensor(x0, dtype=torch.float32,
                         device=iso.data.coords.device)
    md = MetadynamicsSimulation(iso, **mdargs)
    t = md.trajectory(x0=x0, steps=sim.steps * max(1, deposit // sim.steps),
                      saveevery=deposit, gen=iso.gen if gen is None else gen)
    xnew = t.values
    drift = float(torch.linalg.norm(xnew[-1] - x0.reshape(-1)))
    if not drift < maxnorm:
        raise AssertionError(f"metadynamics trajectory drifted "
                             f"{drift:.2f} > maxnorm={maxnorm}")
    iso.addcoords(xnew)
    return dict(t=t, md=md, xnew=xnew)


def run_metadynamics(iso, generations=100, iter=100, plots=None, **mdargs):
    """``generations`` x (``adaptive_metadynamics(iso, **mdargs)`` ->
    ``iso.run(iter)``) (reference ``run_metadynamics!``,
    ``src/workflows.jl:4-14``).  ``plots=`` needs ``utils/plots.py``,
    which is not ported, and raises."""
    _no_plots(plots, "run_metadynamics")
    for _ in range(generations):
        adaptive_metadynamics(iso, **mdargs)
        iso.run(iter)
    return iso


def run_both(iso, generations=100, samples_kde=1, iter=100, plots=None,
             **mdargs):
    """``generations`` x (one KDE generation of ``samples_kde`` points ->
    one metadynamics generation), each trained ``iter`` iterations
    (reference ``run_both!``, ``src/workflows.jl:51-56``)."""
    _no_plots(plots, "run_both")
    for _ in range(generations):
        iso.run_kde(generations=1, kde=samples_kde, iter=iter)
        run_metadynamics(iso, generations=1, iter=iter, **mdargs)
    return iso


def run_kde_dash(iso, generations=1, plots=None, **kwargs):
    """``generations`` x ``iso.run_kde(generations=1, **kwargs)``
    (reference ``run_kde_dash!``, ``src/workflows.jl:39-49``).  Returns
    ``plots``; collecting figures in a ``plots`` list needs
    ``utils/plots.py``, which is not ported."""
    _no_plots(plots, "run_kde_dash")
    for _ in range(generations):
        iso.run_kde(generations=1, **kwargs)
    return plots


def run_girsanov(iso, generations=1, iter=100, kde=1, forcescale=1.0,
                 cutoff=np.inf, showprogress=False, auto_forcescale=False,
                 min_forcescale=0.0625, telemetry=None):
    """Koopman-weighted adaptive training.  Each generation refreshes the
    chi-derived optimal-control bias (``optcontrol``), KDE-resamples
    ``kde`` new start points whose bursts run under that bias
    (Girsanov-weighted ``WeightedSamples``), keeps the last ``cutoff``
    points and trains ``iter`` weighted Koopman iterations.  Before chi
    contracts (``optcontrol`` raises ``DomainError``) a generation samples
    unbiased.  On the card the biased bursts run in the Girsanov kernel
    (kernel B) on the fused route, and on the hybrid route in the ABOBA
    recursion over kernel D's forces with the bias callable (kernels C
    and C′ inside an all-pairs bias of >= 512 atoms).  The previous
    generation's bias, a frozen copy of the model, is dropped before the
    next is made.

    Keep the lag short (the reference's 0.2 ps) or temper with
    ``forcescale`` <= 0.5: at MD scale the log-weight variance grows with
    the lag and the weights degenerate.  The loop warns once when a new
    generation's mean ESS falls below 0.3 nk.

    Telemetry: each generation appends ``dict(gen, biased, forcescale,
    ess, nk, n_new, n_data, loss)`` to ``iso.girsanov_telemetry`` (kept
    across calls) and to the optional ``telemetry`` list.

    ``auto_forcescale=True``: after two consecutive biased generations
    with mean ESS below 0.3 nk, ``forcescale`` is halved (not below
    ``min_forcescale``) before the next bias refresh.
    """
    sim = iso.data.sim
    old_bias = sim.bias
    warned_ess = False
    rows = getattr(iso, "girsanov_telemetry", None)
    if rows is None:
        rows = iso.girsanov_telemetry = []
    low_streak = 0
    try:
        for g in range(generations):
            sim.bias = None
            try:
                sim.bias = optcontrol(iso, forcescale=forcescale)
            except DomainError:
                sim.bias = None       # not yet contracting: sample unbiased
            n_before = len(iso.data)
            iso.resample_kde(kde)
            n_new = len(iso.data) - n_before
            if len(iso.data) > cutoff:
                iso.data = iso.data[len(iso.data) - int(cutoff):]
            ess = None
            pf = iso.data.propfeatures
            if (sim.bias is not None and isinstance(pf, WeightedSamples)
                    and n_new > 0):
                ess = float(pf[-n_new:].ess().mean())
            if (ess is not None and not warned_ess
                    and ess < 0.3 * iso.data.nk):
                warnings.warn(
                    f"run_girsanov: Girsanov weights are degenerating "
                    f"(mean ESS {ess:.1f} of nk={iso.data.nk} on the new "
                    f"generation); the weighted Koopman estimate is "
                    f"noise-dominated at this lag/forcescale.  Lower "
                    f"forcescale (<= 0.5) or shorten the lag.")
                warned_ess = True
            iso.run(iter)
            biased = sim.bias is not None
            row = dict(gen=len(rows), biased=biased,
                       forcescale=float(forcescale), ess=ess,
                       nk=int(iso.data.nk), n_new=int(n_new),
                       n_data=len(iso.data), loss=float(iso.losses[-1]))
            rows.append(row)
            if telemetry is not None:
                telemetry.append(row)
            if biased and ess is not None and ess < 0.3 * iso.data.nk:
                low_streak += 1
            else:
                low_streak = 0
            if (auto_forcescale and low_streak >= 2
                    and forcescale > min_forcescale):
                forcescale = max(forcescale / 2.0, min_forcescale)
                low_streak = 0
                row["forcescale_next"] = float(forcescale)
                if showprogress:
                    print(f"[run_girsanov] ESS below 0.3*nk twice: "
                          f"tempering forcescale to {forcescale:g}",
                          flush=True)
            if showprogress:
                msg = (f"[run_girsanov] gen {g + 1}/{generations} "
                       f"loss={iso.losses[-1]:.4g} n={len(iso.data)} "
                       f"biased={biased}")
                if ess is not None:
                    msg += f" ess={ess:.1f}/{iso.data.nk}"
                print(msg, flush=True)
    finally:
        sim.bias = old_bias
    return iso


# ---- lag selection and validation ------------------------------------------

def _np(a):
    """A tensor or array as a host numpy array."""
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def _take(a, idx):
    """Rows ``idx`` (numpy ints) of a tensor."""
    return a[torch.as_tensor(idx, device=a.device)]


def _gen(gen, default):
    """``gen``, or a generator of the tool's default seed."""
    return make_generator(default if gen is None else gen)


def _fit_koopman(chi_x, chi_y):
    """Least-squares coarse Koopman matrix K with chi @ K = Kchi and its
    eigenvalues (a 1-D chi augmented with 1 - chi, as in the rate fit)."""
    x = np.asarray(chi_x, dtype=np.float64)
    y = np.asarray(chi_y, dtype=np.float64)
    if x.ndim == 1:
        x, y = x[:, None], y[:, None]
    if x.shape[1] == 1:
        x = np.hstack([x, 1.0 - x])
        y = np.hstack([y, 1.0 - y])
    K, *_ = np.linalg.lstsq(x, y, rcond=None)
    K = K.T
    return K, np.linalg.eigvals(K)


def _strat_starts(iso, nx, keepedges, gen):
    """chi-stratified start points from the pooled dataset
    (``sample.subsample_uniformgrid``, the adaptive samplers' selection);
    its numpy generator is seeded from one draw of ``gen``."""
    from .sample import subsample_uniformgrid

    xs_all = iso.data.coords
    chi_all = _np(iso.chis())
    nx = min(int(nx), len(xs_all))
    rng = np.random.default_rng(draw_seed(gen))
    inds = subsample_uniformgrid(chi_all[:, 0], nx, keepedges=keepedges,
                                 rng=rng)
    return _take(xs_all, inds)


def _check_steps_override(sim, who):
    sig = inspect.signature(sim.propagate)
    if "steps" not in sig.parameters and not any(
            p.kind is inspect.Parameter.VAR_KEYWORD
            for p in sig.parameters.values()):
        raise TypeError(
            f"{type(sim).__name__}.propagate() does not accept a "
            f"steps= override; {who} needs a simulator that can "
            "propagate at arbitrary lags (Diffusion family and "
            "MDSimulation do).  Rebuild the simulation with the "
            "candidate lag instead, or add steps= support.")


def _chi_pairs_at_lag(iso, xs, s, nk, gen, max_batch=None):
    """``(chi(x), E[chi(X_s)|x])`` (numpy) for fixed start points ``xs``
    at a lag of ``s`` integrator steps: one ``propagate`` with ``nk``
    replicas, chi of the trained model, the replica mean (weighted by
    Girsanov weights when the propagation returns ``WeightedSamples``).
    ``max_batch`` caps the walkers of one propagation (above it the
    starts are split into chunks)."""
    sim = iso.data.sim
    nx = len(xs)
    if max_batch is not None and nx * nk > max_batch:
        nchunks = -(-(nx * nk) // int(max_batch))
        parts = np.array_split(np.arange(nx), nchunks)
        ys = [sim.propagate(_take(xs, p), nk, gen=gen, steps=s)
              for p in parts]
        if isinstance(ys[0], WeightedSamples):
            ys = WeightedSamples(torch.cat([y.values for y in ys]),
                                 torch.cat([y.weights for y in ys]))
        else:
            ys = torch.cat(ys)
    else:
        ys = sim.propagate(xs, nk, gen=gen, steps=s)
    yv = values(ys)                                  # (nx, nk, d)
    chi_x = _np(iso.chicoords(xs))                   # (nx, d_chi)
    chi_y = _np(iso.chicoords(yv.reshape(-1, yv.shape[-1])))
    chi_y = chi_y.reshape(nx, nk, -1)                # (nx, nk, d_chi)
    if isinstance(ys, WeightedSamples):
        w = _np(ys.weights).astype(np.float64).reshape(nx, nk, 1)
        chi_y = (w * chi_y).sum(axis=1) / w.sum(axis=1)
    else:
        chi_y = chi_y.mean(axis=1)                   # (nx, d_chi)
    return chi_x, chi_y


def _spectrum_resolved(eigs, tol=1e-6):
    """True when the fitted spectrum supports a rate fit: the dominant
    eigenvalue is the structural ~1 (the constant mode) and every other
    lies strictly inside the unit disk with a positive real part."""
    order = np.argsort(np.real(eigs))[::-1]
    rest = np.asarray(eigs)[order[1:]]
    return bool(np.real(eigs[order[0]]) <= 1.0 + tol
                and np.all(np.abs(rest) < 1.0)
                and np.all(np.real(rest) > 0.0))


def lag_sweep(iso, steps=None, nx=50, nk=8, n_boot=100, threshold=0.9,
              keepedges=True, gen=None, verbose=True, max_batch=None):
    """Implied-timescale lag validation.

    For each candidate lag (integrator steps; default the training lag x
    1, 5, 25, 125), ``nx`` chi-stratified start points of the dataset
    are propagated ``nk``-fold and the fitted coarse Koopman spectrum is
    bootstrap-tested over ``n_boot`` resamples of the starts.  Rows:
    ``steps``, ``lag``, ``eigs`` (real parts, descending), ``K``,
    ``timescale`` (-lag / log lambda_slow, NaN outside (0, 1)),
    ``resolved_frac``, ``resolved`` (resolved_frac >= threshold) and,
    with >= 10 resolved resamples, ``exit_rates_lo``/``exit_rates_hi``
    (2.5 / 97.5 percentiles of their exit rates).  Returns
    ``(_recommend_lag(rows), rows)``; warns when the implied timescale
    still rises at the ladder's edge."""
    import scipy.linalg

    sim = iso.data.sim
    if steps is None:
        steps = [sim.steps * m for m in (1, 5, 25, 125)]
    gen = _gen(gen, 0)
    xs = _strat_starts(iso, nx, keepedges, gen)
    nx = len(xs)
    dt_per_step = sim.lagtime / sim.steps
    _check_steps_override(sim, "lag_sweep")

    rows = []
    for s in sorted(int(s) for s in steps):
        chi_x, chi_y = _chi_pairs_at_lag(iso, xs, s, nk, gen,
                                         max_batch=max_batch)
        K, eigs_c = _fit_koopman(chi_x, chi_y)
        eigs = np.sort(np.real(eigs_c))[::-1]
        lag = s * dt_per_step
        n_ok = 0
        boot_exits = []
        rng_b = np.random.default_rng(0)
        for _ in range(n_boot):
            b = rng_b.integers(0, nx, nx)
            Kb, eb = _fit_koopman(chi_x[b], chi_y[b])
            ok_b = _spectrum_resolved(eb)
            n_ok += ok_b
            if ok_b:
                with np.errstate(all="ignore"):
                    Qb = np.real(scipy.linalg.logm(Kb)) / lag
                if np.all(np.isfinite(Qb)):
                    boot_exits.append(-np.diag(Qb))
        frac = n_ok / n_boot
        # the slow eigenvalue: the largest below the dominant one
        lam = eigs[1] if len(eigs) > 1 else eigs[0]
        ts = float(-lag / np.log(lam)) if 0.0 < lam < 1.0 else float("nan")
        row = dict(steps=s, lag=float(lag), eigs=eigs.tolist(),
                   K=K.tolist(), timescale=ts, resolved_frac=frac,
                   resolved=bool(_spectrum_resolved(eigs_c)
                                 and frac >= threshold))
        if len(boot_exits) >= 10:
            be = np.asarray(boot_exits)
            row["exit_rates_lo"] = np.percentile(be, 2.5, axis=0).tolist()
            row["exit_rates_hi"] = np.percentile(be, 97.5, axis=0).tolist()
        rows.append(row)
        if verbose:
            print(f"[lag_sweep] steps={s} lag={lag:g} "
                  f"eigs={np.round(eigs, 5).tolist()} timescale={ts:g} "
                  f"resolved={frac:.2f}", flush=True)

    if _ladder_edge_rising(rows):
        tail = [r for r in rows if r["resolved"]
                and np.isfinite(r["timescale"])]
        warnings.warn(
            f"lag_sweep: the implied timescale is still RISING at the "
            f"ladder edge ({tail[-2]['timescale']:.3g} -> "
            f"{tail[-1]['timescale']:.3g} at lag {tail[-1]['lag']:g}) — "
            f"the slowest process is likely slower than every candidate "
            f"lag resolves; extend the ladder, or rely on the campaign's "
            f"adaptive lag escalation to correct the recommendation as "
            f"chi sharpens.")
    return _recommend_lag(rows), rows


def _ladder_edge_rising(rows, plateau_ratio=1.5):
    """True when the two largest resolved rungs still show a rising
    implied timescale (ratio > ``plateau_ratio``)."""
    tail = [r for r in rows if r["resolved"] and np.isfinite(r["timescale"])]
    if len(tail) < 2:
        return False
    return tail[-1]["timescale"] / tail[-2]["timescale"] > plateau_ratio


def _recommend_lag(rows, eig_headroom=0.98, plateau_ratio=1.5):
    """The smallest resolved lag whose slow eigenvalue is at most
    ``eig_headroom`` and whose implied timescale forms a two-sided
    plateau with the next rung; else the largest resolved rung with
    headroom, else the smallest resolved lag, else None."""
    recommended = None
    for a, b in zip(rows, rows[1:]):
        lam_a = a["eigs"][1] if len(a["eigs"]) > 1 else a["eigs"][0]
        if (a["resolved"] and b["resolved"] and lam_a <= eig_headroom
                and np.isfinite(a["timescale"])
                and np.isfinite(b["timescale"])
                and 1.0 / plateau_ratio
                < b["timescale"] / a["timescale"] < plateau_ratio):
            recommended = a["steps"]
            break
    if recommended is None:
        ok = [r["steps"] for r in rows
              if r["resolved"]
              and (r["eigs"][1] if len(r["eigs"]) > 1 else 1.0)
              <= eig_headroom
              and np.isfinite(r["timescale"])]
        recommended = ok[-1] if ok else None
    if recommended is None:
        recommended = next((r["steps"] for r in rows if r["resolved"]),
                           None)
    return recommended


def rates_resolved(iso, lags=None, nx=100, nk=8, threshold=0.9, gen=None,
                   verbose=True, return_rows=False, max_batch=None):
    """Coarse macro-rates from the smallest lag at which the trained chi's
    Koopman fit resolves: ``lag_sweep`` over ``lags`` (default the
    training lag x 5, 25, 125), then Q = logm(K) / lag of each resolved
    row (its eigenvalues clipped into (0, 1)), stored in the row as
    ``Q`` and ``exit_rates``.  Returns ``(Q, row)`` of the smallest
    resolved lag, ``(None, rows)`` when none resolved; with
    ``return_rows=True`` ``(Q or None, row or None, rows)``."""
    import scipy.linalg

    sim = iso.data.sim
    if lags is None:
        lags = [sim.steps * m for m in (5, 25, 125)]
    dt_per_step = sim.lagtime / sim.steps

    _, rows = lag_sweep(iso, steps=sorted(int(s) for s in lags), nx=nx,
                        nk=nk, threshold=threshold, gen=_gen(gen, 11),
                        verbose=verbose, max_batch=max_batch)
    winner = None
    for row in rows:
        if not row["resolved"]:
            continue
        s = row["steps"]
        K = np.asarray(row["K"], np.float64)
        w_, V = np.linalg.eig(K)
        w_ = np.clip(np.real(w_), 1e-12, 1.0 - 1e-12) + 0j
        K = np.real(V @ np.diag(w_) @ np.linalg.inv(V))
        Q = np.real(scipy.linalg.logm(K)) / (s * dt_per_step)
        row["Q"] = Q.tolist()
        row["exit_rates"] = (-np.diag(Q)).tolist()
        if verbose:
            print(f"[rates_resolved] lag {s} steps "
                  f"({s * dt_per_step:g}): exit rates "
                  f"{(-np.diag(Q)).tolist()}", flush=True)
        if winner is None:
            winner = (Q, row)
    if return_rows:
        return (winner + (rows,)) if winner is not None else (None, None,
                                                              rows)
    if winner is not None:
        return winner
    return None, rows


def training_lag_headroom(iso):
    """The slow eigenvalue of the coarse Koopman fit on the current
    training data (host-side): above ~0.98 a sharpening chi is pushing
    it through 1, where ``rates()`` degrades to clamped bounds."""
    chi = _np(iso.chis()).astype(np.float64)
    kchi = _np(iso.koopman()).astype(np.float64)
    _, eigs = _fit_koopman(chi, kchi)
    eigs = np.sort(np.real(eigs))[::-1]
    return float(eigs[1]) if len(eigs) > 1 else float(eigs[0])


def escalate_lag(iso, new_steps, nx_max=64, keepedges=True, gen=None,
                 sim_factory=None):
    """Continue an adaptive campaign at a longer lag, warm-started: the
    model is kept; the dataset is re-seeded with up to ``nx_max``
    chi-stratified start points of the pool, propagated at the new lag.
    The new simulation is ``sim_factory(new_steps)``, else a shallow
    copy of the current one with ``lagtime_`` (the Diffusion family) or
    ``steps`` (MDSimulation) overridden."""
    sim = iso.data.sim
    nk = iso.data.nk
    new_steps = int(new_steps)
    if sim_factory is not None:
        new_sim = sim_factory(new_steps)
    else:
        new_sim = copy.copy(sim)
        if hasattr(new_sim, "lagtime_") and hasattr(new_sim, "dt"):
            new_sim.lagtime_ = new_steps * new_sim.dt
        elif hasattr(new_sim, "steps"):
            new_sim.steps = new_steps
        else:
            raise TypeError(
                f"{type(sim).__name__} exposes neither steps nor "
                "lagtime_; pass sim_factory")
        if hasattr(new_sim, "constructor"):
            new_sim.constructor = {**sim.constructor, "steps": new_steps}
    gen = _gen(gen, 11)
    xs = _strat_starts(iso, min(nx_max, len(iso.data)), keepedges, gen)
    iso.data = SimulationData.from_sim(new_sim, xs=xs, nk=nk, gen=gen)
    return iso


def cktest(iso, steps=None, factors=(2, 4), nx=50, nk=8, n_boot=200,
           atol=0.1, keepedges=True, gen=None, verbose=True,
           max_batch=None):
    """Chapman-Kolmogorov test of the chi-coarse Koopman model: from the
    same ``nx`` chi-stratified starts, K(tau) at the base lag ``steps``
    (default the training lag) and K(k tau) for each factor k; the
    prediction K(tau)^k is compared entrywise with K(k tau), with a
    joint bootstrap over the starts.  Rows: ``factor``, ``steps``,
    ``lag``, ``K_pred``, ``K_est``, ``dev``, ``dev_lo``/``dev_hi``
    (2.5 / 97.5 percentiles), ``max_abs_dev`` and ``ok`` (each entry's
    interval covers 0 or its deviation is within ``atol``).  Returns
    ``(all ok, rows)``."""
    sim = iso.data.sim
    _check_steps_override(sim, "cktest")
    s0 = int(steps) if steps is not None else int(sim.steps)
    dt_per_step = sim.lagtime / sim.steps
    gen = _gen(gen, 7)

    xs = _strat_starts(iso, nx, keepedges, gen)
    nx = len(xs)
    chi_x, chi_y0 = _chi_pairs_at_lag(iso, xs, s0, nk, gen,
                                      max_batch=max_batch)
    K0, _ = _fit_koopman(chi_x, chi_y0)

    rng_b = np.random.default_rng(0)
    boots = [rng_b.integers(0, nx, nx) for _ in range(n_boot)]

    rows, all_ok = [], True
    for k in sorted(int(k) for k in factors):
        _, chi_yk = _chi_pairs_at_lag(iso, xs, k * s0, nk, gen,
                                      max_batch=max_batch)
        Kk, _ = _fit_koopman(chi_x, chi_yk)
        pred = np.linalg.matrix_power(K0, k)
        dev = pred - Kk

        D = np.empty((n_boot,) + dev.shape)
        for i, b in enumerate(boots):
            K0_b, _ = _fit_koopman(chi_x[b], chi_y0[b])
            Kk_b, _ = _fit_koopman(chi_x[b], chi_yk[b])
            D[i] = np.linalg.matrix_power(K0_b, k) - Kk_b
        lo = np.percentile(D, 2.5, axis=0)
        hi = np.percentile(D, 97.5, axis=0)
        ok = bool(np.all(((lo <= 0.0) & (0.0 <= hi))
                         | (np.abs(dev) <= atol)))
        all_ok = all_ok and ok
        rows.append(dict(
            factor=k, steps=k * s0, lag=float(k * s0 * dt_per_step),
            K_pred=pred.tolist(), K_est=Kk.tolist(), dev=dev.tolist(),
            dev_lo=lo.tolist(), dev_hi=hi.tolist(),
            max_abs_dev=float(np.abs(dev).max()), ok=ok))
        if verbose:
            print(f"[cktest] k={k} lag={rows[-1]['lag']:g} "
                  f"max|K^k - K(k tau)|={rows[-1]['max_abs_dev']:.4f} "
                  f"ok={ok}", flush=True)
    return all_ok, rows
