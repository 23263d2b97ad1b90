"""High-level workflow runners; counterpart of ``run_girsanov`` in
``isokann_tpu/workflows.py``."""

from __future__ import annotations

import warnings

import numpy as np

from .data import WeightedSamples
from .md.integrators import optcontrol
from .targets import DomainError


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
