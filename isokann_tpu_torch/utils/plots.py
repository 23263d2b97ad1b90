"""Training dashboards and molecular plots (matplotlib); counterpart of
``isokann_tpu/utils/plots.py`` (reference ``src/utils/plots.jl``:
``plot_training`` ``:43-60``, ``scatter_ramachandran`` ``:187-202``,
``vismodel`` ``:204-240``).

Every function returns a matplotlib figure and displays nothing; with
``out`` it also writes a PNG.  matplotlib is imported inside each
function (the Agg backend, unless pyplot was already set up), so the
package imports without it; a plot without matplotlib raises
``ImportError``.  Tensors on the card are copied to the host to be drawn.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch


def _pyplot():
    import matplotlib
    if "matplotlib.pyplot" not in sys.modules:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _savefig(fig, out):
    if out:
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        fig.savefig(out, dpi=120)
    return fig


def plot_training(iso, out=None):
    """Dashboard: the log loss, the sorted chi values and the chi-vs-Kchi
    fixpoint scatter (reference ``plot_training``,
    ``src/utils/plots.jl:43-60``)."""
    plt = _pyplot()
    fig, axes = plt.subplots(1, 3, figsize=(12, 3.5))

    ax = axes[0]
    ax.semilogy(np.asarray(iso.losses), label="train loss")
    for lg in iso.loggers:
        if hasattr(lg, "losses") and hasattr(lg, "iters") and len(lg.losses):
            ax.semilogy(lg.iters, lg.losses, label="validation")
    ax.set_xlabel("iteration")
    ax.set_ylabel("loss")
    ax.legend()

    ax = axes[1]
    chi = _np(iso.chis())
    order = np.argsort(chi[:, 0])
    for d in range(chi.shape[1]):
        ax.plot(chi[order, d], ".", ms=2)
    ax.set_xlabel("frame (sorted)")
    ax.set_ylabel(r"$\chi$")

    ax = axes[2]
    kchi = _np(iso.koopman())
    for d in range(chi.shape[1]):
        ax.plot(chi[:, d], kchi[:, d], ".", ms=2)
    lo = min(chi.min(), kchi.min())
    hi = max(chi.max(), kchi.max())
    ax.plot([lo, hi], [lo, hi], "k--", lw=0.5)
    ax.set_xlabel(r"$\chi$")
    ax.set_ylabel(r"$K\chi$")

    fig.tight_layout()
    return _savefig(fig, out)


def plot_chi(iso, out=None):
    """Sorted chi values (reference ``plot_chi``,
    ``src/utils/plots.jl:72-102``)."""
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(5, 3.5))
    chi = _np(iso.chis())
    order = np.argsort(chi[:, 0])
    for d in range(chi.shape[1]):
        ax.plot(chi[order, d], ".", ms=2, label=f"chi{d + 1}")
    ax.legend()
    fig.tight_layout()
    return _savefig(fig, out)


def scatter_chifix(iso, out=None):
    """chi against Kchi, the fixed-point scatter (reference
    ``src/utils/plots.jl:150-163``)."""
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(4, 4))
    ax.plot(_np(iso.chis()).ravel(), _np(iso.koopman()).ravel(), ".", ms=2)
    ax.set_xlabel(r"$\chi$")
    ax.set_ylabel(r"$K\chi$")
    fig.tight_layout()
    return _savefig(fig, out)


def scatter_ramachandran(iso_or_coords, chi=None, pdb=None, out=None):
    """phi/psi scatter of the first backbone dihedral pair, colored by
    each chi dimension (reference ``scatter_ramachandran``,
    ``src/utils/plots.jl:187-202``): an ``Iso`` (its start points, chi and
    molecule) or frames (n, 3N) with ``pdb`` and an optional ``chi``."""
    from ..md.pdbio import read_pdb
    from ..md.topology import build_topology
    from ..ops.dihedrals import dihedrals_from_indices, phi_psi_indices

    if not isinstance(iso_or_coords, (torch.Tensor, np.ndarray)):  # an Iso
        iso = iso_or_coords
        coords = iso.data.coords
        chi = _np(iso.chis() if chi is None else chi)
        pdb = pdb or iso.data.pdbfile
    else:
        coords = iso_or_coords
        chi = None if chi is None else _np(chi)
    coords = torch.as_tensor(coords, dtype=torch.float32) \
        if not isinstance(coords, torch.Tensor) else coords

    phis, psis = phi_psi_indices(build_topology(read_pdb(pdb)))
    phi = _np(dihedrals_from_indices(coords, phis))
    psi = _np(dihedrals_from_indices(coords, psis))

    plt = _pyplot()
    d = 1 if chi is None else chi.shape[1]
    fig, axes = plt.subplots(1, d, figsize=(4 * d, 4), squeeze=False)
    for j in range(d):
        ax = axes[0, j]
        c = None if chi is None else chi[:, j]
        sc = ax.scatter(phi[:, 0], psi[:, 0], c=c, s=6, cmap="viridis")
        if c is not None:
            fig.colorbar(sc, ax=ax)
        ax.set_xlim(-np.pi, np.pi)
        ax.set_ylim(-np.pi, np.pi)
        ax.set_xlabel(r"$\phi$")
        ax.set_ylabel(r"$\psi$")
    fig.tight_layout()
    return _savefig(fig, out)


def plot_reactive_path(ids, xi, out=None):
    """The reaction coordinate along a reactive path ``ids`` (reference
    ``src/utils/reactivepath.jl:192-198``)."""
    plt = _pyplot()
    xi = _np(xi).ravel()
    ids = np.asarray(ids, dtype=int)
    fig, axes = plt.subplots(1, 2, figsize=(8, 3.5))
    axes[0].plot(xi, ".", ms=2)
    axes[0].plot(ids, xi[ids], "o-", ms=4)
    axes[0].set_xlabel("frame")
    axes[0].set_ylabel(r"$\chi$")
    axes[1].plot(xi[ids], "o-")
    axes[1].set_xlabel("path step")
    fig.tight_layout()
    return _savefig(fig, out)


def _model_device(model):
    try:
        return next(model.parameters()).device
    except (AttributeError, StopIteration):
        return torch.device("cpu")


def vismodel(model, grid=30, lims=(-2, 2), out=None):
    """The first output of a 2-D chi model on a grid (reference
    ``vismodel``, ``src/utils/plots.jl:204-240``); the grid goes to the
    model's device."""
    xs = np.linspace(lims[0], lims[1], grid)
    X, Y = np.meshgrid(xs, xs)
    pts = torch.as_tensor(np.stack([X.ravel(), Y.ravel()], axis=1),
                          dtype=torch.float32, device=_model_device(model))
    with torch.no_grad():
        Z = _np(model(pts))[:, 0].reshape(grid, grid)
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(5, 4))
    pcm = ax.pcolormesh(X, Y, Z, cmap="viridis")
    fig.colorbar(pcm, ax=ax)
    fig.tight_layout()
    return _savefig(fig, out)


def plot_targets(iso, out=None):
    """The current chi and its training target, sorted by chi (reference
    ``src/utils/plots.jl:242-260``)."""
    from ..targets import isotarget
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(5, 3.5))
    chi = _np(iso.chis())
    t = _np(isotarget(iso))
    order = np.argsort(chi[:, 0])
    for d in range(chi.shape[1]):
        ax.plot(chi[order, d], label=f"chi{d + 1}")
        ax.plot(t[order, d], ".", ms=2, label=f"target{d + 1}")
    ax.legend()
    fig.tight_layout()
    return _savefig(fig, out)


def plot_potential(sim, grid=100, out=None):
    """The potential of an analytic Langevin system over its support box
    (a line in 1-D, an image of the first two coordinates otherwise, the
    others at 0), evaluated on the simulation's device."""
    box = np.asarray(sim._supportbox)
    dev = getattr(sim, "device", None) or torch.device("cpu")

    def V(pts):
        with torch.no_grad():
            return _np(sim.potential_batch(torch.as_tensor(
                pts, dtype=torch.float32, device=dev)))

    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(5, 4))
    if sim.dim == 1:
        xs = np.linspace(box[0, 0], box[0, 1], grid)
        ax.plot(xs, V(xs[:, None]))
        ax.set_xlabel("x")
        ax.set_ylabel("V")
    else:
        xs = np.linspace(box[0, 0], box[0, 1], grid)
        ys = np.linspace(box[1, 0], box[1, 1], grid)
        X, Y = np.meshgrid(xs, ys)
        pts = np.stack([X.ravel(), Y.ravel()], axis=1)
        if sim.dim > 2:
            pts = np.concatenate(
                [pts, np.zeros((len(pts), sim.dim - 2))], axis=1)
        Vg = V(pts).reshape(grid, grid)
        pcm = ax.pcolormesh(X, Y, np.clip(Vg, None, np.percentile(Vg, 95)),
                            cmap="viridis")
        fig.colorbar(pcm, ax=ax)
    fig.tight_layout()
    return _savefig(fig, out)


def scatter_chi_simplex(iso, chi=None, out=None):
    """Chi of dimension >= 3 on the 2-simplex (a barycentric plot,
    reference ``src/utils/plots.jl:92-102``)."""
    chi = _np(iso.chis() if chi is None else chi)
    if chi.shape[1] < 3:
        raise ValueError("simplex plot needs chi dimension >= 3")
    c = chi[:, :3]
    c = c / np.clip(c.sum(axis=1, keepdims=True), 1e-9, None)
    # barycentric -> 2D: corners (0,0), (1,0), (0.5, sqrt(3)/2)
    corners = np.array([[0.0, 0.0], [1.0, 0.0], [0.5, np.sqrt(3) / 2]])
    xy = c @ corners
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(5, 4.5))
    tri = np.vstack([corners, corners[0]])
    ax.plot(tri[:, 0], tri[:, 1], "k-", lw=0.5)
    ax.scatter(xy[:, 0], xy[:, 1], c=np.argmax(c, axis=1), s=8,
               cmap="viridis")
    for i, lbl in enumerate([r"$\chi_1$", r"$\chi_2$", r"$\chi_3$"]):
        ax.annotate(lbl, corners[i], fontsize=12)
    ax.set_aspect("equal")
    ax.axis("off")
    fig.tight_layout()
    return _savefig(fig, out)


class autoplot:
    """Throttled training-plot logger (reference ``autoplot``,
    ``src/utils/plots.jl:303-314``): writes the dashboard to ``out`` at
    most every ``secs`` seconds.  As an ``Iso`` logger with ``logevery``
    1 it brings the losses to the host after every iteration."""

    def __init__(self, secs=5, out="out/training.png"):
        self.secs = secs
        self.out = out
        self.last = 0.0
        self.logevery = 1

    def log(self, iso):
        now = time.time()
        if now - self.last < self.secs:
            return
        self.last = now
        _pyplot().close(plot_training(iso, out=self.out))

    def diagnostic(self):
        return ("autoplot", self.out)


def plot_lag_sweep(rows, out=None):
    """Implied timescale and resolved fraction against the lag, for the
    rows of ``lag_sweep``.

    Left axis: implied timescale (log-log; its plateau marks trustworthy
    lags) with the bootstrap band where rows carry one.  Right axis: the
    bootstrap resolved fraction.  Unresolved lags are open markers at the
    lag's own value when their timescale is not finite."""
    lags = np.array([r["lag"] for r in rows], float)
    ts = np.array([r["timescale"] for r in rows], float)
    frac = np.array([r["resolved_frac"] for r in rows], float)
    ok = np.array([r["resolved"] for r in rows], bool)

    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(6, 4))
    has_band = [("exit_rates_lo" in r and "exit_rates_hi" in r and ok[i])
                for i, r in enumerate(rows)]
    if any(has_band):
        lo = np.array([max(np.max(r["exit_rates_hi"]), 1e-300)
                       if b else np.nan for r, b in zip(rows, has_band)])
        hi = np.array([max(np.min(r["exit_rates_lo"]), 1e-300)
                       if b else np.nan for r, b in zip(rows, has_band)])
        m = np.asarray(has_band)
        ax.fill_between(lags[m], 1.0 / lo[m], 1.0 / hi[m],
                        color="tab:blue", alpha=0.15, lw=0,
                        label="bootstrap 95% band (1/exit rate)")
    ax.plot(lags[ok], ts[ok], "o-", color="tab:blue",
            label="implied timescale (resolved)")
    bad = ~ok
    if bad.any():
        ax.plot(lags[bad], np.where(np.isfinite(ts[bad]), ts[bad],
                                    lags[bad]),
                "o", mfc="none", color="tab:blue", label="unresolved")
    ax.plot(lags, lags, ":", color="gray", lw=1, label="t = lag")
    ax.set_xscale("log")
    ax.set_yscale("log")
    ax.set_xlabel("lag")
    ax.set_ylabel("implied timescale")
    ax2 = ax.twinx()
    ax2.plot(lags, frac, "s--", color="tab:orange", alpha=0.7)
    ax2.set_ylabel("resolved fraction (bootstrap)", color="tab:orange")
    ax2.set_ylim(0, 1.05)
    ax.legend(loc="upper left", fontsize=8)
    fig.tight_layout()
    return _savefig(fig, out)


def plot_cktest(rows, out=None):
    """Chapman-Kolmogorov panels for the rows of ``workflows.cktest``:
    for each Koopman-matrix entry, the direct estimate ``K(k tau)[i,j]``
    with its joint-bootstrap deviation band against the prediction
    ``K(tau)^k[i,j]``, over the factors k."""
    d = len(rows[0]["K_est"])
    lags = np.array([r["lag"] for r in rows], float)
    plt = _pyplot()
    fig, axes = plt.subplots(d, d, figsize=(3 * d, 2.4 * d),
                             squeeze=False, sharex=True)
    for i in range(d):
        for j in range(d):
            ax = axes[i][j]
            est = np.array([r["K_est"][i][j] for r in rows])
            pred = np.array([r["K_pred"][i][j] for r in rows])
            lo = np.array([r["dev_lo"][i][j] for r in rows])
            hi = np.array([r["dev_hi"][i][j] for r in rows])
            # the band at the estimate's level: the entry passes iff the
            # estimate lies inside it (0 in [dev_lo, dev_hi])
            ax.fill_between(lags, est + lo, est + hi, alpha=0.25,
                            color="tab:blue", lw=0)
            ax.plot(lags, est, "o-", color="tab:blue", label="estimate")
            ax.plot(lags, pred, "s--", color="tab:orange",
                    label="CK prediction")
            ax.set_title(f"K[{i},{j}]", fontsize=9)
            if i == d - 1:
                ax.set_xlabel("lag")
    axes[0][0].legend(fontsize=8)
    fig.suptitle("Chapman-Kolmogorov: K(tau)^k vs K(k tau)", fontsize=10)
    fig.tight_layout()
    return _savefig(fig, out)
