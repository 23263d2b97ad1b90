"""Free energy along chi; counterpart of
``isokann_tpu/analysis/freeenergy.py`` (reference
``src/utils/freeenergy.jl``):

- ``marginal_free_energy``: -kBT log P(chi) from a histogram;
- ``constrained_free_energy``: thermodynamic integration over
  orthogonally projected underdamped dynamics on each chi levelset, with
  the drift correction and the Fixman 1/sqrt(Z) weight; all levelset
  walkers advance together, one ``sim.force`` call a step (kernel A's
  forces entry on the fused route), the noise through
  ``md.integrators._normals``;
- ``local_mean_force``: the binned mean force, one ``sim.force`` call;
- ``integrate_chi``, ``delta_G``, ``sample_uniform_chi_coords``.

The chi gradients of all walkers come from one backward pass of the
summed chi (each walker's chi depends on its own row only)."""

from __future__ import annotations

import numpy as np
import torch

from .._device import make_generator, noise_generator
from ..data import values
from ..md import integrators as I
from ..md.system import KB
from .minimumpath import _chibatch


def _chi_and_grad(chib, x):
    """chi (B,) and grad chi (B, 3N) of the rows ``x``."""
    x = x.detach().requires_grad_(True)
    with torch.enable_grad():
        c = chib(x)
        (g,) = torch.autograd.grad(c.sum(), x)
    return c.detach(), g


def marginal_free_energy(iso, nbins=100):
    """-kBT log P(chi) from a histogram of chi at the start points, its
    minimum 0 (reference ``src/utils/freeenergy.jl:12-42``).  Returns
    (bin_centers, F) on the host; F is inf at empty bins."""
    chivals = iso.chis().double().cpu().numpy().ravel()
    kBT = KB * getattr(iso.data.sim, "temp", 310.0)
    weights, edges = np.histogram(chivals, bins=nbins)
    centers = (edges[:-1] + edges[1:]) / 2
    P = weights / np.sum(weights * np.diff(edges))
    with np.errstate(divide="ignore"):
        F = -kBT * np.log(P)
    F -= F[np.isfinite(F)].min()
    return centers, F


def integrate_chi(f, chi_vals):
    """Cumulative trapezoid of the mean force ``f`` over ``chi_vals``
    (reference ``src/utils/freeenergy.jl:207-216``)."""
    f = np.asarray(f)
    chi_vals = np.asarray(chi_vals)
    F = np.zeros(len(f))
    F[1:] = np.cumsum(0.5 * (f[1:] + f[:-1]) * np.diff(chi_vals))
    return F


def constrained_free_energy(iso, xs, steps=2000, gen=None):
    """Thermodynamic integration (reference
    ``src/utils/freeenergy.jl:59-124``): from the (n_states, 3N) start
    points ``xs``, ``steps`` steps of underdamped Euler-Maruyama with the
    force projected orthogonal to grad chi, each followed by a drift
    correction back onto the walker's chi levelset; the mean projected
    force (the constraint force) integrated over the sorted chi levels,
    minus kBT log of the mean Fixman factor 1/sqrt(sum grad chi^2 / m).
    The noise comes from ``gen`` (default ``iso.gen``) on the walkers'
    device.  Returns (chi_vals_sorted, F_std) on the host."""
    sim = iso.data.sim
    dev = iso.data.features.device
    x = torch.as_tensor(xs, dtype=torch.float32, device=dev)
    dt, gamma = sim.step, sim.friction
    kBT = KB * sim.temp
    m3 = sim.masses3
    amp = torch.sqrt(2 * gamma * kBT * dt * m3)
    noise = noise_generator(iso.gen if gen is None else make_generator(gen),
                            dev)
    chib = _chibatch(iso)
    chi_levels, _ = _chi_and_grad(chib, x)
    v = torch.zeros_like(x)
    lambdas, rzs = [], []
    for _ in range(int(steps)):
        F = sim.force(x)
        _, dchi = _chi_and_grad(chib, x)
        n2 = torch.sum(dchi * dchi, dim=1, keepdim=True)
        F_proj = torch.sum(F * dchi, dim=1, keepdim=True) / n2
        F = F - F_proj * dchi                     # orthogonal force
        db = I._normals(noise, x)
        v = v + ((F - gamma * m3 * v) * dt + amp * db) / m3
        x = x + v * dt
        # drift correction back onto the levelset
        c, dchi = _chi_and_grad(chib, x)
        n2 = torch.sum(dchi * dchi, dim=1, keepdim=True)
        x = x - (c - chi_levels)[:, None] / n2 * dchi
        # Fixman factor Z = sum(1/m dchi^2)
        Z = torch.sum(dchi * dchi / m3, dim=1)
        lambdas.append(-F_proj[:, 0])
        rzs.append(1.0 / torch.sqrt(Z))
    mean_forces = torch.stack(lambdas).mean(dim=0).cpu().numpy()
    mean_Z = torch.stack(rzs).mean(dim=0).cpu().numpy()
    chi_vals = chi_levels.cpu().numpy()
    order = np.argsort(chi_vals)
    chi_sorted = chi_vals[order]
    F_rgd = integrate_chi(mean_forces[order], chi_sorted)
    return chi_sorted, F_rgd - kBT * np.log(mean_Z[order])


def local_mean_force(iso, xs, nbins, return_centers=True):
    """Binned local mean force along chi (reference
    ``src/utils/freeenergy.jl:140-194``): the points sorted by chi, the
    projected force -F . grad chi / |grad chi|^2 of each (one
    ``sim.force`` call), averaged over ``nbins`` equal splits and
    integrated over the bins' mean chi.  Returns (mean_chi, F) or F."""
    sim = iso.data.sim
    xs = torch.as_tensor(xs, dtype=torch.float32,
                         device=iso.data.features.device)
    chib = _chibatch(iso)
    with torch.no_grad():
        chi_vals = chib(xs).cpu().numpy()
    order = np.argsort(chi_vals)
    xs_sorted = xs[torch.as_tensor(order, device=xs.device)]
    chi_sorted = chi_vals[order]
    F = sim.force(xs_sorted)
    _, dchi = _chi_and_grad(chib, xs_sorted)
    n2 = torch.sum(dchi * dchi, dim=1)
    lambdas = -(torch.sum(F * dchi, dim=1) / n2).cpu().numpy()
    splits = np.array_split(np.arange(len(chi_sorted)), nbins)
    mean_forces = np.array([lambdas[s].mean() for s in splits])
    mean_chi = np.array([chi_sorted[s].mean() for s in splits])
    F_rgd = integrate_chi(mean_forces, mean_chi)
    return (mean_chi, F_rgd) if return_centers else F_rgd


def delta_G(PMF, chi_vals):
    """Free-energy difference between the chi < 0.5 and chi >= 0.5
    basins (reference ``src/utils/freeenergy.jl:222-230``)."""
    PMF = np.asarray(PMF)
    chi_vals = np.sort(np.asarray(chi_vals))
    return PMF[chi_vals < 0.5].min() - PMF[chi_vals >= 0.5].min()


def sample_uniform_chi_coords(iso, n_points, xs=None):
    """``n_points`` rows of ``xs`` (default: the start points and the
    first burst of each) whose chi values lie nearest to ``n_points``
    equally spaced levels between chi's extremes (reference
    ``sample_coords``, ``src/utils/freeenergy.jl:236-252``).  On the
    data's device."""
    if xs is None:
        xs = torch.cat([iso.data.coords, values(iso.data.propcoords)[:, 0]])
    xs = torch.as_tensor(xs, dtype=torch.float32,
                         device=iso.data.features.device)
    chi_vals = iso.chicoords(xs).cpu().numpy().ravel()
    targets = np.linspace(chi_vals.min(), chi_vals.max(), n_points)
    idx = [int(np.argmin(np.abs(chi_vals - t))) for t in targets]
    return xs[torch.as_tensor(idx, device=xs.device)]
