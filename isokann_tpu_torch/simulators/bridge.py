"""chi-guided Langevin bridges between simplex corners; counterpart of
``isokann_tpu/simulators/bridge.py`` (reference ``src/simulators/
bridge.jl``).

A guide z(t) interpolates in the reaction coordinate xi; the bias
u = J^T gain(t) (z(t) - xi(x)), J the Jacobian of xi by one backward pass
an output, drives a Girsanov-weighted ABOBA (or Brownian) trajectory over
``sim.force`` (kernel A's forces entry on the fused route).
``bridge_simplex`` runs one bridge from a start point near a simplex
corner toward another over a frozen copy of the chi model and deposits
transition-region frames into the data; ``run_bridges`` runs every
corner pair and trains.
"""

from __future__ import annotations

import math
import warnings
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from .._device import as_tensor, make_generator, noise_generator
from ..data import WeightedSamples, flattenfirst
from ..md import integrators as I
from .metadynamics import batched, frozen_chi


def angdiff(xi, z):
    """Periodic difference wrapped to [-pi, pi) (reference
    ``bridge.jl:13``); the remainder takes the divisor's sign."""
    return torch.remainder(xi - z + math.pi, 2 * math.pi) - math.pi


@dataclass
class LinearInterpolant:
    """Piecewise-linear guide z(t) (reference ``bridge.jl:52-63``):
    ``xs`` (k,) times, ``ys`` (k, d) values; the values live on
    ``device`` (of ``ys`` when it is a tensor), the times on the host."""

    xs: Any
    ys: Any
    device: Any = None

    def __post_init__(self):
        self.ys = as_tensor(self.ys, device=self.device)
        self.ys = self.ys.reshape(1, -1) if self.ys.ndim < 2 else self.ys
        self.device = self.ys.device
        xs = self.xs
        if isinstance(xs, torch.Tensor):
            xs = xs.detach().cpu().numpy()
        self.xs = np.asarray(xs, np.float32)

    def __call__(self, t):
        i = int(np.clip(np.searchsorted(self.xs, np.float32(t),
                                        side="right") - 1,
                        0, len(self.xs) - 2))
        t0, t1 = self.xs[i], self.xs[i + 1]
        w = float((np.float32(t) - t0) / (t1 - t0))
        return (1 - w) * self.ys[i] + w * self.ys[i + 1]

    @property
    def tmax(self):
        return float(self.xs[-1])


class GuidedLangevinBridge:
    """Guided bridge simulation (reference ``GuidedLangevinBridge``,
    ``bridge.jl:6-49``).

    - ``sim``: an MDSimulation (masses3, temp, friction, step, force)
    - ``xi``: reaction coordinate of one flat point (3N,) -> (d,)
    - ``guide``: t -> (d,) target path (e.g. ``LinearInterpolant``)
    - ``gain``: t -> scalar (or (d,)) feedback gain
    - ``periodic``: ``angdiff`` for periodic coordinates (dihedrals)
    """

    def __init__(self, sim, xi, guide, gain=lambda t: 1.0, periodic=False):
        self.sim = sim
        self.xi = xi
        self.guide = guide
        self.gain = gain
        self.periodic = periodic

    def biasforce(self, withsigma=True):
        """``bias(x, t, sigma, F)``: J^T gain(t) (z(t) - xi(x)) for each
        walker of x (B, 3N) (divided by sigma unless ``withsigma``;
        reference ``biasforce``, ``bridge.jl:17-36``)."""
        xi = batched(self.xi)
        guide, gain, periodic = self.guide, self.gain, self.periodic

        def bias(x, t, sigma, F):
            xg = x.detach().requires_grad_(True)
            with torch.enable_grad():
                v = xi(xg)                                  # (B, d)
                z = guide(t)
                diff = (angdiff(z, v) if periodic else z - v).detach()
                c = gain(t) * diff
                u = torch.zeros_like(x)
                for k in range(v.shape[1]):
                    (g,) = torch.autograd.grad(
                        v[:, k].sum(), xg, retain_graph=k + 1 < v.shape[1])
                    u = u + g * c[:, k:k + 1]
            return u if withsigma else u / sigma

        return bias

    @property
    def tmax(self):
        return self.guide.tmax

    def trajectory(self, x0, gen=None):
        """A Girsanov-weighted bridge trajectory of round(tmax / step)
        steps from ``x0`` (reference ``bridge.jl:38-48``): every frame of
        the ABOBA recursion as ``WeightedSamples`` (T, 3N), or for a
        Brownian simulation the end point (1, 3N) and its weight.  The
        momenta are drawn on ``gen``, the steps' noise on the walker's
        device."""
        sim = self.sim
        gen = make_generator(gen)
        x0 = torch.as_tensor(x0, dtype=torch.float32,
                             device=sim.coords.device).reshape(1, -1)
        steps = int(round(self.tmax / sim.step))
        bias = self.biasforce()
        noise = noise_generator(gen, x0.device)
        if getattr(sim, "integrator", "langevin") == "brownian":
            x, logw = I.brownian_girsanov(sim.force, bias, x0, sim.masses3,
                                          sim.temp, sim.friction, sim.step,
                                          steps, noise)
            return WeightedSamples(x, torch.exp(logw))
        p0 = I.maxwell_boltzmann(gen, sim.masses3, sim.temp,
                                 x0.shape) * sim.masses3
        qs, logws, _ = I.aboba_girsanov(sim.force, bias, x0, p0,
                                        sim.masses3, sim.temp, sim.friction,
                                        sim.step, steps, noise, save_every=1)
        return WeightedSamples(qs[:, 0, :], torch.exp(logws[:, 0]))


def _choice(gen, a, size):
    """``size`` draws of the entries of ``a`` with replacement."""
    return np.asarray(a)[torch.randint(len(a), (size,), generator=gen)
                         .numpy()]


def bridge_simplex(iso, ix=(0, 1), eps=0.1, T=1.0, gain=1.0, deposit=10,
                   gen=None):
    """A bridge from simplex corner ``ix[0]`` to ``ix[1]`` over T ps,
    from a start point whose chi lies within ``eps`` of the first corner
    (warns and returns None when there is none); adds up to ``deposit``
    of its frames with sum chi^2 < 0.9 as start points (reference
    ``bridge_simplex``, ``bridge.jl:68-110``).  Draws from ``gen``
    (default ``iso.gen``).  Returns the frames (T/step, 3N)."""
    gen = iso.gen if gen is None else make_generator(gen)
    nd = iso.model.outputdim
    z0 = np.zeros(nd)
    z1 = np.zeros(nd)
    z0[ix[0]] = 1.0
    z1[ix[1]] = 1.0
    c = iso.chis().cpu().numpy()
    starts = np.flatnonzero(np.linalg.norm(c - z0, axis=1) < eps)
    if len(starts) == 0:
        warnings.warn(f"No starting point found within eps={eps} of corner "
                      f"{ix[0]}. Try increasing eps.")
        return None
    x0 = iso.data.coords[int(_choice(gen, starts, 1)[0])]
    guide = LinearInterpolant([0.0, T], np.stack([z0, z1]),
                              device=x0.device)
    glb = GuidedLangevinBridge(iso.data.sim, frozen_chi(iso), guide,
                               lambda t: gain)
    t = glb.trajectory(x0, gen=gen).values
    if deposit > 0:
        chit = iso.chicoords(t).cpu().numpy()
        i_trans = np.flatnonzero((chit ** 2).sum(axis=1) < 0.9)
        if len(i_trans):
            sel = np.unique(_choice(gen, i_trans, min(deposit, len(i_trans))))
            iso.addcoords(t[torch.as_tensor(sel, device=t.device)])
    return t


def run_bridges(iso, sample_bridge=1, train=100, generations=1, **kwargs):
    """``generations`` x (a bridge for every ordered pair of simplex
    corners -> ``iso.run(train)``) (reference ``run_bridges!``,
    ``bridge.jl:112-127``).  Each bridge appends dict(gen, ix, frames,
    finite, n_transition, n_new) to ``iso.bridge_telemetry``: its frame
    count (0 without a start point), whether every frame is finite, its
    frames with sum chi^2 < 0.9 and the start points it added."""
    nd = iso.model.outputdim
    rows = getattr(iso, "bridge_telemetry", None)
    if rows is None:
        rows = iso.bridge_telemetry = []
    for g in range(generations):
        for i1 in range(nd):
            for i2 in range(nd):
                if i1 == i2:
                    continue
                n0 = len(iso.data)
                t = bridge_simplex(iso, ix=(i1, i2), **kwargs)
                row = dict(gen=g, ix=(i1, i2), frames=0, finite=False,
                           n_transition=0, n_new=len(iso.data) - n0)
                if t is not None:
                    row.update(frames=len(t),
                               finite=bool(torch.isfinite(t).all()),
                               n_transition=int(((iso.chicoords(t) ** 2)
                                                 .sum(dim=1) < 0.9).sum()))
                rows.append(row)
        iso.run(train)
    return iso


def resample_picking_features(iso, n=None):
    """Farthest-point resampling over the features of all start points
    and bursts: keeps the picked start points and adds the picked burst
    points as new ones (reference ``resample_picking_features!``,
    ``bridge.jl:318-334``)."""
    from ..sample import picking

    n = len(iso.data) if n is None else n
    ys = torch.cat([iso.data.coords, flattenfirst(iso.data.propcoords)])
    fys = torch.cat([iso.data.features, flattenfirst(iso.data.propfeatures)])
    _, inds, _ = picking(fys.cpu().numpy(), n)
    inds = np.sort(inds)
    nold = len(iso.data)
    iold = inds[inds < nold]
    inew = inds[inds >= nold]
    iso.data = iso.data[torch.as_tensor(iold, device=ys.device)]
    if len(inew):
        iso.addcoords(ys[torch.as_tensor(inew, device=ys.device)])
    return iso
