"""Well-tempered metadynamics with the learned chi as reaction
coordinate; counterpart of ``isokann_tpu/simulators/metadynamics.py``
(reference ``src/simulators/metadynamics.jl``).

The bias is a sum of Gaussians over deposited centers in the reaction
coordinate; its force is -grad_x of the well-tempered rescaled bias by
autograd through the featurizer and a frozen copy of the chi model (a
later ``iso.run`` does not move an existing bias), batched over walkers:
one backward pass of the summed walker energies.  The centers are a
capacity-bounded (capacity, d) matrix with a count of valid rows that
doubles when full; ``MetadynamicsStateGridded`` interpolates a bias
tabulated on a grid multilinearly.  ``trajectory`` runs the plain ABOBA
recursion (``md.integrators.aboba_girsanov``) over ``sim.force``: kernel
A's forces entry on the fused route.
"""

from __future__ import annotations

import copy
import itertools

import numpy as np
import torch

from .._device import as_tensor, make_generator, noise_generator
from ..data import WeightedSamples
from ..md import integrators as I


def rescale_welltempered(U, dt=1600.0):
    """Well-tempered rescaling dt log(1 + U / dt) (reference
    ``metadynamics.jl:60``); ``dt = inf`` leaves U as it is."""
    if np.isinf(dt):
        return U
    return dt * torch.log(1.0 + U / dt)


def project_onto_simplex_hyperplane(x):
    """Project chi (..., d) onto the sum = 1 hyperplane (reference
    ``metadynamics.jl:61``); d = 1 is left as it is."""
    if x.shape[-1] <= 1:
        return x
    return x - (torch.sum(x, dim=-1, keepdim=True) - 1.0) / x.shape[-1]


def frozen_chi(iso, project=False):
    """chi of a frozen copy of ``iso.model`` over the data's featurizer,
    optionally projected onto the simplex hyperplane: a function of one
    flat point (3N,) -> (d,), whose ``batch`` attribute takes rows
    (B, 3N) -> (B, d)."""
    model = copy.deepcopy(iso.model).requires_grad_(False)
    featurizer = iso.data.featurizer

    def batch(x):
        chi = model(featurizer(x).to(torch.float32))
        return project_onto_simplex_hyperplane(chi) if project else chi

    def rc(x):
        return batch(x[None, :])[0]

    rc.batch = batch
    return rc


def batched(f):
    """A function of one point as a function of rows: its ``batch``
    attribute where it has one, else a loop over the rows."""
    fb = getattr(f, "batch", None)
    if fb is not None:
        return fb
    return lambda x: torch.stack([f(xi) for xi in x])


def _atleast_2d(a):
    return a.reshape(1, -1) if a.ndim < 2 else a


class MetadynamicsState:
    """Gaussian centers in a (capacity, d) matrix with ``count`` valid
    rows; a deposit past the capacity doubles it.  Centers given as a
    tensor stay on its device, others go to ``device``."""

    def __init__(self, centers, capacity=4096, device=None):
        centers = _atleast_2d(as_tensor(centers, device=device))
        self.capacity = max(capacity, len(centers))
        self.d = centers.shape[1]
        self.centers = torch.zeros((self.capacity, self.d),
                                   dtype=torch.float32,
                                   device=centers.device)
        self.centers[:len(centers)] = centers
        self.count = len(centers)

    def deposit(self, z):
        """Append center(s) (reference ``deposit!``,
        ``metadynamics.jl:148``)."""
        z = _atleast_2d(torch.as_tensor(z, dtype=torch.float32,
                                        device=self.centers.device))
        n = len(z)
        if self.count + n > self.capacity:
            self.capacity = max(2 * self.capacity, self.count + n)
            buf = torch.zeros((self.capacity, self.d), dtype=torch.float32,
                              device=self.centers.device)
            buf[:self.count] = self.centers[:self.count]
            self.centers = buf
        self.centers[self.count:self.count + n] = z
        self.count += n

    def bias_potential(self, z, height, sigma):
        """V(z) = sum_i h exp(-|z - s_i|^2 / 2 sigma^2) over the valid
        rows (a masked sum over the capacity; reference
        ``metadynamics.jl:150-156``); z (..., d) -> (...)."""
        mask = (torch.arange(self.capacity, device=self.centers.device)
                < self.count)
        d2 = torch.sum((z[..., None, :] - self.centers) ** 2, dim=-1)
        return torch.sum(height * torch.exp(-d2 / (2 * sigma ** 2)) * mask,
                         dim=-1)


class MetadynamicsStateGridded:
    """A bias tabulated on a grid (built in float64 on the host) and
    interpolated multilinearly, indices clamped at the edges (reference
    ``MetadynamicsStateGridded``, ``metadynamics.jl:159-178``); no online
    deposition."""

    def __init__(self, centers, ranges, height, sigma, device=None):
        if isinstance(centers, torch.Tensor):
            device = centers.device
            centers = centers.detach().cpu().numpy()
        centers = np.atleast_2d(np.asarray(centers, np.float64))
        axes = [np.asarray(r, np.float64) for r in ranges]
        mesh = np.meshgrid(*axes, indexing="ij")
        grid = np.zeros(mesh[0].shape)
        pts = np.stack([m.ravel() for m in mesh], axis=-1)
        for c in centers:
            grid += (height * np.exp(-((pts - c) ** 2).sum(-1)
                                     / (2 * sigma ** 2))).reshape(grid.shape)
        self.grid = as_tensor(grid, device=device)
        self.lo = torch.as_tensor([a[0] for a in axes], dtype=torch.float32,
                                  device=self.grid.device)
        self.step = torch.as_tensor([a[1] - a[0] for a in axes],
                                    dtype=torch.float32,
                                    device=self.grid.device)

    def deposit(self, z):
        raise NotImplementedError(
            "gridded metadynamics state does not support online deposition")

    def bias_potential(self, z, height=None, sigma=None):
        """The grid interpolated at z (..., D) -> (...)."""
        idx = (z - self.lo) / self.step
        lower = torch.floor(idx)
        w1 = idx - lower
        lower = lower.to(torch.int64)
        shape = self.grid.shape
        out = torch.zeros(z.shape[:-1], dtype=self.grid.dtype,
                          device=self.grid.device)
        for corner in itertools.product((0, 1), repeat=len(shape)):
            w = torch.ones_like(out)
            ind = []
            for i, c in enumerate(corner):
                w = w * (w1[..., i] if c else 1.0 - w1[..., i])
                ind.append((lower[..., i] + c).clamp(0, shape[i] - 1))
            out = out + w * self.grid[tuple(ind)]
        return out


class MetadynamicsSimulation:
    """A well-tempered metadynamics bias usable as a Langevin force
    (reference ``MetadynamicsSimulation``, ``metadynamics.jl:29-55``).

    From an Iso, the reaction coordinate is chi of a frozen copy of its
    model projected onto the simplex hyperplane, and the initial centers
    are the projected chi values of its start points.  ``rc`` maps one
    flat point (3N,) to (d,)."""

    def __init__(self, iso=None, sim=None, rc=None, mdstate=None,
                 dt=600.0, height=1.0, sigma=0.1, capacity=4096):
        if iso is not None:
            sim = iso.data.sim
            rc = rc if rc is not None else frozen_chi(iso, project=True)
            if mdstate is None:
                mdstate = MetadynamicsState(
                    project_onto_simplex_hyperplane(iso.chis()),
                    capacity=capacity)
        self.sim = sim
        self.rc = rc
        self.mdstate = mdstate
        self.dt = float(dt)
        self.height = float(height)
        self.sigma = float(sigma)

    # -- bias force -------------------------------------------------------

    def bias_energy(self, x):
        """The well-tempered bias at one configuration x (3N,)."""
        U = self.mdstate.bias_potential(self.rc(x).reshape(-1), self.height,
                                        self.sigma)
        return rescale_welltempered(U, self.dt)

    def _bias_energies(self, x):
        """The well-tempered bias of the rows x (B, 3N) -> (B,)."""
        U = self.mdstate.bias_potential(batched(self.rc)(x), self.height,
                                        self.sigma)
        return rescale_welltempered(U, self.dt)

    def __call__(self, x, t=None, sigma=None, F=None):
        """The bias force -grad U_bias of one point (3N,) or of walkers
        (B, 3N), by one backward pass; the integrators' ``bias_fn``
        signature, NOT sigma-scaled (the reference's ``trajectory`` sets
        sigmascaled=false, :54-55)."""
        single = x.ndim == 1
        xb = (x[None, :] if single else x).detach().requires_grad_(True)
        with torch.enable_grad():
            (g,) = torch.autograd.grad(self._bias_energies(xb).sum(), xb)
        return -g[0] if single else -g

    def deposit(self, z):
        self.mdstate.deposit(z)

    # -- sampling -----------------------------------------------------------

    def trajectory(self, **kwargs):
        """A biased single-walker trajectory by the ABOBA recursion with
        Girsanov weights over ``sim.force`` (reference
        ``metadynamics.jl:54-55``): keywords ``x0`` (default the
        simulation's start), ``steps`` (default its lag), ``saveevery``
        (1) and ``gen`` (momenta drawn on it, the steps' noise on the
        walker's device).  Returns ``WeightedSamples`` of the saved
        frames (nsave, 3N) and their weights (nsave,)."""
        sim = self.sim
        gen = make_generator(kwargs.pop("gen", None))
        x0 = torch.as_tensor(kwargs.pop("x0", sim.coords),
                             dtype=torch.float32,
                             device=sim.coords.device).reshape(1, -1)
        steps = kwargs.pop("steps", sim.steps)
        saveevery = kwargs.pop("saveevery", 1)
        if kwargs:
            raise TypeError(f"unexpected keywords {sorted(kwargs)}")
        p0 = I.maxwell_boltzmann(gen, sim.masses3, sim.temp,
                                 x0.shape) * sim.masses3
        qs, logws, _ = I.aboba_girsanov(
            sim.force, self, x0, p0, sim.masses3, sim.temp, sim.friction,
            sim.step, steps, noise_generator(gen, x0.device),
            save_every=saveevery, sigmascaled=False)
        return WeightedSamples(qs[:, 0, :], torch.exp(logws[:, 0]))

    def wt_free_energy(self, zs):
        """F(z) = -(T + dT) / T V(z) at ``zs`` (m, d) (reference
        ``metadynamics.jl:82-87``)."""
        T = self.sim.temp
        dev = (self.mdstate.centers if hasattr(self.mdstate, "centers")
               else self.mdstate.grid).device
        zs = _atleast_2d(torch.as_tensor(zs, dtype=torch.float32,
                                         device=dev))
        V = self.mdstate.bias_potential(zs, self.height, self.sigma)
        return -(T + self.dt) / T * V
