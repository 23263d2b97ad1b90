"""Overdamped Langevin dynamics in analytic potentials; counterpart of
``isokann_tpu/simulators/langevin.py``.

All (n x k) walkers advance together, a batch of Euler-Maruyama steps
(``md.integrators.brownian``) with the force -grad V by
``torch.autograd`` of the summed batch potential.  With a ``bias`` (set
by ``run_girsanov``), ``propagate`` integrates under it
(``md.integrators.brownian_girsanov``) and returns Girsanov-weighted
samples.  The analytic convention dX = -grad V dt + sigma dB is the
integrators' with gamma = m = 1 and T = sigma^2 / (2 kB).

The toy systems ``Doublewell``, ``Triplewell`` (Metzner, Schuette and
Vanden-Eijnden 2006) and ``MuellerBrown`` keep the reference's defaults.
They run on the card unless the caller names another device; the
per-step noise comes from a generator on the walkers' device, seeded from
the caller's ``torch.Generator``.  The potentials are module-level
functions, so a ``Diffusion`` pickles (without its bias).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch

from .._device import make_generator, noise_generator, resolve_device
from ..data import WeightedSamples
from ..md import integrators as I
from .base import IsoSimulation


# ==========================================================================
# Potentials over batches (..., d) -> (...)
# ==========================================================================

def doublewell(x):
    """V(x) = (x^2 - 1)^2."""
    return (x[..., 0] ** 2 - 1.0) ** 2


def triplewell(x):
    """Metzner/Schuette/Vanden-Eijnden (2006) 2-D triple well."""
    X, y = x[..., 0], x[..., 1]
    return (3 * torch.exp(-X**2 - (y - 1/3)**2)
            - 3 * torch.exp(-X**2 - (y - 5/3)**2)
            - 5 * torch.exp(-(X - 1)**2 - y**2)
            - 5 * torch.exp(-(X + 1)**2 - y**2)
            + 0.2 * X**4 + 0.2 * (y - 1/3)**4)


def mueller_brown(x):
    """Mueller-Brown potential, three metastable basins."""
    X, y = x[..., 0], x[..., 1]
    return (-200 * torch.exp(-(X - 1)**2 - 10 * y**2)
            - 100 * torch.exp(-X**2 - 10 * (y - 0.5)**2)
            - 170 * torch.exp(-6.5 * (X + 0.5)**2 + 11 * (X + 0.5) * (y - 1.5)
                              - 6.5 * (y - 1.5)**2)
            + 15 * torch.exp(0.7 * (X + 1)**2 + 0.6 * (X + 1) * (y - 1)
                             + 0.7 * (y - 1)**2))


def _supportbox(support, dim):
    s = np.asarray(support, dtype=np.float64)
    if s.ndim == 0:
        s = np.array([-float(s), float(s)])
    if s.ndim == 1:
        s = np.tile(s[None, :], (dim, 1))
    return s  # (dim, 2)


# ==========================================================================
# Generic diffusion
# ==========================================================================

@dataclass
class Diffusion(IsoSimulation):
    """Overdamped Langevin diffusion dX = -grad V(X) dt + sigma dW in an
    analytic potential ``potential(x)``, (..., dim_) -> (...)."""

    potential: Callable
    dim_: int = 1
    sigma: Any = 1.0
    dt: float = 0.01
    lagtime_: float = 1.0
    support: Any = 1.0
    bias: Any = None
    device: Any = None

    def __post_init__(self):
        self._supportbox = _supportbox(self.support, self.dim_)
        self.device = resolve_device(self.device)

    @property
    def dim(self):
        return self.dim_

    @property
    def lagtime(self):
        return self.lagtime_

    @property
    def steps(self):
        return int(round(self.lagtime_ / self.dt))

    @property
    def coords(self):
        """The centre of the support box, (dim,)."""
        c = (self._supportbox[:, 0] + self._supportbox[:, 1]) / 2
        return torch.as_tensor(c, dtype=torch.float32, device=self.device)

    def potential_batch(self, x):
        """V over leading batch dimensions; x: (..., dim)."""
        return self.potential(x)

    def force(self, x):
        """-grad V, by autograd of the summed batch potential."""
        with torch.enable_grad():
            z = x.detach().requires_grad_(True)
            (g,) = torch.autograd.grad(self.potential(z).sum(), z)
        return -g

    def randx0(self, n, gen=None):
        """n points uniform in the support box, drawn from ``gen``."""
        u = torch.rand((n, self.dim_), generator=make_generator(gen),
                       dtype=torch.float32)
        lo = torch.as_tensor(self._supportbox[:, 0], dtype=torch.float32)
        hi = torch.as_tensor(self._supportbox[:, 1], dtype=torch.float32)
        return (lo + u * (hi - lo)).to(self.device)

    def defaultmodel(self, n=None, nout=1, gen=None, **kwargs):
        from ..models import smallnet
        return smallnet(self.dim_, nout=nout, gen=gen, device=self.device,
                        **kwargs)

    # -- integration ------------------------------------------------------

    def _constants(self):
        """(masses, T) of the integrators' convention: m = 1 and
        T = sigma^2 / (2 kB), so that their noise amplitude is sigma."""
        masses = torch.ones(self.dim_, dtype=torch.float32,
                            device=self.device)
        sig = torch.as_tensor(self.sigma, dtype=torch.float32,
                              device=self.device)
        return masses, sig ** 2 / (2.0 * I.KB)

    def _em(self, x, nsteps, noise):
        masses, T = self._constants()
        return I.brownian(self.force, x, masses, T, 1.0, self.dt, nsteps,
                          noise)

    def propagate(self, x0, nk, gen=None, steps=None):
        """(n, d) -> (n, nk, d): one lag of Euler-Maruyama for nk replicas
        of each start point, all walkers in one batch.  ``steps``
        overrides the lag's step count.  With ``self.bias``: the biased
        bursts as ``WeightedSamples`` with weights exp(logw)."""
        gen = make_generator(gen)
        x0 = torch.as_tensor(x0, dtype=torch.float32, device=self.device)
        n, d = x0.shape
        xs = torch.repeat_interleave(x0, nk, dim=0)
        nsteps = self.steps if steps is None else int(steps)
        noise = noise_generator(gen, self.device)
        if self.bias is not None:
            masses, T = self._constants()
            ys, logw = I.brownian_girsanov(self.force, self.bias, xs, masses,
                                           T, 1.0, self.dt, nsteps, noise)
            return WeightedSamples(ys.reshape(n, nk, d),
                                   torch.exp(logw).reshape(n, nk))
        return self._em(xs, nsteps, noise).reshape(n, nk, d)

    def trajectory(self, T=None, x0=None, saveat=None, gen=None,
                   save_start=False):
        """(nsave, d) trajectory of physical length T saved every
        ``saveat`` (defaults: one lag, every step), from ``x0`` or a
        ``randx0`` point; unbiased, as the reference's."""
        gen = make_generator(gen)
        T = self.lagtime_ if T is None else T
        saveat = self.dt if saveat is None else saveat
        if x0 is None:
            x0 = self.randx0(1, gen=gen)[0]
        x = torch.as_tensor(x0, dtype=torch.float32,
                            device=self.device).reshape(1, -1)
        inner = int(round(saveat / self.dt))
        noise = noise_generator(gen, self.device)
        saves = [x[0]] if save_start else []
        for _ in range(int(round(T / saveat))):
            x = self._em(x, inner, noise)
            saves.append(x[0])
        return torch.stack(saves)

    def laggedtrajectory(self, lags, x0=None, lagtime=None, gen=None):
        """``lags`` frames, one every ``lagtime`` (default: the lag)."""
        lagtime = self.lagtime_ if lagtime is None else lagtime
        return self.trajectory(T=lags * lagtime, x0=x0, saveat=lagtime,
                               gen=gen)


# ==========================================================================
# Toy systems
# ==========================================================================

def Doublewell(**kwargs):
    """1-D double well, sigma 1, dt 0.01, lag 1, support [-1.5, 1.5]."""
    kw = dict(potential=doublewell, dim_=1, support=1.5)
    kw.update(kwargs)
    return Diffusion(**kw)


def Triplewell(**kwargs):
    """2-D triple well, sigma 1, support [-2, 2] x [-1.5, 2.5]."""
    kw = dict(potential=triplewell, dim_=2, sigma=1.0,
              support=np.array([[-2.0, 2.0], [-1.5, 2.5]]))
    kw.update(kwargs)
    return Diffusion(**kw)


def MuellerBrown(**kwargs):
    """2-D Mueller-Brown, sigma 7, dt 1e-4, lag 1e-3, support
    [-1.4, 1.1] x [-0.25, 2]."""
    kw = dict(potential=mueller_brown, dim_=2, sigma=7.0,
              support=np.array([[-1.4, 1.1], [-0.25, 2.0]]),
              dt=0.0001, lagtime_=0.001)
    kw.update(kwargs)
    return Diffusion(**kw)
