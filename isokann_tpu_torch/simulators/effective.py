"""Learned effective dynamics in chi space; counterpart of
``isokann_tpu/simulators/effective.py`` (reference
``src/simulators/effective.jl``): the pointwise Ito projection of the
overdamped dynamics onto the reaction coordinate xi (Legoll/Lelievre;
Zhang/Hartmann/Schuette 2016),

    b(z) = E[ J_xi F + (sigma^2 / 2) Laplacian(xi) | xi = z ]
    A(z) = E[ (J_xi sigma)(J_xi sigma)^T | xi = z ],

estimated by an Epanechnikov-kernel conditional expectation over the
data (a dense masked all-pairs kernel evaluation), and Euler-Maruyama in
chi space.  The table takes all points' forces in one ``sim.force`` call
(kernel A's forces entry on the fused route); J and the diagonal of xi's
Hessian come from autograd over all points at once (each point's xi
depends on its own row only): one backward pass an output for J, one
double backward a coordinate for the diagonal.  The noise goes through
``md.integrators._normals``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import torch

from .._device import as_tensor, make_generator, noise_generator
from ..md import integrators as I
from ..md.integrators import constants
from .base import IsoSimulation
from .metadynamics import batched, frozen_chi


def epanechnikov_weights(zs, z, h):
    """Product Epanechnikov kernel weights of the stored points ``zs``
    (n, d) at queries ``z`` (..., d) -> (..., n) (reference
    ``epanechnikov``, ``effective.jl:131-140``)."""
    u = (zs - z[..., None, :]) / h
    inside = torch.all(torch.abs(u) < 1.0, dim=-1)
    # the product over d by hand: torch.prod's CUDA reduction is compiled
    # at run time on its first use for each shape, which costs more than
    # a 1,000-step trajectory
    q = 1.0 - u ** 2
    w = q[..., 0]
    for k in range(1, q.shape[-1]):
        w = w * q[..., k]
    return torch.where(inside, w, torch.zeros_like(w))


@dataclass
class KDEExpectation:
    """Conditional expectation E[f | z] by kernel regression (reference
    ``KDEExpectation``, ``effective.jl:92-142``): ``zs`` (n, d) reaction
    coordinates, ``fs`` (n, m) function values, on the device of ``zs``
    when it is a tensor, else on ``device``."""

    zs: Any
    fs: Any
    h: float
    device: Any = None

    def __post_init__(self):
        self.zs = as_tensor(self.zs, device=self.device)
        self.zs = self.zs.reshape(-1, 1) if self.zs.ndim < 2 else self.zs
        self.device = self.zs.device
        self.fs = torch.as_tensor(self.fs, dtype=torch.float32,
                                  device=self.device)
        self.fs = self.fs.reshape(-1, 1) if self.fs.ndim < 2 else self.fs

    def marginal_and_weight(self, z):
        z = torch.as_tensor(z, dtype=torch.float32, device=self.device)
        w = epanechnikov_weights(self.zs, z, self.h)
        return w @ self.fs, torch.sum(w, dim=-1)

    def marginal(self, z):
        acc, weight = self.marginal_and_weight(z)
        return acc / torch.clamp(weight, min=1e-12)[..., None]

    def weight(self, z):
        return self.marginal_and_weight(z)[1]


def b_and_A(xi, x, F, sigma):
    """Pointwise Ito projection (reference ``b_and_A``,
    ``effective.jl:46-65``) at the rows ``x`` (n, 3N) (or one point
    (3N,)): ``xi`` of one point (3N,) -> (d,) (its ``batch`` attribute
    used where it has one), ``F`` the mass/friction-scaled forces,
    ``sigma`` (3N,) the overdamped noise amplitudes.  Returns b (n, d)
    and A (n, d, d) (without the n axis for one point)."""
    single = x.ndim == 1
    xb = (x[None, :] if single else x).detach().requires_grad_(True)
    Fb = F[None, :] if single else F
    xib = batched(xi)
    D = xb.shape[1]
    with torch.enable_grad():
        v = xib(xb)                                        # (n, d)
        J, lap = [], []
        for k in range(v.shape[1]):
            (g,) = torch.autograd.grad(v[:, k].sum(), xb, create_graph=True)
            hd = torch.stack([
                torch.autograd.grad(g[:, j].sum(), xb, retain_graph=True)[0]
                [:, j] for j in range(D)], dim=1)          # (n, 3N)
            J.append(g.detach())
            lap.append(torch.sum(sigma ** 2 / 2 * hd, dim=-1))
    J = torch.stack(J, dim=1)                              # (n, d, 3N)
    b = torch.einsum("ndk,nk->nd", J, Fb) + torch.stack(lap, dim=1)
    s = J * sigma
    A = s @ s.transpose(-1, -2)
    return (b[0], A[0]) if single else (b, A)


class EffectiveSimulation(IsoSimulation):
    """The effective SDE in reaction-coordinate space learned from an
    Iso (reference ``EffectiveSimulation``, ``effective.jl:8-43``): the
    (b, A) table over the data's start points (or ``xs``) with xi the
    frozen chi model, a ``KDEExpectation`` of bandwidth ``h``, ``steps``
    Euler-Maruyama steps of ``dt`` a lag."""

    def __init__(self, iso=None, kde: KDEExpectation = None, steps=1000,
                 dt=0.001, h=0.1, xi=None, sim=None, xs=None):
        if iso is not None:
            sim = sim or iso.data.sim
            dev = iso.data.features.device
            xs = torch.as_tensor(iso.data.coords if xs is None else xs,
                                 dtype=torch.float32, device=dev)
            if xi is None:
                xi = frozen_chi(iso)
            m3 = torch.repeat_interleave(
                torch.as_tensor(sim.masses(), dtype=torch.float32,
                                device=dev), 3)
            sigma = constants(m3, sim.temp, sim.friction, overdamped=True)
            F = sim.force(xs) / (sim.friction * m3)
            b, A = b_and_A(xi, xs, F, sigma)
            with torch.no_grad():
                zs = batched(xi)(xs)
            kde = KDEExpectation(zs, torch.cat(
                [b, A.reshape(len(xs), -1)], dim=1), h)
        self.kde = kde
        self.steps = steps
        self.dt = dt

    @property
    def dim(self):
        return self.kde.zs.shape[1]

    @property
    def coords(self):
        return self.kde.zs[0]

    @property
    def lagtime(self):
        return self.steps * self.dt

    def b_and_sigma(self, z):
        """Effective drift b and noise L (the Cholesky factor of
        A + 1e-10 I) at z (..., d) (reference ``b_and_sigma``,
        ``effective.jl:81-89``).  Where A is not positive definite L's
        lower triangle is NaN, as the JAX package's Cholesky gives it,
        without a sync."""
        K = self.dim
        bA = self.kde.marginal(z)
        b = bA[..., :K]
        A = bA[..., K:].reshape(bA.shape[:-1] + (K, K))
        A = A + 1e-10 * torch.eye(K, dtype=A.dtype, device=A.device)
        L, info = torch.linalg.cholesky_ex(A)
        return b, torch.where((info == 0)[..., None, None], L,
                              math.nan).tril()

    def _em(self, z, nsteps, dt, gen, saveevery=None):
        """``nsteps`` Euler-Maruyama steps of the walkers z (B, d): the
        frames after every ``saveevery`` steps, or the end."""
        sqdt = math.sqrt(dt)
        frames = []
        for i in range(int(nsteps)):
            b, L = self.b_and_sigma(z)
            eta = I._normals(gen, z)
            z = z + b * dt + sqdt * (L @ eta[..., None])[..., 0]
            if saveevery and (i + 1) % saveevery == 0:
                frames.append(z)
        return torch.stack(frames) if saveevery else z

    def trajectory(self, steps=None, saveevery=1, x0=None, dt=None,
                   gen=None):
        """Euler-Maruyama in reaction-coordinate space from ``x0``
        (default the first table point): the frames after every
        ``saveevery`` steps, (steps // saveevery, d) (reference
        ``trajectory``, ``effective.jl:67-79``)."""
        steps = self.steps if steps is None else steps
        dt = self.dt if dt is None else dt
        z = (self.coords if x0 is None else torch.as_tensor(
            x0, dtype=torch.float32, device=self.kde.device)).reshape(1, -1)
        gen = noise_generator(make_generator(gen), z.device)
        return self._em(z, steps, dt, gen, saveevery=saveevery)[:, 0]

    def propagate(self, x0, nk, gen=None):
        """(n, d) -> (n, nk, d) bursts of one lag of the effective
        dynamics."""
        x0 = torch.as_tensor(x0, dtype=torch.float32, device=self.kde.device)
        x0 = x0.reshape(1, -1) if x0.ndim < 2 else x0
        n, d = x0.shape
        gen = noise_generator(make_generator(gen), x0.device)
        z = self._em(torch.repeat_interleave(x0, nk, dim=0), self.steps,
                     self.dt, gen)
        return z.reshape(n, nk, d)
