"""Minimum-energy reaction paths along the chi gradient; counterpart of
``isokann_tpu/analysis/minimumpath.py`` (reference
``src/utils/minimumpath.jl``): the gradient of chi at raw coordinates,
projected gradient descent on a chi levelset, the march along
grad chi / |grad chi|^2 with levelset minimization between moves
(``reactionintegrator``, ``reactionpath_minimum``) and the reaction force
integrated by fixed-step RK4 in chi-time (``reactionpath_ode``).  The
gradients come from autograd: chi through the featurizer and the model,
the energy through ``sim.potential`` (an MD simulation) or
``sim.potential_batch`` (a diffusion), the force from ``sim.force``
(kernel A's forces entry on the fused route)."""

from __future__ import annotations


import numpy as np
import torch

from .._device import make_generator


def _chifun(iso):
    """chi at one flat coordinate vector (3N,) -> scalar tensor."""
    featurizer, model = iso.data.featurizer, iso.model

    def chi1(x):
        return model(featurizer(x[None, :]).to(torch.float32))[0, 0]

    return chi1


def _chibatch(iso):
    """chi at rows (B, 3N) -> (B,) tensor."""
    featurizer, model = iso.data.featurizer, iso.model

    def chib(x):
        return model(featurizer(x).to(torch.float32))[:, 0]

    return chib


def _value_and_grad(f, x):
    x = x.detach().requires_grad_(True)
    with torch.enable_grad():
        v = f(x)
        (g,) = torch.autograd.grad(v, x)
    return v.detach(), g


def _coords(iso, x):
    return torch.as_tensor(x, dtype=torch.float32,
                           device=iso.data.features.device)


def dchidx(iso, x):
    """grad chi at the raw coordinates ``x`` (3N,) (reference
    ``src/utils/minimumpath.jl:3-7``)."""
    return _value_and_grad(_chifun(iso), _coords(iso, x))[1]


def minimize_levelset(x0, chi_fn, energy_fn, iterations=20, lr=1e-5):
    """Projected gradient descent on the levelset {chi = chi(x0)}
    (reference ``minimize_levelset``, ``src/utils/minimumpath.jl:155-207``):
    each step moves along -grad U projected orthogonal to grad chi, then
    retracts x += (chi(x0) - chi(x)) grad chi / |grad chi|^2."""
    x = x0.detach()
    target = chi_fn(x).detach()
    for _ in range(iterations):
        _, g = _value_and_grad(energy_fn, x)
        _, u = _value_and_grad(chi_fn, x)
        un = u / (torch.linalg.norm(u) + 1e-12)
        g = g - torch.dot(g, un) * un              # tangent projection
        x = x - lr * g
        c, u = _value_and_grad(chi_fn, x)
        x = x + (target - c) * u / (torch.sum(u * u) + 1e-12)
    return x


def _energy1(sim):
    """The potential energy at one flat point (3N,): ``potential_batch``
    of a diffusion (its batched potential), else ``potential``."""
    potential = (sim.potential_batch if hasattr(sim, "potential_batch")
                 else sim.potential)
    return lambda x: potential(x[None, :])[0]


def energyminimization_chilevel(iso, x0, iterations=20, lr=1e-5):
    """Energy minimization of ``x0`` (3N,) on its chi levelset (reference
    ``src/utils/minimumpath.jl:155-171``); raises ``FloatingPointError``
    if it diverges."""
    x = minimize_levelset(_coords(iso, x0), _chifun(iso),
                          _energy1(iso.data.sim),
                          iterations=iterations, lr=lr)
    if not bool(torch.all(torch.isfinite(x))):
        raise FloatingPointError("chi-levelset minimization diverged")
    return x


def reactionintegrator(iso, x0, steps=10, stepsize=0.01, direction=1,
                       miniter=20, maxstep=0.5):
    """``steps`` moves along direction * stepsize * grad chi / |grad
    chi|^2, each capped at ``maxstep`` in norm (a trust region: where chi
    saturates grad chi -> 0), then minimized on its levelset for
    ``miniter`` iterations (reference ``src/utils/minimumpath.jl:63-75``).
    Returns (steps, 3N)."""
    chi1 = _chifun(iso)
    energy1 = _energy1(iso.data.sim)
    x = _coords(iso, x0)
    out = []
    for _ in range(steps):
        _, g = _value_and_grad(chi1, x)
        dx = direction * stepsize * g / (torch.sum(g * g) + 1e-12)
        nrm = torch.linalg.norm(dx)
        dx = torch.where(nrm > maxstep, dx / nrm * maxstep, dx)
        x = minimize_levelset(x + dx, chi1, energy1, iterations=miniter)
        out.append(x)
    if not out:
        return x.new_zeros((0,) + tuple(x.shape))
    return torch.stack(out)


def reactionpath_minimum(iso, x0=None, steps=101, miniter=20, extrasteps=0,
                         gen=None):
    """The reaction path through ``x0`` (default: a start point of the
    data drawn from ``gen``, else from ``iso.gen``): levelset-minimized,
    then integrated down grad chi to chi ~ 0 and up to chi ~ 1 in steps
    of 1 / ``steps`` in chi (reference ``src/utils/minimumpath.jl:31-49``).
    Returns (nframes, 3N), chi increasing."""
    if x0 is None:
        gen = iso.gen if gen is None else make_generator(gen)
        c = iso.data.coords
        x0 = c[int(torch.randint(len(c), (1,), generator=gen))]
    chi1 = _chifun(iso)
    xs = minimize_levelset(_coords(iso, x0), chi1, _energy1(iso.data.sim),
                           iterations=miniter)
    chi = float(chi1(xs).detach())
    steps2 = max(int(steps * (1 - chi)) + extrasteps, 0)
    steps1 = max(int(steps * chi) + extrasteps, 0)
    stepsize = 1.0 / steps
    x1 = reactionintegrator(iso, xs, steps=steps1, stepsize=stepsize,
                            direction=-1, miniter=miniter)
    x2 = reactionintegrator(iso, xs, steps=steps2, stepsize=stepsize,
                            direction=1, miniter=miniter)
    return torch.cat([x1.flip(0), xs[None, :], x2], dim=0)


def reactionforce(iso, sim, x, direction, orth=0.01):
    """The reaction force at ``x`` (3N,): unit chi-speed along grad chi
    (direction / |grad chi|^2 grad chi) plus ``orth`` times the force's
    part orthogonal to grad chi (reference
    ``src/utils/minimumpath.jl:148-160``).  One ``sim.force`` call."""
    x = _coords(iso, x)
    f = sim.force(x[None, :])[0]
    dchi = dchidx(iso, x)
    n2 = torch.sum(dchi * dchi) + 1e-12
    f = f - dchi * (torch.dot(f, dchi) / n2)
    return f * orth + (direction / n2) * dchi


def reactionpath_ode(iso, x0, steps=101, minimize=False, extrapolate=0.0,
                     orth=0.01, substeps=20, maxspeed=50.0):
    """The reaction force integrated in chi-time by fixed-step RK4
    (``substeps`` a frame, the speed capped at ``maxspeed``), backward
    from chi(x0) to -``extrapolate`` and forward to 1 + ``extrapolate``
    (the reference integrates with Tsit5,
    ``src/utils/minimumpath.jl:96-144``).  Returns (steps, 3N), the
    frames at ``steps`` equally spaced chi-times: steps x substeps x 4
    force calls at B=1."""
    sim = iso.data.sim
    x0 = _coords(iso, x0)
    if minimize:
        x0 = energyminimization_chilevel(iso, x0)
    t0 = float(_chifun(iso)(x0).detach())
    ts = np.linspace(-extrapolate, 1 + extrapolate, steps)

    def f(z):
        v = reactionforce(iso, sim, z, 1, orth)
        n = torch.linalg.norm(v)
        return torch.where(n > maxspeed, v / n * maxspeed, v)

    def rk4_to(x, t_from, t_to):
        h = (t_to - t_from) / substeps
        for _ in range(substeps):
            k1 = f(x)
            k2 = f(x + h / 2 * k1)
            k3 = f(x + h / 2 * k2)
            k4 = f(x + h * k3)
            x = x + h / 6 * (k1 + 2 * k2 + 2 * k3 + k4)
        return x

    frames = {}
    for part in (ts[ts <= t0][::-1], ts[ts > t0]):
        x, prev_t = x0, t0
        for t in part:
            x = rk4_to(x, prev_t, t)
            frames[t] = x
            prev_t = t
    return torch.stack([frames[t] for t in ts])
