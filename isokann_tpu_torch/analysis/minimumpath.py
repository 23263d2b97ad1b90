"""Chi-levelset energy minimization; counterpart of the part of
``isokann_tpu/analysis/minimumpath.py`` that ``sample.extrapolate`` needs
(reference ``src/utils/minimumpath.jl``): the gradient of chi at raw
coordinates and projected gradient descent on a chi levelset.  Both
gradients come from autograd: chi through the featurizer and the model,
the energy through ``sim.potential``.  The reaction paths of the
reference module are not ported yet."""

from __future__ import annotations

import torch


def _chifun(iso):
    """chi at one flat coordinate vector (3N,) -> scalar tensor."""
    featurizer, model = iso.data.featurizer, iso.model

    def chi1(x):
        return model(featurizer(x[None, :]).to(torch.float32))[0, 0]

    return chi1


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


def energyminimization_chilevel(iso, x0, iterations=20, lr=1e-5):
    """Energy minimization of ``x0`` (3N,) on its chi levelset (reference
    ``src/utils/minimumpath.jl:155-171``); raises ``FloatingPointError``
    if it diverges."""
    sim = iso.data.sim
    potential = (sim.potential if hasattr(sim, "potential")
                 else sim.potential_batch)
    x = minimize_levelset(_coords(iso, x0), _chifun(iso),
                          lambda x: potential(x[None, :])[0],
                          iterations=iterations, lr=lr)
    if not bool(torch.all(torch.isfinite(x))):
        raise FloatingPointError("chi-levelset minimization diverged")
    return x
