"""Batched stochastic integrators in PyTorch (plain recursion).

Counterpart of ``isokann_tpu/md/integrators.py``: ``maxwell_boltzmann``,
the OpenMM LangevinMiddle scheme, the Girsanov-weighted ABOBA scheme
(``aboba_girsanov``) over any force and bias function, overdamped
Euler-Maruyama (``brownian``) and its Girsanov-weighted form
(``brownian_girsanov``, the toy diffusions' biased bursts), and the
chi-derived optimal-control bias (``optcontrol``).  Small vacuum systems
integrate in the hand-written kernels of ``langevin_kernel.py`` and
``girsanov_kernel.py``; larger ones run these recursions over a kernel's
forces, with rigid-water constraints where the system has them
(``md.constraints``).

Units: nm, ps, amu, kJ/mol; velocities nm/ps.  Noise is drawn from an
explicit ``torch.Generator``: LangevinMiddle draws on the generator's
device and moves the noise to the walkers', ABOBA and Euler-Maruyama
draw on the walkers' device (a CUDA generator for walkers on the card).
"""

from __future__ import annotations

import copy
import math
from typing import Callable, Optional

import numpy as np
import torch

KB = 0.00831446261815324


def maxwell_boltzmann(gen: torch.Generator, masses3, T, shape):
    """Velocities from the Maxwell-Boltzmann distribution; ``masses3``:
    (3N,) per-coordinate masses on the target device."""
    z = torch.randn(shape, generator=gen, dtype=torch.float32)
    return z.to(masses3.device) * torch.sqrt(KB * T / masses3)


def _langevin_middle_step(force_fn, x, v, masses3, T, gamma, dt, gen,
                          constraints, xlo):
    """One LangevinMiddle step on (x, v) and the low part ``xlo`` of the
    positions (constrained runs only, else None); see
    ``langevin_middle_step``."""
    a = math.exp(-gamma * dt)
    b = math.sqrt(1.0 - a * a)
    h = 0.5 * dt

    def drift(x, xlo, v):
        if constraints is None:
            return x + h * v, xlo, v
        dx = constraints.shake_displacement(x, h * v, xlo)
        # x + dx as a float pair (Fast2Sum): the rounding of the new
        # positions stays in xlo, so that the next SHAKE does not take
        # it for a constraint violation and return it through dx / h
        # (~5e-4 nm/ps at 5 nm coordinates and a 2 fs step)
        y = dx + xlo
        xn = x + y
        return xn, y - (xn - x), dx / h

    v = v + dt * force_fn(x) / masses3
    if constraints is not None:
        v = constraints.rattle(x, v)
    x, xlo, v = drift(x, xlo, v)
    v = a * v
    if gen is not None:
        z = torch.randn(v.shape, generator=gen, dtype=v.dtype,
                        device=gen.device).to(v.device)
        v = v + b * torch.sqrt(KB * T / masses3) * z
    if constraints is not None:
        v = constraints.rattle(x, v)
    return drift(x, xlo, v)


def langevin_middle_step(force_fn, x, v, masses3, T, gamma, dt,
                         gen: Optional[torch.Generator] = None,
                         constraints=None):
    """One LangevinMiddle step: v += dt f/m; x += dt/2 v;
    v = a v + b sqrt(kBT/m) R; x += dt/2 v, a = exp(-gamma dt),
    b = sqrt(1 - a^2).  R is drawn on ``gen``'s device; ``gen=None``
    drops the noise term (R = 0).

    With ``constraints`` (a ``md.constraints.ConstraintSet``), OpenMM's
    constrained variant as the reference runs it: RATTLE after the kick
    and after the random stage, SHAKE after each half drift with the
    velocity recovered from the constrained displacement (SHAKE works on
    the displacement itself, see ``ConstraintSet.shake_displacement``).
    Within a run of steps (``langevin_middle``) the positions carry
    their float32 rounding in a second float."""
    xlo = torch.zeros_like(x) if constraints is not None else None
    x, _, v = _langevin_middle_step(force_fn, x, v, masses3, T, gamma, dt,
                                    gen, constraints, xlo)
    return x, v


def langevin_middle(force_fn: Callable, x0, v0, masses3, T, gamma, dt,
                    nsteps: int, gen: Optional[torch.Generator] = None,
                    constraints=None):
    """``nsteps`` LangevinMiddle steps for a batch (B, 3N); returns (x, v).
    ``gen=None`` runs the noiseless recursion; ``constraints`` as in
    ``langevin_middle_step``."""
    x, v = x0, v0
    xlo = torch.zeros_like(x0) if constraints is not None else None
    for _ in range(int(nsteps)):
        x, xlo, v = _langevin_middle_step(force_fn, x, v, masses3, T, gamma,
                                          dt, gen, constraints, xlo)
    return x, v


def constants(masses3, T, gamma, overdamped: bool):
    """Noise amplitudes: sqrt(2 kB T / (gamma m)) (overdamped, position
    noise) or sqrt(2 kB T gamma m) (underdamped, momentum noise)."""
    if overdamped:
        return torch.sqrt(2 * KB * T / (gamma * masses3))
    return torch.sqrt(2 * KB * T * gamma * masses3)


def _brownian_noise(gen, x):
    return (torch.randn(x.shape, generator=gen, dtype=x.dtype,
                        device=x.device)
            if gen is not None else torch.zeros_like(x))


def brownian(force_fn: Callable, x0, masses3, T, gamma, dt, nsteps: int,
             gen: Optional[torch.Generator] = None):
    """Overdamped Euler-Maruyama: x += F/(gamma m) dt + sigma sqrt(dt) R
    with sigma = sqrt(2 kB T / (gamma m)).  R is drawn from ``gen`` on the
    walkers' device; ``gen=None`` runs the noiseless recursion."""
    sig = constants(masses3, T, gamma, overdamped=True)
    sqdt = math.sqrt(dt)
    x = x0
    for _ in range(int(nsteps)):
        f = force_fn(x)
        x = x + f / (gamma * masses3) * dt + sig * sqdt * _brownian_noise(
            gen, x)
    return x


def brownian_girsanov(force_fn: Callable, bias_fn: Callable, x0, masses3,
                      T, gamma, dt, nsteps: int,
                      gen: Optional[torch.Generator] = None,
                      sigmascaled=True):
    """Overdamped Euler-Maruyama under a bias u, with Girsanov weights:

        dX = [F/(gamma m) + sigma u] dt + sigma dB
        dlogw = -(|u|^2 / 2 dt + u . dB)

    u = bias(x, t, sigma, F) (divided by sigma unless ``sigmascaled``).
    Returns (x, logw), logw per walker."""
    sig = constants(masses3, T, gamma, overdamped=True)
    sqdt = math.sqrt(dt)
    x = x0
    logw = torch.zeros(x0.shape[:-1], dtype=x0.dtype, device=x0.device)
    t = 0.0
    for _ in range(int(nsteps)):
        f = force_fn(x)
        u = bias_fn(x, t=t, sigma=sig, F=f)
        if not sigmascaled:
            u = u / sig
        db = _brownian_noise(gen, x) * sqdt
        x = x + (f / (gamma * masses3) + sig * u) * dt + sig * db
        logw = logw - (torch.sum(u * u, dim=-1) / 2 * dt
                       + torch.sum(u * db, dim=-1))
        t += dt
    return x, logw


def aboba_girsanov(force_fn: Callable, bias_fn: Optional[Callable], x0, p0,
                   masses3, T, gamma, dt, nsteps: int,
                   gen: Optional[torch.Generator] = None,
                   save_every: Optional[int] = None, sigmascaled=True):
    """Underdamped ABOBA with Girsanov weights over positions q and
    momenta p (B, 3N).  Per step, with d = exp(-gamma dt) and
    f = sqrt(kB T m (1 - d^2)):

        q += dt/2 p/m                                    (A)
        B = bias(q, t, sigma, F); [B *= sigma]; deta = (d+1)/f dt/2 B
        logw -= eta . deta + |deta|^2 / 2
        p += dt/2 (F + B); p = d p + f eta; p += dt/2 (F + B)   (B O B)
        q += dt/2 p/m                                    (A)

    ``gen=None`` runs the noiseless recursion (eta = 0); eta is drawn
    from ``gen`` on the walkers' device.  Returns
    (q, p, logw), or (qs, logws, (q, p, logw)) with ``save_every``."""
    sig = constants(masses3, T, gamma, overdamped=False)
    d = math.exp(-gamma * dt)
    famp = torch.sqrt(KB * T * masses3 * (1.0 - d * d))
    t2 = dt / 2.0
    q, p = x0, p0
    logw = torch.zeros(x0.shape[:-1], dtype=x0.dtype, device=x0.device)
    t = 0.0
    qs, logws = [], []
    for i in range(int(nsteps)):
        eta = (torch.randn(p.shape, generator=gen, dtype=p.dtype,
                           device=p.device)
               if gen is not None else torch.zeros_like(p))
        q = q + t2 * p / masses3                                     # A
        F = force_fn(q)
        if bias_fn is not None:
            B = bias_fn(q, t=t, sigma=sig, F=F)
            if sigmascaled:
                B = B * sig
            deta = (d + 1.0) / famp * t2 * B
            logw = logw - (torch.sum(eta * deta, dim=-1)
                           + torch.sum(deta * deta, dim=-1) / 2)
            F = F + B
        b = t2 * F
        p = p + b                                                    # B
        p = d * p + famp * eta                                       # O
        p = p + b                                                    # B
        q = q + t2 * p / masses3                                     # A
        t += dt
        if save_every and (i + 1) % save_every == 0:
            qs.append(q)
            logws.append(logw)
    if save_every:
        return torch.stack(qs), torch.stack(logws), (q, p, logw)
    return q, p, logw


def shift_and_scale(xs, ys):
    """Affine fit ys ~ bias + scale xs; returns (bias, scale, limit) with
    limit = bias / (1 - scale)."""
    xs = np.asarray(xs, dtype=float).ravel()
    ys = np.asarray(ys, dtype=float).ravel()
    X = np.stack([np.ones_like(xs), xs], axis=1)
    beta = np.linalg.pinv(X) @ ys
    bias, scale = beta[0], beta[1]
    return bias, scale, bias / (1.0 - scale)


# floor of the value function psi = lam_t (chi - b) + b inside the
# optimal-control bias; the Girsanov kernel uses the same constant
PSI_FLOOR = 1e-2


def optcontrol(iso, forcescale=1.0):
    """The chi-derived optimal importance-sampling bias.

    Fits Kchi ~ shift + lam chi, raises ``DomainError`` unless
    0 < lam <= 1, and returns ``bias(x, t, sigma, F) = forcescale sigma
    grad log max(psi, PSI_FLOOR)`` with psi = lam_t (chi - b) + b,
    lam_t = exp(qrate (Tmax - t)), qrate = log(lam) / Tmax, Tmax the lag
    (sigma-scaled convention; the gradient comes from ``torch.autograd``).
    The model is a frozen copy of ``iso.model`` at this call.  The callable
    carries ``optcontrol_spec`` (model, featurizer, forcescale, b, qrate,
    Tmax), from which the Girsanov kernel runs the same bias."""
    from ..targets import DomainError

    sim = iso.data.sim
    chi1 = iso.chis().cpu().numpy().ravel()
    kchi = iso.koopman().cpu().numpy().ravel()
    shift, lam, _ = shift_and_scale(chi1, kchi)
    Tmax = sim.lagtime
    if not (0.0 < lam <= 1.0):
        raise DomainError(
            f"expected contracting Koopman operator (fitted lambda={lam:.4g}"
            " outside (0, 1]; chi is not yet converged enough for a"
            " well-defined optimal-control bias)")
    qrate = math.log(lam) / Tmax
    b = shift / (1.0 - lam) if abs(1.0 - lam) > 1e-12 else 0.5

    featurizer = iso.data.featurizer
    model = copy.deepcopy(iso.model).requires_grad_(False)
    floor = torch.tensor(PSI_FLOOR)

    def bias_fn(x, t, sigma, F):
        lam_t = math.exp(qrate * (Tmax - float(t)))
        with torch.enable_grad():
            z = x.detach().requires_grad_(True)
            chi = model(featurizer(z))[..., 0]
            psi = torch.maximum(lam_t * (chi - b) + b, floor.to(z.device))
            (g,) = torch.autograd.grad(torch.log(psi).sum(), z)
        return forcescale * sigma * g

    bias_fn.optcontrol_spec = dict(
        model=model, featurizer=featurizer, forcescale=float(forcescale),
        b=float(b), qrate=float(qrate), Tmax=float(Tmax))
    return bias_fn
