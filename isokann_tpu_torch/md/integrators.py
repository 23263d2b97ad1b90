"""Batched stochastic integrators in PyTorch (plain recursion).

Counterpart of ``isokann_tpu/md/integrators.py``: ``maxwell_boltzmann``
and the OpenMM LangevinMiddle scheme over any force function.  The
production path for supported systems is the hand-written kernel in
``langevin_kernel.py``; this recursion serves the systems it does not
take on the CPU, and the tests.

Units: nm, ps, amu, kJ/mol; velocities nm/ps.  Noise is drawn on the host
from an explicit ``torch.Generator`` and moved to the walkers' device.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch

KB = 0.00831446261815324


def maxwell_boltzmann(gen: torch.Generator, masses3, T, shape):
    """Velocities from the Maxwell-Boltzmann distribution; ``masses3``:
    (3N,) per-coordinate masses on the target device."""
    z = torch.randn(shape, generator=gen, dtype=torch.float32)
    return z.to(masses3.device) * torch.sqrt(KB * T / masses3)


def langevin_middle_step(force_fn, x, v, masses3, T, gamma, dt,
                         gen: Optional[torch.Generator] = None):
    """One LangevinMiddle step: v += dt f/m; x += dt/2 v;
    v = a v + b sqrt(kBT/m) R; x += dt/2 v, a = exp(-gamma dt),
    b = sqrt(1 - a^2).  ``gen=None`` drops the noise term (R = 0)."""
    a = math.exp(-gamma * dt)
    b = math.sqrt(1.0 - a * a)
    h = 0.5 * dt
    v = v + dt * force_fn(x) / masses3
    x = x + h * v
    v = a * v
    if gen is not None:
        z = torch.randn(v.shape, generator=gen, dtype=v.dtype).to(v.device)
        v = v + b * torch.sqrt(KB * T / masses3) * z
    x = x + h * v
    return x, v


def langevin_middle(force_fn: Callable, x0, v0, masses3, T, gamma, dt,
                    nsteps: int, gen: Optional[torch.Generator] = None):
    """``nsteps`` LangevinMiddle steps for a batch (B, 3N); returns (x, v).
    ``gen=None`` runs the noiseless recursion."""
    x, v = x0, v0
    for _ in range(int(nsteps)):
        x, v = langevin_middle_step(force_fn, x, v, masses3, T, gamma, dt,
                                    gen)
    return x, v
