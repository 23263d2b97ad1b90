"""FIRE energy minimization; counterpart of ``isokann_tpu/md/minimize.py``.

A Python loop over autograd of the energy, with the reference's constants
and its fixed trip count (no convergence test).  It runs as plain PyTorch
on whichever device holds the coordinates: no kernel of the port serves
it, as no TPU kernel served the reference's.
"""

from __future__ import annotations

import torch


def minimize_energy(energy_fn, x0, maxiter: int = 500, dt0: float = 1e-4,
                    dtmax: float = 1e-2):
    """FIRE minimization of ``energy_fn`` (flat coords (..., D) -> (...))
    for ``maxiter`` steps; returns minimized coordinates of ``x0``'s
    shape."""
    squeeze = x0.dim() == 1
    x = (x0[None, :] if squeeze else x0).detach().clone()

    alpha0 = 0.1
    f_inc, f_dec, f_alpha = 1.1, 0.5, 0.99
    n_min = 5

    def force(z):
        with torch.enable_grad():
            z = z.detach().requires_grad_(True)
            (g,) = torch.autograd.grad(torch.sum(energy_fn(z)), z)
        return -g

    B = x.shape[0]
    v = torch.zeros_like(x)
    dt = torch.full((B, 1), dt0, dtype=x.dtype, device=x.device)
    alpha = torch.full((B, 1), alpha0, dtype=x.dtype, device=x.device)
    npos = torch.zeros(B, dtype=torch.int32, device=x.device)
    for _ in range(int(maxiter)):
        f = force(x)
        power = torch.sum(f * v, dim=-1, keepdim=True)
        fnorm = torch.linalg.vector_norm(f, dim=-1, keepdim=True) + 1e-12
        vnorm = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
        v = (1.0 - alpha) * v + alpha * f / fnorm * vnorm
        uphill = power <= 0
        v = torch.where(uphill, 0.0, v)
        npos = torch.where(uphill[:, 0], 0, npos + 1)
        grow = (npos > n_min)[:, None]
        dt = torch.where(uphill, dt * f_dec,
                         torch.where(grow, torch.clamp(dt * f_inc,
                                                       max=dtmax), dt))
        alpha = torch.where(uphill, alpha0,
                            torch.where(grow, alpha * f_alpha, alpha))
        v = v + dt * f
        # cap the displacement for stability
        dx = dt * v
        dxn = torch.linalg.vector_norm(dx, dim=-1, keepdim=True)
        dx = torch.where(dxn > 0.05, dx / dxn * 0.05, dx)
        x = x + dx
    return x[0] if squeeze else x
