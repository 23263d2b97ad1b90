"""FIRE energy minimization; counterpart of ``isokann_tpu/md/minimize.py``.

A Python loop over autograd of the energy, with the reference's constants
and its fixed trip count (no convergence test).  It runs as plain PyTorch
on whichever device holds the coordinates (on the card, for a system
without a box, replayed from a CUDA graph of one step): no kernel of
the port serves it, as no TPU kernel served the reference's.
"""

from __future__ import annotations

import torch


def minimize_energy(energy_fn, x0, maxiter: int = 500, dt0: float = 1e-4,
                    dtmax: float = 1e-2, tol: float = 10.0,
                    graph: bool = False):
    """FIRE minimization of ``energy_fn`` (flat coords (..., D) -> (...))
    for ``maxiter`` steps; returns minimized coordinates of ``x0``'s
    shape.  ``tol`` (a max-force target in kJ/mol/nm) is accepted and
    unused, as in the JAX package: the trip count is fixed.  ``graph``: on the card, replay the steps from a CUDA graph of
    one (an eager step is a few hundred small launches, host-bound); the
    energy must then do no host work: that of a system without a box
    does none (``fixtures.peptide_pdb``), a box is copied to the card at
    each call."""
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

    def step(x, v, dt, alpha, npos):
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
        return x + dx, v, dt, alpha, npos

    B = x.shape[0]
    state = (x, torch.zeros_like(x),
             torch.full((B, 1), dt0, dtype=x.dtype, device=x.device),
             torch.full((B, 1), alpha0, dtype=x.dtype, device=x.device),
             torch.zeros(B, dtype=torch.int32, device=x.device))
    if graph and x.is_cuda and int(maxiter) > 0:
        state = _replayed(step, state, int(maxiter))
    else:
        for _ in range(int(maxiter)):
            state = step(*state)
    x = state[0]
    return x[0] if squeeze else x


def _replayed(step, state, n):
    """``n`` applications of ``step`` to the CUDA tensors ``state``,
    replayed from a CUDA graph of one (captured after a warm-up call on
    copies, on a side stream)."""
    state = tuple(t.clone() for t in state)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step(*(t.clone() for t in state))
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, capture_error_mode="thread_local"):
        for t, new in zip(state, step(*state)):
            t.copy_(new)
    for _ in range(n):
        g.replay()
    return state
