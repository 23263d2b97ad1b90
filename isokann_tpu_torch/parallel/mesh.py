"""Walker / data sharding over the ranks of a process group.

Counterpart of ``isokann_tpu/parallel/mesh.py``.  The reference has no
distributed computing (SURVEY.md §2.11): its parallelism is threads over
independent walkers.  The JAX package shards the walker axis over a
``jax.sharding.Mesh`` and lets GSPMD insert the collectives.  Here a mesh
is one process per device over a ``torch.distributed`` group
(``parallel.distributed.initialize``), and every collective is written
out:

- **walker axis = rank axis.**  Koopman bursts shard the walker (leading)
  dimension into contiguous rows, one part a rank; each rank integrates
  its rows with no communication, then one ``all_gather`` gives every rank
  the whole batch.  The noise of a rank's rows is what the unsharded run
  gives them (``_device.WalkerShard``; kernel A keys its Philox stream by
  the global walker).
- **training**: each rank holds its rows of the data; ``all_reduce`` MIN
  and MAX give the global shift-scale bounds, one summed ``all_reduce``
  the gradients (normalised by the global row count, as the JAX loss
  divides by the global n), ``broadcast`` from rank 0 replicates the
  parameters.  No ``DistributedDataParallel``: its buckets buy nothing at
  these sizes, and it would hide the collectives.

Without a group every function runs on one device (``device_count()`` is
1) and the collectives are skipped; with a group of one rank they run (an
NCCL group of one on a single card exercises them).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist

from .._device import WalkerShard, make_generator, noise_generator
from . import distributed as D

_default_devices = None


def set_default_devices(devices) -> None:
    """Pin the device list that ``make_mesh()`` / ``device_count()`` use
    (``None`` restores the group's).  A mesh has one device a rank, so a
    pinned list must be as long as the group is large."""
    global _default_devices
    _default_devices = (None if devices is None
                        else [torch.device(d) for d in devices])


def default_devices():
    """The devices of the ranks: the ``set_default_devices`` override if
    set; with a group, the device ``initialize`` gave this rank, once a
    rank (a rank knows only its own), or for an NCCL group brought up
    elsewhere (``torchrun`` and ``init_process_group``) the current card;
    else the one device of this process.  A group of another backend that
    ``initialize`` did not bring up raises: its device is not known, and
    the CPU is never assumed."""
    if _default_devices is not None:
        return list(_default_devices)
    if dist.is_initialized():
        device = D.local_device()
        if device is None:
            if dist.get_backend() != "nccl":
                raise RuntimeError(
                    f"a {dist.get_backend()} process group that "
                    f"parallel.distributed.initialize did not bring up: "
                    f"name the rank's device with set_default_devices")
            device = torch.device("cuda", torch.cuda.current_device())
        return [device] * D.world_size()
    return [torch.device("cuda", torch.cuda.current_device())
            if torch.cuda.is_available() else torch.device("cpu")]


def device_count() -> int:
    """The shard condition's device count: the pinned list's length, else
    the group's size (1 without a group)."""
    if _default_devices is not None:
        return len(_default_devices)
    return D.world_size()


@dataclass(frozen=True)
class Mesh:
    """A 1-D mesh: one device a rank of the default process group."""

    devices: tuple
    axis: str = "data"

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def rank(self) -> int:
        return D.rank()

    @property
    def grouped(self) -> bool:
        """Whether the collectives run: a process group is up."""
        return dist.is_initialized()

    @property
    def device(self) -> torch.device:
        return self.devices[self.rank]

    def rows(self, n: int) -> slice:
        """This rank's contiguous rows of an ``n``-row batch (equal parts;
        ``n`` must divide by the mesh size)."""
        if n % self.size:
            raise ValueError(f"{n} rows do not shard over {self.size} ranks")
        per = n // self.size
        return slice(self.rank * per, (self.rank + 1) * per)

    def all_reduce(self, t, op=dist.ReduceOp.SUM):
        """``t`` reduced over the ranks, in place (returned)."""
        if self.grouped:
            dist.all_reduce(t, op=op)
        return t

    def all_gather(self, t):
        """Every rank's ``t`` (all of one shape) concatenated along the
        leading axis in rank order, on every rank."""
        if not self.grouped:
            return t
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(parts, t)
        return torch.cat(parts, dim=0)


def make_mesh(n_devices: Optional[int] = None, axis: str = "data",
              devices=None) -> Mesh:
    """1-D mesh over the first ``n_devices`` devices (or an explicit
    device list): one device a rank, so the list must be as long as the
    process group is large (one device without a group)."""
    devices = default_devices() if devices is None else [
        torch.device(d) for d in devices]
    if n_devices is not None:
        devices = devices[:n_devices]
    if len(devices) != D.world_size():
        raise ValueError(f"a mesh has one device a rank: {len(devices)} "
                         f"devices for {D.world_size()} ranks")
    return Mesh(tuple(devices), axis)


def shard_batch(mesh: Mesh, x, axis: str = "data"):
    """This rank's rows of the global batch ``x`` (its leading axis cut
    into ``mesh.size`` contiguous parts), on the rank's device."""
    x = torch.as_tensor(x)
    return x[mesh.rows(x.shape[0])].to(mesh.device)


def _broadcast(mesh: Mesh, t):
    """Rank 0's ``t`` on every rank, in place (through the rank's device
    where the backend needs it there)."""
    if not mesh.grouped:
        return
    on_device = t.device == mesh.device or mesh.device.type == "cpu"
    buf = t.detach() if on_device and t.is_contiguous() else \
        t.detach().contiguous().to(mesh.device)
    dist.broadcast(buf, src=0)
    if buf.data_ptr() != t.data_ptr():
        with torch.no_grad():
            t.copy_(buf)


def replicate(mesh: Mesh, tree):
    """Rank 0's values of ``tree`` on every rank, in place: a module (its
    parameters and buffers, moved to the rank's device), an optimiser (its
    state), a tensor (moved) or a dict / list / tuple of them.  Returns
    ``tree``."""
    if isinstance(tree, torch.nn.Module):
        tree.to(mesh.device)
        for t in list(tree.parameters()) + list(tree.buffers()):
            _broadcast(mesh, t)
        return tree
    if isinstance(tree, torch.optim.Optimizer):
        for state in tree.state.values():
            for v in state.values():
                if isinstance(v, torch.Tensor):
                    _broadcast(mesh, v)
        return tree
    if isinstance(tree, torch.Tensor):
        tree = tree.to(mesh.device)
        _broadcast(mesh, tree)
        return tree
    if isinstance(tree, dict):
        return {k: replicate(mesh, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(replicate(mesh, v) for v in tree)
    return tree


# ==========================================================================
# Sharded propagation
# ==========================================================================

def sharded_propagate(mesh: Mesh, step_fn, x0, gen, axis: str = "data"):
    """Run a batched propagation ``step_fn(x, gen) -> y`` with the walkers
    ``x0`` (nwalkers, ...) sharded over the mesh: each rank runs its rows
    with ``gen`` as a ``WalkerShard`` (so the port's integrators and
    kernel A give its rows the unsharded run's noise), and every rank
    gets the whole result.  No traffic but the final ``all_gather``."""
    if mesh.size == 1:
        return step_fn(x0, gen)
    rows = mesh.rows(x0.shape[0])
    y = step_fn(x0[rows], WalkerShard(gen, rows.start, x0.shape[0]))
    return mesh.all_gather(y)


# ==========================================================================
# Sharded ISOKANN training step
# ==========================================================================

def _optimizer(model, opt):
    """``opt`` as a ``torch.optim.Optimizer`` of ``model``: an optimiser
    passes through, a recipe (``AdamRegularized()``) is built on the
    model's parameters."""
    if isinstance(opt, torch.optim.Optimizer):
        return opt
    return opt(model.parameters())


def sum_gradients(mesh: Mesh, params, *values):
    """The gradients of ``params`` and the 0-d tensors ``values`` summed
    over the ranks in one ``all_reduce``; the gradients are replaced in
    place (zeros for a parameter without one), the summed values
    returned."""
    grads = [p.grad if p.grad is not None else torch.zeros_like(p)
             for p in params]
    flat = mesh.all_reduce(torch.cat([g.reshape(-1) for g in grads]
                                     + [v.reshape(1) for v in values]))
    k = 0
    for p, g in zip(params, grads):
        p.grad = flat[k:k + g.numel()].view_as(p).clone()
        k += g.numel()
    return flat[k:]


def _koopman_step(mesh: Mesh, model, optimizer, xs, ys, yw, pmean: bool):
    """One Koopman iteration on this rank's rows: the shift-scale target
    from the global min / max of the Koopman expectation, the loss
    sum((chi(xs) - target)^2) / n and its gradients summed over the
    ranks, one optimiser step.  ``pmean``: the shard_map form (each
    rank's mean over its own rows, averaged over the ranks) instead of
    the sum over the global n.  Returns the global loss."""
    with torch.no_grad():
        chi_y = model(ys)                                  # (n, k, d)
        if yw is not None:
            kchi = torch.sum(chi_y * yw[..., None], dim=1) / ys.shape[1]
        else:
            kchi = torch.mean(chi_y, dim=1)
        inf = torch.tensor(float("inf"), device=kchi.device,
                           dtype=kchi.dtype)
        lo = torch.min(kchi) if kchi.numel() else inf.clone()
        hi = torch.max(kchi) if kchi.numel() else -inf
        mesh.all_reduce(lo, dist.ReduceOp.MIN)
        mesh.all_reduce(hi, dist.ReduceOp.MAX)
        target = (kchi - lo) / (hi - lo)
    optimizer.zero_grad(set_to_none=True)
    n_local = xs.shape[0]
    loss = torch.sum((model(xs) - target) ** 2)
    if pmean:
        loss = loss / n_local
    loss.backward()
    params = [p for g in optimizer.param_groups for p in g["params"]]
    # one collective: the gradients, the loss and the row count
    loss_sum, n = sum_gradients(mesh, params, loss.detach(),
                                loss.new_full((), float(n_local)))
    norm = float(mesh.size) if pmean else n
    for p in params:
        p.grad.div_(norm)
    optimizer.step()
    return loss_sum / norm


def sharded_train_step(mesh: Mesh, model, opt, axis: str = "data",
                       weighted: bool = False):
    """One Koopman iteration sharded over the mesh:

        kchi = mean_k model(ys)              (each rank its rows)
        target = (kchi - min) / (max - min)  (all_reduce MIN / MAX)
        loss = sum((model(xs) - target)^2) / n, n the global row count
        grads: all_reduce SUM of the rows' gradients, divided by n

    Returns ``step(xs, ys, yw, gen=None) -> loss`` on this rank's rows
    (``shard_batch``): ``model`` and the optimiser (``step.optimizer``,
    built from the recipe ``opt`` or ``opt`` itself) are updated in place
    and stay the same on every rank (``replicate`` them first).
    ``weighted``: the Girsanov estimate sum_k yw chi / k."""
    optimizer = _optimizer(model, opt)

    def step(xs, ys, yw=None, gen=None):
        return _koopman_step(mesh, model, optimizer, xs, ys,
                             yw if weighted else None, pmean=False)

    step.optimizer = optimizer
    return step


def shardmap_train_step(mesh: Mesh, model, opt, axis: str = "data"):
    """``sharded_train_step`` in the JAX package's shard_map form: each
    rank's loss is the mean over its own rows, and the gradients and the
    loss are averaged over the ranks (a summed ``all_reduce`` divided by
    the mesh size); for equal shards the same numbers.  Returns
    ``step(xs, ys, yw, gen=None) -> loss`` (``yw`` unused, as there)."""
    optimizer = _optimizer(model, opt)

    def step(xs, ys, yw=None, gen=None):
        return _koopman_step(mesh, model, optimizer, xs, ys, None,
                             pmean=True)

    step.optimizer = optimizer
    return step


# ==========================================================================
# Full distributed ISOKANN step: propagate + featurize + train
# ==========================================================================

def _bucket(nw: int) -> int:
    """The walker count padded as ``MDSimulation.propagate`` pads it."""
    return max(8, 1 << (nw - 1).bit_length())


def distributed_iso_step(mesh: Mesh, sim, model, opt, nk: int,
                         featurizer=None, axis: str = "data"):
    """One data-generation + training iteration over the mesh.

    Returns ``step(x0, gen=None) -> (loss, ys)``: ``x0`` (n, d) the global
    start points on every rank, ``ys`` (n, nk, d) the global bursts on
    every rank; ``model`` and the optimiser (``step.optimizer``) are
    updated in place.  The n nk walkers, padded to a power of two (>= 8)
    as ``MDSimulation.propagate`` pads them, are sharded over the ranks
    and propagated for the simulation's lag; each rank featurizes and
    trains on its rows of ``x0`` (``distributed.process_slice``) with the
    collectives of ``sharded_train_step``.

    The propagation is the JAX package's: on an ``MDSimulation``, plain
    LangevinMiddle from Maxwell-Boltzmann velocities with **no
    constraint set** (the reference's step ignores the simulation's
    constraints and rigid waters, ``isokann_tpu/parallel/mesh.py:217-222``;
    ROADMAP Queue 3 (aa)): kernel A's trajectory entry where the
    simulation is on the fused route (its plain version in float64 or on
    the CPU), else the plain recursion over the route's forces; on an
    analytic diffusion, Euler-Maruyama over -grad V.  Features and the
    learner are float32, as there."""
    from ..md import integrators as I
    from ..md import langevin_kernel as LK

    featurizer = featurizer or getattr(sim, "featurizer", None) or (
        lambda x: x)
    optimizer = _optimizer(model, opt)
    nsteps = getattr(sim, "steps", None) or max(
        1, int(round(sim.lagtime / sim.dt)))

    if hasattr(sim, "system"):                     # MDSimulation
        def propagate(xk, gen):
            v0 = I.maxwell_boltzmann(gen, sim.masses3, sim.temp, xk.shape)
            if sim.route == "fused" and not sim.plain_versions:
                return LK.langevin_middle(sim.plan, xk, v0, nsteps, gen)[0]
            if sim.route == "fused":
                return LK.langevin_middle_plain(sim.plan, xk, v0, nsteps,
                                                gen)[0]
            return I.langevin_middle(sim.force, xk, v0, sim.masses3,
                                     sim.temp, sim.friction, sim.step,
                                     nsteps, noise_generator(gen, xk.device)
                                     )[0]
    else:                                          # analytic diffusion
        def propagate(xk, gen):
            return sim._em(xk, nsteps, noise_generator(gen, xk.device))

    def step(x0, gen=None):
        gen = make_generator(gen)
        dtype = getattr(sim, "dtype", torch.float32)
        x0 = torch.as_tensor(x0, dtype=dtype).to(mesh.device)
        n, d = x0.shape
        nw = n * nk
        xr = torch.repeat_interleave(x0, nk, dim=0)
        bucket = _bucket(nw)
        xr = torch.cat([xr, xr[-1:].expand(bucket - nw, d)], dim=0)
        ys = sharded_propagate(mesh, propagate, xr, gen)[:nw]
        rows = D.process_slice(n) if mesh.size > 1 else slice(0, n)
        yk = ys.reshape(n, nk, d)[rows]
        fys = featurizer(yk.reshape(-1, d)).to(torch.float32)
        fys = fys.reshape(yk.shape[0], nk, -1)
        fxs = featurizer(x0[rows]).to(torch.float32)
        loss = _koopman_step(mesh, model, optimizer, fxs, fys, None,
                             pmean=False)
        return loss, ys.reshape(n, nk, d)

    step.optimizer = optimizer
    return step
