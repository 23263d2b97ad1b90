"""Process-group bring-up and per-rank data feeding.

Counterpart of ``isokann_tpu/parallel/distributed.py``.  A torch "mesh" is
one process per device over a ``torch.distributed`` process group
(``parallel.mesh``); this module brings the group up and moves walker
rows between the ranks and the global batch.

A single process (the common case) works through the same API:
``initialize`` is a no-op and each rank's data is the global data.
"""

from __future__ import annotations

import datetime
import logging
import os
from typing import Optional

import torch
import torch.distributed as dist

from .._device import resolve_device

logger = logging.getLogger(__name__)

# seconds a rendezvous and every collective may wait for the other ranks
DEFAULT_TIMEOUT_S = 300.0

_local_device = None     # the device this rank runs on, set by initialize


def _init_method(address: str) -> str:
    """A rendezvous URL: ``file://`` and ``tcp://`` pass through, a bare
    ``host:port`` (JAX's coordinator address) becomes ``tcp://host:port``."""
    return address if "://" in address else f"tcp://{address}"


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, *, device=None,
               timeout: float = DEFAULT_TIMEOUT_S, **kw):
    """Bring up the process group: NCCL when this rank's device is CUDA,
    gloo on the CPU; every rendezvous and collective waits at most
    ``timeout`` seconds.

    With ``num_processes`` <= 1 this does nothing, and so does a call once
    the group is up.  With explicit arguments every failure propagates.
    Arguments left out are read from the launcher's environment, as
    ``torchrun`` sets it: ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK`` and the
    rendezvous ``MASTER_ADDR:MASTER_PORT``.  With no arguments and no
    launcher (no ``WORLD_SIZE``) it logs "single process" and returns.

    ``coordinator_address``: ``host:port``, ``tcp://host:port`` or
    ``file:///path`` (a file store; all ranks must see the path).
    ``device``: this rank's device; default the card of ``LOCAL_RANK``
    (raising without a GPU: pass ``device="cpu"`` for gloo on the host).
    ``kw`` goes to ``torch.distributed.init_process_group``."""
    global _local_device
    if num_processes is not None and num_processes <= 1:
        return
    if dist.is_initialized():
        return
    env = os.environ
    if coordinator_address is None and num_processes is None \
            and "WORLD_SIZE" not in env:
        logger.info("no process group configured (no WORLD_SIZE); "
                    "continuing as a single process")
        return
    if num_processes is None:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None:
        process_id = int(env["RANK"])
    if coordinator_address is None:
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    local_rank = int(env.get("LOCAL_RANK", process_id))
    device = resolve_device(device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", local_rank)
        torch.cuda.set_device(device)
        backend = "nccl"
    else:
        backend = "gloo"
    kw.setdefault("backend", backend)
    dist.init_process_group(
        init_method=_init_method(coordinator_address),
        world_size=int(num_processes), rank=int(process_id),
        timeout=datetime.timedelta(seconds=float(timeout)), **kw)
    _local_device = device


def shutdown():
    """Tear the process group down (a no-op without one)."""
    global _local_device
    if dist.is_initialized():
        dist.destroy_process_group()
    _local_device = None


def world_size() -> int:
    """The number of ranks: the group's size, 1 without a group."""
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    """This process's rank: 0 without a group."""
    return dist.get_rank() if dist.is_initialized() else 0


def local_device():
    """The device ``initialize`` gave this rank (None without a group)."""
    return _local_device


def global_mesh(axis: str = "data"):
    """1-D mesh over every rank of the group."""
    from .mesh import make_mesh
    return make_mesh(axis=axis)


def host_local_batch(mesh, local, axis: str = "data"):
    """The global batch from every rank's own rows: each rank passes its
    shard (n_local, ...), all of the same shape; every rank gets the
    concatenation (n_local * ranks, ...) in rank order.  With one rank
    this is ``local`` on the mesh's device."""
    local = torch.as_tensor(local).to(mesh.device)
    return mesh.all_gather(local)


def process_slice(n_global: int) -> slice:
    """The [start, stop) walker range of this rank: ``n_global`` split
    into contiguous parts that differ by at most one, the first
    ``n_global % ranks`` of them one longer."""
    nproc, i = world_size(), rank()
    per, rem = divmod(int(n_global), nproc)
    start = i * per + min(i, rem)
    return slice(start, start + per + (1 if i < rem else 0))
