"""Multi-GPU walker sharding over ``torch.distributed``; counterpart of
``isokann_tpu/parallel``."""

from .mesh import (
    make_mesh, shard_batch, replicate, set_default_devices,
    default_devices, device_count,
    sharded_train_step, shardmap_train_step, sharded_propagate,
    distributed_iso_step,
)
from . import distributed

__all__ = [
    "make_mesh", "shard_batch", "replicate", "set_default_devices",
    "default_devices", "device_count", "sharded_train_step",
    "shardmap_train_step", "sharded_propagate", "distributed_iso_step",
    "distributed",
]
