"""Data parallelism over a process group: the mesh, sharding, collectives,
the launcher, ROI-sharded inference, the multi-host worker and the dry run.

Counterpart of the JAX package's ``parallel/``. One process is one device
(``cuda:rank % device_count``, or the CPU); the collectives are NCCL's on
the GPU and Gloo's on the CPU, or Gloo's with CUDA tensors where the caller
asks for it (two ranks on one card).
"""

from .mesh import (DATA_AXIS, all_gather, all_mean, all_sum, batch_spec, broadcast_,
                   create_mesh, init_distributed, mesh_device, rank_of, replicate,
                   replicated_spec, shard_batch, world_of)

__all__ = [
    "DATA_AXIS", "all_gather", "all_mean", "all_sum", "batch_spec", "broadcast_",
    "create_mesh", "init_distributed", "mesh_device", "rank_of", "replicate",
    "replicated_spec", "shard_batch", "world_of",
]
