"""Parallelism layer (port of the JAX package's ``parallel/``): the device
mesh over the ranks of a ``torch.distributed`` process group and the
partition rules of the LLaVA-OneVision parameters, applied as tensor
parallelism (DTensor ``parallelize_module``) over ``tensor`` and FSDP2
``fully_shard`` over ``fsdp`` (HSDP over ``data``).

The reference trains on one GPU (``devices=1``) and places the 7B teacher
with HF accelerate's ``device_map="auto"``; the mesh dims here are the JAX
package's:

* ``data``: pure data parallelism (the batch axis);
* ``fsdp``: the student's parameters, gradients and optimizer state
  sharded across ranks, each with its own rows of the batch;
* ``tensor``: Megatron-style tensor parallelism of the blocks.

``parallel/aot.py`` is the memory planner: the sharded KD step at real 7B
widths run on fake tensors under a memory tracker (the JAX module's
``memory_analysis()``), and the per-rank parameter bytes of the rule table
and of what ``shard_params`` places.
"""

from .mesh import MeshConfig, active_mesh, make_mesh, use_mesh
from .sharding import (
    batch_sharding,
    logical_to_sharding,
    param_partition_specs,
    shard_batch,
    shard_params,
)

__all__ = [
    "MeshConfig",
    "make_mesh",
    "active_mesh",
    "use_mesh",
    "batch_sharding",
    "logical_to_sharding",
    "param_partition_specs",
    "shard_batch",
    "shard_params",
]
