"""Multi-card scaling: the symbol-lane mesh (mesh.py) and symbol-hash
routing across engine shards (router.py). The port of
``gome_tpu/parallel``."""

from .mesh import (
    Mesh,
    Sharded,
    global_fill_rate,
    make_mesh,
    mesh_backend,
    process_mesh,
    shard_batch,
    shard_execution_report,
    sharded_batch_step,
    sharded_dense_step,
    symbol_sharding,
)
from .router import ShardedEngine, ShardRouter, fnv1a, multihost_mesh

__all__ = [
    "Mesh",
    "Sharded",
    "global_fill_rate",
    "make_mesh",
    "mesh_backend",
    "process_mesh",
    "shard_batch",
    "shard_execution_report",
    "sharded_batch_step",
    "sharded_dense_step",
    "symbol_sharding",
    "ShardRouter",
    "ShardedEngine",
    "fnv1a",
    "multihost_mesh",
]
