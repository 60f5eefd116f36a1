"""Distributed tier: mesh runtime, sharded batches, shuffle, distributed ops.

Entirely net-new relative to the reference (SURVEY.md §2 absence statement);
the replacement for the missing NCCL/scheduler layer per the BASELINE.md
north star.
"""

from .distributed_ops import (
    distributed_aggregate,
    distributed_filter,
    distributed_join,
    distributed_join_indices,
    distributed_sort,
    distributed_sum,
)
from .mesh import MeshRuntime, initialize_distributed
from .sharding import ShardedBatch, ShardedColumn, gather_batch, shard_batch
from .shuffle import fmix32, fmix64, hash_key, hash_partition

__all__ = [
    "MeshRuntime",
    "ShardedBatch",
    "ShardedColumn",
    "distributed_aggregate",
    "distributed_filter",
    "distributed_join",
    "distributed_join_indices",
    "distributed_sort",
    "distributed_sum",
    "fmix32",
    "fmix64",
    "gather_batch",
    "hash_key",
    "hash_partition",
    "initialize_distributed",
    "shard_batch",
]
