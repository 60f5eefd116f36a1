"""Mesh runtime: device mesh construction + multi-host initialization.

Net-new component (SURVEY.md §2 "Parallelism & distribution — explicit absence
statement": the reference has exactly one `GpuDevice` and no collectives).  The
replacement for the missing NCCL/MPI layer is `jax.distributed` +
`jax.sharding.Mesh` with XLA collectives, which XLA hands to NCCL on GPUs
(BASELINE.md north star).
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import config

log = logging.getLogger("arrow_tpu")


def smap(fn, mesh: Mesh, in_specs, out_specs):
    """`jax.shard_map` with replication checking off (programs here mix
    collectives and per-shard data-dependent shapes)."""
    return jax.shard_map(
        fn, mesh=mesh, in_specs=in_specs, out_specs=out_specs, check_vma=False
    )


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Multi-host bring-up (one call per host, ≙ the per-process
    ``GpuDevice::new`` `gpu_device.rs:46-84` — but across hosts).

    No-op when already initialized or single-process.
    """
    if num_processes is None or num_processes <= 1:
        return
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
        log.info(
            "arrow_tpu distributed: process %s/%s, %d global devices",
            process_id,
            num_processes,
            jax.device_count(),
        )
    except RuntimeError as e:  # already initialized
        log.warning("jax.distributed.initialize: %s", e)


@dataclasses.dataclass
class MeshRuntime:
    """A 1-D data mesh over which tables are hash-partitioned.

    The partition axis (default name from config.shard_axis) spans every
    device; on one host's GPUs every card reaches every other over NVLink at
    the same rate, so the mesh follows the algorithm alone.  XLA inserts the
    collectives.
    """

    mesh: Mesh

    @classmethod
    def create(
        cls,
        num_devices: Optional[int] = None,
        axis: Optional[str] = None,
        devices: Optional[Sequence[jax.Device]] = None,
    ) -> "MeshRuntime":
        axis = axis or config.shard_axis
        if devices is None:
            devices = jax.devices()
        if num_devices is not None:
            devices = devices[:num_devices]
        mesh = Mesh(np.asarray(devices), (axis,))
        return cls(mesh)

    @property
    def axis(self) -> str:
        return self.mesh.axis_names[0]

    @property
    def num_shards(self) -> int:
        return self.mesh.devices.size

    def sharding(self, *spec) -> NamedSharding:
        return NamedSharding(self.mesh, P(*spec))

    def shard_leading(self) -> NamedSharding:
        """Shard axis 0 (the per-device partition dim) across the mesh."""
        return NamedSharding(self.mesh, P(self.axis))

    def replicated(self) -> NamedSharding:
        return NamedSharding(self.mesh, P())

    def __repr__(self) -> str:
        return f"MeshRuntime(axis={self.axis!r}, shards={self.num_shards})"
