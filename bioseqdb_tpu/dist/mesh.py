"""Device mesh setup and data-parallel sharding.

The reference has no parallelism at all — one Postgres backend process
per connection, one `mem_align1` call per row (SURVEY.md §2b). This
module introduces it: a 1-D ``data`` mesh over all devices
(across hosts when `jax.distributed` is initialized), read batches
sharded along the batch axis with ``NamedSharding``, and the FM-index
replicated to every device — the small-genome configuration of the
north star. Every pipeline stage is elementwise over reads, so XLA
partitions the jitted program with zero collectives on the hot path
(the banded-SW kernel runs per shard under ``shard_map``,
kernels/extend.py); hit merging happens host-side per shard.

(Human-scale BWT-interval index sharding — the ``index`` mesh axis —
lives in dist/shard_index.py.)
"""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def init_distributed(coordinator: str | None = None, num_processes: int | None = None,
                     process_id: int | None = None) -> None:
    """Multi-host runtime init (jax.distributed.initialize passthrough).
    No-op for single-process runs."""
    if coordinator is None:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
    )


def make_mesh(n_devices: int | None = None, axis: str = "data") -> Mesh:
    """1-D mesh over the first ``n_devices`` devices (default: all)."""
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), axis_names=(axis,))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def batch_sharded(mesh: Mesh, axis: str = "data") -> NamedSharding:
    return NamedSharding(mesh, P(axis))


def shard_pytree_replicated(tree, mesh: Mesh):
    """Replicate every array of a pytree to all mesh devices."""
    sh = replicated(mesh)
    return jax.tree.map(lambda x: jax.device_put(x, sh), tree)


def pad_batch_rows(n: int, mesh: Mesh) -> int:
    """Rows must divide evenly across the data axis."""
    d = mesh.devices.size
    return ((n + d - 1) // d) * d
