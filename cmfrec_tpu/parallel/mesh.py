"""Device-mesh sharding for the ALS engine.

The reference parallelizes with OpenMP threads over rows (SURVEY.md §2.4).
The device equivalent is a 1-D data-parallel mesh axis ``d``:

  * each bucket's row-dimension arrays (idx/val/length/factor blocks) are
    sharded along rows — buckets are padded to multiples of the mesh size
    by construction (data/shards.py row_block);
  * the opposing factor matrix is replicated (n x k is small relative to
    the interaction data) — the all-gather the reference would need simply
    doesn't materialize because B is already everywhere;
  * k x k Gram bases (BtB/CtC) are computed from a row-sharded matrix via a
    psum that XLA inserts automatically under jit.

When n*k outgrows device memory, B can instead be row-sharded and the Gram/gather
pattern turns into an all-gather per half-iteration (SURVEY.md §2.4 P7);
`shard_opposing` exposes that layout.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_devices: int | None = None) -> Mesh:
    devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.array(devices), ("d",))


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> Mesh:
    """Multi-host entry point (SURVEY §2.4 P5): initialize
    ``jax.distributed`` when running one process per host and return the
    global 1-D data mesh spanning every device of every process.  Pass the
    returned mesh as ``mesh=`` to any fit driver/model — interaction
    buckets and factor blocks shard over it; XLA hands the collectives to
    NCCL (NVLink within a host).

    On a single process this skips initialization and returns the local
    mesh, so driver code is identical on 1 host and N hosts.
    """
    if num_processes is not None and num_processes > 1:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    return make_mesh()


def row_sharding(mesh: Mesh) -> NamedSharding:
    """Shard the leading (row) axis over the data axis."""
    return NamedSharding(mesh, P("d"))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_bucketed(bucketed, mesh: Mesh):
    """Place all bucket arrays with rows sharded over the mesh."""
    return bucketed.device_put(row_sharding(mesh))


def shard_blocks(blocks, mesh: Mesh):
    sh = row_sharding(mesh)
    return [jax.device_put(b, sh) for b in blocks]


def shard_opposing(opp, mesh: Mesh, shard_rows: bool = False):
    """Replicate (default) or row-shard the opposing factor matrix."""
    return jax.device_put(opp, row_sharding(mesh) if shard_rows else replicated(mesh))
