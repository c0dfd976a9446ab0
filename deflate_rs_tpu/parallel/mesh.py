"""Device mesh helpers — single-process and multi-host.

The reference is single-threaded (SURVEY.md §2: no parallel components — the
serial bitstream dependence is exactly what this build breaks).  Here the unit
of data parallelism is the independent 64 KiB chunk: chunks shard over the
``data`` mesh axis, meet in one all-gather of their compressed sizes, and are
gathered in stream order on the host.

Multi-host: ``init_distributed`` wires ``jax.distributed.initialize`` so the
mesh spans every process's devices.  Validated without real multi-host
hardware by ``scripts/multihost_dryrun.py``, which launches N coordinated CPU
processes.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh


DATA_AXIS = "data"


def init_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    local_device_ids=None,
) -> None:
    """Join (or start) a multi-process JAX runtime.

    Thin wrapper over ``jax.distributed.initialize``: arguments left as
    None fall back to JAX's own defaults, and a machine that tells JAX of no
    cluster needs all three of coordinator_address, num_processes and
    process_id.  Must run before any other JAX call in the process.  After it
    returns, ``jax.devices()`` lists the GLOBAL device set and ``make_mesh``
    builds a process-spanning mesh.
    """
    kwargs = {}
    if coordinator_address is not None:
        kwargs["coordinator_address"] = coordinator_address
    if num_processes is not None:
        kwargs["num_processes"] = num_processes
    if process_id is not None:
        kwargs["process_id"] = process_id
    if local_device_ids is not None:
        kwargs["local_device_ids"] = local_device_ids
    jax.distributed.initialize(**kwargs)


def is_distributed() -> bool:
    return jax.process_count() > 1


def make_mesh(num_devices: int | None = None) -> Mesh:
    """A 1-D ``data`` mesh over the global device set.

    In a multi-process runtime the devices span every process; collectives
    over the mesh then cross hosts transparently.  The mesh is 1-D, so it
    needs no knowledge of the interconnect's topology.
    """
    devices = jax.devices()
    if num_devices is not None:
        devices = devices[:num_devices]
    return Mesh(np.asarray(devices), (DATA_AXIS,))


def local_chunk_range(global_b: int, mesh: Mesh | None = None) -> range:
    """The [start, stop) rows of a ``DATA_AXIS``-sharded global batch whose
    shards live on THIS process — the rows a multi-host writer is
    responsible for fetching and persisting.

    Row ownership is contiguous per process because ``make_mesh`` lays the
    1-D mesh out in ``jax.devices()`` order, which groups each process's
    devices together; a ``P(DATA_AXIS)`` sharding then assigns row block i
    to device i in that same order.  shard_map already requires the batch
    to divide evenly over the mesh, so an indivisible batch is an error
    here too — the old remainder fallback would have claimed rows this
    process does not address.
    """
    n_proc = jax.process_count()
    pid = jax.process_index()
    if mesh is not None and mesh.devices.size % n_proc:
        raise ValueError(
            f"mesh of {mesh.devices.size} devices does not split over "
            f"{n_proc} processes"
        )
    if global_b % n_proc:
        raise ValueError(
            f"global batch {global_b} is not divisible by the process "
            f"count {n_proc}; pad the batch (shard_map requires this too)"
        )
    per = global_b // n_proc
    return range(pid * per, (pid + 1) * per)
