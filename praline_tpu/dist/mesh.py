"""Device mesh setup (SURVEY.md §3.2 "collective backend" row).

The reference is a single-process CPU program; this build distributes the
pair space over ``jax.sharding.Mesh`` axes with XLA collectives (NCCL on GPUs).
Mesh axes: ``pairs`` shards independent DP problems (the data-parallel axis);
a future ``wave`` axis is reserved for the multi-device diagonal-block ring
over one huge problem (SURVEY.md §3.2 "ring" row, out of the minimum slice).

Multi-host: call :func:`initialize_distributed` once per process before any
JAX call; the mesh then spans all processes' devices and
``host_local_batch`` maps each host's slice of the pair space.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec

PAIR_AXIS = "pairs"


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> None:
    """Multi-host bring-up (jax.distributed); no-op for single process."""
    if num_processes is None or num_processes <= 1:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def make_pair_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """1-D mesh over the pair axis using the first ``n_devices`` devices."""
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        if len(devices) < n_devices:
            raise ValueError(f"need {n_devices} devices, have {len(devices)}")
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (PAIR_AXIS,))


def pair_sharding(mesh: Mesh) -> NamedSharding:
    """Leading (batch) axis sharded over the pair axis."""
    return NamedSharding(mesh, PartitionSpec(PAIR_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, PartitionSpec())
