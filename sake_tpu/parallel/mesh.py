"""Device-mesh construction for single-host, multi-host, and multi-slice.

Replaces all three of the reference's distribution tiers (jit / pmap+pmean /
mpi4jax allreduce — SURVEY §2.9) with one abstraction: a
``jax.sharding.Mesh`` whose collectives ride the device interconnect within
a host and the network across hosts, programmed with ``shard_map``/``pjit``. No MPI, no
replicate/unreplicate state juggling.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(
    axes: Sequence[tuple[str, int]] = (("data", -1),),
    devices: Optional[Sequence[jax.Device]] = None,
) -> Mesh:
    """Build a mesh over the given axes; a single ``-1`` axis size is
    inferred from the device count.

    Default is a pure data-parallel mesh over all devices — the shape of
    every reference workload. Pass e.g. ``(("data", 4), ("model", 2))``
    for hybrid layouts.
    """
    devices = list(devices if devices is not None else jax.devices())
    names = [n for n, _ in axes]
    sizes = [s for _, s in axes]
    n_infer = sizes.count(-1)
    if n_infer > 1:
        raise ValueError("at most one axis size may be -1")
    if n_infer == 1:
        known = int(np.prod([s for s in sizes if s != -1])) if len(sizes) > 1 else 1
        if len(devices) % known:
            raise ValueError(
                f"{len(devices)} devices not divisible by fixed axes {known}"
            )
        sizes[sizes.index(-1)] = len(devices) // known
    total = int(np.prod(sizes))
    if total != len(devices):
        raise ValueError(f"mesh size {total} != device count {len(devices)}")
    dev_array = np.asarray(devices).reshape(sizes)
    return Mesh(dev_array, tuple(names))


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Multi-process initialization (the multi-host entry).

    Replaces the reference's MPI bootstrap (``scripts/ani_mpi/run_mpi.py:
    9-13`` + checkpoint-based weight sync): ``jax.distributed.initialize``
    wires all processes into one global device set; meshes built afterwards
    span hosts transparently.
    Where no cluster environment describes the processes, pass
    ``coordinator_address`` (``host:port``), ``num_processes`` and
    ``process_id`` explicitly.
    """
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def replicated(mesh: Mesh) -> NamedSharding:
    """Sharding for fully-replicated arrays (params, opt state)."""
    return NamedSharding(mesh, P())


def batch_sharded(mesh: Mesh, axis: str = "data") -> NamedSharding:
    """Sharding splitting the leading (batch) axis over ``axis``."""
    return NamedSharding(mesh, P(axis))
