"""shard_map data parallelism.

The replacement for the reference's pmap path
(``scripts/qm9_tpu/run.py:89-95``): the per-device step runs under
``shard_map`` with gradients averaged by ``psum`` over the ``data`` axis,
and — unlike the reference, which drove a python loop around pmap from the
host per batch (``run.py:110-111``) — whole epochs can scan on-device
*inside* the sharded program.

Params/opt-state stay replicated (GSPMD keeps them consistent because the
psum'd gradients are identical on every shard); batches are sharded on
their leading axis. State is donated, so a training block is one
device-resident program with a single host round trip per block.
"""

from __future__ import annotations

from typing import Callable

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

try:  # jax >= 0.7 stable API
    from jax import shard_map
except ImportError:  # pragma: no cover - older jax
    from jax.experimental.shard_map import shard_map

from sake_tpu.train.loop import scan_epoch


def make_dp_step(
    loss_fn: Callable,
    mesh: Mesh,
    axis: str = "data",
) -> Callable:
    """Build a data-parallel ``step(state, batch) -> (state, loss)``.

    ``loss_fn(params, batch) -> scalar`` is the per-shard loss (mean over
    the local sub-batch); gradients and loss are ``pmean``-ed over ``axis``
    so the update equals large-batch SGD.
    """

    def local_step(state, batch):
        loss, grads = jax.value_and_grad(loss_fn)(state.params, batch)
        grads = jax.lax.pmean(grads, axis)
        loss = jax.lax.pmean(loss, axis)
        return state.apply_gradients(grads), loss

    state_spec = P()  # replicated
    batch_spec = P(axis)  # leading axis sharded

    return shard_map(
        local_step,
        mesh=mesh,
        in_specs=(state_spec, batch_spec),
        out_specs=(state_spec, state_spec),
        check_vma=False,
    )


def make_dp_epoch(
    loss_fn: Callable,
    mesh: Mesh,
    axis: str = "data",
) -> Callable:
    """Build ``epoch(state, batched_data) -> (state, losses)`` where the
    scan over batches runs *inside* the sharded program (one XLA program
    per epoch; the reference crossed the host per batch).

    ``batched_data`` leaves have shape ``(n_batches, global_batch, ...)``;
    axis 1 is sharded over ``axis``.
    """

    def local_epoch(state, batches):
        def step(state, batch):
            loss, grads = jax.value_and_grad(loss_fn)(state.params, batch)
            grads = jax.lax.pmean(grads, axis)
            loss = jax.lax.pmean(loss, axis)
            return state.apply_gradients(grads), loss

        return scan_epoch(step, state, batches)

    return shard_map(
        local_epoch,
        mesh=mesh,
        in_specs=(P(), P(None, axis)),
        out_specs=(P(), P()),
        check_vma=False,
    )


def shard_batch(batch, mesh: Mesh, axis: str = "data"):
    """Place a host batch pytree with its leading axis sharded over the
    mesh (the host->device feed; replaces ``flax.jax_utils.replicate`` +
    manual ``(n_dev, B, ...)`` reshapes)."""
    sharding = NamedSharding(mesh, P(axis))
    return jax.tree.map(lambda a: jax.device_put(a, sharding), batch)


def replicate_state(state, mesh: Mesh):
    """Place a train-state pytree fully replicated on the mesh."""
    sharding = NamedSharding(mesh, P())
    return jax.tree.map(lambda a: jax.device_put(a, sharding), state)
