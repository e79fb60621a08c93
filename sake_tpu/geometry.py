"""Pairwise geometry core.

The O(N^2) dense all-pairs primitives every SAKE/EGNN layer is built on.
Behavioral contract follows the reference (``sake/functional.py:4-44``):

- ``EPSILON = 1e-5`` is added *inside* the square root of the pairwise
  distance so the distance is differentiable at r=0 (the self-pairs on the
  diagonal), with a ``relu`` guarding against negative round-off.
- ``INF = 1e5`` is the additive logit mask magnitude used by the attention
  mechanisms (``sake/layers.py:159-165``).

All functions are pure, shape-polymorphic over leading batch dims, and
trace to static-shape XLA programs (no data-dependent control flow), so
they fuse cleanly under ``jit``.

Convention: for positions ``x`` with shape ``(..., N, 3)``, the pairwise
tensor ``pairwise_displacement(x)[..., i, j, :] == x[j] - x[i]``; axis
``-2`` (the ``j`` / sender axis) is the axis attention normalizes and
aggregation reduces over.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

EPSILON = 1e-5
INF = 1e5


def pairwise_displacement(x: jax.Array) -> jax.Array:
    """All-pairs displacement tensor ``(..., N, N, 3)``.

    ``out[..., i, j, :] = x[..., j, :] - x[..., i, :]``
    (reference: ``sake/functional.py:7-8``).
    """
    return x[..., None, :, :] - x[..., :, None, :]


def pairwise_distance(
    displacement: jax.Array, epsilon: float = EPSILON
) -> jax.Array:
    """Regularized pairwise distance ``(..., N, N, 1)``.

    ``sqrt(relu(sum(d^2)) + eps)`` — the ``relu(.)+eps`` inside the sqrt is
    the differentiability guard at r=0 for the diagonal self-pairs
    (reference: ``sake/functional.py:10-19``).
    """
    sq = jax.nn.relu(jnp.sum(displacement**2, axis=-1, keepdims=True))
    return jnp.sqrt(sq + epsilon)


def edge_concat(h: jax.Array) -> jax.Array:
    """Broadcast-concat sender/receiver node features to ``(..., N, N, 2F)``.

    ``out[..., i, j, :] = concat(h[j], h[i])`` — built with broadcasts, not
    ``repeat``, so XLA never materializes the copies before fusion
    (reference: ``sake/functional.py:33-44``).
    """
    n = h.shape[-2]
    shape = (*h.shape[:-2], n, n, h.shape[-1])
    hj = jnp.broadcast_to(h[..., None, :, :], shape)
    hi = jnp.broadcast_to(h[..., :, None, :], shape)
    return jnp.concatenate([hj, hi], axis=-1)


def edge_mask_from_node_mask(node_mask: jax.Array) -> jax.Array:
    """Outer-product edge mask ``(..., N, N)`` from a node mask ``(..., N)``.

    Matches the padded-batch collation of the reference QM9 harness
    (``scripts/qm9_full/run.py:23-27``: ``make_edge_mask(m) = m (x) m``).
    """
    return node_mask[..., :, None] * node_mask[..., None, :]


def self_pair_logit_mask(n: int, dtype=jnp.float32) -> jax.Array:
    """``-INF`` on the diagonal, 0 elsewhere: additive logit mask removing
    self-interactions from attention (reference: ``sake/layers.py:159-162``).
    """
    return -INF * jnp.eye(n, dtype=dtype)


def apply_edge_logit_mask(logits: jax.Array, mask: jax.Array | None) -> jax.Array:
    """Additively mask attention logits.

    Always masks the diagonal (self-pairs); additionally masks padded pairs
    when ``mask`` (edge mask, ``(..., N, N)``) is given
    (reference: ``sake/layers.py:159-165``).
    ``logits`` has shape ``(..., N, N, H)``.
    """
    n = logits.shape[-2]
    logits = logits + self_pair_logit_mask(n, logits.dtype)[..., None]
    if mask is not None:
        logits = logits - INF * (1.0 - mask[..., None])
    return logits


# --- Reference-compatible aliases ------------------------------------------

get_x_minus_xt = pairwise_displacement
get_x_minus_xt_norm = pairwise_distance
get_h_cat_ht = edge_concat
