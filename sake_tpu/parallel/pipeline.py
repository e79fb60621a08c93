"""Pipeline parallelism over model depth (GPipe microbatch schedule).

The reference has no pipeline parallelism at all (its only multi-device
mode is ``jax.pmap`` data parallelism, ``scripts/qm9_tpu/run.py:89-95``);
this is the depth-scaling layout for SAKE stacks too deep or
too wide for one device's memory: the ``depth`` layers are sharded over a
``pipe`` mesh axis (S stages, L = depth/S contiguous layers each) and the
batch is split into M microbatches that flow through the stages.

Inside one ``shard_map`` every device runs the same T = M + S - 1
pipeline ticks (a ``lax.scan``):

- stage 0 *injects* microbatch ``t`` at tick ``t``;
- every stage applies its local L-layer stack (an inner ``lax.scan`` over
  depth-stacked layer params — one traced layer body, XLA-friendly) to
  the state it holds (microbatch ``m = t - stage``);
- the (h, x, v) state is ``ppermute``'d one stage down the ring — the
  per-tick payload is one microbatch's node-level state,
  ``b * N * (F + 6)`` floats; edge-level tensors never cross chips;
- the last stage banks its result for microbatch ``t - (S - 1)``.

Ticks where ``m`` is out of [0, M) are pipeline bubbles: the stage
computes on garbage and the result is discarded by a ``where`` — the
standard SPMD formulation (every device runs an identical program, so
XLA compiles ONE step body; bubble fraction is (S-1)/(M+S-1)).

Embedding and readout are node-level-cheap and run replicated outside
the tick loop. Per-layer ``update`` schedules (``sake/models.py:37-43``
semantics) become traced flags selected with ``where`` so all stages
share one layer body.

Differentiable end-to-end (``jax.grad`` through ``ppermute`` — the same
contract the ring atom-sharded path relies on), so force training works
through the pipeline. Oracle-exact vs the dense functional model
(tests/test_parallel.py). Composes with an outer ``data`` mesh axis in
the SAME ``shard_map`` (``data_axis=``): the per-microbatch slice is
sharded over ``data`` while layers are sharded over ``pipe`` — each data
shard runs an independent pipeline, no cross-``data`` collectives in the
forward (gradient ``psum`` over ``data`` belongs to the caller's loss,
as in ``data_parallel.make_dp_step``).

Full 3D parallelism: ``model_axis=`` additionally runs every stage's
layer body with the spatial-coefficient axis sharded over a ``model``
mesh axis (``tensor_parallel.tp_layer_forward`` — 2 node-level ``psum``
collectives per layer), so one ``shard_map`` covers
data x pipe x model on a single 3D mesh.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

try:  # jax >= 0.7 stable API
    from jax import shard_map
except ImportError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map

from sake_tpu.kernels.functional import (
    ModelParams,
    _embed,
    _make_mm,
    _readout,
    layer_forward_planes,
)
from sake_tpu.parallel.tensor_parallel import tp_layer_forward


def _stack_layers(layers):
    """Tuple of LayerParams -> one LayerParams of (depth, ...) leaves."""
    return jax.tree.map(lambda *ls: jnp.stack(ls), *layers)


def pp_model_forward(
    p: ModelParams,
    h: jax.Array,  # (B, N, F_in)
    x: jax.Array,  # (B, N, 3)
    mesh: Mesh,
    *,
    axis: str = "pipe",
    data_axis: Optional[str] = None,
    model_axis: Optional[str] = None,
    n_heads: int = 4,
    update: Sequence[bool] | bool = True,
    mask: Optional[jax.Array] = None,  # (B, N, N)
    n_microbatches: Optional[int] = None,
    matmul_dtype=None,
):
    """Full model forward with depth pipelined over ``axis``; returns
    ``(out, x_out)`` replicated across the pipe axis (sharded over
    ``data_axis`` when given — PP x DP on one 2D mesh).

    ``n_microbatches`` defaults to the stage count (the smallest M that
    keeps every stage busy once the pipeline fills; raise it to shrink
    the bubble fraction at the cost of smaller per-tick tiles).

    ``model_axis`` shards each stage's layer internals (the C-wide
    spatial-coefficient tensors) over that mesh axis via
    ``tp_layer_forward`` — full data x pipe x model 3D parallelism.
    """
    depth = len(p.layers)
    S = mesh.shape[axis]
    if depth % S:
        raise ValueError(f"depth {depth} not divisible by {S} stages")
    M = n_microbatches if n_microbatches is not None else S
    B, N, _ = h.shape
    if B % M:
        raise ValueError(f"batch {B} not divisible by {M} microbatches")
    b = B // M
    if data_axis is not None and b % mesh.shape[data_axis]:
        raise ValueError(
            f"microbatch {b} not divisible by data axis "
            f"{mesh.shape[data_axis]}"
        )
    updates = [update] * depth if isinstance(update, bool) else list(update)
    flags = jnp.asarray(updates, jnp.float32)  # (depth,)
    stacked = _stack_layers(p.layers)  # (depth, ...) leaves
    mm = _make_mm(matmul_dtype)
    T = M + S - 1

    # embed / microbatch outside the pipeline (replicated, node-level)
    h0 = _embed(p, h, mm).reshape(M, b, N, -1)
    F = h0.shape[-1]
    x_mb = x.reshape(M, b, N, 3)
    mask_mb = mask.reshape(M, b, N, N) if mask is not None else None

    def local_fn(stage_layers, stage_flags, h_in, x_in, mask_in):
        # per-device microbatch slice: b shrinks under a data axis
        _, bl, _, Fl = h_in.shape
        stage = jax.lax.axis_index(axis)
        is_first = stage == 0
        is_last = stage == S - 1
        perm = [(i, (i + 1) % S) for i in range(S)]

        def run_stage(state, m_idx):
            """Apply this device's L layers to ``state`` (microbatch
            ``m_idx``'s mask; garbage m_idx during bubbles is discarded
            by the caller)."""
            msk = (
                jax.lax.dynamic_index_in_dim(
                    mask_in, m_idx, 0, keepdims=False
                )
                if mask_in is not None
                else None
            )

            def one_layer(carry, lp_flag):
                lp, flag = lp_flag
                hc, xc, vc = carry
                xp = [xc[..., k : k + 1] for k in range(3)]
                vp = [vc[..., k : k + 1] for k in range(3)]
                if model_axis is not None:
                    h2, xp2, vp2 = tp_layer_forward(
                        lp, hc, xp, vp,
                        n_heads=n_heads, update=True, axis=model_axis,
                        n_shards=mesh.shape[model_axis], mask=msk,
                        matmul_dtype=matmul_dtype,
                    )
                else:
                    h2, xp2, vp2 = layer_forward_planes(
                        lp, hc, xp, vp,
                        n_heads=n_heads, update=True, mask=msk,
                        matmul_dtype=matmul_dtype,
                    )
                # per-layer update schedule as a traced flag: x/v keep
                # their values on update=False layers (h always updates)
                x2 = jnp.where(flag > 0, jnp.concatenate(xp2, -1), xc)
                v2 = jnp.where(flag > 0, jnp.concatenate(vp2, -1), vc)
                return (h2, x2, v2), None

            out, _ = jax.lax.scan(
                one_layer, state, (stage_layers, stage_flags)
            )
            return out

        zeros_state = (
            jnp.zeros((bl, N, Fl), jnp.float32),
            jnp.zeros((bl, N, 3), jnp.float32),
            jnp.zeros((bl, N, 3), jnp.float32),
        )
        out_h = jnp.zeros((M, bl, N, Fl), jnp.float32)
        out_x = jnp.zeros((M, bl, N, 3), jnp.float32)

        def tick(carry, t):
            state, out_h, out_x = carry
            m = t - stage  # microbatch this stage handles at tick t
            mc = jnp.clip(m, 0, M - 1)
            # stage 0 injects microbatch t (v initialized to 0: the first
            # layer's gate*v term vanishes, matching the dense model's
            # v=None start)
            tc = jnp.clip(t, 0, M - 1)
            inject = (
                jax.lax.dynamic_index_in_dim(h_in, tc, 0, keepdims=False),
                jax.lax.dynamic_index_in_dim(x_in, tc, 0, keepdims=False),
                zeros_state[2],
            )
            state = jax.tree.map(
                lambda i, s: jnp.where(is_first, i, s), inject, state
            )
            new_state = run_stage(state, mc)
            # last stage banks microbatch m = t - (S-1) when it is real
            bank = jnp.logical_and(is_last, jnp.logical_and(m >= 0, m < M))
            old_h = jax.lax.dynamic_index_in_dim(out_h, mc, 0)
            old_x = jax.lax.dynamic_index_in_dim(out_x, mc, 0)
            out_h = jax.lax.dynamic_update_index_in_dim(
                out_h, jnp.where(bank, new_state[0][None], old_h), mc, 0
            )
            out_x = jax.lax.dynamic_update_index_in_dim(
                out_x, jnp.where(bank, new_state[1][None], old_x), mc, 0
            )
            # hand the state to the next stage (ring; stage 0's inbound
            # wrap-around is overwritten by injection)
            new_state = jax.lax.ppermute(new_state, axis, perm)
            return (new_state, out_h, out_x), None

        (state, out_h, out_x), _ = jax.lax.scan(
            tick, (zeros_state, out_h, out_x), jnp.arange(T)
        )
        # only the last stage wrote its banks (others stayed zero):
        # psum replicates the pipeline output to every stage
        return jax.lax.psum((out_h, out_x), axis)

    # (M, b, ...) microbatch arrays: b sharded over the data axis when given
    Pd = P(None, data_axis) if data_axis is not None else P()
    in_specs = (P(axis), P(axis), Pd, Pd, Pd)
    if mask is None:
        fn = shard_map(
            lambda sl, sf, h_, x_: local_fn(sl, sf, h_, x_, None),
            mesh=mesh,
            in_specs=in_specs[:4],
            out_specs=(Pd, Pd),
            check_vma=False,
        )
        h_fin, x_fin = fn(stacked, flags, h0, x_mb)
    else:
        fn = shard_map(
            local_fn,
            mesh=mesh,
            in_specs=in_specs,
            out_specs=(Pd, Pd),
            check_vma=False,
        )
        h_fin, x_fin = fn(stacked, flags, h0, x_mb, mask_mb)

    out = _readout(p, h_fin.reshape(B, N, F), mm)
    return out, x_fin.reshape(B, N, 3)
