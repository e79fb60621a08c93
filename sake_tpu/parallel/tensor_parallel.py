"""Tensor parallelism over the spatial-attention coefficient axis.

The SAKE layer's widest tensors carry ``C = n_heads * hidden`` spatial
coefficients (``x_mixing`` output, ``sake/layers.py:95,111``): the
``(E, C)`` x-mixing matmul, the tanh, and the pooled spatial chains are
~70% of layer FLOPs. This module shards that axis across a ``model``
mesh axis, Megatron-style:

- column-split ``w_xmix`` -> each device forms only its ``C/n`` slice of
  the coefficients/pooled tensors;
- row-split the consumers (``w_post0``, ``w_vmix``) -> partial products
  ``psum``'d back to replicated node-level tensors (2 small collectives
  per layer).

Everything else (edge model, attention, node aggregation) is replicated
compute — the standard TP tradeoff at these widths. Declared future work
in COVERAGE §2.9; the reference has no TP at all. Oracle-exact vs the
dense model (tests/test_parallel.py).
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
    EPSILON,
    INF,
    ModelParams,
    _celu2,
    _embed,
    _make_mm,
    _readout,
    _silu,
    pairwise_geometry_planes,
)


def _slice_c(w, c0, c_loc, axis):
    return jax.lax.dynamic_slice_in_dim(w, c0, c_loc, axis=axis)


def tp_layer_forward(
    p, h, x_planes, v_planes, *, n_heads, update, axis, n_shards,
    mask=None, matmul_dtype=None,
):
    """One dense SAKE layer with the coefficient axis sharded over
    ``axis``. Inputs/outputs are REPLICATED across the axis (node-level
    state is small); only the C-wide internals are sharded."""
    B, N, F = h.shape
    H = p.edge.w_out0.shape[-1]
    K = n_heads
    C = p.w_xmix.shape[-1]
    assert C % n_shards == 0, "C must divide the model axis"
    c_loc = C // n_shards
    c0 = jax.lax.axis_index(axis) * c_loc
    mm = _make_mm(matmul_dtype)
    h2d = h.reshape(B * N, F)
    mask4 = mask[..., None] if mask is not None else None

    d_planes, r = pairwise_geometry_planes(x_planes)

    # --- edge model + attention: replicated (identical to functional) ---
    R = p.edge.w_in.shape[-1]
    a_j = mm(h2d, p.edge.w_in[:F]).reshape(B, N, R)
    a_i = mm(h2d, p.edge.w_in[F:]).reshape(B, N, R)
    pre = a_j[:, None, :, :] + a_i[:, :, None, :] + p.edge.b_in
    rbf = jnp.exp(
        -p.edge.rbf_betas * (jnp.exp(-r) - p.edge.rbf_means) ** 2
    )
    filtered = rbf * pre
    o_j = mm(h2d, p.edge.w_out0[:F]).reshape(B, N, H)
    o_i = mm(h2d, p.edge.w_out0[F : 2 * F]).reshape(B, N, H)
    o_f = mm(filtered.reshape(B * N * N, R), p.edge.w_out0[2 * F : 2 * F + R])
    e0 = (
        o_j[:, None, :, :]
        + o_i[:, :, None, :]
        + o_f.reshape(B, N, N, H)
        + r * p.edge.w_out0[2 * F + R]
        + p.edge.b_out0
    )
    h_e = mm(_silu(e0).reshape(B * N * N, H), p.edge.w_out1).reshape(
        B, N, N, H
    ) + p.edge.b_out1

    logits = _celu2(
        mm(h_e.reshape(B * N * N, H), p.w_sem).reshape(B, N, N, K) + p.b_sem
    )
    eye = jnp.eye(N, dtype=logits.dtype)
    logits = logits - INF * eye[None, :, :, None]
    if mask4 is not None:
        logits = logits - INF * (1.0 - mask4)
    att = jax.nn.softmax(logits, axis=-2)
    if mask4 is not None:
        att = att * mask4
        denom = att.sum(axis=-2, keepdims=True)
        att = att / jnp.where(denom == 0.0, 1.0, denom)

    # --- attended edges: node aggregation replicated, C slice sharded ---
    w_xmix_hk = p.w_xmix.reshape(H, K, C)
    w_nagg_hk = p.w_node0[F : F + H * K].reshape(H, K, -1)
    he2d = h_e.reshape(B * N * N, H)
    coeff_pre = jnp.zeros((B, N, N, c_loc), jnp.float32)
    agg_node = jnp.zeros((B * N, p.w_node0.shape[-1]), jnp.float32)
    for k in range(K):
        att_k = att[..., k : k + 1]
        wx_k = _slice_c(w_xmix_hk[:, k, :], c0, c_loc, 1)  # (H, c_loc)
        coeff_pre = coeff_pre + att_k * mm(he2d, wx_k).reshape(
            B, N, N, c_loc
        )
        a_k = (h_e * att_k).sum(axis=-2)
        agg_node = agg_node + mm(a_k.reshape(B * N, H), w_nagg_hk[:, k, :])
    coeff = jnp.tanh(coeff_pre)  # (B, N, N, c_loc)
    if mask4 is not None:
        coeff = coeff * mask4

    # --- pooled spatial chains on the C slice ---------------------------
    inv_r = 1.0 / (r + 1e-5)
    pooled = [
        (coeff * (d_planes[k] * inv_r)).sum(axis=-2) for k in range(3)
    ]  # 3 x (B, N, c_loc)
    if mask4 is not None:
        count = mask4.sum(axis=-2)
        norm_pool = [pk / (count + 1e-8) for pk in pooled]
        dv_denom = count + 1e-10
    else:
        norm_pool = [pk / float(N) for pk in pooled]
        dv_denom = float(N)
    pool_sq = norm_pool[0] ** 2 + norm_pool[1] ** 2 + norm_pool[2] ** 2

    # row-split consumers -> partial products -> psum (the 2 collectives)
    w_post0_loc = _slice_c(p.w_post0, c0, c_loc, 0)  # (c_loc, H)
    ps0_part = mm(pool_sq.reshape(B * N, c_loc), w_post0_loc)
    w_vmix_loc = _slice_c(p.w_vmix, c0, c_loc, 0)  # (c_loc, 1)
    delta_part = jnp.concatenate(
        [
            mm(pk.reshape(B * N, c_loc), w_vmix_loc).reshape(B, N, 1)
            for pk in pooled
        ],
        axis=-1,
    )  # (B, N, 3)
    ps0_full, delta_full = jax.lax.psum((ps0_part, delta_part), axis)

    h_comb = _silu(
        mm(_silu(ps0_full + p.b_post0), p.w_post1) + p.b_post1
    )
    node_pre = (
        mm(h2d, p.w_node0[:F])
        + agg_node
        + mm(h_comb, p.w_node0[F + H * K :])
        + p.b_node0
    )
    upd = mm(_silu(node_pre), p.w_node1) + p.b_node1
    h_out = h + _silu(upd).reshape(B, N, F)

    if not update:
        return h_out, x_planes, v_planes

    delta_planes = [
        delta_full[..., k : k + 1] / dv_denom for k in range(3)
    ]
    if v_planes is not None:
        gate = 2.0 * jax.nn.sigmoid(
            mm(
                _silu(mm(h_out.reshape(B * N, F), p.w_vel0) + p.b_vel0),
                p.w_vel1,
            )
        ).reshape(B, N, 1)
        v_new = [gate * vk + dk for vk, dk in zip(v_planes, delta_planes)]
    else:
        v_new = delta_planes
    x_new = [xk + vk for xk, vk in zip(x_planes, v_new)]
    return h_out, x_new, v_new


def tp_model_forward(
    p: ModelParams,
    h: jax.Array,  # (B, N, F_in)
    x: jax.Array,  # (B, N, 3)
    mesh: Mesh,
    *,
    axis: str = "model",
    n_heads: int = 4,
    update: Sequence[bool] | bool = True,
    mask: Optional[jax.Array] = None,
    matmul_dtype=None,
):
    """Full model forward with coefficient-axis TP: ``(out, x_out)``
    replicated. Composes with a ``data`` axis (shard the batch outside)."""
    depth = len(p.layers)
    updates = [update] * depth if isinstance(update, bool) else list(update)
    n_shards = mesh.shape[axis]

    def local_fn(h_, x_, mask_):
        mm = _make_mm(matmul_dtype)
        hc = _embed(p, h_, mm)
        xp = [x_[..., k : k + 1] for k in range(3)]
        vp = None
        for lp, upd in zip(p.layers, updates):
            hc, xp, vp = tp_layer_forward(
                lp, hc, xp, vp,
                n_heads=n_heads, update=upd, axis=axis, n_shards=n_shards,
                mask=mask_, matmul_dtype=matmul_dtype,
            )
        out = _readout(p, hc, mm)
        return out, jnp.concatenate(xp, axis=-1)

    if mask is None:
        fn = shard_map(
            lambda h_, x_: local_fn(h_, x_, None),
            mesh=mesh,
            in_specs=(P(), P()),
            out_specs=(P(), P()),
            check_vma=False,
        )
        return fn(h, x)
    fn = shard_map(
        local_fn,
        mesh=mesh,
        in_specs=(P(), P(), P()),
        out_specs=(P(), P()),
        check_vma=False,
    )
    return fn(h, x, mask)
