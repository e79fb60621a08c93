"""Functional (pytree-parameterized) SAKE model.

A pure-function form of ``sake_tpu.layers.DenseSAKELayer`` /
``models.SAKEModel``: parameters are the ``ModelParams`` pytree
(``init_model_params``, or ``adapter.model_params_from_linen`` for linen
trees), so the model runs with nothing but JAX. It is the dense E+F path
of the md17/iso17 tasks and the model that ``sparse``, ``bigsys`` and
``parallel`` build on. Numerics match the linen path (fp32 reassociation
only; the same EPSILON/masking constants).

Reformulations of the reference math (same results):

- **Node-level factorization of edge matmuls.** Every edge Dense whose
  input is the ``[h_j, h_i]`` broadcast-concat splits into two *node*-level
  matmuls broadcast-added over the pair grid:
  ``concat(h_j, h_i) @ W = (h @ W_top)_j + (h @ W_bot)_i`` — an N-fold
  FLOP cut on the widest matmuls vs the reference's per-edge form
  (``sake/layers.py:30``).
- **Coordinate planes.** Positions, velocities and forces are threaded as
  three ``(B, N, 1)`` component planes, so every geometric quantity is a
  broadcast of per-component edge grids ``(B, N, N, 1)``.
- **Per-head splitting.** The attended edge tensor ``h_e (x) att`` of
  width H*K is never formed; its consumers (x_mixing, aggregation, node
  MLP) are sums of K per-head matmuls against weight slices.
- **Pooled spatial attention**: the (N, N, C, 3) combination field of the
  reference (``sake/layers.py:118``) is never built.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence

import jax
import jax.numpy as jnp

EPSILON = 1e-5
INF = 1e5


class CFConvParams(NamedTuple):
    """ContinuousFilterConv: mlp_in, RBF (means/betas), mlp_out (2 Dense)."""

    w_in: jax.Array  # (2F [+he], R)
    b_in: jax.Array  # (R,)
    rbf_means: jax.Array  # (R,)
    rbf_betas: jax.Array  # (R,)
    w_out0: jax.Array  # (2F + R + 1, H)
    b_out0: jax.Array  # (H,)
    w_out1: jax.Array  # (H, H)
    b_out1: jax.Array  # (H,)


class LayerParams(NamedTuple):
    edge: CFConvParams
    w_sem: jax.Array  # (H, K) semantic attention
    b_sem: jax.Array  # (K,)
    w_xmix: jax.Array  # (H*K, C) no bias (hidden-major, head-minor rows)
    w_post0: jax.Array  # (C, H)
    b_post0: jax.Array
    w_post1: jax.Array  # (H, H)
    b_post1: jax.Array
    w_node0: jax.Array  # (F + H*K + H, H)
    b_node0: jax.Array
    w_node1: jax.Array  # (H, F)
    b_node1: jax.Array
    # update head (zeros-shaped placeholders when update=False)
    w_vmix: jax.Array  # (C, 1)
    w_vel0: jax.Array  # (F, H)
    b_vel0: jax.Array
    w_vel1: jax.Array  # (H, 1)


class ModelParams(NamedTuple):
    w_embed: jax.Array  # (F_in, H)
    b_embed: jax.Array
    layers: tuple  # tuple[LayerParams, ...]
    w_out0: jax.Array  # (H, H)
    b_out0: jax.Array
    w_out1: jax.Array  # (H, out)
    b_out1: jax.Array


NUM_RBF = 50  # ContinuousFilterConv.kernel_features (blocks.py)


def _per_layer(update, depth: int) -> list:
    return [update] * depth if isinstance(update, bool) else list(update)


def init_model_params(
    key: jax.Array,
    in_features: int,
    *,
    hidden_features: int,
    depth: int,
    n_heads: int,
    update: Sequence[bool] | bool = True,
) -> ModelParams:
    """Fresh ``ModelParams`` for a SAKE energy model (one output per atom).

    The tree and shapes equal ``model_params_from_linen(SAKEModel(
    hidden_features, out_features=1, depth, n_heads=n_heads,
    update=update).init(key, h, x, v))`` (initialized with a velocity, so
    every update layer has its velocity head) and the initial
    distributions are linen's:
    lecun-normal Dense kernels, zero biases, and the PhysNet RBF means and
    betas of ``radial.ExpNormalSmearing``. Layers without an update head
    carry zero-valued placeholders, as the adapter gives them. The values
    differ from a linen init with the same key (linen derives one key per
    module path).
    """
    F, H, K, R = hidden_features, hidden_features, n_heads, NUM_RBF
    C = K * H
    lecun = jax.nn.initializers.lecun_normal()
    keys = iter(jax.random.split(key, 3 + 12 * depth))

    def dense(fan_in, fan_out):
        return lecun(next(keys), (fan_in, fan_out), jnp.float32)

    def zeros(*shape):
        return jnp.zeros(shape, jnp.float32)

    start = math.exp(-5.0)  # cutoff (0, 5): exp(-(upper - lower))
    beta = (2.0 / R * (1.0 - start)) ** -2

    w_embed = dense(in_features, H)
    layers = []
    for upd in _per_layer(update, depth):
        # every leaf its own buffer: a donated state may not alias
        edge = CFConvParams(
            w_in=dense(2 * F, R), b_in=zeros(R),
            rbf_means=jnp.linspace(start, 1.0, R, dtype=jnp.float32),
            rbf_betas=jnp.full((R,), beta, jnp.float32),
            w_out0=dense(2 * F + R + 1, H), b_out0=zeros(H),
            w_out1=dense(H, H), b_out1=zeros(H),
        )
        lp = LayerParams(
            edge=edge,
            w_sem=dense(H, K), b_sem=zeros(K),
            w_xmix=dense(H * K, C),
            w_post0=dense(C, H), b_post0=zeros(H),
            w_post1=dense(H, H), b_post1=zeros(H),
            w_node0=dense(F + H * K + H, H), b_node0=zeros(H),
            w_node1=dense(H, F), b_node1=zeros(F),
            w_vmix=dense(C, 1), w_vel0=dense(F, H), b_vel0=zeros(H),
            w_vel1=dense(H, 1),
        )
        if not upd:
            lp = lp._replace(
                w_vmix=zeros(C, 1), w_vel0=zeros(F, H), w_vel1=zeros(H, 1)
            )
        layers.append(lp)
    return ModelParams(
        w_embed=w_embed, b_embed=zeros(H), layers=tuple(layers),
        w_out0=dense(H, H), b_out0=zeros(H),
        w_out1=dense(H, 1), b_out1=zeros(1),
    )


def _silu(x):
    return x * jax.nn.sigmoid(x)


def _celu2(x):
    """celu with alpha=2 (reference: ``sake/layers.py:82``), written with
    ``exp``; ``expm1``'s extra precision near 0 is below fp32 noise for
    these logits."""
    return jnp.where(x > 0, x, 2.0 * (jnp.exp(x / 2.0) - 1.0))


def _make_mm(matmul_dtype):
    def mm(a, w):
        if matmul_dtype is not None:
            a = a.astype(matmul_dtype)
            w = w.astype(matmul_dtype)
        return jnp.dot(a, w, preferred_element_type=jnp.float32)

    return mm


def pairwise_geometry_planes(x_planes):
    """``x_planes``: 3 arrays ``(B, N, 1)`` -> (d_planes 3x(B,N,N,1),
    r (B,N,N,1)) with ``d_k[b,i,j] = x_k[b,j] - x_k[b,i]`` and the
    EPSILON-regularized distance (reference ``sake/functional.py:10-19``).
    """
    d = [p[:, None, :, :] - p[:, :, None, :] for p in x_planes]
    r2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
    r = jnp.sqrt(jax.nn.relu(r2) + EPSILON)
    return d, r


def layer_forward_planes(
    p: LayerParams,
    h: jax.Array,  # (B, N, F)
    x_planes,  # 3 x (B, N, 1)
    v_planes,  # 3 x (B, N, 1) or None
    *,
    n_heads: int,
    update: bool,
    mask: Optional[jax.Array] = None,  # (B, N, N) edge mask
    matmul_dtype=None,
):
    """One dense SAKE layer on coordinate planes, keepdims style
    (behavior: ``sake/layers.py:188-235``)."""
    B, N, F = h.shape
    H = p.edge.w_out0.shape[-1]
    K = n_heads
    mm = _make_mm(matmul_dtype)
    h2d = h.reshape(B * N, F)
    mask4 = mask[..., None] if mask is not None else None  # (B, N, N, 1)

    d_planes, r = pairwise_geometry_planes(x_planes)

    # --- edge model (CFConv), node-factorized ---------------------------
    R = p.edge.w_in.shape[-1]
    a_j = mm(h2d, p.edge.w_in[:F]).reshape(B, N, R)
    a_i = mm(h2d, p.edge.w_in[F:]).reshape(B, N, R)
    pre = a_j[:, None, :, :] + a_i[:, :, None, :] + p.edge.b_in  # (B,N,N,R)
    # RBF filter on distances (reference: sake/utils.py:28-65; alpha=1 for
    # the fixed (0,5) cutoff bounds)
    rbf = jnp.exp(
        -p.edge.rbf_betas * (jnp.exp(-r) - p.edge.rbf_means) ** 2
    )
    filtered = rbf * pre  # (B, N, N, R)
    o_j = mm(h2d, p.edge.w_out0[:F]).reshape(B, N, H)
    o_i = mm(h2d, p.edge.w_out0[F : 2 * F]).reshape(B, N, H)
    o_f = mm(filtered.reshape(B * N * N, R), p.edge.w_out0[2 * F : 2 * F + R])
    o_r = r * p.edge.w_out0[2 * F + R]
    e0 = (
        o_j[:, None, :, :]
        + o_i[:, :, None, :]
        + o_f.reshape(B, N, N, H)
        + o_r
        + p.edge.b_out0
    )
    h_e = mm(_silu(e0).reshape(B * N * N, H), p.edge.w_out1).reshape(
        B, N, N, H
    ) + p.edge.b_out1  # (B, N, N, H) edge features

    # --- semantic attention (softmax over senders j) --------------------
    logits = _celu2(
        mm(h_e.reshape(B * N * N, H), p.w_sem).reshape(B, N, N, K) + p.b_sem
    )
    eye = jnp.eye(N, dtype=logits.dtype)
    logits = logits - INF * eye[None, :, :, None]
    if mask4 is not None:
        logits = logits - INF * (1.0 - mask4)
    att = jax.nn.softmax(logits, axis=-2)  # (B, N, N, K)
    if mask4 is not None:
        att = att * mask4
        denom = att.sum(axis=-2, keepdims=True)
        att = att / jnp.where(denom == 0.0, 1.0, denom)
    # (unmasked: softmax already sums to 1 over j — renormalization no-op)

    # --- per-head attended edges: never flattened to width H*K ----------
    # weight rows are hidden-major/head-minor: row(h, k) = h*K + k
    C = p.w_xmix.shape[-1]
    w_xmix_hk = p.w_xmix.reshape(H, K, C)
    w_nagg_hk = p.w_node0[F : F + H * K].reshape(H, K, -1)
    coeff_pre = jnp.zeros((B, N, N, C), jnp.float32)
    agg_node = jnp.zeros((B * N, p.w_node0.shape[-1]), jnp.float32)
    he2d = h_e.reshape(B * N * N, H)
    for k in range(K):
        att_k = att[..., k : k + 1]  # (B, N, N, 1) static lane slice
        # x_mixing head-slice on raw edges, scaled by attention
        coeff_pre = coeff_pre + att_k * mm(
            he2d, w_xmix_hk[:, k, :]
        ).reshape(B, N, N, C)
        # aggregated (sum_j) attended edges, pre-multiplied into node MLP:
        # sum_j (h_e * att_k) @ Wn_k  ==  (sum_j h_e * att_k) @ Wn_k
        a_k = (h_e * att_k).sum(axis=-2)  # (B, N, H)
        agg_node = agg_node + mm(a_k.reshape(B * N, H), w_nagg_hk[:, k, :])
    coeff = jnp.tanh(coeff_pre)
    if mask4 is not None:
        coeff = coeff * mask4

    # --- spatial attention, pooled (no (N,N,C,3) tensor) ----------------
    inv_r = 1.0 / (r + 1e-5)
    pooled_planes = [
        (coeff * (d_planes[k] * inv_r)).sum(axis=-2) for k in range(3)
    ]  # 3 x (B, N, C)
    if mask4 is not None:
        count = mask4.sum(axis=-2)  # (B, N, 1)
        norm_pool = [pk / (count + 1e-8) for pk in pooled_planes]
    else:
        norm_pool = [pk / float(N) for pk in pooled_planes]
    pool_sq = norm_pool[0] ** 2 + norm_pool[1] ** 2 + norm_pool[2] ** 2
    h_comb = _silu(
        mm(
            _silu(mm(pool_sq.reshape(B * N, C), p.w_post0) + p.b_post0),
            p.w_post1,
        )
        + p.b_post1
    )  # (B*N, H)

    # --- node update: concat-free first Dense ----------------------------
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

    # --- velocity/position update ----------------------------------------
    if mask4 is not None:
        dv_denom = mask4.sum(axis=-2) + 1e-10  # (B, N, 1)
    else:
        dv_denom = float(N)
    delta_planes = [
        mm(pk.reshape(B * N, C), p.w_vmix).reshape(B, N, 1) / dv_denom
        for pk in pooled_planes
    ]
    if v_planes is not None:
        gate = 2.0 * jax.nn.sigmoid(
            mm(_silu(mm(h_out.reshape(B * N, F), p.w_vel0) + p.b_vel0), p.w_vel1)
        ).reshape(B, N, 1)
        v_new = [gate * vk + dk for vk, dk in zip(v_planes, delta_planes)]
    else:
        v_new = delta_planes
    x_new = [xk + vk for xk, vk in zip(x_planes, v_new)]
    return h_out, x_new, v_new


def _embed(p, h, mm):
    B, N, _ = h.shape
    return (mm(h.reshape(B * N, -1), p.w_embed) + p.b_embed).reshape(
        B, N, p.w_embed.shape[-1]
    )


def _readout(p, h, mm):
    B, N, _ = h.shape
    out = mm(
        _silu(mm(h.reshape(B * N, -1), p.w_out0) + p.b_out0), p.w_out1
    ) + p.b_out1
    return out.reshape(B, N, -1)


def model_forward_planes(
    p: ModelParams,
    h: jax.Array,
    x_planes,
    v_planes=None,
    *,
    n_heads: int = 4,
    update: Sequence[bool] | bool = True,
    mask: Optional[jax.Array] = None,
    matmul_dtype=None,
):
    depth = len(p.layers)
    updates = _per_layer(update, depth)
    mm = _make_mm(matmul_dtype)
    h = _embed(p, h, mm)
    for lp, upd in zip(p.layers, updates):
        h, x_planes, v_planes = layer_forward_planes(
            lp, h, x_planes, v_planes,
            n_heads=n_heads, update=upd, mask=mask, matmul_dtype=matmul_dtype,
        )
    return _readout(p, h, mm), x_planes, v_planes


def model_forward(
    p: ModelParams,
    h: jax.Array,  # (B, N, F_in)
    x: jax.Array,  # (B, N, 3)
    v: Optional[jax.Array] = None,
    *,
    n_heads: int = 4,
    update: Sequence[bool] | bool = True,
    mask: Optional[jax.Array] = None,
    matmul_dtype=None,
):
    """(B, N, 3) API wrapper over the plane implementation."""
    x_planes = [x[..., k : k + 1] for k in range(3)]
    v_planes = [v[..., k : k + 1] for k in range(3)] if v is not None else None
    out, xp, vp = model_forward_planes(
        p, h, x_planes, v_planes,
        n_heads=n_heads, update=update, mask=mask, matmul_dtype=matmul_dtype,
    )
    x_out = jnp.concatenate(xp, axis=-1)
    v_out = jnp.concatenate(vp, axis=-1) if vp is not None else None
    return out, x_out, v_out


def energy_and_forces_fn(
    p: ModelParams,
    h: jax.Array,
    x: jax.Array,  # (B, N, 3)
    *,
    n_heads: int = 4,
    update: Sequence[bool] | bool = True,
    mask: Optional[jax.Array] = None,
    matmul_dtype=None,
):
    """Energies ``e (B,)`` (the sum of the per-atom outputs) and forces
    ``f = -dE/dx (B, N, 3)`` from one forward and one backward pass. Each
    molecule's forces depend only on its own positions, so the gradient
    of the batch-summed energy gives every molecule's forces at once.
    Differentiable in ``p`` (second order, for force-loss training)."""

    def e_sum(x_):
        out, _, _ = model_forward(
            p, h, x_, n_heads=n_heads, update=update, mask=mask,
            matmul_dtype=matmul_dtype,
        )
        e = out.sum(axis=(-2, -1))
        return e.sum(), e

    (_, e), neg_f = jax.value_and_grad(e_sum, has_aux=True)(x)
    return e, -neg_f
