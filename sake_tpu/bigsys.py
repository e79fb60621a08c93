"""Large-system execution: blocked pairwise evaluation and atom sharding.

The reference's systems are tiny (N <= ~30) so its dense O(N^2) tensors are
free; at OC20-and-beyond scale they are not. This module is the molecular
analog of long-context attention engineering (SURVEY §5.7):

- ``blocked_layer_forward`` — evaluate a dense SAKE layer by scanning the
  sender (j) axis in blocks with an online-softmax accumulation, so peak
  memory is O(N * block) instead of O(N^2): blockwise attention applied to
  geometric messages. Numerically equal to the dense layer (same masking
  and normalization; fp32 reassociation only).
- ``atom_sharded_forward`` — shard receivers across a mesh axis inside
  ``shard_map``; each device all-gathers the (small) sender node states
  per layer and computes only its receiver rows, blocked. The backward of
  ``all_gather`` is the matching reduce-scatter, so forces via ``jax.grad``
  work end-to-end — the all-gather formulation of ring attention (a
  ``ppermute`` ring is the bandwidth-optimal refinement when gathered
  senders no longer fit).

Built on the functional model (pytree params, coordinate-plane geometry);
convert linen params with ``kernels.model_params_from_linen``.
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
    LayerParams,
    ModelParams,
    _celu2,
    _embed,
    _make_mm,
    _readout,
    _silu,
)
from sake_tpu.sparse import _min_image


def _slice_j(a, j0, jn, axis=1):
    return jax.lax.dynamic_slice_in_dim(a, j0, jn, axis=axis)


def _edge_block_vs(
    p, mm, *, a_i, o_i, x_recv, i_ids, a_jb, o_jb, x_jb, j_ids, n_heads
):
    """Edge features + self-masked semantic logits between the local
    receivers and ONE sender block (however that block arrived — a dynamic
    slice of a gathered array, or a ring-visiting shard).

    ``a_i/o_i (B, Ni, R/H)``, receiver planes ``x_recv 3x(B, Ni, 1)``;
    block halves ``a_jb/o_jb (B, bs, R/H)``, planes ``x_jb``; ``i_ids``/
    ``j_ids`` are global atom indices for self-pair masking.
    Returns ``(h_e, logits, d_planes, r)`` with block shapes
    ``(B, Ni, bs, ...)``.
    """
    B, Ni = a_i.shape[:2]
    bs = a_jb.shape[1]
    R = a_i.shape[-1]
    H = o_i.shape[-1]
    F2 = p.edge.w_out0.shape[0] - R - 1  # 2F rows precede the filter rows
    d = [pj[:, None, :, :] - pi[:, :, None, :] for pi, pj in zip(x_recv, x_jb)]
    r2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
    r = jnp.sqrt(jax.nn.relu(r2) + EPSILON)  # (B, Ni, bs, 1)
    pre = a_jb[:, None] + a_i[:, :, None] + p.edge.b_in
    rbf = jnp.exp(-p.edge.rbf_betas * (jnp.exp(-r) - p.edge.rbf_means) ** 2)
    filtered = rbf * pre
    o_f = mm(filtered.reshape(-1, R), p.edge.w_out0[F2 : F2 + R])
    e0 = (
        o_jb[:, None]
        + o_i[:, :, None]
        + o_f.reshape(B, Ni, bs, H)
        + r * p.edge.w_out0[F2 + R]
        + p.edge.b_out0
    )
    h_e = mm(_silu(e0).reshape(-1, H), p.edge.w_out1).reshape(
        B, Ni, bs, H
    ) + p.edge.b_out1
    logits = _celu2(
        mm(h_e.reshape(-1, H), p.w_sem).reshape(B, Ni, bs, n_heads) + p.b_sem
    )
    self_pair = (i_ids[:, None] == j_ids[None, :]).astype(logits.dtype)
    logits = logits - INF * self_pair[None, :, :, None]
    return h_e, logits, d, r


def _pass2_accumulate(p, mm, carry, *, h_e, att, d, r, n_heads, em=None):
    """Accumulate attention-weighted aggregates for one sender block into
    ``carry = (agg_node, pooled (3, B, Ni, C))`` (the linear-in-field
    consumers of the dense layer; see ``layers.DenseSAKELayer``).
    ``em``: optional (B, Ni, bs, 1) edge mask — zeroes the spatial
    coefficients of masked pairs (the dense layer's ``coeff * mask``)."""
    agg_node, pooled = carry
    B, Ni, bs, H = h_e.shape
    K = n_heads
    C = p.w_xmix.shape[-1]
    F = p.w_node0.shape[0] - H * K - H
    w_xmix_hk = p.w_xmix.reshape(H, K, C)
    w_nagg_hk = p.w_node0[F : F + H * K].reshape(H, K, -1)
    coeff_pre = jnp.zeros((B, Ni, bs, C))
    he2d = h_e.reshape(-1, H)
    for k in range(K):
        att_k = att[..., k : k + 1]
        coeff_pre = coeff_pre + att_k * mm(he2d, w_xmix_hk[:, k, :]).reshape(
            B, Ni, bs, C
        )
        a_k = (h_e * att_k).sum(axis=2)
        agg_node = agg_node + mm(a_k.reshape(B * Ni, H), w_nagg_hk[:, k, :])
    coeff = jnp.tanh(coeff_pre)
    if em is not None:
        coeff = coeff * em
    inv_r = 1.0 / (r + 1e-5)
    pooled = pooled + jnp.stack(
        [(coeff * (d[k2] * inv_r)).sum(axis=2) for k2 in range(3)]
    )
    return agg_node, pooled


def blocked_layer_forward(
    p: LayerParams,
    h_send: jax.Array,  # (B, Nj, F) ALL sender node features
    x_send,  # 3 x (B, Nj, 1) ALL sender position planes
    v_recv,  # 3 x (B, Ni, 1) receiver velocities or None
    *,
    n_heads: int,
    update: bool,
    block_size: int,
    receiver_offset=0,  # receivers are h_send[:, off : off + Ni]
    n_receivers: Optional[int] = None,
    mask: Optional[jax.Array] = None,  # (B, Ni, Nj)
    matmul_dtype=None,
    remat: bool = False,
    box=None,  # (3,) periodic box: minimum-image displacements
):
    """One dense SAKE layer over receivers [off, off+Ni) with the sender
    axis scanned in ``block_size`` chunks (online softmax, two passes).

    ``remat=True`` checkpoints the per-block scan bodies: the backward
    (forces / training gradients) re-derives each sender block's edge
    tensors instead of saving them, bounding autodiff memory to
    O(N·block) like the forward — without it ``jax.grad`` through the
    block scans saves every block's (B, Ni, bs, H) intermediates, i.e.
    the full O(N²·H) the blocked formulation exists to avoid.

    Returns local ``(h_recv_out, x_recv_out_planes, v_recv_out_planes)``.
    """
    B, Nj, F = h_send.shape
    Ni = n_receivers if n_receivers is not None else Nj
    K = n_heads
    H = p.edge.w_out0.shape[-1]
    C = p.w_xmix.shape[-1]
    R = p.edge.w_in.shape[-1]
    mm = _make_mm(matmul_dtype)
    assert Nj % block_size == 0, "sender count must divide block_size"
    n_blocks = Nj // block_size

    # node-level matmul halves over all senders / local receivers
    h2d = h_send.reshape(B * Nj, F)
    a_j = mm(h2d, p.edge.w_in[:F]).reshape(B, Nj, R)
    o_j = mm(h2d, p.edge.w_out0[:F]).reshape(B, Nj, H)
    h_recv = _slice_j(h_send, receiver_offset, Ni)
    x_recv = [_slice_j(pk, receiver_offset, Ni) for pk in x_send]
    hr2d = h_recv.reshape(B * Ni, F)
    a_i = mm(hr2d, p.edge.w_in[F:]).reshape(B, Ni, R)
    o_i = mm(hr2d, p.edge.w_out0[F : 2 * F]).reshape(B, Ni, H)

    i_ids = receiver_offset + jnp.arange(Ni)

    def edge_block(j0):
        """(h_e, masked logits, d planes, r) for sender block [j0, j0+bs)."""
        xj = [_slice_j(pk, j0, block_size) for pk in x_send]
        d = [pj[:, None, :, :] - pi[:, :, None, :] for pi, pj in zip(x_recv, xj)]
        if box is not None:
            d = [_min_image(dk, box[k]) for k, dk in enumerate(d)]
        r2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
        r = jnp.sqrt(jax.nn.relu(r2) + EPSILON)  # (B, Ni, bs, 1)
        pre = (
            _slice_j(a_j, j0, block_size)[:, None]
            + a_i[:, :, None]
            + p.edge.b_in
        )
        rbf = jnp.exp(-p.edge.rbf_betas * (jnp.exp(-r) - p.edge.rbf_means) ** 2)
        filtered = rbf * pre
        o_f = mm(filtered.reshape(-1, R), p.edge.w_out0[2 * F : 2 * F + R])
        e0 = (
            _slice_j(o_j, j0, block_size)[:, None]
            + o_i[:, :, None]
            + o_f.reshape(B, Ni, block_size, H)
            + r * p.edge.w_out0[2 * F + R]
            + p.edge.b_out0
        )
        h_e = mm(_silu(e0).reshape(-1, H), p.edge.w_out1).reshape(
            B, Ni, block_size, H
        ) + p.edge.b_out1
        logits = _celu2(
            mm(h_e.reshape(-1, H), p.w_sem).reshape(B, Ni, block_size, K)
            + p.b_sem
        )
        j_ids = j0 + jnp.arange(block_size)
        self_pair = (i_ids[:, None] == j_ids[None, :]).astype(logits.dtype)
        logits = logits - INF * self_pair[None, :, :, None]
        if mask is not None:
            mblk = _slice_j(mask, j0, block_size, axis=2)
            logits = logits - INF * (1.0 - mblk[..., None])
        return h_e, logits, d, r

    # ---- pass 1: online softmax statistics ------------------------------
    def pass1(carry, b):
        m, z = carry
        _, logits, _, _ = edge_block(b * block_size)
        m_new = jnp.maximum(m, logits.max(axis=2))
        z = z * jnp.exp(m - m_new) + jnp.exp(logits - m_new[:, :, None, :]).sum(
            axis=2
        )
        return (m_new, z), None

    m0 = jnp.full((B, Ni, K), -jnp.inf)
    z0 = jnp.zeros((B, Ni, K))
    p1 = jax.checkpoint(pass1, prevent_cse=False) if remat else pass1
    (m, z), _ = jax.lax.scan(p1, (m0, z0), jnp.arange(n_blocks))

    # ---- pass 2: attention-weighted accumulation ------------------------
    w_xmix_hk = p.w_xmix.reshape(H, K, C)
    w_nagg_hk = p.w_node0[F : F + H * K].reshape(H, K, -1)

    def pass2(carry, b):
        agg_node, pooled, att_count = carry
        j0 = b * block_size
        h_e, logits, d, r = edge_block(j0)
        att = jnp.exp(logits - m[:, :, None, :]) / z[:, :, None, :]
        # masked pairs have logit -INF -> att 0; att sums to 1 over real
        # senders, matching the dense path's mask-renormalized attention.
        # A receiver with no real sender has all logits at -INF, so the
        # softmax is uniform there: the mask zeroes it, as the dense path
        # does.
        if mask is not None:
            mblk = _slice_j(mask, j0, block_size, axis=2)
            att = att * mblk[..., None]
            att_count = att_count + mblk.sum(axis=2)[..., None]
        coeff_pre = jnp.zeros((B, Ni, block_size, C))
        he2d = h_e.reshape(-1, H)
        for k in range(K):
            att_k = att[..., k : k + 1]
            coeff_pre = coeff_pre + att_k * mm(he2d, w_xmix_hk[:, k, :]).reshape(
                B, Ni, block_size, C
            )
            a_k = (h_e * att_k).sum(axis=2)
            agg_node = agg_node + mm(a_k.reshape(B * Ni, H), w_nagg_hk[:, k, :])
        coeff = jnp.tanh(coeff_pre)
        if mask is not None:
            mblk = _slice_j(mask, j0, block_size, axis=2)
            coeff = coeff * mblk[..., None]
        inv_r = 1.0 / (r + 1e-5)
        pooled = pooled + jnp.stack(
            [(coeff * (d[k2] * inv_r)).sum(axis=2) for k2 in range(3)]
        )
        return (agg_node, pooled, att_count), None

    agg0 = jnp.zeros((B * Ni, p.w_node0.shape[-1]))
    pooled0 = jnp.zeros((3, B, Ni, C))
    cnt0 = jnp.zeros((B, Ni, 1))
    p2 = jax.checkpoint(pass2, prevent_cse=False) if remat else pass2
    (agg_node, pooled, att_count), _ = jax.lax.scan(
        p2, (agg0, pooled0, cnt0), jnp.arange(n_blocks)
    )

    count = att_count + 1e-8 if mask is not None else float(Nj)
    norm_pool = [pooled[k] / count for k in range(3)]
    pool_sq = norm_pool[0] ** 2 + norm_pool[1] ** 2 + norm_pool[2] ** 2
    h_comb = _silu(
        mm(_silu(mm(pool_sq.reshape(B * Ni, C), p.w_post0) + p.b_post0), p.w_post1)
        + p.b_post1
    )
    node_pre = (
        mm(hr2d, p.w_node0[:F])
        + agg_node
        + mm(h_comb, p.w_node0[F + H * K :])
        + p.b_node0
    )
    upd_val = mm(_silu(node_pre), p.w_node1) + p.b_node1
    h_out = h_recv + _silu(upd_val).reshape(B, Ni, F)

    if not update:
        return h_out, x_recv, v_recv

    dv_denom = att_count + 1e-10 if mask is not None else float(Nj)
    delta_planes = [
        mm(pooled[k].reshape(B * Ni, C), p.w_vmix).reshape(B, Ni, 1) / dv_denom
        for k in range(3)
    ]
    if v_recv is not None:
        gate = 2.0 * jax.nn.sigmoid(
            mm(_silu(mm(h_out.reshape(B * Ni, F), p.w_vel0) + p.b_vel0), p.w_vel1)
        ).reshape(B, Ni, 1)
        v_new = [gate * vk + dk for vk, dk in zip(v_recv, delta_planes)]
    else:
        v_new = delta_planes
    x_new = [xk + vk for xk, vk in zip(x_recv, v_new)]
    return h_out, x_new, v_new


def blocked_model_forward(
    p: ModelParams,
    h: jax.Array,
    x: jax.Array,  # (B, N, 3)
    v=None,
    *,
    n_heads: int = 4,
    update: Sequence[bool] | bool = True,
    block_size: int = 128,
    mask: Optional[jax.Array] = None,
    matmul_dtype=None,
    remat: bool = False,
    box=None,  # (3,) periodic box: minimum-image displacements
):
    """Full model with blocked layers (single device, O(N*block) memory).

    ``remat=True`` makes that bound hold for ``jax.grad`` (forces /
    training) too — see ``blocked_layer_forward``. With ``box`` and the
    densified neighbor mask it is the dense reference for the periodic
    cutoff-sparse path."""
    depth = len(p.layers)
    updates = [update] * depth if isinstance(update, bool) else list(update)
    mm = _make_mm(matmul_dtype)
    xp = [x[..., k : k + 1] for k in range(3)]
    vp = [v[..., k : k + 1] for k in range(3)] if v is not None else None
    hc = _embed(p, h, mm)
    for lp, upd in zip(p.layers, updates):
        hc, xp, vp = blocked_layer_forward(
            lp, hc, xp, vp,
            n_heads=n_heads, update=upd, block_size=block_size, mask=mask,
            matmul_dtype=matmul_dtype, remat=remat, box=box,
        )
    out = _readout(p, hc, mm)
    x_out = jnp.concatenate(xp, axis=-1)
    v_out = jnp.concatenate(vp, axis=-1) if vp is not None else None
    return out, x_out, v_out


def atom_sharded_forward(
    p: ModelParams,
    h: jax.Array,  # (B, N, F_in); N divisible by the mesh axis size
    x: jax.Array,  # (B, N, 3)
    mesh: Mesh,
    *,
    axis: str = "data",
    n_heads: int = 4,
    update: Sequence[bool] | bool = True,
    block_size: int = 128,
    node_mask: Optional[jax.Array] = None,  # (B, N) 1 = real atom
    matmul_dtype=None,
    remat: bool = False,
):
    """Atom-sharded model forward: ``(out, x_out)`` sharded like inputs."""
    depth = len(p.layers)
    updates = [update] * depth if isinstance(update, bool) else list(update)
    n_dev = mesh.shape[axis]
    B, N, _ = h.shape
    assert N % n_dev == 0, "atom count must divide the mesh axis"
    n_local = N // n_dev

    def local_fn(h_loc, x_loc, m_loc):
        mm = _make_mm(matmul_dtype)
        offset = jax.lax.axis_index(axis) * n_local
        hc = _embed(p, h_loc, mm)  # (B, n_local, H)
        xp = [x_loc[..., k : k + 1] for k in range(3)]
        vp = None
        mask_loc = None
        if m_loc is not None:
            m_all = jax.lax.all_gather(m_loc, axis, axis=1, tiled=True)
            mask_loc = m_loc[:, :, None] * m_all[:, None, :]  # (B, nl, N)
        for lp, upd in zip(p.layers, updates):
            h_all = jax.lax.all_gather(hc, axis, axis=1, tiled=True)
            xp_all = [
                jax.lax.all_gather(pk, axis, axis=1, tiled=True) for pk in xp
            ]
            hc, xp, vp = blocked_layer_forward(
                lp, h_all, xp_all, vp,
                n_heads=n_heads, update=upd, block_size=block_size,
                matmul_dtype=matmul_dtype, mask=mask_loc,
                receiver_offset=offset, n_receivers=n_local, remat=remat,
            )
        out = _readout(p, hc, mm)
        return out, jnp.concatenate(xp, axis=-1)

    if node_mask is None:
        fn = shard_map(
            lambda h_, x_: local_fn(h_, x_, None),
            mesh=mesh,
            in_specs=(P(None, axis, None), P(None, axis, None)),
            out_specs=(P(None, axis, None), P(None, axis, None)),
            check_vma=False,
        )
        return fn(h, x)
    fn = shard_map(
        local_fn,
        mesh=mesh,
        in_specs=(
            P(None, axis, None), P(None, axis, None), P(None, axis)
        ),
        out_specs=(P(None, axis, None), P(None, axis, None)),
        check_vma=False,
    )
    return fn(h, x, node_mask)


# Above this many atoms the all-gather formulation's O(n_local * N)
# gathered edge working set stops fitting comfortably in device memory beside
# activations; the ring keeps O(n_local^2) blocks and neighbor-only
# traffic. The crossover is memory- not latency-driven, so it scales with
# atom count only.
RING_CROSSOVER_ATOMS = 4096


def sharded_model_forward(
    p: ModelParams,
    h: jax.Array,
    x: jax.Array,
    mesh: Mesh,
    *,
    axis: str = "data",
    mode: str = "auto",
    n_heads: int = 4,
    update: Sequence[bool] | bool = True,
    block_size: int = 128,
    node_mask: Optional[jax.Array] = None,
    matmul_dtype=None,
    remat: bool = False,
):
    """Atom-sharded forward with automatic gather-vs-ring selection.

    ``mode``: ``'gather'`` (all-gather senders per layer — latency-optimal
    for moderate N), ``'ring'`` (ppermute sender exchange — memory/
    bandwidth-optimal for huge N), or ``'auto'`` (ring when
    ``N > RING_CROSSOVER_ATOMS``). Both are oracle-exact vs the dense
    model (tests/test_bigsys.py) and support ``node_mask``.
    """
    N = h.shape[1]
    if mode == "auto":
        mode = "ring" if N > RING_CROSSOVER_ATOMS else "gather"
    if mode == "gather":
        return atom_sharded_forward(
            p, h, x, mesh, axis=axis, n_heads=n_heads, update=update,
            block_size=block_size, node_mask=node_mask,
            matmul_dtype=matmul_dtype, remat=remat,
        )
    if mode == "ring":
        return ring_atom_sharded_forward(
            p, h, x, mesh, axis=axis, n_heads=n_heads, update=update,
            node_mask=node_mask, matmul_dtype=matmul_dtype,
        )
    raise ValueError(f"unknown sharded mode {mode!r}")


def dp_atom_sharded_loss_step(
    p_like: ModelParams,
    mesh: Mesh,
    *,
    data_axis: str = "data",
    atom_axis: str = "sp",
    n_heads: int = 4,
    update: Sequence[bool] | bool = True,
    block_size: int = 8,
    matmul_dtype=None,
    remat: bool = False,
):
    """Build a 2D-sharded (batch x atoms) energy-regression training step.

    The hybrid layout for huge systems at scale: the batch is sharded over
    ``data_axis`` and atoms over ``atom_axis`` (the molecular analog of
    sequence parallelism). Inside one ``shard_map``:

    - each device computes its receiver rows via the blocked layer
      (senders all-gathered over ``atom_axis`` per layer),
    - per-graph energies are ``psum``-ed over ``atom_axis``,
    - parameter gradients are summed over ``atom_axis`` and averaged over
      ``data_axis`` — equivalent to the unsharded large-batch step.

    Returns ``step(params, opt_update_fn_free_batch) -> (loss, grads)``
    given batch dict {h (B,N,F), x (B,N,3), y (B,1)}.
    """
    depth = len(p_like.layers)
    updates = [update] * depth if isinstance(update, bool) else list(update)
    n_atom_shards = mesh.shape[atom_axis]

    def local_loss(params, h_loc, x_loc, y_loc):
        mm = _make_mm(matmul_dtype)
        n_local = h_loc.shape[1]
        offset = jax.lax.axis_index(atom_axis) * n_local
        hc = _embed(params, h_loc, mm)
        xp = [x_loc[..., k : k + 1] for k in range(3)]
        vp = None
        for lp, upd in zip(params.layers, updates):
            h_all = jax.lax.all_gather(hc, atom_axis, axis=1, tiled=True)
            xp_all = [
                jax.lax.all_gather(pk, atom_axis, axis=1, tiled=True)
                for pk in xp
            ]
            hc, xp, vp = blocked_layer_forward(
                lp, h_all, xp_all, vp,
                n_heads=n_heads, update=upd, block_size=block_size,
                matmul_dtype=matmul_dtype,
                receiver_offset=offset,
                n_receivers=n_local,
                remat=remat,
            )
        out = _readout(params, hc, mm)  # (B_loc, n_local, 1)
        e_partial = out.sum(axis=(-2, -1), keepdims=False)[:, None]
        e = jax.lax.psum(e_partial, atom_axis)  # per-graph energy (B_loc, 1)
        return ((e - y_loc) ** 2).mean()

    def local_step(params, batch):
        loss, grads = jax.value_and_grad(local_loss)(
            params, batch["h"], batch["x"], batch["y"]
        )
        # Collective accounting (verified against the unsharded oracle):
        # the forward ``psum(e_partial)`` transposes to ``psum`` of the
        # energy cotangent, so each shard's local grad is already
        # n_sp x (its own contribution); ``pmean`` over the atom axis
        # (sum contributions / n_sp) therefore yields exactly the full
        # parameter gradient.
        grads = jax.lax.pmean(grads, atom_axis)
        grads = jax.lax.pmean(grads, data_axis)
        loss = jax.lax.pmean(loss, data_axis)
        return loss, grads

    return shard_map(
        local_step,
        mesh=mesh,
        in_specs=(
            P(),
            {
                "h": P(data_axis, atom_axis, None),
                "x": P(data_axis, atom_axis, None),
                "y": P(data_axis, None),
            },
        ),
        out_specs=(P(), P()),
        check_vma=False,
    )


def ring_layer_forward(
    p: LayerParams,
    h_loc: jax.Array,  # (B, n_local, F) THIS shard's node features
    x_loc,  # 3 x (B, n_local, 1) shard position planes
    v_loc,  # 3 x (B, n_local, 1) or None
    *,
    axis: str,
    n_shards: int,
    n_heads: int,
    update: bool,
    m_loc: Optional[jax.Array] = None,  # (B, n_local, 1) node-mask plane
    matmul_dtype=None,
):
    """One dense SAKE layer with senders ring-rotated over ``axis``.

    The bandwidth-optimal refinement of the all-gather formulation
    (``atom_sharded_forward``): no device ever holds more than TWO sender
    shards — the node-level halves ``(a_j, o_j, x)`` of each shard travel
    around the ring via ``lax.ppermute`` while every device accumulates
    its receiver rows, the molecular analog of ring attention
    (SURVEY §5.7(b)). Two rotations are needed because the per-edge
    ``tanh`` coefficients require *finalized* softmax statistics (online
    rescaling cannot cross the nonlinearity): pass 1 accumulates the
    (max, sum) statistics, pass 2 the attention-weighted aggregates.
    Peak activation memory is O(n_local^2) vs the gather path's
    O(n_local * N); comm volume is ~2x an all-gather, in
    neighbor-to-neighbor transfers only.

    ``m_loc`` (node-mask plane, 1 = real atom) enables padded systems:
    sender masks travel the ring with the node halves; masked edges get
    -INF logits, attention/coefficients are zeroed on them, and the
    mean divisors use live-sender counts — matching the masked dense
    layer (including the fully-padded-receiver 0/0 guard).
    """
    B, n_local, F = h_loc.shape
    K = n_heads
    H = p.edge.w_out0.shape[-1]
    C = p.w_xmix.shape[-1]
    R = p.edge.w_in.shape[-1]
    mm = _make_mm(matmul_dtype)
    my = jax.lax.axis_index(axis)
    perm = [(i, (i - 1) % n_shards) for i in range(n_shards)]

    h2d = h_loc.reshape(B * n_local, F)
    a_j = mm(h2d, p.edge.w_in[:F]).reshape(B, n_local, R)
    o_j = mm(h2d, p.edge.w_out0[:F]).reshape(B, n_local, H)
    a_i = mm(h2d, p.edge.w_in[F:]).reshape(B, n_local, R)
    o_i = mm(h2d, p.edge.w_out0[F : 2 * F]).reshape(B, n_local, H)
    i_ids = my * n_local + jnp.arange(n_local)

    def visiting_ids(t):
        # after t left-rotations, this device holds the shard that
        # originated on device (my + t) mod n_shards
        return ((my + t) % n_shards) * n_local + jnp.arange(n_local)

    def rotate(blk):
        return jax.tree.map(lambda a: jax.lax.ppermute(a, axis, perm), blk)

    # ---- pass 1: ring online-softmax statistics --------------------------
    def ring_pass(body, carry):
        blk = (a_j, o_j, tuple(x_loc)) + (
            (m_loc,) if m_loc is not None else ()
        )
        for t in range(n_shards):
            carry = body(carry, blk, t)
            if t < n_shards - 1:
                blk = rotate(blk)
        return carry

    def edge_mask_of(m_jb):
        # (B, Ni, bs, 1): receiver plane x visiting sender plane
        return m_loc[:, :, None, :] * m_jb[:, None, :, 0][..., None]

    def pass1(carry, blk, t):
        m, z = carry
        a_jb, o_jb, x_jb = blk[:3]
        _, logits, _, _ = _edge_block_vs(
            p, mm, a_i=a_i, o_i=o_i, x_recv=x_loc, i_ids=i_ids,
            a_jb=a_jb, o_jb=o_jb, x_jb=list(x_jb), j_ids=visiting_ids(t),
            n_heads=K,
        )
        if m_loc is not None:
            logits = logits - INF * (1.0 - edge_mask_of(blk[3]))
        m_new = jnp.maximum(m, logits.max(axis=2))
        z = z * jnp.exp(m - m_new) + jnp.exp(
            logits - m_new[:, :, None, :]
        ).sum(axis=2)
        return m_new, z

    m0 = jnp.full((B, n_local, K), -jnp.inf)
    z0 = jnp.zeros((B, n_local, K))
    m, z = ring_pass(pass1, (m0, z0))

    # ---- pass 2: attention-weighted accumulation -------------------------
    def pass2(carry, blk, t):
        a_jb, o_jb, x_jb = blk[:3]
        h_e, logits, d, r = _edge_block_vs(
            p, mm, a_i=a_i, o_i=o_i, x_recv=x_loc, i_ids=i_ids,
            a_jb=a_jb, o_jb=o_jb, x_jb=list(x_jb), j_ids=visiting_ids(t),
            n_heads=K,
        )
        em = None
        if m_loc is not None:
            em = edge_mask_of(blk[3])
            logits = logits - INF * (1.0 - em)
        att = jnp.exp(logits - m[:, :, None, :]) / z[:, :, None, :]
        if em is not None:
            # fully-masked receivers have garbage (finite-max) softmax
            # stats — zero their attention exactly (dense 0/0 guard)
            att = att * em
        return _pass2_accumulate(
            p, mm, carry, h_e=h_e, att=att, d=d, r=r, n_heads=K, em=em
        )

    agg0 = jnp.zeros((B * n_local, p.w_node0.shape[-1]))
    pooled0 = jnp.zeros((3, B, n_local, C))
    agg_node, pooled = ring_pass(pass2, (agg0, pooled0))

    # ---- finalize (identical to the dense layer's node/velocity update) --
    if m_loc is not None:
        # live-sender count incl. the self pair (dense: mask4.sum(-2))
        total_live = jax.lax.psum(m_loc.sum(axis=1, keepdims=True), axis)
        count = m_loc * total_live  # (B, n_local, 1)
        pool_denom = count + 1e-8
        dv_denom_m = count + 1e-10
    else:
        N_total = n_shards * n_local
        pool_denom = float(N_total)
        dv_denom_m = float(N_total)
    norm_pool = [pooled[k] / pool_denom for k in range(3)]
    pool_sq = norm_pool[0] ** 2 + norm_pool[1] ** 2 + norm_pool[2] ** 2
    h_comb = _silu(
        mm(_silu(mm(pool_sq.reshape(B * n_local, C), p.w_post0) + p.b_post0),
           p.w_post1)
        + p.b_post1
    )
    node_pre = (
        mm(h2d, p.w_node0[:F])
        + agg_node
        + mm(h_comb, p.w_node0[F + H * K :])
        + p.b_node0
    )
    upd_val = mm(_silu(node_pre), p.w_node1) + p.b_node1
    h_out = h_loc + _silu(upd_val).reshape(B, n_local, F)

    if not update:
        return h_out, x_loc, v_loc

    delta_planes = [
        mm(pooled[k].reshape(B * n_local, C), p.w_vmix).reshape(B, n_local, 1)
        / dv_denom_m
        for k in range(3)
    ]
    if v_loc is not None:
        gate = 2.0 * jax.nn.sigmoid(
            mm(_silu(mm(h_out.reshape(B * n_local, F), p.w_vel0) + p.b_vel0),
               p.w_vel1)
        ).reshape(B, n_local, 1)
        v_new = [gate * vk + dk for vk, dk in zip(v_loc, delta_planes)]
    else:
        v_new = delta_planes
    x_new = [xk + vk for xk, vk in zip(x_loc, v_new)]
    return h_out, x_new, v_new


def ring_atom_sharded_forward(
    p: ModelParams,
    h: jax.Array,  # (B, N, F_in); N divisible by the mesh axis size
    x: jax.Array,  # (B, N, 3)
    mesh: Mesh,
    *,
    axis: str = "data",
    n_heads: int = 4,
    update: Sequence[bool] | bool = True,
    node_mask: Optional[jax.Array] = None,  # (B, N) 1 = real atom
    matmul_dtype=None,
):
    """Atom-sharded model forward with ring-``ppermute`` sender exchange.

    Same contract as ``atom_sharded_forward`` (outputs sharded like the
    inputs, oracle-exact vs the dense model) but never materializes the
    gathered sender set — the large-N formulation.
    """
    depth = len(p.layers)
    updates = [update] * depth if isinstance(update, bool) else list(update)
    n_dev = mesh.shape[axis]
    B, N, _ = h.shape
    assert N % n_dev == 0, "atom count must divide the mesh axis"

    def local_fn(h_loc, x_loc, m_loc):
        mm = _make_mm(matmul_dtype)
        hc = _embed(p, h_loc, mm)
        xp = [x_loc[..., k : k + 1] for k in range(3)]
        vp = None
        mp = m_loc[..., None] if m_loc is not None else None
        for lp, upd in zip(p.layers, updates):
            hc, xp, vp = ring_layer_forward(
                lp, hc, xp, vp,
                axis=axis, n_shards=n_dev, n_heads=n_heads, update=upd,
                m_loc=mp, matmul_dtype=matmul_dtype,
            )
        out = _readout(p, hc, mm)
        return out, jnp.concatenate(xp, axis=-1)

    if node_mask is None:
        fn = shard_map(
            lambda h_, x_: local_fn(h_, x_, None),
            mesh=mesh,
            in_specs=(P(None, axis, None), P(None, axis, None)),
            out_specs=(P(None, axis, None), P(None, axis, None)),
            check_vma=False,
        )
        return fn(h, x)
    fn = shard_map(
        local_fn,
        mesh=mesh,
        in_specs=(
            P(None, axis, None), P(None, axis, None), P(None, axis)
        ),
        out_specs=(P(None, axis, None), P(None, axis, None)),
        check_vma=False,
    )
    return fn(h, x, node_mask)
