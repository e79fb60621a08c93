"""Cutoff-sparse (neighborlist) SAKE execution: O(N·K) edge work.

The reference intended a sparse path (``sake/layers.py``'s vestigial,
broken ``SparseSAKELayer``); ``bigsys`` already bounds *memory* at
O(N·block) but still does O(N²) *work* — at N=8192 a fused E+F eval is
~29 s/chip. Production MD engines cut the work itself with a real-space
cutoff: each atom interacts with its ≤K neighbors inside ``cutoff``.
This module is that path, shaped for XLA:

- static shapes throughout: the neighbor list is a fixed ``(B, N, K)``
  index array + validity mask, so one compiled program serves every
  step of a trajectory (re-built as atoms move, same shapes);
- ``neighbor_list`` scans receiver rows in chunks (O(N·chunk) memory)
  and takes the K *nearest* in-cutoff senders via ``lax.top_k`` — when
  ``max_neighbors`` bounds the true coordination number the list is
  exact, otherwise it degrades gracefully to K-nearest;
- the layer math is the MASKED dense SAKE layer evaluated on gathered
  neighbor features. Contract (tested): for any neighbor graph G,
  ``sparse_model_forward(idx, mask)`` equals the dense masked path
  (``kernels.functional.model_forward(mask=densify(G))``) — the same
  −INF logits, mask-renormalized attention, and count-based mean
  divisors as the padded-batch (QM9/ANI/OC20) semantics
  (reference behavior: ``sake/layers.py:188-235`` + the edge masks of
  ``scripts/qm9_full/run.py:23-27``).

Cutoff semantics vs the reference: SAKE's published model attends over
ALL pairs — a cutoff is an *approximation* the reference never had (its
systems are ≤30 atoms). It is strictly opt-in; energies/forces at a
given cutoff are exact for the induced neighbor graph (the contract
above), and the neighbor indices/mask are non-differentiable (standard
MD practice: the graph is held fixed through the force evaluation).
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import jax.numpy as jnp

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


def _min_image(diff: jax.Array, box) -> jax.Array:
    """Orthorhombic minimum-image convention: wrap displacement components
    into ``[-L/2, L/2)``. ``round`` is piecewise-constant, so gradients
    flow through ``diff`` untouched — PBC forces are exact."""
    box = jnp.asarray(box, diff.dtype)
    return diff - box * jnp.round(diff / box)


def neighbor_list(
    x: jax.Array,  # (B, N, 3)
    cutoff: float,
    max_neighbors: int,
    *,
    node_mask: Optional[jax.Array] = None,  # (B, N) 1 = real atom
    row_chunk: int = 1024,
    box=None,  # (3,) orthorhombic periodic box, or None for open boundaries
    with_overflow: bool = False,
):
    """K-nearest-within-cutoff neighbor indices, static shapes.

    Returns ``(idx (B, N, K) int32, nbr_mask (B, N, K) float32)``; invalid
    slots (outside cutoff, self, padded atoms, or beyond the K nearest)
    have ``nbr_mask 0`` and an arbitrary in-range index. Peak memory is
    O(N·row_chunk), never O(N²): receiver rows are processed in
    ``lax.map`` chunks. With ``box``, distances use the minimum-image
    convention (requires ``cutoff <= min(box)/2``, the standard MD bound).

    When ``max_neighbors`` under-bounds the true coordination, rows keep
    their K *nearest* in-cutoff senders and silently drop the rest — an
    approximation a caller must be able to detect. Pass
    ``with_overflow=True`` to also get a per-batch int32 count of dropped
    in-cutoff senders (0 == the list is exact for this configuration);
    size ``max_neighbors`` until it stays 0.
    """
    B, N, _ = x.shape
    K = min(max_neighbors, N)
    rc = row_chunk if N % row_chunk == 0 else N
    nc = N // rc
    c2 = float(cutoff) ** 2

    # (nc, B, rc, 3) receiver chunks + (nc, rc) global row ids
    x_chunks = jnp.moveaxis(x.reshape(B, nc, rc, 3), 1, 0)
    ids = jnp.arange(N, dtype=jnp.int32).reshape(nc, rc)
    j_ids = jnp.arange(N, dtype=jnp.int32)

    def one(args):
        xi, i_ids = args  # (B, rc, 3), (rc,)
        diff = xi[:, :, None, :] - x[:, None, :, :]  # (B, rc, N, 3)
        if box is not None:
            diff = _min_image(diff, box)
        d2 = (diff * diff).sum(-1)  # (B, rc, N)
        valid = (d2 < c2) & (i_ids[None, :, None] != j_ids[None, None, :])
        if node_mask is not None:
            valid = valid & (node_mask[:, None, :] > 0)
        score = jnp.where(valid, -d2, -jnp.inf)
        vals, idx = jax.lax.top_k(score, K)  # (B, rc, K)
        dropped = jax.nn.relu(
            valid.sum(-1).astype(jnp.int32) - K
        ).sum(-1)  # (B,) in-cutoff senders beyond the K kept
        return (
            idx.astype(jnp.int32),
            (vals > -jnp.inf).astype(jnp.float32),
            dropped,
        )

    idx_c, m_c, drop_c = jax.lax.map(one, (x_chunks, ids))
    idx = jnp.moveaxis(idx_c, 0, 1).reshape(B, N, K)
    nbr_mask = jnp.moveaxis(m_c, 0, 1).reshape(B, N, K)
    if node_mask is not None:  # padded receivers have no neighbors
        nbr_mask = nbr_mask * node_mask[:, :, None]
    if with_overflow:
        return idx, nbr_mask, drop_c.sum(0)
    return idx, nbr_mask


def cell_neighbor_list(
    x: jax.Array,  # (B, N, 3)
    cutoff: float,
    max_neighbors: int,
    *,
    box,  # (3,) or scalar orthorhombic box — STATIC (shape-determining)
    cell_capacity: int = 32,
    node_mask: Optional[jax.Array] = None,  # (B, N) 1 = real atom
    row_chunk: int = 4096,
    with_overflow: bool = False,
    periodic: bool = True,
):
    """Cell-list (grid-binned) neighbor build: O(N·27·capacity) work.

    Same return contract as :func:`neighbor_list` — ``(idx (B, N, K)
    int32, nbr_mask (B, N, K) float32)``, the K nearest in-cutoff
    neighbors under the minimum-image convention — but built by binning
    atoms into a static grid of cells of side ≥ ``cutoff`` and scanning
    only the 27-cell stencil around each receiver, instead of
    :func:`neighbor_list`'s O(N²) all-pairs distance pass. This is the
    production-MD structure (the reference has no large-system path at
    all; its ``SparseSAKELayer`` is vestigial — ``sake/layers.py``).

    Shape discipline: ``box`` must be static (a Python
    float/tuple, not a traced array) because the grid dimensions
    ``floor(L/cutoff)`` are shape-determining; one compiled program then
    serves every rebuild of a trajectory. Binning is sort-based (no
    data-dependent scatter shapes): atoms are ``argsort``-ed by cell id,
    ranked within their run via ``searchsorted``, and scattered into a
    fixed ``(n_cells, capacity)`` table; rank-overflow atoms beyond
    ``cell_capacity`` are DROPPED from the table (detectable — pass
    ``with_overflow=True`` to get the per-batch dropped-atom count; size
    ``cell_capacity`` ≥ the max cell occupancy for an exact list).

    Falls back to :func:`neighbor_list` (identical semantics) when any
    box dimension holds fewer than 3 cells — there the 27-cell stencil
    would alias cells and double-count senders, and the all-pairs pass
    is cheap anyway.

    ``periodic=False`` builds an OPEN-boundary list: ``box`` is then just
    the grid extent (positions need not lie inside it), distances are
    plain Euclidean, and the stencil is clipped at the grid faces instead
    of wrapped. Out-of-extent atoms are clipped into the boundary cell
    layer, which is exact: clipping is per-dimension non-expansive
    (``|clip(a)-clip(b)| <= |a-b|``), so any in-cutoff pair stays within
    one stencil cell of each other — spurious candidates are distance-
    filtered, none are missed. The failure mode is boundary-cell
    crowding, reported through the same overflow count. This matches
    :func:`neighbor_list` with ``box=None`` exactly (tested) and makes
    the O(N·27·capacity) build available to open systems — the all-pairs
    build's O(N²) distance pass is what goes superlinear past N≈8192.
    """
    import numpy as np

    B, N, _ = x.shape
    K = min(max_neighbors, N)
    box3 = tuple(float(v) for v in np.broadcast_to(np.asarray(box), (3,)))
    ncell = tuple(max(int(L / float(cutoff)), 1) for L in box3)
    if min(ncell) < 3:
        return neighbor_list(
            x, cutoff, max_neighbors, node_mask=node_mask,
            box=box if periodic else None, with_overflow=with_overflow,
        )

    n_cells = ncell[0] * ncell[1] * ncell[2]
    cap = int(cell_capacity)
    c2 = float(cutoff) ** 2
    widths = jnp.asarray([L / n for L, n in zip(box3, ncell)], x.dtype)
    ncell_arr = jnp.asarray(ncell, jnp.int32)
    bx = jnp.asarray(box3, x.dtype)
    # static 27-cell stencil offsets
    offs = jnp.asarray(
        [[i, j, k] for i in (-1, 0, 1) for j in (-1, 0, 1)
         for k in (-1, 0, 1)],
        jnp.int32,
    )
    rc = row_chunk if N % row_chunk == 0 else N
    nc = N // rc

    def one(xb, nmb):
        if periodic:
            xw = xb - bx * jnp.floor(xb / bx)  # wrap into [0, L)
        else:
            xw = xb  # open: grid ids clip; distances stay Euclidean
        ci = jnp.clip(
            jnp.floor(xw / widths).astype(jnp.int32), 0, ncell_arr - 1
        )  # (N, 3)
        cid = (ci[:, 0] * ncell[1] + ci[:, 1]) * ncell[2] + ci[:, 2]
        if nmb is not None:  # padded atoms -> trash cell (never candidates)
            cid = jnp.where(nmb > 0, cid, n_cells)
        order = jnp.argsort(cid).astype(jnp.int32)
        scid = cid[order]
        first = jnp.searchsorted(scid, scid, side="left")
        rank = jnp.arange(N, dtype=jnp.int32) - first.astype(jnp.int32)
        real = scid < n_cells
        ok = (rank < cap) & real
        slot = jnp.where(ok, scid * cap + rank, n_cells * cap)
        table = (
            jnp.full((n_cells * cap + 1,), N, jnp.int32).at[slot].set(order)
        )[: n_cells * cap].reshape(n_cells, cap)
        overflow = ((rank >= cap) & real).sum().astype(jnp.int32)

        xpad = jnp.concatenate(
            [xw, jnp.full((1, 3), 2.0 * max(box3) + cutoff, x.dtype)]
        )

        def rows(args):
            ci_r, i_ids, xw_r = args  # (rc, 3), (rc,), (rc, 3)
            nb_raw = ci_r[:, None, :] + offs[None]  # (rc, 27, 3)
            if periodic:
                nb = nb_raw % ncell_arr
            else:  # clip at the grid faces; mask aliased stencil cells
                nb = jnp.clip(nb_raw, 0, ncell_arr - 1)
            nb_id = (nb[..., 0] * ncell[1] + nb[..., 1]) * ncell[2] + nb[
                ..., 2
            ]
            cand = table[nb_id]  # (rc, 27, cap)
            if not periodic:
                in_grid = jnp.all(
                    (nb_raw >= 0) & (nb_raw < ncell_arr), axis=-1
                )  # (rc, 27)
                cand = jnp.where(in_grid[..., None], cand, N)
            cand = cand.reshape(rc, 27 * cap)  # (rc, M)
            diff = xw_r[:, None, :] - xpad[cand]
            if periodic:
                diff = _min_image(diff, bx)
            d2 = (diff * diff).sum(-1)
            valid = (cand != i_ids[:, None]) & (cand < N) & (d2 < c2)
            score = jnp.where(valid, -d2, -jnp.inf)
            kc = min(K, 27 * cap)  # candidate set can be smaller than K
            vals, sel = jax.lax.top_k(score, kc)
            m = vals > -jnp.inf
            idx = jnp.take_along_axis(cand, sel, axis=1)
            idx = jnp.where(m, idx, 0).astype(jnp.int32)
            m = m.astype(jnp.float32)
            trunc = jax.nn.relu(
                valid.sum(-1).astype(jnp.int32) - kc
            ).sum()  # in-cutoff candidates beyond the kc kept
            if kc < K:
                idx = jnp.pad(idx, ((0, 0), (0, K - kc)))
                m = jnp.pad(m, ((0, 0), (0, K - kc)))
            return idx, m, trunc

        ids = jnp.arange(N, dtype=jnp.int32)
        idx_c, m_c, trunc_c = jax.lax.map(
            rows,
            (
                ci.reshape(nc, rc, 3),
                ids.reshape(nc, rc),
                xw.reshape(nc, rc, 3),
            ),
        )
        # overflow = capacity-dropped atoms + K-truncated in-cutoff
        # senders: 0 == the list is exact for this configuration
        return (
            idx_c.reshape(N, K),
            m_c.reshape(N, K),
            overflow + trunc_c.sum(),
        )

    idx, nbr_mask, overflow = jax.vmap(
        one, in_axes=(0, 0 if node_mask is not None else None)
    )(x, node_mask)
    if node_mask is not None:  # padded receivers have no neighbors
        nbr_mask = nbr_mask * node_mask[:, :, None]
    if with_overflow:
        return idx, nbr_mask, overflow
    return idx, nbr_mask


def densify_neighbors(idx, nbr_mask, n: int):
    """(B, N, K) neighbor list -> (B, N, n) dense edge mask (for the
    exactness tests against the masked dense path)."""
    onehot = jax.nn.one_hot(idx, n, dtype=nbr_mask.dtype)  # (B, N, K, n)
    return (onehot * nbr_mask[..., None]).sum(axis=2)


def _gather(a: jax.Array, idx: jax.Array):
    """a (B, N, D), idx (B, N, K) -> a[b, idx[b, i, k], :] (B, N, K, D)."""
    B, N, K = idx.shape
    flat = jnp.take_along_axis(a, idx.reshape(B, N * K, 1), axis=1)
    return flat.reshape(B, N, K, a.shape[-1])


def sparse_layer_forward(
    p: LayerParams,
    h: jax.Array,  # (B, N, F)
    x_planes,  # 3 x (B, N, 1)
    v_planes,  # 3 x (B, N, 1) or None
    idx: jax.Array,  # (B, N, K) neighbor indices
    nbr_mask: jax.Array,  # (B, N, K)
    *,
    n_heads: int,
    update: bool,
    matmul_dtype=None,
    box=None,  # (3,) periodic box: minimum-image displacements
):
    """One SAKE layer on gathered neighbors — the masked dense layer
    (``kernels.functional.layer_forward_planes``) with the sender axis
    j replaced by the K-neighbor axis. Numerically equal to the dense
    path under ``mask=densify_neighbors(idx, nbr_mask, N)`` (tested)."""
    B, N, F = h.shape
    K = n_heads
    H = p.edge.w_out0.shape[-1]
    R = p.edge.w_in.shape[-1]
    mm = _make_mm(matmul_dtype)
    h2d = h.reshape(B * N, F)
    Kn = idx.shape[-1]
    E = B * N * Kn
    m4 = nbr_mask[..., None]  # (B, N, Kn, 1)

    # geometry on gathered positions
    xg = [_gather(pk, idx) for pk in x_planes]  # 3 x (B, N, Kn, 1)
    d_planes = [gj - pi[:, :, None, :] for gj, pi in zip(xg, x_planes)]
    if box is not None:
        bx = jnp.asarray(box, jnp.float32)
        d_planes = [_min_image(dk, bx[k2]) for k2, dk in enumerate(d_planes)]
    r = jnp.sqrt(
        jax.nn.relu(
            d_planes[0] ** 2 + d_planes[1] ** 2 + d_planes[2] ** 2
        )
        + EPSILON
    )

    # edge model (CFConv), node-factorized then gathered
    a_j = _gather(mm(h2d, p.edge.w_in[:F]).reshape(B, N, R), idx)
    a_i = mm(h2d, p.edge.w_in[F:]).reshape(B, N, R)
    pre = a_j + a_i[:, :, None, :] + p.edge.b_in  # (B, N, Kn, R)
    rbf = jnp.exp(-p.edge.rbf_betas * (jnp.exp(-r) - p.edge.rbf_means) ** 2)
    filtered = rbf * pre
    o_j = _gather(mm(h2d, p.edge.w_out0[:F]).reshape(B, N, H), idx)
    o_i = mm(h2d, p.edge.w_out0[F : 2 * F]).reshape(B, N, H)
    o_f = mm(filtered.reshape(E, R), p.edge.w_out0[2 * F : 2 * F + R])
    e0 = (
        o_j
        + o_i[:, :, None, :]
        + o_f.reshape(B, N, Kn, H)
        + r * p.edge.w_out0[2 * F + R]
        + p.edge.b_out0
    )
    h_e = mm(_silu(e0).reshape(E, H), p.edge.w_out1).reshape(
        B, N, Kn, H
    ) + p.edge.b_out1

    # semantic attention over the neighbor axis (masked-dense semantics:
    # -INF invalid slots, renormalize over surviving senders). Self-pairs
    # are already excluded by neighbor_list; a caller-built idx that
    # includes them must zero them in nbr_mask.
    logits = _celu2(
        mm(h_e.reshape(E, H), p.w_sem).reshape(B, N, Kn, K) + p.b_sem
    )
    logits = logits - INF * (1.0 - m4)
    att = jax.nn.softmax(logits, axis=-2)
    att = att * m4
    denom = att.sum(axis=-2, keepdims=True)
    att = att / jnp.where(denom == 0.0, 1.0, denom)

    C = p.w_xmix.shape[-1]
    w_xmix_hk = p.w_xmix.reshape(H, K, C)
    w_nagg_hk = p.w_node0[F : F + H * K].reshape(H, K, -1)
    coeff_pre = jnp.zeros((B, N, Kn, C), jnp.float32)
    agg_node = jnp.zeros((B * N, p.w_node0.shape[-1]), jnp.float32)
    he2d = h_e.reshape(E, H)
    for k in range(K):
        att_k = att[..., k : k + 1]
        coeff_pre = coeff_pre + att_k * mm(he2d, w_xmix_hk[:, k, :]).reshape(
            B, N, Kn, C
        )
        a_k = (h_e * att_k).sum(axis=-2)
        agg_node = agg_node + mm(a_k.reshape(B * N, H), w_nagg_hk[:, k, :])
    coeff = jnp.tanh(coeff_pre) * m4

    inv_r = 1.0 / (r + 1e-5)
    pooled_planes = [
        (coeff * (d_planes[k2] * inv_r)).sum(axis=-2) for k2 in range(3)
    ]
    count = m4.sum(axis=-2)  # (B, N, 1)
    norm_pool = [pk / (count + 1e-8) for pk in pooled_planes]
    pool_sq = norm_pool[0] ** 2 + norm_pool[1] ** 2 + norm_pool[2] ** 2
    h_comb = _silu(
        mm(
            _silu(mm(pool_sq.reshape(B * N, C), p.w_post0) + p.b_post0),
            p.w_post1,
        )
        + p.b_post1
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

    dv_denom = count + 1e-10
    delta_planes = [
        mm(pk.reshape(B * N, C), p.w_vmix).reshape(B, N, 1) / dv_denom
        for pk in pooled_planes
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


def make_sparse_energy_forces(
    h: jax.Array,  # (B, N, F_in) fixed species features
    *,
    n_heads: int = 4,
    update: Sequence[bool] | bool = True,
    matmul_dtype=None,
    remat: bool = True,
    node_mask: Optional[jax.Array] = None,  # (B, N)
    box=None,  # (3,) periodic box
):
    """``(params, x, idx, nbr_mask) -> (e (B,), f (B, N, 3))`` on the
    cutoff-sparse model — the force field driving
    ``md.neighborlist_verlet_rollout``. ``remat=True`` keeps the force
    backward at O(N·K) memory."""
    nm = None if node_mask is None else node_mask[..., None]

    def energy_forces(p: ModelParams, x, idx, nbr_mask):
        # per-graph energies with a single summed-grad pass: forces of
        # graph b depend only on x[b], so grad of the batch-summed energy
        # gives every graph's forces in one backward
        def e_sum(x_):
            out, _, _ = sparse_model_forward(
                p, h, x_, idx, nbr_mask,
                n_heads=n_heads, update=update,
                matmul_dtype=matmul_dtype, remat=remat, box=box,
            )
            if nm is not None:
                out = out * nm
            e_b = out.sum(axis=(-2, -1))
            return e_b.sum(), e_b

        (_, e_b), neg_f = jax.value_and_grad(e_sum, has_aux=True)(x)
        return e_b, -neg_f

    return energy_forces


def sparse_model_forward(
    p: ModelParams,
    h: jax.Array,  # (B, N, F_in)
    x: jax.Array,  # (B, N, 3)
    idx: jax.Array,  # (B, N, K)
    nbr_mask: jax.Array,  # (B, N, K)
    v=None,
    *,
    n_heads: int = 4,
    update: Sequence[bool] | bool = True,
    matmul_dtype=None,
    remat: bool = False,
    box=None,  # (3,) periodic box: minimum-image displacements
):
    """Full model on a fixed neighbor list: O(N·K) work and memory.

    The neighbor graph is held fixed across the depth (the cutoff-MD
    convention; positions move by tiny per-layer updates). ``remat=True``
    checkpoints each layer so force/training backward memory stays
    O(N·K) too.
    """
    depth = len(p.layers)
    updates = [update] * depth if isinstance(update, bool) else list(update)
    mm = _make_mm(matmul_dtype)
    xp = [x[..., k : k + 1] for k in range(3)]
    vp = [v[..., k : k + 1] for k in range(3)] if v is not None else None
    hc = _embed(p, h, mm)

    def layer_step(lp, upd, hc_, xp_, vp_):
        return sparse_layer_forward(
            lp, hc_, xp_, vp_, idx, nbr_mask,
            n_heads=n_heads, update=upd, matmul_dtype=matmul_dtype,
            box=box,
        )

    step = jax.checkpoint(layer_step, static_argnums=(1,)) if remat \
        else layer_step
    for lp, upd in zip(p.layers, updates):
        hc, xp, vp = step(lp, upd, hc, xp, vp)
    out = _readout(p, hc, mm)
    x_out = jnp.concatenate(xp, axis=-1)
    v_out = jnp.concatenate(vp, axis=-1) if vp is not None else None
    return out, x_out, v_out
