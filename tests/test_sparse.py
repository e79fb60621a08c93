"""Cutoff-sparse path: neighbor list correctness and exactness vs the
masked dense path (the contract documented in sake_tpu/sparse.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sake_tpu.kernels import model_forward, model_params_from_linen
from sake_tpu.models import SAKEModel
from sake_tpu.sparse import (
    densify_neighbors,
    neighbor_list,
    sparse_model_forward,
)

TOL = dict(rtol=5e-5, atol=5e-6)


@pytest.fixture(scope="module")
def setup():
    rng = np.random.RandomState(0)
    B, N, F = 2, 48, 5
    h = jnp.asarray(rng.randn(B, N, F), jnp.float32)
    x = jnp.asarray(rng.randn(B, N, 3) * 2.5, jnp.float32)
    model = SAKEModel(hidden_features=16, out_features=1, depth=2)
    params = model.init(jax.random.PRNGKey(0), h[0], x[0])
    kp = model_params_from_linen(params)
    return kp, h, x


def test_neighbor_list_matches_bruteforce(setup):
    _, _, x = setup
    cutoff, K = 2.0, 24
    idx, m = jax.jit(
        lambda x_: neighbor_list(x_, cutoff, K, row_chunk=16)
    )(x)
    xn = np.asarray(x)
    for b in range(xn.shape[0]):
        d = np.linalg.norm(xn[b][:, None] - xn[b][None], axis=-1)
        for i in range(xn.shape[1]):
            true = {
                j for j in range(xn.shape[1])
                if j != i and d[i, j] < cutoff
            }
            assert len(true) <= K, "test geometry must fit K"
            got = {
                int(idx[b, i, k])
                for k in range(K)
                if m[b, i, k] > 0
            }
            assert got == true, (b, i, got, true)


def test_sparse_matches_masked_dense(setup):
    kp, h, x = setup
    N = h.shape[1]
    idx, m = neighbor_list(x, 2.5, 32)
    mask = densify_neighbors(idx, m, N)
    out_d, x_d, v_d = model_forward(kp, h, x, mask=mask)
    out_s, x_s, v_s = sparse_model_forward(kp, h, x, idx, m)
    np.testing.assert_allclose(out_s, out_d, **TOL)
    np.testing.assert_allclose(x_s, x_d, **TOL)
    np.testing.assert_allclose(v_s, v_d, **TOL)


def test_sparse_forces_match_masked_dense(setup):
    kp, h, x = setup
    N = h.shape[1]
    idx, m = neighbor_list(x, 2.5, 32)
    mask = densify_neighbors(idx, m, N)

    def e_dense(x_):
        out, _, _ = model_forward(kp, h, x_, mask=mask)
        return out.sum()

    def e_sparse(x_, remat):
        out, _, _ = sparse_model_forward(kp, h, x_, idx, m, remat=remat)
        return out.sum()

    g_d = jax.grad(e_dense)(x)
    g_s = jax.jit(jax.grad(lambda x_: e_sparse(x_, False)))(x)
    g_r = jax.jit(jax.grad(lambda x_: e_sparse(x_, True)))(x)
    # the dense graph differentiates through its own mask=0 edges exactly
    # the same way (zeroed contributions), so gradients agree
    np.testing.assert_allclose(g_s, g_d, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(g_r, g_s, rtol=1e-6, atol=1e-7)


def test_neighbor_list_node_mask_and_ragged_chunk(setup):
    _, _, x = setup
    rng = np.random.RandomState(1)
    node_mask = jnp.asarray(rng.rand(*x.shape[:2]) > 0.3, jnp.float32)
    # row_chunk not dividing N falls back to a single chunk
    idx, m = neighbor_list(x, 2.0, 16, node_mask=node_mask, row_chunk=7)
    # no neighbor may point at a padded atom, padded rows have none
    sel_real = jnp.take_along_axis(node_mask, idx.reshape(2, -1), axis=1)
    assert bool((m.reshape(2, -1) * (1 - sel_real) == 0).all())
    assert bool((m * (1 - node_mask[:, :, None]) == 0).all())


def test_neighborlist_rollout_matches_dense_at_full_cutoff(setup):
    """With cutoff covering every pair (complete graph each rebuild), the
    neighborlist MD rollout is the dense masked all-pairs rollout."""
    from sake_tpu.kernels import model_forward
    from sake_tpu.md import neighborlist_verlet_rollout, velocity_verlet_rollout
    from sake_tpu.sparse import make_sparse_energy_forces

    kp, h, x = setup
    B, N = x.shape[:2]
    h, x = h[:, :12], x[:, :12]  # keep the dense N^2 reference cheap
    N = 12
    v0 = jnp.zeros_like(x)
    masses = jnp.ones((N,), jnp.float32)
    big = 1e3  # larger than any pair distance

    sparse_ef = make_sparse_energy_forces(h, remat=True)
    xs_s, vs_s, es_s = jax.jit(
        lambda p, x_: neighborlist_verlet_rollout(
            sparse_ef, p, x_, v0, masses, 1e-3, 6,
            cutoff=big, max_neighbors=N, rebuild_every=2,
        )
    )(kp, x)

    # dense reference on the complete-minus-self graph
    idx, m = neighbor_list(x, big, N)
    mask = densify_neighbors(idx, m, N)

    def dense_ef(p, x_):
        def e_sum(x__):
            out, _, _ = model_forward(p, h, x__, mask=mask)
            e_b = out.sum(axis=(-2, -1))
            return e_b.sum(), e_b

        (_, e_b), neg_f = jax.value_and_grad(e_sum, has_aux=True)(x_)
        return e_b, -neg_f

    xs_d, vs_d, es_d = jax.jit(
        lambda p, x_: velocity_verlet_rollout(
            dense_ef, p, x_, v0, masses, 1e-3, 6, sample_every=2
        )
    )(kp, x)
    np.testing.assert_allclose(xs_s, xs_d, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(es_s, es_d, rtol=1e-4, atol=1e-4)


def test_neighborlist_rollout_small_cutoff_finite(setup):
    """A genuinely sparse rollout (small cutoff, K << N) stays finite and
    the rebuild cadence is live (graph changes as atoms move)."""
    from sake_tpu.md import neighborlist_verlet_rollout
    from sake_tpu.sparse import make_sparse_energy_forces

    kp, h, x = setup
    v0 = jnp.zeros_like(x)
    masses = jnp.ones((x.shape[1],), jnp.float32)
    ef = make_sparse_energy_forces(h, remat=True)
    xs, vs, es = jax.jit(
        lambda p, x_: neighborlist_verlet_rollout(
            ef, p, x_, v0, masses, 5e-2, 8,
            cutoff=2.0, max_neighbors=12, rebuild_every=4, skin=0.3,
        )
    )(kp, x)
    assert xs.shape == (2, *x.shape) and es.shape == (2, x.shape[0])
    assert bool(jnp.isfinite(xs).all()) and bool(jnp.isfinite(es).all())
    assert float(jnp.abs(xs[-1] - x).max()) > 0  # atoms actually moved


def test_pbc_lattice_shift_invariance(setup):
    """With a periodic box, shifting any atom by integer lattice vectors
    leaves energies and forces unchanged (minimum image)."""
    kp, h, x = setup
    rng = np.random.RandomState(3)
    box = jnp.asarray([9.0, 10.0, 11.0], jnp.float32)
    xb = jnp.asarray(rng.rand(2, 48, 3), jnp.float32) * box
    shift = jnp.asarray(
        rng.randint(-2, 3, xb.shape), jnp.float32
    ) * box  # integer lattice translations per atom
    from sake_tpu.sparse import make_sparse_energy_forces

    ef = make_sparse_energy_forces(h, box=box, remat=True)

    def run(x_):
        idx, m = neighbor_list(x_, 3.0, 24, box=box)
        return ef(kp, x_, idx, m)

    e0, f0 = jax.jit(run)(xb)
    e1, f1 = jax.jit(run)(xb + shift)
    np.testing.assert_allclose(e1, e0, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(f1, f0, rtol=1e-4, atol=1e-5)


def test_pbc_cross_boundary_pair_matches_unwrapped():
    """A pair interacting across the box face gives exactly the E+F of the
    equivalent unwrapped open-boundary configuration."""
    from sake_tpu.kernels import model_params_from_linen
    from sake_tpu.models import SAKEModel
    from sake_tpu.sparse import make_sparse_energy_forces

    L = 10.0
    box = jnp.asarray([L, L, L], jnp.float32)
    h = jnp.eye(2, 5, dtype=jnp.float32)[None]  # (1, 2, 5)
    model = SAKEModel(hidden_features=16, out_features=1, depth=2)
    params = model.init(jax.random.PRNGKey(0), h[0], jnp.zeros((2, 3)))
    kp = model_params_from_linen(params)

    # across the face: distance 0.4 via the image, 9.6 directly
    x_pbc = jnp.asarray([[[0.2, 5.0, 5.0], [L - 0.2, 5.0, 5.0]]], jnp.float32)
    x_open = jnp.asarray([[[0.2, 5.0, 5.0], [-0.2, 5.0, 5.0]]], jnp.float32)

    ef_pbc = make_sparse_energy_forces(h, box=box, remat=False)
    ef_open = make_sparse_energy_forces(h, remat=False)
    idx_p, m_p = neighbor_list(x_pbc, 1.0, 1, box=box)
    idx_o, m_o = neighbor_list(x_open, 1.0, 1)
    assert float(m_p.sum()) == 2.0 and float(m_o.sum()) == 2.0
    e_p, f_p = jax.jit(ef_pbc)(kp, x_pbc, idx_p, m_p)
    e_o, f_o = jax.jit(ef_open)(kp, x_open, idx_o, m_o)
    np.testing.assert_allclose(e_p, e_o, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(f_p, f_o, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("cell_list", [False, True])
def test_pbc_sparse_matches_blocked_dense_with_box(setup, cell_list):
    """The periodic contract: per-atom outputs of the sparse model equal
    the masked dense model (evaluated blockwise, minimum-image geometry)
    on the same neighbor graph, for both neighbor builds."""
    from sake_tpu.bigsys import blocked_model_forward
    from sake_tpu.sparse import cell_neighbor_list

    kp, h, _ = setup
    rng = np.random.RandomState(21)
    N = h.shape[1]
    box = (7.0, 8.0, 9.0)
    x = jnp.asarray(rng.rand(2, N, 3) * np.asarray(box), jnp.float32)
    if cell_list:
        idx, m = cell_neighbor_list(x, 2.3, 24, box=box, cell_capacity=32)
    else:
        idx, m = neighbor_list(x, 2.3, 24, box=box)
    bx = jnp.asarray(box, jnp.float32)
    out_s, _, _ = sparse_model_forward(kp, h, x, idx, m, update=False, box=bx)
    out_d, _, _ = blocked_model_forward(
        kp, h, x, update=False, block_size=16,
        mask=densify_neighbors(idx, m, N), box=bx,
    )
    np.testing.assert_allclose(out_s, out_d, **TOL)
    # without the minimum image the dense model sees another geometry
    out_o, _, _ = blocked_model_forward(
        kp, h, x, update=False, block_size=16,
        mask=densify_neighbors(idx, m, N),
    )
    assert np.abs(np.asarray(out_o - out_s)).max() > 1e-3


def test_pbc_rollout_wraps_and_stays_finite(setup):
    """Periodic MD rollout: positions stay in the box at sample points,
    trajectory finite."""
    from sake_tpu.md import neighborlist_verlet_rollout
    from sake_tpu.sparse import make_sparse_energy_forces

    kp, h, _ = setup
    rng = np.random.RandomState(4)
    box = jnp.asarray([8.0, 8.0, 8.0], jnp.float32)
    x0 = jnp.asarray(rng.rand(2, 48, 3), jnp.float32) * box
    v0 = jnp.asarray(rng.randn(2, 48, 3) * 2.0, jnp.float32)
    masses = jnp.ones((48,), jnp.float32)
    ef = make_sparse_energy_forces(h, box=box, remat=True)
    xs, vs, es = jax.jit(
        lambda p: neighborlist_verlet_rollout(
            ef, p, x0, v0, masses, 5e-2, 8,
            cutoff=2.0, max_neighbors=12, rebuild_every=2, skin=0.3,
            box=box,
        )
    )(kp)
    assert bool(jnp.isfinite(xs).all()) and bool(jnp.isfinite(es).all())
    # wrapped at rebuild: every sampled frame's positions lie within one
    # verlet interval's drift of the box
    drift = float(jnp.abs(vs).max()) * 5e-2 * 2
    assert float(xs.min()) > -drift - 1e-3
    assert float(xs.max()) < 8.0 + drift + 1e-3


def test_sparse_isolated_atoms_finite(setup):
    """Zero-neighbor rows (cutoff smaller than any pair) stay finite."""
    kp, h, x = setup
    idx, m = neighbor_list(x, 1e-4, 8)
    assert float(m.sum()) == 0.0
    out, x_o, _ = sparse_model_forward(kp, h, x, idx, m)
    assert bool(jnp.isfinite(out).all()) and bool(jnp.isfinite(x_o).all())


def test_cell_list_matches_chunked_build():
    """Grid-binned O(N·27·cap) build == the all-pairs O(N²) build on the
    same periodic box (identical neighbor sets via the densified mask),
    including coordinates far outside the box (wrap) and padded atoms."""
    from sake_tpu.sparse import cell_neighbor_list

    rng = np.random.RandomState(3)
    B, N, K = 2, 257, 32  # N indivisible by row_chunk -> whole-row path
    box = (12.0, 15.0, 13.0)
    x = jnp.asarray(
        rng.rand(B, N, 3) * np.asarray(box) * 3.0 - 7.0, jnp.float32
    )
    i1, m1 = neighbor_list(x, 3.0, K, box=box)
    i2, m2, ov = cell_neighbor_list(
        x, 3.0, K, box=box, cell_capacity=64, with_overflow=True
    )
    assert int(np.asarray(ov).max()) == 0
    assert jnp.all(densify_neighbors(i1, m1, N) == densify_neighbors(i2, m2, N))
    assert int(i2.min()) >= 0 and int(i2.max()) < N

    nm = jnp.asarray((rng.rand(B, N) > 0.2).astype(np.float32))
    i1, m1 = neighbor_list(x, 3.0, K, box=box, node_mask=nm)
    i2, m2 = cell_neighbor_list(
        x, 3.0, K, box=box, cell_capacity=64, node_mask=nm
    )
    assert jnp.all(densify_neighbors(i1, m1, N) == densify_neighbors(i2, m2, N))
    assert jnp.all(m2.sum(-1) * (1 - nm) == 0)  # padded receivers empty


def test_cell_list_small_box_fallback_and_overflow():
    from sake_tpu.sparse import cell_neighbor_list

    rng = np.random.RandomState(4)
    B, N, K = 1, 64, 16
    box = (12.0, 15.0, 13.0)
    x = jnp.asarray(rng.rand(B, N, 3) * np.asarray(box), jnp.float32)
    # cutoff 6 -> 2 cells/dim: must fall back to the exact all-pairs build
    i1, m1 = neighbor_list(x, 6.0, K, box=box)
    i2, m2 = cell_neighbor_list(x, 6.0, K, box=box)
    assert jnp.all(densify_neighbors(i1, m1, N) == densify_neighbors(i2, m2, N))
    # capacity 1 drops atoms and reports them; masks stay a valid subset
    i3, m3, ov = cell_neighbor_list(
        x, 3.0, K, box=box, cell_capacity=1, with_overflow=True
    )
    assert int(np.asarray(ov).max()) > 0
    d_full = densify_neighbors(*neighbor_list(x, 3.0, K, box=box), N)
    d_sub = densify_neighbors(i3, m3, N)
    assert jnp.all(d_sub <= d_full)


def test_rollout_cell_list_matches_allpairs_build():
    """One compiled rollout program, cell-list vs all-pairs builds ->
    identical trajectories (the builds produce the same graphs)."""
    from sake_tpu.md import neighborlist_verlet_rollout
    from sake_tpu.sparse import make_sparse_energy_forces

    rng = np.random.RandomState(5)
    B, N, F = 1, 96, 4
    box = (9.0, 9.0, 9.0)
    h = jnp.asarray(rng.randn(B, N, F), jnp.float32)
    x0 = jnp.asarray(rng.rand(B, N, 3) * 9.0, jnp.float32)
    v0 = jnp.zeros_like(x0)
    model = SAKEModel(hidden_features=8, out_features=1, depth=2)
    params = model.init(jax.random.PRNGKey(0), h[0], x0[0])
    kp = model_params_from_linen(params)
    ef = make_sparse_energy_forces(h, box=box)
    kw = dict(
        dt=5e-4, n_steps=4, cutoff=2.5, max_neighbors=16,
        rebuild_every=2, box=box,
    )
    masses = jnp.ones((N,))
    xs_a, _, es_a = neighborlist_verlet_rollout(
        ef, kp, x0, v0, masses, **kw
    )
    xs_c, _, es_c = neighborlist_verlet_rollout(
        ef, kp, x0, v0, masses, cell_capacity=32, **kw
    )
    np.testing.assert_allclose(np.asarray(xs_a), np.asarray(xs_c), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(es_a), np.asarray(es_c), rtol=1e-6)


def test_neighbor_list_overflow_signal():
    """with_overflow counts in-cutoff senders dropped beyond K exactly
    (silent K-truncation must be detectable)."""
    # 5 atoms in a tight cluster: every pair within the cutoff
    x = jnp.asarray(
        np.random.RandomState(0).randn(1, 5, 3) * 0.1, jnp.float32
    )
    idx, m, ovf = neighbor_list(x, 10.0, 2, with_overflow=True)
    # each of the 5 rows has 4 in-cutoff senders, keeps 2 -> drops 2
    assert int(ovf[0]) == 5 * 2
    assert float(m.sum()) == 5 * 2
    # adequate K -> exact list, overflow 0
    _, m4, ovf0 = neighbor_list(x, 10.0, 4, with_overflow=True)
    assert int(ovf0[0]) == 0
    assert float(m4.sum()) == 5 * 4


def test_cell_neighbor_list_overflow_counts_truncation():
    """The cell-list overflow includes K-truncated in-cutoff senders, not
    just capacity-dropped atoms."""
    from sake_tpu.sparse import cell_neighbor_list

    rng = np.random.RandomState(2)
    side, n = 9.0, 64
    x = jnp.asarray(rng.rand(1, n, 3) * side, jnp.float32)
    box = (side,) * 3
    # generous capacity, tiny K: overflow must equal the all-pairs count
    idx, m, ovf = cell_neighbor_list(
        x, 2.9, 2, box=box, cell_capacity=64, with_overflow=True
    )
    _, _, ovf_ap = neighbor_list(x, 2.9, 2, box=box, with_overflow=True)
    assert int(ovf[0]) == int(ovf_ap[0])
    # adequate K on the same geometry -> 0
    _, _, ovf_ok = cell_neighbor_list(
        x, 2.9, 32, box=box, cell_capacity=64, with_overflow=True
    )
    assert int(ovf_ok[0]) == 0


def test_rollout_overflow_surface_and_cell_capacity_guard(setup):
    from sake_tpu.md import neighborlist_verlet_rollout
    from sake_tpu.sparse import make_sparse_energy_forces

    kp, h, x = setup
    B, N = x.shape[:2]
    masses = jnp.ones((N,), jnp.float32)
    v0 = jnp.zeros_like(x)
    ef = make_sparse_energy_forces(h, update=False)
    out = jax.jit(
        lambda p, x_: neighborlist_verlet_rollout(
            ef, p, x_, v0, masses, 1e-3, 4,
            cutoff=2.5, max_neighbors=2, rebuild_every=2,
            with_overflow=True,
        )
    )(kp, x)
    assert len(out) == 4
    ovfs = out[3]
    assert ovfs.shape == (2, B)
    assert int(jnp.asarray(ovfs).max()) > 0  # K=2 truncates this cluster
    # adequate K reports clean
    _, _, _, ovfs_ok = jax.jit(
        lambda p, x_: neighborlist_verlet_rollout(
            ef, p, x_, v0, masses, 1e-3, 4,
            cutoff=2.5, max_neighbors=32, rebuild_every=2,
            with_overflow=True,
        )
    )(kp, x)
    assert int(jnp.asarray(ovfs_ok).max()) == 0
    # cell_capacity without a box must fail loudly
    with pytest.raises(ValueError, match="cell_capacity"):
        neighborlist_verlet_rollout(
            ef, kp, x, v0, masses, 1e-3, 4,
            cutoff=2.5, max_neighbors=8, cell_capacity=16,
        )


def test_cell_list_open_boundary_matches_allpairs():
    """periodic=False: the grid-binned build on an OPEN system (plain
    Euclidean distances, clipped stencil) == neighbor_list(box=None),
    including atoms OUTSIDE the grid extent (clipping is non-expansive,
    so no in-cutoff pair is missed) and padded atoms."""
    from sake_tpu.sparse import cell_neighbor_list

    rng = np.random.RandomState(7)
    B, N, K = 2, 300, 32
    extent = (12.0, 15.0, 13.0)
    # ~15% of atoms pushed outside the extent on purpose
    x = np.asarray(rng.rand(B, N, 3) * np.asarray(extent), np.float32)
    out = rng.rand(B, N) < 0.15
    x[out] += np.asarray([4.0, -3.0, 5.0], np.float32)
    x = jnp.asarray(x)

    i1, m1 = neighbor_list(x, 3.0, K)  # open all-pairs oracle
    i2, m2, ov = cell_neighbor_list(
        x, 3.0, K, box=extent, periodic=False, cell_capacity=96,
        with_overflow=True,
    )
    assert int(np.asarray(ov).max()) == 0
    assert jnp.all(
        densify_neighbors(i1, m1, N) == densify_neighbors(i2, m2, N)
    )

    nm = jnp.asarray((rng.rand(B, N) > 0.2).astype(np.float32))
    i1, m1 = neighbor_list(x, 3.0, K, node_mask=nm)
    i2, m2 = cell_neighbor_list(
        x, 3.0, K, box=extent, periodic=False, cell_capacity=96,
        node_mask=nm,
    )
    assert jnp.all(
        densify_neighbors(i1, m1, N) == densify_neighbors(i2, m2, N)
    )
    # small extent -> open all-pairs fallback (box must NOT leak in)
    i3, m3 = cell_neighbor_list(
        x, 6.0, K, box=(7.0, 7.0, 7.0), periodic=False
    )
    i4, m4 = neighbor_list(x, 6.0, K)
    assert jnp.all(
        densify_neighbors(i3, m3, N) == densify_neighbors(i4, m4, N)
    )


def test_rollout_cell_extent_open_matches_allpairs():
    """cell_extent= (open-boundary O(N) build) reproduces the all-pairs
    rollout trajectory exactly; cell_extent+box together is an error."""
    from sake_tpu.md import neighborlist_verlet_rollout
    from sake_tpu.sparse import make_sparse_energy_forces

    rng = np.random.RandomState(8)
    B, N, F = 1, 96, 4
    h = jnp.asarray(rng.randn(B, N, F), jnp.float32)
    x0 = jnp.asarray(rng.rand(B, N, 3) * 9.0, jnp.float32)
    v0 = jnp.zeros_like(x0)
    model = SAKEModel(hidden_features=8, out_features=1, depth=2)
    params = model.init(jax.random.PRNGKey(0), h[0], x0[0])
    kp = model_params_from_linen(params)
    ef = make_sparse_energy_forces(h)
    kw = dict(
        dt=5e-4, n_steps=4, cutoff=2.5, max_neighbors=16, rebuild_every=2,
    )
    masses = jnp.ones((N,))
    xs_a, _, es_a = neighborlist_verlet_rollout(
        ef, kp, x0, v0, masses, **kw
    )
    xs_c, _, es_c = neighborlist_verlet_rollout(
        ef, kp, x0, v0, masses,
        cell_capacity=64, cell_extent=(9.0, 9.0, 9.0), **kw
    )
    np.testing.assert_allclose(np.asarray(xs_a), np.asarray(xs_c), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(es_a), np.asarray(es_c), rtol=1e-6)
    with pytest.raises(ValueError, match="not both"):
        neighborlist_verlet_rollout(
            ef, kp, x0, v0, masses, box=(9.0,) * 3,
            cell_capacity=64, cell_extent=(9.0,) * 3, **kw
        )
