"""The functional model (``sake_tpu.kernels``): its forward and E+F must
match the linen model, and ``init_model_params`` must build the tree that
``model_params_from_linen`` gives for a linen init, with the same initial
distributions."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sake_tpu.kernels import (
    energy_and_forces_fn,
    init_model_params,
    model_forward,
    model_params_from_linen,
)
from sake_tpu.models import SAKEModel

TOL = dict(rtol=2e-4, atol=2e-5)


@pytest.fixture(scope="module")
def setup():
    rng = np.random.RandomState(0)
    B, N, F = 4, 7, 5
    h = jnp.asarray(rng.randn(B, N, F), jnp.float32)
    x = jnp.asarray(rng.randn(B, N, 3), jnp.float32)
    model = SAKEModel(hidden_features=16, out_features=1, depth=3)
    params = model.init(jax.random.PRNGKey(0), h, x)
    kp = model_params_from_linen(params)
    return model, params, kp, h, x


def test_functional_model_matches_linen(setup):
    model, params, kp, h, x = setup
    rh, rx, rv = model.apply(params, h, x)
    oh, ox, ov = model_forward(kp, h, x)
    np.testing.assert_allclose(oh, rh, **TOL)
    np.testing.assert_allclose(ox, rx, **TOL)
    np.testing.assert_allclose(ov, rv, **TOL)


def test_functional_model_masked(setup):
    model, params, kp, h, x = setup
    rng = np.random.RandomState(1)
    node_mask = jnp.asarray(rng.rand(*h.shape[:2]) > 0.3, jnp.float32)
    mask = node_mask[..., :, None] * node_mask[..., None, :]
    rh, rx, rv = model.apply(params, h, x, None, mask)
    oh, ox, ov = model_forward(kp, h, x, mask=mask)
    m = node_mask[..., None]
    np.testing.assert_allclose(oh * m, rh * m, **TOL)
    np.testing.assert_allclose(ox * m, rx * m, **TOL)


def test_staged_vjp_forces_match_autodiff(setup):
    """``energy_and_forces_fn`` must equal jax.grad of the linen model's
    energy."""
    model, params, kp, h, x = setup

    def energy(x_):
        out, _, _ = model.apply(params, h, x_)
        return out.sum(), out.sum(axis=(-2, -1))

    (_, e_ref), g = jax.value_and_grad(energy, has_aux=True)(x)
    e, f = energy_and_forces_fn(kp, h, x)
    np.testing.assert_allclose(e, e_ref, **TOL)
    np.testing.assert_allclose(f, -g, **TOL)


def test_staged_vjp_with_update_schedule(setup):
    _, _, _, h, x = setup
    model = SAKEModel(
        hidden_features=16, out_features=1, depth=3, update=[False, True, False]
    )
    params = model.init(jax.random.PRNGKey(2), h, x)
    kp = model_params_from_linen(params)

    def energy(x_):
        out, _, _ = model.apply(params, h, x_)
        return out.sum(), out.sum(axis=(-2, -1))

    (_, e_ref), g = jax.value_and_grad(energy, has_aux=True)(x)
    e, f = energy_and_forces_fn(kp, h, x, update=[False, True, False])
    np.testing.assert_allclose(e, e_ref, **TOL)
    np.testing.assert_allclose(f, -g, **TOL)


@pytest.mark.parametrize(
    "depth,n_heads,update",
    [
        (1, 1, True),
        (2, 4, True),
        (3, 2, [False, True, False]),
        (2, 4, False),
        (6, 4, True),
    ],
)
def test_init_model_params_matches_linen_tree(depth, n_heads, update):
    """Same pytree, shapes and dtypes as a converted linen init; the same
    deterministic leaves (RBF means/betas, zero biases, zero update-head
    placeholders); lecun-normal kernels."""
    hidden, f_in = 32, 5
    model = SAKEModel(
        hidden_features=hidden, out_features=1, depth=depth,
        n_heads=n_heads, update=update,
    )
    # with an input velocity, linen creates every update layer's velocity
    # head (it builds modules on first use)
    ref = model_params_from_linen(
        model.init(
            jax.random.PRNGKey(0), jnp.ones((4, f_in)), jnp.ones((4, 3)),
            jnp.ones((4, 3)),
        )
    )
    got = init_model_params(
        jax.random.PRNGKey(0), f_in, hidden_features=hidden, depth=depth,
        n_heads=n_heads, update=update,
    )
    assert jax.tree.structure(got) == jax.tree.structure(ref)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(ref)):
        assert a.shape == b.shape and a.dtype == b.dtype

    kernels = {"w_embed", "w_in", "w_out0", "w_out1", "w_sem", "w_xmix",
               "w_post0", "w_post1", "w_node0", "w_node1", "w_vmix",
               "w_vel0", "w_vel1"}
    flat_got = jax.tree_util.tree_flatten_with_path(got)[0]
    flat_ref = jax.tree_util.tree_flatten_with_path(ref)[0]
    pooled = []  # standardized kernel entries: N(0, 1) truncated at 2 sd
    for (path, a), (_, b) in zip(flat_got, flat_ref):
        name = path[-1].name
        a, b = np.asarray(a), np.asarray(b)
        if name in kernels and b.any():
            pooled.append(a.ravel() * np.sqrt(a.shape[0]))
        else:  # biases, RBF constants, placeholders: identical values
            np.testing.assert_array_equal(a, b, err_msg=str(path))
    pooled = np.concatenate(pooled)
    assert np.abs(pooled).max() <= 2.0 / 0.87962566103423978 + 1e-5
    assert abs(pooled.std() - 1.0) < 0.05
    assert abs(pooled.mean()) < 0.05


def test_init_model_params_leaves_are_distinct_buffers():
    """No two leaves share a buffer, so a train state built on them can be
    donated to a jitted step."""
    p = init_model_params(
        jax.random.PRNGKey(0), 3, hidden_features=8, depth=3, n_heads=2
    )
    leaves = jax.tree.leaves(p)
    assert len({id(a) for a in leaves}) == len(leaves)
    expected = [np.asarray(a) + 1.0 for a in leaves]
    bump = jax.jit(lambda q: jax.tree.map(lambda a: a + 1.0, q), donate_argnums=0)
    for a, b in zip(jax.tree.leaves(bump(p)), expected):
        np.testing.assert_array_equal(a, b)
