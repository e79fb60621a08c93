"""Data-parallel correctness on an 8-fake-device CPU mesh — the distributed
test tier the reference lacked (its multi-device path was only ever "tested"
on clusters)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from sake_tpu.models import SAKEModel
from sake_tpu.parallel import (
    make_dp_epoch,
    make_dp_step,
    make_mesh,
    replicate_state,
    shard_batch,
)
from sake_tpu.train import TrainState


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) == 8, "conftest must provide 8 fake devices"
    return make_mesh()


def _setup(batch=16, n=5, f=4, hidden=8):
    rng = np.random.RandomState(0)
    h = jnp.asarray(rng.randn(batch, n, f), jnp.float32)
    x = jnp.asarray(rng.randn(batch, n, 3), jnp.float32)
    y = jnp.asarray(rng.randn(batch, 1), jnp.float32)
    model = SAKEModel(hidden_features=hidden, out_features=1, depth=2, update=False)
    params = model.init(jax.random.PRNGKey(0), h[0], x[0])

    def loss_fn(params, batch):
        out, _, _ = model.apply(params, batch["h"], batch["x"])
        pred = out.sum(axis=-2)
        return ((pred - batch["y"]) ** 2).mean()

    return model, params, loss_fn, {"h": h, "x": x, "y": y}


def test_mesh_shapes(mesh):
    assert mesh.shape == {"data": 8}


def test_dp_step_matches_single_device(mesh):
    """One shard_map DP step must equal the equivalent single-device step
    (same loss, same updated params)."""
    model, params, loss_fn, batch = _setup()
    tx = optax.sgd(1e-2)
    state = TrainState.create(apply_fn=model.apply, params=params, tx=tx)

    # single-device reference
    loss_ref, grads_ref = jax.value_and_grad(loss_fn)(state.params, batch)
    state_ref = state.apply_gradients(grads_ref)

    # data-parallel
    dp_step = make_dp_step(loss_fn, mesh)
    state_dp = replicate_state(state, mesh)
    batch_dp = shard_batch(batch, mesh)
    state_dp, loss_dp = jax.jit(dp_step)(state_dp, batch_dp)

    np.testing.assert_allclose(float(loss_dp), float(loss_ref), rtol=1e-5)
    jax.tree.map(
        lambda a, b: np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6),
        jax.device_get(state_dp.params),
        jax.device_get(state_ref.params),
    )


def test_dp_epoch_on_device(mesh):
    """A whole scanned epoch inside shard_map runs and reduces loss."""
    model, params, loss_fn, data = _setup(batch=64)
    tx = optax.adam(1e-2)
    state = TrainState.create(apply_fn=model.apply, params=params, tx=tx)
    # (n_batches=4, global_batch=16, ...)
    batches = jax.tree.map(
        lambda a: a.reshape(4, 16, *a.shape[1:]), data
    )
    dp_epoch = make_dp_epoch(loss_fn, mesh)
    state_dp = replicate_state(state, mesh)
    run = jax.jit(dp_epoch)
    losses_first = None
    for _ in range(10):
        state_dp, losses = run(state_dp, batches)
        if losses_first is None:
            losses_first = float(losses[0])
    assert float(losses[-1]) < losses_first, "loss must decrease over epochs"


def test_dp_grads_average_not_sum(mesh):
    """Scaling check: the DP update on a replicated batch equals the
    single-device update on one shard (pmean, not psum)."""
    model, params, loss_fn, batch = _setup(batch=8)
    # identical data on every shard
    batch_rep = jax.tree.map(lambda a: jnp.tile(a[:1], (8,) + (1,) * (a.ndim - 1)), batch)
    tx = optax.sgd(1e-2)
    state = TrainState.create(apply_fn=model.apply, params=params, tx=tx)

    one = jax.tree.map(lambda a: a[:1], batch)
    loss_ref, grads_ref = jax.value_and_grad(loss_fn)(state.params, one)
    state_ref = state.apply_gradients(grads_ref)

    dp_step = make_dp_step(loss_fn, mesh)
    state_dp, loss_dp = jax.jit(dp_step)(
        replicate_state(state, mesh), shard_batch(batch_rep, mesh)
    )
    np.testing.assert_allclose(float(loss_dp), float(loss_ref), rtol=1e-5)
    jax.tree.map(
        lambda a, b: np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6),
        jax.device_get(state_dp.params),
        jax.device_get(state_ref.params),
    )


def test_tp_model_forward_matches_dense(mesh):
    """Coefficient-axis tensor parallelism (tp_model_forward) must equal
    the dense functional model — masked and unmasked — on a model-axis
    mesh."""
    from sake_tpu.kernels import model_forward, model_params_from_linen
    from sake_tpu.models import SAKEModel
    from sake_tpu.parallel import make_mesh, tp_model_forward

    rng = np.random.RandomState(11)
    B, N, F = 2, 6, 5
    h = jnp.asarray(rng.randn(B, N, F), jnp.float32)
    x = jnp.asarray(rng.randn(B, N, 3), jnp.float32)
    model = SAKEModel(hidden_features=16, out_features=1, depth=2)
    params = model.init(jax.random.PRNGKey(0), h[0], x[0])
    kp = model_params_from_linen(params)
    tp_mesh = make_mesh((("model", -1),))

    out_d, x_d, _ = model_forward(kp, h, x)
    out_t, x_t = jax.jit(
        lambda h_, x_: tp_model_forward(kp, h_, x_, tp_mesh)
    )(h, x)
    np.testing.assert_allclose(out_t, out_d, rtol=5e-4, atol=5e-5)
    np.testing.assert_allclose(x_t, x_d, rtol=5e-4, atol=5e-5)

    node_mask = jnp.asarray((rng.rand(B, N) > 0.3).astype(np.float32))
    mask = node_mask[:, :, None] * node_mask[:, None, :]
    out_dm, x_dm, _ = model_forward(kp, h, x, mask=mask)
    out_tm, x_tm = jax.jit(
        lambda h_, x_, m_: tp_model_forward(kp, h_, x_, tp_mesh, mask=m_)
    )(h, x, mask)
    np.testing.assert_allclose(out_tm, out_dm, rtol=5e-4, atol=5e-5)
    np.testing.assert_allclose(x_tm, x_dm, rtol=5e-4, atol=5e-5)


def test_pp_model_forward_matches_dense(mesh):
    """Depth pipeline parallelism (pp_model_forward) must equal the dense
    functional model — unmasked, masked, mixed update schedule, and more
    microbatches than stages — on a 4-stage pipe mesh."""
    from sake_tpu.kernels import model_forward, model_params_from_linen
    from sake_tpu.parallel import make_mesh, pp_model_forward

    rng = np.random.RandomState(13)
    B, N, F = 8, 5, 4
    h = jnp.asarray(rng.randn(B, N, F), jnp.float32)
    x = jnp.asarray(rng.randn(B, N, 3), jnp.float32)
    model = SAKEModel(hidden_features=16, out_features=1, depth=4)
    params = model.init(jax.random.PRNGKey(0), h[0], x[0])
    kp = model_params_from_linen(params)
    pp_mesh = make_mesh((("pipe", 4),), devices=jax.devices()[:4])

    out_d, x_d, _ = model_forward(kp, h, x)
    out_p, x_p = jax.jit(
        lambda h_, x_: pp_model_forward(kp, h_, x_, pp_mesh)
    )(h, x)
    np.testing.assert_allclose(out_p, out_d, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(x_p, x_d, rtol=1e-5, atol=1e-6)

    # masked graphs travel the pipeline with their masks
    node_mask = jnp.asarray((rng.rand(B, N) > 0.3).astype(np.float32))
    mask = node_mask[:, :, None] * node_mask[:, None, :]
    out_dm, x_dm, _ = model_forward(kp, h, x, mask=mask)
    out_pm, x_pm = jax.jit(
        lambda h_, x_, m_: pp_model_forward(kp, h_, x_, pp_mesh, mask=m_)
    )(h, x, mask)
    np.testing.assert_allclose(out_pm, out_dm, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(x_pm, x_dm, rtol=1e-5, atol=1e-6)

    # per-layer update schedule as traced flags
    sched = [True, False, True, False]
    out_ds, x_ds, _ = model_forward(kp, h, x, update=sched)
    out_ps, x_ps = jax.jit(
        lambda h_, x_: pp_model_forward(kp, h_, x_, pp_mesh, update=sched)
    )(h, x)
    np.testing.assert_allclose(out_ps, out_ds, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(x_ps, x_ds, rtol=1e-5, atol=1e-6)

    # M > S shrinks the bubble; result must be identical
    out_p8, x_p8 = jax.jit(
        lambda h_, x_: pp_model_forward(
            kp, h_, x_, pp_mesh, n_microbatches=8
        )
    )(h, x)
    np.testing.assert_allclose(out_p8, out_d, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(x_p8, x_d, rtol=1e-5, atol=1e-6)


def test_pp_grad_through_pipeline(mesh):
    """Force training through the pipeline: grad of the pipelined energy
    w.r.t. positions (through scan + ppermute + psum) must equal the dense
    gradient."""
    from sake_tpu.kernels import model_forward, model_params_from_linen
    from sake_tpu.parallel import make_mesh, pp_model_forward

    rng = np.random.RandomState(14)
    B, N, F = 4, 5, 4
    h = jnp.asarray(rng.randn(B, N, F), jnp.float32)
    x = jnp.asarray(rng.randn(B, N, 3), jnp.float32)
    model = SAKEModel(hidden_features=16, out_features=1, depth=2)
    params = model.init(jax.random.PRNGKey(0), h[0], x[0])
    kp = model_params_from_linen(params)
    pp_mesh = make_mesh((("pipe", 2),), devices=jax.devices()[:2])

    def e_dense(x_):
        out, _, _ = model_forward(kp, h, x_)
        return out.sum()

    def e_pipe(x_):
        out, _ = pp_model_forward(kp, h, x_, pp_mesh, n_microbatches=4)
        return out.sum()

    g_d = jax.grad(e_dense)(x)
    g_p = jax.jit(jax.grad(e_pipe))(x)
    np.testing.assert_allclose(g_p, g_d, rtol=1e-4, atol=1e-6)


def test_pp_dp_2d_mesh(mesh):
    """PP x DP on one 2D (data=2, pipe=4) mesh: each data shard runs an
    independent depth pipeline; forward and position gradient must equal
    the dense model."""
    from sake_tpu.kernels import model_forward, model_params_from_linen
    from sake_tpu.parallel import make_mesh, pp_model_forward

    rng = np.random.RandomState(15)
    B, N, F = 8, 5, 4
    h = jnp.asarray(rng.randn(B, N, F), jnp.float32)
    x = jnp.asarray(rng.randn(B, N, 3), jnp.float32)
    model = SAKEModel(hidden_features=16, out_features=1, depth=4)
    params = model.init(jax.random.PRNGKey(0), h[0], x[0])
    kp = model_params_from_linen(params)
    mesh2d = make_mesh((("data", 2), ("pipe", 4)))

    node_mask = jnp.asarray((rng.rand(B, N) > 0.3).astype(np.float32))
    mask = node_mask[:, :, None] * node_mask[:, None, :]

    out_d, x_d, _ = model_forward(kp, h, x, mask=mask)
    out_p, x_p = jax.jit(
        lambda h_, x_, m_: pp_model_forward(
            kp, h_, x_, mesh2d, data_axis="data", mask=m_,
            n_microbatches=4,
        )
    )(h, x, mask)
    np.testing.assert_allclose(out_p, out_d, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(x_p, x_d, rtol=1e-5, atol=1e-6)

    def e_dense(x_):
        out, _, _ = model_forward(kp, h, x_, mask=mask)
        return out.sum()

    def e_pipe(x_):
        out, _ = pp_model_forward(
            kp, h, x_, mesh2d, data_axis="data", mask=mask,
            n_microbatches=4,
        )
        return out.sum()

    g_d = jax.grad(e_dense)(x)
    g_p = jax.jit(jax.grad(e_pipe))(x)
    np.testing.assert_allclose(g_p, g_d, rtol=1e-4, atol=1e-6)


def test_pp_tp_dp_3d_mesh(mesh):
    """Full 3D parallelism on one (data=2, pipe=2, model=2) mesh: depth
    pipelined over ``pipe``, each stage's layer body coefficient-sharded
    over ``model`` (tp_layer_forward), microbatches sharded over ``data``.
    Forward and position gradient must equal the dense model."""
    from sake_tpu.kernels import model_forward, model_params_from_linen
    from sake_tpu.parallel import make_mesh, pp_model_forward

    rng = np.random.RandomState(16)
    B, N, F = 8, 5, 4
    h = jnp.asarray(rng.randn(B, N, F), jnp.float32)
    x = jnp.asarray(rng.randn(B, N, 3), jnp.float32)
    model = SAKEModel(hidden_features=16, out_features=1, depth=2)
    params = model.init(jax.random.PRNGKey(0), h[0], x[0])
    kp = model_params_from_linen(params)
    mesh3d = make_mesh((("data", 2), ("pipe", 2), ("model", 2)))

    node_mask = jnp.asarray((rng.rand(B, N) > 0.3).astype(np.float32))
    mask = node_mask[:, :, None] * node_mask[:, None, :]

    out_d, x_d, _ = model_forward(kp, h, x, mask=mask)
    out_p, x_p = jax.jit(
        lambda h_, x_, m_: pp_model_forward(
            kp, h_, x_, mesh3d, data_axis="data", model_axis="model",
            mask=m_, n_microbatches=4,
        )
    )(h, x, mask)
    np.testing.assert_allclose(out_p, out_d, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(x_p, x_d, rtol=1e-5, atol=1e-6)

    def e_pipe(x_):
        out, _ = pp_model_forward(
            kp, h, x_, mesh3d, data_axis="data", model_axis="model",
            mask=mask, n_microbatches=4,
        )
        return out.sum()

    def e_dense(x_):
        out, _, _ = model_forward(kp, h, x_, mask=mask)
        return out.sum()

    g_d = jax.grad(e_dense)(x)
    g_p = jax.jit(jax.grad(e_pipe))(x)
    np.testing.assert_allclose(g_p, g_d, rtol=1e-4, atol=1e-6)
