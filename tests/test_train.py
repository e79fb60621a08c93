"""Training-subsystem tests: loops, optimizers, checkpointing, collation."""

import jax
import jax.numpy as jnp
import numpy as np

from sake_tpu.data.collate import (
    BucketedCollater,
    BucketedDataset,
    make_bucket_edges,
    pad_graphs,
)
from sake_tpu.train import (
    Checkpointer,
    TrainState,
    make_optimizer,
    notfinite_count,
    scan_epochs,
    shuffle_batches,
)


def _toy_state(lr=1e-1):
    params = {"w": jnp.ones((3,)), "b": jnp.zeros(())}

    def apply_fn(params, x):
        return x @ params["w"] + params["b"]

    tx = make_optimizer(lr, if_finite_patience=5)
    return TrainState.create(apply_fn=apply_fn, params=params, tx=tx)


def test_scan_epochs_learns():
    rng = np.random.RandomState(0)
    x = jnp.asarray(rng.randn(64, 3), jnp.float32)
    w_true = jnp.array([1.0, -2.0, 0.5])
    y = x @ w_true
    state = _toy_state()

    def step(state, batch):
        def loss_fn(p):
            return ((batch["x"] @ p["w"] + p["b"] - batch["y"]) ** 2).mean()

        loss, grads = jax.value_and_grad(loss_fn)(state.params)
        return state.apply_gradients(grads), loss

    state, losses = jax.jit(
        lambda s: scan_epochs(step, s, {"x": x, "y": y}, batch_size=16, n_epochs=20)
    )(state)
    assert float(losses[-1]) < 1e-2
    np.testing.assert_allclose(state.params["w"], w_true, atol=0.1)


def test_shuffle_batches_shapes_and_determinism():
    data = {"a": jnp.arange(10.0), "b": jnp.arange(20.0).reshape(10, 2)}
    out1 = shuffle_batches(jax.random.PRNGKey(0), data, 3)
    out2 = shuffle_batches(jax.random.PRNGKey(0), data, 3)
    assert out1["a"].shape == (3, 3)
    assert out1["b"].shape == (3, 3, 2)
    np.testing.assert_array_equal(out1["a"], out2["a"])


def test_apply_if_finite_skips_nan_updates():
    state = _toy_state()
    good = jax.tree.map(jnp.ones_like, state.params)
    bad = jax.tree.map(lambda a: jnp.full_like(a, jnp.nan), state.params)
    p0 = state.params
    state = state.apply_gradients(bad)
    # params unchanged after a NaN update
    jax.tree.map(
        lambda a, b: np.testing.assert_array_equal(a, b), state.params, p0
    )
    assert notfinite_count(state.opt_state) == 1
    state = state.apply_gradients(good)
    assert notfinite_count(state.opt_state) == 0  # reset on a finite step


def test_checkpointer_roundtrip(tmp_path):
    state = {"w": jnp.arange(4.0), "step": jnp.asarray(7)}
    with Checkpointer(str(tmp_path / "ckpt"), async_save=False) as ckpt:
        ckpt.save(1, state)
        ckpt.save(2, jax.tree.map(lambda a: a + 1, state))
        ckpt.wait()
        assert ckpt.latest_step() == 2
        restored = ckpt.restore(state)
    np.testing.assert_allclose(restored["w"], state["w"] + 1)


def test_checkpointer_sharded_roundtrip(tmp_path):
    """Orbax save/restore of a MESH-SHARDED state (the multi-host
    checkpoint story, SURVEY §5.4): values and shardings survive the
    roundtrip on the 8-fake-device backend."""
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    mesh = Mesh(np.asarray(jax.devices()).reshape(4, 2), ("data", "model"))
    sh_data = NamedSharding(mesh, P("data"))
    sh_repl = NamedSharding(mesh, P())
    state = {
        "w": jax.device_put(jnp.arange(32.0).reshape(8, 4), sh_data),
        "b": jax.device_put(jnp.ones((4,)), sh_repl),
        "step": jnp.asarray(3),
    }
    with Checkpointer(str(tmp_path / "ckpt"), async_save=False) as ckpt:
        ckpt.save(1, state)
        ckpt.wait()
        restored = ckpt.restore(state)
    np.testing.assert_array_equal(np.asarray(restored["w"]), state["w"])
    np.testing.assert_array_equal(np.asarray(restored["b"]), state["b"])
    assert restored["w"].sharding.is_equivalent_to(sh_data, 2)
    assert int(restored["step"]) == 3


def test_pad_graphs_masks():
    graphs = [
        {"x": np.ones((3, 3), np.float32)},
        {"x": np.full((5, 3), 2.0, np.float32)},
    ]
    out = pad_graphs(graphs)
    assert out["x"].shape == (2, 5, 3)
    np.testing.assert_array_equal(out["node_mask"][0], [1, 1, 1, 0, 0])
    assert out["edge_mask"].shape == (2, 5, 5)
    assert out["x"][0, 3:].sum() == 0  # padding is zero


def test_bucket_edges_bounded():
    sizes = list(range(4, 60))
    edges = make_bucket_edges(sizes, max_buckets=5)
    assert len(edges) <= 6
    assert max(edges) == 59


def test_bucketed_collater_uniform_shapes():
    rng = np.random.RandomState(0)
    samples = [
        {"z": np.ones(n, np.int32), "x": rng.randn(n, 3).astype(np.float32)}
        for n in rng.randint(4, 30, size=100)
    ]
    ds = BucketedDataset(samples, max_buckets=4)
    assert len(ds.buckets) <= 4
    collater = BucketedCollater(ds, batch_size=8)
    seen = 0
    for edge, batch in collater:
        assert batch["x"].shape == (8, edge, 3)
        seen += 1
    assert seen == collater.batches_per_epoch()
    assert seen > 0


class TestBucketedScanEpoch:
    """The bucketed path must make one dispatch per bucket group (not per
    batch) and match the per-batch loop exactly."""

    def _dataset(self):
        from sake_tpu.data.collate import BucketedCollater, BucketedDataset

        rng = np.random.RandomState(0)
        samples = []
        for n in [4] * 10 + [7] * 6:
            samples.append(
                {"z": rng.randint(1, 4, size=(n,)), "x": rng.randn(n, 3).astype(np.float32)}
            )
        ds = BucketedDataset(samples, max_buckets=2)
        return ds, BucketedCollater(ds, batch_size=2, seed=3)

    def test_epoch_groups_shapes_and_coverage(self):
        ds, collater = self._dataset()
        groups = list(collater.epoch_groups())
        assert len(groups) == len(ds.buckets)
        total = 0
        for edge, g in groups:
            n_b, bs = g["z"].shape[:2]
            assert bs == 2 and g["z"].shape[2] == edge
            assert g["x"].shape == (n_b, bs, edge, 3)
            total += n_b * bs
        assert total == sum(
            (n // 2) * 2 for n in ds.sizes().values()
        )

    def test_scanned_groups_match_per_batch_loop_and_dispatch_count(self):
        import jax
        import jax.numpy as jnp

        ds, collater = self._dataset()

        def step(w, batch):
            # toy "training": accumulate a deterministic statistic
            upd = (batch["x"].sum() + batch["z"].sum()) * 1e-3
            return w + upd, upd

        dispatches = []

        @jax.jit
        def scan_group(w, batches):
            return jax.lax.scan(step, w, batches)

        def scan_group_counted(w, batches):
            dispatches.append(1)
            return scan_group(w, batches)

        # same epoch twice (same collater seed state) requires two collaters
        _, c1 = self._dataset()
        _, c2 = self._dataset()

        w_loop = jnp.float32(0.0)
        n_batches = 0
        for e, g in c1.epoch_groups():
            for b in range(g["z"].shape[0]):
                w_loop, _ = step(
                    w_loop, {k: jnp.asarray(v[b]) for k, v in g.items()}
                )
                n_batches += 1

        w_scan = jnp.float32(0.0)
        for e, g in c2.epoch_groups():
            g = {k: jnp.asarray(v) for k, v in g.items()}
            w_scan, _ = scan_group_counted(w_scan, g)

        assert len(dispatches) == len(ds.buckets) < n_batches
        np.testing.assert_allclose(w_scan, w_loop, rtol=1e-6)

    def test_prefetch_to_device_passthrough(self):
        import jax.numpy as jnp

        from sake_tpu.data.collate import prefetch_to_device

        items = [("a", {"x": np.ones((2, 2), np.float32) * i}) for i in range(5)]
        out = list(prefetch_to_device(iter(items), size=2))
        assert [o[0] for o in out] == ["a"] * 5
        for i, (_, d) in enumerate(out):
            np.testing.assert_allclose(d["x"], np.ones((2, 2)) * i)
            assert isinstance(d["x"], jnp.ndarray)


# --- TrainState: a plain registered dataclass --------------------------------


def test_train_state_create_and_apply_gradients():
    import optax

    params = {"w": jnp.ones((3,)), "b": jnp.zeros(())}
    state = TrainState.create(apply_fn=None, params=params, tx=optax.sgd(0.5))
    assert int(state.step) == 0 and state.step.dtype == jnp.int32
    grads = {"w": jnp.full((3,), 2.0), "b": jnp.asarray(1.0)}
    state = state.apply_gradients(grads)
    assert int(state.step) == 1
    np.testing.assert_allclose(state.params["w"], [0.0, 0.0, 0.0])
    np.testing.assert_allclose(state.params["b"], -0.5)


def test_train_state_replace_is_functional():
    state = _toy_state()
    new = state.replace(step=jnp.asarray(5, jnp.int32))
    assert int(new.step) == 5 and int(state.step) == 0
    assert new.tx is state.tx and new.apply_fn is state.apply_fn
    with np.testing.assert_raises(Exception):
        state.step = jnp.asarray(1)  # frozen


def test_train_state_flatten_unflatten():
    """Only step, params and opt_state are leaves; apply_fn and tx ride in
    the treedef, so jit treats them as static."""
    state = _toy_state()
    leaves, treedef = jax.tree.flatten(state)
    n_opt = len(jax.tree.leaves(state.opt_state))
    assert len(leaves) == 1 + 2 + n_opt
    back = jax.tree.unflatten(treedef, leaves)
    assert back.apply_fn is state.apply_fn and back.tx is state.tx
    jax.tree.map(np.testing.assert_array_equal, back, state)
    doubled = jax.tree.map(lambda a: a * 2, state)
    np.testing.assert_array_equal(doubled.params["w"], 2 * state.params["w"])


def test_train_state_jit_with_donation():
    state = _toy_state()
    grads = jax.tree.map(jnp.ones_like, state.params)
    expected = state.apply_gradients(grads)
    step = jax.jit(lambda s, g: s.apply_gradients(g), donate_argnums=0)
    out = step(jax.tree.map(jnp.copy, state), grads)
    assert int(out.step) == 1
    jax.tree.map(np.testing.assert_allclose, out.params, expected.params)


def test_train_state_needs_no_flax():
    """The state module imports no flax (the main path runs without it)."""
    import subprocess
    import sys

    code = (
        "import sys; sys.modules['flax'] = None\n"
        "import optax, jax.numpy as jnp\n"
        "from sake_tpu.train.state import TrainState\n"
        "s = TrainState.create(apply_fn=None, params=jnp.ones(2), "
        "tx=optax.adam(1e-3))\n"
        "print(int(s.apply_gradients(jnp.ones(2)).step))\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=300,
    )
    assert proc.returncode == 0 and proc.stdout.strip() == "1", proc.stderr


# --- persistent compilation cache --------------------------------------------


def test_compile_cache_honours_env_var(monkeypatch, tmp_path):
    from sake_tpu import compile_cache

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.compile_cache_dir() == str(tmp_path)
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    # JAX reads the variable itself; nothing in code overrides it
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_defaults_to_repo_dir(monkeypatch):
    import os

    from sake_tpu import compile_cache

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        path = compile_cache.enable_compile_cache()
        assert path == os.path.join(repo, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
