"""The functional (``ModelParams``) task paths: the md17 and sparse_md
energy/forces against the linen model, and the workloads that must run
without flax or orbax installed."""

import pytest


def _linen_energy_forces(model, params, h, x, e_mean=0.0, e_std=1.0):
    import jax

    def e_sum(x_):
        out, _, _ = model.apply(params, h, x_)
        e = out.sum(axis=(-2, -1)) * e_std + e_mean
        return e.sum(), e

    (_, e), g = jax.value_and_grad(e_sum, has_aux=True)(x)
    return e[..., None], -g


@pytest.mark.parametrize("e_mean,e_std", [(0.0, 1.0), (1.5, 2.0)])
def test_md17_energy_forces_match_linen(e_mean, e_std):
    """The md17 task's E+F on ``ModelParams`` (converted from a linen
    init) equals the linen model's value_and_grad, de-standardization
    included."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from sake_tpu.data.md17 import ASPIRIN_Z, synthesize_md17
    from sake_tpu.kernels import model_params_from_linen
    from sake_tpu.models import SAKEModel
    from sake_tpu.tasks.md17 import make_energy_force_fn

    species = jax.nn.one_hot(ASPIRIN_Z, ASPIRIN_Z.max())
    x = jnp.asarray(synthesize_md17(4, seed=1).x)
    h = jnp.broadcast_to(species, (4, *species.shape))
    model = SAKEModel(hidden_features=16, out_features=1, depth=2)
    params = model.init(jax.random.PRNGKey(0), h[0], x[0])
    ef = make_energy_force_fn(4, species, e_mean, e_std)
    e, f = jax.jit(ef)(model_params_from_linen(params), x)
    e_ref, f_ref = _linen_energy_forces(model, params, h, x, e_mean, e_std)
    np.testing.assert_allclose(e, e_ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(f, f_ref, rtol=2e-4, atol=2e-5)


def test_md17_force_loss_grads_match_linen():
    """Second order: the md17 force-loss gradient on ``ModelParams``
    equals the linen gradient mapped through the adapter."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from sake_tpu.data.md17 import ASPIRIN_Z, synthesize_md17
    from sake_tpu.kernels import model_params_from_linen
    from sake_tpu.models import SAKEModel
    from sake_tpu.tasks.md17 import make_energy_force_fn, make_loss_fn

    species = jax.nn.one_hot(ASPIRIN_Z, ASPIRIN_Z.max())
    data = synthesize_md17(4, seed=2)
    batch = {"x": jnp.asarray(data.x), "e": jnp.asarray(data.e),
             "f": jnp.asarray(data.f)}
    h = jnp.broadcast_to(species, (4, *species.shape))
    model = SAKEModel(hidden_features=16, out_features=1, depth=2)
    params = model.init(jax.random.PRNGKey(0), h[0], batch["x"][0])
    loss = make_loss_fn(make_energy_force_fn(4, species, 0.0, 1.0), 1e-3)

    def linen_loss(p):
        e, f = _linen_energy_forces(model, p, h, batch["x"])
        return jnp.abs(f - batch["f"]).mean() + 1e-3 * jnp.abs(e - batch["e"]).mean()

    with jax.default_matmul_precision("highest"):
        g = jax.grad(loss)(model_params_from_linen(params), batch)
        g_ref = model_params_from_linen(jax.grad(linen_loss)(params))
    for a, b in zip(jax.tree.leaves(g), jax.tree.leaves(g_ref)):
        np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-6)


def test_sparse_md_energy_forces_match_linen():
    """The sparse_md force field on ``ModelParams``, on a neighbor list
    that holds every pair, equals the linen dense model's E+F."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from sake_tpu.kernels import model_params_from_linen
    from sake_tpu.models import SAKEModel
    from sake_tpu.sparse import make_sparse_energy_forces, neighbor_list
    from sake_tpu.tasks.sparse_md import SparseMDConfig, synthesize_box

    cfg = SparseMDConfig(n_atoms=32, density=0.2)
    h, x, _, _ = synthesize_box(cfg)
    model = SAKEModel(hidden_features=16, out_features=1, depth=2, update=False)
    params = model.init(jax.random.PRNGKey(0), h[0], x[0])
    idx, m = neighbor_list(x, 1e3, cfg.n_atoms - 1)
    assert float(m.sum()) == cfg.n_atoms * (cfg.n_atoms - 1)
    ef = make_sparse_energy_forces(h, update=False)
    e, f = jax.jit(ef)(model_params_from_linen(params), x, idx, m)
    e_ref, f_ref = _linen_energy_forces(model, params, h, x)
    np.testing.assert_allclose(e, e_ref[..., 0], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(f, f_ref, rtol=2e-4, atol=2e-5)


FLAX_FREE = {
    "md17": dict(hidden_features=8, depth=2, n_epochs=2, epochs_per_block=1,
                 n_train=16, n_valid=8, batch_size=4),
    "iso17": dict(hidden_features=8, depth=2, n_epochs=1, epochs_per_block=1,
                  n_train=8, batch_size=4),
    "sparse_md": dict(hidden_features=8, depth=2, n_atoms=64, n_steps=4,
                      rebuild_every=2, cutoff=4.0, max_neighbors=16,
                      periodic=True, cell_capacity=16),
    "sparse_train": dict(hidden_features=8, depth=2, n_atoms=48, n_steps=4,
                         steps_per_block=2, cutoff=4.0, max_neighbors=8),
}


@pytest.mark.parametrize("name", sorted(FLAX_FREE))
def test_workload_runs_without_flax_or_orbax(name):
    """``import sake_tpu`` and the functional workloads run in a process
    where flax and orbax cannot be imported."""
    import os
    import subprocess
    import sys

    code = (
        "import sys\n"
        "sys.modules['flax'] = None\n"
        "sys.modules['orbax'] = None\n"
        "import sake_tpu\n"
        "from sake_tpu.tasks.registry import get_workload\n"
        f"run, cfg = get_workload({name!r}, **{FLAX_FREE[name]!r})\n"
        "_, res = run(cfg)\n"
        "loaded = [m for m, v in sys.modules.items()\n"
        "          if v is not None and m.split('.')[0] in ('flax', 'orbax')]\n"
        "assert not loaded, loaded\n"
        "print('FLAX_FREE_OK')\n"
    )
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=repo, capture_output=True,
        text=True, timeout=600,
        env={**os.environ, "JAX_PLATFORMS": "cpu"},
    )
    assert proc.returncode == 0 and "FLAX_FREE_OK" in proc.stdout, (
        proc.stdout[-2000:] + proc.stderr[-4000:]
    )
