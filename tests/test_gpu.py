"""Tests that need an NVIDIA GPU (marker ``gpu``).

Each test takes the ``gpu`` fixture, which decides at run time whether JAX
has a GPU and skips without one. On the card they run inside
``python chip_smoke.py`` (phase ``gpu_tests``), or alone with
``JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/test_gpu.py``.
Each compares a GPU result with the same computation on the host CPU at
HIGHEST matmul precision: the two differ only in summation order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sake_tpu.kernels import energy_and_forces_fn, init_model_params
from sake_tpu.sparse import (
    cell_neighbor_list,
    densify_neighbors,
    make_sparse_energy_forces,
    neighbor_list,
)

RTOL = 1e-5


@pytest.fixture
def gpu():
    device = jax.devices()[0]
    if device.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX reports {device.platform}")
    return device


def _on(device, tree):
    return jax.device_put(tree, device)


def _close(a, b):
    b = np.asarray(b)
    np.testing.assert_allclose(
        np.asarray(a), b, rtol=RTOL, atol=RTOL * np.abs(b).max()
    )


@pytest.mark.gpu
def test_default_device_is_the_gpu(gpu):
    y = jax.jit(lambda a: a @ a.T)(jnp.ones((64, 64)))
    assert y.devices() == {gpu}
    assert float(y[0, 0]) == 64.0


@pytest.mark.gpu
def test_dense_energy_forces_match_cpu(gpu):
    rng = np.random.RandomState(0)
    h = jnp.asarray(rng.rand(8, 21, 4), jnp.float32)
    x = jnp.asarray(rng.randn(8, 21, 3) * 1.5, jnp.float32)
    p = init_model_params(
        jax.random.PRNGKey(0), 4, hidden_features=32, depth=3, n_heads=4
    )
    ef = jax.jit(energy_and_forces_fn)
    cpu = jax.devices("cpu")[0]
    with jax.default_matmul_precision("highest"):
        e_g, f_g = ef(*_on(gpu, (p, h, x)))
        e_c, f_c = ef(*_on(cpu, (p, h, x)))
    _close(e_g, e_c)
    _close(f_g, f_c)


@pytest.mark.gpu
@pytest.mark.parametrize("periodic", [False, True])
def test_neighbor_lists_match_cpu(gpu, periodic):
    """``lax.top_k`` and the sort-based cell list select the same graph on
    the GPU as on the CPU."""
    rng = np.random.RandomState(1)
    side = 24.0
    x = jnp.asarray(rng.rand(1, 512, 3) * side, jnp.float32)
    box = (side,) * 3 if periodic else None
    cpu = jax.devices("cpu")[0]
    for build in (
        lambda x_: neighbor_list(x_, 5.0, 48, box=box),
        lambda x_: cell_neighbor_list(
            x_, 5.0, 48, box=(side,) * 3, cell_capacity=48,
            periodic=periodic,
        ),
    ):
        idx_g, m_g = jax.jit(build)(_on(gpu, x))
        idx_c, m_c = jax.jit(build)(_on(cpu, x))
        np.testing.assert_array_equal(
            densify_neighbors(idx_g, m_g, 512), densify_neighbors(idx_c, m_c, 512)
        )


@pytest.mark.gpu
def test_sparse_energy_forces_match_cpu(gpu):
    rng = np.random.RandomState(2)
    side = 20.0
    box = jnp.asarray([side] * 3, jnp.float32)
    x = jnp.asarray(rng.rand(1, 400, 3) * side, jnp.float32)
    h = jax.nn.one_hot(jnp.asarray(rng.randint(0, 5, (1, 400))), 5)
    p = init_model_params(
        jax.random.PRNGKey(1), 5, hidden_features=32, depth=3, n_heads=4,
        update=False,
    )
    idx, m = neighbor_list(x, 5.0, 48, box=box)
    cpu = jax.devices("cpu")[0]
    with jax.default_matmul_precision("highest"):
        ef_g = jax.jit(make_sparse_energy_forces(
            _on(gpu, h), update=False, box=_on(gpu, box)))
        ef_c = jax.jit(make_sparse_energy_forces(
            _on(cpu, h), update=False, box=_on(cpu, box)))
        e_g, f_g = ef_g(*_on(gpu, (p, x, idx, m)))
        e_c, f_c = ef_c(*_on(cpu, (p, x, idx, m)))
    _close(e_g, e_c)
    _close(f_g, f_c)
