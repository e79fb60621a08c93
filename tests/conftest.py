"""Test configuration: a CPU backend with 8 virtual devices.

Multi-device (shard_map) behavior is tested on a virtual CPU mesh. The
environment must be set before JAX initializes. ``JAX_PLATFORMS`` is only
defaulted: ``JAX_PLATFORMS=cuda,cpu`` runs the ``gpu``-marked tests on a
card (tests/test_gpu.py).
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def equivariance_ops():
    """Fixed inputs plus random translation/rotation/reflection operators.

    Mirrors the reference property fixture (``sake/tests/conftest.py:6-71``):
    rotation as Rz*Ry*Rx with random angles, reflection as a Householder
    ``I - 2 v v^T``.
    """
    rng = np.random.RandomState(2666)
    # 16 features: layer tests apply DenseSAKELayer directly, whose residual
    # node update requires input width == out_features (models embed first).
    h = jnp.asarray(rng.randn(5, 16), dtype=jnp.float32)
    x = jnp.asarray(rng.randn(5, 3), dtype=jnp.float32)
    v = jnp.asarray(rng.randn(5, 3), dtype=jnp.float32)

    translation = jnp.asarray(rng.randn(1, 3), dtype=jnp.float32)

    a, b, c = rng.uniform(-np.pi, np.pi, size=3)
    rz = np.array(
        [[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1]]
    )
    ry = np.array(
        [[np.cos(b), 0, np.sin(b)], [0, 1, 0], [-np.sin(b), 0, np.cos(b)]]
    )
    rx = np.array(
        [[1, 0, 0], [0, np.cos(c), -np.sin(c)], [0, np.sin(c), np.cos(c)]]
    )
    rotation = jnp.asarray(rz @ ry @ rx, dtype=jnp.float32)

    p = rng.randn(3, 1)
    p = p / np.linalg.norm(p)
    reflection = jnp.asarray(np.eye(3) - 2.0 * p @ p.T, dtype=jnp.float32)

    return h, x, v, translation, rotation, reflection
