"""MD rollout tests: single-program scans, finite trajectories, and
approximate energy conservation under velocity Verlet."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sake_tpu.md import learned_integrator_rollout, velocity_verlet_rollout
from sake_tpu.models import SAKEModel


def _harmonic_ef(params, x):
    """Toy force field: isotropic springs to the origin (exactly solvable)."""
    e = 0.5 * (x**2).sum(axis=(-2, -1))
    return e, -x


def test_velocity_verlet_conserves_energy():
    rng = np.random.RandomState(0)
    x0 = jnp.asarray(rng.randn(5, 3), jnp.float32)
    v0 = jnp.asarray(rng.randn(5, 3), jnp.float32)
    m = jnp.ones(5)
    xs, vs, es = jax.jit(
        lambda x, v: velocity_verlet_rollout(
            _harmonic_ef, None, x, v, m, dt=0.01, n_steps=500, sample_every=50
        )
    )(x0, v0)
    assert xs.shape == (10, 5, 3)
    total = es + 0.5 * (vs**2).sum(axis=(-2, -1))
    drift = float(jnp.abs(total - total[0]).max() / total[0])
    assert drift < 1e-3, f"energy drift {drift}"


def test_learned_integrator_rollout():
    rng = np.random.RandomState(1)
    h = jnp.asarray(rng.randn(5, 4), jnp.float32)
    x0 = jnp.asarray(rng.randn(5, 3), jnp.float32)
    v0 = jnp.asarray(rng.randn(5, 3) * 0.1, jnp.float32)
    model = SAKEModel(hidden_features=8, out_features=1, depth=2, update=True)
    params = model.init(jax.random.PRNGKey(0), h, x0, v0)
    xs, vs = jax.jit(
        lambda p, h_, x_, v_: learned_integrator_rollout(
            model.apply, p, h_, x_, v_, n_steps=4
        )
    )(params, h, x0, v0)
    assert xs.shape == (4, 5, 3)
    assert bool(jnp.isfinite(xs).all() and jnp.isfinite(vs).all())
    # trajectory actually moves
    assert float(jnp.abs(xs[1] - xs[0]).max()) > 0
