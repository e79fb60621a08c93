"""Radial basis functions and cutoff envelopes.

The RBF expansion turns the scalar distance channel into a
``num_rbf``-wide feature axis — an elementwise map whose output feeds the
edge-model matmuls. Everything here is static-shape.
"""

from __future__ import annotations

import math
from typing import Callable

import jax
import jax.numpy as jnp
from flax import linen as nn


def cosine_cutoff(x: jax.Array, lower: float = 0.0, upper: float = 5.0) -> jax.Array:
    """Cosine cutoff envelope on distances.

    Smoothly decays from 1 at ``lower`` to 0 at ``upper`` and is exactly
    periodic-cosine shaped in between (reference: ``sake/utils.py:10-26``;
    note the reference computes — and discards — a windowed copy of ``x``;
    only the envelope is returned there too, so behavior matches).
    """
    return 0.5 * (
        jnp.cos(math.pi * (2.0 * (x - lower) / (upper - lower) + 1.0)) + 1.0
    )


def windowed_cosine_cutoff(
    x: jax.Array, lower: float = 0.0, upper: float = 5.0
) -> jax.Array:
    """Cosine cutoff that is also hard-zeroed outside ``(lower, upper)``.

    The envelope the reference *intended* (its window product is computed
    then discarded, ``sake/utils.py:24-26``); offered as the properly wired
    variant for new configs.
    """
    env = cosine_cutoff(x, lower, upper)
    window = (x < upper) & (x > lower)
    return env * window.astype(env.dtype)


class ExpNormalSmearing(nn.Module):
    """Learnable exponential-normal radial basis (PhysNet initialization).

    ``num_rbf`` Gaussians in ``exp(-alpha * r)`` space with learnable means
    and widths; ``alpha = 5 / (upper - lower)`` and means/betas initialized
    per PhysNet (https://pubs.acs.org/doi/10.1021/acs.jctc.9b00181).
    Reference: ``sake/utils.py:28-65``.
    """

    cutoff_lower: float = 0.0
    cutoff_upper: float = 5.0
    num_rbf: int = 50

    @nn.compact
    def __call__(self, dist: jax.Array) -> jax.Array:
        start = math.exp(-(self.cutoff_upper - self.cutoff_lower))
        init_means = jnp.linspace(start, 1.0, self.num_rbf)
        init_betas = jnp.full(
            (self.num_rbf,), (2.0 / self.num_rbf * (1.0 - start)) ** -2
        )
        means = self.param("means", nn.initializers.constant(init_means), (self.num_rbf,))
        betas = self.param("betas", nn.initializers.constant(init_betas), (self.num_rbf,))
        alpha = 5.0 / (self.cutoff_upper - self.cutoff_lower)
        z = jnp.exp(alpha * (self.cutoff_lower - dist)) - means
        return jnp.exp(-betas * z**2)


CutoffFn = Callable[[jax.Array], jax.Array]
