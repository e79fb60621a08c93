"""Train state: parameters + optimizer state + step, as a pytree.

A minimal, framework-owned equivalent of ``flax.training.train_state``
(which every reference harness used): a frozen dataclass registered with
``jax.tree_util``, so the whole state is a plain pytree that
``jit``/``shard_map`` can donate and shard, with no flax dependency.
``apply_fn`` and ``tx`` are static (treedef) fields.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import jax
import jax.numpy as jnp
import optax


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class TrainState:
    step: jax.Array
    params: Any
    opt_state: optax.OptState
    apply_fn: Callable = dataclasses.field(metadata=dict(static=True))
    tx: optax.GradientTransformation = dataclasses.field(
        metadata=dict(static=True)
    )

    def replace(self, **changes) -> "TrainState":
        return dataclasses.replace(self, **changes)

    def apply_gradients(self, grads) -> "TrainState":
        updates, new_opt_state = self.tx.update(grads, self.opt_state, self.params)
        new_params = optax.apply_updates(self.params, updates)
        return self.replace(
            step=self.step + 1, params=new_params, opt_state=new_opt_state
        )

    @classmethod
    def create(cls, *, apply_fn, params, tx) -> "TrainState":
        return cls(
            step=jnp.zeros((), jnp.int32),
            params=params,
            opt_state=tx.init(params),
            apply_fn=apply_fn,
            tx=tx,
        )
