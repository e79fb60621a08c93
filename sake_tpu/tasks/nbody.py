"""N-body charged-particle trajectory prediction.

Capability match for ``scripts/nbody/run.py``: predict terminal positions
x(t=40) from x, v at t=30 with a velocity-updating SAKE model (the model's
depth acts as learned integrator steps); terminal-position MSE loss.

Improvements over the reference harness:
- whole epochs run on-device as one XLA program (``scan_epochs`` with a
  donated train state) instead of a host loop around per-batch jits;
- dataclass config instead of argparse + shell sweeps;
- data synthesized on demand when the EGNN .npy files are absent.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp

from sake_tpu.data.nbody import load_nbody
from sake_tpu.models import SAKEModel
from sake_tpu.train import TrainState, make_optimizer, scan_epochs
from sake_tpu.train.metrics import MetricLogger


@dataclass
class NBodyConfig:
    hidden_features: int = 64
    depth: int = 4
    n_heads: int = 4
    learning_rate: float = 1e-3
    weight_decay: float = 1e-5
    batch_size: int = 100
    n_epochs: int = 100
    epochs_per_block: int = 10  # epochs fused into one on-device program
    n_train: int = 3000
    n_valid: int = 2000
    n_test: int = 2000
    data_dir: Optional[str] = None
    seed: int = 2666


def make_model(cfg: NBodyConfig) -> SAKEModel:
    return SAKEModel(
        hidden_features=cfg.hidden_features,
        out_features=1,
        depth=cfg.depth,
        n_heads=cfg.n_heads,
        update=True,
    )


def make_step_fn(model: SAKEModel):
    """One SGD step on a batch dict {h, x0, x1, v0}; scan-compatible."""

    def loss_fn(params, batch):
        _, x_hat, _ = model.apply(params, batch["h"], batch["x0"], batch["v0"])
        return ((x_hat - batch["x1"]) ** 2).mean()

    def step(state, batch):
        loss, grads = jax.value_and_grad(loss_fn)(state.params, batch)
        return state.apply_gradients(grads), loss

    return step


def evaluate(model, params, split) -> float:
    _, x_hat, _ = jax.jit(model.apply)(
        params, jnp.asarray(split.h), jnp.asarray(split.x0), jnp.asarray(split.v0)
    )
    return float(((x_hat - jnp.asarray(split.x1)) ** 2).mean())


def run(cfg: NBodyConfig, logger: Optional[MetricLogger] = None):
    logger = logger or MetricLogger()
    tr, vl, te = load_nbody(
        cfg.data_dir, cfg.n_train, cfg.n_valid, cfg.n_test, seed=cfg.seed
    )
    model = make_model(cfg)
    params = jax.jit(model.init)(
        jax.random.PRNGKey(cfg.seed),
        jnp.asarray(tr.h[0]),
        jnp.asarray(tr.x0[0]),
        jnp.asarray(tr.v0[0]),
    )
    tx = make_optimizer(cfg.learning_rate, weight_decay=cfg.weight_decay)
    state = TrainState.create(apply_fn=model.apply, params=params, tx=tx)

    data = {
        "h": jnp.asarray(tr.h),
        "x0": jnp.asarray(tr.x0),
        "x1": jnp.asarray(tr.x1),
        "v0": jnp.asarray(tr.v0),
    }
    step_fn = make_step_fn(model)

    @partial(jax.jit, donate_argnums=0)
    def train_block(state):
        return scan_epochs(
            step_fn,
            state,
            data,
            batch_size=cfg.batch_size,
            n_epochs=cfg.epochs_per_block,
        )

    n_blocks = cfg.n_epochs // cfg.epochs_per_block
    t0 = time.time()
    for block in range(n_blocks):
        state, losses = train_block(state)
        losses = jax.device_get(losses)
        logger.log(
            int(state.step),
            epoch=(block + 1) * cfg.epochs_per_block,
            train_loss=float(losses[-1]),
            wall=round(time.time() - t0, 2),
        )

    results = {
        "valid_mse": evaluate(model, state.params, vl),
        "test_mse": evaluate(model, state.params, te),
    }
    logger.log(int(state.step), **results)
    return state, results


if __name__ == "__main__":
    run(NBodyConfig(n_epochs=30, epochs_per_block=10))
