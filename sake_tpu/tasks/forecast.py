"""Trajectory forecasting tasks: CMU motion capture and MD17 forecasting.

Capability match for ``scripts/motion/run.py`` (full-batch training,
h = [|v|, joint identity]) and ``scripts/md17_forecast/run.py``
(velocity-conditioned position forecasting with an update=True model).
Both reduce to the same velocity-integrating regression the nbody task
uses, so they share its step machinery.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp

from sake_tpu.data.motion import (
    TrajectorySplit,
    load_motion,
    synthesize_md17_forecast,
)
from sake_tpu.models import SAKEModel
from sake_tpu.train import TrainState, make_optimizer, scan_epochs
from sake_tpu.train.metrics import MetricLogger


@dataclass
class ForecastConfig:
    workload: str = "motion"  # motion | md17_forecast
    hidden_features: int = 64
    depth: int = 4
    n_heads: int = 4
    learning_rate: float = 1e-3
    batch_size: int = 100
    n_epochs: int = 50
    epochs_per_block: int = 10
    n_samples: int = 600
    data_dir: Optional[str] = None
    seed: int = 2666


def run(cfg: ForecastConfig, logger: Optional[MetricLogger] = None):
    logger = logger or MetricLogger()
    if cfg.workload == "motion":
        split = load_motion(cfg.data_dir, cfg.n_samples, seed=cfg.seed)
    else:
        split = synthesize_md17_forecast(cfg.n_samples, seed=cfg.seed)
    n_tr = int(len(split.x0) * 0.8)
    tr = TrajectorySplit(*(a[:n_tr] for a in (split.h, split.x0, split.x1, split.v0)))
    te = TrajectorySplit(*(a[n_tr:] for a in (split.h, split.x0, split.x1, split.v0)))

    model = SAKEModel(
        hidden_features=cfg.hidden_features,
        out_features=1,
        depth=cfg.depth,
        n_heads=cfg.n_heads,
        update=True,
    )
    params = jax.jit(model.init)(
        jax.random.PRNGKey(cfg.seed),
        jnp.asarray(tr.h[0]),
        jnp.asarray(tr.x0[0]),
        jnp.asarray(tr.v0[0]),
    )
    tx = make_optimizer(cfg.learning_rate)

    def predict(p, h_, x0_, v0_):
        _, x_hat, _ = model.apply(p, h_, x0_, v0_)
        return x_hat

    state = TrainState.create(apply_fn=model.apply, params=params, tx=tx)

    def step_fn(state, batch):
        def loss_fn(params):
            x_hat = predict(params, batch["h"], batch["x0"], batch["v0"])
            return ((x_hat - batch["x1"]) ** 2).mean()

        loss, grads = jax.value_and_grad(loss_fn)(state.params)
        return state.apply_gradients(grads), loss

    data = {
        "h": jnp.asarray(tr.h),
        "x0": jnp.asarray(tr.x0),
        "x1": jnp.asarray(tr.x1),
        "v0": jnp.asarray(tr.v0),
    }

    @partial(jax.jit, donate_argnums=0)
    def train_block(state):
        return scan_epochs(
            step_fn, state, data,
            batch_size=min(cfg.batch_size, n_tr), n_epochs=cfg.epochs_per_block,
        )

    t0 = time.time()
    for block in range(cfg.n_epochs // cfg.epochs_per_block):
        state, losses = train_block(state)
        logger.log(
            int(state.step),
            epoch=(block + 1) * cfg.epochs_per_block,
            train_loss=float(jax.device_get(losses)[-1]),
            wall=round(time.time() - t0, 2),
        )

    x_hat = jax.jit(predict)(
        state.params, jnp.asarray(te.h), jnp.asarray(te.x0),
        jnp.asarray(te.v0)
    )
    results = {"test_mse": float(((x_hat - jnp.asarray(te.x1)) ** 2).mean())}
    logger.log(int(state.step), **results)
    return state, results


if __name__ == "__main__":
    import sys

    wl = sys.argv[1] if len(sys.argv) > 1 else "motion"
    run(ForecastConfig(workload=wl, n_epochs=10, epochs_per_block=5, n_samples=200))
