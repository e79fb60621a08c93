"""ISO17 energy+force fitting with in/out-of-distribution evaluation.

Capability match for ``scripts/iso17/{run,eval}.py``: same E+F loss as
MD17 (``iso17/run.py:60-71``), eval reported in meV (x1000,
``iso17/eval.py``) on both the within-distribution and other-molecules
test splits.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp

from sake_tpu.data.iso17 import load_iso17
from sake_tpu.tasks.md17 import init_params, make_energy_force_fn, make_step_fn
from sake_tpu.train import TrainState, make_optimizer, scan_epochs, warmup_cosine_schedule
from sake_tpu.train.metrics import MEV_PER_EV, MetricLogger, bootstrap_mae


@dataclass
class ISO17Config:
    hidden_features: int = 64
    depth: int = 6
    n_heads: int = 4
    learning_rate: float = 1e-4
    batch_size: int = 4
    n_train: int = 1000
    n_epochs: int = 50
    epochs_per_block: int = 10
    energy_loss_weight: float = 1e-3
    data_dir: Optional[str] = None
    seed: int = 2666


def run(cfg: ISO17Config, logger: Optional[MetricLogger] = None):
    logger = logger or MetricLogger()
    tr = load_iso17(cfg.data_dir, "reference", cfg.n_train + 200, seed=cfg.seed)
    te_within = load_iso17(cfg.data_dir, "test_within", 200, seed=cfg.seed)
    te_other = load_iso17(cfg.data_dir, "test_other", 200, seed=cfg.seed)

    x_tr, e_tr, f_tr = tr.x[: cfg.n_train], tr.e[: cfg.n_train], tr.f[: cfg.n_train]
    e_mean, e_std = float(e_tr.mean()), float(e_tr.std() + 1e-12)
    species = jax.nn.one_hot(tr.z, tr.z.max())

    total_steps = (cfg.n_train // cfg.batch_size) * cfg.n_epochs
    tx = make_optimizer(warmup_cosine_schedule(cfg.learning_rate, total_steps))
    ef_fn = make_energy_force_fn(cfg.n_heads, species, e_mean, e_std)
    state = TrainState.create(
        apply_fn=ef_fn, params=init_params(cfg, species.shape[-1]), tx=tx
    )

    step_fn = make_step_fn(ef_fn, cfg.energy_loss_weight)
    data = {"x": jnp.asarray(x_tr), "e": jnp.asarray(e_tr), "f": jnp.asarray(f_tr)}

    @partial(jax.jit, donate_argnums=0)
    def train_block(state):
        return scan_epochs(
            step_fn, state, data,
            batch_size=cfg.batch_size, n_epochs=cfg.epochs_per_block,
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

    ef_eval = jax.jit(ef_fn)
    results = {}
    for name, split in (("within", te_within), ("other", te_other)):
        e_pred, f_pred = ef_eval(state.params, jnp.asarray(split.x))
        e_mae = bootstrap_mae(e_pred * MEV_PER_EV, jnp.asarray(split.e) * MEV_PER_EV)
        f_mae = bootstrap_mae(
            f_pred.reshape(-1, 3) * MEV_PER_EV,
            jnp.asarray(split.f).reshape(-1, 3) * MEV_PER_EV,
        )
        results[f"{name}_e_mae_mev"] = e_mae[0]
        results[f"{name}_f_mae_mev"] = f_mae[0]
    logger.log(int(state.step), **results)
    return state, results


if __name__ == "__main__":
    run(ISO17Config(n_epochs=10, epochs_per_block=5, n_train=200))
