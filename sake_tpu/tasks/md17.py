"""MD17 energy+force fitting — the canonical hot path.

Capability match for ``scripts/md17/run.py`` (and its ``md17_traj``
checkpoint-series variant): one-hot species features, energy = colored sum
of node outputs, forces by differentiating the energy w.r.t. positions
(``F = -dE/dx``, ``run.py:54-58``), loss = F-MAE + 1e-3 * E-MAE, scanned
on-device epochs, periodic checkpointing, bootstrap-MAE eval in kcal/mol.

Differences from the reference harness:
- the model is the functional ``ModelParams`` pytree
  (``kernels.functional``), so the task needs neither flax nor orbax
  unless ``checkpoint_dir`` is set;
- energy and forces come from ONE forward+backward pass
  (``energy_and_forces_fn``; the reference ran separate jitted E and F
  evaluations inside the loss);
- epochs are ``lax.scan``-fused blocks with a donated state;
- checkpoints via Orbax (async, preemption-tolerant).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp

from sake_tpu.data.md17 import load_md17
from sake_tpu.kernels.functional import energy_and_forces_fn, init_model_params
from sake_tpu.train import (
    TrainState,
    make_optimizer,
    scan_epochs,
    warmup_cosine_schedule,
)
from sake_tpu.train.metrics import KCAL_PER_MOL, MetricLogger, bootstrap_mae


@dataclass
class MD17Config:
    molecule: str = "aspirin"
    hidden_features: int = 64
    depth: int = 6
    n_heads: int = 4
    learning_rate: float = 1e-4
    batch_size: int = 4
    n_train: int = 1000
    n_valid: int = 1000
    n_epochs: int = 100
    epochs_per_block: int = 10
    energy_loss_weight: float = 1e-3
    data_dir: Optional[str] = None
    checkpoint_dir: Optional[str] = None
    checkpoint_every_blocks: int = 1
    seed: int = 2666


def init_params(cfg, in_features: int):
    """The task's model: a SAKE energy model with velocity updates in
    every layer (``scripts/md17/run.py:40-44``)."""
    return init_model_params(
        jax.random.PRNGKey(cfg.seed), in_features,
        hidden_features=cfg.hidden_features, depth=cfg.depth,
        n_heads=cfg.n_heads, update=True,
    )


def make_energy_force_fn(n_heads: int, species_onehot, e_mean, e_std):
    """``(params, x (B, N, 3)) -> (E (B, 1), F (B, N, 3))`` with the
    energy de-standardized as ``E = std * sum_i out_i + mean`` (so
    ``F = std * f_raw``). Differentiable in ``params`` for force-loss
    training (second order)."""

    def energy_and_forces(params, x):
        h = jnp.broadcast_to(
            species_onehot, (*x.shape[:-1], species_onehot.shape[-1])
        ).astype(x.dtype)
        e, f = energy_and_forces_fn(params, h, x, n_heads=n_heads)
        return (e * e_std + e_mean)[..., None], f * e_std

    return energy_and_forces


def make_loss_fn(ef_fn, energy_loss_weight):
    """Force-matching loss ``F-MAE + w * E-MAE`` (``run.py:60-70``); its
    parameter gradient is second order (through ``F = -dE/dx``)."""

    def loss_fn(params, batch):
        e_pred, f_pred = ef_fn(params, batch["x"])
        e_loss = jnp.abs(e_pred - batch["e"]).mean()
        f_loss = jnp.abs(f_pred - batch["f"]).mean()
        return f_loss + energy_loss_weight * e_loss

    return loss_fn


def make_step_fn(ef_fn, energy_loss_weight):
    loss_fn = make_loss_fn(ef_fn, energy_loss_weight)

    def step(state, batch):
        loss, grads = jax.value_and_grad(loss_fn)(state.params, batch)
        return state.apply_gradients(grads), loss

    return step


def _optimizer(cfg: MD17Config):
    total_steps = (cfg.n_train // cfg.batch_size) * cfg.n_epochs
    return make_optimizer(warmup_cosine_schedule(cfg.learning_rate, total_steps))


def run(cfg: MD17Config, logger: Optional[MetricLogger] = None):
    logger = logger or MetricLogger()
    data = load_md17(cfg.molecule, cfg.data_dir, n_samples=cfg.n_train + 2 * cfg.n_valid)
    n_tr = cfg.n_train
    x_tr, e_tr, f_tr = data.x[:n_tr], data.e[:n_tr], data.f[:n_tr]
    x_vl = data.x[n_tr : n_tr + cfg.n_valid]
    e_vl = data.e[n_tr : n_tr + cfg.n_valid]
    f_vl = data.f[n_tr : n_tr + cfg.n_valid]

    e_mean, e_std = float(e_tr.mean()), float(e_tr.std())
    species = jax.nn.one_hot(data.z, data.z.max())

    ef_fn = make_energy_force_fn(cfg.n_heads, species, e_mean, e_std)
    ef_eval = jax.jit(ef_fn)
    state = TrainState.create(
        apply_fn=ef_fn,
        params=init_params(cfg, species.shape[-1]),
        tx=_optimizer(cfg),
    )
    step_fn = make_step_fn(ef_fn, cfg.energy_loss_weight)
    train_data = {
        "x": jnp.asarray(x_tr),
        "e": jnp.asarray(e_tr),
        "f": jnp.asarray(f_tr),
    }

    @partial(jax.jit, donate_argnums=0)
    def train_block(state):
        return scan_epochs(
            step_fn,
            state,
            train_data,
            batch_size=cfg.batch_size,
            n_epochs=cfg.epochs_per_block,
        )

    ckpt = None
    if cfg.checkpoint_dir:
        from sake_tpu.train.checkpoint import Checkpointer

        ckpt = Checkpointer(
            cfg.checkpoint_dir, keep_every_n=cfg.checkpoint_every_blocks
        )
    # kill-and-resume: restore the full train state from the latest
    # checkpoint (the reference's restart pattern, ani_mpi/run_mpi.py:110)
    if ckpt and ckpt.latest_step() is not None:
        template = jax.device_get(
            {"step": state.step, "params": state.params, "opt_state": state.opt_state}
        )
        restored = ckpt.restore(template)
        state = state.replace(
            step=jnp.asarray(restored["step"]),
            params=jax.tree.map(jnp.asarray, restored["params"]),
            opt_state=jax.tree.map(jnp.asarray, restored["opt_state"]),
        )
        logger.log(int(state.step), resumed_from=int(restored["step"]))

    n_blocks = cfg.n_epochs // cfg.epochs_per_block
    t0 = time.time()
    for block in range(n_blocks):
        state, losses = train_block(state)
        logger.log(
            int(state.step),
            epoch=(block + 1) * cfg.epochs_per_block,
            train_loss=float(jax.device_get(losses)[-1]),
            wall=round(time.time() - t0, 2),
        )
        if ckpt and (block + 1) % cfg.checkpoint_every_blocks == 0:
            ckpt.save(
                int(state.step),
                jax.device_get(
                    {"step": state.step, "params": state.params,
                     "opt_state": state.opt_state}
                ),
            )
    if ckpt:
        ckpt.wait()

    # eval: bootstrap MAE in kcal/mol (reference: md17/eval.py:78-85)
    e_pred, f_pred = ef_eval(state.params, jnp.asarray(x_vl))
    e_mae = bootstrap_mae(e_pred * KCAL_PER_MOL, jnp.asarray(e_vl) * KCAL_PER_MOL)
    f_mae = bootstrap_mae(
        f_pred.reshape(-1, 3) * KCAL_PER_MOL,
        jnp.asarray(f_vl).reshape(-1, 3) * KCAL_PER_MOL,
    )
    results = {
        "e_mae_kcalmol": e_mae[0],
        "e_mae_ci": (e_mae[1], e_mae[2]),
        "f_mae_kcalmol": f_mae[0],
        "f_mae_ci": (f_mae[1], f_mae[2]),
    }
    logger.log(int(state.step), **{k: v for k, v in results.items() if not isinstance(v, tuple)})
    return state, results


def select_best_checkpoint(cfg: MD17Config):
    """Checkpoint-series model selection (the md17_traj pattern,
    reference ``scripts/md17_traj/eval.py:60-78``): evaluate every saved
    checkpoint's validation force-MAE and return (best_step, best_params,
    per_step_mae)."""
    from sake_tpu.train.checkpoint import Checkpointer

    assert cfg.checkpoint_dir, "needs a checkpoint_dir"
    data = load_md17(cfg.molecule, cfg.data_dir, n_samples=cfg.n_train + 2 * cfg.n_valid)
    x_vl = jnp.asarray(data.x[cfg.n_train : cfg.n_train + cfg.n_valid])
    f_vl = jnp.asarray(data.f[cfg.n_train : cfg.n_train + cfg.n_valid])
    e_tr = data.e[: cfg.n_train]
    species = jax.nn.one_hot(data.z, data.z.max())
    ef_fn = jax.jit(
        make_energy_force_fn(
            cfg.n_heads, species, float(e_tr.mean()), float(e_tr.std())
        )
    )
    state_like = jax.device_get(
        TrainState.create(
            apply_fn=None,
            params=init_params(cfg, species.shape[-1]),
            tx=_optimizer(cfg),
        )
    )
    template = {
        "step": state_like.step,
        "params": state_like.params,
        "opt_state": state_like.opt_state,
    }
    scores = {}
    best = (None, None, float("inf"))
    with Checkpointer(cfg.checkpoint_dir) as ckpt:
        for step in ckpt.all_steps():
            params = ckpt.restore(template, step=step)["params"]
            _, f_pred = ef_fn(params, x_vl)
            mae = float(jnp.abs(f_pred - f_vl).mean())
            scores[step] = mae
            if mae < best[2]:
                best = (step, params, mae)
    return best[0], best[1], scores


if __name__ == "__main__":
    import sys

    molecule = sys.argv[1] if len(sys.argv) > 1 else "aspirin"
    run(MD17Config(molecule=molecule, n_epochs=20, epochs_per_block=5))
