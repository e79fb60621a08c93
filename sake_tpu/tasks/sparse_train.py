"""Large-system force-matching training on the cutoff-sparse path.

The MD17 objective (force MAE + weighted energy MAE, F = −dE/dx —
``/root/reference/scripts/md17/run.py:54-70``) at cutoff-sparse scale:
thousands of atoms, O(N·K) work, the regime the reference never reached
(its force-trained systems top out at ~30 atoms and its sparse layer is
vestigial). This is the standard MLIP distillation/fine-tune workflow:
match the forces of a teacher force field (here: the same architecture
at independently initialized parameters; swap in DFT labels by feeding
your own targets) over an amorphous box.

The training gradient is double autodiff through
``sparse.sparse_model_forward(remat=True)``: the force loss's gradient
with respect to the parameters, of the position gradient of the energy.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
import optax

from sake_tpu.kernels.functional import init_model_params
from sake_tpu.sparse import neighbor_list, sparse_model_forward
from sake_tpu.train.metrics import MetricLogger


@dataclass
class SparseTrainConfig:
    # system
    n_atoms: int = 1024
    n_species: int = 5
    density: float = 0.05
    # model
    hidden_features: int = 64
    depth: int = 6
    n_heads: int = 4
    # neighborlist
    cutoff: float = 5.0
    max_neighbors: int = 48
    # objective
    energy_coef: float = 1e-3
    # training
    learning_rate: float = 1e-4
    n_steps: int = 100
    steps_per_block: int = 10  # scanned on device between log lines
    seed: int = 0


def run(cfg: SparseTrainConfig, logger: Optional[MetricLogger] = None):
    logger = logger or MetricLogger()
    rng = np.random.RandomState(cfg.seed)
    side = (cfg.n_atoms / cfg.density) ** (1.0 / 3.0)
    x = jnp.asarray(rng.rand(1, cfg.n_atoms, 3) * side, jnp.float32)
    h = jax.nn.one_hot(
        jnp.asarray(rng.randint(0, cfg.n_species, (1, cfg.n_atoms))),
        cfg.n_species,
    ).astype(jnp.float32)

    def init(seed):
        return init_model_params(
            jax.random.PRNGKey(seed), cfg.n_species,
            hidden_features=cfg.hidden_features, depth=cfg.depth,
            n_heads=cfg.n_heads, update=False,
        )

    kp, teacher = init(cfg.seed), init(cfg.seed + 1)

    idx, m = jax.jit(
        lambda x_: neighbor_list(x_, cfg.cutoff, cfg.max_neighbors)
    )(x)

    # teacher labels (exact lax tier, computed once)
    def _e_sum(p, x_):
        out, _, _ = sparse_model_forward(
            p, h, x_, idx, m, update=False, remat=True
        )
        e_b = out.sum(axis=(-2, -1))
        return e_b.sum(), e_b

    @jax.jit
    def _labels(p, x_):
        (_, e_b), neg_f = jax.value_and_grad(_e_sum, argnums=1,
                                             has_aux=True)(p, x_)
        return -neg_f, e_b

    f_t, e_t = jax.block_until_ready(_labels(teacher, x))

    def loss(p):
        (_, e_b), neg_f = jax.value_and_grad(
            _e_sum, argnums=1, has_aux=True
        )(p, x)
        return (
            jnp.abs(-neg_f - f_t).mean()
            + cfg.energy_coef * jnp.abs(e_b - e_t).mean()
        )

    tx = optax.adam(cfg.learning_rate)

    def _step(carry, _):
        p, opt = carry
        lval, grads = jax.value_and_grad(loss)(p)
        upd, opt = tx.update(grads, opt, p)
        return (optax.apply_updates(p, upd), opt), lval

    @jax.jit
    def block(p, opt):
        (p, opt), losses = jax.lax.scan(
            _step, (p, opt), None, length=cfg.steps_per_block
        )
        return p, opt, losses

    opt0 = tx.init(kp)
    t0 = time.time()
    all_losses = []
    p, opt = kp, opt0
    for b in range((cfg.n_steps + cfg.steps_per_block - 1)
                   // cfg.steps_per_block):
        p, opt, losses = block(p, opt)
        all_losses.append(np.asarray(losses))
        logger.log(
            (b + 1) * cfg.steps_per_block,
            train_loss=float(all_losses[-1].mean()),
            wall=round(time.time() - t0, 2),
        )
    flat = np.concatenate(all_losses)
    wall = time.time() - t0
    result = {
        "first_loss": float(flat[0]),
        "final_loss": float(flat[-1]),
        "loss_decreased": bool(flat[-1] < flat[0]),
        "finite": bool(np.isfinite(flat).all()),
        "steps_per_s": round(len(flat) / wall, 3),
        "atom_updates_per_s": round(len(flat) * cfg.n_atoms / wall, 1),
        "wall_s": round(wall, 1),
    }
    return p, result
