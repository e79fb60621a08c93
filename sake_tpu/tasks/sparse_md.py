"""Large-system MD production on the cutoff-sparse path.

The capability the reference never reached: its systems top out at ~30
atoms (``scripts/md17``), and its intended sparse layer is vestigial
(``sake/layers.py``'s broken ``SparseSAKELayer``). This workload runs a
SAKE force field over thousands of atoms with O(N·K) work
(``sake_tpu.sparse``) and integrates velocity-Verlet entirely on device
with periodic neighbor-list rebuilds (``md.neighborlist_verlet_rollout``
— one scanned XLA program per rollout block).

The force field is the functional ``ModelParams`` model, freshly
initialized from ``seed`` (the throughput and stability numbers are
force-field-independent), or restored from ``checkpoint_dir``: a linen
``SAKEModel`` parameter tree saved with ``train.Checkpointer``, converted
by ``kernels.model_params_from_linen``. Without a checkpoint the task
needs neither flax nor orbax.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from sake_tpu.kernels.functional import init_model_params
from sake_tpu.md import neighborlist_verlet_rollout
from sake_tpu.sparse import make_sparse_energy_forces
from sake_tpu.train.metrics import MetricLogger


@dataclass
class SparseMDConfig:
    # system
    n_atoms: int = 4096
    n_species: int = 5
    density: float = 0.05  # atoms per unit volume (sets the box side)
    periodic: bool = False  # minimum-image PBC over the density-derived box
    mass: float = 12.0
    v0_scale: float = 0.05  # initial Maxwell-ish velocity scale
    # model
    hidden_features: int = 64
    depth: int = 6
    n_heads: int = 4
    checkpoint_dir: Optional[str] = None  # restore linen-trained params
    # neighborlist
    cutoff: float = 5.0
    max_neighbors: int = 64
    skin: float = 0.5
    rebuild_every: int = 10
    # None = O(N²) all-pairs build; an int selects the O(N·27·cap)
    # cell-list build (periodic boxes only)
    cell_capacity: Optional[int] = None
    # integration
    dt: float = 1e-3
    n_steps: int = 100
    remat: bool = True
    seed: int = 0


def synthesize_box(cfg: SparseMDConfig):
    """Seeded amorphous box: ``(h (1, N, n_species), x (1, N, 3),
    v0 (1, N, 3), box (3,) or None)``."""
    rng = np.random.RandomState(cfg.seed)
    side = (cfg.n_atoms / cfg.density) ** (1.0 / 3.0)
    box = jnp.asarray([side] * 3, jnp.float32) if cfg.periodic else None
    x = jnp.asarray(rng.rand(1, cfg.n_atoms, 3) * side, jnp.float32)
    species = rng.randint(0, cfg.n_species, (1, cfg.n_atoms))
    h = jax.nn.one_hot(jnp.asarray(species), cfg.n_species).astype(
        jnp.float32
    )
    v0 = jnp.asarray(
        rng.randn(1, cfg.n_atoms, 3) * cfg.v0_scale, jnp.float32
    )
    return h, x, v0, box


def init_params(cfg: SparseMDConfig):
    """Seeded cutoff force field (no velocity updates: the graph is fixed
    through each force evaluation)."""
    return init_model_params(
        jax.random.PRNGKey(cfg.seed), cfg.n_species,
        hidden_features=cfg.hidden_features, depth=cfg.depth,
        n_heads=cfg.n_heads, update=False,
    )


def run(cfg: SparseMDConfig, logger: Optional[MetricLogger] = None):
    logger = logger or MetricLogger()
    h, x, v0, box = synthesize_box(cfg)

    if cfg.checkpoint_dir is not None:
        from sake_tpu.kernels.adapter import model_params_from_linen
        from sake_tpu.train.checkpoint import Checkpointer

        with Checkpointer(cfg.checkpoint_dir) as ckpt:
            kp = model_params_from_linen(ckpt.restore(None))
    else:
        kp = init_params(cfg)

    masses = jnp.full((cfg.n_atoms,), cfg.mass, jnp.float32)
    ef = make_sparse_energy_forces(
        h, n_heads=cfg.n_heads, update=False, remat=cfg.remat, box=box
    )

    @jax.jit
    def rollout(p, x_, v_):
        return neighborlist_verlet_rollout(
            ef, p, x_, v_, masses, cfg.dt, cfg.n_steps,
            cutoff=cfg.cutoff, max_neighbors=cfg.max_neighbors,
            rebuild_every=cfg.rebuild_every, skin=cfg.skin, box=box,
            cell_capacity=cfg.cell_capacity if cfg.periodic else None,
            with_overflow=True,
        )

    t0 = time.time()
    xs, vs, es, ovfs = jax.block_until_ready(rollout(kp, x, v0))
    compile_s = time.time() - t0
    t1 = time.time()
    xs, vs, es, ovfs = jax.block_until_ready(rollout(kp, x, v0))
    run_s = time.time() - t1

    es = np.asarray(es)[:, 0]
    steps_per_s = cfg.n_steps / run_s
    results = {
        "steps_per_s": round(steps_per_s, 2),
        "atom_steps_per_s": round(steps_per_s * cfg.n_atoms, 1),
        "compile_s": round(compile_s, 1),
        "energy_first": float(es[0]),
        "energy_last": float(es[-1]),
        "energy_drift_abs": float(abs(es[-1] - es[0])),
        "finite": bool(np.isfinite(np.asarray(xs)).all()),
        # dropped neighbors at the worst rebuild: nonzero means the
        # trajectory ran on a truncated graph — raise max_neighbors (or
        # cell_capacity) until this stays 0
        "max_nbr_overflow": int(np.asarray(ovfs).max()),
        "n_atoms": cfg.n_atoms,
    }
    logger.log(cfg.n_steps, **results)
    return (xs, vs, es), results


if __name__ == "__main__":
    _, res = run(SparseMDConfig(n_atoms=2048, n_steps=40))
    print(res)
