"""OC20 IS2RE catalyst energy regression — bucketed heterogeneous systems.

Capability match for ``scripts/oc20_batch/run.py``: per-atom readout
summed to system energy (``run.py:93-97``), one-hot over the discovered
element set (``run.py:76-81``), size-bucketed uniform-shape batches via
the shared collater. The ragged ``scripts/oc20`` variant is subsumed by
``max_buckets`` (raise it to approach per-size batching).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List, Optional, Union

import jax
import jax.numpy as jnp
import numpy as np

from sake_tpu.data.collate import (
    BucketedCollater,
    BucketedDataset,
    prefetch_to_device,
)
from sake_tpu.data.oc20 import load_oc20
from sake_tpu.data.ani import to_bucket_samples
from sake_tpu.tasks.ani import ANIModel, ANIConfig, _prep_batch
from sake_tpu.train import TrainState, make_optimizer
from sake_tpu.train.metrics import MetricLogger, bootstrap_mae


@dataclass
class OC20Config:
    hidden_features: int = 64
    depth: int = 6
    n_heads: int = 4
    update: Union[bool, List[bool]] = False
    learning_rate: float = 1e-4
    batch_size: int = 8
    n_epochs: int = 3
    n_samples: int = 512
    max_buckets: int = 5
    data_dir: Optional[str] = None
    seed: int = 2666
    # Large-system execution (bigsys): blocked online-softmax layers on a
    # single device; on a multi-device mesh, atom sharding with automatic
    # gather-vs-ring sender exchange (bigsys.sharded_model_forward,
    # crossover at RING_CROSSOVER_ATOMS). For catalyst systems too big
    # for the dense O(N^2) layer.
    use_bigsys: bool = False
    bigsys_mode: str = "auto"  # auto | gather | ring
    bigsys_block: int = 32
    # checkpoint the per-block scans so the TRAINING backward stays
    # O(N*block) memory like the forward (bigsys.blocked_layer_forward)
    bigsys_remat: bool = True


def run(cfg: OC20Config, logger: Optional[MetricLogger] = None):
    logger = logger or MetricLogger()
    samples = load_oc20(cfg.data_dir, cfg.n_samples, seed=cfg.seed)
    # element vocabulary discovered from a full data pass (oc20_batch/run.py:76-81)
    z_max = int(max(s["z"].max() for s in samples))
    n_classes = z_max + 1

    rng = np.random.RandomState(cfg.seed)
    order = rng.permutation(len(samples))
    n_tr = int(len(samples) * 0.9)
    tr = [samples[i] for i in order[:n_tr]]
    te = [samples[i] for i in order[n_tr:]]
    e_all = np.array([s["e"] for s in tr])
    e_mean, e_std = float(e_all.mean()), float(e_all.std() + 1e-8)

    ds_tr = BucketedDataset(to_bucket_samples(tr), max_buckets=cfg.max_buckets)
    ds_te = BucketedDataset(to_bucket_samples(te), max_buckets=cfg.max_buckets)
    collater = BucketedCollater(ds_tr, cfg.batch_size, seed=cfg.seed)

    mcfg = ANIConfig(
        hidden_features=cfg.hidden_features,
        depth=cfg.depth,
        n_heads=cfg.n_heads,
        update=cfg.update,
    )
    model = ANIModel(mcfg)
    _, first = next(iter(collater))
    b0 = _prep_batch(first, n_classes)
    params = jax.jit(model.init)(
        jax.random.PRNGKey(cfg.seed), b0["species"], b0["x"], b0["edge_mask"], b0["node_mask"]
    )
    tx = make_optimizer(cfg.learning_rate, zero_nans=True, if_finite_patience=None)

    if cfg.use_bigsys:
        from sake_tpu.bigsys import blocked_model_forward, sharded_model_forward
        from sake_tpu.kernels import model_params_from_linen
        from sake_tpu.parallel import make_mesh

        params = model_params_from_linen(params["params"]["backbone"])
        n_dev = len(jax.devices())
        mesh = make_mesh() if n_dev > 1 else None

        def forward(p, species, x, edge_mask, node_mask):
            n = x.shape[1]
            if mesh is not None and n % n_dev == 0:
                out, _ = sharded_model_forward(
                    p, species, x, mesh, mode=cfg.bigsys_mode,
                    n_heads=cfg.n_heads, update=cfg.update,
                    block_size=min(cfg.bigsys_block, n // n_dev),
                    node_mask=node_mask, remat=cfg.bigsys_remat,
                )
            else:
                bs_ = cfg.bigsys_block
                while n % bs_:
                    bs_ //= 2
                out, _, _ = blocked_model_forward(
                    p, species, x,
                    n_heads=cfg.n_heads, update=cfg.update,
                    block_size=max(bs_, 1), mask=edge_mask,
                    remat=cfg.bigsys_remat,
                )
            return (out[..., 0] * node_mask).sum(-1, keepdims=True)

    else:

        def forward(p, species, x, edge_mask, node_mask):
            return model.apply(p, species, x, edge_mask, node_mask)

    state = TrainState.create(apply_fn=model.apply, params=params, tx=tx)

    def loss_fn(params, batch):
        pred = forward(
            params, batch["species"], batch["x"], batch["edge_mask"], batch["node_mask"]
        )[..., 0]
        return ((pred - (batch["e"] - e_mean) / e_std) ** 2).mean()

    def _step(state, batch):
        loss, grads = jax.value_and_grad(loss_fn)(state.params, batch)
        return state.apply_gradients(grads), loss

    # scanned per-bucket groups + prefetch: <= max_buckets dispatches/epoch
    # (see tasks/ani.py; replaces the reference's per-batch host loop).
    @jax.jit
    def scan_group(state, batches):
        return jax.lax.scan(_step, state, batches)

    t0 = time.time()
    for epoch in range(cfg.n_epochs):
        feed = prefetch_to_device(
            ((e, _prep_batch(g, n_classes)) for e, g in collater.epoch_groups()),
            size=2,
        )
        group_losses = []
        for _, batches in feed:
            state, losses = scan_group(state, batches)
            group_losses.append(losses)
        logger.log(
            int(jax.device_get(state.step)),
            epoch=epoch + 1,
            train_loss=float(
                np.mean(np.concatenate([np.asarray(l).ravel() for l in group_losses]))
            ),
            wall=round(time.time() - t0, 2),
        )

    infer = jax.jit(forward)
    preds, targets = [], []
    for edge, bucket in ds_te.buckets.items():
        b = _prep_batch(bucket, n_classes)
        nb = len(b["x"])
        p = infer(state.params, b["species"], b["x"], b["edge_mask"], b["node_mask"])
        preds.append(np.asarray(p[..., 0])[:nb] * e_std + e_mean)
        targets.append(np.asarray(b["e"])[:nb])
    mae, low, high = bootstrap_mae(
        jnp.asarray(np.concatenate(preds)), jnp.asarray(np.concatenate(targets))
    )
    results = {"test_mae": mae, "test_mae_ci": (low, high)}
    logger.log(int(jax.device_get(state.step)), test_mae=mae)
    return state, results


if __name__ == "__main__":
    run(OC20Config(n_epochs=2, n_samples=256))
