"""End-to-end smoke tests for every workload family (tiny configs, CPU).

These exercise the full task surface — data synthesis/loading, collation,
training loops, NaN containment, checkpointing, eval — the way a user
runs them (`tasks.registry`)."""

import math

import pytest

from sake_tpu.tasks.registry import get_workload, list_workloads


def _finite(results):
    for k, v in results.items():
        if isinstance(v, float):
            assert math.isfinite(v), f"{k} not finite"


def test_cli_overrides_parse_and_apply():
    """``python -m sake_tpu.tasks.registry md17 molecule=ethanol depth=2``
    — the reference's per-script argparse flags as key=value overrides."""
    from sake_tpu.tasks.registry import parse_overrides

    ov = parse_overrides(
        ["molecule=ethanol", "depth=2", "learning_rate=5e-4",
         "energy_loss_weight=1e-2", "data_dir=None"]
    )
    assert ov == {
        "molecule": "ethanol", "depth": 2, "learning_rate": 5e-4,
        "energy_loss_weight": 1e-2, "data_dir": None,
    }
    _, cfg = get_workload("md17", **ov)
    assert cfg.molecule == "ethanol" and cfg.depth == 2
    assert cfg.energy_loss_weight == 1e-2
    with pytest.raises(SystemExit):
        parse_overrides(["notanassignment"])
    with pytest.raises(TypeError):
        get_workload("md17", **parse_overrides(["no_such_field=1"]))


def test_registry_lists_all_reference_families():
    names = list_workloads()
    for required in [
        "nbody", "md17", "md17_traj", "md17_forecast", "iso17", "qm9",
        "qm9_dp", "qm9_aug", "ani", "oc20", "dw4", "dw4_aug", "lj13_aug",
        "motion", "ablation_egnn", "ablation_no_euclidean",
        "ablation_no_semantic", "ablation_no_spatial", "ablation_no_update",
    ]:
        assert required in names


TINY = {
    "nbody": dict(hidden_features=8, depth=2, n_epochs=2, epochs_per_block=1,
                  n_train=100, n_valid=50, n_test=50, batch_size=50),
    "md17": dict(hidden_features=8, depth=2, n_epochs=2, epochs_per_block=1,
                 n_train=16, n_valid=8, batch_size=8),
    "iso17": dict(hidden_features=8, depth=2, n_epochs=2, epochs_per_block=1,
                  n_train=16, batch_size=8),
    "qm9": dict(hidden_features=8, depth=2, n_epochs=1, n_samples=256,
                batch_size=32, data_parallel=False),
    "ani": dict(hidden_features=8, depth=2, n_epochs=1, n_samples=128,
                batch_size=8, max_buckets=3),
    "oc20": dict(hidden_features=8, depth=2, n_epochs=1, n_samples=64,
                 batch_size=4, max_buckets=2),
    "motion": dict(hidden_features=8, depth=2, n_epochs=1, epochs_per_block=1,
                   n_samples=60, batch_size=12),
    "dw4_aug": dict(depth=1, mp_depth=1, hidden_features=8, n_epochs=1,
                    epochs_per_block=1, n_train=100, n_test=50, batch_size=50),
    # every list_workloads() name must run end-to-end in CI.
    "md17_traj": dict(hidden_features=8, depth=2, n_epochs=2,
                      epochs_per_block=1, n_train=16, n_valid=8, batch_size=8),
    "md17_forecast": dict(hidden_features=8, depth=2, n_epochs=1,
                          epochs_per_block=1, n_samples=60, batch_size=12),
    "qm9_dp": dict(hidden_features=8, depth=2, n_epochs=1, n_samples=256,
                   batch_size=16),  # shard_map DP over the 8 fake devices
    "dw4": dict(depth=2, hidden_features=8, n_epochs=2, n_train=64, n_test=32),
    "qm9_aug": dict(depth=1, mp_depth=1, hidden_features=8, n_epochs=1,
                    epochs_per_block=1, n_train=48, n_test=16, batch_size=16),
    "lj13_aug": dict(depth=1, mp_depth=1, hidden_features=8, n_epochs=1,
                     epochs_per_block=1, n_train=64, n_test=32, batch_size=32),
    "ablation_no_euclidean": dict(hidden_features=8, depth=2, n_epochs=1,
                                  epochs_per_block=1, n_train=16, n_valid=8,
                                  batch_size=8),
    "ablation_no_semantic": dict(hidden_features=8, depth=2, n_epochs=1,
                                 epochs_per_block=1, n_train=16, n_valid=8,
                                 batch_size=8),
    "ablation_no_spatial": dict(hidden_features=8, depth=2, n_epochs=1,
                                epochs_per_block=1, n_train=16, n_valid=8,
                                batch_size=8),
    "ablation_no_update": dict(hidden_features=8, depth=2, n_epochs=1,
                               epochs_per_block=1, n_train=16, n_valid=8,
                               batch_size=8),
    "ablation_egnn": dict(hidden_features=8, depth=2, n_epochs=1,
                          epochs_per_block=1, n_train=16, n_valid=8,
                          batch_size=8),
    "sparse_md": dict(hidden_features=8, depth=2, n_atoms=64, n_steps=8,
                      rebuild_every=4, cutoff=4.0, max_neighbors=16,
                      periodic=True),
    "sparse_train": dict(hidden_features=8, depth=2, n_atoms=48,
                         n_steps=4, steps_per_block=2, cutoff=4.0,
                         max_neighbors=8),
}


def test_tiny_covers_whole_registry():
    """No registry entry may be missing from the smoke matrix."""
    assert sorted(TINY) == list_workloads()


@pytest.mark.parametrize("name", sorted(TINY))
def test_workload_smoke(name):
    run, cfg = get_workload(name, **TINY[name])
    _, results = run(cfg)
    _finite(results)



@pytest.mark.slow
def test_oc20_bigsys_forward():
    """OC20 with the large-system (bigsys) execution path: blocked
    online-softmax layers single-device, sharded gather/ring selection on
    a mesh (bigsys.sharded_model_forward)."""
    from sake_tpu.tasks.oc20 import OC20Config, run

    _, results = run(
        OC20Config(
            hidden_features=8,
            depth=2,
            n_epochs=1,
            n_samples=32,
            batch_size=4,
            max_buckets=2,
            use_bigsys=True,
            bigsys_block=8,
        )
    )
    _finite(results)


def test_qm9_bucketed_dp_composition():
    """Size-bucketed batches + shard_map data parallelism over the 8 fake
    devices: each bucketed group runs through the SAME sharded
    scanned-epoch program as flat batches (tasks/qm9.py DP branch)."""
    from sake_tpu.tasks.qm9 import QM9Config, run

    _, results = run(
        QM9Config(
            hidden_features=8,
            depth=2,
            n_epochs=1,
            n_samples=256,
            batch_size=32,  # 8 devices x per-device 4
            data_parallel=True,
            bucket_pad_multiple=8,
        )
    )
    _finite(results)


def test_qm9_bucketed_training():
    """QM9 with size-bucketed training batches (bucket_pad_multiple):
    one scanned program per padded size, eval unchanged (flat)."""
    from sake_tpu.tasks.qm9 import QM9Config, run

    _, results = run(
        QM9Config(
            hidden_features=8,
            depth=2,
            n_epochs=1,
            n_samples=256,
            batch_size=16,
            data_parallel=False,
            bucket_pad_multiple=8,
        )
    )
    _finite(results)


def test_sweep_driver_grid(tmp_path):
    """`sake-tpu sweep` grid runner (layer-6 parity with the reference's
    nested-for LSF scripts, scripts/nbody/run.sh): cartesian cells, JSONL
    per cell, failed cells recorded without killing the sweep."""
    from sake_tpu.tasks.sweep import parse_sweep_axes, run_sweep

    axes = parse_sweep_axes(
        ["hidden_features=4,8", "depth=1", "n_epochs=1",
         "epochs_per_block=1", "n_train=50,100", "n_valid=50", "n_test=50",
         "batch_size=50"]
    )
    assert axes["hidden_features"] == [4, 8]
    assert axes["depth"] == [1]  # single value = 1-point axis
    assert axes["n_train"] == [50, 100]
    # tuple values survive top-level comma splitting
    assert parse_sweep_axes(["box=(1,2),(3,4)"])["box"] == [(1, 2), (3, 4)]

    out = tmp_path / "sweep"
    cells = run_sweep("nbody", axes, out_dir=str(out))
    assert len(cells) == 4  # 2 x 2 grid
    assert all(c["ok"] for c in cells)
    assert {(c["hidden_features"], c["n_train"]) for c in cells} == {
        (4, 50), (4, 100), (8, 50), (8, 100)
    }
    import json as _json

    lines = (out / "cells.jsonl").read_text().splitlines()
    assert len(lines) == 4
    assert all("results" in _json.loads(ln) for ln in lines)
    # per-cell metric streams exist and are JSONL
    assert (out / "cell_000.jsonl").exists()
    _json.loads((out / "cell_000.jsonl").read_text().splitlines()[0])

    # a bad cell is recorded, the sweep continues
    bad = run_sweep(
        "nbody", {"no_such_field": [1, 2]}, out_dir=str(tmp_path / "bad")
    )
    assert len(bad) == 2 and not any(c["ok"] for c in bad)
    assert "error" in bad[0]

