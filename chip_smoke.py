"""Bring-up smoke run on NVIDIA GPUs: SAKE's main paths at MD17 widths.

    python chip_smoke.py                # one card
    python chip_smoke.py --four-cards   # the multi-card paths, on four cards

One card runs, in one process:

- ``device``: JAX must report GPUs; prints ``nvidia-smi``'s name and power
  limit of each card;
- ``dense_ef``: aspirin energies and forces at batch 2048 through the md17
  task's E+F function, against the same model at HIGHEST matmul precision
  on the CPU;
- ``md17_train``: the ``md17`` workload through ``run()`` (force-loss Adam
  steps: the loss must fall) and one step's parameter gradient against
  the HIGHEST-precision gradient;
- ``sparse_md``: the ``sparse_md`` workload at 4096 atoms, once with the
  all-pairs neighbor build and once periodic with the cell list; the
  first frame's per-atom energies against the masked dense model on the
  same neighbor graph (``bigsys.blocked_model_forward``) at HIGHEST;
- ``gpu_tests``: the ``gpu``-marked tests, in this process.

``--four-cards`` runs only ``parallel.make_dp_step`` (the MD17 force-loss
step on a 4-way data mesh, against one device on the same global batch)
and ``bigsys.sharded_model_forward`` (atoms over 4 cards, against the
dense forward).

Each phase prints one JSON line (compile and steady seconds,
``peak_bytes_in_use`` — the process's peak so far — precision, errors
against its reference). A failed
check raises: the process exits non-zero and prints no ``ok`` line. The
last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np

# Tolerances. HIGHEST-vs-HIGHEST comparisons differ only in summation
# order (another device, another sharding); default-precision f32 dots may
# run as TF32 (10-bit mantissa), which bounds the rest.
RTOL_HIGHEST = 1e-4  # elementwise, with atol = RTOL * max|reference|
RTOL_DP_LOSS = 1e-5
RTOL_DEFAULT_FORCES = 1e-2  # relative L2, default precision vs reference
RTOL_DEFAULT_GRADS = 2e-2  # relative L2, default precision vs HIGHEST


def _emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def _block(tree):
    import jax

    return jax.block_until_ready(tree)


def _timed(fn, *args, n_iter: int = 10):
    """``(out, compile_s, steady_s)``: the first call (trace + compile +
    run) and the mean of ``n_iter`` further calls, each timed to
    ``block_until_ready``."""
    t0 = time.perf_counter()
    out = _block(fn(*args))
    compile_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    for _ in range(n_iter):
        out = _block(fn(*args))
    return out, compile_s, (time.perf_counter() - t1) / n_iter


def _peak_bytes():
    import jax

    stats = jax.devices()[0].memory_stats()
    return None if stats is None else stats.get("peak_bytes_in_use")


def _rel_l2(a, b) -> float:
    a = np.concatenate([np.ravel(np.asarray(v, np.float64)) for v in a])
    b = np.concatenate([np.ravel(np.asarray(v, np.float64)) for v in b])
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _assert_close(name, a, b, rtol):
    """Elementwise ``|a - b| <= rtol * (|b| + max|b|)``; returns the
    largest error relative to ``max|b|`` (absolute where ``b`` is 0)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = float(np.abs(b).max())
    np.testing.assert_allclose(a, b, rtol=rtol, atol=rtol * scale, err_msg=name)
    return float(np.abs(a - b).max() / (scale or 1.0))


def _highest():
    import jax

    return jax.default_matmul_precision("highest")


def _quiet_logger():
    import io

    from sake_tpu.train.metrics import MetricLogger

    return MetricLogger(stream=io.StringIO())


# --------------------------------------------------------------------------
# phases


def phase_device(n_cards: int = 1):
    """The devices JAX runs on; fails unless they are GPUs."""
    import jax

    devices = jax.devices()
    platform = devices[0].platform
    if platform != "gpu" or len(devices) < n_cards:
        raise SystemExit(
            f"chip_smoke needs {n_cards} GPU(s); JAX reports {len(devices)} "
            f"{platform} device(s)"
        )
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    _emit(
        "device", platform=platform, kind=devices[0].device_kind,
        count=len(devices), jax=jax.__version__, nvidia_smi=smi.splitlines(),
    )
    print(smi, flush=True)
    return {"platform": platform, "kind": devices[0].device_kind,
            "count": len(devices)}


def phase_dense_ef(batch: int = 2048, n_ref: int = 256, **model):
    """md17 task E+F on aspirin at ``batch``; reference: the same function
    at HIGHEST precision on the CPU for the first ``n_ref`` molecules."""
    import jax

    from sake_tpu.data.md17 import load_md17
    from sake_tpu.tasks.md17 import MD17Config, init_params, make_energy_force_fn

    cfg = MD17Config(**model)
    data = load_md17(cfg.molecule, n_samples=batch)
    species = jax.nn.one_hot(data.z, data.z.max())
    e_mean, e_std = float(data.e.mean()), float(data.e.std())
    params = init_params(cfg, species.shape[-1])
    ef = make_energy_force_fn(cfg.n_heads, species, e_mean, e_std)
    x = jax.numpy.asarray(data.x)

    (e_def, f_def), compile_s, steady_s = _timed(jax.jit(ef), params, x)
    with _highest():
        (e_hi, f_hi), compile_hi_s, steady_hi_s = _timed(
            jax.jit(ef), params, x
        )
        cpu = jax.devices("cpu")[0]
        e_ref, f_ref = _block(
            jax.jit(ef)(jax.device_put(params, cpu), jax.device_put(x[:n_ref], cpu))
        )
    err_e = _assert_close("E highest", e_hi[:n_ref], e_ref, RTOL_HIGHEST)
    err_f = _assert_close("F highest", f_hi[:n_ref], f_ref, RTOL_HIGHEST)
    f_err_default = _rel_l2([f_def[:n_ref]], [f_ref])
    e_err_default = _rel_l2([e_def[:n_ref] - e_mean], [e_ref - e_mean])
    assert f_err_default <= RTOL_DEFAULT_FORCES, f_err_default
    _emit(
        "dense_ef", batch=batch, n_atoms=x.shape[1],
        hidden=cfg.hidden_features, depth=cfg.depth, heads=cfg.n_heads,
        compile_s=compile_s, steady_s=steady_s,
        evals_per_s=batch / steady_s, compile_highest_s=compile_hi_s,
        steady_highest_s=steady_hi_s, peak_bytes_in_use=_peak_bytes(),
        precision="default (f32 dots may run as TF32)",
        highest_vs_cpu_max_err={"e": err_e, "f": err_f},
        default_vs_cpu_rel_l2={"e_minus_mean": e_err_default,
                               "f": f_err_default},
        tolerance={"highest": RTOL_HIGHEST, "default_f": RTOL_DEFAULT_FORCES},
    )


def phase_md17_train(
    n_train: int = 64, n_epochs: int = 4, learning_rate: float = 5e-4,
    **model,
):
    """The ``md17`` workload through ``run()`` (batch 4, one log line per
    epoch), then one step's gradient at default vs HIGHEST precision."""
    import jax

    from sake_tpu.data.md17 import load_md17
    from sake_tpu.tasks.md17 import init_params, make_energy_force_fn, make_loss_fn
    from sake_tpu.tasks.registry import get_workload

    run, cfg = get_workload(
        "md17", n_train=n_train, n_valid=n_train, batch_size=4,
        n_epochs=n_epochs, epochs_per_block=1, learning_rate=learning_rate,
        **model,
    )
    logger = _quiet_logger()
    _, results = run(cfg, logger)
    blocks = [r for r in logger.records if "train_loss" in r]
    losses = [r["train_loss"] for r in blocks]
    walls = [r["wall"] for r in blocks]
    assert np.all(np.isfinite(losses)), losses
    assert losses[-1] < losses[0], f"force loss did not fall: {losses}"
    steps_per_epoch = n_train // cfg.batch_size
    steady_step_s = (walls[-1] - walls[0]) / ((len(walls) - 1) * steps_per_epoch)

    data = load_md17(cfg.molecule, n_samples=cfg.n_train + 2 * cfg.n_valid)
    species = jax.nn.one_hot(data.z, data.z.max())
    e_tr = data.e[:n_train]
    loss_fn = make_loss_fn(
        make_energy_force_fn(
            cfg.n_heads, species, float(e_tr.mean()), float(e_tr.std())
        ),
        cfg.energy_loss_weight,
    )
    params = init_params(cfg, species.shape[-1])
    batch = {k: jax.numpy.asarray(getattr(data, k)[: cfg.batch_size])
             for k in ("x", "e", "f")}
    grad = jax.jit(jax.grad(loss_fn))
    g_def, g_compile_s, g_steady_s = _timed(grad, params, batch)
    with _highest():
        g_hi = _block(jax.jit(jax.grad(loss_fn))(params, batch))
    grad_err = _rel_l2(jax.tree.leaves(g_def), jax.tree.leaves(g_hi))
    assert grad_err <= RTOL_DEFAULT_GRADS, grad_err
    _emit(
        "md17_train", batch=cfg.batch_size, steps=len(walls) * steps_per_epoch,
        losses=losses, compile_s=walls[0] - steps_per_epoch * steady_step_s,
        steady_step_s=steady_step_s, grad_compile_s=g_compile_s,
        grad_steady_s=g_steady_s, peak_bytes_in_use=_peak_bytes(),
        precision="default", grad_default_vs_highest_rel_l2=grad_err,
        tolerance=RTOL_DEFAULT_GRADS, f_mae_kcalmol=results["f_mae_kcalmol"],
    )


def phase_sparse_md(
    n_atoms: int = 4096, n_steps: int = 20, rebuild_every: int = 10,
    periodic: bool = False, cell_capacity=None, ref_block: int = 128,
    **model,
):
    """The ``sparse_md`` workload, then the first frame's per-atom
    energies against the masked dense model on the same neighbor graph."""
    import jax

    from sake_tpu.bigsys import blocked_model_forward
    from sake_tpu.sparse import (
        cell_neighbor_list,
        densify_neighbors,
        make_sparse_energy_forces,
        neighbor_list,
        sparse_model_forward,
    )
    from sake_tpu.tasks.registry import get_workload
    from sake_tpu.tasks.sparse_md import init_params, synthesize_box

    run, cfg = get_workload(
        "sparse_md", n_atoms=n_atoms, n_steps=n_steps,
        rebuild_every=rebuild_every, periodic=periodic,
        cell_capacity=cell_capacity, **model,
    )
    (_, _, es), results = run(cfg, _quiet_logger())
    assert results["max_nbr_overflow"] == 0, results
    assert results["finite"] and np.isfinite(np.asarray(es)).all(), results

    h, x, _, box = synthesize_box(cfg)
    kp = init_params(cfg)
    if cell_capacity is not None:
        box3 = tuple(float(b) for b in box)
        build = jax.jit(lambda x_: cell_neighbor_list(
            x_, cfg.cutoff + cfg.skin, cfg.max_neighbors, box=box3,
            cell_capacity=cell_capacity, with_overflow=True))
    else:
        build = jax.jit(lambda x_: neighbor_list(
            x_, cfg.cutoff + cfg.skin, cfg.max_neighbors, box=box,
            with_overflow=True))
    (idx, m, ovf), build_compile_s, build_s = _timed(build, x, n_iter=5)
    assert int(np.asarray(ovf).max()) == 0

    def sparse_atoms(p, x_):
        return sparse_model_forward(
            p, h, x_, idx, m, n_heads=cfg.n_heads, update=False, box=box
        )[0]

    e_def = _block(jax.jit(sparse_atoms)(kp, x))
    ef = make_sparse_energy_forces(
        h, n_heads=cfg.n_heads, update=False, remat=cfg.remat, box=box
    )
    _, ef_compile_s, ef_s = _timed(jax.jit(ef), kp, x, idx, m, n_iter=5)
    with _highest():
        e_hi = _block(jax.jit(sparse_atoms)(kp, x))
        e_ref = _block(jax.jit(lambda p, x_: blocked_model_forward(
            p, h, x_, n_heads=cfg.n_heads, update=False,
            block_size=min(ref_block, n_atoms),
            mask=densify_neighbors(idx, m, n_atoms), box=box,
        )[0])(kp, x))
    err = _assert_close("per-atom E highest", e_hi, e_ref, RTOL_HIGHEST)
    _emit(
        "sparse_md", n_atoms=n_atoms, build="cell" if cell_capacity else
        "all_pairs", periodic=periodic, max_neighbors=cfg.max_neighbors,
        mean_neighbors=float(np.asarray(m).sum(-1).mean()),
        max_nbr_overflow=results["max_nbr_overflow"],
        rollout_compile_s=results["compile_s"],
        rollout_steps_per_s=results["steps_per_s"],
        atom_steps_per_s=results["atom_steps_per_s"],
        nbr_build_compile_s=build_compile_s, nbr_build_s=build_s,
        sparse_ef_compile_s=ef_compile_s, sparse_ef_s=ef_s,
        peak_bytes_in_use=_peak_bytes(), precision="default",
        highest_vs_dense_max_err=err,
        default_vs_dense_rel_l2=_rel_l2([e_def], [e_ref]),
        tolerance=RTOL_HIGHEST,
    )


class _Outcomes:
    """pytest plugin: counts test outcomes."""

    def __init__(self):
        self.counts = {"passed": 0, "failed": 0, "skipped": 0}

    def pytest_runtest_logreport(self, report):
        if report.when == "call" or report.outcome != "passed":
            self.counts[report.outcome] += 1


def phase_gpu_tests(path: str = "tests/test_gpu.py"):
    """The ``gpu``-marked tests, run in this process on the card."""
    import pytest

    outcomes = _Outcomes()
    t0 = time.perf_counter()
    rc = pytest.main(
        ["-q", "-m", "gpu", "-p", "no:cacheprovider", path],
        plugins=[outcomes],
    )
    c = outcomes.counts
    _emit("gpu_tests", rc=int(rc), seconds=time.perf_counter() - t0, **c)
    if rc != 0 or c["passed"] == 0 or c["skipped"] or c["failed"]:
        raise SystemExit(f"gpu tests failed: rc={rc} {c}")


def _grad_recorder():
    """An optimizer that leaves the parameters as they are and keeps the
    last (all-reduced) gradient as its state."""
    import jax
    import optax

    return optax.GradientTransformation(
        init=lambda params: jax.tree.map(np.zeros_like, params),
        update=lambda g, state, params=None: (
            jax.tree.map(lambda a: a * 0, g), g
        ),
    )


def phase_four_cards(batch: int = 16, n_atoms: int = 1024, **model):
    """Data-parallel MD17 force-loss step and atom-sharded forward on four
    devices, each against its single-device version at HIGHEST."""
    import jax

    from sake_tpu.bigsys import sharded_model_forward
    from sake_tpu.data.md17 import load_md17
    from sake_tpu.kernels import init_model_params, model_forward
    from sake_tpu.parallel import make_dp_step, make_mesh, replicate_state, shard_batch
    from sake_tpu.tasks.md17 import (
        MD17Config,
        init_params,
        make_energy_force_fn,
        make_loss_fn,
    )
    from sake_tpu.tasks.sparse_md import SparseMDConfig, synthesize_box
    from sake_tpu.train import TrainState

    devices = jax.devices()[:4]
    mesh = make_mesh((("data", 4),), devices=devices)
    cfg = MD17Config(**model)
    data = load_md17(cfg.molecule, n_samples=batch)
    species = jax.nn.one_hot(data.z, data.z.max())
    ef = make_energy_force_fn(
        cfg.n_heads, species, float(data.e.mean()), float(data.e.std())
    )
    loss_fn = make_loss_fn(ef, cfg.energy_loss_weight)
    params = init_params(cfg, species.shape[-1])
    batch_ = {k: jax.numpy.asarray(getattr(data, k)) for k in ("x", "e", "f")}
    with _highest():
        loss_ref, g_ref = _block(jax.jit(jax.value_and_grad(loss_fn))(params, batch_))
        state = replicate_state(
            TrainState.create(apply_fn=ef, params=params, tx=_grad_recorder()),
            mesh,
        )
        step = jax.jit(make_dp_step(loss_fn, mesh))
        (state, loss_dp), dp_compile_s, dp_steady_s = _timed(
            step, state, shard_batch(batch_, mesh), n_iter=5
        )
    _assert_close("dp loss", loss_dp, loss_ref, RTOL_DP_LOSS)
    grad_err = max(
        _assert_close("dp grad", a, b, RTOL_HIGHEST)
        for a, b in zip(jax.tree.leaves(state.opt_state), jax.tree.leaves(g_ref))
    )
    _emit(
        "dp_step", devices=4, global_batch=batch, precision="highest",
        loss=float(loss_dp), loss_ref=float(loss_ref), grad_max_err=grad_err,
        compile_s=dp_compile_s, steady_s=dp_steady_s,
        peak_bytes_in_use=_peak_bytes(),
        tolerance={"loss": RTOL_DP_LOSS, "grads": RTOL_HIGHEST},
    )

    scfg = SparseMDConfig(n_atoms=n_atoms, **model)
    h, x, _, _ = synthesize_box(scfg)
    kp = init_model_params(
        jax.random.PRNGKey(scfg.seed), scfg.n_species,
        hidden_features=scfg.hidden_features, depth=scfg.depth,
        n_heads=scfg.n_heads, update=True,
    )
    with _highest():
        out_ref, x_ref, _ = _block(jax.jit(
            lambda p, x_: model_forward(p, h, x_, n_heads=scfg.n_heads)
        )(kp, x))
        for mode in ("gather", "ring"):
            fwd = jax.jit(lambda p, x_, mode=mode: sharded_model_forward(
                p, h, x_, mesh, mode=mode, n_heads=scfg.n_heads,
                block_size=min(128, n_atoms // 4),
            ))
            (out, x_out), compile_s, steady_s = _timed(fwd, kp, x, n_iter=5)
            _emit(
                "sharded_forward", mode=mode, devices=4, n_atoms=n_atoms,
                precision="highest",
                out_max_err=_assert_close("sharded out", out, out_ref, RTOL_HIGHEST),
                x_max_err=_assert_close("sharded x", x_out, x_ref, RTOL_HIGHEST),
                compile_s=compile_s, steady_s=steady_s,
                peak_bytes_in_use=_peak_bytes(), tolerance=RTOL_HIGHEST,
            )


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument(
        "--four-cards", action="store_true",
        help="run only the multi-card paths, on four cards",
    )
    args = parser.parse_args(argv)
    from sake_tpu.compile_cache import enable_compile_cache

    device = phase_device(4 if args.four_cards else 1)
    _emit("compile_cache", dir=enable_compile_cache())
    if args.four_cards:
        phase_four_cards()
    else:
        phase_dense_ef()
        phase_md17_train()
        phase_sparse_md()
        phase_sparse_md(periodic=True, cell_capacity=48)
        phase_gpu_tests()
    print(json.dumps({"ok": True, "device": device}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
