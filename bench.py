"""Aspirin energy+force throughput of the md17 task's E+F path.

    python bench.py [batch]     # default batch 2048

One process: builds the MD17 model at its published widths (hidden 64,
depth 6, 4 heads; ``scripts/md17/run.py:40-44``) with seeded random
weights, jits the md17 task's E+F function (one forward plus the position
gradient) on ``batch`` aspirin geometries, and times steady calls, each
ended by ``block_until_ready``. Prints one JSON line naming the device
(platform, kind, count) and, on a GPU, its name and power limit as
``nvidia-smi`` reports them.
"""

import json
import subprocess
import sys
import time


def build(batch: int):
    """The md17 task's jitted E+F callable, its parameters and positions."""
    import jax

    from sake_tpu.data.md17 import load_md17
    from sake_tpu.tasks.md17 import MD17Config, init_params, make_energy_force_fn

    cfg = MD17Config()
    data = load_md17(cfg.molecule, n_samples=batch)
    species = jax.nn.one_hot(data.z, data.z.max())
    params = init_params(cfg, species.shape[-1])
    ef = jax.jit(make_energy_force_fn(cfg.n_heads, species, 0.0, 1.0))
    return ef, params, jax.numpy.asarray(data.x)


def measure(ef, params, x, min_seconds: float = 2.0):
    """``(compile_s, evals_per_s)``: the first call, then steady calls
    for at least ``min_seconds``."""
    import jax

    t0 = time.perf_counter()
    jax.block_until_ready(ef(params, x))
    compile_s = time.perf_counter() - t0
    n_iter, elapsed = 0, 0.0
    t0 = time.perf_counter()
    while elapsed < min_seconds:
        jax.block_until_ready(ef(params, x))
        n_iter += 1
        elapsed = time.perf_counter() - t0
    return compile_s, n_iter * x.shape[0] / elapsed


def main():
    import jax

    from sake_tpu.compile_cache import enable_compile_cache

    enable_compile_cache()
    batch = int(sys.argv[1]) if len(sys.argv) > 1 else 2048
    device = jax.devices()[0]
    card = None
    if device.platform == "gpu":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip().splitlines()
    compile_s, rate = measure(*build(batch))
    print(json.dumps({
        "metric": "md17_aspirin_energy_force_evals_per_sec",
        "value": round(rate, 1),
        "unit": "evals/s",
        "batch": batch,
        "compile_s": round(compile_s, 2),
        "device": {"platform": device.platform, "kind": device.device_kind,
                   "count": len(jax.devices())},
        "card": card,
    }))


if __name__ == "__main__":
    main()
