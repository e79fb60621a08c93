"""Workload registry: one place mapping every reference experiment family
to its sake_tpu task + config preset.

Replaces the reference's copy-the-directory pattern (41 script dirs, most
byte-near-identical — SURVEY §2.8) with dataclass presets. Ablations are
config fields, matching ``scripts/ablation/*`` which toggle exactly one
flag each.

Usage::

    from sake_tpu.tasks.registry import get_workload
    run, cfg = get_workload("md17")
    run(cfg)

or from the CLI: ``python -m sake_tpu.tasks.registry md17``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple


def _lazy(module: str, fn: str, cfg_cls: str, **overrides):
    def build() -> Tuple[Callable, Any]:
        import importlib

        mod = importlib.import_module(f"sake_tpu.tasks.{module}")
        cfg = getattr(mod, cfg_cls)(**overrides)
        return getattr(mod, fn), cfg

    return build


_REGISTRY: Dict[str, Callable] = {
    # dynamics / forecasting
    "nbody": _lazy("nbody", "run", "NBodyConfig"),
    "motion": _lazy("forecast", "run", "ForecastConfig", workload="motion"),
    "md17_forecast": _lazy(
        "forecast", "run", "ForecastConfig", workload="md17_forecast"
    ),
    # energy+force
    "md17": _lazy("md17", "run", "MD17Config"),
    "md17_traj": _lazy("md17", "run", "MD17Config", checkpoint_every_blocks=1),
    "iso17": _lazy("iso17", "run", "ISO17Config"),
    # property regression
    "qm9": _lazy("qm9", "run", "QM9Config"),
    # shard_map data parallelism over every visible device
    "qm9_dp": _lazy("qm9", "run", "QM9Config", data_parallel=True),
    # large heterogeneous
    "ani": _lazy("ani", "run", "ANIConfig"),
    "oc20": _lazy("oc20", "run", "OC20Config"),
    # large-system MD on the cutoff-sparse O(N*K) path (capability the
    # reference's broken SparseSAKELayer never delivered)
    "sparse_md": _lazy("sparse_md", "run", "SparseMDConfig"),
    # force-matching (second-order) training at cutoff-sparse scale
    "sparse_train": _lazy("sparse_train", "run", "SparseTrainConfig"),
    # flows
    "dw4": _lazy("flows", "run_cnf", "CNFConfig"),
    "dw4_aug": _lazy("flows", "run_augmented", "AugmentedFlowConfig", system="dw4"),
    "lj13_aug": _lazy("flows", "run_augmented", "AugmentedFlowConfig", system="lj13"),
    "qm9_aug": _lazy("flows", "run_augmented", "AugmentedFlowConfig", system="qm9"),
    # ablations (scripts/ablation/*: one flag each off the md17 template)
    "ablation_no_euclidean": _lazy("ablation", "run", "AblationConfig", flag="no_euclidean"),
    "ablation_no_semantic": _lazy("ablation", "run", "AblationConfig", flag="no_semantic"),
    "ablation_no_spatial": _lazy("ablation", "run", "AblationConfig", flag="no_spatial"),
    "ablation_no_update": _lazy("ablation", "run", "AblationConfig", flag="no_update"),
    "ablation_egnn": _lazy("ablation", "run", "AblationConfig", flag="egnn"),
}


def list_workloads():
    return sorted(_REGISTRY)


def get_workload(name: str, **overrides) -> Tuple[Callable, Any]:
    if name not in _REGISTRY:
        raise KeyError(f"unknown workload {name!r}; known: {list_workloads()}")
    run, cfg = _REGISTRY[name]()
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return run, cfg


def parse_overrides(tokens):
    """``key=value`` CLI tokens -> config overrides (the capability the
    reference spread across per-script argparse flags, e.g.
    ``scripts/md17/run.py`` ``--molecule``). Values are parsed as python
    literals (ints, floats, True/None, quoted strings, tuples); bare
    words fall back to strings, so ``molecule=ethanol`` just works."""
    import ast

    overrides = {}
    for tok in tokens:
        key, eq, text = tok.partition("=")
        if not eq:
            raise SystemExit(
                f"override {tok!r} is not key=value (e.g. molecule=ethanol)"
            )
        try:
            overrides[key] = ast.literal_eval(text)
        except (ValueError, SyntaxError):
            overrides[key] = text
    return overrides


def main(argv=None):
    """CLI: ``sake-tpu <workload> [key=value ...]`` (also
    ``python -m sake_tpu.tasks.registry ...``). No workload prints the
    registry."""
    import sys

    from sake_tpu.compile_cache import enable_compile_cache

    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] in ("-h", "--help"):
        print(
            "usage: sake-tpu <workload> [key=value ...]\n"
            "       sake-tpu sweep <workload> key=v1,v2 ... [sweep_out=dir]\n"
            "workloads:"
        )
        for n in list_workloads():
            print(f"  {n}")
        return
    enable_compile_cache()
    if argv[0] == "sweep":
        from sake_tpu.tasks.sweep import main as sweep_main

        return sweep_main(argv[1:])
    run, cfg = get_workload(argv[0], **parse_overrides(argv[1:]))
    print(f"running {argv[0]} with {cfg}")
    run(cfg)


if __name__ == "__main__":
    main()
