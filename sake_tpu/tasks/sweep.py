"""Grid-sweep driver over the workload registry (layer-6 parity).

The reference ran hyperparameter sweeps as nested-for LSF submission
scripts — e.g. ``scripts/nbody/run.sh:1-15`` loops over units/layers and
``bsub``s one ``run.py`` per cell. This module is the single-command
equivalent: a cartesian grid over ``key=v1,v2,...`` axes, each cell a
registry workload run with those config overrides, metrics captured as
JSONL (one summary line per cell in ``cells.jsonl``, plus each cell's
full metric stream in ``cell_NNN.jsonl``).

Usage::

    sake-tpu sweep nbody hidden_features=16,64 depth=3,6
    sake-tpu sweep md17 molecule=aspirin,ethanol lr=1e-3,1e-4 \
        sweep_out=sweeps/md17_lr

On a multi-controller cluster the same command runs under
``parallel.initialize_distributed`` per cell; on one host the cells run
sequentially (accelerators don't time-share well between processes, and
XLA compilations are cached across cells that share shapes).
"""

from __future__ import annotations

import ast
import itertools
import json
import os
import time
import traceback
from typing import Dict, List, Optional, Sequence

from sake_tpu.tasks.registry import get_workload


def split_top_level(text: str) -> List[str]:
    """Split on commas NOT inside (), [], {} or quotes, so
    ``box=(1,2,3),(4,5,6)`` sweeps two tuple values."""
    parts, depth, quote, cur = [], 0, None, []
    for ch in text:
        if quote:
            cur.append(ch)
            if ch == quote:
                quote = None
            continue
        if ch in "\"'":
            quote = ch
            cur.append(ch)
        elif ch in "([{":
            depth += 1
            cur.append(ch)
        elif ch in ")]}":
            depth -= 1
            cur.append(ch)
        elif ch == "," and depth == 0:
            parts.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    parts.append("".join(cur))
    return parts


def _literal(text: str):
    try:
        return ast.literal_eval(text)
    except (ValueError, SyntaxError):
        return text  # bare words are strings (molecule=ethanol)


def parse_sweep_axes(tokens: Sequence[str]) -> Dict[str, list]:
    """``key=v1,v2,...`` tokens -> ordered {key: [values]} axes. A single
    value is a 1-point axis (a fixed override)."""
    axes: Dict[str, list] = {}
    for tok in tokens:
        key, eq, text = tok.partition("=")
        if not eq:
            raise SystemExit(
                f"sweep token {tok!r} is not key=v1,v2,... "
                "(e.g. lr=1e-3,1e-4)"
            )
        axes[key] = [_literal(p) for p in split_top_level(text)]
    return axes


def run_sweep(
    workload: str,
    axes: Dict[str, list],
    out_dir: Optional[str] = None,
    halt_on_error: bool = False,
):
    """Run the cartesian grid; returns the list of per-cell summary dicts
    (also appended to ``<out_dir>/cells.jsonl`` as they finish, so a
    killed sweep keeps its completed cells — the resume story the
    reference's fire-and-forget bsub loops never had)."""
    from sake_tpu.train.metrics import MetricLogger

    out_dir = out_dir or os.path.join(
        "sweeps", f"{workload}-{time.strftime('%Y%m%d-%H%M%S')}"
    )
    os.makedirs(out_dir, exist_ok=True)
    keys = list(axes)
    cells = list(itertools.product(*(axes[k] for k in keys)))
    summaries = []
    with open(os.path.join(out_dir, "cells.jsonl"), "a") as f:
        for i, values in enumerate(cells):
            overrides = dict(zip(keys, values))
            rec = {"cell": i, "workload": workload, **overrides}
            print(f"# sweep cell {i + 1}/{len(cells)}: {overrides}",
                  flush=True)
            logger = MetricLogger(
                path=os.path.join(out_dir, f"cell_{i:03d}.jsonl")
            )
            t0 = time.time()
            try:
                run, cfg = get_workload(workload, **overrides)
                _, results = run(cfg, logger)
                rec.update(results=results, ok=True)
            except Exception as ex:  # noqa: BLE001 — sweep survives cells
                rec.update(ok=False, error=f"{type(ex).__name__}: {ex}")
                traceback.print_exc()
                if halt_on_error:
                    raise
            finally:
                logger.close()
            rec["wall_s"] = round(time.time() - t0, 2)
            f.write(json.dumps(rec) + "\n")
            f.flush()
            summaries.append(rec)
    return summaries


def main(argv: Sequence[str]):
    """``sake-tpu sweep <workload> key=v1,v2 ... [sweep_out=dir]``."""
    if not argv:
        raise SystemExit(
            "usage: sake-tpu sweep <workload> key=v1,v2 ... [sweep_out=dir]"
        )
    workload, tokens = argv[0], list(argv[1:])
    out_dir = None
    for tok in list(tokens):
        if tok.startswith("sweep_out="):
            out_dir = tok.split("=", 1)[1]
            tokens.remove(tok)
    summaries = run_sweep(workload, parse_sweep_axes(tokens), out_dir)
    n_ok = sum(1 for s in summaries if s.get("ok"))
    print(f"# sweep done: {n_ok}/{len(summaries)} cells ok")
    return summaries
