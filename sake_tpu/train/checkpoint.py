"""Checkpointing via Orbax.

Replaces the reference's ``flax.training.checkpoints`` usage
(``scripts/md17/run.py:127-130``, ``ani_mpi/init.py:41``) with Orbax:
async-capable, multi-host/sharded-array aware, preemption-tolerant —
the multi-host choice.

Capabilities preserved from the reference:
- periodic save with ``keep_every_n`` for trajectory/model-selection evals
  (``md17_traj/eval.py:60-78``),
- restore-latest for kill-and-resume (``ani_mpi/run_mpi.py:110``),
- bootstrap-checkpoint pattern for multi-process weight sync.
"""

from __future__ import annotations

import os
from typing import Any, Optional

import orbax.checkpoint as ocp


class Checkpointer:
    """Thin lifecycle wrapper over an Orbax ``CheckpointManager``."""

    def __init__(
        self,
        directory: str,
        *,
        max_to_keep: Optional[int] = 5,
        keep_every_n: Optional[int] = None,
        async_save: bool = True,
    ):
        directory = os.path.abspath(directory)
        os.makedirs(directory, exist_ok=True)
        options = ocp.CheckpointManagerOptions(
            max_to_keep=max_to_keep,
            keep_period=keep_every_n,
            enable_async_checkpointing=async_save,
        )
        self._mgr = ocp.CheckpointManager(directory, options=options)

    def save(self, step: int, state: Any) -> None:
        self._mgr.save(step, args=ocp.args.StandardSave(state))

    def restore(self, state_like: Any, step: Optional[int] = None) -> Any:
        """Restore at ``step`` (default: latest). ``state_like`` provides the
        pytree structure/shardings to restore into."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError("no checkpoint found")
        return self._mgr.restore(step, args=ocp.args.StandardRestore(state_like))

    def latest_step(self) -> Optional[int]:
        return self._mgr.latest_step()

    def all_steps(self):
        return self._mgr.all_steps()

    def wait(self) -> None:
        """Block until async saves complete (call before process exit)."""
        self._mgr.wait_until_finished()

    def close(self) -> None:
        self._mgr.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.wait()
        self.close()
