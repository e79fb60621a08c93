"""Training subsystem: state, optimizer chains, on-device epoch loops,
checkpointing, and metrics.

``Checkpointer`` (Orbax) is imported on first use, so the rest of the
subsystem runs without orbax installed.
"""

from sake_tpu.train.state import TrainState
from sake_tpu.train.optim import (
    make_optimizer,
    warmup_cosine_schedule,
    notfinite_count,
)
from sake_tpu.train.loop import scan_epoch, scan_epochs, shuffle_batches
from sake_tpu.train import metrics

__all__ = [
    "TrainState",
    "make_optimizer",
    "warmup_cosine_schedule",
    "notfinite_count",
    "scan_epoch",
    "scan_epochs",
    "shuffle_batches",
    "Checkpointer",
    "metrics",
]


def __getattr__(name):
    if name == "Checkpointer":
        from sake_tpu.train.checkpoint import Checkpointer

        return Checkpointer
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
