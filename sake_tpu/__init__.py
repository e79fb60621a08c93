"""sake_tpu — a JAX framework for E(n)-equivariant molecular ML.

A ground-up JAX/XLA re-design with the capabilities of the reference
SAKE library (Spatial Attention Kinetic networks with E(n)-Equivariance):

- ``geometry``  — O(N^2) pairwise geometry core (displacements, distances,
  edge feature concatenation, masks).
- ``radial``    — radial basis smearing and cutoff envelopes.
- ``layers``    — SAKE message-passing layers and EGNN baselines (flax linen).
- ``models``    — depth-stacked models and readout heads (flax linen).
- ``flows``     — equivariant normalizing flows (augmented coupling + CNF).
- ``kernels``   — the functional (pytree-parameterized) SAKE model that the
  energy/force tasks, ``sparse``, ``bigsys`` and ``parallel`` run on,
  plus the linen-parameter adapter.
- ``sparse``    — cutoff-sparse (neighbor-list) execution, O(N·K).
- ``bigsys``    — blocked and atom-sharded all-pairs execution.
- ``md``        — on-device molecular-dynamics rollouts.
- ``parallel``  — device-mesh construction and shard_map data parallelism.
- ``train``     — training state, optimizer chains, scanned epoch loops,
  checkpointing, metrics.
- ``data``      — dataset ingestion, padded/bucketed collation.
- ``tasks``     — end-to-end workload harnesses (nbody, MD17, QM9, ANI,
  OC20, ISO17, flows, motion).

The linen modules (``radial``, ``layers``, ``models``, ``flows``) are
imported on first access, so ``import sake_tpu`` and the functional
energy/force paths need neither flax nor orbax.

The numerical contract (constants, masking semantics, activation choices)
matches the reference at fp32 tolerance; see ``tests/test_reference_parity``.
"""

import importlib

from sake_tpu import geometry, utils
from sake_tpu import kernels, parallel, train, data, bigsys, md, compat, sparse

_LINEN_MODULES = ("radial", "layers", "models", "flows")

# Reference-compatible aliases (reference: sake/__init__.py:1 re-exports
# functional, utils, layers, models, flows).
functional = geometry

__all__ = [
    "geometry",
    "functional",
    "radial",
    "layers",
    "models",
    "flows",
    "utils",
    "kernels",
    "parallel",
    "train",
    "data",
    "bigsys",
    "sparse",
    "md",
    "compat",
]

__version__ = "0.1.0"


def __getattr__(name):
    if name in _LINEN_MODULES:
        return importlib.import_module(f"sake_tpu.{name}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
