"""Molecular-dynamics rollouts, entirely on device.

The north-star capability (BASELINE.json): trajectory stepping with no
host round trips. Two integrators, both ``lax.scan`` programs:

- ``velocity_verlet_rollout`` — classical symplectic MD driven by a
  learned force field ``(params, x) -> (e, f)`` (e.g. the MD17 model's
  fused E+F evaluation).
- ``learned_integrator_rollout`` — the SAKE-native alternative: a
  ``update=True`` model IS a learned integrator (depth D = D internal
  steps, ``sake/models.py:56-61``); rolling it out autoregressively gives
  md17_forecast/nbody-style trajectories.

Both return stacked trajectories ``(n_steps, ..., N, 3)``; wrap in jit and
the whole rollout is one XLA program.
"""

from __future__ import annotations

from typing import Callable, Optional

import jax
import jax.numpy as jnp


def velocity_verlet_rollout(
    energy_forces_fn: Callable,
    params,
    x0: jax.Array,  # (..., N, 3)
    v0: jax.Array,  # (..., N, 3)
    masses: jax.Array,  # (N,) or (..., N)
    dt: float,
    n_steps: int,
    sample_every: int = 1,
):
    """Velocity-Verlet integration of ``f = -dE/dx``.

    Returns ``(xs, vs, es)`` stacked every ``sample_every`` steps:
    ``xs (n_samples, ..., N, 3)``, ``es (n_samples, ...)``.
    """
    inv_m = (1.0 / masses)[..., None]

    def step(carry, _):
        x, v, f = carry
        v_half = v + 0.5 * dt * f * inv_m
        x_new = x + dt * v_half
        e_new, f_new = energy_forces_fn(params, x_new)
        v_new = v_half + 0.5 * dt * f_new * inv_m
        return (x_new, v_new, f_new), None

    def sample(carry, _):
        carry, _ = jax.lax.scan(step, carry, None, length=sample_every)
        x, v, f = carry
        e, _ = energy_forces_fn(params, x)
        return carry, (x, v, e)

    _, f0 = energy_forces_fn(params, x0)
    n_samples = n_steps // sample_every
    _, (xs, vs, es) = jax.lax.scan(
        sample, (x0, v0, f0), None, length=n_samples
    )
    return xs, vs, es


def neighborlist_verlet_rollout(
    energy_forces_fn: Callable,
    params,
    x0: jax.Array,  # (B, N, 3)
    v0: jax.Array,  # (B, N, 3)
    masses: jax.Array,  # (N,) or (B, N)
    dt: float,
    n_steps: int,
    *,
    cutoff: float,
    max_neighbors: int,
    rebuild_every: int = 20,
    skin: float = 0.0,
    node_mask: Optional[jax.Array] = None,  # (B, N)
    box=None,  # (3,) orthorhombic periodic box
    cell_capacity: Optional[int] = None,  # use the O(N) cell-list build
    cell_extent=None,  # (3,) static grid extent: O(N) build, OPEN system
    with_overflow: bool = False,
):
    """Velocity-Verlet on a cutoff force field with periodic neighbor-list
    rebuilds — large-system MD entirely on device.

    ``energy_forces_fn(params, x, idx, nbr_mask) -> (e, f)`` evaluates the
    cutoff-sparse model (see ``sake_tpu.sparse.make_sparse_energy_forces``).
    The rollout is an outer ``lax.scan`` over rebuild intervals (the list is
    rebuilt from the current positions at ``cutoff + skin``, standard MD
    skin convention so in-flight atoms don't fall off the list) with an
    inner ``lax.scan`` of ``rebuild_every`` Verlet steps on the FIXED graph
    — every shape static, so the whole trajectory is one compiled program.
    With ``box``, displacements use the minimum-image convention (the
    force field must have been built with the same ``box``) and positions
    are wrapped back into the box at each rebuild. Returns
    ``(xs, vs, es)`` sampled once per rebuild interval — or
    ``(xs, vs, es, overflows)`` with ``with_overflow=True``, where
    ``overflows (n_intervals, B) int32`` counts neighbors each rebuild
    DROPPED (beyond ``max_neighbors``, or past ``cell_capacity`` in a
    cell): any nonzero entry means the trajectory ran on a truncated
    graph — raise the capacity/K until it stays 0. Density fluctuations
    during long MD can overflow a capacity that was fine at t=0, so
    production runs should check this.
    """
    from sake_tpu.sparse import (  # local: avoid import cycle
        cell_neighbor_list,
        neighbor_list,
    )

    if cell_capacity is not None and box is None and cell_extent is None:
        raise ValueError(
            "cell_capacity requires a periodic `box` (the cell grid is "
            "sized from it) or an open-boundary `cell_extent`; with "
            "neither, drop cell_capacity to use the O(N^2)-work "
            "all-pairs build"
        )
    if cell_extent is not None and box is not None:
        raise ValueError("pass either `box` (periodic) or `cell_extent` "
                         "(open grid), not both")

    if cell_capacity is not None:
        # O(N·27·capacity) grid-binned build instead of the O(N²)
        # all-pairs pass — the production large-N configuration.
        # cell_extent: same build on an OPEN system (clipped stencil,
        # Euclidean distances); the extent only sizes the static grid.
        def build_list(x_):
            return cell_neighbor_list(
                x_, cutoff + skin, max_neighbors,
                box=box if box is not None else cell_extent,
                periodic=box is not None,
                cell_capacity=cell_capacity, node_mask=node_mask,
                with_overflow=True,
            )
    else:
        def build_list(x_):
            return neighbor_list(
                x_, cutoff + skin, max_neighbors,
                node_mask=node_mask, box=box, with_overflow=True,
            )

    inv_m = (1.0 / masses)[..., None]

    # The model is inlined into the program exactly ONCE (inside the
    # verlet body): forces carry ACROSS rebuilds (exact under the
    # standard skin criterion — the old list still contains every
    # in-cutoff pair of the current positions, so the cutoff force
    # field evaluates identically on either graph), and the sampled
    # energy is the last verlet step's, which is already at the
    # interval-end positions on the interval's graph. The previous
    # structure inlined the depth-6 model three times per interval and
    # cost 251 s of XLA compile at N=2048 (round-3 measurement); this
    # one compiles ~3x faster with an identical trajectory.

    def verlet(carry, _):
        x, v, f, e, idx, m = carry
        v_half = v + 0.5 * dt * f * inv_m
        x_new = x + dt * v_half
        e_new, f_new = energy_forces_fn(params, x_new, idx, m)
        v_new = v_half + 0.5 * dt * f_new * inv_m
        return (x_new, v_new, f_new, e_new, idx, m), None

    def interval(carry, _):
        x, v, f, e = carry
        if box is not None:
            bx = jnp.asarray(box, x.dtype)
            x = x - bx * jnp.floor(x / bx)  # min-image forces: f unchanged
        idx, m, ovf = build_list(jax.lax.stop_gradient(x))
        (x, v, f, e, _, _), _ = jax.lax.scan(
            verlet, (x, v, f, e, idx, m), None, length=rebuild_every
        )
        return (x, v, f, e), (x, v, e, ovf)

    idx0, m0, _ = build_list(jax.lax.stop_gradient(x0))
    e0, f0 = energy_forces_fn(params, x0, idx0, m0)
    n_intervals = n_steps // rebuild_every
    _, (xs, vs, es, ovfs) = jax.lax.scan(
        interval, (x0, v0, f0, e0), None, length=n_intervals
    )
    if with_overflow:
        return xs, vs, es, ovfs
    return xs, vs, es


def learned_integrator_rollout(
    apply_fn: Callable,
    params,
    h: jax.Array,  # (..., N, F)
    x0: jax.Array,  # (..., N, 3)
    v0: Optional[jax.Array],
    n_steps: int,
):
    """Autoregressive rollout of an ``update=True`` model: each application
    advances (x, v) by one macro-step (D learned sub-steps). Returns
    ``(xs, vs)`` with leading axis ``n_steps``."""
    v0 = v0 if v0 is not None else jnp.zeros_like(x0)

    def step(carry, _):
        x, v = carry
        _, x_new, v_new = apply_fn(params, h, x, v)
        return (x_new, v_new), (x_new, v_new)

    _, (xs, vs) = jax.lax.scan(step, (x0, v0), None, length=n_steps)
    return xs, vs
