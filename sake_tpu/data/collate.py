"""Batch collation: padding, edge masks, and length-bucketing.

Static shapes are the whole game under XLA — it compiles one program per
distinct shape. Two strategies, mirroring (and fixing) the reference:

- **Padded batches** (QM9 pattern, ``scripts/qm9_full/run.py:23-27``): pad
  every graph to a common N, carry a node mask, derive the edge mask as an
  outer product.
- **Length-bucketed batches** (ANI/OC20 pattern,
  ``scripts/ani/run.py:23-56``): group samples by size so every batch is
  shape-uniform. The reference compiled one XLA program per distinct
  molecule size (~25 programs); here bucket edges are **rounded up to a
  small set of static shapes** to bound compilation count.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Sequence, Tuple

import numpy as np


def pad_axis(a: np.ndarray, n: int, axis: int = 0) -> np.ndarray:
    """Zero-pad ``a`` along ``axis`` to length ``n``."""
    if a.shape[axis] == n:
        return a
    widths = [(0, 0)] * a.ndim
    widths[axis] = (0, n - a.shape[axis])
    return np.pad(a, widths)


def pad_graphs(
    graphs: Sequence[Dict[str, np.ndarray]],
    n_max: int | None = None,
    node_axis: int = 0,
) -> Dict[str, np.ndarray]:
    """Pad a list of per-graph dicts to a common node count and stack.

    Returns the stacked dict plus ``node_mask (B, N)`` and
    ``edge_mask (B, N, N)``.
    """
    sizes = [next(iter(g.values())).shape[node_axis] for g in graphs]
    n = n_max if n_max is not None else max(sizes)
    out: Dict[str, np.ndarray] = {}
    keys = graphs[0].keys()
    for k in keys:
        out[k] = np.stack([pad_axis(g[k], n, node_axis) for g in graphs])
    node_mask = np.zeros((len(graphs), n), np.float32)
    for i, s in enumerate(sizes):
        node_mask[i, :s] = 1.0
    out["node_mask"] = node_mask
    out["edge_mask"] = node_mask[:, :, None] * node_mask[:, None, :]
    return out


def round_up_to_bucket(n: int, edges: Sequence[int]) -> int:
    """Smallest bucket edge >= n (edges must be sorted ascending)."""
    for e in edges:
        if n <= e:
            return e
    raise ValueError(f"size {n} exceeds largest bucket edge {edges[-1]}")


def make_bucket_edges(sizes: Sequence[int], max_buckets: int = 6) -> List[int]:
    """Choose <= ``max_buckets`` bucket edges covering the observed sizes,
    by quantile, always including the max. Bounds XLA compilation count
    (the reference compiled one program per distinct size)."""
    uniq = np.unique(np.asarray(sizes))
    if len(uniq) <= max_buckets:
        return [int(u) for u in uniq]
    qs = np.quantile(uniq, np.linspace(0, 1, max_buckets + 1)[1:])
    edges = sorted({int(np.ceil(q)) for q in qs} | {int(uniq.max())})
    return edges


class BucketedDataset:
    """Size-bucketed sample store (the ANI ``data[length] = {i, x, y}``
    layout, ``scripts/ani/data.py:37-48``), with padded bucket edges.

    ``samples``: list of dicts of per-sample arrays whose leading axis is
    the node axis. Samples are padded up to their bucket edge once, at
    ingest, and stored stacked per bucket.
    """

    def __init__(
        self,
        samples: Sequence[Dict[str, np.ndarray]],
        max_buckets: int = 6,
    ):
        sizes = [next(iter(s.values())).shape[0] for s in samples]
        self.edges = make_bucket_edges(sizes, max_buckets)
        grouped: Dict[int, List[Dict[str, np.ndarray]]] = {e: [] for e in self.edges}
        for s, n in zip(samples, sizes):
            grouped[round_up_to_bucket(n, self.edges)].append(s)
        self.buckets: Dict[int, Dict[str, np.ndarray]] = {}
        for e, group in grouped.items():
            if group:
                self.buckets[e] = pad_graphs(group, n_max=e)

    def sizes(self) -> Dict[int, int]:
        return {
            e: next(iter(b.values())).shape[0] for e, b in self.buckets.items()
        }


class BucketedCollater:
    """Uniform-shape batch iterator over a :class:`BucketedDataset`.

    Builds a pointer list of ``(bucket_edge, indices)`` batches and shuffles
    *batches* across buckets (the reference Collater,
    ``scripts/ani/run.py:23-35``) so every yielded batch has a single static
    shape. Ragged tails are dropped (as in the reference).
    """

    def __init__(self, ds: BucketedDataset, batch_size: int, seed: int = 0):
        self.ds = ds
        self.batch_size = batch_size
        self._rng = np.random.RandomState(seed)

    def __iter__(self) -> Iterator[Tuple[int, Dict[str, np.ndarray]]]:
        pointers: List[Tuple[int, np.ndarray]] = []
        for e, bucket in self.ds.buckets.items():
            n = next(iter(bucket.values())).shape[0]
            idxs = self._rng.permutation(n)
            for s in range(0, n - self.batch_size + 1, self.batch_size):
                pointers.append((e, idxs[s : s + self.batch_size]))
        self._rng.shuffle(pointers)
        for e, idxs in pointers:
            yield e, {k: v[idxs] for k, v in self.ds.buckets[e].items()}

    def batches_per_epoch(self) -> int:
        return sum(
            n // self.batch_size for n in self.ds.sizes().values()
        )

    def epoch_groups(self) -> Iterator[Tuple[int, Dict[str, np.ndarray]]]:
        """One epoch as per-bucket *stacked* batch groups.

        Yields ``(bucket_edge, group)`` where each ``group`` leaf has shape
        ``(n_batches, batch_size, ...)`` — the form a ``lax.scan`` epoch
        consumes on device. Samples are reshuffled within each bucket and
        the bucket order is reshuffled each epoch. Replaces the per-batch
        host loop (the reference dispatched one pmap per batch,
        ``scripts/ani/run_tpu.py:132-134``; a scanned group is ONE
        dispatch per bucket), with at most ``len(ds.buckets)`` XLA
        programs since ``n_batches`` per bucket is constant across epochs.
        """
        edges = list(self.ds.buckets)
        self._rng.shuffle(edges)
        for e in edges:
            bucket = self.ds.buckets[e]
            n = next(iter(bucket.values())).shape[0]
            n_b = n // self.batch_size
            if n_b == 0:
                continue
            take = self._rng.permutation(n)[: n_b * self.batch_size].reshape(
                n_b, self.batch_size
            )
            yield e, {k: v[take] for k, v in bucket.items()}


def prefetch_to_device(iterator, size: int = 2, sharding=None):
    """Double-buffered host->device feed (the capability of
    ``flax.jax_utils.prefetch_to_device``, ``scripts/ani/run_gpu.py:135-136``).

    Eagerly starts ``size`` async ``jax.device_put`` transfers ahead of the
    consumer, so host collation and H2D DMA overlap device compute.
    Non-array leaves pass through untouched.
    """
    import collections

    import jax

    def put(tree):
        return jax.tree.map(
            lambda a: jax.device_put(a, sharding)
            if isinstance(a, (np.ndarray, jax.Array))
            else a,
            tree,
        )

    queue = collections.deque()
    for item in iterator:
        queue.append(put(item))
        if len(queue) >= size:
            yield queue.popleft()
    while queue:
        yield queue.popleft()
