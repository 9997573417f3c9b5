"""The estimators' data plane: load the images, build an epoch's batches.

A copy of ``sparkdl_tpu.estimators.data``: collect (URI, label) rows, keep
this rank's strided shard of them inside a process group
(:func:`~sparkdl_tpu_torch.parallel.runner.host_shard_indices`), load the
images through the user's ``imageLoader`` in a thread pool, and batch each
epoch's permutation with the cyclic-pad policy of
``in_memory_epoch_dataset``, batch for batch; ``labels_to_array`` is the
Keras estimator's label policy. :class:`StreamingShardLoader` keeps only the
URIs in memory and loads each batch as the epoch reaches it, with the same
batches, on the :mod:`sparkdl_tpu_torch.data` pipeline as the JAX loader
is.
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np

from sparkdl_tpu_torch.data.dataset import Dataset
from sparkdl_tpu_torch.resilience import inject
from sparkdl_tpu_torch.utils.metrics import metrics

#: threads loading one batch's images, and batches the producer keeps ready
LOAD_WORKERS = 16
PREFETCH = 2


def collect_host_shard_rows(
    dataset,
    input_col: str,
    label_col: str,
    shard: Optional[Tuple[int, int]] = None,
) -> Tuple[List[str], List[Any], int]:
    """Collect the (URI, label) rows and keep this rank's strided shard,
    without loading any image. Returns ``(uris, labels, n_global)``.

    ``shard=(index, count)`` names the shard; by default it is this rank's
    of the process group (:func:`~sparkdl_tpu_torch.parallel.runner
    .host_shard_indices`), every row outside one. Fails, on every rank alike,
    when there are fewer rows than shards, so no rank waits in a collective
    for one that crashed."""
    from sparkdl_tpu_torch.parallel import runner

    rows = dataset.select(input_col, label_col).collect()
    if not rows:
        raise ValueError("fit() received an empty dataset")
    n_global = len(rows)
    index, count = shard if shard is not None else (runner.process_index(),
                                                    runner.process_count())
    if count > 1:
        if n_global < count:
            raise ValueError(
                f"fit() needs at least one row per host: got {n_global} "
                f"rows across {count} processes"
            )
        rows = [rows[i] for i in runner.host_shard_indices(n_global, index, count)]
    return [r[input_col] for r in rows], [r[label_col] for r in rows], n_global


def load_host_shard(
    dataset,
    input_col: str,
    label_col: str,
    loader: Callable[[str], Any],
    shard: Optional[Tuple[int, int]] = None,
) -> Tuple[np.ndarray, List[Any], int]:
    """:func:`collect_host_shard_rows`, then the shard's images loaded via
    ``loader`` in a thread pool, timed into ``sparkdl.load``. Returns ``(x,
    labels, n_global)``: ``x`` stacked float32, ``labels`` the raw label
    values (the caller owns the dtype policy), ``n_global`` the row count
    before the shard."""
    uris, labels, n_global = collect_host_shard_rows(dataset, input_col, label_col, shard)
    with metrics.timer("sparkdl.load").time(), ThreadPoolExecutor(max_workers=LOAD_WORKERS) as pool:
        images = list(
            pool.map(lambda u: np.asarray(loader(u), dtype=np.float32), uris)
        )
        x = np.stack(images)
    return x, labels, n_global


def labels_to_array(labels: List[Any]) -> np.ndarray:
    """Scalar labels -> int32 class ids; vector labels -> float32 rows
    (one dtype policy for both estimator data paths)."""
    first = np.asarray(labels[0])
    if first.ndim == 0:
        return np.asarray(labels, dtype=np.int32)
    return np.stack([np.asarray(l, dtype=np.float32) for l in labels])


def epoch_index_batches(
    order: np.ndarray, batch_size: int, steps: Optional[int] = None
) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """One epoch's composition: ``order`` cut into ``ceil(n / batch_size)``
    batches of row indices, the last padded by cycling from the start of
    ``order`` (``np.resize``), each with its weights: 1 for a real row, 0
    for a pad row. ``steps`` past that count (every rank of a group steps
    alike) adds all-pad batches, each cycled from the start again, as
    ``Dataset.batch(pad="cyclic", min_batches=steps)`` composes them."""
    n = len(order)
    natural = -(-n // batch_size)
    order = np.asarray(order, np.int64)
    idx = np.resize(order, natural * batch_size)
    w = (np.arange(natural * batch_size) < n).astype(np.float32)
    yield from zip(idx.reshape(natural, batch_size), w.reshape(natural, batch_size))
    for _ in range(natural, steps or 0):
        yield np.resize(order, batch_size), np.zeros(batch_size, np.float32)


def epoch_batches(
    order: np.ndarray,
    x: np.ndarray,
    y: np.ndarray,
    batch_size: int,
    weighted: bool = True,
    steps: Optional[int] = None,
) -> Iterator[Dict[str, np.ndarray]]:
    """One epoch of ``{"x", "y", "w"}`` batches over the rows of
    :func:`epoch_index_batches`. ``weighted=False`` leaves ``"w"`` out (a
    loss without a per-sample form trains the pad rows at full weight, as in
    the JAX package)."""
    for rows, weights in epoch_index_batches(order, batch_size, steps):
        batch = {"x": x[rows], "y": y[rows]}
        if weighted:
            batch["w"] = weights
        yield batch


class StreamingShardLoader:
    """Batches over rows of which only the URIs are held in memory.

    The in-memory path loads every image up front; this loader loads one
    batch at a time through ``loader`` in a pool of ``LOAD_WORKERS``
    threads, on a pipeline that keeps up to ``PREFETCH`` batches ready on a
    producer thread (``sparkdl-stream``) while the card steps. :meth:`epoch`
    gives the batches of :func:`epoch_batches` over the same permutation,
    cyclic padding and zero-weight pad rows included, so a streaming fit
    equals an in-memory one bit for bit. Each batch's load is timed into
    ``sparkdl.load``; the time the fit loop waits for a batch goes to
    ``sparkdl.load_wait``.

    Each URI load fires the ``data.source`` injection site, then calls
    ``loader``. ``retry``, a
    :class:`~sparkdl_tpu_torch.resilience.policy.RetryPolicy`, wraps that
    load: a transient failure (a flaky network file system) is tried again
    and counted in ``resilience.retries``, a permanent one (an
    ``ImageDecodeError``) still fails the epoch at once.
    """

    def __init__(
        self,
        uris: List[str],
        y: np.ndarray,
        loader: Callable[[str], Any],
        batch_size: int,
        weighted: bool,
        retry=None,
    ):
        self.uris = list(uris)
        self.y = y
        self.loader = loader
        self.batch_size = int(batch_size)
        self.weighted = bool(weighted)
        self._load_one = retry.wrap(self._load_uri) if retry is not None else self._load_uri

    def _load_uri(self, uri: str) -> np.ndarray:
        inject.fire("data.source")
        return np.asarray(self.loader(uri), dtype=np.float32)

    def _load_batch(self, pool, rows, n_real: int) -> Dict[str, np.ndarray]:
        with metrics.timer("sparkdl.load").time():
            images = list(pool.map(lambda i: self._load_one(self.uris[i]), rows))
            batch = {"x": np.stack(images), "y": self.y[rows]}
        if self.weighted:
            w = np.zeros(self.batch_size, np.float32)
            w[:n_real] = 1.0
            batch["w"] = w
        return batch

    def dataset(self, order: np.ndarray, steps: int) -> Dataset:
        """The epoch as a :class:`~sparkdl_tpu_torch.data.Dataset`:
        ``from_arrays(order).batch(batch_size, pad="cyclic",
        min_batches=steps)`` (the in-memory loop's batch composition), then
        a load stage that owns the thread pool, then ``prefetch``. The pool
        lives one iteration: made when the pipeline starts, shut down when
        the load stage closes (the prefetch producer closes its upstream on
        cancel or exhaustion), so an abandoned epoch leaks no thread."""
        batches = Dataset.from_arrays(np.asarray(order)).batch(
            self.batch_size, pad="cyclic", min_batches=steps)

        def loaded():
            it = iter(batches)
            with ThreadPoolExecutor(max_workers=LOAD_WORKERS) as pool:
                try:
                    for b in it:
                        yield self._load_batch(pool, np.asarray(b.items, np.int64), b.n_real)
                finally:
                    it.close()

        return Dataset(loaded, length=steps, name="load").prefetch(
            PREFETCH, name="sparkdl-stream")

    def epoch(self, order: np.ndarray,
              steps: Optional[int] = None) -> Iterator[Dict[str, np.ndarray]]:
        """Yield the epoch's ``ceil(len(order) / batch_size)`` batches
        following ``order`` (or ``steps``, at least that many). A loader's
        error is raised here, at the batch it failed on; a pipeline that ends
        short of that count raises too. Closing the generator early (an
        abandoned epoch, a preemption) cancels the producer and joins its
        thread."""
        steps = max(-(-len(order) // self.batch_size), steps or 0)
        produced = 0
        it = iter(self.dataset(order, steps))
        try:
            while produced < steps:
                t0 = time.perf_counter()
                try:
                    batch = next(it)
                except StopIteration:
                    break
                finally:
                    metrics.timer("sparkdl.load_wait").add_seconds(time.perf_counter() - t0)
                produced += 1
                yield batch
        finally:
            it.close()
        if produced != steps:
            raise RuntimeError(f"streaming loader produced {produced}/{steps} batches")
