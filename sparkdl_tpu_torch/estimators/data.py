"""The estimators' data plane: load the images, build an epoch's batches.

A copy of ``sparkdl_tpu.estimators.data`` for one host: collect (URI,
label) rows, load the images through the user's ``imageLoader`` in a thread
pool, and batch each epoch's permutation with the cyclic-pad policy of
``in_memory_epoch_dataset``, batch for batch; ``labels_to_array`` is the
Keras estimator's label policy. :class:`StreamingShardLoader` keeps only the
URIs in memory and loads each batch as the epoch reaches it, with the same
batches, on the :mod:`sparkdl_tpu_torch.data` pipeline as the JAX loader
is. The multi-host shard (``runner``) is not ported yet (ROADMAP.md item
12).
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, Iterator, List, Tuple

import numpy as np

from sparkdl_tpu_torch.data.dataset import Dataset
from sparkdl_tpu_torch.utils.metrics import metrics

#: threads loading one batch's images, and batches the producer keeps ready
LOAD_WORKERS = 16
PREFETCH = 2


def load_host_shard(
    dataset,
    input_col: str,
    label_col: str,
    loader: Callable[[str], Any],
) -> Tuple[np.ndarray, List[Any]]:
    """Collect every (URI, label) row and load the images via ``loader`` in
    a thread pool, timed into ``sparkdl.load``. Returns ``(x, labels)``:
    ``x`` stacked float32, ``labels`` the raw label values (the caller owns
    the dtype policy)."""
    rows = dataset.collect()
    if not rows:
        raise ValueError("fit() received an empty dataset")
    uris = [r[input_col] for r in rows]
    with metrics.timer("sparkdl.load").time(), ThreadPoolExecutor(max_workers=LOAD_WORKERS) as pool:
        images = list(
            pool.map(lambda u: np.asarray(loader(u), dtype=np.float32), uris)
        )
        x = np.stack(images)
    return x, [r[label_col] for r in rows]


def collect_host_shard_rows(
    dataset,
    input_col: str,
    label_col: str,
) -> Tuple[List[str], List[Any]]:
    """Collect the (URI, label) rows without loading any image. Returns
    ``(uris, labels)``; one host keeps every row."""
    rows = dataset.select(input_col, label_col).collect()
    if not rows:
        raise ValueError("fit() received an empty dataset")
    return [r[input_col] for r in rows], [r[label_col] for r in rows]


def labels_to_array(labels: List[Any]) -> np.ndarray:
    """Scalar labels -> int32 class ids; vector labels -> float32 rows
    (one dtype policy for both estimator data paths)."""
    first = np.asarray(labels[0])
    if first.ndim == 0:
        return np.asarray(labels, dtype=np.int32)
    return np.stack([np.asarray(l, dtype=np.float32) for l in labels])


def epoch_index_batches(
    order: np.ndarray, batch_size: int
) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """One epoch's composition: ``order`` cut into ``ceil(n / batch_size)``
    batches of row indices, the last one padded by cycling from the start
    of ``order`` (``np.resize``), each with its weights: 1 for a real row,
    0 for a pad row."""
    n = len(order)
    steps = -(-n // batch_size)
    idx = np.resize(np.asarray(order, np.int64), steps * batch_size)
    w = (np.arange(steps * batch_size) < n).astype(np.float32)
    yield from zip(idx.reshape(steps, batch_size), w.reshape(steps, batch_size))


def epoch_batches(
    order: np.ndarray,
    x: np.ndarray,
    y: np.ndarray,
    batch_size: int,
    weighted: bool = True,
) -> Iterator[Dict[str, np.ndarray]]:
    """One epoch of ``{"x", "y", "w"}`` batches over the rows of
    :func:`epoch_index_batches`. ``weighted=False`` leaves ``"w"`` out (a
    loss without a per-sample form trains the pad rows at full weight, as in
    the JAX package)."""
    for rows, weights in epoch_index_batches(order, batch_size):
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
    """

    def __init__(
        self,
        uris: List[str],
        y: np.ndarray,
        loader: Callable[[str], Any],
        batch_size: int,
        weighted: bool,
    ):
        self.uris = list(uris)
        self.y = y
        self.loader = loader
        self.batch_size = int(batch_size)
        self.weighted = bool(weighted)

    def _load_batch(self, pool, rows, n_real: int) -> Dict[str, np.ndarray]:
        with metrics.timer("sparkdl.load").time():
            images = list(pool.map(
                lambda i: np.asarray(self.loader(self.uris[i]), dtype=np.float32), rows))
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

    def epoch(self, order: np.ndarray) -> Iterator[Dict[str, np.ndarray]]:
        """Yield the epoch's ``ceil(len(order) / batch_size)`` batches
        following ``order``. A loader's error is raised here, at the batch
        it failed on; a pipeline that ends short of that count raises too.
        Closing the generator early (an abandoned epoch, a preemption)
        cancels the producer and joins its thread."""
        steps = -(-len(order) // self.batch_size)
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
