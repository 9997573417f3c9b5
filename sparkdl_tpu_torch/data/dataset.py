"""Lazy ``Dataset`` graph: sources and composable pipeline operators.

Port of ``sparkdl_tpu.data.dataset`` (host code, but for the device stage
at the end). A :class:`Dataset` is a recipe, not a container: each node
holds its upstream and its parameters, and ``iter(ds)`` builds a fresh
iterator chain. Iterating twice runs the pipeline again (and draws the next
permutation of a ``shuffle`` node's seeded stream, as the estimators'
per-epoch ``rng.permutation`` draws do).

- **lazy and re-iterable**: nothing runs until iteration; epochs are
  repeated iterations of one graph;
- **deterministic**: every operator keeps order (``map`` with workers yields
  in submission order); ``shuffle`` and ``batch`` reproduce the estimators'
  permutation stream and cyclic-pad policy bit for bit, so a streaming fit
  equals an in-memory one;
- **clean shutdown**: closing a pipeline iterator mid-stream closes the
  whole chain: prefetch threads are joined and pools shut down.

Consumers: the estimators' ``StreamingShardLoader``, the transform loop's
chunked decode (``transformers/utils.run_batched_rows``), and
:meth:`Dataset.prefetch_to_device`, whose placer
(:func:`~sparkdl_tpu_torch.data.device.default_device_placer`) copies each
batch to the card on a side stream while the consumer computes on the
previous one.
"""

from __future__ import annotations

from typing import (
    Any,
    Callable,
    Dict,
    Iterable,
    Iterator,
    List,
    NamedTuple,
    Optional,
    Sequence,
)

import numpy as np

from sparkdl_tpu_torch.resilience import inject


class Batch(NamedTuple):
    """One fixed-size batch: ``items`` (a list or a stacked array, of the
    batch size after padding) and ``n_real``, how many leading entries are
    real rows (the rest are cyclic padding). ``n_real`` stays on the host
    when the batch is placed on the card."""

    items: Any
    n_real: int


def _counter():
    from sparkdl_tpu_torch.utils.metrics import metrics

    return metrics.counter("data.rows_out")


class Dataset:
    """One node of the lazy pipeline graph. Build with the ``from_*``
    sources, chain operators, iterate to run.

    ``len(ds)`` is known when the source's size is and no operator changed
    the count in a data-dependent way.
    """

    def __init__(
        self,
        iter_factory: Callable[[], Iterator],
        length: Optional[int] = None,
        name: str = "dataset",
        unbounded: bool = False,
    ):
        self._iter_factory = iter_factory
        self._length = length
        self._name = name
        self._unbounded = bool(unbounded)

    @property
    def unbounded(self) -> bool:
        """True for a stream-backed dataset (``from_stream``): iteration may
        never end, so the whole-stream operators (``shuffle``, cyclic
        padding) are refused."""
        return self._unbounded

    # ------------------------------------------------------------------
    # sources
    # ------------------------------------------------------------------
    @staticmethod
    def from_items(items: Sequence, name: str = "from_items") -> "Dataset":
        """A dataset over a finite sequence (kept by reference)."""
        return Dataset(lambda: iter(items), length=len(items), name=name)

    @staticmethod
    def from_uris(uris: Sequence[str]) -> "Dataset":
        """A dataset of URI strings, the estimators' ingest source (only the
        URIs stay in host memory; pair it with ``map(loader)``)."""
        return Dataset.from_items(list(uris), name="from_uris")

    @staticmethod
    def from_arrays(*arrays: np.ndarray) -> "Dataset":
        """Rows of aligned arrays: one array yields its rows, several yield
        row tuples (all must share the leading dimension)."""
        if not arrays:
            raise ValueError("from_arrays requires at least one array")
        arrays = tuple(np.asarray(a) for a in arrays)
        n = arrays[0].shape[0]
        for a in arrays[1:]:
            if a.shape[0] != n:
                raise ValueError(
                    "from_arrays requires aligned leading dims: "
                    f"{[a.shape[0] for a in arrays]}"
                )
        if len(arrays) == 1:
            arr = arrays[0]
            return Dataset(lambda: iter(arr), length=n, name="from_arrays")
        return Dataset(lambda: zip(*arrays), length=n, name="from_arrays")

    @staticmethod
    def from_files(paths: Sequence[str], retry=None) -> "Dataset":
        """``(path, bytes)`` pairs read lazily at iteration time, the
        source-read stage. ``retry`` (a
        :class:`~sparkdl_tpu_torch.resilience.policy.RetryPolicy`) tries a
        read that fails transiently again (an ``OSError``); a
        ``FileNotFoundError`` or ``PermissionError`` is permanent and fails
        at once. The ``data.source`` fault site fires before each read."""
        paths = list(paths)

        def read_one(path: str) -> bytes:
            inject.fire("data.source")
            with open(path, "rb") as fh:
                return fh.read()

        reader = retry.wrap(read_one) if retry is not None else read_one

        def rows():
            return ((p, reader(p)) for p in paths)

        return Dataset(rows, length=len(paths), name="from_files")

    @staticmethod
    def from_dataframe(df, *cols: str) -> "Dataset":
        """Rows of a :class:`sparkdl_tpu_torch.sql.dataframe.DataFrame`. With
        ``cols``, tuples of those columns (one column yields bare values);
        without, the whole ``Row``s. Collects once per iteration."""
        if cols:
            selected = df.select(*cols)

            def rows():
                collected = selected.collect()
                if len(cols) == 1:
                    return iter([r[cols[0]] for r in collected])
                return iter([tuple(r[c] for c in cols) for r in collected])

        else:

            def rows():
                return iter(df.collect())

        return Dataset(rows, length=df.count(), name="from_dataframe")

    @staticmethod
    def from_stream(
        source,
        poll_batch: int = 64,
        idle_wait_ms: float = 10.0,
        max_records: Optional[int] = None,
    ) -> "Dataset":
        """An unbounded dataset over a
        :class:`~sparkdl_tpu_torch.streaming.sources.StreamSource`: each
        iteration polls the source and yields record *values* as they
        arrive, waiting ``idle_wait_ms`` between empty polls (the
        ``streaming.poll`` fault site fires before each poll). It ends only
        when the source reports ``finished()`` or after ``max_records`` (a
        bounded window onto the stream).

        The dataset is :attr:`unbounded` unless windowed: ``shuffle`` and
        cyclic padding are refused, and ``batch`` gives ragged finals (or
        ``drop_remainder=True``). Scored, exactly-once consumption is
        :class:`~sparkdl_tpu_torch.streaming.runner.StreamRunner`'s; this is
        the read-only view."""
        import threading

        def rows():
            waiter = threading.Event()  # an interruptible idle wait
            emitted = 0
            while True:
                inject.fire("streaming.poll")
                records = source.poll(poll_batch)
                if not records:
                    if source.finished():
                        return
                    waiter.wait(idle_wait_ms / 1000.0)
                    continue
                for rec in records:
                    yield rec.value
                    emitted += 1
                    if max_records is not None and emitted >= max_records:
                        return

        return Dataset(rows, length=None, name="from_stream",
                       unbounded=max_records is None)

    # ------------------------------------------------------------------
    # operators
    # ------------------------------------------------------------------
    def map(
        self,
        fn: Callable[[Any], Any],
        num_workers: int = 0,
        buffer: Optional[int] = None,
        retry=None,
    ) -> "Dataset":
        """``fn`` on each item (the ``data.map`` fault site fires before
        each). ``num_workers > 0`` runs ``fn`` on a thread pool with a
        bounded in-flight window (``buffer``, default ``2 * num_workers``)
        and **keeps order**: results come in submission order whatever each
        item's latency. The pool's threads re-enter the consumer's trace
        span (captured when iteration starts).

        ``retry`` (a :class:`~sparkdl_tpu_torch.resilience.policy.RetryPolicy`)
        tries an item's transient failure again with backoff; a permanent
        one propagates at once."""
        src = self

        def apply(item):
            inject.fire("data.map")
            return fn(item)

        item_fn = retry.wrap(apply) if retry is not None else apply

        if num_workers <= 0:

            def sequential():
                it = iter(src)
                try:
                    for item in it:
                        yield item_fn(item)
                finally:
                    _close_iter(it)

            return Dataset(sequential, length=self._length, name="map",
                           unbounded=self._unbounded)

        window = max(1, int(buffer) if buffer is not None else 2 * int(num_workers))

        def threaded():
            from collections import deque
            from concurrent.futures import ThreadPoolExecutor

            from sparkdl_tpu_torch.obs.trace import tracer

            # explicit trace propagation: the span current on the thread
            # that drives the pipeline, re-attached around each pool task
            # (pool threads never inherit it); None costs nothing
            span = tracer.capture()
            if span is None:
                run = item_fn
            else:
                def run(item):
                    with tracer.use_span(span):
                        return item_fn(item)

            it = iter(src)
            pending: "deque" = deque()
            pool = ThreadPoolExecutor(max_workers=int(num_workers),
                                      thread_name_prefix="sparkdl-data-map")
            try:
                for item in it:
                    pending.append(pool.submit(run, item))
                    if len(pending) >= window:
                        yield pending.popleft().result()
                while pending:
                    yield pending.popleft().result()
            finally:
                for f in pending:
                    f.cancel()
                _close_iter(it)
                pool.shutdown(wait=True)

        return Dataset(threaded, length=self._length, name="map",
                       unbounded=self._unbounded)

    def shuffle(self, seed: int) -> "Dataset":
        """A seeded whole-dataset shuffle reproducing the estimators'
        permutation stream: one ``np.random.RandomState(seed % 2**32)`` per
        *pipeline* (made at the first iteration), and each iteration draws
        the next ``rng.permutation(n)``, so epoch ``e`` of this dataset sees
        the estimator loop's ``e``-th epoch order. Materializes the upstream
        items per iteration: shuffle URIs or indices, before the expensive
        ``map``."""
        if self._unbounded:
            raise ValueError(
                "shuffle() is a whole-dataset reorder and cannot apply "
                "to an unbounded stream; window the stream first "
                "(from_stream(max_records=...))"
            )
        src = self
        state: Dict[str, Any] = {}

        def shuffled():
            items = list(_iterate_fully(src))
            if "rng" not in state:
                state["rng"] = np.random.RandomState(int(seed) % 2**32)
            order = state["rng"].permutation(len(items))
            return iter([items[i] for i in order])

        return Dataset(shuffled, length=self._length, name="shuffle")

    def shard(self, index: Optional[int] = None,
              count: Optional[int] = None) -> "Dataset":
        """Keep the strided split ``index::count``: per-host sharding as a
        pipeline stage. With no arguments, this process's rank and world
        size in an initialized ``torch.distributed`` group, else all of
        it (one process)."""
        src = self

        def strided():
            if index is None or count is None:
                import torch.distributed as dist

                if not (dist.is_available() and dist.is_initialized()):
                    return iter(_iterate_fully(src))
                i, c = dist.get_rank(), dist.get_world_size()
            else:
                i, c = int(index), int(count)
            if not 0 <= i < c:
                raise ValueError(f"shard index {i} outside [0, {c})")
            return (item for j, item in enumerate(_iterate_fully(src)) if j % c == i)

        length = None
        if self._length is not None and index is not None and count:
            length = len(range(int(index), self._length, int(count)))
        return Dataset(strided, length=length, name="shard",
                       unbounded=self._unbounded)

    def batch(
        self,
        batch_size: int,
        pad: Optional[str] = None,
        min_batches: Optional[int] = None,
        drop_remainder: bool = False,
    ) -> "Dataset":
        """Group items into :class:`Batch` tuples of exactly ``batch_size``.

        ``pad=None`` drops nothing and ends with a ragged batch (``n_real <
        batch_size``, ``items`` shorter). ``pad="cyclic"`` pads the ragged
        final batch by cycling from the stream's start (``np.resize`` over
        every item), the estimators' policy, so batches equal the in-memory
        fit loop's bit for bit. ``min_batches`` (with ``pad="cyclic"``)
        keeps emitting all-pad ``n_real=0`` batches after the end up to that
        count, so that every host runs the same step count.

        ``drop_remainder=True`` drops the ragged final instead: the
        fixed-shape option for **unbounded** streams, where cyclic padding
        is impossible. On an unbounded dataset no item is kept after its
        batch leaves (a stream runs in O(batch) memory)."""
        if pad not in (None, "cyclic"):
            raise ValueError(f"pad must be None or 'cyclic', got {pad!r}")
        if min_batches is not None and pad != "cyclic":
            raise ValueError("min_batches requires pad='cyclic'")
        if drop_remainder and pad is not None:
            raise ValueError("drop_remainder and pad are mutually exclusive")
        if self._unbounded and pad is not None:
            raise ValueError(
                "pad='cyclic' assumes a finite source and cannot apply to "
                "an unbounded stream; use pad=None (ragged final) or "
                "drop_remainder=True"
            )
        bs = int(batch_size)
        if bs < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        src = self
        keep_seen = pad == "cyclic"

        def batched():
            it = iter(src)
            seen: List[Any] = []
            buf: List[Any] = []
            emitted = 0
            try:
                for item in it:
                    buf.append(item)
                    if keep_seen:
                        seen.append(item)
                    if len(buf) == bs:
                        yield Batch(_pack(buf), bs)
                        emitted += 1
                        buf = []
                if buf and not drop_remainder:
                    k = len(buf)
                    if pad == "cyclic":
                        # np.resize over the whole stream (== np.resize(order,
                        # pad) when upstream is the epoch permutation)
                        buf = buf + _cycle_pad(seen, bs - k)
                    yield Batch(_pack(buf), k)
                    emitted += 1
                if min_batches is not None:
                    if not seen and emitted < min_batches:
                        raise ValueError("batch(min_batches=...) on an empty stream")
                    while emitted < min_batches:
                        yield Batch(_pack(_cycle_pad(seen, bs)), 0)
                        emitted += 1
            finally:
                _close_iter(it)

        length = None
        if self._length is not None:
            if drop_remainder:
                length = self._length // bs
            else:
                length = max(-(-self._length // bs), min_batches or 0)
        return Dataset(batched, length=length, name="batch",
                       unbounded=self._unbounded)

    def prefetch(self, size: int = 2, name: str = "sparkdl-prefetch") -> "Dataset":
        """Run the upstream pipeline ``size`` items ahead on a background
        thread (``name``) through a bounded queue; closing the iterator
        cancels, drains and joins it
        (:class:`~sparkdl_tpu_torch.data.prefetch.PrefetchIterator`). Sets
        the ``data.queue_depth`` gauge, observes the consumer's waits in the
        ``data.device_stall_ms`` histogram and the producer's work in the
        ``data.producer_busy`` timer; the producer re-enters the consumer's
        trace span."""
        src = self

        def prefetched():
            from sparkdl_tpu_torch.data.prefetch import PrefetchIterator
            from sparkdl_tpu_torch.obs.trace import tracer
            from sparkdl_tpu_torch.utils.metrics import metrics

            busy = metrics.timer("data.producer_busy")
            it = PrefetchIterator(
                lambda: iter(src), size,
                on_wait_ms=metrics.histogram("data.device_stall_ms").observe,
                on_depth=metrics.gauge("data.queue_depth").set,
                on_busy_s=busy.add_seconds,
                context_span=tracer.capture(),
                name=name,
            )
            try:
                yield from it
            finally:
                it.close()

        return Dataset(prefetched, length=self._length, name="prefetch",
                       unbounded=self._unbounded)

    def prefetch_to_device(self, place: Optional[Callable[[Any], Any]] = None,
                           device=None) -> "Dataset":
        """Double-buffered device placement: batch ``i+1``'s host-to-device
        copy is started (``place``, default
        :func:`~sparkdl_tpu_torch.data.device.default_device_placer` on
        ``device``: a pinned buffer and a ``non_blocking`` copy on a side
        stream) *before* batch ``i`` is yielded, so the copy runs under the
        consumer's compute on ``i``. Before a batch is yielded, the
        consumer's current stream waits for its copy (the placer's
        ``ready``). Terminal stage: counts ``data.rows_out``."""
        src = self

        def doubled():
            from sparkdl_tpu_torch.data.device import default_device_placer

            placer = place if place is not None else default_device_placer(device)
            ready = getattr(placer, "ready", None)
            rows_out = _counter()
            it = iter(src)
            pending = None
            try:
                for item in it:
                    placed = placer(item)  # batch i+1's copy starts ...
                    if pending is not None:
                        yield _hand_over(pending, ready, rows_out)
                    pending = placed  # ... under the consumer's work on i
                if pending is not None:
                    yield _hand_over(pending, ready, rows_out)
            finally:
                _close_iter(it)

        return Dataset(doubled, length=self._length, name="prefetch_to_device",
                       unbounded=self._unbounded)

    # ------------------------------------------------------------------
    def __iter__(self) -> Iterator:
        return self._iter_factory()

    def __len__(self) -> int:
        if self._length is None:
            raise TypeError(f"len() of unsized dataset ({self._name})")
        return self._length

    def __repr__(self) -> str:
        size = "?" if self._length is None else str(self._length)
        return f"<Dataset {self._name} n={size}>"


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def _hand_over(placed, ready, rows_out):
    """A placed batch to the consumer: its stream waits for the copy first
    (the placer's ``ready``, when it has one); its real rows are counted."""
    if ready is not None:
        ready(placed)
    rows_out.add(_row_count(placed))
    return placed


def _close_iter(it) -> None:
    close = getattr(it, "close", None)
    if close is not None:
        close()


def _iterate_fully(src: Iterable) -> Iterator:
    it = iter(src)
    try:
        yield from it
    finally:
        _close_iter(it)


def _pack(items: List[Any]):
    """Stack scalar or array items into one ndarray (what a batch's consumer
    indexes), leave other items as a list."""
    first = items[0]
    if isinstance(first, (int, np.integer, float, np.floating, np.ndarray)):
        try:
            return np.asarray(items)
        except ValueError:  # ragged shapes: keep the list
            return list(items)
    return list(items)


def _cycle_pad(seen: List[Any], k: int) -> List[Any]:
    """``k`` pad items cycling from the stream's start (``np.resize`` over
    arbitrary items)."""
    if k <= 0:
        return []
    if not seen:
        raise ValueError("cannot cyclically pad an empty stream")
    reps = -(-k // len(seen))
    return (seen * reps)[:k]


def _row_count(item) -> int:
    if isinstance(item, Batch):
        return int(item.n_real)
    if isinstance(item, dict):
        for v in item.values():
            return _row_count(v)
        return 1
    shape = getattr(item, "shape", None)
    if shape:
        return int(shape[0])
    return 1
