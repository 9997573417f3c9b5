"""Host metrics of the batched transform loop and the fit loop.

A trimmed copy of ``sparkdl_tpu.utils.metrics``: the counters and timers the
hot loop advances (``sparkdl.load``, ``sparkdl.forward``, ``sparkdl.serve``,
``sparkdl.images_processed``, ``sparkdl.rows_processed``,
``sparkdl.batches_run``), so ``metrics.images_per_sec()`` reports the
sustained rate of the current process; and the always-on part of
``sparkdl_tpu.obs.hooks``' fit profiler, :func:`fit_step` (the
``estimator.step`` timer and the ``estimator.steps`` counter) and
:func:`fit_checkpoint` (the ``estimator.checkpoint`` timer and the
``estimator.checkpoint_ms`` histogram of each save's dispatch), with
:func:`record_commit` for the background write behind it
(``estimator.checkpoint_commit``, ``estimator.checkpoint_commit_ms``,
``estimator.checkpoint_bytes``); the estimators time a resume into
``estimator.restore``, and the streaming loader its loads into
``sparkdl.load`` and the fit loop's waits for them into
``sparkdl.load_wait``; the transform loop's prefetch sets the
``data.queue_depth`` gauge and observes ``data.device_stall_ms``, its
dispatch window the ``engine.inflight`` gauge; the engine counts
``engine.cache_hit`` and ``engine.cache_miss`` and times ``engine.compile``
and ``engine.cache_load``; the serving plane keeps its ``serving.*``,
``batcher.*`` and ``decode.*`` series, its latencies as histograms whose
snapshot gives the p50, p95 and p99 of the last 4096 observations. Trace
spans, exemplars and the Prometheus text are not ported yet (ROADMAP item
14). Thread-safe.
"""

from __future__ import annotations

import math
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Callable, Dict, List, Optional


class Counter:
    """Monotonic accumulator."""

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._value = 0.0

    def add(self, value: float = 1.0) -> None:
        with self._lock:
            self._value += value

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Timer:
    """Accumulates wall-time over ``with timer.time():`` sections."""

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._seconds = 0.0

    @contextmanager
    def time(self):
        start = time.perf_counter()
        try:
            yield
        finally:
            self.add_seconds(time.perf_counter() - start)

    def add_seconds(self, seconds: float) -> None:
        with self._lock:
            self._seconds += seconds

    @property
    def seconds(self) -> float:
        with self._lock:
            return self._seconds


class Gauge:
    """Last-set value (a queue's depth, the results in flight)."""

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


#: how many of its latest observations a histogram keeps for quantiles
HISTOGRAM_WINDOW = 4096


class Histogram:
    """A distribution: lifetime count and sum, and the last
    :data:`HISTOGRAM_WINDOW` observations for quantiles (a serving
    endpoint's p99 is of recent traffic, not of a cold start's compile, and
    a long-lived server's memory stays bounded)."""

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._values: "deque[float]" = deque(maxlen=HISTOGRAM_WINDOW)
        self._count = 0
        self._sum = 0.0

    def observe(self, value: float) -> None:
        with self._lock:
            self._values.append(float(value))
            self._count += 1
            self._sum += float(value)

    def values(self) -> List[float]:
        """The observations in the window, oldest first."""
        with self._lock:
            return list(self._values)

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def total(self) -> float:
        with self._lock:
            return self._sum

    def quantile(self, q: float) -> Optional[float]:
        """The linearly interpolated quantile ``q`` of the window; None when
        it is empty."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1], got {q}")
        data = sorted(self.values())
        if not data:
            return None
        rank = q * (len(data) - 1)
        lo = math.floor(rank)
        hi = min(lo + 1, len(data) - 1)
        return data[lo] * (1.0 - (rank - lo)) + data[hi] * (rank - lo)


class MetricsRegistry:
    """Process-wide named counters, timers, gauges and histograms."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._timers: Dict[str, Timer] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        with self._lock:
            if name not in self._counters:
                self._counters[name] = Counter(name)
            return self._counters[name]

    def timer(self, name: str) -> Timer:
        with self._lock:
            if name not in self._timers:
                self._timers[name] = Timer(name)
            return self._timers[name]

    def gauge(self, name: str) -> Gauge:
        with self._lock:
            if name not in self._gauges:
                self._gauges[name] = Gauge(name)
            return self._gauges[name]

    def histogram(self, name: str) -> Histogram:
        with self._lock:
            if name not in self._histograms:
                self._histograms[name] = Histogram(name)
            return self._histograms[name]

    def snapshot(self, prefix: Optional[str] = None) -> Dict[str, float]:
        """Flat dict of every counter and gauge value, timer total
        (``.seconds``) and histogram count and sum (``.count``, ``.sum``),
        with, once it has observations, its mean and the p50, p95 and p99
        of its window (``.mean``, ``.p50``, ``.p95``, ``.p99``),
        keeping only names that start with ``prefix`` when one is given."""
        with self._lock:
            counters = dict(self._counters)
            timers = dict(self._timers)
            gauges = dict(self._gauges)
            histograms = dict(self._histograms)
        out: Dict[str, float] = {}
        for name, c in {**counters, **gauges}.items():
            out[name] = c.value
        for name, t in timers.items():
            out[name + ".seconds"] = t.seconds
        for name, h in histograms.items():
            count, total = h.count, h.total
            out[name + ".count"] = count
            out[name + ".sum"] = total
            if count:
                out[name + ".mean"] = total / count
                for q in (50, 95, 99):
                    out[f"{name}.p{q}"] = h.quantile(q / 100)
        if prefix is not None:
            out = {k: v for k, v in out.items() if k.startswith(prefix)}
        return out

    def images_per_sec(self) -> Optional[float]:
        """Sustained rows/sec through the batched loop: rows over
        'sparkdl.serve' (loop wall time, load waits included), else over
        'sparkdl.forward'."""
        n = self.counter("sparkdl.rows_processed").value
        s = self.timer("sparkdl.serve").seconds
        if not s:
            s = self.timer("sparkdl.forward").seconds
        return (n / s) if (n and s) else None

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._timers.clear()
            self._gauges.clear()
            self._histograms.clear()


#: the process-wide registry
metrics = MetricsRegistry()


@contextmanager
def fit_step(sync: Optional[Callable[[], None]] = None):
    """Time one optimizer step into the ``estimator.step`` timer and count
    it in ``estimator.steps``. ``sync`` (the card's ``synchronize``) runs
    before the clock stops, so each entry is the step's device time, not
    its enqueue. Nothing is recorded for a step that raised."""
    start = time.perf_counter()
    yield
    if sync is not None:
        sync()
    metrics.timer("estimator.step").add_seconds(time.perf_counter() - start)
    metrics.counter("estimator.steps").add(1)


@contextmanager
def fit_checkpoint():
    """Time one checkpoint save's dispatch (the host snapshot of the
    payload) into the ``estimator.checkpoint`` timer and the
    ``estimator.checkpoint_ms`` histogram; the write behind it is
    :func:`record_commit`'s."""
    start = time.perf_counter()
    try:
        yield
    finally:
        elapsed = time.perf_counter() - start
        metrics.timer("estimator.checkpoint").add_seconds(elapsed)
        metrics.histogram("estimator.checkpoint_ms").observe(elapsed * 1e3)


def record_commit(seconds: float, nbytes: int) -> None:
    """One checkpoint's background commit: its time, from the writer's
    start to the rename, into the ``estimator.checkpoint_commit_ms``
    histogram; its bytes on disk into ``estimator.checkpoint_bytes``."""
    metrics.histogram("estimator.checkpoint_commit_ms").observe(seconds * 1e3)
    metrics.counter("estimator.checkpoint_bytes").add(nbytes)
