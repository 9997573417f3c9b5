"""Host metrics of the batched transform loop and the fit loop.

A trimmed copy of ``sparkdl_tpu.utils.metrics``: the counters and timers the
hot loop advances (``sparkdl.load``, ``sparkdl.forward``, ``sparkdl.serve``,
``sparkdl.images_processed``, ``sparkdl.rows_processed``,
``sparkdl.batches_run``), so ``metrics.images_per_sec()`` reports the
sustained rate of the current process; the fit profiler
(:mod:`sparkdl_tpu_torch.obs.hooks`) keeps the ``estimator.*`` step and
checkpoint series, and :func:`record_commit` the background write behind
each save
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
snapshot gives the p50, p95 and p99 of the last 4096 observations, each
with an exemplar (the trace id of the worst windowed observation that
carried one); the data pipeline keeps ``data.*`` and the streaming runner
``streaming.*``. :meth:`MetricsRegistry.collect` is the one typed view
:func:`sparkdl_tpu_torch.obs.export.prometheus_text` renders. Thread-safe.
"""

from __future__ import annotations

import math
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Dict, List, Optional, Tuple


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
        self._entries = 0

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
            self._entries += 1

    @property
    def seconds(self) -> float:
        with self._lock:
            return self._seconds

    @property
    def entries(self) -> int:
        with self._lock:
            return self._entries


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
        #: exemplar refs (trace ids) appended in lockstep with ``_values``
        #: (same maxlen, so index i of one matches index i of the other);
        #: None for an observation without a trace
        self._exemplars: "deque[Optional[int]]" = deque(maxlen=HISTOGRAM_WINDOW)
        self._count = 0
        self._sum = 0.0

    def observe(self, value: float, exemplar: Optional[int] = None) -> None:
        with self._lock:
            self._values.append(float(value))
            self._exemplars.append(exemplar)
            self._count += 1
            self._sum += float(value)

    def exemplar(self) -> Optional[Tuple[float, int]]:
        """``(value, trace_id)`` of the largest windowed observation that
        carried an exemplar, or None: the one hop from a p99 outlier to
        the trace that produced it (read when scraped, never on observe)."""
        with self._lock:
            pairs = [(v, e) for v, e in zip(self._values, self._exemplars) if e is not None]
        if not pairs:
            return None
        return max(pairs, key=lambda p: p[0])

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

    @property
    def mean(self) -> Optional[float]:
        with self._lock:
            return (self._sum / self._count) if self._count else None

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

    def collect(self) -> Dict[str, Dict[str, object]]:
        """A point-in-time view of the registry by kind: ``{"counters":
        {name: Counter}, "timers": ..., "gauges": ..., "histograms": ...}``
        (each metric stays live and thread-safe to read): what exporters
        read instead of the registry's internals."""
        with self._lock:
            return {
                "counters": dict(self._counters),
                "timers": dict(self._timers),
                "gauges": dict(self._gauges),
                "histograms": dict(self._histograms),
            }

    def snapshot(self, prefix: Optional[str] = None) -> Dict[str, float]:
        """Flat dict of every counter and gauge value, timer total
        (``.seconds``) and, for each histogram with observations, its count,
        sum, mean, the p50, p95 and p99 of its window and its exemplar
        (``.count``, ``.sum``, ``.mean``, ``.p50``, ``.p95``, ``.p99``,
        ``.exemplar_value``, ``.exemplar_trace_id``), keeping only names
        that start with ``prefix`` when one is given."""
        view = self.collect()
        out: Dict[str, float] = {}
        for name, c in {**view["counters"], **view["gauges"]}.items():
            out[name] = c.value
        for name, t in view["timers"].items():
            out[name + ".seconds"] = t.seconds
        for name, h in view["histograms"].items():
            count = h.count
            if not count:
                continue
            out[name + ".count"] = float(count)
            out[name + ".sum"] = h.total
            out[name + ".mean"] = h.mean
            for q in (50, 95, 99):
                out[f"{name}.p{q}"] = h.quantile(q / 100)
            ex = h.exemplar()
            if ex is not None:
                # trace ids are 63-bit ints; a float cast would corrupt them
                out[name + ".exemplar_value"] = ex[0]
                out[name + ".exemplar_trace_id"] = ex[1]  # type: ignore[assignment]
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


def record_commit(seconds: float, nbytes: int) -> None:
    """One checkpoint's background commit: its time, from the writer's
    start to the rename, into the ``estimator.checkpoint_commit_ms``
    histogram; its bytes on disk into ``estimator.checkpoint_bytes``."""
    metrics.histogram("estimator.checkpoint_commit_ms").observe(seconds * 1e3)
    metrics.counter("estimator.checkpoint_bytes").add(nbytes)
