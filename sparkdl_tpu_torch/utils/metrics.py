"""Host metrics of the batched transform loop and the fit loop.

A trimmed copy of ``sparkdl_tpu.utils.metrics``: the counters and timers the
hot loop advances (``sparkdl.load``, ``sparkdl.forward``, ``sparkdl.serve``,
``sparkdl.images_processed``, ``sparkdl.rows_processed``,
``sparkdl.batches_run``), so ``metrics.images_per_sec()`` reports the
sustained rate of the current process; and the always-on part of
``sparkdl_tpu.obs.hooks``' fit profiler, :func:`fit_step` (the
``estimator.step`` timer and the ``estimator.steps`` counter). Trace spans
are not ported yet. Thread-safe.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Callable, Dict, Optional


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


class MetricsRegistry:
    """Process-wide named counters and timers."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._timers: Dict[str, Timer] = {}

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

    def snapshot(self, prefix: Optional[str] = None) -> Dict[str, float]:
        """Flat dict of every counter value and timer total (``.seconds``),
        keeping only names that start with ``prefix`` when one is given."""
        with self._lock:
            counters = dict(self._counters)
            timers = dict(self._timers)
        out: Dict[str, float] = {}
        for name, c in counters.items():
            out[name] = c.value
        for name, t in timers.items():
            out[name + ".seconds"] = t.seconds
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
