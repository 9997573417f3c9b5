"""Bounded in-memory metric time-series: the signal the SLO engine steers
by.

Port of ``sparkdl_tpu.obs.timeseries`` (host code: a copy with the package
renamed).

``MetricsRegistry`` answers "what is the value NOW"; an SLO burn rate,
a ``rate()`` panel, or a post-mortem needs "what was it over the last
window".  :class:`TimeSeriesRecorder` closes that gap: a background
thread samples :meth:`~sparkdl_tpu_torch.utils.metrics.MetricsRegistry.
snapshot` on a fixed interval into per-metric ring buffers and answers
windowed queries — ``rate()``, ``delta()``, quantile-over-window —
without a Prometheus server in the loop.

Design rules:

- **hard memory caps**: at most ``max_series`` distinct series (new
  names past the cap are dropped and counted in ``ts.series_dropped``)
  and at most ``max_points`` points per series (drop-oldest ring) — at
  the defaults that is ~512 series × 600 points × 2 floats, single-digit
  MB worst case, bounded regardless of uptime;
- **never on a hot path**: sampling runs on the recorder's own daemon
  thread; the registry snapshot is taken *before* the recorder's lock so
  a slow reader never extends the critical section;
- **injectable clock**: ``clock``/``sample_once(now=...)`` let the SLO
  tests drive windows synthetically, the same seam
  ``resilience.policy.Deadline`` exposes.

Series naming follows the registry snapshot's flat form: a counter or
gauge keeps its dotted name; a timer contributes ``<name>.seconds``;
a histogram contributes ``<name>.count`` / ``<name>.mean`` /
``<name>.p50|p95|p99``.  The recorder's own ``ts.*`` metrics are
excluded from sampling (a recorder must not spend its caps observing
itself).
"""

from __future__ import annotations

import math
import threading
import time
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

from sparkdl_tpu_torch.utils.metrics import MetricsRegistry, metrics

#: one sample: (timestamp from the recorder's clock, value)
Point = Tuple[float, float]


def _interpolated_quantile(values: List[float], q: float) -> Optional[float]:
    """Linear-interpolated quantile (the Histogram convention) over a
    plain list; None when empty."""
    if not 0.0 <= q <= 1.0:
        raise ValueError(f"quantile must be in [0, 1], got {q}")
    if not values:
        return None
    data = sorted(values)
    rank = q * (len(data) - 1)
    lo = math.floor(rank)
    hi = min(lo + 1, len(data) - 1)
    frac = rank - lo
    return data[lo] * (1.0 - frac) + data[hi] * frac


class TimeSeriesRecorder:
    """Sample the registry on an interval; answer windowed queries.

    ``start()`` launches the sampling thread; tests call
    :meth:`sample_once` with an explicit ``now`` instead and never start
    it.  All query methods are thread-safe and lock only long enough to
    copy the relevant ring.
    """

    def __init__(
        self,
        registry: Optional[MetricsRegistry] = None,
        interval_s: float = 1.0,
        max_points: int = 600,
        max_series: int = 512,
        clock=time.monotonic,
    ):
        if interval_s <= 0:
            raise ValueError(f"interval_s must be > 0, got {interval_s}")
        if max_points < 2:
            raise ValueError(f"max_points must be >= 2, got {max_points}")
        if max_series < 1:
            raise ValueError(f"max_series must be >= 1, got {max_series}")
        self._registry = registry if registry is not None else metrics
        self.interval_s = float(interval_s)
        self.max_points = int(max_points)
        self.max_series = int(max_series)
        self._clock = clock
        self._lock = threading.Lock()
        self._series: Dict[str, Deque[Point]] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._m_samples = self._registry.counter("ts.samples")
        self._m_dropped = self._registry.counter("ts.series_dropped")
        self._m_active = self._registry.gauge("ts.active_series")

    # ------------------------------------------------------------------
    # sampling
    # ------------------------------------------------------------------
    def sample_once(self, now: Optional[float] = None) -> int:
        """Take one sample of every metric; returns the number of series
        updated.  ``now`` overrides the clock (synthetic-time tests)."""
        # snapshot BEFORE taking our lock: the registry does its own
        # locking, and quantile computation can sort thousands of floats
        snap = self._registry.snapshot()
        t = self._clock() if now is None else float(now)
        updated = 0
        with self._lock:
            for name, value in snap.items():
                if name.startswith("ts."):
                    continue  # never observe ourselves into the caps
                ring = self._series.get(name)
                if ring is None:
                    if len(self._series) >= self.max_series:
                        self._m_dropped.add(1)
                        continue
                    ring = deque(maxlen=self.max_points)
                    self._series[name] = ring
                ring.append((t, float(value)))
                updated += 1
            self._m_active.set(len(self._series))
        self._m_samples.add(1)
        return updated

    def record(self, name: str, value: float,
               now: Optional[float] = None) -> bool:
        """Inject one point into series ``name`` directly — the seam the
        fleet collector uses to merge *scraped* replica metrics into the
        same store the SLO engine queries (they never appear in this
        process's registry snapshot).  Subject to the same series cap
        and per-series ring as sampled points; returns False when the
        series cap drops the point."""
        t = self._clock() if now is None else float(now)
        with self._lock:
            ring = self._series.get(name)
            if ring is None:
                if len(self._series) >= self.max_series:
                    self._m_dropped.add(1)
                    return False
                ring = deque(maxlen=self.max_points)
                self._series[name] = ring
                self._m_active.set(len(self._series))
            ring.append((t, float(value)))
        return True

    def start(self) -> "TimeSeriesRecorder":
        """Launch the background sampling thread (idempotent)."""
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return self
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, name="sparkdl-ts-recorder", daemon=True
            )
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        with self._lock:
            thread = self._thread
            self._thread = None
        if thread is not None and thread.is_alive():
            thread.join(timeout=max(2.0, 2 * self.interval_s))

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.sample_once()
            except Exception:  # pragma: no cover - sampling must not die
                pass

    # ------------------------------------------------------------------
    # queries
    # ------------------------------------------------------------------
    def series_names(self) -> List[str]:
        with self._lock:
            return sorted(self._series)

    def points(
        self, name: str, window_s: Optional[float] = None,
        now: Optional[float] = None,
    ) -> List[Point]:
        """Points of one series, oldest first; ``window_s`` keeps only
        points within the trailing window ending at ``now`` (default:
        the recorder's clock)."""
        with self._lock:
            ring = self._series.get(name)
            pts = list(ring) if ring is not None else []
        if window_s is None or not pts:
            return pts
        t = self._clock() if now is None else float(now)
        cutoff = t - float(window_s)
        return [p for p in pts if p[0] >= cutoff]

    def latest(self, name: str) -> Optional[float]:
        with self._lock:
            ring = self._series.get(name)
            return ring[-1][1] if ring else None

    def delta(
        self, name: str, window_s: float, now: Optional[float] = None,
    ) -> Optional[float]:
        """last - first over the window (a counter's increase); None
        with fewer than two points in the window."""
        pts = self.points(name, window_s, now=now)
        if len(pts) < 2:
            return None
        return pts[-1][1] - pts[0][1]

    def rate(
        self, name: str, window_s: float, now: Optional[float] = None,
    ) -> Optional[float]:
        """Per-second increase over the window, computed over the actual
        covered span (not the nominal window, which the ring may not
        reach yet); None with fewer than two points."""
        pts = self.points(name, window_s, now=now)
        if len(pts) < 2:
            return None
        elapsed = pts[-1][0] - pts[0][0]
        if elapsed <= 0:
            return None
        return (pts[-1][1] - pts[0][1]) / elapsed

    def quantile_over_window(
        self, name: str, q: float, window_s: float,
        now: Optional[float] = None,
    ) -> Optional[float]:
        """Interpolated quantile of the sampled VALUES in the window
        (e.g. the p95 of the sampled p99-latency series); None when the
        window holds no points."""
        pts = self.points(name, window_s, now=now)
        return _interpolated_quantile([v for _, v in pts], q)

    def fraction_where(
        self, name: str, predicate, window_s: float,
        now: Optional[float] = None,
    ) -> Optional[float]:
        """Fraction of windowed samples satisfying ``predicate(value)``
        — the SLO engine's "bad minutes / total minutes" primitive; None
        when the window holds no points."""
        pts = self.points(name, window_s, now=now)
        if not pts:
            return None
        bad = sum(1 for _, v in pts if predicate(v))
        return bad / len(pts)

    # ------------------------------------------------------------------
    # export
    # ------------------------------------------------------------------
    def snapshot(self, max_points: int = 120) -> Dict[str, List[Point]]:
        """``{series: [[t, v], ...]}`` with each series truncated to its
        most recent ``max_points`` — the ``/debug/timeseries`` payload."""
        with self._lock:
            return {
                name: [list(p) for p in list(ring)[-max_points:]]
                for name, ring in sorted(self._series.items())
            }

    def __repr__(self):
        with self._lock:
            n = len(self._series)
        return (
            f"TimeSeriesRecorder(series={n}/{self.max_series}, "
            f"interval_s={self.interval_s}, max_points={self.max_points})"
        )
