"""Sampling profiler: folded-stack attribution of where threads burn time.

Port of ``sparkdl_tpu.obs.profile`` (host code: a copy with the package
renamed). A flight recorder says the fleet stalled; a trace says *which request*
stalled; neither says what the process was **doing** — that takes a
profiler, and TensorFlow (PAPERS.md, arXiv:1605.08695) makes the case
that profiling belongs inside the serving system, not bolted on.  This
module is the smallest honest version: a background thread walks
``sys._current_frames()`` on a fixed wall-clock period and folds every
live thread's stack into ``file:function;file:function`` lines with hit
counts — the flame-graph input format — so a ``/debug/profile`` fetch
or an SLO-page blackbox dump shows the hot stacks, no external tooling.

Design rules (same posture as the tracer and flight recorder):

- **pay nothing when off**: no thread, no samples, no imports on the
  serving path; armed explicitly (:meth:`StackProfiler.start`) or by
  the ``SPARKDL_PROFILE`` env hook (:func:`enable_from_env`);
- **low overhead when on**: one stack walk per live thread per period
  (default 10 ms); the fold is string joins over code objects already
  in memory (the port's overhead on the card is not measured);
- **self-excluding**: the sampler never samples its own thread (its
  stack is by definition ``_run``), and window helpers exclude the
  waiting caller (:func:`profile_for`) — the profile shows the
  workload, not the profiler;
- **bounded**: at most ``max_stacks`` unique folded stacks are held;
  beyond that new stacks count into ``dropped_stacks`` instead of
  growing without bound;
- **injectable clock/sleep**: tests drive :meth:`sample_once` directly
  and never start the thread.

Metrics: ``profile.samples`` (stacks recorded), ``profile.overruns``
(periods where sampling ran past the interval — the overhead tell),
``profile.running`` gauge.
"""

from __future__ import annotations

import os
import sys
import threading
import time
from typing import Any, Dict, Iterable, List, Optional, Tuple

from sparkdl_tpu_torch.utils.metrics import metrics

ENV_PROFILE = "SPARKDL_PROFILE"

#: default sampling period: 10 ms ≈ 100 Hz — fine enough to rank hot
#: stacks over a few seconds, coarse enough to stay out of the way
DEFAULT_INTERVAL_S = 0.010

#: frames kept per stack (deeper frames fold into the leaf-most 64)
MAX_STACK_DEPTH = 64

#: unique folded stacks held before new ones drop into dropped_stacks
MAX_UNIQUE_STACKS = 4096


def _fold(frame, depth: int = MAX_STACK_DEPTH) -> str:
    """One thread's stack as a folded line, root first:
    ``file.py:outer;file.py:inner`` — the flame-graph input format."""
    parts: List[str] = []
    while frame is not None and len(parts) < depth:
        code = frame.f_code
        parts.append(
            f"{os.path.basename(code.co_filename)}:{code.co_name}"
        )
        frame = frame.f_back
    parts.reverse()
    return ";".join(parts)


class StackProfiler:
    """Periodic all-thread stack sampler with folded-stack aggregation.

    ``start()`` spawns the sampling thread; ``stop()`` joins it; the
    aggregate survives stop for reading (``folded()`` /
    ``folded_text()`` / ``snapshot()``).  ``sample_once()`` is the
    thread-free seam tests (and :func:`profile_for`) drive directly.
    """

    def __init__(
        self,
        interval_s: float = DEFAULT_INTERVAL_S,
        max_stacks: int = MAX_UNIQUE_STACKS,
        exclude_idents: Iterable[int] = (),
        clock=time.monotonic,
    ):
        if interval_s <= 0:
            raise ValueError(f"interval_s must be > 0, got {interval_s}")
        if max_stacks < 1:
            raise ValueError(f"max_stacks must be >= 1, got {max_stacks}")
        self.interval_s = float(interval_s)
        self._max_stacks = int(max_stacks)
        self._exclude = set(int(i) for i in exclude_idents)
        self._clock = clock
        self._lock = threading.Lock()
        self._stacks: Dict[str, int] = {}
        self._samples = 0
        self._dropped = 0
        self._started_at: Optional[float] = None
        self._active_s = 0.0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._m_samples = metrics.counter("profile.samples")
        self._m_overruns = metrics.counter("profile.overruns")
        self._m_running = metrics.gauge("profile.running")

    # ------------------------------------------------------------------
    # sampling
    # ------------------------------------------------------------------
    def sample_once(self) -> int:
        """Walk every live thread's stack once; returns the number of
        stacks recorded.  The sampler's own thread, the calling thread's
        configured excludes, and nothing else are skipped."""
        excluded = set(self._exclude)
        thread = self._thread
        if thread is not None and thread.ident is not None:
            excluded.add(thread.ident)
        n = 0
        for ident, frame in sys._current_frames().items():
            if ident in excluded:
                continue
            folded = _fold(frame)
            with self._lock:
                if (
                    folded not in self._stacks
                    and len(self._stacks) >= self._max_stacks
                ):
                    self._dropped += 1
                    continue
                self._stacks[folded] = self._stacks.get(folded, 0) + 1
                self._samples += 1
            n += 1
        if n:
            self._m_samples.add(n)
        return n

    def _run(self) -> None:
        next_t = self._clock()
        while not self._stop.is_set():
            self.sample_once()
            next_t += self.interval_s
            delay = next_t - self._clock()
            if delay <= 0:
                # sampling ran past the period — count it (the overhead
                # tell) and re-anchor instead of spinning to catch up
                self._m_overruns.add(1)
                next_t = self._clock()
                continue
            self._stop.wait(delay)

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------
    def start(self) -> "StackProfiler":
        """Spawn the sampling thread.  Idempotent."""
        with self._lock:
            if self._thread is not None:
                return self
            self._stop.clear()
            self._started_at = self._clock()
            self._thread = threading.Thread(
                target=self._run, name="sparkdl-profiler", daemon=True,
            )
        self._m_running.set(1.0)
        self._thread.start()
        return self

    def stop(self) -> "StackProfiler":
        """Stop and join the sampling thread; the aggregate remains
        readable.  Idempotent."""
        with self._lock:
            thread = self._thread
            self._thread = None
            if self._started_at is not None:
                self._active_s += self._clock() - self._started_at
                self._started_at = None
        self._stop.set()
        if thread is not None:
            thread.join(timeout=5.0)
        self._m_running.set(0.0)
        return self

    @property
    def running(self) -> bool:
        with self._lock:
            return self._thread is not None

    def reset(self) -> None:
        with self._lock:
            self._stacks.clear()
            self._samples = 0
            self._dropped = 0
            self._active_s = 0.0
            if self._started_at is not None:
                self._started_at = self._clock()

    # ------------------------------------------------------------------
    # reading
    # ------------------------------------------------------------------
    def folded(self) -> Dict[str, int]:
        """A copy of the folded-stack counts."""
        with self._lock:
            return dict(self._stacks)

    def folded_text(self, top: Optional[int] = None) -> str:
        """``stack count`` lines, hottest first — feed straight into any
        flame-graph renderer."""
        ranked = sorted(
            self.folded().items(), key=lambda kv: (-kv[1], kv[0])
        )
        if top is not None:
            ranked = ranked[:top]
        return "\n".join(f"{s} {c}" for s, c in ranked) + (
            "\n" if ranked else ""
        )

    def snapshot(self, top: int = 50) -> Dict[str, Any]:
        """JSON-safe summary: totals plus the ``top`` hottest stacks."""
        with self._lock:
            stacks = dict(self._stacks)
            samples = self._samples
            dropped = self._dropped
            active = self._active_s
            if self._started_at is not None:
                active += self._clock() - self._started_at
            running = self._thread is not None
        ranked: List[Tuple[str, int]] = sorted(
            stacks.items(), key=lambda kv: (-kv[1], kv[0])
        )[:top]
        return {
            "running": running,
            "interval_s": self.interval_s,
            "duration_s": round(active, 3),
            "samples": samples,
            "unique_stacks": len(stacks),
            "dropped_stacks": dropped,
            "top": [
                {"stack": s, "count": c, "share": (c / samples)}
                for s, c in ranked
            ] if samples else [],
        }


def profile_for(
    seconds: float,
    interval_s: float = DEFAULT_INTERVAL_S,
    sleep=time.sleep,
) -> Dict[str, Any]:
    """Run a dedicated bounded sampling window and return its snapshot —
    the ``/debug/profile?seconds=N`` payload.  The calling thread (which
    only sleeps out the window) is excluded, so the profile shows the
    workload, not the waiter."""
    if seconds <= 0:
        raise ValueError(f"seconds must be > 0, got {seconds}")
    p = StackProfiler(
        interval_s=interval_s, exclude_idents=(threading.get_ident(),),
    )
    p.start()
    try:
        sleep(seconds)
    finally:
        p.stop()
    return p.snapshot()


# ---------------------------------------------------------------------------
# process-wide arming
# ---------------------------------------------------------------------------

#: the env-armed process-wide profiler, if any (see enable_from_env)
_profiler: Optional[StackProfiler] = None


def profiler() -> Optional[StackProfiler]:
    """The env-armed process-wide profiler, if any — what the flight
    recorder folds into its dumps (an SLO page then carries the hot
    stacks of the stall, not just that it stalled)."""
    return _profiler


def enable_from_env() -> Optional[StackProfiler]:
    """Arm and start the process-wide profiler when ``SPARKDL_PROFILE``
    is set: ``1``/``on``/``true`` uses the default 10 ms period, a
    number is the period in **milliseconds**.  Idempotent; ``0``/``off``
    leaves it unarmed."""
    global _profiler
    spec = os.environ.get(ENV_PROFILE, "").strip().lower()
    if not spec or spec in ("0", "off", "false") or _profiler is not None:
        return _profiler
    if spec in ("1", "on", "true"):
        interval_s = DEFAULT_INTERVAL_S
    else:
        try:
            interval_s = max(0.001, float(spec) / 1000.0)
        except ValueError:
            interval_s = DEFAULT_INTERVAL_S
    _profiler = StackProfiler(interval_s=interval_s).start()
    return _profiler
