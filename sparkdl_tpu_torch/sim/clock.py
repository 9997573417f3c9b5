"""Virtual clock and deterministic discrete-event loop.

The whole control plane takes an injectable ``clock=`` (router, batcher,
admission queue, autoscaler, rollout controller, SLO engine, time-series
recorder): a :class:`VirtualClock` is a zero-argument callable
interchangeable with ``time.monotonic``, advanced only by the
:class:`EventLoop` as it pops events in ``(time, sequence)`` order.
Determinism contract: the same schedule calls in the same order give the
same execution order and bit-identical timestamps. There is no wall clock
anywhere in the loop, which is also why a replay runs orders of magnitude
faster than the traffic it replays.
"""

from __future__ import annotations

import heapq
from typing import Any, Callable, List, Optional, Tuple


class ClockWentBackwards(RuntimeError):
    """The one invariant a controller may assume about its clock seam:
    consecutive reads never decrease.  Raised instead of silently
    rewinding when an event is scheduled before the current virtual
    time (a harness bug, never survivable)."""


class VirtualClock:
    """A monotone virtual time source, drop-in for ``time.monotonic``.

    Seconds-since-epoch-zero floats; :meth:`advance_to` is the only
    mutation and refuses to go backwards.
    """

    __slots__ = ("_now",)

    def __init__(self, start: float = 0.0):
        self._now = float(start)

    def __call__(self) -> float:
        return self._now

    @property
    def now(self) -> float:
        return self._now

    def advance_to(self, t: float) -> None:
        if t < self._now - 1e-12:
            raise ClockWentBackwards(
                f"virtual clock asked to rewind {self._now} -> {t}"
            )
        if t > self._now:
            self._now = t

    def __repr__(self):
        return f"VirtualClock(now={self._now})"


class EventLoop:
    """Min-heap of ``(time, seq, fn, args)``; :meth:`run` pops in order,
    advances the shared :class:`VirtualClock`, and calls each handler.

    ``seq`` (a monotone counter) breaks time ties by schedule order, so
    two events at the same virtual instant always run in the order they
    were scheduled — the determinism the byte-identical event-log test
    asserts.  Handlers may schedule further events, including at the
    current instant (they run after everything already queued there).
    """

    def __init__(self, clock: VirtualClock):
        self.clock = clock
        self._heap: List[Tuple[float, int, Callable, tuple]] = []
        self._seq = 0
        self._processed = 0

    def __len__(self) -> int:
        return len(self._heap)

    @property
    def processed(self) -> int:
        """Events executed so far (the replay report's event count)."""
        return self._processed

    def schedule(self, t: float, fn: Callable, *args: Any) -> None:
        """Run ``fn(*args)`` at virtual time ``t``.  Scheduling in the
        past is a harness bug — raise rather than reorder history."""
        t = float(t)
        if t < self.clock.now - 1e-12:
            raise ClockWentBackwards(
                f"event scheduled at {t} but the clock is at "
                f"{self.clock.now}"
            )
        t = max(t, self.clock.now)
        heapq.heappush(self._heap, (t, self._seq, fn, args))
        self._seq += 1

    def run(self, until: Optional[float] = None) -> int:
        """Drain the heap (or up to virtual time ``until``, inclusive);
        returns the number of events processed by this call."""
        n0 = self._processed
        while self._heap:
            if until is not None and self._heap[0][0] > until:
                break
            t, _, fn, args = heapq.heappop(self._heap)
            self.clock.advance_to(t)
            fn(*args)
            self._processed += 1
        return self._processed - n0

    def __repr__(self):
        return (
            f"EventLoop(now={self.clock.now}, pending={len(self._heap)}, "
            f"processed={self._processed})"
        )
