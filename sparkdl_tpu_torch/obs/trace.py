"""Structured tracing: spans with parent/child nesting and *explicit*
cross-thread propagation.

Port of ``sparkdl_tpu.obs.trace`` (host code: a copy with the package
renamed). A :class:`Span` is one timed region with attributes and
point-in-time events; a :class:`Tracer` keeps the context-local current
span and delivers finished spans to sinks (:mod:`sparkdl_tpu_torch.obs.export`).
The serving plane (request, batch and decode spans), the data pipeline
(``map`` workers and ``prefetch`` threads re-enter the consumer's span) and
the streaming runner (run, poll, epoch and recover spans) are its callers.

Design rules:

- **disabled by default, pay-nothing**: every instrumentation site is
  gated on one attribute read (``tracer.enabled``); with tracing off the
  hot loops see a single branch, no allocation;
- **explicit propagation across threads**: the current span lives in a
  ``contextvars.ContextVar``, which deliberately does NOT leak into
  worker threads — a pipeline stage that moves work across a queue must
  ``capture()`` the span on the submitting side and re-attach it with
  :meth:`Tracer.use_span` on the worker (``data.prefetch`` / the
  threaded ``data.map`` / the serving micro-batcher all do; no ambient
  thread-local crosses a queue boundary silently);
- **monotonic timing, wall anchoring**: durations come from
  ``time.perf_counter`` (immune to clock steps); each span also records
  one ``time.time`` start so exported traces can be correlated with
  logs;
- **tail-aware sampling**: at production rates exporting every healthy
  span is waste — :meth:`Tracer.configure_sampling` keeps error spans
  and slow spans (``duration >= slow_ms``) unconditionally and samples
  the rest by a deterministic per-*trace* hash, so a kept trace is kept
  whole (no orphaned children).  Dropped spans count into
  ``sparkdl.spans_sampled_out``; context propagation is unaffected
  (sampling gates delivery to sinks, not span creation).
"""

from __future__ import annotations

import os
import random
import threading
import time
from contextlib import contextmanager
from typing import Any, Callable, Dict, List, Optional, Tuple

ENV_SEED = "SPARKDL_TRACE_SEED"

#: a remote span reference carried over the wire: ``(trace_id, span_id)``
RemoteParent = Tuple[int, int]


class _IdSource:
    """Process-seeded random 64-bit span/trace ids.

    Sequential per-process counters collide the moment traces are
    stitched across processes (every replica starts at 1), so ids come
    from a per-process ``random.Random``: seeded from ``os.urandom``
    normally, or — under ``SPARKDL_TRACE_SEED`` — deterministically from
    the seed mixed with ``os.getpid()``, so tests get reproducible ids
    per process while two replicas under the same seed still cannot
    collide.  The pid is re-checked on every draw: a fork gets a fresh
    stream instead of replaying the parent's.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._rng: Optional[random.Random] = None
        self._pid: Optional[int] = None

    def _reseed(self, pid: int) -> random.Random:
        seed_spec = os.environ.get(ENV_SEED, "").strip()
        if seed_spec:
            rng = random.Random(f"{seed_spec}:{pid}")
        else:
            rng = random.Random(int.from_bytes(os.urandom(8), "big") ^ pid)
        self._rng = rng
        self._pid = pid
        return rng

    def next_id(self) -> int:
        """A nonzero random 63-bit id (always positive, JSON-safe)."""
        pid = os.getpid()
        with self._lock:
            rng = self._rng
            if rng is None or pid != self._pid:
                rng = self._reseed(pid)
            return rng.getrandbits(63) | 1


_ids = _IdSource()


class Span:
    """One timed region of work.

    Created through :meth:`Tracer.span` / :meth:`Tracer.start_span` —
    never directly.  Thread-safe for ``event``/``set_attribute`` (a
    serving request span is touched by the submitter and the batch
    worker); ``end()`` is idempotent.
    """

    __slots__ = (
        "trace_id", "span_id", "parent_id", "name", "attributes",
        "events", "start_wall", "_start", "_end", "_tracer", "_lock",
    )

    def __init__(self, tracer: "Tracer", name: str,
                 parent: Optional["Span"], attributes: Dict[str, Any],
                 remote: Optional[RemoteParent] = None):
        self._tracer = tracer
        self.name = name
        self.span_id = _ids.next_id()
        if parent is not None:
            self.trace_id = parent.trace_id
            self.parent_id = parent.span_id
        elif remote is not None:
            # a parent in another process: its (trace_id, span_id) rode
            # the wire envelope — this span joins that trace
            self.trace_id = int(remote[0])
            self.parent_id = int(remote[1])
        else:
            self.trace_id = _ids.next_id()
            self.parent_id = None
        self.attributes = dict(attributes)
        self.events: List[Dict[str, Any]] = []
        self.start_wall = time.time()
        self._start = time.perf_counter()
        self._end: Optional[float] = None
        self._lock = threading.Lock()

    # ------------------------------------------------------------------
    def context(self) -> RemoteParent:
        """The wire form of this span: ``(trace_id, span_id)`` — what a
        client injects into the envelope so the remote side can open a
        child with ``start_span(..., remote=...)``."""
        return (self.trace_id, self.span_id)

    def set_attribute(self, key: str, value: Any) -> None:
        with self._lock:
            self.attributes[key] = value

    def event(self, name: str, **attrs: Any) -> None:
        """Record a point-in-time event (retry attempt, breaker flip,
        coalescing decision) with its offset from span start."""
        evt = {"name": name, "offset_ms": self.offset_ms(), **attrs}
        with self._lock:
            self.events.append(evt)

    def offset_ms(self) -> float:
        return (time.perf_counter() - self._start) * 1000.0

    @property
    def ended(self) -> bool:
        return self._end is not None

    @property
    def duration_ms(self) -> Optional[float]:
        if self._end is None:
            return None
        return (self._end - self._start) * 1000.0

    def end(self) -> None:
        """Close the span and deliver it to the tracer's sinks.
        Idempotent — a double end keeps the first timestamp."""
        with self._lock:
            if self._end is not None:
                return
            self._end = time.perf_counter()
        self._tracer._deliver(self)

    # ------------------------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        """The export form (what :class:`~sparkdl_tpu_torch.obs.export.
        JsonlTraceSink` writes, one JSON object per line)."""
        with self._lock:
            return {
                "name": self.name,
                "trace_id": self.trace_id,
                "span_id": self.span_id,
                "parent_id": self.parent_id,
                "start_unix_s": round(self.start_wall, 6),
                "duration_ms": (
                    round(self.duration_ms, 4) if self.ended else None
                ),
                "attributes": dict(self.attributes),
                "events": list(self.events),
            }

    def __repr__(self):
        state = f"{self.duration_ms:.2f}ms" if self.ended else "open"
        return (
            f"<Span {self.name!r} id={self.span_id} "
            f"parent={self.parent_id} {state}>"
        )


class Tracer:
    """Process-wide span factory + context-local current span.

    Off by default: :meth:`span` returns a no-op context and
    :meth:`current` returns None until :meth:`enable` installs at least
    the enabled flag (sinks are optional — spans without a sink still
    propagate context, e.g. for tests reading ``current()``).
    """

    def __init__(self):
        # contextvars (not threading.local): nested spans restore the
        # previous current on exit, and NEW threads start with no
        # current span — cross-thread propagation is explicit by design
        import contextvars

        self._current: "contextvars.ContextVar[Optional[Span]]" = (
            contextvars.ContextVar("sparkdl_current_span", default=None)
        )
        self._lock = threading.Lock()
        self._sinks: tuple = ()
        self.enabled = False
        # tail-aware sampling: 1.0 = keep everything (the default);
        # slow_ms None = no slow-span exemption configured
        self._sample_rate = 1.0
        self._sample_slow_ms: Optional[float] = None

    # -- lifecycle -----------------------------------------------------
    def enable(self, sink: Optional[Callable[[Dict[str, Any]], None]] = None
               ) -> "Tracer":
        """Turn tracing on, optionally adding ``sink`` (a callable
        receiving each finished span's ``to_dict()``)."""
        with self._lock:
            if sink is not None and sink not in self._sinks:
                self._sinks = self._sinks + (sink,)
            self.enabled = True
        return self

    def disable(self) -> None:
        """Turn tracing off, drop all sinks, and reset sampling (tests
        use this to restore the pay-nothing default)."""
        with self._lock:
            self.enabled = False
            self._sinks = ()
            self._sample_rate = 1.0
            self._sample_slow_ms = None

    def add_sink(self, sink: Callable[[Dict[str, Any]], None]) -> None:
        with self._lock:
            if sink not in self._sinks:
                self._sinks = self._sinks + (sink,)

    def remove_sink(self, sink: Callable[[Dict[str, Any]], None]) -> None:
        """Detach one sink; unknown sinks are ignored (teardown paths
        must be idempotent)."""
        with self._lock:
            self._sinks = tuple(s for s in self._sinks if s is not sink)

    def configure_sampling(
        self, rate: float, slow_ms: Optional[float] = None,
    ) -> None:
        """Tail-aware sampling policy for finished spans.

        ``rate`` is the keep probability for *healthy* traces in
        ``[0, 1]``; spans with an error attribute, and spans at least
        ``slow_ms`` long, are always kept — the tail is the signal.
        The keep decision hashes ``trace_id`` (Knuth multiplicative
        hash), so every span of a sampled trace is kept and every span
        of a dropped trace is dropped — no orphaned parents."""
        if not 0.0 <= rate <= 1.0:
            raise ValueError(f"sample rate must be in [0, 1], got {rate}")
        if slow_ms is not None and slow_ms < 0:
            raise ValueError(f"slow_ms must be >= 0, got {slow_ms}")
        with self._lock:
            self._sample_rate = float(rate)
            self._sample_slow_ms = None if slow_ms is None else float(slow_ms)

    def _sampled_out(self, span: Span) -> bool:
        """True when tail-aware sampling says to drop this span."""
        rate = self._sample_rate
        if rate >= 1.0:
            return False
        attrs = span.attributes
        if any(k in attrs for k in ("error", "error_class", "exception")):
            return False
        slow_ms = self._sample_slow_ms
        if slow_ms is not None:
            dur = span.duration_ms
            if dur is not None and dur >= slow_ms:
                return False
        # deterministic per-trace coin: Knuth multiplicative hash mapped
        # onto [0, 1) — same trace, same verdict, any process
        coin = ((span.trace_id * 2654435761) & 0xFFFFFFFF) / 2**32
        return coin >= rate

    def _deliver(self, span: Span) -> None:
        if self._sampled_out(span):
            from sparkdl_tpu_torch.utils.metrics import metrics

            metrics.counter("sparkdl.spans_sampled_out").add(1)
            return
        for sink in self._sinks:
            try:
                sink(span.to_dict())
            except Exception:  # pragma: no cover - a sink must not
                pass           # break the traced code path

    # -- context -------------------------------------------------------
    def current(self) -> Optional[Span]:
        """The context-local current span (None when tracing is off or
        no span is open on this thread/context)."""
        return self._current.get()

    def capture(self) -> Optional[Span]:
        """Explicit handle for crossing a queue/thread boundary: grab it
        on the submitting side, re-attach on the worker with
        :meth:`use_span`.  None when there is nothing to propagate —
        callers skip their wrapping entirely then (zero overhead)."""
        if not self.enabled:
            return None
        return self._current.get()

    @contextmanager
    def use_span(self, span: Optional[Span]):
        """Attach an EXISTING span as current for the block without
        ending it on exit — the cross-thread propagation primitive."""
        if span is None:
            yield None
            return
        token = self._current.set(span)
        try:
            yield span
        finally:
            self._current.reset(token)

    # -- cross-process stitching ---------------------------------------
    def ingest(self, span_dict: Dict[str, Any]) -> None:
        """Deliver an already-finished FOREIGN span dict straight to the
        sinks — the router calls this with replica spans piggybacked on
        a reply envelope.  No re-sampling: the emitting process already
        applied its tail-aware policy, and re-flipping the coin here
        could orphan a trace the replica chose to keep."""
        if not self.enabled:
            return
        for sink in self._sinks:
            try:
                sink(dict(span_dict))
            except Exception:  # pragma: no cover - a sink must not
                pass           # break the ingest path

    # -- span creation -------------------------------------------------
    def start_span(self, name: str, parent: Optional[Span] = None,
                   remote: Optional[RemoteParent] = None,
                   **attributes: Any) -> Optional[Span]:
        """A manually-ended span (serving request spans end from a
        future callback, not a ``with`` block).  Child of ``parent``
        (explicit), else of ``remote`` (a ``(trace_id, span_id)`` pair
        from another process's envelope), else of the current span;
        None when disabled."""
        if not self.enabled:
            return None
        if parent is None and remote is None:
            parent = self._current.get()
        return Span(self, name, parent, attributes, remote=remote)

    @contextmanager
    def span(self, name: str, parent: Optional[Span] = None,
             **attributes: Any):
        """Open a child span for the block: becomes the current span,
        ends (and is delivered) on exit.  With tracing disabled, yields
        None at the cost of one branch."""
        if not self.enabled:
            yield None
            return
        sp = self.start_span(name, parent=parent, **attributes)
        token = self._current.set(sp)
        try:
            yield sp
        finally:
            self._current.reset(token)
            sp.end()


#: the process-wide tracer (analog of ``utils.metrics.metrics``)
tracer = Tracer()


def current_span() -> Optional[Span]:
    """Module-level convenience for :meth:`Tracer.current`."""
    return tracer.current()


def record_event(name: str, **attrs: Any) -> None:
    """Attach an event to the current span, if any.

    The one-line hook low layers (``resilience``) call from cold paths:
    with tracing off it is a single attribute read, and with no span
    open it is a no-op — so a retry loop can always call it without
    knowing whether anyone is watching.
    """
    if not tracer.enabled:
        return
    span = tracer.current()
    if span is not None:
        span.event(name, **attrs)
