"""Retry with backoff, deadlines and circuit breaking: a copy of
``sparkdl_tpu.resilience.policy`` without its trace events and flight
recorder (the obs layer, ROADMAP item 14).

- :class:`RetryPolicy`: exponential backoff with deterministic jitter, an
  attempt cap and an optional total-sleep budget. It retries only what
  :func:`~sparkdl_tpu_torch.resilience.errors.classify` calls transient;
  permanent errors propagate on the first attempt, typed class intact.
- :class:`Deadline`: an absolute time bound threaded through retry loops;
  checking an expired one raises the typed
  :class:`~sparkdl_tpu_torch.resilience.errors.DeadlineExceeded`.
- :class:`CircuitBreaker`: closed -> open after a run of failures, open ->
  half-open after a recovery window, a half-open probe re-closes on
  success. The serving plane keeps one per endpoint.

All three count into ``resilience.*`` metrics.
"""

from __future__ import annotations

import logging
import random
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Iterator, Optional

from sparkdl_tpu_torch.resilience.errors import (
    CircuitOpen,
    DeadlineExceeded,
    is_transient,
)
from sparkdl_tpu_torch.utils.metrics import metrics

logger = logging.getLogger(__name__)


class Deadline:
    """An absolute bound on wall time, passed BY VALUE through call
    chains (unlike per-call timeouts, a deadline shrinks as work
    progresses — the grpc convention)."""

    __slots__ = ("_expires_at", "_clock", "what")

    def __init__(
        self,
        expires_at: Optional[float],
        clock: Callable[[], float] = time.monotonic,
        what: str = "work",
    ):
        self._expires_at = expires_at
        self._clock = clock
        self.what = what

    @classmethod
    def after(
        cls,
        seconds: Optional[float],
        clock: Callable[[], float] = time.monotonic,
        what: str = "work",
    ) -> "Deadline":
        """A deadline ``seconds`` from now; ``None`` means unbounded."""
        if seconds is None:
            return cls(None, clock, what)
        return cls(clock() + float(seconds), clock, what)

    def remaining(self) -> Optional[float]:
        """Seconds left (may be negative); None when unbounded."""
        if self._expires_at is None:
            return None
        return self._expires_at - self._clock()

    def expired(self) -> bool:
        rem = self.remaining()
        return rem is not None and rem <= 0

    def check(self) -> None:
        """Raise the typed :class:`DeadlineExceeded` when expired."""
        if self.expired():
            raise DeadlineExceeded(f"deadline expired for {self.what}")

    def __repr__(self):
        rem = self.remaining()
        bound = "unbounded" if rem is None else f"{rem:.3f}s left"
        return f"Deadline({self.what}: {bound})"


@dataclass
class RetryPolicy:
    """Exponential backoff + deterministic jitter + attempt cap + sleep
    budget.

    ``seed`` makes the jitter sequence reproducible — the same policy
    object produces the same delays on every :meth:`call`, so
    fault-injection tests are bit-deterministic.  ``sleep`` is
    injectable for tests (record delays instead of waiting them out).
    """

    max_attempts: int = 3
    base_delay_s: float = 0.05
    multiplier: float = 2.0
    max_delay_s: float = 5.0
    jitter: float = 0.1
    budget_s: Optional[float] = None
    seed: int = 0
    sleep: Callable[[float], None] = field(default=time.sleep, repr=False)

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError(
                f"max_attempts must be >= 1, got {self.max_attempts}"
            )
        if self.base_delay_s < 0 or self.max_delay_s < 0:
            raise ValueError("delays must be >= 0")
        if not 0 <= self.jitter <= 1:
            raise ValueError(f"jitter must be in [0, 1], got {self.jitter}")

    def delays(self) -> Iterator[float]:
        """The deterministic backoff sequence: delay before retry *i*
        (i.e. after failed attempt *i*), capped at ``max_delay_s``, each
        scaled by ``1 ± jitter`` from the seeded stream."""
        rng = random.Random(self.seed)
        for i in range(self.max_attempts - 1):
            raw = min(
                self.base_delay_s * (self.multiplier ** i), self.max_delay_s
            )
            yield raw * (1.0 + self.jitter * (2.0 * rng.random() - 1.0))

    def call(
        self,
        fn: Callable[..., Any],
        *args: Any,
        deadline: Optional[Deadline] = None,
        classify: Callable[[BaseException], bool] = is_transient,
        on_retry: Optional[Callable[[int, BaseException], None]] = None,
        **kwargs: Any,
    ) -> Any:
        """Run ``fn`` retrying transient failures.

        Permanent failures (per ``classify``) raise immediately.  A
        transient failure sleeps the next backoff delay — clipped to the
        deadline's remaining time and the policy's total sleep budget —
        and re-attempts; when attempts, budget, or deadline run out the
        LAST underlying exception is raised (typed class intact, never
        wrapped)."""
        slept = 0.0
        delays = self.delays()
        for attempt in range(1, self.max_attempts + 1):
            if deadline is not None:
                deadline.check()
            try:
                return fn(*args, **kwargs)
            except Exception as exc:
                if not classify(exc):
                    raise
                if attempt >= self.max_attempts:
                    metrics.counter("resilience.retry_exhausted").add(1)
                    raise
                delay = next(delays)
                if self.budget_s is not None:
                    if slept >= self.budget_s:
                        metrics.counter("resilience.retry_exhausted").add(1)
                        raise
                    delay = min(delay, self.budget_s - slept)
                if deadline is not None:
                    rem = deadline.remaining()
                    if rem is not None:
                        if rem <= 0:
                            metrics.counter(
                                "resilience.retry_exhausted"
                            ).add(1)
                            raise
                        delay = min(delay, rem)
                metrics.counter("resilience.retries").add(1)
                metrics.timer("resilience.backoff").add_seconds(delay)
                if on_retry is not None:
                    on_retry(attempt, exc)
                logger.debug(
                    "transient %s on attempt %d/%d; retrying in %.3fs",
                    type(exc).__name__, attempt, self.max_attempts, delay,
                )
                self.sleep(delay)
                slept += delay
        raise AssertionError("unreachable")  # pragma: no cover

    def wrap(self, fn: Callable[..., Any], **call_kw: Any) -> Callable:
        """``fn`` with this policy baked in (for pipeline stages that
        take a plain callable)."""
        def wrapped(*args: Any, **kwargs: Any) -> Any:
            return self.call(fn, *args, **call_kw, **kwargs)

        wrapped.__name__ = getattr(fn, "__name__", "wrapped")
        return wrapped


#: gauge encoding for breaker state
_STATE_VALUE = {"closed": 0.0, "half_open": 1.0, "open": 2.0}


class CircuitBreaker:
    """Closed/open/half-open breaker over a shared dependency.

    ``failure_threshold`` CONSECUTIVE failures open the circuit; while
    open, :meth:`allow` is False (callers raise or shed without touching
    the dependency).  After ``recovery_s`` the breaker half-opens and
    admits up to ``half_open_max`` probe calls: one success re-closes,
    one failure re-opens for another window.  Thread-safe — serving
    workers and retry loops share one instance per dependency.
    """

    def __init__(
        self,
        name: str = "default",
        failure_threshold: int = 5,
        recovery_s: float = 30.0,
        half_open_max: int = 1,
        clock: Callable[[], float] = time.monotonic,
    ):
        if failure_threshold < 1:
            raise ValueError(
                f"failure_threshold must be >= 1, got {failure_threshold}"
            )
        self.name = name
        self.failure_threshold = int(failure_threshold)
        self.recovery_s = float(recovery_s)
        self.half_open_max = int(half_open_max)
        self._clock = clock
        self._lock = threading.Lock()
        self._state = "closed"
        self._failures = 0
        self._opened_at: Optional[float] = None
        self._half_open_inflight = 0
        self._gauge = metrics.gauge(f"resilience.breaker_state.{name}")
        self._gauge.set(0.0)

    # -- transitions (callers hold the lock) ---------------------------
    def _to(self, state: str) -> None:
        self._state = state
        self._gauge.set(_STATE_VALUE[state])

    def allow(self) -> bool:
        """May a call proceed right now?  (Half-open admits probes up to
        ``half_open_max`` in flight.)"""
        with self._lock:
            if self._state == "closed":
                return True
            if self._state == "open":
                if (
                    self._opened_at is not None
                    and self._clock() - self._opened_at >= self.recovery_s
                ):
                    self._to("half_open")
                    self._half_open_inflight = 1
                    return True
                metrics.counter("resilience.breaker_rejections").add(1)
                return False
            # half_open
            if self._half_open_inflight < self.half_open_max:
                self._half_open_inflight += 1
                return True
            metrics.counter("resilience.breaker_rejections").add(1)
            return False

    def check(self) -> None:
        """Raise typed :class:`CircuitOpen` instead of returning False."""
        if not self.allow():
            raise CircuitOpen(
                f"circuit {self.name!r} is open "
                f"(recovery in <= {self.recovery_s}s)"
            )

    def record_success(self) -> None:
        with self._lock:
            self._failures = 0
            if self._state != "closed":
                self._to("closed")
                self._half_open_inflight = 0

    def record_failure(self) -> None:
        with self._lock:
            self._failures += 1
            if self._state == "half_open" or (
                self._state == "closed"
                and self._failures >= self.failure_threshold
            ):
                if self._state != "open":
                    metrics.counter("resilience.breaker_trips").add(1)
                    logger.warning(
                        "circuit %r opened after %d consecutive failures",
                        self.name, self._failures,
                    )
                self._to("open")
                self._opened_at = self._clock()
                self._half_open_inflight = 0

    def call(self, fn: Callable[..., Any], *args: Any, **kwargs: Any):
        """Run ``fn`` under the breaker: rejected-fast when open,
        outcome recorded otherwise."""
        self.check()
        try:
            result = fn(*args, **kwargs)
        except Exception:
            self.record_failure()
            raise
        self.record_success()
        return result

    @property
    def state(self) -> str:
        with self._lock:
            # surface recovery-window expiry without requiring a call
            if (
                self._state == "open"
                and self._opened_at is not None
                and self._clock() - self._opened_at >= self.recovery_s
            ):
                return "half_open_pending"
            return self._state

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "name": self.name,
                "state": self._state,
                "consecutive_failures": self._failures,
                "failure_threshold": self.failure_threshold,
                "recovery_s": self.recovery_s,
            }

    def __repr__(self):
        return f"CircuitBreaker({self.name!r}, state={self.state!r})"
