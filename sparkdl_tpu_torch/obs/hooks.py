"""Step-profiling hooks for the estimators' fit loop.

Port of ``sparkdl_tpu.obs.hooks``. Both estimators' fits run through
:func:`~sparkdl_tpu_torch.estimators.checkpointing.fit_epochs`, which wraps
its work in a :class:`FitProfiler`: one ``estimator.fit`` root span for the
whole call, a child ``estimator.step`` span per optimizer step and an
``estimator.checkpoint`` span around each save's dispatch, so a trace
answers "where did epoch 3 spend its time".

The profiler also feeds the always-on metrics (tracing may be off):

- the ``estimator.step`` timer, the ``estimator.step_ms`` histogram and the
  ``estimator.steps`` counter: each step's device time (the step's
  ``sync``, the card's ``synchronize``, runs before the clock stops);
- the ``estimator.host_stall_ms`` histogram: each epoch's host-stall
  DELTA read from the ``data.*`` instrumentation
  (``data.device_stall_ms``, ``data.producer_busy``), which attributes
  input-bound epochs without the estimator knowing its pipeline;
- the ``estimator.checkpoint`` timer and ``estimator.checkpoint_ms``
  histogram: save-dispatch durations (the commit behind it is
  :func:`~sparkdl_tpu_torch.utils.metrics.record_commit`'s; the dispatch
  blocks the step loop, so it is the number the loop cares about).

Retry attempts and breaker flips inside a step surface as events on
whatever span is current (``resilience.policy`` ->
:func:`sparkdl_tpu_torch.obs.trace.record_event`).
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Any, Callable, Optional

from sparkdl_tpu_torch.obs.trace import tracer
from sparkdl_tpu_torch.utils.metrics import metrics


class FitProfiler:
    """Per-fit instrumentation handle (see module docstring).

    Use as a context manager around the whole fit; call :meth:`step` /
    :meth:`checkpoint` around each unit of work and :meth:`epoch` at
    each epoch boundary.
    """

    def __init__(self, estimator: str, epochs: Optional[int] = None,
                 steps_per_epoch: Optional[int] = None):
        self.estimator = estimator
        self.epochs = epochs
        self.steps_per_epoch = steps_per_epoch
        self._span = None
        self._span_cm = None
        # data.* baselines: the fit attributes only ITS epochs' stall,
        # not whatever the process accumulated before
        self._stall_hist = metrics.histogram("data.device_stall_ms")
        self._busy_timer = metrics.timer("data.producer_busy")
        self._stall_base = 0.0
        self._busy_base = 0.0
        self._step_timer = metrics.timer("estimator.step")
        self._step_ms = metrics.histogram("estimator.step_ms")
        self._steps = metrics.counter("estimator.steps")
        self._ckpt_timer = metrics.timer("estimator.checkpoint")
        self._ckpt_ms = metrics.histogram("estimator.checkpoint_ms")
        self._epoch_stall = metrics.histogram("estimator.host_stall_ms")

    # ------------------------------------------------------------------
    def __enter__(self) -> "FitProfiler":
        self._span_cm = tracer.span(
            "estimator.fit",
            estimator=self.estimator,
            epochs=self.epochs,
            steps_per_epoch=self.steps_per_epoch,
        )
        self._span = self._span_cm.__enter__()
        self._stall_base = self._stall_hist.total
        self._busy_base = self._busy_timer.seconds
        return self

    def __exit__(self, *exc: Any) -> None:
        self._span_cm.__exit__(*exc)
        self._span = None

    # ------------------------------------------------------------------
    @contextmanager
    def step(self, sync: Optional[Callable[[], None]] = None, **attrs: Any):
        """Time one optimizer step; ``sync`` runs before the clock stops,
        so the time is the step's device time, not its enqueue. A step that
        raised is not counted in ``estimator.steps``."""
        t0 = time.perf_counter()
        with tracer.span("estimator.step", **attrs):
            try:
                yield
                if sync is not None:
                    sync()
                self._steps.add(1)
            finally:
                elapsed = time.perf_counter() - t0
                self._step_timer.add_seconds(elapsed)
                self._step_ms.observe(elapsed * 1000.0)

    def epoch(self, epoch: int, loss: Optional[float] = None) -> None:
        """Epoch boundary: attribute this epoch's host stall (delta of
        the ``data.*`` pipeline instrumentation since the last call)."""
        stall_total = self._stall_hist.total
        busy_total = self._busy_timer.seconds
        stall_ms = stall_total - self._stall_base
        busy_s = busy_total - self._busy_base
        self._stall_base = stall_total
        self._busy_base = busy_total
        self._epoch_stall.observe(stall_ms)
        if self._span is not None:
            self._span.event(
                "epoch",
                epoch=epoch,
                loss=loss,
                host_stall_ms=round(stall_ms, 3),
                producer_busy_s=round(busy_s, 6),
            )

    @contextmanager
    def checkpoint(self, **attrs: Any):
        """Time one checkpoint save dispatch (async commit excluded —
        it overlaps the next epoch by design)."""
        t0 = time.perf_counter()
        with tracer.span("estimator.checkpoint", **attrs):
            try:
                yield
            finally:
                elapsed = time.perf_counter() - t0
                self._ckpt_timer.add_seconds(elapsed)
                self._ckpt_ms.observe(elapsed * 1000.0)


def fit_profiler(estimator: str, epochs: Optional[int] = None,
                 steps_per_epoch: Optional[int] = None) -> FitProfiler:
    """The estimators' entry point (kept as a function so the call site
    reads like the other loop scaffolding)."""
    return FitProfiler(
        estimator, epochs=epochs, steps_per_epoch=steps_per_epoch
    )
