"""Preemption-safe fits and a resilient serving plane: a trimmed copy of
``sparkdl_tpu.resilience``.

- ``errors``: the transient/permanent taxonomy, :class:`Preempted`,
  ``CircuitOpen``, ``DeadlineExceeded`` and ``DeviceUnresponsive``;
- ``policy``: ``RetryPolicy``, ``Deadline`` and ``CircuitBreaker``, which
  the serving batcher wraps around each batch;
- ``watchdog``: ``watchdogged``, the soft and hard timeouts of the engine's
  compiles and loads, and ``check_device``;
- ``preempt``: the :func:`preemption_scope` whose token a fit loop polls at
  step boundaries;
- ``inject``: deterministic fault plans fired at the fit loops', the
  serving plane's and the replica plane's sites, and the ``act=`` rules
  the faulty network interprets.

Retries and breaker flips are events of the current trace span, and the
flight recorder (:mod:`sparkdl_tpu_torch.obs.blackbox`) dumps on a breaker's
trip, a preemption and a watchdog hard timeout.
"""

from sparkdl_tpu_torch.resilience.errors import (
    CircuitOpen,
    DeadlineExceeded,
    DeviceUnresponsive,
    PermanentError,
    Preempted,
    TransientError,
    classify,
    is_transient,
)
from sparkdl_tpu_torch.resilience.inject import FaultPlan, active_plan, fire
from sparkdl_tpu_torch.resilience.policy import CircuitBreaker, Deadline, RetryPolicy
from sparkdl_tpu_torch.resilience.preempt import (
    PreemptionToken,
    preemption_scope,
    request_preemption,
)
from sparkdl_tpu_torch.resilience.watchdog import check_device, watchdogged

__all__ = [
    "CircuitBreaker",
    "CircuitOpen",
    "Deadline",
    "DeadlineExceeded",
    "DeviceUnresponsive",
    "FaultPlan",
    "PermanentError",
    "Preempted",
    "PreemptionToken",
    "RetryPolicy",
    "TransientError",
    "active_plan",
    "check_device",
    "classify",
    "fire",
    "is_transient",
    "preemption_scope",
    "request_preemption",
    "watchdogged",
]
