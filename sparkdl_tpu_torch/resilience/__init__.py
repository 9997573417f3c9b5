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
- ``inject``: deterministic fault plans fired at the fit loops' and the
  serving plane's sites.

Not ported yet (ROADMAP.md item 14): the flight recorder the JAX package
dumps on a preemption or a hard timeout, the trace events of retries and
breaker flips, and the fault sites of the replica plane (item 10b).
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
