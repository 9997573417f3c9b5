"""Preemption-safe fits: a trimmed copy of ``sparkdl_tpu.resilience``.

What the estimators' fit loops need to survive a scheduler's SIGTERM and to
be tested for it: the typed :class:`Preempted` (``errors``), the
:func:`preemption_scope` whose token the loop polls at step boundaries
(``preempt``), and the deterministic fault plans fired at the loops' three
sites, ``estimator.step``, ``estimator.epoch`` and
``estimator.checkpoint_saved`` (``inject``).

Not ported yet (ROADMAP.md item 14): the flight recorder the JAX package
dumps on a preemption, the retry policies, deadlines and circuit breaker,
the watchdog, the error taxonomy and every other fault site.
"""

from sparkdl_tpu_torch.resilience.errors import Preempted
from sparkdl_tpu_torch.resilience.inject import FaultPlan, active_plan, fire
from sparkdl_tpu_torch.resilience.preempt import (
    PreemptionToken,
    preemption_scope,
    request_preemption,
)

__all__ = [
    "FaultPlan",
    "Preempted",
    "PreemptionToken",
    "active_plan",
    "fire",
    "preemption_scope",
    "request_preemption",
]
