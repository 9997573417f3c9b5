"""Deterministic fault injection at the fit loops', the serving plane's,
the data pipeline's and the streaming runner's sites.

A trimmed copy of ``sparkdl_tpu.resilience.inject``: a :class:`FaultPlan`
is a list of rules keyed by site, each with a deterministic trigger (``at``,
the Nth call to that site, 1-based, firing on ``times`` consecutive calls)
and one action:

- ``error=``: raise an exception instance or class, or one of the
  shorthands ``"transient"``, ``"permanent"`` and ``"device"``;
- ``stall_s=``: block the call that long (what trips a watchdog);
- ``preempt=True``: a simulated SIGTERM through
  :func:`~sparkdl_tpu_torch.resilience.preempt.request_preemption`;
- ``kill=True``: ``os._exit(9)``, at once, with no ``finally`` and no
  ``atexit``: the stand-in for SIGKILL that proves a death between a
  payload and its commit marker never loses or doubles a record.

The sites:

- the fit loops: ``estimator.step`` before each step, ``estimator.epoch``
  after each epoch's steps, ``estimator.checkpoint_saved`` after each
  save's dispatch;
- the serving plane: ``serving.forward`` before each batch's forward,
  ``decode.step`` before each fused decode step, ``decode.stream`` before
  each emitted stream frame;
- the data pipeline: ``data.source`` before each file read, ``data.map``
  before each mapped item;
- the streaming runner: ``streaming.poll`` before each source poll,
  ``streaming.sink`` between an epoch's payload and its sink write,
  ``streaming.commit`` between the sink write and the commit marker;
- ``watchdog.<name>`` inside each watchdogged call.

Tests install plans with :func:`active_plan`; a whole process takes one
from the ``SPARKDL_FAULT_PLAN`` environment variable (a JSON list of rule
objects, read at import), which is how a worker subprocess is made to fail
on cue. With no plan active, :func:`fire` is one global read.

The ``act=`` rules that the replica plane's faulty network interprets, the
probabilistic ``p=`` trigger and the replica plane's sites come with that
plane (ROADMAP item 10b).
"""

from __future__ import annotations

import json
import os
import threading
import time
from contextlib import contextmanager
from typing import Dict, List, Optional, Union

from sparkdl_tpu_torch.resilience.errors import PermanentError, TransientError
from sparkdl_tpu_torch.utils.metrics import metrics

ENV_VAR = "SPARKDL_FAULT_PLAN"

#: the sites the port fires (and ``watchdog.<name>``)
KNOWN_SITES = (
    "estimator.step", "estimator.epoch", "estimator.checkpoint_saved",
    "serving.forward", "decode.step", "decode.stream",
    "data.source", "data.map",
    "streaming.poll", "streaming.sink", "streaming.commit",
)


class InjectedTransientError(TransientError):
    """A planned transient fault (told apart from real ones)."""


class InjectedPermanentError(PermanentError):
    """A planned permanent fault."""


class InjectedDeviceError(TransientError):
    """A planned transient device fault."""


_ERROR_SHORTHANDS = {
    "transient": InjectedTransientError,
    "permanent": InjectedPermanentError,
    "device": InjectedDeviceError,
}

Error = Union[None, str, BaseException, type]


class Rule:
    """One (site, trigger, action) entry of a plan."""

    def __init__(self, site: str, at: int, preempt: bool = False, error: Error = None,
                 times: int = 1, kill: bool = False, stall_s: Optional[float] = None):
        if site not in KNOWN_SITES and not site.startswith("watchdog."):
            raise ValueError(f"unknown fault site {site!r}; the port fires {KNOWN_SITES}")
        actions = int(bool(preempt)) + int(bool(kill)) + sum(
            a is not None for a in (error, stall_s))
        if actions != 1:
            raise ValueError("a rule needs exactly one action "
                             "(error= / stall_s= / preempt=True / kill=True)")
        if isinstance(error, str) and error not in _ERROR_SHORTHANDS:
            raise ValueError(f"unknown error shorthand {error!r}; use {sorted(_ERROR_SHORTHANDS)}")
        self.site = site
        self.at = int(at)
        self.times = int(times)
        self.preempt = bool(preempt)
        self.kill = bool(kill)
        self.stall_s = None if stall_s is None else float(stall_s)
        self.error = error

    def triggered(self, count: int) -> bool:
        return self.at <= count < self.at + self.times

    def make_error(self) -> BaseException:
        err = self.error
        if isinstance(err, BaseException):
            return err
        if isinstance(err, str):
            return _ERROR_SHORTHANDS[err](f"injected {err} fault at {self.site!r}")
        return err(f"injected fault at {self.site!r}")


class FaultPlan:
    """A deterministic schedule of faults: per-site call counters live in
    the plan, so two runs with the same plan and workload fire alike."""

    def __init__(self):
        self._rules: List[Rule] = []
        self._counts: Dict[str, int] = {}
        self._lock = threading.Lock()

    def add(self, site: str, **rule_kw) -> "FaultPlan":
        """Append a :class:`Rule`; returns ``self``."""
        self._rules.append(Rule(site, **rule_kw))
        return self

    def count(self, site: str) -> int:
        """How many times ``site`` fired under this plan."""
        with self._lock:
            return self._counts.get(site, 0)

    @classmethod
    def from_json(cls, text: str) -> "FaultPlan":
        """A plan from a JSON list of rule objects (the ``SPARKDL_FAULT_PLAN``
        format), e.g. ``[{"site": "streaming.commit", "kill": true, "at": 2}]``."""
        rules = json.loads(text)
        if not isinstance(rules, list):
            raise ValueError(f"{ENV_VAR} must be a JSON list of rule objects")
        plan = cls()
        for rule in rules:
            plan.add(**rule)
        return plan

    def _fire(self, site: str) -> None:
        with self._lock:
            count = self._counts.get(site, 0) + 1
            self._counts[site] = count
            hits = [r for r in self._rules if r.site == site and r.triggered(count)]
        for rule in hits:
            metrics.counter("resilience.injected_faults").add(1)
            if rule.kill:
                os._exit(9)
            if rule.stall_s is not None:
                time.sleep(rule.stall_s)
                continue
            if rule.preempt:
                from sparkdl_tpu_torch.resilience import preempt

                preempt.request_preemption(f"injected preemption at {site!r}")
                continue
            raise rule.make_error()


#: the installed plan (one from the environment is installed at import, so
#: a worker subprocess runs under it with no code of its own)
_ACTIVE: Optional[FaultPlan] = None


def fire(site: str) -> None:
    """Fault-injection hook: a no-op unless a plan is active and has a
    triggered rule for ``site``."""
    plan = _ACTIVE
    if plan is not None:
        plan._fire(site)


@contextmanager
def active_plan(plan: FaultPlan):
    """Install ``plan`` for the block (its counters reset on entry, so a
    reused plan fires again alike)."""
    global _ACTIVE
    previous = _ACTIVE
    with plan._lock:
        plan._counts.clear()
    _ACTIVE = plan
    try:
        yield plan
    finally:
        _ACTIVE = previous


def plan_from_env() -> Optional[FaultPlan]:
    """The plan ``SPARKDL_FAULT_PLAN`` names, or None."""
    text = os.environ.get(ENV_VAR)
    return FaultPlan.from_json(text) if text else None


_ACTIVE = plan_from_env()
