"""Deterministic fault injection at the fit loops', the serving plane's,
the data pipeline's and the streaming runner's sites.

A trimmed copy of ``sparkdl_tpu.resilience.inject``: a :class:`FaultPlan`
is a list of rules keyed by site, each with a deterministic trigger (``at``,
the Nth call to that site, 1-based, firing on ``times`` consecutive calls;
or ``p``, a probability drawn from the plan's seeded generator) and one
action:

- ``error=``: raise an exception instance or class, or one of the
  shorthands ``"transient"``, ``"permanent"`` and ``"device"``;
- ``stall_s=``: block the call that long (what trips a watchdog);
- ``preempt=True``: a simulated SIGTERM through
  :func:`~sparkdl_tpu_torch.resilience.preempt.request_preemption`;
- ``kill=True``: ``os._exit(9)``, at once, with no ``finally`` and no
  ``atexit``: the stand-in for SIGKILL that proves a death between a
  payload and its commit marker never loses or doubles a record;
- ``act=``: a verb this module only *selects* (:func:`decide`) and its
  consumer interprets: the faulty network
  (:mod:`sparkdl_tpu_torch.serving.faultnet`) reads ``corrupt_body``,
  ``corrupt_header``, ``truncate``, ``dup``, ``disconnect`` and
  ``drop_reply``. :func:`fire` never executes an ``act=`` rule.

The sites, by subsystem, are :data:`KNOWN_SITES` (and ``watchdog.<name>``
inside each watchdogged call); a rule for any other site is refused.

Tests install plans with :func:`active_plan`; a whole process takes one
from the ``SPARKDL_FAULT_PLAN`` environment variable (a JSON list of rule
objects, read at import, seeded by ``SPARKDL_FAULT_PLAN_SEED``), which is
how a worker subprocess or a replica is made to fail on cue. With no plan
active, :func:`fire` is one global read.
"""

from __future__ import annotations

import json
import os
import random
import threading
import time
from contextlib import contextmanager
from typing import Any, Dict, List, Optional, Union

from sparkdl_tpu_torch.resilience.errors import PermanentError, TransientError
from sparkdl_tpu_torch.utils.metrics import metrics

ENV_VAR = "SPARKDL_FAULT_PLAN"

#: every :func:`fire` and :func:`decide` site the port instruments, by
#: subsystem (and ``watchdog.<name>``)
KNOWN_SITES = {
    # before each fit step, after each epoch's steps, after each save's
    # dispatch
    "estimator": ("estimator.step", "estimator.epoch", "estimator.checkpoint_saved"),
    # before each batch's forward
    "serving": ("serving.forward",),
    # before each fused decode step, before each emitted stream frame
    "decode": ("decode.step", "decode.stream"),
    # before each file read, before each mapped item
    "data": ("data.source", "data.map"),
    # before each poll, between an epoch's payload and its sink write,
    # between the sink write and the commit marker
    "streaming": ("streaming.poll", "streaming.sink", "streaming.commit"),
    "supervisor": (
        # in the supervisor's process
        "supervisor.spawn", "supervisor.health", "supervisor.restart",
        # in the replica's process: a kill rule here takes out ONE replica
        "supervisor.replica_warm", "supervisor.replica_serve",
    ),
    "router": ("router.route",),
    # the router's shm request path: error and stall rules exercise the
    # lane's failure handling without killing the router
    "wire": ("wire.shm",),
    # decision sites of the faulty network: faultnet.tx guards every
    # encoded frame that leaves a process (both lanes), faultnet.request
    # and faultnet.reply bracket one FaultyTransport round trip
    "faultnet": ("faultnet.request", "faultnet.reply", "faultnet.tx"),
    # the router's result-cache lookup, before fingerprint resolution: an
    # error here must degrade to the miss path, never to a request error
    "cache": ("cache.lookup",),
    # blue/green rollout transitions (RolloutController): shift fires
    # before each weight change, bake before each canary evaluation,
    # rollback as a rollback begins (which must never stop it)
    "rollout": ("rollout.shift", "rollout.bake", "rollout.rollback"),
}


def known_sites() -> tuple:
    """Every registered fault site, flat and sorted."""
    return tuple(sorted(site for sites in KNOWN_SITES.values() for site in sites))


_SITES = frozenset(known_sites())


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

    def __init__(self, site: str, at: Optional[int] = None, preempt: bool = False,
                 error: Error = None, times: int = 1, kill: bool = False,
                 stall_s: Optional[float] = None, act: Optional[str] = None,
                 p: Optional[float] = None):
        if site not in _SITES and not site.startswith("watchdog."):
            raise ValueError(f"unknown fault site {site!r}; the port fires {known_sites()}")
        actions = int(bool(preempt)) + int(bool(kill)) + sum(
            a is not None for a in (error, stall_s, act))
        if actions != 1:
            raise ValueError("a rule needs exactly one action "
                             "(error= / stall_s= / preempt=True / kill=True / act=)")
        if (at is None) == (p is None):
            raise ValueError("a rule needs exactly one trigger (at= or p=)")
        if isinstance(error, str) and error not in _ERROR_SHORTHANDS:
            raise ValueError(f"unknown error shorthand {error!r}; use {sorted(_ERROR_SHORTHANDS)}")
        self.site = site
        self.at = None if at is None else int(at)
        self.p = None if p is None else float(p)
        self.times = int(times)
        self.preempt = bool(preempt)
        self.kill = bool(kill)
        self.stall_s = None if stall_s is None else float(stall_s)
        self.error = error
        #: the verb a consumer interprets (see :func:`decide`)
        self.act = act

    def triggered(self, count: int, rng: random.Random) -> bool:
        if self.at is not None:
            return self.at <= count < self.at + self.times
        return rng.random() < self.p

    def make_error(self) -> BaseException:
        err = self.error
        if isinstance(err, BaseException):
            return err
        if isinstance(err, str):
            return _ERROR_SHORTHANDS[err](f"injected {err} fault at {self.site!r}")
        return err(f"injected fault at {self.site!r}")

    def describe(self) -> dict:
        trigger = {"at": self.at, "times": self.times} if self.at is not None else {"p": self.p}
        action = ("kill" if self.kill
                  else "preempt" if self.preempt
                  else f"stall {self.stall_s}s" if self.stall_s is not None
                  else f"act {self.act}" if self.act is not None
                  else f"error {self.error!r}")
        return {"site": self.site, "action": action, **trigger}


class FaultPlan:
    """A seeded, deterministic schedule of faults: per-site call counters
    live in the plan, so two runs with the same plan and workload fire
    alike, and ``seed`` pins the ``p=`` rules too."""

    def __init__(self, seed: int = 0):
        self._rules: List[Rule] = []
        self._counts: Dict[str, int] = {}
        self._lock = threading.Lock()
        self._rng = random.Random(int(seed))

    def add(self, site: str, **rule_kw: Any) -> "FaultPlan":
        """Append a :class:`Rule`; returns ``self``."""
        self._rules.append(Rule(site, **rule_kw))
        return self

    def count(self, site: str) -> int:
        """How many times ``site`` fired under this plan."""
        with self._lock:
            return self._counts.get(site, 0)

    def sites(self) -> tuple:
        """The sorted sites this plan has rules for (faultnet hooks in only
        when one of its sites is among them)."""
        return tuple(sorted({r.site for r in self._rules}))

    def reset(self) -> None:
        with self._lock:
            self._counts.clear()

    def describe(self) -> List[dict]:
        return [r.describe() for r in self._rules]

    @classmethod
    def from_json(cls, text: str, seed: int = 0) -> "FaultPlan":
        """A plan from a JSON list of rule objects (the ``SPARKDL_FAULT_PLAN``
        format), e.g. ``[{"site": "streaming.commit", "kill": true, "at": 2}]``."""
        rules = json.loads(text)
        if not isinstance(rules, list):
            raise ValueError(f"{ENV_VAR} must be a JSON list of rule objects")
        plan = cls(seed=seed)
        for rule in rules:
            plan.add(**rule)
        return plan

    def _hits(self, site: str) -> List[Rule]:
        """Count one call to ``site``; the rules it triggers."""
        with self._lock:
            count = self._counts.get(site, 0) + 1
            self._counts[site] = count
            return [r for r in self._rules if r.site == site and r.triggered(count, self._rng)]

    def decide(self, site: str) -> List[Rule]:
        """The triggered rules of ``site``, NOT executed: counts the call as
        :func:`fire` does and each triggered rule as an injected fault, for
        a consumer that interprets the rules itself."""
        hits = self._hits(site)
        if hits:
            metrics.counter("resilience.injected_faults").add(len(hits))
        return hits

    def _fire(self, site: str) -> None:
        for rule in [r for r in self._hits(site) if r.act is None]:
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


def installed_plan() -> Optional[FaultPlan]:
    """The active plan, if any."""
    return _ACTIVE


def fire(site: str) -> None:
    """Fault-injection hook: a no-op unless a plan is active and has a
    triggered rule for ``site``. ``act=`` rules are never executed here."""
    plan = _ACTIVE
    if plan is not None:
        plan._fire(site)


def decide(site: str) -> List[Rule]:
    """The triggered rules of ``site`` under the active plan, for the caller
    to interpret (faultnet's corrupt, truncate and dup verbs are not a
    raised exception); empty with no plan."""
    plan = _ACTIVE
    return [] if plan is None else plan.decide(site)


@contextmanager
def active_plan(plan: FaultPlan):
    """Install ``plan`` for the block (its counters reset on entry, so a
    reused plan fires again alike)."""
    global _ACTIVE
    previous = _ACTIVE
    plan.reset()
    _ACTIVE = plan
    try:
        yield plan
    finally:
        _ACTIVE = previous


def plan_from_env() -> Optional[FaultPlan]:
    """The plan ``SPARKDL_FAULT_PLAN`` names (seeded by
    ``SPARKDL_FAULT_PLAN_SEED``), or None."""
    text = os.environ.get(ENV_VAR)
    if not text:
        return None
    return FaultPlan.from_json(text, seed=int(os.environ.get(ENV_VAR + "_SEED", "0")))


_ACTIVE = plan_from_env()
