"""SLO-guarded blue/green rollout: shift, bake, promote, or roll back.

A copy of ``sparkdl_tpu.serving.rollout`` over the port's replica plane.
:class:`RolloutController` drives a new model version from 0% of traffic to
100% with what the fleet already has: the supervisor's versioned
:meth:`~sparkdl_tpu_torch.serving.supervisor.ReplicaSupervisor.deploy`,
:meth:`~sparkdl_tpu_torch.serving.supervisor.ReplicaSupervisor.retire_version`
and ``set_primary``, the router's weighted version split
(:meth:`~sparkdl_tpu_torch.serving.router.Router.set_weights`), and the
burn-rate states of :class:`~sparkdl_tpu_torch.obs.slo.SLOEngine` as the
canary's verdict. State machine::

    idle -> spawning -> shifting -> baking -+-> shifting   (next stage)
                            ^               |
                            +---------------+
                                            +-> promoting -> done
        (breach / injected fault anywhere) ----> rolling_back -> rolled_back

- **spawning**: the new fleet comes up next to the old one and gets no
  traffic until its version has weight.
- **shifting**: each stage (default ``1% -> 50% -> 100%``) is one weight
  change at the router. Requests in flight are never touched: a shift only
  changes where new unpinned requests land.
- **baking**: the stage must hold for ``bake_s`` with no watched SLO in a
  rollback state (default: any ``page``). The watched names default to
  every SLO whose name starts with ``rollout.<new>.`` or
  ``fleet.rollout.<new>.``: :func:`~sparkdl_tpu_torch.obs.slo.rollout_slos`
  over the canary's per-version router series and
  :func:`~sparkdl_tpu_torch.obs.slo.fleet_rollout_slos` over its own
  scraped series.
- **promoting**: after the last stage bakes clean, the new version becomes
  primary, then the old fleet is drained by SIGTERM (``retire_version``:
  router removal first, so no accepted request is lost; exit 0 everywhere
  is a clean drain).
- **rolling back**: on a canary page, a spawn timeout or an injected fault
  at a rollout site, the weight snaps back to the old version, the new
  fleet drains out, and the verdict (with the detection latency, from the
  shift that exposed the breach to the rollback) lands in the flight
  recorder. Rollback is the fail-safe path: an error raised during it is
  logged and passed over, never allowed to strand the fleet mid-shift.

Fault sites: ``rollout.shift`` (before each weight change),
``rollout.bake`` (before each canary evaluation), ``rollout.rollback`` (as
the rollback begins). The first two fail safe into a rollback; the third
must never stop one.

Environment (constructor arguments override)::

    SPARKDL_ROLLOUT_STAGES      comma floats, default "0.01,0.5,1.0"
    SPARKDL_ROLLOUT_BAKE_S      per-stage bake window   (default 30)
    SPARKDL_ROLLOUT_INTERVAL_S  background step period  (default 1)
    SPARKDL_ROLLOUT_SPAWN_S     new-fleet ready timeout (default 120)
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

from sparkdl_tpu_torch.obs import blackbox
from sparkdl_tpu_torch.resilience import inject
from sparkdl_tpu_torch.utils.metrics import metrics

logger = logging.getLogger(__name__)

ENV_STAGES = "SPARKDL_ROLLOUT_STAGES"
ENV_BAKE_S = "SPARKDL_ROLLOUT_BAKE_S"
ENV_INTERVAL_S = "SPARKDL_ROLLOUT_INTERVAL_S"
ENV_SPAWN_S = "SPARKDL_ROLLOUT_SPAWN_S"

DEFAULT_STAGES = (0.01, 0.5, 1.0)

#: terminal states — :meth:`RolloutController.step` is a no-op in them
TERMINAL = ("done", "rolled_back")

#: numeric encoding for the ``rollout.state`` gauge (time-series
#: friendly; the string state rides in :meth:`report` and breadcrumbs)
_STATE_CODES = {
    "idle": 0, "spawning": 1, "shifting": 2, "baking": 3,
    "promoting": 4, "done": 5, "rolling_back": 6, "rolled_back": 7,
}


def _stages_from_env() -> Tuple[float, ...]:
    text = os.environ.get(ENV_STAGES)
    if not text:
        return DEFAULT_STAGES
    return tuple(float(part) for part in text.split(",") if part.strip())


class RolloutController:
    """Drive one blue/green rollout of ``new_version`` over
    ``old_version`` (module docstring has the state machine).

    ``supervisor`` needs ``deploy`` / ``retire_version`` /
    ``set_primary`` / ``live_count`` and a ``router`` with
    ``set_weights``; ``engine`` needs ``states()`` (tests hand in stubs,
    as for the autoscaler).  :meth:`step` is the
    synchronous entry (one transition per call, ``now=`` injectable);
    :meth:`start` runs it on a background thread until terminal.
    """

    def __init__(
        self,
        supervisor,
        engine,
        new_version: str,
        spec,
        old_version: Optional[str] = None,
        replicas: Optional[int] = None,
        stages: Optional[Sequence[float]] = None,
        bake_s: Optional[float] = None,
        interval_s: Optional[float] = None,
        spawn_timeout_s: Optional[float] = None,
        watch: Optional[Sequence[str]] = None,
        rollback_on: Sequence[str] = ("page",),
        autoscaler=None,
        clock=time.monotonic,
    ):
        self._supervisor = supervisor
        self._engine = engine
        self.new_version = str(new_version)
        self.old_version = str(
            old_version if old_version is not None
            else supervisor.primary_version
        )
        if self.new_version == self.old_version:
            raise ValueError(
                f"rollout needs two versions, got {self.new_version!r} "
                "for both"
            )
        self._spec = spec
        self._replicas = (
            int(replicas) if replicas is not None
            else max(1, supervisor.live_count(self.old_version))
        )
        self.stages = tuple(
            float(s) for s in (stages if stages is not None
                               else _stages_from_env())
        )
        if not self.stages or any(
            not 0.0 < s <= 1.0 for s in self.stages
        ) or list(self.stages) != sorted(self.stages):
            raise ValueError(
                f"stages must be ascending fractions in (0, 1], "
                f"got {self.stages}"
            )
        self.bake_s = (
            float(bake_s) if bake_s is not None
            else float(os.environ.get(ENV_BAKE_S, "30"))
        )
        self.interval_s = (
            float(interval_s) if interval_s is not None
            else float(os.environ.get(ENV_INTERVAL_S, "1"))
        )
        self._spawn_timeout_s = (
            float(spawn_timeout_s) if spawn_timeout_s is not None
            else float(os.environ.get(ENV_SPAWN_S, "120"))
        )
        #: SLO names judged at bake; None = every name starting with
        #: ``rollout.<new_version>.``
        self._watch = tuple(watch) if watch is not None else None
        self._rollback_on = tuple(rollback_on)
        self._autoscaler = autoscaler
        self._clock = clock

        self.state = "idle"
        self._stage_index = -1
        self._bake_deadline: Optional[float] = None
        self._spawn_deadline: Optional[float] = None
        self._started_at: Optional[float] = None
        self._last_shift_at: Optional[float] = None
        self._rollback_at: Optional[float] = None
        self._verdict: Optional[str] = None
        self._reason: Optional[str] = None
        self._old_exits: Dict[int, Optional[int]] = {}
        self._new_exits: Dict[int, Optional[int]] = {}
        self._events: List[Dict[str, Any]] = []
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

        self._m_state = metrics.gauge("rollout.state")
        self._m_weight = metrics.gauge("rollout.weight")
        self._m_shifts = metrics.counter("rollout.shifts")
        self._m_rollbacks = metrics.counter("rollout.rollbacks")
        self._m_promotions = metrics.counter("rollout.promotions")
        self._m_state.set(_STATE_CODES[self.state])
        self._m_weight.set(0.0)

    # ------------------------------------------------------------------
    # bookkeeping
    # ------------------------------------------------------------------
    @property
    def weight(self) -> float:
        """The canary's current traffic fraction."""
        if self._stage_index < 0:
            return 0.0
        return self.stages[min(self._stage_index, len(self.stages) - 1)]

    def _transition(self, state: str, **attrs) -> None:
        now = self._clock()
        with self._lock:
            self.state = state
            self._events.append({"at": now, "state": state, **attrs})
        self._m_state.set(_STATE_CODES[state])
        blackbox.note(
            "rollout.transition", state=state,
            new=self.new_version, old=self.old_version, **attrs,
        )
        logger.info(
            "rollout %s->%s: %s %s",
            self.old_version, self.new_version, state,
            attrs or "",
        )

    def events(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [dict(e) for e in self._events]

    def report(self) -> Dict[str, Any]:
        """The rollout's verdict record (what the flight recorder
        dumps)."""
        with self._lock:
            detection_s = (
                self._rollback_at - self._last_shift_at
                if self._rollback_at is not None
                and self._last_shift_at is not None
                else None
            )
            return {
                "old_version": self.old_version,
                "new_version": self.new_version,
                "state": self.state,
                "verdict": self._verdict,
                "reason": self._reason,
                "stages": list(self.stages),
                "stage_index": self._stage_index,
                "weight": self.weight if self.state not in
                ("rolled_back", "idle") else 0.0,
                "detection_s": detection_s,
                "old_exits": dict(self._old_exits),
                "new_exits": dict(self._new_exits),
                "events": [dict(e) for e in self._events],
            }

    # ------------------------------------------------------------------
    # the state machine
    # ------------------------------------------------------------------
    def step(self, now: Optional[float] = None) -> str:
        """Advance at most one transition; returns the (new) state."""
        now = self._clock() if now is None else now
        if self.state in TERMINAL:
            return self.state
        try:
            if self.state == "idle":
                self._begin(now)
            elif self.state == "spawning":
                self._check_spawned(now)
            elif self.state == "shifting":
                self._shift(now)
            elif self.state == "baking":
                self._bake(now)
            elif self.state == "promoting":
                self._promote(now)
        except Exception as exc:
            # any fault inside a non-terminal transition fails SAFE
            logger.warning(
                "rollout step failed in %s: %s; rolling back",
                self.state, exc,
            )
            self._rollback(now, reason=f"{self.state}: {exc}")
        return self.state

    def _begin(self, now: float) -> None:
        self._started_at = now
        if self._autoscaler is not None:
            self._autoscaler.pause()
        self._transition("spawning", replicas=self._replicas)
        self._spawn_deadline = now + self._spawn_timeout_s
        # deploy blocks on ready lines; replicas register with the
        # router under the new version but carry zero weight until the
        # first shift
        self._supervisor.deploy(
            self.new_version, self._spec, replicas=self._replicas
        )

    def _check_spawned(self, now: float) -> None:
        live = self._supervisor.live_count(self.new_version)
        if live >= self._replicas:
            self._stage_index = 0
            self._transition("shifting", stage=0)
            return
        if self._spawn_deadline is not None and now >= self._spawn_deadline:
            raise RuntimeError(
                f"{self.new_version} fleet not live within "
                f"{self._spawn_timeout_s:.0f}s ({live}/{self._replicas})"
            )

    def _shift(self, now: float) -> None:
        inject.fire("rollout.shift")
        w = self.stages[self._stage_index]
        self._supervisor.router.set_weights({
            self.old_version: 1.0 - w,
            self.new_version: w,
        })
        self._m_weight.set(w)
        self._m_shifts.add(1)
        with self._lock:
            self._last_shift_at = now
        self._bake_deadline = now + self.bake_s
        self._transition(
            "baking", stage=self._stage_index, weight=w,
        )

    def _bake(self, now: float) -> None:
        inject.fire("rollout.bake")
        breached = self._breached()
        if breached:
            self._rollback(now, reason=f"canary SLO breach: {breached}")
            return
        if self._bake_deadline is not None and now < self._bake_deadline:
            return  # still baking, still clean
        if self._stage_index + 1 < len(self.stages):
            self._stage_index += 1
            self._transition("shifting", stage=self._stage_index)
        else:
            self._transition("promoting")

    def _breached(self) -> List[str]:
        """Watched SLO names currently in a rollback state.  The default
        watch covers both canary views: the router-side
        ``rollout.<version>.*`` attempt objectives AND the federated
        ``fleet.rollout.<version>.*`` replica-attributed objectives
        (:func:`~sparkdl_tpu_torch.obs.slo.fleet_rollout_slos`) — a canary
        whose failures the router's retries mask still pages on its own
        scraped series."""
        states = self._engine.states() if self._engine is not None else {}
        prefixes = (
            f"rollout.{self.new_version}.",
            f"fleet.rollout.{self.new_version}.",
        )
        return sorted(
            name for name, state in states.items()
            if state in self._rollback_on
            and (name in self._watch if self._watch is not None
                 else name.startswith(prefixes))
        )

    def _promote(self, now: float) -> None:
        # the new fleet takes everything BEFORE the old one drains, so
        # there is never a moment with no weighted-in version
        self._supervisor.router.set_weights({
            self.new_version: 1.0, self.old_version: 0.0,
        })
        self._supervisor.set_primary(self.new_version)
        self._old_exits = self._supervisor.retire_version(self.old_version)
        self._supervisor.router.set_weights({self.new_version: 1.0})
        self._m_weight.set(1.0)
        self._m_promotions.add(1)
        dirty = {
            s: c for s, c in self._old_exits.items() if c != 0
        }
        with self._lock:
            self._verdict = "promoted"
            self._reason = (
                f"dirty drains: {dirty}" if dirty else "clean"
            )
        if self._autoscaler is not None:
            self._autoscaler.resume()
        self._transition(
            "done", verdict="promoted", old_exits=dict(self._old_exits),
        )

    def _rollback(self, now: float, reason: str) -> None:
        """Fail SAFE: all weight back on the old version, drain the new
        fleet out.  Nothing — not even an injected fault at the
        ``rollout.rollback`` site — may stop this path."""
        with self._lock:
            self._rollback_at = now
            self._verdict = "rolled_back"
            self._reason = reason
        self._m_rollbacks.add(1)
        self._transition("rolling_back", reason=reason)
        try:
            inject.fire("rollout.rollback")
        except Exception as exc:
            logger.warning(
                "fault injected during rollback (continuing): %s", exc
            )
        try:
            self._supervisor.router.set_weights({
                self.old_version: 1.0, self.new_version: 0.0,
            })
        except Exception:
            logger.exception("rollback: weight reset failed (continuing)")
        self._m_weight.set(0.0)
        try:
            self._new_exits = self._supervisor.retire_version(
                self.new_version
            )
        except Exception:
            logger.exception("rollback: retire failed (continuing)")
        if self._autoscaler is not None:
            self._autoscaler.resume()
        self._transition(
            "rolled_back", reason=reason,
            new_exits=dict(self._new_exits),
        )
        blackbox.dump(f"rollout rolled back: {reason}")

    # ------------------------------------------------------------------
    # the background thread
    # ------------------------------------------------------------------
    def start(self) -> "RolloutController":
        """Run :meth:`step` on a background thread until terminal."""
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="sparkdl-rollout", daemon=True
        )
        self._thread.start()
        return self

    def _run(self) -> None:
        while self.state not in TERMINAL:
            try:
                self.step()
            except Exception:
                logger.exception("rollout step failed")
            if self.state in TERMINAL:
                break
            if self._stop.wait(self.interval_s):
                break

    def wait(self, timeout_s: float = 300.0) -> str:
        """Block until the rollout reaches a terminal state (or the
        timeout passes); returns the state either way."""
        thread = self._thread
        if thread is not None:
            thread.join(timeout=timeout_s)
        return self.state

    def close(self) -> None:
        self._stop.set()
        thread, self._thread = self._thread, None
        if thread is not None and thread.is_alive():
            thread.join(timeout=10.0)

    def __enter__(self) -> "RolloutController":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    def __repr__(self):
        return (
            f"RolloutController({self.old_version}->{self.new_version}, "
            f"state={self.state!r}, weight={self.weight:g})"
        )
