"""SLO-driven autoscaler: burn rates in, replica count + admission out.

Port of ``sparkdl_tpu.serving.autoscale`` (host code: a copy with the
package renamed). The control loop closes the replica plane: the
:class:`~sparkdl_tpu_torch.obs.slo.SLOEngine` classifies burn rates
into ``ok`` / ``warning`` / ``page``; the :class:`Autoscaler` turns
that classification into the two actuators the supervisor exposes —

- **replica count** via :meth:`ReplicaSupervisor.scale_to` —
  ``page`` adds ``step_up * 2`` replicas, ``warning`` adds ``step_up``,
  and ``ok_streak`` consecutive clean evaluations remove one (scale-up
  is eager because an SLO is burning; scale-down is reluctant because
  flapping costs spawns);
- **admission limit** via :meth:`Router.set_max_inflight` — always
  ``replicas * per_replica_inflight``, so shed pressure tracks real
  capacity while new replicas warm up.

Both moves respect a cooldown (no thrash inside one spawn's warmup
time).  The loop is evaluate-then-wait on an ``Event`` — interval ticks,
not sleep-retry — and :meth:`evaluate_once` is the synchronous entry the
tests drive with stub engines/supervisors.

Env knobs (a caller's arguments override them)::

    SPARKDL_REPLICAS                initial replica count (supervisor)
    SPARKDL_AUTOSCALE_MIN           floor replica count      (default 1)
    SPARKDL_AUTOSCALE_MAX           ceiling replica count    (default 4)
    SPARKDL_AUTOSCALE_INTERVAL_S    evaluation period        (default 5)
    SPARKDL_AUTOSCALE_COOLDOWN_S    min gap between moves    (default 15)
    SPARKDL_AUTOSCALE_STEP          replicas per warning step (default 1)
    SPARKDL_AUTOSCALE_OK_STREAK     clean evals before -1    (default 6)
    SPARKDL_AUTOSCALE_INFLIGHT      admission per replica    (default 64)
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Any, Dict, List, Optional

from sparkdl_tpu_torch.utils.metrics import metrics

logger = logging.getLogger(__name__)


def _env_int(name: str, default: int) -> int:
    return int(os.environ.get(name, str(default)))


def _env_float(name: str, default: float) -> float:
    return float(os.environ.get(name, str(default)))


class Autoscaler:
    """Scale a :class:`~sparkdl_tpu_torch.serving.supervisor.ReplicaSupervisor`
    off an :class:`~sparkdl_tpu_torch.obs.slo.SLOEngine` (module docstring has
    the policy).  ``supervisor`` needs ``scale_to(n)`` and a ``router``
    with ``set_max_inflight(n)``; ``engine`` needs ``states()`` — the
    tests hand in stubs."""

    def __init__(
        self,
        supervisor,
        engine,
        min_replicas: Optional[int] = None,
        max_replicas: Optional[int] = None,
        interval_s: Optional[float] = None,
        cooldown_s: Optional[float] = None,
        step_up: Optional[int] = None,
        ok_streak: Optional[int] = None,
        per_replica_inflight: Optional[int] = None,
        clock=time.monotonic,
    ):
        self._supervisor = supervisor
        self._engine = engine
        self.min_replicas = (
            min_replicas if min_replicas is not None
            else _env_int("SPARKDL_AUTOSCALE_MIN", 1)
        )
        self.max_replicas = (
            max_replicas if max_replicas is not None
            else _env_int("SPARKDL_AUTOSCALE_MAX", 4)
        )
        if not 1 <= self.min_replicas <= self.max_replicas:
            raise ValueError(
                f"need 1 <= min ({self.min_replicas}) <= "
                f"max ({self.max_replicas})"
            )
        self.interval_s = (
            interval_s if interval_s is not None
            else _env_float("SPARKDL_AUTOSCALE_INTERVAL_S", 5.0)
        )
        self.cooldown_s = (
            cooldown_s if cooldown_s is not None
            else _env_float("SPARKDL_AUTOSCALE_COOLDOWN_S", 15.0)
        )
        self.step_up = (
            step_up if step_up is not None
            else _env_int("SPARKDL_AUTOSCALE_STEP", 1)
        )
        self.ok_streak = (
            ok_streak if ok_streak is not None
            else _env_int("SPARKDL_AUTOSCALE_OK_STREAK", 6)
        )
        self.per_replica_inflight = (
            per_replica_inflight if per_replica_inflight is not None
            else _env_int("SPARKDL_AUTOSCALE_INFLIGHT", 64)
        )
        self._clock = clock
        self._replicas = max(
            self.min_replicas,
            min(self.max_replicas, supervisor.live_count() or
                self.min_replicas),
        )
        self._clean_evals = 0
        self._last_move_at: Optional[float] = None
        self._paused = False
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._decisions: List[Dict[str, Any]] = []
        self._m_target = metrics.gauge("supervisor.autoscale_target")
        self._m_moves = metrics.counter("supervisor.autoscale_moves")
        self._m_target.set(self._replicas)
        self._apply_admission()

    # ------------------------------------------------------------------
    @property
    def target(self) -> int:
        return self._replicas

    def decisions(self) -> List[Dict[str, Any]]:
        """The decision log."""
        return list(self._decisions)

    @property
    def paused(self) -> bool:
        return self._paused

    def pause(self) -> None:
        """Freeze the control loop (evaluations become no-op records).
        The :class:`~sparkdl_tpu_torch.serving.rollout.RolloutController`
        pauses scaling while a rollout is shifting traffic — a mid-shift
        scale move would change the very denominators the canary SLOs
        are judged on."""
        self._paused = True

    def resume(self) -> None:
        """Un-freeze; the clean-eval streak restarts so a pause can
        never queue up an immediate scale-down."""
        self._paused = False
        self._clean_evals = 0

    def _apply_admission(self) -> None:
        self._supervisor.router.set_max_inflight(
            self._replicas * self.per_replica_inflight
        )

    def evaluate_once(self, now: Optional[float] = None) -> Dict[str, Any]:
        """One control step: read states, maybe move.  Returns the
        decision record (also appended to :meth:`decisions`)."""
        now = self._clock() if now is None else now
        if self._paused:
            decision = {
                "at": now, "worst": "paused", "states": {},
                "replicas_before": self._replicas,
                "replicas_after": self._replicas,
                "moved": False, "in_cooldown": False,
                "max_inflight": (
                    self._replicas * self.per_replica_inflight
                ),
            }
            self._decisions.append(decision)
            return decision
        states = self._engine.states()
        worst = "ok"
        for state in states.values():
            if state == "page":
                worst = "page"
                break
            if state == "warning":
                worst = "warning"
        in_cooldown = (
            self._last_move_at is not None
            and now - self._last_move_at < self.cooldown_s
        )
        before = self._replicas
        want = before
        if worst == "page":
            self._clean_evals = 0
            want = before + 2 * self.step_up
        elif worst == "warning":
            self._clean_evals = 0
            want = before + self.step_up
        else:
            self._clean_evals += 1
            if self._clean_evals >= self.ok_streak:
                want = before - 1
        want = max(self.min_replicas, min(self.max_replicas, want))
        moved = False
        if want != before and not in_cooldown:
            self._replicas = want
            self._last_move_at = now
            if want < before:
                self._clean_evals = 0
            # widen admission BEFORE spawning (scale-up must not shed
            # the very burst it reacts to), narrow it after draining
            if want > before:
                self._apply_admission()
                self._supervisor.scale_to(want)
            else:
                self._supervisor.scale_to(want)
                self._apply_admission()
            self._m_target.set(want)
            self._m_moves.add(1)
            moved = True
            logger.info(
                "autoscale %d -> %d (worst=%s)", before, want, worst
            )
        decision = {
            "at": now,
            "worst": worst,
            "states": dict(states),
            "replicas_before": before,
            "replicas_after": self._replicas,
            "moved": moved,
            "in_cooldown": bool(in_cooldown and want != before),
            "max_inflight": self._replicas * self.per_replica_inflight,
        }
        self._decisions.append(decision)
        return decision

    # ------------------------------------------------------------------
    def start(self) -> "Autoscaler":
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="sparkdl-autoscaler", daemon=True
        )
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.evaluate_once()
            except Exception:
                logger.exception("autoscaler evaluation failed")

    def close(self) -> None:
        self._stop.set()
        thread, self._thread = self._thread, None
        if thread is not None and thread.is_alive():
            thread.join(timeout=5.0)

    def __enter__(self) -> "Autoscaler":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    def __repr__(self):
        return (
            f"Autoscaler(target={self._replicas}, "
            f"bounds=[{self.min_replicas}, {self.max_replicas}])"
        )
