"""Process-level replica supervisor: replicas as cattle, not pets.

Port of ``sparkdl_tpu.serving.supervisor`` (host code: a copy with the
package renamed). :class:`ReplicaSupervisor` owns N *slots*, each backed by a spawned
``python -m sparkdl_tpu_torch.serving.replica`` OS process (see
:mod:`~sparkdl_tpu_torch.serving.replica` for the in-process half and the
ready/SIGTERM contract).  The supervisor's whole job is the failure
loop the kill matrix exercises:

- **spawn** — export the :class:`~sparkdl_tpu_torch.serving.replica
  .ReplicaSpec` through ``SPARKDL_REPLICA_SPEC``, wait for the ready
  line, register the replica with the :class:`~sparkdl_tpu_torch.serving
  .router.Router`.  The child inherits the parent's environment
  (``SPARKDL_COMPILE_CACHE``, ``SPARKDL_TRACE_OUT``, ``CXX``...), so
  restarts of compiled endpoints warm up from disk instead of
  recompiling.
- **watch** — a monitor thread (interval ticks on an ``Event``, never a
  sleep-retry loop) notices process death via ``poll()`` and gray
  failure via the replica's own ``/healthz`` (``health_failures``
  consecutive bad probes = dead: SIGKILL and treat as a crash).
- **restart with backoff** — delays come from a
  :class:`~sparkdl_tpu_torch.resilience.policy.RetryPolicy` (the package's
  one backoff definition); each death also feeds the slot's
  :class:`~sparkdl_tpu_torch.resilience.policy.CircuitBreaker`, and a breaker
  that opens **evicts** the slot — a crash-looping replica must not eat
  spawn cycles forever.
- **drain on stop** — a graceful stop unregisters the replica from the
  router *first* (no new work), then SIGTERMs it so in-flight requests
  finish (exit 0 = clean drain).  :meth:`kill_replica` is the chaos
  path: SIGKILL, stranded requests fail over via the router, the
  monitor restarts the slot.

Fault sites: ``supervisor.spawn`` (before each spawn),
``supervisor.restart`` (before each backoff restart),
``supervisor.health`` (each health probe; an injected error counts as a
failed probe).  The replica process itself hosts
``supervisor.replica_warm`` / ``supervisor.replica_serve``; per-slot
``fault_plans`` arm ``SPARKDL_FAULT_PLAN`` in the FIRST process of a
slot only, so a planned kill fires once and the restarted replica
lives — a deterministic single kill.
"""

from __future__ import annotations

import json
import logging
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.request
from typing import Any, Dict, List, Optional, Sequence, Tuple

from sparkdl_tpu_torch.resilience import inject
from sparkdl_tpu_torch.resilience.policy import CircuitBreaker, RetryPolicy
from sparkdl_tpu_torch.serving.replica import ENV_SPEC, ReplicaSpec
from sparkdl_tpu_torch.serving.router import DEFAULT_VERSION, Router
from sparkdl_tpu_torch.utils.metrics import metrics

logger = logging.getLogger(__name__)

#: default replica count (the autoscaler floor/ceiling knobs live in
#: :mod:`sparkdl_tpu_torch.serving.autoscale`)
ENV_REPLICAS = "SPARKDL_REPLICAS"


class ReplicaHandle:
    """One supervised slot: the current process (if any) plus the
    restart bookkeeping.  State machine::

        starting -> live -> (backoff -> starting)* -> evicted
                         \\-> stopped          (graceful scale-down)
    """

    def __init__(
        self, slot: int, spec: ReplicaSpec,
        version: str = DEFAULT_VERSION,
    ):
        self.slot = int(slot)
        self.name = f"replica-{slot}"
        self.spec = spec
        self.version = str(version)
        self.proc: Optional[subprocess.Popen] = None
        self.state = "new"
        self.generation = 0          # completed spawns
        self.attempt = 0             # consecutive failed/dead runs
        self.restart_at: Optional[float] = None
        self.port: Optional[int] = None
        self.obs_port: Optional[int] = None
        self.lanes: Tuple[str, ...] = ("tcp",)
        self.warmup: Dict[str, Any] = {}
        self.fingerprints: Dict[str, str] = {}
        self.health_bad = 0
        self.fault_armed = False
        self.last_exit: Optional[int] = None
        self._drain_thread: Optional[threading.Thread] = None

    def obs_url(self) -> Optional[str]:
        """Base URL of this replica's ObsServer (None before ready)."""
        if self.obs_port is None:
            return None
        return f"http://{self.spec.host}:{self.obs_port}"

    def describe(self) -> Dict[str, Any]:
        return {
            "slot": self.slot,
            "name": self.name,
            "version": self.version,
            "state": self.state,
            "pid": self.proc.pid if self.proc is not None else None,
            "port": self.port,
            "obs_port": self.obs_port,
            "obs_url": self.obs_url(),
            "lanes": list(self.lanes),
            "generation": self.generation,
            "attempt": self.attempt,
            "last_exit": self.last_exit,
            "warmup": self.warmup,
        }


class ReplicaSupervisor:
    """Spawn, watch, restart, and evict replica processes behind one
    router (module docstring has the full loop)."""

    def __init__(
        self,
        spec: ReplicaSpec,
        replicas: Optional[int] = None,
        router: Optional[Router] = None,
        backoff: Optional[RetryPolicy] = None,
        breaker_threshold: int = 5,
        breaker_recovery_s: float = 60.0,
        monitor_interval_s: float = 0.25,
        health_interval_s: float = 2.0,
        health_failures: int = 3,
        spawn_timeout_s: float = 120.0,
        stop_timeout_s: Optional[float] = None,
        fault_plans: Optional[Dict[int, List[dict]]] = None,
    ):
        if replicas is None:
            replicas = int(os.environ.get(ENV_REPLICAS, "2"))
        if replicas < 1:
            raise ValueError(f"replicas must be >= 1, got {replicas}")
        self._spec = spec
        #: one ReplicaSpec per registered version; the initial spec is
        #: the primary ("v1") fleet, :meth:`deploy` adds more
        self._specs: Dict[str, ReplicaSpec] = {DEFAULT_VERSION: spec}
        self._primary_version = DEFAULT_VERSION
        self._initial_replicas = int(replicas)
        self._owns_router = router is None
        self.router = router if router is not None else Router()
        backoff = backoff or RetryPolicy(
            max_attempts=8, base_delay_s=0.25, max_delay_s=10.0, jitter=0.1
        )
        # the deterministic backoff ladder, reused across slots: delay
        # before restart attempt i (clamped at the ladder's top rung)
        self._backoff_delays = list(backoff.delays()) or [1.0]
        self._breaker_threshold = int(breaker_threshold)
        self._breaker_recovery_s = float(breaker_recovery_s)
        self._monitor_interval_s = float(monitor_interval_s)
        self._health_interval_s = float(health_interval_s)
        self._health_failures = int(health_failures)
        self._spawn_timeout_s = float(spawn_timeout_s)
        self._stop_timeout_s = (
            float(stop_timeout_s) if stop_timeout_s is not None
            else float(os.environ.get("SPARKDL_REPLICA_DRAIN_S", "15")) + 5.0
        )
        self._fault_plans = dict(fault_plans or {})
        self._lock = threading.Lock()
        self._handles: Dict[int, ReplicaHandle] = {}
        self._breakers: Dict[int, CircuitBreaker] = {}
        self._next_slot = 0
        self._stop = threading.Event()
        self._monitor: Optional[threading.Thread] = None
        self._last_health_at = 0.0
        self._telemetry: Optional[Dict[str, Any]] = None
        self._started_at: Optional[float] = None
        self._m_replicas = metrics.gauge("supervisor.replicas")
        self._m_spawns = metrics.counter("supervisor.spawns")
        self._m_restarts = metrics.counter("supervisor.restarts")
        self._m_evicted = metrics.counter("supervisor.evicted")
        self._m_health_bad = metrics.counter("supervisor.health_failures")
        self._m_spawn_time = metrics.timer("supervisor.spawn_seconds")

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------
    def start(self) -> "ReplicaSupervisor":
        """Spawn the initial replica set and start the monitor."""
        with self._lock:
            if self._monitor is not None:
                return self
            self._started_at = time.monotonic()
        for _ in range(self._initial_replicas):
            self._add_slot()
        with self._lock:
            self._monitor = threading.Thread(
                target=self._monitor_loop,
                name="sparkdl-replica-supervisor",
                daemon=True,
            )
            self._monitor.start()
        return self

    def close(self) -> None:
        self._stop.set()
        with self._lock:
            monitor = self._monitor
            self._monitor = None
            handles = list(self._handles.values())
        if monitor is not None and monitor.is_alive():
            monitor.join(timeout=10.0)
        for handle in handles:
            self._stop_handle(handle, graceful=True)
        telemetry, self._telemetry = self._telemetry, None
        if telemetry is not None:
            if telemetry.get("fleet") is not None:
                telemetry["fleet"].stop()
            telemetry["engine"].stop()
            telemetry["recorder"].stop()
            telemetry["server"].close()
        if self._owns_router:
            self.router.close()

    def __enter__(self) -> "ReplicaSupervisor":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------------
    # spawning
    # ------------------------------------------------------------------
    def _add_slot(self, version: Optional[str] = None) -> ReplicaHandle:
        with self._lock:
            if version is None:
                version = self._primary_version
            spec = self._specs[version]
            slot = self._next_slot
            self._next_slot += 1
            handle = ReplicaHandle(slot, spec, version=version)
            self._handles[slot] = handle
            self._breakers[slot] = CircuitBreaker(
                name=f"supervisor.slot{slot}",
                failure_threshold=self._breaker_threshold,
                recovery_s=self._breaker_recovery_s,
            )
        self._spawn(handle)
        return handle

    def _spawn(self, handle: ReplicaHandle) -> bool:
        """Start one replica process and wait for its ready line.  Never
        called under ``self._lock`` — spawning blocks."""
        started = time.monotonic()
        try:
            inject.fire("supervisor.spawn")
        except Exception as exc:
            logger.warning("injected spawn fault on %s: %s",
                           handle.name, exc)
            self._after_death(handle, exit_code=None)
            return False
        env = os.environ.copy()
        env[ENV_SPEC] = handle.spec.to_json()
        rules = self._fault_plans.get(handle.slot)
        if rules and not handle.fault_armed:
            env[inject.ENV_VAR] = json.dumps(rules)
            handle.fault_armed = True
        else:
            env.pop(inject.ENV_VAR, None)
        self._m_spawns.add(1)
        with self._lock:
            handle.state = "starting"
            handle.health_bad = 0
        proc = subprocess.Popen(
            [sys.executable, "-m", "sparkdl_tpu_torch.serving.replica"],
            stdout=subprocess.PIPE,
            env=env,
        )
        handle.proc = proc
        ready = self._read_ready(proc, self._spawn_timeout_s)
        if ready is None:
            logger.warning(
                "%s produced no ready line within %.0fs (pid %d)",
                handle.name, self._spawn_timeout_s, proc.pid,
            )
            proc.kill()
            proc.wait(timeout=10.0)
            handle.last_exit = proc.returncode
            self._after_death(handle, exit_code=proc.returncode)
            return False
        # keep the pipe drained so a chatty replica can never block on
        # a full stdout buffer
        handle._drain_thread = threading.Thread(
            target=_drain_pipe, args=(proc.stdout,),
            name=f"sparkdl-{handle.name}-stdout", daemon=True,
        )
        handle._drain_thread.start()
        with self._lock:
            handle.port = int(ready["port"])
            handle.obs_port = int(ready["obs_port"])
            handle.lanes = tuple(ready.get("lanes", ("tcp",)))
            handle.warmup = ready.get("warmup", {})
            handle.fingerprints = dict(ready.get("fingerprints") or {})
            handle.generation += 1
            handle.attempt = 0
            handle.restart_at = None
            handle.state = "live"
            live = sum(
                1 for h in self._handles.values() if h.state == "live"
            )
            self._m_replicas.set(live)
        self._breakers[handle.slot].record_success()
        self.router.add(
            handle.name, handle.spec.host, handle.port,
            lanes=handle.lanes, version=handle.version,
            fingerprints=handle.fingerprints,
        )
        self._m_spawn_time.add_seconds(time.monotonic() - started)
        logger.info(
            "%s live: pid=%d port=%d gen=%d (%.1fs)",
            handle.name, proc.pid, handle.port, handle.generation,
            time.monotonic() - started,
        )
        return True

    @staticmethod
    def _read_ready(
        proc: subprocess.Popen, timeout_s: float
    ) -> Optional[Dict[str, Any]]:
        """The replica's single ready line, or None on timeout/death.
        ``readline`` has no timeout, so a helper thread does the read
        (daemonized; it unblocks at EOF once the process is killed)."""
        holder: Dict[str, bytes] = {}
        got = threading.Event()

        def reader():
            try:
                holder["line"] = proc.stdout.readline()
            except Exception:
                holder["line"] = b""
            got.set()

        thread = threading.Thread(
            target=reader, name="sparkdl-replica-ready", daemon=True
        )
        thread.start()
        if not got.wait(timeout_s):
            return None
        thread.join(timeout=1.0)
        line = holder.get("line") or b""
        if not line.strip():
            return None
        try:
            ready = json.loads(line.decode("utf-8", "replace"))
        except ValueError:
            logger.warning("unparseable ready line: %r", line[:200])
            return None
        return ready if ready.get("ready") else None

    # ------------------------------------------------------------------
    # monitor loop
    # ------------------------------------------------------------------
    def _monitor_loop(self) -> None:
        while not self._stop.wait(self._monitor_interval_s):
            try:
                self._tick()
            except Exception:
                logger.exception("supervisor tick failed")

    def _tick(self, now: Optional[float] = None) -> None:
        now = time.monotonic() if now is None else now
        with self._lock:
            handles = list(self._handles.values())
            probe_health = (
                now - self._last_health_at >= self._health_interval_s
            )
            if probe_health:
                self._last_health_at = now
        for handle in handles:
            if self._stop.is_set():
                return
            if handle.state == "live":
                proc = handle.proc
                if proc is not None and proc.poll() is not None:
                    self._on_death(handle, proc.returncode)
                elif probe_health:
                    self._probe(handle)
            elif handle.state == "backoff":
                if handle.restart_at is not None and now >= handle.restart_at:
                    self._restart(handle)

    def _probe(self, handle: ReplicaHandle) -> None:
        """One /healthz probe; ``health_failures`` consecutive bad
        probes condemn the replica (SIGKILL + crash path)."""
        url = (
            f"http://{handle.spec.host}:{handle.obs_port}/healthz"
        )
        try:
            inject.fire("supervisor.health")
            with urllib.request.urlopen(url, timeout=2.0) as resp:
                ok = resp.status == 200
        except Exception:
            ok = False
        if ok:
            with self._lock:
                handle.health_bad = 0
            return
        self._m_health_bad.add(1)
        with self._lock:
            handle.health_bad += 1
            condemned = handle.health_bad >= self._health_failures
        if condemned and handle.state == "live":
            logger.warning(
                "%s failed %d consecutive health probes; killing pid %s",
                handle.name, handle.health_bad,
                handle.proc.pid if handle.proc else "?",
            )
            proc = handle.proc
            if proc is not None and proc.poll() is None:
                proc.kill()
                proc.wait(timeout=10.0)
            self._on_death(
                handle,
                proc.returncode if proc is not None else None,
            )

    def _on_death(self, handle: ReplicaHandle, exit_code) -> None:
        """A live replica died: unregister, reap, then decide restart
        vs. eviction."""
        self.router.remove(handle.name)
        proc = handle.proc
        if proc is not None:
            proc.wait(timeout=10.0)  # reap — no zombie replicas
            handle.last_exit = proc.returncode
        drain = handle._drain_thread
        if drain is not None and drain.is_alive():
            drain.join(timeout=2.0)
        logger.warning(
            "%s died (exit=%s, gen=%d)",
            handle.name, handle.last_exit, handle.generation,
        )
        self._after_death(handle, exit_code=handle.last_exit)

    def _after_death(self, handle: ReplicaHandle, exit_code) -> None:
        """Shared failure bookkeeping for deaths AND failed spawns."""
        breaker = self._breakers[handle.slot]
        breaker.record_failure()
        evict = breaker.state == "open"
        with self._lock:
            handle.attempt += 1
            live = sum(
                1 for h in self._handles.values() if h.state == "live"
            )
            self._m_replicas.set(live)
            if evict:
                handle.state = "evicted"
                handle.restart_at = None
                self._m_evicted.add(1)
                evicted = True
            else:
                rung = min(
                    handle.attempt - 1, len(self._backoff_delays) - 1
                )
                delay = self._backoff_delays[rung]
                handle.restart_at = time.monotonic() + delay
                handle.state = "backoff"
                evicted = False
        if evicted:
            logger.error(
                "%s evicted after %d consecutive failures (breaker %s)",
                handle.name, handle.attempt, breaker.state,
            )

    def _restart(self, handle: ReplicaHandle) -> None:
        try:
            inject.fire("supervisor.restart")
        except Exception as exc:
            logger.warning("injected restart fault on %s: %s",
                           handle.name, exc)
            self._after_death(handle, exit_code=None)
            return
        self._m_restarts.add(1)
        self._spawn(handle)

    # ------------------------------------------------------------------
    # operator surface
    # ------------------------------------------------------------------
    def scale_to(self, n: int, version: Optional[str] = None) -> int:
        """Grow or (gracefully) shrink toward ``n`` replicas of one
        version (default: the primary fleet); returns the resulting slot
        count for that version.  Shrink stops the highest slots — drain
        first, never a kill."""
        n = max(1, int(n))
        with self._lock:
            if version is None:
                version = self._primary_version
        while True:
            with self._lock:
                active = sorted(
                    h.slot for h in self._handles.values()
                    if h.version == version
                    and h.state not in ("stopped", "evicted")
                )
            if len(active) < n:
                self._add_slot(version)
                continue
            if len(active) > n:
                self.stop_replica(active[-1])
                continue
            return len(active)

    # ------------------------------------------------------------------
    # versioned deploys (the blue/green substrate RolloutController
    # drives — the supervisor only knows *mechanism*: spawn a second
    # fleet, retire a fleet, flip which one scaling targets)
    # ------------------------------------------------------------------
    def deploy(
        self,
        version: str,
        spec: ReplicaSpec,
        replicas: int = 1,
    ) -> List[ReplicaHandle]:
        """Spawn ``replicas`` slots of a new ``version`` next to the
        existing fleet(s).  The new replicas register with the router
        under their version, so they receive no unpinned traffic until
        :meth:`Router.set_weights` gives the version weight.  Spawning
        is synchronous (ready-line waited); restarts of these slots
        reuse the deployed spec."""
        version = str(version)
        if replicas < 1:
            raise ValueError(f"replicas must be >= 1, got {replicas}")
        with self._lock:
            existing = self._specs.get(version)
            if existing is not None and existing is not spec:
                raise ValueError(
                    f"version {version!r} already deployed; retire it "
                    "before redeploying"
                )
            self._specs[version] = spec
        metrics.counter("supervisor.deploys").add(1)
        handles = [self._add_slot(version) for _ in range(replicas)]
        logger.info(
            "deployed version %s: %d replica(s)", version, len(handles)
        )
        return handles

    def retire_version(self, version: str) -> Dict[int, Optional[int]]:
        """Gracefully drain and stop every slot of ``version`` (router
        removal first, then SIGTERM — the zero-downtime half of a
        promotion or rollback).  Returns ``{slot: exit_code}``; exit 0
        everywhere means every in-flight request finished.  The version's
        spec is dropped, so the monitor cannot resurrect its slots."""
        version = str(version)
        with self._lock:
            if version == self._primary_version:
                raise ValueError(
                    f"refusing to retire the primary version {version!r}; "
                    "set_primary() to the survivor first"
                )
            slots = [
                h.slot for h in self._handles.values()
                if h.version == version
                and h.state not in ("stopped", "evicted")
            ]
            self._specs.pop(version, None)
        exits: Dict[int, Optional[int]] = {}
        for slot in slots:
            self.stop_replica(slot, graceful=True)
            with self._lock:
                exits[slot] = self._handles[slot].last_exit
        metrics.counter("supervisor.retired").add(len(slots))
        logger.info("retired version %s: exits=%s", version, exits)
        return exits

    def set_primary(self, version: str) -> None:
        """Flip which version unqualified :meth:`scale_to` (and the
        autoscaler through it) targets — the promotion bookkeeping step
        after a rollout reaches 100%."""
        version = str(version)
        with self._lock:
            if version not in self._specs:
                raise KeyError(f"version {version!r} was never deployed")
            self._primary_version = version

    @property
    def primary_version(self) -> str:
        with self._lock:
            return self._primary_version

    def versions(self) -> Dict[str, int]:
        """Live replica count per version."""
        with self._lock:
            out: Dict[str, int] = {v: 0 for v in self._specs}
            for h in self._handles.values():
                if h.state == "live":
                    out[h.version] = out.get(h.version, 0) + 1
            return out

    def stop_replica(self, slot: int, graceful: bool = True) -> None:
        """Take one replica out of service. Graceful = drain contract:
        router removal first (stop admitting), SIGTERM, wait for exit."""
        with self._lock:
            handle = self._handles.get(slot)
            if handle is None:
                raise KeyError(f"no such slot {slot}")
            handle.state = "stopping"
        self._stop_handle(handle, graceful=graceful)

    def _stop_handle(self, handle: ReplicaHandle, graceful: bool) -> None:
        self.router.remove(handle.name)
        proc = handle.proc
        if proc is not None and proc.poll() is None:
            if graceful:
                proc.send_signal(signal.SIGTERM)
                try:
                    proc.wait(timeout=self._stop_timeout_s)
                except subprocess.TimeoutExpired:
                    logger.warning(
                        "%s ignored SIGTERM for %.0fs; killing",
                        handle.name, self._stop_timeout_s,
                    )
                    proc.kill()
                    proc.wait(timeout=10.0)
            else:
                proc.kill()
                proc.wait(timeout=10.0)
        elif proc is not None:
            proc.wait(timeout=10.0)
        drain = handle._drain_thread
        if drain is not None and drain.is_alive():
            drain.join(timeout=2.0)
        with self._lock:
            handle.last_exit = (
                proc.returncode if proc is not None else None
            )
            handle.state = "stopped"
            live = sum(
                1 for h in self._handles.values() if h.state == "live"
            )
            self._m_replicas.set(live)

    def kill_replica(self, slot: int) -> int:
        """SIGKILL one replica (the chaos path — the monitor notices and
        restarts it).  Returns the killed pid."""
        with self._lock:
            handle = self._handles.get(slot)
            if handle is None or handle.proc is None:
                raise KeyError(f"no running replica in slot {slot}")
            proc = handle.proc
        proc.kill()
        return proc.pid

    def revive(self, slot: int) -> None:
        """Clear an eviction (operator override): reset the slot's
        breaker and restart it."""
        with self._lock:
            handle = self._handles.get(slot)
            if handle is None:
                raise KeyError(f"no such slot {slot}")
            handle.attempt = 0
        self._breakers[slot].record_success()
        self._spawn(handle)

    def handles(self) -> List[ReplicaHandle]:
        with self._lock:
            return list(self._handles.values())

    def live_count(self, version: Optional[str] = None) -> int:
        with self._lock:
            return sum(
                1 for h in self._handles.values()
                if h.state == "live"
                and (version is None or h.version == version)
            )

    def wait_live(
        self, n: int, timeout_s: float = 60.0,
        version: Optional[str] = None,
    ) -> bool:
        """Block (event-paced, not sleep-retry) until ``n`` replicas are
        live or ``timeout_s`` passes."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if self.live_count(version) >= n:
                return True
            if self._stop.wait(0.05):
                return False
        return self.live_count(version) >= n

    def status(self) -> Dict[str, Any]:
        """The supervisor's ``/healthz`` payload: healthy while at least
        one replica is live."""
        with self._lock:
            rows = [h.describe() for h in self._handles.values()]
            primary = self._primary_version
        live = sum(1 for r in rows if r["state"] == "live")
        return {
            "healthy": live > 0,
            "live": live,
            "primary_version": primary,
            "versions": self.versions(),
            "replicas": rows,
            "breakers": {
                slot: b.snapshot() for slot, b in self._breakers.items()
            },
            "router": {
                "replicas": list(self.router.names()),
                "lanes": self.router.lanes(),
                "max_inflight": self.router.max_inflight,
            },
        }

    # ------------------------------------------------------------------
    # telemetry
    # ------------------------------------------------------------------
    def obs_targets(self) -> List[Dict[str, Any]]:
        """Scrape targets for the fleet collector: every live replica's
        name / version / ObsServer base URL.  Polled at each scrape, so
        restarts (new obs port) and deploys are picked up on the next
        pass without re-wiring."""
        with self._lock:
            return [
                {
                    "name": h.name,
                    "version": h.version,
                    "url": h.obs_url(),
                }
                for h in self._handles.values()
                if h.state == "live" and h.obs_port is not None
            ]

    def start_telemetry(
        self,
        port: int = 0,
        host: str = "127.0.0.1",
        sample_interval_s: float = 1.0,
        slo_interval_s: float = 5.0,
        latency_threshold_ms: float = 250.0,
        latency_objective: float = 0.99,
        error_objective: float = 0.999,
        extra_slos: Optional[Sequence] = None,
        federate: bool = True,
        fleet_interval_s: float = 2.0,
        **slo_overrides,
    ):
        """The router-level telemetry plane (mirrors
        :meth:`ModelServer.start_telemetry`, but over ``router.*``):
        a recorder sampling the registry, an SLO engine with router p99
        latency + error-rate objectives (what the autoscaler reads), and
        an ObsServer whose ``/healthz`` reflects :meth:`status`.
        With ``federate`` (the default) a
        :class:`~sparkdl_tpu_torch.obs.fleet.FleetCollector` also scrapes
        every live replica's own metrics into the recorder as
        ``fleet.*`` series — replica-attributed signal for the SLO
        engine, the autoscaler, and the rollout controller — and the
        ObsServer gains the federated ``/metrics`` + ``/debug/fleet``
        views.  Idempotent; torn down in :meth:`close`."""
        if self._telemetry is not None:
            return self._telemetry["server"]
        from sparkdl_tpu_torch.obs import ObsServer, SLOEngine, TimeSeriesRecorder
        from sparkdl_tpu_torch.obs.slo import SLO

        recorder = TimeSeriesRecorder(interval_s=sample_interval_s).start()
        engine = SLOEngine(recorder)
        engine.add(
            SLO(
                name="router.latency",
                kind="threshold",
                series="router.latency_ms.p99",
                threshold=latency_threshold_ms,
                objective=latency_objective,
                description=(
                    f"router p99 latency under {latency_threshold_ms:g} ms"
                ),
                **slo_overrides,
            ),
            SLO(
                name="router.errors",
                kind="error_rate",
                numerator="router.errors",
                denominator="router.requests",
                objective=error_objective,
                description="router request success rate",
                **slo_overrides,
            ),
        )
        if extra_slos:
            engine.add(*extra_slos)
        engine.start(interval_s=slo_interval_s)
        fleet = None
        if federate:
            from sparkdl_tpu_torch.obs.fleet import FleetCollector

            fleet = FleetCollector(
                recorder, self.obs_targets, interval_s=fleet_interval_s,
            ).start()
        cache_view = None
        if self.router.result_cache is not None:
            result_cache = self.router.result_cache

            def cache_view(top: int = 10):
                # the router-tier LRU view plus the collapse count the
                # replicas reported back through reply markers
                snap = result_cache.snapshot(top=top)
                snap["collapsed"] = metrics.counter(
                    "router.cache.collapsed"
                ).value
                return snap
        server = ObsServer(
            port=port,
            host=host,
            recorder=recorder,
            slo_engine=engine,
            health_fn=self.status,
            fleet=fleet,
            cache=cache_view,
        ).start()
        self._telemetry = {
            "server": server, "recorder": recorder, "engine": engine,
            "fleet": fleet,
        }
        return server

    @property
    def slo_engine(self):
        """The running telemetry SLO engine (None before
        :meth:`start_telemetry`) — the autoscaler's signal source."""
        return (
            self._telemetry["engine"] if self._telemetry else None
        )

    @property
    def fleet_collector(self):
        """The running fleet collector (None before
        :meth:`start_telemetry`, or when it ran with
        ``federate=False``)."""
        return (
            self._telemetry.get("fleet") if self._telemetry else None
        )

    def __repr__(self):
        return (
            f"ReplicaSupervisor(live={self.live_count()}, "
            f"slots={len(self._handles)})"
        )


def _drain_pipe(pipe) -> None:
    try:
        while pipe.read(65536):
            pass
    except Exception:
        pass
    finally:
        try:
            pipe.close()
        except Exception:
            pass
