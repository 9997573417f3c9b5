"""Fleet replay harness: the real control plane on a virtual clock.

:class:`FleetReplay` re-runs a recorded request stream against the
*actual* serving-plane objects — a real
:class:`~sparkdl_tpu_torch.serving.router.Router` (weighted version rolls,
least-loaded placement, admission shedding, retry budget, hedge
trigger), real per-replica
:class:`~sparkdl_tpu_torch.serving.batcher.MicroBatcher` /
:class:`~sparkdl_tpu_torch.serving.admission.AdmissionQueue` instances (DRR
fair share, typed shedding, deadline expiry), and the real
:class:`~sparkdl_tpu_torch.serving.autoscale.Autoscaler` /
:class:`~sparkdl_tpu_torch.serving.rollout.RolloutController` /
:class:`~sparkdl_tpu_torch.obs.slo.SLOEngine` stepped through their
``now=``/``clock=`` seams — all driven by a deterministic
discrete-event loop instead of threads and sockets.  Only what a
device or a wire would do is replayed from the trace: each request
reuses its own recorded ``forward``/``fetch``/``wire``/``transport``/
client-hop durations, while every *queueing* phase (``admission``,
``router_queue``, ``replica_queue``) re-emerges from the simulated
contention under the candidate config.  That split is why a knob
change shows up in the replayed tail: the device cost is pinned, the
scheduling around it is live.

Determinism contract (tested): same trace + same seed + same config ->
byte-identical event log; the virtual clock never moves backwards
across controller callbacks.  The port's event log equals the JAX
package's (``sparkdl_tpu.sim.replay``) byte for byte on the same trace,
seed and config.  Speed: a trace replays in milliseconds
of wall time per second of recorded traffic (>= 100x, usually far
more) because nothing ever sleeps.
"""

from __future__ import annotations

import hashlib
import json
import random
import time
from typing import Any, Dict, List, Optional, Set, Tuple

from sparkdl_tpu_torch.obs.slo import SLO, SLOEngine
from sparkdl_tpu_torch.obs.timeseries import TimeSeriesRecorder
from sparkdl_tpu_torch.serving.autoscale import Autoscaler
from sparkdl_tpu_torch.serving.batcher import ServingConfig
from sparkdl_tpu_torch.serving.errors import (
    ServerOverloaded,
    TenantThrottled,
)
from sparkdl_tpu_torch.serving.rollout import RolloutController
from sparkdl_tpu_torch.serving.router import Router
from sparkdl_tpu_torch.sim.clock import EventLoop, VirtualClock
from sparkdl_tpu_torch.sim.replica import SimReplica, SimTransport
from sparkdl_tpu_torch.sim.trace import (
    EMERGENT_PHASES,
    REPLAYED_PHASES,
    PhaseSampler,
    TraceRecord,
    _quantile,
    summarize,
)
from sparkdl_tpu_torch.utils.metrics import MetricsRegistry

#: every knob the replay honours, with the live plane's defaults — the
#: baseline :func:`sparkdl_tpu_torch.sim.tune.tune` must beat and its
#: artifact diffs against
DEFAULT_CONFIG: Dict[str, Any] = {
    # fleet shape
    "replicas": 2,
    # batcher (per endpoint, per replica)
    "max_batch": 32,
    "max_wait_ms": 2.0,
    "queue_capacity": 256,
    # host constants, not knobs to search: the worker thread's condvar
    # wakeup latency and its per-batch CPython bookkeeping outside the
    # forward (expiry checks, future resolution, metrics) — both show
    # up in the live replica_queue floor/tail and act at every load
    "wakeup_ms": 0.15,
    "worker_overhead_ms": 0.5,
    # router
    "max_inflight": 128,
    "hedge": True,
    "hedge_quantile": 0.95,
    "hedge_min_ms": 10.0,
    "hedge_warmup": 20,
    "retry_budget_ratio": 0.5,
    "retry_budget_burst": 32.0,
    "request_timeout_s": 30.0,
    "deadline_ms": None,
    # SLO plane (threshold derived from the trace when None)
    "slo_p99_ms": None,
    "slo_objective": 0.99,
    "slo_fast_s": 2.0,
    "slo_slow_s": 8.0,
    "tick_s": 0.5,
    "drain_s": 1.0,
    # optional controllers
    "autoscale": None,   # dict(min, max, interval_s, cooldown_s, ...)
    "rollout": None,     # dict(new_version, replicas, stages, ...)
}


def _merge_config(config: Optional[Dict[str, Any]]) -> Dict[str, Any]:
    cfg = dict(DEFAULT_CONFIG)
    for key, value in (config or {}).items():
        if key not in DEFAULT_CONFIG:
            raise KeyError(f"unknown sim knob {key!r}")
        cfg[key] = value
    return cfg


class SimSupervisor:
    """The supervisor-shaped seam the autoscaler and rollout controller
    actuate: virtual replicas spawn/retire instantly (spawn latency is
    a device property the trace can't see), the router side is the real
    object."""

    def __init__(self, replay: "FleetReplay"):
        self._replay = replay
        self.router = replay.router

    # --- autoscaler interface ---------------------------------------
    def live_count(self, version: Optional[str] = None) -> int:
        return sum(
            1 for r in self._replay.replicas.values()
            if version is None or r.version == version
        )

    def scale_to(self, n: int) -> None:
        self._replay._scale_to(int(n), self.primary_version)

    # --- rollout interface ------------------------------------------
    @property
    def primary_version(self) -> str:
        return self._replay._primary_version

    def set_primary(self, version: str) -> None:
        self._replay._primary_version = str(version)

    def deploy(self, version: str, spec, replicas: int = 1) -> None:
        for _ in range(int(replicas)):
            self._replay._add_replica(str(version))

    def retire_version(self, version: str) -> Dict[int, Optional[int]]:
        gone = [
            name for name, r in self._replay.replicas.items()
            if r.version == str(version)
        ]
        for name in gone:
            self._replay._remove_replica(name)
        return {i: 0 for i, _ in enumerate(gone)}


class FleetReplay:
    """Replay ``records`` against ``config``; :meth:`run` returns the
    report.  ``time_scale`` compresses arrival gaps (2.0 = the same
    requests at twice the offered rate) — the stress dial
    ``sim/tune.py`` uses to expose headroom differences between
    configs without recording a second trace."""

    def __init__(
        self,
        records: List[TraceRecord],
        config: Optional[Dict[str, Any]] = None,
        seed: int = 0,
        time_scale: float = 1.0,
    ):
        if not records:
            raise ValueError("cannot replay an empty trace")
        self.cfg = _merge_config(config)
        self.seed = int(seed)
        self.time_scale = float(time_scale)
        self.records = sorted(records, key=lambda r: r.t)
        self.clock = VirtualClock(0.0)
        self.loop = EventLoop(self.clock)
        self.sampler = PhaseSampler(self.records, seed=self.seed)
        self._sampler_phases = frozenset(self.sampler.phases())
        # scheduler noise is a host property the trace records, not
        # something the control plane controls: the live replica_queue
        # overshoots its floor (window + minimum wakeup) by the condvar
        # wakeup jitter — replay that overshoot empirically, like wire
        # time, so the simulated queue tail is honest under ANY window
        rqs = sorted(
            float(r.phases["replica_queue"]) for r in self.records
            if "replica_queue" in r.phases
        )
        # the extreme overshoot tail (beyond ~p98) is worker-busy time,
        # not scheduler noise — the sim models that itself (busy_until /
        # worker_ready), so sampling it too would double-count the tail
        floor = _quantile(rqs, 0.02) if rqs else None
        cap = _quantile(
            [max(0.0, v - floor) for v in rqs], 0.98
        ) if floor is not None else None
        self._jitter_vals = (
            [min(max(0.0, v - floor), cap) for v in rqs]
            if floor is not None else []
        )
        self._jitter_rng = random.Random(self.seed ^ 0x9E3779B9)

        # sim-local metrics world: the SLO engine reads series the
        # replay feeds directly; the process-global registry stays out
        # of the loop so back-to-back trials never cross-contaminate
        self.registry = MetricsRegistry()
        self.recorder = TimeSeriesRecorder(
            registry=self.registry, clock=self.clock
        )
        self.engine = SLOEngine(
            self.recorder, registry=self.registry, clock=self.clock
        )
        slo_p99 = self.cfg["slo_p99_ms"]
        if slo_p99 is None:
            lats = sorted(
                float(r.latency_ms) for r in self.records
                if r.outcome == "ok" and r.latency_ms is not None
            )
            slo_p99 = round((_quantile(lats, 0.99) or 10.0) * 1.5, 3)
        self._slo_p99_ms = float(slo_p99)
        self.engine.add(
            SLO(
                name="sim.latency",
                kind="threshold",
                objective=self.cfg["slo_objective"],
                series="sim.latency_ms.p99",
                threshold=self._slo_p99_ms,
                fast_window_s=self.cfg["slo_fast_s"],
                slow_window_s=self.cfg["slo_slow_s"],
                description="replayed p99 under the trace-derived bound",
            ),
            SLO(
                name="sim.errors",
                kind="error_rate",
                objective=self.cfg["slo_objective"],
                numerator="sim.errors",
                denominator="sim.requests",
                fast_window_s=self.cfg["slo_fast_s"],
                slow_window_s=self.cfg["slo_slow_s"],
                description="sheds + expiries + failures per arrival",
            ),
        )

        self.router = Router(
            max_inflight=self.cfg["max_inflight"],
            request_timeout_s=self.cfg["request_timeout_s"],
            seed=self.seed,
            hedge=self.cfg["hedge"],
            hedge_quantile=self.cfg["hedge_quantile"],
            hedge_min_ms=self.cfg["hedge_min_ms"],
            hedge_warmup=self.cfg["hedge_warmup"],
            retry_budget_ratio=self.cfg["retry_budget_ratio"],
            retry_budget_burst=self.cfg["retry_budget_burst"],
            clock=self.clock,
        )
        self._serving_config = ServingConfig(
            max_batch=self.cfg["max_batch"],
            max_wait_ms=self.cfg["max_wait_ms"],
            queue_capacity=self.cfg["queue_capacity"],
        )
        # accounting (before the fleet: replica adds hit the event log)
        self.results: List[TraceRecord] = []
        self.event_log: List[Dict[str, Any]] = []
        self._pending: Dict[Any, Tuple[dict, Any, float, bool, float, float]] = {}
        self._close_state: Dict[Tuple[str, str], Optional[float]] = {}
        self._worker_ready: Dict[Tuple[str, str], float] = {}
        self._n_total = 0
        self._n_ok = 0
        self._n_shed = 0
        self._n_expired = 0
        self._n_errors = 0
        self._lat_window: List[float] = []
        self._ver_window: Dict[str, List[float]] = {}
        self._burn_integral = 0.0
        self._pages = 0
        self._warnings = 0
        self._worst_seen = "ok"
        self._horizon = (
            self.records[-1].t / self.time_scale + self.cfg["drain_s"]
        )
        self._ran = False

        self.replicas: Dict[str, SimReplica] = {}
        self._primary_version = "v1"
        self._replica_seq = 0
        self.supervisor = SimSupervisor(self)
        for _ in range(int(self.cfg["replicas"])):
            self._add_replica(self._primary_version)

        self.autoscaler: Optional[Autoscaler] = None
        asc = self.cfg["autoscale"]
        if asc:
            self.autoscaler = Autoscaler(
                self.supervisor,
                self.engine,
                min_replicas=asc.get("min", 1),
                max_replicas=asc.get("max", 4),
                interval_s=asc.get("interval_s", 5.0),
                cooldown_s=asc.get("cooldown_s", 15.0),
                step_up=asc.get("step_up", 1),
                ok_streak=asc.get("ok_streak", 6),
                per_replica_inflight=asc.get("per_replica_inflight", 64),
                clock=self.clock,
            )

        self.rollout: Optional[RolloutController] = None
        ro = self.cfg["rollout"]
        if ro:
            new_version = ro.get("new_version", "v2")
            self.engine.add(SLO(
                name=f"rollout.{new_version}.latency",
                kind="threshold",
                objective=self.cfg["slo_objective"],
                series=f"sim.latency_ms.{new_version}.p99",
                threshold=float(
                    ro.get("slo_p99_ms", self._slo_p99_ms)
                ),
                fast_window_s=self.cfg["slo_fast_s"],
                slow_window_s=self.cfg["slo_slow_s"],
                description="the canary's own replayed p99",
            ))
            self.rollout = RolloutController(
                self.supervisor,
                self.engine,
                new_version=new_version,
                spec=None,
                old_version=self._primary_version,
                replicas=ro.get("replicas", self.cfg["replicas"]),
                stages=ro.get("stages", (0.01, 0.5, 1.0)),
                bake_s=ro.get("bake_s", 2.0),
                interval_s=ro.get("interval_s", self.cfg["tick_s"]),
                spawn_timeout_s=ro.get("spawn_timeout_s", 10.0),
                autoscaler=self.autoscaler,
                clock=self.clock,
            )
            #: extra per-request forward latency the canary carries —
            #: how a trace-driven run injects the regression a guard
            #: rollout must catch
            self._rollout_regress_ms = float(ro.get("regress_ms", 0.0))
        else:
            self._rollout_regress_ms = 0.0

    # ------------------------------------------------------------------
    # fleet membership
    # ------------------------------------------------------------------
    def _add_replica(self, version: str) -> SimReplica:
        name = f"sim-{self._replica_seq}"
        self._replica_seq += 1
        replica = SimReplica(
            name, version, self._serving_config, self.clock,
            start=self.clock.now,
        )
        self.replicas[name] = replica
        self.router.add(
            name, "sim", 0, lanes=("sim",), version=version,
            transport=SimTransport(),
        )
        self._log("replica_add", name=name, version=version)
        return replica

    def _remove_replica(self, name: str) -> None:
        replica = self.replicas.pop(name, None)
        if replica is None:
            return
        self.router.remove(name)
        self._log("replica_remove", name=name, version=replica.version)
        # queued work keeps draining through already-scheduled events —
        # the live drain contract: removal stops placement, not service

    def _scale_to(self, n: int, version: str) -> None:
        current = [
            name for name, r in self.replicas.items()
            if r.version == version
        ]
        while len(current) < n:
            current.append(self._add_replica(version).name)
        while len(current) > n:
            self._remove_replica(current.pop())

    # ------------------------------------------------------------------
    # event log
    # ------------------------------------------------------------------
    def _log(self, ev: str, **fields: Any) -> None:
        # virtual-time arithmetic is deterministic, so raw floats hash
        # identically run-to-run; rounding here would only burn cycles
        fields["t"] = round(self.clock.now, 9)
        fields["ev"] = ev
        self.event_log.append(fields)

    def event_log_bytes(self) -> bytes:
        """The canonical event-log serialization the determinism test
        hashes: the whole log as one compact sorted-key JSON array
        (a single C-level encode — per-row dumps calls cost more than
        the rest of the report combined at replay speeds)."""
        return json.dumps(
            self.event_log, sort_keys=True, separators=(",", ":")
        ).encode()

    # ------------------------------------------------------------------
    # request lifecycle (events)
    # ------------------------------------------------------------------
    def _replayed(self, rec: TraceRecord, name: str,
                  synthetic: bool = False) -> Optional[float]:
        """The replayed duration for phase ``name``: the record's own
        value, or a seeded empirical draw for synthetic attempts /
        records that carried no phases (sheds)."""
        if not synthetic and name in rec.phases:
            return rec.phases[name]
        if name in self._sampler_phases:
            return self.sampler.sample(name)
        return None

    def _service_ms(self, rec: TraceRecord, version: str,
                    synthetic: bool = False) -> Tuple[float, float]:
        fwd = self._replayed(rec, "forward", synthetic) or 0.0
        fetch = self._replayed(rec, "fetch", synthetic) or 0.0
        if (self.rollout is not None
                and version == self.rollout.new_version):
            fwd += self._rollout_regress_ms
        return fwd, fetch

    def _arrive(self, rec: TraceRecord) -> None:
        t = self.clock.now
        self._n_total += 1
        tm = self.router._tenant_instruments(rec.tenant)
        try:
            self.router._admit(tm)
        except ServerOverloaded:
            self._finish_unplaced(rec, "ServerOverloaded")
            return
        self.router._retry_budget.earn()
        self.router._m_requests.add(1)
        if tm is not None:
            tm.requests.add(1)
        deadline = t + float(self.cfg["request_timeout_s"])
        deadline_ms = self.cfg["deadline_ms"]
        if deadline_ms:
            deadline = min(deadline, t + float(deadline_ms) / 1000.0)
        ctx = {
            "rec": rec, "t_arr": t, "tried": set(), "retries": 0,
            "attempts": 0, "done": False, "deadline": deadline,
            "last_exc": None, "primary": None,
        }
        self._place(ctx)

    def _finish_unplaced(self, rec: TraceRecord, outcome: str) -> None:
        """A request that never got an admission slot (or never found a
        backend): terminal before any attempt."""
        self._n_shed += 1
        self._n_errors += 1
        self._log("shed", ep=rec.endpoint, outcome=outcome)
        self.results.append(TraceRecord(
            t=self.clock.now, endpoint=rec.endpoint, tenant=rec.tenant,
            outcome=outcome,
        ))

    def _place(self, ctx: dict) -> None:
        """The router's retry loop, one virtual instant per pass — the
        real ``_pick`` / retry-budget / typed-shed decisions against
        the virtual replicas."""
        rec: TraceRecord = ctx["rec"]
        while True:
            if self.clock.now >= ctx["deadline"]:
                self.router._m_expired.add(1)
                self._fail_placed(ctx, "DeadlineExceeded")
                return
            if ctx["retries"] > 0 and not self.router._retry_budget.spend():
                self._fail_placed(
                    ctx, ctx["last_exc"] or "ServerOverloaded"
                )
                return
            backend = self.router._pick(ctx["tried"], pin=None)
            if backend is None:
                self._fail_placed(
                    ctx, ctx["last_exc"] or "NoLiveReplicas"
                )
                return
            replica = self.replicas.get(backend.name)
            if replica is None:  # raced a removal; try elsewhere
                self.router._unpick(backend)
                ctx["tried"].add(backend.name)
                continue
            mb = replica.batcher(rec.endpoint)
            remaining_ms = None
            if self.cfg["deadline_ms"]:
                remaining_ms = max(
                    1.0, (ctx["deadline"] - self.clock.now) * 1000.0
                )
            vm = self.router._version_instruments(backend.version)
            vm.requests.add(1)
            self.router._m_attempts.add(1)
            try:
                fut = mb.submit(
                    0.0, deadline_ms=remaining_ms, tenant=rec.tenant
                )
            except (ServerOverloaded, TenantThrottled) as exc:
                vm.errors.add(1)
                self.router._unpick(backend)
                ctx["tried"].add(backend.name)
                ctx["last_exc"] = type(exc).__name__
                ctx["retries"] += 1
                self.router._m_retries.add(1)
                continue
            if fut.done():  # expired-on-arrival fast-fail
                self.router._unpick(backend)
                self.router._m_expired.add(1)
                self._fail_placed(ctx, "DeadlineExceeded")
                return
            ctx["attempts"] += 1
            if ctx["primary"] is None:
                ctx["primary"] = backend.name
            fwd, fetch = self._service_ms(rec, backend.version)
            self._pending[fut] = (
                ctx, backend, self.clock.now, False, fwd, fetch,
            )
            self._on_admitted(replica, rec.endpoint, mb)
            delay = self.router._hedge_delay_s(ctx["deadline"])
            if delay is not None:
                self.loop.schedule(
                    self.clock.now + delay, self._maybe_hedge, ctx
                )
            return

    def _fail_placed(self, ctx: dict, outcome: str) -> None:
        """Terminal failure after admission: release the slot, count
        the error class."""
        if ctx["done"]:
            return
        ctx["done"] = True
        self.router._m_errors.add(1)
        self.router._release()
        rec: TraceRecord = ctx["rec"]
        if outcome == "DeadlineExceeded":
            self._n_expired += 1
        else:
            self._n_shed += 1
        self._n_errors += 1
        self._log("fail", ep=rec.endpoint, outcome=outcome,
                  retries=ctx["retries"])
        self.results.append(TraceRecord(
            t=ctx["t_arr"], endpoint=rec.endpoint, tenant=rec.tenant,
            outcome=outcome,
        ))

    def _maybe_hedge(self, ctx: dict) -> None:
        """The hedge race, event-shaped: if the primary attempt is
        still out past the trigger, spend a budget token and race a
        second (synthetic) attempt — real ``_pick``, real token
        bucket, real fired/wins counters."""
        if ctx["done"] or self.clock.now >= ctx["deadline"]:
            return
        rec: TraceRecord = ctx["rec"]
        tried: Set[str] = set(ctx["tried"])
        if ctx["primary"] is not None:
            tried.add(ctx["primary"])
        backend = self.router._pick(tried, pin=None)
        if backend is None:
            return
        if not self.router._retry_budget.spend():
            self.router._unpick(backend)
            return
        replica = self.replicas.get(backend.name)
        if replica is None:
            self.router._unpick(backend)
            return
        self.router._m_hedge_fired.add(1)
        mb = replica.batcher(rec.endpoint)
        vm = self.router._version_instruments(backend.version)
        vm.requests.add(1)
        self.router._m_attempts.add(1)
        try:
            fut = mb.submit(0.0, deadline_ms=None, tenant=rec.tenant)
        except (ServerOverloaded, TenantThrottled):
            vm.errors.add(1)
            self.router._unpick(backend)
            return
        ctx["attempts"] += 1
        fwd, fetch = self._service_ms(rec, backend.version, synthetic=True)
        self._pending[fut] = (
            ctx, backend, self.clock.now, True, fwd, fetch,
        )
        self._log("hedge", ep=rec.endpoint, replica=backend.name)
        self._on_admitted(replica, rec.endpoint, mb)

    # ------------------------------------------------------------------
    # replica-side batching (events)
    # ------------------------------------------------------------------
    def _wakeup_jitter_ms(self) -> float:
        """One seeded draw from the live run's wakeup-jitter empirical
        distribution (replica_queue overshoot beyond its floor)."""
        vals = self._jitter_vals
        if not vals:
            return 0.0
        if len(vals) == 1:
            return vals[0]
        pos = self._jitter_rng.random() * (len(vals) - 1)
        lo = int(pos)
        frac = pos - lo
        return vals[lo] * (1.0 - frac) + vals[lo + 1] * frac

    def _on_admitted(self, replica: SimReplica, endpoint: str, mb) -> None:
        """Keep the coalesce-window close event honest: the worker pops
        the first item once it is free (previous batch served + its
        bookkeeping) and awake, then lingers ``max_wait_ms`` *from the
        pop* — or returns immediately at ``max_batch`` — the same
        instants the live ``take`` loop returns at."""
        key = (replica.name, endpoint)
        qlen = len(mb._queue)
        wait_s = self._serving_config.max_wait_ms / 1000.0
        pending = self._close_state.get(key)
        ready = self._worker_ready.get(key, 0.0)
        if qlen >= self._serving_config.max_batch:
            desired = max(self.clock.now, ready)
        elif pending is not None:
            return  # window already closing at the first item's pop
        else:
            wake_ms = self.cfg["wakeup_ms"] + self._wakeup_jitter_ms()
            t_pop = max(self.clock.now + wake_ms / 1000.0, ready)
            desired = t_pop + wait_s
        if pending is None or desired < pending:
            self._close_state[key] = desired
            self.loop.schedule(
                desired, self._close_batch, replica, endpoint, desired
            )

    def _close_batch(self, replica: SimReplica, endpoint: str,
                     token: float) -> None:
        key = (replica.name, endpoint)
        if self._close_state.get(key) != token:
            return  # superseded by an earlier (max_batch) close
        self._close_state[key] = None
        mb = replica.batcher(endpoint)
        batch = mb.drain(self.clock.now)
        now = self.clock.now
        if batch:
            live = []
            for req in batch:
                if req.expired(now):
                    self._complete_attempt(
                        req.future, None, "DeadlineExceeded"
                    )
                else:
                    live.append(req)
            if live:
                start = max(now, replica.busy_until)
                svc_ms = max(
                    self._pending[r.future][4] + self._pending[r.future][5]
                    for r in live if r.future in self._pending
                ) if any(r.future in self._pending for r in live) else 0.0
                t_done = start + svc_ms / 1000.0
                replica.busy_until = t_done
                # the worker thread blocks on the forward, then does its
                # per-batch bookkeeping before it can pop again
                self._worker_ready[key] = (
                    t_done + self.cfg["worker_overhead_ms"] / 1000.0
                )
                self._log(
                    "batch", replica=replica.name, ep=endpoint,
                    n=len(live), start=round(start, 9), svc_ms=svc_ms,
                )
                self.loop.schedule(
                    t_done, self._finish_batch, live, start
                )
        if len(mb._queue):
            # more than max_batch were waiting: the worker's next take
            # pops them the moment it returns from this batch
            qlen = len(mb._queue)
            ready = max(now, self._worker_ready.get(key, 0.0))
            desired = (
                ready if qlen >= self._serving_config.max_batch
                else ready + self._serving_config.max_wait_ms / 1000.0
            )
            self._close_state[key] = desired
            self.loop.schedule(
                desired, self._close_batch, replica, endpoint, desired
            )

    def _finish_batch(self, live: List[Any], start: float) -> None:
        done = self.clock.now
        for req in live:
            entry = self._pending.get(req.future)
            fwd = entry[4] if entry else 0.0
            fetch = entry[5] if entry else 0.0
            # the same stamping the live worker does in _complete()
            req.future.sparkdl_phases = {
                "replica_queue": (start - req.enqueued_at) * 1000.0,
                "forward": fwd,
                "fetch": fetch,
            }
            req.future.set_result(0.0)
            self._complete_attempt(
                req.future, req.future.sparkdl_phases, None
            )

    # ------------------------------------------------------------------
    # attempt completion
    # ------------------------------------------------------------------
    def _complete_attempt(self, fut, rep_phases, error: Optional[str]) -> None:
        entry = self._pending.pop(fut, None)
        if entry is None:
            return
        ctx, backend, attempt_start, is_hedge, fwd, fetch = entry
        self.router._unpick(backend)
        ctx["attempts"] -= 1
        rec: TraceRecord = ctx["rec"]
        if error is not None:
            self.router._version_instruments(backend.version).errors.add(1)
            if ctx["done"]:
                return
            if ctx["attempts"] > 0:
                ctx["last_exc"] = error
                return  # a raced attempt may still deliver
            self._fail_placed(ctx, error)
            return
        now = self.clock.now
        synthetic = is_hedge
        rp = rec.phases if not synthetic else {}
        wire = (
            rp["wire"] if "wire" in rp
            else self._replayed(rec, "wire", synthetic)
        ) or 0.0
        transport = (
            rp["transport"] if "transport" in rp
            else self._replayed(rec, "transport", synthetic)
        ) or 0.0
        attempt_ms = (now - attempt_start) * 1000.0 + wire + transport
        self.router._observe_attempt_ms(attempt_ms)
        vm = self.router._version_instruments(backend.version)
        vm.latency.observe(attempt_ms)
        if ctx["done"]:
            return  # the hedge race's loser
        ctx["done"] = True
        if is_hedge:
            self.router._m_hedge_wins.add(1)
        self.router._release()
        phases: Dict[str, float] = {
            "admission": 0.0,
            "router_queue": (attempt_start - ctx["t_arr"]) * 1000.0,
            "replica_queue": rep_phases["replica_queue"],
            "forward": rep_phases["forward"],
            "fetch": rep_phases["fetch"],
            "wire": wire,
            "transport": transport,
        }
        for name in ("ingress", "egress", "frontdoor", "cache"):
            value = (
                rp[name] if name in rp
                else self._replayed(rec, name, synthetic)
            )
            if value is not None:
                phases[name] = value
        latency_ms = sum(phases.values())
        self._n_ok += 1
        self._lat_window.append(latency_ms)
        if len(self._lat_window) > 2048:
            del self._lat_window[:1024]
        if self.rollout is not None:
            win = self._ver_window.setdefault(backend.version, [])
            win.append(latency_ms)
            if len(win) > 2048:
                del win[:1024]
        e2e = self.router._m_latency
        e2e.observe(latency_ms)
        self._log(
            "done", ep=rec.endpoint, replica=backend.name,
            ms=round(latency_ms, 6), hedged=bool(is_hedge),
        )
        self.results.append(TraceRecord(
            t=ctx["t_arr"], endpoint=rec.endpoint, tenant=rec.tenant,
            outcome="ok", latency_ms=latency_ms, phases=phases,
        ))

    # ------------------------------------------------------------------
    # control-plane ticks
    # ------------------------------------------------------------------
    def _tick(self) -> None:
        t = self.clock.now
        # per-interval p99: only latencies completed since the last
        # tick, so the series tracks CURRENT conditions and burn can
        # actually clear after a bad stretch (a trailing window would
        # pin the series at the warmup tail for the whole run)
        if self._lat_window:
            window = sorted(self._lat_window)
            self.recorder.record(
                "sim.latency_ms.p99", _quantile(window, 0.99), now=t
            )
            self._lat_window = []
        for version, win in self._ver_window.items():
            if win:
                self.recorder.record(
                    f"sim.latency_ms.{version}.p99",
                    _quantile(sorted(win), 0.99),
                    now=t,
                )
                self._ver_window[version] = []
        self.recorder.record("sim.requests", float(self._n_total), now=t)
        self.recorder.record("sim.errors", float(self._n_errors), now=t)
        states = self.engine.evaluate_once(now=t)
        worst = "ok"
        for state in states.values():
            if state == "page":
                worst = "page"
                break
            if state == "warning":
                worst = "warning"
        if worst == "page":
            self._pages += 1
        elif worst == "warning":
            self._warnings += 1
        order = ("ok", "warning", "page")
        if order.index(worst) > order.index(self._worst_seen):
            self._worst_seen = worst
        burn = 0.0
        for row in self.engine.report()["slos"]:
            if row.get("burn_fast"):
                burn = max(burn, float(row["burn_fast"]))
        self._burn_integral += burn * self.cfg["tick_s"]
        self._log("tick", worst=worst, burn=round(burn, 6))
        if self.rollout is not None:
            self.rollout.step(now=t)
        nxt = t + self.cfg["tick_s"]
        if nxt <= self._horizon:
            self.loop.schedule(nxt, self._tick)

    def _autoscale_tick(self) -> None:
        t = self.clock.now
        decision = self.autoscaler.evaluate_once(now=t)
        self._log(
            "autoscale", worst=decision["worst"],
            replicas=decision["replicas_after"],
            moved=decision["moved"],
        )
        nxt = t + self.autoscaler.interval_s
        if nxt <= self._horizon:
            self.loop.schedule(nxt, self._autoscale_tick)

    # ------------------------------------------------------------------
    # run + report
    # ------------------------------------------------------------------
    def run(self) -> Dict[str, Any]:
        if self._ran:
            raise RuntimeError("a FleetReplay runs once; build a new one")
        self._ran = True
        wall0 = time.perf_counter()
        for rec in self.records:
            self.loop.schedule(rec.t / self.time_scale, self._arrive, rec)
        self.loop.schedule(self.cfg["tick_s"], self._tick)
        if self.autoscaler is not None:
            self.loop.schedule(
                self.autoscaler.interval_s, self._autoscale_tick
            )
        self.loop.run()
        wall_s = time.perf_counter() - wall0
        for replica in self.replicas.values():
            replica.close()
        virtual_s = self._horizon
        summary = summarize(self.results)
        report: Dict[str, Any] = {
            "benchmark": "sim_replay",
            "sim": True,
            "seed": self.seed,
            "time_scale": self.time_scale,
            "config": {
                k: v for k, v in self.cfg.items()
                if k not in ("autoscale", "rollout")
            },
            "requests": self._n_total,
            "ok": self._n_ok,
            "shed": self._n_shed,
            "expired": self._n_expired,
            "errors": self._n_errors,
            "error_rate": (
                round(self._n_errors / self._n_total, 6)
                if self._n_total else None
            ),
            "latency_ms": summary["latency_ms"],
            "phases_ms": {"per_phase_ms": summary["per_phase_ms"]},
            "slo": {
                "p99_threshold_ms": self._slo_p99_ms,
                "worst_seen": self._worst_seen,
                "pages": self._pages,
                "warnings": self._warnings,
                "burn_integral": round(self._burn_integral, 6),
                "final": self.engine.states(),
            },
            "virtual_s": round(virtual_s, 6),
            "wall_s": round(wall_s, 6),
            "speedup": (
                round(virtual_s / wall_s, 1) if wall_s > 0 else None
            ),
            "events": self.loop.processed,
            "event_log_sha256": hashlib.sha256(
                self.event_log_bytes()
            ).hexdigest(),
        }
        if self.autoscaler is not None:
            report["autoscale"] = {
                "target": self.autoscaler.target,
                "decisions": self.autoscaler.decisions(),
            }
        if self.rollout is not None:
            report["rollout"] = self.rollout.report()
        return report


def replay_trace(
    records: List[TraceRecord],
    config: Optional[Dict[str, Any]] = None,
    seed: int = 0,
    time_scale: float = 1.0,
) -> Dict[str, Any]:
    """One-shot convenience: build, run, report."""
    return FleetReplay(
        records, config=config, seed=seed, time_scale=time_scale
    ).run()


def fidelity_report(
    live: Dict[str, Any],
    sim_report: Dict[str, Any],
    tolerance: float = 0.15,
    floor_ms: float = 0.25,
) -> Dict[str, Any]:
    """Compare a live run's summary against a replay of its own trace:
    per-phase and end-to-end p50/p99 must land within ``tolerance``
    (relative) or ``floor_ms`` (absolute — sub-millisecond phases drown
    in scheduler noise the simulator rightly doesn't model).  ``live``
    is the trace header's ``live`` section (or a bench report):
    ``{"latency_ms": {...}, "phases_ms": {"per_phase_ms": {...}}}``."""
    rows: Dict[str, Any] = {}
    ok_all = True

    def compare(label: str, live_stats, sim_stats) -> None:
        nonlocal ok_all
        if not isinstance(live_stats, dict) or not isinstance(
            sim_stats, dict
        ):
            return
        for q in ("p50", "p99"):
            lv, sv = live_stats.get(q), sim_stats.get(q)
            if lv is None or sv is None:
                continue
            bound = max(tolerance * float(lv), floor_ms)
            passed = abs(float(sv) - float(lv)) <= bound
            ok_all = ok_all and passed
            rows[f"{label}.{q}"] = {
                "live": round(float(lv), 3),
                "sim": round(float(sv), 3),
                "bound": round(bound, 3),
                "ok": passed,
            }

    def phase_table(report: Dict[str, Any]) -> Dict[str, Any]:
        # bench reports nest under phases_ms; trace summaries don't
        nested = (report.get("phases_ms") or {}).get("per_phase_ms")
        return nested or report.get("per_phase_ms") or {}

    compare("e2e", live.get("latency_ms"),
            sim_report.get("latency_ms"))
    live_phases = phase_table(live)
    sim_phases = phase_table(sim_report)
    for name in sorted(live_phases):
        compare(f"phase.{name}", live_phases[name], sim_phases.get(name))
    return {"pass": ok_all, "tolerance": tolerance,
            "floor_ms": floor_ms, "rows": rows}
