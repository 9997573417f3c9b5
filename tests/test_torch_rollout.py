"""The port's blue/green rollout, on the cases of the JAX package's
``tests/test_rollout.py``: versioned routing, the SLO-guarded
``RolloutController`` and its fault sites, plus the controller half of
``tests/test_fleet_obs.py``'s federated canary.

The controller's state machine is driven synchronously against stub
supervisor, router and engine seams with an injected clock; every
``rollout.*`` fault site of ``resilience.inject.KNOWN_SITES`` is exercised
with error injection (a ``kill`` at these sites would take out the
controller's process, this test): ``rollout.shift`` and ``rollout.bake``
faults fail safe into a rollback, and a fault at ``rollout.rollback`` never
stops the rollback. The one real-process test walks a clean v2 through
every stage to promotion and holds v1's replicas to a drain with exit 0.
Replicas are CPU processes of ``tests/torch_fixtures/replica_factories.py``.
"""

import os
import sys
import threading
import time

import numpy as np
import pytest

from sparkdl_tpu_torch.obs import TimeSeriesRecorder
from sparkdl_tpu_torch.obs.slo import SLOEngine, fleet_rollout_slos, rollout_slos
from sparkdl_tpu_torch.resilience import inject
from sparkdl_tpu_torch.utils.metrics import MetricsRegistry, metrics
from sparkdl_tpu_torch.serving import ModelServer, ServingConfig
from sparkdl_tpu_torch.serving.errors import NoLiveReplicas
from sparkdl_tpu_torch.serving.replica import ReplicaService
from sparkdl_tpu_torch.serving.rollout import (
    DEFAULT_STAGES,
    RolloutController,
    _stages_from_env,
)
from sparkdl_tpu_torch.serving.router import (
    DEFAULT_VERSION,
    Router,
    split_versioned,
)
from sparkdl_tpu_torch.serving.supervisor import ReplicaSupervisor

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_fixtures")
sys.path.insert(0, FIXTURES)
from replica_factories import spec as fixture_spec  # noqa: E402


# ----------------------------------------------------------------------
# versioned routing (in-process replica services, real sockets)
# ----------------------------------------------------------------------
def versioned_service(counter=None, scale=2.0, fingerprint=None):
    server = ModelServer(ServingConfig(
        max_batch=8, max_wait_ms=1.0, queue_capacity=64,
    ), device="cpu")

    def forward(x):
        batch = np.asarray(x)
        if counter is not None:
            counter.extend([1] * batch.shape[0])
        return batch * scale

    server.register("ep0", forward, item_shape=(4,), compile=False,
                    fingerprint=fingerprint)
    return ReplicaService(server).start()


class TestSplitVersioned:
    def test_plain_id_has_no_pin(self):
        assert split_versioned("ep0") == ("ep0", None)

    def test_at_suffix_pins(self):
        assert split_versioned("ep0@v2") == ("ep0", "v2")

    def test_only_last_at_splits(self):
        assert split_versioned("a@b@v3") == ("a@b", "v3")

    def test_none_passes_through(self):
        assert split_versioned(None) == (None, None)


class TestVersionedRouter:
    def test_zero_weight_version_gets_no_unpinned_traffic(self):
        served_v1, served_v2 = [], []
        svc1 = versioned_service(served_v1)
        svc2 = versioned_service(served_v2, scale=3.0)
        with Router(seed=7) as router:
            router.add("r1", "127.0.0.1", svc1.port)
            router.add("r2", "127.0.0.1", svc2.port, version="v2")
            router.set_weights({"v1": 1.0, "v2": 0.0})
            try:
                for _ in range(20):
                    out = router.route(np.ones(4, np.float32),
                                       model_id="ep0")
                    np.testing.assert_allclose(np.asarray(out), 2.0)
                assert len(served_v1) == 20
                assert len(served_v2) == 0
            finally:
                svc1.close()
                svc2.close()

    def test_pin_overrides_weights(self):
        served_v2 = []
        svc1 = versioned_service()
        svc2 = versioned_service(served_v2, scale=3.0)
        with Router() as router:
            router.add("r1", "127.0.0.1", svc1.port)
            router.add("r2", "127.0.0.1", svc2.port, version="v2")
            router.set_weights({"v1": 1.0, "v2": 0.0})
            try:
                out = router.route(np.ones(4, np.float32),
                                   model_id="ep0@v2")
                np.testing.assert_allclose(np.asarray(out), 3.0)
                assert len(served_v2) == 1
            finally:
                svc1.close()
                svc2.close()

    def test_pin_to_absent_version_is_no_live_replicas(self):
        svc1 = versioned_service()
        with Router() as router:
            router.add("r1", "127.0.0.1", svc1.port)
            try:
                with pytest.raises(NoLiveReplicas):
                    router.route(np.ones(4, np.float32),
                                 model_id="ep0@v9")
            finally:
                svc1.close()

    def test_weights_split_traffic_roughly(self):
        served_v1, served_v2 = [], []
        svc1 = versioned_service(served_v1)
        svc2 = versioned_service(served_v2)
        with Router(seed=3) as router:
            router.add("r1", "127.0.0.1", svc1.port)
            router.add("r2", "127.0.0.1", svc2.port, version="v2")
            router.set_weights({"v1": 0.5, "v2": 0.5})
            try:
                for _ in range(60):
                    router.route(np.ones(4, np.float32), model_id="ep0")
                # seeded rng: the exact split is deterministic, but the
                # assertion only needs "both sides saw real traffic"
                assert len(served_v1) >= 10
                assert len(served_v2) >= 10
            finally:
                svc1.close()
                svc2.close()

    def test_all_zero_weights_falls_back_to_availability(self):
        # availability beats split fidelity: if every version has
        # weight 0 the router still serves (and counts the fallback)
        svc1 = versioned_service()
        with Router() as router:
            router.add("r1", "127.0.0.1", svc1.port)
            router.set_weights({"v1": 0.0})
            before = metrics.counter("router.weight_fallback").value
            try:
                out = router.route(np.ones(4, np.float32),
                                   model_id="ep0")
                np.testing.assert_allclose(np.asarray(out), 2.0)
                assert metrics.counter(
                    "router.weight_fallback"
                ).value > before
            finally:
                svc1.close()

    def test_per_version_metrics_are_attempt_level(self):
        svc2 = versioned_service(scale=3.0)
        with Router() as router:
            router.add("r2", "127.0.0.1", svc2.port, version="v2")
            before = metrics.counter("router.requests.v2").value
            try:
                router.route(np.ones(4, np.float32), model_id="ep0@v2")
                assert metrics.counter(
                    "router.requests.v2"
                ).value == before + 1
                assert metrics.histogram(
                    "router.latency_ms.v2"
                ).count > 0
            finally:
                svc2.close()

    def test_versions_and_weights_snapshots(self):
        with Router() as router:
            router.add("a", "127.0.0.1", 1, version="v1")
            router.add("b", "127.0.0.1", 2, version="v2")
            router.add("c", "127.0.0.1", 3, version="v2")
            assert router.versions() == {"v1": 1, "v2": 2}
            router.set_weights({"v2": 0.25})
            assert router.weights() == {"v2": 0.25}

    def test_rejects_negative_weight(self):
        with Router() as router:
            with pytest.raises(ValueError):
                router.set_weights({"v2": -0.1})

    def test_rollout_flip_invalidates_result_cache(self, monkeypatch):
        # invalidation by construction: the result-cache key
        # embeds the endpoint-version fingerprint, so promoting v2 (a
        # weight flip — exactly what RolloutController.set_primary
        # drives) retargets every lookup at v2's key space.  v1's
        # cached result must never be served for v2 traffic, with ZERO
        # manual flushes, and flipping BACK must re-serve v1's still-
        # warm entries without re-scoring.
        monkeypatch.setenv("SPARKDL_RESULT_CACHE", "1")
        served_v1, served_v2 = [], []
        svc1 = versioned_service(served_v1, scale=2.0,
                                 fingerprint="weights:v1")
        svc2 = versioned_service(served_v2, scale=3.0,
                                 fingerprint="weights:v2")
        with Router(seed=7) as router:
            router.add("r1", "127.0.0.1", svc1.port,
                       fingerprints={"ep0": "weights:v1"})
            router.add("r2", "127.0.0.1", svc2.port, version="v2",
                       fingerprints={"ep0": "weights:v2"})
            router.set_weights({"v1": 1.0, "v2": 0.0})
            x = np.ones(4, np.float32)
            try:
                # warm v1's cache entry, then serve it from cache
                for _ in range(3):
                    out = router.route(x, model_id="ep0")
                    np.testing.assert_allclose(np.asarray(out), 2.0)
                assert len(served_v1) == 1
                # the rollout flip: all weight to v2, no cache flush
                router.set_weights({"v1": 0.0, "v2": 1.0})
                for _ in range(3):
                    out = router.route(x, model_id="ep0")
                    # THE assertion: v2 traffic never sees v1's 2.0
                    np.testing.assert_allclose(np.asarray(out), 3.0)
                assert len(served_v2) == 1  # miss once, then v2 hits
                # flip back: v1's entry is still warm — zero re-scores
                router.set_weights({"v1": 1.0, "v2": 0.0})
                out = router.route(x, model_id="ep0")
                np.testing.assert_allclose(np.asarray(out), 2.0)
                assert len(served_v1) == 1
            finally:
                svc1.close()
                svc2.close()


# ----------------------------------------------------------------------
# controller state machine (stub seams, injected clock — no processes)
# ----------------------------------------------------------------------
class _StubRouter:
    def __init__(self):
        self.weights_log = []

    def set_weights(self, weights):
        self.weights_log.append(dict(weights))


class _StubSupervisor:
    def __init__(self, live_v1=2):
        self.router = _StubRouter()
        self.calls = []
        self.live = {DEFAULT_VERSION: live_v1}
        self.primary = DEFAULT_VERSION
        self.deploy_raises = None
        self.retire_raises = None

    @property
    def primary_version(self):
        return self.primary

    def live_count(self, version=None):
        if version is None:
            return sum(self.live.values())
        return self.live.get(version, 0)

    def deploy(self, version, spec, replicas=1):
        self.calls.append(("deploy", version, replicas))
        if self.deploy_raises is not None:
            raise self.deploy_raises
        self.live[version] = replicas
        return []

    def retire_version(self, version):
        self.calls.append(("retire", version))
        if self.retire_raises is not None:
            raise self.retire_raises
        n = self.live.pop(version, 0)
        return {slot: 0 for slot in range(n)}

    def set_primary(self, version):
        self.calls.append(("set_primary", version))
        self.primary = version


class _StubEngine:
    def __init__(self):
        self.current = {}

    def states(self):
        return dict(self.current)


class _StubAutoscaler:
    def __init__(self):
        self.log = []

    def pause(self):
        self.log.append("pause")

    def resume(self):
        self.log.append("resume")


def make_rollout(**kw):
    sup = _StubSupervisor(live_v1=kw.pop("live_v1", 2))
    engine = _StubEngine()
    clock = {"t": 0.0}
    ctl = RolloutController(
        sup, engine, "v2", spec=None,
        stages=kw.pop("stages", (0.01, 0.5, 1.0)),
        bake_s=kw.pop("bake_s", 10.0),
        spawn_timeout_s=kw.pop("spawn_timeout_s", 30.0),
        clock=lambda: clock["t"],
        **kw,
    )
    return ctl, sup, engine, clock


def drive(ctl, clock, dt=6.0, max_steps=30):
    """Tick the clock and step until a terminal state."""
    for _ in range(max_steps):
        clock["t"] += dt
        if ctl.step() in ("done", "rolled_back"):
            break
    return ctl.state


class TestRolloutStateMachine:
    def test_clean_canary_promotes_through_every_stage(self):
        ctl, sup, engine, clock = make_rollout()
        assert drive(ctl, clock) == "done"
        # every stage's weight reached the router, ascending
        canary = [w["v2"] for w in sup.router.weights_log if "v1" in w]
        assert canary[:3] == [0.01, 0.5, 1.0]
        # promotion order: all weight on v2 BEFORE v1 drains
        assert sup.calls[-2:] == [("set_primary", "v2"), ("retire", "v1")]
        report = ctl.report()
        assert report["verdict"] == "promoted"
        assert report["detection_s"] is None
        assert set(report["old_exits"].values()) == {0}

    def test_new_fleet_matches_old_fleet_size(self):
        ctl, sup, engine, clock = make_rollout(live_v1=3)
        drive(ctl, clock)
        assert ("deploy", "v2", 3) in sup.calls

    def test_canary_page_rolls_back_and_drains_v2(self):
        ctl, sup, engine, clock = make_rollout()
        while ctl.state != "baking":
            clock["t"] += 1.0
            ctl.step()
        engine.current = {"rollout.v2.latency": "page"}
        clock["t"] += 1.0
        assert ctl.step() == "rolled_back"
        # weight snapped back to v1, v2 drained out
        assert sup.router.weights_log[-1] == {"v1": 1.0, "v2": 0.0}
        assert ("retire", "v2") in sup.calls
        report = ctl.report()
        assert report["verdict"] == "rolled_back"
        assert "rollout.v2.latency" in report["reason"]
        assert report["detection_s"] == pytest.approx(1.0)

    def test_unwatched_slo_page_does_not_roll_back(self):
        # only the canary's own rollout.v2.* names are judged — a page
        # on an unrelated fleet SLO must not abort the rollout
        ctl, sup, engine, clock = make_rollout()
        while ctl.state != "baking":
            clock["t"] += 1.0
            ctl.step()
        engine.current = {"router.latency": "page",
                          "rollout.v2.errors": "warning"}
        assert drive(ctl, clock) == "done"

    def test_explicit_watch_list_overrides_prefix(self):
        ctl, sup, engine, clock = make_rollout(
            watch=("custom.canary",)
        )
        while ctl.state != "baking":
            clock["t"] += 1.0
            ctl.step()
        engine.current = {"custom.canary": "page"}
        clock["t"] += 1.0
        assert ctl.step() == "rolled_back"

    def test_spawn_timeout_rolls_back(self):
        ctl, sup, engine, clock = make_rollout(spawn_timeout_s=5.0)
        # deploy "succeeds" but the fleet never reports live
        orig = sup.deploy

        def deploy_dead(version, spec, replicas=1):
            orig(version, spec, replicas)
            sup.live[version] = 0

        sup.deploy = deploy_dead
        assert drive(ctl, clock, dt=3.0) == "rolled_back"
        assert "not live" in ctl.report()["reason"]

    def test_autoscaler_paused_during_shift_resumed_after(self):
        scaler = _StubAutoscaler()
        ctl, sup, engine, clock = make_rollout(autoscaler=scaler)
        drive(ctl, clock)
        assert scaler.log == ["pause", "resume"]

    def test_autoscaler_resumed_on_rollback_too(self):
        scaler = _StubAutoscaler()
        ctl, sup, engine, clock = make_rollout(autoscaler=scaler)
        while ctl.state != "baking":
            clock["t"] += 1.0
            ctl.step()
        engine.current = {"rollout.v2.latency": "page"}
        clock["t"] += 1.0
        ctl.step()
        assert scaler.log == ["pause", "resume"]

    def test_terminal_states_are_sticky(self):
        ctl, sup, engine, clock = make_rollout()
        drive(ctl, clock)
        calls = list(sup.calls)
        clock["t"] += 100.0
        assert ctl.step() == "done"
        assert sup.calls == calls

    def test_rejects_same_version_both_sides(self):
        sup = _StubSupervisor()
        with pytest.raises(ValueError):
            RolloutController(sup, _StubEngine(), DEFAULT_VERSION,
                              spec=None)

    def test_rejects_unsorted_or_out_of_range_stages(self):
        sup = _StubSupervisor()
        for bad in ((0.5, 0.1), (0.0, 1.0), (0.5, 1.5), ()):
            with pytest.raises(ValueError):
                RolloutController(sup, _StubEngine(), "v2", spec=None,
                                  stages=bad)

    def test_stages_env_knob(self, monkeypatch):
        monkeypatch.delenv("SPARKDL_ROLLOUT_STAGES", raising=False)
        assert _stages_from_env() == DEFAULT_STAGES
        monkeypatch.setenv("SPARKDL_ROLLOUT_STAGES", "0.1,1.0")
        assert _stages_from_env() == (0.1, 1.0)


# ----------------------------------------------------------------------
# rollout fault sites (error injection: a kill here would kill the
# controller process — this test — so fail-safe semantics are what the
# kill matrix means for rollout.*)
# ----------------------------------------------------------------------
class TestRolloutFaultSites:
    def test_registry_lists_rollout_sites(self):
        sites = inject.known_sites()
        for site in ("rollout.shift", "rollout.bake",
                     "rollout.rollback"):
            assert site in sites

    def test_shift_fault_fails_safe_into_rollback(self):
        ctl, sup, engine, clock = make_rollout()
        plan = inject.FaultPlan().add(
            "rollout.shift", error="transient", at=1
        )
        with inject.active_plan(plan):
            assert drive(ctl, clock, dt=1.0) == "rolled_back"
        assert "shifting" in ctl.report()["reason"]
        # the rollback still restored v1's weight
        assert sup.router.weights_log[-1] == {"v1": 1.0, "v2": 0.0}

    def test_bake_fault_fails_safe_into_rollback(self):
        ctl, sup, engine, clock = make_rollout()
        plan = inject.FaultPlan().add(
            "rollout.bake", error="transient", at=1
        )
        with inject.active_plan(plan):
            assert drive(ctl, clock, dt=1.0) == "rolled_back"
        assert "baking" in ctl.report()["reason"]
        assert ("retire", "v2") in sup.calls

    def test_rollback_fault_cannot_stop_the_rollback(self):
        ctl, sup, engine, clock = make_rollout()
        plan = inject.FaultPlan().add(
            "rollout.rollback", error="permanent", at=1
        )
        with inject.active_plan(plan):
            while ctl.state != "baking":
                clock["t"] += 1.0
                ctl.step()
            engine.current = {"rollout.v2.latency": "page"}
            clock["t"] += 1.0
            assert ctl.step() == "rolled_back"
        # despite the injected fault mid-rollback, the weights were
        # restored and the v2 fleet drained
        assert sup.router.weights_log[-1] == {"v1": 1.0, "v2": 0.0}
        assert ("retire", "v2") in sup.calls

    def test_even_retire_failure_leaves_weights_safe(self):
        ctl, sup, engine, clock = make_rollout()
        sup.retire_raises = RuntimeError("drain hung")
        while ctl.state != "baking":
            clock["t"] += 1.0
            ctl.step()
        engine.current = {"rollout.v2.errors": "page"}
        clock["t"] += 1.0
        assert ctl.step() == "rolled_back"
        assert sup.router.weights_log[-1] == {"v1": 1.0, "v2": 0.0}


# ----------------------------------------------------------------------
# canary SLO factories
# ----------------------------------------------------------------------
class TestRolloutSLOFactories:
    def test_rollout_pair_watches_per_version_series(self):
        lat, err = rollout_slos("v2", latency_threshold_ms=50.0)
        assert lat.name == "rollout.v2.latency"
        assert lat.series == "router.latency_ms.v2.p99"
        assert err.name == "rollout.v2.errors"
        assert err.numerator == "router.errors.v2"
        assert err.denominator == "router.requests.v2"

    def test_tenant_pair_watches_tenant_series(self):
        from sparkdl_tpu_torch.obs.slo import tenant_slos

        lat, err = tenant_slos("tenant-b")
        assert lat.name == "tenant.tenant_b.latency"
        assert lat.series == "router.tenant.tenant_b.latency_ms.p99"
        assert err.numerator == "router.tenant.tenant_b.errors"


# ----------------------------------------------------------------------
# real processes: clean v2 promotes, v1 drains with exit 0 under load
# ----------------------------------------------------------------------
def test_clean_rollout_promotes_and_v1_drains_clean():
    from sparkdl_tpu_torch.resilience.policy import RetryPolicy

    spec = fixture_spec("demo_server_plain")
    sup = ReplicaSupervisor(
        spec, replicas=1, monitor_interval_s=0.05,
        health_interval_s=1.0, spawn_timeout_s=120.0,
        backoff=RetryPolicy(max_attempts=8, base_delay_s=0.1,
                            multiplier=1.5, max_delay_s=0.5, jitter=0.0),
    ).start()
    try:
        assert sup.wait_live(1, 120.0)
        stop = threading.Event()
        failures = []
        served = [0]

        def traffic():
            x = np.ones(64, np.float32)
            while not stop.is_set():
                try:
                    sup.router.route(x, model_id="ep0")
                    served[0] += 1
                except Exception as exc:  # noqa: BLE001
                    failures.append(exc)
                time.sleep(0.01)

        threads = [threading.Thread(target=traffic, daemon=True)
                   for _ in range(2)]
        for t in threads:
            t.start()
        # no engine: a clean canary never needs one (states() unread
        # paths are covered by the stub tests) — watch nothing, bake
        # fast, promote for real
        ctl = RolloutController(
            sup, None, "v2", fixture_spec("demo_server_plain"),
            replicas=1, stages=(0.5, 1.0), bake_s=0.3,
            interval_s=0.05, spawn_timeout_s=120.0,
        ).start()
        state = ctl.wait(timeout_s=180.0)
        stop.set()
        for t in threads:
            t.join(timeout=10)
        assert state == "done", ctl.report()
        report = ctl.report()
        assert report["verdict"] == "promoted"
        # THE zero-downtime contract: every v1 replica drained clean
        assert set(report["old_exits"].values()) == {0}, report
        assert sup.primary_version == "v2"
        assert sup.live_count("v2") == 1
        assert sup.live_count("v1") == 0
        # traffic flowed throughout; nothing the router accepted died
        assert served[0] > 0
        assert not failures, failures[:3]
        # and the promoted fleet still serves
        out = sup.router.route(np.ones(64, np.float32), model_id="ep0")
        assert np.asarray(out).shape == (64,)
    finally:
        sup.close()


# ----------------------------------------------------------------------
# the federated canary: the controller half of tests/test_fleet_obs.py
# ----------------------------------------------------------------------
class TestFederatedCanaryController:
    def test_fleet_rollout_slos_watch_federated_series(self):
        # the names the controller's default watch matches for "V2-Canary"
        slos = fleet_rollout_slos("V2-Canary")
        by_name = {s.name: s for s in slos}
        assert set(by_name) == {
            "fleet.rollout.v2_canary.latency",
            "fleet.rollout.v2_canary.errors",
        }
        lat = by_name["fleet.rollout.v2_canary.latency"]
        assert lat.series == "fleet.version.v2_canary.serving.latency_ms.p99"
        err = by_name["fleet.rollout.v2_canary.errors"]
        assert err.numerator == "fleet.version.v2_canary.serving.errors"
        assert err.denominator == "fleet.version.v2_canary.serving.requests"
        engine = _StubEngine()
        engine.current = {name: "page" for name in by_name}
        ctl = RolloutController(_StubSupervisor(), engine, "v2_canary", spec=None)
        assert ctl._breached() == sorted(by_name)

    def test_canary_pages_on_own_series_while_router_view_is_clean(self):
        # every request the canary serves fails, but the router's retries
        # re-place them on v1: the router-side attempt series stay clean,
        # and the federated series (the canary's own numbers) page
        rec = TimeSeriesRecorder(interval_s=60.0)
        engine = SLOEngine(rec, registry=MetricsRegistry(), clock=lambda: 0.0)
        engine.add(*rollout_slos("v2", fast_window_s=5.0, slow_window_s=10.0))
        engine.add(*fleet_rollout_slos("v2", fast_window_s=5.0, slow_window_s=10.0))
        for t in range(12):
            t = float(t)
            rec.record("router.requests.v2", 10.0 * t, now=t)
            rec.record("router.errors.v2", 0.0, now=t)
            rec.record("router.latency_ms.v2.p99", 5.0, now=t)
            rec.record("fleet.version.v2.serving.requests", 10.0 * t, now=t)
            rec.record("fleet.version.v2.serving.errors", 10.0 * t, now=t)
        states = engine.evaluate_once(now=11.0)
        assert states["rollout.v2.errors"] == "ok"
        assert states["rollout.v2.latency"] == "ok"
        assert states["fleet.rollout.v2.errors"] == "page"
        # the controller's default watch catches exactly that federated
        # breach, with no explicit watch list
        ctrl = RolloutController(
            object(), engine, "v2", spec=None, old_version="v1",
            replicas=1, stages=(0.05, 1.0), bake_s=1.0,
            interval_s=0.1, spawn_timeout_s=1.0,
        )
        assert ctrl._breached() == ["fleet.rollout.v2.errors"]
