"""The port's replica plane on the cases of the JAX package's
``tests/test_supervisor.py``: wire protocol, router, supervisor, autoscaler.

The centerpiece is the kill matrix (:class:`TestKillMatrix`): with 2
replicas under sustained multi-thread traffic, a ``FaultPlan`` kill at
``supervisor.replica_serve`` takes one replica out **mid-request**, and the
run must lose zero accepted requests (the stranded one retries on the
survivor), the supervisor must restart the dead slot, and p99 must return
to pre-kill levels within a bounded window.

Every ``supervisor.*`` and ``router.*`` fault site of
``resilience.inject.KNOWN_SITES`` is exercised here:
``supervisor.replica_serve`` (kill matrix), ``supervisor.replica_warm``
(:func:`test_replica_warm_kill_restarts`), ``supervisor.spawn`` and
``supervisor.restart`` (:func:`test_spawn_and_restart_fault_sites`),
``supervisor.health`` (:func:`test_health_probe_condemns_replica`),
``router.route`` (:func:`test_route_fault_site_fires`).

Replicas are CPU processes built by the zero-argument factories of
``tests/torch_fixtures/replica_factories.py``. Process-spawning tests pace
themselves on supervisor state, not sleeps; each replica boot pays a torch
import, so the per-test replica counts are deliberately minimal. The
reference's compile-cache-warm restart case is not held here: it fails in
the reference's own runs, and a restart's warmup is the engine's concern.
"""

import json
import os
import socket
import struct
import sys
import threading
import time

import numpy as np
import pytest
import torch

from sparkdl_tpu_torch.resilience import inject
from sparkdl_tpu_torch.utils.metrics import metrics
from sparkdl_tpu_torch.resilience.errors import TransientError
from sparkdl_tpu_torch.resilience.policy import RetryPolicy
from sparkdl_tpu_torch.serving import ModelServer, ServingConfig, wire
from sparkdl_tpu_torch.serving.errors import (
    NoLiveReplicas,
    RemoteReplicaError,
    ReplicaDraining,
    ServerOverloaded,
)
from sparkdl_tpu_torch.serving.autoscale import Autoscaler
from sparkdl_tpu_torch.serving.replica import ReplicaService, ReplicaSpec
from sparkdl_tpu_torch.serving.router import Router
from sparkdl_tpu_torch.serving.supervisor import ReplicaSupervisor

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_fixtures")
sys.path.insert(0, FIXTURES)
from replica_factories import spec as fixture_spec  # noqa: E402


def fast_supervisor(**kw):
    """A supervisor tuned for test latency: tight monitor ticks, fast
    deterministic backoff."""
    defaults = dict(
        replicas=1,
        monitor_interval_s=0.05,
        health_interval_s=1.0,
        spawn_timeout_s=120.0,
        backoff=RetryPolicy(
            max_attempts=8, base_delay_s=0.1, multiplier=1.5,
            max_delay_s=0.5, jitter=0.0,
        ),
    )
    spec = kw.pop("spec", None) or fixture_spec("demo_server_plain")
    defaults.update(kw)
    return ReplicaSupervisor(spec, **defaults)


def wait_until(predicate, timeout_s=60.0, interval_s=0.05):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(interval_s)
    return predicate()


# ----------------------------------------------------------------------
# wire protocol
# ----------------------------------------------------------------------
class TestWire:
    def test_roundtrip_ndarray_frame(self):
        a, b = socket.socketpair()
        try:
            payload = {"op": "infer", "value": np.arange(8, dtype=np.float32)}
            wire.send_msg(a, payload)
            got = wire.recv_msg(b)
            assert got["op"] == "infer"
            np.testing.assert_array_equal(got["value"], payload["value"])
        finally:
            a.close()
            b.close()

    def test_clean_eof_is_none(self):
        a, b = socket.socketpair()
        a.close()
        try:
            assert wire.recv_msg(b) is None
        finally:
            b.close()

    def test_mid_frame_close_is_connection_error(self):
        a, b = socket.socketpair()
        try:
            # a frame prefix promising 100 body bytes, then death
            a.sendall(struct.pack(
                ">4sBBIQ", wire.MAGIC, wire.KIND_MSG, 0, 10, 100
            ) + b"only-a-few")
            a.close()
            with pytest.raises(ConnectionError):
                wire.recv_msg(b)
        finally:
            b.close()

    def test_oversized_frame_refused(self):
        a, b = socket.socketpair()
        try:
            a.sendall(struct.pack(
                ">4sBBIQ", wire.MAGIC, wire.KIND_MSG, 0, 16,
                wire.MAX_FRAME_BYTES + 1,
            ))
            with pytest.raises(ConnectionError):
                wire.recv_msg(b)
        finally:
            a.close()
            b.close()

    def test_typed_error_crosses_by_class(self):
        reply = wire.encode_error(ReplicaDraining("draining"))
        exc = wire.decode_error(reply)
        assert isinstance(exc, ReplicaDraining)
        assert isinstance(exc, TransientError)  # classification survives

    def test_unknown_error_class_is_permanent_remote_error(self):
        exc = wire.decode_error(
            {"ok": False, "error_class": "SomethingExotic", "error": "boom"}
        )
        assert isinstance(exc, RemoteReplicaError)
        assert "SomethingExotic" in str(exc)


# ----------------------------------------------------------------------
# router over in-process replica services
# ----------------------------------------------------------------------
def plain_service(counter=None):
    """A ReplicaService around a tiny compile=False ModelServer; if
    ``counter`` is given, the forward appends to it per call."""
    server = ModelServer(ServingConfig(
        max_batch=8, max_wait_ms=1.0, queue_capacity=64,
    ), device="cpu")

    def forward(x):
        batch = x
        if counter is not None:
            counter.extend([1] * batch.shape[0])  # count items, not batches
        return batch * 2.0

    server.register("ep0", forward, item_shape=(4,), compile=False)
    return ReplicaService(server).start()


class TestRouter:
    def test_routes_and_returns_result(self):
        svc = plain_service()
        with Router() as router:
            router.add("r0", "127.0.0.1", svc.port)
            try:
                out = router.route(np.ones(4, np.float32), model_id="ep0")
                np.testing.assert_allclose(np.asarray(out), 2.0)
            finally:
                svc.close()

    def test_dead_replica_fails_over_to_survivor(self):
        served_b = []
        svc_a = plain_service()
        svc_b = plain_service(served_b)
        with Router() as router:
            router.add("a", "127.0.0.1", svc_a.port)
            router.add("b", "127.0.0.1", svc_b.port)
            # replica "a" dies while still registered: its port now
            # refuses connections, so every placement on it must retry
            svc_a.close()
            try:
                x = np.ones(4, np.float32)
                retries_before = metrics.counter("router.retries").value
                for _ in range(6):
                    out = router.route(x, model_id="ep0")
                    np.testing.assert_allclose(np.asarray(out), 2.0)
                # every request landed on the survivor, via retry
                assert len(served_b) >= 6
                assert metrics.counter(
                    "router.retries"
                ).value > retries_before
            finally:
                svc_b.close()

    def test_draining_replica_is_rerouted(self):
        served_b = []
        svc_a = plain_service()
        svc_b = plain_service(served_b)
        with Router() as router:
            router.add("a", "127.0.0.1", svc_a.port)
            router.add("b", "127.0.0.1", svc_b.port)
            try:
                with svc_a._lock:
                    svc_a._draining = True
                for _ in range(4):
                    out = router.route(np.ones(4, np.float32),
                                       model_id="ep0")
                    np.testing.assert_allclose(np.asarray(out), 2.0)
                assert len(served_b) >= 4
            finally:
                svc_a.close()
                svc_b.close()

    def test_no_live_replicas_is_typed(self):
        with Router() as router:
            with pytest.raises(NoLiveReplicas):
                router.route(np.ones(4, np.float32))

    def test_admission_limit_sheds_typed(self):
        svc = plain_service()
        with Router(max_inflight=0) as router:
            router.add("r0", "127.0.0.1", svc.port)
            try:
                with pytest.raises(ServerOverloaded):
                    router.route(np.ones(4, np.float32), model_id="ep0")
            finally:
                svc.close()

    def test_concurrent_load_spreads_over_replicas(self):
        served_a, served_b = [], []
        svc_a = plain_service(served_a)
        svc_b = plain_service(served_b)
        with Router() as router:
            router.add("a", "127.0.0.1", svc_a.port)
            router.add("b", "127.0.0.1", svc_b.port)
            try:
                x = np.ones(4, np.float32)
                errs = []

                def hammer():
                    for _ in range(25):
                        try:
                            router.route(x, model_id="ep0")
                        except Exception as exc:  # noqa: BLE001
                            errs.append(exc)

                threads = [
                    threading.Thread(target=hammer, daemon=True)
                    for _ in range(6)
                ]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(timeout=60)
                assert not errs
                # least-loaded placement must use both replicas under
                # concurrency
                assert len(served_a) > 0 and len(served_b) > 0
                assert len(served_a) + len(served_b) >= 150
            finally:
                svc_a.close()
                svc_b.close()

    def test_route_fault_site_fires(self):
        svc = plain_service()
        plan = inject.FaultPlan().add(
            "router.route", error="transient", at=1
        )
        with Router() as router:
            router.add("r0", "127.0.0.1", svc.port)
            try:
                with inject.active_plan(plan):
                    with pytest.raises(inject.InjectedTransientError):
                        router.route(np.ones(4, np.float32),
                                     model_id="ep0")
                    # next request is past the planned fault
                    out = router.route(np.ones(4, np.float32),
                                       model_id="ep0")
                np.testing.assert_allclose(np.asarray(out), 2.0)
            finally:
                svc.close()


# ----------------------------------------------------------------------
# replica spec
# ----------------------------------------------------------------------
@pytest.mark.parametrize("name", ["demo_server_plain", "demo_server_decode",
                                  "demo_server_metered", "demo_server_slow"])
def test_demo_factories_match_the_jax_packages(name, monkeypatch):
    """Each demo factory builds on the device asked for (the card by
    default, which raises here) and answers as the JAX package's does."""
    from sparkdl_tpu.serving import replica as jax_replica
    from sparkdl_tpu_torch.serving import replica

    monkeypatch.setenv("SPARKDL_DEMO_COST_MS", "1")
    monkeypatch.setenv("SPARKDL_DEMO_DELAY_MS", "1")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        getattr(replica, name)()
    x = np.random.default_rng(0).standard_normal((3, replica.DEMO_DIM)).astype(np.float32)
    with getattr(replica, name)(device="cpu") as port, getattr(jax_replica, name)() as ref:
        assert port.fingerprints() == ref.fingerprints()
        for mid in ("ep0", "ep1", "ep2"):
            got = np.stack([port.predict(row, model_id=mid, timeout=30) for row in x])
            want = np.stack([np.asarray(ref.predict(row, model_id=mid, timeout=30))
                             for row in x])
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        if name == "demo_server_decode":
            np.testing.assert_array_equal(
                port.decode([2.0, 1.0], model_id="dec0", max_steps=5, timeout=30),
                np.asarray(ref.decode([2.0, 1.0], model_id="dec0", max_steps=5,
                                      timeout=30)))


class TestReplicaSpec:
    def test_json_roundtrip(self):
        spec = ReplicaSpec(
            factory="pkg.mod:make", warmup=False, port=7001,
            pythonpath=("/tmp/x",),
        )
        back = ReplicaSpec.from_json(spec.to_json())
        assert back == spec

    def test_from_env_requires_var(self, monkeypatch):
        monkeypatch.delenv("SPARKDL_REPLICA_SPEC", raising=False)
        with pytest.raises(RuntimeError):
            ReplicaSpec.from_env()

    def test_factory_must_be_module_colon_callable(self):
        with pytest.raises(ValueError):
            ReplicaSpec(factory="no_colon_here").build_server()


# ----------------------------------------------------------------------
# THE kill matrix: FaultPlan kill at
# supervisor.replica_serve under sustained traffic
# ----------------------------------------------------------------------
class TestKillMatrix:
    # ragged slot-block dispatch defaults ON, so the two
    # lane cases already prove zero accepted loss through the ragged
    # path; the third case pins the SPARKDL_RAGGED=0 padded-ladder
    # fallback to the same contract
    @pytest.mark.parametrize("lane,ragged", [
        ("tcp", "1"), ("shm", "1"), ("shm", "0"),
    ])
    def test_replica_kill_under_load_loses_nothing(
        self, lane, ragged, monkeypatch
    ):
        monkeypatch.setenv("SPARKDL_WIRE_TRANSPORT", lane)
        monkeypatch.setenv("SPARKDL_RAGGED", ragged)
        sup = fast_supervisor(
            replicas=2,
            fault_plans={0: [{
                # slot 0 dies MID-REQUEST (os._exit) at its 150th
                # served request — the stranded request must fail over
                "site": "supervisor.replica_serve", "kill": True,
                "at": 150,
            }]},
        )
        results = []  # (t_rel, latency_s, error-or-None)
        stop = threading.Event()
        with sup:
            assert sup.wait_live(2, 120), sup.status()
            # the requested lane must actually be the one carrying
            # traffic (replicas advertise shm unless disabled)
            lanes = sup.status()["router"]["lanes"]
            assert set(lanes.values()) == {lane}, lanes
            start = time.monotonic()

            def generate():
                x = np.ones(64, np.float32)
                while not stop.is_set():
                    t0 = time.monotonic()
                    err = None
                    try:
                        sup.router.route(x, model_id="ep0",
                                         timeout_s=15.0)
                    except Exception as exc:  # noqa: BLE001
                        err = exc
                    results.append(
                        (t0 - start, time.monotonic() - t0, err)
                    )

            threads = [
                threading.Thread(target=generate, daemon=True)
                for _ in range(4)
            ]
            for t in threads:
                t.start()

            # watch for the kill and the recovery
            kill_t = recovery_t = None
            deadline = time.monotonic() + 90
            while time.monotonic() < deadline:
                status = sup.status()
                slot0 = next(
                    r for r in status["replicas"] if r["slot"] == 0
                )
                if kill_t is None and status["live"] < 2:
                    kill_t = time.monotonic() - start
                if slot0["generation"] >= 2 and status["live"] == 2:
                    recovery_t = time.monotonic() - start
                    break
                time.sleep(0.05)
            # keep traffic flowing on the recovered fleet
            time.sleep(1.5)
            stop.set()
            for t in threads:
                t.join(timeout=30)

        assert kill_t is not None, "planned kill never happened"
        assert recovery_t is not None, (
            f"slot 0 not restarted: {sup.status()}"
        )

        failures = [r for r in results if r[2] is not None]
        assert not failures, (
            "accepted requests were lost during the kill: "
            f"{[(type(e).__name__, str(e)) for _, _, e in failures[:5]]}"
        )
        assert len(results) > 300, "not enough sustained traffic"

        # p99 recovers to pre-kill levels within a bounded window: the
        # post-recovery tail must not be worse than 5x the pre-kill tail
        # (generous — CPU CI boxes jitter — but a replica that came back
        # cold or a router still timing out on the dead one blows it)
        pre = sorted(lat for t, lat, _ in results if t < kill_t)
        post = sorted(
            lat for t, lat, _ in results if t >= recovery_t + 0.5
        )
        assert pre and post
        pre_p99 = pre[min(len(pre) - 1, int(0.99 * len(pre)))]
        post_p99 = post[min(len(post) - 1, int(0.99 * len(post)))]
        assert post_p99 <= max(5 * pre_p99, 0.25), (
            f"p99 did not recover: pre={pre_p99:.4f}s "
            f"post={post_p99:.4f}s"
        )

        # shm lane hygiene: every segment this router created was
        # unlinked — a SIGKILLed replica must not leak /dev/shm entries
        from sparkdl_tpu_torch.serving import transport as transport_mod

        assert transport_mod.active_segments() == []
        shm_dir = "/dev/shm"
        if os.path.isdir(shm_dir):
            mine = [f for f in os.listdir(shm_dir)
                    if f.startswith(f"sdw_{os.getpid()}_")]
            assert mine == [], f"leaked shm segments: {mine}"

    def test_shm_disabled_replica_falls_back_to_tcp(self, monkeypatch):
        """Transparent fallback, process-level: the operator asks for
        shm but replicas refuse (SPARKDL_WIRE_SHM_DISABLE) — traffic
        must flow over TCP with no caller-visible difference."""
        monkeypatch.setenv("SPARKDL_WIRE_TRANSPORT", "shm")
        monkeypatch.setenv("SPARKDL_WIRE_SHM_DISABLE", "1")
        fallback_before = metrics.counter("wire.shm.fallback").value
        sup = fast_supervisor(replicas=1)
        with sup:
            assert sup.wait_live(1, 120), sup.status()
            lanes = sup.status()["router"]["lanes"]
            assert set(lanes.values()) == {"tcp"}, lanes
            out = sup.router.route(
                np.ones(64, np.float32), model_id="ep0", timeout_s=15.0
            )
            assert np.asarray(out).shape == (64,)
        assert metrics.counter(
            "wire.shm.fallback"
        ).value > fallback_before


# ----------------------------------------------------------------------
# drain contract
# ----------------------------------------------------------------------
SLOW_FACTORY_SRC = '''
import time

import numpy as np

from sparkdl_tpu_torch.serving.batcher import ServingConfig
from sparkdl_tpu_torch.serving.server import ModelServer


def make():
    server = ModelServer(ServingConfig(
        max_batch=4, max_wait_ms=1.0, queue_capacity=32,
    ), device="cpu")

    def forward(x):
        time.sleep(1.0)
        return x * 2.0

    server.register("slow", forward, item_shape=(4,), compile=False)
    return server
'''


def test_sigterm_drain_finishes_inflight(tmp_path):
    """Graceful stop: the in-flight request completes, the replica exits
    0 (clean drain), and the router stops placing new work there."""
    (tmp_path / "slow_replica_factory.py").write_text(SLOW_FACTORY_SRC)
    spec = ReplicaSpec(
        factory="slow_replica_factory:make",
        warmup=False,
        pythonpath=(str(tmp_path),),
    )
    sup = fast_supervisor(spec=spec, replicas=1)
    with sup:
        assert sup.wait_live(1, 120)
        outcome = {}

        def slow_request():
            try:
                outcome["result"] = np.asarray(sup.router.route(
                    np.ones(4, np.float32), model_id="slow",
                    timeout_s=30.0,
                ))
            except Exception as exc:  # noqa: BLE001
                outcome["error"] = exc

        t = threading.Thread(target=slow_request, daemon=True)
        t.start()
        time.sleep(0.4)  # let it reach the replica's 1s forward
        sup.stop_replica(0, graceful=True)  # blocks through the drain
        t.join(timeout=30)
        assert "error" not in outcome, outcome["error"]
        np.testing.assert_allclose(outcome["result"], 2.0)
        handle = sup.handles()[0]
        assert handle.state == "stopped"
        assert handle.last_exit == 0  # clean drain, not the timeout path
        with pytest.raises(NoLiveReplicas):
            sup.router.route(np.ones(4, np.float32), model_id="slow")


CHATTY_FACTORY_SRC = '''
import os
import subprocess
import sys

from replica_factories import demo_server_plain


def make():
    # what a kernel build or a library may do while the server is built
    print("building kernels...", flush=True)
    os.write(1, b"a raw write to descriptor 1\\n")
    subprocess.run([sys.executable, "-c", "print('a child process inherits stdout')"],
                   check=True)
    return demo_server_plain()
'''


def test_stdout_chatter_does_not_break_the_ready_line(tmp_path):
    """The ready line is the replica's only stdout line: whatever else the
    factory (or a process it starts) writes there goes to stderr."""
    (tmp_path / "chatty_factory.py").write_text(CHATTY_FACTORY_SRC)
    spec = ReplicaSpec(factory="chatty_factory:make",
                       pythonpath=(str(tmp_path), FIXTURES))
    spawns = metrics.counter("supervisor.spawns").value
    sup = fast_supervisor(spec=spec, replicas=1)
    with sup:
        assert sup.wait_live(1, 120), sup.status()
        got = sup.router.route(np.ones(64, np.float32), model_id="ep0", timeout_s=30.0)
        assert np.asarray(got).shape == (64,)
        # live at the first spawn: the chatter did not cost a retry
        assert metrics.counter("supervisor.spawns").value - spawns == 1


# ----------------------------------------------------------------------
# fault sites in the supervisor/replica processes
# ----------------------------------------------------------------------
def test_replica_warm_kill_restarts():
    """A kill at ``supervisor.replica_warm`` takes out the FIRST process
    of the slot during warmup; the supervisor backs off and the restart
    (no plan re-armed) comes up live."""
    sup = fast_supervisor(
        replicas=1,
        fault_plans={0: [{
            "site": "supervisor.replica_warm", "kill": True, "at": 1,
        }]},
    )
    with sup:
        assert sup.wait_live(1, 180), sup.status()
        handle = sup.handles()[0]
        assert handle.last_exit == 9  # the planned os._exit(9) happened
        assert handle.generation == 1  # first SUCCESSFUL spawn
        assert handle.state == "live"


def test_spawn_and_restart_fault_sites():
    """Injected faults at ``supervisor.spawn`` and then at
    ``supervisor.restart`` each count as a failed run; the loop keeps
    backing off until a clean spawn."""
    plan = (
        inject.FaultPlan()
        .add("supervisor.spawn", error="transient", at=1)
        .add("supervisor.restart", error="transient", at=1)
    )
    with inject.active_plan(plan):
        sup = fast_supervisor(replicas=1)
        with sup:
            assert sup.wait_live(1, 180), sup.status()
            # spawn #1 injected-failed; restart #1 injected-failed;
            # restart #2 -> spawn #2 succeeded
            assert plan.count("supervisor.spawn") >= 2
            assert plan.count("supervisor.restart") >= 2
            assert sup.handles()[0].attempt == 0  # reset on success


def test_health_probe_condemns_replica():
    """Consecutive failed ``supervisor.health`` probes (injected) kill
    and restart an otherwise-live replica — the gray-failure path."""
    sup = fast_supervisor(
        replicas=1, health_interval_s=0.2, health_failures=2,
    )
    with sup:
        assert sup.wait_live(1, 120)
        first_pid = sup.handles()[0].proc.pid
        plan = inject.FaultPlan().add(
            "supervisor.health", error="transient", at=1, times=2,
        )
        with inject.active_plan(plan):
            assert wait_until(
                lambda: sup.handles()[0].generation >= 2
                and sup.live_count() == 1,
                timeout_s=180.0,
            ), sup.status()
        assert sup.handles()[0].proc.pid != first_pid


def test_crash_loop_evicts_via_breaker():
    """A slot whose replica can never boot trips its CircuitBreaker and
    is evicted instead of burning spawn cycles forever."""
    spec = ReplicaSpec(
        factory="sparkdl_tpu_torch.serving.replica:no_such_factory"
    )
    sup = fast_supervisor(spec=spec, replicas=1, breaker_threshold=2)
    with sup:
        assert wait_until(
            lambda: sup.handles()[0].state == "evicted",
            timeout_s=180.0,
        ), sup.status()
        status = sup.status()
        assert status["breakers"][0]["state"] == "open"
        assert not status["healthy"]


# ----------------------------------------------------------------------
# autoscaler control law (stub supervisor/engine — no processes)
# ----------------------------------------------------------------------
class _StubRouter:
    def __init__(self):
        self.limits = []

    def set_max_inflight(self, n):
        self.limits.append(n)


class _StubSupervisor:
    def __init__(self, live=1):
        self.router = _StubRouter()
        self.scaled = []
        self._live = live

    def live_count(self):
        return self._live

    def scale_to(self, n):
        self.scaled.append(n)
        self._live = n
        return n


class _StubEngine:
    def __init__(self):
        self.current = {}

    def states(self):
        return dict(self.current)


def make_autoscaler(**kw):
    sup = _StubSupervisor(live=kw.pop("live", 1))
    engine = _StubEngine()
    clock = {"t": 0.0}
    scaler = Autoscaler(
        sup, engine,
        min_replicas=1, max_replicas=4, interval_s=1.0,
        cooldown_s=10.0, step_up=1, ok_streak=3,
        per_replica_inflight=8, clock=lambda: clock["t"],
        **kw,
    )
    return scaler, sup, engine, clock


class TestAutoscaler:
    def test_page_scales_up_by_two_steps(self):
        scaler, sup, engine, _ = make_autoscaler()
        engine.current = {"router.latency": "page"}
        decision = scaler.evaluate_once()
        assert decision["moved"]
        assert scaler.target == 3
        assert sup.scaled == [3]
        # admission limit widened BEFORE the scale-up call
        assert sup.router.limits[-1] == 3 * 8

    def test_warning_scales_up_by_one(self):
        scaler, sup, engine, _ = make_autoscaler()
        engine.current = {"router.errors": "warning"}
        scaler.evaluate_once()
        assert scaler.target == 2

    def test_cooldown_blocks_consecutive_moves(self):
        scaler, sup, engine, clock = make_autoscaler()
        engine.current = {"router.latency": "page"}
        scaler.evaluate_once()
        clock["t"] = 5.0  # inside the 10s cooldown
        decision = scaler.evaluate_once()
        assert not decision["moved"] and decision["in_cooldown"]
        assert scaler.target == 3
        clock["t"] = 11.0  # past it
        assert scaler.evaluate_once()["moved"]
        assert scaler.target == 4  # clamped at max next time

    def test_clamped_at_max(self):
        scaler, _, engine, clock = make_autoscaler(live=4)
        engine.current = {"router.latency": "page"}
        decision = scaler.evaluate_once()
        assert not decision["moved"]
        assert scaler.target == 4

    def test_ok_streak_scales_down_one(self):
        scaler, sup, engine, clock = make_autoscaler(live=3)
        engine.current = {"router.latency": "ok"}
        for i in range(3):
            clock["t"] = float(i)
            decision = scaler.evaluate_once()
        assert decision["moved"]
        assert scaler.target == 2
        # scale-down narrows admission AFTER draining the replica
        assert sup.router.limits[-1] == 2 * 8
        # streak resets: the next two clean evals do not move again
        clock["t"] = 20.0
        assert not scaler.evaluate_once()["moved"]

    def test_floor_respected(self):
        scaler, _, engine, clock = make_autoscaler(live=1)
        engine.current = {}
        for i in range(10):
            clock["t"] = float(i * 20)
            scaler.evaluate_once()
        assert scaler.target == 1

    def test_env_knobs(self, monkeypatch):
        monkeypatch.setenv("SPARKDL_AUTOSCALE_MIN", "2")
        monkeypatch.setenv("SPARKDL_AUTOSCALE_MAX", "6")
        monkeypatch.setenv("SPARKDL_AUTOSCALE_INFLIGHT", "16")
        sup = _StubSupervisor(live=2)
        scaler = Autoscaler(sup, _StubEngine())
        assert scaler.min_replicas == 2
        assert scaler.max_replicas == 6
        assert scaler.per_replica_inflight == 16

    def test_rejects_inverted_bounds(self):
        with pytest.raises(ValueError):
            Autoscaler(
                _StubSupervisor(), _StubEngine(),
                min_replicas=5, max_replicas=2,
            )


# ----------------------------------------------------------------------
# known-sites registry
# ----------------------------------------------------------------------
def test_known_sites_registry_lists_replica_plane():
    sites = inject.known_sites()
    for site in (
        "supervisor.spawn", "supervisor.health", "supervisor.restart",
        "supervisor.replica_warm", "supervisor.replica_serve",
        "router.route",
    ):
        assert site in sites
    assert sites == tuple(sorted(sites))
