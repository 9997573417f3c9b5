"""The port's byzantine-wire hardening, on the cases of the JAX package's
``tests/test_faultnet.py``.

The centerpiece is the network kill matrix
(:class:`TestNetworkKillMatrix`): a router over one replica reachable
two ways — through a :class:`faultnet.FaultProxy` injecting a byte- or
timing-level fault on *every* reply frame, and directly as the clean
survivor — must serve every request with the **correct tensor value**
(asserted by comparison, never just "no exception"): zero accepted
loss, zero silently-wrong answers.  Corrupt-body frames must be caught
by the CRC trailer specifically (``wire.crc_fail`` moves), not by
luck of the unpickler.  The shm-ring lane gets the same treatment via
the encode-side tx tap (:func:`test_shm_lane_corrupt_frame_retries`).

Around the matrix: unit coverage for the ``faultnet.request`` /
``faultnet.reply`` message-level sites on :class:`FaultyTransport`,
the hedged-request trigger (:meth:`Router._hedge_delay_s` gating),
the retry-budget token bucket (amplification cap), and end-to-end
deadline enforcement down to the replica's shed-at-the-door check.
"""

import socket
import threading
import time

import numpy as np
import pytest

from sparkdl_tpu_torch.resilience import inject
from sparkdl_tpu_torch.resilience.errors import is_transient
from sparkdl_tpu_torch.serving import ModelServer, ServingConfig, faultnet, wire
from sparkdl_tpu_torch.serving import transport
from sparkdl_tpu_torch.serving.errors import DeadlineExceeded
from sparkdl_tpu_torch.serving.faultnet import FaultProxy, FaultyTransport
from sparkdl_tpu_torch.serving.replica import ReplicaService
from sparkdl_tpu_torch.serving.router import Router, _RetryBudget
from sparkdl_tpu_torch.utils.metrics import metrics


def plain_service():
    """In-process ReplicaService around a compile=False doubler."""
    server = ModelServer(ServingConfig(
        max_batch=8, max_wait_ms=1.0, queue_capacity=64,
    ), device="cpu")
    server.register(
        "ep0", lambda x: x * 2.0, item_shape=(4,),
        compile=False,
    )
    return ReplicaService(server).start()


# ----------------------------------------------------------------------
# FaultyTransport: the message-level Transport seam
# ----------------------------------------------------------------------
class _StubInner(transport.Transport):
    lane = "stub"

    def __init__(self):
        self.calls = 0
        self.closed = False

    def request(self, msg, timeout_s):
        self.calls += 1
        return {"ok": True, "result": np.asarray(msg["value"]) * 2.0}

    def close(self):
        self.closed = True


class TestFaultyTransport:
    def _roundtrip(self, t):
        return t.request(
            {"op": "infer", "value": np.ones(4, np.float32)}, 1.0
        )

    def test_no_plan_is_passthrough(self):
        inner = _StubInner()
        t = FaultyTransport(inner)
        reply = self._roundtrip(t)
        np.testing.assert_array_equal(reply["result"], 2.0 * np.ones(4))
        assert t.lane == "stub"
        t.close()
        assert inner.closed

    def test_request_site_latency(self):
        plan = inject.FaultPlan().add(
            "faultnet.request", stall_s=0.15, at=1
        )
        before = metrics.counter("faultnet.injected").value
        with inject.active_plan(plan):
            t0 = time.monotonic()
            reply = self._roundtrip(FaultyTransport(_StubInner()))
        assert time.monotonic() - t0 >= 0.15
        assert reply["ok"]
        assert metrics.counter("faultnet.injected").value == before + 1

    def test_request_site_typed_error(self):
        plan = inject.FaultPlan().add(
            "faultnet.request", error="transient", at=1
        )
        with inject.active_plan(plan):
            with pytest.raises(inject.InjectedTransientError) as ei:
                self._roundtrip(FaultyTransport(_StubInner()))
        assert is_transient(ei.value)

    def test_request_site_disconnect(self):
        plan = inject.FaultPlan().add(
            "faultnet.request", act="disconnect", at=1
        )
        inner = _StubInner()
        with inject.active_plan(plan):
            with pytest.raises(ConnectionError):
                self._roundtrip(FaultyTransport(inner))
        assert inner.calls == 0  # dropped before the wire

    def test_reply_site_drop_is_slow_backend_shaped(self):
        # the replica answered — the caller just never hears it: the
        # exact shape a hedged request exists to rescue
        plan = inject.FaultPlan().add(
            "faultnet.reply", act="drop_reply", at=1
        )
        inner = _StubInner()
        with inject.active_plan(plan):
            with pytest.raises(socket.timeout):
                self._roundtrip(FaultyTransport(inner))
        assert inner.calls == 1

    def test_make_transport_wraps_under_env(self, monkeypatch):
        monkeypatch.setenv("SPARKDL_FAULTNET", "1")
        t = transport.make_transport("127.0.0.1", 1, ("tcp",))
        try:
            assert isinstance(t, FaultyTransport)
        finally:
            t.close()


# ----------------------------------------------------------------------
# retry budget: the amplification cap
# ----------------------------------------------------------------------
class TestRetryBudget:
    def test_spend_drains_then_denies(self):
        b = _RetryBudget(ratio=0.5, burst=2)
        denied = metrics.counter("router.retry_budget.denied").value
        assert b.spend() and b.spend()
        assert not b.spend()
        assert metrics.counter(
            "router.retry_budget.denied"
        ).value == denied + 1

    def test_earn_is_capped_at_burst(self):
        b = _RetryBudget(ratio=10.0, burst=3)
        for _ in range(5):
            b.earn()
        assert [b.spend() for _ in range(4)] == [True] * 3 + [False]

    def test_ratio_bounds_steady_state_amplification(self):
        b = _RetryBudget(ratio=0.5, burst=10)
        while b.spend():  # burn the one-off burst
            pass
        for _ in range(8):  # 8 admitted requests earn 4 tokens
            b.earn()
        spent = sum(1 for _ in range(8) if b.spend())
        assert spent == 4  # <= 1.5x attempts per request, by arithmetic

    def test_exhausted_budget_degrades_into_last_typed_error(self):
        svc = plain_service()
        port = svc.port
        svc.close()  # both registered backends now refuse connections
        attempts = metrics.counter("router.attempts").value
        with Router(
            retry_budget_ratio=0.0, retry_budget_burst=0.0,
            connect_timeout_s=0.2,
        ) as router:
            router.add("dead-a", "127.0.0.1", port)
            router.add("dead-b", "127.0.0.1", port)
            with pytest.raises((ConnectionError, OSError)):
                router.route(np.ones(4, np.float32), model_id="ep0")
        # one attempt, then the budget denies the retry: no storm
        assert metrics.counter("router.attempts").value == attempts + 1


# ----------------------------------------------------------------------
# hedge trigger gating
# ----------------------------------------------------------------------
class TestHedgeTrigger:
    def _warm(self, router, ms=10.0, n=50):
        for _ in range(n):
            router._observe_attempt_ms(ms)

    def test_no_hedge_when_disabled(self):
        with Router(hedge=False) as router:
            router.add("a", "127.0.0.1", 1)
            router.add("b", "127.0.0.1", 2)
            self._warm(router)
            assert router._hedge_delay_s(time.monotonic() + 10) is None

    def test_no_hedge_below_two_backends(self):
        with Router(hedge=True) as router:
            router.add("a", "127.0.0.1", 1)
            self._warm(router)
            assert router._hedge_delay_s(time.monotonic() + 10) is None

    def test_no_hedge_while_cold(self):
        with Router(hedge=True) as router:
            router.add("a", "127.0.0.1", 1)
            router.add("b", "127.0.0.1", 2)
            self._warm(router, n=5)  # below the warmup window
            assert router._hedge_delay_s(time.monotonic() + 10) is None

    def test_no_hedge_past_deadline(self):
        with Router(hedge=True) as router:
            router.add("a", "127.0.0.1", 1)
            router.add("b", "127.0.0.1", 2)
            self._warm(router)
            assert router._hedge_delay_s(time.monotonic() - 1) is None

    def test_warm_delay_is_quantile_with_floor(self):
        with Router(hedge=True) as router:
            router.add("a", "127.0.0.1", 1)
            router.add("b", "127.0.0.1", 2)
            self._warm(router, ms=40.0)
            delay = router._hedge_delay_s(time.monotonic() + 10)
            assert delay == pytest.approx(0.040, rel=0.05)
            # the floor: a uniformly-2ms window still waits >= min_ms
            self._warm(router, ms=2.0, n=300)
            delay = router._hedge_delay_s(time.monotonic() + 10)
            assert delay == pytest.approx(
                router._hedge_min_ms / 1000.0, rel=0.05
            )

    def test_delay_never_exceeds_half_the_remaining_budget(self):
        with Router(hedge=True) as router:
            router.add("a", "127.0.0.1", 1)
            router.add("b", "127.0.0.1", 2)
            self._warm(router, ms=500.0)
            delay = router._hedge_delay_s(time.monotonic() + 0.2)
            assert delay is not None and delay <= 0.1 + 0.01


# ----------------------------------------------------------------------
# end-to-end deadline enforcement
# ----------------------------------------------------------------------
class TestDeadlineEnforcement:
    def test_expired_deadline_is_typed_in_router(self):
        expired = metrics.counter("router.deadline_expired").value
        with Router() as router:
            with pytest.raises(DeadlineExceeded):
                router.route(
                    np.ones(4, np.float32), model_id="ep0",
                    deadline_ms=0.0,
                )
        assert metrics.counter(
            "router.deadline_expired"
        ).value == expired + 1

    def test_replica_sheds_work_that_arrives_expired(self):
        # the router ships *remaining* milliseconds; non-positive means
        # the answer can no longer matter — the replica must shed at
        # the door instead of burning a batch slot
        svc = plain_service()
        shed = metrics.counter("replica.expired_shed").value
        t = transport.TcpTransport("127.0.0.1", svc.port)
        try:
            reply = t.request(
                {"op": "infer", "model_id": "ep0",
                 "value": np.ones(4, np.float32), "deadline_ms": -5.0},
                5.0,
            )
            assert reply["ok"] is False
            assert isinstance(wire.decode_error(reply), DeadlineExceeded)
            assert metrics.counter(
                "replica.expired_shed"
            ).value == shed + 1
        finally:
            t.close()
            svc.close()

    def test_deadline_beats_a_stalled_socket(self):
        # one backend, stalled mid-reply far past the deadline: the
        # caller gets a typed DeadlineExceeded at ~deadline, not a hang
        svc = plain_service()
        proxy = FaultProxy("127.0.0.1", svc.port)
        plan = inject.FaultPlan().add(
            "faultnet.reply", stall_s=30.0, p=1.0
        )
        try:
            with Router() as router:
                router.add("stalled", "127.0.0.1", proxy.port)
                t0 = time.monotonic()
                with inject.active_plan(plan):
                    with pytest.raises(DeadlineExceeded):
                        router.route(
                            np.ones(4, np.float32), model_id="ep0",
                            deadline_ms=500.0,
                        )
                assert time.monotonic() - t0 < 5.0
        finally:
            proxy.close()
            svc.close()


# ----------------------------------------------------------------------
# the network kill matrix: every fault, zero loss, zero wrong answers
# ----------------------------------------------------------------------
class TestNetworkKillMatrix:
    #: (fault name, rule kwargs applied to EVERY reply frame through
    #: the proxy, whether the CRC trailer must be what catches it)
    MATRIX = [
        ("corrupt_body", dict(act="corrupt_body", p=1.0), True),
        ("corrupt_header", dict(act="corrupt_header", p=1.0), False),
        ("duplicate_reply", dict(act="dup", p=1.0), False),
        ("midframe_disconnect",
         dict(act="midframe_disconnect", p=1.0), False),
        ("stall", dict(stall_s=0.6, p=1.0), False),
    ]

    @pytest.mark.parametrize(
        "name,rule_kw,crc_expected",
        MATRIX, ids=[m[0] for m in MATRIX],
    )
    def test_fault_sweep_zero_accepted_loss(self, name, rule_kw,
                                            crc_expected):
        svc = plain_service()
        proxy = FaultProxy("127.0.0.1", svc.port)
        plan = inject.FaultPlan().add("faultnet.reply", **rule_kw)
        crc_before = metrics.counter("wire.crc_fail").value
        injected_before = metrics.counter("faultnet.injected").value
        try:
            with Router(hedge=False) as router:
                # registration order is the idle tie-break: every
                # request is PLACED on the faulty path first and must
                # survive via typed detection + retry on the clean one
                router.add("faulty", "127.0.0.1", proxy.port)
                router.add("clean", "127.0.0.1", svc.port)
                with inject.active_plan(plan):
                    for i in range(1, 7):
                        x = np.full(4, float(i), np.float32)
                        out = router.route(
                            x, model_id="ep0", timeout_s=10.0
                        )
                        np.testing.assert_array_equal(
                            np.asarray(out), x * 2.0
                        )
        finally:
            proxy.close()
            svc.close()
        assert metrics.counter(
            "faultnet.injected"
        ).value > injected_before
        crc_delta = metrics.counter("wire.crc_fail").value - crc_before
        if crc_expected:
            # a flipped tensor byte passes every structural check; only
            # the CRC trailer stands between it and a wrong answer
            assert crc_delta > 0

    def test_shm_lane_corrupt_frame_retries(self):
        # same contract on the shared-memory ring, corrupted at the
        # encode-side tap (covers ring writes and the spill lane alike)
        svc_a, svc_b = plain_service(), plain_service()
        crc_before = metrics.counter("wire.crc_fail").value
        plan = inject.FaultPlan().add(
            "faultnet.tx", act="corrupt_body", at=4, times=1
        )
        try:
            with Router() as router:
                router.add("a", "127.0.0.1", svc_a.port,
                           lanes=("shm", "tcp"))
                router.add("b", "127.0.0.1", svc_b.port,
                           lanes=("shm", "tcp"))
                with inject.active_plan(plan):
                    assert faultnet.arm()
                    try:
                        for i in range(1, 9):
                            x = np.full(4, float(i), np.float32)
                            out = router.route(
                                x, model_id="ep0", timeout_s=10.0
                            )
                            np.testing.assert_array_equal(
                                np.asarray(out), x * 2.0
                            )
                    finally:
                        faultnet.disarm()
                assert plan.count("faultnet.tx") >= 4
        finally:
            svc_a.close()
            svc_b.close()
        assert metrics.counter("wire.crc_fail").value > crc_before


# ----------------------------------------------------------------------
# hedged requests: the tail-latency rescue, measured
# ----------------------------------------------------------------------
class TestHedging:
    def test_hedge_rescues_a_stalled_backend(self, monkeypatch):
        # "slow" is registered first, so every idle-tie placement lands
        # on it; its replies stall 0.5s at the proxy.  A warm router
        # must fire a hedge at ~min_ms and let the clean backend win —
        # the caller never waits out the stall.
        monkeypatch.setenv("SPARKDL_HEDGE_MIN_MS", "10")
        monkeypatch.setenv("SPARKDL_HEDGE_QUANTILE", "0.5")
        svc = plain_service()
        proxy = FaultProxy("127.0.0.1", svc.port)
        plan = inject.FaultPlan().add(
            "faultnet.reply", stall_s=0.5, p=1.0
        )
        fired = metrics.counter("router.hedge.fired").value
        wins = metrics.counter("router.hedge.wins").value
        try:
            with Router(hedge=True) as router:
                router.add("slow", "127.0.0.1", proxy.port)
                router.add("fast", "127.0.0.1", svc.port)
                for _ in range(50):  # a warm, all-fast sample window
                    router._observe_attempt_ms(2.0)
                with inject.active_plan(plan):
                    elapsed = []
                    for i in range(1, 7):
                        x = np.full(4, float(i), np.float32)
                        t0 = time.monotonic()
                        out = router.route(
                            x, model_id="ep0", timeout_s=10.0
                        )
                        elapsed.append(time.monotonic() - t0)
                        np.testing.assert_array_equal(
                            np.asarray(out), x * 2.0
                        )
                # no caller waited out the 0.5s stall
                assert max(elapsed) < 0.45, elapsed
        finally:
            proxy.close()
            svc.close()
        assert metrics.counter("router.hedge.fired").value > fired
        assert metrics.counter("router.hedge.wins").value > wins

    def test_hedge_off_router_never_hedges(self):
        svc = plain_service()
        fired = metrics.counter("router.hedge.fired").value
        try:
            with Router(hedge=False) as router:
                router.add("a", "127.0.0.1", svc.port)
                router.add("b", "127.0.0.1", svc.port)
                for _ in range(50):
                    router._observe_attempt_ms(2.0)
                for _ in range(4):
                    out = router.route(
                        np.ones(4, np.float32), model_id="ep0"
                    )
                    np.testing.assert_array_equal(np.asarray(out), 2.0)
        finally:
            svc.close()
        assert metrics.counter("router.hedge.fired").value == fired

    def test_hedge_spends_retry_budget(self, monkeypatch):
        # a hedge IS amplification: with an empty budget the trigger
        # must decline rather than double the brownout
        monkeypatch.setenv("SPARKDL_HEDGE_MIN_MS", "10")
        monkeypatch.setenv("SPARKDL_HEDGE_QUANTILE", "0.5")
        svc = plain_service()
        proxy = FaultProxy("127.0.0.1", svc.port)
        plan = inject.FaultPlan().add(
            "faultnet.reply", stall_s=0.4, p=1.0
        )
        fired = metrics.counter("router.hedge.fired").value
        try:
            with Router(
                hedge=True, retry_budget_ratio=0.0,
                retry_budget_burst=0.0,
            ) as router:
                router.add("slow", "127.0.0.1", proxy.port)
                router.add("fast", "127.0.0.1", svc.port)
                for _ in range(50):
                    router._observe_attempt_ms(2.0)
                with inject.active_plan(plan):
                    x = np.ones(4, np.float32)
                    t0 = time.monotonic()
                    out = router.route(x, model_id="ep0", timeout_s=10.0)
                    waited = time.monotonic() - t0
                np.testing.assert_array_equal(np.asarray(out), x * 2.0)
                assert waited >= 0.4  # rode out the stall: no hedge
        finally:
            proxy.close()
            svc.close()
        assert metrics.counter("router.hedge.fired").value == fired
