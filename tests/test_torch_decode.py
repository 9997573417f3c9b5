"""The port's continuous-batching decode plane against the JAX package's.

The slot pool (rows zeroed on release, mid-flight reuse), the decode
endpoint (streamed output equal to the one-shot replay, eos, deadline and
disconnect eviction, the ``decode.step`` and ``decode.stream`` fault sites),
ported from ``tests/test_decode.py`` with a torch step over the pool's
carries. The streams are held to the closed form of the JAX package's
``demo_server_decode`` step (carry ``[acc, step]``: each step emits the
pre-step ``acc`` and adds 1, so a prompt summing to ``s`` streams ``s, s+1,
...``) and to that JAX endpoint's own streams. A compiled step runs through
the engine with its compile swapped for ``torch.export`` alone
(``ExportOnly`` of ``tests/torch_fixtures/engine_fixtures.py``). The replica plane's wire,
router and kill-matrix cases wait for it (ROADMAP item 10b).
"""

import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

from sparkdl_tpu.serving.replica import demo_server_decode
from sparkdl_tpu_torch.engine.slots import SlotPool, slot_block_fingerprint
from sparkdl_tpu_torch.resilience import inject
from sparkdl_tpu_torch.resilience.errors import TransientError, is_transient
from sparkdl_tpu_torch.serving import ModelServer, ServingConfig
from sparkdl_tpu_torch.serving.admission import TenantPolicy
from sparkdl_tpu_torch.serving.decode import ClientGone, DecodeEndpoint
from sparkdl_tpu_torch.serving.errors import DeadlineExceeded, ServerClosed, TenantThrottled
from sparkdl_tpu_torch.utils.metrics import metrics

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_fixtures"))
from engine_fixtures import ExportOnly  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def clean_slate(monkeypatch):
    monkeypatch.setenv("SPARKDL_COMPILE_CACHE", "off")
    metrics.reset()
    yield
    metrics.reset()


def counting_step(step_s: float = 0.0):
    """carry [acc, step] -> emit the pre-step acc, add 1 to both."""

    def step_fn(carries):
        if step_s > 0.0:
            time.sleep(step_s)
        return carries + 1.0, carries[:, 0].clone()

    return step_fn


def sum_init(prompt):
    return np.asarray([float(np.asarray(prompt, np.float64).sum()), 0.0], np.float32)


def make_endpoint(**kw):
    defaults = dict(max_steps=16, n_slots=4, compile=False, step_s=0.0)
    defaults.update(kw)
    step_s = defaults.pop("step_s")
    return DecodeEndpoint("dec", counting_step(step_s), sum_init, **defaults)


def expected_tokens(prompt_sum: float, steps: int):
    return [float(prompt_sum + i) for i in range(steps)]


@pytest.fixture(scope="module")
def jax_server():
    server = demo_server_decode(endpoints=1)
    yield server
    server.close()


class TestSlotPool:
    def test_acquire_binds_shape_release_zeroes(self):
        pool = SlotPool(3)
        s0 = pool.acquire("r0", np.asarray([5.0, 1.0], np.float32))
        assert s0 is not None and s0.index == 0
        assert pool.carry_shape == (2,)
        assert pool.n_free == 2 and pool.n_occupied == 1
        np.testing.assert_array_equal(
            pool.carries()[0], [5.0, 1.0]
        )
        pool.release(s0)
        # no state carryover: the freed row is zeroed, not stale
        np.testing.assert_array_equal(pool.carries()[0], [0.0, 0.0])
        assert pool.n_free == 3

    def test_mismatched_carry_shape_rejected(self):
        pool = SlotPool(2)
        pool.acquire("r0", np.zeros(2, np.float32))
        with pytest.raises(ValueError, match="one pool serves one"):
            pool.acquire("r1", np.zeros(3, np.float32))

    def test_release_all_returns_occupants(self):
        pool = SlotPool(2)
        pool.acquire("a", np.zeros(2, np.float32))
        pool.acquire("b", np.zeros(2, np.float32))
        evicted = pool.release_all()
        assert [s.request for s in evicted] == ["a", "b"]
        assert pool.n_occupied == 0
        np.testing.assert_array_equal(
            pool.carries(), np.zeros((2, 2), np.float32)
        )

    def test_freed_slot_is_reused_mid_flight(self):
        pool = SlotPool(2)
        a = pool.acquire("a", np.ones(2, np.float32))
        pool.acquire("b", np.ones(2, np.float32))
        assert pool.acquire("c", np.ones(2, np.float32)) is None
        pool.release(a)
        c = pool.acquire("c", np.full(2, 7.0, np.float32))
        assert c is not None and c.index == a.index
        np.testing.assert_array_equal(pool.carries()[c.index], 7.0)

    def test_mask_tracks_occupancy_by_index(self):
        pool = SlotPool(3)
        a = pool.acquire("a", np.zeros(2, np.float32))
        pool.acquire("b", np.zeros(2, np.float32))
        np.testing.assert_array_equal(
            pool.mask(), [True, True, False]
        )
        pool.release(a)
        np.testing.assert_array_equal(
            pool.mask(), [False, True, False]
        )
        assert pool.mask().dtype == bool


# ----------------------------------------------------------------------
# endpoint: streaming semantics
# ----------------------------------------------------------------------
class TestDecodeEndpoint:
    def test_stream_and_result_byte_identical(self):
        ep = make_endpoint()
        try:
            frames = []
            req = ep.submit([2.0, 1.0], emit=frames.append, max_steps=6)
            result = req.future.result(timeout=10)
            streamed = [f for f in frames if not f["final"]]
            final = [f for f in frames if f["final"]]
            # gap-free 0-based stream_seq, exactly one final frame
            assert [f["stream_seq"] for f in streamed] == list(range(6))
            assert len(final) == 1 and final[0]["stream_seq"] == 6
            np.testing.assert_array_equal(
                np.stack([f["result"] for f in streamed]), result
            )
            # the one-shot replay of the same prompt is byte-identical
            np.testing.assert_array_equal(
                ep.decode([2.0, 1.0], max_steps=6, timeout=10), result
            )
            assert result.tolist() == expected_tokens(3.0, 6)
        finally:
            ep.close()
        assert ep.slots.n_occupied == 0

    def test_eos_stops_stream_early(self):
        ep = DecodeEndpoint(
            "dec", counting_step(), sum_init, max_steps=50,
            eos_fn=lambda tok, step: float(tok) >= 4.0,
            n_slots=2, compile=False,
        )
        try:
            out = ep.decode([2.0], timeout=10)
            assert out.tolist() == [2.0, 3.0, 4.0]
        finally:
            ep.close()

    def test_max_steps_clamped_to_endpoint_cap(self):
        ep = make_endpoint(max_steps=4)
        try:
            out = ep.decode([1.0], max_steps=99, timeout=10)
            assert out.tolist() == expected_tokens(1.0, 4)
        finally:
            ep.close()

    def test_continuous_admission_short_not_stuck_behind_long(self):
        """THE acceptance property: with a long decode occupying one
        slot, a short request admitted later completes while the long
        one is still mid-flight — no barrier on the slowest sequence."""
        ep = make_endpoint(n_slots=2, max_steps=400, step_s=0.005)
        try:
            long_req = ep.submit([0.0], max_steps=400)
            short = ep.decode([1.0], max_steps=3, timeout=30)
            assert short.tolist() == expected_tokens(1.0, 3)
            assert not long_req.future.done(), (
                "short stream should finish while the long decode is "
                "still running"
            )
            long_req.cancelled.set()  # don't burn 400 steps of teardown
        finally:
            ep.close()

    def test_admission_into_freed_slot_mid_flight(self):
        """More queued streams than slots: the (n_slots+1)-th stream is
        admitted into a freed slot while others still decode."""
        ep = make_endpoint(n_slots=2, max_steps=64, step_s=0.002)
        try:
            reqs = [
                ep.submit([float(i)], max_steps=4 + 4 * i)
                for i in range(5)
            ]
            outs = [r.future.result(timeout=30) for r in reqs]
            for i, out in enumerate(outs):
                assert out.tolist() == expected_tokens(float(i), 4 + 4 * i)
        finally:
            ep.close()
        assert ep.slots.n_occupied == 0

    def test_deadline_expiry_mid_stream_evicts_typed(self):
        ep = make_endpoint(n_slots=1, max_steps=10_000, step_s=0.01)
        try:
            req = ep.submit([1.0], deadline_ms=60.0)
            with pytest.raises(DeadlineExceeded):
                req.future.result(timeout=30)
            deadline = time.monotonic() + 5
            while ep.slots.n_occupied and time.monotonic() < deadline:
                time.sleep(0.01)
            assert ep.slots.n_occupied == 0, "expired stream leaked its slot"
            # the endpoint still serves after the eviction
            assert ep.decode([2.0], max_steps=2, timeout=10).tolist() == [
                2.0, 3.0,
            ]
        finally:
            ep.close()

    def test_client_disconnect_evicts_slot(self):
        """emit returning False = client gone: the stream fails with
        ``ClientGone``, the slot frees immediately (no more device
        steps burned), and the pool keeps serving others."""
        ep = make_endpoint(n_slots=1, max_steps=1000, step_s=0.002)
        try:
            seen = []

            def flaky_emit(frame):
                seen.append(frame)
                return len(seen) < 3  # hang up after 3 frames

            req = ep.submit([5.0], emit=flaky_emit)
            with pytest.raises(ClientGone):
                req.future.result(timeout=30)
            assert metrics.counter("decode.evicted_disconnect").value == 1
            deadline = time.monotonic() + 5
            while ep.slots.n_occupied and time.monotonic() < deadline:
                time.sleep(0.01)
            assert ep.slots.n_occupied == 0
            assert metrics.gauge("decode.slots_occupied").value == 0
            # the freed slot serves the next stream with clean state
            assert ep.decode([9.0], max_steps=2, timeout=10).tolist() == [
                9.0, 10.0,
            ]
        finally:
            ep.close()

    def test_emit_raising_is_disconnect_too(self):
        ep = make_endpoint(n_slots=1, max_steps=100)
        try:
            def dead_emit(frame):
                raise ConnectionError("peer reset")

            req = ep.submit([1.0], emit=dead_emit)
            with pytest.raises(ClientGone):
                req.future.result(timeout=30)
        finally:
            ep.close()

    def test_cancel_before_admission_never_burns_a_slot(self):
        ep = make_endpoint(n_slots=1, max_steps=500, step_s=0.005)
        try:
            blocker = ep.submit([0.0], max_steps=500)
            victim = ep.submit([1.0], max_steps=500)
            victim.cancelled.set()  # client gone while still queued
            with pytest.raises(ClientGone):
                victim.future.result(timeout=30)
            blocker.cancelled.set()
        finally:
            ep.close()

    def test_failed_fused_step_fails_all_streams_typed(self):
        calls = {"n": 0}

        def exploding_step(carries):
            calls["n"] += 1
            if calls["n"] >= 3:
                raise TransientError("device poked")
            tokens = np.array(carries[:, 0], copy=True)
            return carries + 1.0, tokens

        ep = DecodeEndpoint(
            "dec", exploding_step, sum_init, max_steps=50,
            n_slots=4, compile=False,
        )
        try:
            reqs = [ep.submit([float(i)], max_steps=50) for i in range(3)]
            for req in reqs:
                with pytest.raises(TransientError):
                    req.future.result(timeout=30)
            assert ep.slots.n_occupied == 0
            assert metrics.counter("decode.errors").value == 3
        finally:
            ep.close()

    def test_drain_finishes_inflight_rejects_new(self):
        ep = make_endpoint(n_slots=2, max_steps=200, step_s=0.002)
        try:
            got_token = threading.Event()

            def emit(frame):
                got_token.set()
                return True

            req = ep.submit([1.0], max_steps=20, emit=emit)
            assert got_token.wait(timeout=10), "stream never admitted"
            assert ep.drain(timeout_s=30)
            assert req.future.result(timeout=1).tolist() == (
                expected_tokens(1.0, 20)
            )
            with pytest.raises(ServerClosed):
                ep.submit([2.0])
        finally:
            ep.close()

    def test_close_fails_queued_and_inflight(self):
        ep = make_endpoint(n_slots=1, max_steps=10_000, step_s=0.01)
        inflight = ep.submit([0.0])
        queued = ep.submit([1.0])
        ep.close()
        for req in (inflight, queued):
            with pytest.raises(ServerClosed):
                req.future.result(timeout=10)
        assert ep.slots.n_occupied == 0


# ----------------------------------------------------------------------
# fault sites (fault-site-coverage: decode.step / decode.stream)
# ----------------------------------------------------------------------
class TestDecodeFaultSites:
    def test_decode_step_fault_fails_stream_typed(self):
        plan = inject.FaultPlan().add(
            "decode.step", error="transient", at=2,
        )
        ep = make_endpoint(n_slots=2, max_steps=50)
        try:
            with inject.active_plan(plan):
                req = ep.submit([1.0], max_steps=50)
                with pytest.raises(TransientError):
                    req.future.result(timeout=30)
            assert plan.count("decode.step") >= 2
            assert ep.slots.n_occupied == 0
            # typed-transient by taxonomy: the router may re-place it
            exc = req.future.exception()
            assert is_transient(exc)
        finally:
            ep.close()

    def test_decode_stream_fault_evicts_as_disconnect(self):
        plan = inject.FaultPlan().add(
            "decode.stream", error="transient", at=3,
        )
        ep = make_endpoint(n_slots=1, max_steps=50)
        try:
            frames = []
            with inject.active_plan(plan):
                req = ep.submit(
                    [1.0], emit=frames.append, max_steps=50,
                )
                with pytest.raises(ClientGone):
                    req.future.result(timeout=30)
            # the frames delivered before the fault are intact
            assert [float(f["result"]) for f in frames] == [1.0, 2.0]
            assert ep.slots.n_occupied == 0
        finally:
            ep.close()




# ----------------------------------------------------------------------
# against the JAX package's decode endpoint
# ----------------------------------------------------------------------
@pytest.mark.parametrize("prompt,steps", [([2.0, 1.0], 6), ([0.5], 3), ([-4.0, 2.0, 1.0], 9)])
def test_streams_match_the_jax_demo_decode(jax_server, prompt, steps):
    want = np.asarray(jax_server.decode(prompt, model_id="dec0", max_steps=steps,
                                        timeout=30))
    ep = make_endpoint(max_steps=64)
    try:
        frames = []
        req = ep.submit(prompt, emit=frames.append, max_steps=steps)
        got = req.future.result(timeout=30)
    finally:
        ep.close()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        np.stack([f["result"] for f in frames if not f["final"]]), want)
    assert got.tolist() == expected_tokens(float(np.sum(prompt)), steps)


def test_sixteen_streams_admitted_mid_flight_into_eight_slots(jax_server):
    """More streams than slots, of different lengths: each is admitted into
    a freed slot while others decode, and each equals the JAX endpoint's
    stream of the same prompt."""
    server = ModelServer(device="cpu")
    server.register_decode("dec", counting_step(0.001), sum_init, max_steps=64, n_slots=8,
                           compile=False)
    try:
        reqs = [server.submit_decode([float(i)], max_steps=2 + i % 7) for i in range(16)]
        outs = [r.future.result(timeout=60) for r in reqs]
        assert max(metrics.histogram("decode.ttft_ms").values()) > 0
    finally:
        server.close()
    for i, out in enumerate(outs):
        want = jax_server.decode([float(i)], model_id="dec0", max_steps=2 + i % 7, timeout=30)
        np.testing.assert_array_equal(out, want)
    assert metrics.counter("decode.tokens").value == sum(2 + i % 7 for i in range(16))


@pytest.fixture
def export_only(monkeypatch):
    return ExportOnly.install(monkeypatch).compiled


def test_compiled_step_runs_through_the_engine(export_only, jax_server):
    """``compile=True``: one program for the pool shape, resolved through
    the process engine at warmup and reused by every step."""
    server = ModelServer(device="cpu")
    server.register_decode("dec", counting_step(), sum_init, max_steps=32, n_slots=4,
                           fingerprint="counting:v1")
    try:
        with pytest.raises(ValueError, match="example_prompt"):
            server._endpoint("dec").warmup()
        assert server._endpoint("dec").warmup(example_prompt=[1.0]) == "compile"
        outs = [server.decode([float(i)], max_steps=5, timeout=30) for i in range(3)]
    finally:
        server.close()
    assert len(export_only) == 1
    for i, out in enumerate(outs):
        np.testing.assert_array_equal(
            out, jax_server.decode([float(i)], model_id="dec0", max_steps=5, timeout=30))
    assert slot_block_fingerprint("counting:v1", "decode", 4) == "counting:v1:decode-slots-4"
    assert slot_block_fingerprint(None, "decode", 4) is None


def test_server_tenant_policy_reaches_decode_endpoints():
    """``ServingConfig.tenant_policy`` holds for a server's decode endpoints
    as for its one-shot ones: a tenant at its in-flight cap is throttled."""
    policy = TenantPolicy(inflight_cap=1)
    server = ModelServer(ServingConfig(tenant_policy=policy), device="cpu")
    server.register_decode("dec", counting_step(0.01), sum_init, max_steps=64, compile=False)
    try:
        first = server.submit_decode([1.0], tenant="a")
        with pytest.raises(TenantThrottled):
            server.submit_decode([2.0], tenant="a")
        second = server.submit_decode([3.0], tenant="b")
        assert first.future.result(timeout=30).tolist() == expected_tokens(1.0, 64)
        assert second.future.result(timeout=30).tolist() == expected_tokens(3.0, 64)
    finally:
        server.close()
    assert server._endpoint("dec")._queue.tenant_policy is policy


def test_decode_endpoint_errors_for_one_shot_ops():
    server = ModelServer(device="cpu")
    server.register("plain", lambda x: x * 2.0, item_shape=(2,), compile=False)
    server.register_decode("dec", counting_step(), sum_init, max_steps=4, compile=False)
    try:
        with pytest.raises(TypeError, match="register_decode"):
            server.decode([1.0], model_id="plain")
        assert server.warmup() == {"plain": (), "dec": ()}
        assert server.status()["endpoints"]["dec"]["kind"] == "decode"
    finally:
        server.close()
