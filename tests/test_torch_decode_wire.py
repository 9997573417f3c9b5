"""The port's decode plane over the replica plane, on the cases of the JAX
package's ``tests/test_decode.py`` that need the wire: the streaming path
on both lanes (gap-free ``KIND_STREAM`` frames, client-disconnect
eviction), the router's stream placement (backend pinning, retry only
before the first token, stitched ``decode.*`` spans), and the process-level
kill matrix on both lanes: a ``FaultPlan`` SIGKILL at ``decode.step``
mid-stream must surface as a typed or connection-shaped error, never
corrupt a completed stream, and leave no slot state behind. Streams are
held to the closed form of the demo step (a prompt summing to ``s``
streams ``s, s+1, ...``). Replicas are CPU processes built by
``tests/torch_fixtures/replica_factories.py``.
"""

import os
import socket
import sys
import threading
import time

import numpy as np
import pytest
import torch

from sparkdl_tpu_torch.obs.export import JsonlTraceSink
from sparkdl_tpu_torch.obs.trace import tracer
from sparkdl_tpu_torch.resilience.errors import is_transient
from sparkdl_tpu_torch.serving import ModelServer, wire
from sparkdl_tpu_torch.serving.errors import DeadlineExceeded
from sparkdl_tpu_torch.serving.replica import ReplicaService
from sparkdl_tpu_torch.serving.router import Router
from sparkdl_tpu_torch.serving.transport import ShmTransport, TcpTransport
from sparkdl_tpu_torch.utils.metrics import metrics

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_fixtures")
sys.path.insert(0, FIXTURES)
from replica_factories import spec as fixture_spec  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def clean_slate():
    tracer.disable()
    metrics.reset()
    yield
    tracer.disable()
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


def expected_tokens(prompt_sum: float, steps: int):
    return [float(prompt_sum + i) for i in range(steps)]


# ----------------------------------------------------------------------
# wire: KIND_STREAM over both lanes
# ----------------------------------------------------------------------
def decode_replica(n_slots=4, step_s=0.0):
    server = ModelServer(device="cpu")
    server.register_decode(
        "dec", counting_step(step_s), sum_init, max_steps=64,
        n_slots=n_slots, compile=False,
    )
    service = ReplicaService(server).start()
    return server, service


class TestDecodeWire:
    @pytest.mark.parametrize("transport_cls", [TcpTransport, ShmTransport])
    def test_stream_over_wire_matches_oneshot(self, transport_cls):
        server, service = decode_replica()
        t = transport_cls("127.0.0.1", service.port)
        try:
            frames = []
            final = t.stream(
                {"op": "decode", "model_id": "dec", "value": [2.0, 2.0],
                 "max_steps": 5},
                frames.append, timeout_s=30.0,
            )
            toks = [float(f["result"]) for f in frames]
            assert toks == expected_tokens(4.0, 5)
            assert [f["stream_seq"] for f in frames] == list(range(5))
            assert final["ok"] and final["final"]
            assert final["stream_seq"] == 5
            assert {"replica_queue", "decode"} <= set(final["phases"])
            # byte-identity against the in-process replay
            replay = server.decode([2.0, 2.0], max_steps=5)
            np.testing.assert_array_equal(np.asarray(toks), replay)
        finally:
            t.close()
            service.close()
            server.close()

    def test_typed_error_ends_stream_and_channel_survives(self):
        server, service = decode_replica()
        t = TcpTransport("127.0.0.1", service.port)
        try:
            with pytest.raises(Exception, match="no endpoint"):
                t.stream(
                    {"op": "decode", "model_id": "nope", "value": [1.0],
                     "max_steps": 2},
                    lambda f: None, timeout_s=30.0,
                )
            # the connection is still usable for the next stream
            final = t.stream(
                {"op": "decode", "model_id": "dec", "value": [1.0],
                 "max_steps": 2},
                lambda f: None, timeout_s=30.0,
            )
            assert final["ok"]
        finally:
            t.close()
            service.close()
            server.close()

    def test_expired_deadline_shed_before_decode(self):
        server, service = decode_replica()
        t = TcpTransport("127.0.0.1", service.port)
        try:
            with pytest.raises(DeadlineExceeded):
                t.stream(
                    {"op": "decode", "model_id": "dec", "value": [1.0],
                     "max_steps": 2, "deadline_ms": 0},
                    lambda f: None, timeout_s=30.0,
                )
            assert metrics.counter("replica.expired_shed").value == 1
        finally:
            t.close()
            service.close()
            server.close()

    def test_client_disconnect_over_wire_evicts_slot(self):
        """A raw client that hangs up mid-stream: the replica's next
        frame send fails, the slot evicts, and the pool serves the next
        stream — a gone client never wedges a device slot."""
        server, service = decode_replica(n_slots=1, step_s=0.005)
        try:
            sock = socket.create_connection(
                ("127.0.0.1", service.port), timeout=10,
            )
            wire.send_msg(sock, {
                "op": "decode", "model_id": "dec", "value": [1.0],
                "max_steps": 1000, "seq": 1,
            })
            kind, frame = wire.recv_any(sock)
            assert kind == wire.KIND_STREAM and not frame.get("final")
            sock.close()  # hang up mid-stream

            deadline = time.monotonic() + 15
            while (metrics.counter("decode.evicted_disconnect").value < 1
                   and time.monotonic() < deadline):
                time.sleep(0.02)
            assert metrics.counter("decode.evicted_disconnect").value == 1

            # the single slot is free again: a fresh stream completes
            t = TcpTransport("127.0.0.1", service.port)
            try:
                final = t.stream(
                    {"op": "decode", "model_id": "dec", "value": [3.0],
                     "max_steps": 3},
                    lambda f: None, timeout_s=30.0,
                )
                assert final["ok"] and final["stream_seq"] == 3
            finally:
                t.close()
            assert metrics.gauge("decode.slots_occupied").value == 0
        finally:
            service.close()
            server.close()


# ----------------------------------------------------------------------
# router: stream placement + stitched spans
# ----------------------------------------------------------------------
class TestDecodeRouter:
    def test_route_stream_end_to_end_with_stitched_spans(self):
        sink = JsonlTraceSink(capacity=4096)
        tracer.enable(sink)
        server, service = decode_replica()
        router = Router()
        router.add("r0", "127.0.0.1", service.port, lanes=("tcp",))
        try:
            frames = []
            reply = router.route_stream(
                [3.0], model_id="dec", on_frame=frames.append,
                max_steps=4,
            )
            assert reply["result"].tolist() == expected_tokens(3.0, 4)
            assert reply["steps"] == 4
            assert [float(f["result"]) for f in frames] == (
                expected_tokens(3.0, 4)
            )
            # one stitched trace: router.stream -> replica.serve ->
            # decode.request, with decode.steps groups alongside
            roots = sink.find("router.stream")
            assert len(roots) == 1
            trace_id = roots[0]["trace_id"]
            req_spans = []
            for name in ("replica.serve", "decode.request"):
                spans = [
                    s for s in sink.find(name)
                    if s["trace_id"] == trace_id
                ]
                assert spans, f"span {name} missing from stitched trace"
                req_spans.extend(spans)
            # the fused-step group spans live on the worker thread and
            # link back to the per-request spans via member_span_ids
            req_ids = {s["span_id"] for s in req_spans}
            linked = [
                s for s in sink.find("decode.steps")
                if req_ids & set(
                    s["attributes"].get("member_span_ids") or ()
                )
            ]
            assert linked, "no decode.steps group references this request"
        finally:
            router.close()
            service.close()
            server.close()

    def test_stream_retries_only_before_first_token(self):
        """A dead backend costs a retry, not a failure — but only
        because no frame was forwarded yet.  All streams land whole."""
        server, service = decode_replica()
        router = Router()
        router.add("dead", "127.0.0.1", 1, lanes=("tcp",))
        router.add("live", "127.0.0.1", service.port, lanes=("tcp",))
        try:
            for i in range(6):
                reply = router.route_stream(
                    [float(i)], model_id="dec", max_steps=3,
                )
                assert reply["result"].tolist() == (
                    expected_tokens(float(i), 3)
                )
        finally:
            router.close()
            service.close()
            server.close()

    def test_mid_stream_death_is_typed_never_spliced(self):
        """After the first forwarded frame, a dying backend must NOT be
        retried elsewhere (two half-streams can't be stitched): the
        caller gets the connection-shaped error itself."""

        class DiesAfterTwo:
            lane = "faulty"

            def stream(self, msg, on_frame, timeout_s):
                on_frame({"result": np.float32(1.0), "stream_seq": 0,
                          "final": False})
                on_frame({"result": np.float32(2.0), "stream_seq": 1,
                          "final": False})
                raise ConnectionError("replica died mid-stream")

            def request(self, msg, timeout_s):
                raise ConnectionError("one-shot not wired here")

            def close(self):
                pass

        router = Router()
        router.add("dying", "127.0.0.1", 1, transport=DiesAfterTwo())
        try:
            got = []
            with pytest.raises(ConnectionError, match="mid-stream"):
                router.route_stream(
                    [1.0], model_id="dec", on_frame=got.append,
                    max_steps=5,
                )
            assert len(got) == 2
            assert metrics.counter("router.retries").value == 0
        finally:
            router.close()

    def test_frontdoor_stream_restamps_client_seq(self):
        server, service = decode_replica()
        router = Router()
        router.add("r0", "127.0.0.1", service.port, lanes=("tcp",))
        port = router.serve()
        try:
            sock = socket.create_connection(("127.0.0.1", port), timeout=10)
            wire.send_msg(sock, {
                "op": "decode", "model_id": "dec", "value": [2.0],
                "max_steps": 3, "seq": 42,
            })
            toks, final = [], None
            while final is None:
                kind, frame = wire.recv_any(sock)
                assert kind == wire.KIND_STREAM
                assert frame["seq"] == 42
                if frame.get("final"):
                    final = frame
                else:
                    toks.append(float(frame["result"]))
            assert toks == expected_tokens(2.0, 3)
            assert final["ok"] and final["stream_seq"] == 3
            assert "frontdoor" in final["phases"]
            # one-shot ops still work on the same client connection
            wire.send_msg(sock, {"op": "ping"})
            assert wire.recv_msg(sock)["ok"]
            sock.close()
        finally:
            router.close()
            service.close()
            server.close()


# ----------------------------------------------------------------------
# kill matrix: SIGKILL mid-decode under mixed traffic
# ----------------------------------------------------------------------
class TestDecodeKillMatrix:
    @pytest.mark.parametrize("lane", ["tcp", "shm"])
    def test_kill_mid_decode_typed_failure_no_corruption(
        self, lane, monkeypatch
    ):
        """``FaultPlan`` kill at ``decode.step`` takes slot 0 out in
        the middle of its fused step, with one-shot and streaming
        traffic interleaved.  Contract under fire:

        - one-shot traffic loses nothing (stranded requests fail over);
        - every stream that *returned* is byte-correct — tokens are
          exactly ``s, s+1, ...`` from its prompt sum, never a splice
          of two replicas;
        - interrupted streams fail TYPED (connection-shaped/transient),
          never silently truncated;
        - the supervisor restarts the slot and a burst of sequential
          post-recovery streams proves no slot leaked.
        """
        from test_torch_supervisor import fast_supervisor, wait_until

        monkeypatch.setenv("SPARKDL_WIRE_TRANSPORT", lane)
        monkeypatch.setenv("SPARKDL_DEMO_STEP_MS", "4")
        sup = fast_supervisor(
            replicas=2,
            spec=fixture_spec("demo_server_decode"),
            fault_plans={0: [{
                "site": "decode.step", "kill": True, "at": 60,
            }]},
        )
        oneshot, streams = [], []  # (err, payload)
        stop = threading.Event()
        with sup:
            assert sup.wait_live(2, 120), sup.status()
            start = time.monotonic()

            def gen_oneshot():
                x = np.ones(64, np.float32)
                while not stop.is_set():
                    err = None
                    try:
                        sup.router.route(x, model_id="ep0",
                                         timeout_s=15.0)
                    except Exception as exc:  # noqa: BLE001
                        err = exc
                    oneshot.append(err)

            def gen_streams():
                i = 0
                while not stop.is_set():
                    i += 1
                    s = float(i % 7)
                    err = reply = None
                    try:
                        reply = sup.router.route_stream(
                            [s], model_id="dec0", max_steps=10,
                            timeout_s=20.0,
                        )
                    except Exception as exc:  # noqa: BLE001
                        err = exc
                    streams.append((s, err, reply))

            threads = [
                threading.Thread(target=gen_oneshot, daemon=True),
                threading.Thread(target=gen_streams, daemon=True),
                threading.Thread(target=gen_streams, daemon=True),
            ]
            for t in threads:
                t.start()

            # watch for the planned kill, then the restart
            saw_kill = wait_until(
                lambda: sup.status()["live"] < 2, timeout_s=90,
            )
            recovered = wait_until(
                lambda: (
                    sup.status()["live"] == 2
                    and next(
                        r for r in sup.status()["replicas"]
                        if r["slot"] == 0
                    )["generation"] >= 2
                ),
                timeout_s=90,
            )
            time.sleep(1.0)  # traffic on the recovered fleet
            stop.set()
            for t in threads:
                t.join(timeout=30)
            assert saw_kill, "planned decode.step kill never happened"
            assert recovered, f"slot 0 not restarted: {sup.status()}"

            # post-recovery sequential streams: a leaked slot in the
            # restarted pool (n_slots=8) would wedge this burst
            for i in range(16):
                reply = sup.router.route_stream(
                    [float(i)], model_id="dec0", max_steps=6,
                    timeout_s=30.0,
                )
                assert reply["result"].tolist() == (
                    expected_tokens(float(i), 6)
                )

        # one-shot plane: zero accepted loss (retry on the survivor)
        one_failures = [e for e in oneshot if e is not None]
        assert not one_failures, (
            f"one-shot requests lost: "
            f"{[type(e).__name__ for e in one_failures[:5]]}"
        )

        # stream plane: completed == byte-correct, failed == typed
        assert len(streams) > 20, "not enough stream traffic"
        completed = [(s, r) for s, e, r in streams if e is None]
        failed = [e for _, e, _ in streams if e is not None]
        assert completed, "no stream ever completed"
        for s, reply in completed:
            assert reply["result"].tolist() == expected_tokens(s, 10), (
                f"accepted stream corrupted for prompt sum {s}"
            )
        for exc in failed:
            assert (
                isinstance(exc, (ConnectionError, OSError, socket.timeout))
                or is_transient(exc)
            ), f"mid-kill stream failed untyped: {type(exc).__name__}: {exc}"

        # shm hygiene: a SIGKILLed replica must not leak segments
        from sparkdl_tpu_torch.serving import transport as transport_mod

        assert transport_mod.active_segments() == []
