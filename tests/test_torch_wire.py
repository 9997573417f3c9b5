"""The port's wire codec and transport seam, on the cases of the JAX
package's ``tests/test_wire.py``.

Two halves:

- **Torn-frame fuzz** — every way a frame can arrive damaged
  (truncated prefix, truncated meta/body, descriptor/payload
  disagreement, hostile sizes, bad magic) must surface as a typed
  ``ConnectionError``/``RemoteReplicaError``, never a garbage array.
  The codec is the trust boundary between a healthy router and a
  replica that died mid-write.
- **Transport seam** — the TCP lane (pooled + coalesced) and the
  shared-memory lane against a real ``serve_connection`` loop:
  roundtrips, lane negotiation/refusal fallback, big-frame spill onto
  the TCP side-channel, peer-death detection, and ``/dev/shm`` leak
  hygiene.  The ``wire.shm`` fault site registered in
  ``resilience.inject`` is exercised here.
"""

import os
import pickle
import socket
import socketserver
import struct
import threading
import time

import numpy as np
import pytest

from sparkdl_tpu_torch.resilience import inject
from sparkdl_tpu_torch.serving import transport, wire
from sparkdl_tpu_torch.serving.errors import RemoteReplicaError
from sparkdl_tpu_torch.utils.metrics import metrics

PREFIX = struct.Struct(">4sBBIQ")


def frame_bytes(obj, kind=wire.KIND_MSG) -> bytearray:
    return bytearray(
        b"".join(bytes(p) for p in wire.encode_parts(obj, kind))
    )


# ----------------------------------------------------------------------
# codec roundtrips
# ----------------------------------------------------------------------
class TestCodec:
    @pytest.mark.parametrize("dtype", [
        np.float32, np.float64, np.int32, np.int64, np.uint8,
        np.bool_, np.float16,
    ])
    def test_dtype_roundtrip(self, dtype):
        a, b = socket.socketpair()
        try:
            x = np.arange(24).astype(dtype).reshape(2, 3, 4)
            wire.send_msg(a, {"value": x})
            got = wire.recv_msg(b)
            np.testing.assert_array_equal(got["value"], x)
            assert got["value"].dtype == x.dtype
        finally:
            a.close()
            b.close()

    def test_nested_containers_and_scalars(self):
        x = np.linspace(0, 1, 8, dtype=np.float32)
        msg = {
            "op": "infer", "model_id": "ep0", "deadline_ms": 12.5,
            "value": x,
            "nest": [x * 2, {"k": (x, 7, "s")}, None, True],
        }
        kind, got = wire.decode_frame(frame_bytes(msg))
        assert kind == wire.KIND_MSG
        np.testing.assert_array_equal(got["value"], x)
        np.testing.assert_array_equal(got["nest"][0], x * 2)
        np.testing.assert_array_equal(got["nest"][1]["k"][0], x)
        assert got["nest"][1]["k"][1:] == (7, "s")
        assert got["nest"][2] is None and got["nest"][3] is True
        assert got["deadline_ms"] == 12.5

    def test_noncontiguous_zero_d_and_empty(self):
        base = np.arange(24, dtype=np.float32).reshape(4, 6)
        for arr in (base[:, ::2], np.array(3.5), np.empty((0, 4))):
            _, got = wire.decode_frame(frame_bytes({"a": arr}))
            np.testing.assert_array_equal(got["a"], arr)
            assert got["a"].shape == arr.shape

    def test_received_arrays_are_writable(self):
        # np.frombuffer over the receive *bytearray*: views must be
        # writable or every consumer pays a defensive copy
        _, got = wire.decode_frame(
            frame_bytes({"a": np.ones(4, np.float32)})
        )
        got["a"][0] = 7.0
        assert got["a"][0] == 7.0

    def test_object_dtype_rides_the_pickle_envelope(self):
        # raw bytes of an object array are pointers — must NOT be
        # zero-copy framed
        arr = np.array([{"k": 1}, [2]], dtype=object)
        _, got = wire.decode_frame(frame_bytes({"a": arr}))
        assert got["a"][0] == {"k": 1} and got["a"][1] == [2]

    def test_batch_frame_shares_one_body(self):
        msgs = [{"i": i, "v": np.full(4, i, np.float32)}
                for i in range(5)]
        kind, got = wire.decode_frame(
            frame_bytes(msgs, kind=wire.KIND_BATCH), )
        assert kind == wire.KIND_BATCH
        assert [m["i"] for m in got] == list(range(5))
        np.testing.assert_array_equal(got[3]["v"], np.full(4, 3.0))

    def test_batch_frame_on_message_channel_is_refused(self):
        a, b = socket.socketpair()
        try:
            wire.send_batch(a, [{"i": 0}])
            with pytest.raises(ConnectionError):
                wire.recv_msg(b)
        finally:
            a.close()
            b.close()


# ----------------------------------------------------------------------
# envelope schema: the cross-process contract, fixture-tested
# ----------------------------------------------------------------------
class TestEnvelopeSchema:
    """Every ``wire.ENVELOPE_FIELDS`` member round-trips here, as a
    *literal*.  The ``wire-envelope`` checker rule requires any field a
    serving module puts on the wire to appear quoted in this file; the
    completeness assertion below closes the other direction — a field
    added to the schema without a fixture fails this test.  Together
    they pin the envelope from both sides."""

    #: one fixture envelope per message family, every field literal
    FIXTURES = {
        "request": {
            "op": "infer", "model_id": "ep0", "value": None,
            "deadline_ms": 12.5, "tenant": "team-a",
            "trace": (12345, 67890), "seq": 7,
        },
        "decode_request": {
            "op": "decode", "model_id": "dec0", "value": None,
            "max_steps": 16, "seq": 9,
        },
        "stream": {
            "ok": True, "result": None, "stream_seq": 3,
            "final": False, "seq": 9, "steps": 4,
        },
        "shm_handshake": {
            "op": "shm_attach", "shm": "psm_fixture",
            "ring_bytes": 1 << 20, "efd": "sdw_efd_fixture",
        },
        "shm_handshake_reply": {
            "ok": True, "eventfd": True,
        },
        "reply": {
            "ok": True, "result": None, "server_ms": 3.25,
            "phases": {"wire": 0.1, "transport": 0.4},
            "spans": [{"name": "replica.serve", "trace_id": 12345}],
            "pid": 4242, "draining": False,
            "replicas": ("replica-0",), "seq": 7,
            "cache": "hit",
        },
        "error": {
            "ok": False, "error": "boom",
            "error_class": "ValueError",
        },
    }

    @pytest.mark.parametrize("family", sorted(FIXTURES))
    def test_envelope_roundtrip(self, family):
        env = dict(self.FIXTURES[family])
        if "value" in env:
            env["value"] = np.arange(8, dtype=np.float32)
        if "result" in env:
            env["result"] = np.arange(4, dtype=np.float32)
        _, got = wire.decode_frame(frame_bytes(env))
        assert set(got) == set(env)
        for key, want in env.items():
            if isinstance(want, np.ndarray):
                np.testing.assert_array_equal(got[key], want)
            elif isinstance(want, tuple):
                assert tuple(got[key]) == want
            else:
                assert got[key] == want

    def test_fixtures_cover_the_declared_schema(self):
        covered = set()
        for env in self.FIXTURES.values():
            covered |= set(env)
        assert covered == set(wire.ENVELOPE_FIELDS), (
            "ENVELOPE_FIELDS and the roundtrip fixtures disagree: "
            f"unfixtured={sorted(set(wire.ENVELOPE_FIELDS) - covered)}, "
            f"undeclared={sorted(covered - set(wire.ENVELOPE_FIELDS))}"
        )


# ----------------------------------------------------------------------
# KIND_STREAM frames: incremental decode replies ride the
# same framing — CRC trailer, seq echo, torn-frame typing — with a
# gap-free stream_seq and exactly one final frame per stream
# ----------------------------------------------------------------------
class TestStreamFrames:
    def test_stream_roundtrip_over_socket(self):
        a, b = socket.socketpair()
        try:
            for i in range(3):
                wire.send_stream(a, {
                    "ok": True, "stream_seq": i, "final": False,
                    "result": np.full(4, i, np.float32), "seq": 7,
                })
            wire.send_stream(
                a, {"ok": True, "stream_seq": 3, "final": True, "seq": 7}
            )
            for i in range(3):
                kind, got = wire.recv_any(b)
                assert kind == wire.KIND_STREAM
                assert got["stream_seq"] == i and got["final"] is False
                assert got["seq"] == 7
                np.testing.assert_array_equal(
                    got["result"], np.full(4, i, np.float32)
                )
            kind, got = wire.recv_any(b)
            assert kind == wire.KIND_STREAM
            assert got["final"] is True and got["stream_seq"] == 3
        finally:
            a.close()
            b.close()

    def test_stream_frame_on_message_channel_is_refused(self):
        # recv_msg is the one-shot API; a stream fragment there means
        # the caller lost track of a stream — refuse, don't misfile
        a, b = socket.socketpair()
        try:
            wire.send_stream(a, {"ok": True, "stream_seq": 0,
                                 "final": True})
            with pytest.raises(ConnectionError):
                wire.recv_msg(b)
        finally:
            a.close()
            b.close()

    def test_stream_frames_carry_and_verify_crc(self):
        raw = frame_bytes(
            {"ok": True, "stream_seq": 1, "final": False,
             "result": np.arange(32, dtype=np.float32)},
            kind=wire.KIND_STREAM,
        )
        _, flags, _, _ = wire._parse_prefix(bytes(raw[:PREFIX.size]))
        assert flags & wire.FLAG_CRC
        raw[len(raw) - wire._CRC.size - 5] ^= 0x20
        before = metrics.counter("wire.crc_fail").value
        with pytest.raises(wire.FrameCorrupt):
            wire.decode_frame(raw)
        assert metrics.counter("wire.crc_fail").value == before + 1

    def test_stream_kind_decodes_from_memory(self):
        kind, got = wire.decode_frame(frame_bytes(
            {"ok": True, "stream_seq": 0, "final": True,
             "result": np.ones(4, np.float32)},
            kind=wire.KIND_STREAM,
        ))
        assert kind == wire.KIND_STREAM
        np.testing.assert_array_equal(
            got["result"], np.ones(4, np.float32)
        )


# ----------------------------------------------------------------------
# torn-frame fuzz: damaged input must never become a garbage array
# ----------------------------------------------------------------------
class TestTornFrames:
    def recv_raises(self, raw: bytes):
        a, b = socket.socketpair()
        try:
            a.sendall(raw)
            a.close()
            with pytest.raises(ConnectionError):
                wire.recv_msg(b)
        finally:
            b.close()

    def test_truncated_prefix(self):
        whole = bytes(frame_bytes({"v": np.ones(4, np.float32)}))
        for cut in (1, 5, PREFIX.size - 1):
            self.recv_raises(whole[:cut])

    def test_truncated_meta_and_body(self):
        whole = bytes(frame_bytes({"v": np.ones(64, np.float32)}))
        for cut in (PREFIX.size + 3, len(whole) - 1, len(whole) - 100):
            self.recv_raises(whole[:cut])

    def test_bad_magic(self):
        whole = bytearray(frame_bytes({"v": np.ones(4, np.float32)}))
        whole[:4] = b"XXXX"
        self.recv_raises(bytes(whole))

    def test_unknown_kind(self):
        whole = bytearray(frame_bytes({"v": 1}))
        whole[4] = 99
        self.recv_raises(bytes(whole))

    def test_oversized_frame_refused_before_allocation(self):
        self.recv_raises(PREFIX.pack(
            wire.MAGIC, wire.KIND_MSG, 0, 16, wire.MAX_FRAME_BYTES + 1
        ))

    def test_oversized_meta_refused(self):
        self.recv_raises(PREFIX.pack(
            wire.MAGIC, wire.KIND_MSG, 0, wire.MAX_META_BYTES + 1, 0
        ))

    def _forged(self, desc, body: bytes) -> bytearray:
        meta = pickle.dumps(((wire._TENSOR_MARK, 0), [desc]))
        return bytearray(
            PREFIX.pack(wire.MAGIC, wire.KIND_MSG, 0, len(meta),
                        len(body)) + meta + body
        )

    def test_dtype_shape_payload_length_mismatch(self):
        body = np.ones(8, np.float32).tobytes()
        # descriptor claims 8 float64s (64 bytes) over a 32-byte body
        forged = self._forged(("<f8", (8,), 0, 32, True), body)
        with pytest.raises(ConnectionError):
            wire.decode_frame(forged)

    def test_descriptor_overruns_body(self):
        body = np.ones(8, np.float32).tobytes()
        forged = self._forged(("<f4", (16,), 0, 64, True), body)
        with pytest.raises(ConnectionError):
            wire.decode_frame(forged)
        forged = self._forged(("<f4", (8,), 16, 32, True), body)
        with pytest.raises(ConnectionError):
            wire.decode_frame(forged)

    def test_invalid_dtype_string(self):
        forged = self._forged(("not-a-dtype", (8,), 0, 32, True),
                              bytes(32))
        with pytest.raises(ConnectionError):
            wire.decode_frame(forged)

    def test_tensor_marker_out_of_range(self):
        meta = pickle.dumps(((wire._TENSOR_MARK, 3), []))
        raw = bytearray(
            PREFIX.pack(wire.MAGIC, wire.KIND_MSG, 0, len(meta), 0)
            + meta
        )
        with pytest.raises(ConnectionError):
            wire.decode_frame(raw)

    def test_garbage_meta_pickle(self):
        raw = bytearray(
            PREFIX.pack(wire.MAGIC, wire.KIND_MSG, 0, 8, 0)
            + b"\x00garbage"
        )
        with pytest.raises(ConnectionError):
            wire.decode_frame(raw)

    def test_unknown_remote_error_is_typed(self):
        exc = wire.decode_error(
            {"ok": False, "error_class": "Weird", "error": "boom"}
        )
        assert isinstance(exc, RemoteReplicaError)

    def test_error_registry_is_cached(self):
        assert wire._error_registry() is wire._error_registry()


# ----------------------------------------------------------------------
# transport seam against a live serve_connection loop
# ----------------------------------------------------------------------
class _EchoServer(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True


def start_echo(allow_shm=True):
    """A serve_connection loop that doubles ``value`` — the transport
    mechanics without a ModelServer underneath."""

    def handle_one(msg):
        if msg.get("op") == "boom":
            raise ValueError("planned failure")
        return {"ok": True, "result": msg["value"] * 2, "server_ms": 0.1}

    class Handler(socketserver.BaseRequestHandler):
        def handle(self):
            srv.conns.append(self.request)
            transport.serve_connection(
                self.request, handle_one, allow_shm=allow_shm
            )

    srv = _EchoServer(("127.0.0.1", 0), Handler)
    srv.conns = []
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, srv.server_address[1]


def my_shm_entries():
    shm_dir = "/dev/shm"
    if not os.path.isdir(shm_dir):
        return []
    return [f for f in os.listdir(shm_dir)
            if f.startswith(f"sdw_{os.getpid()}_")]


class TestTransports:
    def test_pooled_tcp_roundtrip(self):
        srv, port = start_echo()
        try:
            t = transport.TcpTransport("127.0.0.1", port, coalesce=False)
            x = np.arange(8, dtype=np.float32)
            reply = t.request({"op": "infer", "value": x}, 5.0)
            np.testing.assert_array_equal(reply["result"], x * 2)
            assert t.lane == "tcp"
            t.close()
        finally:
            srv.shutdown()
            srv.server_close()

    def test_coalescer_batches_concurrent_requests(self):
        srv, port = start_echo()
        try:
            t = transport.TcpTransport("127.0.0.1", port, coalesce=True)
            before = metrics.counter("wire.coalesced_msgs").value
            x = np.ones(8, np.float32)
            errs = []

            def hit(i):
                try:
                    reply = t.request({"op": "infer", "value": x + i}, 10.0)
                    np.testing.assert_array_equal(
                        reply["result"], (x + i) * 2
                    )
                except Exception as exc:  # noqa: BLE001
                    errs.append(exc)

            threads = [threading.Thread(target=hit, args=(i,))
                       for i in range(32)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=30)
            assert not errs, errs[:3]
            # 32 concurrent requests over one socket MUST have shared
            # frames (greedy group commit while an RTT is in flight)
            assert metrics.counter("wire.coalesced_msgs").value > before
            t.close()
        finally:
            srv.shutdown()
            srv.server_close()

    def test_coalesced_error_reply_stays_per_message(self):
        srv, port = start_echo()
        try:
            t = transport.TcpTransport("127.0.0.1", port, coalesce=True)
            reply = t.request({"op": "boom", "value": 1}, 5.0)
            assert reply["ok"] is False
            assert reply["error_class"] == "ValueError"
            t.close()
        finally:
            srv.shutdown()
            srv.server_close()

    def test_shm_roundtrip_and_lane(self):
        srv, port = start_echo()
        try:
            t = transport.ShmTransport("127.0.0.1", port)
            x = np.arange(16, dtype=np.float32)
            for i in range(8):
                reply = t.request({"op": "infer", "value": x + i}, 5.0)
                np.testing.assert_array_equal(reply["result"], (x + i) * 2)
            assert t.lane == "shm"
            assert transport.active_segments()
            t.close()
            assert transport.active_segments() == []
            assert my_shm_entries() == []
        finally:
            srv.shutdown()
            srv.server_close()

    def test_shm_big_frame_spills_to_tcp_sidechannel(self):
        srv, port = start_echo()
        try:
            t = transport.ShmTransport("127.0.0.1", port)
            before = metrics.counter("wire.shm.spill").value
            big = np.ones((700, 700), np.float32)  # ~1.9MB > 1MB ring
            reply = t.request({"op": "infer", "value": big}, 15.0)
            np.testing.assert_array_equal(reply["result"], big * 2)
            assert metrics.counter("wire.shm.spill").value > before
            t.close()
        finally:
            srv.shutdown()
            srv.server_close()

    def test_shm_refusal_falls_back_to_tcp(self):
        srv, port = start_echo(allow_shm=False)
        try:
            before = metrics.counter("wire.shm.fallback").value
            t = transport.ShmTransport("127.0.0.1", port)
            x = np.ones(4, np.float32)
            reply = t.request({"op": "infer", "value": x}, 5.0)
            np.testing.assert_array_equal(reply["result"], x * 2)
            assert t.lane == "tcp"
            assert metrics.counter("wire.shm.fallback").value > before
            t.close()
            assert my_shm_entries() == []
        finally:
            srv.shutdown()
            srv.server_close()

    @pytest.mark.skipif(
        not (hasattr(os, "eventfd") and hasattr(socket, "send_fds")),
        reason="eventfd doorbells need os.eventfd + SCM_RIGHTS passing",
    )
    def test_shm_doorbells_ride_eventfd(self):
        """Where the platform supports it, shm doorbells are eventfd
        wakes — the socket side-channel carries zero doorbell bytes."""
        srv, port = start_echo()
        try:
            efd_before = metrics.counter("wire.doorbell.eventfd").value
            sock_before = metrics.counter("wire.doorbell.socket").value
            t = transport.ShmTransport("127.0.0.1", port)
            x = np.ones(8, np.float32)
            for i in range(6):
                reply = t.request({"op": "infer", "value": x + i}, 5.0)
                np.testing.assert_array_equal(reply["result"], (x + i) * 2)
            assert t.lane == "shm"
            t.close()
            assert metrics.counter("wire.doorbell.eventfd").value \
                > efd_before
            assert metrics.counter("wire.doorbell.socket").value \
                == sock_before
        finally:
            srv.shutdown()
            srv.server_close()

    def test_eventfd_kill_switch_forces_socket_doorbells(
        self, monkeypatch
    ):
        """SPARKDL_WIRE_EVENTFD=0 must pin every doorbell to the socket
        byte — the portable path stays exercised and killable."""
        monkeypatch.setenv("SPARKDL_WIRE_EVENTFD", "0")
        srv, port = start_echo()
        try:
            efd_before = metrics.counter("wire.doorbell.eventfd").value
            sock_before = metrics.counter("wire.doorbell.socket").value
            t = transport.ShmTransport("127.0.0.1", port)
            x = np.ones(8, np.float32)
            reply = t.request({"op": "infer", "value": x}, 5.0)
            np.testing.assert_array_equal(reply["result"], x * 2)
            assert t.lane == "shm"
            t.close()
            assert metrics.counter("wire.doorbell.eventfd").value \
                == efd_before
            assert metrics.counter("wire.doorbell.socket").value \
                > sock_before
        finally:
            srv.shutdown()
            srv.server_close()

    def test_peer_death_is_connection_error(self):
        # SIGKILL equivalent at channel level: the peer process is gone
        # (listener included) and the client must turn that into a
        # typed ConnectionError instead of spinning on a ring no one
        # will ever answer
        srv, port = start_echo()
        t = transport.ShmTransport("127.0.0.1", port)
        try:
            x = np.ones(4, np.float32)
            t.request({"op": "infer", "value": x}, 5.0)
            for conn in list(srv.conns):
                try:
                    conn.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
            srv.shutdown()
            srv.server_close()
            with pytest.raises((ConnectionError, OSError)):
                t.request({"op": "infer", "value": x}, 2.0)
        finally:
            t.close()
        assert transport.active_segments() == []
        assert my_shm_entries() == []

    def test_replica_restart_while_pooled_recovers_transparently(self):
        # the softer death: the replica behind the name was restarted
        # while this channel sat pooled, but SOMETHING is listening
        # again — the staleness probe discards the dead channel and the
        # request rides a fresh one instead of surfacing ConnectionError
        srv, port = start_echo()
        t = transport.ShmTransport("127.0.0.1", port)
        try:
            x = np.ones(4, np.float32)
            t.request({"op": "infer", "value": x}, 5.0)
            before = metrics.counter("wire.pool.stale").value
            for conn in list(srv.conns):
                try:
                    conn.shutdown(socket.SHUT_RDWR)
                    conn.close()
                except OSError:
                    pass
            time.sleep(0.05)
            reply = t.request({"op": "infer", "value": x}, 5.0)
            np.testing.assert_array_equal(reply["result"], x * 2)
            assert metrics.counter("wire.pool.stale").value == before + 1
        finally:
            t.close()
            srv.shutdown()
            srv.server_close()
        assert transport.active_segments() == []
        assert my_shm_entries() == []

    def test_make_transport_mode_matrix(self):
        srv, port = start_echo()
        try:
            t = transport.make_transport(
                "127.0.0.1", port, lanes=("tcp", "shm"), mode="tcp"
            )
            assert isinstance(t, transport.TcpTransport)
            t.close()
            t = transport.make_transport(
                "127.0.0.1", port, lanes=("tcp",), mode="shm"
            )
            assert isinstance(t, transport.TcpTransport)  # fell back
            t.close()
            t = transport.make_transport(
                "127.0.0.1", port, lanes=("tcp", "shm"), mode="auto"
            )
            assert isinstance(t, transport.ShmTransport)
            t.close()
            with pytest.raises(ValueError):
                transport.make_transport(
                    "127.0.0.1", port, mode="carrier-pigeon"
                )
        finally:
            srv.shutdown()
            srv.server_close()

    def test_wire_shm_fault_site_fires(self):
        assert "wire.shm" in inject.known_sites()
        srv, port = start_echo()
        try:
            t = transport.ShmTransport("127.0.0.1", port)
            plan = inject.FaultPlan().add(
                "wire.shm", error="transient", at=1
            )
            with inject.active_plan(plan):
                with pytest.raises(inject.InjectedTransientError):
                    t.request(
                        {"op": "infer", "value": np.ones(4, np.float32)},
                        5.0,
                    )
            t.close()
            assert my_shm_entries() == []
        finally:
            srv.shutdown()
            srv.server_close()


class TestPoolStaleness:
    """The idle pool must never hand a request a
    socket the peer already abandoned — checkout probes (readable while
    idle == EOF/garbage) and age-gates every pooled entry first."""

    def test_healthy_idle_socket_is_reused(self):
        srv, port = start_echo()
        try:
            t = transport.TcpTransport("127.0.0.1", port, coalesce=False)
            x = np.ones(4, np.float32)
            for _ in range(3):
                reply = t.request({"op": "infer", "value": x}, 5.0)
                np.testing.assert_array_equal(reply["result"], x * 2)
            # all three rode the same connection: probe passed, no churn
            assert len(srv.conns) == 1
            t.close()
        finally:
            srv.shutdown()
            srv.server_close()

    def test_peer_closed_idle_socket_is_discarded_not_served(self):
        srv, port = start_echo()
        try:
            t = transport.TcpTransport("127.0.0.1", port, coalesce=False)
            x = np.ones(4, np.float32)
            t.request({"op": "infer", "value": x}, 5.0)
            # replica restarts during a quiet spell: the pooled socket
            # is now a dead letter the old code would try to write to
            before = metrics.counter("wire.pool.stale").value
            for conn in list(srv.conns):
                try:
                    conn.shutdown(socket.SHUT_RDWR)
                    conn.close()
                except OSError:
                    pass
            time.sleep(0.05)  # let the FIN land client-side
            reply = t.request({"op": "infer", "value": x}, 5.0)
            np.testing.assert_array_equal(reply["result"], x * 2)
            assert metrics.counter("wire.pool.stale").value == before + 1
            assert len(srv.conns) == 2  # fresh dial, not the corpse
            t.close()
        finally:
            srv.shutdown()
            srv.server_close()

    def test_idle_socket_ages_out(self, monkeypatch):
        # the knob is read at construction: set it BEFORE the transport
        monkeypatch.setenv("SPARKDL_WIRE_POOL_IDLE_S", "0.02")
        srv, port = start_echo()
        try:
            t = transport.TcpTransport("127.0.0.1", port, coalesce=False)
            x = np.ones(4, np.float32)
            t.request({"op": "infer", "value": x}, 5.0)
            before = metrics.counter("wire.pool.aged").value
            time.sleep(0.05)  # older than the 20ms budget
            reply = t.request({"op": "infer", "value": x}, 5.0)
            np.testing.assert_array_equal(reply["result"], x * 2)
            assert metrics.counter("wire.pool.aged").value == before + 1
            assert len(srv.conns) == 2
            t.close()
        finally:
            srv.shutdown()
            srv.server_close()


# ----------------------------------------------------------------------
# CRC-verified frames: a flipped byte anywhere in the frame
# is detected and typed — never decoded into a silently-wrong tensor
# ----------------------------------------------------------------------
class TestFrameCrc:
    def test_frames_carry_the_crc_flag(self):
        raw = frame_bytes({"v": np.ones(4, np.float32)})
        _, flags, _, _ = wire._parse_prefix(bytes(raw[:PREFIX.size]))
        assert flags & wire.FLAG_CRC

    @pytest.mark.parametrize("where", ["meta", "body", "trailer"])
    def test_single_flipped_byte_is_detected(self, where):
        raw = frame_bytes({"v": np.arange(64, dtype=np.float32)})
        index = {
            "meta": PREFIX.size + 2,
            "body": len(raw) - wire._CRC.size - 5,
            "trailer": len(raw) - 1,
        }[where]
        raw[index] ^= 0x40
        before = metrics.counter("wire.crc_fail").value
        with pytest.raises(wire.FrameCorrupt):
            wire.decode_frame(raw)
        assert metrics.counter("wire.crc_fail").value == before + 1

    def test_corrupt_frame_over_socket_is_typed(self):
        raw = frame_bytes({"v": np.arange(16, dtype=np.float32)})
        raw[len(raw) - wire._CRC.size - 3] ^= 0x01
        a, b = socket.socketpair()
        try:
            a.sendall(bytes(raw))
            a.close()
            with pytest.raises(ConnectionError):
                wire.recv_msg(b)
        finally:
            b.close()

    def test_crc_off_roundtrip(self, monkeypatch):
        monkeypatch.setattr(wire, "_CRC_ENABLED", False)
        raw = frame_bytes({"v": np.ones(4, np.float32)})
        _, flags, _, _ = wire._parse_prefix(bytes(raw[:PREFIX.size]))
        assert not (flags & wire.FLAG_CRC)
        _, got = wire.decode_frame(raw)
        np.testing.assert_array_equal(got["v"], np.ones(4, np.float32))

    def test_decode_honours_frame_flag_not_env(self, monkeypatch):
        # a CRC-stamped frame from a peer with the knob ON must still
        # verify locally even when THIS process has encoding turned off
        raw = frame_bytes({"v": np.arange(8, dtype=np.float32)})
        monkeypatch.setattr(wire, "_CRC_ENABLED", False)
        raw[-2] ^= 0x10
        with pytest.raises(wire.FrameCorrupt):
            wire.decode_frame(raw)

    def test_framecorrupt_is_transient_and_registry_typed(self):
        from sparkdl_tpu_torch.resilience.errors import is_transient

        exc = wire.FrameCorrupt("x")
        assert isinstance(exc, ConnectionError)
        assert is_transient(exc)
        # the registry round-trips it (and plain connection-shaped
        # classes) typed, never as the permanent RemoteReplicaError
        for cls in ("FrameCorrupt", "ConnectionError", "TimeoutError"):
            decoded = wire.decode_error(
                {"ok": False, "error_class": cls, "error": "x"}
            )
            assert not isinstance(decoded, RemoteReplicaError), cls
        assert isinstance(
            wire.decode_error(
                {"ok": False, "error_class": "FrameCorrupt", "error": "x"}
            ),
            wire.FrameCorrupt,
        )


# ----------------------------------------------------------------------
# seq stamping: the duplicated/reordered-reply defense
# ----------------------------------------------------------------------
class TestSeqEcho:
    def test_check_seq_passes_on_echo_and_absence(self):
        assert transport._check_seq({"ok": True, "seq": 9}, 9)["ok"]
        # a peer that predates the field: absence is not a desync
        assert transport._check_seq({"ok": True}, 9)["ok"]

    def test_check_seq_raises_on_mismatch(self):
        with pytest.raises(ConnectionError, match="desync"):
            transport._check_seq({"ok": True, "seq": 8}, 9)

    def test_replies_echo_seq_end_to_end(self):
        srv, port = start_echo()
        try:
            t = transport.TcpTransport("127.0.0.1", port, coalesce=False)
            reply = t.request(
                {"op": "infer", "value": np.ones(4, np.float32)}, 5.0
            )
            assert isinstance(reply.get("seq"), int)
            t.close()
        finally:
            srv.shutdown()
            srv.server_close()

    def test_duplicated_reply_desyncs_then_recovers(self):
        # a dup'd request frame makes the server answer twice, leaving
        # a stale extra reply in the socket.  Two independent defenses
        # race to catch it — which one wins depends on whether the
        # stale bytes land before the next checkout:
        #   * pool staleness probe: readable-while-idle => the poisoned
        #     socket is discarded and the request rides a fresh dial
        #   * seq echo: the stale reply is read => typed "desync" error
        #     and the socket is dropped
        # Either way the invariant is the same: NEVER a wrong result,
        # one of the defenses provably fired, and the request after
        # that succeeds on a clean socket.
        srv, port = start_echo()
        fired = []

        def dup_once(parts):
            if not fired:
                fired.append(True)
                return list(parts) + [bytes(p) for p in parts]
            return parts

        t = transport.TcpTransport("127.0.0.1", port, coalesce=False)
        try:
            x = np.ones(4, np.float32)
            stale_before = metrics.counter("wire.pool.stale").value
            wire.set_send_tap(dup_once)
            try:
                reply = t.request({"op": "infer", "value": x}, 5.0)
                np.testing.assert_array_equal(reply["result"], x * 2)
                desynced = False
                try:
                    reply = t.request({"op": "infer", "value": x}, 5.0)
                except ConnectionError as exc:
                    desynced = True
                    assert "desync" in str(exc)
                else:
                    np.testing.assert_array_equal(reply["result"], x * 2)
            finally:
                wire.set_send_tap(None)
            probed = metrics.counter("wire.pool.stale").value > stale_before
            assert desynced or probed, (
                "duplicated reply was neither desync-detected nor "
                "discarded by the pool staleness probe"
            )
            reply = t.request({"op": "infer", "value": x}, 5.0)
            np.testing.assert_array_equal(reply["result"], x * 2)
        finally:
            t.close()
            srv.shutdown()
            srv.server_close()


# ----------------------------------------------------------------------
# injected network faults on the shm lane: ring,
# spill side-channel, and the shm->tcp fallback path all detect
# corruption typed — zero silent wrong answers
# ----------------------------------------------------------------------
class TestShmLaneFaults:
    def _plan(self, **rule_kw):
        return inject.FaultPlan().add("faultnet.tx", **rule_kw)

    def test_ring_corrupt_frame_is_detected_not_decoded(self):
        from sparkdl_tpu_torch.serving import faultnet

        srv, port = start_echo()
        t = transport.ShmTransport("127.0.0.1", port)
        try:
            x = np.arange(16, dtype=np.float32)
            reply = t.request({"op": "infer", "value": x}, 5.0)
            np.testing.assert_array_equal(reply["result"], x * 2)
            before = metrics.counter("wire.crc_fail").value
            with inject.active_plan(self._plan(act="corrupt_body", at=1)):
                assert faultnet.arm()
                try:
                    with pytest.raises(
                        (ConnectionError, OSError, socket.timeout)
                    ):
                        t.request({"op": "infer", "value": x}, 2.0)
                finally:
                    faultnet.disarm()
            assert metrics.counter("wire.crc_fail").value > before
            # the lane heals: a fresh channel serves clean traffic
            reply = t.request({"op": "infer", "value": x}, 5.0)
            np.testing.assert_array_equal(reply["result"], x * 2)
        finally:
            t.close()
            srv.shutdown()
            srv.server_close()
        assert my_shm_entries() == []

    def test_spill_lane_corrupt_frame_is_detected(self):
        from sparkdl_tpu_torch.serving import faultnet

        srv, port = start_echo()
        t = transport.ShmTransport("127.0.0.1", port)
        try:
            big = np.ones((700, 700), np.float32)  # > 1MB ring: spills
            reply = t.request({"op": "infer", "value": big}, 15.0)
            np.testing.assert_array_equal(reply["result"], big * 2)
            before = metrics.counter("wire.crc_fail").value
            with inject.active_plan(self._plan(act="corrupt_body", at=1)):
                assert faultnet.arm()
                try:
                    with pytest.raises(
                        (ConnectionError, OSError, socket.timeout)
                    ):
                        t.request({"op": "infer", "value": big}, 2.0)
                finally:
                    faultnet.disarm()
            assert metrics.counter("wire.crc_fail").value > before
        finally:
            t.close()
            srv.shutdown()
            srv.server_close()
        assert my_shm_entries() == []

    def test_fallback_tcp_lane_detects_corruption_too(self):
        from sparkdl_tpu_torch.serving import faultnet

        srv, port = start_echo(allow_shm=False)  # forces shm->tcp fall
        t = transport.ShmTransport("127.0.0.1", port)
        try:
            x = np.ones(4, np.float32)
            reply = t.request({"op": "infer", "value": x}, 5.0)
            np.testing.assert_array_equal(reply["result"], x * 2)
            assert t.lane == "tcp"
            before = metrics.counter("wire.crc_fail").value
            with inject.active_plan(self._plan(act="corrupt_body", at=1)):
                assert faultnet.arm()
                try:
                    with pytest.raises(
                        (ConnectionError, OSError, socket.timeout)
                    ):
                        t.request({"op": "infer", "value": x}, 2.0)
                finally:
                    faultnet.disarm()
            assert metrics.counter("wire.crc_fail").value > before
            reply = t.request({"op": "infer", "value": x}, 5.0)
            np.testing.assert_array_equal(reply["result"], x * 2)
        finally:
            t.close()
            srv.shutdown()
            srv.server_close()
