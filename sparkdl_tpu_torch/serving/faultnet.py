"""Network fault injection at the Transport seam.

Port of ``sparkdl_tpu.serving.faultnet`` (host code: a copy with the
package renamed). The kill matrix proves the serving plane against
*process* death; this module supplies the *network* faults: added
latency, dropped replies, mid-frame disconnects, stalled sockets,
corrupt bytes (header and tensor body), duplicated replies — on both
the TCP and shm-ring lanes.  Everything is driven by the existing
:mod:`sparkdl_tpu_torch.resilience.inject` plan machinery (the
``SPARKDL_FAULT_PLAN`` env var arms child replica processes with no
code changes), through three *decision* sites whose ``act=`` verb this
module interprets:

``faultnet.tx``
    Consulted for every encoded frame leaving the process, via the
    :func:`wire.set_send_tap` seam — *after* the CRC trailer is
    stamped, so a ``corrupt_body`` flip is exactly the damage the
    checksum exists to catch.  Because the tap sits inside
    ``encode_parts``, it covers every lane that consumes an encode:
    TCP ``sendmsg``, the shm ring write, and the oversized-frame spill.
    Verbs: ``corrupt_body``, ``corrupt_header``, ``truncate``,
    ``dup``, ``disconnect`` (plus ``stall_s=`` / ``error=`` /
    ``kill=`` rule actions, honored as themselves).

``faultnet.request`` / ``faultnet.reply``
    Consulted by :class:`FaultyTransport` around each round trip
    (message level: latency, drop, disconnect) and by
    :class:`FaultProxy` per forwarded frame in each direction
    (byte level: everything above plus a true ``midframe_disconnect``
    — N bytes of a frame land and then the socket dies).

Corruption NEVER mutates a caller's live buffers — the damaged part is
a copy — so an injected fault can't silently poison the array a
request still holds.  Every applied fault counts
``faultnet.injected``.
"""

from __future__ import annotations

import os
import socket
import threading
import time
from typing import Any, Dict, List, Optional

from sparkdl_tpu_torch.resilience import inject
from sparkdl_tpu_torch.serving import wire
from sparkdl_tpu_torch.serving.transport import Transport
from sparkdl_tpu_torch.utils.metrics import metrics

#: faultnet decision sites (registered in ``inject.KNOWN_SITES``)
SITE_TX = "faultnet.tx"
SITE_REQUEST = "faultnet.request"
SITE_REPLY = "faultnet.reply"

#: ``act=`` verbs the tx tap understands
TX_VERBS = ("corrupt_body", "corrupt_header", "truncate", "dup",
            "disconnect")
#: extra verbs only the byte-level proxy can express
PROXY_VERBS = TX_VERBS + ("midframe_disconnect", "drop")


def _count_injected() -> None:
    metrics.counter("faultnet.injected").add(1)


# ---------------------------------------------------------------------------
# the encode-side tap (both lanes)


def _flip_copy(part: Any, index: int) -> bytes:
    """A copy of ``part`` with one bit flipped — the caller's buffer
    (possibly a live ndarray's memory) is never touched."""
    buf = bytearray(bytes(part))
    buf[index % len(buf)] ^= 0x40
    return bytes(buf)


def _apply_tx_verb(verb: str, parts: List[Any]) -> List[Any]:
    if verb == "disconnect":
        raise ConnectionError("faultnet: injected disconnect before send")
    if verb == "corrupt_body":
        # flip a byte in the largest non-prefix part (a tensor buffer
        # when one exists, else the meta region of part 0 past the
        # prefix) — the structural checks can't see it; only CRC can
        if len(parts) > 1:
            idx = max(range(1, len(parts)), key=lambda i: len(parts[i]))
            parts = list(parts)
            parts[idx] = _flip_copy(parts[idx], len(parts[idx]) // 2)
        else:
            parts = [_flip_copy(parts[0], wire._PREFIX.size + 1)]
        return parts
    if verb == "corrupt_header":
        # flip the MSB of the prefix's u64 body_len (byte 10): the
        # declared frame size explodes past MAX_FRAME_BYTES and the
        # receiver refuses before allocating — a deterministic,
        # immediately-detected header flip
        parts = list(parts)
        parts[0] = _flip_copy(parts[0], 10)
        return parts
    if verb == "truncate":
        # a torn frame: the prefix promises more bytes than arrive.
        # On the shm ring the short record is refused instantly; on a
        # stream the peer blocks until timeout/EOF — the stalled-socket
        # shape of a mid-frame failure
        raw = b"".join(bytes(p) for p in parts)
        return [raw[: max(wire._PREFIX.size + 1, len(raw) // 2)]]
    if verb == "dup":
        # the full frame twice: the first decodes fine, the duplicate
        # desyncs the reply stream — what the seq echo check catches
        return list(parts) + [bytes(p) for p in parts]
    raise ValueError(f"unknown faultnet tx verb {verb!r}")


def _tx_tap(parts: List[Any]) -> List[Any]:
    """The :func:`wire.set_send_tap` hook: consult the active plan for
    every outgoing frame and apply any triggered verbs."""
    for rle in inject.decide(SITE_TX):
        _count_injected()
        if rle.kill:
            os._exit(9)
        if rle.stall_s is not None:
            # an injected stall IS the product here, not a retry loop
            time.sleep(rle.stall_s)  # sparkdl: disable=sleep-retry
            continue
        if rle.error is not None:
            raise rle.make_error()
        parts = _apply_tx_verb(rle.act, parts)
    return parts


def arm() -> bool:
    """Install the tx tap iff the active fault plan targets a faultnet
    site.  Called by the replica ``main()`` (so an env-armed child
    process taps itself) and by tests/benches after installing a plan.
    Returns whether the tap went in."""
    plan = inject.installed_plan()
    if plan is None or not any(
        s.startswith("faultnet.") for s in plan.sites()
    ):
        return False
    wire.set_send_tap(_tx_tap)
    return True


def disarm() -> None:
    wire.set_send_tap(None)


# ---------------------------------------------------------------------------
# message-level wrapper (the Transport seam)


class FaultyTransport(Transport):
    """A :class:`Transport` that injects message-level faults around an
    inner lane: added latency / stalls (``stall_s=``), typed errors
    (``error=``), ``disconnect`` before send, and ``drop_reply`` — the
    reply is computed by the replica but never reaches the caller
    (surfaces as ``socket.timeout``, the slow-backend shape).  Enable
    fleet-wide with ``SPARKDL_FAULTNET=1`` (see
    :func:`~sparkdl_tpu_torch.serving.transport.make_transport`)."""

    def __init__(self, inner: Transport):
        self._inner = inner

    @property
    def lane(self) -> str:
        return self._inner.lane

    @staticmethod
    def _apply(rle: inject.Rule, dropped_ok: bool) -> bool:
        """Honor one triggered rule; returns True when the reply must
        be dropped (only meaningful at the reply site)."""
        _count_injected()
        if rle.stall_s is not None:
            time.sleep(rle.stall_s)
            return False
        if rle.error is not None:
            raise rle.make_error()
        if rle.act == "disconnect":
            raise ConnectionError("faultnet: injected disconnect")
        if rle.act == "drop_reply" and dropped_ok:
            return True
        raise ValueError(
            f"faultnet rule act={rle.act!r} not applicable at a "
            "message-level site"
        )

    def request(self, msg: Dict[str, Any],
                timeout_s: float) -> Dict[str, Any]:
        for rle in inject.decide(SITE_REQUEST):
            self._apply(rle, dropped_ok=False)
        reply = self._inner.request(msg, timeout_s)
        for rle in inject.decide(SITE_REPLY):
            if self._apply(rle, dropped_ok=True):
                raise socket.timeout(
                    "faultnet: reply dropped after replica answered"
                )
        return reply

    def stream(self, msg: Dict[str, Any], on_frame,
               timeout_s: float) -> Dict[str, Any]:
        """Decode streams get the same message-level faults: the
        request site fires before the stream opens, the reply site
        after its final frame (dropping it surfaces as the slow-backend
        timeout shape, exactly like a dropped one-shot reply)."""
        for rle in inject.decide(SITE_REQUEST):
            self._apply(rle, dropped_ok=False)
        reply = self._inner.stream(msg, on_frame, timeout_s)
        for rle in inject.decide(SITE_REPLY):
            if self._apply(rle, dropped_ok=True):
                raise socket.timeout(
                    "faultnet: final stream frame dropped after replica "
                    "answered"
                )
        return reply

    def close(self) -> None:
        self._inner.close()


# ---------------------------------------------------------------------------
# socket-level proxy (frame-aware, true mid-frame faults on TCP)


def _read_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    """``n`` bytes or None on EOF at a boundary; EOF mid-read also
    returns None (the proxy just stops forwarding — the endpoints'
    own torn-frame handling takes it from there)."""
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            return None
        buf += chunk
    return bytes(buf)


class FaultProxy:
    """A frame-aware TCP proxy between a router and one replica port:
    it parses SDW2 prefixes (doorbell bytes pass straight through) so
    faults land on exact frame boundaries — including the one fault no
    in-process tap can fake, a *mid-frame disconnect* where half a
    frame arrives and then the connection dies.  Client→upstream frames
    consult ``faultnet.request``; upstream→client frames consult
    ``faultnet.reply``.  Point the router at :attr:`port` instead of
    the replica's own."""

    def __init__(self, upstream_host: str, upstream_port: int):
        self._upstream = (upstream_host, upstream_port)
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(
            socket.SOL_SOCKET, socket.SO_REUSEADDR, 1
        )
        self._listener.bind(("127.0.0.1", 0))
        self._listener.listen(16)
        self.port = self._listener.getsockname()[1]
        self._closed = False
        self._conns: List[socket.socket] = []
        self._lock = threading.Lock()
        threading.Thread(
            target=self._accept_loop, daemon=True,
            name=f"faultproxy:{self.port}",
        ).start()

    def _accept_loop(self) -> None:
        while not self._closed:
            try:
                client, _ = self._listener.accept()
            except OSError:
                return
            try:
                upstream = wire.connect(*self._upstream, timeout_s=5.0)
            except OSError:
                client.close()
                continue
            client.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            with self._lock:
                self._conns += [client, upstream]
            for src, dst, site in (
                (client, upstream, SITE_REQUEST),
                (upstream, client, SITE_REPLY),
            ):
                threading.Thread(
                    target=self._pump, args=(src, dst, site), daemon=True,
                ).start()

    def _pump(self, src: socket.socket, dst: socket.socket,
              site: str) -> None:
        try:
            while True:
                frame = self._read_unit(src)
                if frame is None:
                    break
                for rle in inject.decide(site):
                    frame = self._apply(rle, frame, src, dst)
                    if frame is None:
                        return  # disconnected — sockets already dead
                if frame:
                    dst.sendall(frame)
        except (OSError, ValueError):
            pass
        finally:
            self._kill_pair(src, dst)

    @staticmethod
    def _read_unit(src: socket.socket) -> Optional[bytes]:
        """One forwarding unit: a doorbell byte or a whole SDW2 frame
        (prefix + meta + body + CRC trailer when flagged)."""
        first = _read_exact(src, 1)
        if first is None:
            return None
        if first == b"\x00":  # the shm doorbell — opaque, pass through
            return first
        rest = _read_exact(src, wire._PREFIX.size - 1)
        if rest is None:
            return None
        head = first + rest
        magic, _kind, flags, meta_len, body_len = wire._PREFIX.unpack(head)
        if magic != wire.MAGIC:
            raise ValueError("non-SDW2 bytes through fault proxy")
        tail = wire._CRC.size if flags & wire.FLAG_CRC else 0
        payload = _read_exact(src, meta_len + body_len + tail)
        if payload is None:
            return None
        return head + payload

    def _apply(self, rle: inject.Rule, frame: bytes,
               src: socket.socket, dst: socket.socket) -> Optional[bytes]:
        _count_injected()
        if rle.stall_s is not None:
            time.sleep(rle.stall_s)
            return frame
        verb = rle.act if rle.act is not None else "disconnect"
        if verb == "disconnect" or rle.error is not None or rle.kill:
            # a proxy can't raise into either process — every
            # non-byte-level action degrades to tearing the wire down
            self._kill_pair(src, dst)
            return None
        if verb == "midframe_disconnect":
            try:
                dst.sendall(frame[: max(1, len(frame) // 2)])
            except OSError:
                pass
            self._kill_pair(src, dst)
            return None
        if verb == "drop" or verb == "drop_reply":
            return b""
        if verb == "corrupt_body":
            mid = wire._PREFIX.size + (len(frame) - wire._PREFIX.size) // 2
            buf = bytearray(frame)
            buf[mid % len(buf)] ^= 0x40
            return bytes(buf)
        if verb == "corrupt_header":
            buf = bytearray(frame)
            buf[10] ^= 0x40  # body_len MSB — see _apply_tx_verb
            return bytes(buf)
        if verb == "truncate":
            return frame[: max(wire._PREFIX.size + 1, len(frame) // 2)]
        if verb == "dup":
            return frame + frame
        raise ValueError(f"unknown faultnet proxy verb {verb!r}")

    @staticmethod
    def _kill_pair(a: socket.socket, b: socket.socket) -> None:
        for sock in (a, b):
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                sock.close()
            except OSError:
                pass

    def close(self) -> None:
        self._closed = True
        try:
            self._listener.close()
        except OSError:
            pass
        with self._lock:
            conns, self._conns = self._conns, []
        for sock in conns:
            try:
                sock.close()
            except OSError:
                pass
