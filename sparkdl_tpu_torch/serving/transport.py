"""Transport seam for the replica wire: TCP and shared-memory lanes.

Port of ``sparkdl_tpu.serving.transport`` (host code: a copy with the
package renamed). :mod:`~sparkdl_tpu_torch.serving.wire` defines *what* crosses the process
boundary (typed zero-copy frames); this module defines *how*.  The
router, replica, and supervisor talk only to the :class:`Transport`
protocol, so a future RDMA or cross-host lane is one new subclass —
today there are two:

``TcpTransport``
    Loopback TCP.  By default requests that pile up while one frame's
    round trip is in flight are group-committed into a single
    ``KIND_BATCH`` frame (the coalescer) — one syscall and one frame
    prefix amortized over N small requests, with no added idle latency
    (the flush window defaults to the in-flight RTT itself).

``ShmTransport``
    A ``multiprocessing.shared_memory`` segment holding two SPSC byte
    rings (request + reply), negotiated per-connection over a TCP
    side-channel with a ``shm_attach`` handshake.  The *router* creates
    and unlinks the segment, so a SIGKILLed replica can never leak
    ``/dev/shm`` entries.  The TCP socket stays open as the liveness
    signal (a killed replica's kernel closes it — the poll loop sees
    EOF and raises ``ConnectionError``, the router's retry trigger)
    and as the spill lane for frames larger than the ring.  If the
    replica refuses the handshake (``SPARKDL_WIRE_SHM_DISABLE=1``) or
    shm is unusable, the transport falls back to plain TCP permanently
    for that backend and counts ``wire.shm.fallback``.

Ring cursors are free-running u64 byte counters at the segment head,
8-byte aligned so each cross-process load/store is a single word copy;
the writer publishes its cursor only after the record bytes land
(store ordering holds on the x86/TSO hosts this intra-host lane
targets).  Negotiation: a replica advertises its lanes in the ready
line, the supervisor forwards them to ``router.add``, and
``SPARKDL_WIRE_TRANSPORT`` (``auto``/``tcp``/``shm``) picks the lane
on the router side.

Every request is stamped with a per-channel ``seq`` number the reply
must echo; a reply carrying the wrong ``seq`` (a duplicated frame, a
desynced stream) is refused as ``ConnectionError`` and the channel is
dropped — a stale reply can never be returned for the wrong request.

Env knobs (constructor args override)::

    SPARKDL_WIRE_TRANSPORT      auto | tcp | shm        (default auto)
    SPARKDL_WIRE_SHM_DISABLE    "1": replica refuses shm (default 0)
    SPARKDL_WIRE_SHM_RING       per-direction ring bytes (default 1MiB)
    SPARKDL_WIRE_COALESCE       "0" disables TCP group commit
    SPARKDL_WIRE_COALESCE_MS    extra flush window, ms   (default 0)
    SPARKDL_WIRE_POOL_IDLE_S    pooled-socket age-out    (default 30)
    SPARKDL_SEND_TIMEOUT_S      server->client shm send bound (default 30)
    SPARKDL_WIRE_EVENTFD        "0" forces socket doorbells (default 1)
    SPARKDL_FAULTNET            "1": wrap transports in FaultyTransport
"""

from __future__ import annotations

import abc
import contextlib
import itertools
import os
import select
import socket
import struct
import sys
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from sparkdl_tpu_torch.resilience import inject
from sparkdl_tpu_torch.serving import wire
from sparkdl_tpu_torch.utils.metrics import metrics

ENV_TRANSPORT = "SPARKDL_WIRE_TRANSPORT"      # auto | tcp | shm (router side)
ENV_SHM_DISABLE = "SPARKDL_WIRE_SHM_DISABLE"  # replica-side refusal
ENV_RING_BYTES = "SPARKDL_WIRE_SHM_RING"      # per-direction ring capacity
ENV_COALESCE = "SPARKDL_WIRE_COALESCE"        # "0" disables TCP coalescing
ENV_COALESCE_MS = "SPARKDL_WIRE_COALESCE_MS"  # extra flush window (default 0)
ENV_POOL_IDLE_S = "SPARKDL_WIRE_POOL_IDLE_S"  # pooled-socket age-out window
ENV_SEND_TIMEOUT_S = "SPARKDL_SEND_TIMEOUT_S"  # server->client send bound
ENV_EVENTFD = "SPARKDL_WIRE_EVENTFD"          # "0" forces socket doorbells
ENV_FAULTNET = "SPARKDL_FAULTNET"             # wrap lanes in FaultyTransport

#: discard pooled sockets idle longer than this — a replica that was
#: replaced behind the same name while traffic was quiet should cost a
#: dial, not a retry
DEFAULT_POOL_IDLE_S = 30.0

DEFAULT_RING_BYTES = 1 << 20
_POLL_SPIN = 32           # busy polls before blocking on the doorbell
_POLL_SLEEP_S = 0.0001
_SERVER_SEND_TIMEOUT_S = float(
    os.environ.get(ENV_SEND_TIMEOUT_S, "30.0")
)

#: one byte rung on the TCP side-channel to wake a peer that advertised
#: (via the ring's waiter flag) that it is blocked in select().  0x00
#: can never open a real frame — wire.MAGIC starts with b"S" — so a
#: reader can always tell a doorbell from a spilled frame by peeking.
#: When both ends support it (Linux, negotiated at ``shm_attach``), the
#: wake rides a pair of ``eventfd``\ s instead — one write syscall, no
#: TCP stack, nothing to drain past an 8-byte counter reset — with this
#: socket byte kept as the universal fallback.  Per-wake lane counts
#: land in ``wire.doorbell.eventfd`` / ``wire.doorbell.socket``.
_DOORBELL = b"\x00"


def _eventfd_wanted() -> bool:
    """Whether this end should offer/accept eventfd doorbells: needs
    ``os.eventfd`` + SCM_RIGHTS fd passing (Linux, py>=3.10) and the
    ``SPARKDL_WIRE_EVENTFD=0`` kill switch left alone."""
    return (
        os.environ.get(ENV_EVENTFD, "1").strip() != "0"
        and hasattr(os, "eventfd")
        and hasattr(socket, "send_fds")
    )
#: select() timeouts while a waiter flag is up.  These bound the cost of
#: the one unfenced store-load race in the doorbell protocol (waiter
#: store vs. head load can reorder through the store buffer): a missed
#: doorbell costs one timeout tick, not a hang.
_CLIENT_WAIT_S = 0.002
_SERVER_WAIT_S = 0.02
#: a coalescer follower's re-poll tick — only hit when a leader exits
#: with work still queued and no new arrival takes the socket over
_FOLLOWER_TICK_S = 0.001

_REC_LEN = struct.Struct("<I")
_seg_seq = itertools.count()
_segments_lock = threading.Lock()
_active_segments: set = set()


def shm_supported() -> bool:
    try:
        import multiprocessing.shared_memory  # noqa: F401
        return True
    except Exception:
        return False


def active_segments() -> List[str]:
    """Names of shm segments this process has created and not yet
    unlinked — the kill-matrix leak assertion reads this (and
    ``/dev/shm``) after tearing a lane down."""
    with _segments_lock:
        return sorted(_active_segments)


_tracker_lock = threading.Lock()


@contextlib.contextmanager
def _untracked_shm():
    """*Attach* to a ``SharedMemory`` without resource_tracker
    registration (3.10 has no ``track=`` opt-out).  The creator keeps
    default tracking — its ``unlink()`` unregisters symmetrically, and
    a SIGKILLed creator's surviving tracker still reaps the segment —
    but an attacher must not register: it never unlinks, so its entry
    would make the tracker unlink a shared segment a *second* time at
    interpreter exit."""
    try:
        from multiprocessing import resource_tracker
    except Exception:
        yield
        return
    with _tracker_lock:
        orig = resource_tracker.register

        def register(name, rtype):
            if rtype != "shared_memory":
                orig(name, rtype)

        resource_tracker.register = register
        try:
            yield
        finally:
            resource_tracker.register = orig


class Transport(abc.ABC):
    """One replica endpoint as seen by the router: a synchronous
    request/reply channel that raises ``ConnectionError`` /
    ``socket.timeout`` when the backend should be retried elsewhere."""

    @property
    @abc.abstractmethod
    def lane(self) -> str:
        """The lane currently carrying requests (``"tcp"``/``"shm"``)."""

    @abc.abstractmethod
    def request(self, msg: Dict[str, Any], timeout_s: float) -> Dict[str, Any]:
        """Send one envelope, return the reply envelope."""

    def stream(
        self,
        msg: Dict[str, Any],
        on_frame: Callable[[Dict[str, Any]], Any],
        timeout_s: float,
    ) -> Dict[str, Any]:
        """One decode stream: send ``msg``, forward each partial
        :data:`~sparkdl_tpu_torch.serving.wire.KIND_STREAM` frame to
        ``on_frame`` as it arrives, return the ``final: True`` envelope.
        The stream is pinned to this backend for its whole life — a
        failure mid-stream raises (``ConnectionError`` / typed) and the
        channel is dropped, never reused.  Lanes without an
        implementation are stream-incapable."""
        raise NotImplementedError(
            f"{type(self).__name__} cannot carry decode streams"
        )

    @abc.abstractmethod
    def close(self) -> None:
        """Release sockets/segments; in-flight requests fail fast."""


def make_transport(
    host: str,
    port: int,
    lanes: Sequence[str] = ("tcp",),
    connect_timeout_s: float = 2.0,
    io_timeout_s: float = 30.0,
    mode: Optional[str] = None,
) -> Transport:
    """Pick a lane for a backend advertising ``lanes``, honouring
    ``SPARKDL_WIRE_TRANSPORT`` (``auto`` prefers shm when offered)."""
    mode = mode or os.environ.get(ENV_TRANSPORT, "auto")
    if mode not in ("auto", "tcp", "shm"):
        raise ValueError(f"unknown wire transport mode {mode!r}")
    picked: Transport
    if mode != "tcp" and "shm" in lanes and shm_supported():
        picked = ShmTransport(host, port, connect_timeout_s, io_timeout_s)
    else:
        if mode == "shm":
            # explicitly requested but the replica does not offer it —
            # the transparent-fallback contract still applies
            metrics.counter("wire.shm.fallback").add(1)
        picked = TcpTransport(host, port, connect_timeout_s, io_timeout_s)
    if os.environ.get(ENV_FAULTNET, "0") == "1":
        # lazy import: faultnet imports this module for the Transport
        # protocol, and the wrap only exists under an active chaos run
        from sparkdl_tpu_torch.serving.faultnet import FaultyTransport

        picked = FaultyTransport(picked)
    return picked


# ---------------------------------------------------------------------------
# TCP lane


def _stamp_wire(reply: Any, wire_ms: float) -> Any:
    """Record the client-side serialize+send cost of THIS request into
    the reply's ``phases`` dict (created if the replica sent none) — the
    ``wire`` slice of the per-request latency decomposition.  Non-dict
    replies pass through untouched (the router rejects them anyway)."""
    if isinstance(reply, dict):
        phases = reply.get("phases")
        if isinstance(phases, dict):
            phases["wire"] = wire_ms
        else:
            reply["phases"] = {"wire": wire_ms}
    return reply


#: process-wide request sequence — uniqueness across every channel in
#: the process is what makes a cross-channel mixup detectable too
_req_seq = itertools.count(1)


def _stamp_seq(msg: Dict[str, Any]) -> Tuple[Dict[str, Any], int]:
    """Shallow-copy ``msg`` with the next request sequence number — the
    caller's dict is never mutated, so a hedge/retry re-stamps its own
    copy and replies can be matched to the exact attempt."""
    seq = next(_req_seq)
    stamped = dict(msg)
    stamped["seq"] = seq
    return stamped, seq


def _consume_stream(
    next_frame: Callable[[], Tuple[int, Any]],
    on_frame: Callable[[Dict[str, Any]], Any],
    seq: int,
    wire_ms: float,
) -> Dict[str, Any]:
    """Drive one decode stream off ``next_frame()`` until its terminal
    frame — the client half of the streaming contract, shared by the
    tcp and shm lanes.  Every frame must be ``KIND_STREAM``, echo our
    ``seq``, and carry a gap-free 0-based ``stream_seq``; a typed error
    frame raises the decoded error, a protocol violation raises
    ``ConnectionError`` (the caller drops the channel).  Partial frames
    are handed to ``on_frame`` in arrival order; the ``final: True``
    envelope is returned with the wire phase stamped."""
    expect = 0
    while True:
        kind, frame = next_frame()
        if kind != wire.KIND_STREAM or not isinstance(frame, dict):
            raise ConnectionError(
                "non-stream frame on a decode stream channel"
            )
        if not frame.get("ok", True) or frame.get("error_class"):
            # the replica ended the stream with a typed error frame —
            # surface the error itself, not a protocol complaint
            raise wire.decode_error(frame)
        _check_seq(frame, seq)
        if frame.get("stream_seq") != expect:
            raise ConnectionError(
                f"stream desync: expected stream_seq {expect}, frame "
                f"carries {frame.get('stream_seq')!r}"
            )
        expect += 1
        if frame.get("final"):
            return _stamp_wire(frame, wire_ms)
        on_frame(frame)


def _check_seq(reply: Any, seq: int) -> Any:
    """Refuse a reply that does not echo our ``seq``: a duplicated
    frame or a desynced reply stream must surface as a retryable
    ``ConnectionError`` (the channel is dropped by the caller), never
    as the wrong request's tensor."""
    if isinstance(reply, dict) and reply.get("seq", seq) != seq:
        raise ConnectionError(
            f"reply desync: sent seq {seq}, reply echoes "
            f"{reply.get('seq')!r} — duplicated or reordered frame"
        )
    return reply


def _sock_is_stale(sock) -> bool:
    """True when a pooled *idle* socket must not carry the next request.
    The wire protocol is strictly request/reply, so an idle socket with
    readable data is either EOF (the replica died while the socket sat
    pooled) or a torn stream — both mean dial fresh.  Without this
    probe a whole pool of sockets to a dead replica fails one request
    each before the pool empties (a staleness burst)."""
    try:
        readable, _, _ = select.select([sock], [], [], 0)
    except (OSError, ValueError):
        return True
    return bool(readable)


class _Slot:
    __slots__ = ("msg", "seq", "deadline", "done", "reply", "exc")

    def __init__(self, msg: Dict[str, Any], seq: int, deadline: float):
        self.msg = msg
        self.seq = seq
        self.deadline = deadline
        self.done = threading.Event()
        self.reply: Optional[Dict[str, Any]] = None
        self.exc: Optional[BaseException] = None


class _Coalescer:
    """Group-commit sender over one socket, leader/follower style: a
    requester that finds the socket free runs the round trip inline on
    its own thread — a lone request pays ZERO thread handoffs, same as
    a plain pooled socket — while requesters arriving during an
    in-flight round trip queue up and ride the next ``KIND_BATCH``
    frame together.  Batching is RTT-driven: the longer the in-flight
    round trip, the more followers the next frame carries."""

    def __init__(self, host: str, port: int, connect_timeout_s: float,
                 io_timeout_s: float, flush_s: float, max_batch: int = 64):
        self._host, self._port = host, port
        self._connect_timeout_s = connect_timeout_s
        self._io_timeout_s = io_timeout_s
        self._flush_s = flush_s
        self._max_batch = max_batch
        self._lock = threading.Lock()      # guards queue + closed
        self._io = threading.Lock()        # held by the current leader
        self._pace = threading.Event()     # never set: gather-window nap
        self._queue: List[_Slot] = []
        self._closed = False
        self._sock: Optional[socket.socket] = None

    def request(self, msg: Dict[str, Any], timeout_s: float) -> Dict[str, Any]:
        deadline = time.monotonic() + timeout_s
        slot = _Slot(*_stamp_seq(msg), deadline)
        with self._lock:
            if self._closed:
                raise ConnectionError("transport closed")
            self._queue.append(slot)
        while not slot.done.is_set():
            if not self._io.acquire(blocking=False):
                # a leader is mid-flight; it takes the queue — us
                # included — on its next drain.  The tick only matters
                # in the rare case a leader returns with work still
                # queued and nobody new arrives to take over.
                if slot.done.wait(_FOLLOWER_TICK_S):
                    break
                if time.monotonic() > deadline:
                    with self._lock:
                        if slot in self._queue:
                            self._queue.remove(slot)
                    raise socket.timeout(
                        f"no reply within {timeout_s:.1f}s "
                        "(coalesced tcp lane)"
                    )
                continue
            try:
                self._lead(slot)  # leader: our slot is done on return
            finally:
                self._io.release()
        if slot.exc is not None:
            raise slot.exc
        assert slot.reply is not None
        return slot.reply

    def _lead(self, own: _Slot) -> None:
        """Drain the queue in max_batch frames until our own slot has
        its reply, then hand the socket back (stranded followers retake
        it on their next tick; new arrivals try the lock immediately)."""
        while not own.done.is_set():
            if self._flush_s > 0:
                with self._lock:
                    short = len(self._queue) < self._max_batch
                if short:
                    self._pace.wait(self._flush_s)  # explicit gather window
            with self._lock:
                batch = self._queue[: self._max_batch]
                del self._queue[: len(batch)]
            if not batch:
                return
            self._roundtrip(batch)

    def _roundtrip(self, batch: List[_Slot]) -> None:
        try:
            sock = self._sock
            if sock is not None and _sock_is_stale(sock):
                # the replica died while the lane was idle between
                # round trips: pay a fresh dial here, not a failed
                # batch surfacing as ConnectionError retries
                metrics.counter("wire.pool.stale").add(1)
                self._drop_sock()
                sock = None
            if sock is None:
                sock = wire.connect(
                    self._host, self._port, self._connect_timeout_s
                )
                self._sock = sock
            # the leader blocks in recv on behalf of every rider: bound
            # the wait by the tightest deadline in the batch so a
            # stalled socket surfaces as a typed timeout while the
            # riders' end-to-end budgets can still buy a retry
            remaining = min(s.deadline for s in batch) - time.monotonic()
            sock.settimeout(
                min(self._io_timeout_s, max(0.05, remaining))
            )
            t0 = time.perf_counter()
            if len(batch) == 1:
                wire.sendall_parts(
                    sock, wire.encode_parts(batch[0].msg, wire.KIND_MSG)
                )
                wire_ms = (time.perf_counter() - t0) * 1000.0
                reply = wire.recv_msg(sock)
                if reply is None:
                    raise ConnectionError("replica closed connection mid-request")
                replies = [reply]
            else:
                wire.sendall_parts(
                    sock,
                    wire.encode_parts([s.msg for s in batch], wire.KIND_BATCH),
                )
                # the frame cost is shared — attribute an equal share of
                # serialize+send to each coalesced rider
                wire_ms = (time.perf_counter() - t0) * 1000.0 / len(batch)
                got = wire.recv_any(sock)
                if got is None:
                    raise ConnectionError("replica closed connection mid-batch")
                kind, replies = got
                if (kind != wire.KIND_BATCH or not isinstance(replies, list)
                        or len(replies) != len(batch)):
                    raise ConnectionError("reply batch shape mismatch")
                metrics.counter("wire.coalesced_msgs").add(len(batch))
                metrics.counter("wire.batch_frames").add(1)
        except Exception as exc:
            self._drop_sock()
            self._fail(batch, exc)
            return
        try:
            # verify every echo before releasing ANY waiter: a desynced
            # stream invalidates the whole frame, not just one slot
            for slot, reply in zip(batch, replies):
                _check_seq(reply, slot.seq)
        except ConnectionError as exc:
            self._drop_sock()
            self._fail(batch, exc)
            return
        for slot, reply in zip(batch, replies):
            slot.reply = _stamp_wire(reply, wire_ms)
            slot.done.set()

    @staticmethod
    def _fail(batch: List[_Slot], exc: BaseException) -> None:
        # a refused connection keeps its type: the router passes a backend
        # that refuses over for a while
        kind = ConnectionRefusedError if isinstance(exc, ConnectionRefusedError) \
            else ConnectionError
        for slot in batch:
            # a fresh instance per waiter: exceptions are mutable and
            # these are raised concurrently in N caller threads
            slot.exc = kind(f"coalesced tcp lane failed: {exc}")
            slot.done.set()

    def _drop_sock(self) -> None:
        sock, self._sock = self._sock, None
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass

    def close(self) -> None:
        with self._lock:
            self._closed = True
            stranded = self._queue[:]
            del self._queue[:]
        self._fail(stranded, ConnectionError("transport closed"))
        # closing the fd interrupts a leader blocked in recv; it fails
        # its batch and unwinds on its own (no join: callers hold the
        # router lock)
        self._drop_sock()


class TcpTransport(Transport):
    """Pooled loopback-TCP lane; coalescing on by default (disable with
    ``SPARKDL_WIRE_COALESCE=0`` to get one pooled socket per caller)."""

    def __init__(self, host: str, port: int, connect_timeout_s: float = 2.0,
                 io_timeout_s: float = 30.0, max_idle: int = 8,
                 coalesce: Optional[bool] = None):
        self._host, self._port = host, port
        self._connect_timeout_s = connect_timeout_s
        self._io_timeout_s = io_timeout_s
        self._max_idle = max_idle
        self._max_idle_s = float(
            os.environ.get(ENV_POOL_IDLE_S, str(DEFAULT_POOL_IDLE_S))
        )
        self._lock = threading.Lock()
        self._idle: List[Tuple[socket.socket, float]] = []
        self._closed = False
        if coalesce is None:
            coalesce = os.environ.get(ENV_COALESCE, "1") != "0"
        flush_s = float(os.environ.get(ENV_COALESCE_MS, "0")) / 1000.0
        self._coalescer = (
            _Coalescer(host, port, connect_timeout_s, io_timeout_s, flush_s)
            if coalesce else None
        )

    @property
    def lane(self) -> str:
        return "tcp"

    def request(self, msg: Dict[str, Any], timeout_s: float) -> Dict[str, Any]:
        if self._coalescer is not None:
            return self._coalescer.request(msg, timeout_s)
        sock = self._checkout()
        msg, seq = _stamp_seq(msg)
        try:
            sock.settimeout(timeout_s)
            t0 = time.perf_counter()
            wire.sendall_parts(sock, wire.encode_parts(msg, wire.KIND_MSG))
            wire_ms = (time.perf_counter() - t0) * 1000.0
            reply = wire.recv_msg(sock)
            if reply is not None:
                _check_seq(reply, seq)
        except BaseException:
            try:
                sock.close()
            except OSError:
                pass
            raise
        if reply is None:
            try:
                sock.close()
            except OSError:
                pass
            raise ConnectionError("replica closed connection mid-request")
        self._checkin(sock)
        return _stamp_wire(reply, wire_ms)

    def stream(
        self,
        msg: Dict[str, Any],
        on_frame: Callable[[Dict[str, Any]], Any],
        timeout_s: float,
    ) -> Dict[str, Any]:
        """One decode stream over a DEDICATED pooled socket.  The
        coalescer is strictly request/reply, so streams always bypass
        it; the socket returns to the pool only after a clean final
        frame (a torn stream closes it — half-consumed frames must
        never leak into the next request)."""
        sock = self._checkout()
        msg, seq = _stamp_seq(msg)
        deadline = time.monotonic() + timeout_s
        try:
            sock.settimeout(timeout_s)
            t0 = time.perf_counter()
            wire.sendall_parts(sock, wire.encode_parts(msg, wire.KIND_MSG))
            wire_ms = (time.perf_counter() - t0) * 1000.0

            def next_frame() -> Tuple[int, Any]:
                sock.settimeout(min(
                    self._io_timeout_s,
                    max(0.05, deadline - time.monotonic()),
                ))
                got = wire.recv_any(sock)
                if got is None:
                    raise ConnectionError(
                        "replica closed connection mid-stream"
                    )
                return got

            reply = _consume_stream(next_frame, on_frame, seq, wire_ms)
        except BaseException:
            try:
                sock.close()
            except OSError:
                pass
            raise
        self._checkin(sock)
        return reply

    def _checkout(self) -> socket.socket:
        """A pooled socket proven idle-healthy, or a fresh dial.  Aged
        and stale entries are discarded here (probe outside the lock —
        select is a syscall) so replica death during a quiet spell costs
        a dial, never a user-visible error burst."""
        now = time.monotonic()
        while True:
            with self._lock:
                if self._closed:
                    raise ConnectionError("transport closed")
                if not self._idle:
                    break
                sock, idle_since = self._idle.pop()
            if now - idle_since > self._max_idle_s:
                metrics.counter("wire.pool.aged").add(1)
            elif not _sock_is_stale(sock):
                return sock
            else:
                metrics.counter("wire.pool.stale").add(1)
            try:
                sock.close()
            except OSError:
                pass
        return wire.connect(self._host, self._port, self._connect_timeout_s)

    def _checkin(self, sock: socket.socket) -> None:
        with self._lock:
            if not self._closed and len(self._idle) < self._max_idle:
                self._idle.append((sock, time.monotonic()))
                return
        try:
            sock.close()
        except OSError:
            pass

    def close(self) -> None:
        with self._lock:
            self._closed = True
            idle, self._idle = self._idle, []
        for sock, _ in idle:
            try:
                sock.close()
            except OSError:
                pass
        if self._coalescer is not None:
            self._coalescer.close()


# ---------------------------------------------------------------------------
# shared-memory lane


class _ShmUnavailable(Exception):
    """shm could not be negotiated — fall back to TCP (NOT a retry
    trigger: the backend itself is healthy)."""


class _Ring:
    """SPSC byte ring inside a shared segment: ``[head u64][tail u64]
    [waiter u32][pad u32][data ...]``.  Cursors are free-running byte
    counters (no modulo ambiguity between full and empty); records are
    ``u32 length`` + payload, wrapping byte-wise.

    ``waiter`` is the doorbell contract: the *consumer* raises it just
    before blocking in ``select()`` on the TCP side-channel, and the
    producer, after publishing a record, rings one :data:`_DOORBELL`
    byte iff the flag is up — so neither side ever busy-polls a quiet
    ring, and an idle lane costs zero CPU."""

    HDR = 24

    def __init__(self, buf: memoryview, base: int, capacity: int):
        self._buf = buf
        self._base = base
        self._cap = capacity
        self._data = buf[base + self.HDR: base + self.HDR + capacity]

    @property
    def capacity(self) -> int:
        return self._cap

    def fits(self, nbytes: int) -> bool:
        return 4 + nbytes <= self._cap

    def _load(self, off: int) -> int:
        return struct.unpack_from("<Q", self._buf, self._base + off)[0]

    def _store(self, off: int, value: int) -> None:
        struct.pack_into("<Q", self._buf, self._base + off, value)

    @property
    def waiter(self) -> bool:
        return struct.unpack_from("<I", self._buf, self._base + 16)[0] != 0

    def set_waiter(self, up: bool) -> None:
        struct.pack_into("<I", self._buf, self._base + 16, 1 if up else 0)

    def try_write(self, parts: Sequence[Any], total: int) -> bool:
        head, tail = self._load(0), self._load(8)
        need = 4 + total
        if self._cap - (head - tail) < need:
            return False
        pos = self._put(head % self._cap, _REC_LEN.pack(total))
        for part in parts:
            pos = self._put(pos, part)
        self._store(0, head + need)  # publish only after the bytes land
        return True

    def _put(self, pos: int, buf: Any) -> int:
        mv = buf if isinstance(buf, memoryview) else memoryview(buf)
        n = len(mv)
        first = min(n, self._cap - pos)
        self._data[pos:pos + first] = mv[:first]
        if n > first:
            self._data[0:n - first] = mv[first:]
        return (pos + n) % self._cap

    def readable(self) -> bool:
        """A record is ready (nothing consumed — the waiter-flag
        re-check must not race the actual read)."""
        head, tail = self._load(0), self._load(8)
        return head - tail >= 4

    def try_read(self) -> Optional[bytearray]:
        head, tail = self._load(0), self._load(8)
        if head - tail < 4:
            return None
        lenbuf = bytearray(4)
        self._get(tail % self._cap, memoryview(lenbuf))
        (n,) = _REC_LEN.unpack(bytes(lenbuf))
        out = bytearray(n)
        self._get((tail + 4) % self._cap, memoryview(out))
        self._store(8, tail + 4 + n)
        return out

    def _get(self, pos: int, view: memoryview) -> None:
        n = len(view)
        first = min(n, self._cap - pos)
        view[:first] = self._data[pos:pos + first]
        if n > first:
            view[first:] = self._data[0:n - first]

    def release(self) -> None:
        self._data.release()


def _await_doorbell(
    sock, wait_s: float, efd: Optional[int] = None
) -> Optional[Tuple[int, Any]]:
    """Block up to ``wait_s`` for a doorbell: the cheap half of the
    doorbell contract.  A doorbell (eventfd tick when ``efd`` was
    negotiated, else one byte on the TCP side-channel) is consumed
    right here — a wake costs one syscall and leaves nothing stale
    behind — and means "check your ring" (returns None).  A spilled
    frame is read whole off the socket and returned.  EOF or a dead
    socket raises ConnectionError (the side-channel doubles as the
    liveness signal even when wakes ride the eventfd), and a quiet
    wait returns None after the timeout so the caller re-polls its
    ring — the bounded wait is what closes the one unfenced
    waiter-flag store/load race."""
    if efd is not None:
        try:
            readable, _, _ = select.select([sock, efd], [], [], wait_s)
        except (OSError, ValueError) as exc:
            raise ConnectionError(f"shm side-channel failed: {exc}")
        if efd in readable:
            try:
                os.eventfd_read(efd)  # reset the counter: wake consumed
            except BlockingIOError:
                pass  # raced another reset; the wake still happened
            except OSError as exc:
                raise ConnectionError(f"eventfd doorbell failed: {exc}")
        if sock not in readable:
            return None
        # socket bytes pending (legacy doorbell / spill / EOF): fall
        # through — the recv below returns immediately
    prev = sock.gettimeout()
    sock.settimeout(wait_s)
    try:
        first = sock.recv(1)
    except socket.timeout:
        return None
    except (OSError, ValueError) as exc:
        raise ConnectionError(f"shm side-channel failed: {exc}")
    finally:
        sock.settimeout(prev)
    if first == b"":
        raise ConnectionError("peer closed shm side-channel")
    if first == _DOORBELL:
        return None
    got = wire.recv_any(sock, first=first)
    if got is None:
        raise ConnectionError("peer closed shm side-channel")
    return got


def _drain_side_channel(sock) -> Optional[Tuple[int, Any]]:
    """Consume whatever is pending on the TCP side-channel without
    blocking: doorbell bytes are swallowed (they only mean "check your
    ring"), a spilled frame is returned whole, EOF or a dead socket
    raises ConnectionError — the side-channel doubles as the liveness
    signal for the shm lane."""
    while True:
        try:
            readable, _, _ = select.select([sock], [], [], 0)
        except (OSError, ValueError):
            raise ConnectionError("shm side-channel torn down")
        if not readable:
            return None
        try:
            first = sock.recv(1, socket.MSG_PEEK)
        except OSError as exc:
            raise ConnectionError(f"shm side-channel failed: {exc}")
        if first == b"":
            raise ConnectionError("peer closed shm side-channel")
        if first == _DOORBELL:
            sock.recv(1)
            continue
        got = wire.recv_any(sock)
        if got is None:
            raise ConnectionError("peer closed shm side-channel")
        return got


class _ShmClientChannel:
    """Router side of one shm connection: creates the segment, attaches
    it to the replica over the TCP side-channel, then runs synchronous
    request/reply through the rings — doorbell-woken, so a waiting side
    blocks in select() instead of burning the GIL — with the socket as
    liveness signal and big-frame spill lane."""

    def __init__(self, host: str, port: int, connect_timeout_s: float,
                 io_timeout_s: float, ring_bytes: int):
        self._io_timeout_s = io_timeout_s
        self._wake = threading.Event()  # never set: an interruptible nap
        self._seg = None
        self._tx: Optional[_Ring] = None
        self._rx: Optional[_Ring] = None
        self._efd_tx: Optional[int] = None  # we write: rings the replica
        self._efd_rx: Optional[int] = None  # we read: replica rings us
        self._sock = wire.connect(host, port, connect_timeout_s)
        try:
            self._sock.settimeout(io_timeout_s)
            try:
                from multiprocessing import shared_memory
                name = f"sdw_{os.getpid()}_{next(_seg_seq)}"
                # under _tracker_lock: an in-process attacher patching
                # tracker registration away must not swallow ours
                with _tracker_lock:
                    self._seg = shared_memory.SharedMemory(
                        create=True, name=name,
                        size=2 * (_Ring.HDR + ring_bytes),
                    )
            except Exception as exc:
                raise _ShmUnavailable(f"cannot create shm segment: {exc}")
            with _segments_lock:
                _active_segments.add(self._seg.name)
            buf = self._seg.buf
            self._tx = _Ring(buf, 0, ring_bytes)
            self._rx = _Ring(buf, _Ring.HDR + ring_bytes, ring_bytes)
            # eventfd doorbell offer: an abstract-namespace AF_UNIX
            # listener (no filesystem entry to leak) whose name rides
            # the attach message; a capable replica connects and passes
            # two eventfds over it via SCM_RIGHTS.  Any failure at any
            # step degrades silently to the socket doorbell — legacy
            # replicas simply ignore the "efd" field.
            efd_listener = None
            efd_name = None
            if _eventfd_wanted():
                try:
                    efd_listener = socket.socket(
                        socket.AF_UNIX, socket.SOCK_STREAM
                    )
                    efd_name = f"sdw_efd_{os.getpid()}_{next(_seg_seq)}"
                    efd_listener.bind("\0" + efd_name)
                    efd_listener.listen(1)
                except OSError:
                    if efd_listener is not None:
                        efd_listener.close()
                    efd_listener = None
                    efd_name = None
            try:
                attach = {
                    "op": "shm_attach",
                    "shm": self._seg.name,
                    "ring_bytes": ring_bytes,
                }
                if efd_name is not None:
                    attach["efd"] = efd_name
                wire.send_msg(self._sock, attach)
                reply = wire.recv_msg(self._sock)
                if reply is None:
                    raise ConnectionError(
                        "replica closed during shm handshake"
                    )
                if not reply.get("ok"):
                    raise _ShmUnavailable(
                        reply.get("error", "replica refused shm lane")
                    )
                if reply.get("eventfd") and efd_listener is not None:
                    try:
                        efd_listener.settimeout(connect_timeout_s)
                        conn, _ = efd_listener.accept()
                        try:
                            _, fds, _, _ = socket.recv_fds(conn, 1, 2)
                        finally:
                            conn.close()
                        if len(fds) == 2:
                            self._efd_tx, self._efd_rx = fds[0], fds[1]
                        else:  # truncated SCM_RIGHTS: refuse the lane
                            for fd in fds:
                                os.close(fd)
                    except OSError:
                        self._close_efds()  # socket doorbell it is
            finally:
                if efd_listener is not None:
                    efd_listener.close()
            metrics.counter("wire.shm.attach").add(1)
        except BaseException:
            self.close()
            raise

    def request(self, msg: Dict[str, Any], timeout_s: float) -> Dict[str, Any]:
        inject.fire("wire.shm")
        deadline = time.monotonic() + timeout_s
        t0 = time.perf_counter()
        msg, seq = _stamp_seq(msg)
        parts = wire.encode_parts(msg, wire.KIND_MSG)
        self._write_request(parts, wire.parts_len(parts), deadline)
        wire_ms = (time.perf_counter() - t0) * 1000.0
        kind, obj = self._next_frame(deadline)
        if kind != wire.KIND_MSG:
            raise ConnectionError("unexpected batch frame on shm ring")
        return _stamp_wire(_check_seq(obj, seq), wire_ms)

    def stream(
        self,
        msg: Dict[str, Any],
        on_frame: Callable[[Dict[str, Any]], Any],
        timeout_s: float,
    ) -> Dict[str, Any]:
        """One decode stream over this shm channel: the request rides
        the tx ring (or spills), and each ``KIND_STREAM`` frame comes
        back as its own ring record — same doorbell wake, same CRC and
        seq-echo discipline as request/reply, just 0+N frames instead
        of exactly one."""
        inject.fire("wire.shm")
        deadline = time.monotonic() + timeout_s
        t0 = time.perf_counter()
        msg, seq = _stamp_seq(msg)
        parts = wire.encode_parts(msg, wire.KIND_MSG)
        self._write_request(parts, wire.parts_len(parts), deadline)
        wire_ms = (time.perf_counter() - t0) * 1000.0
        return _consume_stream(
            lambda: self._next_frame(deadline), on_frame, seq, wire_ms
        )

    def _write_request(self, parts, total: int, deadline: float) -> None:
        """Publish one encoded request: onto the tx ring when it fits
        (doorbell if the replica advertised a wait), spilled whole onto
        the TCP side-channel when it doesn't."""
        assert self._tx is not None and self._rx is not None
        if self._tx.fits(total):
            while not self._tx.try_write(parts, total):
                # ring full: the replica has stopped draining requests
                if _drain_side_channel(self._sock) is not None:
                    raise ConnectionError(
                        "unexpected frame while shm ring was full"
                    )
                if time.monotonic() > deadline:
                    raise socket.timeout(
                        "shm ring stayed full past request deadline"
                    )
                self._wake.wait(_POLL_SLEEP_S)
            if self._tx.waiter:
                self._ring_doorbell()
        else:
            # oversized frame: spill onto the TCP side-channel (the
            # frame itself wakes the replica — no doorbell needed)
            wire.sendall_parts(self._sock, parts)
            metrics.counter("wire.shm.spill").add(1)

    def _next_frame(self, deadline: float) -> Tuple[int, Any]:
        """The next reply frame as ``(kind, obj)`` — from the rx ring,
        or whole off the side-channel when the replica spilled an
        oversized frame."""
        assert self._rx is not None
        spins = 0
        while True:
            record = self._rx.try_read()
            if record is not None:
                return wire.decode_frame(record)
            if spins < _POLL_SPIN:
                # pure ring polls — no syscalls until we decide to block
                spins += 1
                continue
            now = time.monotonic()
            if now > deadline:
                raise socket.timeout("shm reply wait exceeded deadline")
            # advertise the wait, re-check the ring (a reply published
            # between the poll above and the flag going up would never
            # ring the bell), then block until doorbell/spill/EOF
            self._rx.set_waiter(True)
            try:
                if not self._rx.readable():
                    got = _await_doorbell(
                        self._sock,
                        min(_CLIENT_WAIT_S, max(deadline - now, 0.001)),
                        efd=self._efd_rx,
                    )
                    if got is not None:  # oversized reply spilled to tcp
                        return got
            finally:
                self._rx.set_waiter(False)

    def _ring_doorbell(self) -> None:
        if self._efd_tx is not None:
            try:
                os.eventfd_write(self._efd_tx, 1)
                metrics.counter("wire.doorbell.eventfd").add(1)
                return
            except OSError:
                # fd hosed: drop to the socket byte, whose failure is
                # the authoritative liveness verdict
                self._close_efds()
        try:
            self._sock.sendall(_DOORBELL)
        except OSError as exc:
            raise ConnectionError(f"replica gone (doorbell failed): {exc}")
        metrics.counter("wire.doorbell.socket").add(1)

    def _close_efds(self) -> None:
        for attr in ("_efd_tx", "_efd_rx"):
            fd = getattr(self, attr, None)
            if fd is not None:
                try:
                    os.close(fd)
                except OSError:
                    pass
                setattr(self, attr, None)

    def close(self) -> None:
        self._close_efds()
        try:
            self._sock.close()
        except OSError:
            pass
        if self._tx is not None:
            self._tx.release()
            self._tx = None
        if self._rx is not None:
            self._rx.release()
            self._rx = None
        seg = self._seg
        self._seg = None
        if seg is not None:
            try:
                seg.close()
            except (OSError, BufferError):
                pass
            try:
                seg.unlink()
            except (OSError, FileNotFoundError):
                pass
            with _segments_lock:
                _active_segments.discard(seg.name)


class ShmTransport(Transport):
    """Channel-pooled shared-memory lane with permanent per-backend
    fallback to :class:`TcpTransport` when negotiation fails."""

    def __init__(self, host: str, port: int, connect_timeout_s: float = 2.0,
                 io_timeout_s: float = 30.0, max_idle: int = 8,
                 ring_bytes: Optional[int] = None):
        self._host, self._port = host, port
        self._connect_timeout_s = connect_timeout_s
        self._io_timeout_s = io_timeout_s
        self._max_idle = max_idle
        self._ring_bytes = ring_bytes or int(
            os.environ.get(ENV_RING_BYTES, str(DEFAULT_RING_BYTES))
        )
        self._lock = threading.Lock()
        self._idle: List[_ShmClientChannel] = []
        self._closed = False
        self._fallback: Optional[TcpTransport] = None

    @property
    def lane(self) -> str:
        return "tcp" if self._fallback is not None else "shm"

    def request(self, msg: Dict[str, Any], timeout_s: float) -> Dict[str, Any]:
        fallback = self._fallback
        if fallback is None:
            try:
                chan = self._checkout()
            except _ShmUnavailable as exc:
                fallback = self._fall_back(str(exc))
        if fallback is not None:
            return fallback.request(msg, timeout_s)
        try:
            reply = chan.request(msg, timeout_s)
        except BaseException:
            chan.close()  # failed channel: segment unlinked right here
            raise
        self._checkin(chan)
        return reply

    def stream(
        self,
        msg: Dict[str, Any],
        on_frame: Callable[[Dict[str, Any]], Any],
        timeout_s: float,
    ) -> Dict[str, Any]:
        fallback = self._fallback
        chan = None
        if fallback is None:
            try:
                chan = self._checkout()
            except _ShmUnavailable as exc:
                fallback = self._fall_back(str(exc))
        if fallback is not None:
            return fallback.stream(msg, on_frame, timeout_s)
        try:
            reply = chan.stream(msg, on_frame, timeout_s)
        except BaseException:
            chan.close()  # torn stream: segment unlinked right here
            raise
        self._checkin(chan)
        return reply

    def _fall_back(self, reason: str) -> TcpTransport:
        with self._lock:
            if self._fallback is None:
                metrics.counter("wire.shm.fallback").add(1)
                self._fallback = TcpTransport(
                    self._host, self._port,
                    self._connect_timeout_s, self._io_timeout_s,
                )
            fallback = self._fallback
        sys.stderr.write(f"[wire] shm lane unavailable ({reason}); "
                         f"falling back to tcp\n")
        return fallback

    def _checkout(self) -> _ShmClientChannel:
        while True:
            with self._lock:
                if self._closed:
                    raise ConnectionError("transport closed")
                if not self._idle:
                    break
                chan = self._idle.pop()
            # the side-channel is the liveness signal: EOF (or a frame
            # that has no business arriving on an idle channel) means
            # the replica died while this channel sat pooled
            try:
                stale = _drain_side_channel(chan._sock) is not None
            except ConnectionError:
                stale = True
            if not stale:
                return chan
            metrics.counter("wire.pool.stale").add(1)
            chan.close()
        return _ShmClientChannel(
            self._host, self._port, self._connect_timeout_s,
            self._io_timeout_s, self._ring_bytes,
        )

    def _checkin(self, chan: _ShmClientChannel) -> None:
        with self._lock:
            if not self._closed and len(self._idle) < self._max_idle:
                self._idle.append(chan)
                return
        chan.close()

    def close(self) -> None:
        with self._lock:
            self._closed = True
            idle, self._idle = self._idle, []
            fallback, self._fallback = self._fallback, self._fallback
        for chan in idle:
            chan.close()
        if fallback is not None:
            fallback.close()


# ---------------------------------------------------------------------------
# replica (server) side


class ServerChannel:
    """Replica side of one connection: starts as plain TCP and upgrades
    in place when the client negotiates ``shm_attach``.  The channel
    never owns the socket (socketserver does) and never *unlinks* the
    segment (the creating router does) — it only maps and unmaps."""

    def __init__(self, sock: socket.socket, allow_shm: Optional[bool] = None):
        if allow_shm is None:
            allow_shm = os.environ.get(ENV_SHM_DISABLE, "0") != "1"
        self._sock = sock
        try:
            # the doorbell contract depends on this: a 1-byte wake must
            # never sit in a Nagle queue behind an unacked predecessor
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError:
            pass  # not a TCP socket (tests drive AF_UNIX pairs)
        self._allow_shm = allow_shm and shm_supported()
        self._wake = threading.Event()  # never set: an interruptible nap
        self._seg = None
        self._rx: Optional[_Ring] = None
        self._tx: Optional[_Ring] = None
        self._efd_rx: Optional[int] = None  # we read: client rings us
        self._efd_tx: Optional[int] = None  # we write: rings the client
        self._spins = 0

    @property
    def lane(self) -> str:
        return "shm" if self._seg is not None else "tcp"

    def recv(self) -> Optional[Tuple[int, Any]]:
        """Next request frame as ``(kind, obj)``; None when the client
        is gone.  Handles the shm upgrade handshake internally."""
        while True:
            if self._seg is None:
                got = wire.recv_any(self._sock)
                if got is None:
                    return None
                kind, msg = got
                if (kind == wire.KIND_MSG and isinstance(msg, dict)
                        and msg.get("op") == "shm_attach"):
                    self._attach(msg)
                    continue
                return got
            record = self._rx.try_read() if self._rx is not None else None
            if record is not None:
                self._spins = 0
                return wire.decode_frame(record)
            if self._spins < _POLL_SPIN:
                # pure ring polls — the socket is only consulted when
                # the ring has gone quiet and we are about to block
                self._spins += 1
                continue
            # quiet ring: advertise the wait, re-check, then block on
            # the doorbell (the client rings after every ring write it
            # makes while our flag is up)
            assert self._rx is not None
            self._rx.set_waiter(True)
            try:
                try:
                    got = None
                    if not self._rx.readable():
                        got = _await_doorbell(
                            self._sock, _SERVER_WAIT_S, efd=self._efd_rx
                        )
                except ConnectionError:
                    return None  # socket torn down under us: client gone
                if got is not None:  # oversized request spilled to tcp
                    self._spins = 0
                    return got
            finally:
                self._rx.set_waiter(False)

    def _attach(self, msg: Dict[str, Any]) -> None:
        if not self._allow_shm:
            wire.send_msg(self._sock, {
                "ok": False, "error": "shm lane disabled on this replica",
            })
            return
        try:
            from multiprocessing import shared_memory
            ring_bytes = int(msg["ring_bytes"])
            with _untracked_shm():
                seg = shared_memory.SharedMemory(name=msg["shm"])
        except Exception as exc:
            wire.send_msg(self._sock, {
                "ok": False, "error": f"shm attach failed: {exc}",
            })
            return
        self._seg = seg
        buf = seg.buf
        # mirror of the client: its tx ring is our rx ring
        self._rx = _Ring(buf, 0, ring_bytes)
        self._tx = _Ring(buf, _Ring.HDR + ring_bytes, ring_bytes)
        efd_name = msg.get("efd")
        eventfd_ok = bool(
            efd_name and _eventfd_wanted()
            and self._offer_eventfd(str(efd_name))
        )
        wire.send_msg(self._sock, {"ok": True, "eventfd": eventfd_ok})

    def _offer_eventfd(self, name: str) -> bool:
        """Create the doorbell eventfd pair and pass both ends to the
        client over its abstract-namespace AF_UNIX listener.  The
        connect happens *before* our attach reply goes out, but an
        AF_UNIX stream connect completes against the listen backlog and
        SCM_RIGHTS payloads buffer until the client accepts — so the
        ordering is safe.  Any failure returns False and the connection
        stays on socket doorbells."""
        c2s = s2c = None
        conn = None
        try:
            flags = os.EFD_NONBLOCK | getattr(os, "EFD_CLOEXEC", 0)
            c2s = os.eventfd(0, flags)  # client rings us
            s2c = os.eventfd(0, flags)  # we ring the client
            conn = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            conn.settimeout(1.0)
            conn.connect("\0" + name)
            socket.send_fds(conn, [b"\x01"], [c2s, s2c])
        except OSError:
            for fd in (c2s, s2c):
                if fd is not None:
                    try:
                        os.close(fd)
                    except OSError:
                        pass
            return False
        finally:
            if conn is not None:
                try:
                    conn.close()
                except OSError:
                    pass
        self._efd_rx, self._efd_tx = c2s, s2c
        metrics.counter("wire.shm.eventfd").add(1)
        return True

    def send(self, obj: Any, kind: int = wire.KIND_MSG) -> None:
        parts = wire.encode_parts(obj, kind)
        total = wire.parts_len(parts)
        if self._seg is not None and self._tx is not None \
                and self._tx.fits(total):
            deadline = time.monotonic() + _SERVER_SEND_TIMEOUT_S
            spins = 0
            while not self._tx.try_write(parts, total):
                if time.monotonic() > deadline:
                    raise ConnectionError("client stopped draining shm ring")
                if spins >= _POLL_SPIN:
                    self._wake.wait(_POLL_SLEEP_S)
                spins += 1
            if self._tx.waiter:
                self._ring_doorbell()
            return
        wire.sendall_parts(self._sock, parts)

    def _ring_doorbell(self) -> None:
        if self._efd_tx is not None:
            try:
                os.eventfd_write(self._efd_tx, 1)
                metrics.counter("wire.doorbell.eventfd").add(1)
                return
            except OSError:
                self._close_efds()  # socket byte decides liveness below
        try:
            self._sock.sendall(_DOORBELL)
        except OSError as exc:
            raise ConnectionError(f"client gone (doorbell failed): {exc}")
        metrics.counter("wire.doorbell.socket").add(1)

    def _close_efds(self) -> None:
        for attr in ("_efd_tx", "_efd_rx"):
            fd = getattr(self, attr, None)
            if fd is not None:
                try:
                    os.close(fd)
                except OSError:
                    pass
                setattr(self, attr, None)

    def close(self) -> None:
        self._close_efds()
        if self._rx is not None:
            self._rx.release()
            self._rx = None
        if self._tx is not None:
            self._tx.release()
            self._tx = None
        seg = self._seg
        self._seg = None
        if seg is not None:
            try:
                seg.close()
            except (OSError, BufferError):
                pass


def serve_connection(
    sock: socket.socket,
    handle_one: Callable[[Dict[str, Any]], Dict[str, Any]],
    handle_batch: Optional[
        Callable[[List[Dict[str, Any]]], List[Dict[str, Any]]]
    ] = None,
    handle_stream: Optional[
        Callable[[Dict[str, Any], Callable[[Dict[str, Any]], None]], None]
    ] = None,
    allow_shm: Optional[bool] = None,
) -> None:
    """Serve one client connection until EOF: the replica's request
    loop, shared by the real replica process and the in-process test
    services.  Handler exceptions become typed error replies; transport
    errors end the connection (the client retries elsewhere).

    ``handle_stream(msg, send_frame)`` — when given — owns ``decode``
    ops: it must push 0+ partial frames plus exactly one ``final: True``
    frame through ``send_frame`` (each goes out as ``KIND_STREAM`` with
    the request ``seq`` echoed, on whichever lane the connection runs).
    The stream occupies this connection until its final frame — which is
    why the router pins streams to a dedicated channel."""
    chan = ServerChannel(sock, allow_shm=allow_shm)
    try:
        while True:
            try:
                got = chan.recv()
            except (ConnectionError, OSError):
                return
            if got is None:
                return
            kind, msg = got
            if (handle_stream is not None and kind == wire.KIND_MSG
                    and isinstance(msg, dict)
                    and msg.get("op") == "decode"):

                def send_frame(frame: Dict[str, Any], _msg=msg) -> None:
                    chan.send(
                        _echo_seq(_msg, frame), kind=wire.KIND_STREAM
                    )

                try:
                    handle_stream(msg, send_frame)
                except (ConnectionError, OSError):
                    return
                except Exception as exc:
                    # a handler that died without terminating its own
                    # stream: end it with a typed error frame (the
                    # client surfaces the error; a gap-free consumer
                    # treats a bad stream_seq as a dropped channel)
                    err = wire.encode_error(exc)
                    err["final"] = True
                    try:
                        send_frame(err)
                    except (ConnectionError, OSError):
                        return
                continue
            try:
                if kind == wire.KIND_BATCH:
                    if not isinstance(msg, list):
                        return  # malformed batch: drop the connection
                    if handle_batch is not None:
                        replies = handle_batch(msg)
                    else:
                        replies = [_safe(handle_one, m) for m in msg]
                    for m, r in zip(msg, replies):
                        _echo_seq(m, r)
                    chan.send(replies, kind=wire.KIND_BATCH)
                else:
                    chan.send(_echo_seq(msg, _safe(handle_one, msg)))
            except (ConnectionError, OSError):
                return
    finally:
        chan.close()


def _echo_seq(msg: Any, reply: Any) -> Any:
    """Echo the request's ``seq`` onto its reply — done centrally here
    so every handler (real replica service or test stub) satisfies the
    client-side desync check without knowing the field exists."""
    if isinstance(msg, dict) and isinstance(reply, dict) and "seq" in msg:
        reply["seq"] = msg["seq"]
    return reply


def _safe(
    handle_one: Callable[[Dict[str, Any]], Dict[str, Any]],
    msg: Dict[str, Any],
) -> Dict[str, Any]:
    try:
        return handle_one(msg)
    except Exception as exc:
        return wire.encode_error(exc)
