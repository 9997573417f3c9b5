"""Typed zero-copy framing between router and replicas.

The replica plane is process-per-replica (a SIGKILL must take out ONE
replica, not the server), so requests cross a process boundary.  This
module is the one definition of that boundary: a port of
``sparkdl_tpu.serving.wire`` whose frames are the JAX package's byte for
byte. Frames are *typed*: tensors travel
as raw buffer bytes described by a compact (dtype, shape, contiguity)
descriptor and come back via ``np.frombuffer`` over the receive buffer
— zero-copy on encode (``sendmsg`` scatter-gathers the array's own
memory) and one ``recv_into`` fill on decode.  Pickle is retained only
for the small non-tensor control envelope.

Frame layout (big-endian)::

    +-------+------+-------+----------+----------+=======+=========+
    | magic | kind | flags | meta_len | body_len | meta  | body    |
    | 4s    | u8   | u8    | u32      | u64      | ...   | ...     |
    +-------+------+-------+----------+----------+=======+=========+

``meta`` is a pickle of ``(envelope, descs)`` where every ndarray in
the envelope has been replaced by a ``("\\x00sdw-tensor\\x00", i)``
marker tuple and ``descs[i] = (dtype_str, shape, offset, nbytes,
c_contiguous)`` locates its bytes inside ``body``.  Marker tuples (not
classes) keep the meta pickle importable by the bench generators,
which load this file standalone by path.  ``kind`` is ``KIND_MSG`` for
one envelope or ``KIND_BATCH`` for a list of envelopes sharing one
body (the TCP lane's request coalescer).

A half-written frame from a killed replica surfaces as a clean
``ConnectionError`` the router can retry — bad magic, truncated
header, truncated body, or a descriptor that disagrees with the
payload length all refuse loudly, never a torn or garbage array.
Structural checks can't catch a *bit flip inside a tensor body*, so
every frame also carries a 4-byte checksum trailer (``flags`` bit
:data:`FLAG_CRC`, covering prefix + meta + body); a mismatch raises
the typed transient :class:`FrameCorrupt` and counts ``wire.crc_fail``.
``SPARKDL_WIRE_CRC=0`` disables stamping (decode always honors the
flag on the frame itself).

Security note: meta is **pickle** and the sockets bind loopback by
default — this is an intra-host data plane between processes the
supervisor itself spawned, not an internet-facing protocol.  Anything
that can reach the port can already signal the processes.

Typed errors cross the boundary by *class name*: a replica encodes an
exception as ``{"error_class": ..., "error": ...}`` and the router
re-raises the same class when it is one of the sanctioned serving /
resilience types (so ``isinstance`` retry decisions — transient vs
permanent — survive the hop), falling back to
:class:`~sparkdl_tpu_torch.serving.errors.RemoteReplicaError` otherwise.
"""

from __future__ import annotations

import os
import pickle
import socket
import struct
import sys
import time
import zlib
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

MAGIC = b"SDW2"
KIND_MSG = 1
KIND_BATCH = 2
#: one *incremental* reply frame in a decode stream: same framing, CRC
#: trailer, and seq-echo as any reply, but the channel stays open — a
#: request is answered by 0+ KIND_STREAM frames followed by exactly one
#: whose envelope carries ``final: True``.  Ordering within the stream
#: is ``stream_seq`` (0-based, gap-free: a hole means a torn stream).
KIND_STREAM = 3

_PREFIX = struct.Struct(">4sBBIQ")  # magic, kind, flags, meta_len, body_len

#: flags bit 0: a 4-byte checksum trailer follows the body, covering
#: prefix + meta + body.  The checksum is ``zlib.crc32`` — C-speed in
#: the stdlib; true CRC32C (Castagnoli) needs a native wheel this
#: environment doesn't ship, and the polynomial is a one-line swap here
#: if one ever lands.  Flag-driven so a CRC-less peer (older frame, or
#: ``SPARKDL_WIRE_CRC=0``) still decodes.
FLAG_CRC = 0x01

_CRC = struct.Struct(">I")

#: encode-side knob; decode always honors the flag on the frame itself
_CRC_ENABLED = os.environ.get(
    "SPARKDL_WIRE_CRC", "1"
).lower() not in ("0", "false", "off")


class FrameCorrupt(ConnectionError):
    """A frame whose checksum trailer disagrees with its bytes — the
    payload was damaged in flight (flipped bit, torn ring record, a
    proxy that rewrote us).  Subclasses ``ConnectionError`` so every
    existing retry/fallback path already treats it as transient, and so
    this module stays importable standalone (no package imports)."""


#: optional hook over every encoded frame's parts, installed by
#: ``serving.faultnet`` to damage frames *after* the CRC trailer is
#: stamped (corrupt / truncate / duplicate / disconnect / stall) on
#: whichever lane consumes the encode — TCP sendmsg, shm ring, spill.
#: Must stay None-by-default: wire imports nothing from faultnet.
_SEND_TAP: Optional[Callable[[List[Any]], List[Any]]] = None


def set_send_tap(tap: Optional[Callable[[List[Any]], List[Any]]]) -> None:
    """Install (or clear, with None) the frame send tap."""
    global _SEND_TAP
    _SEND_TAP = tap

#: refuse frames beyond this (a torn prefix must not allocate GBs)
MAX_FRAME_BYTES = 256 * 1024 * 1024
#: the control envelope is small by design; a huge meta is a torn stream
MAX_META_BYTES = 64 * 1024 * 1024

#: ndarrays in the envelope are swapped for (_TENSOR_MARK, index) tuples
_TENSOR_MARK = "\x00sdw-tensor\x00"

#: every key any request/reply envelope may carry — THE schema of the
#: router<->replica boundary.  The ``wire-envelope`` check rule holds
#: code to this set AND requires each field to appear in the
#: ``tests/test_wire.py`` roundtrip fixtures, so a field cannot ship
#: without a codec roundtrip proving it survives both lanes.
ENVELOPE_FIELDS = frozenset({
    # requests ("seq" is the per-channel request sequence number the
    # reply must echo — the duplicate/desynced-reply detector;
    # "max_steps" is the decode op's per-request step cap, clamped to
    # the endpoint's registered maximum)
    "op", "model_id", "value", "deadline_ms", "tenant", "trace", "seq",
    "max_steps",
    # shm lane upgrade handshake ("efd" is the client's abstract-
    # namespace AF_UNIX listener name for eventfd doorbell passing;
    # "eventfd" in the attach reply confirms the replica passed the fd
    # pair — absent/false means socket doorbells)
    "shm", "ring_bytes", "efd", "eventfd",
    # replies ("cache" marks how the result was produced — "hit" from
    # the router tier, "collapsed" when single-flight fanned a leader's
    # reply out, "negative" when a poison-input error replayed)
    "ok", "result", "server_ms", "phases", "spans",
    "pid", "draining", "replicas", "cache",
    # streaming replies (KIND_STREAM): "stream_seq" is the 0-based
    # gap-free position of this frame in its stream, "final" marks the
    # stream's terminal frame (the only one allowed to carry phases /
    # spans / server_ms; every frame echoes "seq" like any reply);
    # "steps" is the stitched reply's generated-token count — the
    # router stamps it on the reassembled stream result and the front
    # door forwards it in the terminal frame
    "stream_seq", "final", "steps",
    # typed errors
    "error", "error_class",
})


def _timer(name: str):
    """``wire.*`` timer when the package's metrics registry is already
    loaded, else None.  This module must stay importable standalone
    (a load generator may load it by file path without the package's
    imports), so it must never *trigger* the package import."""
    mod = sys.modules.get("sparkdl_tpu_torch.utils.metrics")
    if mod is None:
        return None
    metrics = mod.metrics
    # every call site passes a "wire." literal; the indirection exists
    # only for the sys.modules guard above
    return metrics.timer(name)  # sparkdl: disable=metric-name


def _count(name: str, n: float) -> None:
    mod = sys.modules.get("sparkdl_tpu_torch.utils.metrics")
    if mod is None:
        return
    metrics = mod.metrics
    metrics.counter(name).add(n)  # sparkdl: disable=metric-name


# ---------------------------------------------------------------------------
# encode


def encode_parts(obj: Any, kind: int = KIND_MSG) -> List[Any]:
    """Encode ``obj`` into frame parts ``[prefix+meta, buf, buf, ...]``
    where the trailing parts are zero-copy memoryviews over the
    envelope's own ndarray memory (scatter-gather them with
    :func:`sendall_parts`, or concatenate for a shm ring record)."""
    t0 = time.perf_counter()
    descs: List[Tuple[str, tuple, int, int, bool]] = []
    buffers: List[memoryview] = []
    offset = 0

    def walk(x: Any) -> Any:
        nonlocal offset
        if isinstance(x, np.ndarray) and not x.dtype.hasobject:
            was_c = bool(x.flags.c_contiguous)
            arr = x if was_c else np.ascontiguousarray(x)
            try:
                raw = memoryview(arr.reshape(-1)).cast("B")  # reshape: view
            except (BufferError, TypeError, ValueError):
                return x  # exotic dtype — ride the pickle envelope
            descs.append((arr.dtype.str, arr.shape, offset, arr.nbytes, was_c))
            buffers.append(raw)
            offset += arr.nbytes
            return (_TENSOR_MARK, len(descs) - 1)
        if isinstance(x, dict):
            return {k: walk(v) for k, v in x.items()}
        if isinstance(x, list):
            return [walk(v) for v in x]
        if isinstance(x, tuple):
            return tuple(walk(v) for v in x)
        return x

    envelope = walk(obj)
    meta = pickle.dumps((envelope, descs), protocol=pickle.HIGHEST_PROTOCOL)
    flags = FLAG_CRC if _CRC_ENABLED else 0
    head = _PREFIX.pack(MAGIC, kind, flags, len(meta), offset)
    parts: List[Any] = [head + meta, *buffers]
    if flags & FLAG_CRC:
        crc = zlib.crc32(meta, zlib.crc32(head))
        for buf in buffers:
            crc = zlib.crc32(buf, crc)
        parts.append(_CRC.pack(crc))
    timer = _timer("wire.serialize_seconds")
    if timer is not None:
        timer.add_seconds(time.perf_counter() - t0)
        _count("wire.frames_out", 1)
        _count("wire.bytes_out", parts_len(parts))
    if _SEND_TAP is not None:
        parts = _SEND_TAP(parts)
    return parts


def parts_len(parts: Sequence[Any]) -> int:
    return sum(len(p) for p in parts)


def sendall_parts(sock: socket.socket, parts: Sequence[Any]) -> None:
    """Vectored send of frame parts — one ``sendmsg`` syscall for the
    common case, advancing memoryviews across partial sends (and
    falling back past IOV_MAX) so no flattening copy is ever made."""
    views = [memoryview(p).cast("B") if not isinstance(p, memoryview) else p
             for p in parts if len(p)]
    while views:
        sent = sock.sendmsg(views[:64])
        while sent:
            if sent >= len(views[0]):
                sent -= len(views[0])
                views.pop(0)
            else:
                views[0] = views[0][sent:]
                sent = 0


# ---------------------------------------------------------------------------
# decode


def _fill(sock: socket.socket, view: memoryview,
          eof_ok_at_start: bool = False) -> bool:
    """``recv_into`` until ``view`` is full.  Returns False on a clean
    EOF before the first byte (only when allowed); EOF mid-fill raises
    ``ConnectionError`` — the router's retry trigger."""
    got = 0
    n = len(view)
    while got < n:
        r = sock.recv_into(view[got:])
        if r == 0:
            if got == 0 and eof_ok_at_start:
                return False
            raise ConnectionError("connection closed mid-frame")
        got += r
    return True


def _parse_prefix(head: bytes) -> Tuple[int, int, int, int]:
    magic, kind, flags, meta_len, body_len = _PREFIX.unpack(head)
    if magic != MAGIC:
        raise ConnectionError(
            f"bad frame magic {magic!r} — torn or foreign stream"
        )
    if kind not in (KIND_MSG, KIND_BATCH, KIND_STREAM):
        raise ConnectionError(f"unknown frame kind {kind}")
    if meta_len > MAX_META_BYTES or meta_len + body_len > MAX_FRAME_BYTES:
        raise ConnectionError(
            f"frame of {meta_len + body_len} bytes exceeds MAX_FRAME_BYTES "
            f"({MAX_FRAME_BYTES}) — torn or hostile stream"
        )
    return kind, flags, meta_len, body_len


def _verify_crc(head: bytes, meta: bytes, body: memoryview,
                trailer: bytes) -> None:
    """Checksum prefix+meta+body against the 4-byte trailer; a mismatch
    is :class:`FrameCorrupt` — counted, typed, retried elsewhere.  The
    prefix is covered too, so a flipped length byte that still parses
    lands here instead of decoding garbage."""
    crc = zlib.crc32(meta, zlib.crc32(head))
    crc = zlib.crc32(body, crc)
    (want,) = _CRC.unpack(trailer)
    if crc != want:
        _count("wire.crc_fail", 1)
        raise FrameCorrupt(
            f"frame checksum mismatch: computed {crc:#010x}, trailer "
            f"says {want:#010x} — payload damaged in flight"
        )


def _decode(meta: bytes, body: memoryview) -> Any:
    """Rebuild the envelope: unpickle meta, then point each tensor
    marker at a ``np.frombuffer`` view of ``body``.  Every descriptor
    is validated against the payload before any array is built."""
    t0 = time.perf_counter()
    try:
        envelope, descs = pickle.loads(meta)
    except Exception as exc:
        raise ConnectionError(f"undecodable frame meta: {exc}") from exc
    if not isinstance(descs, list):
        raise ConnectionError("malformed frame meta: descriptor table")

    arrays: List[np.ndarray] = []
    for desc in descs:
        try:
            dtype_str, shape, off, nbytes, was_c = desc
            dt = np.dtype(dtype_str)
            shape = tuple(int(d) for d in shape)
            off = int(off)
            nbytes = int(nbytes)
        except Exception as exc:
            raise ConnectionError(
                f"malformed tensor descriptor {desc!r}"
            ) from exc
        count = 1
        for d in shape:
            if d < 0:
                raise ConnectionError(f"negative dim in shape {shape}")
            count *= d
        if dt.itemsize * count != nbytes:
            raise ConnectionError(
                f"tensor descriptor mismatch: dtype {dt.str} shape {shape} "
                f"wants {dt.itemsize * count} bytes, descriptor says {nbytes}"
            )
        if off < 0 or off + nbytes > len(body):
            raise ConnectionError(
                f"tensor descriptor overruns body: offset {off} + {nbytes} "
                f"> {len(body)}"
            )
        arr = np.frombuffer(body[off:off + nbytes], dtype=dt)
        arrays.append(arr.reshape(shape))

    def restore(x: Any) -> Any:
        if (isinstance(x, tuple) and len(x) == 2 and x[0] == _TENSOR_MARK):
            idx = x[1]
            if not isinstance(idx, int) or not 0 <= idx < len(arrays):
                raise ConnectionError(f"tensor marker out of range: {x!r}")
            return arrays[idx]
        if isinstance(x, dict):
            return {k: restore(v) for k, v in x.items()}
        if isinstance(x, list):
            return [restore(v) for v in x]
        if isinstance(x, tuple):
            return tuple(restore(v) for v in x)
        return x

    out = restore(envelope)
    timer = _timer("wire.deserialize_seconds")
    if timer is not None:
        timer.add_seconds(time.perf_counter() - t0)
    return out


def recv_any(sock: socket.socket,
             first: bytes = b"") -> Optional[Tuple[int, Any]]:
    """One frame as ``(kind, obj)``, or None on clean EOF between
    frames.  The body lands in a single preallocated buffer via
    ``recv_into`` — no per-chunk copies — and reconstructed arrays are
    writable views over it.  ``first`` holds prefix bytes the caller
    already consumed (the shm side-channel reads one byte to tell a
    doorbell from a spilled frame); EOF after a partial prefix is a
    torn frame, not a clean close."""
    head = bytearray(_PREFIX.size)
    if first:
        head[:len(first)] = first
        _fill(sock, memoryview(head)[len(first):])
    elif not _fill(sock, memoryview(head), eof_ok_at_start=True):
        return None
    kind, flags, meta_len, body_len = _parse_prefix(bytes(head))
    t0 = time.perf_counter()
    meta = bytearray(meta_len)
    body = bytearray(body_len)
    _fill(sock, memoryview(meta))
    _fill(sock, memoryview(body))
    if flags & FLAG_CRC:
        trailer = bytearray(_CRC.size)
        _fill(sock, memoryview(trailer))
        _verify_crc(bytes(head), bytes(meta), memoryview(body),
                    bytes(trailer))
    timer = _timer("wire.copy_seconds")
    if timer is not None:
        timer.add_seconds(time.perf_counter() - t0)
        _count("wire.frames_in", 1)
        _count("wire.bytes_in", _PREFIX.size + meta_len + body_len)
    return kind, _decode(bytes(meta), memoryview(body))


def decode_frame(frame: bytearray) -> Tuple[int, Any]:
    """Decode one complete frame held in memory (the shm ring hands
    records over whole).  Torn or inconsistent frames raise
    ``ConnectionError`` exactly like the socket path."""
    if len(frame) < _PREFIX.size:
        raise ConnectionError(
            f"truncated frame: {len(frame)} bytes < prefix"
        )
    kind, flags, meta_len, body_len = _parse_prefix(
        bytes(frame[:_PREFIX.size])
    )
    tail = _CRC.size if flags & FLAG_CRC else 0
    if len(frame) != _PREFIX.size + meta_len + body_len + tail:
        raise ConnectionError(
            f"frame length mismatch: have {len(frame)}, prefix declares "
            f"{_PREFIX.size + meta_len + body_len + tail}"
        )
    view = memoryview(frame)
    meta = bytes(view[_PREFIX.size:_PREFIX.size + meta_len])
    body = view[_PREFIX.size + meta_len:_PREFIX.size + meta_len + body_len]
    if tail:
        _verify_crc(bytes(view[:_PREFIX.size]), meta, body,
                    bytes(view[len(frame) - tail:]))
    return kind, _decode(meta, body)


# ---------------------------------------------------------------------------
# message-level API (the generators and the router front door use this)


def send_msg(sock: socket.socket, obj: Any) -> None:
    """Serialize ``obj`` as one typed frame."""
    sendall_parts(sock, encode_parts(obj, KIND_MSG))


def send_batch(sock: socket.socket, msgs: Sequence[Any]) -> None:
    """N envelopes in one KIND_BATCH frame sharing a single body — the
    TCP lane's coalescer amortizes prefix + syscall across them."""
    sendall_parts(sock, encode_parts(list(msgs), KIND_BATCH))


def send_stream(sock: socket.socket, obj: Any) -> None:
    """One incremental :data:`KIND_STREAM` frame — a partial decode
    reply on a channel that stays open until a frame with
    ``final: True``.  CRC stamping and seq-echo apply exactly as for
    :func:`send_msg`; only the kind differs, so receivers can tell a
    stream fragment from a one-shot reply without peeking envelopes."""
    sendall_parts(sock, encode_parts(obj, KIND_STREAM))


def recv_msg(sock: socket.socket) -> Optional[Any]:
    """One message frame, or None on clean EOF.  A connection that dies
    mid-frame raises ``ConnectionError`` (the router's retry trigger)."""
    got = recv_any(sock)
    if got is None:
        return None
    kind, obj = got
    if kind != KIND_MSG:
        raise ConnectionError("unexpected batch frame on message channel")
    return obj


# ---------------------------------------------------------------------------
# typed errors

_REGISTRY: Optional[Dict[str, type]] = None


def _error_registry() -> Dict[str, type]:
    """Class-name -> class for the typed errors sanctioned to cross the
    wire, built once and cached at module level (lazy: errors modules
    import this one's siblings, and decode_error is an error path that
    must not pay two imports + a dict scan per call)."""
    global _REGISTRY
    if _REGISTRY is not None:
        return _REGISTRY
    from sparkdl_tpu_torch.resilience.errors import (
        CircuitOpen,
        DeadlineExceeded,
        PermanentError,
        TransientError,
    )
    from sparkdl_tpu_torch.serving import errors as serving_errors

    registry: Dict[str, type] = {
        cls.__name__: cls
        for cls in (CircuitOpen, DeadlineExceeded, PermanentError,
                    TransientError)
    }
    # connection-shaped failures must stay *transient* across the hop:
    # a replica that hit FrameCorrupt / ConnectionError / TimeoutError
    # talking to its own dependencies would otherwise decode router-side
    # as the permanent RemoteReplicaError and never be retried
    registry["FrameCorrupt"] = FrameCorrupt
    registry["ConnectionError"] = ConnectionError
    registry["TimeoutError"] = TimeoutError
    for name in serving_errors.__dict__:
        obj = serving_errors.__dict__[name]
        if isinstance(obj, type) and issubclass(obj, Exception):
            registry[name] = obj
    _REGISTRY = registry
    return registry


def encode_error(exc: BaseException) -> Dict[str, str]:
    return {
        "ok": False,
        "error_class": type(exc).__name__,
        "error": str(exc),
    }


def decode_error(reply: Dict[str, Any]) -> BaseException:
    """Re-hydrate a typed error reply; unknown classes come back as the
    catch-all :class:`~sparkdl_tpu_torch.serving.errors.RemoteReplicaError`
    (permanent — the router must not blind-retry a failure it cannot
    classify)."""
    from sparkdl_tpu_torch.serving.errors import RemoteReplicaError

    cls = _error_registry().get(reply.get("error_class", ""))
    message = reply.get("error", "remote replica error")
    if cls is None:
        return RemoteReplicaError(
            f"{reply.get('error_class', 'UnknownError')}: {message}"
        )
    try:
        return cls(message)
    except Exception:  # exotic __init__ signature
        return RemoteReplicaError(
            f"{reply.get('error_class')}: {message}"
        )


def connect(host: str, port: int, timeout_s: float) -> socket.socket:
    """A connected loopback socket with TCP_NODELAY (the frames are
    small and latency-bound; Nagle would serialize the micro-batcher's
    linger window behind the kernel's)."""
    sock = socket.create_connection((host, port), timeout=timeout_s)
    sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    return sock
