"""One serving replica as a spawnable/killable OS process.

Port of ``sparkdl_tpu.serving.replica``. A
:class:`~sparkdl_tpu_torch.serving.server.ModelServer` is a library object —
a SIGKILL aimed at it takes out the whole host process.  This module wraps
it in a process boundary so the supervisor can treat replicas like cattle:
``python -m sparkdl_tpu_torch.serving.replica`` (a fresh interpreter,
started by ``subprocess``: nothing that touched CUDA is ever forked) builds
a server from a :class:`ReplicaSpec` (a dotted ``module:callable`` factory
— the only thing that crosses the spawn boundary is a name, never a
pickled closure), **pre-warms** it (the spawned process inherits
``SPARKDL_COMPILE_CACHE``, so a restarted replica's compiled endpoints
*load* their programs instead of recompiling), reports liveness via the
:class:`~sparkdl_tpu_torch.obs.server.ObsServer` ``/healthz``, and serves
the :mod:`~sparkdl_tpu_torch.serving.wire` protocol on a loopback TCP port.
The demo factories build their servers on the card unless given
``device="cpu"``; rows cross the wire as numpy arrays (a bf16 result is
widened to float32 on the card before its copy), never as tensors.

Lifecycle contract (what the supervisor and router rely on):

- **ready line** — exactly one JSON line on stdout once warm and
  listening: ``{"ready": true, "pid", "port", "obs_port", "lanes",
  "warmup", "fingerprints"}``. The replica moves descriptor 1 to stderr
  before it builds anything, so a log, a compiler or a child process
  that writes to stdout cannot break the handshake.
  ``lanes`` is the wire transports this replica accepts and
  ``fingerprints`` maps endpoints to their engine fingerprints (the
  supervisor forwards both to ``router.add``, where lane selection and
  result-cache keying happen).
- **SIGTERM = drain** — stop admitting (new requests get the transient
  :class:`~sparkdl_tpu_torch.serving.errors.ReplicaDraining`, which the router
  re-routes), finish every in-flight request, flush/close the server,
  exit 0.  Accepted work is never dropped by a graceful stop.
- **SIGKILL = crash** — in-flight requests surface router-side as
  connection errors and are retried on a surviving replica; the
  supervisor restarts the process with backoff.

Fault sites (``resilience.inject``): ``supervisor.replica_warm`` fires
once before warmup, ``supervisor.replica_serve`` before each handled
request — a ``SPARKDL_FAULT_PLAN`` kill rule at either is the
deterministic stand-in for a replica dying at that point.
"""

from __future__ import annotations

import importlib
import json
import os
import signal
import socket as socketmod
import socketserver
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

import numpy as np

from sparkdl_tpu_torch.obs.trace import tracer
from sparkdl_tpu_torch.resilience import inject
from sparkdl_tpu_torch.serving import transport as transport_mod
from sparkdl_tpu_torch.serving import wire
from sparkdl_tpu_torch.serving.errors import (
    DeadlineExceeded,
    ReplicaDraining,
    ServerClosed,
)
from sparkdl_tpu_torch.serving.result_cache import (
    ENV_RESULT_CACHE,
    NegativeCache,
    SingleFlight,
    canonical_digest,
)
from sparkdl_tpu_torch.utils.metrics import metrics

ENV_SPEC = "SPARKDL_REPLICA_SPEC"

#: how long a SIGTERM'd replica waits for in-flight work before exiting
#: anyway (a wedged forward must not make "graceful" mean "forever")
DRAIN_TIMEOUT_S = float(os.environ.get("SPARKDL_REPLICA_DRAIN_S", "15"))


@dataclass
class ReplicaSpec:
    """Everything a replica process needs, JSON-serializable.

    ``factory`` is ``"package.module:callable"`` resolving to a
    zero-arg callable that returns a configured
    :class:`~sparkdl_tpu_torch.serving.server.ModelServer` (register your
    endpoints with durable ``fingerprint=`` there and restarts become
    cache-warm).  ``pythonpath`` entries are prepended to ``sys.path``
    before the import — how tests and benches ship ad-hoc factories."""

    factory: str
    warmup: bool = True
    host: str = "127.0.0.1"
    port: int = 0
    obs_port: int = 0
    request_timeout_s: float = 30.0
    pythonpath: Tuple[str, ...] = field(default_factory=tuple)

    def to_json(self) -> str:
        return json.dumps({
            "factory": self.factory,
            "warmup": self.warmup,
            "host": self.host,
            "port": self.port,
            "obs_port": self.obs_port,
            "request_timeout_s": self.request_timeout_s,
            "pythonpath": list(self.pythonpath),
        })

    @classmethod
    def from_json(cls, text: str) -> "ReplicaSpec":
        raw = json.loads(text)
        raw["pythonpath"] = tuple(raw.get("pythonpath", ()))
        return cls(**raw)

    @classmethod
    def from_env(cls) -> "ReplicaSpec":
        text = os.environ.get(ENV_SPEC, "")
        if not text:
            raise RuntimeError(
                f"{ENV_SPEC} is not set — replica processes are spawned "
                "by ReplicaSupervisor, not run by hand"
            )
        return cls.from_json(text)

    def build_server(self):
        """Import and call the factory (pythonpath applied first)."""
        for entry in self.pythonpath:
            if entry and entry not in sys.path:
                sys.path.insert(0, entry)
        modname, _, attr = self.factory.partition(":")
        if not attr:
            raise ValueError(
                f"factory {self.factory!r} must be 'module:callable'"
            )
        fn = getattr(importlib.import_module(modname), attr)
        return fn()


DEMO_DIM = 64


def _demo_weight(i: int):
    """Endpoint ``ep{i}``'s deterministic ``(DEMO_DIM, DEMO_DIM)`` weight."""
    import torch

    return torch.from_numpy(
        np.linspace(-1.0, 1.0, DEMO_DIM * DEMO_DIM, dtype=np.float32)
        .reshape(DEMO_DIM, DEMO_DIM) * (i + 1))


def _demo_model_server(device):
    from sparkdl_tpu_torch.serving.batcher import ServingConfig
    from sparkdl_tpu_torch.serving.server import ModelServer

    return ModelServer(config=ServingConfig(max_batch=16, max_wait_ms=1.0, queue_capacity=512),
                       device=device)


def demo_server(endpoints: int = 3, compile: bool = True, device=None):
    """The built-in demo factory (``sparkdl_tpu_torch.serving.replica:
    demo_server``): ``endpoints`` tiny ``tanh(x @ w)`` models with durable
    fingerprints, enough model diversity for Zipf endpoint traffic and cheap
    enough that a chaos run measures the *plane*, not the matmul. Built on
    ``device`` (``None`` is the card, which raises without one; a CPU test
    ships a zero-argument factory that passes ``device="cpu"``)."""
    import torch

    server = _demo_model_server(device)
    for i in range(int(endpoints)):
        weight = _demo_weight(i).to(server.device)

        def forward(x, _w=weight):
            return torch.tanh(x @ _w)

        server.register(f"ep{i}", forward, item_shape=(DEMO_DIM,), compile=compile,
                        fingerprint=f"demo:ep{i}:dim{DEMO_DIM}:v1" if compile else None)
    return server


def demo_server_plain(device=None):
    """``demo_server`` with eager forwards (no compile): the deterministic,
    import-cheap flavour the fault-injection tests use."""
    return demo_server(compile=False, device=device)


def demo_server_decode(endpoints: int = 3, device=None):
    """``demo_server_plain`` plus a deterministic decode endpoint (``dec0``):
    carry ``[acc, step]``, each step emits the pre-step ``acc`` and adds 1,
    so a prompt summing to ``s`` streams tokens ``s, s+1, s+2, ...`` and the
    whole stream replays exactly from the prompt. ``SPARKDL_DEMO_STEP_MS``
    (default 0) stalls each fused step, so that streams stay in flight long
    enough to be worth killing."""
    step_s = float(os.environ.get("SPARKDL_DEMO_STEP_MS", "0")) / 1000.0
    server = demo_server(endpoints, compile=False, device=device)

    def step_fn(carries):
        if step_s > 0.0:
            time.sleep(step_s)
        return carries + 1.0, carries[:, 0].clone()

    def init_fn(prompt):
        return np.asarray([float(np.asarray(prompt, np.float64).sum()), 0.0], np.float32)

    server.register_decode("dec0", step_fn, init_fn, max_steps=64, n_slots=8, compile=False)
    return server


def demo_server_metered(endpoints: int = 3, device=None):
    """A fingerprinted, deliberately *metered* demo build for the result
    cache's sweeps: eager forwards that cost ``SPARKDL_DEMO_COST_MS``
    (default 15) per batched item, a stand-in for device time, so replica
    throughput is capacity-bound and a cache hit (which skips the replica)
    visibly multiplies goodput. The fingerprints are durable across boots
    (the weights are deterministic), so the router can key on them."""
    import torch

    cost_s = float(os.environ.get("SPARKDL_DEMO_COST_MS", "15")) / 1000.0
    server = _demo_model_server(device)
    for i in range(int(endpoints)):
        weight = _demo_weight(i).to(server.device)

        def forward(x, _w=weight):
            time.sleep(cost_s * max(1, int(x.shape[0])))
            return torch.tanh(x @ _w)

        server.register(f"ep{i}", forward, item_shape=(DEMO_DIM,), compile=False,
                        fingerprint=f"demo:ep{i}:dim{DEMO_DIM}:metered:v1")
    return server


def demo_server_slow(endpoints: int = 3, device=None):
    """A deliberately *regressed* demo build: every forward stalls
    ``SPARKDL_DEMO_DELAY_MS`` (default 80) before answering, the stand-in
    for a canary that breaches its latency objective."""
    import torch

    delay_s = float(os.environ.get("SPARKDL_DEMO_DELAY_MS", "80")) / 1000.0
    server = _demo_model_server(device)
    for i in range(int(endpoints)):
        weight = _demo_weight(i).to(server.device)

        def forward(x, _w=weight):
            time.sleep(delay_s)
            return torch.tanh(x @ _w)

        server.register(f"ep{i}", forward, item_shape=(DEMO_DIM,), compile=False)
    return server


class _SpanHarvest:
    """Tracer sink buffering this process's finished spans by trace_id
    so a reply envelope can carry its own trace's spans back to the
    router (where they are stitched into the router-side sink).

    Bounded both ways — at most ``MAX_TRACES`` trace buckets (oldest
    evicted first: a trace whose reply never ships, e.g. a connection
    that died mid-request, must not leak) and ``MAX_SPANS_PER_TRACE``
    spans per bucket.  Only spans that survived the tracer's tail-aware
    sampling reach any sink, so the piggyback inherits the same policy:
    a dropped trace ships no spans, a kept trace ships whole."""

    MAX_TRACES = 256
    MAX_SPANS_PER_TRACE = 16

    def __init__(self):
        self._lock = threading.Lock()
        self._by_trace: "Dict[int, list]" = {}

    def __call__(self, span_dict: Dict[str, Any]) -> None:
        tid = span_dict.get("trace_id")
        if tid is None:
            return
        with self._lock:
            bucket = self._by_trace.get(tid)
            if bucket is None:
                if len(self._by_trace) >= self.MAX_TRACES:
                    # dicts iterate in insertion order: drop the oldest
                    self._by_trace.pop(next(iter(self._by_trace)))
                bucket = self._by_trace[tid] = []
            if len(bucket) < self.MAX_SPANS_PER_TRACE:
                bucket.append(span_dict)

    def take(self, trace_id: int) -> list:
        """Pop (and return) every buffered span of one trace."""
        with self._lock:
            return self._by_trace.pop(trace_id, [])


class ReplicaService:
    """Serve a :class:`ModelServer` over the wire protocol.

    Usable in-process (router unit tests run one per thread) and as the
    body of the replica process.  One connection handler thread per
    router connection; each loops request frames:

    - ``{"op": "ping"}`` -> ``{"ok": true, "pid", "draining"}``
    - ``{"op": "infer", "model_id", "value", "deadline_ms"}`` ->
      ``{"ok": true, "result", "server_ms"}`` or a typed error reply

    Connections are served through
    :func:`~sparkdl_tpu_torch.serving.transport.serve_connection`, so a
    router may upgrade any of them to the shared-memory lane and
    coalesced ``KIND_BATCH`` frames fan out through :meth:`_handle_batch`
    (submit-all-then-gather — the whole batch lands in one micro-batcher
    window instead of serializing N round trips).
    """

    def __init__(
        self,
        server,
        host: str = "127.0.0.1",
        port: int = 0,
        request_timeout_s: float = 30.0,
        allow_shm: Optional[bool] = None,
    ):
        self._server = server
        self._request_timeout_s = float(request_timeout_s)
        self._allow_shm = allow_shm
        self._lock = threading.Lock()
        self._idle = threading.Condition(self._lock)
        self._inflight = 0
        self._draining = False
        self._m_requests = metrics.counter("supervisor.replica_requests")
        self._m_inflight = metrics.gauge("supervisor.replica_inflight")
        self._m_expired_shed = metrics.counter("replica.expired_shed")
        # replica-tier result cache: single-flight collapses
        # concurrent identical requests into one forward; the negative
        # cache replays typed-permanent-error replies for poison inputs.
        # Armed by the same env switch as the router tier.
        cache_on = os.environ.get(ENV_RESULT_CACHE) == "1"
        self._single_flight = SingleFlight() if cache_on else None
        self._negative = NegativeCache() if cache_on else None
        # harvest this process's finished spans per trace so replies can
        # piggyback them back to the router for cross-process stitching
        self._harvest = _SpanHarvest()
        tracer.add_sink(self._harvest)
        outer = self

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):  # one thread per router connection
                self.request.setsockopt(
                    socketmod.IPPROTO_TCP, socketmod.TCP_NODELAY, 1
                )
                transport_mod.serve_connection(
                    self.request,
                    outer._handle_one,
                    handle_batch=outer._handle_batch,
                    handle_stream=outer._handle_stream,
                    allow_shm=outer._allow_shm,
                )

        class Server(socketserver.ThreadingTCPServer):
            daemon_threads = True
            allow_reuse_address = True

        self._tcp = Server((host, int(port)), Handler)
        self._thread = threading.Thread(
            target=self._tcp.serve_forever,
            kwargs={"poll_interval": 0.1},
            name="sparkdl-replica-serve",
            daemon=True,
        )

    # ------------------------------------------------------------------
    def start(self) -> "ReplicaService":
        self._thread.start()
        return self

    @property
    def port(self) -> int:
        return self._tcp.server_address[1]

    @property
    def draining(self) -> bool:
        with self._lock:
            return self._draining

    @property
    def lanes(self) -> Tuple[str, ...]:
        """Wire lanes this replica will accept, advertised in the ready
        line (shm honours ``SPARKDL_WIRE_SHM_DISABLE``)."""
        allow = self._allow_shm
        if allow is None:
            allow = os.environ.get(
                transport_mod.ENV_SHM_DISABLE, "0"
            ) != "1"
        if allow and transport_mod.shm_supported():
            return ("tcp", "shm")
        return ("tcp",)

    def _handle_one(self, msg: Dict[str, Any]) -> Dict[str, Any]:
        staged = self._submit(msg)
        if staged[0] == "reply":
            return staged[1]
        if staged[0] == "collapse":
            return self._finish_collapse(*staged[1:])
        return self._finish(*staged[1:])

    def _handle_batch(
        self, msgs: list
    ) -> list:
        """A coalesced ``KIND_BATCH`` frame: submit every request first
        (they share one micro-batcher admission window), then gather the
        futures in order.  Per-message failures become typed error
        replies — one bad request never poisons its batchmates."""
        staged = []
        for msg in msgs:
            try:
                staged.append(self._submit(msg))
            except Exception as exc:
                staged.append(("error", wire.encode_error(exc)))
        replies = []
        for item in staged:
            if item[0] == "reply" or item[0] == "error":
                replies.append(item[1])
                continue
            try:
                if item[0] == "collapse":
                    replies.append(self._finish_collapse(*item[1:]))
                else:
                    replies.append(self._finish(*item[1:]))
            except Exception as exc:
                replies.append(wire.encode_error(exc))
        return replies

    def _handle_stream(self, msg: Dict[str, Any], send_frame) -> None:
        """One ``decode`` op end to end: admit into the decode plane,
        forward each token frame through ``send_frame`` the moment the
        slot worker emits it, then terminate the stream with a final
        frame carrying ``server_ms``/``phases``/piggybacked spans (or a
        typed error).  ``send_frame`` raising ``ConnectionError`` marks
        the client gone — the emit callback's failure evicts the slot,
        so a disconnected consumer never burns another device step."""
        span = self._serve_span(msg)
        t0 = time.monotonic()
        sent = 0  # token frames actually shipped

        def fail(exc: BaseException) -> None:
            self._end_span(span, type(exc))
            err = wire.encode_error(exc)
            err["final"] = True
            err["stream_seq"] = sent
            send_frame(err)

        deadline_ms = msg.get("deadline_ms")
        if deadline_ms is not None and float(deadline_ms) <= 0.0:
            self._m_expired_shed.add(1)
            fail(DeadlineExceeded(
                f"decode request arrived at replica pid={os.getpid()} "
                f"already expired ({deadline_ms}ms remaining)"
            ))
            return
        with self._lock:
            draining = self._draining
            if not draining:
                self._inflight += 1
                self._m_inflight.set(self._inflight)
        if draining:
            fail(ReplicaDraining(
                f"replica pid={os.getpid()} is draining"
            ))
            return
        try:
            inject.fire("supervisor.replica_serve")
            self._m_requests.add(1)

            def emit_cb(frame: Dict[str, Any]) -> bool:
                nonlocal sent
                if frame.get("final"):
                    # the terminal frame is enriched and sent below,
                    # after the future resolves (it alone may carry
                    # server_ms / phases / spans)
                    return True
                send_frame(frame)  # ConnectionError -> slot evicted
                sent += 1
                return True

            try:
                with tracer.use_span(span):
                    req = self._server.submit_decode(
                        msg["value"],
                        model_id=msg.get("model_id"),
                        emit=emit_cb,
                        max_steps=msg.get("max_steps"),
                        deadline_ms=deadline_ms,
                        tenant=msg.get("tenant"),
                        trace=(
                            span.context() if span is not None
                            else msg.get("trace")
                        ),
                    )
                req.future.result(timeout=self._request_timeout_s)
            except Exception as exc:
                if isinstance(exc, (ConnectionError, OSError)):
                    # the client is gone (its disconnect evicted the
                    # slot) — there is nobody left to send a frame to
                    self._end_span(span, type(exc))
                    raise
                fail(exc)
                return
            final: Dict[str, Any] = {
                "ok": True,
                "final": True,
                "stream_seq": sent,
                "server_ms": round((time.monotonic() - t0) * 1000.0, 3),
            }
            phases = getattr(req.future, "sparkdl_phases", None)
            if phases:
                final["phases"] = dict(phases)
            if span is not None:
                span.set_attribute("steps", sent)
                span.end()
                final["spans"] = self._harvest.take(span.trace_id)
            send_frame(final)
        finally:
            self._done_one()

    def _submit(self, msg: Dict[str, Any]):
        """Admit + submit one request; returns ``("reply", dict)`` for
        control ops, ``("future", fut, t0, span, flight, sf_key)`` for
        inference, or ``("collapse", flight, t0, span)`` when the
        single-flight map folded this request into an identical one
        already being forwarded."""
        op = msg.get("op")
        if op == "ping":
            return ("reply", {"ok": True, "pid": os.getpid(),
                              "draining": self.draining})
        if op != "infer":
            raise ValueError(f"unknown wire op {op!r}")
        span = self._serve_span(msg)
        deadline_ms = msg.get("deadline_ms")
        if deadline_ms is not None and float(deadline_ms) <= 0.0:
            # the router propagates *remaining* milliseconds: non-
            # positive means the end-to-end deadline is already blown —
            # shed at the door instead of burning a batch slot on an
            # answer nobody will read
            self._m_expired_shed.add(1)
            self._end_span(span, DeadlineExceeded)
            raise DeadlineExceeded(
                f"request arrived at replica pid={os.getpid()} already "
                f"expired ({deadline_ms}ms remaining)"
            )
        with self._lock:
            if self._draining:
                self._end_span(span, ReplicaDraining)
                raise ReplicaDraining(
                    f"replica pid={os.getpid()} is draining"
                )
            self._inflight += 1
            self._m_inflight.set(self._inflight)
        ok = False
        flight = None
        sf_key = None
        try:
            inject.fire("supervisor.replica_serve")
            self._m_requests.add(1)
            if self._single_flight is not None:
                try:
                    sf_key = (
                        msg.get("model_id"), canonical_digest(msg["value"])
                    )
                except Exception:
                    sf_key = None  # fail-open: undigestable -> forward
            if sf_key is not None:
                neg = self._negative.get(sf_key)
                if neg is not None:
                    # known-poison input: replay the typed error reply
                    # without burning a batch slot (ok stays False so
                    # the finally releases this request's inflight)
                    reply = dict(neg)
                    reply["cache"] = "negative"
                    if span is not None:
                        span.set_attribute("cache", "negative")
                    self._end_span(span)
                    return ("reply", reply)
                flight, leader = self._single_flight.claim(sf_key)
                if not leader:
                    # collapsed: ride the leader's forward (ok=True —
                    # _finish_collapse owns the inflight release)
                    ok = True
                    return ("collapse", flight, time.monotonic(), span)
            # the serve span is current for the submit, so the micro-
            # batcher's "serving.request" span becomes its child — one
            # stitched lineage from the router's root down to the batch
            with tracer.use_span(span):
                fut = self._server.submit(
                    msg["value"],
                    model_id=msg.get("model_id"),
                    deadline_ms=msg.get("deadline_ms"),
                    tenant=msg.get("tenant"),
                )
            ok = True
            return ("future", fut, time.monotonic(), span, flight, sf_key)
        except Exception as exc:
            self._end_span(span, type(exc))
            if flight is not None:
                # a failed leader must still publish, or followers hang
                self._single_flight.resolve(flight, exc=exc)
            self._maybe_negative(sf_key, exc)
            raise
        finally:
            if not ok:
                self._done_one()

    def _serve_span(self, msg: Dict[str, Any]):
        """Open this replica's serve span as a child of the REMOTE
        parent whose ``(trace_id, span_id)`` rode the request envelope;
        None when tracing is off or no context was sent."""
        remote = msg.get("trace")
        if not tracer.enabled or remote is None:
            return None
        try:
            remote = (int(remote[0]), int(remote[1]))
        except (TypeError, ValueError, IndexError):
            return None
        return tracer.start_span(
            "replica.serve", remote=remote,
            model_id=msg.get("model_id"), pid=os.getpid(),
        )

    @staticmethod
    def _end_span(span, exc_type=None) -> None:
        if span is None:
            return
        if exc_type is not None:
            span.set_attribute("error", exc_type.__name__)
        span.end()

    def _finish(self, fut, t0: float, span=None, flight=None,
                sf_key=None) -> Dict[str, Any]:
        try:
            result = fut.result(timeout=self._request_timeout_s)
            reply = {
                "ok": True,
                "result": np.asarray(result),
                # submit->result time: the replica-attributed share of
                # the client-observed latency
                "server_ms": round((time.monotonic() - t0) * 1000.0, 3),
            }
            # the micro-batcher stamps its phase decomposition onto the
            # future before resolving it; forward it on the reply
            phases = getattr(fut, "sparkdl_phases", None)
            if phases:
                reply["phases"] = dict(phases)
            if flight is not None:
                # fan the result out to collapsed followers — minus
                # "spans", which belong to this request's trace only
                self._single_flight.resolve(flight, reply=dict(reply))
            if span is not None:
                span.end()
                # piggyback this trace's finished replica-side spans
                # (bounded + sampled by the harvest sink) on the reply
                reply["spans"] = self._harvest.take(span.trace_id)
            return reply
        except Exception as exc:
            self._end_span(span, type(exc))
            if flight is not None:
                self._single_flight.resolve(flight, exc=exc)
            self._maybe_negative(sf_key, exc)
            raise
        finally:
            self._done_one()

    def _finish_collapse(self, flight, t0: float, span=None) -> Dict[str, Any]:
        """Follower half of the single-flight: wait for the leader's
        outcome and restamp it as this request's reply.  The leader's
        phase breakdown is dropped (it decomposes the *leader's* wall
        time, which is longer than this follower's wait) and
        ``server_ms`` becomes the follower's own submit->fan-out time so
        router-side phase accounting still sums to what the client saw."""
        try:
            if not flight.event.wait(timeout=self._request_timeout_s):
                raise TimeoutError(
                    "single-flight leader never resolved "
                    f"(key={flight.key!r})"
                )
            if flight.exc is not None:
                raise flight.exc
            reply = dict(flight.reply)
            reply.pop("phases", None)
            reply.pop("spans", None)
            reply["cache"] = "collapsed"
            reply["server_ms"] = round((time.monotonic() - t0) * 1000.0, 3)
            if span is not None:
                span.set_attribute("cache", "collapsed")
                span.end()
                reply["spans"] = self._harvest.take(span.trace_id)
            return reply
        except Exception as exc:
            self._end_span(span, type(exc))
            raise
        finally:
            self._done_one()

    def _maybe_negative(self, sf_key, exc: BaseException) -> None:
        """Remember a typed-permanent error reply for this exact input.
        Transient refusals (overload, drain), deadline expiries, close
        races, and connection-shaped failures are about the *moment*;
        only input-determined failures may replay from memory."""
        if sf_key is None or self._negative is None:
            return
        if isinstance(exc, (DeadlineExceeded, ServerClosed,
                            ConnectionError, OSError)):
            return
        try:
            from sparkdl_tpu_torch.resilience.errors import is_transient

            if is_transient(exc):
                return
            self._negative.put(sf_key, wire.encode_error(exc))
        except Exception:
            pass  # the negative cache is an optimization, never a risk

    def cache_snapshot(self, top: int = 10) -> Dict[str, Any]:
        """Replica-tier view for ``/debug/cache``: single-flight and
        negative-cache state (the router tier owns the LRU view)."""
        out: Dict[str, Any] = {"tier": "replica", "enabled":
                               self._single_flight is not None}
        if self._single_flight is not None:
            out["singleflight"] = self._single_flight.stats()
        if self._negative is not None:
            out["negative"] = self._negative.stats()
        return out

    def _done_one(self) -> None:
        with self._idle:
            self._inflight -= 1
            self._m_inflight.set(self._inflight)
            if self._inflight == 0:
                self._idle.notify_all()

    # ------------------------------------------------------------------
    def drain(self, timeout_s: float = DRAIN_TIMEOUT_S) -> bool:
        """Stop admitting, wait for in-flight requests to finish (bounded
        by ``timeout_s``), then close the underlying server.  Returns
        True when the drain completed clean."""
        with self._idle:
            self._draining = True
            metrics.gauge("supervisor.replica_draining").set(1.0)
            deadline = time.monotonic() + timeout_s
            while self._inflight > 0:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._idle.wait(remaining)
            clean = self._inflight == 0
        self.close()
        return clean

    def close(self) -> None:
        self._tcp.shutdown()
        self._tcp.server_close()
        if self._thread.is_alive():
            self._thread.join(timeout=5.0)
        tracer.remove_sink(self._harvest)
        self._server.close()

    def __enter__(self) -> "ReplicaService":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()


def _ready_channel():
    """The stdout that only the ready line may use. Descriptor 1 is moved
    to stderr for the rest of the process's life, so whatever else writes
    there (a log, a kernel build's compiler, a child process that inherits
    it) goes to stderr and cannot break the handshake; the ready line goes
    to a duplicate of the original descriptor."""
    sys.stdout.flush()
    ready = os.fdopen(os.dup(1), "w")
    os.dup2(2, 1)
    return ready


def main() -> int:
    """Replica process entry: build, warm, serve, drain on SIGTERM."""
    ready_out = _ready_channel()
    # a SPARKDL_FAULT_PLAN with faultnet.* rules installs the frame-
    # level byte-corruption tap in THIS process too, so replica->router
    # reply frames brown out alongside router->replica requests
    from sparkdl_tpu_torch.serving import faultnet

    faultnet.arm()
    spec = ReplicaSpec.from_env()
    server = spec.build_server()
    warmup_report: Dict[str, Any] = {}
    if spec.warmup:
        inject.fire("supervisor.replica_warm")
        warmed = server.warmup()
        # per-bucket compile-vs-disk-load sources — what the supervisor
        # asserts when it claims a restart came up cache-warm
        cache_stats = server.status().get("program_cache", {})
        warmup_report = {
            "buckets": {m: list(b) for m, b in warmed.items()},
            "sources": cache_stats.get("warmup", cache_stats),
        }

    service = ReplicaService(
        server, host=spec.host, port=spec.port,
        request_timeout_s=spec.request_timeout_s,
    ).start()

    from sparkdl_tpu_torch.obs.server import ObsServer

    obs = ObsServer(
        port=spec.obs_port, host=spec.host, health_fn=server.status,
        cache=service.cache_snapshot,
    ).start()

    stop = threading.Event()

    def on_sigterm(signum, frame):
        stop.set()

    signal.signal(signal.SIGTERM, on_sigterm)

    print(json.dumps({
        "ready": True,
        "pid": os.getpid(),
        "port": service.port,
        "obs_port": obs.port,
        "lanes": list(service.lanes),
        "warmup": warmup_report,
        # endpoint -> engine fingerprint: the version half of every
        # result-cache key; the supervisor forwards it to router.add
        "fingerprints": server.fingerprints(),
    }), file=ready_out, flush=True)
    ready_out.close()

    while not stop.wait(0.5):
        pass
    clean = service.drain()
    obs.close()
    return 0 if clean else 3


if __name__ == "__main__":
    sys.exit(main())
