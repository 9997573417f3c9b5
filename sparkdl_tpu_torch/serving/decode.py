"""Continuous-batching decode plane: slot-based autoregressive endpoints.

Port of ``sparkdl_tpu.serving.decode``. The one-shot batcher coalesces,
fires once and resolves every future together; autoregressive decode runs
for many steps of per-request state and finishes at different times. So:

- a fixed :class:`~sparkdl_tpu_torch.engine.slots.SlotPool` of N slots holds
  the per-request carries on the endpoint's device; the **fused step** runs
  over all N rows every iteration, so one program exists per pool shape,
  compiled through the engine (:data:`sparkdl_tpu_torch.engine.engine`),
  never per batch shape;
- new requests are admitted into freed slots **mid-flight**: a short
  request admitted behind a long decode completes without waiting for it;
- slots are evicted on completion (``eos_fn`` or ``max_steps``), on
  deadline expiry and on client disconnect (``emit`` returning False or
  raising);
- each token goes to the request's ``emit`` as a stream-frame dict
  (``{"result", "stream_seq", "final"}``); with ``emit=None`` the caller
  reads the stacked result off the future.

The endpoint's contract (``ModelServer.register_decode``):

- ``init_fn(prompt) -> carry``: one host call per request, the slot's first
  carry row (an array or a tensor of one fixed shape);
- ``step_fn(carries) -> (new_carries, tokens)``: a torch function over the
  ``(N, *carry_shape)`` stack on the device; row i of ``tokens`` is slot i's
  next token; vacant rows compute values nobody reads;
- ``eos_fn(token, step) -> bool``: a host stop predicate, else the stream
  runs to its step cap;
- ``max_steps``: the endpoint's cap; a request may ask for fewer.

Metrics: the ``decode.slots_occupied`` gauge, the ``decode.ttft_ms`` and
``decode.step_ms`` histograms, ``decode.requests``, ``decode.steps``,
``decode.tokens``, ``decode.errors`` and ``decode.evicted_disconnect``.
Fault sites: ``decode.step`` before each fused step, ``decode.stream``
before each emitted frame. The trace spans wait for the obs layer (ROADMAP
item 14); the replica plane's stream frames for item 10b.
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch

from sparkdl_tpu_torch.engine.slots import SlotPool, slot_block_fingerprint
from sparkdl_tpu_torch.resilience import inject
from sparkdl_tpu_torch.serving.admission import AdmissionQueue, Request, TenantPolicy
from sparkdl_tpu_torch.serving.batcher import sanitize_name, to_host
from sparkdl_tpu_torch.serving.errors import DeadlineExceeded, ServerClosed
from sparkdl_tpu_torch.utils.metrics import metrics

logger = logging.getLogger(__name__)

#: how long the worker waits on an idle poll (no occupied slot, nothing
#: queued) before looking again
_IDLE_POLL_S = 0.02


class ClientGone(ConnectionError):
    """The streaming client went away mid-decode; its slot was evicted. A
    ``ConnectionError``, so that a router treats it as a peer's death and
    never retries it elsewhere (the client is gone everywhere)."""


@dataclass
class DecodeRequest(Request):
    """One decode stream in flight.

    ``emit`` receives one dict per token (``result``, ``stream_seq``,
    ``final=False``) and a last ``final=True`` one; returning False (or
    raising) marks the client gone and evicts the slot. ``future`` resolves
    with the stacked ``(steps, *token_shape)`` output, equal to the streamed
    tokens."""

    emit: Optional[Callable[[dict], Any]] = None
    max_steps: Optional[int] = None
    #: set when the client's connection drops
    cancelled: threading.Event = field(default_factory=threading.Event)
    tokens: List[np.ndarray] = field(default_factory=list)


class DecodeEndpoint:
    """One autoregressive endpoint: an admission queue, a slot pool on
    ``device`` and one worker running the fused step over occupied slots.

    ``compile=False`` runs ``step_fn`` eagerly (deterministic: what the
    fault tests use); ``compile=True`` resolves one program for the pool
    shape through the engine. ``tenant_policy`` is the server's
    ``ServingConfig.tenant_policy``; None reads the ``SPARKDL_TENANT_*``
    variables, as a one-shot endpoint does."""

    def __init__(
        self,
        model_id: str,
        step_fn: Callable[[Any], Tuple[Any, Any]],
        init_fn: Callable[[Any], Any],
        max_steps: int,
        eos_fn: Optional[Callable[[np.ndarray, int], bool]] = None,
        n_slots: int = 8,
        queue_capacity: int = 256,
        dtype: Any = np.float32,
        compile: bool = True,
        fingerprint: Optional[str] = None,
        tenant_policy: Optional[TenantPolicy] = None,
        device="cpu",
    ):
        if max_steps < 1:
            raise ValueError(f"max_steps must be >= 1, got {max_steps}")
        self.model_id = model_id
        self._step_fn = step_fn
        self._init_fn = init_fn
        self.max_steps = int(max_steps)
        self._eos_fn = eos_fn
        self._dtype = np.dtype(dtype)
        self._compile = bool(compile)
        self._fingerprint = fingerprint
        self._m_requests = metrics.counter(f"decode.requests.{sanitize_name(model_id)}")
        self._m_ttft = metrics.histogram("decode.ttft_ms")
        self._m_step = metrics.histogram("decode.step_ms")
        self._m_tokens = metrics.counter("decode.tokens")
        self._pool = SlotPool(n_slots, occupied_gauge=metrics.gauge("decode.slots_occupied"),
                              device=device)
        self._queue = AdmissionQueue(
            queue_capacity,
            depth_gauge=metrics.gauge(f"serving.queue_depth.{model_id}"),
            shed_counter=metrics.counter("serving.shed"),
            tenant_policy=tenant_policy if tenant_policy is not None else TenantPolicy.from_env(),
        )
        self._program = None  # resolved at the first step or at warmup
        self._closed = False
        self._draining = False
        self._worker_lock = threading.Lock()
        self._worker: Optional[threading.Thread] = None
        self._idle = threading.Event()
        self._idle.set()
        #: wakes the worker out of its idle wait the moment a stream is
        #: submitted (or the endpoint closes)
        self._wake = threading.Event()

    # ------------------------------------------------------------------
    # submission
    # ------------------------------------------------------------------
    def submit(self, prompt, emit: Optional[Callable[[dict], Any]] = None,
               max_steps: Optional[int] = None, deadline_ms: Optional[float] = None,
               tenant: Optional[str] = None) -> DecodeRequest:
        """Admit one decode stream; returns the request (its ``future``
        resolves with the stacked tokens). Sheds with the one-shot plane's
        typed errors; ``max_steps`` is clamped to the endpoint's cap."""
        if self._closed or self._draining:
            raise ServerClosed(f"decode endpoint {self.model_id!r} is "
                               f"{'draining' if self._draining else 'closed'}")
        steps = self.max_steps
        if max_steps is not None:
            steps = max(1, min(int(max_steps), self.max_steps))
        deadline = time.monotonic() + deadline_ms / 1000.0 if deadline_ms is not None else None
        req = DecodeRequest(value=np.asarray(prompt, dtype=self._dtype), deadline=deadline,
                            tenant=tenant, enqueued_at=time.monotonic(), emit=emit,
                            max_steps=steps)
        metrics.counter("decode.requests").add(1)
        self._m_requests.add(1)
        self._ensure_worker()
        self._idle.clear()
        self._queue.offer(req)
        self._wake.set()
        return req

    def decode(self, prompt, max_steps: Optional[int] = None,
               deadline_ms: Optional[float] = None, tenant: Optional[str] = None,
               timeout: Optional[float] = None) -> np.ndarray:
        """Blocking: the whole ``(steps, *token_shape)`` output, no
        streaming."""
        req = self.submit(prompt, max_steps=max_steps, deadline_ms=deadline_ms, tenant=tenant)
        return req.future.result(timeout)

    # ------------------------------------------------------------------
    # warmup
    # ------------------------------------------------------------------
    def warmup(self, example_prompt=None) -> Optional[str]:
        """Resolve the fused step's program for the pool shape before
        traffic (an example prompt binds the carry shape unless a request
        already did). Returns the source (``memory``, ``disk``,
        ``compile``), None for an uncompiled endpoint."""
        if not self._compile:
            return None
        if self._pool.carry_shape is None:
            if example_prompt is None:
                raise ValueError(f"decode endpoint {self.model_id!r} has no bound carry "
                                 "shape yet; pass example_prompt")
            carry = torch.as_tensor(np.asarray(
                self._init_fn(np.asarray(example_prompt, self._dtype))))
            shape, dtype = (self._pool.n_slots, *carry.shape), carry.dtype
        else:
            shape = (self._pool.n_slots, *self._pool.carry_shape)
            dtype = self._pool.carry_dtype
        return self._resolve(torch.zeros(shape, dtype=dtype, device=self._pool.device))

    def _resolve(self, carries: torch.Tensor) -> str:
        from sparkdl_tpu_torch.engine import engine

        # one program per (model, pool shape): the pool size is part of its
        # identity, a request's batch size is not
        handle = engine.program(
            self._step_fn, (carries,),
            fingerprint=slot_block_fingerprint(self._fingerprint, "decode", self._pool.n_slots),
            name=f"decode.{self.model_id}",
        )
        self._program = handle.callable
        return handle.source

    # ------------------------------------------------------------------
    # worker
    # ------------------------------------------------------------------
    def _ensure_worker(self) -> None:
        with self._worker_lock:
            if self._closed:
                return
            if self._worker is None or not self._worker.is_alive():
                self._worker = threading.Thread(target=self._worker_loop,
                                                name=f"sparkdl-decode-{self.model_id}",
                                                daemon=True)
                self._worker.start()

    def _worker_loop(self) -> None:
        try:
            while not self._closed:
                self._admit()
                occupied = self._pool.occupied()
                if not occupied:
                    # clear, then check: a submit between the queue check
                    # and the wait sets the event, and the wait returns
                    self._wake.clear()
                    if not len(self._queue):
                        self._idle.set()
                        self._wake.wait(_IDLE_POLL_S)
                    continue
                self._step_group(occupied)
        except Exception:
            logger.exception("decode worker for %r died; failing the streams in flight",
                             self.model_id)
        finally:
            for slot in self._pool.release_all():
                req = slot.request
                if not req.future.done():
                    req.future.set_exception(ServerClosed(
                        f"decode endpoint {self.model_id!r} shut down mid-stream "
                        f"(step {slot.step})"))

    def _admit(self) -> None:
        """Fill free slots from the queue the moment they free: without
        blocking while any slot decodes, with a short poll only when the
        whole pool is idle."""
        free = self._pool.n_free
        if free == 0 or self._draining:
            return
        busy = self._pool.n_occupied > 0
        reqs = self._queue.take(free, 0.0, poll_s=0.0 if busy else _IDLE_POLL_S)
        now = time.monotonic()
        for req in reqs:
            if req.cancelled.is_set():
                self._evict_disconnected(req, step=0)
                continue
            if req.expired(now):
                metrics.counter("serving.expired").add(1)
                req.future.set_exception(DeadlineExceeded(
                    f"decode request to {self.model_id!r} expired after "
                    f"{(now - req.enqueued_at) * 1000:.1f}ms in queue"))
                continue
            try:
                carry = self._init_fn(req.value)
                slot = self._pool.acquire(req, carry, now=now)
            except Exception as exc:
                req.future.set_exception(exc)
                continue
            if slot is None:  # take() was capped at n_free
                raise RuntimeError("slot pool overflow")

    def _step_group(self, occupied) -> None:
        """One fused step over every slot, then per-slot emit and eviction:
        the continuous-batching inner loop."""
        t0 = time.monotonic()
        try:
            inject.fire("decode.step")
            carries = self._pool.carries()
            if self._compile:
                if self._program is None:
                    self._resolve(carries)
                new_carries, tokens = self._program(carries)
            else:
                new_carries, tokens = self._step_fn(carries)
            # tokens to the host BEFORE the carries are stored: an eager
            # step may return them as a view of the stack (carries[:, 0])
            tokens = to_host(tokens).copy()
            self._pool.store_carries(new_carries)
        except Exception as exc:
            # a failed fused step fails every stream on the endpoint, typed:
            # their per-slot state is gone
            metrics.counter("decode.errors").add(len(occupied))
            for slot in occupied:
                req = slot.request
                self._pool.release(slot)
                if not req.future.done():
                    req.future.set_exception(exc)
            return
        self._m_step.observe((time.monotonic() - t0) * 1000.0)
        metrics.counter("decode.steps").add(1)
        now = time.monotonic()
        for slot in occupied:
            req = slot.request
            token = np.array(tokens[slot.index], copy=True)
            slot.step += 1
            if slot.first_token_at is None:
                slot.first_token_at = now
                self._m_ttft.observe((now - req.enqueued_at) * 1000.0)
            if req.cancelled.is_set():
                self._pool.release(slot)
                self._evict_disconnected(req, step=slot.step)
                continue
            req.tokens.append(token)
            self._m_tokens.add(1)
            done = (slot.step >= req.max_steps
                    or (self._eos_fn is not None and bool(self._eos_fn(token, slot.step))))
            expired = req.expired(now)
            if not self._emit_frame(req, slot, token, final=False):
                self._pool.release(slot)
                self._evict_disconnected(req, step=slot.step)
                continue
            if expired and not done:
                steps = slot.step
                self._pool.release(slot)
                metrics.counter("serving.expired").add(1)
                req.future.set_exception(DeadlineExceeded(
                    f"decode stream to {self.model_id!r} hit its deadline at step {steps}"))
                continue
            if done:
                self._finish(req, slot)

    def _emit_frame(self, req: DecodeRequest, slot, token, final: bool) -> bool:
        """One stream frame to the request's ``emit``; False means the client
        is gone."""
        if req.emit is None:
            return True
        frame = {"result": None if final else token, "stream_seq": slot.stream_seq,
                 "final": final}
        slot.stream_seq += 1
        try:
            inject.fire("decode.stream")
            ok = req.emit(frame)
        except Exception:
            return False
        return ok is not False

    def _finish(self, req: DecodeRequest, slot) -> None:
        acquired_at = slot.acquired_at
        self._emit_frame(req, slot, None, final=True)
        self._pool.release(slot)
        if not req.future.done():
            if acquired_at is not None:
                now = time.monotonic()
                req.future.sparkdl_phases = {
                    "replica_queue": round((acquired_at - req.enqueued_at) * 1000.0, 3),
                    "decode": round((now - acquired_at) * 1000.0, 3),
                }
            req.future.set_result(np.stack(req.tokens))

    def _evict_disconnected(self, req: DecodeRequest, step: int) -> None:
        metrics.counter("decode.evicted_disconnect").add(1)
        if not req.future.done():
            req.future.set_exception(ClientGone(
                f"client of decode stream to {self.model_id!r} disconnected at step {step}; "
                "slot evicted"))

    # ------------------------------------------------------------------
    # lifecycle and introspection
    # ------------------------------------------------------------------
    def drain(self, timeout_s: float = 30.0) -> bool:
        """Admit nothing new, let the streams in flight finish; True when the
        pool emptied within ``timeout_s``."""
        self._draining = True
        for req in self._queue.close():
            req.future.set_exception(ServerClosed(
                f"decode endpoint {self.model_id!r} is draining"))
        deadline = time.monotonic() + timeout_s
        while self._pool.n_occupied:
            if time.monotonic() > deadline:
                return False
            self._idle.wait(0.01)
        return True

    def close(self) -> None:
        """Stop the worker; queued and in-flight streams fail with
        ``ServerClosed``."""
        self._closed = True
        self._wake.set()
        for req in self._queue.close():
            req.future.set_exception(ServerClosed(f"decode endpoint {self.model_id!r} closed"))
        with self._worker_lock:
            worker = self._worker
        if worker is not None and worker.is_alive():
            worker.join(timeout=5.0)

    @property
    def queue_depth(self) -> int:
        return len(self._queue)

    @property
    def slots(self) -> SlotPool:
        return self._pool

    @property
    def fingerprint(self) -> Optional[str]:
        return self._fingerprint

    @property
    def degraded(self) -> bool:
        """Never: the decode plane fails streams typed instead of tripping a
        breaker."""
        return False

    @property
    def worker_alive(self) -> bool:
        with self._worker_lock:
            return self._worker is not None and self._worker.is_alive()

    def describe(self) -> dict:
        return {
            "model_id": self.model_id,
            "kind": "decode",
            "max_steps": self.max_steps,
            "slots": self._pool.snapshot(),
            "queue_depth": self.queue_depth,
            "compiled": self._compile,
            "fingerprint": self._fingerprint,
            "draining": self._draining,
            "closed": self._closed,
        }

    def __repr__(self):
        return (f"DecodeEndpoint({self.model_id!r}, slots={self._pool.n_slots}, "
                f"max_steps={self.max_steps})")
