"""Dynamic micro-batcher: ragged slot-block dispatch, with the padded bucket
ladder as kill switch and fallback.

Port of ``sparkdl_tpu.serving.batcher``.

**Ragged path (default).** Each endpoint owns a fixed ``(n_slots, *item)``
slot block (:class:`~sparkdl_tpu_torch.engine.SlotPool`, ``n_slots =
max_batch``). A request is admitted into any free slot the moment it
arrives: no bucket pad, no linger while the card idles. A compiled endpoint
runs ONE program, a masked fused forward over the whole block whose vacant
rows ``torch.where`` zeroes on a bool mask; results go back by slot index.
A plain (``compile=False``) endpoint gets exactly the occupied rows, so no
pad row is computed. Slots stay occupied while their block is in flight in
the dispatch window and free when it completes.

**Padded fallback.** ``SPARKDL_RAGGED=0`` (read at each dispatch, so the
switch is live), or a compiled endpoint without a durable fingerprint (an
anonymous slot-block program could never persist), falls back to
coalescing, padding to a
:func:`~sparkdl_tpu_torch.transformers.utils.bucket_ladder` bucket with
:func:`~sparkdl_tpu_torch.transformers.utils.pad_to_batch`, and one warm
program per bucket.

Either way one worker thread per endpoint runs the batches. Inputs reach
the card through :class:`~sparkdl_tpu_torch.engine.PinnedStaging` (a pinned
buffer is refilled only after the copy that last read it has completed:
the pool rewrites its rows while an earlier block may still be on its way),
and results come back through the port's
:class:`~sparkdl_tpu_torch.engine.DispatchWindow`, each request's row a
copy it owns. A forward that raises fails only its batch's futures; retry
(of transient failures, within the batch's tightest deadline) and the
circuit breaker work as in the JAX package. Counters and histograms:
``serving.requests``, ``serving.batches``, ``serving.errors``,
``serving.expired``, ``serving.shed``, ``serving.latency_ms``,
``serving.batch_occupancy``, ``batcher.rows_real``,
``batcher.rows_computed``, ``batcher.pad_fraction`` (a histogram and a
gauge) and ``batcher.slot_occupancy``. The trace spans of the JAX batcher
wait for the obs layer (ROADMAP item 14).
"""

from __future__ import annotations

import logging
import os
import threading
import time
from concurrent.futures import Future
from typing import Any, Callable, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils import _pytree as pytree

from sparkdl_tpu_torch.engine import DispatchWindow, FetchFailure, PinnedStaging, SlotPool
from sparkdl_tpu_torch.resilience import inject
from sparkdl_tpu_torch.resilience.errors import CircuitOpen
from sparkdl_tpu_torch.resilience.policy import CircuitBreaker, Deadline, RetryPolicy
from sparkdl_tpu_torch.serving.admission import AdmissionQueue, Request, TenantPolicy
from sparkdl_tpu_torch.serving.cache import ProgramCache
from sparkdl_tpu_torch.serving.errors import DeadlineExceeded, ServerClosed
from sparkdl_tpu_torch.transformers.utils import _serial_inference, pad_to_batch, shape_bucket
from sparkdl_tpu_torch.utils.metrics import metrics

logger = logging.getLogger(__name__)

#: kill switch of ragged one-shot dispatch: ``SPARKDL_RAGGED=0`` puts every
#: endpoint on the padded bucket ladder
ENV_RAGGED = "SPARKDL_RAGGED"


def ragged_enabled() -> bool:
    """Ragged slot-block dispatch is on unless ``SPARKDL_RAGGED=0``; read at
    each dispatch cycle, so flipping it mid-process takes effect on the next
    batch."""
    return os.environ.get(ENV_RAGGED, "1").strip() != "0"


def sanitize_name(name: str) -> str:
    """A model id as a metric name segment: ``[a-z0-9_]``."""
    return "".join(ch if (ch.isalnum() or ch == "_") else "_" for ch in name.lower())


def widened(out):
    """A program's output as the host can hold it: bfloat16 (which numpy
    lacks) widened to float32 on the device, as the transform loop does."""
    if isinstance(out, torch.Tensor) and out.dtype == torch.bfloat16:
        return out.float()
    return out


def _contiguous(leaf):
    return leaf.contiguous() if isinstance(leaf, torch.Tensor) else leaf


def to_host(out) -> np.ndarray:
    """A plain forward's output as a numpy array."""
    if isinstance(out, torch.Tensor):
        return widened(out).detach().cpu().numpy()
    return np.asarray(out)


class ServingConfig:
    """The knobs of an online endpoint (shared by every endpoint of a
    :class:`~sparkdl_tpu_torch.serving.server.ModelServer`)."""

    def __init__(
        self,
        max_batch: int = 32,
        max_wait_ms: float = 2.0,
        queue_capacity: int = 256,
        cache_size: int = 32,
        default_deadline_ms: Optional[float] = None,
        retry: Optional[RetryPolicy] = None,
        breaker_threshold: int = 5,
        breaker_recovery_s: float = 30.0,
        tenant_policy: Optional[TenantPolicy] = None,
    ):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if max_wait_ms < 0:
            raise ValueError(f"max_wait_ms must be >= 0, got {max_wait_ms}")
        self.max_batch = int(max_batch)
        self.max_wait_ms = float(max_wait_ms)
        self.queue_capacity = int(queue_capacity)
        self.cache_size = int(cache_size)
        self.default_deadline_ms = default_deadline_ms
        # `retry` re-attempts *transient* forward failures within the
        # batch's deadline; `breaker_threshold` consecutive failures trip
        # the endpoint's breaker (degraded in status()) for
        # `breaker_recovery_s`
        self.retry = retry
        self.breaker_threshold = int(breaker_threshold)
        self.breaker_recovery_s = float(breaker_recovery_s)
        # per-tenant fair-share admission; None falls back to the
        # SPARKDL_TENANT_* variables at endpoint construction
        self.tenant_policy = tenant_policy

    def __repr__(self):
        return (f"ServingConfig(max_batch={self.max_batch}, max_wait_ms={self.max_wait_ms}, "
                f"queue_capacity={self.queue_capacity}, cache_size={self.cache_size}, "
                f"default_deadline_ms={self.default_deadline_ms}, retry={self.retry}, "
                f"breaker_threshold={self.breaker_threshold}, "
                f"breaker_recovery_s={self.breaker_recovery_s}, "
                f"tenant_policy={self.tenant_policy})")


class MicroBatcher:
    """One online endpoint: an admission queue, a worker and the warm
    programs of one model ``forward(batch) -> batch`` on ``device``.

    ``forward`` takes a tensor of ``(n, *item_shape)`` on ``device`` and
    returns one. With ``params`` (a pytree of tensors on ``device``) it is
    ``forward(params, batch)``, and every program of the endpoint takes
    the params as an input: the ragged program and each rung of the ladder
    share the one copy of the weights, and a persisted package holds code
    only. Tensors a forward closes over are compiled into each program
    instead. ``compile=False`` runs the forward eagerly instead of through
    a compiled program: the way for a callable that cannot be exported, and
    what the fault-injection tests use for deterministic workers."""

    def __init__(
        self,
        model_id: str,
        forward: Callable[..., Any],
        config: ServingConfig,
        cache: ProgramCache,
        item_shape: Optional[Sequence[int]] = None,
        dtype: Any = np.float32,
        compile: bool = True,
        fingerprint: Optional[str] = None,
        prologue: Optional[Callable[[Any], Any]] = None,
        params: Any = None,
        device="cpu",
    ):
        self.model_id = model_id
        self._config = config
        self._cache = cache
        self._device = torch.device(device)
        # every internal forward takes (params, batch); an endpoint without
        # params passes the empty tuple. The weights go in contiguous (a copy
        # only of those that are not): a package compiled on the card for a
        # non-contiguous weight input computed wrong rows
        self._params = (pytree.tree_map(_contiguous, params) if params is not None else ())
        if params is None:
            def core(p, x, _fwd=forward):
                return _fwd(x)
        else:
            core = forward
        # the input prologue (cast, resize, normalize:
        # transformers.utils.make_input_prologue) in front of the forward, so
        # that a compiled endpoint compiles prologue and model as one
        # program; a plain endpoint applies it eagerly (same math)
        self._prologue = prologue
        if prologue is None:
            self._fused_forward = core
        else:
            def _fused_forward(p, x, _fwd=core, _pro=prologue):
                return _fwd(p, _pro(x))

            self._fused_forward = _fused_forward

        def padded(p, x, _fwd=self._fused_forward):
            return widened(_fwd(p, x))

        # made once: the engine keys an unfingerprinted program by its
        # function object
        self._padded_forward = padded
        self._masked = self._masked_fused()
        mid = sanitize_name(model_id)
        self._m_requests = metrics.counter(f"serving.requests.{mid}")
        self._m_errors = metrics.counter(f"serving.errors.{mid}")
        self._m_latency = metrics.histogram(f"serving.latency_ms.{mid}")
        # durable model identity: makes the endpoint's programs persistable
        # and (for compiled endpoints) enables ragged dispatch
        self._fingerprint = fingerprint
        # batch i's device-to-host copy streams while batch i+1 computes;
        # drained whenever the queue goes idle, so that a lone request never
        # waits on the window
        self._window = DispatchWindow(depth=0 if _serial_inference() else None,
                                      capture_errors=True)
        self._staging = (PinnedStaging(self._device, slots=self._window.depth + 2)
                         if self._device.type == "cuda" else None)
        self._item_shape: Optional[Tuple[int, ...]] = (
            tuple(int(d) for d in item_shape) if item_shape is not None else None)
        self._dtype = np.dtype(dtype)
        self._compile = bool(compile)
        # the one-shot slot block on the host: a request holds its slot from
        # admission until its row is returned (across its block's time in
        # the window), so the gauge reads "requests resident on the card".
        # Worker-owned; the gauge is the only read from other threads
        self._pool = SlotPool(config.max_batch,
                              occupied_gauge=metrics.gauge("batcher.slot_occupancy"))
        # pad accounting: rows asked for against rows computed
        self._m_rows_real = metrics.counter("batcher.rows_real")
        self._m_rows_computed = metrics.counter("batcher.rows_computed")
        self._m_pad_gauge = metrics.gauge("batcher.pad_fraction")
        self._queue = AdmissionQueue(
            config.queue_capacity,
            depth_gauge=metrics.gauge(f"serving.queue_depth.{model_id}"),
            shed_counter=metrics.counter("serving.shed"),
            tenant_policy=(config.tenant_policy if config.tenant_policy is not None
                           else TenantPolicy.from_env()),
        )
        self._breaker = CircuitBreaker(
            name=f"serving.{model_id}",
            failure_threshold=config.breaker_threshold,
            recovery_s=config.breaker_recovery_s,
        )
        self._closed = False
        self._worker_lock = threading.Lock()
        self._worker: Optional[threading.Thread] = None

    # ------------------------------------------------------------------
    # submission
    # ------------------------------------------------------------------
    def submit(self, value, deadline_ms: Optional[float] = None,
               tenant: Optional[str] = None) -> Future:
        """Admit one item; returns a Future of its output row (a numpy
        array). Raises :class:`ServerOverloaded` when the queue is full
        (``TenantThrottled`` when only ``tenant`` is over its cap) and
        :class:`ServerClosed` after :meth:`close`; a deadline that expires
        while queued fails the future with :class:`DeadlineExceeded`."""
        if self._closed:
            raise ServerClosed(f"endpoint {self.model_id!r} is closed")
        arr = np.asarray(value, dtype=self._dtype)
        if self._item_shape is None:
            # the first request binds the endpoint's item shape
            self._item_shape = tuple(arr.shape)
        elif tuple(arr.shape) != self._item_shape:
            raise ValueError(
                f"endpoint {self.model_id!r} serves items of shape {self._item_shape}; got "
                f"{tuple(arr.shape)}: one endpoint serves one item shape (register another "
                "for a second shape)"
            )
        if deadline_ms is None:
            deadline_ms = self._config.default_deadline_ms
        deadline = time.monotonic() + deadline_ms / 1000.0 if deadline_ms is not None else None
        if deadline is not None and deadline <= time.monotonic():
            # expired on arrival: fail fast without a queue slot
            metrics.counter("serving.expired").add(1)
            fut: Future = Future()
            fut.set_exception(DeadlineExceeded(
                f"request to {self.model_id!r} expired before submit ({deadline_ms}ms budget)"))
            return fut
        req = Request(value=arr, deadline=deadline, tenant=tenant, enqueued_at=time.monotonic())
        metrics.counter("serving.requests").add(1)
        self._m_requests.add(1)
        self._ensure_worker()
        self._queue.offer(req)
        return req.future

    def predict(self, value, timeout: Optional[float] = None,
                deadline_ms: Optional[float] = None, tenant: Optional[str] = None):
        """Blocking convenience: ``submit(...).result(timeout)``."""
        return self.submit(value, deadline_ms=deadline_ms, tenant=tenant).result(timeout)

    # ------------------------------------------------------------------
    # warmup
    # ------------------------------------------------------------------
    def warmup(self, buckets: Optional[Sequence[int]] = None) -> Tuple[Any, ...]:
        """Compile (or load) the endpoint's programs before traffic, so that
        a first request is not a compile: the slot-block program when ragged
        dispatch is on (unless ``buckets`` asks for the ladder), else the
        bucket ladder up to ``max_batch`` (or ``buckets``). Returns what it
        warmed: bucket sizes, and ``"ragged"`` for the slot-block program.
        Requires a known item shape. A compile that fails raises."""
        if self._item_shape is None:
            raise ValueError(f"endpoint {self.model_id!r} has no item shape yet; register "
                             "with item_shape=... to warm up before traffic")
        if not self._compile:
            return ()
        if self._ragged_active() and buckets is None:
            n = self._pool.n_slots
            start = time.perf_counter()
            key = self._cache._key(self.model_id, ("ragged", n), self._item_shape, self._dtype)
            fn = self._ragged_program()
            block, mask = self._place(np.zeros((n, *self._item_shape), self._dtype),
                                      np.zeros(n, bool))
            fn(self._params, block, mask).cpu()  # warmup waits, off the request path
            self._cache.report(self.model_id, "ragged", self._cache.source(key),
                               time.perf_counter() - start)
            return ("ragged",)
        return self._cache.warmup(
            self.model_id, self._padded_forward, self._item_shape, self._dtype, self._device,
            buckets=buckets, max_batch=self._config.max_batch, fingerprint=self._fingerprint,
            params=self._params)

    # ------------------------------------------------------------------
    # worker
    # ------------------------------------------------------------------
    def _ensure_worker(self) -> None:
        """Start (or restart after an unexpected death) the batch worker: a
        dead worker must not strand queued futures."""
        with self._worker_lock:
            if self._closed:
                return
            if self._worker is None or not self._worker.is_alive():
                self._worker = threading.Thread(
                    target=self._worker_loop, name=f"sparkdl-serving-{self.model_id}",
                    daemon=True)
                self._worker.start()

    def _worker_loop(self) -> None:
        try:
            while not self._closed:
                try:
                    if self._ragged_active():
                        self._ragged_tick()
                    else:
                        batch = self._queue.take(self._config.max_batch,
                                                 self._config.max_wait_ms / 1000.0,
                                                 flush_early=self._device_free)
                        if batch:
                            self._run_batch(batch)
                    if len(self._window) and not len(self._queue):
                        # nothing left to overlap with: complete the
                        # in-flight batches now
                        for host, meta in self._window.drain():
                            self._complete(host, meta)
                except Exception:  # a batcher fault: log it and keep serving
                    logger.exception("serving worker for %r survived an internal error",
                                     self.model_id)
        finally:
            # a closing worker resolves every in-flight future
            try:
                for host, meta in self._window.drain():
                    self._complete(host, meta)
            except Exception:
                logger.exception("serving worker for %r failed draining in-flight batches "
                                 "at shutdown", self.model_id)

    def _device_free(self) -> bool:
        """True while the dispatch window takes another batch without a
        blocking fetch: the idle-card signal that cuts the coalesce linger
        short."""
        return self._window.has_room

    def _place(self, *arrays: np.ndarray) -> Tuple[torch.Tensor, ...]:
        """Host arrays on the endpoint's device, through pinned staging on
        the card; private copies on the CPU (the pool's block is rewritten
        while a result may still be read)."""
        if self._staging is not None:
            return self._staging.place(arrays)
        return tuple(torch.from_numpy(np.array(a, copy=True)) for a in arrays)

    # ------------------------------------------------------------------
    # ragged slot-block dispatch
    # ------------------------------------------------------------------
    def _ragged_active(self) -> bool:
        """Ragged dispatch, unless the kill switch says padded or the
        endpoint is compiled without a durable fingerprint."""
        if not ragged_enabled():
            return False
        return not (self._compile and self._fingerprint is None)

    def _masked_fused(self) -> Callable:
        """The one ragged program's body: the (prologue-fused) forward over
        the whole ``(n_slots, *item)`` block, vacant rows zeroed by the
        occupancy mask (bfloat16 widened to float32)."""
        forward = self._fused_forward

        def fused(params, block, mask):
            out = widened(forward(params, block))
            m = mask.reshape(mask.shape + (1,) * (out.dim() - 1))
            return torch.where(m, out, torch.zeros_like(out))

        return fused

    def _ragged_program(self) -> Callable:
        return self._cache.ragged_program(
            self.model_id, self._masked, self._pool.n_slots, self._item_shape,
            self._dtype, self._device, fingerprint=self._fingerprint, params=self._params)

    def _expire(self, reqs, now):
        """The requests of ``reqs`` still alive at ``now``; the expired ones
        fail with :class:`DeadlineExceeded`."""
        live = []
        for r in reqs:
            if r.expired(now):
                metrics.counter("serving.expired").add(1)
                r.future.set_exception(DeadlineExceeded(
                    f"request to {self.model_id!r} expired after "
                    f"{(now - r.enqueued_at) * 1000:.1f}ms in queue"))
            else:
                live.append(r)
        return live

    def _ragged_tick(self) -> None:
        """One ragged cycle: free the slots of blocks that fell out of the
        window, admit arrivals straight into free slots, dispatch them as one
        masked block."""
        pool = self._pool
        for host, meta in self._window.pop_ready():
            self._complete(host, meta)
        if pool.n_free == 0:
            # every slot rides an in-flight block: completing the oldest is
            # the only way to free one
            if len(self._window):
                host, meta = next(self._window.drain())
                self._complete(host, meta)
            return
        busy = pool.n_occupied > 0 or len(self._window) > 0
        reqs = self._queue.take(pool.n_free, 0.0, poll_s=0.0 if busy else 0.05,
                                flush_early=self._device_free)
        if not reqs:
            return
        now = time.monotonic()
        live = self._expire(reqs, now)
        if not live:
            return
        slots = []
        for r in live:
            slot = pool.acquire(r, r.value, now=now)
            if slot is None:  # take() was capped at n_free
                raise RuntimeError("slot pool overflow")
            slots.append(slot)

        if not self._compile:
            # plain endpoints get exactly the occupied rows, synchronously
            x = np.stack([r.value for r in live])
            try:
                self._forward_batch(live, len(live), self._plain_once(x), now)
            finally:
                for s in slots:
                    pool.release(s)
            return

        # compiled: the one slot-block program over the pool's block; this
        # dispatch's rows ride the mask (NOT pool.mask(): slots of blocks
        # still in flight stay out of this one's results)
        mask = np.zeros(pool.n_slots, dtype=bool)
        for s in slots:
            mask[s.index] = True

        def dispatch_once():
            inject.fire("serving.forward")
            fn = self._ragged_program()
            return fn(self._params, *self._place(pool.carries().numpy(), mask))

        self._dispatch(live, pool.n_slots, dispatch_once, now, slots)

    def _plain_once(self, x: np.ndarray) -> Callable:
        def forward_once():
            inject.fire("serving.forward")
            batch = torch.from_numpy(np.array(x, copy=True)).to(self._device)
            with torch.inference_mode():
                return to_host(self._fused_forward(self._params, batch))

        return forward_once

    def _run_batch(self, reqs) -> None:
        now = time.monotonic()
        live = self._expire(reqs, now)
        if not live:
            return
        bucket = shape_bucket(len(live), self._config.max_batch)
        x = pad_to_batch(np.stack([r.value for r in live]), bucket)
        if not self._compile:
            self._forward_batch(live, bucket, self._plain_once(x), now)
            return

        # the program is dispatched now; its blocking fetch happens when the
        # batch falls out of the dispatch window
        def dispatch_once():
            inject.fire("serving.forward")
            fn = self._cache.program(self.model_id, self._padded_forward, bucket,
                                     self._item_shape, self._dtype, self._device,
                                     fingerprint=self._fingerprint, params=self._params)
            return fn(self._params, *self._place(x))

        self._dispatch(live, bucket, dispatch_once, now, None)

    def _retried(self, live, once: Callable):
        """``once()`` under the breaker and the retry policy, retries bounded
        by the batch's tightest request deadline."""
        self._breaker.check()
        retry = self._config.retry
        if retry is None:
            return once()
        dls = [r.deadline for r in live if r.deadline is not None]
        deadline = Deadline(min(dls), what=f"batch to {self.model_id!r}") if dls else None
        return retry.call(once, deadline=deadline)

    def _dispatch(self, live, n_computed, dispatch_once, t_batch, slots) -> None:
        """Launch a compiled batch and hand its result to the window; the
        batch's futures resolve when it falls out (``_complete``)."""
        try:
            out_dev = self._retried(live, dispatch_once)
        except CircuitOpen as e:
            self._fail_batch(live, e, record=False, slots=slots)
            return
        except Exception as e:
            metrics.counter("serving.errors").add(1)
            self._m_errors.add(len(live))
            self._fail_batch(live, e, record=True, slots=slots)
            return
        t_dispatched = time.monotonic()
        for host, meta in self._window.submit(
                out_dev, meta=(live, n_computed, t_batch, t_dispatched, slots)):
            self._complete(host, meta)

    def _fail_batch(self, live, exc, record: bool, slots=None) -> None:
        if record:
            self._breaker.record_failure()
        for r in live:
            r.future.set_exception(exc)
        for s in slots or ():
            self._pool.release(s)

    def _complete(self, host, meta) -> None:
        """Resolve one batch that fell out of the dispatch window. The
        padded ladder passes ``slots=None`` (request i reads row i), the
        ragged path its slots (request j reads its slot's row, then frees
        it). Each request gets a copy of its row."""
        live, n_computed, t_batch, t_dispatched, slots = meta
        if isinstance(host, FetchFailure):
            metrics.counter("serving.errors").add(1)
            self._m_errors.add(len(live))
            self._fail_batch(live, host.error, record=True, slots=slots)
            return
        self._breaker.record_success()
        # counted before the futures resolve: a caller woken by its result
        # sees its batch counted
        self._observe_batch(len(live), n_computed)
        done = time.monotonic()
        latency = metrics.histogram("serving.latency_ms")
        for i, r in enumerate(live):
            # queue wait, dispatch, device-to-host fetch, set BEFORE the
            # result so a reader woken by set_result sees them
            r.future.sparkdl_phases = {
                "replica_queue": (t_batch - r.enqueued_at) * 1000.0,
                "forward": (t_dispatched - t_batch) * 1000.0,
                "fetch": (done - t_dispatched) * 1000.0,
            }
            r.future.set_result(np.array(host[slots[i].index if slots is not None else i]))
            ms = (done - r.enqueued_at) * 1000.0
            latency.observe(ms)
            self._m_latency.observe(ms)
        for s in slots or ():
            self._pool.release(s)

    def _forward_batch(self, live, n_computed, forward_once, t_batch) -> None:
        """A plain endpoint's batch, synchronously: forward, then resolve."""
        try:
            out = self._retried(live, forward_once)
        except CircuitOpen as e:
            self._fail_batch(live, e, record=False)
            return
        except Exception as e:
            metrics.counter("serving.errors").add(1)
            self._m_errors.add(len(live))
            self._fail_batch(live, e, record=True)
            return
        self._breaker.record_success()
        self._observe_batch(len(live), n_computed)
        done = time.monotonic()
        latency = metrics.histogram("serving.latency_ms")
        for i, r in enumerate(live):
            r.future.sparkdl_phases = {
                "replica_queue": (t_batch - r.enqueued_at) * 1000.0,
                "forward": (done - t_batch) * 1000.0,
                "fetch": 0.0,
            }
            r.future.set_result(np.array(out[i]))
            ms = (done - r.enqueued_at) * 1000.0
            latency.observe(ms)
            self._m_latency.observe(ms)

    def _observe_batch(self, n_real: int, n_computed: int) -> None:
        """Per-batch pad accounting: ``n_real`` rows asked for rode a device
        call of ``n_computed`` rows (equal on the ragged plain lane, the
        whole block on the ragged compiled lane, the bucket when padded)."""
        metrics.counter("serving.batches").add(1)
        metrics.histogram("serving.batch_occupancy").observe(n_real / n_computed)
        metrics.histogram("batcher.pad_fraction").observe((n_computed - n_real) / n_computed)
        self._m_rows_real.add(n_real)
        self._m_rows_computed.add(n_computed)
        computed = self._m_rows_computed.value
        if computed:
            self._m_pad_gauge.set(round(1.0 - self._m_rows_real.value / computed, 4))

    # ------------------------------------------------------------------
    # lifecycle and introspection
    # ------------------------------------------------------------------
    def close(self) -> None:
        """Stop admitting, fail queued requests with ``ServerClosed``, join
        the worker."""
        self._closed = True
        for r in self._queue.close():
            r.future.set_exception(ServerClosed(f"endpoint {self.model_id!r} closed"))
        with self._worker_lock:
            worker = self._worker
        if worker is not None and worker.is_alive():
            worker.join(timeout=5.0)

    @property
    def queue_depth(self) -> int:
        return len(self._queue)

    @property
    def worker_alive(self) -> bool:
        with self._worker_lock:
            return self._worker is not None and self._worker.is_alive()

    @property
    def breaker(self) -> CircuitBreaker:
        return self._breaker

    @property
    def fingerprint(self) -> Optional[str]:
        """The durable model identity the endpoint was registered with (None:
        its programs are not persisted)."""
        return self._fingerprint

    @property
    def degraded(self) -> bool:
        """True while the endpoint's circuit is not closed."""
        return self._breaker.state != "closed"

    def describe(self) -> dict:
        return {
            "model_id": self.model_id,
            "item_shape": list(self._item_shape) if self._item_shape else None,
            "dtype": self._dtype.name,
            "device": str(self._device),
            "compiled": self._compile,
            "fingerprint": self._fingerprint,
            "ragged": self._ragged_active(),
            "slot_pool": self._pool.snapshot(),
            "prologue": self._prologue is not None,
            "queue_depth": self.queue_depth,
            "queue_capacity": self._queue.capacity,
            "worker_alive": self.worker_alive,
            "closed": self._closed,
            "degraded": self.degraded,
            "breaker": self._breaker.snapshot(),
            "tenants": (self._queue.tenants() if self._queue.tenant_policy is not None
                        else None),
        }
