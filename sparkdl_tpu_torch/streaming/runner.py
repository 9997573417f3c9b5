"""StreamRunner: micro-batched continuous inference with exactly-once commits.

Port of ``sparkdl_tpu.streaming.runner``, on the port's serving and engine
seams:

- a **poller thread** pulls :class:`~sparkdl_tpu_torch.streaming.sources.
  Record` batches from the source and admits them one by one into a bounded
  :class:`~sparkdl_tpu_torch.serving.admission.AdmissionQueue` through the
  blocking ``offer_wait``: a full queue *stalls the poller*, so backpressure
  reaches the source and no row is shed;
- the **run loop** coalesces requests with the serving layer's
  first-item-then-linger ``take`` (flush on max-batch or max-wait), scores
  each micro-batch, and hands a scorer's CUDA result to the engine's
  :class:`~sparkdl_tpu_torch.engine.DispatchWindow`, which starts its copy
  to pinned host memory at once and fetches it only when it falls out of the
  window: batch ``i``'s commit overlaps batch ``i+1``'s compute, and no
  result is read back inline (a bf16 result is widened to float32 on the
  card first, since numpy has no bfloat16);
- each completed micro-batch becomes one **epoch** committed through the
  payload-then-marker :class:`~sparkdl_tpu_torch.streaming.commit.CommitLog`
  (the epoch's *outputs* ride in the payload, so recovery re-emits them bit
  for bit without scoring again), with the source's ``end_offset`` in the
  same payload;
- **recovery** on entry: replay every pending (payload without marker)
  epoch into the sink, then ``seek`` the source to the last payload's
  ``end_offset`` and go on numbering from there;
- **preemption**: the loop runs in a
  :func:`~sparkdl_tpu_torch.resilience.preempt.preemption_scope`: SIGTERM
  stops the polling, flushes everything already admitted (queue and
  dispatch window) into committed epochs, and returns with
  ``stop_reason="preempted"``; a restarted runner resumes from the last
  committed offset.

Fault sites ``streaming.poll`` (before each source poll), ``streaming.sink``
(between the payload and the sink write) and ``streaming.commit`` (between
the sink write and the marker); a ``kill`` at any of them loses and doubles
no record. Spans ``streaming.run`` (the root), ``streaming.recover``,
``streaming.poll`` (on the poller thread, re-entered explicitly),
``streaming.epoch`` (the score call) and ``streaming.commit`` (payload, sink
and marker; the JAX runner has no span there); the ``streaming.*`` metrics;
:meth:`StreamRunner.slos`.
"""

from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from sparkdl_tpu_torch.engine import DispatchWindow
from sparkdl_tpu_torch.obs.trace import tracer
from sparkdl_tpu_torch.resilience import inject
from sparkdl_tpu_torch.resilience.errors import Preempted
from sparkdl_tpu_torch.resilience.preempt import preemption_scope
from sparkdl_tpu_torch.serving.admission import AdmissionQueue, Request
from sparkdl_tpu_torch.streaming.commit import CommitLog, Sink
from sparkdl_tpu_torch.streaming.sources import StreamSource, WatermarkTracker
from sparkdl_tpu_torch.utils.metrics import metrics


def _env_int(name: str, default: int) -> int:
    spec = os.environ.get(name, "").strip()
    return int(spec) if spec else default


def _env_float(name: str, default: float) -> float:
    spec = os.environ.get(name, "").strip()
    return float(spec) if spec else default


@dataclass
class StreamConfig:
    """Knobs of one :class:`StreamRunner`.

    The flush policy is max-batch OR max-wait: a micro-batch closes the
    moment it has ``max_batch`` rows or its oldest row has waited
    ``max_wait_ms``. Environment overrides, read at construction:
    ``SPARKDL_STREAM_MAX_BATCH``, ``SPARKDL_STREAM_MAX_WAIT_MS``,
    ``SPARKDL_STREAM_QUEUE_CAPACITY``.
    """

    #: rows per micro-batch (flush threshold and scoring batch size)
    max_batch: int = field(default_factory=lambda: _env_int("SPARKDL_STREAM_MAX_BATCH", 32))
    #: linger before flushing a micro-batch that is not full
    max_wait_ms: float = field(
        default_factory=lambda: _env_float("SPARKDL_STREAM_MAX_WAIT_MS", 50.0))
    #: admission-queue bound, the backpressure depth (a full queue blocks
    #: the poller, which stops polling the source)
    queue_capacity: int = field(
        default_factory=lambda: _env_int("SPARKDL_STREAM_QUEUE_CAPACITY", 256))
    #: records per source poll
    poll_batch: int = 64
    #: idle wait between empty polls
    poll_interval_ms: float = 10.0
    #: the watermark's bounded lateness
    allowed_lateness_ms: float = 0.0
    #: dispatch-window depth (None: the engine's default, ``SPARKDL_DISPATCH_DEPTH``)
    dispatch_depth: Optional[int] = None
    #: how long a blocked poller waits per offer before checking for shutdown
    offer_timeout_s: float = 0.2
    #: an optional RetryPolicy around each micro-batch's score call
    retry: Any = None


def _jsonable(v: Any) -> Any:
    """``v`` as something ``json.dump`` takes (payloads and sink records
    round-trip through the commit log)."""
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    if isinstance(v, np.ndarray):
        return v.tolist()
    if isinstance(v, np.integer):
        return int(v)
    if isinstance(v, np.floating):
        return float(v)
    if isinstance(v, np.bool_):
        return bool(v)
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    return v


def _default_encode(record, output) -> Dict[str, Any]:
    """One sink record per input row: the source offset (the row's identity
    for set-equality checks), the input value and the scored output."""
    return {
        "offset": int(record.offset),
        "input": _jsonable(record.value),
        "output": _jsonable(output),
    }


def _split_outputs(host_out: Any, n: int) -> List[Any]:
    """Per-row outputs of one scored micro-batch: an array split on its
    leading dimension, a sequence as it is; anything else raises."""
    if isinstance(host_out, np.ndarray):
        if host_out.shape and host_out.shape[0] == n:
            return list(host_out)
        raise ValueError(
            f"scored batch has leading dim {host_out.shape[:1]} for "
            f"{n} input rows — fn must return one output per row"
        )
    if isinstance(host_out, (list, tuple)):
        if len(host_out) != n:
            raise ValueError(f"scored batch returned {len(host_out)} outputs for {n} input rows")
        return list(host_out)
    raise TypeError(
        f"fn must return an array or sequence of per-row outputs, got "
        f"{type(host_out).__name__}"
    )


class StreamRunner:
    """Pull, micro-batch, score, commit, with exactly-once delivery.

    ``fn`` scores one micro-batch: it receives the batch as a stacked
    ``np.ndarray`` when the values stack (``pack=True``, the default: what
    a forward wants) or as a plain list otherwise, and returns one output
    per row: a tensor (on the card or the CPU) or an array with that leading
    dimension, or a sequence. A tensor result goes through the engine's
    :class:`DispatchWindow`, never read back inline.
    """

    def __init__(
        self,
        source: StreamSource,
        fn: Callable[[Any], Any],
        sink: Sink,
        log_dir: str,
        config: Optional[StreamConfig] = None,
        encode: Optional[Callable[[Any, Any], Dict[str, Any]]] = None,
        pack: bool = True,
    ):
        self.source = source
        self.sink = sink
        self.config = config or StreamConfig()
        self.log = CommitLog(log_dir)
        self._encode = encode or _default_encode
        self._pack = bool(pack)
        self._score = self.config.retry.wrap(fn) if self.config.retry is not None else fn
        self._queue = AdmissionQueue(
            self.config.queue_capacity,
            depth_gauge=metrics.gauge("streaming.queue_depth"),
            shed_counter=metrics.counter("streaming.shed"),
        )
        self._watermark = WatermarkTracker(allowed_lateness_ms=self.config.allowed_lateness_ms)
        self._stop_poller = threading.Event()
        self._source_done = threading.Event()
        self._poller_error: Optional[BaseException] = None
        self._next_epoch = (self.log.last_committed() or 0) + 1
        self._m_records_in = metrics.counter("streaming.records_in")
        self._m_sink_records = metrics.counter("streaming.sink_records")
        self._m_epochs = metrics.counter("streaming.epochs_committed")
        self._m_replays = metrics.counter("streaming.replays")
        self._m_late = metrics.counter("streaming.late_records")
        self._m_wm_lag = metrics.gauge("streaming.watermark_lag_ms")
        self._m_consumer_lag = metrics.gauge("streaming.consumer_lag")
        self._m_offset = metrics.gauge("streaming.committed_offset")
        self._m_latency = metrics.histogram("streaming.record_latency_ms")

    # ------------------------------------------------------------------
    # constructors
    # ------------------------------------------------------------------
    @classmethod
    def from_server(
        cls,
        source: StreamSource,
        server,
        sink: Sink,
        log_dir: str,
        model_id: Optional[str] = None,
        config: Optional[StreamConfig] = None,
        encode: Optional[Callable[[Any, Any], Dict[str, Any]]] = None,
    ) -> "StreamRunner":
        """Score through a :class:`~sparkdl_tpu_torch.serving.server.
        ModelServer` endpoint: each row of a micro-batch is submitted to the
        endpoint (its admission control, slot block and warm programs) and
        the futures are gathered in order; the endpoint's batcher coalesces
        them back into device blocks, so the stream shares the card fairly
        with interactive traffic."""

        def fn(values):
            futures = [server.submit(v, model_id=model_id) for v in values]
            return [f.result() for f in futures]

        return cls(source, fn, sink, log_dir, config=config, encode=encode, pack=False)

    # ------------------------------------------------------------------
    # poller thread
    # ------------------------------------------------------------------
    def _poll_loop(self, run_span) -> None:
        # explicit cross-thread propagation: the run span was captured on
        # the run() thread; the poller re-enters it
        with tracer.use_span(run_span):
            try:
                while not self._stop_poller.is_set():
                    inject.fire("streaming.poll")
                    records = self.source.poll(self.config.poll_batch)
                    if not records:
                        self._observe_lag()
                        if self.source.finished():
                            self._source_done.set()
                            return
                        self._stop_poller.wait(self.config.poll_interval_ms / 1000.0)
                        continue
                    self._m_records_in.add(len(records))
                    with tracer.span("streaming.poll", rows=len(records)):
                        for rec in records:
                            if self._watermark.observe(rec.event_time_ms):
                                self._m_late.add(1)
                            req = Request(value=rec)
                            while not self._queue.offer_wait(
                                    req, timeout_s=self.config.offer_timeout_s):
                                if self._stop_poller.is_set():
                                    return
                    self._observe_lag()
            except BaseException as exc:  # raised in run(), not lost
                self._poller_error = exc
                self._source_done.set()

    def _observe_lag(self) -> None:
        lag = self._watermark.lag_ms(time.time() * 1000.0)
        if lag is not None:
            self._m_wm_lag.set(lag)
        backlog = self.source.backlog()
        if backlog is not None:
            self._m_consumer_lag.set(backlog)

    # ------------------------------------------------------------------
    # recovery
    # ------------------------------------------------------------------
    def _recover(self) -> int:
        """Replay the pending epochs into the sink and seek the source to the
        checkpointed offset. Returns the number of epochs replayed."""
        pending = self.log.pending()
        with tracer.span("streaming.recover", pending=len(pending)):
            for epoch in pending:
                payload = self.log.payload(epoch)
                inject.fire("streaming.sink")
                self.sink.write(epoch, payload["records"])
                inject.fire("streaming.commit")
                self.log.commit(epoch)
                self._m_replays.add(1)
            offset = self.log.resume_offset()
            if offset is not None:
                self.source.seek(int(offset))
            self._next_epoch = (self.log.last_committed() or 0) + 1
        return len(pending)

    # ------------------------------------------------------------------
    # commit path
    # ------------------------------------------------------------------
    def _commit_epoch(self, epoch: int, requests: List[Request], host_out: Any) -> None:
        outputs = _split_outputs(host_out, len(requests))
        records = [self._encode(req.value, out) for req, out in zip(requests, outputs)]
        end_offset = int(requests[-1].value.offset)
        with tracer.span("streaming.commit", epoch=epoch, rows=len(records)):
            self.log.write_payload(epoch, {
                "epoch": epoch,
                "end_offset": end_offset,
                "watermark_ms": self._watermark.watermark_ms,
                "records": records,
            })
            inject.fire("streaming.sink")
            self.sink.write(epoch, records)
            inject.fire("streaming.commit")
            self.log.commit(epoch)
        now = time.monotonic()
        for req in requests:
            self._m_latency.observe((now - req.enqueued_at) * 1000.0)
        self._m_epochs.add(1)
        self._m_sink_records.add(len(records))
        self._m_offset.set(end_offset)

    def _flush_batch(self, window: DispatchWindow, requests: List[Request]) -> List:
        """Score one micro-batch and hand its result to the window; returns
        the (host, meta) pairs that are ready to commit, in order."""
        epoch = self._next_epoch
        self._next_epoch += 1
        values = [req.value.value for req in requests]
        if self._pack:
            try:
                values = np.asarray(values)
            except ValueError:  # ragged rows: score as a list
                pass
        with tracer.span("streaming.epoch", epoch=epoch, rows=len(requests)):
            result = self._score(values)
        meta = (epoch, requests)
        if isinstance(result, torch.Tensor):
            if result.dtype == torch.bfloat16:
                result = result.float()
            return window.submit(result, meta=meta)
        # a host result: whatever is in flight commits first, in order
        return list(window.drain()) + [(result, meta)]

    def _commit_all(self, ready) -> None:
        for host, (epoch, requests) in ready:
            self._commit_epoch(epoch, requests, host)

    # ------------------------------------------------------------------
    # run loop
    # ------------------------------------------------------------------
    def run(self, max_epochs: Optional[int] = None,
            idle_timeout_s: Optional[float] = None) -> Dict[str, Any]:
        """Recover, then pull, score and commit until a stop condition.

        Stops when the source reports ``finished()`` and everything admitted
        has committed (``stop_reason="source_finished"``), after
        ``max_epochs`` fresh commits (``"max_epochs"``), after
        ``idle_timeout_s`` with no record anywhere in flight
        (``"idle_timeout"``), or on SIGTERM or a requested preemption
        (``"preempted"``: in-flight work is flushed and committed first).
        """
        epochs_start = self._next_epoch
        stop_reason = "source_finished"
        with preemption_scope() as token:
            with tracer.span("streaming.run", source=type(self.source).__name__) as run_span:
                replayed = self._recover()
                window = DispatchWindow(depth=self.config.dispatch_depth)
                poller = threading.Thread(
                    target=self._poll_loop,
                    args=(tracer.capture() if run_span else None,),
                    name="sparkdl-stream-poller", daemon=True)
                poller.start()
                idle_since: Optional[float] = None
                try:
                    while True:
                        try:
                            token.check()
                        except Preempted:
                            stop_reason = "preempted"
                            break
                        if max_epochs is not None and \
                                self._next_epoch - epochs_start >= max_epochs:
                            stop_reason = "max_epochs"
                            break
                        batch = self._queue.take(self.config.max_batch,
                                                 self.config.max_wait_ms / 1000.0)
                        if batch:
                            idle_since = None
                            self._commit_all(self._flush_batch(window, batch))
                            continue
                        # an idle tick: let in-flight work land
                        self._commit_all(window.drain())
                        if self._poller_error is not None:
                            raise self._poller_error
                        if self._source_done.is_set() and len(self._queue) == 0:
                            break
                        if idle_timeout_s is not None:
                            now = time.monotonic()
                            if idle_since is None:
                                idle_since = now
                            elif now - idle_since >= idle_timeout_s:
                                stop_reason = "idle_timeout"
                                break
                finally:
                    self._stop_poller.set()
                    poller.join()
                # everything already admitted becomes committed epochs before
                # the return (the preemption contract)
                while True:
                    batch = self._queue.take(self.config.max_batch, 0.0, poll_s=0.0)
                    if not batch:
                        break
                    self._commit_all(self._flush_batch(window, batch))
                self._commit_all(window.drain())
                if run_span is not None:
                    run_span.set_attribute("stop_reason", stop_reason)
        return {
            "stop_reason": stop_reason,
            "epochs": self._next_epoch - epochs_start,
            "replayed": replayed,
            "last_committed": self.log.last_committed(),
            "committed_offset": self.log.resume_offset(),
            "watermark_ms": self._watermark.watermark_ms,
        }

    # ------------------------------------------------------------------
    def slos(self, max_watermark_lag_ms: Optional[float] = None,
             lag_objective: float = 0.95, min_commit_rate: Optional[float] = None,
             **overrides):
        """The streaming SLO bundle of this runner
        (:func:`~sparkdl_tpu_torch.obs.slo.streaming_slos`): bounded
        ``streaming.watermark_lag_ms`` (5 s by default, never below the
        configured ``allowed_lateness_ms``) and, with ``min_commit_rate``, a
        committed-epoch throughput floor. Register them on an engine:
        ``engine.add(*runner.slos(min_commit_rate=0.5))``."""
        from sparkdl_tpu_torch.obs.slo import streaming_slos

        if max_watermark_lag_ms is None:
            max_watermark_lag_ms = max(5000.0, float(self.config.allowed_lateness_ms))
        return streaming_slos(max_watermark_lag_ms=max_watermark_lag_ms,
                              lag_objective=lag_objective,
                              min_commit_rate=min_commit_rate, **overrides)

    def close(self) -> None:
        self._stop_poller.set()
        self._queue.close()
        self.sink.close()
        self.source.close()

    def __enter__(self) -> "StreamRunner":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
