"""Streaming inference: unbounded sources, watermarks, exactly-once sinks.

Port of ``sparkdl_tpu.streaming``: rows that arrive continuously (change
data capture, log enrichment, near-real-time featurization) scored with
delivery guarantees, on the layers the port already has:

- **sources** (:mod:`sources`): a pull-based, replayable
  :class:`StreamSource` protocol (``poll``/``seek``/``position``) with
  :class:`FileTailSource` (tail a growing JSONL file; offset = byte
  position) and :class:`QueueSource` (in memory); event-time watermarks with
  bounded lateness (:class:`WatermarkTracker`);
- **execution** (:mod:`runner`): :class:`StreamRunner` micro-batches rows
  through the serving layer's ``AdmissionQueue`` (a full queue blocks the
  poller: backpressure, never a dropped row) and pipelines scored batches
  through the engine's ``DispatchWindow``; ``StreamRunner.from_server``
  scores through a ``ModelServer`` endpoint;
- **exactly-once sinks** (:mod:`commit`): a :class:`CommitLog` of
  per-epoch payloads and atomic commit markers, replayed idempotently on
  restart (:class:`JsonlSink` rewrites an epoch's lines;
  :class:`CallbackSink` delegates);
- **recovery**: source offsets ride in each epoch's payload; SIGTERM
  flushes the in-flight epochs, and a restarted runner resumes from the last
  committed offset.

Fault sites ``streaming.poll`` / ``streaming.sink`` / ``streaming.commit``
plug into :class:`~sparkdl_tpu_torch.resilience.FaultPlan`; the
``streaming.*`` metrics export through :mod:`sparkdl_tpu_torch.obs`.
"""

from sparkdl_tpu_torch.streaming.commit import (
    CallbackSink,
    CommitLog,
    JsonlSink,
    Sink,
)
from sparkdl_tpu_torch.streaming.runner import StreamConfig, StreamRunner
from sparkdl_tpu_torch.streaming.sources import (
    FileTailSource,
    QueueSource,
    Record,
    StreamSource,
    WatermarkTracker,
)

__all__ = [
    "CallbackSink",
    "CommitLog",
    "FileTailSource",
    "JsonlSink",
    "QueueSource",
    "Record",
    "Sink",
    "StreamConfig",
    "StreamRunner",
    "StreamSource",
    "WatermarkTracker",
]
