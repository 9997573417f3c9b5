"""sparkdl_tpu_torch.obs: structured tracing, span-correlated metrics,
export, SLOs and the flight recorder.

Port of the core of ``sparkdl_tpu.obs`` (host code):

- :mod:`trace`: :class:`Span` / :class:`Tracer` with parent/child nesting,
  attributes, span events, and a context-local current span whose
  cross-thread propagation is EXPLICIT (``capture()`` + ``use_span()``)
  through the data pipeline's worker threads, the serving micro-batcher and
  the streaming runner's poller;
- :mod:`export`: a bounded :class:`JsonlTraceSink` and
  :func:`prometheus_text` (what ``ModelServer.metrics_text`` returns);
- :mod:`timeseries`: :class:`TimeSeriesRecorder`, bounded in-memory metric
  history with windowed queries;
- :mod:`slo`: declarative :class:`SLO` objectives evaluated as multi-window
  burn rates (:class:`SLOEngine`), and the serving, streaming, tenant and
  availability bundles;
- :mod:`blackbox`: :class:`FlightRecorder`, the crash flight recorder
  (``SPARKDL_BLACKBOX_DIR``) that the circuit breaker's trip, a preemption
  and a watchdog hard timeout dump.

Disabled by default: every instrumentation site costs one branch until
``tracer.enable(...)`` or the ``SPARKDL_TRACE_OUT`` environment variable
(read when ``sparkdl_tpu_torch`` is imported; ``SPARKDL_TRACE_SAMPLE`` and
``SPARKDL_TRACE_SLOW_MS`` arm tail-aware sampling).

The rest of the JAX package's obs layer (``ObsServer``, the fit profiler's
hooks, ``FleetCollector``, ``diagnose`` and the stack profiler) comes with
the replica plane in the next slice (ROADMAP item 10b); its names raise
``AttributeError`` here.
"""

from sparkdl_tpu_torch.obs.blackbox import FlightRecorder
from sparkdl_tpu_torch.obs.export import JsonlTraceSink, prometheus_text
from sparkdl_tpu_torch.obs.slo import (
    SLO,
    SLOEngine,
    availability_slo,
    fleet_rollout_slos,
    rollout_slos,
    serving_slos,
    streaming_slos,
    tenant_slos,
)
from sparkdl_tpu_torch.obs.timeseries import TimeSeriesRecorder
from sparkdl_tpu_torch.obs.trace import (
    Span,
    Tracer,
    current_span,
    record_event,
    tracer,
)

ENV_VAR = "SPARKDL_TRACE_OUT"
ENV_SAMPLE = "SPARKDL_TRACE_SAMPLE"
ENV_SLOW_MS = "SPARKDL_TRACE_SLOW_MS"

#: the sink installed by :func:`enable_from_env`, if any
_env_sink = None

#: the JAX package's obs names that come with the next slice
_NEXT_SLICE = ("ObsServer", "FitProfiler", "fit_profiler", "FleetCollector",
               "diagnose", "diagnose_paths", "StackProfiler", "profile_for")


def enable_from_env() -> "JsonlTraceSink | None":
    """Enable tracing when ``SPARKDL_TRACE_OUT`` names a JSONL path (the
    buffer is appended to it at interpreter exit), and arm tail-aware
    sampling from ``SPARKDL_TRACE_SAMPLE`` / ``SPARKDL_TRACE_SLOW_MS``.
    Called from ``sparkdl_tpu_torch/__init__`` at import time, so a worker
    subprocess captures traces with no code of its own. Idempotent."""
    global _env_sink
    import atexit
    import os

    rate_spec = os.environ.get(ENV_SAMPLE, "").strip()
    if rate_spec:
        slow_spec = os.environ.get(ENV_SLOW_MS, "").strip()
        tracer.configure_sampling(
            float(rate_spec), slow_ms=float(slow_spec) if slow_spec else None)
    path = os.environ.get(ENV_VAR)
    if not path or _env_sink is not None:
        return _env_sink
    _env_sink = JsonlTraceSink(path=path)
    tracer.enable(_env_sink)
    atexit.register(_env_sink.flush)
    return _env_sink


def __getattr__(name):
    if name in _NEXT_SLICE:
        raise AttributeError(
            f"sparkdl_tpu_torch.obs.{name} is not ported yet: it comes with the replica "
            "plane in the next slice (ROADMAP item 10b)")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "ENV_SAMPLE",
    "ENV_SLOW_MS",
    "ENV_VAR",
    "FlightRecorder",
    "JsonlTraceSink",
    "SLO",
    "SLOEngine",
    "Span",
    "TimeSeriesRecorder",
    "Tracer",
    "availability_slo",
    "current_span",
    "enable_from_env",
    "fleet_rollout_slos",
    "prometheus_text",
    "record_event",
    "rollout_slos",
    "serving_slos",
    "streaming_slos",
    "tenant_slos",
    "tracer",
]
