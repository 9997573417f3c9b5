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
  and a watchdog hard timeout dump;
- :mod:`server`: :class:`ObsServer`, the opt-in stdlib HTTP introspection
  endpoint (``/metrics``, ``/healthz``, ``/slo``, ``/debug/*``;
  ``SPARKDL_OBS_PORT``);
- :mod:`hooks`: :class:`FitProfiler`, the estimators' fit, step, epoch and
  checkpoint spans and the always-on step metrics;
- :mod:`fleet`: :class:`FleetCollector`, which federates every replica's
  registry into the supervisor's recorder as labeled ``fleet.*`` series;
- :mod:`diag`: :func:`diagnose`, the offline span-file analyser (critical
  paths, latency attribution by phase and by replica, retries and hedges);
- :mod:`profile`: :class:`StackProfiler`, the sampling stack profiler
  (``SPARKDL_PROFILE``) whose stacks a flight-recorder dump carries.

Disabled by default: every instrumentation site costs one branch until
``tracer.enable(...)`` or the ``SPARKDL_TRACE_OUT`` environment variable
(read when ``sparkdl_tpu_torch`` is imported; ``SPARKDL_TRACE_SAMPLE`` and
``SPARKDL_TRACE_SLOW_MS`` arm tail-aware sampling).
"""

from sparkdl_tpu_torch.obs.blackbox import FlightRecorder
from sparkdl_tpu_torch.obs.diag import diagnose, diagnose_paths
from sparkdl_tpu_torch.obs.export import JsonlTraceSink, prometheus_text
from sparkdl_tpu_torch.obs.fleet import FleetCollector
from sparkdl_tpu_torch.obs.hooks import FitProfiler, fit_profiler
from sparkdl_tpu_torch.obs.profile import StackProfiler, profile_for
from sparkdl_tpu_torch.obs.server import ObsServer
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

    # the sampling profiler arms off its own variable (SPARKDL_PROFILE) at
    # the same import-time seam, so a replica profiles itself with no code
    from sparkdl_tpu_torch.obs import profile as _profile

    _profile.enable_from_env()
    path = os.environ.get(ENV_VAR)
    if not path or _env_sink is not None:
        return _env_sink
    _env_sink = JsonlTraceSink(path=path)
    tracer.enable(_env_sink)
    atexit.register(_env_sink.flush)
    return _env_sink


__all__ = [
    "ENV_SAMPLE",
    "ENV_SLOW_MS",
    "ENV_VAR",
    "FitProfiler",
    "FleetCollector",
    "FlightRecorder",
    "JsonlTraceSink",
    "ObsServer",
    "SLO",
    "SLOEngine",
    "Span",
    "StackProfiler",
    "TimeSeriesRecorder",
    "Tracer",
    "availability_slo",
    "current_span",
    "diagnose",
    "diagnose_paths",
    "enable_from_env",
    "fit_profiler",
    "fleet_rollout_slos",
    "profile_for",
    "prometheus_text",
    "record_event",
    "rollout_slos",
    "serving_slos",
    "streaming_slos",
    "tenant_slos",
    "tracer",
]
