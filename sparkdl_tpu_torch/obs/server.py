"""Live introspection server: the telemetry plane's front door.

Port of ``sparkdl_tpu.obs.server`` (host code: a copy with the package
renamed). An opt-in stdlib ``ThreadingHTTPServer`` (no new dependencies) that
serves the process's existing telemetry over HTTP:

====================  ====================================================
``/metrics``          Prometheus text exposition
                      (:func:`~sparkdl_tpu_torch.obs.export.prometheus_text`);
                      with a fleet collector attached, replica series
                      follow with ``replica``/``version`` labels — the
                      federated view
``/metrics.json``     the registry's flat snapshot as JSON — what the
                      :class:`~sparkdl_tpu_torch.obs.fleet.FleetCollector`
                      scrapes (machine-mergeable, no exposition parsing)
``/healthz``          JSON health: the wired health callable (e.g.
                      ``ModelServer.status()``) + the worst SLO state;
                      **200** while healthy, **503** when not — the
                      orchestrator-facing contract
``/slo``              :meth:`SLOEngine.report` — every objective with
                      burn rates, state, recent transitions
``/debug/spans``      recent finished spans from the wired
                      :class:`~sparkdl_tpu_torch.obs.export.JsonlTraceSink`
``/debug/threads``    all-thread stack dump (``sys._current_frames``)
``/debug/timeseries`` :meth:`TimeSeriesRecorder.snapshot`
``/debug/fleet``      :meth:`FleetCollector.snapshot` — per-replica
                      scrape state (who answered, who is failing, with
                      what) on the supervisor
``/debug/cache``      the wired result-cache view (hit ratio, bytes,
                      top-N hot keys, single-flight collapse count) —
                      a :class:`~sparkdl_tpu_torch.serving.result_cache.
                      ResultCache`-like object or a ``(top) -> dict``
                      callable
====================  ====================================================

Design rules:

- **never on a hot-path thread**: handlers run on the HTTP server's own
  daemon threads and only read bounded snapshots (every wired component
  copies under its lock and renders outside it) — a slow scraper cannot
  extend any serving-side critical section;
- **bind-then-serve**: ``start()`` binds synchronously (``port=0`` gets
  an ephemeral port, published as ``server.port`` — what the tests use)
  and serves on a daemon thread;
- **components are attachable**: the server renders whatever is wired —
  :meth:`attach` accepts a recorder / SLO engine / span sink / health
  callable at any time, so the env-armed server
  (``SPARKDL_OBS_PORT``) starts bare and gains panes as subsystems come
  up (``ModelServer.start_telemetry`` wires all of them).

Each ``/healthz`` evaluation also records the ``sparkdl.up`` gauge
(1 healthy / 0 not), which is exactly the series
:func:`~sparkdl_tpu_torch.obs.slo.availability_slo` watches — scraping your
health endpoint is what feeds your availability objective.
"""

from __future__ import annotations

import json
import sys
import threading
import time
import traceback
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, Optional

from sparkdl_tpu_torch.utils.metrics import MetricsRegistry, metrics

ENV_PORT = "SPARKDL_OBS_PORT"

#: the env-armed process-wide server, if any (see :func:`enable_from_env`)
_server: "Optional[ObsServer]" = None

#: /debug/profile window bounds — a scraper must not park a handler
#: thread for minutes
MAX_PROFILE_SECONDS = 60.0


class BadRequest(ValueError):
    """A malformed ``/debug/*`` query parameter — surfaces as HTTP 400
    (the caller's mistake), never a 500 (the server's)."""


def _query_number(
    query: Dict[str, Any], name: str, default: float,
    lo: float, hi: float,
) -> float:
    """One numeric query param, validated: unparseable or out-of-range
    values raise :class:`BadRequest`."""
    raw = query.get(name)
    if raw is None:
        return default
    if isinstance(raw, list):
        raw = raw[-1] if raw else None
    try:
        value = float(raw)
    except (TypeError, ValueError):
        raise BadRequest(
            f"query param {name!r} must be a number, got {raw!r}"
        )
    if not (lo <= value <= hi):
        raise BadRequest(
            f"query param {name!r} must be in [{lo:g}, {hi:g}], "
            f"got {value:g}"
        )
    return value


def _thread_dump() -> Dict[str, Any]:
    """The ``/debug/threads`` payload: one stack per live thread."""
    names = {t.ident: (t.name, t.daemon) for t in threading.enumerate()}
    threads = []
    for ident, frame in sys._current_frames().items():
        name, daemon = names.get(ident, ("unknown", None))
        threads.append({
            "name": name,
            "ident": ident,
            "daemon": daemon,
            "stack": [
                line.rstrip("\n")
                for line in traceback.format_stack(frame)
            ],
        })
    threads.sort(key=lambda t: t["name"])
    return {"count": len(threads), "threads": threads}


class ObsServer:
    """Introspection HTTP server over the process's telemetry.

    ``start()`` binds and serves; ``close()`` shuts down.  All wired
    components are optional — unwired endpoints return 404 with a hint
    rather than failing."""

    def __init__(
        self,
        port: int = 0,
        host: str = "127.0.0.1",
        registry: Optional[MetricsRegistry] = None,
        recorder=None,
        slo_engine=None,
        span_sink=None,
        health_fn: Optional[Callable[[], Dict[str, Any]]] = None,
        fleet=None,
        cache=None,
    ):
        self.host = host
        self._requested_port = int(port)
        self._registry = registry if registry is not None else metrics
        self._lock = threading.Lock()
        self._recorder = recorder
        self._slo_engine = slo_engine
        self._span_sink = span_sink
        self._health_fn = health_fn
        self._fleet = fleet
        self._cache = cache
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------------
    # wiring
    # ------------------------------------------------------------------
    def attach(
        self,
        recorder=None,
        slo_engine=None,
        span_sink=None,
        health_fn: Optional[Callable[[], Dict[str, Any]]] = None,
        fleet=None,
        cache=None,
    ) -> "ObsServer":
        """Wire components after construction (each is optional; a
        later attach replaces an earlier one for that slot)."""
        with self._lock:
            if recorder is not None:
                self._recorder = recorder
            if slo_engine is not None:
                self._slo_engine = slo_engine
            if span_sink is not None:
                self._span_sink = span_sink
            if health_fn is not None:
                self._health_fn = health_fn
            if fleet is not None:
                self._fleet = fleet
            if cache is not None:
                self._cache = cache
        return self

    #: the served paths -> metric-segment labels; anything else pools
    #: into "other" so a URL-scanning client can't mint series
    _ENDPOINT_LABELS = {
        "/": "index", "/index": "index",
        "/metrics": "metrics", "/metrics.json": "metrics_json",
        "/healthz": "healthz", "/slo": "slo",
        "/debug/spans": "debug_spans",
        "/debug/threads": "debug_threads",
        "/debug/timeseries": "debug_timeseries",
        "/debug/fleet": "debug_fleet",
        "/debug/diag": "debug_diag",
        "/debug/profile": "debug_profile",
        "/debug/cache": "debug_cache",
    }

    @classmethod
    def _endpoint_label(cls, path: str) -> str:
        return cls._ENDPOINT_LABELS.get(path, "other")

    # ------------------------------------------------------------------
    # payloads (each reads ONE bounded snapshot; no handler state)
    # ------------------------------------------------------------------
    def _health_payload(self) -> Dict[str, Any]:
        with self._lock:
            health_fn = self._health_fn
            engine = self._slo_engine
        payload: Dict[str, Any] = {"healthy": True}
        if health_fn is not None:
            try:
                status = health_fn()
                payload.update(status)
                payload["healthy"] = bool(status.get("healthy", True))
            except Exception as exc:
                payload = {
                    "healthy": False,
                    "error": f"{type(exc).__name__}: {exc}",
                }
        if engine is not None:
            payload["slo_worst"] = engine.worst_state()
        # feed the availability objective: 1 while healthy, 0 while not
        self._registry.gauge("sparkdl.up").set(
            1.0 if payload["healthy"] else 0.0
        )
        return payload

    def _handle(self, path: str, query: Optional[Dict[str, Any]] = None):
        """Route one GET; returns (status, content_type, body_bytes).
        Raises :class:`BadRequest` on malformed query params (the
        handler maps it to 400)."""
        query = query or {}
        with self._lock:
            recorder = self._recorder
            engine = self._slo_engine
            sink = self._span_sink
            fleet = self._fleet
            cache = self._cache

        def jdump(status: int, obj: Any):
            body = json.dumps(obj, indent=2, default=str).encode()
            return status, "application/json", body

        if path in ("/", "/index"):
            return jdump(200, {
                "endpoints": [
                    "/metrics", "/metrics.json", "/healthz", "/slo",
                    "/debug/spans", "/debug/threads", "/debug/timeseries",
                    "/debug/fleet", "/debug/diag", "/debug/profile",
                    "/debug/cache",
                ],
            })
        if path == "/metrics":
            from sparkdl_tpu_torch.obs.export import prometheus_text

            text = prometheus_text(self._registry)
            if fleet is not None:
                # federation: every replica's latest scrape, labeled —
                # one scrape of the supervisor sees the whole fleet
                text += fleet.prometheus_block()
            return 200, "text/plain; version=0.0.4", text.encode()
        if path == "/metrics.json":
            return jdump(200, self._registry.snapshot())
        if path == "/healthz":
            payload = self._health_payload()
            return jdump(200 if payload["healthy"] else 503, payload)
        if path == "/slo":
            if engine is None:
                return jdump(404, {"error": "no SLO engine attached"})
            return jdump(200, engine.report())
        if path == "/debug/spans":
            if sink is None:
                return jdump(404, {"error": "no span sink attached"})
            spans = sink.spans()
            return jdump(200, {
                "count": len(spans),
                "dropped": sink.dropped,
                "spans": spans[-256:],
            })
        if path == "/debug/threads":
            return jdump(200, _thread_dump())
        if path == "/debug/timeseries":
            if recorder is None:
                return jdump(404, {"error": "no time-series recorder "
                                            "attached"})
            return jdump(200, {"series": recorder.snapshot()})
        if path == "/debug/fleet":
            if fleet is None:
                return jdump(404, {"error": "no fleet collector attached"})
            return jdump(200, fleet.snapshot())
        if path == "/debug/diag":
            if sink is None:
                return jdump(404, {"error": "no span sink attached"})
            from sparkdl_tpu_torch.obs.diag import diagnose

            top = int(_query_number(query, "top", 3.0, 0.0, 64.0))
            return jdump(200, diagnose(
                sink.spans(), top=top, registry=self._registry,
            ))
        if path == "/debug/profile":
            from sparkdl_tpu_torch.obs import profile as profile_mod

            seconds = _query_number(
                query, "seconds", 2.0, 0.05, MAX_PROFILE_SECONDS,
            )
            interval_ms = _query_number(
                query, "interval_ms", 10.0, 1.0, 1000.0,
            )
            payload: Dict[str, Any] = {
                "window": profile_mod.profile_for(
                    seconds, interval_s=interval_ms / 1000.0,
                ),
            }
            armed = profile_mod.profiler()
            if armed is not None:
                # the env-armed profiler's lifetime aggregate, when on
                payload["armed"] = armed.snapshot()
            return jdump(200, payload)
        if path == "/debug/cache":
            if cache is None:
                return jdump(404, {"error": "no result cache attached"})
            top = int(_query_number(query, "top", 10.0, 0.0, 64.0))
            # duck-typed slot: the router wires a ResultCache-like
            # object, replica/supervisor wire a (top) -> dict closure
            if hasattr(cache, "snapshot"):
                return jdump(200, cache.snapshot(top=top))
            return jdump(200, cache(top))
        return jdump(404, {"error": f"unknown path {path!r}"})

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------
    def start(self) -> "ObsServer":
        """Bind (synchronously — ``self.port`` is live on return) and
        serve on a daemon thread.  Idempotent."""
        with self._lock:
            if self._httpd is not None:
                return self
            outer = self

            class Handler(BaseHTTPRequestHandler):
                # one handler class per server instance: the closure is
                # the only channel to the wired components
                def do_GET(self):  # noqa: N802 (http.server API)
                    split = urllib.parse.urlsplit(self.path)
                    path = split.path
                    t0 = time.monotonic()
                    try:
                        query = urllib.parse.parse_qs(split.query)
                        status, ctype, body = outer._handle(path, query)
                    except BadRequest as exc:
                        # the caller's mistake: 400, not 500 — a typo'd
                        # ?seconds= must not read as a server fault
                        body = json.dumps({
                            "error": str(exc),
                        }).encode()
                        status, ctype = 400, "application/json"
                    except Exception as exc:  # never kill the server
                        body = json.dumps({
                            "error": f"{type(exc).__name__}: {exc}",
                        }).encode()
                        status, ctype = 500, "application/json"
                    outer._registry.counter("sparkdl.obs_requests").add(1)
                    # the telemetry plane measures itself, per endpoint
                    # (bounded label set: unknown paths pool in "other")
                    outer._registry.histogram(
                        "sparkdl.obs_request_ms"
                        f".{outer._endpoint_label(path)}"
                    ).observe((time.monotonic() - t0) * 1000.0)
                    self.send_response(status)
                    self.send_header("Content-Type", ctype)
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)

                def log_message(self, *args):  # silence stderr chatter
                    pass

            httpd = ThreadingHTTPServer(
                (self.host, self._requested_port), Handler
            )
            httpd.daemon_threads = True
            self._httpd = httpd
            self._thread = threading.Thread(
                target=httpd.serve_forever,
                kwargs={"poll_interval": 0.2},
                name="sparkdl-obs-server",
                daemon=True,
            )
            self._thread.start()
        return self

    @property
    def port(self) -> Optional[int]:
        """The bound port (resolves ``port=0``); None before start()."""
        with self._lock:
            if self._httpd is None:
                return None
            return self._httpd.server_address[1]

    @property
    def url(self) -> Optional[str]:
        port = self.port
        return None if port is None else f"http://{self.host}:{port}"

    def close(self) -> None:
        with self._lock:
            httpd, thread = self._httpd, self._thread
            self._httpd = None
            self._thread = None
        if httpd is not None:
            httpd.shutdown()      # stops serve_forever (blocks briefly)
            httpd.server_close()
        if thread is not None and thread.is_alive():
            thread.join(timeout=5.0)

    def __enter__(self) -> "ObsServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    def __repr__(self):
        return f"ObsServer(url={self.url!r})"


# ---------------------------------------------------------------------------
# process-wide arming
# ---------------------------------------------------------------------------

def server() -> Optional[ObsServer]:
    """The env-armed process-wide server, if any."""
    return _server


def enable_from_env() -> Optional[ObsServer]:
    """Start the introspection server when ``SPARKDL_OBS_PORT`` is set
    (``0`` picks an ephemeral port).  Called from
    ``sparkdl_tpu/__init__`` at import time; idempotent.  Starts bare —
    ``/metrics``, ``/healthz``, ``/debug/threads`` work immediately;
    later subsystems :meth:`ObsServer.attach` their panes (and the env
    trace sink, when one is armed, is wired as the span source)."""
    global _server
    import os

    spec = os.environ.get(ENV_PORT, "").strip()
    if not spec or _server is not None:
        return _server
    srv = ObsServer(port=int(spec))
    from sparkdl_tpu_torch import obs

    if obs._env_sink is not None:
        srv.attach(span_sink=obs._env_sink)
    srv.start()
    _server = srv
    return srv
