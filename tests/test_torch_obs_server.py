"""The port's introspection server (``obs/server.py``) and the wired
telemetry plane (:meth:`ModelServer.start_telemetry`), on the cases of the
JAX package's ``tests/test_obs_server.py``.

Everything binds ``127.0.0.1`` with an ephemeral port (``port=0`` —
``server.port`` resolves the bound one) and scrapes over real HTTP with
urllib; no fixed ports, no external processes.
"""

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from sparkdl_tpu_torch.obs import JsonlTraceSink, ObsServer, tracer
from sparkdl_tpu_torch.obs.slo import SLO, SLOEngine
from sparkdl_tpu_torch.obs.timeseries import TimeSeriesRecorder
from sparkdl_tpu_torch.serving import ModelServer, ServingConfig
from sparkdl_tpu_torch.utils.metrics import MetricsRegistry, metrics


@pytest.fixture(autouse=True)
def clean_slate():
    tracer.disable()
    metrics.reset()
    yield
    tracer.disable()
    metrics.reset()


def _get(url, timeout=10.0):
    """GET -> (status, content_type, body_bytes); 4xx/5xx are data here,
    not exceptions."""
    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            return resp.status, resp.headers.get("Content-Type"), resp.read()
    except urllib.error.HTTPError as err:
        return err.code, err.headers.get("Content-Type"), err.read()


def _get_json(url, timeout=10.0):
    status, _, body = _get(url, timeout=timeout)
    return status, json.loads(body)


@pytest.fixture()
def registry():
    return MetricsRegistry()


# ----------------------------------------------------------------------
# endpoint payloads
# ----------------------------------------------------------------------
class TestEndpoints:
    def test_index_lists_endpoints(self, registry):
        with ObsServer(registry=registry) as srv:
            status, payload = _get_json(srv.url + "/")
        assert status == 200
        assert "/metrics" in payload["endpoints"]
        assert "/healthz" in payload["endpoints"]

    def test_metrics_is_prometheus_text(self, registry):
        registry.counter("serving.requests").add(3)
        registry.gauge("data.queue_depth").set(2.0)
        with ObsServer(registry=registry) as srv:
            status, ctype, body = _get(srv.url + "/metrics")
        assert status == 200
        assert ctype.startswith("text/plain")
        text = body.decode()
        assert "# HELP serving_requests" in text
        assert "# TYPE serving_requests counter\nserving_requests 3" in text
        assert "data_queue_depth 2" in text

    def test_healthz_default_healthy(self, registry):
        with ObsServer(registry=registry) as srv:
            status, payload = _get_json(srv.url + "/healthz")
        assert status == 200
        assert payload["healthy"] is True
        # scraping /healthz feeds the availability series
        assert registry.snapshot()["sparkdl.up"] == 1.0

    def test_healthz_503_when_degraded(self, registry):
        health = {"healthy": True, "note": "fine"}
        with ObsServer(registry=registry,
                       health_fn=lambda: dict(health)) as srv:
            assert _get_json(srv.url + "/healthz")[0] == 200
            health["healthy"] = False
            status, payload = _get_json(srv.url + "/healthz")
        assert status == 503
        assert payload["healthy"] is False
        assert payload["note"] == "fine"  # health_fn payload passes through
        assert registry.snapshot()["sparkdl.up"] == 0.0

    def test_healthz_503_when_health_fn_raises(self, registry):
        def boom():
            raise RuntimeError("probe wedged")

        with ObsServer(registry=registry, health_fn=boom) as srv:
            status, payload = _get_json(srv.url + "/healthz")
        assert status == 503
        assert "probe wedged" in payload["error"]

    def test_healthz_includes_worst_slo_state(self, registry):
        recorder = TimeSeriesRecorder(registry=registry)
        engine = SLOEngine(recorder, registry=registry)
        engine.add(SLO(name="lat", kind="threshold", series="s",
                       threshold=1.0))
        with ObsServer(registry=registry, slo_engine=engine) as srv:
            status, payload = _get_json(srv.url + "/healthz")
        assert status == 200
        assert payload["slo_worst"] == "ok"

    def test_slo_endpoint(self, registry):
        recorder = TimeSeriesRecorder(registry=registry)
        engine = SLOEngine(recorder, registry=registry)
        engine.add(SLO(name="lat", kind="threshold", series="s",
                       threshold=1.0))
        engine.evaluate_once(now=0.0)
        with ObsServer(registry=registry, slo_engine=engine) as srv:
            status, payload = _get_json(srv.url + "/slo")
        assert status == 200
        assert payload["worst"] == "ok"
        assert [row["name"] for row in payload["slos"]] == ["lat"]

    def test_debug_spans(self, registry):
        sink = JsonlTraceSink(capacity=16)
        tracer.enable(sink)
        with tracer.span("unit.work", step=1):
            pass
        with ObsServer(registry=registry, span_sink=sink) as srv:
            status, payload = _get_json(srv.url + "/debug/spans")
        assert status == 200
        assert payload["count"] == 1
        assert payload["dropped"] == 0
        assert payload["spans"][0]["name"] == "unit.work"

    def test_debug_threads_sees_this_thread(self, registry):
        with ObsServer(registry=registry) as srv:
            status, payload = _get_json(srv.url + "/debug/threads")
        assert status == 200
        assert payload["count"] >= 2  # us + the server thread at least
        names = [t["name"] for t in payload["threads"]]
        assert "MainThread" in names
        main = next(t for t in payload["threads"]
                    if t["name"] == "MainThread")
        assert any("test_torch_obs_server" in line for line in main["stack"])

    def test_debug_timeseries(self, registry):
        recorder = TimeSeriesRecorder(registry=registry)
        registry.counter("serving.requests").add(5)
        recorder.sample_once(now=1.0)
        with ObsServer(registry=registry, recorder=recorder) as srv:
            status, payload = _get_json(srv.url + "/debug/timeseries")
        assert status == 200
        assert payload["series"]["serving.requests"] == [[1.0, 5.0]]

    def test_unwired_endpoints_404_with_hint(self, registry):
        with ObsServer(registry=registry) as srv:
            for path in ("/slo", "/debug/spans", "/debug/timeseries"):
                status, payload = _get_json(srv.url + path)
                assert status == 404, path
                assert "error" in payload, path
            status, payload = _get_json(srv.url + "/nope")
        assert status == 404
        assert "/nope" in payload["error"]

    def test_handler_exception_is_500_not_crash(self, registry):
        class BadEngine:
            def report(self):
                raise RuntimeError("report boom")

            def worst_state(self):
                return "ok"

        with ObsServer(registry=registry, slo_engine=BadEngine()) as srv:
            status, payload = _get_json(srv.url + "/slo")
            assert status == 500
            assert "report boom" in payload["error"]
            # the server survived the handler failure
            assert _get_json(srv.url + "/healthz")[0] == 200

    def test_request_counter(self, registry):
        with ObsServer(registry=registry) as srv:
            for _ in range(3):
                _get(srv.url + "/healthz")
        assert registry.snapshot()["sparkdl.obs_requests"] == 3


# ----------------------------------------------------------------------
# diagnosis endpoints (/debug/diag, /debug/profile) + self-telemetry
# ----------------------------------------------------------------------
def _diag_span(name, tid, sid, parent=None, dur=5.0, **attrs):
    return {
        "name": name, "trace_id": tid, "span_id": sid,
        "parent_id": parent, "start_unix_s": 0.0,
        "duration_ms": dur, "attributes": attrs, "events": [],
    }


class TestDiagnosisEndpoints:
    @pytest.fixture(autouse=True)
    def unarm_profiler(self):
        from sparkdl_tpu_torch.obs import profile

        yield
        if profile._profiler is not None:
            profile._profiler.stop()
            profile._profiler = None

    def _stitched_sink(self):
        sink = JsonlTraceSink(capacity=16)
        sink(_diag_span(
            "router.request", 42, 1, dur=10.0, e2e_ms=10.0,
            phases={"transport": 6.0, "forward": 4.0},
            replica="replica-0",
        ))
        sink(_diag_span("replica.serve", 42, 2, parent=1, dur=6.0))
        return sink

    def test_debug_diag_report(self, registry):
        sink = self._stitched_sink()
        with ObsServer(registry=registry, span_sink=sink) as srv:
            status, payload = _get_json(srv.url + "/debug/diag")
        assert status == 200
        assert payload["requests"] == 1
        assert payload["stitched_requests"] == 1
        assert payload["attribution"]["coverage_p50"] == 1.0
        assert payload["slowest"][0]["trace_id"] == 42
        # the report's headline gauges land in the process registry
        # (the wired one only resolves exemplars)
        assert metrics.snapshot()["diag.requests"] == 1.0

    def test_debug_diag_top_param(self, registry):
        sink = self._stitched_sink()
        with ObsServer(registry=registry, span_sink=sink) as srv:
            status, payload = _get_json(
                srv.url + "/debug/diag?top=0")
        assert status == 200
        assert payload["slowest"] == []

    def test_debug_diag_404_without_sink(self, registry):
        with ObsServer(registry=registry) as srv:
            status, payload = _get_json(srv.url + "/debug/diag")
        assert status == 404
        assert "span sink" in payload["error"]

    def test_debug_profile_window(self, registry):
        with ObsServer(registry=registry) as srv:
            status, payload = _get_json(
                srv.url + "/debug/profile?seconds=0.1&interval_ms=5")
        assert status == 200
        window = payload["window"]
        assert window["running"] is False
        assert window["duration_s"] >= 0.05
        # no env-armed profiler -> no "armed" section
        assert "armed" not in payload

    def test_debug_profile_reports_armed_profiler(self, registry,
                                                  monkeypatch):
        from sparkdl_tpu_torch.obs import profile

        monkeypatch.setenv(profile.ENV_PROFILE, "1")
        profile.enable_from_env()
        with ObsServer(registry=registry) as srv:
            status, payload = _get_json(
                srv.url + "/debug/profile?seconds=0.05")
        assert status == 200
        assert payload["armed"]["running"] is True

    def test_malformed_query_params_are_400_not_500(self, registry):
        sink = self._stitched_sink()
        with ObsServer(registry=registry, span_sink=sink) as srv:
            for url in (
                "/debug/profile?seconds=banana",
                "/debug/profile?seconds=9999",   # > 60s cap
                "/debug/profile?interval_ms=0",  # below floor
                "/debug/diag?top=-5",
            ):
                status, payload = _get_json(srv.url + url)
                assert status == 400, url
                assert "query param" in payload["error"], url
            # the caller's typo never killed the server
            assert _get_json(srv.url + "/healthz")[0] == 200

    def test_per_endpoint_latency_histogram(self, registry):
        with ObsServer(registry=registry) as srv:
            _get(srv.url + "/healthz")
            _get(srv.url + "/metrics")
            _get(srv.url + "/made-up-path")
        snap = registry.snapshot(prefix="sparkdl.obs_request_ms")
        assert snap["sparkdl.obs_request_ms.healthz.count"] == 1.0
        assert snap["sparkdl.obs_request_ms.metrics.count"] == 1.0
        # unknown paths pool into "other" — a URL-scanning client
        # cannot mint unbounded label series
        assert snap["sparkdl.obs_request_ms.other.count"] == 1.0
        assert "sparkdl.obs_request_ms.healthz.p99" in snap


# ----------------------------------------------------------------------
# lifecycle
# ----------------------------------------------------------------------
class TestLifecycle:
    def test_port_resolution_and_idempotent_start(self, registry):
        srv = ObsServer(registry=registry)
        assert srv.port is None and srv.url is None
        try:
            srv.start()
            port = srv.port
            assert port and port > 0
            assert srv.start() is srv and srv.port == port
        finally:
            srv.close()
        assert srv.port is None
        srv.close()  # close is idempotent too

    def test_attach_replaces_slots(self, registry):
        recorder = TimeSeriesRecorder(registry=registry)
        registry.gauge("serving.g").set(1.0)
        recorder.sample_once(now=1.0)
        with ObsServer(registry=registry) as srv:
            assert _get_json(srv.url + "/debug/timeseries")[0] == 404
            srv.attach(recorder=recorder)
            status, payload = _get_json(srv.url + "/debug/timeseries")
            assert status == 200
            assert "serving.g" in payload["series"]

    def test_two_servers_coexist(self, registry):
        with ObsServer(registry=registry) as a, \
                ObsServer(registry=registry) as b:
            assert a.port != b.port
            assert _get_json(a.url + "/healthz")[0] == 200
            assert _get_json(b.url + "/healthz")[0] == 200


# ----------------------------------------------------------------------
# the wired plane: ModelServer.start_telemetry
# ----------------------------------------------------------------------
def _poll(fn, timeout_s=15.0, interval_s=0.05):
    """Poll ``fn`` until it returns a truthy value; fail on timeout."""
    deadline = time.monotonic() + timeout_s
    while True:
        value = fn()
        if value:
            return value
        if time.monotonic() > deadline:
            pytest.fail("condition not reached within "
                        f"{timeout_s}s: {fn}")
        time.sleep(interval_s)


class TestServingTelemetry:
    def test_end_to_end_scrape_under_traffic(self):
        server = ModelServer(ServingConfig(max_wait_ms=1.0), device="cpu")
        server.register("echo", lambda x: x, item_shape=(4,),
                        compile=False)
        with server:
            obs = server.start_telemetry(
                sample_interval_s=0.05, slo_interval_s=0.1,
            )
            assert server.start_telemetry() is obs  # idempotent
            url = obs.url

            for _ in range(20):
                fut = server.submit(np.ones((4,), dtype=np.float32))
                fut.result(timeout=10.0)

            # /metrics shows the per-endpoint SLO feed counters
            text = _poll(lambda: (
                lambda t: t if "serving_requests_echo 20" in t else None
            )(_get(url + "/metrics")[2].decode()))
            assert "# HELP serving_requests_echo" in text
            assert "serving_latency_ms_echo" in text

            # /healthz: healthy, with the worst SLO state folded in
            status, health = _get_json(url + "/healthz")
            assert status == 200
            assert health["healthy"] is True
            assert health["slo_worst"] in ("ok", "warning", "page")
            assert "echo" in health["endpoints"]

            # /slo: the latency + error objectives for the endpoint
            status, slo = _get_json(url + "/slo")
            assert status == 200
            assert [r["name"] for r in slo["slos"]] == [
                "serving.echo.errors", "serving.echo.latency",
            ]

            # /debug/timeseries: the sampled latency histogram series
            _poll(lambda: "serving.latency_ms.echo.p99" in
                  _get_json(url + "/debug/timeseries")[1]["series"])

            # concurrent scrape while the server is under load
            statuses, errors = [], []

            def scrape():
                try:
                    for _ in range(10):
                        for path in ("/metrics", "/healthz",
                                     "/debug/threads"):
                            statuses.append(_get(url + path)[0])
                except Exception as exc:  # noqa: BLE001 - recorded
                    errors.append(exc)

            scrapers = [threading.Thread(target=scrape) for _ in range(4)]
            for t in scrapers:
                t.start()
            futures = [server.submit(np.ones((4,), dtype=np.float32))
                       for _ in range(200)]
            for fut in futures:
                fut.result(timeout=10.0)
            for t in scrapers:
                t.join(timeout=30.0)
            assert not errors
            assert len(statuses) == 4 * 10 * 3
            assert set(statuses) == {200}
        # close() tears the plane down
        assert server.telemetry is None

    def test_induced_latency_regression_flips_fast_burn(self):
        # the acceptance scenario: healthy traffic, then a
        # latency regression; the fast-burn window must flip the SLO
        # out of "ok", visibly at /slo and in the slo.* gauges
        delay = {"s": 0.0}

        def fwd(x):
            if delay["s"]:
                time.sleep(delay["s"])
            return x

        server = ModelServer(ServingConfig(max_wait_ms=1.0), device="cpu")
        server.register("echo", fwd, item_shape=(4,), compile=False)
        with server:
            obs = server.start_telemetry(
                sample_interval_s=0.02,
                slo_interval_s=0.05,
                latency_threshold_ms=50.0,
                fast_window_s=0.5,
                slow_window_s=5.0,
            )
            url = obs.url

            def request():
                server.submit(
                    np.ones((4,), dtype=np.float32)
                ).result(timeout=10.0)

            for _ in range(10):  # healthy baseline, well under 50 ms
                request()
            assert _get_json(url + "/slo")[1]["worst"] == "ok"

            delay["s"] = 0.12  # regression: every request > 50 ms
            deadline = time.monotonic() + 20.0
            worst = "ok"
            while worst == "ok" and time.monotonic() < deadline:
                request()
                worst = _get_json(url + "/slo")[1]["worst"]
            assert worst in ("warning", "page")

            snap = metrics.snapshot()
            assert snap["slo.serving.echo.latency.state"] >= 1.0
            assert snap["slo.serving.echo.latency.burn_fast"] >= 6.0
            assert snap["slo.transitions"] >= 1
