"""The port's obs core (``sparkdl_tpu_torch/obs``: trace, export,
timeseries, slo, blackbox) against the JAX package's, on the CPU.

The cases of ``tests/test_obs.py``, ``tests/test_slo.py`` and
``tests/test_blackbox.py`` that touch the ported modules run against the
port (the fit profiler's cases wait for ``obs/hooks.py``, which comes with
the next slice). The parity cases at the end hold the port to the JAX
package on the same inputs: ``prometheus_text`` of the same registry
contents is the same text, an ``SLOEngine`` fed the same series goes
through the same states with the same burn rates, and one served request
leaves the same span tree (names and parentage) in both packages.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from sparkdl_tpu_torch.data import Dataset
from sparkdl_tpu_torch.obs import (
    JsonlTraceSink,
    current_span,
    prometheus_text,
    record_event,
    tracer,
)
from sparkdl_tpu_torch.obs.blackbox import FlightRecorder
from sparkdl_tpu_torch.obs.slo import (
    SLO,
    SLOEngine,
    availability_slo,
    sanitize_name,
    serving_slos,
    streaming_slos,
)
from sparkdl_tpu_torch.obs.timeseries import TimeSeriesRecorder, _interpolated_quantile
from sparkdl_tpu_torch.resilience import CircuitBreaker, RetryPolicy, TransientError
from sparkdl_tpu_torch.utils.metrics import MetricsRegistry, metrics


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def tracing_off_between_tests(monkeypatch):
    """Every test starts and ends at the pay-nothing default."""
    monkeypatch.setenv("SPARKDL_COMPILE_CACHE", "off")
    tracer.disable()
    metrics.reset()
    yield
    tracer.disable()
    metrics.reset()


@pytest.fixture()
def registry():
    return MetricsRegistry()


@pytest.fixture()
def recorder(registry):
    return TimeSeriesRecorder(registry=registry, interval_s=1.0)


def enabled_sink(capacity=4096):
    sink = JsonlTraceSink(capacity=capacity)
    tracer.enable(sink)
    return sink


def _read_json(path):
    with open(path) as fh:
        return json.load(fh)


# ----------------------------------------------------------------------
# span model
# ----------------------------------------------------------------------
class TestSpanModel:
    def test_nesting_ids_and_attributes(self):
        sink = enabled_sink()
        with tracer.span("root", job="fit") as root:
            with tracer.span("child") as child:
                child.event("tick", n=1)
            assert current_span() is root
        assert current_span() is None

        r, = sink.find("root")
        c, = sink.find("child")
        assert r["parent_id"] is None
        assert c["parent_id"] == r["span_id"]
        assert c["trace_id"] == r["trace_id"]
        assert r["attributes"] == {"job": "fit"}
        assert c["events"][0]["name"] == "tick"
        assert c["events"][0]["n"] == 1
        assert 0.0 <= c["events"][0]["offset_ms"] <= c["duration_ms"]
        # child finishes (and is delivered) before its parent
        assert sink.spans()[0]["name"] == "child"
        assert r["duration_ms"] >= c["duration_ms"] >= 0.0

    def test_sibling_roots_get_distinct_traces(self):
        sink = enabled_sink()
        with tracer.span("a"):
            pass
        with tracer.span("b"):
            pass
        a, = sink.find("a")
        b, = sink.find("b")
        assert a["trace_id"] != b["trace_id"]
        assert a["span_id"] != b["span_id"]

    def test_manual_spans_and_double_end(self):
        sink = enabled_sink()
        sp = tracer.start_span("request", model_id="m")
        sp.set_attribute("bucket", 4)
        sp.end()
        first = sink.find("request")[0]["duration_ms"]
        sp.end()  # idempotent: no second delivery, same timestamp
        assert len(sink.find("request")) == 1
        # export rounds to 4 decimals; the live value must match it
        assert sp.duration_ms == pytest.approx(first, abs=1e-4)
        assert sink.find("request")[0]["attributes"] == {
            "model_id": "m", "bucket": 4,
        }

    def test_disabled_is_a_no_op(self):
        assert not tracer.enabled
        with tracer.span("nope", k=1) as sp:
            assert sp is None
            assert current_span() is None
        assert tracer.start_span("nope") is None
        assert tracer.capture() is None
        record_event("nothing")  # must not raise with no span either

    def test_record_event_without_open_span_is_dropped(self):
        sink = enabled_sink()
        record_event("orphan")  # enabled, but no current span
        with tracer.span("s"):
            record_event("kept", x=2)
        s, = sink.find("s")
        assert [e["name"] for e in s["events"]] == ["kept"]

    def test_sink_exceptions_do_not_break_traced_code(self):
        def bad_sink(span_dict):
            raise RuntimeError("sink died")

        tracer.enable(bad_sink)
        with tracer.span("still_fine"):
            pass  # must not raise


# ----------------------------------------------------------------------
# explicit cross-thread propagation (data pipeline)
# ----------------------------------------------------------------------
class TestCrossThreadPropagation:
    def test_contextvar_does_not_leak_into_new_threads(self):
        enabled_sink()
        seen = []
        with tracer.span("outer"):
            t = threading.Thread(target=lambda: seen.append(tracer.current()))
            t.start()
            t.join()
        assert seen == [None]  # propagation is opt-in, never ambient

    def test_capture_use_span_crosses_a_thread(self):
        enabled_sink()
        seen = []
        with tracer.span("outer") as outer:
            handle = tracer.capture()

            def worker():
                with tracer.use_span(handle):
                    seen.append(tracer.current())
                seen.append(tracer.current())

            t = threading.Thread(target=worker)
            t.start()
            t.join()
        assert seen == [outer, None]
        assert not outer.ended or outer.ended  # use_span never ends it

    def test_prefetch_worker_sees_the_submitting_span(self):
        """The prefetch producer thread re-attaches the span captured
        when iteration began — events recorded inside map/decode land on
        the consumer's span across the queue boundary."""
        enabled_sink()

        def decode(x):
            record_event("decode", item=int(x))
            return x * 2

        with tracer.span("epoch") as epoch:
            ds = Dataset.from_arrays(np.arange(6)).map(decode).prefetch(2)
            assert sorted(int(v) for v in ds) == [0, 2, 4, 6, 8, 10]
        assert len(epoch.events) == 6
        assert {e["name"] for e in epoch.events} == {"decode"}

    def test_threaded_map_workers_see_the_submitting_span(self):
        enabled_sink()

        def decode(x):
            record_event("decode", item=int(x))
            return x + 1

        with tracer.span("epoch") as epoch:
            ds = Dataset.from_arrays(np.arange(8)).map(decode, num_workers=3)
            assert sorted(int(v) for v in ds) == list(range(1, 9))
        assert len(epoch.events) == 8

    def test_pipeline_untraced_when_disabled(self):
        out = list(
            Dataset.from_arrays(np.arange(4)).map(lambda x: x).prefetch(2)
        )
        assert len(out) == 4


# ----------------------------------------------------------------------
# resilience span events
# ----------------------------------------------------------------------
class TestResilienceEvents:
    def test_retry_attempts_become_span_events(self):
        enabled_sink()
        policy = RetryPolicy(max_attempts=3, base_delay_s=0.01,
                             sleep=lambda s: None)
        calls = {"n": 0}

        def flaky():
            calls["n"] += 1
            if calls["n"] < 3:
                raise TransientError("transient")
            return "ok"

        with tracer.span("step") as step:
            assert policy.call(flaky) == "ok"
        retries = [e for e in step.events if e["name"] == "retry"]
        assert [e["attempt"] for e in retries] == [1, 2]
        assert all(e["error"] == "TransientError" for e in retries)
        assert all(e["delay_s"] >= 0.0 for e in retries)

    def test_breaker_state_changes_become_span_events(self):
        enabled_sink()
        breaker = CircuitBreaker("dep", failure_threshold=2, recovery_s=60.0)

        def boom():
            raise TransientError("down")

        with tracer.span("request") as req:
            for _ in range(2):
                with pytest.raises(TransientError):
                    breaker.call(boom)
        flips = [e for e in req.events if e["name"] == "breaker_state"]
        assert len(flips) == 1
        assert flips[0]["breaker"] == "dep"
        assert flips[0]["state"] == "open"
        assert flips[0]["from_state"] == "closed"

    def test_resilience_works_untraced(self):
        policy = RetryPolicy(max_attempts=2, sleep=lambda s: None)
        calls = {"n": 0}

        def once():
            calls["n"] += 1
            if calls["n"] == 1:
                raise TransientError("x")
            return 7

        assert policy.call(once) == 7


# ----------------------------------------------------------------------
# serving fan-in
# ----------------------------------------------------------------------
class TestServingFanIn:
    def make_server(self):
        from sparkdl_tpu_torch.serving import ModelServer, ServingConfig

        server = ModelServer(
            ServingConfig(max_batch=8, max_wait_ms=25.0, queue_capacity=64),
            device="cpu",
        )
        server.register(
            "double", lambda x: x * 2.0, item_shape=(4,), compile=False
        )
        return server

    def test_batch_span_records_member_request_spans(self):
        sink = enabled_sink()
        n = 6
        with self.make_server() as server:
            barrier = threading.Barrier(n)
            results = [None] * n

            def one(i):
                barrier.wait()
                results[i] = server.predict(
                    np.full((4,), float(i), np.float32), timeout=30.0
                )

            threads = [
                threading.Thread(target=one, args=(i,)) for i in range(n)
            ]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        for i in range(n):
            np.testing.assert_allclose(results[i], 2.0 * i)

        requests = sink.find("serving.request")
        batches = sink.find("serving.batch")
        assert len(requests) == n
        assert batches, "no serving.batch span captured"
        # fan-in bookkeeping is exact in both directions: every request
        # span id appears in exactly one batch's member list, and every
        # request carries a 'coalesced' event naming its batch span
        member_ids = [
            sid for b in batches for sid in b["attributes"]["member_span_ids"]
        ]
        assert sorted(member_ids) == sorted(r["span_id"] for r in requests)
        assert sum(b["attributes"]["n_real"] for b in batches) == n
        batch_ids = {b["span_id"] for b in batches}
        for r in requests:
            coalesced = [
                e for e in r["events"] if e["name"] == "coalesced"
            ]
            assert len(coalesced) == 1
            assert coalesced[0]["batch_span"] in batch_ids

    def test_request_span_records_error(self):
        sink = enabled_sink()
        from sparkdl_tpu_torch.serving import ModelServer, ServingConfig

        def blow_up(x):
            raise ValueError("bad model")

        with ModelServer(ServingConfig(max_wait_ms=1.0), device="cpu") as server:
            server.register("bad", blow_up, item_shape=(4,), compile=False)
            fut = server.submit(np.ones((4,), np.float32))
            with pytest.raises(Exception):
                fut.result(30.0)
        r, = sink.find("serving.request")
        assert r["duration_ms"] is not None
        assert "error" in r["attributes"]

    def test_serving_untraced_when_disabled(self):
        with self.make_server() as server:
            np.testing.assert_allclose(
                server.predict(np.ones((4,), np.float32), timeout=30.0), 2.0
            )

    def test_server_metrics_text_endpoint(self):
        with self.make_server() as server:
            server.predict(np.ones((4,), np.float32), timeout=30.0)
            text = server.metrics_text(serving_only=True)
        assert "# TYPE serving_requests counter" in text
        assert "serving_requests 1" in text
        assert 'serving_latency_ms{quantile="0.5"}' in text
        assert "sparkdl_" not in text  # serving_only filters other subsystems


# ----------------------------------------------------------------------
# exporters
# ----------------------------------------------------------------------
class TestJsonlSink:
    def test_buffer_is_bounded_drop_oldest(self):
        sink = enabled_sink(capacity=4)
        for i in range(10):
            with tracer.span(f"s{i}"):
                pass
        assert len(sink) == 4
        assert sink.emitted == 10
        assert sink.dropped == 6
        assert [s["name"] for s in sink.spans()] == ["s6", "s7", "s8", "s9"]

    def test_flush_appends_parseable_jsonl(self, tmp_path):
        path = tmp_path / "trace.jsonl"
        sink = JsonlTraceSink(path=str(path), capacity=16)
        tracer.enable(sink)
        with tracer.span("first", k=1):
            pass
        assert sink.flush() == 1
        assert len(sink) == 0  # flush drains
        with tracer.span("second"):
            pass
        assert sink.flush() == 1  # append mode: first survives
        lines = path.read_text().splitlines()
        assert [json.loads(ln)["name"] for ln in lines] == ["first", "second"]
        parsed = json.loads(lines[0])
        assert parsed["attributes"] == {"k": 1}
        assert parsed["duration_ms"] >= 0.0
        assert sink.flush() == 0  # empty buffer writes nothing

    def test_flush_without_path_raises(self):
        sink = JsonlTraceSink()
        sink({"name": "x"})
        with pytest.raises(ValueError):
            sink.flush()

    def test_invalid_capacity_rejected(self):
        with pytest.raises(ValueError):
            JsonlTraceSink(capacity=0)


class TestPrometheusText:
    def test_all_metric_kinds_render(self):
        metrics.counter("serving.requests").add(3)
        metrics.gauge("data.queue_depth").set(2)
        metrics.timer("estimator.step").add_seconds(0.25)
        h = metrics.histogram("serving.latency_ms")
        for v in (1.0, 2.0, 3.0, 4.0):
            h.observe(v)
        text = prometheus_text(metrics)
        assert "# TYPE serving_requests counter\nserving_requests 3" in text
        assert "# TYPE data_queue_depth gauge\ndata_queue_depth 2" in text
        assert "estimator_step_seconds_total 0.25" in text
        assert "estimator_step_entries_total 1" in text
        assert "# TYPE serving_latency_ms summary" in text
        assert 'serving_latency_ms{quantile="0.5"} 2.5' in text
        assert 'serving_latency_ms{quantile="0.95"}' in text
        assert 'serving_latency_ms{quantile="0.99"}' in text
        assert "serving_latency_ms_sum 10" in text
        assert "serving_latency_ms_count 4" in text
        assert text.endswith("\n")

    def test_prefix_filter_and_empty_registry(self):
        metrics.counter("serving.requests").add()
        metrics.counter("data.rows_out").add()
        only = prometheus_text(metrics, prefix="serving.")
        assert "serving_requests" in only and "data_rows_out" not in only
        metrics.reset()
        assert prometheus_text(metrics) == ""

    def test_snapshot_prefix_filter(self):
        metrics.counter("serving.requests").add(2)
        metrics.counter("data.rows_out").add(5)
        snap = metrics.snapshot(prefix="serving.")
        assert snap == {"serving.requests": 2.0}

    def test_histogram_exemplar_rendered_as_comment(self):
        h = metrics.histogram("serving.latency_ms")
        h.observe(2.0, exemplar=111)
        h.observe(9.0, exemplar=42)
        text = prometheus_text(metrics)
        # parse-safe comment form, not OpenMetrics mid-line syntax —
        # plain-Prometheus scrapers must keep parsing the exposition
        assert "# EXEMPLAR serving_latency_ms trace_id=42 value=9" \
            in text
        # exemplar-free histograms render no EXEMPLAR line
        metrics.reset()
        metrics.histogram("serving.latency_ms").observe(2.0)
        assert "EXEMPLAR" not in prometheus_text(metrics)


# ----------------------------------------------------------------------
# env auto-enable
# ----------------------------------------------------------------------
def test_env_hook_captures_from_a_fresh_process(tmp_path):
    """SPARKDL_TRACE_OUT=<path> wires the tracer with zero code changes
    (what subprocess workers rely on)."""
    import os
    import subprocess
    import sys

    path = tmp_path / "env_trace.jsonl"
    code = (
        "import sparkdl_tpu_torch\n"
        "from sparkdl_tpu_torch.obs import tracer\n"
        "assert tracer.enabled\n"
        "with tracer.span('env_root', pid=1):\n"
        "    pass\n"
    )
    env = dict(os.environ, SPARKDL_TRACE_OUT=str(path))
    proc = subprocess.run(
        [sys.executable, "-c", code], env=env, cwd=_REPO,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    spans = [json.loads(ln) for ln in path.read_text().splitlines()]
    assert [s["name"] for s in spans] == ["env_root"]
    assert spans[0]["attributes"] == {"pid": 1}


# ----------------------------------------------------------------------
# tail-aware sampling
# ----------------------------------------------------------------------
class TestTailSampling:
    def test_rate_zero_drops_healthy_spans_and_counts(self):
        sink = enabled_sink()
        tracer.configure_sampling(0.0)
        for _ in range(5):
            with tracer.span("healthy"):
                pass
        assert sink.spans() == []
        assert metrics.snapshot()["sparkdl.spans_sampled_out"] == 5

    def test_error_spans_always_kept(self):
        sink = enabled_sink()
        tracer.configure_sampling(0.0)
        with tracer.span("failing") as sp:
            sp.set_attribute("error_class", "TransientError")
        assert [s["name"] for s in sink.spans()] == ["failing"]

    def test_slow_spans_always_kept(self):
        sink = enabled_sink()
        # slow_ms=0: every finished span qualifies as slow -> all kept
        # even at rate 0 (no sleeps needed to exercise the gate)
        tracer.configure_sampling(0.0, slow_ms=0.0)
        with tracer.span("slow"):
            pass
        assert [s["name"] for s in sink.spans()] == ["slow"]

    def test_decision_is_per_trace_not_per_span(self):
        sink = enabled_sink()
        tracer.configure_sampling(0.5)
        verdicts = []
        for _ in range(32):
            before = len(sink.spans())
            with tracer.span("root"):
                with tracer.span("child"):
                    pass
            kept = len(sink.spans()) - before
            assert kept in (0, 2)  # whole trace or nothing
            verdicts.append(kept)
        assert 0 in verdicts and 2 in verdicts  # both outcomes occur

    def test_rate_one_keeps_everything(self):
        sink = enabled_sink()
        tracer.configure_sampling(1.0)
        with tracer.span("kept"):
            pass
        assert len(sink.spans()) == 1
        assert "sparkdl.spans_sampled_out" not in metrics.snapshot()

    def test_disable_resets_sampling(self):
        tracer.configure_sampling(0.0)
        tracer.disable()
        sink = enabled_sink()
        with tracer.span("after_reset"):
            pass
        assert len(sink.spans()) == 1

    def test_validation(self):
        with pytest.raises(ValueError):
            tracer.configure_sampling(1.5)
        with pytest.raises(ValueError):
            tracer.configure_sampling(0.5, slow_ms=-1)

    def test_remove_sink(self):
        sink = enabled_sink()
        tracer.remove_sink(sink)
        with tracer.span("unseen"):
            pass
        assert sink.spans() == []
        tracer.remove_sink(sink)  # idempotent

    def test_env_arming(self, monkeypatch):
        from sparkdl_tpu_torch import obs

        monkeypatch.setenv(obs.ENV_SAMPLE, "0.25")
        monkeypatch.setenv(obs.ENV_SLOW_MS, "500")
        monkeypatch.delenv(obs.ENV_VAR, raising=False)
        obs.enable_from_env()
        assert tracer._sample_rate == 0.25
        assert tracer._sample_slow_ms == 500.0


# ----------------------------------------------------------------------
# exposition format details
# ----------------------------------------------------------------------
class TestPrometheusHelpAndEscaping:
    def test_help_precedes_type_for_every_family(self):
        metrics.counter("serving.requests").add(1)
        metrics.gauge("data.queue_depth").set(2)
        metrics.timer("estimator.step").add_seconds(0.1)
        metrics.histogram("serving.latency_ms").observe(1.0)
        text = prometheus_text(metrics)
        assert ("# HELP serving_requests counter serving.requests\n"
                "# TYPE serving_requests counter") in text
        assert ("# HELP data_queue_depth gauge data.queue_depth\n"
                "# TYPE data_queue_depth gauge") in text
        assert "# HELP estimator_step_seconds_total " in text
        assert "# HELP estimator_step_entries_total " in text
        assert ("# HELP serving_latency_ms histogram serving.latency_ms\n"
                "# TYPE serving_latency_ms summary") in text
        # every TYPE line is immediately preceded by its HELP line
        lines = text.splitlines()
        for i, line in enumerate(lines):
            if line.startswith("# TYPE "):
                family = line.split()[2]
                assert lines[i - 1].startswith(f"# HELP {family} ")

    def test_label_value_escaping(self):
        from sparkdl_tpu_torch.obs.export import _escape_help, _escape_label_value

        assert _escape_label_value('a"b') == 'a\\"b'
        assert _escape_label_value("a\\b") == "a\\\\b"
        assert _escape_label_value("a\nb") == "a\\nb"
        assert _escape_help("a\nb\\c") == "a\\nb\\\\c"

    def test_quantile_labels_still_byte_stable(self):
        h = metrics.histogram("serving.latency_ms")
        for v in (1.0, 2.0, 3.0, 4.0):
            h.observe(v)
        text = prometheus_text(metrics)
        assert 'serving_latency_ms{quantile="0.5"} 2.5' in text


# ----------------------------------------------------------------------
# time-series recorder
# ----------------------------------------------------------------------
class TestTimeSeriesRecorder:
    def test_samples_registry_snapshot_flat_names(self, registry, recorder):
        registry.counter("serving.requests").add(3)
        registry.gauge("data.queue_depth").set(2.0)
        registry.histogram("serving.latency_ms").observe(10.0)
        n = recorder.sample_once(now=1.0)
        assert n >= 3
        names = recorder.series_names()
        assert "serving.requests" in names
        assert "data.queue_depth" in names
        # histograms land in their snapshot() expansion
        assert "serving.latency_ms.p99" in names
        assert recorder.latest("serving.requests") == 3.0

    def test_excludes_own_ts_metrics(self, registry, recorder):
        registry.counter("serving.requests").add(1)
        recorder.sample_once(now=1.0)
        recorder.sample_once(now=2.0)
        assert not any(
            n.startswith("ts.") for n in recorder.series_names()
        )
        # but the self-metrics exist in the registry
        assert registry.snapshot()["ts.samples"] == 2

    def test_window_queries(self, registry, recorder):
        c = registry.counter("serving.requests")
        for t in range(10):
            c.add(5)
            recorder.sample_once(now=float(t))
        # full window: 10 samples, 45 of increase over 9 seconds
        assert recorder.delta("serving.requests", 100.0, now=9.0) == 45.0
        assert recorder.rate("serving.requests", 100.0, now=9.0) == 5.0
        # trailing window keeps only the in-window points
        pts = recorder.points("serving.requests", 2.0, now=9.0)
        assert [p[0] for p in pts] == [7.0, 8.0, 9.0]
        assert recorder.delta("serving.requests", 2.0, now=9.0) == 10.0

    def test_windowed_queries_need_two_points(self, registry, recorder):
        registry.counter("serving.requests").add(1)
        recorder.sample_once(now=1.0)
        assert recorder.delta("serving.requests", 10.0, now=1.0) is None
        assert recorder.rate("serving.requests", 10.0, now=1.0) is None
        assert recorder.delta("nope", 10.0, now=1.0) is None
        assert recorder.latest("nope") is None

    def test_quantile_and_fraction_over_window(self, registry, recorder):
        g = registry.gauge("serving.lag")
        for t, v in enumerate([10.0, 20.0, 30.0, 40.0, 50.0]):
            g.set(v)
            recorder.sample_once(now=float(t))
        assert recorder.quantile_over_window(
            "serving.lag", 0.5, 100.0, now=4.0
        ) == 30.0
        assert recorder.fraction_where(
            "serving.lag", lambda v: v > 25.0, 100.0, now=4.0
        ) == pytest.approx(0.6)
        assert recorder.fraction_where(
            "serving.lag", lambda v: v > 25.0, 100.0, now=500.0
        ) is None  # window slid past every point

    def test_max_points_ring_drops_oldest(self, registry):
        rec = TimeSeriesRecorder(registry=registry, max_points=5)
        g = registry.gauge("serving.lag")
        for t in range(10):
            g.set(float(t))
            rec.sample_once(now=float(t))
        pts = rec.points("serving.lag")
        assert len(pts) == 5
        assert pts[0] == (5.0, 5.0)

    def test_max_series_cap_counts_drops(self, registry):
        rec = TimeSeriesRecorder(registry=registry, max_series=3)
        for i in range(6):
            registry.gauge(f"serving.g{i}").set(1.0)
        rec.sample_once(now=1.0)
        assert len(rec.series_names()) == 3
        assert registry.snapshot()["ts.series_dropped"] >= 3

    def test_snapshot_truncates(self, registry):
        rec = TimeSeriesRecorder(registry=registry, max_points=100)
        g = registry.gauge("serving.lag")
        for t in range(50):
            g.set(float(t))
            rec.sample_once(now=float(t))
        snap = rec.snapshot(max_points=10)
        assert len(snap["serving.lag"]) == 10
        assert snap["serving.lag"][-1] == [49.0, 49.0]

    def test_interpolated_quantile(self):
        assert _interpolated_quantile([], 0.5) is None
        assert _interpolated_quantile([1.0, 2.0, 3.0], 0.5) == 2.0
        assert _interpolated_quantile([1.0, 3.0], 0.5) == 2.0
        with pytest.raises(ValueError):
            _interpolated_quantile([1.0], 1.5)

    def test_quantile_empty_window_is_none(self, registry, recorder):
        """No series at all, and a window that slid past every point,
        must both read as None — never 0.0, never a raise."""
        assert recorder.quantile_over_window(
            "serving.lag", 0.99, 10.0, now=1.0
        ) is None
        g = registry.gauge("serving.lag")
        g.set(5.0)
        recorder.sample_once(now=1.0)
        assert recorder.quantile_over_window(
            "serving.lag", 0.99, 10.0, now=500.0
        ) is None

    def test_quantile_single_point_window(self, registry, recorder):
        """One in-window point: every quantile IS that point."""
        g = registry.gauge("serving.lag")
        g.set(7.0)
        recorder.sample_once(now=1.0)
        for q in (0.0, 0.5, 0.99, 1.0):
            assert recorder.quantile_over_window(
                "serving.lag", q, 10.0, now=1.0
            ) == 7.0

    def test_quantile_window_straddles_ring_drop(self, registry):
        """A window reaching back past points the bounded ring already
        dropped must quantile over the survivors only — the dropped
        prefix silently narrows the window, it must not corrupt it."""
        rec = TimeSeriesRecorder(registry=registry, max_points=5)
        g = registry.gauge("serving.lag")
        for t in range(10):  # ring keeps t=5..9 (values 5.0..9.0)
            g.set(float(t))
            rec.sample_once(now=float(t))
        # the 100s window nominally covers all ten points; only the
        # five surviving the ring participate
        assert rec.quantile_over_window(
            "serving.lag", 0.0, 100.0, now=9.0
        ) == 5.0
        assert rec.quantile_over_window(
            "serving.lag", 0.5, 100.0, now=9.0
        ) == 7.0
        assert rec.quantile_over_window(
            "serving.lag", 1.0, 100.0, now=9.0
        ) == 9.0

    def test_validation(self, registry):
        with pytest.raises(ValueError):
            TimeSeriesRecorder(registry=registry, interval_s=0)
        with pytest.raises(ValueError):
            TimeSeriesRecorder(registry=registry, max_points=1)
        with pytest.raises(ValueError):
            TimeSeriesRecorder(registry=registry, max_series=0)

    def test_background_thread_lifecycle(self, registry):
        rec = TimeSeriesRecorder(registry=registry, interval_s=0.01)
        registry.counter("serving.requests").add(1)
        rec.start()
        try:
            deadline = time.monotonic() + 5.0
            while not rec.series_names():
                if time.monotonic() > deadline:
                    pytest.fail("background sampler never sampled")
        finally:
            rec.stop()
        assert "serving.requests" in rec.series_names()


# ----------------------------------------------------------------------
# SLO declarations
# ----------------------------------------------------------------------
class TestSLODeclaration:
    def test_sanitize_name(self):
        assert sanitize_name("My-Model v2") == "my_model_v2"
        assert sanitize_name(".weird.") == "weird"
        assert sanitize_name("...") == "unnamed"

    def test_validation(self):
        with pytest.raises(ValueError, match="unknown SLO kind"):
            SLO(name="x", kind="bogus", series="s", threshold=1.0)
        with pytest.raises(ValueError, match="objective"):
            SLO(name="x", kind="threshold", series="s", threshold=1.0,
                objective=1.0)
        with pytest.raises(ValueError, match="numerator"):
            SLO(name="x", kind="error_rate")
        with pytest.raises(ValueError, match="needs a series"):
            SLO(name="x", kind="threshold", threshold=1.0)
        with pytest.raises(ValueError, match="needs a threshold"):
            SLO(name="x", kind="threshold", series="s")
        with pytest.raises(ValueError, match="fast_window_s"):
            SLO(name="x", kind="threshold", series="s", threshold=1.0,
                fast_window_s=600.0, slow_window_s=60.0)

    def test_budget(self):
        slo = SLO(name="x", kind="threshold", series="s", threshold=1.0,
                  objective=0.99)
        assert slo.budget == pytest.approx(0.01)

    def test_factories(self):
        pair = serving_slos("My Model", latency_threshold_ms=100.0)
        assert [s.name for s in pair] == [
            "serving.my_model.latency", "serving.my_model.errors",
        ]
        assert pair[0].series == "serving.latency_ms.my_model.p99"
        assert pair[1].numerator == "serving.errors.my_model"
        bundle = streaming_slos(min_commit_rate=2.0)
        assert [s.name for s in bundle] == [
            "streaming.watermark_lag", "streaming.commit_rate",
        ]
        up = availability_slo()
        assert up.kind == "availability" and up.series == "sparkdl.up"


# ----------------------------------------------------------------------
# burn-rate state machine (synthetic clock throughout)
# ----------------------------------------------------------------------
def _latency_slo(**overrides):
    """p99-latency objective: 99% of samples under 100 ms, 60s fast /
    600s slow windows, page at burn 14, warn at 6, clear after 3."""
    defaults = dict(
        name="lat", kind="threshold", series="serving.p99",
        threshold=100.0, objective=0.99,
        fast_window_s=60.0, slow_window_s=600.0,
    )
    defaults.update(overrides)
    return SLO(**defaults)


class _Plant:
    """Drive a (recorder, engine) pair: one sample + one evaluation per
    10-second tick, gauge value chosen by the caller."""

    def __init__(self, registry, slo):
        self.registry = registry
        self.recorder = TimeSeriesRecorder(registry=registry)
        self.engine = SLOEngine(
            self.recorder, registry=registry, clock=lambda: self.t
        )
        self.engine.add(slo)
        self.gauge = registry.gauge(slo.series)
        self.t = 0.0

    def tick(self, value, n=1, step_s=10.0):
        out = None
        for _ in range(n):
            self.t += step_s
            self.gauge.set(value)
            self.recorder.sample_once(now=self.t)
            out = self.engine.evaluate_once(now=self.t)
        return out


class TestBurnRateStateMachine:
    def test_healthy_stays_ok(self, registry):
        plant = _Plant(registry, _latency_slo())
        states = plant.tick(50.0, n=30)
        assert states == {"lat": "ok"}
        st = plant.engine.report()["slos"][0]
        assert st["burn_fast"] == 0.0 and st["no_data"] is False

    def test_no_data_is_ok_not_breach(self, registry):
        plant = _Plant(registry, _latency_slo())
        assert plant.engine.evaluate_once(now=0.0) == {"lat": "ok"}
        assert plant.engine.report()["slos"][0]["no_data"] is True

    def test_total_breach_pages_and_is_hysteretic(self, registry):
        plant = _Plant(registry, _latency_slo())
        plant.tick(50.0, n=30)  # 5 healthy minutes
        # latency regression: every sample lands over threshold.  Fast
        # burn saturates immediately; page waits for the slow window to
        # confirm real budget spend (burn_slow >= 6 needs >= 6% of the
        # slow window bad).
        states = plant.tick(500.0, n=1)
        assert states == {"lat": "warning"}  # fast breach, unconfirmed
        states = plant.tick(500.0, n=5)
        assert states == {"lat": "page"}
        # recovery: downgrade waits clear_after consecutive clean evals
        # per step, and steps DOWN through warning while the slow window
        # still holds the breach (hysteresis: no flapping at threshold)
        states = plant.tick(50.0, n=1)
        assert states == {"lat": "page"}
        plant.tick(50.0, n=70)  # drain both windows well past clean
        assert plant.engine.states() == {"lat": "ok"}
        trans = plant.engine.report()["slos"][0]["transitions"]
        assert [(x["from"], x["to"]) for x in trans] == [
            ("ok", "warning"), ("warning", "page"),
            ("page", "warning"), ("warning", "ok"),
        ]

    def test_partial_breach_warns_without_paging(self, registry):
        # sparse breach: every 10th sample bad.  The 7-point fast window
        # makes one bad sample burn ~14x, so pin page_burn out of reach
        # and assert the multiwindow gate holds the state at warning
        # (slow-window burn ~10 >= warn_burn 6) without ever paging
        plant = _Plant(registry, _latency_slo(page_burn=100.0))
        for _ in range(10):
            plant.tick(50.0, n=9)
            plant.tick(500.0, n=1)
        assert plant.engine.states() == {"lat": "warning"}
        assert not any(
            x["to"] == "page"
            for x in plant.engine.report()["slos"][0]["transitions"]
        )

    def test_escalation_is_immediate_not_hysteretic(self, registry):
        plant = _Plant(registry, _latency_slo(clear_after=1000))
        plant.tick(50.0, n=30)
        plant.tick(500.0, n=6)
        # huge clear_after delays downgrades, never upgrades
        assert plant.engine.states() == {"lat": "page"}

    def test_gauges_and_transition_counter_exported(self, registry):
        plant = _Plant(registry, _latency_slo())
        plant.tick(50.0, n=30)
        plant.tick(500.0, n=6)
        snap = registry.snapshot()
        assert snap["slo.lat.state"] == 2.0  # page
        assert snap["slo.lat.burn_fast"] >= 14.0
        assert snap["slo.lat.burn_slow"] >= 6.0
        assert snap["slo.transitions"] == 2  # ok->warning, warning->page

    def test_transition_callback_seam(self, registry):
        plant = _Plant(registry, _latency_slo())
        seen = []
        plant.engine.on_transition(
            lambda slo, old, new, st: seen.append((slo.name, old, new))
        )
        plant.tick(50.0, n=30)
        plant.tick(500.0, n=6)
        assert ("lat", "ok", "warning") in seen
        assert ("lat", "warning", "page") in seen

    def test_callback_errors_do_not_break_evaluation(self, registry):
        plant = _Plant(registry, _latency_slo())

        def bad_hook(*a):
            raise RuntimeError("hook boom")

        plant.engine.on_transition(bad_hook)
        plant.tick(50.0, n=30)
        assert plant.tick(500.0, n=6) == {"lat": "page"}

    def test_error_rate_kind_zero_traffic_is_zero_burn(self, registry):
        recorder = TimeSeriesRecorder(registry=registry)
        engine = SLOEngine(recorder, registry=registry)
        engine.add(SLO(
            name="err", kind="error_rate", objective=0.999,
            numerator="serving.errors.m", denominator="serving.requests.m",
        ))
        errors = registry.counter("serving.errors.m")
        requests = registry.counter("serving.requests.m")
        t = 0.0
        for _ in range(10):  # idle: counters flat
            t += 10.0
            recorder.sample_once(now=t)
        assert engine.evaluate_once(now=t) == {"err": "ok"}
        # 50% errors on live traffic with budget 0.001 -> page fast
        for _ in range(10):
            t += 10.0
            requests.add(100)
            errors.add(50)
            recorder.sample_once(now=t)
            engine.evaluate_once(now=t)
        assert engine.states() == {"err": "page"}

    def test_rate_min_kind(self, registry):
        recorder = TimeSeriesRecorder(registry=registry)
        engine = SLOEngine(recorder, registry=registry)
        engine.add(SLO(
            name="commits", kind="rate_min", objective=0.99,
            series="streaming.epochs_committed", threshold=1.0,
            fast_window_s=60.0, slow_window_s=600.0,
        ))
        committed = registry.counter("streaming.epochs_committed")
        t = 0.0
        for _ in range(30):  # 2 epochs/s >= floor of 1
            t += 10.0
            committed.add(20)
            recorder.sample_once(now=t)
            engine.evaluate_once(now=t)
        assert engine.states() == {"commits": "ok"}
        for _ in range(40):  # throughput collapses below the floor
            t += 10.0
            recorder.sample_once(now=t)
            engine.evaluate_once(now=t)
        assert engine.states() == {"commits": "page"}

    def test_availability_kind(self, registry):
        recorder = TimeSeriesRecorder(registry=registry)
        engine = SLOEngine(recorder, registry=registry)
        engine.add(availability_slo(objective=0.99))
        up = registry.gauge("sparkdl.up")
        t = 0.0
        for _ in range(30):
            t += 10.0
            up.set(1.0)
            recorder.sample_once(now=t)
            engine.evaluate_once(now=t)
        assert engine.states() == {"availability": "ok"}
        for _ in range(6):
            t += 10.0
            up.set(0.0)
            recorder.sample_once(now=t)
            engine.evaluate_once(now=t)
        assert engine.states() == {"availability": "page"}

    def test_report_shape_and_worst(self, registry):
        plant = _Plant(registry, _latency_slo())
        plant.engine.add(SLO(
            name="other", kind="threshold", series="serving.other",
            threshold=1.0,
        ))
        plant.tick(50.0, n=30)
        plant.tick(500.0, n=6)
        report = plant.engine.report()
        assert report["worst"] == "page"
        assert plant.engine.worst_state() == "page"
        row = {r["name"]: r for r in report["slos"]}["lat"]
        assert row["kind"] == "threshold"
        assert row["windows_s"] == [60.0, 600.0]
        assert row["state"] == "page"

    def test_duplicate_slo_rejected(self, registry):
        recorder = TimeSeriesRecorder(registry=registry)
        engine = SLOEngine(recorder, registry=registry)
        engine.add(_latency_slo())
        with pytest.raises(ValueError, match="already registered"):
            engine.add(_latency_slo())


# ----------------------------------------------------------------------
# rings + dump files (in process)
# ----------------------------------------------------------------------
class TestFlightRecorder:
    def test_rings_are_bounded(self, tmp_path, registry):
        rec = FlightRecorder(
            str(tmp_path), span_capacity=4, event_capacity=3,
            sample_capacity=2, registry=registry,
        )
        for i in range(10):
            rec({"name": f"span{i}"})
            rec.note(f"event{i}", i=i)
            rec.sample_metrics()
        path = rec.dump("manual")
        payload = _read_json(path)
        assert [s["name"] for s in payload["spans"]] == [
            "span6", "span7", "span8", "span9",
        ]
        assert [e["name"] for e in payload["events"]] == [
            "event7", "event8", "event9",
        ]
        assert len(payload["metric_samples"]) == 2

    def test_dump_payload_shape(self, tmp_path, registry):
        registry.counter("serving.requests").add(7)
        rec = FlightRecorder(str(tmp_path), registry=registry)
        rec.note("breadcrumb", detail="x")
        rec.sample_metrics()
        path = rec.dump("watchdog_probe")
        assert os.path.basename(path).startswith(
            f"blackbox-{os.getpid()}-watchdog_probe-"
        )
        payload = _read_json(path)
        assert payload["reason"] == "watchdog_probe"
        assert payload["pid"] == os.getpid()
        assert payload["metrics_now"]["serving.requests"] == 7
        assert payload["metric_samples"][0]["metrics"][
            "serving.requests"] == 7
        # every dump carries all-thread stacks
        assert any("MainThread" in name for name in payload["threads"])
        stacks = list(payload["threads"].values())
        assert any(
            "test_torch_obs" in line for st in stacks for line in st
        )

    def test_dump_reason_is_sanitized(self, tmp_path, registry):
        rec = FlightRecorder(str(tmp_path), registry=registry)
        path = rec.dump("breaker open: a/b")
        assert "breaker_open__a_b" in os.path.basename(path)

    def test_dump_with_exception(self, tmp_path, registry):
        rec = FlightRecorder(str(tmp_path), registry=registry)
        try:
            raise ValueError("device wedged")
        except ValueError as err:
            path = rec.dump("crash", exc=err)
        payload = _read_json(path)
        assert payload["exception"]["type"] == "ValueError"
        assert payload["exception"]["message"] == "device wedged"
        assert any(
            "device wedged" in line
            for line in payload["exception"]["traceback"]
        )

    def test_event_dumps_capped(self, tmp_path, registry):
        rec = FlightRecorder(str(tmp_path), max_dumps=3, registry=registry)
        paths = [rec.dump("crash") for _ in range(6)]
        assert sum(p is not None for p in paths) == 3
        # the periodic persist is NOT capped (it overwrites one file)
        assert rec.dump("periodic") is not None
        assert rec.dump("periodic") is not None

    def test_periodic_overwrites_single_file(self, tmp_path, registry):
        rec = FlightRecorder(str(tmp_path), registry=registry)
        rec.note("first")
        p1 = rec.dump("periodic")
        rec.note("second")
        p2 = rec.dump("periodic")
        assert p1 == p2
        names = [e["name"] for e in _read_json(p1)["events"]]
        assert names == ["first", "second"]
        assert not [f for f in os.listdir(tmp_path) if ".tmp." in f]

    def test_is_a_tracer_sink(self, tmp_path, registry):
        rec = FlightRecorder(str(tmp_path), registry=registry)
        tracer.enable(rec)
        with tracer.span("unit.work", step=3):
            pass
        payload = _read_json(rec.dump("manual"))
        assert payload["spans"][0]["name"] == "unit.work"
        assert payload["spans"][0]["attributes"]["step"] == 3

    def test_background_persist_thread(self, tmp_path, registry):
        rec = FlightRecorder(
            str(tmp_path), interval_s=0.02, registry=registry,
        )
        registry.counter("serving.requests").add(1)
        rec.start()
        try:
            path = os.path.join(tmp_path, f"blackbox-{os.getpid()}.json")
            deadline = time.monotonic() + 10.0
            while not os.path.exists(path):
                if time.monotonic() > deadline:
                    pytest.fail("periodic persist never wrote")
                time.sleep(0.01)
        finally:
            rec.stop()
        payload = _read_json(path)
        assert payload["reason"] == "periodic"
        assert payload["metric_samples"]  # sampled before persisting

    def test_validation(self, tmp_path, registry):
        with pytest.raises(ValueError):
            FlightRecorder(str(tmp_path), interval_s=0, registry=registry)

    def test_module_api_noop_while_disarmed(self):
        from sparkdl_tpu_torch.obs import blackbox

        assert blackbox.recorder() is None
        blackbox.note("ignored")          # must not raise
        assert blackbox.dump("ignored") is None


# ----------------------------------------------------------------------
# resilience layer crossings (cold-path, armed via the module global)
# ----------------------------------------------------------------------
class TestResilienceCrossings:
    @pytest.fixture()
    def armed(self, tmp_path, registry, monkeypatch):
        from sparkdl_tpu_torch.obs import blackbox

        rec = FlightRecorder(str(tmp_path), registry=registry)
        monkeypatch.setattr(blackbox, "_recorder", rec)
        return rec, tmp_path

    def test_breaker_open_dumps(self, armed):
        from sparkdl_tpu_torch.resilience.policy import CircuitBreaker

        rec, out_dir = armed
        breaker = CircuitBreaker(
            name="tunnel", failure_threshold=2, recovery_s=60.0,
        )
        breaker.record_failure()
        breaker.record_failure()  # trips open -> event dump
        dumps = [f for f in os.listdir(out_dir)
                 if "breaker_open_tunnel" in f]
        assert len(dumps) == 1
        payload = _read_json(os.path.join(out_dir, dumps[0]))
        names = [e["name"] for e in payload["events"]]
        assert "breaker_open_tunnel" in names

    def test_preempted_dumps(self, armed):
        from sparkdl_tpu_torch.resilience.preempt import PreemptionToken
        from sparkdl_tpu_torch.resilience.errors import Preempted

        rec, out_dir = armed
        token = PreemptionToken()
        token.request("maintenance event")
        with pytest.raises(Preempted):
            token.check()
        dumps = [f for f in os.listdir(out_dir) if "preempted" in f]
        assert len(dumps) == 1


# ----------------------------------------------------------------------
# subprocess post-mortems (the production contracts)
# ----------------------------------------------------------------------
_CRASH_WORKER = """
import sparkdl_tpu_torch  # SPARKDL_BLACKBOX_DIR arms the recorder at import
from sparkdl_tpu_torch.obs import blackbox

assert blackbox.recorder() is not None
blackbox.note("about_to_fail", step=42)
raise RuntimeError("unhandled worker crash")
"""

_KILL_WORKER = """
import sys
import time

import sparkdl_tpu_torch  # SPARKDL_BLACKBOX_DIR arms the recorder at import
from sparkdl_tpu_torch.obs import blackbox, tracer

rec = blackbox.recorder()
assert rec is not None
tracer.enable()  # enable_from_env added rec as a sink; spans now flow
with tracer.span("worker.step", step=1):
    pass
blackbox.note("worker_ready")
print("READY", flush=True)
while True:  # spin until SIGKILLed; the periodic persist keeps writing
    time.sleep(0.05)
"""


_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _worker_env(out_dir):
    env = dict(os.environ)
    env.update({
        "SPARKDL_BLACKBOX_DIR": str(out_dir),
        "SPARKDL_BLACKBOX_INTERVAL_S": "0.05",
        "PYTHONPATH": _REPO + os.pathsep + env.get("PYTHONPATH", ""),
    })
    return env


class TestSubprocessPostMortems:
    def test_unhandled_crash_leaves_exception_dump(self, tmp_path):
        proc = subprocess.run(
            [sys.executable, "-c", _CRASH_WORKER],
            capture_output=True, text=True, timeout=120,
            env=_worker_env(tmp_path), cwd="/",
        )
        assert proc.returncode != 0
        assert "unhandled worker crash" in proc.stderr  # hook chained
        dumps = [f for f in os.listdir(tmp_path)
                 if "-crash-" in f and f.endswith(".json")]
        assert len(dumps) == 1
        payload = _read_json(os.path.join(tmp_path, dumps[0]))
        assert payload["reason"] == "crash"
        assert payload["exception"]["type"] == "RuntimeError"
        assert payload["exception"]["message"] == "unhandled worker crash"
        assert [e["name"] for e in payload["events"]] == ["about_to_fail"]
        assert payload["events"][0]["step"] == 42

    def test_sigkill_leaves_readable_periodic_dump(self, tmp_path):
        # kill -9 a worker mid-flight; the periodic atomic persist must leave a parseable dump with
        # the final spans and thread stacks
        proc = subprocess.Popen(
            [sys.executable, "-c", _KILL_WORKER],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=_worker_env(tmp_path), cwd="/",
        )
        try:
            assert proc.stdout.readline().strip() == "READY"
            path = os.path.join(tmp_path, f"blackbox-{proc.pid}.json")
            deadline = time.monotonic() + 60.0
            while True:  # wait for a persist that includes the span
                if os.path.exists(path):
                    try:
                        if _read_json(path)["spans"]:
                            break
                    except (json.JSONDecodeError, KeyError):
                        pytest.fail("periodic dump was torn mid-write")
                if time.monotonic() > deadline:
                    pytest.fail("worker never persisted its telemetry")
                time.sleep(0.02)
            os.kill(proc.pid, signal.SIGKILL)
        finally:
            proc.kill()
            proc.wait(timeout=30)
        assert proc.returncode == -signal.SIGKILL
        payload = _read_json(path)  # still parseable after the kill
        assert payload["reason"] == "periodic"
        assert [s["name"] for s in payload["spans"]] == ["worker.step"]
        assert any(e["name"] == "worker_ready"
                   for e in payload["events"])
        assert any("MainThread" in name for name in payload["threads"])
        # the faulthandler fault file was armed alongside
        assert os.path.exists(
            os.path.join(tmp_path, f"fault-{proc.pid}.txt")
        )


# ----------------------------------------------------------------------
# the flight recorder at the watchdog's hard timeout
# ----------------------------------------------------------------------
def test_watchdog_hard_timeout_dumps(tmp_path, registry, monkeypatch):
    from sparkdl_tpu_torch.obs import blackbox
    from sparkdl_tpu_torch.resilience import watchdog
    from sparkdl_tpu_torch.resilience.errors import DeviceUnresponsive

    rec = FlightRecorder(str(tmp_path), registry=registry)
    monkeypatch.setattr(blackbox, "_recorder", rec)
    monkeypatch.setattr(watchdog, "bounded_subprocess_probe", lambda code, t: (True, "card"))
    release = threading.Event()
    with pytest.raises(DeviceUnresponsive):
        watchdog.watchdogged(release.wait, 5.0, soft_timeout_s=0.05, hard_timeout_s=0.1,
                             name="stuck")
    release.set()
    dumps = [f for f in os.listdir(tmp_path) if "watchdog_stuck" in f]
    assert len(dumps) == 1
    names = [e["name"] for e in _read_json(os.path.join(tmp_path, dumps[0]))["events"]]
    assert names == ["watchdog_soft_timeout", "watchdog_stuck"]


# ----------------------------------------------------------------------
# parity with the JAX package
# ----------------------------------------------------------------------
def _fill(reg):
    """The same registry contents, whichever package's registry."""
    reg.counter("serving.requests").add(3)
    reg.counter("streaming.records_in").add(256)
    reg.gauge("data.queue_depth").set(2)
    reg.gauge("streaming.watermark_lag_ms").set(1234.5)
    reg.timer("estimator.step").add_seconds(0.25)
    reg.timer("estimator.step").add_seconds(0.125)
    h = reg.histogram("serving.latency_ms")
    for i, v in enumerate((1.0, 2.5, 3.0, 40.0, 7.25)):
        h.observe(v, exemplar=1000 + i if i % 2 else None)
    reg.histogram("streaming.record_latency_ms").observe(12.0)
    reg.histogram("data.device_stall_ms")  # no observations yet
    reg.counter('weird.na"me\\x').add(1)


@pytest.mark.parametrize("prefix", [None, "serving.", "streaming.", "nothing."])
def test_prometheus_text_is_the_jax_packages_text(prefix):
    from sparkdl_tpu.obs.export import prometheus_text as jax_prometheus_text
    from sparkdl_tpu.utils.metrics import MetricsRegistry as JaxRegistry

    jax_reg, reg = JaxRegistry(), MetricsRegistry()
    _fill(jax_reg)
    _fill(reg)
    text = prometheus_text(reg, prefix=prefix)
    assert text == jax_prometheus_text(jax_reg, prefix=prefix)
    if prefix is None:
        assert "# EXEMPLAR serving_latency_ms trace_id=1003 value=40" in text


def _drive(slo_module, ts_module, registry_cls, values):
    """One sample and one evaluation per 10 s tick of a p99 gauge and an
    error-rate pair, through one package's recorder and engine; each
    tick's (states, burn rates)."""
    reg = registry_cls()
    rec = ts_module.TimeSeriesRecorder(registry=reg)
    t = [0.0]
    engine = slo_module.SLOEngine(rec, registry=reg, clock=lambda: t[0])
    engine.add(slo_module.SLO(name="lat", kind="threshold", series="serving.p99",
                              threshold=100.0, objective=0.99))
    engine.add(*slo_module.serving_slos("ep", latency_threshold_ms=100.0))
    engine.add(*slo_module.streaming_slos(max_watermark_lag_ms=500.0, min_commit_rate=0.5))
    out = []
    for i, v in enumerate(values):
        t[0] += 10.0
        reg.gauge("serving.p99").set(v)
        reg.gauge("streaming.watermark_lag_ms").set(v * 5.0)
        reg.counter("serving.requests.ep").add(10)
        reg.counter("serving.errors.ep").add(1 if v > 100.0 else 0)
        reg.counter("streaming.epochs_committed").add(10 if v < 100.0 else 1)
        reg.histogram("serving.latency_ms.ep").observe(v)
        rec.sample_once(now=t[0])
        states = engine.evaluate_once(now=t[0])
        report = {s["name"]: (s["state"], s["burn_fast"], s["burn_slow"])
                  for s in engine.report()["slos"]}
        out.append((states, report, engine.worst_state()))
    return out


def test_slo_engine_states_and_burn_rates_equal_the_jax_engines():
    from sparkdl_tpu.obs import slo as jax_slo
    from sparkdl_tpu.obs import timeseries as jax_ts
    from sparkdl_tpu.utils.metrics import MetricsRegistry as JaxRegistry
    from sparkdl_tpu_torch.obs import slo, timeseries

    values = [50.0] * 30 + [500.0] * 12 + [50.0] * 40 + [150.0, 50.0] * 10
    got = _drive(slo, timeseries, MetricsRegistry, values)
    want = _drive(jax_slo, jax_ts, JaxRegistry, values)
    assert got == want
    assert {w for _, _, w in got} == {"ok", "warning", "page"}


def _span_tree(spans):
    """Spans as sorted (name, parent name, attribute keys) triples, with
    the batch span's member ids resolved to names."""
    by_id = {s["span_id"]: s for s in spans}
    out = []
    for s in spans:
        parent = by_id.get(s["parent_id"], {}).get("name") if s["parent_id"] else None
        members = sorted(by_id[m]["name"] for m in s["attributes"].get("member_span_ids", ()))
        events = sorted({e["name"] for e in s["events"]})
        out.append((s["name"], parent, tuple(sorted(s["attributes"])), tuple(members),
                    tuple(events)))
    return sorted(out)


def test_a_served_request_has_the_jax_span_tree():
    from sparkdl_tpu.obs import tracer as jax_tracer
    from sparkdl_tpu.serving import ModelServer as JaxModelServer
    from sparkdl_tpu.serving import ServingConfig as JaxServingConfig
    from sparkdl_tpu_torch.serving import ModelServer, ServingConfig

    x = np.arange(4, dtype=np.float32)
    trees = []
    for trc, server in (
            (jax_tracer, JaxModelServer(JaxServingConfig(max_batch=4, max_wait_ms=1.0))),
            (tracer, ModelServer(ServingConfig(max_batch=4, max_wait_ms=1.0), device="cpu"))):
        spans = []
        trc.enable(sink=spans.append)
        try:
            server.register("double", lambda b: b * 2.0, item_shape=(4,), compile=False)
            with trc.span("client"):
                out = server.predict(x, timeout=30.0)
            server.close()
        finally:
            trc.disable()
        np.testing.assert_array_equal(np.asarray(out), x * 2.0)
        trees.append(_span_tree(spans))
    jax_tree, tree = trees
    assert tree == jax_tree
    names = {(name, parent) for name, parent, *_ in tree}
    assert names == {("client", None), ("serving.request", "client"),
                     ("serving.batch", None)}
