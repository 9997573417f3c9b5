"""The port's trace analytics (``obs/diag.py``), on the cases of the JAX
package's ``tests/test_diag.py``: JSONL ingest (torn-tail
tolerant), tree reassembly, critical-path extraction, attribution /
per-replica / rescue aggregation, exemplar resolution, and the CLI.

Everything here is synthetic span dicts — no processes, no sockets;
``test_torch_replica_parity.py`` holds the report on live spans to the JAX
package's.
"""

import json

import pytest

from sparkdl_tpu_torch.obs import diag
from sparkdl_tpu_torch.obs.diag import (
    TraceTree,
    build_trees,
    diagnose,
    load_spans,
    read_jsonl,
)
from sparkdl_tpu_torch.obs.export import JsonlTraceSink
from sparkdl_tpu_torch.utils.metrics import MetricsRegistry, metrics


@pytest.fixture(autouse=True)
def clean_registry():
    metrics.reset()
    yield
    metrics.reset()


def _span(name, tid, sid, parent=None, start=0.0, dur=1.0, **attrs):
    return {
        "name": name, "trace_id": tid, "span_id": sid,
        "parent_id": parent, "start_unix_s": start,
        "duration_ms": dur, "attributes": attrs, "events": [],
    }


def _request(tid, e2e, phases, replica="replica-0", retries=0,
             hedged=False, hedge_won=False, error=None, serves=1):
    """One synthetic stitched request: router.request root carrying the
    phase breakdown, an attempt child, and ``serves`` replica halves."""
    attrs = dict(
        e2e_ms=e2e, phases=phases, replica=replica, retries=retries,
        hedged=hedged, hedge_won=hedge_won,
    )
    if error:
        attrs["error"] = error
    spans = [_span(diag.ROOT_SPAN, tid, 1, dur=e2e, **attrs)]
    for i in range(serves):
        spans.append(_span(
            "router.attempt", tid, 10 + i, parent=1, dur=e2e * 0.8,
        ))
        spans.append(_span(
            diag.REMOTE_SPAN, tid, 20 + i, parent=10 + i,
            dur=e2e * 0.6,
        ))
    return spans


# ----------------------------------------------------------------------
# ingest
# ----------------------------------------------------------------------
class TestIngest:
    def test_read_jsonl_roundtrip(self, tmp_path):
        path = tmp_path / "trace.jsonl"
        spans = _request(7, 10.0, {"transport": 4.0})
        path.write_text(
            "".join(json.dumps(s) + "\n" for s in spans)
        )
        got, skipped = read_jsonl(str(path))
        assert skipped == 0
        assert [s["span_id"] for s in got] == [1, 10, 20]

    def test_read_jsonl_skips_torn_tail(self, tmp_path):
        """A crash mid-flush leaves a truncated final line; ingest must
        skip and count it, never raise (the regression this guards: a
        diagnosis tool dying on the evidence of the crash)."""
        path = tmp_path / "trace.jsonl"
        spans = _request(7, 10.0, {"transport": 4.0})
        text = "".join(json.dumps(s) + "\n" for s in spans)
        # tear the last line mid-JSON, no trailing newline
        path.write_text(text[:-20])
        got, skipped = read_jsonl(str(path))
        assert skipped == 1
        assert len(got) == len(spans) - 1
        # and the report layer digests the survivors without raising
        report = diagnose(got, skipped_lines=skipped,
                          record_metrics=False)
        assert report["skipped_lines"] == 1

    def test_sink_flush_then_torn_tail(self, tmp_path):
        """End-to-end with the real writer: JsonlTraceSink.flush output
        truncated a few bytes short still ingests all-but-last span."""
        path = tmp_path / "sink.jsonl"
        sink = JsonlTraceSink(path=str(path))
        for s in _request(11, 8.0, {"forward": 5.0}):
            sink(s)
        written = sink.flush()
        assert written == 3
        raw = path.read_bytes()
        path.write_bytes(raw[:-10])  # the torn tail
        got, skipped = read_jsonl(str(path))
        assert skipped == 1
        assert len(got) == written - 1

    def test_read_jsonl_skips_non_span_objects(self, tmp_path):
        path = tmp_path / "trace.jsonl"
        path.write_text(
            json.dumps([1, 2]) + "\n"          # not a dict
            + json.dumps({"name": "x"}) + "\n"  # no trace_id
            + json.dumps(_span("a", 5, 1)) + "\n"
        )
        got, skipped = read_jsonl(str(path))
        assert skipped == 2
        assert len(got) == 1

    def test_load_spans_merges_files(self, tmp_path):
        a, b = tmp_path / "a.jsonl", tmp_path / "b.jsonl"
        a.write_text(json.dumps(_span("a", 1, 1)) + "\n")
        b.write_text(json.dumps(_span("b", 2, 1)) + "\nnot json\n")
        spans, skipped = load_spans([str(a), str(b)])
        assert {s["trace_id"] for s in spans} == {1, 2}
        assert skipped == 1


# ----------------------------------------------------------------------
# tree reassembly + critical path
# ----------------------------------------------------------------------
class TestTraceTree:
    def test_root_prefers_router_request(self):
        tree = TraceTree(1)
        tree.add(_span("replica.flush", 1, 2))
        tree.add(_span(diag.ROOT_SPAN, 1, 1))
        assert tree.root["span_id"] == 1

    def test_orphans_counted(self):
        tree = TraceTree(1)
        tree.add(_span(diag.ROOT_SPAN, 1, 1))
        tree.add(_span("child", 1, 2, parent=99))  # parent never seen
        assert tree.orphans == 1
        assert not tree.stitched

    def test_stitched_needs_remote_half(self):
        tree = TraceTree(1)
        for s in _request(1, 5.0, {}):
            tree.add(s)
        assert tree.stitched
        lonely = TraceTree(2)
        lonely.add(_span(diag.ROOT_SPAN, 2, 1))
        assert not lonely.stitched

    def test_critical_path_follows_longest_child(self):
        tree = TraceTree(1)
        tree.add(_span(diag.ROOT_SPAN, 1, 1, dur=10.0))
        tree.add(_span("fast", 1, 2, parent=1, dur=2.0))
        tree.add(_span("slow", 1, 3, parent=1, dur=7.0))
        tree.add(_span("leaf", 1, 4, parent=3, dur=6.0))
        path = tree.critical_path()
        assert [p["name"] for p in path] == \
            [diag.ROOT_SPAN, "slow", "leaf"]
        # self time: the segment's duration its children don't explain
        assert path[0]["self_ms"] == pytest.approx(10.0 - 9.0)
        assert path[1]["self_ms"] == pytest.approx(1.0)
        assert path[2]["self_ms"] == pytest.approx(6.0)

    def test_critical_path_cycle_guard(self):
        """A duplicated span id must terminate the walk, not hang it."""
        tree = TraceTree(1)
        tree.add(_span(diag.ROOT_SPAN, 1, 1, dur=10.0))
        tree.add(_span("kid", 1, 2, parent=1, dur=5.0))
        # a second span reusing id 2 parents itself under 2 — the walk
        # would revisit sid 2 forever without the seen-guard
        tree.children.setdefault(2, []).append(
            _span("kid-again", 1, 2, parent=2, dur=4.0)
        )
        path = tree.critical_path()
        assert len(path) == 2

    def test_render_includes_tags(self):
        tree = TraceTree(1)
        tree.add(_span(diag.ROOT_SPAN, 1, 1, dur=3.0,
                       replica="replica-1", retries=2))
        lines = tree.render()
        assert len(lines) == 1
        assert "replica=replica-1" in lines[0]
        assert "retries=2" in lines[0]


# ----------------------------------------------------------------------
# aggregation
# ----------------------------------------------------------------------
class TestAggregation:
    def test_attribution_coverage_and_dominance(self):
        spans = []
        for tid in range(1, 11):
            spans += _request(
                tid, 10.0,
                {"transport": 6.0, "forward": 3.0, "admission": 1.0},
            )
        report = diagnose(spans, record_metrics=False)
        attribution = report["attribution"]
        assert attribution["requests"] == 10
        assert attribution["e2e_p50_ms"] == pytest.approx(10.0)
        # phases sum exactly to e2e — coverage is 100%
        assert attribution["coverage_p50"] == pytest.approx(1.0)
        assert attribution["dominant_p50"][0] == "transport"
        # report rows keep lifecycle order, not alphabetical
        assert list(attribution["phases"]) == \
            ["admission", "transport", "forward"]

    def test_timestamp_stamps_excluded_from_phases(self):
        spans = _request(
            1, 10.0, {"transport": 4.0, "t_accepted": 1.7e9},
        )
        report = diagnose(spans, record_metrics=False)
        assert list(report["attribution"]["phases"]) == ["transport"]

    def test_errored_requests_excluded_from_attribution(self):
        spans = _request(1, 10.0, {"transport": 5.0})
        spans += _request(2, 500.0, {"transport": 499.0},
                          error="TimeoutError")
        report = diagnose(spans, record_metrics=False)
        assert report["requests"] == 2
        assert report["errored_requests"] == 1
        assert report["attribution"]["requests"] == 1
        assert report["attribution"]["e2e_p50_ms"] == \
            pytest.approx(10.0)

    def test_per_replica_queue_vs_service(self):
        spans = []
        for tid in range(1, 5):
            spans += _request(
                tid, 10.0,
                {"replica_queue": 7.0, "forward": 3.0},
                replica="replica-0",
            )
        for tid in range(5, 9):
            spans += _request(
                tid, 10.0,
                {"replica_queue": 1.0, "forward": 9.0},
                replica="replica-1",
            )
        per = diagnose(spans, record_metrics=False)["per_replica"]
        # replica-0 is *behind* (queue-dominated), replica-1 is *slow*
        assert per["replica-0"]["queue_p50_ms"] == pytest.approx(7.0)
        assert per["replica-0"]["service_p50_ms"] == pytest.approx(3.0)
        assert per["replica-1"]["queue_p50_ms"] == pytest.approx(1.0)
        assert per["replica-1"]["service_p50_ms"] == pytest.approx(9.0)

    def test_rescue_accounting_duplicate_serves(self):
        spans = _request(1, 10.0, {}, hedged=True, hedge_won=True,
                         serves=2)
        spans += _request(2, 8.0, {}, retries=2)
        rescue = diagnose(spans, record_metrics=False)["rescue"]
        assert rescue["hedged_requests"] == 1
        assert rescue["hedge_wins"] == 1
        assert rescue["retried_requests"] == 1
        assert rescue["total_retries"] == 2
        assert rescue["duplicated_serves"] == 1
        # both serves ran 6.0ms: the duplicate cost is sum - max
        assert rescue["duplicate_serve_ms"] == pytest.approx(6.0)


# ----------------------------------------------------------------------
# exemplar resolution
# ----------------------------------------------------------------------
class TestExemplars:
    def test_exemplar_resolves_to_stitched_trace(self):
        registry = MetricsRegistry()
        registry.histogram("router.e2e_ms").observe(9.5, exemplar=42)
        registry.histogram("router.other_ms").observe(1.0,
                                                      exemplar=777)
        spans = _request(42, 9.5, {"transport": 9.0})
        report = diagnose(spans, registry=registry,
                          record_metrics=False)
        rows = {r["metric"]: r for r in report["exemplars"]}
        assert rows["router.e2e_ms"]["trace_id"] == 42
        assert rows["router.e2e_ms"]["resolved"] is True
        assert rows["router.e2e_ms"]["stitched"] is True
        # an exemplar pointing at a trace the file never saw
        assert rows["router.other_ms"]["resolved"] is False
        assert rows["router.other_ms"]["stitched"] is False

    def test_no_registry_no_exemplar_section(self):
        report = diagnose(_request(1, 5.0, {}), record_metrics=False)
        assert "exemplars" not in report


# ----------------------------------------------------------------------
# the full report + metrics side channel
# ----------------------------------------------------------------------
class TestDiagnose:
    def test_slowest_drilldown_ordering(self):
        spans = []
        for tid, e2e in ((1, 5.0), (2, 50.0), (3, 20.0)):
            spans += _request(tid, e2e, {"transport": e2e - 1.0})
        report = diagnose(spans, top=2, record_metrics=False)
        slow = report["slowest"]
        assert [s["trace_id"] for s in slow] == [2, 3]
        assert slow[0]["critical_path"][0]["name"] == diag.ROOT_SPAN
        assert slow[0]["tree"]  # the rendered drill-down rides along

    def test_record_metrics_publishes_gauges(self):
        spans = _request(1, 10.0, {"transport": 10.0})
        diagnose(spans, skipped_lines=3, record_metrics=True)
        snap = metrics.snapshot(prefix="diag")
        assert snap["diag.reports"] == 1
        assert snap["diag.requests"] == 1.0
        assert snap["diag.skipped_lines"] == 3
        assert snap["diag.coverage_p50"] == pytest.approx(1.0)
        assert snap["diag.e2e_p50_ms"] == pytest.approx(10.0)

    def test_record_metrics_off_is_silent(self):
        diagnose(_request(1, 10.0, {}), record_metrics=False)
        assert metrics.snapshot(prefix="diag") == {}


# ----------------------------------------------------------------------
# CLI
# ----------------------------------------------------------------------
class TestCli:
    @pytest.fixture()
    def trace_file(self, tmp_path):
        path = tmp_path / "trace.jsonl"
        spans = _request(42, 12.0, {"transport": 7.0, "forward": 5.0})
        path.write_text(
            "".join(json.dumps(s) + "\n" for s in spans)
        )
        return str(path)

    def test_text_report(self, trace_file, capsys):
        assert diag.main([trace_file]) == 0
        out = capsys.readouterr().out
        assert "requests=1" in out
        assert "transport" in out

    def test_json_report(self, trace_file, capsys):
        assert diag.main([trace_file, "--json"]) == 0
        report = json.loads(capsys.readouterr().out)
        assert report["requests"] == 1
        assert report["attribution"]["coverage_p50"] == \
            pytest.approx(1.0)

    def test_trace_drilldown(self, trace_file, capsys):
        assert diag.main([trace_file, "--trace", "42"]) == 0
        assert diag.ROOT_SPAN in capsys.readouterr().out

    def test_trace_drilldown_missing(self, trace_file, capsys):
        assert diag.main([trace_file, "--trace", "999"]) == 1

    def test_cli_does_not_touch_process_registry(self, trace_file):
        diag.main([trace_file])
        assert metrics.snapshot(prefix="diag") == {}
