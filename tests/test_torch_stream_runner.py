"""The port's streaming runner (``sparkdl_tpu_torch/streaming``) against
the JAX package's, on the CPU.

The cases of ``tests/test_streaming.py`` run against the port: sources,
watermarks, the commit log and sinks, ``Dataset.from_stream``, the runner's
stop conditions, backpressure, late records, spans and recovery, and the
kill matrix: a ``FaultPlan`` kills a worker subprocess (``os._exit(9)``) at
``streaming.poll``, ``streaming.sink`` and ``streaming.commit``, a restart
resumes from the last committed offset, and the sink holds each source
record exactly once; a kill between payload and marker replays exactly that
epoch, and SIGTERM flushes and resumes. The workers score with a trivial
function (no model, no compile).

The parity case scores the same ``QueueSource`` records with a tiny flash
ViT through the JAX ``StreamRunner`` (the Pallas kernel in interpret mode,
as the JAX package's own tests run it) and through the port's runner (the
kernel's plain version on the CPU) with the same weights, carried across by
the port's converter: the sinks hold the same offsets once each, and the
outputs agree within ``atol=1e-5, rtol=1e-4``.
"""

import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from sparkdl_tpu_torch.data import Dataset
from sparkdl_tpu_torch.resilience.errors import PermanentError
from sparkdl_tpu_torch.streaming import (
    CallbackSink,
    CommitLog,
    FileTailSource,
    JsonlSink,
    QueueSource,
    StreamConfig,
    StreamRunner,
    WatermarkTracker,
)
from sparkdl_tpu_torch.utils.metrics import metrics

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _no_compile_cache(monkeypatch):
    monkeypatch.setenv("SPARKDL_COMPILE_CACHE", "off")


def fast_config(**overrides):
    kw = dict(max_batch=4, max_wait_ms=5.0, poll_batch=4,
              poll_interval_ms=2.0)
    kw.update(overrides)
    return StreamConfig(**kw)


# ---------------------------------------------------------------------------
# sources
# ---------------------------------------------------------------------------


class TestQueueSource:
    def test_poll_seek_replay(self):
        src = QueueSource()
        src.put_all(["a", "b", "c", "d"])
        first = src.poll(3)
        assert [r.value for r in first] == ["a", "b", "c"]
        assert [r.offset for r in first] == [1, 2, 3]
        assert src.position() == 3
        src.seek(1)  # replay everything after record 1
        assert [r.value for r in src.poll(10)] == ["b", "c", "d"]

    def test_finished_only_after_end_and_drain(self):
        src = QueueSource()
        src.put("x")
        assert not src.finished()
        src.end()
        assert not src.finished()  # still one record to drain
        src.poll(5)
        assert src.finished()
        with pytest.raises(ValueError):
            src.put("y")

    def test_backlog(self):
        src = QueueSource()
        src.put_all(range(5))
        assert src.backlog() == 5
        src.poll(2)
        assert src.backlog() == 3


class TestFileTailSource:
    def test_tail_growing_file(self, tmp_path):
        path = tmp_path / "in.jsonl"
        src = FileTailSource(str(path))
        assert src.poll(10) == []  # not created yet: empty, not an error
        with open(path, "a") as fh:
            fh.write('{"x": 1}\n{"x": 2}\n')
        vals = src.poll(10)
        assert [r.value for r in vals] == [{"x": 1}, {"x": 2}]
        with open(path, "a") as fh:
            fh.write('{"x": 3}\n')
        assert [r.value for r in src.poll(10)] == [{"x": 3}]

    def test_partial_line_left_for_next_poll(self, tmp_path):
        path = tmp_path / "in.jsonl"
        path.write_text('{"x": 1}\n{"x": 2')  # torn write, no newline
        src = FileTailSource(str(path))
        assert [r.value for r in src.poll(10)] == [{"x": 1}]
        with open(path, "a") as fh:
            fh.write("}\n")
        assert [r.value for r in src.poll(10)] == [{"x": 2}]

    def test_byte_offsets_replay_identically(self, tmp_path):
        path = tmp_path / "in.jsonl"
        path.write_text('{"x": 1}\n{"x": 2}\n{"x": 3}\n')
        src = FileTailSource(str(path))
        recs = src.poll(2)
        # a fresh source sought to a record's offset resumes right after it
        other = FileTailSource(str(path))
        other.seek(recs[-1].offset)
        assert [r.value for r in other.poll(10)] == [{"x": 3}]

    def test_event_time_field_and_blank_lines(self, tmp_path):
        path = tmp_path / "in.jsonl"
        path.write_text('{"x": 1, "ts": 100}\n\n{"x": 2, "ts": 50}\n')
        src = FileTailSource(str(path), event_time_field="ts")
        recs = src.poll(10)
        assert [r.event_time_ms for r in recs] == [100.0, 50.0]

    def test_corrupt_line_is_permanent(self, tmp_path):
        path = tmp_path / "in.jsonl"
        path.write_text("not json\n")
        src = FileTailSource(str(path))
        with pytest.raises(PermanentError):
            src.poll(10)

    def test_raw_mode(self, tmp_path):
        path = tmp_path / "in.log"
        path.write_text("alpha\nbeta\n")
        src = FileTailSource(str(path), parse="raw")
        assert [r.value for r in src.poll(10)] == ["alpha", "beta"]


class TestWatermark:
    def test_bounded_lateness(self):
        wm = WatermarkTracker(allowed_lateness_ms=10.0)
        assert wm.observe(100.0) is False
        assert wm.watermark_ms == 90.0
        assert wm.observe(95.0) is False   # within lateness allowance
        assert wm.observe(80.0) is True    # behind the watermark: late
        assert wm.watermark_ms == 90.0     # max never decreases
        assert wm.observe(200.0) is False
        assert wm.watermark_ms == 190.0

    def test_no_event_times_no_watermark(self):
        wm = WatermarkTracker()
        assert wm.observe(None) is False
        assert wm.watermark_ms is None
        assert wm.lag_ms(1000.0) is None

    def test_lag(self):
        wm = WatermarkTracker()
        wm.observe(1000.0)
        assert wm.lag_ms(1500.0) == 500.0


# ---------------------------------------------------------------------------
# commit log + sinks
# ---------------------------------------------------------------------------


class TestCommitLog:
    def test_payload_then_marker(self, tmp_path):
        log = CommitLog(str(tmp_path / "log"))
        assert log.last_committed() is None
        assert log.resume_offset() is None
        log.write_payload(1, {"end_offset": 4, "records": [{"a": 1}]})
        assert log.pending() == [1]
        log.commit(1)
        assert log.pending() == []
        assert log.last_committed() == 1
        assert log.resume_offset() == 4
        assert log.payload(1)["records"] == [{"a": 1}]

    def test_marker_requires_payload(self, tmp_path):
        log = CommitLog(str(tmp_path / "log"))
        with pytest.raises(ValueError):
            log.commit(1)

    def test_resume_offset_prefers_highest_payload(self, tmp_path):
        # a pending (uncommitted) payload still checkpoints its offset:
        # its records replay from the payload, never from the source
        log = CommitLog(str(tmp_path / "log"))
        log.write_payload(1, {"end_offset": 4, "records": []})
        log.commit(1)
        log.write_payload(2, {"end_offset": 9, "records": []})
        assert log.pending() == [2]
        assert log.resume_offset() == 9


class TestJsonlSink:
    def test_replay_is_idempotent(self, tmp_path):
        sink = JsonlSink(str(tmp_path / "out.jsonl"))
        sink.write(1, [{"v": 1}, {"v": 2}])
        sink.write(2, [{"v": 3}])
        sink.write(2, [{"v": 3}])  # replay: exactly one copy survives
        rows = sink.read_all()
        assert [r["v"] for r in rows] == [1, 2, 3]
        assert [r["epoch"] for r in rows] == [1, 1, 2]

    def test_replay_after_reopen(self, tmp_path):
        path = str(tmp_path / "out.jsonl")
        JsonlSink(path).write(1, [{"v": 1}])
        sink = JsonlSink(path)  # fresh process: index rebuilt from disk
        sink.write(1, [{"v": 1}])
        assert [r["v"] for r in sink.read_all()] == [1]

    def test_torn_tail_truncated_on_open(self, tmp_path):
        path = tmp_path / "out.jsonl"
        path.write_bytes(b'{"epoch": 1, "v": 1}\n{"epoch": 2, "v":')
        sink = JsonlSink(str(path))
        assert [r["v"] for r in sink.read_all()] == [1]
        sink.write(2, [{"v": 2}])
        assert [r["v"] for r in sink.read_all()] == [1, 2]


class TestCallbackSink:
    def test_in_process_dedupe(self):
        got = []
        sink = CallbackSink(lambda epoch, recs: got.append((epoch, recs)))
        sink.write(1, [{"v": 1}])
        sink.write(1, [{"v": 1}])
        assert got == [(1, [{"v": 1}])]

    def test_failed_delivery_can_retry(self):
        calls = []

        def fn(epoch, recs):
            calls.append(epoch)
            if len(calls) == 1:
                raise RuntimeError("flaky consumer")

        sink = CallbackSink(fn)
        with pytest.raises(RuntimeError):
            sink.write(1, [])
        sink.write(1, [])  # the failure un-marked the epoch
        assert calls == [1, 1]


# ---------------------------------------------------------------------------
# Dataset.from_stream + unbounded batch semantics
# ---------------------------------------------------------------------------


class TestFromStream:
    def test_yields_values_until_finished(self):
        src = QueueSource()
        src.put_all(range(7))
        src.end()
        ds = Dataset.from_stream(src, poll_batch=3)
        assert ds.unbounded
        assert list(ds) == list(range(7))

    def test_max_records_window_is_bounded(self):
        src = QueueSource()
        src.put_all(range(100))
        ds = Dataset.from_stream(src, max_records=5)
        assert not ds.unbounded
        assert list(ds) == [0, 1, 2, 3, 4]

    def test_shuffle_rejected_on_unbounded(self):
        ds = Dataset.from_stream(QueueSource())
        with pytest.raises(ValueError, match="unbounded"):
            ds.shuffle(seed=0)

    def test_cyclic_pad_rejected_on_unbounded(self):
        ds = Dataset.from_stream(QueueSource())
        with pytest.raises(ValueError, match="unbounded"):
            ds.batch(4, pad="cyclic")

    def test_ragged_final_batch(self):
        src = QueueSource()
        src.put_all(range(10))
        src.end()
        batches = list(Dataset.from_stream(src).batch(4))
        assert [b.n_real for b in batches] == [4, 4, 2]

    def test_drop_remainder(self):
        src = QueueSource()
        src.put_all(range(10))
        src.end()
        batches = list(Dataset.from_stream(src).batch(4, drop_remainder=True))
        assert [b.n_real for b in batches] == [4, 4]

    def test_drop_remainder_on_bounded_dataset(self):
        ds = Dataset.from_items(list(range(9)))
        batches = list(ds.batch(4, drop_remainder=True))
        assert [list(b.items) for b in batches] == [[0, 1, 2, 3], [4, 5, 6, 7]]
        assert len(ds.batch(4, drop_remainder=True)) == 2

    def test_drop_remainder_excludes_pad(self):
        with pytest.raises(ValueError, match="mutually exclusive"):
            Dataset.from_items([1, 2]).batch(2, pad="cyclic",
                                             drop_remainder=True)

    def test_unbounded_flag_propagates(self):
        ds = Dataset.from_stream(QueueSource()).map(lambda x: x).batch(4)
        assert ds.unbounded
        with pytest.raises(TypeError):
            len(ds)


# ---------------------------------------------------------------------------
# StreamRunner in-process
# ---------------------------------------------------------------------------


def _offsets(sink_rows):
    return sorted(r["offset"] for r in sink_rows)


class TestStreamRunner:
    def test_end_to_end_exactly_once(self, tmp_path):
        src = QueueSource()
        src.put_all([[float(i)] for i in range(25)])
        src.end()
        sink = JsonlSink(str(tmp_path / "out.jsonl"))
        runner = StreamRunner(
            src, lambda x: np.asarray(x) * 2.0, sink,
            str(tmp_path / "log"), config=fast_config(),
        )
        summary = runner.run()
        assert summary["stop_reason"] == "source_finished"
        rows = sink.read_all()
        assert _offsets(rows) == list(range(1, 26))
        assert rows[0]["output"] == [0.0]
        assert rows[3]["output"] == [6.0]
        assert summary["committed_offset"] == 25
        log = CommitLog(str(tmp_path / "log"))
        assert log.pending() == []

    def test_max_epochs_stop(self, tmp_path):
        src = QueueSource()
        src.put_all([[1.0]] * 40)
        sink = JsonlSink(str(tmp_path / "out.jsonl"))
        runner = StreamRunner(
            src, lambda x: np.asarray(x), sink, str(tmp_path / "log"),
            config=fast_config(),
        )
        summary = runner.run(max_epochs=2)
        assert summary["stop_reason"] == "max_epochs"
        assert summary["epochs"] >= 2

    def test_idle_timeout_stop(self, tmp_path):
        src = QueueSource()  # never ends, never produces
        sink = CallbackSink(lambda e, r: None)
        runner = StreamRunner(
            src, lambda x: x, sink, str(tmp_path / "log"),
            config=fast_config(),
        )
        summary = runner.run(idle_timeout_s=0.1)
        assert summary["stop_reason"] == "idle_timeout"
        assert summary["epochs"] == 0

    def test_backpressure_blocks_instead_of_shedding(self, tmp_path):
        # a tiny queue + slow scorer: the poller must stall, not drop
        shed_before = metrics.counter("streaming.shed").value
        src = QueueSource()
        src.put_all([[float(i)] for i in range(60)])
        src.end()
        sink = JsonlSink(str(tmp_path / "out.jsonl"))

        def slow(x):
            time.sleep(0.002)
            return np.asarray(x)

        runner = StreamRunner(
            src, slow, sink, str(tmp_path / "log"),
            config=fast_config(queue_capacity=4, poll_batch=16,
                               offer_timeout_s=0.05),
        )
        runner.run()
        assert _offsets(sink.read_all()) == list(range(1, 61))
        assert metrics.counter("streaming.shed").value == shed_before

    def test_watermark_and_lag_metrics_in_prometheus_text(self, tmp_path):
        from sparkdl_tpu_torch.obs.export import prometheus_text

        src = QueueSource()
        now_ms = time.time() * 1000.0
        for i in range(8):
            src.put([float(i)], event_time_ms=now_ms - 5000.0 + i)
        src.put([99.0], event_time_ms=now_ms - 50000.0)  # very late
        src.end()
        sink = CallbackSink(lambda e, r: None)
        runner = StreamRunner(
            src, lambda x: np.asarray(x), sink, str(tmp_path / "log"),
            config=fast_config(allowed_lateness_ms=1000.0),
        )
        summary = runner.run()
        assert summary["watermark_ms"] == pytest.approx(
            now_ms - 5000.0 + 7 - 1000.0
        )
        assert metrics.counter("streaming.late_records").value >= 1
        lag = metrics.gauge("streaming.watermark_lag_ms").value
        assert lag >= 5000.0
        text = prometheus_text(metrics)
        assert "streaming_watermark_lag_ms" in text
        assert "streaming_epochs_committed" in text
        assert "streaming_records_in" in text

    def test_spans_nest_across_runner_threads(self, tmp_path):
        from sparkdl_tpu_torch.obs import tracer

        spans = []
        tracer.enable(sink=spans.append)
        try:
            src = QueueSource()
            src.put_all([[float(i)] for i in range(12)])
            src.end()
            sink = CallbackSink(lambda e, r: None)
            StreamRunner(
                src, lambda x: np.asarray(x), sink, str(tmp_path / "log"),
                config=fast_config(),
            ).run()
        finally:
            tracer.disable()
        by_name = {}
        for s in spans:
            by_name.setdefault(s["name"], []).append(s)
        run = by_name["streaming.run"]
        assert len(run) == 1
        run_id, trace_id = run[0]["span_id"], run[0]["trace_id"]
        # poll spans are created on the poller THREAD but must still nest
        # under the run span (explicit capture()/use_span propagation)
        assert by_name["streaming.poll"], "no poll spans recorded"
        for s in by_name["streaming.poll"]:
            assert s["parent_id"] == run_id
            assert s["trace_id"] == trace_id
        for s in by_name["streaming.epoch"]:
            assert s["parent_id"] == run_id
            assert s["trace_id"] == trace_id
        assert by_name["streaming.recover"][0]["parent_id"] == run_id
        # the port also spans each epoch's commit (payload, sink, marker)
        assert len(by_name["streaming.commit"]) == len(by_name["streaming.epoch"]) == 3
        for s in by_name["streaming.commit"]:
            assert s["parent_id"] == run_id

    def test_preemption_flushes_and_resumes(self, tmp_path):
        from sparkdl_tpu_torch.resilience import preempt

        src = QueueSource()
        src.put_all([[float(i)] for i in range(40)])
        sink = JsonlSink(str(tmp_path / "out.jsonl"))

        def slow(x):
            time.sleep(0.002)
            return np.asarray(x)

        runner = StreamRunner(
            src, slow, sink, str(tmp_path / "log"),
            config=fast_config(max_batch=4),
        )
        timer = threading.Timer(
            0.05, preempt.request_preemption, args=("test preemption",)
        )
        timer.start()
        try:
            summary = runner.run()
        finally:
            timer.cancel()
        assert summary["stop_reason"] == "preempted"
        committed = len(sink.read_all())
        # everything admitted before the preempt was flushed + committed
        assert committed == summary["committed_offset"] or committed == 0

        # a fresh runner resumes from the committed offset: the union is
        # exactly the source, no duplicates
        src.end()
        runner2 = StreamRunner(
            src, slow, sink, str(tmp_path / "log"),
            config=fast_config(max_batch=4),
        )
        runner2.run()
        assert _offsets(sink.read_all()) == list(range(1, 41))

    def test_restart_replays_pending_epoch(self, tmp_path):
        # simulate a crash between payload write and marker: the payload
        # exists, the sink write may or may not have landed
        log = CommitLog(str(tmp_path / "log"))
        records = [{"offset": 1, "input": [1.0], "output": [2.0]}]
        log.write_payload(1, {"end_offset": 1, "records": records})
        src = QueueSource()
        src.put([1.0])  # record 1, already scored per the payload
        src.end()
        sink = JsonlSink(str(tmp_path / "out.jsonl"))
        runner = StreamRunner(
            src, lambda x: np.asarray(x), sink, str(tmp_path / "log"),
            config=fast_config(),
        )
        summary = runner.run()
        assert summary["replayed"] == 1
        rows = sink.read_all()
        # the epoch was re-emitted from the payload (bit-identical
        # outputs), the source was NOT re-polled for it
        assert len(rows) == 1
        assert rows[0]["output"] == [2.0]
        assert CommitLog(str(tmp_path / "log")).pending() == []

    def test_from_server_scores_through_endpoint(self, tmp_path):
        from sparkdl_tpu_torch.serving import ModelServer, ServingConfig

        with ModelServer(config=ServingConfig(), device="cpu") as server:
            server.register(
                "double", lambda b: b * 2.0, item_shape=(2,),
                compile=False,
            )
            src = QueueSource()
            src.put_all([
                np.full((2,), float(i), dtype=np.float32) for i in range(9)
            ])
            src.end()
            sink = JsonlSink(str(tmp_path / "out.jsonl"))
            runner = StreamRunner.from_server(
                src, server, sink, str(tmp_path / "log"),
                model_id="double", config=fast_config(),
            )
            runner.run()
        rows = sink.read_all()
        assert _offsets(rows) == list(range(1, 10))
        assert rows[4]["output"] == [8.0, 8.0]


# ---------------------------------------------------------------------------
# the kill matrix: FaultPlan SIGKILL at each streaming site → restart →
# sink record set == source record set
# ---------------------------------------------------------------------------

N_RECORDS = 30

WORKER = """
import json, os, sys
sys.path.insert(0, {repo!r})
from sparkdl_tpu_torch.streaming import FileTailSource, JsonlSink, StreamRunner, StreamConfig
workdir = {workdir!r}
source = FileTailSource(os.path.join(workdir, "in.jsonl"))
sink = JsonlSink(os.path.join(workdir, "out.jsonl"))
runner = StreamRunner(
    source,
    lambda xs: [x["x"] * 2 for x in xs],
    sink,
    os.path.join(workdir, "log"),
    config=StreamConfig(max_batch=4, max_wait_ms=5.0, poll_batch=4,
                        poll_interval_ms=2.0),
    pack=False,
)
summary = runner.run(idle_timeout_s=1.0)
print("SUMMARY " + json.dumps(summary))
print("WORKER_FINISHED")
"""

SIGTERM_WORKER = """
import json, os, signal, sys, threading, time
sys.path.insert(0, {repo!r})
import numpy as np
from sparkdl_tpu_torch.streaming import FileTailSource, JsonlSink, StreamRunner, StreamConfig
workdir = {workdir!r}
source = FileTailSource(os.path.join(workdir, "in.jsonl"))
sink = JsonlSink(os.path.join(workdir, "out.jsonl"))

def slow(xs):
    time.sleep(0.01)
    return [x["x"] * 2 for x in xs]

runner = StreamRunner(
    source, slow, sink, os.path.join(workdir, "log"),
    config=StreamConfig(max_batch=4, max_wait_ms=5.0, poll_batch=4,
                        poll_interval_ms=2.0),
    pack=False,
)
threading.Timer(0.15, os.kill, args=(os.getpid(), signal.SIGTERM)).start()
summary = runner.run(idle_timeout_s=5.0)
print("SUMMARY " + json.dumps(summary))
"""


def _write_source(workdir, n=N_RECORDS):
    os.makedirs(workdir, exist_ok=True)
    with open(os.path.join(workdir, "in.jsonl"), "w") as fh:
        for i in range(n):
            fh.write(json.dumps({"x": i}) + "\n")


def _run_worker(workdir, script=WORKER, fault_plan=None, timeout=90):
    env = dict(os.environ)
    env.pop("SPARKDL_FAULT_PLAN", None)
    if fault_plan is not None:
        env["SPARKDL_FAULT_PLAN"] = json.dumps(fault_plan)
    return subprocess.run(
        [sys.executable, "-c", script.format(repo=_REPO, workdir=workdir)],
        env=env,
        stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT,
        text=True,
        timeout=timeout,
    )


def _summary_of(proc):
    for line in proc.stdout.splitlines():
        if line.startswith("SUMMARY "):
            return json.loads(line[len("SUMMARY "):])
    raise AssertionError(f"no SUMMARY in worker output:\n{proc.stdout}")


def _assert_exactly_once(workdir):
    with open(os.path.join(workdir, "out.jsonl")) as fh:
        rows = [json.loads(line) for line in fh if line.endswith("\n")]
    inputs = [r["input"]["x"] for r in rows]
    assert sorted(inputs) == list(range(N_RECORDS)), (
        f"sink != source: {len(inputs)} rows, "
        f"dupes={len(inputs) - len(set(inputs))}"
    )
    for r in rows:
        assert r["output"] == r["input"]["x"] * 2


@pytest.mark.parametrize("site,at", [
    ("streaming.poll", 3),
    ("streaming.sink", 2),
    ("streaming.commit", 2),
])
def test_kill_at_site_then_restart_is_exactly_once(tmp_path, site, at):
    workdir = str(tmp_path)
    _write_source(workdir)
    killed = _run_worker(
        workdir, fault_plan=[{"site": site, "kill": True, "at": at}]
    )
    assert killed.returncode == 9, killed.stdout
    assert "WORKER_FINISHED" not in killed.stdout

    restarted = _run_worker(workdir)
    assert restarted.returncode == 0, restarted.stdout
    summary = _summary_of(restarted)
    assert summary["committed_offset"] is not None
    _assert_exactly_once(workdir)


def test_kill_between_payload_and_marker_replays_exactly_that_epoch(
    tmp_path,
):
    """Death AFTER the payload write but BEFORE the
    commit marker.  The restart must replay exactly the uncertain epoch
    (from its stored payload — no re-scoring) and the sink must hold one
    copy of every record."""
    workdir = str(tmp_path)
    _write_source(workdir)
    killed = _run_worker(
        workdir,
        fault_plan=[{"site": "streaming.commit", "kill": True, "at": 2}],
    )
    assert killed.returncode == 9, killed.stdout
    from sparkdl_tpu_torch.streaming import CommitLog as Log

    log = Log(os.path.join(workdir, "log"))
    pending_before = log.pending()
    assert pending_before, "the kill must leave a payload without marker"

    restarted = _run_worker(workdir)
    assert restarted.returncode == 0, restarted.stdout
    summary = _summary_of(restarted)
    assert summary["replayed"] == len(pending_before)
    assert log.pending() == []
    _assert_exactly_once(workdir)


def test_sigterm_flushes_inflight_epoch_and_resumes(tmp_path):
    workdir = str(tmp_path)
    _write_source(workdir)
    first = _run_worker(workdir, script=SIGTERM_WORKER, timeout=120)
    assert first.returncode == 0, first.stdout
    summary = _summary_of(first)
    if summary["stop_reason"] == "preempted":
        # resume from the last committed offset and finish the stream
        restarted = _run_worker(workdir)
        assert restarted.returncode == 0, restarted.stdout
    else:
        # the whole stream committed before the signal landed — already
        # complete; nothing to resume
        assert summary["stop_reason"] == "idle_timeout"
    _assert_exactly_once(workdir)


# ---------------------------------------------------------------------------
# the port's own: tensor results through the dispatch window, the SLO bundle
# ---------------------------------------------------------------------------


def test_tensor_results_go_through_the_dispatch_window(tmp_path):
    """A scorer that returns tensors hands them to the engine's window
    (``engine.inflight`` moves); a bf16 result is widened to float32 before
    its copy, since numpy has no bfloat16. Host results committed between
    tensor ones keep the epoch order."""
    calls = []

    def score(x):
        calls.append(len(x))
        t = torch.from_numpy(np.asarray(x, np.float32)) * 0.5
        if len(calls) % 3 == 0:
            return (t * 2.0).numpy()  # a host result now and then
        return t.to(torch.bfloat16)

    src = QueueSource()
    src.put_all([[float(i), float(-i)] for i in range(30)])
    src.end()
    sink = JsonlSink(str(tmp_path / "out.jsonl"))
    gauge_seen = []
    inflight = metrics.gauge("engine.inflight")
    orig_set = inflight.set

    def spy(v):
        gauge_seen.append(v)
        orig_set(v)

    inflight.set = spy
    try:
        summary = StreamRunner(src, score, sink, str(tmp_path / "log"),
                               config=fast_config(dispatch_depth=2)).run()
    finally:
        del inflight.set
    rows = sink.read_all()
    assert summary["stop_reason"] == "source_finished"
    assert [r["offset"] for r in rows] == list(range(1, 31))
    assert [r["epoch"] for r in rows] == sorted(r["epoch"] for r in rows)
    for r in rows:
        x = np.asarray(r["input"], np.float32)
        got = np.asarray(r["output"], np.float32)
        assert got.dtype == np.float32
        bf16 = torch.from_numpy(x * 0.5).to(torch.bfloat16).float().numpy()
        assert np.array_equal(got, bf16) or np.array_equal(got, x)
    assert max(gauge_seen) >= 1


def test_runner_slos_follow_the_allowed_lateness(tmp_path):
    runner = StreamRunner(QueueSource(), lambda x: x, CallbackSink(lambda e, r: None),
                          str(tmp_path / "log"),
                          config=fast_config(allowed_lateness_ms=8000.0))
    lag, = runner.slos()
    assert lag.series == "streaming.watermark_lag_ms" and lag.threshold == 8000.0
    lag, rate = runner.slos(max_watermark_lag_ms=100.0, min_commit_rate=0.5)
    assert lag.threshold == 100.0 and rate.kind == "rate_min" and rate.threshold == 0.5


def test_stream_config_reads_the_environment_at_construction(monkeypatch):
    monkeypatch.setenv("SPARKDL_STREAM_MAX_BATCH", "7")
    monkeypatch.setenv("SPARKDL_STREAM_MAX_WAIT_MS", "3.5")
    monkeypatch.setenv("SPARKDL_STREAM_QUEUE_CAPACITY", "9")
    cfg = StreamConfig()
    assert (cfg.max_batch, cfg.max_wait_ms, cfg.queue_capacity) == (7, 3.5, 9)
    monkeypatch.delenv("SPARKDL_STREAM_MAX_BATCH")
    assert StreamConfig().max_batch == 32


# ---------------------------------------------------------------------------
# parity: a tiny flash ViT streamed through both packages' runners
# ---------------------------------------------------------------------------

#: (patch, width, depth, heads, mlp): 2 blocks, width 64, head_dim 32
TINY_VIT = (8, 64, 2, 2, 128)
GEOMETRY = dict(variant="tiny-stream", num_classes=5, image_size=16)


def test_a_flash_vit_streamed_by_both_runners_agrees(tmp_path, monkeypatch):
    import jax
    import jax.numpy as jnp

    from sparkdl_tpu.models import vit as jax_vit
    from sparkdl_tpu.ops.flash_attention import flash_attention as jax_flash_attention
    from sparkdl_tpu.streaming import JsonlSink as JaxJsonlSink
    from sparkdl_tpu.streaming import QueueSource as JaxQueueSource
    from sparkdl_tpu.streaming import StreamConfig as JaxStreamConfig
    from sparkdl_tpu.streaming import StreamRunner as JaxStreamRunner
    from sparkdl_tpu_torch.models import vit as port_vit
    from sparkdl_tpu_torch.models.convert import vit_state_dict_from_flax

    monkeypatch.setitem(jax_vit.VIT_VARIANTS, "tiny-stream", TINY_VIT)
    monkeypatch.setitem(port_vit.VIT_VARIANTS, "tiny-stream", TINY_VIT)
    images = np.random.default_rng(16).random((10, 16, 16, 3), dtype=np.float32)
    jax_model = jax_vit.ViT(**GEOMETRY, attn_impl=jax_flash_attention)
    params = jax.tree_util.tree_map(
        np.asarray, jax_model.init(jax.random.PRNGKey(0), jnp.asarray(images[:2])))
    module = port_vit.ViT(**GEOMETRY, attn_impl="flash")
    module.load_state_dict(vit_state_dict_from_flax(params), strict=True)
    module.eval()

    def port_score(x):
        with torch.inference_mode():
            return module(torch.from_numpy(np.asarray(x, np.float32)))

    def jax_score(x):
        return jax_model.apply(params, jnp.asarray(x))

    knobs = dict(max_batch=4, max_wait_ms=5.0, poll_batch=4, poll_interval_ms=2.0)
    jax_src, src = JaxQueueSource(), QueueSource()
    for s in (jax_src, src):
        s.put_all(list(images))
        s.end()
    jax_sink = JaxJsonlSink(str(tmp_path / "jax.jsonl"))
    JaxStreamRunner(jax_src, jax_score, jax_sink, str(tmp_path / "jax_log"),
                    config=JaxStreamConfig(**knobs)).run()
    sink = JsonlSink(str(tmp_path / "port.jsonl"))
    summary = StreamRunner(src, port_score, sink, str(tmp_path / "port_log"),
                           config=StreamConfig(**knobs)).run()
    want = {r["offset"]: r for r in jax_sink.read_all()}
    got = sink.read_all()
    assert summary["committed_offset"] == 10
    assert sorted(r["offset"] for r in got) == sorted(want) == list(range(1, 11))
    for r in got:
        w = want[r["offset"]]
        np.testing.assert_array_equal(np.asarray(r["input"]), np.asarray(w["input"]))
        out = np.asarray(r["output"])
        assert out.shape == (5,) and np.isfinite(out).all()
        np.testing.assert_allclose(out, np.asarray(w["output"]), atol=1e-5, rtol=1e-4)
