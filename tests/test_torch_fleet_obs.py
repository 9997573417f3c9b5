"""The port's fleet-wide observability, on the cases of the JAX
package's ``tests/test_fleet_obs.py``: trace propagation across the wire,
the supervisor-side federation of replica metrics and the federated canary
signal.

- **stitched traces across the lanes**: with tracing on, one
  ``router.route`` yields a ``router.request`` root AND a ``replica.serve``
  child that crossed a real socket (TCP, shm ring, shm spill, a coalesced
  micro-batch), sharing one ``trace_id``; a request whose replica is gone
  still ends its root span with an ``error`` attribute.
- **ids**: span and trace ids are random 63-bit odd numbers per process,
  deterministic under ``SPARKDL_TRACE_SEED``.
- **federation**: :class:`FleetCollector`'s scrape semantics (labels,
  sum-vs-max version aggregation, prefix filter, failure bookkeeping,
  forgetting a target, the labeled Prometheus block) and one real HTTP
  round trip against an ObsServer.
- **federated canary**: a canary whose failures the router's retries mask
  (the router's ``rollout.v2.*`` stays ok) still pages on its OWN scraped
  series. The rollout controller's default watch over that series comes
  with the controller (ROADMAP item 10c).
"""

import threading
import time

import numpy as np
import pytest

from sparkdl_tpu_torch.obs import JsonlTraceSink, ObsServer, TimeSeriesRecorder
from sparkdl_tpu_torch.obs.fleet import FleetCollector, sanitize_label
from sparkdl_tpu_torch.obs.slo import SLOEngine, fleet_rollout_slos, rollout_slos
from sparkdl_tpu_torch.obs.trace import _IdSource, tracer
from sparkdl_tpu_torch.serving import ModelServer, ServingConfig
from sparkdl_tpu_torch.serving.replica import ReplicaService
from sparkdl_tpu_torch.serving.router import Router
from sparkdl_tpu_torch.utils.metrics import MetricsRegistry, metrics


@pytest.fixture(autouse=True)
def tracing_off_between_tests():
    """Every test starts and ends at the pay-nothing default."""
    tracer.disable()
    metrics.reset()
    yield
    tracer.disable()
    metrics.reset()


def enabled_sink(capacity=4096):
    sink = JsonlTraceSink(capacity=capacity)
    tracer.enable(sink)
    return sink


def plain_service(max_wait_ms=1.0, big_shape=None):
    """An in-process ReplicaService around a compile=False ModelServer
    with endpoint ``ep0`` of shape (4,); ``big_shape`` registers a
    second endpoint ``big`` (spill tests need frames larger than the
    shm ring)."""
    server = ModelServer(ServingConfig(
        max_batch=8, max_wait_ms=max_wait_ms, queue_capacity=64,
    ), device="cpu")
    server.register(
        "ep0", lambda x: x * 2.0, item_shape=(4,),
        compile=False,
    )
    if big_shape is not None:
        server.register(
            "big", lambda x: x * 2.0, item_shape=big_shape,
            compile=False,
        )
    return ReplicaService(server).start()


def assert_stitched(sink, n_roots=1):
    """Every ``router.request`` root has a ``replica.serve`` child in
    the SAME trace whose ``parent_id`` is the root's span id — the
    cross-process stitch.  Returns (roots, serves)."""
    roots = sink.find("router.request")
    serves = sink.find("replica.serve")
    assert len(roots) >= n_roots, f"got {len(roots)} roots, want {n_roots}"
    for root in roots:
        assert root["parent_id"] is None
        kids = [
            s for s in serves
            if s["trace_id"] == root["trace_id"]
            and s["parent_id"] == root["span_id"]
        ]
        assert kids, (
            f"router.request trace {root['trace_id']} has no stitched "
            "replica.serve child"
        )
    return roots, serves


# ----------------------------------------------------------------------
# cross-process trace propagation, per lane
# ----------------------------------------------------------------------
class TestStitchedTraces:
    def test_tcp_lane_stitches_parent_child(self, monkeypatch):
        monkeypatch.setenv("SPARKDL_WIRE_TRANSPORT", "tcp")
        sink = enabled_sink()
        svc = plain_service()
        with Router() as router:
            router.add("r0", "127.0.0.1", svc.port)
            try:
                assert router.lanes()["r0"] == "tcp"
                out = router.route(np.ones(4, np.float32), model_id="ep0")
                np.testing.assert_allclose(np.asarray(out), 2.0)
            finally:
                svc.close()
        roots, serves = assert_stitched(sink)
        # the reply envelope does NOT leak the piggybacked spans to the
        # caller — the router pops them into its own tracer
        assert roots[-1]["attributes"].get("replica") == "r0"

    def test_shm_ring_lane_stitches(self, monkeypatch):
        monkeypatch.setenv("SPARKDL_WIRE_TRANSPORT", "shm")
        sink = enabled_sink()
        svc = plain_service()
        with Router() as router:
            router.add("r0", "127.0.0.1", svc.port, lanes=svc.lanes)
            try:
                assert router.lanes()["r0"] == "shm"
                router.route(np.ones(4, np.float32), model_id="ep0")
            finally:
                svc.close()
        assert_stitched(sink)

    def test_shm_spill_lane_stitches(self, monkeypatch):
        # a frame bigger than the default 1 MiB ring must spill onto
        # the TCP side-channel — and the trace context rides the spill
        monkeypatch.setenv("SPARKDL_WIRE_TRANSPORT", "shm")
        sink = enabled_sink()
        svc = plain_service(big_shape=(300_000,))
        with Router() as router:
            router.add("r0", "127.0.0.1", svc.port, lanes=svc.lanes)
            try:
                assert router.lanes()["r0"] == "shm"
                before = metrics.counter("wire.shm.spill").value
                out = router.route(
                    np.ones(300_000, np.float32), model_id="big",
                )
                assert np.asarray(out).shape == (300_000,)
                assert metrics.counter("wire.shm.spill").value > before
            finally:
                svc.close()
        assert_stitched(sink)

    def test_coalesced_batch_keeps_per_request_traces(self):
        # several concurrent requests coalesce into one device batch;
        # each still gets its OWN stitched trace, and the batch span
        # records the member request span ids (the fan-in edge)
        sink = enabled_sink()
        svc = plain_service(max_wait_ms=200.0)
        n = 4
        with Router() as router:
            router.add("r0", "127.0.0.1", svc.port)
            try:
                errs = []
                barrier = threading.Barrier(n)

                def one():
                    try:
                        barrier.wait(timeout=10)
                        router.route(
                            np.ones(4, np.float32), model_id="ep0",
                        )
                    except Exception as exc:  # noqa: BLE001
                        errs.append(exc)

                threads = [
                    threading.Thread(target=one, daemon=True)
                    for _ in range(n)
                ]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(timeout=30)
                assert not errs
            finally:
                svc.close()
        roots, _ = assert_stitched(sink, n_roots=n)
        assert len({r["trace_id"] for r in roots}) == n  # distinct traces
        batches = sink.find("serving.batch")
        assert any(
            len(b["attributes"].get("member_span_ids") or []) >= 2
            for b in batches
        ), "no coalesced batch recorded >= 2 member spans"

    def test_dead_replica_terminates_root_with_error(self):
        # the replica is gone before the request: the root span must
        # still END, error-attributed — never a dangling parent whose
        # children can't be found
        sink = enabled_sink()
        svc = plain_service()
        with Router() as router:
            router.add("r0", "127.0.0.1", svc.port)
            svc.close()  # port now refuses connections
            with pytest.raises(Exception):
                router.route(np.ones(4, np.float32), model_id="ep0")
        roots = sink.find("router.request")
        assert roots, "root span never reached the sink (dangled)"
        assert roots[-1]["attributes"].get("error"), (
            "terminated request's root span carries no error attribute"
        )
        dead_trace = roots[-1]["trace_id"]
        assert not [
            s for s in sink.find("replica.serve")
            if s["trace_id"] == dead_trace
        ], "a replica span appeared for a request that never served"


class TestTraceIds:
    def test_ids_are_63_bit_odd_and_collision_free(self):
        src = _IdSource()
        ids = [src.next_id() for _ in range(4096)]
        assert len(set(ids)) == len(ids)
        assert all(0 < i < 2 ** 63 and i & 1 for i in ids)

    def test_seeded_ids_are_deterministic_per_process(self, monkeypatch):
        monkeypatch.setenv("SPARKDL_TRACE_SEED", "42")
        a = [_IdSource().next_id() for _ in range(16)]
        b = [_IdSource().next_id() for _ in range(16)]
        assert a == b
        monkeypatch.setenv("SPARKDL_TRACE_SEED", "43")
        c = [_IdSource().next_id() for _ in range(16)]
        assert c != a


# ----------------------------------------------------------------------
# recorder injection seam
# ----------------------------------------------------------------------
class TestRecorderRecord:
    def test_record_injects_points(self):
        rec = TimeSeriesRecorder(interval_s=60.0)
        assert rec.record("fleet.x", 1.0, now=10.0)
        assert rec.record("fleet.x", 3.0, now=20.0)
        assert [v for _, v in rec.points("fleet.x")] == [1.0, 3.0]
        assert rec.latest("fleet.x") == 3.0

    def test_record_respects_series_cap(self):
        rec = TimeSeriesRecorder(interval_s=60.0, max_series=1)
        assert rec.record("fleet.a", 1.0, now=1.0)
        assert not rec.record("fleet.b", 1.0, now=1.0)  # capped, dropped
        assert rec.latest("fleet.b") is None
        assert rec.record("fleet.a", 2.0, now=2.0)  # existing still fine


# ----------------------------------------------------------------------
# fleet collector
# ----------------------------------------------------------------------
def collector(targets, snaps, recorder=None):
    """A FleetCollector over synthetic targets whose ``_fetch`` serves
    canned ``/metrics.json`` payloads (raises for unknown urls — the
    failure path)."""
    rec = recorder or TimeSeriesRecorder(interval_s=60.0)
    fc = FleetCollector(
        rec, lambda: list(targets), registry=MetricsRegistry(),
    )
    fc._fetch = lambda url: dict(snaps[url])
    return fc, rec


class TestFleetCollector:
    TARGETS = [
        {"name": "replica-0", "version": "v2", "url": "http://a"},
        {"name": "replica-1", "version": "v2", "url": "http://b"},
    ]
    SNAPS = {
        "http://a": {
            "serving.requests": 5.0,
            "serving.latency_ms.p99": 10.0,
            "sparkdl.up": 1.0,
            "router.not_federated": 9.0,  # outside the prefix filter
            "serving.note": "not-a-number",
        },
        "http://b": {
            "serving.requests": 7.0,
            "serving.latency_ms.p99": 30.0,
        },
    }

    def test_scrape_federates_labeled_and_aggregated(self):
        fc, rec = collector(self.TARGETS, self.SNAPS)
        assert fc.scrape_once(now=5.0) == 2
        # per-replica ground truth, labels sanitized into segments
        assert rec.latest(
            "fleet.replica.replica_0.serving.requests"
        ) == 5.0
        assert rec.latest(
            "fleet.replica.replica_1.serving.latency_ms.p99"
        ) == 30.0
        # per-version: counters sum, quantiles max
        assert rec.latest("fleet.version.v2.serving.requests") == 12.0
        assert rec.latest(
            "fleet.version.v2.serving.latency_ms.p99"
        ) == 30.0
        # the prefix filter keeps foreign subsystems out of the caps
        assert rec.latest(
            "fleet.replica.replica_0.router.not_federated"
        ) is None
        snap = fc.snapshot()
        assert (snap["healthy"], snap["total"]) == (2, 2)

    def test_failed_target_is_bookkept_not_fatal(self):
        targets = list(self.TARGETS) + [
            {"name": "replica-9", "version": "v2", "url": "http://gone"},
        ]
        fc, rec = collector(targets, self.SNAPS)
        assert fc.scrape_once(now=1.0) == 2  # the bad target absorbed
        assert fc.scrape_once(now=2.0) == 2
        snap = fc.snapshot()
        assert (snap["healthy"], snap["total"]) == (2, 3)
        bad = snap["targets"]["replica-9"]
        assert bad["ok"] is False
        assert bad["consecutive_errors"] == 2
        assert rec.latest("fleet.replica.replica_9.sparkdl.up") is None

    def test_departed_target_is_forgotten(self):
        targets = list(self.TARGETS)
        fc, _ = collector(targets, self.SNAPS)
        fc.scrape_once(now=1.0)
        del targets[1]  # replica-1 retired
        fc.scrape_once(now=2.0)
        assert sorted(fc.snapshot()["targets"]) == ["replica-0"]

    def test_exemplar_samples_skipped(self):
        """Exemplar trace ids are links, not gauges — summing them
        across replicas (or maxing a trace id) is meaningless, so the
        federation skips the ``.exemplar_*`` snapshot keys."""
        snaps = {
            "http://a": {
                "serving.requests": 5.0,
                "serving.latency_ms.p99": 10.0,
                "serving.latency_ms.exemplar_value": 10.0,
                "serving.latency_ms.exemplar_trace_id": 12345,
            },
            "http://b": dict(self.SNAPS["http://b"]),
        }
        fc, rec = collector(self.TARGETS, snaps)
        assert fc.scrape_once(now=1.0) == 2
        assert rec.latest(
            "fleet.replica.replica_0.serving.latency_ms.p99"
        ) == 10.0
        assert rec.latest(
            "fleet.replica.replica_0.serving.latency_ms"
            ".exemplar_trace_id"
        ) is None
        assert rec.latest(
            "fleet.version.v2.serving.latency_ms.exemplar_value"
        ) is None

    def test_prometheus_block_carries_labels(self):
        fc, _ = collector(self.TARGETS, self.SNAPS)
        fc.scrape_once(now=1.0)
        block = fc.prometheus_block()
        assert 'replica="replica-0",version="v2"' in block
        assert "serving_requests" in block.replace(".", "_")

    def test_real_http_roundtrip_against_obs_server(self):
        # one end-to-end pass over a real socket: ObsServer serves its
        # registry's /metrics.json, the collector federates it
        reg = MetricsRegistry()
        reg.counter("serving.requests").add(3)
        obs = ObsServer(port=0, registry=reg).start()
        try:
            rec = TimeSeriesRecorder(interval_s=60.0)
            fc = FleetCollector(
                rec,
                lambda: [{
                    "name": "r0", "version": "v1",
                    "url": f"http://127.0.0.1:{obs.port}",
                }],
                registry=MetricsRegistry(),
            )
            assert fc.scrape_once(now=1.0) == 1
            assert rec.latest("fleet.replica.r0.serving.requests") == 3.0
            assert rec.latest("fleet.version.v1.serving.requests") == 3.0
        finally:
            obs.close()

    def test_sanitize_label(self):
        assert sanitize_label("replica-0") == "replica_0"
        assert sanitize_label("V2.Canary") == "v2_canary"
        assert sanitize_label("") == "unknown"


# ----------------------------------------------------------------------
# the federated canary signal
# ----------------------------------------------------------------------
class TestFederatedCanary:
    def test_fleet_rollout_slos_watch_federated_series(self):
        slos = fleet_rollout_slos("V2-Canary")
        by_name = {s.name: s for s in slos}
        assert set(by_name) == {
            "fleet.rollout.v2_canary.latency",
            "fleet.rollout.v2_canary.errors",
        }
        lat = by_name["fleet.rollout.v2_canary.latency"]
        assert lat.series == (
            "fleet.version.v2_canary.serving.latency_ms.p99"
        )
        err = by_name["fleet.rollout.v2_canary.errors"]
        assert err.numerator == "fleet.version.v2_canary.serving.errors"
        assert err.denominator == (
            "fleet.version.v2_canary.serving.requests"
        )

    def test_canary_pages_on_own_series_while_router_view_is_clean(self):
        # every request the canary serves fails,
        # but the router's retry loop re-places them on v1 — so the
        # router-side attempt series stay clean and rollout_slos alone
        # would bake a burning canary to 100%.  The federated series
        # are the canary's own numbers; they page.
        rec = TimeSeriesRecorder(interval_s=60.0)
        engine = SLOEngine(
            rec, registry=MetricsRegistry(), clock=lambda: 0.0,
        )
        engine.add(*rollout_slos(
            "v2", fast_window_s=5.0, slow_window_s=10.0,
        ))
        engine.add(*fleet_rollout_slos(
            "v2", fast_window_s=5.0, slow_window_s=10.0,
        ))
        for t in range(12):
            t = float(t)
            # router-side attempt view: traffic flows, zero errors,
            # healthy latency (the retried failures landed on v1)
            rec.record("router.requests.v2", 10.0 * t, now=t)
            rec.record("router.errors.v2", 0.0, now=t)
            rec.record("router.latency_ms.v2.p99", 5.0, now=t)
            # the canary's scraped ground truth: everything it
            # actually served errored
            rec.record(
                "fleet.version.v2.serving.requests", 10.0 * t, now=t,
            )
            rec.record(
                "fleet.version.v2.serving.errors", 10.0 * t, now=t,
            )
        states = engine.evaluate_once(now=11.0)
        assert states["rollout.v2.errors"] == "ok"
        assert states["rollout.v2.latency"] == "ok"
        assert states["fleet.rollout.v2.errors"] == "page"

    def test_quiet_fleet_series_do_not_page(self):
        # no-data is no evidence: a canary that served nothing yet must
        # not page (the 1% stage may take a moment to see traffic)
        rec = TimeSeriesRecorder(interval_s=60.0)
        engine = SLOEngine(
            rec, registry=MetricsRegistry(), clock=lambda: 0.0,
        )
        engine.add(*fleet_rollout_slos(
            "v2", fast_window_s=5.0, slow_window_s=10.0,
        ))
        states = engine.evaluate_once(now=11.0)
        assert states["fleet.rollout.v2.errors"] == "ok"
        assert states["fleet.rollout.v2.latency"] == "ok"
