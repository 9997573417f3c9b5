"""The port's fleet simulator (``sparkdl_tpu_torch.sim``) against the JAX
package's, on the CPU.

- Each case of ``tests/test_sim.py`` runs as its port twin
  (``tests/torch_fixtures/twin.py``: the same source with its imports naming
  ``sparkdl_tpu_torch``) and must pass its own assertions. Three cases are
  not twinned (:data:`NOT_TWINNED`).
- Cross-package parity: on the committed fixture, the port's
  ``FleetReplay(...).event_log_bytes()`` equals the JAX package's byte for
  byte, under the live fleet's config (seeds 0 and 1), the autoscale config
  and both rollout configs of the reference's cases, and so do the reports
  but for their wall-clock fields; ``tune`` gives the same artifact. A
  difference names the first event where the two logs part.
- A port fleet on the CPU: requests routed through the port's ``Router`` to
  two in-process replicas, tracing on, give one record per request through
  ``records_from_spans``, and those records replay.
"""

import json
import os
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_fixtures"))
import twin  # noqa: E402

from sparkdl_tpu.sim import FleetReplay as JaxFleetReplay  # noqa: E402
from sparkdl_tpu.sim.tune import tune as jax_tune  # noqa: E402
from sparkdl_tpu_torch.obs import JsonlTraceSink  # noqa: E402
from sparkdl_tpu_torch.obs.trace import tracer  # noqa: E402
from sparkdl_tpu_torch.serving import ModelServer, ServingConfig  # noqa: E402
from sparkdl_tpu_torch.serving.replica import ReplicaService  # noqa: E402
from sparkdl_tpu_torch.serving.router import Router  # noqa: E402
from sparkdl_tpu_torch.sim import (  # noqa: E402
    FleetReplay,
    load_trace,
    records_from_spans,
    write_trace,
)
from sparkdl_tpu_torch.sim.trace import EMERGENT_PHASES, REPLAYED_PHASES  # noqa: E402
from sparkdl_tpu_torch.sim.tune import tune  # noqa: E402
from sparkdl_tpu_torch.utils.metrics import metrics  # noqa: E402

REFERENCE = Path(__file__).with_name("test_sim.py")
JAX_TESTS = twin.load(REFERENCE, "_sim_reference_tests")
PORT_TESTS = twin.load(REFERENCE, "_sim_port_tests", twin.PORT_SUBS[:1])
FIXTURE = JAX_TESTS.FIXTURE
LIVE_CONFIG = JAX_TESTS.LIVE_CONFIG

#: the reference's cases the port does not run, and why
NOT_TWINNED = {
    "test_replay_is_100x_faster_than_wall_clock":
        "a wall-clock ratio, not a behaviour: it fails on the JAX package itself "
        "when six test workers share one host; chip_smoke.py phase 21 (a) prints "
        "the port's ratio on the card's host",
    "test_perf_gate_sim_flavor_passes_on_committed_artifact":
        "imports ci/perf_gate.py, the JAX package's gate (its twin is not written)",
    "test_shape_key_separates_sim_from_live_reports":
        "imports ci/perf_gate.py, the JAX package's gate (its twin is not written)",
}
CASES = [c for c, _ in twin.cases(PORT_TESTS) if c not in NOT_TWINNED]

#: the reference's controller configs (test_autoscaler_scales_up_under_stress,
#: test_rollout_promotes_clean_canary, test_rollout_rolls_back_regressed_canary)
AUTOSCALE_CONFIG = {
    "replicas": 1,
    "autoscale": {
        "min": 1, "max": 4, "interval_s": 0.5, "cooldown_s": 0.5,
        "step_up": 2, "ok_streak": 2, "per_replica_inflight": 8,
    },
    "tick_s": 0.25, "slo_fast_s": 1.0, "slo_slow_s": 2.5,
}


def rollout_config(regress_ms):
    return {
        "rollout": {
            "new_version": "v2", "replicas": 2, "stages": (0.5, 1.0),
            "bake_s": 0.5, "interval_s": 0.25, "regress_ms": regress_ms,
            "slo_p99_ms": 300.0,
        },
        "tick_s": 0.25,
    }


#: (config, seed, time_scale) of each parity run
PARITY = {
    "live-seed0": (LIVE_CONFIG, 0, 1.0),
    "live-seed1": (LIVE_CONFIG, 1, 1.0),
    "autoscale": (AUTOSCALE_CONFIG, 0, 4.0),
    "rollout-clean": (rollout_config(0.0), 0, 1.0),
    "rollout-regress": (rollout_config(500.0), 0, 1.0),
}
#: report fields read off the wall clock
WALL_FIELDS = ("wall_s", "speedup")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def records():
    return load_trace(str(FIXTURE))[1]


def test_every_case_is_twinned_or_named():
    listed = [c for c, _ in twin.cases(JAX_TESTS)]
    assert len(listed) == 20
    assert sorted(CASES + list(NOT_TWINNED)) == sorted(listed)


@pytest.mark.parametrize("case_id", CASES)
def test_sim_case_passes_on_the_port(case_id, tmp_path):
    with pytest.MonkeyPatch.context() as mp:
        twin.run_body(PORT_TESTS, case_id, {}, {
            "tmp_path": lambda: tmp_path,
            "monkeypatch": lambda: mp,
        })


def _without_wall_clock(report):
    return {k: v for k, v in report.items() if k not in WALL_FIELDS}


@pytest.mark.parametrize("name", list(PARITY))
def test_event_log_equals_the_jax_packages_byte_for_byte(name):
    config, seed, time_scale = PARITY[name]
    # each package's own loader: the trace format is shared
    jax_records = JAX_TESTS.load_trace(str(FIXTURE))[1]
    port_records = load_trace(str(FIXTURE))[1]
    want = JaxFleetReplay(jax_records, config=config, seed=seed, time_scale=time_scale)
    got = FleetReplay(port_records, config=config, seed=seed, time_scale=time_scale)
    want_report, got_report = want.run(), got.run()
    want_log, got_log = want.event_log_bytes(), got.event_log_bytes()
    assert got_log == want_log, twin.first_difference(json.loads(got_log), json.loads(want_log))
    assert len(got.event_log) > 1000
    assert _without_wall_clock(got_report) == _without_wall_clock(want_report)


def test_tune_artifact_equals_the_jax_packages(records):
    jax_records = JAX_TESTS.load_trace(str(FIXTURE))[1]
    want = jax_tune(jax_records, budget=6, seed=0)
    got = tune(records, budget=6, seed=0)
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
    assert len(got["trials"]) > 6


def test_a_port_trace_reads_in_the_jax_package(records, tmp_path):
    path = tmp_path / "port.jsonl"
    assert write_trace(str(path), {"benchmark": "port"}, records) == len(records)
    meta, back = JAX_TESTS.load_trace(str(path))
    assert meta["benchmark"] == "port"
    assert [r.to_json() for r in back] == [r.to_json() for r in records]


# -- a port fleet on the CPU ------------------------------------------------

#: replicas, requests and client threads of the CPU fleet
FLEET_REPLICAS, FLEET_REQUESTS, FLEET_THREADS = 2, 32, 4
#: what a route through the router's own ``route`` records: the front door's
#: hop (``frontdoor``) and a load client's own hops (``ingress``,
#: ``egress``), which the fixture's records also hold, are not on this path
ROUTED_PHASES = {"admission", "router_queue", "transport", "wire",
                 "replica_queue", "forward", "fetch"}


@pytest.fixture
def traced_fleet():
    """Two in-process replicas of a plain endpoint ``ep0`` (``x * 2`` over
    items of shape (4,)) on the CPU behind a seeded ``Router``, tracing on;
    yields ``(router, sink)``."""
    tracer.disable()
    metrics.reset()
    sink = JsonlTraceSink(capacity=4096)
    tracer.enable(sink)
    services = []
    try:
        for _ in range(FLEET_REPLICAS):
            server = ModelServer(ServingConfig(max_batch=8, max_wait_ms=1.0, queue_capacity=64),
                                 device="cpu")
            server.register("ep0", lambda x: x * 2.0, item_shape=(4,), compile=False)
            services.append(ReplicaService(server).start())
        with Router(seed=0) as router:
            for i, svc in enumerate(services):
                router.add(f"r{i}", "127.0.0.1", svc.port, lanes=svc.lanes)
            yield router, sink
    finally:
        for svc in services:
            svc.close()
        tracer.disable()
        metrics.reset()


def test_routed_port_traffic_records_and_replays(traced_fleet, records, tmp_path):
    router, sink = traced_fleet

    def one(k):
        return np.asarray(router.route(np.full(4, k, np.float32), model_id="ep0"))

    with ThreadPoolExecutor(FLEET_THREADS) as pool:
        rows = list(pool.map(one, range(FLEET_REQUESTS)))
    for k, row in enumerate(rows):
        np.testing.assert_array_equal(row, np.full(4, 2.0 * k, np.float32))

    got = records_from_spans(sink.spans())
    assert len(got) == FLEET_REQUESTS
    assert all(r.endpoint == "ep0" and r.outcome == "ok" for r in got)
    assert all(r.phases["forward"] > 0 for r in got)
    assert [r.t for r in got] == sorted(r.t for r in got) and got[0].t == 0.0
    names = {k for r in got for k in r.phases}
    fixture_names = {k for r in records for k in r.phases}
    assert names == ROUTED_PHASES
    assert names <= fixture_names <= set(REPLAYED_PHASES) | set(EMERGENT_PHASES)

    path = tmp_path / "routed.jsonl"
    write_trace(str(path), {"benchmark": "routed"}, got)
    _, back = load_trace(str(path))
    config = {"replicas": FLEET_REPLICAS, "max_batch": 8, "max_wait_ms": 1.0,
              "queue_capacity": 64}
    runs = [FleetReplay(back, config=config, seed=0) for _ in range(2)]
    reports = [fr.run() for fr in runs]
    assert runs[0].event_log_bytes() == runs[1].event_log_bytes()
    report = reports[0]
    assert report["requests"] == FLEET_REQUESTS
    assert report["ok"] == FLEET_REQUESTS
    times = [row["t"] for row in runs[0].event_log]
    assert all(a <= b for a, b in zip(times, times[1:]))
    # the JAX package replays the port's trace to the same event log
    jax_run = JaxFleetReplay(JAX_TESTS.load_trace(str(path))[1], config=config, seed=0)
    jax_run.run()
    assert jax_run.event_log_bytes() == runs[0].event_log_bytes()


# -- the batcher's clock seam -------------------------------------------------

def test_the_batchers_clock_reaches_every_stamp():
    """``MicroBatcher(clock=)`` stamps the deadline, the enqueue, expiry and
    the batch's phases from its clock, and hands it to its admission queue;
    a ``SimBatcher`` (no worker thread) lets the test drive a batch by hand."""
    from sparkdl_tpu_torch.serving.batcher import ServingConfig as Config
    from sparkdl_tpu_torch.serving.cache import ProgramCache
    from sparkdl_tpu_torch.serving.errors import DeadlineExceeded
    from sparkdl_tpu_torch.sim import VirtualClock
    from sparkdl_tpu_torch.sim.replica import SimBatcher

    clock = VirtualClock(100.0)
    mb = SimBatcher("clocked", lambda x: x * 2.0, Config(max_batch=4), ProgramCache(),
                    item_shape=(2,), compile=False, device="cpu", clock=clock)
    try:
        assert mb._queue._clock is clock
        kept = mb.submit(np.ones(2, np.float32), deadline_ms=50.0)
        late = mb.submit(np.ones(2, np.float32), deadline_ms=5.0)
        clock.advance_to(100.01)
        batch = mb.drain(clock.now)
        assert [r.enqueued_at for r in batch] == [100.0, 100.0]
        assert [r.deadline for r in batch] == [pytest.approx(100.05), pytest.approx(100.005)]
        mb._run_batch(batch)
        np.testing.assert_array_equal(kept.result(timeout=5), np.full(2, 2.0, np.float32))
        assert kept.sparkdl_phases["replica_queue"] == pytest.approx(10.0)
        assert kept.sparkdl_phases["forward"] == 0.0
        with pytest.raises(DeadlineExceeded, match="10.0ms in queue"):
            late.result(timeout=5)
        # expired on arrival, read off the same clock
        assert isinstance(mb.submit(np.ones(2, np.float32), deadline_ms=0.0).exception(),
                          DeadlineExceeded)
    finally:
        mb.close()
