"""The port's continuous SQL against the JAX package's, on the CPU.

One differential case for each test of ``tests/test_continuous_sql.py``.
Each body runs as it is and as its port twin (``tests/torch_fixtures/
twin.py``: the same source with its imports naming ``sparkdl_tpu_torch``);
both must pass their own assertions, every ``collect()`` they make must
agree exactly, and every ``.jsonl`` file they write (the emitted windows,
the late rows' side output, the inputs) must hold the same lines byte for
byte, each line's ``epoch`` dropped (epoch boundaries follow the
micro-batches a poller thread happens to cut; window contents and their
order do not). The twin's serving UDF runs on the port's ``ModelServer`` on
the CPU (``device="cpu"``), its endpoint registered eagerly
(``compile=False``) before the query binds it.

The kill matrix's three cases run the port twin's bodies, whose workers are
torch-only subprocesses (the worker's JAX lines removed; each worker checks
that neither ``jax`` nor ``sparkdl_tpu`` was imported), with the reference's
90 s timeout; their emitted windows and late rows are then held, byte for
byte, to the JAX package's ``ContinuousQuery`` run in this process over the
same input file.

``test_vit_udf_window_aggregates_match_jax`` scores a standing query's
aggregates through the port's ``ModelServer`` with a narrow 2-layer ViT
(seeded weights converted from the JAX ``models/vit.py``), against the same
query over the JAX ViT's forward, at the slice's tolerance.
"""

import json
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_fixtures"))
import twin  # noqa: E402

from sparkdl_tpu.sql.dataframe import DataFrame as JaxDataFrame  # noqa: E402
from sparkdl_tpu_torch.sql.dataframe import DataFrame as TorchDataFrame  # noqa: E402

REFERENCE = Path(__file__).with_name("test_continuous_sql.py")
# the twin's worker imports only the port (and checks it), and its serving
# UDF runs eagerly on the CPU
_WORKER_JAX = ('os.environ.setdefault("KERAS_BACKEND", "jax")\nimport jax\n'
               'jax.config.update("jax_platforms", "cpu")\n')
PORT_SUBS = twin.PORT_SUBS + (
    (_WORKER_JAX, ""),
    ('print("WORKER_FINISHED")',
     'assert not [m for m in sys.modules if m == "jax" or m.startswith(("jax.", "sparkdl_tpu."))]'
     '\nprint("WORKER_FINISHED")'),
    ("        with ModelServer(config=ServingConfig()) as server:\n",
     '        with ModelServer(config=ServingConfig(), device="cpu") as server:\n'
     '            server.register("score3", udf._serving_endpoint["forward"],\n'
     '                            item_shape=(), compile=False)\n'),
)
JAX_TESTS = twin.load(REFERENCE, "_csql_reference_tests")
PORT_TESTS = twin.load(REFERENCE, "_csql_port_tests", PORT_SUBS)
KILL_CASES = (
    "test_kill_at_window_commit_then_restart_is_byte_identical",
    "test_kill_at_window_commit_late_rows_survive_in_side_output",
    "test_kill_at_plan_leaves_no_partial_state",
)
CASES = [c for c in twin.cases(JAX_TESTS) if c[0] not in KILL_CASES]

# the slice's tolerance (tests/test_torch_slice.py)
TOL = dict(atol=5e-4, rtol=5e-3)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _no_compile_cache(monkeypatch):
    monkeypatch.setenv("SPARKDL_COMPILE_CACHE", "off")


def _run(module, case_id, args, df_cls, tmp_path):
    with twin.recording(df_cls) as log, twin.seeded_draws(), \
            pytest.MonkeyPatch.context() as mp:
        twin.run_body(module, case_id, args, {
            "tmp_path": lambda: tmp_path,
            "monkeypatch": lambda: mp,
        })
    return log, twin.jsonl_outputs(tmp_path)


def test_every_reference_test_has_a_case():
    every = [c for c, _ in twin.cases(JAX_TESTS)]
    assert len(every) == 65  # 41 tests, three of them over 6, 6 and 15 parameters
    assert sorted(set(every) - {c for c, _ in CASES}) == sorted(KILL_CASES)
    assert [c for c, _ in twin.cases(PORT_TESTS)] == every


@pytest.mark.parametrize("case_id,args", CASES, ids=[c for c, _ in CASES])
def test_continuous_case_matches_jax(case_id, args, tmp_path):
    (tmp_path / "jax").mkdir()
    (tmp_path / "torch").mkdir()
    want_rows, want_files = _run(JAX_TESTS, case_id, args, JaxDataFrame, tmp_path / "jax")
    got_rows, got_files = _run(PORT_TESTS, case_id, args, TorchDataFrame, tmp_path / "torch")
    assert got_rows == want_rows, twin.first_difference(got_rows, want_rows)
    assert sorted(got_files) == sorted(want_files)
    for name, lines in want_files.items():
        assert got_files[name] == lines, f"{name}: " + twin.first_difference(
            got_files[name], lines)


def _jax_emission(workdir: Path) -> dict:
    """The kill matrix's query, run by the JAX package's ``ContinuousQuery``
    in this process over ``workdir``'s input, as its uninterrupted worker
    would: the emitted windows and late rows, without their epochs."""
    from sparkdl_tpu.sql import TPUSession
    from sparkdl_tpu.streaming import FileTailSource, JsonlSink, StreamConfig

    session = TPUSession.builder.getOrCreate()
    session.readStream("scores", FileTailSource(str(workdir / "in.jsonl"),
                                                event_time_field="ts"))
    out = workdir / "jax_out"
    query = session.sqlStream(
        "SELECT endpoint, p95(latency) AS p95_ms, count(*) AS n "
        "FROM scores GROUP BY WINDOW(ts, '2s'), endpoint",
        JsonlSink(str(out / "out.jsonl")), str(out / "log"),
        late_sink=JsonlSink(str(out / "late.jsonl")),
        config=StreamConfig(max_batch=4, max_wait_ms=5.0, poll_batch=4,
                            poll_interval_ms=2.0))
    try:
        query.run(idle_timeout_s=1.0)
    finally:
        query.close()
        session.catalog.dropStreamTable("scores")
    files = twin.jsonl_outputs(out)
    return {name: files.get(name, []) for name in ("out.jsonl", "late.jsonl")}


@pytest.mark.parametrize("case_id", KILL_CASES)
def test_kill_matrix_matches_jax(case_id, tmp_path):
    twin.run_body(PORT_TESTS, case_id, {}, {"tmp_path": lambda: tmp_path})
    runs = [d for d in sorted(tmp_path.iterdir()) if (d / "out.jsonl").exists()]
    assert runs, "the port's workers emitted nothing"
    for workdir in runs:
        want = _jax_emission(workdir)
        got = twin.jsonl_outputs(workdir)
        assert want["out.jsonl"], "the JAX query emitted nothing"
        for name, lines in want.items():
            assert got.get(name, []) == lines, f"{workdir.name}/{name}: " + \
                twin.first_difference(got.get(name, []), lines)


# -- a ViT scoring inside the query, through the port's ModelServer ------------------

# a narrow 2-layer ViT: (patch, width, depth, heads, mlp), added to both
# packages' variant tables for the test
NARROW_VIT = ("ViT-2L/8", (8, 32, 2, 2, 64))
VIT_KW = dict(variant=NARROW_VIT[0], image_size=16, num_classes=10)
VIT_QUERY = ("SELECT label, count(*) AS n, max(vit_top(image)) AS top, "
             "p95(vit_top(image)) AS p95 FROM frames GROUP BY WINDOW(ts, '1s'), label")


def _vit_records(n: int):
    rng = np.random.default_rng(20)
    images = rng.random((n, 16, 16, 3), dtype=np.float32)
    return images, [{"image": images[i].tolist(), "label": f"l{i % 3}", "ts": i * 100.0}
                    for i in range(n)]


def test_vit_udf_window_aggregates_match_jax(tmp_path, monkeypatch):
    import jax

    import sparkdl_tpu.models.vit as jax_vit
    import sparkdl_tpu_torch.models.vit as torch_vit
    from sparkdl_tpu.models.vit import ViT as FlaxViT
    from sparkdl_tpu.sql import TPUSession
    from sparkdl_tpu.streaming import JsonlSink as JaxJsonlSink
    from sparkdl_tpu.streaming import QueueSource as JaxQueueSource
    from sparkdl_tpu.streaming import StreamConfig as JaxStreamConfig
    from sparkdl_tpu_torch.models.convert import vit_state_dict_from_flax
    from sparkdl_tpu_torch.models.vit import ViT
    from sparkdl_tpu_torch.serving import ModelServer, ServingConfig
    from sparkdl_tpu_torch.sql import TorchSession
    from sparkdl_tpu_torch.sql.functions import UserDefinedFunction
    from sparkdl_tpu_torch.streaming import JsonlSink, QueueSource, StreamConfig

    for table in (jax_vit.VIT_VARIANTS, torch_vit.VIT_VARIANTS):
        monkeypatch.setitem(table, *NARROW_VIT)
    images, records = _vit_records(24)
    flax_model = FlaxViT(**VIT_KW, attn_impl="full")
    variables = jax.jit(flax_model.init)(jax.random.PRNGKey(20), images[:1])
    params = jax.tree_util.tree_map(np.asarray, variables["params"])

    # the JAX side: the same query, its UDF the JAX ViT's largest logit
    apply = jax.jit(lambda x: flax_model.apply({"params": params}, x))

    def jax_top(image):
        return float(np.asarray(apply(np.asarray(image, np.float32)[None])).max())

    jax_session = TPUSession.builder.getOrCreate()
    jax_session.udf.register("vit_top", jax_top)
    src = JaxQueueSource()
    src.put_all(records)
    src.end()
    jax_session.readStream("frames", src)
    config = dict(max_batch=8, max_wait_ms=5.0, poll_batch=8, poll_interval_ms=2.0)
    q = jax_session.sqlStream(VIT_QUERY, JaxJsonlSink(str(tmp_path / "jax.jsonl")),
                              str(tmp_path / "jax_log"), config=JaxStreamConfig(**config))
    try:
        q.run(idle_timeout_s=2.0)
    finally:
        q.close()
        jax_session.catalog.dropStreamTable("frames")

    # the port: the UDF's serving hook puts the converted ViT on a CPU endpoint
    module = ViT(**VIT_KW, attn_impl="flash")
    module.load_state_dict(vit_state_dict_from_flax(params), strict=True)
    module.eval()

    def forward(batch):
        with torch.inference_mode():
            return module(batch).amax(dim=-1)

    udf = UserDefinedFunction(lambda v: v, name="vit_top")
    udf._serving_endpoint = {"model_id": "vit_top", "forward": forward,
                             "item_shape": (16, 16, 3), "dtype": np.float32,
                             "fingerprint": None}
    session = TorchSession.builder.getOrCreate()
    session.udf.register("vit_top", udf)._serving_endpoint = udf._serving_endpoint
    src = QueueSource()
    src.put_all(records)
    src.end()
    session.readStream("frames", src)
    with ModelServer(config=ServingConfig(max_batch=8), device="cpu") as server:
        server.register("vit_top", forward, item_shape=(16, 16, 3), compile=False)
        q = session.sqlStream(VIT_QUERY, JsonlSink(str(tmp_path / "torch.jsonl")),
                              str(tmp_path / "torch_log"), server=server,
                              config=StreamConfig(**config))
        try:
            summary = q.run(idle_timeout_s=2.0)
        finally:
            q.close()
            session.catalog.dropStreamTable("frames")
        served = server.status()["endpoints"]["vit_top"]
    assert summary["stop_reason"] == "source_finished"
    assert served["device"] == "cpu" and not served["compiled"]

    def emitted(path):
        with open(path) as fh:
            rows = [json.loads(line) for line in fh]
        return sorted(((r["window_start"], r["label"]), r) for r in rows)

    got, want = emitted(tmp_path / "torch.jsonl"), emitted(tmp_path / "jax.jsonl")
    # 24 rows 100 ms apart: windows [0, 1s) and [1s, 2s) close, 3 labels each
    assert [k for k, _ in got] == [k for k, _ in want] and len(want) == 6
    for (_, g), (_, w) in zip(got, want):
        assert g["n"] == w["n"]
        np.testing.assert_allclose([g["top"], g["p95"]], [w["top"], w["p95"]], **TOL)
