"""The port's data pipeline (``sparkdl_tpu_torch.data``) against the JAX
package's (``sparkdl_tpu.data``), on the CPU.

The cases of ``tests/test_data_pipeline.py``, each run through both
packages where the JAX package has the same operator: the same sources and
seeds give the same items and batches bit for bit (``shuffle`` reproduces
the estimators' permutation stream, ``batch`` their cyclic pad), closing a
pipeline mid-stream joins every thread it started, and the ``data.*``
metrics advance. ``prefetch_to_device`` runs on ``device="cpu"`` here (the
side-stream copy runs only on the card, in ``chip_smoke.py`` phase 15): it
yields the tensors a plain placement gives and keeps ``Batch.n_real`` on
the host.
"""

import threading
import time

import numpy as np
import pytest
import torch

from sparkdl_tpu.data import Dataset as JaxDataset
from sparkdl_tpu.estimators.data import StreamingShardLoader as JaxStreamingShardLoader
from sparkdl_tpu.estimators.data import in_memory_epoch_dataset
from sparkdl_tpu.resilience.policy import RetryPolicy as JaxRetryPolicy
from sparkdl_tpu.streaming import QueueSource as JaxQueueSource
from sparkdl_tpu_torch.data import Batch, Dataset, PrefetchIterator, default_device_placer
from sparkdl_tpu_torch.data.device import DevicePlacer
from sparkdl_tpu_torch.estimators.data import StreamingShardLoader, epoch_batches
from sparkdl_tpu_torch.obs.trace import tracer
from sparkdl_tpu_torch.resilience.inject import FaultPlan, active_plan
from sparkdl_tpu_torch.resilience.policy import RetryPolicy
from sparkdl_tpu_torch.streaming import QueueSource
from sparkdl_tpu_torch.utils.metrics import metrics


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _no_compile_cache(monkeypatch):
    monkeypatch.setenv("SPARKDL_COMPILE_CACHE", "off")


def _thread_count():
    # settle: dying threads unwind off the active list
    for _ in range(50):
        time.sleep(0.01)
        stable = threading.active_count()
        time.sleep(0.01)
        if threading.active_count() == stable:
            return stable
    return threading.active_count()


def _plain(item):
    """An item as comparable plain data: a batch as (items, n_real), arrays
    and tensors as numpy arrays, tuples element-wise."""
    if isinstance(item, tuple) and hasattr(item, "n_real"):
        return ("batch", _plain(item.items), int(item.n_real))
    if isinstance(item, torch.Tensor):
        return np.asarray(item.numpy())
    if isinstance(item, (tuple, list)):
        return type(item)(_plain(x) for x in item)
    if isinstance(item, dict):
        return {k: _plain(v) for k, v in item.items()}
    if hasattr(item, "__array__") and not isinstance(item, (int, float, str)):
        return np.asarray(item)
    return item


def _assert_same(got, want):
    got, want = _plain(got), _plain(want)
    if isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    elif isinstance(want, (tuple, list)):
        assert type(got) is type(want) and len(got) == len(want)
        for g, w in zip(got, want):
            _assert_same(g, w)
    elif isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _assert_same(got[k], want[k])
    else:
        assert got == want


def both(build):
    """``build(Dataset)`` through each package; the port's items, asserted
    equal to the JAX package's bit for bit."""
    want = list(build(JaxDataset))
    got = list(build(Dataset))
    _assert_same(got, want)
    return got


# ----------------------------------------------------------------------
# sources
# ----------------------------------------------------------------------
def test_from_uris_is_lazy_and_reiterable():
    uris = [f"file:///img_{i}.png" for i in range(5)]
    ds = Dataset.from_uris(uris)
    assert len(ds) == len(JaxDataset.from_uris(uris)) == 5
    assert list(ds) == list(ds)
    both(lambda D: D.from_uris(uris))


def test_from_arrays_rows_and_tuples():
    x = np.arange(6).reshape(3, 2)
    y = np.array([10, 11, 12])
    rows = both(lambda D: D.from_arrays(x))
    assert len(rows) == 3 and np.array_equal(rows[1], [2, 3])
    pairs = both(lambda D: D.from_arrays(x, y))
    assert np.array_equal(pairs[2][0], [4, 5]) and pairs[2][1] == 12


def test_from_arrays_rejects_misaligned():
    for D in (JaxDataset, Dataset):
        with pytest.raises(ValueError, match="aligned"):
            D.from_arrays(np.zeros(3), np.zeros(4))
        with pytest.raises(ValueError, match="at least one"):
            D.from_arrays()


def test_from_dataframe_columns():
    from sparkdl_tpu.sql.session import TPUSession
    from sparkdl_tpu_torch.sql.session import TorchSession

    rows = [("a.png", 0), ("b.png", 1), ("c.png", 2)]
    jax_df = TPUSession.builder.getOrCreate().createDataFrame(rows, ["uri", "label"])
    df = TorchSession.builder.getOrCreate().createDataFrame(
        [{"uri": u, "label": k} for u, k in rows])
    ds = Dataset.from_dataframe(df, "uri", "label")
    assert len(ds) == 3
    assert list(ds) == list(JaxDataset.from_dataframe(jax_df, "uri", "label")) == rows
    assert list(Dataset.from_dataframe(df, "label")) == \
        list(JaxDataset.from_dataframe(jax_df, "label")) == [0, 1, 2]
    assert [r["uri"] for r in Dataset.from_dataframe(df)] == ["a.png", "b.png", "c.png"]


def test_from_files_reads_lazily_and_retries_transient_errors(tmp_path):
    paths = []
    for i in range(4):
        path = tmp_path / f"f{i}.npy"
        np.save(path, np.full((2, 3), i, np.float32))
        paths.append(str(path))
    got = both(lambda D: D.from_files(paths))
    assert [p for p, _ in got] == paths
    # a transient read error (the data.source site) heals on retry, in order
    plan = FaultPlan().add("data.source", error="transient", at=2)
    with active_plan(plan):
        retried = list(Dataset.from_files(paths, retry=RetryPolicy(base_delay_s=0.0)))
    jax_retried = list(JaxDataset.from_files(paths, retry=JaxRetryPolicy(base_delay_s=0.0)))
    assert plan.count("data.source") == 5
    _assert_same(retried, jax_retried)
    # a missing file is permanent: no retry
    with pytest.raises(FileNotFoundError):
        list(Dataset.from_files([str(tmp_path / "missing.npy")],
                                retry=RetryPolicy(base_delay_s=0.0)))


# ----------------------------------------------------------------------
# map
# ----------------------------------------------------------------------
def test_map_threaded_preserves_order():
    def slow_when_even(i):
        time.sleep(0.02 if i % 2 == 0 else 0.0)
        return i * i

    got = both(lambda D: D.from_items(list(range(16))).map(slow_when_even, num_workers=4))
    assert got == [i * i for i in range(16)]


def test_map_threaded_shuts_pool_down():
    before = _thread_count()
    it = iter(Dataset.from_items(list(range(64))).map(lambda i: i, num_workers=4))
    next(it)
    it.close()
    assert _thread_count() <= before


def test_map_propagates_errors():
    def boom(i):
        if i == 3:
            raise RuntimeError("decode failed")
        return i

    for workers in (0, 2):
        with pytest.raises(RuntimeError, match="decode failed"):
            list(Dataset.from_items(list(range(8))).map(boom, num_workers=workers))


def test_map_workers_reenter_the_consumers_span():
    spans = []
    tracer.enable(sink=spans.append)
    try:
        with tracer.span("consumer") as root:
            def traced(i):
                with tracer.span("item", i=i):
                    return i

            assert list(Dataset.from_items(list(range(6))).map(traced, num_workers=3)) == \
                list(range(6))
    finally:
        tracer.disable()
    items = [s for s in spans if s["name"] == "item"]
    assert len(items) == 6
    assert {s["parent_id"] for s in items} == {root.span_id}
    assert {s["trace_id"] for s in items} == {root.trace_id}


# ----------------------------------------------------------------------
# shuffle: the estimators' permutation stream
# ----------------------------------------------------------------------
def test_shuffle_reproduces_estimator_rng_stream():
    seed, n = 1234, 11
    ds = Dataset.from_arrays(np.arange(n)).shuffle(seed)
    jax_ds = JaxDataset.from_arrays(np.arange(n)).shuffle(seed)
    rng = np.random.RandomState(seed % 2**32)
    for _ in range(3):  # three epochs, three consecutive draws
        expect = [int(v) for v in rng.permutation(n)]
        assert [int(v) for v in ds] == [int(v) for v in jax_ds] == expect


@pytest.mark.parametrize("seed", [0, 7, 2**33 + 5])
@pytest.mark.parametrize("index,count", [(0, 1), (1, 3)])
def test_the_whole_chain_equals_the_jax_chain_over_two_epochs(seed, index, count):
    """``from_arrays -> shuffle(seed) -> shard -> batch(cyclic, min_batches)``
    gives the JAX chain's batches bit for bit, epoch after epoch."""
    order = np.arange(23, dtype=np.int64)
    labels = (order * 3).astype(np.int32)

    def chain(D):
        return (D.from_arrays(order, labels).shuffle(seed).shard(index=index, count=count)
                .batch(4, pad="cyclic", min_batches=9))

    ds, jax_ds = chain(Dataset), chain(JaxDataset)
    assert len(ds) == len(jax_ds)
    for _ in range(2):
        got, want = list(ds), list(jax_ds)
        assert len(got) == len(want) == 9
        _assert_same(got, want)


# ----------------------------------------------------------------------
# shard
# ----------------------------------------------------------------------
def test_shard_strided_split_partitions_everything():
    items = list(range(10))
    shards = [both(lambda D, i=i: D.from_items(items).shard(index=i, count=3))
              for i in range(3)]
    assert shards == [[0, 3, 6, 9], [1, 4, 7], [2, 5, 8]]
    assert len(Dataset.from_items(items).shard(index=1, count=3)) == 3


def test_shard_default_is_identity_when_single_process():
    assert both(lambda D: D.from_items([1, 2, 3]).shard()) == [1, 2, 3]


def test_shard_rejects_bad_index():
    with pytest.raises(ValueError, match="outside"):
        list(Dataset.from_items([1]).shard(index=3, count=2))


# ----------------------------------------------------------------------
# batch: cyclic pad identical to the estimators'
# ----------------------------------------------------------------------
def test_batch_cyclic_pad_matches_estimator_policy():
    order = np.random.RandomState(0).permutation(7)
    got = both(lambda D: D.from_arrays(order).batch(3, pad="cyclic"))
    assert [b.n_real for b in got] == [3, 3, 1]
    assert np.array_equal(got[-1].items, np.concatenate([order[6:], np.resize(order, 2)]))


def test_batch_min_batches_emits_all_pad_batches():
    order = np.arange(3)
    got = both(lambda D: D.from_arrays(order).batch(2, pad="cyclic", min_batches=4))
    assert [b.n_real for b in got] == [2, 1, 0, 0]
    assert np.array_equal(got[2].items, np.resize(order, 2))


def test_batch_without_pad_keeps_ragged_tail():
    got = both(lambda D: D.from_items([1, 2, 3]).batch(2))
    assert got[-1].n_real == 1 and list(got[-1].items) == [3]


def test_batch_refuses_what_the_jax_batch_refuses():
    for D in (JaxDataset, Dataset):
        for kwargs, match in (({"pad": "zeros"}, "pad must be"),
                              ({"min_batches": 2}, "requires pad"),
                              ({"pad": "cyclic", "drop_remainder": True}, "mutually")):
            with pytest.raises(ValueError, match=match):
                D.from_items([1, 2]).batch(2, **kwargs)
        with pytest.raises(ValueError, match=">= 1"):
            D.from_items([1]).batch(0)
        with pytest.raises(ValueError, match="empty stream"):
            list(D.from_items([]).batch(2, pad="cyclic", min_batches=1))


# ----------------------------------------------------------------------
# from_stream: an unbounded source, windowed
# ----------------------------------------------------------------------
def test_from_stream_with_max_records_equals_the_jax_view():
    values = [np.full((2,), i, np.float32) for i in range(10)]
    jax_src, src = JaxQueueSource(), QueueSource()
    for s in (jax_src, src):
        s.put_all(values)  # not ended: the window bounds the read
    got = list(Dataset.from_stream(src, poll_batch=3, max_records=7).batch(3))
    want = list(JaxDataset.from_stream(jax_src, poll_batch=3, max_records=7).batch(3))
    _assert_same(got, want)
    assert [b.n_real for b in got] == [3, 3, 1]
    assert Dataset.from_stream(src).unbounded
    assert not Dataset.from_stream(src, max_records=3).unbounded


# ----------------------------------------------------------------------
# prefetch: thread hygiene
# ----------------------------------------------------------------------
def test_prefetch_yields_everything_in_order():
    assert both(lambda D: D.from_items(list(range(20))).prefetch(3)) == list(range(20))


def test_prefetch_early_close_joins_producer_thread():
    before = _thread_count()
    it = iter(Dataset.from_items(list(range(1000))).prefetch(2))
    assert next(it) == 0
    it.close()
    assert _thread_count() <= before


def test_prefetch_propagates_producer_error_and_joins():
    def explode(i):
        if i == 5:
            raise ValueError("bad row")
        return i

    before = _thread_count()
    with pytest.raises(ValueError, match="bad row"):
        list(Dataset.from_items(list(range(10))).map(explode).prefetch(2))
    assert _thread_count() <= before


def test_prefetch_iterator_close_is_idempotent():
    it = PrefetchIterator(lambda: iter(range(100)), size=2)
    next(it)
    it.close()
    it.close()
    with pytest.raises(StopIteration):
        next(it)


def test_prefetch_closes_upstream_pools():
    before = _thread_count()
    it = iter(Dataset.from_items(list(range(500))).map(lambda i: i + 1, num_workers=4)
              .prefetch(2))
    next(it)
    it.close()
    assert _thread_count() <= before


def test_closing_mid_stream_joins_every_thread_of_the_chain(tmp_path):
    """Files, a threaded map, a batch, a prefetch and the device stage:
    closing the iterator after one batch leaves no thread behind."""
    paths = []
    for i in range(40):
        path = tmp_path / f"img_{i}.npy"
        np.save(path, np.full((4, 4, 3), i, np.float32))
        paths.append(str(path))
    before = _thread_count()
    it = iter(Dataset.from_files(paths).map(lambda pb: np.load(pb[0]), num_workers=4)
              .batch(4, pad="cyclic").prefetch(2).prefetch_to_device(device="cpu"))
    first = next(it)
    assert first.n_real == 4 and tuple(first.items.shape) == (4, 4, 4, 3)
    it.close()
    assert _thread_count() <= before
    assert not [t for t in threading.enumerate()
                if t.name.startswith(("sparkdl-data-map", "sparkdl-prefetch"))]


# ----------------------------------------------------------------------
# prefetch_to_device
# ----------------------------------------------------------------------
def test_prefetch_to_device_places_and_preserves_values():
    x = np.arange(12, dtype=np.float32).reshape(6, 2)
    out = list(Dataset.from_arrays(x).batch(2).prefetch_to_device(device="cpu"))
    want = list(JaxDataset.from_arrays(x).batch(2).prefetch_to_device())
    assert len(out) == 3 and all(isinstance(b, Batch) for b in out)
    assert isinstance(out[0].items, torch.Tensor)
    _assert_same(out, want)


def test_prefetch_to_device_equals_a_plain_placement_and_keeps_n_real_on_the_host():
    rng = np.random.default_rng(0)
    x = rng.random((7, 3, 2), dtype=np.float32)
    y = np.arange(7, dtype=np.int32)
    batches = list(Dataset.from_arrays(x, y).map(lambda r: {"x": r[0], "y": r[1]})
                   .batch(3, pad="cyclic"))
    placed = list(Dataset.from_arrays(x, y).map(lambda r: {"x": r[0], "y": r[1]})
                  .batch(3, pad="cyclic").prefetch_to_device(device="cpu"))
    assert len(placed) == len(batches) == 3
    for p, b in zip(placed, batches):
        assert type(p.n_real) is int and p.n_real == b.n_real
        for row_p, row_b in zip(p.items, b.items):
            for key in ("x", "y"):
                plain = torch.as_tensor(row_b[key]).to("cpu")
                assert isinstance(row_p[key], torch.Tensor)
                assert row_p[key].dtype == plain.dtype and row_p[key].device == plain.device
                torch.testing.assert_close(row_p[key], plain, rtol=0, atol=0)


def test_prefetch_to_device_counts_real_rows():
    metrics.reset()
    x = np.arange(10, dtype=np.float32).reshape(5, 2)
    list(Dataset.from_arrays(x).batch(2, pad="cyclic").prefetch_to_device(device="cpu"))
    assert metrics.counter("data.rows_out").value == 5  # the pad row is not counted


def test_prefetch_to_device_custom_placer():
    seen = []

    def spy(batch):
        seen.append(batch)
        return batch

    assert list(Dataset.from_items([1, 2, 3]).prefetch_to_device(place=spy)) == [1, 2, 3]
    assert seen == [1, 2, 3]


def test_the_device_placer_takes_the_card_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        default_device_placer()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        next(iter(Dataset.from_items([np.zeros(2)]).prefetch_to_device()))
    # the mesh branch: several cards are placed by the ranks of a process
    # group, each its own rows; without a group of as many ranks it raises
    with pytest.raises(ValueError, match="process group of 2"):
        default_device_placer(["cuda:0", "cuda:1"])
    from sparkdl_tpu_torch.parallel import runner

    runner.initialize(device="cpu")
    try:
        mesh_placer = default_device_placer(mesh=runner.make_global_mesh())
        assert mesh_placer.shard == (0, 1)
        placed = mesh_placer({"x": np.arange(6, dtype=np.float32).reshape(3, 2)})
        np.testing.assert_array_equal(placed["x"].numpy(), np.arange(6).reshape(3, 2))
    finally:
        runner.shutdown()
    placer = default_device_placer(["cpu"])
    assert isinstance(placer, DevicePlacer) and placer.device == torch.device("cpu")
    # strings pass through; numbers become tensors
    out = placer({"uri": "a.png", "x": np.ones(2, np.float32), "k": 3})
    assert out["uri"] == "a.png" and isinstance(out["x"], torch.Tensor)
    assert isinstance(out["k"], torch.Tensor) and int(out["k"]) == 3


# ----------------------------------------------------------------------
# metrics
# ----------------------------------------------------------------------
def test_pipeline_advances_data_metrics():
    metrics.reset()
    list(Dataset.from_items(list(range(8))).map(lambda i: np.full((2,), i, np.float32))
         .prefetch(2))
    snap = metrics.snapshot()
    assert snap.get("data.device_stall_ms.count", 0) > 0
    assert metrics.timer("data.producer_busy").entries > 0


# ----------------------------------------------------------------------
# the streaming loader on the pipeline
# ----------------------------------------------------------------------
def _loader_for(values):
    return lambda uri: np.full((2, 2), values[uri], np.float32)


def test_streaming_loader_epoch_matches_plan():
    uris = [f"u{i}" for i in range(5)]
    values = {u: float(i) for i, u in enumerate(uris)}
    y = np.arange(5, dtype=np.int32)
    order = np.random.RandomState(3).permutation(5)
    got = list(StreamingShardLoader(uris, y, _loader_for(values), 2, True).epoch(order))
    want = list(JaxStreamingShardLoader(uris, y, _loader_for(values), local_bs=2,
                                        weighted=True).epoch(order, steps=3))
    assert len(got) == 3
    _assert_same(got, want)
    assert got[-1]["w"].tolist() == [1.0, 0.0]
    assert np.array_equal(got[-1]["y"], y[np.concatenate([order[4:], np.resize(order, 1)])])


def test_streaming_loader_early_close_leaks_no_threads():
    uris = [f"u{i}" for i in range(64)]
    values = {u: float(i) for i, u in enumerate(uris)}
    loader = StreamingShardLoader(uris, np.arange(64, dtype=np.int32), _loader_for(values),
                                  4, False)
    before = _thread_count()
    gen = loader.epoch(np.arange(64))
    next(gen)
    gen.close()
    assert _thread_count() <= before


def test_in_memory_epoch_dataset_matches_hand_loop():
    x = np.arange(14, dtype=np.float32).reshape(7, 2)
    y = np.arange(7, dtype=np.int32)
    order = np.random.RandomState(1).permutation(7)
    got = list(epoch_batches(order, x, y, 3))
    want = list(in_memory_epoch_dataset(order, x, y, 3, 3, True))
    _assert_same(got, want)
    for step_i in range(3):
        idx = order[step_i * 3:(step_i + 1) * 3]
        k = len(idx)
        if k < 3:
            idx = np.concatenate([idx, np.resize(order, 3 - k)])
        assert np.array_equal(got[step_i]["x"], x[idx])
        assert got[step_i]["w"].tolist() == [1.0] * k + [0.0] * (3 - k)
