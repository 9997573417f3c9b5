"""The transform loop's input half: the dispatch window
(``engine/executor.py``), the prefetch (``data/prefetch.py``), the trimmed
``Dataset`` and ``run_batched_rows`` / ``run_batched_multi`` on them,
against the JAX package's ``DispatchWindow``, ``PrefetchIterator`` and
``run_batched_rows`` on the CPU.

Outputs are compared byte for byte (``np.array_equal``): the loop moves
rows, it computes nothing, so every depth, the serial mode and the JAX loop
must give the same bytes for the same forward. Threads are counted by name
before and after: no decode thread may outlive a call, whether it ended,
its decode raised or its forward raised. The pinned-buffer reuse on the
card is ``tests/test_torch_cuda_kernels.py::test_pinned_buffers_are_reused_only_after_their_copy``.
"""

import threading
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sparkdl_tpu.data.prefetch import PrefetchIterator as JaxPrefetchIterator
from sparkdl_tpu.engine import DispatchWindow as JaxDispatchWindow
from sparkdl_tpu.engine.executor import dispatch_depth as jax_dispatch_depth
from sparkdl_tpu.transformers import utils as jax_utils
from sparkdl_tpu_torch.data import Dataset, PrefetchIterator
from sparkdl_tpu_torch.engine import DispatchWindow, FetchFailure, dispatch_depth
from sparkdl_tpu_torch.transformers import utils
from sparkdl_tpu_torch.utils.metrics import metrics

MODES = [("SPARKDL_DISPATCH_DEPTH", d) for d in ("0", "1", "2", "3")] + [
    ("SPARKDL_SERIAL_INFERENCE", "1")]
MODE_IDS = ["depth0", "depth1", "depth2", "depth3", "serial"]


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    monkeypatch.delenv("SPARKDL_DISPATCH_DEPTH", raising=False)
    monkeypatch.delenv("SPARKDL_SERIAL_INFERENCE", raising=False)
    monkeypatch.setenv("SPARKDL_COMPILE_CACHE", "off")


def _threads(prefix="sparkdl-"):
    return sorted(t.name for t in threading.enumerate() if t.name.startswith(prefix))


def _decode(chunk):
    """Row i -> a (4, 3) float32 block of i's, then +0.25."""
    return np.stack([np.full((4, 3), r, np.float32) + 0.25 for r in chunk])


def _fn(x):
    return x * 3.0 - 1.0


# -- dispatch_depth and the window ---------------------------------------------

@pytest.mark.parametrize("spec,want", [(None, 2), ("", 2), ("0", 0), ("3", 3), ("-1", 0),
                                       (" 5 ", 5)])
def test_dispatch_depth_reads_the_env_as_jax(monkeypatch, spec, want):
    if spec is not None:
        monkeypatch.setenv("SPARKDL_DISPATCH_DEPTH", spec)
    assert dispatch_depth() == jax_dispatch_depth() == want


@pytest.mark.parametrize("spec", ["x", "1.5"])
def test_dispatch_depth_rejects_a_non_integer(monkeypatch, spec):
    monkeypatch.setenv("SPARKDL_DISPATCH_DEPTH", spec)
    with pytest.raises(ValueError, match="non-negative integer"):
        dispatch_depth()
    with pytest.raises(ValueError, match="non-negative integer"):
        jax_dispatch_depth()


@pytest.mark.parametrize("depth", [0, 1, 2, 3])
def test_window_releases_results_as_jax_does(depth):
    """The same submissions give the same (host, meta) pairs at the same
    calls as the JAX window, ``has_room`` and ``len`` alike, then drain."""
    ours, theirs = DispatchWindow(depth=depth), JaxDispatchWindow(depth=depth)
    for i in range(6):
        value = np.arange(4, dtype=np.float32) + i
        got = ours.submit(torch.from_numpy(value), meta=i)
        want = theirs.submit(jnp.asarray(value), meta=i)
        assert [m for _, m in got] == [m for _, m in want]
        for (g, _), (w, _) in zip(got, want):
            np.testing.assert_array_equal(g, np.asarray(w))
        assert len(ours) == len(theirs) and ours.has_room == theirs.has_room
    assert metrics.gauge("engine.inflight").value == len(ours) == min(depth, 6)
    assert [m for _, m in ours.drain()] == [m for _, m in theirs.drain()]
    assert len(ours) == 0


def test_window_keeps_tuples_and_pop_ready():
    window = DispatchWindow(depth=1)
    assert window.submit((torch.ones(2), torch.zeros(3)), meta="a") == []
    window.depth = 0
    (host, meta), = window.pop_ready()
    assert meta == "a" and isinstance(host, tuple) and [h.shape for h in host] == [(2,), (3,)]


def test_window_captures_a_failed_fetch_in_order():
    """A result whose fetch raises (numpy holds no bfloat16) comes back as
    a FetchFailure with its meta, in order; without capture it raises."""
    window = DispatchWindow(depth=0, capture_errors=True)
    (failure, meta), = window.submit(torch.ones(2, dtype=torch.bfloat16), meta=7)
    assert isinstance(failure, FetchFailure) and meta == 7
    (ok, meta), = window.submit(torch.ones(2), meta=8)
    assert meta == 8 and ok.tolist() == [1.0, 1.0]
    with pytest.raises(TypeError):
        DispatchWindow(depth=0).submit(torch.ones(2, dtype=torch.bfloat16))


def test_abandon_drops_what_is_in_flight():
    window = DispatchWindow(depth=3)
    for i in range(3):
        window.submit(torch.ones(1), meta=i)
    window.abandon()
    assert len(window) == 0 and list(window.drain()) == []
    assert metrics.gauge("engine.inflight").value == 0


# -- PrefetchIterator and Dataset ------------------------------------------------

def test_prefetch_yields_in_order_and_joins():
    before = _threads()
    it = PrefetchIterator(lambda: iter(range(10)), 2, name="sparkdl-test")
    assert list(it) == list(range(10))
    assert _threads() == before


@pytest.mark.parametrize("cls", [PrefetchIterator, JaxPrefetchIterator], ids=["port", "jax"])
def test_consumer_leaving_early_joins_the_producer(cls):
    """A producer blocked on a full queue is cancelled, drained and joined
    by ``close()``; its upstream generator is closed."""
    closed = threading.Event()

    def source():
        try:
            yield from range(1000)
        finally:
            closed.set()

    before = threading.active_count()
    it = cls(source, 2)
    assert next(it) == 0 and next(it) == 1
    time.sleep(0.05)  # the producer now waits on the full queue
    it.close()
    assert closed.is_set() and threading.active_count() == before
    with pytest.raises(StopIteration):
        next(it)


@pytest.mark.parametrize("cls", [PrefetchIterator, JaxPrefetchIterator], ids=["port", "jax"])
def test_producer_error_is_raised_on_the_consumer(cls):
    def source():
        yield 1
        raise KeyError("decode failed")

    before = threading.active_count()
    it = cls(source, 2)
    assert next(it) == 1
    with pytest.raises(KeyError, match="decode failed"):
        next(it)
    assert threading.active_count() == before


def test_prefetch_reports_queue_depth_and_stalls():
    metrics.reset()

    def slow():
        for i in range(3):
            time.sleep(0.02)
            yield i

    assert list(Dataset.from_items([0]).map(lambda _: 0).prefetch(2)) == [0]
    assert list(Dataset(slow, length=3).prefetch(2)) == [0, 1, 2]
    stalls = metrics.histogram("data.device_stall_ms").values()
    assert len(stalls) >= 4 and max(stalls) >= 10.0
    assert "data.queue_depth" in metrics.snapshot("data.")


def test_dataset_is_a_lazy_recipe():
    calls = []
    ds = Dataset.from_items([1, 2, 3]).map(lambda x: calls.append(x) or x * 10)
    assert calls == [] and len(ds) == 3 and "map" in repr(ds)
    assert list(ds) == [10, 20, 30] and list(ds.prefetch(1)) == [10, 20, 30]
    assert calls == [1, 2, 3, 1, 2, 3]
    with pytest.raises(TypeError, match="unsized"):
        len(Dataset(lambda: iter([])))


def test_closing_a_pipeline_mid_stream_joins_its_thread():
    before = _threads()
    it = iter(Dataset.from_items(list(range(50))).map(lambda x: x).prefetch(2, name="sparkdl-x"))
    assert next(it) == 0
    it.close()
    assert _threads() == before


# -- run_batched_rows / run_batched_multi ------------------------------------------

@pytest.mark.parametrize("n,batch", [(37, 8), (8, 8), (3, 8), (1, 1)],
                         ids=["ragged", "one_full", "one_short", "single_row"])
def test_rows_are_identical_at_every_depth_and_serial(monkeypatch, n, batch):
    rows = list(range(n))
    want = _fn(torch.from_numpy(_decode(rows))).numpy()
    for (env, value), mode in zip(MODES, MODE_IDS):
        with monkeypatch.context() as m:
            m.setenv(env, value)
            got = utils.run_batched_rows(_fn, rows, _decode, batch, device="cpu")
        assert got.dtype == want.dtype and got.shape == want.shape, mode
        assert np.array_equal(got, want), mode


def test_rows_match_the_jax_loop(monkeypatch):
    """The same decode and forward through the JAX loop (which pads the
    ragged last chunk and shards over the 8 virtual devices) and the
    port's, at the default depth and in serial mode."""
    rows = list(range(21))
    for serial in ("", "1"):
        monkeypatch.setenv("SPARKDL_SERIAL_INFERENCE", serial)
        want = jax_utils.run_batched_rows(lambda x: x * 3.0 - 1.0, rows, _decode, 8)
        got = utils.run_batched_rows(_fn, rows, _decode, 8, device="cpu")
        assert np.array_equal(got, np.asarray(want))


@pytest.mark.parametrize("mode", range(len(MODES)), ids=MODE_IDS)
def test_multi_outputs_are_identical_at_every_depth(monkeypatch, mode):
    rng = np.random.RandomState(0)
    a, b = rng.randn(13, 3).astype(np.float32), rng.randn(13, 2).astype(np.float32)
    monkeypatch.setenv(*MODES[mode])
    out = utils.run_batched_multi(lambda x, y: (x.sum(1), y * 2, x[:, :1] + y[:, :1]),
                                  [a, b], 4, device="cpu")
    assert len(out) == 3
    assert np.array_equal(out[0], a.sum(1))
    assert np.array_equal(out[1], b * 2)
    assert np.array_equal(out[2], a[:, :1] + b[:, :1])


def test_decode_runs_on_the_prefetch_thread_unless_serial(monkeypatch):
    seen = []

    def decode(chunk):
        seen.append(threading.current_thread().name)
        return _decode(chunk)

    utils.run_batched_rows(_fn, list(range(9)), decode, 4, device="cpu")
    assert set(seen) == {"sparkdl-decode"}
    seen.clear()
    monkeypatch.setenv("SPARKDL_SERIAL_INFERENCE", "on")
    utils.run_batched_rows(_fn, list(range(9)), decode, 4, device="cpu")
    assert set(seen) == {threading.current_thread().name}


@pytest.mark.parametrize("serial", ["", "1"], ids=["prefetch", "serial"])
def test_a_decode_error_is_raised_and_leaves_nothing_behind(monkeypatch, serial):
    monkeypatch.setenv("SPARKDL_SERIAL_INFERENCE", serial)

    def decode(chunk):
        if chunk[0] >= 8:
            raise OSError("unreadable image")
        return _decode(chunk)

    before = _threads()
    with pytest.raises(OSError, match="unreadable image"):
        utils.run_batched_rows(_fn, list(range(30)), decode, 4, device="cpu")
    assert _threads() == before
    assert metrics.gauge("engine.inflight").value == 0


def test_a_forward_error_joins_the_decode_thread():
    """The consumer leaves early (its forward raises on the second chunk)
    while the producer may be blocked on the full queue."""
    calls = []

    def fn(x):
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("forward failed")
        return x

    before = _threads()
    with pytest.raises(RuntimeError, match="forward failed"):
        utils.run_batched_rows(fn, list(range(100)), _decode, 2, device="cpu")
    assert _threads() == before
    assert metrics.gauge("engine.inflight").value == 0


def test_a_misaligned_decode_raises():
    with pytest.raises(ValueError, match="row-aligned"):
        utils.run_batched_rows(_fn, list(range(5)), lambda c: _decode(c)[:1], 4, device="cpu")


def test_timers_keep_their_meaning():
    """``sparkdl.load`` (in the loader's decode), ``sparkdl.forward`` and
    ``sparkdl.serve`` advance; serve covers forward; the rate is reported."""
    metrics.reset()
    decode = utils.make_loader_decode_plan(lambda i: np.full((2, 2, 3), i, np.float32))
    utils.run_batched_rows(_fn, list(range(10)), decode, 4, device="cpu")
    snap = metrics.snapshot("sparkdl.")
    assert snap["sparkdl.load.seconds"] > 0 and snap["sparkdl.forward.seconds"] > 0
    assert snap["sparkdl.serve.seconds"] >= snap["sparkdl.forward.seconds"]
    assert snap["sparkdl.rows_processed"] == 10 and snap["sparkdl.batches_run"] == 3
    assert metrics.images_per_sec() > 0
