"""The port's streaming loader against the JAX package's batch composition,
on the CPU.

``StreamingShardLoader.epoch`` must give the batches of the in-memory path
(``epoch_batches``, itself held to the JAX package's
``in_memory_epoch_dataset``): the same rows in the same order, the same
cyclic padding and the same zero-weight pad rows. A streaming Keras fit
equals the in-memory fit bit for bit (the JAX package's
``test_streaming_fit_identical_to_in_memory``).
"""

import threading
import time

import keras
import numpy as np
import pytest
import torch

from sparkdl_tpu.estimators.data import (
    StreamingShardLoader as JaxStreamingShardLoader,
)
from sparkdl_tpu.estimators.data import in_memory_epoch_dataset
from sparkdl_tpu_torch import KerasImageFileEstimator
from sparkdl_tpu_torch.estimators import data
from sparkdl_tpu_torch.estimators.data import (
    PREFETCH,
    StreamingShardLoader,
    collect_host_shard_rows,
    epoch_batches,
)
from sparkdl_tpu_torch.models.keras_model import read_keras_file
from sparkdl_tpu_torch.sql.session import TorchSession
from sparkdl_tpu_torch.utils.metrics import metrics

L = keras.layers


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _no_compile_cache(monkeypatch):
    monkeypatch.setenv("SPARKDL_COMPILE_CACHE", "off")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """30 rows of 4x4x3 images whose pixels hold their row number."""
    root = tmp_path_factory.mktemp("stream_rows")
    uris = []
    for i in range(30):
        path = str(root / f"img_{i:02d}.npy")
        np.save(path, np.full((4, 4, 3), i, np.float32))
        uris.append(path)
    return uris


def _live_stream_threads():
    return [t for t in threading.enumerate() if t.name == "sparkdl-stream"]


@pytest.mark.parametrize("n,bs", [(30, 8), (30, 6), (5, 8), (2, 7), (1, 1), (13, 4)])
@pytest.mark.parametrize("weighted", [True, False])
def test_epochs_match_the_in_memory_batches(files, n, bs, weighted):
    uris = files[:n]
    x = np.stack([np.load(u) for u in uris])
    y = np.arange(n, dtype=np.int32) * 10
    loader = StreamingShardLoader(uris, y, np.load, bs, weighted)
    rng = np.random.RandomState(3)
    steps = -(-n // bs)
    for _ in range(2):
        order = rng.permutation(n)
        got = list(loader.epoch(order))
        want = list(epoch_batches(order, x, y, bs, weighted))
        jax_want = list(in_memory_epoch_dataset(order, x, y, bs, steps, weighted))
        assert len(got) == len(want) == len(jax_want) == steps
        for g, w, j in zip(got, want, jax_want):
            assert set(g) == set(w) == set(j)
            for key in g:
                assert g[key].dtype == w[key].dtype, key
                np.testing.assert_array_equal(g[key], w[key])
                np.testing.assert_array_equal(g[key], j[key])
    assert _live_stream_threads() == []


def test_epochs_match_the_jax_streaming_loader(files):
    y = np.arange(30, dtype=np.int32)
    order = np.random.RandomState(1).permutation(30)
    got = list(StreamingShardLoader(files, y, np.load, 8, True).epoch(order))
    want = list(JaxStreamingShardLoader(files, y, np.load, 8, True).epoch(order, 4))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        for key in ("x", "y", "w"):
            np.testing.assert_array_equal(g[key], w[key])


def test_many_epochs_under_a_short_switch_interval(files):
    """The producer and the consumer hand batches over under frequent
    thread switches, epoch after epoch, abandoned or not: every batch
    arrives whole and in order, and no producer is left running."""
    import sys

    y = np.arange(30, dtype=np.int32)
    x = np.stack([np.load(u) for u in files])
    loader = StreamingShardLoader(files, y, np.load, 4, True)
    rng = np.random.RandomState(9)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for epoch in range(20):
            order = rng.permutation(30)
            want = list(epoch_batches(order, x, y, 4))
            stream = loader.epoch(order)
            got = [b for _, b in zip(range(3 if epoch % 3 == 0 else 8), stream)]
            stream.close()
            for g, w in zip(got, want):
                for key in ("x", "y", "w"):
                    np.testing.assert_array_equal(g[key], w[key])
    finally:
        sys.setswitchinterval(interval)
    assert _live_stream_threads() == []


def test_an_abandoned_epoch_leaves_no_live_thread(files):
    loads = []

    def slow(uri):
        loads.append(uri)
        time.sleep(0.01)
        return np.load(uri)

    loader = StreamingShardLoader(files, np.zeros(30, np.int32), slow, 2, True)
    epoch = loader.epoch(np.arange(30))
    next(epoch)
    assert len(_live_stream_threads()) == 1
    epoch.close()
    assert _live_stream_threads() == []
    # the producer stopped: at most the batches in flight were loaded (the
    # one taken, PREFETCH queued, one being loaded)
    assert len(loads) <= 2 * (1 + PREFETCH + 1)


def test_a_short_producer_raises(files, monkeypatch):
    loader = StreamingShardLoader(files[:8], np.zeros(8, np.int32), np.load, 4, True)
    full = StreamingShardLoader.dataset

    def first_batch_only(self, order, steps):
        it = iter(full(self, order, steps))
        try:
            first = [next(it)]
        finally:
            it.close()
        return data.Dataset.from_items(first).map(lambda batch: batch)

    monkeypatch.setattr(StreamingShardLoader, "dataset", first_batch_only)
    with pytest.raises(RuntimeError, match="produced 1/2 batches"):
        list(loader.epoch(np.arange(8)))
    assert _live_stream_threads() == []


def test_a_loader_error_is_raised_at_its_batch(files):
    def broken(uri):
        if uri.endswith("img_05.npy"):
            raise OSError("unreadable image")
        return np.load(uri)

    loader = StreamingShardLoader(files[:8], np.zeros(8, np.int32), broken, 4, True)
    epoch = loader.epoch(np.arange(8))
    assert next(epoch)["x"].shape == (4, 4, 4, 3)
    with pytest.raises(OSError, match="unreadable image"):
        next(epoch)
    assert _live_stream_threads() == []


def test_loads_are_timed(files):
    metrics.reset()
    loader = StreamingShardLoader(files[:8], np.zeros(8, np.int32), np.load, 4, False)
    batches = list(loader.epoch(np.arange(8)))
    assert len(batches) == 2 and "w" not in batches[0]
    assert metrics.timer("sparkdl.load").seconds > 0
    assert metrics.timer("sparkdl.load_wait").seconds > 0


def test_collect_host_shard_rows_keeps_only_uris(files):
    session = TorchSession.builder.getOrCreate()
    df = session.createDataFrame(
        [{"uri": u, "label": i % 3, "extra": "x"} for i, u in enumerate(files[:5])],
        numPartitions=2)
    uris, labels = collect_host_shard_rows(df, "uri", "label")
    assert uris == files[:5] and labels == [0, 1, 2, 0, 1]
    with pytest.raises(ValueError, match="empty dataset"):
        collect_host_shard_rows(session.createDataFrame([{"uri": "a", "label": 0}])
                                .filter(lambda r: False), "uri", "label")


# -- the streaming fit ------------------------------------------------------------

@pytest.fixture(scope="module")
def bright(tmp_path_factory):
    """12 8x8x3 images labelled by brightness, and a Flatten -> Dense model."""
    root = tmp_path_factory.mktemp("bright")
    rng = np.random.default_rng(0)
    rows = []
    for i in range(12):
        low, high = (0.1, 0.7) if i % 2 else (-0.7, -0.1)
        img = rng.uniform(low, high, (8, 8, 3)).astype(np.float32)
        path = str(root / f"img_{i:02d}.npy")
        np.save(path, img)
        rows.append({"uri": path, "label": int(img.mean() > 0)})
    keras.utils.set_random_seed(0)
    model = keras.Sequential([L.Input((8, 8, 3)), L.Flatten(), L.Dense(8, activation="relu"),
                              L.Dropout(0.3), L.Dense(2, activation="softmax")])
    path = str(root / "tiny.keras")
    model.save(path)
    return rows, path


@pytest.mark.parametrize("loss", ["sparse_categorical_crossentropy", "custom"])
def test_a_streaming_fit_equals_the_in_memory_fit(bright, loss):
    """3 epochs at batch 5 over 12 rows (a ragged last batch), seed 3, with
    Dropout: the tuned files' weights bit for bit."""
    rows, path = bright
    df = TorchSession.builder.getOrCreate().createDataFrame(rows, numPartitions=2)
    kloss = "sparse_categorical_crossentropy" if loss != "custom" else \
        (lambda y, p: -torch.log(p.clamp(1e-7, 1)).gather(1, y.long()[:, None]).mean())

    def fit(streaming):
        est = KerasImageFileEstimator(
            inputCol="uri", outputCol="pred", labelCol="label", imageLoader=np.load,
            modelFile=path, kerasOptimizer="adam", kerasLoss=kloss,
            kerasFitParams={"epochs": 3, "batch_size": 5, "learning_rate": 0.05, "seed": 3,
                            "streaming": streaming},
            device="cpu")
        fitted = est.fit(df)
        return fitted._training_losses, read_keras_file(fitted.getModelFile())[1]

    (got_losses, got), (want_losses, want) = fit(True), fit(False)
    assert got_losses == want_losses and len(got_losses) == 9
    assert set(got) == set(want)
    for name in want:
        for a, b in zip(got[name], want[name]):
            np.testing.assert_array_equal(a, b)
    assert _live_stream_threads() == []
