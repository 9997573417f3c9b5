"""The port's fit profiler (``sparkdl_tpu_torch.obs.hooks``) on the cases of
the JAX package's ``tests/test_obs.py::TestFitProfiler``, and its spans from
a real fit of each of the port's estimators held to the JAX estimators'.

The parity case fits the same tiny ``.keras`` model (Flatten -> Dense over
8x8x3 images, 12 rows, batch 8, 2 epochs, with a checkpoint directory)
through the JAX ``KerasImageFileEstimator`` and the port's, each with its
own package's tracer on, and compares the trees of spans: names, nesting,
the fit span's attributes, the epoch events' keys and epochs, and the
checkpoint spans' epochs. The port's ``TorchImageFileEstimator`` (the Flax
estimator's counterpart) makes the same tree under its own name. Times and
losses are not compared (the two runs are different programs).
"""

import numpy as np
import pytest
import torch

import keras

from sparkdl_tpu.estimators import KerasImageFileEstimator as JaxKerasImageFileEstimator
from sparkdl_tpu.obs import JsonlTraceSink as JaxJsonlTraceSink
from sparkdl_tpu.obs import tracer as jax_tracer
from sparkdl_tpu.sql.session import TPUSession
from sparkdl_tpu_torch import KerasImageFileEstimator, TorchImageFileEstimator
from sparkdl_tpu_torch.obs import FitProfiler, JsonlTraceSink, fit_profiler, tracer
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
def tracing_off_between_tests(monkeypatch):
    monkeypatch.setenv("SPARKDL_COMPILE_CACHE", "off")
    tracer.disable()
    jax_tracer.disable()
    metrics.reset()
    yield
    tracer.disable()
    jax_tracer.disable()
    metrics.reset()


def enabled_sink(capacity=4096):
    sink = JsonlTraceSink(capacity=capacity)
    tracer.enable(sink)
    return sink


# ----------------------------------------------------------------------
# the reference's cases
# ----------------------------------------------------------------------
class TestFitProfiler:
    def test_steps_epochs_checkpoints_metered_and_spanned(self):
        sink = enabled_sink()
        with fit_profiler("TestEstimator", epochs=2, steps_per_epoch=3) as prof:
            assert isinstance(prof, FitProfiler)
            for epoch in range(1, 3):
                for _ in range(3):
                    with prof.step():
                        pass
                prof.epoch(epoch, loss=0.5)
                with prof.checkpoint(epoch=epoch):
                    pass

        snap = metrics.snapshot(prefix="estimator.")
        assert snap["estimator.step_ms.count"] == 6
        assert snap["estimator.steps"] == 6
        assert snap["estimator.checkpoint_ms.count"] == 2
        assert snap["estimator.host_stall_ms.count"] == 2
        assert snap["estimator.step.seconds"] >= 0.0

        fit, = sink.find("estimator.fit")
        assert fit["attributes"]["estimator"] == "TestEstimator"
        assert fit["attributes"]["epochs"] == 2
        epochs = [e for e in fit["events"] if e["name"] == "epoch"]
        assert [e["epoch"] for e in epochs] == [1, 2]
        assert all(e["loss"] == 0.5 for e in epochs)
        assert all("host_stall_ms" in e for e in epochs)
        steps = sink.find("estimator.step")
        assert len(steps) == 6
        assert all(s["parent_id"] == fit["span_id"] for s in steps)
        assert len(sink.find("estimator.checkpoint")) == 2

    def test_epoch_stall_attribution_is_a_delta(self):
        """Pre-fit pipeline stall must not be billed to the fit."""
        enabled_sink()
        metrics.histogram("data.device_stall_ms").observe(500.0)
        with fit_profiler("E") as prof:
            metrics.histogram("data.device_stall_ms").observe(40.0)
            prof.epoch(1)
            prof.epoch(2)  # nothing new since epoch 1
        h = metrics.histogram("estimator.host_stall_ms")
        assert h.count == 2
        assert h.quantile(1.0) == pytest.approx(40.0)
        assert h.quantile(0.0) == pytest.approx(0.0)

    def test_profiler_works_untraced(self):
        with fit_profiler("E") as prof:
            with prof.step():
                pass
            prof.epoch(1)
        assert metrics.histogram("estimator.step_ms").count == 1

    def test_step_runs_sync_and_skips_the_count_of_a_failed_step(self):
        synced = []
        with fit_profiler("E") as prof:
            with prof.step(lambda: synced.append(1)):
                pass
            with pytest.raises(ValueError):
                with prof.step(lambda: synced.append(1)):
                    raise ValueError("step failed")
        assert synced == [1]
        assert metrics.counter("estimator.steps").value == 1
        assert metrics.histogram("estimator.step_ms").count == 2


# ----------------------------------------------------------------------
# a real fit of each estimator
# ----------------------------------------------------------------------
def _loader(uri):
    return np.load(uri)


@pytest.fixture(scope="module")
def bright_rows(tmp_path_factory):
    """12 rows of 8x8x3 images labelled by mean brightness."""
    root = tmp_path_factory.mktemp("bright_rows")
    rng = np.random.default_rng(0)
    rows = []
    for i in range(12):
        low, high = (0.1, 0.7) if i % 2 else (-0.7, -0.1)
        img = rng.uniform(low, high, (8, 8, 3)).astype(np.float32)
        path = str(root / f"img_{i:02d}.npy")
        np.save(path, img)
        rows.append({"uri": path, "label": int(img.mean() > 0)})
    return rows


@pytest.fixture(scope="module")
def tiny_keras_file(tmp_path_factory):
    keras.utils.set_random_seed(0)
    model = keras.Sequential([L.Input((8, 8, 3)), L.Flatten(), L.Dense(2, activation="softmax")])
    path = str(tmp_path_factory.mktemp("tiny") / "tiny.keras")
    model.save(path)
    return path


FIT = {"epochs": 2, "batch_size": 8}


def _keras_args(path, ckpt_dir):
    return dict(inputCol="uri", outputCol="pred", labelCol="label", imageLoader=_loader,
                modelFile=path, kerasOptimizer="adam",
                kerasLoss="sparse_categorical_crossentropy",
                kerasFitParams=FIT, checkpointDir=ckpt_dir)


def _span_tree(spans):
    """The fit's spans as comparable data: (name, parent name) pairs in
    order, the fit's attributes, its epoch events' keys and epochs, and the
    checkpoint spans' epochs."""
    by_id = {s["span_id"]: s for s in spans}
    fit, = [s for s in spans if s["name"] == "estimator.fit"]
    fit_spans = [s for s in spans if s["trace_id"] == fit["trace_id"]]
    edges = sorted((s["name"], by_id[s["parent_id"]]["name"] if s["parent_id"] else None)
                   for s in fit_spans)
    epochs = [e for e in fit["events"] if e["name"] == "epoch"]
    return {
        "edges": edges,
        "fit_attributes": fit["attributes"],
        "epoch_keys": [sorted(e) for e in epochs],
        "epochs": [e["epoch"] for e in epochs],
        "losses_finite": all(np.isfinite(e["loss"]) for e in epochs),
        "checkpoint_epochs": [s["attributes"]["epoch"] for s in fit_spans
                              if s["name"] == "estimator.checkpoint"],
    }


@pytest.fixture(scope="module")
def jax_keras_tree(bright_rows, tiny_keras_file, tmp_path_factory):
    session = TPUSession.builder.master("local[*]").appName("fit-profiler").getOrCreate()
    df = session.createDataFrame(bright_rows, numPartitions=2)
    sink = JaxJsonlTraceSink(capacity=4096)
    jax_tracer.enable(sink)
    try:
        ckpt = str(tmp_path_factory.mktemp("jax_ckpt"))
        JaxKerasImageFileEstimator(**_keras_args(tiny_keras_file, ckpt)).fit(df)
    finally:
        jax_tracer.disable()
    return _span_tree(sink.spans())


def test_keras_fit_spans_match_the_jax_estimators(jax_keras_tree, bright_rows, tiny_keras_file,
                                                  tmp_path):
    sink = enabled_sink()
    df = TorchSession.builder.getOrCreate().createDataFrame(bright_rows, numPartitions=2)
    KerasImageFileEstimator(device="cpu", **_keras_args(tiny_keras_file, str(tmp_path))).fit(df)
    tree = _span_tree(sink.spans())
    assert tree == jax_keras_tree
    assert tree["fit_attributes"] == {"estimator": "KerasImageFileEstimator", "epochs": 2,
                                      "steps_per_epoch": 2}
    assert tree["epochs"] == [1, 2] and tree["checkpoint_epochs"] == [1, 2]
    assert tree["epoch_keys"][0] == ["epoch", "host_stall_ms", "loss", "name", "offset_ms",
                                     "producer_busy_s"]
    assert metrics.counter("estimator.steps").value == 4


def test_torch_estimator_fit_makes_the_same_tree(jax_keras_tree, bright_rows, tmp_path):
    from sparkdl_tpu_torch.models.vit import ViT

    sink = enabled_sink()
    torch.manual_seed(0)
    model = ViT(variant="ViT-Ti/16", num_classes=2, image_size=16)
    rows = [{"uri": r["uri"], "label": r["label"]} for r in bright_rows]
    df = TorchSession.builder.getOrCreate().createDataFrame(rows, numPartitions=2)

    def loader(uri):
        return np.repeat(np.repeat(np.load(uri), 2, axis=0), 2, axis=1)

    est = TorchImageFileEstimator(
        inputCol="uri", outputCol="pred", labelCol="label", imageLoader=loader, module=model,
        loss="sparse_categorical_crossentropy", optimizer="adam",
        fitParams=FIT, checkpointDir=str(tmp_path), device="cpu")
    est.fit(df)
    tree = _span_tree(sink.spans())
    want = dict(jax_keras_tree, fit_attributes={
        "estimator": "TorchImageFileEstimator", "epochs": 2, "steps_per_epoch": 2})
    assert tree == want
