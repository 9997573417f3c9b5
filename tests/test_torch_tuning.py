"""The port's hyperparameter tuning against the JAX package's, on the CPU.

- ``CrossValidator`` over ``LogisticRegression`` on a vector frame, as
  ``tests/test_estimators.py`` and ``tests/test_persistence.py`` build it:
  the same folds (``randomSplit([1.0] * numFolds, seed)``), the same
  ``avgMetrics`` and the same best index as the JAX package's; the save and
  load of ``CrossValidator`` and ``CrossValidatorModel``;
  ``partitionDevices=True``: one card and ``parallelism=2`` refused before
  any fit with the JAX package's uneven-split error; over two explicit CPU
  devices each trial thread is bound to its own slice, with the
  ``avgMetrics`` of ``partitionDevices=False``;
- ``ParamGridBuilder``, ``Estimator.fitMultiple`` driven from threads,
  ``DataFrame.union``, and the model caches' ``LRUCache`` under threads;
- a grid over a ``Pipeline`` stage's param: ``Pipeline.copy`` passes the
  map on to the stages (the JAX package's does not, so a JAX grid over
  ``featurizer.modelName`` leaves the featurizer as it was), and a
  ``CrossValidator`` over ``DeepImageFeaturizer -> LogisticRegression``
  picks a backbone on the CPU.
"""

import threading

import numpy as np
import pytest
import torch

from sparkdl_tpu.ml.classification import LogisticRegression as JaxLR
from sparkdl_tpu.ml.evaluation import MulticlassClassificationEvaluator as JaxEvaluator
from sparkdl_tpu.ml.pipeline import Pipeline as JaxPipeline
from sparkdl_tpu.ml.tuning import CrossValidator as JaxCrossValidator
from sparkdl_tpu.ml.tuning import ParamGridBuilder as JaxParamGridBuilder
from sparkdl_tpu_torch import (
    CrossValidator,
    CrossValidatorModel,
    DeepImageFeaturizer,
    LogisticRegression,
    MulticlassClassificationEvaluator,
    ParamGridBuilder,
    Pipeline,
    PipelineModel,
)
from sparkdl_tpu_torch.image import imageIO
from sparkdl_tpu_torch.ml.classification import LogisticRegressionModel
from sparkdl_tpu_torch.sql.session import TorchSession
from sparkdl_tpu_torch.utils.lru import LRUCache


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _no_compile_cache(monkeypatch):
    monkeypatch.setenv("SPARKDL_COMPILE_CACHE", "off")


def _vector_rows(n=48, seed=0):
    """Two overlapping 4-d classes: accuracy below 1, so the grid's
    metrics differ."""
    rng = np.random.RandomState(seed)
    return [{"features": (rng.randn(4) + (0.8 if i % 2 else -0.8)).astype(np.float32),
             "label": i % 2} for i in range(n)]


@pytest.fixture(scope="module")
def frames(tpu_session):
    rows = _vector_rows()
    return (TorchSession.builder.getOrCreate().createDataFrame(rows, numPartitions=4),
            tpu_session.createDataFrame(rows, numPartitions=4))


def _cv(lr, grid_cls, cv_cls, evaluator_cls, parallelism=2, seed=7):
    grid = grid_cls().addGrid(lr.maxIter, [1, 30]).addGrid(lr.regParam, [0.0, 0.5]).build()
    return cv_cls(estimator=lr, estimatorParamMaps=grid,
                  evaluator=evaluator_cls(metricName="accuracy"), numFolds=3,
                  parallelism=parallelism, seed=seed)


def _port_cv(**kw):
    return _cv(LogisticRegression(maxIter=30, stepSize=0.1, device="cpu"), ParamGridBuilder, CrossValidator,
               MulticlassClassificationEvaluator, **kw)


def _jax_cv(**kw):
    return _cv(JaxLR(maxIter=30, stepSize=0.1), JaxParamGridBuilder, JaxCrossValidator, JaxEvaluator, **kw)


@pytest.mark.parametrize("n_folds,seed", [(2, 7), (3, 7), (3, 11)])
def test_folds_match_jax(frames, n_folds, seed):
    port_df, jax_df = frames
    port = port_df.randomSplit([1.0] * n_folds, seed=seed)
    want = jax_df.randomSplit([1.0] * n_folds, seed=seed)
    for p, w in zip(port, want):
        assert [r["features"].tolist() for r in p.collect()] == \
            [np.asarray(r["features"]).tolist() for r in w.collect()]


def test_cross_validator_matches_jax(frames):
    port_df, jax_df = frames
    got = _port_cv().fit(port_df)
    want = _jax_cv().fit(jax_df)
    assert len(got.avgMetrics) == 4
    assert got.avgMetrics == pytest.approx(want.avgMetrics, abs=1e-12)
    assert len(set(got.avgMetrics)) > 1  # the grid's metrics differ
    best = int(np.argmax(got.avgMetrics))
    assert best == int(np.argmax(want.avgMetrics))
    assert isinstance(got.bestModel, LogisticRegressionModel)
    np.testing.assert_allclose(np.asarray(got.bestModel.weights),
                               np.asarray(want.bestModel.weights), rtol=1e-4, atol=1e-4)
    assert [r["prediction"] for r in got.transform(port_df).collect()] == \
        [r["prediction"] for r in want.transform(jax_df).collect()]


def test_parallelism_gives_the_same_metrics(frames):
    port_df, _ = frames
    assert _port_cv(parallelism=1).fit(port_df).avgMetrics == \
        _port_cv(parallelism=3).fit(port_df).avgMetrics


def test_cross_validator_save_and_load(frames, tmp_path):
    cv = _port_cv()
    path = str(tmp_path / "cv")
    cv.write().overwrite().save(path)
    loaded = CrossValidator.load(path)
    assert loaded.uid == cv.uid
    assert loaded.getOrDefault(loaded.numFolds) == 3
    assert loaded.getOrDefault(loaded.seed) == 7
    assert loaded.getOrDefault(loaded.parallelism) == 2
    est = loaded.getEstimator()
    maps = loaded.getEstimatorParamMaps()
    assert len(maps) == 4 and all(p.parent == est.uid for m in maps for p in m)
    assert sorted(tuple(sorted((p.name, v) for p, v in m.items())) for m in maps) == \
        sorted(tuple(sorted((p.name, v) for p, v in m.items()))
               for m in cv.getEstimatorParamMaps())
    port_df, _ = frames
    assert loaded.fit(port_df).avgMetrics == cv.fit(port_df).avgMetrics


def test_cross_validator_model_save_and_load(frames, tmp_path):
    port_df, _ = frames
    model = _port_cv().fit(port_df)
    path = str(tmp_path / "cv_model")
    model.write().overwrite().save(path)
    loaded = CrossValidatorModel.load(path)
    assert loaded.avgMetrics == model.avgMetrics
    assert isinstance(loaded.bestModel, LogisticRegressionModel)
    assert [r["prediction"] for r in loaded.transform(port_df).collect()] == \
        [r["prediction"] for r in model.transform(port_df).collect()]


def test_partition_devices_is_refused_before_any_fit(frames, monkeypatch):
    # one card does not split into two slices: the JAX package's error,
    # raised before any fit
    from sparkdl_tpu_torch.parallel import trainer

    monkeypatch.setattr(trainer, "local_devices", lambda: [torch.device("cuda", 0)])

    class NoFit(LogisticRegression):
        def _fit(self, dataset):
            raise AssertionError("fitted")

    port_df, _ = frames
    lr = NoFit()
    cv = CrossValidator(estimator=lr, estimatorParamMaps=[{lr.maxIter: 1}],
                        evaluator=MulticlassClassificationEvaluator(), numFolds=2,
                        parallelism=2, partitionDevices=True)
    with pytest.raises(ValueError, match="1 devices do not partition into 2 equal slices"):
        cv.fit(port_df)


def test_partition_devices_binds_each_trial_thread_to_its_slice(frames, monkeypatch):
    from sparkdl_tpu_torch.parallel import trainer

    cpus = [torch.device("cpu"), torch.device("cpu")]
    monkeypatch.setattr(trainer, "local_devices", lambda: list(cpus))
    seen = []

    class Spy(LogisticRegression):
        def _fit(self, dataset):
            seen.append((threading.current_thread() is threading.main_thread(),
                         trainer.current_device_slice()))
            return super()._fit(dataset)

    port_df, _ = frames

    def run(partition):
        cv = _cv(Spy(maxIter=30, stepSize=0.1, device="cpu"), ParamGridBuilder, CrossValidator,
                 MulticlassClassificationEvaluator, parallelism=2)
        cv.setParams(partitionDevices=partition)
        return cv.fit(port_df).avgMetrics

    plain = run(False)
    assert all(slice_ is None for _, slice_ in seen)
    seen.clear()
    assert run(True) == plain
    # every trial in a pool thread trained on a one-card slice; the final
    # refit in the caller's thread is unbound, as in the JAX package
    trials = [slice_ for main, slice_ in seen if not main]
    assert len(trials) == 3 * 4 and all(s == [torch.device("cpu")] for s in trials)
    assert [s for main, s in seen if main] == [None]


def test_param_grid_builder_matches_jax():
    lr, jlr = LogisticRegression(), JaxLR()
    got = (ParamGridBuilder().baseOn({lr.featuresCol: "f"})
           .addGrid(lr.maxIter, [10, 50]).addGrid(lr.regParam, [0.0, 0.1]).build())
    want = (JaxParamGridBuilder().baseOn({jlr.featuresCol: "f"})
            .addGrid(jlr.maxIter, [10, 50]).addGrid(jlr.regParam, [0.0, 0.1]).build())
    assert [sorted((p.name, v) for p, v in m.items()) for m in got] == \
        [sorted((p.name, v) for p, v in m.items()) for m in want]
    pairs = ParamGridBuilder().baseOn((lr.maxIter, 3), (lr.regParam, 0.2)).build()
    assert pairs == [{lr.maxIter: 3, lr.regParam: 0.2}]


def test_fit_multiple_from_threads(frames):
    port_df, _ = frames
    lr = LogisticRegression(maxIter=2, device="cpu")
    maps = [{lr.maxIter: i + 1} for i in range(6)]
    fits = lr.fitMultiple(port_df, maps)
    got, lock = {}, threading.Lock()

    def drain():
        for index, model in fits:
            with lock:
                assert index not in got
                got[index] = model

    threads = [threading.Thread(target=drain) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert sorted(got) == list(range(6))
    # each index's model is its own map's fit, and the estimator is unchanged
    for i, model in enumerate(lr.fit(port_df, maps)):
        np.testing.assert_array_equal(np.asarray(got[i].weights), np.asarray(model.weights))
    assert lr.getOrDefault(lr.maxIter) == 2


def test_union_matches_jax(tpu_session):
    rows = [{"a": i, "b": float(i)} for i in range(5)]
    session = TorchSession.builder.getOrCreate()
    port = session.createDataFrame(rows[:2], numPartitions=1).union(
        session.createDataFrame(rows[2:], numPartitions=2))
    want = tpu_session.createDataFrame(rows[:2], numPartitions=1).union(
        tpu_session.createDataFrame(rows[2:], numPartitions=2))
    assert port.getNumPartitions() == want.getNumPartitions() == 3
    assert [r.asDict() for r in port.collect()] == [r.asDict() for r in want.collect()]
    with pytest.raises(ValueError, match="same columns"):
        port.union(session.createDataFrame([{"b": 1.0, "a": 1}]))


def test_lru_cache_under_threads():
    """Readers and writers on a cache of 4 from 8 threads: ``get`` never
    raises on an entry another thread evicts, and the bound holds."""
    cache = LRUCache(4)
    errors = []

    def hammer(seed):
        rng = np.random.default_rng(seed)
        try:
            for _ in range(3000):
                key = int(rng.integers(12))
                value = cache.get(key)
                if value is None:
                    cache[key] = ("v", key)
                else:
                    assert value == ("v", key)
                assert len(cache) <= 4
        except Exception as exc:  # collected for the main thread's assert
            errors.append(exc)

    threads = [threading.Thread(target=hammer, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert errors == []
    assert len(cache) == 4
    assert cache.get("absent", "default") == "default"


# -- grids over a pipeline stage -----------------------------------------

def test_pipeline_copy_passes_the_map_to_its_stages():
    lr = LogisticRegression(maxIter=5)
    copy = Pipeline(stages=[lr]).copy({lr.maxIter: 77})
    assert copy.getStages()[0].getOrDefault(copy.getStages()[0].maxIter) == 77
    assert lr.getOrDefault(lr.maxIter) == 5
    # the JAX package's Pipeline.copy leaves the stage as it was
    jlr = JaxLR(maxIter=5)
    jcopy = JaxPipeline(stages=[jlr]).copy({jlr.maxIter: 77})
    assert jcopy.getStages()[0].getOrDefault(jcopy.getStages()[0].maxIter) == 5


def _image_frame(n, seed):
    rng = np.random.RandomState(seed)
    rows = []
    for i in range(n):
        bgr = rng.randint(0, 80, (32, 40, 3)).astype(np.uint8)
        bgr[..., 0 if i % 2 else 2] += 120
        rows.append({"image": imageIO.imageArrayToStruct(bgr, origin=f"i{i}"),
                     "label": i % 2})
    return TorchSession.builder.getOrCreate().createDataFrame(rows, numPartitions=2)


def test_cross_validator_over_a_featurizer_picks_a_backbone(tmp_path):
    df = _image_frame(12, seed=1)
    featurizer = DeepImageFeaturizer(inputCol="image", outputCol="features",
                                     modelName="MobileNetV2", modelWeights="random",
                                     computeDtype="float32", batchSize=8, device="cpu")
    lr = LogisticRegression(featuresCol="features", labelCol="label", maxIter=10,
                            device="cpu")
    grid = (ParamGridBuilder().addGrid(featurizer.modelName, ["MobileNetV2", "ResNet50"])
            .addGrid(lr.regParam, [0.0, 0.01]).build())
    cv = CrossValidator(estimator=Pipeline(stages=[featurizer, lr]), estimatorParamMaps=grid,
                        evaluator=MulticlassClassificationEvaluator(metricName="accuracy"),
                        numFolds=2, parallelism=2, seed=7)
    # each param map's model featurizes with the map's backbone
    fitted = dict(cv.getEstimator().fitMultiple(df, grid))
    assert [fitted[i].stages[0].getModelName() for i in range(4)] == \
        ["MobileNetV2", "MobileNetV2", "ResNet50", "ResNet50"]
    assert [len(fitted[i].stages[0].transform(df).collect()[0]["features"].toArray())
            for i in (0, 2)] == [1280, 2048]
    model = cv.fit(df)
    assert len(model.avgMetrics) == 4
    best = int(np.argmax(model.avgMetrics))
    assert model.bestModel.stages[0].getModelName() == grid[best][featurizer.modelName]
    refit = cv.getEstimator().fit(df, grid[best])
    np.testing.assert_array_equal(np.asarray(model.bestModel.stages[1].weights),
                                  np.asarray(refit.stages[1].weights))
    cv.setParams(parallelism=1)
    assert cv.fit(df).avgMetrics == model.avgMetrics
    path = str(tmp_path / "cv_pipeline")
    model.write().overwrite().save(path)
    loaded = CrossValidatorModel.load(path)
    assert isinstance(loaded.bestModel, PipelineModel)
    want = model.transform(df).collect()
    got = loaded.transform(df).collect()
    assert [r["prediction"] for r in got] == [r["prediction"] for r in want]
    assert all(np.array_equal(g["features"].toArray(), w["features"].toArray())
               for g, w in zip(got, want))
