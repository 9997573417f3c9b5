"""The port's transfer-learning pipeline against the JAX package's, on the
CPU: ``LogisticRegression``, ``randomSplit``, the evaluator, persistence,
and the twin of ``examples/transfer_learning.py``.

The twin makes 20 red- or blue-dominant 96x96 images as the example's
``make_dataset`` does (a fifth of them 60x80, so one partition mixes sizes),
splits them with ``randomSplit([0.75, 0.25], seed=7)`` (16 train, 4 test:
with 16 images this seed leaves one test row), and runs
``DeepImageFeaturizer(InceptionV3, float32) -> LogisticRegression(maxIter=30)``
in both packages on the same Flax tree.

Tolerances:
- LR on one feature matrix: weights and probabilities ``rtol=atol=1e-4``;
  30 adam steps of the two optimizers' float32 arithmetic differ by 2e-5
  (measured) on weights of unit order;
- the twin's LR weights within 1e-3 of their norm: the features differ by
  ~1e-6, and adam turns such noise in near-zero gradients into weight moves
  of up to ``stepSize`` (measured 1.2e-4 at most, 1e-4 of the norm).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sparkdl_tpu import DeepImageFeaturizer as JaxFeaturizer
from sparkdl_tpu.image import imageIO as jax_imageIO
from sparkdl_tpu.ml.classification import LogisticRegression as JaxLR
from sparkdl_tpu.ml.classification import _training_program
from sparkdl_tpu.ml.evaluation import MulticlassClassificationEvaluator as JaxEvaluator
from sparkdl_tpu.ml.pipeline import Pipeline as JaxPipeline
from sparkdl_tpu_torch import (
    DeepImageFeaturizer,
    LogisticRegression,
    MulticlassClassificationEvaluator,
    Pipeline,
    PipelineModel,
)
from sparkdl_tpu_torch.image import imageIO
from sparkdl_tpu_torch.ml.classification import (
    LogisticRegressionModel,
    train_logistic_regression,
)
from sparkdl_tpu_torch.ml.linalg import DenseVector
from sparkdl_tpu_torch.ml.util import load_stage
from sparkdl_tpu_torch.sql.session import TorchSession
from test_torch_inception import flax_inception_tree

LR_TOL = dict(rtol=1e-4, atol=1e-4)
TWIN_LR_NORM_RTOL = 1e-3
FEATURE_TOL = dict(rtol=1e-4, atol=1e-4)
N_TWIN = 20


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _no_compile_cache(monkeypatch):
    monkeypatch.setenv("SPARKDL_COMPILE_CACHE", "off")


def _session():
    return TorchSession.builder.getOrCreate()


def _feature_rows(n, d, k, seed, module):
    rng = np.random.default_rng(seed)
    x = np.maximum(rng.standard_normal((n, d)), 0) * 0.5
    return [{"features": module(x[i]), "label": i % k} for i in range(n)]


# -- LogisticRegression ---------------------------------------------------

@pytest.mark.parametrize("n,d,k,reg", [(16, 2048, 2, 0.0), (40, 64, 3, 0.01)],
                         ids=["two_classes", "three_classes_l2"])
def test_logistic_regression_matches_jax(tpu_session, n, d, k, reg):
    from sparkdl_tpu.ml.linalg import DenseVector as JaxVector

    args = dict(maxIter=30, regParam=reg)
    jax_model = JaxLR(**args).fit(
        tpu_session.createDataFrame(_feature_rows(n, d, k, 0, JaxVector), numPartitions=2)
    )
    df = _session().createDataFrame(_feature_rows(n, d, k, 0, DenseVector), numPartitions=2)
    model = LogisticRegression(**args, device="cpu").fit(df)
    assert model.numClasses == k and model.weights.shape == (d, k)
    np.testing.assert_allclose(model.weights, jax_model.weights, **LR_TOL)
    np.testing.assert_allclose(model.bias, jax_model.bias, **LR_TOL)
    jax_df = tpu_session.createDataFrame(_feature_rows(n, d, k, 1, JaxVector))
    want = jax_model.transform(jax_df).collect()
    got = model.transform(_session().createDataFrame(_feature_rows(n, d, k, 1, DenseVector))
                          ).collect()
    np.testing.assert_allclose(
        np.stack([r["probability"].toArray() for r in got]),
        np.stack([r["probability"].toArray() for r in want]), **LR_TOL)
    assert [r["prediction"] for r in got] == [r["prediction"] for r in want]
    assert all(isinstance(r["prediction"], float) for r in got)


def test_train_logistic_regression_matches_optax():
    """Signed features, four classes, L2. The labels are drawn, not
    balanced: with balanced labels the bias's gradient at the zero start is
    zero in exact arithmetic, and adam's first step moves each bias by
    ``stepSize`` on the sign of each package's float noise (both right,
    0.1 apart), as a uniform start does in any adam fit."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((24, 10)).astype(np.float32)
    y = rng.integers(0, 4, 24).astype(np.int32)
    assert len(set(np.bincount(y))) > 1
    train, tx = _training_program(12, 0.05, 0.1)
    p = {"w": jnp.zeros((10, 4)), "b": jnp.zeros((4,))}
    p = train(p, tx.init(p), jnp.asarray(x), jnp.asarray(y))
    w, b = train_logistic_regression(torch.from_numpy(x), torch.from_numpy(y).long(),
                                     4, 12, 0.05, 0.1)
    np.testing.assert_allclose(w.numpy(), np.asarray(p["w"]), **LR_TOL)
    np.testing.assert_allclose(b.numpy(), np.asarray(p["b"]), **LR_TOL)


def test_logistic_regression_refuses_an_empty_dataset():
    df = _session().createDataFrame(_feature_rows(2, 3, 2, 0, DenseVector))
    empty = df.randomSplit([1.0, 0.0], seed=0)[1]
    with pytest.raises(ValueError, match="empty dataset"):
        LogisticRegression(device="cpu").fit(empty)


def test_logistic_regression_default_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    df = _session().createDataFrame(_feature_rows(4, 3, 2, 0, DenseVector))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LogisticRegression().fit(df)


# -- DataFrame and evaluator ----------------------------------------------

@pytest.mark.parametrize("n,parts,weights,seed", [
    (20, 4, [0.75, 0.25], 7), (33, 3, [0.5, 0.3, 0.2], 11), (7, 1, [1, 1], None),
])
def test_random_split_matches_jax(tpu_session, n, parts, weights, seed):
    rows = [{"i": i, "s": f"r{i}"} for i in range(n)]
    got = _session().createDataFrame(rows, numPartitions=parts).randomSplit(weights, seed=seed)
    want = tpu_session.createDataFrame(rows, numPartitions=parts).randomSplit(weights,
                                                                             seed=seed)
    if seed is None:
        assert sum(g.count() for g in got) == n
        return
    for g, w in zip(got, want):
        assert [r["i"] for r in g.collect()] == [r["i"] for r in w.collect()]
        assert g.getNumPartitions() == parts


def test_select_and_with_column_match_jax(tpu_session):
    rows = [{"a": i, "b": float(i) / 2, "c": f"x{i}"} for i in range(6)]
    got = (_session().createDataFrame(rows, numPartitions=2)
           .withColumn("d", lambda a, c: f"{c}-{a * 3}", "a", "c").select("d", "b"))
    want = (tpu_session.createDataFrame(rows, numPartitions=2)
            .withColumn("d", lambda a, c: f"{c}-{a * 3}", "a", "c").select("d", "b"))
    assert got.columns == want.columns == ["d", "b"]
    assert [tuple(r) for r in got.collect()] == [tuple(r) for r in want.collect()]
    with pytest.raises(KeyError, match="No such column"):
        _session().createDataFrame(rows).select("zz")


@pytest.mark.parametrize("metric", ["accuracy", "f1"])
def test_evaluator_matches_jax(tpu_session, metric):
    rng = np.random.default_rng(3)
    rows = [{"label": int(a), "prediction": float(b)}
            for a, b in zip(rng.integers(0, 3, 30), rng.integers(0, 3, 30))]
    got = MulticlassClassificationEvaluator(metricName=metric).evaluate(
        _session().createDataFrame(rows))
    want = JaxEvaluator(metricName=metric).evaluate(tpu_session.createDataFrame(rows))
    assert got == want and 0 < got < 1


# -- the twin of examples/transfer_learning.py ----------------------------

def _twin_rows(module):
    """make_dataset's two classes: red-dominant (0) vs blue-dominant (1)."""
    rng = np.random.RandomState(0)
    rows = []
    for i in range(N_TWIN):
        label = i % 2
        hw = (60, 80) if i % 5 == 4 else (96, 96)
        img = rng.randint(0, 80, (*hw, 3)).astype(np.uint8)
        img[..., 2 if label else 0] += 120
        rows.append({"image": module.imageArrayToStruct(img, origin=f"flower_{i}"),
                     "label": label})
    return rows


@pytest.fixture(scope="module")
def twin(tpu_session):
    tree = flax_inception_tree(seed=2)
    featurize = dict(inputCol="image", outputCol="features", modelName="InceptionV3",
                     modelWeights=tree, computeDtype="float32", batchSize=4)
    head = dict(featuresCol="features", labelCol="label", maxIter=30)
    jax_train, jax_test = tpu_session.createDataFrame(
        _twin_rows(jax_imageIO), numPartitions=4).randomSplit([0.75, 0.25], seed=7)
    jax_model = JaxPipeline(stages=[JaxFeaturizer(**featurize), JaxLR(**head)]).fit(jax_train)
    train, test = _session().createDataFrame(
        _twin_rows(imageIO), numPartitions=4).randomSplit([0.75, 0.25], seed=7)
    model = Pipeline(stages=[DeepImageFeaturizer(**featurize, device="cpu"),
                             LogisticRegression(**head, device="cpu")]).fit(train)
    return {
        "jax_model": jax_model, "jax_pred": jax_model.transform(jax_test).collect(),
        "model": model, "test": test, "pred": model.transform(test).collect(),
    }


def _accuracy(rows):
    return float(np.mean([r["prediction"] == r["label"] for r in rows]))


def test_twin_splits_the_same_rows(twin):
    got = [r["image"]["origin"] for r in twin["pred"]]
    assert got == [r["image"]["origin"] for r in twin["jax_pred"]]
    assert len(got) == 4


def test_twin_features_match_jax(twin):
    got = np.stack([r["features"].toArray() for r in twin["pred"]])
    want = np.stack([r["features"].toArray() for r in twin["jax_pred"]])
    assert got.shape == (4, 2048)
    np.testing.assert_allclose(got, want, **FEATURE_TOL)


def test_twin_lr_weights_match_jax(twin):
    got, want = twin["model"].stages[1], twin["jax_model"].stages[1]
    err = np.linalg.norm(got.weights - want.weights) / np.linalg.norm(want.weights)
    assert err <= TWIN_LR_NORM_RTOL, err
    np.testing.assert_allclose(got.bias, want.bias, rtol=TWIN_LR_NORM_RTOL, atol=1e-4)
    np.testing.assert_allclose(
        np.stack([r["probability"].toArray() for r in twin["pred"]]),
        np.stack([r["probability"].toArray() for r in twin["jax_pred"]]), atol=1e-3)


def test_twin_accuracy_matches_jax(twin):
    evaluator = MulticlassClassificationEvaluator(metricName="accuracy")
    got = evaluator.evaluate(twin["model"].transform(twin["test"]))
    assert got == _accuracy(twin["pred"]) == _accuracy(twin["jax_pred"])


def test_twin_save_load_reproduces_it(twin, tmp_path):
    path = str(tmp_path / "fitted_pipeline")
    twin["model"].write().overwrite().save(path)
    reloaded = PipelineModel.load(path)
    assert [type(s).__name__ for s in reloaded.stages] == [
        "DeepImageFeaturizer", "LogisticRegressionModel"]
    assert reloaded.stages[0].getDevice() == "cpu"
    rows = reloaded.transform(twin["test"]).collect()
    for a, b in zip(rows, twin["pred"]):
        np.testing.assert_array_equal(a["features"].toArray(), b["features"].toArray())
        assert a["prediction"] == b["prediction"]
    evaluator = MulticlassClassificationEvaluator(metricName="accuracy")
    assert evaluator.evaluate(reloaded.transform(twin["test"])) == _accuracy(twin["pred"])


# -- persistence ----------------------------------------------------------

def test_logistic_regression_model_round_trip(tmp_path):
    model = LogisticRegressionModel(
        np.arange(6, dtype=np.float32).reshape(3, 2), np.array([0.5, -0.5], np.float32),
        "f", "p", "prob", device="cpu")
    model.save(str(tmp_path / "lr"))
    back = LogisticRegressionModel.load(str(tmp_path / "lr"))
    np.testing.assert_array_equal(back.weights, model.weights)
    np.testing.assert_array_equal(back.bias, model.bias)
    assert back.uid == model.uid and back.getDevice() == "cpu"
    assert (tmp_path / "lr" / "lr_model.npz").exists()


def test_unfitted_pipeline_round_trip(tmp_path):
    tree = {"params": {"a": np.ones((2, 2), np.float32)}}
    pipeline = Pipeline(stages=[
        DeepImageFeaturizer(inputCol="image", outputCol="f", modelName="InceptionV3",
                            modelWeights=tree, device="cpu"),
        LogisticRegression(maxIter=7, device="cpu"),
    ])
    pipeline.save(str(tmp_path / "p"))
    back = load_stage(str(tmp_path / "p"))
    featurizer, lr = back.getStages()
    np.testing.assert_array_equal(featurizer.getOrDefault("modelWeights")["params"]["a"],
                                  tree["params"]["a"])
    assert lr.getOrDefault("maxIter") == 7 and lr.getDevice() == "cpu"
    with pytest.raises(FileExistsError, match="overwrite"):
        pipeline.save(str(tmp_path / "p"))
    with pytest.raises(TypeError, match="expected PipelineModel"):
        PipelineModel.load(str(tmp_path / "p"))


def _vit_transformer():
    """A fitted ViT stage that cannot be saved: its attention is a lambda,
    which does not pickle (the stage itself saves since the port of its
    persistence; ``tests/test_torch_vit_persistence.py``)."""
    from sparkdl_tpu_torch.estimators import TorchImageFileTransformer
    from sparkdl_tpu_torch.models.vit import ViT

    return TorchImageFileTransformer(
        inputCol="uri", outputCol="out", imageLoader=np.load,
        module=ViT("ViT-Ti/16", num_classes=2, image_size=32,
                   attn_impl=lambda q, k, v: v), device="cpu")


def test_fitted_vit_transformer_save_raises(tmp_path):
    stage = _vit_transformer()
    with pytest.raises(ValueError, match="does not pickle"):
        stage.save(str(tmp_path / "vit"))
    assert not (tmp_path / "vit").exists()


@pytest.mark.parametrize("holder", ["stage", "pipeline_model", "pipeline"])
def test_refused_save_leaves_an_existing_directory_whole(tmp_path, holder):
    """An overwrite that cannot be done raises before it removes anything,
    also where the unsavable stage sits inside a pipeline."""
    stage = _vit_transformer()
    target = {"stage": stage, "pipeline_model": PipelineModel([stage]),
              "pipeline": Pipeline(stages=[stage])}[holder]
    kept = tmp_path / "kept"
    kept.mkdir()
    (kept / "data.txt").write_text("the user's file")
    with pytest.raises(ValueError, match="does not pickle"):
        target.write().overwrite().save(str(kept))
    assert [p.name for p in kept.iterdir()] == ["data.txt"]
    assert (kept / "data.txt").read_text() == "the user's file"
