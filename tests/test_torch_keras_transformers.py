"""The port's Keras stages and UDFs against the JAX package's, on the CPU.

The cases of ``tests/test_transformers.py`` (``KerasTransformer``,
``KerasImageFileTransformer`` in both output modes and in bf16),
``tests/test_udf.py`` (``registerKerasImageUDF`` through ``session.sql`` and
through ``select(udf(...).alias(...))``, in preprocessor mode, bf16 refused
on an in-memory model, mixed sizes refused without a fixed input size;
``makeGraphUDF`` with one output and with several) and
``tests/test_persistence.py`` (a saved stage carries its model file), each
run through ``sparkdl_tpu`` and ``sparkdl_tpu_torch`` on the same files and
inputs, plus ``session.sql`` outside the ported subset.
"""

import os

import keras
import numpy as np
import pytest
import torch
from PIL import Image

from sparkdl_tpu.graph.function import XlaFunction
from sparkdl_tpu.image import imageIO as jax_imageIO
from sparkdl_tpu.transformers.keras_image import (
    KerasImageFileTransformer as JaxKerasImageFileTransformer,
)
from sparkdl_tpu.transformers.keras_tensor import KerasTransformer as JaxKerasTransformer
from sparkdl_tpu.udf import makeGraphUDF as jax_makeGraphUDF
from sparkdl_tpu.udf import registerKerasImageUDF as jax_registerKerasImageUDF
from sparkdl_tpu_torch import (
    KerasImageFileTransformer,
    KerasTransformer,
    makeGraphUDF,
    registerKerasImageUDF,
)
from sparkdl_tpu_torch.graph import TorchFunction
from sparkdl_tpu_torch.image import imageIO
from sparkdl_tpu_torch.sql.functions import col
from sparkdl_tpu_torch.sql.session import TorchSession

L = keras.layers
TOL = dict(rtol=1e-4, atol=1e-4)
BF16_MAX_REL = 3e-2
UDF_SIZE = 24


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
def session():
    return TorchSession.builder.appName("tests").getOrCreate()


def _seeded(model, seed):
    rng = np.random.RandomState(seed)
    model.set_weights([(rng.randn(*w.shape) * 0.1).astype(np.float32)
                       for w in model.get_weights()])
    return model


def _save(model, path) -> str:
    model.save(path)
    return str(path)


def loader_16(uri):
    img = Image.open(uri).convert("RGB").resize((16, 16))
    return np.asarray(img, dtype=np.float32) / 255.0


def _vectors(rows, column):
    return np.stack([np.asarray(r[column]) for r in rows])


def _both_file_frames(session, tpu_session, image_dir, parts=2):
    return (imageIO.filesToDF(session, image_dir, numPartitions=parts),
            jax_imageIO.filesToDF(tpu_session, image_dir, numPartitions=parts))


# -- KerasImageFileTransformer, KerasTransformer -----------------------------

@pytest.mark.parametrize("mode", ["vector", "image"])
def test_keras_image_file_transformer_matches_jax(session, tpu_session, image_dir,
                                                  tmp_path, mode):
    head = [L.Flatten(), L.Dense(4)] if mode == "vector" else \
        [L.Conv2D(3, 3, padding="same", activation="relu")]
    path = _save(_seeded(keras.Sequential([keras.Input((16, 16, 3))] + head), 1),
                 tmp_path / f"{mode}.keras")
    port_df, jax_df = _both_file_frames(session, tpu_session, image_dir)
    args = dict(inputCol="filePath", outputCol="out", modelFile=path,
                imageLoader=loader_16, outputMode=mode, batchSize=4)
    got = KerasImageFileTransformer(device="cpu", **args).transform(port_df).collect()
    want = JaxKerasImageFileTransformer(**args).transform(jax_df).collect()
    assert [r["filePath"] for r in got] == [r["filePath"] for r in want]
    if mode == "vector":
        np.testing.assert_allclose(_vectors(got, "out"), _vectors(want, "out"), **TOL)
    else:
        a = np.stack([imageIO.imageStructToArray(r["out"]) for r in got])
        b = np.stack([jax_imageIO.imageStructToArray(r["out"]) for r in want])
        assert a.shape == b.shape == (len(got), 16, 16, 3)
        np.testing.assert_allclose(a, b, **TOL)


def test_keras_image_file_transformer_bf16(session, tpu_session, image_dir, tmp_path):
    model = keras.Sequential([keras.Input((16, 16, 3)),
                              L.Conv2D(8, 3, padding="same", activation="relu"),
                              L.GlobalAveragePooling2D()])
    path = _save(_seeded(model, 2), tmp_path / "bf16.keras")
    port_df, jax_df = _both_file_frames(session, tpu_session, image_dir)
    args = dict(inputCol="filePath", outputCol="out", modelFile=path,
                imageLoader=loader_16, batchSize=4)
    f32 = _vectors(KerasImageFileTransformer(device="cpu", **args)
                   .transform(port_df).collect(), "out")
    got = _vectors(KerasImageFileTransformer(device="cpu", computeDtype="bfloat16", **args)
                   .transform(port_df).collect(), "out")
    want = _vectors(JaxKerasImageFileTransformer(computeDtype="bfloat16", **args)
                    .transform(jax_df).collect(), "out")
    scale = np.abs(f32).max()
    assert np.abs(got - want).max() <= BF16_MAX_REL * scale
    assert np.abs(got - f32).max() <= BF16_MAX_REL * scale
    assert np.abs(got - f32).max() > 0  # it did narrow


def test_keras_transformer_matches_jax(session, tpu_session, tmp_path):
    model = keras.Sequential([keras.Input((10,)), L.Dense(7, activation="relu"), L.Dense(3)])
    path = _save(_seeded(model, 3), tmp_path / "dense.keras")
    rng = np.random.RandomState(1)
    vecs = [rng.rand(10).astype(np.float32) for _ in range(9)]
    port_df = session.createDataFrame([{"x": v} for v in vecs])
    jax_df = tpu_session.createDataFrame([{"x": v} for v in vecs])
    args = dict(inputCol="x", outputCol="y", modelFile=path, batchSize=4)
    got = _vectors(KerasTransformer(device="cpu", **args).transform(port_df).collect(), "y")
    want = _vectors(JaxKerasTransformer(**args).transform(jax_df).collect(), "y")
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, np.asarray(model(np.stack(vecs))), **TOL)


def test_saved_stage_carries_its_model_file(session, image_dir, tmp_path):
    model = keras.Sequential([keras.Input((16, 16, 3)), L.Flatten(), L.Dense(5)])
    model_path = _save(_seeded(model, 4), tmp_path / "m.keras")
    df = imageIO.filesToDF(session, image_dir, numPartitions=2)
    stage = KerasImageFileTransformer(inputCol="filePath", outputCol="feat",
                                      modelFile=model_path, imageLoader=loader_16,
                                      batchSize=4, device="cpu")
    want = _vectors(stage.transform(df).collect(), "feat")
    stage.save(str(tmp_path / "stage"))
    os.remove(model_path)  # the bundle holds its own copy
    loaded = KerasImageFileTransformer.load(str(tmp_path / "stage"))
    assert loaded.getModelFile().startswith(str(tmp_path / "stage"))
    assert loaded.getDevice() == "cpu"
    np.testing.assert_array_equal(_vectors(loaded.transform(df).collect(), "feat"), want)


# -- registerKerasImageUDF ---------------------------------------------------------

@pytest.fixture(scope="module")
def udf_model():
    model = keras.Sequential([keras.Input((UDF_SIZE, UDF_SIZE, 3)),
                              L.Conv2D(4, 3, activation="relu"),
                              L.GlobalAveragePooling2D(), L.Dense(5)])
    return _seeded(model, 7)


@pytest.fixture(scope="module")
def udf_model_file(udf_model, tmp_path_factory):
    return _save(udf_model, tmp_path_factory.mktemp("udf") / "small_cnn.keras")


@pytest.fixture()
def image_frames(session, tpu_session, image_dir):
    return (imageIO.readImages(image_dir, session, numPartitions=2),
            jax_imageIO.readImages(image_dir, tpu_session, numPartitions=2))


def _by_path(rows, column="preds"):
    return {r["filePath"]: np.asarray(r[column]) for r in rows}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_keras_image_udf_through_sql_matches_jax(session, tpu_session, image_frames,
                                                  udf_model_file, dtype):
    port_df, jax_df = image_frames
    name = f"small_cnn_{dtype}"
    registerKerasImageUDF(name, udf_model_file, computeDtype=dtype, device="cpu")
    jax_registerKerasImageUDF(name, udf_model_file, computeDtype=dtype)
    port_df.createOrReplaceTempView("images")
    jax_df.createOrReplaceTempView("images")
    query = f"SELECT filePath, {name}(image) AS preds FROM images"
    got, want = session.sql(query).collect(), tpu_session.sql(query).collect()
    assert len(got) == len(want) == port_df.count()
    got, want = _by_path(got), _by_path(want)
    assert sorted(got) == sorted(want)
    for path in got:
        if dtype == "float32":
            np.testing.assert_allclose(got[path], want[path], **TOL)
        else:
            np.testing.assert_allclose(got[path], want[path], rtol=3e-2, atol=3e-2)


def test_keras_image_udf_in_memory_model_through_select(session, tpu_session,
                                                        image_frames, udf_model):
    port_df, jax_df = image_frames
    udf = registerKerasImageUDF("small_cnn_obj", udf_model, device="cpu")
    jax_udf = jax_registerKerasImageUDF("small_cnn_obj", udf_model)
    got = port_df.select(col("filePath"), udf("image").alias("preds")).collect()
    want = jax_df.select("filePath", jax_udf("image").alias("preds")).collect()
    got, want = _by_path(got), _by_path(want)
    for path in want:
        np.testing.assert_allclose(got[path], want[path], **TOL)
    assert "small_cnn_obj" in session.udf


def test_keras_image_udf_with_a_preprocessor(session, tpu_session, image_dir, udf_model,
                                             udf_model_file):
    def preprocessor(path):
        img = Image.open(path).convert("RGB").resize((UDF_SIZE, UDF_SIZE))
        return np.asarray(img, dtype=np.float32)

    registerKerasImageUDF("small_cnn_file", udf_model_file, preprocessor=preprocessor,
                          device="cpu")
    jax_registerKerasImageUDF("small_cnn_file", udf_model_file, preprocessor=preprocessor)
    port_df, jax_df = _both_file_frames(session, tpu_session, image_dir, parts=1)
    port_df.createOrReplaceTempView("files")
    jax_df.createOrReplaceTempView("files")
    query = "SELECT filePath, small_cnn_file(filePath) AS preds FROM files"
    got, want = _by_path(session.sql(query).collect()), _by_path(tpu_session.sql(query).collect())
    for path in want:
        np.testing.assert_allclose(got[path], want[path], **TOL)
        direct = np.asarray(udf_model(preprocessor(path)[None]))[0]
        np.testing.assert_allclose(got[path], direct, **TOL)


def test_keras_image_udf_refusals(session, tpu_session, image_frames, udf_model, tmp_path):
    with pytest.raises(ValueError, match="computeDtype"):
        registerKerasImageUDF("nope", udf_model, computeDtype="bfloat16", device="cpu")
    with pytest.raises(ValueError, match="computeDtype"):
        jax_registerKerasImageUDF("nope", udf_model, computeDtype="bfloat16",
                                  session=tpu_session)
    # a model without a fixed input size over a column of mixed sizes
    dynamic = _save(keras.Sequential([keras.Input((None, None, 3)),
                                      L.GlobalAveragePooling2D()]),
                    tmp_path / "dynamic.keras")
    port_df, jax_df = image_frames
    udf = registerKerasImageUDF("dynamic_udf", dynamic, device="cpu")
    jax_udf = jax_registerKerasImageUDF("dynamic_udf", dynamic)
    with pytest.raises(ValueError, match="input size is dynamic"):
        port_df.select(udf("image")).collect()
    with pytest.raises(ValueError, match="input size is dynamic"):
        jax_df.select(jax_udf("image")).collect()


# -- makeGraphUDF ------------------------------------------------------------

def test_make_graph_udf_one_output(session, tpu_session):
    makeGraphUDF(TorchFunction.from_callable(lambda x: (x * 2.0).sum(dim=-1)),
                 "double_sum", device="cpu")
    jax_makeGraphUDF(XlaFunction.from_callable(lambda x: (x * 2.0).sum(axis=-1)),
                     "double_sum")
    rows = [([1.0, 2.0, 3.0],), ([4.0, 5.0, 6.0],), ([0.5, 0.0, -1.0],)]
    session.createDataFrame(rows, ["v"]).createOrReplaceTempView("vectors")
    tpu_session.createDataFrame(rows, ["v"]).createOrReplaceTempView("vectors")
    query = "SELECT double_sum(v) AS s FROM vectors"
    got = [r.s for r in session.sql(query).collect()]
    assert got == [r.s for r in tpu_session.sql(query).collect()] == [12.0, 30.0, -1.0]


def test_make_graph_udf_vector_output_params_and_no_registration(session, tpu_session):
    w = np.arange(6, dtype=np.float32).reshape(3, 2)
    fn = TorchFunction.from_callable(lambda p, x: x @ p["w"], params={"w": w},
                                     takes_params=True)
    udf = makeGraphUDF(fn, "matmul_udf", register=False, device="cpu")
    jax_udf = jax_makeGraphUDF(
        XlaFunction.from_callable(lambda p, x: x @ p["w"], params={"w": w},
                                  takes_params=True), "matmul_udf", register=False)
    rows = [([1.0, 0.0, 1.0],), ([2.0, -1.0, 0.5],)]
    got = session.createDataFrame(rows, ["v"]).select(udf("v").alias("y")).collect()
    want = tpu_session.createDataFrame(rows, ["v"]).select(jax_udf("v").alias("y")).collect()
    np.testing.assert_allclose(_vectors(got, "y"), _vectors(want, "y"), **TOL)
    assert "matmul_udf" not in session.udf
    with pytest.raises(TypeError, match="TorchFunction"):
        makeGraphUDF(lambda x: x, "not_a_function", device="cpu")


def test_make_graph_udf_several_outputs(session, tpu_session):
    makeGraphUDF(TorchFunction.from_callable(
        lambda x: (x.sum(dim=-1), x.amax(dim=-1)), output_names=("total", "peak")),
        "stats_udf", device="cpu")
    jax_makeGraphUDF(XlaFunction.from_callable(
        lambda x: (x.sum(axis=-1), x.max(axis=-1)), output_names=("total", "peak")),
        "stats_udf")
    rows = [([1.0, 5.0],), ([2.0, 2.0],)]
    session.createDataFrame(rows, ["v"]).createOrReplaceTempView("stats_in")
    tpu_session.createDataFrame(rows, ["v"]).createOrReplaceTempView("stats_in")
    query = "SELECT stats_udf(v) AS st FROM stats_in"
    got, want = session.sql(query).collect(), tpu_session.sql(query).collect()
    assert [(r.st.total, r.st.peak) for r in got] == \
        [(r.st.total, r.st.peak) for r in want] == [(6.0, 5.0), (4.0, 2.0)]


# -- session.sql outside its subset ---------------------------------------------------

@pytest.mark.parametrize("query", [
    "SELECT v FROM vectors WHERE v IS NOT NULL",
    "SELECT count(*) FROM vectors",
    "SELECT v + 1 AS w FROM vectors",
    "SELECT v FROM vectors ORDER BY v",
    "SELECT a.v FROM vectors a JOIN vectors b ON a.v = b.v",
])
def test_sql_outside_the_subset_raises(session, query):
    session.createDataFrame([([1.0],)], ["v"]).createOrReplaceTempView("vectors")
    with pytest.raises(NotImplementedError, match="item 14"):
        session.sql(query)
