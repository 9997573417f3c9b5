"""The port's TFImageTransformer and TFTransformer against the JAX package's.

The cases of ``tests/test_transformers.py`` (the numpy oracle, image mode,
the mapping errors, integer columns) and ``tests/test_persistence.py`` (the
two stages saved and loaded), each run through both packages on the same
rows, plus InceptionV3 at 75x75 as a function (the JAX stage with
``XlaFunction.from_flax``, the port's with ``TorchFunction.from_module``)
on uniform and mixed partitions, the one-channel ``"L"`` order, and the
helpers the stages run on: the decode with ``n_channels`` and ``to_rgb``,
``run_batched_multi``, ``place_params``, ``make_input_prologue`` and
``DataFrame.filter``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sparkdl_tpu.graph import XlaFunction
from sparkdl_tpu.graph import pieces as jax_pieces
from sparkdl_tpu.image import imageIO as jax_imageIO
from sparkdl_tpu.models.inception_v3 import InceptionV3 as FlaxInceptionV3
from sparkdl_tpu.transformers import utils as jax_utils
from sparkdl_tpu.transformers.tf_image import TFImageTransformer as JaxTFImageTransformer
from sparkdl_tpu.transformers.tf_tensor import TFTransformer as JaxTFTransformer
from sparkdl_tpu_torch import PipelineModel, TFImageTransformer, TFTransformer
from sparkdl_tpu_torch.graph import TorchFunction, pieces
from sparkdl_tpu_torch.image import imageIO
from sparkdl_tpu_torch.ml.linalg import DenseVector
from sparkdl_tpu_torch.ml.util import load_stage
from sparkdl_tpu_torch.models.convert import inception_state_dict_from_flax
from sparkdl_tpu_torch.models.inception_v3 import InceptionV3
from sparkdl_tpu_torch.sql.session import TorchSession
from sparkdl_tpu_torch.transformers import utils
from sparkdl_tpu_torch.utils.metrics import metrics
from test_torch_inception import flax_inception_tree
from test_torch_named_image import _frames, _images, _vectors

STAGE_TOL = dict(rtol=1e-4, atol=1e-4)
# tests/test_transformers.py's bound on a channel mean after
# jax.image.resize (up to 3e-3 off float64 on the CPU, 0-255 scale)
MEAN_TOL = dict(rtol=1e-4, atol=1e-3)
RESIZE_VS_JAX_ATOL = 5e-3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _no_compile_cache(monkeypatch):
    monkeypatch.setenv("SPARKDL_COMPILE_CACHE", "off")


@pytest.fixture()
def session():
    return TorchSession.builder.getOrCreate()


@pytest.fixture()
def image_frames(tpu_session, session, image_dir):
    """The conftest's files (mixed sizes, one grayscale) as a port frame and
    a JAX frame, two partitions each."""
    return (imageIO.readImages(image_dir, session, numPartitions=2),
            jax_imageIO.readImages(image_dir, tpu_session, numPartitions=2))


def _by_path(rows, col):
    return {r["filePath"]: r[col] for r in rows}


def _chan_mean():
    return (TorchFunction.from_callable(lambda x: x.mean(dim=(1, 2)), name="chan_mean"),
            XlaFunction.from_callable(lambda x: jnp.mean(x, axis=(1, 2)), name="chan_mean"))


# -- TFImageTransformer ------------------------------------------------------

def test_tf_image_transformer_vector_vs_numpy_oracle(image_frames):
    port_df, jax_df = image_frames
    fn, jax_fn = _chan_mean()
    args = dict(inputCol="image", outputCol="out", inputShape=(64, 64),
                channelOrder="RGB", batchSize=4)
    got = _by_path(TFImageTransformer(graph=fn, device="cpu", **args)
                   .transform(port_df).collect(), "out")
    want = _by_path(JaxTFImageTransformer(graph=jax_fn, **args)
                    .transform(jax_df).collect(), "out")
    assert sorted(got) == sorted(want) and len(got) == 7
    for row in port_df.collect():
        path = row["filePath"]
        assert isinstance(got[path], DenseVector) and len(got[path]) == 3
        # the oracle: the same decode, resize and channel mean, in numpy
        rgb = utils.normalize_channels(
            imageIO.imageStructToArray(row["image"]).astype(np.float32), 3)[..., ::-1]
        wh = utils.resize_weights(rgb.shape[0], 64).astype(np.float64)
        ww = utils.resize_weights(rgb.shape[1], 64).astype(np.float64)
        oracle = np.einsum("hwc,hk,wl->klc", rgb.astype(np.float64), wh, ww).mean(axis=(0, 1))
        np.testing.assert_allclose(got[path].toArray(), oracle, rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(got[path].toArray(), want[path].toArray(), **MEAN_TOL)


def test_tf_image_transformer_image_output_mode(image_frames):
    port_df, jax_df = image_frames
    args = dict(inputCol="image", outputCol="out", inputShape=(32, 32), outputMode="image")
    # only 3-channel rows: drop the grayscale file
    port_df = port_df.filter(lambda r: r["image"]["nChannels"] == 3)
    jax_df = jax_df.filter(lambda r: r["image"]["nChannels"] == 3)
    got = _by_path(TFImageTransformer(
        graph=TorchFunction.from_callable(lambda x: x * 0.5, name="halve"), device="cpu",
        **args).transform(port_df).collect(), "out")
    want = _by_path(JaxTFImageTransformer(
        graph=XlaFunction.from_callable(lambda x: x * 0.5, name="halve"),
        **args).transform(jax_df).collect(), "out")
    assert sorted(got) == sorted(want) and len(got) == 6
    for path, struct in got.items():
        assert struct["height"] == 32 and struct["width"] == 32 and struct["nChannels"] == 3
        arr = imageIO.imageStructToArray(struct)
        assert arr.dtype == np.float32
        np.testing.assert_allclose(arr, jax_imageIO.imageStructToArray(want[path]),
                                   atol=RESIZE_VS_JAX_ATOL)


@pytest.mark.parametrize("order", ["L", "BGR"])
def test_tf_image_transformer_channel_orders(image_frames, order):
    port_df, jax_df = image_frames
    fn, jax_fn = _chan_mean()
    args = dict(inputCol="image", outputCol="out", inputShape=(24, 40), channelOrder=order,
                batchSize=3)
    got = _by_path(TFImageTransformer(graph=fn, device="cpu", **args)
                   .transform(port_df).collect(), "out")
    want = _by_path(JaxTFImageTransformer(graph=jax_fn, **args)
                    .transform(jax_df).collect(), "out")
    width = 1 if order == "L" else 3
    for path in want:
        assert len(got[path]) == width
        np.testing.assert_allclose(got[path].toArray(), want[path].toArray(), **MEAN_TOL)


def test_tf_image_transformer_one_channel_images_match_jax(tpu_session):
    """Uniform three-channel uint8 rows under "L": the luminance of the
    stored BGR order, image out, against the JAX stage."""
    port_df, jax_df = _frames(tpu_session, _images([(20, 16)] * 3, seed=5))
    args = dict(inputCol="image", outputCol="out", channelOrder="L", outputMode="image")
    got = TFImageTransformer(graph=TorchFunction.from_callable(lambda x: x), device="cpu",
                             **args).transform(port_df).collect()
    want = JaxTFImageTransformer(graph=XlaFunction.from_callable(lambda x: x),
                                 **args).transform(jax_df).collect()
    for g, w, img in zip(got, want, _images([(20, 16)] * 3, seed=5)):
        got_img = imageIO.imageStructToArray(g["out"])
        assert got_img.shape == (20, 16, 1)
        np.testing.assert_allclose(got_img, jax_imageIO.imageStructToArray(w["out"]),
                                   rtol=1e-6, atol=1e-4)
        lum = 0.114 * img[..., 0] + 0.587 * img[..., 1] + 0.299 * img[..., 2]
        np.testing.assert_allclose(got_img[..., 0], lum, rtol=1e-6, atol=1e-4)


def test_tf_image_transformer_rejects_a_multi_output_function(image_frames):
    port_df, _ = image_frames
    fn = TorchFunction.from_callable(lambda x: (x, x), output_names=("a", "b"))
    with pytest.raises(ValueError, match="single-output"):
        TFImageTransformer(inputCol="image", outputCol="out", graph=fn, inputShape=(8, 8),
                           device="cpu").transform(port_df)


def test_graph_param_takes_only_a_torch_function():
    with pytest.raises(TypeError, match="TorchFunction"):
        TFImageTransformer(inputCol="image", outputCol="out",
                           graph=XlaFunction.from_callable(lambda x: x))
    with pytest.raises(TypeError, match="Channel order"):
        TFImageTransformer(channelOrder="RGBA")
    with pytest.raises(TypeError, match="outputMode must be one of") as port_err:
        TFImageTransformer(outputMode="tensor")
    with pytest.raises(TypeError, match="outputMode must be one of") as jax_err:
        JaxTFImageTransformer(outputMode="tensor")
    assert str(port_err.value) == str(jax_err.value)


def test_stages_default_to_the_card(monkeypatch, session):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rows = [{"image": imageIO.imageArrayToStruct(np.zeros((4, 4, 3), np.uint8)),
             "x": np.zeros(3, np.float32)}]
    df = session.createDataFrame(rows, numPartitions=1)
    fn = TorchFunction.from_callable(lambda x: x)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TFImageTransformer(inputCol="image", outputCol="out", graph=fn).transform(df)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TFTransformer(tfInputGraph=fn, inputMapping={"x": "input"},
                      outputMapping={"output": "y"}).transform(df)


@pytest.fixture(scope="module")
def inception():
    tree = flax_inception_tree(seed=4)
    jax_fn = XlaFunction.from_list([
        jax_pieces.build_preprocessor("tf"),
        XlaFunction.from_flax(FlaxInceptionV3(), tree, features_only=True),
    ])
    to_nchw = TorchFunction.from_callable(
        lambda x: x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last))
    module = InceptionV3().to(memory_format=torch.channels_last)
    fn = TorchFunction.from_list([
        pieces.build_preprocessor("tf"), to_nchw,
        TorchFunction.from_module(module, inception_state_dict_from_flax(tree),
                                  features_only=True),
    ], name="inception_v3")
    return fn, jax_fn


@pytest.mark.parametrize("sizes", [
    [(48, 64)] * 3,
    [(48, 64), (96, 80), (75, 75)],
], ids=["one_size_uint8", "mixed_sizes_resized_while_packing"])
def test_inception_function_matches_jax(tpu_session, inception, sizes):
    fn, jax_fn = inception
    port_df, jax_df = _frames(tpu_session, _images(sizes, seed=3))
    args = dict(inputCol="image", outputCol="features", inputShape=(75, 75), batchSize=2)
    want = JaxTFImageTransformer(graph=jax_fn, **args).transform(jax_df).collect()
    rows_before = metrics.counter("sparkdl.rows_processed").value
    got = TFImageTransformer(graph=fn, device="cpu", **args).transform(port_df).collect()
    assert metrics.counter("sparkdl.rows_processed").value == rows_before + len(sizes)
    assert [r["image"]["origin"] for r in got] == [f"img{i}" for i in range(len(sizes))]
    features = _vectors(got, "features")
    assert features.shape == (len(sizes), 2048) and np.isfinite(features).all()
    np.testing.assert_allclose(features, _vectors(want, "features"), **STAGE_TOL)


# -- TFTransformer -----------------------------------------------------------

def _double_sum():
    return (
        TorchFunction.from_callable(lambda x: (x * 2.0, x.sum(-1)), input_names=("inp",),
                                    output_names=("doubled", "total"), name="double_sum"),
        XlaFunction.from_callable(lambda x: (x * 2.0, jnp.sum(x, axis=-1)),
                                  input_names=("inp",), output_names=("doubled", "total"),
                                  name="double_sum"),
    )


def test_tf_transformer_mappings(tpu_session, session):
    rng = np.random.RandomState(0)
    vecs = [rng.rand(8).astype(np.float32) for _ in range(11)]
    fn, jax_fn = _double_sum()
    args = dict(inputMapping={"x": "inp"}, outputMapping={"doubled": "x2", "total": "sum"},
                batchSize=4)
    rows = TFTransformer(tfInputGraph=fn, device="cpu", **args).transform(
        session.createDataFrame([{"x": v} for v in vecs], numPartitions=2)).collect()
    want = JaxTFTransformer(tfInputGraph=jax_fn, **args).transform(
        tpu_session.createDataFrame([{"x": v} for v in vecs])).collect()
    assert len(rows) == len(want) == 11
    for row, w, v in zip(rows, want, vecs):
        np.testing.assert_allclose(row["x2"], v * 2, rtol=1e-6)
        np.testing.assert_allclose(row["sum"], v.sum(), rtol=1e-5)
        np.testing.assert_allclose(row["x2"], np.asarray(w["x2"]), rtol=1e-6)
        np.testing.assert_allclose(row["sum"], np.asarray(w["sum"]), rtol=1e-6)
        assert row["x2"].dtype == np.float32 and row["x2"].shape == (8,)


def test_tf_transformer_two_inputs(session):
    fn = TorchFunction.from_callable(lambda a, b: a * b, input_names=("a", "b"),
                                     output_names=("prod",))
    rows = [{"p": np.full(2, i, np.float32), "q": np.arange(2, dtype=np.float32)}
            for i in range(5)]
    out = TFTransformer(tfInputGraph=fn, inputMapping={"q": "b", "p": "a"},
                        outputMapping={"prod": "r"}, batchSize=2, device="cpu").transform(
        session.createDataFrame(rows, numPartitions=1)).collect()
    np.testing.assert_array_equal(np.stack([r["r"] for r in out]),
                                  [[0, i] for i in range(5)])


@pytest.mark.parametrize("input_mapping,output_mapping,message", [
    ({"x": "input"}, {"nope": "y"}, "Unknown function outputs"),
    ({"x": "nope"}, {"output": "y"}, "Unknown function inputs"),
    ({"x": "input", "x2": "input"}, {"output": "y"}, "maps multiple columns"),
    ({}, {"output": "y"}, "does not cover function inputs"),
], ids=["unknown_output", "unknown_input", "two_columns_one_input", "uncovered_input"])
def test_tf_transformer_bad_mapping(tpu_session, session, input_mapping, output_mapping,
                                    message):
    row = {"x": np.zeros(3, np.float32), "x2": np.zeros(3, np.float32)}
    with pytest.raises(ValueError, match=message) as port_err:
        TFTransformer(tfInputGraph=TorchFunction.from_callable(lambda x: x, name="id"),
                      inputMapping=input_mapping, outputMapping=output_mapping,
                      device="cpu").transform(session.createDataFrame([row]))
    with pytest.raises(ValueError, match=message) as jax_err:
        JaxTFTransformer(tfInputGraph=XlaFunction.from_callable(lambda x: x, name="id"),
                         inputMapping=input_mapping, outputMapping=output_mapping,
                         ).transform(tpu_session.createDataFrame([row]))
    assert str(port_err.value) == str(jax_err.value)


def test_tf_transformer_preserves_integer_columns(tpu_session, session):
    """Integer tensor columns keep an integral type (int32) through the
    stage, as in the JAX package."""
    args = dict(inputMapping={"ids": "ids"}, outputMapping={"doubled": "out"})
    got = TFTransformer(
        tfInputGraph=TorchFunction.from_callable(lambda x: x * 2, input_names=("ids",),
                                                 output_names=("doubled",)),
        device="cpu", **args,
    ).transform(session.createDataFrame([([1, 2, 3],), ([4, 5, 6],)], ["ids"])).collect()
    want = JaxTFTransformer(
        tfInputGraph=XlaFunction.from_callable(lambda x: x * 2, input_names=("ids",),
                                               output_names=("doubled",)), **args,
    ).transform(tpu_session.createDataFrame([([1, 2, 3],), ([4, 5, 6],)], ["ids"])).collect()
    out = np.asarray(got[0]["out"])
    assert out.dtype == np.int32 == np.asarray(want[0]["out"]).dtype
    np.testing.assert_array_equal(out, [2, 4, 6])
    np.testing.assert_array_equal(got[1]["out"], want[1]["out"])


def test_tf_transformer_keeps_empty_partitions(session):
    df = session.createDataFrame([{"x": np.ones(2, np.float32)}], numPartitions=1)
    empty = df.filter(lambda r: False)
    out = TFTransformer(tfInputGraph=TorchFunction.from_callable(lambda x: x + 1),
                        inputMapping={"x": "input"}, outputMapping={"output": "y"},
                        device="cpu").transform(df.union(empty)).collect()
    assert len(out) == 1 and out[0]["y"].tolist() == [2.0, 2.0]


# -- persistence ----------------------------------------------------------------

def _double_fn():
    fn = TorchFunction.from_callable(lambda x: 2.0 * x, input_names=("x",),
                                     output_names=("y",), name="double")
    fn.input_specs = [((4, 3), np.float32)]
    return fn


def test_tf_transformer_roundtrip(session, tmp_path):
    t = TFTransformer(tfInputGraph=_double_fn(), inputMapping={"x": "x"},
                      outputMapping={"y": "doubled"}, batchSize=4, device="cpu")
    df = session.createDataFrame([{"x": np.full(3, float(i), np.float32)} for i in range(5)])
    want = np.stack([r["doubled"] for r in t.transform(df).collect()])
    path = str(tmp_path / "tf_transformer")
    t.save(path)
    loaded = TFTransformer.load(path)
    assert loaded.uid == t.uid
    assert loaded.getOrDefault(loaded.batchSize) == 4
    assert loaded.getOrDefault(loaded.inputMapping) == {"x": "x"}
    assert loaded.getOrDefault(loaded.tfInputGraph).fingerprint.startswith("pt2:")
    got = np.stack([r["doubled"] for r in loaded.transform(df).collect()])
    np.testing.assert_array_equal(got, want)


def test_function_without_specs_refuses_to_save_before_touching_the_disk(session, tmp_path):
    fn = TorchFunction.from_callable(lambda x: x + 1, name="plus_one")
    t = TFTransformer(tfInputGraph=fn, inputMapping={"x": "input"},
                      outputMapping={"output": "y"}, device="cpu")
    path = tmp_path / "stage"
    path.mkdir()
    (path / "keep.txt").write_text("the old save")
    with pytest.raises(ValueError, match="no recorded input specs"):
        t.write().overwrite().save(str(path))
    with pytest.raises(ValueError, match="no recorded input specs"):
        PipelineModel(stages=[t]).write().overwrite().save(str(path))
    assert (path / "keep.txt").read_text() == "the old save"
    fn.input_specs = [((2, 3), np.float32)]
    t.write().overwrite().save(str(path))
    loaded = TFTransformer.load(str(path))
    df = session.createDataFrame([{"x": np.zeros(3, np.float32)}], numPartitions=1)
    assert loaded.transform(df).collect()[0]["y"].tolist() == [1.0, 1.0, 1.0]


def test_tf_image_transformer_roundtrip(image_frames, tmp_path):
    port_df, _ = image_frames
    fn = TorchFunction.from_callable(lambda x: x.mean(dim=(1, 2)), input_names=("images",),
                                     output_names=("means",), name="chanmean")
    fn.input_specs = [((2, 16, 16, 3), np.float32)]
    t = TFImageTransformer(inputCol="image", outputCol="out", graph=fn, inputShape=(16, 16),
                           channelOrder="RGB", batchSize=2, device="cpu")
    want = _vectors(t.transform(port_df).collect(), "out")
    path = str(tmp_path / "tf_image")
    t.save(path)
    loaded = TFImageTransformer.load(path)
    assert tuple(loaded.getOrDefault(loaded.inputShape)) == (16, 16)
    assert loaded.getGraph().name == "chanmean"
    np.testing.assert_array_equal(_vectors(loaded.transform(port_df).collect(), "out"), want)


def test_pipeline_model_of_both_stages_roundtrip(tpu_session, inception, tmp_path):
    """A PipelineModel([TFImageTransformer, TFTransformer]) saved and
    loaded gives the same columns bit for bit."""
    fn, _ = inception
    fn.input_specs = [((2, 75, 75, 3), np.float32)]
    head = TorchFunction.from_callable(
        lambda p, f: (f @ p["w"], torch.softmax(f @ p["w"], dim=-1)),
        params={"w": np.random.RandomState(0).randn(2048, 3).astype(np.float32) * 0.01},
        takes_params=True, input_names=("features",), output_names=("logits", "probs"))
    head.input_specs = [((2, 2048), np.float32)]
    model = PipelineModel(stages=[
        TFImageTransformer(inputCol="image", outputCol="features", graph=fn,
                           inputShape=(75, 75), batchSize=2, device="cpu"),
        TFTransformer(tfInputGraph=head, inputMapping={"features": "features"},
                      outputMapping={"logits": "logits", "probs": "probs"}, device="cpu"),
    ])
    port_df, _ = _frames(tpu_session, _images([(48, 64)] * 3, seed=6))
    want = model.transform(port_df).collect()
    path = str(tmp_path / "pipeline")
    model.write().overwrite().save(path)
    loaded = load_stage(path)
    assert isinstance(loaded, PipelineModel)
    got = loaded.transform(port_df).collect()
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["features"].toArray(), w["features"].toArray())
        np.testing.assert_array_equal(g["logits"], w["logits"])
        np.testing.assert_array_equal(g["probs"], w["probs"])
        np.testing.assert_allclose(g["probs"].sum(), 1.0, rtol=1e-6)


# -- the helpers --------------------------------------------------------------------

@pytest.mark.parametrize("channels,n_channels", [(1, 3), (4, 3), (3, 1), (4, 1), (1, 1)])
def test_normalize_channels_matches_jax(channels, n_channels):
    img = np.random.RandomState(channels).uniform(0, 255, (5, 6, channels)).astype(np.float32)
    got = utils.normalize_channels(img, n_channels)
    assert got.shape == (5, 6, n_channels) and got.dtype == np.float32
    np.testing.assert_array_equal(got, jax_utils.normalize_channels(img, n_channels))


def test_normalize_channels_refuses_what_jax_refuses():
    img = np.zeros((2, 2, 2), np.float32)
    with pytest.raises(ValueError, match="Cannot convert") as port_err:
        utils.normalize_channels(img, 3)
    with pytest.raises(ValueError, match="Cannot convert") as jax_err:
        jax_utils.normalize_channels(img, 3)
    assert str(port_err.value) == str(jax_err.value)


@pytest.mark.parametrize("sizes,n_channels,to_rgb", [
    ([(6, 8)] * 3, 3, True),
    ([(6, 8)] * 3, 1, False),
    ([(6, 8), (9, 5)], 1, False),
    ([(6, 8), (9, 5)], 3, True),
], ids=["uint8_rgb", "uniform_luminance", "mixed_luminance", "mixed_rgb"])
def test_decode_plan_matches_jax(sizes, n_channels, to_rgb):
    images = _images(sizes, seed=8)
    port = [imageIO.imageArrayToStruct(img) for img in images]
    ref = [jax_imageIO.imageArrayToStruct(img) for img in images]
    got = utils.make_image_decode_plan(port, (7, 7), device="cpu", n_channels=n_channels,
                                       to_rgb=to_rgb)(port)
    want = jax_utils.make_image_decode_plan(ref, n_channels, (7, 7), to_rgb=to_rgb)(ref)
    assert got.shape == want.shape and got.shape[-1] == n_channels
    if len(set(sizes)) == 1 and n_channels == 3:
        assert got.dtype == np.uint8  # packed at source size, cast on the device
    np.testing.assert_allclose(got.astype(np.float32), want.astype(np.float32),
                               atol=RESIZE_VS_JAX_ATOL)


def test_run_batched_multi_keeps_every_row_in_order():
    a = np.arange(22, dtype=np.float32).reshape(11, 2)
    b = np.arange(11, dtype=np.int32)
    batches = []

    def fn(x, y):
        batches.append(x.shape[0])
        return x.sum(-1), y * 2

    s, d = utils.run_batched_multi(fn, [a, b], batch_size=4, device="cpu")
    assert batches == [4, 4, 3]  # the ragged last chunk at its own size
    np.testing.assert_array_equal(s, a.sum(-1))
    np.testing.assert_array_equal(d, b * 2)
    assert d.dtype == np.int32
    jax_s, jax_d = jax_utils.run_batched_multi(jax.jit(lambda x, y: (x.sum(-1), y * 2)),
                                               [a, b], batch_size=4)
    np.testing.assert_array_equal(s, jax_s)
    np.testing.assert_array_equal(d, jax_d)
    one = utils.run_batched(lambda x: x + 1, a, batch_size=5, device="cpu")
    np.testing.assert_array_equal(one, a + 1)
    with pytest.raises(ValueError, match="non-empty"):
        utils.run_batched(lambda x: x, a[:0], device="cpu")


def test_run_batched_multi_widens_bf16_outputs():
    a = np.linspace(-2, 2, 12, dtype=np.float32).reshape(6, 2)
    (out,) = utils.run_batched_multi(lambda x: x.to(torch.bfloat16), [a], device="cpu")
    assert out.dtype == np.float32
    np.testing.assert_array_equal(out, torch.from_numpy(a).to(torch.bfloat16).float().numpy())


def test_place_params_moves_every_leaf():
    tree = {"a": np.ones(2, np.float32), "b": [torch.zeros(1), 3], "c": {"d": np.float64(2)}}
    placed = utils.place_params(tree, "cpu")
    assert isinstance(placed["a"], torch.Tensor) and placed["a"].tolist() == [1.0, 1.0]
    assert placed["b"][1] == 3 and placed["c"]["d"].item() == 2.0
    with pytest.raises(RuntimeError, match="device='cpu'"):
        if torch.cuda.is_available():
            pytest.skip("a card is present")
        utils.place_params(tree)


def test_make_input_prologue_matches_jax():
    x = np.random.RandomState(2).randint(0, 255, (2, 10, 12, 3)).astype(np.uint8)
    from sparkdl_tpu_torch.models.registry import preprocess_input
    from sparkdl_tpu.models.registry import preprocess_input as jax_preprocess_input

    got = utils.make_input_prologue((6, 6), lambda t: preprocess_input(t, "tf"))(
        torch.from_numpy(x))
    want = jax_utils.make_input_prologue((6, 6), lambda t: jax_preprocess_input(t, "tf"))(
        jnp.asarray(x))
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 6, 6, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=RESIZE_VS_JAX_ATOL / 127.5)
    same = utils.make_input_prologue()(torch.from_numpy(x))
    np.testing.assert_array_equal(same.numpy(), x.astype(np.float32))


def test_dataframe_filter_matches_jax(tpu_session, session):
    rows = [{"i": i, "v": float(i) / 2} for i in range(9)]
    got = session.createDataFrame(rows, numPartitions=3).filter(lambda r: r["i"] % 3 != 1)
    want = tpu_session.createDataFrame(rows, numPartitions=3).filter(lambda r: r["i"] % 3 != 1)
    assert got.getNumPartitions() == 3
    assert [tuple(r) for r in got.collect()] == [tuple(r) for r in want.collect()]
    assert [tuple(r) for r in got.where(lambda r: r["v"] > 2).collect()] == [
        (5, 2.5), (6, 3.0), (8, 4.0)]
    with pytest.raises(TypeError, match="callable"):
        got.filter("i > 1")
