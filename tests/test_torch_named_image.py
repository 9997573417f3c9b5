"""The port's named-CNN stages and their input half against the JAX
package's, on the CPU.

- ``DeepImageFeaturizer(device="cpu", computeDtype="float32")`` against
  ``sparkdl_tpu``'s ``DeepImageFeaturizer(computeDtype="float32")`` on the
  same image-struct rows and Flax tree: a partition of one size (uint8,
  packed at source size, resized in the forward) and one of mixed sizes
  (float32, resized while packing);
- ``DeepImagePredictor`` probabilities and the top-K decode;
- the resize against ``jax.image.resize``, the decode against the JAX
  decode, ``MixedImageSizesError``, image structs;
- ``modelWeights`` resolution and the port's device rule.

The JAX featurizer's float32 forward on the CPU and the port's agree to
about 1e-6 (features of unit order); the stage bound is the module's,
``rtol=atol=1e-4``, since resize and preprocessing add float rounding only.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax._src.image.scale import _fill_triangle_kernel, compute_weight_mat

from sparkdl_tpu import DeepImageFeaturizer as JaxFeaturizer
from sparkdl_tpu import DeepImagePredictor as JaxPredictor
from sparkdl_tpu.image import imageIO as jax_imageIO
from sparkdl_tpu.models import registry as jax_registry
from sparkdl_tpu.transformers import utils as jax_utils
from sparkdl_tpu_torch import DeepImageFeaturizer, DeepImagePredictor
from sparkdl_tpu_torch.image import imageIO
from sparkdl_tpu_torch.ml.linalg import DenseVector
from sparkdl_tpu_torch.models import registry
from sparkdl_tpu_torch.models.inception_v3 import InceptionV3
from sparkdl_tpu_torch.sql.session import TorchSession
from sparkdl_tpu_torch.transformers import named_image
from sparkdl_tpu_torch.transformers import utils
from sparkdl_tpu_torch.utils.metrics import metrics
from test_torch_inception import flax_inception_tree

STAGE_TOL = dict(rtol=1e-4, atol=1e-4)
# jax.image.resize on the CPU against a float64 product of its own weights:
# up to 3.1e-3 on a 0-255 scale (measured: its einsum is not exact float32);
# the port's resize is within 3e-5 of that float64 product
RESIZE_VS_JAX_ATOL = 5e-3
RESIZE_VS_F64_ATOL = 1e-4


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
def tree():
    return flax_inception_tree(seed=1)


def _images(sizes, seed=0):
    """Stored-BGR uint8 images, red- or blue-dominant by index parity."""
    rng = np.random.RandomState(seed)
    out = []
    for i, hw in enumerate(sizes):
        img = rng.randint(0, 80, (*hw, 3)).astype(np.uint8)
        img[..., 2 if i % 2 else 0] += 120
        out.append(img)
    return out


def _frames(tpu_session, images, n_parts=1):
    """The same rows as a port DataFrame and a JAX DataFrame."""
    port = [imageIO.imageArrayToStruct(img, origin=f"img{i}")
            for i, img in enumerate(images)]
    jax_rows = [jax_imageIO.imageArrayToStruct(img, origin=f"img{i}")
                for i, img in enumerate(images)]
    session = TorchSession.builder.getOrCreate()
    return (session.createDataFrame([{"image": r} for r in port], numPartitions=n_parts),
            tpu_session.createDataFrame([{"image": r} for r in jax_rows],
                                        numPartitions=n_parts))


def _vectors(rows, col):
    return np.stack([r[col].toArray() for r in rows])


@pytest.mark.parametrize("sizes", [
    [(48, 64)] * 3,
    [(48, 64), (331, 300), (299, 299)],
], ids=["one_size_uint8", "mixed_sizes_resized_while_packing"])
def test_featurizer_matches_jax(tpu_session, tree, sizes):
    port_df, jax_df = _frames(tpu_session, _images(sizes))
    args = dict(inputCol="image", outputCol="features", modelName="InceptionV3",
                modelWeights=tree, computeDtype="float32", batchSize=2)
    want = JaxFeaturizer(**args).transform(jax_df).collect()
    rows_before = metrics.counter("sparkdl.rows_processed").value
    got = DeepImageFeaturizer(**args, device="cpu").transform(port_df).collect()
    assert metrics.counter("sparkdl.rows_processed").value == rows_before + len(sizes)
    assert [r["image"]["origin"] for r in got] == [f"img{i}" for i in range(len(sizes))]
    assert all(isinstance(r["features"], DenseVector) for r in got)
    np.testing.assert_allclose(_vectors(got, "features"), _vectors(want, "features"),
                               **STAGE_TOL)
    assert _vectors(got, "features").shape == (len(sizes), 2048)


@pytest.fixture(scope="module")
def predictor_frames(tpu_session):
    return _frames(tpu_session, _images([(40, 40)] * 2, seed=2))


def test_predictor_probabilities_match_jax(tree, predictor_frames):
    port_df, jax_df = predictor_frames
    args = dict(inputCol="image", outputCol="preds", modelName="InceptionV3",
                modelWeights=tree, computeDtype="float32")
    want = _vectors(JaxPredictor(**args).transform(jax_df).collect(), "preds")
    got = _vectors(DeepImagePredictor(**args, device="cpu").transform(port_df).collect(),
                   "preds")
    assert got.shape == (2, 1000)
    np.testing.assert_allclose(got.sum(axis=1), 1.0, rtol=1e-6)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-7)


def test_predictor_top_k_decode_matches_jax(tree, predictor_frames):
    port_df, jax_df = predictor_frames
    args = dict(inputCol="image", outputCol="preds", modelName="InceptionV3",
                modelWeights=tree, computeDtype="float32", decodePredictions=True,
                topK=3)
    want = JaxPredictor(**args).transform(jax_df).collect()
    got = DeepImagePredictor(**args, device="cpu").transform(port_df).collect()
    for g, w in zip(got, want):
        assert [e["class"] for e in g["preds"]] == [e["class"] for e in w["preds"]]
        assert [e["description"] for e in g["preds"]] == [
            e["description"] for e in w["preds"]]
        np.testing.assert_allclose([e["probability"] for e in g["preds"]],
                                   [e["probability"] for e in w["preds"]], rtol=1e-4)


def test_decode_predictions_matches_jax():
    preds = np.random.default_rng(3).random((3, 1000))
    assert registry.decode_predictions(preds, top=4) == \
        jax_registry.decode_predictions(preds, top=4)
    small = np.random.default_rng(4).random((2, 7))
    assert registry.decode_predictions(small, top=2) == \
        jax_registry.decode_predictions(small, top=2)


def test_featurizer_reuses_its_module_across_transforms(tree, predictor_frames):
    port_df, _ = predictor_frames
    stage = DeepImageFeaturizer(inputCol="image", outputCol="f", modelName="InceptionV3",
                                modelWeights=tree, computeDtype="float32", device="cpu")
    first = stage._build_forward(torch.device("cpu"))
    assert stage.copy()._build_forward(torch.device("cpu")) is first
    other = stage.copy({stage.computeDtype: "bfloat16"})
    assert other._build_forward(torch.device("cpu")) is not first


# -- the input half -------------------------------------------------------

@pytest.mark.parametrize("src,dst", [
    ((96, 96), (299, 299)), ((331, 300), (299, 299)), ((48, 64), (75, 90)),
], ids=["upscale", "downscale", "non_square"])
def test_resize_matches_jax_image_resize(src, dst):
    x = np.random.default_rng(5).uniform(0, 255, (2, *src, 3)).astype(np.float32)
    for n_in, n_out in zip(src, dst):
        # the same float32 algorithm; its sums may round in another order
        np.testing.assert_allclose(
            utils.resize_weights(n_in, n_out),
            np.asarray(compute_weight_mat(n_in, n_out, n_out / n_in, 0.0,
                                          _fill_triangle_kernel, True)),
            rtol=1e-6, atol=1e-7,
        )
    got = utils.resize_bilinear(torch.from_numpy(x), dst).numpy()
    want = np.asarray(jax.image.resize(x, (2, *dst, 3), "bilinear"))
    wh, ww = (utils.resize_weights(a, b).astype(np.float64) for a, b in zip(src, dst))
    exact = np.einsum("nhwc,hk->nkwc", x.astype(np.float64), wh)
    exact = np.einsum("nkwc,wl->nklc", exact, ww)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, exact, rtol=0, atol=RESIZE_VS_F64_ATOL)
    np.testing.assert_allclose(got, want, rtol=0, atol=RESIZE_VS_JAX_ATOL)


def test_cast_and_resize_matches_jax():
    x = np.random.default_rng(6).integers(0, 256, (2, 40, 50, 3), dtype=np.uint8)
    got = utils.cast_and_resize_on_device(torch.from_numpy(x), (60, 60))
    want = np.asarray(jax_utils.cast_and_resize_on_device(jnp.asarray(x), (60, 60)))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=RESIZE_VS_JAX_ATOL)
    same = utils.cast_and_resize_on_device(torch.from_numpy(x), (40, 50))
    np.testing.assert_array_equal(same.numpy(), x.astype(np.float32))


def _struct_rows(images, module):
    return [module.imageArrayToStruct(img) for img in images]


@pytest.mark.parametrize("case", ["uint8_one_size", "float_mixed", "gray_and_rgba"])
def test_decode_image_batch_matches_jax(case):
    rng = np.random.default_rng(7)
    if case == "uint8_one_size":
        images = [rng.integers(0, 256, (9, 11, 3), dtype=np.uint8) for _ in range(3)]
    elif case == "float_mixed":
        images = [rng.random((9, 11, 3), dtype=np.float32) * 255,
                  rng.random((14, 6, 3), dtype=np.float32) * 255]
    else:
        images = [rng.integers(0, 256, (9, 11), dtype=np.uint8),
                  rng.integers(0, 256, (9, 11, 4), dtype=np.uint8)]
    port_rows = _struct_rows(images, imageIO)
    jax_rows = _struct_rows(images, jax_imageIO)
    got = utils.make_image_decode_plan(port_rows, (12, 12), device="cpu")(port_rows)
    want = jax_utils.make_image_decode_plan(jax_rows, 3, (12, 12))(jax_rows)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_allclose(got.astype(np.float32), want.astype(np.float32),
                               rtol=0, atol=1e-3)


def test_mixed_sizes_error_where_jax_raises():
    images = [np.zeros((4, 4, 3), np.uint8), np.zeros((5, 4, 3), np.uint8)]
    port, ref = _struct_rows(images, imageIO), _struct_rows(images, jax_imageIO)
    calls = [
        (lambda: utils.make_image_decode_plan(port, None, device="cpu"),
         lambda: jax_utils.make_image_decode_plan(ref, 3, None)),
        (lambda: utils.decode_image_batch(port, None, device="cpu"),
         lambda: jax_utils.decode_image_batch(ref, 3, None)),
    ]
    for got, want in calls:
        with pytest.raises(jax_utils.MixedImageSizesError, match="mixes image sizes"):
            want()
        with pytest.raises(utils.MixedImageSizesError, match="mixes image sizes"):
            got()
    assert utils.decode_image_batch(port[:1], None, device="cpu").shape == (1, 4, 4, 3)
    assert jax_utils.decode_image_batch(ref[:1], 3, None).shape == (1, 4, 4, 3)


@pytest.mark.parametrize("call", ["device_resize", "decode_image_batch",
                                  "make_image_decode_plan"])
def test_decode_and_resize_default_to_the_card(call, monkeypatch):
    """``device=None`` means the card, as in every entry point: without one
    the call raises, and the CPU is taken only when named."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    images = [np.zeros((4, 4, 3), np.float32), np.zeros((5, 4, 3), np.float32)]
    rows = _struct_rows([img.astype(np.uint8) for img in images], imageIO)
    fn = {
        "device_resize": lambda **kw: utils.device_resize(images, (6, 6), **kw),
        "decode_image_batch": lambda **kw: utils.decode_image_batch(rows, (6, 6), **kw),
        "make_image_decode_plan":
            lambda **kw: utils.make_image_decode_plan(rows, (6, 6), **kw)(rows),
    }[call]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fn()
    assert fn(device="cpu").shape == (2, 6, 6, 3)


def test_device_resize_advances_its_timer():
    before = metrics.timer("sparkdl.resize").seconds
    out = utils.device_resize([np.ones((3, 3, 3), np.float32),
                               np.ones((5, 5, 3), np.float32)], (5, 5), device="cpu")
    assert out.shape == (2, 5, 5, 3) and metrics.timer("sparkdl.resize").seconds > before
    np.testing.assert_allclose(out, 1.0, rtol=1e-6)


@pytest.mark.parametrize("img", [
    np.arange(24, dtype=np.uint8).reshape(2, 4, 3),
    np.arange(8, dtype=np.uint8).reshape(2, 4),
    np.linspace(0, 1, 32, dtype=np.float32).reshape(2, 4, 4),
], ids=["bgr_uint8", "gray_uint8", "bgra_float32"])
def test_image_structs_match_jax(img):
    got = imageIO.imageArrayToStruct(img, origin="o")
    want = jax_imageIO.imageArrayToStruct(img, origin="o")
    assert got.asDict() == want.asDict()
    np.testing.assert_array_equal(imageIO.imageStructToArray(got),
                                  jax_imageIO.imageStructToArray(want))
    if img.ndim == 3:
        rgb = imageIO.rgbArrayToStruct(img)
        np.testing.assert_array_equal(imageIO.imageStructToRGBArray(rgb), img)
        assert rgb.asDict() == jax_imageIO.rgbArrayToStruct(img).asDict()


def test_image_type_table_matches_jax():
    assert imageIO.ocvTypes == jax_imageIO.ocvTypes
    assert imageIO.imageType.byName("CV_8UC3").ord == 16
    with pytest.raises(ValueError, match="Unsupported image array"):
        imageIO.imageType.forArray(np.zeros((2, 2, 2), np.uint8))


def test_read_images_matches_jax(tpu_session, image_dir):
    got = imageIO.readImages(image_dir, numPartitions=2).collect()
    want = jax_imageIO.readImages(image_dir, tpu_session, numPartitions=2).collect()
    assert [r["filePath"] for r in got] == [r["filePath"] for r in want]
    for g, w in zip(got, want):
        assert g["image"].asDict() == w["image"].asDict()


# -- weights and device ---------------------------------------------------

def test_imagenet_weights_raise_without_a_cache(monkeypatch, tmp_path):
    """Without Keras's cache file, ``"imagenet"`` (and the default) raise as
    the JAX package does; a file of another model, or a ``_notop`` one,
    does not count (the weights read from a cache file:
    ``tests/test_torch_imagenet_cache.py``)."""
    monkeypatch.setenv("HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="imagenet weights for InceptionV3"):
        named_image._resolve_weights("InceptionV3", None)
    cache = tmp_path / ".keras" / "models"
    cache.mkdir(parents=True)
    (cache / "inception_v3_weights_tf_dim_ordering_tf_kernels_notop.h5").write_bytes(b"")
    (cache / named_image.IMAGENET_FILES["ResNet50"]).write_bytes(b"")
    with pytest.raises(RuntimeError, match="imagenet weights for InceptionV3"):
        named_image._resolve_weights("InceptionV3", "imagenet")


def test_keras_model_weights_are_not_accepted_yet():
    """Built Keras models are accepted now (ported in numpy, never importing
    Keras); an object that is neither a tree nor a model (no ``layers``)
    raises ``TypeError``."""
    class KerasLike:
        pass

    with pytest.raises(TypeError, match="built Keras model"):
        named_image._resolve_weights("InceptionV3", KerasLike())
    keras = pytest.importorskip("keras")
    km = keras.applications.InceptionV3(weights=None, include_top=False,
                                        input_shape=(75, 75, 3))
    state = named_image._resolve_weights("InceptionV3", km)
    assert state.keys() == InceptionV3(num_classes=None).state_dict().keys()
    assert named_image._resolve_weights("InceptionV3", km) is state


def test_random_weights_are_seeded_and_scaled():
    a = named_image.random_state_dict(InceptionV3(), seed=0)
    b = named_image.random_state_dict(InceptionV3(), seed=0)
    assert a.keys() == b.keys() == InceptionV3().state_dict().keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    stem = a["conv2d.weight"]
    assert abs(stem.std().item() - (1 / 27) ** 0.5) < 0.03
    assert stem.abs().max().item() <= 2 * (1 / 27) ** 0.5 / 0.87962566103423978 + 1e-6
    assert torch.equal(a["batch_normalization_3.var"], torch.ones(80))
    assert torch.equal(a["batch_normalization_3.bias"], torch.zeros(80))
    assert named_image._resolve_weights("InceptionV3", "random") is \
        named_image._resolve_weights("InceptionV3", "random")


def test_default_device_without_cuda_raises(monkeypatch, predictor_frames, tree):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    port_df, _ = predictor_frames
    stage = DeepImageFeaturizer(inputCol="image", outputCol="f",
                                modelName="InceptionV3", modelWeights=tree)
    assert stage.getDevice() is None
    assert stage.getOrDefault(stage.computeDtype) == "bfloat16"
    assert stage.getOrDefault(stage.batchSize) == 32
    with pytest.raises(RuntimeError, match="device='cpu'"):
        stage.transform(port_df)


def test_unknown_model_and_dtype_raise(tree, predictor_frames):
    port_df, _ = predictor_frames
    with pytest.raises(ValueError, match="Unsupported model name"):
        DeepImageFeaturizer(inputCol="image", outputCol="f", modelName="AlexNet",
                            device="cpu").transform(port_df)
    with pytest.raises(ValueError, match="computeDtype"):
        DeepImageFeaturizer(inputCol="image", outputCol="f", modelName="InceptionV3",
                            modelWeights=tree, computeDtype="float16",
                            device="cpu").transform(port_df)
