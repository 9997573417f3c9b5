"""The port's ``DeepImageFeaturizer`` / ``DeepImagePredictor`` over the rest
of the CNN zoo against the JAX package's stages, on the CPU.

- ResNet50 ("caffe": the BGR flip in the forward) and MobileNetV2 ("tf":
  the flip folded into the stem) at their 224x224 input, features,
  probabilities and the top-5 decode, on the same Flax tree and 2 images,
  in float32 to the module bound (``rtol=atol=1e-4``);
- VGG16 featurized at 224 (fc1 at 25088 inputs, Flax's flatten order) from
  a tree without ``predictions``, which the JAX package featurizes too;
- Xception from a 728-wide tree, which both packages pad to the registry's
  768-wide module.

``tests/test_torch_zoo_weights.py`` holds the other ``modelWeights``.
"""

import numpy as np
import pytest
import torch

from sparkdl_tpu import DeepImageFeaturizer as JaxFeaturizer
from sparkdl_tpu import DeepImagePredictor as JaxPredictor
from sparkdl_tpu.models.mobilenet_v2 import MobileNetV2 as FlaxMobileNetV2
from sparkdl_tpu.models.resnet import ResNet50 as FlaxResNet50
from sparkdl_tpu.models.vgg import VGG16 as FlaxVGG16
from sparkdl_tpu.models.xception import Xception as FlaxXception
from sparkdl_tpu_torch import DeepImageFeaturizer, DeepImagePredictor
from sparkdl_tpu_torch.models import registry
from test_torch_named_image import _frames, _images, _vectors
from test_torch_zoo import flax_tree

STAGE_TOL = dict(rtol=1e-4, atol=1e-4)

FLAX = {"ResNet50": (FlaxResNet50(), 224), "MobileNetV2": (FlaxMobileNetV2(), 224),
        "VGG16": (FlaxVGG16(), 224), "Xception": (FlaxXception(middle_width=728), 299)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _no_compile_cache(monkeypatch):
    monkeypatch.setenv("SPARKDL_COMPILE_CACHE", "off")


# the stem convs of the "caffe" models, whose inputs stay at +-128
CAFFE_STEMS = {"ResNet50": "conv1_conv", "VGG16": "block1_conv1"}


@pytest.fixture(scope="module")
def trees():
    """``test_torch_zoo.flax_tree`` at the input sizes; a "caffe" model's
    stem kernel at 1/128 of it, as if its inputs were scaled to unit order
    like "tf" ones, so that its features are of unit order too (VGG16's
    reach 600 otherwise, and the float32 rounding of both packages, 2e-6 of
    that, is above ``atol=1e-4``)."""
    out = {}
    for i, (name, (module, size)) in enumerate(FLAX.items()):
        tree = flax_tree(module, size, seed=10 + i)
        if name in CAFFE_STEMS:
            stem = tree["params"][CAFFE_STEMS[name]]
            stem["kernel"] = stem["kernel"] / np.float32(128)
        if name == "VGG16":  # featurizing reads fc2: a tree without predictions
            tree = {"params": {k: v for k, v in tree["params"].items()
                               if k != "predictions"}}
        out[name] = tree
    return out


@pytest.fixture(scope="module")
def frames(tpu_session):
    return _frames(tpu_session, _images([(48, 64)] * 2, seed=5))


def _args(name, tree, **kw):
    return dict(inputCol="image", modelName=name, modelWeights=tree,
                computeDtype="float32", **kw)


@pytest.mark.parametrize("name", ["ResNet50", "MobileNetV2", "VGG16", "Xception"])
def test_featurizer_matches_jax(trees, frames, name):
    port_df, jax_df = frames
    args = _args(name, trees[name], outputCol="features")
    want = _vectors(JaxFeaturizer(**args).transform(jax_df).collect(), "features")
    got = _vectors(DeepImageFeaturizer(**args, device="cpu").transform(port_df).collect(),
                   "features")
    width = registry.get_keras_application_model(name).feature_size
    assert got.shape == want.shape == (2, width)
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, **STAGE_TOL)


@pytest.mark.parametrize("name", ["ResNet50", "MobileNetV2"])
def test_predictor_matches_jax(trees, frames, name):
    port_df, jax_df = frames
    args = _args(name, trees[name], outputCol="preds")
    want = _vectors(JaxPredictor(**args).transform(jax_df).collect(), "preds")
    got = _vectors(DeepImagePredictor(**args, device="cpu").transform(port_df).collect(),
                   "preds")
    assert got.shape == (2, 1000)
    np.testing.assert_allclose(got.sum(axis=1), 1.0, rtol=1e-6)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-7)
    decode = dict(decodePredictions=True, topK=5)
    want_top = JaxPredictor(**args, **decode).transform(jax_df).collect()
    got_top = DeepImagePredictor(**args, **decode, device="cpu").transform(port_df).collect()
    for g, w in zip(got_top, want_top):
        assert len(g["preds"]) == 5
        assert [e["class"] for e in g["preds"]] == [e["class"] for e in w["preds"]]
        np.testing.assert_allclose([e["probability"] for e in g["preds"]],
                                   [e["probability"] for e in w["preds"]],
                                   rtol=1e-4, atol=1e-7)


def test_predictor_needs_the_predictions_layer(trees, frames):
    port_df, _ = frames
    with pytest.raises(ValueError, match="without its predictions layer"):
        DeepImagePredictor(**_args("VGG16", trees["VGG16"], outputCol="p"),
                           device="cpu").transform(port_df)


def test_vgg_tree_without_its_top_cannot_featurize(trees, frames):
    port_df, _ = frames
    convs = {"params": {k: v for k, v in trees["VGG16"]["params"].items()
                        if k.startswith("block")}}
    with pytest.raises(ValueError, match="cut point is the fc2 output"):
        DeepImageFeaturizer(**_args("VGG16", convs, outputCol="f"),
                            device="cpu").transform(port_df)
