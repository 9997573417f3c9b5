"""``modelWeights`` of the port's named-CNN stages over the whole zoo, on
the CPU: every model's ``"random"`` weights (features neither all zero nor
infinite; BN scales drawn as ones, as Flax initialises them), a
built Keras model (ported in numpy, as the JAX package ports it), and the
caches that make a repeated transform reuse its ported tree and its module.
"""

import numpy as np
import pytest
import torch

from sparkdl_tpu.models import keras_port as jax_keras_port
from sparkdl_tpu.models.xception import Xception as FlaxXception
from sparkdl_tpu_torch import DeepImageFeaturizer
from sparkdl_tpu_torch.models import registry
from sparkdl_tpu_torch.transformers import named_image
from test_torch_named_image import _frames, _images, _vectors
from test_torch_zoo import flax_tree


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
def frames(tpu_session):
    return _frames(tpu_session, _images([(48, 64)] * 2, seed=5))


@pytest.mark.parametrize("name", list(registry.SUPPORTED_MODELS))
def test_random_weights_featurize_every_model(frames, name):
    port_df, _ = frames
    rows = DeepImageFeaturizer(inputCol="image", outputCol="f", modelName=name,
                               modelWeights="random", device="cpu").transform(port_df).collect()
    feats = _vectors(rows, "f")
    assert feats.shape == (2, registry.get_keras_application_model(name).feature_size)
    assert np.isfinite(feats).all() and np.abs(feats).max() > 0
    state = named_image._resolve_weights(name, "random")
    scales = [k for k in state if k.endswith(".scale")]
    assert all(torch.equal(state[k], torch.ones_like(state[k])) for k in scales)
    assert bool(scales) == (name not in ("InceptionV3", "VGG16", "VGG19"))


def test_repeated_transforms_reuse_the_ported_tree_and_module():
    """A 728-wide Xception tree pads once per object: the same tree gives
    the same state_dict, hence the same cached module."""
    tree = flax_tree(FlaxXception(middle_width=728), 71, seed=4)
    state = named_image._resolve_weights("Xception", tree)
    assert named_image._resolve_weights("Xception", tree) is state
    assert state["block5_sepconv1.pointwise_kernel"].shape == (768, 768, 1, 1)
    stage = DeepImageFeaturizer(inputCol="image", outputCol="f", modelName="Xception",
                                modelWeights=tree, computeDtype="float32", device="cpu")
    first = stage._build_forward(torch.device("cpu"))
    assert stage.copy()._build_forward(torch.device("cpu")) is first
    copy = {"params": dict(tree["params"]), "batch_stats": dict(tree["batch_stats"])}
    assert named_image._resolve_weights("Xception", copy) is not state


def test_a_built_keras_model_is_ported_once(frames):
    """A Keras model's weights featurize as the JAX package's port of the
    same model does, through the port's own numpy port, once per model."""
    keras = pytest.importorskip("keras")
    keras.utils.set_random_seed(3)
    km = keras.applications.MobileNetV2(weights=None, input_shape=(64, 64, 3))
    port_df, _ = frames
    state = named_image._resolve_weights("MobileNetV2", km)
    assert named_image._resolve_weights("MobileNetV2", km) is state
    tree = jax_keras_port.port_keras_weights(km)
    args = dict(inputCol="image", outputCol="f", modelName="MobileNetV2",
                computeDtype="float32", device="cpu")
    got = _vectors(DeepImageFeaturizer(**args, modelWeights=km).transform(port_df).collect(), "f")
    want = _vectors(DeepImageFeaturizer(**args, modelWeights=tree).transform(port_df).collect(),
                    "f")
    np.testing.assert_array_equal(got, want)
