"""The port's Keras weight porting against the JAX package's, on the CPU.

Keras models are built here with ``weights=None`` at small inputs (the
porting map is under test, not the values); the port reads them duck-typed
and never imports Keras itself:

- ``port_keras_weights`` gives the JAX package's tree leaf for leaf, and
  ``normalized_layer_names`` its names (Xception's auto-named projections
  ``conv2d`` .. ``conv2d_3`` among them);
- ``pad_variables_to_module`` pads a 728-wide Xception tree to the 768-wide
  port module as the JAX one pads it to the 768-wide Flax module, bit for
  bit;
- a ported tree, carried to the port's module, gives the Keras model's own
  outputs (``tests/test_models.py``'s Keras-oracle bound, 1e-4).
"""

import numpy as np
import pytest
import torch

import jax

from sparkdl_tpu.models import keras_port as jax_keras_port
from sparkdl_tpu.models.xception import Xception as FlaxXception
from sparkdl_tpu_torch.models import keras_port, registry
from sparkdl_tpu_torch.models.convert import cnn_state_dict_from_flax
from sparkdl_tpu_torch.models.xception import Xception

keras = pytest.importorskip("keras")

# name -> (keras constructor kwargs): small inputs; MobileNetV2 keeps its
# top, so the Dense is ported too
KERAS_MODELS = {
    "ResNet50": dict(include_top=False, input_shape=(64, 64, 3)),
    "VGG16": dict(include_top=False, input_shape=(64, 64, 3)),
    "VGG19": dict(include_top=False, input_shape=(64, 64, 3)),
    "MobileNetV2": dict(include_top=True, input_shape=(64, 64, 3)),
    "Xception": dict(include_top=False, input_shape=(71, 71, 3)),
    "InceptionV3": dict(include_top=False, input_shape=(75, 75, 3)),
}


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
def keras_models():
    return {}


def keras_model(name, cache):
    if name not in cache:
        keras.utils.set_random_seed(len(cache))
        cache[name] = getattr(keras.applications, name)(
            weights=None, classifier_activation=None, **KERAS_MODELS[name])
    return cache[name]


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(a)
            for p, a in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("name", list(KERAS_MODELS))
def test_port_keras_weights_matches_jax(keras_models, name):
    km = keras_model(name, keras_models)
    names = keras_port.normalized_layer_names(km)
    assert names == jax_keras_port.normalized_layer_names(km)
    got, want = keras_port.port_keras_weights(km), jax_keras_port.port_keras_weights(km)
    got_leaves, want_leaves = _leaves(got), _leaves(want)
    assert got_leaves.keys() == want_leaves.keys()
    for k in want_leaves:
        assert isinstance(got_leaves[k], np.ndarray)
        np.testing.assert_array_equal(got_leaves[k], want_leaves[k], err_msg=k)
    if name == "Xception":
        projections = {"conv2d", "conv2d_1", "conv2d_2", "conv2d_3",
                       "batch_normalization", "batch_normalization_3"}
        assert projections <= set(names.values())
        assert {"conv2d", "conv2d_3"} <= set(got["params"])


@pytest.mark.parametrize("name", ["ResNet50", "MobileNetV2", "Xception"])
def test_ported_keras_model_matches_keras(keras_models, name):
    """The Keras model's own outputs, from the port's module on the ported
    weights (Xception through the registry's 768-wide module)."""
    km = keras_model(name, keras_models)
    h, w, _ = KERAS_MODELS[name]["input_shape"]
    x = np.random.default_rng(0).uniform(-1, 1, (2, h, w, 3)).astype(np.float32)
    want = np.asarray(km(x, training=False))
    entry = registry.get_keras_application_model(name)
    state = entry.state_dict_from_flax(keras_port.port_keras_weights(km))
    head = state.get("predictions.weight")
    module = entry.module_for({k.split(".", 1)[0] for k in state},
                              None if head is None else head.shape[0])
    module.load_state_dict(state, strict=True)
    with torch.inference_mode():
        out = module.eval()(torch.from_numpy(x).permute(0, 3, 1, 2),
                            features_only=not KERAS_MODELS[name]["include_top"])
    if not KERAS_MODELS[name]["include_top"]:  # Keras's last map, averaged
        want = want.mean(axis=(1, 2))
    np.testing.assert_allclose(out.numpy(), want, rtol=1e-4, atol=1e-4)


def test_xception_padding_matches_jax(keras_models):
    variables = jax_keras_port.port_keras_weights(keras_model("Xception", keras_models))
    want = jax_keras_port.pad_variables_to_module(
        variables, FlaxXception(middle_width=768), (71, 71))
    with torch.device("meta"):
        wide = Xception(middle_width=768, num_classes=None)
    got = keras_port.pad_variables_to_module(
        jax.tree_util.tree_map(np.asarray, variables), wide)
    got_leaves, want_leaves = _leaves(got), _leaves(want)
    assert got_leaves.keys() == want_leaves.keys()
    for k in want_leaves:
        assert got_leaves[k].dtype == want_leaves[k].dtype
        np.testing.assert_array_equal(got_leaves[k], want_leaves[k], err_msg=k)
    assert got["params"]["block5_sepconv1"]["pointwise_kernel"].shape == (1, 1, 768, 768)
    assert np.all(got["batch_stats"]["block5_sepconv1_bn"]["var"][728:] == 1.0)
    # idempotent on a tree of the module's width, and it carries across
    again = keras_port.pad_variables_to_module(got, wide)
    for k, a in _leaves(again).items():
        np.testing.assert_array_equal(a, got_leaves[k])
    assert cnn_state_dict_from_flax(got, wide).keys() == wide.state_dict().keys()


def test_padding_refuses_what_the_module_cannot_hold():
    with torch.device("meta"):
        narrow = Xception(middle_width=728)
        wide = Xception(middle_width=768)
    stray = {"params": {"block1_conv1": {"kernel": np.zeros((3, 3, 3, 32), np.float32)},
                        "no_such_layer": {"kernel": np.zeros((1, 1, 2, 2), np.float32)}}}
    with pytest.raises(ValueError, match="no counterpart"):
        keras_port.pad_variables_to_module(stray, narrow)
    wide_leaf = {"params": {"block5_sepconv1": {
        "pointwise_kernel": np.zeros((1, 1, 768, 768), np.float32)}}}
    with pytest.raises(ValueError, match="narrower"):
        keras_port.pad_variables_to_module(wide_leaf, narrow)
    flat = {"params": {"block5_sepconv1": {"pointwise_kernel": np.zeros((728, 728), np.float32)}}}
    with pytest.raises(ValueError, match="rank mismatch"):
        keras_port.pad_variables_to_module(flat, wide)


def test_port_refuses_what_is_not_a_keras_model():
    with pytest.raises(TypeError, match="built Keras model"):
        keras_port.port_keras_weights(object())

    class Odd:
        name = "lstm"

        def get_weights(self):
            return [np.zeros(2)]

    class Model:
        layers = [Odd()]

    with pytest.raises(NotImplementedError, match="No porting rule .* of type Odd"):
        keras_port.port_keras_weights(Model())
