"""``modelWeights="imagenet"`` from Keras's cache, without Keras.

Offline, under a temporary ``HOME``: each test builds
``keras.applications.<Model>(weights=None)`` (Keras on JAX, in the test
only), draws seeded batch-norm weights so that no two layers hold the same
numbers, and writes the model's weights into ``~/.keras/models/`` under the
exact file name the constructor with its top opens, with Keras's own legacy
writer (``save_weights_to_hdf5_group`` into an ``h5py.File``). Keras's
``get_file`` checks a file hash and would try a download, so the JAX
package's ``"imagenet"`` path is not the oracle here. The oracle is a fresh
Keras model of the same class after Keras's ``load_weights`` of that file,
ported as a built Keras model is: the two ``state_dict`` s must be equal
bit for bit (both go through the same numpy port), and the features
through ``DeepImageFeaturizer`` equal at tests/test_ops.py's ViT tolerance.
InceptionV3 (batch norm without scale), MobileNetV2 (depthwise convs,
224x224) and Xception (separable convs; 728 wide in Keras, padded to the
registry's 768) cover every layer class the registry's files hold.
"""

import os

import numpy as np
import pytest
import torch

keras = pytest.importorskip("keras")
h5py = pytest.importorskip("h5py")

from keras.src.legacy.saving.legacy_h5_format import (  # noqa: E402
    save_weights_to_hdf5_group,
)

from sparkdl_tpu_torch import DeepImageFeaturizer  # noqa: E402
from sparkdl_tpu_torch.image import imageIO  # noqa: E402
from sparkdl_tpu_torch.models.keras_model import (  # noqa: E402
    read_keras_file,
    read_keras_model,
    read_legacy_weights,
    write_legacy_weights,
)
from sparkdl_tpu_torch.sql.session import TorchSession  # noqa: E402
from sparkdl_tpu_torch.transformers import named_image  # noqa: E402
from sparkdl_tpu_torch.utils.lru import LRUCache  # noqa: E402

SLICE_TOL = dict(atol=5e-4, rtol=5e-3)  # tests/test_ops.py's ViT tolerance

#: the file each constructor with its top opens, copied from Keras 3.13's
#: keras/src/applications/{inception_v3,mobilenet_v2,xception}.py
KERAS_FILES = {
    "InceptionV3": "inception_v3_weights_tf_dim_ordering_tf_kernels.h5",
    "MobileNetV2": "mobilenet_v2_weights_tf_dim_ordering_tf_kernels_1.0_224.h5",
    "Xception": "xception_weights_tf_dim_ordering_tf_kernels.h5",
    "ResNet50": "resnet50_weights_tf_dim_ordering_tf_kernels.h5",
    "VGG16": "vgg16_weights_tf_dim_ordering_tf_kernels.h5",
    "VGG19": "vgg19_weights_tf_dim_ordering_tf_kernels.h5",
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture()
def home(tmp_path, monkeypatch):
    """A temporary HOME with an empty Keras cache directory."""
    monkeypatch.setenv("HOME", str(tmp_path))
    cache = tmp_path / ".keras" / "models"
    cache.mkdir(parents=True)
    # a cache of this test's own: the ported files stay out of later tests
    monkeypatch.setattr(named_image, "_WEIGHTS_CACHE", LRUCache(4))
    return cache


def _keras_model(name: str, seed: int):
    """The Keras application with its top, its batch-norm weights drawn
    from ``seed``."""
    keras.utils.set_random_seed(seed)
    model = getattr(keras.applications, name)(weights=None, classifier_activation=None)
    rng = np.random.RandomState(seed)
    for layer in model.layers:
        if type(layer).__name__ == "BatchNormalization":
            arrays = []
            for w in layer.weights:
                var = w.path.rsplit("/", 1)[-1]
                shape = tuple(w.shape)
                if var in ("gamma", "moving_variance"):
                    arrays.append(rng.uniform(0.5, 1.5, shape).astype(np.float32))
                else:
                    arrays.append((0.1 * rng.standard_normal(shape)).astype(np.float32))
            layer.set_weights(arrays)
    return model


def _write_cache_file(model, path):
    with h5py.File(path, "w") as f:
        save_weights_to_hdf5_group(f, model)


def _frame(size, n=2, seed=0):
    rng = np.random.RandomState(seed)
    rows = [{"image": imageIO.imageArrayToStruct(rng.randint(0, 255, (size, size, 3))
                                                  .astype(np.uint8))} for _ in range(n)]
    return TorchSession.builder.getOrCreate().createDataFrame(rows)


def _features(weights, name, df):
    stage = DeepImageFeaturizer(inputCol="image", outputCol="f", modelName=name,
                                modelWeights=weights, computeDtype="float32", device="cpu")
    return np.stack([r["f"].toArray() for r in stage.transform(df).collect()])


@pytest.mark.parametrize("name,size", [("InceptionV3", 299), ("MobileNetV2", 224),
                                       ("Xception", 299)])
def test_imagenet_from_the_cache_equals_keras_load_weights(home, name, size):
    _write_cache_file(_keras_model(name, seed=1), home / KERAS_FILES[name])
    oracle = _keras_model(name, seed=2)  # other numbers until load_weights
    oracle.load_weights(str(home / KERAS_FILES[name]))
    got = named_image._resolve_weights(name, "imagenet")
    want = named_image._resolve_weights(name, oracle)
    assert set(got) == set(want)
    for key in want:
        assert torch.equal(got[key], want[key]), key
    if name == "Xception":  # the registry's 768-wide middle flow, zero-padded
        assert got["block5_sepconv1.pointwise_kernel"].shape[0] == 768
    df = _frame(size)
    feats = _features("imagenet", name, df)
    assert feats.shape == (2, 2048 if name != "MobileNetV2" else 1280)
    np.testing.assert_allclose(feats, _features(oracle, name, df), **SLICE_TOL)
    # the default is "imagenet" too, and the ported weights are cached per file
    assert named_image._resolve_weights(name, None) is got


def test_registry_file_names_are_keras_names():
    assert named_image.IMAGENET_FILES == KERAS_FILES


def test_no_file_or_a_notop_file_alone_raises(home):
    with pytest.raises(RuntimeError, match="imagenet weights for MobileNetV2"):
        named_image._resolve_weights("MobileNetV2", "imagenet")
    notop = KERAS_FILES["MobileNetV2"].replace("_224.h5", "_224_no_top.h5")
    (home / notop).write_bytes(b"not opened")
    (home / KERAS_FILES["InceptionV3"].replace(".h5", "_notop.h5")).write_bytes(b"x")
    for name in ("MobileNetV2", "InceptionV3"):
        with pytest.raises(RuntimeError, match=f"imagenet weights for {name}"):
            named_image._resolve_weights(name, None)


def test_a_full_model_file_of_that_name_reads_too(home, tmp_path):
    """A legacy ``.h5`` model (``model_config`` and ``model_weights``) under
    the cache's name reads through its ``model_weights`` group, as Keras's
    ``load_weights`` reads it, and still reads whole with
    ``read_keras_file``."""
    model = _keras_model("MobileNetV2", seed=3)
    path = home / KERAS_FILES["MobileNetV2"]
    model.save(str(path))
    got = named_image._resolve_weights("MobileNetV2", "imagenet")
    want = named_image._resolve_weights("MobileNetV2", model)
    for key in want:
        assert torch.equal(got[key], want[key]), key
    config, weights = read_keras_file(str(path))
    assert config["class_name"] == "Functional"
    np.testing.assert_array_equal(weights["Conv1"][0], model.get_layer("Conv1").get_weights()[0])


def test_the_ports_writer_is_read_by_keras(tmp_path):
    """``write_legacy_weights`` (no h5py) writes what Keras's
    ``load_weights`` and h5py read, and the port reads it back array for
    array."""
    model = _keras_model("MobileNetV2", seed=4)
    config, weights = read_keras_model(model)
    path = str(tmp_path / "weights.h5")
    write_legacy_weights(path, config, weights)
    with h5py.File(path, "r") as f:
        names = [n.decode() if isinstance(n, bytes) else n for n in f.attrs["layer_names"]]
        assert names == [layer.name for layer in model.layers]
    other = _keras_model("MobileNetV2", seed=5)
    other.load_weights(path)
    for a, b in zip(model.get_weights(), other.get_weights()):
        np.testing.assert_array_equal(a, b)
    for layer_name, pairs in read_legacy_weights(path):
        assert [a.shape for _, a in pairs] == [np.shape(w) for w in weights[layer_name]]
        for (_, a), w in zip(pairs, weights[layer_name]):
            np.testing.assert_array_equal(a, w)


def test_cache_is_read_from_home_only(home):
    assert named_image.imagenet_cache_file("ResNet50") is None
    path = home / KERAS_FILES["ResNet50"]
    path.write_bytes(b"")
    assert named_image.imagenet_cache_file("ResNet50") == os.path.join(
        os.environ["HOME"], ".keras", "models", KERAS_FILES["ResNet50"])


def test_keras2_weight_names_read_alike(home):
    """The files Keras downloads were written by Keras 2: weight names end
    in ``:0`` and a depthwise conv's kernel is ``depthwise_kernel``. Such a
    file (MobileNetV2's layers, written with h5py) ports to the same
    weights as Keras 3's naming."""
    model = _keras_model("MobileNetV2", seed=6)
    with h5py.File(home / KERAS_FILES["MobileNetV2"], "w") as f:
        f.attrs["layer_names"] = np.array([layer.name.encode() for layer in model.layers])
        for layer in model.layers:
            group = f.create_group(layer.name)
            names = []
            for w in layer.weights:
                var = w.path.rsplit("/", 1)[-1]
                if type(layer).__name__ == "DepthwiseConv2D" and var == "kernel":
                    var = "depthwise_kernel"
                names.append(f"{layer.name}/{var}:0".encode())
                group.create_dataset(names[-1], data=np.asarray(w.numpy()))
            group.attrs["weight_names"] = np.array(names)
    got = named_image._resolve_weights("MobileNetV2", "imagenet")
    want = named_image._resolve_weights("MobileNetV2", model)
    for key in want:
        assert torch.equal(got[key], want[key]), key
