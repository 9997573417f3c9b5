"""The port's Keras models built from their configs (``sparkdl_tpu_torch.models.keras_model``,
through ``TorchFunction.from_keras``) held to Keras itself, on its JAX
backend, on the CPU.

Each layer family runs as a small Sequential and a small Functional model
with seeded random weights, read from a ``.keras`` file, a legacy ``.h5``
file and the model in memory, at float32 ``rtol=atol=1e-4``: convolutions
(TF ``'same'`` padding with stride 2 on even sizes, dilation, groups,
depthwise and separable kernels with a multiplier, with and without bias),
pooling (``'same'`` max pooling padding with -inf, average pooling leaving
the padding out of its count, every ``ZeroPadding2D`` form), batch norm
(with and without scale or center, its config's epsilon, on 4-D, 3-D and
2-D tensors), merges along the channel and spatial axes, ``Dense`` on a 4-D
tensor, ``Flatten`` / ``Reshape`` in NHWC order, and every activation with
the ``ReLU`` options. InceptionV3 (``weights=None``) at 75x75 runs from both
file formats; ``mixed_bfloat16`` within 3% of the largest output; a file
made by the port's writer loads in Keras with the same outputs; and the
committed InceptionV3 config is what this Keras builds.

Nested models (a Functional base in a Sequential, a Sequential block in a
Functional), with a frozen inner conv, run from all three sources at the
same tolerance; the legacy ``.h5`` lists such a model's weights trainable
first, so they are mapped by name. A legacy ``.h5`` whose ``layer_names`` and
``weight_names`` Keras split in chunks reads as Keras reads it, and a nested
model's weights written back by the port load in Keras bit for bit.
"""

import gzip
import json
from pathlib import Path
from types import SimpleNamespace

import h5py
import keras
import numpy as np
import pytest
import torch

from sparkdl_tpu.graph.function import XlaFunction
from sparkdl_tpu_torch.graph import TorchFunction
from sparkdl_tpu_torch.models.keras_model import (
    KerasModel,
    read_keras_file,
    read_keras_model,
    write_keras_file,
)

L = keras.layers
TOL = dict(rtol=1e-4, atol=1e-4)
BF16_MAX_REL = 3e-2
CONFIG_FIXTURE = Path(__file__).parent / "torch_fixtures" / "keras_inception_v3.config.json.gz"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _randomize(model, seed: int):
    """Seeded weights: N(0, 0.3) kernels and biases, BN scales near 1 and
    variances in [0.5, 1.5]."""
    rng = np.random.default_rng(seed)
    for layer in model.layers:
        values = []
        for var in layer.weights:
            shape, name = tuple(var.shape), var.path.rsplit("/", 1)[-1]
            if name == "moving_variance":
                values.append(rng.uniform(0.5, 1.5, shape))
            elif name == "gamma":
                values.append(1.0 + 0.2 * rng.standard_normal(shape))
            else:
                values.append(0.3 * rng.standard_normal(shape))
        if values:
            layer.set_weights([v.astype(np.float32) for v in values])
    return model


def _port(model_or_path, x, **kwargs) -> np.ndarray:
    fn = TorchFunction.from_keras(model_or_path, **kwargs)
    return fn(x, device="cpu").float().numpy()


def _keras(model, x) -> np.ndarray:
    return np.asarray(model(x, training=False)).astype(np.float32)


def _max_rel(got, want) -> float:
    return float(np.abs(got - want).max() / np.abs(want).max())


# -- the layer families ------------------------------------------------------

def _merge(x, branches):
    return L.Concatenate()([L.Flatten()(b(x)) for b in branches])


def _conv(functional: bool):
    if not functional:
        return (10, 12, 3), [
            L.Conv2D(4, 3, strides=2, padding="same", activation="relu"),
            L.DepthwiseConv2D(3, padding="same", depth_multiplier=2, dilation_rate=2,
                              activation="relu6"),
            L.SeparableConv2D(5, 3, strides=2, padding="same", depth_multiplier=2),
            L.Conv2D(6, (2, 3), use_bias=False),
            L.Flatten(),
            L.Dense(3),
        ]
    return (10, 12, 3), lambda x: _merge(x, [
        L.Conv2D(4, 3, strides=2, padding="same", activation="relu"),
        L.Conv2D(4, (3, 2), dilation_rate=(2, 1), use_bias=False),
        L.Conv2D(6, 3, padding="same", groups=3, dilation_rate=2),
        L.DepthwiseConv2D(3, strides=2, padding="same", depth_multiplier=2),
        L.DepthwiseConv2D(3, padding="same", dilation_rate=2, use_bias=False),
        L.SeparableConv2D(5, 3, strides=2, padding="same", depth_multiplier=2,
                          activation="relu"),
        L.SeparableConv2D(5, 3, padding="same", dilation_rate=2, use_bias=False),
    ])


def _pool(functional: bool):
    if not functional:
        return (10, 9, 3), [
            L.ZeroPadding2D(((1, 0), (2, 3))),
            L.MaxPooling2D(3, strides=2, padding="same"),
            L.AveragePooling2D(3, strides=1, padding="same"),
            L.ZeroPadding2D((1, 2)),
            L.AveragePooling2D((2, 3), strides=(2, 1)),
            L.ZeroPadding2D(1),
            L.MaxPooling2D(2),
            L.GlobalAveragePooling2D(),
        ]
    return (10, 9, 3), lambda x: _merge(x, [
        L.MaxPooling2D(3, strides=2, padding="same"),
        L.MaxPooling2D(2),
        L.AveragePooling2D(3, strides=1, padding="same"),
        L.AveragePooling2D(3, strides=2, padding="same"),
        L.AveragePooling2D((2, 3), strides=(2, 1)),
        L.ZeroPadding2D(1),
        L.ZeroPadding2D((1, 2)),
        L.ZeroPadding2D(((1, 0), (2, 3))),
        L.GlobalAveragePooling2D(keepdims=True),
    ])


def _norm_merge(functional: bool):
    if not functional:
        return (6, 6, 4), [
            L.BatchNormalization(scale=False),
            L.Conv2D(5, 1),
            L.BatchNormalization(center=False, epsilon=0.01),
            L.BatchNormalization(axis=3),
            L.Flatten(),
            L.Dense(6),
            L.BatchNormalization(epsilon=1e-5),
        ]

    def graph(x):
        a = L.BatchNormalization(scale=False)(x)
        b = L.BatchNormalization(center=False, epsilon=0.01)(x)
        c = L.BatchNormalization()(x)
        m = L.Add()([a, b, c])
        joined = L.Concatenate()([L.Flatten()(L.Concatenate(axis=axis)([m, y]))
                                  for axis, y in ((-1, a), (1, b), (2, c))])
        return L.BatchNormalization()(L.Dense(5)(joined))

    return (6, 6, 4), graph


def _dense_shape(functional: bool):
    if not functional:
        return (4, 5, 3), [
            L.Rescaling(1 / 127.5, offset=-1.0),
            L.Dense(6, activation="tanh"),
            L.Reshape((20, 6)),
            L.BatchNormalization(),
            L.Reshape((5, 4, 6)),
            L.Flatten(),
            L.Dropout(0.5),
            L.Dense(7),
            L.Softmax(),
        ]

    def graph(x):
        x = L.Rescaling(0.01)(x)
        d4 = L.Dense(6)(x)
        parts = [L.Softmax()(d4), L.Softmax(axis=1)(d4), L.Reshape((2, 10, 3))(x)]
        return L.Dense(4, activation="softmax")(L.Concatenate()([L.Flatten()(p) for p in parts]))

    return (4, 5, 3), graph


_NAMES = ("linear", "relu", "relu6", "sigmoid", "softmax", "tanh", "swish", "silu",
          "gelu", "elu", "softplus", "hard_sigmoid")


def _activations(functional: bool):
    if not functional:
        return (12,), [
            L.Dense(8, activation="gelu"), L.Activation("elu"),
            L.Dense(8, activation="softplus"), L.Activation("hard_sigmoid"),
            L.Dense(8, activation="swish"), L.Activation("sigmoid"),
            L.Dense(8, activation="tanh"),
            L.ReLU(max_value=4.0, negative_slope=0.1, threshold=0.5),
            L.Dense(8, activation="relu6"), L.ReLU(negative_slope=0.2),
            L.Dense(8, activation="silu"), L.ReLU(threshold=0.1),
            L.Dense(8, activation="linear"), L.ReLU(max_value=6.0),
            L.Dense(8, activation="relu"), L.Activation("softmax"),
        ]

    def graph(x):
        d = L.Dense(8)(x)
        outs = [L.Activation(name)(d) for name in _NAMES]
        outs += [L.ReLU(max_value=1.5)(d), L.ReLU(negative_slope=0.3, threshold=0.5)(d),
                 L.ReLU(max_value=2.0, negative_slope=0.1)(d), L.ReLU(threshold=0.2)(d)]
        return L.Concatenate()(outs)

    return (12,), graph


FAMILIES = {"conv": _conv, "pool": _pool, "norm_merge": _norm_merge,
            "dense_shape": _dense_shape, "activations": _activations}


def _build(family: str, functional: bool, seed: int = 0):
    shape, spec = FAMILIES[family](functional)
    if functional:
        inp = keras.Input(shape)
        model = keras.Model(inp, spec(inp), name=f"{family}_functional")
    else:
        model = keras.Sequential([keras.Input(shape)] + spec, name=f"{family}_sequential")
    return _randomize(model, seed), shape


def _inputs(family: str, shape, n: int = 3) -> np.ndarray:
    rng = np.random.default_rng(1)
    if family == "dense_shape":
        return rng.uniform(0, 255, (n, *shape)).astype(np.float32)
    x = 2.0 * rng.standard_normal((n, *shape))
    return (x - 1.0 if family == "pool" else x).astype(np.float32)


@pytest.mark.parametrize("functional", [False, True], ids=["sequential", "functional"])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_layer_family_matches_keras(family, functional, tmp_path):
    model, shape = _build(family, functional)
    x = _inputs(family, shape)
    want = _keras(model, x)
    model.save(tmp_path / "m.keras")
    model.save(tmp_path / "m.h5")
    for source in (str(tmp_path / "m.keras"), str(tmp_path / "m.h5"), model):
        got = _port(source, x)
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, **TOL)


# -- InceptionV3 at 75x75 ---------------------------------------------------------

@pytest.fixture(scope="module")
def inception(tmp_path_factory):
    """InceptionV3(weights=None) at 75x75 (Keras's seeded initial weights),
    saved in both formats, and Keras's own output on a batch of 2."""
    keras.utils.set_random_seed(0)
    model = keras.applications.InceptionV3(weights=None, input_shape=(75, 75, 3))
    root = tmp_path_factory.mktemp("inception")
    paths = {fmt: str(root / f"inception_v3.{fmt}") for fmt in ("keras", "h5")}
    for path in paths.values():
        model.save(path)
    x = np.random.default_rng(2).uniform(-1, 1, (2, 75, 75, 3)).astype(np.float32)
    return model, paths, x, _keras(model, x)


@pytest.mark.parametrize("fmt", ["keras", "h5"])
def test_inception_v3_from_file_matches_keras(inception, fmt):
    _, paths, x, want = inception
    got = _port(paths[fmt], x)
    assert got.shape == (2, 1000)
    np.testing.assert_allclose(got, want, **TOL)
    assert _max_rel(got, want) < 1e-4


def test_inception_v3_in_memory_and_mixed_bfloat16(inception):
    model, paths, x, want = inception
    np.testing.assert_allclose(_port(model, x), want, **TOL)
    got = _port(paths["keras"], x, compute_dtype="bfloat16")
    assert _max_rel(got, want) < BF16_MAX_REL


def test_inception_v3_weights_are_read_in_both_formats_alike(inception):
    _, paths, _, _ = inception
    (cfg_k, w_k), (cfg_h, w_h) = (read_keras_file(paths[f]) for f in ("keras", "h5"))
    assert [layer["config"]["name"] for layer in cfg_k["config"]["layers"]] == \
        [layer["config"]["name"] for layer in cfg_h["config"]["layers"]]
    w_k = {name: arrays for name, arrays in w_k.items() if arrays}
    assert sorted(w_k) == sorted(name for name, arrays in w_h.items() if arrays)
    for name, arrays in w_k.items():
        assert len(arrays) == len(w_h[name])
        for a, b in zip(arrays, w_h[name]):
            np.testing.assert_array_equal(a, b)
    assert sum(a.size for arrays in w_k.values() for a in arrays) == 23_851_784


# -- mixed precision ---------------------------------------------------------------

def test_serialized_mixed_bfloat16_policy_is_honoured(tmp_path):
    keras.config.set_dtype_policy("mixed_bfloat16")
    try:
        model, shape = _build("conv", functional=True, seed=3)
    finally:
        keras.config.set_dtype_policy("float32")
    x = _inputs("conv", shape)
    model.save(tmp_path / "mixed.keras")
    want = _keras(model, x)
    fn = TorchFunction.from_keras(str(tmp_path / "mixed.keras"))
    out = fn(x, device="cpu")
    assert out.dtype == torch.bfloat16
    assert _max_rel(out.float().numpy(), want) < BF16_MAX_REL


def test_compute_dtype_override_matches_the_jax_package(tmp_path):
    model, shape = _build("norm_merge", functional=True, seed=4)
    path = str(tmp_path / "f32.keras")
    model.save(path)
    x = _inputs("norm_merge", shape)
    jax_fn = XlaFunction.from_keras(path, compute_dtype="bfloat16")
    want = np.asarray(jax_fn.apply(jax_fn.params, x)[0]).astype(np.float32)
    got = _port(path, x, compute_dtype="bfloat16")
    assert _max_rel(got, want) < BF16_MAX_REL
    assert _max_rel(got, _keras(model, x)) < BF16_MAX_REL
    np.testing.assert_array_equal(_port(path, x, compute_dtype="float32"), _port(path, x))


# -- errors ----------------------------------------------------------------------

def _small_config():
    model, _ = _build("dense_shape", functional=True)
    return read_keras_model(model)


def test_unknown_layer_class_raises_with_its_name():
    config, weights = _small_config()
    config["config"]["layers"][2]["class_name"] = "LSTM"
    with pytest.raises(NotImplementedError, match="LSTM"):
        KerasModel(config, weights)


def test_keras2_node_format_raises():
    config, weights = _small_config()
    for layer in config["config"]["layers"][1:]:
        layer["inbound_nodes"] = [[["input_layer", 0, 0, {}]]]
    with pytest.raises(NotImplementedError, match="Keras 2"):
        KerasModel(config, weights)


def test_nested_model_raises():
    """One level of nesting builds (the nested-model tests below); a model
    nested two deep raises."""
    inner = keras.Sequential([keras.Input((4,)), L.Dense(2)], name="inner")
    middle = keras.Sequential([keras.Input((4,)), inner, L.Dense(3)], name="middle")
    inp = keras.Input((4,))
    outer = keras.Model(inp, L.Dense(3)(middle(inp)))
    with pytest.raises(NotImplementedError, match="nested two deep"):
        TorchFunction.from_keras(outer)


def test_compute_dtype_is_checked(tmp_path):
    model, _ = _build("activations", functional=False)
    path = str(tmp_path / "a.keras")
    model.save(path)
    with pytest.raises(ValueError, match="unsupported compute_dtype"):
        TorchFunction.from_keras(path, compute_dtype="int8")
    with pytest.raises(ValueError, match="compute_dtype applies"):
        TorchFunction.from_keras(model, compute_dtype="bfloat16")


# -- the writer and the committed config --------------------------------------------------

@pytest.mark.parametrize("family", ["conv", "norm_merge"])
def test_written_keras_file_loads_in_keras(family, tmp_path):
    model, shape = _build(family, functional=True, seed=5)
    x = _inputs(family, shape)
    _, weights = read_keras_model(model)
    config = keras.saving.serialize_keras_object(model)
    path = str(tmp_path / "written.keras")
    write_keras_file(path, config, weights)
    reloaded = keras.models.load_model(path, compile=False)
    want = _keras(model, x)
    np.testing.assert_array_equal(_keras(reloaded, x), want)
    np.testing.assert_allclose(_port(path, x), want, **TOL)


def _without_object_ids(node):
    if isinstance(node, dict):
        return {k: _without_object_ids(v) for k, v in node.items() if k != "shared_object_id"}
    if isinstance(node, list):
        return [_without_object_ids(v) for v in node]
    return node


def _inbound_layers(layer):
    found = []

    def walk(node):
        if isinstance(node, dict):
            if node.get("class_name") == "__keras_tensor__":
                found.append(node["config"]["keras_history"][0])
            for v in node.values():
                walk(v)
        elif isinstance(node, list):
            for v in node:
                walk(v)

    walk(layer.get("inbound_nodes", []))
    return found


def test_committed_inception_v3_config_is_what_keras_builds():
    committed = json.loads(gzip.decompress(CONFIG_FIXTURE.read_bytes()))
    keras.backend.clear_session()  # the layer names restart at conv2d, as in a fresh process
    built = keras.applications.InceptionV3(weights=None).get_config()
    built = json.loads(json.dumps(built))  # tuples as the file's lists
    want, got = built["layers"], committed["config"]["layers"]
    assert len(got) == len(want) == 313
    for a, b in zip(got, want):
        assert (a["class_name"], a["config"]["name"]) == (b["class_name"], b["config"]["name"])
        assert _inbound_layers(a) == _inbound_layers(b), a["config"]["name"]
        assert _without_object_ids(a["config"]) == _without_object_ids(b["config"])
    assert committed["config"]["input_layers"] == built["input_layers"]
    assert committed["config"]["output_layers"] == built["output_layers"]


# -- nested models, chunked attributes, weights written back ------------------------

def _nested_model(kind: str, seed: int = 0):
    """``functional_in_sequential``: a Functional conv/BN/pool base in a
    Sequential with a Dense head (the fine-tune idiom);
    ``sequential_in_functional``: a Sequential conv/BN block called inside
    a Functional model. Each with its inner conv frozen."""
    keras.utils.set_random_seed(seed)
    if kind == "functional_in_sequential":
        inp = keras.Input((10, 10, 3))
        h = L.Conv2D(4, 3, padding="same", name="c1")(inp)
        h = L.BatchNormalization(name="bn1")(h)
        h = L.Activation("relu", name="act")(h)
        h = L.Conv2D(5, 3, strides=2, name="c2")(h)
        base = keras.Model(inp, L.GlobalAveragePooling2D(name="gap")(h), name="base")
        base.get_layer("c1").trainable = False
        model = keras.Sequential([base, L.Dense(3, activation="softmax", name="head")])
        model.build((None, 10, 10, 3))
    else:
        block = keras.Sequential([L.Input((10, 10, 3)), L.Conv2D(4, 3, name="c1"),
                                  L.BatchNormalization(name="bn1")], name="block")
        block.get_layer("c1").trainable = False
        inp = keras.Input((10, 10, 3))
        h = L.Conv2D(2, 1, name="side")(inp)
        h = L.Concatenate()([L.Flatten()(block(inp)), L.Flatten()(h)])
        model = keras.Model(inp, L.Dense(3, name="head")(h))
    return _randomize_nested(model, seed)


def _randomize_nested(model, seed: int):
    """``_randomize`` of every layer, a nested model's layers in turn."""
    for i, layer in enumerate(model.layers):
        if hasattr(layer, "layers"):
            _randomize_nested(layer, seed + 1 + i)
    _randomize(SimpleNamespace(layers=[la for la in model.layers
                                       if not hasattr(la, "layers")]), seed)
    return model


@pytest.mark.parametrize("source", ["keras", "h5", "memory"])
@pytest.mark.parametrize("kind", ["functional_in_sequential", "sequential_in_functional"])
def test_nested_model_matches_keras(kind, source, tmp_path):
    model = _nested_model(kind)
    x = np.random.default_rng(1).uniform(-1, 1, (3, 10, 10, 3)).astype(np.float32)
    if source == "memory":
        got = _port(model, x)
    else:
        path = str(tmp_path / f"nested.{source}")
        model.save(path)
        got = _port(path, x)
        if source == "h5":
            # the frozen conv's weights come after the BN's trainable ones
            names = [str(n, "utf8") if isinstance(n, bytes) else str(n) for n in
                     h5py.File(path)["model_weights"][model.layers[0 if kind.startswith("f")
                                                               else 1].name].attrs["weight_names"]]
            assert names.index(next(n for n in names if n.endswith("c1/kernel"))) > \
                names.index(next(n for n in names if n.endswith("bn1/gamma")))
    np.testing.assert_allclose(got, _keras(model, x), **TOL)


def test_nested_weights_are_read_in_all_sources_alike(tmp_path):
    model = _nested_model("functional_in_sequential")
    model.save(str(tmp_path / "n.keras"))
    model.save(str(tmp_path / "n.h5"))
    trees = [read_keras_file(str(tmp_path / "n.keras"))[1],
             read_keras_file(str(tmp_path / "n.h5"))[1], read_keras_model(model)[1]]
    base = model.layers[0]
    for tree in trees:
        assert set(tree) == {"base", "head"}
        for layer in base.layers:
            want = layer.get_weights()
            got = tree["base"].get(layer.name, [])
            assert len(got) == len(want), layer.name
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)


def test_nested_model_trainable_flags_and_written_weights(tmp_path):
    """The frozen conv's parameters take no gradient, the others do; the
    module's ``keras_weights()`` written by ``write_keras_file`` load in
    Keras with the port's weights bit for bit, nested model included."""
    model = _nested_model("functional_in_sequential")
    path = str(tmp_path / "n.keras")
    model.save(path)
    config, weights = read_keras_file(path)
    module = KerasModel(config, weights)
    frozen = {n for n, p in module.named_parameters() if not p.requires_grad}
    assert frozen == {"layers.base.layers.c1.conv.weight", "layers.base.layers.c1.conv.bias"}
    with torch.no_grad():
        for p in module.parameters():
            p.add_(0.25)
        module.layers["base"].layers["bn1"].bn.var.mul_(1.5)
    written = str(tmp_path / "written.keras")
    write_keras_file(written, config, module.keras_weights())
    reloaded = keras.models.load_model(written, compile=False)
    got = module.keras_weights()
    for layer in reloaded.layers[0].layers:
        for g, w in zip(got["base"].get(layer.name, []), layer.get_weights()):
            np.testing.assert_array_equal(g, w)
    for g, w in zip(got["head"], reloaded.layers[1].get_weights()):
        np.testing.assert_array_equal(g, w)
    x = np.random.default_rng(2).uniform(-1, 1, (2, 10, 10, 3)).astype(np.float32)
    np.testing.assert_allclose(_port(written, x), _keras(reloaded, x), **TOL)


def _long_name(kind: str, i: int) -> str:
    return f"{kind}_{i:03d}_" + "x" * 1000


def test_chunked_h5_attributes_are_joined(tmp_path):
    """Keras splits an attribute larger than 64512 bytes into ``name0``,
    ``name1``, ...: 64 outer layers and 33 layers of a nested model, each
    with a 1008-character name, split the root's ``layer_names`` and the
    nested model's ``weight_names``. The port joins them as Keras does."""
    keras.utils.set_random_seed(0)
    base = keras.Sequential([L.Input((3,))] + [L.Dense(3, name=_long_name("inner", i))
                                                for i in range(33)], name="base")
    model = keras.Sequential([L.Input((3,)), base]
                             + [L.Dense(3, name=_long_name("outer", i)) for i in range(64)])
    path = str(tmp_path / "chunked.h5")
    model.save(path)
    root = h5py.File(path)["model_weights"]
    assert {"layer_names0", "layer_names1"} <= set(root.attrs) and "layer_names" not in root.attrs
    assert {"weight_names0", "weight_names1"} <= set(root["base"].attrs)
    _, weights = read_keras_file(path)
    assert list(weights) == ["base"] + [_long_name("outer", i) for i in range(64)]
    for layer in model.layers[1:]:
        for g, w in zip(weights[layer.name], layer.get_weights()):
            np.testing.assert_array_equal(g, w)
    for layer in base.layers:
        for g, w in zip(weights["base"][layer.name], layer.get_weights()):
            np.testing.assert_array_equal(g, w)
    x = np.random.default_rng(0).uniform(-1, 1, (4, 3)).astype(np.float32)
    np.testing.assert_allclose(_port(path, x), _keras(model, x), **TOL)
