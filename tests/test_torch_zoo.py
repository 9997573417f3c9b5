"""The rest of the port's CNN zoo against the JAX package's, on the CPU.

- ``ResNet50``, ``VGG16``, ``VGG19``, ``MobileNetV2`` and ``Xception`` (at
  ``middle_width`` 728 and 768) against the Flax modules on the same
  weights: features and logits in float32 to ``rtol=atol=1e-4``
  (``tests/test_models.py``'s Keras-oracle bound), features in bfloat16
  within 3% of the largest (``tests/test_torch_inception.py``'s bound).
  Sizes: 64x64 for ResNet50, MobileNetV2 and VGG (whose last map is then
  2x2x512, so ``fc1`` sees Flax's ``(h, w, c)`` flatten order), 71x71 for
  Xception (its smallest input);
- the shared layers (``Conv`` with bias and groups, ``BatchNorm`` with
  scale, ``SeparableConv``) against ``jax.lax`` and the Flax layers;
- the one converter of the five models and its inverse, ``cnn_flax_shapes``
  and the registry's ``state_dict_from_flax`` (Xception pads 728 -> 768; a
  tree's head keeps its width).

The weights are seeded numpy trees in the Flax layout, shaped by
``jax.eval_shape`` of the Flax ``init``: conv kernels He-normal (a
separable conv's depthwise kernel at gain 1: no relu follows it before the
pointwise conv), BN scales and variances ``1 + 0.1|n|``, means and biases
``0.1 n``, the Dense at ``1/sqrt(in)``; the batch norm that ends a residual
branch (ResNet's ``_3_bn``, Xception's ``sepconv3_bn``, MobileNetV2's
``_project_BN``) has its scale at a fifth of that, so the residual sums do
not double the activations' variance block after block. The features then
stay of unit order (at most about 10 for ResNet50, 35 for Xception at
71x71), where the float32 bound's ``atol=1e-4`` means what it says. With
every scale near 1 they reach 3e3 (ResNet50) and 8e5 (Xception), float32
rounding alone is above that bound, and MobileNetV2's bf16 features part
from its float32 ones by 16% of the largest in both packages (measured:
rounding amplified through the undamped residual adds), so no bf16 bound
could tell a fault from the weights.
"""

import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as fnn
from jax import lax

from sparkdl_tpu.models import layers as jax_layers
from sparkdl_tpu.models.keras_port import pad_variables_to_module as jax_pad
from sparkdl_tpu.models.mobilenet_v2 import MobileNetV2 as FlaxMobileNetV2
from sparkdl_tpu.models.resnet import ResNet50 as FlaxResNet50
from sparkdl_tpu.models.vgg import VGG16 as FlaxVGG16
from sparkdl_tpu.models.vgg import VGG19 as FlaxVGG19
from sparkdl_tpu.models.xception import Xception as FlaxXception
from sparkdl_tpu_torch.models import layers, registry
from sparkdl_tpu_torch.transformers.named_image import build_module
from sparkdl_tpu_torch.models.convert import (
    cnn_flax_from_state_dict,
    cnn_flax_shapes,
    cnn_state_dict_from_flax,
    inception_state_dict_from_flax,
)
from sparkdl_tpu_torch.models.mobilenet_v2 import MobileNetV2
from sparkdl_tpu_torch.models.resnet import ResNet50
from sparkdl_tpu_torch.models.vgg import VGG16, VGG19
from sparkdl_tpu_torch.models.xception import Xception

F32_TOL = dict(rtol=1e-4, atol=1e-4)
# bfloat16 against Flax's dtype=bfloat16, both on the CPU: each conv, BN and
# pool output rounds to bf16 (2**-9) after sums in another order, compounded
# through the depth: within 3% of the largest feature
BF16_MAX_REL = 3e-2

# name -> (Flax module, port module, port kwargs, input size)
MODELS = {
    "ResNet50": (FlaxResNet50(), ResNet50, {}, 64),
    "VGG16": (FlaxVGG16(), VGG16, {"input_size": (64, 64)}, 64),
    "VGG19": (FlaxVGG19(), VGG19, {"input_size": (64, 64)}, 64),
    "MobileNetV2": (FlaxMobileNetV2(), MobileNetV2, {}, 64),
    "Xception728": (FlaxXception(middle_width=728), Xception, {"middle_width": 728}, 71),
    "Xception768": (FlaxXception(middle_width=768), Xception, {"middle_width": 768}, 71),
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


# the batch norms that end a residual branch
RESIDUAL_END = re.compile(r"(_3_bn|sepconv3_bn|_project_BN)$")


def flax_tree(module, size: int, seed: int = 0):
    """Seeded numpy variables of the Flax ``module`` at ``size`` x ``size``."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, size, size, 3), jnp.float32))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        layer, name, shape = path[-2].key, path[-1].key, leaf.shape
        if len(shape) == 4:  # conv kernels: He-normal
            gain = 1.0 if name == "depthwise_kernel" else 2.0
            std = np.sqrt(gain / np.prod(shape[:-1]))
        elif name == "kernel":
            std = 1.0 / np.sqrt(shape[0])
        elif name in ("scale", "var"):
            v = (1 + 0.1 * np.abs(rng.standard_normal(shape))).astype(np.float32)
            return v * np.float32(0.2) if name == "scale" and RESIDUAL_END.search(layer) else v
        else:
            std = 0.1
        return (rng.standard_normal(shape) * std).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def port_module(name, tree, dtype=None):
    _, cls, kwargs, _ = MODELS[name]
    with torch.device("meta"):
        template = cls(**kwargs)
    module = cls(**kwargs, dtype=dtype)
    module.load_state_dict(cnn_state_dict_from_flax(tree, template), strict=True)
    return module.eval()


def _nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x).permute(0, 3, 1, 2)


@pytest.fixture(scope="module")
def cases():
    """Per model: its tree, an input batch of 2, the Flax features and
    logits."""
    out = {}
    for name, (flax, _, _, size) in MODELS.items():
        tree = flax_tree(flax, size, seed=len(out))
        x = np.random.default_rng(size).uniform(-1, 1, (2, size, size, 3)).astype(np.float32)
        features = jax.jit(lambda v, x, m=flax: m.apply(v, x, features_only=True))
        logits = jax.jit(lambda v, x, m=flax: m.apply(v, x))
        out[name] = (tree, x, np.asarray(features(tree, x)), np.asarray(logits(tree, x)))
    return out


# -- the models -----------------------------------------------------------

@pytest.mark.parametrize("name", list(MODELS))
def test_float32_matches_flax(cases, name):
    tree, x, features, logits = cases[name]
    module = port_module(name, tree)
    with torch.inference_mode():
        got_features = module(_nchw(x), features_only=True).numpy()
        got_logits = module(_nchw(x).contiguous(memory_format=torch.channels_last)).numpy()
    width = {"VGG16": 4096, "VGG19": 4096, "MobileNetV2": 1280}.get(name, 2048)
    assert got_features.shape == features.shape == (2, width)
    assert got_logits.shape == logits.shape == (2, 1000)
    assert np.abs(features).max() > 0.1
    np.testing.assert_allclose(got_features, features, **F32_TOL)
    np.testing.assert_allclose(got_logits, logits, **F32_TOL)


@pytest.mark.parametrize("name", list(MODELS))
def test_bfloat16_matches_flax(cases, name):
    tree, x, _, _ = cases[name]
    flax = MODELS[name][0].clone(dtype=jnp.bfloat16)
    want = np.asarray(jax.jit(
        lambda v, x: flax.apply(v, x.astype(jnp.bfloat16), features_only=True)
    )(tree, x).astype(jnp.float32))
    module = port_module(name, tree, dtype=torch.bfloat16)
    with torch.inference_mode():
        got = module(_nchw(x), features_only=True)
    assert got.dtype == torch.bfloat16
    err = np.abs(got.float().numpy() - want).max()
    assert err <= BF16_MAX_REL * np.abs(want).max(), err


def test_vgg_flattens_in_flax_order(cases):
    """At 64x64 VGG's last map is 2x2x512: fc1's rows in Flax's (h, w, c)
    order; flattening NCHW's (c, h, w) order instead gives other numbers."""
    tree, x, features, _ = cases["VGG16"]
    module = port_module("VGG16", tree)
    assert module.fc1.weight.shape == (4096, 2 * 2 * 512)
    rows = torch.arange(2048).view(2, 2, 512).permute(2, 0, 1).flatten()
    wrong = port_module("VGG16", tree)
    with torch.no_grad():
        wrong.fc1.weight.copy_(module.fc1.weight[:, rows])
    with torch.inference_mode():
        bad = wrong(_nchw(x), features_only=True).numpy()
    assert np.abs(bad - features).max() > 1e-2


def test_vgg_without_its_top_cannot_featurize():
    module = VGG16(include_top=False, input_size=(64, 64)).eval()
    assert "fc1.weight" not in module.state_dict()
    x = torch.zeros(1, 3, 64, 64)
    with torch.inference_mode():
        assert module(x).shape == (1, 512, 2, 2)
        with pytest.raises(ValueError, match="cut point is the fc2 output"):
            module(x, features_only=True)
    assert VGG16(input_size=(224, 224)).fc1.weight.shape == (4096, 25088)


@pytest.mark.parametrize("name", ["ResNet50", "MobileNetV2", "Xception768", "VGG16"])
def test_headless_module_featurizes_only(cases, name):
    tree, x, features, _ = cases[name]
    headless = {"params": {k: v for k, v in tree["params"].items() if k != "predictions"},
                **{k: v for k, v in tree.items() if k != "params"}}
    _, cls, kwargs, _ = MODELS[name]
    with torch.device("meta"):
        template = cls(**kwargs, num_classes=None)
    module = cls(**kwargs, num_classes=None)
    module.load_state_dict(cnn_state_dict_from_flax(headless, template), strict=True)
    assert module.predictions is None
    with torch.inference_mode():
        np.testing.assert_allclose(module.eval()(_nchw(x), features_only=True).numpy(),
                                   features, **F32_TOL)
        with pytest.raises(ValueError, match="without its predictions layer"):
            module(_nchw(x))


def test_xception_widths_agree(cases):
    """The 728-wide tree zero-padded to the 768-wide module (the registry's)
    gives the 728-wide module's numbers."""
    tree, x, features, _ = cases["Xception728"]
    wide = Xception(middle_width=768).eval()
    with torch.device("meta"):
        template = Xception(middle_width=768)
    from sparkdl_tpu_torch.models.keras_port import pad_variables_to_module
    wide.load_state_dict(
        cnn_state_dict_from_flax(pad_variables_to_module(tree, template), template))
    with torch.inference_mode():
        got = wide(_nchw(x), features_only=True).numpy()
    np.testing.assert_allclose(got, features, **F32_TOL)


@pytest.mark.parametrize("name,units", [
    ("ResNet50", 53), ("VGG16", 13), ("VGG19", 16), ("MobileNetV2", 52), ("Xception768", 40),
])
def test_layout_matches_flax_tree(cases, name, units):
    """Every Flax leaf has one state_dict entry of the same size, and the
    conv-like layers count as the Keras models' do."""
    tree = cases[name][0]
    module = port_module(name, tree)
    n_flax = sum(int(np.prod(a.shape)) for a in jax.tree_util.tree_leaves(tree))
    assert n_flax == sum(t.numel() for t in module.state_dict().values())
    assert sum(isinstance(m, layers.CONV_TYPES) for m in module.modules()) == units


# -- the shared layers ----------------------------------------------------

@pytest.mark.parametrize("hw,strides,padding,groups,use_bias", [
    ((8, 8), 2, "SAME", 6, False),
    ((7, 9), 2, "SAME", 6, True),
    ((9, 9), 1, "SAME", 1, True),
    ((9, 9), 2, "VALID", 1, True),
], ids=["depthwise_stride2_even", "depthwise_stride2_odd_bias", "bias_same",
        "bias_valid_stride2"])
def test_conv_matches_lax(hw, strides, padding, groups, use_bias):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, *hw, 6)).astype(np.float32)
    cout = 6 if groups > 1 else 4
    w = rng.standard_normal((3, 3, 6 // groups, cout)).astype(np.float32)
    b = rng.standard_normal(cout).astype(np.float32)
    want = lax.conv_general_dilated(x, w, (strides, strides), padding,
                                    dimension_numbers=("NHWC", "HWIO", "NHWC"),
                                    feature_group_count=groups)
    if use_bias:
        want = want + b
    conv = layers.Conv(6, cout, 3, strides, padding, use_bias=use_bias, groups=groups)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(w).permute(3, 2, 0, 1))
        if use_bias:
            conv.bias.copy_(torch.from_numpy(b))
    got = conv(_nchw(x)).detach().permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("hw", [(8, 8), (7, 9)])
def test_separable_conv_matches_flax(hw):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, *hw, 5)).astype(np.float32)
    flax = jax_layers.SeparableConv(7)
    variables = flax.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want = np.asarray(flax.apply(variables, jnp.asarray(x)))
    sep = layers.SeparableConv(5, 7)
    state = cnn_state_dict_from_flax({"params": {"sep": variables["params"]}},
                                     torch.nn.ModuleDict({"sep": sep}))
    sep.load_state_dict({k.split(".", 1)[1]: v for k, v in state.items()})
    assert sep.depthwise_kernel.shape == (5, 1, 3, 3)
    assert sep.pointwise_kernel.shape == (7, 5, 1, 1)
    with torch.no_grad():
        got = sep(_nchw(x)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype,epsilon", [("float32", 1.001e-5), ("bfloat16", 1e-3)])
def test_batch_norm_with_scale_matches_flax(dtype, epsilon):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 4, 5, 6)).astype(np.float32) * 3
    stats = {"mean": rng.standard_normal(6).astype(np.float32),
             "var": (1 + rng.random(6)).astype(np.float32)}
    params = {"scale": rng.standard_normal(6).astype(np.float32),
              "bias": rng.standard_normal(6).astype(np.float32)}
    flax = fnn.BatchNorm(use_running_average=True, epsilon=epsilon,
                         dtype=getattr(jnp, dtype))
    want = flax.apply({"params": params, "batch_stats": stats},
                      jnp.asarray(x, getattr(jnp, dtype)))
    bn = layers.BatchNorm(6, epsilon)
    bn.load_state_dict({k: torch.from_numpy(v) for k, v in {**params, **stats}.items()})
    with torch.no_grad():
        got = bn(_nchw(x).to(getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype)
    # float32 arithmetic, rounded once: equal to a few ulp (bf16: one rounding)
    tol = dict(rtol=1e-6, atol=1e-6) if dtype == "float32" else dict(rtol=2 ** -8, atol=1e-6)
    np.testing.assert_allclose(got.float().permute(0, 2, 3, 1).numpy(),
                               np.asarray(want.astype(jnp.float32)), **tol)


# -- converter ------------------------------------------------------------

@pytest.mark.parametrize("name", list(MODELS))
def test_converter_round_trip_is_exact(cases, name):
    tree = cases[name][0]
    module = port_module(name, tree)
    back = cnn_flax_from_state_dict(module.state_dict())
    flat_a = {jax.tree_util.keystr(p): a for p, a in jax.tree_util.tree_leaves_with_path(tree)}
    flat_b = {jax.tree_util.keystr(p): a for p, a in jax.tree_util.tree_leaves_with_path(back)}
    assert flat_a.keys() == flat_b.keys()
    for k in flat_a:
        np.testing.assert_array_equal(np.asarray(flat_a[k]), flat_b[k], err_msg=k)
    shapes = cnn_flax_shapes(module)
    assert {k: tuple(a.shape) for k, a in flat_b.items()} == {
        jax.tree_util.keystr(p): s
        for p, s in jax.tree_util.tree_leaves_with_path(shapes, is_leaf=lambda n: isinstance(n, tuple))
    }


def _edit(tree, where, key, value=None):
    out = jax.tree_util.tree_map(lambda a: a, tree)
    node = out
    for part in where:
        node = node[part]
    if value is None:
        del node[key]
    else:
        node[key] = value
    return out


@pytest.mark.parametrize("name,where,key,value,match", [
    ("ResNet50", ("params", "conv3_block2_2_conv"), "bias", None,
     "missing key params/conv3_block2_2_conv/bias"),
    ("ResNet50", ("params", "conv1_bn"), "scale", None, "missing key params/conv1_bn/scale"),
    ("MobileNetV2", ("batch_stats", "block_5_depthwise_BN"), "var", None,
     "missing key batch_stats/block_5_depthwise_BN/var"),
    ("Xception768", ("params", "block7_sepconv2"), "depthwise_kernel", None,
     "missing key params/block7_sepconv2/depthwise_kernel"),
    ("VGG16", ("params",), "fc3", {"kernel": np.zeros((2, 2), np.float32)},
     "unused keys under params/"),
    ("ResNet50", ("params", "conv1_conv"), "scale", np.zeros(64, np.float32),
     "unused keys under params/conv1_conv/"),
    ("MobileNetV2", ("batch_stats",), "Conv1", {"mean": np.zeros(32, np.float32)},
     "unused keys under batch_stats/"),
], ids=["missing_bias", "missing_scale", "missing_var", "missing_depthwise", "extra_layer",
        "extra_leaf", "extra_stats"])
def test_converter_refuses_missing_or_unused_keys(cases, name, where, key, value, match):
    _, cls, kwargs, _ = MODELS[name]
    with torch.device("meta"):
        target = cls(**kwargs)
    with pytest.raises(KeyError, match=match):
        cnn_state_dict_from_flax(_edit(cases[name][0], where, key, value), target)


def test_converter_refuses_a_narrow_tree_for_a_wide_module(cases):
    with torch.device("meta"):
        wide = Xception(middle_width=768)
    with pytest.raises(ValueError, match="has shape"):
        cnn_state_dict_from_flax(cases["Xception728"][0], wide)


def test_inverse_converter_refuses_an_empty_state():
    with pytest.raises(KeyError, match="empty"):
        cnn_flax_from_state_dict({})


# -- the registry's converter and the stem fold -------------------------

def test_registry_pads_a_narrow_xception_tree_as_jax(cases):
    """``state_dict_from_flax`` pads a 728-wide tree to the entry's 768
    module as the JAX package's ``pad_variables_to_module`` does."""
    tree = cases["Xception728"][0]
    entry = registry.get_keras_application_model("Xception")
    state = entry.state_dict_from_flax(tree)
    want = jax_pad(tree, FlaxXception(middle_width=768), (71, 71))
    expect = cnn_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, want),
                                      entry.make_module())
    assert state.keys() == expect.keys()
    for k in state:
        assert torch.equal(state[k], expect[k]), k
    assert state["block5_sepconv1.pointwise_kernel"].shape == (768, 768, 1, 1)
    assert torch.all(state["block5_sepconv1_bn.var"][728:] == 1)
    assert torch.all(state["block5_sepconv1.depthwise_kernel"][728:] == 0)


@pytest.mark.parametrize("name", ["InceptionV3", "MobileNetV2"])
def test_registry_keeps_the_trees_head_width(name):
    """Every entry converts through the one converter, its module built at
    the tree's head width: a 10-class ``predictions`` Dense stays 10 wide
    (the padding never widens it to the entry's 1000), InceptionV3's
    conversion is ``inception_state_dict_from_flax``'s, and the stage's
    module loads the result."""
    entry = registry.get_keras_application_model(name)
    with torch.device("meta"):
        layout = entry.module_cls(num_classes=10)
    gen = torch.Generator().manual_seed(0)
    state = {k: torch.randn(v.shape, generator=gen) for k, v in layout.state_dict().items()}
    tree = cnn_flax_from_state_dict(state)
    got = entry.state_dict_from_flax(tree)
    assert got["predictions.weight"].shape == (10, entry.feature_size)
    assert got.keys() == state.keys()
    for k in state:
        assert torch.equal(got[k], state[k]), k
    if name == "InceptionV3":
        want = inception_state_dict_from_flax(tree)
        assert all(torch.equal(got[k], want[k]) for k in want)
    module = build_module(name, got, torch.float32, "cpu")
    assert module.predictions.weight.shape == (10, entry.feature_size)


@pytest.mark.parametrize("name,stem", [("MobileNetV2", "Conv1.weight"),
                                       ("Xception", "block1_conv1.weight")])
def test_fold_bgr_flip_finds_the_stem_alone(name, stem):
    """Depthwise and separable weights are (cin, 1, kh, kw): only the stem
    has 3 input channels, so "tf" models fold the flip into it."""
    state = registry.get_keras_application_model(name).make_module().state_dict()
    state = {k: torch.randn(v.shape) for k, v in state.items()}
    folded = registry.fold_bgr_flip_into_stem(state, "tf")
    changed = [k for k in state if not torch.equal(folded[k], state[k])]
    assert changed == [stem]
    assert torch.equal(folded[stem], state[stem].flip(1))
