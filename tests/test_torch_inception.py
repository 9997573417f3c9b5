"""The port's CNN modules against the JAX package's, on the CPU.

- ``sparkdl_tpu_torch.models.layers``: TF-``'SAME'`` padding, pools and
  convolutions against ``jax.lax`` and ``sparkdl_tpu.models.layers``;
- ``InceptionV3`` against the Flax module on the same weights, in float32 at
  75x75 (Keras's smallest input) and 299x299, features and logits, to
  ``rtol=atol=1e-4`` (``tests/test_models.py``'s Keras-oracle bound), and
  in bfloat16 at 75x75;
- the weight converter, ``preprocess_input``, the BGR stem fold and the
  registry.

The weights are a seeded numpy tree in the Flax layout, shaped by
``jax.eval_shape`` of the Flax ``init``: conv kernels He-normal, BN
variances near 1, means and biases near 0, the Dense at ``1/sqrt(in)``, so
activations stay of unit order through the 94 units.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import lax

from sparkdl_tpu.models import layers as jax_layers
from sparkdl_tpu.models import registry as jax_registry
from sparkdl_tpu.models.inception_v3 import InceptionV3 as FlaxInceptionV3
from sparkdl_tpu_torch.models import layers
from sparkdl_tpu_torch.models import registry
from sparkdl_tpu_torch.models.convert import (
    inception_flax_from_state_dict,
    inception_state_dict_from_flax,
)
from sparkdl_tpu_torch.models.inception_v3 import InceptionV3

F32_TOL = dict(rtol=1e-4, atol=1e-4)
# bfloat16 InceptionV3 against Flax's dtype=bfloat16, both on the CPU: the two
# round each conv, BN and pool output to bf16 (2**-9 relative) after sums
# taken in another order, and the roundings compound through 94 units; at
# 75x75 the features (max |f| 0.74) differ by at most 0.0068 (measured),
# so: within 3% of the largest feature, and 5e-3 in norm would not hold
BF16_MAX_REL = 3e-2


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _no_compile_cache(monkeypatch):
    monkeypatch.setenv("SPARKDL_COMPILE_CACHE", "off")


def flax_inception_tree(seed: int = 0, num_classes: int = 1000):
    """Seeded numpy InceptionV3 variables in the Flax layout."""
    shapes = jax.eval_shape(
        FlaxInceptionV3(num_classes=num_classes).init,
        jax.random.PRNGKey(0), jnp.zeros((1, 75, 75, 3), jnp.float32),
    )
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = path[-1].key
        shape = leaf.shape
        if name == "kernel" and len(shape) == 4:
            std = np.sqrt(2.0 / np.prod(shape[:-1]))
        elif name == "kernel":
            std = 1.0 / np.sqrt(shape[0])
        elif name == "var":
            return (1 + 0.1 * np.abs(rng.standard_normal(shape))).astype(np.float32)
        else:
            std = 0.1
        return (rng.standard_normal(shape) * std).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.fixture(scope="module")
def tree():
    return flax_inception_tree()


@pytest.fixture(scope="module")
def state(tree):
    return inception_state_dict_from_flax(tree)


def _nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.permute(0, 2, 3, 1).numpy()


# -- layers ---------------------------------------------------------------

@pytest.mark.parametrize("size,kernel,stride", [
    (8, 3, 2), (7, 3, 2), (8, 1, 2), (35, 3, 1), (17, 7, 1), (10, 4, 3),
])
def test_tf_same_padding_matches_lax(size, kernel, stride):
    want = lax.padtype_to_pads((size,), (kernel,), (stride,), "SAME")[0]
    assert layers.tf_same_padding(size, kernel, stride) == tuple(want)


@pytest.mark.parametrize("hw,kernel,strides,padding", [
    ((8, 8), (3, 3), (2, 2), "SAME"),
    ((7, 9), (3, 3), (2, 2), "SAME"),
    ((9, 9), (7, 1), (1, 1), "SAME"),
    ((9, 9), (3, 3), (2, 2), "VALID"),
], ids=["stride2_even", "stride2_odd", "stride1_7x1", "valid_stride2"])
def test_conv2d_matches_lax(hw, kernel, strides, padding):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, *hw, 3)).astype(np.float32)
    w = rng.standard_normal((*kernel, 3, 4)).astype(np.float32)
    want = lax.conv_general_dilated(
        x, w, strides, padding, dimension_numbers=("NHWC", "HWIO", "NHWC")
    )
    got = layers.conv2d(_nchw(x), torch.from_numpy(w).permute(3, 2, 0, 1),
                        strides, padding)
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), rtol=1e-5, atol=1e-5)


POOL_CASES = [
    ("max", (9, 9), 3, 2, "VALID"),
    ("max", (8, 8), 3, 2, "SAME"),
    ("max", (7, 7), 3, 2, "SAME"),
    ("avg", (6, 7), 3, 1, "SAME"),
    ("avg", (8, 8), 3, 2, "SAME"),
    ("avg", (7, 9), 3, 2, "SAME"),
    ("avg", (9, 9), 3, 2, "VALID"),
]


@pytest.mark.parametrize("kind,hw,window,strides,padding", POOL_CASES,
                         ids=[f"{c[0]}_{c[4]}_{c[1][0]}x{c[1][1]}_s{c[3]}"
                              for c in POOL_CASES])
def test_pools_match_flax(kind, hw, window, strides, padding):
    """Padded cells stay out of the average's divisor at the edges
    (count_include_pad=False), stride-2 SAME pads the odd cell after."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, *hw, 5)).astype(np.float32)
    fn = {"max": (jax_layers.max_pool, layers.max_pool),
          "avg": (jax_layers.avg_pool, layers.avg_pool)}[kind]
    want = np.asarray(fn[0](jnp.asarray(x), window, strides, padding))
    got = _nhwc(fn[1](_nchw(x), window, strides, padding))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_global_avg_pool_matches_flax(dtype):
    x = np.random.default_rng(2).standard_normal((2, 8, 8, 16)).astype(np.float32)
    want = jax_layers.global_avg_pool(jnp.asarray(x, getattr(jnp, dtype)))
    got = layers.global_avg_pool(_nchw(x).to(getattr(torch, dtype)))
    assert str(got.dtype).endswith(dtype)
    # a float32 mean either way (sums in another order: a few ulp of the
    # unit-scale sum), rounded once to bf16 (2**-8 relative)
    tol = dict(rtol=1e-6, atol=1e-7) if dtype == "float32" else dict(rtol=2 ** -8)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)), **tol)


# -- InceptionV3 ----------------------------------------------------------

@pytest.fixture(scope="module")
def flax_outputs(tree):
    """Flax features and logits at 75x75 and 299x299, batch 2."""
    module = FlaxInceptionV3()
    features = jax.jit(lambda v, x: module.apply(v, x, features_only=True))
    logits = jax.jit(module.apply)
    out = {}
    for size in (75, 299):
        x = np.random.default_rng(size).uniform(-1, 1, (2, size, size, 3)).astype(np.float32)
        out[size] = (x, np.asarray(features(tree, x)), np.asarray(logits(tree, x)))
    return out


@pytest.fixture(scope="module")
def port_module(state):
    module = InceptionV3()
    module.load_state_dict(state, strict=True)
    return module.eval()


@pytest.mark.parametrize("size", [75, 299])
@pytest.mark.parametrize("output", ["features", "logits"])
def test_inception_v3_float32_matches_flax(flax_outputs, port_module, size, output):
    x, features, logits = flax_outputs[size]
    with torch.inference_mode():
        got = port_module(_nchw(x), features_only=output == "features").numpy()
    want = features if output == "features" else logits
    assert got.shape == want.shape == (2, 2048 if output == "features" else 1000)
    # the scaled weights keep the features of unit order (norm 7-21 at these sizes)
    assert 1.0 < np.linalg.norm(want, axis=1).min() < 1e3
    np.testing.assert_allclose(got, want, **F32_TOL)


def test_inception_v3_channels_last_matches_contiguous(flax_outputs, port_module):
    x, features, _ = flax_outputs[75]
    with torch.inference_mode():
        got = port_module(_nchw(x).contiguous(memory_format=torch.channels_last),
                          features_only=True).numpy()
    np.testing.assert_allclose(got, features, **F32_TOL)


def test_inception_v3_bfloat16_matches_flax(tree, state):
    x = np.random.default_rng(3).uniform(-1, 1, (2, 75, 75, 3)).astype(np.float32)
    flax = FlaxInceptionV3(dtype=jnp.bfloat16)
    want = np.asarray(jax.jit(
        lambda v, x: flax.apply(v, x.astype(jnp.bfloat16), features_only=True)
    )(tree, x).astype(jnp.float32))
    module = InceptionV3(dtype=torch.bfloat16)
    module.load_state_dict(state, strict=True)
    with torch.inference_mode():
        got = module.eval()(_nchw(x), features_only=True)
    assert got.dtype == torch.bfloat16
    err = np.abs(got.float().numpy() - want).max()
    assert err <= BF16_MAX_REL * np.abs(want).max(), err


def test_inception_v3_layout_is_flax_creation_order(tree):
    module = InceptionV3()
    assert module.num_units == 94 and module.num_features == 2048
    assert len(tree["params"]) == 189  # 94 conv + 94 BN + predictions
    n_flax = sum(int(np.prod(a.shape)) for a in jax.tree_util.tree_leaves(tree))
    assert n_flax == sum(t.numel() for t in module.state_dict().values()) == 23_851_784
    headless = InceptionV3(include_top=False)
    assert "predictions.weight" not in headless.state_dict()


# -- converter ------------------------------------------------------------

def test_converter_round_trip(tree, state):
    assert state["conv2d.weight"].shape == (32, 3, 3, 3)
    assert state["predictions.weight"].shape == (1000, 2048)
    np.testing.assert_array_equal(
        state["conv2d_5.weight"].numpy(),
        np.asarray(tree["params"]["conv2d_5"]["kernel"]).transpose(3, 2, 0, 1),
    )
    back = inception_flax_from_state_dict(state)
    flat_a = jax.tree_util.tree_leaves_with_path(tree)
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (_, a), (_, b) in zip(flat_a, flat_b):
        np.testing.assert_array_equal(np.asarray(a), b)


def test_converter_takes_jax_arrays(tree, state):
    jax_tree = jax.tree_util.tree_map(jnp.asarray, tree)
    got = inception_state_dict_from_flax(jax_tree)
    assert got.keys() == state.keys()
    for k in state:
        assert torch.equal(got[k], state[k])


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


@pytest.mark.parametrize("where,key,value,match", [
    (("params", "conv2d_3"), "kernel", None, "missing key params/conv2d_3/kernel"),
    (("batch_stats", "batch_normalization_7"), "var", None, "missing key"),
    (("params",), "batch_normalization_93", None, "missing key params/batch_normalization_93"),
    (("params",), "extra_dense", {"kernel": np.zeros((2, 2), np.float32)}, "unused keys"),
    (("batch_stats", "batch_normalization"), "count", np.zeros(1), "unused keys"),
], ids=["missing_kernel", "missing_var", "missing_bn", "extra_param", "extra_stat"])
def test_converter_refuses_missing_or_unused_keys(tree, where, key, value, match):
    with pytest.raises(KeyError, match=match):
        inception_state_dict_from_flax(_edit(tree, where, key, value))


def test_inverse_converter_refuses_unused_keys(state):
    with pytest.raises(KeyError, match="unused keys"):
        inception_flax_from_state_dict({**state, "stray.weight": torch.zeros(1)})


# -- preprocessing, stem fold, registry ----------------------------------

@pytest.mark.parametrize("mode", ["tf", "caffe", "torch"])
def test_preprocess_input_matches_jax(mode):
    x = np.random.default_rng(4).uniform(0, 255, (2, 5, 6, 3)).astype(np.float32)
    want = np.asarray(jax_registry.preprocess_input(jnp.asarray(x), mode))
    got = registry.preprocess_input(torch.from_numpy(x), mode).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)


def test_preprocess_input_refuses_unknown_mode():
    with pytest.raises(ValueError, match="Unknown preprocessing mode"):
        registry.preprocess_input(torch.zeros(1, 2, 2, 3), "keras")


def test_fold_bgr_flip_matches_jax(tree, state):
    folded = registry.fold_bgr_flip_into_stem(state, "tf")
    jax_folded = jax_registry.fold_bgr_flip_into_stem(tree, "tf")
    want = inception_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, jax_folded))
    assert folded.keys() == want.keys()
    for k in want:
        assert torch.equal(folded[k], want[k]), k
    assert torch.equal(folded["conv2d.weight"], state["conv2d.weight"].flip(1))
    assert not torch.equal(folded["conv2d.weight"], state["conv2d.weight"])


@pytest.mark.parametrize("mode,extra", [
    ("caffe", {}), ("torch", {}), ("tf", {"second.weight": torch.zeros(8, 3, 1, 1)}),
], ids=["caffe", "torch", "two_rgb_kernels"])
def test_fold_bgr_flip_gate(state, mode, extra):
    assert registry.fold_bgr_flip_into_stem({**state, **extra}, mode) is None


def test_folded_stem_gives_the_flipped_features(state):
    """The folded weights on BGR input equal the unfolded ones on RGB."""
    x = np.random.default_rng(5).uniform(-1, 1, (2, 75, 75, 3)).astype(np.float32)
    plain, folded = InceptionV3(include_top=False), InceptionV3(include_top=False)
    headless = {k: v for k, v in state.items() if not k.startswith("predictions")}
    plain.load_state_dict(headless, strict=True)
    folded.load_state_dict(registry.fold_bgr_flip_into_stem(headless, "tf"), strict=True)
    with torch.inference_mode():
        want = plain.eval()(_nchw(x[..., ::-1].copy()))
        got = folded.eval()(_nchw(x))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", list(jax_registry.SUPPORTED_MODELS))
def test_registry_entry_matches_jax(name):
    want = jax_registry.get_keras_application_model(name)
    got = registry.get_keras_application_model(name)
    assert got.inputShape() == want.inputShape()
    assert got.feature_size == want.feature_size
    assert got.preprocess_mode == want.preprocess_mode
    assert got.keras_name == want.keras_name
    module = got.make_module()
    assert type(module).__name__ == want.flax_cls.__name__
    assert got.module_kwargs == want.module_kwargs
    if name == "InceptionV3":
        assert isinstance(module, InceptionV3)


def test_registry_refuses_unknown_name():
    assert registry.SUPPORTED_MODELS == jax_registry.SUPPORTED_MODELS
    with pytest.raises(ValueError, match="Unsupported model"):
        registry.get_keras_application_model("AlexNet")
