"""The port's ViT against the JAX package's, from the same Flax weights.

ViT-Ti/16 at image_size=32 (the geometry tests/test_ops.py uses), initialised
by Flax with PRNGKey(0) and carried across by ``vit_state_dict_from_flax``.
The JAX side runs its dense attention, the plain reference of its Pallas
kernel; the port runs ``"full"`` and ``"flash"`` (the kernel's plain version
on the CPU).
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sparkdl_tpu.models.vit import ViT as JaxViT
from sparkdl_tpu_torch.models.convert import vit_state_dict_from_flax
from sparkdl_tpu_torch.models.vit import ViT

TOL = dict(atol=5e-4, rtol=5e-3)  # tests/test_ops.py's ViT tolerance
GEOMETRY = dict(variant="ViT-Ti/16", num_classes=4, image_size=32)


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
def images():
    return np.random.RandomState(0).rand(2, 32, 32, 3).astype(np.float32)


@pytest.fixture(scope="module")
def flax_params(images):
    variables = JaxViT(**GEOMETRY).init(jax.random.PRNGKey(0), jnp.asarray(images))
    return jax.tree_util.tree_map(np.asarray, variables)


def _port(params, **kw):
    model = ViT(**GEOMETRY, **kw)
    model.load_state_dict(vit_state_dict_from_flax(params), strict=True)
    return model.eval()


@pytest.mark.parametrize("exact_gelu", [False, True], ids=["tanh_gelu", "exact_gelu"])
@pytest.mark.parametrize("attn_impl", ["full", "flash"])
def test_vit_matches_jax(flax_params, images, attn_impl, exact_gelu):
    jax_model = JaxViT(**GEOMETRY, exact_gelu=exact_gelu)
    x = jnp.asarray(images)
    want_logits = np.asarray(jax_model.apply(flax_params, x))
    want_feats = np.asarray(jax_model.apply(flax_params, x, features_only=True))

    model = _port(flax_params, attn_impl=attn_impl, exact_gelu=exact_gelu)
    with torch.inference_mode():
        logits = model(torch.from_numpy(images))
        feats = model(torch.from_numpy(images), features_only=True)
    assert logits.shape == (2, 4) and feats.shape == (2, 192)
    np.testing.assert_allclose(logits.numpy(), want_logits, **TOL)
    np.testing.assert_allclose(feats.numpy(), want_feats, **TOL)


@pytest.mark.parametrize("attn_impl", ["full", "flash"])
def test_bf16_vit_matches_jax(flax_params, images, attn_impl):
    """``dtype`` is the computation type, as in Flax: float32 parameters,
    bf16 arithmetic. bf16 keeps 8 significant bits and the two frameworks
    round at different places through 12 blocks, so the bound is about 50
    bf16 roundoffs (2**-9) at unit scale plus 2% of the value."""
    bf16_tol = dict(atol=0.1, rtol=2e-2)
    jax_model = JaxViT(**GEOMETRY, dtype=jnp.bfloat16)
    x = jnp.asarray(images)
    model = _port(flax_params, attn_impl=attn_impl, dtype=torch.bfloat16)
    with torch.inference_mode():
        logits = model(torch.from_numpy(images))
        feats = model(torch.from_numpy(images), features_only=True)
    assert logits.dtype == feats.dtype == torch.bfloat16
    for got, want in (
        (logits, jax_model.apply(flax_params, x)),
        (feats, jax_model.apply(flax_params, x, features_only=True)),
    ):
        np.testing.assert_allclose(
            got.float().numpy(), np.asarray(want.astype(jnp.float32)), **bf16_tol
        )


def test_headless_vit_returns_features(flax_params, images):
    params = copy.deepcopy(flax_params)
    del params["params"]["head"]
    model = ViT(**GEOMETRY, include_top=False)
    model.load_state_dict(vit_state_dict_from_flax(params), strict=True)
    want = np.asarray(JaxViT(**GEOMETRY).apply(
        flax_params, jnp.asarray(images), features_only=True
    ))
    with torch.inference_mode():
        got = model.eval()(torch.from_numpy(images))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_converter_layouts(flax_params):
    state = vit_state_dict_from_flax(flax_params)
    p = flax_params["params"]
    np.testing.assert_array_equal(
        state["patch_embed.weight"].numpy(),
        p["patch_embed"]["kernel"].transpose(3, 2, 0, 1),
    )
    np.testing.assert_array_equal(
        state["blocks.3.qkv.weight"].numpy(), p["block_3"]["qkv"]["kernel"].T
    )
    np.testing.assert_array_equal(
        state["blocks.0.ln_2.weight"].numpy(), p["block_0"]["ln_2"]["scale"]
    )
    assert set(state) == set(ViT(**GEOMETRY).state_dict())


def test_converter_raises_on_missing_key(flax_params):
    params = copy.deepcopy(flax_params)
    del params["params"]["block_5"]["qkv"]["bias"]
    with pytest.raises(KeyError, match="missing key block_5/qkv/bias"):
        vit_state_dict_from_flax(params)


@pytest.mark.parametrize("where", ["root", "block", "leaf"])
def test_converter_raises_on_unused_key(flax_params, where):
    params = copy.deepcopy(flax_params)
    extra = np.zeros(3, np.float32)
    target = {
        "root": params["params"],
        "block": params["params"]["block_2"],
        "leaf": params["params"]["block_2"]["mlp_up"],
    }[where]
    target["surplus"] = extra
    with pytest.raises(KeyError, match="unused keys"):
        vit_state_dict_from_flax(params)


def test_unknown_attn_impl_raises():
    with pytest.raises(ValueError, match="attn_impl"):
        ViT(**GEOMETRY, attn_impl="ring")
