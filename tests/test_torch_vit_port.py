"""The port's ViT checkpoint import (``models/vit_port.py``) against the
JAX package's ``sparkdl_tpu.models.vit_port``.

A tiny ViT (patch 8, dim 64, depth 2, 2 heads, MLP 128) is registered in
both packages' ``VIT_VARIANTS`` for the tests. Weights: a seeded numpy tree
in the Flax layout, shaped by the JAX module's ``init``, or a random-init
Hugging Face ``ViTForImageClassification`` (``transformers`` serves as an
oracle in the tests only; the port reads the model duck-typed).

- ``.npz``: the port's import of a file the JAX ``export_vit_npz`` wrote
  equals the JAX import carried across by ``vit_state_dict_from_flax``, bit
  for bit, and the round trips through either package's writer are exact;
- ``adapt_vit_variables``: equal to the JAX result at ``atol=1e-6`` (the
  pos-embed grid is a bilinear resize in float32 on both sides);
- Hugging Face: the port's import equals the JAX import bit for bit, and
  its logits equal HF's forward at tests/test_ops.py's ViT tolerance.
"""

import numpy as np
import pytest
import torch

import jax

transformers = pytest.importorskip("transformers")

from sparkdl_tpu.models import vit as jax_vit  # noqa: E402
from sparkdl_tpu.models import vit_port as jax_vit_port  # noqa: E402
from sparkdl_tpu_torch.models import vit as port_vit  # noqa: E402
from sparkdl_tpu_torch.models.convert import (  # noqa: E402
    vit_flax_from_state_dict,
    vit_state_dict_from_flax,
)
from sparkdl_tpu_torch.models.vit import ViT  # noqa: E402
from sparkdl_tpu_torch.models.vit_port import (  # noqa: E402
    adapt_vit_variables,
    export_vit_npz,
    port_hf_vit,
    port_vit_npz,
)

TINY = (8, 64, 2, 2, 128)  # patch, dim, depth, heads, mlp_dim
SLICE_TOL = dict(atol=5e-4, rtol=5e-3)  # tests/test_ops.py's ViT tolerance
ADAPT_TOL = dict(atol=1e-6, rtol=0)


@pytest.fixture(autouse=True)
def _tiny_variant(monkeypatch):
    monkeypatch.setitem(jax_vit.VIT_VARIANTS, "tiny-test", TINY)
    monkeypatch.setitem(port_vit.VIT_VARIANTS, "tiny-test", TINY)
    monkeypatch.setenv("SPARKDL_COMPILE_CACHE", "off")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _flax_tree(image_size=32, num_classes=10, seed=0):
    """A seeded numpy tree in the Flax layout of the JAX module."""
    shapes = jax.eval_shape(
        jax_vit.ViT("tiny-test", num_classes=num_classes, image_size=image_size).init,
        jax.random.PRNGKey(0), np.zeros((1, image_size, image_size, 3), np.float32))
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda s: (0.1 * rng.standard_normal(s.shape)).astype(np.float32), shapes)


def _assert_state_dicts_equal(got, want):
    assert set(got) == set(want)
    for name in want:
        assert got[name].dtype == want[name].dtype, name
        assert torch.equal(got[name], want[name]), name


def _assert_trees_equal(got, want):
    flat = dict(jax.tree_util.tree_leaves_with_path(want))
    leaves = jax.tree_util.tree_leaves_with_path(got)
    assert len(leaves) == len(flat)
    for path, leaf in leaves:
        np.testing.assert_array_equal(np.asarray(leaf), np.asarray(flat[path]),
                                      err_msg=jax.tree_util.keystr(path))


# -- .npz -------------------------------------------------------------------

@pytest.mark.parametrize("with_head", [True, False], ids=["head", "headless"])
def test_npz_import_equals_jax(tmp_path, with_head):
    tree = _flax_tree()
    if not with_head:
        del tree["params"]["head"]
    path = str(tmp_path / "vit.npz")
    jax_vit_port.export_vit_npz(tree, path)
    want = jax.tree_util.tree_map(np.asarray, jax_vit_port.port_vit_npz(path))
    _assert_state_dicts_equal(port_vit_npz(path), vit_state_dict_from_flax(want))
    _assert_trees_equal(port_vit_npz(path, flax=True), want)


def test_npz_round_trips_both_ways(tmp_path):
    """state_dict -> the port's .npz -> the port's import and the JAX
    import; the JAX .npz -> the port's import -> the port's .npz, equal
    file for file."""
    tree = _flax_tree(seed=1)
    state = vit_state_dict_from_flax(tree)
    ours = str(tmp_path / "ours.npz")
    export_vit_npz(state, ours)
    _assert_state_dicts_equal(port_vit_npz(ours), state)
    _assert_trees_equal(jax.tree_util.tree_map(np.asarray, jax_vit_port.port_vit_npz(ours)), tree)

    theirs = str(tmp_path / "theirs.npz")
    jax_vit_port.export_vit_npz(tree, theirs)
    again = str(tmp_path / "again.npz")
    export_vit_npz(port_vit_npz(theirs, flax=True), again)
    with np.load(theirs) as a, np.load(again) as b:
        assert sorted(a.files) == sorted(b.files)
        for name in a.files:
            assert a[name].dtype == b[name].dtype, name
            np.testing.assert_array_equal(a[name], b[name], err_msg=name)


def test_npz_ported_weights_run_the_module(tmp_path):
    """A ported checkpoint loads strictly into the port's ViT, and its logits
    equal the JAX module's on the same weights."""
    tree = _flax_tree(seed=2)
    path = str(tmp_path / "vit.npz")
    jax_vit_port.export_vit_npz(tree, path)
    model = ViT("tiny-test", num_classes=10, image_size=32)
    model.load_state_dict(port_vit_npz(path), strict=True)
    x = np.random.RandomState(0).rand(2, 32, 32, 3).astype(np.float32)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    with jax.default_matmul_precision("float32"):
        want = np.asarray(jax_vit.ViT("tiny-test", num_classes=10, image_size=32).apply(tree, x))
    np.testing.assert_allclose(got, want, **SLICE_TOL)


def test_npz_rejects_pre_logits(tmp_path):
    path = str(tmp_path / "in21k.npz")
    np.savez(path, **{"pre_logits/kernel": np.zeros((2, 2), np.float32)})
    with pytest.raises(ValueError, match="pre_logits"):
        port_vit_npz(path)


def test_export_needs_heads_for_another_geometry(tmp_path):
    tree = _flax_tree()
    del tree["params"]["block_1"]
    with pytest.raises(ValueError, match="cannot infer heads"):
        export_vit_npz(tree, str(tmp_path / "x.npz"))
    export_vit_npz(tree, str(tmp_path / "x.npz"), heads=2)
    assert set(port_vit_npz(str(tmp_path / "x.npz"))) == set(vit_state_dict_from_flax(tree))


# -- adapt_vit_variables ----------------------------------------------------

@pytest.mark.parametrize("size,classes,target,new_classes", [
    (32, 10, 48, 3),     # a 4x4 grid up to 6x6, a new head
    (64, 10, 32, None),  # 8x8 down to 4x4 (antialiased), the head kept
    (32, 10, 32, 10),    # the same geometry: passed through
    (32, 10, 32, 3),     # a new head only
], ids=["up_new_head", "down_keep_head", "same", "head_only"])
@pytest.mark.parametrize("form", ["state_dict", "flax"])
def test_adapt_matches_jax(size, classes, target, new_classes, form):
    tree = _flax_tree(image_size=size, num_classes=classes, seed=3)
    want = jax.tree_util.tree_map(
        np.asarray, jax_vit_port.adapt_vit_variables(tree, target, new_classes))
    given = vit_state_dict_from_flax(tree) if form == "state_dict" else tree
    got = adapt_vit_variables(given, target, new_classes)
    if form == "state_dict":
        assert all(isinstance(t, torch.Tensor) for t in got.values())
        got = vit_flax_from_state_dict(got)
    flat = dict(jax.tree_util.tree_leaves_with_path(want))
    for path, leaf in jax.tree_util.tree_leaves_with_path(got):
        assert np.shape(leaf) == np.shape(flat[path])
        np.testing.assert_allclose(np.asarray(leaf), flat[path], **ADAPT_TOL,
                                   err_msg=jax.tree_util.keystr(path))
    assert len(jax.tree_util.tree_leaves(got)) == len(flat)
    # the CLS slot passes through exactly, and the input is unchanged
    np.testing.assert_array_equal(np.asarray(got["params"]["pos_embed"])[:, 0],
                                  tree["params"]["pos_embed"][:, 0])
    assert tree["params"]["pos_embed"].shape[1] == (size // 8) ** 2 + 1
    model = ViT("tiny-test", num_classes=new_classes or classes, image_size=target)
    model.load_state_dict(vit_state_dict_from_flax(got), strict=True)


def test_adapt_rejects_a_size_off_the_patch_grid():
    with pytest.raises(ValueError, match="not a multiple"):
        adapt_vit_variables(_flax_tree(), image_size=30)


# -- Hugging Face -----------------------------------------------------------

def _hf_model(with_head=True):
    patch, dim, depth, heads, mlp = TINY
    cfg = transformers.ViTConfig(
        hidden_size=dim, num_hidden_layers=depth, num_attention_heads=heads,
        intermediate_size=mlp, image_size=32, patch_size=patch, num_labels=5,
        layer_norm_eps=1e-6,  # the ViT's LayerNorm epsilon
    )
    torch.manual_seed(0)
    cls = transformers.ViTForImageClassification if with_head else transformers.ViTModel
    return cls(cfg).eval()


@pytest.mark.parametrize("with_head", [True, False], ids=["classifier", "headless"])
def test_hf_import_equals_jax_and_runs_like_hf(with_head):
    hf = _hf_model(with_head)
    state = port_hf_vit(hf)
    want = jax.tree_util.tree_map(np.asarray, jax_vit_port.port_hf_vit(hf))
    _assert_state_dicts_equal(state, vit_state_dict_from_flax(want))
    _assert_trees_equal(port_hf_vit(hf, flax=True), want)
    assert ("head.weight" in state) == with_head

    model = ViT("tiny-test", num_classes=5, include_top=with_head, image_size=32,
                exact_gelu=True, attn_impl="flash")
    model.load_state_dict(state, strict=True)
    x = np.random.RandomState(0).randn(3, 32, 32, 3).astype(np.float32)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
        out = hf(torch.from_numpy(x.transpose(0, 3, 1, 2)))
    want_out = out.logits if with_head else out.last_hidden_state[:, 0]
    np.testing.assert_allclose(got, want_out.numpy(), **SLICE_TOL)
