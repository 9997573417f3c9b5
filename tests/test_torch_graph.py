"""The port's graph layer against the JAX package's.

The cases of ``tests/test_graph_function.py``: every constructor against one
numpy oracle and against the JAX package's ``XlaFunction`` built the same
way; composition and ``from_list``; every piece; the name utils and the
``IsolatedSession`` shim; the save and load round trips of the port's own
format (``torch.export`` ``.pt2`` beside ``manifest.json``). Beside them, a
ViT-Ti with ``attn_impl="flash"`` exported with the flash forward as one op
node of its graph; ``from_keras`` on a ``.keras`` file, a legacy ``.h5``
file and an in-memory model, held to ``XlaFunction.from_keras`` on its
outputs and on what it records (names, ``input_hw``, ``input_specs``, the
fingerprint), exported, saved and loaded; and ``from_saved_model``, which
raises.
"""

import hashlib
import io
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sparkdl_tpu.graph import XlaFunction
from sparkdl_tpu.graph import pieces as jax_pieces
from sparkdl_tpu.models.vit import ViT as JaxViT
from sparkdl_tpu_torch.graph import GraphFunction, IsolatedSession, TorchFunction, pieces, utils
from sparkdl_tpu_torch.models.convert import vit_state_dict_from_flax
from sparkdl_tpu_torch.models.vit import ViT
from sparkdl_tpu_torch.ops.flash_attention import (
    flash_attention_fwd_lse_op,
    flash_attention_fwd_op,
    flash_attention_reference,
)

RNG = np.random.RandomState(7)
X = RNG.rand(4, 10).astype(np.float32)
W = RNG.rand(10, 3).astype(np.float32)
B = RNG.rand(3).astype(np.float32)
ORACLE = X @ W + B  # the one numpy oracle every constructor must match
TOL = dict(atol=1e-5, rtol=1e-5)  # tests/test_graph_function.py's
VIT_TOL = dict(atol=5e-4, rtol=5e-3)  # tests/test_ops.py's ViT tolerance
VIT = dict(variant="ViT-Ti/16", num_classes=4, image_size=32)
FLASH_OP = "sparkdl_tpu_torch.flash_attention_fwd.default"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _no_compile_cache(monkeypatch):
    monkeypatch.setenv("SPARKDL_COMPILE_CACHE", "off")


def _linear_apply(params, x):
    return x @ params["w"] + params["b"]


def _check(fn, params=None, x=X, want=ORACLE):
    kw = {"device": "cpu"} if isinstance(fn, TorchFunction) else {}
    out = fn(x, **kw) if params is None else fn(x, params=params, **kw)
    np.testing.assert_allclose(np.asarray(out), want, **TOL)


def _jax_linear():
    return XlaFunction.from_callable(_linear_apply, params={"w": W, "b": B}, takes_params=True)


def _linear(**kw):
    return TorchFunction.from_callable(_linear_apply, params={"w": W, "b": B},
                                       takes_params=True, **kw)


# -- constructor matrix ----------------------------------------------------

def test_from_callable_with_params():
    fn = _linear()
    _check(fn)
    np.testing.assert_allclose(fn(X, device="cpu").numpy(), np.asarray(_jax_linear()(X)), **TOL)
    _check(fn, params={"w": W, "b": B})
    assert fn.input_names == ["input"] and fn.output_names == ["output"]


def test_from_callable_pure():
    w, b = torch.from_numpy(W), torch.from_numpy(B)
    fn = TorchFunction.from_callable(lambda x: x @ w + b)
    _check(fn)
    assert fn.params == {}
    assert GraphFunction is TorchFunction


def test_from_module_matches_from_flax():
    import flax.linen as nn

    class Dense(nn.Module):
        @nn.compact
        def __call__(self, x):
            return nn.Dense(3)(x)

    jax_fn = XlaFunction.from_flax(
        Dense(), {"params": {"Dense_0": {"kernel": jnp.asarray(W), "bias": jnp.asarray(B)}}}
    )
    module = torch.nn.Linear(10, 3)
    state = {"weight": torch.from_numpy(W.T.copy()), "bias": torch.from_numpy(B)}
    fn = TorchFunction.from_module(module, state)
    _check(fn)
    np.testing.assert_allclose(fn(X, device="cpu").numpy(), np.asarray(jax_fn(X)), **TOL)
    assert fn.name == "Linear"
    # the params ride apart from the module: its own weights are untouched
    assert not torch.equal(module.weight, state["weight"])


@pytest.fixture(scope="module")
def vit_case():
    images = np.random.RandomState(0).rand(3, 32, 32, 3).astype(np.float32)
    variables = JaxViT(**{k: VIT[k] for k in VIT}).init(jax.random.PRNGKey(0),
                                                         jnp.asarray(images))
    variables = jax.tree_util.tree_map(np.asarray, variables)
    return images, variables


@pytest.mark.parametrize("features_only", [False, True], ids=["logits", "features"])
def test_from_module_vit_matches_from_flax(vit_case, features_only):
    images, variables = vit_case
    jax_fn = XlaFunction.from_flax(JaxViT(**VIT), variables, features_only=features_only)
    fn = TorchFunction.from_module(ViT(**VIT, attn_impl="flash"),
                                   vit_state_dict_from_flax(variables),
                                   features_only=features_only)
    np.testing.assert_allclose(fn(images, device="cpu").numpy(), np.asarray(jax_fn(images)), **VIT_TOL)


def test_from_module_method():
    module = torch.nn.Linear(10, 3)
    fn = TorchFunction.from_module(
        module, {"weight": torch.from_numpy(W.T.copy()), "bias": torch.from_numpy(B)},
        method="forward",
    )
    _check(fn)


def test_from_npz(tmp_path):
    path = str(tmp_path / "params.npz")
    np.savez(path, **{"w": W, "b": B})
    _check(TorchFunction.from_npz(path, _linear_apply))
    _check(XlaFunction.from_npz(path, _linear_apply))


def test_from_npz_nests_scoped_keys(tmp_path):
    path = str(tmp_path / "scoped.npz")
    np.savez(path, **{"dense/w": W, "dense/b": B})
    fn = TorchFunction.from_npz(path, lambda p, x: _linear_apply(p["dense"], x))
    jax_fn = XlaFunction.from_npz(path, lambda p, x: _linear_apply(p["dense"], x))
    assert sorted(fn.params["dense"]) == sorted(jax_fn.params["dense"]) == ["b", "w"]
    _check(fn)


def test_from_checkpoint(tmp_path):
    path = str(tmp_path / "params.pt")
    torch.save({"w": torch.from_numpy(W), "b": torch.from_numpy(B)}, path)
    fn = TorchFunction.from_checkpoint(path, _linear_apply)
    _check(fn)
    assert fn.name == "checkpoint"


def test_from_keras_and_from_saved_model_raise():
    # from_keras is ported (the from_keras tests below); from_saved_model
    # still raises: the port has no TensorFlow
    with pytest.raises(NotImplementedError, match="6b"):
        TorchFunction.from_saved_model("saved_model_dir")


@pytest.fixture(scope="module")
def keras_cnn(tmp_path_factory):
    """A small Keras CNN with seeded weights, saved as .keras and .h5."""
    import keras

    model = keras.Sequential([
        keras.Input((12, 10, 3)),
        keras.layers.Conv2D(4, 3, strides=2, padding="same", activation="relu"),
        keras.layers.BatchNormalization(),
        keras.layers.GlobalAveragePooling2D(),
        keras.layers.Dense(3, activation="softmax"),
    ], name="small_cnn")
    rng = np.random.RandomState(3)
    model.set_weights([np.abs(rng.randn(*w.shape)).astype(np.float32) * 0.3 + 0.1
                       for w in model.get_weights()])
    root = tmp_path_factory.mktemp("keras_cnn")
    paths = {fmt: str(root / f"small_cnn.{fmt}") for fmt in ("keras", "h5")}
    for path in paths.values():
        model.save(path)
    return model, paths


@pytest.mark.parametrize("source", ["keras", "h5", "model"])
def test_from_keras_matches_the_jax_package(keras_cnn, source):
    model, paths = keras_cnn
    arg = model if source == "model" else paths[source]
    fn, jax_fn = TorchFunction.from_keras(arg), XlaFunction.from_keras(arg)
    x = np.random.RandomState(4).uniform(0, 1, (5, 12, 10, 3)).astype(np.float32)
    np.testing.assert_allclose(fn(x, device="cpu").numpy(), np.asarray(jax_fn(x)),
                               rtol=1e-4, atol=1e-5)
    assert (fn.name, fn.input_names, fn.output_names) == \
        (jax_fn.name, jax_fn.input_names, jax_fn.output_names) == \
        ("small_cnn", ["input"], ["output"])
    assert fn.input_hw == jax_fn.input_hw == (12, 10)
    assert [(tuple(s), np.dtype(d)) for s, d in fn.input_specs] == \
        [(tuple(s), np.dtype(d)) for s, d in jax_fn.input_specs] == [((1, 12, 10, 3), np.float32)]
    if source == "model":
        assert fn.fingerprint is None and jax_fn.fingerprint is None
    else:
        st = os.stat(paths[source])
        want = f"keras:{os.path.abspath(paths[source])}:{st.st_mtime_ns}:{st.st_size}:float32"
        assert fn.fingerprint == jax_fn.fingerprint == want
        bf16 = TorchFunction.from_keras(paths[source], compute_dtype="bfloat16")
        assert bf16.fingerprint == want.replace(":float32", ":bfloat16")


def test_from_keras_without_a_static_input_size(tmp_path):
    import keras

    model = keras.Sequential([keras.Input((None, None, 3)),
                              keras.layers.GlobalAveragePooling2D()])
    fn, jax_fn = TorchFunction.from_keras(model), XlaFunction.from_keras(model)
    assert fn.input_hw is None and jax_fn.input_hw is None
    assert fn.input_specs is None and getattr(jax_fn, "input_specs", None) is None
    x = np.random.RandomState(5).rand(2, 7, 9, 3).astype(np.float32)
    np.testing.assert_allclose(fn(x, device="cpu").numpy(), x.mean(axis=(1, 2)), **TOL)


def test_from_keras_exports_saves_and_loads(keras_cnn, tmp_path):
    _, paths = keras_cnn
    fn = TorchFunction.from_keras(paths["keras"])
    fn.save(str(tmp_path / "saved"))  # the recorded input specs
    loaded = TorchFunction.load(str(tmp_path / "saved"))
    assert loaded.name == "small_cnn"
    x = np.random.RandomState(6).rand(3, 12, 10, 3).astype(np.float32)
    np.testing.assert_array_equal(loaded(x, device="cpu").numpy(),
                                  fn(x, device="cpu").numpy())


# -- serialization --------------------------------------------------------

def test_export_roundtrip_is_batch_polymorphic():
    blob = _linear().export(((4, 10), np.float32))
    assert isinstance(blob, bytes) and len(blob) > 0
    fn = TorchFunction.from_exported(blob)
    _check(fn)
    for n in (1, 8):
        x = np.vstack([X] * 2)[:n]
        np.testing.assert_allclose(fn(x, device="cpu").numpy(), (x @ W + B), **TOL)
    assert fn.fingerprint == "pt2:" + hashlib.sha256(blob).hexdigest()


def test_export_with_a_static_batch():
    fn = TorchFunction.from_exported(
        _linear().export(((4, 10), np.float32), batch_polymorphic=False))
    _check(fn)
    with pytest.raises(Exception):
        fn(X[:2], device="cpu")


def test_save_load_dir(tmp_path):
    path = str(tmp_path / "exported")
    _linear(name="lin").save(path, ((4, 10), np.float32))
    assert sorted(os.listdir(path)) == ["function.pt2", "manifest.json"]
    fn = TorchFunction.load(path)
    assert fn.name == "lin"
    assert fn.input_specs == [((4, 10), torch.float32)]
    _check(fn)
    with open(os.path.join(path, "function.pt2"), "rb") as fh:
        assert fn.fingerprint == "pt2:" + hashlib.sha256(fh.read()).hexdigest()
    # a loaded function writes its program back as it was read
    again = str(tmp_path / "again")
    fn.save(again)
    with open(os.path.join(path, "function.pt2"), "rb") as a, \
            open(os.path.join(again, "function.pt2"), "rb") as b:
        assert a.read() == b.read()
    assert TorchFunction.load(again).input_specs == fn.input_specs


def test_save_uses_recorded_specs_and_needs_them(tmp_path):
    fn = TorchFunction.from_callable(lambda x: 2 * x, input_names=("x",),
                                     output_names=("y",), name="double")
    with pytest.raises(ValueError, match="no recorded input specs"):
        fn.save(str(tmp_path / "none"))
    fn.input_specs = [((4, 3), np.float32)]
    fn.save(str(tmp_path / "double"))
    loaded = TorchFunction.load(str(tmp_path / "double"))
    assert (loaded.input_names, loaded.output_names) == (["x"], ["y"])
    x = np.arange(12, dtype=np.float32).reshape(4, 3)
    np.testing.assert_array_equal(loaded(x, device="cpu").numpy(), 2 * x)


def test_multi_input_multi_output_export(tmp_path):
    fn = TorchFunction.from_callable(
        lambda a, b: (a + b, (a * b).sum(-1)), input_names=("a", "b"),
        output_names=("sum", "dot"),
    )
    a, b = RNG.rand(5, 3).astype(np.float32), RNG.rand(5, 3).astype(np.float32)
    fn.save(str(tmp_path / "two"), ((2, 3), np.float32), ((2, 3), np.float32))
    loaded = TorchFunction.load(str(tmp_path / "two"))
    for got, want in zip(loaded(a, b, device="cpu"), fn(a, b, device="cpu")):
        torch.testing.assert_close(got, want)


def test_integer_inputs_export(tmp_path):
    fn = TorchFunction.from_callable(lambda x: x * 2, input_names=("ids",))
    fn.save(str(tmp_path / "ids"), ((2, 3), "int32"))
    loaded = TorchFunction.load(str(tmp_path / "ids"))
    out = loaded(np.array([[1, 2, 3]], np.int32), device="cpu")
    assert out.dtype == torch.int32 and out.tolist() == [[2, 4, 6]]


def test_call_places_inputs_and_params_on_its_device(tmp_path, monkeypatch):
    """A call runs on the card unless the caller asks for the CPU: without a
    card and without ``device="cpu"``, numpy input raises for an in-memory
    function and for a loaded one; with it, inputs and params land on the
    CPU, and the function's own params are placed once per device."""
    fn = TorchFunction.from_callable(_linear_apply, {"w": W, "b": B}, takes_params=True)
    fn.save(str(tmp_path / "lin"), ((4, 10), np.float32))
    loaded = TorchFunction.load(str(tmp_path / "lin"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for f in (fn, loaded):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            f(X)
        out = f(X, device="cpu")
        assert out.device.type == "cpu"
        np.testing.assert_allclose(out.numpy(), ORACLE, **TOL)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        loaded.apply({})
    placed = fn._placed[2]
    fn(X, device="cpu")
    assert fn._placed[2] is placed
    fn.params = {"w": np.zeros_like(W), "b": B}
    np.testing.assert_allclose(fn(X, device="cpu").numpy(), np.broadcast_to(B, ORACLE.shape))
    np.testing.assert_allclose(
        fn(X, params={"w": W, "b": np.zeros_like(B)}, device="cpu").numpy(), X @ W, **TOL)


# -- the flash-attention op in exported programs ---------------------------

def _flash_vit(variables):
    return TorchFunction.from_module(ViT(**VIT, attn_impl="flash"),
                                     vit_state_dict_from_flax(variables), name="vit")


def test_exported_flash_vit_keeps_the_op_node(vit_case, tmp_path):
    images, variables = vit_case
    fn = _flash_vit(variables)
    program = torch.export.load(io.BytesIO(fn.export(((2, 32, 32, 3), torch.float32))))
    targets = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
    # one forward per block, and no plain attention in its place
    assert targets.count(FLASH_OP) == 12
    assert not [t for t in targets
                if any(s in t for s in ("softmax", "logsumexp", "aten.exp."))]

    fn.save(str(tmp_path / "vit"), ((2, 32, 32, 3), torch.float32))
    loaded = TorchFunction.load(str(tmp_path / "vit"))
    assert [str(n.target) for n in loaded.exported_program.graph.nodes].count(FLASH_OP) == 12
    for n in (1, 3):
        torch.testing.assert_close(loaded(images[:n], device="cpu"), fn(images[:n], device="cpu"), atol=1e-6, rtol=1e-6)
    jax_fn = XlaFunction.from_flax(JaxViT(**VIT), variables)
    np.testing.assert_allclose(loaded(images, device="cpu").numpy(), np.asarray(jax_fn(images)), **VIT_TOL)


def test_kernel_input_is_checked_at_launch():
    """The op's CUDA implementation checks what the kernel takes before it
    launches, so a loaded program that feeds the op a q strided along
    head_dim raises as an eager call does. The check reads shapes, strides
    and dtypes only, so it runs here on CPU tensors."""
    from importlib import import_module

    launch = import_module("sparkdl_tpu_torch.ops.flash_attention")._forward_cuda
    q = torch.zeros(2, 4, 64, 3).transpose(2, 3)
    with pytest.raises(ValueError, match="contiguous along head_dim"):
        launch(q, q, q, False, 0.125, 4, False)
    ok = torch.zeros(2, 4, 3, 64)
    with pytest.raises(ValueError, match="head_dim 48"):
        launch(ok[..., :48].contiguous(), ok[..., :48].contiguous(),
               ok[..., :48].contiguous(), False, 0.125, 4, True)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        launch(ok.half(), ok.half(), ok.half(), False, 0.125, 4, False)
    big = torch.zeros(1, 1, 1, 32).expand(65536, 1, 1, 32)
    with pytest.raises(ValueError, match="at most 65535"):
        launch(big, big, big, False, 0.125, 1, False)


def test_exported_dense_vit_has_no_flash_op(vit_case):
    _, variables = vit_case
    fn = TorchFunction.from_module(ViT(**VIT, attn_impl="full"),
                                   vit_state_dict_from_flax(variables))
    program = torch.export.load(io.BytesIO(fn.export(((2, 32, 32, 3), torch.float32))))
    assert FLASH_OP not in [str(n.target) for n in program.graph.nodes]


@pytest.mark.parametrize("op", [flash_attention_fwd_op, flash_attention_fwd_lse_op],
                         ids=["fwd", "fwd_lse"])
def test_flash_ops_pass_opcheck(op):
    rng = np.random.RandomState(3)
    q, k, v = (torch.from_numpy(rng.randn(2, 40, 3, 32).astype(np.float32)) for _ in range(3))
    torch.library.opcheck(op, (q, k, v, False, 32 ** -0.5, 40))
    torch.library.opcheck(op, (q, k, v, True, 0.2, 33))
    want = flash_attention_reference(q, k, v, causal=True, scale=0.2, kv_len=33,
                                     return_lse=op is flash_attention_fwd_lse_op)
    for got, w in zip(torch.utils._pytree.tree_leaves(op(q, k, v, True, 0.2, 33)),
                      torch.utils._pytree.tree_leaves(want)):
        torch.testing.assert_close(got, w, atol=0, rtol=0)


# -- composition and pieces ------------------------------------------------

def test_compose_and_from_list():
    relu = TorchFunction.from_callable(lambda x: torch.clamp(x, min=0))
    double = TorchFunction.from_callable(lambda x: x * 2)
    piped = TorchFunction.from_list([_linear(), relu, double])
    np.testing.assert_allclose(piped(X, device="cpu").numpy(), np.maximum(ORACLE, 0) * 2, **TOL)
    np.testing.assert_allclose(_linear().compose(relu)(X, device="cpu").numpy(), np.maximum(ORACLE, 0), **TOL)
    jax_piped = XlaFunction.from_list([
        _jax_linear(), XlaFunction.from_callable(lambda x: jnp.maximum(x, 0)),
        XlaFunction.from_callable(lambda x: x * 2),
    ])
    np.testing.assert_allclose(piped(X, device="cpu").numpy(), np.asarray(jax_piped(X)), **TOL)
    assert piped.name == "pipeline" and set(piped.params) == {"f0", "f1", "f2"}
    with pytest.raises(ValueError):
        TorchFunction.from_list([])


def test_composition_exports(tmp_path):
    piped = TorchFunction.from_list([_linear(), TorchFunction.from_callable(torch.tanh)])
    piped.save(str(tmp_path / "piped"), ((4, 10), np.float32))
    np.testing.assert_allclose(TorchFunction.load(str(tmp_path / "piped"))(X, device="cpu").numpy(),
                               np.tanh(ORACLE), **TOL)


@pytest.mark.parametrize("order", ["BGR", "RGB", "L"])
def test_sp_image_converter_piece(order):
    channels = 1 if order == "L" else 3
    img = RNG.randint(0, 255, (2, 4, 4, channels)).astype(np.uint8)
    got = pieces.build_sp_image_converter(order)(img, device="cpu")
    assert got.dtype == torch.float32
    want = np.asarray(jax_pieces.build_sp_image_converter(order)(img))
    np.testing.assert_array_equal(got.numpy(), want)
    if order == "BGR":
        np.testing.assert_array_equal(got.numpy(), img[..., ::-1].astype(np.float32))
    with pytest.raises(ValueError):
        pieces.build_sp_image_converter("XYZ")


def test_flattener_piece():
    x = RNG.rand(3, 4, 5).astype(np.float32)
    got = pieces.build_flattener()(x, device="cpu")
    assert tuple(got.shape) == (3, 20)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_pieces.build_flattener()(x)))


@pytest.mark.parametrize("size", [(4, 4), (12, 6)], ids=["down", "mixed"])
def test_resizer_piece(size):
    x = RNG.randint(0, 255, (2, 8, 8, 3)).astype(np.float32)
    got = pieces.build_resizer(size)(x, device="cpu").numpy()
    assert got.shape == (2, *size, 3)
    assert got.min() >= 0 and got.max() <= 255
    # jax.image.resize on the CPU is up to 3e-3 off a float64 product of
    # its own weights (0-255 scale); the port's is within 3e-5
    np.testing.assert_allclose(got, np.asarray(jax_pieces.build_resizer(size)(x)), atol=5e-3)
    with pytest.raises(ValueError, match="not ported"):
        pieces.build_resizer(size, method="nearest")


@pytest.mark.parametrize("mode", ["tf", "caffe", "torch", "none"])
def test_preprocessor_modes(mode):
    x = RNG.uniform(0, 255, (2, 3, 3, 3)).astype(np.float32)
    got = pieces.build_preprocessor(mode)(x, device="cpu").numpy()
    np.testing.assert_allclose(got, np.asarray(jax_pieces.build_preprocessor(mode)(x)),
                               atol=1e-4, rtol=1e-6)
    full = np.full((1, 2, 2, 3), 255.0, dtype=np.float32)
    if mode == "tf":
        np.testing.assert_allclose(pieces.build_preprocessor("tf")(full, device="cpu").numpy(),
                                   np.ones_like(full), atol=1e-6)
    if mode == "caffe":
        np.testing.assert_allclose(pieces.build_preprocessor("caffe")(full, device="cpu").numpy()[0, 0, 0],
                                   255.0 - np.array([103.939, 116.779, 123.68]), atol=1e-4)


def test_preprocessor_rejects_an_unknown_mode():
    with pytest.raises(ValueError):
        pieces.build_preprocessor("nope")
    with pytest.raises(ValueError):
        jax_pieces.build_preprocessor("nope")


def test_pipeline_converter_model_flatten():
    """The original's flagship composition: spImageConverter -> model ->
    flattener."""
    imgs = RNG.randint(0, 255, (3, 4, 4, 3)).astype(np.uint8)
    piped = TorchFunction.from_list([
        pieces.build_sp_image_converter("BGR"),
        TorchFunction.from_callable(lambda x: x.mean(dim=3, keepdim=True)),
        pieces.build_flattener(),
    ])
    got = piped(imgs, device="cpu").numpy()
    assert got.shape == (3, 16)
    np.testing.assert_allclose(got, imgs[..., ::-1].astype(np.float32).mean(3).reshape(3, -1),
                               atol=1e-4)
    jax_piped = XlaFunction.from_list([
        jax_pieces.build_sp_image_converter("BGR"),
        XlaFunction.from_callable(lambda x: x.mean(axis=3, keepdims=True)),
        jax_pieces.build_flattener(),
    ])
    np.testing.assert_allclose(got, np.asarray(jax_piped(imgs)), atol=1e-4)


# -- utils and the builder shim -------------------------------------------

def test_name_utils():
    assert utils.tensor_name("x") == "x:0"
    assert utils.tensor_name("x:1") == "x:1"
    assert utils.op_name("x:0") == "x"
    assert utils.op_name("x") == "x"
    assert utils.add_scope_to_name("scope", "x") == "scope/x"
    assert utils.add_scope_to_name("", "x") == "x"
    with pytest.raises(ValueError):
        utils.tensor_name("x:bad")
    with pytest.raises(ValueError):
        utils.op_name("x:bad")


def test_validated_io():
    fn = TorchFunction.from_callable(lambda x: x, input_names=["a"], output_names=["b"])
    assert utils.validated_input(fn, "a:0") == "a"
    assert utils.validated_output(fn, "b") == "b"
    with pytest.raises(ValueError):
        utils.validated_input(fn, "zz")
    with pytest.raises(ValueError):
        utils.validated_output(fn, "zz")
    assert utils.validated_graph(fn) is fn
    with pytest.raises(TypeError):
        utils.validated_graph(XlaFunction.from_callable(lambda x: x))
    with pytest.raises(ValueError, match="Duplicate"):
        utils.validated_graph(TorchFunction.from_callable(lambda x: x, input_names=["a", "a"]))


def test_isolated_session_shim():
    with IsolatedSession() as issn:
        gfn = issn.makeGraphFunction(lambda x: x * 3)
        imported_io = issn.importGraphFunction(gfn)
        assert imported_io == (["input"], ["output"])
        packaged = issn.asGraphFunction(["input"], ["output"])
        np.testing.assert_allclose(issn.run(lambda x: x + 1, torch.ones(2)).numpy(), [2, 2])
    np.testing.assert_allclose(packaged(X, device="cpu").numpy(), X * 3, atol=1e-6)
    with pytest.raises(RuntimeError, match="Nothing staged"):
        IsolatedSession().asGraphFunction(["input"], ["output"])
