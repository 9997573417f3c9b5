"""The port's CUDA kernels against their plain PyTorch versions, on the card.

A CUDA kernel has no CPU mode, so every test here is marked ``cuda`` and
skips without a card. The file imports no JAX, so it also runs where only
PyTorch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py
"""

import numpy as np
import pytest
import torch

from sparkdl_tpu_torch.ops.flash_attention import (
    FLASH_BWD_DKV,
    FLASH_BWD_DQ,
    FLASH_FWD,
    FLASH_FWD_LSE,
    flash_attention,
    flash_attention_bwd_reference,
    flash_attention_reference,
)

pytestmark = pytest.mark.cuda

F32_TOL = dict(atol=2e-4, rtol=2e-4)  # tests/test_ops.py's flash tolerance
BF16_TOL = dict(atol=2e-2, rtol=2e-2)  # bf16 output rounding
GRAD_TOL = dict(atol=1e-3, rtol=1e-3)  # tests/test_ops.py's flash-gradient tolerance
# bf16 gradients: one bf16 rounding of the value (float32 sums, one rounding
# at the store, as in the plain backward)
BF16_GRAD_TOL = dict(atol=1e-3, rtol=8e-3)

# (shape, kwargs): the cases of tests/test_ops.py:21-46, the ViT-B/16 shape,
# and ragged cases that reach the backward kernels' skips of padding: a last
# 64-row Q tile with one valid row, kv_len short of the sequence by more than
# one 8-key fragment, and causal over a ragged sequence
CASES = [
    ((2, 197, 3, 64), {}),
    ((1, 128, 2, 32), {}),
    ((2, 300, 4, 128), {}),
    ((1, 197, 2, 64), {"causal": True}),
    ((1, 256, 2, 64), {"kv_len": 200}),
    ((4, 197, 12, 64), {}),
    ((2, 193, 3, 64), {}),
    ((1, 256, 2, 64), {"kv_len": 197}),
    ((1, 300, 2, 128), {"causal": True}),
]
IDS = ["vit_ti", "block_multiple", "ragged_d128", "causal", "kv_len", "vit_b",
       "one_row_tile", "kv_len_197", "causal_300"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _qkv(shape, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(*shape).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape,kwargs", CASES, ids=IDS)
def test_kernel_matches_plain_version(cuda, shape, kwargs, dtype):
    q, k, v = (torch.from_numpy(a).to(cuda, dtype) for a in _qkv(shape, seed=4))
    launches = FLASH_FWD.launches, FLASH_FWD_LSE.launches
    out, lse = flash_attention(q, k, v, return_lse=True, **kwargs)
    want, want_lse = flash_attention_reference(q, k, v, return_lse=True, **kwargs)
    torch.cuda.synchronize()
    assert (FLASH_FWD.launches, FLASH_FWD_LSE.launches) == (launches[0], launches[1] + 1)
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    torch.testing.assert_close(out.float(), want.float(), **tol)
    torch.testing.assert_close(lse, want_lse, **F32_TOL)


def test_kernel_reads_strided_qkv(cuda):
    """q, k, v as views into one fused projection, as ViT makes them."""
    b, s, h, d = 2, 197, 3, 64
    rng = np.random.RandomState(5)
    qkv = torch.from_numpy(rng.randn(b, s, 3 * h * d).astype(np.float32)).to(cuda)
    q, k, v = (t.reshape(b, s, h, d) for t in qkv.chunk(3, dim=-1))
    assert not q.is_contiguous()
    got = flash_attention(q, k, v)
    torch.testing.assert_close(got, flash_attention_reference(q, k, v), **F32_TOL)


def test_kernel_refuses_what_it_does_not_take(cuda):
    q = torch.zeros((1, 8, 1, 48), device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention(q, q, q)
    h = torch.zeros((1, 8, 1, 64), device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        flash_attention(h, h, h)
    w = torch.zeros((1, 8, 1, 48), device=cuda, requires_grad=True)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention(w, w, w)


def _qkv_views(shape, dtype, seed, cuda, mul=1.0):
    """q, k, v as views into one fused (b, s, 3*h*d) projection, as ViT
    passes them, times ``mul``, and a random cotangent."""
    b, s, h, d = shape
    rng = np.random.RandomState(seed)
    qkv = torch.from_numpy(rng.randn(b, s, 3 * h * d).astype(np.float32) * mul)
    qkv = qkv.to(cuda, dtype)
    q, k, v = (t.reshape(b, s, h, d) for t in qkv.chunk(3, dim=-1))
    do = torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(cuda, dtype)
    return q, k, v, do


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape,kwargs", CASES, ids=IDS)
def test_backward_kernels_match_plain_version(cuda, shape, kwargs, dtype):
    """dQ and dK/dV kernels against flash_attention_bwd_reference on the
    same (strided) q, k, v, the forward's out and lse, and one cotangent."""
    q, k, v, do = _qkv_views(shape, dtype, seed=6, cuda=cuda)
    assert not q.is_contiguous()
    out, lse = flash_attention(q, k, v, return_lse=True, **kwargs)
    q_, k_, v_ = (t.detach().requires_grad_() for t in (q, k, v))
    launches = [k.launches for k in (FLASH_FWD, FLASH_FWD_LSE, FLASH_BWD_DQ, FLASH_BWD_DKV)]
    got = torch.autograd.grad(flash_attention(q_, k_, v_, **kwargs), (q_, k_, v_), do)
    torch.cuda.synchronize()
    assert [k.launches for k in (FLASH_FWD, FLASH_FWD_LSE, FLASH_BWD_DQ, FLASH_BWD_DKV)] == [
        launches[0], launches[1] + 1, launches[2] + 1, launches[3] + 1,
    ]
    want = flash_attention_bwd_reference(q, k, v, out, lse, do, **kwargs)
    tol = GRAD_TOL if dtype == torch.float32 else BF16_GRAD_TOL
    for g, w in zip(got, want):
        assert g.dtype == dtype and g.shape == shape
        torch.testing.assert_close(g.float(), w.float(), **tol)


@pytest.mark.parametrize("shape,kwargs", CASES, ids=IDS)
def test_gradients_match_autograd_of_plain_forward(cuda, shape, kwargs):
    """The autograd.Function on the card against autograd through the
    plain forward, in one random cotangent direction."""
    q, k, v, do = _qkv_views(shape, torch.float32, seed=7, cuda=cuda)
    grads = []
    for fn in (flash_attention, flash_attention_reference):
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        grads.append(torch.autograd.grad(fn(*leaves, **kwargs), leaves, do))
    for g, w in zip(*grads):
        torch.testing.assert_close(g, w, **GRAD_TOL)


def test_backward_is_deterministic(cuda):
    """No atomics: two backward passes give the same bytes."""
    q, k, v, do = _qkv_views((4, 197, 12, 64), torch.float32, seed=8, cuda=cuda)
    q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
    runs = [torch.autograd.grad(flash_attention(q, k, v), (q, k, v), do)
            for _ in range(2)]
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_backward_is_split_tf32_not_single_tf32(cuda):
    """The kernels compute each f32 product as three TF32 products (operands
    split in a TF32 value and its TF32 remainder), which keeps an error near
    f32's. With inputs x4 at the ViT-B shape (a peaked softmax), their
    gradients are at least 10x closer to the f32 plain backward than that
    plain backward run with TF32 products is."""
    q, k, v, do = _qkv_views((4, 197, 12, 64), torch.float32, seed=10, cuda=cuda, mul=4.0)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    got = torch.autograd.grad(flash_attention(*leaves), leaves, do)
    out, lse = flash_attention(q, k, v, return_lse=True)
    allow_tf32 = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        want = flash_attention_bwd_reference(q, k, v, out, lse, do)
        torch.backends.cuda.matmul.allow_tf32 = True
        tf32 = flash_attention_bwd_reference(q, k, v, out, lse, do)
        torch.cuda.synchronize()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow_tf32
    for name, g, w, single in zip("qkv", got, want, tf32):
        err = (g - w).abs().max().item()
        single_err = (single - w).abs().max().item()
        assert 10 * err <= single_err, f"d{name}: {err:.3e} vs TF32 {single_err:.3e}"


def test_backward_takes_rows_that_are_not_16_byte_aligned(cuda):
    """q/k/v one element into a wider buffer, so their rows are 4 bytes off a
    16-byte boundary: the kernels stage rows in 16-byte copies, so the
    wrapper hands them aligned copies, and the gradients still match the
    plain backward."""
    b, s, h, d = 2, 197, 3, 64
    rng = np.random.RandomState(12)
    buf = torch.from_numpy(rng.randn(b, s, 3 * h * d + 1).astype(np.float32)).to(cuda)
    q, k, v = (t.reshape(b, s, h, d) for t in buf[..., 1:].chunk(3, dim=-1))
    assert q.data_ptr() % 16 and q.stride(1) % 4
    do = torch.from_numpy(rng.randn(b, s, h, d).astype(np.float32)).to(cuda)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    got = torch.autograd.grad(flash_attention(*leaves), leaves, do)
    out, lse = flash_attention(q, k, v, return_lse=True)
    want = flash_attention_bwd_reference(q, k, v, out, lse, do)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **GRAD_TOL)


def test_forward_is_split_tf32_not_single_tf32(cuda):
    """The forward computes each f32 product as three TF32 products. With
    inputs x4 at the ViT-B shape (a peaked softmax), its output and lse are
    at least 10x closer to the f32 plain forward than that plain forward run
    with TF32 products is."""
    q, k, v, _ = _qkv_views((4, 197, 12, 64), torch.float32, seed=13, cuda=cuda, mul=4.0)
    got = flash_attention(q, k, v, return_lse=True)
    allow_tf32 = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        want = flash_attention_reference(q, k, v, return_lse=True)
        torch.backends.cuda.matmul.allow_tf32 = True
        tf32 = flash_attention_reference(q, k, v, return_lse=True)
        torch.cuda.synchronize()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow_tf32
    for name, g, w, single in zip(("out", "lse"), got, want, tf32):
        err = (g - w).abs().max().item()
        single_err = (single - w).abs().max().item()
        assert 10 * err <= single_err, f"{name}: {err:.3e} vs TF32 {single_err:.3e}"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_forward_takes_rows_that_are_not_16_byte_aligned(cuda, dtype):
    """q/k/v one element into a wider buffer, so their rows are off a 16-byte
    boundary: the kernel stages rows in 16-byte copies, so the wrapper hands
    it aligned copies, and the output and lse still match the plain forward."""
    b, s, h, d = 2, 197, 3, 64
    rng = np.random.RandomState(14)
    buf = torch.from_numpy(rng.randn(b, s, 3 * h * d + 1).astype(np.float32)).to(cuda, dtype)
    q, k, v = (t.reshape(b, s, h, d) for t in buf[..., 1:].chunk(3, dim=-1))
    assert q.data_ptr() % 16
    launches = FLASH_FWD_LSE.launches
    out, lse = flash_attention(q, k, v, return_lse=True)
    want, want_lse = flash_attention_reference(q, k, v, return_lse=True)
    torch.cuda.synchronize()
    assert FLASH_FWD_LSE.launches == launches + 1
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    torch.testing.assert_close(out.float(), want.float(), **tol)
    torch.testing.assert_close(lse, want_lse, **F32_TOL)


def test_forward_is_deterministic(cuda):
    """No atomics: two forward runs give the same bytes, output and lse."""
    q, k, v, _ = _qkv_views((4, 197, 12, 64), torch.float32, seed=15, cuda=cuda)
    runs = [flash_attention(q, k, v, return_lse=True) for _ in range(2)]
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_no_grad_call_takes_the_lse_free_forward(cuda):
    q, k, v, _ = _qkv_views((2, 197, 3, 64), torch.float32, seed=9, cuda=cuda)
    leaf = q.detach().requires_grad_()
    launches = FLASH_FWD.launches, FLASH_BWD_DQ.launches
    with torch.no_grad():
        out = flash_attention(leaf, k, v)
    assert not out.requires_grad
    assert (FLASH_FWD.launches, FLASH_BWD_DQ.launches) == (launches[0] + 1, launches[1])


@pytest.mark.parametrize("traced_on", ["cpu", "cuda"])
def test_exported_flash_vit_launches_the_kernel(cuda, tmp_path, traced_on):
    """A ViT-Ti function with attn_impl="flash", exported on either device,
    saved and loaded: its program runs on the card through the forward op,
    12 launches a call, and gives the in-memory function's rows."""
    from sparkdl_tpu_torch.graph import TorchFunction
    from sparkdl_tpu_torch.models.vit import ViT

    torch.manual_seed(0)
    module = ViT(variant="ViT-Ti/16", num_classes=4, image_size=32, attn_impl="flash")
    fn = TorchFunction.from_module(module, {k: v.to(traced_on)
                                            for k, v in module.state_dict().items()})
    fn.save(str(tmp_path / "vit"), ((2, 32, 32, 3), torch.float32))
    loaded = TorchFunction.load(str(tmp_path / "vit"))
    x = torch.from_numpy(np.random.RandomState(0).rand(3, 32, 32, 3).astype(np.float32))
    on_card = TorchFunction.from_module(module.to(cuda))
    want = on_card(x.to(cuda))
    launches = FLASH_FWD.launches
    got = loaded(x.to(cuda))
    torch.cuda.synchronize()
    assert FLASH_FWD.launches == launches + 12
    assert got.device.type == "cuda"
    torch.testing.assert_close(got, want, atol=5e-4, rtol=5e-3)


def test_loaded_program_checks_the_kernel_input(cuda, tmp_path):
    """A program traced on the CPU whose q, k, v are strided along head_dim:
    loaded and run on the card, the op's launch refuses them as an eager
    call does, rather than reading head_dim as contiguous."""
    from sparkdl_tpu_torch.graph import TorchFunction

    fn = TorchFunction.from_callable(
        lambda x: flash_attention(*(x.transpose(2, 3),) * 3))
    fn.save(str(tmp_path / "strided"), ((2, 16, 64, 2), torch.float32))
    loaded = TorchFunction.load(str(tmp_path / "strided"))
    x = torch.zeros((2, 16, 64, 2), device=cuda)
    with pytest.raises(ValueError, match="contiguous along head_dim"):
        flash_attention(*(x.transpose(2, 3),) * 3)
    launches = FLASH_FWD.launches
    with pytest.raises(ValueError, match="contiguous along head_dim"):
        loaded(x)
    assert FLASH_FWD.launches == launches


def _layer(cls, name, **config):
    return {"module": "keras.layers", "class_name": cls, "config": {"name": name, **config}}


def test_keras_file_function_on_the_card(cuda, tmp_path):
    """A small Sequential ``.keras`` file, written by the port's writer (no
    Keras on the card's machine), read by ``from_keras`` and run on the
    card against the CPU, in float32 and under ``mixed_bfloat16``; no
    attention kernel runs."""
    from sparkdl_tpu_torch.graph import TorchFunction
    from sparkdl_tpu_torch.models.keras_model import write_keras_file

    config = {"module": "keras", "class_name": "Sequential", "config": {
        "name": "card_cnn", "layers": [
            _layer("InputLayer", "input_layer", batch_shape=[None, 32, 30, 3]),
            _layer("Conv2D", "conv2d", filters=8, kernel_size=[3, 3], strides=[2, 2],
                   padding="same", activation="relu", use_bias=True),
            _layer("BatchNormalization", "batch_normalization", axis=-1, epsilon=1e-3,
                   center=True, scale=False),
            _layer("DepthwiseConv2D", "depthwise_conv2d", kernel_size=[3, 3],
                   padding="same", depth_multiplier=2, activation="relu6", use_bias=False),
            _layer("AveragePooling2D", "average_pooling2d", pool_size=[3, 3],
                   strides=[2, 2], padding="same"),
            _layer("GlobalAveragePooling2D", "global_average_pooling2d"),
            _layer("Dense", "dense", units=5, activation="softmax", use_bias=True),
        ]}}
    rng = np.random.default_rng(0)
    weights = {
        "conv2d": [rng.standard_normal((3, 3, 3, 8)) * 0.3, rng.standard_normal(8) * 0.1],
        "batch_normalization": [rng.standard_normal(8) * 0.1, rng.standard_normal(8) * 0.1,
                                rng.uniform(0.5, 1.5, 8)],
        "depthwise_conv2d": [rng.standard_normal((3, 3, 8, 2)) * 0.3],
        "dense": [rng.standard_normal((16, 5)) * 0.3, rng.standard_normal(5) * 0.1],
    }
    path = str(tmp_path / "card_cnn.keras")
    write_keras_file(path, config, {k: [w.astype(np.float32) for w in v]
                                    for k, v in weights.items()})
    x = rng.uniform(-1, 1, (6, 32, 30, 3)).astype(np.float32)
    launches = FLASH_FWD.launches
    for dtype, tol in (("float32", dict(atol=1e-5, rtol=1e-4)),
                       ("bfloat16", dict(atol=2e-2, rtol=2e-2))):
        fn = TorchFunction.from_keras(path, compute_dtype=dtype)
        got = fn(x)
        assert got.device.type == "cuda" and got.shape == (6, 5)
        torch.testing.assert_close(got.float().cpu(), fn(x, device="cpu").float(), **tol)
    assert FLASH_FWD.launches == launches


def test_keras_fine_tune_step_on_the_card(cuda, tmp_path):
    """One fine-tune step of a small nested Keras file (a Functional conv/BN
    base in a Sequential with a softmax head), written by the port's writer,
    on the card against the CPU with TF32 off: the loss, every weight and
    moving statistic after an sgd step within float32 rounding
    (``atol=1e-5, rtol=1e-4``); no attention kernel runs."""
    from sparkdl_tpu_torch.estimators.losses import get_optimizer, get_per_sample_loss_fn
    from sparkdl_tpu_torch.models.keras_model import KerasModel, read_keras_file, write_keras_file
    from sparkdl_tpu_torch.parallel.keras_train import (
        init_keras_train_state,
        make_keras_train_step,
    )

    base = {"module": "keras", "class_name": "Functional", "config": {
        "name": "base", "trainable": True, "layers": [
            {**_layer("InputLayer", "input_layer", batch_shape=[None, 16, 16, 3]),
             "inbound_nodes": []},
            *[{**_layer(cls, name, **cfg), "inbound_nodes": [{"args": [{
                "class_name": "__keras_tensor__", "config": {"keras_history": [src, 0, 0]}}],
                "kwargs": {}}]} for cls, name, src, cfg in (
                ("Conv2D", "c1", "input_layer", dict(filters=8, kernel_size=[3, 3],
                                                     strides=[2, 2], padding="same",
                                                     use_bias=True, activation="linear")),
                ("BatchNormalization", "bn1", "c1", dict(axis=-1, momentum=0.9)),
                ("Activation", "relu", "bn1", dict(activation="relu")),
                ("GlobalAveragePooling2D", "gap", "relu", {}))],
        ],
        "input_layers": [["input_layer", 0, 0]], "output_layers": [["gap", 0, 0]]}}
    config = {"module": "keras", "class_name": "Sequential", "config": {
        "name": "card_fine_tune", "layers": [
            _layer("InputLayer", "input_layer_1", batch_shape=[None, 16, 16, 3]), base,
            _layer("Dense", "head", units=5, activation="softmax", use_bias=True)]}}
    rng = np.random.default_rng(0)
    weights = {"base": {"c1": [rng.standard_normal((3, 3, 3, 8)) * 0.3, np.zeros(8)],
                        "bn1": [np.ones(8), np.zeros(8), rng.standard_normal(8) * 0.1,
                                rng.uniform(0.5, 1.5, 8)]},
               "head": [rng.standard_normal((8, 5)) * 0.3, np.zeros(5)]}
    weights = {k: ({n: [a.astype(np.float32) for a in v] for n, v in w.items()}
                   if isinstance(w, dict) else [a.astype(np.float32) for a in w])
               for k, w in weights.items()}
    path = str(tmp_path / "fine_tune.keras")
    write_keras_file(path, config, weights)
    batch = {"x": rng.uniform(-1, 1, (8, 16, 16, 3)).astype(np.float32),
             "y": rng.integers(0, 5, 8).astype(np.int32),
             "w": (np.arange(8) < 6).astype(np.float32)}
    launches = [k.launches for k in (FLASH_FWD, FLASH_FWD_LSE, FLASH_BWD_DQ, FLASH_BWD_DKV)]
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        results = {}
        for device in ("cpu", "cuda"):
            module = KerasModel(*read_keras_file(path)).to(device)
            state = init_keras_train_state(module, get_optimizer("sgd", 0.1))
            step = make_keras_train_step(
                get_per_sample_loss_fn("sparse_categorical_crossentropy"), weighted=True)
            state, loss = step(state, {k: torch.from_numpy(v).to(device)
                                       for k, v in batch.items()})
            results[device] = float(loss), module.keras_weights()
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    assert results["cuda"][0] == pytest.approx(results["cpu"][0], rel=1e-5)
    got, want = results["cuda"][1], results["cpu"][1]
    for name in ("c1", "bn1"):
        for g, w in zip(got["base"][name], want["base"][name]):
            np.testing.assert_allclose(g, w, atol=1e-5, rtol=1e-4)
    for g, w in zip(got["head"], want["head"]):
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=1e-4)
    assert not np.array_equal(got["base"]["bn1"][3], weights["base"]["bn1"][3])
    assert [k.launches for k in (FLASH_FWD, FLASH_FWD_LSE, FLASH_BWD_DQ, FLASH_BWD_DKV)] \
        == launches


def test_checkpointed_vit_fit_resumes_on_the_card_bit_for_bit(cuda, tmp_path):
    """A small ViT (ViT-Ti/16 cut to 2 blocks, head_dim 64, flash attention)
    fitted on the card for 2 epochs of 2 steps: fit(1) with a checkpoint,
    then a fresh fit(2) on the directory, equals the uninterrupted fit(2) bit
    for bit, and its epoch launched the backward kernels once a block a
    step (the flash kernels take no atomics, so a step repeats exactly)."""
    from sparkdl_tpu_torch import TorchImageFileEstimator, ViT
    from sparkdl_tpu_torch.sql.session import TorchSession

    rng = np.random.RandomState(0)
    rows = []
    for i in range(8):
        path = str(tmp_path / f"img_{i}.npy")
        np.save(path, rng.rand(32, 32, 3).astype(np.float32))
        rows.append({"uri": path, "label": i % 4})
    df = TorchSession.builder.getOrCreate().createDataFrame(rows, numPartitions=2)
    module = ViT("ViT-Ti/16", num_classes=4, image_size=32, attn_impl="flash")
    module.blocks = torch.nn.ModuleList(list(module.blocks)[:2])

    def fit(epochs, ckpt=None):
        return TorchImageFileEstimator(
            inputCol="uri", outputCol="out", labelCol="label", imageLoader=np.load,
            module=module, checkpointDir=ckpt, device="cuda",
            fitParams={"epochs": epochs, "batch_size": 4, "learning_rate": 1e-3, "seed": 0},
        ).fit(df)

    straight = fit(2)
    ckpt = str(tmp_path / "ckpt")
    fit(1, ckpt)
    before = [k.launches for k in (FLASH_FWD_LSE, FLASH_BWD_DQ, FLASH_BWD_DKV)]
    resumed = fit(2, ckpt)
    after = [k.launches for k in (FLASH_FWD_LSE, FLASH_BWD_DQ, FLASH_BWD_DKV)]
    assert [a - b for a, b in zip(after, before)] == [2 * 2] * 3  # 2 blocks x 2 steps
    assert resumed._training_losses == straight._training_losses[2:]
    want = straight.module.state_dict()
    for name, tensor in resumed.module.state_dict().items():
        assert tensor.device.type == "cuda"
        assert torch.equal(tensor, want[name]), name


def test_pinned_buffers_are_reused_only_after_their_copy(cuda, monkeypatch):
    """The transform loop's pinned input buffers on the card: a buffer is
    refilled only after the event of the ``non_blocking`` copy that last
    read it. (a) One slot, the stream held busy by a spin kernel so that
    the first copy is still queued when the second batch arrives: both
    batches reach the card whole. (b) ``run_batched_rows`` with a slow
    decode over 6 chunks, so that each slot is refilled (warm) after its
    first use (cold), at depths 0-3 and serial, twice each: the same bytes
    every time, equal to the CPU loop's."""
    import time

    from sparkdl_tpu_torch.engine.executor import PinnedStaging
    from sparkdl_tpu_torch.transformers.utils import run_batched_rows

    staging = PinnedStaging(cuda, slots=1)
    a = np.full((64, 1024), 1.0, np.float32)
    b = np.full((64, 1024), 2.0, np.float32)
    torch.cuda._sleep(200_000_000)  # ~0.1 s of spinning ahead of the copies
    xa, = staging.place([a])
    xb, = staging.place([b])
    assert torch.equal(xa.cpu(), torch.from_numpy(a))
    assert torch.equal(xb.cpu(), torch.from_numpy(b))

    def decode(chunk):
        time.sleep(0.01)
        return np.stack([np.full((16, 16, 3), r, np.float32) for r in chunk])

    def fn(x):
        torch.cuda._sleep(2_000_000)
        return (x * 3.0 - 1.0).sum(dim=(1, 2))

    rows = list(range(45))
    want = run_batched_rows(lambda x: (x * 3.0 - 1.0).sum(dim=(1, 2)), rows, decode, 8,
                            device="cpu")
    for env, value in [("SPARKDL_DISPATCH_DEPTH", d) for d in "0123"] + [
            ("SPARKDL_SERIAL_INFERENCE", "1")]:
        with monkeypatch.context() as m:
            m.setenv(env, value)
            cold = run_batched_rows(fn, rows, decode, 8, device=cuda)
            warm = run_batched_rows(fn, rows, decode, 8, device=cuda)
        assert np.array_equal(cold, warm), (env, value)
        assert np.array_equal(cold, want), (env, value)


def test_engine_program_launches_the_kernel_and_loads_from_disk(cuda, tmp_path):
    """A ViT-Ti flash function compiled by the engine (AOTInductor) on the
    card: the program calls the forward op (12 launches a call) and gives
    the eager function's rows; a second engine on the same cache directory
    loads the package instead of compiling, and its rows are the first's
    bit for bit."""
    from sparkdl_tpu_torch.engine import ExecutionEngine, PersistentCompileCache
    from sparkdl_tpu_torch.models.vit import ViT

    torch.manual_seed(0)
    module = ViT(variant="ViT-Ti/16", num_classes=4, image_size=32,
                 attn_impl="flash").to(cuda).eval()
    x = torch.from_numpy(np.random.RandomState(0).rand(3, 32, 32, 3).astype(np.float32))
    x = x.to(cuda)
    cache = PersistentCompileCache(str(tmp_path / "programs"))
    cold = ExecutionEngine(cache=cache).program(module, (x,), fingerprint="vit-ti:seed0")
    launches = FLASH_FWD.launches
    got = cold(x)
    torch.cuda.synchronize()
    assert cold.source == "compile" and FLASH_FWD.launches == launches + 12
    with torch.inference_mode():
        torch.testing.assert_close(got, module(x), atol=5e-4, rtol=5e-3)
    warm = ExecutionEngine(cache=cache).program(module, (x,), fingerprint="vit-ti:seed0")
    assert warm.source == "disk" and warm.key == cold.key
    assert torch.equal(warm(x), got)
