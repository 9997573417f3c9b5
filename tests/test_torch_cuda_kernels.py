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
