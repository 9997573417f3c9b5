"""The port's flash-attention backward against the JAX package's custom VJP.

``flash_attention_bwd_reference`` (the plain version of the dQ and dK/dV
kernels) and the CPU gradient of the port's ``flash_attention`` (its
``autograd.Function`` over the plain versions) are held to ``jax.vjp`` of
``sparkdl_tpu.ops.flash_attention``, whose Pallas kernels run in interpret
mode on the CPU as tests/test_ops.py runs them. Inputs and the cotangent
come from numpy with a seed. tests/test_torch_cuda_kernels.py holds the CUDA
kernels to the plain versions on the card.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sparkdl_tpu.ops import flash_attention as jax_flash_attention
from sparkdl_tpu_torch.ops.flash_attention import (
    FLASH_BWD_DKV,
    FLASH_BWD_DQ,
    FLASH_FWD,
    FLASH_FWD_LSE,
    FlashAttention,
    _rows_aligned,
    attention_delta,
    flash_attention,
    flash_attention_bwd_reference,
    flash_attention_reference,
)

GRAD_TOL = dict(atol=1e-3, rtol=1e-3)  # tests/test_ops.py:104-107

# (shape, kwargs): the cases of tests/test_torch_flash_attention.py
CASES = [
    ((2, 197, 3, 64), {}),             # ViT-Ti: CLS-token seq
    ((1, 128, 2, 32), {}),             # exact block multiple
    ((2, 300, 4, 128), {}),            # ragged seq, head_dim 128
    ((1, 197, 2, 64), {"causal": True}),
    ((1, 256, 2, 64), {"kv_len": 200}),
]
IDS = ["vit_ti", "block_multiple", "ragged_d128", "causal", "kv_len"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _no_compile_cache(monkeypatch):
    monkeypatch.setenv("SPARKDL_COMPILE_CACHE", "off")


def _inputs(shape, seed):
    """q, k, v and one cotangent, float32 numpy."""
    rng = np.random.RandomState(seed)
    return [rng.randn(*shape).astype(np.float32) for _ in range(4)]


def _jax_vjp(q, k, v, do, kwargs):
    _, vjp = jax.vjp(
        lambda q, k, v: jax_flash_attention(q, k, v, **kwargs),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
    )
    return [np.asarray(g) for g in vjp(jnp.asarray(do))]


@pytest.fixture(scope="module")
def jax_grads():
    """``jax.vjp`` of the JAX kernels per case, computed once per module."""
    cache = {}

    def get(case_id):
        if case_id not in cache:
            shape, kwargs = CASES[IDS.index(case_id)]
            cache[case_id] = _jax_vjp(*_inputs(shape, seed=11), kwargs)
        return cache[case_id]

    return get


@pytest.mark.parametrize("shape,kwargs", CASES, ids=IDS)
def test_bwd_reference_matches_jax_vjp(jax_grads, request, shape, kwargs):
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(shape, seed=11))
    out, lse = flash_attention_reference(q, k, v, return_lse=True, **kwargs)
    got = flash_attention_bwd_reference(q, k, v, out, lse, do, **kwargs)
    want = jax_grads(request.node.callspec.id)
    for name, g, w in zip("qkv", got, want):
        assert g.shape == shape, name
        np.testing.assert_allclose(g.numpy(), w, **GRAD_TOL, err_msg=f"d{name}")


@pytest.mark.parametrize("shape,kwargs", CASES, ids=IDS)
def test_cpu_gradient_matches_jax_vjp(jax_grads, request, shape, kwargs):
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(shape, seed=11))
    leaves = [t.requires_grad_() for t in (q, k, v)]
    out = flash_attention(*leaves, **kwargs)
    assert out.grad_fn is not None and "FlashAttention" in type(out.grad_fn).__name__
    got = torch.autograd.grad(out, leaves, do)
    want = jax_grads(request.node.callspec.id)
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(g.numpy(), w, **GRAD_TOL, err_msg=f"d{name}")


def _tf32(x):
    """float32 rounded to TF32 (10 mantissa bits), to nearest with ties away
    from zero, as ``cvt.rna.tf32.f32`` rounds: add half of the dropped range
    to the magnitude bits, then clear the 13 dropped bits."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _mm_split_tf32(a, b):
    """``a @ b`` as the backward kernels compute it on the tensor cores: each
    operand split as ``hi = tf32(x)``, ``lo = tf32(x - hi)``, the product
    summed as ``lo hi' + hi lo' + hi hi'``. Products of two TF32 values are
    exact in float32, so the CPU's float32 matmul emulates the TF32 units."""
    a_hi, b_hi = _tf32(a), _tf32(b)
    a_lo, b_lo = _tf32(a - a_hi), _tf32(b - b_hi)
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


def _mm_single_tf32(a, b):
    """``a @ b`` with one TF32 product: what TF32 without the split gives."""
    return _tf32(a) @ _tf32(b)


def _emulated_backward(q, k, v, out, lse, do, mm, causal=False, kv_len=None):
    """The backward kernels' formulas with every matrix product done by
    ``mm``, in (b, h, s, d) layout: ``S = scale (Q K^T)``, ``P = exp(S - lse)``
    where kept, ``dS = P (dO V^T - delta)``, ``dQ = scale (dS K)``,
    ``dK = scale (dS^T Q)``, ``dV = P^T dO``."""
    s, d = q.shape[1], q.shape[3]
    scale = d ** -0.5
    kv_len = s if kv_len is None else kv_len
    qt, kt, vt, dot = (x.transpose(1, 2) for x in (q, k, v, do))
    pos = torch.arange(s)
    keep = (pos < kv_len)[None, :] & ((pos[:, None] >= pos[None, :]) | (not causal))
    scores = mm(qt, kt.transpose(-1, -2)) * scale
    p = torch.where(keep, torch.exp(scores - lse[..., None]), 0.0)
    ds = p * (mm(dot, vt.transpose(-1, -2)) - attention_delta(out, do)[..., None])
    dq = mm(ds, kt) * scale
    dk = mm(ds.transpose(-1, -2), qt) * scale
    dv = mm(p.transpose(-1, -2), dot)
    return [g.transpose(1, 2).numpy() for g in (dq, dk, dv)]


def _emulated_grads(shape, kwargs, mm):
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(shape, seed=11))
    out, lse = flash_attention_reference(q, k, v, return_lse=True, **kwargs)
    return _emulated_backward(q, k, v, out, lse, do, mm, **kwargs)


def test_tf32_rounding_is_round_to_nearest_away():
    one = 1.0 + 2.0 ** -10  # the TF32 value after 1.0
    x = torch.tensor([1.0, 1.0 + 2.0 ** -12, 1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11),
                      1.0 + 3 * 2.0 ** -12])
    assert torch.equal(_tf32(x), torch.tensor([1.0, 1.0, one, -one, one]))


@pytest.mark.parametrize("shape,kwargs", CASES, ids=IDS)
def test_split_tf32_backward_matches_jax_vjp(jax_grads, request, shape, kwargs):
    """The precision design of the CUDA backward kernels, each f32 product
    as three TF32 products, keeps the gradients within the flash-gradient
    tolerance of ``jax.vjp`` of the Pallas kernels."""
    got = _emulated_grads(shape, kwargs, _mm_split_tf32)
    want = jax_grads(request.node.callspec.id)
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(g, w, **GRAD_TOL, err_msg=f"d{name}")


@pytest.mark.parametrize("shape,kwargs", CASES, ids=IDS)
def test_single_tf32_backward_is_10x_further_from_jax_vjp(jax_grads, request, shape, kwargs):
    """One TF32 product per f32 product (about 3 decimal digits) lands at
    least 10x further from ``jax.vjp`` than the split does: the split is
    what keeps the kernels near f32."""
    split = _emulated_grads(shape, kwargs, _mm_split_tf32)
    single = _emulated_grads(shape, kwargs, _mm_single_tf32)
    want = jax_grads(request.node.callspec.id)
    for name, g, one, w in zip("qkv", split, single, want):
        err, single_err = np.abs(g - w).max(), np.abs(one - w).max()
        assert single_err >= 10 * err, f"d{name}: split {err:.3e}, single {single_err:.3e}"


def test_bwd_reference_is_autograd_of_the_forward():
    """The explicit formulas agree with autograd through the plain forward
    (float64, so the comparison is tight)."""
    q, k, v, do = (torch.from_numpy(a).double() for a in _inputs((2, 70, 3, 32), 12))
    for kwargs in ({}, {"causal": True}, {"kv_len": 33, "scale": 0.3}):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        want = torch.autograd.grad(
            flash_attention_reference(*leaves, **kwargs), leaves, do
        )
        out, lse = flash_attention_reference(q, k, v, return_lse=True, **kwargs)
        got = flash_attention_bwd_reference(q, k, v, out, lse, do, **kwargs)
        for g, w in zip(got, want):
            # the reference computes in float32 and casts back
            torch.testing.assert_close(g, w, atol=1e-5, rtol=1e-5)


def test_delta_is_rowsum_of_do_times_out():
    out, do = (torch.from_numpy(a) for a in _inputs((2, 9, 3, 32), 13)[:2])
    delta = attention_delta(out, do)
    assert delta.shape == (2, 3, 9) and delta.is_contiguous()
    torch.testing.assert_close(delta, torch.einsum("bshd,bshd->bhs", out, do))


def test_cpu_gradient_launches_no_kernel():
    q, k, v, do = (torch.from_numpy(a) for a in _inputs((1, 70, 2, 32), 14))
    leaves = [t.requires_grad_() for t in (q, k, v)]
    kernels = (FLASH_FWD, FLASH_FWD_LSE, FLASH_BWD_DQ, FLASH_BWD_DKV)
    before = [k.launches for k in kernels]
    torch.autograd.grad(flash_attention(*leaves, kv_len=50), leaves, do)
    assert [k.launches for k in kernels] == before


def test_grad_free_calls_take_the_primal():
    """No graph under no_grad, nor when no input requires a gradient: the
    lse-free forward, as the JAX ``flash`` primal."""
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs((1, 20, 2, 32), 15))
    assert flash_attention(q, k, v).grad_fn is None
    leaf = q.clone().requires_grad_()
    with torch.no_grad():
        assert flash_attention(leaf, k, v).grad_fn is None
    assert flash_attention(leaf, k, v).grad_fn is not None


def test_lse_comes_back_without_gradient():
    q, k, v, do = (torch.from_numpy(a) for a in _inputs((1, 20, 2, 32), 16))
    leaf = q.clone().requires_grad_()
    out, lse = flash_attention(leaf, k, v, return_lse=True)
    assert out.requires_grad and not lse.requires_grad
    _, want_lse = flash_attention_reference(q, k, v, return_lse=True)
    torch.testing.assert_close(lse, want_lse)
    (dq,) = torch.autograd.grad(out, leaf, do)
    assert dq.shape == q.shape


def test_strided_views_give_the_contiguous_gradient():
    """q, k, v as views of one fused qkv (as ViT passes them) differentiate
    as their contiguous copies do, and the gradient reaches the fused
    tensor."""
    b, s, h, d = 2, 37, 3, 32
    rng = np.random.RandomState(17)
    qkv = torch.from_numpy(rng.randn(b, s, 3 * h * d).astype(np.float32))
    do = torch.from_numpy(rng.randn(b, s, h, d).astype(np.float32))
    fused = qkv.clone().requires_grad_()
    views = [t.reshape(b, s, h, d) for t in fused.chunk(3, dim=-1)]
    assert not views[0].is_contiguous()
    flash_attention(*views).backward(do)
    copies = [t.reshape(b, s, h, d).clone().requires_grad_() for t in qkv.chunk(3, dim=-1)]
    want = torch.autograd.grad(flash_attention(*copies), copies, do)
    torch.testing.assert_close(fused.grad, torch.cat(
        [g.reshape(b, s, h * d) for g in want], dim=-1
    ))


def test_bf16_gradients_keep_the_input_type():
    q, k, v, do = (torch.from_numpy(a).bfloat16() for a in _inputs((1, 40, 2, 64), 18))
    leaves = [t.requires_grad_() for t in (q, k, v)]
    grads = torch.autograd.grad(flash_attention(*leaves), leaves, do)
    f32 = [t.float().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(flash_attention(*f32), f32, do.float())
    for g, w in zip(grads, want):
        assert g.dtype == torch.bfloat16
        # one bf16 rounding of each gradient (2**-8 relative)
        torch.testing.assert_close(g.float(), w, atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_rows_not_16_byte_aligned_are_copied(dtype):
    """The backward kernels stage rows in 16-byte copies: ViT's fused-qkv
    views go to them as they are, and a view whose rows are not 16-byte
    aligned as a contiguous copy."""
    b, s, h, d = 2, 5, 3, 32
    fused = torch.randn(b, s, 3 * h * d).to(dtype)
    for view in (t.reshape(b, s, h, d) for t in fused.chunk(3, dim=-1)):
        assert _rows_aligned(view) is view
    wide = torch.randn(b, s, h * d + 1).to(dtype)
    for view in (wide[..., 1:].reshape(b, s, h, d), wide[..., :-1].reshape(b, s, h, d)):
        copy = _rows_aligned(view)
        assert copy is not view and copy.is_contiguous()
        assert copy.data_ptr() % 16 == 0 and torch.equal(copy, view)


def test_function_is_the_autograd_node():
    assert issubclass(FlashAttention, torch.autograd.Function)
