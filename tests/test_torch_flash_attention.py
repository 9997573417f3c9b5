"""The port's flash-attention forward against the JAX package's.

On the CPU the port's ``flash_attention`` runs its plain PyTorch version;
the JAX side runs the Pallas kernel in interpret mode, as tests/test_ops.py
runs it. Inputs come from numpy with a seed and reach both as the same
arrays. tests/test_torch_cuda_kernels.py holds the CUDA kernel itself to its
plain version on the card.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sparkdl_tpu.ops import flash_attention as jax_flash_attention
from sparkdl_tpu.parallel.context import full_attention as jax_full_attention
from sparkdl_tpu_torch.ops.flash_attention import (
    FLASH_FWD,
    NEG_INF,
    flash_attention,
    flash_attention_reference,
)
from sparkdl_tpu_torch.parallel.context import full_attention

F32_TOL = dict(atol=2e-4, rtol=2e-4)  # tests/test_ops.py's flash tolerance

# (shape, kwargs, mul): the cases of tests/test_ops.py:21-46, and a peaked
# softmax (inputs x4, the ViT-B/16 head shape at batch 1), the regime of the
# card's split-TF32 checks
CASES = [
    ((2, 197, 3, 64), {}, 1.0),             # ViT-Ti: CLS-token seq
    ((1, 128, 2, 32), {}, 1.0),             # exact block multiple
    ((2, 300, 4, 128), {}, 1.0),            # ragged seq, head_dim 128
    ((1, 197, 2, 64), {"causal": True}, 1.0),
    ((1, 256, 2, 64), {"kv_len": 200}, 1.0),
    ((1, 197, 12, 64), {}, 4.0),            # peaked softmax
]
IDS = ["vit_ti", "block_multiple", "ragged_d128", "causal", "kv_len", "peaked"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _no_compile_cache(monkeypatch):
    monkeypatch.setenv("SPARKDL_COMPILE_CACHE", "off")


def _qkv(shape, seed=0, mul=1.0):
    rng = np.random.RandomState(seed)
    return [rng.randn(*shape).astype(np.float32) * np.float32(mul) for _ in range(3)]


def _jax_lse(q, k, causal=False, kv_len=None):
    """The lse that the JAX kernel's fwd_call saves: logsumexp over the
    masked (-1e30), scaled scores, as (b, h, s)."""
    s, d = q.shape[1], q.shape[3]
    kv_len = s if kv_len is None else min(kv_len, s)
    scores = jnp.einsum("bqhd,bkhd->bhqk", jnp.asarray(q) * d ** -0.5,
                        jnp.asarray(k))
    pos = jnp.arange(s)
    keep = (pos < kv_len)[None, :] & jnp.ones((s, s), bool)
    if causal:
        keep &= pos[:, None] >= pos[None, :]
    return np.asarray(jax.nn.logsumexp(jnp.where(keep, scores, NEG_INF), -1))


@pytest.mark.parametrize("shape,kwargs,mul", CASES, ids=IDS)
def test_flash_matches_jax_kernel(shape, kwargs, mul):
    q, k, v = _qkv(shape, mul=mul)
    want = np.asarray(jax_flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kwargs
    ))
    got = flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), **kwargs
    )
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)


@pytest.mark.parametrize("shape,kwargs,mul", CASES, ids=IDS)
def test_flash_lse_matches_jax(shape, kwargs, mul):
    q, k, v = _qkv(shape, seed=1, mul=mul)
    _, lse = flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        return_lse=True, **kwargs,
    )
    assert lse.shape == (shape[0], shape[2], shape[1])
    assert lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), _jax_lse(q, k, **kwargs), **F32_TOL)


@pytest.mark.parametrize("shape,kwargs,mul", CASES, ids=IDS)
def test_full_attention_matches_jax(shape, kwargs, mul):
    q, k, v = _qkv(shape, seed=2, mul=mul)
    want = np.asarray(jax_full_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kwargs
    ))
    got = full_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), **kwargs
    )
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)


def _tf32(x):
    """float32 rounded to TF32 (10 mantissa bits), to nearest with ties away
    from zero, as the kernels' split rounds."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _mm_split_tf32(a, b):
    """``a @ b`` as the kernels compute it on the tensor cores: each operand
    split as ``hi = tf32(x)``, ``lo = tf32(x - hi)``, the product summed as
    ``lo hi' + hi lo' + hi hi'``. Products of two TF32 values are exact in
    float32, so the CPU's float32 matmul emulates the TF32 units."""
    a_hi, b_hi = _tf32(a), _tf32(b)
    a_lo, b_lo = _tf32(a - a_hi), _tf32(b - b_hi)
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


def _mm_single_tf32(a, b):
    return _tf32(a) @ _tf32(b)


def _emulated_forward(q, k, v, mm, causal=False, kv_len=None):
    """The f32 forward kernel's arithmetic with every matrix product done by
    ``mm``, in (b, h, s, d) layout: scores in log2 units from Q times
    ``scale log2(e)``, masked to -1e30, ``P = exp2(S - m)``, ``O = (P V) / l``,
    ``lse = m ln 2 + log l``. Returns (out (b, s, h, d), lse (b, h, s))."""
    s, d = q.shape[1], q.shape[3]
    kv_len = s if kv_len is None else kv_len
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    scale_log2 = torch.tensor(d ** -0.5, dtype=torch.float32) * torch.tensor(
        1.4426950408889634, dtype=torch.float32)
    scores = mm(qt * scale_log2, kt.transpose(-1, -2))
    pos = torch.arange(s)
    keep = (pos < kv_len)[None, :] & ((pos[:, None] >= pos[None, :]) | (not causal))
    scores = scores.masked_fill(~keep, NEG_INF)
    m = scores.amax(-1, keepdim=True)
    p = torch.exp2(scores - m)
    l = p.sum(-1, keepdim=True)
    out = mm(p, vt) / l
    lse = (m * np.float32(np.log(2.0)) + torch.log(l))[..., 0]
    return out.transpose(1, 2), lse


@pytest.mark.parametrize("shape,kwargs,mul", CASES, ids=IDS)
def test_split_tf32_forward_matches_jax_kernel(shape, kwargs, mul):
    """The precision design of the CUDA forward, each f32 product as three
    TF32 products and the softmax in log2 units, keeps its output and lse
    within the flash tolerance of the Pallas kernel."""
    q, k, v = _qkv(shape, mul=mul)
    out, lse = _emulated_forward(
        *(torch.from_numpy(a) for a in (q, k, v)), _mm_split_tf32, **kwargs)
    want = np.asarray(jax_flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kwargs
    ))
    np.testing.assert_allclose(out.numpy(), want, **F32_TOL)
    np.testing.assert_allclose(lse.numpy(), _jax_lse(q, k, **kwargs), **F32_TOL)


@pytest.mark.parametrize("shape,kwargs,mul", CASES, ids=IDS)
def test_single_tf32_forward_is_10x_further_from_jax_kernel(shape, kwargs, mul):
    """One TF32 product per f32 product lands at least 10x further from the
    Pallas kernel's output and lse than the split does."""
    q, k, v = _qkv(shape, mul=mul)
    qkv = [torch.from_numpy(a) for a in (q, k, v)]
    split = _emulated_forward(*qkv, _mm_split_tf32, **kwargs)
    single = _emulated_forward(*qkv, _mm_single_tf32, **kwargs)
    want = (np.asarray(jax_flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kwargs
    )), _jax_lse(q, k, **kwargs))
    for name, g, one, w in zip(("out", "lse"), split, single, want):
        err, single_err = np.abs(g.numpy() - w).max(), np.abs(one.numpy() - w).max()
        assert single_err >= 10 * err, f"{name}: split {err:.3e}, single {single_err:.3e}"


def test_cpu_tensors_run_the_plain_version():
    q, k, v = (torch.from_numpy(a) for a in _qkv((1, 70, 2, 32), seed=3))
    launches = FLASH_FWD.launches
    got = flash_attention(q, k, v, scale=0.3, kv_len=50)
    want = flash_attention_reference(q, k, v, scale=0.3, kv_len=50)
    assert torch.equal(got, want)
    assert FLASH_FWD.launches == launches


@pytest.mark.parametrize("fn", [flash_attention, flash_attention_reference])
def test_kv_len_below_one_raises(fn):
    q, k, v = (torch.from_numpy(a) for a in _qkv((1, 8, 1, 32)))
    with pytest.raises(ValueError, match="kv_len must be at least 1"):
        fn(q, k, v, kv_len=0)
