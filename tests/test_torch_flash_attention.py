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

# (shape, kwargs): the cases of tests/test_ops.py:21-46
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


def _qkv(shape, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(*shape).astype(np.float32) for _ in range(3)]


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


@pytest.mark.parametrize("shape,kwargs", CASES, ids=IDS)
def test_flash_matches_jax_kernel(shape, kwargs):
    q, k, v = _qkv(shape)
    want = np.asarray(jax_flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kwargs
    ))
    got = flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), **kwargs
    )
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)


@pytest.mark.parametrize("shape,kwargs", CASES, ids=IDS)
def test_flash_lse_matches_jax(shape, kwargs):
    q, k, v = _qkv(shape, seed=1)
    _, lse = flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        return_lse=True, **kwargs,
    )
    assert lse.shape == (shape[0], shape[2], shape[1])
    assert lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), _jax_lse(q, k, **kwargs), **F32_TOL)


@pytest.mark.parametrize("shape,kwargs", CASES, ids=IDS)
def test_full_attention_matches_jax(shape, kwargs):
    q, k, v = _qkv(shape, seed=2)
    want = np.asarray(jax_full_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kwargs
    ))
    got = full_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), **kwargs
    )
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)


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
