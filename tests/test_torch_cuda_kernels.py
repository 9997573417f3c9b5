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
    FLASH_FWD,
    flash_attention,
    flash_attention_reference,
)

pytestmark = pytest.mark.cuda

F32_TOL = dict(atol=2e-4, rtol=2e-4)  # tests/test_ops.py's flash tolerance
BF16_TOL = dict(atol=2e-2, rtol=2e-2)  # bf16 output rounding

# (shape, kwargs): the cases of tests/test_ops.py:21-46 and the ViT-B/16 shape
CASES = [
    ((2, 197, 3, 64), {}),
    ((1, 128, 2, 32), {}),
    ((2, 300, 4, 128), {}),
    ((1, 197, 2, 64), {"causal": True}),
    ((1, 256, 2, 64), {"kv_len": 200}),
    ((4, 197, 12, 64), {}),
]
IDS = ["vit_ti", "block_multiple", "ragged_d128", "causal", "kv_len", "vit_b"]


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
    launches = FLASH_FWD.launches
    out, lse = flash_attention(q, k, v, return_lse=True, **kwargs)
    want, want_lse = flash_attention_reference(q, k, v, return_lse=True, **kwargs)
    torch.cuda.synchronize()
    assert FLASH_FWD.launches == launches + 1
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
    w = torch.zeros((1, 8, 1, 64), device=cuda, requires_grad=True)
    with pytest.raises(NotImplementedError, match="backward"):
        flash_attention(w, w, w)
