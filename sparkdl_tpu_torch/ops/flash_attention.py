"""Flash attention forward: a hand-written CUDA kernel for Hopper.

Port of ``sparkdl_tpu.ops.flash_attention``'s forward. The TPU module padded
the sequence to ``lcm(block_q, block_k)`` and the head dim to 128 lanes and
ran a Pallas kernel on a ``(b, h, s_pad, d_pad)`` grid; here the CUDA kernel
(``csrc/flash_attention_fwd.cu``) reads the ``(b, s, h, d)`` tensors in place
and masks the ragged edge itself, so nothing is padded or transposed.

:func:`flash_attention` launches the kernel for CUDA tensors and runs
:func:`flash_attention_reference`, the same function in plain PyTorch, for
CPU tensors: only a caller that asked for the CPU holds those. A build or
launch failure raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple, Union

import torch

from sparkdl_tpu_torch.ops.cuda_build import CudaKernel

NEG_INF = -1e30

#: head dims the kernel is instantiated for (every ViT variant has 64)
HEAD_DIMS = (32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I = ctypes.c_int

#: the kernel; ``FLASH_FWD.launches`` counts its launches
FLASH_FWD = CudaKernel(
    "flash_attention_fwd.cu",
    "flash_attention_fwd",
    [_P, _P, _P, _P, _P]       # q, k, v, o, lse
    + [_I64] * 9               # batch / seq / head strides of q, k, v
    + [_I] * 6                 # batch, seq, heads, head_dim, dtype, causal
    + [ctypes.c_float, _I, _P],  # scale, kv_len, stream
)

Out = Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]


def _resolve(q, k, v, scale, kv_len) -> Tuple[float, int]:
    if q.dim() != 4:
        raise ValueError(f"expected (batch, seq, heads, head_dim), got {tuple(q.shape)}")
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            f"q, k and v must share one shape, got {tuple(q.shape)}, "
            f"{tuple(k.shape)}, {tuple(v.shape)}"
        )
    s, d = q.shape[1], q.shape[3]
    scale = 1.0 / (d ** 0.5) if scale is None else float(scale)
    kv_len = s if kv_len is None else min(int(kv_len), s)
    if kv_len < 1:
        raise ValueError(
            f"kv_len must be at least 1 (got {kv_len}): a query row that "
            "sees no key has no softmax"
        )
    return scale, kv_len


def flash_attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = False,
    scale: Optional[float] = None,
    kv_len: Optional[int] = None,
    return_lse: bool = False,
) -> Out:
    """The kernel's function in plain PyTorch, in fp32: scores masked to
    -1e30, softmax, ``P V`` cast back to the input type; ``lse`` is
    ``(b, h, s)`` float32."""
    scale, kv_len = _resolve(q, k, v, scale, kv_len)
    s = q.shape[1]
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float() * scale, k.float())
    pos = torch.arange(s, device=q.device)
    keep = (pos < kv_len)[None, :].expand(s, s)
    if causal:
        keep = keep & (pos[:, None] >= pos[None, :])
    logits = logits.masked_fill(~keep, NEG_INF)
    lse = torch.logsumexp(logits, dim=-1)
    probs = torch.exp(logits - lse[..., None])
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v.float()).to(q.dtype)
    return (out, lse) if return_lse else out


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = False,
    scale: Optional[float] = None,
    kv_len: Optional[int] = None,
    return_lse: bool = False,
) -> Out:
    """Fused attention ``(b, s, h, d) -> (b, s, h, d)`` (ViT layout).

    ``scale`` defaults to ``1/sqrt(d)``; ``kv_len`` (clamped to ``s``, at
    least 1) masks keys at or past it; ``causal`` masks keys after the
    query. With ``return_lse`` it also returns the per-row logsumexp
    ``(b, h, s)`` in float32, the value a backward pass reuses.
    """
    if q.device.type == "cpu":
        return flash_attention_reference(
            q, k, v, causal=causal, scale=scale, kv_len=kv_len,
            return_lse=return_lse,
        )
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")
    scale, kv_len = _resolve(q, k, v, scale, kv_len)
    b, s, h, d = q.shape
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        if x.dtype not in _DTYPE_CODES or x.dtype != q.dtype:
            raise TypeError(
                f"flash_attention takes float32 or bfloat16 q, k, v of one "
                f"type; {name} is {x.dtype}, q is {q.dtype}"
            )
        if x.stride(3) != 1:
            raise ValueError(f"{name} must be contiguous along head_dim")
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} not in {HEAD_DIMS}")
    if b > 65535 or h > 65535:
        raise ValueError(f"batch {b} and heads {h} must be at most 65535")
    if q.requires_grad or k.requires_grad or v.requires_grad:
        if torch.is_grad_enabled():
            raise NotImplementedError(
                "flash_attention has no backward kernel yet; call it under "
                "torch.no_grad() or torch.inference_mode()"
            )

    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    lse = (
        torch.empty((b, h, s), dtype=torch.float32, device=q.device)
        if return_lse else None
    )
    if out.numel() == 0:
        return (out, lse) if return_lse else out
    with torch.cuda.device(q.device):
        FLASH_FWD(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr() if lse is not None else None,
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            b, s, h, d, _DTYPE_CODES[q.dtype], int(bool(causal)),
            scale, kv_len, torch.cuda.current_stream(q.device).cuda_stream,
        )
    return (out, lse) if return_lse else out
