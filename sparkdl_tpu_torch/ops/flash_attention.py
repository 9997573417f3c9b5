"""Flash attention, forward and backward: hand-written CUDA kernels for Hopper.

Port of ``sparkdl_tpu.ops.flash_attention``. The TPU module padded the
sequence to ``lcm(block_q, block_k)`` and the head dim to 128 lanes and ran
Pallas kernels on a ``(b, h, s_pad, d_pad)`` grid; here the CUDA kernels
(``csrc/flash_attention_fwd.cu``, ``csrc/flash_attention_bwd.cu``) read the
``(b, s, h, d)`` tensors in place and mask the ragged edge themselves, so
nothing is padded or transposed.

:func:`flash_attention` routes as the JAX ``custom_vjp`` does: a call that
needs gradients goes through :class:`FlashAttention` (the forward saves the
logsumexp, the backward runs the dQ and dK/dV kernels); any other call takes
the lse-free forward. CUDA tensors launch the kernels; CPU tensors run
:func:`flash_attention_reference` and :func:`flash_attention_bwd_reference`,
the same functions in plain PyTorch: only a caller that asked for the CPU
holds those. A build or launch failure raises; nothing falls back.

The forward, with and without the lse, is a ``torch.library`` op
(``sparkdl_tpu_torch::flash_attention_fwd`` and
``sparkdl_tpu_torch::flash_attention_fwd_lse``) whose CUDA implementation
launches the kernel and whose CPU implementation is the plain version, with
a fake implementation for tracing. So ``torch.export`` keeps the op as one
node of the graph wherever it traces: a program exported on either device
and loaded on the card launches the kernel, and no saved program holds the
plain attention in its place.
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

_FWD_ARGS = (
    [_P, _P, _P, _P, _P]       # q, k, v, o, lse
    + [_I64] * 9               # batch / seq / head strides of q, k, v
    + [_I] * 6                 # batch, seq, heads, head_dim, dtype, causal
    + [ctypes.c_float, _I, _P]  # scale, kv_len, stream
)
#: the lse-free forward (``fwd_only``, the inference primal); its
#: ``.launches`` counts those launches
FLASH_FWD = CudaKernel("flash_attention_fwd.cu", "flash_attention_fwd", _FWD_ARGS)
#: the same launcher asked for the lse (``fwd_call``, the training
#: forward), counted on its own
FLASH_FWD_LSE = CudaKernel("flash_attention_fwd.cu", "flash_attention_fwd", _FWD_ARGS)

_BWD_INPUTS = [_P] * 6        # q, k, v, dout, lse, delta
_BWD_SIZES = [
    ctypes.POINTER(_I64),          # batch / seq / head strides of q, k, v, dout
    _I, _I, _I, _I, _I, _I,        # batch, seq, heads, head_dim, dtype, causal
    ctypes.c_float, _I, _P,        # scale, kv_len, stream
]
#: the dQ half of the backward (``_dq_kernel``)
FLASH_BWD_DQ = CudaKernel(
    "flash_attention_bwd.cu", "flash_attention_bwd_dq",
    _BWD_INPUTS + [_P] + _BWD_SIZES,           # dq
)
#: the dK/dV half of the backward (``_dkv_kernel``)
FLASH_BWD_DKV = CudaKernel(
    "flash_attention_bwd.cu", "flash_attention_bwd_dkv",
    _BWD_INPUTS + [_P, _P] + _BWD_SIZES,       # dk, dv
)

Out = Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]
Grads = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


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
    logits = logits.masked_fill(~_keep_mask(s, kv_len, causal, q.device), NEG_INF)
    lse = torch.logsumexp(logits, dim=-1)
    probs = torch.exp(logits - lse[..., None])
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v.float()).to(q.dtype)
    return (out, lse) if return_lse else out


def _keep_mask(s: int, kv_len: int, causal: bool, device) -> torch.Tensor:
    pos = torch.arange(s, device=device)
    keep = (pos < kv_len)[None, :].expand(s, s)
    if causal:
        keep = keep & (pos[:, None] >= pos[None, :])
    return keep


def attention_delta(out: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """``delta = rowsum(dO * O)`` in float32, ``(b, h, s)`` contiguous, from
    ``out`` in its own type (the JAX ``bwd`` computes it outside Pallas too)."""
    return (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()


def flash_attention_bwd_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    out: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    causal: bool = False,
    scale: Optional[float] = None,
    kv_len: Optional[int] = None,
) -> Grads:
    """The backward kernels' function in plain fp32 PyTorch: the explicit
    formulas of ``_dq_kernel`` / ``_dkv_kernel``, not autograd of the
    forward. With ``S = (scale q) k^T``: ``P = exp(S - lse)`` where kept,
    else 0; ``dS = P (dO V^T - delta)``; ``dQ = scale dS K``,
    ``dK = dS^T (scale Q)``, ``dV = P^T dO``, each cast to its input's type."""
    scale, kv_len = _resolve(q, k, v, scale, kv_len)
    qs = q.float() * scale
    kf, vf, dof = k.float(), v.float(), do.float()
    scores = torch.einsum("bqhd,bkhd->bhqk", qs, kf)
    keep = _keep_mask(q.shape[1], kv_len, causal, q.device)
    p = torch.where(keep, torch.exp(scores - lse[..., None]), 0.0)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    ds = p * (dp - attention_delta(out, do)[..., None])
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qs)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check_cuda(q, k, v) -> None:
    """What the kernels take: CUDA tensors of one float32 / bfloat16 type on
    one device, contiguous along head_dim, with a head_dim in HEAD_DIMS and
    a batch and heads of at most 65535. Checked where the forward op
    launches, on real tensors only (never while ``torch.export`` traces, so
    the symbolic batch stays unbounded), which covers eager calls and
    loaded programs alike; the backward takes the tensors its forward
    checked."""
    b, _, h, d = q.shape
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


def _fwd_plain(q, k, v, causal, scale, kv_len) -> torch.Tensor:
    return flash_attention_reference(
        q, k, v, causal=causal, scale=scale, kv_len=kv_len
    ).contiguous()


def _fwd_lse_plain(q, k, v, causal, scale, kv_len):
    out, lse = flash_attention_reference(
        q, k, v, causal=causal, scale=scale, kv_len=kv_len, return_lse=True
    )
    return out.contiguous(), lse.contiguous()


def _fwd_cuda(q, k, v, causal, scale, kv_len):
    return _forward_cuda(q, k, v, causal, scale, kv_len, return_lse=False)


def _fwd_lse_cuda(q, k, v, causal, scale, kv_len):
    return _forward_cuda(q, k, v, causal, scale, kv_len, return_lse=True)


def _fwd_fake(q, k, v, causal, scale, kv_len):
    return q.new_empty(q.shape)


def _fwd_lse_fake(q, k, v, causal, scale, kv_len):
    b, s, h, _ = q.shape
    return q.new_empty(q.shape), q.new_empty((b, h, s), dtype=torch.float32)


# The forward as two ops of the dispatcher (a ``torch.library.Library``
# rather than ``custom_op``, whose Python wrapper cost ~20 us a call: the
# bf16 ViT forward is launch-bound). CPU tensors run the plain version, CUDA
# tensors one launch of FLASH_FWD or FLASH_FWD_LSE, fake tensors the shapes.
_LIB = torch.library.Library("sparkdl_tpu_torch", "DEF")
_FWD_ARGS_SCHEMA = "(Tensor q, Tensor k, Tensor v, bool causal, float scale, int kv_len)"
for _name, _out, _plain, _cuda, _fake in (
    ("flash_attention_fwd", "Tensor", _fwd_plain, _fwd_cuda, _fwd_fake),
    ("flash_attention_fwd_lse", "(Tensor, Tensor)", _fwd_lse_plain, _fwd_lse_cuda,
     _fwd_lse_fake),
):
    _LIB.define(f"{_name}{_FWD_ARGS_SCHEMA} -> {_out}")
    _LIB.impl(_name, _plain, "CPU")
    _LIB.impl(_name, _cuda, "CUDA")
    torch.library.register_fake(f"sparkdl_tpu_torch::{_name}", _fake, lib=_LIB)

#: the lse-free forward op (``fwd_only``)
flash_attention_fwd_op = torch.ops.sparkdl_tpu_torch.flash_attention_fwd.default
#: the forward op with the lse (``fwd_call``)
flash_attention_fwd_lse_op = torch.ops.sparkdl_tpu_torch.flash_attention_fwd_lse.default


def _forward(q, k, v, causal, scale, kv_len, return_lse) -> Out:
    """The forward op, with the lse or without: one launch of the kernel
    for CUDA tensors, the plain version for CPU tensors. ``scale`` and
    ``kv_len`` are resolved."""
    op = flash_attention_fwd_lse_op if return_lse else flash_attention_fwd_op
    return op(q, k, v, bool(causal), float(scale), int(kv_len))


def _forward_cuda(q, k, v, causal, scale, kv_len, return_lse) -> Out:
    """One launch of the forward kernel (``FLASH_FWD``, or ``FLASH_FWD_LSE``
    with the lse) into new contiguous outputs. An input whose rows are not
    16-byte aligned is copied to a contiguous tensor first."""
    _check_cuda(q, k, v)
    b, s, h, d = q.shape
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    lse = (
        torch.empty((b, h, s), dtype=torch.float32, device=q.device)
        if return_lse else None
    )
    if out.numel() == 0:
        return (out, lse) if return_lse else out
    q, k, v = (_rows_aligned(x) for x in (q, k, v))
    kernel = FLASH_FWD_LSE if return_lse else FLASH_FWD
    _launch_fwd(kernel, q, k, v, out, lse, causal, scale, kv_len)
    return (out, lse) if return_lse else out


def _launch_fwd(kernel, q, k, v, out, lse, causal, scale, kv_len) -> None:
    """One launch of ``kernel`` (``FLASH_FWD``, ``FLASH_FWD_LSE`` or a tile
    sweep's variant) into ``out`` and, unless it is None, ``lse``: CUDA
    tensors as :func:`_forward_cuda` prepares them (rows 16-byte aligned)."""
    b, s, h, d = q.shape
    with torch.cuda.device(q.device):
        kernel(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr() if lse is not None else None,
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            b, s, h, d, _DTYPE_CODES[q.dtype], int(bool(causal)),
            scale, kv_len, torch.cuda.current_stream(q.device).cuda_stream,
        )


def _rows_aligned(x: torch.Tensor) -> torch.Tensor:
    """``x``, or a contiguous copy of it where its rows are not 16-byte
    aligned: the kernels stage rows with 16-byte ``cp.async`` copies. ViT's
    fused-qkv views and contiguous tensors pass as they are."""
    item = x.element_size()
    if x.data_ptr() % 16 == 0 and all(
        x.stride(i) * item % 16 == 0 for i in range(3) if x.shape[i] > 1
    ):
        return x
    return x.clone(memory_format=torch.contiguous_format)


def _launch_bwd(kernel, q, k, v, do, lse, delta, grads, causal, scale, kv_len):
    b, s, h, d = q.shape
    strides = (_I64 * 12)(*(x.stride(i) for x in (q, k, v, do) for i in range(3)))
    with torch.cuda.device(q.device):
        kernel(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), *(g.data_ptr() for g in grads),
            strides, b, s, h, d, _DTYPE_CODES[q.dtype], int(causal), scale,
            kv_len, torch.cuda.current_stream(q.device).cuda_stream,
        )


def flash_attention_bwd_dq(q, k, v, do, lse, delta, causal, scale, kv_len):
    """One launch of the dQ kernel (``FLASH_BWD_DQ``): ``dQ`` from CUDA
    tensors as :func:`_backward` prepares them (``do`` of q's type and
    contiguous along head_dim, rows 16-byte aligned, ``delta`` from
    :func:`attention_delta`)."""
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch_bwd(FLASH_BWD_DQ, q, k, v, do, lse, delta, (dq,), causal, scale, kv_len)
    return dq


def flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal, scale, kv_len):
    """One launch of the dK/dV kernel (``FLASH_BWD_DKV``): ``(dK, dV)``,
    from the inputs :func:`flash_attention_bwd_dq` takes."""
    dk = torch.empty(k.shape, dtype=q.dtype, device=q.device)
    dv = torch.empty(v.shape, dtype=q.dtype, device=q.device)
    _launch_bwd(FLASH_BWD_DKV, q, k, v, do, lse, delta, (dk, dv), causal, scale, kv_len)
    return dk, dv


def _backward(q, k, v, out, lse, do, causal, scale, kv_len) -> Grads:
    """The dQ and dK/dV kernels, or their plain version for CPU tensors.
    ``dO`` is read through its strides; one that is not contiguous along
    head_dim is copied to a contiguous tensor first, as is any input whose
    rows are not 16-byte aligned."""
    if q.device.type == "cpu":
        return flash_attention_bwd_reference(
            q, k, v, out, lse, do, causal=causal, scale=scale, kv_len=kv_len
        )
    do = do.to(q.dtype)
    if do.stride(3) != 1:
        do = do.contiguous()
    if q.numel() == 0:
        return tuple(torch.empty(q.shape, dtype=q.dtype, device=q.device)
                     for _ in range(3))
    delta = attention_delta(out, do)
    q, k, v, do = (_rows_aligned(x) for x in (q, k, v, do))
    args = (q, k, v, do, lse, delta, causal, scale, kv_len)
    dq = flash_attention_bwd_dq(*args)
    dk, dv = flash_attention_bwd_dkv(*args)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Differentiable flash attention, the counterpart of the JAX
    ``custom_vjp``: the forward saves ``(q, k, v, out, lse)`` and the
    backward recomputes P from the lse. ``lse`` is returned but carries no
    gradient. Arguments after ``v`` are resolved (see :func:`_resolve`)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, kv_len):
        out, lse = _forward(q, k, v, causal, scale, kv_len, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, scale, kv_len)
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do, _dlse):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _backward(q, k, v, out, lse, do, *ctx.args)
        return dq, dk, dv, None, None, None


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

    Differentiable: when grad mode is on and any of q, k, v requires a
    gradient, the call goes through :class:`FlashAttention` (forward with
    lse, then the dQ and dK/dV kernels); otherwise it is one lse-free
    forward launch (with lse only when ``return_lse`` asks for it).
    """
    scale, kv_len = _resolve(q, k, v, scale, kv_len)
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")
    causal = bool(causal)
    if torch.is_grad_enabled() and (
        q.requires_grad or k.requires_grad or v.requires_grad
    ):
        out, lse = FlashAttention.apply(q, k, v, causal, scale, kv_len)
        return (out, lse) if return_lse else out
    return _forward(q, k, v, causal, scale, kv_len, return_lse)
