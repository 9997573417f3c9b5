"""Attention over a sequence split across ranks: ring and Ulysses.

Port of ``sparkdl_tpu.parallel.context``. ``full_attention`` is ViT's
default ``attn_impl="full"`` and the single-device oracle of the flash
kernel and of the two schemes here, each of which runs on every rank of a
process group with that rank's block of the sequence:

- :func:`ring_attention`: each rank holds its Q block while the K/V blocks
  rotate around the ring (P2P ``send``/``recv`` to the neighbours); the
  softmax is accumulated online (running max, denominator), so no rank
  holds the whole sequence's scores;
- :func:`ulysses_attention`: an all-to-all reshards Q/K/V from sequence
  blocks to head groups, each rank attends over the whole sequence for its
  heads (dense, or the port's flash kernels: ``impl="ulysses-flash"``), and
  a second all-to-all reshards back.

Both are differentiable. The rotation is :class:`_RingShift`, whose
backward sends the gradient the opposite way round the ring; the
all-to-all is :class:`_AllToAll`, whose backward is the same all-to-all
(exchanging chunk ``j`` of every rank with rank ``j`` is its own inverse).
Both are small ``torch.autograd.Function``s over ``torch.distributed``'s
public collectives rather than the functional collectives, whose autograd
forms are private or deprecated API, and they run the same on NCCL and
gloo. :func:`make_sp_attention` wraps a scheme as a function of each
rank's own ``(batch, seq, heads, head_dim)`` rows, so it serves as a
model's ``attn_impl`` in a data-parallel fit, where every rank holds other
rows: an all-to-all hands each rank its sequence block of every rank's
rows, the scheme runs over that global batch, and a second all-to-all
gives each rank its own rows whole (the JAX version's global arrays,
resharded by GSPMD). :func:`pad_tokens_for_sp` pads the token count to the
group's size first.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Optional

import torch
import torch.distributed as dist

from sparkdl_tpu_torch.parallel.trainer import axis_group


def full_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = False,
    scale: Optional[float] = None,
    kv_len: Optional[int] = None,
) -> torch.Tensor:
    """Plain softmax attention.

    Shapes: ``q/k/v: (batch, seq, heads, head_dim)`` -> same.
    ``kv_len`` masks out key positions >= kv_len (token-padding support);
    fully-masked query rows yield zeros.
    """
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q * scale, k)
    s_q, s_k = logits.shape[-2], logits.shape[-1]
    mask = torch.ones((s_q, s_k), dtype=torch.bool, device=q.device)
    if causal:
        mask = torch.tril(mask)
    if kv_len is not None:
        mask = mask & (torch.arange(s_k, device=q.device) < kv_len)[None, :]
    logits = logits.masked_fill(~mask, float("-inf"))
    # NaN-safe softmax: fully-masked query rows (padded tokens) yield zeros
    m = logits.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isneginf(m), torch.zeros_like(m), m)
    e = torch.where(mask, torch.exp(logits - m), torch.zeros_like(logits))
    denom = e.sum(dim=-1, keepdim=True)
    probs = e / torch.where(denom == 0.0, torch.ones_like(denom), denom)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


# ----------------------------------------------------------------------
# differentiable collectives
# ----------------------------------------------------------------------
def _peer(group, group_rank: int) -> int:
    """The global rank of ``group_rank`` in ``group``."""
    return group_rank if group is None else dist.get_global_rank(group, group_rank)


def _shift(x: torch.Tensor, group, step: int) -> torch.Tensor:
    """Send ``x`` ``step`` ranks down the ring and receive the block of the
    rank ``step`` up it."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    x = x.contiguous()
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x, _peer(group, (r - step) % n), group),
           dist.P2POp(dist.irecv, out, _peer(group, (r + step) % n), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


class _RingShift(torch.autograd.Function):
    """``lax.ppermute`` with ``perm = [(j, (j - 1) % n)]``: rank ``j``'s
    block goes to rank ``j - 1``. The gradient goes the other way round."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _shift(x, group, 1)

    @staticmethod
    def backward(ctx, grad):
        return _shift(grad, ctx.group, -1), None


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Chunk ``j`` of dim 0 goes to rank ``j``; the output's chunk ``i``
    came from rank ``i``."""
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_to_all(x, group)

    @staticmethod
    def backward(ctx, grad):
        return _all_to_all(grad, ctx.group), None


def _rows_to_blocks(x: torch.Tensor, group) -> torch.Tensor:
    """This rank's ``(b, s, ...)`` rows -> ``(n * b, s / n, ...)``: sequence
    block ``r`` (this rank's) of every rank's rows, in rank order."""
    n = dist.get_world_size(group)
    b, s = x.shape[:2]
    # chunk j (sequence block j) to rank j; chunk i of the output came from rank i
    x = x.reshape(b, n, s // n, *x.shape[2:]).transpose(0, 1)
    return _AllToAll.apply(x, group).reshape(n * b, s // n, *x.shape[3:])


def _blocks_to_rows(x: torch.Tensor, group) -> torch.Tensor:
    """The inverse of :func:`_rows_to_blocks`: each rank its own rows, with
    every sequence block in order."""
    n = dist.get_world_size(group)
    b, s_blk = x.shape[0] // n, x.shape[1]
    # chunk j (rank j's rows) to rank j; chunk i of the output is sequence block i
    x = _AllToAll.apply(x.reshape(n, b, s_blk, *x.shape[2:]), group)
    return x.transpose(0, 1).reshape(b, n * s_blk, *x.shape[3:])


# ----------------------------------------------------------------------
# the schemes, on each rank's block
# ----------------------------------------------------------------------
def ring_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    group=None,
    causal: bool = False,
    scale: Optional[float] = None,
    kv_len: Optional[int] = None,
) -> torch.Tensor:
    """Blockwise ring attention over a sequence split across ``group``
    (default: every rank).

    Each rank passes its block ``(batch, seq / n, heads, head_dim)`` of
    q/k/v, rank ``r`` holding positions ``[r * seq / n, (r + 1) * seq /
    n)``. Every rank attends its Q block to all K/V blocks as they rotate
    around the ring; the softmax is accumulated online, so the result is
    full attention over the whole sequence (up to float association).
    ``causal`` and ``kv_len`` mask by global position. The running maxima
    are constants of the accumulation (the result does not depend on them),
    so no gradient flows through them.
    """
    n, idx = dist.get_world_size(group), dist.get_rank(group)
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    b, s_blk, h, d = q.shape
    qs = q.float() * scale
    acc = torch.zeros((b, s_blk, h, d), dtype=torch.float32, device=q.device)
    denom = torch.zeros((b, h, s_blk), dtype=torch.float32, device=q.device)
    running_max = torch.full((b, h, s_blk), float("-inf"), device=q.device)
    q_pos = idx * s_blk + torch.arange(s_blk, device=q.device)
    k_blk, v_blk = k, v
    for i in range(n):
        src = (idx + i) % n
        logits = torch.einsum("bqhd,bkhd->bhqk", qs, k_blk.float())
        k_pos = src * s_blk + torch.arange(s_blk, device=q.device)
        mask = torch.ones((s_blk, s_blk), dtype=torch.bool, device=q.device)
        if causal:
            mask = mask & (q_pos[:, None] >= k_pos[None, :])
        if kv_len is not None:
            mask = mask & (k_pos < kv_len)[None, :]
        with torch.no_grad():
            blk_max = logits.masked_fill(~mask, float("-inf")).amax(dim=-1)
            new_max = torch.maximum(running_max, blk_max)
            shift = torch.where(torch.isneginf(new_max), torch.zeros_like(new_max), new_max)
            # fully-masked rows keep a -inf max and a zero correction
            correction = torch.where(torch.isneginf(running_max),
                                     torch.zeros_like(running_max),
                                     torch.exp(running_max - shift))
        probs = torch.where(mask, torch.exp(logits - shift[..., None]),
                            torch.zeros_like(logits))
        acc = acc * correction.transpose(1, 2)[..., None] + torch.einsum(
            "bhqk,bkhd->bqhd", probs, v_blk.float())
        denom = denom * correction + probs.sum(dim=-1)
        running_max = new_max
        if i + 1 < n:
            # rotate K/V to the next rank (a ring of one has no neighbour)
            k_blk = _RingShift.apply(k_blk, group)
            v_blk = _RingShift.apply(v_blk, group)
    safe = torch.where(denom == 0.0, torch.ones_like(denom), denom)
    out = acc / safe.transpose(1, 2)[..., None]
    return out.to(q.dtype)


def ulysses_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    group=None,
    causal: bool = False,
    scale: Optional[float] = None,
    kv_len: Optional[int] = None,
    local_attn: Optional[Callable] = None,
) -> torch.Tensor:
    """Ulysses sequence parallelism: all-to-all from sequence blocks to
    head groups and back.

    Each rank passes its sequence block as :func:`ring_attention` does;
    ``heads`` must divide by the group's size. Rank ``j`` ends up with the
    whole sequence for heads ``[j * h / n, (j + 1) * h / n)``, attends with
    ``local_attn`` (default :func:`full_attention`; the port's
    ``flash_attention`` for ``impl="ulysses-flash"``), and the result goes
    back to sequence blocks with the heads in their order.
    """
    n = dist.get_world_size(group)
    b, s_blk, h, d = q.shape
    if h % n != 0:
        raise ValueError(
            f"ulysses_attention requires heads ({h}) divisible by the "
            f"sequence-axis size ({n}); use ring_attention instead"
        )

    def to_heads(x):
        # (b, s/n, h, d) -> chunk j of heads to rank j -> (b, s, h/n, d),
        # the sequence in rank order
        x = x.reshape(b, s_blk, n, h // n, d).permute(2, 0, 1, 3, 4)
        x = _AllToAll.apply(x, group)                     # (n_src, b, s/n, h/n, d)
        return x.permute(1, 0, 2, 3, 4).reshape(b, n * s_blk, h // n, d)

    def to_seq(x):
        # (b, s, h/n, d) -> sequence block i to rank i -> (b, s/n, h, d),
        # the heads reassembled as (rank, local head)
        x = x.reshape(b, n, s_blk, h // n, d).permute(1, 0, 2, 3, 4)
        x = _AllToAll.apply(x, group)                     # (n_heads, b, s/n, h/n, d)
        return x.permute(1, 2, 0, 3, 4).reshape(b, s_blk, h, d)

    attn = local_attn if local_attn is not None else full_attention
    out = attn(to_heads(q), to_heads(k), to_heads(v), causal=causal, scale=scale,
               kv_len=kv_len)
    return to_seq(out)


def make_sp_attention(mesh, axis_name: str = "seq", impl: str = "ring",
                      causal: bool = False, kv_len: Optional[int] = None):
    """``fn(q, k, v)`` over each rank's own ``(batch, seq, heads,
    head_dim)`` rows, with the sequence split over ``mesh``'s ``axis_name``
    (a ``DeviceMesh``; a process group or ``None``, every rank, also do).
    Every rank of the axis calls it with the same shapes; the ranks may hold
    the same rows (a replicated model) or their own (a data-parallel fit).
    The group attends over every rank's rows, each rank over its sequence
    block of them, and each rank gets its own rows' result back. ``impl`` is
    ``"ring"``, ``"ulysses"`` or ``"ulysses-flash"`` (Ulysses with the
    port's flash kernels as the local step: #1 in inference, #2-#4 in
    training; the plain version on CPU tensors). Gradients flow back to each
    rank's own rows, as from a model on one device over the global batch."""
    if impl == "ring":
        inner = ring_attention
    elif impl == "ulysses-flash":
        from sparkdl_tpu_torch.ops.flash_attention import flash_attention

        inner = partial(ulysses_attention, local_attn=flash_attention)
    elif impl == "ulysses":
        inner = ulysses_attention
    else:
        raise ValueError(
            f"unknown SP attention impl {impl!r}; expected 'ring', "
            "'ulysses', or 'ulysses-flash'"
        )
    group = axis_group(mesh, axis_name)

    def fn(q, k, v):
        n = dist.get_world_size(group)
        if q.shape[1] % n:
            raise ValueError(f"sequence length {q.shape[1]} does not split over {n} "
                             "ranks; use pad_tokens_for_sp")
        blocks = [_rows_to_blocks(t, group) for t in (q, k, v)]
        out = inner(*blocks, group=group, causal=causal, kv_len=kv_len)
        return _blocks_to_rows(out, group)

    return fn


def pad_tokens_for_sp(mesh, axis_name: str = "seq", impl: str = "ring",
                      causal: bool = False):
    """Sequence-parallel attention for token counts that do not divide the
    axis (a ViT's CLS token breaks divisibility by design): pads the token
    axis up to a multiple, masks the pad keys out of the softmax
    (``kv_len``), runs :func:`make_sp_attention`'s schedule and slices the
    pad queries off. Returns ``fn(q, k, v)``, usable as a model's
    ``attn_impl``."""
    n = dist.get_world_size(axis_group(mesh, axis_name))
    schedules = {}

    def fn(q, k, v):
        s = q.shape[1]
        pad = (-s) % n
        if s not in schedules:
            schedules[s] = make_sp_attention(mesh, axis_name=axis_name, impl=impl,
                                             causal=causal, kv_len=s)
        if pad:
            q, k, v = (torch.nn.functional.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
        out = schedules[s](q, k, v)
        return out[:, :s] if pad else out

    return fn
