"""Dense attention: ``full_attention`` of ``sparkdl_tpu.parallel.context``.

It is ViT's default ``attn_impl="full"`` and the single-device oracle of the
flash kernel. Ring and Ulysses sequence-parallel attention are not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch


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
