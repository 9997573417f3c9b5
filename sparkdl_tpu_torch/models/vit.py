"""Vision Transformer (ViT-B/16 family) in PyTorch.

Port of ``sparkdl_tpu.models.vit``: the same variants, the same parameters
under the same names (see :mod:`sparkdl_tpu_torch.models.convert`) and the
same numbers as the Flax module, with NHWC input like it. What differs from
PyTorch's habits, to match Flax:

- LayerNorm uses ``eps=1e-6``;
- ``exact_gelu=False`` is the tanh-approximate gelu;
- patch tokens run row-major over the (h, w) patch grid, as Flax's
  ``reshape(b, -1, dim)`` of an NHWC feature map;
- parameters stay float32 and ``dtype`` is the computation type, as Flax's
  ``dtype``; the CLS token and position embedding are cast to it at use.

``attn_impl`` switches the attention schedule without touching parameters:
``"full"`` (dense), ``"flash"`` (the CUDA kernel) or a callable
``(q, k, v) -> out`` over ``(batch, seq, heads, head_dim)`` tensors.
"""

from __future__ import annotations

from typing import Callable, Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from sparkdl_tpu_torch.ops.flash_attention import flash_attention
from sparkdl_tpu_torch.parallel.context import full_attention

# name -> (patch, dim, depth, heads, mlp_dim)
VIT_VARIANTS = {
    "ViT-Ti/16": (16, 192, 12, 3, 768),
    "ViT-S/16": (16, 384, 12, 6, 1536),
    "ViT-B/16": (16, 768, 12, 12, 3072),
    "ViT-B/32": (32, 768, 12, 12, 3072),
    "ViT-L/16": (16, 1024, 24, 16, 4096),
}

AttnImpl = Union[str, Callable]


def resolve_attention(attn_impl: AttnImpl) -> Callable:
    if callable(attn_impl):
        return attn_impl
    if attn_impl == "full":
        return full_attention
    if attn_impl == "flash":
        return flash_attention
    raise ValueError(
        f"attn_impl must be 'full', 'flash' or a callable, got {attn_impl!r}"
    )


class Dense(nn.Linear):
    """``nn.Linear`` that computes in its input's type (Flax ``Dense``:
    float32 parameters, ``dtype`` computation)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


class LayerNorm(nn.LayerNorm):
    """Flax ``LayerNorm``: ``eps=1e-6``, statistics in float32, output in
    the input's type."""

    def __init__(self, dim: int):
        super().__init__(dim, eps=1e-6)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(
            x.float(), self.normalized_shape, self.weight, self.bias, self.eps
        )
        return y.to(x.dtype)


class ViTEncoderBlock(nn.Module):
    def __init__(
        self,
        dim: int,
        heads: int,
        mlp_dim: int,
        attn_impl: AttnImpl = "full",
        exact_gelu: bool = False,
    ):
        super().__init__()
        self.dim = dim
        self.heads = heads
        self.attention = resolve_attention(attn_impl)
        # tanh-approximate gelu matches google-research/vision_transformer
        # (the Flax default); exact (erf) gelu matches torch/HF ViT
        self.gelu_approximate = "none" if exact_gelu else "tanh"
        self.ln_1 = LayerNorm(dim)
        self.qkv = Dense(dim, 3 * dim)
        self.proj = Dense(dim, dim)
        self.ln_2 = LayerNorm(dim)
        self.mlp_up = Dense(dim, mlp_dim)
        self.mlp_down = Dense(mlp_dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, s, _ = x.shape
        head_dim = self.dim // self.heads
        # views into the fused projection: the flash kernel reads them in
        # place through their strides
        q, k, v = (
            t.reshape(b, s, self.heads, head_dim)
            for t in self.qkv(self.ln_1(x)).chunk(3, dim=-1)
        )
        attn = self.attention(q, k, v).reshape(b, s, self.dim)
        x = x + self.proj(attn)
        y = self.mlp_up(self.ln_2(x))
        y = F.gelu(y, approximate=self.gelu_approximate)
        return x + self.mlp_down(y)


class ViT(nn.Module):
    """``variant`` picks the geometry; input is NHWC RGB, ``image_size`` square.

    ``forward(x, features_only=False)`` returns logits, or the CLS embedding
    after the final LayerNorm (the transfer-learning cut point) when
    ``features_only`` is set or the model has no head.
    """

    def __init__(
        self,
        variant: str = "ViT-B/16",
        num_classes: int = 1000,
        include_top: bool = True,
        dtype: Optional[torch.dtype] = None,
        attn_impl: AttnImpl = "full",
        image_size: int = 224,
        exact_gelu: bool = False,
    ):
        super().__init__()
        patch, dim, depth, heads, mlp_dim = VIT_VARIANTS[variant]
        self.patch = patch
        self.dim = dim
        self.dtype = dtype
        tokens = (image_size // patch) ** 2 + 1
        self.patch_embed = nn.Conv2d(3, dim, patch, stride=patch)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.pos_embed = nn.Parameter(torch.empty(1, tokens, dim))
        nn.init.normal_(self.pos_embed, std=0.02)
        self.blocks = nn.ModuleList(
            ViTEncoderBlock(dim, heads, mlp_dim, attn_impl, exact_gelu)
            for _ in range(depth)
        )
        self.ln_final = LayerNorm(dim)
        self.head = Dense(dim, num_classes) if include_top else None

    def forward(self, x: torch.Tensor, features_only: bool = False) -> torch.Tensor:
        dtype = self.dtype or torch.promote_types(x.dtype, torch.float32)
        b = x.shape[0]
        conv = self.patch_embed
        x = F.conv2d(
            x.permute(0, 3, 1, 2).to(dtype),
            conv.weight.to(dtype),
            conv.bias.to(dtype),
            stride=self.patch,
        )
        x = x.flatten(2).transpose(1, 2)  # (b, tokens, dim), row-major (h, w)
        cls = self.cls_token.to(dtype).expand(b, 1, self.dim)
        x = torch.cat([cls, x], dim=1) + self.pos_embed.to(dtype)
        for block in self.blocks:
            x = block(x)
        feats = self.ln_final(x)[:, 0]
        if features_only or self.head is None:
            return feats
        return self.head(feats)
