"""InceptionV3 in PyTorch.

Port of ``sparkdl_tpu.models.inception_v3``: the same 94 conv-BN-relu units
under the same Keras creation-order names (``conv2d``, ``conv2d_1``, ...,
``batch_normalization_93``), the same mixed0–mixed10 blocks, the 2048-d
global-average-pool cut point and the ``predictions`` Dense. Input is NCHW
(the card runs it in channels_last memory); the JAX module's is NHWC.

What is kept from Flax, to give its numbers:

- the convolutions have no bias, and TF ``'SAME'`` / ``'VALID'`` padding
  (:class:`sparkdl_tpu_torch.models.layers.Conv`);
- batch norm has no scale (``use_scale=False``), epsilon 1e-3 and running
  statistics, and is float32 arithmetic on the conv output, rounded once to
  the computation type: Flax's ``BatchNorm(dtype=bf16)`` meets float32
  ``mean``/``var`` and promotes;
- parameters stay float32 and ``dtype`` is the computation type, as Flax's
  ``dtype``; a caller may keep the conv and Dense weights in ``dtype``
  already (the cast is then skipped), never the batch-norm vectors.

The graph is written once (:func:`_graph`) and runs twice: at construction
over channel counts, which creates the units in creation order, and in
``forward`` over tensors, which takes them in the same order.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from sparkdl_tpu_torch.models.layers import (
    BatchNorm,
    Conv,
    Dense,
    avg_pool,
    global_avg_pool,
    head,
    max_pool,
)

BN_EPSILON = 1e-3


def conv_name(i: int) -> str:
    return "conv2d" if i == 0 else f"conv2d_{i}"


def bn_name(i: int) -> str:
    return "batch_normalization" if i == 0 else f"batch_normalization_{i}"


class _Build:
    """The graph's ops over channel counts: each ``conv_bn`` creates the
    next unit on ``module``."""

    def __init__(self, module: nn.Module):
        self.module = module
        self.count = 0

    def conv_bn(self, cin, filters, kh, kw, strides=(1, 1), padding="SAME"):
        i = self.count
        self.count += 1
        self.module.add_module(conv_name(i), Conv(cin, filters, (kh, kw), strides, padding))
        self.module.add_module(bn_name(i), BatchNorm(filters, BN_EPSILON, use_scale=False))
        return filters

    @staticmethod
    def cat(channels):
        return sum(channels)

    @staticmethod
    def max_pool(channels):
        return channels

    avg_pool = max_pool


class _Run:
    """The graph's ops over NCHW tensors: each ``conv_bn`` runs the next
    unit of ``module``."""

    def __init__(self, module: nn.Module):
        self.module = module
        self.count = 0

    def conv_bn(self, x, *spec, **kwargs):
        i = self.count
        self.count += 1
        y = getattr(self.module, conv_name(i))(x)
        return F.relu(getattr(self.module, bn_name(i))(y))

    @staticmethod
    def cat(tensors):
        return torch.cat(tensors, dim=1)

    @staticmethod
    def max_pool(x):
        return max_pool(x, 3, 2)

    @staticmethod
    def avg_pool(x):
        return avg_pool(x, 3, 1, "SAME")


def _graph(x, op):
    """InceptionV3 from the stem to mixed10, as
    ``sparkdl_tpu/models/inception_v3.py:59-129``."""
    c = op.conv_bn
    # ---- stem ----
    x = c(x, 32, 3, 3, strides=(2, 2), padding="VALID")
    x = c(x, 32, 3, 3, padding="VALID")
    x = c(x, 64, 3, 3)
    x = op.max_pool(x)
    x = c(x, 80, 1, 1, padding="VALID")
    x = c(x, 192, 3, 3, padding="VALID")
    x = op.max_pool(x)

    # ---- mixed0..mixed2 (35x35) ----
    for pool_features in (32, 64, 64):
        b1 = c(x, 64, 1, 1)
        b5 = c(x, 48, 1, 1)
        b5 = c(b5, 64, 5, 5)
        b3d = c(x, 64, 1, 1)
        b3d = c(b3d, 96, 3, 3)
        b3d = c(b3d, 96, 3, 3)
        bp = op.avg_pool(x)
        bp = c(bp, pool_features, 1, 1)
        x = op.cat([b1, b5, b3d, bp])

    # ---- mixed3 (reduce to 17x17) ----
    b3 = c(x, 384, 3, 3, strides=(2, 2), padding="VALID")
    b3d = c(x, 64, 1, 1)
    b3d = c(b3d, 96, 3, 3)
    b3d = c(b3d, 96, 3, 3, strides=(2, 2), padding="VALID")
    bp = op.max_pool(x)
    x = op.cat([b3, b3d, bp])

    # ---- mixed4..mixed7 (17x17, factorized 7x7) ----
    for w in (128, 160, 160, 192):
        b1 = c(x, 192, 1, 1)
        b7 = c(x, w, 1, 1)
        b7 = c(b7, w, 1, 7)
        b7 = c(b7, 192, 7, 1)
        b7d = c(x, w, 1, 1)
        b7d = c(b7d, w, 7, 1)
        b7d = c(b7d, w, 1, 7)
        b7d = c(b7d, w, 7, 1)
        b7d = c(b7d, 192, 1, 7)
        bp = op.avg_pool(x)
        bp = c(bp, 192, 1, 1)
        x = op.cat([b1, b7, b7d, bp])

    # ---- mixed8 (reduce to 8x8) ----
    b3 = c(x, 192, 1, 1)
    b3 = c(b3, 320, 3, 3, strides=(2, 2), padding="VALID")
    b7x3 = c(x, 192, 1, 1)
    b7x3 = c(b7x3, 192, 1, 7)
    b7x3 = c(b7x3, 192, 7, 1)
    b7x3 = c(b7x3, 192, 3, 3, strides=(2, 2), padding="VALID")
    bp = op.max_pool(x)
    x = op.cat([b3, b7x3, bp])

    # ---- mixed9, mixed10 (8x8, expanded filter banks) ----
    for _ in range(2):
        b1 = c(x, 320, 1, 1)
        b3 = c(x, 384, 1, 1)
        b3 = op.cat([c(b3, 384, 1, 3), c(b3, 384, 3, 1)])
        b3d = c(x, 448, 1, 1)
        b3d = c(b3d, 384, 3, 3)
        b3d = op.cat([c(b3d, 384, 1, 3), c(b3d, 384, 3, 1)])
        bp = op.avg_pool(x)
        bp = c(bp, 192, 1, 1)
        x = op.cat([b1, b3, b3d, bp])
    return x


class InceptionV3(nn.Module):
    """``features_only`` (or ``include_top=False``) returns the 2048-d
    global-average-pool features, else the ``num_classes`` logits. Output
    is in ``dtype``, as Flax's. ``num_classes=None`` leaves out the
    ``predictions`` Dense (a headless tree's module)."""

    def __init__(self, num_classes: Optional[int] = 1000, include_top: bool = True,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.num_classes = num_classes
        self.include_top = include_top
        self.dtype = dtype or torch.float32
        build = _Build(self)
        self.num_features = _graph(3, build)
        self.num_units = build.count
        self.predictions = (Dense(self.num_features, num_classes)
                            if include_top and num_classes else None)

    def forward(self, x: torch.Tensor, features_only: bool = False) -> torch.Tensor:
        x = _graph(x.to(self.dtype), _Run(self))
        return head(self, global_avg_pool(x), features_only)
