"""Xception in PyTorch.

Port of ``sparkdl_tpu.models.xception``: the same Keras layer names for the
separable-conv blocks (``blockN_sepconvM`` / ``_bn``) and the Keras
auto-names of the four 1x1 stride-2 residual projections (``conv2d`` ..
``conv2d_3`` with ``batch_normalization`` .. ``batch_normalization_3``);
``'VALID'`` stem convs; batch norm with scale and epsilon 1e-3; the relu
before ``sepconv1`` from block 3 on; 3x3 stride-2 ``'SAME'`` max pools,
padded with -inf. Cut point: the 2048-d global average pool. Input is
NCHW; 299x299 (71x71 at least), "tf" preprocessing.

``middle_width`` is the width of the 728-channel trunk (Keras's). A wider
module holds Keras weights zero-padded
(:func:`sparkdl_tpu_torch.models.keras_port.pad_variables_to_module`):
zero channels stay zero through the depthwise and pointwise convs, batch
norm on zero mean and unit variance, relu and the residual adds, so the
numbers are unchanged.
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
    SeparableConv,
    global_avg_pool,
    head,
    max_pool,
)

BN_EPSILON = 1e-3


def _projection_names(i: int):
    return (("conv2d", "batch_normalization") if i == 0
            else (f"conv2d_{i}", f"batch_normalization_{i}"))


class Xception(nn.Module):
    """``features_only`` (or ``include_top=False``) returns the 2048-d
    features, else the ``num_classes`` logits, in ``dtype``.
    ``num_classes=None`` leaves out the ``predictions`` Dense."""

    def __init__(self, num_classes: Optional[int] = 1000, include_top: bool = True,
                 dtype: Optional[torch.dtype] = None, middle_width: int = 728):
        super().__init__()
        self.num_classes = num_classes
        self.include_top = include_top
        self.dtype = dtype or torch.float32
        self.middle_width = width = int(middle_width)
        self.block1_conv1 = Conv(3, 32, 3, 2, "VALID")
        self.block1_conv1_bn = BatchNorm(32, BN_EPSILON)
        self.block1_conv2 = Conv(32, 64, 3, 1, "VALID")
        self.block1_conv2_bn = BatchNorm(64, BN_EPSILON)
        cin = 64
        # entry flow: three downsampling residual blocks
        for i, (filters, block) in enumerate(self._entry_blocks()):
            conv, bn = _projection_names(i)
            self.add_module(conv, Conv(cin, filters, 1, 2, "SAME"))
            self.add_module(bn, BatchNorm(filters, BN_EPSILON))
            self._sep(f"block{block}_sepconv1", cin, filters)
            self._sep(f"block{block}_sepconv2", filters, filters)
            cin = filters
        # middle flow: 8 residual blocks of 3 separable convs
        for block in range(5, 13):
            for j in (1, 2, 3):
                self._sep(f"block{block}_sepconv{j}", width, width)
        # exit flow
        conv, bn = _projection_names(3)
        self.add_module(conv, Conv(width, 1024, 1, 2, "SAME"))
        self.add_module(bn, BatchNorm(1024, BN_EPSILON))
        self._sep("block13_sepconv1", width, width)
        self._sep("block13_sepconv2", width, 1024)
        self._sep("block14_sepconv1", 1024, 1536)
        self._sep("block14_sepconv2", 1536, 2048)
        self.num_features = 2048
        self.predictions = (Dense(2048, num_classes)
                            if include_top and num_classes else None)

    def _entry_blocks(self):
        return ((128, 2), (256, 3), (self.middle_width, 4))

    def _sep(self, name: str, cin: int, cout: int) -> None:
        self.add_module(name, SeparableConv(cin, cout, 3))
        self.add_module(f"{name}_bn", BatchNorm(cout, BN_EPSILON))

    def _unit(self, name: str, x: torch.Tensor, bn: Optional[str] = None) -> torch.Tensor:
        """Layer ``name``, then its batch norm (``{name}_bn`` unless named)."""
        return getattr(self, bn or f"{name}_bn")(getattr(self, name)(x))

    def _projection(self, i: int, x: torch.Tensor) -> torch.Tensor:
        conv, bn = _projection_names(i)
        return self._unit(conv, x, bn)

    def forward(self, x: torch.Tensor, features_only: bool = False) -> torch.Tensor:
        x = F.relu(self._unit("block1_conv1", x.to(self.dtype)))
        x = F.relu(self._unit("block1_conv2", x))
        for i, (_, block) in enumerate(self._entry_blocks()):
            residual = self._projection(i, x)
            if block > 2:
                x = F.relu(x)
            x = F.relu(self._unit(f"block{block}_sepconv1", x))
            x = self._unit(f"block{block}_sepconv2", x)
            x = max_pool(x, 3, 2, "SAME") + residual
        for block in range(5, 13):
            residual = x
            for j in (1, 2, 3):
                x = self._unit(f"block{block}_sepconv{j}", F.relu(x))
            x = x + residual
        residual = self._projection(3, x)
        x = self._unit("block13_sepconv1", F.relu(x))
        x = self._unit("block13_sepconv2", F.relu(x))
        x = max_pool(x, 3, 2, "SAME") + residual
        x = F.relu(self._unit("block14_sepconv1", x))
        x = F.relu(self._unit("block14_sepconv2", x))
        return head(self, global_avg_pool(x), features_only)
