"""ResNet50 (v1, post-activation) in PyTorch.

Port of ``sparkdl_tpu.models.resnet``: the same Keras layer names
(``conv1_conv``, ``conv{S}_block{B}_{i}_conv`` / ``_bn``), convs with bias,
batch norm with scale and epsilon 1.001e-5, the stride on the first 1x1
conv of each block (Keras v1) and on the 1x1 projection shortcut. The stem
pads 3 cells of zeros before a 7x7 stride-2 ``'VALID'`` conv, and 1 cell of
zeros (not -inf) before the 3x3 stride-2 ``'VALID'`` max pool, as the Flax
module does. Cut point: the 2048-d global average pool. Input is NCHW (the
card runs it in channels_last memory); 224x224, "caffe" preprocessing.
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
    global_avg_pool,
    head,
    max_pool,
)

BN_EPSILON = 1.001e-5

# (name, filters, blocks, stride of the first block)
_STACKS = (("conv2", 64, 3, 1), ("conv3", 128, 4, 2), ("conv4", 256, 6, 2),
           ("conv5", 512, 3, 2))


class ResNet50(nn.Module):
    """``features_only`` (or ``include_top=False``) returns the 2048-d
    features, else the ``num_classes`` logits, in ``dtype``.
    ``num_classes=None`` leaves out the ``predictions`` Dense."""

    def __init__(self, num_classes: Optional[int] = 1000, include_top: bool = True,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.num_classes = num_classes
        self.include_top = include_top
        self.dtype = dtype or torch.float32
        self._conv_bn("conv1", 3, 64, 7, 2)
        cin = 64
        for stack, filters, blocks, stride in _STACKS:
            for b in range(1, blocks + 1):
                name = f"{stack}_block{b}"
                s = stride if b == 1 else 1
                if b == 1:
                    self._conv_bn(f"{name}_0", cin, 4 * filters, 1, s)
                self._conv_bn(f"{name}_1", cin, filters, 1, s)
                self._conv_bn(f"{name}_2", filters, filters, 3, 1, "SAME")
                self._conv_bn(f"{name}_3", filters, 4 * filters, 1, 1)
                cin = 4 * filters
        self.num_features = cin
        self.predictions = (Dense(cin, num_classes)
                            if include_top and num_classes else None)

    def _conv_bn(self, name: str, cin: int, cout: int, kernel: int, strides: int,
                 padding: str = "VALID") -> None:
        self.add_module(f"{name}_conv", Conv(cin, cout, kernel, strides, padding,
                                             use_bias=True))
        self.add_module(f"{name}_bn", BatchNorm(cout, BN_EPSILON))

    def _unit(self, name: str, x: torch.Tensor) -> torch.Tensor:
        x = getattr(self, f"{name}_conv")(x)
        return getattr(self, f"{name}_bn")(x)

    def forward(self, x: torch.Tensor, features_only: bool = False) -> torch.Tensor:
        x = F.pad(x.to(self.dtype), (3, 3, 3, 3))
        x = F.relu(self._unit("conv1", x))
        x = max_pool(F.pad(x, (1, 1, 1, 1)), 3, 2)
        for stack, _, blocks, _ in _STACKS:
            for b in range(1, blocks + 1):
                name = f"{stack}_block{b}"
                shortcut = self._unit(f"{name}_0", x) if b == 1 else x
                y = F.relu(self._unit(f"{name}_1", x))
                y = F.relu(self._unit(f"{name}_2", y))
                x = F.relu(shortcut + self._unit(f"{name}_3", y))
        return head(self, global_avg_pool(x), features_only)
