"""MobileNetV2 (alpha=1.0) in PyTorch.

Port of ``sparkdl_tpu.models.mobilenet_v2``: the same Keras layer names
(``Conv1`` / ``bn_Conv1``, ``expanded_conv_*``, ``block_N_expand`` /
``_depthwise`` / ``_project`` with ``_BN`` suffixes, ``Conv_1`` /
``Conv_1_bn``), bias-free convs, batch norm with scale and epsilon 1e-3,
ReLU6 as ``min(relu(x), 6)``. The 3x3 depthwise convs are grouped convs
(``groups=cin``, weight ``(cin, 1, 3, 3)``) under TF ``'SAME'`` padding,
asymmetric at stride 2; the residual is added only where ``stride == 1``
and the block keeps its width. Cut point: the 1280-d global average pool.
Input is NCHW; 224x224, "tf" preprocessing.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from sparkdl_tpu_torch.models.layers import BatchNorm, Conv, Dense, global_avg_pool, head

BN_EPSILON = 1e-3

# (out_filters, stride, expansion) per inverted-residual block, block_id 0..16
_BLOCKS = (
    (16, 1, 1),
    (24, 2, 6), (24, 1, 6),
    (32, 2, 6), (32, 1, 6), (32, 1, 6),
    (64, 2, 6), (64, 1, 6), (64, 1, 6), (64, 1, 6),
    (96, 1, 6), (96, 1, 6), (96, 1, 6),
    (160, 2, 6), (160, 1, 6), (160, 1, 6),
    (320, 1, 6),
)


def relu6(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp_max(F.relu(x), 6.0)


def _prefix(block_id: int) -> str:
    return "expanded_conv" if block_id == 0 else f"block_{block_id}"


class MobileNetV2(nn.Module):
    """``features_only`` (or ``include_top=False``) returns the 1280-d
    features, else the ``num_classes`` logits, in ``dtype``.
    ``num_classes=None`` leaves out the ``predictions`` Dense."""

    def __init__(self, num_classes: Optional[int] = 1000, include_top: bool = True,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.num_classes = num_classes
        self.include_top = include_top
        self.dtype = dtype or torch.float32
        self.Conv1 = Conv(3, 32, 3, 2, "SAME")
        self.bn_Conv1 = BatchNorm(32, BN_EPSILON)
        cin = 32
        for block_id, (filters, stride, expansion) in enumerate(_BLOCKS):
            prefix = _prefix(block_id)
            width = expansion * cin
            if expansion != 1:
                self.add_module(f"{prefix}_expand", Conv(cin, width, 1))
                self.add_module(f"{prefix}_expand_BN", BatchNorm(width, BN_EPSILON))
            self.add_module(f"{prefix}_depthwise",
                            Conv(width, width, 3, stride, "SAME", groups=width))
            self.add_module(f"{prefix}_depthwise_BN", BatchNorm(width, BN_EPSILON))
            self.add_module(f"{prefix}_project", Conv(width, filters, 1))
            self.add_module(f"{prefix}_project_BN", BatchNorm(filters, BN_EPSILON))
            cin = filters
        self.Conv_1 = Conv(cin, 1280, 1)
        self.Conv_1_bn = BatchNorm(1280, BN_EPSILON)
        self.num_features = 1280
        self.predictions = (Dense(1280, num_classes)
                            if include_top and num_classes else None)

    def _unit(self, conv: str, bn: str, x: torch.Tensor) -> torch.Tensor:
        return getattr(self, bn)(getattr(self, conv)(x))

    def forward(self, x: torch.Tensor, features_only: bool = False) -> torch.Tensor:
        x = relu6(self.bn_Conv1(self.Conv1(x.to(self.dtype))))
        for block_id, (filters, stride, expansion) in enumerate(_BLOCKS):
            prefix = _prefix(block_id)
            inputs, cin = x, x.shape[1]
            if expansion != 1:
                x = relu6(self._unit(f"{prefix}_expand", f"{prefix}_expand_BN", x))
            x = relu6(self._unit(f"{prefix}_depthwise", f"{prefix}_depthwise_BN", x))
            x = self._unit(f"{prefix}_project", f"{prefix}_project_BN", x)
            if stride == 1 and cin == filters:
                x = inputs + x
        x = relu6(self.Conv_1_bn(self.Conv_1(x)))
        return head(self, global_avg_pool(x), features_only)
