"""The shared pieces of the port's CNNs: convolution, batch norm,
separable convolution, pooling and TF-``'SAME'`` padding.

Port of ``sparkdl_tpu.models.layers`` (and of the Flax ``nn.Conv`` and
``nn.BatchNorm`` the zoo builds on) in NCHW; the card runs it in
channels_last memory. What the Flax layers take from TensorFlow, and
PyTorch's own ops do not do by themselves:

- ``'SAME'`` pads ``ceil(n / s)`` outputs' worth, the odd cell after: a
  stride-2 convolution or pool on an even input pads asymmetrically, and
  ``torch.nn.functional.conv2d(padding="same")`` refuses stride > 1;
- average pooling divides by the count of cells that are not padding;
- ``'SAME'`` max pooling pads with -inf.

Parameters stay float32 and a module's ``dtype`` is the computation type,
as Flax's ``dtype``: the conv weights are cast at each use (a no-op when
the caller holds them in that type already), batch norm's vectors never.
Each parameter's name is its Flax leaf's where the two agree (``bias``,
``scale``, ``mean``, ``var``, ``depthwise_kernel``, ``pointwise_kernel``);
a conv kernel is ``weight``, OIHW, as PyTorch names it.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

IntPair = Union[int, Tuple[int, int]]


def _pair(v: IntPair) -> Tuple[int, int]:
    if isinstance(v, (tuple, list)):
        return (int(v[0]), int(v[1]))
    return (int(v), int(v))


def tf_same_padding(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """TensorFlow's ``'SAME'`` padding of one spatial axis: ``(before,
    after)`` such that the output has ``ceil(size / stride)`` cells; the odd
    cell goes after."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def _pads(x: torch.Tensor, window: Tuple[int, int], strides: Tuple[int, int],
          padding: str) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """``((top, bottom), (left, right))`` of ``padding`` over NCHW ``x``."""
    if padding == "VALID":
        return (0, 0), (0, 0)
    if padding != "SAME":
        raise ValueError(f"padding must be 'SAME' or 'VALID', got {padding!r}")
    return (tf_same_padding(x.shape[2], window[0], strides[0]),
            tf_same_padding(x.shape[3], window[1], strides[1]))


def _symmetric(pads) -> bool:
    return all(before == after for before, after in pads)


def _flat(pads) -> Tuple[int, int, int, int]:
    """``F.pad``'s order: last axis first."""
    (top, bottom), (left, right) = pads
    return (left, right, top, bottom)


def conv2d(x: torch.Tensor, weight: torch.Tensor, strides: IntPair = 1,
           padding: str = "SAME", bias: Optional[torch.Tensor] = None,
           groups: int = 1, dilation: IntPair = 1) -> torch.Tensor:
    """Convolution of NCHW ``x`` with an OIHW ``weight`` (``(cout, cin /
    groups, kh, kw)``) under TF padding: symmetric pads go to the
    convolution, asymmetric ones to an explicit zero pad before a
    ``'VALID'`` convolution. A dilated kernel pads as its spread
    ``(k - 1) * d + 1``."""
    strides, dilation = _pair(strides), _pair(dilation)
    spread = tuple((k - 1) * d + 1 for k, d in zip(weight.shape[2:], dilation))
    pads = _pads(x, spread, strides, padding)
    if _symmetric(pads):
        return F.conv2d(x, weight, bias, stride=strides,
                        padding=(pads[0][0], pads[1][0]), dilation=dilation,
                        groups=groups)
    return F.conv2d(F.pad(x, _flat(pads)), weight, bias, stride=strides,
                    dilation=dilation, groups=groups)


class Conv(nn.Module):
    """Flax ``nn.Conv`` with TF padding: ``weight`` is OIHW, ``bias``
    (when ``use_bias``) is added in the computation type, as Flax adds it;
    ``groups=cin`` is a depthwise convolution, whose weight is ``(cin, 1,
    kh, kw)``."""

    def __init__(self, cin: int, cout: int, kernel, strides=1, padding: str = "SAME",
                 use_bias: bool = False, groups: int = 1, dilation=1):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros((cout, cin // groups, *_pair(kernel))))
        self.bias = nn.Parameter(torch.zeros(cout)) if use_bias else None
        self.strides = _pair(strides)
        self.padding = padding
        self.groups = groups
        self.dilation = _pair(dilation)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return conv2d(x, self.weight.to(x.dtype), self.strides, self.padding,
                      bias, self.groups, self.dilation)


class BatchNorm(nn.Module):
    """Flax ``BatchNorm(use_running_average=True)``: ``(x - mean) *
    (rsqrt(var + eps) * scale) + bias`` in float32, rounded once to the
    input's type (a bf16 ``x`` meets float32 ``mean`` and promotes, as in
    Flax). Without ``use_scale`` the multiplier is ``rsqrt(var + eps)``.
    The features are dim 1 of an input of any rank (NCHW, or a batch of
    vectors)."""

    def __init__(self, features: int, epsilon: float = 1e-3, use_scale: bool = True):
        super().__init__()
        self.epsilon = float(epsilon)
        self.scale = nn.Parameter(torch.ones(features)) if use_scale else None
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = (1, -1) + (1,) * (x.dim() - 2)
        mul = torch.rsqrt(self.var + self.epsilon)
        if self.scale is not None:
            mul = mul * self.scale
        # x - mean promotes a bf16 x to float32 exactly
        y = (x - self.mean.view(shape)).mul_(mul.view(shape)).add_(self.bias.view(shape))
        return y.to(x.dtype)


class SeparableConv(nn.Module):
    """Keras ``SeparableConv2D`` without bias, as Xception uses it: a 3x3
    depthwise convolution (``depthwise_kernel``, ``(cin, 1, kh, kw)``,
    ``groups=cin``) under TF padding, then a 1x1 pointwise one
    (``pointwise_kernel``, ``(cout, cin, 1, 1)``)."""

    def __init__(self, cin: int, cout: int, kernel=3, strides=1, padding: str = "SAME"):
        super().__init__()
        self.depthwise_kernel = nn.Parameter(torch.zeros((cin, 1, *_pair(kernel))))
        self.pointwise_kernel = nn.Parameter(torch.zeros((cout, cin, 1, 1)))
        self.strides = _pair(strides)
        self.padding = padding

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = conv2d(x, self.depthwise_kernel.to(x.dtype), self.strides, self.padding,
                   groups=x.shape[1])
        return F.conv2d(x, self.pointwise_kernel.to(x.dtype))


class Dense(nn.Linear):
    """Flax ``nn.Dense``: ``x @ kernel + bias`` in the input's type;
    ``weight`` is ``(out, in)``; ``bias=False`` leaves the bias out. Made at
    zero: its values come from a ``state_dict``."""

    def reset_parameters(self) -> None:
        with torch.no_grad():
            self.weight.zero_()
            if self.bias is not None:
                self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), bias)


# the layers whose weights a stage holds in the computation type
CONV_TYPES = (Conv, SeparableConv)


def head(module: nn.Module, x: torch.Tensor, features_only: bool) -> torch.Tensor:
    """The end of a zoo model's forward: ``x`` at the featurization cut, or
    the ``predictions`` Dense of it. A module built with ``num_classes=None``
    has no ``predictions`` and featurizes only."""
    if features_only or not module.include_top:
        return x
    if module.predictions is None:
        raise ValueError(f"{type(module).__name__} was built without its predictions "
                         "layer (num_classes=None): it featurizes only")
    return module.predictions(x)


def max_pool(x: torch.Tensor, window: IntPair = 3, strides: IntPair = 2,
             padding: str = "VALID") -> torch.Tensor:
    window, strides = _pair(window), _pair(strides)
    pads = _pads(x, window, strides, padding)
    if pads != ((0, 0), (0, 0)):
        x = F.pad(x, _flat(pads), value=float("-inf"))
    return F.max_pool2d(x, window, strides)


def avg_pool(x: torch.Tensor, window: IntPair = 3, strides: IntPair = 1,
             padding: str = "SAME") -> torch.Tensor:
    """TF/Keras average pooling: padded cells are left out of the divisor
    (``count_include_pad=False``, ``sparkdl_tpu/models/layers.py:100``)."""
    window, strides = _pair(window), _pair(strides)
    pads = _pads(x, window, strides, padding)
    if _symmetric(pads):
        return F.avg_pool2d(x, window, strides, padding=(pads[0][0], pads[1][0]),
                            count_include_pad=False)
    # asymmetric: window sums over the zero-padded input, over the count of
    # real cells under each window
    flat = _flat(pads)
    sums = F.avg_pool2d(F.pad(x, flat), window, strides, divisor_override=1)
    ones = torch.ones((1, 1, *x.shape[2:]), dtype=x.dtype, device=x.device)
    counts = F.avg_pool2d(F.pad(ones, flat), window, strides, divisor_override=1)
    return sums / counts


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """Mean over H and W, in float32 and rounded once to the input's type,
    as ``jnp.mean`` of a bfloat16 array."""
    return x.mean(dim=(2, 3), dtype=torch.float32).to(x.dtype)
