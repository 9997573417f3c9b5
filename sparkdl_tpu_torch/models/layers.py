"""Pooling and TF-``'SAME'`` padding for the port's CNNs.

Port of ``sparkdl_tpu.models.layers`` in NCHW (the card runs it in
channels_last memory). What the Flax layers take from TensorFlow, and
PyTorch's own ops do not do by themselves:

- ``'SAME'`` pads ``ceil(n / s)`` outputs' worth, the odd cell after: a
  stride-2 convolution or pool on an even input pads asymmetrically, and
  ``torch.nn.functional.conv2d(padding="same")`` refuses stride > 1;
- average pooling divides by the count of cells that are not padding;
- ``'SAME'`` max pooling pads with -inf.

``SeparableConv`` is not ported yet (Xception, ROADMAP item 5).
"""

from __future__ import annotations

from typing import Tuple, Union

import torch
import torch.nn.functional as F

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
           padding: str = "SAME") -> torch.Tensor:
    """Bias-free convolution of NCHW ``x`` with an OIHW ``weight`` under
    TF padding: symmetric pads go to the convolution, asymmetric ones to an
    explicit zero pad before a ``'VALID'`` convolution."""
    strides = _pair(strides)
    pads = _pads(x, weight.shape[2:], strides, padding)
    if _symmetric(pads):
        return F.conv2d(x, weight, stride=strides,
                        padding=(pads[0][0], pads[1][0]))
    return F.conv2d(F.pad(x, _flat(pads)), weight, stride=strides)


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
