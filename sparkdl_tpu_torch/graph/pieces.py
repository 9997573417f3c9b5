"""Prebuilt pieces of the graph layer: port of ``sparkdl_tpu.graph.pieces``.

Each piece is a :class:`~sparkdl_tpu_torch.graph.function.TorchFunction`
over NHWC batches, composed with a model by ``TorchFunction.from_list``.
The decode of image structs happens on the host in the transformers; pieces
start from uint8 or float tensors.
"""

from __future__ import annotations

from typing import Tuple

import torch

from sparkdl_tpu_torch.graph.function import TorchFunction
from sparkdl_tpu_torch.models.registry import preprocess_input
from sparkdl_tpu_torch.transformers.utils import resize_bilinear


def build_sp_image_converter(
    channel_order: str = "BGR", output_dtype=torch.float32
) -> TorchFunction:
    """A stored image batch (NHWC, Spark's BGR order) -> a float RGB batch.

    ``channel_order`` is the order converted from: 'BGR' flips the
    channels, 'RGB' and 'L' (one channel) pass through."""
    order = channel_order.upper()
    if order not in ("BGR", "RGB", "L"):
        raise ValueError(f"Unsupported channel order {channel_order!r}")

    def convert(x):
        x = x.to(output_dtype)
        return x.flip(-1) if order == "BGR" else x

    return TorchFunction.from_callable(convert, name=f"spImageConverter[{order}]")


def build_flattener() -> TorchFunction:
    """A batch ``(N, ...)`` -> ``(N, prod(...))`` float32."""

    def flatten(x):
        return x.reshape(x.shape[0], -1).float()

    return TorchFunction.from_callable(flatten, name="flattener")


def build_resizer(size: Tuple[int, int], method: str = "bilinear") -> TorchFunction:
    """A float NHWC batch resized to ``size=(H, W)`` on its device, as
    ``jax.image.resize(..., "bilinear")`` resizes it
    (:func:`~sparkdl_tpu_torch.transformers.utils.resize_bilinear`), clipped
    to 0-255. Only the bilinear method is ported."""
    if method != "bilinear":
        raise ValueError(f"resize method {method!r} is not ported; use 'bilinear'")
    height, width = int(size[0]), int(size[1])

    def resize(x):
        return resize_bilinear(x.float(), (height, width)).clamp(0.0, 255.0)

    return TorchFunction.from_callable(resize, name=f"resizer{(height, width)}")


def build_preprocessor(mode: str = "tf") -> TorchFunction:
    """Keras ``preprocess_input`` over float RGB batches, as the model
    registry computes it:

    - ``"tf"``: scale to [-1, 1];
    - ``"torch"``: scale to [0, 1], normalize by the ImageNet mean and std;
    - ``"caffe"``: convert to BGR, subtract the ImageNet BGR means;
    - ``"none"``: identity.
    """
    mode = mode.lower()
    if mode == "none":
        return TorchFunction.from_callable(lambda x: x, name="preprocess[none]")
    preprocess_input(torch.zeros((1, 1, 1, 3)), mode)  # an unknown mode raises now

    def pre(x):
        return preprocess_input(x, mode)

    return TorchFunction.from_callable(pre, name=f"preprocess[{mode}]")
