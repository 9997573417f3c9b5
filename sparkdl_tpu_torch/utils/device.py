"""Where the port runs: the card unless the caller asks for the CPU."""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch
from torch.utils import _pytree as pytree


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` means ``"cuda"``. A CUDA device without a card raises: the
    CPU is taken only when the caller names it."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}: use 'cuda' or 'cpu'")
    return device


def place_params(params, device=None):
    """A params tree on ``device`` (``None``: the card), once per
    transform: numpy leaves become tensors, tensors move there (a no-op
    for those already on it), other leaves stay as they are."""
    device = resolve_device(device)

    def place(leaf):
        if isinstance(leaf, (np.ndarray, np.generic)):
            leaf = torch.from_numpy(np.ascontiguousarray(leaf))
        return leaf.to(device) if isinstance(leaf, torch.Tensor) else leaf

    return pytree.tree_map(place, params)
