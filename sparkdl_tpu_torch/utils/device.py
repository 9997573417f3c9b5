"""Where the port runs: the card unless the caller asks for the CPU."""

from __future__ import annotations

import threading
from typing import Optional, Union

import numpy as np
import torch
from torch.utils import _pytree as pytree

#: the devices a thread is restricted to (``parallel.trainer.device_slice``)
_DEVICE_SLICE = threading.local()


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` means ``"cuda"``, or the card of the thread's device slice
    (``parallel.trainer.device_slice``) when one is bound. A CUDA device
    without a card raises: the CPU is taken only when the caller names it."""
    if device is None:
        bound = getattr(_DEVICE_SLICE, "devices", None)
        if bound is not None and len(bound) != 1:
            raise ValueError(
                f"this thread is bound to {len(bound)} devices ({bound}); one process "
                "drives one card, so a trial thread's slice must be one card")
        device = bound[0] if bound else "cuda"
    device = torch.device(device)
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
