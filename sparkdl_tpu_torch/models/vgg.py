"""VGG16 / VGG19 in PyTorch.

Port of ``sparkdl_tpu.models.vgg``: the same Keras layer names
(``blockN_convM``, ``fc1``, ``fc2``, ``predictions``), 3x3 ``'SAME'`` convs
with bias and relu, 2x2 stride-2 max pools. The cut point is ``fc2`` after
its relu (4096-d): featurizing needs the top, and a module without it
raises ``ValueError`` as the Flax one does.

Flax flattens the last NHWC map in ``(h, w, c)`` order, so ``fc1``'s rows
follow that order: the port flattens ``x.permute(0, 2, 3, 1)`` (a view in
channels_last memory). ``fc1``'s width is fixed by the input size (25088 =
7 * 7 * 512 at 224x224): the module takes ``input_size``. Input is NCHW;
"caffe" preprocessing.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from sparkdl_tpu_torch.models.layers import Conv, Dense, head, max_pool

_FILTERS = (64, 128, 256, 512, 512)


class _VGG(nn.Module):
    blocks: Sequence[int]

    def __init__(self, num_classes: Optional[int] = 1000, include_top: bool = True,
                 dtype: Optional[torch.dtype] = None,
                 input_size: Tuple[int, int] = (224, 224)):
        super().__init__()
        self.num_classes = num_classes
        self.include_top = include_top
        self.dtype = dtype or torch.float32
        cin = 3
        for b, (n_convs, filters) in enumerate(zip(self.blocks, _FILTERS), start=1):
            for c in range(1, n_convs + 1):
                self.add_module(f"block{b}_conv{c}",
                                Conv(cin, filters, 3, 1, "SAME", use_bias=True))
                cin = filters
        h, w = input_size
        for _ in self.blocks:  # each 2x2 'VALID' pool floors the size
            h, w = h // 2, w // 2
        self.input_size = tuple(input_size)
        self.num_features = 4096
        if include_top:
            self.fc1 = Dense(h * w * cin, 4096)
            self.fc2 = Dense(4096, 4096)
        self.predictions = (Dense(4096, num_classes)
                            if include_top and num_classes else None)

    def forward(self, x: torch.Tensor, features_only: bool = False) -> torch.Tensor:
        x = x.to(self.dtype)
        for b, n_convs in enumerate(self.blocks, start=1):
            for c in range(1, n_convs + 1):
                x = F.relu(getattr(self, f"block{b}_conv{c}")(x))
            x = max_pool(x, 2, 2)
        if not self.include_top:
            if features_only:
                raise ValueError(
                    "VGG featurization (features_only=True) requires "
                    "include_top=True: the cut point is the fc2 output."
                )
            return x
        x = x.permute(0, 2, 3, 1).flatten(1)  # Flax's (h, w, c) order
        x = F.relu(self.fc1(x))
        x = F.relu(self.fc2(x))
        return head(self, x, features_only)


class VGG16(_VGG):
    blocks = (2, 2, 3, 3, 3)


class VGG19(_VGG):
    blocks = (2, 2, 4, 4, 4)
