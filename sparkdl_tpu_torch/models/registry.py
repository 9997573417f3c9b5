"""Model registry: name -> module constructor, input geometry, feature size
and preprocessing mode.

Port of ``sparkdl_tpu.models.registry``. All six entries keep their
geometry, feature size and Keras preprocessing mode; :meth:`make_module`
builds InceptionV3 and raises ``NotImplementedError`` for the other five,
which are not ported yet (ROADMAP item 5). Keras weight porting
(``keras_model``, ``load_variables``) is not ported either: the port takes
Flax variables trees through :mod:`sparkdl_tpu_torch.models.convert`.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from sparkdl_tpu_torch.models.imagenet_labels import IMAGENET_CLASS_NAMES
from sparkdl_tpu_torch.models.inception_v3 import InceptionV3

_CAFFE_MEAN_BGR = (103.939, 116.779, 123.68)
_TORCH_MEAN = (0.485, 0.456, 0.406)
_TORCH_STD = (0.229, 0.224, 0.225)


def preprocess_input(x: torch.Tensor, mode: str) -> torch.Tensor:
    """Keras ``preprocess_input``: ``x`` is float RGB in [0, 255], NHWC."""
    if mode == "tf":
        return x / 127.5 - 1.0
    if mode == "caffe":
        x = x.flip(-1)  # RGB -> BGR
        return x - torch.tensor(_CAFFE_MEAN_BGR, dtype=x.dtype, device=x.device)
    if mode == "torch":
        x = x / 255.0
        mean = torch.tensor(_TORCH_MEAN, dtype=x.dtype, device=x.device)
        std = torch.tensor(_TORCH_STD, dtype=x.dtype, device=x.device)
        return (x - mean) / std
    raise ValueError(f"Unknown preprocessing mode: {mode!r}")


class KerasApplicationModel:
    """One registry entry: what the transformers need to run a named CNN."""

    def __init__(
        self,
        name: str,
        module_cls,
        keras_name: str,
        input_size: Tuple[int, int],
        feature_size: int,
        preprocess_mode: str,
        num_classes: int = 1000,
    ):
        self.name = name
        self.module_cls = module_cls
        self.keras_name = keras_name
        self.input_size = input_size
        self.feature_size = feature_size
        self.preprocess_mode = preprocess_mode
        self.num_classes = num_classes

    def inputShape(self) -> Tuple[int, int]:
        return self.input_size

    def preprocess(self, x: torch.Tensor) -> torch.Tensor:
        return preprocess_input(x, self.preprocess_mode)

    def make_module(self, dtype: Optional[torch.dtype] = None,
                    include_top: bool = True) -> torch.nn.Module:
        if self.module_cls is None:
            raise NotImplementedError(
                f"{self.name} is not ported to PyTorch yet (ROADMAP item 5); "
                "the port builds InceptionV3"
            )
        return self.module_cls(num_classes=self.num_classes,
                               include_top=include_top, dtype=dtype)

    def __repr__(self):
        return (
            f"KerasApplicationModel({self.name}, input={self.input_size}, "
            f"features={self.feature_size}, mode={self.preprocess_mode!r})"
        )


KERAS_APPLICATION_MODELS: Dict[str, KerasApplicationModel] = {
    m.name: m
    for m in [
        KerasApplicationModel("InceptionV3", InceptionV3, "InceptionV3",
                              (299, 299), 2048, "tf"),
        KerasApplicationModel("Xception", None, "Xception",
                              (299, 299), 2048, "tf"),
        KerasApplicationModel("ResNet50", None, "ResNet50",
                              (224, 224), 2048, "caffe"),
        KerasApplicationModel("VGG16", None, "VGG16",
                              (224, 224), 4096, "caffe"),
        KerasApplicationModel("VGG19", None, "VGG19",
                              (224, 224), 4096, "caffe"),
        KerasApplicationModel("MobileNetV2", None, "MobileNetV2",
                              (224, 224), 1280, "tf"),
    ]
}

SUPPORTED_MODELS = tuple(KERAS_APPLICATION_MODELS)


def get_keras_application_model(name: str) -> KerasApplicationModel:
    if name not in KERAS_APPLICATION_MODELS:
        raise ValueError(
            f"Unsupported model: {name!r}. Supported: {sorted(SUPPORTED_MODELS)}"
        )
    return KERAS_APPLICATION_MODELS[name]


def fold_bgr_flip_into_stem(
    state: Mapping[str, torch.Tensor], preprocess_mode: str
) -> Optional[Dict[str, torch.Tensor]]:
    """Fold the BGR->RGB input flip into the stem conv's weights.

    Under channel-symmetric preprocessing (``"tf"`` mode: the same affine
    on every channel) reversing the input-channel axis of the first conv's
    OIHW weight (axis 1) is the same as flipping the input. Any other mode
    returns ``None``, as does a ``state_dict`` without exactly one 4-d
    3-input-channel weight: the caller then keeps the flip in its forward.
    Returns a new ``state_dict``; ``state`` is not changed.
    """
    if preprocess_mode != "tf":
        return None
    hits = [k for k, v in state.items()
            if k.endswith("weight") and v.dim() == 4 and v.shape[1] == 3]
    if len(hits) != 1:
        return None
    folded = dict(state)
    folded[hits[0]] = state[hits[0]].flip(1)
    return folded


def decode_predictions(preds, top: int = 5):
    """``imagenet_utils.decode_predictions``: the ``top`` classes of each
    row of ``preds`` (logits or probabilities, (batch, classes)) as
    ``(wnid, label, score)``. Keras's cached ``imagenet_class_index.json``
    gives real wnids where present; else the vendored names with
    ``n{index:08d}`` placeholders, and ``class_{i}`` outside 1000 classes."""
    preds = np.asarray(preds)
    class_index = None
    path = os.path.expanduser("~/.keras/models/imagenet_class_index.json")
    if os.path.exists(path):
        with open(path) as fh:
            class_index = json.load(fh)
    results = []
    for row in preds:
        entries = []
        is_imagenet_shaped = row.shape[-1] == 1000
        for i in row.argsort()[-top:][::-1]:
            i = int(i)
            if class_index is not None and is_imagenet_shaped:
                wnid, label = class_index[str(i)]
            elif is_imagenet_shaped and i < len(IMAGENET_CLASS_NAMES):
                wnid, label = f"n{i:08d}", IMAGENET_CLASS_NAMES[i]
            else:
                wnid, label = f"n{i:08d}", f"class_{i}"
            entries.append((wnid, label, float(row[i])))
        results.append(entries)
    return results
