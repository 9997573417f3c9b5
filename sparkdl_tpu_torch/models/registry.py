"""Model registry: name -> module constructor, input geometry, feature size,
preprocessing mode and weight converter.

Port of ``sparkdl_tpu.models.registry``: the six entries keep their
geometry, feature size and Keras preprocessing mode, and Xception its
``middle_width=768`` (a TPU lane choice of the JAX package; the port takes
728- and 768-wide trees alike, the narrow ones zero-padded). Each entry
carries a Flax variables tree to its module's ``state_dict``
(:meth:`KerasApplicationModel.state_dict_from_flax`). Building a Keras model
(``keras_model``, ``load_variables``) is not ported: the port never imports
Keras, and reads a caller's built model with
:func:`~sparkdl_tpu_torch.models.keras_port.port_keras_weights`.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from sparkdl_tpu_torch.models.convert import cnn_state_dict_from_flax
from sparkdl_tpu_torch.models.imagenet_labels import IMAGENET_CLASS_NAMES
from sparkdl_tpu_torch.models.inception_v3 import InceptionV3
from sparkdl_tpu_torch.models.keras_port import pad_variables_to_module
from sparkdl_tpu_torch.models.mobilenet_v2 import MobileNetV2
from sparkdl_tpu_torch.models.resnet import ResNet50
from sparkdl_tpu_torch.models.vgg import VGG16, VGG19
from sparkdl_tpu_torch.models.xception import Xception

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
        module_kwargs: Optional[Dict[str, Any]] = None,
        top_layers: Tuple[str, ...] = (),
    ):
        self.name = name
        self.module_cls = module_cls
        self.keras_name = keras_name
        self.input_size = input_size
        self.feature_size = feature_size
        self.preprocess_mode = preprocess_mode
        self.num_classes = num_classes
        self.module_kwargs = dict(module_kwargs or {})
        # the layers of the top other than predictions, which featurizing
        # needs (VGG's fc1 and fc2: its cut point is fc2)
        self.top_layers = top_layers

    def inputShape(self) -> Tuple[int, int]:
        return self.input_size

    def preprocess(self, x: torch.Tensor) -> torch.Tensor:
        return preprocess_input(x, self.preprocess_mode)

    def make_module(self, dtype: Optional[torch.dtype] = None) -> torch.nn.Module:
        """The entry's whole module, its ``predictions`` Dense included."""
        return self.module_cls(num_classes=self.num_classes, dtype=dtype,
                               **self.module_kwargs)

    def module_for(self, layers, num_classes: Optional[int],
                   dtype: Optional[torch.dtype] = None) -> torch.nn.Module:
        """The module that holds the top-level ``layers`` of a weights tree,
        its ``predictions`` Dense ``num_classes`` wide (the tree's), or none
        where that is ``None``; without VGG's fc1 and fc2 where the tree
        lacks them (it then cannot featurize, as in the JAX package). Build
        it under ``torch.device("meta")`` to read its layout for nothing."""
        layers = set(layers)
        return self.module_cls(
            num_classes=num_classes, dtype=dtype,
            include_top=all(name in layers for name in self.top_layers), **self.module_kwargs,
        )

    def state_dict_from_flax(self, variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
        """The entry's module's ``state_dict`` of Flax variables (those of
        the JAX module, or of a built Keras model through
        :func:`~sparkdl_tpu_torch.models.keras_port.port_keras_weights`): a
        tree at Keras's width pads to a wider module first (Xception
        728 -> 768). A missing key raises ``KeyError``, a leaf the module
        lacks ``ValueError``."""
        params = variables["params"]
        head = params.get("predictions")
        with torch.device("meta"):
            module = self.module_for(
                params, None if head is None else int(np.shape(head["kernel"])[-1]))
        return cnn_state_dict_from_flax(pad_variables_to_module(variables, module), module)

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
        # middle_width=768 as the JAX package's entry (a TPU lane choice
        # there); 728-wide trees pad up with the numbers unchanged
        KerasApplicationModel("Xception", Xception, "Xception",
                              (299, 299), 2048, "tf",
                              module_kwargs={"middle_width": 768}),
        KerasApplicationModel("ResNet50", ResNet50, "ResNet50",
                              (224, 224), 2048, "caffe"),
        KerasApplicationModel("VGG16", VGG16, "VGG16",
                              (224, 224), 4096, "caffe", top_layers=("fc1", "fc2")),
        KerasApplicationModel("VGG19", VGG19, "VGG19",
                              (224, 224), 4096, "caffe", top_layers=("fc1", "fc2")),
        KerasApplicationModel("MobileNetV2", MobileNetV2, "MobileNetV2",
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
