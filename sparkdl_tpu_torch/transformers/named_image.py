"""DeepImageFeaturizer / DeepImagePredictor: named-CNN pipeline stages.

Port of ``sparkdl_tpu.transformers.named_image``. Each batch of image-struct
rows goes: stored-BGR uint8 (or float32) NHWC -> float32 -> bilinear resize
to the model's input size -> the BGR -> RGB flip -> Keras
``preprocess_input`` -> ``computeDtype`` -> the CNN in channels_last ->
float32, on ``device`` (the card unless ``"cpu"`` is set). In ``"tf"``
preprocessing the flip is folded into the stem conv's weights instead
(:func:`~sparkdl_tpu_torch.models.registry.fold_bgr_flip_into_stem`).

``modelWeights`` is one of:

- a Flax variables tree of the JAX module, carried across by the registry
  entry's converter
  (:meth:`~sparkdl_tpu_torch.models.registry.KerasApplicationModel.state_dict_from_flax`;
  a 728-wide Xception tree pads to the entry's 768-wide module), or a
  ``state_dict`` of the port's module;
- a caller's built Keras model, ported in numpy
  (:func:`~sparkdl_tpu_torch.models.keras_port.port_keras_weights`; Keras is
  never imported here), or the port's
  :class:`~sparkdl_tpu_torch.models.keras_model.KerasModel` of one, as a
  saved stage loads it back;
- ``"random"``, drawn from a ``torch.Generator`` (seed 0) with the
  distributions of Flax's initialisers: not the JAX package's numbers;
- ``"imagenet"`` (the default): the weights file that
  ``keras.applications.<Model>(weights="imagenet")`` with its top opens
  from Keras's cache, ``~/.keras/models/<its file name>``
  (:data:`IMAGENET_FILES`), read without Keras or ``h5py``
  (:func:`~sparkdl_tpu_torch.models.keras_model.read_legacy_weights`) and
  ported as a built Keras model is. Without that file it raises
  ``RuntimeError`` as the JAX package does (a ``_notop`` file is not it:
  the constructor with its top never opens one).

A tree or model is ported once per object (memoised by ``id``, holding the
object, as the JAX package's ``_PORTED_CACHE``), so repeated transforms
reuse one ``state_dict`` and so one cached module. The stages run their
modules eagerly, where the JAX package compiles them through its engine
(whether an AOT compile pays here is ROADMAP item D's question): a small
cache keeps the built module on its device from one transform to the next.
"""

from __future__ import annotations

import os
from typing import Any, Callable, Dict, Mapping, Optional

import numpy as np
import torch

from sparkdl_tpu_torch.ml.base import Transformer
from sparkdl_tpu_torch.ml.linalg import DenseVector
from sparkdl_tpu_torch.models.keras_model import KerasModel, read_legacy_weights
from sparkdl_tpu_torch.models.keras_port import (
    keras_layers_view,
    legacy_weights_view,
    port_keras_weights,
)
from sparkdl_tpu_torch.models.layers import CONV_TYPES, Conv
from sparkdl_tpu_torch.models.registry import (
    SUPPORTED_MODELS,
    decode_predictions,
    fold_bgr_flip_into_stem,
    get_keras_application_model,
)
from sparkdl_tpu_torch.param.base import Param, TypeConverters, keyword_only
from sparkdl_tpu_torch.param.shared import HasDevice, HasInputCol, HasOutputCol
from sparkdl_tpu_torch.sql.types import Row
from sparkdl_tpu_torch.transformers.utils import (
    DEFAULT_BATCH_SIZE,
    cast_and_resize_on_device,
    make_image_decode_plan,
    run_batched_rows,
)
from sparkdl_tpu_torch.utils.device import resolve_device
from sparkdl_tpu_torch.utils.lru import LRUCache

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}

# (modelName, "random") and (modelName, "imagenet", path, mtime) ->
# state_dict, shared across stages
_WEIGHTS_CACHE = LRUCache(4)

# (modelName, id(spec)) -> (spec, state_dict) for Flax trees and Keras
# models: the strong reference to spec keeps its id from being reused
_PORTED_CACHE = LRUCache(4)

# (modelName, dtype, featurize, id(weights), device) -> (forward, weights):
# keeps the module and its weights on the device from fit to transform;
# the strong reference to the weights keeps their id from being reused
_FORWARD_CACHE = LRUCache(8)

#: the imagenet weights file each ``keras.applications`` constructor opens
#: with its top (``include_top=True``, MobileNetV2 at alpha 1.0 and 224),
#: as Keras 3.13's ``keras/src/applications/*.py`` name them
IMAGENET_FILES = {
    "InceptionV3": "inception_v3_weights_tf_dim_ordering_tf_kernels.h5",
    "Xception": "xception_weights_tf_dim_ordering_tf_kernels.h5",
    "ResNet50": "resnet50_weights_tf_dim_ordering_tf_kernels.h5",
    "VGG16": "vgg16_weights_tf_dim_ordering_tf_kernels.h5",
    "VGG19": "vgg19_weights_tf_dim_ordering_tf_kernels.h5",
    "MobileNetV2": "mobilenet_v2_weights_tf_dim_ordering_tf_kernels_1.0_224.h5",
}


def imagenet_cache_file(model_name: str) -> Optional[str]:
    """The path of ``model_name``'s imagenet weights in Keras's cache
    (``~/.keras/models``), or None where that file is not there."""
    path = os.path.join(os.path.expanduser("~/.keras/models"), IMAGENET_FILES[model_name])
    return path if os.path.isfile(path) else None


def _truncated_normal(shape, gen: torch.Generator) -> torch.Tensor:
    """Standard normal draws truncated at two deviations: the draws outside
    are drawn again until none is (exact, and far quicker than the inverse
    error function of ``trunc_normal_`` on VGG's 1e8 weights)."""
    w = torch.randn(shape, generator=gen)
    flat = w.view(-1)
    outside = (flat.abs() > 2).nonzero().squeeze(1)
    while outside.numel():
        draw = torch.randn(outside.numel(), generator=gen)
        flat[outside] = draw
        outside = outside[draw.abs() > 2]
    return w


def random_state_dict(module: torch.nn.Module, seed: int = 0) -> Dict[str, torch.Tensor]:
    """A ``state_dict`` for ``module`` drawn from a ``torch.Generator``
    seeded with ``seed``, with the distributions of Flax's initialisers:
    conv and Dense weights lecun-normal (truncated at two deviations),
    biases and BN means zero, BN scales and variances one."""
    gen = torch.Generator().manual_seed(int(seed))
    state = {}
    for name, t in module.state_dict().items():
        leaf = name.rsplit(".", 1)[-1]
        if leaf in ("var", "scale"):
            state[name] = torch.ones_like(t)
        elif t.dim() == 1:
            state[name] = torch.zeros_like(t)
        else:
            # variance_scaling(1, fan_in, truncated_normal): the constant
            # undoes the truncation's shrinkage of the variance
            std = (1.0 / t[0].numel()) ** 0.5 / 0.87962566103423978
            state[name] = _truncated_normal(t.shape, gen).mul_(std)
    return state


def _ported(model_name: str, spec, port) -> Dict[str, torch.Tensor]:
    """``port(spec)``, once per ``spec`` object."""
    key = (model_name, id(spec))
    hit = _PORTED_CACHE.get(key)
    if hit is None or hit[0] is not spec:
        hit = (spec, port(spec))
        _PORTED_CACHE[key] = hit
    return hit[1]


def _resolve_weights(model_name: str, spec) -> Dict[str, torch.Tensor]:
    """``modelWeights`` -> the ``state_dict`` of the entry's module."""
    entry = get_keras_application_model(model_name)
    if spec is None or spec == "imagenet":
        path = imagenet_cache_file(model_name)
        if path is not None:
            key = (model_name, "imagenet", path, os.path.getmtime(path))
            state = _WEIGHTS_CACHE.get(key)
            if state is None:
                with torch.device("meta"):
                    module = entry.make_module()
                depthwise = {name for name, m in module.named_modules()
                             if isinstance(m, Conv) and m.groups > 1}
                view = legacy_weights_view(read_legacy_weights(path), depthwise)
                state = entry.state_dict_from_flax(port_keras_weights(view))
                _WEIGHTS_CACHE[key] = state
            return state
        raise RuntimeError(
            f"imagenet weights for {model_name} are unavailable (offline "
            "and no local Keras cache). Pass modelWeights= a built Keras "
            "model or a Flax variables tree, or opt in to "
            "modelWeights='random' for deterministic random initialization "
            "(testing/benchmarking only)."
        )
    if isinstance(spec, str) and spec == "random":
        key = (model_name, "random")
        state = _WEIGHTS_CACHE.get(key)
        if state is None:
            state = random_state_dict(entry.make_module())
            _WEIGHTS_CACHE[key] = state
        return state
    if isinstance(spec, Mapping):
        if "params" not in spec:  # a state_dict of the port's module
            return spec
        return _ported(model_name, spec, entry.state_dict_from_flax)
    if isinstance(spec, KerasModel):  # the port's, as a loaded stage holds it
        return _ported(model_name, spec, lambda m: entry.state_dict_from_flax(
            port_keras_weights(keras_layers_view(m.config, m.keras_weights()))))
    if hasattr(spec, "layers"):  # a built Keras model
        return _ported(model_name, spec,
                       lambda m: entry.state_dict_from_flax(port_keras_weights(m)))
    raise TypeError(
        f"modelWeights of type {type(spec).__name__}: expected 'imagenet', "
        "'random', a Flax variables tree, a state_dict or a built Keras model"
    )


def build_module(model_name: str, state: Dict[str, torch.Tensor],
                 dtype: torch.dtype, device) -> torch.nn.Module:
    """The named CNN as a stage runs it: the entry's module that holds
    exactly ``state``'s layers (headless where it has no ``predictions``;
    VGG keeps fc1 and fc2, its cut), made by :func:`load_module`."""
    entry = get_keras_application_model(model_name)
    with torch.device("meta"):  # the layout alone: the weights come from state
        head = state.get("predictions.weight")
        module = entry.module_for({k.split(".", 1)[0] for k in state},
                                  None if head is None else head.shape[0], dtype=dtype)
    return load_module(module, state, dtype, device)


def load_module(module: torch.nn.Module, state: Dict[str, torch.Tensor],
                dtype: torch.dtype, device) -> torch.nn.Module:
    """``module`` (on the meta device, or anywhere) with ``state`` loaded
    strictly, the conv and Dense weights held in ``dtype`` (the cast at each
    use is then a no-op; batch norm stays float32), on ``device`` in
    channels_last, in eval mode."""
    module.load_state_dict(state, strict=True, assign=True)
    for m in module.modules():
        if isinstance(m, CONV_TYPES + (torch.nn.Linear,)):
            m.to(dtype)
    return module.to(device=device, memory_format=torch.channels_last).eval()


def fused_forward(model_name: str, state: Dict[str, torch.Tensor], dtype: torch.dtype,
                  featurize: bool, device):
    """The fused forward of the named-CNN stages, as ``(module, body)``.

    ``body(x, run)`` takes an NHWC batch in stored (BGR) order at source
    size, uint8 or float32, casts it to float32, resizes it to the model's
    input size, flips it to RGB, applies the entry's ``preprocess_input``
    and calls ``run(x, features_only=featurize)`` on it in channels_last and
    ``dtype``; the result is float32. ``run`` is ``module``, the entry's
    module built from ``state`` on ``device``, or a function that calls it
    with other weights (the native export's
    ``torch.func.functional_call``). In ``"tf"`` preprocessing the flip is
    folded into the stem conv's weights (``module`` holds them) instead.
    :class:`DeepImageFeaturizer` runs this body and
    :func:`~sparkdl_tpu_torch.native.featurizer.export_featurizer` exports
    it, so both stacks run one function."""
    entry = get_keras_application_model(model_name)
    folded = fold_bgr_flip_into_stem(state, entry.preprocess_mode)
    flip_in_forward = folded is None
    module = build_module(model_name, state if folded is None else folded, dtype, device)
    size = entry.input_size
    preprocess = entry.preprocess

    def body(x: torch.Tensor, run: Callable) -> torch.Tensor:
        x = cast_and_resize_on_device(x, size)
        if flip_in_forward:
            x = x.flip(-1)  # BGR -> RGB
        x = preprocess(x)
        x = x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        return run(x.to(dtype), features_only=featurize).float()

    return module, body


class _NamedImageTransformer(Transformer, HasInputCol, HasOutputCol, HasDevice):
    """Shared machinery: resize -> preprocess -> CNN forward on the device."""

    modelName = Param(
        "undefined",
        "modelName",
        "A deep learning model name. Supported: %s" % (sorted(SUPPORTED_MODELS),),
        TypeConverters.toString,
    )
    modelWeights = Param(
        "undefined",
        "modelWeights",
        "'imagenet', a built Keras model, a Flax variables tree, or 'random' "
        "(explicit opt-in to deterministic random init)",
    )
    batchSize = Param(
        "undefined", "batchSize", "rows per device batch", TypeConverters.toInt
    )
    computeDtype = Param(
        "undefined",
        "computeDtype",
        "on-device compute dtype: 'bfloat16' or 'float32'",
        TypeConverters.toString,
    )

    _featurize: bool  # subclasses set

    def setModelName(self, value):
        return self._set(modelName=value)

    def getModelName(self):
        return self.getOrDefault(self.modelName)

    def _validate_model_name(self):
        name = self.getModelName()
        if name not in SUPPORTED_MODELS:
            raise ValueError(
                f"Unsupported model name {name!r}; supported: "
                f"{sorted(SUPPORTED_MODELS)}"
            )
        return name

    def _build_forward(self, device: torch.device):
        name = self._validate_model_name()
        dtype_name = self.getOrDefault(self.computeDtype)
        if dtype_name not in _DTYPES:
            raise ValueError(
                f"computeDtype must be one of {sorted(_DTYPES)}, got {dtype_name!r}"
            )
        dtype = _DTYPES[dtype_name]
        state = _resolve_weights(name, self.getOrDefault(self.modelWeights))
        key = (name, dtype_name, self._featurize, id(state), str(device))
        hit = _FORWARD_CACHE.get(key)
        if hit is not None:
            return hit[0]

        module, body = fused_forward(name, state, dtype, self._featurize, device)

        def forward(x: torch.Tensor) -> torch.Tensor:
            # x: uint8 or float32 NHWC in stored (BGR) order, at source size
            with torch.inference_mode():
                return body(x, module)

        _FORWARD_CACHE[key] = (forward, state)
        return forward

    def _transform(self, dataset):
        input_col = self.getInputCol()
        output_col = self.getOutputCol()
        batch_size = self.getOrDefault(self.batchSize)
        device = resolve_device(self.getDevice())
        forward = self._build_forward(device)
        size = get_keras_application_model(self.getModelName()).input_size

        def process_partition(part):
            rows = part[input_col]
            out = dict(part)
            if not rows:
                out[output_col] = []
                return out
            # the decode policy (uint8 at source size, or float32 resized
            # while packing) is decided over the whole partition
            decode = make_image_decode_plan(rows, size, device=device)
            result = run_batched_rows(forward, rows, decode, batch_size, device=device)
            out[output_col] = self._postprocess(result)
            return out

        return dataset.mapPartitions(process_partition)


class DeepImageFeaturizer(_NamedImageTransformer):
    """The penultimate-layer features of a named CNN, for transfer
    learning."""

    _featurize = True

    @keyword_only
    def __init__(
        self,
        inputCol: Optional[str] = None,
        outputCol: Optional[str] = None,
        modelName: Optional[str] = None,
        modelWeights: Any = None,
        batchSize: int = DEFAULT_BATCH_SIZE,
        computeDtype: str = "bfloat16",
        device: Optional[str] = None,
    ):
        super().__init__()
        self._setDefault(
            modelWeights=None,
            batchSize=DEFAULT_BATCH_SIZE,
            computeDtype="bfloat16",
            device=None,
        )
        kwargs = self._input_kwargs
        self.setParams(**kwargs)

    @keyword_only
    def setParams(
        self,
        inputCol: Optional[str] = None,
        outputCol: Optional[str] = None,
        modelName: Optional[str] = None,
        modelWeights: Any = None,
        batchSize: int = DEFAULT_BATCH_SIZE,
        computeDtype: str = "bfloat16",
        device: Optional[str] = None,
    ):
        kwargs = self._input_kwargs
        return self._set(**kwargs)

    def _postprocess(self, result: np.ndarray):
        return [DenseVector(v) for v in result.astype(np.float64)]


class DeepImagePredictor(_NamedImageTransformer):
    """A named CNN classifier; optionally decodes the top-K ImageNet
    predictions."""

    _featurize = False

    decodePredictions = Param(
        "undefined",
        "decodePredictions",
        "If true, output (class, description, probability) top-K tuples "
        "instead of the raw prediction vector",
        TypeConverters.toBoolean,
    )
    topK = Param(
        "undefined",
        "topK",
        "number of predictions to keep when decodePredictions is true",
        TypeConverters.toInt,
    )

    @keyword_only
    def __init__(
        self,
        inputCol: Optional[str] = None,
        outputCol: Optional[str] = None,
        modelName: Optional[str] = None,
        modelWeights: Any = None,
        decodePredictions: bool = False,
        topK: int = 5,
        batchSize: int = DEFAULT_BATCH_SIZE,
        computeDtype: str = "bfloat16",
        device: Optional[str] = None,
    ):
        super().__init__()
        self._setDefault(
            modelWeights=None,
            decodePredictions=False,
            topK=5,
            batchSize=DEFAULT_BATCH_SIZE,
            computeDtype="bfloat16",
            device=None,
        )
        kwargs = self._input_kwargs
        self.setParams(**kwargs)

    @keyword_only
    def setParams(
        self,
        inputCol: Optional[str] = None,
        outputCol: Optional[str] = None,
        modelName: Optional[str] = None,
        modelWeights: Any = None,
        decodePredictions: bool = False,
        topK: int = 5,
        batchSize: int = DEFAULT_BATCH_SIZE,
        computeDtype: str = "bfloat16",
        device: Optional[str] = None,
    ):
        kwargs = self._input_kwargs
        return self._set(**kwargs)

    def _postprocess(self, result: np.ndarray):
        # softmax over the logits (the Keras top layer's activation)
        z = result - result.max(axis=1, keepdims=True)
        probs = np.exp(z)
        probs /= probs.sum(axis=1, keepdims=True)
        if not self.getOrDefault(self.decodePredictions):
            return [DenseVector(p) for p in probs.astype(np.float64)]
        decoded = decode_predictions(probs, top=self.getOrDefault(self.topK))
        return [
            [
                Row(**{"class": wnid, "description": label, "probability": p})
                for wnid, label, p in entries
            ]
            for entries in decoded
        ]
