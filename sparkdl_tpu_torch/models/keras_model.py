"""Keras 3 models built as torch modules, from a ``.keras`` or ``.h5`` file
or a built model, without Keras.

The torch counterpart of what ``keras.models.load_model`` and
``model.stateless_call`` do for ``sparkdl_tpu.graph.function``'s
``XlaFunction.from_keras``:

- :func:`read_keras_file` reads a file's architecture and weights with
  :mod:`sparkdl_tpu_torch.utils.hdf5`: a ``.keras`` zip (``config.json`` and
  ``model.weights.h5``, whose variables sit at ``layers/<class>/vars/<i>``)
  or a legacy ``.h5`` (the ``model_config`` attribute, the weights under
  ``model_weights`` in the order of each layer's ``weight_names``; an
  attribute Keras split in chunks, ``layer_names0``, ``layer_names1``, ...,
  is joined again);
- :func:`read_keras_model` reads a built model duck-typed, as
  :mod:`~sparkdl_tpu_torch.models.keras_port` does: ``model.get_config()``
  and each layer's ``get_weights()``;
- :class:`KerasModel` runs the config's graph in topological order:
  Sequential and Functional models in the node format Keras 3 writes
  (``inbound_nodes`` of ``__keras_tensor__`` args with ``keras_history``).
  A model may hold one level of nested models (``Sequential([ResNet50(...),
  Dense(5)])``, the usual fine-tune idiom): a nested model's weights are a
  mapping of its own layers' names to their arrays;
- :func:`write_keras_file` writes a ``.keras`` file of a config and its
  weights (with :func:`sparkdl_tpu_torch.utils.hdf5.write`), so a machine
  without Keras can make one; :meth:`KerasModel.keras_weights` gives a
  module's current weights in that form;
- :func:`read_legacy_weights` reads a weights-only legacy ``.h5`` (what
  ``keras.applications`` caches under ``~/.keras/models``, or Keras's
  legacy ``save_weights``): root ``layer_names``, each layer's
  ``weight_names``, the arrays at ``<layer>/<weight name>`` and no
  ``model_config``; :func:`write_legacy_weights` writes one.

Training follows Keras's ``stateless_call(..., training=True)``: under
``module.train()`` a ``BatchNormalization`` layer normalises by the batch's
float32 mean and biased variance and moves its moving statistics by its
``momentum``, and ``Dropout`` draws its mask from the caller's
``torch.Generator``. A layer's weights take gradients only where its
``trainable`` flag, and every enclosing model's, is true; a frozen batch
norm stays on its moving statistics in training, as in Keras.

Layout: Keras is NHWC; every 4-D tensor here is held NCHW in channels_last
memory, as the port's CNNs run, permuted once at the input and back at a
4-D output. Keras axis ``-1`` of a 4-D tensor (``BatchNormalization``,
``Concatenate``, ``Softmax``, ``Dense``) is then dim 1, and ``Flatten`` and
``Reshape`` go through NHWC so that the weights after them see Keras's order.

Each layer computes in its dtype policy's compute type (a ``mixed_bfloat16``
layer casts its floating inputs to bf16, its float32 weights at each use),
batch norm in float32 as Keras does under a mixed policy. Layer classes:
InputLayer, Conv2D, DepthwiseConv2D, SeparableConv2D, BatchNormalization,
Dense, Activation, ReLU, Softmax, Add, Concatenate, Flatten, Reshape,
Rescaling, Dropout (identity at inference), ZeroPadding2D, MaxPooling2D,
AveragePooling2D and GlobalAveragePooling2D; activations ``linear``,
``relu``, ``relu6``, ``sigmoid``, ``softmax``, ``tanh``, ``swish`` /
``silu``, ``gelu``, ``elu``, ``softplus`` and ``hard_sigmoid``. Another
class, a model nested two deep, ``channels_first`` data or Keras 2's node
format raises ``NotImplementedError``.
"""

from __future__ import annotations

import copy
import json
import os
import re
import time
import zipfile
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from sparkdl_tpu_torch.models.layers import (
    BatchNorm,
    Conv,
    Dense,
    avg_pool,
    conv2d,
    global_avg_pool,
    max_pool,
)
from sparkdl_tpu_torch.utils import hdf5

# layer name -> its arrays in Keras's variable order; a nested model's name
# -> the same mapping of its own layers
Weights = Dict[str, Union[List[np.ndarray], "Weights"]]

_MODEL_CLASSES = ("Functional", "Sequential")
# the Keras whose file format write_keras_file follows, as metadata.json records it
_KERAS_VERSION = "3.13.1"
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16, "float64": torch.float64}
# each layer's variables in Keras's order, by their names in a legacy .h5
# (a nested model's weight_names list them trainable first, not layer by layer)
_VARIABLE_ORDER = ("kernel", "depthwise_kernel", "pointwise_kernel", "bias",
                   "gamma", "beta", "moving_mean", "moving_variance")


# ----------------------------------------------------------------------
# reading
# ----------------------------------------------------------------------

def read_keras_file(path) -> Tuple[Dict[str, Any], Weights]:
    """A Keras file's config (``{"class_name": ..., "config": ...}``) and
    its weights, layer name -> arrays in the layer's variable order (a
    nested model's name -> its layers' weights)."""
    path = os.fspath(path)
    if zipfile.is_zipfile(path):
        with zipfile.ZipFile(path) as archive:
            config = json.loads(archive.read("config.json"))
            weights_file = hdf5.File(archive.read("model.weights.h5"))
        return config, _read_variables(weights_file, _variable_paths(config))
    weights_file = hdf5.File(path)
    if "model_config" not in weights_file.attrs:
        raise ValueError(f"{path}: neither a .keras zip nor an HDF5 file with a "
                         "model_config attribute (a weights-only file reads with "
                         "read_legacy_weights)")
    config = json.loads(weights_file.attrs["model_config"])
    root = weights_file["model_weights"] if "model_weights" in weights_file else weights_file
    models = {layer["config"]["name"] for layer in config["config"].get("layers", ())
              if layer["class_name"] in _MODEL_CLASSES}
    weights: Weights = {}
    for name in _chunked_attribute(root, "layer_names"):
        group = root[name]
        names = _chunked_attribute(group, "weight_names")
        if name in models:
            weights[name] = _nested_h5_weights(group, names)
        else:
            weights[name] = [group[w].read() for w in names]
    return config, weights


LegacyWeights = List[Tuple[str, List[Tuple[str, np.ndarray]]]]


def read_legacy_weights(path) -> LegacyWeights:
    """A weights-only legacy ``.h5``: per layer of its ``layer_names``, in
    order, the (weight name, array) pairs of its ``weight_names``, in
    order (an empty list for a layer without weights). A full legacy
    ``.h5`` model (``model_config`` and a ``model_weights`` group) reads
    from that group, as Keras's ``load_weights`` does."""
    root = hdf5.File(os.fspath(path))
    if ("layer_names" not in root.attrs and "layer_names0" not in root.attrs
            and "model_weights" in root):
        root = root["model_weights"]
    layers: LegacyWeights = []
    for name in _chunked_attribute(root, "layer_names"):
        group = root[name]
        names = _chunked_attribute(group, "weight_names")
        layers.append((name, [(w, group[w].read()) for w in names]))
    return layers


def _legacy_variable_names(layer: Mapping[str, Any], count: int) -> List[str]:
    """The variable names of a layer of the config, in Keras's order, as a
    legacy ``.h5`` names its weights."""
    cls, cfg = layer["class_name"], layer["config"]
    if cls == "BatchNormalization":
        names = [v for v, on in (("gamma", cfg.get("scale", True)),
                                 ("beta", cfg.get("center", True))) if on]
        names += ["moving_mean", "moving_variance"]
    else:
        names = {"Conv2D": ["kernel", "bias"], "Dense": ["kernel", "bias"],
                 "DepthwiseConv2D": ["depthwise_kernel", "bias"],
                 "SeparableConv2D": ["depthwise_kernel", "pointwise_kernel", "bias"],
                 }.get(cls, [])[:count]
    if len(names) != count:
        raise NotImplementedError(f"layer {cfg['name']!r} of class {cls} with {count} "
                                  "weights in a legacy weights file")
    return names


def write_legacy_weights(path, config: Mapping[str, Any], weights: Mapping[str, Any]) -> None:
    """Write the weights of a config (one without nested models) as the
    weights-only legacy ``.h5`` Keras's ``save_weights_to_hdf5_group``
    writes: root ``layer_names`` (every layer, in the config's order),
    each layer's group with its ``weight_names`` (``<layer>/<variable>``)
    and the arrays under them."""
    layers = config["config"]["layers"]
    tree: Dict[str, Any] = {}
    attrs: Dict[str, Dict[str, Any]] = {"": {
        "layer_names": [layer["config"]["name"] for layer in layers],
        "backend": "torch", "keras_version": _KERAS_VERSION}}
    for layer in layers:
        name = layer["config"]["name"]
        if layer["class_name"] in _MODEL_CLASSES:
            raise NotImplementedError(f"nested model {name!r} in a legacy weights file")
        arrays = [np.asarray(a) for a in weights.get(name, ())]
        variables = _legacy_variable_names(layer, len(arrays))
        tree[name] = {name: dict(zip(variables, arrays))} if arrays else {}
        attrs[name] = {"weight_names": [f"{name}/{v}" for v in variables]}
    hdf5.write(path, tree, attrs)


def _chunked_attribute(group, name: str) -> List[str]:
    """A list attribute of a legacy ``.h5``, as Keras's
    ``load_attributes_from_hdf5_group`` reads it: ``name`` itself, or else
    the chunks ``name0``, ``name1``, ... joined in order (Keras splits an
    attribute larger than HDF5's 64 KB object header)."""
    attrs = group.attrs
    if name in attrs:
        chunks = [attrs[name]]
    else:
        chunks = []
        while f"{name}{len(chunks)}" in attrs:
            chunks.append(attrs[f"{name}{len(chunks)}"])
        if not chunks:
            raise KeyError(f"no attribute {name!r} (nor {name}0, {name}1, ...) on "
                           f"{group.name!r}")
    return [n.decode("utf8") if isinstance(n, bytes) else str(n)
            for chunk in chunks for n in np.atleast_1d(chunk)]


def _nested_h5_weights(group, names: Sequence[str]) -> Weights:
    """A nested model's weights in a legacy ``.h5``: its ``weight_names``
    are ``[<model>/]<inner layer>/<variable>``, trainable ones first, so
    they are mapped by name, each layer's variables in Keras's order."""
    by_layer: Dict[str, Dict[str, np.ndarray]] = {}
    for w in names:
        parts = w.split("/")
        if len(parts) < 2 or parts[-1] not in _VARIABLE_ORDER:
            raise NotImplementedError(f"nested weight {w!r} in {group.name!r}")
        by_layer.setdefault(parts[-2], {})[parts[-1]] = group[w].read()
    return {layer: [variables[v] for v in _VARIABLE_ORDER if v in variables]
            for layer, variables in by_layer.items()}


def _read_variables(store, paths: Mapping[str, Any]) -> Weights:
    weights: Weights = {}
    for name, path in paths.items():
        if isinstance(path, Mapping):
            weights[name] = _read_variables(store, path)
        elif path in store:
            group = store[path]
            weights[name] = [group[k].read() for k in sorted(group.keys(), key=int)]
    return weights


def _snake_case(name: str) -> str:
    """``keras.src.utils.naming.to_snake_case``."""
    name = re.sub(r"\W+", "", name)
    name = re.sub("(.)([A-Z][a-z]+)", r"\1_\2", name)
    return re.sub("([a-z])([A-Z])", r"\1_\2", name).lower()


def _variable_paths(config: Mapping[str, Any], prefix: str = "") -> Dict[str, Any]:
    """Layer name -> the group of its variables in a ``.keras`` weights
    file (a nested model's name -> the same mapping of its layers). Keras
    names a model's layers there by class, not by name (so that two builds
    of one model match): ``layers/<snake_case class>``, then ``_1``, ``_2``,
    ... for the next of a class, in the order of ``model.layers`` (which
    leaves out a Sequential model's InputLayer); a nested model's layers sit
    under its own group (``layers/functional/layers/...``)."""
    layers = list(config["config"].get("layers", ()))
    if config.get("class_name") == "Sequential" and layers \
            and layers[0]["class_name"] == "InputLayer":
        layers = layers[1:]
    used: Dict[str, int] = {}
    paths: Dict[str, Any] = {}
    for layer in layers:
        base = _snake_case(layer["class_name"])
        count = used[base] = used.get(base, -1) + 1
        group = f"{prefix}layers/{base}" + (f"_{count}" if count else "")
        if layer["class_name"] in _MODEL_CLASSES:
            paths[layer["config"]["name"]] = _variable_paths(layer, group + "/")
        else:
            paths[layer["config"]["name"]] = group + "/vars"
    return paths


def read_keras_model(model) -> Tuple[Dict[str, Any], Weights]:
    """A built Keras model's config and weights, read duck-typed
    (``get_config()``, ``layers``, each layer's ``name`` and
    ``get_weights()``, a nested model's layers in turn); Keras is never
    imported."""
    if not hasattr(model, "get_config") or not hasattr(model, "layers"):
        raise TypeError(f"expected a built Keras model, got {type(model).__name__}")
    config = {"class_name": type(model).__name__, "config": model.get_config()}
    weights: Weights = {}
    for layer in model.layers:
        if type(layer).__name__ in _MODEL_CLASSES:
            weights[layer.name] = read_keras_model(layer)[1]
        else:
            weights[layer.name] = [np.asarray(w) for w in layer.get_weights()]
    return config, weights


# ----------------------------------------------------------------------
# layout helpers: a 4-D tensor is held NCHW for Keras's NHWC
# ----------------------------------------------------------------------

def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1) if x.dim() == 4 else x


def _from_nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2) if x.dim() == 4 else x


def _dim(x: torch.Tensor, axis: int) -> int:
    """Keras axis ``axis`` of the tensor ``x`` holds."""
    axis = axis % x.dim()
    return (0, 2, 3, 1)[axis] if x.dim() == 4 else axis


def _pair(v) -> Tuple[int, int]:
    return (int(v), int(v)) if isinstance(v, (int, float)) else (int(v[0]), int(v[1]))


# ----------------------------------------------------------------------
# activations, as Keras 3 defines them
# ----------------------------------------------------------------------

def _relu(x, negative_slope=0.0, max_value=None, threshold=0.0):
    """``keras.activations.relu``, in the same steps."""
    negative = 1
    if negative_slope != 0.0:
        if max_value is None and threshold == 0:
            return F.leaky_relu(x, negative_slope)
        negative = torch.relu(threshold - x)
    clip = max_value is not None
    if threshold != 0:
        x = x * (x > threshold).to(x.dtype)
    elif max_value == 6:
        x, clip = F.relu6(x), False
    else:
        x = torch.relu(x)
    if clip:
        x = x.clamp(0.0, float(max_value))
    if negative_slope != 0.0:
        x = x - negative_slope * negative
    return x


def _softmax(x: torch.Tensor, axis=-1) -> torch.Tensor:
    axes = axis if isinstance(axis, (list, tuple)) else [axis]
    if len(axes) == 1:
        return torch.softmax(x, dim=_dim(x, axes[0]))
    dims = [_dim(x, a) for a in axes]
    return torch.exp(x - torch.logsumexp(x, dim=dims, keepdim=True))


_ACTIVATIONS: Dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "linear": lambda x: x,
    "relu": _relu,
    "relu6": F.relu6,
    "sigmoid": torch.sigmoid,
    "softmax": _softmax,
    "tanh": torch.tanh,
    "swish": F.silu,
    "silu": F.silu,
    # keras.activations.gelu's default: the exact (erf) form
    "gelu": F.gelu,
    "elu": F.elu,
    # log(1 + exp(x)), with no linear cut-over as torch's default has
    "softplus": lambda x: torch.logaddexp(x, torch.zeros_like(x)),
    "hard_sigmoid": lambda x: F.relu6(x + 3.0) / 6.0,
}


def _activation(spec, layer: str) -> Callable[[torch.Tensor], torch.Tensor]:
    if spec is None:
        return _ACTIVATIONS["linear"]
    if isinstance(spec, str) and spec in _ACTIVATIONS:
        return _ACTIVATIONS[spec]
    raise NotImplementedError(f"activation {spec!r} of layer {layer!r} is not supported")


def policy_dtype(spec) -> torch.dtype:
    """The compute type of a serialized Keras dtype policy: ``"float32"``,
    ``"mixed_bfloat16"`` or ``{"class_name": "DTypePolicy", "config":
    {"name": ...}}``; float32 when absent."""
    if isinstance(spec, Mapping):
        spec = spec.get("config", {}).get("name")
    if spec is None:
        return torch.float32
    name = str(spec).removeprefix("mixed_")
    if name not in _DTYPES:
        raise NotImplementedError(f"Keras dtype policy {spec!r} is not supported")
    return _DTYPES[name]


# ----------------------------------------------------------------------
# layers
# ----------------------------------------------------------------------

class _Layer(nn.Module):
    """One Keras layer: ``call(*args)`` over its node's inputs (a tensor,
    or a list of them for the merge layers) in its compute type;
    ``keras_weights()`` its current weights as Keras holds them.
    ``trainable`` is the layer's effective flag (its own and every
    enclosing model's), set by the model that builds it."""

    n_weights: Tuple[int, ...] = (0,)
    trainable = True

    def __init__(self, cfg: Mapping[str, Any], weights: List[np.ndarray], dtype: torch.dtype):
        super().__init__()
        self.layer_name = cfg["name"]
        self.dtype = dtype
        if cfg.get("data_format", "channels_last") != "channels_last":
            raise NotImplementedError(
                f"layer {self.layer_name!r}: data_format {cfg['data_format']!r}")
        if len(weights) not in self.n_weights:
            raise ValueError(f"layer {self.layer_name!r} ({type(self).__name__[1:]}) has "
                             f"{len(weights)} weights; expected {self.n_weights}")

    def cast(self, x):
        if isinstance(x, (list, tuple)):
            return [self.cast(t) for t in x]
        # tested here, not by a no-op x.to(): a launch-bound forward pays
        # for every call into the dispatcher
        if x.is_floating_point() and x.dtype != self.dtype:
            return x.to(self.dtype)
        return x

    def call(self, x):
        raise NotImplementedError

    def keras_weights(self) -> List[np.ndarray]:
        return []


def _array(t: torch.Tensor) -> np.ndarray:
    """A tensor's values as a contiguous array on the host."""
    return np.ascontiguousarray(t.detach().cpu().numpy())


def _keras_kernel(oihw: torch.Tensor) -> np.ndarray:
    """An OIHW kernel in Keras's ``(kh, kw, cin, cout)``."""
    return _array(oihw.permute(2, 3, 1, 0))


def _keras_depthwise(kernel: torch.Tensor, mult: int) -> np.ndarray:
    """The inverse of :func:`_depthwise_oihw`."""
    cout, _, kh, kw = kernel.shape
    return _array(kernel.reshape(cout // mult, mult, kh, kw).permute(2, 3, 0, 1))


def _tensor(array: np.ndarray) -> torch.Tensor:
    """A float32 copy of ``array`` in its own contiguous memory (file
    buffers are read-only views, and kernels come transposed)."""
    return torch.from_numpy(np.array(array, dtype=np.float32, order="C"))


def _param(array: np.ndarray) -> nn.Parameter:
    return nn.Parameter(_tensor(array), requires_grad=False)


def _kernel(oihw: np.ndarray) -> nn.Parameter:
    """A convolution kernel in channels_last memory, the layout of the
    activations it meets: a contiguous NCHW kernel would be converted at
    every call (and its bf16 cast with it)."""
    return nn.Parameter(_tensor(oihw).contiguous(memory_format=torch.channels_last),
                        requires_grad=False)


class _InputLayer(_Layer):
    def __init__(self, cfg, weights, dtype):
        super().__init__(cfg, weights, policy_dtype(cfg.get("dtype")))
        shape = cfg.get("batch_shape", cfg.get("batch_input_shape"))
        self.batch_shape = None if shape is None else tuple(shape)

    def call(self, x):
        return self.cast(x)


def _depthwise_oihw(kernel: np.ndarray) -> np.ndarray:
    """Keras ``(kh, kw, cin, mult)`` -> ``(cin * mult, 1, kh, kw)``: output
    channel ``c * mult + m``, as Keras orders it."""
    kh, kw, cin, mult = kernel.shape
    return kernel.transpose(2, 3, 0, 1).reshape(cin * mult, 1, kh, kw)


class _Conv2D(_Layer):
    n_weights = (1, 2)

    def __init__(self, cfg, weights, dtype):
        super().__init__(cfg, weights, dtype)
        if cfg.get("use_bias", True) != (len(weights) == 2):
            raise ValueError(f"layer {self.layer_name!r}: use_bias and its weights disagree")
        kernel = weights[0]
        groups = int(cfg.get("groups", 1))
        self.conv = Conv(kernel.shape[2] * groups, kernel.shape[3], kernel.shape[:2],
                         _pair(cfg.get("strides", 1)), cfg.get("padding", "valid").upper(),
                         use_bias=len(weights) == 2, groups=groups,
                         dilation=_pair(cfg.get("dilation_rate", 1)))
        self.conv.weight = _kernel(kernel.transpose(3, 2, 0, 1))
        if len(weights) == 2:
            self.conv.bias = _param(weights[1])
        self.activation = _activation(cfg.get("activation"), self.layer_name)

    def call(self, x):
        return self.activation(self.conv(self.cast(x)))

    def keras_weights(self):
        bias = [] if self.conv.bias is None else [_array(self.conv.bias)]
        return [_keras_kernel(self.conv.weight)] + bias


class _DepthwiseConv2D(_Layer):
    n_weights = (1, 2)

    def __init__(self, cfg, weights, dtype):
        super().__init__(cfg, weights, dtype)
        kernel = weights[0]
        cin = kernel.shape[2]
        self.conv = Conv(cin, cin * kernel.shape[3], kernel.shape[:2],
                         _pair(cfg.get("strides", 1)), cfg.get("padding", "valid").upper(),
                         use_bias=len(weights) == 2, groups=cin,
                         dilation=_pair(cfg.get("dilation_rate", 1)))
        self.conv.weight = _kernel(_depthwise_oihw(kernel))
        if len(weights) == 2:
            self.conv.bias = _param(weights[1])
        self.multiplier = kernel.shape[3]
        self.activation = _activation(cfg.get("activation"), self.layer_name)

    def call(self, x):
        return self.activation(self.conv(self.cast(x)))

    def keras_weights(self):
        bias = [] if self.conv.bias is None else [_array(self.conv.bias)]
        return [_keras_depthwise(self.conv.weight, self.multiplier)] + bias


class _SeparableConv2D(_Layer):
    """The depthwise convolution (strides, padding, dilation), then the 1x1
    pointwise one, then the bias, as Keras's ``separable_conv``."""

    n_weights = (2, 3)

    def __init__(self, cfg, weights, dtype):
        super().__init__(cfg, weights, dtype)
        self.depthwise_kernel = _kernel(_depthwise_oihw(weights[0]))
        self.pointwise_kernel = _kernel(weights[1].transpose(3, 2, 0, 1))
        self.bias = _param(weights[2]) if len(weights) == 3 else None
        self.multiplier = weights[0].shape[3]
        self.strides = _pair(cfg.get("strides", 1))
        self.padding = cfg.get("padding", "valid").upper()
        self.dilation = _pair(cfg.get("dilation_rate", 1))
        self.activation = _activation(cfg.get("activation"), self.layer_name)

    def call(self, x):
        x = self.cast(x)
        x = conv2d(x, self.depthwise_kernel.to(x.dtype), self.strides, self.padding,
                   groups=x.shape[1], dilation=self.dilation)
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return self.activation(F.conv2d(x, self.pointwise_kernel.to(x.dtype), bias))

    def keras_weights(self):
        bias = [] if self.bias is None else [_array(self.bias)]
        return [_keras_depthwise(self.depthwise_kernel, self.multiplier),
                _keras_kernel(self.pointwise_kernel)] + bias


class _BatchNormalization(_Layer):
    """Keras's batch norm on one axis (its config's ``axis``), in float32
    and rounded once to the input's type. At inference (or frozen) it
    normalises by the moving statistics; under ``train()`` it takes Keras's
    training branch (:meth:`_train`)."""

    n_weights = (2, 3, 4)

    def __init__(self, cfg, weights, dtype):
        super().__init__(cfg, weights, dtype)
        axis = cfg.get("axis", -1)
        axes = axis if isinstance(axis, (list, tuple)) else [axis]
        if len(axes) != 1:
            raise NotImplementedError(f"layer {self.layer_name!r}: batch norm over {axes}")
        self.axis = int(axes[0])
        self.momentum = float(cfg.get("momentum", 0.99))
        self.scale, self.center = bool(cfg.get("scale", True)), bool(cfg.get("center", True))
        if len(weights) != 2 + self.scale + self.center:
            raise ValueError(f"layer {self.layer_name!r}: {len(weights)} weights for "
                             f"scale={self.scale}, center={self.center}")
        features = weights[-1].shape[0]
        self.bn = BatchNorm(features, float(cfg.get("epsilon", 1e-3)), use_scale=self.scale)
        i = 0
        if self.scale:
            self.bn.scale, i = _param(weights[0]), 1
        if self.center:
            self.bn.bias = _param(weights[i])
        else:
            # no beta in Keras: a zero offset that never trains
            del self.bn.bias
            self.bn.register_buffer("bias", torch.zeros(features))
        self.bn.mean = _tensor(weights[-2])
        self.bn.var = _tensor(weights[-1])

    def call(self, x):
        x = self.cast(x)
        dim = _dim(x, self.axis)
        if self.training and self.trainable:
            return self._train(x, dim)
        if dim == 1:
            return self.bn(x)
        return self.bn(x.movedim(dim, 1)).movedim(1, dim)

    def _train(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """Keras's ``BatchNormalization.call(training=True)``: the batch's
        mean and biased variance, in float32 or wider, over every axis but
        ``dim``; the moving statistics move to ``moving * momentum + batch *
        (1 - momentum)`` (no gradient); the output is ``x * inv + (beta -
        mean * inv)`` with ``inv = rsqrt(var + eps) * gamma``, as
        ``ops.batch_normalization`` computes it, rounded once to ``x``'s
        type."""
        bn = self.bn
        # float32 at least, as Keras's result_type(x.dtype, "float32")
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        dims = [d for d in range(x.dim()) if d != dim]
        shape = [1] * x.dim()
        shape[dim] = -1
        mean = xf.mean(dim=dims)
        var = (xf - mean.view(shape)).square().mean(dim=dims)
        with torch.no_grad():
            bn.mean.copy_(bn.mean * self.momentum + mean * (1.0 - self.momentum))
            bn.var.copy_(bn.var * self.momentum + var * (1.0 - self.momentum))
        inv = torch.rsqrt(var + bn.epsilon)
        if bn.scale is not None:
            inv = inv * bn.scale
        offset = -mean * inv + bn.bias
        return (xf * inv.view(shape) + offset.view(shape)).to(x.dtype)

    def keras_weights(self):
        bn = self.bn
        return ([_array(bn.scale)] if self.scale else []) \
            + ([_array(bn.bias)] if self.center else []) + [_array(bn.mean), _array(bn.var)]


class _Dense(_Layer):
    """``x @ kernel + bias`` on the last (Keras) axis."""

    n_weights = (1, 2)

    def __init__(self, cfg, weights, dtype):
        super().__init__(cfg, weights, dtype)
        kernel = weights[0]
        self.dense = Dense(kernel.shape[0], kernel.shape[1], bias=len(weights) == 2)
        self.dense.weight = _param(kernel.T)
        if len(weights) == 2:
            self.dense.bias = _param(weights[1])
        self.activation = _activation(cfg.get("activation"), self.layer_name)

    def call(self, x):
        y = _from_nhwc(self.dense(_nhwc(self.cast(x))))
        return self.activation(y)

    def keras_weights(self):
        bias = [] if self.dense.bias is None else [_array(self.dense.bias)]
        return [_array(self.dense.weight.T)] + bias


class _Activation(_Layer):
    def __init__(self, cfg, weights, dtype):
        super().__init__(cfg, weights, dtype)
        self.activation = _activation(cfg.get("activation"), self.layer_name)

    def call(self, x):
        return self.activation(self.cast(x))


class _ReLU(_Layer):
    def __init__(self, cfg, weights, dtype):
        super().__init__(cfg, weights, dtype)
        max_value = cfg.get("max_value")
        self.kwargs = dict(negative_slope=float(cfg.get("negative_slope", 0.0)),
                           max_value=None if max_value is None else float(max_value),
                           threshold=float(cfg.get("threshold", 0.0)))

    def call(self, x):
        return _relu(self.cast(x), **self.kwargs)


class _Softmax(_Layer):
    def __init__(self, cfg, weights, dtype):
        super().__init__(cfg, weights, dtype)
        self.axis = cfg.get("axis", -1)

    def call(self, x):
        return _softmax(self.cast(x), self.axis)


class _Add(_Layer):
    def call(self, xs):
        xs = self.cast(xs)
        out = xs[0]
        for x in xs[1:]:
            out = out + x
        return out


class _Concatenate(_Layer):
    def __init__(self, cfg, weights, dtype):
        super().__init__(cfg, weights, dtype)
        self.axis = int(cfg.get("axis", -1))

    def call(self, xs):
        xs = self.cast(xs)
        return torch.cat(xs, dim=_dim(xs[0], self.axis))


class _Flatten(_Layer):
    def call(self, x):
        x = self.cast(x)
        return _nhwc(x).reshape(x.shape[0], -1)


class _Reshape(_Layer):
    def __init__(self, cfg, weights, dtype):
        super().__init__(cfg, weights, dtype)
        self.target = tuple(int(d) for d in cfg["target_shape"])

    def call(self, x):
        x = self.cast(x)
        return _from_nhwc(_nhwc(x).reshape(x.shape[0], *self.target))


class _Rescaling(_Layer):
    def __init__(self, cfg, weights, dtype):
        super().__init__(cfg, weights, dtype)
        self.scale = np.asarray(cfg.get("scale", 1.0), dtype=np.float64)
        self.offset = np.asarray(cfg.get("offset", 0.0), dtype=np.float64)

    def _const(self, value: np.ndarray, x: torch.Tensor) -> torch.Tensor:
        t = torch.tensor(value, dtype=x.dtype, device=x.device)
        return t.view(1, -1, 1, 1) if x.dim() == 4 and t.dim() == 1 else t

    def call(self, x):
        x = self.cast(x)
        return x * self._const(self.scale, x) + self._const(self.offset, x)


class _Dropout(_Layer):
    """The identity at inference. Under ``train()``, Keras's dropout: each
    value kept with probability ``1 - rate`` and scaled by its inverse, the
    mask drawn from ``generator`` (the default generator when None)."""

    def __init__(self, cfg, weights, dtype):
        super().__init__(cfg, weights, dtype)
        self.rate = float(cfg.get("rate", 0.0))
        self.noise_shape = cfg.get("noise_shape")

    def call(self, x, generator: Optional[torch.Generator] = None):
        x = self.cast(x)
        if not (self.training and self.rate > 0):
            return x
        if self.noise_shape is not None:
            raise NotImplementedError(f"layer {self.layer_name!r}: training with a noise_shape")
        keep = 1.0 - self.rate
        mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
        return torch.where(mask, x / keep, torch.zeros_like(x))


class _ZeroPadding2D(_Layer):
    def __init__(self, cfg, weights, dtype):
        super().__init__(cfg, weights, dtype)
        pad = cfg.get("padding", 1)
        if isinstance(pad, int):
            pad = ((pad, pad), (pad, pad))
        elif all(isinstance(p, int) for p in pad):
            pad = ((pad[0], pad[0]), (pad[1], pad[1]))
        (top, bottom), (left, right) = pad
        self.pads = (int(left), int(right), int(top), int(bottom))

    def call(self, x):
        return F.pad(self.cast(x), self.pads)


class _Pooling2D(_Layer):
    def __init__(self, cfg, weights, dtype):
        super().__init__(cfg, weights, dtype)
        self.window = _pair(cfg.get("pool_size", 2))
        strides = cfg.get("strides")
        self.strides = self.window if strides is None else _pair(strides)
        self.padding = cfg.get("padding", "valid").upper()


class _MaxPooling2D(_Pooling2D):
    def call(self, x):
        return max_pool(self.cast(x), self.window, self.strides, self.padding)


class _AveragePooling2D(_Pooling2D):
    def call(self, x):
        return avg_pool(self.cast(x), self.window, self.strides, self.padding)


class _GlobalAveragePooling2D(_Layer):
    def __init__(self, cfg, weights, dtype):
        super().__init__(cfg, weights, dtype)
        self.keepdims = bool(cfg.get("keepdims", False))

    def call(self, x):
        y = global_avg_pool(self.cast(x))
        return y[:, :, None, None] if self.keepdims else y


_LAYERS = {cls.__name__[1:]: cls for cls in (
    _InputLayer, _Conv2D, _DepthwiseConv2D, _SeparableConv2D, _BatchNormalization,
    _Dense, _Activation, _ReLU, _Softmax, _Add, _Concatenate, _Flatten, _Reshape,
    _Rescaling, _Dropout, _ZeroPadding2D, _MaxPooling2D, _AveragePooling2D,
    _GlobalAveragePooling2D,
)}


# ----------------------------------------------------------------------
# the graph
# ----------------------------------------------------------------------

def _history(arg) -> Optional[Tuple[str, int, int]]:
    if isinstance(arg, Mapping) and arg.get("class_name") == "__keras_tensor__":
        name, node, index = arg["config"]["keras_history"]
        return (str(name), int(node), int(index))
    return None


def _refs(args) -> List[Tuple[str, int, int]]:
    """Every keras tensor an inbound node's args name, in order."""
    found = _history(args)
    if found is not None:
        return [found]
    if isinstance(args, (list, tuple)):
        return [r for a in args for r in _refs(a)]
    if isinstance(args, Mapping):
        return [r for a in args.values() for r in _refs(a)]
    return []


def _substitute(args, values: Mapping[Tuple[str, int, int], torch.Tensor]):
    found = _history(args)
    if found is not None:
        return values[found]
    if isinstance(args, (list, tuple)):
        return [_substitute(a, values) for a in args]
    return args


def _as_list(spec) -> List:
    """``input_layers`` / ``output_layers``: one ``[name, node, index]`` or
    a list of them."""
    if spec and isinstance(spec[0], str):
        return [spec]
    return list(spec)


class KerasModel(nn.Module):
    """A Keras 3 model (Sequential or Functional) as a torch module.

    ``KerasModel(config, weights, compute_dtype=None)``: ``config`` is
    ``{"class_name": ..., "config": ...}`` as a file holds it; ``weights``
    maps each layer's name to its arrays in the layer's variable order (a
    nested model's name to the same mapping of its layers);
    ``compute_dtype`` (``"bfloat16"`` or ``"float16"``) overrides every
    layer's policy to ``mixed_<dtype>``, else each layer's serialized policy
    holds. ``forward`` takes NHWC inputs as Keras does and returns the
    model's output (a tuple where it has several); ``generator`` feeds the
    Dropout masks under ``train()``.

    A layer's weights are parameters that take gradients where the layer is
    trainable (its config's ``trainable``, ANDed with every enclosing
    model's; ``trainable=False`` freezes the whole model); batch norm's
    moving statistics are buffers. It is built in eval mode. A nested model (``nested=True``) is a
    child ``KerasModel`` that reads and returns the outer model's NCHW
    layout; it may not nest a model in turn."""

    def __init__(self, config: Mapping[str, Any], weights: Mapping[str, Any],
                 compute_dtype: Optional[str] = None, *, trainable: bool = True,
                 nested: bool = False):
        super().__init__()
        cls = config.get("class_name")
        if cls not in _MODEL_CLASSES:
            raise NotImplementedError(f"Keras model class {cls!r} is not supported")
        cfg = config["config"]
        #: the configuration the model was built from, for writing it back
        #: (``write_keras_file(path, model.config, model.keras_weights())``)
        self.config = copy.deepcopy(dict(config))
        self.name = cfg.get("name", "model")
        self.trainable = trainable and bool(cfg.get("trainable", True))
        self.nested = nested
        self.compute_dtype = compute_dtype
        override = None if compute_dtype is None else policy_dtype(f"mixed_{compute_dtype}")
        self.layers = nn.ModuleDict()
        self._keys: Dict[str, str] = {}
        for layer in cfg["layers"]:
            self._add_layer(layer, weights, override)
        if cls == "Sequential":
            self._sequential(cfg)
        else:
            self._functional(cfg)
        # built for inference, as Keras calls a model; train() for a fit
        self.eval()

    def _add_layer(self, layer: Mapping[str, Any], weights, override) -> None:
        cls, lcfg = layer["class_name"], layer["config"]
        name = lcfg["name"]
        key = name.replace(".", "_")
        if key in self.layers:
            raise ValueError(f"two layers named {name!r}")
        trainable = self.trainable and bool(lcfg.get("trainable", True))
        if cls in _MODEL_CLASSES + ("Model",):
            if self.nested:
                raise NotImplementedError(
                    f"layer {name!r} of {self.name!r} is a model nested two deep ({cls})")
            inner = weights.get(name, {})
            if not isinstance(inner, Mapping):
                raise ValueError(f"nested model {name!r}: its weights must map its layers' "
                                 "names to their arrays")
            module: nn.Module = KerasModel(layer, inner, self.compute_dtype,
                                           trainable=self.trainable, nested=True)
        elif cls not in _LAYERS:
            raise NotImplementedError(f"Keras layer class {cls!r} (layer {name!r}) is not supported")
        else:
            dtype = policy_dtype(lcfg.get("dtype")) if override is None else override
            module = _LAYERS[cls](lcfg, [np.asarray(w) for w in weights.get(name, [])], dtype)
            module.trainable = trainable
            module.requires_grad_(trainable)
        self._keys[name] = key
        self.layers[key] = module

    def _layer(self, name: str):
        return self.layers[self._keys[name]]

    def _sequential(self, cfg) -> None:
        names = [layer["config"]["name"] for layer in cfg["layers"]]
        if not names:
            raise ValueError(f"Sequential model {self.name!r} has no layers")
        first = self._layer(names[0])
        if isinstance(first, _InputLayer):
            self._inputs, chain = [(names[0], 0, 0)], names[1:]
            self.input_shapes = [first.batch_shape]
        else:
            # no InputLayer: the input feeds the first layer ("" names it)
            self._inputs, chain = [("", 0, 0)], names
            shape = cfg.get("build_input_shape")
            self.input_shapes = [None if shape is None else tuple(shape)]
        self._nodes = []
        previous = self._inputs[0][0]
        for name in chain:
            self._nodes.append((name, 0, [{"class_name": "__keras_tensor__",
                                           "config": {"keras_history": [previous, 0, 0]}}]))
            previous = name
        self._outputs = [(previous, 0, 0)]

    def _functional(self, cfg) -> None:
        pending = []
        for layer in cfg["layers"]:
            name = layer["config"]["name"]
            for node_index, node in enumerate(layer.get("inbound_nodes", [])):
                if not isinstance(node, Mapping) or "args" not in node:
                    raise NotImplementedError(
                        f"layer {name!r}: Keras 2's node format is not supported "
                        "(save the model with Keras 3)")
                if _refs(node.get("kwargs", {})):
                    raise NotImplementedError(f"layer {name!r} takes tensors as kwargs")
                pending.append((name, node_index, node["args"]))
        self._inputs = [tuple(spec) for spec in _as_list(cfg["input_layers"])]
        self._outputs = [tuple(spec) for spec in _as_list(cfg["output_layers"])]
        self.input_shapes = []
        for name, _, _ in self._inputs:
            layer = self._layer(name)
            self.input_shapes.append(getattr(layer, "batch_shape", None))
        # topological order: a node runs once every tensor it reads exists
        ready = {(str(n), int(i), int(j)) for n, i, j in self._inputs}
        self._nodes = []
        while pending:
            left = []
            for name, node_index, args in pending:
                if all(r in ready for r in _refs(args)):
                    self._nodes.append((name, node_index, args))
                    ready.add((name, node_index, 0))
                else:
                    left.append((name, node_index, args))
            if len(left) == len(pending):
                raise ValueError(f"the graph cannot run: layers {[p[0] for p in left]} "
                                 "read tensors no layer makes")
            pending = left

    def forward(self, *inputs: torch.Tensor, generator: Optional[torch.Generator] = None):
        # NHWC in: a 4-D input goes NCHW into channels_last memory once
        inputs = tuple(_from_nhwc(x).contiguous(memory_format=torch.channels_last)
                       if x.dim() == 4 else x for x in inputs)
        outputs = tuple(_nhwc(y) for y in self._run(inputs, generator))
        return outputs[0] if len(outputs) == 1 else outputs

    def call(self, *inputs: torch.Tensor, generator: Optional[torch.Generator] = None):
        """The model as a layer of an enclosing one: NCHW in and out."""
        outputs = self._run(inputs, generator)
        return outputs[0] if len(outputs) == 1 else outputs

    def _run(self, inputs, generator) -> Tuple[torch.Tensor, ...]:
        if len(inputs) != len(self._inputs):
            raise ValueError(f"{self.name} takes {len(self._inputs)} inputs, got {len(inputs)}")
        values: Dict[Tuple[str, int, int], torch.Tensor] = {}
        for (name, node, index), x in zip(self._inputs, inputs):
            if name:
                x = self._layer(name).call(x)
            values[(name, node, index)] = x
        for name, node_index, args in self._nodes:
            layer = self._layer(name)
            args = _substitute(args, values)
            if isinstance(layer, (KerasModel, _Dropout)):
                values[(name, node_index, 0)] = layer.call(*args, generator=generator)
            else:
                values[(name, node_index, 0)] = layer.call(*args)
        return tuple(values[spec] for spec in self._outputs)

    def keras_weights(self) -> Weights:
        """The current weights as :func:`read_keras_file` gives them: layer
        name -> arrays in Keras's variable order and layout, a nested
        model's name -> its own mapping; host copies."""
        return {name: self.layers[key].keras_weights() for name, key in self._keys.items()}


# ----------------------------------------------------------------------
# writing
# ----------------------------------------------------------------------

def write_keras_file(path, config: Mapping[str, Any], weights: Mapping[str, Any]) -> None:
    """Write a ``.keras`` file: the zip Keras 3 writes (``metadata.json``,
    ``config.json`` and ``model.weights.h5``, stored), each layer's weights
    at ``<its group>/<i>`` of the HDF5 file (:func:`_variable_paths`; a
    nested model's layers under its group), written by
    :func:`sparkdl_tpu_torch.utils.hdf5.write`."""
    tree: Dict[str, Any] = {"layers": {}, "vars": {}}
    attrs = {"vars": {"name": config["config"].get("name", "model")}}

    def put(paths: Mapping[str, Any], weights: Mapping[str, Any]) -> None:
        for name, group in paths.items():
            arrays = weights.get(name, ())
            if isinstance(group, Mapping):
                put(group, arrays or {})
            elif len(arrays):
                node = tree
                for part in group.split("/")[:-1]:
                    node = node.setdefault(part, {})
                node["vars"] = {str(i): np.asarray(a) for i, a in enumerate(arrays)}
                attrs[group] = {"name": name}

    put(_variable_paths(config), weights)
    blob = hdf5.write(None, tree, attrs)
    metadata = {"keras_version": _KERAS_VERSION,
                "date_saved": time.strftime("%Y-%m-%d@%H:%M:%S")}
    with zipfile.ZipFile(path, "w", compression=zipfile.ZIP_STORED) as archive:
        archive.writestr("metadata.json", json.dumps(metadata))
        archive.writestr("config.json", json.dumps(config))
        archive.writestr("model.weights.h5", blob)
