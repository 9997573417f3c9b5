"""Keras -> Flax-layout weight porting, in numpy.

Port of ``sparkdl_tpu.models.keras_port``. It never imports ``keras``: it
reads a caller's built model duck-typed, through ``model.layers``, each
layer's ``name``, ``type(layer).__name__``, ``get_weights()`` and the
``use_bias`` / ``scale`` / ``center`` flags, and returns the variables
tree of the JAX package's zoo module (``{"params": ..., "batch_stats":
...}`` of numpy arrays), which
:func:`sparkdl_tpu_torch.models.convert.cnn_state_dict_from_flax` carries
to the port's ``state_dict``.

:func:`keras_layers_view` and :func:`legacy_weights_view` present a Keras
config with its weights, or a weights-only legacy ``.h5`` (the files
``keras.applications`` caches), in the same duck-typed form.

Keras auto-names (``conv2d_37``, ``batch_normalization_5``, ...) shift by a
global uid offset from one construction to the next, but their per-type
order is stable: :func:`normalized_layer_names` renumbers each auto-named
type from zero, which gives the names the modules hold. Explicitly named
layers (``conv1_conv``, ``block1_sepconv1``, ...) pass through.
"""

from __future__ import annotations

import re
from types import SimpleNamespace
from typing import Any, Dict, Mapping

import numpy as np
import torch

from sparkdl_tpu_torch.models.convert import cnn_flax_shapes
from sparkdl_tpu_torch.models.keras_model import _VARIABLE_ORDER, LegacyWeights

# Keras auto-name prefixes that get renumbered per type
_AUTO_PREFIXES = frozenset(
    {
        "conv2d",
        "batch_normalization",
        "dense",
        "depthwise_conv2d",
        "separable_conv2d",
        "activation",
        "concatenate",
        "max_pooling2d",
        "average_pooling2d",
        "global_average_pooling2d",
        "dropout",
        "input_layer",
        "zero_padding2d",
        "add",
        "flatten",
        "rescaling",
    }
)

_SUFFIX_RE = re.compile(r"^(.*?)(?:_(\d+))?$")


def normalized_layer_names(model) -> Dict[str, str]:
    """Each Keras layer's session-dependent name -> a deterministic one.

    Keras uid suffixes grow in layer creation order, while ``model.layers``
    is topologically sorted, so each auto-named prefix loses its smallest
    suffix rather than being renumbered by list position."""
    minima: Dict[str, int] = {}
    parsed: Dict[str, tuple] = {}
    for layer in model.layers:
        m = _SUFFIX_RE.match(layer.name)
        base, suffix = m.group(1), int(m.group(2) or 0)
        parsed[layer.name] = (base, suffix)
        if base in _AUTO_PREFIXES:
            minima[base] = min(minima.get(base, suffix), suffix)
    out: Dict[str, str] = {}
    for layer in model.layers:
        base, suffix = parsed[layer.name]
        if base in _AUTO_PREFIXES:
            idx = suffix - minima[base]
            out[layer.name] = base if idx == 0 else f"{base}_{idx}"
        else:
            out[layer.name] = layer.name
    return out


def _with_bias(layer, entry: Dict[str, np.ndarray], weights, index: int):
    if getattr(layer, "use_bias", False):
        entry["bias"] = np.asarray(weights[index])
    return entry


def keras_layers_view(config: Mapping[str, Any], weights: Mapping[str, Any]) -> SimpleNamespace:
    """A Keras config and its weights (``read_keras_file``'s pair, or a
    ``KerasModel``'s ``config`` and ``keras_weights()``) as
    :func:`port_keras_weights` reads a built Keras model: ``layers`` in the
    configuration's order, each with its Keras class's name, ``name``,
    ``get_weights()`` and the ``use_bias`` / ``scale`` / ``center`` flags
    of its config."""
    layers = []
    for layer in config["config"]["layers"]:
        cfg = layer["config"]
        flags = {"use_bias": cfg.get("use_bias", False), "scale": cfg.get("scale", True),
                 "center": cfg.get("center", True)}
        layers.append(_weights_view(layer["class_name"], cfg["name"],
                                    weights.get(cfg["name"], []), flags))
    return SimpleNamespace(layers=layers)


def _weights_view(cls: str, name: str, arrays, flags: Mapping[str, bool]):
    """One layer as :func:`port_keras_weights` reads it: an object of class
    ``cls`` with ``name``, ``get_weights()`` and the flags."""
    view = type(cls, (), {})()
    view.name = name
    for flag, value in flags.items():
        setattr(view, flag, value)
    view.get_weights = lambda: list(arrays)
    return view


def _class_of_variables(name: str, variables: Mapping[str, np.ndarray],
                        depthwise: bool) -> str:
    """A layer's Keras class, from the names of its variables (and, for a
    Keras 3 ``DepthwiseConv2D``, whose one weight is named ``kernel``,
    from ``depthwise``)."""
    if not variables:
        return "Layer"
    if "moving_mean" in variables:
        return "BatchNormalization"
    if "depthwise_kernel" in variables:
        return "SeparableConv2D" if "pointwise_kernel" in variables else "DepthwiseConv2D"
    if "kernel" in variables and np.ndim(variables["kernel"]) == 4:
        return "DepthwiseConv2D" if depthwise else "Conv2D"
    if "kernel" in variables and np.ndim(variables["kernel"]) == 2:
        return "Dense"
    raise NotImplementedError(f"no porting rule for layer {name!r} with weights "
                              f"{sorted(variables)}")


def legacy_weights_view(layers: LegacyWeights, depthwise=frozenset()) -> SimpleNamespace:
    """A weights-only legacy ``.h5``
    (:func:`~sparkdl_tpu_torch.models.keras_model.read_legacy_weights`) as
    :func:`port_keras_weights` reads a built Keras model: ``layers`` in the
    file's ``layer_names`` order, each layer's class told by its variables'
    names (the last part of each weight name, without a ``:0``):
    ``moving_mean`` a ``BatchNormalization`` (``scale`` where it has
    ``gamma``, ``center`` where ``beta``), ``depthwise_kernel`` a
    ``DepthwiseConv2D`` (Keras 2's name), or with ``pointwise_kernel`` a
    ``SeparableConv2D``, ``kernel`` of rank 2 a ``Dense`` and of rank 4 a
    ``Conv2D``, unless the layer's normalized name is in ``depthwise`` (a
    Keras 3 ``DepthwiseConv2D`` names its weight ``kernel``; the caller's
    module tells which layers those are); ``use_bias`` where it has
    ``bias``; the arrays in Keras's variable order."""
    normalized = normalized_layer_names(
        SimpleNamespace(layers=[SimpleNamespace(name=name) for name, _ in layers]))
    views = []
    for name, pairs in layers:
        variables: Dict[str, np.ndarray] = {}
        for weight, array in pairs:
            var = weight.rsplit("/", 1)[-1].split(":", 1)[0]
            if var in variables or var not in _VARIABLE_ORDER:
                raise NotImplementedError(f"weight {weight!r} of layer {name!r} (a nested "
                                          "model or another layer class)")
            variables[var] = array
        cls = _class_of_variables(name, variables, normalized[name] in depthwise)
        flags = {"use_bias": "bias" in variables, "scale": "gamma" in variables,
                 "center": "beta" in variables}
        arrays = [variables[v] for v in _VARIABLE_ORDER if v in variables]
        views.append(_weights_view(cls, name, arrays, flags))
    return SimpleNamespace(layers=views)


def port_keras_weights(model) -> Dict[str, Any]:
    """A built Keras model's weights as Flax variables ``{"params": ...,
    "batch_stats": ...}`` of numpy arrays, keyed by normalized layer name:
    ``kernel`` / ``bias`` for convs and Dense, ``scale`` / ``bias`` and
    ``mean`` / ``var`` for batch norm, ``depthwise_kernel`` /
    ``pointwise_kernel`` for separable convs. A layer with weights of
    another type raises ``NotImplementedError``."""
    if not hasattr(model, "layers"):
        raise TypeError(f"expected a built Keras model (with .layers), got "
                        f"{type(model).__name__}")
    names = normalized_layer_names(model)
    params: Dict[str, Any] = {}
    batch_stats: Dict[str, Any] = {}
    for layer in model.layers:
        weights = layer.get_weights()
        if not weights:
            continue
        name = names[layer.name]
        cls = type(layer).__name__
        if cls in ("Conv2D", "Dense"):
            params[name] = _with_bias(layer, {"kernel": np.asarray(weights[0])}, weights, 1)
        elif cls == "DepthwiseConv2D":
            # Keras (kh, kw, cin, 1) -> the grouped conv's HWIO (kh, kw, 1, cin)
            kernel = np.asarray(weights[0]).transpose(0, 1, 3, 2)
            params[name] = _with_bias(layer, {"kernel": kernel}, weights, 1)
        elif cls == "SeparableConv2D":
            entry = {
                "depthwise_kernel": np.asarray(weights[0]).transpose(0, 1, 3, 2),
                "pointwise_kernel": np.asarray(weights[1]),
            }
            params[name] = _with_bias(layer, entry, weights, 2)
        elif cls == "BatchNormalization":
            idx = 0
            entry = {}
            if layer.scale:
                entry["scale"] = np.asarray(weights[idx])
                idx += 1
            if layer.center:
                entry["bias"] = np.asarray(weights[idx])
                idx += 1
            batch_stats[name] = {"mean": np.asarray(weights[idx]),
                                 "var": np.asarray(weights[idx + 1])}
            if entry:
                params[name] = entry
        else:
            raise NotImplementedError(
                f"No porting rule for Keras layer {layer.name} of type {cls}"
            )
    return {"params": params, "batch_stats": batch_stats}


def pad_variables_to_module(variables: Mapping[str, Any],
                            module: torch.nn.Module) -> Dict[str, Any]:
    """Zero-pad Flax variables up to a wider port module (Xception's
    728 -> 768 middle flow), as the JAX package's
    ``pad_variables_to_module`` does.

    The target shapes are those of ``module.state_dict()`` (the module may
    be on the meta device), in the Flax layout of the inverse converter
    (:func:`~sparkdl_tpu_torch.models.convert.cnn_flax_shapes`).
    ``variables`` may hold fewer layers than the module (a headless tree);
    a leaf the module lacks, a narrower target or another rank raises
    ``ValueError``. Each wider leaf pads at the high end of its
    differing axes, with zeros, except batch norm ``var``, which pads with
    ones: the padded channels then stay exactly zero end to end."""
    target = cnn_flax_shapes(module)

    def pad(node, want, path):
        if isinstance(node, Mapping):
            return {k: pad(v, want.get(k) if isinstance(want, Mapping) else None,
                           f"{path}/{k}")
                    for k, v in node.items()}
        if not isinstance(want, tuple):
            raise ValueError(f"ported weight {path} has no counterpart in the module")
        leaf = np.asarray(node)
        if leaf.shape == want:
            return leaf
        if leaf.ndim != len(want):
            raise ValueError(f"rank mismatch at {path}: {leaf.shape} vs {want}")
        if any(w < h for h, w in zip(leaf.shape, want)):
            raise ValueError(f"target narrower than ported weights at {path}: "
                             f"{leaf.shape} vs {want}")
        return np.pad(leaf, [(0, w - h) for h, w in zip(leaf.shape, want)],
                      constant_values=1.0 if path.endswith("/var") else 0.0)

    return {k: pad(v, target.get(k), k) for k, v in variables.items()}
