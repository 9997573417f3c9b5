"""Carry ViT and CNN zoo weights between the Flax layout and a PyTorch
``state_dict``.

``vit_state_dict_from_flax`` takes the parameter tree of
``sparkdl_tpu.models.vit.ViT`` (nested dicts of numpy arrays, with or without
the outer ``{"params": ...}``) and returns the ``state_dict`` of
:class:`sparkdl_tpu_torch.models.vit.ViT`:

- Dense kernels ``(in, out)`` become ``weight`` ``(out, in)``;
- the patch conv kernel goes from HWIO to OIHW;
- LayerNorm ``scale`` / ``bias`` become ``weight`` / ``bias``;
- ``cls_token`` and ``pos_embed`` carry over as they are.

``vit_flax_from_state_dict`` is its inverse: it maps a ``state_dict`` (or a
tree of gradients under the same names) back to ``{"params": ...}`` of
numpy arrays, so the port's trained weights compare with the JAX package's
by Flax name.

``cnn_state_dict_from_flax`` carries the variables ``{"params": ...,
"batch_stats": ...}`` of a zoo model of the JAX package (InceptionV3,
ResNet50, VGG16, VGG19, MobileNetV2, Xception) to the ``state_dict`` of the
port's module, driven by that module's own parameter names: the layer name
is the Flax layer's, and each leaf maps as

- ``weight`` (4-d) <- ``params/<layer>/kernel``: HWIO -> OIHW, which also
  takes a depthwise kernel ``(kh, kw, 1, cin)`` to ``(cin, 1, kh, kw)``;
- ``depthwise_kernel`` / ``pointwise_kernel`` <- the same names, by the
  same permutation: ``(kh, kw, 1, cin)`` -> ``(cin, 1, kh, kw)`` and
  ``(1, 1, cin, cout)`` -> ``(cout, cin, 1, 1)``;
- ``weight`` (2-d) <- a Dense ``kernel``, ``(in, out)`` -> ``(out, in)``;
- ``bias`` and ``scale`` <- ``params``, ``mean`` and ``var`` <-
  ``batch_stats``, as they are.

``cnn_flax_from_state_dict`` is its inverse. ``inception_state_dict_from_flax``
and ``inception_flax_from_state_dict`` are the two for InceptionV3, whose
module they build themselves.

The arrays may be numpy or JAX arrays. A key that the layout does not use,
or one that it needs and does not find, raises ``KeyError``; a leaf of
another shape than the module's raises ``ValueError``.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from sparkdl_tpu_torch.models.inception_v3 import InceptionV3

_BLOCK_DENSE = ("qkv", "proj", "mlp_up", "mlp_down")
_BLOCK_NORMS = ("ln_1", "ln_2")


def _take(tree: Mapping[str, Any], key: str, where: str):
    if not isinstance(tree, Mapping) or key not in tree:
        raise KeyError(f"missing key {where}{key}")
    return tree[key]


def _check_used(tree: Mapping[str, Any], used, where: str) -> None:
    extra = sorted(set(tree) - set(used))
    if extra:
        raise KeyError(f"unused keys under {where or '<root>'}: {extra}")


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def _dense(tree, name, where, out: Dict[str, torch.Tensor], prefix: str):
    sub = _take(tree, name, where)
    path = f"{where}{name}/"
    kernel = _take(sub, "kernel", path)
    bias = _take(sub, "bias", path)
    _check_used(sub, ("kernel", "bias"), path)
    out[f"{prefix}{name}.weight"] = _tensor(kernel).T.contiguous()
    out[f"{prefix}{name}.bias"] = _tensor(bias)


def _norm(tree, name, where, out: Dict[str, torch.Tensor], prefix: str):
    sub = _take(tree, name, where)
    path = f"{where}{name}/"
    scale = _take(sub, "scale", path)
    bias = _take(sub, "bias", path)
    _check_used(sub, ("scale", "bias"), path)
    out[f"{prefix}{name}.weight"] = _tensor(scale)
    out[f"{prefix}{name}.bias"] = _tensor(bias)


def vit_state_dict_from_flax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The PyTorch ``state_dict`` of a Flax ViT parameter tree."""
    if set(params) == {"params"}:
        params = params["params"]
    out: Dict[str, torch.Tensor] = {}
    used = ["patch_embed", "cls_token", "pos_embed", "ln_final"]

    pe = _take(params, "patch_embed", "")
    kernel = _take(pe, "kernel", "patch_embed/")
    bias = _take(pe, "bias", "patch_embed/")
    _check_used(pe, ("kernel", "bias"), "patch_embed/")
    out["patch_embed.weight"] = _tensor(kernel).permute(3, 2, 0, 1).contiguous()
    out["patch_embed.bias"] = _tensor(bias)
    out["cls_token"] = _tensor(_take(params, "cls_token", ""))
    out["pos_embed"] = _tensor(_take(params, "pos_embed", ""))

    depth = 0
    while f"block_{depth}" in params:
        name = f"block_{depth}"
        block = params[name]
        for norm in _BLOCK_NORMS:
            _norm(block, norm, f"{name}/", out, f"blocks.{depth}.")
        for dense in _BLOCK_DENSE:
            _dense(block, dense, f"{name}/", out, f"blocks.{depth}.")
        _check_used(block, _BLOCK_NORMS + _BLOCK_DENSE, f"{name}/")
        used.append(name)
        depth += 1
    if depth == 0:
        raise KeyError("missing key block_0")

    _norm(params, "ln_final", "", out, "")
    if "head" in params:
        _dense(params, "head", "", out, "")
        used.append("head")
    _check_used(params, used, "")
    return out


def vit_flax_from_state_dict(state: Mapping[str, Any]) -> Dict[str, Any]:
    """The Flax parameter tree ``{"params": ...}`` (float32 numpy arrays) of
    a ViT ``state_dict``: the inverse of :func:`vit_state_dict_from_flax`."""
    left = dict(state)

    def take(name: str) -> np.ndarray:
        if name not in left:
            raise KeyError(f"missing key {name}")
        t = left.pop(name)
        t = t.detach().cpu() if isinstance(t, torch.Tensor) else torch.as_tensor(t)
        return t.float().numpy().copy()

    def dense(prefix: str) -> Dict[str, np.ndarray]:
        return {"kernel": take(f"{prefix}.weight").T.copy(),
                "bias": take(f"{prefix}.bias")}

    def norm(prefix: str) -> Dict[str, np.ndarray]:
        return {"scale": take(f"{prefix}.weight"), "bias": take(f"{prefix}.bias")}

    params: Dict[str, Any] = {
        "patch_embed": {
            "kernel": take("patch_embed.weight").transpose(2, 3, 1, 0).copy(),
            "bias": take("patch_embed.bias"),
        },
        "cls_token": take("cls_token"),
        "pos_embed": take("pos_embed"),
    }
    depth = 0
    while f"blocks.{depth}.ln_1.weight" in left:
        prefix = f"blocks.{depth}"
        block = {n: norm(f"{prefix}.{n}") for n in _BLOCK_NORMS}
        block.update({n: dense(f"{prefix}.{n}") for n in _BLOCK_DENSE})
        params[f"block_{depth}"] = block
        depth += 1
    if depth == 0:
        raise KeyError("missing key blocks.0.ln_1.weight")
    params["ln_final"] = norm("ln_final")
    if "head.weight" in left or "head.bias" in left:
        params["head"] = dense("head")
    if left:
        raise KeyError(f"unused keys: {sorted(left)}")
    return {"params": params}


def _inception_module(num_classes) -> torch.nn.Module:
    """InceptionV3 on the meta device: its layout, without any number."""
    with torch.device("meta"):
        return InceptionV3(num_classes=num_classes)


def inception_state_dict_from_flax(
    variables: Mapping[str, Any]
) -> Dict[str, torch.Tensor]:
    """The PyTorch ``state_dict`` of Flax InceptionV3 variables, through
    :func:`cnn_state_dict_from_flax`; the ``predictions`` Dense, where the
    tree has one, keeps its number of classes."""
    params = _take(variables, "params", "")
    num_classes = None
    if isinstance(params, Mapping) and "predictions" in params:
        kernel = _take(params["predictions"], "kernel", "params/predictions/")
        num_classes = np.shape(kernel)[-1]
    return cnn_state_dict_from_flax(variables, _inception_module(num_classes))


def inception_flax_from_state_dict(state: Mapping[str, Any]) -> Dict[str, Any]:
    """The Flax variables ``{"params": ..., "batch_stats": ...}`` (float32
    numpy arrays) of an InceptionV3 ``state_dict``: the inverse of
    :func:`inception_state_dict_from_flax`, through
    :func:`cnn_flax_from_state_dict`. A key that InceptionV3 lacks, or one
    of its own that ``state`` lacks, raises ``KeyError``."""
    with_predictions = any(k.startswith("predictions.") for k in state)
    want = _inception_module(1000 if with_predictions else None).state_dict().keys()
    missing = sorted(set(want) - set(state))
    if missing:
        raise KeyError(f"missing key {missing[0]}")
    _check_used(state, want, "")
    return cnn_flax_from_state_dict(state)


def _flax_leaf(key: str):
    """``(collection, layer, leaf)`` of the Flax variable behind the
    ``state_dict`` key ``key`` of a zoo module."""
    layer, leaf = key.rsplit(".", 1)
    if leaf in ("mean", "var"):
        return "batch_stats", layer, leaf
    return "params", layer, "kernel" if leaf == "weight" else leaf


def _torch_layout(a: torch.Tensor) -> torch.Tensor:
    if a.dim() == 4:  # HWIO -> OIHW
        return a.permute(3, 2, 0, 1).contiguous()
    if a.dim() == 2:  # Dense (in, out) -> (out, in)
        return a.T.contiguous()
    return a


# torch -> Flax axes by rank: OIHW -> HWIO, (out, in) -> (in, out)
_FLAX_AXES = {4: (2, 3, 1, 0), 2: (1, 0)}


def _flax_layout(a: np.ndarray) -> np.ndarray:
    axes = _FLAX_AXES.get(a.ndim)
    return a if axes is None else a.transpose(axes).copy()


def cnn_state_dict_from_flax(variables: Mapping[str, Any],
                             module: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """The ``state_dict`` of ``module`` (a zoo model of the port; it may be
    on the meta device) from Flax variables ``{"params": ...,
    "batch_stats": ...}`` of the JAX module of the same architecture."""
    collections = {"params": _take(variables, "params", "")}
    if "batch_stats" in variables:
        collections["batch_stats"] = variables["batch_stats"]
    _check_used(variables, collections, "")
    used: Dict[str, Dict[str, list]] = {c: {} for c in collections}
    out: Dict[str, torch.Tensor] = {}
    for key, target in module.state_dict().items():
        coll, layer, leaf = _flax_leaf(key)
        where = f"{coll}/"
        node = _take(_take(collections.get(coll), layer, where), leaf, f"{where}{layer}/")
        t = _torch_layout(_tensor(node))
        if tuple(t.shape) != tuple(target.shape):
            raise ValueError(f"{where}{layer}/{leaf} has shape {tuple(np.shape(node))}; "
                             f"{type(module).__name__} needs {key} {tuple(target.shape)}")
        out[key] = t
        used[coll].setdefault(layer, []).append(leaf)
    for coll, tree in collections.items():
        _check_used(tree, used[coll], f"{coll}/")
        for layer, leaves in used[coll].items():
            _check_used(tree[layer], leaves, f"{coll}/{layer}/")
    return out


def cnn_flax_from_state_dict(state: Mapping[str, Any]) -> Dict[str, Any]:
    """The Flax variables (float32 numpy arrays) of a zoo module's
    ``state_dict``: the inverse of :func:`cnn_state_dict_from_flax`.
    ``batch_stats`` is left out when no layer has statistics (VGG)."""
    variables: Dict[str, Any] = {"params": {}, "batch_stats": {}}
    for key, t in state.items():
        coll, layer, leaf = _flax_leaf(key)
        t = t.detach().cpu() if isinstance(t, torch.Tensor) else torch.as_tensor(t)
        variables[coll].setdefault(layer, {})[leaf] = _flax_layout(t.float().numpy().copy())
    if not variables["params"]:
        raise KeyError("missing key: the state_dict is empty")
    if not variables["batch_stats"]:
        del variables["batch_stats"]
    return variables


def cnn_flax_shapes(module: torch.nn.Module) -> Dict[str, Any]:
    """The Flax variables tree of ``module`` (on any device, the meta one
    too) with each leaf's shape in place of its array: the layout of
    :func:`cnn_flax_from_state_dict`, without reading any number."""
    shapes: Dict[str, Any] = {}
    for key, t in module.state_dict().items():
        coll, layer, leaf = _flax_leaf(key)
        axes = _FLAX_AXES.get(t.dim(), range(t.dim()))
        shapes.setdefault(coll, {}).setdefault(layer, {})[leaf] = tuple(t.shape[i] for i in axes)
    return shapes
