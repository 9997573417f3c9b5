"""Carry ViT weights between the Flax layout and a PyTorch ``state_dict``.

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

A key that the layout does not use, or one that it needs and does not find,
raises ``KeyError``.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

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
