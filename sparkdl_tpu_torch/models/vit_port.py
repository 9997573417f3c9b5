"""Pretrained-weight ingestion for the ViT family.

Port of ``sparkdl_tpu.models.vit_port``, in numpy and torch. It reads the
two ViT artifact families:

- **google-research/vision_transformer ``.npz``** (``ViT-B_16.npz`` and
  the like): ``Transformer/encoderblock_{i}/MultiHeadDotProductAttention_1/
  query/kernel`` naming, attention weights factored per head.
  :func:`export_vit_npz` writes the same naming, so a checkpoint made
  offline goes through the path a downloaded one takes;
- **Hugging Face's torch ViT** (``ViTModel`` /
  ``ViTForImageClassification``), read duck-typed through its
  ``state_dict()``: ``transformers`` is never imported. Hugging Face's
  gelu is the exact erf form, so run the result in ``ViT(exact_gelu=True)``.

Each builds the Flax-layout tree of the JAX package's ``ViT``
(``{"params": ...}`` of numpy arrays) and carries it to the port's
``state_dict`` through
:func:`~sparkdl_tpu_torch.models.convert.vit_state_dict_from_flax`; with
``flax=True`` it returns that tree instead, as
``TorchImageFileEstimator(initialVariables=...)`` also takes it.
:func:`adapt_vit_variables` and :func:`export_vit_npz` take either form.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from sparkdl_tpu_torch.models.convert import (
    vit_flax_from_state_dict,
    vit_state_dict_from_flax,
)

_GR_ATTN = "Transformer/encoderblock_{i}/MultiHeadDotProductAttention_1"
_GR_MLP = "Transformer/encoderblock_{i}/MlpBlock_3"
_GR_LN = "Transformer/encoderblock_{i}/LayerNorm_{n}"


def _is_state_dict(variables: Mapping[str, Any]) -> bool:
    return bool(variables) and all(isinstance(v, torch.Tensor) for v in variables.values())


def _flax_params(variables: Mapping[str, Any]) -> Dict[str, Any]:
    """The Flax ``params`` tree of a ``state_dict`` or a Flax tree (with or
    without the outer ``{"params": ...}``)."""
    if _is_state_dict(variables):
        return vit_flax_from_state_dict(variables)["params"]
    return dict(variables["params"] if "params" in variables else variables)


def _result(params: Dict[str, Any], flax: bool):
    tree = {"params": params}
    return tree if flax else vit_state_dict_from_flax(tree)


def port_hf_vit(hf_model, flax: bool = False):
    """A Hugging Face torch ViT (``ViTModel`` or
    ``ViTForImageClassification``, or anything with the same
    ``state_dict()`` names) as the port's ``ViT`` ``state_dict`` (or, with
    ``flax``, the Flax-layout tree). HF's query, key and value projections
    concatenate into the fused ``qkv``; its torch ``(out, in)`` weights
    need no transpose on the way to the port, but go through the Flax
    layout so that one mapping serves every source."""
    sd = {k: v.detach().cpu().float().numpy() for k, v in hf_model.state_dict().items()}
    prefix = "vit." if any(k.startswith("vit.") for k in sd) else ""

    def g(name):
        return sd[prefix + name]

    def dense(name):
        return {"kernel": g(name + ".weight").T.copy(), "bias": g(name + ".bias")}

    def norm(name):
        return {"scale": g(name + ".weight"), "bias": g(name + ".bias")}

    params: Dict[str, Any] = {
        "patch_embed": {  # torch OIHW -> Flax HWIO
            "kernel": g("embeddings.patch_embeddings.projection.weight").transpose(2, 3, 1, 0),
            "bias": g("embeddings.patch_embeddings.projection.bias"),
        },
        "cls_token": g("embeddings.cls_token"),
        "pos_embed": g("embeddings.position_embeddings"),
    }
    depth = 1 + max(int(m.group(1)) for k in sd
                    if (m := re.search(r"encoder\.layer\.(\d+)\.", k)))
    for i in range(depth):
        p = f"encoder.layer.{i}."
        q, k, v = (dense(p + f"attention.attention.{w}") for w in ("query", "key", "value"))
        params[f"block_{i}"] = {
            "ln_1": norm(p + "layernorm_before"),
            "qkv": {"kernel": np.concatenate([q["kernel"], k["kernel"], v["kernel"]], axis=1),
                    "bias": np.concatenate([q["bias"], k["bias"], v["bias"]])},
            "proj": dense(p + "attention.output.dense"),
            "ln_2": norm(p + "layernorm_after"),
            "mlp_up": dense(p + "intermediate.dense"),
            "mlp_down": dense(p + "output.dense"),
        }
    params["ln_final"] = norm("layernorm")
    if "classifier.weight" in sd:  # ViTForImageClassification's head
        params["head"] = {"kernel": sd["classifier.weight"].T.copy(),
                          "bias": sd["classifier.bias"]}
    return _result(params, flax)


def adapt_vit_variables(
    variables: Mapping[str, Any],
    image_size: int,
    num_classes: Optional[int] = None,
):
    """Adapt ViT weights (a ``state_dict`` or a Flax tree; the result is of
    the same form) to another fine-tune geometry:

    - **position embeddings**: the 2-D grid of a checkpoint's ``pos_embed``
      is resized bilinearly (``jax.image.resize``'s weights, antialiased
      when it shrinks) to the new token grid; the CLS slot passes through;
    - **classifier head**: where ``num_classes`` differs from the
      checkpoint's head (or it has none), the head is replaced by a zero one.

    The input is not changed."""
    from sparkdl_tpu_torch.transformers.utils import resize_bilinear

    as_state_dict = _is_state_dict(variables)
    params = _flax_params(variables)
    patch = int(params["patch_embed"]["kernel"].shape[0])
    dim = int(params["patch_embed"]["kernel"].shape[-1])
    if image_size % patch:
        raise ValueError(f"image_size {image_size} is not a multiple of the "
                         f"checkpoint's patch size {patch}")
    grid = image_size // patch
    pos = np.asarray(params["pos_embed"], np.float32)
    tokens = int(pos.shape[1])
    if tokens != grid * grid + 1:
        src = int(round((tokens - 1) ** 0.5))
        if src * src != tokens - 1:
            raise ValueError(f"cannot adapt pos_embed with {tokens} tokens: not a "
                             "CLS + square grid")
        grid_pos = torch.from_numpy(pos[:, 1:].reshape(1, src, src, dim).copy())
        grid_pos = resize_bilinear(grid_pos, (grid, grid)).numpy()
        params["pos_embed"] = np.concatenate(
            [pos[:, :1], grid_pos.reshape(1, grid * grid, dim)], axis=1)
    if num_classes is not None:
        head = params.get("head")
        if head is None or int(np.shape(head["kernel"])[1]) != num_classes:
            params["head"] = {"kernel": np.zeros((dim, num_classes), np.float32),
                              "bias": np.zeros((num_classes,), np.float32)}
    return _result(params, flax=not as_state_dict)


def port_vit_npz(path, flax: bool = False):
    """A google-research/vision_transformer ``.npz`` checkpoint as the
    port's ``ViT`` ``state_dict`` (or, with ``flax``, the Flax-layout
    tree). The per-head query/key/value kernels ``(dim, heads, head_dim)``
    and the out kernel ``(heads, head_dim, dim)`` flatten into the fused
    ``qkv`` and ``proj``. A checkpoint with a ``pre_logits`` layer (the
    in21k pre-training variants) raises: the model has no such layer."""
    with np.load(path) as z:
        arrays = {name: z[name] for name in z.files}
    if any(n.startswith("pre_logits") for n in arrays):
        raise ValueError(f"{path} has a pre_logits head (an in21k pre-training "
                         "checkpoint); use a fine-tuned variant without it")
    params: Dict[str, Any] = {
        "patch_embed": {"kernel": arrays["embedding/kernel"],
                        "bias": arrays["embedding/bias"]},
        "cls_token": arrays["cls"],
        "pos_embed": arrays["Transformer/posembed_input/pos_embedding"],
        "ln_final": {"scale": arrays["Transformer/encoder_norm/scale"],
                     "bias": arrays["Transformer/encoder_norm/bias"]},
    }
    dim = int(params["patch_embed"]["kernel"].shape[-1])
    depth = 0
    while f"Transformer/encoderblock_{depth}/LayerNorm_0/scale" in arrays:
        depth += 1
    if depth == 0:
        raise ValueError(f"{path}: no encoderblock_* entries found")
    for i in range(depth):
        attn, mlp = _GR_ATTN.format(i=i), _GR_MLP.format(i=i)

        def ln(n):
            base = _GR_LN.format(i=i, n=n)
            return {"scale": arrays[base + "/scale"], "bias": arrays[base + "/bias"]}

        parts = [(arrays[f"{attn}/{w}/kernel"].reshape(dim, -1),
                  arrays[f"{attn}/{w}/bias"].reshape(-1)) for w in ("query", "key", "value")]
        params[f"block_{i}"] = {
            "ln_1": ln(0),
            "qkv": {"kernel": np.concatenate([k for k, _ in parts], axis=1),
                    "bias": np.concatenate([b for _, b in parts])},
            "proj": {"kernel": arrays[f"{attn}/out/kernel"].reshape(-1, dim),
                     "bias": arrays[f"{attn}/out/bias"]},
            "ln_2": ln(2),
            "mlp_up": {"kernel": arrays[f"{mlp}/Dense_0/kernel"],
                       "bias": arrays[f"{mlp}/Dense_0/bias"]},
            "mlp_down": {"kernel": arrays[f"{mlp}/Dense_1/kernel"],
                         "bias": arrays[f"{mlp}/Dense_1/bias"]},
        }
    if "head/kernel" in arrays:
        params["head"] = {"kernel": arrays["head/kernel"], "bias": arrays["head/bias"]}
    return _result(params, flax)


def export_vit_npz(variables: Mapping[str, Any], path, heads: Optional[int] = None) -> None:
    """Write ViT weights (a ``state_dict`` or a Flax tree) as a
    google-research/vision_transformer-named ``.npz``: the inverse of
    :func:`port_vit_npz`. ``heads`` defaults to the registry variant with
    the weights' width and depth; pass it for another geometry."""
    from sparkdl_tpu_torch.models.vit import VIT_VARIANTS

    params = _flax_params(variables)
    dim = int(np.shape(params["patch_embed"]["kernel"])[-1])
    depth = sum(1 for k in params if k.startswith("block_"))
    if heads is None:
        matches = [h for (_, d, dep, h, _) in VIT_VARIANTS.values() if d == dim and dep == depth]
        if not matches:
            raise ValueError(f"cannot infer heads for dim={dim} depth={depth}; pass "
                             "heads= explicitly")
        heads = matches[0]
    head_dim = dim // heads

    def a(x):
        return np.asarray(x)

    out: Dict[str, np.ndarray] = {
        "embedding/kernel": a(params["patch_embed"]["kernel"]),
        "embedding/bias": a(params["patch_embed"]["bias"]),
        "cls": a(params["cls_token"]),
        "Transformer/posembed_input/pos_embedding": a(params["pos_embed"]),
        "Transformer/encoder_norm/scale": a(params["ln_final"]["scale"]),
        "Transformer/encoder_norm/bias": a(params["ln_final"]["bias"]),
    }
    for i in range(depth):
        blk = params[f"block_{i}"]
        attn, mlp = _GR_ATTN.format(i=i), _GR_MLP.format(i=i)
        qkv_k, qkv_b = a(blk["qkv"]["kernel"]), a(blk["qkv"]["bias"])
        for j, which in enumerate(("query", "key", "value")):
            cols = slice(j * dim, (j + 1) * dim)
            out[f"{attn}/{which}/kernel"] = qkv_k[:, cols].reshape(dim, heads, head_dim)
            out[f"{attn}/{which}/bias"] = qkv_b[cols].reshape(heads, head_dim)
        out[f"{attn}/out/kernel"] = a(blk["proj"]["kernel"]).reshape(heads, head_dim, dim)
        out[f"{attn}/out/bias"] = a(blk["proj"]["bias"])
        for n, name in ((0, "ln_1"), (2, "ln_2")):
            out[_GR_LN.format(i=i, n=n) + "/scale"] = a(blk[name]["scale"])
            out[_GR_LN.format(i=i, n=n) + "/bias"] = a(blk[name]["bias"])
        out[f"{mlp}/Dense_0/kernel"] = a(blk["mlp_up"]["kernel"])
        out[f"{mlp}/Dense_0/bias"] = a(blk["mlp_up"]["bias"])
        out[f"{mlp}/Dense_1/kernel"] = a(blk["mlp_down"]["kernel"])
        out[f"{mlp}/Dense_1/bias"] = a(blk["mlp_down"]["bias"])
    if "head" in params:
        out["head/kernel"] = a(params["head"]["kernel"])
        out["head/bias"] = a(params["head"]["bias"])
    np.savez(path, **out)
