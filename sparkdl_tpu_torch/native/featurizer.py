"""Export the named-CNN featurizer for the native (C++) stack.

Port of ``sparkdl_tpu.native.featurizer``. The dual-stack featurizer: the
JAX package's counterpart of the Scala ``DeepImageFeaturizer``, which ran a
frozen graph with no Python. Here the frozen graph is an exported program
directory (:func:`~sparkdl_tpu_torch.native.aoti.export_program`: an
AOTInductor package, its weights in ``params.bin``) and the executor is
``aoti_tool`` (C++ alone) or the in-process
:class:`~sparkdl_tpu_torch.native.aoti.NativeProgram`.

The exported program is **the same function** the Python
``DeepImageFeaturizer`` runs: uint8 in, cast, resize, BGR handling,
preprocess, the CNN, float32 features, made by one function
(:func:`~sparkdl_tpu_torch.transformers.named_image.fused_forward`) for
both. Its weights are the module's parameters and batch-norm buffers, the
stem's folded BGR flip included, passed in through
``torch.func.functional_call``.
"""

from __future__ import annotations

import json
import os
import subprocess
import tempfile
from typing import Optional, Tuple

import numpy as np
import torch

from sparkdl_tpu_torch import native
from sparkdl_tpu_torch.native import aoti

_HERE = os.path.dirname(os.path.abspath(__file__))
_TOOL_SRC = os.path.join(_HERE, "aoti_tool.cpp")


def export_featurizer(
    model_name: str,
    batch_size: int,
    out_dir: str,
    source_hw: Optional[Tuple[int, int]] = None,
    model_weights="imagenet",
    compute_dtype: str = "bfloat16",
    device=None,
) -> dict:
    """Write a native featurizer program directory for ``device`` (``None``:
    the card).

    ``source_hw``: the (H, W) batches arrive at (uint8, stored BGR, NHWC:
    the image-struct convention); the model's input size by default.
    ``model_weights`` as ``DeepImageFeaturizer`` takes them. Named weights
    (a string, or None for ``"imagenet"``) make the export content
    addressable: an ``out_dir`` whose manifest carries the same fingerprint
    is already this export, and is returned as it is. Returns the
    manifest."""
    from sparkdl_tpu_torch.models.registry import get_keras_application_model
    from sparkdl_tpu_torch.obs.trace import tracer
    from sparkdl_tpu_torch.transformers.named_image import (
        _DTYPES,
        _resolve_weights,
        fused_forward,
    )
    from sparkdl_tpu_torch.utils.device import resolve_device
    from sparkdl_tpu_torch.utils.metrics import metrics

    entry = get_keras_application_model(model_name)
    if source_hw is None:
        source_hw = entry.input_size
    if compute_dtype not in _DTYPES:
        raise ValueError(f"compute_dtype must be one of {sorted(_DTYPES)}, "
                         f"got {compute_dtype!r}")
    device = resolve_device(device)

    fingerprint = None
    manifest_path = os.path.join(out_dir, "manifest.json")
    if model_weights is None or isinstance(model_weights, str):
        fingerprint = (
            f"featurizer:{model_name}:{model_weights or 'imagenet'}:"
            f"b{int(batch_size)}:{int(source_hw[0])}x{int(source_hw[1])}:"
            f"{compute_dtype}:{device.type}:torch={torch.__version__}"
        )
        try:
            with open(manifest_path) as fh:
                existing = json.load(fh)
        except (OSError, ValueError):
            existing = None
        if existing and existing.get("fingerprint") == fingerprint:
            metrics.counter("engine.cache_hit").add(1)
            return existing
        metrics.counter("engine.cache_miss").add(1)

    state = _resolve_weights(model_name, model_weights)
    module, body = fused_forward(model_name, state, _DTYPES[compute_dtype], True, device)
    params = {k: v.detach() for k, v in module.state_dict().items()}

    def forward(p, x):
        return body(x, lambda *a, **k: torch.func.functional_call(module, p, a, k))

    example = torch.zeros((int(batch_size), int(source_hw[0]), int(source_hw[1]), 3),
                          dtype=torch.uint8)
    with metrics.timer("engine.export").time(), tracer.span(
            "engine.export", program=f"featurizer_{model_name}",
            fingerprint=fingerprint or "", out_dir=out_dir):
        manifest = aoti.export_program(forward, params, [example], out_dir,
                                       input_names=["image"], device=device)
    if fingerprint is not None:
        manifest["fingerprint"] = fingerprint
        tmp = f"{manifest_path}.{os.getpid()}.tmp"
        with open(tmp, "w") as fh:
            json.dump(manifest, fh, indent=1)
        os.replace(tmp, manifest_path)
    return manifest


def tool_path() -> str:
    """Where the build of ``aoti_tool`` for the running torch lies (its
    flags name the runner library, whose name hashes the runner's build)."""
    return native.build_path("aoti_tool", [_TOOL_SRC], _tool_flags(), suffix="",
                             extra=[torch.__version__])


def _tool_flags():
    runner = aoti.library_path()
    return ["-O2", runner, f"-Wl,-rpath,{os.path.dirname(runner)}", *aoti.torch_link_flags()]


_tool = native.Once()


def build_tool() -> str:
    """Build ``aoti_tool`` (and the runner library it links) into
    ``native/_build/`` unless it is there, once a process; returns its path.
    Raises ``RuntimeError`` with the compiler's message on failure."""
    def make():
        aoti._load()
        return native.build([_TOOL_SRC], _tool_flags(), tool_path())

    return _tool.get(make)


def run_featurizer_cli(program_dir: str, batches, timeout: float = 900) -> np.ndarray:
    """Run the standalone ``aoti_tool`` over uint8 image batches shaped
    ``(n_batches, B, H, W, 3)`` and return the stacked float32 features,
    ``(n_batches, B, F)``. Builds the tool at first use; raises
    ``RuntimeError`` with the tool's message when it fails."""
    tool = build_tool()
    with open(os.path.join(program_dir, "manifest.json")) as fh:
        manifest = json.load(fh)
    (out_spec,) = manifest["outputs"]
    batches = np.ascontiguousarray(batches, np.uint8)
    with tempfile.TemporaryDirectory(prefix="aoti-tool-") as tmp:
        in_path = os.path.join(tmp, "in.bin")
        out_path = os.path.join(tmp, "out.bin")
        batches.tofile(in_path)
        proc = subprocess.run([tool, program_dir, in_path, out_path],
                              capture_output=True, text=True, timeout=timeout)
        if proc.returncode != 0:
            raise RuntimeError(f"aoti_tool failed ({proc.returncode}): {proc.stderr[-4000:]}")
        feats = np.fromfile(out_path, np.float32)
    return feats.reshape((batches.shape[0], *out_spec["shape"]))
