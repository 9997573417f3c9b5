"""registerKerasImageUDF: serve a Keras model as a SQL UDF over images.

Port of ``sparkdl_tpu.udf.keras_image_model``. The struct decode, the
channel-order fix, the resize and the model's forward run as one vectorized
UDF, batched through the same
:func:`~sparkdl_tpu_torch.transformers.utils.run_batched_rows` loop as the
pipeline transformers, on ``device`` (the card unless ``"cpu"`` is set):

- without ``preprocessor`` the UDF takes an image-struct column (Spark's
  ImageSchema layout, stored BGR). The structs are decoded, grayscale and
  RGBA made three channels, flipped BGR -> RGB, and on the device cast to
  float32 and resized to the model's spatial input size: the model sees
  ``[0, 255]`` RGB, exactly what Keras on the decoded arrays would see;
- with ``preprocessor`` the UDF takes a column of file paths, and
  ``preprocessor(path) -> ndarray`` does all the loading and preprocessing;
  its output goes to the model unchanged.

The UDF (and the copy the session's registry keeps) carries
``_serving_endpoint``: the fused forward (cast, resize and model) with the
placed params it takes, its item contract and the fingerprint ``keras_udf:<file fingerprint>:<size>``, so
that ``ModelServer.from_registered_udf`` serves the same model online,
compiled ahead of time through the engine and persisted under that
fingerprint. The SQL batch path itself runs the forward eagerly, where the
JAX package compiles it through its engine: an AOTInductor compile of every
batch stage would cost minutes a model before its first row (ROADMAP item D
asks whether it pays on the card's host-bound forwards).
"""

from __future__ import annotations

import os
from typing import Any, Callable, Optional

import numpy as np
import torch

from sparkdl_tpu_torch.graph.function import TorchFunction
from sparkdl_tpu_torch.ml.linalg import DenseVector
from sparkdl_tpu_torch.sql.functions import UserDefinedFunction
from sparkdl_tpu_torch.transformers.utils import (
    DEFAULT_BATCH_SIZE,
    MixedImageSizesError,
    cast_and_resize_on_device,
    load_keras_function,
    make_image_decode_plan,
    make_loader_decode_plan,
    run_batched_rows,
)
from sparkdl_tpu_torch.utils.device import resolve_device


def _resolve_model(model_or_file, compute_dtype=None) -> TorchFunction:
    if isinstance(model_or_file, (str, os.PathLike)):
        # one cached function per (path, mtime, dtype) across the
        # transformers and the UDFs
        return load_keras_function(os.fspath(model_or_file), compute_dtype=compute_dtype)
    return TorchFunction.from_keras(model_or_file, compute_dtype=compute_dtype)


def registerKerasImageUDF(
    udfName: str,
    keras_model_or_file: Any,
    preprocessor: Optional[Callable[[str], np.ndarray]] = None,
    session=None,
    batchSize: int = DEFAULT_BATCH_SIZE,
    computeDtype: Optional[str] = "float32",
    device: Optional[str] = None,
) -> UserDefinedFunction:
    """Register ``udfName`` so ``SELECT udfName(image) FROM view`` runs the
    model, and return the :class:`UserDefinedFunction` (also usable in
    ``DataFrame.select``). Output rows are ``DenseVector``s of the flattened
    model output.

    ``computeDtype="bfloat16"`` narrows the compute (the variables stay
    float32), as ``KerasImageFileTransformer``'s param does. File paths
    only: an in-memory model already carries its own dtype policy."""
    if computeDtype not in (None, "float32") and not isinstance(
        keras_model_or_file, (str, os.PathLike)
    ):
        raise ValueError(
            f"computeDtype={computeDtype!r} applies when serving from a "
            "saved model file; an in-memory model already carries its "
            "dtype policy; build it under a keras mixed policy instead"
        )
    fn = _resolve_model(keras_model_or_file, compute_dtype=computeDtype)
    size = getattr(fn, "input_hw", None)
    device = resolve_device(device)
    # contiguous, so that the online endpoint (which takes its weights
    # contiguous) shares this copy
    params = {k: v.contiguous() for k, v in fn.placed_params(device).items()}

    def forward_core(p, x: torch.Tensor) -> torch.Tensor:
        # batches arrive at source size (uint8 where they can): cast and
        # resize on the device, then the model
        return fn.apply(p, cast_and_resize_on_device(x, size))[0]

    def forward(x: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return forward_core(params, x)

    def evaluate(values):
        if not values:
            return []
        if preprocessor is not None:
            # the preprocessor owns the input contract: one fixed output
            # shape, enforced across chunk boundaries
            decode = make_loader_decode_plan(
                preprocessor, what=f"UDF {udfName!r} preprocessor"
            )
        else:
            # stored BGR -> model RGB while packing; the plan (shape and
            # dtype) is decided over the whole partition
            try:
                decode = make_image_decode_plan(values, size, device=device,
                                                n_channels=3, to_rgb=True)
            except MixedImageSizesError as e:
                raise ValueError(
                    f"UDF {udfName!r}: model input size is dynamic and "
                    "the column holds mixed shapes; resize in a "
                    "preprocessor or use a fixed-input-size model"
                ) from e
        result = run_batched_rows(forward, values, decode, batchSize, device=device)
        flat = result.reshape(result.shape[0], -1).astype(np.float64)
        return [DenseVector(v) for v in flat]

    udf = UserDefinedFunction(evaluate, name=udfName, vectorized=True)
    # the online-serving hook: the fused forward and its item contract, for
    # ModelServer.from_registered_udf (which compiles it). A file-loader UDF
    # keeps item_shape=None: the first request binds it
    base_fp = getattr(fn, "fingerprint", None)
    udf._serving_endpoint = {
        "model_id": udfName,
        "forward": forward_core,
        "params": params,
        "item_shape": (size[0], size[1], 3) if size is not None else None,
        "dtype": np.float32,
        "device": device,
        "fingerprint": f"keras_udf:{base_fp}:{size}" if base_fp else None,
    }
    from sparkdl_tpu_torch.sql.session import TorchSession

    session = session or TorchSession.getActiveSession()
    registered = session.udf.register(udfName, udf)
    # the registry re-wraps the UDF: the hook rides on its copy too
    registered._serving_endpoint = udf._serving_endpoint
    return udf
