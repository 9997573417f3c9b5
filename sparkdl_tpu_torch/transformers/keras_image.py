"""KerasImageFileTransformer: a URI column -> loaded images -> a Keras model.

Port of ``sparkdl_tpu.transformers.keras_image``: a user
``imageLoader(uri) -> ndarray`` loads and preprocesses each file, and the
``.keras`` / ``.h5`` model runs on ``device`` (the card unless ``"cpu"`` is
set) as a :class:`~sparkdl_tpu_torch.graph.TorchFunction` built from the
file without Keras (:meth:`TorchFunction.from_keras`), cached per (path,
mtime, dtype) with its params placed on the device once.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from sparkdl_tpu_torch.image import imageIO
from sparkdl_tpu_torch.ml.base import Transformer
from sparkdl_tpu_torch.ml.linalg import DenseVector
from sparkdl_tpu_torch.param.base import Param, TypeConverters, keyword_only
from sparkdl_tpu_torch.param.shared import (
    CanLoadImage,
    HasDevice,
    HasInputCol,
    HasKerasModel,
    HasOutputCol,
    HasOutputMode,
)
from sparkdl_tpu_torch.transformers.utils import (
    DEFAULT_BATCH_SIZE,
    load_keras_function,
    make_loader_decode_plan,
    run_batched_rows,
)
from sparkdl_tpu_torch.utils.device import resolve_device


class KerasImageFileTransformer(
    Transformer, HasInputCol, HasOutputCol, HasOutputMode, CanLoadImage,
    HasKerasModel, HasDevice
):
    batchSize = Param(
        "undefined", "batchSize", "rows per device batch", TypeConverters.toInt
    )
    computeDtype = Param(
        "undefined", "computeDtype",
        "'float32' (saved-model default) or 'bfloat16' (mixed policy: f32 "
        "variables, bf16 compute)",
        TypeConverters.toString,
    )

    @keyword_only
    def __init__(
        self,
        inputCol: Optional[str] = None,
        outputCol: Optional[str] = None,
        modelFile: Optional[str] = None,
        imageLoader=None,
        outputMode: str = "vector",
        batchSize: int = DEFAULT_BATCH_SIZE,
        computeDtype: str = "float32",
        device: Optional[str] = None,
    ):
        super().__init__()
        self._setDefault(outputMode="vector", batchSize=DEFAULT_BATCH_SIZE,
                         computeDtype="float32", device=None)
        kwargs = self._input_kwargs
        self.setParams(**kwargs)

    @keyword_only
    def setParams(
        self,
        inputCol: Optional[str] = None,
        outputCol: Optional[str] = None,
        modelFile: Optional[str] = None,
        imageLoader=None,
        outputMode: str = "vector",
        batchSize: int = DEFAULT_BATCH_SIZE,
        computeDtype: str = "float32",
        device: Optional[str] = None,
    ):
        kwargs = self._input_kwargs
        return self._set(**kwargs)

    def _transform(self, dataset):
        input_col = self.getInputCol()
        output_col = self.getOutputCol()
        loader = self.getImageLoader()
        mode = self.getOutputMode()
        batch_size = self.getOrDefault(self.batchSize)
        device = resolve_device(self.getDevice())

        fn = load_keras_function(
            self.getModelFile(),
            compute_dtype=self.getOrDefault(self.computeDtype),
        )
        params = fn.placed_params(device)

        def forward(x: torch.Tensor) -> torch.Tensor:
            with torch.inference_mode():
                return fn.apply(params, x)[0]

        def process_partition(part):
            uris = part[input_col]
            out = dict(part)
            if not uris:
                out[output_col] = []
                return out
            # chunk i+1 loads on a prefetch thread while chunk i runs; the
            # one-fixed-shape loader contract binds across chunks
            decode = make_loader_decode_plan(loader)
            result = run_batched_rows(forward, uris, decode, batch_size, device=device)
            if mode == "vector":
                flat = result.reshape(result.shape[0], -1).astype(np.float64)
                out[output_col] = [DenseVector(v) for v in flat]
            else:
                out[output_col] = [
                    imageIO.imageArrayToStruct(np.asarray(r, dtype=np.float32))
                    for r in result
                ]
            return out

        return dataset.mapPartitions(process_partition)
