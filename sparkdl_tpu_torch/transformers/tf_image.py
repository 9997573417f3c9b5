"""TFImageTransformer: a TorchFunction over an image column.

Port of ``sparkdl_tpu.transformers.tf_image``. The image structs are decoded
on the host (:func:`~sparkdl_tpu_torch.transformers.utils.make_image_decode_plan`);
per batch, on ``device`` (the card unless ``"cpu"`` is set), the batch is
cast to float32, resized to ``inputShape`` and flipped from the stored BGR
order to RGB where the function wants RGB, then the function runs. The
output is an MLlib vector per row, or an image struct per row.

The name of the original stage is kept; ``TorchImageTransformer`` is the
port's own spelling.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from sparkdl_tpu_torch.image import imageIO
from sparkdl_tpu_torch.ml.base import Transformer
from sparkdl_tpu_torch.ml.linalg import DenseVector
from sparkdl_tpu_torch.param.base import Param, TypeConverters, keyword_only
from sparkdl_tpu_torch.param.converters import SparkDLTypeConverters
from sparkdl_tpu_torch.param.shared import (
    HasDevice,
    HasInputCol,
    HasOutputCol,
    HasOutputMode,
)
from sparkdl_tpu_torch.transformers.utils import (
    DEFAULT_BATCH_SIZE,
    cast_and_resize_on_device,
    make_image_decode_plan,
    place_params,
    run_batched_rows,
)
from sparkdl_tpu_torch.utils.device import resolve_device


class TFImageTransformer(Transformer, HasInputCol, HasOutputCol, HasOutputMode, HasDevice):
    """Applies a single-output :class:`~sparkdl_tpu_torch.graph.TorchFunction`
    to an image-struct column.

    ``channelOrder`` is the order the function expects its input channels
    in ('RGB', 'BGR', or 'L', one luminance channel); image structs are
    stored BGR (Spark's convention), and the flip to RGB runs on the device.
    The function takes a float32 NHWC batch."""

    graph = Param(
        "undefined",
        "graph",
        "TorchFunction to apply to the image column",
        SparkDLTypeConverters.toGraph,
    )
    inputShape = Param(
        "undefined",
        "inputShape",
        "(height, width) the function expects; images are resized on the "
        "device. None runs images at their stored size (they must then be "
        "of one size).",
    )
    channelOrder = Param(
        "undefined",
        "channelOrder",
        "channel order the function expects: 'RGB', 'BGR' or 'L'",
        SparkDLTypeConverters.toChannelOrder,
    )
    batchSize = Param(
        "undefined", "batchSize", "rows per device batch", TypeConverters.toInt
    )

    @keyword_only
    def __init__(
        self,
        inputCol: Optional[str] = None,
        outputCol: Optional[str] = None,
        graph=None,
        inputShape: Optional[Tuple[int, int]] = None,
        channelOrder: str = "RGB",
        outputMode: str = "vector",
        batchSize: int = DEFAULT_BATCH_SIZE,
        device: Optional[str] = None,
    ):
        super().__init__()
        self._setDefault(
            inputShape=None,
            channelOrder="RGB",
            outputMode="vector",
            batchSize=DEFAULT_BATCH_SIZE,
            device=None,
        )
        kwargs = self._input_kwargs
        self.setParams(**kwargs)

    @keyword_only
    def setParams(
        self,
        inputCol: Optional[str] = None,
        outputCol: Optional[str] = None,
        graph=None,
        inputShape: Optional[Tuple[int, int]] = None,
        channelOrder: str = "RGB",
        outputMode: str = "vector",
        batchSize: int = DEFAULT_BATCH_SIZE,
        device: Optional[str] = None,
    ):
        kwargs = self._input_kwargs
        return self._set(**kwargs)

    def setGraph(self, value):
        return self._set(graph=value)

    def getGraph(self):
        return self.getOrDefault(self.graph)

    def _transform(self, dataset):
        input_col = self.getInputCol()
        output_col = self.getOutputCol()
        fn = self.getGraph()
        size = self.getOrDefault(self.inputShape)
        order = self.getOrDefault(self.channelOrder)
        mode = self.getOutputMode()
        batch_size = self.getOrDefault(self.batchSize)
        device = resolve_device(self.getDevice())

        if len(fn.output_names) != 1:
            raise ValueError(
                "TFImageTransformer requires a single-output TorchFunction "
                f"(got outputs {fn.output_names}); use TFTransformer with an "
                "outputMapping for multi-output functions."
            )
        params = place_params(fn.params, device)
        want_bgr = order == "BGR"

        def forward(x: torch.Tensor) -> torch.Tensor:
            # x: uint8 or float32 NHWC in stored (BGR) order, at source size
            with torch.inference_mode():
                x = cast_and_resize_on_device(x, size)
                if not want_bgr and x.shape[-1] == 3:
                    x = x.flip(-1)
                return fn.apply(params, x)[0]

        n_channels = 1 if order == "L" else 3

        def process_partition(part):
            rows = part[input_col]
            out = dict(part)
            if not rows:
                out[output_col] = []
                return out
            # the decode policy (shape, dtype) is decided over the whole
            # partition; mixed sizes without an inputShape raise
            decode = make_image_decode_plan(rows, size, device=device,
                                            n_channels=n_channels)
            result = run_batched_rows(forward, rows, decode, batch_size, device=device)
            if mode == "vector":
                flat = result.reshape(result.shape[0], -1).astype(np.float64)
                out[output_col] = [DenseVector(v) for v in flat]
            else:  # "image"
                out[output_col] = [
                    imageIO.imageArrayToStruct(np.asarray(img, dtype=np.float32), origin="")
                    for img in result
                ]
            return out

        return dataset.mapPartitions(process_partition)


# The port's own spelling.
TorchImageTransformer = TFImageTransformer
