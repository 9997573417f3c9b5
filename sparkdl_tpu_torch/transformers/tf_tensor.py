"""TFTransformer: a TorchFunction over tensor (1-D array) columns.

Port of ``sparkdl_tpu.transformers.tf_tensor``. ``inputMapping`` routes
columns to the function's named inputs and ``outputMapping`` its named
outputs back to columns; the rows run in batches on ``device`` (the card
unless ``"cpu"`` is set). Integer columns stay integral (int32), float
columns become float32.

The name of the original stage is kept; ``TorchTransformer`` is the port's
own spelling.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from sparkdl_tpu_torch.ml.base import Transformer
from sparkdl_tpu_torch.param.base import Param, TypeConverters, keyword_only
from sparkdl_tpu_torch.param.converters import SparkDLTypeConverters
from sparkdl_tpu_torch.param.shared import HasDevice
from sparkdl_tpu_torch.transformers.utils import DEFAULT_BATCH_SIZE, run_batched_multi
from sparkdl_tpu_torch.utils.device import resolve_device


def _column_batch(values) -> np.ndarray:
    """A column's rows as one array: integers as int32 (embedding ids,
    one-hot indices keep their values), anything else as float32."""
    first = np.asarray(values[0])
    dtype = np.int32 if np.issubdtype(first.dtype, np.integer) else np.float32
    return np.stack([np.asarray(v, dtype=dtype) for v in values])


class TFTransformer(Transformer, HasDevice):
    tfInputGraph = Param(
        "undefined",
        "tfInputGraph",
        "TorchFunction to run over the tensor columns",
        SparkDLTypeConverters.toGraph,
    )
    inputMapping = Param(
        "undefined",
        "inputMapping",
        "dict: DataFrame column name -> function input name",
    )
    outputMapping = Param(
        "undefined",
        "outputMapping",
        "dict: function output name -> new DataFrame column name",
    )
    batchSize = Param(
        "undefined", "batchSize", "rows per device batch", TypeConverters.toInt
    )

    @keyword_only
    def __init__(
        self,
        tfInputGraph=None,
        inputMapping: Optional[Dict[str, str]] = None,
        outputMapping: Optional[Dict[str, str]] = None,
        batchSize: int = DEFAULT_BATCH_SIZE,
        device: Optional[str] = None,
    ):
        super().__init__()
        self._setDefault(batchSize=DEFAULT_BATCH_SIZE, device=None)
        kwargs = self._input_kwargs
        self.setParams(**kwargs)

    @keyword_only
    def setParams(
        self,
        tfInputGraph=None,
        inputMapping: Optional[Dict[str, str]] = None,
        outputMapping: Optional[Dict[str, str]] = None,
        batchSize: int = DEFAULT_BATCH_SIZE,
        device: Optional[str] = None,
    ):
        kwargs = self._input_kwargs
        return self._set(**kwargs)

    def _transform(self, dataset):
        fn = self.getOrDefault(self.tfInputGraph)
        input_mapping = dict(self.getOrDefault(self.inputMapping))
        output_mapping = dict(self.getOrDefault(self.outputMapping))
        batch_size = self.getOrDefault(self.batchSize)

        unknown_in = set(input_mapping.values()) - set(fn.input_names)
        unknown_out = set(output_mapping) - set(fn.output_names)
        if unknown_in:
            raise ValueError(f"Unknown function inputs: {sorted(unknown_in)}")
        if unknown_out:
            raise ValueError(f"Unknown function outputs: {sorted(unknown_out)}")
        # columns in the order of the function's positional inputs; the
        # mapping must cover every input exactly once
        col_for_input = {v: k for k, v in input_mapping.items()}
        if len(col_for_input) != len(input_mapping):
            raise ValueError(
                "inputMapping maps multiple columns to the same function "
                f"input: {input_mapping}"
            )
        missing = set(fn.input_names) - set(col_for_input)
        if missing:
            raise ValueError(
                f"inputMapping does not cover function inputs {sorted(missing)}"
            )
        ordered_cols = [col_for_input[name] for name in fn.input_names]
        device = resolve_device(self.getDevice())
        params = fn.placed_params(device)

        def forward(*xs):
            with torch.inference_mode():
                return fn.apply(params, *xs)

        def process_partition(part):
            out = dict(part)
            if not part[ordered_cols[0]]:
                for col in output_mapping.values():
                    out[col] = []
                return out
            columns = [_column_batch(part[c]) for c in ordered_cols]
            results = run_batched_multi(forward, columns, batch_size, device=device)
            by_name = dict(zip(fn.output_names, results))
            for name, col in output_mapping.items():
                out[col] = [np.asarray(v) for v in by_name[name]]
            return out

        return dataset.mapPartitions(process_partition)


# The port's own spelling.
TorchTransformer = TFTransformer
