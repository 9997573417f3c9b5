"""KerasTransformer: a saved Keras model over a 1-D array column.

Port of ``sparkdl_tpu.transformers.keras_tensor``: the file is read into a
:class:`~sparkdl_tpu_torch.graph.TorchFunction` without Keras
(:meth:`TorchFunction.from_keras`, cached per path and mtime) and the rows
run through :class:`~sparkdl_tpu_torch.transformers.tf_tensor.TFTransformer`
on ``device`` (the card unless ``"cpu"`` is set).
"""

from __future__ import annotations

from typing import Optional

from sparkdl_tpu_torch.ml.base import Transformer
from sparkdl_tpu_torch.param.base import Param, TypeConverters, keyword_only
from sparkdl_tpu_torch.param.shared import (
    HasDevice,
    HasInputCol,
    HasKerasModel,
    HasOutputCol,
)
from sparkdl_tpu_torch.transformers.tf_tensor import TFTransformer
from sparkdl_tpu_torch.transformers.utils import (
    DEFAULT_BATCH_SIZE,
    load_keras_function,
)


class KerasTransformer(Transformer, HasInputCol, HasOutputCol, HasKerasModel, HasDevice):
    batchSize = Param(
        "undefined", "batchSize", "rows per device batch", TypeConverters.toInt
    )

    @keyword_only
    def __init__(
        self,
        inputCol: Optional[str] = None,
        outputCol: Optional[str] = None,
        modelFile: Optional[str] = None,
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
        inputCol: Optional[str] = None,
        outputCol: Optional[str] = None,
        modelFile: Optional[str] = None,
        batchSize: int = DEFAULT_BATCH_SIZE,
        device: Optional[str] = None,
    ):
        kwargs = self._input_kwargs
        return self._set(**kwargs)

    def _transform(self, dataset):
        fn = load_keras_function(self.getModelFile())
        delegate = TFTransformer(
            tfInputGraph=fn,
            inputMapping={self.getInputCol(): fn.input_names[0]},
            outputMapping={fn.output_names[0]: self.getOutputCol()},
            batchSize=self.getOrDefault(self.batchSize),
            device=self.getDevice(),
        )
        return delegate._transform(dataset)
