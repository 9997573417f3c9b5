"""Shared param mixins: a trimmed copy of ``sparkdl_tpu.param.shared``."""

from __future__ import annotations

from typing import Callable

from sparkdl_tpu_torch.param.base import Param, Params, TypeConverters


class HasInputCol(Params):
    inputCol = Param(
        "undefined", "inputCol", "input column name.", TypeConverters.toString
    )

    def setInputCol(self, value):
        return self._set(inputCol=value)

    def getInputCol(self):
        return self.getOrDefault(self.inputCol)


class HasOutputCol(Params):
    outputCol = Param(
        "undefined", "outputCol", "output column name.", TypeConverters.toString
    )

    def setOutputCol(self, value):
        return self._set(outputCol=value)

    def getOutputCol(self):
        return self.getOrDefault(self.outputCol)


class HasLabelCol(Params):
    labelCol = Param(
        "undefined",
        "labelCol",
        "name of the column storing the training data labels.",
        TypeConverters.toString,
    )

    def setLabelCol(self, value):
        return self._set(labelCol=value)

    def getLabelCol(self):
        return self.getOrDefault(self.labelCol)


class CanLoadImage(Params):
    """Mixin for stages taking an ``imageLoader`` callable:
    ``imageLoader(uri) -> np.ndarray`` loads and preprocesses one image."""

    imageLoader = Param(
        "undefined",
        "imageLoader",
        "Function containing the logic for loading and pre-processing one "
        "image URI into a numpy array.",
    )

    def setImageLoader(self, value: Callable):
        return self._set(imageLoader=value)

    def getImageLoader(self):
        return self.getOrDefault(self.imageLoader)
