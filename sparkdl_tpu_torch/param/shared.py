"""Shared param mixins: a trimmed copy of ``sparkdl_tpu.param.shared``."""

from __future__ import annotations

from typing import Callable

from sparkdl_tpu_torch.param.base import Param, Params, TypeConverters
from sparkdl_tpu_torch.param.converters import SparkDLTypeConverters


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


OUTPUT_MODES = ("vector", "image")


def _toOutputMode(value):
    if isinstance(value, str) and value.lower() in OUTPUT_MODES:
        return value.lower()
    raise ValueError("outputMode must be one of %s, got %r" % (OUTPUT_MODES, value))


class HasKerasModel(Params):
    # persistence: modelFile names a model artifact, so save() copies the
    # file into the save directory instead of recording a path that may go
    _file_params = ("modelFile",)

    modelFile = Param(
        "undefined",
        "modelFile",
        "h5py file containing the Keras model (architecture and weights)",
        TypeConverters.toString,
    )
    kerasFitParams = Param(
        "undefined",
        "kerasFitParams",
        "dict with parameters passed to Keras model fit method",
    )

    def setModelFile(self, value):
        return self._set(modelFile=value)

    def getModelFile(self):
        return self.getOrDefault(self.modelFile)

    def setKerasFitParams(self, value):
        return self._set(kerasFitParams=value)

    def getKerasFitParams(self):
        return self.getOrDefault(self.kerasFitParams)


class HasKerasOptimizer(Params):
    kerasOptimizer = Param(
        "undefined",
        "kerasOptimizer",
        "Name of the optimizer for training a Keras model",
        SparkDLTypeConverters.toKerasOptimizer,
    )

    def setKerasOptimizer(self, value):
        return self._set(kerasOptimizer=value)

    def getKerasOptimizer(self):
        return self.getOrDefault(self.kerasOptimizer)


class HasKerasLoss(Params):
    kerasLoss = Param(
        "undefined",
        "kerasLoss",
        "Name of the loss for training a Keras model",
        SparkDLTypeConverters.toKerasLoss,
    )

    def setKerasLoss(self, value):
        return self._set(kerasLoss=value)

    def getKerasLoss(self):
        return self.getOrDefault(self.kerasLoss)


class HasOutputMode(Params):
    outputMode = Param(
        "undefined",
        "outputMode",
        'how the output column should be formatted. "vector" for a 1-d MLlib '
        'Vector of floats. "image" to format the output to work with the '
        "image tools in this package.",
        _toOutputMode,
    )

    def setOutputMode(self, value):
        return self._set(outputMode=value)

    def getOutputMode(self):
        return self.getOrDefault(self.outputMode)


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


def _toDevice(value):
    """``None`` (the card) or a device name: ``"cuda"``, ``"cuda:1"``,
    ``"cpu"`` (a ``torch.device`` is kept by its name, so it persists)."""
    return None if value is None else str(value)


class HasDevice(Params):
    """Mixin for the port's stages: where they run. ``None`` is the card;
    without one the stage raises when it runs, unless ``"cpu"`` is set."""

    device = Param(
        "undefined",
        "device",
        "device the stage runs on: None (the CUDA card) or 'cpu'",
        _toDevice,
    )

    def getDevice(self):
        return self.getOrDefault(self.device)
