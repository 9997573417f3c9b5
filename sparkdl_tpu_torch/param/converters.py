"""Domain type converters for the port's params: the part of
``sparkdl_tpu.param.converters`` that the graph transformers and the Keras
estimator use.

The graph object is a :class:`~sparkdl_tpu_torch.graph.TorchFunction`
where the JAX package holds an ``XlaFunction``.
"""

from __future__ import annotations

from typing import Any

SUPPORTED_CHANNEL_ORDERS = ("RGB", "BGR", "L")

# Keras loss / optimizer names the estimators resolve
# (sparkdl_tpu_torch.estimators.losses); kept as data so that the converters
# import no torch
KERAS_LOSS_NAMES = frozenset(
    {
        "categorical_crossentropy",
        "sparse_categorical_crossentropy",
        "binary_crossentropy",
        "mean_squared_error",
        "mse",
        "mean_absolute_error",
        "mae",
    }
)
KERAS_OPTIMIZER_NAMES = frozenset(
    {"sgd", "adam", "adamw", "rmsprop", "adagrad", "nadam", "lamb", "lion"}
)


class SparkDLTypeConverters:
    @staticmethod
    def toGraph(value: Any):
        """A TorchFunction, as it is (the JAX package's ``toXlaFunction``)."""
        from sparkdl_tpu_torch.graph.function import TorchFunction

        if isinstance(value, TorchFunction):
            return value
        raise TypeError("Could not convert %s to TorchFunction" % type(value))

    toTorchFunction = toGraph

    @staticmethod
    def toChannelOrder(value: Any) -> str:
        if isinstance(value, str) and value.upper() in SUPPORTED_CHANNEL_ORDERS:
            return value.upper()
        raise TypeError(
            "Channel order must be one of %s, got %r"
            % (SUPPORTED_CHANNEL_ORDERS, value)
        )

    @staticmethod
    def toStringOrTensorName(value: Any) -> str:
        """A plain output name (the TF-tensor analog)."""
        if isinstance(value, str):
            return value
        raise TypeError("Could not convert %r to an output name" % (value,))

    @staticmethod
    def toKerasLoss(value: Any):
        if callable(value):
            return value
        if isinstance(value, str) and value.lower() in KERAS_LOSS_NAMES:
            return value.lower()
        raise ValueError(
            "Named loss not supported in Keras or unknown: %r" % (value,)
        )

    @staticmethod
    def toKerasOptimizer(value: Any):
        """A name (lower-cased), or a callable ``params ->
        torch.optim.Optimizer``: the port's counterpart of the pre-built
        optax transformation the JAX package takes."""
        if isinstance(value, str) and value.lower() in KERAS_OPTIMIZER_NAMES:
            return value.lower()
        if callable(value):
            return value
        raise ValueError(
            "Named optimizer not supported or unknown: %r" % (value,)
        )
