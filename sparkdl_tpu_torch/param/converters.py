"""Domain type converters for the port's params: the part of
``sparkdl_tpu.param.converters`` that the graph transformers use.

The graph object is a :class:`~sparkdl_tpu_torch.graph.TorchFunction`
where the JAX package holds an ``XlaFunction``.
"""

from __future__ import annotations

from typing import Any

SUPPORTED_CHANNEL_ORDERS = ("RGB", "BGR", "L")


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
