"""Spark-ML-compatible typed parameters (a trimmed copy of ``sparkdl_tpu.param``)."""

from sparkdl_tpu_torch.param.base import Param, Params, TypeConverters, keyword_only
from sparkdl_tpu_torch.param.converters import SparkDLTypeConverters
from sparkdl_tpu_torch.param.shared import (
    CanLoadImage,
    HasDevice,
    HasInputCol,
    HasLabelCol,
    HasOutputCol,
    HasOutputMode,
)

__all__ = [
    "Param",
    "Params",
    "TypeConverters",
    "SparkDLTypeConverters",
    "keyword_only",
    "HasDevice",
    "HasInputCol",
    "HasLabelCol",
    "HasOutputCol",
    "HasOutputMode",
    "CanLoadImage",
]
