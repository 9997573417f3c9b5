"""Spark-ML-compatible typed parameters (a trimmed copy of ``sparkdl_tpu.param``)."""

from sparkdl_tpu_torch.param.base import Param, Params, TypeConverters, keyword_only
from sparkdl_tpu_torch.param.shared import (
    CanLoadImage,
    HasInputCol,
    HasLabelCol,
    HasOutputCol,
)

__all__ = [
    "Param",
    "Params",
    "TypeConverters",
    "keyword_only",
    "HasInputCol",
    "HasLabelCol",
    "HasOutputCol",
    "CanLoadImage",
]
