"""The port's columnar dataframe engine, SQL dialect and continuous SQL:
``sparkdl_tpu.sql`` under the port's names.

Partitioned columnar data, column expressions, joins, set operations,
window functions and grouped aggregates, Python UDF registration (model
UDFs score batched on the card), temp views, ``TorchSession.sql`` and
standing windowed queries over stream tables (``TorchSession.sqlStream``).

The continuous-SQL names resolve lazily (PEP 562): ``sql.continuous``
imports the serving and streaming packages, which import
``sql.types`` through ``image/imageIO.py``, so an eager import here would
close that cycle for whichever of them is imported first.
"""

import importlib

from sparkdl_tpu_torch.sql.types import Row, StructType
from sparkdl_tpu_torch.sql.dataframe import DataFrame
from sparkdl_tpu_torch.sql.session import TorchSession
from sparkdl_tpu_torch.sql.functions import Column, UserDefinedFunction, col, lit, udf

_LAZY = {
    "ContinuousPlan": "sparkdl_tpu_torch.sql.continuous",
    "ContinuousQuery": "sparkdl_tpu_torch.sql.continuous",
    "ContinuousQueryError": "sparkdl_tpu_torch.sql.continuous",
    "StreamTable": "sparkdl_tpu_torch.sql.continuous",
    "StreamTableError": "sparkdl_tpu_torch.sql.continuous",
    "WindowStateStore": "sparkdl_tpu_torch.sql.window_state",
}

__all__ = [
    "Column",
    "ContinuousPlan",
    "ContinuousQuery",
    "ContinuousQueryError",
    "DataFrame",
    "Row",
    "StreamTable",
    "StreamTableError",
    "StructType",
    "TorchSession",
    "UserDefinedFunction",
    "WindowStateStore",
    "col",
    "lit",
    "udf",
]


def __getattr__(name):
    if name in _LAZY:
        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
