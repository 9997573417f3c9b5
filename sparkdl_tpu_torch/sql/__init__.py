"""DataFrame, Row, columns, UDFs and session: the part of ``sparkdl_tpu.sql``
the port uses."""

from sparkdl_tpu_torch.sql.dataframe import DataFrame
from sparkdl_tpu_torch.sql.functions import Column, UserDefinedFunction, col, udf
from sparkdl_tpu_torch.sql.session import TorchSession
from sparkdl_tpu_torch.sql.types import Row, StructType

__all__ = ["Column", "DataFrame", "Row", "StructType", "TorchSession",
           "UserDefinedFunction", "col", "udf"]
