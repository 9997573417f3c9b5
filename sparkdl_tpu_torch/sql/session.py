"""``TorchSession``: the SparkSession analog of the port.

The part of ``sparkdl_tpu.sql.session`` that the port's transformers use:
``TorchSession.builder...getOrCreate()`` and ``createDataFrame``.
"""

from __future__ import annotations

from typing import Any, Iterable, List, Optional

from sparkdl_tpu_torch.sql.dataframe import DataFrame, Partition
from sparkdl_tpu_torch.sql.types import Row, StructType, infer_type

DEFAULT_PARTITIONS = 4


class _Builder:
    def __init__(self):
        self._appName = "sparkdl_tpu_torch"

    def master(self, _master: str) -> "_Builder":
        return self

    def appName(self, name: str) -> "_Builder":
        self._appName = name
        return self

    def getOrCreate(self) -> "TorchSession":
        if TorchSession._active is None:
            TorchSession._active = TorchSession(self._appName)
        return TorchSession._active


class TorchSession:
    _active: Optional["TorchSession"] = None

    builder = _Builder()

    def __init__(self, appName: str = "sparkdl_tpu_torch"):
        self.appName = appName
        TorchSession._active = self

    def createDataFrame(
        self,
        data: Iterable[Any],
        schema: "Optional[StructType | List[str]]" = None,
        numPartitions: int = DEFAULT_PARTITIONS,
    ) -> DataFrame:
        """Create a DataFrame from rows (Row / dict / tuple), split into
        ``numPartitions`` contiguous partitions."""
        rows = list(data)
        if rows and isinstance(rows[0], Row):
            names = list(rows[0]._fields)
            values = [tuple(r) for r in rows]
        elif rows and isinstance(rows[0], dict):
            names = list(rows[0].keys())
            values = [tuple(r[k] for k in names) for r in rows]
        else:
            if schema is None:
                raise ValueError("schema (column names) required for tuple data")
            names = (
                list(schema.names) if isinstance(schema, StructType) else list(schema)
            )
            values = [tuple(r) for r in rows]
        if isinstance(schema, (list, tuple)) and schema:
            names = list(schema)

        n = len(values)
        numPartitions = max(1, min(numPartitions, max(n, 1)))
        parts: List[Partition] = []
        for i in range(numPartitions):
            lo = i * n // numPartitions
            hi = (i + 1) * n // numPartitions
            chunk = values[lo:hi]
            parts.append(
                {c: [row[j] for row in chunk] for j, c in enumerate(names)}
            )
        st = StructType()
        for j, c in enumerate(names):
            if isinstance(schema, StructType):
                st.add(c, schema[c].dataType)
            else:
                probe = next(
                    (row[j] for row in values if row[j] is not None), None
                )
                st.add(c, infer_type(probe))
        return DataFrame(parts, st, self)
