"""Partitioned columnar DataFrame: the part of ``sparkdl_tpu.sql.dataframe``
that the port's transformers use.

Data lives as partitions of column -> list dicts; ``mapPartitions`` is the
primitive every model transformer builds on, so whole partitions reach the
batched model runner. The SQL dialect, joins and windows are not ported yet.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

from sparkdl_tpu_torch.sql.types import (
    DataType,
    ObjectType,
    Row,
    StructType,
    infer_type,
)

Partition = Dict[str, List[Any]]


def _partition_nrows(part: Partition) -> int:
    if not part:
        return 0
    return len(next(iter(part.values())))


class DataFrame:
    def __init__(
        self,
        partitions: List[Partition],
        schema: StructType,
        session: Any = None,
    ):
        self._partitions = partitions
        self._schema = schema
        self.sql_ctx = self.sparkSession = session

    @property
    def schema(self) -> StructType:
        return self._schema

    @property
    def columns(self) -> List[str]:
        return list(self._schema.names)

    def getNumPartitions(self) -> int:
        return len(self._partitions)

    def count(self) -> int:
        return sum(_partition_nrows(p) for p in self._partitions)

    def collect(self) -> List[Row]:
        names = self.columns
        rows: List[Row] = []
        for part in self._partitions:
            n = _partition_nrows(part)
            cols = [part[c] for c in names]
            rows.extend(Row._make(names, vals) for vals in zip(*cols))
            if n and not names:
                raise RuntimeError("partition with rows but no columns")
        return rows

    def _field_type(self, name: str) -> DataType:
        for f in self._schema:
            if f.name == name:
                return f.dataType
        return ObjectType()

    def mapPartitions(
        self,
        fn: Callable[[Partition], Partition],
        schema: Optional[StructType] = None,
    ) -> "DataFrame":
        """Apply ``fn`` to each partition's column dict -> new column dict."""
        out_parts = [fn(dict(part)) for part in self._partitions]
        if schema is None:
            schema = StructType()
            probe = next((p for p in out_parts if _partition_nrows(p)), None)
            cols = list(out_parts[0].keys()) if out_parts else []
            for c in cols:
                schema.add(
                    c, infer_type(probe[c][0]) if probe else self._field_type(c)
                )
        return DataFrame(out_parts, schema, self.sparkSession)

    def __repr__(self):
        cols = ", ".join(
            f"{f.name}: {f.dataType.simpleString()}" for f in self._schema
        )
        return f"DataFrame[{cols}]"
