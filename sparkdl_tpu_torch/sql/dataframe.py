"""Partitioned columnar DataFrame: the part of ``sparkdl_tpu.sql.dataframe``
that the port's transformers use.

Data lives as partitions of column -> list dicts; ``mapPartitions`` is the
primitive every model transformer builds on, so whole partitions reach the
batched model runner. ``select`` takes column names and
:class:`~sparkdl_tpu_torch.sql.functions.Column` references and UDF calls,
``withColumn`` a row-wise callable over named input columns, ``filter`` a
callable over rows, ``randomSplit`` draws as the JAX package's does, so one
seed splits the same rows, ``union`` appends partitions, and
``createOrReplaceTempView`` names the frame for ``session.table`` and
``session.sql``. The rest of the column expressions, of the SQL dialect,
joins and windows are not ported yet (ROADMAP item 14).
"""

from __future__ import annotations

import random
from typing import Any, Callable, Dict, List, Optional, Sequence

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

    def _with_partitions(
        self, partitions: List[Partition], schema: Optional[StructType] = None
    ) -> "DataFrame":
        return DataFrame(partitions, schema or self._schema, self.sparkSession)

    def _column_type(self, parts: List[Partition], name: str) -> DataType:
        """The type of the first non-None value of ``name``, else the
        schema's."""
        for part in parts:
            for value in part.get(name, ()):
                if value is not None:
                    return infer_type(value)
        return self._field_type(name)

    def _check_columns(self, names: Sequence[str]) -> None:
        missing = [c for c in names if c not in self.columns]
        if missing:
            raise KeyError(f"No such column(s): {missing}; have {self.columns}")

    def select(self, *cols: "Column | str") -> "DataFrame":
        """Project columns, in the order given: a name (``"*"`` is all) or a
        :class:`~sparkdl_tpu_torch.sql.functions.Column` (``col("x")``,
        ``udf("x").alias("y")``), evaluated a partition at a time."""
        from sparkdl_tpu_torch.sql.functions import Column

        if len(cols) == 1 and isinstance(cols[0], (list, tuple)):
            cols = tuple(cols[0])
        exprs: List[Any] = []
        for c in cols:
            if isinstance(c, Column):
                exprs.append(c)
            else:
                exprs.extend(self.columns if c == "*" else [c])
        self._check_columns([e for e in exprs if isinstance(e, str)])
        names = [e if isinstance(e, str) else e._name for e in exprs]
        parts = []
        for part in self._partitions:
            n = _partition_nrows(part)
            parts.append({name: part[e] if isinstance(e, str) else e._eval(part, n)
                          for name, e in zip(names, exprs)})
        schema = StructType()
        for name, e in zip(names, exprs):
            schema.add(name, self._field_type(e) if isinstance(e, str)
                       else self._column_type(parts, name))
        return self._with_partitions(parts, schema)

    def withColumn(self, name: str, fn: Callable, *input_cols: str) -> "DataFrame":
        """Add or replace column ``name`` with ``fn(*row values of
        input_cols)``, row by row."""
        if not input_cols:
            raise ValueError("withColumn needs the names of the columns fn reads")
        self._check_columns(input_cols)
        parts = []
        for part in self._partitions:
            new_part = dict(part)
            new_part[name] = [fn(*values) for values in zip(*(part[c] for c in input_cols))]
            parts.append(new_part)
        schema = StructType()
        for f in self._schema:
            if f.name != name:
                schema.add(f.name, f.dataType)
        schema.add(name, self._column_type(parts, name))
        return self._with_partitions(parts, schema)

    def filter(self, condition: Callable[[Row], bool]) -> "DataFrame":
        """Keep the rows for which ``condition(row)`` is true, in their
        partitions (the JAX package's callable form; column expressions are
        not ported)."""
        if not callable(condition):
            raise TypeError(
                f"filter takes a callable over rows, got {type(condition).__name__}"
            )
        names = self.columns
        parts = []
        for part in self._partitions:
            mask = [bool(condition(Row._make(names, vals)))
                    for vals in zip(*(part[c] for c in names))]
            parts.append({c: [v for v, m in zip(vals, mask) if m]
                          for c, vals in part.items()})
        return self._with_partitions(parts)

    where = filter

    def randomSplit(
        self, weights: Sequence[float], seed: Optional[int] = None
    ) -> List["DataFrame"]:
        """Split rows by ``weights``, keeping partitions: each row draws
        one ``random.Random(seed)`` number, in partition and row order, as
        ``sparkdl_tpu.sql.dataframe.DataFrame.randomSplit`` does."""
        rng = random.Random(seed)
        total_w = float(sum(weights))
        cum = []
        acc = 0.0
        for w in weights:
            acc += w / total_w
            cum.append(acc)
        buckets: List[List[Partition]] = [[] for _ in weights]
        names = self.columns
        for part in self._partitions:
            n = _partition_nrows(part)
            assignment = [
                next(i for i, c in enumerate(cum)
                     if rng.random() <= c or i == len(cum) - 1)
                for _ in range(n)
            ]
            for i in range(len(weights)):
                buckets[i].append(
                    {c: [v for v, a in zip(part[c], assignment) if a == i]
                     for c in names}
                )
        return [self._with_partitions(b) for b in buckets]

    def union(self, other: "DataFrame") -> "DataFrame":
        """The rows of both frames, this one's partitions first; the columns
        must be the same, in the same order."""
        if self.columns != other.columns:
            raise ValueError(
                f"Union requires same columns: {self.columns} vs {other.columns}"
            )
        return self._with_partitions(self._partitions + other._partitions)

    def createOrReplaceTempView(self, name: str) -> None:
        """Name this frame in its session, for ``session.table(name)`` and
        ``session.sql("... FROM name")``."""
        if self.sparkSession is None:
            raise RuntimeError("DataFrame has no session")
        self.sparkSession._views[name] = self

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
