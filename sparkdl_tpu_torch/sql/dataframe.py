"""Partitioned columnar DataFrame: the port's copy of
``sparkdl_tpu.sql.dataframe`` (host Python, unchanged but for its imports).

Data lives as partitions of column→list dicts; ``mapPartitions`` is the
primitive every model transformer builds on (the ``TensorFrames
map_blocks`` analog: whole partitions reach the batched model runner).
Column expressions, joins, set operations, window functions, grouped
aggregates and pivots evaluate on the host, row for row as the JAX
package's do. Interop: ``to_arrow``/``toPandas`` for columnar exchange
(``pandas`` and ``pyarrow`` are imported only where they are used).
"""

from __future__ import annotations

import math
import random as _random
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence

from sparkdl_tpu_torch.sql.functions import Column, col as _col
from sparkdl_tpu_torch.sql.types import (
    DataType,
    Row,
    StructField,
    StructType,
    infer_type,
)

Partition = Dict[str, List[Any]]

#: accepted ``how`` spellings (pyspark's aliases) -> canonical join type
_JOIN_HOW: Dict[str, str] = {
    "inner": "inner",
    "left": "left", "left_outer": "left", "leftouter": "left",
    "right": "right", "right_outer": "right", "rightouter": "right",
    "outer": "full", "full": "full",
    "full_outer": "full", "fullouter": "full",
}


def _dedupe_key(v):
    """A hashable full-content fingerprint of one cell for
    dropDuplicates.  repr() would truncate large numpy arrays (numpy
    elides the middle with '...'), silently collapsing distinct feature
    vectors — arrays fingerprint by (shape, dtype, bytes) instead."""
    try:
        hash(v)
        return v
    except TypeError:
        pass
    import numpy as np  # after the fast path: hot per-cell loop

    if isinstance(v, np.ndarray):
        return (v.shape, v.dtype.str, v.tobytes())
    if isinstance(v, (list, tuple)):
        return tuple(_dedupe_key(x) for x in v)
    if isinstance(v, dict):
        # mixed-type dict keys (int and str) would make a bare sorted()
        # raise TypeError mid-dropDuplicates; but numeric keys must stay
        # mutually ordered by VALUE (equal dicts may spell a key 2 vs
        # 2.0 — a type-name tag alone would order them differently and
        # split one fingerprint into two)
        def rank(kv):
            k = kv[0]
            if isinstance(k, (int, float)):
                return (0, float(k), "")
            return (1, type(k).__name__, repr(k))

        return tuple(
            sorted(((k, _dedupe_key(x)) for k, x in v.items()), key=rank)
        )
    return repr(v)


def _disjoint_tmp_names(n: int, taken) -> List[str]:
    """``n`` temp column names guaranteed absent from ``taken`` (a
    two-phase positional rename with colliding temps would silently
    clobber real columns)."""
    taken = set(taken)
    base = "__tmp"
    while any(f"{base}_{i}" in taken for i in range(n)):
        base += "_"
    return [f"{base}_{i}" for i in range(n)]


def _partition_nrows(part: Partition) -> int:
    if not part:
        return 0
    return len(next(iter(part.values())))


def _infer_column_type(parts: List[Partition], name: str, fallback):
    """Type of the first non-None value anywhere in the column — a probe of
    just the first partition's first row degrades to untyped whenever that
    row is empty or None.  ``fallback()`` supplies the prior schema's type
    when the whole column is empty/None."""
    for part in parts:
        for v in part.get(name, ()):
            if v is not None:
                return infer_type(v)
    return fallback()


class DataFrame:
    def __init__(
        self,
        partitions: List[Partition],
        schema: StructType,
        session: "Any" = None,
    ):
        self._partitions = partitions
        self._schema = schema
        self.sql_ctx = self.sparkSession = session

    # ------------------------------------------------------------------
    # metadata
    # ------------------------------------------------------------------
    @property
    def schema(self) -> StructType:
        return self._schema

    @property
    def columns(self) -> List[str]:
        return list(self._schema.names)

    def printSchema(self):
        print(self._schema.simpleString())

    def getNumPartitions(self) -> int:
        return len(self._partitions)

    def count(self) -> int:
        return sum(_partition_nrows(p) for p in self._partitions)

    # ------------------------------------------------------------------
    # actions
    # ------------------------------------------------------------------
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

    def take(self, num: int) -> List[Row]:
        return self.limit(num).collect()

    def head(self, n: Optional[int] = None):
        if n is None:
            rows = self.take(1)
            return rows[0] if rows else None
        return self.take(n)

    def first(self):
        return self.head()

    def show(self, n: int = 20, truncate: bool = True):
        rows = self.take(n)
        print(" | ".join(self.columns))
        for r in rows:
            cells = []
            for v in r:
                s = repr(v)
                if truncate and len(s) > 24:
                    s = s[:21] + "..."
                cells.append(s)
            print(" | ".join(cells))

    def toPandas(self):
        import pandas as pd

        names = self.columns
        data = {c: [] for c in names}
        for part in self._partitions:
            for c in names:
                data[c].extend(part[c])
        return pd.DataFrame(data)

    def to_arrow(self):
        """Best-effort conversion of arrow-compatible columns to a pyarrow
        Table (object/ndarray columns are converted via python lists)."""
        import pyarrow as pa

        names = self.columns
        data = {c: [] for c in names}
        for part in self._partitions:
            for c in names:
                data[c].extend(part[c])
        return pa.table({c: pa.array(vals) for c, vals in data.items()})

    # ------------------------------------------------------------------
    # transformations
    # ------------------------------------------------------------------
    def _with_partitions(
        self, partitions: List[Partition], schema: Optional[StructType] = None
    ) -> "DataFrame":
        return DataFrame(partitions, schema or self._schema, self.sparkSession)

    def select(self, *cols: "Column | str") -> "DataFrame":
        if len(cols) == 1 and isinstance(cols[0], (list, tuple)):
            cols = tuple(cols[0])
        exprs: List[Column] = []
        for c in cols:
            if isinstance(c, str):
                if c == "*":
                    exprs.extend(_col(name) for name in self.columns)
                else:
                    exprs.append(_col(c))
            else:
                exprs.append(c)
        if any(hasattr(e, "_window") for e in exprs):
            # window-bound expressions (F.row_number().over(w)) need the
            # whole-frame evaluators: materialize each as a hidden
            # column first, then project
            base = self
            final_exprs: List[Column] = []
            for j, e in enumerate(exprs):
                if hasattr(e, "_window"):
                    h = f"__winsel_{j}"
                    while h in base.columns:
                        h = "_" + h
                    base = base._apply_window_marker(h, e)
                    final_exprs.append(_col(h).alias(e._name))
                else:
                    final_exprs.append(e)
            return base.select(*final_exprs)
        out_parts: List[Partition] = []
        for part in self._partitions:
            n = _partition_nrows(part)
            out_parts.append({e._name: e._eval(part, n) for e in exprs})
        new_schema = StructType()
        for e in exprs:
            new_schema.add(
                e._name,
                _infer_column_type(
                    out_parts, e._name, lambda: self._field_type(e._name)
                ),
            )
        return self._with_partitions(out_parts, new_schema)

    def _field_type(self, name: str) -> DataType:
        for f in self._schema:
            if f.name == name:
                return f.dataType
        from sparkdl_tpu_torch.sql.types import ObjectType

        return ObjectType()

    def withColumn(
        self,
        name: str,
        value: "Column | Callable",
        *input_cols: str,
    ) -> "DataFrame":
        """Add/replace a column.  ``value`` is a Column expression, or (engine
        extension) a plain callable applied row-wise over ``input_cols``."""
        if callable(value) and not isinstance(value, Column):
            from sparkdl_tpu_torch.sql.functions import udf as _udf

            value = _udf(value)(*input_cols)
        if isinstance(value, Column) and hasattr(value, "_window"):
            if name not in self.columns:
                return self._apply_window_marker(name, value)
            # replacing a column the window itself may reference (as
            # value/partition/order key): evaluate against the
            # PRE-replacement frame into a hidden name, then swap
            h = f"__wincol_{name}"
            while h in self.columns:
                h = "_" + h
            out = self._apply_window_marker(h, value)
            return out.drop(name).withColumnRenamed(h, name)
        expr: Column = value
        out_parts: List[Partition] = []
        for part in self._partitions:
            n = _partition_nrows(part)
            new_part = dict(part)
            new_part[name] = expr._eval(part, n)
            out_parts.append(new_part)
        new_schema = StructType()
        for f in self._schema:
            if f.name != name:
                new_schema.add(f.name, f.dataType)
        new_schema.add(
            name,
            _infer_column_type(
                out_parts, name, lambda: self._field_type(name)
            ),
        )
        return self._with_partitions(out_parts, new_schema)

    def withColumnRenamed(self, existing: str, new: str) -> "DataFrame":
        out_parts = []
        for part in self._partitions:
            p = dict(part)
            if existing in p:
                p[new] = p.pop(existing)
            out_parts.append(p)
        schema = StructType(
            [
                StructField(new if f.name == existing else f.name, f.dataType)
                for f in self._schema
            ]
        )
        return self._with_partitions(out_parts, schema)

    def drop(self, *names: str) -> "DataFrame":
        keep = [c for c in self.columns if c not in names]
        return self.select(*keep)

    def filter(self, condition: "Column | Callable") -> "DataFrame":
        out_parts = []
        for part in self._partitions:
            n = _partition_nrows(part)
            if isinstance(condition, Column):
                mask = condition._eval(part, n)
            else:
                rows = list(zip(*[part[c] for c in self.columns]))
                mask = [
                    condition(Row._make(self.columns, vals)) for vals in rows
                ]
            out_parts.append(
                {
                    c: [v for v, m in zip(vals, mask) if m]
                    for c, vals in part.items()
                }
            )
        return self._with_partitions(out_parts)

    where = filter

    def limit(self, num: int) -> "DataFrame":
        remaining = num
        out_parts = []
        for part in self._partitions:
            n = _partition_nrows(part)
            k = min(n, remaining)
            out_parts.append({c: vals[:k] for c, vals in part.items()})
            remaining -= k
            if remaining <= 0:
                break
        if not out_parts:
            out_parts = [{c: [] for c in self.columns}]
        return self._with_partitions(out_parts)

    def join(
        self,
        other: "DataFrame",
        on: "str | Sequence",
        how: str = "inner",
    ) -> "DataFrame":
        """Equality hash join (the pyspark ``DataFrame.join`` subset the
        reference's serving-analytics flow used — it delegated joins to
        Spark SQL/Catalyst).

        ``on`` is a key column name or list of names present on BOTH
        sides (the pyspark same-name form: the output carries each key
        column once, keys first, as Spark's USING join does), or a list
        of ``(left_name, right_name)`` pairs for differently-named keys
        (both columns kept).  ``how`` is one of ``inner``,
        ``left``/``left_outer``, ``right``/``right_outer``,
        ``outer``/``full``/``full_outer``.

        Spark semantics throughout: NULL keys never match anything (rows
        with a NULL key still appear, unmatched, in the outer variants).
        Non-key output name collisions raise immediately with the
        offending names — rename or drop before joining (the engine's
        column dicts cannot carry duplicate names the way Spark's
        attribute-id plans can).

        Execution is partition-wise: both sides hash-partition by key
        into the same bucket count, then each bucket builds a map of the
        right rows and probes with the left rows — no cross-bucket data
        dependence, so buckets are output partitions.
        """
        how_key = _JOIN_HOW.get(str(how).lower())
        if how_key is None:
            raise ValueError(
                f"Unsupported join type {how!r}; supported: "
                f"{sorted(set(_JOIN_HOW))}"
            )
        if isinstance(on, str):
            pairs = [(on, on)]
        else:
            entries = list(on)
            if not entries:
                raise ValueError("join requires at least one key column")
            pairs = []
            for e in entries:
                if isinstance(e, str):
                    pairs.append((e, e))
                elif (isinstance(e, (tuple, list)) and len(e) == 2
                        and all(isinstance(k, str) for k in e)):
                    pairs.append((e[0], e[1]))
                else:
                    raise ValueError(
                        f"join key entry {e!r} must be a column name or a "
                        "(left_name, right_name) pair"
                    )
        return self._hash_join(other, pairs, how_key)

    def _hash_join(
        self,
        other: "DataFrame",
        pairs: "List[tuple]",
        how: str,
    ) -> "DataFrame":
        """``pairs``: (left key, right key) per equality; ``how`` is one
        of inner/left/right/full (already normalized)."""
        left_keys = [l for l, _ in pairs]
        right_keys = [r for _, r in pairs]
        for k in left_keys:
            if k not in self.columns:
                raise KeyError(
                    f"join key {k!r} not among left columns {self.columns}"
                )
        for k in right_keys:
            if k not in other.columns:
                raise KeyError(
                    f"join key {k!r} not among right columns {other.columns}"
                )
        # same-named key pairs collapse to one output column (USING
        # semantics); differently-named pairs keep both
        shared = [l for l, r in pairs if l == r]
        left_rest = [c for c in self.columns if c not in shared]
        right_out = [c for c in other.columns if c not in shared]
        clashes = sorted(set(left_rest) & set(right_out))
        if clashes:
            raise ValueError(
                f"join would produce duplicate column names {clashes}; "
                "rename (withColumnRenamed) or drop them on one side first"
            )
        out_cols = shared + left_rest + right_out

        def rows_of(df: "DataFrame") -> List[tuple]:
            names = df.columns
            out = []
            for part in df._partitions:
                out.extend(zip(*[part[c] for c in names]) if names else [])
            return out

        l_idx = {c: i for i, c in enumerate(self.columns)}
        r_idx = {c: i for i, c in enumerate(other.columns)}
        n_buckets = max(
            self.getNumPartitions(), other.getNumPartitions(), 1
        )

        def bucket_key(row, idx, keys):
            key = tuple(row[idx[k]] for k in keys)
            try:
                return hash(key) % n_buckets, key
            except TypeError:
                raise TypeError(
                    f"unhashable join key value {key!r}; join keys must "
                    "be hashable scalars"
                ) from None

        left_buckets: List[List[tuple]] = [[] for _ in range(n_buckets)]
        for row in rows_of(self):
            b, key = bucket_key(row, l_idx, left_keys)
            left_buckets[b].append((key, row))
        # right buckets: key -> row indices, plus a matched flag per row
        right_buckets: List[Dict[tuple, List[int]]] = [
            {} for _ in range(n_buckets)
        ]
        right_rows: List[List[tuple]] = [[] for _ in range(n_buckets)]
        for row in rows_of(other):
            b, key = bucket_key(row, r_idx, right_keys)
            i = len(right_rows[b])
            right_rows[b].append(row)
            if not any(v is None for v in key):  # NULL keys never match
                right_buckets[b].setdefault(key, []).append(i)

        out_parts: List[Partition] = []
        for b in range(n_buckets):
            cols: Partition = {c: [] for c in out_cols}
            matched = [False] * len(right_rows[b])

            def emit(lrow, rrow):
                for c in shared:
                    src = lrow if lrow is not None else rrow
                    idx = l_idx if lrow is not None else r_idx
                    cols[c].append(src[idx[c]])
                for c in left_rest:
                    cols[c].append(None if lrow is None else lrow[l_idx[c]])
                for c in right_out:
                    cols[c].append(None if rrow is None else rrow[r_idx[c]])

            for key, lrow in left_buckets[b]:
                hits = (
                    right_buckets[b].get(key, [])
                    if not any(v is None for v in key)
                    else []
                )
                if hits:
                    for i in hits:
                        matched[i] = True
                        emit(lrow, right_rows[b][i])
                elif how in ("left", "full"):
                    emit(lrow, None)
            if how in ("right", "full"):
                for i, rrow in enumerate(right_rows[b]):
                    if not matched[i]:
                        emit(None, rrow)
            out_parts.append(cols)

        schema = StructType()
        for c in shared + left_rest:
            schema.add(c, self._field_type(c))
        for c in right_out:
            schema.add(c, other._field_type(c))
        return DataFrame(out_parts, schema, self.sparkSession)

    def union(self, other: "DataFrame") -> "DataFrame":
        if self.columns != other.columns:
            raise ValueError(
                f"Union requires same columns: {self.columns} vs {other.columns}"
            )
        return self._with_partitions(self._partitions + other._partitions)

    unionAll = union

    def unionByName(
        self, other: "DataFrame", allowMissingColumns: bool = False
    ) -> "DataFrame":
        """Union resolving columns BY NAME (pyspark ``unionByName``);
        with ``allowMissingColumns`` the asymmetric columns fill NULL."""
        mine, theirs = set(self.columns), set(other.columns)
        if mine != theirs:
            if not allowMissingColumns:
                raise ValueError(
                    f"unionByName: column sets differ ({sorted(mine)} "
                    f"vs {sorted(theirs)}); pass "
                    "allowMissingColumns=True to NULL-fill"
                )
            all_cols = list(self.columns) + [
                c for c in other.columns if c not in mine
            ]
        else:
            all_cols = list(self.columns)

        def conform(df: "DataFrame") -> "DataFrame":
            if df.columns == all_cols:
                return df  # already aligned: share partitions, no copy
            out_parts = []
            for part in df._partitions:
                n = _partition_nrows(part)
                out_parts.append(
                    {
                        c: (list(part[c]) if c in df.columns
                            else [None] * n)
                        for c in all_cols
                    }
                )
            st = StructType()
            for c in all_cols:
                st.add(
                    c,
                    df._field_type(c) if c in df.columns
                    else (
                        self._field_type(c) if c in self.columns
                        else other._field_type(c)
                    ),
                )
            return DataFrame(out_parts, st, df.sparkSession)

        return conform(self).union(conform(other))

    def _row_fingerprints(self) -> "Dict[tuple, int]":
        """Full-row content fingerprint -> occurrence count (the
        multiset the set operations compare)."""
        names = self.columns
        counts: Dict[tuple, int] = {}
        for part in self._partitions:
            n = _partition_nrows(part)
            cols = [part[c] for c in names]
            for i in range(n):
                fp = tuple(_dedupe_key(col[i]) for col in cols)
                counts[fp] = counts.get(fp, 0) + 1
        return counts

    def _setop_filter(self, other: "DataFrame", keep) -> "DataFrame":
        """Shared engine for intersect/except: stream partitions in
        order, keeping row occurrence #k (1-based, per fingerprint) iff
        ``keep(k, other_count)``."""
        if self.columns != other.columns:
            raise ValueError(
                f"Set operation requires same columns: {self.columns} "
                f"vs {other.columns}"
            )
        other_counts = other._row_fingerprints()
        seen: Dict[tuple, int] = {}
        names = self.columns
        out_parts: List[Partition] = []
        for part in self._partitions:
            n = _partition_nrows(part)
            cols = [part[c] for c in names]
            mask = []
            for i in range(n):
                fp = tuple(_dedupe_key(col[i]) for col in cols)
                k = seen.get(fp, 0) + 1
                seen[fp] = k
                mask.append(keep(k, other_counts.get(fp, 0)))
            out_parts.append(
                {
                    c: [v for v, m in zip(vals, mask) if m]
                    for c, vals in part.items()
                }
            )
        return self._with_partitions(out_parts)

    def intersect(self, other: "DataFrame") -> "DataFrame":
        """Distinct rows present in BOTH frames (SQL ``INTERSECT``)."""
        return self._setop_filter(
            other, lambda k, oc: k == 1 and oc > 0
        )

    def intersectAll(self, other: "DataFrame") -> "DataFrame":
        """Multiset intersection: each row min(count_self, count_other)
        times (SQL ``INTERSECT ALL``)."""
        return self._setop_filter(other, lambda k, oc: k <= oc)

    def subtract(self, other: "DataFrame") -> "DataFrame":
        """Distinct rows of this frame absent from ``other`` (SQL
        ``EXCEPT``; pyspark ``subtract``)."""
        return self._setop_filter(
            other, lambda k, oc: k == 1 and oc == 0
        )

    def exceptAll(self, other: "DataFrame") -> "DataFrame":
        """Multiset difference: each row max(0, count_self -
        count_other) times (SQL ``EXCEPT ALL``)."""
        return self._setop_filter(other, lambda k, oc: k > oc)

    def repartition(self, numPartitions: int) -> "DataFrame":
        names = self.columns
        all_cols: Dict[str, List[Any]] = {c: [] for c in names}
        for part in self._partitions:
            for c in names:
                all_cols[c].extend(part[c])
        total = len(next(iter(all_cols.values()))) if names else 0
        numPartitions = max(1, numPartitions)
        out_parts = []
        for i in range(numPartitions):
            lo = i * total // numPartitions
            hi = (i + 1) * total // numPartitions
            out_parts.append({c: all_cols[c][lo:hi] for c in names})
        return self._with_partitions(out_parts)

    coalesce = repartition

    def randomSplit(
        self, weights: Sequence[float], seed: Optional[int] = None
    ) -> List["DataFrame"]:
        rng = _random.Random(seed)
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
                next(i for i, c in enumerate(cum) if rng.random() <= c or i == len(cum) - 1)
                for _ in range(n)
            ]
            for i in range(len(weights)):
                buckets[i].append(
                    {
                        c: [v for v, a in zip(part[c], assignment) if a == i]
                        for c in names
                    }
                )
        return [self._with_partitions(b) for b in buckets]

    def orderBy(
        self, *cols: "Column | str", ascending: "bool | Sequence[bool]" = True
    ) -> "DataFrame":
        """Sort by one or more columns.  ``ascending`` is a bool for all
        keys or a per-key list (pyspark form); Spark null ordering:
        NULLS FIRST ascending, NULLS LAST descending."""
        names = self.columns
        keys = [c if isinstance(c, str) else c._name for c in cols]
        for k in keys:
            if k not in names:
                raise KeyError(f"No such column: {k!r}")
        if isinstance(ascending, (list, tuple)):
            if len(ascending) != len(keys):
                raise ValueError(
                    f"ascending list length {len(ascending)} != "
                    f"{len(keys)} sort columns"
                )
            asc = [bool(a) for a in ascending]
        else:
            asc = [bool(ascending)] * len(keys)
        # Column.asc()/desc() markers override the ascending argument
        # per key (pyspark: df.orderBy(F.desc("score")))
        for i, c in enumerate(cols):
            marker = getattr(c, "_sort_asc", None)
            if marker is not None:
                asc[i] = marker
        # Sort a row-index permutation using ONLY the key columns (no Row
        # materialization), then apply it to each column and re-split at
        # the original partition sizes: downstream mapPartitions keeps
        # its parallel grain instead of collapsing to one partition.
        sizes = [_partition_nrows(p) for p in self._partitions]
        col_cache: Dict[str, List[Any]] = {}
        for c in names:
            flat: List[Any] = []
            for part in self._partitions:
                flat.extend(part[c])
            col_cache[c] = flat
        idx = list(range(sum(sizes)))
        # stable multi-key sort: apply keys right-to-left; the (is-null
        # rank, value) key gives Spark's null ordering under reverse=
        for k, a in reversed(list(zip(keys, asc))):
            vals = col_cache[k]
            idx.sort(
                key=lambda i: (
                    (0 if vals[i] is None else 1),
                    0 if vals[i] is None else vals[i],
                ),
                reverse=not a,
            )
        out_parts: List[Partition] = []
        pos = 0
        for size in sizes:
            chunk = idx[pos:pos + size]
            out_parts.append(
                {c: [col_cache[c][i] for i in chunk] for c in names}
            )
            pos += size
        if not out_parts:
            out_parts = [{c: [] for c in names}]
        return self._with_partitions(out_parts)

    sort = orderBy

    def _apply_window_marker(self, name: str, expr: Column) -> "DataFrame":
        """Dispatch a ``Column.over(WindowSpec)`` expression to the
        engine's window evaluators, appending column ``name``."""
        desc, window = expr._window
        part_cols = list(window._partition_cols)
        ord_cols = [c for c, _ in window._order]
        ascs = [a for _, a in window._order]
        kind = desc[0]
        if kind == "rank":
            if not ord_cols:
                raise ValueError(
                    f"{desc[1]}() requires a window with orderBy"
                )
            return self._with_rank_column(
                name, desc[1], part_cols, ord_cols, ascs,
                n_buckets=desc[2],
            )
        if kind == "shift":
            direction, vcol, offset, default = desc[1:]
            if not ord_cols:
                raise ValueError("lag/lead require a window with orderBy")
            return self._with_window_shift_column(
                name, direction, vcol, offset, default, part_cols,
                ord_cols, ascs,
            )
        fn_key, vcol = desc[1], desc[2]
        return self._with_window_agg_column(
            name, fn_key, vcol, part_cols, ord_cols, ascs,
            frame=window._frame,
        )

    def _window_groups(
        self,
        partition_cols: Sequence[str],
        order_cols: Sequence[str],
        ascending: Sequence[bool],
        extra_cols: Sequence[str] = (),
    ):
        """Shared window-evaluator plumbing: flatten ONLY the referenced
        columns, bucket row indices by partition key (first-appearance
        order), and sort each bucket by the order keys with the same
        stable multi-key + null-ordering discipline as :meth:`orderBy`.
        Returns ``(flat, ordered_groups, sizes)``."""
        for c in (
            list(partition_cols) + list(order_cols) + list(extra_cols)
        ):
            if c not in self.columns:
                raise KeyError(f"No such column: {c!r}")
        sizes = [_partition_nrows(p) for p in self._partitions]
        needed = dict.fromkeys(
            list(partition_cols) + list(order_cols) + list(extra_cols)
        )
        flat: Dict[str, List[Any]] = {}
        for c in needed:
            vals: List[Any] = []
            for part in self._partitions:
                vals.extend(part[c])
            flat[c] = vals
        total = sum(sizes)

        # several windows over one spec (the top-N idiom: rank + lag +
        # lead on the same PARTITION BY/ORDER BY) share the bucketing
        # and sort; the memo rides along layout-preserving scatters
        memo_key = (
            tuple(partition_cols), tuple(order_cols), tuple(ascending)
        )
        memo = getattr(self, "_win_memo", None)
        if memo is not None and memo_key in memo:
            return flat, memo[memo_key], sizes

        groups: Dict[tuple, List[int]] = {}
        gorder: List[tuple] = []
        for i in range(total):
            key = tuple(flat[c][i] for c in partition_cols)
            try:
                bucket = groups[key]
            except KeyError:
                bucket = groups[key] = []
                gorder.append(key)
            except TypeError:
                raise TypeError(
                    f"unhashable PARTITION BY key value in "
                    f"{list(partition_cols)}; keys must be hashable "
                    "scalars"
                ) from None
            bucket.append(i)
        for key in gorder:
            idx = groups[key]
            for c, a in reversed(list(zip(order_cols, ascending))):
                vals = flat[c]
                idx.sort(
                    key=lambda i: (
                        (0 if vals[i] is None else 1),
                        0 if vals[i] is None else vals[i],
                    ),
                    reverse=not a,
                )
        ordered = [groups[k] for k in gorder]
        if memo is None:
            memo = {}
            self._win_memo = memo
        memo[memo_key] = ordered
        return flat, ordered, sizes

    def _scatter_window_column(
        self, name: str, values: List[Any], sizes: List[int], dtype
    ) -> "DataFrame":
        """Attach a computed per-row column back into the existing
        partition layout (partitioning and every other column's storage
        untouched)."""
        if name in self.columns:
            raise ValueError(
                f"window output column {name!r} already exists"
            )
        out_parts: List[Partition] = []
        pos = 0
        for part, size in zip(self._partitions, sizes):
            p = dict(part)
            p[name] = values[pos:pos + size]
            pos += size
            out_parts.append(p)
        schema = StructType(
            [StructField(f.name, f.dataType) for f in self._schema]
        )
        schema.add(name, dtype)
        out = self._with_partitions(out_parts, schema)
        # scatter preserves row layout, so the spec memo stays valid
        if getattr(self, "_win_memo", None):
            out._win_memo = self._win_memo
        return out

    def _with_rank_column(
        self,
        name: str,
        fn_key: str,
        partition_cols: Sequence[str],
        order_cols: Sequence[str],
        ascending: Sequence[bool],
        n_buckets: Optional[int] = None,
    ) -> "DataFrame":
        """Append a ranking-family column — the window-function
        evaluator behind SQL ``ROW_NUMBER()/RANK()/DENSE_RANK()/
        PERCENT_RANK()/CUME_DIST()/NTILE(n) OVER (PARTITION BY ...
        ORDER BY ...)`` (the Spark-SQL window idiom the reference's
        serving analytics leaned on).

        Reads ONLY the partition/order key columns; values scatter back
        into the existing partition layout.  Ties: ``rank`` repeats with
        gaps, ``dense_rank`` without, ``row_number`` breaks ties by
        input order (deterministic — the engine has no shuffle
        nondeterminism to hide); ``percent_rank`` = (rank-1)/(n-1) (0
        for a single row), ``cume_dist`` counts peers inclusively,
        ``ntile`` deals row_number round-robin into ``n_buckets`` with
        the first n%k buckets one larger, as Spark."""
        if fn_key not in ("row_number", "rank", "dense_rank",
                          "percent_rank", "cume_dist", "ntile"):
            raise ValueError(f"Unsupported window function {fn_key!r}")
        if fn_key == "ntile" and (n_buckets is None or n_buckets < 1):
            raise ValueError("NTILE requires a positive bucket count")
        flat, ordered_groups, sizes = self._window_groups(
            partition_cols, order_cols, ascending
        )
        ranks: List[Any] = [0] * sum(sizes)
        for idx in ordered_groups:
            n = len(idx)
            if fn_key == "cume_dist":
                # peer-run walk (same pattern as the running-aggregate
                # frame): every member of a tie run shares the run's
                # INCLUSIVE end position
                j = 0
                while j < n:
                    key_j = tuple(flat[c][idx[j]] for c in order_cols)
                    k_ = j
                    while (
                        k_ < n
                        and tuple(flat[c][idx[k_]] for c in order_cols)
                        == key_j
                    ):
                        k_ += 1
                    for m in range(j, k_):
                        ranks[idx[m]] = k_ / n
                    j = k_
                continue
            prev: "Any" = object()  # never equal to a real key tuple
            rank = dense = 0
            for pos, i in enumerate(idx, start=1):
                cur = tuple(flat[c][i] for c in order_cols)
                if cur != prev:
                    dense += 1
                    rank = pos
                    prev = cur
                if fn_key == "row_number":
                    ranks[i] = pos
                elif fn_key == "rank":
                    ranks[i] = rank
                elif fn_key == "dense_rank":
                    ranks[i] = dense
                elif fn_key == "percent_rank":
                    ranks[i] = (rank - 1) / (n - 1) if n > 1 else 0.0
                else:  # ntile
                    base, extra = divmod(n, n_buckets)
                    # first `extra` buckets hold base+1 rows; when
                    # base == 0 every row lands in the first branch
                    # (boundary == n), so the else-arm implies base > 0
                    boundary = extra * (base + 1)
                    if pos <= boundary:
                        ranks[i] = (pos - 1) // (base + 1) + 1
                    else:
                        ranks[i] = extra + (pos - boundary - 1) // base + 1

        from sparkdl_tpu_torch.sql.types import DoubleType, LongType

        dtype = (
            DoubleType()
            if fn_key in ("percent_rank", "cume_dist") else LongType()
        )
        return self._scatter_window_column(name, ranks, sizes, dtype)

    def _with_window_agg_column(
        self,
        name: str,
        fn_key: str,
        value_col: Optional[str],  # None = COUNT(*)
        partition_cols: Sequence[str],
        order_cols: Sequence[str],
        ascending: Sequence[bool],
        frame: Optional[tuple] = None,
    ) -> "DataFrame":
        """Aggregate-over-window column: ``SUM(x) OVER (PARTITION BY k)``
        broadcasts the partition aggregate to every row; with ORDER BY it
        is the RUNNING aggregate under Spark's default frame (RANGE
        UNBOUNDED PRECEDING .. CURRENT ROW — tied rows are peers and
        share one value).  An explicit ``frame`` is a ROWS window
        ``(lo, hi)`` of offsets relative to the current row (None =
        unbounded on that side; -2..0 is the 3-row moving window) —
        row-based, so peers do NOT share.  NULLs are excluded, as in
        GROUP BY."""
        if fn_key == "mean":
            fn_key = "avg"
        if fn_key not in _AGG_SPECS:
            raise ValueError(
                f"Unsupported window aggregate {fn_key!r}; supported: "
                f"{sorted(_AGG_SPECS)}"
            )
        spec = _AGG_SPECS[fn_key]
        extra = [value_col] if value_col is not None else []
        flat, ordered_groups, sizes = self._window_groups(
            partition_cols, order_cols, ascending, extra_cols=extra
        )
        out: List[Any] = [None] * sum(sizes)
        vals = flat[value_col] if value_col is not None else None

        def update(acc, i):
            if vals is None:  # COUNT(*)
                return spec.update(acc, True)
            v = vals[i]
            return acc if v is None else spec.update(acc, v)

        for idx in ordered_groups:
            if frame is not None:
                # explicit ROWS frame: a per-row offset window
                lo_off, hi_off = frame
                n = len(idx)
                if lo_off is None:
                    # unbounded-preceding frames (the cumulative idiom)
                    # share ONE growing accumulator: O(n), not O(n^2)
                    acc = spec.init()
                    upto = 0  # rows folded so far (exclusive)
                    empty = spec.final(spec.init())
                    for pos in range(n):
                        hi = (n - 1) if hi_off is None else pos + hi_off
                        hi = hi if hi < n - 1 else n - 1
                        while upto <= hi:
                            acc = update(acc, idx[upto])
                            upto += 1
                        if hi < 0:
                            result = empty
                        else:
                            result = spec.final(acc)
                            if isinstance(result, list):
                                result = list(result)
                        out[idx[pos]] = result
                    continue
                for pos in range(n):
                    lo = pos + lo_off
                    hi = (n - 1) if hi_off is None else pos + hi_off
                    acc = spec.init()
                    for m in range(lo if lo > 0 else 0,
                                   (hi if hi < n - 1 else n - 1) + 1):
                        acc = update(acc, idx[m])
                    result = spec.final(acc)
                    if isinstance(result, list):
                        result = list(result)
                    out[idx[pos]] = result
                continue
            if not order_cols:
                acc = spec.init()
                for i in idx:
                    acc = update(acc, i)
                result = spec.final(acc)
                for i in idx:
                    out[i] = result
                continue
            # running frame: walk peer groups (rows tied on the order
            # key), extend the accumulator by the whole peer group,
            # then assign one value to all its members
            acc = spec.init()
            j = 0
            while j < len(idx):
                k = j
                key_j = tuple(flat[c][idx[j]] for c in order_cols)
                while (
                    k < len(idx)
                    and tuple(flat[c][idx[k]] for c in order_cols)
                    == key_j
                ):
                    acc = update(acc, idx[k])
                    k += 1
                result = spec.final(acc)
                if isinstance(result, list):
                    # collect_* finals return the live accumulator;
                    # later frame extensions must not mutate earlier
                    # rows' snapshots
                    result = list(result)
                for m in range(j, k):
                    out[idx[m]] = result
                j = k

        from sparkdl_tpu_torch.sql.types import ObjectType

        dtype = _agg_result_type(
            fn_key,
            self._field_type(value_col) if value_col is not None else None,
        )
        if isinstance(dtype, ObjectType):
            probe = next((v for v in out if v is not None), None)
            dtype = infer_type(probe)
        return self._scatter_window_column(name, out, sizes, dtype)

    def _with_window_shift_column(
        self,
        name: str,
        direction: int,  # -1 = LAG, +1 = LEAD
        value_col: str,
        offset: int,
        default: Any,
        partition_cols: Sequence[str],
        order_cols: Sequence[str],
        ascending: Sequence[bool],
    ) -> "DataFrame":
        """``LAG/LEAD(x[, offset[, default]]) OVER (...)`` — the row
        ``offset`` positions before/after in the partition's order, or
        ``default`` (NULL unless given) off either end.

        ``default`` must be NULL or type-compatible with the value
        column's declared dtype: the filled edges land in the same
        column as the shifted values, and a mismatched literal (e.g.
        ``LAG(score, 1, 'n/a')`` over a DOUBLE) would silently produce
        a mixed-type column that breaks downstream numeric ops."""
        self._check_shift_default(value_col, default)
        flat, ordered_groups, sizes = self._window_groups(
            partition_cols, order_cols, ascending,
            extra_cols=[value_col],
        )
        vals = flat[value_col]
        out: List[Any] = [default] * sum(sizes)
        for idx in ordered_groups:
            for pos, i in enumerate(idx):
                src = pos + direction * offset
                if 0 <= src < len(idx):
                    out[i] = vals[idx[src]]
        return self._scatter_window_column(
            name, out, sizes, self._field_type(value_col)
        )

    def _check_shift_default(self, value_col: str, default: Any) -> None:
        """Reject a LAG/LEAD ``default`` literal that cannot live in the
        value column's declared type.  NULL always passes; an untyped
        (Object) column accepts anything."""
        if default is None:
            return
        from sparkdl_tpu_torch.sql.types import (
            BooleanType,
            DoubleType,
            FloatType,
            IntegerType,
            LongType,
            StringType,
        )

        dtype = self._field_type(value_col)
        # bool is an int subclass in Python; it is NOT a numeric literal
        ok: bool
        if isinstance(dtype, (IntegerType, LongType)):
            ok = isinstance(default, int) and not isinstance(default, bool)
        elif isinstance(dtype, (FloatType, DoubleType)):
            ok = isinstance(default, (int, float)) and not isinstance(
                default, bool
            )
        elif isinstance(dtype, StringType):
            ok = isinstance(default, str)
        elif isinstance(dtype, BooleanType):
            ok = isinstance(default, bool)
        else:
            # Object/array/vector columns carry no checkable contract
            return
        if not ok:
            raise ValueError(
                f"LAG/LEAD default {default!r} "
                f"({type(default).__name__}) is not compatible with "
                f"column {value_col!r} of type "
                f"{type(dtype).__name__}; use a literal of the "
                "column's type or omit the default (NULL)"
            )

    def dropDuplicates(
        self, subset: Optional[Sequence[str]] = None
    ) -> "DataFrame":
        """Keep the first occurrence of each distinct row (optionally
        judged on ``subset`` columns only) — pyspark semantics; NULLs
        compare equal to NULLs here, as in Spark's dropDuplicates."""
        cols = list(subset) if subset else self.columns
        for c in cols:
            if c not in self.columns:
                raise KeyError(f"No such column: {c!r}")
        seen: set = set()
        out_parts: List[Partition] = []
        for part in self._partitions:
            n = _partition_nrows(part)
            mask = []
            for i in range(n):
                key = tuple(_dedupe_key(part[c][i]) for c in cols)
                if key in seen:
                    mask.append(False)
                else:
                    seen.add(key)
                    mask.append(True)
            out_parts.append(
                {
                    c: [v for v, m in zip(vals, mask) if m]
                    for c, vals in part.items()
                }
            )
        return self._with_partitions(out_parts)

    drop_duplicates = dropDuplicates

    def distinct(self) -> "DataFrame":
        return self.dropDuplicates()

    @property
    def na(self) -> "DataFrameNaFunctions":
        return DataFrameNaFunctions(self)

    def dropna(self, how: str = "any", thresh: Optional[int] = None,
               subset: Optional[Sequence[str]] = None) -> "DataFrame":
        return self.na.drop(how=how, thresh=thresh, subset=subset)

    def fillna(self, value, subset: Optional[Sequence[str]] = None
               ) -> "DataFrame":
        return self.na.fill(value, subset=subset)

    def groupBy(self, *cols: "Column | str") -> "GroupedData":
        """Group by one or more columns (pyspark ``GroupedData`` subset:
        ``count/sum/avg/mean/min/max/agg``)."""
        keys = [c if isinstance(c, str) else c._name for c in cols]
        for k in keys:
            if k not in self.columns:
                raise KeyError(f"No such column: {k!r}")
        return GroupedData(self, keys)

    groupby = groupBy

    def selectExpr(self, *exprs: str) -> "DataFrame":
        """Project SQL expression strings (pyspark ``selectExpr``):
        ``df.selectExpr("score * 100 AS pct", "label")``."""
        if self.sparkSession is None:
            raise RuntimeError("selectExpr requires a session")
        parsed: List[Column] = []
        for e in exprs:
            e = e.strip()
            if e == "*":
                parsed.extend(_col(c) for c in self.columns)
            else:
                parsed.append(
                    self.sparkSession._parse_projection(
                        e, frozenset(), self.columns
                    )
                )
        return self.select(*parsed)

    def crossJoin(self, other: "DataFrame") -> "DataFrame":
        """Cartesian product (pyspark ``crossJoin``); output keeps the
        left frame's partition count."""
        clashes = sorted(set(self.columns) & set(other.columns))
        if clashes:
            raise ValueError(
                f"crossJoin would produce duplicate column names "
                f"{clashes}; rename or drop them on one side first"
            )
        right_cols: Dict[str, List[Any]] = {c: [] for c in other.columns}
        for part in other._partitions:
            for c in other.columns:
                right_cols[c].extend(part[c])
        n_right = len(next(iter(right_cols.values()))) if other.columns else 0
        out_parts: List[Partition] = []
        for part in self._partitions:
            n = _partition_nrows(part)
            p: Partition = {}
            for c in self.columns:
                p[c] = [v for v in part[c] for _ in range(n_right)]
            for c in other.columns:
                p[c] = list(right_cols[c]) * n
            out_parts.append(p)
        schema = StructType(
            [StructField(f.name, f.dataType) for f in self._schema]
            + [StructField(f.name, f.dataType) for f in other._schema]
        )
        return DataFrame(out_parts, schema, self.sparkSession)

    def sample(
        self,
        withReplacement=None,
        fraction: Optional[float] = None,
        seed: Optional[int] = None,
    ) -> "DataFrame":
        """Row sampling (pyspark argument juggling supported:
        ``sample(0.5)``, ``sample(0.5, seed)``, ``sample(0.5, seed=seed)``,
        ``sample(False, 0.5, seed)``).  Without replacement:
        Bernoulli(fraction) per row; with replacement: Poisson(fraction)
        copies per row. One seed gives one set of rows."""
        if isinstance(withReplacement, (int, float)) and not isinstance(
            withReplacement, bool
        ):
            # a fraction in the first place: a second positional argument
            # is the seed, else a keyword seed stands (as pyspark reads it)
            if fraction is not None:
                seed = fraction
            withReplacement, fraction = False, withReplacement
        if fraction is None:
            raise ValueError("sample requires a fraction")
        import numpy as np

        rng = np.random.RandomState(seed)
        out_parts: List[Partition] = []
        for part in self._partitions:
            n = _partition_nrows(part)
            if withReplacement:
                counts = rng.poisson(float(fraction), size=n)
            else:
                counts = (
                    rng.random_sample(n) < float(fraction)
                ).astype(int)
            out_parts.append(
                {
                    c: [v for v, k in zip(vals, counts)
                        for _ in range(int(k))]
                    for c, vals in part.items()
                }
            )
        return self._with_partitions(out_parts)

    def describe(self, *cols: str) -> "DataFrame":
        """count/mean/stddev/min/max summary (pyspark ``describe``):
        numeric columns get all five, string columns count/min/max."""
        from sparkdl_tpu_torch.sql.types import (
            DoubleType,
            FloatType,
            IntegerType,
            LongType,
            StringType,
        )

        numeric = (IntegerType, LongType, FloatType, DoubleType)
        targets = list(cols) or [
            f.name
            for f in self._schema
            if isinstance(f.dataType, numeric + (StringType,))
        ]
        for c in targets:
            if c not in self.columns:
                raise KeyError(f"No such column: {c!r}")
        stats = ["count", "mean", "stddev", "min", "max"]
        # ONE aggregation pass over all target columns (Spark's
        # describe is one-pass too), labels prefixed per column
        pairs: List[tuple] = []
        per_col: Dict[str, Dict[str, str]] = {}
        for c in targets:
            is_num = isinstance(self._field_type(c), numeric)
            fns = (
                [("count", "count"), ("avg", "mean"),
                 ("stddev", "stddev"), ("min", "min"), ("max", "max")]
                if is_num
                else [("count", "count"), ("min", "min"), ("max", "max")]
            )
            per_col[c] = {}
            for fn_key, stat in fns:
                label = f"__describe_{stat}({c})"
                pairs.append((c, fn_key, label))
                per_col[c][stat] = label
        row = self.groupBy()._aggregate(pairs).collect()[0]
        part: Partition = {"summary": list(stats)}
        for c in targets:
            part[c] = [
                str(row[per_col[c][s]])
                if s in per_col[c] and row[per_col[c][s]] is not None
                else None
                for s in stats
            ]
        st = StructType().add("summary", StringType())
        for c in targets:
            st.add(c, StringType())
        return DataFrame([part], st, self.sparkSession)

    def corr(self, col1: str, col2: str) -> float:
        """Pearson correlation of two numeric columns (pyspark
        ``df.corr``); NULL-bearing pairs are excluded."""
        import numpy as np

        xs, ys = self._numeric_pairs(col1, col2)
        if len(xs) < 2:
            return float("nan")
        return float(np.corrcoef(xs, ys)[0, 1])

    def cov(self, col1: str, col2: str) -> float:
        """Sample covariance of two numeric columns (pyspark
        ``df.cov``)."""
        import numpy as np

        xs, ys = self._numeric_pairs(col1, col2)
        if len(xs) < 2:
            return float("nan")
        return float(np.cov(xs, ys, ddof=1)[0, 1])

    def _numeric_pairs(self, col1: str, col2: str):
        for c in (col1, col2):
            if c not in self.columns:
                raise KeyError(f"No such column: {c!r}")
        xs: List[float] = []
        ys: List[float] = []
        for part in self._partitions:
            for a, b in zip(part[col1], part[col2]):
                if a is not None and b is not None:
                    xs.append(float(a))
                    ys.append(float(b))
        return xs, ys

    def isEmpty(self) -> bool:
        return self.count() == 0

    def tail(self, num: int) -> List[Row]:
        rows = self.collect()
        return rows[len(rows) - num:] if num < len(rows) else rows

    def toDF(self, *names: str) -> "DataFrame":
        """Rename every column positionally (pyspark ``toDF``)."""
        if len(names) != len(self.columns):
            raise ValueError(
                f"toDF needs {len(self.columns)} names, got {len(names)}"
            )
        out = self
        tmp = _disjoint_tmp_names(
            len(names), set(self.columns) | set(names)
        )
        for old, t in zip(list(out.columns), tmp):
            out = out.withColumnRenamed(old, t)
        for t, new in zip(tmp, names):
            out = out.withColumnRenamed(t, new)
        return out

    def withColumns(self, colsMap: "Dict[str, Column]") -> "DataFrame":
        out = self
        for name, expr in colsMap.items():
            out = out.withColumn(name, expr)
        return out

    def sortWithinPartitions(
        self, *cols: "Column | str", ascending: "bool | Sequence[bool]" = True
    ) -> "DataFrame":
        """Sort each partition independently (pyspark analog) — the
        local-sort primitive before a mapPartitions that wants ordered
        input without a global shuffle."""
        out_parts = []
        for part in self._partitions:
            single = DataFrame([part], self._schema, self.sparkSession)
            out_parts.extend(
                single.orderBy(*cols, ascending=ascending)._partitions
            )
        return self._with_partitions(out_parts)

    def cache(self) -> "DataFrame":
        return self

    persist = cache

    def unpersist(self) -> "DataFrame":
        return self

    # ------------------------------------------------------------------
    # partition-level compute (the hot path)
    # ------------------------------------------------------------------
    def mapPartitions(
        self,
        fn: Callable[[Partition], Partition],
        schema: Optional[StructType] = None,
    ) -> "DataFrame":
        """Apply ``fn`` to each partition's column dict → new column dict.

        This is the engine primitive under every model transformer (the
        TensorFrames ``map_blocks`` analog)."""
        out_parts = [fn(dict(part)) for part in self._partitions]
        if schema is None:
            schema = StructType()
            probe = next((p for p in out_parts if _partition_nrows(p)), None)
            cols = list(out_parts[0].keys()) if out_parts else []
            for c in cols:
                schema.add(c, infer_type(probe[c][0]) if probe else self._field_type(c))
        return self._with_partitions(out_parts, schema)

    def mapInArrow(self, fn: Callable, schema: Optional[StructType] = None):
        """Arrow-columnar partition mapping: ``fn(pyarrow.RecordBatch) ->
        pyarrow.RecordBatch`` (native-bridge integration point)."""
        import pyarrow as pa

        def wrapper(part: Partition) -> Partition:
            batch = pa.record_batch(
                {c: pa.array(vals) for c, vals in part.items()}
            )
            out = fn(batch)
            return {
                name: out.column(i).to_pylist()
                for i, name in enumerate(out.schema.names)
            }

        return self.mapPartitions(wrapper, schema)

    def foreachPartition(self, fn: Callable[[Partition], None]):
        for part in self._partitions:
            fn(dict(part))

    # ------------------------------------------------------------------
    # views
    # ------------------------------------------------------------------
    def createOrReplaceTempView(self, name: str):
        if self.sparkSession is None:
            raise RuntimeError("DataFrame has no session")
        self.sparkSession.catalog._views[name] = self

    registerTempTable = createOrReplaceTempView

    def __repr__(self):
        cols = ", ".join(
            f"{f.name}: {f.dataType.simpleString()}" for f in self._schema
        )
        return f"DataFrame[{cols}]"


class DataFrameNaFunctions:
    """``df.na`` — the pyspark null-handling surface (drop/fill)."""

    def __init__(self, df: DataFrame):
        self._df = df

    def drop(self, how: str = "any", thresh: Optional[int] = None,
             subset: Optional[Sequence[str]] = None) -> DataFrame:
        """Drop rows with nulls.  ``how="any"`` drops a row when any of
        the judged columns is null, ``"all"`` only when every one is;
        ``thresh=k`` (overrides ``how``, as in Spark) keeps rows with at
        least k non-null judged values."""
        df = self._df
        cols = list(subset) if subset else df.columns
        for c in cols:
            if c not in df.columns:
                raise KeyError(f"No such column: {c!r}")
        if how not in ("any", "all"):
            raise ValueError(f"how must be 'any' or 'all', got {how!r}")
        need = (
            thresh if thresh is not None
            else (len(cols) if how == "any" else 1)
        )

        def keep(r) -> bool:
            return sum(r[c] is not None for c in cols) >= need

        return df.filter(keep)

    def fill(self, value, subset: Optional[Sequence[str]] = None
             ) -> DataFrame:
        """Replace nulls.  ``value`` is a scalar (applied to ``subset``
        or, Spark-style, to every column whose type matches the value's)
        or a ``{column: value}`` dict."""
        df = self._df
        if isinstance(value, dict):
            if subset is not None:
                raise ValueError("pass either a value dict or subset")
            fills = dict(value)
        else:
            if subset is None:
                # Spark fills only type-compatible columns; numeric
                # values fill numeric columns, strings fill strings,
                # bools fill bools
                from sparkdl_tpu_torch.sql.types import (
                    BooleanType,
                    DoubleType,
                    FloatType,
                    IntegerType,
                    LongType,
                    StringType,
                )

                if isinstance(value, bool):
                    ok = (BooleanType,)
                elif isinstance(value, (int, float)):
                    ok = (IntegerType, LongType, FloatType, DoubleType)
                elif isinstance(value, str):
                    ok = (StringType,)
                else:
                    raise TypeError(
                        f"unsupported fill value type {type(value).__name__}"
                    )
                subset = [
                    f.name for f in df.schema
                    if isinstance(f.dataType, ok)
                ]
            fills = {c: value for c in subset}
        for c in fills:
            if c not in df.columns:
                raise KeyError(f"No such column: {c!r}")
        # pyspark semantics: type-incompatible columns are silently
        # IGNORED (fill("x") never touches an int column), and numeric
        # fills cast to the column's declared type (0.5 into an int
        # column stores 0) — keeping the schema honest for typed
        # consumers (to_arrow etc.)
        from sparkdl_tpu_torch.sql.types import (
            BooleanType,
            DoubleType,
            FloatType,
            IntegerType,
            LongType,
            StringType,
        )

        def cast_for(c, v):
            """Casted value, or None to skip the column."""
            t = df._field_type(c)
            if isinstance(v, bool):
                return v if isinstance(t, BooleanType) else None
            if isinstance(v, (int, float)):
                if isinstance(t, (IntegerType, LongType)):
                    return int(v)
                if isinstance(t, (FloatType, DoubleType)):
                    return float(v)
                return None
            if isinstance(v, str):
                return v if isinstance(t, StringType) else None
            return None

        fills = {
            c: cv
            for c, v in fills.items()
            if (cv := cast_for(c, v)) is not None
        }
        out_parts = []
        for part in df._partitions:
            p = dict(part)
            for c, v in fills.items():
                p[c] = [v if cell is None else cell for cell in p[c]]
            out_parts.append(p)
        return df._with_partitions(out_parts)


class _AggSpec:
    """One aggregate function as a mergeable accumulator triple —
    ``init() -> acc``, ``update(acc, v) -> acc`` over one partition's
    non-null values, ``merge(a, b) -> acc`` across partition partials,
    ``final(acc) -> scalar``.

    This factored (partial-aggregate, then merge) shape is what lets
    :meth:`GroupedData._aggregate` stream partition-by-partition without
    materializing rows in one place — the same combiner discipline
    Spark's partial aggregation used (the reference delegated GROUP BY to
    it); NULLs are excluded before ``update`` (SQL
    semantics); ``COUNT(*)`` counts rows, ``COUNT(col)`` non-null values.
    """

    __slots__ = ("init", "update", "merge", "final")

    def __init__(self, init, update, merge, final):
        self.init = init
        self.update = update
        self.merge = merge
        self.final = final


def _moments_update(acc, v):
    # Welford accumulation: (n, mean, M2) — numerically stable where the
    # naive sum/sumsq form cancels catastrophically for large means
    n, mean, m2 = acc
    n += 1
    d = v - mean
    mean += d / n
    m2 += d * (v - mean)
    return (n, mean, m2)


def _moments_merge(a, b):
    # Chan's parallel-merge of two Welford partials
    na, ma, m2a = a
    nb, mb, m2b = b
    if na == 0:
        return b
    if nb == 0:
        return a
    n = na + nb
    d = mb - ma
    return (n, ma + d * nb / n, m2a + m2b + d * d * na * nb / n)


def _var_final(acc, ddof: int):
    # Spark semantics: no rows -> NULL; one row with ddof=1 -> NaN
    # (0/0 in the sample estimator), population variance of one row -> 0
    n, _, m2 = acc
    if n == 0:
        return None
    if n - ddof <= 0:
        return float("nan")
    return m2 / (n - ddof)


def _make_var_spec(ddof: int, sqrt: bool) -> _AggSpec:
    import math

    def final(acc):
        v = _var_final(acc, ddof)
        if v is None:
            return None
        return math.sqrt(v) if sqrt else v

    return _AggSpec(
        lambda: (0, 0.0, 0.0), _moments_update, _moments_merge, final
    )


def _collect_set_update(acc, v):
    acc.setdefault(_dedupe_key(v), v)
    return acc


_AGG_SPECS: Dict[str, _AggSpec] = {
    "count": _AggSpec(
        lambda: 0, lambda a, v: a + 1, lambda a, b: a + b, lambda a: a
    ),
    "sum": _AggSpec(
        # (total, seen-any): SUM of zero non-null values is NULL, not 0
        lambda: (0, False),
        lambda a, v: (a[0] + v, True),
        lambda a, b: (a[0] + b[0], a[1] or b[1]),
        lambda a: a[0] if a[1] else None,
    ),
    "avg": _AggSpec(
        lambda: (0, 0),
        lambda a, v: (a[0] + v, a[1] + 1),
        lambda a, b: (a[0] + b[0], a[1] + b[1]),
        lambda a: (a[0] / a[1]) if a[1] else None,
    ),
    "min": _AggSpec(
        lambda: (None, False),
        lambda a, v: (v if not a[1] or v < a[0] else a[0], True),
        lambda a, b: (
            a if not b[1] else b if not a[1]
            else ((a[0], True) if a[0] <= b[0] else (b[0], True))
        ),
        lambda a: a[0],
    ),
    "max": _AggSpec(
        lambda: (None, False),
        lambda a, v: (v if not a[1] or v > a[0] else a[0], True),
        lambda a, b: (
            a if not b[1] else b if not a[1]
            else ((a[0], True) if a[0] >= b[0] else (b[0], True))
        ),
        lambda a: a[0],
    ),
    # COUNT(DISTINCT c): nulls were already excluded, so set-size;
    # _dedupe_key keeps unhashable cells (arrays) countable
    "count_distinct": _AggSpec(
        lambda: set(),
        lambda a, v: (a.add(_dedupe_key(v)), a)[1],
        lambda a, b: a | b,
        len,
    ),
    "stddev": _make_var_spec(1, sqrt=True),
    "stddev_samp": _make_var_spec(1, sqrt=True),
    "stddev_pop": _make_var_spec(0, sqrt=True),
    "variance": _make_var_spec(1, sqrt=False),
    "var_samp": _make_var_spec(1, sqrt=False),
    "var_pop": _make_var_spec(0, sqrt=False),
    # collect_*: non-null values in first-appearance order (Spark drops
    # nulls in both; its ordering is unspecified — ours is deterministic)
    "collect_list": _AggSpec(
        lambda: [], lambda a, v: (a.append(v), a)[1], lambda a, b: a + b,
        lambda a: a,
    ),
    "collect_set": _AggSpec(
        lambda: {},
        _collect_set_update,
        lambda a, b: {**a, **{k: v for k, v in b.items() if k not in a}},
        lambda a: list(a.values()),
    ),
}
_AGG_SPECS["first"] = _AggSpec(
    # first NON-NULL value in partition order (Spark's
    # first(col, ignorenulls=True); nulls were pre-filtered)
    lambda: (None, False),
    lambda a, v: a if a[1] else (v, True),
    lambda a, b: a if a[1] else b,
    lambda a: a[0],
)
_AGG_SPECS["last"] = _AggSpec(
    lambda: (None, False),
    lambda a, v: (v, True),
    lambda a, b: b if b[1] else a,
    lambda a: a[0],
)
_AGG_SPECS["first_value"] = _AGG_SPECS["first"]
_AGG_SPECS["last_value"] = _AGG_SPECS["last"]
_AGG_SPECS["mean"] = _AGG_SPECS["avg"]


def _make_percentile_spec(p: float) -> _AggSpec:
    """Exact linear-interpolation percentile (numpy's default method)
    over the group's non-null values — the bounded-plane twin of
    ``sql.window_state.WINDOW_AGG_SPECS`` p50/p90/p95/p99, pinned
    against it by tests/test_continuous_sql.py."""

    def final(acc):
        if not acc:
            return None
        vals = sorted(acc)
        rank = (len(vals) - 1) * (p / 100.0)
        lo = math.floor(rank)
        hi = math.ceil(rank)
        if lo == hi:
            return float(vals[int(rank)])
        return float(vals[lo] + (vals[hi] - vals[lo]) * (rank - lo))

    return _AggSpec(
        lambda: [],
        lambda a, v: (a.append(float(v)), a)[1],
        lambda a, b: a + b,
        final,
    )


_AGG_SPECS["p50"] = _make_percentile_spec(50.0)
_AGG_SPECS["p90"] = _make_percentile_spec(90.0)
_AGG_SPECS["p95"] = _make_percentile_spec(95.0)
_AGG_SPECS["p99"] = _make_percentile_spec(99.0)


def _agg_result_type(fn_key: str, src: "Optional[DataType]") -> DataType:
    """Declared output type of aggregate ``fn_key`` over a column of
    declared type ``src`` (None for ``COUNT(*)``) — ONE mapping shared
    by GROUP BY and window aggregation so the two cannot drift.
    ``ObjectType`` means "unknown, probe the values"."""
    from sparkdl_tpu_torch.sql.types import (
        ArrayType,
        DoubleType,
        FloatType,
        IntegerType,
        LongType,
        ObjectType,
    )

    if fn_key in ("count", "count_distinct"):
        return LongType()
    if fn_key in ("avg", "mean", "stddev", "stddev_samp", "stddev_pop",
                  "variance", "var_samp", "var_pop",
                  "p50", "p90", "p95", "p99"):
        return DoubleType()
    if fn_key == "sum":
        # Spark widens: integral sums to long, fractional to double
        if isinstance(src, (IntegerType, LongType)):
            return LongType()
        if isinstance(src, (FloatType, DoubleType)):
            return DoubleType()
        return src if src is not None else ObjectType()
    if fn_key in ("min", "max", "first", "last", "first_value",
                  "last_value"):
        return src if src is not None else ObjectType()
    if fn_key in ("collect_list", "collect_set"):
        return ArrayType(src if src is not None else ObjectType())
    return ObjectType()


class GroupedData:
    """Result of :meth:`DataFrame.groupBy` — the pyspark ``GroupedData``
    subset the engine needs (count/sum/avg/min/max/agg).  Groups preserve
    first-appearance order; aggregation collects to the caller (the engine
    is a local substrate, so no shuffle is involved)."""

    def __init__(self, df: DataFrame, keys: List[str],
                 pivot: Optional[tuple] = None):
        self._df = df
        self._keys = keys
        self._pivot = pivot  # (pivot_col, explicit values or None)

    def pivot(self, pivot_col: str, values: Optional[Sequence] = None
              ) -> "GroupedData":
        """Pivot the distinct values of ``pivot_col`` into output
        columns (pyspark ``GroupedData.pivot``): the subsequent
        aggregate runs per (group, pivot value).  ``values`` fixes the
        column set explicitly (missing combinations are NULL);
        discovered values are sorted ascending, NULLs excluded."""
        if pivot_col not in self._df.columns:
            raise KeyError(f"No such column: {pivot_col!r}")
        if self._pivot is not None:
            raise ValueError("pivot() can only be applied once")
        return GroupedData(
            self._df, self._keys,
            pivot=(pivot_col, list(values) if values is not None else None),
        )

    # -- core -----------------------------------------------------------
    def agg(self, *exprs, **kwargs: str) -> DataFrame:
        """``agg({"score": "avg", "*": "count"})``, ``agg(score="avg")``,
        or aggregate Column expressions built by
        :mod:`sparkdl_tpu_torch.sql.functions` —
        ``agg(F.avg("score").alias("m"), F.count("*"))`` — as pyspark;
        output columns default to ``fn(col)``."""
        pairs: List[tuple] = []
        spec: Dict[str, str] = {}
        # back-compat: an older signature was agg(exprs={...})
        if isinstance(kwargs.get("exprs"), dict):
            spec.update(kwargs.pop("exprs"))
        for e in exprs:
            if e is None:
                continue
            if isinstance(e, dict):
                spec.update(e)
            elif isinstance(e, Column):
                marker = getattr(e, "_agg", None)
                if marker is None:
                    raise ValueError(
                        f"agg() Column {e._name!r} is not an aggregate; "
                        "build it with functions.avg/sum/count/... "
                        "(optionally .alias(...))"
                    )
                col_name, fn_key = marker
                pairs.append((col_name, fn_key, e._name))
            else:
                raise TypeError(
                    f"agg() takes a dict, keyword fn names, or aggregate "
                    f"Columns, got {type(e).__name__}"
                )
        spec.update(kwargs)
        for col_name, fn_name in spec.items():
            fn_key = fn_name.lower()
            pairs.append((col_name, fn_key, f"{fn_key}({col_name})"))
        if not pairs:
            raise ValueError("agg requires at least one aggregate")
        return self._aggregate(pairs)

    def _aggregate(self, pairs: List[tuple]) -> DataFrame:
        """``pairs``: (column-or-*, fn key, OUTPUT column name).  All
        validation lives here (every caller path gets the same errors):
        fn must be known, columns must exist, ``*`` only pairs with
        count, and output names must be unique.  With a pivot set, the
        pairs compute per (group, pivot value) and reshape wide.

        Execution is partial aggregation with projection pushdown: each
        partition folds ONLY the key + referenced columns into per-group
        :class:`_AggSpec` accumulators, and the caller merges the
        per-partition partials — an unreferenced column (e.g. the image
        struct of a scored view during ``GROUP BY label``) is never read,
        let alone materialized into whole rows.  Group order is
        first-appearance, as before."""
        for col_name, fn_key, _ in pairs:
            if fn_key not in _AGG_SPECS:
                raise ValueError(
                    f"Unsupported aggregate {fn_key!r}; supported: "
                    f"{sorted(_AGG_SPECS)}"
                )
            if col_name == "*":
                if fn_key != "count":
                    raise ValueError(
                        f"{fn_key}(*) is not defined; use a column"
                    )
            elif col_name not in self._df.columns:
                raise KeyError(f"No such column: {col_name!r}")
        if self._pivot is not None:
            return self._aggregate_pivot(pairs)
        out_names = list(self._keys) + [label for _, _, label in pairs]
        if len(set(out_names)) != len(out_names):
            raise ValueError(
                f"duplicate output columns in aggregation: {out_names}; "
                "alias repeated aggregates distinctly"
            )

        specs = [_AGG_SPECS[fn_key] for _, fn_key, _ in pairs]

        def partial(part: Partition):
            """One partition's ``{key: [acc, ...]}`` + key order."""
            n = _partition_nrows(part)
            key_cols = [part[k] for k in self._keys]
            val_cols = [
                part[c] if c != "*" else None for c, _, _ in pairs
            ]
            accs: Dict[tuple, list] = {}
            order: List[tuple] = []
            for i in range(n):
                key = tuple(kc[i] for kc in key_cols)
                try:
                    group = accs[key]
                except KeyError:
                    group = accs[key] = [s.init() for s in specs]
                    order.append(key)
                except TypeError:
                    raise TypeError(
                        f"unhashable GROUP BY key value in {self._keys}; "
                        "group keys must be hashable scalars"
                    ) from None
                for j, vc in enumerate(val_cols):
                    if vc is None:  # COUNT(*): every row counts
                        group[j] = specs[j].update(group[j], True)
                    else:
                        v = vc[i]
                        if v is not None:
                            group[j] = specs[j].update(group[j], v)
            return accs, order

        merged: Dict[tuple, list] = {}
        order: List[tuple] = []
        for part in self._df._partitions:
            p_accs, p_order = partial(part)
            for key in p_order:
                if key in merged:
                    merged[key] = [
                        s.merge(a, b)
                        for s, a, b in zip(specs, merged[key], p_accs[key])
                    ]
                else:
                    merged[key] = p_accs[key]
                    order.append(key)
        if not self._keys and not order:
            # SQL semantics: an ungrouped aggregate over zero rows yields
            # exactly one row (COUNT(*) = 0, SUM/AVG/... = NULL)
            merged[()] = [s.init() for s in specs]
            order.append(())

        part_out: Partition = {name: [] for name in out_names}
        for key in order:
            for k, v in zip(self._keys, key):
                part_out[k].append(v)
            for (_, _, label), spec, acc in zip(pairs, specs, merged[key]):
                part_out[label].append(spec.final(acc))

        return DataFrame(
            [part_out], self._output_schema(pairs, part_out),
            self._df.sparkSession,
        )

    def _aggregate_pivot(self, pairs: List[tuple]) -> DataFrame:
        """Wide reshape: aggregate grouped by keys + pivot column, then
        spread each pivot value into its own column set.  Missing
        (group, value) combinations are NULL; one aggregate names
        columns ``str(value)``, several name them ``value_label``."""
        pcol, pvals = self._pivot
        base = GroupedData(
            self._df, self._keys + [pcol]
        )._aggregate(pairs)
        labels = [label for _, _, label in pairs]
        base_part = base._partitions[0]
        if pvals is None:
            seen = {
                v for v in base_part[pcol] if v is not None
            }  # discovered values: NULL pivot groups are dropped
            try:
                pvals = sorted(seen)
            except TypeError:
                pvals = sorted(seen, key=lambda v: (str(type(v)), str(v)))
        single = len(labels) == 1

        def col_name(v, label):
            v_str = "null" if v is None else str(v)
            return v_str if single else f"{v_str}_{label}"

        # pivot-derived names are data-driven: a value that collides
        # with a group key, or two values that stringify identically
        # (1 vs "1"), would silently overwrite dict entries downstream
        out_names = list(self._keys) + [
            col_name(v, label) for v in pvals for label in labels
        ]
        if len(set(out_names)) != len(out_names):
            dupes = sorted(
                {n for n in out_names if out_names.count(n) > 1}
            )
            raise ValueError(
                f"pivot produces duplicate output columns {dupes}; "
                "rename the group key or restrict/clean the pivot "
                "values"
            )

        # (group key tuple) -> {pivot value -> row index in base}
        n_base = _partition_nrows(base_part)
        key_cols = [base_part[k] for k in self._keys]
        pivot_vals = base_part[pcol]
        index: Dict[tuple, Dict[Any, int]] = {}
        gorder: List[tuple] = []
        for i in range(n_base):
            key = tuple(kc[i] for kc in key_cols)
            if key not in index:
                index[key] = {}
                gorder.append(key)
            index[key][pivot_vals[i]] = i

        out: Partition = {k: [] for k in self._keys}
        for v in pvals:
            for label in labels:
                out[col_name(v, label)] = []
        for key in gorder:
            for k, kv in zip(self._keys, key):
                out[k].append(kv)
            for v in pvals:
                i = index[key].get(v)
                for label in labels:
                    out[col_name(v, label)].append(
                        base_part[label][i] if i is not None else None
                    )

        st = StructType()
        for k in self._keys:
            st.add(k, self._df._field_type(k))
        for v in pvals:
            for label in labels:
                st.add(col_name(v, label), base.schema[label].dataType)
        return DataFrame([out], st, self._df.sparkSession)

    def _output_schema(self, pairs: List[tuple], part_out: Partition
                       ) -> StructType:
        """Aggregation output types from the SOURCE frame's declared
        schema, not value probes — an all-NULL output column (outer-join
        side that never matched) must keep its declared type so
        ``df.na.fill``'s type-matched semantics still reach it."""
        from sparkdl_tpu_torch.sql.types import ObjectType

        st = StructType()
        for k in self._keys:
            st.add(k, self._df._field_type(k))
        for col_name, fn_key, label in pairs:
            t = _agg_result_type(
                fn_key,
                self._df._field_type(col_name) if col_name != "*" else None,
            )
            if isinstance(t, ObjectType):
                probe = next(
                    (v for v in part_out[label] if v is not None), None
                )
                t = infer_type(probe)
            st.add(label, t)
        return st

    # -- named helpers (pyspark surface) --------------------------------
    def count(self) -> DataFrame:
        df = self._aggregate([("*", "count", "count")])
        return df

    def _each(self, fn_key: str, cols: Sequence[str]) -> DataFrame:
        if not cols:
            # pyspark semantics: the no-arg form aggregates every NUMERIC
            # non-key column (a string column would crash sum/avg)
            from sparkdl_tpu_torch.sql.types import (
                DoubleType,
                FloatType,
                IntegerType,
                LongType,
            )

            numeric = (IntegerType, LongType, FloatType, DoubleType)
            cols = [
                f.name
                for f in self._df.schema
                if f.name not in self._keys
                and isinstance(f.dataType, numeric)
            ]
            if not cols:
                raise ValueError(
                    f"no numeric columns to {fn_key} over; name columns "
                    "explicitly"
                )
        return self._aggregate(
            [(c, fn_key, f"{fn_key}({c})") for c in cols]
        )

    def sum(self, *cols: str) -> DataFrame:
        return self._each("sum", cols)

    def avg(self, *cols: str) -> DataFrame:
        return self._each("avg", cols)

    mean = avg

    def min(self, *cols: str) -> DataFrame:
        return self._each("min", cols)

    def max(self, *cols: str) -> DataFrame:
        return self._each("max", cols)
