"""``TorchSession``: the SparkSession analog of the port.

The part of ``sparkdl_tpu.sql.session`` that the port's transformers and
UDFs use: ``TorchSession.builder...getOrCreate()``, ``createDataFrame``,
temporary views (``DataFrame.createOrReplaceTempView``, ``table``), the UDF
registry (``session.udf.register``) and ``sql`` for the queries that serve a
UDF::

    SELECT <item>[, <item> ...] FROM <view>

where an item is ``*``, a column name, or a registered UDF applied to
column names, each with an optional ``AS <name>``. Any other query raises
``NotImplementedError``: the rest of the JAX package's dialect is ROADMAP
item 14.
"""

from __future__ import annotations

import re
from typing import Any, Callable, Dict, Iterable, List, Optional

from sparkdl_tpu_torch.sql.dataframe import DataFrame, Partition
from sparkdl_tpu_torch.sql.functions import Column, UserDefinedFunction, col
from sparkdl_tpu_torch.sql.types import Row, StructType, infer_type

_NAME = r"(?:[A-Za-z_]\w*|`[^`]+`)"
_QUERY_RE = re.compile(rf"\s*SELECT\s+(?P<items>.+?)\s+FROM\s+(?P<view>{_NAME})\s*;?\s*",
                       re.IGNORECASE | re.DOTALL)
_ITEM_RE = re.compile(
    rf"(?:(?P<star>\*)|(?P<fn>{_NAME})\s*\(\s*(?P<args>{_NAME}(?:\s*,\s*{_NAME})*)?\s*\)"
    rf"|(?P<col>{_NAME}))(?:\s+AS\s+(?P<alias>{_NAME}))?",
    re.IGNORECASE | re.DOTALL)


def _unquote(name: str) -> str:
    return name[1:-1] if name.startswith("`") else name


def _unsupported(query: str) -> NotImplementedError:
    return NotImplementedError(
        f"session.sql supports SELECT <column | * | udf(columns)> [AS name], ... "
        f"FROM <view>; the rest of the dialect is ROADMAP item 14: {query!r}"
    )


class UDFRegistry:
    """``session.udf``: named UDFs that ``session.sql`` can call."""

    def __init__(self):
        self._udfs: Dict[str, UserDefinedFunction] = {}

    def register(
        self,
        name: str,
        f: "Callable | UserDefinedFunction",
        returnType=None,
        vectorized: bool = False,
    ) -> UserDefinedFunction:
        if not isinstance(f, UserDefinedFunction):
            f = UserDefinedFunction(f, returnType, name=name, vectorized=vectorized)
        else:
            f = UserDefinedFunction(f.func, returnType or f.returnType, name, f.vectorized)
        self._udfs[name] = f
        return f

    def __contains__(self, name: str) -> bool:
        return name in self._udfs

    def resolve(self, name: str) -> Optional[UserDefinedFunction]:
        """The UDF for ``name``: an exact match first, else the one match
        ignoring case (Spark resolves functions case-insensitively); None
        when unregistered. Two registrations differing only by case make
        any third casing ambiguous, which raises."""
        if name in self._udfs:
            return self._udfs[name]
        hits = [k for k in self._udfs if k.lower() == name.lower()]
        if len(hits) > 1:
            raise KeyError(f"Ambiguous function name {name!r}: case-insensitively "
                           f"matches {sorted(hits)}; use one of those exact spellings")
        return self._udfs[hits[0]] if hits else None

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
        self._views: Dict[str, DataFrame] = {}
        self.udf = UDFRegistry()
        TorchSession._active = self

    @classmethod
    def getActiveSession(cls) -> "TorchSession":
        if cls._active is None:
            cls._active = TorchSession()
        return cls._active

    def table(self, name: str) -> DataFrame:
        try:
            return self._views[name]
        except KeyError:
            raise KeyError(f"Table or view not found: {name!r}") from None

    def sql(self, query: str) -> DataFrame:
        """Evaluate ``SELECT <item>[, <item> ...] FROM <view>`` (see the
        module's docstring); anything else raises ``NotImplementedError``."""
        m = _QUERY_RE.fullmatch(query)
        if m is None:
            raise _unsupported(query)
        df = self.table(_unquote(m.group("view")))
        projection: List["Column | str"] = []
        for item in _split_items(m.group("items")):
            im = _ITEM_RE.fullmatch(item.strip())
            if im is None:
                raise _unsupported(query)
            alias = im.group("alias")
            if im.group("star"):
                if alias:
                    raise _unsupported(query)
                projection.append("*")
                continue
            if im.group("col"):
                expr = col(_unquote(im.group("col")))
            else:
                name = _unquote(im.group("fn"))
                fn = self.udf.resolve(name)
                if fn is None:
                    raise NotImplementedError(
                        f"{name!r} is not a registered UDF; the dialect's built-in "
                        "functions are ROADMAP item 14")
                args = [_unquote(a.strip()) for a in (im.group("args") or "").split(",")
                        if a.strip()]
                expr = fn(*args)
            projection.append(expr.alias(_unquote(alias)) if alias else expr)
        return df.select(*projection)

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


def _split_items(text: str) -> List[str]:
    """The SELECT list split at the commas outside parentheses."""
    items, depth, start = [], 0, 0
    for i, ch in enumerate(text):
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth -= 1
        elif ch == "," and depth == 0:
            items.append(text[start:i])
            start = i + 1
    items.append(text[start:])
    return items
