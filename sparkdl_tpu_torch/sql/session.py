"""``TorchSession``: the SparkSession analog of the port, a copy of
``sparkdl_tpu.sql.session`` (host Python, unchanged but for its imports).

Owns the catalog of temp views and stream tables, the UDF registry (the
TensorFrames-UDF registration surface) and the SQL dialect: joins, WHERE,
GROUP BY, HAVING, ORDER BY, LIMIT, ``UNION``/``EXCEPT``/``INTERSECT
[ALL]``, derived tables, ``IN (SELECT ...)`` and window functions, so
``SELECT my_udf(image) FROM images`` runs a model UDF like the reference's
SQL path. ``readStream`` and ``sqlStream`` register stream tables and
standing windowed queries (:mod:`sparkdl_tpu_torch.sql.continuous`).
"""

from __future__ import annotations

import re
from typing import (
    Any,
    Callable,
    Dict,
    Iterable,
    List,
    NamedTuple,
    Optional,
    Sequence,
)

import numpy as np

from sparkdl_tpu_torch.sql.dataframe import DataFrame, Partition
from sparkdl_tpu_torch.sql.functions import Column, UserDefinedFunction, col
from sparkdl_tpu_torch.sql.types import Row, StructType, infer_type

DEFAULT_PARTITIONS = 4


class CatalogTable(NamedTuple):
    """One ``listTables`` entry: ``tableType`` is ``"TEMPORARY"`` for a
    bounded temp view, ``"STREAM"`` for a registered stream table (the
    PySpark ``Catalog.listTables`` shape, minus the database levels)."""

    name: str
    tableType: str


class Catalog:
    def __init__(self):
        self._views: Dict[str, DataFrame] = {}
        #: name -> sql.continuous.StreamTable (unbounded; not a view)
        self._streams: Dict[str, Any] = {}

    def listTables(self):
        return sorted(
            [CatalogTable(n, "TEMPORARY") for n in self._views]
            + [CatalogTable(n, "STREAM") for n in self._streams]
        )

    def dropTempView(self, name: str):
        """Drop a bounded temp view.  A *stream* table is not a temp
        view — dropping one here raises typed errors instead of
        silently unregistering an unbounded source (use
        :meth:`dropStreamTable`)."""
        if name in self._streams:
            from sparkdl_tpu_torch.sql.continuous import StreamTableError

            raise StreamTableError(
                f"{name!r} is a stream table, not a temp view; use "
                "dropStreamTable()"
            )
        self._views.pop(name, None)

    # -- stream tables (sql.continuous) --------------------------------
    def registerStreamTable(self, name: str, source) -> Any:
        """Register ``source`` (a :class:`StreamSource`) as stream table
        ``name``.  The name must not collide with a temp view — a query
        binding it must never be ambiguous about boundedness."""
        from sparkdl_tpu_torch.sql.continuous import StreamTable, StreamTableError

        if name in self._views:
            raise StreamTableError(
                f"{name!r} is already a bounded temp view; a stream "
                "table cannot shadow it"
            )
        existing = self._streams.get(name)
        if existing is not None and existing.active_query is not None:
            raise StreamTableError(
                f"stream table {name!r} is being read by running query "
                f"{existing.active_query!r}; stop it before re-registering"
            )
        table = StreamTable(name, source)
        self._streams[name] = table
        return table

    def streamTable(self, name: str):
        """The registered :class:`StreamTable`, with typed errors that
        name what the caller actually hit (temp view vs nothing)."""
        from sparkdl_tpu_torch.sql.continuous import StreamTableError

        table = self._streams.get(name)
        if table is None:
            if name in self._views:
                raise StreamTableError(
                    f"{name!r} is a bounded temp view, not a stream "
                    "table; continuous queries need "
                    "session.readStream(...)"
                )
            raise StreamTableError(f"Stream table not found: {name!r}")
        return table

    def dropStreamTable(self, name: str):
        """Unregister a stream table; refuses while a continuous query
        is reading it (the error names the running query)."""
        from sparkdl_tpu_torch.sql.continuous import StreamTableError

        table = self._streams.get(name)
        if table is None:
            return
        if table.active_query is not None:
            raise StreamTableError(
                f"cannot drop stream table {name!r}: continuous query "
                f"{table.active_query!r} is reading it; close the query "
                "first"
            )
        del self._streams[name]


class UDFRegistry:
    def __init__(self, session: "TorchSession"):
        self._session = session
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

    def get(self, name: str) -> UserDefinedFunction:
        try:
            return self._udfs[name]
        except KeyError:
            raise KeyError(f"Undefined function: {name!r}") from None

    def resolve(self, name: str) -> Optional[UserDefinedFunction]:
        """The UDF for ``name`` — exact match first, else
        case-insensitive (Spark's function resolution is
        case-insensitive); None when unregistered.  Two registrations
        differing only by case make any THIRD casing ambiguous — that
        raises rather than silently resolving by registration order."""
        if name in self._udfs:
            return self._udfs[name]
        lowered = name.lower()
        hits = [k for k in self._udfs if k.lower() == lowered]
        if len(hits) > 1:
            raise KeyError(
                f"Ambiguous function name {name!r}: case-insensitively "
                f"matches {sorted(hits)}; use one of those exact spellings"
            )
        return self._udfs[hits[0]] if hits else None

    def __contains__(self, name: str):
        # `in` keeps its bool contract even when resolution is ambiguous:
        # a case-ambiguous name IS registered (twice), so membership is
        # True — the informative error surfaces later when the call path
        # actually resolves it
        try:
            return self.resolve(name) is not None
        except KeyError:
            return True


class DataFrameReader:
    def __init__(self, session: "TorchSession"):
        self._session = session
        self._format: Optional[str] = None
        self._options: Dict[str, Any] = {}

    def format(self, source: str) -> "DataFrameReader":
        self._format = source
        return self

    def option(self, key: str, value: Any) -> "DataFrameReader":
        self._options[key] = value
        return self

    def load(self, path: str) -> DataFrame:
        if self._format == "image":
            from sparkdl_tpu_torch.image.imageIO import readImages

            return readImages(
                path,
                session=self._session,
                numPartitions=int(
                    self._options.get("numPartitions", DEFAULT_PARTITIONS)
                ),
            )
        if self._format == "binaryFile":
            from sparkdl_tpu_torch.image.imageIO import filesToDF

            return filesToDF(self._session, path)
        raise ValueError(f"Unsupported reader format: {self._format!r}")

    def image(self, path: str) -> DataFrame:
        return self.format("image").load(path)


class _Builder:
    def __init__(self):
        self._conf: Dict[str, Any] = {}
        self._appName = "sparkdl_tpu_torch"

    def master(self, _master: str) -> "_Builder":
        return self

    def appName(self, name: str) -> "_Builder":
        self._appName = name
        return self

    def config(self, key: str, value: Any) -> "_Builder":
        self._conf[key] = value
        return self

    def getOrCreate(self) -> "TorchSession":
        if TorchSession._active is None:
            TorchSession._active = TorchSession(self._appName, self._conf)
        return TorchSession._active


class TorchSession:
    _active: Optional["TorchSession"] = None

    builder = _Builder()

    def __init__(self, appName: str = "sparkdl_tpu_torch", conf: Optional[dict] = None):
        self.appName = appName
        self.conf = dict(conf or {})
        self.catalog = Catalog()
        self.udf = UDFRegistry(self)
        TorchSession._active = self

    @classmethod
    def getActiveSession(cls) -> "TorchSession":
        if cls._active is None:
            cls._active = TorchSession()
        return cls._active

    # ------------------------------------------------------------------
    def createDataFrame(
        self,
        data: "Iterable[Any]",
        schema: "Optional[StructType | List[str]]" = None,
        numPartitions: int = DEFAULT_PARTITIONS,
    ) -> DataFrame:
        """Create a DataFrame from rows (Row / dict / tuple) or a pandas
        DataFrame."""
        try:
            import pandas as pd

            if isinstance(data, pd.DataFrame):
                names = list(data.columns)
                rows = [tuple(rec) for rec in data.itertuples(index=False)]
                data = rows
                if schema is None:
                    schema = names
        except ImportError:  # pragma: no cover
            pass

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
                # first NON-NULL value anywhere in the column (same probe
                # discipline as DataFrame._infer_column_type — a leading
                # None must not leave the column untyped)
                probe = next(
                    (row[j] for row in values if row[j] is not None), None
                )
                st.add(c, infer_type(probe))
        return DataFrame(parts, st, self)

    @property
    def read(self) -> DataFrameReader:
        return DataFrameReader(self)

    def table(self, name: str) -> DataFrame:
        try:
            return self.catalog._views[name]
        except KeyError:
            if name in self.catalog._streams:
                from sparkdl_tpu_torch.sql.continuous import StreamTableError

                raise StreamTableError(
                    f"{name!r} is a stream table; it has no bounded "
                    "DataFrame — run a continuous query over it with "
                    "session.sqlStream(...)"
                ) from None
            raise KeyError(f"Table or view not found: {name!r}") from None

    # ------------------------------------------------------------------
    # continuous queries (sql.continuous)
    # ------------------------------------------------------------------
    def readStream(self, name: str, source):
        """Register ``source`` (a
        :class:`~sparkdl_tpu_torch.streaming.sources.StreamSource`) as stream
        table ``name`` so continuous queries can bind it by name.
        Returns the catalog's :class:`StreamTable` entry."""
        return self.catalog.registerStreamTable(name, source)

    def sqlStream(
        self,
        query: str,
        sink,
        checkpoint_dir: str,
        late_sink=None,
        server=None,
        config=None,
        name: Optional[str] = None,
    ):
        """A standing windowed query over a registered stream table —
        ``SELECT key, p95(latency) FROM scores GROUP BY
        WINDOW(event_time_ms, '10s'), key`` — as a
        :class:`~sparkdl_tpu_torch.sql.continuous.ContinuousQuery` (call
        ``.run(...)`` to drive it; exactly-once emission into ``sink``
        via ``checkpoint_dir``'s commit log)."""
        from sparkdl_tpu_torch.sql.continuous import ContinuousQuery

        return ContinuousQuery(
            self, query, sink, checkpoint_dir,
            late_sink=late_sink, server=server, config=config, name=name,
        )

    def range(self, start: int, end: Optional[int] = None, step: int = 1):
        if end is None:
            start, end = 0, start
        return self.createDataFrame(
            [(i,) for i in range(start, end, step)], ["id"]
        )

    # ------------------------------------------------------------------
    # Minimal SQL: SELECT <exprs> FROM <view> [<alias>]
    #   [[INNER|LEFT [OUTER]|RIGHT [OUTER]|FULL [OUTER]] JOIN <view>
    #    [<alias>] ON a.k = b.k [AND ...]]*
    #   [WHERE <pred>] [GROUP BY <cols>] [HAVING <pred>]
    #   [ORDER BY <col> [ASC|DESC]] [LIMIT n]
    #   expr := * | ident | fn(ident, ...) [AS alias]
    #           | COUNT(*|ident) | SUM/AVG/MEAN/MIN/MAX(ident) [AS alias]
    #   pred := comparisons composed with AND / OR / NOT / IN (...) / parens
    # ------------------------------------------------------------------
    _KEYWORDS = (
        r"WHERE|GROUP|HAVING|ORDER|LIMIT|JOIN|INNER|LEFT|RIGHT|FULL|ON"
    )
    # The ON condition is a sequence of non-keyword tokens (each token
    # guarded by a lookahead) rather than a lazy [\w\s.=]+? blob: a blob
    # could also absorb a following "JOIN ..." clause, making the outer
    # (...)* ambiguous — which is catastrophic-backtracking territory on
    # malformed queries (measured ~4x slower per 2 extra JOIN clauses).
    _ON_COND = (
        rf"(?:\s*(?!(?:{_KEYWORDS})\b)[\w.=]+)+"
    )
    # The SELECT head (projections + FROM + joins).  Tail clauses
    # (WHERE/GROUP BY/HAVING/ORDER BY/LIMIT) are split off FIRST by the
    # paren- and literal-aware :meth:`_split_clauses` — a lazy
    # ``(?P<where>.+?)(?:\s+GROUP\s+BY...)`` regex would stop at the
    # first keyword *textually*, mis-splitting ``WHERE x IN (SELECT ...
    # GROUP BY k)`` at the subquery's GROUP BY instead of treating the
    # whole parenthesized predicate as the WHERE clause.
    _SQL_HEAD_RE = re.compile(
        r"^\s*SELECT\s+(?P<distinct>DISTINCT\s+)?(?P<proj>.+?)\s+FROM\s+(?P<table>\w+)"
        rf"(?:\s+(?:AS\s+)?(?!(?:{_KEYWORDS})\b)(?P<talias>\w+))?"
        r"(?P<joins>(?:\s+(?:INNER\s+|LEFT\s+(?:OUTER\s+)?|RIGHT\s+"
        r"(?:OUTER\s+)?|FULL\s+(?:OUTER\s+)?)?JOIN\s+\w+"
        rf"(?:\s+(?:AS\s+)?(?!ON\b)\w+)?\s+ON\b{_ON_COND})*)"
        r"\s*$",
        re.IGNORECASE | re.DOTALL,
    )
    #: tail clauses in canonical order (keyword regex, clause key)
    _CLAUSE_KEYWORDS = (
        (r"WHERE", "where"),
        (r"GROUP\s+BY", "group"),
        (r"HAVING", "having"),
        (r"ORDER\s+BY", "order"),
        (r"LIMIT", "limit"),
    )
    _CLAUSE_RE = re.compile(
        r"\b(?P<kw>WHERE|GROUP\s+BY|HAVING|ORDER\s+BY|LIMIT)\b",
        re.IGNORECASE,
    )
    _JOIN_CLAUSE_RE = re.compile(
        r"\s+(?P<how>INNER\s+|LEFT\s+(?:OUTER\s+)?|RIGHT\s+(?:OUTER\s+)?"
        r"|FULL\s+(?:OUTER\s+)?)?JOIN\s+(?P<table>\w+)"
        r"(?:\s+(?:AS\s+)?(?!ON\b)(?P<alias>\w+))?\s+ON\b"
        rf"(?P<cond>{_ON_COND})",
        re.IGNORECASE,
    )
    _AGG_FN_ALT = (
        r"count|sum|avg|mean|min|max|stddev_samp|stddev_pop|stddev"
        r"|var_samp|var_pop|variance|collect_list|collect_set"
        r"|first_value|first|last_value|last"
        r"|p50|p90|p95|p99"
    )
    _AGG_RE = re.compile(
        rf"^(?P<fn>{_AGG_FN_ALT})\s*\(\s*"
        r"(?P<distinct>DISTINCT\s+)?(?P<arg>\*|.+?)\s*\)$",
        re.IGNORECASE | re.DOTALL,
    )
    _AGG_CALL_RE = re.compile(
        rf"\b(?P<fn>{_AGG_FN_ALT})\s*\(", re.IGNORECASE
    )

    #: window functions — the OVER () clause the reference's serving
    #: analytics used through Spark SQL: ranking (top-K per group),
    #: aggregates (share-of-partition, running totals under Spark's
    #: default RANGE frame), and LAG/LEAD shifts
    _WINDOW_RE = re.compile(
        r"^(?P<fn>ROW_NUMBER|RANK|DENSE_RANK|PERCENT_RANK|CUME_DIST"
        r"|NTILE|LAG|LEAD"
        r"|COUNT|SUM|AVG|MEAN|MIN|MAX"
        r"|STDDEV_SAMP|STDDEV_POP|STDDEV|VAR_SAMP|VAR_POP|VARIANCE"
        r"|COLLECT_LIST|COLLECT_SET|FIRST_VALUE|FIRST|LAST_VALUE|LAST)"
        r"\s*\(\s*(?P<arg>.*?)\s*\)\s+OVER\s*\(\s*"
        r"(?:PARTITION\s+BY\s+(?P<part>.+?)\s*)?"
        r"(?:ORDER\s+BY\s+(?P<ord>.+?)\s*)?"
        r"(?:ROWS\s+BETWEEN\s+(?P<fstart>UNBOUNDED\s+PRECEDING"
        r"|\d+\s+PRECEDING|CURRENT\s+ROW|\d+\s+FOLLOWING)"
        r"\s+AND\s+(?P<fend>UNBOUNDED\s+FOLLOWING|\d+\s+PRECEDING"
        r"|CURRENT\s+ROW|\d+\s+FOLLOWING)\s*)?\)\s*$",
        re.IGNORECASE | re.DOTALL,
    )

    @classmethod
    def _parse_frame(cls, fstart: str, fend: str) -> tuple:
        """ROWS bounds -> ``(lo, hi)`` row offsets (None = unbounded),
        validated: an inverted frame (start after end) is an error, as
        in Spark — not an all-NULL column."""
        def bound(text: str) -> Optional[int]:
            t = re.sub(r"\s+", " ", text.strip()).upper()
            if t in ("UNBOUNDED PRECEDING", "UNBOUNDED FOLLOWING"):
                return None
            if t == "CURRENT ROW":
                return 0
            n, direction = t.split(" ")
            return -int(n) if direction == "PRECEDING" else int(n)

        lo, hi = bound(fstart), bound(fend)
        if lo is not None and hi is not None and lo > hi:
            raise ValueError(
                f"ROWS BETWEEN: frame start ({fstart.strip()}) is "
                f"after its end ({fend.strip()})"
            )
        return lo, hi

    _subq_counter = 0  # class-wide: unique derived-table view names

    # -- text-level helpers (string-literal- and paren-aware) -----------
    @staticmethod
    def _literal_spans(text: str) -> List[tuple]:
        return [
            m.span()
            for m in re.finditer(
                r"'(?:[^'\\]|\\.)*'|\"(?:[^\"\\]|\\.)*\"", text
            )
        ]

    @staticmethod
    def _depth_profile(text: str, spans: List[tuple]) -> List[int]:
        """Paren nesting depth at each character (string literals
        ignored) — what makes keyword scans respect subqueries."""
        def in_str(i: int) -> bool:
            return any(lo <= i < hi for lo, hi in spans)

        depth, out = 0, []
        for i, ch in enumerate(text):
            if not in_str(i):
                if ch == "(":
                    depth += 1
                elif ch == ")":
                    depth -= 1
            out.append(depth)
        return out

    @staticmethod
    def _matching_paren(text: str, open_i: int, spans: List[tuple]) -> int:
        def in_str(i: int) -> bool:
            return any(lo <= i < hi for lo, hi in spans)

        depth = 0
        for i in range(open_i, len(text)):
            if in_str(i):
                continue
            if text[i] == "(":
                depth += 1
            elif text[i] == ")":
                depth -= 1
                if depth == 0:
                    return i
        raise ValueError(f"Unbalanced parentheses in {text!r}")

    @classmethod
    def _split_set_ops(cls, query: str):
        """Split at top-level ``UNION/INTERSECT/EXCEPT [ALL]`` joints.
        Returns ``[(op_joining_to_previous, segment), ...]`` with the
        first op ``None``; op strings are e.g. ``union``/``union_all``."""
        spans = cls._literal_spans(query)
        depth_at = cls._depth_profile(query, spans)

        def in_str(i: int) -> bool:
            return any(lo <= i < hi for lo, hi in spans)

        out, last, prev_op = [], 0, None
        for m in re.finditer(
            r"\b(UNION|INTERSECT|EXCEPT)(?:\s+(ALL))?\b", query,
            re.IGNORECASE,
        ):
            if in_str(m.start()) or depth_at[m.start()] != 0:
                continue
            out.append((prev_op, query[last:m.start()]))
            prev_op = m.group(1).lower() + ("_all" if m.group(2) else "")
            last = m.end()
        out.append((prev_op, query[last:]))
        return out

    @classmethod
    def _split_clauses(cls, query: str):
        """Split a single SELECT into ``(head, clauses)`` at the
        *top-level* WHERE / GROUP BY / HAVING / ORDER BY / LIMIT
        keywords — paren-depth- and string-literal-aware (same machinery
        as :meth:`_split_set_ops`), so the same keywords inside a
        subquery (``WHERE x IN (SELECT ... GROUP BY k)``) stay part of
        the enclosing clause text.

        Returns ``None`` when the query is not in the dialect's clause
        shape (out-of-order or duplicate clauses, non-integer LIMIT) —
        the caller raises its uniform "Unsupported SQL" error."""
        query = re.sub(r";\s*$", "", query)
        spans = cls._literal_spans(query)
        depth_at = cls._depth_profile(query, spans)

        def in_str(i: int) -> bool:
            return any(lo <= i < hi for lo, hi in spans)

        keys = [k for _, k in cls._CLAUSE_KEYWORDS]
        hits = []  # (canonical_index, match)
        for m in cls._CLAUSE_RE.finditer(query):
            if in_str(m.start()) or depth_at[m.start()] != 0:
                continue
            kw = re.sub(r"\s+", " ", m.group("kw")).upper()
            canon = {"WHERE": "where", "GROUP BY": "group",
                     "HAVING": "having", "ORDER BY": "order",
                     "LIMIT": "limit"}[kw]
            hits.append((keys.index(canon), m))
        # canonical order, no duplicates — anything else isn't dialect
        order = [i for i, _ in hits]
        if order != sorted(set(order)):
            return None
        head = query[: hits[0][1].start()] if hits else query
        clauses = {}
        for pos, (i, m) in enumerate(hits):
            end = hits[pos + 1][1].start() if pos + 1 < len(hits) else len(query)
            text = query[m.end():end].strip()
            if not text:
                return None
            clauses[keys[i]] = text
        if "limit" in clauses and not clauses["limit"].isdigit():
            return None
        return head, clauses

    @classmethod
    def _parse_order_items(cls, text: str) -> List[tuple]:
        """``(expression_text, ascending)`` per top-level comma item."""
        items = []
        for raw in cls._split_projections(text):
            raw = raw.strip()
            om = re.match(
                r"^(?P<e>.+?)(?:\s+(?P<dir>ASC|DESC))?\s*$", raw,
                re.IGNORECASE | re.DOTALL,
            )
            d = om.group("dir")
            items.append(
                (om.group("e").strip(), d is None or d.upper() != "DESC")
            )
        return items

    def _lift_derived_tables(self, query: str, created: List[str]) -> str:
        """Replace every ``FROM ( SELECT ... )`` / ``JOIN ( SELECT ... )``
        derived table with a temp view of its (recursively) evaluated
        result.  View names go on ``created`` for the caller to drop."""
        while True:
            spans = self._literal_spans(query)
            m = next(
                (
                    c
                    for c in re.finditer(
                        r"\b(FROM|JOIN)\s*\(", query, re.IGNORECASE
                    )
                    if not any(lo <= c.start() < hi for lo, hi in spans)
                ),
                None,
            )
            if m is None:
                return query
            open_i = m.end() - 1
            close_i = self._matching_paren(query, open_i, spans)
            inner = query[open_i + 1:close_i].strip()
            if not re.match(r"^SELECT\b", inner, re.IGNORECASE):
                raise ValueError(
                    f"Expected a SELECT subquery after "
                    f"{m.group(1).upper()} ( in {query!r}"
                )
            TorchSession._subq_counter += 1
            name = f"__subq_{TorchSession._subq_counter}"
            self.sql(inner).createOrReplaceTempView(name)
            created.append(name)
            query = (
                f"{query[:m.start()]}{m.group(1)} {name}"
                f"{query[close_i + 1:]}"
            )

    # -- the dialect ----------------------------------------------------
    def sql(self, query: str) -> DataFrame:
        """Evaluate a query in the minimal dialect (see the grammar note
        above :data:`_SQL_HEAD_RE`, plus: ``UNION [ALL]`` between SELECTs,
        derived tables ``FROM (SELECT ...) t``, uncorrelated
        ``IN (SELECT ...)``, ranking window functions, and expression
        ORDER BY / GROUP BY)."""
        created: List[str] = []
        try:
            return self._sql_query(query, created)
        finally:
            for n in created:
                self.catalog.dropTempView(n)

    @staticmethod
    def _align_columns(left: DataFrame, right: DataFrame) -> DataFrame:
        """Positional column resolution for set operations: the first
        branch's names win (as Spark); two-phase rename avoids
        transient collisions."""
        names = left.columns
        if len(right.columns) != len(names):
            raise ValueError(
                f"Set operation requires the same column count: "
                f"{names} vs {right.columns}"
            )
        if right.columns != names:
            from sparkdl_tpu_torch.sql.dataframe import _disjoint_tmp_names

            tmp = _disjoint_tmp_names(
                len(names), set(right.columns) | set(names)
            )
            for old, t in zip(list(right.columns), tmp):
                right = right.withColumnRenamed(old, t)
            for t, new in zip(tmp, names):
                right = right.withColumnRenamed(t, new)
        return right

    def _fold_setop(
        self, left: DataFrame, op: str, right: DataFrame
    ) -> DataFrame:
        right = self._align_columns(left, right)
        if op == "union_all":
            return left.union(right)
        if op == "union":  # bare UNION dedupes the combined result
            return left.union(right).dropDuplicates()
        if op == "except":
            return left.subtract(right)
        if op == "except_all":
            return left.exceptAll(right)
        if op == "intersect":
            return left.intersect(right)
        if op == "intersect_all":
            return left.intersectAll(right)
        raise AssertionError(op)  # pragma: no cover

    def _sql_query(self, query: str, created: List[str]) -> DataFrame:
        pieces = self._split_set_ops(query)
        if len(pieces) == 1:
            return self._sql_select(query, created)
        # standard SQL: a trailing ORDER BY / LIMIT closes the whole
        # compound query, not the last branch
        last_op, last_seg = pieces[-1]
        tail, order_text, limit_n = self._strip_tail_order_limit(last_seg)
        pieces[-1] = (last_op, tail)
        evaluated = [
            (op, self._sql_select(seg, created)) for op, seg in pieces
        ]
        # precedence: INTERSECT [ALL] binds tighter than UNION/EXCEPT
        # (as SQL/Spark) — fold intersect-runs first, then the chain
        groups: List[tuple] = []
        cur_op, cur_df = None, None
        for op, df in evaluated:
            if op in ("intersect", "intersect_all"):
                cur_df = self._fold_setop(cur_df, op, df)
            else:
                if cur_df is not None:
                    groups.append((cur_op, cur_df))
                cur_op, cur_df = op, df
        groups.append((cur_op, cur_df))
        out = groups[0][1]
        for op, df in groups[1:]:
            out = self._fold_setop(out, op, df)
        if order_text:
            keys, ascs = [], []
            for text, asc in self._parse_order_items(order_text):
                if re.fullmatch(r"\d+", text):
                    n_ = int(text)
                    if not 1 <= n_ <= len(out.columns):
                        raise ValueError(
                            f"ORDER BY position {n_} is out of range "
                            f"({len(out.columns)} output columns)"
                        )
                    keys.append(out.columns[n_ - 1])
                elif re.fullmatch(r"\w+", text) and text in out.columns:
                    keys.append(text)
                else:
                    raise ValueError(
                        f"ORDER BY after a set operation supports "
                        f"output column names or ordinals; {text!r} is "
                        f"not one of {out.columns}"
                    )
                ascs.append(asc)
            out = out.orderBy(*keys, ascending=ascs)
        if limit_n is not None:
            out = out.limit(limit_n)
        return out

    def _strip_tail_order_limit(self, text: str):
        """Split a union's final branch into (select_text, order_text,
        limit) — the trailing clauses at paren depth 0 belong to the
        union."""
        spans = self._literal_spans(text)
        depth_at = self._depth_profile(text, spans)

        def ok(i: int) -> bool:
            return depth_at[i] == 0 and not any(
                lo <= i < hi for lo, hi in spans
            )

        for m in re.finditer(r"\bORDER\s+BY\b", text, re.IGNORECASE):
            if not ok(m.start()):
                continue
            tail = text[m.end():]
            lm = re.search(r"\s+LIMIT\s+(\d+)\s*;?\s*$", tail,
                           re.IGNORECASE)
            if lm:
                return text[:m.start()], tail[:lm.start()].strip(), int(
                    lm.group(1)
                )
            return (
                text[:m.start()],
                re.sub(r";\s*$", "", tail).strip(),
                None,
            )
        for m in re.finditer(r"\bLIMIT\s+(\d+)\s*;?\s*$", text,
                             re.IGNORECASE):
            if ok(m.start()):
                return text[:m.start()], None, int(m.group(1))
        return text, None, None

    def _sql_select(self, query: str, created: List[str]) -> DataFrame:
        query = self._lift_derived_tables(query, created)
        parts = self._split_clauses(query)
        m = self._SQL_HEAD_RE.match(parts[0]) if parts is not None else None
        if not m:
            raise ValueError(f"Unsupported SQL (minimal dialect): {query!r}")
        clauses = parts[1]
        out = self.table(m.group("table"))
        # table names/aliases usable as column qualifiers downstream
        # (WHERE t.score > 1 resolves t.score -> score)
        quals = {m.group("talias") or m.group("table")}
        if m.group("joins"):
            out, quals = self._apply_joins(
                out, m.group("table"), m.group("talias"), m.group("joins")
            )
        where = clauses.get("where")
        if where:
            out = out.filter(
                self._parse_predicate(where.strip(), quals, out.columns)
            )

        proj_raw = [
            raw.strip() for raw in self._split_projections(m.group("proj"))
        ]
        group = clauses.get("group")

        def _window_match(p: str):
            text, _ = self._strip_alias(p)
            wm = self._WINDOW_RE.match(text)
            if wm is None and re.search(r"\bOVER\s*\(", text,
                                        re.IGNORECASE):
                raise ValueError(
                    f"Unsupported window expression {text!r}; supported "
                    "as a FULL projection (not inside arithmetic — use a "
                    "derived table for that): ranking "
                    "(ROW_NUMBER/RANK/DENSE_RANK), aggregates "
                    "(COUNT/SUM/AVG/MIN/MAX/STDDEV*/VAR*/COLLECT_*), "
                    "LAG/LEAD — each OVER ([PARTITION BY ...] "
                    "[ORDER BY ...])"
                )
            return wm

        def _is_agg_call(p: str) -> bool:
            if _window_match(p):
                return False
            am = self._AGG_RE.match(self._strip_alias(p)[0])
            if not am:
                return False
            # a registered scalar UDF named e.g. `min` keeps its per-row
            # meaning outside GROUP BY queries (as before this dialect
            # grew aggregates); inside one, SQL aggregate semantics win
            return group is not None or am.group("fn").lower() not in self.udf

        is_agg = group is not None or any(_is_agg_call(p) for p in proj_raw)
        if clauses.get("having") and not is_agg:
            raise ValueError("HAVING requires a GROUP BY / aggregate query")
        order = clauses.get("order")
        order_items = self._parse_order_items(order) if order else []
        distinct = bool(m.group("distinct"))

        if is_agg:
            if distinct:
                raise ValueError(
                    "SELECT DISTINCT with aggregates is not supported; "
                    "GROUP BY output is already one row per group"
                )
            if any(_window_match(p) for p in proj_raw):
                raise ValueError(
                    "window functions over GROUP BY output are not "
                    "supported; aggregate in a derived table first "
                    "(FROM (SELECT ... GROUP BY ...) t)"
                )
            out, select_names = self._sql_aggregate(
                out, proj_raw, group, having=clauses.get("having"),
                qualifiers=quals, columns=out.columns,
            )
            if order_items:
                out = self._order_aggregated(
                    out, order_items, quals, select_names
                )
        else:
            out = self._project_and_order(
                out, m.group("proj").strip(), proj_raw, order_items,
                distinct, quals,
            )
        if clauses.get("limit"):
            out = out.limit(int(clauses["limit"]))
        return out

    def _order_aggregated(
        self, out: DataFrame, order_items: List[tuple], quals,
        select_names: List[str],
    ) -> DataFrame:
        """ORDER BY over an aggregation's output: plain output columns,
        select-list ordinals (``ORDER BY 2 DESC``), or expressions over
        them (``ORDER BY cnt / total``); direct aggregate calls must be
        aliased in the select list instead.

        The non-aggregate analog lives in :meth:`_project_and_order`;
        the two attach hidden sort columns at different pipeline stages
        (post-aggregation ``withColumn`` here vs select-list append over
        the pre-projection input there), which is why they stay
        separate implementations."""
        keys: List[str] = []
        ascs: List[bool] = []
        hidden: List[str] = []
        for text, asc in order_items:
            if re.fullmatch(r"\d+", text):
                n_ = int(text)
                if not 1 <= n_ <= len(select_names):
                    raise ValueError(
                        f"ORDER BY position {n_} is out of range "
                        f"(select list has {len(select_names)} items)"
                    )
                keys.append(select_names[n_ - 1])
            elif re.fullmatch(r"\w+", text):
                if text not in out.columns:
                    raise ValueError(
                        f"ORDER BY {text!r}: not an output column of "
                        f"the aggregation ({out.columns}); alias the "
                        "aggregate (AS) and order by the alias"
                    )
                keys.append(text)
            else:
                expr = _PredicateParser(
                    text, udf_registry=self.udf, qualifiers=quals,
                    columns=out.columns, session=self,
                ).parse_expression()
                h = f"__sort_{len(hidden)}"
                out = out.withColumn(h, expr)
                hidden.append(h)
                keys.append(h)
            ascs.append(asc)
        out = out.orderBy(*keys, ascending=ascs)
        for h in hidden:
            out = out.drop(h)
        return out

    def _project_and_order(
        self,
        out: DataFrame,
        proj_text: str,
        proj_raw: List[str],
        order_items: List[tuple],
        distinct: bool,
        quals,
    ) -> DataFrame:
        """The non-aggregate SELECT path: window columns, star
        expansion, projection, DISTINCT, and select-list-first ORDER BY
        resolution (hidden projected sort columns for input-side keys,
        dropped after the sort)."""
        input_cols = out.columns
        # SELECT *, expr — stars expand positionally against the
        # PRE-window input columns (a window alias must not duplicate)
        expanded: List[str] = []
        for raw in proj_raw:
            if raw == "*":
                expanded.extend(input_cols)
            else:
                expanded.append(raw)
        star_only = proj_text == "*"

        proj_items: List[str] = []
        for raw in expanded:
            text, alias = self._strip_alias(raw)
            wm = self._WINDOW_RE.match(text)
            if wm:
                name = alias or re.sub(r"\s+", " ", text)
                out = self._apply_window(out, name, wm, quals)
                proj_items.append(name)  # now an ordinary column
                star_only = False
            else:
                proj_items.append(raw)

        if star_only:
            # DISTINCT * dedupes full rows (every column is "in the
            # select list", so any column is a legal sort key)
            if not order_items:
                return out.distinct() if distinct else out
            simple = all(
                re.fullmatch(r"\w+", t) and t in out.columns
                for t, _ in order_items
            )
            if simple:
                if distinct:
                    out = out.distinct()
                return out.orderBy(
                    *[t for t, _ in order_items],
                    ascending=[a for _, a in order_items],
                )
            proj_items = list(out.columns)  # need hidden sort columns

        exprs = [
            self._parse_projection(raw, quals, out.columns)
            for raw in proj_items
        ]
        post_names = [e._name for e in exprs]
        keys: List[str] = []
        ascs: List[bool] = []
        hidden: List[str] = []
        for text, asc in order_items:
            # SQL resolution: ordinals first (ORDER BY 2 = second
            # select item), then the select list (aliases win over
            # same-named input columns), else an expression over the
            # input — a plain column, t.col, score + 1, ABS(score) —
            # projected as a hidden column and dropped after the sort
            if re.fullmatch(r"\d+", text):
                n_ = int(text)
                if not 1 <= n_ <= len(post_names):
                    raise ValueError(
                        f"ORDER BY position {n_} is out of range "
                        f"(select list has {len(post_names)} items)"
                    )
                keys.append(post_names[n_ - 1])
            elif text in post_names:
                keys.append(text)
            else:
                if re.fullmatch(r"\w+", text) and text not in out.columns:
                    raise ValueError(
                        f"ORDER BY [{text!r}]: no such column "
                        f"({out.columns}) or projection alias"
                    )
                if distinct:
                    # Spark's rule: DISTINCT dedupes the projected rows,
                    # so a sort key outside the select list has no
                    # well-defined value per deduped row
                    raise ValueError(
                        "SELECT DISTINCT: ORDER BY columns must appear "
                        "in the select list"
                    )
                expr = _PredicateParser(
                    text, udf_registry=self.udf, qualifiers=quals,
                    columns=out.columns, session=self,
                ).parse_expression()
                h = f"__sort_{len(hidden)}"
                exprs.append(expr.alias(h))
                hidden.append(h)
                keys.append(h)
            ascs.append(asc)
        out = out.select(*exprs)
        if distinct:
            out = out.distinct()
        if keys:
            out = out.orderBy(*keys, ascending=ascs)
        for h in hidden:
            out = out.drop(h)
        return out

    _RANK_FNS = frozenset(
        ("row_number", "rank", "dense_rank", "percent_rank",
         "cume_dist", "ntile")
    )

    def _apply_window(
        self, df: DataFrame, out_name: str, wm, quals
    ) -> DataFrame:
        """Materialize one window function as a column named
        ``out_name`` — ranking (no argument, ORDER BY required),
        aggregate (``SUM(x) OVER (PARTITION BY k)``; with ORDER BY the
        running aggregate under Spark's default frame), or
        ``LAG/LEAD(x[, offset[, default]])``.  PARTITION BY / ORDER BY
        items and value arguments may be plain columns, qualified
        names, or expressions (computed as helper columns, dropped
        after)."""
        fn_key = wm.group("fn").lower()
        arg = (wm.group("arg") or "").strip()
        helpers: List[str] = []

        def resolve(text: str, tag: str) -> str:
            nonlocal df
            t = text.strip()
            if re.fullmatch(r"\w+", t) and t in df.columns:
                return t
            mq = re.fullmatch(r"(\w+)\.(\w+)", t)
            if mq and mq.group(1) in quals and mq.group(1) not in df.columns:
                return mq.group(2)
            expr = _PredicateParser(
                t, udf_registry=self.udf, qualifiers=quals,
                columns=df.columns, session=self,
            ).parse_expression()
            h = f"__win_{tag}_{len(helpers)}"
            helpers.append(h)
            df = df.withColumn(h, expr)
            return h

        part_cols = (
            [
                resolve(p, "p")
                for p in self._split_projections(wm.group("part"))
            ]
            if wm.group("part")
            else []
        )
        ords = (
            self._parse_order_items(wm.group("ord"))
            if wm.group("ord") else []
        )
        ord_cols = [resolve(t, "o") for t, _ in ords]
        ascs = [a for _, a in ords]
        frame = None
        if wm.group("fstart"):
            frame = self._parse_frame(
                wm.group("fstart"), wm.group("fend")
            )
            if not ord_cols:
                raise ValueError(
                    "ROWS BETWEEN requires ORDER BY in the window"
                )
            if fn_key in self._RANK_FNS or fn_key in ("lag", "lead"):
                raise ValueError(
                    f"{fn_key.upper()} does not accept a frame "
                    "specification"
                )

        if fn_key in self._RANK_FNS:
            n_buckets = None
            if fn_key == "ntile":
                if not re.fullmatch(r"\d+", arg or ""):
                    raise ValueError(
                        f"NTILE requires a literal positive bucket "
                        f"count, got {arg!r}"
                    )
                n_buckets = int(arg)
            elif arg:
                raise ValueError(
                    f"{fn_key.upper()}() takes no argument"
                )
            if not ord_cols:
                raise ValueError(
                    f"{fn_key.upper()}() OVER requires ORDER BY"
                )
            df = df._with_rank_column(
                out_name, fn_key, part_cols, ord_cols, ascs,
                n_buckets=n_buckets,
            )
        elif fn_key in ("lag", "lead"):
            if not ord_cols:
                raise ValueError("LAG/LEAD OVER requires ORDER BY")
            args = (
                [a.strip() for a in self._split_projections(arg)]
                if arg else []
            )
            if not args or len(args) > 3:
                raise ValueError(
                    "LAG/LEAD takes (column[, offset[, default]])"
                )
            vcol = resolve(args[0], "v")
            offset = 1
            if len(args) >= 2:
                if not re.fullmatch(r"\d+", args[1]):
                    raise ValueError(
                        f"LAG/LEAD offset must be a literal integer, "
                        f"got {args[1]!r}"
                    )
                offset = int(args[1])
            default = None
            if len(args) == 3:
                p = _PredicateParser(args[2], session=self)
                default = p._literal()
                if p.i != len(p.tokens):
                    raise ValueError(
                        f"LAG/LEAD default must be a single literal, "
                        f"got {args[2]!r}"
                    )
            df = df._with_window_shift_column(
                out_name, -1 if fn_key == "lag" else 1, vcol, offset,
                default, part_cols, ord_cols, ascs,
            )
        else:  # aggregate over a window
            if arg == "*":
                if fn_key != "count":
                    raise ValueError(
                        f"{fn_key}(*) is not defined; use a column"
                    )
                vcol = None
            elif not arg:
                raise ValueError(
                    f"{fn_key.upper()}() OVER requires an argument"
                )
            else:
                vcol = resolve(arg, "v")
            df = df._with_window_agg_column(
                out_name, fn_key, vcol, part_cols, ord_cols, ascs,
                frame=frame,
            )
        for h in helpers:
            df = df.drop(h)
        return df

    def _apply_joins(
        self,
        out: DataFrame,
        base_table: str,
        base_alias: Optional[str],
        joins_text: str,
    ):
        """Left-associative chain of ``JOIN <view> [alias] ON`` clauses.
        Returns ``(joined_df, qualifier_names)``.

        Each ON condition is one or more qualified equalities
        (``a.k = b.k AND ...``); one side of every equality must
        reference an already-joined table (or its alias), the other the
        table being joined.  Same-named key pairs collapse to one output
        column (the engine's USING semantics — Spark SQL would keep both,
        which a dict-backed partition cannot represent); differently-
        named pairs keep both columns.  Downstream clauses (WHERE/GROUP
        BY/projections) reference the joined columns UNQUALIFIED.
        """
        # an alias HIDES the table name (Spark semantics) — this is what
        # makes self-joins expressible: FROM t a JOIN t b ON a.k = b.k
        left_quals = {base_alias} if base_alias else {base_table}
        for jm in self._JOIN_CLAUSE_RE.finditer(joins_text):
            how = (jm.group("how") or "inner").strip().split()[0].lower()
            rtable, ralias = jm.group("table"), jm.group("alias")
            right = self.table(rtable)
            rquals = {ralias} if ralias else {rtable}
            overlap = sorted(rquals & left_quals)
            if overlap:
                raise ValueError(
                    f"JOIN: qualifier(s) {overlap} already name a table "
                    "on the left side; alias the second occurrence "
                    "(self-joins need distinct aliases)"
                )
            pairs = []
            for clause in re.split(
                r"\s+AND\s+", jm.group("cond").strip(), flags=re.IGNORECASE
            ):
                cm = re.match(
                    r"^\s*(\w+)\.(\w+)\s*=\s*(\w+)\.(\w+)\s*$", clause
                )
                if not cm:
                    raise ValueError(
                        f"Unsupported JOIN condition {clause!r}: use "
                        "qualified equalities like a.k = b.k [AND ...]"
                    )
                q1, c1, q2, c2 = cm.groups()
                if q1 in left_quals and q2 in rquals:
                    pairs.append((c1, c2))
                elif q2 in left_quals and q1 in rquals:
                    pairs.append((c2, c1))
                else:
                    raise ValueError(
                        f"JOIN condition {clause!r}: one side must "
                        f"reference the left tables {sorted(left_quals)} "
                        f"and the other {sorted(rquals)}"
                    )
            out = out._hash_join(right, pairs, how)
            left_quals |= rquals
        return out, left_quals

    @staticmethod
    def _strip_alias(text: str):
        # DOTALL: a multi-line projection (windows in triple-quoted SQL
        # wrap naturally) must still find its trailing AS alias
        m = re.match(
            r"^(?P<expr>.+?)\s+AS\s+(?P<alias>\w+)\s*$", text,
            re.IGNORECASE | re.DOTALL,
        )
        if m:
            return m.group("expr").strip(), m.group("alias")
        return text, None

    def _group_key(self, text: str, qualifiers, columns):
        """Resolve one GROUP BY key to ``(column_name, expr_or_None)``:
        a bare column stays itself, ``t.col`` de-qualifies, anything
        else parses as an expression whose derived column is named by
        the normalized text (so the select list can match it)."""
        k = re.sub(r"\s+", " ", text.strip())
        if re.fullmatch(r"\w+", k):
            return k, None
        mq = re.fullmatch(r"(\w+)\.(\w+)", k)
        if mq and mq.group(1) in qualifiers and mq.group(1) not in columns:
            return mq.group(2), None
        expr = _PredicateParser(
            k, udf_registry=self.udf, qualifiers=qualifiers,
            columns=columns, session=self,
        ).parse_expression()
        return k, expr

    def _agg_pair(
        self,
        df: DataFrame,
        fn_key: str,
        distinct: bool,
        arg: str,
        label: str,
        tmp_idx: List[int],
        qualifiers=frozenset(),
        columns=(),
    ):
        """Normalize one aggregate call into a ``GroupedData._aggregate``
        pair, materializing expression arguments (``AVG(score * 100)``)
        as derived columns first.  Returns ``(df, pair)``."""
        if fn_key == "mean":
            fn_key = "avg"
        if fn_key in ("first", "last", "first_value", "last_value"):
            # Spark's two-arg form: FIRST(col, ignoreNulls).  The engine
            # drops NULLs before aggregating, so only the true spelling
            # (Spark's NON-default) is expressible — false must fail
            # loudly, not silently act like true.
            ig = re.fullmatch(
                r"(?P<col>.+?)\s*,\s*(?P<ig>true|false)", arg,
                re.IGNORECASE | re.DOTALL,
            )
            if ig:
                if ig.group("ig").lower() == "false":
                    raise NotImplementedError(
                        f"{fn_key.upper()}({arg}): ignoreNulls=false is "
                        "not supported — the engine drops NULLs before "
                        "aggregating, so only the first/last NON-NULL "
                        "value is observable"
                    )
                arg = ig.group("col").strip()
        if distinct:
            if fn_key != "count":
                raise ValueError(
                    f"DISTINCT is supported with COUNT only, not "
                    f"{fn_key.upper()}"
                )
            fn_key = "count_distinct"
        if arg == "*":
            if fn_key != "count":
                raise ValueError(f"{fn_key}(*) is not defined; use a column")
            return df, ("*", fn_key, label)
        if not re.fullmatch(r"\w+", arg):
            expr = _PredicateParser(
                arg, udf_registry=self.udf, qualifiers=qualifiers,
                columns=columns, session=self,
            ).parse_expression()
            tmp = f"__agg_arg_{tmp_idx[0]}"
            tmp_idx[0] += 1
            df = df.withColumn(tmp, expr)
            return df, (tmp, fn_key, label)
        return df, (arg, fn_key, label)

    def _sql_aggregate(
        self,
        df: DataFrame,
        proj_raw: List[str],
        group: Optional[str],
        having: Optional[str] = None,
        qualifiers=frozenset(),
        columns=(),
    ) -> DataFrame:
        """The GROUP BY path: every projection must be a group key or an
        aggregate call (as in Spark); aliases rename the pyspark-style
        ``fn(col)`` output columns.  Aggregate arguments may be
        arithmetic expressions (``AVG(score * 100)``) or
        ``COUNT(DISTINCT col)``; group keys may be qualified names
        (``t.label``) or expressions (``CAST(score AS int)``, computed
        as derived columns named by their normalized text); HAVING may
        use direct aggregate calls (computed as hidden columns and
        dropped after the filter)."""
        # select-list aliases are legal group keys (GROUP BY b where the
        # projection says CAST(n AS int) AS b — Spark resolution order:
        # real column first, then alias)
        alias_map: Dict[str, str] = {}
        for raw in proj_raw:
            expr_text, alias = self._strip_alias(raw)
            if alias:
                alias_map[alias] = expr_text
        keys: List[str] = []
        if group:
            for raw_key in self._split_projections(group):
                raw_key = raw_key.strip()
                if not raw_key:
                    continue
                if re.fullmatch(r"\d+", raw_key):
                    # select-list ordinal (GROUP BY 1)
                    n_ = int(raw_key)
                    if not 1 <= n_ <= len(proj_raw):
                        raise ValueError(
                            f"GROUP BY position {n_} is out of range "
                            f"(select list has {len(proj_raw)} items)"
                        )
                    target, _ = self._strip_alias(proj_raw[n_ - 1])
                    if self._AGG_RE.match(target):
                        raise ValueError(
                            f"GROUP BY position {n_} refers to an "
                            "aggregate"
                        )
                    raw_key = target
                if (
                    re.fullmatch(r"\w+", raw_key)
                    and raw_key not in df.columns
                    and raw_key in alias_map
                ):
                    target = alias_map[raw_key]
                    if self._AGG_RE.match(target):
                        raise ValueError(
                            f"GROUP BY {raw_key!r}: cannot group by an "
                            "aggregate's alias"
                        )
                    raw_key = target
                kname, kexpr = self._group_key(
                    raw_key, qualifiers, columns
                )
                if kexpr is not None:
                    df = df.withColumn(kname, kexpr)
                keys.append(kname)
        pairs = []  # (col, fn, OUTPUT name) for GroupedData._aggregate
        renames = []  # (key, alias) — keys only; aggregates alias directly
        passthrough = []
        select_names: List[str] = []  # output name per select item, in
        # SELECT order (what ORDER BY ordinals resolve against)
        tmp_idx = [0]
        for raw in proj_raw:
            expr, alias = self._strip_alias(raw)
            am = self._AGG_RE.match(expr)
            if am:
                fn_key = am.group("fn").lower()
                if self.udf is not None and fn_key in self.udf:
                    # inside an aggregate query the SQL aggregate used to
                    # silently shadow a same-named scalar UDF — ambiguous
                    # calls must be an error, not a coin flip
                    raise ValueError(
                        f"{fn_key.upper()}(...) is ambiguous: "
                        f"{fn_key!r} is both a SQL aggregate and a "
                        "registered UDF.  Unregister or rename the UDF "
                        "(outside GROUP BY the UDF keeps its per-row "
                        "meaning; inside one the call cannot be resolved)"
                    )
                arg = am.group("arg").strip()
                distinct = bool(am.group("distinct"))
                # the alias IS the output column (aliasing after the fact
                # breaks for repeated aggregates — duplicate default
                # labels would collide)
                label = alias or (
                    f"{fn_key}(DISTINCT {arg})" if distinct
                    else f"{fn_key}({arg})"
                )
                df, pair = self._agg_pair(
                    df, fn_key, distinct, arg, label, tmp_idx, qualifiers,
                    columns,
                )
                pairs.append(pair)
                select_names.append(label)
            else:
                # a projection matches a group key by its RESOLVED name
                # (bare column, de-qualified t.col, or normalized
                # expression text), so SELECT CAST(score AS int), ...
                # GROUP BY CAST(score AS int) lines up.  Expression
                # spellings compare case-insensitively (cast vs CAST —
                # SQL keywords are caseless); bare column identifiers
                # stay exact, as everywhere in the engine.
                pname, _ = self._group_key(expr, qualifiers, columns)
                if re.fullmatch(r"\w+", pname):
                    match = pname if pname in keys else None
                else:
                    match = next(
                        (
                            k for k in keys
                            if k.casefold() == pname.casefold()
                        ),
                        None,
                    )
                if match is not None:
                    if alias:
                        renames.append((match, alias))
                    elif match != pname:
                        # output column named by the SELECT spelling
                        renames.append((match, pname))
                    passthrough.append(match)
                    select_names.append(alias or pname)
                else:
                    raise ValueError(
                        f"Projection {raw!r} must be a GROUP BY key or "
                        "an aggregate (COUNT/SUM/AVG/MIN/MAX/STDDEV/"
                        "VARIANCE/COLLECT_LIST/COLLECT_SET)"
                    )
        if not pairs:
            raise ValueError("GROUP BY query needs at least one aggregate")
        hidden: List[str] = []
        having_text = having.strip() if having else None
        if having_text:
            # direct aggregate calls in HAVING (COUNT(DISTINCT origin) >
            # 1) compute as hidden output columns; the clause text is
            # rewritten to reference them before predicate parsing
            having_text, df, extra = self._rewrite_having_aggs(
                having_text, df, tmp_idx, qualifiers, columns
            )
            for pair in extra:
                pairs.append(pair)
                hidden.append(pair[2])
        out = df.groupBy(*keys)._aggregate(pairs)
        if having_text:
            # standard SQL: HAVING may reference any group key (even one
            # the projection drops), an aggregate BY ITS ALIAS, or a
            # direct aggregate call (rewritten above)
            try:
                predicate = self._parse_predicate(
                    having_text, qualifiers, out.columns
                )
                out = out.filter(predicate)
            except (ValueError, KeyError) as e:
                raise ValueError(
                    f"Unsupported HAVING clause {having.strip()!r}: {e}; "
                    "reference group keys, aliased aggregates (use AS) or "
                    "direct aggregate calls"
                ) from None
        for h in hidden:
            out = out.drop(h)
        # drop group keys the projection didn't ask for (AFTER the HAVING
        # filter, which may reference them)
        for k in keys:
            if k not in passthrough:
                out = out.drop(k)
        for key, alias in renames:
            out = out.withColumnRenamed(key, alias)
        return out, select_names

    def _rewrite_having_aggs(
        self, text: str, df: DataFrame, tmp_idx: List[int],
        qualifiers=frozenset(), columns=(),
    ):
        """Replace direct aggregate calls in a HAVING clause with hidden
        output-column references.  Returns ``(rewritten_text, df,
        extra_pairs)``; quoted strings are left untouched."""
        # mark string-literal spans so `count(` inside a quote survives
        spans = [
            m.span()
            for m in re.finditer(r"'(?:[^'\\]|\\.)*'|\"(?:[^\"\\]|\\.)*\"",
                                 text)
        ]

        def in_string(i: int) -> bool:
            return any(lo <= i < hi for lo, hi in spans)

        out_text, pos, extra = [], 0, []
        for m in self._AGG_CALL_RE.finditer(text):
            if m.start() < pos or in_string(m.start()):
                continue
            depth, j = 1, m.end()
            while j < len(text) and depth:
                depth += text[j] == "("
                depth -= text[j] == ")"
                j += 1
            if depth:
                raise ValueError(
                    f"Unbalanced parentheses in HAVING: {text!r}"
                )
            inner = text[m.end():j - 1].strip()
            fn_key = m.group("fn").lower()
            dm = re.match(r"^DISTINCT\s+(?P<rest>.+)$", inner,
                          re.IGNORECASE | re.DOTALL)
            distinct = dm is not None
            arg = dm.group("rest").strip() if dm else inner
            label = f"__having_{tmp_idx[0]}"
            tmp_idx[0] += 1
            df, pair = self._agg_pair(
                df, fn_key, distinct, arg, label, tmp_idx, qualifiers,
                columns,
            )
            extra.append(pair)
            out_text.append(text[pos:m.start()])
            out_text.append(label)
            pos = j
        out_text.append(text[pos:])
        return "".join(out_text), df, extra

    @staticmethod
    def _split_projections(proj: str) -> List[str]:
        parts, depth, cur = [], 0, []
        for ch in proj:
            if ch == "," and depth == 0:
                parts.append("".join(cur))
                cur = []
            else:
                depth += ch == "("
                depth -= ch == ")"
                cur.append(ch)
        parts.append("".join(cur))
        return parts

    def _parse_projection(
        self, text: str, qualifiers=frozenset(), columns=()
    ) -> Column:
        text, alias = self._strip_alias(text)
        if text == "*":
            raise ValueError("'*' must be the only projection")
        if text in columns:
            # engine-materialized columns may carry expression-shaped
            # names (an unaliased window projection's normalized text);
            # an existing column always wins over re-parsing its name
            return col(text).alias(alias) if alias else col(text)
        m_q = re.fullmatch(r"(\w+)\.(\w+)", text)
        if m_q and m_q.group(1) in qualifiers and m_q.group(1) not in columns:
            # qualified simple column (t.score): output name is the bare
            # column, as in Spark
            expr = col(m_q.group(2))
        elif re.fullmatch(r"(?!\d)\w+", text):
            # bare digits are literals (SELECT 1 — the EXISTS idiom),
            # not column refs; they fall to the expression parser below
            expr = col(text)
        else:
            # full expression projection: arithmetic over columns,
            # literals and registered-UDF calls (`score * 100`,
            # `my_udf(image)`, `a + b / 2`)
            expr = _PredicateParser(
                text, udf_registry=self.udf, qualifiers=qualifiers,
                columns=columns, session=self,
            ).parse_expression()
            expr = expr.alias(re.sub(r"\s+", " ", text))
        return expr.alias(alias) if alias else expr

    def _parse_predicate(
        self, text: str, qualifiers=frozenset(), columns=()
    ) -> Column:
        return _PredicateParser(
            text, udf_registry=self.udf, qualifiers=qualifiers,
            columns=columns, session=self,
        ).parse()

    def stop(self):
        TorchSession._active = None

    @property
    def sparkContext(self):
        return self

    # SparkContext-ish helpers used by imageIO.filesToDF parity
    def binaryFiles(self, path: str, minPartitions: int = DEFAULT_PARTITIONS):
        from sparkdl_tpu_torch.image.imageIO import _list_files

        out = []
        for f in _list_files(path):
            with open(f, "rb") as fh:
                out.append((f, fh.read()))
        return out


class _PredicateParser:
    """Recursive-descent WHERE/expression parser lowering to
    :class:`Column` combinators.

    Grammar (SQL92 subset; precedence NOT > AND > OR, as in Spark SQL):

        pred   := and_e (OR and_e)*
        and_e  := not_e (AND not_e)*
        not_e  := NOT not_e | '(' pred ')' | cmp
        cmp    := sum ( op sum
                      | [NOT] IN '(' literal (',' literal)* ')'
                      | IS [NOT] NULL
                      | [NOT] LIKE str
                      | [NOT] BETWEEN sum AND sum )
        sum    := term (('+'|'-') term)*       -- arithmetic expressions
        term   := factor (('*'|'/') factor)*
        factor := '-' factor | literal | ref | fn '(' sum (',' sum)* ')'
                | '(' sum ')'
        ref    := ident ('.' ident)*         -- struct fields: image.height
        op     := = | == | != | <> | <= | >= | < | >

    ``fn`` resolves against the session's UDF registry (model-serving
    UDFs compose into expressions: ``score_img(image) * 100``).

    Reference analog: the reference delegated WHERE to Spark Catalyst; this
    covers the predicate shapes its examples/tests exercise (e.g.
    ``label IN (0,1) AND height > 100``, ``origin LIKE '%.png'``,
    ``score * 100 BETWEEN 10 AND 90``).
    """

    _TOKEN_RE = re.compile(
        r"\s*(?:(?P<num>(?:\d+\.?\d*|\.\d+)(?:[eE][+-]?\d+)?)"
        r"|(?P<str>'(?:[^'\\]|\\.)*'|\"(?:[^\"\\]|\\.)*\")"
        r"|(?P<ident>\w+)"
        r"|(?P<op><=|>=|==|!=|<>|=|<|>)"
        r"|(?P<arith>[+\-*/])"
        r"|(?P<punct>[(),.]))"
    )

    _AGG_NAMES = frozenset(
        (
            "count", "sum", "avg", "mean", "min", "max",
            "stddev", "stddev_samp", "stddev_pop",
            "variance", "var_samp", "var_pop",
            "collect_list", "collect_set",
            "first", "last", "first_value", "last_value",
        )
    )

    def __init__(self, text: str, udf_registry=None,
                 qualifiers=frozenset(), columns=(), session=None):
        self.text = text
        self.udf = udf_registry
        self.qualifiers = qualifiers
        self.columns = frozenset(columns)
        self.session = session  # for IN (SELECT ...) subqueries
        self.tokens: List[tuple] = []
        self._spans: List[tuple] = []  # source span per token
        pos = 0
        while pos < len(text):
            m = self._TOKEN_RE.match(text, pos)
            if not m or m.end() == pos:
                if text[pos:].strip():
                    raise ValueError(
                        f"Unsupported WHERE clause at {text[pos:]!r}"
                    )
                break
            pos = m.end()
            kind = m.lastgroup
            self.tokens.append((kind, m.group(kind)))
            self._spans.append((m.start(kind), m.end(kind)))
        self.i = 0

    # -- token helpers --------------------------------------------------
    def _peek(self, offset: int = 0):
        j = self.i + offset
        return self.tokens[j] if j < len(self.tokens) else (None, None)

    def _next(self):
        tok = self._peek()
        self.i += 1
        return tok

    def _accept_kw(self, word: str) -> bool:
        kind, val = self._peek()
        if kind == "ident" and val.upper() == word:
            self.i += 1
            return True
        return False

    def _expect(self, kind: str, value: Optional[str] = None):
        got_kind, got_val = self._next()
        if got_kind != kind or (value is not None and got_val != value):
            raise ValueError(
                f"Unsupported WHERE clause: {self.text!r} "
                f"(expected {value or kind}, got {got_val!r})"
            )
        return got_val

    # -- grammar --------------------------------------------------------
    def parse(self) -> Column:
        out = self._or_expr()
        if self.i != len(self.tokens):
            raise ValueError(
                f"Unsupported WHERE clause: trailing tokens in {self.text!r}"
            )
        return out

    def parse_expression(self) -> Column:
        """Parse the whole text as one arithmetic/value expression (the
        projection entry point — no boolean connectives)."""
        out = self._sum_expr()
        if self.i != len(self.tokens):
            kind, val = self._peek()
            raise ValueError(
                f"Unsupported expression: trailing {val!r} in {self.text!r}"
            )
        return out

    def _or_expr(self) -> Column:
        left = self._and_expr()
        while self._accept_kw("OR"):
            left = left | self._and_expr()
        return left

    def _and_expr(self) -> Column:
        left = self._not_expr()
        while self._accept_kw("AND"):
            left = left & self._not_expr()
        return left

    def _not_expr(self) -> Column:
        if self._accept_kw("NOT"):
            return ~self._not_expr()
        kind, val = self._peek()
        if (
            kind == "ident"
            and val.upper() == "EXISTS"
            and self._peek(1) == ("punct", "(")
            and self._peek(2)[0] == "ident"
            and self._peek(2)[1].upper() == "SELECT"
        ):
            # uncorrelated EXISTS: the subquery evaluates once to a
            # constant truth value (Spark's uncorrelated-EXISTS plan
            # does the same).  The three-token lookahead keeps a COLUMN
            # named `exists` parseable (`WHERE exists > 1`).
            from sparkdl_tpu_torch.sql.functions import lit

            self.i += 2  # consume EXISTS and '('
            df = self._subquery_df()
            return lit(df.count() > 0)
        if kind == "punct" and val == "(":
            # '(' opens either a parenthesized predicate or an arithmetic
            # group ("(a + b) * 2 > 4"): try the predicate read, and on
            # failure rewind and let _comparison's expression grammar
            # consume the paren itself
            save = self.i
            try:
                self.i += 1
                inner = self._or_expr()
                self._expect("punct", ")")
                return inner
            except ValueError:
                self.i = save
        return self._comparison()

    def _comparison(self) -> Column:
        c = self._sum_expr()
        if self._accept_kw("IS"):
            negate = self._accept_kw("NOT")
            k, v = self._next()
            if k != "ident" or v.upper() != "NULL":
                raise ValueError(f"Expected NULL after IS in {self.text!r}")
            return c.isNotNull() if negate else c.isNull()
        negate = self._accept_kw("NOT")
        if self._accept_kw("IN"):
            self._expect("punct", "(")
            k, v = self._peek()
            if k == "ident" and v.upper() == "SELECT":
                membership = c._isin_values(self._in_subquery_values())
            else:
                values = [self._literal()]
                while self._peek() == ("punct", ","):
                    self.i += 1
                    values.append(self._literal())
                self._expect("punct", ")")
                membership = c.isin(*values)
            return ~membership if negate else membership
        if self._accept_kw("LIKE"):
            kind, val = self._next()
            if kind != "str":
                raise ValueError(
                    f"LIKE requires a string pattern literal in {self.text!r}"
                )
            matched = c.like(self._unquote(val))
            return ~matched if negate else matched
        if self._accept_kw("BETWEEN"):
            lower = self._sum_expr()
            if not self._accept_kw("AND"):
                raise ValueError(
                    f"Expected AND in BETWEEN ... AND ... ({self.text!r})"
                )
            upper = self._sum_expr()
            ranged = (c >= lower) & (c <= upper)
            return ~ranged if negate else ranged
        if negate:
            raise ValueError(
                f"Expected IN, LIKE or BETWEEN after NOT in {self.text!r}"
            )
        kind, op = self._next()
        if kind != "op":
            raise ValueError(
                f"Unsupported WHERE clause: expected operator after "
                f"{c._name!r} in {self.text!r}"
            )
        value = self._sum_expr()
        if op in ("=", "=="):
            return c == value
        if op in ("!=", "<>"):
            return c != value
        return {"<": c < value, "<=": c <= value, ">": c > value, ">=": c >= value}[op]

    def _subquery_df(self):
        """Evaluate the subquery starting at the current token (its
        opening paren already consumed) through the matching close;
        returns the result DataFrame."""
        if self.session is None:
            raise ValueError(
                f"subqueries require a session: {self.text!r}"
            )
        depth, j = 1, self.i
        while j < len(self.tokens):
            k, v = self.tokens[j]
            if k == "punct" and v == "(":
                depth += 1
            elif k == "punct" and v == ")":
                depth -= 1
                if depth == 0:
                    break
            j += 1
        if depth:
            raise ValueError(
                f"Unbalanced parentheses in subquery: {self.text!r}"
            )
        start = self._spans[self.i][0]
        end = self._spans[j][0]
        df = self.session.sql(self.text[start:end])
        self.i = j + 1
        return df

    def _in_subquery_values(self) -> list:
        """Evaluate an uncorrelated ``IN (SELECT ...)`` subquery to its
        value list (single output column required; NULLs kept — the
        three-valued IN semantics live in :meth:`Column.isin`).  The
        opening paren has been consumed; consumes through the close."""
        df = self._subquery_df()
        if len(df.columns) != 1:
            raise ValueError(
                f"IN subquery must select exactly one column, got "
                f"{df.columns}"
            )
        name = df.columns[0]
        vals: list = []
        for part in df._partitions:
            vals.extend(part[name])
        return vals

    # -- arithmetic expressions -----------------------------------------
    def _sum_expr(self) -> Column:
        left = self._term_expr()
        while self._peek()[0] == "arith" and self._peek()[1] in "+-":
            _, sym = self._next()
            right = self._term_expr()
            left = (left + right) if sym == "+" else (left - right)
        return left

    def _term_expr(self) -> Column:
        left = self._factor()
        while self._peek()[0] == "arith" and self._peek()[1] in "*/":
            _, sym = self._next()
            right = self._factor()
            left = (left * right) if sym == "*" else (left / right)
        return left

    def _factor(self) -> Column:
        kind, val = self._peek()
        if kind == "arith" and val == "-":
            self.i += 1
            return -self._factor()
        if kind == "punct" and val == "(":
            k2, v2 = self._peek(1)
            if k2 == "ident" and v2.upper() == "SELECT":
                # scalar subquery: one column, at most one row (zero
                # rows is NULL, as Spark); evaluated eagerly to a
                # literal — WHERE score > (SELECT AVG(score) FROM t)
                from sparkdl_tpu_torch.sql.functions import lit

                self.i += 1
                vals = self._in_subquery_values()
                if len(vals) > 1:
                    raise ValueError(
                        f"Scalar subquery returned {len(vals)} rows "
                        f"(at most 1 allowed) in {self.text!r}"
                    )
                return lit(vals[0] if vals else None)
            self.i += 1
            inner = self._sum_expr()
            self._expect("punct", ")")
            return inner
        if kind in ("num", "str"):
            from sparkdl_tpu_torch.sql.functions import lit

            return lit(self._literal())
        if kind == "ident":
            if val.upper() == "CASE":
                self.i += 1
                return self._case_expr()
            if val.upper() == "NULL":
                from sparkdl_tpu_torch.sql.functions import lit

                self.i += 1
                return lit(None)
            # keywords that can follow an expression must not be eaten
            # as column refs (defensive; callers normally stop first)
            if val.upper() in ("AND", "OR", "NOT", "IN", "IS", "LIKE",
                               "BETWEEN", "WHEN", "THEN", "ELSE", "END",
                               "AS"):
                raise ValueError(
                    f"Unexpected keyword {val!r} in {self.text!r}"
                )
            self.i += 1
            if val.upper() == "CAST" and self._peek() == ("punct", "("):
                return self._cast_expr()
            if self._peek() == ("punct", "("):
                return self._fn_call(val)
            if (val in self.qualifiers and val not in self.columns
                    and self._peek() == ("punct", ".")):
                # table/alias qualifier: t.score resolves to the joined
                # column `score` (Spark UX) — after a join the engine
                # holds single flat columns, not per-table attributes
                self.i += 1
                k, name2 = self._next()
                if k != "ident":
                    raise ValueError(
                        f"Expected column after {val!r}. in {self.text!r}"
                    )
                val = name2
            c = col(val)
            while self._peek() == ("punct", "."):
                self.i += 1
                k, field = self._next()
                if k != "ident":
                    raise ValueError(
                        f"Expected field name after '.' in {self.text!r}"
                    )
                c = c.getField(field)
            return c
        raise ValueError(
            f"Unsupported WHERE clause: expected column name, got "
            f"{val!r} in {self.text!r}"
        )

    def _case_expr(self) -> Column:
        """``CASE WHEN pred THEN expr [WHEN ...]* [ELSE expr] END`` —
        branches evaluate under SQL 3VL (a NULL condition falls through,
        as in Spark); no ELSE yields NULL."""
        branches = []
        while self._accept_kw("WHEN"):
            cond = self._or_expr()
            if not self._accept_kw("THEN"):
                raise ValueError(
                    f"Expected THEN after WHEN in {self.text!r}"
                )
            branches.append((cond, self._sum_expr()))
        if not branches:
            raise ValueError(
                f"CASE requires at least one WHEN in {self.text!r}"
            )
        default = self._sum_expr() if self._accept_kw("ELSE") else None
        if not self._accept_kw("END"):
            raise ValueError(f"Expected END closing CASE in {self.text!r}")
        # one CASE evaluator (SQL conditional-evaluation guarantee)
        # shared with the pyspark when/otherwise chain
        from sparkdl_tpu_torch.sql.functions import _case_column

        return _case_column(branches, default).alias("CASE")

    _CAST_TYPES = {
        "int": "int", "integer": "int", "bigint": "long", "long": "long",
        "float": "float", "double": "double", "string": "string",
        "boolean": "boolean", "bool": "boolean",
    }

    def _cast_expr(self) -> Column:
        """``CAST(expr AS type)`` lowering to :meth:`Column.cast`."""
        self._expect("punct", "(")
        inner = self._sum_expr()
        if not self._accept_kw("AS"):
            raise ValueError(f"Expected AS inside CAST in {self.text!r}")
        k, tname = self._next()
        if k != "ident" or tname.lower() not in self._CAST_TYPES:
            raise ValueError(
                f"Unsupported CAST target {tname!r}; supported: "
                f"{sorted(set(self._CAST_TYPES))}"
            )
        self._expect("punct", ")")
        target = self._CAST_TYPES[tname.lower()]

        def safe_cast(v):
            # Spark CAST semantics: invalid conversions yield NULL (not
            # a mid-query crash); numeric->int truncates toward zero;
            # string->boolean accepts t/true/y/yes/1 and f/false/n/no/0
            if v is None:
                return None
            try:
                if target in ("int", "long"):
                    return int(float(v)) if isinstance(v, str) else int(v)
                if target in ("float", "double"):
                    return float(v)
                if target == "string":
                    return str(v)
                if target == "boolean":
                    if isinstance(v, str):
                        s = v.strip().lower()
                        if s in ("t", "true", "y", "yes", "1"):
                            return True
                        if s in ("f", "false", "n", "no", "0"):
                            return False
                        return None
                    return bool(v)
            except (ValueError, TypeError, OverflowError):
                return None
            return None

        return Column(
            lambda cols, n: [safe_cast(v) for v in inner._eval(cols, n)],
            f"CAST({inner._name} AS {target})",
        )

    #: built-in scalar functions (NULL-propagating except COALESCE,
    #: whose whole point is the NULLs) — the high-traffic Spark SQL
    #: builtins serving analytics use; a registered UDF of the same
    #: name takes precedence.
    _BUILTIN_FNS = {
        "abs": (1, 1, lambda a: None if a is None else abs(a)),
        "round": (1, 2, "_round_half_up"),
        "upper": (1, 1, lambda a: None if a is None else a.upper()),
        "lower": (1, 1, lambda a: None if a is None else a.lower()),
        "length": (1, 1, lambda a: None if a is None else len(a)),
        "coalesce": (1, None, "functions._coalesce_vals"),
        "concat": (1, None, "functions._concat_vals"),
        "substring": (2, 3, "functions._substring_sql"),
        "substr": (2, 3, "functions._substring_sql"),
        "trim": (1, 1, lambda a: None if a is None else a.strip()),
        "ltrim": (1, 1, lambda a: None if a is None else a.lstrip()),
        "rtrim": (1, 1, lambda a: None if a is None else a.rstrip()),
        "replace": (
            2, 3,
            # two-arg form deletes occurrences (Spark); empty search
            # string returns the input unchanged (Python's str.replace
            # would interleave the replacement)
            lambda s, find, repl="": None
            if s is None or find is None or repl is None
            else (s if find == "" else s.replace(find, repl)),
        ),
        # INSTR: 1-based position of the first occurrence, 0 when absent
        "instr": (
            2, 2,
            lambda s, sub: None if s is None or sub is None
            else s.find(sub) + 1,
        ),
        "split": (2, 2, "_split_regex"),
    }

    @staticmethod
    def _split_regex(s, pattern):
        if s is None or pattern is None:
            return None
        return re.split(pattern, s)

    @staticmethod
    def _round_half_up(a, d=0):
        # Spark SQL ROUND is HALF_UP; Python round() is banker's
        # (ROUND(2.5) must be 3, not 2).  NULL in either arg -> NULL.
        if a is None or d is None:
            return None
        from decimal import ROUND_HALF_UP, Decimal

        q = Decimal(1).scaleb(-int(d))
        out = Decimal(str(a)).quantize(q, rounding=ROUND_HALF_UP)
        return float(out) if isinstance(a, float) or int(d) > 0 else int(out)

    def _fn_call(self, name: str) -> Column:
        if name.lower() in self._AGG_NAMES and (
            self.udf is None or name not in self.udf
        ):
            raise ValueError(
                f"aggregate {name.upper()}(...) cannot appear inside an "
                "expression; compute it as its own projection (alias it "
                "with AS) and reference the alias"
            )
        registered = self.udf is not None and self.udf.resolve(name)
        builtin = self._BUILTIN_FNS.get(name.lower())
        if not registered and builtin is None:
            raise KeyError(f"Undefined function: {name!r}")
        self._expect("punct", "(")
        args = []
        if self._peek() != ("punct", ")"):
            args.append(self._sum_expr())
            while self._peek() == ("punct", ","):
                self.i += 1
                args.append(self._sum_expr())
        self._expect("punct", ")")
        if registered:
            return registered(*args)
        lo, hi, fn = builtin
        if isinstance(fn, str):
            if fn.startswith("functions."):
                # shared with the pyspark-functions surface (one
                # implementation; the two APIs cannot drift)
                import sparkdl_tpu_torch.sql.functions as _F

                fn = getattr(_F, fn.split(".", 1)[1])
            else:
                fn = getattr(self, fn)
        if len(args) < lo or (hi is not None and len(args) > hi):
            raise ValueError(
                f"{name.upper()} takes "
                + (f"{lo}" if hi == lo else f"{lo}..{hi or 'n'}")
                + f" arguments, got {len(args)}"
            )

        def ev(cols, n, _args=args, _fn=fn):
            evaluated = [a._eval(cols, n) for a in _args]
            return [_fn(*vals) for vals in zip(*evaluated)] if n else []

        return Column(ev, f"{name.lower()}(...)")

    @staticmethod
    def _unquote(val: str) -> str:
        body = val[1:-1]
        return body.replace("\\" + val[0], val[0]).replace("\\\\", "\\")

    def _literal(self):
        kind, val = self._next()
        if kind == "arith" and val == "-":
            v = self._literal()
            if not isinstance(v, (int, float)):
                raise ValueError(
                    f"Unsupported WHERE literal -{v!r} in {self.text!r}"
                )
            return -v
        if kind == "num":
            return float(val) if ("." in val or "e" in val.lower()) else int(val)
        if kind == "str":
            return self._unquote(val)
        raise ValueError(
            f"Unsupported WHERE literal {val!r} in {self.text!r}"
        )
