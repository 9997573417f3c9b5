"""Column expressions and UDFs (pyspark.sql.functions API subset): the
port's copy of ``sparkdl_tpu.sql.functions`` (host Python, unchanged but for
its imports).

The engine's expression layer: a ``Column`` is a small eval tree applied
per-partition over Python lists: operators and predicates, aggregate and
scalar functions, ``when``/CASE and ``expr()``. Python UDFs are the analog
of the reference's TensorFrames-registered UDFs; model-backed UDFs built by
:mod:`sparkdl_tpu_torch.udf` are ``vectorized`` and evaluate whole
partitions at once, so the model runs batched on the card.
"""

from __future__ import annotations

import operator
from typing import Any, Callable, List, Optional, Sequence

from sparkdl_tpu_torch.sql.types import DataType, Row


class Column:
    """An expression evaluable against a partition (dict of column lists)."""

    def __init__(self, eval_fn: Callable[[dict, int], List[Any]], name: str):
        # eval_fn(partition_columns, n_rows) -> list of n_rows values
        self._eval = eval_fn
        self._name = name

    # -- construction helpers --------------------------------------------
    @staticmethod
    def _column_ref(name: str) -> "Column":
        def ev(cols, n):
            if name not in cols:
                raise KeyError(f"No such column: {name!r}")
            return cols[name]

        return Column(ev, name)

    @staticmethod
    def _literal(value: Any) -> "Column":
        return Column(lambda cols, n: [value] * n, str(value))

    def alias(self, name: str) -> "Column":
        out = Column(self._eval, name)
        # aggregate/sort/window markers survive aliasing
        # (F.avg("x").alias("m") must still aggregate;
        # F.rank().over(w).alias("rk") must still window) —
        # _when_branches deliberately does NOT survive: .alias() seals
        # a when/otherwise chain
        for attr in ("_agg", "_sort_asc", "_window", "_rank_fn",
                     "_ntile_n", "_shift"):
            if hasattr(self, attr):
                setattr(out, attr, getattr(self, attr))
        return out

    # -- sort direction markers (pyspark Column.asc/desc) ----------------
    def asc(self) -> "Column":
        out = Column(self._eval, self._name)
        out._sort_asc = True
        return out

    def desc(self) -> "Column":
        out = Column(self._eval, self._name)
        out._sort_asc = False
        return out

    def getField(self, field: str) -> "Column":
        def ev(cols, n):
            return [v[field] if v is not None else None for v in self._eval(cols, n)]

        return Column(ev, f"{self._name}.{field}")

    getItem = getField

    def cast(self, to: str) -> "Column":
        caster = {
            "int": int,
            "long": int,
            "float": float,
            "double": float,
            "string": str,
            "boolean": bool,
        }[to]

        def ev(cols, n):
            return [None if v is None else caster(v) for v in self._eval(cols, n)]

        return Column(ev, self._name)

    # -- operators --------------------------------------------------------
    def _binop(self, other, op, sym) -> "Column":
        other_col = other if isinstance(other, Column) else Column._literal(other)

        def ev(cols, n):
            return [
                None if a is None or b is None else op(a, b)
                for a, b in zip(self._eval(cols, n), other_col._eval(cols, n))
            ]

        return Column(ev, f"({self._name} {sym} {other_col._name})")

    def __add__(self, other):
        return self._binop(other, operator.add, "+")

    def __sub__(self, other):
        return self._binop(other, operator.sub, "-")

    def __mul__(self, other):
        return self._binop(other, operator.mul, "*")

    def __truediv__(self, other):
        # Spark SQL divide semantics: x / 0 is NULL, not an error — an
        # unguarded ZeroDivisionError would abort the whole query for
        # one bad row.  The explicit b == 0 probe matters for numpy
        # scalar cells, whose truediv returns inf/nan without raising.
        def safe_div(a, b):
            try:
                if b == 0:
                    return None
            except (TypeError, ValueError):
                pass  # non-scalar operand (e.g. ndarray): let truediv act
            try:
                return operator.truediv(a, b)
            except ZeroDivisionError:
                return None

        return self._binop(other, safe_div, "/")

    def __neg__(self):
        return Column(
            lambda cols, n: [
                None if v is None else -v for v in self._eval(cols, n)
            ],
            f"(- {self._name})",
        )

    def __eq__(self, other):  # type: ignore[override]
        return self._binop(other, operator.eq, "==")

    def __ne__(self, other):  # type: ignore[override]
        return self._binop(other, operator.ne, "!=")

    def __lt__(self, other):
        return self._binop(other, operator.lt, "<")

    def __le__(self, other):
        return self._binop(other, operator.le, "<=")

    def __gt__(self, other):
        return self._binop(other, operator.gt, ">")

    def __ge__(self, other):
        return self._binop(other, operator.ge, ">=")

    def _kleene_binop(self, other, table, sym) -> "Column":
        """SQL three-valued logic combinator (as in Spark/Catalyst):
        ``table(a, b)`` receives operands normalized to True/False/None
        (comparisons over numpy scalars yield np.True_/np.False_, for
        which ``is True`` identity checks would fail)."""
        other_col = other if isinstance(other, Column) else Column._literal(other)

        def ev(cols, n):
            return [
                table(
                    None if a is None else bool(a),
                    None if b is None else bool(b),
                )
                for a, b in zip(self._eval(cols, n), other_col._eval(cols, n))
            ]

        return Column(ev, f"({self._name} {sym} {other_col._name})")

    def __and__(self, other):
        # FALSE AND NULL = FALSE, TRUE AND NULL = NULL
        def table(a, b):
            if a is False or b is False:
                return False
            if a is None or b is None:
                return None
            return a and b

        return self._kleene_binop(other, table, "&")

    def __or__(self, other):
        # TRUE OR NULL = TRUE, FALSE OR NULL = NULL
        def table(a, b):
            if a is True or b is True:
                return True
            if a is None or b is None:
                return None
            return a or b

        return self._kleene_binop(other, table, "|")

    def __invert__(self):
        return Column(
            lambda cols, n: [None if v is None else not v for v in self._eval(cols, n)],
            f"(NOT {self._name})",
        )

    def isin(self, *values):
        """Membership test (``col.isin(0, 1)`` or ``col.isin([0, 1])``) —
        the pyspark ``Column.isin`` analog, and what SQL ``IN (...)``
        (including ``IN (SELECT ...)``) lowers to.

        Spark's three-valued IN: NULL input yields NULL; a non-matching
        input yields NULL (not False) when the value set itself contains
        NULL — which is also why ``NOT IN`` against a set with a NULL
        matches nothing, the classic SQL trap, preserved faithfully."""
        if len(values) == 1 and isinstance(values[0], (list, tuple, set)):
            values = tuple(values[0])
        return self._isin_values(values)

    def _isin_values(self, values: Sequence) -> "Column":
        """Membership against ``values`` EXACTLY as given — no
        single-container convenience unpack (the ``IN (SELECT ...)``
        path must not flatten a one-row array-valued result into
        element-wise membership)."""
        has_null = any(v is None for v in values)
        try:
            vals = {v for v in values if v is not None}
        except TypeError:
            raise ValueError(
                "IN requires hashable scalar values; got array-valued "
                "entries"
            ) from None

        def ev(cols, n):
            out = []
            for v in self._eval(cols, n):
                if v is None:
                    out.append(None)
                elif v in vals:
                    out.append(True)
                else:
                    out.append(None if has_null else False)
            return out

        return Column(
            ev,
            "(%s IN (%s))" % (self._name, ", ".join(map(repr, values))),
        )

    def like(self, pattern: str) -> "Column":
        """SQL ``LIKE``: ``%`` matches any run, ``_`` any one character,
        ``\\%``/``\\_``/``\\\\`` escape to literals (Spark's backslash
        escapes), anchored to the whole string; NULL input yields NULL
        (pyspark ``Column.like`` analog)."""
        import re as _re

        frags, i = [], 0
        while i < len(pattern):
            ch = pattern[i]
            if ch == "\\" and i + 1 < len(pattern) and pattern[i + 1] in "%_\\":
                frags.append(_re.escape(pattern[i + 1]))
                i += 2
                continue
            frags.append(
                ".*" if ch == "%" else "." if ch == "_" else _re.escape(ch)
            )
            i += 1
        rx = _re.compile("".join(frags), _re.DOTALL)

        def match(v):
            if v is None:
                return None
            if not isinstance(v, str):
                raise TypeError(
                    f"LIKE requires a string operand, got {type(v).__name__}"
                )
            return rx.fullmatch(v) is not None

        return Column(
            lambda cols, n: [match(v) for v in self._eval(cols, n)],
            f"({self._name} LIKE {pattern!r})",
        )

    def between(self, lower, upper) -> "Column":
        """``lower <= col <= upper`` with SQL null semantics (pyspark
        ``Column.between`` analog; what SQL ``BETWEEN`` lowers to)."""
        return ((self >= lower) & (self <= upper)).alias(
            f"({self._name} BETWEEN {lower} AND {upper})"
        )

    def isNull(self):
        return Column(
            lambda cols, n: [v is None for v in self._eval(cols, n)],
            f"({self._name} IS NULL)",
        )

    def isNotNull(self):
        return Column(
            lambda cols, n: [v is not None for v in self._eval(cols, n)],
            f"({self._name} IS NOT NULL)",
        )

    # -- CASE WHEN (pyspark when/otherwise chain) ------------------------
    def when(self, condition: "Column", value) -> "Column":
        """Chain another WHEN branch (only valid on a Column started by
        :func:`when`)."""
        branches = getattr(self, "_when_branches", None)
        if branches is None:
            raise TypeError(
                "when() can only chain on a Column created by "
                "functions.when(...)"
            )
        return _case_column(branches + [(condition, value)], None)

    def otherwise(self, value) -> "Column":
        branches = getattr(self, "_when_branches", None)
        if branches is None:
            raise TypeError(
                "otherwise() requires a Column created by "
                "functions.when(...)"
            )
        return _case_column(branches, value if isinstance(value, Column)
                            else Column._literal(value))

    def over(self, window: "WindowSpec") -> "Column":
        """Bind a ranking/aggregate/shift function to a window
        (pyspark ``F.row_number().over(Window.partitionBy(...)
        .orderBy(...))``); evaluated by the DataFrame window engine in
        ``select``/``withColumn``."""
        if not isinstance(window, WindowSpec):
            raise TypeError(
                f"over() takes a WindowSpec (build one with "
                f"Window.partitionBy/orderBy), got {type(window).__name__}"
            )
        rank_fn = getattr(self, "_rank_fn", None)
        shift = getattr(self, "_shift", None)
        agg = getattr(self, "_agg", None)
        if rank_fn is not None:
            if window._frame is not None:
                raise ValueError(
                    f"{rank_fn}() does not accept a frame (rowsBetween)"
                )
            desc = ("rank", rank_fn, getattr(self, "_ntile_n", None))
        elif shift is not None:
            if window._frame is not None:
                raise ValueError(
                    "lag/lead do not accept a frame (rowsBetween)"
                )
            desc = ("shift", *shift)
        elif agg is not None:
            if window._frame is not None and not window._order:
                raise ValueError(
                    "rowsBetween requires the window to have orderBy"
                )
            col_name, fn_key = agg
            desc = ("agg", fn_key, None if col_name == "*" else col_name)
        else:
            raise ValueError(
                f"{self._name!r} is not a window function; use "
                "row_number/rank/dense_rank/lag/lead or an aggregate "
                "(sum/avg/count/...)"
            )

        def ev(cols, n):
            raise ValueError(
                f"window expression {self._name!r} can only be used in "
                "select()/withColumn(), not inside another expression"
            )

        out = Column(ev, f"{self._name} OVER ({window._describe()})")
        out._window = (desc, window)
        return out

    def __repr__(self):
        return f"Column<{self._name}>"


def col(name: str) -> Column:
    return Column._column_ref(name)


column = col


def lit(value: Any) -> Column:
    return Column._literal(value)


def _case_column(branches, default: "Optional[Column]") -> Column:
    """CASE evaluator with SQL conditional-evaluation semantics shared
    by the dialect's ``CASE WHEN`` and the pyspark ``when/otherwise``
    chain: branch conditions run in order only on still-unmatched rows,
    and branch VALUES run only on the rows their condition selected
    (``when(n != 0, 100 / n)`` never divides by the guarded zero); a
    NULL condition falls through, as in Spark."""
    norm = [
        (c, v if isinstance(v, Column) else Column._literal(v))
        for c, v in branches
    ]

    def ev(cols, n):
        out = [None] * n
        remaining = list(range(n))

        def sub_eval(expr, idx):
            sub = {c: [vals[i] for i in idx] for c, vals in cols.items()}
            return expr._eval(sub, len(idx))

        for cexpr, vexpr in norm:
            if not remaining:
                break
            cvals = sub_eval(cexpr, remaining)
            matched = [i for i, cv in zip(remaining, cvals) if cv]
            if matched:
                for i, v in zip(matched, sub_eval(vexpr, matched)):
                    out[i] = v
            remaining = [i for i, cv in zip(remaining, cvals) if not cv]
        if default is not None and remaining:
            for i, v in zip(remaining, sub_eval(default, remaining)):
                out[i] = v
        return out

    col_ = Column(ev, "CASE")
    if default is None:
        # only an open chain accepts further .when()/.otherwise()
        # (pyspark rejects otherwise-after-otherwise too)
        col_._when_branches = list(branches)
    return col_


def when(condition: Column, value) -> Column:
    """Start a pyspark ``when/otherwise`` chain:
    ``F.when(col("n") > 0, 1).when(...).otherwise(0)``."""
    return _case_column([(condition, value)], None)


def _agg_column(fn_key: str, col_or_name, label: Optional[str] = None
                ) -> Column:
    """An aggregate-marked Column for ``GroupedData.agg`` — evaluating
    it outside an aggregation raises (as pyspark's analysis would)."""
    name = col_or_name if isinstance(col_or_name, str) else col_or_name._name
    label = label or f"{fn_key}({name})"

    def ev(cols, n):
        raise ValueError(
            f"aggregate expression {label!r} can only be used inside "
            "GroupedData.agg(...)"
        )

    out = Column(ev, label)
    out._agg = (name, fn_key)
    return out


def count(col_or_name) -> Column:
    name = col_or_name if isinstance(col_or_name, str) else col_or_name._name
    if name == "*":
        return _agg_column("count", "*", "count(*)")
    return _agg_column("count", col_or_name)


def countDistinct(col_or_name) -> Column:
    name = col_or_name if isinstance(col_or_name, str) else col_or_name._name
    return _agg_column("count_distinct", name, f"count(DISTINCT {name})")


def sum(col_or_name) -> Column:  # noqa: A001 - pyspark name
    return _agg_column("sum", col_or_name)


def avg(col_or_name) -> Column:
    return _agg_column("avg", col_or_name)


mean = avg


def min(col_or_name) -> Column:  # noqa: A001 - pyspark name
    return _agg_column("min", col_or_name)


def max(col_or_name) -> Column:  # noqa: A001 - pyspark name
    return _agg_column("max", col_or_name)


def stddev(col_or_name) -> Column:
    return _agg_column("stddev", col_or_name)


stddev_samp = stddev


def stddev_pop(col_or_name) -> Column:
    return _agg_column("stddev_pop", col_or_name)


def variance(col_or_name) -> Column:
    return _agg_column("variance", col_or_name)


var_samp = variance


def var_pop(col_or_name) -> Column:
    return _agg_column("var_pop", col_or_name)


def p50(col_or_name) -> Column:
    """Exact interpolated median — the latency-SLO shape shared with
    continuous windowed queries (``sql.window_state``)."""
    return _agg_column("p50", col_or_name)


def p90(col_or_name) -> Column:
    return _agg_column("p90", col_or_name)


def p95(col_or_name) -> Column:
    return _agg_column("p95", col_or_name)


def p99(col_or_name) -> Column:
    return _agg_column("p99", col_or_name)


def collect_list(col_or_name) -> Column:
    return _agg_column("collect_list", col_or_name)


def collect_set(col_or_name) -> Column:
    return _agg_column("collect_set", col_or_name)


def first(col_or_name, ignorenulls: bool = True) -> Column:
    """First NON-NULL value in partition order.

    The engine pre-filters NULLs before every aggregation, so only
    Spark's ``ignorenulls=True`` behaviour exists here.  Spark's own
    default is ``False`` (first value, null or not) — callers relying
    on that must fail loudly rather than silently get non-null-first
    semantics."""
    if not ignorenulls:
        raise NotImplementedError(
            "first(col, ignorenulls=False) is not supported: the engine "
            "drops NULLs before aggregating, so only the first NON-NULL "
            "value is observable; pass ignorenulls=True (note Spark "
            "defaults to False)"
        )
    return _agg_column("first", col_or_name)


def last(col_or_name, ignorenulls: bool = True) -> Column:
    """Last NON-NULL value in partition order (same ``ignorenulls``
    contract as :func:`first`)."""
    if not ignorenulls:
        raise NotImplementedError(
            "last(col, ignorenulls=False) is not supported: the engine "
            "drops NULLs before aggregating, so only the last NON-NULL "
            "value is observable; pass ignorenulls=True (note Spark "
            "defaults to False)"
        )
    return _agg_column("last", col_or_name)


class WindowSpec:
    """Immutable PARTITION BY / ORDER BY specification (the pyspark
    ``Window`` spec's product).  No explicit frame support: the frame
    is Spark's default — whole partition without ORDER BY, RANGE
    UNBOUNDED PRECEDING..CURRENT ROW with it."""

    def __init__(self, partition_cols=(), order=(), frame=None):
        self._partition_cols = tuple(partition_cols)
        self._order = tuple(order)  # (column_name, ascending)
        self._frame = frame  # (lo, hi) row offsets; None bound=unbounded

    def partitionBy(self, *cols) -> "WindowSpec":
        names = [c if isinstance(c, str) else c._name for c in cols]
        return WindowSpec(
            self._partition_cols + tuple(names), self._order, self._frame
        )

    def orderBy(self, *cols) -> "WindowSpec":
        order = []
        for c in cols:
            if isinstance(c, str):
                order.append((c, True))
            else:
                order.append((c._name, getattr(c, "_sort_asc", True)))
        return WindowSpec(
            self._partition_cols, self._order + tuple(order), self._frame
        )

    def rowsBetween(self, start: int, end: int) -> "WindowSpec":
        """Explicit ROWS frame (pyspark ``rowsBetween``): offsets
        relative to the current row; ``Window.unboundedPreceding`` /
        ``unboundedFollowing`` / ``currentRow`` sentinels accepted."""
        def norm(v, lo_side):
            # generous sentinel thresholds (pyspark code in the wild
            # passes various huge stand-ins for "unbounded")
            if v <= -(1 << 62):
                return None if lo_side else _bad()
            if v >= (1 << 62):
                return _bad() if lo_side else None
            return int(v)

        def _bad():
            raise ValueError(
                "rowsBetween: start must not be unboundedFollowing and "
                "end must not be unboundedPreceding"
            )

        frame = (norm(start, True), norm(end, False))
        if (
            frame[0] is not None
            and frame[1] is not None
            and frame[0] > frame[1]
        ):
            raise ValueError(
                f"rowsBetween: start {start} is after end {end}"
            )
        return WindowSpec(self._partition_cols, self._order, frame)

    def _describe(self) -> str:
        parts = []
        if self._partition_cols:
            parts.append(
                "PARTITION BY " + ", ".join(self._partition_cols)
            )
        if self._order:
            parts.append(
                "ORDER BY " + ", ".join(
                    f"{c}{'' if a else ' DESC'}" for c, a in self._order
                )
            )
        if self._frame is not None:
            def bound(v, following):
                if v is None:
                    return (
                        "UNBOUNDED FOLLOWING" if following
                        else "UNBOUNDED PRECEDING"
                    )
                if v == 0:
                    return "CURRENT ROW"
                return (
                    f"{v} FOLLOWING" if v > 0 else f"{-v} PRECEDING"
                )

            parts.append(
                f"ROWS BETWEEN {bound(self._frame[0], False)} AND "
                f"{bound(self._frame[1], True)}"
            )
        return " ".join(parts)


class Window:
    """pyspark ``Window`` entry points: ``Window.partitionBy("k")
    .orderBy(F.desc("score")).rowsBetween(-2, Window.currentRow)``."""

    unboundedPreceding = -(1 << 63)
    unboundedFollowing = (1 << 63) - 1
    currentRow = 0

    @staticmethod
    def partitionBy(*cols) -> WindowSpec:
        return WindowSpec().partitionBy(*cols)

    @staticmethod
    def orderBy(*cols) -> WindowSpec:
        return WindowSpec().orderBy(*cols)

    @staticmethod
    def rowsBetween(start: int, end: int) -> WindowSpec:
        return WindowSpec().rowsBetween(start, end)


def _rank_column(fn_key: str) -> Column:
    def ev(cols, n):
        raise ValueError(
            f"{fn_key}() must be bound to a window with .over(...)"
        )

    out = Column(ev, f"{fn_key}()")
    out._rank_fn = fn_key
    return out


def row_number() -> Column:
    return _rank_column("row_number")


def rank() -> Column:
    return _rank_column("rank")


def dense_rank() -> Column:
    return _rank_column("dense_rank")


def percent_rank() -> Column:
    return _rank_column("percent_rank")


def cume_dist() -> Column:
    return _rank_column("cume_dist")


def ntile(n: int) -> Column:
    if not isinstance(n, int) or n < 1:
        raise ValueError("ntile requires a positive integer bucket count")
    out = _rank_column("ntile")
    out._ntile_n = n
    return out


def _shift_column(direction: int, col_or_name, offset: int, default
                  ) -> Column:
    name = col_or_name if isinstance(col_or_name, str) else col_or_name._name
    fn = "lag" if direction < 0 else "lead"
    out = Column(
        lambda cols, n: (_ for _ in ()).throw(
            ValueError(f"{fn}() must be bound to a window with .over(...)")
        ),
        f"{fn}({name})",
    )
    out._shift = (direction, name, int(offset), default)
    return out


def lag(col_or_name, offset: int = 1, default=None) -> Column:
    return _shift_column(-1, col_or_name, offset, default)


def lead(col_or_name, offset: int = 1, default=None) -> Column:
    return _shift_column(1, col_or_name, offset, default)


def asc(name: str) -> Column:
    return col(name).asc()


def desc(name: str) -> Column:
    return col(name).desc()


def _substring_sql(s, pos, ln=None):
    """Spark ``substringSQL``: 1-based, pos 0 behaves like 1, negative
    counts from the end, and the length window applies BEFORE clamping
    (``SUBSTRING('abc', -5, 3)`` is ``'a'``).  ONE implementation shared
    by the SQL builtin and :func:`substring` so the two surfaces cannot
    drift."""
    if s is None or pos is None:
        return None
    pos = int(pos)
    if pos > 0:
        start = pos - 1
    elif pos == 0:
        start = 0
    else:
        start = len(s) + pos  # may stay negative: virtual pre-start
    # no max(): this module shadows the builtin with the aggregate marker
    lo = start if start > 0 else 0
    if ln is None:
        return s[lo:]
    end = start + int(ln)
    return s[lo:end if end > 0 else 0]


def _concat_vals(*vs):
    return (
        None if any(v is None for v in vs)
        else "".join(str(v) for v in vs)
    )


def _coalesce_vals(*vs):
    return next((v for v in vs if v is not None), None)


def _scalar_fn(name, fn, *cols_in) -> Column:
    cols_ = [
        c if isinstance(c, Column) else col(c) for c in cols_in
    ]

    def ev(colmap, n):
        if not cols_:
            # zero-arg call (concat() -> "" per row, coalesce() -> NULL):
            # zip(*[]) would silently yield ZERO rows, dropping data
            return [fn() for _ in range(n)]
        evaluated = [c._eval(colmap, n) for c in cols_]
        return [fn(*vals) for vals in zip(*evaluated)] if n else []

    return Column(
        ev, "%s(%s)" % (name, ", ".join(c._name for c in cols_))
    )


def abs(col_or_name) -> Column:  # noqa: A001 - pyspark name
    import builtins

    return _scalar_fn(
        "abs", lambda a: None if a is None else builtins.abs(a),
        col_or_name,
    )


def upper(col_or_name) -> Column:
    return _scalar_fn(
        "upper", lambda a: None if a is None else a.upper(), col_or_name
    )


def lower(col_or_name) -> Column:
    return _scalar_fn(
        "lower", lambda a: None if a is None else a.lower(), col_or_name
    )


def length(col_or_name) -> Column:
    return _scalar_fn(
        "length", lambda a: None if a is None else len(a), col_or_name
    )


def concat(*cols_in) -> Column:
    return _scalar_fn("concat", _concat_vals, *cols_in)


def substring(col_or_name, pos: int, length_: int) -> Column:
    return _scalar_fn(
        "substring",
        lambda a: _substring_sql(a, pos, length_),
        col_or_name,
    )


def coalesce(*cols_in) -> Column:
    return _scalar_fn("coalesce", _coalesce_vals, *cols_in)


def isnull(col_or_name) -> Column:
    c = col_or_name if isinstance(col_or_name, Column) else col(col_or_name)
    return c.isNull()


def expr(text: str) -> Column:
    """Parse a SQL expression string into a Column against the active
    session's UDF registry (``F.expr("score * 100")``, ``F.expr("n AS
    m")`` — a trailing alias is honored, as pyspark)."""
    from sparkdl_tpu_torch.sql.session import TorchSession, _PredicateParser

    body, alias = TorchSession._strip_alias(text.strip())
    session = TorchSession._active
    out = _PredicateParser(
        body,
        udf_registry=session.udf if session else None,
        session=session,
    ).parse_expression()
    return out.alias(alias or body)


def struct(*cols: "Column | str") -> Column:
    cols_ = [c if isinstance(c, Column) else col(c) for c in cols]

    def ev(colmap, n):
        evaluated = [c._eval(colmap, n) for c in cols_]
        names = [c._name for c in cols_]
        return [Row._make(names, vals) for vals in zip(*evaluated)]

    return Column(ev, "struct(%s)" % ", ".join(c._name for c in cols_))


class UserDefinedFunction:
    """A Python UDF. ``vectorized=True`` UDFs receive whole-partition lists
    (the batched, TensorFrames-"blocked"-mode analog) and must return a list;
    scalar UDFs receive one row's values."""

    def __init__(
        self,
        func: Callable,
        returnType: Optional[DataType] = None,
        name: Optional[str] = None,
        vectorized: bool = False,
    ):
        self.func = func
        self.returnType = returnType
        self._name = name or getattr(func, "__name__", "udf")
        self.vectorized = vectorized

    def __call__(self, *cols_in: "Column | str") -> Column:
        cols_ = [c if isinstance(c, Column) else col(c) for c in cols_in]
        func, vectorized = self.func, self.vectorized

        def ev(colmap, n):
            args = [c._eval(colmap, n) for c in cols_]
            if vectorized:
                out = func(*args)
                out = list(out)
                if len(out) != n:
                    raise ValueError(
                        f"Vectorized UDF {self._name!r} returned {len(out)} "
                        f"rows for a {n}-row partition"
                    )
                return out
            return [func(*vals) for vals in zip(*args)] if n else []

        label = "%s(%s)" % (self._name, ", ".join(c._name for c in cols_))
        return Column(ev, label)


def udf(
    f: Optional[Callable] = None,
    returnType: Optional[DataType] = None,
    vectorized: bool = False,
):
    """Create a UDF; usable directly or as a decorator."""
    if f is None:
        return lambda func: UserDefinedFunction(func, returnType, vectorized=vectorized)
    return UserDefinedFunction(f, returnType, vectorized=vectorized)


def pandas_udf(f: Callable, returnType: Optional[DataType] = None):
    """Arrow/pandas-shaped UDF: receives and returns whole-column sequences."""
    return UserDefinedFunction(f, returnType, vectorized=True)
