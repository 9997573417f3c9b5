"""Column references and UDFs: the part of ``sparkdl_tpu.sql.functions``
that the model-serving UDFs need.

A :class:`Column` evaluates against a partition (a dict of column lists);
``col(name)`` reads a column and ``alias`` renames it. A
:class:`UserDefinedFunction` called on columns gives a :class:`Column`; a
``vectorized`` UDF receives whole-partition lists (the batched,
TensorFrames-"blocked"-mode analog) and must return one value per row.
Operators, aggregates and the other functions of the JAX package's column
layer are not ported (ROADMAP item 14).
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional

from sparkdl_tpu_torch.sql.types import DataType


class Column:
    """An expression evaluable against a partition (dict of column lists)."""

    def __init__(self, eval_fn: Callable[[dict, int], List[Any]], name: str):
        # eval_fn(partition_columns, n_rows) -> list of n_rows values
        self._eval = eval_fn
        self._name = name

    @staticmethod
    def _column_ref(name: str) -> "Column":
        def ev(cols, n):
            if name not in cols:
                raise KeyError(f"No such column: {name!r}")
            return cols[name]

        return Column(ev, name)

    def alias(self, name: str) -> "Column":
        return Column(self._eval, name)

    def __repr__(self):
        return f"Column<{self._name!r}>"


def col(name: str) -> Column:
    return Column._column_ref(name)


class UserDefinedFunction:
    """A Python UDF. ``vectorized=True`` UDFs receive whole-partition lists
    and must return a list of as many rows; scalar UDFs receive one row's
    values."""

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
                out = list(func(*args))
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
