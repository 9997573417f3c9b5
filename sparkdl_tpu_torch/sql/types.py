"""Row and minimal schema types (pyspark.sql.types API subset).

A copy of ``sparkdl_tpu.sql.types``.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, List, Optional, Sequence


class Row:
    """Immutable-ish named record with attribute and index access,
    API-compatible with ``pyspark.sql.Row`` for the operations the framework
    and its tests use."""

    __slots__ = ("_fields", "_values")

    def __init__(self, **kwargs):
        object.__setattr__(self, "_fields", tuple(kwargs.keys()))
        object.__setattr__(self, "_values", tuple(kwargs.values()))

    @classmethod
    def _make(cls, fields: Sequence[str], values: Sequence[Any]) -> "Row":
        row = cls.__new__(cls)
        object.__setattr__(row, "_fields", tuple(fields))
        object.__setattr__(row, "_values", tuple(values))
        return row

    def __getattr__(self, name):
        try:
            return self._values[self._fields.index(name)]
        except ValueError:
            raise AttributeError(name) from None

    def __getitem__(self, key):
        if isinstance(key, int):
            return self._values[key]
        return self._values[self._fields.index(key)]

    def __contains__(self, key):
        return key in self._fields

    def asDict(self, recursive: bool = False) -> Dict[str, Any]:
        def conv(v):
            if recursive and isinstance(v, Row):
                return v.asDict(True)
            return v

        return {f: conv(v) for f, v in zip(self._fields, self._values)}

    def __fields__(self):
        return list(self._fields)

    def __len__(self):
        return len(self._values)

    def __iter__(self) -> Iterator[Any]:
        return iter(self._values)

    def __eq__(self, other):
        if isinstance(other, Row):
            return (
                self._fields == other._fields and self._values == other._values
            )
        return NotImplemented

    def __hash__(self):
        return hash((self._fields, self._values))

    def __repr__(self):
        body = ", ".join(f"{f}={v!r}" for f, v in zip(self._fields, self._values))
        return f"Row({body})"


class DataType:
    def simpleString(self) -> str:
        return type(self).__name__.replace("Type", "").lower()

    def __eq__(self, other):
        return type(self) is type(other)

    def __hash__(self):
        return hash(type(self))

    def __repr__(self):
        return f"{type(self).__name__}()"


class StringType(DataType):
    pass


class BinaryType(DataType):
    pass


class LongType(DataType):
    pass


class DoubleType(DataType):
    pass


class BooleanType(DataType):
    pass


class ArrayType(DataType):
    def __init__(self, elementType: DataType, containsNull: bool = True):
        self.elementType = elementType
        self.containsNull = containsNull

    def simpleString(self):
        return f"array<{self.elementType.simpleString()}>"

    def __eq__(self, other):
        return (
            isinstance(other, ArrayType)
            and self.elementType == other.elementType
        )

    def __hash__(self):
        return hash(("array", self.elementType))


class NumpyArrayType(DataType):
    """Engine-native column of homogeneous numpy arrays (tensor column)."""

    def simpleString(self):
        return "ndarray"


class VectorType(DataType):
    """MLlib-Vector-like dense vector column."""

    def simpleString(self):
        return "vector"


class ObjectType(DataType):
    """Arbitrary Python objects (engine-native escape hatch)."""

    def simpleString(self):
        return "object"


class StructField:
    def __init__(self, name: str, dataType: DataType, nullable: bool = True):
        self.name = name
        self.dataType = dataType
        self.nullable = nullable

    def __eq__(self, other):
        return (
            isinstance(other, StructField)
            and self.name == other.name
            and self.dataType == other.dataType
        )

    def __repr__(self):
        return f"StructField({self.name!r}, {self.dataType!r})"


class StructType(DataType):
    def __init__(self, fields: Optional[List[StructField]] = None):
        self.fields = fields or []

    @property
    def names(self) -> List[str]:
        return [f.name for f in self.fields]

    fieldNames = names

    def add(self, name: str, dataType: DataType, nullable: bool = True):
        self.fields.append(StructField(name, dataType, nullable))
        return self

    def __getitem__(self, key):
        if isinstance(key, int):
            return self.fields[key]
        for f in self.fields:
            if f.name == key:
                return f
        raise KeyError(key)

    def __iter__(self):
        return iter(self.fields)

    def __len__(self):
        return len(self.fields)

    def __eq__(self, other):
        return isinstance(other, StructType) and self.fields == other.fields

    def simpleString(self):
        inner = ",".join(
            f"{f.name}:{f.dataType.simpleString()}" for f in self.fields
        )
        return f"struct<{inner}>"

    def __repr__(self):
        return f"StructType({self.fields!r})"


def infer_type(value: Any) -> DataType:
    import numpy as np

    from sparkdl_tpu_torch.ml.linalg import DenseVector

    if isinstance(value, bool):
        return BooleanType()
    if isinstance(value, (int, np.integer)):
        return LongType()
    if isinstance(value, (float, np.floating)):
        return DoubleType()
    if isinstance(value, str):
        return StringType()
    if isinstance(value, (bytes, bytearray)):
        return BinaryType()
    if isinstance(value, DenseVector):
        return VectorType()
    if isinstance(value, np.ndarray):
        return NumpyArrayType()
    if isinstance(value, Row):
        st = StructType()
        for f, v in zip(value._fields, value._values):
            st.add(f, infer_type(v))
        return st
    if isinstance(value, (list, tuple)):
        elem = infer_type(value[0]) if len(value) else StringType()
        return ArrayType(elem)
    return ObjectType()
