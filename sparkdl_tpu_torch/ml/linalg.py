"""MLlib-compatible dense vectors (pyspark.ml.linalg API subset).

A copy of ``sparkdl_tpu.ml.linalg``.
"""

from __future__ import annotations

from typing import Iterable

import numpy as np


class DenseVector:
    __slots__ = ("_values",)

    def __init__(self, values: Iterable[float]):
        arr = np.asarray(values, dtype=np.float64)
        if arr.ndim != 1:
            raise ValueError("DenseVector must be 1-dimensional")
        self._values = arr

    def toArray(self) -> np.ndarray:
        return self._values

    @property
    def values(self) -> np.ndarray:
        return self._values

    def dot(self, other) -> float:
        other_arr = other.toArray() if isinstance(other, DenseVector) else np.asarray(other)
        return float(np.dot(self._values, other_arr))

    def norm(self, p: float = 2.0) -> float:
        return float(np.linalg.norm(self._values, p))

    def squared_distance(self, other) -> float:
        other_arr = other.toArray() if isinstance(other, DenseVector) else np.asarray(other)
        diff = self._values - other_arr
        return float(np.dot(diff, diff))

    def __len__(self):
        return len(self._values)

    def __getitem__(self, idx):
        return self._values[idx]

    def __iter__(self):
        return iter(self._values)

    def __eq__(self, other):
        if isinstance(other, DenseVector):
            return np.array_equal(self._values, other._values)
        return NotImplemented

    def __hash__(self):
        return hash(self._values.tobytes())

    def __repr__(self):
        return f"DenseVector({self._values.tolist()})"


class Vectors:
    @staticmethod
    def dense(*values) -> DenseVector:
        if len(values) == 1 and isinstance(values[0], (list, tuple, np.ndarray)):
            return DenseVector(values[0])
        return DenseVector(values)
