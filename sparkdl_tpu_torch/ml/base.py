"""Transformer / Estimator / Model / Evaluator (pyspark.ml.base subset).

A trimmed copy of ``sparkdl_tpu.ml.base``: ``transform(df[, params])``,
``fit(df[, params or a list of them])``, ``evaluate(df[, params])``, and
persistence (``MLWritable`` / ``MLReadable``) on every stage, and
``fitMultiple``, the thread-safe iterator ``CrossValidator`` drives from a
thread pool.
"""

from __future__ import annotations

import abc
import threading
from typing import Any, Dict, Iterator, Optional, Sequence, Tuple, Union

from sparkdl_tpu_torch.ml.util import MLReadable, MLWritable
from sparkdl_tpu_torch.param.base import Param, Params

ParamMap = Dict[Param, Any]


class Transformer(Params, MLWritable, MLReadable, metaclass=abc.ABCMeta):
    def transform(self, dataset, params: Optional[ParamMap] = None):
        if params is None:
            params = {}
        if isinstance(params, dict):
            if params:
                return self.copy(params)._transform(dataset)
            return self._transform(dataset)
        raise TypeError(f"Params must be a param map but got {type(params)}.")

    @abc.abstractmethod
    def _transform(self, dataset):
        ...


class Model(Transformer, metaclass=abc.ABCMeta):
    """A Transformer produced by an Estimator."""


class Estimator(Params, MLWritable, MLReadable, metaclass=abc.ABCMeta):
    @abc.abstractmethod
    def _fit(self, dataset) -> Transformer:
        ...

    def fit(
        self,
        dataset,
        params: Optional[Union[ParamMap, Sequence[ParamMap]]] = None,
    ):
        """One fitted model for one param map, or a list of them, in order,
        for a list of param maps."""
        if params is None:
            params = {}
        if isinstance(params, (list, tuple)):
            return [self.fit(dataset, p) for p in params]
        if isinstance(params, dict):
            if params:
                return self.copy(params)._fit(dataset)
            return self._fit(dataset)
        raise TypeError(
            "Params must be either a param map or a list/tuple of param "
            f"maps, but got {type(params)}."
        )

    def fitMultiple(
        self, dataset, paramMaps: Sequence[ParamMap]
    ) -> Iterator[Tuple[int, Transformer]]:
        """One model per param map, as ``(index, model)`` pairs, possibly out
        of order. Safe to drive from several threads at once: each ``next``
        takes the next index under a lock and fits outside it."""
        estimator = self.copy()
        lock = threading.Lock()
        indices = iter(range(len(paramMaps)))

        class _Iter:
            def __iter__(self):
                return self

            def __next__(inner):
                with lock:
                    index = next(indices)
                return index, estimator.fit(dataset, paramMaps[index])

        return _Iter()


class Evaluator(Params, MLWritable, MLReadable, metaclass=abc.ABCMeta):
    @abc.abstractmethod
    def _evaluate(self, dataset) -> float:
        ...

    def evaluate(self, dataset, params: Optional[ParamMap] = None) -> float:
        if params:
            return self.copy(params)._evaluate(dataset)
        return self._evaluate(dataset)

    def isLargerBetter(self) -> bool:
        return True
