"""The ``Transformer`` and ``Estimator`` stage contracts (pyspark.ml.base subset).

A trimmed copy of ``sparkdl_tpu.ml.base``: ``transform(df[, params])`` and
``fit(df[, params or a list of them])``. Persistence (``MLWritable`` /
``MLReadable``) is not ported yet.
"""

from __future__ import annotations

import abc
from typing import Any, Dict, Optional, Sequence, Union

from sparkdl_tpu_torch.param.base import Param, Params

ParamMap = Dict[Param, Any]


class Transformer(Params, metaclass=abc.ABCMeta):
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


class Estimator(Params, metaclass=abc.ABCMeta):
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
