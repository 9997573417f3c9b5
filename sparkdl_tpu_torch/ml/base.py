"""The ``Transformer`` stage contract (pyspark.ml.base subset).

A trimmed copy of ``sparkdl_tpu.ml.base``: ``transform(df[, params])``.
Persistence (``MLWritable`` / ``MLReadable``) is not ported yet.
"""

from __future__ import annotations

import abc
from typing import Any, Dict, Optional

from sparkdl_tpu_torch.param.base import Param, Params


class Transformer(Params, metaclass=abc.ABCMeta):
    def transform(self, dataset, params: Optional[Dict[Param, Any]] = None):
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
