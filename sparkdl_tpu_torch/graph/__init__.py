"""The graph layer: port of ``sparkdl_tpu.graph``.

:class:`TorchFunction` (alias ``GraphFunction``) holds a function over
tensors and its params, composes with others, and exports through
``torch.export``; :class:`IsolatedSession` is the session shim; ``pieces``
holds the prebuilt converter, flattener, resizer and preprocessor.
"""

from sparkdl_tpu_torch.graph.function import GraphFunction, TorchFunction
from sparkdl_tpu_torch.graph.builder import IsolatedSession
from sparkdl_tpu_torch.graph import pieces, utils

__all__ = ["TorchFunction", "GraphFunction", "IsolatedSession", "pieces", "utils"]
