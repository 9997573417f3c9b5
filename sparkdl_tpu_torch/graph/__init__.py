"""The graph layer: port of ``sparkdl_tpu.graph``.

:class:`TorchFunction` (alias ``GraphFunction``) holds a function over
tensors and its params, composes with others, exports through
``torch.export`` and reads Keras files (``from_keras``);
:class:`IsolatedSession` is the session shim; ``pieces`` holds the prebuilt
converter, flattener, resizer and preprocessor; ``tensorframes_udf``
registers a function as a SQL UDF (``makeGraphUDF``, exported by the
package as the JAX package does).
"""

from sparkdl_tpu_torch.graph.function import GraphFunction, TorchFunction
from sparkdl_tpu_torch.graph.builder import IsolatedSession
from sparkdl_tpu_torch.graph import pieces, utils

__all__ = ["TorchFunction", "GraphFunction", "IsolatedSession", "pieces", "utils"]
