"""IsolatedSession: port of ``sparkdl_tpu.graph.builder``.

The original ``IsolatedSession`` gave each scope a fresh TF graph and
session. PyTorch runs eagerly and keeps no graph state, so the session
carries none; the shim lets code written against the original
(``with IsolatedSession() as issn: ... issn.asGraphFunction(...)``) run as
it is.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Sequence

import torch

from sparkdl_tpu_torch.graph.function import TorchFunction


class IsolatedSession:
    """Context manager in the shape of the original isolated TF session."""

    def __init__(self, using_keras: bool = False):
        self.using_keras = using_keras  # kept for the signature
        self._graph_fn: Optional[Callable] = None
        self._params: Any = {}

    def __enter__(self) -> "IsolatedSession":
        return self

    def __exit__(self, *exc):
        return False

    def run(self, fn: Callable, *args):
        """Evaluate a callable over tensors (the ``sess.run`` analog)."""
        with torch.inference_mode():
            return fn(*args)

    def importGraphFunction(self, gfn: TorchFunction, prefix: str = ""):
        """Stage an existing TorchFunction in this scope (the
        ``import_graph_def`` analog); returns its input and output names."""
        self._graph_fn = gfn.apply_fn
        self._params = gfn.params
        return gfn.input_names, gfn.output_names

    def makeGraphFunction(
        self,
        fn: Callable,
        params: Any = None,
        inputs: Sequence[str] = ("input",),
        outputs: Sequence[str] = ("output",),
        takes_params: bool = False,
    ) -> TorchFunction:
        return TorchFunction.from_callable(
            fn, params=params, input_names=inputs, output_names=outputs,
            takes_params=takes_params,
        )

    def asGraphFunction(
        self, inputs: Sequence[str], outputs: Sequence[str]
    ) -> TorchFunction:
        """Package what was staged in this scope as a TorchFunction."""
        if self._graph_fn is None:
            raise RuntimeError(
                "Nothing staged in this session; use importGraphFunction or "
                "makeGraphFunction"
            )
        return TorchFunction(self._graph_fn, self._params, list(inputs), list(outputs))
