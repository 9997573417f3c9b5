"""makeGraphUDF: register a TorchFunction as a named SQL UDF.

Port of ``sparkdl_tpu.graph.tensorframes_udf``: the UDF is vectorized: it
receives whole-partition column lists, stacks them into batches and runs
the function on ``device`` (the card unless ``"cpu"`` is set) through
:func:`~sparkdl_tpu_torch.transformers.utils.run_batched_multi`. The
TensorFrames "blocked" mode is the only mode.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from sparkdl_tpu_torch.graph.function import TorchFunction
from sparkdl_tpu_torch.ml.linalg import DenseVector
from sparkdl_tpu_torch.sql.functions import UserDefinedFunction
from sparkdl_tpu_torch.sql.types import Row
from sparkdl_tpu_torch.transformers.utils import DEFAULT_BATCH_SIZE, run_batched_multi
from sparkdl_tpu_torch.utils.device import resolve_device


def _rows_from_output(out: np.ndarray):
    """Per-row Python values: scalars for rank-1 results, DenseVectors for
    anything higher (flattened), the MLlib-Vector convention of the
    reference's UDF output."""
    if out.ndim == 1:
        return [float(v) for v in out]
    flat = out.reshape(out.shape[0], -1).astype(np.float64)
    return [DenseVector(v) for v in flat]


def makeGraphUDF(
    fn: TorchFunction,
    udfName: str,
    blocked: bool = True,
    register: bool = True,
    session=None,
    batchSize: int = DEFAULT_BATCH_SIZE,
    device: Optional[str] = None,
) -> UserDefinedFunction:
    """Build (and by default register) a SQL UDF evaluating ``fn``.

    ``blocked`` is accepted for API parity and ignored: execution is always
    batched. Input columns must hold numeric scalars or fixed-shape nested
    lists or arrays; each is stacked along a new leading batch axis as
    float32. A single-output function yields scalars or ``DenseVector``s per
    row; a multi-output function yields ``Row``s keyed by
    ``fn.output_names``."""
    if not isinstance(fn, TorchFunction):
        raise TypeError(f"makeGraphUDF expects a TorchFunction, got {type(fn).__name__}")
    device = resolve_device(device)
    params = fn.placed_params(device)
    output_names = list(fn.output_names)

    def forward(*xs):
        with torch.inference_mode():
            return fn.apply(params, *xs)

    def evaluate(*columns):
        if len(columns[0]) == 0:
            return []
        arrays = [np.asarray([np.asarray(v, dtype=np.float32) for v in c]) for c in columns]
        results = run_batched_multi(forward, arrays, batchSize, device=device)
        if len(results) == 1:
            return _rows_from_output(results[0])
        per_output = [_rows_from_output(r) for r in results]
        return [Row(**dict(zip(output_names, vals))) for vals in zip(*per_output)]

    udf = UserDefinedFunction(evaluate, name=udfName, vectorized=True)
    if register:
        from sparkdl_tpu_torch.sql.session import TorchSession

        session = session or TorchSession.getActiveSession()
        session.udf.register(udfName, udf)
    return udf


# snake_case alias
make_graph_udf = makeGraphUDF
