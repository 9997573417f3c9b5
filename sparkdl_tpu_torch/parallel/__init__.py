"""Distributed execution: process groups, DP and DP x TP steps, sequence
parallelism.

Port of ``sparkdl_tpu.parallel``: :mod:`runner` (``torch.distributed``, one
rank per card), the training step on one card or data-parallel across
ranks (:mod:`trainer`), tensor parallelism as ``DTensor`` placements
(:mod:`tp`), ring and Ulysses attention (:mod:`context`) and the Keras
step (:mod:`keras_train`).
"""

from sparkdl_tpu_torch.parallel import runner  # noqa: F401
from sparkdl_tpu_torch.parallel.context import full_attention
from sparkdl_tpu_torch.parallel.trainer import (
    TrainState,
    init_train_state,
    make_mesh,
    make_train_step,
    shard_batch,
)

__all__ = ["TrainState", "full_attention", "init_train_state", "make_mesh",
           "make_train_step", "runner", "shard_batch"]
