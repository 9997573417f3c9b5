"""Attention schedules (dense only; ring and Ulysses are not ported yet) and
the single-device training step."""

from sparkdl_tpu_torch.parallel.context import full_attention
from sparkdl_tpu_torch.parallel.trainer import (
    TrainState,
    init_train_state,
    make_train_step,
)

__all__ = ["TrainState", "full_attention", "init_train_state", "make_train_step"]
