"""Attention schedules of the port (dense only; ring and Ulysses are not ported yet)."""

from sparkdl_tpu_torch.parallel.context import full_attention

__all__ = ["full_attention"]
