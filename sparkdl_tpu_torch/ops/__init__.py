"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions."""

from sparkdl_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_bwd_reference,
    flash_attention_reference,
)

__all__ = ["flash_attention", "flash_attention_bwd_reference", "flash_attention_reference"]
