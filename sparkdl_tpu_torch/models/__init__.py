"""Models of the port and their weight converters."""

from sparkdl_tpu_torch.models.convert import (
    vit_flax_from_state_dict,
    vit_state_dict_from_flax,
)
from sparkdl_tpu_torch.models.vit import VIT_VARIANTS, ViT, ViTEncoderBlock

__all__ = ["VIT_VARIANTS", "ViT", "ViTEncoderBlock",
           "vit_flax_from_state_dict", "vit_state_dict_from_flax"]
