"""Models of the port and their weight converters."""

from sparkdl_tpu_torch.models.convert import (
    inception_flax_from_state_dict,
    inception_state_dict_from_flax,
    vit_flax_from_state_dict,
    vit_state_dict_from_flax,
)
from sparkdl_tpu_torch.models.inception_v3 import InceptionV3
from sparkdl_tpu_torch.models.registry import (
    SUPPORTED_MODELS,
    get_keras_application_model,
)
from sparkdl_tpu_torch.models.vit import VIT_VARIANTS, ViT, ViTEncoderBlock

__all__ = ["InceptionV3", "SUPPORTED_MODELS", "VIT_VARIANTS", "ViT",
           "ViTEncoderBlock", "get_keras_application_model",
           "inception_flax_from_state_dict", "inception_state_dict_from_flax",
           "vit_flax_from_state_dict", "vit_state_dict_from_flax"]
