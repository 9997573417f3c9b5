"""Models of the port and their weight converters."""

from sparkdl_tpu_torch.models.convert import (
    cnn_flax_from_state_dict,
    cnn_state_dict_from_flax,
    inception_flax_from_state_dict,
    inception_state_dict_from_flax,
    vit_flax_from_state_dict,
    vit_state_dict_from_flax,
)
from sparkdl_tpu_torch.models.inception_v3 import InceptionV3
from sparkdl_tpu_torch.models.keras_port import port_keras_weights
from sparkdl_tpu_torch.models.mobilenet_v2 import MobileNetV2
from sparkdl_tpu_torch.models.registry import (
    KERAS_APPLICATION_MODELS,
    SUPPORTED_MODELS,
    KerasApplicationModel,
    get_keras_application_model,
)
from sparkdl_tpu_torch.models.resnet import ResNet50
from sparkdl_tpu_torch.models.vgg import VGG16, VGG19
from sparkdl_tpu_torch.models.vit import VIT_VARIANTS, ViT, ViTEncoderBlock
from sparkdl_tpu_torch.models.xception import Xception

__all__ = ["InceptionV3", "KERAS_APPLICATION_MODELS", "KerasApplicationModel",
           "MobileNetV2", "ResNet50", "SUPPORTED_MODELS", "VGG16", "VGG19",
           "VIT_VARIANTS", "ViT", "ViTEncoderBlock", "Xception",
           "cnn_flax_from_state_dict", "cnn_state_dict_from_flax",
           "get_keras_application_model", "inception_flax_from_state_dict",
           "inception_state_dict_from_flax", "port_keras_weights",
           "vit_flax_from_state_dict", "vit_state_dict_from_flax"]
