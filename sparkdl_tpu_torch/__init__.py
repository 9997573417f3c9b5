"""sparkdl_tpu_torch — Deep Learning Pipelines on PyTorch and an NVIDIA H100.

The port of ``sparkdl_tpu`` (JAX on a TPU): the same pipeline stages, params
and outputs from the same weights and inputs, with every Pallas kernel of the
JAX package written again by hand for Hopper (``ops/csrc``). The port imports
``torch`` and never ``jax`` nor the JAX package. Entry points run on the card
(``device=None`` is ``"cuda"``) unless the caller passes ``device="cpu"``.

Exports resolve lazily (PEP 562) so importing the package stays cheap.
"""

import importlib

VERSION = __version__ = "0.1.0"

_EXPORTS = {
    "CrossValidator": "sparkdl_tpu_torch.ml.tuning",
    "CrossValidatorModel": "sparkdl_tpu_torch.ml.tuning",
    "DeepImageFeaturizer": "sparkdl_tpu_torch.transformers.named_image",
    "DeepImagePredictor": "sparkdl_tpu_torch.transformers.named_image",
    "GraphFunction": "sparkdl_tpu_torch.graph.function",
    "InceptionV3": "sparkdl_tpu_torch.models.inception_v3",
    "IsolatedSession": "sparkdl_tpu_torch.graph.builder",
    "KerasImageFileEstimator": "sparkdl_tpu_torch.estimators.keras_image_file_estimator",
    "KerasImageFileTransformer": "sparkdl_tpu_torch.transformers.keras_image",
    "KerasTransformer": "sparkdl_tpu_torch.transformers.keras_tensor",
    "LogisticRegression": "sparkdl_tpu_torch.ml.classification",
    "MobileNetV2": "sparkdl_tpu_torch.models.mobilenet_v2",
    "MulticlassClassificationEvaluator": "sparkdl_tpu_torch.ml.evaluation",
    "ParamGridBuilder": "sparkdl_tpu_torch.ml.tuning",
    "Pipeline": "sparkdl_tpu_torch.ml.pipeline",
    "PipelineModel": "sparkdl_tpu_torch.ml.pipeline",
    "ResNet50": "sparkdl_tpu_torch.models.resnet",
    "TFImageTransformer": "sparkdl_tpu_torch.transformers.tf_image",
    "TFTransformer": "sparkdl_tpu_torch.transformers.tf_tensor",
    "TorchFunction": "sparkdl_tpu_torch.graph.function",
    "TorchImageFileEstimator": "sparkdl_tpu_torch.estimators.torch_image_file_estimator",
    "TorchImageFileTransformer": "sparkdl_tpu_torch.estimators.torch_image_file_estimator",
    "TorchImageTransformer": "sparkdl_tpu_torch.transformers.tf_image",
    "TorchSession": "sparkdl_tpu_torch.sql.session",
    "TorchTransformer": "sparkdl_tpu_torch.transformers.tf_tensor",
    "VGG16": "sparkdl_tpu_torch.models.vgg",
    "VGG19": "sparkdl_tpu_torch.models.vgg",
    "ViT": "sparkdl_tpu_torch.models.vit",
    "Xception": "sparkdl_tpu_torch.models.xception",
    "flash_attention": "sparkdl_tpu_torch.ops.flash_attention",
    "inception_state_dict_from_flax": "sparkdl_tpu_torch.models.convert",
    "makeGraphUDF": "sparkdl_tpu_torch.graph.tensorframes_udf",
    "registerKerasImageUDF": "sparkdl_tpu_torch.udf.keras_image_model",
    "resolve_device": "sparkdl_tpu_torch.utils.device",
    "vit_state_dict_from_flax": "sparkdl_tpu_torch.models.convert",
}

__all__ = ["VERSION", *sorted(_EXPORTS)]


def __getattr__(name):
    if name in _EXPORTS:
        module = importlib.import_module(_EXPORTS[name])
        value = getattr(module, name)
        globals()[name] = value
        return value
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))
