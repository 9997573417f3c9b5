"""sparkdl_tpu_torch — Deep Learning Pipelines on PyTorch and an NVIDIA H100.

The port of ``sparkdl_tpu`` (JAX on a TPU): the same pipeline stages, params
and outputs from the same weights and inputs, with every Pallas kernel of the
JAX package written again by hand for Hopper (``ops/csrc``). The port imports
``torch`` and never ``jax`` nor the JAX package. Entry points run on the card
(``device=None`` is ``"cuda"``) unless the caller passes ``device="cpu"``.

Exports resolve lazily (PEP 562) so importing the package stays cheap.
"""

import importlib
import os

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
    "prometheus_text": "sparkdl_tpu_torch.obs",
    "tracer": "sparkdl_tpu_torch.obs",
    "registerKerasImageUDF": "sparkdl_tpu_torch.udf.keras_image_model",
    "resolve_device": "sparkdl_tpu_torch.utils.device",
    "vit_state_dict_from_flax": "sparkdl_tpu_torch.models.convert",
}

__all__ = ["VERSION", *sorted(_EXPORTS)]

# Zero-code trace capture: SPARKDL_TRACE_OUT=<path.jsonl> enables the tracer
# with a bounded JSONL sink appended at interpreter exit, so a worker
# subprocess captures into the same file with no code of its own;
# SPARKDL_TRACE_SAMPLE arms tail-aware sampling. No variable, no obs import.
if os.environ.get("SPARKDL_TRACE_OUT") or os.environ.get("SPARKDL_TRACE_SAMPLE"):
    from sparkdl_tpu_torch.obs import enable_from_env as _obs_enable_from_env

    _obs_enable_from_env()

# Zero-code flight recorder: SPARKDL_BLACKBOX_DIR=<dir> arms it (periodic
# atomic persist and crash hooks), so a worker leaves a post-mortem dump
# even when it is killed.
if os.environ.get("SPARKDL_BLACKBOX_DIR"):
    from sparkdl_tpu_torch.obs.blackbox import enable_from_env as _blackbox_enable_from_env

    _blackbox_enable_from_env()

# Zero-code introspection server: SPARKDL_OBS_PORT=<port> serves /metrics,
# /healthz, /slo and /debug/* on localhost (0 picks a free port).
if os.environ.get("SPARKDL_OBS_PORT"):
    from sparkdl_tpu_torch.obs.server import enable_from_env as _obs_server_enable_from_env

    _obs_server_enable_from_env()


def __getattr__(name):
    if name in _EXPORTS:
        module = importlib.import_module(_EXPORTS[name])
        value = getattr(module, name)
        globals()[name] = value
        return value
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))
