"""The port's pipeline stages over image and tensor columns, and the batched
inference loop they share (``transformers.utils``).

Exports resolve lazily (PEP 562), so importing ``transformers.utils``
alone stays cheap.
"""

import importlib

_EXPORTS = {
    "DeepImageFeaturizer": "sparkdl_tpu_torch.transformers.named_image",
    "DeepImagePredictor": "sparkdl_tpu_torch.transformers.named_image",
    "KerasImageFileTransformer": "sparkdl_tpu_torch.transformers.keras_image",
    "KerasTransformer": "sparkdl_tpu_torch.transformers.keras_tensor",
    "TFImageTransformer": "sparkdl_tpu_torch.transformers.tf_image",
    "TFTransformer": "sparkdl_tpu_torch.transformers.tf_tensor",
    "TorchImageTransformer": "sparkdl_tpu_torch.transformers.tf_image",
    "TorchTransformer": "sparkdl_tpu_torch.transformers.tf_tensor",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        value = getattr(importlib.import_module(_EXPORTS[name]), name)
        globals()[name] = value
        return value
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))
