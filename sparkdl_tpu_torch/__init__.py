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
    "TorchImageFileEstimator": "sparkdl_tpu_torch.estimators.torch_image_file_estimator",
    "TorchImageFileTransformer": "sparkdl_tpu_torch.estimators.torch_image_file_estimator",
    "TorchSession": "sparkdl_tpu_torch.sql.session",
    "ViT": "sparkdl_tpu_torch.models.vit",
    "vit_state_dict_from_flax": "sparkdl_tpu_torch.models.convert",
    "flash_attention": "sparkdl_tpu_torch.ops.flash_attention",
    "resolve_device": "sparkdl_tpu_torch.utils.device",
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
