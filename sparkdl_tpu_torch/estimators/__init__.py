"""Fitted image-file models of the port (the estimators' ``fit`` is not ported yet)."""

from sparkdl_tpu_torch.estimators.torch_image_file_estimator import (
    TorchImageFileTransformer,
)

__all__ = ["TorchImageFileTransformer"]
