"""Image-file estimators of the port and their fitted models."""

from sparkdl_tpu_torch.estimators.torch_image_file_estimator import (
    TorchImageFileEstimator,
    TorchImageFileTransformer,
)

__all__ = ["TorchImageFileEstimator", "TorchImageFileTransformer"]
