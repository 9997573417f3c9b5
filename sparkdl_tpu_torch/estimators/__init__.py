"""Image-file estimators of the port and their fitted models."""

from sparkdl_tpu_torch.estimators.keras_image_file_estimator import KerasImageFileEstimator
from sparkdl_tpu_torch.estimators.torch_image_file_estimator import (
    TorchImageFileEstimator,
    TorchImageFileTransformer,
)

__all__ = ["KerasImageFileEstimator", "TorchImageFileEstimator", "TorchImageFileTransformer"]
