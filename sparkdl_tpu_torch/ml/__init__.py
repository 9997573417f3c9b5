"""Pipeline-stage base classes and vectors (a trimmed copy of ``sparkdl_tpu.ml``)."""

from sparkdl_tpu_torch.ml.base import Estimator, Transformer
from sparkdl_tpu_torch.ml.linalg import DenseVector, Vectors

__all__ = ["Estimator", "Transformer", "DenseVector", "Vectors"]
