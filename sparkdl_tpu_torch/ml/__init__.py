"""Pipeline stages, persistence and vectors (a trimmed copy of
``sparkdl_tpu.ml``)."""

from sparkdl_tpu_torch.ml.base import Estimator, Evaluator, Model, Transformer
from sparkdl_tpu_torch.ml.linalg import DenseVector, Vectors

__all__ = ["Estimator", "Evaluator", "Model", "Transformer", "DenseVector",
           "Vectors"]
