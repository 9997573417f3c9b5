"""LogisticRegression: the transfer-learning head.

Port of ``sparkdl_tpu.ml.classification``: multinomial logistic regression
trained full-batch from zeros, ``k = max(label) + 1`` classes, on mean
softmax cross-entropy plus ``regParam * sum(w**2)``, by ``maxIter`` adam
steps at ``stepSize`` with optax's defaults (``torch.optim.Adam``, as
:func:`~sparkdl_tpu_torch.estimators.losses.get_optimizer` builds it). The
JAX package's loop is one jitted ``lax.scan``; here it is a plain loop of
steps on ``device`` (the card unless ``"cpu"`` is set). The fitted model
gives softmax probabilities and the argmax as a float, and persists its
weights to ``lr_model.npz``.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F

from sparkdl_tpu_torch.estimators.losses import get_optimizer
from sparkdl_tpu_torch.ml.base import Estimator, Model
from sparkdl_tpu_torch.ml.linalg import DenseVector
from sparkdl_tpu_torch.param.base import Param, TypeConverters, keyword_only
from sparkdl_tpu_torch.param.shared import HasDevice, HasInputCol, HasLabelCol
from sparkdl_tpu_torch.utils.device import resolve_device


class LogisticRegressionModel(Model, HasDevice):
    def __init__(self, weights, bias, featuresCol, predictionCol,
                 probabilityCol, device=None):
        super().__init__()
        self.weights = weights  # (D, K) float32
        self.bias = bias  # (K,)
        self._features_col = featuresCol
        self._prediction_col = predictionCol
        self._probability_col = probabilityCol
        self._setDefault(device=None)
        self._set(device=device)

    @property
    def numClasses(self) -> int:
        return int(self.weights.shape[1])

    def _save_artifacts(self, path: str):
        np.savez(
            os.path.join(path, "lr_model.npz"),
            weights=np.asarray(self.weights),
            bias=np.asarray(self.bias),
        )
        return {
            "featuresCol": self._features_col,
            "predictionCol": self._prediction_col,
            "probabilityCol": self._probability_col,
        }

    @classmethod
    def _load_instance(cls, metadata, path: str):
        extra = metadata["extra"]
        with np.load(os.path.join(path, "lr_model.npz")) as data:
            weights, bias = data["weights"], data["bias"]
        return cls(weights, bias, extra["featuresCol"], extra["predictionCol"],
                   extra["probabilityCol"])

    def _transform(self, dataset):
        device = resolve_device(self.getDevice())
        w = torch.as_tensor(np.asarray(self.weights, np.float32), device=device)
        b = torch.as_tensor(np.asarray(self.bias, np.float32), device=device)
        features_col = self._features_col
        prediction_col = self._prediction_col
        probability_col = self._probability_col

        def process_partition(part):
            out = dict(part)
            feats = part[features_col]
            if not feats:
                out[prediction_col] = []
                if probability_col:
                    out[probability_col] = []
                return out
            x = np.stack([np.asarray(v, dtype=np.float32) for v in feats])
            x = torch.from_numpy(x).to(device)
            probs = torch.softmax(x @ w + b, dim=-1).cpu().numpy()
            out[prediction_col] = [float(p.argmax()) for p in probs]
            if probability_col:
                out[probability_col] = [DenseVector(p.astype(np.float64)) for p in probs]
            return out

        return dataset.mapPartitions(process_partition)


def train_logistic_regression(x: torch.Tensor, y: torch.Tensor, k: int,
                              max_iter: int, reg: float, lr: float):
    """``max_iter`` full-batch adam steps from zero weights on ``x`` (N, D)
    and integer labels ``y`` (N,); returns ``(w (D, K), b (K,))``."""
    w = torch.zeros((x.shape[1], k), dtype=torch.float32, device=x.device,
                    requires_grad=True)
    b = torch.zeros((k,), dtype=torch.float32, device=x.device, requires_grad=True)
    opt = get_optimizer("adam", lr)([w, b])
    for _ in range(max_iter):
        opt.zero_grad()
        loss = F.cross_entropy(x @ w + b, y) + reg * (w ** 2).sum()
        loss.backward()
        opt.step()
    return w.detach(), b.detach()


class LogisticRegression(Estimator, HasInputCol, HasLabelCol, HasDevice):
    featuresCol = Param(
        "undefined", "featuresCol", "features column name",
        TypeConverters.toString,
    )
    predictionCol = Param(
        "undefined", "predictionCol", "prediction column name",
        TypeConverters.toString,
    )
    probabilityCol = Param(
        "undefined", "probabilityCol", "probability column name",
        TypeConverters.toString,
    )
    maxIter = Param(
        "undefined", "maxIter", "max optimization steps", TypeConverters.toInt
    )
    regParam = Param(
        "undefined", "regParam", "L2 regularization strength",
        TypeConverters.toFloat,
    )
    stepSize = Param(
        "undefined", "stepSize", "optimizer learning rate",
        TypeConverters.toFloat,
    )

    @keyword_only
    def __init__(
        self,
        featuresCol: str = "features",
        labelCol: str = "label",
        predictionCol: str = "prediction",
        probabilityCol: str = "probability",
        maxIter: int = 100,
        regParam: float = 0.0,
        stepSize: float = 0.1,
        device=None,
    ):
        super().__init__()
        self._setDefault(
            featuresCol="features",
            labelCol="label",
            predictionCol="prediction",
            probabilityCol="probability",
            maxIter=100,
            regParam=0.0,
            stepSize=0.1,
            device=None,
        )
        kwargs = self._input_kwargs
        self.setParams(**kwargs)

    @keyword_only
    def setParams(
        self,
        featuresCol: str = "features",
        labelCol: str = "label",
        predictionCol: str = "prediction",
        probabilityCol: str = "probability",
        maxIter: int = 100,
        regParam: float = 0.0,
        stepSize: float = 0.1,
        device=None,
    ):
        kwargs = self._input_kwargs
        return self._set(**kwargs)

    def _fit(self, dataset) -> LogisticRegressionModel:
        device = resolve_device(self.getDevice())
        features_col = self.getOrDefault(self.featuresCol)
        label_col = self.getOrDefault(self.labelCol)
        rows = dataset.select(features_col, label_col).collect()
        if not rows:
            raise ValueError("LogisticRegression.fit received an empty dataset")
        x = np.stack([np.asarray(r[features_col], dtype=np.float32) for r in rows])
        y = np.asarray([int(r[label_col]) for r in rows], dtype=np.int64)
        w, b = train_logistic_regression(
            torch.from_numpy(x).to(device), torch.from_numpy(y).to(device),
            int(y.max()) + 1, self.getOrDefault(self.maxIter),
            self.getOrDefault(self.regParam), self.getOrDefault(self.stepSize),
        )
        return self._copyValues(
            LogisticRegressionModel(
                w.cpu().numpy(),
                b.cpu().numpy(),
                features_col,
                self.getOrDefault(self.predictionCol),
                self.getOrDefault(self.probabilityCol),
            )
        )
