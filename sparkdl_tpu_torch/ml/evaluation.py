"""Evaluators (pyspark.ml.evaluation subset): a copy of
``sparkdl_tpu.ml.evaluation``. ``MulticlassClassificationEvaluator``
computes accuracy or support-weighted F1 on the host."""

from __future__ import annotations

import numpy as np

from sparkdl_tpu_torch.ml.base import Evaluator
from sparkdl_tpu_torch.param.base import Param, TypeConverters, keyword_only


class MulticlassClassificationEvaluator(Evaluator):
    labelCol = Param(
        "undefined", "labelCol", "label column", TypeConverters.toString
    )
    predictionCol = Param(
        "undefined", "predictionCol", "prediction column",
        TypeConverters.toString,
    )
    metricName = Param(
        "undefined", "metricName", "metric: f1|accuracy", TypeConverters.toString
    )

    @keyword_only
    def __init__(
        self,
        labelCol: str = "label",
        predictionCol: str = "prediction",
        metricName: str = "f1",
    ):
        super().__init__()
        self._setDefault(
            labelCol="label", predictionCol="prediction", metricName="f1"
        )
        kwargs = self._input_kwargs
        self.setParams(**kwargs)

    @keyword_only
    def setParams(
        self,
        labelCol: str = "label",
        predictionCol: str = "prediction",
        metricName: str = "f1",
    ):
        kwargs = self._input_kwargs
        return self._set(**kwargs)

    def _evaluate(self, dataset) -> float:
        label_col = self.getOrDefault(self.labelCol)
        pred_col = self.getOrDefault(self.predictionCol)
        rows = dataset.select(label_col, pred_col).collect()
        if not rows:
            return 0.0
        y = np.asarray([float(r[label_col]) for r in rows])
        p = np.asarray([float(r[pred_col]) for r in rows])
        metric = self.getOrDefault(self.metricName)
        if metric == "accuracy":
            return float((y == p).mean())
        if metric == "f1":
            # support-weighted F1, matching pyspark's default "f1" metric
            classes = np.unique(np.concatenate([y, p]))
            total = 0.0
            for c in classes:
                tp = float(((p == c) & (y == c)).sum())
                fp = float(((p == c) & (y != c)).sum())
                fn = float(((p != c) & (y == c)).sum())
                denom = 2 * tp + fp + fn
                f1 = 2 * tp / denom if denom else 0.0
                total += f1 * float((y == c).sum())
            return total / len(y)
        raise ValueError(f"Unknown metric {metric!r}")

    def isLargerBetter(self) -> bool:
        return True
