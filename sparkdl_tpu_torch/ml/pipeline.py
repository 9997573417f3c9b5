"""Pipeline / PipelineModel (pyspark.ml.pipeline subset): a copy of
``sparkdl_tpu.ml.pipeline``, whose ``Pipeline.copy`` passes its param map
on to the stages (as pyspark's does; the JAX package's does not).

Chains Transformers/Estimators, as the transfer-learning flow
``Pipeline([DeepImageFeaturizer, LogisticRegression])`` does. ``fit`` fits
each Estimator on the data transformed by the stages before it, up to the
last Estimator; each stage persists in a directory of its own under
``stages/``.
"""

from __future__ import annotations

import os
from typing import List, Optional

from sparkdl_tpu_torch.ml.base import Estimator, Model, Transformer
from sparkdl_tpu_torch.ml.util import load_stage
from sparkdl_tpu_torch.param.base import Param, Params, keyword_only


def _save_stages(stages, path: str) -> List[str]:
    refs = []
    for i, stage in enumerate(stages):
        ref = os.path.join("stages", f"{i}_{stage.uid}")
        stage.write().overwrite().save(os.path.join(path, ref))
        refs.append(ref)
    return refs


def _load_stages(refs, path: str):
    return [load_stage(os.path.join(path, ref)) for ref in refs]


class Pipeline(Estimator):
    stages = Param("undefined", "stages", "a list of pipeline stages")

    @keyword_only
    def __init__(self, stages: Optional[List[Params]] = None):
        super().__init__()
        kwargs = self._input_kwargs
        self.setParams(**kwargs)

    @keyword_only
    def setParams(self, stages: Optional[List[Params]] = None):
        kwargs = self._input_kwargs
        return self._set(**kwargs)

    def setStages(self, value: List[Params]):
        return self._set(stages=value)

    def getStages(self) -> List[Params]:
        return self.getOrDefault(self.stages)

    def _fit(self, dataset) -> "PipelineModel":
        stages = self.getStages()
        for stage in stages:
            if not isinstance(stage, (Estimator, Transformer)):
                raise TypeError(
                    f"Cannot recognize a pipeline stage of type {type(stage)}."
                )
        last_estimator = -1
        for i, stage in enumerate(stages):
            if isinstance(stage, Estimator):
                last_estimator = i
        transformers: List[Transformer] = []
        for i, stage in enumerate(stages):
            if i <= last_estimator:
                if isinstance(stage, Estimator):
                    model = stage.fit(dataset)
                    transformers.append(model)
                    if i < last_estimator:
                        dataset = model.transform(dataset)
                else:
                    transformers.append(stage)
                    if i < last_estimator:
                        dataset = stage.transform(dataset)
            else:
                transformers.append(stage)
        return PipelineModel(transformers)

    def copy(self, extra=None):
        """A copy whose stages are copied with ``extra`` too, as pyspark's:
        a param map over a stage's params (a ``CrossValidator`` grid over
        ``featurizer.modelName``) reaches that stage. The JAX package's
        ``Pipeline.copy`` copies the stages without ``extra``, so such a
        grid leaves its stages as they were."""
        that = Params.copy(self, extra)
        if that.isDefined(that.stages):
            that._set(stages=[s.copy(extra) for s in that.getStages()])
        return that

    # -- persistence: each stage saved as its own sub-stage directory ----
    _exclude_params_from_save = ("stages",)

    def _held_stages(self):
        return self.getStages()

    def _save_artifacts(self, path: str):
        return {"stages": _save_stages(self.getStages(), path)}

    def _load_artifacts(self, extra, path: str):
        self._set(stages=_load_stages(extra["stages"], path))


class PipelineModel(Model):
    def __init__(self, stages: List[Transformer]):
        super().__init__()
        self.stages = stages

    def _transform(self, dataset):
        for t in self.stages:
            dataset = t.transform(dataset)
        return dataset

    def copy(self, extra=None):
        return PipelineModel([s.copy() for s in self.stages])

    def _held_stages(self):
        return self.stages

    def _save_artifacts(self, path: str):
        return {"stages": _save_stages(self.stages, path)}

    @classmethod
    def _load_instance(cls, metadata, path: str):
        return cls(_load_stages(metadata["extra"]["stages"], path))
