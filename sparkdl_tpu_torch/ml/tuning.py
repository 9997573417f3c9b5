"""Hyperparameter tuning (pyspark.ml.tuning subset): a copy of
``sparkdl_tpu.ml.tuning``.

``ParamGridBuilder`` builds the cartesian grid of param maps;
``CrossValidator`` splits the frame in ``numFolds`` folds with
``randomSplit([1.0] * numFolds, seed)`` (the JAX package's draws, so one
seed gives the same folds), fits one model per param map on each fold's
training rows through ``fitMultiple`` from a pool of ``parallelism``
threads, averages the evaluator's metric over the folds and refits the best
param map on the whole frame. A grid over a ``Pipeline`` stage's params
reaches the stage (``Pipeline.copy`` passes the map on), so a grid over
``DeepImageFeaturizer.modelName`` picks the backbone.

``partitionDevices=True`` is the JAX package's trial parallelism across
device slices: the local cards are split into ``parallelism`` equal slices
(:func:`~sparkdl_tpu_torch.parallel.trainer.partition_devices`, which
raises before any fit when they do not divide) and each trial thread is
bound to one (:func:`~sparkdl_tpu_torch.parallel.trainer.bind_device_slice`),
so every ``device=None`` its fits resolve is its own card. One process
drives one card, so a slice is one card: ``parallelism`` equals the number
of cards, or it raises. The binding happens at ``parallelism=1`` too (one
slice of every card), where the JAX package binds nothing; with one card
that is the same card.
"""

from __future__ import annotations

import os
import threading
from concurrent.futures import ThreadPoolExecutor
from queue import Queue
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from sparkdl_tpu_torch.ml.base import Estimator, Model
from sparkdl_tpu_torch.ml.util import load_stage
from sparkdl_tpu_torch.param.base import Param, TypeConverters, keyword_only

ParamMap = Dict[Param, Any]


def _walk_params_objects(root):
    """``root`` and its nested stages (``Pipeline``): the owners a saved
    param map can name."""
    yield root
    if hasattr(root, "getStages"):
        try:
            for stage in root.getStages():
                yield from _walk_params_objects(stage)
        except KeyError:
            pass


def _encode_param_maps(param_maps) -> List[List[Dict[str, Any]]]:
    return [[{"parent": p.parent, "name": p.name, "value": v} for p, v in pmap.items()]
            for pmap in param_maps]


def _decode_param_maps(encoded, estimator) -> List[ParamMap]:
    """Saved param maps, re-anchored on the params of ``estimator`` and its
    nested stages (matched by uid)."""
    owners = list(_walk_params_objects(estimator))
    maps: List[ParamMap] = []
    for entries in encoded:
        pmap: ParamMap = {}
        for entry in entries:
            owner = next((o for o in owners if o.uid == entry["parent"]), None)
            if owner is None:
                raise ValueError(
                    f"Cannot resolve param {entry['name']!r} of "
                    f"{entry['parent']!r} against the restored estimator"
                )
            pmap[owner.getParam(entry["name"])] = entry["value"]
        maps.append(pmap)
    return maps


class ParamGridBuilder:
    """Builds a cartesian grid of param maps (pyspark's API)."""

    def __init__(self):
        self._param_grid: Dict[Param, List[Any]] = {}

    def addGrid(self, param: Param, values: Sequence[Any]) -> "ParamGridBuilder":
        self._param_grid[param] = list(values)
        return self

    def baseOn(self, *args) -> "ParamGridBuilder":
        """Fix params in every map: a dict, or ``(param, value)`` pairs."""
        if len(args) == 1 and isinstance(args[0], dict):
            args = tuple(args[0].items())
        for param, value in args:
            self.addGrid(param, [value])
        return self

    def build(self) -> List[ParamMap]:
        grids: List[ParamMap] = [{}]
        for key, values in self._param_grid.items():
            grids = [{**g, key: v} for g in grids for v in values]
        return grids


class CrossValidatorModel(Model):
    """The best param map's model, refitted on the whole frame, and the
    metric of each param map averaged over the folds."""

    def __init__(self, bestModel: Model, avgMetrics: List[float]):
        super().__init__()
        self.bestModel = bestModel
        self.avgMetrics = list(avgMetrics)

    def _transform(self, dataset):
        return self.bestModel.transform(dataset)

    def _held_stages(self):
        return [self.bestModel]

    def _save_artifacts(self, path: str):
        self.bestModel.write().overwrite().save(os.path.join(path, "bestModel"))
        return {"avgMetrics": [float(m) for m in self.avgMetrics]}

    @classmethod
    def _load_instance(cls, metadata, path: str):
        return cls(load_stage(os.path.join(path, "bestModel")),
                   metadata["extra"]["avgMetrics"])


class CrossValidator(Estimator):
    estimator = Param("undefined", "estimator", "estimator to cross-validate")
    estimatorParamMaps = Param("undefined", "estimatorParamMaps", "param grid")
    evaluator = Param("undefined", "evaluator", "metric evaluator")
    numFolds = Param("undefined", "numFolds", "number of folds", TypeConverters.toInt)
    parallelism = Param("undefined", "parallelism", "number of threads for parallel fits",
                        TypeConverters.toInt)
    partitionDevices = Param(
        "undefined", "partitionDevices",
        "split the local cards into `parallelism` disjoint slices and bind one to "
        "each trial thread, so concurrent trials train on separate cards; the "
        "cards must divide evenly",
        TypeConverters.toBoolean,
    )
    seed = Param("undefined", "seed", "random seed")

    @keyword_only
    def __init__(
        self,
        estimator: Optional[Estimator] = None,
        estimatorParamMaps: Optional[List[ParamMap]] = None,
        evaluator=None,
        numFolds: int = 3,
        parallelism: int = 1,
        partitionDevices: bool = False,
        seed: Optional[int] = None,
    ):
        super().__init__()
        self._setDefault(numFolds=3, parallelism=1, partitionDevices=False, seed=None)
        kwargs = self._input_kwargs
        self.setParams(**kwargs)

    @keyword_only
    def setParams(
        self,
        estimator: Optional[Estimator] = None,
        estimatorParamMaps: Optional[List[ParamMap]] = None,
        evaluator=None,
        numFolds: int = 3,
        parallelism: int = 1,
        partitionDevices: bool = False,
        seed: Optional[int] = None,
    ):
        kwargs = self._input_kwargs
        return self._set(**kwargs)

    def getEstimator(self) -> Estimator:
        return self.getOrDefault(self.estimator)

    def getEstimatorParamMaps(self) -> List[ParamMap]:
        return self.getOrDefault(self.estimatorParamMaps)

    def getEvaluator(self):
        return self.getOrDefault(self.evaluator)

    def _fit(self, dataset) -> CrossValidatorModel:
        est = self.getEstimator()
        param_maps = self.getEstimatorParamMaps()
        evaluator = self.getEvaluator()
        n_folds = self.getOrDefault(self.numFolds)
        parallelism = max(1, self.getOrDefault(self.parallelism))
        slices = None
        if self.getOrDefault(self.partitionDevices):
            from sparkdl_tpu_torch.parallel.trainer import bind_device_slice, partition_devices

            # checked before any fit: the cards must split evenly
            slices = partition_devices(parallelism)
        slice_queue: Optional[Queue] = None

        def bind_slice():
            if slice_queue is not None:
                bind_device_slice(slice_queue.get_nowait())

        folds = dataset.randomSplit([1.0] * n_folds, seed=self.getOrDefault(self.seed))
        metrics = np.zeros((len(param_maps),), dtype=np.float64)
        lock = threading.Lock()
        for fold_idx, validation in enumerate(folds):
            train = None
            for j, fold in enumerate(folds):
                if j != fold_idx:
                    train = fold if train is None else train.union(fold)
            fit_iter = est.fitMultiple(train, param_maps)

            def consume_one(_):
                index, model = next(fit_iter)
                metric = evaluator.evaluate(model.transform(validation))
                with lock:
                    metrics[index] += metric

            if slices is not None:
                # a fresh queue per fold: each pool makes fresh worker
                # threads, and every one binds its own slice
                slice_queue = Queue()
                for s in slices:
                    slice_queue.put(s)
            with ThreadPoolExecutor(max_workers=parallelism, initializer=bind_slice) as pool:
                list(pool.map(consume_one, range(len(param_maps))))

        metrics /= n_folds
        best_index = (int(np.argmax(metrics)) if evaluator.isLargerBetter()
                      else int(np.argmin(metrics)))
        best_model = est.fit(dataset, param_maps[best_index])
        return self._copyValues(CrossValidatorModel(best_model, metrics.tolist()))

    # -- persistence ----------------------------------------------------
    _exclude_params_from_save = ("estimator", "evaluator", "estimatorParamMaps")

    def _held_stages(self):
        return [self.getOrDefault(p) for p in (self.estimator, self.evaluator)
                if self.isDefined(p)]

    def _save_artifacts(self, path: str):
        extra: Dict[str, Any] = {}
        if self.isDefined(self.estimator):
            self.getEstimator().write().overwrite().save(os.path.join(path, "estimator"))
            extra["estimator"] = "estimator"
        if self.isDefined(self.evaluator):
            self.getEvaluator().write().overwrite().save(os.path.join(path, "evaluator"))
            extra["evaluator"] = "evaluator"
        if self.isDefined(self.estimatorParamMaps):
            extra["estimatorParamMaps"] = _encode_param_maps(self.getEstimatorParamMaps())
        return extra

    def _load_artifacts(self, extra, path: str):
        if "estimator" in extra:
            self._set(estimator=load_stage(os.path.join(path, extra["estimator"])))
        if "evaluator" in extra:
            self._set(evaluator=load_stage(os.path.join(path, extra["evaluator"])))
        if "estimatorParamMaps" in extra:
            self._set(estimatorParamMaps=_decode_param_maps(
                extra["estimatorParamMaps"], self.getEstimator()))
