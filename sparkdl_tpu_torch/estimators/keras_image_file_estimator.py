"""``KerasImageFileEstimator``: fine-tune a saved Keras model over image files.

Port of ``sparkdl_tpu.estimators.keras_image_file_estimator`` for one card.
The same params (``imageLoader``, ``modelFile``, ``kerasOptimizer``,
``kerasLoss``, ``kerasFitParams``, ``checkpointDir``), plus ``device``, and
the same flow: collect (URI, label) rows, load the images through the
user's ``imageLoader``, train the model of ``modelFile`` one optimizer step
per batch, and return a
:class:`~sparkdl_tpu_torch.transformers.keras_image.KerasImageFileTransformer`
on the tuned ``.keras`` file. Without Keras: the file is read and built by
:mod:`sparkdl_tpu_torch.models.keras_model` (Keras's training semantics under
``train()``), trained by :mod:`sparkdl_tpu_torch.parallel.keras_train`, and
the tuned weights written back with ``write_keras_file``.

One card: ``batch_size`` is used as given (the JAX package rounds it to its
device mesh). ``checkpointDir`` and ``kerasFitParams["streaming"]`` are not
ported yet (ROADMAP.md item 7b) and raise before any row is read.
``fitMultiple`` (``ml/base.py``) gives one model per param map, for
``CrossValidator`` grids.
"""

from __future__ import annotations

import logging
import os
import tempfile
from typing import Any, Dict, Optional

import numpy as np
import torch

from sparkdl_tpu_torch.estimators.data import epoch_batches, labels_to_array, load_host_shard
from sparkdl_tpu_torch.estimators.losses import (
    get_loss_fn,
    get_optimizer,
    get_per_sample_loss_fn,
)
from sparkdl_tpu_torch.ml.base import Estimator
from sparkdl_tpu_torch.models.keras_model import KerasModel, read_keras_file, write_keras_file
from sparkdl_tpu_torch.param.base import Param, keyword_only
from sparkdl_tpu_torch.param.shared import (
    CanLoadImage,
    HasDevice,
    HasInputCol,
    HasKerasLoss,
    HasKerasModel,
    HasKerasOptimizer,
    HasLabelCol,
    HasOutputCol,
)
from sparkdl_tpu_torch.parallel.keras_train import (
    init_keras_train_state,
    make_keras_train_step,
)
from sparkdl_tpu_torch.transformers.keras_image import KerasImageFileTransformer
from sparkdl_tpu_torch.utils.device import resolve_device
from sparkdl_tpu_torch.utils.metrics import fit_step

logger = logging.getLogger(__name__)

_ITEM_7B = "ROADMAP.md item 7b"


class KerasImageFileEstimator(
    Estimator,
    HasInputCol,
    HasOutputCol,
    HasLabelCol,
    CanLoadImage,
    HasKerasModel,
    HasKerasOptimizer,
    HasKerasLoss,
    HasDevice,
):
    checkpointDir = Param(
        "undefined",
        "checkpointDir",
        "checkpoint directory for mid-training save/resume; not ported yet, "
        "must be None",
    )

    @keyword_only
    def __init__(
        self,
        inputCol: Optional[str] = None,
        outputCol: Optional[str] = None,
        labelCol: Optional[str] = None,
        imageLoader=None,
        modelFile: Optional[str] = None,
        kerasOptimizer: str = "adam",
        kerasLoss: Optional[str] = None,
        kerasFitParams: Optional[Dict[str, Any]] = None,
        checkpointDir: Optional[str] = None,
        device: Optional[str] = None,
    ):
        super().__init__()
        self._setDefault(
            kerasOptimizer="adam",
            kerasFitParams={"epochs": 1, "batch_size": 32},
            checkpointDir=None,
            device=None,
        )
        kwargs = self._input_kwargs
        self.setParams(**kwargs)

    @keyword_only
    def setParams(
        self,
        inputCol: Optional[str] = None,
        outputCol: Optional[str] = None,
        labelCol: Optional[str] = None,
        imageLoader=None,
        modelFile: Optional[str] = None,
        kerasOptimizer: str = "adam",
        kerasLoss: Optional[str] = None,
        kerasFitParams: Optional[Dict[str, Any]] = None,
        checkpointDir: Optional[str] = None,
        device: Optional[str] = None,
    ):
        kwargs = self._input_kwargs
        return self._set(**kwargs)

    def _validateParams(self):
        for p in (self.inputCol, self.labelCol, self.imageLoader,
                  self.modelFile, self.kerasLoss, self.outputCol):
            if not self.isDefined(p):
                raise ValueError(f"Required param not set: {p.name}")
        return True

    def _fit(self, dataset):
        self._validateParams()
        fit_params = dict(self.getKerasFitParams() or {})
        if self.getOrDefault(self.checkpointDir) is not None:
            raise NotImplementedError(
                f"checkpointDir is not ported to sparkdl_tpu_torch yet ({_ITEM_7B}: "
                "estimators/checkpointing.py); leave it None")
        if fit_params.get("streaming", False):
            raise NotImplementedError(
                f"kerasFitParams['streaming'] is not ported to sparkdl_tpu_torch yet "
                f"({_ITEM_7B}: StreamingShardLoader); leave it False")
        device = resolve_device(self.getDevice())

        x, labels = load_host_shard(
            dataset, self.getInputCol(), self.getLabelCol(), self.getImageLoader())
        y = labels_to_array(labels)
        epochs = int(fit_params.get("epochs", 1))
        # one card: no mesh to round the batch to
        batch_size = max(int(fit_params.get("batch_size", 32)), 1)
        seed = int(fit_params.get("seed", 0))

        config, weights = read_keras_file(self.getModelFile())
        module = KerasModel(config, weights).to(device)
        loss_spec = self.getKerasLoss()
        per_sample_loss = get_per_sample_loss_fn(loss_spec)
        weighted = per_sample_loss is not None
        loss_fn = per_sample_loss if weighted else get_loss_fn(loss_spec)
        tx = get_optimizer(self.getKerasOptimizer(), fit_params.get("learning_rate"))
        state = init_keras_train_state(module, tx)
        step_fn = make_keras_train_step(loss_fn, weighted=weighted)

        n = x.shape[0]
        if not weighted and n % batch_size:
            logger.warning(
                "custom loss without a per-sample form: ragged batches "
                "(%d rows, batch %d) train duplicate-padded rows at full "
                "weight, slightly over-weighting them; use a named loss for "
                "exact zero-weight padding",
                n,
                batch_size,
            )
        # the JAX package's draw for process 0 of one
        rng = np.random.RandomState((seed * 7919 + 0) % 2**32)
        sync = (lambda: torch.cuda.synchronize(device)) if device.type == "cuda" else None

        def place(batch):
            return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}

        step_losses = []
        last_loss = None
        for epoch in range(epochs):
            order = rng.permutation(n)
            losses = []
            for batch in epoch_batches(order, x, y, batch_size, weighted):
                with fit_step(sync):
                    state, loss = step_fn(state, place(batch))
                losses.append(loss)
            # one read of the losses per epoch, as the JAX loop's float(loss)
            step_losses += torch.stack(losses).tolist()
            last_loss = step_losses[-1]
            logger.info("epoch %d/%d loss=%.4f", epoch + 1, epochs, last_loss)

        state.opt_state.zero_grad(set_to_none=True)
        module.eval()
        tuned_path = os.path.join(tempfile.mkdtemp(prefix="sparkdl_tuned_"), "model.keras")
        write_keras_file(tuned_path, config, module.keras_weights())
        transformer = KerasImageFileTransformer(
            inputCol=self.getInputCol(),
            outputCol=self.getOutputCol(),
            modelFile=tuned_path,
            imageLoader=self.getImageLoader(),
            device=self.getDevice(),
        )
        transformer._training_loss = last_loss
        transformer._training_losses = step_losses
        return transformer
