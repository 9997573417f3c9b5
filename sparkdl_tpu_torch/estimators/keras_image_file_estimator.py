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
device mesh). ``kerasFitParams["streaming"]`` keeps only the URIs in memory
and loads each batch as the epoch reaches it
(:class:`~sparkdl_tpu_torch.estimators.data.StreamingShardLoader`), with
the in-memory fit's batches. ``checkpointDir`` saves every epoch (the
trainable parameters, the moving statistics, the optimizer's state, the
step count and the Dropout generator's state) under a ``torch_fit_``
namespace whose hash is the JAX estimator's, resumes from the latest
committed epoch up to ``epochs`` and replays the permutation draws, so a
resumed or preempted-then-resumed fit equals an uninterrupted one bit for
bit wherever two uninterrupted fits agree. On the CPU they do; on a card a
model with convolutions does only under
``torch.use_deterministic_algorithms(True)``, since cuDNN's default
weight-gradient algorithms part two plain fits. The estimator leaves that
mode to the caller. ``fitMultiple`` (``ml/base.py``) gives one model per param map, for
``CrossValidator`` grids.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import tempfile
from typing import Any, Dict, Optional

import numpy as np
import torch

from sparkdl_tpu_torch.estimators import checkpointing
from sparkdl_tpu_torch.estimators.data import (
    StreamingShardLoader,
    collect_host_shard_rows,
    epoch_batches,
    labels_to_array,
    load_host_shard,
)
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
    KerasTrainState,
    init_keras_train_state,
    make_keras_train_step,
)
from sparkdl_tpu_torch.transformers.keras_image import KerasImageFileTransformer
from sparkdl_tpu_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)


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
        "checkpoint directory for mid-training save/resume "
        "(None disables checkpointing)",
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
        device = resolve_device(self.getDevice())
        # streaming=True: only the URIs in memory, each batch loaded as the
        # epoch reaches it; the batches are the in-memory path's
        streaming = bool(fit_params.get("streaming", False))
        if streaming:
            uris, labels = collect_host_shard_rows(
                dataset, self.getInputCol(), self.getLabelCol())
            x, n = None, len(uris)
        else:
            x, labels = load_host_shard(
                dataset, self.getInputCol(), self.getLabelCol(), self.getImageLoader())
            n = x.shape[0]
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
        state = init_keras_train_state(module, tx, seed=seed)
        step_fn = make_keras_train_step(loss_fn, weighted=weighted)

        ckpt_dir = self.getOrDefault(self.checkpointDir)
        namespace = self._ckpt_namespace() if ckpt_dir else None
        # the latest committed epoch up to the requested stopping point:
        # fit(epochs=2) after a fit(epochs=4) returns the epoch-2 weights
        start_epoch = checkpointing.restore_latest(
            ckpt_dir, namespace, epochs,
            lambda payload: self._ckpt_restore(state, payload)) if ckpt_dir else 0

        if not weighted and n % batch_size:
            logger.warning(
                "custom loss without a per-sample form: ragged batches "
                "(%d rows, batch %d) train duplicate-padded rows at full "
                "weight, slightly over-weighting them; use a named loss for "
                "exact zero-weight padding",
                n,
                batch_size,
            )
        if streaming:
            batches = StreamingShardLoader(
                uris, y, self.getImageLoader(), batch_size, weighted).epoch
        else:
            def batches(order):
                return epoch_batches(order, x, y, batch_size, weighted)
        # the JAX package's draw for process 0 of one
        rng = np.random.RandomState((seed * 7919 + 0) % 2**32)
        state, step_losses = checkpointing.fit_epochs(
            state, step_fn, batches, n, rng, start_epoch, epochs, device,
            ckpt_dir, namespace, self._ckpt_payload, estimator="KerasImageFileEstimator",
            steps_per_epoch=max(1, -(-n // batch_size)))
        last_loss = step_losses[-1] if step_losses else None

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

    # ------------------------------------------------------------------
    # checkpoint / resume: the JAX estimator's contract
    # ------------------------------------------------------------------
    @staticmethod
    def _ckpt_payload(state: KerasTrainState) -> Dict[str, Any]:
        module = state.module
        return {
            "trainable": {n: p for n, p in module.named_parameters() if p.requires_grad},
            "buffers": dict(module.named_buffers()),
            "optimizer": state.opt_state.state_dict(),
            "step": state.step,
            "generator": state.generator.get_state(),
        }

    def _ckpt_namespace(self) -> str:
        """A subdirectory per training configuration, so that fits of other
        param maps (``fitMultiple``, ``CrossValidator`` grids) or unrelated
        runs sharing one ``checkpointDir`` never restore each other's state,
        while a re-run of the same configuration resumes. The hash is the
        JAX estimator's, over the same description (the model file's
        absolute path, the optimizer, the loss, the fitParams but
        ``streaming``, which gives the same batches, and ``epochs``, a
        stopping point, and the columns); the prefix is ``torch_fit_``, so
        the two packages never read or overwrite each other's checkpoints in
        one directory."""
        fit_params = {k: v for k, v in (self.getKerasFitParams() or {}).items()
                      if k not in ("streaming", "epochs")}
        stable = checkpointing.stable_description
        payload = json.dumps(
            {
                "modelFile": os.path.abspath(str(self.getModelFile())),
                "optimizer": stable(self.getKerasOptimizer()),
                "loss": stable(self.getKerasLoss()),
                "fitParams": sorted((str(k), stable(v)) for k, v in fit_params.items()),
                "labelCol": self.getLabelCol(),
                "inputCol": self.getInputCol(),
            },
            sort_keys=True,
        )
        return "torch_fit_" + hashlib.sha256(payload.encode()).hexdigest()[:12]

    @staticmethod
    def _ckpt_restore(state: KerasTrainState, payload: Dict[str, Any]) -> None:
        """Copy a payload of :meth:`_ckpt_payload` into ``state``."""
        module = state.module
        live = {**{n: p for n, p in module.named_parameters() if p.requires_grad},
                **dict(module.named_buffers())}
        saved = {**payload["trainable"], **payload["buffers"]}
        if set(saved) != set(live):
            raise KeyError(f"tensors {sorted(set(saved) ^ set(live))[:5]}")
        with torch.no_grad():
            for name, tensor in live.items():
                tensor.copy_(saved[name])
        state.opt_state.load_state_dict(payload["optimizer"])
        state.step = int(payload["step"])
        state.generator.set_state(payload["generator"])
