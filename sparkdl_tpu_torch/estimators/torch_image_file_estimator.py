"""``TorchImageFileTransformer``: a ``torch.nn.Module`` over image files.

Port of ``FlaxImageFileTransformer`` (the fitted model that
``sparkdl_tpu.estimators.FlaxImageFileEstimator`` returns): a URI column goes
through the user's image loader, then batched forward passes on the device,
then one ``DenseVector`` per row. The estimator's ``fit`` and persistence
are not ported yet.
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch

from sparkdl_tpu_torch.ml.base import Transformer
from sparkdl_tpu_torch.ml.linalg import DenseVector
from sparkdl_tpu_torch.param.shared import CanLoadImage, HasInputCol, HasOutputCol
from sparkdl_tpu_torch.transformers.utils import (
    DEFAULT_BATCH_SIZE,
    make_loader_decode_plan,
    run_batched_rows,
)
from sparkdl_tpu_torch.utils.device import resolve_device


class TorchImageFileTransformer(
    Transformer, HasInputCol, HasOutputCol, CanLoadImage
):
    """Fitted model: user loader -> ``module(x, features_only=...)``.

    ``state_dict`` (when given) is loaded into ``module`` strictly at the
    first transform, and the module moves to ``device`` in eval mode: the
    transformer owns the module from then on. ``device=None`` is the card;
    without one it raises unless ``device="cpu"`` is passed.
    """

    def __init__(
        self,
        inputCol: str,
        outputCol: str,
        imageLoader,
        module: torch.nn.Module,
        state_dict: Optional[Mapping[str, torch.Tensor]] = None,
        batchSize: int = DEFAULT_BATCH_SIZE,
        features_only: bool = False,
        device=None,
    ):
        super().__init__()
        self._set(inputCol=inputCol, outputCol=outputCol,
                  imageLoader=imageLoader)
        self.module = module
        self.state_dict = state_dict
        self.batchSize = int(batchSize)
        self.features_only = bool(features_only)
        self.device = resolve_device(device)
        self._placed = False

    def _forward(self):
        module = self.module
        if not self._placed:
            if self.state_dict is not None:
                module.load_state_dict(self.state_dict, strict=True)
            module.to(self.device).eval()
            self._placed = True
        feats = self.features_only

        def forward(x: torch.Tensor) -> torch.Tensor:
            with torch.inference_mode():
                out = module(x, features_only=feats)
            if isinstance(out, (tuple, list)):
                # first-output semantics for multi-output modules
                out = out[0]
            return out

        return forward

    def _transform(self, dataset):
        input_col = self.getInputCol()
        output_col = self.getOutputCol()
        loader = self.getImageLoader()
        fn = self._forward()

        def process_partition(part):
            uris = part[input_col]
            out = dict(part)
            if not uris:
                out[output_col] = []
                return out
            # one fixed loader shape bound across chunks, as in the JAX port
            decode = make_loader_decode_plan(loader)
            result = run_batched_rows(
                fn, uris, decode, self.batchSize, device=self.device
            )
            flat = result.reshape(result.shape[0], -1).astype(np.float64)
            out[output_col] = [DenseVector(v) for v in flat]
            return out

        return dataset.mapPartitions(process_partition)
