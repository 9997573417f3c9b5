"""``TorchImageFileEstimator``: fine-tune a ``torch.nn.Module`` over image files.

Port of ``sparkdl_tpu.estimators.FlaxImageFileEstimator`` and its fitted
``FlaxImageFileTransformer``. ``fit`` collects (URI, label) rows, loads the
images through the user's loader, trains a copy of the module one optimizer
step per batch (each epoch a seeded permutation, the ragged last batch
padded cyclically with zero-weight rows) and returns a
:class:`TorchImageFileTransformer`: a URI column goes through the loader,
then batched forward passes on the device, then one ``DenseVector`` per row.

With ``checkpointDir`` a fit saves every epoch (the module's
``state_dict``, the optimizer's and the step count) under a namespace of
its configuration, resumes from the latest committed epoch up to
``epochs`` and replays the restored epochs' permutation draws, so a
resumed or preempted-then-resumed fit equals an uninterrupted one bit for
bit wherever two uninterrupted fits agree: on the CPU, and on the card for
the flash ViT under the default algorithms (the flash kernels use no
atomics) (:mod:`~sparkdl_tpu_torch.estimators.checkpointing`,
:mod:`~sparkdl_tpu_torch.resilience`).

The fitted transformer saves and loads as the JAX package's does: its
module pickled (class and attributes; a custom ``attn_impl`` must be a
module-level callable) with its weights beside it, taken from the CPU, so a
saved stage loads on a machine without a card when ``device="cpu"`` is
passed to :meth:`TorchImageFileTransformer.load`.

A module computing in bfloat16 (``ViT(dtype=torch.bfloat16)``) fits as the
JAX estimator fits ``ViT(dtype=jnp.bfloat16)``: float32 parameters and
optimizer state, the forward in bfloat16, the per-sample losses and their
weighted mean in float32.

Not ported yet (ROADMAP.md): ``shardingRules`` / ``meshShape`` (the DP x TP
step, item 12) and several hosts or cards. Setting one of those params
raises.
"""

from __future__ import annotations

import copy
import hashlib
import json
import os
import pickle
from typing import Any, Dict, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from sparkdl_tpu_torch.estimators import checkpointing
from sparkdl_tpu_torch.estimators.data import epoch_batches, load_host_shard
from sparkdl_tpu_torch.estimators.losses import (
    get_optimizer,
    get_per_sample_loss_fn,
)
from sparkdl_tpu_torch.ml.base import Estimator, Transformer
from sparkdl_tpu_torch.ml.linalg import DenseVector
from sparkdl_tpu_torch.models.convert import vit_state_dict_from_flax
from sparkdl_tpu_torch.param.base import Param, keyword_only
from sparkdl_tpu_torch.param.shared import (
    CanLoadImage,
    HasInputCol,
    HasLabelCol,
    HasOutputCol,
)
from sparkdl_tpu_torch.parallel.trainer import (
    TrainState,
    init_train_state,
    make_train_step,
)
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

    _WEIGHTS_FILE = "torch_model.pt"

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

    # -- persistence: the module pickled without its weights, and the
    # weights as a CPU state_dict, in one torch.save file (the JAX
    # package's flax_model.pkl holds the Flax module and its variables)
    def _module_skeleton(self) -> torch.nn.Module:
        """A copy of the module whose parameters and persistent buffers are
        meta tensors (no bytes, no device): its class and attributes."""
        module = self.module
        persistent = set(module.state_dict())
        memo = {}
        for p in module.parameters():
            memo[id(p)] = torch.nn.Parameter(torch.empty_like(p, device="meta"),
                                             requires_grad=p.requires_grad)
        for name, b in module.named_buffers():
            memo[id(b)] = (torch.empty_like(b, device="meta") if name in persistent
                           else b.detach().to("cpu", copy=True))
        return copy.deepcopy(module, memo)

    def _check_save(self) -> None:
        """Raise before anything is written if the module does not pickle
        (a lambda or a nested function as ``attn_impl``)."""
        try:
            pickle.dumps(self._module_skeleton())
        except (pickle.PicklingError, TypeError, AttributeError) as exc:
            raise ValueError(
                f"cannot save {type(self).__name__}: its module "
                f"{type(self.module).__name__} does not pickle ({exc}); give it "
                "module-level callables (such as attn_impl)"
            ) from exc

    def _save_artifacts(self, path: str):
        if self.state_dict is not None and not self._placed:
            self.module.load_state_dict(self.state_dict, strict=True)
        weights = {k: v.detach().to("cpu", copy=True)
                   for k, v in self.module.state_dict().items()}
        torch.save({"module": self._module_skeleton(), "state_dict": weights},
                   os.path.join(path, self._WEIGHTS_FILE))
        return {"batchSize": self.batchSize, "features_only": self.features_only,
                "device": str(self.device)}

    @classmethod
    def _load_instance(cls, metadata, path: str, device=None):
        from sparkdl_tpu_torch.ml.util import _decode_param

        extra, params = metadata["extra"], metadata["params"]
        payload = torch.load(os.path.join(path, cls._WEIGHTS_FILE), weights_only=False)
        module = payload["module"]
        module.load_state_dict(payload["state_dict"], strict=True, assign=True)
        return cls(
            inputCol=_decode_param(params["inputCol"], path),
            outputCol=_decode_param(params["outputCol"], path),
            imageLoader=_decode_param(params["imageLoader"], path),
            module=module,
            batchSize=extra["batchSize"],
            features_only=extra["features_only"],
            device=extra["device"] if device is None else device,
        )

    @classmethod
    def load(cls, path: str, device=None):
        """A saved transformer, on the device it was saved with, or on
        ``device`` (``"cpu"`` loads a card's stage on a machine without
        one)."""
        from sparkdl_tpu_torch.ml.util import load_stage

        instance = load_stage(path, **({} if device is None else {"device": device}))
        if not isinstance(instance, cls):
            raise TypeError(f"Loaded {type(instance).__name__} from {path}, "
                            f"expected {cls.__name__}")
        return instance

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


def init_parameters(module: torch.nn.Module, seed: int) -> None:
    """Draw ``module``'s parameters from a ``torch.Generator`` seeded with
    ``seed``, with the distributions of the Flax ViT's initialisers: kernels
    lecun-normal (truncated at two deviations), biases and ``cls_token``
    zero, other vectors (LayerNorm scales) one, ``pos_embed`` normal(0.02).
    The values are not Flax's: ``jax.random`` draws other numbers."""
    gen = torch.Generator().manual_seed(int(seed) % 2**63)
    with torch.no_grad():
        for name, p in module.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "pos_embed":
                p.copy_(torch.randn(p.shape, generator=gen) * 0.02)
            elif leaf in ("bias", "cls_token"):
                p.zero_()
            elif p.dim() == 1:
                p.fill_(1.0)
            else:
                # variance_scaling(1, fan_in, truncated_normal): the
                # constant undoes the truncation's shrinkage of the variance
                std = (1.0 / p[0].numel()) ** 0.5 / 0.87962566103423978
                w = torch.empty(p.shape)
                torch.nn.init.trunc_normal_(
                    w, std=std, a=-2 * std, b=2 * std, generator=gen
                )
                p.copy_(w)


def _as_state_dict(variables) -> Dict[str, torch.Tensor]:
    """``initialVariables``: a torch ``state_dict`` as it is, else a Flax
    ViT tree through ``vit_state_dict_from_flax``."""
    if isinstance(variables, Mapping) and variables and all(
        isinstance(v, torch.Tensor) for v in variables.values()
    ):
        return dict(variables)
    return vit_state_dict_from_flax(variables)


class TorchImageFileEstimator(
    Estimator, HasInputCol, HasOutputCol, HasLabelCol, CanLoadImage
):
    """Fine-tune ``module`` (logits out, NHWC images in) on (URI, label)
    rows. The params and their defaults are ``FlaxImageFileEstimator``'s;
    ``optimizer`` is a name of :func:`get_optimizer` or a callable
    ``params -> torch.optim.Optimizer``. ``device=None`` is the card;
    without one it raises unless ``device="cpu"`` is passed.

    ``fit`` trains a deep copy of ``module``: the caller's module and its
    parameters are never changed. ``initialVariables`` is a Flax ViT tree
    or a torch ``state_dict``; ``None`` draws the parameters from ``seed``
    (see :func:`init_parameters`).
    """

    module = Param("undefined", "module", "torch.nn.Module to fine-tune")
    optimizer = Param("undefined", "optimizer", "optimizer name or factory")
    loss = Param("undefined", "loss", "loss name (per-example labels)")
    fitParams = Param(
        "undefined", "fitParams",
        "dict: epochs / batch_size / learning_rate / seed",
    )
    initialVariables = Param(
        "undefined", "initialVariables",
        "optional pretrained weights: a Flax ViT tree or a torch state_dict "
        "(None: drawn from the seed)",
    )
    shardingRules = Param(
        "undefined", "shardingRules",
        "tensor-parallel rules; not ported yet, must be None",
    )
    meshShape = Param(
        "undefined", "meshShape",
        "(dp, tp) device split; not ported yet, must be None",
    )
    checkpointDir = Param(
        "undefined", "checkpointDir",
        "checkpoint directory for save/resume (None disables checkpointing)",
    )

    #: params that must stay None, and the ROADMAP.md item that ports them
    _NOT_PORTED = {
        "shardingRules": "queue 1 item 12 (parallelism: the DP x TP step)",
        "meshShape": "queue 1 item 12 (parallelism: the DP x TP step)",
    }

    @keyword_only
    def __init__(
        self,
        inputCol: Optional[str] = None,
        outputCol: Optional[str] = None,
        labelCol: Optional[str] = None,
        imageLoader=None,
        module=None,
        optimizer="adam",
        loss: str = "sparse_categorical_crossentropy",
        fitParams: Optional[Dict[str, Any]] = None,
        initialVariables=None,
        shardingRules: Optional[Sequence] = None,
        meshShape: Optional[Sequence[int]] = None,
        checkpointDir: Optional[str] = None,
        device=None,
    ):
        super().__init__()
        self._setDefault(
            optimizer="adam",
            loss="sparse_categorical_crossentropy",
            fitParams={"epochs": 1, "batch_size": 32},
            initialVariables=None,
            shardingRules=None,
            meshShape=None,
            checkpointDir=None,
        )
        kwargs = dict(self._input_kwargs)
        self.device = resolve_device(kwargs.pop("device", None))
        self.setParams(**kwargs)

    @keyword_only
    def setParams(
        self,
        inputCol: Optional[str] = None,
        outputCol: Optional[str] = None,
        labelCol: Optional[str] = None,
        imageLoader=None,
        module=None,
        optimizer="adam",
        loss: str = "sparse_categorical_crossentropy",
        fitParams: Optional[Dict[str, Any]] = None,
        initialVariables=None,
        shardingRules: Optional[Sequence] = None,
        meshShape: Optional[Sequence[int]] = None,
        checkpointDir: Optional[str] = None,
    ):
        kwargs = self._input_kwargs
        return self._set(**kwargs)

    def _load_shard(self, dataset):
        x, labels = load_host_shard(
            dataset,
            self.getInputCol(),
            self.getLabelCol(),
            self.getImageLoader(),
        )
        raw = np.asarray(labels)
        if not np.issubdtype(raw.dtype, np.integer):
            as_int = raw.astype(np.int64)
            if not np.array_equal(raw, as_int):
                raise ValueError(
                    f"labelCol {self.getLabelCol()!r} holds non-integral "
                    f"values (dtype {raw.dtype}); this estimator trains "
                    "with integer class labels"
                )
        return x, raw.astype(np.int32)

    def _per_sample_loss(self):
        """``(module, batch) -> (batch,)`` per-sample losses, in float32
        whatever the module computes in (the weighted mean over them is
        never taken in bfloat16)."""
        loss_name = self.getOrDefault(self.loss)
        if loss_name == "sparse_categorical_crossentropy":
            # logits-space CE (the module emits logits, unlike the Keras
            # estimator's softmax outputs): optax's
            # softmax_cross_entropy_with_integer_labels
            def per_sample(module, batch):
                logits = module(batch["x"])
                return F.cross_entropy(
                    logits.float(), batch["y"].long(), reduction="none"
                )

            return per_sample
        per = get_per_sample_loss_fn(loss_name)
        if per is None:
            raise ValueError(
                f"loss {loss_name!r} has no per-sample form; use a named loss"
            )
        return lambda module, batch: per(batch["y"], module(batch["x"]).float())

    def _fit(self, dataset):
        for p in (self.inputCol, self.outputCol, self.labelCol,
                  self.imageLoader, self.module):
            if not self.isDefined(p):
                raise ValueError(f"Required param not set: {p.name}")
        for name, item in self._NOT_PORTED.items():
            if self.getOrDefault(name) is not None:
                raise NotImplementedError(
                    f"{name} is not ported to sparkdl_tpu_torch yet "
                    f"(ROADMAP.md {item}); leave it None"
                )

        device = self.device
        fit_params = dict(self.getOrDefault(self.fitParams) or {})
        epochs = int(fit_params.get("epochs", 1))
        batch_size = max(int(fit_params.get("batch_size", 32)), 1)
        lr = fit_params.get("learning_rate")
        seed = int(fit_params.get("seed", 0))

        x, y = self._load_shard(dataset)
        tx = get_optimizer(self.getOrDefault(self.optimizer), lr)
        per_sample = self._per_sample_loss()

        # a torch module holds its parameters: train a copy, so fit never
        # changes the caller's module (the counterpart of the JAX fit's
        # defensive copy of initialVariables)
        model = copy.deepcopy(self.getOrDefault(self.module))
        variables = self.getOrDefault(self.initialVariables)
        if variables is None:
            init_parameters(model, seed)
        else:
            model.load_state_dict(_as_state_dict(variables), strict=True)
        model.to(device).train()
        state = init_train_state(model, tx)
        step_fn = make_train_step(per_sample)

        ckpt_dir = self.getOrDefault(self.checkpointDir)
        # once per fit: the digest sums every initialVariables leaf
        namespace = self._ckpt_namespace() if ckpt_dir else None
        start_epoch = checkpointing.restore_latest(
            ckpt_dir, namespace, epochs,
            lambda payload: self._ckpt_restore(state, payload)) if ckpt_dir else 0

        def batches(order):
            # pad rows carry zero weight, so each update is the exact mean
            # over the real rows
            return epoch_batches(order, x, y, batch_size)

        state, step_losses = checkpointing.fit_epochs(
            state, step_fn, batches, x.shape[0], np.random.RandomState(seed % 2**32),
            start_epoch, epochs, device, ckpt_dir, namespace, self._ckpt_payload,
            estimator="TorchImageFileEstimator",
            steps_per_epoch=max(1, -(-x.shape[0] // batch_size)))
        last_loss = step_losses[-1] if step_losses else None

        state.opt_state.zero_grad(set_to_none=True)
        model.eval()
        transformer = TorchImageFileTransformer(
            inputCol=self.getInputCol(),
            outputCol=self.getOutputCol(),
            imageLoader=self.getImageLoader(),
            module=model,
            state_dict=model.state_dict(),
            device=device,
        )
        transformer._training_loss = last_loss
        transformer._training_losses = step_losses
        return transformer

    # ------------------------------------------------------------------
    # checkpoint / resume: the JAX estimator's contract (a namespace per
    # configuration without epochs, async commits, epoch-capped restore)
    # ------------------------------------------------------------------
    @staticmethod
    def _ckpt_payload(state: TrainState) -> Dict[str, Any]:
        return {
            "model": state.module.state_dict(),
            "optimizer": state.opt_state.state_dict(),
            "step": state.step,
        }

    def _ckpt_namespace(self) -> str:
        """A subdirectory per training configuration: the module (class,
        plain attributes, shapes; see ``checkpointing.stable_description``),
        the optimizer, the loss, the fitParams but ``epochs`` (a stopping
        point, not a trajectory parameter), the columns, and a digest of
        ``initialVariables`` (each ``state_dict`` entry's name, shape and
        float64 sum), so that fits from other starting weights never
        restore each other's state. Prefixed ``torch_fit_``: the JAX
        package's ``fit_`` namespaces in a shared directory are never read
        or overwritten."""
        stable = checkpointing.stable_description
        fit_params = {k: v for k, v in (self.getOrDefault(self.fitParams) or {}).items()
                      if k != "epochs"}
        variables = self.getOrDefault(self.initialVariables)
        if variables is None:
            vars_digest = "init"
        else:
            vars_digest = hashlib.sha256(json.dumps(
                [(name, list(t.shape), float(t.detach().to(torch.float64).sum()))
                 for name, t in sorted(_as_state_dict(variables).items())],
                sort_keys=True,
            ).encode()).hexdigest()[:16]
        payload = json.dumps(
            {
                "module": stable(self.getOrDefault(self.module)),
                "optimizer": stable(self.getOrDefault(self.optimizer)),
                "loss": stable(self.getOrDefault(self.loss)),
                "fitParams": sorted((str(k), stable(v)) for k, v in fit_params.items()),
                "initialVariables": vars_digest,
                "labelCol": self.getLabelCol(),
                "inputCol": self.getInputCol(),
            },
            sort_keys=True,
        )
        return "torch_fit_" + hashlib.sha256(payload.encode()).hexdigest()[:12]

    @staticmethod
    def _ckpt_restore(state: TrainState, payload: Dict[str, Any]) -> None:
        """Copy a payload of :meth:`_ckpt_payload` into ``state``."""
        state.module.load_state_dict(payload["model"], strict=True)
        state.opt_state.load_state_dict(payload["optimizer"])
        state.step = int(payload["step"])
