"""The single-device training step of a Keras model.

Port of ``sparkdl_tpu.parallel.keras_train`` for one device. The JAX step
is a pure function of the model's trainable and non-trainable variables
(``stateless_call(..., training=True)`` returns the new batch-norm
statistics); here the :class:`~sparkdl_tpu_torch.models.keras_model.KerasModel`
holds its weights as parameters and its moving statistics as buffers, so the
step runs the module in ``train()`` and updates both in place. The optimizer
covers the trainable parameters only: a frozen layer's weights take no
gradient and no update, as they are ``non_trainable_variables`` in Keras.
The data-parallel step over several cards is ROADMAP.md item 12.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict

import torch

from sparkdl_tpu_torch.parallel.trainer import OptimizerFactory

Batch = Dict[str, torch.Tensor]


@dataclass
class KerasTrainState:
    """Everything a step mutates: the module (its trainable parameters and
    its moving statistics), the optimizer over the trainable parameters
    (``opt_state``) and the step count."""

    module: torch.nn.Module
    opt_state: torch.optim.Optimizer
    step: int = 0


def init_keras_train_state(module: torch.nn.Module, tx: OptimizerFactory) -> KerasTrainState:
    """``tx`` is a factory ``params -> Optimizer`` (``get_optimizer``'s),
    given the parameters that require a gradient."""
    trainable = [p for p in module.parameters() if p.requires_grad]
    return KerasTrainState(module=module, opt_state=tx(trainable), step=0)


def make_keras_train_step(
    loss_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    weighted: bool = False,
) -> Callable[[KerasTrainState, Batch], tuple]:
    """Build ``step(state, batch) -> (state, loss)`` over ``batch = {"x",
    "y"[, "w"]}``.

    With ``weighted=True``, ``loss_fn(y_true, y_pred)`` returns per-sample
    losses (``(batch,)``) and the step optimizes the exact weighted mean
    ``(per * w).sum() / w.sum()``: zero-weight rows (ragged-batch padding)
    add nothing to the loss or the gradient, though they pass through the
    forward, so the batch-norm statistics see them, as in the JAX step.
    Otherwise ``loss_fn`` returns the mean loss. Dropout masks come from
    torch's default generator (JAX's draws cannot be matched). The loss
    comes back as a device tensor: reading it synchronises, so callers read
    it rarely.
    """

    def step(state: KerasTrainState, batch: Batch):
        module = state.module
        module.train()
        state.opt_state.zero_grad(set_to_none=True)
        outputs = module(batch["x"])
        if weighted:
            w = batch["w"]
            loss = (loss_fn(batch["y"], outputs) * w).sum() / w.sum()
        else:
            loss = loss_fn(batch["y"], outputs)
        loss.backward()
        state.opt_state.step()
        state.step += 1
        return state, loss.detach()

    return step
