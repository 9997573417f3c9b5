"""The single-device training step of a Keras model.

Port of ``sparkdl_tpu.parallel.keras_train`` for one device. The JAX step
is a pure function of the model's trainable and non-trainable variables
(``stateless_call(..., training=True)`` returns the new batch-norm
statistics); here the :class:`~sparkdl_tpu_torch.models.keras_model.KerasModel`
holds its weights as parameters and its moving statistics as buffers, so the
step runs the module in ``train()`` and updates both in place. The optimizer
covers the trainable parameters only: a frozen layer's weights take no
gradient and no update, as they are ``non_trainable_variables`` in Keras.
Dropout draws its masks from the state's own ``torch.Generator``, seeded by
the fit, the counterpart of the Keras ``SeedGenerator`` state that the JAX
step carries among the non-trainable variables: its state is checkpointed
with the weights, so a resumed fit draws the masks an uninterrupted one
draws. The data-parallel step over several cards is ROADMAP.md item 12.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional

import torch

from sparkdl_tpu_torch.parallel.trainer import OptimizerFactory

Batch = Dict[str, torch.Tensor]


@dataclass
class KerasTrainState:
    """Everything a step mutates: the module (its trainable parameters and
    its moving statistics), the optimizer over the trainable parameters
    (``opt_state``), the step count and the generator of the Dropout
    masks."""

    module: torch.nn.Module
    opt_state: torch.optim.Optimizer
    step: int = 0
    generator: Optional[torch.Generator] = None


def init_keras_train_state(module: torch.nn.Module, tx: OptimizerFactory,
                           seed: int = 0) -> KerasTrainState:
    """``tx`` is a factory ``params -> Optimizer`` (``get_optimizer``'s),
    given the parameters that require a gradient. The Dropout generator
    lies on the module's device, seeded with ``seed``."""
    trainable = [p for p in module.parameters() if p.requires_grad]
    first = next(iter([*module.parameters(), *module.buffers()]), None)
    device = first.device if first is not None else torch.device("cpu")
    generator = torch.Generator(device=device).manual_seed(int(seed) % 2**63)
    return KerasTrainState(module=module, opt_state=tx(trainable), step=0, generator=generator)


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
    ``state.generator`` (JAX's draws cannot be matched). The loss
    comes back as a device tensor: reading it synchronises, so callers read
    it rarely.
    """

    def step(state: KerasTrainState, batch: Batch):
        module = state.module
        module.train()
        state.opt_state.zero_grad(set_to_none=True)
        outputs = module(batch["x"], generator=state.generator)
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
