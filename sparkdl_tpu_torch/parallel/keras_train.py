"""The training step of a Keras model, on one card or data-parallel.

Port of ``sparkdl_tpu.parallel.keras_train``. The JAX step
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
draws.

Given a mesh (a ``DeviceMesh`` of the process group, one card per rank),
the step is data-parallel, as the JAX step over its ``data`` axis: each
rank's batch norm normalizes with its own batch's statistics, the
gradients (and the loss) are summed, for the exact global weighted mean,
or averaged, and after the update each floating-point buffer (batch norm's
moving statistics) is averaged over the ranks, as the JAX step's ``pmean``
of the non-trainable variables; other buffers pass through.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional

import torch

import torch.distributed as dist

from sparkdl_tpu_torch.parallel.trainer import OptimizerFactory, all_reduce_grads, axis_group

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
    mesh=None,
    data_axis: str = "data",
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
    it rarely. ``mesh`` makes the step data-parallel (module docstring);
    ``batch`` is then this rank's rows.
    """
    group = axis_group(mesh, data_axis)

    def step(state: KerasTrainState, batch: Batch):
        module = state.module
        module.train()
        state.opt_state.zero_grad(set_to_none=True)
        outputs = module(batch["x"], generator=state.generator)
        if weighted:
            w = batch["w"]
            w_total = w.sum()
            if mesh is not None:
                w_total = w_total.detach().clone()
                dist.all_reduce(w_total, group=group)
            loss = (loss_fn(batch["y"], outputs) * w).sum() / w_total
        else:
            loss = loss_fn(batch["y"], outputs)
        loss.backward()
        if mesh is not None:
            trainable = [p for p in module.parameters() if p.requires_grad]
            loss = all_reduce_grads(trainable, loss, group, average=not weighted)
        state.opt_state.step()
        if mesh is not None:
            stats = [b for b in module.buffers() if b.is_floating_point()]
            if stats:
                flat = torch.cat([b.reshape(-1).float() for b in stats])
                dist.all_reduce(flat, group=group)
                flat /= dist.get_world_size(group)
                offset = 0
                with torch.no_grad():
                    for b in stats:
                        b.copy_(flat[offset:offset + b.numel()].view_as(b))
                        offset += b.numel()
        state.step += 1
        return state, loss.detach()

    return step
