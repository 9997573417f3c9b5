"""The single-device training step.

Port of ``sparkdl_tpu.parallel.trainer``'s ``TrainState``,
``init_train_state`` and ``make_train_step`` for one device. The JAX step is
a pure function of the state; here the module holds the parameters and the
``torch.optim`` optimizer holds their moments, so ``TrainState`` carries
both and the step updates them in place. The data-parallel step over several
cards (``shard_map`` with ``psum``) is not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Iterable

import torch

Batch = Dict[str, torch.Tensor]
OptimizerFactory = Callable[[Iterable[torch.nn.Parameter]], torch.optim.Optimizer]


@dataclass
class TrainState:
    """Everything a training step mutates: the module's parameters, the
    optimizer's state (``opt_state``, a ``torch.optim.Optimizer`` over
    them) and the step count."""

    module: torch.nn.Module
    opt_state: torch.optim.Optimizer
    step: int = 0


def init_train_state(module: torch.nn.Module, tx: OptimizerFactory) -> TrainState:
    """``tx`` is a factory ``params -> Optimizer`` (``get_optimizer``'s)."""
    return TrainState(module=module, opt_state=tx(module.parameters()), step=0)


def make_train_step(
    loss_fn: Callable[[torch.nn.Module, Batch], torch.Tensor],
) -> Callable[[TrainState, Batch], tuple]:
    """Build ``step(state, batch) -> (state, loss)``.

    ``loss_fn(module, batch) -> (batch,)`` per-sample losses, and ``batch``
    carries a ``"w"`` weight vector: the step optimizes the exact weighted
    mean ``(per * w).sum() / w.sum()`` (the JAX step with ``weighted=True``,
    the only form its estimator uses), so zero-weight rows (ragged-batch
    padding) contribute nothing to loss or gradient. The loss comes back as
    a device tensor: reading it synchronises, so callers read it rarely.
    """

    def step(state: TrainState, batch: Batch):
        state.opt_state.zero_grad(set_to_none=True)
        per = loss_fn(state.module, batch)
        w = batch["w"]
        loss = (per * w).sum() / w.sum()
        loss.backward()
        state.opt_state.step()
        state.step += 1
        return state, loss.detach()

    return step
