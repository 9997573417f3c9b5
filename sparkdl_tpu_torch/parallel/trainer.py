"""The training step, on one card or data-parallel across ranks.

Port of ``sparkdl_tpu.parallel.trainer``. The JAX step is a pure function
of the state, ``shard_map`` over a ``data`` mesh axis with ``psum`` of the
gradients; here the module holds the parameters and the ``torch.optim``
optimizer their moments, so :class:`TrainState` carries both and the step
updates them in place. Given a mesh (a ``DeviceMesh`` of the process group,
one card per rank), the step is data-parallel: each rank computes the
gradients of its own rows, and one all-reduce over the ``data`` axis (all
gradients and the loss flattened into one buffer) makes the update the same
on every rank.

Device slices are the JAX package's trial-parallel tuning: a thread bound
to a slice of the local cards (:func:`device_slice`,
:func:`bind_device_slice`) resolves ``device=None`` to its slice's card
(:func:`~sparkdl_tpu_torch.utils.device.resolve_device`), so concurrent
trials train on cards of their own. One process drives one card, so a slice
a thread can train on is one card.
"""

from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass
from typing import Callable, Dict, Iterable, List, Optional, Sequence

import torch
import torch.distributed as dist

from sparkdl_tpu_torch.utils.device import _DEVICE_SLICE

Batch = Dict[str, torch.Tensor]
OptimizerFactory = Callable[[Iterable[torch.nn.Parameter]], torch.optim.Optimizer]


def current_device_slice() -> Optional[List[torch.device]]:
    """The devices this thread is restricted to, or None (all local)."""
    return getattr(_DEVICE_SLICE, "devices", None)


@contextmanager
def device_slice(devices: Sequence):
    """Restrict this thread to ``devices`` for the scope."""
    prev = current_device_slice()
    _DEVICE_SLICE.devices = [torch.device(d) for d in devices]
    try:
        yield
    finally:
        _DEVICE_SLICE.devices = prev


def bind_device_slice(devices: Optional[Sequence]) -> None:
    """The unscoped :func:`device_slice`, for a pool thread's initializer
    (a ``ThreadPoolExecutor`` binds each worker thread once, for its life)."""
    _DEVICE_SLICE.devices = ([torch.device(d) for d in devices]
                             if devices is not None else None)


def local_devices() -> List[torch.device]:
    """Every card of this machine, in order."""
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def partition_devices(k: int, devices: Optional[Sequence] = None) -> List[List[torch.device]]:
    """Split ``devices`` (default: :func:`local_devices`) into ``k``
    disjoint, equal, contiguous slices. Raises when they do not divide
    evenly: a ragged split would give trials different widths and different
    batch math."""
    devices = [torch.device(d) for d in (devices if devices is not None else local_devices())]
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    n = len(devices)
    if n == 0 or n % k:
        raise ValueError(f"{n} devices do not partition into {k} equal slices")
    per = n // k
    return [devices[i * per:(i + 1) * per] for i in range(k)]


def make_mesh(
    n_devices: Optional[int] = None,
    axis_names: Sequence[str] = ("data",),
    axis_shape: Optional[Sequence[int]] = None,
    devices: Optional[Sequence] = None,
):
    """A ``DeviceMesh`` over the process group's ranks, one card each: one
    ``data`` axis (pure DP) by default, or e.g. ``axis_names=("data",
    "model"), axis_shape=(2, 2)`` for DP x TP. A mesh needs a group
    (:func:`~sparkdl_tpu_torch.parallel.runner.initialize`): one process
    drives one card. ``n_devices`` and ``devices``, when given, must match
    the group's size and this rank's card among them."""
    from sparkdl_tpu_torch.parallel import runner

    if not runner.is_initialized():
        raise RuntimeError("a mesh spans a process group, one card per rank: "
                           "call sparkdl_tpu_torch.parallel.runner.initialize() first")
    world = runner.process_count()
    if n_devices is not None and int(n_devices) != world:
        raise ValueError(f"n_devices={n_devices}, but the group has {world} ranks")
    devices = devices if devices is not None else current_device_slice()
    if devices is not None:
        devices = [torch.device(d) for d in devices]
        if len(devices) != world or runner.current_device() not in devices:
            raise ValueError(f"devices {devices} are not the group's {world} cards "
                             f"(this rank: {runner.current_device()})")
    return runner.make_global_mesh(axis_names, axis_shape)


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


def axis_group(mesh, axis: str = "data"):
    """The process group of ``mesh``'s ``axis``: a ``DeviceMesh``'s axis
    group, ``mesh`` itself when it is a process group, or ``None`` (every
    rank) for ``None``."""
    if mesh is None:
        return None
    if hasattr(mesh, "get_group"):
        return mesh.get_group(axis)
    return mesh


def all_reduce_grads(params: Iterable[torch.Tensor], loss: torch.Tensor, group,
                     average: bool) -> torch.Tensor:
    """Sum (or average) every gradient and ``loss`` over ``group`` in one
    collective: they are flattened into one float32 buffer, reduced and
    copied back. Returns the reduced loss. A ``DTensor`` gradient reduces
    its local shard."""
    grads = []
    for p in params:
        if p.grad is not None:
            g = p.grad
            grads.append(g.to_local() if hasattr(g, "to_local") else g)
    flat = torch.cat([g.reshape(-1).float() for g in grads] + [loss.detach().reshape(1).float()])
    dist.all_reduce(flat, group=group)
    if average:
        flat /= dist.get_world_size(group)
    offset = 0
    for g in grads:
        n = g.numel()
        g.copy_(flat[offset:offset + n].view_as(g))
        offset += n
    return flat[offset].to(loss.dtype)


def make_train_step(
    loss_fn: Callable[[torch.nn.Module, Batch], torch.Tensor],
    mesh=None,
    data_axis: str = "data",
    weighted: bool = True,
) -> Callable[[TrainState, Batch], tuple]:
    """Build ``step(state, batch) -> (state, loss)``.

    With ``weighted=True`` (what both estimators use), ``loss_fn(module,
    batch) -> (batch,)`` per-sample losses and ``batch`` carries a ``"w"``
    weight vector: the step optimizes the exact weighted mean ``(per *
    w).sum() / w.sum()``, so zero-weight rows (ragged-batch padding) add
    nothing to the loss or the gradient. Otherwise ``loss_fn`` returns the
    mean loss of the batch.

    ``mesh=None`` is one card. Given a ``DeviceMesh`` (or a process group),
    ``batch`` is this rank's rows and the step is data-parallel over
    ``data_axis``, as the JAX step: weighted, ``w_total`` is all-reduced
    first, each rank's loss is its share ``(per * w).sum() / w_total`` of
    the global weighted mean, and the loss and the gradients are summed;
    unweighted, the ranks' equal-sized shards make the average of their
    gradients and losses the global mean's. The loss comes back as a device
    tensor: reading it synchronises, so callers read it rarely.
    """
    group = axis_group(mesh, data_axis)

    def step(state: TrainState, batch: Batch):
        state.opt_state.zero_grad(set_to_none=True)
        if weighted:
            per = loss_fn(state.module, batch)
            w = batch["w"]
            w_total = w.sum()
            if mesh is not None:
                w_total = w_total.detach().clone()
                dist.all_reduce(w_total, group=group)
            loss = (per * w).sum() / w_total
        else:
            loss = loss_fn(state.module, batch)
        loss.backward()
        if mesh is not None:
            loss = all_reduce_grads(state.module.parameters(), loss, group,
                                    average=not weighted)
        state.opt_state.step()
        state.step += 1
        return state, loss.detach()

    return step


def shard_batch(batch: Batch, mesh, axis: str = "data") -> Batch:
    """This rank's rows of a global host batch: the contiguous slice
    ``[r * n / ranks, (r + 1) * n / ranks)`` of every leaf's leading
    dimension along ``axis`` (the JAX package's ``P("data")`` placement
    gives device r the same rows)."""
    group = axis_group(mesh, axis)
    ranks, r = dist.get_world_size(group), dist.get_rank(group)
    out = {}
    for name, x in batch.items():
        if x.shape[0] % ranks:
            raise ValueError(f"{name}: {x.shape[0]} rows do not split over {ranks} ranks")
        per = x.shape[0] // ranks
        out[name] = x[r * per:(r + 1) * per]
    return out
