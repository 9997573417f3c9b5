"""Tensor parallelism: rule-based parameter placement and the DP x TP step.

Port of ``sparkdl_tpu.parallel.tp``. The JAX package annotates parameters
with ``PartitionSpec`` rules and lets GSPMD insert the collectives; here the
rules give each parameter its ``DTensor`` placement on the ``model`` axis of
a ``(data, model)`` ``DeviceMesh`` (one card per rank), and the Megatron
layout is ``torch.distributed.tensor.parallel``'s:

- ``qkv`` / ``mlp_up``: the output features split over ``model`` (column
  parallel, :class:`ColwiseParallel`): activations stay split per head or
  neuron;
- ``proj`` / ``mlp_down``: the input features split (row parallel,
  :class:`RowwiseParallel`): one all-reduce per block restores the residual;
- everything else replicated.

**qkv is split by head group.** The port's ViT computes ``q``, ``k`` and
``v`` from one fused ``Dense(dim, 3 * dim)`` and splits its output in three
(``models/vit.py``). GSPMD keeps the JAX package's column split of the
fused kernel correct; a contiguous ``DTensor`` shard would hand a rank a
slice of ``[q | k | v]``, not its heads' q, k and v. So the fused columns
are split as ``(3, heads)`` on heads (:class:`Split` with ``groups=3``):
at placement each rank's q, k and v rows are moved together, the shard is
contiguous, and each rank attends with its own heads (its blocks' ``heads``
and ``dim`` become the rank's share). Checkpoints, ``initialVariables`` and
the fitted stage keep the unsharded layout: :func:`gather_state_dict` and
:func:`gather_payload` undo the move; :func:`restore_payload` redoes it.

The step (:func:`make_tp_train_step`) is written as if on one card; the
layers' collectives run over ``model``, and one all-reduce of every
gradient over ``data`` makes the update the same on every rank.
"""

from __future__ import annotations

import copy
import re
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from sparkdl_tpu_torch.parallel.trainer import (
    Batch,
    OptimizerFactory,
    TrainState,
    all_reduce_grads,
    axis_group,
)


@dataclass(frozen=True)
class Split:
    """A parameter split over one mesh axis along ``dim``. ``groups > 1``
    is a fused projection of ``groups`` equal parts (``qkv``: 3): each part
    is split in turn, and a rank's shard holds its slice of every part."""

    dim: int
    groups: int = 1


#: a parameter's spec: the mesh axis it is split over and how; empty is
#: replicated
Spec = Dict[str, Split]

#: (path regex, spec function) rules for the port's ViT encoder, the Megatron
#: column/row layout over the ``model`` axis. Paths are ``/``-joined
#: ``state_dict`` names (``blocks/0/qkv/weight``); a torch ``Linear`` keeps
#: its weight as (out, in), so column parallel splits dim 0.
VIT_TP_RULES: List[Tuple[str, Callable[[str], Spec]]] = [
    (r".*/qkv/(weight|bias)$", lambda axis: {axis: Split(0, groups=3)}),
    (r".*/mlp_up/(weight|bias)$", lambda axis: {axis: Split(0)}),
    (r".*/(proj|mlp_down)/weight$", lambda axis: {axis: Split(1)}),
]


def param_path_specs(
    params: Any,
    rules: Sequence[Tuple[str, Callable[[str], Spec]]],
    model_axis: str = "model",
) -> Dict[str, Spec]:
    """Each parameter's spec, from the first rule whose pattern matches its
    ``/``-joined path (none, or a rule whose function is ``None``:
    replicated). ``params`` is a module or a ``state_dict``."""
    names = (dict(params.named_parameters()) if isinstance(params, torch.nn.Module)
             else params)
    specs: Dict[str, Spec] = {}
    for name in names:
        path = name.replace(".", "/")
        build = next((b for pattern, b in rules if re.match(pattern, path)), None)
        specs[name] = (build(model_axis) if build is not None else None) or {}
    return specs


def _grouped(x: torch.Tensor, split: Split, shards: int) -> torch.Tensor:
    """The unsharded layout -> each shard's slice of every group together
    (a no-op for ``groups == 1``)."""
    if split.groups == 1:
        return x
    moved = x.movedim(split.dim, 0)
    g = split.groups
    out = moved.reshape(g, shards, moved.shape[0] // (g * shards), *moved.shape[1:])
    return out.transpose(0, 1).reshape(moved.shape).movedim(0, split.dim)


def _ungrouped(x: torch.Tensor, split: Split, shards: int) -> torch.Tensor:
    """The inverse of :func:`_grouped`."""
    if split.groups == 1:
        return x
    moved = x.movedim(split.dim, 0)
    g = split.groups
    out = moved.reshape(shards, g, moved.shape[0] // (g * shards), *moved.shape[1:])
    return out.transpose(0, 1).reshape(moved.shape).movedim(0, split.dim)


def _model_split(spec: Spec, model_axis: str) -> Optional[Split]:
    return spec.get(model_axis)


def shard_params(module: torch.nn.Module, mesh, specs: Mapping[str, Spec],
                 model_axis: str = "model") -> torch.nn.Module:
    """Place ``module``'s parameters on ``mesh`` per their specs, in place:
    each ``Linear`` whose weight is split on dim 0 becomes column parallel,
    on dim 1 row parallel, over ``mesh[model_axis]`` (fused groups moved
    first); the rest stay replicated. A module with ``heads`` and ``dim``
    (an encoder block) whose ``qkv`` is split attends with its share of the
    heads. Raises when a split does not divide."""
    from torch.distributed.tensor.parallel import (
        ColwiseParallel,
        RowwiseParallel,
        parallelize_module,
    )

    shards = mesh[model_axis].size()
    plan = {}
    with torch.no_grad():
        for name, sub in module.named_modules():
            if not isinstance(sub, torch.nn.Linear):
                continue
            split = _model_split(specs.get(f"{name}.weight", {}), model_axis)
            if split is None:
                continue
            bias_split = _model_split(specs.get(f"{name}.bias", {}), model_axis)
            column = split.dim == 0
            if (column and sub.bias is not None and bias_split != split) or \
                    (not column and bias_split is not None):
                raise ValueError(f"{name}: the bias spec {bias_split} does not go with a "
                                 f"{'column' if column else 'row'}-parallel weight")
            if sub.weight.shape[split.dim] % (split.groups * shards):
                raise ValueError(f"{name}.weight: dim {split.dim} of {tuple(sub.weight.shape)} "
                                 f"does not split into {split.groups} x {shards}")
            sub.weight.copy_(_grouped(sub.weight, split, shards))
            if column and sub.bias is not None:
                sub.bias.copy_(_grouped(sub.bias, split, shards))
            plan[name] = ColwiseParallel() if column else RowwiseParallel()
        for name, sub in module.named_modules():
            if f"{name}.qkv" in plan and hasattr(sub, "heads") and hasattr(sub, "dim"):
                if sub.heads % shards:
                    raise ValueError(f"{name}: {sub.heads} heads do not split over "
                                     f"{shards} ranks")
                sub.heads //= shards
                sub.dim //= shards
    parallelize_module(module, mesh[model_axis], plan)
    return module


def _shards(t: torch.Tensor) -> int:
    """The ranks a parameter-shaped tensor is split over (1: a plain one)."""
    return t.device_mesh.size() if hasattr(t, "device_mesh") else 1


def _full(t: torch.Tensor, split: Optional[Split]) -> torch.Tensor:
    """A parameter-shaped tensor (a DTensor shard or a replicated tensor)
    as the unsharded value, on the CPU."""
    shards = _shards(t)
    if hasattr(t, "full_tensor"):
        t = t.full_tensor()
    if split is not None:
        t = _ungrouped(t, split, shards)
    return t.detach().to("cpu", copy=True)


def gather_state_dict(module: torch.nn.Module, specs: Mapping[str, Spec],
                      model_axis: str = "model") -> Dict[str, torch.Tensor]:
    """``module``'s ``state_dict`` in the unsharded layout, on the CPU
    (a collective: every rank of the model axis calls it)."""
    return {name: _full(t, _model_split(specs.get(name, {}), model_axis))
            for name, t in module.state_dict().items()}


def unsharded_copy(template: torch.nn.Module, module: torch.nn.Module,
                   specs: Mapping[str, Spec], model_axis: str = "model") -> torch.nn.Module:
    """A copy of ``template`` (the module before :func:`shard_params`)
    holding ``module``'s trained weights in the unsharded layout."""
    out = copy.deepcopy(template)
    out.load_state_dict(gather_state_dict(module, specs, model_axis), strict=True)
    return out


def _param_names(state: TrainState) -> List[str]:
    """Each optimizer-state index's parameter name (the optimizer numbers
    the parameters of its groups in turn)."""
    names = {id(p): name for name, p in state.module.named_parameters()}
    return [names[id(p)] for group in state.opt_state.param_groups for p in group["params"]]


def gather_payload(state: TrainState, specs: Mapping[str, Spec],
                   model_axis: str = "model") -> Dict[str, Any]:
    """A checkpoint payload in a one-card fit's layout: the module's
    weights unsharded, the optimizer's state with each parameter-shaped
    entry gathered, in one parameter group numbered in the module's
    parameter order, and the step. A collective."""
    order = _param_names(state)
    named = [name for name, _ in state.module.named_parameters()]
    position = {name: i for i, name in enumerate(named)}
    opt = state.opt_state.state_dict()
    gathered = {}
    for idx, entry in opt["state"].items():
        name = order[idx]
        split = _model_split(specs.get(name, {}), model_axis)
        gathered[position[name]] = {
            key: (_full(v, split) if isinstance(v, torch.Tensor) and v.dim() else
                  (v.detach().to("cpu", copy=True) if isinstance(v, torch.Tensor) else v))
            for key, v in entry.items()}
    group = {k: v for k, v in opt["param_groups"][0].items() if k != "params"}
    group["params"] = list(range(len(named)))
    return {"model": gather_state_dict(state.module, specs, model_axis),
            "optimizer": {"state": gathered, "param_groups": [group]},
            "step": state.step}


def restore_payload(state: TrainState, payload: Mapping[str, Any], specs: Mapping[str, Spec],
                    model_axis: str = "model") -> None:
    """Copy a payload in a one-card fit's layout (:func:`gather_payload`'s,
    or a one-card fit's own) into a sharded ``state``."""
    from torch.distributed.tensor import distribute_tensor

    params = dict(state.module.named_parameters())
    live = state.module.state_dict()

    def place(full: torch.Tensor, like: torch.Tensor, split: Optional[Split]):
        if split is not None:
            full = _grouped(full, split, _shards(like))
        full = full.to(like.device, like.dtype)
        if hasattr(like, "device_mesh"):
            return distribute_tensor(full, like.device_mesh, like.placements)
        return full

    model = payload["model"]
    if set(model) != set(live):
        raise KeyError(f"tensors {sorted(set(model) ^ set(live))[:5]}")
    with torch.no_grad():
        for name, like in live.items():
            like.copy_(place(model[name], like, _model_split(specs.get(name, {}), model_axis)))
    named = [name for name, _ in state.module.named_parameters()]
    index = {name: i for i, name in enumerate(_param_names(state))}
    opt = payload["optimizer"]
    if len(opt["param_groups"]) != 1:
        raise ValueError(f"a payload of {len(opt['param_groups'])} parameter groups; "
                         "expected one, in the module's parameter order")
    saved = {k: v for k, v in opt["param_groups"][0].items() if k != "params"}
    groups = [dict(saved, params=g["params"])
              for g in state.opt_state.state_dict()["param_groups"]]
    placed_state = {}
    for idx, entry in opt["state"].items():
        name = named[int(idx)]
        split = _model_split(specs.get(name, {}), model_axis)
        placed_state[index[name]] = {
            key: (place(v, params[name], split) if isinstance(v, torch.Tensor) and v.dim()
                  else v) for key, v in entry.items()}
    state.opt_state.load_state_dict({"state": placed_state, "param_groups": groups})
    state.step = int(payload["step"])


def init_tp_train_state(module: torch.nn.Module, tx: OptimizerFactory, mesh,
                        param_specs: Mapping[str, Spec], model_axis: str = "model") -> TrainState:
    """Shard the parameters per their specs, then build the optimizer over
    the sharded parameters, so its moments take the same layout. The
    ``DTensor`` parameters and the plain ones are two parameter groups: an
    optimizer's multi-tensor update (the default on a card) takes one kind
    at a time."""
    shard_params(module, mesh, param_specs, model_axis)
    params = list(module.parameters())
    groups = [{"params": [p for p in params if hasattr(p, "device_mesh")]},
              {"params": [p for p in params if not hasattr(p, "device_mesh")]}]
    return TrainState(module=module, opt_state=tx([g for g in groups if g["params"]]), step=0)


def make_tp_train_step(
    loss_fn: Callable[[torch.nn.Module, Batch], torch.Tensor],
    mesh,
    param_specs: Mapping[str, Spec],
    data_axis: str = "data",
) -> Callable[[TrainState, Batch], tuple]:
    """The DP x TP step: ``loss_fn(module, batch) -> (batch,)`` per-sample
    losses, ``batch`` this data shard's rows (the same on every rank of its
    model group) with a ``"w"`` weight vector. The step optimizes the exact
    global weighted mean: ``w_total`` is all-reduced over ``data_axis``,
    each shard's loss is its share, the layers' collectives run over
    ``model``, and the loss and every gradient are summed over ``data_axis``
    (a ``DTensor`` gradient its shard)."""
    del param_specs  # the placements ride on the sharded parameters
    group = axis_group(mesh, data_axis)

    def step(state: TrainState, batch: Batch):
        state.opt_state.zero_grad(set_to_none=True)
        per = loss_fn(state.module, batch)
        w = batch["w"]
        w_total = w.sum().detach().clone()
        dist.all_reduce(w_total, group=group)
        loss = (per * w).sum() / w_total
        loss.backward()
        loss = all_reduce_grads(state.module.parameters(), loss, group, average=False)
        state.opt_state.step()
        state.step += 1
        return state, loss.detach()

    return step
