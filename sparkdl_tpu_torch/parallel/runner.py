"""The multi-process runner: ``torch.distributed`` as control and data plane.

Port of ``sparkdl_tpu.parallel.runner``, with ``jax.distributed`` replaced
by a ``torch.distributed`` process group. One process drives one card (one
rank per card), so what the JAX package calls a host is a rank here:

- **control plane**: :func:`initialize` joins the group at a coordinator
  address (``tcp://host:port``, where process 0 listens); NCCL when the
  rank's device is a card, gloo only when the caller asks for the CPU;
- **collectives**: NCCL (or gloo) all-reduces, all-to-alls and P2P sends,
  issued by the steps of :mod:`~sparkdl_tpu_torch.parallel.trainer`,
  :mod:`~sparkdl_tpu_torch.parallel.tp` and
  :mod:`~sparkdl_tpu_torch.parallel.context`;
- **data plane**: each rank loads only its own strided shard of the rows
  (:func:`host_shard_indices`) and places it on its own card.

The CPU tests run the same code in gloo groups of 2 and 4 processes.
"""

from __future__ import annotations

import datetime
import logging
import os
import socket
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

logger = logging.getLogger(__name__)

ENV_COORDINATOR = "SPARKDL_COORDINATOR"
ENV_NUM_PROCS = "SPARKDL_NUM_PROCS"
ENV_PROC_ID = "SPARKDL_PROC_ID"

#: the rank's device, set by :func:`initialize`
_DEVICE: Optional[torch.device] = None


def _free_local_address() -> str:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return f"127.0.0.1:{s.getsockname()[1]}"


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device=None,
    timeout_s: float = 600.0,
) -> torch.device:
    """Join the process group (idempotent); returns this rank's device.

    The arguments default to ``SPARKDL_COORDINATOR`` (``host:port`` of
    process 0), ``SPARKDL_NUM_PROCS`` and ``SPARKDL_PROC_ID``; a group of
    one needs no address (a free local port is taken). ``device=None`` is
    the card ``cuda:<process_id % cards>`` and the backend NCCL; without a
    card it raises. Only ``device="cpu"`` takes gloo: there is no quiet
    fallback from one backend to the other.
    """
    global _DEVICE
    if dist.is_initialized():
        return current_device()
    coordinator_address = coordinator_address or os.environ.get(ENV_COORDINATOR)
    if num_processes is None:
        num_processes = int(os.environ.get(ENV_NUM_PROCS, "1"))
    if process_id is None:
        process_id = int(os.environ.get(ENV_PROC_ID, "0"))
    if coordinator_address is None:
        if num_processes != 1:
            raise ValueError(
                f"a group of {num_processes} processes needs a coordinator address "
                f"(coordinator_address= or {ENV_COORDINATOR})")
        coordinator_address = _free_local_address()
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
        device = torch.device("cuda", process_id % torch.cuda.device_count())
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
        if device.index is None:
            device = torch.device("cuda", process_id % torch.cuda.device_count())
        torch.cuda.set_device(device)
        backend = "nccl"
    elif device.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"unsupported device {device}: use 'cuda' or 'cpu'")
    dist.init_process_group(
        backend,
        init_method=f"tcp://{coordinator_address}",
        world_size=int(num_processes),
        rank=int(process_id),
        timeout=datetime.timedelta(seconds=timeout_s),
        **({"device_id": device} if backend == "nccl" else {}),
    )
    _DEVICE = device
    logger.info("process group up: rank %d/%d on %s (%s)", dist.get_rank(),
                dist.get_world_size(), device, backend)
    return device


def shutdown() -> None:
    """Leave the process group (a no-op without one)."""
    global _DEVICE
    if dist.is_initialized():
        dist.destroy_process_group()
    _DEVICE = None


def is_initialized() -> bool:
    """True inside a process group, a group of one included."""
    return dist.is_initialized()


def is_distributed() -> bool:
    """True when more than one process takes part."""
    return dist.is_initialized() and dist.get_world_size() > 1


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def current_device() -> torch.device:
    """This rank's device (``initialize``'s)."""
    if _DEVICE is None:
        raise RuntimeError("no process group: call runner.initialize() first")
    return _DEVICE


def make_global_mesh(
    axis_names: Sequence[str] = ("data",),
    axis_shape: Optional[Sequence[int]] = None,
):
    """A ``DeviceMesh`` over every rank of the group, one card each, ranks
    in order (a pure ``data`` axis by default)."""
    from torch.distributed.device_mesh import DeviceMesh

    world = process_count()
    if axis_shape is None:
        axis_shape = (world,) + (1,) * (len(axis_names) - 1)
    if int(np.prod(axis_shape)) != world:
        raise ValueError(f"mesh shape {tuple(axis_shape)} needs {int(np.prod(axis_shape))} "
                         f"ranks, the group has {world}")
    return DeviceMesh(current_device().type, torch.arange(world).reshape(tuple(axis_shape)),
                      mesh_dim_names=tuple(axis_names))


def host_shard_indices(n_rows: int, process_id: Optional[int] = None,
                       num_processes: Optional[int] = None) -> np.ndarray:
    """Row indices this rank owns: the strided shard ``pid::nprocs``."""
    pid = process_index() if process_id is None else process_id
    n = process_count() if num_processes is None else num_processes
    return np.arange(pid, n_rows, n)


def _place(x) -> torch.Tensor:
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(x))
    return t.to(current_device())


def global_batch(batch: Any, mesh, axis: str = "data") -> Any:
    """Each leaf of ``batch`` is this rank's rows of the global batch:
    returns them on this rank's card as ``DTensor``s sharded along ``axis``
    (leading dimension ``local_rows * ranks on the axis``), replicated over
    the mesh's other axes. No data moves between ranks."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    placements = [Shard(0) if name == axis else Replicate() for name in mesh.mesh_dim_names]
    return pytree.tree_map(
        lambda x: DTensor.from_local(_place(x), mesh, placements, run_check=False), batch)


def replicate(tree: Any, mesh=None) -> Any:
    """Make every tensor leaf of ``tree`` hold process 0's values on every
    rank: a broadcast from rank 0, in place. A replicated start then never
    depends on every process drawing the same numbers. ``mesh`` (the JAX
    signature's) must span the whole group. Returns ``tree``."""
    if mesh is not None and mesh.mesh.numel() != process_count():
        raise ValueError("replicate() needs a mesh over every rank of the group")
    for leaf in pytree.tree_leaves(tree):
        if isinstance(leaf, torch.Tensor):
            dist.broadcast(leaf.data, src=0)
    return tree


def place_global(tree: Dict[str, Any], mesh, specs: Dict[str, Sequence]) -> Dict[str, Any]:
    """Place each entry of ``tree`` on ``mesh`` per ``specs[name]``, a
    sequence of ``DTensor`` placements, one per mesh axis: every rank holds
    the full value and keeps only its shard (the TP analog of
    :func:`replicate`)."""
    from torch.distributed.tensor import distribute_tensor

    return {name: distribute_tensor(_place(x), mesh, list(specs[name]))
            for name, x in tree.items()}


def barrier(name: str = "sparkdl_barrier") -> None:
    """Block until every rank reaches this point."""
    del name  # the JAX package names its barriers; the group's needs none
    if not dist.is_initialized():
        return
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[current_device().index])
    else:
        dist.barrier()
