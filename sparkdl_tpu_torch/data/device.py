"""Host-to-device placement for the pipeline's terminal stage.

Port of ``sparkdl_tpu.data.device``. ``Dataset.prefetch_to_device`` needs
one callable that moves a host batch (arrays, or pytrees of arrays: the
estimators' ``{"x", "y", "w"}`` dicts, a :class:`~sparkdl_tpu_torch.data.
dataset.Batch`) to the card and returns at once, so that the next batch's
copy overlaps the consumer's compute on the current one.
:func:`default_device_placer` builds it:

- each numeric leaf goes into a pinned host buffer of
  :class:`~sparkdl_tpu_torch.engine.executor.PinnedStaging` and from there
  to the card with a ``non_blocking`` copy **on a side stream**; a buffer is
  refilled only after the event recorded behind the copy that last read it;
- before a placed batch reaches the consumer, :meth:`DevicePlacer.ready`
  makes the consumer's current stream wait for the copy's event, and marks
  each placed tensor as used on that stream (``record_stream``): the
  tensors were allocated on the side stream, and without it the caching
  allocator could hand their memory out again while the consumer's kernels
  still read it;
- ``Batch.n_real`` stays on the host (it drives masking, not device work);
  leaves that are not numbers (URIs, rows) pass through unchanged.

The JAX package shards a batch over a device mesh when one is live. The
port's mesh is a process group, one rank per card: given a ``DeviceMesh``
(or the group's cards, in rank order), each rank keeps its own rows of a
batch (the contiguous slice of the leading dimension that the JAX
package's ``P("data")`` places on device ``r``) and places them on its own
card through the same pinned side-stream copy; a leaf whose leading
dimension does not split over the ranks is placed whole.
"""

from __future__ import annotations

from collections import deque
from typing import Any, Callable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

from sparkdl_tpu_torch.data.dataset import Batch
from sparkdl_tpu_torch.utils.device import resolve_device


def _is_numeric(leaf) -> bool:
    if isinstance(leaf, (bool, int, float, np.generic)):
        return True
    return isinstance(leaf, np.ndarray) and leaf.dtype.kind in "biuf"


def _host_array(leaf) -> np.ndarray:
    """A leaf as a host array of its own shape (``np.ascontiguousarray``
    would make a scalar one-dimensional)."""
    a = leaf.numpy() if isinstance(leaf, torch.Tensor) else np.asarray(leaf)
    return np.ascontiguousarray(a) if a.ndim else a


def _rank_rows(leaf, rank: int, ranks: int):
    """Rank ``rank``'s contiguous share of ``leaf``'s leading dimension, or
    ``leaf`` whole when it does not split over ``ranks``."""
    shape = getattr(leaf, "shape", ())
    if not shape or shape[0] % ranks:
        return leaf
    per = shape[0] // ranks
    return leaf[rank * per:(rank + 1) * per]


class DevicePlacer:
    """``place(batch)`` starts the batch's copy to ``device`` and returns the
    placed batch; ``ready(placed)`` must run on the consumer's thread before
    it reads the tensors (``prefetch_to_device`` calls it). ``shard=(rank,
    ranks)`` keeps only that rank's rows of each leaf (the mesh branch)."""

    #: pinned buffer sets: the batch being placed, the one the consumer
    #: reads, and one whose copy may still run
    SLOTS = 3

    def __init__(self, device: torch.device, shard: Optional[Tuple[int, int]] = None):
        self.device = torch.device(device)
        self.shard = shard
        self._cuda = self.device.type == "cuda"
        if self._cuda:
            from sparkdl_tpu_torch.engine.executor import PinnedStaging

            self._staging = PinnedStaging(self.device, slots=self.SLOTS)
            self._stream = torch.cuda.Stream(device=self.device)
            #: (placed batch, its tensors, the event behind their copy), oldest first
            self._inflight: "deque" = deque()

    def __call__(self, batch):
        if isinstance(batch, Batch):
            return Batch(self(batch.items), batch.n_real)
        leaves, spec = pytree.tree_flatten(batch)
        if self.shard is not None:
            leaves = [_rank_rows(leaf, *self.shard)
                      if _is_numeric(leaf) or isinstance(leaf, torch.Tensor) else leaf
                      for leaf in leaves]
        moved = [i for i, leaf in enumerate(leaves)
                 if _is_numeric(leaf) or (isinstance(leaf, torch.Tensor)
                                          and leaf.device.type == "cpu")]
        if not self._cuda:
            for i in moved:
                leaves[i] = torch.as_tensor(_host_array(leaves[i]))
            return pytree.tree_unflatten(leaves, spec)
        host = [_host_array(leaves[i]) for i in moved]
        with torch.cuda.stream(self._stream):
            # staged with a leading dimension (a scalar as one row)
            placed = self._staging.place([a.reshape(1) if not a.ndim else a for a in host])
            done = torch.cuda.Event()
            done.record(self._stream)
        for i, a, t in zip(moved, host, placed):
            leaves[i] = t.reshape(a.shape)
        out = pytree.tree_unflatten(leaves, spec)
        self._inflight.append((out, placed, done))
        return out

    def ready(self, placed) -> None:
        """The consumer's current stream waits for ``placed``'s copy, and
        each placed tensor is recorded as used on it."""
        if not self._cuda:
            return
        items = placed.items if isinstance(placed, Batch) else placed
        while self._inflight:
            out, tensors, done = self._inflight.popleft()
            consumer = torch.cuda.current_stream(self.device)
            consumer.wait_event(done)
            for t in tensors:
                t.record_stream(consumer)
            if out is items:
                return
        raise ValueError("ready() of a batch this placer did not place")


def default_device_placer(
    device: Union[None, str, torch.device, Sequence[Union[str, torch.device]]] = None,
    mesh=None,
    axis: str = "data",
) -> Callable[[Any], Any]:
    """A :class:`DevicePlacer` for ``device`` (None: the card; without one
    it raises unless ``device="cpu"``).

    The mesh branch: given ``mesh`` (a ``DeviceMesh`` of the process group)
    or several devices (the group's cards in rank order, one per rank),
    each rank places its own rows of ``axis`` on its own card. Several
    devices without a group of as many ranks raise: one process drives one
    card."""
    from sparkdl_tpu_torch.parallel import runner

    if isinstance(device, (list, tuple)):
        devices: List = [torch.device(d) for d in device]
        if len(devices) > 1 or mesh is not None:
            if not runner.is_initialized() or runner.process_count() != len(devices):
                raise ValueError(
                    f"default_device_placer got {len(devices)} devices: one process drives "
                    "one card, so a batch split over several is placed by the ranks of a "
                    f"process group of {len(devices)} (parallel.runner.initialize), each "
                    "its own rows")
            if devices[runner.process_index()] != runner.current_device():
                raise ValueError(f"rank {runner.process_index()} runs on "
                                 f"{runner.current_device()}, not {devices[runner.process_index()]}")
            mesh = mesh if mesh is not None else runner.make_global_mesh((axis,))
        device = devices[0] if devices else None
    if mesh is not None:
        group = mesh.get_group(axis)
        return DevicePlacer(runner.current_device(),
                            shard=(dist.get_rank(group), dist.get_world_size(group)))
    return DevicePlacer(resolve_device(device))
