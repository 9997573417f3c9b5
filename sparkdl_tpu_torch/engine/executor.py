"""Async dispatch window: keep N batches in flight, fetch without stalls.

Port of ``sparkdl_tpu.engine.executor``. PyTorch launches on the card
asynchronously, as jax dispatches: ``fn(batch)`` returns device tensors
whose values are not computed yet. A loop that reads each result back right
after its launch puts the device-to-host copy and the host's wait behind
every batch. The window decides when to wait instead:

- ``submit(result, meta)`` starts each result tensor's **device-to-host
  copy at once**, ``non_blocking``, into a pinned host buffer, and records
  a CUDA event after it; it then fetches only what falls out of the window;
- with depth N, batch i is fetched while batches i+1..i+N are queued, so
  its copy has finished when the host reads it;
- depth 0 is strict dispatch -> fetch (the ``SPARKDL_SERIAL_INFERENCE=1``
  kill switch of :mod:`sparkdl_tpu_torch.transformers.utils`).

A fetch synchronizes on the result's event, copies the pinned buffer into
an array the caller owns, and returns the buffer to a free list: a pinned
buffer is written again only after the copy that filled it was read.

:class:`PinnedStaging` is the host-to-device half: each batch goes into a
pinned input buffer and from there to the card with a ``non_blocking``
copy, and a buffer is refilled only after the event recorded behind the
copy that last read it (a buffer overwritten while a copy still reads it
would ship the next batch's rows).

CPU tensors pass through: their values exist at ``submit``, and a fetch is
``.numpy()``. The window is not a thread: the card's stream gives the
asynchrony, and the window only decides when to synchronize.
"""

from __future__ import annotations

import os
from collections import deque
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from sparkdl_tpu_torch.utils.metrics import metrics

_DEPTH_ENV = "SPARKDL_DISPATCH_DEPTH"
DEFAULT_DEPTH = 2


def dispatch_depth() -> int:
    """The configured in-flight window depth (``SPARKDL_DISPATCH_DEPTH``,
    default 2: one batch computing, one copying back). A negative value
    clamps to 0; one that is not an integer raises ``ValueError``."""
    spec = os.environ.get(_DEPTH_ENV, "").strip()
    if not spec:
        return DEFAULT_DEPTH
    try:
        return max(0, int(spec))
    except ValueError:
        raise ValueError(
            f"{_DEPTH_ENV} must be a non-negative integer, got {spec!r}"
        ) from None


def _fit_buffer(free: List[torch.Tensor], like: torch.Tensor) -> torch.Tensor:
    """A pinned buffer from ``free`` that holds ``like`` (the same trailing
    shape and dtype, at least as many rows), taken off the list; else a new
    one."""
    for i, buf in enumerate(free):
        if (buf.dtype == like.dtype and buf.shape[1:] == like.shape[1:]
                and buf.shape[0] >= like.shape[0]):
            return free.pop(i)
    return torch.empty(like.shape, dtype=like.dtype, pin_memory=True)


class _InFlight:
    """One submitted result: per tensor, its pinned host buffer (CUDA) or
    the tensor itself (CPU), and the event recorded after the copies."""

    __slots__ = ("parts", "rows", "event", "single")

    def __init__(self, parts, rows, event, single):
        self.parts = parts
        self.rows = rows
        self.event = event
        self.single = single


class FetchFailure:
    """A fetch that raised, delivered in order with its ``meta`` instead of
    aborting the window (``capture_errors=True``)."""

    __slots__ = ("error",)

    def __init__(self, error: BaseException):
        self.error = error

    def __repr__(self):
        return f"FetchFailure({self.error!r})"


class DispatchWindow:
    """A depth-N in-flight window over launched results.

    Usage::

        window = DispatchWindow(depth=2)
        for chunk in chunks:
            for host, meta in window.submit(fn(chunk), meta=k):
                consume(host, meta)          # arrives depth batches late
        for host, meta in window.drain():
            consume(host, meta)

    ``result`` is one tensor or a tuple of tensors; the host result is one
    array or a tuple of arrays, in the same form. Results come back strictly
    in submission order and ``meta`` rides through untouched. With
    ``capture_errors=True`` a failed fetch yields ``(FetchFailure(exc),
    meta)`` instead of raising. The ``engine.inflight`` gauge tracks the
    window's depth.
    """

    def __init__(self, depth: Optional[int] = None, capture_errors: bool = False):
        self.depth = dispatch_depth() if depth is None else max(0, int(depth))
        self.capture_errors = bool(capture_errors)
        self._inflight: "deque[Tuple[_InFlight, Any]]" = deque()
        self._free: Dict[int, List[torch.Tensor]] = {}
        self._gauge = metrics.gauge("engine.inflight")

    def __len__(self) -> int:
        return len(self._inflight)

    @property
    def has_room(self) -> bool:
        """True while another ``submit`` would not force a blocking fetch."""
        return len(self._inflight) <= self.depth

    def _start_copy(self, result) -> _InFlight:
        single = isinstance(result, torch.Tensor)
        tensors = (result,) if single else tuple(result)
        if not any(t.is_cuda for t in tensors):
            return _InFlight(tensors, None, None, single)
        parts, rows = [], []
        for j, t in enumerate(tensors):
            buf = _fit_buffer(self._free.setdefault(j, []), t)
            buf[:t.shape[0]].copy_(t.detach(), non_blocking=True)
            parts.append(buf)
            rows.append(t.shape[0])
        event = torch.cuda.Event()
        event.record()
        return _InFlight(parts, rows, event, single)

    def _fetch(self, entry: _InFlight):
        if entry.event is None:
            host = tuple(t.detach().numpy() for t in entry.parts)
        else:
            entry.event.synchronize()
            host = tuple(buf[:k].numpy().copy() for buf, k in zip(entry.parts, entry.rows))
            for j, buf in enumerate(entry.parts):
                self._free[j].append(buf)
        return host[0] if entry.single else host

    def _pop(self) -> Tuple[Any, Any]:
        entry, meta = self._inflight.popleft()
        self._gauge.set(len(self._inflight))
        if self.capture_errors:
            try:
                return self._fetch(entry), meta
            except Exception as exc:  # delivered, not raised
                return FetchFailure(exc), meta
        return self._fetch(entry), meta

    def pop_ready(self) -> List[Tuple[Any, Any]]:
        """Fetch and return only what exceeds the window's depth (what
        ``submit`` would have returned), without submitting anything."""
        out = []
        while len(self._inflight) > self.depth:
            out.append(self._pop())
        return out

    def submit(self, result, meta: Any = None) -> List[Tuple[Any, Any]]:
        """Start ``result``'s copy to the host and enqueue it; return the
        ``(host_result, meta)`` pairs that fell out of the window (possibly
        none)."""
        self._inflight.append((self._start_copy(result), meta))
        self._gauge.set(len(self._inflight))
        return self.pop_ready()

    def drain(self) -> Iterator[Tuple[Any, Any]]:
        """Fetch everything still in flight, in order."""
        while self._inflight:
            yield self._pop()

    def abandon(self) -> None:
        """Drop what is in flight without fetching (the error path)."""
        self._inflight.clear()
        self._gauge.set(0)


class PinnedStaging:
    """Host batches to ``device`` through ``slots`` rings of pinned input
    buffers (one buffer per input of a batch), each refilled only after the
    event recorded behind the ``non_blocking`` copy that last read it."""

    def __init__(self, device: torch.device, slots: int = 2):
        self.device = torch.device(device)
        self._slots: List[Tuple[Dict[int, torch.Tensor], torch.cuda.Event]] = [
            ({}, torch.cuda.Event()) for _ in range(max(1, int(slots)))
        ]
        self._next = 0

    def place(self, arrays: Sequence[np.ndarray]) -> Tuple[torch.Tensor, ...]:
        """Each array on the device, through the next slot's buffers."""
        bufs, event = self._slots[self._next]
        self._next = (self._next + 1) % len(self._slots)
        event.synchronize()  # the copy that last read these buffers is done
        out = []
        for j, a in enumerate(arrays):
            host = torch.from_numpy(np.ascontiguousarray(a))
            buf = bufs.get(j)
            if (buf is None or buf.dtype != host.dtype or buf.shape[1:] != host.shape[1:]
                    or buf.shape[0] < host.shape[0]):
                buf = bufs[j] = torch.empty(host.shape, dtype=host.dtype, pin_memory=True)
            k = host.shape[0]
            buf[:k].copy_(host)
            out.append(buf[:k].to(self.device, non_blocking=True))
        event.record()
        return tuple(out)
