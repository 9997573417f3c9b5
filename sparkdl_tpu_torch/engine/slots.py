"""A fixed pool of slots for continuous batching.

Port of ``sparkdl_tpu.engine.slots``. A fixed pool of N slots over one
carry stack of shape ``(N, *carry_shape)``:

- a fused program is compiled once for the pool's shape and never again
  (one program per pool size, not per batch size);
- each slot holds one request's row (a decode stream's carry, or a one-shot
  request's input) and its step counter; the stack is allocated once and
  reused across steps and requests;
- a finished request frees its slot at once, and the next queued request is
  admitted into it mid-flight, with no barrier on the others.

The stack lives on ``device``: the decode plane keeps its carries on the
card between fused steps; the one-shot batcher keeps its block on the host
and stages each dispatch's copy through pinned buffers, since the pool
rewrites rows (admission, release) while an earlier block may still be on
its way to the card. One worker thread owns a pool; only its occupancy
gauge is read from other threads.
"""

from __future__ import annotations

from collections import deque
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from sparkdl_tpu_torch.utils.device import resolve_device


def slot_block_fingerprint(fingerprint: Optional[str], kind: str,
                           n_slots: int) -> Optional[str]:
    """The durable identity of a slot-block program: one per (model, kind,
    pool size). ``kind`` tells a decode step from the one-shot ragged
    forward over the same pool shape. None stays None: an unfingerprinted
    model is not persisted (and its one-shot endpoint serves padded)."""
    if fingerprint is None:
        return None
    return f"{fingerprint}:{kind}-slots-{int(n_slots)}"


class Slot:
    """One slot: its row of the stack, the request in it (opaque here) and
    the stream's counters."""

    __slots__ = ("index", "request", "step", "stream_seq", "acquired_at", "first_token_at")

    def __init__(self, index: int):
        self.index = index
        self.request: Any = None
        self.step = 0
        #: the next stream frame's sequence number (gap-free from 0)
        self.stream_seq = 0
        self.acquired_at: Optional[float] = None
        self.first_token_at: Optional[float] = None

    @property
    def occupied(self) -> bool:
        return self.request is not None

    def __repr__(self):
        return f"Slot({self.index}, occupied={self.occupied}, step={self.step})"


def _as_tensor(carry) -> torch.Tensor:
    if isinstance(carry, torch.Tensor):
        return carry
    return torch.from_numpy(np.ascontiguousarray(np.asarray(carry)))


class SlotPool:
    """N slots over one reused stack of shape ``(N, *carry_shape)`` on
    ``device`` (``None`` is the card, which raises without one; pass
    ``"cpu"`` for the CPU).

    The carry's shape and dtype bind at the first :meth:`acquire`; every
    later carry must match. :meth:`release` zeroes the slot's row: state
    never leaks into the next request, and a leak would show as zeros
    rather than as a wrong answer."""

    def __init__(self, n_slots: int, occupied_gauge=None, device=None):
        if n_slots < 1:
            raise ValueError(f"n_slots must be >= 1, got {n_slots}")
        self.n_slots = int(n_slots)
        self.device = resolve_device(device)
        self._slots = [Slot(i) for i in range(self.n_slots)]
        self._free: "deque[int]" = deque(range(self.n_slots))
        self._carries: Optional[torch.Tensor] = None
        self._gauge = occupied_gauge
        self._set_gauge()

    def _set_gauge(self) -> None:
        if self._gauge is not None:
            self._gauge.set(self.n_occupied)

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_occupied(self) -> int:
        return self.n_slots - len(self._free)

    @property
    def carry_shape(self) -> Optional[Tuple[int, ...]]:
        """One slot's carry shape (no slot dim), once bound."""
        return None if self._carries is None else tuple(self._carries.shape[1:])

    @property
    def carry_dtype(self) -> Optional[torch.dtype]:
        return None if self._carries is None else self._carries.dtype

    def acquire(self, request: Any, carry, now: Optional[float] = None) -> Optional[Slot]:
        """Admit ``request`` into a free slot, writing its first ``carry``
        (an array or a tensor) into the slot's row; None when the pool is
        full."""
        if not self._free:
            return None
        row = _as_tensor(carry)
        if self._carries is None:
            self._carries = torch.zeros((self.n_slots, *row.shape), dtype=row.dtype,
                                        device=self.device)
        elif tuple(row.shape) != self.carry_shape or row.dtype != self.carry_dtype:
            raise ValueError(
                f"carry of shape {tuple(row.shape)}/{row.dtype} does not match the "
                f"pool's bound {self.carry_shape}/{self.carry_dtype}: one pool serves "
                "one carry shape"
            )
        slot = self._slots[self._free.popleft()]
        slot.request = request
        slot.step = 0
        slot.stream_seq = 0
        slot.acquired_at = now
        slot.first_token_at = None
        self._carries[slot.index].copy_(row)
        self._set_gauge()
        return slot

    def release(self, slot: Slot) -> None:
        """Free ``slot`` and zero its row."""
        if slot.request is None:
            return
        slot.request = None
        slot.step = 0
        slot.stream_seq = 0
        slot.acquired_at = None
        slot.first_token_at = None
        if self._carries is not None:
            self._carries[slot.index].zero_()
        self._free.append(slot.index)
        self._set_gauge()

    def release_all(self) -> List[Slot]:
        """Evict every occupied slot (shutdown, drain); returns them with
        their ``request`` still attached, so the caller can resolve the
        futures. The pool itself is cleared."""
        out = []
        for slot in self._slots:
            if slot.occupied:
                evicted = Slot(slot.index)
                evicted.request = slot.request
                evicted.step = slot.step
                evicted.stream_seq = slot.stream_seq
                out.append(evicted)
                self.release(slot)
        return out

    def occupied(self) -> List[Slot]:
        """The occupied slots in index order: the fused step's rows."""
        return [s for s in self._slots if s.occupied]

    def mask(self) -> np.ndarray:
        """``(n_slots,)`` bool occupancy (True rows are computed and read;
        False rows are zeroed by a masked program)."""
        m = np.zeros(self.n_slots, dtype=bool)
        for s in self._slots:
            if s.occupied:
                m[s.index] = True
        return m

    def carries(self) -> torch.Tensor:
        """The whole ``(N, *carry_shape)`` stack (vacant rows are zeros). A
        fused step runs over every row each time, constant shape being the
        point; vacant rows' outputs are never read."""
        if self._carries is None:
            raise RuntimeError("pool has no bound carry shape yet")
        return self._carries

    def store_carries(self, new_carries) -> None:
        """Write a fused step's new ``(N, *carry_shape)`` stack into the
        reused one (no reallocation)."""
        new = _as_tensor(new_carries)
        if tuple(new.shape) != tuple(self._carries.shape):
            raise ValueError(f"step returned carries of shape {tuple(new.shape)}; "
                             f"pool expects {tuple(self._carries.shape)}")
        self._carries.copy_(new)

    def snapshot(self) -> dict:
        shape = self.carry_shape
        return {
            "n_slots": self.n_slots,
            "occupied": self.n_occupied,
            "carry_shape": list(shape) if shape is not None else None,
            "steps": {s.index: s.step for s in self._slots if s.occupied},
        }

    def __repr__(self):
        return f"SlotPool(n_slots={self.n_slots}, occupied={self.n_occupied})"
