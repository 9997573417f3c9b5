"""The batched inference loop of the port's transformers.

Ports ``make_loader_decode_plan`` and ``run_batched_rows`` of
``sparkdl_tpu.transformers.utils``. The JAX loop padded the ragged last chunk
to ``batch_size`` so that XLA compiled one static shape; PyTorch runs
eagerly, so the last chunk runs at its own size and every row still comes
back once, in input order.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from sparkdl_tpu_torch.utils.metrics import metrics

DEFAULT_BATCH_SIZE = 32


def make_loader_decode_plan(
    load_one: Callable, what: str = "imageLoader"
) -> Callable[[Sequence], np.ndarray]:
    """Chunked decode plan for user-loader inputs (``load_one(uri) ->
    ndarray``), for :func:`run_batched_rows`.

    Enforces the one-fixed-shape loader contract ACROSS chunks (the first
    chunk's shape binds the partition), so a chunk-aligned shape change
    still raises the contract error instead of a raw concatenate failure.
    Advances the ``sparkdl.load`` timer and the images counter.
    """
    expected_shape: List[Optional[Tuple[int, ...]]] = [None]

    def decode(chunk):
        with metrics.timer("sparkdl.load").time():
            arrays = [
                np.asarray(load_one(v), dtype=np.float32) for v in chunk
            ]
        metrics.counter("sparkdl.images_processed").add(len(arrays))
        shapes = {a.shape for a in arrays}
        if expected_shape[0] is not None:
            shapes.add(expected_shape[0])
        if len(shapes) > 1:
            raise ValueError(
                f"{what} must produce one fixed array shape per image; "
                f"this partition mixes {sorted(shapes)} — resize inside "
                f"the {what}"
            )
        expected_shape[0] = arrays[0].shape
        return np.stack(arrays)

    return decode


def _prefetched(
    pool: ThreadPoolExecutor,
    decode: Callable[[Sequence], np.ndarray],
    rows: Sequence,
    bounds: Sequence[Tuple[int, int]],
) -> Iterator[np.ndarray]:
    """Decoded chunks in order; chunk i+1 decodes on the pool's one thread
    while the caller runs chunk i."""

    def job(lo, hi):
        batch = decode(rows[lo:hi])
        if batch.shape[0] != hi - lo:
            raise ValueError(
                f"decode returned {batch.shape[0]} rows for a chunk of "
                f"{hi - lo}; it must be row-aligned with its input"
            )
        return batch

    future = pool.submit(job, *bounds[0])
    for i in range(len(bounds)):
        batch = future.result()
        if i + 1 < len(bounds):
            future = pool.submit(job, *bounds[i + 1])
        yield batch


class _PinnedSlot:
    """Pinned host buffers of one chunk in flight, and the event recorded
    after the last copy that reads or writes them. A slot is refilled only
    after that event: a ``non_blocking`` copy still reading a buffer that
    the host overwrites would ship the next chunk's rows."""

    def __init__(self):
        self.inp: Optional[torch.Tensor] = None
        self.out: Optional[torch.Tensor] = None
        self.done = torch.cuda.Event()

    @staticmethod
    def _fit(buf, rows, like: torch.Tensor) -> torch.Tensor:
        if buf is None or buf.shape[1:] != like.shape[1:] or buf.dtype != like.dtype:
            buf = torch.empty(
                (rows, *like.shape[1:]), dtype=like.dtype, pin_memory=True
            )
        return buf


def _single_output(result) -> torch.Tensor:
    """The one tensor the loop fetches; bfloat16, which numpy cannot hold,
    widened (exactly) to float32 where it lies."""
    if isinstance(result, (tuple, list)):
        raise TypeError(
            "run_batched_rows requires a single-output fn "
            f"(got {len(result)} outputs); unwrap the output in the forward"
        )
    return result.float() if result.dtype == torch.bfloat16 else result


def run_batched_rows(
    fn: Callable[[torch.Tensor], torch.Tensor],
    rows: Sequence,
    decode: Callable[[Sequence], np.ndarray],
    batch_size: int = DEFAULT_BATCH_SIZE,
    device: "torch.device | str" = "cuda",
) -> np.ndarray:
    """Decode + forward pipeline over row chunks of ``batch_size`` rows.

    - the host decode of chunk i+1 runs on a prefetch thread while chunk i
      runs;
    - on CUDA each chunk goes through a pinned host buffer with a
      ``non_blocking`` host-to-device copy, and comes back with one
      device-to-host copy into a pinned buffer; two slots alternate, so the
      host dispatches chunk i+1 before it waits for chunk i.

    ``decode(chunk_rows) -> np.ndarray`` must be row-aligned with ``rows``;
    ``fn`` takes the batch on ``device`` and returns one tensor. Returns the
    outputs of all rows, in order, as one host array.
    """
    device = torch.device(device)
    n = len(rows)
    if n == 0:
        raise ValueError("run_batched_rows requires non-empty rows")
    bounds = [(lo, min(lo + batch_size, n)) for lo in range(0, n, batch_size)]
    collected: List[np.ndarray] = []
    # 'sparkdl.forward' times dispatch + fetch; 'sparkdl.serve' the whole
    # loop, load waits included (the rate images_per_sec() reports)
    serve_timer = metrics.timer("sparkdl.serve")
    forward_timer = metrics.timer("sparkdl.forward")
    pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="sparkdl-decode")
    try:
        with serve_timer.time():
            chunks = _prefetched(pool, decode, rows, bounds)
            if device.type == "cuda":
                with torch.cuda.device(device):
                    _run_cuda(fn, chunks, batch_size, device, collected, forward_timer)
            else:
                for batch in chunks:
                    with forward_timer.time():
                        y = _single_output(fn(torch.from_numpy(batch).to(device)))
                        collected.append(y.detach().cpu().numpy())
    finally:
        pool.shutdown(wait=True, cancel_futures=True)
    metrics.counter("sparkdl.rows_processed").add(n)
    metrics.counter("sparkdl.batches_run").add(len(bounds))
    return np.concatenate(collected, axis=0)


def _run_cuda(fn, chunks, batch_size, device, collected, forward_timer):
    slots = (_PinnedSlot(), _PinnedSlot())
    pending: List[Tuple[_PinnedSlot, int]] = []

    def fetch(slot: _PinnedSlot, k: int) -> None:
        slot.done.synchronize()
        collected.append(slot.out[:k].numpy().copy())

    for i, batch in enumerate(chunks):
        with forward_timer.time():
            k = batch.shape[0]
            slot = slots[i % 2]
            slot.done.synchronize()
            host = torch.from_numpy(batch)
            slot.inp = _PinnedSlot._fit(slot.inp, batch_size, host)
            slot.inp[:k].copy_(host)
            x = slot.inp[:k].to(device, non_blocking=True)
            y = _single_output(fn(x))
            slot.out = _PinnedSlot._fit(slot.out, batch_size, y)
            slot.out[:k].copy_(y, non_blocking=True)
            slot.done.record()
            pending.append((slot, k))
            if len(pending) == len(slots):
                fetch(*pending.pop(0))
    with forward_timer.time():
        for slot, k in pending:
            fetch(slot, k)
