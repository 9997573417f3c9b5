"""Opt-in ``torch.profiler`` trace capture around transforms.

Any transform can be wrapped in a trace of its host and card activity,
written as ``*.pt.trace.json`` (Chrome trace format: Perfetto, TensorBoard's
profiler plugin and ``chrome://tracing`` read it):

- programmatic: ``with profiler.trace("/tmp/trace"): transformer.transform(df)``
- zero-code: set ``SPARKDL_PROFILE_DIR=/tmp/trace`` and every batched
  transform captures into it (``maybe_trace`` wraps the loops of
  :func:`~sparkdl_tpu_torch.transformers.utils.run_batched_rows` and
  :func:`~sparkdl_tpu_torch.transformers.utils.run_batched_multi`).

CPU activity is always captured; CUDA activity (kernels, copies) when a card
is present. With the variable unset, ``maybe_trace`` is a ``nullcontext``:
no import of the profiler, no work.

On an H100 the first capture in a process pays ~14 s of CUPTI start-up, and
a capture taken minutes after the process's first one can miss its first
kernels: the profiler places the card's events ever earlier against the
host clock as the process ages, and drops those that fall before the
capture's start (4 minutes on: the first 10 kernels of a ViT-B/16 batch;
15 minutes on: its first 3 blocks). For complete kernel counts, capture in
a fresh process.
"""

from __future__ import annotations

import os
import threading
from contextlib import contextmanager, nullcontext

# a process holds one profiler capture at a time (CUPTI's state is global),
# so the first entrant wins and nested or concurrent sections run untraced
# (their card work still lands in the active capture)
_trace_lock = threading.Lock()
_trace_active = False


@contextmanager
def trace(log_dir: str):
    """Capture a ``torch.profiler`` trace of the enclosed block into
    ``log_dir`` (created if missing).

    Re-entrant and concurrent use degrades to a no-op instead of raising:
    only one capture exists per process at a time.
    """
    global _trace_active
    with _trace_lock:
        acquired = not _trace_active
        _trace_active = True
    if not acquired:
        yield
        return
    try:
        import torch
        from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        log_dir = str(log_dir)
        os.makedirs(log_dir, exist_ok=True)
        with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)):
            yield
    finally:
        with _trace_lock:
            _trace_active = False


def maybe_trace(log_dir=None):
    """``trace(dir)`` if profiling is requested, else a no-op context.

    ``log_dir`` defaults to the ``SPARKDL_PROFILE_DIR`` environment variable;
    profiling is off when neither is set (the common case: no overhead).
    """
    log_dir = log_dir or os.environ.get("SPARKDL_PROFILE_DIR")
    return trace(log_dir) if log_dir else nullcontext()


def annotate(name: str):
    """A named range inside an active trace (``record_function``)."""
    import torch.profiler

    return torch.profiler.record_function(name)
