"""The port's engine: compiling, caching and dispatching programs.

Port of ``sparkdl_tpu.engine``:

- :class:`ExecutionEngine` and :data:`engine`: a function at a concrete
  argument signature resolves to an AOTInductor program through an
  in-memory LRU and the on-disk :class:`PersistentCompileCache`
  (``SPARKDL_COMPILE_CACHE``);
- :class:`DispatchWindow`: a depth-N in-flight window with asynchronous
  device-to-host copies, and :class:`PinnedStaging`, its host-to-device
  half;
- :class:`SlotPool`: the fixed slot pool of the continuous-batching decode
  plane and of ragged one-shot serving;
- :func:`cache_key`: the content address binding a program to its
  fingerprint, its arguments' shapes, dtypes and placements, the placements
  of what it closes over, and the torch, CUDA and card it was built for.
"""

from sparkdl_tpu_torch.engine.cache import (
    PersistentCompileCache,
    cache_key,
    default_cache_dir,
)
from sparkdl_tpu_torch.engine.core import ExecutionEngine, ProgramHandle
from sparkdl_tpu_torch.engine.executor import (
    DispatchWindow,
    FetchFailure,
    PinnedStaging,
    dispatch_depth,
)
from sparkdl_tpu_torch.engine.slots import Slot, SlotPool, slot_block_fingerprint

#: the process-wide engine (the decode plane's); serving's ProgramCache
#: builds its own, so that its cache_size eviction releases programs
engine = ExecutionEngine()

__all__ = [
    "DispatchWindow",
    "ExecutionEngine",
    "FetchFailure",
    "PersistentCompileCache",
    "PinnedStaging",
    "ProgramHandle",
    "Slot",
    "SlotPool",
    "cache_key",
    "default_cache_dir",
    "dispatch_depth",
    "engine",
    "slot_block_fingerprint",
]
