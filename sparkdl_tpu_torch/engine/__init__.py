"""The port's engine: so far the dispatch window of the transform loop
(:mod:`sparkdl_tpu_torch.engine.executor`). The execution engine, the
persistent compile cache and the slot pool are not ported yet (ROADMAP
item 9)."""

from sparkdl_tpu_torch.engine.executor import (  # noqa: F401
    DispatchWindow,
    FetchFailure,
    PinnedStaging,
    dispatch_depth,
)
