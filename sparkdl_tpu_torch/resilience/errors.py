"""The preemption error of ``sparkdl_tpu.resilience.errors``."""


class Preempted(BaseException):
    """The process received (or simulated) a preemption notice: SIGTERM
    from the scheduler. A ``BaseException``, like ``KeyboardInterrupt``, so
    that broad ``except Exception`` recovery paths cannot swallow a shutdown
    request; the fit loops let it through after flushing their last
    completed epoch's checkpoint."""
