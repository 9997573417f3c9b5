"""Trace-driven fleet simulator and self-tuning control plane.

The closed loop over the serving plane's knobs:

- :mod:`sparkdl_tpu_torch.sim.clock`: the virtual clock and deterministic
  discrete-event loop every controller's injectable-clock seam plugs into;
- :mod:`sparkdl_tpu_torch.sim.trace`: the record/replay trace format (the
  JAX package's, so either package reads the other's traces), records from
  the router's spans, and the seeded empirical phase sampler;
- :mod:`sparkdl_tpu_torch.sim.replica`: virtual replicas: the *real*
  :class:`~sparkdl_tpu_torch.serving.batcher.MicroBatcher` admission and
  coalesce path driven by events instead of a worker thread, with device
  time replayed from the trace;
- :mod:`sparkdl_tpu_torch.sim.replay`: the fleet replay harness: real
  Router / AdmissionQueue / Autoscaler / RolloutController / SLOEngine
  objects on virtual time, 100-1000x faster than the wall clock;
- :mod:`sparkdl_tpu_torch.sim.tune`: knob-space search (random +
  successive halving) against SLO burn, emitting a reviewable JSON
  artifact.

Nothing here touches a device or imports a kernel: the simulator replays
what the card did, recorded in the trace.
"""

from sparkdl_tpu_torch.sim.clock import EventLoop, VirtualClock
from sparkdl_tpu_torch.sim.replay import (
    DEFAULT_CONFIG,
    FleetReplay,
    fidelity_report,
    replay_trace,
)
from sparkdl_tpu_torch.sim.trace import (
    PhaseSampler,
    TraceRecord,
    load_trace,
    records_from_spans,
    summarize,
    write_trace,
)

__all__ = [
    "DEFAULT_CONFIG",
    "EventLoop",
    "FleetReplay",
    "PhaseSampler",
    "TraceRecord",
    "VirtualClock",
    "fidelity_report",
    "load_trace",
    "records_from_spans",
    "replay_trace",
    "summarize",
    "write_trace",
]
