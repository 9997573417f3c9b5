"""Virtual replicas: the real admission and coalesce objects, event-driven.

A :class:`SimReplica` is what a live replica process is to the router,
minus the process and the device: each endpoint gets a *real*
:class:`~sparkdl_tpu_torch.serving.batcher.MicroBatcher` (a real
:class:`~sparkdl_tpu_torch.serving.admission.AdmissionQueue` with DRR
fairness and typed shedding, real deadline bookkeeping, real expiry) built
on the virtual clock. Only the worker *thread* is replaced by event-loop
callbacks, and the device forward is replayed from the trace instead of run.
The replay harness drains batches at the same first-item-then-linger
instants the live worker would (``max_wait_ms`` after the first admit, at
once at ``max_batch``) and serializes service on ``busy_until``: one device,
one batch at a time, the property the coalesce window exists to exploit.
"""

from __future__ import annotations

from typing import Dict, List

from sparkdl_tpu_torch.serving.admission import Request
from sparkdl_tpu_torch.serving.batcher import MicroBatcher, ServingConfig
from sparkdl_tpu_torch.serving.cache import ProgramCache


class SimTransport:
    """Placeholder transport for a virtual backend: registering with
    :meth:`Router.add(transport=...) <sparkdl_tpu_torch.serving.router.Router.add>`
    must not dial a socket, and nothing in the simulator ever sends a frame:
    requests reach a :class:`SimReplica` as events."""

    lane = "sim"

    def request(self, msg, timeout_s):  # pragma: no cover - guard only
        raise RuntimeError(
            "SimTransport carries no frames; the replay harness delivers "
            "requests as events"
        )

    def close(self) -> None:
        pass


class SimBatcher(MicroBatcher):
    """A :class:`MicroBatcher` that never starts its worker thread: the
    event loop drains its (real) queue at the instants the worker would
    have. Everything on the submit side (shape binding, deadline
    bookkeeping, the expired-on-arrival fast fail, tenant fair-share
    shedding) is the production code path on the virtual clock."""

    def _ensure_worker(self) -> None:  # the event loop is the worker
        return

    def drain(self, now: float) -> List[Request]:
        """Non-blocking take of up to ``max_batch`` queued requests: what the
        worker's ``take(max_batch, max_wait)`` returns at the moment the
        coalesce window closes (the event loop already waited out the linger
        in virtual time)."""
        if not len(self._queue):
            return []
        return self._queue.take(self._config.max_batch, 0.0, poll_s=0.0)

    @property
    def config(self) -> ServingConfig:
        return self._config


class SimReplica:
    """One virtual replica: per-endpoint :class:`SimBatcher` lanes plus the
    single-device serialization point (``busy_until``)."""

    def __init__(self, name: str, version: str, config: ServingConfig,
                 clock, start: float = 0.0):
        self.name = name
        self.version = version
        self.config = config
        self._clock = clock
        #: the device is busy until this virtual instant; a batch that closes
        #: earlier waits (that wait is replica_queue time)
        self.busy_until = float(start)
        self._batchers: Dict[str, SimBatcher] = {}

    def batcher(self, endpoint: str) -> SimBatcher:
        mb = self._batchers.get(endpoint)
        if mb is None:
            # a simulated replica's device time is replayed from the trace
            # and its forward never runs (the event loop drains the queue and
            # resolves each future itself), so the batcher holds no tensors:
            # it is built on the CPU, eager, whether or not a card is present
            mb = SimBatcher(
                model_id=f"{self.name}.{endpoint}",
                forward=lambda x: x,
                config=self.config,
                cache=ProgramCache(maxsize=self.config.cache_size),
                item_shape=(),
                compile=False,
                device="cpu",
                clock=self._clock,
            )
            self._batchers[endpoint] = mb
        return mb

    def endpoints(self) -> List[str]:
        return sorted(self._batchers)

    def queue_depth(self) -> int:
        return sum(mb.queue_depth for mb in self._batchers.values())

    def close(self) -> None:
        for mb in self._batchers.values():
            mb.close()

    def __repr__(self):
        return (
            f"SimReplica({self.name!r}, version={self.version!r}, "
            f"busy_until={self.busy_until:.6f})"
        )
