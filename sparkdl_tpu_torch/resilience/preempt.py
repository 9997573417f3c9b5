"""Preemption-safe shutdown: SIGTERM -> typed ``Preempted`` at a safe point
-> final checkpoint flush -> clean resume on the next fit.

A copy of ``sparkdl_tpu.resilience.preempt`` without the flight recorder
(ROADMAP.md item 14). The contract:

1. a fit loop runs inside :func:`preemption_scope`, which installs a
   SIGTERM handler (main thread only; elsewhere the scope only polls) that
   sets a flag: a signal handler must not raise into an arbitrary frame;
2. the loop calls ``token.check()`` at step boundaries, the safe points,
   which raises :class:`~sparkdl_tpu_torch.resilience.errors.Preempted`;
3. the loop's cleanup waits for the checkpointer, so the last completed
   epoch is committed before the process yields;
4. a re-fit restores that epoch and replays the permutation draws, and
   equals an uninterrupted fit bit for bit wherever two uninterrupted fits
   agree (on a card, a model whose weight gradients run cuDNN's default
   algorithms needs ``torch.use_deterministic_algorithms(True)``).

:func:`request_preemption` is what a fault plan's ``preempt=True`` rule
calls: the same flag and the same safe-point delivery, without a signal.
"""

from __future__ import annotations

import logging
import signal
import threading
from contextlib import contextmanager
from typing import List

from sparkdl_tpu_torch.resilience.errors import Preempted
from sparkdl_tpu_torch.utils.metrics import metrics

logger = logging.getLogger(__name__)


class PreemptionToken:
    """The flag a scope's loop polls at safe points."""

    def __init__(self, reason: str = ""):
        self._event = threading.Event()
        self.reason = reason

    def request(self, reason: str = "") -> None:
        if reason:
            self.reason = reason
        self._event.set()

    @property
    def requested(self) -> bool:
        return self._event.is_set()

    def check(self) -> None:
        """Raise :class:`Preempted` when a preemption is pending; call it
        at step boundaries, where stopping is safe."""
        if self._event.is_set():
            raise Preempted(self.reason or "preemption requested")


#: innermost-last stack of active scopes (fitMultiple nests fits)
_SCOPES: List[PreemptionToken] = []
_SCOPES_LOCK = threading.Lock()


def request_preemption(reason: str = "preemption requested") -> None:
    """Deliver a simulated preemption: flag the innermost active scope; with
    no scope active, raise :class:`Preempted` at once, since a caller
    outside a guarded loop has no safe point to defer to."""
    metrics.counter("resilience.preemptions").add(1)
    with _SCOPES_LOCK:
        token = _SCOPES[-1] if _SCOPES else None
    if token is None:
        raise Preempted(reason)
    token.request(reason)


@contextmanager
def preemption_scope():
    """Yield a :class:`PreemptionToken` wired to SIGTERM for the block.

    The previous SIGTERM handler is chained, not replaced: after flagging
    the token it still runs, so an outer supervisor keeps its behaviour,
    and it is put back when the block ends. Only the main thread can install
    a handler; from a worker thread (a ``CrossValidator`` trial) the scope
    serves simulated preemptions without a signal."""
    token = PreemptionToken()
    with _SCOPES_LOCK:
        _SCOPES.append(token)
    previous = None
    installed = False

    def handler(signum, frame):
        logger.warning(
            "SIGTERM received: finishing the current step, flushing "
            "the last completed epoch's checkpoint, then exiting"
        )
        token.request("SIGTERM")
        if callable(previous):
            previous(signum, frame)

    try:
        previous = signal.signal(signal.SIGTERM, handler)
        installed = True
    except ValueError:
        # not the main thread: a polling-only scope
        pass
    try:
        yield token
    finally:
        with _SCOPES_LOCK:
            if token in _SCOPES:
                _SCOPES.remove(token)
        if installed:
            signal.signal(signal.SIGTERM, previous)
