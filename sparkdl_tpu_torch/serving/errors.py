"""Typed serving errors: the admission-control contract.

Port of ``sparkdl_tpu.serving.errors``. A caller tells a *shed* request
(retry later or elsewhere), an *expired* one (the answer is worthless now)
and a *closed* endpoint (stop sending) from a model failure by type. Each
also carries its :mod:`sparkdl_tpu_torch.resilience` class, so a
``RetryPolicy`` in front of a server backs off on shed requests and fails
fast on expired or closed ones. The replica plane's errors
(``ReplicaDraining``, ``NoLiveReplicas``, ``RemoteReplicaError``) cross the
wire by class name (:func:`sparkdl_tpu_torch.serving.wire.decode_error`).
"""

from __future__ import annotations

from sparkdl_tpu_torch.resilience.errors import (
    DeadlineExceeded as _DeadlineExpired,
    PermanentError,
    TransientError,
)


class ServingError(RuntimeError):
    """Base class of every online-serving error."""


class ServerOverloaded(ServingError, TransientError):
    """The bounded request queue is full: the request was shed at admission,
    before it took a queue slot or card time. Back off and retry; the server
    is alive. (Transient.)"""


class TenantThrottled(ServerOverloaded):
    """One tenant is over its fair share (its in-flight cap) while the server
    as a whole has room. Raised at admission only: an admitted request always
    resolves through its future. (Transient.)"""


class DeadlineExceeded(ServingError, _DeadlineExpired):
    """The request's deadline expired while it waited; it was dropped before
    it took a batch row. (Permanent: never retried under the same
    deadline.)"""


class ServerClosed(ServingError, PermanentError):
    """The endpoint was closed: submissions are rejected, and requests still
    queued at close fail with this error. (Permanent.)"""


class ReplicaDraining(ServingError, TransientError):
    """The replica is draining after SIGTERM: it finishes in-flight work but
    admits nothing new. The router treats it as a connection-level failure
    and re-routes to a live replica. (Transient.)"""


class NoLiveReplicas(ServingError, TransientError):
    """The router has no live replica to place the request on: every replica
    is dead, draining or evicted. The supervisor is restarting them; back
    off and retry. (Transient.)"""


class RemoteReplicaError(ServingError, PermanentError):
    """A replica reported a failure class the wire does not recognise.
    Permanent on purpose: the router must not blind-retry a failure it
    cannot classify (it may be a model error that fails alike everywhere).
    Connection-shaped classes (``ConnectionError``, ``TimeoutError``,
    ``FrameCorrupt``) are in the wire's error registry and decode to their
    own retryable types, so they never land here. Every ``ServingError``
    subclass inherits exactly one of ``TransientError`` and
    ``PermanentError``."""
