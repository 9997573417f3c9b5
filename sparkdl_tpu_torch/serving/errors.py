"""Typed serving errors: the admission-control contract.

Port of ``sparkdl_tpu.serving.errors``. A caller tells a *shed* request
(retry later or elsewhere), an *expired* one (the answer is worthless now)
and a *closed* endpoint (stop sending) from a model failure by type. Each
also carries its :mod:`sparkdl_tpu_torch.resilience` class, so a
``RetryPolicy`` in front of a server backs off on shed requests and fails
fast on expired or closed ones.

The replica plane's errors (``ReplicaDraining``, ``NoLiveReplicas``,
``RemoteReplicaError``) come with it (ROADMAP item 10b).
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
