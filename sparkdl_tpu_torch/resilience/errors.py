"""The failure taxonomy of ``sparkdl_tpu.resilience.errors``, trimmed to what
the port's fit loops, engine and serving plane raise and read.

Every fault is *transient* (a retry may succeed: overload, a reset
connection, a device out of memory for the moment) or *permanent* (the
request, program or data is wrong: retrying hides the bug). A
:class:`~sparkdl_tpu_torch.resilience.policy.RetryPolicy` retries only what
:func:`classify` calls transient. The serving errors inherit these bases,
so ``isinstance`` is the classification, and :func:`register` teaches
:func:`classify` a foreign type.
"""

from __future__ import annotations

from typing import Optional, Type, Union

import torch


class FaultError(RuntimeError):
    """Base of the taxonomy."""


class TransientError(FaultError):
    """A retry may succeed: the fault is in the environment, not in the
    request."""


class PermanentError(FaultError):
    """Retrying cannot help: fail fast with the typed class."""


class DeviceUnresponsive(PermanentError):
    """A device-touching call (a compile, a program load) outlived the
    watchdog's hard timeout. Permanent: a retry in this process would hang
    against the same device; recovery is a new process."""


class DeadlineExceeded(PermanentError):
    """The work's deadline expired: the answer is worthless now, so no
    retry policy re-attempts it under the same deadline."""


class CircuitOpen(TransientError):
    """A :class:`~sparkdl_tpu_torch.resilience.policy.CircuitBreaker` is open:
    calls are rejected without touching the failing dependency until its
    recovery window has passed."""


class Preempted(BaseException):
    """The process received (or simulated) a preemption notice: SIGTERM
    from the scheduler. A ``BaseException``, like ``KeyboardInterrupt``, so
    that broad ``except Exception`` recovery paths cannot swallow a shutdown
    request; the fit loops let it through after flushing their last
    completed epoch's checkpoint."""


#: OS-level exceptions where the environment, not the caller, failed
_TRANSIENT_OS_TYPES = (ConnectionError, TimeoutError, InterruptedError, BlockingIOError)
#: OS-level exceptions where a retry asks the same doomed question
_PERMANENT_OS_TYPES = (FileNotFoundError, PermissionError, IsADirectoryError,
                       NotADirectoryError)

#: caller-registered overrides, consulted before the built-in rules
_REGISTERED: "list[tuple[Type[BaseException], bool]]" = []


def register(exc_type: Type[BaseException], transient: bool) -> None:
    """Teach :func:`classify` about a foreign exception type. Later
    registrations win (consulted most recent first), so a caller can
    narrow an earlier, broader registration."""
    _REGISTERED.insert(0, (exc_type, bool(transient)))


def classify(exc: BaseException) -> "Type[Union[TransientError, PermanentError]]":
    """:class:`TransientError` or :class:`PermanentError` for any exception.

    Taxonomy members answer for themselves; then the caller's
    :func:`register` entries; the card running out of memory is transient
    (the JAX package's ``RESOURCE_EXHAUSTED``); OS errors by type, a
    residual ``OSError`` transient; everything unknown is permanent, since
    retrying an unclassified failure masks bugs."""
    if isinstance(exc, TransientError):
        return TransientError
    if isinstance(exc, PermanentError):
        return PermanentError
    for exc_type, transient in _REGISTERED:
        if isinstance(exc, exc_type):
            return TransientError if transient else PermanentError
    if isinstance(exc, torch.OutOfMemoryError):
        return TransientError
    if isinstance(exc, _PERMANENT_OS_TYPES):
        return PermanentError
    if isinstance(exc, (*_TRANSIENT_OS_TYPES, OSError)):
        return TransientError
    return PermanentError


def is_transient(exc: BaseException) -> bool:
    return classify(exc) is TransientError


def error_class(exc: Optional[BaseException]) -> str:
    """The structured-record label of an exception: its type's name."""
    return type(exc).__name__ if exc is not None else "None"
