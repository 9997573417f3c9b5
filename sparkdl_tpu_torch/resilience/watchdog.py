"""Watchdogged device calls: turn an unbounded hang into a typed failure.

A trimmed copy of ``sparkdl_tpu.resilience.watchdog``, without its flight
recorder (ROADMAP item 14). :func:`watchdogged` runs the call on a worker
thread and watches it from the caller's thread:

- past the **soft timeout** it runs a bounded out-of-process probe of the
  card, logs what the probe says and keeps waiting (an AOTInductor compile
  of a full-width model may take minutes and still land);
- past the **hard timeout** it raises
  :class:`~sparkdl_tpu_torch.resilience.errors.DeviceUnresponsive` with the
  probe's answer. The worker thread cannot be killed, so it is abandoned as
  a daemon: the caller's thread, and with it the job, stays in control.

:func:`check_device` is ``ModelServer.status(probe_device=True)``'s probe:
one structured ``{"ok", "error_class", "detail"}`` record.
"""

from __future__ import annotations

import logging
import subprocess
import sys
import threading
import time
from typing import Any, Callable

from sparkdl_tpu_torch.resilience import inject
from sparkdl_tpu_torch.resilience.errors import DeviceUnresponsive, error_class
from sparkdl_tpu_torch.utils.metrics import metrics

logger = logging.getLogger(__name__)

#: the liveness probe: create a CUDA context in a fresh interpreter and name
#: the card
DEFAULT_PROBE_CODE = (
    "import torch; torch.zeros(1, device='cuda'); "
    "print(torch.cuda.get_device_name(0))"
)


def bounded_subprocess_probe(code: str, timeout_s: int) -> "tuple[bool, str]":
    """Run ``code`` in a fresh interpreter with a hard timeout: ``(True,
    stdout)`` on success, else ``(False, diagnostic)``."""
    try:
        proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                              text=True, timeout=timeout_s)
    except subprocess.TimeoutExpired:
        return False, f"probe hung > {timeout_s}s"
    if proc.returncode != 0:
        return False, (proc.stderr or proc.stdout).strip()[-200:]
    return True, proc.stdout.strip()


def watchdogged(
    fn: Callable[..., Any],
    *args: Any,
    soft_timeout_s: float = 30.0,
    hard_timeout_s: float = 120.0,
    name: str = "device_call",
    diagnostic_code: str = DEFAULT_PROBE_CODE,
    diagnostic_timeout_s: float = 60.0,
    **kwargs: Any,
) -> Any:
    """``fn(*args, **kwargs)`` bounded by a two-stage watchdog: its result,
    its exception, or :class:`DeviceUnresponsive` after ``hard_timeout_s``.
    The fault site ``watchdog.<name>`` fires inside the worker."""
    if hard_timeout_s <= 0:
        raise ValueError(f"hard_timeout_s must be > 0, got {hard_timeout_s}")
    soft_timeout_s = min(soft_timeout_s, hard_timeout_s)
    done = threading.Event()
    box: dict = {}

    def run():
        try:
            inject.fire(f"watchdog.{name}")
            box["result"] = fn(*args, **kwargs)
        except BaseException as exc:  # noqa: BLE001 - relayed to the caller
            box["error"] = exc
        finally:
            done.set()

    worker = threading.Thread(target=run, name=f"sparkdl-watchdog-{name}", daemon=True)
    start = time.monotonic()
    worker.start()
    diagnostic = None
    if not done.wait(soft_timeout_s):
        metrics.counter("resilience.watchdog_soft_timeouts").add(1)
        ok, msg = bounded_subprocess_probe(diagnostic_code, int(diagnostic_timeout_s))
        diagnostic = f"probe {'ok' if ok else 'FAILED'}: {msg}"
        logger.warning("%s exceeded its soft timeout (%.1fs); out-of-process %s",
                       name, soft_timeout_s, diagnostic)
        remaining = hard_timeout_s - (time.monotonic() - start)
        if remaining > 0:
            done.wait(remaining)
    if not done.is_set():
        metrics.counter("resilience.watchdog_hard_timeouts").add(1)
        detail = f"; {diagnostic}" if diagnostic else ""
        raise DeviceUnresponsive(
            f"{name} still running after its hard timeout of {hard_timeout_s:.1f}s{detail}"
        )
    if "error" in box:
        raise box["error"]
    return box["result"]


def check_device(timeout_s: int = 300, probe_code: str = DEFAULT_PROBE_CODE) -> dict:
    """A bounded check that the card answers, as a structured record:
    ``{"ok": bool, "error_class": str | None, "detail": str}`` (``detail``
    is the card's name on success, the diagnostic on failure)."""
    try:
        ok, msg = watchdogged(
            bounded_subprocess_probe, probe_code, int(timeout_s),
            soft_timeout_s=timeout_s, hard_timeout_s=timeout_s + 30.0,
            name="device_probe", diagnostic_code=probe_code,
        )
    except DeviceUnresponsive as exc:
        return {"ok": False, "error_class": error_class(exc), "detail": str(exc)}
    if ok:
        return {"ok": True, "error_class": None, "detail": msg}
    return {"ok": False, "error_class": DeviceUnresponsive.__name__, "detail": msg}
