"""Bounded out-of-process liveness probes.

A wedged card can make context creation block forever. Anything
that must touch the device unconditionally probes through this helper first
(the watchdog's soft timeout does), turning an unbounded hang into a loud,
bounded diagnostic.

Free of torch at import time: the probe must be importable and runnable
before any in-process device initialization.
"""

from __future__ import annotations

import subprocess
import sys


def bounded_subprocess_probe(code: str, timeout_s: int) -> "tuple[bool, str]":
    """Run ``code`` in a fresh interpreter with a hard timeout.

    Returns ``(ok, message)``: on success the probe's stdout, on timeout or
    failure a diagnostic (the last 200 characters of stderr, else stdout).
    One implementation, so the kill, timeout and truncation behaviour cannot
    drift between callers.
    """
    try:
        proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                              text=True, timeout=timeout_s)
    except subprocess.TimeoutExpired:
        return False, f"probe hung > {timeout_s}s (wedged device?)"
    if proc.returncode != 0:
        return False, (proc.stderr or proc.stdout).strip()[-200:]
    return True, proc.stdout.strip()
