"""Crash flight recorder: the last N seconds of telemetry, on disk,
even when the process dies without a word.

Port of ``sparkdl_tpu.obs.blackbox`` (host code: a copy with the package
renamed). While armed, a recorder keeps bounded in-memory rings of recent
spans, breadcrumb events and metric snapshots, and **persists them
continuously**: an atomic write-tmp-then-rename of ``blackbox-<pid>.json``
every ``interval_s``, so even SIGKILL (which no handler can observe)
leaves the last completed dump on disk. Event dumps (unhandled crash,
watchdog hard timeout, circuit-breaker open, ``Preempted``, SLO page)
write separate ``blackbox-<pid>-<reason>-<n>.json`` files, capped at
``max_dumps`` per process so a crash loop cannot fill the disk.

Every dump carries all-thread stack traces (``sys._current_frames``);
:meth:`FlightRecorder.arm` additionally chains ``sys.excepthook`` /
``threading.excepthook`` (unhandled crash → dump with the traceback)
and arms ``faulthandler``: hard faults (SIGSEGV/SIGABRT) and an
optional repeating stall timer dump native-level stacks into
``fault-<pid>.txt`` in the same directory.

Zero-code arming mirrors ``SPARKDL_TRACE_OUT``: setting
``SPARKDL_BLACKBOX_DIR`` arms a process-wide recorder at import time
(``SPARKDL_BLACKBOX_INTERVAL_S`` / ``SPARKDL_BLACKBOX_STALL_S`` tune
it).  Low layers (``resilience``) reach it only through the module-level
:func:`note` / :func:`dump`, which are no-ops while disarmed — the same
pay-nothing posture as tracing.
"""

from __future__ import annotations

import faulthandler
import json
import os
import sys
import threading
import time
import traceback
from collections import deque
from typing import Any, Dict, List, Optional

from sparkdl_tpu_torch.utils.metrics import MetricsRegistry, metrics

ENV_DIR = "SPARKDL_BLACKBOX_DIR"
ENV_INTERVAL = "SPARKDL_BLACKBOX_INTERVAL_S"
ENV_STALL = "SPARKDL_BLACKBOX_STALL_S"

#: the armed process-wide recorder, if any (see :func:`enable_from_env`)
_recorder: "Optional[FlightRecorder]" = None


def _thread_stacks() -> Dict[str, List[str]]:
    """``{thread name: [stack lines]}`` for every live thread."""
    names = {t.ident: t.name for t in threading.enumerate()}
    out: Dict[str, List[str]] = {}
    for ident, frame in sys._current_frames().items():
        label = f"{names.get(ident, 'unknown')} (ident={ident})"
        out[label] = [
            line.rstrip("\n")
            for line in traceback.format_stack(frame)
        ]
    return out


class FlightRecorder:
    """Bounded rings of spans/events/metric samples with atomic dumps.

    The instance is a tracer sink (``tracer.add_sink(recorder)``
    delivers every finished span into the span ring).  ``start()``
    launches the periodic persist thread; ``arm()`` installs the crash
    hooks.  All public methods are safe from any thread, including
    exception hooks.
    """

    def __init__(
        self,
        out_dir: str,
        span_capacity: int = 512,
        event_capacity: int = 256,
        sample_capacity: int = 120,
        interval_s: float = 0.5,
        max_dumps: int = 16,
        registry: Optional[MetricsRegistry] = None,
    ):
        if interval_s <= 0:
            raise ValueError(f"interval_s must be > 0, got {interval_s}")
        self.out_dir = str(out_dir)
        os.makedirs(self.out_dir, exist_ok=True)
        self.interval_s = float(interval_s)
        self.max_dumps = int(max_dumps)
        self._registry = registry if registry is not None else metrics
        self._lock = threading.Lock()
        self._spans: deque = deque(maxlen=int(span_capacity))
        self._events: deque = deque(maxlen=int(event_capacity))
        self._samples: deque = deque(maxlen=int(sample_capacity))
        self._dumps = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._fault_file = None
        self._prev_excepthook = None
        self._prev_threading_hook = None
        self._started_wall = time.time()

    # ------------------------------------------------------------------
    # recording
    # ------------------------------------------------------------------
    def __call__(self, span_dict: Dict[str, Any]) -> None:
        """Accept one finished span (the Tracer sink protocol)."""
        with self._lock:
            self._spans.append(span_dict)

    def note(self, name: str, **attrs: Any) -> None:
        """Append one breadcrumb (breaker flip, watchdog soft timeout,
        SLO transition) with a wall timestamp."""
        evt = {"name": name, "time_unix_s": round(time.time(), 3), **attrs}
        with self._lock:
            self._events.append(evt)

    def sample_metrics(self) -> None:
        """Append one registry snapshot to the sample ring — the
        "last-N-seconds telemetry" a post-mortem reads rate deltas
        from."""
        snap = self._registry.snapshot()  # registry locks internally
        row = {"time_unix_s": round(time.time(), 3), "metrics": snap}
        with self._lock:
            self._samples.append(row)

    # ------------------------------------------------------------------
    # dumping
    # ------------------------------------------------------------------
    def _payload(self, reason: str, exc: Optional[BaseException]) -> Dict:
        with self._lock:
            spans = list(self._spans)
            events = list(self._events)
            samples = list(self._samples)
        payload: Dict[str, Any] = {
            "reason": reason,
            "pid": os.getpid(),
            "argv": list(sys.argv),
            "started_unix_s": round(self._started_wall, 3),
            "dumped_unix_s": round(time.time(), 3),
            "threads": _thread_stacks(),
            "spans": spans,
            "events": events,
            "metric_samples": samples,
            "metrics_now": self._registry.snapshot(),
        }
        # when the env-armed sampling profiler is running, the dump
        # carries its folded stacks too: an SLO page then shows WHERE
        # the fleet was spending time, not just that it stalled
        try:
            from sparkdl_tpu_torch.obs import profile as _profile

            prof = _profile.profiler()
            if prof is not None:
                payload["profile"] = prof.snapshot()
        except Exception:  # never turn a dump into a crash
            pass
        if exc is not None:
            payload["exception"] = {
                "type": type(exc).__name__,
                "message": str(exc),
                "traceback": traceback.format_exception(
                    type(exc), exc, exc.__traceback__
                ),
            }
        return payload

    def dump(
        self, reason: str = "manual",
        exc: Optional[BaseException] = None,
    ) -> Optional[str]:
        """Atomically write one dump; returns its path.

        ``reason="periodic"`` overwrites the per-process steady file
        (what survives SIGKILL); any other reason writes a fresh
        ``blackbox-<pid>-<reason>-<n>.json``, bounded by ``max_dumps``.
        Never raises — a recorder must not turn a crash into a different
        crash."""
        try:
            if reason == "periodic":
                path = os.path.join(
                    self.out_dir, f"blackbox-{os.getpid()}.json"
                )
            else:
                with self._lock:
                    if self._dumps >= self.max_dumps:
                        return None
                    self._dumps += 1
                    n = self._dumps
                safe = "".join(
                    c if c.isalnum() or c in "._-" else "_" for c in reason
                )
                path = os.path.join(
                    self.out_dir,
                    f"blackbox-{os.getpid()}-{safe}-{n}.json",
                )
            payload = self._payload(reason, exc)
            tmp = f"{path}.tmp.{os.getpid()}"
            with open(tmp, "w") as fh:
                json.dump(payload, fh, default=str)
                fh.flush()
                os.fsync(fh.fileno())
            os.replace(tmp, path)  # atomic: readers never see a torn file
            return path
        except Exception:  # pragma: no cover - defensive by contract
            return None

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------
    def start(self) -> "FlightRecorder":
        """Launch the periodic sample+persist thread (idempotent)."""
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return self
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, name="sparkdl-blackbox", daemon=True
            )
            self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            self.sample_metrics()
            self.dump("periodic")

    def stop(self) -> None:
        self._stop.set()
        with self._lock:
            thread = self._thread
            self._thread = None
        if thread is not None and thread.is_alive():
            thread.join(timeout=max(2.0, 2 * self.interval_s))

    def arm(self, stall_timeout_s: Optional[float] = None) -> "FlightRecorder":
        """Install the crash hooks: chained ``sys.excepthook`` and
        ``threading.excepthook`` (dump with the exception), a
        ``faulthandler`` fault file for hard signals, and — when
        ``stall_timeout_s`` is given — a repeating stall timer that
        dumps all-thread native stacks into the fault file whenever the
        main thread stays wedged past the timeout."""
        self._prev_excepthook = sys.excepthook

        def excepthook(exc_type, exc, tb):
            err = exc if isinstance(exc, BaseException) else exc_type(exc)
            self.dump("crash", exc=err)
            if callable(self._prev_excepthook):
                self._prev_excepthook(exc_type, exc, tb)

        sys.excepthook = excepthook

        self._prev_threading_hook = threading.excepthook

        def thread_hook(args):
            if args.exc_type is not SystemExit:
                self.dump("thread_crash", exc=args.exc_value)
            if callable(self._prev_threading_hook):
                self._prev_threading_hook(args)

        threading.excepthook = thread_hook

        try:
            self._fault_file = open(
                os.path.join(self.out_dir, f"fault-{os.getpid()}.txt"), "w"
            )
            faulthandler.enable(file=self._fault_file)
            if stall_timeout_s is not None and stall_timeout_s > 0:
                faulthandler.dump_traceback_later(
                    float(stall_timeout_s), repeat=True,
                    file=self._fault_file,
                )
        except Exception:  # pragma: no cover - faulthandler is optional
            self._fault_file = None
        return self

    def disarm(self) -> None:
        """Undo :meth:`arm` (tests restore the interpreter's hooks)."""
        if self._prev_excepthook is not None:
            sys.excepthook = self._prev_excepthook
            self._prev_excepthook = None
        if self._prev_threading_hook is not None:
            threading.excepthook = self._prev_threading_hook
            self._prev_threading_hook = None
        if self._fault_file is not None:
            try:
                faulthandler.cancel_dump_traceback_later()
                faulthandler.disable()
                self._fault_file.close()
            except Exception:  # pragma: no cover
                pass
            self._fault_file = None

    def __repr__(self):
        with self._lock:
            return (
                f"FlightRecorder(dir={self.out_dir!r}, "
                f"spans={len(self._spans)}, events={len(self._events)}, "
                f"samples={len(self._samples)}, dumps={self._dumps})"
            )


# ---------------------------------------------------------------------------
# process-wide arming (env hook + the no-op-when-disarmed module API)
# ---------------------------------------------------------------------------

def recorder() -> Optional[FlightRecorder]:
    """The armed process-wide recorder, if any."""
    return _recorder


def note(name: str, **attrs: Any) -> None:
    """Breadcrumb into the armed recorder; no-op while disarmed — the
    one-line hook low layers (``resilience``) call unconditionally."""
    rec = _recorder
    if rec is not None:
        rec.note(name, **attrs)


def dump(reason: str, exc: Optional[BaseException] = None) -> Optional[str]:
    """Event dump through the armed recorder; None while disarmed."""
    rec = _recorder
    if rec is not None:
        return rec.dump(reason, exc=exc)
    return None


def enable_from_env() -> Optional[FlightRecorder]:
    """Arm the process-wide recorder when ``SPARKDL_BLACKBOX_DIR`` is
    set: rings + periodic persist + crash hooks + tracer sink.  Called
    from ``sparkdl_tpu_torch/__init__`` at import time (the same zero-code
    posture as ``SPARKDL_TRACE_OUT``); idempotent."""
    global _recorder
    out_dir = os.environ.get(ENV_DIR)
    if not out_dir or _recorder is not None:
        return _recorder
    interval = float(os.environ.get(ENV_INTERVAL, "") or 0.5)
    stall_spec = os.environ.get(ENV_STALL, "").strip()
    stall = float(stall_spec) if stall_spec else None
    rec = FlightRecorder(out_dir, interval_s=interval)
    rec.arm(stall_timeout_s=stall)
    rec.start()
    # spans flow into the ring whenever tracing is (or later becomes)
    # enabled; add_sink alone never enables tracing
    from sparkdl_tpu_torch.obs.trace import tracer

    tracer.add_sink(rec)
    _recorder = rec
    return rec
