"""Trace/metric export: bounded JSONL trace sink + Prometheus text.

Port of ``sparkdl_tpu.obs.export`` (host code: a copy with the package
renamed). Two formats, one module:

- :class:`JsonlTraceSink`: finished spans as one JSON object per line,
  held in a BOUNDED ring buffer (a trace sink must never become the memory
  leak it was supposed to diagnose): when full, the oldest span drops and
  ``dropped`` counts it. ``flush(path)`` appends the buffer to a file, what
  the ``SPARKDL_TRACE_OUT`` hook writes at exit;
- :func:`prometheus_text`: the ``MetricsRegistry`` in the Prometheus text
  exposition format: counters and gauges as they are, timers as
  ``*_seconds_total`` and ``*_entries_total``, histograms as summaries with
  p50/p95/p99 ``quantile`` labels from the sliding window of
  :class:`~sparkdl_tpu_torch.utils.metrics.Histogram` and their exemplar as
  a comment line. Dotted names map to underscores.
"""

from __future__ import annotations

import json
import re
import threading
from collections import deque
from typing import Any, Dict, List, Optional

from sparkdl_tpu_torch.utils.metrics import MetricsRegistry, metrics

#: Prometheus metric names: [a-zA-Z_:][a-zA-Z0-9_:]* — our dotted
#: ``subsystem.name`` convention maps every other character to "_"
_PROM_BAD = re.compile(r"[^a-zA-Z0-9_:]")

#: the quantiles the summary lines export (same set Histogram snapshots)
_QUANTILES = (0.5, 0.95, 0.99)


class JsonlTraceSink:
    """Bounded in-memory span buffer with JSONL flush.

    Register with ``tracer.enable(sink)`` / ``tracer.add_sink(sink)``
    (the sink is the callable itself).  ``capacity`` bounds memory: the
    buffer keeps the most recent spans and counts what it dropped —
    tests read ``spans()``, a run ``flush()``-es to a path.
    """

    def __init__(self, path: Optional[str] = None, capacity: int = 4096):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.path = path
        self.capacity = int(capacity)
        self._lock = threading.Lock()
        self._buffer: "deque[Dict[str, Any]]" = deque(maxlen=self.capacity)
        self._dropped = 0
        self._emitted = 0

    def __call__(self, span_dict: Dict[str, Any]) -> None:
        """Accept one finished span (the Tracer sink protocol)."""
        with self._lock:
            if len(self._buffer) == self.capacity:
                self._dropped += 1
            self._buffer.append(span_dict)
            self._emitted += 1

    @property
    def dropped(self) -> int:
        with self._lock:
            return self._dropped

    @property
    def emitted(self) -> int:
        with self._lock:
            return self._emitted

    def __len__(self) -> int:
        with self._lock:
            return len(self._buffer)

    def spans(self) -> List[Dict[str, Any]]:
        """A copy of the buffered spans, oldest first."""
        with self._lock:
            return list(self._buffer)

    def find(self, name: str) -> List[Dict[str, Any]]:
        """Buffered spans with the given name (test convenience)."""
        return [s for s in self.spans() if s.get("name") == name]

    def flush(self, path: Optional[str] = None) -> int:
        """Append the buffered spans to ``path`` (default: the sink's
        configured path) as JSONL and clear the buffer; returns the
        number of spans written.  Append mode on purpose: subprocess
        workers under ``SPARKDL_TRACE_OUT`` share one file."""
        target = path or self.path
        if target is None:
            raise ValueError("JsonlTraceSink.flush needs a path")
        with self._lock:
            drained = list(self._buffer)
            self._buffer.clear()
        if not drained:
            return 0
        with open(target, "a") as fh:
            for span in drained:
                fh.write(json.dumps(span, default=str) + "\n")
        return len(drained)

    def clear(self) -> None:
        with self._lock:
            self._buffer.clear()
            self._dropped = 0
            self._emitted = 0


def _prom_name(name: str) -> str:
    return _PROM_BAD.sub("_", name)


def _escape_help(text: str) -> str:
    """HELP-line escaping per the exposition format: backslash and
    newline (HELP text is not quoted, so quotes pass through)."""
    return text.replace("\\", "\\\\").replace("\n", "\\n")


def _escape_label_value(value: Any) -> str:
    """Label-value escaping per the exposition format: backslash,
    double-quote, newline — in that order."""
    return (
        str(value)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


def _help_line(pn: str, dotted: str, kind: str) -> str:
    # "<kind> <dotted registry name>": points scrapers back at the
    # in-process name without leaking extra words into filtered views
    return f"# HELP {pn} {_escape_help(f'{kind} {dotted}')}"


def prometheus_text(registry: Optional[MetricsRegistry] = None,
                    prefix: Optional[str] = None) -> str:
    """The registry in the Prometheus text exposition format.

    One consistent point-in-time read through
    :meth:`MetricsRegistry.collect` — no poking at registry internals.
    ``prefix`` filters by dotted metric-name prefix (e.g. ``"serving."``
    for a ``ModelServer`` ``/metrics`` endpoint).
    """
    registry = registry if registry is not None else metrics
    view = registry.collect()

    def keep(name: str) -> bool:
        return prefix is None or name.startswith(prefix)

    lines: List[str] = []
    for name, c in sorted(view["counters"].items()):
        if not keep(name):
            continue
        pn = _prom_name(name)
        lines.append(_help_line(pn, name, "counter"))
        lines.append(f"# TYPE {pn} counter")
        lines.append(f"{pn} {c.value:g}")
    for name, g in sorted(view["gauges"].items()):
        if not keep(name):
            continue
        pn = _prom_name(name)
        lines.append(_help_line(pn, name, "gauge"))
        lines.append(f"# TYPE {pn} gauge")
        lines.append(f"{pn} {g.value:g}")
    for name, t in sorted(view["timers"].items()):
        if not keep(name):
            continue
        pn = _prom_name(name)
        lines.append(_help_line(f"{pn}_seconds_total", name, "timer"))
        lines.append(f"# TYPE {pn}_seconds_total counter")
        lines.append(f"{pn}_seconds_total {t.seconds:g}")
        lines.append(_help_line(f"{pn}_entries_total", name, "timer"))
        lines.append(f"# TYPE {pn}_entries_total counter")
        lines.append(f"{pn}_entries_total {t.entries:g}")
    for name, h in sorted(view["histograms"].items()):
        if not keep(name):
            continue
        pn = _prom_name(name)
        lines.append(_help_line(pn, name, "histogram"))
        lines.append(f"# TYPE {pn} summary")
        for q in _QUANTILES:
            v = h.quantile(q)
            if v is not None:
                label = _escape_label_value(f"{q:g}")
                lines.append(f'{pn}{{quantile="{label}"}} {v:g}')
        lines.append(f"{pn}_sum {h.total:g}")
        lines.append(f"{pn}_count {h.count:g}")
        ex = h.exemplar()
        if ex is not None:
            # exemplar as a comment line, not OpenMetrics `# {...}`
            # mid-line syntax: the text-format parsers in this repo (and
            # plain Prometheus scrapers) must keep seeing valid lines,
            # and a comment is the one forward-compatible place to put
            # a 63-bit trace id without float-mangling it
            lines.append(
                f"# EXEMPLAR {pn} trace_id={ex[1]:d} value={ex[0]:g}"
            )
    return "\n".join(lines) + ("\n" if lines else "")
