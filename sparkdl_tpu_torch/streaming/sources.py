"""Unbounded pull-based stream sources + event-time watermarks.

Port of ``sparkdl_tpu.streaming.sources`` (host code: a copy with the
package renamed).

A :class:`StreamSource` is the streaming analog of a ``Dataset`` source:
it yields :class:`Record` tuples on :meth:`~StreamSource.poll` and —
crucially for exactly-once recovery — is **replayable**: ``seek(offset)``
rewinds to any previously returned resume point, so a restarted
:class:`~sparkdl_tpu_torch.streaming.runner.StreamRunner` re-reads exactly the
rows whose commit never landed.  Offsets are opaque monotonic integers
owned by the source (record index for :class:`QueueSource`, byte
position for :class:`FileTailSource`); a record's ``offset`` is the
position *after* it — i.e. the resume point that skips it.

Watermarks follow the standard bounded-lateness model (tf.data /
Structured Streaming): the watermark trails the maximum event time seen
by ``allowed_lateness_ms``, and a record whose event time falls behind
the watermark is *late* (counted, never dropped here — drop policy
belongs to the consumer).
"""

from __future__ import annotations

import json
import os
import threading
from typing import Any, List, NamedTuple, Optional

from sparkdl_tpu_torch.resilience.errors import PermanentError


class EventTimeError(PermanentError):
    """A source configured with ``event_time_field`` met a row where
    that field is absent or non-numeric.  Permanent by nature (the bytes
    on disk do not heal on retry), and typed so a continuous query's
    operator can distinguish "bad event time" from "corrupt line"."""


class Record(NamedTuple):
    """One streamed row: the decoded ``value``, the source's resume
    ``offset`` *after* this record, and an optional event time
    (epoch milliseconds; None means the source carries no event time
    and arrival order is the only order)."""

    value: Any
    offset: int
    event_time_ms: Optional[float] = None


class StreamSource:
    """Protocol base for unbounded pull sources.

    Subclasses implement :meth:`poll` / :meth:`seek` / :meth:`position`;
    the optional hooks (:meth:`finished`, :meth:`backlog`,
    :meth:`close`) have safe defaults.  ``poll`` must be non-blocking:
    return ``[]`` when nothing is available — pacing belongs to the
    caller (the runner's idle wait), not the source.
    """

    def poll(self, max_records: int) -> List[Record]:
        """Up to ``max_records`` records from the current position
        (possibly empty), advancing the position past what is returned."""
        raise NotImplementedError

    def seek(self, offset: int) -> None:
        """Rewind/forward the read position to a resume point previously
        returned as some record's ``offset`` (0 = the stream's start)."""
        raise NotImplementedError

    def position(self) -> int:
        """The current resume point (what ``seek`` would need to re-read
        the next record)."""
        raise NotImplementedError

    def finished(self) -> bool:
        """True when the source will never produce another record —
        unbounded sources (the default) always return False."""
        return False

    def backlog(self) -> Optional[int]:
        """Source-units of data available beyond the current position
        (records for :class:`QueueSource`, bytes for
        :class:`FileTailSource`), or None when unknowable — feeds the
        ``streaming.consumer_lag`` gauge."""
        return None

    def close(self) -> None:
        pass


class QueueSource(StreamSource):
    """In-memory source for tests and generator threads.

    ``put`` appends; items are *retained* so ``seek`` can replay (this
    is a test/demo source, not a production buffer — memory grows with
    the stream).  ``end()`` marks the stream bounded: once drained,
    :meth:`finished` turns True and a runner's run loop can stop
    instead of idling forever.  Thread-safe: producers ``put`` from any
    thread while the runner's poller drains.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._items: List[Record] = []
        self._cursor = 0
        self._ended = False

    def put(self, value: Any, event_time_ms: Optional[float] = None) -> None:
        with self._lock:
            if self._ended:
                raise ValueError("QueueSource is ended; no more puts")
            self._items.append(
                Record(value, len(self._items) + 1, event_time_ms)
            )

    def put_all(self, values, event_time_ms: Optional[float] = None) -> None:
        for v in values:
            self.put(v, event_time_ms=event_time_ms)

    def end(self) -> None:
        """Declare the stream bounded (no further ``put`` allowed)."""
        with self._lock:
            self._ended = True

    def poll(self, max_records: int) -> List[Record]:
        with self._lock:
            out = self._items[self._cursor:self._cursor + int(max_records)]
            self._cursor += len(out)
            return out

    def seek(self, offset: int) -> None:
        with self._lock:
            if not 0 <= offset <= len(self._items):
                raise ValueError(
                    f"seek({offset}) outside [0, {len(self._items)}]"
                )
            self._cursor = int(offset)

    def position(self) -> int:
        with self._lock:
            return self._cursor

    def finished(self) -> bool:
        with self._lock:
            return self._ended and self._cursor >= len(self._items)

    def backlog(self) -> Optional[int]:
        with self._lock:
            return len(self._items) - self._cursor

    def __len__(self) -> int:
        with self._lock:
            return len(self._items)


class FileTailSource(StreamSource):
    """Tail a growing line-delimited file (JSONL by default).

    Offsets are byte positions, so a resume point is durable across
    processes — the replayable source the exactly-once recovery tests
    lean on.  Only *complete* lines (terminated by ``\\n``) are
    consumed: a writer's partial final line stays in the file for the
    next poll, and a file that does not exist yet polls empty instead
    of raising (the tail-before-first-write race).

    ``parse="json"`` decodes each line to its JSON value and reads the
    event time from ``event_time_field`` (epoch ms) when configured —
    a row where that field is absent or non-numeric raises
    :class:`EventTimeError` (a :class:`PermanentError`): configuring an
    event-time field declares the stream watermarked, and a silently
    ``None`` event time would make windows close around ghost rows.
    ``parse="raw"`` yields the undecoded line (no trailing newline).
    A line that fails to decode raises
    :class:`~sparkdl_tpu_torch.resilience.errors.PermanentError` — corrupt
    input does not heal on retry, and silently skipping it would break
    the sink-set-equals-source-set contract.
    """

    def __init__(
        self,
        path: str,
        parse: str = "json",
        event_time_field: Optional[str] = None,
        encoding: str = "utf-8",
    ):
        if parse not in ("json", "raw"):
            raise ValueError(f"parse must be 'json' or 'raw', got {parse!r}")
        self.path = str(path)
        self._parse = parse
        self._event_time_field = event_time_field
        self._encoding = encoding
        self._offset = 0

    def _decode(self, line: bytes, offset: int) -> Record:
        text = line.decode(self._encoding)
        if self._parse == "raw":
            return Record(text, offset)
        try:
            value = json.loads(text)
        except ValueError as e:
            from sparkdl_tpu_torch.resilience.errors import PermanentError

            raise PermanentError(
                f"undecodable JSONL line in {self.path!r} ending at byte "
                f"{offset}: {e}"
            ) from e
        event_time = None
        if self._event_time_field:
            raw = (
                value.get(self._event_time_field)
                if isinstance(value, dict) else None
            )
            if raw is None:
                raise EventTimeError(
                    f"configured event_time_field "
                    f"{self._event_time_field!r} is absent from the row "
                    f"in {self.path!r} ending at byte {offset} — a "
                    "watermarked stream cannot carry un-timestamped rows"
                )
            try:
                event_time = float(raw)
            except (TypeError, ValueError):
                raise EventTimeError(
                    f"event_time_field {self._event_time_field!r} in "
                    f"{self.path!r} at byte {offset} is non-numeric: "
                    f"{raw!r} (epoch milliseconds expected)"
                ) from None
        return Record(value, offset, event_time)

    def poll(self, max_records: int) -> List[Record]:
        try:
            size = os.path.getsize(self.path)
        except OSError:
            return []
        if size <= self._offset:
            return []
        with open(self.path, "rb") as fh:
            fh.seek(self._offset)
            chunk = fh.read(size - self._offset)
        out: List[Record] = []
        pos = self._offset
        start = 0
        while len(out) < int(max_records):
            nl = chunk.find(b"\n", start)
            if nl < 0:
                break  # partial final line: leave it for the next poll
            line = chunk[start:nl]
            start = nl + 1
            pos = self._offset + start
            if line.strip():
                out.append(self._decode(line, pos))
        self._offset = pos
        return out

    def seek(self, offset: int) -> None:
        if offset < 0:
            raise ValueError(f"seek({offset}) before start of file")
        self._offset = int(offset)

    def position(self) -> int:
        return self._offset

    def backlog(self) -> Optional[int]:
        try:
            return max(os.path.getsize(self.path) - self._offset, 0)
        except OSError:
            return 0


class WatermarkTracker:
    """Bounded-lateness event-time watermark.

    ``observe(event_time_ms)`` advances the high-water event time and
    returns whether the observed record was *late* (behind the watermark
    that existed before it arrived).  The watermark is
    ``max_event_time - allowed_lateness_ms`` — monotonic by
    construction, since the max never decreases.  Records without event
    times don't move it (a source with no event-time column simply has
    no watermark).  Thread-safe: the runner's poller observes while the
    main thread reads.
    """

    def __init__(self, allowed_lateness_ms: float = 0.0):
        if allowed_lateness_ms < 0:
            raise ValueError(
                f"allowed_lateness_ms must be >= 0, got {allowed_lateness_ms}"
            )
        self.allowed_lateness_ms = float(allowed_lateness_ms)
        self._lock = threading.Lock()
        self._max_event_ms: Optional[float] = None

    def observe(self, event_time_ms: Optional[float]) -> bool:
        if event_time_ms is None:
            return False
        t = float(event_time_ms)
        with self._lock:
            wm = (
                self._max_event_ms - self.allowed_lateness_ms
                if self._max_event_ms is not None
                else None
            )
            late = wm is not None and t < wm
            if self._max_event_ms is None or t > self._max_event_ms:
                self._max_event_ms = t
            return late

    @property
    def watermark_ms(self) -> Optional[float]:
        with self._lock:
            if self._max_event_ms is None:
                return None
            return self._max_event_ms - self.allowed_lateness_ms

    @property
    def max_event_time_ms(self) -> Optional[float]:
        with self._lock:
            return self._max_event_ms

    def lag_ms(self, now_ms: float) -> Optional[float]:
        """How far the watermark trails ``now_ms`` (wall epoch ms) —
        what the ``streaming.watermark_lag_ms`` gauge exports."""
        wm = self.watermark_ms
        if wm is None:
            return None
        return max(now_ms - wm, 0.0)
