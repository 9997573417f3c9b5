"""Exactly-once commit machinery: payload-then-marker log + idempotent sinks.

Port of ``sparkdl_tpu.streaming.commit`` (host code: a copy with the
package renamed). The delivery contract is the estimator checkpoints'
(``estimators/checkpointing.py``): write the **payload** first, then an
atomic **commit marker**, and on restart treat a payload
without a marker as *uncertain* — replay it idempotently, never skip it
and never double it.  Per micro-batch the
:class:`~sparkdl_tpu_torch.streaming.runner.StreamRunner` runs:

1. ``log.write_payload(epoch, {records, end_offset, ...})``  (atomic
   tmp + ``os.replace``);
2. ``sink.write(epoch, records)``  (idempotent per epoch);
3. ``log.commit(epoch)``  (atomic marker).

A death after (1) replays (2)+(3) from the stored payload — the sink
sees the epoch at-least-once but keeps exactly one copy; a death after
(3) never replays.  Source offsets ride inside the payload, so the
commit marker is simultaneously the offset checkpoint.
"""

from __future__ import annotations

import json
import os
import re
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

_PAYLOAD_RE = re.compile(r"^epoch_(\d{8})\.payload\.json$")
_MARKER_RE = re.compile(r"^epoch_(\d{8})\.commit$")


def _atomic_write_json(path: str, doc: Any) -> None:
    """Write ``doc`` as JSON such that ``path`` either doesn't exist or
    holds the complete document — never a torn prefix (tmp file in the
    same directory + ``os.replace``, the estimator checkpoint rule)."""
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as fh:
        json.dump(doc, fh)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, path)


class CommitLog:
    """Per-epoch payload + commit-marker files under one directory.

    Epoch ids are dense and 1-based (epoch ``e+1`` follows ``e``); the
    log does not enforce density — the runner owns the numbering — but
    :meth:`pending` returns *every* payload-without-marker in order so
    recovery replays whatever the crash left behind.
    """

    def __init__(self, log_dir: str):
        self.log_dir = os.path.abspath(str(log_dir))
        os.makedirs(self.log_dir, exist_ok=True)

    # -- paths ---------------------------------------------------------
    def _payload_path(self, epoch: int) -> str:
        return os.path.join(self.log_dir, f"epoch_{epoch:08d}.payload.json")

    def _marker_path(self, epoch: int) -> str:
        return os.path.join(self.log_dir, f"epoch_{epoch:08d}.commit")

    def _scan(self) -> Tuple[List[int], List[int]]:
        payloads, markers = [], []
        for name in os.listdir(self.log_dir):
            m = _PAYLOAD_RE.match(name)
            if m:
                payloads.append(int(m.group(1)))
                continue
            m = _MARKER_RE.match(name)
            if m:
                markers.append(int(m.group(1)))
        return sorted(payloads), sorted(markers)

    # -- writes --------------------------------------------------------
    def write_payload(self, epoch: int, payload: Dict[str, Any]) -> None:
        """Atomically persist ``payload`` for ``epoch`` (step 1 of the
        protocol).  The payload must be JSON-serializable and carries
        everything replay needs — notably the sink records themselves,
        so a replayed epoch re-emits bit-identical content without
        re-scoring."""
        _atomic_write_json(self._payload_path(int(epoch)), payload)

    def commit(self, epoch: int) -> None:
        """Atomically drop the commit marker for ``epoch`` (step 3);
        requires the payload to exist — a marker without its payload
        would make the epoch unverifiable."""
        epoch = int(epoch)
        if not os.path.exists(self._payload_path(epoch)):
            raise ValueError(
                f"commit({epoch}) before write_payload({epoch}) — the "
                "payload-then-marker order is the whole guarantee"
            )
        _atomic_write_json(self._marker_path(epoch), {"epoch": epoch})

    # -- reads ---------------------------------------------------------
    def payload(self, epoch: int) -> Dict[str, Any]:
        with open(self._payload_path(int(epoch))) as fh:
            return json.load(fh)

    def committed_epochs(self) -> List[int]:
        _, markers = self._scan()
        return markers

    def last_committed(self) -> Optional[int]:
        """Highest epoch whose marker exists, or None for a fresh log."""
        _, markers = self._scan()
        return markers[-1] if markers else None

    def pending(self) -> List[int]:
        """Epochs with a payload but no marker, in order — the uncertain
        set a restart must replay (sink write may or may not have
        happened; idempotent re-write resolves it)."""
        payloads, markers = self._scan()
        committed = set(markers)
        return [e for e in payloads if e not in committed]

    def resume_offset(self) -> Optional[int]:
        """The source offset recovery should seek to: the ``end_offset``
        of the highest payload (committed or pending — pending epochs
        are replayed from their stored records, never re-polled), or
        None for a fresh log."""
        payloads, _ = self._scan()
        if not payloads:
            return None
        return self.payload(payloads[-1]).get("end_offset")

    def describe(self) -> Dict[str, Any]:
        payloads, markers = self._scan()
        return {
            "log_dir": self.log_dir,
            "payloads": len(payloads),
            "committed": len(markers),
            "pending": [e for e in payloads if e not in set(markers)],
            "last_committed": markers[-1] if markers else None,
        }


# ---------------------------------------------------------------------------
# sinks
# ---------------------------------------------------------------------------


class Sink:
    """Protocol for exactly-once record sinks.

    ``write(epoch, records)`` must be **idempotent per epoch**: writing
    the same epoch twice (a recovery replay) leaves exactly one copy.
    Records are the JSON-serializable dicts the runner emitted for that
    epoch, in order.
    """

    def write(self, epoch: int, records: List[Dict[str, Any]]) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass


class JsonlSink(Sink):
    """Append-only JSONL file with per-epoch idempotent rewrite.

    Every line is ``{"epoch": N, ...record}``.  On open the file is
    scanned once to index where each epoch's lines begin (and a torn
    final line from a crashed append is truncated away); a replayed
    ``write(epoch, ...)`` truncates back to that epoch's start before
    re-appending — so a crash anywhere between the runner's payload
    write and its commit marker leaves, after replay, exactly one copy
    of the epoch's records.  ``fsync`` on every write: the sink is the
    durability boundary the commit marker vouches for.
    """

    def __init__(self, path: str):
        self.path = str(path)
        self._lock = threading.Lock()
        self._epoch_starts: Dict[int, int] = {}
        self._end = 0
        self._recover_index()

    def _recover_index(self) -> None:
        if not os.path.exists(self.path):
            return
        valid_end = 0
        starts: Dict[int, int] = {}
        with open(self.path, "rb") as fh:
            pos = 0
            for line in fh:
                if not line.endswith(b"\n"):
                    break  # torn tail from a crashed append
                try:
                    epoch = int(json.loads(line)["epoch"])
                except (ValueError, KeyError, TypeError):
                    break  # corrupt tail: truncate from here
                starts.setdefault(epoch, pos)
                pos += len(line)
                valid_end = pos
        self._epoch_starts = starts
        self._end = valid_end
        if os.path.getsize(self.path) != valid_end:
            with open(self.path, "rb+") as fh:
                fh.truncate(valid_end)

    def write(self, epoch: int, records: List[Dict[str, Any]]) -> None:
        epoch = int(epoch)
        with self._lock:
            if epoch in self._epoch_starts:
                # replay: drop this epoch (and anything after — commits
                # are ordered, so later lines can only be leftovers of a
                # crashed future epoch) and re-append
                cut = self._epoch_starts[epoch]
                with open(self.path, "rb+") as fh:
                    fh.truncate(cut)
                self._end = cut
                self._epoch_starts = {
                    e: s for e, s in self._epoch_starts.items() if s < cut
                }
            with open(self.path, "ab") as fh:
                start = self._end
                for rec in records:
                    doc = {"epoch": epoch}
                    doc.update(rec)
                    fh.write(json.dumps(doc).encode() + b"\n")
                fh.flush()
                os.fsync(fh.fileno())
                self._epoch_starts[epoch] = start
                self._end = fh.tell()

    def read_all(self) -> List[Dict[str, Any]]:
        """Every committed line as a dict (test/inspection helper)."""
        if not os.path.exists(self.path):
            return []
        out = []
        with open(self.path, "rb") as fh:
            for line in fh:
                if line.endswith(b"\n"):
                    out.append(json.loads(line))
        return out


class CallbackSink(Sink):
    """Deliver each epoch to a callable ``fn(epoch, records)``.

    Idempotence is per *process*: epochs already delivered through this
    instance are skipped on replay, which makes in-process recovery
    exactly-once.  Across a process restart the callback may see an
    uncertain epoch again (same epoch id, identical records) — consumers
    that need cross-process exactly-once must dedupe on the epoch id or
    use a durable sink like :class:`JsonlSink`.
    """

    def __init__(self, fn: Callable[[int, List[Dict[str, Any]]], None]):
        self._fn = fn
        self._lock = threading.Lock()
        self._delivered: set = set()

    def write(self, epoch: int, records: List[Dict[str, Any]]) -> None:
        epoch = int(epoch)
        with self._lock:
            if epoch in self._delivered:
                return
            self._delivered.add(epoch)
        try:
            self._fn(epoch, records)
        except BaseException:
            with self._lock:
                self._delivered.discard(epoch)
            raise
