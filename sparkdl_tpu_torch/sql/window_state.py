"""Checkpointable window-aggregation state for continuous queries.

A standing windowed query (``GROUP BY WINDOW(event_time, '10s')``) must
survive a SIGKILL at any instant without losing rows that were consumed
past the source's committed offset but whose windows have not closed
yet.  The :class:`WindowStateStore` holds exactly that state — one
accumulator set per ``(window, group-key)`` pair — and every accumulator
is **JSON-native** (numbers, lists, None), so the whole store round-trips
through the commit log's payload files byte-identically:
``restore(snapshot())`` is an identity, and a restart re-aggregates
*nothing* — it resumes from the checkpointed accumulators.

This is deliberately NOT :data:`sparkdl_tpu_torch.sql.dataframe._AGG_SPECS`
(whose accumulators use sets/tuples for speed and never leave the
process); the two share fn keys and semantics, pinned against each other
by the continuous-SQL tests.

Window assignment follows the standard tumbling/sliding model: a row
with event time ``t`` belongs to every window ``[start, start+size)``
with ``start ≡ 0 (mod slide)`` and ``start <= t < start+size``.
Tumbling is the ``slide == size`` special case (exactly one window per
row).
"""

from __future__ import annotations

import json
import math
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple


class WindowAggSpec(NamedTuple):
    """One aggregate over one window's rows.  ``init`` returns a fresh
    JSON-native accumulator; ``update`` folds one non-null value;
    ``final`` produces the emitted cell.  NULLs are dropped before
    ``update`` (Spark aggregate semantics), so ``count`` counts non-null
    values and ``count(*)`` counts rows via the per-window row counter.
    """

    init: Callable[[], Any]
    update: Callable[[Any, Any], Any]
    final: Callable[[Any], Any]


def _percentile(p: float) -> WindowAggSpec:
    """Linear-interpolation percentile (numpy's default ``linear``
    method) over the window's collected values — windows are bounded in
    event time, so the value list is bounded by the window span times
    the row rate."""

    def final(acc: List[float]) -> Optional[float]:
        if not acc:
            return None
        vals = sorted(acc)
        rank = (len(vals) - 1) * (p / 100.0)
        lo = math.floor(rank)
        hi = math.ceil(rank)
        if lo == hi:
            return float(vals[int(rank)])
        return float(vals[lo] + (vals[hi] - vals[lo]) * (rank - lo))

    return WindowAggSpec(
        list, lambda a, v: (a.append(float(v)), a)[1], final
    )


#: fn key -> spec; the continuous mirror of the bounded plane's
#: ``_AGG_SPECS`` subset that makes sense over unbounded input
WINDOW_AGG_SPECS: Dict[str, WindowAggSpec] = {
    "count": WindowAggSpec(
        lambda: 0, lambda a, v: a + 1, lambda a: a
    ),
    "sum": WindowAggSpec(
        # [total, seen]: SUM of zero non-null values is NULL, not 0
        lambda: [0.0, 0],
        lambda a, v: [a[0] + v, a[1] + 1],
        lambda a: a[0] if a[1] else None,
    ),
    "avg": WindowAggSpec(
        lambda: [0.0, 0],
        lambda a, v: [a[0] + v, a[1] + 1],
        lambda a: (a[0] / a[1]) if a[1] else None,
    ),
    "min": WindowAggSpec(
        lambda: None,
        lambda a, v: v if a is None or v < a else a,
        lambda a: a,
    ),
    "max": WindowAggSpec(
        lambda: None,
        lambda a, v: v if a is None or v > a else a,
        lambda a: a,
    ),
    "collect_list": WindowAggSpec(
        list, lambda a, v: (a.append(v), a)[1], lambda a: a
    ),
    "p50": _percentile(50.0),
    "p90": _percentile(90.0),
    "p95": _percentile(95.0),
    "p99": _percentile(99.0),
}
WINDOW_AGG_SPECS["mean"] = WINDOW_AGG_SPECS["avg"]


def parse_duration_ms(text: str) -> float:
    """``'10s'`` / ``'500ms'`` / ``'2m'`` / ``'1h'`` (or a bare number,
    read as milliseconds) -> milliseconds.  Raises ``ValueError`` on
    anything else — a silently misparsed window size would aggregate
    into the wrong buckets forever."""
    t = text.strip().lower()
    for suffix, scale in (
        ("ms", 1.0), ("s", 1000.0), ("m", 60_000.0), ("h", 3_600_000.0),
    ):
        if t.endswith(suffix):
            body = t[: -len(suffix)].strip()
            try:
                v = float(body)
            except ValueError:
                break
            if v <= 0:
                raise ValueError(
                    f"window duration must be positive, got {text!r}"
                )
            return v * scale
    try:
        v = float(t)
    except ValueError:
        raise ValueError(
            f"unparseable window duration {text!r}; use e.g. '10s', "
            "'500ms', '2m', '1h', or a bare millisecond count"
        ) from None
    if v <= 0:
        raise ValueError(f"window duration must be positive, got {text!r}")
    return v


def assign_windows(
    event_time_ms: float, size_ms: float, slide_ms: float,
) -> List[Tuple[float, float]]:
    """Every ``(start_ms, end_ms)`` window containing ``event_time_ms``.
    Tumbling (``slide == size``) yields exactly one; a sliding window
    yields ``ceil(size / slide)`` of them."""
    t = float(event_time_ms)
    # first window start at or before t, aligned to the slide grid
    first = math.floor(t / slide_ms) * slide_ms
    out: List[Tuple[float, float]] = []
    start = first
    while start + size_ms > t:
        out.append((start, start + size_ms))
        start -= slide_ms
    out.reverse()
    return out


def _state_key(window: Tuple[float, float], keys: Tuple) -> str:
    """A JSON string key: dict keys must be strings to survive the
    payload round-trip, and json.dumps of a flat list is canonical
    enough (group keys are hashable scalars, enforced on update)."""
    return json.dumps([window[0], window[1], list(keys)])


class WindowStateStore:
    """Open-window accumulators, snapshot/restore-able through JSON.

    One entry per ``(window, group-key tuple)``; each entry carries the
    per-aggregate accumulators plus a row count (``count(*)``).
    :meth:`close_upto` finalizes and removes every window whose end is
    at or behind the watermark, returning emission-ready result rows in
    deterministic ``(window_start, group keys)`` order — the byte-
    identity anchor for the exactly-once tests.
    """

    def __init__(self, aggs: List[Tuple[str, str]]):
        """``aggs``: ``(label, fn_key)`` per aggregate, in SELECT
        order.  ``fn_key`` must be in :data:`WINDOW_AGG_SPECS`."""
        for label, fn_key in aggs:
            if fn_key not in WINDOW_AGG_SPECS:
                raise ValueError(
                    f"unsupported window aggregate {fn_key!r} (for "
                    f"{label!r}); supported: {sorted(WINDOW_AGG_SPECS)}"
                )
        self._aggs = list(aggs)
        self._specs = [WINDOW_AGG_SPECS[k] for _, k in aggs]
        # state key -> {"w": [start, end], "k": [...], "n": rows,
        #               "a": [acc per agg]}
        self._state: Dict[str, Dict[str, Any]] = {}

    # ------------------------------------------------------------------
    def update(
        self,
        window: Tuple[float, float],
        keys: Tuple,
        values: List[Any],
    ) -> None:
        """Fold one row into ``window``'s accumulators for group
        ``keys``.  ``values`` is row-aligned with the agg list; None
        values are skipped (NULL semantics), the row always counts."""
        for k in keys:
            if isinstance(k, (dict, list)):
                raise TypeError(
                    f"unhashable group key value {k!r}; window group "
                    "keys must be scalars"
                )
        skey = _state_key(window, keys)
        entry = self._state.get(skey)
        if entry is None:
            entry = self._state[skey] = {
                "w": [window[0], window[1]],
                "k": list(keys),
                "n": 0,
                "a": [s.init() for s in self._specs],
            }
        entry["n"] += 1
        for i, (spec, v) in enumerate(zip(self._specs, values)):
            if v is not None:
                entry["a"][i] = spec.update(entry["a"][i], v)

    # ------------------------------------------------------------------
    def close_upto(self, watermark_ms: Optional[float]) -> List[dict]:
        """Finalize + remove every window with ``end <= watermark``.
        Returns result rows ``{"window_start", "window_end", <keys are
        merged by the caller>, "rows", "aggs": [...]}`` sorted by
        (window_start, stringified keys) — deterministic regardless of
        arrival order, so two runs over the same input emit identical
        bytes."""
        if watermark_ms is None:
            return []
        closing = [
            (skey, e) for skey, e in self._state.items()
            if e["w"][1] <= watermark_ms
        ]
        closing.sort(key=lambda kv: (kv[1]["w"][0], json.dumps(kv[1]["k"])))
        out = []
        for skey, e in closing:
            del self._state[skey]
            out.append({
                "window_start": e["w"][0],
                "window_end": e["w"][1],
                "keys": list(e["k"]),
                "rows": e["n"],
                "aggs": [
                    spec.final(acc)
                    for spec, acc in zip(self._specs, e["a"])
                ],
            })
        return out

    # ------------------------------------------------------------------
    @property
    def open_windows(self) -> int:
        """Distinct open ``(window, key)`` entries — what the
        ``csql.open_windows`` gauge exports."""
        return len(self._state)

    def earliest_open_ms(self) -> Optional[float]:
        if not self._state:
            return None
        return min(e["w"][0] for e in self._state.values())

    # ------------------------------------------------------------------
    # checkpointing
    # ------------------------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        """JSON-native deep copy of the open-window state (rides inside
        each commit-log payload, next to the epoch's closed windows)."""
        return json.loads(json.dumps({
            "aggs": [list(a) for a in self._aggs],
            "state": self._state,
        }))

    def restore(self, snap: Optional[Dict[str, Any]]) -> None:
        """Replace the open-window state with ``snap`` (a prior
        :meth:`snapshot`).  The agg list must match the plan's — a
        checkpoint from a *different* query must fail loudly, not
        aggregate garbage."""
        if not snap:
            return
        snap_aggs = [tuple(a) for a in snap.get("aggs", [])]
        if snap_aggs != [tuple(a) for a in self._aggs]:
            raise ValueError(
                f"window-state checkpoint was written by a different "
                f"query: checkpoint aggregates {snap_aggs} vs plan "
                f"{self._aggs}; use a fresh checkpoint directory"
            )
        self._state = json.loads(json.dumps(snap.get("state", {})))
