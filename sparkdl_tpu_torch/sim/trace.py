"""Replay-ready trace format: one recorded request per JSONL line.

A trace holds what the simulator needs from a live run: each request's
arrival time, the router/replica latency decomposition off the reply
envelope (the phases), and the tenant/endpoint labels placement decisions
depend on. The file is a header line (``{"kind": "sparkdl_trace", ...}``:
the run's shape plus the live run's latency/phase summary, the fidelity
baseline) followed by one record per request, in arrival order. The format
is the JAX package's (``sparkdl_tpu.sim.trace``), byte for byte, so either
package reads a trace the other wrote. :func:`records_from_spans` builds
records from the router's ``router.request`` spans (``SPARKDL_TRACE_OUT``).

Phases split into two classes for replay (:mod:`sparkdl_tpu_torch.sim.replay`):

- **replayed**: device and wire time the simulator must not model:
  ``forward``, ``fetch``, ``wire``, ``transport``, ``ingress``, ``egress``,
  ``frontdoor``, ``cache``. Each replayed request reuses its own recorded
  values; synthetic extra attempts (hedges, retries) draw from the
  :class:`PhaseSampler`'s seeded empirical distribution instead.
- **emergent**: queueing the simulator re-derives from the real controllers
  under the candidate config: ``admission``, ``router_queue``,
  ``replica_queue``.
"""

from __future__ import annotations

import json
import random
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Optional, Tuple

#: phase durations replayed verbatim from the record (device + wire +
#: client-side hops the sim never re-executes)
REPLAYED_PHASES = (
    "forward", "fetch", "wire", "transport",
    "ingress", "egress", "frontdoor", "cache",
)

#: phase durations that re-emerge from the simulated queues
EMERGENT_PHASES = ("admission", "router_queue", "replica_queue")


@dataclass
class TraceRecord:
    """One recorded request: when it arrived, where it went, how long
    each phase took on the live run."""

    t: float                                  # arrival, s from run start
    endpoint: str = "ep0"
    tenant: Optional[str] = None
    outcome: str = "ok"
    latency_ms: Optional[float] = None
    server_ms: Optional[float] = None
    phases: Dict[str, float] = field(default_factory=dict)

    def to_json(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {
            "t": round(float(self.t), 6),
            "endpoint": self.endpoint,
            "outcome": self.outcome,
        }
        if self.tenant is not None:
            out["tenant"] = self.tenant
        if self.latency_ms is not None:
            out["ms"] = round(float(self.latency_ms), 3)
        if self.server_ms is not None:
            out["server_ms"] = round(float(self.server_ms), 3)
        if self.phases:
            out["phases"] = {
                k: round(float(v), 4) for k, v in sorted(self.phases.items())
            }
        return out

    @classmethod
    def from_json(cls, row: Dict[str, Any]) -> "TraceRecord":
        phases = {
            str(k): float(v)
            for k, v in (row.get("phases") or {}).items()
            if isinstance(v, (int, float)) and not str(k).startswith("t_")
        }
        return cls(
            t=float(row["t"]),
            endpoint=str(row.get("endpoint") or "ep0"),
            tenant=row.get("tenant"),
            outcome=str(row.get("outcome") or "ok"),
            latency_ms=row.get("ms"),
            server_ms=row.get("server_ms"),
            phases=phases,
        )


def write_trace(path: str, meta: Dict[str, Any],
                records: Iterable[TraceRecord]) -> int:
    """Write header + records; returns the record count."""
    n = 0
    with open(path, "w") as f:
        header = dict(meta)
        header.setdefault("kind", "sparkdl_trace")
        header.setdefault("version", 1)
        f.write(json.dumps(header, sort_keys=True) + "\n")
        for rec in records:
            f.write(json.dumps(rec.to_json(), sort_keys=True) + "\n")
            n += 1
    return n


def load_trace(path: str) -> Tuple[Dict[str, Any], List[TraceRecord]]:
    """Read a trace file -> ``(meta, records)`` sorted by arrival.  A
    file without a header line (plain record JSONL) yields ``{}``."""
    meta: Dict[str, Any] = {}
    records: List[TraceRecord] = []
    with open(path) as f:
        for i, line in enumerate(f):
            line = line.strip()
            if not line:
                continue
            row = json.loads(line)
            if i == 0 and row.get("kind") == "sparkdl_trace":
                meta = row
                continue
            records.append(TraceRecord.from_json(row))
    records.sort(key=lambda r: r.t)
    return meta, records


def records_from_spans(spans: Iterable[Dict[str, Any]]) -> List[TraceRecord]:
    """Build replay records from stitched-trace span dicts (the
    ``obs.trace`` JSONL sinks): every ``router.request`` root span
    carries ``attributes.phases`` + ``e2e_ms`` + ``model_id`` +
    ``tenant``.  Arrival times are the span starts, rebased to the
    earliest one."""
    rows = []
    for span in spans:
        if span.get("name") != "router.request":
            continue
        attrs = span.get("attributes") or {}
        phases = {
            str(k): float(v)
            for k, v in (attrs.get("phases") or {}).items()
            if isinstance(v, (int, float)) and not str(k).startswith("t_")
        }
        base_id = str(attrs.get("model_id") or "ep0").split("@", 1)[0]
        rows.append(TraceRecord(
            t=float(span.get("start_unix_s") or 0.0),
            endpoint=base_id,
            tenant=attrs.get("tenant"),
            outcome="ok" if "error" not in attrs else str(attrs["error"]),
            latency_ms=attrs.get("e2e_ms") or span.get("duration_ms"),
            phases=phases,
        ))
    if not rows:
        return []
    t0 = min(r.t for r in rows)
    for r in rows:
        r.t -= t0
    rows.sort(key=lambda r: r.t)
    return rows


class PhaseSampler:
    """Seeded empirical sampler over the trace's per-phase values —
    inverse-CDF draws from the recorded distribution, for the synthetic
    attempts (hedges, retries) that have no recorded twin.  Same seed +
    same trace -> same draw sequence (the determinism contract)."""

    def __init__(self, records: Iterable[TraceRecord], seed: int = 0):
        self._values: Dict[str, List[float]] = {}
        for rec in records:
            for name, v in rec.phases.items():
                self._values.setdefault(name, []).append(float(v))
        for vals in self._values.values():
            vals.sort()
        self._rng = random.Random(seed)

    def phases(self) -> Tuple[str, ...]:
        return tuple(sorted(self._values))

    def sample(self, phase: str, default: float = 0.0) -> float:
        """One draw from ``phase``'s empirical distribution (linear
        interpolation between order statistics); ``default`` when the
        trace never recorded that phase."""
        vals = self._values.get(phase)
        if not vals:
            return default
        if len(vals) == 1:
            return vals[0]
        pos = self._rng.random() * (len(vals) - 1)
        lo = int(pos)
        frac = pos - lo
        return vals[lo] * (1.0 - frac) + vals[lo + 1] * frac

    def quantile(self, phase: str, q: float) -> Optional[float]:
        vals = self._values.get(phase)
        if not vals:
            return None
        return _quantile(vals, q)


def _quantile(sorted_vals: List[float], q: float) -> Optional[float]:
    if not sorted_vals:
        return None
    if len(sorted_vals) == 1:
        return sorted_vals[0]
    pos = q * (len(sorted_vals) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(sorted_vals) - 1)
    frac = pos - lo
    return sorted_vals[lo] * (1 - frac) + sorted_vals[hi] * frac


def _stats(values: List[float]) -> Dict[str, Any]:
    vals = sorted(values)
    if not vals:
        return {"count": 0}
    return {
        "count": len(vals),
        "mean": round(sum(vals) / len(vals), 3),
        "p50": round(_quantile(vals, 0.50), 3),
        "p95": round(_quantile(vals, 0.95), 3),
        "p99": round(_quantile(vals, 0.99), 3),
        "max": round(vals[-1], 3),
    }


def summarize(records: Iterable[TraceRecord]) -> Dict[str, Any]:
    """Latency + per-phase summary in the same shape as the bench
    report's ``latency_ms`` / ``phases_ms`` sections — so live and
    replayed runs compare field-for-field in
    :func:`sparkdl_tpu_torch.sim.replay.fidelity_report`."""
    ok = [r for r in records if r.outcome == "ok"]
    by_phase: Dict[str, List[float]] = {}
    for r in ok:
        for name, v in r.phases.items():
            by_phase.setdefault(name, []).append(float(v))
    return {
        "requests": len(ok),
        "latency_ms": _stats([
            float(r.latency_ms) for r in ok if r.latency_ms is not None
        ]),
        "per_phase_ms": {
            name: _stats(vals) for name, vals in sorted(by_phase.items())
        },
    }
