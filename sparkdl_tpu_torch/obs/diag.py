"""Trace analytics: stitched-trace JSONL in, ranked attribution out.

Port of ``sparkdl_tpu.obs.diag`` (host code: a copy with the package
renamed; its report equals the JAX package's on the same spans).
The fleet *emits* everything — per-request spans stitched across the
router, wire, and replica processes, per-phase latency
histograms, exemplar trace ids on every latency sample — but a p99
regression still meant a human eyeballing JSONL dumps.  tf.data
(PAPERS.md, arXiv:2101.12127) argues the payoff of pipeline
instrumentation is *automated attribution*: the autotuner acts on
measured stage stats, not raw logs.  This module is that layer for the
serving plane: ingest a trace file (or a live
:class:`~sparkdl_tpu_torch.obs.export.JsonlTraceSink`), reassemble each
request's span tree, extract its critical path, and aggregate into a
report that answers the on-call questions directly —

- which phase (``admission`` / ``router_queue`` / ``transport`` /
  ``wire`` / ``replica_queue`` / ``forward`` / ``fetch``) dominates
  p50 vs p99 latency, and how much of measured end-to-end time the
  attribution actually covers;
- the slowest requests, each drilled down to its span tree and
  critical path (the ``/debug/diag`` → exemplar-trace hop);
- queue-vs-service decomposition per replica (is the replica slow, or
  just behind?);
- hedge/retry cost accounting — duplicate replica work bought by the
  tail-rescue machinery, and what it won.

Surfaces: :func:`diagnose` (the library call), ``python -m
sparkdl_tpu_torch.obs.diag trace.jsonl`` (CLI), and the ObsServer's
``/debug/diag`` endpoint.  Ingest is torn-tail tolerant: a process
crashing mid-``flush`` leaves a truncated final line, which is skipped
and counted (``skipped_lines``), never raised on.

Metrics: ``diag.reports`` (runs), ``diag.requests`` /
``diag.coverage_p50`` / ``diag.e2e_p50_ms`` / ``diag.e2e_p99_ms``
gauges from the latest report, ``diag.skipped_lines`` counter.
"""

from __future__ import annotations

import json
import math
import sys
from typing import Any, Dict, Iterable, List, Optional, Tuple

from sparkdl_tpu_torch.utils.metrics import metrics

#: the canonical phase ordering (request lifecycle order) — report rows
#: keep this order so two reports diff cleanly; unknown phases append
PHASE_ORDER = (
    "ingress", "admission", "router_queue", "transport", "frontdoor",
    "wire", "replica_queue", "forward", "fetch", "egress",
)

#: phases that are time spent *waiting* (queueing/admission) vs doing
#: work — the queue-vs-service split per replica
QUEUE_PHASES = ("admission", "router_queue", "replica_queue")

#: the root span every request tree hangs off
ROOT_SPAN = "router.request"

#: the replica-side serve span — its presence is what makes a trace
#: "stitched" (the remote half made it home on the reply envelope)
REMOTE_SPAN = "replica.serve"


def _quantile(values: List[float], q: float) -> Optional[float]:
    """Linear-interpolated quantile; None on empty input."""
    if not 0.0 <= q <= 1.0:
        raise ValueError(f"quantile must be in [0, 1], got {q}")
    if not values:
        return None
    data = sorted(values)
    rank = q * (len(data) - 1)
    lo = math.floor(rank)
    hi = min(lo + 1, len(data) - 1)
    frac = rank - lo
    return data[lo] * (1.0 - frac) + data[hi] * frac


# ---------------------------------------------------------------------------
# ingest
# ---------------------------------------------------------------------------

def read_jsonl(path: str) -> Tuple[List[Dict[str, Any]], int]:
    """Span dicts from a ``JsonlTraceSink`` file; returns ``(spans,
    skipped_lines)``.  Malformed lines — above all the torn final line a
    crash mid-flush leaves behind — are skipped and counted, never
    raised on: a diagnosis tool that dies on the evidence of the crash
    it should explain is useless."""
    spans: List[Dict[str, Any]] = []
    skipped = 0
    with open(path, "r", errors="replace") as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                obj = json.loads(line)
            except ValueError:
                skipped += 1
                continue
            if isinstance(obj, dict) and "trace_id" in obj:
                spans.append(obj)
            else:
                skipped += 1
    return spans, skipped


def load_spans(paths: Iterable[str]) -> Tuple[List[Dict[str, Any]], int]:
    """:func:`read_jsonl` over several files (router + replica halves
    of one bench run), merged."""
    spans: List[Dict[str, Any]] = []
    skipped = 0
    for path in paths:
        s, k = read_jsonl(path)
        spans.extend(s)
        skipped += k
    return spans, skipped


# ---------------------------------------------------------------------------
# tree reassembly + critical path
# ---------------------------------------------------------------------------

class TraceTree:
    """One request's spans, reassembled by ``(trace_id, span_id,
    parent_id)``."""

    def __init__(self, trace_id: int):
        self.trace_id = int(trace_id)
        #: span_id -> span dict
        self.spans: Dict[int, Dict[str, Any]] = {}
        #: parent span_id -> [child span dicts]
        self.children: Dict[int, List[Dict[str, Any]]] = {}

    def add(self, span: Dict[str, Any]) -> None:
        try:
            sid = int(span["span_id"])
        except (KeyError, TypeError, ValueError):
            return
        # last write wins: a re-ingested duplicate replaces, not forks
        self.spans[sid] = span
        parent = span.get("parent_id")
        if parent is not None:
            try:
                self.children.setdefault(int(parent), []).append(span)
            except (TypeError, ValueError):
                pass

    @property
    def root(self) -> Optional[Dict[str, Any]]:
        """The request root: the ``router.request`` span when present,
        else any parentless span."""
        parentless = [
            s for s in self.spans.values() if s.get("parent_id") is None
        ]
        for s in parentless:
            if s.get("name") == ROOT_SPAN:
                return s
        return parentless[0] if parentless else None

    @property
    def orphans(self) -> int:
        """Spans whose parent_id names a span this trace never saw —
        nonzero means the stitching lost a link."""
        n = 0
        for s in self.spans.values():
            parent = s.get("parent_id")
            if parent is None:
                continue
            try:
                if int(parent) not in self.spans:
                    n += 1
            except (TypeError, ValueError):
                n += 1
        return n

    @property
    def stitched(self) -> bool:
        """True when this trace is a COMPLETE stitched request: a
        ``router.request`` root, the remote ``replica.serve`` half
        present, and every parent link resolving in-trace."""
        root = self.root
        return (
            root is not None
            and root.get("name") == ROOT_SPAN
            and any(
                s.get("name") == REMOTE_SPAN for s in self.spans.values()
            )
            and self.orphans == 0
        )

    def _kids(self, span: Dict[str, Any]) -> List[Dict[str, Any]]:
        kids = self.children.get(int(span.get("span_id") or 0), [])
        return sorted(kids, key=lambda s: s.get("start_unix_s") or 0.0)

    def critical_path(self) -> List[Dict[str, Any]]:
        """Root-to-leaf chain following the longest-duration child at
        each level — per segment: name, duration, and self time (the
        segment's duration its own children do NOT account for)."""
        path: List[Dict[str, Any]] = []
        node = self.root
        seen: set = set()
        while node is not None:
            sid = node.get("span_id")
            if sid in seen:  # defensive: a cyclic link must not hang us
                break
            seen.add(sid)
            kids = self._kids(node)
            dur = float(node.get("duration_ms") or 0.0)
            kid_ms = sum(float(k.get("duration_ms") or 0.0) for k in kids)
            path.append({
                "name": node.get("name"),
                "span_id": sid,
                "duration_ms": dur,
                "self_ms": max(0.0, dur - kid_ms),
            })
            node = max(
                kids, key=lambda k: float(k.get("duration_ms") or 0.0),
            ) if kids else None
        return path

    def render(self, max_spans: int = 64) -> List[str]:
        """Indented text form of the tree (drill-down payload)."""
        lines: List[str] = []

        def walk(span: Dict[str, Any], depth: int) -> None:
            if len(lines) >= max_spans:
                return
            dur = span.get("duration_ms")
            dur_s = f"{dur:.2f}ms" if isinstance(dur, (int, float)) \
                else "open"
            attrs = span.get("attributes") or {}
            tags = " ".join(
                f"{k}={attrs[k]}"
                for k in ("replica", "version", "error", "retries",
                          "hedged", "pid")
                if k in attrs
            )
            lines.append(
                "  " * depth + f"{span.get('name')} {dur_s}"
                + (f" [{tags}]" if tags else "")
            )
            for kid in self._kids(span):
                walk(kid, depth + 1)

        root = self.root
        if root is not None:
            walk(root, 0)
        return lines


def build_trees(spans: Iterable[Dict[str, Any]]) -> Dict[int, TraceTree]:
    """Group spans into per-trace trees."""
    trees: Dict[int, TraceTree] = {}
    for span in spans:
        try:
            tid = int(span["trace_id"])
        except (KeyError, TypeError, ValueError):
            continue
        tree = trees.get(tid)
        if tree is None:
            tree = trees[tid] = TraceTree(tid)
        tree.add(span)
    return trees


# ---------------------------------------------------------------------------
# aggregation
# ---------------------------------------------------------------------------

def _request_rows(trees: Dict[int, TraceTree]) -> List[Dict[str, Any]]:
    """One row per completed request root: e2e latency, phase
    breakdown, placement, and rescue accounting."""
    rows: List[Dict[str, Any]] = []
    for tree in trees.values():
        root = tree.root
        if root is None or root.get("name") != ROOT_SPAN:
            continue
        attrs = root.get("attributes") or {}
        e2e = attrs.get("e2e_ms")
        if not isinstance(e2e, (int, float)):
            e2e = root.get("duration_ms")
        if not isinstance(e2e, (int, float)):
            continue  # never finished — not a latency sample
        phases: Dict[str, float] = {}
        for k, v in (attrs.get("phases") or {}).items():
            # t_-prefixed keys are absolute stamps, not durations
            if isinstance(v, (int, float)) and not str(k).startswith("t_"):
                phases[str(k)] = float(v)
        rows.append({
            "trace_id": tree.trace_id,
            "e2e_ms": float(e2e),
            "phases": phases,
            "replica": attrs.get("replica"),
            "version": attrs.get("version"),
            "error": attrs.get("error"),
            "retries": int(attrs.get("retries") or 0),
            "hedged": bool(attrs.get("hedged")),
            "hedge_won": bool(attrs.get("hedge_won")),
            "stitched": tree.stitched,
        })
    return rows


def _phase_names(rows: List[Dict[str, Any]]) -> List[str]:
    known = [p for p in PHASE_ORDER]
    extra = sorted(
        {k for r in rows for k in r["phases"]} - set(PHASE_ORDER)
    )
    names = known + extra
    return [n for n in names if any(n in r["phases"] for r in rows)]


def _attribution(rows: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Per-phase p50/p99 plus the ranked answer to "what dominates":
    phase medians vs the e2e median (coverage), and the same over the
    p99 tail cohort."""
    e2e = [r["e2e_ms"] for r in rows]
    p50 = _quantile(e2e, 0.5)
    p99 = _quantile(e2e, 0.99)
    names = _phase_names(rows)
    phases: Dict[str, Dict[str, Any]] = {}
    tail = [r for r in rows if p99 is not None and r["e2e_ms"] >= p99]
    for name in names:
        samples = [
            r["phases"][name] for r in rows if name in r["phases"]
        ]
        tail_samples = [
            r["phases"][name] for r in tail if name in r["phases"]
        ]
        phases[name] = {
            "p50_ms": _quantile(samples, 0.5),
            "p99_ms": _quantile(samples, 0.99),
            "tail_mean_ms": (
                sum(tail_samples) / len(tail_samples)
                if tail_samples else None
            ),
        }
    covered = sum(
        (phases[n]["p50_ms"] or 0.0) for n in names
    )
    tail_mean = (
        sum(r["e2e_ms"] for r in tail) / len(tail) if tail else None
    )
    tail_covered = sum(
        (phases[n]["tail_mean_ms"] or 0.0) for n in names
    )

    def rank(key: str) -> List[str]:
        return [
            n for n, _ in sorted(
                ((n, phases[n][key] or 0.0) for n in names),
                key=lambda kv: -kv[1],
            )
        ]

    return {
        "requests": len(rows),
        "e2e_p50_ms": p50,
        "e2e_p99_ms": p99,
        "phases": phases,
        # how much of the measured e2e median the phase medians explain
        # — the "attribution sums to >=90% of p50" acceptance number
        "coverage_p50": (covered / p50) if p50 else None,
        "coverage_tail": (
            (tail_covered / tail_mean) if tail_mean else None
        ),
        "dominant_p50": rank("p50_ms"),
        "dominant_tail": rank("tail_mean_ms"),
    }


def _per_replica(rows: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Queue-vs-service decomposition per replica: is it slow doing the
    work, or slow *getting to* the work?"""
    out: Dict[str, Any] = {}
    by_replica: Dict[str, List[Dict[str, Any]]] = {}
    for r in rows:
        if r["replica"]:
            by_replica.setdefault(str(r["replica"]), []).append(r)
    for name, group in sorted(by_replica.items()):
        queue = [
            sum(v for k, v in r["phases"].items() if k in QUEUE_PHASES)
            for r in group
        ]
        service = [
            sum(
                v for k, v in r["phases"].items()
                if k not in QUEUE_PHASES
            )
            for r in group
        ]
        out[name] = {
            "requests": len(group),
            "e2e_p50_ms": _quantile([r["e2e_ms"] for r in group], 0.5),
            "e2e_p99_ms": _quantile([r["e2e_ms"] for r in group], 0.99),
            "queue_p50_ms": _quantile(queue, 0.5),
            "queue_p99_ms": _quantile(queue, 0.99),
            "service_p50_ms": _quantile(service, 0.5),
            "service_p99_ms": _quantile(service, 0.99),
        }
    return out


def _rescue_accounting(
    rows: List[Dict[str, Any]], trees: Dict[int, TraceTree],
) -> Dict[str, Any]:
    """What the tail-rescue machinery (hedges, retries) cost and won:
    duplicate replica-side serve time is work bought twice."""
    duplicate_ms = 0.0
    duplicated = 0
    for r in rows:
        tree = trees.get(r["trace_id"])
        if tree is None:
            continue
        serves = [
            float(s.get("duration_ms") or 0.0)
            for s in tree.spans.values()
            if s.get("name") == REMOTE_SPAN
        ]
        if len(serves) > 1:
            duplicated += 1
            duplicate_ms += sum(serves) - max(serves)
    return {
        "retried_requests": sum(1 for r in rows if r["retries"] > 0),
        "total_retries": sum(r["retries"] for r in rows),
        "hedged_requests": sum(1 for r in rows if r["hedged"]),
        "hedge_wins": sum(1 for r in rows if r["hedge_won"]),
        "duplicated_serves": duplicated,
        "duplicate_serve_ms": round(duplicate_ms, 3),
    }


def _exemplar_rows(
    registry, trees: Dict[int, TraceTree],
) -> List[Dict[str, Any]]:
    """Every live histogram exemplar resolved against the trace set —
    the one-hop check that a p99 outlier's trace actually exists and is
    complete."""
    rows: List[Dict[str, Any]] = []
    for name, h in sorted(registry.collect()["histograms"].items()):
        ex = h.exemplar()
        if ex is None:
            continue
        tree = trees.get(int(ex[1]))
        rows.append({
            "metric": name,
            "value": ex[0],
            "trace_id": ex[1],
            "resolved": tree is not None,
            "stitched": bool(tree is not None and tree.stitched),
        })
    return rows


def diagnose(
    spans: Iterable[Dict[str, Any]],
    skipped_lines: int = 0,
    top: int = 3,
    registry=None,
    record_metrics: bool = True,
) -> Dict[str, Any]:
    """The full attribution report over a span set.

    ``registry`` (optional) resolves that registry's histogram
    exemplars against these traces; ``record_metrics`` publishes the
    headline numbers as ``diag.*`` gauges (off for pure-library use in
    tests that must not touch the process registry)."""
    trees = build_trees(spans)
    rows = _request_rows(trees)
    ok_rows = [r for r in rows if not r["error"]]
    slowest = sorted(
        ok_rows, key=lambda r: -r["e2e_ms"],
    )[:max(0, int(top))]
    report: Dict[str, Any] = {
        "traces": len(trees),
        "spans": sum(len(t.spans) for t in trees.values()),
        "skipped_lines": int(skipped_lines),
        "requests": len(rows),
        "errored_requests": len(rows) - len(ok_rows),
        "stitched_requests": sum(1 for r in rows if r["stitched"]),
        "attribution": _attribution(ok_rows) if ok_rows else None,
        "per_replica": _per_replica(ok_rows),
        "rescue": _rescue_accounting(rows, trees),
        "slowest": [
            {
                **{k: r[k] for k in (
                    "trace_id", "e2e_ms", "phases", "replica",
                    "version", "retries", "hedged", "stitched",
                )},
                "critical_path":
                    trees[r["trace_id"]].critical_path(),
                "tree": trees[r["trace_id"]].render(),
            }
            for r in slowest
        ],
    }
    if registry is not None:
        report["exemplars"] = _exemplar_rows(registry, trees)
    if record_metrics:
        metrics.counter("diag.reports").add(1)
        metrics.gauge("diag.requests").set(len(rows))
        if skipped_lines:
            metrics.counter("diag.skipped_lines").add(skipped_lines)
        attribution = report["attribution"]
        if attribution:
            gauges = {
                "coverage_p50": metrics.gauge("diag.coverage_p50"),
                "e2e_p50_ms": metrics.gauge("diag.e2e_p50_ms"),
                "e2e_p99_ms": metrics.gauge("diag.e2e_p99_ms"),
            }
            for key, gauge in gauges.items():
                v = attribution.get(key)
                if isinstance(v, (int, float)):
                    gauge.set(float(v))
    return report


def diagnose_paths(
    paths: Iterable[str], top: int = 3, registry=None,
    record_metrics: bool = True,
) -> Dict[str, Any]:
    """:func:`diagnose` over trace files (CLI / bench entry)."""
    spans, skipped = load_spans(paths)
    return diagnose(
        spans, skipped_lines=skipped, top=top, registry=registry,
        record_metrics=record_metrics,
    )


# ---------------------------------------------------------------------------
# rendering + CLI
# ---------------------------------------------------------------------------

def _fmt(v: Optional[float], unit: str = "") -> str:
    return "-" if v is None else f"{v:.2f}{unit}"


def render_text(report: Dict[str, Any]) -> str:
    """The report as an on-call-readable text block (CLI default)."""
    lines: List[str] = []
    lines.append(
        f"traces={report['traces']} spans={report['spans']} "
        f"requests={report['requests']} "
        f"stitched={report['stitched_requests']} "
        f"errors={report['errored_requests']} "
        f"skipped_lines={report['skipped_lines']}"
    )
    attribution = report.get("attribution")
    if attribution:
        lines.append(
            f"e2e p50={_fmt(attribution['e2e_p50_ms'], 'ms')} "
            f"p99={_fmt(attribution['e2e_p99_ms'], 'ms')} "
            f"coverage_p50="
            f"{_fmt((attribution['coverage_p50'] or 0.0) * 100.0, '%')}"
        )
        lines.append(
            "dominant: p50=" + ">".join(attribution["dominant_p50"][:3])
            + "  tail=" + ">".join(attribution["dominant_tail"][:3])
        )
        lines.append(f"{'phase':<14}{'p50':>10}{'p99':>10}{'tail':>10}")
        for name, row in attribution["phases"].items():
            lines.append(
                f"{name:<14}{_fmt(row['p50_ms']):>10}"
                f"{_fmt(row['p99_ms']):>10}"
                f"{_fmt(row['tail_mean_ms']):>10}"
            )
    per_replica = report.get("per_replica") or {}
    if per_replica:
        lines.append("per-replica queue-vs-service (p50/p99 ms):")
        for name, row in per_replica.items():
            lines.append(
                f"  {name}: n={row['requests']} "
                f"queue={_fmt(row['queue_p50_ms'])}/"
                f"{_fmt(row['queue_p99_ms'])} "
                f"service={_fmt(row['service_p50_ms'])}/"
                f"{_fmt(row['service_p99_ms'])}"
            )
    rescue = report.get("rescue") or {}
    if rescue:
        lines.append(
            f"rescue: retries={rescue['total_retries']} "
            f"(over {rescue['retried_requests']} requests) "
            f"hedged={rescue['hedged_requests']} "
            f"won={rescue['hedge_wins']} "
            f"duplicate_serve_ms={rescue['duplicate_serve_ms']}"
        )
    for slow in report.get("slowest") or []:
        lines.append(
            f"slowest trace {slow['trace_id']}: "
            f"{slow['e2e_ms']:.2f}ms replica={slow['replica']} "
            f"stitched={slow['stitched']}"
        )
        for line in slow["tree"]:
            lines.append("  " + line)
    ex_rows = report.get("exemplars")
    if ex_rows:
        lines.append("exemplars:")
        for row in ex_rows:
            lines.append(
                f"  {row['metric']}={row['value']:.2f} "
                f"trace={row['trace_id']} "
                f"resolved={row['resolved']} stitched={row['stitched']}"
            )
    return "\n".join(lines) + "\n"


def main(argv: Optional[List[str]] = None) -> int:
    import argparse

    parser = argparse.ArgumentParser(
        prog="python -m sparkdl_tpu_torch.obs.diag",
        description=(
            "Attribution report over stitched-trace JSONL "
            "(JsonlTraceSink / SPARKDL_TRACE_OUT output)"
        ),
    )
    parser.add_argument(
        "paths", nargs="+",
        help="trace JSONL file(s) — router + replica halves merge",
    )
    parser.add_argument(
        "--top", type=int, default=3,
        help="slowest-request drill-downs to include (default 3)",
    )
    parser.add_argument(
        "--json", action="store_true",
        help="emit the raw JSON report instead of text",
    )
    parser.add_argument(
        "--trace", type=int, default=None,
        help="render one trace id's full span tree and exit",
    )
    args = parser.parse_args(argv)
    spans, skipped = load_spans(args.paths)
    if args.trace is not None:
        tree = build_trees(spans).get(args.trace)
        if tree is None:
            print(f"trace {args.trace} not found", file=sys.stderr)
            return 1
        print("\n".join(tree.render(max_spans=256)))
        return 0
    report = diagnose(
        spans, skipped_lines=skipped, top=args.top,
        record_metrics=False,
    )
    if args.json:
        print(json.dumps(report, indent=2, default=str))
    else:
        print(render_text(report), end="")
    return 0


if __name__ == "__main__":
    sys.exit(main())
