"""Fleet metrics federation: one supervisor-side view of every replica.

Port of ``sparkdl_tpu.obs.fleet`` (host code: a copy with the package
renamed). The supervisor's own registry only sees the *router* side of the fleet —
``router.*`` series measured where requests are placed.  Each replica
process keeps its own registry (``serving.*`` forward/queue/batch
series) behind its ObsServer, and before this module those numbers died
with the process: the SLO engine, the autoscaler, and the
:class:`~sparkdl_tpu_torch.serving.rollout.RolloutController` all steered by
router-side proxies.  That is exactly the view that *masks* a sick
canary — the router's retry loop re-places failed requests on healthy
replicas, so router-side error series stay clean while the canary burns.

:class:`FleetCollector` closes the gap: a background thread scrapes
each replica's ``/metrics.json`` endpoint on an interval and merges the
samples into the supervisor's :class:`~sparkdl_tpu_torch.obs.timeseries.
TimeSeriesRecorder` as *labeled* series —

- ``fleet.replica.<replica>.<metric>`` — one series per (replica,
  metric), the per-process ground truth;
- ``fleet.version.<version>.<metric>`` — the per-deployment-version
  aggregate (sum for counters/counts, max for latency quantiles and
  means: a version is as slow as its slowest member), the series
  ``fleet_rollout_slos`` watches so a canary pages on its OWN numbers.

Design rules:

- **scrapes never block serving**: collection runs on the collector's
  daemon thread with a per-target socket timeout; a dead or wedged
  replica costs one timeout, counts into ``fleet.scrape_errors``, and
  is reported in :meth:`snapshot` — it never stalls the router;
- **bounded**: series flow into the recorder's existing caps
  (``max_series`` / ``max_points``); per-target raw snapshots are kept
  only for the most recent scrape (the ``/debug/fleet`` payload);
- **prefix-filtered**: only ``metric_prefixes`` series federate
  (default ``serving.`` + the replica's own ``sparkdl.up`` health
  gauge) — scraping a replica must not mirror its entire registry into
  the supervisor's caps.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.request
from typing import Any, Callable, Dict, Iterable, List, Optional

from sparkdl_tpu_torch.obs.timeseries import TimeSeriesRecorder
from sparkdl_tpu_torch.utils.metrics import MetricsRegistry, metrics

#: one scrape target: where a replica's ObsServer answers
#: ``/metrics.json``, plus the labels its series federate under
Target = Dict[str, Any]  # {"name": str, "version": str, "url": str}

#: metric-name suffixes aggregated by max (a version is as slow as its
#: slowest replica); everything else aggregates by sum
_MAX_SUFFIXES = (".p50", ".p95", ".p99", ".mean", ".seconds")

#: histogram exemplar refs — excluded from federation (a trace id is a
#: link, not a measurement; see Histogram.exemplar())
_EXEMPLAR_SUFFIXES = (".exemplar_trace_id", ".exemplar_value")


def sanitize_label(label: str) -> str:
    """Metric-segment-safe form of a replica/version label
    (``replica-0`` -> ``replica_0``)."""
    return "".join(
        ch if (ch.isalnum() or ch == "_") else "_"
        for ch in str(label).lower()
    ) or "unknown"


class FleetCollector:
    """Scrape every target's ``/metrics.json`` on an interval; merge the
    samples into ``recorder`` as ``fleet.*`` series.

    ``targets_fn`` is polled at each scrape (membership changes as
    replicas restart under new ports) and must return an iterable of
    ``{"name", "version", "url"}`` rows — the supervisor's
    ``obs_targets()``.  Tests call :meth:`scrape_once` with a synthetic
    ``now`` and never start the thread.
    """

    def __init__(
        self,
        recorder: TimeSeriesRecorder,
        targets_fn: Callable[[], Iterable[Target]],
        interval_s: float = 2.0,
        timeout_s: float = 1.0,
        metric_prefixes: Iterable[str] = (
            # "cache." covers the replica-tier single-flight / negative
            # cache counters so the result-cache series federate;
            # "decode." / "batcher." federate the streaming
            # plane (slot occupancy, step/token counters, pad fraction)
            # so padding waste is measurable fleet-side, not just in the
            # replica process
            "serving.", "sparkdl.up", "cache.", "decode.", "batcher.",
        ),
        registry: Optional[MetricsRegistry] = None,
        clock=time.monotonic,
    ):
        if interval_s <= 0:
            raise ValueError(f"interval_s must be > 0, got {interval_s}")
        self._recorder = recorder
        self._targets_fn = targets_fn
        self.interval_s = float(interval_s)
        self.timeout_s = float(timeout_s)
        self._prefixes = tuple(metric_prefixes)
        self._registry = registry if registry is not None else metrics
        self._clock = clock
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        #: per-target scrape state, keyed by replica name — the
        #: ``/debug/fleet`` payload
        self._state: Dict[str, Dict[str, Any]] = {}
        self._m_scrapes = self._registry.counter("fleet.scrapes")
        self._m_errors = self._registry.counter("fleet.scrape_errors")
        self._m_targets = self._registry.gauge("fleet.targets")

    # ------------------------------------------------------------------
    # scraping
    # ------------------------------------------------------------------
    def _fetch(self, url: str) -> Dict[str, float]:
        with urllib.request.urlopen(
            f"{url.rstrip('/')}/metrics.json", timeout=self.timeout_s,
        ) as resp:
            payload = json.loads(resp.read().decode("utf-8"))
        if not isinstance(payload, dict):
            raise ValueError(f"malformed /metrics.json from {url}")
        return payload

    def _wanted(self, name: str) -> bool:
        return any(name.startswith(p) for p in self._prefixes)

    def scrape_once(self, now: Optional[float] = None) -> int:
        """Scrape every current target once; returns the number of
        targets that answered.  Failures are absorbed into per-target
        state and ``fleet.scrape_errors`` — a scrape pass never raises."""
        try:
            targets = list(self._targets_fn())
        except Exception:
            targets = []
        t = self._clock() if now is None else float(now)
        self._m_targets.set(len(targets))
        #: version label -> metric name -> list of replica values
        by_version: Dict[str, Dict[str, List[float]]] = {}
        ok = 0
        seen = set()
        for target in targets:
            name = str(target.get("name", "unknown"))
            version = str(target.get("version", "unknown"))
            url = target.get("url")
            seen.add(name)
            row = {
                "name": name, "version": version, "url": url,
                "last_scrape": t,
            }
            try:
                if not url:
                    raise ValueError("target has no obs url")
                snap = self._fetch(str(url))
            except Exception as exc:
                self._m_errors.add(1)
                with self._lock:
                    prev = self._state.get(name, {})
                    row.update({
                        "ok": False,
                        "error": f"{type(exc).__name__}: {exc}",
                        "consecutive_errors":
                            int(prev.get("consecutive_errors", 0)) + 1,
                        "metrics": prev.get("metrics", {}),
                    })
                    self._state[name] = row
                continue
            self._m_scrapes.add(1)
            ok += 1
            rlabel = sanitize_label(name)
            vlabel = sanitize_label(version)
            kept: Dict[str, float] = {}
            for metric_name, value in snap.items():
                if not isinstance(value, (int, float)):
                    continue
                if not self._wanted(metric_name):
                    continue
                if metric_name.endswith(_EXEMPLAR_SUFFIXES):
                    # exemplar refs are trace-id links, not samples —
                    # summing them across replicas is meaningless and
                    # burns a recorder series per histogram
                    continue
                kept[metric_name] = float(value)
                self._recorder.record(
                    f"fleet.replica.{rlabel}.{metric_name}",
                    float(value), now=t,
                )
                by_version.setdefault(vlabel, {}).setdefault(
                    metric_name, []
                ).append(float(value))
            with self._lock:
                row.update({
                    "ok": True, "error": None, "consecutive_errors": 0,
                    "metrics": kept,
                })
                self._state[name] = row
        for vlabel, series in by_version.items():
            for metric_name, values in series.items():
                agg = (
                    max(values)
                    if metric_name.endswith(_MAX_SUFFIXES) else sum(values)
                )
                self._recorder.record(
                    f"fleet.version.{vlabel}.{metric_name}", agg, now=t,
                )
        with self._lock:
            # forget replicas no longer in the target set (restarted
            # under a new name, or removed) so /debug/fleet stays honest
            for gone in [n for n in self._state if n not in seen]:
                del self._state[gone]
        return ok

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------
    def start(self) -> "FleetCollector":
        """Launch the background scrape thread (idempotent)."""
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return self
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, name="sparkdl-fleet-collector",
                daemon=True,
            )
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        with self._lock:
            thread = self._thread
            self._thread = None
        if thread is not None and thread.is_alive():
            thread.join(timeout=max(2.0, 2 * self.interval_s))

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.scrape_once()
            except Exception:  # pragma: no cover - scraping must not die
                pass

    # ------------------------------------------------------------------
    # export
    # ------------------------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        """The ``/debug/fleet`` payload: per-target scrape state (url,
        last error, consecutive failures) plus each target's most recent
        federated values."""
        with self._lock:
            targets = {name: dict(row) for name, row in
                       sorted(self._state.items())}
        return {
            "targets": targets,
            "healthy": sum(1 for r in targets.values() if r.get("ok")),
            "total": len(targets),
        }

    def prometheus_block(self) -> str:
        """Labeled exposition lines for the federated ``/metrics`` view:
        each target's latest scraped values with ``replica``/``version``
        labels, appended after the supervisor's own series."""
        from sparkdl_tpu_torch.obs.export import _prom_name

        with self._lock:
            rows = [dict(r) for _, r in sorted(self._state.items())]
        lines: List[str] = []
        for row in rows:
            if not row.get("ok"):
                continue
            labels = (
                f'replica="{row["name"]}",version="{row["version"]}"'
            )
            for metric_name, value in sorted(row.get("metrics", {}).items()):
                lines.append(
                    f"{_prom_name(metric_name)}{{{labels}}} {value}"
                )
        return "\n".join(lines) + ("\n" if lines else "")
