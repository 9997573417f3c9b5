"""Declarative SLOs evaluated as multi-window burn rates.

Port of ``sparkdl_tpu.obs.slo`` (host code: a copy with the package
renamed). ``fleet_rollout_slos`` and ``tenant_slos`` watch the series of
the replica plane's router and fleet collector; ``rollout_slos`` comes along
as plain data for the rollout controller (``serving/rollout.py``).

An SLO here is "objective fraction of good samples/requests over time"
— e.g. *99% of p99-latency samples under 250 ms*, *99.9% of requests
error-free*, *95% of watermark-lag samples under 5 s*.  The engine turns
the :class:`~sparkdl_tpu_torch.obs.timeseries.TimeSeriesRecorder`'s windows
into **burn rates** (observed bad fraction ÷ error budget, where budget
= 1 − objective): burn 1.0 spends the budget exactly at the sustainable
pace, burn 14 exhausts a 30-day budget in ~2 days.

Multi-window alerting (the SRE-workbook shape): the **fast** window
reacts to fresh breaches, the **slow** window confirms real budget
spend, so a one-sample blip cannot page:

- ``page``    — ``burn_fast >= page_burn`` AND ``burn_slow >= warn_burn``
- ``warning`` — either window's burn ``>= warn_burn``
- ``ok``      — otherwise

Downgrades are hysteretic: the state steps down only after
``clear_after`` consecutive clean evaluations (an alert that flaps at
the threshold is worse than a late all-clear); upgrades apply
immediately.  Every evaluation exports ``slo.<name>.state`` /
``.burn_fast`` / ``.burn_slow`` gauges; every transition increments
``slo.transitions``, emits a ``slo.transition`` span (when tracing is
on), and lands in the flight recorder's breadcrumb ring when one is
armed.

Factories at the bottom build the bundles the serving and streaming
layers wire in (:func:`serving_slos` for an endpoint,
:meth:`sparkdl_tpu_torch.streaming.runner.StreamRunner.slos`).
"""

from __future__ import annotations

import re
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from sparkdl_tpu_torch.obs.timeseries import TimeSeriesRecorder
from sparkdl_tpu_torch.utils.metrics import MetricsRegistry, metrics

#: alert states, escalating; gauge values are the indices
STATES = ("ok", "warning", "page")

_NAME_OK = re.compile(r"[a-z0-9_.]+")


def sanitize_name(name: str) -> str:
    """Lowercase ``[a-z0-9_.]`` form of an SLO/model name — what the
    ``slo.<name>.*`` gauge names embed (the ``metric-name`` rule's
    alphabet)."""
    out = re.sub(r"[^a-z0-9_.]", "_", str(name).lower()).strip(".")
    return out or "unnamed"


@dataclass
class SLO:
    """One declarative objective over recorder series.

    ``kind`` selects the bad-fraction computation per window:

    - ``"error_rate"`` — ``delta(numerator) / delta(denominator)``
      (counter series; zero traffic is zero burn);
    - ``"threshold"`` — fraction of ``series`` samples **above**
      ``threshold`` (latency quantiles, lag gauges);
    - ``"availability"`` — fraction of ``series`` samples **below**
      ``threshold`` (an up/health gauge, default threshold 1.0);
    - ``"rate_min"`` — the whole window is bad when
      ``rate(series) < threshold`` (a commit/throughput floor).
    """

    name: str
    kind: str
    objective: float = 0.99
    series: Optional[str] = None
    threshold: Optional[float] = None
    numerator: Optional[str] = None
    denominator: Optional[str] = None
    fast_window_s: float = 60.0
    slow_window_s: float = 600.0
    page_burn: float = 14.0
    warn_burn: float = 6.0
    clear_after: int = 3
    description: str = ""

    def __post_init__(self):
        self.name = sanitize_name(self.name)
        if self.kind not in (
            "error_rate", "threshold", "availability", "rate_min"
        ):
            raise ValueError(f"unknown SLO kind {self.kind!r}")
        if not 0.0 < self.objective < 1.0:
            raise ValueError(
                f"objective must be in (0, 1), got {self.objective}"
            )
        if self.kind == "error_rate":
            if not (self.numerator and self.denominator):
                raise ValueError(
                    "error_rate SLO needs numerator + denominator series"
                )
        elif self.series is None:
            raise ValueError(f"{self.kind} SLO needs a series")
        if self.kind == "availability" and self.threshold is None:
            self.threshold = 1.0
        if self.kind in ("threshold", "rate_min") and self.threshold is None:
            raise ValueError(f"{self.kind} SLO needs a threshold")
        if self.fast_window_s >= self.slow_window_s:
            raise ValueError(
                "fast_window_s must be shorter than slow_window_s "
                f"({self.fast_window_s} >= {self.slow_window_s})"
            )

    @property
    def budget(self) -> float:
        return max(1.0 - self.objective, 1e-9)

    def bad_fraction(
        self, recorder: TimeSeriesRecorder, window_s: float,
        now: Optional[float],
    ) -> Optional[float]:
        """Observed bad fraction over one window; None when the window
        holds no data (no data is no evidence, not a breach)."""
        if self.kind == "error_rate":
            num = recorder.delta(self.numerator, window_s, now=now)
            den = recorder.delta(self.denominator, window_s, now=now)
            if num is None or den is None:
                return None
            if den <= 0:
                return 0.0
            return min(max(num / den, 0.0), 1.0)
        if self.kind == "rate_min":
            rate = recorder.rate(self.series, window_s, now=now)
            if rate is None:
                return None
            return 1.0 if rate < self.threshold else 0.0
        if self.kind == "availability":
            return recorder.fraction_where(
                self.series, lambda v: v < self.threshold, window_s, now=now
            )
        return recorder.fraction_where(
            self.series, lambda v: v > self.threshold, window_s, now=now
        )


@dataclass
class _SLOState:
    """Mutable evaluation state the engine keeps per objective."""

    state: str = "ok"
    burn_fast: Optional[float] = None
    burn_slow: Optional[float] = None
    clean_evals: int = 0
    no_data: bool = True
    last_eval_at: Optional[float] = None
    transitions: List[Dict] = field(default_factory=list)


class SLOEngine:
    """Evaluate a set of :class:`SLO`\\ s against one recorder.

    ``evaluate_once(now=...)`` is the synchronous entry the tests drive
    with a synthetic clock; ``start(interval_s)`` runs it on a daemon
    thread for live processes.  :meth:`report` is the ``/slo`` payload.
    """

    def __init__(
        self,
        recorder: TimeSeriesRecorder,
        registry: Optional[MetricsRegistry] = None,
        clock=time.monotonic,
    ):
        self._recorder = recorder
        self._registry = registry if registry is not None else metrics
        self._clock = clock
        self._lock = threading.Lock()
        self._slos: Dict[str, SLO] = {}
        self._states: Dict[str, _SLOState] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._on_transition: List[Callable[[SLO, str, str, _SLOState], None]] = []

    def add(self, *slos: SLO) -> "SLOEngine":
        with self._lock:
            for slo in slos:
                if slo.name in self._slos:
                    raise ValueError(f"SLO {slo.name!r} already registered")
                self._slos[slo.name] = slo
                self._states[slo.name] = _SLOState()
        return self

    def on_transition(
        self, callback: Callable[[SLO, str, str, _SLOState], None]
    ) -> None:
        """Register ``callback(slo, old_state, new_state, state)`` —
        the seam an autoscaler or a router hooks."""
        with self._lock:
            self._on_transition.append(callback)

    # ------------------------------------------------------------------
    # evaluation
    # ------------------------------------------------------------------
    def evaluate_once(self, now: Optional[float] = None) -> Dict[str, str]:
        """Evaluate every objective; returns ``{slo_name: state}``."""
        t = self._clock() if now is None else float(now)
        with self._lock:
            slos = list(self._slos.values())
            callbacks = list(self._on_transition)
        out: Dict[str, str] = {}
        for slo in slos:
            out[slo.name] = self._evaluate(slo, t, callbacks)
        return out

    def _evaluate(self, slo: SLO, t: float, callbacks) -> str:
        bad_fast = slo.bad_fraction(self._recorder, slo.fast_window_s, t)
        bad_slow = slo.bad_fraction(self._recorder, slo.slow_window_s, t)
        burn_fast = None if bad_fast is None else bad_fast / slo.budget
        burn_slow = None if bad_slow is None else bad_slow / slo.budget
        bf = burn_fast if burn_fast is not None else 0.0
        bs = burn_slow if burn_slow is not None else 0.0
        if bf >= slo.page_burn and bs >= slo.warn_burn:
            target = "page"
        elif bf >= slo.warn_burn or bs >= slo.warn_burn:
            target = "warning"
        else:
            target = "ok"

        with self._lock:
            st = self._states[slo.name]
            st.burn_fast, st.burn_slow = burn_fast, burn_slow
            st.no_data = burn_fast is None and burn_slow is None
            st.last_eval_at = t
            old = st.state
            rank = STATES.index
            if rank(target) > rank(old):
                st.state = target          # escalate immediately
                st.clean_evals = 0
            elif rank(target) < rank(old):
                st.clean_evals += 1        # hysteresis on the way down
                if st.clean_evals >= slo.clear_after:
                    st.state = target
                    st.clean_evals = 0
            else:
                st.clean_evals = 0
            new = st.state
            if new != old:
                st.transitions.append({
                    "at": t, "from": old, "to": new,
                    "burn_fast": burn_fast, "burn_slow": burn_slow,
                })
                del st.transitions[:-32]   # bounded transition history
        self._export(slo, new)
        if new != old:
            self._announce(slo, old, new, burn_fast, burn_slow, callbacks)
        return new

    def _export(self, slo: SLO, state: str) -> None:
        with self._lock:
            st = self._states[slo.name]
            bf, bs = st.burn_fast, st.burn_slow
        reg = self._registry
        reg.gauge(f"slo.{slo.name}.state").set(STATES.index(state))
        if bf is not None:
            reg.gauge(f"slo.{slo.name}.burn_fast").set(bf)
        if bs is not None:
            reg.gauge(f"slo.{slo.name}.burn_slow").set(bs)

    def _announce(self, slo, old, new, burn_fast, burn_slow, callbacks):
        self._registry.counter("slo.transitions").add(1)
        attrs = {
            "slo": slo.name, "from_state": old, "to_state": new,
            "burn_fast": burn_fast, "burn_slow": burn_slow,
        }
        from sparkdl_tpu_torch.obs.trace import record_event, tracer

        record_event("slo_transition", **attrs)
        if tracer.enabled:
            span = tracer.start_span("slo.transition", **attrs)
            if span is not None:
                span.end()
        # breadcrumb for the post-mortem ring, when a recorder is armed
        from sparkdl_tpu_torch.obs import blackbox

        blackbox.note("slo_transition", **attrs)
        if new == "page":
            blackbox.dump(f"slo_page_{slo.name}")
        for cb in callbacks:
            try:
                cb(slo, old, new, self._states[slo.name])
            except Exception:  # pragma: no cover - a hook must not
                pass           # break the evaluation loop

    # ------------------------------------------------------------------
    # lifecycle / export
    # ------------------------------------------------------------------
    def start(self, interval_s: float = 5.0) -> "SLOEngine":
        """Evaluate on a daemon thread every ``interval_s`` (idempotent)."""
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return self
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, args=(float(interval_s),),
                name="sparkdl-slo-engine", daemon=True,
            )
            self._thread.start()
        return self

    def _run(self, interval_s: float) -> None:
        while not self._stop.wait(interval_s):
            try:
                self.evaluate_once()
            except Exception:  # pragma: no cover - must not die
                pass

    def stop(self) -> None:
        self._stop.set()
        with self._lock:
            thread = self._thread
            self._thread = None
        if thread is not None and thread.is_alive():
            thread.join(timeout=5.0)

    def states(self) -> Dict[str, str]:
        with self._lock:
            return {name: st.state for name, st in self._states.items()}

    def worst_state(self) -> str:
        states = self.states()
        if not states:
            return "ok"
        return max(states.values(), key=STATES.index)

    def report(self) -> Dict:
        """The ``/slo`` endpoint payload: every objective with its
        config, current burn rates, state, and recent transitions."""
        with self._lock:
            rows = []
            for name, slo in sorted(self._slos.items()):
                st = self._states[name]
                rows.append({
                    "name": name,
                    "kind": slo.kind,
                    "objective": slo.objective,
                    "description": slo.description,
                    "series": slo.series or {
                        "numerator": slo.numerator,
                        "denominator": slo.denominator,
                    },
                    "threshold": slo.threshold,
                    "windows_s": [slo.fast_window_s, slo.slow_window_s],
                    "burns": [slo.warn_burn, slo.page_burn],
                    "state": st.state,
                    "burn_fast": st.burn_fast,
                    "burn_slow": st.burn_slow,
                    "no_data": st.no_data,
                    "last_eval_at": st.last_eval_at,
                    "transitions": list(st.transitions),
                })
        worst = "ok"
        for row in rows:
            if STATES.index(row["state"]) > STATES.index(worst):
                worst = row["state"]
        return {"worst": worst, "slos": rows}


# ---------------------------------------------------------------------------
# bundles the subsystems wire in
# ---------------------------------------------------------------------------

def serving_slos(
    model_id: str,
    latency_quantile: str = "p99",
    latency_threshold_ms: float = 250.0,
    latency_objective: float = 0.99,
    error_objective: float = 0.999,
    **overrides,
) -> List[SLO]:
    """The per-endpoint pair: a latency-quantile objective over the endpoint's sampled
    ``serving.latency_ms.<id>.p99`` series and an error-rate objective
    over its ``serving.errors.<id>`` / ``serving.requests.<id>``
    counters.  ``overrides`` (``fast_window_s`` etc.) apply to both."""
    mid = sanitize_name(model_id)
    return [
        SLO(
            name=f"serving.{mid}.latency",
            kind="threshold",
            series=f"serving.latency_ms.{mid}.{latency_quantile}",
            threshold=latency_threshold_ms,
            objective=latency_objective,
            description=(
                f"{latency_quantile} latency of endpoint {model_id!r} "
                f"under {latency_threshold_ms:g} ms"
            ),
            **overrides,
        ),
        SLO(
            name=f"serving.{mid}.errors",
            kind="error_rate",
            numerator=f"serving.errors.{mid}",
            denominator=f"serving.requests.{mid}",
            objective=error_objective,
            description=f"request success rate of endpoint {model_id!r}",
            **overrides,
        ),
    ]


def _router_label(name: str) -> str:
    """The router's metric-segment form of a version/tenant label
    (``[a-z0-9_]`` — no dots, unlike :func:`sanitize_name`): the series
    these factories watch must match what the router actually emits."""
    out = re.sub(r"[^a-z0-9_]", "_", str(name).lower())
    return out or "unknown"


def rollout_slos(
    version: str,
    latency_quantile: str = "p99",
    latency_threshold_ms: float = 250.0,
    latency_objective: float = 0.95,
    error_objective: float = 0.99,
    **overrides,
) -> List[SLO]:
    """The canary pair a :class:`~sparkdl_tpu_torch.serving.rollout
    .RolloutController` watches: a latency-quantile objective over the
    router's *per-version* attempt series
    (``router.latency_ms.<version>.p99``) and an error-rate objective
    over ``router.errors.<version>`` / ``router.requests.<version>``.
    Per-version series are attempt-level, so a 1%-weight canary is
    measurable on its own traffic.  Objectives default looser than the
    fleet SLOs (0.95 / 0.99): a canary page must mean the *new
    version* is bad, not that one slow request landed on it.  Names are
    ``rollout.<version>.latency`` / ``rollout.<version>.errors`` — the
    ``rollout.<version>.`` prefix is what the controller's default
    watch list matches."""
    ver = _router_label(version)
    return [
        SLO(
            name=f"rollout.{ver}.latency",
            kind="threshold",
            series=f"router.latency_ms.{ver}.{latency_quantile}",
            threshold=latency_threshold_ms,
            objective=latency_objective,
            description=(
                f"{latency_quantile} attempt latency of version "
                f"{version!r} under {latency_threshold_ms:g} ms"
            ),
            **overrides,
        ),
        SLO(
            name=f"rollout.{ver}.errors",
            kind="error_rate",
            numerator=f"router.errors.{ver}",
            denominator=f"router.requests.{ver}",
            objective=error_objective,
            description=f"attempt success rate of version {version!r}",
            **overrides,
        ),
    ]


def fleet_rollout_slos(
    version: str,
    latency_quantile: str = "p99",
    latency_threshold_ms: float = 250.0,
    latency_objective: float = 0.95,
    error_objective: float = 0.99,
    **overrides,
) -> List[SLO]:
    """The *replica-attributed* canary pair: objectives over the
    federated ``fleet.version.<version>.serving.*`` series a
    :class:`~sparkdl_tpu_torch.obs.fleet.FleetCollector` scrapes from the
    canary replicas themselves.  The router-side :func:`rollout_slos`
    measures attempts *the router saw complete* — its retry loop
    re-places a failing canary's requests on healthy replicas, so the
    router-side error series can stay clean while the canary burns.
    These objectives read the canary's own registry (queue depth spikes,
    replica-side errors, forward-path latency), so the rollout
    controller pages on what the canary *experienced*, not on what the
    router salvaged.  Names carry the ``fleet.rollout.<version>.``
    prefix, which the controller's default watch list also matches."""
    ver = _router_label(version)
    return [
        SLO(
            name=f"fleet.rollout.{ver}.latency",
            kind="threshold",
            series=(
                f"fleet.version.{ver}.serving.latency_ms"
                f".{latency_quantile}"
            ),
            threshold=latency_threshold_ms,
            objective=latency_objective,
            description=(
                f"replica-side {latency_quantile} latency of version "
                f"{version!r} under {latency_threshold_ms:g} ms "
                "(federated)"
            ),
            **overrides,
        ),
        SLO(
            name=f"fleet.rollout.{ver}.errors",
            kind="error_rate",
            numerator=f"fleet.version.{ver}.serving.errors",
            denominator=f"fleet.version.{ver}.serving.requests",
            objective=error_objective,
            description=(
                f"replica-side success rate of version {version!r} "
                "(federated)"
            ),
            **overrides,
        ),
    ]


def tenant_slos(
    tenant: str,
    latency_quantile: str = "p99",
    latency_threshold_ms: float = 250.0,
    latency_objective: float = 0.95,
    error_objective: float = 0.99,
    **overrides,
) -> List[SLO]:
    """Per-tenant objectives over the router's tenant-labelled series
    (``router.tenant.<tenant>.*``) — what the fairness harness asserts:
    tenant B's pair must stay ``ok`` while tenant A saturates its
    share."""
    ten = _router_label(tenant)
    return [
        SLO(
            name=f"tenant.{ten}.latency",
            kind="threshold",
            series=f"router.tenant.{ten}.latency_ms.{latency_quantile}",
            threshold=latency_threshold_ms,
            objective=latency_objective,
            description=(
                f"{latency_quantile} latency for tenant {tenant!r} "
                f"under {latency_threshold_ms:g} ms"
            ),
            **overrides,
        ),
        SLO(
            name=f"tenant.{ten}.errors",
            kind="error_rate",
            numerator=f"router.tenant.{ten}.errors",
            denominator=f"router.tenant.{ten}.requests",
            objective=error_objective,
            description=f"request success rate for tenant {tenant!r}",
            **overrides,
        ),
    ]


def streaming_slos(
    max_watermark_lag_ms: float = 5000.0,
    lag_objective: float = 0.95,
    min_commit_rate: Optional[float] = None,
    **overrides,
) -> List[SLO]:
    """The streaming bundle (:meth:`StreamRunner.slos`): bounded
    watermark lag, and optionally a committed-epoch throughput floor."""
    out = [
        SLO(
            name="streaming.watermark_lag",
            kind="threshold",
            series="streaming.watermark_lag_ms",
            threshold=max_watermark_lag_ms,
            objective=lag_objective,
            description=(
                f"watermark lag under {max_watermark_lag_ms:g} ms"
            ),
            **overrides,
        ),
    ]
    if min_commit_rate is not None:
        out.append(SLO(
            name="streaming.commit_rate",
            kind="rate_min",
            series="streaming.epochs_committed",
            threshold=float(min_commit_rate),
            objective=0.99,
            description=(
                f"committed epochs per second >= {min_commit_rate:g}"
            ),
            **overrides,
        ))
    return out


def availability_slo(
    series: str = "sparkdl.up",
    objective: float = 0.999,
    **overrides,
) -> SLO:
    """Process availability over an up/health gauge (sampled 1 while
    healthy, 0 while not — the obs server's health poller feeds it)."""
    return SLO(
        name="availability",
        kind="availability",
        series=series,
        objective=objective,
        description=f"availability of {series}",
        **overrides,
    )
