"""Request router: spread traffic across live replicas, lose nothing.

Port of ``sparkdl_tpu.serving.router`` (host code: a copy with the
package renamed). The front half of the replica plane: the supervisor registers replicas
as they come up (and removes them the moment a drain or death begins),
and :meth:`Router.route` places each request on the live replica with
the fewest in-flight requests (least-loaded — with one router process
this measures true queue pressure, which power-of-two-choices only
approximates).

**Delivery contract** (what the kill-matrix test asserts): once
:meth:`route` accepts a request, it returns a result or a *typed* error
— a replica dying mid-request surfaces here as a connection error and
the request is transparently re-sent to a surviving replica
(``router.retries``).  Inference is idempotent, so at-least-once
re-execution is safe; replies classified *transient*
(:class:`~sparkdl_tpu_torch.serving.errors.ReplicaDraining`, a replica-side
``ServerOverloaded``) are also re-routed, while permanent model errors
propagate untouched.  Only when no live replica remains does the typed
:class:`~sparkdl_tpu_torch.serving.errors.NoLiveReplicas` surface.

**Versioned placement**: every backend carries a deployment
``version`` ("v1" by default) and :meth:`set_weights` splits traffic
across versions by weight — the blue/green dial a rollout controller
turns through 1% → 50% → 100%.  A request may pin a version explicitly with the
``name@version`` endpoint form (``"ep0@v2"``); unpinned requests follow
the weights.  A zero-weight version receives *no* unpinned traffic
(the rollback guarantee) — unless every candidate version is
zero-weighted, in which case availability wins over the split and the
fallback is counted in ``router.weight_fallback``.  Per-version series
(``router.requests.<v>`` / ``router.errors.<v>`` /
``router.latency_ms.<v>``) are *attempt*-level so a misbehaving canary
at 1% weight is measurable on its own, and per-tenant series
(``router.tenant.<t>.*``) give the SLO engine a per-tenant page signal.

Admission control sits in front: ``max_inflight`` bounds the router's
total in-flight work (beyond it requests shed with the transient
``ServerOverloaded``, counted in ``router.shed``) — the knob the SLO
autoscaler turns together with the replica count.

:meth:`Router.serve` opens the wire-protocol front door that
multi-process load generators connect to.
"""

from __future__ import annotations

import bisect
import collections
import os
import queue
import random
import socket
import socketserver
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from sparkdl_tpu_torch.obs.trace import tracer
from sparkdl_tpu_torch.resilience import inject
from sparkdl_tpu_torch.serving import transport as transport_mod
from sparkdl_tpu_torch.serving import wire
from sparkdl_tpu_torch.serving.errors import (
    DeadlineExceeded,
    NoLiveReplicas,
    ServerOverloaded,
)
from sparkdl_tpu_torch.serving.result_cache import (
    ENV_RESULT_CACHE,
    ENV_RESULT_CACHE_BYTES,
    ResultCache,
    canonical_digest,
    result_key,
)
from sparkdl_tpu_torch.utils.metrics import metrics

#: version every backend belongs to unless told otherwise
DEFAULT_VERSION = "v1"

ENV_HEDGE = "SPARKDL_HEDGE"                       # "0" disables hedging
ENV_HEDGE_QUANTILE = "SPARKDL_HEDGE_QUANTILE"     # trigger quantile
ENV_HEDGE_MIN_MS = "SPARKDL_HEDGE_MIN_MS"         # floor on the trigger
ENV_HEDGE_WARMUP = "SPARKDL_HEDGE_WARMUP"         # samples before hedging
ENV_RETRY_RATIO = "SPARKDL_RETRY_BUDGET_RATIO"    # tokens earned/request
ENV_RETRY_BURST = "SPARKDL_RETRY_BUDGET_BURST"    # bucket capacity

#: recent attempt latencies kept for the hedge-trigger quantile
_HEDGE_WINDOW = 256


class _RetryBudget:
    """Token bucket capping fleet-wide retry *amplification*: every
    admitted request earns ``ratio`` tokens (capped at ``burst``), and
    every extra attempt — retry or hedge — spends one.  Under a full
    brownout the extra-attempt rate is thus bounded at ``ratio`` per
    request plus a one-off ``burst``, so a bad minute degrades into
    typed errors instead of a self-amplifying retry storm (the
    Google-SRE retry-budget idiom).  Denials surface the *last typed
    error*, never a blind reclassification."""

    def __init__(self, ratio: float, burst: float):
        self.ratio = float(ratio)
        self.burst = float(burst)
        self._tokens = self.burst
        self._lock = threading.Lock()
        self._m_spent = metrics.counter("router.retry_budget.spent")
        self._m_denied = metrics.counter("router.retry_budget.denied")
        self._m_tokens = metrics.gauge("router.retry_budget.tokens")
        self._m_tokens.set(self._tokens)

    def earn(self) -> None:
        with self._lock:
            self._tokens = min(self.burst, self._tokens + self.ratio)
            self._m_tokens.set(self._tokens)

    def spend(self) -> bool:
        with self._lock:
            if self._tokens < 1.0:
                self._m_denied.add(1)
                return False
            self._tokens -= 1.0
            self._m_tokens.set(self._tokens)
            self._m_spent.add(1)
            return True


def split_versioned(model_id: Optional[str]) -> Tuple[Optional[str], Optional[str]]:
    """``"ep0@v2"`` -> ``("ep0", "v2")``; ``"ep0"`` -> ``("ep0", None)``.
    The version half never reaches the replica — its endpoints are
    version-unaware; the pin only constrains router placement."""
    if model_id is None or "@" not in model_id:
        return model_id, None
    base, _, version = model_id.rpartition("@")
    return (base or None), (version or None)


def _sanitize_label(label: str) -> str:
    """Metric-segment-safe form of a tenant/version label."""
    return "".join(
        ch if (ch.isalnum() or ch == "_") else "_"
        for ch in label.lower()
    ) or "unknown"


class _Backend:
    """One registered replica: a :class:`~sparkdl_tpu_torch.serving.transport.
    Transport` picked from the lanes it advertised at handshake, plus
    the in-flight count the balancer reads."""

    def __init__(self, name: str, host: str, port: int,
                 lanes: Tuple[str, ...] = ("tcp",),
                 version: str = DEFAULT_VERSION,
                 connect_timeout_s: float = 2.0,
                 io_timeout_s: float = 30.0,
                 transport=None):
        self.name = name
        self.host = host
        self.port = int(port)
        self.version = str(version)
        self.inflight = 0
        self.removed = False
        # an injected transport (the sim's virtual replica) skips the
        # socket handshake entirely; live fleets use the lane factory
        self.transport = transport if transport is not None else (
            transport_mod.make_transport(
                host, int(port), lanes=lanes,
                connect_timeout_s=connect_timeout_s,
                io_timeout_s=io_timeout_s,
            )
        )

    def close(self) -> None:
        self.removed = True
        self.transport.close()


class _VersionInstruments:
    """Cached per-version counters/histogram (hot path: no registry
    lookup per request)."""

    __slots__ = ("requests", "errors", "latency")

    def __init__(self, version: str):
        label = _sanitize_label(version)
        self.requests = metrics.counter(f"router.requests.{label}")
        self.errors = metrics.counter(f"router.errors.{label}")
        self.latency = metrics.histogram(f"router.latency_ms.{label}")


class _TenantInstruments:
    __slots__ = ("requests", "errors", "shed", "latency")

    def __init__(self, tenant: str):
        label = _sanitize_label(tenant)
        self.requests = metrics.counter(f"router.tenant.{label}.requests")
        self.errors = metrics.counter(f"router.tenant.{label}.errors")
        self.shed = metrics.counter(f"router.tenant.{label}.shed")
        self.latency = metrics.histogram(f"router.tenant.{label}.latency_ms")


class Router:
    """Weighted version split + least-loaded placement + stranded-request
    retry over the registered replica set (see module docstring for the
    contract)."""

    def __init__(
        self,
        max_inflight: Optional[int] = None,
        request_timeout_s: float = 30.0,
        connect_timeout_s: float = 2.0,
        seed: int = 0,
        hedge: Optional[bool] = None,
        hedge_quantile: Optional[float] = None,
        hedge_min_ms: Optional[float] = None,
        hedge_warmup: Optional[int] = None,
        retry_budget_ratio: Optional[float] = None,
        retry_budget_burst: Optional[float] = None,
        result_cache: Optional[ResultCache] = None,
        clock=time.monotonic,
    ):
        self._lock = threading.Lock()
        #: injectable time source — every latency stamp, deadline check,
        #: and hedge trigger below reads this instead of the wall clock,
        #: so the sim can drive the router in virtual time
        self._clock = clock
        self._backends: Dict[str, _Backend] = {}
        self._weights: Dict[str, float] = {}
        self._rng = random.Random(seed)
        self._max_inflight = (
            int(max_inflight) if max_inflight is not None else None
        )
        self._total_inflight = 0
        self._request_timeout_s = float(request_timeout_s)
        self._connect_timeout_s = float(connect_timeout_s)
        self._closed = False
        self._m_requests = metrics.counter("router.requests")
        self._m_attempts = metrics.counter("router.attempts")
        self._m_retries = metrics.counter("router.retries")
        self._m_errors = metrics.counter("router.errors")
        self._m_shed = metrics.counter("router.shed")
        self._m_expired = metrics.counter("router.deadline_expired")
        self._m_latency = metrics.histogram("router.latency_ms")
        self._m_inflight = metrics.gauge("router.inflight")
        self._m_replicas = metrics.gauge("router.replicas")
        self._m_weight_fallback = metrics.counter("router.weight_fallback")
        self._m_hedge_fired = metrics.counter("router.hedge.fired")
        self._m_hedge_wins = metrics.counter("router.hedge.wins")
        self._vm: Dict[str, _VersionInstruments] = {}
        self._tm: Dict[str, _TenantInstruments] = {}
        self._m_phase: Dict[str, Any] = {}
        # hedging: a second attempt fires when the first has run past
        # the recent attempt-latency quantile — a tail-latency rescue,
        # not a throughput feature, so it needs a warm sample window
        # and >= 2 live backends before it ever triggers
        if hedge is None:
            hedge = os.environ.get(ENV_HEDGE, "1") != "0"
        self._hedge_enabled = bool(hedge)
        self._hedge_quantile = (
            float(hedge_quantile) if hedge_quantile is not None
            else float(os.environ.get(ENV_HEDGE_QUANTILE, "0.95"))
        )
        self._hedge_min_ms = (
            float(hedge_min_ms) if hedge_min_ms is not None
            else float(os.environ.get(ENV_HEDGE_MIN_MS, "10"))
        )
        self._hedge_warmup = (
            int(hedge_warmup) if hedge_warmup is not None
            else int(os.environ.get(ENV_HEDGE_WARMUP, "20"))
        )
        self._attempt_ms: collections.deque = collections.deque(
            maxlen=_HEDGE_WINDOW
        )
        # the same window kept sorted (insort on observe, evictee
        # removed by bisect) so the hedge-trigger quantile is two index
        # reads per request instead of a full sort of the window
        self._attempt_ms_sorted: List[float] = []
        self._sample_lock = threading.Lock()
        self._retry_budget = _RetryBudget(
            ratio=(
                retry_budget_ratio if retry_budget_ratio is not None
                else float(os.environ.get(ENV_RETRY_RATIO, "0.5"))
            ),
            burst=(
                retry_budget_burst if retry_budget_burst is not None
                else float(os.environ.get(ENV_RETRY_BURST, "32"))
            ),
        )
        # content-addressed result cache — opt-in: load generators send
        # constant inputs, so an always-on cache would silently turn
        # every established baseline into a hit-rate test
        if result_cache is None and os.environ.get(ENV_RESULT_CACHE) == "1":
            result_cache = ResultCache(max_bytes=int(
                os.environ.get(ENV_RESULT_CACHE_BYTES, str(64 * 1024 * 1024))
            ))
        self._result_cache = result_cache
        #: (version, model_id) -> engine fingerprint, fed by :meth:`add`
        #: from each replica's ready-line advertisement.  Entries are
        #: keyed by version, never flushed: a rollout flip simply makes
        #: requests resolve v2's fingerprint, so v1 keys stop matching.
        self._fingerprints: Dict[Tuple[str, str], str] = {}
        self._m_cache_collapsed = metrics.counter("router.cache.collapsed")

    # ------------------------------------------------------------------
    # membership (the supervisor's side of the interface)
    # ------------------------------------------------------------------
    def add(self, name: str, host: str, port: int,
            lanes: Tuple[str, ...] = ("tcp",),
            version: str = DEFAULT_VERSION,
            fingerprints: Optional[Dict[str, str]] = None,
            transport=None) -> None:
        """Register a replica.  ``lanes`` is what it advertised in its
        ready line; the transport factory (and the
        ``SPARKDL_WIRE_TRANSPORT`` override) picks the lane.
        ``version`` is the deployment group weighted placement splits
        over.  ``fingerprints`` maps the replica's endpoint ids to their
        engine fingerprints — the version half of every result-cache
        key; an endpoint that advertises none stays uncacheable.
        ``transport`` injects a ready-made transport (the sim's virtual
        replica) instead of dialing ``host:port``."""
        backend = _Backend(
            name, host, port, lanes=tuple(lanes), version=version,
            connect_timeout_s=self._connect_timeout_s,
            io_timeout_s=self._request_timeout_s,
            transport=transport,
        )
        with self._lock:
            old = self._backends.pop(name, None)
            self._backends[name] = backend
            self._m_replicas.set(len(self._backends))
            for mid, fp in (fingerprints or {}).items():
                if fp:
                    self._fingerprints[(str(version), str(mid))] = str(fp)
        if old is not None:
            old.close()

    @property
    def result_cache(self) -> Optional[ResultCache]:
        """The router-tier result cache, or None when disabled (what
        the supervisor hands ``/debug/cache``)."""
        return self._result_cache

    def remove(self, name: str) -> None:
        """Stop placing on ``name`` (drain-begin or death).  In-flight
        requests on its sockets fail over on their own."""
        with self._lock:
            backend = self._backends.pop(name, None)
            self._m_replicas.set(len(self._backends))
        if backend is not None:
            backend.close()

    def names(self) -> Tuple[str, ...]:
        with self._lock:
            return tuple(self._backends)

    def lanes(self) -> Dict[str, str]:
        """Backend name -> lane currently carrying its requests."""
        with self._lock:
            return {b.name: b.transport.lane
                    for b in self._backends.values()}

    def versions(self) -> Dict[str, int]:
        """Deployment version -> registered backend count."""
        with self._lock:
            out: Dict[str, int] = {}
            for b in self._backends.values():
                out[b.version] = out.get(b.version, 0) + 1
            return out

    # ------------------------------------------------------------------
    # traffic split (the rollout controller's side of the interface)
    # ------------------------------------------------------------------
    def set_weights(self, weights: Dict[str, float]) -> None:
        """Replace the version traffic split.  Unlisted versions keep
        the implicit weight 1.0 (a fresh fleet needs no configuration);
        an explicit 0.0 starves the version of unpinned traffic."""
        clean = {}
        for version, w in weights.items():
            w = float(w)
            if w < 0:
                raise ValueError(
                    f"weight for {version!r} must be >= 0, got {w}"
                )
            clean[str(version)] = w
        with self._lock:
            self._weights = clean
        for version, w in clean.items():
            metrics.gauge(
                f"router.weight.{_sanitize_label(version)}"
            ).set(w)

    def weights(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._weights)

    def set_max_inflight(self, n: Optional[int]) -> None:
        """The admission limit — the autoscaler's second knob."""
        with self._lock:
            self._max_inflight = int(n) if n is not None else None

    @property
    def max_inflight(self) -> Optional[int]:
        with self._lock:
            return self._max_inflight

    # ------------------------------------------------------------------
    # request path
    # ------------------------------------------------------------------
    def _admit(self, tm: Optional[_TenantInstruments]) -> None:
        with self._lock:
            limit = self._max_inflight
            if limit is not None and self._total_inflight >= limit:
                self._m_shed.add(1)
                if tm is not None:
                    tm.shed.add(1)
                raise ServerOverloaded(
                    f"router at admission limit ({limit} in flight); "
                    "load-shedding"
                )
            self._total_inflight += 1
            self._m_inflight.set(self._total_inflight)

    def _release(self) -> None:
        with self._lock:
            self._total_inflight -= 1
            self._m_inflight.set(self._total_inflight)

    def _version_instruments(self, version: str) -> _VersionInstruments:
        vm = self._vm.get(version)
        if vm is None:
            vm = self._vm.setdefault(version, _VersionInstruments(version))
        return vm

    def _tenant_instruments(
        self, tenant: Optional[str]
    ) -> Optional[_TenantInstruments]:
        if tenant is None:
            return None
        tm = self._tm.get(tenant)
        if tm is None:
            tm = self._tm.setdefault(tenant, _TenantInstruments(tenant))
        return tm

    def _roll_version(self, pin: Optional[str]) -> Optional[str]:
        """The deployment version this request will be served by: the
        pin when given, else one weighted roll over the live versions —
        made ONCE, before the cache lookup, so the cache key and the
        placement agree (the miss path then pins ``_pick`` to the
        rolled version instead of rolling again).  None when no live
        version exists or every candidate is zero-weighted (placement
        unpredictable -> uncacheable this request)."""
        with self._lock:
            versions = sorted({
                b.version for b in self._backends.values()
                if not b.removed and (pin is None or b.version == pin)
            })
            if not versions:
                return None
            if pin is not None:
                return pin
            if len(versions) == 1:
                return versions[0]
            weighted = [(v, self._weights.get(v, 1.0)) for v in versions]
            total = sum(w for _, w in weighted)
            if total <= 0:
                return None
            roll = self._rng.random() * total
            acc = 0.0
            for v, w in weighted:
                acc += w
                if roll < acc:
                    return v
            return weighted[-1][0]

    def _pick(self, tried, pin: Optional[str] = None) -> Optional[_Backend]:
        """Choose a version by weight (or honour ``pin``), then the
        backend with the fewest in-flight within it, excluding
        ``tried``."""
        with self._lock:
            candidates = [
                b for b in self._backends.values()
                if b.name not in tried and not b.removed
                and (pin is None or b.version == pin)
            ]
            if not candidates:
                return None
            by_version: Dict[str, list] = {}
            for b in candidates:
                by_version.setdefault(b.version, []).append(b)
            if pin is None and len(by_version) > 1:
                weighted = [
                    (v, self._weights.get(v, 1.0)) for v in by_version
                ]
                total = sum(w for _, w in weighted)
                if total > 0:
                    roll = self._rng.random() * total
                    acc = 0.0
                    chosen = weighted[-1][0]
                    for v, w in weighted:
                        acc += w
                        if roll < acc:
                            chosen = v
                            break
                    candidates = by_version[chosen]
                else:
                    # every candidate version is weighted to zero —
                    # serve anyway (availability > split fidelity) and
                    # make the breach countable
                    self._m_weight_fallback.add(1)
            elif pin is None and len(by_version) == 1:
                only = next(iter(by_version))
                if self._weights.get(only, 1.0) == 0.0:
                    # the sole surviving version is the starved one:
                    # availability wins, but visibly
                    self._m_weight_fallback.add(1)
            best = min(candidates, key=lambda b: b.inflight)
            best.inflight += 1
            return best

    def _unpick(self, backend: _Backend) -> None:
        with self._lock:
            backend.inflight -= 1

    def _observe_attempt_ms(self, ms: float) -> None:
        with self._sample_lock:
            if len(self._attempt_ms) == self._attempt_ms.maxlen:
                evicted = self._attempt_ms[0]
                del self._attempt_ms_sorted[
                    bisect.bisect_left(self._attempt_ms_sorted, evicted)
                ]
            self._attempt_ms.append(ms)
            bisect.insort(self._attempt_ms_sorted, ms)

    def _hedge_delay_s(self, deadline: float) -> Optional[float]:
        """Seconds to wait on the primary before firing a hedge, or
        ``None`` when hedging must stay off: disabled, cold (not enough
        latency samples), fewer than two live backends, or the deadline
        already blown.  The trigger is the recent attempt-latency
        quantile floored at ``hedge_min_ms`` and clamped to half the
        remaining deadline (a hedge that can't finish is pure load)."""
        if not self._hedge_enabled:
            return None
        with self._lock:
            live = sum(
                1 for b in self._backends.values() if not b.removed
            )
        if live < 2:
            return None
        with self._sample_lock:
            samples = self._attempt_ms_sorted
            if len(samples) < self._hedge_warmup:
                return None
            idx = min(
                len(samples) - 1,
                int(self._hedge_quantile * len(samples)),
            )
            delay_ms = max(self._hedge_min_ms, samples[idx])
        remaining_s = deadline - self._clock()
        if remaining_s <= 0:
            return None
        return min(delay_ms / 1000.0, remaining_s / 2.0)

    def _observe_phase(self, name: str, ms: float,
                       exemplar: Optional[int] = None) -> None:
        h = self._m_phase.get(name)
        if h is None:
            h = self._m_phase.setdefault(
                name,
                metrics.histogram(
                    f"router.phase.{_sanitize_label(str(name))}"
                ),
            )
        h.observe(float(ms), exemplar=exemplar)

    def _cache_lookup(self, base_id, pin, value, tm, span):
        """Router-tier result-cache step.  Returns
        ``(hit_reply, key, version, lookup_ms)``: a non-None
        ``hit_reply`` is served NOW — before admission, placement, or
        any wire frame; a non-None ``key`` tells the miss path to pin
        placement to ``version`` and populate the key on success.
        Fail-open by contract: any failure in here (including an
        injected ``cache.lookup`` fault) degrades the request to plain
        miss-path scoring, never to an error."""
        cache = self._result_cache
        if cache is None or base_id is None or value is None:
            return None, None, None, None
        t0 = self._clock()
        try:
            inject.fire("cache.lookup")
            version = self._roll_version(pin)
            fp = (
                self._fingerprints.get((version, base_id))
                if version is not None else None
            )
            if fp is None:
                # no fingerprint -> no stable identity to key on (the
                # compile cache's rule at request granularity)
                cache.uncacheable()
                return None, None, None, (self._clock() - t0) * 1000.0
            key = result_key(fp, canonical_digest(value))
            hit = cache.get(key)
            lookup_ms = (self._clock() - t0) * 1000.0
            if hit is None:
                return None, key, version, lookup_ms
        except Exception:
            return None, None, None, None
        # the hit: charged to the tenant (same DRR accounting as a
        # scored request) but consuming no admission slot and no
        # replica inflight budget; stamped as its own ``cache`` phase
        # so diag attribution still explains e2e p50
        self._m_requests.add(1)
        if tm is not None:
            tm.requests.add(1)
        exemplar = span.trace_id if span is not None else None
        self._m_latency.observe(lookup_ms, exemplar=exemplar)
        if tm is not None:
            tm.latency.observe(lookup_ms, exemplar=exemplar)
        self._observe_phase("cache", lookup_ms, exemplar)
        reply = {
            "ok": True,
            "result": hit,
            "server_ms": None,
            "cache": "hit",
            "phases": {"cache": lookup_ms},
        }
        if span is not None:
            span.set_attribute("cache", "hit")
            span.set_attribute("phases", {"cache": lookup_ms})
            span.set_attribute("e2e_ms", lookup_ms)
        return reply, key, version, lookup_ms

    def _classify(self, exc: BaseException) -> str:
        """``"retry"`` for connection-shaped or transient-typed
        failures (the re-place-elsewhere class), ``"raise"`` for
        permanent ones."""
        from sparkdl_tpu_torch.resilience.errors import is_transient

        if isinstance(
            exc, (ConnectionError, OSError, socket.timeout)
        ) or is_transient(exc):
            return "retry"
        return "raise"

    def _one_attempt(self, backend: _Backend, value, base_id,
                     propagate_deadline: bool, tenant: Optional[str],
                     deadline: float, span) -> Dict[str, Any]:
        """One wire round trip on an already-picked backend, charged to
        its version series and the hedge sample window.  The replica
        sees the *remaining* milliseconds (when the caller set a
        deadline at all), so downstream shedding works off the same
        end-to-end clock.  Always unpicks; per-version latency is
        per-*attempt* so a retried request doesn't charge the surviving
        version for time the dying one burned."""
        vm = self._version_instruments(backend.version)
        vm.requests.add(1)
        self._m_attempts.add(1)
        t0 = self._clock()
        try:
            reply = self._send_one(
                backend, value, base_id,
                (
                    max(1.0, (deadline - t0) * 1000.0)
                    if propagate_deadline else None
                ),
                tenant,
                max(0.05, deadline - t0),
                trace=(span.context() if span is not None else None),
            )
        except Exception:
            vm.errors.add(1)
            raise
        finally:
            self._unpick(backend)
        ms = (self._clock() - t0) * 1000.0
        vm.latency.observe(
            ms, exemplar=span.trace_id if span is not None else None,
        )
        self._observe_attempt_ms(ms)
        return reply

    def _attempt_or_hedge(self, primary: _Backend, tried, pin,
                          value, base_id, propagate_deadline: bool,
                          tenant: Optional[str], deadline: float, span):
        """Attempt on ``primary``; when hedging is warm, race a second
        attempt on another backend if the primary runs past the trigger
        latency — first success wins, the loser finishes (and unpicks
        itself) in the background, since a synchronous socket read
        can't be cancelled.  Returns ``(reply, winner, t_start)``;
        failed backends land in ``tried``.  A permanent failure raises
        immediately; transient ones drain the race then re-raise the
        last for the outer retry loop.  When hedging can't trigger,
        this degrades to a plain inline call — no extra threads."""
        delay = self._hedge_delay_s(deadline)
        t_start = self._clock()
        if delay is None:
            try:
                reply = self._one_attempt(
                    primary, value, base_id, propagate_deadline,
                    tenant, deadline, span,
                )
            except Exception:
                tried.add(primary.name)
                raise
            return reply, primary, t_start

        q: "queue.SimpleQueue" = queue.SimpleQueue()

        def run(backend: _Backend, is_hedge: bool) -> None:
            try:
                r = self._one_attempt(
                    backend, value, base_id, propagate_deadline,
                    tenant, deadline, span,
                )
                q.put((backend, is_hedge, r, None))
            except BaseException as exc:
                q.put((backend, is_hedge, None, exc))

        threading.Thread(
            target=run, args=(primary, False),
            name="sparkdl-router-attempt", daemon=True,
        ).start()
        in_flight = 1
        hedge_decided = False
        last_exc: Optional[BaseException] = None
        while in_flight:
            try:
                item = (
                    q.get(timeout=delay) if not hedge_decided else q.get()
                )
            except queue.Empty:
                # the primary is out past the trigger: fire the hedge —
                # if another backend exists and the retry budget allows
                # the extra attempt (a hedge IS retry amplification)
                hedge_decided = True
                hedge = self._pick(tried | {primary.name}, pin=pin)
                if hedge is None:
                    continue
                if not self._retry_budget.spend():
                    self._unpick(hedge)
                    continue
                self._m_hedge_fired.add(1)
                if span is not None:
                    span.set_attribute("hedged", True)
                threading.Thread(
                    target=run, args=(hedge, True),
                    name="sparkdl-router-hedge", daemon=True,
                ).start()
                in_flight += 1
                continue
            in_flight -= 1
            backend, is_hedge, reply, exc = item
            if exc is None:
                if is_hedge:
                    self._m_hedge_wins.add(1)
                    if span is not None:
                        span.set_attribute("hedge_won", True)
                return reply, backend, t_start
            tried.add(backend.name)
            last_exc = exc
            if self._classify(exc) == "raise":
                raise exc
        assert last_exc is not None
        raise last_exc

    def route(
        self,
        value: Any,
        model_id: Optional[str] = None,
        deadline_ms: Optional[float] = None,
        timeout_s: Optional[float] = None,
        tenant: Optional[str] = None,
    ):
        """Place one request; returns the model output row or raises a
        typed error.  Retries connection failures and transient replies
        on other live replicas until the replica set is exhausted."""
        return self.route_reply(
            value, model_id=model_id, deadline_ms=deadline_ms,
            timeout_s=timeout_s, tenant=tenant,
        )["result"]

    def route_reply(
        self,
        value: Any,
        model_id: Optional[str] = None,
        deadline_ms: Optional[float] = None,
        timeout_s: Optional[float] = None,
        tenant: Optional[str] = None,
    ) -> Dict[str, Any]:
        """:meth:`route`, but returning the full reply envelope — with a
        per-phase latency breakdown in ``reply["phases"]`` (admission /
        router_queue / wire / transport / replica_queue / forward /
        fetch, observed as ``router.phase.<name>``) and, when tracing
        is on, the replica's piggybacked spans ingested into this
        process's sinks so the trace sink holds one stitched
        end-to-end trace per request."""
        base_id, pin = split_versioned(model_id)
        tm = self._tenant_instruments(tenant)
        span = (
            tracer.start_span(
                "router.request", model_id=model_id, tenant=tenant,
            )
            if tracer.enabled else None
        )
        try:
            hit_reply, cache_key, cache_version, cache_ms = (
                self._cache_lookup(base_id, pin, value, tm, span)
            )
            if hit_reply is not None:
                return hit_reply
            # a cacheable miss pins placement to the version the key
            # was rolled for, so the populate below can never store a
            # v1 result under a v2 key (or vice versa)
            effective_pin = pin if cache_version is None else cache_version
            t_in = self._clock()
            self._admit(tm)
            start = self._clock()
            admission_ms = (start - t_in) * 1000.0
            budget = (
                timeout_s if timeout_s is not None
                else self._request_timeout_s
            )
            # the END-TO-END deadline: the caller's deadline_ms and the
            # router's own timeout budget, whichever is tighter.  Every
            # attempt below gets the *remaining* time — propagated to
            # the replica so its batcher can shed work that can no
            # longer make it, instead of restarting the clock per hop.
            deadline = start + budget
            if deadline_ms is not None:
                deadline = min(deadline, start + float(deadline_ms) / 1000.0)
            self._retry_budget.earn()
            try:
                inject.fire("router.route")
                self._m_requests.add(1)
                if tm is not None:
                    tm.requests.add(1)
                tried: set = set()
                last_exc: Optional[BaseException] = None
                retries = 0
                while True:
                    if self._clock() >= deadline:
                        self._m_expired.add(1)
                        self._m_errors.add(1)
                        if tm is not None:
                            tm.errors.add(1)
                        raise DeadlineExceeded(
                            f"deadline expired in router after {retries} "
                            f"retr{'y' if retries == 1 else 'ies'}"
                        ) from last_exc
                    if retries > 0 and not self._retry_budget.spend():
                        # budget exhausted: degrade into the last typed
                        # error instead of amplifying the brownout
                        self._m_errors.add(1)
                        if tm is not None:
                            tm.errors.add(1)
                        assert last_exc is not None
                        raise last_exc
                    backend = self._pick(tried, pin=effective_pin)
                    if (backend is None and cache_version is not None
                            and pin is None):
                        # the cache-rolled version lost its replicas
                        # mid-request: availability beats key affinity —
                        # unpin, stop populating, and re-place
                        effective_pin = None
                        cache_key = None
                        cache_version = None
                        continue
                    if backend is None:
                        self._m_errors.add(1)
                        if tm is not None:
                            tm.errors.add(1)
                        if last_exc is not None:
                            raise last_exc
                        raise NoLiveReplicas(
                            "no live replica to place the request on "
                            f"(version {pin or 'any'}; "
                            f"tried {sorted(tried) or 'none'})"
                        )
                    try:
                        reply, winner, attempt_start = self._attempt_or_hedge(
                            backend, tried, effective_pin, value, base_id,
                            deadline_ms is not None, tenant, deadline, span,
                        )
                    except Exception as exc:
                        from sparkdl_tpu_torch.resilience.errors import is_transient

                        if isinstance(
                            exc, (ConnectionError, OSError, socket.timeout)
                        ) or is_transient(exc):
                            # stranded or transiently-refused: re-place
                            # on a backend we haven't burned yet
                            last_exc = exc
                            retries += 1
                            self._m_retries.add(1)
                            if span is not None:
                                span.set_attribute("retries", retries)
                            continue
                        self._m_errors.add(1)
                        if tm is not None:
                            tm.errors.add(1)
                        raise
                    now = self._clock()
                    e2e_ms = (now - start) * 1000.0
                    # exemplar: the root span's trace id rides along
                    # with every latency sample, so a p99 outlier in
                    # /metrics.json names the stitched trace behind it
                    exemplar = span.trace_id if span is not None else None
                    self._m_latency.observe(e2e_ms, exemplar=exemplar)
                    if tm is not None:
                        tm.latency.observe(e2e_ms, exemplar=exemplar)
                    shipped = reply.pop("spans", None)
                    if span is not None:
                        span.set_attribute("replica", winner.name)
                        span.set_attribute("version", winner.version)
                        for remote_span in shipped or ():
                            tracer.ingest(remote_span)
                    if reply.get("cache") == "collapsed":
                        # the replica's single-flight folded this
                        # request into another's forward
                        self._m_cache_collapsed.add(1)
                        if span is not None:
                            span.set_attribute("cache", "collapsed")
                    if (cache_key is not None
                            and winner.version == cache_version):
                        try:
                            # hedge-safe: only the race winner reaches
                            # here, and put() is idempotent besides
                            self._result_cache.put(
                                cache_key, reply["result"]
                            )
                        except Exception:
                            pass  # populate is best-effort, fail-open
                    self._decompose(
                        reply,
                        admission_ms=admission_ms,
                        queue_ms=(attempt_start - start) * 1000.0,
                        attempt_ms=(now - attempt_start) * 1000.0,
                        cache_ms=cache_ms,
                        exemplar=exemplar,
                    )
                    if span is not None:
                        # the merged breakdown rides the root span too:
                        # trace-JSONL consumers (obs.diag) attribute
                        # phases without needing the reply envelope
                        span.set_attribute(
                            "phases", dict(reply.get("phases") or {})
                        )
                        span.set_attribute("e2e_ms", e2e_ms)
                    return reply
            finally:
                self._release()
        except BaseException as exc:
            # a replica dying mid-request (SIGKILL, wedge) with no
            # survivor still leaves a *terminated* root span carrying
            # the error class — never a dangling parent
            if span is not None:
                span.set_attribute("error", type(exc).__name__)
            raise
        finally:
            if span is not None:
                span.end()

    def route_stream(
        self,
        value: Any,
        model_id: Optional[str] = None,
        on_frame=None,
        max_steps: Optional[int] = None,
        deadline_ms: Optional[float] = None,
        timeout_s: Optional[float] = None,
        tenant: Optional[str] = None,
    ) -> Dict[str, Any]:
        """Place one autoregressive decode and stream its token frames.

        ``on_frame(frame)`` fires for every incremental ``KIND_STREAM``
        frame as it arrives off the wire; the return value is the final
        envelope with ``result`` (the full token array, byte-identical
        to a one-shot replay of the stream), ``steps``, ``server_ms``
        and the phase breakdown.

        Placement differs from :meth:`route_reply` in two deliberate
        ways.  **No hedging**: a stream is pinned to the backend that
        admitted it — racing a second decode would duplicate token
        emission and double-charge a device slot for work the loser
        throws away.  **Retry only before first token**: once a frame
        has been forwarded to the caller the stream cannot be spliced
        onto another replica mid-flight, so a connection failure after
        that surfaces as the typed error it is.  The result cache is
        bypassed entirely (decode output depends on ``max_steps`` and
        per-step state, not just the prompt)."""
        base_id, pin = split_versioned(model_id)
        tm = self._tenant_instruments(tenant)
        span = (
            tracer.start_span(
                "router.stream", model_id=model_id, tenant=tenant,
            )
            if tracer.enabled else None
        )
        try:
            t_in = self._clock()
            self._admit(tm)
            start = self._clock()
            admission_ms = (start - t_in) * 1000.0
            budget = (
                timeout_s if timeout_s is not None
                else self._request_timeout_s
            )
            deadline = start + budget
            if deadline_ms is not None:
                deadline = min(deadline, start + float(deadline_ms) / 1000.0)
            self._retry_budget.earn()
            try:
                inject.fire("router.route")
                self._m_requests.add(1)
                if tm is not None:
                    tm.requests.add(1)
                tokens: list = []

                def fwd(frame: Dict[str, Any]) -> None:
                    tokens.append(np.asarray(frame.get("result")))
                    if on_frame is not None:
                        on_frame(frame)

                tried: set = set()
                last_exc: Optional[BaseException] = None
                retries = 0
                while True:
                    if self._clock() >= deadline:
                        self._m_expired.add(1)
                        self._m_errors.add(1)
                        if tm is not None:
                            tm.errors.add(1)
                        raise DeadlineExceeded(
                            f"deadline expired in router after {retries} "
                            f"stream retr{'y' if retries == 1 else 'ies'}"
                        ) from last_exc
                    if retries > 0 and not self._retry_budget.spend():
                        self._m_errors.add(1)
                        if tm is not None:
                            tm.errors.add(1)
                        assert last_exc is not None
                        raise last_exc
                    backend = self._pick(tried, pin=pin)
                    if backend is None:
                        self._m_errors.add(1)
                        if tm is not None:
                            tm.errors.add(1)
                        if last_exc is not None:
                            raise last_exc
                        raise NoLiveReplicas(
                            "no live replica to place the stream on "
                            f"(version {pin or 'any'}; "
                            f"tried {sorted(tried) or 'none'})"
                        )
                    vm = self._version_instruments(backend.version)
                    vm.requests.add(1)
                    self._m_attempts.add(1)
                    attempt_start = self._clock()
                    msg: Dict[str, Any] = {
                        "op": "decode",
                        "model_id": base_id,
                        "value": value,
                        "max_steps": max_steps,
                        "deadline_ms": (
                            max(1.0, (deadline - attempt_start) * 1000.0)
                            if deadline_ms is not None else None
                        ),
                        "tenant": tenant,
                    }
                    if span is not None:
                        msg["trace"] = span.context()
                    try:
                        try:
                            final = backend.transport.stream(
                                msg, fwd, max(0.05, deadline - attempt_start),
                            )
                        except Exception:
                            vm.errors.add(1)
                            raise
                        finally:
                            self._unpick(backend)
                    except Exception as exc:
                        tried.add(backend.name)
                        if not tokens and self._classify(exc) == "retry":
                            # nothing forwarded yet: the stream never
                            # really started, so re-place it whole
                            last_exc = exc
                            retries += 1
                            self._m_retries.add(1)
                            if span is not None:
                                span.set_attribute("retries", retries)
                            continue
                        self._m_errors.add(1)
                        if tm is not None:
                            tm.errors.add(1)
                        raise
                    break
                now = self._clock()
                # per-version latency charges the whole stream; the
                # hedge sample window does NOT see it — decode walls
                # are token-count-shaped and would inflate the one-shot
                # hedge trigger
                attempt_ms = (now - attempt_start) * 1000.0
                exemplar = span.trace_id if span is not None else None
                vm.latency.observe(attempt_ms, exemplar=exemplar)
                e2e_ms = (now - start) * 1000.0
                self._m_latency.observe(e2e_ms, exemplar=exemplar)
                if tm is not None:
                    tm.latency.observe(e2e_ms, exemplar=exemplar)
                reply = dict(final)
                shipped = reply.pop("spans", None)
                if span is not None:
                    span.set_attribute("replica", backend.name)
                    span.set_attribute("version", backend.version)
                    span.set_attribute("steps", len(tokens))
                    for remote_span in shipped or ():
                        tracer.ingest(remote_span)
                reply["result"] = (
                    np.stack(tokens) if tokens
                    else np.empty((0,), dtype=np.float32)
                )
                reply["steps"] = len(tokens)
                self._decompose(
                    reply,
                    admission_ms=admission_ms,
                    queue_ms=(attempt_start - start) * 1000.0,
                    attempt_ms=attempt_ms,
                    exemplar=exemplar,
                )
                if span is not None:
                    span.set_attribute(
                        "phases", dict(reply.get("phases") or {})
                    )
                    span.set_attribute("e2e_ms", e2e_ms)
                return reply
            finally:
                self._release()
        except BaseException as exc:
            if span is not None:
                span.set_attribute("error", type(exc).__name__)
            raise
        finally:
            if span is not None:
                span.end()

    def _decompose(self, reply: Dict[str, Any], admission_ms: float,
                   queue_ms: float, attempt_ms: float,
                   cache_ms: Optional[float] = None,
                   exemplar: Optional[int] = None) -> None:
        """Merge the router-side phases into the reply's breakdown and
        observe each as ``router.phase.<name>``.  The transport phase
        is the winning attempt's wall time minus what finer phases
        already account for (client-side wire work stamped by the
        transport, replica-side ``server_ms``), clamped at zero.
        ``cache_ms`` is the miss-path lookup cost — tiny, but part of
        the e2e latency the decomposition promises to explain."""
        phases = reply.get("phases")
        if not isinstance(phases, dict):
            phases = reply["phases"] = {}
        phases["admission"] = admission_ms
        phases["router_queue"] = queue_ms
        if cache_ms is not None:
            phases["cache"] = cache_ms
        try:
            accounted = (
                float(phases.get("wire") or 0.0)
                + float(reply.get("server_ms") or 0.0)
            )
        except (TypeError, ValueError):
            accounted = 0.0
        phases["transport"] = max(0.0, attempt_ms - accounted)
        for name, ms in phases.items():
            if not isinstance(ms, (int, float)):
                continue
            self._observe_phase(str(name), float(ms), exemplar)

    def _send_one(self, backend: _Backend, value, model_id, deadline_ms,
                  tenant: Optional[str], timeout_s: float,
                  trace=None) -> Dict[str, Any]:
        msg: Dict[str, Any] = {
            "op": "infer",
            "model_id": model_id,
            "value": value,
            "deadline_ms": deadline_ms,
            "tenant": tenant,
        }
        if trace is not None:
            msg["trace"] = trace
        reply = backend.transport.request(msg, timeout_s)
        if not isinstance(reply, dict):
            raise ConnectionError(
                f"malformed reply from replica {backend.name!r}"
            )
        if reply.get("ok"):
            return reply
        raise wire.decode_error(reply)

    def _front_stream(self, sock, msg: Dict[str, Any]) -> bool:
        """One front-door decode: stream the replica's token frames to
        the client as they arrive, then a final envelope (or a typed
        error frame with ``final: True``).  Returns False when the
        CLIENT connection died — the handler loop must stop; replica-
        side failures come back as typed error frames instead."""
        seq = msg.get("seq")

        def send(frame: Dict[str, Any]) -> None:
            out = dict(frame)
            if seq is not None:
                out["seq"] = seq
            wire.send_stream(sock, out)

        sent = 0
        try:
            t_route = self._clock()

            def fwd(frame: Dict[str, Any]) -> None:
                nonlocal sent
                send(frame)
                sent += 1

            inner = self.route_stream(
                msg["value"],
                model_id=msg.get("model_id"),
                on_frame=fwd,
                max_steps=msg.get("max_steps"),
                deadline_ms=msg.get("deadline_ms"),
                tenant=msg.get("tenant"),
            )
            route_ms = (self._clock() - t_route) * 1000.0
            final: Dict[str, Any] = {
                "ok": True,
                "final": True,
                "stream_seq": sent,
                "server_ms": inner.get("server_ms"),
            }
            phases = inner.get("phases")
            if isinstance(phases, dict):
                phases = dict(phases)
                accounted = sum(
                    v for v in phases.values()
                    if isinstance(v, (int, float))
                )
                phases["frontdoor"] = max(0.0, route_ms - accounted)
                phases["t_route"] = t_route
                phases["t_send"] = self._clock()
                final["phases"] = phases
            send(final)
        except (ConnectionError, OSError) as exc:
            from sparkdl_tpu_torch.resilience.errors import is_transient

            if not is_transient(exc):
                # a raw (untyped) connection error here is the CLIENT
                # socket dying under send(); typed transients fall
                # through to the error frame below
                return False
            err = wire.encode_error(exc)
            err["final"] = True
            err["stream_seq"] = sent
            try:
                send(err)
            except (ConnectionError, OSError):
                return False
        except Exception as exc:
            err = wire.encode_error(exc)
            err["final"] = True
            err["stream_seq"] = sent
            try:
                send(err)
            except (ConnectionError, OSError):
                return False
        return True

    # ------------------------------------------------------------------
    # front door (what the load generators connect to)
    # ------------------------------------------------------------------
    def serve(self, host: str = "127.0.0.1", port: int = 0) -> int:
        """Open the wire-protocol front door; returns the bound port.
        Each generator connection gets a handler thread that loops
        ``infer`` frames through :meth:`route`."""
        outer = self

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):
                self.request.setsockopt(
                    socket.IPPROTO_TCP, socket.TCP_NODELAY, 1
                )
                while True:
                    try:
                        msg = wire.recv_msg(self.request)
                    except (ConnectionError, OSError):
                        return
                    if msg is None:
                        return
                    if msg.get("op") == "ping":
                        reply: Dict[str, Any] = {
                            "ok": True, "replicas": outer.names(),
                        }
                    elif msg.get("op") == "decode":
                        # streaming front door: forward each replica
                        # token frame to the client the moment it
                        # lands, restamped with the CLIENT's seq (the
                        # replica-leg seq belongs to that hop alone)
                        if not outer._front_stream(self.request, msg):
                            return
                        continue
                    else:
                        try:
                            t_route = outer._clock()
                            inner = outer.route_reply(
                                msg["value"],
                                model_id=msg.get("model_id"),
                                deadline_ms=msg.get("deadline_ms"),
                                tenant=msg.get("tenant"),
                            )
                            route_ms = (
                                outer._clock() - t_route
                            ) * 1000.0
                            reply = {
                                "ok": True,
                                "result": inner["result"],
                                "server_ms": inner.get("server_ms"),
                            }
                            if inner.get("cache"):
                                # hit / collapsed marker, so clients
                                # (and the bench report) can split
                                # hit-path from miss-path latency
                                reply["cache"] = inner["cache"]
                            phases = inner.get("phases")
                            if isinstance(phases, dict):
                                phases = dict(phases)
                                accounted = sum(
                                    v for v in phases.values()
                                    if isinstance(v, (int, float))
                                )
                                # routing time no finer phase accounts
                                # for (retry gaps, GIL waits)
                                phases["frontdoor"] = max(
                                    0.0, route_ms - accounted
                                )
                                # absolute CLOCK_MONOTONIC stamps (s,
                                # not ms — the "t_" prefix marks them):
                                # monotonic is system-wide on Linux, so
                                # a SAME-HOST client can decompose its
                                # own ingress (t0 -> t_route) and
                                # egress (t_send -> reply-read) hops —
                                # the scheduler/codec time no server-
                                # side phase can see.  Phase consumers
                                # skip "t_"-prefixed keys.
                                phases["t_route"] = t_route
                                phases["t_send"] = outer._clock()
                                reply["phases"] = phases
                        except Exception as exc:
                            reply = wire.encode_error(exc)
                    try:
                        wire.send_msg(self.request, reply)
                    except (ConnectionError, OSError):
                        return

        class Server(socketserver.ThreadingTCPServer):
            daemon_threads = True
            allow_reuse_address = True

        with self._lock:
            if self._closed:
                raise RuntimeError("router is closed")
            if getattr(self, "_front", None) is not None:
                return self._front.server_address[1]
            self._front = Server((host, int(port)), Handler)
            self._front_thread = threading.Thread(
                target=self._front.serve_forever,
                kwargs={"poll_interval": 0.1},
                name="sparkdl-router-front",
                daemon=True,
            )
            self._front_thread.start()
            return self._front.server_address[1]

    def close(self) -> None:
        with self._lock:
            self._closed = True
            backends = list(self._backends.values())
            self._backends.clear()
            front = getattr(self, "_front", None)
            front_thread = getattr(self, "_front_thread", None)
            self._front = None
            self._front_thread = None
        for backend in backends:
            backend.close()
        if front is not None:
            front.shutdown()
            front.server_close()
        if front_thread is not None and front_thread.is_alive():
            front_thread.join(timeout=5.0)

    def __enter__(self) -> "Router":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __repr__(self):
        return (
            f"Router(replicas={sorted(self.names())}, "
            f"weights={self.weights()}, "
            f"max_inflight={self.max_inflight})"
        )
