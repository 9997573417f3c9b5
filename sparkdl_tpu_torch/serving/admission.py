"""Admission control: a bounded request queue with load shedding, deadline
bookkeeping and per-tenant weighted-fair scheduling.

Port of ``sparkdl_tpu.serving.admission`` (host code, unchanged but for its
imports). Requests are admitted into a *bounded* queue:
a full queue sheds at submit with the typed
:class:`~sparkdl_tpu_torch.serving.errors.ServerOverloaded`, never an
unbounded backlog. The batcher's worker takes them with a
first-item-then-linger policy (``max_batch`` / ``max_wait``).

With a :class:`TenantPolicy`, each tenant has its own FIFO and ``take``
drains them by deficit round robin: each pass credits each backlogged
tenant its ``weight``, so a tenant bursting 10x its share is served its
weighted fraction while others have work queued. A per-tenant cap on
admitted-but-unresolved requests sheds with
:class:`~sparkdl_tpu_torch.serving.errors.TenantThrottled`. Both sheds
happen at ``offer`` only: an admitted request always resolves through its
future.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Mapping, Optional

from sparkdl_tpu_torch.serving.errors import (
    ServerClosed,
    ServerOverloaded,
    TenantThrottled,
)
from sparkdl_tpu_torch.utils.metrics import metrics

ENV_TENANT_WEIGHTS = "SPARKDL_TENANT_WEIGHTS"
ENV_TENANT_INFLIGHT = "SPARKDL_TENANT_INFLIGHT"
ENV_TENANT_DEFAULT_WEIGHT = "SPARKDL_TENANT_DEFAULT_WEIGHT"

#: bucket for requests that carry no tenant id
DEFAULT_TENANT = "default"


@dataclass
class Request:
    """One in-flight single-item request."""

    value: Any
    future: Future = field(default_factory=Future)
    enqueued_at: float = field(default_factory=time.monotonic)
    #: absolute ``time.monotonic()`` expiry, or None for no deadline
    deadline: Optional[float] = None
    #: fair-share bucket; None lands in :data:`DEFAULT_TENANT`
    tenant: Optional[str] = None
    #: the request's trace span (None when tracing is off): captured at
    #: submit, carried EXPLICITLY across the queue so the batch worker can
    #: record which member spans it coalesced
    span: Optional[Any] = None

    def expired(self, now: Optional[float] = None) -> bool:
        if self.deadline is None:
            return False
        if now is None:
            now = time.monotonic()
        return now > self.deadline


@dataclass(frozen=True)
class TenantPolicy:
    """Fair-share knobs: service ``weights`` per tenant (unlisted
    tenants get ``default_weight``) and an optional per-tenant cap on
    admitted-but-unresolved requests.  ``inflight_cap`` is the isolation
    valve — set it below the queue ``capacity`` or one tenant's burst
    can still fill the whole queue before DRR gets a say."""

    weights: Mapping[str, float] = field(default_factory=dict)
    inflight_cap: Optional[int] = None
    default_weight: float = 1.0

    def __post_init__(self):
        for tenant, w in self.weights.items():
            if w <= 0:
                raise ValueError(
                    f"tenant {tenant!r} weight must be > 0, got {w}"
                )
        if self.default_weight <= 0:
            raise ValueError(
                f"default_weight must be > 0, got {self.default_weight}"
            )
        if self.inflight_cap is not None and self.inflight_cap < 1:
            raise ValueError(
                f"inflight_cap must be >= 1, got {self.inflight_cap}"
            )

    def weight(self, tenant: str) -> float:
        return float(self.weights.get(tenant, self.default_weight))

    @classmethod
    def from_env(cls) -> Optional["TenantPolicy"]:
        """Build from ``SPARKDL_TENANT_WEIGHTS`` (``"a:3,b:1"``) /
        ``SPARKDL_TENANT_INFLIGHT`` / ``SPARKDL_TENANT_DEFAULT_WEIGHT``;
        None when neither weights nor cap are set (single-queue mode)."""
        raw = os.environ.get(ENV_TENANT_WEIGHTS, "").strip()
        cap_raw = os.environ.get(ENV_TENANT_INFLIGHT, "").strip()
        if not raw and not cap_raw:
            return None
        weights: Dict[str, float] = {}
        for part in raw.split(","):
            part = part.strip()
            if not part:
                continue
            tenant, _, w = part.partition(":")
            weights[tenant.strip()] = float(w) if w else 1.0
        return cls(
            weights=weights,
            inflight_cap=int(cap_raw) if cap_raw else None,
            default_weight=float(
                os.environ.get(ENV_TENANT_DEFAULT_WEIGHT, "1.0")
            ),
        )


class _TenantLane:
    """One tenant's FIFO plus its DRR and accounting state."""

    __slots__ = ("items", "deficit", "inflight", "m_admitted",
                 "m_throttled", "m_depth")

    def __init__(self, tenant_label: str, instrumented: bool):
        self.items: "deque[Request]" = deque()
        self.deficit = 0.0
        #: admitted requests whose futures have not resolved yet
        self.inflight = 0
        # tenant.* instruments only exist in tenanted mode — the
        # single-queue path must not pay (or emit) per-tenant series
        if instrumented:
            self.m_admitted = metrics.counter(
                f"tenant.{tenant_label}.admitted"
            )
            self.m_throttled = metrics.counter(
                f"tenant.{tenant_label}.throttled"
            )
            self.m_depth = metrics.gauge(
                f"tenant.{tenant_label}.queue_depth"
            )
        else:
            self.m_admitted = self.m_throttled = self.m_depth = None


def _sanitize_tenant(tenant: str) -> str:
    # local, import-cycle-free twin of obs.slo.sanitize_name: metric
    # segments stay [a-z0-9_]
    return "".join(
        ch if (ch.isalnum() or ch == "_") else "_"
        for ch in tenant.lower()
    ) or DEFAULT_TENANT


class AdmissionQueue:
    """Bounded FIFO of :class:`Request` with coalescing take.

    ``offer`` never blocks: a full queue sheds the request immediately
    (backpressure surfaces at the caller as :class:`ServerOverloaded`
    instead of as silent latency).  ``take`` blocks briefly for the first
    request, then lingers up to ``max_wait_s`` gathering more — the
    dynamic micro-batching window.

    With a :class:`TenantPolicy` (explicit or from ``SPARKDL_TENANT_*``
    env), requests fan into per-tenant FIFOs and ``take`` interleaves
    them by deficit round robin; without one, every request shares the
    :data:`DEFAULT_TENANT` lane and behavior is plain FIFO.
    """

    def __init__(self, capacity: int, depth_gauge=None, shed_counter=None,
                 tenant_policy: Optional[TenantPolicy] = None,
                 clock=time.monotonic):
        if capacity < 1:
            raise ValueError(f"queue capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self.tenant_policy = tenant_policy
        #: injectable time source — the sim drives the queue in virtual
        #: time; wall-clock threads keep the monotonic default
        self._clock = clock
        self._lock = threading.Lock()
        self._not_empty = threading.Condition(self._lock)
        self._not_full = threading.Condition(self._lock)
        self._closed = False
        self._depth_gauge = depth_gauge
        self._shed_counter = shed_counter
        self._size = 0
        self._lanes: Dict[str, _TenantLane] = {}
        #: DRR active list — tenants with a non-empty FIFO, in visit order
        self._ring: "deque[str]" = deque()

    def __len__(self) -> int:
        with self._lock:
            return self._size

    # ------------------------------------------------------------------
    # internals (all assume self._lock held)
    # ------------------------------------------------------------------
    def _set_depth_locked(self) -> None:
        if self._depth_gauge is not None:
            self._depth_gauge.set(self._size)

    def _lane_for(self, tenant: str) -> _TenantLane:
        lane = self._lanes.get(tenant)
        if lane is None:
            lane = _TenantLane(
                _sanitize_tenant(tenant),
                instrumented=self.tenant_policy is not None,
            )
            self._lanes[tenant] = lane
        return lane

    def _admit_locked(self, request: Request) -> _TenantLane:
        """Capacity/cap checks + enqueue; raises the typed shed errors.
        The order matters: the tenant cap is checked before the global
        capacity so a throttled tenant is told *why* (its own footprint),
        not fobbed off with a generic overload."""
        if self._closed:
            raise ServerClosed("endpoint is closed")
        tenant = request.tenant or DEFAULT_TENANT
        lane = self._lane_for(tenant)
        policy = self.tenant_policy
        cap = policy.inflight_cap if policy is not None else None
        if cap is not None and lane.inflight >= cap:
            if lane.m_throttled is not None:
                lane.m_throttled.add(1)
            if self._shed_counter is not None:
                self._shed_counter.add(1)
            raise TenantThrottled(
                f"tenant {tenant!r} at its inflight cap ({cap} admitted "
                "and unresolved); fair-share throttling"
            )
        if self._size >= self.capacity:
            if self._shed_counter is not None:
                self._shed_counter.add(1)
            raise ServerOverloaded(
                f"request queue full ({self.capacity} pending); "
                "load-shedding"
            )
        if not lane.items:
            self._ring.append(tenant)
        lane.items.append(request)
        lane.inflight += 1
        self._size += 1
        if lane.m_admitted is not None:
            lane.m_admitted.add(1)
        if lane.m_depth is not None:
            lane.m_depth.set(len(lane.items))
        self._set_depth_locked()
        self._not_empty.notify()
        return lane

    def _on_resolved(self, tenant: str):
        """Future done-callback: the admitted request resolved (result,
        model error, or close-time failure) — release its inflight slot
        and wake anyone blocked on the tenant cap."""

        def done(_future):
            with self._not_full:
                lane = self._lanes.get(tenant)
                if lane is not None and lane.inflight > 0:
                    lane.inflight -= 1
                self._not_full.notify_all()

        return done

    def _blocked_locked(self, request: Request) -> bool:
        """True while ``offer_wait`` must keep waiting: global capacity
        reached, or the request's tenant is at its inflight cap."""
        if self._size >= self.capacity:
            return True
        policy = self.tenant_policy
        if policy is None or policy.inflight_cap is None:
            return False
        lane = self._lanes.get(request.tenant or DEFAULT_TENANT)
        return lane is not None and lane.inflight >= policy.inflight_cap

    def _pop_drr_locked(self) -> Optional[Request]:
        """One request in deficit-round-robin order: each ring visit
        credits the tenant its weight; a tenant out of credit rotates to
        the back.  A single-tenant ring degenerates to plain FIFO."""
        policy = self.tenant_policy
        while self._ring:
            tenant = self._ring[0]
            lane = self._lanes[tenant]
            if not lane.items:  # drained by close(); drop from ring
                self._ring.popleft()
                lane.deficit = 0.0
                continue
            if lane.deficit < 1.0:
                # out of credit: this visit banks one quantum (the
                # tenant's weight); still short means an under-weighted
                # tenant keeps banking while the ring moves on
                lane.deficit += (
                    policy.weight(tenant) if policy is not None else 1.0
                )
                if lane.deficit < 1.0:
                    self._ring.rotate(-1)
                    continue
            lane.deficit -= 1.0
            req = lane.items.popleft()
            self._size -= 1
            if lane.m_depth is not None:
                lane.m_depth.set(len(lane.items))
            if not lane.items:
                self._ring.popleft()
                lane.deficit = 0.0  # classic DRR: idle tenants bank nothing
            elif lane.deficit < 1.0:
                # credit spent — the next pop visits the next tenant
                self._ring.rotate(-1)
            return req
        return None

    # ------------------------------------------------------------------
    # producer side
    # ------------------------------------------------------------------
    def offer(self, request: Request) -> None:
        """Admit ``request`` or raise (:class:`ServerOverloaded` /
        :class:`TenantThrottled` / :class:`ServerClosed`)."""
        with self._not_empty:
            self._admit_locked(request)
        # outside the lock: a done-callback can run synchronously when
        # the future already resolved, and it re-takes self._lock
        request.future.add_done_callback(
            self._on_resolved(request.tenant or DEFAULT_TENANT)
        )

    def offer_wait(
        self,
        request: Request,
        timeout_s: Optional[float] = None,
    ) -> bool:
        """Admit ``request``, *blocking* while the queue is full (or the
        tenant is at its cap) — the backpressure mode a streaming poller
        wants: a full queue stalls the producer (which stops pulling from
        its source) instead of shedding the row.  Returns False if still
        blocked after ``timeout_s`` (None = wait indefinitely); raises
        :class:`ServerClosed` once the queue closes."""
        deadline = (
            self._clock() + timeout_s if timeout_s is not None else None
        )
        with self._not_full:
            while True:
                if self._closed:
                    raise ServerClosed("endpoint is closed")
                if not self._blocked_locked(request):
                    self._admit_locked(request)
                    break
                if deadline is None:
                    self._not_full.wait()
                else:
                    remaining = deadline - self._clock()
                    if remaining <= 0 or not self._not_full.wait(remaining):
                        if self._blocked_locked(request):
                            return False
        request.future.add_done_callback(
            self._on_resolved(request.tenant or DEFAULT_TENANT)
        )
        return True

    # ------------------------------------------------------------------
    # consumer side
    # ------------------------------------------------------------------
    def take(
        self,
        max_n: int,
        max_wait_s: float,
        poll_s: float = 0.05,
        flush_early: Optional[Callable[[], bool]] = None,
    ) -> List[Request]:
        """Coalesce up to ``max_n`` requests.

        Blocks at most ``poll_s`` for the first request (so a closing
        worker notices promptly); once one arrives, lingers up to
        ``max_wait_s`` — measured from the first request — for more.
        Returns ``[]`` on an idle poll or when closed.

        ``flush_early`` (checked whenever the queue runs dry mid-linger)
        cuts the linger short while it returns True — the consumer's
        "the device could run this batch NOW" signal.  Lingering exists
        to trade latency for occupancy; when the downstream dispatch
        window has a free slot that trade is pure added latency, so the
        batch in hand flushes immediately and the next one coalesces
        naturally while this one computes.
        """
        with self._not_empty:
            if not self._size and not self._closed:
                self._not_empty.wait(poll_s)
            if not self._size:
                return []
            batch = [self._pop_drr_locked()]
            linger_until = self._clock() + max_wait_s
            while len(batch) < max_n and not self._closed:
                if self._size:
                    batch.append(self._pop_drr_locked())
                    continue
                if flush_early is not None and flush_early():
                    metrics.counter("batcher.flush_early").add(1)
                    break
                remaining = linger_until - self._clock()
                if remaining <= 0:
                    break
                self._not_empty.wait(remaining)
            self._set_depth_locked()
            self._not_full.notify_all()
            return batch

    # ------------------------------------------------------------------
    # lifecycle / introspection
    # ------------------------------------------------------------------
    def close(self) -> List[Request]:
        """Stop admitting; return (and remove) everything still queued so
        the caller can fail those futures."""
        with self._not_empty:
            self._closed = True
            drained: List[Request] = []
            while self._ring:
                tenant = self._ring.popleft()
                lane = self._lanes[tenant]
                drained.extend(lane.items)
                lane.items.clear()
                lane.deficit = 0.0
                if lane.m_depth is not None:
                    lane.m_depth.set(0)
            self._size = 0
            self._set_depth_locked()
            self._not_empty.notify_all()
            self._not_full.notify_all()
        return drained

    def tenants(self) -> Dict[str, Dict[str, float]]:
        """Per-tenant accounting snapshot (introspection/status)."""
        policy = self.tenant_policy
        with self._lock:
            return {
                tenant: {
                    "queued": len(lane.items),
                    "inflight": lane.inflight,
                    "weight": (
                        policy.weight(tenant) if policy is not None else 1.0
                    ),
                }
                for tenant, lane in self._lanes.items()
            }

    @property
    def closed(self) -> bool:
        with self._lock:
            return self._closed
