"""Content-addressed inference result cache.

Port of ``sparkdl_tpu.serving.result_cache`` (host code: a copy with the
package renamed; its keys equal the JAX package's for the same values).
Two tiers, one key contract:

**Router tier** — :class:`ResultCache`, a bounded-byte LRU keyed on
``sha256(endpoint-version fingerprint || canonical input digest)``.
The fingerprint is the engine's durable program fingerprint each replica
advertises at ready time, so a rollout flip (``set_primary`` / weight
shift) changes the key and is therefore an automatic, *correct*
invalidation — no epoch counters, no TTL guesswork.  A hit returns
before admission, placement, or any wire frame: it costs a hash, not a
forward.  Unfingerprinted endpoints never cache — the same rule the
engine's compile cache enforces (an unfingerprinted program never
persists).

**Replica tier** — :class:`SingleFlight` collapses N concurrent
identical requests into one forward and fans the result out (the
``serving/cache.py`` claim-loop shape at request granularity; a
result-carrying flight instead of a bare claim because followers need
the *value*, not just the wake-up), and :class:`NegativeCache`
remembers typed-permanent-error replies so a poison input cannot
stampede the device.

Everything here is transport- and framework-free: numpy + stdlib,
importable without torch.
"""

from __future__ import annotations

import hashlib
import pickle
import threading
from collections import OrderedDict
from typing import Any, Dict, Optional, Tuple

import numpy as np

from ..utils.metrics import MetricsRegistry, metrics

#: "1" turns the cache on in BOTH tiers: the router builds a
#: :class:`ResultCache` and replicas arm :class:`SingleFlight` +
#: :class:`NegativeCache`.  Opt-in by design — always-on would turn
#: every constant-input smoke baseline into a hit-rate test.
ENV_RESULT_CACHE = "SPARKDL_RESULT_CACHE"
ENV_RESULT_CACHE_BYTES = "SPARKDL_RESULT_CACHE_BYTES"

#: hash-domain tags — an ndarray and a pickle that happen to serialize
#: to the same bytes must not collide
_TAG_ARRAY = b"\x01nd\x00"
_TAG_PYOBJ = b"\x02py\x00"
_TAG_META = b"\x03meta\x00"


def _hash_value(h, value) -> None:
    if isinstance(value, np.ndarray):
        # C-contiguous normalization: two equal arrays digest
        # identically regardless of memory layout (F-order, negative
        # strides, broadcast views), while dtype or shape differences
        # always change the digest even when the raw bytes match
        arr = np.ascontiguousarray(value)
        h.update(_TAG_ARRAY)
        h.update(arr.dtype.str.encode("ascii"))
        h.update(repr(arr.shape).encode("ascii"))
        h.update(arr.tobytes())
    else:
        h.update(_TAG_PYOBJ)
        h.update(pickle.dumps(value, protocol=2))


def canonical_digest(value: Any, meta: Any = None) -> str:
    """Stable hex digest of one request input.

    ndarrays hash as ``dtype.str || shape || C-contiguous bytes``;
    anything else (scalars, strings, tuples) hashes via a
    fixed-protocol pickle.  ``meta`` extends the digest in a separate
    hash domain — request options that change the result must change
    the key.
    """
    h = hashlib.sha256()
    _hash_value(h, value)
    if meta is not None:
        h.update(_TAG_META)
        _hash_value(h, meta)
    return h.hexdigest()


def result_key(fingerprint: str, digest: str) -> str:
    """The cache key: ``sha256(fingerprint || 0x00 || digest)``.

    The fingerprint half is what makes rollout flips self-invalidating:
    v2 weights mean a new fingerprint, a new key space, and v1 entries
    that simply never match again (they age out of the LRU instead of
    needing a flush).
    """
    h = hashlib.sha256()
    h.update(str(fingerprint).encode("utf-8"))
    h.update(b"\x00")
    h.update(str(digest).encode("ascii"))
    return h.hexdigest()


class _Entry:
    __slots__ = ("result", "nbytes", "hits")

    def __init__(self, result, nbytes: int):
        self.result = result
        self.nbytes = nbytes
        self.hits = 0


class ResultCache:
    """Bounded-byte LRU of request key → result ndarray (router tier).

    ``put`` is idempotent — a key already present is never re-inserted
    and never double-counts bytes, which is what makes hedged requests
    safe: whichever racer populates first wins, the loser's put is a
    no-op.  Stored arrays are private read-only copies; ``get`` hands
    the same array to every hit (hits are byte-identical by
    construction).
    """

    def __init__(self, max_bytes: int = 64 * 1024 * 1024,
                 registry: Optional[MetricsRegistry] = None,
                 metric_prefix: str = "router.cache"):
        reg = registry or metrics
        self.max_bytes = int(max_bytes)
        self._lock = threading.Lock()
        self._entries: "OrderedDict[str, _Entry]" = OrderedDict()
        self._bytes = 0
        # per-instance tallies back snapshot(); the registry counters
        # below are process-wide (shared across instances by name) and
        # exist for federation, not for describing THIS cache
        self._n_hit = 0
        self._n_miss = 0
        self._n_evicted = 0
        self._n_uncacheable = 0
        self._m_hit = reg.counter(metric_prefix + ".hit")
        self._m_miss = reg.counter(metric_prefix + ".miss")
        self._m_evicted = reg.counter(metric_prefix + ".evicted")
        self._m_uncacheable = reg.counter(metric_prefix + ".uncacheable")
        self._m_bytes = reg.gauge(metric_prefix + ".bytes")

    def get(self, key: str):
        """The cached result array, or None (counted as hit/miss)."""
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                self._n_miss += 1
                self._m_miss.add(1)
                return None
            self._entries.move_to_end(key)
            entry.hits += 1
            self._n_hit += 1
            self._m_hit.add(1)
            return entry.result

    def uncacheable(self) -> None:
        """Count a request that could not form a key (no fingerprint)."""
        with self._lock:
            self._n_uncacheable += 1
        self._m_uncacheable.add(1)

    def put(self, key: str, result) -> bool:
        """Insert (idempotent); evicts LRU entries to stay under the
        byte budget.  Results larger than the whole budget are refused
        rather than wiping the cache for one key."""
        arr = np.array(result, copy=True)
        arr.setflags(write=False)
        nbytes = int(arr.nbytes)
        with self._lock:
            if key in self._entries:
                return False
            if nbytes > self.max_bytes:
                return False
            while self._bytes + nbytes > self.max_bytes and self._entries:
                _, old = self._entries.popitem(last=False)
                self._bytes -= old.nbytes
                self._n_evicted += 1
                self._m_evicted.add(1)
            self._entries[key] = _Entry(arr, nbytes)
            self._bytes += nbytes
            self._m_bytes.set(self._bytes)
            return True

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._bytes = 0
            self._m_bytes.set(0)

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    @property
    def bytes(self) -> int:
        with self._lock:
            return self._bytes

    def snapshot(self, top: int = 10) -> Dict[str, Any]:
        """The ``/debug/cache`` view: ratios, bytes, hottest keys."""
        with self._lock:
            entries = len(self._entries)
            total = self._bytes
            rows = sorted(
                ((k, e.hits, e.nbytes) for k, e in self._entries.items()),
                key=lambda r: r[1], reverse=True,
            )[:max(int(top), 0)]
            hits = self._n_hit
            misses = self._n_miss
            evicted = self._n_evicted
            uncacheable = self._n_uncacheable
        lookups = hits + misses
        return {
            "entries": entries,
            "bytes": total,
            "max_bytes": self.max_bytes,
            "hit": hits,
            "miss": misses,
            "hit_ratio": round(hits / lookups, 4) if lookups else None,
            "evicted": evicted,
            "uncacheable": uncacheable,
            "top_keys": [
                {"key": k[:16], "hits": h, "bytes": b}
                for k, h, b in rows
            ],
        }


class _Flight:
    """One in-flight forward: the leader resolves it, followers wait."""

    __slots__ = ("key", "event", "reply", "exc", "followers")

    def __init__(self, key):
        self.key = key
        self.event = threading.Event()
        self.reply: Optional[Dict[str, Any]] = None
        self.exc: Optional[BaseException] = None
        self.followers = 0


class SingleFlight:
    """Request-granularity single-flight (replica tier).

    ``claim`` returns ``(flight, is_leader)``: the leader runs the
    forward and MUST ``resolve`` (success or failure) or followers hang
    until their own timeout; followers wait on ``flight.event`` and
    read ``flight.reply`` / ``flight.exc``.
    """

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 metric_prefix: str = "cache.singleflight"):
        reg = registry or metrics
        self._lock = threading.Lock()
        self._inflight: Dict[Any, _Flight] = {}
        self._n_collapsed = 0
        self._n_leaders = 0
        self._m_collapsed = reg.counter(metric_prefix + ".collapsed")
        self._m_leaders = reg.counter(metric_prefix + ".leaders")

    def claim(self, key) -> Tuple[_Flight, bool]:
        with self._lock:
            flight = self._inflight.get(key)
            if flight is not None:
                flight.followers += 1
                self._n_collapsed += 1
                self._m_collapsed.add(1)
                return flight, False
            flight = _Flight(key)
            self._inflight[key] = flight
            self._n_leaders += 1
            self._m_leaders.add(1)
            return flight, True

    def resolve(self, flight: _Flight, reply: Optional[Dict[str, Any]] = None,
                exc: Optional[BaseException] = None) -> None:
        """Leader publishes.  Pop BEFORE set — the compile-cache
        ordering at request granularity: a request arriving after the
        outcome is published claims a *fresh* flight instead of a stale
        one, so a failed leader never wedges the key."""
        with self._lock:
            self._inflight.pop(flight.key, None)
        flight.reply = reply
        flight.exc = exc
        flight.event.set()

    def stats(self) -> Dict[str, float]:
        with self._lock:
            return {
                "inflight": len(self._inflight),
                "leaders": self._n_leaders,
                "collapsed": self._n_collapsed,
            }


class NegativeCache:
    """Small LRU of typed-permanent-error replies (replica tier).

    A poison input whose forward deterministically raises would
    otherwise stampede the device every time a client retries it; here
    the encoded error reply replays from memory.  Only *permanent*
    error classes belong here — transient refusals (overload, drain)
    and deadline expiries are about the moment, not the input, and the
    caller must never store them.
    """

    def __init__(self, capacity: int = 256,
                 registry: Optional[MetricsRegistry] = None,
                 metric_prefix: str = "cache.negative"):
        reg = registry or metrics
        self.capacity = int(capacity)
        self._lock = threading.Lock()
        self._entries: "OrderedDict[Any, Dict[str, Any]]" = OrderedDict()
        self._n_hit = 0
        self._n_stored = 0
        self._m_hit = reg.counter(metric_prefix + ".hit")
        self._m_stored = reg.counter(metric_prefix + ".stored")

    def get(self, key) -> Optional[Dict[str, Any]]:
        with self._lock:
            reply = self._entries.get(key)
            if reply is None:
                return None
            self._entries.move_to_end(key)
            self._n_hit += 1
            self._m_hit.add(1)
            return dict(reply)

    def put(self, key, error_reply: Dict[str, Any]) -> None:
        with self._lock:
            if key in self._entries:
                return
            while len(self._entries) >= self.capacity:
                self._entries.popitem(last=False)
            self._entries[key] = dict(error_reply)
            self._n_stored += 1
            self._m_stored.add(1)

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def stats(self) -> Dict[str, float]:
        with self._lock:
            return {
                "entries": len(self._entries),
                "hit": self._n_hit,
                "stored": self._n_stored,
            }
