"""Bounded LRU mapping for the port's model caches (a trimmed copy of
``sparkdl_tpu.utils.lru``): an entry can hold a whole CNN's weights on the
card, so the caches evict rather than grow.

The caches are shared by stages that run in several threads at once
(``CrossValidator(parallelism=k)``), so every access holds a lock, and the
only read is :meth:`LRUCache.get`, which tests membership and reads under
one hold: ``key in cache`` then ``cache[key]`` could lose the entry to
another thread's eviction in between.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any


class LRUCache:
    """Tiny bounded mapping with least-recently-used eviction, safe under
    threads."""

    def __init__(self, maxsize: int):
        self.maxsize = int(maxsize)
        self._data: "OrderedDict[Any, Any]" = OrderedDict()
        self._lock = threading.Lock()

    def __len__(self) -> int:
        with self._lock:
            return len(self._data)

    def get(self, key, default=None):
        """The value of ``key`` (now the most recently used), or
        ``default``."""
        with self._lock:
            if key not in self._data:
                return default
            self._data.move_to_end(key)
            return self._data[key]

    def __setitem__(self, key, value):
        with self._lock:
            self._data[key] = value
            self._data.move_to_end(key)
            while len(self._data) > self.maxsize:
                self._data.popitem(last=False)

    def pop(self, key) -> bool:
        """Drop ``key``; True when it was there."""
        with self._lock:
            return self._data.pop(key, _MISSING) is not _MISSING

    def keys(self) -> list:
        """The keys, least recently used first."""
        with self._lock:
            return list(self._data)

    def clear(self) -> int:
        """Drop every entry; returns how many."""
        with self._lock:
            n = len(self._data)
            self._data.clear()
            return n


_MISSING = object()
