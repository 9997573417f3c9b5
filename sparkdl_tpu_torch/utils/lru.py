"""Bounded LRU mapping for the port's model caches (a trimmed copy of
``sparkdl_tpu.utils.lru``): an entry can hold a whole CNN's weights on the
card, so the caches evict rather than grow."""

from __future__ import annotations

from collections import OrderedDict
from typing import Any


class LRUCache:
    """Tiny bounded mapping with least-recently-used eviction."""

    def __init__(self, maxsize: int):
        self.maxsize = int(maxsize)
        self._data: "OrderedDict[Any, Any]" = OrderedDict()

    def __contains__(self, key) -> bool:
        return key in self._data

    def __getitem__(self, key):
        value = self._data[key]
        self._data.move_to_end(key)
        return value

    def __setitem__(self, key, value):
        self._data[key] = value
        self._data.move_to_end(key)
        while len(self._data) > self.maxsize:
            self._data.popitem(last=False)
