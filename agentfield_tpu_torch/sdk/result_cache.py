"""TTL + LRU result cache, the port's copy of
``agentfield_tpu/sdk/result_cache.py`` (reference: sdk/python/agentfield/result_cache.py:98
— the async execution manager caches terminal results so pollers and
late readers never re-fetch)."""

from __future__ import annotations

import collections
import time
from typing import Any


class ResultCache:
    def __init__(self, max_entries: int = 1024, ttl: float = 300.0):
        self.max_entries = max_entries
        self.ttl = ttl
        self._data: collections.OrderedDict[str, tuple[float, Any]] = collections.OrderedDict()
        self.hits = 0
        self.misses = 0

    def get(self, key: str) -> Any | None:
        item = self._data.get(key)
        if item is None:
            self.misses += 1
            return None
        ts, value = item
        if time.monotonic() - ts > self.ttl:
            del self._data[key]
            self.misses += 1
            return None
        self._data.move_to_end(key)
        self.hits += 1
        return value

    def put(self, key: str, value: Any) -> None:
        self._data[key] = (time.monotonic(), value)
        self._data.move_to_end(key)
        while len(self._data) > self.max_entries:
            self._data.popitem(last=False)

    def purge_expired(self) -> int:
        cutoff = time.monotonic() - self.ttl
        dead = [k for k, (ts, _) in self._data.items() if ts < cutoff]
        for k in dead:
            del self._data[k]
        return len(dead)

    def stats(self) -> dict[str, int]:
        return {"entries": len(self._data), "hits": self.hits, "misses": self.misses}
