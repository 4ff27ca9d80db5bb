"""Fixed-size LRU with an eviction handler.

The reference's ra_flru.erl (:8-40) — a tiny LRU used to cap the number
of open segment file descriptors per server (ra_log_reader's
open_segments).  Eviction calls the handler so the owner can close the
evicted resource.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Any, Callable, Optional

DEFAULT_MAX_SIZE = 5  # ra_flru's default open-segment cap


class Flru:
    def __init__(self, max_size: int = DEFAULT_MAX_SIZE,
                 on_evict: Optional[Callable[[Any, Any], None]] = None):
        self.max_size = max_size
        self.on_evict = on_evict
        self._items: "OrderedDict[Any, Any]" = OrderedDict()

    def touch(self, key: Any, value: Any) -> None:
        """Insert or refresh key as most-recently-used; evicts the LRU
        item (invoking the handler) when over capacity."""
        if key in self._items:
            self._items.move_to_end(key)
            self._items[key] = value
            return
        self._items[key] = value
        while len(self._items) > self.max_size:
            old_key, old_val = self._items.popitem(last=False)
            if self.on_evict is not None:
                self.on_evict(old_key, old_val)

    def get(self, key: Any) -> Optional[Any]:
        if key not in self._items:
            return None
        self._items.move_to_end(key)
        return self._items[key]

    def pop(self, key: Any) -> Optional[Any]:
        """Remove without invoking the eviction handler (the caller is
        taking ownership)."""
        return self._items.pop(key, None)

    def evict_all(self) -> None:
        while self._items:
            key, val = self._items.popitem(last=False)
            if self.on_evict is not None:
                self.on_evict(key, val)

    def __contains__(self, key: Any) -> bool:
        return key in self._items

    def __len__(self) -> int:
        return len(self._items)
