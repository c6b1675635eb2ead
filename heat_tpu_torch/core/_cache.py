"""Bounded LRU cache (counterpart of ``heat_tpu/core/_cache.py``).

The lazy layer keys its plans (``PROGRAM_CACHE``) and its inferred layouts
(``META_CACHE``) by graph signature; a plain dict would grow without bound
under shape-polymorphic traffic. This LRU keeps the newest entries; an
evicted one is only built again."""
from __future__ import annotations

import threading
from collections import OrderedDict

from . import _hooks

__all__ = ["ExecutableCache"]


class ExecutableCache(OrderedDict):
    """OrderedDict with LRU eviction, safe across threads: the serving
    dispatcher thread evaluates plans while client threads capture, and an
    unguarded ``move_to_end`` racing an eviction corrupts the OrderedDict.
    One re-entrant lock covers every mutating path. A new key reports
    ``"cache.insert"`` to the observers (the sanitizer counts it)."""

    def __init__(self, maxsize: int = 256):
        super().__init__()
        self.maxsize = int(maxsize)
        self._lock = threading.RLock()

    def get(self, key, default=None):
        with self._lock:
            try:
                value = super().__getitem__(key)
            except KeyError:
                return default
            self._touch(key)
            return value

    def __getitem__(self, key):
        with self._lock:
            value = super().__getitem__(key)
            self._touch(key)
            return value

    def __setitem__(self, key, value):
        with self._lock:
            is_new = key not in self
            super().__setitem__(key, value)
            self.move_to_end(key)
            # evict oldest first without popitem, which re-enters __getitem__ after unlinking the node
            while len(self) > self.maxsize:
                del self[next(iter(self))]
            if is_new:
                _hooks.observe("cache.insert", size=len(self))

    def pop(self, key, *default):
        with self._lock:
            return super().pop(key, *default)

    def clear(self):
        with self._lock:
            super().clear()

    def _touch(self, key) -> None:
        # an inherited method may look up a key it has already unlinked
        try:
            self.move_to_end(key)
        except KeyError:
            pass
