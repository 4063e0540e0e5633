"""Small LRU cache dict with eviction callback.

Used by the model manager (character model cache) and reference-audio
feature cache; capability parity with the reference's
``LRUCacheDict`` (``genie_tts/Utils/Utils.py:5-21``)
plus an eviction hook so device buffers can be released deterministically.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Callable, Generic, Iterator, Optional, Tuple, TypeVar

K = TypeVar("K")
V = TypeVar("V")


class LRUCache(Generic[K, V]):
    def __init__(self, capacity: int, on_evict: Optional[Callable[[K, V], None]] = None):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = capacity
        self._data: "OrderedDict[K, V]" = OrderedDict()
        self._on_evict = on_evict
        self._lock = threading.RLock()

    def get(self, key: K) -> Optional[V]:
        with self._lock:
            if key not in self._data:
                return None
            self._data.move_to_end(key)
            return self._data[key]

    def put(self, key: K, value: V) -> None:
        with self._lock:
            if key in self._data:
                self._data.move_to_end(key)
            self._data[key] = value
            while len(self._data) > self.capacity:
                k, v = self._data.popitem(last=False)
                if self._on_evict:
                    self._on_evict(k, v)

    def pop(self, key: K) -> Optional[V]:
        with self._lock:
            return self._data.pop(key, None)

    def clear(self) -> None:
        with self._lock:
            if self._on_evict:
                for k, v in self._data.items():
                    self._on_evict(k, v)
            self._data.clear()

    def __contains__(self, key: K) -> bool:
        with self._lock:
            return key in self._data

    def __len__(self) -> int:
        with self._lock:
            return len(self._data)

    def items(self) -> Iterator[Tuple[K, V]]:
        with self._lock:
            return iter(list(self._data.items()))
