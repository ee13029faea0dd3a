"""Host key→slot interning with LRU + TTL semantics.

The reference's LRU cache maps key strings to boxed bucket items
(reference: lrucache.go:32-187).  Here the bucket state lives on device,
so the host only maps key → dense slot index and decides eviction; the
device holds the authoritative `expire_at` and the kernel re-checks
liveness on every access, so the host TTL mirror only has to be good
enough for eviction ordering and the unexpired-evictions metric
(reference: lrucache.go:148-159).

Reference parity notes:
* Eviction policy: least-recently-used first, regardless of expiry,
  with a counter for evictions of unexpired items
  (reference: lrucache.go:148-159).
* Hit/miss accounting mirrors `accessMetric`
  (reference: lrucache.go:112-138).

Port of `gubernator_tpu/core/interning.py` (the Python table).  The
engine serves through the port's native table (`core/native.py`,
csrc/intern_table.cpp); this one is its plain version, which the parity
tests hold the native table against.
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np


class InternTable:
    """Maps key strings to stable slot indices in [0, capacity)."""

    def __init__(self, capacity: int):
        if capacity <= 0:
            raise ValueError("capacity must be positive")
        self.capacity = capacity
        self._map: OrderedDict[str, int] = OrderedDict()
        self._free: list[int] = list(range(capacity - 1, -1, -1))
        # Host TTL mirror, slot-indexed (approximate; device is authoritative).
        self._expire = np.zeros(capacity, dtype=np.int64)
        self._slot_key: list[str | None] = [None] * capacity
        # Metrics (reference: lrucache.go:48-59).
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.unexpired_evictions = 0

    def __len__(self) -> int:
        return len(self._map)

    def contains(self, key: str) -> bool:
        return key in self._map

    def intern(self, key: str, now_ms: int, cleared: list[int]) -> int:
        """Return the slot for `key`, allocating (and possibly evicting)
        if unknown.  Evicted slots are appended to `cleared` so the
        caller can scrub them on device before reuse."""
        slot = self._map.get(key)
        if slot is not None:
            self.hits += 1
            self._map.move_to_end(key)
            return slot
        self.misses += 1
        if self._free:
            slot = self._free.pop()
        else:
            # Evict the least-recently-used key (reference: lrucache.go:148-159).
            old_key, slot = self._map.popitem(last=False)
            self._slot_key[slot] = None
            self.evictions += 1
            if self._expire[slot] > now_ms:
                self.unexpired_evictions += 1
            cleared.append(slot)
        self._map[key] = slot
        self._slot_key[slot] = key
        self._expire[slot] = 0
        return slot

    def set_expiry(self, slots: np.ndarray, expires: np.ndarray) -> None:
        """Update the host TTL mirror after a kernel step."""
        self._expire[slots] = expires

    def remove(self, key: str) -> int | None:
        """Drop a key, freeing its slot (reference: lrucache.go:141-145).
        Returns the freed slot (the caller scrubs it on the device)."""
        slot = self._map.pop(key, None)
        if slot is None:
            return None
        self._slot_key[slot] = None
        self._expire[slot] = 0
        self._free.append(slot)
        return slot

    def release_slots(self, slots: np.ndarray) -> None:
        """Free slots a sweep found expired."""
        for slot in slots.tolist():
            key = self._slot_key[slot]
            if key is None:
                continue
            self._map.pop(key, None)
            self._slot_key[slot] = None
            self._expire[slot] = 0
            self._free.append(slot)

    def key_for_slot(self, slot: int) -> str | None:
        return self._slot_key[slot]
