"""ctypes wrapper over the port's native intern table.

Port of `gubernator_tpu/core/native.py`.  `NativeInternTable` has the
API of the plain `core.interning.InternTable` plus the batch `schedule()`
the engine serves through: one call interns the whole batch, assigns
serialization rounds and returns the eviction clears with their rounds,
where the plain table walks the keys one by one in Python.  The library
is `csrc/intern_table.cpp`, built with g++ by `ops.native_build` on
first use.  The two tables agree on every observable
(tests/test_torch_native_table.py).  `multi_schedule` is the sharded
engine's whole host tier over one table a shard in one call (reference
:262).

There is no fallback: `make_intern_table` raises when the library does
not build or load, and the engine does not quietly serve from the plain
table.
"""

from __future__ import annotations

import ctypes
import os
from typing import List, Optional, Tuple

import numpy as np

from gubernator_tpu_torch.ops import native_build


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


class NativeInternTable:
    """Maps key strings to stable slot indices in [0, capacity), in C++."""

    def __init__(self, capacity: int):
        if capacity <= 0:
            raise ValueError("capacity must be positive")
        self._lib = native_build.load("intern_table")
        self.capacity = capacity
        self._t = self._lib.git_new(capacity)
        # Mirrors of the C++ cumulative counters, refreshed by schedule()
        # and multi_schedule(), less `_stat_off`.
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.unexpired_evictions = 0
        # Discounts subtracted from the C++ counters when they are
        # mirrored (`discount_stats`; reference :128).
        self._stat_off = [0, 0, 0, 0]

    def __del__(self):
        t = getattr(self, "_t", None)
        if t:
            self._lib.git_free(t)
            self._t = None

    def __len__(self) -> int:
        return int(self._lib.git_len(self._t))

    # -- batch path ------------------------------------------------------

    def schedule(
        self, keys: List[bytes], now_ms: int
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """Intern a batch: returns (slots, rounds, evicted_slots,
        evict_rounds), int32 each, in one native call."""
        from gubernator_tpu_torch.core.engine import PackedKeys

        packed = PackedKeys.from_list(keys)
        return self.schedule_packed(packed.buf, packed.offsets, now_ms)

    def schedule_packed(
        self,
        buf_arr: np.ndarray,  # uint8: the keys' bytes, concatenated
        offsets: np.ndarray,  # int64 [n+1]
        now_ms: int,
        idx: Optional[np.ndarray] = None,  # int64 subset of the items (None = all)
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """`schedule` over keys already packed as one byte buffer and
        offsets (`core.engine.PackedKeys`): no per-key Python."""
        n = len(idx) if idx is not None else len(offsets) - 1
        buf_arr = np.ascontiguousarray(buf_arr, dtype=np.uint8)
        offsets = np.ascontiguousarray(offsets, dtype=np.int64)
        if idx is not None:
            idx = np.ascontiguousarray(idx, dtype=np.int64)
        slots = np.empty(n, dtype=np.int32)
        rounds = np.empty(n, dtype=np.int32)
        evicted = np.empty(max(n, 1), dtype=np.int32)
        evict_rounds = np.empty(max(n, 1), dtype=np.int32)
        stats = np.zeros(4, dtype=np.int64)
        n_ev = self._lib.git_schedule_idx(
            self._t, _ptr(buf_arr), _ptr(offsets),
            _ptr(idx) if idx is not None else None, n, now_ms,
            _ptr(slots), _ptr(rounds), _ptr(evicted), _ptr(evict_rounds), _ptr(stats),
        )
        self._mirror(stats)
        return slots, rounds, evicted[:n_ev], evict_rounds[:n_ev]

    def _mirror(self, stats) -> None:
        """Take the C++ cumulative (hits, misses, evictions,
        unexpired_evictions), less the discounts."""
        self.hits, self.misses, self.evictions, self.unexpired_evictions = (
            int(v) - off for v, off in zip(stats, self._stat_off)
        )

    def discount_stats(self, hits: int, misses: int, evictions: int = 0,
                       unexpired: int = 0) -> None:
        """Leave traffic out of the mirrored counters from now on
        (reference :190)."""
        for k, v in enumerate((hits, misses, evictions, unexpired)):
            self._stat_off[k] += v
        self.hits -= hits
        self.misses -= misses
        self.evictions -= evictions
        self.unexpired_evictions -= unexpired

    # -- the InternTable API ---------------------------------------------

    def intern(self, key: str, now_ms: int, cleared: list) -> int:
        """The slot of `key`, allocating (and maybe evicting); evicted
        slots are appended to `cleared`."""
        slots, _rounds, evicted, _er = self.schedule([key.encode()], now_ms)
        cleared.extend(evicted.tolist())
        return int(slots[0])

    def contains(self, key: str) -> bool:
        k = key.encode()
        return bool(self._lib.git_contains(self._t, k, len(k)))

    def set_expiry(self, slots: np.ndarray, expires: np.ndarray) -> None:
        """Update the host TTL mirror (eviction accounting only; the
        device holds the authoritative expiry)."""
        slots = np.ascontiguousarray(slots, dtype=np.int32)
        expires = np.ascontiguousarray(expires, dtype=np.int64)
        self._lib.git_set_expiry(self._t, _ptr(slots), _ptr(expires), len(slots))

    def remove(self, key: str) -> Optional[int]:
        k = key.encode()
        slot = self._lib.git_remove(self._t, k, len(k))
        return None if slot < 0 else int(slot)

    def release_slots(self, slots: np.ndarray) -> None:
        """Free slots (a sweep's reclaimed buckets)."""
        slots = np.ascontiguousarray(slots, dtype=np.int32)
        self._lib.git_release(self._t, _ptr(slots), len(slots))

    def key_for_slot(self, slot: int) -> Optional[str]:
        cap = 256
        while True:
            out = ctypes.create_string_buffer(cap)
            ln = self._lib.git_key_for_slot(self._t, slot, out, cap)
            if ln < 0:
                return None
            if ln <= cap:
                return out.raw[:ln].decode()
            cap = int(ln)


_DEFAULT_THREADS: Optional[int] = None


def _default_threads() -> int:
    """GUBER_MULTI_THREADS, read once (a malformed value fails at first
    use); 0 or unset = one thread a shard, at most one a CPU (reference
    :249)."""
    global _DEFAULT_THREADS
    if _DEFAULT_THREADS is None:
        env = os.environ.get("GUBER_MULTI_THREADS", "")
        _DEFAULT_THREADS = int(env) if env else 0
    return _DEFAULT_THREADS


def multi_schedule(
    tables: List[NativeInternTable],
    buf_arr: np.ndarray,  # uint8: the keys' bytes, concatenated
    offsets: np.ndarray,  # int64 [n+1]
    hashes: Optional[np.ndarray],  # uint64 fnv1a-64 a key (None = computed in C)
    now_ms: int,
    expires: Optional[np.ndarray] = None,  # int64 [n]: TTL mirror writes
    threads: Optional[int] = None,  # None = GUBER_MULTI_THREADS, else one a shard
):
    """The sharded engine's host tier in one native call (reference
    :262): shard routing (fnv1a-64 % n_shards), each table's interning,
    LRU, eviction and rounds (a table on one thread only), the TTL mirror
    writes, and the dispatch order, grouped by shard and sorted by
    (slot, round) within each shard.  Returns (max_round, shard, slots,
    rounds, order, shard_counts, evicted, evict_shard, evict_rounds),
    numpy arrays."""
    n_sh = len(tables)
    n = len(offsets) - 1
    lib = tables[0]._lib
    if threads is None:
        threads = _default_threads() or min(n_sh, os.cpu_count() or 1)
    buf_arr = np.ascontiguousarray(buf_arr, dtype=np.uint8)
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    if hashes is not None:
        hashes = np.ascontiguousarray(hashes, dtype=np.uint64)
    if expires is not None:
        expires = np.ascontiguousarray(expires, dtype=np.int64)
    shard = np.empty(n, dtype=np.int32)
    slots = np.empty(n, dtype=np.int32)
    rounds = np.empty(n, dtype=np.int32)
    order = np.empty(n, dtype=np.int64)
    shard_counts = np.empty(n_sh, dtype=np.int64)
    evicted = np.empty(max(n, 1), dtype=np.int32)
    evict_shard = np.empty(max(n, 1), dtype=np.int32)
    evict_rounds = np.empty(max(n, 1), dtype=np.int32)
    n_evicted = np.zeros(1, dtype=np.int64)
    stats = np.zeros(4 * n_sh, dtype=np.int64)
    ptrs = (ctypes.c_void_p * n_sh)(*[t._t for t in tables])
    max_round = lib.git_multi_schedule(
        ptrs, n_sh, _ptr(buf_arr), _ptr(offsets),
        _ptr(hashes) if hashes is not None else None, n, now_ms,
        _ptr(expires) if expires is not None else None,
        _ptr(shard), _ptr(slots), _ptr(rounds), _ptr(order), _ptr(shard_counts),
        _ptr(evicted), _ptr(evict_shard), _ptr(evict_rounds), _ptr(n_evicted), _ptr(stats),
        int(threads),
    )
    for sh, t in enumerate(tables):
        t._mirror(stats[4 * sh : 4 * sh + 4])
    ne = int(n_evicted[0])
    return (int(max_round), shard, slots, rounds, order, shard_counts,
            evicted[:ne], evict_shard[:ne], evict_rounds[:ne])


def make_intern_table(capacity: int) -> NativeInternTable:
    """The engine's table: the native one.  A failed build raises (the
    compiler's output in the message); nothing falls back."""
    return NativeInternTable(capacity)
