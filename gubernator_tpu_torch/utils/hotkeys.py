"""Hot-key attribution: a space-saving top-K sketch over decision keys.

Port of `gubernator_tpu/utils/hotkeys.py` (stdlib and numpy only, no
device work): Metwally's space-saving algorithm with a fixed capacity of
counters.  Every offered (key, hits) either bumps its existing counter
or evicts the minimum counter, inheriting its count as the new entry's
error bound: any key with true count > count_min is in the table, and
each reported count over-estimates by at most its recorded `err`.

Windowed decay: each tracked key also carries a two-window hit counter
(current and previous window of `window_s` seconds, rotated lazily on
touch and read), so `top_rates()` reports the current offered rate — a
key hot an hour ago reads ~0.  Rates come with the last observed (limit,
duration) where the offering path carries them.

In the port the sketch feeds the paged state's eviction clock
(core/paging.py `_maybe_refresh_hot`, wired in service.py): pages that
hold the top keys get one grace pass of the clock hand.  `now` is
injectable, so tests freeze the rate windows.  The batch entry points
pre-aggregate with numpy (one np.unique a batch, dict work only per
unique key).  GUBER_HOTKEYS turns it off; GUBER_HOTKEYS_K sets the
counters, GUBER_HOTKEYS_WINDOW the decay window (`from_env`).
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Tuple

# _items value layout (a list, not a class: the offer path is the
# serving tier's highest-rate per-unique-key loop).
_COUNT = 0   # cumulative estimated count (space-saving)
_ERR = 1     # over-estimate bound inherited at eviction
_WID = 2     # window id of the _WIN counter
_WIN = 3     # hits offered in window _WID
_PREV = 4    # hits offered in window _WID - 1
_LIMIT = 5   # last observed request limit (0 = never seen)
_DUR = 6     # last observed request duration ms (0 = never seen)


class SpaceSaving:
    """Fixed-capacity top-K counter table (thread-safe).

    Eviction uses a LAZY MIN-HEAP of (count-at-push, key) entries
    instead of an O(capacity) min() scan: counts only grow, so a heap
    entry is either current (evictable) or stale (its key was bumped
    or already evicted — pop and, if live, re-push at the current
    count).  Amortized O(log K) per eviction; the table is on
    default-enabled serve paths where a full scan per new key would
    be a per-batch tax on high-cardinality workloads."""

    def __init__(
        self,
        capacity: int = 1024,
        *,
        window_s: float = 5.0,
        now=time.monotonic,
    ) -> None:
        self.capacity = max(1, capacity)
        # Decay window (seconds) for top_rates(); mutable, so a caller
        # can tune responsiveness live.
        self.window_s = max(1e-3, window_s)
        self._now = now
        # key -> [count, err, wid, win, prev, limit, duration]
        self._items: Dict[bytes, List[int]] = {}
        self._heap: list = []  # lazy (count_at_push, key) min-heap, guarded by _lock
        self._lock = threading.Lock()  # guards _items
        self.offered = 0  # guarded by _lock

    def _wid(self) -> int:
        return int(self._now() / self.window_s)

    @staticmethod
    def _rotate(it: List[int], wid: int) -> None:
        """Lazily shift the two-window counters to window `wid`."""
        gap = wid - it[_WID]
        if gap == 0:
            return
        it[_PREV] = it[_WIN] if gap == 1 else 0
        it[_WIN] = 0
        it[_WID] = wid

    def _pop_min_locked(self) -> tuple:
        """(min_key, min_count) via the lazy heap; stale entries are
        dropped or refreshed on the way down."""
        import heapq

        while True:
            count, key = heapq.heappop(self._heap)
            it = self._items.get(key)
            if it is None:
                continue  # evicted earlier; stale entry
            if it[_COUNT] != count:
                # Bumped since pushed: refresh at the current count.
                heapq.heappush(self._heap, (it[_COUNT], key))
                continue
            return key, count

    def _offer_locked(
        self, key: bytes, n: int, wid: int, lim: int = 0, dur: int = 0
    ) -> None:
        import heapq

        it = self._items.get(key)
        if it is not None:
            it[_COUNT] += n  # heap entry goes stale; refreshed lazily
            self._rotate(it, wid)
            it[_WIN] += n
            if lim:
                it[_LIMIT] = lim
                it[_DUR] = dur
            return
        if len(self._items) < self.capacity:
            self._items[key] = [n, 0, wid, n, 0, lim, dur]
            heapq.heappush(self._heap, (n, key))
            return
        # Evict the minimum counter; the newcomer inherits its count
        # as the over-estimate bound (Metwally et al. 2005).  The
        # window counters start fresh — rates carry no inherited
        # error, only the cumulative count does.
        min_key, min_count = self._pop_min_locked()
        del self._items[min_key]
        self._items[key] = [min_count + n, min_count, wid, n, 0, lim, dur]
        heapq.heappush(self._heap, (min_count + n, key))

    def offer(self, key: bytes, n: int = 1) -> None:
        wid = self._wid()
        with self._lock:
            self.offered += n
            self._offer_locked(key, n, wid)

    def offer_many(self, pairs) -> None:
        """(key bytes, hits) iterable under ONE lock acquisition."""
        wid = self._wid()
        with self._lock:
            for key, n in pairs:
                self.offered += n
                self._offer_locked(key, n, wid)

    def offer_many_params(self, rows) -> None:
        """(key bytes, hits, limit, duration) iterable under ONE lock
        — the dataclass serving path's entry, carrying the request
        params the promotion plane sizes leases from."""
        wid = self._wid()
        with self._lock:
            for key, n, lim, dur in rows:
                self.offered += n
                self._offer_locked(key, n, wid, lim, dur)

    def offer_columns(
        self, key_buf, key_offsets, hits, idx=None, hashes=None,
        limit=None, duration=None,
    ) -> None:
        """Decoded-wire-batch entry: with `hashes` (the decode's
        per-row fnv1a), rows group by hash in ONE np.unique pass and
        key bytes materialize only per UNIQUE key — a 1000-occurrence
        hot-key batch costs one slice, which is what lets the
        zero-per-key-Python serve paths afford this hook.  (Hash
        identity: a 64-bit collision merges two keys' counts — noise
        far below the sketch's own error bound.)  Without hashes the
        per-row fallback runs.  `idx` restricts to a subset of rows
        (the GLOBAL serve route's owned/non-owned splits reuse the
        same decode).  `limit`/`duration` columns, when given, stamp
        each unique key's last-seen request params (lease sizing)."""
        import numpy as np

        offs = np.asarray(key_offsets)
        h = np.asarray(hits, dtype=np.int64)
        starts = offs[:-1]
        lens = offs[1:] - starts
        lim = np.asarray(limit) if limit is not None else None
        dur = np.asarray(duration) if duration is not None else None
        if idx is not None:
            starts, lens, h = starts[idx], lens[idx], h[idx]
            if lim is not None:
                lim, dur = lim[idx], dur[idx]
        if len(starts) == 0:
            return
        # Decisions with hits=0 are status reads; count them as one
        # observation each so read-hot keys still surface.
        weight = np.maximum(h, 1)
        if hashes is not None:
            hh = np.asarray(hashes)
            if idx is not None:
                hh = hh[idx]
            _u, first, inv = np.unique(
                hh, return_index=True, return_inverse=True
            )
            weight = np.bincount(inv, weights=weight).astype(np.int64)
            starts, lens = starts[first], lens[first]
            if lim is not None:
                lim, dur = lim[first], dur[first]
        buf = np.asarray(key_buf)
        if lim is None:
            self.offer_many(
                (buf[a:a + l].tobytes(), w)
                for a, l, w in zip(
                    starts.tolist(), lens.tolist(), weight.tolist()
                )
            )
        else:
            self.offer_many_params(
                (buf[a:a + l].tobytes(), w, li, du)
                for a, l, w, li, du in zip(
                    starts.tolist(), lens.tolist(), weight.tolist(),
                    lim.tolist(), dur.tolist(),
                )
            )

    def top(self, n: int = 20) -> List[Tuple[bytes, int, int]]:
        """[(key, estimated count, error bound)] sorted descending."""
        with self._lock:
            rows = sorted(
                ((k, v[_COUNT], v[_ERR]) for k, v in self._items.items()),
                key=lambda r: r[1],
                reverse=True,
            )
        return rows[:n]

    def top_rates(
        self, n: int = 20
    ) -> List[Tuple[bytes, float, int, int]]:
        """[(key, current offered hits/sec, last limit, last duration)]
        sorted by rate descending.  The rate is the sliding two-window
        estimate: the previous window's count weighted by its remaining
        overlap plus the current window's count, over one window — so a
        key that stopped being offered decays to ~0 within two windows
        regardless of its cumulative count (the demotion contract)."""
        now = self._now()
        wid = int(now / self.window_s)
        frac = (now / self.window_s) - wid  # elapsed fraction of wid
        w = self.window_s
        out: List[Tuple[bytes, float, int, int]] = []
        with self._lock:
            for k, it in self._items.items():
                self._rotate(it, wid)
                rate = (it[_PREV] * (1.0 - frac) + it[_WIN]) / w
                if rate > 0.0:
                    out.append((k, rate, it[_LIMIT], it[_DUR]))
        out.sort(key=lambda r: r[1], reverse=True)
        return out[:n]

    def rate(self, key: bytes) -> float:
        """Current offered rate (hits/sec) for one tracked key; 0.0
        when untracked or idle."""
        now = self._now()
        wid = int(now / self.window_s)
        frac = (now / self.window_s) - wid
        with self._lock:
            it = self._items.get(key)
            if it is None:
                return 0.0
            self._rotate(it, wid)
            return (it[_PREV] * (1.0 - frac) + it[_WIN]) / self.window_s

    def stats(self) -> dict:
        with self._lock:
            return {
                "capacity": self.capacity,
                "tracked": len(self._items),
                "offered": self.offered,
            }


def from_env() -> Optional[SpaceSaving]:
    """Build the instance-level sketch from GUBER_HOTKEYS /
    GUBER_HOTKEYS_K / GUBER_HOTKEYS_WINDOW (None when disabled)."""
    import os

    if os.environ.get("GUBER_HOTKEYS", "1").strip().lower() in (
        "0", "false", "no", "off"
    ):
        return None
    try:
        k = int(os.environ.get("GUBER_HOTKEYS_K", "1024"))
    except ValueError:
        k = 1024
    try:
        window = float(os.environ.get("GUBER_HOTKEYS_WINDOW", "5.0"))
    except ValueError:
        window = 5.0
    return SpaceSaving(capacity=k, window_s=window)
