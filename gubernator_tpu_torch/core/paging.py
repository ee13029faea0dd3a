"""Paged device bucket state: a page table with host spill.

Port of `gubernator_tpu/core/paging.py PagePlane`.  The dense state holds
`capacity` bucket rows on the device and can never serve more keys than
that.  Here the LOGICAL slot space (the intern table's) is cut into
pages of GUBER_PAGE_SIZE rows, of which GUBER_PAGED_RESIDENT live in the
device state (the "frames"); the rest live as raw column words in a host
page store (numpy int32 [num_pages, 12, page_size], 48 B a row, the
reference's layout).  The kernels never learn about pages: the host
translates logical slot → (page, row) → frame * page_size + row before it
packs a batch, so every kernel keeps its dense indexing at the device
capacity.

Residency is a two-hand clock over frames: every batch sets the
reference bit of the frames it touches; the hand clears bits as it
sweeps and evicts the first unreferenced, unpinned frame (pinned = the
pages of the batch being translated, so a fault never evicts a page the
same batch needs).  Pages that hold keys the hot-key sketch ranks hot
(utils/hotkeys.py through `hot_slots_provider`) get one extra grace pass
per refresh.

Spill and refill move raw words, so a round trip is bit-exact, the leaky
32.32 remaining included.  The reference spills and refills one page at
a time.  Here the faults of one `translate` are taken together, which
moves the same pages into the same frames:

1. the victim picks and the page-table bookkeeping run page by page in
   the reference's order (`_fault_one`); each refilled frame is pinned,
   so the later picks of the batch see what the reference's see;
2. one host-to-device copy carries the victims' frame starts, the
   refilled frames' starts and the refilled pages' host words;
3. kernel K9 (`ops.page_words.gather_pages`) gathers every victim frame
   that was ever used (never-used pages spill as zeros with no gather),
   before any refill writes, and its block starts home;
4. kernel K10 (`load_pages`) writes the refilled pages into their frames,
   queued on the stream before the faulting batch's K1 / K3 / K4, so the
   batch is answered from the restored rows;
5. the spill's block is fetched, then written to `host_words`.

All of it runs under the engine lock after a pump flush, so every queued
batch that touched a victim frame has run before K9 reads it.  Batches
whose pages are all resident pay none of this.  The host store also
serves what the device cannot: the expiry sweep of non-resident pages
(`sweep_host`), restores into cold pages (`host_restore`) and the export
of cold rows (`host_rows`), none of which faults a page in.
"""

from __future__ import annotations

import time as _time
from typing import Callable, List, Optional, Set, Tuple

import numpy as np

from gubernator_tpu_torch.ops.bucket_kernel import (
    _HI11,
    PAGE_WORD_ROWS,
    UNSIGNED_FIELDS,
    BucketState,
    build_restore_record,
    pack_state_host,
    unpack_state_host,
)
from gubernator_tpu_torch.ops.page_words import gather_pages, load_pages
from gubernator_tpu_torch.utils.metrics import DurationStat

_I32 = np.int32
_I64 = np.int64

# Row of each column in a page block (BucketState order).
_ROW = {name: i for i, name in enumerate(BucketState._fields)}

# Non-resident pages scanned per sweep_host call (incremental, from a
# cursor, as the device sweep's windows are).
SWEEP_HOST_PAGES = 4096

# Ask the hot-slots provider at most once per this many faults: it walks
# the sketch.
_HOT_REFRESH_FAULTS = 64


def words_as_state(words: np.ndarray) -> dict:
    """A [PAGE_WORD_ROWS, P] int32 block as reference-typed host columns
    (uint32 views of the `*_lo` rows), for `unpack_state_host`."""
    return {
        name: words[i].view(np.uint32) if name in UNSIGNED_FIELDS else words[i]
        for i, name in enumerate(BucketState._fields)
    }


def state_as_words(cols: dict) -> np.ndarray:
    """Inverse of `words_as_state` for `pack_state_host`'s output: the
    12 columns stacked into one int32 block."""
    rows = []
    for name in BucketState._fields:
        c = np.asarray(cols[name])
        rows.append(c.view(np.int32) if c.dtype == np.uint32 else c)
    return np.stack(rows).astype(np.int32, copy=False)


class PagePlane:
    """Page table, frame residency and host spill store of one engine.
    Every mutating entry point runs under the engine's lock."""

    def __init__(self, logical_capacity: int, page_size: int, resident_pages: int) -> None:
        if page_size < 16 or page_size & (page_size - 1):
            raise ValueError("page_size must be a power of two >= 16")
        self.page_size = page_size
        self.page_shift = page_size.bit_length() - 1
        self.page_mask = page_size - 1
        self.logical_capacity = logical_capacity
        self.num_pages = -(-logical_capacity // page_size)
        frames = resident_pages or self.num_pages
        self.frames = max(2, min(frames, self.num_pages))
        self.device_capacity = self.frames * page_size

        # Page table: logical page → frame (-1 = not resident) and frame →
        # page.  The first `frames` pages boot resident: the intern table
        # hands out slots ascending, so a cold node fills them first.
        self.frame_of = np.full(self.num_pages, -1, dtype=_I32)
        self.frame_of[: self.frames] = np.arange(self.frames, dtype=_I32)
        self.page_of = np.arange(self.frames, dtype=_I64)
        # Clock state.
        self._ref = np.zeros(self.frames, dtype=bool)
        self._hand = 0
        # Host page store, allocated in full (48 B a row); pages never used
        # spill as zeros without a gather.
        self.host_words = np.zeros((self.num_pages, PAGE_WORD_ROWS, page_size), dtype=_I32)
        self._ever_used = np.zeros(self.num_pages, dtype=bool)
        self._ever_used[: self.frames] = True
        self._sweep_page_cursor = 0

        # Heat feed: a callable returning the hot LOGICAL slots (the
        # service wires the hot-key sketch here), read lazily on faults.
        self.hot_slots_provider: Optional[Callable[[], List[int]]] = None
        self._hot_pages: Set[int] = set()
        self._faults_since_hot_refresh = 0

        self.faults = 0
        self.spills = 0
        self.refills = 0
        # Fault wall per faulted page (a batch's wall counted once per page
        # it faults), its spill half per spilled page (the gather, the copy
        # home, the store) and its refill half per refilled page (the
        # words, the copy up, the write).
        self.fault_duration = DurationStat()
        self.spill_duration = DurationStat()
        self.refill_wait = DurationStat()
        # Fault batches (one K10 each, one K9 where a victim was used).
        self.fault_batches = 0

    # -- translation ----------------------------------------------------

    def translate(self, engine, slots: np.ndarray) -> np.ndarray:
        """Logical slots → device rows, faulting non-resident pages in
        first.  Engine lock held; flushes the pump before it touches
        residency."""
        pages = slots >> self.page_shift
        upages = np.unique(pages)
        if len(upages) > self.frames:
            raise RuntimeError(
                f"batch touches {len(upages)} pages > {self.frames} resident frames "
                "(engine segmentation should have split it)"
            )
        missing = upages[self.frame_of[upages] < 0]
        if len(missing):
            engine._flush_pump()
            self._fault_batch(engine, missing.tolist(), set(upages.tolist()))
        self._ref[self.frame_of[upages]] = True
        self._ever_used[upages] = True
        return self.resident_rows(slots)

    def resident_rows(self, slots: np.ndarray) -> np.ndarray:
        """Device rows of logical slots whose pages are resident."""
        pages = slots >> self.page_shift
        return (
            (self.frame_of[pages].astype(_I64) << self.page_shift)
            | (slots.astype(_I64) & self.page_mask)
        ).astype(_I32)

    def logical_of_device(self, dev_slots: np.ndarray) -> np.ndarray:
        """Device rows → logical slots (sweep release, export)."""
        d = np.asarray(dev_slots, dtype=_I64)
        return (self.page_of[d >> self.page_shift] << self.page_shift) | (d & self.page_mask)

    def resident_mask(self, slots: np.ndarray) -> np.ndarray:
        """Whether each logical slot's page is resident."""
        return self.frame_of[np.asarray(slots, dtype=_I64) >> self.page_shift] >= 0

    # -- fault path -----------------------------------------------------

    def _fault_batch(self, engine, missing: List[int], pinned: Set[int]) -> None:
        """Fault `missing` pages in: victims picked page by page as the
        reference's `_fault_one` picks them, then one K9 for the used
        victims, one K10 for all refills (see the module docstring)."""
        t0 = _time.monotonic()
        spill_pages, spill_frames, refill_frames = [], [], []
        for page in missing:
            frame = self._pick_victim(pinned)
            victim = int(self.page_of[frame])
            if self._ever_used[victim]:
                spill_pages.append(victim)
                spill_frames.append(frame)
            self.frame_of[victim] = -1
            self.frame_of[page] = frame
            self.page_of[frame] = page
            self._ref[frame] = True
            refill_frames.append(frame)
        k, ks, psz = len(missing), len(spill_pages), self.page_size
        # The refill's half: its words and one copy up, [victim starts |
        # refill starts | pad | refill words], the words at a 16-byte
        # boundary (K10 moves 16 bytes a thread).
        tr = _time.monotonic()
        n_starts = -(-(ks + k) // 4) * 4
        buf = np.zeros(n_starts + k * PAGE_WORD_ROWS * psz, dtype=_I32)
        buf[: ks + k] = np.asarray(spill_frames + refill_frames, dtype=_I64) << self.page_shift
        buf[n_starts:] = self.host_words[missing].reshape(-1)
        staged = engine._stage(buf)
        t_refill = _time.monotonic() - tr
        state = engine._state
        ticket = None
        if ks:
            ts = _time.monotonic()
            ticket = engine.readback.register(gather_pages(state, staged[:ks], psz))
            engine.dispatches_total += 1
            t_spill = _time.monotonic() - ts
        tr = _time.monotonic()
        load_pages(state, staged[ks : ks + k], staged[n_starts:].view(k, PAGE_WORD_ROWS, psz))
        engine.dispatches_total += 1
        self.refill_wait.observe(t_refill + _time.monotonic() - tr, k)
        if ticket is not None:
            ts = _time.monotonic()
            self.host_words[spill_pages] = ticket.fetch()
            self.spill_duration.observe(t_spill + _time.monotonic() - ts, ks)
        self.faults += k
        self.refills += k
        self.spills += ks
        self.fault_batches += 1
        self.fault_duration.observe(_time.monotonic() - t0, k)

    def _pick_victim(self, pinned: Set[int]) -> int:
        """Two-hand clock: clear reference bits as the hand sweeps; evict
        the first unreferenced, unpinned, not-hot frame.  Bounded at two
        revolutions, then the first unpinned frame."""
        self._maybe_refresh_hot()
        hot = self._hot_pages
        for _ in range(2 * self.frames):
            f = self._hand
            self._hand = (f + 1) % self.frames
            page = int(self.page_of[f])
            if page in pinned:
                continue
            if self._ref[f]:
                self._ref[f] = False
                continue
            if page in hot:
                hot.discard(page)  # one grace pass per refresh
                continue
            return f
        for f in range(self.frames):
            if int(self.page_of[f]) not in pinned:
                return f
        raise RuntimeError("no evictable frame (all pinned)")

    def _maybe_refresh_hot(self) -> None:
        if self.hot_slots_provider is None:
            return
        self._faults_since_hot_refresh += 1
        if self._faults_since_hot_refresh < _HOT_REFRESH_FAULTS and self._hot_pages:
            return
        self._faults_since_hot_refresh = 0
        try:
            slots = self.hot_slots_provider()
        except Exception:  # noqa: BLE001 — heat is advisory, never fatal
            return
        self._hot_pages = {int(s) >> self.page_shift for s in slots}

    # -- host-side mutations (non-resident pages) -----------------------

    def clear_host_slots(self, slots: np.ndarray) -> None:
        """Drop the occupied bit of non-resident logical slots in the host
        store (the eviction clear of a cold page)."""
        slots = np.asarray(slots, dtype=_I64)
        self.host_words[slots >> self.page_shift, _ROW["meta"], slots & self.page_mask] &= ~_I32(1)

    def host_restore(self, restores: List[Tuple[int, object]]) -> None:
        """Write restored CacheItems straight into non-resident pages' host
        words, so a checkpoint load does not fault the key space through
        the frames.  `restores` = [(logical_slot, CacheItem)]."""
        n = len(restores)
        rec = build_restore_record(restores, self.logical_capacity, size=n)
        packed = pack_state_host({
            "occupied": np.ones(n, dtype=bool),
            "algo": rec["algo"],
            "status": rec["status"],
            "t0": rec["t0"],
            "invalid": rec["invalid_at"],
            "expire": rec["expire_at"],
            "duration": rec["duration"],
            "limit": rec["limit"],
            "remaining": rec["remaining"],
            "remf_hi": rec["remf_hi"],
            "remf_lo": rec["remf_lo"],
            "burst": rec["burst"],
        })
        words = state_as_words(packed)  # [12, n]
        slots = rec["slot"].astype(_I64)
        pages = slots >> self.page_shift
        self.host_words[pages, :, slots & self.page_mask] = words.T
        self._ever_used[np.unique(pages)] = True

    def host_rows(self, page: int) -> dict:
        """One non-resident page's host words decoded as
        `unpack_state_host` decodes a state."""
        return unpack_state_host(words_as_state(self.host_words[page]))

    def nonresident_used_pages(self) -> np.ndarray:
        """Pages whose rows exist only in the host store."""
        return np.nonzero((self.frame_of < 0) & self._ever_used)[0]

    def sweep_host(self, now_ms: int) -> np.ndarray:
        """TTL sweep of non-resident pages from the host words alone:
        returns the freed LOGICAL slots (the caller releases them) and
        drops their occupied bits.  At most SWEEP_HOST_PAGES pages a
        call, from a cursor; never faults a page in."""
        cand = self.nonresident_used_pages()
        if len(cand) == 0:
            return np.empty(0, dtype=_I64)
        if len(cand) > SWEEP_HOST_PAGES:
            start = self._sweep_page_cursor % len(cand)
            take = np.roll(cand, -start)[:SWEEP_HOST_PAGES]
            self._sweep_page_cursor = start + SWEEP_HOST_PAGES
        else:
            take = cand
            self._sweep_page_cursor = 0
        w = self.host_words[take]  # [K, 12, P]
        occ = (w[:, _ROW["meta"], :] & 1) != 0
        exp_lo = w[:, _ROW["expire_lo"], :].view(np.uint32).astype(_I64)
        expire = ((w[:, _ROW["hi2"], :] & _HI11).astype(_I64) << 32) | exp_lo
        # expire_at < now is dead; equality still serves (as the device sweep).
        pk, rows = np.nonzero(occ & (expire < now_ms))
        if len(pk) == 0:
            return np.empty(0, dtype=_I64)
        pages = take[pk]
        self.host_words[pages, _ROW["meta"], rows] &= ~_I32(1)
        return (pages.astype(_I64) << self.page_shift) | rows
