"""Interval-driven aggregation loop — the framework's host-side batcher.

The port's copy of `gubernator_tpu/cluster/batch_loop.py` (stdlib only).

The reference builds this pattern three times (peer batching
peer_client.go:380-453, GLOBAL hit/broadcast loops global.go:78-202,
multi-region multiregion.go:43-92): accumulate items into an aggregate,
flush when the aggregate reaches `batch_limit` or `sync_wait` has
elapsed since the first item.  This is the one host-side primitive that
feeds the TPU step cadence, so it lives in one place.

`sync_wait` is a CAP, not a fixed
delay.  Every tier grew one of these windows, and on the GLOBAL path
they stack in series (client window + hit window + broadcast window),
so a fixed wait taxes the cluster-tier MEDIAN even when nothing would
have batched.  AdaptiveWait keeps the reference's interval semantics
(peer_client.go:380-453: the ticker only matters when traffic is
actually queueing) but sizes the wait by measured occupancy: an idle
batcher fires immediately; the wait grows toward the cap only while
batches actually fill.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, Generic, Optional, TypeVar

K = TypeVar("K")
V = TypeVar("V")


class AdaptiveWait:
    """Load-adaptive batching window: 0 under low occupancy, `cap`
    when batches fill.

    Occupancy is an EWMA of flush fill fraction (drained items ÷
    batch_limit).  The wait is `cap * min(1, ewma / fill_target)`:
    once windows fill past `fill_target` of the limit the full cap is
    worth paying (amortization), below it the wait shrinks linearly to
    zero — a single-caller batcher flushes as soon as the item lands
    instead of idling out its window (the cluster-tier p50 mechanism).  The feedback is self-correcting: firing
    immediately under trickle load keeps batches small, which keeps
    the wait at ~0; under a herd, even zero-wait windows fill while
    the previous flush runs, which grows the wait toward the cap.
    """

    __slots__ = ("cap", "limit", "fill_target", "alpha", "_ewma")

    def __init__(
        self,
        cap: float,
        limit: int,
        *,
        fill_target: float = 0.5,
        alpha: float = 0.4,
    ):
        self.cap = cap
        self.limit = max(1, limit)
        self.fill_target = fill_target
        self.alpha = alpha
        self._ewma = 0.0  # start idle: the first window fires fast

    def next_wait(self) -> float:
        if self.cap <= 0:
            return 0.0
        frac = min(1.0, self._ewma / self.fill_target)
        w = self.cap * frac
        # Sub-50µs sleeps cost more in scheduler churn than they buy.
        return w if w >= 50e-6 else 0.0

    def observe(self, drained: int) -> None:
        fill = min(1.0, drained / self.limit)
        self._ewma += self.alpha * (fill - self._ewma)


class IntervalBatcher(Generic[K, V]):
    """Aggregate (key, item) pairs; flush at batch_limit or an
    occupancy-adaptive wait capped at sync_wait.

    `combine(existing, item) -> merged` merges a new item into the
    aggregate for its key (None existing for the first).  `flush(dict)`
    runs on the batcher thread (ordered mode) or a small flush pool
    (ordered=False) — see `flush_workers`.
    """

    def __init__(
        self,
        sync_wait: float,
        batch_limit: int,
        combine: Callable,
        flush: Callable[[Dict[K, V]], None],
        *,
        name: str = "batcher",
        chunked: bool = False,
        drain_limit: int | None = None,
        item_drain_limit: int | None = None,
        max_pending: int | None = None,
        overflow: str = "block",
        adaptive: bool = True,
        flush_workers: int = 0,
        wait_stat=None,  # DurationStat: queue age at drain (window wait)
        age_stat=None,  # DurationStat: oldest-item age at flush END
    ):
        self.sync_wait = sync_wait
        self.batch_limit = batch_limit
        # sync_wait as an occupancy-scaled cap (AdaptiveWait) vs the
        # fixed wait (tests that pin window timing).
        self._adaptive = (
            AdaptiveWait(sync_wait, batch_limit) if adaptive else None
        )
        # Max items taken per flush CYCLE (None = drain everything).
        # Under overload an unbounded drain turns into one multi-second
        # flush that holds the GIL/core against the serving threads and
        # blows peer RPC deadlines (the GLOBAL p99 tail);
        # a bounded drain keeps each flush ~batch-sized and lets the
        # loop run back-to-back cycles until the queue is level.
        # (Columnar flushes that aggregate their drain vectorized can
        # safely take None + max_pending as the bound instead —
        # item_drain_limit then still caps the DICT items per cycle,
        # whose flush cost is per-key Python, not one numpy pass.)
        self._drain_limit = drain_limit
        self._item_drain_limit = item_drain_limit
        # Queue bound.  overflow="block": producers wait for drain
        # space (the reference's unbuffered-channel backpressure,
        # global.go:68-74) — safe only where no flush path can
        # re-enter the producer side, or a full cluster deadlocks.
        # overflow="drop_oldest": shed the oldest chunks and count
        # them (safe for supersedable traffic like status broadcasts).
        self._max_pending = max_pending
        self._overflow = overflow
        self.dropped = 0  # guberlint: guarded-by _lock
        self._combine = combine
        self._flush = flush
        self._wait_stat = wait_stat
        self._age_stat = age_stat
        # Deferred re-admission (requeue_many delay=): failed-flush
        # items HELD until a due time, invisible to the drain until
        # they come due — the damped-retry primitive.  A flush that
        # re-queues toward a broken peer with a backoff delay must not
        # spin the loop (re-admitted items would drain again
        # immediately) and must not sleep on a flush worker (a parked
        # worker is exactly the stall the health plane exists to
        # prevent); held batches instead bound the loop's wait, so the
        # retry fires at its due time even with zero fresh traffic —
        # which is what lets a healed peer converge after the clients
        # go quiet.  Entries: (due_monotonic, pairs, oldest_ts).
        self._held: list = []  # guberlint: guarded-by _lock
        # chunked=True: the flush callable accepts (dict, chunks) and
        # add_chunk is available — the columnar wire path queues whole
        # column slices in O(1) instead of per-item dict merges, and
        # the flush thread does the per-key work off the serving path.
        self._chunked = chunked
        self._items: Dict[K, V] = {}  # guberlint: guarded-by _lock
        self._chunks: list = []  # guberlint: guarded-by _lock
        self._chunk_count = 0  # guberlint: guarded-by _lock
        # Arrival of the oldest queued item.
        self._oldest_ts = 0.0  # guberlint: guarded-by _lock
        self._lock = threading.Lock()
        # Flush ORDERING without blocking producers: each snapshot
        # takes a turn number under the queue lock; flushes then run
        # strictly in turn order, coordinated on a separate condition
        # so add()/add_many()/add_chunk() never wait on an in-flight
        # flush (a later flush_now snapshot broadcasting before an
        # older batcher snapshot would regress peer caches).
        self._turn_cv = threading.Condition(threading.Lock())
        # Next turn number to hand out.
        self._next_turn = 0  # guberlint: guarded-by _turn_cv
        # Turns fully flushed (ordered mode).
        self._done_turn = 0  # guberlint: guarded-by _turn_cv
        # In-flight turns (pooled mode).
        self._active_turns: set = set()  # guberlint: guarded-by _turn_cv
        self._cv = threading.Condition(self._lock)
        self._space = threading.Condition(self._lock)  # drain freed room
        self._closing = False  # guberlint: guarded-by _lock
        # flush_workers > 0: flushes hop to a bounded pool so the NEXT
        # window opens while this flush's RPCs are still in flight —
        # the batching cadence overlaps the network instead of
        # serializing behind it (the pipelined GLOBAL flush).
        # Only valid for commutative flushes
        # (hit sums); supersedable traffic needs delivery order and
        # keeps flush_workers=0.
        self._flush_pool = None
        self._flush_slots = None
        if flush_workers > 0:
            from concurrent.futures import ThreadPoolExecutor

            self._flush_pool = ThreadPoolExecutor(
                max_workers=flush_workers,
                thread_name_prefix=f"{name}-flush",
            )
            self._flush_slots = threading.Semaphore(flush_workers)
        self._thread = threading.Thread(target=self._run, name=name, daemon=True)
        self._thread.start()

    def _admit_locked(self, incoming: int) -> bool:
        """Enforce max_pending before enqueueing `incoming` items
        (caller holds the lock).  Returns False when closing."""
        if self._closing:
            return False
        if self._max_pending is None:
            return True
        if self._overflow == "block":
            # Admit only when the WHOLE batch fits (a 1000-item chunk
            # must not slip past the cap through one free slot) — but
            # an oversized batch is always admitted into an empty
            # queue, or it could never be admitted at all.  Held
            # (deferred-retry) items occupy pending space: the memory
            # bound covers the retry backlog too.
            while not self._closing:
                pending = (
                    len(self._items) + self._chunk_count
                    + self._held_count_locked()
                )
                if pending == 0 or pending + incoming <= self._max_pending:
                    break
                self._space.wait(timeout=1.0)
            return not self._closing
        # drop_oldest: shed whole chunks first (cheap), then items.
        shed_chunks = False
        while (
            len(self._items) + self._chunk_count + incoming
            > self._max_pending
            and self._chunks
        ):
            _, cnt, _ts = self._chunks.pop(0)
            self._chunk_count -= cnt
            self.dropped += cnt
            shed_chunks = True
        while (
            len(self._items) + self._chunk_count + incoming
            > self._max_pending
            and self._items
        ):
            self._items.pop(next(iter(self._items)))
            self.dropped += 1
        if shed_chunks:
            # Re-anchor the backlog age on the oldest SURVIVING chunk —
            # keeping the shed items' arrival time overstated the gauge
            # for as long as the overload lasted.  With
            # only dict items left the old anchor stands (per-key
            # arrival is untracked; overestimating is the safe
            # direction for an overload gauge).
            if self._chunks:
                self._oldest_ts = self._chunks[0][2]
            elif not self._items:
                self._oldest_ts = time.monotonic()
        return True

    def add(self, key: K, item) -> None:
        with self._lock:
            if not self._admit_locked(1):
                return
            if not self._items and not self._chunks:
                self._oldest_ts = time.monotonic()
            self._items[key] = self._combine(self._items.get(key), item)
            self._cv.notify()

    def pending(self) -> int:
        """Items currently queued for the next flush, INCLUDING held
        deferred-retry batches (metrics gauge)."""
        with self._lock:
            return (
                len(self._items) + self._chunk_count
                + self._held_count_locked()
            )

    def backlog_age(self) -> float:
        """Seconds since the oldest still-queued item arrived (metrics
        gauge: a healthy batcher keeps this near sync_wait; growth
        means flushes cannot keep up with enqueues).  Held retry
        batches count with their ORIGINAL enqueue time — the failure
        episode they carry is exactly what this gauge exists to
        expose."""
        with self._lock:
            oldest = None
            if self._items or self._chunks:
                oldest = self._oldest_ts
            for _due, _pairs, held_oldest in self._held:
                if held_oldest and (oldest is None or held_oldest < oldest):
                    oldest = held_oldest
            if oldest is None:
                return 0.0
            return time.monotonic() - oldest

    def _held_count_locked(self) -> int:  # guberlint: holds _lock
        return sum(len(pairs) for _due, pairs, _ts in self._held)

    def _promote_held_locked(self, force: bool = False):
        """Move held batches whose due time arrived (all of them when
        `force`) into the live queue; returns the earliest remaining
        due time, or None when nothing is held.  Caller holds the
        lock."""  # guberlint: holds _lock
        if not self._held:
            return None
        now = time.monotonic()
        keep = []
        earliest = None
        for due, pairs, oldest_ts in self._held:
            if not force and due > now:
                keep.append((due, pairs, oldest_ts))
                if earliest is None or due < earliest:
                    earliest = due
                continue
            if not self._items and not self._chunks:
                self._oldest_ts = oldest_ts if oldest_ts else now
            elif oldest_ts and oldest_ts < self._oldest_ts:
                self._oldest_ts = oldest_ts
            items = self._items
            combine = self._combine
            for key, item in pairs:
                items[key] = combine(items.get(key), item)
        self._held = keep
        return earliest

    def current_wait(self) -> float:
        """The wait the next window will use (sync_wait when the
        batcher is non-adaptive) — metrics gauge + tests."""
        if self._adaptive is None:
            return self.sync_wait
        # Under the queue lock: AdaptiveWait state is owned by the
        # batcher thread's drain (observe() runs under _lock), so an
        # unlocked scrape could read mid-update EWMA state.
        with self._lock:
            return self._adaptive.next_wait()

    def add_many(self, pairs) -> None:
        """Batch enqueue under ONE lock acquisition — a 1000-item wire
        batch must not pay 1000 lock round-trips."""
        pairs = list(pairs)  # admission control needs the real count
        with self._lock:
            if not self._admit_locked(len(pairs)):
                return
            if not self._items and not self._chunks:
                self._oldest_ts = time.monotonic()
            items = self._items
            combine = self._combine
            for key, item in pairs:
                items[key] = combine(items.get(key), item)
            self._cv.notify()

    def requeue_many(
        self,
        pairs,
        oldest_ts: float | None = None,
        delay: float = 0.0,
    ) -> int:
        """Re-enqueue failed-flush items WITHOUT blocking: flush
        threads must never wait on producer admission (a blocked flush
        worker is exactly the stall the health plane exists to
        prevent).  Items that don't fit under max_pending are dropped
        and counted; returns the number admitted.  `oldest_ts` is the
        items' ORIGINAL first-enqueue time: re-queued items already
        waited at least one window, and re-anchoring backlog age at
        now() would hide exactly the failure-episode backlog the gauge
        exists to expose.

        `delay` > 0 defers re-admission: the batch is HELD invisible
        to the drain until `delay` seconds pass (the capped-backoff
        retry cycle toward a broken peer — re-admitting immediately
        would spin the loop against an open circuit, and sleeping on
        the flush worker would stall healthy traffic).  The loop's
        idle wait is bounded by the earliest held due time, so the
        retry fires on schedule even with zero fresh traffic."""
        pairs = list(pairs)
        admitted = 0
        with self._lock:
            if self._closing:
                return 0
            if delay > 0:
                if self._max_pending is not None:
                    space = self._max_pending - (
                        len(self._items) + self._chunk_count
                        + self._held_count_locked()
                    )
                    if space < len(pairs):
                        self.dropped += len(pairs) - max(0, space)
                        pairs = pairs[: max(0, space)]
                if not pairs:
                    return 0
                self._held.append(
                    (time.monotonic() + delay, pairs, oldest_ts or 0.0)
                )
                # Wake the loop so its idle wait re-arms with the new
                # due time (a plain cv.wait() would sleep past it).
                self._cv.notify()
                return len(pairs)
            if not self._items and not self._chunks:
                self._oldest_ts = (
                    oldest_ts if oldest_ts else time.monotonic()
                )
            elif oldest_ts and oldest_ts < self._oldest_ts:
                self._oldest_ts = oldest_ts
            items = self._items
            combine = self._combine
            for key, item in pairs:
                if (
                    self._max_pending is not None
                    and len(items) + self._chunk_count >= self._max_pending
                    and key not in items
                ):
                    self.dropped += 1
                    continue
                items[key] = combine(items.get(key), item)
                admitted += 1
            if admitted:
                self._cv.notify()
        return admitted

    def add_chunk(self, chunk, count: int) -> None:
        """Queue one columnar chunk (O(1): stores references only).
        Requires chunked=True."""
        assert self._chunked
        with self._lock:
            if not self._admit_locked(count):
                return
            if not self._items and not self._chunks:
                self._oldest_ts = time.monotonic()
            self._chunks.append((chunk, count, time.monotonic()))
            self._chunk_count += count
            self._cv.notify()

    def _run(self) -> None:
        while True:
            if self._flush_slots is not None:
                # Reserve a flush slot BEFORE draining: when the pool
                # is saturated the queue keeps absorbing (bounded by
                # max_pending) instead of a drained snapshot sitting in
                # a handoff limbo the gauges can't see.
                self._flush_slots.acquire()
            with self._lock:
                while True:
                    # Promote due held retries first (forced on close:
                    # the final drain must deliver-or-fail the whole
                    # retry backlog, not strand it); an undue backlog
                    # bounds the idle wait so retries fire on schedule
                    # without fresh traffic.
                    earliest = self._promote_held_locked(
                        force=self._closing
                    )
                    if self._items or self._chunks or self._closing:
                        break
                    if earliest is None:
                        self._cv.wait()
                    else:
                        self._cv.wait(
                            max(0.0, earliest - time.monotonic())
                        )
                if self._closing and not self._items and not self._chunks:
                    if self._flush_slots is not None:
                        self._flush_slots.release()
                    return
                wait = (
                    self._adaptive.next_wait()
                    if self._adaptive is not None
                    else self.sync_wait
                )
                deadline = time.monotonic() + wait
                while (
                    len(self._items) + self._chunk_count < self.batch_limit
                    and not self._closing
                ):
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    self._cv.wait(remaining)
                drained_oldest = self._oldest_ts
                batch, chunks = self._drain_locked()
                turn = self._take_turn()
            if self._flush_pool is not None:
                self._flush_pool.submit(
                    self._flush_pooled, turn, batch, chunks, drained_oldest
                )
                continue
            try:
                self._flush_in_turn(turn, batch, chunks, drained_oldest)
            except Exception:  # noqa: BLE001 — loop must survive flush errors
                import logging

                from gubernator_tpu_torch.utils.metrics import record_swallowed

                record_swallowed("batcher.flush")
                logging.getLogger("gubernator_tpu_torch").exception(
                    "batcher flush failed"
                )

    def _drain_locked(self, limit: int | None = -1):
        """Take up to `drain_limit` queued items (caller holds the
        lock).  Returns (items_dict, chunk_list).  limit=None forces a
        full drain (flush_now / tests)."""
        from_loop = limit == -1
        if limit == -1:
            limit = self._drain_limit
        # item_drain_limit applies only to the loop's cycles; an
        # explicit flush_now/close drain (limit=None from the caller)
        # takes everything.
        item_cap = self._item_drain_limit if from_loop else None
        if (
            limit is None
            and item_cap is not None
            and len(self._items) > item_cap
        ):
            # Full chunk drain (vectorized flush) but a BOUNDED dict
            # drain: dict items cost per-key Python in the flush, so
            # an unbounded dict backlog would be the §15 monster
            # flush all over again.
            taken = 0
            batch: Dict[K, V] = {}
            for k in list(self._items.keys()):
                if taken >= item_cap:
                    break
                batch[k] = self._items.pop(k)
                taken += 1
            pairs, self._chunks = self._chunks, []
            drained = taken + self._chunk_count
            self._chunk_count = 0
            if self._adaptive is not None:
                self._adaptive.observe(drained)
            if self._wait_stat is not None:
                self._wait_stat.observe(
                    max(0.0, time.monotonic() - self._oldest_ts)
                )
            # Dict items remain and per-key arrival is untracked: the
            # old anchor stands (overestimating age is the safe
            # direction for an overload gauge).
            self._space.notify_all()
            return batch, [c for c, _, _ in pairs]
        drained = len(self._items) + self._chunk_count
        if limit is None or drained <= limit:
            if self._adaptive is not None:
                self._adaptive.observe(drained)
            if self._wait_stat is not None and drained:
                self._wait_stat.observe(
                    max(0.0, time.monotonic() - self._oldest_ts)
                )
            batch, self._items = self._items, {}
            pairs, self._chunks = self._chunks, []
            self._chunk_count = 0
            self._space.notify_all()
            return batch, [c for c, _, _ in pairs]
        if self._adaptive is not None:
            self._adaptive.observe(limit)
        if self._wait_stat is not None:
            self._wait_stat.observe(
                max(0.0, time.monotonic() - self._oldest_ts)
            )
        taken = 0
        batch: Dict[K, V] = {}
        # CPython dicts iterate in insertion order: oldest keys first.
        for k in list(self._items.keys()):
            if taken >= limit:
                break
            batch[k] = self._items.pop(k)
            taken += 1
        chunks = []
        while self._chunks and taken < limit:
            ch, cnt, _ts = self._chunks.pop(0)
            chunks.append(ch)
            self._chunk_count -= cnt
            taken += cnt
        # Re-anchor the backlog age on the oldest REMAINING chunk's
        # real arrival time — resetting to now() here made the gauge
        # read "healthy" through the exact sustained overload it
        # exists to expose.  With only dict items left the old anchor
        # stands (per-key arrival is untracked; overestimating age is
        # the safe direction for an overload gauge).
        if self._chunks:
            self._oldest_ts = self._chunks[0][2]
        elif not self._items:
            self._oldest_ts = time.monotonic()
        self._space.notify_all()
        return batch, chunks

    def _take_turn(self) -> int:
        """Reserve the next flush turn.  Caller holds the queue lock —
        the snapshot and its turn number are taken atomically."""
        with self._turn_cv:
            turn = self._next_turn
            self._next_turn += 1
            if self._flush_pool is not None:
                self._active_turns.add(turn)
        return turn

    def _flush_in_turn(
        self, turn: int, batch, chunks, drained_oldest: float = 0.0
    ) -> None:
        """Run the flush when (and only when) its turn comes up, so
        snapshot order == delivery order; always advances the turn."""
        with self._turn_cv:
            while self._done_turn != turn:
                self._turn_cv.wait()
        try:
            self._flush_batch(batch, chunks, drained_oldest)
        finally:
            with self._turn_cv:
                self._done_turn = turn + 1
                self._turn_cv.notify_all()

    def _flush_pooled(
        self, turn: int, batch, chunks, drained_oldest: float
    ) -> None:
        """Pool-mode flush: runs CONCURRENTLY with other flushes (no
        turn wait — only commutative flushes use the pool); completion
        is tracked per turn so flush_now can wait out older snapshots."""
        try:
            self._flush_batch(batch, chunks, drained_oldest)
        except Exception:  # noqa: BLE001 — pool must survive flush errors
            import logging

            from gubernator_tpu_torch.utils.metrics import record_swallowed

            record_swallowed("batcher.flush_pooled")
            logging.getLogger("gubernator_tpu_torch").exception(
                "batcher flush failed"
            )
        finally:
            self._flush_slots.release()
            with self._turn_cv:
                self._active_turns.discard(turn)
                self._turn_cv.notify_all()

    def _flush_batch(self, batch, chunks, drained_oldest: float) -> None:
        if batch or chunks:
            if self._chunked:
                self._flush(batch, chunks)
            else:
                self._flush(batch)
            if self._age_stat is not None and drained_oldest:
                # Enqueue→delivered age of the snapshot's oldest item:
                # the stage a consumer of this batcher actually waits
                # (broadcast age in the GLOBAL budget).
                self._age_stat.observe(
                    max(0.0, time.monotonic() - drained_oldest)
                )

    def flush_now(self, force_held: bool = False) -> None:
        """Flush everything queued immediately, on the caller's thread
        (operational drains + deterministic tests).  Returns only after
        every OLDER snapshot's flush AND this drain complete; producers
        never wait on flush execution.  `force_held=True` also promotes
        not-yet-due held retry batches into this drain (convergence
        probes after a heal: deliver the backlog NOW instead of waiting
        out the backoff)."""
        with self._lock:
            self._promote_held_locked(force=force_held)
            drained_oldest = self._oldest_ts
            batch, chunks = self._drain_locked(limit=None)
            turn = self._take_turn()
        if self._flush_pool is None:
            self._flush_in_turn(turn, batch, chunks, drained_oldest)
            return
        try:
            self._flush_batch(batch, chunks, drained_oldest)
        finally:
            with self._turn_cv:
                self._active_turns.discard(turn)
                self._turn_cv.notify_all()
                # Older concurrent flushes may still be in flight;
                # everything enqueued before this call is either in
                # our snapshot or in one of them.
                while any(t < turn for t in self._active_turns):
                    self._turn_cv.wait()

    def close(self, timeout: float = 5.0) -> None:
        """Stop, flushing anything still queued."""
        with self._lock:
            if self._closing:
                return
            self._closing = True
            self._cv.notify_all()
            self._space.notify_all()
        self._thread.join(timeout)
        if self._flush_pool is not None:
            self._flush_pool.shutdown(wait=True)
