"""Host-tier decision ledger: answer hot-key checks without a device launch.

Port of `gubernator_tpu/core/ledger.py` (the reference's default,
GUBER_LEDGER=1).  Every decision on the plain columnar path costs an
engine call and a kernel launch, even the 1500th hit on one hot key in
one second.  Token-bucket algebra makes most of those launches
unnecessary, exactly:

* **Sticky over-limit** — a token bucket whose stored status is
  OVER_LIMIT with remaining == 0 cannot change before its recorded reset
  passes, as long as every request carries the same limit and duration
  and no precondition-breaking flag.  The ledger answers those hits
  itself — (OVER_LIMIT, limit, 0, reset) — until the reset.  The engine's
  application of the same request would be a state no-op with the same
  answer.

* **Credit leases** — when a token key's hit count in a 1 s window
  crosses the hot threshold, the serving tier appends an *acquisition
  row* (hits = a bounded credit) to its next engine batch.  An
  UNDER_LIMIT answer means the credit is debited on the device and held
  here; later hits drain it on the host with the collapsed step's closed
  form (`ops/bucket_kernel.py token_extras_host`), answering remaining
  and reset as the sequential engine would.  Every precondition-breaking
  request (RESET_REMAINING, Gregorian, a limit or duration change,
  negative hits, leaky buckets, over-asks, exhaustion, TTL expiry)
  revokes the lease: the *unused* credit rides back as a negative-hit
  *return row* prepended to the same engine batch, so the engine
  computes on exactly the sequential state.  Admitted hits are debited
  up front, so racing consumers are never over-admitted; the exposure is
  bounded under-admission (the outstanding lease credit per key).  Idle
  leases settle back through a background flusher off the serving path.

Exactness: with all traffic through ledger-aware paths (the h2 front's
columnar serve, and the dataclass path through `invalidate_keys`),
answers are bit-equal to the sequential engine
(tests/test_torch_ledger.py holds them to `models/spec.py` and to the
reference's ledger over the JAX engine).

Left for the cluster tier (ROADMAP A item 11): `attach_readonly` and
`readonly_overlay` (the GLOBAL broadcast cache that only peers fill) and
`remote_install` / `remote_pull` (replica-held leases).  The hot-key
sketch credit of native drains waits for item 13.

Knobs (config.py): GUBER_LEDGER, GUBER_LEDGER_LEASE, GUBER_LEDGER_LEASE_TTL,
GUBER_LEDGER_HOT_THRESHOLD, GUBER_LEDGER_KEYS, GUBER_LEDGER_SETTLE_INTERVAL.

Threads: the settle flusher calls `apply_columnar` from its own thread,
like the h2 front's dispatch thread, on the device's default stream; the
engine's lock orders the two.  Lock order: ledger lock → plane mutex
(core/native_plane.py); the C side never calls back out.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import OrderedDict
from typing import Dict, List, Optional

import numpy as np

from gubernator_tpu_torch.net.wire_codec import gather_key_slices
from gubernator_tpu_torch.ops.bucket_kernel import token_extras_host
from gubernator_tpu_torch.types import Algorithm, Behavior, Status
from gubernator_tpu_torch.utils.metrics import DurationStat, record_swallowed

log = logging.getLogger("gubernator_tpu_torch.ledger")

_TOKEN = int(Algorithm.TOKEN_BUCKET)
_OVER = int(Status.OVER_LIMIT)
_UNDER = int(Status.UNDER_LIMIT)
# Flags that break the ledger's preconditions outright.  GLOBAL /
# NO_BATCHING / BATCHING do not change the bucket update itself.
_BREAKERS = int(Behavior.DURATION_IS_GREGORIAN) | int(Behavior.RESET_REMAINING)
# A key is hot after `hot_threshold` eligible hits within this window.
_HOT_WINDOW_MS = 1000

# Entry kinds.  _K_OVER/_K_LEASE are the protocol with the native
# decision plane: dp_pull returns csrc/decision_plane.cpp's kOver/kLease
# and the branches below compare against these
# (tests/test_torch_native_plane.py pins the two tiers equal).
_K_COUNTER = 0
_K_OVER = 1
_K_LEASE = 2
# Lease delegated to the native decision plane (core/native_plane.py):
# the C table is the ONLY drain point until a Python-path touch pulls
# it back — the fields on the Python entry are the grant-time shadow
# (limit/duration/reset/expiry stay authoritative; consumed is stale
# until the pull refreshes it).  Exactly one tier can drain at a time,
# so delegation can never over-admit.
_K_NATIVE = 3

# Settle/return record: (key, hits, limit, duration, fnv1a, t_mono,
# reset).  hits < 0 returns unused lease credit; the `reset` bound
# drops records whose bucket window already ended (a return landing on
# a FRESH bucket would overfill it).
_ACQ_INFLIGHT_TIMEOUT_S = 2.0


class _Entry:
    """One tracked key: hit-rate counter, sticky-OVER record, or lease."""

    __slots__ = (
        "key", "kind", "count", "win_start", "want",
        "limit", "duration", "reset", "rem", "credit", "consumed",
        "expiry", "gen", "rem_hint", "acq_inflight",
    )

    def __init__(self, key: bytes, now_ms: int):
        self.key = key
        self.kind = _K_COUNTER
        self.count = 0
        self.win_start = now_ms
        self.want = False
        self.limit = 0
        self.duration = 0
        self.reset = 0
        # Lease state: `rem` is the LOGICAL remaining at grant time
        # (device remaining + held credit); answers report
        # rem - consumed, exactly what the sequential engine would.
        self.rem = 0
        self.credit = 0
        self.consumed = 0
        self.expiry = 0
        # Apply generation: bumped whenever a plan sends this key's
        # rows to the engine.  Sticky-OVER inserts and rem_hint updates
        # require gen equality between plan and learn — a racing row
        # would otherwise install stale observations.
        self.gen = 0
        # Last engine-confirmed remaining (acquisition sizing); -1 =
        # unknown.
        self.rem_hint = -1
        # time.monotonic() of an acquisition row in flight (0 = none):
        # prevents concurrent plans from double-debiting the key.
        self.acq_inflight = 0.0


class _Lane:
    """Engine-lane columns (settle/return rows + fall-through rows +
    acquisition rows) shaped like a DecodedBatch so the group-commit
    windows and apply_columnar can consume it unchanged."""

    __slots__ = (
        "n", "key_buf", "key_offsets", "algo", "behavior", "hits",
        "limit", "duration", "burst", "fnv1a",
    )


def concat_lanes(a, b) -> _Lane:
    """Concatenate two DecodedBatch/_Lane column sets (a first)."""
    out = _Lane()
    out.n = a.n + b.n
    out.key_buf = np.concatenate([a.key_buf, b.key_buf])
    off = np.concatenate(
        [a.key_offsets, b.key_offsets[1:] + a.key_offsets[-1]]
    )
    out.key_offsets = off
    for f in ("algo", "behavior", "hits", "limit", "duration", "burst",
              "fnv1a"):
        setattr(out, f, np.concatenate([getattr(a, f), getattr(b, f)]))
    return out


def _rows_lane(rows: List[tuple]) -> Optional[_Lane]:
    """Build a lane from settle/return/acquisition records
    [(key, hits, limit, duration, fnv1a, ...)]."""
    if not rows:
        return None
    keys = [r[0] for r in rows]
    m = len(keys)
    lane = _Lane()
    lane.n = m
    lane.key_buf = np.frombuffer(b"".join(keys), dtype=np.uint8).copy()
    off = np.zeros(m + 1, dtype=np.int64)
    np.cumsum([len(k) for k in keys], out=off[1:])
    lane.key_offsets = off
    lane.algo = np.zeros(m, dtype=np.int32)
    lane.behavior = np.zeros(m, dtype=np.int32)
    lane.hits = np.asarray([r[1] for r in rows], dtype=np.int64)
    lane.limit = np.asarray([r[2] for r in rows], dtype=np.int64)
    lane.duration = np.asarray([r[3] for r in rows], dtype=np.int64)
    lane.burst = np.zeros(m, dtype=np.int64)
    lane.fnv1a = np.asarray([r[4] for r in rows], dtype=np.uint64)
    return lane


class LedgerPlan:
    """One batch's partition: locally-answered rows, return/settle rows
    to prepend, the fall-through rows the engine must still decide, and
    lease-acquisition rows to append.

    Lifecycle: `plan()` → (caller dispatches the engine lane) →
    `learn()` with the lane outputs in [settles..., fall...,
    acquires...] order — or `rollback()` if the dispatch path failed
    and the caller re-serves through another path.
    """

    __slots__ = (
        "ledger", "dec", "now_ms", "hashes", "fell_whole",
        "answered_rows", "ans_st", "ans_rem", "ans_rst",
        "fall", "fall_elig", "fall_dur_ok", "settles", "acquires", "gens",
        "_batch_hits", "_acq_candidates", "_consumed_log", "_done",
    )

    def __init__(self, ledger, dec, now_ms):
        self.ledger = ledger
        self.dec = dec
        self.now_ms = now_ms
        # The rows' fnv1a as Python ints, for learn.
        self.hashes: List[int] = np.asarray(dec.fnv1a).tolist()
        # Every row fell through with nothing else to do
        # (DecisionLedger._fall_whole_batch).
        self.fell_whole = False
        self.answered_rows: List[int] = []
        self.ans_st: List[int] = []
        self.ans_rem: List[int] = []
        self.ans_rst: List[int] = []
        self.fall: List[int] = []
        self.fall_elig: List[bool] = []
        # Per fall row: the row's duration matched the entry's last
        # engine-observed duration.  Sticky-OVER inserts require it —
        # a duration change can RENEW an expired bucket, where the
        # engine's (OVER, remaining=0) response is a pre-renewal
        # snapshot while the stored remaining silently became `limit`
        # (models/spec.py:173-185, reference algorithms.go:131-162);
        # an insert from that response would answer OVER until the new
        # reset on a bucket that is actually full.
        self.fall_dur_ok: List[bool] = []
        # Return/settle records (see module constant note).
        self.settles: List[tuple] = []
        # Acquisition records (key, hits>0, limit, duration, fnv1a).
        self.acquires: List[tuple] = []
        # hash → entry generation at THIS plan's last touch.
        self.gens: Dict[int, int] = {}
        # hash → engine-bound hits this batch (acquisition sizing).
        self._batch_hits: Dict[int, int] = {}
        self._acq_candidates: List[int] = []
        self._consumed_log: List[tuple] = []  # (hash, delta)
        self._done = False

    # -- shape ---------------------------------------------------------

    @property
    def full(self) -> bool:
        return not self.fall and not self.settles and not self.acquires

    @property
    def n_settles(self) -> int:
        return len(self.settles)

    @property
    def n_acquires(self) -> int:
        return len(self.acquires)

    @property
    def answered_idx(self) -> np.ndarray:
        return np.asarray(self.answered_rows, dtype=np.int64)

    @property
    def fall_idx(self) -> np.ndarray:
        return np.asarray(self.fall, dtype=np.int64)

    def answered_cols(self):
        """(status, remaining, reset) aligned to answered_idx; limit is
        the request limit (the engine echoes it too)."""
        return (
            np.asarray(self.ans_st, dtype=np.int32),
            np.asarray(self.ans_rem, dtype=np.int64),
            np.asarray(self.ans_rst, dtype=np.int64),
        )

    def dense_cols(self):
        """Full-length (status, limit, remaining, reset) in row order —
        only valid when `full` (every considered row answered)."""
        dec = self.dec
        n = dec.n
        st = np.zeros(n, dtype=np.int32)
        lim = np.asarray(dec.limit, dtype=np.int64).copy()
        rem = np.zeros(n, dtype=np.int64)
        rst = np.zeros(n, dtype=np.int64)
        rows = self.answered_idx
        a_st, a_rem, a_rst = self.answered_cols()
        st[rows] = a_st
        rem[rows] = a_rem
        rst[rows] = a_rst
        return st, lim, rem, rst

    # -- engine lane ---------------------------------------------------

    def settle_lane(self) -> Optional[_Lane]:
        return _rows_lane(self.settles)

    def acq_lane(self) -> Optional[_Lane]:
        return _rows_lane(self.acquires)

    def build_engine_lane(self):
        """Columns the engine must run: settle/return rows first, then
        the fall-through rows, then acquisition rows.  Returns the
        original dec unchanged when the plan changed nothing."""
        dec = self.dec
        if (
            not self.settles
            and not self.acquires
            and len(self.fall) == dec.n
        ):
            return dec
        fall = self.fall_idx
        lane = _Lane()
        lane.n = len(fall)
        offs = dec.key_offsets
        lens = offs[1:] - offs[:-1]
        lane.key_buf, lane.key_offsets = gather_key_slices(
            dec.key_buf, offs[:-1][fall], lens[fall]
        )
        for f in ("algo", "behavior", "hits", "limit", "duration",
                  "burst", "fnv1a"):
            setattr(
                lane, f, np.ascontiguousarray(np.asarray(getattr(dec, f))[fall])
            )
        s = self.settle_lane()
        if s is not None:
            lane = concat_lanes(s, lane)
        a = self.acq_lane()
        if a is not None:
            lane = concat_lanes(lane, a)
        return lane

    def merge_outputs(self, st, rem, rst):
        """Scatter the engine-lane outputs (in [settles..., fall...,
        acquires...] order) and the locally-answered rows into dense
        full-length (status, limit, remaining, reset) columns in row
        order — the one reassembly shared by every ledger-aware front
        (the slicing/learn-order contract must not fork per caller).
        Limit is the request limit (the engine echoes it too)."""
        dec = self.dec
        n = dec.n
        ns = self.n_settles
        nf = len(self.fall)
        status = np.zeros(n, dtype=np.int64)
        limit = np.asarray(dec.limit, dtype=np.int64).copy()
        remaining = np.zeros(n, dtype=np.int64)
        reset = np.zeros(n, dtype=np.int64)
        fall = self.fall_idx
        status[fall] = np.asarray(st)[ns:ns + nf]
        remaining[fall] = np.asarray(rem)[ns:ns + nf]
        reset[fall] = np.asarray(rst)[ns:ns + nf]
        aidx = self.answered_idx
        if len(aidx):
            a_st, a_rem, a_rst = self.answered_cols()
            status[aidx] = a_st
            remaining[aidx] = a_rem
            reset[aidx] = a_rst
        return status, limit, remaining, reset

    # -- post-dispatch -------------------------------------------------

    def learn(self, st, lim, rem, rst) -> None:
        """Absorb the engine outputs for the WHOLE engine lane, in
        [settles..., fall (fall_idx order)..., acquires...] order:
        return/settle accounting, rem_hint refreshes, sticky-OVER
        inserts, and lease grants from acquisition responses."""
        if self._done:
            return
        self._done = True
        self.ledger._learn(self, st, lim, rem, rst)

    def rollback(self) -> None:
        """Undo this plan's ledger mutations — the caller's dispatch
        path failed and the whole RPC will be re-served elsewhere (the
        pb fallback), so locally-consumed credits must be restored,
        revoked returns re-queued for the async flusher, and in-flight
        acquisition marks cleared (the debit never happened)."""
        if self._done:
            return
        self._done = True
        led = self.ledger
        with led._lock:
            for h, delta in self._consumed_log:
                e = led._items.get(h)
                if (
                    e is not None
                    and e.kind == _K_NATIVE
                    and led._native is not None
                ):
                    # Re-delegated during this plan: pull back before
                    # undoing the local drain.
                    led._undelegate_locked(e)
                if e is not None and e.kind == _K_LEASE:
                    e.consumed -= delta
            for s in self.settles:
                led._pending[s[4]] = s
                # Back in the pending queue: the _pending guard covers
                # sticky inserts from here on.
                led._returning.discard(s[4])
            for a in self.acquires:
                e = led._items.get(a[4])
                if e is not None:
                    e.acq_inflight = 0.0
            led.answered -= len(self.answered_rows)
            led.fallthrough -= len(self.fall)


class DecisionLedger:
    """Host-side decision ledger over one engine (see module docstring)."""

    def __init__(
        self,
        engine,
        *,
        lease_size: int = 512,
        lease_ttl: float = 0.2,
        hot_threshold: int = 8,
        max_keys: int = 65536,
        settle_interval: float = 0.05,
    ):
        self.engine = engine
        self.lease_size = max(1, lease_size)
        self.lease_ttl_ms = max(1, int(lease_ttl * 1000))
        self.hot_threshold = max(1, hot_threshold)
        self.max_keys = max_keys
        self._items: "OrderedDict[int, _Entry]" = OrderedDict()  # guarded by _lock
        # OVER/LEASE entries indexed by key bytes — the dataclass-path
        # invalidation hook must be O(1) per key with zero hashing.
        self._key_index: Dict[bytes, int] = {}  # guarded by _lock
        # Revoked-but-unapplied returns keyed by fnv1a: a plan for the
        # same key pulls its return into the synchronous batch; the
        # flusher drains the rest.
        self._pending: Dict[int, tuple] = {}  # guarded by _lock
        # Hashes whose credit return is IN FLIGHT on the engine (the
        # async settle apply runs outside this lock): a sticky-OVER
        # insert for such a key would capture the device's PRE-return
        # (OVER, remaining=0) snapshot and then answer OVER until the
        # reset while the returned credit sits unservable — the
        # small-hot-bucket starvation (tests/test_torch_ledger.py's canary).
        self._returning: set = set()  # guarded by _lock
        self._lock = threading.Lock()
        # Counters (exported via utils.metrics + bench artifacts).
        # _Entry fields ride the same lock: entries are only reachable
        # through _items, and every traversal holds it.
        self.answered = 0  # guarded by _lock
        self.fallthrough = 0  # guarded by _lock
        self.leases_granted = 0  # guarded by _lock
        self.leases_revoked = 0  # guarded by _lock
        self.settles = 0  # guarded by _lock
        self.over_entries = 0  # guarded by _lock
        self.settle_lag = DurationStat()
        # Optional native decision plane (NativeDecisionPlane).  All
        # bridge calls happen under _lock, so the lock order is always
        # ledger lock → plane mutex (the C mutex never calls back out).
        self._native = None  # guarded by _lock
        self._stop = threading.Event()
        self._flusher = None
        if settle_interval > 0:
            self._flusher = threading.Thread(
                target=self._flush_loop,
                args=(settle_interval,),
                name="guber-ledger-settle",
                daemon=True,
            )
            self._flusher.start()

    # ------------------------------------------------------------------

    def attach_native(self, plane) -> None:
        """Attach a native decision plane: future lease grants and
        sticky-OVER inserts are pushed down so hot-key RPCs answer
        inside the C connection threads; Python-path touches pull the
        drained counts back (see _K_NATIVE).  The plane's clock is
        anchored to this engine's clock domain here and on every
        grant.  A plane already attached (a second front on the same
        instance) is detached first: its delegated leases come back
        with their drained counts and its table is emptied, so it
        answers nothing more and no credit is held in two places."""
        with self._lock:
            self._detach_native_locked()
            plane.set_clock_offset(self.engine.clock.now_ms())
            self._native = plane

    def detach_native(self, plane=None) -> None:
        """Pull every delegated lease back to the Python tier and drop
        the plane (front shutdown / GUBER_NATIVE_LEDGER flush); with
        `plane`, only if that plane is the one attached.  The table is
        cleared, so stale OVER copies die with it."""
        with self._lock:
            if plane is None or plane is self._native:
                self._detach_native_locked()

    def _detach_native_locked(self) -> None:
        plane = self._native
        if plane is None:
            return
        for e in self._items.values():
            if e.kind == _K_NATIVE:
                self._undelegate_locked(e)
        self._native = None
        plane.clear()

    def _undelegate_locked(self, e: _Entry) -> None:
        """Pull a delegated lease back: the plane atomically stops
        answering the key and returns the drained count, so every
        native answer is linearized before whatever the caller does
        next (engine lane, revoke, settle)."""
        res = self._native.pull(e.key)
        if res is not None and res[0] == _K_LEASE:
            e.consumed = res[1]
        e.kind = _K_LEASE

    def plan(self, dec, now_ms: int) -> LedgerPlan:
        """Partition one decoded batch: which rows the ledger answers,
        which return rows must precede the engine lane, which rows fall
        through, which acquisition rows to append.  (The reference's
        `idx`, which restricts the plan to a GLOBAL route's owned rows,
        comes with that route, ROADMAP A item 11.)"""
        plan = LedgerPlan(self, dec, now_ms)
        # Column materialization happens OUTSIDE the lock: O(n)
        # conversions under the ledger lock would serialize serving
        # threads behind full-batch work.
        hh = plan.hashes
        algo_a, beh_a = np.asarray(dec.algo), np.asarray(dec.behavior)
        hits_a, lim_a = np.asarray(dec.hits), np.asarray(dec.limit)
        if not ((algo_a == _TOKEN) & ((beh_a & _BREAKERS) == 0) & (hits_a >= 0)
                & (lim_a > 0)).any() and self._fall_whole_batch(plan, hh):
            return plan
        rows = range(dec.n)
        algo_l = algo_a.tolist()
        beh_l = beh_a.tolist()
        hits_l = hits_a.tolist()
        lim_l = lim_a.tolist()
        dur_l = np.asarray(dec.duration).tolist()
        raw = None
        offs = None
        now = now_ms
        answered_rows = plan.answered_rows
        ans_st, ans_rem, ans_rst = plan.ans_st, plan.ans_rem, plan.ans_rst
        # Lease keys this plan answered locally: still-live ones are
        # pushed back down to the native plane at the end (a delegated
        # key pulled up by one mixed RPC must not stay Python-only
        # while hot native traffic keeps arriving for it).
        redelegate: List[int] = []
        with self._lock:
            items = self._items
            for k, row in enumerate(rows):
                h = hh[k]
                elig = (
                    algo_l[k] == _TOKEN
                    and (beh_l[k] & _BREAKERS) == 0
                    and hits_l[k] >= 0
                    and lim_l[k] > 0
                )
                e = items.get(h)
                if e is None:
                    if elig:
                        if raw is None:
                            raw = dec.key_buf.tobytes()
                            offs = np.asarray(dec.key_offsets).tolist()
                        e = _Entry(raw[offs[row]:offs[row + 1]], now)
                        items[h] = e
                        if len(items) > self.max_keys:
                            self._evict_locked()
                        self._bump_locked(e, now)
                    self._fall_locked(plan, row, elig, h, e, hits_l[k], now, lim_l[k], dur_l[k])
                    continue
                items.move_to_end(h)
                if e.kind == _K_COUNTER:
                    if elig:
                        self._bump_locked(e, now)
                    self._fall_locked(plan, row, elig, h, e, hits_l[k], now, lim_l[k], dur_l[k])
                    continue
                # OVER / LEASE: verify the key (hash collisions must
                # never serve another key's state).
                if raw is None:
                    raw = dec.key_buf.tobytes()
                    offs = np.asarray(dec.key_offsets).tolist()
                key = raw[offs[row]:offs[row + 1]]
                if key != e.key:
                    self._fall_locked(plan, row, elig, h, None, 0, now)
                    continue
                if e.kind == _K_NATIVE:
                    # Python-path touch of a delegated key (an RPC the
                    # plane declined, on the window path): pull the
                    # drained count back and continue
                    # as a live Python lease; if it stays answerable it
                    # re-delegates below.
                    self._undelegate_locked(e)
                lapsed = now > e.reset
                mismatch = (
                    not elig
                    or lim_l[k] != e.limit
                    or dur_l[k] != e.duration
                )
                if e.kind == _K_OVER:
                    if lapsed or mismatch:
                        # Reset passed (bucket dead) or the config
                        # changed (the recorded reset no longer binds):
                        # demote and let the engine decide.
                        self._demote_locked(e, h)
                        if elig:
                            self._bump_locked(e, now)
                        self._fall_locked(
                            plan, row, elig, h, e, hits_l[k], now,
                            lim_l[k], dur_l[k],
                        )
                        continue
                    self._bump_locked(e, now)
                    answered_rows.append(row)
                    ans_st.append(_OVER)
                    ans_rem.append(0)
                    ans_rst.append(e.reset)
                    self.answered += 1
                    continue
                # LEASE
                if lapsed:
                    # The bucket window itself ended: the held credit
                    # died with it — returning it would overfill the
                    # NEXT window.
                    self._demote_locked(e, h)
                    self.leases_revoked += 1
                    if elig:
                        self._bump_locked(e, now)
                    self._fall_locked(plan, row, elig, h, e, hits_l[k], now, lim_l[k], dur_l[k])
                    continue
                if mismatch or now > e.expiry:
                    self._revoke_locked(plan, e, h, now)
                    if elig:
                        self._bump_locked(e, now)
                    self._fall_locked(plan, row, elig, h, e, hits_l[k], now, lim_l[k], dur_l[k])
                    continue
                hi = hits_l[k]
                self._bump_locked(e, now)
                if hi == 0:
                    answered_rows.append(row)
                    ans_st.append(_UNDER)
                    ans_rem.append(e.rem - e.consumed)
                    ans_rst.append(e.reset)
                    self.answered += 1
                    redelegate.append(h)
                    continue
                # Drain: same closed form as the collapsed kernel's
                # extras (admitted = clip(avail // h, 0, 1) for one
                # occurrence) applied to the lease's pre-debited credit.
                avail = e.credit - e.consumed
                admitted, _, _ = token_extras_host(avail, hi, 1)
                if admitted:
                    e.consumed += hi
                    # Activity extends the lease: the TTL exists to
                    # reclaim IDLE credit, not to churn a hot key
                    # through revoke/re-acquire cycles — each async
                    # revoke opens a window where a racing hit can
                    # flip the device bucket sticky-OVER while the
                    # unused credit is mid-return, starving a
                    # small-limit bucket until its reset (the
                    # canary's failure shape).
                    e.expiry = now + self.lease_ttl_ms
                    plan._consumed_log.append((h, hi))
                    answered_rows.append(row)
                    ans_st.append(_UNDER)
                    ans_rem.append(e.rem - e.consumed)
                    ans_rst.append(e.reset)
                    self.answered += 1
                    redelegate.append(h)
                else:
                    # Exhausted (or an over-ask): return what we still
                    # hold and let the engine make this call.
                    self._revoke_locked(plan, e, h, now)
                    self._fall_locked(plan, row, elig, h, e, hits_l[k], now, lim_l[k], dur_l[k])
            # Acquisition pass: hot counter keys with a known remaining
            # hint request a lease by appending a credit-debit row.
            t_mono = time.monotonic()
            for h in plan._acq_candidates:
                e = items.get(h)
                if (
                    e is None
                    or e.kind != _K_COUNTER
                    or not e.want
                    or e.rem_hint < 1
                    or h in self._pending
                ):
                    continue
                if (
                    e.acq_inflight
                    and t_mono - e.acq_inflight < _ACQ_INFLIGHT_TIMEOUT_S
                ):
                    continue
                # Size the debit to what remains AFTER this batch's own
                # engine rows — in a serialized history the acquisition
                # then never over-asks, so it cannot perturb state (the
                # engine rejects over-asks without consuming anyway).
                # Take at most HALF of it: between this debit landing
                # and the lease installing, concurrent plans still fall
                # through to the engine, and a near-total debit leaves
                # a sliver racing hits can exhaust — flipping the
                # bucket's stored status sticky-OVER while the credit
                # is in flight, which starves a small-limit bucket
                # until its reset (the flashcrowd canary's failure
                # shape; big buckets are unaffected — lease_size caps
                # first).
                # Credit is carved from engine-confirmed remaining
                # (minus this batch's own in-flight hits), so the sum
                # of live lease slices never exceeds the window limit.
                avail = e.rem_hint - plan._batch_hits.get(h, 0)
                acq = min(self.lease_size, avail // 2)
                if acq < 1:
                    continue
                e.acq_inflight = t_mono
                plan.acquires.append(
                    (e.key, acq, e.limit, e.duration, h)
                )
            if self._native is not None:
                for h in redelegate:
                    e = items.get(h)
                    # Only still-live leases go back down; anything a
                    # later row of this batch revoked/demoted stays up
                    # (its engine lane must run first), and duplicates
                    # no-op on the kind check.
                    if (
                        e is not None
                        and e.kind == _K_LEASE
                        and now <= e.reset
                        and now <= e.expiry
                        and self._native.install_lease(
                            e.key, e.limit, e.duration, e.reset,
                            e.rem, e.credit, e.consumed, e.expiry,
                        )
                    ):
                        e.kind = _K_NATIVE
        return plan

    def _fall_whole_batch(self, plan, hh: List[int]) -> bool:
        """Fall every row of a batch in which no row is eligible (leaky,
        a breaker flag, negative hits, limit 0) and no key has an entry
        or a pending return: the per-row pass would fall each such row
        and do nothing else.  Returns False, having changed nothing,
        when some key has an entry or a pending return."""
        with self._lock:
            if not self._items.keys().isdisjoint(hh) or (
                    self._pending and not self._pending.keys().isdisjoint(hh)):
                return False
            n = len(hh)
            plan.fall = list(range(n))
            plan.fall_elig = [False] * n
            plan.fall_dur_ok = [False] * n
            plan.fell_whole = True
            self.fallthrough += n
        return True

    # -- locked helpers ------------------------------------------------

    def _fall_locked(self, plan, row, elig, h, e, hi, now, lim=0, dur=0) -> None:
        plan.fall.append(row)
        plan.fall_elig.append(elig)
        # Entries reaching a fall are always _K_COUNTER (OVER/LEASE
        # callers demote/revoke first), so e.duration is the last
        # duration an engine row stored for this key; a differing (or
        # never-observed) duration can trigger the renewal corner —
        # see the fall_dur_ok note above.
        plan.fall_dur_ok.append(
            e is not None and elig and e.duration == dur
        )
        self.fallthrough += 1
        if e is not None:
            e.gen += 1
            plan.gens[h] = e.gen
            if elig:
                if e.kind == _K_COUNTER:
                    if e.limit != lim or e.duration != dur:
                        # Config change invalidates the remaining hint
                        # (a limit delta folds into remaining) — defer
                        # acquisitions until a fresh engine response.
                        e.rem_hint = -1
                    e.limit = lim
                    e.duration = dur
                plan._batch_hits[h] = plan._batch_hits.get(h, 0) + hi
                if e.want and e.kind == _K_COUNTER:
                    plan._acq_candidates.append(h)
            else:
                # A precondition-breaking row reaches the engine: the
                # post-row remaining is unknowable here.
                e.rem_hint = -1
        # Pull this key's pending return (if any) into the synchronous
        # batch so the engine sees the reconciled state for this
        # request; drop it if its bucket window already ended.  The
        # key is marked returning until this plan's learn: a racing
        # plan's fall must not sticky-insert off the pre-return state.
        s = self._pending.pop(h, None)
        if s is not None and now <= s[6]:
            plan.settles.append(s)
            self._returning.add(h)

    def _bump_locked(self, e: _Entry, now: int) -> None:
        if now - e.win_start > _HOT_WINDOW_MS:
            # Cooled: the hot flag decays with the window, or a
            # once-hot key would churn acquire/expire/return cycles
            # forever on trickle traffic.
            e.count = 0
            e.win_start = now
            e.want = False
        e.count += 1
        if e.count >= self.hot_threshold:
            e.want = True

    def _demote_locked(self, e: _Entry, h: int) -> None:
        if self._native is not None and e.kind in (_K_OVER, _K_NATIVE):
            # Drop the plane's copy so it cannot keep answering a
            # demoted record.  Lease callers pull (undelegate) BEFORE
            # demoting — reaching here as _K_NATIVE is the defensive
            # path and forfeits only unused credit (under-admission).
            self._native.pull(e.key)
        self._key_index.pop(e.key, None)
        e.kind = _K_COUNTER

    def _revoke_locked(self, plan, e: _Entry, h: int, now: int) -> None:
        """Revoke a live lease: consumed credit is already on the
        device; the UNUSED remainder rides back as a negative-hit
        return row in this plan's engine lane."""
        unused = e.credit - e.consumed
        if unused > 0:
            plan.settles.append(
                (e.key, -unused, e.limit, e.duration, h,
                 time.monotonic(), e.reset)
            )
            self._returning.add(h)
        # The next acquisition sizes off the post-revoke remaining.
        e.rem_hint = e.rem - e.consumed
        self.leases_revoked += 1
        self._demote_locked(e, h)

    def _evict_locked(self) -> None:
        h, e = self._items.popitem(last=False)
        if self._native is not None and e.kind == _K_NATIVE:
            # Delegated keys are answered in C, so they never
            # move_to_end and age toward this LRU edge even while hot:
            # pull the exact drained count before settling.
            self._undelegate_locked(e)
        elif self._native is not None and e.kind == _K_OVER:
            self._native.pull(e.key)
        if e.kind == _K_LEASE:
            unused = e.credit - e.consumed
            if unused > 0:
                # The held credit must flow back to the device.
                self._pending[h] = (
                    e.key, -unused, e.limit, e.duration, h,
                    time.monotonic(), e.reset,
                )
            self.leases_revoked += 1
        self._key_index.pop(e.key, None)

    # -- learn (post-dispatch) -----------------------------------------

    def _learn(self, plan: LedgerPlan, st, lim, rem, rst) -> None:
        ns = plan.n_settles
        nf = len(plan.fall)
        hh = plan.hashes
        fall_h = hh if nf == len(hh) else [hh[r] for r in plan.fall]
        # A batch that fell whole has nothing to learn unless a racing
        # plan has since made an entry for one of its keys: it converts
        # the outputs only then (under the lock, a rare case).
        cols = None if plan.fell_whole else [np.asarray(c).tolist() for c in (st, rem, rst)]
        with self._lock:
            items = self._items
            # Returns (negative hits) always land — the engine's
            # consume branch adds them back unconditionally.  Each
            # applied return also clears its in-flight mark and
            # demotes any sticky-OVER a racing plan installed off the
            # pre-return snapshot (the recorded OVER no longer binds).
            for s in plan.settles:
                self.settles += 1
                self.settle_lag.observe(time.monotonic() - s[5])
                hs = s[4]
                self._returning.discard(hs)
                es = items.get(hs)
                if es is not None and es.key == s[0]:
                    # The applied return invalidates every snapshot a
                    # concurrent plan took of this key BEFORE it landed
                    # (same reasoning as flush_settles' bump): a learn
                    # racing in later with a pre-return (OVER, 0) must
                    # fail its freshness check, or it re-installs the
                    # starvation this loop's demote just prevented.
                    es.gen += 1
                    if hs in plan.gens:
                        # THIS plan's engine row ran after its own
                        # prepended settles — its observation is
                        # post-return, so its snapshot stays fresh.
                        plan.gens[hs] = es.gen
                    if es.kind == _K_OVER:
                        self._demote_locked(es, hs)
            dec = plan.dec
            lim_a = np.asarray(dec.limit)
            dur_a = np.asarray(dec.duration)
            raw = None
            offs = None
            now = plan.now_ms
            written: set = set()
            # Only a row whose key has an entry learns anything: the
            # pass is skipped when no fall row's key has one.
            fall = () if items.keys().isdisjoint(fall_h) else plan.fall
            if cols is None:
                if not fall:
                    return
                cols = [np.asarray(c).tolist() for c in (st, rem, rst)]
            st_l, rem_l, rst_l = cols
            for j, row in enumerate(fall):
                h = fall_h[j]
                e = items.get(h)
                if e is None:
                    continue
                if e.kind != _K_COUNTER and h not in written:
                    # A racing plan already promoted this key; its view
                    # is at least as fresh — keep it.  (Keys THIS learn
                    # wrote are overwritten by later rows of the same
                    # batch: the last row's response is the stored
                    # state.)
                    continue
                if raw is None:
                    raw = dec.key_buf.tobytes()
                    offs = np.asarray(dec.key_offsets).tolist()
                key = raw[offs[row]:offs[row + 1]]
                if key != e.key:
                    continue
                fresh = plan.gens.get(h) == e.gen
                if not plan.fall_elig[j]:
                    # A precondition-breaking row (leaky, reset,
                    # negative hits) ran on the engine AFTER anything
                    # this learn recorded: the recorded state is stale.
                    self._demote_locked(e, h)
                    e.rem_hint = -1
                    written.add(h)
                    continue
                s_i = st_l[ns + j]
                r_i = rem_l[ns + j]
                written.add(h)
                if fresh:
                    # Engine-confirmed remaining for acquisition
                    # sizing.  ONLY an UNDER response may arm it: an
                    # OVER response with remaining>0 means the stored
                    # status is sticky OVER (limit raised on an
                    # over-limit bucket), where an acquisition row
                    # would CONSUME its hits while reporting OVER —
                    # learn would read that as "not debited" and the
                    # credit would be silently lost.
                    e.rem_hint = r_i if s_i == _UNDER else -1
                if s_i == _OVER and r_i == 0:
                    if not fresh:
                        # A plan raced in after us (possibly a config
                        # change): our OVER observation may describe a
                        # replaced bucket — insert nothing.
                        continue
                    if h in self._pending or h in self._returning:
                        # A revoked lease's unused credit is queued or
                        # mid-apply for this key: the (OVER, 0) we saw
                        # is the pre-return snapshot, not a sticky
                        # state — inserting it would starve the bucket
                        # until its reset.
                        continue
                    if not plan.fall_dur_ok[j]:
                        # Duration changed (or first observation): the
                        # (OVER, 0) response may be the pre-renewal
                        # snapshot of a bucket whose stored remaining
                        # just became `limit` — not a sticky state.
                        continue
                    # Stored status is OVER with remaining 0 (see the
                    # module docstring's case analysis): exact until
                    # the reset passes.
                    if e.kind != _K_OVER:
                        self.over_entries += 1
                    e.kind = _K_OVER
                    e.limit = int(lim_a[row])
                    e.duration = int(dur_a[row])
                    e.reset = rst_l[ns + j]
                    self._key_index[key] = h
                    if self._native is not None:
                        # Sticky OVER is read-only until the reset, so
                        # the plane may hold a COPY (both tiers answer
                        # it); the demote pulls it.
                        self._native.install_over(
                            key, e.limit, e.duration, e.reset
                        )
                elif e.kind != _K_COUNTER:
                    # The last row's response fits no fast path (e.g.
                    # OVER with remaining>0 after a limit raise):
                    # whatever this learn wrote earlier is stale.
                    self._demote_locked(e, h)
            # Acquisition responses: UNDER means the credit is debited
            # on the device and the lease is live.
            for i, a in enumerate(plan.acquires):
                j = ns + nf + i
                h = a[4]
                e = items.get(h)
                debited = st_l[j] == _UNDER
                if e is None or e.key != a[0] or e.kind != _K_COUNTER:
                    # Entry evicted or re-promoted by a racer: nobody
                    # holds this credit — send it straight back.
                    if debited:
                        self._pending.setdefault(
                            h,
                            (a[0], -a[1], a[2], a[3], h,
                             time.monotonic(), rst_l[j]),
                        )
                    continue
                e.acq_inflight = 0.0
                if not debited:
                    # Rejected (raced below the ask) — or, in the
                    # sticky-OVER corner, consumed-while-reporting-OVER
                    # (ambiguous from the response alone): disarm
                    # acquisitions until a fresh UNDER fall-row
                    # response proves the stored status is UNDER.
                    e.rem_hint = -1
                    continue
                e.kind = _K_LEASE
                e.limit = a[2]
                e.duration = a[3]
                e.reset = rst_l[j]
                e.rem = rem_l[j] + a[1]  # logical remaining at grant
                e.credit = a[1]
                e.consumed = 0
                e.expiry = now + self.lease_ttl_ms
                e.rem_hint = rem_l[j]
                self._key_index[e.key] = h
                self.leases_granted += 1
                if self._native is not None:
                    # Delegate the fresh lease: the plane becomes the
                    # sole drain point until a Python-path touch pulls
                    # it back.  Re-anchor the clock at every grant so
                    # offset drift stays bounded by one lease TTL.
                    self._native.set_clock_offset(now)
                    if self._native.install_lease(
                        e.key, e.limit, e.duration, e.reset,
                        e.rem, e.credit, 0, e.expiry,
                    ):
                        e.kind = _K_NATIVE

    # -- dataclass-path coherence --------------------------------------

    def invalidate_keys(self, keys: List[bytes]) -> None:
        """A batch is about to run on the engine OUTSIDE the ledger
        (the dataclass paths): revoke/drop any entry for these keys and
        apply their returns synchronously so the engine computes on the
        reconciled state.  O(1) dict probes per key — keys without
        entries (the overwhelming case) cost one failed lookup."""
        returns: List[tuple] = []
        now = self.engine.clock.now_ms()
        with self._lock:
            for k in keys:
                h = self._key_index.get(k)
                if h is None:
                    continue
                e = self._items.get(h)
                if e is None or e.key != k:
                    continue
                if self._native is not None and e.kind == _K_NATIVE:
                    # The engine is about to run this key outside the
                    # ledger: stop the native drains first, then settle
                    # off the exact pulled count.
                    self._undelegate_locked(e)
                if e.kind == _K_LEASE:
                    unused = e.credit - e.consumed
                    if unused > 0 and now <= e.reset:
                        returns.append(
                            (e.key, -unused, e.limit, e.duration, h,
                             time.monotonic(), e.reset)
                        )
                    self.leases_revoked += 1
                self._demote_locked(e, h)
                e.gen += 1  # the engine is about to run this key
                e.rem_hint = -1
                s = self._pending.pop(h, None)
                if s is not None and now <= s[6]:
                    returns.append(s)
        if returns:
            self._apply_settles(returns)

    # -- background settle ---------------------------------------------

    def _flush_loop(self, interval: float) -> None:
        while not self._stop.wait(interval):
            try:
                self.flush_settles()
            except Exception:  # noqa: BLE001 — settling must not die
                record_swallowed("ledger.settle_flush")
                log.exception("ledger settle flush failed")

    def flush_settles(self) -> int:
        """Return the unused credit of expired/idle leases and drain
        the pending queue via one batched engine apply off the serving
        path; returns rows applied."""
        now = self.engine.clock.now_ms()
        returns: List[tuple] = []
        with self._lock:
            for h in [
                h for h, e in self._items.items()
                if e.kind in (_K_LEASE, _K_NATIVE)
            ]:
                e = self._items[h]
                if now <= e.reset and now <= e.expiry:
                    continue  # live (possibly delegated): leave it
                if self._native is not None and e.kind == _K_NATIVE:
                    # Expired while delegated: pull the exact drained
                    # count before settling the remainder.
                    self._undelegate_locked(e)
                if now > e.reset:
                    # Window over: the held credit died with it.
                    self._demote_locked(e, h)
                    self.leases_revoked += 1
                elif now > e.expiry:
                    unused = e.credit - e.consumed
                    if unused > 0:
                        returns.append(
                            (e.key, -unused, e.limit, e.duration, h,
                             time.monotonic(), e.reset)
                        )
                        e.gen += 1  # return apply races stale learns
                    e.rem_hint = e.rem - e.consumed
                    self._demote_locked(e, h)
                    self.leases_revoked += 1
            for s in self._pending.values():
                if now <= s[6]:
                    returns.append(s)
            self._pending.clear()
        if returns:
            self._apply_settles(returns)
        return len(returns)

    def _apply_settles(self, rows: List[tuple]) -> None:
        engine = self.engine
        # Mark every key's return as in flight so a racing plan's
        # fall-through cannot install a sticky OVER off the device's
        # pre-return snapshot (see _returning above); afterwards,
        # demote any sticky entry that slipped in before the mark —
        # its recorded (OVER, 0) no longer binds.
        with self._lock:
            self._returning.update(s[4] for s in rows)
        try:
            for lo in range(0, len(rows), 4096):
                chunk = rows[lo:lo + 4096]
                m = len(chunk)
                cols = (
                    [s[0] for s in chunk],
                    np.zeros(m, dtype=np.int32),
                    np.zeros(m, dtype=np.int32),
                    np.asarray([s[1] for s in chunk], dtype=np.int64),
                    np.asarray([s[2] for s in chunk], dtype=np.int64),
                    np.asarray([s[3] for s in chunk], dtype=np.int64),
                    np.zeros(m, dtype=np.int64),
                )
                try:
                    # Returns are reconciliation, not decisions: keep
                    # them out of the decision counters.
                    engine.apply_columnar(*cols, count_decisions=False)
                except Exception:  # noqa: BLE001
                    record_swallowed("ledger.return_apply")
                    log.exception(
                        "ledger return apply failed (%d rows)", m
                    )
                    continue
                with self._lock:
                    self.settles += m
                for s in chunk:
                    self.settle_lag.observe(time.monotonic() - s[5])
        finally:
            with self._lock:
                for s in rows:
                    h = s[4]
                    self._returning.discard(h)
                    e = self._items.get(h)
                    if e is not None and e.key == s[0]:
                        # Stale pre-return snapshots must not learn
                        # (see _learn's settle loop / flush_settles).
                        e.gen += 1
                        if e.kind == _K_OVER:
                            self._demote_locked(e, h)

    # ------------------------------------------------------------------

    def stats(self) -> dict:
        with self._lock:
            out = {
                "answered": self.answered,
                "fallthrough": self.fallthrough,
                "leases_granted": self.leases_granted,
                "leases_revoked": self.leases_revoked,
                "settles": self.settles,
                "over_entries": self.over_entries,
                "entries": len(self._items),
                "pending_settles": len(self._pending),
                "settle_lag_ms_mean": round(
                    self.settle_lag.mean() * 1e3, 3
                ),
            }
        with self._lock:
            # Under the lock: detach_native (which precedes the plane's
            # free) also takes it, so the handle stays live across the
            # dp_stats call.
            if self._native is not None:
                # native_answered rides every stats surface (metrics,
                # bench artifacts): decisions the C plane served with
                # zero GIL.
                out.update(self._native.stats())
        return out

    def close(self) -> None:
        self._stop.set()
        if self._flusher is not None:
            self._flusher.join(timeout=2.0)
        self.detach_native()
        self.flush_settles()
