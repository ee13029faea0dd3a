"""ShardedDecisionEngine — bucket state split into shards, on one card.

Port of `gubernator_tpu/parallel/sharded_engine.py` in its single-program
form (`_build_step_single_program` :323, `GUBER_SHARDS_SINGLE_PROGRAM=1`):
the state of `n_shards` shards of `shard_capacity` slots lives on one
device as [n_shards, shard_capacity] (held as one `BucketState` of
[n_shards * shard_capacity] columns, row-major; `state` gives the 2-D
views), each key is routed to shard fnv1a-64(key) % n_shards on the host
(the reference's worker hash ring, gubernator_pool.go:183-187), and each
shard has its own native intern table.  The port has no mesh: `n_shards`
stands for the reference mesh's size (:96-97).

Device programs, as the reference's single-program engine runs them:

* The dataclass path (`get_rate_limits`, :462-724): per-shard rounds,
  one launch a round over every shard — kernel K11 (`ops.sharded_step
  shard_step`, the reference's `jax.vmap(_fused_step_core)`), with the
  round's eviction clears inside it.  A round that restores store items
  runs its clears (K2) and restores (K5) over the flat columns first,
  each shard's slots made global (`sh * shard_capacity + slot`), then
  K11 with no clears.  A hot-key batch collapses per shard: one K12 launch
  a chunk (`shard_collapsed_step`, `jax.vmap(collapsed_fused_one)`).
* The columnar path (`apply_columnar`, :936-1258): the whole host tier in
  one native call (`core.native.multi_schedule`), then, while the global
  slots fit in int32 (`_flat_ok`, :369), the flat executors (:379-412):
  the batch's slots made global and the whole batch run over the flat
  columns as one K1 launch a round (its clears inside) or one K3 launch
  a collapsed chunk, packed with the whole capacity, so padding lanes are
  out of range everywhere.  Past int32, K11 / K12 per shard.
* `sweep` (:727): K13 (`ops.expiry.shard_sweep_windows`) a group of up
  to 16 windows, each the same window of every shard; freed slots go back
  to the tables shard by shard in ascending order, window after window.

`load` / `export_items` / `save` (:1653-1777) decode and re-encode the
whole state on the host, as the reference does; `export_items` yields
shard-major (`np.nonzero` over [n_shards, shard_capacity]), so a saved
npz is the reference's byte for byte.  The shard_map build, the psum
merge (`GUBER_PSUM_MERGE`) and `warmup` are not ported: nothing compiles
here, and the mesh form needs one card a shard.

Requests, batches, rounds and over-limit answers are counted as the
reference counts them; `dispatches_total` counts the port's launches
(K1, K2, K3, K5, K11, K12), `sweep_groups_total` K13's, `sweep_windows_total`
the windows they swept.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from gubernator_tpu_torch.clock import SYSTEM_CLOCK, Clock
from gubernator_tpu_torch.core.engine import (
    PackedKeys,
    PendingColumnar,
    write_through_store,
)
from gubernator_tpu_torch.core.native import (
    NativeInternTable,
    make_intern_table,
    multi_schedule,
)
from gubernator_tpu_torch.core.readback import ReadbackCombiner
from gubernator_tpu_torch.gregorian import (
    GregorianError,
    dt_from_ms,
    gregorian_duration,
    gregorian_expiration,
)
from gubernator_tpu_torch.hashing import fnv1a_64, fnv1a_64_batch, pack_keys
from gubernator_tpu_torch.ops.bucket_kernel import (
    COLLAPSED_IN_ROWS,
    PACKED_IN_ROWS,
    BucketState,
    build_restore_record,
    make_state,
    pack_batch_host,
    pack_collapsed_host,
    pack_restore_host,
    pack_rounds_host,
    pack_state_host,
    pad_size,
    split_rounds,
    unpack_out_host,
    unpack_state_host,
)
from gubernator_tpu_torch.ops.collapsed_step import collapsed_step
from gubernator_tpu_torch.ops.expiry import shard_sweep_windows, windowed_sweep
from gubernator_tpu_torch.ops.fused_step import (
    clear_occupied,
    load_slots,
    multi_fused_step,
    resolve_device,
)
from gubernator_tpu_torch.ops.sharded_step import (
    shard_clear_rows,
    shard_collapsed_step,
    shard_step,
)
from gubernator_tpu_torch.store import (
    LeakyBucketItem,
    TokenBucketItem,
    item_from_record,
    words_from_float,
)
from gubernator_tpu_torch.types import (
    Algorithm,
    Behavior,
    RateLimitReq,
    RateLimitResp,
    Status,
)

_I32 = np.int32
_I64 = np.int64
_GREG = int(Behavior.DURATION_IS_GREGORIAN)
_RESET = int(Behavior.RESET_REMAINING)
_LEAKY = int(Algorithm.LEAKY_BUCKET)
_OVER_I = int(Status.OVER_LIMIT)
_STATUS_OF = {int(st): st for st in Status}


class ShardedDecisionEngine:
    """Decision engine over `n_shards` shards of `shard_capacity` slots
    on one device (total capacity n_shards × shard_capacity)."""

    SWEEP_WINDOW = 1 << 17  # slots a shard per sweep window (reference :725)

    def __init__(
        self,
        shard_capacity: int = 50_000,
        *,
        n_shards: int,
        clock: Clock = SYSTEM_CLOCK,
        max_kernel_width: int = 8192,
        store=None,  # store.Store: write-through hooks
        device=None,
    ):
        if n_shards < 1 or shard_capacity < 1:
            raise ValueError("n_shards and shard_capacity must be positive")
        self.device = resolve_device(device)
        self.store = store
        self.n_shards = n_shards
        self.shard_capacity = shard_capacity
        self.capacity = shard_capacity * n_shards
        self.logical_capacity = self.capacity
        self.clock = clock
        self.max_kernel_width = max_kernel_width
        self.tables = [make_intern_table(shard_capacity) for _ in range(n_shards)]
        # All-native tables take the one-call host tier (multi_schedule);
        # the per-shard loop stays as the plain version (tests clear it).
        self._multi_ok = all(isinstance(t, NativeInternTable) for t in self.tables)
        self._lock = threading.RLock()
        self._sweep_cursor = 0  # next window start of the incremental sweep
        self.requests_total = 0
        self.over_limit_total = 0
        self.batches_total = 0
        self.rounds_total = 0
        # Kernel launches of the serving, store and load paths.
        self.dispatches_total = 0
        self.sweep_windows_total = 0  # sweep windows run
        self.sweep_groups_total = 0  # the groups of up to 16 they ran in: K13 launches
        self.readback = ReadbackCombiner()
        self._state: BucketState = make_state(self.capacity, self.device)
        # The flat executors' padding lanes run up to capacity + width;
        # the int32 slot row caps the flat layout at 2^31 (reference :369).
        self._flat_ok = self.capacity + 2 * self.max_kernel_width < 2**31

    @property
    def state(self) -> BucketState:
        """The live state as [n_shards, shard_capacity] views (read-only
        use: export, comparison)."""
        with self._lock:
            return BucketState(*(c.view(self.n_shards, self.shard_capacity)
                                 for c in self._state))

    # ------------------------------------------------------------------

    def shard_of(self, key: str) -> int:
        return fnv1a_64(key.encode()) % self.n_shards

    def _stage(self, buf: np.ndarray) -> torch.Tensor:
        """A host int32 buffer on the engine's device: one non_blocking
        copy from pinned memory on the card."""
        t = torch.from_numpy(np.ascontiguousarray(buf))
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def _global(self, clears: List[List[int]]) -> np.ndarray:
        """Per-shard slot lists → sorted global slots (sh * shard_capacity
        + slot) of the flat columns."""
        cap = self.shard_capacity
        parts = [np.asarray(c, dtype=_I64) + sh * cap for sh, c in enumerate(clears) if len(c)]
        if not parts:
            return np.zeros(0, dtype=_I32)
        return np.sort(np.concatenate(parts)).astype(_I32)

    def _apply_shard_clears(self, clears: List[List[int]]) -> None:
        """Eviction clears as one K2 launch over the flat columns (reference
        :419): `clears[sh]` lists the slots to scrub on shard sh, made
        global; the padding (`capacity + i`) is out of range."""
        g = self._global(clears)
        if not len(g):
            return
        c = np.arange(self.capacity, self.capacity + pad_size(len(g), floor=16),
                      dtype=_I64).astype(_I32)
        c[: len(g)] = g
        clear_occupied(self._state.meta, self._stage(c))
        self.dispatches_total += 1

    def _apply_shard_restores(self, restores: List[List[tuple]]) -> None:
        """Hydrate store items into fresh slots on every shard: one record
        of global slots, one K5 launch (reference :438).
        reference: algorithms.go:46-54."""
        cap = self.shard_capacity
        flat = [(sh * cap + slot, item) for sh, r in enumerate(restores) for slot, item in r]
        rec = pack_restore_host(build_restore_record(flat, self.capacity))
        load_slots(self._state, self._stage(rec))
        self.dispatches_total += 1

    def get_rate_limits(
        self, requests: Sequence[RateLimitReq], now_ms: Optional[int] = None
    ) -> List[RateLimitResp]:
        if now_ms is None:
            now_ms = self.clock.now_ms()
        n = len(requests)
        if n == 0:
            return []
        responses: List[Optional[RateLimitResp]] = [None] * n
        now_dt = None
        greg_dur = np.zeros(n, dtype=_I64)
        greg_exp = np.zeros(n, dtype=_I64)
        valid: List[int] = []
        for i, r in enumerate(requests):
            if int(r.behavior) & _GREG:
                if now_dt is None:
                    # Civil time from the kernel's own `now`.
                    now_dt = dt_from_ms(now_ms)
                try:
                    greg_dur[i] = gregorian_duration(now_dt, r.duration)
                    greg_exp[i] = gregorian_expiration(now_dt, r.duration)
                except GregorianError as e:
                    responses[i] = RateLimitResp(error=str(e))
                    continue
            valid.append(i)

        with self._lock:
            self._apply(requests, valid, greg_dur, greg_exp, now_ms, responses)
            self.requests_total += n
            self.batches_total += 1
        return responses  # type: ignore[return-value]

    def _apply(self, requests, valid, greg_dur, greg_exp, now_ms, responses) -> None:
        """The dataclass path (reference :496): route, intern and schedule
        rounds per shard key by key, then collapse or run the rounds."""
        if not valid:
            return
        n_sh = self.n_shards
        seqs: List[Dict[int, int]] = [dict() for _ in range(n_sh)]
        rounds: Dict[int, List[List[Tuple[int, int]]]] = {}
        clear_rounds: Dict[int, List[List[int]]] = {}
        restore_rounds: Dict[int, List[List[tuple]]] = {}
        for i in valid:
            key = requests[i].hash_key()
            sh = self.shard_of(key)
            is_new = self.store is not None and not self.tables[sh].contains(key)
            evicted: List[int] = []
            slot = self.tables[sh].intern(key, now_ms, evicted)
            for es in evicted:
                k = seqs[sh].get(es, 0)
                clear_rounds.setdefault(k, [[] for _ in range(n_sh)])[sh].append(es)
            k = seqs[sh].get(slot, 0)
            seqs[sh][slot] = k + 1
            rounds.setdefault(k, [[] for _ in range(n_sh)])[sh].append((i, slot))
            if is_new:
                # Read-through (reference: algorithms.go:46-54).
                item = self.store.get(requests[i])
                if item is not None and item.value is not None:
                    restore_rounds.setdefault(k, [[] for _ in range(n_sh)])[sh].append(
                        (slot, item))

        expire_of: Dict[int, int] = {}
        if (
            self.store is None
            and len(rounds) > 1
            and self._collapse_dataclass_sharded(
                requests, valid, rounds, clear_rounds, greg_dur, greg_exp, now_ms, responses,
            )
        ):
            return
        for k in sorted(set(rounds) | set(clear_rounds)):
            members = rounds.get(k, [[] for _ in range(n_sh)])
            clears = clear_rounds.get(k, [[] for _ in range(n_sh)])
            restores = restore_rounds.get(k)
            # Wide rounds are cut into chunks of max_kernel_width lanes.
            offset = 0
            while True:
                chunk = [m[offset : offset + self.max_kernel_width] for m in members]
                if not any(chunk) and offset > 0:
                    break
                self._run_round(
                    chunk, clears if offset == 0 else [[] for _ in range(n_sh)],
                    greg_dur, greg_exp, now_ms, requests, responses,
                    restores=restores if offset == 0 else None, expire_of=expire_of,
                )
                self.rounds_total += 1
                offset += self.max_kernel_width
                if all(offset >= len(m) for m in members):
                    break

        if self.store is not None:
            write_through_store(self.store, requests, valid, greg_dur, now_ms, responses,
                                expire_of)

    def _run_round(self, members, clears, greg_dur, greg_exp, now_ms, requests, responses,
                   restores=None, expire_of=None) -> None:
        """One round of every shard as one K11 launch (reference :592): a
        [n_sh, 16, width] buffer, each shard's lanes sorted by slot and
        padded with `shard_capacity + lane`; the round's clears ride in the
        launch, unless store items restore into it (clears K2, restores K5,
        then K11 with no clears, the reference's order)."""
        n_sh = self.n_shards
        cap = self.shard_capacity
        width = pad_size(max((len(m) for m in members), default=1))
        if restores is not None and any(restores):
            self._apply_shard_clears(clears)
            self._apply_shard_restores(restores)
            clears = [[] for _ in range(n_sh)]
        buf = np.zeros((n_sh, PACKED_IN_ROWS, width), dtype=_I32)
        order_of: List[np.ndarray] = []
        limits_of: List[np.ndarray] = []
        host_expire: List[Tuple[List[int], List[int]]] = [([], []) for _ in range(n_sh)]
        empty64 = np.empty(0, dtype=_I64)
        for sh in range(n_sh):
            m = len(members[sh])
            if m == 0:
                buf[sh] = pack_batch_host(width, now_ms, cap, np.empty(0, dtype=_I32),
                                          *(empty64,) * 8)
                order_of.append(np.empty(0, dtype=np.int64))
                limits_of.append(empty64)
                continue
            reqs = [requests[i] for i, _ in members[sh]]
            c_slot = np.fromiter((s for _, s in members[sh]), dtype=_I32, count=m)
            idx = np.fromiter((i for i, _ in members[sh]), dtype=_I64, count=m)
            c_beh = np.fromiter((int(r.behavior) for r in reqs), dtype=_I32, count=m)
            c_dur = np.fromiter((r.duration for r in reqs), dtype=_I64, count=m)
            c_limit = np.fromiter((r.limit for r in reqs), dtype=_I64, count=m)
            cols = (np.fromiter((int(r.algorithm) for r in reqs), dtype=_I32, count=m), c_beh,
                    np.fromiter((r.hits for r in reqs), dtype=_I64, count=m), c_limit, c_dur,
                    np.fromiter((r.burst for r in reqs), dtype=_I64, count=m),
                    greg_dur[idx], greg_exp[idx])
            exp = np.where((c_beh & _GREG) != 0, greg_exp[idx], now_ms + c_dur)
            host_expire[sh] = (c_slot, exp)
            if expire_of is not None:
                expire_of.update(zip(idx.tolist(), exp.tolist()))
            sort_idx = np.argsort(c_slot, kind="stable")
            buf[sh] = pack_batch_host(width, now_ms, cap,
                                      np.ascontiguousarray(c_slot[sort_idx]),
                                      *(c[sort_idx] for c in cols))
            order_of.append(sort_idx)
            limits_of.append(c_limit)

        rows = shard_clear_rows(clears, cap)
        flat = self._stage(np.concatenate([buf.ravel(), rows.ravel()]))
        pout = shard_step(self._state, flat[: buf.size].view(buf.shape), cap,
                          flat[buf.size :].view(rows.shape))
        self.dispatches_total += 1

        arr = self.readback.register(pout).fetch()
        for sh in range(n_sh):
            mm = len(members[sh])
            if mm == 0:
                continue
            o_status, o_rem, o_reset = unpack_out_host(arr[sh], mm)
            sort_idx = order_of[sh]
            c_limit = limits_of[sh]
            over = 0
            for pos in range(mm):
                sj = int(sort_idx[pos])
                i = members[sh][sj][0]
                st = int(o_status[pos])
                if st == _OVER_I:
                    over += 1
                responses[i] = RateLimitResp(
                    status=_STATUS_OF[st], limit=int(c_limit[sj]), remaining=int(o_rem[pos]),
                    reset_time=int(o_reset[pos]),
                )
            self.over_limit_total += over
        for sh, (e_slots, e_exps) in enumerate(host_expire):
            if len(e_slots):
                self.tables[sh].set_expiry(np.asarray(e_slots, dtype=_I32),
                                           np.asarray(e_exps, dtype=_I64))

    def sweep(self, now_ms: Optional[int] = None, max_windows: Optional[int] = None) -> int:
        """Reclaim the slots of expired buckets on every shard; returns how
        many were freed (reference :727).  A window is the same slot range
        of every shard, up to 16 windows a K13 launch; a window's freed
        slots go back to the tables shard by shard in ascending order,
        window after window."""
        if now_ms is None:
            now_ms = self.clock.now_ms()
        n_sh = self.n_shards

        def window_fn(meta, hi2, expire_lo, now, starts, window):
            self.sweep_groups_total += 1
            return shard_sweep_windows(meta, hi2, expire_lo, n_sh, now, starts, window)

        def release(freed, start) -> int:
            self.sweep_windows_total += 1
            total = 0
            for sh, f in enumerate(freed):
                if len(f):
                    self.tables[sh].release_slots(f + start)
                    total += len(f)
            return total

        with self._lock:
            return windowed_sweep(self, self.shard_capacity, now_ms, max_windows, release,
                                  window_fn=window_fn, per_shard=True)

    # ------------------------------------------------------------------
    # Columnar path (reference :936): vectorized routing, the native host
    # tier, one launch a round or collapsed chunk, one readback each.

    def apply_columnar(
        self,
        keys,  # List[bytes] or PackedKeys
        algo: np.ndarray,
        behavior: np.ndarray,
        hits: np.ndarray,
        limit: np.ndarray,
        duration: np.ndarray,
        burst: np.ndarray,
        now_ms: Optional[int] = None,
        want_async: bool = False,
        route_hashes: Optional[np.ndarray] = None,  # uint64 fnv1a-64 a key
    ):
        """(status int32, limit int64, remaining int64, reset_time int64)
        in request order, or with want_async=True a PendingColumnar whose
        .get() gives them.  `route_hashes` (the wire decode's `fnv1a`, the
        table's own hash of each key) spare the host tier the hashing.
        Raises with a store attached (use get_rate_limits)."""
        if self.store is not None:
            raise RuntimeError(
                "apply_columnar does not support a write-through Store; use get_rate_limits"
            )
        n = len(keys)
        if now_ms is None:
            now_ms = self.clock.now_ms()
        greg_mask = (behavior & _GREG) != 0
        greg_dur = np.zeros(n, dtype=_I64)
        greg_exp = greg_dur
        if greg_mask.any():
            greg_exp = np.zeros(n, dtype=_I64)
            now_dt = dt_from_ms(now_ms)
            for i in np.nonzero(greg_mask)[0]:
                greg_dur[i] = gregorian_duration(now_dt, int(duration[i]))
                greg_exp[i] = gregorian_expiration(now_dt, int(duration[i]))
        with self._lock:
            pending = self._apply_columnar_locked(
                keys, algo, behavior, hits, limit, duration, burst, greg_dur, greg_exp,
                greg_mask, now_ms, route_hashes,
            )
            self.requests_total += n
            self.batches_total += 1
        return pending if want_async else pending.get()

    def _apply_columnar_locked(self, keys, algo, behavior, hits, limit, duration, burst,
                               greg_dur, greg_exp, greg_mask, now_ms, route_hashes=None):
        n_sh = self.n_shards
        n = len(keys)
        packed = keys if isinstance(keys, PackedKeys) else None
        if self._multi_ok:
            if packed is None:
                # The native call needs only (buf, offsets) and hashes itself.
                packed = PackedKeys.from_list(keys)
                route_hashes = None
            return self._apply_columnar_native(
                packed, algo, behavior, hits, limit, duration, burst, greg_dur, greg_exp,
                greg_mask, now_ms, route_hashes,
            )

        # The plain host tier (reference :1008): one FNV-1a pass for the
        # routes (or the caller's hashes), then a schedule call a shard.
        if route_hashes is not None:
            hashes = np.asarray(route_hashes, dtype=np.uint64)
        else:
            if packed is not None:
                keys, packed = packed.to_list(), None
            hashes = fnv1a_64_batch(*pack_keys(keys))
        shards = (hashes % np.uint64(n_sh)).astype(np.int64)
        shard_idx: List[np.ndarray] = []
        shard_slots: List[np.ndarray] = []
        shard_rounds: List[np.ndarray] = []
        clear_by_round: Dict[int, List[List[int]]] = {}
        max_round = 0
        for sh in range(n_sh):
            idx = np.nonzero(shards == sh)[0]
            shard_idx.append(idx)
            if len(idx) == 0:
                shard_slots.append(np.empty(0, dtype=_I32))
                shard_rounds.append(np.empty(0, dtype=_I32))
                continue
            table = self.tables[sh]
            if packed is not None:
                slots, rounds, evicted, evict_rounds = table.schedule_packed(
                    packed.buf, packed.offsets, now_ms, idx=idx.astype(np.int64))
            else:
                slots, rounds, evicted, evict_rounds = table.schedule(
                    [keys[i] for i in idx], now_ms)
            shard_slots.append(slots)
            shard_rounds.append(rounds)
            if len(rounds):
                max_round = max(max_round, int(rounds.max()))
            for es, k in zip(evicted.tolist(), evict_rounds.tolist()):
                clear_by_round.setdefault(k, [[] for _ in range(n_sh)])[sh].append(es)

        expires = np.where(greg_mask, greg_exp, now_ms + duration).astype(_I64)
        pieces = None
        if max_round > 0:
            pieces = self._try_collapse_sharded(
                shard_idx, shard_slots, clear_by_round, algo, behavior, hits, limit, duration,
                burst, greg_dur, greg_exp, now_ms,
            )
        if pieces is None:
            pieces = []
            for k in range(max_round + 1):
                members = [shard_idx[sh][shard_rounds[sh] == k] for sh in range(n_sh)]
                m_slots = [shard_slots[sh][shard_rounds[sh] == k] for sh in range(n_sh)]
                if not any(len(m) for m in members) and k not in clear_by_round:
                    continue
                self._dispatch_round(members, m_slots, clear_by_round.get(k), pieces, algo,
                                     behavior, hits, limit, duration, burst, greg_dur,
                                     greg_exp, now_ms, presorted=False, flat=False)
        # TTL mirror, per shard.
        for sh in range(n_sh):
            if len(shard_idx[sh]):
                self.tables[sh].set_expiry(shard_slots[sh], expires[shard_idx[sh]])
        return PendingColumnar(self, pieces, limit, n)

    def _apply_columnar_native(self, packed, algo, behavior, hits, limit, duration, burst,
                               greg_dur, greg_exp, greg_mask, now_ms, route_hashes):
        """The whole host tier in one native call (reference :1150):
        routing, each table's interning, LRU, eviction and rounds, the TTL
        mirror and the shard-grouped (slot, round)-sorted order."""
        n_sh = self.n_shards
        n = len(packed.offsets) - 1
        expires = np.where(greg_mask, greg_exp, np.int64(now_ms) + duration).astype(_I64)
        (max_round, shard, slots, rounds, order, counts,
         evicted, evict_shard, evict_rounds) = multi_schedule(
            self.tables, packed.buf, packed.offsets, route_hashes, now_ms, expires,
        )
        flat = self._flat_ok
        if flat:
            # Global slots sh * shard_capacity + slot: the shard-grouped,
            # slot-sorted order is then sorted globally, and the whole batch
            # runs over the flat columns.
            seg_slots = (slots.astype(_I64) + shard.astype(_I64) * self.shard_capacity).astype(_I32)
            segs = [order]
        else:
            bounds = np.zeros(n_sh + 1, dtype=np.int64)
            np.cumsum(counts, out=bounds[1:])
            segs = [order[bounds[sh] : bounds[sh + 1]] for sh in range(n_sh)]
            seg_slots = slots
        clear_by_round: Dict[int, List[List[int]]] = {}
        for s, sh, k in zip(evicted.tolist(), evict_shard.tolist(), evict_rounds.tolist()):
            clear_by_round.setdefault(k, [[] for _ in range(n_sh)])[sh].append(s)

        if max_round > 0:
            per_shard = [(seg, seg_slots[seg]) if len(seg) else None for seg in segs]
            pieces = self._collapse_presorted(
                per_shard, clear_by_round, algo, behavior, hits, limit, duration, burst,
                greg_dur, greg_exp, now_ms, flat=flat,
            )
            if pieces is not None:
                return PendingColumnar(self, pieces, limit, n)

        pieces = []
        for k in range(max_round + 1):
            if max_round == 0:
                members = segs
            else:
                # Filtering a round keeps each shard's slot order.
                members = [seg[rounds[seg] == k] for seg in segs]
            if not any(len(m) for m in members) and k not in clear_by_round:
                continue
            self._dispatch_round(members, [seg_slots[m] for m in members], clear_by_round.get(k),
                                 pieces, algo, behavior, hits, limit, duration, burst, greg_dur,
                                 greg_exp, now_ms, presorted=True, flat=flat)
        return PendingColumnar(self, pieces, limit, n)

    def _dispatch_round(self, members, m_slots, clears, pieces, *cols, presorted, flat) -> None:
        """One round of a columnar batch, cut into chunks of at most
        max_kernel_width lanes a shard, its clears in the first chunk's
        launch (reference :1222-1257)."""
        offset = 0
        while True:
            chunk_members = [m[offset : offset + self.max_kernel_width] for m in members]
            chunk_slots = [s[offset : offset + self.max_kernel_width] for s in m_slots]
            if offset > 0 and not any(len(m) for m in chunk_members):
                break
            piece = self._dispatch_sorted_chunk(
                chunk_members, chunk_slots, *cols, presorted=presorted, flat=flat,
                clears=clears if offset == 0 else None,
            )
            if piece is not None:
                pieces.append(piece)
            self.rounds_total += 1
            offset += self.max_kernel_width
            if all(offset >= len(m) for m in members):
                break

    def _dispatch_sorted_chunk(self, members, m_slots, algo, behavior, hits, limit, duration,
                               burst, greg_dur, greg_exp, now_ms, presorted=False, flat=False,
                               clears=None):
        """Pack one chunk, launch it and start its readback (reference
        :1544); returns a PendingColumnar piece, or None for a chunk with
        no lane.  flat: `members` is one pseudo-shard of global slots, run
        as one K1 round over the flat columns with `clears` (per-shard
        lists) made global; otherwise one K11 launch over [n_sh, 16,
        width], each shard packed with its own capacity and its clears in
        its row."""
        cols = (algo, behavior, hits, limit, duration, burst, greg_dur, greg_exp)
        sorted_members = []
        for m, s in zip(members, m_slots):
            if presorted or len(m) == 0:
                sorted_members.append((m, s))
            else:
                o = np.argsort(s, kind="stable")
                sorted_members.append((m[o], s[o]))
        if flat:
            idx, slots = sorted_members[0]
            g = self._global(clears) if clears is not None else np.zeros(0, dtype=_I32)
            if len(idx) == 0:
                if len(g):
                    self._apply_shard_clears(clears)
                return None
            packed = pack_rounds_host(now_ms, self.capacity, [len(idx)],
                                      np.ascontiguousarray(slots, dtype=_I32),
                                      [c[idx] for c in cols], [g])
            dev = self._stage(packed.buf)
            pout = multi_fused_step(self._state, *split_rounds(dev, packed.pin.shape[1], 1),
                                    widest=packed.widest)
            self.dispatches_total += 1
            return (self.readback.register(pout), idx, packed.lanes, unpack_out_host)

        n_sh = self.n_shards
        cap = self.shard_capacity
        width = pad_size(max((len(m) for m, _ in sorted_members), default=1))
        buf = np.zeros((n_sh, PACKED_IN_ROWS, width), dtype=_I32)
        empty = np.empty(0, dtype=_I64)
        for sh, (idx, slots) in enumerate(sorted_members):
            if len(idx) == 0:
                buf[sh] = pack_batch_host(width, now_ms, cap, np.empty(0, dtype=_I32),
                                          *(empty,) * 8)
            else:
                buf[sh] = pack_batch_host(width, now_ms, cap,
                                          np.ascontiguousarray(slots, dtype=_I32),
                                          *(c[idx] for c in cols))
        rows = shard_clear_rows(clears if clears is not None else [[]] * n_sh, cap)
        dev = self._stage(np.concatenate([buf.ravel(), rows.ravel()]))
        pout = shard_step(self._state, dev[: buf.size].view(buf.shape), cap,
                          dev[buf.size :].view(rows.shape))
        self.dispatches_total += 1
        return (self.readback.register(pout), [m for m, _ in sorted_members],
                [len(m) for m, _ in sorted_members], unpack_out_host)

    # ------------------------------------------------------------------
    # Hot keys: the per-shard collapse (reference :1260-1511).

    def _collapse_dataclass_sharded(self, requests, valid, rounds, clear_rounds, greg_dur,
                                    greg_exp, now_ms, responses) -> bool:
        """Hot-key batches on the dataclass path: columns built once, the
        per-shard collapse (K12).  Returns False for the rounds path."""
        if any(k > 0 for k in clear_rounds):
            return False
        n_sh = self.n_shards
        nv = len(valid)
        pos_of = {i: j for j, i in enumerate(valid)}
        reqs = [requests[i] for i in valid]
        vidx = np.asarray(valid, dtype=np.int64)
        c_beh = np.fromiter((int(r.behavior) for r in reqs), dtype=_I32, count=nv)
        c_dur = np.fromiter((r.duration for r in reqs), dtype=_I64, count=nv)
        c_limit = np.fromiter((r.limit for r in reqs), dtype=_I64, count=nv)
        cols = (np.fromiter((int(r.algorithm) for r in reqs), dtype=_I32, count=nv), c_beh,
                np.fromiter((r.hits for r in reqs), dtype=_I64, count=nv), c_limit, c_dur,
                np.fromiter((r.burst for r in reqs), dtype=_I64, count=nv),
                greg_dur[vidx], greg_exp[vidx])
        expire = np.where((c_beh & _GREG) != 0, cols[7], now_ms + c_dur)

        # Per-shard (column positions, slots) in arrival order.
        shard_idx: List[np.ndarray] = []
        shard_slots: List[np.ndarray] = []
        per_shard: List[List[Tuple[int, int]]] = [[] for _ in range(n_sh)]
        for k in sorted(rounds):
            for sh in range(n_sh):
                per_shard[sh].extend(rounds[k][sh])
        for sh in range(n_sh):
            # Arrival order within a key is the round order; restore the
            # global arrival order by request index.
            items = sorted(per_shard[sh], key=lambda t: pos_of[t[0]])
            shard_idx.append(np.asarray([pos_of[i] for i, _ in items], dtype=np.int64))
            shard_slots.append(np.asarray([s for _, s in items], dtype=_I32))

        pieces = self._try_collapse_sharded(shard_idx, shard_slots, clear_rounds, *cols, now_ms)
        if pieces is None:
            return False
        over = 0
        for ticket, dst_rows, chunk_m, unpack in pieces:
            arr = ticket.fetch()
            for sh in range(n_sh):
                mm = chunk_m[sh]
                if mm == 0:
                    continue
                st, rem, rst = unpack(arr[sh], mm)
                for p, j in enumerate(dst_rows[sh].tolist()):
                    s = int(st[p])
                    if s == _OVER_I:
                        over += 1
                    responses[valid[j]] = RateLimitResp(
                        status=_STATUS_OF[s], limit=int(c_limit[j]), remaining=int(rem[p]),
                        reset_time=int(rst[p]),
                    )
        self.over_limit_total += over
        for sh in range(n_sh):
            if len(shard_idx[sh]):
                self.tables[sh].set_expiry(shard_slots[sh], expire[shard_idx[sh]])
        return True

    def _try_collapse_sharded(self, shard_idx, shard_slots, clear_by_round, algo, behavior,
                              hits, limit, duration, burst, greg_dur, greg_exp, now_ms):
        """Per-shard duplicate-segment collapse over arrival-ordered
        shards; returns pieces, or None for the rounds path."""
        per_shard: List[Optional[tuple]] = []
        for sh in range(self.n_shards):
            idx = shard_idx[sh]
            if len(idx) == 0:
                per_shard.append(None)
                continue
            order = np.argsort(shard_slots[sh], kind="stable")
            per_shard.append((idx[order], shard_slots[sh][order]))
        return self._collapse_presorted(per_shard, clear_by_round, algo, behavior, hits, limit,
                                        duration, burst, greg_dur, greg_exp, now_ms)

    def _collapse_presorted(self, per_shard, clear_by_round, algo, behavior, hits, limit,
                            duration, burst, greg_dur, greg_exp, now_ms, flat=False):
        """Collapse per-shard (request indices, slots) pairs already sorted
        by (slot, arrival); None for the rounds path (non-uniform duplicate
        fields, RESET_REMAINING or leaky negative hits on a duplicate, a
        slot reused within the batch).  flat: one pseudo-shard of global
        slots, each chunk one K3 launch over the flat columns; otherwise
        one K12 launch a chunk over [n_sh, 19, width].  The round-0 clears
        ride in the first chunk's launch."""
        if any(k > 0 for k in clear_by_round):
            return None  # mid-batch slot reuse
        n_sh = 1 if flat else self.n_shards
        cap = self.capacity if flat else self.shard_capacity
        cols = (algo, behavior, hits, limit, duration, burst, greg_dur, greg_exp)
        for p in per_shard:
            if p is None:
                continue
            src, s_slots = p
            _uniq, seg_start, counts = np.unique(s_slots, return_index=True, return_counts=True)
            seg_of = np.repeat(np.arange(len(counts), dtype=np.int64), counts)
            dup = counts[seg_of] > 1
            for col in cols:
                cs = col[src]
                if not np.array_equal(cs[dup], cs[seg_start][seg_of][dup]):
                    return None
            if bool((((behavior[src] & _RESET) != 0) & dup).any()):
                return None
            if bool((((algo[src] == _LEAKY) & (hits[src] < 0)) & dup).any()):
                return None

        clears = clear_by_round.get(0)
        max_lanes = max((len(p[0]) for p in per_shard if p is not None), default=0)
        pieces: List[tuple] = []
        empty64 = np.empty(0, dtype=_I64)
        for lo in range(0, max_lanes, self.max_kernel_width):
            chunk_m = [min(max(len(p[0]) - lo, 0), self.max_kernel_width) if p is not None else 0
                       for p in per_shard]
            width = pad_size(max(chunk_m))
            buf = np.zeros((n_sh, COLLAPSED_IN_ROWS, width), dtype=_I32)
            dst_rows: List[np.ndarray] = []
            for sh in range(n_sh):
                m = chunk_m[sh]
                if m == 0:
                    buf[sh] = pack_collapsed_host(width, now_ms, cap, np.empty(0, dtype=_I32),
                                                  empty64, (empty64,) * 8,
                                                  np.empty(0, dtype=_I32),
                                                  np.empty(0, dtype=_I32))
                    dst_rows.append(np.empty(0, dtype=np.int64))
                    continue
                src, s_slots = per_shard[sh]
                c_src = src[lo : lo + m]
                c_uniq, c_start, c_counts = np.unique(s_slots[lo : lo + m], return_index=True,
                                                      return_counts=True)
                c_seg_of = np.repeat(np.arange(len(c_uniq), dtype=np.int64), c_counts)
                c_pos = np.arange(m, dtype=np.int64) - c_start[c_seg_of]
                buf[sh] = pack_collapsed_host(
                    width, now_ms, cap, np.ascontiguousarray(c_uniq, dtype=_I32),
                    c_counts.astype(np.int64), tuple(col[c_src][c_start] for col in cols),
                    c_seg_of.astype(_I32), c_pos.astype(_I32),
                )
                dst_rows.append(c_src)

            if flat:
                g = self._global(clears) if clears is not None else np.zeros(0, dtype=_I32)
                dev = self._stage(np.concatenate([buf.ravel(), g]))
                pout = collapsed_step(self._state, dev[: buf.size].view(buf.shape[1:]),
                                      dev[buf.size :])
                piece = (self.readback.register(pout), dst_rows[0], np.arange(chunk_m[0]),
                         unpack_out_host)
            else:
                rows = shard_clear_rows(clears if clears is not None else [[]] * n_sh, cap)
                dev = self._stage(np.concatenate([buf.ravel(), rows.ravel()]))
                pout = shard_collapsed_step(self._state, dev[: buf.size].view(buf.shape), cap,
                                            dev[buf.size :].view(rows.shape))
                piece = (self.readback.register(pout), dst_rows, chunk_m, unpack_out_host)
            clears = None
            self.dispatches_total += 1
            self.rounds_total += 1
            pieces.append(piece)
        return pieces

    # ------------------------------------------------------------------
    # Bulk persistence (reference :1653-1777; store.go:69-78 Loader): the
    # whole state decoded on the host once and encoded back once.

    def load(self, loader) -> int:
        """Restore a CacheItem stream into the sharded state; returns how
        many items were restored."""
        now_ms = self.clock.now_ms()
        with self._lock:
            host = {k: np.array(v) for k, v in unpack_state_host(self.state).items()}
            count = 0
            for item in loader.load():
                v = item.value
                if v is None or not item.key:
                    continue
                sh = self.shard_of(item.key)
                cleared: List[int] = []
                slot = self.tables[sh].intern(item.key, now_ms, cleared)
                for es in cleared:
                    host["occupied"][sh, es] = False
                self.tables[sh].set_expiry(np.asarray([slot], dtype=_I32),
                                           np.asarray([item.expire_at], dtype=_I64))
                host["occupied"][sh, slot] = True
                host["algo"][sh, slot] = int(item.algorithm)
                host["limit"][sh, slot] = v.limit
                host["duration"][sh, slot] = v.duration
                host["expire"][sh, slot] = item.expire_at
                host["invalid"][sh, slot] = item.invalid_at
                if isinstance(v, TokenBucketItem):
                    host["status"][sh, slot] = v.status
                    host["remaining"][sh, slot] = v.remaining
                    host["remf_hi"][sh, slot] = 0
                    host["remf_lo"][sh, slot] = 0
                    host["t0"][sh, slot] = v.created_at
                    host["burst"][sh, slot] = 0
                elif isinstance(v, LeakyBucketItem):
                    host["status"][sh, slot] = 0
                    w = (v.remaining_words if v.remaining_words is not None
                         else words_from_float(v.remaining))
                    host["remf_hi"][sh, slot] = w[0]
                    host["remf_lo"][sh, slot] = np.uint32(w[1])
                    host["t0"][sh, slot] = v.updated_at
                    host["burst"][sh, slot] = v.burst
                count += 1
            words = pack_state_host(host)
            for name, col in zip(BucketState._fields, self._state):
                a = np.ascontiguousarray(words[name]).reshape(-1)
                col.copy_(torch.from_numpy(a.view(_I32) if a.dtype == np.uint32 else a))
        return count

    def export_items(self):
        """Full-fidelity snapshot of every live bucket as CacheItems, shard
        by shard (the state decoded on the host once)."""
        with self._lock:
            u = unpack_state_host(self.state)
            located = [(sh, int(sl), self.tables[sh].key_for_slot(int(sl)))
                       for sh, sl in zip(*np.nonzero(u["occupied"]))]
        for sh, sl, key in located:
            if key is None:
                continue
            yield item_from_record(
                key=key,
                algorithm=int(u["algo"][sh, sl]),
                status=int(u["status"][sh, sl]),
                limit=int(u["limit"][sh, sl]),
                remaining=int(u["remaining"][sh, sl]),
                remf_hi=int(u["remf_hi"][sh, sl]),
                remf_lo=int(u["remf_lo"][sh, sl]),
                duration=int(u["duration"][sh, sl]),
                t0=int(u["t0"][sh, sl]),
                expire_at=int(u["expire"][sh, sl]),
                burst=int(u["burst"][sh, sl]),
                invalid_at=int(u["invalid"][sh, sl]),
            )

    def save(self, loader) -> None:
        loader.save(self.export_items())

    def cache_size(self) -> int:
        return sum(len(t) for t in self.tables)

    def close(self) -> None:
        """Release the device state."""
        with self._lock:
            self._state = None  # type: ignore[assignment]
