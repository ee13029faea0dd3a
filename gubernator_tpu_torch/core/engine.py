"""DecisionEngine — the local rate-limit execution engine, on PyTorch.

Port of `gubernator_tpu/core/engine.py:322 DecisionEngine`:

  host: one native `schedule` call per batch (core/native.py) interns
        the keys, assigns rounds and eviction clears; the host packs
  device: one kernel launch per batch, its output read back
          asynchronously (core/readback.py)

Per-key serialization is kept by splitting a batch into rounds: request
i goes to round k if it is the k-th occurrence of its key within the
batch, so each round sees a slot at most once and duplicate keys apply
in arrival order.  Eviction clears belong to the round whose slot
sequence they precede.  A batch then takes one of three device paths,
as in the reference:

* **Collapse** (`_try_collapse`): a batch with duplicate keys whose
  occurrences all carry the same fields runs as one collapsed segment
  buffer per `max_kernel_width` chunk — kernel K3, one full application
  per key and a closed form for its repeats, exact sequential semantics.
  Non-uniform duplicates, RESET_REMAINING or leaky negative hits on a
  duplicate, and a slot reused within the batch fall back to rounds.
* **Uniform rounds**: a columnar batch with one limit config across it
  (`_uniform_params`) packs only the slot per lane
  (`pack_uniform_rounds_host`) and runs through kernel K4.
* **Rounds**: every other batch packs all its rounds, their lane
  offsets and their clears into one buffer (`pack_rounds_host`; each
  round sorted by slot, padded to 32 lanes, a round wider than
  `max_kernel_width` split into sub-rounds) and runs through kernel K1.

The rounds and uniform paths submit their buffer to the step pump
(core/pump.py).  With queueing on (the card's default, GUBER_PUMP) it
joins queued batches into one launch; with it off it launches each
batch as it is submitted.
`apply_columnar(..., want_async=True)` returns a `PendingColumnar` whose
`.get()` waits for the batch's output.  `get_rate_limits` runs the same
decision path (`_apply`) without the uniform format, as the reference's
dataclass path does.

Persistence and expiry (reference :212, :266, :770-:803, :914,
:1401-:1500):

* **Store** (`store=`): `get_rate_limits` takes the reference's per-key
  path: `contains` / `intern` per key, a per-slot sequence for rounds
  and eviction clears, and `store.get` for every new key.  A round with
  restores runs as its clears (kernel K2), its restores (kernel K5,
  `_apply_restores`), then its apply (K1, with no clears), the order the
  reference keeps; the rounds between such rounds still go through the
  pump.  No collapse, and `apply_columnar` raises.  After the answers,
  `write_through_store` calls `on_change` for every touched key
  (`remove` first on RESET_REMAINING).
* **Loader**: `load` interns and restores items in batches of at most
  4096 (K2 for evictions, K5 for the items), `export_items` decodes the
  whole state on the host, `save` streams it to a loader
  (`checkpoint.NpzFileLoader` is the file form).
* **Sweep**: `sweep` frees expired slots a `SWEEP_WINDOW` at a time from
  a cursor, up to 16 windows a launch of kernel K6 (`ops/expiry.py`),
  and hands them back to the intern table in ascending order, window
  after window.

Each of them runs what the pump holds first.  `now_ms` flows in from the
caller or the injected Clock.

The split arm (GUBER_FUSED=split, reference :398-450, its A/B control):
no pump and no uniform format; each round runs as its clears (one K2
launch, then K5 for a restoring round), then a launch of K14
(`ops.split_step.packed_compute`, the update with no state write)
and one of K15 (`scatter_store`, its words written at the slots) a
`max_kernel_width` chunk; a collapsed batch as its clears' launch, then
K16 (`collapsed_compute`) and K15 a chunk.  Both entry points, the store
path and paged state take it alike.

Paged state (GUBER_PAGED; core/paging.py; reference :349-372): the
engine's `capacity` argument becomes `logical_capacity`, the intern
table's size, and `capacity` the device's, the resident frames' rows:
the state, the padding lanes `capacity + lane` of every packer and the
sweep use it.  A batch with more unique keys than frames is cut into
arrival-order segments (`_segments_by_unique_keys`).  Right after
`schedule`, `paging.translate` faults the batch's pages in and gives
device rows; the intern table keeps the logical slots (`set_expiry`).
An eviction clear of a cold page drops the occupied bit in the host
store; a resident one goes to the device as its row, inside the round
buffers as always (`_device_clears`).  Restores into cold pages write
the host store (`_apply_restores`), the sweep frees cold expired rows
from the host words after the device windows, and `export_items` reads
cold pages from the host store: none of them faults a page in.

Threads: the kernels launch on the calling thread's current stream, and
PyTorch's current stream is the device's default stream in every thread
unless a caller sets another, so the serving threads (the gateway's) and
the daemon's sweep thread queue on one stream, in the order the engine
lock gives them (`chip_smoke.py` checks that the sweep thread's stream is
the serving one).
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from gubernator_tpu_torch.clock import SYSTEM_CLOCK, Clock
from gubernator_tpu_torch.config import (
    env_fused,
    env_page_size,
    env_paged,
    env_paged_resident,
    env_pump,
)
from gubernator_tpu_torch.core.native import make_intern_table
from gubernator_tpu_torch.core.paging import PagePlane
from gubernator_tpu_torch.core.pump import StepPump
from gubernator_tpu_torch.core.readback import ReadbackCombiner
from gubernator_tpu_torch.gregorian import (
    GregorianError,
    dt_from_ms,
    gregorian_duration,
    gregorian_expiration,
)
from gubernator_tpu_torch.ops.bucket_kernel import (
    ROUND_ALIGN,
    UNIFORM_IN_ROWS,
    BucketState,
    build_restore_record,
    make_state,
    pack_collapsed_host,
    pack_restore_host,
    pack_rounds_host,
    pack_uniform_rounds_host,
    pad_size,
    unpack_out_host,
    unpack_state_host,
    unpack_uniform_out_host,
)
from gubernator_tpu_torch.ops.collapsed_step import collapsed_step
from gubernator_tpu_torch.ops.expiry import sweep_windows, windowed_sweep
from gubernator_tpu_torch.ops.fused_step import (
    clear_occupied,
    load_slots,
    multi_fused_step,
    multi_uniform_step,
    resolve_device,
)
from gubernator_tpu_torch.ops.split_step import collapsed_compute, packed_compute, scatter_store
from gubernator_tpu_torch.store import (
    CacheItem,
    LeakyBucketItem,
    TokenBucketItem,
    item_from_record,
)
from gubernator_tpu_torch.utils.metrics import DurationStat
from gubernator_tpu_torch.utils.tracing import span
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
_TOKEN = int(Algorithm.TOKEN_BUCKET)
_OVER_I = int(Status.OVER_LIMIT)
_STATUS_OF = {int(s): s for s in Status}


def _aligned(n: int) -> int:
    return -(-n // ROUND_ALIGN) * ROUND_ALIGN


def _segments_by_unique_keys(keys: List, budget: int) -> List[tuple]:
    """Cut a batch into contiguous arrival-order segments of at most
    `budget` unique keys each (paged state: unique pages <= unique keys,
    so each segment's pages fit the frames); returns [(lo, hi)] ranges
    covering the batch (reference :83)."""
    segs: List[tuple] = []
    lo = 0
    seen: set = set()
    for i, k in enumerate(keys):
        if k not in seen:
            if len(seen) >= budget:
                segs.append((lo, i))
                lo = i
                seen = set()
            seen.add(k)
    segs.append((lo, len(keys)))
    return segs


class PackedKeys:
    """Keys as one concatenated byte buffer + offsets (reference
    :119), consumed by the native table's `schedule_packed` without a
    Python object per key."""

    __slots__ = ("buf", "offsets", "count")

    def __init__(self, buf: np.ndarray, offsets: np.ndarray, count: int):
        self.buf = buf
        self.offsets = offsets
        self.count = count

    def __len__(self) -> int:
        return self.count

    def to_list(self) -> List[bytes]:
        raw = self.buf.tobytes()
        off = self.offsets
        return [raw[off[i] : off[i + 1]] for i in range(self.count)]

    @classmethod
    def from_list(cls, keys: List[bytes]) -> "PackedKeys":
        """Concatenate a key list (an empty batch keeps a valid one-byte
        buffer for the native callee)."""
        n = len(keys)
        buf = b"".join(keys)
        offsets = np.zeros(n + 1, dtype=np.int64)
        np.cumsum([len(k) for k in keys], out=offsets[1:])
        buf_arr = np.frombuffer(buf, dtype=np.uint8) if buf else np.zeros(1, np.uint8)
        return cls(buf_arr, offsets, n)


class PendingColumnar:
    """A batch whose launches are made or queued and whose outputs are on
    their way home.  `.get()` returns (status int32, limit int64,
    remaining int64, reset_time int64) in request order (reference
    :154).  Each piece is (ticket, request indices, output lanes,
    unpack); the over-limit counter moves when the result is made.  A
    sharded piece (parallel/sharded_engine.py, reference :182-195) has a
    list of request indices a shard and a list of lane counts a shard,
    and its output is [n_shards, 5, W]: shard sh answers its first
    counts[sh] lanes."""

    __slots__ = ("_engine", "_pieces", "_limit", "_n", "_result")

    def __init__(self, engine, pieces, limit, n):
        self._engine = engine
        self._pieces = pieces
        self._limit = limit
        self._n = n
        self._result = None

    def get(self):
        if self._result is not None:
            return self._result
        n = self._n
        o_status = np.empty(n, dtype=np.int32)
        o_rem = np.empty(n, dtype=_I64)
        o_reset = np.empty(n, dtype=_I64)
        for ticket, dst_idx, lanes, unpack in self._pieces:
            arr = ticket.fetch()
            if isinstance(dst_idx, list):
                for sh, idxs in enumerate(dst_idx):
                    if lanes[sh]:
                        st, rem, rst = unpack(arr[sh], lanes[sh])
                        o_status[idxs] = st
                        o_rem[idxs] = rem
                        o_reset[idxs] = rst
                continue
            st, rem, rst = unpack(arr[:, lanes], len(lanes))
            o_status[dst_idx] = st
            o_rem[dst_idx] = rem
            o_reset[dst_idx] = rst
        with self._engine._lock:
            self._engine.over_limit_total += int(np.sum(o_status == _OVER_I))
        # limit is echoed from the request (the step's limit is the request's)
        self._result = (o_status, self._limit, o_rem, o_reset)
        self._pieces = ()
        return self._result


def write_through_store(
    store,
    requests: Sequence[RateLimitReq],
    valid_idx: List[int],
    greg_dur,
    now_ms: int,
    responses: List[Optional[RateLimitResp]],
    expire_of: dict,
) -> None:
    """Store.OnChange per touched key, its values derived from the
    response (reference core/engine.py:212; the leaky remaining is the
    response's integer, see store.py).  `greg_dur` and `expire_of` are
    indexed by request index.  reference: algorithms.go:164-169,266-269."""
    for i in valid_idx:
        r = requests[i]
        resp = responses[i]
        if resp is None or resp.error:
            continue
        key = r.hash_key()
        greg = bool(int(r.behavior) & _GREG)
        dur = int(greg_dur[i]) if greg else r.duration
        if int(r.algorithm) == _TOKEN:
            if int(r.behavior) & _RESET:
                # reference: algorithms.go:83-97 (remove, then recreate).
                store.remove(key)
            value = TokenBucketItem(
                status=int(resp.status),
                limit=resp.limit,
                duration=dur,
                remaining=resp.remaining,
                created_at=now_ms if greg else resp.reset_time - dur,
            )
        else:
            value = LeakyBucketItem(
                limit=resp.limit,
                duration=dur,
                remaining=float(resp.remaining),
                updated_at=now_ms,
                burst=r.burst,
            )
        store.on_change(
            r, CacheItem(key=key, value=value, expire_at=int(expire_of[i]),
                         algorithm=int(r.algorithm)),
        )


class DecisionEngine:
    """Single-device decision engine over `capacity` bucket slots."""

    # Slots per sweep window: bounds one window's readback (its count and
    # freed indices) whatever the capacity (reference :914).
    SWEEP_WINDOW = 1 << 17

    def __init__(
        self,
        capacity: int = 50_000,  # reference default cache size (config.go:294)
        *,
        clock: Clock = SYSTEM_CLOCK,
        device=None,
        max_kernel_width: int = 8192,
        store=None,  # store.Store: write-through hooks
    ):
        self.device = resolve_device(device)
        # Paged state: `capacity` is the logical key space, the device
        # holds the resident frames only (GUBER_PAGED*, read here as the
        # reference's engine reads them).
        self.logical_capacity = capacity
        self.paging: Optional[PagePlane] = None
        if env_paged():
            self.paging = PagePlane(capacity, env_page_size(), env_paged_resident())
            capacity = self.paging.device_capacity
        self.capacity = capacity
        self.clock = clock
        self.max_kernel_width = max_kernel_width
        self.table = make_intern_table(self.logical_capacity)
        self._state: BucketState = make_state(capacity, self.device)
        self.store = store
        # Next window start of the incremental sweep.
        self._sweep_cursor = 0
        # RLock: a pump ticket's fetch may flush from a thread already
        # inside the engine.
        self._lock = threading.RLock()
        # GUBER_FUSED (reference :398-450).  "split", the reference's A/B
        # control: each round runs as its clears (a K2 launch, then K5 for
        # a restoring round), then K14 and K15, a collapsed chunk as K16
        # and K15, with no pump and no uniform format.  Every other value
        # selects the fused kernels: the port has one fused form where the reference
        # has a Pallas kernel and an XLA program, so "pallas", "interpret"
        # and "xla" name no arm of their own here, and `fused_mode` is
        # "cuda" (kernels K1 / K3 / K4) or "torch-cpu" (their plain PyTorch
        # versions) for them.
        self._split = env_fused() == "split"
        if self._split:
            self.fused_mode = "split"
        else:
            self.fused_mode = "cuda" if self.device.type == "cuda" else "torch-cpu"
        self._pump = StepPump(self, queueing=env_pump(self.device.type) and not self._split)
        self.readback = ReadbackCombiner()
        self.requests_total = 0
        self.over_limit_total = 0
        self.batches_total = 0
        # Rounds and sub-rounds run, plus one per collapsed chunk.
        self.rounds_total = 0
        # Every kernel launch the serving, store and load paths make (K1,
        # K3, K4; K2 and K5 where a round restores or a load runs; K9 and
        # K10 where paged state faults; under split, a round's clear launch,
        # K14 and K15, and K16 and K15 a collapsed chunk).
        self.dispatches_total = 0
        # Eviction clears run, inside those launches or as K2's (or, for a
        # cold page, in the host store).
        self.clears_total = 0
        # Sweep windows run, and the groups of up to 16 they ran in (one
        # K6 launch each).
        self.sweep_windows_total = 0
        self.sweep_groups_total = 0
        # Host wall time of each round or batch launch: its staging copy
        # and the launch, as enqueued (the service's device.step stage;
        # reference :491).
        self.round_duration = DurationStat()

    @property
    def state(self) -> BucketState:
        """The live device state, after every queued batch has run
        (read-only use: export, comparison)."""
        with self._lock:
            self._flush_pump()
            return self._state

    # ------------------------------------------------------------------

    def get_rate_limits(
        self, requests: Sequence[RateLimitReq], now_ms: Optional[int] = None
    ) -> List[RateLimitResp]:
        """Apply a batch of rate-limit checks; responses in request order.
        An invalid Gregorian interval answers that item with an error."""
        if now_ms is None:
            now_ms = self.clock.now_ms()
        n = len(requests)
        if n == 0:
            return []
        responses: List[Optional[RateLimitResp]] = [None] * n
        now_dt = None
        greg_dur: List[int] = []
        greg_exp: List[int] = []
        valid: List[int] = []
        for i, r in enumerate(requests):
            gd = ge = 0
            if int(r.behavior) & _GREG:
                if now_dt is None:
                    # Civil time from the kernel's own `now` (a second
                    # clock read could land in another interval).
                    now_dt = dt_from_ms(now_ms)
                try:
                    gd = gregorian_duration(now_dt, r.duration)
                    ge = gregorian_expiration(now_dt, r.duration)
                except GregorianError as e:
                    responses[i] = RateLimitResp(error=str(e))
                    continue
            valid.append(i)
            greg_dur.append(gd)
            greg_exp.append(ge)

        if valid:
            reqs = [requests[i] for i in valid]

            def col(get, dtype):
                return np.fromiter((get(r) for r in reqs), dtype=dtype, count=len(reqs))

            limit = col(lambda r: r.limit, _I64)
            cols = (col(lambda r: int(r.algorithm), _I32), col(lambda r: int(r.behavior), _I32),
                    col(lambda r: r.hits, _I64), limit, col(lambda r: r.duration, _I64),
                    col(lambda r: r.burst, _I64), np.asarray(greg_dur, dtype=_I64),
                    np.asarray(greg_exp, dtype=_I64))
            if self.store is None:
                self._answer(responses, valid, self._apply(
                    [r.hash_key().encode() for r in reqs], cols, now_ms, uniform_ok=False))
            else:
                # The reference holds the engine lock from scheduling to
                # the last write-through (core/engine.py:562-570).
                with self._lock:
                    self._answer(responses, valid, self._apply_store(reqs, cols, now_ms))
                    expires = self._expiry(cols, now_ms)
                    write_through_store(
                        self.store, requests, valid,
                        dict(zip(valid, greg_dur)), now_ms, responses,
                        dict(zip(valid, expires.tolist())),
                    )
        with self._lock:
            self.requests_total += n
            self.batches_total += 1
        return responses  # type: ignore[return-value]

    @staticmethod
    def _answer(responses, valid: List[int], pending: "PendingColumnar") -> None:
        """Fill the valid items' responses from a batch's result."""
        status, limit, rem, reset = pending.get()
        for i, st, lim, rm, rs in zip(
            valid, status.tolist(), limit.tolist(), rem.tolist(), reset.tolist()
        ):
            responses[i] = RateLimitResp(
                status=_STATUS_OF[st], limit=lim, remaining=rm, reset_time=rs
            )

    @staticmethod
    def _expiry(cols, now_ms: int) -> np.ndarray:
        """The host TTL mirror's expiry per item (device is authoritative):
        the Gregorian expiry, or now + duration."""
        behavior, duration, greg_exp = cols[1], cols[4], cols[7]
        return np.where((behavior & _GREG) != 0, greg_exp, now_ms + duration).astype(_I64)

    # ------------------------------------------------------------------
    # Columnar path: keys + numpy columns in, numpy columns out.

    def apply_columnar(
        self,
        keys,  # List[bytes] or PackedKeys
        algo: np.ndarray,  # int32 [n]
        behavior: np.ndarray,  # int32 [n]
        hits: np.ndarray,  # int64 [n]
        limit: np.ndarray,  # int64 [n]
        duration: np.ndarray,  # int64 [n]
        burst: np.ndarray,  # int64 [n]
        now_ms: Optional[int] = None,
        want_async: bool = False,
        count_decisions: bool = True,
    ):
        """Vectorized decision path; returns (status int32, limit int64,
        remaining int64, reset_time int64) numpy arrays in request order
        — or, with want_async=True, a PendingColumnar whose .get() gives
        them, so the caller can pack the next batch while this one's
        output comes home.  Gregorian lanes are computed per item; an
        invalid interval raises GregorianError (columnar callers
        pre-validate).  Raises with a store attached: the write-through
        path needs the request dataclasses (use get_rate_limits).

        `count_decisions=False` applies the batch without bumping
        `requests_total` / `batches_total` (reference :972): the decision
        ledger's settle rows (core/ledger.py) are device work, not client
        decisions."""
        if self.store is not None:
            raise RuntimeError(
                "apply_columnar does not support a write-through Store; use get_rate_limits"
            )
        n = len(keys)
        if now_ms is None:
            now_ms = self.clock.now_ms()
        greg_dur = np.zeros(n, dtype=_I64)
        greg_exp = np.zeros(n, dtype=_I64)
        greg_idx = np.nonzero((behavior & _GREG) != 0)[0]
        if len(greg_idx):
            now_dt = dt_from_ms(now_ms)
            for i in greg_idx:
                greg_dur[i] = gregorian_duration(now_dt, int(duration[i]))
                greg_exp[i] = gregorian_expiration(now_dt, int(duration[i]))
        with span("engine.columnar", batch=n):
            pending = self._apply(
                keys, (algo, behavior, hits, limit, duration, burst, greg_dur, greg_exp), now_ms,
                uniform_ok=True,
            )
            if count_decisions:
                with self._lock:
                    self.requests_total += n
                    self.batches_total += 1
        return pending if want_async else pending.get()

    def _apply(self, keys, cols, now_ms: int, *, uniform_ok: bool) -> PendingColumnar:
        """The decision path of both entry points.  `keys` are bytes (a
        list or PackedKeys); `cols` the valid items' request columns
        (algo, behavior, hits, limit, duration, burst, greg_duration,
        greg_expire).  Schedules the batch with one native call, then
        collapses it or packs its rounds (uniform format only when
        `uniform_ok`), and returns the pending result.  The dataclass path
        (`uniform_ok` false) traces the batch as the reference's does:
        `engine.batch` (batch, rounds), `engine.collapsed` where it tries
        the collapse, `engine.round` a chunk."""
        n = len(keys)
        limit = cols[3]
        if n == 0:
            return PendingColumnar(self, [], limit, 0)
        with self._lock:
            key_list, segs = self._segments(keys)
            if segs is not None:
                return self._segmented(segs, limit, lambda lo, hi: self._apply(
                    key_list[lo:hi], tuple(c[lo:hi] for c in cols), now_ms,
                    uniform_ok=uniform_ok))
            if isinstance(keys, PackedKeys):
                slots, rounds_arr, evicted, evict_rounds = self.table.schedule_packed(
                    keys.buf, keys.offsets, now_ms
                )
            else:
                slots, rounds_arr, evicted, evict_rounds = self.table.schedule(keys, now_ms)
            lslots = slots
            if self.paging is not None:
                slots = self.paging.translate(self, lslots)
                evicted, res = self._device_clears(evicted)
                evict_rounds = evict_rounds[res]
            n_rounds = int(rounds_arr.max()) + 1
            with (contextlib.nullcontext() if uniform_ok
                  else span("engine.batch", batch=n, rounds=n_rounds)):
                pieces = None
                if n_rounds > 1:
                    # Hot keys: one collapsed launch instead of a round per
                    # repeat, when the duplicates allow it.
                    collapse = self._try_collapse if uniform_ok else self._collapse_dataclass
                    pieces = collapse(slots, *cols, now_ms, evicted, evict_rounds)
                if pieces is None:
                    clear_by_round: dict[int, List[int]] = {}
                    for es, k in zip(evicted.tolist(), evict_rounds.tolist()):
                        clear_by_round.setdefault(k, []).append(es)
                    pieces = self._dispatch_rounds(slots, rounds_arr, cols, now_ms,
                                                   clear_by_round, uniform_ok)
            # Host TTL mirror for eviction accounting (device is authoritative).
            self.table.set_expiry(lslots, self._expiry(cols, now_ms))
        return PendingColumnar(self, pieces, limit, n)

    def _segments(self, keys):
        """Paged state: (the keys as a list, the segments) of a batch with
        more unique keys than frames (reference :561, :1029), or (None,
        None) when it fits."""
        if self.paging is None or len(keys) <= self.paging.frames:
            return None, None
        key_list = keys.to_list() if isinstance(keys, PackedKeys) else keys
        segs = _segments_by_unique_keys(key_list, self.paging.frames)
        return (key_list, segs) if len(segs) > 1 else (None, None)

    def _segmented(self, segs, limit, apply_segment) -> PendingColumnar:
        """Apply a batch segment by segment, in order; each segment's
        pieces are re-offset into the caller's lanes (reference
        :1043-1044)."""
        pieces = []
        for lo, hi in segs:
            for p in apply_segment(lo, hi)._pieces:
                pieces.append((p[0], p[1] + lo) + p[2:])
        return PendingColumnar(self, pieces, limit, len(limit))

    def _device_clears(self, evicted):
        """Paged state: eviction clears (logical slots, after the batch's
        translation) → (the device rows of the resident ones, the resident
        mask).  A slot whose page is not resident is cleared in the host
        store here: no batch touches it (reference `_apply_clears`
        :740-757)."""
        evicted = np.asarray(evicted, dtype=_I64)
        res = self.paging.resident_mask(evicted)
        if not res.all():
            self.paging.clear_host_slots(evicted[~res])
            self.clears_total += int((~res).sum())
        return self.paging.resident_rows(evicted[res]), res

    def _apply_store(self, reqs, cols, now_ms: int) -> PendingColumnar:
        """The decision path with a write-through store (reference
        :587-646): intern key by key, a per-slot sequence giving each
        request its round and each eviction clear the round of the slot's
        next use, and `store.get` for every new key, whose item restores
        its slot in that round.  No collapse.  Caller holds the lock."""
        n = len(reqs)
        if self.paging is not None and n > self.paging.frames:
            _keys, segs = self._segments([r.hash_key() for r in reqs])
            if segs is not None:
                return self._segmented(segs, cols[3], lambda lo, hi: self._apply_store(
                    reqs[lo:hi], tuple(c[lo:hi] for c in cols), now_ms))
        slots = np.empty(n, dtype=_I32)
        rounds_arr = np.empty(n, dtype=_I32)
        seq: dict[int, int] = {}
        clear_by_round: dict[int, List[int]] = {}
        restore_by_round: dict[int, List[tuple]] = {}
        for j, r in enumerate(reqs):
            key = r.hash_key()
            evicted: List[int] = []
            is_new = not self.table.contains(key)
            slot = self.table.intern(key, now_ms, evicted)
            for es in evicted:
                clear_by_round.setdefault(seq.get(es, 0), []).append(es)
            k = seq.get(slot, 0)
            seq[slot] = k + 1
            slots[j] = slot
            rounds_arr[j] = k
            if is_new:
                # Read-through (reference: algorithms.go:46-54).
                item = self.store.get(r)
                if item is not None and item.value is not None:
                    restore_by_round.setdefault(k, []).append((slot, item))
        lslots = slots
        if self.paging is not None:
            # Device rows for the rounds and the clears they carry; restores
            # stay logical (`_apply_restores` maps them).
            slots = self.paging.translate(self, lslots)
            for k, cleared in clear_by_round.items():
                # A restoring round's clears stay logical: they run through
                # `_apply_clears`, which maps them.
                if k not in restore_by_round:
                    clear_by_round[k] = self._device_clears(cleared)[0].tolist()
        with span("engine.batch", batch=n, rounds=int(rounds_arr.max()) + 1 if n else 0):
            pieces = self._dispatch_rounds(slots, rounds_arr, cols, now_ms, clear_by_round,
                                           False, restore_by_round)
        self.table.set_expiry(lslots, self._expiry(cols, now_ms))
        return PendingColumnar(self, pieces, cols[3], n)

    def _uniform_params(self, algo, behavior, hits, limit, duration, burst) -> Optional[tuple]:
        """Gate of the narrow uniform format (reference :1111): one
        limit config across the batch, no Gregorian or
        RESET_REMAINING (its reset_time 0 has no narrow form), and
        32-bit-safe values.  Returns (algo, behavior, hits, limit,
        duration, burst) or None."""
        if len(algo) == 0:
            return None
        a0, b0, h0, l0, d0, u0 = (
            int(c[0]) for c in (algo, behavior, hits, limit, duration, burst)
        )
        if b0 & (_GREG | _RESET):
            return None
        if not (0 <= l0 < 2**31 and 0 <= u0 < 2**31 and 0 < d0 < 2**31):
            return None
        if not -(2**31) < h0 < 2**31:
            return None
        if (
            (algo != a0).any() or (behavior != b0).any() or (hits != h0).any()
            or (limit != l0).any() or (duration != d0).any() or (burst != u0).any()
        ):
            return None
        return (a0, b0, h0, l0, d0, u0)

    def _round_chunks(self, slots, rounds_arr, clear_by_round, restore_by_round, on_restore):
        """Walk a batch's rounds in order: yields (k, chunk, cleared) for
        each chunk of at most max_kernel_width of round k's lanes (member
        indexes sorted by slot), `cleared` the round's clears on its first
        chunk, else [].  A round with store restores (`restore_by_round`)
        first calls `on_restore()`, then runs its clears and restores
        (`_apply_clears`, `_apply_restores`: K2, then K5) and yields no
        clears (reference :632-646, :1185-1190)."""
        order = np.argsort(rounds_arr, kind="stable")
        uniq, starts = np.unique(rounds_arr[order], return_index=True)
        bounds = list(starts) + [len(slots)]
        for r, k in enumerate(uniq.tolist()):
            cleared = clear_by_round.get(k, [])
            restores = restore_by_round.get(k) if restore_by_round else None
            if restores:
                on_restore()
                if cleared:
                    self._apply_clears(np.asarray(cleared, dtype=_I32))
                self._apply_restores(restores)
                cleared = []
            members = order[bounds[r] : bounds[r + 1]]
            for lo in range(0, len(members), self.max_kernel_width):
                chunk = members[lo : lo + self.max_kernel_width]
                yield k, chunk[np.argsort(slots[chunk], kind="stable")], cleared if lo == 0 else []

    def _dispatch_rounds(self, slots, rounds_arr, cols, now_ms, clear_by_round, uniform_ok,
                         restore_by_round=None):
        """Pack the rounds of a batch (`_round_chunks`, each round's clears
        before it) into one buffer and submit it to the pump.  A round with
        store restores closes the buffer before it: its clears and restores
        run on their own (K2 and K5), then it opens the next buffer with no
        clears.  Returns one piece per buffer.  Under split, `_split_rounds`.
        The dataclass path (`uniform_ok` false) opens an `engine.round`
        span a chunk, as the reference's does; since the chunks of a batch
        launch together, a round's span covers its place in the buffer."""
        if self._split:
            return self._split_rounds(slots, rounds_arr, cols, now_ms, clear_by_round,
                                      restore_by_round, traced=not uniform_ok)
        uni = self._uniform_params(*cols[:6]) if uniform_ok else None
        pieces = []
        counts: List[int] = []
        clears: List[List[int]] = []
        parts: List[np.ndarray] = []

        def close():
            nonlocal counts, clears, parts
            if parts:
                pieces.append(self._submit_rounds(slots, cols, now_ms, counts, clears, parts, uni))
                counts, clears, parts = [], [], []

        for k, chunk, cleared in self._round_chunks(slots, rounds_arr, clear_by_round,
                                                    restore_by_round, close):
            with (contextlib.nullcontext() if uniform_ok
                  else span("engine.round", round=k, width=len(chunk))):
                parts.append(chunk)
                counts.append(len(chunk))
                clears.append(cleared)
        close()
        return pieces

    def _split_rounds(self, slots, rounds_arr, cols, now_ms, clear_by_round,
                      restore_by_round=None, traced=False):
        """The split arm's rounds (reference :1181-1240 with no pump): each
        chunk of `_round_chunks` as its round's clears (K2 alone, on the
        round's first chunk), then K14 and K15, in an `engine.round` span
        when `traced`.  Returns one piece a chunk."""
        pieces = []
        for k, chunk, cleared in self._round_chunks(slots, rounds_arr, clear_by_round,
                                                    restore_by_round, lambda: None):
            with (span("engine.round", round=k, width=len(chunk)) if traced
                  else contextlib.nullcontext()):
                if len(cleared):
                    self._launch_clears(np.asarray(cleared, dtype=_I64))
                packed = pack_rounds_host(now_ms, self.capacity, [len(chunk)], slots[chunk],
                                          [a[chunk] for a in cols], [[]])
                t0 = time.monotonic()
                slot, words, pout = packed_compute(self._state, self._stage(packed.pin))
                scatter_store(self._state, slot, words)
                self.round_duration.observe(time.monotonic() - t0)
                self.dispatches_total += 2
                self.rounds_total += 1
                pieces.append((self.readback.register(pout), chunk, packed.lanes,
                               unpack_out_host))
        return pieces

    def _submit_rounds(self, slots, cols, now_ms, counts, clears, parts, uni):
        """One buffer of rounds to the pump (the uniform format when `uni`
        holds the batch's one config); returns its piece."""
        order = np.concatenate(parts)
        if uni is not None:
            packed = pack_uniform_rounds_host(now_ms, self.capacity, counts, slots[order],
                                              uni, clears)

            def unpack(arr, m, _now=now_ms):
                return unpack_uniform_out_host(arr, m, _now)
        else:
            packed = pack_rounds_host(now_ms, self.capacity, counts, slots[order],
                                      [a[order] for a in cols], clears)
            unpack = unpack_out_host
        ticket = self._pump.submit(packed)
        self.rounds_total += len(counts)
        self.clears_total += sum(len(c) for c in clears)
        return (ticket, order, packed.lanes, unpack)

    def _collapse_dataclass(self, slots, *cols_now_clears):
        """The dataclass path's collapse (reference :1244): none when a
        clear falls in a round after the first, else `_try_collapse` in an
        `engine.collapsed` span."""
        evict_rounds = cols_now_clears[-1]
        if len(evict_rounds) and int(evict_rounds.max()) > 0:
            return None
        with span("engine.collapsed", width=len(slots)):
            return self._try_collapse(slots, *cols_now_clears)

    def _try_collapse(self, slots, algo, behavior, hits, limit, duration, burst,
                      greg_dur, greg_exp, now_ms, evicted, evict_rounds):
        """Collapse a hot-key batch into one K3 launch per chunk (reference
        :1313; under split, its clears' launch, then K16 and K15 a chunk);
        returns its pieces, or None when the batch needs rounds
        (non-uniform duplicate fields, RESET_REMAINING on a duplicate,
        leaky negative hits on a duplicate, or a slot reused within the
        batch)."""
        # Mid-batch eviction reuse (a slot freed after use and handed to
        # another key in the same batch) breaks one key per segment.
        if len(evict_rounds) and int(evict_rounds.max()) > 0:
            return None
        n = len(slots)
        order = np.argsort(slots, kind="stable")  # stable = arrival order
        sorted_slots = slots[order]
        _uniq, seg_start, counts = np.unique(sorted_slots, return_index=True,
                                             return_counts=True)
        seg_of = np.repeat(np.arange(len(counts), dtype=np.int64), counts)
        dup_lane = counts[seg_of] > 1
        cols = (algo, behavior, hits, limit, duration, burst, greg_dur, greg_exp)
        for col in cols:
            cs = col[order]
            if not np.array_equal(cs[dup_lane], cs[seg_start][seg_of][dup_lane]):
                return None
        if bool(((behavior[order] & _RESET) != 0)[dup_lane].any()):
            return None
        # Sequential leaky semantics re-clamp remaining to burst on every
        # gather; with negative hits the closed form would skip those.
        if bool(((algo[order] == _LEAKY) & (hits[order] < 0))[dup_lane].any()):
            return None

        # The collapsed step reads the state: queued batches run first.
        self._flush_pump()
        sorted_cols = tuple(col[order] for col in cols)
        pieces = []
        # All clears are round 0 here: the first chunk's launch runs them,
        # sorted (K3's blocks then find theirs side by side).  Under split
        # they are a launch of their own first, as the reference's
        # `_apply_clears` (:1359-1361).
        clear_slots = np.sort(np.asarray(evicted, dtype=_I32))
        if self._split and len(clear_slots):
            self._launch_clears(clear_slots)
            clear_slots = clear_slots[:0]
        for lo in range(0, n, self.max_kernel_width):
            hi = min(lo + self.max_kernel_width, n)
            m = hi - lo
            # Per-chunk segments (a segment split across chunks is fine:
            # the next chunk's first occurrence gathers the stored state).
            c_uniq, c_start, c_counts = np.unique(sorted_slots[lo:hi], return_index=True,
                                                  return_counts=True)
            c_seg_of = np.repeat(np.arange(len(c_uniq), dtype=np.int64), c_counts)
            c_pos = np.arange(m, dtype=np.int64) - c_start[c_seg_of]
            buf = pack_collapsed_host(
                _aligned(m), now_ms, self.capacity, np.ascontiguousarray(c_uniq, dtype=_I32),
                c_counts.astype(np.int64), tuple(c[lo:hi][c_start] for c in sorted_cols),
                c_seg_of.astype(_I32), c_pos.astype(_I32),
            )
            t0 = time.monotonic()
            if self._split:
                slot, words, pout = collapsed_compute(self._state, self._stage(buf))
                scatter_store(self._state, slot, words)
                self.dispatches_total += 2
            else:
                flat = self._stage(np.concatenate([buf.ravel(), clear_slots]))
                pout = collapsed_step(self._state, flat[: buf.size].view(buf.shape),
                                      flat[buf.size :])
                self.dispatches_total += 1
            self.round_duration.observe(time.monotonic() - t0)
            self.rounds_total += 1
            self.clears_total += len(clear_slots)
            clear_slots = clear_slots[:0]
            pieces.append((self.readback.register(pout), order[lo:hi], np.arange(m),
                           unpack_out_host))
        return pieces

    # ------------------------------------------------------------------
    # Device helpers (caller holds the lock).

    def _stage(self, buf: np.ndarray) -> torch.Tensor:
        """A host int32 buffer on the engine's device.  On the card: one
        `non_blocking` copy from a pinned staging copy, queued on the
        current stream."""
        t = torch.from_numpy(buf)
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def _launch_rounds(self, pin, round_off, clear_off, clear_slots, widest: int) -> torch.Tensor:
        """One K1 launch, or K4 for a uniform pin, over packed rounds
        already on the device; returns the output tensor."""
        step = multi_uniform_step if pin.shape[0] == UNIFORM_IN_ROWS else multi_fused_step
        pout = step(self._state, pin, round_off, clear_off, clear_slots, widest=widest)
        self.dispatches_total += 1
        return pout

    def _flush_pump(self) -> None:
        """Run queued batches before any other state access (the pump's
        ordering contract).  Caller holds the lock."""
        self._pump.flush_locked()

    def _apply_clears(self, cleared: np.ndarray) -> None:
        """Eviction clears as one K2 launch of their own (reference :730).
        The slots are logical: with paged state a cold page's slots clear
        in the host store, the resident ones at their device rows
        (:740-757)."""
        if self.paging is not None:
            cleared = self._device_clears(cleared)[0]
        self._launch_clears(cleared)

    def _launch_clears(self, rows: np.ndarray) -> None:
        """One K2 launch over eviction clears at device rows, padded to the
        pow2 ladder from 16 with `capacity + lane`: a restoring round's
        (mapped by `_apply_clears`), and under split every round's and
        collapsed batch's (reference :1185-1187, :1359-1361).  Nothing to
        clear launches nothing."""
        if len(rows) == 0:
            return
        self._flush_pump()
        c = np.arange(self.capacity, self.capacity + pad_size(len(rows), floor=16),
                      dtype=np.int64).astype(_I32)
        c[: len(rows)] = rows
        clear_occupied(self._state.meta, self._stage(c))
        self.dispatches_total += 1
        self.clears_total += len(rows)

    def _apply_restores(self, restores: List[tuple]) -> None:
        """Hydrate items into fresh slots, `restores` = [(slot, CacheItem)]
        with unique logical slots: one record buffer, one copy, one K5
        launch (reference :770).  With paged state the items of cold pages
        go to the host store instead (no fault) and the others to their
        device rows."""
        self._flush_pump()
        if self.paging is not None:
            res = self.paging.resident_mask([s for s, _ in restores])
            cold = [r for r, ok in zip(restores, res) if not ok]
            if cold:
                self.paging.host_restore(cold)
            hot = [r for r, ok in zip(restores, res) if ok]
            if not hot:
                return
            rows = self.paging.resident_rows(np.asarray([s for s, _ in hot], dtype=_I64))
            restores = [(int(d), item) for d, (_s, item) in zip(rows, hot)]
        rec = pack_restore_host(build_restore_record(restores, self.capacity))
        load_slots(self._state, self._stage(rec))
        self.dispatches_total += 1

    # ------------------------------------------------------------------
    # Expiry sweep (reference :914).

    def sweep(self, now_ms: Optional[int] = None, max_windows: Optional[int] = None) -> int:
        """Reclaim the slots of expired buckets; returns how many were
        freed.  `max_windows` bounds this call to that many SWEEP_WINDOW
        ranges, resuming from the cursor next call (the daemon's
        incremental mode); None sweeps the whole capacity."""
        if now_ms is None:
            now_ms = self.clock.now_ms()

        def window_fn(meta, hi2, expire_lo, now, starts, window):
            self.sweep_groups_total += 1
            return sweep_windows(meta, hi2, expire_lo, now, starts, window)

        def release(freed: np.ndarray, start: int) -> int:
            self.sweep_windows_total += 1
            if len(freed):
                slots = freed + start
                if self.paging is not None:
                    # The intern table only knows logical slots.
                    slots = self.paging.logical_of_device(slots)
                self.table.release_slots(slots)
            return len(freed)

        with self._lock, span("engine.sweep") as sp:
            self._flush_pump()
            freed = windowed_sweep(self, self.capacity, now_ms, max_windows, release,
                                   window_fn=window_fn)
            if self.paging is not None:
                # Cold pages never reach the device sweep: their expired
                # rows free from the host words, with no fault (reference
                # :940-944).
                host_freed = self.paging.sweep_host(now_ms)
                if len(host_freed):
                    self.table.release_slots(host_freed)
                    freed += len(host_freed)
            if sp is not None:
                sp.set_attribute("freed", freed)
            return freed

    # ------------------------------------------------------------------
    # Bulk persistence (reference :1401-:1500; store.go:69-78 Loader).

    def load(self, loader) -> int:
        """Stream CacheItems in before serving; returns how many were
        restored (reference: gubernator.go:146-152)."""
        count = 0
        batch: List[tuple] = []
        pending_slots: set = set()
        now_ms = self.clock.now_ms()

        def flush():
            nonlocal batch
            if batch:
                self._apply_restores(batch)
                self.table.set_expiry(
                    np.asarray([s for s, _ in batch], dtype=_I32),
                    np.asarray([it.expire_at for _, it in batch], dtype=_I64),
                )
                batch = []
                pending_slots.clear()

        with self._lock:
            self._flush_pump()
            for item in loader.load():
                if item.value is None or not item.key:
                    continue
                evicted: List[int] = []
                slot = self.table.intern(item.key, now_ms, evicted)
                # A reused slot (an eviction, or a loader giving one key
                # twice) must not appear twice in one restore, and its
                # clear must not run after a pending restore of that slot.
                if slot in pending_slots or any(e in pending_slots for e in evicted):
                    flush()
                if evicted:
                    self._apply_clears(np.asarray(evicted, dtype=_I32))
                batch.append((slot, item))
                pending_slots.add(slot)
                count += 1
                if len(batch) >= 4096:
                    flush()
            flush()
        return count

    def export_items(self):
        """Full-fidelity snapshot of every live bucket as CacheItems: the
        whole state is copied to the host once, then decoded
        (reference: gubernator_pool.go:468-531)."""
        with self._lock:
            self._flush_pump()
            u = unpack_state_host(self._state)
            dev = np.nonzero(u["occupied"])[0]
            lsl = dev if self.paging is None else self.paging.logical_of_device(dev)
            rows = [(u, int(sl), self.table.key_for_slot(int(ls))) for sl, ls in zip(dev, lsl)]
            if self.paging is not None:
                # Cold pages export from the host store, bit-identical
                # words, with no fault (reference :1468-1477).
                for page in self.paging.nonresident_used_pages():
                    hu = self.paging.host_rows(page)
                    base = int(page) << self.paging.page_shift
                    rows.extend((hu, int(r), self.table.key_for_slot(base + int(r)))
                                for r in np.nonzero(hu["occupied"])[0])
        for u, sl, key in rows:
            if key is None:
                continue
            yield item_from_record(
                key=key,
                algorithm=int(u["algo"][sl]),
                status=int(u["status"][sl]),
                limit=int(u["limit"][sl]),
                remaining=int(u["remaining"][sl]),
                remf_hi=int(u["remf_hi"][sl]),
                remf_lo=int(u["remf_lo"][sl]),
                duration=int(u["duration"][sl]),
                t0=int(u["t0"][sl]),
                expire_at=int(u["expire"][sl]),
                burst=int(u["burst"][sl]),
                invalid_at=int(u["invalid"][sl]),
            )

    def save(self, loader) -> None:
        """Stream the cache out at shutdown (reference: Loader.Save)."""
        loader.save(self.export_items())

    # ------------------------------------------------------------------

    def cache_size(self) -> int:
        return len(self.table)

    def close(self) -> None:
        """Run what is queued, then release the device state."""
        with self._lock:
            if self._state is not None:
                self._flush_pump()
            self._state = None  # type: ignore[assignment]
