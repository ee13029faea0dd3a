"""DecisionEngine — the local rate-limit execution engine, on PyTorch.

Port of `gubernator_tpu/core/engine.py:322 DecisionEngine`:

  host: key interning (key string → slot) + per-key rounds + packing
  device: one multi-round fused-step launch per batch (ops/fused_step.py)

Per-key serialization is kept by splitting a batch into rounds: request
i goes to round k if it is the k-th occurrence of its key within the
batch, so each round sees a slot at most once and duplicate keys apply
in arrival order.  Eviction clears belong to the round whose slot
sequence they precede.  The host sorts each round by slot and packs all
of the batch's rounds, their lane offsets and their clears into one
int32 buffer (`ops.bucket_kernel.pack_rounds_host`; each round padded to
a multiple of 32 lanes with `capacity + j`, a round wider than
`max_kernel_width` split into sub-rounds).  One copy takes it to the
device, one launch of kernel K1 runs every round in order with its
clears as the round's prologue, and one readback brings the [5, L]
output home.

Not in this slice: the pump, the hot-key collapse, the uniform narrow
format, paging, the write-through store, restore, sweep and the ledger.
Batches with duplicate keys therefore always run as rounds; the
reference's collapse is exact sequential semantics, so the answers are
the same.  `now_ms` flows in from the caller or the injected Clock.
"""

from __future__ import annotations

import threading
from typing import List, Optional, Sequence

import numpy as np
import torch

from gubernator_tpu_torch.clock import SYSTEM_CLOCK, Clock
from gubernator_tpu_torch.core.interning import InternTable
from gubernator_tpu_torch.gregorian import (
    GregorianError,
    dt_from_ms,
    gregorian_duration,
    gregorian_expiration,
)
from gubernator_tpu_torch.ops.bucket_kernel import (
    BucketState,
    make_state,
    pack_rounds_host,
    split_rounds,
    unpack_out_host,
)
from gubernator_tpu_torch.ops.fused_step import multi_fused_step, resolve_device
from gubernator_tpu_torch.types import Behavior, RateLimitReq, RateLimitResp, Status

_I32 = np.int32
_I64 = np.int64
_GREG = int(Behavior.DURATION_IS_GREGORIAN)
_OVER_I = int(Status.OVER_LIMIT)
_STATUS_OF = {int(s): s for s in Status}


class DecisionEngine:
    """Single-device decision engine over `capacity` bucket slots."""

    def __init__(
        self,
        capacity: int = 50_000,  # reference default cache size (config.go:294)
        *,
        clock: Clock = SYSTEM_CLOCK,
        device=None,
        max_kernel_width: int = 8192,
    ):
        self.device = resolve_device(device)
        self.capacity = capacity
        self.clock = clock
        self.max_kernel_width = max_kernel_width
        self.table = InternTable(capacity)
        self._state: BucketState = make_state(capacity, self.device)
        self._lock = threading.RLock()
        # "cuda": batches run kernel K1; "torch-cpu": its plain PyTorch
        # version.
        self.fused_mode = "cuda" if self.device.type == "cuda" else "torch-cpu"
        self.requests_total = 0
        self.over_limit_total = 0
        self.batches_total = 0
        # Rounds and sub-rounds run (all of a batch's in one launch).
        self.rounds_total = 0
        # Every device program the serving path launches: one per batch.
        self.dispatches_total = 0
        # Eviction clears run as a round's prologue inside K1.
        self.clears_total = 0

    @property
    def state(self) -> BucketState:
        """The live device state (read-only use: export, comparison)."""
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
            status, rem, reset = self._apply(
                [r.hash_key() for r in reqs],
                (col(lambda r: int(r.algorithm), _I32), col(lambda r: int(r.behavior), _I32),
                 col(lambda r: r.hits, _I64), limit, col(lambda r: r.duration, _I64),
                 col(lambda r: r.burst, _I64), np.asarray(greg_dur, dtype=_I64),
                 np.asarray(greg_exp, dtype=_I64)),
                now_ms,
            )
            for i, st, lim, rm, rs in zip(
                valid, status.tolist(), limit.tolist(), rem.tolist(), reset.tolist()
            ):
                responses[i] = RateLimitResp(
                    status=_STATUS_OF[st], limit=lim, remaining=rm, reset_time=rs
                )
        with self._lock:
            self.requests_total += n
            self.batches_total += 1
        return responses  # type: ignore[return-value]

    # ------------------------------------------------------------------
    # Columnar path: keys + numpy columns in, numpy columns out.

    def apply_columnar(
        self,
        keys: List[bytes],
        algo: np.ndarray,  # int32 [n]
        behavior: np.ndarray,  # int32 [n]
        hits: np.ndarray,  # int64 [n]
        limit: np.ndarray,  # int64 [n]
        duration: np.ndarray,  # int64 [n]
        burst: np.ndarray,  # int64 [n]
        now_ms: Optional[int] = None,
    ):
        """Vectorized decision path; returns (status int32, limit int64,
        remaining int64, reset_time int64) numpy arrays in request order.
        Gregorian lanes are computed per item; an invalid interval raises
        GregorianError (columnar callers pre-validate)."""
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
        o_status, o_rem, o_reset = self._apply(
            [k.decode() for k in keys],
            (algo, behavior, hits, limit, duration, burst, greg_dur, greg_exp),
            now_ms,
        )
        with self._lock:
            self.requests_total += n
            self.batches_total += 1
        return o_status, limit, o_rem, o_reset

    def _apply(self, keys: List[str], cols, now_ms: int):
        """The decision path of both entry points.  `cols` are the valid
        items' request columns (algo, behavior, hits, limit, duration,
        burst, greg_duration, greg_expire); returns (status int32,
        remaining int64, reset_time int64) in request order.

        Rounds: the k-th operation on a slot goes to round k.  An eviction
        clear is scheduled at its slot's current sequence number (after
        the evicted key's last request, before the reusing key's first)."""
        n = len(keys)
        if n == 0:
            return np.empty(0, np.int32), np.empty(0, _I64), np.empty(0, _I64)
        with self._lock:
            slots = np.empty(n, dtype=_I32)
            rounds_arr = np.empty(n, dtype=_I32)
            seq: dict[int, int] = {}
            clear_by_round: dict[int, List[int]] = {}
            for j, key in enumerate(keys):
                evicted: List[int] = []
                slot = self.table.intern(key, now_ms, evicted)
                for es in evicted:
                    clear_by_round.setdefault(seq.get(es, 0), []).append(es)
                k = seq.get(slot, 0)
                seq[slot] = k + 1
                slots[j] = slot
                rounds_arr[j] = k
            pout, lanes, order = self._dispatch_rounds(
                slots, rounds_arr, cols, now_ms, clear_by_round
            )
            # Host TTL mirror for eviction accounting (device is authoritative).
            behavior, duration, greg_exp = cols[1], cols[4], cols[7]
            expires = np.where((behavior & _GREG) != 0, greg_exp, now_ms + duration)
            self.table.set_expiry(slots, expires.astype(_I64))

        # One readback of the whole batch; lane `lanes[j]` answers request
        # `order[j]`.
        out = pout.cpu().numpy()[:, lanes]
        st, rem, rst = unpack_out_host(out, n)
        o_status = np.empty(n, dtype=np.int32)
        o_rem = np.empty(n, dtype=_I64)
        o_reset = np.empty(n, dtype=_I64)
        o_status[order] = st
        o_rem[order] = rem
        o_reset[order] = rst
        with self._lock:
            self.over_limit_total += int(np.sum(o_status == _OVER_I))
        return o_status, o_rem, o_reset

    def _dispatch_rounds(self, slots, rounds_arr, cols, now_ms, clear_by_round):
        """Pack every round of a batch (sorted by slot, wide rounds split
        into sub-rounds of at most max_kernel_width lanes, each round's
        clears before it) into one buffer, copy it to the device once and
        launch K1 once.  Returns (pout [5, L] on the device, the lane of
        each request in `order`, `order`: request indices round-major)."""
        order = np.argsort(rounds_arr, kind="stable")
        uniq, starts = np.unique(rounds_arr[order], return_index=True)
        bounds = list(starts) + [len(slots)]
        counts: List[int] = []
        clears: List[List[int]] = []
        parts: List[np.ndarray] = []
        for r, k in enumerate(uniq.tolist()):
            members = order[bounds[r] : bounds[r + 1]]
            cleared = clear_by_round.get(k, [])
            for lo in range(0, len(members), self.max_kernel_width):
                chunk = members[lo : lo + self.max_kernel_width]
                parts.append(chunk[np.argsort(slots[chunk], kind="stable")])
                counts.append(len(chunk))
                clears.append(cleared if lo == 0 else [])
        order = np.concatenate(parts)
        packed = pack_rounds_host(
            now_ms, self.capacity, counts, slots[order], [a[order] for a in cols], clears
        )
        flat = torch.from_numpy(packed.buf).to(self.device)
        pin, round_off, clear_off, clear_slots = split_rounds(
            flat, packed.pin.shape[1], len(counts)
        )
        pout = multi_fused_step(
            self._state, pin, round_off, clear_off, clear_slots, widest=packed.widest
        )
        self.dispatches_total += 1
        self.rounds_total += len(counts)
        self.clears_total += sum(len(c) for c in clears)
        return pout, packed.lanes, order

    # ------------------------------------------------------------------

    def cache_size(self) -> int:
        return len(self.table)

    def close(self) -> None:
        """Release the device state."""
        with self._lock:
            self._state = None  # type: ignore[assignment]
