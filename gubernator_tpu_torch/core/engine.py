"""DecisionEngine — the local rate-limit execution engine, on PyTorch.

Port of `gubernator_tpu/core/engine.py:322 DecisionEngine`:

  host: key interning (key string → slot) + per-key rounds + packing
  device: one fused-step kernel launch per round (ops/fused_step.py)

Per-key serialization is kept by splitting a batch into rounds: request
i goes to round k if it is the k-th occurrence of its key within the
batch, so each launch sees a slot at most once and duplicate keys apply
in arrival order.  Eviction clears run (kernel K2) just before the round
whose slot sequence they belong to.  The host sorts each round by slot
and packs it into one int32 [16, W] buffer; padding lanes hold
`capacity + lane`; W rides the pow2 ladder 64 … `max_kernel_width`.

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
    pack_batch_host,
    unpack_out_host,
)
from gubernator_tpu_torch.ops.fused_step import clear_occupied, fused_step, resolve_device
from gubernator_tpu_torch.types import Behavior, RateLimitReq, RateLimitResp, Status

_I32 = np.int32
_I64 = np.int64
_GREG = int(Behavior.DURATION_IS_GREGORIAN)
_OVER_I = int(Status.OVER_LIMIT)
_STATUS_OF = {int(s): s for s in Status}


def _pad_size(n: int, floor: int = 64) -> int:
    """Next power of two ≥ n (reference engine.py:75)."""
    size = floor
    while size < n:
        size *= 2
    return size


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
        # "cuda": rounds run kernel K1 (clears K2); "torch-cpu": their
        # plain PyTorch versions.
        self.fused_mode = "cuda" if self.device.type == "cuda" else "torch-cpu"
        self.requests_total = 0
        self.over_limit_total = 0
        self.batches_total = 0
        self.rounds_total = 0
        # Every device program the serving path launches (fused steps
        # and clears); one per round in steady state.
        self.dispatches_total = 0

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
            pieces = self._dispatch_rounds(slots, rounds_arr, cols, now_ms, clear_by_round)
            # Host TTL mirror for eviction accounting (device is authoritative).
            behavior, duration, greg_exp = cols[1], cols[4], cols[7]
            expires = np.where((behavior & _GREG) != 0, greg_exp, now_ms + duration)
            self.table.set_expiry(slots, expires.astype(_I64))

        o_status = np.empty(n, dtype=np.int32)
        o_rem = np.empty(n, dtype=_I64)
        o_reset = np.empty(n, dtype=_I64)
        # All rounds are queued on the device; read them back in order.
        for pout, dst_idx, m in pieces:
            st, rem, rst = unpack_out_host(pout.cpu().numpy(), m)
            o_status[dst_idx] = st
            o_rem[dst_idx] = rem
            o_reset[dst_idx] = rst
        with self._lock:
            self.over_limit_total += int(np.sum(o_status == _OVER_I))
        return o_status, o_rem, o_reset

    def _dispatch(self, buf: np.ndarray) -> torch.Tensor:
        """One round on the device: the packed buffer up, one fused-step
        launch; returns the [5, W] output still on the device."""
        pin = torch.from_numpy(buf).to(self.device)
        pout = fused_step(self._state, pin)
        self.dispatches_total += 1
        return pout

    def _apply_clears(self, cleared: np.ndarray) -> None:
        """Eviction clears: one K2 launch over the evicted slots, padded
        to a pow2 width ≥ 16 with out-of-range `capacity + lane` lanes."""
        csize = _pad_size(len(cleared), floor=16)
        c = np.arange(self.capacity, self.capacity + csize, dtype=np.int64).astype(_I32)
        c[: len(cleared)] = cleared
        clear_occupied(self._state.meta, torch.from_numpy(c).to(self.device))
        self.dispatches_total += 1

    def _dispatch_rounds(self, slots, rounds_arr, cols, now_ms, clear_by_round):
        """Launch every round of a columnar batch (clears first, wide
        rounds chunked to max_kernel_width); returns [(pout on device,
        request indices of the sorted lanes, lane count)]."""
        n = len(slots)
        order = np.argsort(rounds_arr, kind="stable")
        uniq, starts = np.unique(rounds_arr[order], return_index=True)
        bounds = list(starts) + [n]
        pieces = []
        for r, k in enumerate(uniq.tolist()):
            cleared = clear_by_round.get(k)
            if cleared:
                self._apply_clears(np.asarray(cleared, dtype=_I32))
            members = order[bounds[r] : bounds[r + 1]]
            for lo in range(0, len(members), self.max_kernel_width):
                chunk = members[lo : lo + self.max_kernel_width]
                c_slot = slots[chunk]
                sort_idx = np.argsort(c_slot, kind="stable")
                lanes = chunk[sort_idx]
                buf = pack_batch_host(
                    _pad_size(len(chunk)), now_ms, self.capacity,
                    np.ascontiguousarray(c_slot[sort_idx], dtype=_I32),
                    *(a[lanes] for a in cols),
                )
                pieces.append((self._dispatch(buf), lanes, len(chunk)))
                self.rounds_total += 1
        return pieces

    # ------------------------------------------------------------------

    def cache_size(self) -> int:
        return len(self.table)

    def close(self) -> None:
        """Release the device state."""
        with self._lock:
            self._state = None  # type: ignore[assignment]
