"""Bucket state layout, host packing helpers and the plain PyTorch
fused decision step.

Port of `gubernator_tpu/ops/bucket_kernel.py` (the JAX package is the
reference; this module imports none of it).  Three parts:

* **Layout.**  `BucketState` is twelve 1-D int32 tensors of `capacity`
  words each, 48 B per slot, field for field the JAX package's
  `BucketState`.  The reference holds six of the columns (`*_lo`) as
  uint32; PyTorch has no usable uint32 arithmetic (`>>`, `<`, `+` and
  `index_put` raise for `torch.uint32`), so those columns hold the same
  32 bits as int32 and are widened with `& 0xFFFFFFFF` wherever their
  value is read.  `state_from_numpy` / `state_to_numpy` move a state
  between the two representations word for word.
* **Host helpers.**  numpy copies of the packed-buffer and state
  packing helpers (`pack_batch_host`, `unpack_out_host`,
  `pack_state_host`, `unpack_state_host`): the same bytes as the
  reference's; and `pack_rounds_host`, which lays a whole batch's
  rounds, lane offsets and eviction clears into one flat buffer.
* **The plain fused step.**  `fused_step_reference(state, pin)` is the
  gather → `update_lanes` → `encode_slot_values` → store → pack round
  of the reference's `_fused_step_core`, written as tensor code;
  `multi_fused_step_reference` runs R such rounds in order, each after
  its clears (`clear_occupied_reference`), as the reference's
  `_multi_fused_core` and its engine's per-round clears do.  They are
  the CPU paths of `ops.fused_step` and the oracles the CUDA kernel
  (csrc/fused_step.cu) is held against on the card.

Two semantics of the reference need care in PyTorch:

* f64 → int conversions.  XLA:CPU truncates toward zero and SATURATES
  (1e30 → INT64_MAX, -1e30 → INT64_MIN, NaN → 0); a plain
  `tensor.to(torch.int64)` does not (it gives INT64_MIN for all of
  those).  `f64_to_i64` / `f64_to_u32` / `f64_to_i32` reproduce the
  saturating rule, which is also what PTX `cvt.rzi` does on the card.
* int64 overflow.  `now + duration` and friends wrap in two's
  complement in the reference; PyTorch's integer tensor arithmetic
  wraps the same way, and low-word extraction is done with explicit
  masks rather than a narrowing cast.

Division is exact IEEE f64 `/` (the CPU branch of the reference's
`ops/fastmath.py f64_div`), so every output and stored word is
bit-equal to the reference's.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from gubernator_tpu_torch.types import Algorithm, Behavior, Status

_I32 = torch.int32
_I64 = torch.int64
_F64 = torch.float64

_LO = 0xFFFFFFFF
_OVER = int(Status.OVER_LIMIT)
_UNDER = int(Status.UNDER_LIMIT)
_GREG = int(Behavior.DURATION_IS_GREGORIAN)
_RESET = int(Behavior.RESET_REMAINING)
_TOKEN = int(Algorithm.TOKEN_BUCKET)
INT64_MAX = (1 << 63) - 1

# Millisecond-timestamp clamp bound for the packed 11-bit hi words.
TS_CLAMP_MAX = (1 << 43) - 1
_HI11 = 0x7FF

# Packed single-transfer buffers (reference bucket_kernel.py:921-944):
#
#   row 0      header: [now_hi, now_lo, 0, ...]   (now_ms int64 words)
#   row 1      slot    (int32; sorted ascending; padding = cap + lane)
#   row 2      algo    row 3   behavior
#   rows 4-5   hits    rows 6-7   limit     rows 8-9  duration
#   rows 10-11 burst   rows 12-13 greg_dur  rows 14-15 greg_exp
#
# Output rows: 0 status, 1-2 remaining (hi, lo), 3-4 reset_time.
PACKED_IN_ROWS = 16
PACKED_OUT_ROWS = 5


class BucketState(NamedTuple):
    """Struct-of-arrays bucket state, 48 bytes/slot, every column an
    int32 tensor of `capacity` words.  Bit layout as the reference's
    `BucketState`: `meta` = occupied (bit 0) | algo (1) | sticky token
    status (2-3) | t0 hi word (4-14) | invalid_at hi word (15-25);
    `hi2` = expire hi (0-10) | duration hi (11-21); `rem_*` are the
    token remaining (int64 words) or the leaky 32.32 fixed point
    (whole, fraction), read through the meta algo bit.  The `*_lo`
    columns hold uint32 values as their int32 bit pattern."""

    meta: torch.Tensor
    hi2: torch.Tensor
    t0_lo: torch.Tensor
    expire_lo: torch.Tensor
    invalid_lo: torch.Tensor
    duration_lo: torch.Tensor
    limit_hi: torch.Tensor
    limit_lo: torch.Tensor
    rem_hi: torch.Tensor
    rem_lo: torch.Tensor
    burst_hi: torch.Tensor
    burst_lo: torch.Tensor


N_COLS = len(BucketState._fields)
# The columns the reference types uint32 (their numpy exports are uint32).
UNSIGNED_FIELDS = frozenset(f for f in BucketState._fields if f.endswith("_lo"))


def make_state(capacity: int, device) -> BucketState:
    """An empty state of `capacity` slots on `device`, one buffer per
    column (the kernel writes each column in place)."""
    return BucketState(
        *(torch.zeros(capacity, dtype=_I32, device=device) for _ in range(N_COLS))
    )


def state_from_numpy(words: dict, device) -> BucketState:
    """Reference-typed numpy columns (int32 / uint32, as the JAX
    package's `BucketState` exports them) → a port state on `device`;
    uint32 columns are reinterpreted bit for bit as int32."""
    cols = []
    for name in BucketState._fields:
        a = np.ascontiguousarray(words[name])
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        if a.dtype != np.int32:
            raise TypeError(f"column {name}: expected int32/uint32, got {a.dtype}")
        cols.append(torch.from_numpy(a.copy()).to(device))
    return BucketState(*cols)


def state_to_numpy(state: BucketState) -> dict:
    """A port state → numpy columns typed as the reference's (the
    `*_lo` columns come back as uint32), for word-for-word comparison."""
    out = {}
    for name, col in zip(BucketState._fields, state):
        a = col.detach().cpu().numpy()
        out[name] = a.view(np.uint32) if name in UNSIGNED_FIELDS else a
    return out


# ---------------------------------------------------------------------------
# meta / hi2 bit layout (reference bucket_kernel.py:158-207), on int64
# tensors: the `*_lo` arguments are already widened to their uint32 value.


def meta_occupied(meta):
    return (meta & 1) != 0


def meta_algo(meta):
    return (meta >> 1) & 1


def meta_status(meta):
    return (meta >> 2) & 3


def meta_t0(meta, t0_lo):
    return (((meta >> 4) & _HI11) << 32) | t0_lo


def meta_invalid(meta, inv_lo):
    return (((meta >> 15) & _HI11) << 32) | inv_lo


def hi2_expire(hi2, exp_lo):
    return ((hi2 & _HI11) << 32) | exp_lo


def hi2_duration(hi2, dur_lo):
    return (((hi2 >> 11) & _HI11) << 32) | dur_lo


def pack_meta(occ, algo, status, t0c, invc):
    """occupied/algo/status/t0/invalid (normalized; t0c/invc clamped to
    [0, 2^43)) → the meta word."""
    return occ | (algo << 1) | ((status & 3) << 2) | ((t0c >> 32) << 4) | ((invc >> 32) << 15)


def pack_hi2(expc, durc):
    """expire/duration (clamped) → the hi2 word."""
    return (expc >> 32) | ((durc >> 32) << 11)


# ---------------------------------------------------------------------------
# Host (numpy) helpers — byte-equal copies of the reference's.


def pack_state_host(logical: dict) -> dict:
    """Encode logical numpy columns (keys as in `unpack_state_host`,
    with the leaky remaining given as remf_hi/remf_lo words) into the
    packed column arrays, typed as the reference's (reference
    bucket_kernel.py:209)."""
    occ = np.asarray(logical["occupied"]).astype(bool)
    algo = (np.asarray(logical["algo"]) != 0).astype(np.int32)
    status = np.asarray(logical["status"]).astype(np.int64)
    t0c = np.clip(np.asarray(logical["t0"]), 0, TS_CLAMP_MAX)
    invc = np.clip(np.asarray(logical["invalid"]), 0, TS_CLAMP_MAX)
    expc = np.clip(np.asarray(logical["expire"]), 0, TS_CLAMP_MAX)
    durc = np.clip(np.asarray(logical["duration"]), 0, TS_CLAMP_MAX)
    meta = (
        occ.astype(np.int32)
        | (algo << 1)
        | ((status & 3).astype(np.int32) << 2)
        | ((t0c >> 32).astype(np.int32) << 4)
        | ((invc >> 32).astype(np.int32) << 15)
    )
    hi2 = ((expc >> 32).astype(np.int32)) | ((durc >> 32).astype(np.int32) << 11)
    rem64 = np.asarray(logical["remaining"]).astype(np.int64)
    leaky = algo == 1
    rem_hi = np.where(
        leaky,
        np.asarray(logical["remf_hi"]).astype(np.int32),
        (rem64 >> 32).astype(np.int32),
    )
    rem_lo = np.where(
        leaky,
        np.asarray(logical["remf_lo"]).astype(np.uint32),
        (rem64 & _LO).astype(np.uint32),
    )
    limit64 = np.asarray(logical["limit"]).astype(np.int64)
    burst64 = np.asarray(logical["burst"]).astype(np.int64)
    return {
        "meta": meta,
        "hi2": hi2,
        "t0_lo": (t0c & _LO).astype(np.uint32),
        "expire_lo": (expc & _LO).astype(np.uint32),
        "invalid_lo": (invc & _LO).astype(np.uint32),
        "duration_lo": (durc & _LO).astype(np.uint32),
        "limit_hi": (limit64 >> 32).astype(np.int32),
        "limit_lo": (limit64 & _LO).astype(np.uint32),
        "rem_hi": rem_hi,
        "rem_lo": rem_lo,
        "burst_hi": (burst64 >> 32).astype(np.int32),
        "burst_lo": (burst64 & _LO).astype(np.uint32),
    }


def unpack_state_host(state) -> dict:
    """Decode a full state (a port `BucketState` or reference-typed
    numpy columns) into logical numpy columns (reference
    bucket_kernel.py:258).  Keys: occupied, algo, status, t0, invalid,
    expire, duration, limit, remaining (token view), remf_hi/remf_lo
    (leaky words), burst."""
    w = state_to_numpy(state) if isinstance(state, BucketState) else state
    meta = np.asarray(w["meta"])
    hi2 = np.asarray(w["hi2"])

    def c64(hi, lo):
        return (np.asarray(w[hi]).astype(np.int64) << 32) | np.asarray(w[lo]).astype(
            np.int64
        )

    return {
        "occupied": (meta & 1) != 0,
        "algo": (meta >> 1) & 1,
        "status": (meta >> 2) & 3,
        "t0": (((meta >> 4) & _HI11).astype(np.int64) << 32)
        | np.asarray(w["t0_lo"]).astype(np.int64),
        "invalid": (((meta >> 15) & _HI11).astype(np.int64) << 32)
        | np.asarray(w["invalid_lo"]).astype(np.int64),
        "expire": ((hi2 & _HI11).astype(np.int64) << 32)
        | np.asarray(w["expire_lo"]).astype(np.int64),
        "duration": (((hi2 >> 11) & _HI11).astype(np.int64) << 32)
        | np.asarray(w["duration_lo"]).astype(np.int64),
        "limit": c64("limit_hi", "limit_lo"),
        "remaining": c64("rem_hi", "rem_lo"),
        "remf_hi": np.asarray(w["rem_hi"]),
        "remf_lo": np.asarray(w["rem_lo"]),
        "burst": c64("burst_hi", "burst_lo"),
    }


def pack_batch_host(
    size: int,
    now_ms: int,
    capacity: int,
    slot_sorted: np.ndarray,  # int32 [m] sorted ascending
    algo: np.ndarray,
    behavior: np.ndarray,
    hits: np.ndarray,
    limit: np.ndarray,
    duration: np.ndarray,
    burst: np.ndarray,
    greg_duration: np.ndarray,
    greg_expire: np.ndarray,
) -> np.ndarray:
    """Build the packed [16, size] int32 input buffer (reference
    bucket_kernel.py:982).  Lanes beyond `len(slot_sorted)` are
    padding: distinct ascending out-of-range slots, zero fields."""
    m = len(slot_sorted)
    out = np.zeros((PACKED_IN_ROWS, size), dtype=np.int32)
    out[0, 0] = (np.int64(now_ms) >> 32).astype(np.int32)
    out[0, 1] = np.int64(now_ms).astype(np.int32)  # low-word bit pattern
    out[1, :m] = slot_sorted
    if size > m:
        out[1, m:] = np.arange(capacity, capacity + (size - m), dtype=np.int64).astype(
            np.int32
        )
    out[2, :m] = algo
    out[3, :m] = behavior

    def w64(hi_row, lo_row, col):
        c = col.astype(np.int64, copy=False)
        out[hi_row, :m] = (c >> 32).astype(np.int32)
        out[lo_row, :m] = c.astype(np.int32)  # low-word bit pattern

    w64(4, 5, hits)
    w64(6, 7, limit)
    w64(8, 9, duration)
    w64(10, 11, burst)
    w64(12, 13, greg_duration)
    w64(14, 15, greg_expire)
    return out


# A multi-round call carries a batch's R rounds one after another along
# the lanes of one pin.  Each round's lanes are sorted by slot and padded
# to a multiple of ROUND_ALIGN lanes (one warp; 128 B of each pin row),
# with the `cap + j` padding of pack_batch_host; the `now` header sits in
# row 0, lanes 0-1, once for the batch.  R = 1 with a pow2 width is
# exactly pack_batch_host's buffer.
ROUND_ALIGN = 32


class PackedRounds(NamedTuple):
    """A batch's rounds in one flat int32 host buffer laid out as
    [pin (16·L) | round_off (R+1) | clear_off (R+1) | clear_slots (C)],
    so that one copy moves all of it; the array fields are views of
    `buf`.  Round r owns lanes [round_off[r], round_off[r+1]) and clears
    clear_slots[clear_off[r]:clear_off[r+1]] just before it runs."""

    buf: np.ndarray
    pin: np.ndarray  # int32 [16, L]
    round_off: np.ndarray  # int32 [R+1]
    clear_off: np.ndarray  # int32 [R+1]
    clear_slots: np.ndarray  # int32 [C], C >= 1 (an out-of-range slot when none)
    lanes: np.ndarray  # int64 [n]: the lane of each real request, in input order
    widest: int  # lanes of the widest round


def split_rounds(flat, width: int, n_rounds: int):
    """(pin [16, L], round_off, clear_off, clear_slots) views of a flat
    buffer laid out as `PackedRounds.buf` (numpy array or tensor)."""
    a = PACKED_IN_ROWS * width
    b = a + n_rounds + 1
    c = b + n_rounds + 1
    return flat[:a].reshape(PACKED_IN_ROWS, width), flat[a:b], flat[b:c], flat[c:]


def pack_rounds_host(
    now_ms: int,
    capacity: int,
    counts,  # int [R]: real lanes of each round
    slot_sorted: np.ndarray,  # int32 [n], round-major, ascending within each round
    cols,  # the 8 request columns (algo … greg_expire) in the same order
    clears,  # R sequences: the slots to clear before each round
    align: int = ROUND_ALIGN,
) -> PackedRounds:
    """Pack a batch's rounds for one multi-round step (the ragged
    counterpart of `pack_batch_host`, vectorized over all rounds)."""
    counts = np.asarray(counts, dtype=np.int64)
    n_rounds = len(counts)
    n = int(counts.sum())
    widths = -(-counts // align) * align
    round_off = np.zeros(n_rounds + 1, dtype=np.int64)
    np.cumsum(widths, out=round_off[1:])
    width = int(round_off[-1])
    if capacity + int(widths.max(initial=0)) > np.iinfo(np.int32).max:
        raise ValueError("capacity + round width must fit in int32 (padding slots)")
    first = np.cumsum(counts) - counts  # index of each round's first request
    lanes = np.arange(n, dtype=np.int64) + np.repeat(round_off[:-1] - first, counts)
    clear_counts = [len(c) for c in clears]
    if len(clear_counts) != n_rounds:
        raise ValueError("one clear list per round")
    n_clear = max(1, sum(clear_counts))
    buf = np.zeros(PACKED_IN_ROWS * width + 2 * (n_rounds + 1) + n_clear, dtype=np.int32)
    pin, v_round, v_clear, v_slots = split_rounds(buf, width, n_rounds)
    pin[0, 0] = (np.int64(now_ms) >> 32).astype(np.int32)
    pin[0, 1] = np.int64(now_ms).astype(np.int32)  # low-word bit pattern
    # padding: capacity + j for the round's j-th padding lane
    pad_start = np.repeat(round_off[:-1] + counts, widths)
    pin[1] = capacity + (np.arange(width, dtype=np.int64) - pad_start)
    pin[1, lanes] = slot_sorted
    algo, behavior, *wide = cols
    pin[2, lanes] = algo
    pin[3, lanes] = behavior
    for row, col in zip(range(4, PACKED_IN_ROWS, 2), wide):
        c = np.asarray(col).astype(np.int64, copy=False)
        pin[row, lanes] = (c >> 32).astype(np.int32)
        pin[row + 1, lanes] = c.astype(np.int32)  # low-word bit pattern
    v_round[:] = round_off
    v_clear[0] = 0
    np.cumsum(clear_counts, out=v_clear[1:])
    if sum(clear_counts):
        v_slots[:] = np.concatenate([np.asarray(c, dtype=np.int32) for c in clears])
    else:
        v_slots[:] = capacity  # out of range: clears nothing
    return PackedRounds(buf, pin, v_round, v_clear, v_slots, lanes,
                        int(widths.max(initial=0)))


def unpack_out_host(arr: np.ndarray, m: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Packed output rows → (status int32[m], remaining i64[m], reset
    i64[m]) (reference bucket_kernel.py:1031)."""
    status = arr[0, :m]
    rem = (arr[1, :m].astype(np.int64) << 32) | (arr[2, :m].astype(np.int64) & _LO)
    reset = (arr[3, :m].astype(np.int64) << 32) | (arr[4, :m].astype(np.int64) & _LO)
    return status, rem, reset


# ---------------------------------------------------------------------------
# Tensor helpers for the plain step.


def f64_to_i64(x: torch.Tensor) -> torch.Tensor:
    """float64 → int64 as XLA:CPU and PTX `cvt.rzi.s64.f64` convert:
    truncate toward zero, saturate at the int64 range, NaN → 0."""
    x = torch.nan_to_num(x, nan=0.0, posinf=2.0**63, neginf=-(2.0**63))
    over = x >= 2.0**63
    out = torch.where(over, 0.0, x).clamp(min=-(2.0**63)).to(_I64)
    return out.masked_fill(over, INT64_MAX)


def f64_to_u32(x: torch.Tensor) -> torch.Tensor:
    """float64 → uint32 value (held in int64): truncate, saturate to
    [0, 2^32 - 1], NaN → 0 (PTX `cvt.rzi.u32.f64`)."""
    return torch.nan_to_num(x, nan=0.0).clamp(0.0, 4294967295.0).to(_I64)


def f64_to_i32(x: torch.Tensor) -> torch.Tensor:
    """float64 → int32 value (held in int64): truncate, saturate, NaN → 0."""
    return torch.nan_to_num(x, nan=0.0).clamp(-(2.0**31), 2.0**31 - 1).to(_I64)


def _u32(x: torch.Tensor) -> torch.Tensor:
    """An int32 bit pattern → its uint32 value, as int64."""
    return x.to(_I64) & _LO


def _combine(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """(hi int32, lo uint32 bits) → int64 (two's complement)."""
    return (hi.to(_I64) << 32) | _u32(lo)


def _low_word(x: torch.Tensor) -> torch.Tensor:
    """int64 → its low 32 bits as an int32 bit pattern (the reference's
    int64 → uint32/int32 astype), without a narrowing cast of an
    out-of-range value."""
    return (((x & _LO) ^ 0x80000000) - 0x80000000).to(_I32)


def _row64(pin: torch.Tensor, hi_row: int, lo_row: int) -> torch.Tensor:
    return _combine(pin[hi_row], pin[lo_row])


def _update_lanes(g, mask, r_algo, r_beh, r_hits, r_limit, r_dur, r_burst, r_gdur, r_gexp, now):
    """The branch-free bucket update over gathered lanes: a line-for-
    line transcription of the reference's `update_lanes` (:514) and
    `encode_slot_values` (:781).  Returns (stored words as int64 in
    BucketState field order, status, remaining, reset)."""
    meta = g.meta.to(_I64)
    s_occ = meta_occupied(meta) & mask
    s_algo = meta_algo(meta)
    s_status = meta_status(meta)
    s_t0 = meta_t0(meta, _u32(g.t0_lo))
    s_inv = meta_invalid(meta, _u32(g.invalid_lo))
    hi2 = g.hi2.to(_I64)
    s_exp = hi2_expire(hi2, _u32(g.expire_lo))
    s_dur = hi2_duration(hi2, _u32(g.duration_lo))
    s_limit = _combine(g.limit_hi, g.limit_lo)
    s_rem = _combine(g.rem_hi, g.rem_lo)
    s_rem_f = g.rem_hi.to(_F64) + _u32(g.rem_lo).to(_F64) * (2.0**-32)
    s_burst = _combine(g.burst_hi, g.burst_lo)

    r_algo = (r_algo != 0).to(_I64)
    greg = (r_beh & _GREG) != 0
    rst = (r_beh & _RESET) != 0

    live = s_occ & ~((s_inv != 0) & (s_inv < now)) & (s_exp >= now)
    same = live & (s_algo == r_algo)
    is_tok = r_algo == _TOKEN

    p_tok_reset = same & is_tok & rst
    p_tok_ex = same & is_tok & ~rst
    p_leak_ex = same & ~is_tok
    p_tok_new = ~same & is_tok
    p_leak_new = ~same & ~is_tok

    zero = torch.zeros_like(r_limit)

    # ---------------- token bucket, existing item
    te_rem0 = torch.where(
        s_limit != r_limit, torch.clamp(s_rem + (r_limit - s_limit), min=0), s_rem
    )
    dur_changed = s_dur != r_dur
    te_new_exp = torch.where(greg, r_gexp, s_t0 + r_dur)
    te_renew = dur_changed & (te_new_exp <= now)
    te_exp = torch.where(dur_changed, torch.where(te_renew, now + r_dur, te_new_exp), s_exp)
    te_created = torch.where(te_renew, now, s_t0)
    te_rem_store = torch.where(te_renew, r_limit, te_rem0)

    te_q = r_hits == 0
    te_e = (te_rem0 == 0) & (r_hits > 0)
    te_x = te_rem_store == r_hits
    te_o = r_hits > te_rem_store

    te_rem_out = te_rem_store - r_hits
    te_rem_out = torch.where(te_o, te_rem_store, te_rem_out)
    te_rem_out = torch.where(te_x, zero, te_rem_out)
    te_rem_out = torch.where(te_e, te_rem_store, te_rem_out)
    te_rem_out = torch.where(te_q, te_rem_store, te_rem_out)

    te_resp_rem = te_rem_store - r_hits
    te_resp_rem = torch.where(te_o, te_rem0, te_resp_rem)
    te_resp_rem = torch.where(te_x, zero, te_resp_rem)
    te_resp_rem = torch.where(te_e, te_rem0, te_resp_rem)
    te_resp_rem = torch.where(te_q, te_rem0, te_resp_rem)

    over = torch.full_like(s_status, _OVER)
    under = torch.full_like(s_status, _UNDER)
    te_resp_status = torch.where(te_q, s_status, torch.where(te_e | (~te_x & te_o), over, s_status))
    te_status_store = torch.where(te_e & ~te_q, over, s_status)

    # ---------------- token bucket, new item
    tn_exp = torch.where(greg, r_gexp, now + r_dur)
    tn_over = r_hits > r_limit
    tn_rem = torch.where(tn_over, r_limit, r_limit - r_hits)
    tn_resp_status = torch.where(tn_over, over, under)

    # ---------------- leaky bucket shared
    burst_eff = torch.where(r_burst == 0, r_limit, r_burst)
    limit_pos = r_limit > 0
    lk_d = torch.where(greg, r_gdur, r_dur)
    rate_zero = limit_pos & (lk_d == 0)
    lk_rate = lk_d.to(_F64) / torch.where(limit_pos, r_limit, torch.ones_like(r_limit)).to(_F64)
    lk_rate = torch.where(limit_pos, lk_rate, torch.zeros_like(lk_rate))
    lk_rate_i = f64_to_i64(lk_rate)
    burst_f = burst_eff.to(_F64)

    # ---------------- leaky bucket, existing item
    le_rem = torch.where(rst, burst_f, s_rem_f)
    le_rem = torch.where((s_burst != burst_eff) & (burst_eff > f64_to_i64(le_rem)), burst_f, le_rem)
    le_eff_dur = torch.where(greg, r_gexp - now, r_dur)
    le_exp = torch.where(r_hits != 0, now + le_eff_dur, s_exp)

    elapsed = (now - s_t0).to(_F64)
    rate_pos = limit_pos & ~rate_zero
    le_leak = elapsed / torch.where(rate_pos, lk_rate, torch.ones_like(lk_rate))
    le_leak = torch.where(rate_pos, le_leak, torch.zeros_like(le_leak))
    leak_inf = rate_zero & (elapsed > 0)
    leak_applies = (f64_to_i64(le_leak) > 0) | leak_inf
    le_rem = torch.where(leak_applies, le_rem + le_leak, le_rem)
    le_rem = torch.where(leak_inf, burst_f, le_rem)
    le_t0 = torch.where(leak_applies, now.expand_as(s_t0), s_t0)
    le_rem = torch.where(f64_to_i64(le_rem) > burst_eff, burst_f, le_rem)

    le_rem_i = f64_to_i64(le_rem)
    le_reset0 = now + (r_limit - le_rem_i) * lk_rate_i

    le_e = (le_rem_i == 0) & (r_hits > 0)
    le_x = le_rem_i == r_hits
    le_o = r_hits > le_rem_i
    le_q = r_hits == 0

    le_consume = le_rem - r_hits.to(_F64)
    le_rem_out = le_consume
    le_rem_out = torch.where(le_q, le_rem, le_rem_out)
    le_rem_out = torch.where(le_o, le_rem, le_rem_out)
    le_rem_out = torch.where(le_x, le_consume, le_rem_out)
    le_rem_out = torch.where(le_e, le_rem, le_rem_out)

    le_consume_i = f64_to_i64(le_consume)
    le_resp_rem = le_consume_i
    le_resp_rem = torch.where(le_q, le_rem_i, le_resp_rem)
    le_resp_rem = torch.where(le_o, le_rem_i, le_resp_rem)
    le_resp_rem = torch.where(le_x, zero, le_resp_rem)
    le_resp_rem = torch.where(le_e, le_rem_i, le_resp_rem)

    le_resp_status = torch.where(le_e | (~le_x & le_o), over, under)
    le_reset = now + (r_limit - le_consume_i) * lk_rate_i
    le_reset = torch.where(le_q, le_reset0, le_reset)
    le_reset = torch.where(le_o, le_reset0, le_reset)
    le_reset = torch.where(le_x, now + r_limit * lk_rate_i, le_reset)
    le_reset = torch.where(le_e, le_reset0, le_reset)

    # ---------------- leaky bucket, new item
    ln_dur = torch.where(greg, r_gexp - now, r_dur)
    ln_over = r_hits > burst_eff
    ln_rem = burst_eff - r_hits
    ln_resp_rem = torch.where(ln_over, zero, ln_rem)
    ln_rem_f = torch.where(ln_over, torch.zeros_like(burst_f), ln_rem.to(_F64))
    ln_resp_status = torch.where(ln_over, over, under)
    ln_reset = now + (r_limit - ln_resp_rem) * lk_rate_i

    # ---------------- combine paths (exactly one p_* holds per lane)
    def pick(tok_reset, tok_ex, tok_new, leak_ex, leak_new):
        out = leak_new
        out = torch.where(p_leak_ex, leak_ex, out)
        out = torch.where(p_tok_new, tok_new, out)
        out = torch.where(p_tok_ex, tok_ex, out)
        return torch.where(p_tok_reset, tok_reset, out)

    now_b = now.expand_as(r_limit)
    zf = torch.zeros_like(burst_f)
    resp_status = pick(under, te_resp_status, tn_resp_status, le_resp_status, ln_resp_status)
    resp_rem = pick(r_limit, te_resp_rem, tn_rem, le_resp_rem, ln_resp_rem)
    resp_reset = pick(zero, te_exp, tn_exp, le_reset, ln_reset)

    n_occ = (~p_tok_reset).to(_I64)
    n_rem = pick(zero, te_rem_out, tn_rem, zero, zero)
    n_rem_f = pick(zf, zf, zf, le_rem_out, ln_rem_f)
    n_dur = pick(r_dur, r_dur, r_dur, r_dur, ln_dur)
    n_t0 = pick(zero, te_created, now_b, le_t0, now_b)
    n_exp = pick(zero, te_exp, tn_exp, le_exp, now + ln_dur)
    n_burst = pick(zero, zero, zero, burst_eff, burst_eff)
    n_status = pick(under, te_status_store, under, under, under)

    # ---------------- encode_slot_values (update always clears invalid_at)
    t0c = n_t0.clamp(0, TS_CLAMP_MAX)
    expc = n_exp.clamp(0, TS_CLAMP_MAX)
    durc = n_dur.clamp(0, TS_CLAMP_MAX)
    w_meta = pack_meta(n_occ, r_algo, n_status, t0c, zero)
    w_hi2 = pack_hi2(expc, durc)
    w_floor = torch.floor(n_rem_f)
    remf_hi = f64_to_i32(w_floor.clamp(-(2.0**31), 2.0**31 - 1))
    remf_lo = f64_to_u32((n_rem_f - w_floor) * (2.0**32))
    leaky = r_algo == 1
    words = (
        w_meta,
        w_hi2,
        t0c,
        expc,
        zero,
        durc,
        r_limit >> 32,
        r_limit,
        torch.where(leaky, remf_hi, n_rem >> 32),
        torch.where(leaky, remf_lo, n_rem),
        n_burst >> 32,
        n_burst,
    )
    return words, resp_status, resp_rem, resp_reset


def check_pin(pin: torch.Tensor) -> None:
    if pin.dtype != _I32 or pin.dim() != 2 or pin.shape[0] != PACKED_IN_ROWS:
        raise ValueError(
            f"pin must be int32 [{PACKED_IN_ROWS}, W]; got {pin.dtype} {list(pin.shape)}"
        )


def check_state(state: BucketState) -> int:
    """Validate a state's columns; returns its capacity."""
    cap = state.meta.shape[0]
    for name, col in zip(BucketState._fields, state):
        if col.dtype != _I32 or col.dim() != 1 or col.shape[0] != cap:
            raise ValueError(f"state.{name} must be int32 [{cap}]")
        if col.device != state.meta.device:
            raise ValueError(f"state.{name} is on {col.device}, meta on {state.meta.device}")
    return cap


def fused_step_reference(state: BucketState, pin: torch.Tensor) -> torch.Tensor:
    """The plain fused decision step: (state, pin [16, W]) → pout
    [5, W] int32, with `state` updated IN PLACE.  Padding lanes (slot
    outside [0, cap)) read zero words, are computed like any lane, and
    store nothing — the reference's fill/drop gather/scatter."""
    check_pin(pin)
    check_state(state)
    return _step_lanes(state, pin, _combine(pin[0, 0], pin[0, 1]))


def _step_lanes(state: BucketState, pin: torch.Tensor, now: torch.Tensor) -> torch.Tensor:
    """The fused step over the lanes of `pin` (rows 1-15 read; row 0 is
    not) at `now` (int64 scalar tensor)."""
    cap = state.meta.shape[0]
    slot = pin[1].to(_I64)
    valid = (slot >= 0) & (slot < cap)
    idx = torch.where(valid, slot, torch.zeros_like(slot))
    g = BucketState(
        *(torch.where(valid, col[idx], torch.zeros_like(col[idx])) for col in state)
    )
    words, status, rem, reset = _update_lanes(
        g,
        valid,
        pin[2].to(_I64),
        pin[3].to(_I64),
        _row64(pin, 4, 5),
        _row64(pin, 6, 7),
        _row64(pin, 8, 9),
        _row64(pin, 10, 11),
        _row64(pin, 12, 13),
        _row64(pin, 14, 15),
        now,
    )
    dst = slot[valid]
    for col, w in zip(state, words):
        col[dst] = _low_word(w[valid])
    return torch.stack(
        [
            status.to(_I32),
            (rem >> 32).to(_I32),
            _low_word(rem),
            (reset >> 32).to(_I32),
            _low_word(reset),
        ]
    )


def clear_occupied_reference(meta: torch.Tensor, slots: torch.Tensor) -> None:
    """Eviction clear, plain version (reference `_clear_occupied_impl`
    :329): clear meta bit 0 at each slot in [0, cap), in place; other
    lanes (the `cap + lane` padding) are dropped.  Slots are unique."""
    s = slots.to(_I64)
    s = s[(s >= 0) & (s < meta.shape[0])]
    meta[s] = meta[s] & ~1


def check_rounds(pin, round_off, clear_off, clear_slots) -> int:
    """Shapes and dtypes of a multi-round call; returns R."""
    check_pin(pin)
    for name, t in (("round_off", round_off), ("clear_off", clear_off),
                    ("clear_slots", clear_slots)):
        if t.dtype != _I32 or t.dim() != 1:
            raise ValueError(f"{name} must be a 1-D int32 tensor")
    n_rounds = round_off.shape[0] - 1
    if n_rounds < 1 or clear_off.shape[0] != n_rounds + 1:
        raise ValueError("round_off and clear_off must both be int32 [R+1], R >= 1")
    if clear_slots.shape[0] < 1:
        raise ValueError("clear_slots must be int32 [C], C >= 1")
    return n_rounds


def multi_fused_step_reference(
    state: BucketState,
    pin: torch.Tensor,
    round_off: torch.Tensor,
    clear_off: torch.Tensor,
    clear_slots: torch.Tensor,
) -> torch.Tensor:
    """The plain multi-round step (reference `_multi_fused_core`
    :1071, with the engine's per-round clears): for r in 0..R-1, clear
    the occupied bit at round r's in-range clear slots, then run the
    fused step over round r's lanes at the header's `now`.  Returns
    pout int32 [5, L]; `state` is updated IN PLACE."""
    n_rounds = check_rounds(pin, round_off, clear_off, clear_slots)
    check_state(state)
    ro, co = round_off.tolist(), clear_off.tolist()
    width = pin.shape[1]
    if ro[0] != 0 or ro[-1] != width or any(b < a for a, b in zip(ro, ro[1:])):
        raise ValueError("round_off must rise from 0 to the pin's width")
    if co[0] != 0 or co[-1] > clear_slots.shape[0] or any(b < a for a, b in zip(co, co[1:])):
        raise ValueError("clear_off must rise from 0 to at most len(clear_slots)")
    now = _combine(pin[0, 0], pin[0, 1])
    pout = torch.empty((PACKED_OUT_ROWS, width), dtype=_I32, device=pin.device)
    for r in range(n_rounds):
        if co[r + 1] > co[r]:
            clear_occupied_reference(state.meta, clear_slots[co[r] : co[r + 1]])
        if ro[r + 1] > ro[r]:
            pout[:, ro[r] : ro[r + 1]] = _step_lanes(state, pin[:, ro[r] : ro[r + 1]], now)
    return pout
