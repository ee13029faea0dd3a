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


# A multi-round call carries R rounds one after another along the lanes
# of one pin.  Each round's lanes are sorted by slot and padded to a
# multiple of ROUND_ALIGN lanes (one warp; 128 B of each pin row), with
# the `cap + j` padding of pack_batch_host.  Row 0 of a round's first
# lanes is the round's header, as each pin of the reference's stacked
# [R, rows, W] scan input carries its own: `now` in the general format,
# `now` and the config scalars in the uniform one.  So rounds of
# different batches (the pump's queued submissions) can share a launch.
# R = 1 with a pow2 width is exactly pack_batch_host's buffer.
ROUND_ALIGN = 32


class PackedRounds(NamedTuple):
    """R rounds in one flat int32 host buffer laid out as
    [pin (rows·L) | round_off (R+1) | clear_off (R+1) | clear_slots (C)],
    so that one copy moves all of it; the array fields are views of
    `buf`.  Round r owns lanes [round_off[r], round_off[r+1]) and clears
    clear_slots[clear_off[r]:clear_off[r+1]] just before it runs.  `pin`
    has PACKED_IN_ROWS rows (general format) or UNIFORM_IN_ROWS."""

    buf: np.ndarray
    pin: np.ndarray  # int32 [rows, L]
    round_off: np.ndarray  # int32 [R+1]
    clear_off: np.ndarray  # int32 [R+1]
    clear_slots: np.ndarray  # int32 [C], C >= 1 (an out-of-range slot when none)
    lanes: np.ndarray  # int64 [n]: the lane of each real request, in input order
    widest: int  # lanes of the widest round


def split_rounds(flat, width: int, n_rounds: int, rows: int = PACKED_IN_ROWS):
    """(pin [rows, L], round_off, clear_off, clear_slots) views of a flat
    buffer laid out as `PackedRounds.buf` (numpy array or tensor)."""
    a = rows * width
    b = a + n_rounds + 1
    c = b + n_rounds + 1
    return flat[:a].reshape(rows, width), flat[a:b], flat[b:c], flat[c:]


def _now_words(now_ms: int):
    return np.int32(np.int64(now_ms) >> 32), np.int64(now_ms).astype(np.int32)


def _lay_out_rounds(now_ms, capacity, counts, slot_sorted, clears, align, rows, header):
    """The shared layout of `pack_rounds_host` and
    `pack_uniform_rounds_host`: lanes, padding slots, per-round headers
    (`header`, int32 words for row 0 of each non-empty round) and the
    clears' CSR arrays.  Returns the PackedRounds with the request rows
    still zero."""
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
    buf = np.zeros(rows * width + 2 * (n_rounds + 1) + n_clear, dtype=np.int32)
    pin, v_round, v_clear, v_slots = split_rounds(buf, width, n_rounds, rows)
    starts = round_off[:-1][widths > 0]
    for k, word in enumerate(header):
        pin[0, starts + k] = word
    # padding: capacity + j for the round's j-th padding lane
    pad_start = np.repeat(round_off[:-1] + counts, widths)
    pin[1] = capacity + (np.arange(width, dtype=np.int64) - pad_start)
    pin[1, lanes] = slot_sorted
    v_round[:] = round_off
    v_clear[0] = 0
    np.cumsum(clear_counts, out=v_clear[1:])
    if sum(clear_counts):
        v_slots[:] = np.concatenate([np.asarray(c, dtype=np.int32) for c in clears])
    else:
        v_slots[:] = capacity  # out of range: clears nothing
    return PackedRounds(buf, pin, v_round, v_clear, v_slots, lanes,
                        int(widths.max(initial=0)))


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
    packed = _lay_out_rounds(now_ms, capacity, counts, slot_sorted, clears, align,
                             PACKED_IN_ROWS, _now_words(now_ms))
    pin, lanes = packed.pin, packed.lanes
    algo, behavior, *wide = cols
    pin[2, lanes] = algo
    pin[3, lanes] = behavior
    for row, col in zip(range(4, PACKED_IN_ROWS, 2), wide):
        c = np.asarray(col).astype(np.int64, copy=False)
        pin[row, lanes] = (c >> 32).astype(np.int32)
        pin[row + 1, lanes] = c.astype(np.int32)  # low-word bit pattern
    return packed


def unpack_out_host(arr: np.ndarray, m: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Packed output rows → (status int32[m], remaining i64[m], reset
    i64[m]) (reference bucket_kernel.py:1031)."""
    status = arr[0, :m]
    rem = (arr[1, :m].astype(np.int64) << 32) | (arr[2, :m].astype(np.int64) & _LO)
    reset = (arr[3, :m].astype(np.int64) << 32) | (arr[4, :m].astype(np.int64) & _LO)
    return status, rem, reset


# ---------------------------------------------------------------------------
# The uniform narrow format (reference bucket_kernel.py:1098-1216).
#
# A batch with one limit config across it ships only the slot per lane:
#
#   pin  int32 [2, W]: row 0 header [now_hi, now_lo, algo, behavior,
#        hits_hi, hits_lo, limit, duration_lo, burst, duration_hi],
#        row 1 slot (sorted; padding = cap + lane)
#   pout int32 [2, W]: row 0 (status << 31) | (remaining & 0x7FFFFFFF),
#        row 1 reset_time - now
#
# The engine's gate (`_uniform_params`) keeps the format to configs it
# represents: no Gregorian or RESET_REMAINING, limit / burst / duration
# below 2^31.

UNIFORM_IN_ROWS = 2
UNIFORM_OUT_ROWS = 2
UNIFORM_HEADER = 10


def uniform_header(now_ms: int, algo: int, behavior: int, hits: int, limit: int,
                   duration: int, burst: int) -> np.ndarray:
    """Row 0's header words of a uniform round (int32)."""
    return np.array([
        np.int64(now_ms) >> 32, np.int64(now_ms).astype(np.int32), algo, behavior,
        np.int64(hits) >> 32, np.int64(hits).astype(np.int32), limit,
        np.int64(duration).astype(np.int32), burst, np.int64(duration) >> 32,
    ], dtype=np.int64).astype(np.int32)


def pack_uniform_host(
    size: int,
    now_ms: int,
    capacity: int,
    slot_sorted: np.ndarray,  # int32 [m] sorted ascending
    algo: int,
    behavior: int,
    hits: int,
    limit: int,
    duration: int,
    burst: int,
) -> np.ndarray:
    """The [2, size] uniform pin of one round (reference :1122)."""
    m = len(slot_sorted)
    out = np.zeros((UNIFORM_IN_ROWS, size), dtype=np.int32)
    out[0, :UNIFORM_HEADER] = uniform_header(now_ms, algo, behavior, hits, limit,
                                             duration, burst)
    out[1, :m] = slot_sorted
    if size > m:
        out[1, m:] = np.arange(capacity, capacity + (size - m), dtype=np.int64).astype(
            np.int32
        )
    return out


def pack_uniform_rounds_host(
    now_ms: int,
    capacity: int,
    counts,  # int [R]: real lanes of each round
    slot_sorted: np.ndarray,  # int32 [n], round-major, ascending within each round
    uniform: tuple,  # (algo, behavior, hits, limit, duration, burst)
    clears,  # R sequences: the slots to clear before each round
    align: int = ROUND_ALIGN,
) -> PackedRounds:
    """A batch's rounds in the uniform format: `pack_rounds_host`'s
    layout with UNIFORM_IN_ROWS rows, each round's row 0 starting with
    the uniform header."""
    return _lay_out_rounds(now_ms, capacity, counts, slot_sorted, clears, align,
                           UNIFORM_IN_ROWS, uniform_header(now_ms, *uniform))


def unpack_uniform_out_host(
    arr: np.ndarray, m: int, now_ms: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Narrow output rows → (status, remaining, reset) like
    unpack_out_host (reference :1209)."""
    u = arr[0, :m].view(np.uint32)
    status = (u >> 31).astype(np.int32)
    rem = (u & 0x7FFFFFFF).astype(np.int64)
    reset = arr[1, :m].astype(np.int64) + now_ms
    return status, rem, reset


# ---------------------------------------------------------------------------
# The collapsed duplicate-segment step (reference bucket_kernel.py:1277-1475).
#
# When every occurrence of a key in a batch carries the same request
# fields, the m-1 occurrences after the first see an existing item with
# unchanged config and no elapsed time, so each either consumes `h` or
# is rejected: with R1 the remaining after the first application, the
# extras admit a2 = clip(R1 // h, 0, m-1) (all of them for h <= 0);
# extra p (0-based) answers R1-(p+1)h and the first application's status
# when p < a2, else R1-a2·h and OVER; the bucket stores R1-a2·h, and the
# token bucket's sticky status flips to OVER iff an extra saw exactly 0
# (h > 0, R1-a2·h == 0, a2 < m-1).  Leaky buckets work the same over
# floor(rem_f), with reset_time = now + (limit - rem)·rate.
#
# Packed layout (int32 [COLLAPSED_IN_ROWS, W]):
#   row 0       header [now_hi, now_lo]
#   rows 1-16   SEGMENT level (first S lanes real; padding = m 0 and
#               ascending out-of-range slots): slot, m, algo, behavior,
#               hits, limit, duration, burst, greg_dur, greg_exp
#               (64-bit as hi/lo pairs)
#   row 17      lane → segment index;  row 18  lane → position in segment
# Output rows are PACKED_OUT_ROWS, in lane order.

COLLAPSED_IN_ROWS = 19


def token_extras_host(R1: int, h: int, extras: int) -> tuple[int, int, bool]:
    """Host-scalar twin of the token branch of the collapsed step
    (reference :1396): `extras` further occurrences each consuming `h`
    after the first application left R1 admit a2 = clip(R1 // h, 0,
    extras) (all, for h <= 0), leaving rem2 = R1 - a2*h; the sticky
    status flips OVER iff an extra saw remaining == 0.  Returns (a2,
    rem2, sticky_over)."""
    if h > 0:
        a2 = min(max(R1 // h, 0), extras)
    else:
        a2 = extras
    rem2 = R1 - a2 * h
    sticky = h > 0 and rem2 == 0 and a2 < extras
    return a2, rem2, sticky


def pack_collapsed_host(
    size: int,
    now_ms: int,
    capacity: int,
    uniq_slots: np.ndarray,  # int32 [S] sorted unique
    counts: np.ndarray,  # int64 [S]
    seg_fields: tuple,  # (algo, behavior, hits, limit, duration, burst,
    #                      greg_dur, greg_exp) per segment, [S]
    seg_idx: np.ndarray,  # int32 [m_lanes]
    pos: np.ndarray,  # int32 [m_lanes]
) -> np.ndarray:
    """Host packer for the collapsed step (reference :1428; layout
    above)."""
    s_count = len(uniq_slots)
    n_lanes = len(seg_idx)
    out = np.zeros((COLLAPSED_IN_ROWS, size), dtype=np.int32)
    out[0, :2] = _now_words(now_ms)
    out[1, :s_count] = uniq_slots
    if size > s_count:
        out[1, s_count:] = np.arange(
            capacity, capacity + (size - s_count), dtype=np.int64
        ).astype(np.int32)
    out[2, :s_count] = counts.astype(np.int32)
    algo, behavior, *wide = seg_fields
    out[3, :s_count] = algo
    out[4, :s_count] = behavior
    for row, col in zip(range(5, 17, 2), wide):
        c = np.asarray(col).astype(np.int64, copy=False)
        out[row, :s_count] = (c >> 32).astype(np.int32)
        out[row + 1, :s_count] = c.astype(np.int32)  # low-word bit pattern
    out[17, :n_lanes] = seg_idx
    # Padding lanes point at the last padding segment (m = 0, harmless).
    if size > n_lanes:
        out[17, n_lanes:] = size - 1
    out[18, :n_lanes] = pos
    return out


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
    line transcription of the reference's `update_lanes` (:514).
    Returns (SlotValues to store, status, remaining, reset)."""
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

    vals = SlotValues(
        occ=n_occ, algo=r_algo, status=n_status, limit=r_limit, remaining=n_rem,
        rem_f=n_rem_f, duration=n_dur, t0=n_t0, expire=n_exp, burst=n_burst,
    )
    return vals, resp_status, resp_rem, resp_reset


class SlotValues(NamedTuple):
    """Per-lane values to store after an update (reference `SlotValues`
    :744): int64 tensors, `rem_f` float64 (the leaky 32.32 source)."""

    occ: torch.Tensor
    algo: torch.Tensor
    status: torch.Tensor
    limit: torch.Tensor
    remaining: torch.Tensor
    rem_f: torch.Tensor
    duration: torch.Tensor
    t0: torch.Tensor
    expire: torch.Tensor
    burst: torch.Tensor


def _encode_values(v: SlotValues):
    """The stored words (int64, BucketState field order) of updated
    slots: reference `encode_slot_values` (:781).  An update always
    clears invalid_at."""
    zero = torch.zeros_like(v.limit)
    t0c = v.t0.clamp(0, TS_CLAMP_MAX)
    expc = v.expire.clamp(0, TS_CLAMP_MAX)
    durc = v.duration.clamp(0, TS_CLAMP_MAX)
    w_meta = pack_meta(v.occ, v.algo, v.status, t0c, zero)
    w_hi2 = pack_hi2(expc, durc)
    w_floor = torch.floor(v.rem_f)
    remf_hi = f64_to_i32(w_floor.clamp(-(2.0**31), 2.0**31 - 1))
    remf_lo = f64_to_u32((v.rem_f - w_floor) * (2.0**32))
    leaky = v.algo == 1
    return (
        w_meta,
        w_hi2,
        t0c,
        expc,
        zero,
        durc,
        v.limit >> 32,
        v.limit,
        torch.where(leaky, remf_hi, v.remaining >> 32),
        torch.where(leaky, remf_lo, v.remaining),
        v.burst >> 32,
        v.burst,
    )


def check_pin(pin: torch.Tensor, rows: int = PACKED_IN_ROWS) -> None:
    if pin.dtype != _I32 or pin.dim() != 2 or pin.shape[0] != rows:
        raise ValueError(f"pin must be int32 [{rows}, W]; got {pin.dtype} {list(pin.shape)}")


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


def _step_fields(state: BucketState, slot: torch.Tensor, fields, now: torch.Tensor):
    """Gather → update → store over lanes with request `fields` (algo,
    behavior, hits, limit, duration, burst, greg_dur, greg_exp; int64)
    at `now`: the reference's `_apply_core`.  Returns (status,
    remaining, reset) per lane."""
    cap = state.meta.shape[0]
    slot = slot.to(_I64)
    valid = (slot >= 0) & (slot < cap)
    idx = torch.where(valid, slot, torch.zeros_like(slot))
    g = BucketState(
        *(torch.where(valid, col[idx], torch.zeros_like(col[idx])) for col in state)
    )
    vals, status, rem, reset = _update_lanes(g, valid, *fields, now)
    dst = slot[valid]
    for col, w in zip(state, _encode_values(vals)):
        col[dst] = _low_word(w[valid])
    return status, rem, reset


def _pack_out(status, rem, reset) -> torch.Tensor:
    return torch.stack(
        [status.to(_I32), (rem >> 32).to(_I32), _low_word(rem), (reset >> 32).to(_I32),
         _low_word(reset)]
    )


def _step_lanes(state: BucketState, pin: torch.Tensor, now: torch.Tensor) -> torch.Tensor:
    """The fused step over the lanes of `pin` (rows 1-15 read; row 0 is
    not) at `now` (int64 scalar tensor)."""
    fields = (pin[2].to(_I64), pin[3].to(_I64)) + tuple(
        _row64(pin, r, r + 1) for r in range(4, PACKED_IN_ROWS, 2)
    )
    return _pack_out(*_step_fields(state, pin[1], fields, now))


def clear_occupied_reference(meta: torch.Tensor, slots: torch.Tensor) -> None:
    """Eviction clear, plain version (reference `_clear_occupied_impl`
    :329): clear meta bit 0 at each slot in [0, cap), in place; other
    lanes (the `cap + lane` padding) are dropped.  Slots are unique."""
    s = slots.to(_I64)
    s = s[(s >= 0) & (s < meta.shape[0])]
    meta[s] = meta[s] & ~1


def check_rounds(pin, round_off, clear_off, clear_slots, rows: int = PACKED_IN_ROWS) -> int:
    """Shapes and dtypes of a multi-round call; returns R."""
    check_pin(pin, rows)
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


def check_collapsed(pin) -> None:
    """The layout kernel K3 relies on (csrc/collapsed_step.cu), which
    `pack_collapsed_host` gives: row 17 (a lane's segment) never
    decreases; segment s's lanes are contiguous, row 18 (position)
    running 0 .. m_s - 1, row 2 holding m_s, and segments 0 .. S-1 all
    have lanes; segment slots (row 1) ascend; the padding lanes come last
    and point at column W - 1 (m = 0) at position 0.  `pin` is int32
    [19, W], a tensor or numpy array; raises ValueError at the first
    breach."""
    p = pin.cpu().numpy() if isinstance(pin, torch.Tensor) else np.asarray(pin)
    if p.dtype != np.int32 or p.ndim != 2 or p.shape[0] != COLLAPSED_IN_ROWS:
        raise ValueError(f"pin must be int32 [{COLLAPSED_IN_ROWS}, W]")
    width = p.shape[1]
    if width == 0:
        return
    seg, pos, m = (p[r].astype(np.int64) for r in (17, 18, 2))
    if seg.min() < 0 or seg.max() >= width:
        raise ValueError("row 17 points outside the pin")
    if (np.diff(seg) < 0).any():
        raise ValueError("row 17 decreases: segments interleave")
    pad = (seg == width - 1) & (m[width - 1] == 0)
    if (pos[pad] != 0).any():
        raise ValueError("a padding lane is not at position 0")
    real = seg[~pad]
    n_seg = int(real[-1]) + 1 if len(real) else 0
    counts = np.bincount(real, minlength=n_seg)
    if (counts == 0).any():
        raise ValueError("a segment before the last has no lanes")
    if not np.array_equal(counts, m[:n_seg]):
        raise ValueError("row 2 does not hold each segment's lane count")
    first = np.cumsum(counts) - counts
    if not np.array_equal(pos[~pad], np.arange(len(real)) - np.repeat(first, counts)):
        raise ValueError("row 18 does not run 0 .. m-1 within each segment")
    if (np.diff(p[1, :n_seg].astype(np.int64)) <= 0).any():
        raise ValueError("segment slots do not ascend")


def _run_rounds(state, pin, round_off, clear_off, clear_slots, rows, out_rows, step):
    """The round loop shared by the plain multi-round steps: for r in
    0..R-1, clear round r's in-range clear slots, then `step(state, pin
    columns of round r)` writes the round's output columns."""
    check_rounds(pin, round_off, clear_off, clear_slots, rows)
    check_state(state)
    ro, co = round_off.tolist(), clear_off.tolist()
    width = pin.shape[1]
    if ro[0] != 0 or ro[-1] != width or any(b < a for a, b in zip(ro, ro[1:])):
        raise ValueError("round_off must rise from 0 to the pin's width")
    if co[0] != 0 or co[-1] > clear_slots.shape[0] or any(b < a for a, b in zip(co, co[1:])):
        raise ValueError("clear_off must rise from 0 to at most len(clear_slots)")
    pout = torch.empty((out_rows, width), dtype=_I32, device=pin.device)
    for r in range(len(ro) - 1):
        if co[r + 1] > co[r]:
            clear_occupied_reference(state.meta, clear_slots[co[r] : co[r + 1]])
        if ro[r + 1] > ro[r]:
            pout[:, ro[r] : ro[r + 1]] = step(state, pin[:, ro[r] : ro[r + 1]])
    return pout


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
    fused step over round r's lanes at the `now` of the round's header.
    Returns pout int32 [5, L]; `state` is updated IN PLACE."""

    def step(st, seg):
        return _step_lanes(st, seg, _combine(seg[0, 0], seg[0, 1]))

    return _run_rounds(state, pin, round_off, clear_off, clear_slots, PACKED_IN_ROWS,
                       PACKED_OUT_ROWS, step)


def _uniform_lanes(state: BucketState, pin: torch.Tensor) -> torch.Tensor:
    """One uniform round (reference `_uniform_step_core` :1161): the
    header's scalars broadcast over the lanes, greg fields zero; pout
    [(status << 31) | (rem & 0x7FFFFFFF), reset - now]."""
    hdr = pin[0, :UNIFORM_HEADER].to(_I64)
    now = _combine(pin[0, 0], pin[0, 1])
    w = pin.shape[1]

    def bc(x):
        return x.expand(w).contiguous()

    zeros = torch.zeros(w, dtype=_I64, device=pin.device)
    fields = (
        bc(hdr[2]), bc(hdr[3]), bc(_combine(pin[0, 4], pin[0, 5])), bc(hdr[6]),
        bc(_combine(pin[0, 9], pin[0, 7])), bc(hdr[8]), zeros, zeros,
    )
    status, rem, reset = _step_fields(state, pin[1], fields, now)
    return torch.stack([_low_word((status << 31) | (rem & 0x7FFFFFFF)), _low_word(reset - now)])


def multi_uniform_step_reference(
    state: BucketState,
    pin: torch.Tensor,
    round_off: torch.Tensor,
    clear_off: torch.Tensor,
    clear_slots: torch.Tensor,
) -> torch.Tensor:
    """The plain uniform multi-round step (reference `_multi_uniform_core`
    :1198, with the engine's per-round clears): pin int32 [2, L] laid out
    as `pack_uniform_rounds_host`, each round's header in row 0 of its
    first lanes.  Returns pout int32 [2, L]; `state` is updated IN
    PLACE."""
    return _run_rounds(state, pin, round_off, clear_off, clear_slots, UNIFORM_IN_ROWS,
                       UNIFORM_OUT_ROWS, _uniform_lanes)


def collapsed_step_reference(state: BucketState, pin: torch.Tensor) -> torch.Tensor:
    """The plain collapsed step (reference `_collapsed_values` :1314 +
    `_scatter_values`): pin int32 [19, W] as `pack_collapsed_host` lays it
    out → pout int32 [5, W] in lane order; `state` is updated IN PLACE
    with each segment's final words.  One full application per segment
    lane, the closed form for its m-1 extras, lane answers gathered by
    segment index (clamped into [0, W))."""
    check_pin(pin, COLLAPSED_IN_ROWS)
    cap = check_state(state)
    now = _combine(pin[0, 0], pin[0, 1])
    slot = pin[1].to(_I64)
    m = pin[2].to(_I64)
    s_algo = pin[3].to(_I64)
    s_beh = pin[4].to(_I64)
    s_hits, s_limit, s_dur, s_burst, s_gdur, s_gexp = (
        _row64(pin, r, r + 1) for r in range(5, 17, 2)
    )
    seg = pin[17].to(_I64).clamp(0, pin.shape[1] - 1)
    pos = pin[18].to(_I64)

    # First application per segment: the full bucket update.
    valid = (slot >= 0) & (slot < cap)
    idx = torch.where(valid, slot, torch.zeros_like(slot))
    g = BucketState(
        *(torch.where(valid, col[idx], torch.zeros_like(col[idx])) for col in state)
    )
    vals, st1, rem1, rst1 = _update_lanes(g, valid, s_algo, s_beh, s_hits, s_limit,
                                          s_dur, s_burst, s_gdur, s_gexp, now)

    extras = torch.clamp(m - 1, min=0)
    h = s_hits
    h_safe = torch.clamp(h, min=1)
    is_tok = s_algo == _TOKEN

    def clip_extras(x):
        return torch.minimum(torch.clamp(x, min=0), extras)

    # Token extras.
    R1 = vals.remaining
    a2_tok = torch.where(h > 0, clip_extras(torch.div(R1, h_safe, rounding_mode="floor")),
                         extras)
    rem2_tok = R1 - a2_tok * h
    sticky_over = (h > 0) & (rem2_tok == 0) & (a2_tok < extras)
    status2 = torch.where(sticky_over & is_tok, torch.full_like(vals.status, _OVER),
                          vals.status)

    # Leaky extras (over the floor of the fixed-point remaining).
    W1f = vals.rem_f
    W1 = f64_to_i64(W1f)
    a2_lk = torch.where(h > 0, clip_extras(torch.div(W1, h_safe, rounding_mode="floor")),
                        extras)
    rem2_lkf = W1f - (a2_lk * h).to(_F64)
    vals2 = vals._replace(
        remaining=torch.where(is_tok, rem2_tok, vals.remaining),
        status=status2,
        rem_f=torch.where(is_tok, vals.rem_f, rem2_lkf),
    )

    # Leaky reset slope (the update's lk_rate_i).
    lk_d = torch.where((s_beh & _GREG) != 0, s_gdur, s_dur)
    limit_pos = s_limit > 0
    lk_rate = lk_d.to(_F64) / torch.where(limit_pos, s_limit, torch.ones_like(s_limit)).to(_F64)
    lk_rate_i = f64_to_i64(torch.where(limit_pos, lk_rate, torch.zeros_like(lk_rate)))

    # Lane-level responses.
    def gs(x):
        return x[seg]

    p = torch.clamp(pos - 1, min=0)
    first = pos == 0
    l_tok = gs(is_tok)
    l_h = gs(h)
    over = torch.full_like(p, _OVER)

    acc_tok = p < gs(a2_tok)
    rem_tok = torch.where(acc_tok, gs(R1) - (p + 1) * l_h, gs(rem2_tok))
    st_tok = torch.where(acc_tok, gs(vals.status), over)
    rst_tok = gs(vals.expire)

    acc_lk = p < gs(a2_lk)
    rem_lk = torch.where(acc_lk, gs(W1) - (p + 1) * l_h, gs(W1 - a2_lk * h))
    st_lk = torch.where(acc_lk, torch.full_like(p, _UNDER), over)
    rst_lk = now + (gs(s_limit) - rem_lk) * gs(lk_rate_i)

    o_status = torch.where(first, gs(st1), torch.where(l_tok, st_tok, st_lk))
    o_rem = torch.where(first, gs(rem1), torch.where(l_tok, rem_tok, rem_lk))
    o_reset = torch.where(first, gs(rst1), torch.where(l_tok, rst_tok, rst_lk))

    dst = slot[valid]
    for col, w in zip(state, _encode_values(vals2)):
        col[dst] = _low_word(w[valid])
    return _pack_out(o_status, o_rem, o_reset)
