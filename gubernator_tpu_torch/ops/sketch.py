"""Count-min-sketch rate limiting: approximate decisions for any number of
keys in fixed memory (Behavior.SKETCH).

Port of `gubernator_tpu/ops/sketch.py`.  The state is int32 counts
`[2, depth, width]` on the device: two planes, the current window and
the previous one, read as a sliding window by interpolating the previous
plane's count with the elapsed fraction of the current window (Q16).
The window index `epoch` and the current plane `cur` live on the host
(the reference mirrors them there too, :225-229).  Errors are one-sided:
collisions only inflate an estimate, and counters saturate at the int32
bounds instead of wrapping.

The host hashes each key once (fnv1a-64, `hashing.py`) and derives the
`depth` row indexes by Kirsch-Mitzenmacher double hashing, then
pre-combines each row's duplicates (sorted unique indexes and their
exact int64 sums clamped to int32) into one packed int32 pin
`[2 + 3·depth, size]`, `size` = 64 doubled until it holds the batch:

  row 0          header: [epoch_hi, epoch_lo, frac_q16, 0, ...]
  row 1          hits (clamped to int32)
  row 2 + 3r     row r's unique indexes; padding holds width + j
  row 3 + 3r     row r's summed hits (0 on padding)
  row 4 + 3r     each lane's position in row r's unique indexes

* `sketch_step(counts, pin, cur)` — kernel K7 (csrc/sketch.cu), the port
  of `_sketch_step_impl` (:99): add each unique entry's hits to its cell
  of plane `cur` (int64 add, clamped to int32), then each lane's estimate
  `min_r (prev · (65536 − frac) // 65536 + new)`, with FLOOR division
  (a negative previous count rounds down, as the reference's `//` does).
  Returns int32 [2, size], the int64 estimate's hi and lo words;
  `counts` is updated in place.  `plan_sketch_step(depth, size)` picks
  its form from (depth, size) alone (`SketchPlan`): the block form, ONE
  launch of one block that keeps the row estimates in shared memory, while
  depth·size <= 1024 (256 lanes at depth 4); above that the pair form,
  two launches (adds into an int64 scratch, then the minimum over rows),
  the second a programmatic dependent launch of the first.  Bound: bytes
  (0.02–0.03 µs for 1000 keys at depth 4), so launch floors are the cost;
  csrc/sketch.cu says what was tried (clusters of 2–16 blocks, kept in
  scripts/torch_k7_cluster.py).
* `sketch_rotate(counts, cur, delta)` — kernel K8, the port of `_rotate`
  (:63): the window moved `delta` epochs forward; one step zeroes the
  other plane and makes it current, a gap of two or more zeroes both
  planes and keeps `cur`; `delta <= 0` changes nothing.  Returns the new
  `cur`.

A CUDA tensor goes to the kernel (no fallback: a plan the launcher
refuses, or a refused launch, raises); a CPU
tensor to the plain `sketch_step_reference` / `rotate_reference`.
Launches count in `ops.fused_step.launches` ("sketch_step": one per
wrapper call, whichever its form; "sketch_rotate"), and K7's calls by
form in `ops.fused_step.forms["sketch_step"]` ("block": one device
launch; "pair": two).
"""

from __future__ import annotations

import threading
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from gubernator_tpu_torch.hashing import fnv1a_64_batch, pack_keys
from gubernator_tpu_torch.ops import native_build
from gubernator_tpu_torch.ops.bucket_kernel import _low_word
from gubernator_tpu_torch.ops.fused_step import (check_cuda, forms, launches, resolve_device,
                                                 stream_of)

_I32_MIN, _I32_MAX = -(2**31), 2**31 - 1
Q16 = 65536
# The multiplier of the second hash (reference `SketchLimiter(seed=)`'s default).
SEED = 0x9E3779B97F4A7C15


def pin_rows(depth: int) -> int:
    return 2 + 3 * depth


def check_counts(counts: torch.Tensor) -> Tuple[int, int]:
    """Validate the sketch planes; returns (depth, width)."""
    if counts.dtype != torch.int32 or counts.dim() != 3 or counts.shape[0] != 2:
        raise ValueError(f"counts must be int32 [2, depth, width]; got {counts.dtype} "
                         f"{list(counts.shape)}")
    return counts.shape[1], counts.shape[2]


def check_sketch_pin(counts: torch.Tensor, pin: torch.Tensor, cur: int) -> Tuple[int, int, int]:
    """Validate a step's inputs; returns (depth, width, size)."""
    depth, width = check_counts(counts)
    if pin.dtype != torch.int32 or pin.dim() != 2 or pin.shape[0] != pin_rows(depth) \
            or pin.shape[1] < 1:
        raise ValueError(f"pin must be int32 [{pin_rows(depth)}, size >= 1]; got {pin.dtype} "
                         f"{list(pin.shape)}")
    if pin.device != counts.device:
        raise ValueError(f"pin is on {pin.device}, counts on {counts.device}")
    if cur not in (0, 1):
        raise ValueError(f"cur must be 0 or 1; got {cur}")
    return depth, width, pin.shape[1]


def sketch_step_reference(counts: torch.Tensor, pin: torch.Tensor, cur: int) -> torch.Tensor:
    """The plain count-min step: `sketch_step`'s contract as tensor code.
    Entries whose index lies outside [0, width) are padding: they touch
    no cell, and their row estimate is their clamped hits."""
    depth, width, size = check_sketch_pin(counts, pin, cur)
    frac = pin[0, 2].to(torch.int64)
    idx = pin[2 : 2 + 3 * depth : 3].to(torch.int64)  # [depth, size]
    add = pin[3 : 3 + 3 * depth : 3].to(torch.int64)
    pos = pin[4 : 4 + 3 * depth : 3].to(torch.int64)
    valid = (idx >= 0) & (idx < width)
    safe = torch.where(valid, idx, 0)
    zero = torch.zeros((), dtype=torch.int64, device=counts.device)
    old = torch.where(valid, counts[cur].gather(1, safe).to(torch.int64), zero)
    new = (old + add).clamp(_I32_MIN, _I32_MAX)
    rr, jj = valid.nonzero(as_tuple=True)
    counts.view(-1)[(cur * depth + rr) * width + idx[rr, jj]] = new[rr, jj].to(torch.int32)
    prev = torch.where(valid, counts[1 - cur].gather(1, safe).to(torch.int64), zero)
    row_est = torch.div(prev * (Q16 - frac), Q16, rounding_mode="floor") + new
    est = row_est.gather(1, pos).min(0).values
    return torch.stack([(est >> 32).to(torch.int32), _low_word(est)])


def rotate_reference(counts: torch.Tensor, cur: int, delta: int) -> int:
    """The plain rotation: `sketch_rotate`'s contract as tensor code."""
    check_counts(counts)
    if delta <= 0:
        return cur
    if delta == 1:
        counts[1 - cur] = 0
        return 1 - cur
    counts[:] = 0
    return cur


# K7's plans (csrc/sketch.cu).
BLOCK_THREADS_MAX = 1024  # the block form: one thread an entry, one block
PAIR_THREADS = 256
_FORM_CODES = {"pair": 0, "block": 1}


class SketchPlan(NamedTuple):
    """How one K7 call runs.  "block": one launch of one block of
    `threads` threads, thread f taking entry f = (row f // size, lane
    f % size), with `shared_bytes` = 16·depth·size of row estimates and the
    estimates the entries read at their lanes' positions.  "pair": two
    launches of `threads`-thread blocks (no shared memory), one thread an
    entry, then one a lane."""

    form: str
    threads: int
    shared_bytes: int


PAIR_PLAN = SketchPlan("pair", PAIR_THREADS, 0)


def plan_sketch_step(depth: int, size: int) -> SketchPlan:
    """K7's plan for a [2 + 3·depth, size] pin: the block form while one
    block holds every entry (depth·size <= 1024: 256 lanes at depth 4),
    else the pair form.  The threshold is measured (PERF.md §6): above
    it one SM's share of the random cell reads costs more than the second
    launch, which programmatic dependent launch mostly hides."""
    entries = depth * size
    if entries > BLOCK_THREADS_MAX:
        return PAIR_PLAN
    return SketchPlan("block", max(32, -(-entries // 32) * 32), 16 * entries)


def sketch_step(counts: torch.Tensor, pin: torch.Tensor, cur: int) -> torch.Tensor:
    """One count-min step (see the module docstring); `counts` is updated
    in place.  Returns int32 [2, size]."""
    dev = counts.device
    if dev.type == "cpu":
        return sketch_step_reference(counts, pin, cur)
    if dev.type != "cuda":
        raise ValueError(f"sketch_step: unsupported device {dev}")
    depth, _, size = check_sketch_pin(counts, pin, cur)
    return launch_step(counts, pin, cur, plan_sketch_step(depth, size))


def launch_step(counts: torch.Tensor, pin: torch.Tensor, cur: int,
                plan: SketchPlan) -> torch.Tensor:
    """K7 on the card by `plan` (sketch_step's own, or another form for a
    test or a timing).  Raises if the launcher refuses the plan or a launch
    fails; never runs another form."""
    dev = counts.device
    if dev.type != "cuda":
        raise ValueError(f"launch_step: K7 runs on a CUDA device, not {dev}")
    depth, width, size = check_sketch_pin(counts, pin, cur)
    check_cuda(counts, "counts", dev)
    check_cuda(pin, "pin", dev)
    if plan.form not in _FORM_CODES:
        raise ValueError(f"sketch_step (K7): the launcher refuses {plan}: no such form")
    lib = native_build.load("sketch")
    out = torch.empty((2, size), dtype=torch.int32, device=dev)
    row_est = (torch.empty((depth, size), dtype=torch.int64, device=dev)
               if plan.form == "pair" else None)
    with torch.cuda.device(dev):
        rc = lib.guber_sketch_step(
            counts.data_ptr(), depth, width, pin.data_ptr(), size, cur, out.data_ptr(),
            None if row_est is None else row_est.data_ptr(), _FORM_CODES[plan.form],
            plan.threads, plan.shared_bytes, stream_of(dev))
    if rc == -1:
        raise ValueError(f"sketch_step (K7): the launcher refuses {plan} for depth {depth}, "
                         f"size {size}")
    if rc != 0:
        raise RuntimeError(f"sketch_step (K7) launch failed ({plan}): cudaError {rc}")
    launches["sketch_step"] += 1
    forms["sketch_step"][plan.form] += 1
    return out


def sketch_rotate(counts: torch.Tensor, cur: int, delta: int) -> int:
    """Advance the planes `delta` windows (see the module docstring);
    zeroes in place and returns the new `cur`."""
    dev = counts.device
    if dev.type == "cpu":
        return rotate_reference(counts, cur, delta)
    if dev.type != "cuda":
        raise ValueError(f"sketch_rotate: unsupported device {dev}")
    check_counts(counts)
    check_cuda(counts, "counts", dev)
    if delta <= 0:
        return cur
    target = counts[1 - cur] if delta == 1 else counts
    lib = native_build.load("sketch")
    with torch.cuda.device(dev):
        rc = lib.guber_sketch_rotate(target.data_ptr(), target.numel(), stream_of(dev))
    if rc != 0:
        raise RuntimeError(f"sketch_rotate (K8) launch failed: cudaError {rc}")
    launches["sketch_rotate"] += 1
    return 1 - cur if delta == 1 else cur


class SketchState(NamedTuple):
    """Two-epoch count-min sketch: int32 counts [2, depth, width] on the
    device, the window index of plane `cur` and `cur` on the host."""

    counts: torch.Tensor
    epoch: int
    cur: int


def sketch_state_from_numpy(counts: np.ndarray, epoch: int, cur: int,
                            device=None) -> SketchState:
    """A state from numpy planes (the JAX package's `SketchState` read
    with `np.asarray`), on `device` (the card unless "cpu" is asked)."""
    t = torch.from_numpy(np.ascontiguousarray(counts, dtype=np.int32)).to(resolve_device(device))
    check_counts(t)
    return SketchState(t, int(epoch), int(cur))


def sketch_state_to_numpy(state: SketchState) -> Tuple[np.ndarray, int, int]:
    """(counts int32 [2, depth, width], epoch, cur) on the host."""
    return state.counts.cpu().numpy(), int(state.epoch), int(state.cur)


def row_indexes(h1: np.ndarray, depth: int, width: int) -> np.ndarray:
    """[depth, n] int64 row indexes from fnv1a-64 key hashes by double
    hashing: (h1 + r·h2) mod width, h2 one multiply-xor over h1
    (reference :240)."""
    h1 = np.asarray(h1, dtype=np.uint64)
    h2 = (h1 ^ (h1 >> np.uint64(33))) * np.uint64(SEED)
    rows = np.empty((depth, len(h1)), dtype=np.int64)
    for r in range(depth):
        rows[r] = ((h1 + np.uint64(r) * h2) % np.uint64(width)).astype(np.int64)
    return rows


def pack_pin(rows: np.ndarray, hits: np.ndarray, now_ms: int, window_ms: int,
             width: int) -> np.ndarray:
    """The packed int32 pin of one batch (layout in the module docstring)
    from its [depth, n] row indexes and int64 hits (reference :273-303)."""
    depth, n = rows.shape
    hits64 = np.asarray(hits, dtype=np.int64)
    size = 64  # the pad ladder: 64, doubled until it holds the batch
    while size < n:
        size *= 2
    pin = np.zeros((pin_rows(depth), size), dtype=np.int32)
    epoch = now_ms // window_ms
    pin[0, 0] = np.int32(epoch >> 32)
    pin[0, 1] = np.int64(epoch).astype(np.int32)
    pin[0, 2] = (now_ms % window_ms) * Q16 // window_ms
    pin[1, :n] = np.clip(hits64, _I32_MIN, _I32_MAX).astype(np.int32)
    for r in range(depth):
        uniq, inv = np.unique(rows[r], return_inverse=True)
        m = len(uniq)
        # Exact int64 sums, clamped: a hot key's combined hits must not
        # wrap negative in the int32 lane.
        sums = np.zeros(m, dtype=np.int64)
        np.add.at(sums, inv, hits64)
        pin[2 + 3 * r, :m] = uniq.astype(np.int32)
        if size > m:
            pin[2 + 3 * r, m:] = np.arange(width, width + (size - m), dtype=np.int64).astype(
                np.int32)
        pin[3 + 3 * r, :m] = np.clip(sums, _I32_MIN, _I32_MAX).astype(np.int32)
        pin[4 + 3 * r, :n] = inv.reshape(-1).astype(np.int32)
    return pin


class SketchLimiter:
    """Approximate per-key rate limiter over a count-min sketch.

    One limiter is one (window_ms, depth, width) sketch on `device` (the
    card unless "cpu" is asked; with no CUDA it raises).  `apply(keys,
    hits, limit, now_ms)` returns (over, estimate) arrays.  The step
    updates `counts` in place (the reference donates its state to a new
    one), so `apply` runs under a lock: two racing calls would otherwise
    read and write the same planes and drop each other's hits, breaking
    the never-under-count contract.
    """

    def __init__(self, window_ms: int = 1_000, depth: int = 4, width: int = 1 << 20, *,
                 device=None):
        if depth < 1 or width < 2:
            raise ValueError("depth >= 1 and width >= 2 required")
        self.window_ms = int(window_ms)
        self.depth = depth
        self.width = width
        self.device = resolve_device(device)
        self._lock = threading.Lock()
        self._state = SketchState(
            torch.zeros((2, depth, width), dtype=torch.int32, device=self.device), 0, 0)

    @property
    def state(self) -> SketchState:
        return self._state

    @state.setter
    def state(self, st: SketchState) -> None:
        if tuple(st.counts.shape) != (2, self.depth, self.width) or st.counts.device != self.device:
            raise ValueError("state must match the limiter's shape and device")
        with self._lock:
            self._state = st

    # -- host packing --------------------------------------------------

    def _indexes(self, keys) -> np.ndarray:
        """[depth, B] int64 row indexes via double hashing."""
        padded, lengths = pack_keys(keys)
        return self._indexes_hashed(fnv1a_64_batch(padded, lengths))

    def _indexes_hashed(self, h1: np.ndarray) -> np.ndarray:
        """Row indexes from fnv1a-64 key hashes (reference :240)."""
        return row_indexes(h1, self.depth, self.width)

    def apply(self, keys, hits: np.ndarray, limit: np.ndarray, now_ms: int, *,
              key_hashes: Optional[np.ndarray] = None) -> Tuple[np.ndarray, np.ndarray]:
        """One batch: (over bool [n], estimate int64 [n]); every lane of a
        key sees the estimate after the whole batch's hits."""
        n = len(key_hashes) if key_hashes is not None else len(keys)
        if n == 0:
            return np.zeros(0, dtype=bool), np.zeros(0, dtype=np.int64)
        rows = self._indexes_hashed(key_hashes) if key_hashes is not None else self._indexes(keys)
        pin = pack_pin(rows, hits, now_ms, self.window_ms, self.width)
        epoch = now_ms // self.window_ms
        pin_t = torch.from_numpy(pin).to(self.device)
        with self._lock:
            counts, epoch_host, cur = self._state
            if epoch > epoch_host:
                # The window moved: rotate first (a separate, rare launch).
                cur = sketch_rotate(counts, cur, epoch - epoch_host)
                epoch_host = epoch
            out = sketch_step(counts, pin_t, cur)
            self._state = SketchState(counts, epoch_host, cur)
            arr = out.cpu().numpy()
        est = (arr[0, :n].astype(np.int64) << 32) | (arr[1, :n].astype(np.int64) & 0xFFFFFFFF)
        over = est > np.asarray(limit, dtype=np.int64)
        return over, est
