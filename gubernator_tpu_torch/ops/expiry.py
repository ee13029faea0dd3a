"""The expiry sweep: reclaim the slots of expired buckets, a group of
windows at a time.

Port of `gubernator_tpu/ops/expiry.py`.  The reference's LRU expires
items lazily on read and evicts on overflow (reference:
lrucache.go:112-159); with the state on the device the step's liveness
check already expires lazily, and this sweep frees the slots of expired
buckets in bulk so that the host intern table can reuse them.

* `sweep_windows(meta, hi2, expire_lo, now_ms, starts, window, n_sh=1)`
  — kernel K6 (csrc/sweep.cu), the port of `sweep_window_scan` (:40)
  with `sweep_window_commit` (:78) fused in, run over the windows
  [start, start + window) of `starts` one after another, as the
  reference's loop (:89) runs them: a slot is freed when meta bit 0 is
  set and its expiry (hi2 & 0x7FF, expire_lo), a 64-bit pair with an
  UNSIGNED low word, is below `now_ms`; its meta bit 0 is cleared in
  place.  Returns int32 [len(starts), n_sh, window + 1]: each row the
  count, then the freed window-local indices in ascending order (what
  follows them is unspecified).  With n_sh > 1 it is K13 (below).  A
  group of up to MAX_WINDOWS windows is one launch: a row frees only
  what no earlier row of its launch covers (`plan_launches`), which is
  the sequential result, since with one `now_ms` the earlier row has
  already freed every expired occupied slot of the overlap.  A CUDA
  tensor goes to the kernel (no fallback from a failed launch); a CPU
  tensor to the plain `sweep_windows_reference`.  Launches count in
  `ops.fused_step.launches["sweep_window"]`.
* `shard_sweep_windows(meta, hi2, expire_lo, n_sh, now_ms, starts,
  window)` — kernel K13 (the same kernel with a shard axis), the
  reference's scan + commit over the sharded engine's [n_sh, shard_cap]
  state (`parallel/sharded_engine.py:727 sweep`): the columns are
  [n_sh * shard_cap], a window [start, start + window) of every shard,
  output rows as `sweep_windows`'; launches count in
  `launches["shard_sweep"]`.
* `sweep_window` / `shard_sweep_window` — the one-window case
  ([window + 1] and [n_sh, window + 1] out); plain versions
  `sweep_window_reference` / `shard_sweep_window_reference`.
* `windowed_sweep(...)` — the window loop (reference :89): windows of
  `min(cap, SWEEP_WINDOW)`, the tail window clamped to end at `cap`, a
  cursor that resumes where the last call stopped and wraps at `cap`;
  each group of READBACK_GROUP windows is one call of the engine's
  window function, then the host reads back the counts, then only
  `count` indices a window: the transfer is O(freed), not O(window).
* `sweep_expired(...)` — the one-shot full-capacity form (reference
  :131): the same kernel over one window of `cap`.

The kernel's tiles take tickets from a small int64 buffer kept per
device and stream (word 0 the ticket counter, then one published word a
tile), and every launch has a stamp its buffer never saw, so nothing is
zeroed between launches.  The buffer's counter and the count this module
keeps must agree, so launches with one buffer are made under a lock, in
the order they reach the stream.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from gubernator_tpu_torch.ops import native_build
from gubernator_tpu_torch.ops.bucket_kernel import _HI11, _LO
from gubernator_tpu_torch.ops.fused_step import check_cuda, launches

# Windows a launch sweeps (csrc/sweep.cu kMaxWindows).
MAX_WINDOWS = 16
# Windows launched before their results are read back: one call's windows
# go in groups of this many, each group one launch, read back in two
# transfers.
READBACK_GROUP = 16
# A tile's stamp has 31 bits (csrc/sweep.cu tile_word).
_STAMP_END = 1 << 31
# Blocks a launch should keep when its tiles grow past one 16-byte quad
# a thread (to 2, 4 or 8): fewer, larger tiles take fewer tickets and
# shorter look-backs, but the card has 132 SMs to fill.  On the H100 a
# group of 16 windows of 2^17 ran fastest at 8 quads (512 blocks), a lone
# window at 1 (256 blocks; 2 would leave SMs idle).
MIN_BLOCKS = 512


def tile_quads(rows: int, window: int, head: int, tile_slots: int) -> int:
    """Quads a thread for a launch of `rows` rows of `window` slots (plus
    up to `head` slots before a 16-byte boundary): the most of 8, 4, 2
    that still gives MIN_BLOCKS tiles, else 1."""
    for quads in (8, 4, 2):
        if rows * -(-(window + head) // (tile_slots * quads)) >= MIN_BLOCKS:
            return quads
    return 1


def _check_window(meta, hi2, expire_lo, start: int, window: int, n_sh: int = 1) -> int:
    """Validate the three columns, int32 [n_sh * cap], and the window,
    which must lie in [0, cap); returns cap."""
    rows = meta.shape[0]
    for name, t in (("meta", meta), ("hi2", hi2), ("expire_lo", expire_lo)):
        if t.dtype != torch.int32 or t.dim() != 1 or t.shape[0] != rows:
            raise ValueError(f"{name} must be int32 [{rows}]")
        if t.device != meta.device:
            raise ValueError(f"{name} is on {t.device}, meta on {meta.device}")
    if n_sh < 1 or rows % n_sh:
        raise ValueError(f"{rows} rows are not {n_sh} equal shards")
    cap = rows // n_sh
    if window < 1 or start < 0 or start + window > cap:
        raise ValueError(f"window [{start}, {start + window}) must lie in [0, {cap})")
    return cap


def sweep_window_reference(meta, hi2, expire_lo, now_ms: int, start: int,
                           window: int) -> torch.Tensor:
    """The plain sweep of one window: `sweep_window`'s contract, the
    reference's scan + commit written as tensor code."""
    _check_window(meta, hi2, expire_lo, start, window)
    sl = slice(start, start + window)
    m = meta[sl]
    ehi = (hi2[sl] & _HI11).to(torch.int64)
    elo = expire_lo[sl].to(torch.int64) & _LO  # the uint32 value
    now_hi, now_lo = now_ms >> 32, now_ms & _LO
    freed = ((m & 1) != 0) & ((ehi < now_hi) | ((ehi == now_hi) & (elo < now_lo)))
    idx = torch.nonzero(freed).flatten()
    meta[sl] = torch.where(freed, m & ~1, m)
    out = torch.zeros(window + 1, dtype=torch.int32, device=meta.device)
    out[0] = idx.numel()
    out[1 : 1 + idx.numel()] = idx.to(torch.int32)
    return out


def shard_sweep_window_reference(meta, hi2, expire_lo, n_sh: int, now_ms: int, start: int,
                                 window: int) -> torch.Tensor:
    """The plain sweep of one window of every shard: `sweep_window_reference`
    on each shard's rows, stacked to [n_sh, window + 1]."""
    shard_cap = _check_window(meta, hi2, expire_lo, start, window, n_sh)
    return torch.stack([
        sweep_window_reference(*(c[sh * shard_cap : (sh + 1) * shard_cap]
                                 for c in (meta, hi2, expire_lo)), now_ms, start, window)
        for sh in range(n_sh)
    ])


def sweep_windows_reference(meta, hi2, expire_lo, now_ms: int, starts, window: int,
                            n_sh: int = 1) -> torch.Tensor:
    """The plain sweep of a group of windows: `shard_sweep_window_reference`
    on each start in order, stacked to [len(starts), n_sh, window + 1]."""
    if not len(starts):
        raise ValueError("sweep_windows: no windows")
    return torch.stack([shard_sweep_window_reference(meta, hi2, expire_lo, n_sh, now_ms,
                                                     int(s), window) for s in starts])


def _owned(earlier, start: int, window: int) -> tuple:
    """The part of [start, start + window) that no window of the same
    width starting at one of `earlier` covers, window-local, as (lo, hi)
    (lo == hi: none).  A window of the same width that overlaps this one
    holds its first or its last slot, so it covers a prefix or a suffix
    (or all), and what is left is one range."""
    lo, hi = 0, window
    for e in earlier:
        if start <= e < start + window:
            hi = min(hi, e - start)
        elif e < start < e + window:
            lo = max(lo, e + window - start)
    return lo, max(lo, hi)


def plan_launches(starts, window: int, max_windows: int = MAX_WINDOWS) -> list:
    """Cut the windows of `starts` into launches of up to `max_windows`,
    and give each row the window-local range [lo, hi) it frees in: what
    no earlier row of its launch covers (for `windowed_sweep`, the
    clamped tail leaves its overlap with the window before it to that
    window, and after a wrap window 0 leaves its overlap with the tail).
    Returns [(first row, [(lo, hi) a row])] in order."""
    return [(first, [_owned(starts[first:r], starts[r], window)
                     for r in range(first, min(first + max_windows, len(starts)))])
            for first in range(0, len(starts), max_windows)]


# (device index, stream) → [publish buffer int64 [1 + tiles], tickets
# taken from it, stamps used]: word 0 holds the kernel's ticket counter,
# and a stamp is never reused with its buffer, so nothing needs clearing
# between launches.
_publish: dict = {}
_publish_lock = threading.Lock()


def _publish_entry(dev: torch.device, stream: int, tiles: int) -> list:
    """The publish buffer of `dev`'s stream `stream`, with room for
    `tiles` tiles and a stamp left (called under `_publish_lock`)."""
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    key = (index, stream)
    entry = _publish.get(key)
    if entry is None or entry[0].shape[0] < 1 + tiles or entry[2] + 1 >= _STAMP_END:
        entry = [torch.zeros(1 + max(tiles, 4096), dtype=torch.int64, device=dev), 0, 0]
        _publish[key] = entry
    return entry


def launch_group(meta, hi2, expire_lo, n_sh: int, now_ms: int, starts, owned, window: int,
                 out: torch.Tensor, silent_tile: int = -1, quads=None) -> None:
    """One launch of the sweep kernel over the windows of `starts` (at
    most MAX_WINDOWS), row w freeing only in its window-local range
    owned[w]; writes out int32 [len(starts), n_sh, window + 1] (CUDA,
    contiguous).  `quads` (1, 2, 4 or 8; default `tile_quads`) sets the
    tile size; `silent_tile` names a tile that publishes nothing (a
    test's way to show that the look-back's wait traps)."""
    dev = meta.device
    lib = native_build.load("sweep")
    stride = meta.shape[0] // n_sh
    g = len(starts)
    ptrs = (meta.data_ptr(), hi2.data_ptr(), expire_lo.data_ptr())
    vec = ptrs[0] % 16 == ptrs[1] % 16 == ptrs[2] % 16
    head = 0  # the most slots any row has before its first 16-byte boundary
    if vec:
        shards = range(n_sh) if stride % 4 else (0,)
        head = max((ptrs[0] // 4 + sh * stride + s) & 3 for s in starts for sh in shards)
    tile_slots = lib.guber_sweep_tile_slots()
    if quads is None:
        quads = tile_quads(g * n_sh, window, head, tile_slots)
    tiles_per_row = -(-(window + head) // (tile_slots * quads))
    tiles = g * n_sh * tiles_per_row
    arr = (ctypes.c_longlong * g)(*starts)
    lo = (ctypes.c_int * g)(*(a for a, _ in owned))
    hi = (ctypes.c_int * g)(*(b for _, b in owned))
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev), _publish_lock:
        entry = _publish_entry(dev, stream, tiles)
        rc = lib.guber_sweep_windows(*ptrs, n_sh, stride, g, arr, lo, hi, window,
                                     tiles_per_row, quads, int(vec), now_ms, entry[0].data_ptr(),
                                     entry[1], entry[2] + 1, silent_tile, out.data_ptr(),
                                     ctypes.c_void_p(stream))
        if rc == 0:
            entry[1] += tiles
            entry[2] += 1
    if rc != 0:
        raise RuntimeError(f"sweep launch of {g} windows x {n_sh} shards ({tiles} blocks) "
                           f"failed: cudaError {rc}")


def _sweep_group(meta, hi2, expire_lo, n_sh: int, now_ms: int, starts, window: int,
                 counter: str) -> torch.Tensor:
    """`sweep_windows` / `shard_sweep_windows`: the plain version on the
    CPU, else one launch a planned group, counted in `launches[counter]`."""
    dev = meta.device
    if dev.type == "cpu":
        return sweep_windows_reference(meta, hi2, expire_lo, now_ms, starts, window, n_sh)
    if dev.type != "cuda":
        raise ValueError(f"sweep_windows: unsupported device {dev}")
    if not len(starts):
        raise ValueError("sweep_windows: no windows")
    starts = [int(s) for s in starts]
    cap = _check_window(meta, hi2, expire_lo, starts[0], window, n_sh)
    if min(starts) < 0 or max(starts) + window > cap:
        raise ValueError(f"windows of {window} at {starts} must lie in [0, {cap})")
    if window >= 2**31 - 1:
        raise ValueError(f"window {window} does not fit the int32 output")
    for name, t in (("meta", meta), ("hi2", hi2), ("expire_lo", expire_lo)):
        check_cuda(t, name, dev)
    out = torch.empty((len(starts), n_sh, window + 1), dtype=torch.int32, device=dev)
    plan = plan_launches(starts, window)
    for first, owned in plan:
        part = out if len(plan) == 1 else out[first : first + len(owned)]
        launch_group(meta, hi2, expire_lo, n_sh, now_ms, starts[first : first + len(owned)],
                     owned, window, part)
        launches[counter] += 1
    return out


def sweep_windows(meta, hi2, expire_lo, now_ms: int, starts, window: int,
                  n_sh: int = 1) -> torch.Tensor:
    """K6 (K13 with n_sh > 1): sweep the windows [s, s + window) of
    `starts` in order at `now_ms`; `meta` is updated in place.  Returns
    int32 [len(starts), n_sh, window + 1]."""
    return _sweep_group(meta, hi2, expire_lo, n_sh, now_ms, starts, window,
                        "sweep_window" if n_sh == 1 else "shard_sweep")


def shard_sweep_windows(meta, hi2, expire_lo, n_sh: int, now_ms: int, starts,
                        window: int) -> torch.Tensor:
    """K13: sweep the windows of `starts` of each of the n_sh shards of
    the [n_sh * shard_cap] columns, in order, at `now_ms`."""
    return _sweep_group(meta, hi2, expire_lo, n_sh, now_ms, starts, window, "shard_sweep")


def shard_sweep_window(meta, hi2, expire_lo, n_sh: int, now_ms: int, start: int,
                       window: int) -> torch.Tensor:
    """K13 on one window: int32 [n_sh, window + 1]."""
    return shard_sweep_windows(meta, hi2, expire_lo, n_sh, now_ms, [start], window)[0]


def sweep_window(meta, hi2, expire_lo, now_ms: int, start: int, window: int) -> torch.Tensor:
    """K6 on one window: int32 [window + 1]."""
    return sweep_windows(meta, hi2, expire_lo, now_ms, [start], window)[0, 0]


def read_freed(outs) -> list:
    """The freed indices (int64, ascending) of each window output in
    `outs` (a list of [window + 1] rows, or one [n, window + 1] tensor),
    on the host: one transfer for all the counts, then one for exactly
    that many indices, so the transfer is O(freed)."""
    if not len(outs):
        return []
    heads = outs[:, 0] if torch.is_tensor(outs) else torch.stack([o[0] for o in outs])
    counts = heads.cpu().tolist()
    parts = [o[1 : 1 + c] for o, c in zip(outs, counts) if c]
    flat = (torch.cat(parts).cpu().numpy().astype(np.int64) if parts
            else np.zeros(0, dtype=np.int64))
    return np.split(flat, np.cumsum(counts)[:-1])


def windowed_sweep(engine, cap: int, now_ms: int, max_windows, release,
                   window_fn=sweep_windows, per_shard: bool = False) -> int:
    """Drive sweep windows over an engine's state (reference :89).
    `engine` supplies `_state`, `_sweep_cursor` and `SWEEP_WINDOW`; the
    caller holds the engine lock.  `window_fn(meta, hi2, expire_lo,
    now_ms, starts, window)` sweeps a group of windows in order and
    returns int32 [len(starts), n_sh, window + 1] (`sweep_windows`, an
    engine's closure over it or over `shard_sweep_windows`, or
    `sweep_windows_reference` to hold a kernel against).
    `release(freed, start) -> n` frees one window's compacted slots
    (`freed` window-local, ascending; with `per_shard`, a list of one
    such array a shard) in the host table and returns how many; windows
    are released in cursor order, as the reference releases them.

    The reference reads each window back before it scans the next; here a
    group of READBACK_GROUP windows is swept first and read back at once,
    which frees the same slots in the same order (a window changes only
    meta, and `release` touches only the host table) with two
    synchronisations a group instead of two a window."""
    window = min(cap, engine.SWEEP_WINDOW)
    n_windows = (cap + window - 1) // window
    if max_windows is not None:
        n_windows = min(n_windows, max_windows)
    freed_total = 0
    for g in range(0, n_windows, READBACK_GROUP):
        starts = []
        for _ in range(min(READBACK_GROUP, n_windows - g)):
            # Clamp the tail window; where it overlaps the window before
            # it, the earlier window's sweep stands (the slots it freed
            # are no longer occupied).
            starts.append(min(engine._sweep_cursor, cap - window))
            engine._sweep_cursor += window
            if engine._sweep_cursor >= cap:
                engine._sweep_cursor = 0
        st = engine._state
        out = window_fn(st.meta, st.hi2, st.expire_lo, now_ms, starts, window)
        n_sh = out.shape[1]
        flat = read_freed(out.reshape(-1, window + 1))
        for w, start in enumerate(starts):
            rows = flat[w * n_sh : (w + 1) * n_sh]
            freed_total += release(rows if per_shard else rows[0], start)
    return freed_total


def sweep_expired(meta, hi2, expire_lo, now_ms: int) -> torch.Tensor:
    """One-shot sweep of the whole capacity: clears the freed slots'
    meta bit 0 in place and returns the freed mask (bool [cap])."""
    cap = meta.shape[0]
    freed = torch.from_numpy(read_freed(sweep_windows(meta, hi2, expire_lo, now_ms, [0],
                                                      cap)[0])[0])
    mask = torch.zeros(cap, dtype=torch.bool, device=meta.device)
    mask[freed.to(meta.device)] = True
    return mask
