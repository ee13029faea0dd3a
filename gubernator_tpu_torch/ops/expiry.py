"""The expiry sweep: reclaim the slots of expired buckets, a window at a
time.

Port of `gubernator_tpu/ops/expiry.py`.  The reference's LRU expires
items lazily on read and evicts on overflow (reference:
lrucache.go:112-159); with the state on the device the step's liveness
check already expires lazily, and this sweep frees the slots of expired
buckets in bulk so that the host intern table can reuse them.

* `sweep_window(meta, hi2, expire_lo, now_ms, start, window)` — kernel K6
  (csrc/sweep.cu), the port of `sweep_window_scan` (:40) with
  `sweep_window_commit` (:78) fused in: over [start, start + window), a
  slot is freed when meta bit 0 is set and its expiry (hi2 & 0x7FF,
  expire_lo), a 64-bit pair with an UNSIGNED low word, is below `now_ms`;
  its meta bit 0 is cleared in place.  Returns int32 [window + 1]:
  element 0 the count, then the freed window-local indices in ascending
  order (what follows them is unspecified).  A CUDA tensor goes to the
  kernel (no fallback from a failed launch); a CPU tensor to the plain
  `sweep_window_reference`.  Launches count in
  `ops.fused_step.launches["sweep_window"]`.
* `shard_sweep_window(meta, hi2, expire_lo, n_sh, now_ms, start,
  window)` — kernel K13 (csrc/sweep.cu, K6 with a shard axis), the
  reference's scan + commit over the sharded engine's [n_sh, shard_cap]
  state (`parallel/sharded_engine.py:727 sweep`): the columns are
  [n_sh * shard_cap], the window [start, start + window) of every
  shard; returns int32 [n_sh, window + 1], row sh laid out as
  `sweep_window`'s output.  Plain version `shard_sweep_window_reference`;
  launches count in `launches["shard_sweep"]`.
* `windowed_sweep(...)` — the window loop (reference :89): windows of
  `min(cap, SWEEP_WINDOW)`, the tail window clamped to end at `cap` (it
  overlaps slots this pass already swept, which is harmless: they are no
  longer occupied), a cursor that resumes where the last call stopped
  and wraps at `cap`.  The host reads back the counts, then only
  `count` indices a window: the transfer is O(freed), not O(window).
  With a sharded window function (`cap` is then the shard's), a window's
  release gets one array a shard.
* `sweep_expired(...)` — the one-shot full-capacity form (reference
  :131): the same kernel over one window of `cap`.
"""

from __future__ import annotations

import numpy as np
import torch

from gubernator_tpu_torch.ops import native_build
from gubernator_tpu_torch.ops.bucket_kernel import _HI11, _LO
from gubernator_tpu_torch.ops.fused_step import check_cuda, launches, stream_of


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


def shard_sweep_window(meta, hi2, expire_lo, n_sh: int, now_ms: int, start: int,
                       window: int) -> torch.Tensor:
    """K13: sweep [start, start + window) of each of the n_sh shards of the
    [n_sh * shard_cap] columns at `now_ms`; `meta` is updated in place."""
    dev = meta.device
    if dev.type == "cpu":
        return shard_sweep_window_reference(meta, hi2, expire_lo, n_sh, now_ms, start, window)
    if dev.type != "cuda":
        raise ValueError(f"shard_sweep_window: unsupported device {dev}")
    shard_cap = _check_window(meta, hi2, expire_lo, start, window, n_sh)
    for name, t in (("meta", meta), ("hi2", hi2), ("expire_lo", expire_lo)):
        check_cuda(t, name, dev)
    lib = native_build.load("sweep")
    out = torch.empty((n_sh, window + 1), dtype=torch.int32, device=dev)
    scratch = torch.empty(lib.guber_shard_sweep_scratch_words(n_sh, window), dtype=torch.int32,
                          device=dev)
    with torch.cuda.device(dev):
        rc = lib.guber_shard_sweep_window(meta.data_ptr(), hi2.data_ptr(), expire_lo.data_ptr(),
                                          n_sh, shard_cap, start, window, now_ms,
                                          out.data_ptr(), scratch.data_ptr(), stream_of(dev))
    if rc != 0:
        raise RuntimeError(f"shard_sweep_window (K13) launch failed: cudaError {rc}")
    launches["shard_sweep"] += 1
    return out


def sweep_window(meta, hi2, expire_lo, now_ms: int, start: int, window: int) -> torch.Tensor:
    """Sweep [start, start + window) at `now_ms` (see the module
    docstring); `meta` is updated in place."""
    dev = meta.device
    if dev.type == "cpu":
        return sweep_window_reference(meta, hi2, expire_lo, now_ms, start, window)
    if dev.type != "cuda":
        raise ValueError(f"sweep_window: unsupported device {dev}")
    _check_window(meta, hi2, expire_lo, start, window)
    for name, t in (("meta", meta), ("hi2", hi2), ("expire_lo", expire_lo)):
        check_cuda(t, name, dev)
    lib = native_build.load("sweep")
    out = torch.empty(window + 1, dtype=torch.int32, device=dev)
    scratch = torch.empty(lib.guber_sweep_scratch_words(window), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.guber_sweep_window(meta.data_ptr(), hi2.data_ptr(), expire_lo.data_ptr(), start,
                                    window, now_ms, out.data_ptr(), scratch.data_ptr(),
                                    stream_of(dev))
    if rc != 0:
        raise RuntimeError(f"sweep_window (K6) launch failed: cudaError {rc}")
    launches["sweep_window"] += 1
    return out


# Windows launched before their results are read back: one call's windows
# go in groups of this many, each group read back in two transfers.
READBACK_GROUP = 16


def read_freed(outs) -> list:
    """The freed indices (int64, ascending) of each window output in
    `outs`, on the host: one transfer for all the counts, then one for
    exactly that many indices, so the transfer is O(freed)."""
    if not outs:
        return []
    counts = torch.stack([o[0] for o in outs]).cpu().tolist()
    parts = [o[1 : 1 + c] for o, c in zip(outs, counts) if c]
    flat = (torch.cat(parts).cpu().numpy().astype(np.int64) if parts
            else np.zeros(0, dtype=np.int64))
    return np.split(flat, np.cumsum(counts)[:-1])


def windowed_sweep(engine, cap: int, now_ms: int, max_windows, release,
                   window_fn=sweep_window) -> int:
    """Drive sweep windows over an engine's state (reference :89).
    `engine` supplies `_state`, `_sweep_cursor` and `SWEEP_WINDOW`; the
    caller holds the engine lock.  `release(freed, start) -> n` frees one
    window's compacted slots (`freed` window-local, ascending; for a
    sharded `window_fn`, whose output is [n_sh, window + 1], a list of
    one such array a shard) in the host table and returns how many;
    windows are released in cursor order, as the reference releases them.
    `window_fn` sweeps one window (`sweep_window`, a shard-axis closure
    over `shard_sweep_window`, or a plain version to hold a kernel
    against).

    The reference reads each window back before it scans the next; here a
    group of READBACK_GROUP windows is launched first and read back at
    once, which frees the same slots in the same order (a window changes
    only meta, on the stream the next window runs on, and `release`
    touches only the host table) with two synchronisations a group
    instead of two a window."""
    window = min(cap, engine.SWEEP_WINDOW)
    n_windows = (cap + window - 1) // window
    if max_windows is not None:
        n_windows = min(n_windows, max_windows)
    freed_total = 0
    for g in range(0, n_windows, READBACK_GROUP):
        starts, outs = [], []
        for _ in range(min(READBACK_GROUP, n_windows - g)):
            # Clamp the tail window; the overlap is idempotent (slots freed
            # earlier in this pass are no longer occupied).
            start = min(engine._sweep_cursor, cap - window)
            st = engine._state
            outs.append(window_fn(st.meta, st.hi2, st.expire_lo, now_ms, start, window))
            starts.append(start)
            engine._sweep_cursor += window
            if engine._sweep_cursor >= cap:
                engine._sweep_cursor = 0
        for start, freed in zip(starts, _read_windows(outs)):
            freed_total += release(freed, start)
    return freed_total


def _read_windows(outs) -> list:
    """`read_freed` of window outputs, 1-D ([window + 1]) or sharded
    ([n_sh, window + 1], then a list of arrays a window, one a shard), in
    the same two transfers."""
    if not outs or outs[0].dim() == 1:
        return read_freed(outs)
    n_sh = outs[0].shape[0]
    flat = read_freed([o[sh] for o in outs for sh in range(n_sh)])
    return [flat[i * n_sh : (i + 1) * n_sh] for i in range(len(outs))]


def sweep_expired(meta, hi2, expire_lo, now_ms: int) -> torch.Tensor:
    """One-shot sweep of the whole capacity: clears the freed slots'
    meta bit 0 in place and returns the freed mask (bool [cap])."""
    cap = meta.shape[0]
    freed = torch.from_numpy(read_freed([sweep_window(meta, hi2, expire_lo, now_ms, 0, cap)])[0])
    mask = torch.zeros(cap, dtype=torch.bool, device=meta.device)
    mask[freed.to(meta.device)] = True
    return mask
