"""Wrappers of kernels K11 and K12, the sharded engine's per-shard steps
(csrc/sharded_step.cu), and the host packing of K11's rounds.

Port of the vmapped programs of the reference's single-program sharded
engine (`gubernator_tpu/parallel/sharded_engine.py:323
_build_step_single_program`), over n_sh shards of `shard_cap` slots held
as one `BucketState` of [n_sh * shard_cap] columns (the [n_sh,
shard_cap] layout, row-major; `ops.bucket_kernel.shard_views`):

* `shard_step(state, pin, shard_cap, clear_slots, round_off, clear_off,
  widest=)` — kernel K11: R packed rounds of every shard in one launch,
  each round after its clears (`jax.vmap(_clear_occupied_impl)` then
  `jax.vmap(_fused_step_core)`, :338-339, once a round): pin int32
  [n_sh, 16, L] laid out by `pack_shard_rounds`, round r at lanes
  [round_off[r], round_off[r+1]) of every shard, each shard's lanes of a
  round packed with the shard's capacity, so its padding lanes
  (`shard_cap + j`) are out of range there; round r's clears at columns
  [clear_off[r], clear_off[r+1]) of clear_slots int32 [n_sh, C], each
  shard's run of a round ascending.  Without `round_off` / `clear_off` it
  is one round (R = 1: the whole pin, every clear before it).  Returns
  pout int32 [n_sh, 5, L]; `state` is updated in place.
* `shard_collapsed_step(state, pin, shard_cap, clear_slots)` — kernel
  K12: clear each shard's row, then run one collapsed chunk a shard
  (`jax.vmap(collapsed_fused_one)`, :347): pin int32 [n_sh, 19, W], each
  shard's chunk as `pack_collapsed_host` lays it out with the shard's
  capacity.  Returns pout int32 [n_sh, 5, W].

`clear_slots` entries outside [0, shard_cap) are ignored: the
reference's `_apply_shard_clears` (:419), which runs just before the
step.  `shard_clear_rows` makes the one-round rows.

A CUDA tensor goes to the kernel on the current stream; a CPU tensor to
the plain versions (`ops.bucket_kernel.sharded_multi_fused_step_reference`,
or `shard_clears_reference` then `sharded_fused_step_reference` /
`sharded_collapsed_step_reference`); any other device raises.  No
fallback from a failed launch.  Launches count in
`ops.fused_step.launches["shard_step"]` and `["shard_collapsed"]`.  K12,
like K3, gives each segment to the block that holds its first lane
and publishes a hot key's terms to the blocks holding its other lanes
through a small int64 buffer kept per device, stream and shard count, one
chain a shard (its own ticket counter and stamps), so launches with one
buffer are made under a lock, in the order they reach the stream.
"""

from __future__ import annotations

import threading
from typing import NamedTuple

import numpy as np
import torch

from gubernator_tpu_torch.ops import native_build
from gubernator_tpu_torch.ops.bucket_kernel import (
    COLLAPSED_IN_ROWS,
    PACKED_IN_ROWS,
    PACKED_OUT_ROWS,
    ROUND_ALIGN,
    BucketState,
    check_shard_pin,
    shard_clears_reference,
    shard_views,
    sharded_collapsed_step_reference,
    sharded_fused_step_reference,
    sharded_multi_fused_step_reference,
    unpack_out_host,
)
from gubernator_tpu_torch.ops.collapsed_step import PUBLISH_WORDS
from gubernator_tpu_torch.ops.fused_step import check_cuda, launches, state_pointers, stream_of

# Rounds one K11 launch takes (its blocks keep 2 int32 a round in shared
# memory, at most 48 KiB).
MAX_LAUNCH_ROUNDS = 4096


def shard_clear_rows(clears, shard_cap: int, floor: int = 16) -> np.ndarray:
    """Per-shard clear lists (`clears[sh]`, slots of shard sh) → the int32
    [n_sh, C] rows of a K12 or one-round K11 call: each row sorted, padded
    with `shard_cap + i` (out of range in the shard) to C, the pow2 ladder
    from `floor` over the longest list (reference :419); C = 0 when no
    shard clears."""
    n_clear = max((len(c) for c in clears), default=0)
    if not n_clear:
        return np.zeros((len(clears), 0), dtype=np.int32)
    size = floor
    while size < n_clear:
        size *= 2
    rows = np.tile(np.arange(shard_cap, shard_cap + size, dtype=np.int64).astype(np.int32),
                   (len(clears), 1))
    for sh, c in enumerate(clears):
        rows[sh, : len(c)] = np.sort(np.asarray(c, dtype=np.int32))
    return rows


class ShardRounds(NamedTuple):
    """R rounds of every shard in one flat int32 host buffer, laid out as
    [pin (n_sh·16·L) | round_off (R+1) | clear_off (R+1) | clear_slots
    (n_sh·C)] so that one copy moves all of it; the array fields are views
    of `buf` (`split_shard_rounds` cuts a device copy the same way)."""

    buf: np.ndarray
    pin: np.ndarray  # int32 [n_sh, 16, L]
    round_off: np.ndarray  # int32 [R+1]
    clear_off: np.ndarray  # int32 [R+1]
    clear_slots: np.ndarray  # int32 [n_sh, C]
    lanes: np.ndarray  # int64 [n]: the lane of each request, in input order
    widest: int  # lanes of the widest round


def pack_shard_rounds(now_ms: int, shard_cap: int, n_sh: int, n_rounds: int, rnd, shard,
                      slot, cols, clears) -> ShardRounds:
    """Pack a batch's rounds for one K11 launch.  Request i goes to round
    rnd[i] of shard shard[i] at slot slot[i] (unique within its round and
    shard), with the 8 request columns `cols` (algo … greg_expire, in the
    same order); `clears[r]` is None or round r's per-shard clear lists.
    Each round is padded to its widest shard, to a multiple of ROUND_ALIGN
    lanes and at least ROUND_ALIGN (so every round has its `now` header
    lanes); its lanes of a shard are sorted by slot and padded with
    `shard_cap + j`; its clear run of a shard sorted and padded with
    `shard_cap + j` to the round's longest."""
    rnd = np.asarray(rnd, dtype=np.int64)
    shard = np.asarray(shard, dtype=np.int64)
    slot = np.asarray(slot, dtype=np.int64)
    n = len(rnd)
    key = rnd * n_sh + shard
    counts = np.bincount(key, minlength=n_rounds * n_sh).reshape(n_rounds, n_sh)
    widths = np.maximum(-(-counts.max(axis=1) // ROUND_ALIGN) * ROUND_ALIGN, ROUND_ALIGN)
    round_off = np.zeros(n_rounds + 1, dtype=np.int64)
    np.cumsum(widths, out=round_off[1:])
    width = int(round_off[-1])
    if shard_cap + int(widths.max()) > np.iinfo(np.int32).max:
        raise ValueError("shard_cap + round width must fit in int32 (padding slots)")
    c_counts = np.zeros((n_rounds, n_sh), dtype=np.int64)
    for r, cl in enumerate(clears):
        if cl is not None:
            c_counts[r] = [len(c) for c in cl]
    clear_off = np.zeros(n_rounds + 1, dtype=np.int64)
    np.cumsum(c_counts.max(axis=1), out=clear_off[1:])
    n_clear = int(clear_off[-1])

    a = n_sh * PACKED_IN_ROWS * width
    buf = np.zeros(a + 2 * (n_rounds + 1) + n_sh * n_clear, dtype=np.int32)
    pin, v_round, v_clear, v_slots = split_shard_rounds(buf, n_sh, width, n_rounds)
    v_round[:] = round_off
    v_clear[:] = clear_off
    # Lanes: each (round, shard) group sorted by slot from its round's start.
    order = np.lexsort((slot, key))
    flat = counts.ravel()
    group_start = np.cumsum(flat) - flat
    lanes = np.empty(n, dtype=np.int64)
    lanes[order] = round_off[rnd[order]] + np.arange(n) - group_start[key[order]]
    # Padding slots shard_cap + j, j the lane's place among its round's
    # padding in its shard; then the real lanes over them.
    lane_round = np.repeat(np.arange(n_rounds), widths)
    pad_j = (np.arange(width) - round_off[lane_round])[None, :] - counts[lane_round].T
    pin[:, 1, :] = shard_cap + pad_j
    starts = round_off[:-1]
    now = np.int64(now_ms)
    pin[:, 0, starts] = np.int32(now >> 32)
    pin[:, 0, starts + 1] = now.astype(np.int32)  # low-word bit pattern
    pin[shard, 1, lanes] = slot
    algo, behavior, *wide = cols
    pin[shard, 2, lanes] = algo
    pin[shard, 3, lanes] = behavior
    for row, col in zip(range(4, PACKED_IN_ROWS, 2), wide):
        c = np.asarray(col).astype(np.int64, copy=False)
        pin[shard, row, lanes] = (c >> 32).astype(np.int32)
        pin[shard, row + 1, lanes] = c.astype(np.int32)  # low-word bit pattern
    if n_clear:
        seg = np.repeat(np.arange(n_rounds), clear_off[1:] - clear_off[:-1])
        v_slots[:] = shard_cap + (np.arange(n_clear) - clear_off[:-1][seg])
        for r, cl in enumerate(clears):
            for sh, c in enumerate(cl or ()):
                if len(c):
                    v_slots[sh, clear_off[r] : clear_off[r] + len(c)] = np.sort(
                        np.asarray(c, dtype=np.int64))
    return ShardRounds(buf, pin, v_round, v_clear, v_slots, lanes, int(widths.max()))


def split_shard_rounds(flat, n_sh: int, width: int, n_rounds: int):
    """(pin [n_sh, 16, L], round_off, clear_off, clear_slots [n_sh, C])
    views of a flat buffer laid out as `ShardRounds.buf` (numpy array or
    tensor)."""
    a = n_sh * PACKED_IN_ROWS * width
    b = a + n_rounds + 1
    c = b + n_rounds + 1
    return (flat[:a].reshape(n_sh, PACKED_IN_ROWS, width), flat[a:b], flat[b:c],
            flat[c:].reshape(n_sh, (len(flat) - c) // n_sh))


def unpack_shard_rounds(arr: np.ndarray, shard, lanes) -> tuple:
    """K11's host output [n_sh, 5, L] → (status int32, remaining int64,
    reset int64) of the requests at (shard[i], lanes[i])."""
    return unpack_out_host(np.ascontiguousarray(arr[shard, :, lanes].T), len(lanes))


def _check(state: BucketState, pin, rows: int, shard_cap: int, clear_slots) -> int:
    """Shapes and devices of a per-shard call; returns n_sh."""
    n_sh = len(shard_views(state, shard_cap))
    check_shard_pin(pin, rows, n_sh)
    if pin.shape[2] < 1:
        raise ValueError("empty pin")
    if clear_slots.dtype != torch.int32 or clear_slots.dim() != 2 \
            or clear_slots.shape[0] != n_sh:
        raise ValueError(f"clear_slots must be int32 [{n_sh}, C]")
    for name, t in (("pin", pin), ("clear_slots", clear_slots)):
        if t.device != state.meta.device:
            raise ValueError(f"{name} is on {t.device}, state on {state.meta.device}")
    return n_sh


def shard_step(state: BucketState, pin: torch.Tensor, shard_cap: int,
               clear_slots: torch.Tensor, round_off: torch.Tensor | None = None,
               clear_off: torch.Tensor | None = None, *,
               widest: int | None = None) -> torch.Tensor:
    """K11: (state [n_sh * shard_cap], pin int32 [n_sh, 16, L],
    clear_slots int32 [n_sh, C], and for R rounds round_off / clear_off
    int32 [R+1]) → pout int32 [n_sh, 5, L]; `state` is updated in place.
    On CUDA a multi-round call gives `widest` (`ShardRounds.widest`), which
    sizes the grid."""
    n_sh = _check(state, pin, PACKED_IN_ROWS, shard_cap, clear_slots)
    if (round_off is None) != (clear_off is None):
        raise ValueError("round_off and clear_off come together")
    dev = pin.device
    if dev.type == "cpu":
        if round_off is None:
            shard_clears_reference(state, clear_slots, shard_cap)
            return sharded_fused_step_reference(state, pin, shard_cap)
        return sharded_multi_fused_step_reference(state, pin, shard_cap, round_off, clear_off,
                                                  clear_slots)
    if dev.type != "cuda":
        raise ValueError(f"shard_step: unsupported device {dev}")
    check_cuda(pin, "pin", dev)
    check_cuda(clear_slots, "clear_slots", dev)
    width = pin.shape[2]
    n_rounds = 1
    offs = (None, None)
    if round_off is not None:
        for name, t in (("round_off", round_off), ("clear_off", clear_off)):
            if t.dtype != torch.int32 or t.dim() != 1:
                raise ValueError(f"{name} must be a 1-D int32 tensor")
            check_cuda(t, name, dev)
        n_rounds = round_off.shape[0] - 1
        if n_rounds < 1 or clear_off.shape[0] != n_rounds + 1:
            raise ValueError("round_off and clear_off must both be int32 [R+1], R >= 1")
        if n_rounds > MAX_LAUNCH_ROUNDS:
            raise ValueError(f"K11 takes at most {MAX_LAUNCH_ROUNDS} rounds a launch")
        if widest is None:
            raise ValueError("shard_step over several rounds on CUDA needs `widest`")
        offs = (round_off.data_ptr(), clear_off.data_ptr())
    if widest is None:
        widest = width
    cols, _cap = state_pointers(state, dev)
    lib = native_build.load("sharded_step")
    pout = torch.empty((n_sh, PACKED_OUT_ROWS, width), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.guber_shard_step(cols, shard_cap, n_sh, pin.data_ptr(), width, offs[0],
                                  n_rounds, offs[1], clear_slots.data_ptr(),
                                  clear_slots.shape[1], int(widest), pout.data_ptr(),
                                  stream_of(dev))
    if rc != 0:
        raise RuntimeError(f"shard_step (K11) launch of {n_rounds} rounds failed: cudaError {rc}")
    launches["shard_step"] += 1
    return pout


# (device index, stream, n_sh) → [publish buffer int64 [n_sh, 1 + tiles,
# PUBLISH_WORDS], tiles a shard launched with it]; as K3's (ops.collapsed_step)
# with one chain a shard.
_publish: dict = {}
_publish_lock = threading.Lock()


def _publish_entry(dev: torch.device, n_sh: int, tiles: int) -> list:
    """The publish buffer of `dev`'s current stream for `n_sh` shards, with
    room for `tiles` tiles a shard (called under `_publish_lock`)."""
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    key = (index, torch.cuda.current_stream(dev).cuda_stream, n_sh)
    entry = _publish.get(key)
    if entry is None or entry[0].shape[1] < 1 + tiles:
        entry = [torch.zeros((n_sh, 1 + max(tiles, 128), PUBLISH_WORDS), dtype=torch.int64,
                             device=dev), 0]
        _publish[key] = entry
    return entry


def shard_collapsed_step(state: BucketState, pin: torch.Tensor, shard_cap: int,
                         clear_slots: torch.Tensor) -> torch.Tensor:
    """K12: (state [n_sh * shard_cap], pin int32 [n_sh, 19, W],
    clear_slots int32 [n_sh, C]) → pout int32 [n_sh, 5, W]; `state` is
    updated in place."""
    n_sh = _check(state, pin, COLLAPSED_IN_ROWS, shard_cap, clear_slots)
    dev = pin.device
    if dev.type == "cpu":
        shard_clears_reference(state, clear_slots, shard_cap)
        return sharded_collapsed_step_reference(state, pin, shard_cap)
    if dev.type != "cuda":
        raise ValueError(f"shard_collapsed_step: unsupported device {dev}")
    check_cuda(pin, "pin", dev)
    check_cuda(clear_slots, "clear_slots", dev)
    cols, _cap = state_pointers(state, dev)
    width = pin.shape[2]
    lib = native_build.load("sharded_step")
    pout = torch.empty((n_sh, PACKED_OUT_ROWS, width), dtype=torch.int32, device=dev)
    tiles = -(-width // lib.guber_shard_collapsed_threads())
    with torch.cuda.device(dev), _publish_lock:
        entry = _publish_entry(dev, n_sh, tiles)
        pub = entry[0]
        rc = lib.guber_shard_collapsed(
            cols, shard_cap, n_sh, pin.data_ptr(), width, clear_slots.data_ptr(),
            clear_slots.shape[1], pub.data_ptr(), pub.shape[1] - 1, entry[1], pout.data_ptr(),
            stream_of(dev),
        )
        if rc == 0:
            entry[1] += tiles
    if rc != 0:
        raise RuntimeError(f"shard_collapsed_step (K12) launch of {tiles} x {n_sh} blocks "
                           f"failed: cudaError {rc}")
    launches["shard_collapsed"] += 1
    return pout
