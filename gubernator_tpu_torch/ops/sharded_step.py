"""Wrappers of kernels K11 and K12, the sharded engine's per-shard steps
(csrc/sharded_step.cu).

Port of the vmapped programs of the reference's single-program sharded
engine (`gubernator_tpu/parallel/sharded_engine.py:323
_build_step_single_program`), over n_sh shards of `shard_cap` slots held
as one `BucketState` of [n_sh * shard_cap] columns (the [n_sh,
shard_cap] layout, row-major; `ops.bucket_kernel.shard_views`):

* `shard_step(state, pin, shard_cap, clear_slots)` — kernel K11: clear
  each shard's `clear_slots` row, then run one packed round a shard
  (`jax.vmap(_fused_step_core)`, :339): pin int32 [n_sh, 16, W], each
  shard's round packed with the shard's capacity, so its padding lanes
  (`shard_cap + lane`) are out of range there.  Returns pout int32
  [n_sh, 5, W]; `state` is updated in place.
* `shard_collapsed_step(state, pin, shard_cap, clear_slots)` — kernel
  K12: clear each shard's row, then run one collapsed chunk a shard
  (`jax.vmap(collapsed_fused_one)`, :347): pin int32 [n_sh, 19, W], each
  shard's chunk as `pack_collapsed_host` lays it out with the shard's
  capacity.  Returns pout int32 [n_sh, 5, W].

`clear_slots` is int32 [n_sh, C] (C may be 0), entries outside [0,
shard_cap) ignored: the reference's `_apply_shard_clears` (:419), which
runs just before the step.  K11 needs each row ascending (it finds a
lane's clear by binary search); the engine sorts them, and so does
`shard_clear_rows`.

A CUDA tensor goes to the kernel on the current stream; a CPU tensor to
the plain versions (`ops.bucket_kernel.shard_clears_reference`, then
`sharded_fused_step_reference` / `sharded_collapsed_step_reference`);
any other device raises.  No fallback from a failed launch.  Launches
count in `ops.fused_step.launches["shard_step"]` and
`["shard_collapsed"]`.  K12, like K3, gives each segment to the block
that holds its first lane and publishes a hot key's terms to the blocks
holding its other lanes through a small int64 buffer kept per device,
stream and shard count, one chain a shard (its own ticket counter and
stamps), so launches with one buffer are made under a lock, in the order
they reach the stream.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from gubernator_tpu_torch.ops import native_build
from gubernator_tpu_torch.ops.bucket_kernel import (
    COLLAPSED_IN_ROWS,
    PACKED_IN_ROWS,
    PACKED_OUT_ROWS,
    BucketState,
    check_shard_pin,
    shard_clears_reference,
    shard_views,
    sharded_collapsed_step_reference,
    sharded_fused_step_reference,
)
from gubernator_tpu_torch.ops.collapsed_step import PUBLISH_WORDS
from gubernator_tpu_torch.ops.fused_step import check_cuda, launches, state_pointers, stream_of


def shard_clear_rows(clears, shard_cap: int, floor: int = 16) -> np.ndarray:
    """Per-shard clear lists (`clears[sh]`, slots of shard sh) → the int32
    [n_sh, C] rows K11 / K12 take: each row sorted, padded with
    `shard_cap + i` (out of range in the shard) to C, the pow2 ladder
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
               clear_slots: torch.Tensor) -> torch.Tensor:
    """K11: (state [n_sh * shard_cap], pin int32 [n_sh, 16, W],
    clear_slots int32 [n_sh, C], rows ascending) → pout int32
    [n_sh, 5, W]; `state` is updated in place."""
    n_sh = _check(state, pin, PACKED_IN_ROWS, shard_cap, clear_slots)
    dev = pin.device
    if dev.type == "cpu":
        shard_clears_reference(state, clear_slots, shard_cap)
        return sharded_fused_step_reference(state, pin, shard_cap)
    if dev.type != "cuda":
        raise ValueError(f"shard_step: unsupported device {dev}")
    check_cuda(pin, "pin", dev)
    check_cuda(clear_slots, "clear_slots", dev)
    cols, _cap = state_pointers(state, dev)
    width = pin.shape[2]
    lib = native_build.load("sharded_step")
    pout = torch.empty((n_sh, PACKED_OUT_ROWS, width), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.guber_shard_step(cols, shard_cap, n_sh, pin.data_ptr(), width,
                                  clear_slots.data_ptr(), clear_slots.shape[1],
                                  pout.data_ptr(), stream_of(dev))
    if rc != 0:
        raise RuntimeError(f"shard_step (K11) launch failed: cudaError {rc}")
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
