"""Wrappers of the split arm's kernels K14-K16 (csrc/split_step.cu).

Port of the reference's unfused compute + scatter pair, the A/B control
that `GUBER_FUSED=split` selects (gubernator_tpu/core/engine.py:674-696):

* `packed_compute(state, pin)` — kernel K14, the port of
  `bucket_kernel.py:1246 _packed_compute_core` (jit `packed_compute`):
  one packed round (pin int32 [16, W], as `pack_rounds_host` lays out one
  round) updated with no state write.  Returns (slot int32 [W], a view of
  pin row 1; words int32 [12, W], each lane's new state words; pout int32
  [5, W]).
* `scatter_store(state, slot, words)` — kernel K15, the port of
  `:815 _scatter_values` (jit `scatter_store`): the words written at the
  slots, in place; lanes outside [0, cap) are dropped.
* `collapsed_compute(state, pin)` — kernel K16, the port of `:1425
  collapsed_compute` (`_collapsed_values`): the collapsed hot-key step of
  `ops.collapsed_step` (pin int32 [19, W]) with no clears and no state
  write.  Returns (slot, a view of pin row 1, the segment slots; words,
  each segment column's final words; pout in request-lane order).

The reference passes `SlotValues` between the halves and encodes them in
the scatter; here the compute kernels encode and pass the twelve words,
which leave the same state.  On CUDA the words of a lane (or segment
column) whose slot lies outside [0, cap) are not written: the scatter
drops that lane.  The plain versions (`ops.bucket_kernel
packed_compute_reference`, `scatter_store_reference`,
`collapsed_compute_reference`) compute every lane's.

A CUDA tensor goes to the kernel, one plain launch on the current
stream; a CPU tensor to the plain version; any other device raises.  No
fallback from a failed launch.  Launches count in
`ops.fused_step.split_launches`.  K16 shares K3's publish buffer of the
current stream (`ops.collapsed_step`), under its lock.
"""

from __future__ import annotations

import torch

from gubernator_tpu_torch.ops import native_build
from gubernator_tpu_torch.ops.bucket_kernel import (
    COLLAPSED_IN_ROWS,
    N_COLS,
    PACKED_OUT_ROWS,
    BucketState,
    check_pin,
    check_words,
    collapsed_compute_reference,
    packed_compute_reference,
    scatter_store_reference,
)
from gubernator_tpu_torch.ops.collapsed_step import _publish_entry, _publish_lock
from gubernator_tpu_torch.ops.fused_step import (
    check_cuda,
    split_launches,
    state_pointers,
    stream_of,
)


def _outputs(pin: torch.Tensor):
    """The words and pout buffers of a compute launch over `pin`."""
    width = pin.shape[1]
    if width < 1:
        raise ValueError("empty pin")
    return (torch.empty((N_COLS, width), dtype=torch.int32, device=pin.device),
            torch.empty((PACKED_OUT_ROWS, width), dtype=torch.int32, device=pin.device))


def packed_compute(state: BucketState, pin: torch.Tensor):
    """(state, pin int32 [16, W]) → (slot, words int32 [12, W], pout int32
    [5, W]); the state is read, not written."""
    dev = pin.device
    if dev.type == "cpu":
        return packed_compute_reference(state, pin)
    if dev.type != "cuda":
        raise ValueError(f"packed_compute: unsupported device {dev}")
    check_pin(pin)
    check_cuda(pin, "pin", dev)
    cols, cap = state_pointers(state, dev)
    words, pout = _outputs(pin)
    lib = native_build.load("split_step")
    with torch.cuda.device(dev):
        rc = lib.guber_packed_compute(cols, cap, pin.data_ptr(), pin.shape[1], words.data_ptr(),
                                      pout.data_ptr(), stream_of(dev))
    if rc != 0:
        raise RuntimeError(f"packed_compute (K14) launch failed: cudaError {rc}")
    split_launches["packed_compute"] += 1
    return pin[1], words, pout


def scatter_store(state: BucketState, slot: torch.Tensor, words: torch.Tensor) -> None:
    """Write `words` (int32 [12, W]) at `slot` (int32 [W], unique in
    range) in place, dropping lanes outside [0, cap)."""
    dev = slot.device
    if words.device != dev:
        raise ValueError(f"words is on {words.device}, slot on {dev}")
    if dev.type == "cpu":
        scatter_store_reference(state, slot, words)
        return
    if dev.type != "cuda":
        raise ValueError(f"scatter_store: unsupported device {dev}")
    check_words(slot, words)
    check_cuda(slot, "slot", dev)
    check_cuda(words, "words", dev)
    cols, cap = state_pointers(state, dev)
    if slot.shape[0] < 1:
        raise ValueError("scatter_store: no lanes")
    lib = native_build.load("split_step")
    with torch.cuda.device(dev):
        rc = lib.guber_scatter_store(cols, cap, slot.data_ptr(), words.data_ptr(),
                                     slot.shape[0], stream_of(dev))
    if rc != 0:
        raise RuntimeError(f"scatter_store (K15) launch failed: cudaError {rc}")
    split_launches["scatter_store"] += 1


def collapsed_compute(state: BucketState, pin: torch.Tensor):
    """(state, pin int32 [19, W] as `pack_collapsed_host` lays it out) →
    (slot, words int32 [12, W], pout int32 [5, W]); the state is read,
    not written."""
    dev = pin.device
    if dev.type == "cpu":
        return collapsed_compute_reference(state, pin)
    if dev.type != "cuda":
        raise ValueError(f"collapsed_compute: unsupported device {dev}")
    check_pin(pin, COLLAPSED_IN_ROWS)
    check_cuda(pin, "pin", dev)
    cols, cap = state_pointers(state, dev)
    words, pout = _outputs(pin)
    width = pin.shape[1]
    lib = native_build.load("split_step")
    tiles = -(-width // lib.guber_collapsed_compute_threads())
    with torch.cuda.device(dev), _publish_lock:
        entry = _publish_entry(dev, tiles)
        pub = entry[0]
        rc = lib.guber_collapsed_compute(cols, cap, pin.data_ptr(), width, pub.data_ptr(),
                                         pub.shape[0] - 1, entry[1], words.data_ptr(),
                                         pout.data_ptr(), stream_of(dev))
        if rc == 0:
            entry[1] += tiles
    if rc != 0:
        raise RuntimeError(f"collapsed_compute (K16) launch of {tiles} blocks failed: "
                           f"cudaError {rc}")
    split_launches["collapsed_compute"] += 1
    return pin[1], words, pout
