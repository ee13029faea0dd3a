"""Wrapper of kernel K3, the collapsed hot-key step (csrc/collapsed_step.cu).

Port of `gubernator_tpu/ops/bucket_kernel.py:1417 collapsed_step` (the
XLA program `_collapsed_step_core`), with the chunk's eviction clears,
which the reference engine runs just before it (core/engine.py:1359):

* `collapsed_step(state, pin, clear_slots)` — clear the occupied bit at
  `clear_slots`, then one full application per duplicate segment of
  `pin` (int32 [19, W], `ops.bucket_kernel.pack_collapsed_host`) and the
  closed form for its extras; `state` is updated in place, returns the
  [5, W] int32 output in request-lane order.  As `pack_collapsed_host`
  lays it out, every lane points at a real segment or at the last
  column; the kernel skips the other padding columns.

A CUDA tensor goes to the kernel, one plain launch of ceil(W / 64)
blocks on the current stream; a CPU tensor to the plain
`clear_occupied_reference` + `collapsed_step_reference`; any other
device raises.  No fallback from a failed launch.  Launches count in
`ops.fused_step.launches["collapsed_step"]`.

Input contract of the kernel (what every producer gives, and what
`ops.bucket_kernel.check_collapsed` asserts): row 17 (a lane's segment)
never decreases along the lanes; segment s's lanes are contiguous, row
18 (position) running 0 .. m_s - 1, row 2 holding m_s, segment slots
ascending; padding lanes come last and point at column W - 1 at
position 0.  The kernel gives each segment to the block that holds its
first lane, so it needs no grid barrier; `clear_slots` may come in any
order.  A segment that runs past its block's end (a hot key) is
published by its owner block to a small int64 buffer kept per device and
stream, under a stamp that no earlier launch used, and the blocks holding
its other lanes wait for it and answer them.  A block takes its tile of
64 lanes by a ticket from a counter in that buffer, so it waits only on
blocks already running; a wait that still times out (a pin that breaks
the layout) traps, and the launch's error reaches the caller at the next
synchronisation.  The buffer's counter and the count this module keeps
must agree, so launches with one buffer are made under a lock, in the
order they reach the stream.
"""

from __future__ import annotations

import threading

import torch

from gubernator_tpu_torch.ops import native_build
from gubernator_tpu_torch.ops.bucket_kernel import (
    COLLAPSED_IN_ROWS,
    PACKED_OUT_ROWS,
    BucketState,
    check_pin,
    check_state,
    clear_occupied_reference,
    collapsed_step_reference,
)
from gubernator_tpu_torch.ops.fused_step import check_cuda, launches, state_pointers, stream_of

# int64 words of a row of the publish buffer (csrc/collapsed_step.cu kPub).
PUBLISH_WORDS = 16

# (device index, stream) → [publish buffer int64 [1 + tiles, PUBLISH_WORDS],
# tiles launched with it]: row 0 holds the kernel's ticket counter, and a
# stamp (tiles launched before + 1) is never reused with its buffer, so
# nothing needs clearing between launches.
_publish: dict = {}
_publish_lock = threading.Lock()


def _publish_entry(dev: torch.device, tiles: int) -> list:
    """The publish buffer of `dev`'s current stream, with room for
    `tiles` tiles (called under `_publish_lock`)."""
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    key = (index, torch.cuda.current_stream(dev).cuda_stream)
    entry = _publish.get(key)
    if entry is None or entry[0].shape[0] < 1 + tiles:
        entry = [torch.zeros((1 + max(tiles, 128), PUBLISH_WORDS), dtype=torch.int64,
                             device=dev), 0]
        _publish[key] = entry
    return entry


def collapsed_step(state: BucketState, pin: torch.Tensor,
                   clear_slots: torch.Tensor) -> torch.Tensor:
    """(state, pin int32 [19, W], clear_slots int32 [C], C >= 0) → pout
    int32 [5, W]; `state` is updated in place."""
    dev = pin.device
    check_pin(pin, COLLAPSED_IN_ROWS)
    if clear_slots.dtype != torch.int32 or clear_slots.dim() != 1:
        raise ValueError("clear_slots must be a 1-D int32 tensor")
    if clear_slots.device != dev:
        raise ValueError(f"clear_slots is on {clear_slots.device}, pin on {dev}")
    if dev.type == "cpu":
        check_state(state)
        if clear_slots.shape[0]:
            clear_occupied_reference(state.meta, clear_slots)
        return collapsed_step_reference(state, pin)
    if dev.type != "cuda":
        raise ValueError(f"collapsed_step: unsupported device {dev}")
    check_cuda(pin, "pin", dev)
    check_cuda(clear_slots, "clear_slots", dev)
    cols, cap = state_pointers(state, dev)
    width = pin.shape[1]
    if width < 1:
        raise ValueError("collapsed_step: empty pin")
    lib = native_build.load("collapsed_step")
    pout = torch.empty((PACKED_OUT_ROWS, width), dtype=torch.int32, device=dev)
    tiles = -(-width // lib.guber_collapsed_threads())
    with torch.cuda.device(dev), _publish_lock:
        entry = _publish_entry(dev, tiles)
        pub = entry[0]
        rc = lib.guber_collapsed_step(
            cols, cap, pin.data_ptr(), width, clear_slots.data_ptr(), clear_slots.shape[0],
            pub.data_ptr(), pub.shape[0] - 1, entry[1], pout.data_ptr(), stream_of(dev),
        )
        if rc == 0:
            entry[1] += tiles
    if rc != 0:
        raise RuntimeError(f"collapsed_step (K3) launch of {tiles} blocks failed: cudaError {rc}")
    launches["collapsed_step"] += 1
    return pout
