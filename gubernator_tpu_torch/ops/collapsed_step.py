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

A CUDA tensor goes to the kernel, one cooperative launch; a CPU tensor to
the plain `clear_occupied_reference` + `collapsed_step_reference`; any
other device raises.  No fallback from a failed launch.  Launches count
in `ops.fused_step.launches["collapsed_step"]`.
"""

from __future__ import annotations

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

# Rows of K3's int64 scratch: the per-segment terms its lanes answer from.
SCRATCH_ROWS = 11


def collapsed_step(state: BucketState, pin: torch.Tensor, clear_slots: torch.Tensor) -> torch.Tensor:
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
    scratch = torch.empty((SCRATCH_ROWS, width), dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        rc = lib.guber_collapsed_step(
            cols, cap, pin.data_ptr(), width, clear_slots.data_ptr(), clear_slots.shape[0],
            scratch.data_ptr(), pout.data_ptr(), stream_of(dev),
        )
    if rc != 0:
        raise RuntimeError(f"collapsed_step (K3) cooperative launch failed: cudaError {rc}")
    launches["collapsed_step"] += 1
    return pout
