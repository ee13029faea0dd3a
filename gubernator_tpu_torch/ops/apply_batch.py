"""Wrapper of the dataclass decision step, kernel K17 (csrc/apply_batch.cu).

Port of `gubernator_tpu/ops/bucket_kernel.py:848 apply_batch` (jit of
`_apply_batch_impl` :356), the public step that `gubernator_tpu/ops`
exports:

* `apply_batch(state, batch, clear_slots, now_ms)` — clear meta bit 0 at
  the in-range `clear_slots` (int32 [C]; padding lanes out of range),
  then update every lane of `batch` (`ops.bucket_kernel.BatchInput`,
  [B] a field; in-range slots unique, padding at capacity + lane) at
  `now_ms`; `state` is updated in place (the reference donates it) and
  the answers come back in request order as a `BatchOutput`.

It runs on the device that holds the state: a CUDA state goes to K17,
one cooperative launch on the current stream; a CPU state to the plain
version (`ops.bucket_kernel.apply_batch_reference`); any other device
raises.  No fallback from a failed launch.  The reference sorts the batch
by slot and back on the device; K17 does not need to (the kernel's
header says why).  Launches count in `ops.fused_step.launches
["apply_batch"]`.
"""

from __future__ import annotations

import ctypes

import torch

from gubernator_tpu_torch.ops import native_build
from gubernator_tpu_torch.ops.bucket_kernel import (
    BatchInput,
    BatchOutput,
    BucketState,
    apply_batch_reference,
    check_batch,
)
from gubernator_tpu_torch.ops.fused_step import check_cuda, launches, state_pointers, stream_of


def _pointers(tensors) -> ctypes.Array:
    return (ctypes.c_void_p * len(tensors))(*(t.data_ptr() for t in tensors))


def apply_batch(state: BucketState, batch: BatchInput, clear_slots: torch.Tensor,
                now_ms) -> BatchOutput:
    """(state, batch, clear_slots int32 [C], now_ms int) → BatchOutput in
    request order; `state` updated in place.  `now_ms` may be an int or a
    0-d tensor."""
    dev = state.meta.device
    if dev.type == "cpu":
        return apply_batch_reference(state, batch, clear_slots, now_ms)
    if dev.type != "cuda":
        raise ValueError(f"apply_batch: unsupported device {dev}")
    width = check_batch(batch, clear_slots)
    for name, t in zip(BatchInput._fields, batch):
        check_cuda(t, f"batch.{name}", dev)
    check_cuda(clear_slots, "clear_slots", dev)
    cols, cap = state_pointers(state, dev)
    out = BatchOutput(*(torch.empty(width, dtype=dt, device=dev)
                        for dt in (torch.int32, torch.int64, torch.int64, torch.int64)))
    n_clear = clear_slots.shape[0]
    if width == 0 and n_clear == 0:
        return out
    lib = native_build.load("apply_batch")
    with torch.cuda.device(dev):
        rc = lib.guber_apply_batch(cols, cap, _pointers(batch), width,
                                   clear_slots.data_ptr() if n_clear else None, n_clear,
                                   int(now_ms), _pointers(out), stream_of(dev))
    if rc != 0:
        raise RuntimeError(f"apply_batch (K17) launch failed: cudaError {rc}")
    launches["apply_batch"] += 1
    return out
