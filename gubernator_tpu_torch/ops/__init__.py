"""Device-side state layout and the kernels of the decision step.

The public step, as the reference's `gubernator_tpu/ops/__init__.py`
exports it: `apply_batch(state, batch, clear_slots, now_ms)` (kernel K17
on a CUDA state, its plain version on a CPU one) over a `BucketState` made
by `make_state(capacity, device)`, a `BatchInput` in and a `BatchOutput`
out."""

from gubernator_tpu_torch.ops.apply_batch import apply_batch
from gubernator_tpu_torch.ops.bucket_kernel import (
    BatchInput,
    BatchOutput,
    BucketState,
    make_state,
)

__all__ = ["BucketState", "BatchInput", "BatchOutput", "apply_batch", "make_state"]
