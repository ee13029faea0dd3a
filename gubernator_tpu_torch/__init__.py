"""gubernator_tpu_torch — the PyTorch/CUDA port of gubernator_tpu.

The same rate limiter (token and leaky buckets over 48 B/slot device
state, answered in batched rounds) with the decision step as a CUDA
kernel written for Hopper (csrc/).  The JAX package `gubernator_tpu` is
the reference this port is held against word for word; the port imports
nothing of it.  Entry points run on `cuda` unless the caller passes
`device="cpu"`, where the plain PyTorch versions of the kernels run.
"""

from gubernator_tpu_torch.types import (
    MAX_BATCH_SIZE,
    Algorithm,
    Behavior,
    RateLimitReq,
    RateLimitResp,
    Status,
)

__all__ = [
    "MAX_BATCH_SIZE",
    "Algorithm",
    "Behavior",
    "RateLimitReq",
    "RateLimitResp",
    "Status",
]
