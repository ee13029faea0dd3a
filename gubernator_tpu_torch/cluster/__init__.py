"""Cluster tier: the peer planes' modules that need no transport.

The port's copies of the JAX package's `cluster/hash_ring.py` (key to
owner), `health.py` (per-peer circuit breakers, backoff), `faults.py`
(seeded fault injection) and `batch_loop.py` (the interval batcher that
carries every peer RPC).  The transport and the planes over it
(forwarding, GLOBAL, membership) come with ROADMAP A entries 3 and 4.
"""

from gubernator_tpu_torch.cluster.hash_ring import (
    DEFAULT_REPLICAS,
    DualRingWindow,
    RegionPicker,
    ReplicatedConsistentHash,
)

__all__ = [
    "DEFAULT_REPLICAS",
    "DualRingWindow",
    "RegionPicker",
    "ReplicatedConsistentHash",
]
