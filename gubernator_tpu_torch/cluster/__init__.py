"""Cluster tier: the peer planes.

The port's copies of the JAX package's `cluster/hash_ring.py` (key to
owner), `health.py` (per-peer circuit breakers, backoff), `faults.py`
(seeded fault injection) and `batch_loop.py` (the interval batcher that
carries every peer RPC), with `peer_client.py` (owner forwarding over
the port's own gRPC wire) and `harness.py` (in-process clusters).  The
GLOBAL, MULTI_REGION, membership and replication planes come with
ROADMAP A entry 4.
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
