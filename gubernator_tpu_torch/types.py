"""Wire-level types of the rate-limit API.

The port's own copy of `gubernator_tpu/types.py` (the port imports
nothing of the JAX package).  They mirror the reference proto contract
(reference: proto/gubernator.proto:48-192), so the JSON the gateway
prints is the JAX package's gateway JSON.  The cluster-tier types
(UpdatePeerGlobal, PeerInfo) come with the cluster planes.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Dict


class Algorithm(enum.IntEnum):
    """reference: proto/gubernator.proto:57-62"""

    TOKEN_BUCKET = 0
    LEAKY_BUCKET = 1


class Behavior(enum.IntFlag):
    """Bit flags controlling rate-limit behavior.

    reference: proto/gubernator.proto:65-131.  BATCHING is 0 (the proto
    requires a zero member); it is the default and has no effect when set.
    """

    BATCHING = 0
    NO_BATCHING = 1
    GLOBAL = 2
    DURATION_IS_GREGORIAN = 4
    RESET_REMAINING = 8
    MULTI_REGION = 16
    # Extension (no reference counterpart): route to the node-local
    # count-min-sketch approximate limiter — O(1) memory at unbounded
    # key cardinality, one-sided (never-under-count) error
    # (ops/sketch.py; BASELINE config 5).  Approximate and node-local
    # by design: no ownership routing, no peer forwarding.
    SKETCH = 32


class Status(enum.IntEnum):
    """reference: proto/gubernator.proto:164-167"""

    UNDER_LIMIT = 0
    OVER_LIMIT = 1


@dataclass
class RateLimitReq:
    """One rate-limit check; config is carried in the request.

    reference: proto/gubernator.proto:133-162
    """

    name: str = ""
    unique_key: str = ""
    hits: int = 0
    limit: int = 0
    duration: int = 0  # milliseconds (or a Gregorian interval enum)
    algorithm: int = Algorithm.TOKEN_BUCKET
    behavior: int = Behavior.BATCHING
    burst: int = 0

    def hash_key(self) -> str:
        """The canonical cache/routing key.

        reference: client.go:37-39 (HashKey = Name + "_" + UniqueKey)
        """
        return self.name + "_" + self.unique_key


@dataclass
class RateLimitResp:
    """reference: proto/gubernator.proto:169-182"""

    status: int = Status.UNDER_LIMIT
    limit: int = 0
    remaining: int = 0
    reset_time: int = 0
    error: str = ""
    metadata: Dict[str, str] = field(default_factory=dict)


@dataclass
class HealthCheckResp:
    """reference: proto/gubernator.proto:185-192"""

    status: str = ""
    message: str = ""
    peer_count: int = 0


# Max number of requests in one GetRateLimits / GetPeerRateLimits batch.
# reference: gubernator.go:41 (maxBatchSize = 1000)
MAX_BATCH_SIZE = 1000
