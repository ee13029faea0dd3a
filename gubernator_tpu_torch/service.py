"""V1Instance — the service core of one node, on the port's engine.

Port of `gubernator_tpu/service.py:284 V1Instance`, single node with no
peers: the batch-size check and per-item validation of GetRateLimits,
then one engine call for every item this node answers.

Not in this slice: peers, GLOBAL, MULTI_REGION and the SKETCH limiter.
An item with one of those behaviors is answered with a per-item error
instead of a local answer that would silently drop the behavior's
guarantee.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

from gubernator_tpu_torch.types import (
    MAX_BATCH_SIZE,
    Behavior,
    HealthCheckResp,
    RateLimitReq,
    RateLimitResp,
)

HEALTHY = "healthy"

# Behaviors whose planes this slice does not carry yet.
_UNPORTED = {
    int(Behavior.GLOBAL): "GLOBAL",
    int(Behavior.MULTI_REGION): "MULTI_REGION",
    int(Behavior.SKETCH): "SKETCH",
}


class ServiceError(RuntimeError):
    """RPC-level error (the gateway maps it to HTTP 400, gRPC code 11).

    The only RPC-level failure the contract allows is an oversized batch
    (reference: gubernator.go:212-216); per-item problems travel in
    RateLimitResp.error."""


class V1Instance:
    """GetRateLimits and HealthCheck over one DecisionEngine."""

    def __init__(self, engine):
        self.engine = engine

    def get_rate_limits(self, requests: Sequence[RateLimitReq]) -> List[RateLimitResp]:
        """reference: gubernator.go:197-317 (GetRateLimits)."""
        if len(requests) > MAX_BATCH_SIZE:
            raise ServiceError(
                f"Requests.RateLimits list too large; max size is '{MAX_BATCH_SIZE}'"
            )
        responses: List[Optional[RateLimitResp]] = [None] * len(requests)
        now_ms = self.engine.clock.now_ms()
        local: List[int] = []
        for i, r in enumerate(requests):
            if not r.unique_key:
                responses[i] = RateLimitResp(error="field 'unique_key' cannot be empty")
            elif not r.name:
                responses[i] = RateLimitResp(error="field 'namespace' cannot be empty")
            else:
                unported = [n for bit, n in _UNPORTED.items() if int(r.behavior) & bit]
                if unported:
                    responses[i] = RateLimitResp(
                        error=f"behavior {'|'.join(unported)} is not supported by "
                        "this node (gubernator_tpu_torch serves local buckets only)"
                    )
                else:
                    local.append(i)
        if local:
            resps = self.engine.get_rate_limits([requests[i] for i in local], now_ms=now_ms)
            for i, resp in zip(local, resps):
                responses[i] = resp
        return responses  # type: ignore[return-value]

    def health_check(self) -> HealthCheckResp:
        """A single node with no peers is healthy (reference:
        gubernator.go:562-619 aggregates peer errors; there are none)."""
        return HealthCheckResp(status=HEALTHY, peer_count=0)

    def close(self) -> None:
        self.engine.close()
