"""V1Instance — the service core of one node, on the port's engine.

Port of `gubernator_tpu/service.py:284 V1Instance` on a node with no
peers and no regions: the batch-size check and per-item validation of
GetRateLimits, then the reference's partition (:587-600, :695-730).  An
item with the SKETCH bit goes to the node-local count-min sketch
(`ops/sketch.py SketchLimiter`, built on first use on the engine's
device), whatever its other bits; every other valid item, GLOBAL and
MULTI_REGION included, goes to the engine in one call with its behavior
bits as sent.  With no peers the reference's GLOBAL and MULTI_REGION
managers have no one to send to, so the engine's answer is the answer;
but the GLOBAL manager still reads its keys back through the engine
before its (empty) broadcast, and that read can change a bucket, so the
port runs it too, as extra items at the tail of the same engine call
(`_global_reads`).  `serve_decoded_local` is the columnar entry of the
native h2 front (net/h2_fast.py): wire-decoded columns through the
decision ledger (core/ledger.py; the reference's default, GUBER_LEDGER)
to `apply_columnar`.  The ledger is built, as the reference's is
(:293-313), when `ledger` is on and no write-through store is attached;
the dataclass path settles and drops the ledger's entries for its keys
before its engine call (`invalidate_keys`), so the engine computes on
the sequential state.  Peers, forwarding and the cluster planes are not
in the port yet: with no peers there is no GLOBAL broadcast cache for
the ledger's read-only tier.
"""

from __future__ import annotations

import threading
from dataclasses import replace
from typing import List, Mapping, Optional, Sequence

import numpy as np

from gubernator_tpu_torch.types import (
    MAX_BATCH_SIZE,
    Behavior,
    HealthCheckResp,
    RateLimitReq,
    RateLimitResp,
    Status,
)

HEALTHY = "healthy"
_GLOBAL = int(Behavior.GLOBAL)
_SKETCH = int(Behavior.SKETCH)

# Behaviors the columnar route declines (reference service.py:79-82):
# GLOBAL and MULTI_REGION (their managers' queues), Gregorian durations
# (per-item civil-time validation with an error in the response) and
# SKETCH (the approximate limiter, not the bucket engine).  The port's
# `apply_columnar` could serve Gregorian items, but the front declines
# them as the reference's does.
COLUMNAR_DISQUALIFIERS = (
    _GLOBAL | int(Behavior.MULTI_REGION) | int(Behavior.DURATION_IS_GREGORIAN) | _SKETCH
)


class ServiceError(RuntimeError):
    """RPC-level error (the gateway maps it to HTTP 400, gRPC code 11).

    The only RPC-level failure the contract allows is an oversized batch
    (reference: gubernator.go:212-216); per-item problems travel in
    RateLimitResp.error."""


def _global_reads(reqs: Sequence[RateLimitReq]) -> List[RateLimitReq]:
    """The GLOBAL owner's read-back before its broadcast (reference
    cluster/global_manager.py:1042 `_reread_encoded`, :1099
    `_reread_own_state`): each key's latest GLOBAL request of the batch,
    with hits 0 and GLOBAL cleared.  The caller appends them to the
    batch's engine call and drops their answers; the engine applies a
    key's items in request order, so they read each bucket after the
    batch, as a second call would.  The read is not always a no-op:
    RESET_REMAINING refills the bucket, and a config or algorithm that a
    later item of the batch changed comes back.  The reference reads on
    its flush thread, once per sync window; here it reads once per batch,
    at the batch's `now_ms`."""
    latest = {r.hash_key(): r for r in reqs if int(r.behavior) & _GLOBAL}
    return [replace(r, hits=0, behavior=int(r.behavior) & ~_GLOBAL) for r in latest.values()]


class V1Instance:
    """GetRateLimits and HealthCheck over one DecisionEngine, its decision
    ledger (`ledger`: GUBER_LEDGER; `ledger_opts`: `DecisionLedger`'s
    keywords, `DaemonConfig.ledger_opts()`) and one sketch limiter
    (`sketch_*`: GUBER_SKETCH_*; config.py)."""

    def __init__(self, engine, *, sketch_window_ms: int = 1_000, sketch_depth: int = 4,
                 sketch_width: int = 1 << 20, ledger: bool = True,
                 ledger_opts: Optional[Mapping] = None):
        self.engine = engine
        # Host-tier decision ledger: sticky over-limit answers and bounded
        # credit leases serve hot-key decisions with no device work.
        self.ledger = None
        if ledger and engine.store is None:
            from gubernator_tpu_torch.core.ledger import DecisionLedger

            self.ledger = DecisionLedger(engine, **(ledger_opts or {}))
        self.sketch_window_ms = sketch_window_ms
        self.sketch_depth = sketch_depth
        self.sketch_width = sketch_width
        self._sketch = None
        self._sketch_lock = threading.Lock()
        self.counters = {"sketch": 0}  # items decided by the approximate limiter

    def sketch(self):
        """The sketch limiter, built on first use (reference :528)."""
        if self._sketch is None:
            with self._sketch_lock:
                if self._sketch is None:
                    from gubernator_tpu_torch.ops.sketch import SketchLimiter

                    self._sketch = SketchLimiter(self.sketch_window_ms, self.sketch_depth,
                                                 self.sketch_width, device=self.engine.device)
        return self._sketch

    def _apply_sketch(self, reqs: Sequence[RateLimitReq], now_ms: int) -> List[RateLimitResp]:
        """One sketch batch (reference :541): OVER when the estimate
        exceeds the limit, remaining = max(limit - estimate, 0), reset at
        the end of the current sketch window, no metadata."""
        sk = self.sketch()
        limit = np.fromiter((r.limit for r in reqs), dtype=np.int64, count=len(reqs))
        over, est = sk.apply([r.hash_key().encode() for r in reqs],
                             np.fromiter((r.hits for r in reqs), dtype=np.int64, count=len(reqs)),
                             limit, now_ms)
        remaining = np.maximum(limit - est, 0).tolist()
        reset = (now_ms // sk.window_ms + 1) * sk.window_ms
        self.counters["sketch"] += len(reqs)
        return [
            RateLimitResp(status=Status.OVER_LIMIT if o else Status.UNDER_LIMIT, limit=lim,
                          remaining=rem, reset_time=reset)
            for o, lim, rem in zip(over.tolist(), limit.tolist(), remaining)
        ]

    def get_rate_limits(self, requests: Sequence[RateLimitReq]) -> List[RateLimitResp]:
        """reference: gubernator.go:197-317 (GetRateLimits)."""
        if len(requests) > MAX_BATCH_SIZE:
            raise ServiceError(
                f"Requests.RateLimits list too large; max size is '{MAX_BATCH_SIZE}'"
            )
        responses: List[Optional[RateLimitResp]] = [None] * len(requests)
        now_ms = self.engine.clock.now_ms()
        local: List[int] = []
        sketch: List[int] = []
        for i, r in enumerate(requests):
            if not r.unique_key:
                responses[i] = RateLimitResp(error="field 'unique_key' cannot be empty")
            elif not r.name:
                responses[i] = RateLimitResp(error="field 'namespace' cannot be empty")
            elif int(r.behavior) & _SKETCH:
                sketch.append(i)
            else:
                local.append(i)
        if sketch:
            for i, resp in zip(sketch, self._apply_sketch([requests[i] for i in sketch], now_ms)):
                responses[i] = resp
        if local:
            reqs = [requests[i] for i in local]
            batch = reqs + _global_reads(reqs)
            if self.ledger is not None:
                # This batch runs on the engine outside the ledger: settle
                # and drop any ledger entry for its keys first (reference
                # :1672-1678; one dict probe per key, almost always a miss).
                self.ledger.invalidate_keys([r.hash_key().encode() for r in batch])
            answers = self.engine.get_rate_limits(batch, now_ms=now_ms)
            for i, resp in zip(local, answers):
                responses[i] = resp
        return responses  # type: ignore[return-value]

    def serve_decoded_local(self, dec):
        """The post-decode columnar serve of the native h2 front
        (reference :1028): a `net.wire_codec.DecodedBatch` → (status,
        limit, remaining, reset) columns, through the decision ledger when
        it is on, or None to decline (the front answers UNIMPLEMENTED).
        It declines when a write-through store is attached, which
        `apply_columnar` cannot honour.  The reference's ownership gate
        is true on a node with no peers, the only node the port has.  No
        hot-key offer: it comes with ROADMAP A item 13."""
        from gubernator_tpu_torch.core.engine import PackedKeys

        engine = self.engine
        if engine.store is not None:
            return None
        if self.ledger is not None:
            return self._serve_decoded_ledger(dec)
        return engine.apply_columnar(
            PackedKeys(dec.key_buf, dec.key_offsets, dec.n), dec.algo, dec.behavior, dec.hits,
            dec.limit, dec.duration, dec.burst,
        )

    def _serve_decoded_ledger(self, dec):
        """Ledger-aware columnar serve (reference :1065): hot-key rows
        (sticky over-limit, live lease credit) are answered without device
        work, and a window of only such rows makes no engine call at all.
        The engine lane is [settle / return rows, fall-through rows,
        acquisition rows]; a failed engine call rolls the plan back."""
        from gubernator_tpu_torch.core.engine import PackedKeys

        engine = self.engine
        plan = self.ledger.plan(dec, engine.clock.now_ms())
        if plan.full:
            return plan.dense_cols()
        lane = plan.build_engine_lane()
        try:
            out = engine.apply_columnar(
                PackedKeys(lane.key_buf, lane.key_offsets, lane.n), lane.algo, lane.behavior,
                lane.hits, lane.limit, lane.duration, lane.burst,
            )
        except Exception:
            plan.rollback()
            raise
        st, lim, rem, rst = out
        plan.learn(st, lim, rem, rst)
        if not plan.answered_rows and lane is dec:
            return out
        return plan.merge_outputs(st, rem, rst)

    def health_check(self) -> HealthCheckResp:
        """A single node with no peers is healthy (reference:
        gubernator.go:562-619 aggregates peer errors; there are none)."""
        return HealthCheckResp(status=HEALTHY, peer_count=0)

    def close(self) -> None:
        """Close the ledger (its flusher joined, every delegated lease
        pulled back, pending returns applied), then the engine."""
        if self.ledger is not None:
            self.ledger.close()
        self.engine.close()
