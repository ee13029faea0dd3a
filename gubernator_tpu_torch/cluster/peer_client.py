"""PeerClient — connection and request batcher toward one owner peer.

Port of `gubernator_tpu/cluster/peer_client.py:112 PeerClient` over the
port's own unary HTTP/2 client (`core/h2_client.py UnaryChannel`) in
place of a grpc channel, with the protobuf written by
`net/proto_codec.py`.  Semantics as the reference's (peer_client.go):

- Lazy dial on first use; requests after `shutdown` fail NotReady.
- BATCHING (default): requests queue into a per-peer batch that a
  batcher thread flushes at `batch_limit` (1000) or after an
  occupancy-adaptive wait capped at `batch_wait` (`cluster/batch_loop.py
  AdaptiveWait`, GUBER_ADAPTIVE_WINDOWS); responses go back to callers in
  order (reference :535 `_get_batched`, :569 `_run`).
- NO_BATCHING: one unary GetPeerRateLimits straight away.
- `last_errs` keeps a 5-minute window of recent errors for HealthCheck.
- `PeerError.not_ready` marks a retryable connection state (UNAVAILABLE);
  the router's forward path re-picks the owner on it.

Every send passes the health plane first (`cluster/health.py`, `_gate`,
reference :207, :232): an open circuit refuses without dialing, and the
seeded fault injector (`cluster/faults.py`) taps the same point.
UNAVAILABLE and DEADLINE_EXCEEDED count as transport failures, statuses
that prove the peer answered as successes, anything else as neither.

The RPCs of the GLOBAL, handoff, replication and fleet planes
(UpdatePeerGlobals, TransferBuckets, ReplicateKeys, ObsSnapshot and
GLOBAL hit forwarding) are not ported yet: their methods raise
NotImplementedError naming ROADMAP A entry 4.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence

from gubernator_tpu_torch.cluster import faults
from gubernator_tpu_torch.cluster.health import PeerHealth
from gubernator_tpu_torch.config import BehaviorConfig
from gubernator_tpu_torch.core.h2_client import StatusCode, UnaryChannel
from gubernator_tpu_torch.net import proto_codec
from gubernator_tpu_torch.net.proto_codec import GET_PEER_RATE_LIMITS
from gubernator_tpu_torch.types import Behavior, PeerInfo, RateLimitReq, RateLimitResp
from gubernator_tpu_torch.utils import tracing

_LAST_ERRS_TTL = 300.0  # reference: peer_client.go:64 (5-minute TTL LRU)
_LAST_ERRS_CAP = 100

# Statuses that mean "the transport failed": only these feed the
# circuit breaker as failures.
_TRANSPORT_CODES = (StatusCode.UNAVAILABLE, StatusCode.DEADLINE_EXCEEDED)
# Statuses that prove the peer processed the request and answered: these
# close the circuit.  Anything else (INTERNAL from a reset stream,
# CANCELLED, UNKNOWN, ...) moves it in neither direction.
_ANSWERED_CODES = (
    StatusCode.INVALID_ARGUMENT, StatusCode.OUT_OF_RANGE, StatusCode.FAILED_PRECONDITION,
    StatusCode.RESOURCE_EXHAUSTED, StatusCode.PERMISSION_DENIED, StatusCode.UNAUTHENTICATED,
    StatusCode.NOT_FOUND, StatusCode.ALREADY_EXISTS, StatusCode.UNIMPLEMENTED,
)
_ENTRY_4 = ("is not ported yet: the GLOBAL, handoff, replication and fleet planes' RPCs "
            "come with ROADMAP A entry 4")


class PeerError(RuntimeError):
    """Error talking to a peer; `not_ready` means the peer was not
    connected and the caller may retry against a re-picked owner;
    `circuit_open` means the health plane refused the send without
    dialing (reference peer_client.go:556-580)."""

    def __init__(self, message: str, *, not_ready: bool = False, circuit_open: bool = False):
        super().__init__(message)
        self.not_ready = not_ready
        self.circuit_open = circuit_open


class _Pending:
    __slots__ = ("req", "future")

    def __init__(self, req: RateLimitReq):
        self.req = req
        self.future: Future = Future()


class PeerClient:
    """A connection to one peer with request batching."""

    def __init__(self, info: PeerInfo, behaviors: Optional[BehaviorConfig] = None, *,
                 flush_stat=None):
        self.info = info
        self.behaviors = behaviors or BehaviorConfig()
        self._flush_stat = flush_stat
        # Who sends through this client (stamped by set_peers); the fault
        # injector keys asymmetric partitions on (src, dst).
        self.src_addr = ""
        b = self.behaviors
        self.health = PeerHealth(info.grpc_address, failure_threshold=b.circuit_failures,
                                 backoff=b.circuit_backoff, backoff_cap=b.circuit_backoff_cap)
        self._channel = None
        self._lock = threading.Lock()
        self._queue: List[_Pending] = []
        self._queue_cv = threading.Condition(self._lock)
        self._closing = False
        self._batcher: Optional[threading.Thread] = None
        self._flusher: Optional[ThreadPoolExecutor] = None
        self._inflight = 0
        self._drained = threading.Condition(self._lock)
        self._last_errs: Dict[str, float] = {}

    # -- connection ------------------------------------------------------

    def _connect(self):
        """The channel, made on first use (it dials at its first call),
        with the batcher thread and the flush pool."""
        with self._lock:
            if self._closing:
                raise PeerError("already disconnecting", not_ready=True)
            if self._channel is None:
                self._channel = UnaryChannel(self.info.grpc_address)
                self._flusher = ThreadPoolExecutor(
                    max_workers=4, thread_name_prefix=f"guber-flush-{self.info.grpc_address}")
                self._batcher = threading.Thread(
                    target=self._run, name=f"guber-batch-{self.info.grpc_address}", daemon=True)
                self._batcher.start()
            return self._channel

    def _gate(self) -> None:
        """The pre-dial health gate: refuse at once when the circuit is
        open, then pass the send through the fault injector when one is
        installed (its faults count as real transport failures)."""
        if not self.health.allow():
            tracing.add_event("circuit_open", peer=self.info.grpc_address)
            raise PeerError(
                f"circuit open to {self.info.grpc_address} "
                f"(probe in {self.health.retry_after():.2f}s)",
                not_ready=True, circuit_open=True)
        inj = faults.active()
        if inj is not None:
            try:
                inj.check(self.src_addr, self.info.grpc_address)
            except faults.FaultError as e:
                self.health.record_failure()
                self._set_last_err(str(e))
                raise PeerError(str(e), not_ready=True) from e

    def _observe_status(self, code: int) -> None:
        if code in _TRANSPORT_CODES:
            self.health.record_failure()
        elif code in _ANSWERED_CODES:
            self.health.record_success()

    def _set_last_err(self, err: str) -> None:
        now = time.monotonic()
        with self._lock:
            self._last_errs[err] = now
            if len(self._last_errs) > _LAST_ERRS_CAP:
                for k in sorted(self._last_errs, key=self._last_errs.get)[
                        : len(self._last_errs) - _LAST_ERRS_CAP]:
                    del self._last_errs[k]

    def last_errs(self) -> List[str]:
        """Recent (<= 5 min) errors (reference peer_client.go:294-306)."""
        cutoff = time.monotonic() - _LAST_ERRS_TTL
        with self._lock:
            self._last_errs = {k: t for k, t in self._last_errs.items() if t >= cutoff}
            return list(self._last_errs)

    def _call(self, what: str, reqs: Sequence[RateLimitReq], timeout: Optional[float], *,
              batched: bool = False) -> List[RateLimitResp]:
        """One GetPeerRateLimits RPC (the caller passed `_gate`).  A
        batcher flush (`batched`) is in flight already (`_run` counted
        it) and drains the queue during shutdown too, on the channel the
        batcher was made with."""
        channel = self._channel if batched else self._connect()
        with self._lock:
            if self._closing and not batched:
                raise PeerError("already disconnecting", not_ready=True)
            self._inflight += not batched
        try:
            code, msg, body = channel.call(
                GET_PEER_RATE_LIMITS, proto_codec.encode_get_peer_rate_limits_req(reqs),
                timeout or self.behaviors.batch_timeout)
        finally:
            with self._lock:
                self._inflight -= not batched
                self._drained.notify_all()
        if code != StatusCode.OK:
            name = StatusCode(code).name if code in StatusCode._value2member_map_ else str(code)
            err = f"{what} to {self.info.grpc_address}: {name}: {msg}"
            self._set_last_err(err)
            self._observe_status(code)
            raise PeerError(err, not_ready=code == StatusCode.UNAVAILABLE)
        self.health.record_success()
        try:
            resps = proto_codec.decode_get_peer_rate_limits_resp(body)
        except proto_codec.DecodeError as e:
            err = f"{what} to {self.info.grpc_address}: undecodable response: {e}"
            self._set_last_err(err)
            raise PeerError(err) from e
        if len(resps) != len(reqs):
            err = "number of rate limits in peer response does not match request"
            self._set_last_err(err)
            raise PeerError(err)
        return resps

    # -- public API ------------------------------------------------------

    def get_peer_rate_limit(self, req: RateLimitReq,
                            timeout: Optional[float] = None) -> RateLimitResp:
        """Forward one request; batched unless NO_BATCHING (reference
        :265, peer_client.go:171-205)."""
        if int(req.behavior) & int(Behavior.NO_BATCHING):
            return self.get_peer_rate_limits([req], timeout=timeout)[0]
        return self._get_batched(req, timeout)

    def get_peer_rate_limits(self, reqs: Sequence[RateLimitReq],
                             timeout: Optional[float] = None) -> List[RateLimitResp]:
        """One unary batch RPC (reference :277, peer_client.go:208-246)."""
        with tracing.span("peer.batch_rpc", peer=self.info.grpc_address, batch=len(reqs)):
            self._gate()
            return self._call("GetPeerRateLimits", reqs, timeout)

    def send_peer_hits(self, reqs, timeout=None):
        raise NotImplementedError(f"PeerClient.send_peer_hits {_ENTRY_4}")

    def send_peer_hits_raw(self, payload, timeout=None):
        raise NotImplementedError(f"PeerClient.send_peer_hits_raw {_ENTRY_4}")

    def update_peer_globals(self, globals_, timeout=None):
        raise NotImplementedError(f"PeerClient.update_peer_globals {_ENTRY_4}")

    def update_peer_globals_raw(self, payload, timeout=None):
        raise NotImplementedError(f"PeerClient.update_peer_globals_raw {_ENTRY_4}")

    def transfer_buckets_raw(self, payload, timeout=None):
        raise NotImplementedError(f"PeerClient.transfer_buckets_raw {_ENTRY_4}")

    def replicate_keys_raw(self, payload, timeout=None):
        raise NotImplementedError(f"PeerClient.replicate_keys_raw {_ENTRY_4}")

    def obs_snapshot_raw(self, timeout=None):
        raise NotImplementedError(f"PeerClient.obs_snapshot_raw {_ENTRY_4}")

    # -- batching --------------------------------------------------------

    def _get_batched(self, req: RateLimitReq, timeout: Optional[float]) -> RateLimitResp:
        """Enqueue and wait (reference peer_client.go:308-376).  A
        circuit-open peer fails before the enqueue: one dict probe, not a
        batch_timeout wait on a future that can only fail."""
        if not self.health.would_allow():
            raise PeerError(
                f"circuit open to {self.info.grpc_address} "
                f"(probe in {self.health.retry_after():.2f}s)",
                not_ready=True, circuit_open=True)
        self._connect()
        pending = _Pending(req)
        with self._lock:
            if self._closing:
                raise PeerError("already disconnecting", not_ready=True)
            self._queue.append(pending)
            self._queue_cv.notify()
        try:
            result = pending.future.result(timeout=timeout or self.behaviors.batch_timeout)
        except TimeoutError:
            raise PeerError(
                f"timeout waiting for batched response from {self.info.grpc_address}") from None
        if isinstance(result, Exception):
            raise result
        return result

    def _run(self) -> None:
        """Batcher loop: flush at batch_limit or an occupancy-adaptive
        wait capped at batch_wait (reference peer_client.go:380-453)."""
        from gubernator_tpu_torch.cluster.batch_loop import AdaptiveWait

        limit = self.behaviors.batch_limit
        cap = self.behaviors.batch_wait
        adaptive = AdaptiveWait(cap, limit) if self.behaviors.adaptive_windows else None
        while True:
            with self._lock:
                while not self._queue and not self._closing:
                    self._queue_cv.wait()
                if self._closing and not self._queue:
                    return
                # The first item is in: hold the window open until the
                # deadline or the batch limit.
                wait = adaptive.next_wait() if adaptive is not None else cap
                deadline = time.monotonic() + wait
                while len(self._queue) < limit and not self._closing:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    self._queue_cv.wait(remaining)
                batch = self._queue[:limit]
                del self._queue[: len(batch)]
                if adaptive is not None:
                    adaptive.observe(len(batch))
                self._inflight += 1
            self._flusher.submit(self._send_queue, batch)

    def _send_queue(self, batch: List[_Pending]) -> None:
        """One flush: the RPC, then each caller its response, in order
        (reference peer_client.go:457-516)."""
        t0 = time.monotonic()
        with tracing.span("peer.flush", peer=self.info.grpc_address, batch=len(batch)):
            try:
                self._gate()
                resps = self._call("GetPeerRateLimits batch", [p.req for p in batch], None,
                                   batched=True)
                for p, r in zip(batch, resps):
                    p.future.set_result(r)
            except Exception as e:  # noqa: BLE001 — every caller gets the error
                for p in batch:
                    if not p.future.done():
                        p.future.set_result(e)
            finally:
                with self._lock:
                    self._inflight -= 1
                    self._drained.notify_all()
        if self._flush_stat is not None:
            self._flush_stat.observe(time.monotonic() - t0)

    # -- lifecycle -------------------------------------------------------

    def shutdown(self, timeout: float = 5.0) -> None:
        """Stop taking work, drain the queue and the RPCs in flight, close
        the channel (reference peer_client.go:519-553)."""
        with self._lock:
            if self._closing:
                return
            self._closing = True
            self._queue_cv.notify_all()
        if self._batcher is not None:
            self._batcher.join(timeout)
        deadline = time.monotonic() + timeout
        with self._lock:
            while self._inflight > 0:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._drained.wait(remaining)
        if self._flusher is not None:
            self._flusher.shutdown(wait=True)
        if self._channel is not None:
            self._channel.close()

    def queue_length(self) -> int:
        with self._lock:
            return len(self._queue)

    def inflight(self) -> int:
        """RPCs in flight plus queued items awaiting a flush."""
        with self._lock:
            return self._inflight + len(self._queue)
