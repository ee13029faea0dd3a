"""V1Instance — the service core of one node, on the port's engine.

Port of `gubernator_tpu/service.py:284 V1Instance`: the batch-size check
and per-item validation of GetRateLimits, then the reference's partition
(:575-700).  An item with the SKETCH bit goes to the node-local
count-min sketch (`ops/sketch.py SketchLimiter`, built on first use on
the engine's device), whatever its other bits.  Every other valid item
is routed by the peer ring (`set_peers`, `cluster/hash_ring.py`; the
reference's :1705): items this node owns, and every item while the ring
is empty, go to the engine in one call (`apply_local_batch`, :1652);
items another node owns are grouped by owner and forwarded to it as
PeersV1/GetPeerRateLimits (`_forward_group`, :795-960: the re-pick loop
on NotReady with backoff after a real dial failure, and `degraded_local`
answers from this engine when the owner cannot be reached,
`_degraded_answer` :766), their answers marked with `metadata.owner`.
The owner answers a forwarded batch with `get_peer_rate_limits` (:1560),
never forwarding again.

The GLOBAL and MULTI_REGION planes are not ported (ROADMAP A entry 4):
on a node with peers (any other member on its ring, or any peer in
another data center) such items are answered with a per-item error that
says so, counted in `check_errors`, on both entry points.  With no peers
they keep the answers of C1: they go to the engine with their behavior
bits as sent.  There the reference's GLOBAL and MULTI_REGION managers
have no one to send to, so the engine's answer is the answer;
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
the sequential state.  With no GLOBAL plane there is no broadcast cache
for the ledger's read-only tier.  The columnar routes serve a batch only
when this node owns every key (`all_locally_owned`, :976): the h2 front
through `serve_decoded_local` declines it otherwise, and the gRPC
listener (`net/grpc_listener.py`) then takes the full decode, through
`serve_wire_columnar`, which skips the check for a forwarded batch.

The hot-key sketch (utils/hotkeys.py `SpaceSaving`, GUBER_HOTKEYS, on by
default; reference :465-509) is built on every instance, as the
reference builds it, and counts the decision keys of both entry points:
the dataclass path's items before the engine call (:604-620) and the
columnar rows before the ledger (`_offer_hotkeys`, :1009); the ledger
credits what its native plane answered when it pulls a lease back.  Its
readers are the gateway's /debug/hotkeys and, over a paged engine, the
eviction clock (`_hot_slots`): pages that hold the top keys get a grace
pass of the clock hand, as in the reference, whose victims, and so
device words, the port must match.

Observability (reference :380-430, :510-526, :572, :751): `get_rate_limits`
runs in a `service.get_rate_limits` span; `stage_timers` holds the
reference's stage budget — `engine_serve` (observed on the columnar
route, `serve_decoded_local`, where the reference's columnar wire route
observes it), `device.step` (the engine's `round_duration`),
`device.readback` (its readback's `transfer_duration`),
`device.window_wait` (its pump's), `device.page_fault` (paging's fault
time) and the stages of the planes a node with no peers never enters
(`wire_window_wait`, `hits_window_wait`, `owner_rpc`, `broadcast_age`,
`multiregion.window_wait`, `multiregion.region_rpc`), which stay at 0
as on the reference's node with no peers.  `admission_watch`
(obs/slo.py) counts the admitted hits of watched keys from
`get_rate_limits`' answers; the daemon attaches `flight_recorder`,
`native_events`, `obs` and `slo_watchdog`.  `counters` has the
reference's keys; the port moves `check_errors`, `local` and `sketch`,
where the reference's node with no peers moves them (its native fronts'
columnar route counts none).
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import replace
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from gubernator_tpu_torch.cluster.hash_ring import RegionPicker, make_picker
from gubernator_tpu_torch.cluster.health import backoff_delay
from gubernator_tpu_torch.cluster.peer_client import PeerClient, PeerError
from gubernator_tpu_torch.config import BehaviorConfig
from gubernator_tpu_torch.obs.slo import AdmissionWatch
from gubernator_tpu_torch.utils import hotkeys as _hotkeys
from gubernator_tpu_torch.utils import tracing
from gubernator_tpu_torch.utils.metrics import DurationStat
from gubernator_tpu_torch.utils.tracing import span
from gubernator_tpu_torch.types import (
    MAX_BATCH_SIZE,
    Algorithm,
    Behavior,
    HealthCheckResp,
    PeerInfo,
    RateLimitReq,
    RateLimitResp,
    Status,
)

HEALTHY = "healthy"
UNHEALTHY = "unhealthy"
_GLOBAL = int(Behavior.GLOBAL)
_SKETCH = int(Behavior.SKETCH)
_TOKEN = int(Algorithm.TOKEN_BUCKET)
# Rows that can never be answered from leased credit (reference :68): the
# sketch stamps limit 0 for them, so lease sizing skips them.
_LEASE_BREAKERS = (
    int(Behavior.DURATION_IS_GREGORIAN) | int(Behavior.RESET_REMAINING)
    | int(Behavior.MULTI_REGION) | _SKETCH
)

# Behaviors the columnar route declines (reference service.py:79-82):
# GLOBAL and MULTI_REGION (their managers' queues), Gregorian durations
# (per-item civil-time validation with an error in the response) and
# SKETCH (the approximate limiter, not the bucket engine).  The port's
# `apply_columnar` could serve Gregorian items, but the front declines
# them as the reference's does.
COLUMNAR_DISQUALIFIERS = (
    _GLOBAL | int(Behavior.MULTI_REGION) | int(Behavior.DURATION_IS_GREGORIAN) | _SKETCH
)

# The behaviours whose planes are not ported: on a node with peers such an
# item gets `CLUSTER_GAP_ERROR`.
_CLUSTER_GAP = _GLOBAL | int(Behavior.MULTI_REGION)
CLUSTER_GAP_ERROR = ("GLOBAL and MULTI_REGION behaviors on a node with peers are not "
                     "ported yet (ROADMAP A entry 4)")


class ServiceError(RuntimeError):
    """RPC-level error (the gateway maps it to HTTP 400, gRPC code 11).

    The only RPC-level failure the contract allows is an oversized batch
    (reference: gubernator.go:212-216); per-item problems travel in
    RateLimitResp.error.  `code` names the gRPC status (reference
    service.py:96)."""

    def __init__(self, message: str, code: str = "OUT_OF_RANGE"):
        super().__init__(message)
        self.code = code


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
    """GetRateLimits, GetPeerRateLimits and HealthCheck over one
    DecisionEngine, its decision ledger (`ledger`: GUBER_LEDGER;
    `ledger_opts`: `DecisionLedger`'s keywords,
    `DaemonConfig.ledger_opts()`), one sketch limiter (`sketch_*`:
    GUBER_SKETCH_*; config.py) and the peer ring (`behaviors`, the
    forwarding knobs; `peer_picker`, `hash_algorithm`, `picker_replicas`,
    the ring's; `data_center`, which peers are local)."""

    def __init__(self, engine, *, sketch_window_ms: int = 1_000, sketch_depth: int = 4,
                 sketch_width: int = 1 << 20, ledger: bool = True,
                 ledger_opts: Optional[Mapping] = None,
                 behaviors: Optional[BehaviorConfig] = None,
                 peer_picker: str = "replicated-hash", hash_algorithm: str = "fnv1",
                 picker_replicas: int = 512, data_center: str = ""):
        self.engine = engine
        self.behaviors = behaviors or BehaviorConfig()
        self.data_center = data_center
        # guberlint: guard local_picker, region_picker by _peer_lock
        self.local_picker = make_picker(peer_picker, hash_algorithm, picker_replicas)
        self.region_picker = RegionPicker(hash_algorithm, picker_replicas)
        self._peer_lock = threading.RLock()
        # Whether any other node is on the rings: the GLOBAL and
        # MULTI_REGION gap applies then (set by set_peers).
        self._clustered = False
        self._forward_pool = ThreadPoolExecutor(max_workers=32,
                                                thread_name_prefix="guber-forward")
        self._drains: List[threading.Thread] = []
        self._closed = False
        # The flush time of every PeerClient's batch (reference
        # guber_batch_send_duration).
        self.flush_duration = DurationStat()
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
        # The reference's counters (:334); "sketch" counts the items the
        # approximate limiter decided, "columnar" the columnar route's.
        self.counters = {k: 0 for k in (
            "local", "columnar", "forward", "global", "sketch", "global_miss_local",
            "check_errors", "async_retries", "backoff_retries", "degraded_answers",
            "replicated_local", "degraded_region_answers")}
        self.stage_timers = {name: DurationStat() for name in (
            "wire_window_wait", "engine_serve", "hits_window_wait", "owner_rpc",
            "broadcast_age", "multiregion.window_wait", "multiregion.region_rpc")}
        self.stage_timers["device.step"] = engine.round_duration
        self.stage_timers["device.readback"] = engine.readback.transfer_duration
        pump = getattr(engine, "_pump", None)
        if pump is not None:
            self.stage_timers["device.window_wait"] = pump.window_wait
        paging = getattr(engine, "paging", None)
        if paging is not None:
            self.stage_timers["device.page_fault"] = paging.fault_duration
        # Hot-key attribution: None when GUBER_HOTKEYS is off.
        self.hotkeys = _hotkeys.from_env()
        if self.hotkeys is not None and paging is not None:
            paging.hot_slots_provider = self._hot_slots_provider(engine, self.hotkeys)
        if self.ledger is not None and self.hotkeys is not None:
            # Native drains surface their per-key counts only when the
            # ledger pulls a lease back: it credits them there.
            self.ledger.hotkeys = self.hotkeys
        # Attached by the daemon (None for a bare instance): the tail
        # flight recorder, the native event collector, the rollup and the
        # SLO watchdog, and the h2 front the rollup's gauge reads.
        self.flight_recorder = None
        self.native_events = None
        self.obs = None
        self.slo_watchdog = None
        self.h2_front = None
        # Always present: one attribute peek a batch while nothing is
        # watched.
        self.admission_watch = AdmissionWatch()

    @staticmethod
    def _hot_slots_provider(engine, sketch):
        """The paged state's heat feed (reference :474-498): the logical
        slots of the sketch's 32 top keys by current rate.  It runs under
        the engine lock (from `translate`), so `contains` then `intern`
        is atomic; `intern` of a present key is a lookup."""
        table, clock = engine.table, engine.clock

        def hot_slots() -> List[int]:
            out: List[int] = []
            now = clock.now_ms()
            for key, rate, _lim, _dur in sketch.top_rates(32):
                if rate <= 0:
                    break
                try:
                    ks = key.decode()
                except UnicodeDecodeError:
                    continue
                if table.contains(ks):
                    out.append(table.intern(ks, now, []))
            return out

        return hot_slots

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
        with span("service.get_rate_limits", batch=len(requests)):
            return self._get_rate_limits(requests)

    def _get_rate_limits(self, requests: Sequence[RateLimitReq]) -> List[RateLimitResp]:
        if len(requests) > MAX_BATCH_SIZE:
            self.counters["check_errors"] += 1
            raise ServiceError(
                f"Requests.RateLimits list too large; max size is '{MAX_BATCH_SIZE}'"
            )
        responses: List[Optional[RateLimitResp]] = [None] * len(requests)
        now_ms = self.engine.clock.now_ms()
        candidates: List[int] = []
        sketch: List[int] = []
        for i, r in enumerate(requests):
            if not r.unique_key:
                self.counters["check_errors"] += 1
                responses[i] = RateLimitResp(error="field 'unique_key' cannot be empty")
            elif not r.name:
                self.counters["check_errors"] += 1
                responses[i] = RateLimitResp(error="field 'namespace' cannot be empty")
            elif int(r.behavior) & _SKETCH:
                sketch.append(i)
            else:
                candidates.append(i)
        if sketch:
            for i, resp in zip(sketch, self._apply_sketch([requests[i] for i in sketch], now_ms)):
                responses[i] = resp
        keys = [requests[i].hash_key() for i in candidates]
        if self.hotkeys is not None and candidates:
            # Lease-sizing aux: only rows the lease algebra could cover
            # stamp their limit (reference :604-620).
            self.hotkeys.offer_many_params(
                (k.encode(), max(r.hits, 1),
                 r.limit if int(r.algorithm) == _TOKEN
                 and not int(r.behavior) & _LEASE_BREAKERS else 0,
                 r.duration)
                for k, r in zip(keys, (requests[i] for i in candidates))
            )
        with self._peer_lock:
            picker, clustered = self.local_picker, self._clustered
        owners = picker.get_batch(keys) if picker.size() and keys else [None] * len(keys)
        local: List[int] = []
        forward: Dict[str, Tuple[PeerClient, List[int]]] = {}
        for i, owner in zip(candidates, owners):
            if clustered and int(requests[i].behavior) & _CLUSTER_GAP:
                self.counters["check_errors"] += 1
                responses[i] = RateLimitResp(error=CLUSTER_GAP_ERROR)
            elif owner is None or owner.info.is_owner:
                local.append(i)
            else:
                forward.setdefault(owner.info.grpc_address, (owner, []))[1].append(i)
        if local:
            # Owned here, or the ring is empty: GLOBAL items included
            # when there are no peers (reference :725).
            self.counters["local"] += len(local)
            answers = self.apply_local_batch([requests[i] for i in local], now_ms=now_ms)
            for i, resp in zip(local, answers):
                responses[i] = resp
        if forward:
            # One pool task an owner; the caller's span context travels
            # explicitly (tracing.current_context is thread-local).
            ctx = tracing.current_context()
            futures = []
            for peer, idxs in forward.values():
                self.counters["forward"] += len(idxs)
                futures.append(self._forward_pool.submit(
                    self._forward_group, peer, idxs, requests, responses, ctx))
            for f in futures:
                f.result()
        aw = self.admission_watch
        if aw.active:
            # The admission-bound feed (obs/slo.py): watched keys count the
            # hits their client-facing answers admitted.
            aw.observe_batch(requests, responses)
        return responses  # type: ignore[return-value]

    def apply_local_batch(self, reqs: List[RateLimitReq],
                          now_ms: Optional[int] = None) -> List[RateLimitResp]:
        """One engine call for items this node answers (reference :1652),
        with the GLOBAL owner's read-back of its GLOBAL items at the tail
        (`_global_reads`; only on a node with no peers do GLOBAL items
        get here).  The ledger's entries for the batch's keys are settled
        and dropped first (reference :1672-1678: one dict probe a key,
        almost always a miss), so the engine computes on the sequential
        state."""
        if not reqs:
            return []
        batch = list(reqs) + _global_reads(reqs)
        if self.ledger is not None:
            self.ledger.invalidate_keys([r.hash_key().encode() for r in batch])
        return self.engine.get_rate_limits(batch, now_ms=now_ms)[: len(reqs)]

    def get_peer_rate_limits(self, requests: Sequence[RateLimitReq]) -> List[RateLimitResp]:
        """The owner's side of a forwarded batch (reference :1560,
        gubernator.go:493-559): answered here, never forwarded again, in
        one engine call; on a node with peers a GLOBAL or MULTI_REGION
        item gets the entry-4 error, as on `get_rate_limits`."""
        if len(requests) > MAX_BATCH_SIZE:
            self.counters["check_errors"] += 1
            raise ServiceError(
                f"'PeerRequest.rate_limits' list too large; max size is '{MAX_BATCH_SIZE}'"
            )
        with span("service.get_peer_rate_limits", batch=len(requests)):
            with self._peer_lock:
                clustered = self._clustered
            out: List[Optional[RateLimitResp]] = [None] * len(requests)
            ok: List[int] = []
            for i, r in enumerate(requests):
                if clustered and int(r.behavior) & _CLUSTER_GAP:
                    self.counters["check_errors"] += 1
                    out[i] = RateLimitResp(error=CLUSTER_GAP_ERROR)
                else:
                    ok.append(i)
            for i, resp in zip(ok, self.apply_local_batch([requests[i] for i in ok])):
                out[i] = resp
            return out  # type: ignore[return-value]

    def _degraded_answer(self, ids: List[int], requests: Sequence[RateLimitReq],
                         responses: List[Optional[RateLimitResp]], owner_addr: str) -> None:
        """Answer forwarded items from THIS engine because their owner
        cannot be reached (circuit open, retries spent; reference :766),
        marked `metadata.degraded` beside `metadata.owner`: availability
        over accuracy, at most N_partitions x limit admitted a key."""
        tracing.add_event("degraded_answer", owner=owner_addr, items=len(ids))
        resps = self.apply_local_batch([requests[i] for i in ids])
        self.counters["degraded_answers"] += len(ids)
        for i, resp in zip(ids, resps):
            md = dict(resp.metadata) if resp.metadata else {}
            md["degraded"] = "true"
            md["owner"] = owner_addr
            resp.metadata = md
            responses[i] = resp

    def _forward_group(self, peer: PeerClient, idxs: List[int],
                       requests: Sequence[RateLimitReq],
                       responses: List[Optional[RateLimitResp]], parent_ctx=None) -> None:
        """The forward pool's task: a span anchored to the caller's
        trace around `_forward_group_traced`."""
        with span("forward.group", parent_ctx=parent_ctx, peer=peer.info.grpc_address,
                  batch=len(idxs)):
            self._forward_group_traced(peer, idxs, requests, responses)

    def _forward_group_traced(self, peer: PeerClient, idxs: List[int],
                              requests: Sequence[RateLimitReq],
                              responses: List[Optional[RateLimitResp]]) -> None:
        """Forward one owner's items with the ownership-migration loop
        (reference :795-960, gubernator.go:333-422): up to 5 re-picks on
        NotReady, applying locally once the ring names this node; a
        re-pick after a real dial failure first sleeps a capped
        exponential backoff with full jitter; an open circuit answers
        degraded at once (GUBER_DEGRADED_LOCAL), as do spent retries,
        unless degraded mode is off, which gives the reference's error
        strings.  A group of several items goes as one GetPeerRateLimits;
        a lone item rides the peer's batcher (or goes straight with
        NO_BATCHING)."""
        groups: Dict[str, Tuple[PeerClient, List[int]]] = {peer.info.grpc_address: (peer, idxs)}
        behaviors = self.behaviors
        degraded_on = behaviors.degraded_local
        attempts = 0
        while groups:
            if attempts > 5:
                for p, ids in groups.values():
                    if degraded_on:
                        self._degraded_answer(ids, requests, responses, p.info.grpc_address)
                        continue
                    for i in ids:
                        self.counters["check_errors"] += 1
                        responses[i] = RateLimitResp(
                            error=("GetPeer() keeps returning peers that are not "
                                   f"connected for '{requests[i].hash_key()}'"))
                return
            retry: List[int] = []
            dialed_and_failed = False
            for p, ids in groups.values():
                if attempts != 0 and p.info.is_owner:
                    # Ownership moved here (reference gubernator.go:368-383).
                    for i, resp in zip(ids, self.apply_local_batch([requests[i] for i in ids])):
                        responses[i] = resp
                    continue
                try:
                    if len(ids) == 1:
                        resps = [p.get_peer_rate_limit(requests[ids[0]],
                                                       timeout=behaviors.batch_timeout)]
                    else:
                        resps = p.get_peer_rate_limits([requests[i] for i in ids],
                                                       timeout=behaviors.batch_timeout)
                except PeerError as e:
                    if e.circuit_open:
                        tracing.add_event("circuit_open", peer=p.info.grpc_address,
                                          items=len(ids))
                        if degraded_on:
                            # A re-pick would hand back the same broken
                            # peer: answer here now.
                            self._degraded_answer(ids, requests, responses, p.info.grpc_address)
                            continue
                    if e.not_ready:
                        self.counters["async_retries"] += len(ids)
                        retry.extend(ids)
                        if not e.circuit_open:
                            dialed_and_failed = True
                        continue
                    for i in ids:
                        responses[i] = RateLimitResp(
                            error=(f"Error while fetching rate limit "
                                   f"'{requests[i].hash_key()}' from peer: {e}"))
                    continue
                for i, resp in zip(ids, resps):
                    resp.metadata = {"owner": p.info.grpc_address}
                    responses[i] = resp
            if not retry:
                return
            attempts += 1
            if dialed_and_failed:
                delay = backoff_delay(attempts - 1, behaviors.forward_backoff,
                                      behaviors.forward_backoff_cap)
                if delay > 0:
                    self.counters["backoff_retries"] += len(retry)
                    time.sleep(delay)
            # Re-pick the retried items' owners: they may map elsewhere now.
            groups = {}
            for i in retry:
                try:
                    p = self.get_peer(requests[i].hash_key())
                except Exception as pick_err:  # noqa: BLE001 — the item carries the error
                    responses[i] = RateLimitResp(
                        error=(f"Error finding peer that owns rate limit "
                               f"'{requests[i].hash_key()}': {pick_err}"))
                    continue
                groups.setdefault(p.info.grpc_address, (p, []))[1].append(i)

    def _owned_mask(self, dec):
        """Each row's "owned here" for a decoded wire batch, or None when
        the ring is empty (every key is this node's; reference :962)."""
        with self._peer_lock:
            picker = self.local_picker
        n_peers = picker.size()
        if n_peers == 0:
            return None
        if n_peers == 1:
            return np.full(dec.n, bool(picker.peers()[0].info.is_owner))
        owners = picker.get_batch_dual_hashed(dec.fnv1, dec.fnv1a)
        return np.fromiter((o.info.is_owner for o in owners), bool, dec.n)

    def all_locally_owned(self, dec) -> bool:
        """Whether this node owns every key of a decoded wire batch: the
        columnar routes' gate (reference :976)."""
        owned = self._owned_mask(dec)
        return owned is None or bool(owned.all())

    def serve_wire_columnar(self, dec, *, check_ownership: bool = True):
        """The gRPC listener's columnar route (reference :1100
        `serve_wire_bytes`, less its group-commit window): the columns of
        `serve_decoded_local`, or None to decline to the full decode.  A
        forwarded batch (`check_ownership=False`) is served whoever owns
        its keys; the counters move as the reference's route moves them."""
        if self.engine.store is not None:
            return None
        if check_ownership:
            if not self.all_locally_owned(dec):
                return None
            self.counters["local"] += dec.n
        self.counters["columnar"] += dec.n
        return self._serve_columns(dec)

    def serve_decoded_local(self, dec):
        """The post-decode columnar serve of the native h2 front
        (reference :1028): a `net.wire_codec.DecodedBatch` → (status,
        limit, remaining, reset) columns, through the decision ledger when
        it is on, or None to decline (the front answers UNIMPLEMENTED).
        It declines when a write-through store is attached, which
        `apply_columnar` cannot honour, and when another node owns one of
        the keys (the fronts never answer peer-owned keys: clustered
        deployments route them through the gRPC listener's forward path;
        reference :1047)."""
        if self.engine.store is not None or not self.all_locally_owned(dec):
            return None
        return self._serve_columns(dec)

    def _serve_columns(self, dec):
        """Offer the rows to the hot-key sketch, then serve them through
        the ledger, or straight from the engine."""
        from gubernator_tpu_torch.core.engine import PackedKeys

        engine = self.engine
        self._offer_hotkeys(dec)
        if self.ledger is not None:
            return self._serve_decoded_ledger(dec)
        t_serve = time.monotonic()
        try:
            return engine.apply_columnar(
                PackedKeys(dec.key_buf, dec.key_offsets, dec.n), dec.algo, dec.behavior,
                dec.hits, dec.limit, dec.duration, dec.burst, **self._routes(dec.fnv1a),
            )
        finally:
            self.stage_timers["engine_serve"].observe(time.monotonic() - t_serve)

    def _routes(self, fnv1a) -> dict:
        """The sharded engine's shard routes (reference :1055-1062): the
        wire decode's fnv1a-64 of each key, the intern table's own hash,
        so the host tier hashes nothing again."""
        return {"route_hashes": fnv1a} if hasattr(self.engine, "tables") else {}

    def _offer_hotkeys(self, dec) -> None:
        """Columnar hot-key accounting (reference :1009): rows the lease
        algebra could never cover stamp limit 0."""
        hk = self.hotkeys
        if hk is None:
            return
        lim = np.asarray(dec.limit)
        elig = ((np.asarray(dec.algo) == _TOKEN)
                & ((np.asarray(dec.behavior) & _LEASE_BREAKERS) == 0) & (lim > 0))
        hk.offer_columns(dec.key_buf, dec.key_offsets, dec.hits, hashes=dec.fnv1a,
                         limit=np.where(elig, lim, 0), duration=dec.duration)

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
        t_serve = time.monotonic()
        try:
            out = engine.apply_columnar(
                PackedKeys(lane.key_buf, lane.key_offsets, lane.n), lane.algo, lane.behavior,
                lane.hits, lane.limit, lane.duration, lane.burst, **self._routes(lane.fnv1a),
            )
        except Exception:
            plan.rollback()
            raise
        finally:
            self.stage_timers["engine_serve"].observe(time.monotonic() - t_serve)
        st, lim, rem, rst = out
        plan.learn(st, lim, rem, rst)
        if not plan.answered_rows and lane is dec:
            return out
        return plan.merge_outputs(st, rem, rst)

    def health_check(self) -> HealthCheckResp:
        """Healthy unless a peer failed in the last five minutes; the peer
        count is the rings' (reference :1530, gubernator.go:562-619)."""
        with self._peer_lock:
            local_peers = self.local_picker.peers()
            region_peers = self.region_picker.peers()
        errs = [f"Error returned from local peer.GetLastErr: {e}"
                for p in local_peers for e in p.last_errs()]
        errs += [f"Error returned from region peer.GetLastErr: {e}"
                 for p in region_peers for e in p.last_errs()]
        resp = HealthCheckResp(status=HEALTHY, peer_count=len(local_peers) + len(region_peers))
        if errs:
            resp.status = UNHEALTHY
            resp.message = "|".join(errs)
        return resp

    # -- peers (reference :1705-1790, gubernator.go:657-765) -------------

    def set_peers(self, peer_infos: Sequence[PeerInfo]) -> None:
        """Rebuild the rings from a full peer list (the entry with
        `is_owner` is this node), keeping the clients of peers that stay
        and draining the dropped ones on threads of their own.  A peer in
        another data center goes to the region picker, as in the
        reference (strict match)."""
        with self._peer_lock:
            local_picker = self.local_picker.new()
            region_picker = self.region_picker.new()
            me_addr = next((p.grpc_address for p in peer_infos if p.is_owner), "")
            local_members: List[PeerClient] = []
            for info in peer_infos:
                remote = info.datacenter != self.data_center
                old = (self.region_picker if remote else self.local_picker).get_by_peer_info(info)
                peer = old or PeerClient(info, self.behaviors, flush_stat=self.flush_duration)
                peer.info = info
                peer.src_addr = me_addr
                if remote:
                    region_picker.add(peer)
                else:
                    local_members.append(peer)
            local_picker.add_all(local_members)  # one ring rebuild
            old_peers = self.local_picker.peers() + self.region_picker.peers()
            self.local_picker = local_picker
            self.region_picker = region_picker
            self._clustered = (region_picker.size() > 0
                               or any(not p.info.is_owner for p in local_members))
        keep = {p.info.grpc_address for p in local_picker.peers() + region_picker.peers()}
        self._drains = [t for t in self._drains if t.is_alive()]
        for p in old_peers:
            if p.info.grpc_address not in keep:
                t = threading.Thread(target=p.shutdown, name="guber-peer-drain", daemon=True)
                t.start()
                self._drains.append(t)

    def get_peer(self, key: str) -> PeerClient:
        """The owner of one key (reference gubernator.go:743-765)."""
        with self._peer_lock:
            return self.local_picker.get(key)

    def get_peer_list(self) -> List[PeerClient]:
        with self._peer_lock:
            return self.local_picker.peers()

    def close(self) -> None:
        """Close the ledger (its flusher joined, every delegated lease
        pulled back, pending returns applied), the forward pool and the
        peer clients, then the engine."""
        if self._closed:
            return
        self._closed = True
        if self.ledger is not None:
            self.ledger.close()
        self._forward_pool.shutdown(wait=True)
        with self._peer_lock:
            peers = self.local_picker.peers() + self.region_picker.peers()
        for p in peers:
            p.shutdown(timeout=1.0)
        for t in self._drains:
            t.join(timeout=5.0)
        self.engine.close()
