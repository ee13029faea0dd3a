"""Peer health plane: per-peer circuit-breaker state machine.

The port's copy of `gubernator_tpu/cluster/health.py` (stdlib only).

The reference fails *closed and loud* when a peer dies: every forward
re-dials the dead address until the gRPC connect timeout fires, and
the 5-retry ownership-migration loop spins with no backoff
(gubernator.go:333-422).  "Designing Scalable Rate Limiting Systems"
(PAPERS.md) names graceful degradation under partition as the defining
property of a production limiter, and "When Two is Worse Than One"
shows that exactly this backoff-free retry/redundancy amplifies tail
latency.  This module is the missing availability layer:

    healthy ──failure──▶ suspect ──N failures──▶ broken
       ▲                    │                      │ open period
       │                    └──success──▶ healthy  │ (exp. backoff)
       │                                           ▼
       └───────success──── half-open ◀──probe due──┘
                              │
                              └──failure──▶ broken (period doubles)

State is driven entirely by RPC outcomes (`record_success` /
`record_failure`) observed in PeerClient; `allow()` is the circuit
gate every send consults *before* dialing, so a broken peer costs one
dict probe per request, not a connect timeout.  While BROKEN, exactly
one caller per open-period expiry wins the HALF_OPEN probe slot; its
outcome decides whether the circuit closes or re-opens with a doubled
(capped) period.

RESILIENCE.md documents the transition table, the degradation
semantics built on top of this gate, and the operator knobs.
"""

from __future__ import annotations

import random
import threading
import time
from typing import Callable, Dict

HEALTHY = "healthy"
SUSPECT = "suspect"
BROKEN = "broken"
HALF_OPEN = "half-open"

STATES = (HEALTHY, SUSPECT, BROKEN, HALF_OPEN)

# Aggregate circuit states for one REMOTE REGION, derived from the
# per-peer breakers of the region's members (cluster/multiregion.py;
# RESILIENCE.md §12).
REGION_HEALTHY = "healthy"
REGION_DEGRADED = "degraded"
REGION_OPEN = "open"


def aggregate_region_state(healths) -> str:
    """Fold member PeerHealth breakers into one region-level state:

    - ``open``    — not a single member would accept a send right now
      (every circuit is open inside its period / probing): the region
      is unreachable, MULTI_REGION answers carry
      ``metadata.degraded_region=true``, and the §12 drift bound
      (over-admission ≤ N_regions × limit per window) is the active
      guarantee until a probe heals a member.
    - ``degraded`` — some members are broken/half-open but at least
      one accepts sends: pushes still flow (the region ring re-routes
      nothing — per-key owners are fixed — but the region is not yet
      lost, and answers stay unflagged).
    - ``healthy`` — every member's circuit is closed.

    An empty region reads healthy: no members means nothing to push
    and no drift to bound."""
    any_member = False
    any_allow = False
    any_broken = False
    for h in healths:
        any_member = True
        if h.would_allow():
            any_allow = True
        if h.state() in (BROKEN, HALF_OPEN):
            any_broken = True
    if not any_member:
        return REGION_HEALTHY
    if not any_allow:
        return REGION_OPEN
    return REGION_DEGRADED if any_broken else REGION_HEALTHY

# Process-wide jitter source for backoff_delay callers that don't
# thread their own rng.  Deterministic tests pass a seeded Random.
_jitter_rng = random.Random()


def backoff_delay(
    attempt: int,
    base: float,
    cap: float,
    rng: random.Random | None = None,
) -> float:
    """Capped exponential backoff with FULL jitter: uniform in
    [0, min(cap, base * 2^attempt)].  Full jitter (not equal jitter)
    because the forward retry loop's failure mode is a synchronized
    herd re-picking the same dead owner — spreading retries across the
    whole window is what de-correlates them ("When Two is Worse Than
    One", PAPERS.md)."""
    if base <= 0:
        return 0.0
    ceiling = min(cap, base * (2 ** max(0, attempt)))
    return (rng or _jitter_rng).uniform(0.0, ceiling)


class PeerHealth:
    """Circuit breaker for ONE peer address.

    Thread-safe; every method is a few dict/int ops under a tiny lock
    (the gate sits on the forward hot path, but only on its failure
    branches — a healthy peer costs one lock acquire + two compares).
    """

    __slots__ = (
        "addr", "failure_threshold", "backoff", "backoff_cap",
        "probe_timeout", "_lock", "_state", "_failures", "_open_until",
        "_open_period", "_probe_inflight", "_probe_started",
        "transitions", "_now",
    )

    # guberlint: guard _state, _failures, _open_until, _open_period, _probe_inflight, _probe_started by _lock

    def __init__(
        self,
        addr: str,
        *,
        failure_threshold: int = 3,
        backoff: float = 0.5,
        backoff_cap: float = 30.0,
        probe_timeout: float = 5.0,
        now: Callable[[], float] = time.monotonic,
    ):
        self.addr = addr
        self.failure_threshold = max(1, failure_threshold)
        self.backoff = backoff
        self.backoff_cap = backoff_cap
        # A half-open probe that never reports an outcome (its sender
        # died between winning the slot and the RPC — e.g. a client
        # mid-shutdown raising before the dial) would otherwise hold
        # the slot forever and permanently blacklist the peer; past
        # this many seconds the slot is reclaimed by the next caller.
        self.probe_timeout = probe_timeout
        self._lock = threading.Lock()
        self._state = HEALTHY
        self._failures = 0
        self._open_until = 0.0
        self._open_period = 0.0
        self._probe_inflight = False
        self._probe_started = 0.0
        # to-state -> count, scraped as
        # gubernator_circuit_transitions{peer,to}.  Mutated only under
        # _lock; reads are a snapshot copy.
        self.transitions: Dict[str, int] = {}
        self._now = now

    # -- gates ---------------------------------------------------------

    def allow(self) -> bool:
        """Circuit gate, consulted before every RPC send.  True in
        HEALTHY/SUSPECT.  In BROKEN: once the open period expires, the
        FIRST caller transitions to HALF_OPEN and wins the single probe
        slot; everyone else (and everyone before expiry) is refused
        without a dial.  In HALF_OPEN: refused while the probe is in
        flight."""
        with self._lock:
            if self._state in (HEALTHY, SUSPECT):
                return True
            now = self._now()
            if self._state == BROKEN:
                if now < self._open_until:
                    return False
                self._to(HALF_OPEN)
                self._probe_inflight = True
                self._probe_started = now
                return True
            # HALF_OPEN: one probe at a time — but reclaim a slot whose
            # probe never reported back (probe_timeout), or the peer is
            # blacklisted forever.
            if (
                self._probe_inflight
                and now - self._probe_started < self.probe_timeout
            ):
                return False
            self._probe_inflight = True
            self._probe_started = now
            return True

    def would_allow(self) -> bool:
        """Non-consuming peek: would `allow()` grant a send right now?
        Fan-out planners use it to skip submitting pool tasks for
        broken peers without stealing the half-open probe slot."""
        with self._lock:
            if self._state in (HEALTHY, SUSPECT):
                return True
            if self._state == BROKEN:
                return self._now() >= self._open_until
            return (
                not self._probe_inflight
                or self._now() - self._probe_started >= self.probe_timeout
            )

    # -- outcome feedback ---------------------------------------------

    def record_success(self) -> None:
        with self._lock:
            self._failures = 0
            self._probe_inflight = False
            if self._state != HEALTHY:
                self._to(HEALTHY)
                self._open_period = 0.0

    def record_failure(self) -> None:
        """One RPC-level failure (UNAVAILABLE / deadline / reset).
        Only *transport-shaped* outcomes should feed this — an
        application error from a live peer is a success for circuit
        purposes (the peer answered)."""
        with self._lock:
            if self._state == HALF_OPEN:
                # Probe failed: re-open with a doubled (capped) period.
                self._probe_inflight = False
                self._reopen()
                return
            if self._state == BROKEN:
                return  # already open; a racing in-flight RPC failed
            self._failures += 1
            if self._state == HEALTHY:
                self._to(SUSPECT)
            if self._failures >= self.failure_threshold:
                self._reopen()

    # -- introspection -------------------------------------------------

    def state(self) -> str:
        with self._lock:
            # Surface expiry lazily: a broken peer whose open period
            # has elapsed reads as broken until someone probes, which
            # is accurate — no probe has succeeded yet.
            return self._state

    def transition_counts(self) -> Dict[str, int]:
        with self._lock:
            return dict(self.transitions)

    def retry_after(self) -> float:
        """Seconds until the next probe is allowed (0 when closed)."""
        with self._lock:
            if self._state != BROKEN:
                return 0.0
            return max(0.0, self._open_until - self._now())

    # -- internals (caller holds _lock) --------------------------------

    def _reopen(self) -> None:  # guberlint: holds _lock
        self._open_period = (
            min(self.backoff_cap, self._open_period * 2)
            if self._open_period > 0
            else self.backoff
        )
        self._open_until = self._now() + self._open_period
        self._failures = 0
        self._to(BROKEN)

    # guberlint: invariant circuit-legal-transitions
    def _to(self, state: str) -> None:  # guberlint: holds _lock
        if state != self._state:
            self._state = state
            self.transitions[state] = self.transitions.get(state, 0) + 1
