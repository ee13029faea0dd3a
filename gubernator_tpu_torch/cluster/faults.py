"""Deterministic fault injection for the cluster transport.

The port's copy of `gubernator_tpu/cluster/faults.py`: one seed gives
the same fates in either package.

Chaos tests need *repeatable* failure: a seeded injector that decides
drop / delay / reset per send from one `random.Random(seed)` stream,
plus binary asymmetric partitions that need no randomness at all.
The injection point is the narrow waist every peer RPC already passes
through — PeerClient's send methods call `check(src, dst)` right
before the wire — so one wrapper covers the forward path, the GLOBAL
hit fan-out, the broadcast plane, and multi-region pushes.

Faults raise `FaultError`, which PeerClient maps to the same
`PeerError(not_ready=True)` a real UNAVAILABLE produces: the health
plane, circuit breakers, and degraded-mode answering see an injected
partition exactly as they would a dead NIC.  Latency faults sleep in
the sending thread (the caller's own timeout budget still applies).

Installation is process-global (`install()` / `uninstall()`), matching
the in-process ClusterHarness where all "nodes" share one interpreter;
`ClusterHarness.partition()/heal()` are the operator-shaped veneer.
Nothing in this module is imported on the serving path unless an
injector is installed — the gate in PeerClient is one module-attribute
read when idle.
"""

from __future__ import annotations

import random
import threading
import time
from typing import Dict, Optional, Set, Tuple


class FaultError(RuntimeError):
    """An injected transport fault (mapped to PeerError(not_ready))."""

    def __init__(self, kind: str, src: str, dst: str):
        super().__init__(f"injected {kind} {src or '?'} -> {dst}")
        self.kind = kind


class FaultInjector:
    """Seeded per-send fault decisions + asymmetric partitions.

    Rates are evaluated in a fixed order (drop, reset, latency) against
    one seeded stream, so two injectors with the same seed and the same
    send sequence make identical decisions.  Partition rules are
    binary and direction-sensitive: `partition(a, b)` blocks a→b only
    (the classic asymmetric-partition failure), `partition_both` blocks
    both directions; `heal()` removes matching rules (None wildcards).
    """

    def __init__(
        self,
        seed: int = 0,
        *,
        drop_rate: float = 0.0,
        reset_rate: float = 0.0,
        latency_rate: float = 0.0,
        latency_s: float = 0.05,
    ):
        self.seed = seed
        self.drop_rate = drop_rate
        self.reset_rate = reset_rate
        self.latency_rate = latency_rate
        self.latency_s = latency_s
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        # Directed blocks: (src, dst); "*" wildcards one side.
        self._partitions: Set[Tuple[str, str]] = set()  # guberlint: guarded-by _lock
        # Directed ALWAYS-ON latency links: (src, dst) -> seconds.
        # Unlike the rate-based latency_rate (a random spike model),
        # these emulate a link's deterministic RTT — the inter-region
        # DCN hop the crossregion bench injects (RESILIENCE.md §12).
        self._latency_links: Dict[Tuple[str, str], float] = {}  # guberlint: guarded-by _lock
        self.injected: Dict[str, int] = {}  # guberlint: guarded-by _lock

    # -- partitions ----------------------------------------------------

    def partition(self, src: str, dst: str) -> None:
        """Block src→dst sends (one direction — asymmetric)."""
        with self._lock:
            self._partitions.add((src, dst))

    def partition_both(self, a: str, b: str) -> None:
        with self._lock:
            self._partitions.add((a, b))
            self._partitions.add((b, a))

    def isolate(self, addr: str) -> None:
        """Block every send to AND from `addr`."""
        with self._lock:
            self._partitions.add((addr, "*"))
            self._partitions.add(("*", addr))

    def heal(self, src: Optional[str] = None, dst: Optional[str] = None) -> None:
        """Remove partition rules matching (src, dst); None wildcards
        that side, so `heal()` clears every rule.  Only the ARGUMENT
        side wildcards: a stored `isolate()` rule like ("*", "B") is
        removed by heal(), heal(dst="B") or heal("*", "B"), but never
        as a side effect of healing some other node's partitions."""
        with self._lock:
            self._partitions = {
                (s, d)
                for (s, d) in self._partitions
                if not (
                    (src is None or s == src)
                    and (dst is None or d == dst)
                )
            }

    # -- directed latency links ----------------------------------------

    def add_latency(self, src: str, dst: str, seconds: float) -> None:
        """Inject a deterministic per-send delay on src→dst (one
        direction; "*" wildcards a side) — inter-region RTT emulation.
        Stacks with the rate-based latency model; the largest matching
        link wins when wildcards overlap."""
        with self._lock:
            self._latency_links[(src, dst)] = seconds

    def clear_latency(
        self, src: Optional[str] = None, dst: Optional[str] = None
    ) -> None:
        """Remove latency links matching (src, dst); None wildcards
        that side (argument-side only, like heal())."""
        with self._lock:
            self._latency_links = {
                (s, d): v
                for (s, d), v in self._latency_links.items()
                if not (
                    (src is None or s == src)
                    and (dst is None or d == dst)
                )
            }

    def _link_delay_locked(self, src: str, dst: str) -> float:  # guberlint: holds _lock
        links = self._latency_links
        if not links:
            return 0.0
        return max(
            links.get((src, dst), 0.0),
            links.get((src, "*"), 0.0),
            links.get(("*", dst), 0.0),
        )

    def _partitioned(self, src: str, dst: str) -> bool:  # guberlint: holds _lock
        p = self._partitions
        return (
            (src, dst) in p
            or (src, "*") in p
            or ("*", dst) in p
        )

    # -- the per-send gate ---------------------------------------------

    def check(self, src: str, dst: str) -> None:
        """Decide this send's fate.  Raises FaultError for drops,
        partitions, and resets; sleeps for latency spikes; returns for
        clean sends.  Decisions draw from the seeded stream in a fixed
        order so equal seeds replay equal fates."""
        with self._lock:
            if self._partitioned(src, dst):
                self._count("partition")
                raise FaultError("partition", src, dst)
            # Single draw per configured rate, fixed order.
            if self.drop_rate > 0 and self._rng.random() < self.drop_rate:
                self._count("drop")
                raise FaultError("drop", src, dst)
            if self.reset_rate > 0 and self._rng.random() < self.reset_rate:
                self._count("reset")
                raise FaultError("reset", src, dst)
            delay = 0.0
            if self.latency_rate > 0 and self._rng.random() < self.latency_rate:
                self._count("latency")
                delay = self.latency_s
            link = self._link_delay_locked(src, dst)
            if link > 0:
                self._count("link_latency")
                delay += link
        if delay > 0:
            time.sleep(delay)

    def _count(self, kind: str) -> None:  # guberlint: holds _lock
        self.injected[kind] = self.injected.get(kind, 0) + 1

    def counts(self) -> Dict[str, int]:
        with self._lock:
            return dict(self.injected)


# -- process-global installation ---------------------------------------

_active: Optional[FaultInjector] = None


def install(injector: FaultInjector) -> FaultInjector:
    """Install the process-global injector (chaos tests / harness)."""
    global _active
    _active = injector
    return injector


def uninstall() -> None:
    global _active
    _active = None


def active() -> Optional[FaultInjector]:
    return _active
