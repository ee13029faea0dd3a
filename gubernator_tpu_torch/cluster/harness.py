"""In-process cluster harness: N full port daemons in one process.

Port of `gubernator_tpu/cluster/harness.py:1-110` (reference
cluster/cluster.go): `start(n)` spawns real daemons with test-tuned
behaviors, every address 127.0.0.1:0, and gives each the full peer list
through `Daemon.set_peers` instead of discovery; `kill` / `restart`
serve the failure tests, and the fault-injection veneer (`install_faults`,
`partition`, `isolate`, `heal`) drives the chaos cases.  Every node is a
whole `Daemon`: its engine (on `device`), its gRPC listener, its HTTP
gateway.  The membership, handoff and multi-region parts of the
reference's harness come with their planes (ROADMAP A entry 4).
"""

from __future__ import annotations

import random
import time
from dataclasses import replace as dc_replace
from typing import List, Optional, Sequence

from gubernator_tpu_torch.clock import SYSTEM_CLOCK, Clock
from gubernator_tpu_torch.cluster import faults
from gubernator_tpu_torch.config import BehaviorConfig, DaemonConfig
from gubernator_tpu_torch.daemon import Daemon, spawn_daemon
from gubernator_tpu_torch.types import PeerInfo


def cluster_behaviors() -> BehaviorConfig:
    """Cluster-test knobs (reference cluster/cluster.go:109-115): the
    forward path and the health plane on a test timescale."""
    return BehaviorConfig(
        batch_timeout=1.0,
        batch_wait=0.005,
        circuit_backoff=0.1,
        circuit_backoff_cap=1.0,
        forward_backoff=0.005,
        forward_backoff_cap=0.05,
    )


class ClusterHarness:
    """Spawn and wire N in-process daemons."""

    def __init__(self) -> None:
        self.daemons: List[Daemon] = []
        self._datacenters: List[str] = []
        self._clock: Clock = SYSTEM_CLOCK
        self._behaviors = cluster_behaviors()
        self._cache_size = 5_000
        self._device = None
        self._conf_extra: dict = {}
        self._injector = None

    # -- startup ---------------------------------------------------------

    def start(self, count: int, *, datacenters: Optional[Sequence[str]] = None,
              clock: Clock = SYSTEM_CLOCK, behaviors: Optional[BehaviorConfig] = None,
              cache_size: int = 5_000, device=None, **conf) -> "ClusterHarness":
        """Start `count` daemons (datacenters[i] is node i's) on `device`
        and give every daemon the full peer list (reference
        cluster/cluster.go:101-136 StartWith).  `conf` sets other
        DaemonConfig fields of every node (sweep_interval, ledger, ...)."""
        self._datacenters = list(datacenters or [""] * count)
        if len(self._datacenters) != count:
            raise ValueError("one datacenter a daemon")
        self._clock = clock
        if behaviors is not None:
            self._behaviors = behaviors
        self._cache_size = cache_size
        self._device = device
        self._conf_extra = conf
        try:
            for i in range(count):
                self.daemons.append(self._spawn(self._datacenters[i]))
            self._push_peers()
            self._verify_membership()
        except BaseException:
            # No live daemons (listeners, engines, threads) leak: the
            # caller has no handle to stop them yet.
            self.stop()
            raise
        return self

    def _spawn(self, datacenter: str, grpc_address: str = "127.0.0.1:0") -> Daemon:
        conf = DaemonConfig(
            grpc_listen_address=grpc_address,
            http_listen_address="127.0.0.1:0",
            behaviors=dc_replace(self._behaviors),
            cache_size=self._cache_size,
            data_center=datacenter,
            peer_discovery_type="none",
            **self._conf_extra,
        )
        return spawn_daemon(conf, clock=self._clock, device=self._device)

    def _push_peers(self) -> None:
        peers = self.peers()
        for d in self.daemons:
            d.set_peers(peers)

    def _verify_membership(self) -> None:
        """Every daemon sees its data center's members with exactly one
        marked as itself, and routes some keys elsewhere (reference
        harness.py :131-185)."""
        if len(self.daemons) < 2:
            return
        dc_count: dict = {}
        for dc in self._datacenters:
            dc_count[dc] = dc_count.get(dc, 0) + 1
        for d, dc in zip(self.daemons, self._datacenters):
            members = [(p.info.grpc_address, p.info.is_owner)
                       for p in d.instance.get_peer_list()]
            if len(members) != dc_count[dc] or sum(o for _, o in members) != 1:
                raise RuntimeError(f"degenerate membership at {d.grpc_address}: {members}")
            # Probe keys vary a LEADING byte: FNV-1 does not avalanche
            # trailing-byte differences (hash_ring.py).
            if dc_count[dc] >= 2 and all(d.instance.get_peer(f"{i}_hprobe").info.is_owner
                                         for i in range(64)):
                raise RuntimeError(f"{d.grpc_address} owns every probe key")

    # -- introspection ---------------------------------------------------

    def peers(self) -> List[PeerInfo]:
        return [d.peer_info() for d in self.daemons]

    def daemon_at(self, idx: int) -> Daemon:
        """reference cluster/cluster.go:63-66 (DaemonAt)."""
        return self.daemons[idx]

    def peer_at(self, idx: int) -> PeerInfo:
        """reference cluster/cluster.go:58-61 (PeerAt)."""
        return self.daemons[idx].peer_info()

    def get_random_peer(self, datacenter: str = "") -> PeerInfo:
        """reference cluster/cluster.go:68-79 (GetRandomPeer)."""
        options = [d.peer_info() for d, dc in zip(self.daemons, self._datacenters)
                   if dc == datacenter]
        if not options:
            raise ValueError(f"no peers in datacenter {datacenter!r}")
        return random.choice(options)

    def owner_of(self, key: str, datacenter: str = "") -> Daemon:
        """The daemon that owns `key` on `datacenter`'s ring."""
        entry = next((d for d, dc in zip(self.daemons, self._datacenters) if dc == datacenter),
                     None)
        if entry is None:
            raise ValueError(f"no daemons in datacenter {datacenter!r}")
        addr = entry.instance.get_peer(key).info.grpc_address
        for d in self.daemons:
            if d.peer_info().grpc_address == addr:
                return d
        raise AssertionError(f"owner {addr} not in harness")

    def non_owner_of(self, key: str) -> Daemon:
        """A daemon of the default data center that does NOT own `key`."""
        owner_addr = self.owner_of(key).peer_info().grpc_address
        for d, dc in zip(self.daemons, self._datacenters):
            if dc == "" and d.peer_info().grpc_address != owner_addr:
                return d
        raise AssertionError("cluster too small for a non-owner")

    def health_states(self) -> dict:
        """{observer: {peer: circuit state}}: the chaos suite's oracle."""
        return {
            d.peer_info().grpc_address: {p.info.grpc_address: p.health.state()
                                         for p in d.instance.get_peer_list()
                                         if not p.info.is_owner}
            for d in self.daemons if d.instance is not None
        }

    # -- fault injection (cluster/faults.py) -----------------------------

    def install_faults(self, seed: int = 0, **rates):
        """Install one process-wide seeded FaultInjector (every node of
        the in-process cluster sends through it); `stop` removes it."""
        self._injector = faults.install(faults.FaultInjector(seed, **rates))
        return self._injector

    def uninstall_faults(self) -> None:
        faults.uninstall()
        self._injector = None

    def partition(self, src_idx: int, dst_idx: int) -> None:
        """Block node src's sends to dst only."""
        self._injector.partition(self.peer_at(src_idx).grpc_address,
                                 self.peer_at(dst_idx).grpc_address)

    def partition_both(self, a_idx: int, b_idx: int) -> None:
        self._injector.partition_both(self.peer_at(a_idx).grpc_address,
                                      self.peer_at(b_idx).grpc_address)

    def isolate(self, idx: int) -> None:
        """Cut one node off from everyone, both ways."""
        self._injector.isolate(self.peer_at(idx).grpc_address)

    def heal(self) -> None:
        self._injector.heal()

    # -- lifecycle -------------------------------------------------------

    def kill(self, idx: int) -> None:
        """Stop one daemon and leave it on every ring: its peers see
        connection errors (reference functional_test.go:1063-1071)."""
        self.daemons[idx].close()

    def restart(self, idx: int) -> None:
        """Restart a killed daemon on its address (reference
        cluster/cluster.go:89-98).  The port can be briefly unbindable
        after the close; the bind is retried for a second."""
        old = self.daemons[idx]
        addr = old.grpc_address
        old.close()
        deadline = time.monotonic() + 1.0
        while True:
            try:
                self.daemons[idx] = self._spawn(self._datacenters[idx], grpc_address=addr)
                break
            except OSError:
                if time.monotonic() > deadline:
                    raise
                time.sleep(0.05)
        self._push_peers()
        self._verify_membership()

    def stop(self) -> None:
        """reference cluster/cluster.go:139-145 (Stop)."""
        if self._injector is not None:
            self.uninstall_faults()
        for d in self.daemons:
            d.close()
        self.daemons = []
