"""Gossip peer discovery (memberlist-style, self-contained).

The port's copy of `gubernator_tpu/discovery/memberlist.py`: the same
datagrams, so pools of both packages gossip in one cluster.

reference: memberlist.go — the reference embeds hashicorp/memberlist
(SWIM gossip over UDP+TCP) and carries each node's PeerInfo as JSON
metadata (memberlist.go:126-151); join/leave/update events rebuild the
peer map (:187-233).

This backend reproduces the capability without the dependency: an
anti-entropy heartbeat gossip over UDP.  Each node keeps a member map
`addr -> (incarnation, heartbeat, PeerInfo, last_seen)`; every interval
it bumps its own heartbeat and sends its full map (JSON, one datagram)
to `fanout` random members plus any configured seed.  `last_seen` only
refreshes when a member's (incarnation, heartbeat) RISES — second-hand
gossip cannot keep a dead member alive — so members whose heartbeat
stalls for `suspect_after` are dropped.  A drop leaves a *death
certificate* (tombstone at the dead incarnation) that is itself
gossiped; without it, peers that haven't expired the member yet would
re-introduce it and the pool would oscillate.  Incarnations (startup
timestamps) resolve restarts: a restarted node's fresh incarnation
exceeds its tombstone and rejoins cleanly.

Wire format: the member map is SEGMENTED into datagrams of at most
`max_datagram` bytes (default 1200 — safely under any path MTU, like
hashicorp memberlist's packet budget).  Each datagram is a
self-contained partial map — merging is per-member idempotent
anti-entropy, so segmentation needs no reassembly protocol, and losing
a datagram only delays convergence of the members it carried.  The
sender's own entry rides in every segment so liveness never depends on
which segment survives.  Member-count envelope: a segment holds ~10
members, a 1000-member map is ~100 datagrams per target per interval
(~120KB/s at the defaults) — fine for hundreds of members, and the
soak test pins 50 members converging through loss
(tests/test_gossip_hardening.py); the data plane scales via the device
mesh, not host count.
"""

from __future__ import annotations

import json
import random
import socket
import threading
import time
from dataclasses import dataclass
from typing import TYPE_CHECKING, Dict, List, Tuple

from gubernator_tpu_torch.discovery.base import DiscoveryBase, log
from gubernator_tpu_torch.types import PeerInfo

if TYPE_CHECKING:
    from gubernator_tpu_torch.config import DaemonConfig
    from gubernator_tpu_torch.daemon import Daemon


@dataclass
class _Member:
    incarnation: int
    heartbeat: int
    info: PeerInfo
    last_seen: float


class MemberListPool(DiscoveryBase):
    """reference: memberlist.go:40-233 (MemberListPool)."""

    def __init__(
        self,
        conf: "DaemonConfig",
        daemon: "Daemon",
        *,
        interval: float = 1.0,
        suspect_after: float = 5.0,
        fanout: int = 3,
        max_datagram: int = 1200,
    ):
        super().__init__(daemon)
        self.interval = interval
        self.suspect_after = suspect_after
        self.fanout = fanout
        self.max_datagram = max_datagram
        bind = conf.member_list_address or f"0.0.0.0:{conf.advertise_port}"
        host, _, port = bind.rpartition(":")
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._sock.bind((host or "0.0.0.0", int(port)))
        self._sock.settimeout(0.25)
        self.gossip_address = (
            f"{self._advertise_host(host)}:{self._sock.getsockname()[1]}"
        )
        self.seeds = [s for s in conf.known_hosts if s != self.gossip_address]
        self.incarnation = time.time_ns()
        self.heartbeat = 0
        self._members: Dict[str, _Member] = {}
        # Death certificates: addr -> (incarnation, recorded_at).
        self._dead: Dict[str, Tuple[int, float]] = {}
        self._dead_ttl = max(suspect_after * 4, 30.0)
        self._lock = threading.Lock()
        self._threads = [
            threading.Thread(target=self._recv_loop, name="guber-gossip-rx", daemon=True),
            threading.Thread(target=self._gossip_loop, name="guber-gossip-tx", daemon=True),
        ]

    @staticmethod
    def _advertise_host(bind_host: str) -> str:
        if bind_host in ("", "0.0.0.0", "::"):
            return "127.0.0.1"
        return bind_host

    # -- wire ------------------------------------------------------------

    def _snapshot(self) -> Dict[str, dict]:
        me = self.daemon.peer_info()
        with self._lock:
            out = {
                addr: {
                    "inc": m.incarnation,
                    "hb": m.heartbeat,
                    "grpc": m.info.grpc_address,
                    "http": m.info.http_address,
                    "dc": m.info.datacenter,
                }
                for addr, m in self._members.items()
            }
        out[self.gossip_address] = {
            "inc": self.incarnation,
            "hb": self.heartbeat,
            "grpc": me.grpc_address,
            "http": me.http_address,
            "dc": me.datacenter,
        }
        now = time.monotonic()
        with self._lock:
            for addr, (inc, recorded_at) in self._dead.items():
                if addr not in out:
                    # Certificates carry their age so every node's TTL
                    # clock agrees and retirement converges cluster-wide
                    # (re-learning a cert must not reset its age).
                    out[addr] = {
                        "inc": inc,
                        "dead": True,
                        "age": round(now - recorded_at, 3),
                    }
        return out

    def _merge(self, payload: Dict[str, dict]) -> bool:
        """Merge a received member map; True if membership changed."""
        changed = False
        now = time.monotonic()
        with self._lock:
            for addr, meta in payload.items():
                inc = int(meta.get("inc", 0))
                if addr == self.gossip_address:
                    # Refutation (the SWIM alive-message analog): if the
                    # cluster certified US dead (e.g. after a long GC
                    # pause), adopt a fresh incarnation — it exceeds the
                    # tombstone, so the next gossip round rejoins us.
                    if meta.get("dead") and inc >= self.incarnation:
                        self.incarnation = time.time_ns()
                        self.heartbeat = 0
                    continue
                cur = self._members.get(addr)
                if meta.get("dead"):
                    # Death certificate: kills any entry at or below
                    # the certified incarnation.
                    if cur is not None and cur.incarnation <= inc:
                        del self._members[addr]
                        changed = True
                    recorded_at = now - float(meta.get("age", 0.0))
                    prev = self._dead.get(addr)
                    if prev is None or prev[0] < inc:
                        self._dead[addr] = (inc, recorded_at)
                    elif prev[0] == inc and recorded_at < prev[1]:
                        # Same certificate, older clock — keep the older
                        # age so TTL retirement converges.
                        self._dead[addr] = (inc, recorded_at)
                    continue
                tomb = self._dead.get(addr)
                if tomb is not None and inc <= tomb[0]:
                    continue  # certified dead at this incarnation
                hb = int(meta.get("hb", 0))
                if cur is None or (inc, hb) > (cur.incarnation, cur.heartbeat):
                    self._members[addr] = _Member(
                        incarnation=inc,
                        heartbeat=hb,
                        info=PeerInfo(
                            grpc_address=meta.get("grpc", ""),
                            http_address=meta.get("http", ""),
                            datacenter=meta.get("dc", ""),
                        ),
                        last_seen=now,
                    )
                    changed = changed or cur is None
        return changed

    def _expire(self) -> bool:
        now = time.monotonic()
        cutoff = now - self.suspect_after
        with self._lock:
            dead = [a for a, m in self._members.items() if m.last_seen < cutoff]
            for a in dead:
                self._dead[a] = (self._members[a].incarnation, now)
                del self._members[a]
            # Retire old certificates so the map stays bounded.
            for a in [
                a
                for a, (_, t) in self._dead.items()
                if t < now - self._dead_ttl
            ]:
                del self._dead[a]
        return bool(dead)

    def _push_peers(self) -> None:
        me = self.daemon.peer_info()
        with self._lock:
            peers = [m.info for m in self._members.values()]
        peers.append(me)
        self.on_update(sorted(peers, key=lambda p: p.grpc_address))

    # -- loops -----------------------------------------------------------

    def _recv_loop(self) -> None:
        while not self._closed.is_set():
            try:
                data, _ = self._sock.recvfrom(256 * 1024)
            except socket.timeout:
                continue
            except OSError:
                return
            try:
                payload = json.loads(data)
            except ValueError:
                continue
            if self._merge(payload):
                self._push_peers()

    def _encode_segments(self, snapshot: Dict[str, dict]) -> List[bytes]:
        """Split the member map into standalone datagrams ≤ max_datagram.

        The sender's own entry is repeated in every segment (liveness
        must not depend on which segment survives a lossy network); the
        remaining entries are packed greedily.  An entry that alone
        exceeds the budget still ships (the OS may fragment it)."""
        me_key = self.gossip_address
        me_entry = {me_key: snapshot[me_key]}
        base = len(json.dumps(me_entry).encode())
        segments: List[bytes] = []
        pending: Dict[str, dict] = dict(me_entry)
        size = base
        for addr, meta in snapshot.items():
            if addr == me_key:
                continue
            entry_len = len(json.dumps({addr: meta}).encode())
            if size + entry_len > self.max_datagram and len(pending) > 1:
                segments.append(json.dumps(pending).encode())
                pending = dict(me_entry)
                size = base
            pending[addr] = meta
            size += entry_len
        segments.append(json.dumps(pending).encode())
        return segments

    def _send(self, blob: bytes, addr: str) -> None:
        """One datagram to one member — the fault-injection seam
        (tests drop a fraction of sends here to model lossy networks)."""
        host, _, port = addr.rpartition(":")
        try:
            self._sock.sendto(blob, (host, int(port)))
        except OSError as e:
            log.debug("gossip send to %s failed: %s", addr, e)

    def _gossip_loop(self) -> None:
        # Announce immediately so joins propagate fast.
        self._push_peers()
        while not self._closed.wait(self.interval):
            self.heartbeat += 1
            segments = self._encode_segments(self._snapshot())
            with self._lock:
                members = list(self._members)
            targets = set(random.sample(members, min(self.fanout, len(members))))
            targets.update(self.seeds)
            for addr in targets:
                for blob in segments:
                    self._send(blob, addr)
            if self._expire():
                self._push_peers()

    def start(self) -> None:
        for t in self._threads:
            t.start()

    def close(self) -> None:
        super().close()
        for t in self._threads:
            t.join(timeout=2.0)
        self._sock.close()
