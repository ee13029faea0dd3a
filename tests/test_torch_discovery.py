"""The port's discovery backends against the JAX package's.

tests/test_discovery_fakes.py's etcd and k8s cases run on the port's
`EtcdPool` / `K8sPool` over the same in-process fakes (copied here: that
file is the reference's own); DNS runs over a stubbed resolver beside the
reference's `DNSPool`; tests/test_gossip_hardening.py's tiny-datagram and
30 %-loss cases run on the port's `MemberListPool`.  The gossip datagrams
must be wire-compatible: the same member map encodes to the same
segments, the same payloads merge and expire to the same member maps,
and a cluster of 5 reference and 5 port pools converges on 10.  Every
socket binds 127.0.0.1:0.  The 50-member soak with deaths is `slow`, as
its reference twin's 60 s waits are.
"""

from __future__ import annotations

import queue
import random
import socket
import threading
import time
import types
from typing import Dict, List

import pytest

from gubernator_tpu.config import DaemonConfig as RefConfig
from gubernator_tpu.discovery import dns as ref_dns
from gubernator_tpu.discovery import memberlist as ref_ml
from gubernator_tpu.types import PeerInfo as RefPeerInfo
from gubernator_tpu_torch.config import DaemonConfig
from gubernator_tpu_torch.discovery import create_discovery
from gubernator_tpu_torch.discovery import dns as port_dns
from gubernator_tpu_torch.discovery import memberlist as port_ml
from gubernator_tpu_torch.discovery.etcd import EtcdPool
from gubernator_tpu_torch.discovery.kubernetes import K8sPool
from gubernator_tpu_torch.types import PeerInfo


def _until(pred, timeout=30.0, interval=0.02):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(interval)
    return pred()


class FakeDaemon:
    """Just enough daemon surface for a discovery backend."""

    def __init__(self, grpc="10.0.0.1:1051", http="10.0.0.1:1050", peer_info=PeerInfo):
        self.grpc_address = grpc
        self.http_address = http
        self._peer_info = peer_info
        self._lock = threading.Lock()
        self.pushes: List[list] = []

    def peer_info(self):
        return self._peer_info(grpc_address=self.grpc_address, http_address=self.http_address)

    def set_peers(self, peers) -> None:
        with self._lock:
            self.pushes.append(list(peers))

    def peer_count(self) -> int:
        with self._lock:
            return len(self.pushes[-1]) if self.pushes else 0

    def wait_push(self, pred, timeout=5.0) -> bool:
        def seen():
            with self._lock:
                return any(pred(p) for p in self.pushes)
        return _until(seen, timeout, 0.01)


def _addrs(peers):
    return {p.grpc_address for p in peers}


# ---------------------------------------------------------------- etcd
# The fakes of tests/test_discovery_fakes.py: etcd3's kv / lease / watch.


class FakeLease:
    def __init__(self, store: "FakeEtcd", ttl: int):
        self.store = store
        self.ttl = ttl
        self.keys: set = set()
        self.revoked = False
        self.fail_refresh = False
        self.refreshes = 0

    def refresh(self):
        if self.fail_refresh:
            raise ConnectionError("lease lost")
        self.refreshes += 1

    def revoke(self):
        self.revoked = True
        for k in list(self.keys):
            self.store.delete(k)


class FakeEtcd:
    def __init__(self):
        self.kv: Dict[str, str] = {}
        self.leases: List[FakeLease] = []
        self._watches: Dict[int, tuple] = {}
        self._next_watch = 0
        self._lock = threading.Lock()

    def lease(self, ttl):
        lease = FakeLease(self, ttl)
        self.leases.append(lease)
        return lease

    def put(self, key, value, lease=None):
        with self._lock:
            self.kv[key] = value
            if lease is not None:
                lease.keys.add(key)
            watches = list(self._watches.values())
        for prefix, cb in watches:
            if key.startswith(prefix):
                cb(types.SimpleNamespace(key=key, value=value))

    def delete(self, key):
        with self._lock:
            existed = self.kv.pop(key, None) is not None
            watches = list(self._watches.values())
        if existed:
            for prefix, cb in watches:
                if key.startswith(prefix):
                    cb(types.SimpleNamespace(key=key, value=None))
        return existed

    def get_prefix(self, prefix):
        with self._lock:
            return [(v, types.SimpleNamespace(key=k)) for k, v in self.kv.items()
                    if k.startswith(prefix)]

    def add_watch_prefix_callback(self, prefix, cb):
        with self._lock:
            self._next_watch += 1
            self._watches[self._next_watch] = (prefix, cb)
            return self._next_watch

    def cancel_watch(self, watch_id):
        with self._lock:
            self._watches.pop(watch_id, None)


def _etcd_pool(daemon, store, keepalive=0.05):
    return EtcdPool(DaemonConfig(), daemon, client=store, keepalive_interval=keepalive)


def test_etcd_register_and_watch():
    store, daemon = FakeEtcd(), FakeDaemon()
    pool = _etcd_pool(daemon, store)
    pool.start()
    try:
        my_key = "/gubernator/peers/10.0.0.1:1051"
        assert my_key in store.kv
        assert store.leases and my_key in store.leases[0].keys
        store.put("/gubernator/peers/10.0.0.2:1051",
                  '{"grpc": "10.0.0.2:1051", "http": "10.0.0.2:1050", "dc": ""}')
        assert daemon.wait_push(lambda p: _addrs(p) == {"10.0.0.1:1051", "10.0.0.2:1051"})
    finally:
        pool.close()


def test_etcd_peer_departure():
    store = FakeEtcd()
    store.put("/gubernator/peers/10.0.0.2:1051", '{"grpc": "10.0.0.2:1051"}')
    daemon = FakeDaemon()
    pool = _etcd_pool(daemon, store)
    pool.start()
    try:
        store.delete("/gubernator/peers/10.0.0.2:1051")
        assert daemon.wait_push(lambda p: _addrs(p) == {"10.0.0.1:1051"})
    finally:
        pool.close()


def test_etcd_lease_keepalive_and_reregister():
    store, daemon = FakeEtcd(), FakeDaemon()
    pool = _etcd_pool(daemon, store, keepalive=0.02)
    pool.start()
    try:
        first = store.leases[0]
        assert _until(lambda: first.refreshes > 0, 5.0, 0.01)
        store.delete("/gubernator/peers/10.0.0.1:1051")
        first.fail_refresh = True
        assert _until(lambda: len(store.leases) >= 2, 5.0, 0.01), "no re-register"
        assert "/gubernator/peers/10.0.0.1:1051" in store.kv
    finally:
        pool.close()


def test_etcd_close_deregisters():
    store, daemon = FakeEtcd(), FakeDaemon()
    pool = _etcd_pool(daemon, store)
    pool.start()
    pool.close()
    assert "/gubernator/peers/10.0.0.1:1051" not in store.kv
    assert store.leases[-1].revoked
    assert not store._watches


def test_etcd_malformed_values_skipped():
    store = FakeEtcd()
    store.put("/gubernator/peers/bad", "not json")
    store.put("/gubernator/peers/nogrpc", '{"http": "x"}')
    daemon = FakeDaemon()
    pool = _etcd_pool(daemon, store)
    pool.start()
    try:
        assert daemon.wait_push(lambda p: _addrs(p) == {"10.0.0.1:1051"})
    finally:
        pool.close()


def test_etcd_without_a_client_names_the_roadmap_entry():
    with pytest.raises(RuntimeError, match="ROADMAP A entry 5"):
        EtcdPool(DaemonConfig(), FakeDaemon())


# ----------------------------------------------------------------- k8s


def _pod(ip, ready=True):
    return types.SimpleNamespace(status=types.SimpleNamespace(
        pod_ip=ip,
        conditions=[types.SimpleNamespace(type="Ready", status="True" if ready else "False")]))


class FakeCoreV1:
    def __init__(self):
        self.pods: List = []
        self.lock = threading.Lock()

    def list_namespaced_pod(self, namespace, label_selector=None, **kw):
        with self.lock:
            return types.SimpleNamespace(items=list(self.pods))


class FakeWatch:
    events: "queue.Queue" = None

    def stream(self, fn, *args, **kwargs):
        while True:
            ev = FakeWatch.events.get()
            if ev is None:
                return
            yield ev


def test_k8s_ready_pods_become_peers():
    core = FakeCoreV1()
    core.pods = [_pod("10.0.0.1"), _pod("10.0.0.2"), _pod("10.0.0.3", ready=False)]
    FakeWatch.events = queue.Queue()
    daemon = FakeDaemon()
    pool = K8sPool(DaemonConfig(), daemon, core_api=core, watch_factory=FakeWatch)
    pool.start()
    try:
        assert daemon.wait_push(lambda p: _addrs(p) == {"10.0.0.1:1051", "10.0.0.2:1051"})
        with core.lock:
            core.pods.append(_pod("10.0.0.4"))
        FakeWatch.events.put(object())
        assert daemon.wait_push(
            lambda p: _addrs(p) == {"10.0.0.1:1051", "10.0.0.2:1051", "10.0.0.4:1051"})
        with core.lock:
            core.pods = [p for p in core.pods if p.status.pod_ip != "10.0.0.2"]
        FakeWatch.events.put(object())
        assert daemon.wait_push(lambda p: _addrs(p) == {"10.0.0.1:1051", "10.0.0.4:1051"})
    finally:
        pool._closed.set()
        FakeWatch.events.put(None)
        pool.close()


def test_k8s_watch_failure_retries():
    core = FakeCoreV1()
    core.pods = [_pod("10.0.0.9")]

    class FlakyWatch:
        calls = 0

        def stream(self, fn, *args, **kwargs):
            FlakyWatch.calls += 1
            if FlakyWatch.calls == 1:
                raise ConnectionError("watch dropped")
            while True:
                ev = FakeWatch.events.get()
                if ev is None:
                    return
                yield ev

    FakeWatch.events = queue.Queue()
    daemon = FakeDaemon()
    pool = K8sPool(DaemonConfig(), daemon, core_api=core, watch_factory=FlakyWatch)
    pool.start()
    try:
        assert _until(lambda: FlakyWatch.calls >= 2, 10.0), "watch loop did not restart"
        assert daemon.wait_push(lambda p: _addrs(p) == {"10.0.0.9:1051"})
    finally:
        pool._closed.set()
        FakeWatch.events.put(None)
        pool.close()


# ----------------------------------------------------------------- dns


def test_dns_pool_pushes_resolved_peers_like_the_reference(monkeypatch):
    answers = {"addrs": ["10.0.0.7", "10.0.0.5", "10.0.0.5"]}

    def fake_getaddrinfo(host, port, *a, **kw):
        assert host == "guber.svc.local"
        return [(socket.AF_INET, socket.SOCK_STREAM, 6, "", (ip, 0)) for ip in answers["addrs"]]

    monkeypatch.setattr(socket, "getaddrinfo", fake_getaddrinfo)
    conf = DaemonConfig(dns_fqdn="guber.svc.local", dns_poll_interval=1.0, data_center="dc1")
    ref_pool = ref_dns.DNSPool(RefConfig(dns_fqdn="guber.svc.local", data_center="dc1"),
                               FakeDaemon(peer_info=RefPeerInfo))
    want = [(p.grpc_address, p.http_address, p.datacenter) for p in ref_pool._resolve()]
    daemon = FakeDaemon()
    pool = port_dns.DNSPool(conf, daemon)
    assert [(p.grpc_address, p.http_address, p.datacenter) for p in pool._resolve()] == want
    assert want == [("10.0.0.5:1051", "10.0.0.5:1050", "dc1"),
                    ("10.0.0.7:1051", "10.0.0.7:1050", "dc1")]
    pool.start()
    try:
        assert daemon.wait_push(lambda p: _addrs(p) == {"10.0.0.5:1051", "10.0.0.7:1051"})
        answers["addrs"] = ["10.0.0.9"]
        assert daemon.wait_push(lambda p: _addrs(p) == {"10.0.0.9:1051"}, timeout=10.0)
    finally:
        pool.close()
    with pytest.raises(ValueError, match="GUBER_DNS_FQDN"):
        port_dns.DNSPool(DaemonConfig(), FakeDaemon())


def test_create_discovery_builds_the_configured_backend():
    d = FakeDaemon()
    pool = create_discovery(DaemonConfig(peer_discovery_type="member-list",
                                         member_list_address="127.0.0.1:0"), d)
    try:
        assert isinstance(pool, port_ml.MemberListPool)
        assert pool.gossip_address.startswith("127.0.0.1:")
    finally:
        pool._sock.close()
    pool = create_discovery(DaemonConfig(peer_discovery_type="dns", dns_fqdn="x.local"), d)
    assert isinstance(pool, port_dns.DNSPool)
    with pytest.raises(RuntimeError, match="ROADMAP A entry 5"):
        create_discovery(DaemonConfig(peer_discovery_type="etcd"), d)
    with pytest.raises(RuntimeError, match="kubernetes"):
        create_discovery(DaemonConfig(peer_discovery_type="k8s"), d)
    with pytest.raises(ValueError, match="unknown peer discovery type"):
        create_discovery(DaemonConfig(peer_discovery_type="none"), d)


# -------------------------------------------------------------- gossip


class GossipDaemon(FakeDaemon):
    def __init__(self, idx: int, peer_info):
        super().__init__(f"127.0.0.1:{20000 + idx}", f"127.0.0.1:{30000 + idx}", peer_info)


def _start_pools(mods, *, max_datagram=1200, drop=0.0, interval=0.05, suspect_after=2.0,
                 seed_rng=0):
    """One pool per module in `mods` (the reference's or the port's
    memberlist), wired through fake daemons; pool 0 seeds the rest.
    `drop` loses that fraction of datagrams at the send seam."""
    rng = random.Random(seed_rng)
    daemons, pools, seed = [], [], None
    for i, mod in enumerate(mods):
        ref = mod is ref_ml
        d = GossipDaemon(i, RefPeerInfo if ref else PeerInfo)
        conf = (RefConfig if ref else DaemonConfig)(
            member_list_address="127.0.0.1:0", known_hosts=[seed] if seed else [],
            advertise_port=0)
        p = mod.MemberListPool(conf, d, interval=interval, suspect_after=suspect_after,
                               fanout=3, max_datagram=max_datagram)
        if drop > 0:
            orig = p._send

            def lossy(blob, addr, _orig=orig):
                if rng.random() >= drop:
                    _orig(blob, addr)

            p._send = lossy
        seed = seed or p.gossip_address
        daemons.append(d)
        pools.append(p)
    for p in pools:
        p.start()
    return daemons, pools


def _stop(pools):
    for p in pools:
        p.close()


def test_segmentation_converges_with_tiny_datagrams():
    daemons, pools = _start_pools([port_ml] * 8, max_datagram=300)
    try:
        assert _until(lambda: all(d.peer_count() == 8 for d in daemons)), \
            [d.peer_count() for d in daemons]
        segs = pools[0]._encode_segments(pools[0]._snapshot())
        assert len(segs) > 1
        assert all(len(s) <= 300 for s in segs)
    finally:
        _stop(pools)


def test_convergence_under_30pct_loss():
    daemons, pools = _start_pools([port_ml] * 10, drop=0.30)
    try:
        assert _until(lambda: all(d.peer_count() == 10 for d in daemons), timeout=45), \
            [d.peer_count() for d in daemons]
    finally:
        _stop(pools)


def test_mixed_reference_and_port_cluster_converges():
    """5 reference and 5 port pools, seeded by a reference pool, gossip
    one membership of 10 both ways; a port pool's death reaches every
    survivor of both packages."""
    daemons, pools = _start_pools([ref_ml, port_ml] * 5, interval=0.05, suspect_after=1.0)
    try:
        assert _until(lambda: all(d.peer_count() == 10 for d in daemons)), \
            [d.peer_count() for d in daemons]
        want = {d.grpc_address for d in daemons}
        assert all(_addrs(d.pushes[-1]) == want for d in daemons)
        pools[-1].close()
        assert _until(lambda: all(d.peer_count() == 9 for d in daemons[:-1])), \
            [d.peer_count() for d in daemons[:-1]]
    finally:
        _stop(pools)


@pytest.mark.slow
def test_50_member_soak_with_deaths():
    daemons, pools = _start_pools([port_ml] * 50, interval=0.1, suspect_after=3.0)
    try:
        assert _until(lambda: all(d.peer_count() == 50 for d in daemons), timeout=60), \
            sorted(d.peer_count() for d in daemons)
        for p in pools[45:]:
            p.close()
        assert _until(lambda: all(d.peer_count() == 45 for d in daemons[:45]), timeout=60), \
            sorted(d.peer_count() for d in daemons[:45])
        time.sleep(1.0)
        assert all(d.peer_count() == 45 for d in daemons[:45])
    finally:
        _stop(pools)


class _FrozenTime:
    """A stand-in for the memberlist module's `time`: monotonic and
    time_ns read a settable clock."""

    def __init__(self):
        self.t = 1000.0

    def monotonic(self):
        return self.t

    def time_ns(self):
        return int(self.t * 1e9)


def _member_map(pool):
    return ({a: (m.incarnation, m.heartbeat, m.info.grpc_address, m.info.http_address,
                 m.info.datacenter, m.last_seen) for a, m in pool._members.items()},
            dict(pool._dead))


def test_gossip_wire_format_matches_reference(monkeypatch):
    """The same member map encodes to the same segments in both packages,
    and the same payload sequence (alive entries, heartbeats, death
    certificates, a refutation of ourselves) merges and expires to the
    same member maps, with the same `changed` answers."""
    clocks = []
    pools = []
    for mod, conf, info in ((ref_ml, RefConfig, RefPeerInfo), (port_ml, DaemonConfig, PeerInfo)):
        clock = _FrozenTime()
        monkeypatch.setattr(mod, "time", clock)
        p = mod.MemberListPool(conf(member_list_address="127.0.0.1:0", advertise_port=0),
                               GossipDaemon(0, info), suspect_after=5.0, max_datagram=400)
        p.gossip_address = "127.0.0.1:7000"
        p.incarnation = 42
        clocks.append(clock)
        pools.append(p)
    try:
        rng = random.Random(3)
        snapshot = {f"10.1.0.{i}:7946": {"inc": rng.randrange(1, 9), "hb": rng.randrange(50),
                                         "grpc": f"10.1.0.{i}:1051", "http": f"10.1.0.{i}:1050",
                                         "dc": rng.choice(["", "dc-west"])}
                    for i in range(25)}
        snapshot["127.0.0.1:7000"] = {"inc": 42, "hb": 3, "grpc": "a", "http": "b", "dc": ""}
        snapshot["10.9.9.9:7946"] = {"inc": 5, "dead": True, "age": 1.5}
        assert pools[1]._encode_segments(snapshot) == pools[0]._encode_segments(snapshot)
        assert len(pools[0]._encode_segments(snapshot)) > 1

        payloads = []
        for step in range(40):
            addr = f"10.1.0.{rng.randrange(8)}:7946"
            kind = rng.choice(["alive", "alive", "alive", "dead", "self_dead", "tick"])
            if kind == "alive":
                payloads.append({addr: {"inc": rng.randrange(1, 4), "hb": rng.randrange(20),
                                        "grpc": addr.replace("7946", "1051"), "http": "h",
                                        "dc": ""}})
            elif kind == "dead":
                payloads.append({addr: {"inc": rng.randrange(1, 4), "dead": True,
                                        "age": round(rng.random() * 3, 3)}})
            elif kind == "self_dead":
                payloads.append({"127.0.0.1:7000": {"inc": 42, "dead": True, "age": 0.0}})
            else:
                payloads.append(None)
        traces = []
        for pool, clock in zip(pools, clocks):
            trace = []
            for payload in payloads:
                if payload is None:
                    clock.t += 2.0
                    trace.append(("expire", pool._expire()))
                else:
                    clock.t += 0.1
                    trace.append(("merge", pool._merge(payload)))
                trace.append(_member_map(pool))
                trace.append((pool.incarnation, pool.heartbeat))
            trace.append(pool._encode_segments(pool._snapshot()))
            traces.append(trace)
        assert traces[0] == traces[1]
    finally:
        for p in pools:
            p._sock.close()
