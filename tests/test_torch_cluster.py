"""Clusters of port daemons with static peers, against clusters of the
JAX package's daemons.

- tests/test_cluster.py's cases with no GLOBAL or MULTI_REGION item run on
  both packages through the `pkg` fixture: each package's harness, each
  package's client (grpcio's `V1Client` for the JAX package, the port's
  own unary client over `core/h2_client.py` for the port).  So do the
  non-GLOBAL cases of tests/test_chaos.py (:103, :134, :189),
  tests/test_wire_columnar.py::test_forwarding_still_works_with_fast_path
  and tests/test_h2_fast.py::test_fast_front_ownership_gate.
- The parity test: one seeded stream of 1000-item RPCs (token and leaky
  buckets, BATCHING, NO_BATCHING, RESET_REMAINING, DURATION_IS_GREGORIAN,
  validation errors, repeated keys, a frozen clock) goes to (a) two JAX
  daemons, (b) one JAX daemon and one port daemon (grpcio one way, the
  port's wire the other), (c) two port daemons.  Every answer of (b) and
  (c) equals (a)'s, bit for bit; `metadata.owner` is the owner the
  cluster's own ring names; the owners' state words are equal key for
  key.
- The GLOBAL / MULTI_REGION gap: such an item on a port node with peers
  gets the entry-4 error on both entry points; on a node with no peers it
  keeps C1's answers.

The JAX daemons skip their engine warmup here (`Daemon._warmup`, a
compile-ahead of every batch width): it changes no answer, and a width
compiles at first use instead, which can take longer than the harness's
1 s forward deadline inside a forwarded RPC, so their deadline
(`batch_timeout`) is 30 s.
"""

from __future__ import annotations

import json
import time
import urllib.request
from dataclasses import replace as dc_replace
from types import SimpleNamespace

import grpc
import numpy as np
import pytest

import gubernator_tpu.daemon as ref_daemon_mod
from gubernator_tpu import types as ref_types
from gubernator_tpu.client import V1Client, random_string
from gubernator_tpu.clock import Clock as RefClock
from gubernator_tpu.cluster import health as ref_health
from gubernator_tpu.cluster.harness import ClusterHarness as RefHarness
from gubernator_tpu.cluster.harness import cluster_behaviors as ref_cluster_behaviors
from gubernator_tpu.config import BehaviorConfig as RefBehaviorConfig
from gubernator_tpu.config import Config as RefConfig
from gubernator_tpu.config import DaemonConfig as RefDaemonConfig
from gubernator_tpu.core.engine import DecisionEngine as RefEngine
from gubernator_tpu.net.grpc_service import V1Stub, dial
from gubernator_tpu.net.h2_fast import H2FastFront as RefFront
from gubernator_tpu.net.pb import gubernator_pb2 as pb
from gubernator_tpu.service import V1Instance as RefInstance
from gubernator_tpu_torch import types as port_types
from gubernator_tpu_torch.clock import Clock
from gubernator_tpu_torch.cluster import health as port_health
from gubernator_tpu_torch.cluster.harness import ClusterHarness as PortHarness
from gubernator_tpu_torch.cluster.harness import cluster_behaviors as port_cluster_behaviors
from gubernator_tpu_torch.config import DaemonConfig
from gubernator_tpu_torch.core.engine import DecisionEngine
from gubernator_tpu_torch.core.h2_client import StatusCode, UnaryChannel
from gubernator_tpu_torch.daemon import spawn_daemon
from gubernator_tpu_torch.net import proto_codec
from gubernator_tpu_torch.net.h2_fast import H2FastFront
from gubernator_tpu_torch.ops import bucket_kernel as tk
from gubernator_tpu_torch.service import CLUSTER_GAP_ERROR, V1Instance

T0_NS = 1_700_000_000_000_000_000
NODES = 3


@pytest.fixture(scope="module", autouse=True)
def _no_ref_warmup():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref_daemon_mod.Daemon, "_warmup", lambda self, engine: None)
        yield


class PortRpcError(RuntimeError):
    def __init__(self, code: int, message: str):
        super().__init__(f"{StatusCode(code).name}: {message}")
        self.status = StatusCode(code)
        self.message = message


class PortClient:
    """V1Client's surface over the port's own unary client."""

    def __init__(self, address: str):
        self._ch = UnaryChannel(address)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self._ch.close()

    def get_rate_limits(self, reqs, timeout=None):
        code, msg, body = self._ch.call(proto_codec.GET_RATE_LIMITS,
                                        proto_codec.encode_get_rate_limits_req(reqs), timeout)
        if code != StatusCode.OK:
            raise PortRpcError(code, msg)
        return proto_codec.decode_get_rate_limits_resp(body)

    def health_check(self, timeout=None):
        code, msg, body = self._ch.call(proto_codec.HEALTH_CHECK, b"", timeout)
        if code != StatusCode.OK:
            raise PortRpcError(code, msg)
        return proto_codec.decode_health_check_resp(body)


def _code(e) -> str:
    return e.code().name if isinstance(e, grpc.RpcError) else e.status.name


def ref_behaviors():
    return dc_replace(ref_cluster_behaviors(), batch_timeout=30.0)


def _pkg(name: str) -> SimpleNamespace:
    if name == "ref":
        return SimpleNamespace(
            name=name, types=ref_types, health=ref_health, client=V1Client,
            behaviors=ref_behaviors, front=RefFront, errors=(grpc.RpcError,),
            start=lambda n, **kw: RefHarness().start(n, **{"behaviors": ref_behaviors(), **kw}),
            clock=RefClock)
    return SimpleNamespace(
        name=name, types=port_types, health=port_health, client=PortClient,
        behaviors=port_cluster_behaviors, front=H2FastFront, errors=(PortRpcError,),
        start=lambda n, **kw: PortHarness().start(n, device="cpu", **kw), clock=Clock)


@pytest.fixture(scope="module", params=["ref", "port"])
def pkg(request):
    return _pkg(request.param)


@pytest.fixture(scope="module")
def cluster(pkg):
    h = pkg.start(NODES)
    yield h
    h.stop()


def _until(pred, timeout=8.0, interval=0.05):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(interval)
    return False


# -- tests/test_cluster.py ---------------------------------------------------

def test_over_the_limit(pkg, cluster):
    """reference functional_test.go:64-111 (TestOverTheLimit)."""
    T = pkg.types
    with pkg.client(cluster.peer_at(0).grpc_address) as c:
        key = random_string(prefix="otl_")
        for want_status, want_remaining in [(T.Status.UNDER_LIMIT, 1), (T.Status.UNDER_LIMIT, 0),
                                            (T.Status.OVER_LIMIT, 0)]:
            rs = c.get_rate_limits([T.RateLimitReq(
                name="test_over_limit", unique_key=key, algorithm=T.Algorithm.TOKEN_BUCKET,
                duration=60_000, limit=2, hits=1)], timeout=10)
            assert (rs[0].error, rs[0].status, rs[0].remaining, rs[0].limit) == (
                "", want_status, want_remaining, 2)


def test_multiple_async(pkg, cluster):
    """A batch fanned across every owner in one request (reference
    functional_test.go:113-157)."""
    T = pkg.types
    reqs = [T.RateLimitReq(name=f"test_async_{i}", unique_key=random_string(prefix="async_"),
                           algorithm=T.Algorithm.TOKEN_BUCKET, duration=60_000, limit=10, hits=1)
            for i in range(20)]
    with pkg.client(cluster.peer_at(1).grpc_address) as c:
        rs = c.get_rate_limits(reqs, timeout=10)
    assert [(r.error, r.status, r.remaining) for r in rs] == [("", T.Status.UNDER_LIMIT, 9)] * 20


def test_missing_fields(pkg, cluster):
    """Per-item validation errors (reference functional_test.go:737-798)."""
    T = pkg.types
    cases = [(T.RateLimitReq(name="exists", unique_key="", hits=1, limit=10),
              "field 'unique_key' cannot be empty"),
             (T.RateLimitReq(name="", unique_key="key", hits=1, limit=10),
              "field 'namespace' cannot be empty")]
    with pkg.client(cluster.peer_at(0).grpc_address) as c:
        for req, want in cases:
            assert c.get_rate_limits([req], timeout=10)[0].error == want
        rs = c.get_rate_limits([T.RateLimitReq(name="no_duration", unique_key=random_string(),
                                               hits=1, limit=5)], timeout=10)
        assert rs[0].error == ""


def test_batch_too_large(pkg, cluster):
    """More than 1000 items is the one RPC-level error (reference
    gubernator.go:212-216)."""
    T = pkg.types
    reqs = [T.RateLimitReq(name="big", unique_key=str(i), hits=1, limit=10, duration=60_000)
            for i in range(1001)]
    with pkg.client(cluster.peer_at(0).grpc_address) as c:
        with pytest.raises(pkg.errors) as exc:
            c.get_rate_limits(reqs, timeout=10)
    assert _code(exc.value) == "OUT_OF_RANGE"


def test_batch_order_stability(pkg, cluster):
    """Responses in request order at every batch size (reference
    functional_test.go:1175-1221)."""
    T = pkg.types
    with pkg.client(cluster.peer_at(2).grpc_address) as c:
        for n in (1, 13, 100, 1000):
            tag = random_string(prefix=f"order{n}_")
            reqs = [T.RateLimitReq(name="test_order", unique_key=f"{tag}{i}", hits=0,
                                   limit=100 + i, duration=60_000) for i in range(n)]
            rs = c.get_rate_limits(reqs, timeout=30)
            assert [(r.error, r.limit) for r in rs] == [("", 100 + i) for i in range(n)]


def test_grpc_gateway(pkg, cluster):
    """The HTTP gateway's JSON contract on a cluster node (reference
    functional_test.go:1158-1173)."""
    base = f"http://{cluster.daemon_at(0).http_address}"
    body = urllib.request.urlopen(f"{base}/v1/HealthCheck", timeout=5).read().decode()
    assert json.loads(body)["peer_count"] == NODES
    data = json.dumps({"requests": [{"name": "gw", "unique_key": random_string(), "hits": "1",
                                     "limit": "5", "duration": "60000"}]}).encode()
    resp = json.loads(urllib.request.urlopen(urllib.request.Request(
        f"{base}/v1/GetRateLimits", data=data, headers={"Content-Type": "application/json"}),
        timeout=5).read())
    r = resp["responses"][0]
    assert (r["status"], r["remaining"]) == ("UNDER_LIMIT", "4") and r["reset_time"] != "0"


def test_forwarding_still_works_with_fast_path(pkg, cluster):
    """tests/test_wire_columnar.py: a key owned by another node declines
    the columnar route and is forwarded; the owner's own answer then
    sees the forwarded hit."""
    T = pkg.types
    d0 = cluster.daemon_at(0)
    for i in range(4096):
        key = f"{i}_colfwd"
        owner = d0.instance.get_peer("wire_" + key)
        if not owner.info.is_owner:
            break
    req = T.RateLimitReq(name="wire", unique_key=key, hits=1, limit=3, duration=60_000)
    with pkg.client(cluster.peer_at(0).grpc_address) as c0:
        r0 = c0.get_rate_limits([req], timeout=10)[0]
    assert r0.error == "" and r0.metadata.get("owner") == owner.info.grpc_address
    with pkg.client(owner.info.grpc_address) as c1:
        assert c1.get_rate_limits([req], timeout=10)[0].remaining == 1


def test_fast_front_ownership_gate(pkg, cluster):
    """tests/test_h2_fast.py: the h2 front on a cluster node declines a
    batch with a key another node owns (UNIMPLEMENTED) and serves one it
    owns."""
    d0 = cluster.daemon_at(0)
    front = pkg.front(d0.instance, window_s=0.001)
    try:
        stub = V1Stub(dial(front.address))
        keys = {}
        for i in range(400):
            key = f"{i}rem"
            mine = d0.instance.get_peer(f"own_{key}").info.is_owner
            keys.setdefault(mine, key)
        req = lambda k: pb.GetRateLimitsReq(requests=[pb.RateLimitReq(  # noqa: E731
            name="own", unique_key=k, hits=1, limit=5, duration=60_000)])
        with pytest.raises(grpc.RpcError) as err:
            stub.GetRateLimits(req(keys[False]), timeout=10)
        assert err.value.code() == grpc.StatusCode.UNIMPLEMENTED
        assert stub.GetRateLimits(req(keys[True]), timeout=10).responses[0].remaining == 4
    finally:
        front.close()


def test_health_check_detects_dead_peer(pkg):
    """A dead owner's key gets a degraded local answer and the caller
    turns unhealthy; a restart recovers (reference
    functional_test.go:1037-1104)."""
    T = pkg.types
    h = pkg.start(3)
    try:
        for attempt in range(200):
            key = random_string(prefix=f"hc{attempt}_")
            owner_addr = h.owner_of("test_health_" + key).grpc_address
            idx = [i for i, d in enumerate(h.daemons) if d.grpc_address == owner_addr]
            if idx and idx[0] != 0:
                owner_idx = idx[0]
                break
        h.kill(owner_idx)
        with pkg.client(h.peer_at(0).grpc_address) as c:
            rs = c.get_rate_limits([T.RateLimitReq(name="test_health", unique_key=key, hits=1,
                                                   limit=5, duration=60_000)], timeout=15)
            assert rs[0].error == "" and rs[0].metadata.get("degraded") == "true"
            hc = c.health_check(timeout=10)
            assert hc.status == "unhealthy"
            assert "UNAVAILABLE" in hc.message or "connect" in hc.message.lower()
        h.restart(owner_idx)
        with pkg.client(h.peer_at(owner_idx).grpc_address) as c:
            assert c.health_check(timeout=10).status == "healthy"
    finally:
        h.stop()


def test_cluster_token_bucket_frozen_clock(pkg):
    """A shared frozen clock threads through daemon, service and engine
    (reference functional_test.go:159-218)."""
    T = pkg.types
    clock = pkg.clock().freeze()
    h = pkg.start(2, clock=clock)
    try:
        req = T.RateLimitReq(name="test_tb", unique_key=random_string(prefix="tb_"),
                             duration=5_000, limit=2, hits=1)
        with pkg.client(h.peer_at(0).grpc_address) as c:
            r1 = c.get_rate_limits([req], timeout=10)[0]
            assert (r1.status, r1.remaining) == (T.Status.UNDER_LIMIT, 1)
            r2 = c.get_rate_limits([req], timeout=10)[0]
            assert (r2.status, r2.remaining) == (T.Status.UNDER_LIMIT, 0)
            assert c.get_rate_limits([req], timeout=10)[0].status == T.Status.OVER_LIMIT
            clock.advance(ms=6_000)
            r4 = c.get_rate_limits([req], timeout=10)[0]
            assert (r4.status, r4.remaining) == (T.Status.UNDER_LIMIT, 1)
            assert r4.reset_time > r1.reset_time
    finally:
        h.stop()


# -- tests/test_chaos.py, the cases with no GLOBAL item ------------------------

def _chaos_req(T, name, key, limit=1_000_000):
    return T.RateLimitReq(name=name, unique_key=key, hits=1, limit=limit, duration=60_000)


def _keys_owned_by(h, idx, name, n, prefix):
    want = h.daemons[idx].peer_info().grpc_address
    out, i = [], 0
    while len(out) < n:
        key = f"{prefix}{i}_{random_string()}"
        if h.daemons[0].instance.get_peer(f"{name}_{key}").info.grpc_address == want:
            out.append(key)
        i += 1
        assert i < 20_000
    return out


@pytest.fixture(scope="module")
def killed(pkg):
    """One 4-node cluster whose node 3 is killed for the whole arc."""
    h = pkg.start(4)
    addr = h.daemons[3].peer_info().grpc_address
    dead_keys = _keys_owned_by(h, 3, "chaos_kill", 8, "dk")
    h.kill(3)
    yield SimpleNamespace(h=h, addr=addr, dead_keys=dead_keys)
    h.stop()


def test_owner_killed_degraded_availability(pkg, killed):
    """tests/test_chaos.py:103: 1 of 4 peers dead, every answer without
    error, the dead owner's items flagged degraded."""
    T, h = pkg.types, killed.h
    n_err = n_degraded = n_total = 0
    with pkg.client(h.peer_at(0).grpc_address) as c:
        for round_ in range(12):
            for key in killed.dead_keys:
                r = c.get_rate_limits([_chaos_req(T, "chaos_kill", key)], timeout=15)[0]
                n_total += 1
                n_err += bool(r.error)
                n_degraded += r.metadata.get("degraded") == "true"
            r = c.get_rate_limits([_chaos_req(T, "chaos_live", f"live{round_}")], timeout=15)[0]
            n_total += 1
            n_err += bool(r.error)
    assert n_err / n_total <= 0.01, f"{n_err}/{n_total} errors"
    assert n_degraded > 0
    assert h.daemons[0].instance.counters["degraded_answers"] > 0


def test_circuit_opens_and_forwarding_stays_fast(pkg, killed):
    """tests/test_chaos.py:134: once the circuit to the dead owner is
    open, its keys cost a dict probe and a local apply."""
    T, h = pkg.types, killed.h
    me = h.daemons[0].peer_info().grpc_address
    assert _until(lambda: h.health_states()[me].get(killed.addr) == pkg.health.BROKEN,
                  timeout=5.0), h.health_states()
    with pkg.client(h.peer_at(0).grpc_address) as c:
        t0 = time.monotonic()
        for i in range(20):
            r = c.get_rate_limits([_chaos_req(T, "chaos_kill", killed.dead_keys[i % 8])],
                                  timeout=15)[0]
            assert r.error == ""
        per_req = (time.monotonic() - t0) / 20
    assert per_req < 0.25, f"{per_req * 1e3:.0f}ms per request"


def test_degraded_off_restores_fail_closed_errors(pkg):
    """tests/test_chaos.py:189: with degraded mode off, a dead owner's
    key always gets an error and never a degraded answer."""
    T = pkg.types
    h = pkg.start(3, behaviors=dc_replace(pkg.behaviors(), degraded_local=False))
    try:
        keys = _keys_owned_by(h, 2, "chaos_fc", 2, "fc")
        h.kill(2)
        with pkg.client(h.peer_at(0).grpc_address) as c:
            for _ in range(6):
                r = c.get_rate_limits([_chaos_req(T, "chaos_fc", keys[0])], timeout=15)[0]
                assert r.error != "" and r.metadata.get("degraded") is None
        assert h.daemons[0].instance.counters["degraded_answers"] == 0
    finally:
        h.stop()


# -- the parity test -------------------------------------------------------

RPCS = 6
ITEMS = 1000
CAP = 1 << 14
GREG = int(ref_types.Behavior.DURATION_IS_GREGORIAN)


def parity_stream(seed: int):
    """[(clock step in ms, node index, [item tuples])]: 1000-item RPCs
    over 300 keys with a config each (token / leaky, BATCHING /
    NO_BATCHING / Gregorian), RESET_REMAINING on 3 % of items, an
    invalid Gregorian interval or an empty field on 2 %."""
    rng = np.random.default_rng(seed)
    keys = []
    for k in range(300):
        algo = int(rng.integers(0, 2))
        kind = rng.choice(["batching", "no_batching", "gregorian"], p=[0.6, 0.25, 0.15])
        behavior = {"batching": 0, "no_batching": 1, "gregorian": GREG}[kind]
        duration = int(rng.integers(0, 4)) if kind == "gregorian" else int(
            rng.choice([1_000, 10_000, 60_000]))
        keys.append((f"{k}_pk", algo, behavior, int(rng.choice([3, 10, 100])), duration,
                     int(rng.choice([0, 0, 20]))))
    out = []
    for n in range(RPCS):
        items = []
        for _ in range(ITEMS):
            key, algo, behavior, limit, duration, burst = keys[int(rng.integers(0, len(keys)))]
            name, hits = "par", int(rng.choice([0, 1, 1, 1, 2, 5]))
            u = rng.random()
            if u < 0.03:
                behavior |= int(ref_types.Behavior.RESET_REMAINING)
            elif u < 0.035:
                key = ""
            elif u < 0.04:
                name = ""
            elif u < 0.05 and behavior & GREG:
                duration = 9  # no such interval: a per-item error
            items.append((name, key, hits, limit, duration, algo, behavior, burst))
        out.append((int(rng.choice([0, 250, 1_000, 61_000])), n % 2, items))
    return out


def _ref_words_by_key(eng):
    eng._flush_pump()
    words = {f: np.asarray(getattr(eng._state, f)) for f in eng._state._fields}
    return {k: tuple(int(words[f][s]) for f in eng._state._fields)
            for s in range(eng.capacity) if (k := eng.table.key_for_slot(s)) is not None}


def _port_words_by_key(eng):
    words = tk.state_to_numpy(eng.state)
    return {k: tuple(int(words[f][s]) for f in tk.BucketState._fields)
            for s in range(eng.capacity) if (k := eng.table.key_for_slot(s)) is not None}


def _ref_node(clock):
    conf = RefDaemonConfig(grpc_listen_address="127.0.0.1:0", http_listen_address="127.0.0.1:0",
                           behaviors=ref_behaviors(), cache_size=CAP,
                           peer_discovery_type="none", device_count=1, ledger=False,
                           sweep_interval=0.0, membership_epoch_timeout=3.0, drain_deadline=5.0)
    return ref_daemon_mod.spawn_daemon(conf, clock=clock)


def _port_node(clock):
    conf = DaemonConfig(grpc_listen_address="127.0.0.1:0", http_listen_address="127.0.0.1:0",
                        behaviors=port_cluster_behaviors(), cache_size=CAP, ledger=False,
                        sweep_interval=0.0)
    return spawn_daemon(conf, clock=clock, device="cpu")


def _run_parity(kinds, stream):
    """Drive one cluster (`kinds`: "ref" / "port" a node) with the
    stream; returns each RPC's answers as plain tuples, the owner the
    cluster's ring names for each item's key, the state words by key and
    the nodes' forward counters."""
    ref_clock = RefClock().freeze_at(T0_NS)
    port_clock = Clock().freeze_at(T0_NS)
    nodes = []
    try:
        for k in kinds:
            nodes.append(_ref_node(ref_clock) if k == "ref" else _port_node(port_clock))
        peers = [d.peer_info() for d in nodes]
        for d in nodes:
            d.set_peers(peers)
        for d, k in zip(nodes, kinds):
            if k == "ref":
                assert d.membership.wait_settled(10.0)
        addrs = [p.grpc_address for p in peers]
        answers, owners = [], []
        for step, node, items in stream:
            ref_clock.advance(ms=step)
            port_clock.advance(ms=step)
            ring = nodes[node].instance
            if kinds[node] == "ref":
                reqs = [ref_types.RateLimitReq(*it) for it in items]
                with V1Client(addrs[node]) as c:
                    resps = c.get_rate_limits(reqs, timeout=60)
            else:
                reqs = [port_types.RateLimitReq(*it) for it in items]
                with PortClient(addrs[node]) as c:
                    resps = c.get_rate_limits(reqs, timeout=60)
            answers.append([(int(r.status), r.limit, r.remaining, r.reset_time, r.error,
                             dict(r.metadata)) for r in resps])
            owners.append([ring.get_peer(r.hash_key()).info.grpc_address
                           if r.name and r.unique_key else None for r in reqs])
        words = {}
        for d, k in zip(nodes, kinds):
            mine = (_ref_words_by_key if k == "ref" else _port_words_by_key)(d.instance.engine)
            assert not set(mine) & set(words), "a key held by two owners"
            words.update(mine)
        forwards = [d.instance.counters["forward"] for d in nodes]
        return SimpleNamespace(answers=answers, owners=owners, words=words, addrs=addrs,
                               forwards=forwards)
    finally:
        for d in nodes:
            d.close()


def test_parity_with_the_reference_cluster():
    stream = parity_stream(23)
    a = _run_parity(("ref", "ref"), stream)
    for kinds in (("ref", "port"), ("port", "port")):
        got = _run_parity(kinds, stream)
        assert all(f > 0 for f in got.forwards), (kinds, got.forwards)
        for n, (want_rpc, got_rpc) in enumerate(zip(a.answers, got.answers)):
            node = stream[n][1]
            for i, (w, g) in enumerate(zip(want_rpc, got_rpc)):
                assert g[:5] == w[:5], (kinds, n, i, stream[n][2][i], w, g)
                owner = got.owners[n][i]
                md = {} if owner in (None, got.addrs[node]) else {"owner": owner}
                assert g[5] == md, (kinds, n, i, owner, g)
        assert got.words == a.words, kinds


# -- the GLOBAL / MULTI_REGION gap --------------------------------------------

@pytest.mark.parametrize("behavior", [int(port_types.Behavior.GLOBAL),
                                      int(port_types.Behavior.MULTI_REGION)])
def test_global_and_multi_region_on_a_node_with_peers_get_the_gap_error(behavior):
    h = PortHarness().start(2, device="cpu")
    try:
        inst = h.daemons[0].instance
        before = inst.counters["check_errors"]
        reqs = [port_types.RateLimitReq(name="gap", unique_key=f"{i}_g", hits=1, limit=5,
                                        duration=60_000, behavior=behavior) for i in range(4)]
        plain = port_types.RateLimitReq(name="gap", unique_key="plain", hits=1, limit=5,
                                        duration=60_000)
        with PortClient(h.peer_at(0).grpc_address) as c:
            rs = c.get_rate_limits(reqs + [plain], timeout=10)
        assert [r.error for r in rs] == [CLUSTER_GAP_ERROR] * 4 + [""]
        assert rs[4].remaining == 4
        ch = UnaryChannel(h.peer_at(1).grpc_address)
        try:
            code, _, body = ch.call(proto_codec.GET_PEER_RATE_LIMITS,
                                    proto_codec.encode_get_peer_rate_limits_req(reqs[:1]), 10)
        finally:
            ch.close()
        assert code == StatusCode.OK
        assert proto_codec.decode_get_peer_rate_limits_resp(body)[0].error == CLUSTER_GAP_ERROR
        assert inst.counters["check_errors"] == before + 4
    finally:
        h.stop()


@pytest.mark.parametrize("behavior", [int(port_types.Behavior.GLOBAL),
                                      int(port_types.Behavior.MULTI_REGION)])
def test_global_and_multi_region_on_a_node_with_no_peers_keep_c1(behavior):
    port = V1Instance(DecisionEngine(1 << 10, clock=Clock().freeze_at(T0_NS), device="cpu"),
                      ledger=False)
    ref = RefInstance(RefConfig(cache_size=1 << 10, ledger=False,
                                behaviors=RefBehaviorConfig(global_sync_wait=3600.0,
                                                            adaptive_windows=False)),
                      RefEngine(1 << 10, clock=RefClock().freeze_at(T0_NS)))
    try:
        for hits in (1, 2, 3):
            item = dict(name="c1", unique_key="k", hits=hits, limit=5, duration=60_000,
                        behavior=behavior)
            got = port.get_rate_limits([port_types.RateLimitReq(**item)])
            want = ref.get_rate_limits([ref_types.RateLimitReq(**item)])
            ref.global_mgr.flush_now()
            assert [(int(r.status), r.remaining, r.reset_time, r.error) for r in got] == [
                (int(r.status), r.remaining, r.reset_time, r.error) for r in want]
            assert got[0].error == ""
    finally:
        port.close()
        ref.close()
