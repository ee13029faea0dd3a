"""The port's peer rings against the JAX package's.

tests/test_hash_ring.py's cases run on both packages (the `pkg` fixture),
then hypothesis-made clusters and keys go through both packages' rings,
which must name the same owner for every key: a mixed cluster routes by
both, and one key on which they disagree has two owners.  The FNV-1 pair
the rings hash with is held to the reference's on empty, one-byte and
1 KiB keys.
"""

from __future__ import annotations

import importlib
import random
from types import SimpleNamespace

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from gubernator_tpu import hashing as ref_hashing
from gubernator_tpu.cluster import hash_ring as ref_ring
from gubernator_tpu.types import PeerInfo as RefPeerInfo
from gubernator_tpu_torch import hashing as port_hashing
from gubernator_tpu_torch.cluster import hash_ring as port_ring
from gubernator_tpu_torch.types import PeerInfo as PortPeerInfo

PACKAGES = ("gubernator_tpu", "gubernator_tpu_torch")


class Pkg(SimpleNamespace):
    def member(self, addr: str, dc: str = "") -> SimpleNamespace:
        return SimpleNamespace(info=self.PeerInfo(grpc_address=addr, datacenter=dc))


@pytest.fixture(params=PACKAGES)
def pkg(request) -> Pkg:
    ring = importlib.import_module(f"{request.param}.cluster.hash_ring")
    types = importlib.import_module(f"{request.param}.types")
    return Pkg(ring=ring, PeerInfo=types.PeerInfo)


HOSTS = ["a.svc.local", "b.svc.local", "c.svc.local"]

# tests/test_hash_ring.py's frozen per-host counts for 10k seeded IPs.
GOLDEN = {
    "fnv1": {"a.svc.local": 3400, "b.svc.local": 3298, "c.svc.local": 3302},
    "fnv1a": {"a.svc.local": 3274, "b.svc.local": 3365, "c.svc.local": 3361},
}


def _random_ips(n: int, seed: int = 1234):
    rng = random.Random(seed)
    return [".".join(str(rng.randint(0, 255)) for _ in range(4)) for _ in range(n)]


# ---------------------------------------------------------------------
# tests/test_hash_ring.py, on both packages


@pytest.mark.parametrize("hash_name", ["fnv1", "fnv1a"])
def test_golden_distribution(pkg, hash_name):
    ring = pkg.ring.ReplicatedConsistentHash(hash_name)
    for h in HOSTS:
        ring.add(pkg.member(h))
    counts = {h: 0 for h in HOSTS}
    for m in ring.get_batch(_random_ips(10_000)):
        counts[m.info.grpc_address] += 1
    assert counts == GOLDEN[hash_name]


@pytest.mark.parametrize("hash_name", ["fnv1", "fnv1a"])
def test_batch_matches_scalar(pkg, hash_name):
    ring = pkg.ring.ReplicatedConsistentHash(hash_name)
    ring.add_all([pkg.member(h) for h in HOSTS])
    keys = _random_ips(500, seed=9)
    assert [m.info.grpc_address for m in ring.get_batch(keys)] == \
        [ring.get(k).info.grpc_address for k in keys]


def test_stability_under_membership_change(pkg):
    ring = pkg.ring.ReplicatedConsistentHash()
    ring.add_all([pkg.member(h) for h in HOSTS])
    keys = _random_ips(10_000)
    before = [m.info.grpc_address for m in ring.get_batch(keys)]
    ring.add(pkg.member("d.svc.local"))
    after = [m.info.grpc_address for m in ring.get_batch(keys)]
    moved = sum(1 for b, a in zip(before, after) if b != a)
    assert 0.15 < moved / len(keys) < 0.35
    assert all(a == "d.svc.local" for b, a in zip(before, after) if b != a)


def test_empty_pool_raises(pkg):
    ring = pkg.ring.ReplicatedConsistentHash()
    with pytest.raises(pkg.ring.PoolEmptyError):
        ring.get("x")
    with pytest.raises(pkg.ring.PoolEmptyError):
        ring.get_batch(["x"])


def test_get_by_peer_info_and_size(pkg):
    ring = pkg.ring.ReplicatedConsistentHash()
    ring.add_all([pkg.member(h) for h in HOSTS])
    assert ring.size() == 3
    got = ring.get_by_peer_info(pkg.PeerInfo(grpc_address="b.svc.local"))
    assert got.info.grpc_address == "b.svc.local"
    assert ring.get_by_peer_info(pkg.PeerInfo(grpc_address="zz")) is None
    assert len(ring._hashes) == 3 * pkg.ring.DEFAULT_REPLICAS


def test_re_add_same_peer_is_idempotent(pkg):
    ring = pkg.ring.ReplicatedConsistentHash()
    ring.add(pkg.member("a.svc.local"))
    ring.add(pkg.member("a.svc.local"))
    assert ring.size() == 1
    assert len(ring._hashes) == pkg.ring.DEFAULT_REPLICAS


@pytest.mark.parametrize("hash_name", ["fnv1", "fnv1a"])
@pytest.mark.parametrize("n_hosts", [3, 5, 8])
def test_add_one_peer_moves_about_one_over_n(pkg, hash_name, n_hosts):
    hosts = [f"h{i}.svc.local" for i in range(n_hosts)]
    ring = pkg.ring.ReplicatedConsistentHash(hash_name)
    ring.add_all([pkg.member(h) for h in hosts])
    keys = _random_ips(20_000, seed=n_hosts)
    before = [m.info.grpc_address for m in ring.get_batch(keys)]
    ring.add(pkg.member("joiner.svc.local"))
    after = [m.info.grpc_address for m in ring.get_batch(keys)]
    moved = [(b, a) for b, a in zip(before, after) if b != a]
    expected = 1.0 / (n_hosts + 1)
    assert 0.5 * expected < len(moved) / len(keys) < 1.6 * expected
    assert all(a == "joiner.svc.local" for _b, a in moved)


@pytest.mark.parametrize("hash_name", ["fnv1", "fnv1a"])
@pytest.mark.parametrize("n_hosts", [4, 6])
def test_remove_one_peer_moves_only_its_keys(pkg, hash_name, n_hosts):
    hosts = [f"h{i}.svc.local" for i in range(n_hosts)]
    ring = pkg.ring.ReplicatedConsistentHash(hash_name)
    ring.add_all([pkg.member(h) for h in hosts])
    keys = _random_ips(20_000, seed=100 + n_hosts)
    before = [m.info.grpc_address for m in ring.get_batch(keys)]
    gone = hosts[1]
    survivor_ring = ring.new()
    survivor_ring.add_all([pkg.member(h) for h in hosts if h != gone])
    after = [m.info.grpc_address for m in survivor_ring.get_batch(keys)]
    for b, a in zip(before, after):
        if b != gone:
            assert a == b
        else:
            assert a != gone
    departed = sum(1 for b in before if b == gone)
    expected = len(keys) / n_hosts
    assert 0.5 * expected < departed < 1.6 * expected


@pytest.mark.parametrize("hash_name", ["fnv1", "fnv1a"])
@pytest.mark.parametrize("delta", ["join", "leave"])
def test_dual_ring_window_routes_old_or_new_never_third(pkg, hash_name, delta):
    hosts = [f"h{i}.svc.local" for i in range(5)]
    old_infos = [pkg.PeerInfo(grpc_address=h) for h in hosts]
    if delta == "join":
        new_infos = old_infos + [pkg.PeerInfo(grpc_address="joiner.svc.local")]
    else:
        new_infos = old_infos[:-1]
    window = pkg.ring.DualRingWindow(pkg.ring.address_ring(old_infos, hash_name),
                                     pkg.ring.address_ring(new_infos, hash_name))
    keys = _random_ips(5_000, seed=7)
    n_moved = 0
    for k in keys:
        old_addr, new_addr = window.owners(k)
        assert window.owner(k) == new_addr
        assert window.acceptable(k, old_addr)
        assert window.acceptable(k, new_addr)
        third = next(h for h in hosts if h not in (old_addr, new_addr))
        assert not window.acceptable(k, third)
        n_moved += bool(window.moved(k))
    assert n_moved / len(keys) < 0.35


def test_region_picker_routes_per_dc(pkg):
    rp = pkg.ring.RegionPicker()
    rp.add(pkg.member("a1", dc="us-east"))
    rp.add(pkg.member("a2", dc="us-east"))
    rp.add(pkg.member("b1", dc="eu-west"))
    assert rp.size() == 3
    assert set(rp.pickers()) == {"us-east", "eu-west"}
    clients = rp.get_clients("some_key")
    assert len(clients) == 2
    assert {c.info.datacenter for c in clients} == {"us-east", "eu-west"}
    assert rp.get_by_peer_info(pkg.PeerInfo(grpc_address="b1")).info.grpc_address == "b1"


# ---------------------------------------------------------------------
# FNV-1 / FNV-1a: the port's against the reference's


@pytest.mark.parametrize("name", ["fnv1", "fnv1a"])
def test_fnv_batch_matches_scalar_and_reference(name):
    rng = np.random.default_rng(5)
    keys = [b"", b"\x00", b"\xff", b"a", rng.integers(0, 256, 1024, dtype=np.uint8).tobytes(),
            bytes(range(256)) * 4, b"name_key"]
    padded, lengths = port_hashing.pack_keys(keys)
    got = getattr(port_hashing, f"{name}_64_batch")(padded, lengths)
    assert got.dtype == np.uint64
    scalar = [getattr(port_hashing, f"{name}_64")(k) for k in keys]
    assert got.tolist() == scalar
    assert scalar == [getattr(ref_hashing, f"{name}_64")(k) for k in keys]
    rp, rl = ref_hashing.pack_keys(keys)
    assert got.tolist() == getattr(ref_hashing, f"{name}_64_batch")(rp, rl).tolist()


# ---------------------------------------------------------------------
# Ownership: the same owner from both packages' rings, key for key

_ADDR = st.from_regex(r"[a-z0-9.\-]{1,24}:[0-9]{2,5}", fullmatch=True)
_KEYS = st.lists(st.binary(min_size=0, max_size=40), min_size=1, max_size=60)


def _rings(addrs, picker, hash_name, replicas, dcs=None):
    dcs = dcs or [""] * len(addrs)
    out = []
    for ring, PeerInfo in ((ref_ring, RefPeerInfo), (port_ring, PortPeerInfo)):
        r = ring.make_picker(picker, hash_name, replicas)
        r.add_all([SimpleNamespace(info=PeerInfo(grpc_address=a, datacenter=dc))
                   for a, dc in zip(addrs, dcs)])
        out.append(r)
    return out


@settings(max_examples=60, deadline=None)
@given(addrs=st.lists(_ADDR, min_size=1, max_size=20, unique=True), keys=_KEYS,
       picker=st.sampled_from(["replicated-hash", "consistent-hash"]),
       hash_name=st.sampled_from(["fnv1", "fnv1a"]), replicas=st.sampled_from([1, 512]))
def test_owner_matches_reference_for_every_key(addrs, keys, picker, hash_name, replicas):
    ref, port = _rings(addrs, picker, hash_name, replicas)
    skeys = [k.decode("latin-1") for k in keys]
    want = [m.info.grpc_address for m in ref.get_batch(skeys)]
    assert [m.info.grpc_address for m in port.get_batch(skeys)] == want
    assert [port.get(k).info.grpc_address for k in skeys] == want


@settings(max_examples=40, deadline=None)
@given(addrs=st.lists(_ADDR, min_size=2, max_size=12, unique=True), keys=_KEYS,
       hash_name=st.sampled_from(["fnv1", "fnv1a"]), cut=st.integers(1, 11))
def test_dual_ring_window_matches_reference(addrs, keys, hash_name, cut):
    old, new = addrs[: min(cut, len(addrs) - 1)], addrs[1:]
    windows = []
    for ring, PeerInfo in ((ref_ring, RefPeerInfo), (port_ring, PortPeerInfo)):
        windows.append(ring.DualRingWindow(
            ring.address_ring([PeerInfo(grpc_address=a) for a in old], hash_name),
            ring.address_ring([PeerInfo(grpc_address=a) for a in new], hash_name)))
    ref, port = windows
    for k in (k.decode("latin-1") for k in keys):
        assert port.owners(k) == ref.owners(k)
        assert port.owner(k) == ref.owner(k) and port.moved(k) == ref.moved(k)
        assert all(port.acceptable(k, a) == ref.acceptable(k, a) for a in addrs)


@settings(max_examples=40, deadline=None)
@given(addrs=st.lists(_ADDR, min_size=1, max_size=16, unique=True), keys=_KEYS,
       regions=st.lists(st.sampled_from(["", "us-east", "eu-west", "ap"]), min_size=16,
                        max_size=16))
def test_region_picker_matches_reference(addrs, keys, regions):
    pickers = []
    for ring, PeerInfo in ((ref_ring, RefPeerInfo), (port_ring, PortPeerInfo)):
        rp = ring.RegionPicker()
        for a, dc in zip(addrs, regions):
            rp.add(SimpleNamespace(info=PeerInfo(grpc_address=a, datacenter=dc)))
        pickers.append(rp)
    ref, port = pickers
    assert sorted(port.pickers()) == sorted(ref.pickers())
    for k in (k.decode("latin-1") for k in keys):
        assert sorted(c.info.grpc_address for c in port.get_clients(k)) == \
            sorted(c.info.grpc_address for c in ref.get_clients(k))
