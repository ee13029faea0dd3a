"""Consistent-hash peer routing.

The port's copy of `gubernator_tpu/cluster/hash_ring.py`: the same
rings, so a key has the same owner in either package.

Host-level key→owner-peer assignment with the same semantics as the
reference (reference: replicated_hash.go:29-119): each peer contributes
`replicas` virtual points on a uint64 ring — point i is
`hash(str(i) + md5hex(grpc_address))` — and a key routes to the first
ring point clockwise from `hash(key)`.  Hash is FNV-1 by default, FNV-1a
selectable (reference: config.go:395-417).

Routing is *batch-vectorized*.  The ring is a sorted
numpy uint64 array, a request batch is hashed in one vectorized FNV pass
(`hashing.fnv1_64_batch`) and routed with one `np.searchsorted` — the
host-side analog of the device kernel's gather, so the per-request
Python cost stays flat as batches grow.

Distribution caveat (reference-faithful — fasthash fnv1 is the
reference's default too): FNV-1's LAST operation is an xor, so keys
that differ only in their final byte(s) produce hashes that differ
only in low bits and fall into the SAME ring gap — sequentially
suffixed names like "key0".."key999" collapse onto ~one owner per
suffix-length class.  Real keys (entropy before the tail) distribute
fine; quantified: a byte changed k positions before the end moves the
hash by ~Δ·prime^k, so synthetic key generators should keep ≥3
constant bytes AFTER the varying ones, and
`GUBER_PEER_PICKER_HASH=fnv1a` (final op: multiply, full avalanche)
avoids the property entirely.

`RegionPicker` keeps one ring per datacenter for MULTI_REGION routing
(reference: region_picker.go:33-111).
"""

from __future__ import annotations

import hashlib
from typing import Callable, Dict, Generic, List, Optional, Sequence, TypeVar

import numpy as np

from gubernator_tpu_torch.hashing import fnv1_64, fnv1a_64, fnv1_64_batch, fnv1a_64_batch, pack_keys
from gubernator_tpu_torch.types import PeerInfo

# reference: replicated_hash.go:29 (defaultReplicas = 512)
DEFAULT_REPLICAS = 512

T = TypeVar("T")  # the member type: anything carrying a PeerInfo via .info


class PoolEmptyError(RuntimeError):
    """reference: replicated_hash.go:106 ("unable to pick a peer; pool is empty")"""

    def __init__(self) -> None:
        super().__init__("unable to pick a peer; pool is empty")


_SCALAR = {"fnv1": fnv1_64, "fnv1a": fnv1a_64}
_BATCH = {"fnv1": fnv1_64_batch, "fnv1a": fnv1a_64_batch}


class ReplicatedConsistentHash(Generic[T]):
    """Ring of virtual peer replicas; keys route via binary search.

    Members are arbitrary objects exposing `.info -> PeerInfo`; identity
    is `info.grpc_address` (reference: replicated_hash.go:78-79).
    """

    def __init__(self, hash_name: str = "fnv1", replicas: int = DEFAULT_REPLICAS):
        if hash_name not in _SCALAR:
            raise ValueError(f"unknown hash {hash_name!r}; want fnv1 or fnv1a")
        self.hash_name = hash_name
        self.replicas = replicas
        self._hash: Callable[[bytes], int] = _SCALAR[hash_name]
        self._members: Dict[str, T] = {}
        # Virtual ring points per member address, computed once on first
        # add (vectorized) and reused across rebuilds.
        self._points: Dict[str, np.ndarray] = {}
        # Sorted ring: hashes[i] is the ring point, owner_idx[i] indexes
        # into _member_list.
        self._member_list: List[T] = []
        self._hashes = np.empty(0, dtype=np.uint64)
        self._owner_idx = np.empty(0, dtype=np.int32)

    def new(self) -> "ReplicatedConsistentHash[T]":
        """Fresh empty picker with the same configuration (ring-point
        cache carried over so re-adding a known peer is free).

        reference: replicated_hash.go:61-67
        """
        picker = ReplicatedConsistentHash(self.hash_name, self.replicas)
        picker._points = dict(self._points)
        return picker

    # -- membership ----------------------------------------------------

    def add(self, member: T) -> None:
        """reference: replicated_hash.go:78-91"""
        info: PeerInfo = member.info  # type: ignore[attr-defined]
        self._members[info.grpc_address] = member
        self._rebuild()

    def add_all(self, members: Sequence[T]) -> None:
        for m in members:
            info: PeerInfo = m.info  # type: ignore[attr-defined]
            self._members[info.grpc_address] = m
        self._rebuild()

    def _member_points(self, address: str) -> np.ndarray:
        """The member's `replicas` ring points, cached after first use.

        Virtual point i = hash(str(i) + md5hex(address))
        (reference: replicated_hash.go:81-84), all `replicas` points
        hashed in one vectorized pass.
        """
        points = self._points.get(address)
        if points is None:
            key = hashlib.md5(address.encode()).hexdigest()
            padded, lengths = pack_keys(
                [(str(i) + key).encode() for i in range(self.replicas)]
            )
            points = _BATCH[self.hash_name](padded, lengths)
            self._points[address] = points
        return points

    def _rebuild(self) -> None:
        self._member_list = list(self._members.values())
        addresses = [m.info.grpc_address for m in self._member_list]  # type: ignore[attr-defined]
        # Prune cached points of departed members — new() copies the
        # cache forward on every membership change, so without pruning
        # it would grow with every address ever seen.
        self._points = {a: p for a, p in self._points.items() if a in self._members}
        if not addresses:
            self._hashes = np.empty(0, dtype=np.uint64)
            self._owner_idx = np.empty(0, dtype=np.int32)
            return
        hashes = np.concatenate([self._member_points(a) for a in addresses])
        owners = np.repeat(
            np.arange(len(addresses), dtype=np.int32), self.replicas
        )
        order = np.argsort(hashes, kind="stable")
        self._hashes = hashes[order]
        self._owner_idx = owners[order]

    def size(self) -> int:
        return len(self._members)

    def peers(self) -> List[T]:
        return list(self._members.values())

    def get_by_peer_info(self, info: PeerInfo) -> Optional[T]:
        """reference: replicated_hash.go:99-101"""
        return self._members.get(info.grpc_address)

    # -- routing -------------------------------------------------------

    def get(self, key: str) -> T:
        """Owner of one key. reference: replicated_hash.go:104-119"""
        if not self._member_list:
            raise PoolEmptyError()
        h = self._hash(key.encode())
        idx = int(np.searchsorted(self._hashes, np.uint64(h), side="left"))
        if idx == len(self._hashes):
            idx = 0
        return self._member_list[self._owner_idx[idx]]

    def get_batch(self, keys: Sequence[str]) -> List[T]:
        """Vectorized owner lookup for a whole request batch."""
        if not keys:
            return []
        padded, lengths = pack_keys([k.encode() for k in keys])
        return self.get_batch_hashed(_BATCH[self.hash_name](padded, lengths))

    def get_batch_dual_hashed(self, fnv1, fnv1a) -> List[T]:
        """Owner lookup given BOTH precomputed hash columns (the
        native wire codec emits fnv1 and fnv1a per key) — the single
        place that picks the column matching `hash_name`."""
        return self.get_batch_hashed(
            np.asarray(fnv1 if self.hash_name == "fnv1" else fnv1a)
        )

    def get_batch_hashed(self, hashes: np.ndarray) -> List[T]:
        """Owner lookup from precomputed key hashes (the native wire
        codec emits both fnv1 and fnv1a per key; pick the column
        matching `hash_name`)."""
        if not self._member_list:
            raise PoolEmptyError()
        idx = np.searchsorted(self._hashes, hashes, side="left")
        idx[idx == len(self._hashes)] = 0
        owners = self._owner_idx[idx]
        return [self._member_list[i] for i in owners]


class ConsistentHash(ReplicatedConsistentHash[T]):
    """Non-replicated picker: ONE ring point per peer (the point is
    hash(grpc_address)) — the reference's legacy 'consistent-hash'
    GUBER_PEER_PICKER choice (config.go:395-417).  Cheaper rebuilds,
    lumpier key distribution; replicated-hash remains the default."""

    def __init__(self, hash_name: str = "fnv1"):
        super().__init__(hash_name, replicas=1)

    def new(self) -> "ConsistentHash[T]":
        picker = ConsistentHash(self.hash_name)
        picker._points = dict(self._points)
        return picker

    def _member_points(self, address: str) -> np.ndarray:
        points = self._points.get(address)
        if points is None:
            points = np.asarray(
                [self._hash(address.encode())], dtype=np.uint64
            )
            self._points[address] = points
        return points


def make_picker(
    picker: str, hash_name: str, replicas: int = DEFAULT_REPLICAS
):
    """GUBER_PEER_PICKER → picker instance (reference config.go:395-417)."""
    if picker in ("", "replicated-hash"):
        return ReplicatedConsistentHash(hash_name, replicas)
    if picker == "consistent-hash":
        return ConsistentHash(hash_name)
    raise ValueError(
        f"GUBER_PEER_PICKER={picker!r} is invalid; choices are "
        "['replicated-hash', 'consistent-hash']"
    )


class RingMember:
    """Address-only ring member: a PeerInfo with no client attached.
    Membership planning (cluster/membership.py) builds throwaway rings
    over candidate views before any PeerClient exists for them."""

    __slots__ = ("info",)

    def __init__(self, info: PeerInfo):
        self.info = info


def address_ring(
    infos: Sequence[PeerInfo],
    hash_name: str = "fnv1",
    picker: str = "replicated-hash",
    replicas: int = DEFAULT_REPLICAS,
) -> "ReplicatedConsistentHash[RingMember]":
    """A routing ring over bare PeerInfos (no clients, no daemon) —
    the membership plane's way of asking "who WOULD own key k under
    view V" without mutating any serving state."""
    ring = make_picker(picker, hash_name, replicas)
    ring.add_all([RingMember(i) for i in infos])
    return ring


class DualRingWindow:
    """Old + new rings valid simultaneously during a membership
    cutover (the DualMap-style routing window, PAPERS.md).

    While an epoch transition is in flight, requests ROUTE to the new
    ring's owner, but the old ring's owner remains an ACCEPTABLE
    destination.  In this codebase the acceptance half is realized by
    the peer-serving contract itself — `get_peer_rate_limits`
    receivers answer authoritatively and never re-forward, so
    in-flight forwards and hit pushes keyed to the old owner cannot
    404 — which makes this object the window's *verification and
    introspection* surface rather than a serving-path gate: the
    membership manager exposes it (`dual_window()`) while a cutover
    is open, and tests/test_hash_ring.py pins its invariant — every
    key lands on its old or new owner, never a third node."""

    __slots__ = ("old", "new")

    def __init__(
        self,
        old: "ReplicatedConsistentHash",
        new: "ReplicatedConsistentHash",
    ):
        self.old = old
        self.new = new

    def owner(self, key: str) -> str:
        """Routing decision: the NEW ring's owner address (traffic
        converges toward the post-cutover topology)."""
        return self.new.get(key).info.grpc_address

    def owners(self, key: str):
        """(old_owner_addr, new_owner_addr) for one key."""
        return (
            self.old.get(key).info.grpc_address,
            self.new.get(key).info.grpc_address,
        )

    def acceptable(self, key: str, addr: str) -> bool:
        """True when `addr` may serve `key` during the window (it is
        the key's owner in the old OR the new ring)."""
        # guberlint: invariant dual-window-no-third-owner
        return addr in self.owners(key)

    def moved(self, key: str) -> bool:
        old_addr, new_addr = self.owners(key)
        return old_addr != new_addr


class RegionPicker(Generic[T]):
    """One consistent-hash ring per datacenter.

    reference: region_picker.go:33-111.  `get_clients(key)` returns the
    key's owner in *every* region (used by MULTI_REGION replication).
    """

    def __init__(self, hash_name: str = "fnv1", replicas: int = DEFAULT_REPLICAS):
        self.hash_name = hash_name
        self.replicas = replicas
        self._regions: Dict[str, ReplicatedConsistentHash[T]] = {}

    def new(self) -> "RegionPicker[T]":
        return RegionPicker(self.hash_name, self.replicas)

    def add(self, member: T) -> None:
        """reference: region_picker.go:104-111"""
        info: PeerInfo = member.info  # type: ignore[attr-defined]
        picker = self._regions.get(info.datacenter)
        if picker is None:
            picker = ReplicatedConsistentHash(self.hash_name, self.replicas)
            self._regions[info.datacenter] = picker
        picker.add(member)

    def get_clients(self, key: str) -> List[T]:
        """The key's owner in every region. reference: region_picker.go:63-75"""
        return [picker.get(key) for picker in self._regions.values()]

    def get_by_peer_info(self, info: PeerInfo) -> Optional[T]:
        """reference: region_picker.go:78-85"""
        for picker in self._regions.values():
            member = picker.get_by_peer_info(info)
            if member is not None:
                return member
        return None

    def pickers(self) -> Dict[str, ReplicatedConsistentHash[T]]:
        return self._regions

    def peers(self) -> List[T]:
        out: List[T] = []
        for picker in self._regions.values():
            out.extend(picker.peers())
        return out

    def size(self) -> int:
        return sum(p.size() for p in self._regions.values())
