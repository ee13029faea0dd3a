"""Persistence interfaces: the write-through Store and the bulk Loader.

The port's own copy of `gubernator_tpu/store.py` (the port imports
nothing of the JAX package).  reference: store.go — `Store` gets
OnChange/Get/Remove called inline by the algorithms (:49-65, call sites
algorithms.go:46-54,164-169,266-269); `Loader` streams the whole cache
in at startup and out at shutdown (:69-78, driven by
gubernator_pool.go:341-531).  The bucket value structs mirror
store.go:29-43.

Bucket state lives on the device, so
- `Store.get` hydrates a freshly interned slot through the restore
  kernel (`ops.fused_step.load_slots`, K5) instead of a cache insert;
- `Store.on_change` receives values derived from the step's response
  (for LEAKY_BUCKET the sub-integer remainder is quantized to the
  response's integer `remaining` — the reference hands the store its
  float64; a restored bucket may therefore leak up to one hit of
  precision per save/restore cycle);
- `Loader.save`/`load` carry full-fidelity snapshots (the exact 32.32
  words of the leaky remaining in `remaining_words`).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Iterable, Iterator, List, Optional, Protocol, Union

from gubernator_tpu_torch.types import Algorithm, RateLimitReq


@dataclass
class TokenBucketItem:
    """reference: store.go:29-35."""

    status: int = 0
    limit: int = 0
    duration: int = 0
    remaining: int = 0
    created_at: int = 0  # unix ms


@dataclass
class LeakyBucketItem:
    """reference: store.go:37-43."""

    limit: int = 0
    duration: int = 0
    remaining: float = 0.0
    updated_at: int = 0  # unix ms
    burst: int = 0
    # Exact 32.32 fixed-point (whole, frac) words of `remaining`, set by
    # engine snapshots so Loader round trips are bit-exact even where
    # the float64 mirror rounds (whole part >= 2^21); restores prefer
    # them over `remaining` when present.
    remaining_words: Optional[tuple] = None


@dataclass
class CacheItem:
    """reference: cache.go:30-42."""

    key: str = ""
    value: Union[TokenBucketItem, LeakyBucketItem, None] = None
    expire_at: int = 0  # unix ms
    algorithm: int = Algorithm.TOKEN_BUCKET
    # A store may set this to force the cache to treat the item as
    # invalid after this time (reference: cache.go:37-41).
    invalid_at: int = 0


def words_from_float(v: float) -> tuple:
    """float remaining → exact-as-possible 32.32 fixed-point words."""
    whole = math.floor(v)
    frac = min((v - whole) * (2.0**32), 2.0**32 - 1)
    return (int(whole), int(frac))


def item_from_record(
    key: str,
    algorithm: int,
    status: int,
    limit: int,
    remaining: int,
    remf_hi: int,
    remf_lo: int,
    duration: int,
    t0: int,
    expire_at: int,
    burst: int,
    invalid_at: int,
) -> CacheItem:
    """A CacheItem from one slot's decoded state words — the one place
    that maps snapshot columns onto bucket value structs."""
    if algorithm == int(Algorithm.TOKEN_BUCKET):
        value: Union[TokenBucketItem, LeakyBucketItem] = TokenBucketItem(
            status=status,
            limit=limit,
            duration=duration,
            remaining=remaining,
            created_at=t0,
        )
    else:
        value = LeakyBucketItem(
            limit=limit,
            duration=duration,
            # The float mirror rounds at whole >= 2^21; the words are exact.
            remaining=float(remf_hi) + float(remf_lo) * 2.0**-32,
            updated_at=t0,
            burst=burst,
            remaining_words=(remf_hi, remf_lo),
        )
    return CacheItem(
        key=key,
        value=value,
        expire_at=expire_at,
        algorithm=algorithm,
        invalid_at=invalid_at,
    )


class Store(Protocol):
    """Write-through hooks, called by the engine per touched key.

    reference: store.go:49-65.
    """

    def on_change(self, req: RateLimitReq, item: CacheItem) -> None: ...

    def get(self, req: RateLimitReq) -> Optional[CacheItem]: ...

    def remove(self, key: str) -> None: ...


class Loader(Protocol):
    """Bulk restore at startup and persist at shutdown.

    reference: store.go:69-78.
    """

    def load(self) -> Iterable[CacheItem]: ...

    def save(self, items: Iterator[CacheItem]) -> None: ...


class MemoryStore:
    """Dict-backed Store (reference: MockStore, store.go:80-112)."""

    def __init__(self) -> None:
        self.data: Dict[str, CacheItem] = {}
        self.on_change_calls = 0
        self.get_calls = 0
        self.remove_calls = 0

    def on_change(self, req: RateLimitReq, item: CacheItem) -> None:
        self.on_change_calls += 1
        self.data[item.key] = item

    def get(self, req: RateLimitReq) -> Optional[CacheItem]:
        self.get_calls += 1
        return self.data.get(req.hash_key())

    def remove(self, key: str) -> None:
        self.remove_calls += 1
        self.data.pop(key, None)


class MemoryLoader:
    """List-backed Loader (reference: MockLoader, store.go:114-150)."""

    def __init__(self, items: Optional[List[CacheItem]] = None) -> None:
        self.items: List[CacheItem] = list(items or [])
        self.load_calls = 0
        self.save_calls = 0

    def load(self) -> Iterable[CacheItem]:
        self.load_calls += 1
        return list(self.items)

    def save(self, items: Iterator[CacheItem]) -> None:
        self.save_calls += 1
        self.items = list(items)
