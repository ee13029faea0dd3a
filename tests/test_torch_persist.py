"""The port's persistence path against the JAX package's, on the CPU.

* `load_slots_reference` (the plain version of kernel K5) against JAX
  `_load_slots_impl` on the same records and state, extreme values
  included; `build_restore_record`, `item_from_record` and
  `words_from_float` against the JAX ones.
* The port engine with a `MemoryStore`, and through `load` /
  `export_items` / `save`, against the JAX `DecisionEngine`, both on
  frozen clocks: ports of tests/test_store.py:50, :66, :87, :105, :117,
  :145, :175, :189 and :248 (the sharded case at :221 waits for the
  port's sharded engine) and tests/test_state_packing.py:124 (the export
  round trip), each run through both engines where the case drives an
  engine, the daemon cases through the port daemon with the JAX engine
  as the oracle of the answers.
* A seeded stream with a store and a small capacity, which drives the
  clear → restore → apply order at a round k > 0: a key evicted and asked
  for again within one batch.
* npz checkpoints that cross between the packages both ways.

Tolerance: exact — every response field, state word and stored item.
"""

from __future__ import annotations

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gubernator_tpu.ops.bucket_kernel as jbk
from gubernator_tpu import store as jstore
from gubernator_tpu.checkpoint import NpzFileLoader as RefNpzFileLoader
from gubernator_tpu.clock import Clock as RefClock
from gubernator_tpu.core.engine import DecisionEngine as RefEngine
from gubernator_tpu.core.engine import build_restore_record as ref_build_restore_record
from gubernator_tpu.types import RateLimitReq as RefReq
from gubernator_tpu_torch import store as tstore
from gubernator_tpu_torch.checkpoint import NpzFileLoader
from gubernator_tpu_torch.clock import Clock
from gubernator_tpu_torch.core.engine import DecisionEngine
from gubernator_tpu_torch.ops import bucket_kernel as tk
from gubernator_tpu_torch.types import Algorithm, Behavior, RateLimitReq, Status

T0_NS = 1_760_000_000_123 * 1_000_000
TOKEN, LEAKY = int(Algorithm.TOKEN_BUCKET), int(Algorithm.LEAKY_BUCKET)
RESET = int(Behavior.RESET_REMAINING)
GREG = int(Behavior.DURATION_IS_GREGORIAN)


# ---------------------------------------------------------------------------
# The restore record and the plain restore step.


def _random_words(rng, cap, now):
    return tk.pack_state_host(dict(
        occupied=rng.random(cap) < 0.5, algo=rng.integers(0, 2, cap),
        status=rng.integers(0, 2, cap), t0=now - rng.integers(0, 5_000, cap),
        invalid=np.where(rng.random(cap) < 0.1, now + 7, 0), expire=now + rng.integers(-9, 9, cap),
        duration=rng.choice([0, 1, 40, 1000], cap), limit=rng.choice([0, 5, 10**12], cap),
        remaining=rng.integers(-5, 200, cap), remf_hi=rng.integers(-3, 200, cap).astype(np.int32),
        remf_lo=rng.integers(0, 2**32, cap, dtype=np.uint64).astype(np.uint32),
        burst=rng.choice([0, 5, 20], cap),
    ))


def random_record(rng, cap, n, size, now, *, extreme=False):
    """SlotRecord columns typed as the reference's: n sorted unique slots,
    padding lanes at cap + lane.  `extreme`: negative and > 2^43
    timestamps and durations, leaky fraction words >= 2^31, limit and
    burst >= 2^32, odd algo and status values."""
    rec = {
        "slot": np.arange(cap, cap + size, dtype=np.int64).astype(np.int32),
        "algo": np.zeros(size, np.int32), "status": np.zeros(size, np.int32),
        "remf_hi": np.zeros(size, np.int32), "remf_lo": np.zeros(size, np.uint32),
        **{k: np.zeros(size, np.int64) for k in ("limit", "remaining", "duration", "t0",
                                                   "expire_at", "burst", "invalid_at")},
    }
    rec["slot"][:n] = np.sort(rng.choice(cap, n, replace=False))
    rec["algo"][:n] = rng.choice([0, 1, 2, -1] if extreme else [0, 1], n)
    rec["status"][:n] = rng.choice([0, 1, 3, -2] if extreme else [0, 1], n)
    big = [2**32, 2**40 + 5, 2**62, -(2**35), -7] if extreme else [0, 10, 10**6]
    rec["limit"][:n] = rng.choice(big, n)
    rec["burst"][:n] = rng.choice(big, n)
    rec["remaining"][:n] = rng.choice(big + [3, -1], n)
    rec["remf_hi"][:n] = rng.integers(-(2**31), 2**31, n) if extreme else rng.integers(0, 50, n)
    rec["remf_lo"][:n] = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    ts = ([-5, 0, 2**43 - 1, 2**43, 2**50, -(2**40), now] if extreme
          else [now - 1000, now, now + 60_000])
    for k in ("t0", "expire_at", "invalid_at", "duration"):
        rec[k][:n] = rng.choice(ts, n) + rng.integers(0, 3, n)
    return rec


@pytest.mark.parametrize("n,size,extreme", [(0, 16, False), (5, 16, False), (16, 16, True),
                                            (200, 256, True), (3000, 4096, False),
                                            (4096, 4096, True)])
def test_load_slots_reference_matches_jax(n, size, extreme):
    rng = np.random.default_rng(n + size + extreme)
    cap, now = 8192, 1_760_000_000_000
    words = _random_words(rng, cap, now)
    rec = random_record(rng, cap, n, size, now, extreme=extreme)
    ref = jbk._load_slots_impl(
        jbk.BucketState(**{f: jnp.asarray(words[f]) for f in words}),
        jbk.SlotRecord(**{k: jnp.asarray(a) for k, a in rec.items()}))
    state = tk.state_from_numpy(words, "cpu")
    tk.load_slots_reference(state, torch.from_numpy(tk.pack_restore_host(rec)))
    got = tk.state_to_numpy(state)
    for f in tk.BucketState._fields:
        assert np.array_equal(got[f], np.asarray(getattr(ref, f))), f


def _items(mod, now):
    """Token and leaky items, leaky with and without exact words."""
    return [
        (3, mod.CacheItem(key="a", value=mod.TokenBucketItem(
            status=1, limit=10, duration=60_000, remaining=3, created_at=now - 5),
            expire_at=now + 59_000, algorithm=TOKEN)),
        (0, mod.CacheItem(key="b", value=mod.LeakyBucketItem(
            limit=10, duration=1000, remaining=4.75, updated_at=now, burst=12),
            expire_at=now + 1000, algorithm=LEAKY, invalid_at=now + 9)),
        (9, mod.CacheItem(key="c", value=mod.LeakyBucketItem(
            limit=2**40, duration=7, remaining=3.0, updated_at=now, burst=2**33,
            remaining_words=(2**30, 2**31 + 5)), expire_at=now + 7, algorithm=LEAKY)),
        (5, mod.CacheItem(key="d", value=mod.TokenBucketItem(
            status=0, limit=2**35, duration=2**44, remaining=-4, created_at=-3),
            expire_at=2**45, algorithm=TOKEN)),
    ]


@pytest.mark.parametrize("size", [None, 64])
def test_build_restore_record_matches_jax(size):
    now = 1_760_000_000_000
    got = tk.build_restore_record(_items(tstore, now), 16, size)
    want = ref_build_restore_record(_items(jstore, now), 16, size)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    buf = tk.pack_restore_host(got)
    assert buf.shape == (tk.RESTORE_ROWS, len(want["slot"])) and buf.dtype == np.int32


@pytest.mark.parametrize("v", [0.0, 4.75, 1e-12, 2.0**21 + 0.5, -3.25, 123456.789])
def test_store_helpers_match_jax(v):
    assert tstore.words_from_float(v) == jstore.words_from_float(v)
    args = dict(key="k", status=1, limit=7, remaining=-2, remf_hi=5, remf_lo=2**31 + 3,
                duration=9, t0=11, expire_at=13, burst=4, invalid_at=2)
    for algo in (TOKEN, LEAKY):
        assert dataclasses.asdict(tstore.item_from_record(algorithm=algo, **args)) == \
            dataclasses.asdict(jstore.item_from_record(algorithm=algo, **args))


# ---------------------------------------------------------------------------
# Engines with a store, a loader, and checkpoints.


def _pair(capacity, *, store=False):
    rs = jstore.MemoryStore() if store else None
    ps = tstore.MemoryStore() if store else None
    ref = RefEngine(capacity=capacity, clock=RefClock().freeze_at(T0_NS), store=rs)
    port = DecisionEngine(capacity, clock=Clock().freeze_at(T0_NS), device="cpu", store=ps)
    return ref, port


def _req(cls, key="k1", hits=1, limit=10, duration=60_000, **kw):
    return cls(name="test_store", unique_key=key, hits=hits, limit=limit, duration=duration, **kw)


def _both(ref, port, specs):
    """One batch through both engines (`specs`: kwargs of _req); returns
    the port's responses after holding them equal to the reference's."""
    want = ref.get_rate_limits([_req(RefReq, **s) for s in specs])
    got = port.get_rate_limits([_req(RateLimitReq, **s) for s in specs])
    for g, w in zip(got, want):
        assert (g.error, int(g.status), g.limit, g.remaining, g.reset_time) == (
            w.error, int(w.status), w.limit, w.remaining, w.reset_time)
    return got


def _asdict(items):
    return [dataclasses.asdict(i) for i in items]


def _to_port(item):
    """A JAX package CacheItem as the port's."""
    cls = tstore.TokenBucketItem if isinstance(item.value, jstore.TokenBucketItem) else (
        tstore.LeakyBucketItem)
    fields = dataclasses.asdict(item)
    return tstore.CacheItem(**dict(fields, value=cls(**fields["value"])))


def _assert_same_store(ref, port):
    assert (port.store.on_change_calls, port.store.get_calls, port.store.remove_calls) == (
        ref.store.on_change_calls, ref.store.get_calls, ref.store.remove_calls)
    assert {k: dataclasses.asdict(v) for k, v in port.store.data.items()} == {
        k: dataclasses.asdict(v) for k, v in ref.store.data.items()}


def _assert_identical(ref, port):
    """The same key on every slot and the same 12 words on every slot."""
    ref._flush_pump()
    assert len(ref.table) == len(port.table)
    for s in range(port.capacity):
        assert port.table.key_for_slot(s) == ref.table.key_for_slot(s), s
    want = {f: np.asarray(getattr(ref._state, f)) for f in ref._state._fields}
    got = tk.state_to_numpy(port.state)
    for f in tk.BucketState._fields:
        assert np.array_equal(got[f], want[f]), f


def _advance(ms, *engines):
    for e in engines:
        e.clock.advance(ms=ms)


def test_store_write_through():
    """tests/test_store.py:50."""
    ref, port = _pair(100, store=True)
    assert _both(ref, port, [{}])[0].remaining == 9
    item = port.store.data["test_store_k1"]
    assert isinstance(item.value, tstore.TokenBucketItem)
    assert (item.value.remaining, item.value.limit) == (9, 10)
    assert item.expire_at == port.clock.now_ms() + 60_000
    _both(ref, port, [{}])
    assert port.store.data["test_store_k1"].value.remaining == 8
    _assert_same_store(ref, port)
    _assert_identical(ref, port)


def test_store_read_through_restores_bucket():
    """tests/test_store.py:66: a new engine with a primed store continues
    the persisted bucket."""
    ref, port = _pair(100, store=True)
    now = port.clock.now_ms()
    for mod, eng in ((jstore, ref), (tstore, port)):
        eng.store.data["test_store_k1"] = mod.CacheItem(
            key="test_store_k1", value=mod.TokenBucketItem(
                status=Status.UNDER_LIMIT, limit=10, duration=60_000, remaining=3,
                created_at=now - 1_000),
            expire_at=now + 59_000, algorithm=TOKEN)
    r = _both(ref, port, [{}])[0]
    assert port.store.get_calls == 1
    assert (r.remaining, r.reset_time) == (2, now - 1_000 + 60_000)
    _assert_same_store(ref, port)
    _assert_identical(ref, port)


def test_store_read_through_leaky():
    """tests/test_store.py:87."""
    ref, port = _pair(100, store=True)
    now = port.clock.now_ms()
    for mod, eng in ((jstore, ref), (tstore, port)):
        eng.store.data["test_store_lk"] = mod.CacheItem(
            key="test_store_lk", value=mod.LeakyBucketItem(
                limit=10, duration=60_000, remaining=5.0, updated_at=now, burst=10),
            expire_at=now + 60_000, algorithm=LEAKY)
    assert _both(ref, port, [dict(key="lk", algorithm=LEAKY, burst=10)])[0].remaining == 4
    _assert_same_store(ref, port)
    _assert_identical(ref, port)


def test_store_remove_on_reset_remaining():
    """tests/test_store.py:105."""
    ref, port = _pair(100, store=True)
    _both(ref, port, [dict(hits=5)])
    assert port.store.data["test_store_k1"].value.remaining == 5
    r = _both(ref, port, [dict(hits=0, behavior=RESET)])[0]
    assert (port.store.remove_calls, r.remaining) == (1, 10)
    _assert_same_store(ref, port)


def test_store_gregorian_and_duplicates_in_one_batch():
    """A Gregorian token item stores created_at = now; a key repeated in a
    batch writes through once per request."""
    ref, port = _pair(100, store=True)
    _both(ref, port, [dict(key="g", behavior=GREG, duration=2), dict(key="x"), dict(key="x"),
                      dict(key="g", behavior=GREG, duration=2, hits=2),
                      dict(key="bad", behavior=GREG, duration=9)])
    assert port.store.data["test_store_g"].value.created_at == port.clock.now_ms()
    _assert_same_store(ref, port)
    _assert_identical(ref, port)


def test_store_apply_columnar_raises():
    _, port = _pair(16, store=True)
    with pytest.raises(RuntimeError, match="Store"):
        port.apply_columnar([b"k"], *(np.zeros(1, np.int32),) * 2, *(np.ones(1, np.int64),) * 4)


def _save_load(eng_a, eng_b, loader):
    eng_a.save(loader)
    return eng_b.load(loader)


def test_loader_round_trip():
    """tests/test_store.py:117 (reference store_test.go TestLoader:76)."""
    ref1, port1 = _pair(100)
    _both(ref1, port1, [dict(key="a", hits=4), dict(key="b", hits=2, algorithm=LEAKY, burst=10)])
    rl, pl = jstore.MemoryLoader(), tstore.MemoryLoader()
    ref2, port2 = _pair(100)
    assert _save_load(port1, port2, pl) == _save_load(ref1, ref2, rl) == 2
    assert pl.save_calls == 1 and _asdict(pl.items) == _asdict(rl.items)
    assert port2.cache_size() == 2
    assert _both(ref2, port2, [dict(key="a", hits=0)])[0].remaining == 6
    assert _both(ref2, port2, [dict(key="b", hits=0, algorithm=LEAKY, burst=10)])[0].remaining == 8
    _assert_identical(ref2, port2)


def test_leaky_fraction_survives_loader():
    """tests/test_store.py:145: the leaky 32.32 words round-trip exactly."""
    ref1, port1 = _pair(100)
    spec = dict(key="f", limit=3, duration=1000, algorithm=LEAKY, burst=3)
    assert _both(ref1, port1, [dict(spec, hits=3)])[0].remaining == 0
    _advance(500, ref1, port1)
    rl, pl = jstore.MemoryLoader(), tstore.MemoryLoader()
    ref2, port2 = _pair(100)
    _advance(500, ref2, port2)
    _save_load(ref1, ref2, rl)
    _save_load(port1, port2, pl)
    assert _asdict(pl.items) == _asdict(rl.items)
    r1 = _both(ref1, port1, [dict(spec, hits=1)])[0]
    r2 = _both(ref2, port2, [dict(spec, hits=1)])[0]
    assert (r1.status, r1.remaining, r1.reset_time) == (r2.status, r2.remaining, r2.reset_time)
    _assert_identical(ref2, port2)


def test_npz_checkpoint(tmp_path):
    """tests/test_store.py:189."""
    ref1, port1 = _pair(100)
    _both(ref1, port1, [dict(key=f"k{i}", hits=i % 5) for i in range(50)])
    ref2, port2 = _pair(100)
    rpath, ppath = os.fspath(tmp_path / "ref.npz"), os.fspath(tmp_path / "port.npz")
    assert _save_load(ref1, ref2, RefNpzFileLoader(rpath)) == 50
    assert _save_load(port1, port2, NpzFileLoader(ppath)) == 50
    with np.load(rpath, allow_pickle=True) as a, np.load(ppath, allow_pickle=True) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    assert _both(ref2, port2, [dict(key="k4", hits=0)])[0].remaining == 10 - 4
    _assert_identical(ref2, port2)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_npz_checkpoint_crosses_packages(tmp_path, direction):
    """A checkpoint written by one package loads in the other and the
    buckets continue as in the engine that never stopped."""
    rng = np.random.default_rng(7)
    ref1, port1 = _pair(256)
    specs = [dict(key=f"x{int(rng.integers(60))}", hits=int(rng.integers(0, 4)),
                  algorithm=int(rng.integers(0, 2)), burst=int(rng.choice([0, 8])),
                  duration=int(rng.choice([1000, 60_000])), limit=int(rng.choice([5, 10**6])))
             for _ in range(150)]
    for lo in range(0, 150, 30):
        _both(ref1, port1, specs[lo:lo + 30])
        _advance(333, ref1, port1)
    path = os.fspath(tmp_path / "x.npz")
    ref2, port2 = _pair(256)
    _advance(5 * 333, ref2, port2)  # the instant the first pair stopped at
    if direction == "jax_to_port":
        ref1.save(RefNpzFileLoader(path))
        n = port2.load(NpzFileLoader(path))
        ref2.load(RefNpzFileLoader(path))
    else:
        port1.save(NpzFileLoader(path))
        n = ref2.load(RefNpzFileLoader(path))
        port2.load(NpzFileLoader(path))
    assert n == len(ref1.table) > 0
    _advance(500, ref1, port1, ref2, port2)
    follow = specs[:60]
    a = _both(ref1, port1, follow)
    b = _both(ref2, port2, follow)
    assert [(x.status, x.remaining, x.reset_time) for x in a] == [
        (x.status, x.remaining, x.reset_time) for x in b]
    _assert_identical(ref2, port2)


def test_load_with_evictions_and_repeated_keys():
    """`load` into a capacity below the item count (evictions, cleared
    before their slot's restore) with a key given twice (the pending
    batch flushes before the slot is reused): as the reference."""
    rng = np.random.default_rng(11)
    ref1, port1 = _pair(512)
    _both(ref1, port1, [dict(key=f"l{i}", hits=int(rng.integers(0, 5)), algorithm=i % 2)
                        for i in range(300)])
    rl = jstore.MemoryLoader()
    ref1.save(rl)
    items_ref = rl.items + rl.items[:40]
    items_port = [_to_port(i) for i in items_ref]
    assert _asdict(items_port) == _asdict(items_ref)
    ref2, port2 = _pair(128)
    assert port2.load(tstore.MemoryLoader(items_port)) == ref2.load(
        jstore.MemoryLoader(items_ref)) == 340
    assert port2.table.evictions == ref2.table.evictions > 0
    assert port2.clears_total > 0
    _assert_identical(ref2, port2)
    _both(ref2, port2, [dict(key=f"l{i}", hits=1, algorithm=i % 2) for i in range(0, 300, 7)])
    _assert_identical(ref2, port2)


def test_export_round_trip_through_engine():
    """tests/test_state_packing.py:124: decisions → export_items → a fresh
    engine's load → identical follow-up decisions."""
    ref, port = _pair(64)
    specs = [dict(key=f"{i}k", hits=2, limit=11, algorithm=TOKEN if i % 2 == 0 else LEAKY)
             for i in range(20)]
    _both(ref, port, specs)
    items, ref_items = list(port.export_items()), list(ref.export_items())
    assert len(items) == 20 and _asdict(items) == _asdict(ref_items)
    ref2, port2 = _pair(64)
    assert port2.load(tstore.MemoryLoader(items)) == ref2.load(
        jstore.MemoryLoader(ref_items)) == 20
    r1 = _both(ref, port, specs)
    r2 = _both(ref2, port2, specs)
    assert [(a.status, a.remaining, a.reset_time) for a in r1] == [
        (b.status, b.remaining, b.reset_time) for b in r2]
    _assert_identical(ref2, port2)


class _Trace:
    """Records the order of a port engine's submits, K2 clears and K5
    restores (slots), batch by batch."""

    def __init__(self, eng):
        self.events = []
        submit, clears, restores = eng._pump.submit, eng._apply_clears, eng._apply_restores

        def on_submit(packed):
            self.events.append(("submit", None))
            return submit(packed)

        def on_clears(c):
            self.events.append(("clear", {int(s) for s in c}))
            clears(c)

        def on_restores(r):
            self.events.append(("restore", {int(s) for s, _ in r}))
            restores(r)

        eng._pump.submit, eng._apply_clears, eng._apply_restores = on_submit, on_clears, on_restores

    def clear_restore_after_submit(self) -> int:
        """Restores of a slot cleared just before them, in a batch whose
        earlier rounds were already submitted (round k > 0)."""
        hits = 0
        for i in range(2, len(self.events)):
            (a, _), (b, cleared), (c, restored) = self.events[i - 2 : i + 1]
            if a == "submit" and b == "clear" and c == "restore" and cleared & restored:
                hits += 1
        return hits


def test_store_fuzz_clear_restore_apply_at_later_rounds():
    """A seeded stream with a store and 8 slots for 24 keys: keys are
    evicted and asked for again within one batch, so a round k > 0 runs
    its eviction clear, then the store's restore of the same slot, then
    its apply.  Answers, state words and stores as the reference's."""
    rng = np.random.default_rng(2026)
    ref, port = _pair(8, store=True)
    trace = _Trace(port)
    keys = [f"z{i}" for i in range(24)]
    for b in range(40):
        n = int(rng.integers(4, 20))
        specs = [dict(key=keys[int(rng.integers(len(keys)))] if rng.random() < 0.6 else
                      keys[int(rng.integers(6))], hits=int(rng.choice([0, 1, 1, 2, 5])),
                      algorithm=int(rng.integers(0, 2)), burst=int(rng.choice([0, 6])),
                      limit=int(rng.choice([5, 20])), duration=int(rng.choice([400, 60_000])),
                      behavior=RESET if rng.random() < 0.05 else 0) for _ in range(n)]
        _both(ref, port, specs)
        _advance(int(rng.choice([0, 50, 300])), ref, port)
        if b % 10 == 9:
            _assert_identical(ref, port)
            _assert_same_store(ref, port)
    assert port.table.evictions == ref.table.evictions > 0
    assert trace.clear_restore_after_submit() > 0
    _assert_identical(ref, port)
    _assert_same_store(ref, port)


def test_store_case_evicted_key_returns_in_one_batch():
    """The case by hand: 2 slots; batch [a, b, c, a] evicts a for c and
    brings a back from the store in round 1 of the same batch, onto the
    slot it clears in that round."""
    ref, port = _pair(2, store=True)
    trace = _Trace(port)
    _both(ref, port, [dict(key="a", hits=3), dict(key="b", hits=1)])
    _both(ref, port, [dict(key="b"), dict(key="c", hits=2), dict(key="b"), dict(key="a")])
    assert trace.clear_restore_after_submit() >= 1
    _assert_identical(ref, port)
    _assert_same_store(ref, port)
    assert port.store.data["test_store_a"].value.remaining == 6


# ---------------------------------------------------------------------------
# The daemon: store, loader and the sweep thread.


def _port_daemon(tmp_path=None, **kw):
    from gubernator_tpu_torch.config import DaemonConfig
    from gubernator_tpu_torch.daemon import spawn_daemon

    conf = DaemonConfig(http_listen_address="127.0.0.1:0", cache_size=1000,
                        sweep_interval=kw.pop("sweep_interval", 0.0))
    return spawn_daemon(conf, clock=kw.pop("clock"), device="cpu", **kw)


def _http(addr, specs):
    import json
    import urllib.request

    body = json.dumps({"requests": [vars(_req(RateLimitReq, **s)) for s in specs]}).encode()
    with urllib.request.urlopen(urllib.request.Request(
            f"http://{addr}/v1/GetRateLimits", data=body, method="POST"), timeout=30) as r:
        return json.loads(r.read())["responses"]


def test_daemon_periodic_sweep():
    """tests/test_store.py:175: the daemon's sweep thread reclaims expired
    slots, and the slots it frees are the reference engine's."""
    import time

    clock = Clock().freeze_at(T0_NS)
    ref = RefEngine(capacity=1000, clock=RefClock().freeze_at(T0_NS))
    d = _port_daemon(clock=clock, sweep_interval=0.2)
    try:
        eng = d.instance.engine
        specs = [dict(key=f"sw{i}", duration=1_000 + 10 * (i % 3)) for i in range(20)]
        _both(ref, eng, specs)
        assert eng.cache_size() == 20
        clock.advance(ms=1_015)  # two thirds expire
        ref.clock.advance(ms=1_015)
        assert ref.sweep(max_windows=16) == 14
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and eng.cache_size() > 6:
            time.sleep(0.05)
        assert eng.cache_size() == 6
        assert eng.sweep_windows_total >= 1
        clock.advance(ms=2_000)
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and eng.cache_size() > 0:
            time.sleep(0.05)
        assert eng.cache_size() == 0
    finally:
        d.close()
    assert not d._sweeper.is_alive()


def test_daemon_loader_integration(tmp_path):
    """tests/test_store.py:248 over HTTP: the daemon restores at start and
    persists at close; a store given to the daemon takes write-through."""
    path = os.fspath(tmp_path / "daemon.npz")
    clock = Clock().freeze_at(T0_NS)
    store = tstore.MemoryStore()
    d1 = _port_daemon(clock=clock, loader=NpzFileLoader(path), store=store)
    try:
        assert _http(d1.http_address, [dict(key="persist", hits=7)])[0]["remaining"] == "3"
    finally:
        d1.close()
    assert os.path.exists(path) and store.on_change_calls == 1
    d2 = _port_daemon(clock=clock, loader=NpzFileLoader(path))
    try:
        assert _http(d2.http_address, [dict(key="persist", hits=0)])[0]["remaining"] == "3"
        assert _http(d2.http_address, [dict(key="persist", hits=1)])[0]["remaining"] == "2"
    finally:
        d2.close()
    d3 = _port_daemon(clock=clock, loader=NpzFileLoader(path))
    try:
        assert _http(d3.http_address, [dict(key="persist", hits=0)])[0]["remaining"] == "2"
    finally:
        d3.close()
