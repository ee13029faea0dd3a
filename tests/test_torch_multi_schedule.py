"""The port's `multi_schedule` (csrc/intern_table.cpp git_multi_schedule,
core/native.py) against the JAX package's, on the CPU.

`multi_schedule` is the sharded engine's whole host tier in one native
call: shard routing (fnv1a-64 % n_shards), each table's interning, LRU,
eviction and rounds, the TTL mirror writes, and the dispatch order
grouped by shard and sorted by (slot, round) within each shard.  Held
bit-equal to the reference's call on the same keys, clocks and tables
(slots, rounds, order, counts, evictions, every table's statistics), and
ports of `tests/test_multi_schedule.py`: the native host tier against the
per-shard fallback loop (answers, occupancy, statistics), the hot-key
collapse, threaded against serial, and the TTL mirror.  The port's
engines run with n_shards = 8, the size of the reference's virtual CPU
mesh (tests/conftest.py).

Tolerance: exact.
"""

from __future__ import annotations

import random

import numpy as np
import pytest

from gubernator_tpu.clock import Clock as RefClock
from gubernator_tpu.core.engine import PackedKeys as RefPackedKeys
from gubernator_tpu.core.native import NativeInternTable as RefTable
from gubernator_tpu.core.native import multi_schedule as ref_multi_schedule
from gubernator_tpu.parallel.sharded_engine import ShardedDecisionEngine as RefSharded
from gubernator_tpu.types import RateLimitReq as RefReq
from gubernator_tpu_torch.clock import Clock
from gubernator_tpu_torch.core import native as tnative
from gubernator_tpu_torch.core.engine import PackedKeys
from gubernator_tpu_torch.core.native import NativeInternTable, multi_schedule
from gubernator_tpu_torch.hashing import fnv1a_64_batch, pack_keys
from gubernator_tpu_torch.parallel.sharded_engine import ShardedDecisionEngine
from gubernator_tpu_torch.types import Algorithm, Behavior, RateLimitReq
from test_torch_sharded import assert_same_state

N_SHARDS = 8
T0_NS = 1_760_000_000_123 * 1_000_000


def _columns(reqs):
    return (
        [r.hash_key().encode() for r in reqs],
        np.asarray([int(r.algorithm) for r in reqs], dtype=np.int32),
        np.asarray([int(r.behavior) for r in reqs], dtype=np.int32),
        np.asarray([r.hits for r in reqs], dtype=np.int64),
        np.asarray([r.limit for r in reqs], dtype=np.int64),
        np.asarray([r.duration for r in reqs], dtype=np.int64),
        np.asarray([r.burst for r in reqs], dtype=np.int64),
    )


def _fuzz_reqs(rng, n_keys, n_items, greg=False):
    """The reference test's stream (tests/test_multi_schedule.py:37)."""
    reqs = []
    for _ in range(n_items):
        i = rng.randint(0, n_keys - 1)
        behavior = Behavior.BATCHING
        duration = 60_000
        if greg and i % 7 == 0:
            behavior |= Behavior.DURATION_IS_GREGORIAN
            duration = 1  # GregorianMinutes
        reqs.append(RateLimitReq(
            name=f"{i}ms", unique_key=f"{i}x", hits=rng.randint(0, 3), limit=10,
            duration=duration, algorithm=rng.choice([Algorithm.TOKEN_BUCKET,
                                                     Algorithm.LEAKY_BUCKET]),
            behavior=behavior, burst=10,
        ))
    return reqs


def _stats(t):
    return (t.hits, t.misses, t.evictions, t.unexpired_evictions, len(t))


@pytest.mark.parametrize("threads", [1, 4])
@pytest.mark.parametrize("shard_capacity,n_keys", [(128, 60), (8, 200)])
@pytest.mark.parametrize("hashes", [False, True])
def test_multi_schedule_equals_the_reference(shard_capacity, n_keys, threads, hashes):
    """Same keys, clock and TTLs through both packages' calls, batch after
    batch: every output array and every table's statistics equal."""
    rng = random.Random(shard_capacity + n_keys + threads)
    ref_tables = [RefTable(shard_capacity) for _ in range(N_SHARDS)]
    tables = [NativeInternTable(shard_capacity) for _ in range(N_SHARDS)]
    now = 1_760_000_000_000
    evictions = 0
    for step in range(10):
        keys = [r.hash_key().encode() for r in _fuzz_reqs(rng, n_keys, rng.randint(1, 96))]
        packed = PackedKeys.from_list(keys)
        ref_packed = RefPackedKeys.from_list(keys)
        h = fnv1a_64_batch(*pack_keys(keys)) if hashes else None
        exp = np.asarray([now + rng.choice([-5, 1000, 60_000]) for _ in keys], dtype=np.int64)
        want = ref_multi_schedule(ref_tables, ref_packed.buf, ref_packed.offsets, h, now, exp,
                                  threads=threads)
        got = multi_schedule(tables, packed.buf, packed.offsets, h, now, exp, threads=threads)
        assert got[0] == want[0], step
        for label, a, b in zip(("shard", "slots", "rounds", "order", "counts", "evicted",
                                "evict_shard", "evict_rounds"), got[1:], want[1:]):
            np.testing.assert_array_equal(a, b, err_msg=f"step {step} {label}")
        assert [_stats(t) for t in tables] == [_stats(t) for t in ref_tables], step
        evictions += len(got[6])
        now += rng.choice([0, 500, 70_000])
    assert (evictions > 0) == (shard_capacity * N_SHARDS < n_keys)


def test_route_hashes_are_the_tables_hash():
    """Hashes given by the caller (the wire decode's fnv1a) and the ones
    the call computes route and schedule alike."""
    keys = [f"{i}k_{i * 7}".encode() for i in range(300)]
    packed = PackedKeys.from_list(keys)
    a = multi_schedule([NativeInternTable(64) for _ in range(N_SHARDS)], packed.buf,
                       packed.offsets, None, 5, None)
    b = multi_schedule([NativeInternTable(64) for _ in range(N_SHARDS)], packed.buf,
                       packed.offsets, fnv1a_64_batch(*pack_keys(keys)), 5, None)
    for x, y in zip(a[1:], b[1:]):
        np.testing.assert_array_equal(x, y)
    assert len(set(a[1].tolist())) == N_SHARDS


def test_discounted_statistics_as_the_reference():
    """`discount_stats` (reference core/native.py:190) leaves traffic out
    of the mirrored counters from then on, through `schedule` and
    `multi_schedule` alike."""
    keys = [f"d{i % 40}".encode() for i in range(100)]
    packed = PackedKeys.from_list(keys)
    ref_tables = [RefTable(4) for _ in range(N_SHARDS)]
    tables = [NativeInternTable(4) for _ in range(N_SHARDS)]
    for ts, call in ((ref_tables, ref_multi_schedule), (tables, multi_schedule)):
        call(ts, packed.buf, packed.offsets, None, 1, None)
        for t in ts:
            t.discount_stats(t.hits, t.misses, 1, 0)
        call(ts, packed.buf, packed.offsets, None, 2, None)
        ts[0].schedule([b"solo"], 3)
    assert [_stats(t) for t in tables] == [_stats(t) for t in ref_tables]
    assert [t._stat_off for t in tables] == [t._stat_off for t in ref_tables]


def test_default_threads_read_once(monkeypatch):
    monkeypatch.setattr(tnative, "_DEFAULT_THREADS", None)
    monkeypatch.setenv("GUBER_MULTI_THREADS", "3")
    assert tnative._default_threads() == 3
    monkeypatch.setenv("GUBER_MULTI_THREADS", "5")
    assert tnative._default_threads() == 3
    monkeypatch.setattr(tnative, "_DEFAULT_THREADS", None)
    monkeypatch.delenv("GUBER_MULTI_THREADS")
    assert tnative._default_threads() == 0


def _engines(shard_capacity):
    clock = Clock().freeze_at(T0_NS)
    native = ShardedDecisionEngine(shard_capacity, n_shards=N_SHARDS, clock=clock, device="cpu")
    fallback = ShardedDecisionEngine(shard_capacity, n_shards=N_SHARDS, clock=clock,
                                     device="cpu")
    fallback._multi_ok = False  # the per-shard loop
    assert native._multi_ok
    ref_clock = RefClock().freeze_at(T0_NS)
    ref = RefSharded(shard_capacity=shard_capacity, clock=ref_clock, single_program=True)
    return clock, native, fallback, ref_clock, ref


@pytest.mark.parametrize("shard_capacity,n_keys", [(128, 60), (8, 200)])
def test_multi_schedule_matches_fallback(shard_capacity, n_keys):
    """tests/test_multi_schedule.py:72: the one-call host tier and the
    per-shard loop answer alike and leave equal tables, and both equal
    the reference's single-program engine, state words included."""
    clock, native, fallback, ref_clock, ref = _engines(shard_capacity)
    rng = random.Random(5)
    for step in range(8):
        reqs = _fuzz_reqs(rng, n_keys, rng.randint(1, 80), greg=True)
        cols = _columns(reqs)
        a = native.apply_columnar(*cols)
        b = fallback.apply_columnar(*cols)
        want = ref.apply_columnar(*cols)
        for col_a, col_b, col_w, label in zip(a, b, want, "slrr"):
            np.testing.assert_array_equal(col_a, col_b, err_msg=f"step {step} {label}")
            np.testing.assert_array_equal(col_a, np.asarray(col_w),
                                          err_msg=f"step {step} {label}")
        for sh, (ta, tb, tr) in enumerate(zip(native.tables, fallback.tables, ref.tables)):
            assert _stats(ta) == _stats(tb) == _stats(tr), f"step {step} shard {sh}"
        step_ms = rng.randint(0, 3_000)
        clock.advance(ms=step_ms)
        ref_clock.advance(ms=step_ms)
    assert_same_state(native, ref)
    assert_same_state(fallback, ref)


def test_multi_schedule_hot_key_collapse():
    """tests/test_multi_schedule.py:118: an all-duplicate batch collapses
    to one launch and agrees with the fallback and the reference."""
    _clock, native, fallback, _ref_clock, ref = _engines(64)
    reqs = [RateLimitReq(name="hot", unique_key="key", hits=1, limit=1000, duration=60_000,
                         burst=1000)] * 50
    cols = _columns(reqs)
    rounds_before = native.rounds_total
    a = native.apply_columnar(*cols)
    assert native.rounds_total == rounds_before + 1
    b = fallback.apply_columnar(*cols)
    want = ref.apply_columnar(*cols)
    for x, y, z in zip(a, b, want):
        np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(x, np.asarray(z))
    assert int(a[2][-1]) == 1000 - 50
    assert native.rounds_total == ref.rounds_total


def test_multi_schedule_threaded_matches_serial():
    """tests/test_multi_schedule.py:145: the per-shard threads give the
    serial call's results bit for bit."""
    rng = random.Random(9)
    ta = [NativeInternTable(16) for _ in range(N_SHARDS)]
    tb = [NativeInternTable(16) for _ in range(N_SHARDS)]
    now = 1_760_000_000_000
    for step in range(6):
        keys = [r.hash_key().encode() for r in _fuzz_reqs(rng, 120, rng.randint(1, 96))]
        packed = PackedKeys.from_list(keys)
        exp = np.full(len(keys), now + 60_000, dtype=np.int64)
        a = multi_schedule(ta, packed.buf, packed.offsets, None, now, exp, threads=1)
        b = multi_schedule(tb, packed.buf, packed.offsets, None, now, exp, threads=4)
        assert a[0] == b[0], f"step {step} max_round"
        for ai, bi, label in zip(a[1:6], b[1:6], ("shard", "slots", "rounds", "order", "counts")):
            np.testing.assert_array_equal(ai, bi, err_msg=f"step {step} {label}")
        # Evictions: the same set a shard (their order across shards is free).
        assert sorted(zip(a[7].tolist(), a[6].tolist(), a[8].tolist())) == sorted(
            zip(b[7].tolist(), b[6].tolist(), b[8].tolist())), step
        now += 500


def test_multi_schedule_ttl_mirror():
    """tests/test_multi_schedule.py:188: the call's TTL writes make later
    evictions of lapsed keys count as expired, as the reference's do."""
    clock = Clock().freeze_at(T0_NS)
    ref_clock = RefClock().freeze_at(T0_NS)
    eng = ShardedDecisionEngine(4, n_shards=N_SHARDS, clock=clock, device="cpu")
    ref = RefSharded(shard_capacity=4, clock=ref_clock, single_program=True)
    cols = _columns(_fuzz_reqs(random.Random(7), 64, 60))
    eng.apply_columnar(*cols)
    ref.apply_columnar(*cols)
    base_unexpired = [t.unexpired_evictions for t in eng.tables]
    clock.advance(ms=10 * 60_000)
    ref_clock.advance(ms=10 * 60_000)
    reqs2 = [RateLimitReq(name=f"{i}fresh", unique_key=f"{i}y", hits=1, limit=10,
                          duration=60_000) for i in range(64)]
    got = eng.apply_columnar(*_columns(reqs2))
    want = ref.apply_columnar(*_columns([RefReq(name=r.name, unique_key=r.unique_key, hits=1,
                                                limit=10, duration=60_000) for r in reqs2]))
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x, np.asarray(y))
    assert [t.unexpired_evictions for t in eng.tables] == base_unexpired
    assert [_stats(t) for t in eng.tables] == [_stats(t) for t in ref.tables]
    assert sum(t.evictions for t in eng.tables) > 0
