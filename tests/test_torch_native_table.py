"""The port's native intern table (csrc/intern_table.cpp) against its
plain Python version and against the JAX package's native table.

Ports the cases of tests/test_native_table.py.  The three tables take the
same seeded key streams; slots, rounds, evicted slots with their clear
rounds, lengths and the hit / miss / eviction statistics must agree
exactly.  The two native tables share an allocation order, so their slot
numbers are compared directly; the Python table's are compared through
the key → slot mapping.
"""

from __future__ import annotations

import random

import numpy as np
import pytest

from gubernator_tpu.core import native as ref_native
from gubernator_tpu_torch.core.engine import PackedKeys
from gubernator_tpu_torch.core.interning import InternTable
from gubernator_tpu_torch.core.native import NativeInternTable, make_intern_table


def test_basic_ops():
    t = NativeInternTable(8)
    cleared: list = []
    s1 = t.intern("a", 0, cleared)
    s2 = t.intern("b", 0, cleared)
    assert s1 != s2
    assert t.intern("a", 0, cleared) == s1
    assert len(t) == 2
    assert t.contains("a") and not t.contains("zz")
    assert t.key_for_slot(s1) == "a"
    assert t.remove("a") == s1
    assert not t.contains("a")
    assert t.key_for_slot(s1) is None
    assert len(t) == 1
    assert cleared == []


def test_eviction_lru_order():
    t = NativeInternTable(3)
    cleared: list = []
    t.intern("a", 0, cleared)
    t.intern("b", 0, cleared)
    t.intern("c", 0, cleared)
    t.intern("a", 0, cleared)  # refresh a: LRU order is now b, c, a
    t.intern("d", 0, cleared)  # evicts b
    assert cleared == [t.remove("d")]  # d took b's slot
    assert not t.contains("b")
    assert t.contains("a") and t.contains("c")
    assert t.evictions == 1


def test_unexpired_eviction_metric():
    t = NativeInternTable(2)
    cleared: list = []
    s = t.intern("x", 100, cleared)
    t.set_expiry(np.asarray([s], dtype=np.int32), np.asarray([500], dtype=np.int64))
    t.intern("y", 100, cleared)
    t.intern("z", 100, cleared)  # evicts x (expire 500 > now 100)
    assert t.unexpired_evictions == 1


def test_schedule_rounds_and_packed_keys():
    t = NativeInternTable(16)
    keys = [b"k1", b"k2", b"k1", b"k3", b"k1", b"k2"]
    slots, rounds, evicted, _ = t.schedule(keys, 0)
    assert len(evicted) == 0
    assert slots[0] == slots[2] == slots[4]
    assert slots[1] == slots[5]
    assert list(rounds) == [0, 0, 1, 0, 2, 1]
    # Rounds restart each batch; PackedKeys schedules the same way.
    packed = PackedKeys.from_list([b"k1", b"k1"])
    assert packed.to_list() == [b"k1", b"k1"]
    slots2, rounds2, _, _ = t.schedule_packed(packed.buf, packed.offsets, 0)
    assert list(rounds2) == [0, 1]
    assert slots2[0] == slots[0]
    # An index subset schedules only those items.
    s3, r3, _, _ = t.schedule_packed(packed.buf, packed.offsets, 0, idx=np.array([1]))
    assert (list(s3), list(r3)) == ([slots[0]], [0])


def test_release_frees_the_slot():
    t = NativeInternTable(4)
    cleared: list = []
    s = t.intern("r1", 0, cleared)
    t.release_slots(np.asarray([s], dtype=np.int32))
    assert not t.contains("r1")
    assert len(t) == 0
    assert t.intern("r2", 0, cleared) == s


def test_make_intern_table_is_native_and_rejects_bad_capacity():
    assert isinstance(make_intern_table(4), NativeInternTable)
    with pytest.raises(ValueError):
        NativeInternTable(0)


def _python_schedule(py, batch, now):
    """The plain table driven as the engine drove it before the native
    table: per key, the clear of an evicted slot at the slot's current
    round."""
    slots, rounds, ev, ev_rounds = [], [], [], []
    seq: dict = {}
    for k in batch:
        cleared: list = []
        s = py.intern(k, now, cleared)
        for es in cleared:
            ev.append(es)
            ev_rounds.append(seq.get(es, 0))
        r = seq.get(s, 0)
        seq[s] = r + 1
        slots.append(s)
        rounds.append(r)
    return slots, rounds, ev, ev_rounds


@pytest.mark.parametrize("seed", [42, 7])
def test_fuzz_three_tables_agree_under_eviction_pressure(seed):
    """Random batches over 4× more keys than slots: the port's native
    table, the port's Python table and the JAX package's native table
    agree on every observable, batch after batch."""
    rng = random.Random(seed)
    cap = 50
    py = InternTable(cap)
    nat = NativeInternTable(cap)
    ref = ref_native.NativeInternTable(cap)
    keyspace = [f"key:{i}" for i in range(200)]
    for step in range(300):
        now = step * 10
        batch = [rng.choice(keyspace) for _ in range(rng.randint(1, 40))]
        enc = [k.encode() for k in batch]
        got = nat.schedule(enc, now)
        want = ref.schedule(enc, now)
        for g, w in zip(got, want):
            assert np.array_equal(g, w), f"step {step}"
        p_slots, p_rounds, p_ev, p_ev_rounds = _python_schedule(py, batch, now)
        assert list(got[1]) == p_rounds, f"step {step}"
        assert list(got[3]) == p_ev_rounds, f"step {step}"
        assert len(got[2]) == len(p_ev), f"step {step}"
        # Same key -> slot mapping within each table.
        assert len(set(zip(batch, got[0].tolist()))) == len(set(zip(batch, p_slots)))
        expires = np.full(len(batch), now + rng.choice([5, 50, 500]), np.int64)
        for t, s in ((nat, got[0]), (ref, want[0]), (py, np.asarray(p_slots))):
            t.set_expiry(s, expires)
        if rng.random() < 0.3:
            k = rng.choice(keyspace)
            removed = nat.remove(k)
            assert removed == ref.remove(k)
            assert (removed is None) == (py.remove(k) is None)
            assert not nat.contains(k) and not py.contains(k)
        for attr in ("hits", "misses", "evictions", "unexpired_evictions"):
            assert getattr(nat, attr) == getattr(ref, attr) == getattr(py, attr), (step, attr)
        assert len(nat) == len(ref) == len(py), f"step {step}"
    for s in range(cap):
        assert nat.key_for_slot(s) == ref.key_for_slot(s)
    live = np.array([s for s in range(cap) if nat.key_for_slot(s) is not None][:5], np.int32)
    keys = [nat.key_for_slot(int(s)) for s in live]
    nat.release_slots(live)
    ref.release_slots(live)
    py.release_slots(np.array([py._map[k] for k in keys], np.int32))
    assert len(nat) == len(ref) == len(py)
    assert not any(nat.contains(k) or py.contains(k) for k in keys)


def test_a_failed_build_raises_and_nothing_falls_back(monkeypatch, tmp_path):
    """With the compiler failing (and no library built yet), making the
    table — and so an engine — raises with the build's message; the
    engine never serves from the Python table instead."""
    from gubernator_tpu_torch.core.engine import DecisionEngine
    from gubernator_tpu_torch.ops import native_build

    monkeypatch.setattr(native_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native_build, "_libs", {})
    monkeypatch.setattr(native_build, "_compiler", lambda name: ("false",))
    with pytest.raises(RuntimeError, match="build failed for intern_table.cpp"):
        make_intern_table(8)
    with pytest.raises(RuntimeError, match="build failed"):
        DecisionEngine(8, device="cpu")
