"""A round's eviction clears then its restores (kernels K2 and K5,
csrc/clear_occupied.cu and csrc/load_slots.cu, each a launch of its own)
against the JAX package's eviction clear then restore, on the CPU.

* `clear_occupied` then `load_slots` (on CPU tensors, their plain
  versions) against JAX `clear_occupied` then `_load_slots_impl` on seeded
  state and records: half of the clears on slots the record restores (a
  slot cleared and restored in one round), every clear restored, clears
  with no record, a record with no clear, extreme record values.
* The dense engine's store path under eviction pressure against the JAX
  engine with the same store (the stream of tests/test_store.py and
  tests/test_torch_persist.py's later-round fuzz): answers, every slot's
  words and the store bit-equal, a K5 launch where the reference
  dispatches its K5 and a K2 before it when the round has clears.
* `load` of more items than slots (evictions in the loaded stream): the
  reference's dispatches, the state as the reference's.
* The sharded engine's restore rounds (4 shards of 2 slots, keys back
  from the store in rounds after the first): one K5 and at most one K2 a
  restoring round, answers, words, tables and store as the reference's.

The two kinds of launch merged into one, and K5 as K2's programmatic
dependent, were tried on the card and not kept (scripts/torch_k2_restore.py).

Tolerance: exact, bit for bit.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_multi_round import _jax_state, _rand_logical
from test_torch_persist import (
    T0_NS,
    _Trace,
    _assert_identical,
    _assert_same_store,
    _both,
    _pair,
    random_record,
)
from test_torch_sharded import _both as _both_sharded
from test_torch_sharded import _pair as _sharded_pair
from test_torch_sharded import assert_same_state, assert_same_tables

import gubernator_tpu.ops.bucket_kernel as jbk
from gubernator_tpu.clock import Clock as RefClock
from gubernator_tpu.core.engine import DecisionEngine as RefEngine
from gubernator_tpu_torch import store as tstore
from gubernator_tpu_torch.clock import Clock
from gubernator_tpu_torch.core import engine as engine_mod
from gubernator_tpu_torch.core.engine import DecisionEngine
from gubernator_tpu_torch.ops import bucket_kernel as tk
from gubernator_tpu_torch.ops import fused_step as fs
from gubernator_tpu_torch.parallel import sharded_engine as sharded_mod
from gubernator_tpu_torch.types import RateLimitReq

NOW = 1_760_000_000_000


def _jax_clear_restore(words, clears, rec):
    """The reference's order: `clear_occupied` (clears padded with
    out-of-range slots), then `_load_slots_impl`."""
    cap = len(words["meta"])
    js = _jax_state(words)
    if len(clears):
        c = np.arange(cap, cap + tk.pad_size(len(clears), floor=16), dtype=np.int64)
        c[: len(clears)] = clears
        js = js._replace(meta=jbk.clear_occupied(js.meta, jnp.asarray(c.astype(np.int32))))
    if rec is not None:
        js = jbk._load_slots_impl(js, jbk.SlotRecord(**{k: jnp.asarray(a)
                                                        for k, a in rec.items()}))
    return js


def _port_clear_restore(words, clears, rec):
    """The port's order: `clear_occupied` over the clears padded as the
    engine pads them, then `load_slots`."""
    state = tk.state_from_numpy(words, "cpu")
    cap = len(words["meta"])
    if len(clears):
        c = np.arange(cap, cap + tk.pad_size(len(clears), floor=16), dtype=np.int64)
        c[: len(clears)] = clears
        fs.clear_occupied(state.meta, torch.from_numpy(c.astype(np.int32)))
    if rec is not None:
        fs.load_slots(state, torch.from_numpy(tk.pack_restore_host(rec)))
    return state


@pytest.mark.parametrize("case", ["overlap", "all_restored", "no_record", "no_clear",
                                  "extreme", "wide"])
def test_clear_restore_matches_jax_clear_then_restore(case):
    rng = np.random.default_rng(["overlap", "all_restored", "no_record", "no_clear",
                                 "extreme", "wide"].index(case))
    cap = 16384
    words = tk.pack_state_host(_rand_logical(rng, cap, NOW))
    n, size = {"wide": (3000, 4096), "extreme": (16, 16)}.get(case, (40, 64))
    rec = None if case == "no_record" else random_record(rng, cap, n, size, NOW,
                                                         extreme=case == "extreme")
    restored = np.zeros(0, np.int64) if rec is None else rec["slot"][:n].astype(np.int64)
    others = np.setdiff1d(rng.choice(cap, 3 * n, replace=False), restored)[:n]
    if case == "no_clear":
        clears = np.zeros(0, np.int64)
    elif case == "all_restored":
        clears = restored.copy()
    elif case == "no_record":
        clears = others
    else:  # half of the clears are slots the record restores
        clears = np.concatenate([rng.choice(restored, n // 2, replace=False), others[: n // 2]])
    rng.shuffle(clears)
    want = _jax_clear_restore(words, clears, rec)
    out = tk.state_to_numpy(_port_clear_restore(words, clears, rec))
    for f in tk.BucketState._fields:
        assert np.array_equal(out[f], np.asarray(getattr(want, f))), f


def test_clear_occupied_and_load_slots_check_their_arguments():
    state = tk.make_state(64, "cpu")
    with pytest.raises(ValueError):
        fs.load_slots(state, torch.zeros((tk.RESTORE_ROWS, 0), dtype=torch.int32))
    with pytest.raises(ValueError):
        fs.load_slots(state, torch.zeros((18, 4), dtype=torch.int32))
    with pytest.raises(ValueError):
        fs.clear_occupied(state.meta, torch.zeros(3, dtype=torch.int32, device="meta"))
    state.meta[5] = 3
    fs.reset_launches()
    fs.clear_occupied(state.meta, torch.tensor([5, 64, 70], dtype=torch.int32))
    assert int(state.meta[5]) == 2
    # The plain versions launch no kernel.
    assert fs.launches["clear_occupied"] == fs.launches["load_slots"] == 0


class _Launches:
    """Counts, on a port engine, the restoring rounds (calls of its
    restore method) and the K2 and K5 wrapper calls."""

    def __init__(self, monkeypatch, eng, module):
        self.k2 = self.k5 = self.restores = 0
        real_k2, real_k5 = module.clear_occupied, module.load_slots
        name = "_apply_restores" if hasattr(eng, "_apply_restores") else "_apply_shard_restores"
        real_restores = getattr(eng, name)

        def counted(real, kind):
            def call(*a):
                setattr(self, kind, getattr(self, kind) + 1)
                return real(*a)
            return call

        def restores(r):
            self.restores += 1
            real_restores(r)

        monkeypatch.setattr(module, "clear_occupied", counted(real_k2, "k2"))
        monkeypatch.setattr(module, "load_slots", counted(real_k5, "k5"))
        setattr(eng, name, restores)


def test_store_path_under_eviction_k2_then_k5_as_the_reference(monkeypatch):
    """8 slots for 24 keys and a store: keys are evicted and come back
    from the store in later rounds of a batch, onto the slot their round
    clears.  The port launches K5 where the reference dispatches its K5,
    and K2 before it when the round has clears."""
    rng = np.random.default_rng(2031)
    ref, port = _pair(8, store=True)
    trace = _Trace(port)  # patches the clear and restore methods: install first
    counts = _Launches(monkeypatch, port, engine_mod)
    ref_k2k5 = {"clears": 0, "restores": 0}
    real_clears, real_restores = ref._apply_clears, ref._apply_restores

    def ref_clears(c):
        ref_k2k5["clears"] += 1
        real_clears(c)

    def ref_restores(r):
        ref_k2k5["restores"] += 1
        real_restores(r)

    ref._apply_clears, ref._apply_restores = ref_clears, ref_restores
    keys = [f"c{i}" for i in range(24)]
    for b in range(40):
        specs = [dict(key=keys[int(rng.integers(len(keys)))] if rng.random() < 0.6 else
                      keys[int(rng.integers(6))], hits=int(rng.choice([0, 1, 1, 2, 5])),
                      algorithm=int(rng.integers(0, 2)), burst=int(rng.choice([0, 6])),
                      limit=int(rng.choice([5, 20])), duration=int(rng.choice([400, 60_000])),
                      behavior=8 if rng.random() < 0.05 else 0)
                 for _ in range(int(rng.integers(4, 20)))]
        _both(ref, port, specs)
        dt = int(rng.choice([0, 50, 300]))
        for e in (ref, port):
            e.clock.advance(ms=dt)
        if b % 10 == 9:
            _assert_identical(ref, port)
            _assert_same_store(ref, port)
    assert trace.clear_restore_after_submit() > 0  # a slot cleared and restored in one round
    assert counts.restores == ref_k2k5["restores"] == counts.k5 > 0
    # A K2 before the K5 of each restoring round with clears; the reference
    # also dispatches its K2 there.
    assert 0 < counts.k2 <= min(counts.restores, ref_k2k5["clears"])
    _assert_identical(ref, port)
    _assert_same_store(ref, port)


def test_load_with_evictions_matches_jax():
    """`load` of 300 items into 64 slots: each evicting item's clear and
    each flushed batch's items make the reference's dispatches; the state
    as the reference's load."""
    from gubernator_tpu.store import CacheItem as RefItem
    from gubernator_tpu.store import TokenBucketItem as RefToken

    def items(item_cls, token_cls):
        return [item_cls(key=f"ld{i}", value=token_cls(status=0, limit=10 + i, duration=60_000,
                                                       remaining=i % 7, created_at=NOW - i),
                         expire_at=NOW + 60_000 + i, algorithm=0) for i in range(300)]

    class _Loader:
        def __init__(self, its):
            self.its = its

        def load(self):
            return iter(self.its)

    ref = RefEngine(capacity=64, clock=RefClock().freeze_at(T0_NS))
    port = DecisionEngine(64, clock=Clock().freeze_at(T0_NS), device="cpu")
    d0, r0 = port.dispatches_total, ref.dispatches_total
    assert port.load(_Loader(items(tstore.CacheItem, tstore.TokenBucketItem))) == ref.load(
        _Loader(items(RefItem, RefToken))) == 300
    assert port.table.evictions == ref.table.evictions > 0
    assert port.dispatches_total - d0 == ref.dispatches_total - r0 > 0
    _assert_identical(ref, port)


def test_sharded_restore_rounds_match_jax(monkeypatch):
    """4 shards of 2 slots and 40 keys: evicted keys come back from the
    store in rounds after the first; each such round launches one K5 over
    the flat columns (and one K2 before it when it has clears)."""
    port, ref = _sharded_pair(2, store=True, n_shards=4)
    counts = _Launches(monkeypatch, port, sharded_mod)
    rng = np.random.default_rng(2032)
    keys = [f"sr{i}" for i in range(40)]
    for b in range(30):
        pool = keys[: int(rng.integers(6, 40))]
        reqs = [RateLimitReq(name="cr", unique_key=pool[int(rng.integers(len(pool)))],
                             hits=int(rng.choice([0, 1, 1, 2])), algorithm=int(rng.integers(0, 2)),
                             limit=int(rng.choice([5, 20])), burst=int(rng.choice([0, 6])),
                             duration=int(rng.choice([400, 60_000])))
                for _ in range(int(rng.integers(4, 30)))]
        _both_sharded(port, ref, reqs)
        dt = int(rng.choice([0, 50, 300]))
        for e in (port, ref):
            e.clock.advance(ms=dt)
    assert counts.restores == counts.k5 > 0
    assert 0 < counts.k2 <= counts.restores
    assert_same_state(port, ref)
    assert_same_tables(port, ref)
    assert {k: dataclasses.asdict(v) for k, v in port.store.data.items()} == {
        k: dataclasses.asdict(v) for k, v in ref.store.data.items()}
