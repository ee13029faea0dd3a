"""Paged bucket state (GUBER_PAGED; gubernator_tpu_torch/core/paging.py) on
the CPU, against the JAX package's paged engine.

* The plain page kernels: `gather_page_words_reference` /
  `load_page_words_reference` (the CPU versions of K9 / K10) against JAX
  `gather_page_words` / `load_page_words` on seeded state with extreme
  words.
* Ports of tests/test_paged_state.py :90 (the dense / paged / spec fuzz,
  each seed), :136 (the spill and refill round trip at the TTL
  boundary), :182 (the dataclass path), :214 (segmentation), :248
  (page-aware restore and export), :298 (the host sweep), :318
  (resident-only traffic never faults), :334 (the knob defaults) and
  :358 (the counters; the port has no /metrics).  Every case runs the
  same calls through the port's paged engine and the reference's (pump
  off, the reference in its XLA or interpret mode) and holds, after every
  batch, the answers, the fault / spill / refill counters, the page table
  (`frame_of`, `page_of`, the clock's `_ref` and `_hand`, `_ever_used`),
  `host_words` and the device words equal.
* The paged three-way of tests/test_fused_parity.py:298: the port's
  ledger over the port's paged engine, the reference's ledger over the
  reference's paged Pallas engine (interpret mode) and the spec.
* Batched faults: batches that fault many pages at once (one K9 and one
  K10 in the port, a page at a time in the reference) leave the same
  page table and host store after each batch.
* The write-through store, `load` / `save` through `NpzFileLoader`, the
  sweep, and the daemon with its loader and sweep thread, paged.
* The default service: a `V1Instance` over a paged engine with the
  hot-key sketch on (the default) and a frozen sketch clock on each side
  evicts the reference `V1Instance`'s victims.

Tolerance: exact for every answer field, state word, host word, counter
and page-table entry.
"""

from __future__ import annotations

import dataclasses
import os
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_paged_state import _SpecOracle

import gubernator_tpu.ops.bucket_kernel as jbk
from gubernator_tpu import store as jstore
from gubernator_tpu.checkpoint import NpzFileLoader as RefNpzFileLoader
from gubernator_tpu.clock import Clock as RefClock
from gubernator_tpu.config import BehaviorConfig, Config
from gubernator_tpu.config import env_page_size as ref_env_page_size
from gubernator_tpu.config import env_paged_resident as ref_env_paged_resident
from gubernator_tpu.core.engine import DecisionEngine as RefEngine
from gubernator_tpu.service import V1Instance as RefInstance
from gubernator_tpu.types import RateLimitReq as RefReq
from gubernator_tpu.utils import hotkeys as ref_hotkeys
from gubernator_tpu_torch import store as tstore
from gubernator_tpu_torch.checkpoint import NpzFileLoader
from gubernator_tpu_torch.clock import Clock
from gubernator_tpu_torch.config import DaemonConfig, env_page_size, env_paged, env_paged_resident
from gubernator_tpu_torch.core.engine import DecisionEngine
from gubernator_tpu_torch.core.paging import PagePlane
from gubernator_tpu_torch.ops import bucket_kernel as tk
from gubernator_tpu_torch.service import V1Instance
from gubernator_tpu_torch.types import RateLimitReq
from gubernator_tpu_torch.utils import hotkeys

T0_NS = 1_760_000_000_123 * 1_000_000
_TABLE = ("frame_of", "page_of", "_ref", "_ever_used")


def _paged_env(monkeypatch, page_size=16, resident=4, fused="xla"):
    monkeypatch.setenv("GUBER_FUSED", fused)
    monkeypatch.setenv("GUBER_PUMP", "0")
    monkeypatch.setenv("GUBER_PAGED", "1")
    monkeypatch.setenv("GUBER_PAGE_SIZE", str(page_size))
    monkeypatch.setenv("GUBER_PAGED_RESIDENT", str(resident))


def _cols(rows):
    return (
        [r[0] for r in rows],
        np.asarray([r[1] for r in rows], np.int32),
        np.asarray([r[2] for r in rows], np.int32),
        np.asarray([r[3] for r in rows], np.int64),
        np.asarray([r[4] for r in rows], np.int64),
        np.asarray([r[5] for r in rows], np.int64),
        np.asarray([r[6] for r in rows], np.int64),
    )


def _answers(res):
    st, lim, rem, rst = res
    return [(int(st[i]), int(lim[i]), int(rem[i]), int(rst[i])) for i in range(len(st))]


def assert_same_paging(ref, port):
    """Counters, page table, host store and device words of two paged
    engines, word for word."""
    rp, pp = ref.paging, port.paging
    assert (pp.faults, pp.spills, pp.refills) == (rp.faults, rp.spills, rp.refills)
    for name in _TABLE:
        assert np.array_equal(getattr(pp, name), getattr(rp, name)), name
    assert pp._hand == rp._hand
    assert np.array_equal(pp.host_words, rp.host_words)
    ref._flush_pump()
    words = tk.state_to_numpy(port.state)
    for f in tk.BucketState._fields:
        assert np.array_equal(words[f], np.asarray(getattr(ref._state, f))), f


class Paged:
    """The reference's paged engine and the port's, built under the same
    paging knobs on frozen clocks at T0: `columnar` / `dataclass` run one
    batch through both and hold everything equal."""

    def __init__(self, monkeypatch, capacity, page_size=16, resident=4, fused="xla",
                 store=False):
        _paged_env(monkeypatch, page_size, resident, fused)
        self.ref = RefEngine(capacity=capacity, clock=RefClock().freeze_at(T0_NS),
                             store=jstore.MemoryStore() if store else None)
        self.port = DecisionEngine(capacity, clock=Clock().freeze_at(T0_NS), device="cpu",
                                   store=tstore.MemoryStore() if store else None)
        assert self.port.paging is not None and self.ref.paging is not None
        assert (self.port.capacity, self.port.logical_capacity) == (
            self.ref.capacity, self.ref.logical_capacity)

    def advance(self, ms):
        self.ref.clock.advance(ms=ms)
        self.port.clock.advance(ms=ms)

    def now(self):
        return self.port.clock.now_ms()

    def columnar(self, rows):
        now = self.now()
        want = _answers(self.ref.apply_columnar(*_cols(rows), now_ms=now))
        got = _answers(self.port.apply_columnar(*_cols(rows), now_ms=now))
        assert got == want
        assert_same_paging(self.ref, self.port)
        return got

    def dataclass(self, reqs):
        want = self.ref.get_rate_limits([RefReq(**vars(r)) for r in reqs])
        got = self.port.get_rate_limits(reqs)
        for g, w in zip(got, want):
            assert (g.error, int(g.status), g.limit, g.remaining, g.reset_time) == (
                w.error, int(w.status), w.limit, w.remaining, w.reset_time)
        assert_same_paging(self.ref, self.port)
        return got


# ---------------------------------------------------------------------------
# The plain page kernels.


def _extreme_words(rng, cap):
    """Seeded state words, every bit pattern likely: bit 31 set in the
    `*_lo` columns, negative hi words, all meta bits."""
    return {f: rng.integers(-(2**31), 2**31, cap, dtype=np.int64).astype(np.int32)
            for f in tk.BucketState._fields}


def _jax_state(words):
    cols = {}
    for f in jbk.BucketState._fields:
        w = words[f]
        cols[f] = jnp.asarray(w.view(np.uint32) if f in tk.UNSIGNED_FIELDS else w)
    return jbk.BucketState(**cols)


@pytest.mark.parametrize("page_size,k", [(16, 1), (16, 5), (64, 3), (512, 2)])
def test_plain_page_words_match_jax(page_size, k):
    rng = np.random.default_rng(page_size + k)
    frames = 8
    cap = frames * page_size
    words = _extreme_words(rng, cap)
    starts = np.sort(rng.choice(frames, k, replace=False)).astype(np.int64) * page_size
    starts[0] = 0
    if k > 1:
        starts[-1] = cap - page_size
    state = tk.state_from_numpy(words, "cpu")
    got = tk.gather_page_words_reference(state, torch.from_numpy(starts.astype(np.int32)),
                                         page_size)
    js = _jax_state(words)
    want = np.stack([np.asarray(jbk.gather_page_words(js, np.int32(s), page_size))
                     for s in starts])
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    assert (got.numpy()[:, [2, 3, 4, 5, 7, 9, 11]] < 0).any()  # bit 31 of *_lo words

    # Refill fresh blocks into the same pages: JAX one page at a time.
    blocks = rng.integers(-(2**31), 2**31, (k, 12, page_size), dtype=np.int64).astype(np.int32)
    tk.load_page_words_reference(state, torch.from_numpy(starts.astype(np.int32)),
                                 torch.from_numpy(blocks))
    for s, b in zip(starts, blocks):
        js = jbk.load_page_words(js, np.int32(s), jnp.asarray(b))
    out = tk.state_to_numpy(state)
    for f in tk.BucketState._fields:
        assert np.array_equal(out[f], np.asarray(getattr(js, f))), f


def test_plain_page_words_clamp_like_the_dynamic_slice():
    """A start past the end or below 0 reads the page `lax.dynamic_slice`
    takes: a negative start counts from the end, then clamps."""
    rng = np.random.default_rng(9)
    words = _extreme_words(rng, 64)
    state = tk.state_from_numpy(words, "cpu")
    js = _jax_state(words)
    for s in (-5, -20, -64, -100, 50, 63):
        got = tk.gather_page_words_reference(state, torch.tensor([s], dtype=torch.int32), 16)
        assert np.array_equal(got[0].numpy(),
                              np.asarray(jbk.gather_page_words(js, np.int32(s), 16)))


# ---------------------------------------------------------------------------
# Ports of tests/test_paged_state.py.


@pytest.mark.parametrize("seed", [5, 23])
def test_dense_vs_paged_vs_spec_fuzz(seed, monkeypatch):
    """:90 — token and leaky fuzz over a key space ~6x the resident rows:
    port paged == reference paged == port dense == spec, and the paged
    arms really page."""
    rng = np.random.default_rng(seed)
    pair = Paged(monkeypatch, 1024)
    assert pair.port.capacity == 64 and pair.port.logical_capacity == 1024
    monkeypatch.delenv("GUBER_PAGED")
    dense = DecisionEngine(1024, clock=pair.port.clock, device="cpu")
    assert dense.paging is None and dense.capacity == 1024
    oracle = _SpecOracle()
    keys = [b"pz_%d" % i for i in range(380)]
    for _step in range(50):
        pair.advance(int(rng.integers(0, 120)))
        rows = []
        for _ in range(int(rng.integers(1, 24))):
            key = keys[int(rng.integers(0, len(keys)))]
            rows.append((key, int(key[-1] % 2), 0, int(rng.choice([-1, 0, 1, 1, 2, 5])),
                         int(rng.choice([1, 3, 10, 50])), int(rng.choice([40, 200, 1000])),
                         int(rng.choice([0, 0, 5]))))
        got = pair.columnar(rows)
        assert got == _answers(dense.apply_columnar(*_cols(rows), now_ms=pair.now()))
        assert got == oracle.apply(rows, pair.now())
    pp = pair.port.paging
    assert pp.faults > 0 and pp.spills > 0 and pp.refills == pp.faults
    assert pp.fault_batches <= pp.faults


def test_spill_refill_roundtrip_exact_ttl_boundary(monkeypatch):
    """:136 — evict → spill → refill keeps a bucket bit-exact across the
    round trip: a re-hit at expire_at (still served) and at expire_at + 1
    (a fresh bucket), the leaky 32.32 words included."""
    pair = Paged(monkeypatch, 512, page_size=16, resident=2)
    oracle = _SpecOracle()
    tok = [(b"tok", 0, 0, 3, 10, 5_000, 0)]
    lky = [(b"lky", 1, 0, 3, 7, 700, 0)]
    assert pair.columnar(tok) == oracle.apply(tok, pair.now())
    pair.advance(33)
    assert pair.columnar(lky) == oracle.apply(lky, pair.now())
    before = pair.port.paging.spills
    for i in range(60):
        rows = [(b"cold_%d" % i, 0, 0, 1, 5, 60_000, 0)]
        assert pair.columnar(rows) == oracle.apply(rows, pair.now())
    assert pair.port.paging.spills > before
    assert not pair.port.paging.resident_mask([0])[0]
    pair.advance(44)
    lrows = [(b"lky", 1, 0, 1, 7, 700, 0)]
    assert pair.columnar(lrows) == oracle.apply(lrows, pair.now())
    exp = oracle.states[b"tok"].expire_at
    pair.advance(exp - pair.now())
    trows = [(b"tok", 0, 0, 1, 10, 5_000, 0)]
    assert pair.columnar(trows) == oracle.apply(trows, pair.now())
    pair.advance(1)
    assert pair.columnar(trows) == oracle.apply(trows, pair.now())


def test_dataclass_path_pages_and_matches_dense(monkeypatch):
    """:182 — get_rate_limits through the paged engines answers as a dense
    engine over a key space well past the resident rows."""
    pair = Paged(monkeypatch, 1024)
    monkeypatch.delenv("GUBER_PAGED")
    dense = DecisionEngine(1024, clock=pair.port.clock, device="cpu")

    def reqs(lo, hi):
        return [RateLimitReq(name="dp", unique_key=str(i), hits=1, limit=4, duration=30_000)
                for i in range(lo, hi)]

    for _round in range(3):
        for lo in range(0, 300, 50):
            pair.advance(7)
            got = pair.dataclass(reqs(lo, lo + 50))
            want = dense.get_rate_limits(reqs(lo, lo + 50), now_ms=pair.now())
            assert [(g.status, g.remaining, g.reset_time) for g in got] == [
                (w.status, w.remaining, w.reset_time) for w in want]
    assert pair.port.paging.faults > 0


def test_oversized_batch_segments_by_working_set(monkeypatch):
    """:214 — a batch with more unique keys than the device holds splits
    into arrival-order segments; a straggler duplicate sees the earlier
    segment's debit.  Columnar and dataclass paths."""
    pair = Paged(monkeypatch, 2048, page_size=16, resident=2)
    oracle = _SpecOracle()
    rows = [(b"seg_%d" % i, 0, 0, 1, 10, 60_000, 0) for i in range(200)]
    rows.append((b"seg_0", 0, 0, 1, 10, 60_000, 0))
    assert pair.columnar(rows) == oracle.apply(rows, pair.now())
    reqs = [RateLimitReq(name="seg2", unique_key=str(i % 150), hits=1, limit=9,
                         duration=60_000) for i in range(160)]
    got = pair.dataclass(reqs)
    want = oracle.apply([(b"r2_%d" % (i % 150), 0, 0, 1, 9, 60_000, 0) for i in range(160)],
                        pair.now())
    for g, (ws, _wl, wr, wt) in zip(got, want):
        assert (int(g.status), g.remaining, g.reset_time) == (ws, wr, wt)


def test_restore_is_page_aware_no_fault_storm(monkeypatch, tmp_path):
    """:248 — a load of a key space far past the frames writes cold pages
    into the host store with no fault; the restored buckets answer exactly
    after a counted fault; the export (cold pages included) is the
    reference's.  The checkpoint crosses through both NpzFileLoaders."""
    pair = Paged(monkeypatch, 1024)
    rows = [(b"rst_%d" % i, i % 2, 0, 1 + i % 3, 10, 600_000, 0) for i in range(300)]
    pair.columnar(rows)
    items = list(pair.port.export_items())
    ref_items = list(pair.ref.export_items())
    assert len(items) == 300
    assert [dataclasses.asdict(i) for i in items] == [dataclasses.asdict(i) for i in ref_items]

    path = os.fspath(tmp_path / "paged.npz")
    NpzFileLoader(path).save(iter(items))
    dst = Paged(monkeypatch, 1024)
    assert dst.port.load(NpzFileLoader(path)) == dst.ref.load(RefNpzFileLoader(path)) == 300
    assert dst.port.paging.faults == 0
    assert_same_paging(dst.ref, dst.port)
    by_key = {it.key: it.value.remaining for it in items}
    got = dst.columnar([(b"rst_7", 1, 0, 0, 10, 600_000, 0), (b"rst_8", 0, 0, 0, 10, 600_000, 0)])
    assert got[1][2] == by_key["rst_8"]
    assert dst.port.paging.faults >= 1
    assert {it.key for it in dst.port.export_items()} == set(by_key)


def test_host_sweep_frees_cold_pages_without_faults(monkeypatch):
    """:298 — expired buckets on non-resident pages free from the host
    words alone: the slots go back to the intern table, no fault."""
    pair = Paged(monkeypatch, 512, page_size=16, resident=2)
    rows = [(b"sw_%d" % i, 0, 0, 1, 5, 1_000, 0) for i in range(96)]
    assert len(pair.columnar(rows)) == 96
    assert len(pair.port.paging.nonresident_used_pages()) > 0
    faults = pair.port.paging.faults
    pair.advance(60_000)
    assert pair.port.sweep(now_ms=pair.now()) == pair.ref.sweep(now_ms=pair.now()) == 96
    assert pair.port.paging.faults == faults
    assert_same_paging(pair.ref, pair.port)
    assert pair.port.cache_size() == pair.ref.cache_size() == 0
    assert list(pair.port.export_items()) == []
    # The freed slots are handed out as the reference's table hands them.
    pair.columnar([(b"again_%d" % i, 0, 0, 1, 5, 1_000, 0) for i in range(40)])


def test_resident_only_traffic_never_faults(monkeypatch):
    """:318 — a working set inside the frames pays no fault after first
    contact."""
    pair = Paged(monkeypatch, 1024, page_size=16, resident=4)
    rows = [(b"hot_%d" % i, 0, 0, 1, 1000, 600_000, 0) for i in range(48)]
    pair.columnar(rows)
    base = pair.port.paging.faults
    for _ in range(10):
        pair.advance(5)
        pair.columnar(rows)
    assert pair.port.paging.faults == base


def test_paged_knob_defaults_and_validation(monkeypatch):
    """:334 — GUBER_PAGE_SIZE falls back to 512 when not a power of two >=
    16; GUBER_PAGED_RESIDENT < 0 reads 0, and 0 keeps every page resident;
    only "1" turns paging on."""
    for v in ("48", "8", "64", "x", "", "1024"):
        monkeypatch.setenv("GUBER_PAGE_SIZE", v)
        assert env_page_size() == ref_env_page_size()
    monkeypatch.setenv("GUBER_PAGE_SIZE", "48")
    assert env_page_size() == 512
    monkeypatch.setenv("GUBER_PAGE_SIZE", "64")
    assert env_page_size() == 64
    for v in ("-3", "0", "7", "x"):
        monkeypatch.setenv("GUBER_PAGED_RESIDENT", v)
        assert env_paged_resident() == ref_env_paged_resident()
    monkeypatch.setenv("GUBER_PAGED_RESIDENT", "-3")
    assert env_paged_resident() == 0
    for v, on in (("1", True), (" 1 ", True), ("true", False), ("0", False)):
        monkeypatch.setenv("GUBER_PAGED", v)
        assert env_paged() is on
    monkeypatch.delenv("GUBER_PAGED")
    assert DecisionEngine(256, device="cpu").paging is None

    pair = Paged(monkeypatch, 256, page_size=16, resident=0)
    assert pair.port.capacity == pair.port.logical_capacity == 256
    pair.columnar([(b"all_%d" % i, 0, 0, 1, 5, 60_000, 0) for i in range(200)])
    assert pair.port.paging.faults == 0 and pair.port.paging.spills == 0


def test_paged_counters():
    """:358, as counters: the plane's shape and its zeroed counters and
    timers."""
    plane = PagePlane(1024, 16, 4)
    assert (plane.frames, plane.device_capacity, plane.num_pages) == (4, 64, 64)
    assert (plane.faults, plane.spills, plane.refills, plane.fault_batches) == (0, 0, 0, 0)
    for stat in (plane.fault_duration, plane.spill_duration, plane.refill_wait):
        assert (stat.count, stat.total) == (0, 0.0)
    with pytest.raises(ValueError):
        PagePlane(1024, 24, 4)


# ---------------------------------------------------------------------------
# Batched faults, the store path and the ledger.


@pytest.mark.parametrize("seed", [2, 11])
def test_batched_faults_match_the_reference_page_table(seed, monkeypatch):
    """Batches whose keys span many cold pages: the port takes each
    batch's faults in one K9 and one K10; the victims, the clock and the
    host store after every batch are the reference's, page by page."""
    rng = np.random.default_rng(seed)
    pair = Paged(monkeypatch, 4096, page_size=16, resident=8)
    keys = [b"bf_%d" % i for i in range(1500)]
    pair.columnar([(k, 0, 0, 1, 1000, 600_000, 0) for k in keys[:120]])
    multi = 0
    for _step in range(30):
        pair.advance(int(rng.integers(0, 50)))
        picks = rng.choice(len(keys), int(rng.integers(20, 100)))
        rows = [(keys[int(i)], int(i % 2), 0, int(rng.integers(0, 3)), 50, 90_000, 0)
                for i in picks]
        before = pair.port.paging.faults
        pair.columnar(rows)
        multi += pair.port.paging.faults - before > 1
    pp = pair.port.paging
    assert multi > 0 and pp.fault_batches < pp.faults


def test_store_path_pages_like_the_reference(monkeypatch):
    """A write-through store over paged state: read-through restores into
    the batch's (resident) pages, eviction clears of cold pages, and the
    store's calls and contents are the reference's."""
    pair = Paged(monkeypatch, 96, page_size=16, resident=2, store=True)
    rng = np.random.default_rng(12)
    for _ in range(25):
        pair.advance(int(rng.integers(0, 400)))
        reqs = [RateLimitReq(name="st", unique_key=f"k{int(rng.integers(140))}",
                             hits=int(rng.integers(0, 3)), limit=5,
                             duration=int(rng.choice([500, 60_000])),
                             algorithm=int(rng.integers(0, 2))) for _ in range(12)]
        pair.dataclass(reqs)
    assert pair.port.paging.faults > 0
    assert pair.port.table.evictions == pair.ref.table.evictions > 0
    ps, rs = pair.port.store, pair.ref.store
    assert (ps.on_change_calls, ps.get_calls, ps.remove_calls) == (
        rs.on_change_calls, rs.get_calls, rs.remove_calls)
    assert {k: dataclasses.asdict(v) for k, v in ps.data.items()} == {
        k: dataclasses.asdict(v) for k, v in rs.data.items()}


@pytest.mark.parametrize("seed", [7])
def test_paged_vs_spec_vs_ledger_three_way(seed, monkeypatch):
    """tests/test_fused_parity.py:298 with the port as a third party: the
    port's ledger over the port's paged engine (64 resident rows under
    2048 logical slots), the reference's ledger over its paged Pallas
    engine in interpret mode, and the spec agree row for row; after the
    settles, the page tables, host stores and device words are equal."""
    from test_torch_ledger import Twin

    _paged_env(monkeypatch, 16, 4, fused="interpret")
    rng = np.random.default_rng(seed)
    t = Twin()
    assert t.ref_engine.fused_mode == "pallas-interpret"
    assert t.engine.capacity == 64 and t.engine.logical_capacity == 2048
    keys = [b"pgl_%d" % i for i in range(420)]
    try:
        for step in range(60):
            t.advance(int(rng.integers(0, 60)))
            rows = []
            for _ in range(int(rng.integers(1, 8))):
                key = keys[int(rng.integers(0, len(keys)))]
                rows.append((key, int(key[-1] % 2), 0, int(rng.choice([0, 1, 1, 2, 4])),
                             int(rng.choice([2, 5, 9])), int(rng.choice([40, 90, 400])), 0))
            t.serve(rows, tag=f"seed {seed} step {step}")
        assert t.engine.paging.faults > 0 and t.engine.paging.spills > 0
        assert t.ledger.flush_settles() == t.ref_ledger.flush_settles()
        t.stats()
        assert_same_paging(t.ref_engine, t.engine)
    finally:
        t.close()


# ---------------------------------------------------------------------------
# The default service: the hot-key sketch picks the victims with the clock.


class _Now:
    def __init__(self, t):
        self.t = t

    def __call__(self):
        return self.t


def _instances(monkeypatch, hot):
    """(reference, port) V1Instances over paged engines; the sketch on
    (`hot`) with a frozen clock on each side, or off."""
    _paged_env(monkeypatch, 16, 6)
    now = _Now(50.0)
    for mod in (ref_hotkeys, hotkeys):
        monkeypatch.setattr(mod, "from_env", lambda m=mod: m.SpaceSaving(
            capacity=64, window_s=5.0, now=now) if hot else None)
    behaviors = BehaviorConfig(global_sync_wait=3600.0, adaptive_windows=False)
    ref = RefInstance(Config(behaviors=behaviors),
                      RefEngine(2048, clock=RefClock().freeze_at(T0_NS)))
    port = V1Instance(DecisionEngine(2048, clock=Clock().freeze_at(T0_NS), device="cpu"),
                      ledger_opts=dict(settle_interval=0))
    return ref, port


def _service_stream(ref, port, seed=21):
    rng = np.random.default_rng(seed)
    for _step in range(40):
        ref.engine.clock.advance(ms=3)
        port.engine.clock.advance(ms=3)
        reqs = [RateLimitReq(name="svc", unique_key=f"z{int(rng.zipf(1.2)) % 900}",
                             hits=1, limit=1000, duration=600_000) for _ in range(30)]
        want = ref.get_rate_limits([RefReq(**vars(r)) for r in reqs])
        got = port.get_rate_limits(reqs)
        assert [(g.status, g.remaining, g.reset_time, g.error) for g in got] == [
            (w.status, w.remaining, w.reset_time, w.error) for w in want]
        assert_same_paging(ref.engine, port.engine)


def test_default_service_with_the_sketch_evicts_the_reference_victims(monkeypatch):
    ref, port = _instances(monkeypatch, hot=True)
    calls = []
    provider = port.engine.paging.hot_slots_provider
    assert provider is not None and ref.engine.paging.hot_slots_provider is not None
    port.engine.paging.hot_slots_provider = lambda: calls.append(1) or provider()
    try:
        _service_stream(ref, port)
        assert port.engine.paging.faults > 64 and len(calls) > 1
        assert port.engine.paging._hot_pages == ref.engine.paging._hot_pages
    finally:
        port.close()
        ref.close()


def test_the_sketch_changes_the_victims(monkeypatch):
    """The control of the case above: with the sketch off on both sides
    the two still agree, and their page tables differ from the sketch's
    run, so the sketch case is not vacuous."""
    tables = []
    for hot in (True, False):
        ref, port = _instances(monkeypatch, hot)
        try:
            _service_stream(ref, port)
            tables.append(port.engine.paging.frame_of.copy())
        finally:
            port.close()
            ref.close()
    assert not np.array_equal(*tables)


# ---------------------------------------------------------------------------
# The daemon: store, loader and sweep thread over paged state.


def _http(addr, specs):
    import json
    import urllib.request

    body = json.dumps({"requests": [
        dict(name="pd", unique_key=k, hits=h, limit=10, duration=d) for k, h, d in specs
    ]}).encode()
    with urllib.request.urlopen(urllib.request.Request(
            f"http://{addr}/v1/GetRateLimits", data=body, method="POST"), timeout=30) as r:
        return [int(x.get("remaining", 0)) for x in json.loads(r.read())["responses"]]


def test_daemon_pages_with_a_loader_and_the_sweep_thread(monkeypatch, tmp_path):
    from gubernator_tpu_torch.daemon import spawn_daemon

    _paged_env(monkeypatch, 16, 2)
    path = os.fspath(tmp_path / "daemon.npz")
    clock = Clock().freeze_at(T0_NS)
    ref = RefEngine(capacity=1000, clock=RefClock().freeze_at(T0_NS))
    specs = [(f"d{i}", 1 + i % 4, 5_000) for i in range(90)]

    def ref_answers(sp):
        return [r.remaining for r in ref.get_rate_limits([
            RefReq(name="pd", unique_key=k, hits=h, limit=10, duration=d) for k, h, d in sp])]

    conf = DaemonConfig(http_listen_address="127.0.0.1:0", cache_size=1000, sweep_interval=0.0)
    d1 = spawn_daemon(conf, clock=clock, device="cpu", loader=NpzFileLoader(path),
                      store=tstore.MemoryStore())
    try:
        assert d1.instance.engine.capacity == 32
        assert _http(d1.http_address, specs) == ref_answers(specs)
        assert d1.instance.engine.paging.faults > 0
    finally:
        d1.close()
    conf.sweep_interval = 0.1
    d2 = spawn_daemon(conf, clock=clock, device="cpu", loader=NpzFileLoader(path))
    try:
        eng = d2.instance.engine
        assert eng.cache_size() == 90 and eng.paging.faults == 0
        again = [(k, 0, d) for k, _h, d in specs[:40]]
        assert _http(d2.http_address, again) == ref_answers(again)
        faults = eng.paging.faults
        clock.advance(ms=10_000)
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and eng.cache_size() > 0:
            time.sleep(0.05)
        assert eng.cache_size() == 0 and eng.paging.faults == faults
    finally:
        d2.close()
