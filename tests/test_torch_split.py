"""The split arm (GUBER_FUSED=split) of the port against the JAX package's,
on the CPU.

* The plain versions of kernels K14-K16 against the reference's split
  programs on seeded state: `packed_compute_reference` against
  `packed_compute` (slot, packed output, and the words against
  `encode_slot_values` of its values, every lane), `scatter_store_reference`
  against `scatter_store` (all twelve columns), `collapsed_compute_reference`
  against `collapsed_compute`; and the fused plain steps equal to compute
  then scatter.
* The port's engine under `GUBER_FUSED=split` against the JAX engine
  under `split`, over the rounds stream (duplicate keys, both entry
  points), an evicting stream, hot-key batches that collapse, a store
  stream whose evicted keys come back from the store, and paged state:
  answers, every live key's twelve words, `rounds_total` and
  `dispatches_total` equal, and at least two dispatches a round.
* Ports of tests/test_fused_parity.py:348 (the fused steady state is one
  dispatch a batch and split takes more) and :382 (an unknown knob
  raises), and the other four knob values selecting the fused arm.

Tolerance: exact, bit for bit.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_collapse import _segments
from test_torch_engine import T0_NS, _assert_same_state, _columnar_step, _dataclass_step, _rows
from test_torch_multi_round import _assert_state_equal, _jax_state, _rand_logical
from test_torch_paging import Paged
from test_torch_persist import _assert_identical, _assert_same_store, _both

from gubernator_tpu import store as jstore
from gubernator_tpu.clock import Clock as RefClock
from gubernator_tpu.core.engine import DecisionEngine as RefEngine
from gubernator_tpu.ops import bucket_kernel as bk
from gubernator_tpu_torch import store as tstore
from gubernator_tpu_torch.clock import Clock
from gubernator_tpu_torch.core import engine as engine_mod
from gubernator_tpu_torch.core.engine import DecisionEngine
from gubernator_tpu_torch.ops import bucket_kernel as tk
from gubernator_tpu_torch.ops import fused_step as fs
from gubernator_tpu_torch.ops import split_step as ss
from gubernator_tpu_torch.types import RateLimitReq

NOW = 1_760_000_000_000


def _low32(a) -> np.ndarray:
    return np.asarray(a).astype(np.int64) & 0xFFFFFFFF


def _assert_words(got: torch.Tensor, vals, lanes=None):
    """The port's words [12, W] against `encode_slot_values(vals)`."""
    want = bk.encode_slot_values(vals)
    g = got.numpy()
    sel = slice(None) if lanes is None else lanes
    for c, f in enumerate(bk.StoredWords._fields):
        assert np.array_equal(_low32(g[c])[sel], _low32(getattr(want, f))[sel]), f


def _random_pin(rng, cap, width, now):
    m = width - int(rng.integers(0, width // 4 + 1))
    slots = np.sort(rng.choice(cap, m, replace=False)).astype(np.int32)
    cols = [rng.integers(0, 3, m), rng.choice([0, 4, 8, 12], m),
            rng.choice([-3, 0, 1, 2, 5, 2**40], m), rng.choice([-1, 0, 5, 100, 2**62], m),
            rng.choice([0, 1, 40, 30_000, -5], m), rng.choice([0, 0, 5, -7], m),
            rng.choice([60_000, 86_400_000], m), now + rng.integers(0, 100_000, m)]
    return tk.pack_batch_host(width, now, cap, slots, *cols)


# ---------------------------------------------------------------------------
# The plain versions of K14-K16.


@pytest.mark.parametrize("seed,width", [(0, 64), (1, 256), (2, 64), (3, 1024)])
def test_packed_compute_and_scatter_match_jax(seed, width):
    """K14's and K15's plain versions against `packed_compute` then
    `scatter_store`, call after call on an evolving state."""
    rng = np.random.default_rng(seed)
    cap, now = 2048, NOW
    words = bk.pack_state_host(_rand_logical(rng, cap, now))
    jstate, port = _jax_state(words), tk.state_from_numpy(words, "cpu")
    for it in range(6):
        now += int(rng.integers(0, 400))
        pin = _random_pin(rng, cap, width, now)
        jslot, jvals, jpout = bk.packed_compute(jstate, jnp.asarray(pin))
        slot, w, pout = tk.packed_compute_reference(port, torch.from_numpy(pin))
        assert np.array_equal(slot.numpy(), np.asarray(jslot))
        assert np.array_equal(pout.numpy(), np.asarray(jpout)), it
        _assert_words(w, jvals)
        _assert_state_equal(jstate, port, it)  # the compute half writes nothing
        jstate = bk.scatter_store(jstate, jslot, jvals)
        tk.scatter_store_reference(port, slot, w)
        _assert_state_equal(jstate, port, it)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_collapsed_compute_matches_jax(seed):
    """K16's plain version against `collapsed_compute`, then K15's against
    `scatter_store` over the segment slots."""
    rng = np.random.default_rng(seed + 10)
    cap, now = 256, NOW
    words = bk.pack_state_host(_rand_logical(rng, cap, now))
    jstate, port = _jax_state(words), tk.state_from_numpy(words, "cpu")
    for it in range(8):
        uniq, counts, fields, seg, pos = _segments(rng, cap, int(rng.integers(1, 40)), now)
        size = 1 << max(6, (len(seg) - 1).bit_length())
        pin = tk.pack_collapsed_host(size, now, cap, uniq, counts, fields, seg, pos)
        jslot, jvals, jpout = bk.collapsed_compute(jstate, jnp.asarray(pin))
        slot, w, pout = tk.collapsed_compute_reference(port, torch.from_numpy(pin))
        assert np.array_equal(slot.numpy(), np.asarray(jslot))
        assert np.array_equal(pout.numpy(), np.asarray(jpout)), it
        _assert_words(w, jvals)
        jstate = bk.scatter_store(jstate, jslot, jvals)
        tk.scatter_store_reference(port, slot, w)
        _assert_state_equal(jstate, port, it)
        now += int(rng.integers(0, 3_000))


def test_compute_then_scatter_is_the_fused_step():
    """The fused plain steps equal their split halves run one after the
    other (the engines' two arms leave the same state)."""
    rng = np.random.default_rng(7)
    cap = 1024
    words = bk.pack_state_host(_rand_logical(rng, cap, NOW))
    fused, split = tk.state_from_numpy(words, "cpu"), tk.state_from_numpy(words, "cpu")
    for it in range(4):
        pin = torch.from_numpy(_random_pin(rng, cap, 128, NOW + it))
        want = tk.fused_step_reference(fused, pin)
        slot, w, got = ss.packed_compute(split, pin)
        ss.scatter_store(split, slot, w)
        assert torch.equal(got, want)
        uniq, counts, fields, seg, pos = _segments(rng, cap, 20, NOW + it)
        cpin = torch.from_numpy(tk.pack_collapsed_host(128, NOW + it, cap, uniq, counts,
                                                       fields, seg, pos))
        want = tk.collapsed_step_reference(fused, cpin)
        slot, w, got = ss.collapsed_compute(split, cpin)
        ss.scatter_store(split, slot, w)
        assert torch.equal(got, want)
        for a, b in zip(fused, split):
            assert torch.equal(a, b), it


def test_split_wrappers_route_cpu_tensors_to_the_plain_versions():
    """CPU tensors run the plain versions and count no launch; a bad words
    buffer raises."""
    fs.reset_launches()
    state = tk.make_state(64, "cpu")
    pin = torch.from_numpy(_random_pin(np.random.default_rng(1), 64, 32, NOW))
    slot, w, pout = ss.packed_compute(state, pin)
    assert w.shape == (12, 32) and pout.shape == (5, 32)
    ss.scatter_store(state, slot, w)
    assert fs.split_launches == {"packed_compute": 0, "scatter_store": 0,
                                 "collapsed_compute": 0}
    with pytest.raises(ValueError):
        ss.scatter_store(state, slot, w[:11])


# ---------------------------------------------------------------------------
# The engines under GUBER_FUSED=split.


def _split_pair(monkeypatch, capacity, *, store=False):
    monkeypatch.setenv("GUBER_FUSED", "split")
    ref = RefEngine(capacity=capacity, clock=RefClock().freeze_at(T0_NS),
                    store=jstore.MemoryStore() if store else None)
    port = DecisionEngine(capacity, clock=Clock().freeze_at(T0_NS), device="cpu",
                          store=tstore.MemoryStore() if store else None)
    assert ref.fused_mode == port.fused_mode == "split"
    return ref, port


def _same_counts(ref, port):
    assert port.rounds_total == ref.rounds_total
    assert port.dispatches_total == ref.dispatches_total
    assert port.dispatches_total >= 2 * port.rounds_total


@pytest.mark.parametrize("path", ["dataclass", "columnar"])
def test_split_engine_rounds_match_jax_split(monkeypatch, path):
    """Token and leaky traffic with duplicate keys (rounds), RESET_REMAINING
    and Gregorian intervals, both entry points."""
    rng = np.random.default_rng(31 if path == "dataclass" else 32)
    ref, port = _split_pair(monkeypatch, 512)
    keys = [f"s{i}" for i in range(40)]
    step = _dataclass_step if path == "dataclass" else _columnar_step
    for _ in range(30):
        step(ref, port, _rows(rng, keys, int(rng.integers(1, 48)),
                              invalid_greg=path == "dataclass"))
        dt = int(rng.choice([0, 1, 100, 40_000]))
        for e in (ref, port):
            e.clock.advance(ms=dt)
    _assert_same_state(ref, port)
    _same_counts(ref, port)
    assert port.rounds_total > port.batches_total


@pytest.mark.parametrize("path", ["dataclass", "columnar"])
def test_split_engine_eviction_matches_jax_split(monkeypatch, path):
    """Capacity below the keys: each round's clears are a launch of their
    own before the round's compute and scatter."""
    rng = np.random.default_rng(33 if path == "dataclass" else 34)
    ref, port = _split_pair(monkeypatch, 64)
    keys = [f"v{i}" for i in range(200)]
    step = _dataclass_step if path == "dataclass" else _columnar_step
    for _ in range(25):
        step(ref, port, _rows(rng, keys, int(rng.integers(8, 64)), greg=False))
        for e in (ref, port):
            e.clock.advance(ms=7)
    assert port.table.evictions == ref.table.evictions > 0
    assert port.clears_total > 0
    _assert_same_state(ref, port)
    _same_counts(ref, port)


def test_split_engine_collapse_matches_jax_split(monkeypatch):
    """Hot-key batches collapse: the clears' launch, then K16 and K15 a
    chunk (chunks of 64 lanes here)."""
    rng = np.random.default_rng(35)
    ref, port = _split_pair(monkeypatch, 128)
    ref.max_kernel_width = port.max_kernel_width = 64
    calls = []
    real = engine_mod.collapsed_compute
    monkeypatch.setattr(engine_mod, "collapsed_compute",
                        lambda *a: calls.append(1) or real(*a))
    keys = [f"z{i}" for i in range(300)]
    for b in range(16):
        ranks = np.minimum(rng.zipf(1.3, 150), 300) - 1
        rows = [(keys[int(k)], int(k) % 2, 0, 1, 10 + int(k) % 7, 60_000, 0) for k in ranks]
        d0 = port.dispatches_total
        _columnar_step(ref, port, rows)
        _dataclass_step(ref, port, rows)
        assert port.dispatches_total - d0 >= 4
        for e in (ref, port):
            e.clock.advance(ms=int(b * 37 % 900))
    assert port.table.evictions > 0 and port.clears_total > 0
    assert len(calls) >= 16  # collapsed chunks through K16's wrapper
    _assert_same_state(ref, port)
    _same_counts(ref, port)


def test_split_engine_store_matches_jax_split(monkeypatch):
    """A store and 8 slots for 24 keys: evicted keys come back from the
    store in later rounds of a batch, the round's clears and restores one
    launch, then its compute and scatter."""
    rng = np.random.default_rng(36)
    ref, port = _split_pair(monkeypatch, 8, store=True)
    keys = [f"r{i}" for i in range(24)]
    for b in range(30):
        specs = [dict(key=keys[int(rng.integers(len(keys)))] if rng.random() < 0.6 else
                      keys[int(rng.integers(6))], hits=int(rng.choice([0, 1, 2, 5])),
                      algorithm=int(rng.integers(0, 2)), burst=int(rng.choice([0, 6])),
                      limit=int(rng.choice([5, 20])), duration=int(rng.choice([400, 60_000])))
                 for _ in range(int(rng.integers(4, 20)))]
        _both(ref, port, specs)
        dt = int(rng.choice([0, 50, 300]))
        for e in (ref, port):
            e.clock.advance(ms=dt)
    assert port.store.get_calls > 0 and port.table.evictions > 0
    _assert_identical(ref, port)
    _assert_same_store(ref, port)
    assert port.rounds_total == ref.rounds_total
    assert port.dispatches_total >= 2 * port.rounds_total


@pytest.mark.parametrize("seed", [3, 4])
def test_split_engine_paged_matches_jax_split(monkeypatch, seed):
    """Paged state under split: translation, faults and the page table as
    the reference's, the rounds split into compute and scatter."""
    rng = np.random.default_rng(seed)
    pair = Paged(monkeypatch, 1024, fused="split")
    assert pair.port.fused_mode == pair.ref.fused_mode == "split"
    keys = [f"p{i}" for i in range(1024)]
    for b in range(12):
        rows = [(keys[int(rng.integers(1024))].encode(), int(rng.integers(0, 2)), 0,
                 int(rng.choice([1, 1, 2])), 20, int(rng.choice([500, 60_000])), 0)
                for _ in range(int(rng.integers(8, 60)))]
        pair.columnar(rows)
        reqs = [RateLimitReq(name="pg", unique_key=keys[int(rng.integers(200))], hits=1,
                             limit=9, duration=60_000) for _ in range(20)]
        pair.dataclass(reqs)
        pair.advance(int(rng.choice([0, 10, 700])))
    assert pair.port.paging.faults > 0
    assert pair.port.dispatches_total >= 2 * pair.port.rounds_total


def test_fused_steady_state_is_single_dispatch_and_split_takes_more(monkeypatch):
    """tests/test_fused_parity.py:348: in steady state a batch of the fused
    arm is one launch; the split control launches at least two."""
    monkeypatch.setenv("GUBER_PUMP", "0")
    clock = Clock().freeze()
    engine = DecisionEngine(4096, clock=clock, device="cpu")
    assert engine.fused_mode == "torch-cpu"

    def batch(eng, start, n=100):
        return eng.apply_columnar(
            [b"sd_%d" % i for i in range(start, start + n)],
            np.zeros(n, np.int32), np.zeros(n, np.int32), np.ones(n, np.int64),
            np.full(n, 10, np.int64), np.full(n, 60_000, np.int64), np.zeros(n, np.int64))

    batch(engine, 0)
    before = engine.dispatches_total
    batch(engine, 0)
    assert engine.dispatches_total - before == 1
    before = engine.dispatches_total
    batch(engine, 200)
    assert engine.dispatches_total - before == 1

    monkeypatch.setenv("GUBER_FUSED", "split")
    unfused = DecisionEngine(4096, clock=clock, device="cpu")
    assert unfused.fused_mode == "split"
    batch(unfused, 0)
    before = unfused.dispatches_total
    batch(unfused, 0)
    assert unfused.dispatches_total - before >= 2
    assert [np.asarray(a).tolist() for a in batch(unfused, 0)] == [
        np.asarray(a).tolist() for a in batch(engine, 0)]


def test_guber_fused_knob_rejects_unknown(monkeypatch):
    """tests/test_fused_parity.py:382."""
    monkeypatch.setenv("GUBER_FUSED", "warp")
    with pytest.raises(ValueError, match="GUBER_FUSED"):
        DecisionEngine(256, clock=Clock().freeze(), device="cpu")


@pytest.mark.parametrize("knob", ["auto", "pallas", "interpret", "xla", "", " XLA "])
def test_other_knob_values_select_the_fused_arm(monkeypatch, knob):
    """Every value but split runs the fused kernels, with the pump."""
    monkeypatch.setenv("GUBER_FUSED", knob)
    monkeypatch.setenv("GUBER_PUMP", "1")
    eng = DecisionEngine(256, clock=Clock().freeze(), device="cpu")
    assert eng.fused_mode == "torch-cpu" and eng._pump.queueing
    n = 10
    eng.apply_columnar([b"k%d" % i for i in range(n)], np.zeros(n, np.int32),
                       np.zeros(n, np.int32), np.ones(n, np.int64), np.full(n, 5, np.int64),
                       np.full(n, 1000, np.int64), np.zeros(n, np.int64))
    assert eng.dispatches_total == 1 and eng._pump.submitted == 1
