"""The port's sharded engine (parallel/sharded_engine.py) against the JAX
package's `ShardedDecisionEngine`, on the CPU.

The reference runs on the 8-device virtual CPU mesh that tests/conftest.py
forces: its shard_map form by default, and its single-program form
(`single_program=True`) where a case is parametrised on it.  The port runs
with `n_shards` equal to the reference mesh's size, its state on one
device.  Held bit-equal: answers, and every state word a shard and slot
(both packages' native tables take the same calls, so slots match too).

* The plain per-shard steps (the CPU paths of kernels K11, K12 and K13)
  against the reference's vmapped programs: `jax.vmap(_fused_step_core)`,
  `jax.vmap(collapsed_fused_one)` after `jax.vmap(_clear_occupied_impl)`,
  and `sweep_window_scan` + `sweep_window_commit` over [n_sh, cap], at 1,
  4 and 8 shards with padding lanes and clears.
* Ports of tests/test_sharded_engine.py (the same stream as one device,
  keys spread, over-limit aggregation, duplicates applied in order,
  sweep, eviction and reuse in one batch), tests/test_sharded_columnar.py
  (columnar equals dataclass, async; the psum cases held as "the port's
  answers equal the reference's psum engine's"), tests/test_sweep.py:90
  (the windowed sweep over 4 shards), tests/test_store.py:221 (the
  loader round trip, and npz checkpoints both ways) and
  tests/test_h2_fast.py:113 (the h2 front over a sharded daemon,
  device_count=8); a seeded stream through `V1Instance` over both sharded
  engines with the ledger on and off, the same stream through both h2
  fronts (response bytes; their columnar feeders on, as by default, and
  off), a write-through store stream, and a
  racing-threads storm with the exact accounting of
  tests/test_sharded_storm.py.

Tolerance: exact.
"""

from __future__ import annotations

import dataclasses
import os
import random
import threading

import grpc
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gubernator_tpu.ops.bucket_kernel as jbk
from gubernator_tpu import store as jstore
from gubernator_tpu.checkpoint import NpzFileLoader as RefNpzFileLoader
from gubernator_tpu.clock import Clock as RefClock
from gubernator_tpu.config import BehaviorConfig
from gubernator_tpu.config import Config as RefConfig
from gubernator_tpu.net.h2_fast import H2FastFront as RefFront
from gubernator_tpu.net.pb import gubernator_pb2 as pb
from gubernator_tpu.ops.expiry import sweep_window_commit, sweep_window_scan
from gubernator_tpu.parallel.mesh import make_mesh
from gubernator_tpu.parallel.sharded_engine import ShardedDecisionEngine as RefSharded
from gubernator_tpu.service import V1Instance as RefInstance
from gubernator_tpu.types import RateLimitReq as RefReq
from gubernator_tpu_torch import store as tstore
from gubernator_tpu_torch.checkpoint import NpzFileLoader
from gubernator_tpu_torch.clock import Clock
from gubernator_tpu_torch.config import DaemonConfig, setup_daemon_config
from gubernator_tpu_torch.core.engine import DecisionEngine
from gubernator_tpu_torch.daemon import spawn_daemon
from gubernator_tpu_torch.net.h2_fast import H2FastFront
from gubernator_tpu_torch.net.wire_codec import decode_reqs
from gubernator_tpu_torch.ops import bucket_kernel as tk
from gubernator_tpu_torch.ops.expiry import shard_sweep_window, shard_sweep_window_reference
from gubernator_tpu_torch.ops.sharded_step import (
    shard_clear_rows,
    shard_collapsed_step,
    shard_step,
)
from gubernator_tpu_torch.parallel.sharded_engine import ShardedDecisionEngine
from gubernator_tpu_torch.service import COLUMNAR_DISQUALIFIERS, V1Instance
from gubernator_tpu_torch.types import Algorithm, Behavior, RateLimitReq, Status
from test_torch_h2_fast import _raw_call, _stream_rpcs, settled_stats
from test_torch_persist import _random_words

N_SHARDS = 8  # the reference's virtual CPU mesh (tests/conftest.py)
T0_NS = 1_760_000_000_123 * 1_000_000
SECOND = 1000
FORMS = ["shard_map", "single_program"]


def assert_same_state(port, ref) -> None:
    """Every state word of every shard and slot equal."""
    want = {f: np.asarray(getattr(ref._state, f)) for f in ref._state._fields}
    got = tk.state_to_numpy(port.state)
    for f in tk.BucketState._fields:
        assert got[f].shape == want[f].shape, f
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)


def assert_same_tables(port, ref) -> None:
    for sh, (t, r) in enumerate(zip(port.tables, ref.tables)):
        assert (len(t), t.hits, t.misses, t.evictions, t.unexpired_evictions) == (
            len(r), r.hits, r.misses, r.evictions, r.unexpired_evictions), sh


def _pair(shard_capacity, form="single_program", *, n_shards=N_SHARDS, store=False):
    """(port engine on the CPU, reference engine), frozen clocks at T0."""
    mesh = make_mesh(jax.devices()[:n_shards]) if n_shards != N_SHARDS else None
    ref = RefSharded(shard_capacity=shard_capacity, mesh=mesh,
                     clock=RefClock().freeze_at(T0_NS),
                     single_program=form == "single_program",
                     store=jstore.MemoryStore() if store else None)
    assert ref.n_shards == n_shards
    port = ShardedDecisionEngine(shard_capacity, n_shards=n_shards,
                                 clock=Clock().freeze_at(T0_NS), device="cpu",
                                 store=tstore.MemoryStore() if store else None)
    return port, ref


def _advance(ms, *engines):
    for e in engines:
        e.clock.advance(ms=ms)


def _answers(resps):
    return [(r.error, int(r.status), r.limit, r.remaining, r.reset_time) for r in resps]


def _both(port, ref, reqs, **kw):
    """One dataclass batch through both engines; answers held equal."""
    got = port.get_rate_limits(reqs, **kw)
    want = ref.get_rate_limits([RefReq(**vars(r)) for r in reqs], **kw)
    assert _answers(got) == _answers(want)
    return got


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


def _both_columnar(port, ref, reqs):
    got = port.apply_columnar(*_columns(reqs))
    want = ref.apply_columnar(*_columns(reqs))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, np.asarray(b))
    return got


# ---------------------------------------------------------------------------
# The plain per-shard steps against the reference's vmapped programs.


def _sharded_words(rng, n_sh, cap, now):
    """Random valid words of n_sh shards: numpy [n_sh, cap] columns typed
    as the reference's."""
    shards = [_random_words(rng, cap, now) for _ in range(n_sh)]
    return {f: np.stack([s[f] for s in shards]) for f in shards[0]}


def _ref_state(words):
    return jbk.BucketState(**{f: jnp.asarray(words[f]) for f in words})


def _port_state(words):
    return tk.state_from_numpy({f: a.reshape(-1) for f, a in words.items()}, "cpu")


def _assert_words(port_state, ref_state, n_sh):
    got = tk.state_to_numpy(port_state)
    for f in tk.BucketState._fields:
        np.testing.assert_array_equal(got[f].reshape(n_sh, -1), np.asarray(getattr(ref_state, f)),
                                      err_msg=f)


def _request_cols(rng, m, now):
    greg = rng.random(m) < 0.1
    return (rng.integers(0, 2, m).astype(np.int32),
            np.where(greg, 4, np.where(rng.random(m) < 0.05, 8, 0)).astype(np.int32),
            rng.choice([-2, 0, 1, 1, 3, 50], m).astype(np.int64),
            rng.choice([0, 5, 10, 10**6], m).astype(np.int64),
            rng.choice([0, 1, 1000, 60_000], m).astype(np.int64),
            rng.choice([0, 5, 20], m).astype(np.int64),
            np.where(greg, 60_000, 0).astype(np.int64),
            np.where(greg, now + 30_000, 0).astype(np.int64))


def _clear_lists(rng, n_sh, cap, slots_of):
    """Per-shard clears: some of the shard's lane slots, some other slots,
    a shard or two with none."""
    out = []
    for sh in range(n_sh):
        if sh % 3 == 2:
            out.append([])
            continue
        lanes = list(rng.choice(slots_of[sh], min(3, len(slots_of[sh])), replace=False)) \
            if len(slots_of[sh]) else []
        others = [int(s) for s in rng.choice(cap, 4, replace=False) if s not in slots_of[sh]]
        out.append(sorted({int(s) for s in lanes} | set(others)))
    return out


def _ref_clears(state, rows):
    return state._replace(meta=jax.vmap(jbk._clear_occupied_impl)(state.meta, jnp.asarray(rows)))


@pytest.mark.parametrize("n_sh", [1, 4, 8])
def test_plain_shard_step_equals_the_vmapped_reference(n_sh):
    """K11's plain version (`shard_step` on the CPU): the shards' clears,
    then one packed round a shard, each shard padded with shard_cap + lane;
    against `jax.vmap(_clear_occupied_impl)` then
    `jax.vmap(_fused_step_core)`."""
    rng = np.random.default_rng(n_sh)
    cap, width, now = 512, 128, 1_760_000_000_000
    words = _sharded_words(rng, n_sh, cap, now)
    pins, slots_of = [], []
    for sh in range(n_sh):
        m = int(rng.integers(0, width)) if sh else width  # shard 0 full, others padded
        slots = np.sort(rng.choice(cap, m, replace=False)).astype(np.int32)
        slots_of.append(slots)
        pins.append(tk.pack_batch_host(width, now + sh, cap, slots, *_request_cols(rng, m, now)))
    pin = np.stack(pins)
    rows = shard_clear_rows(_clear_lists(rng, n_sh, cap, slots_of), cap)
    ref_state, ref_pout = jax.vmap(jbk._fused_step_core)(
        _ref_clears(_ref_state(words), rows), jnp.asarray(pin))
    state = _port_state(words)
    pout = shard_step(state, torch.from_numpy(pin), cap, torch.from_numpy(rows))
    np.testing.assert_array_equal(pout.numpy(), np.asarray(ref_pout))
    _assert_words(state, ref_state, n_sh)
    # Nothing past a shard's rows: padding lanes wrote nowhere.
    assert rows.shape == (n_sh, 16)


def _collapsed_pin(rng, cap, now, n_seg, width):
    """One shard's collapsed chunk: n_seg segments on unique sorted slots,
    a hot one and short ones, uniform fields a segment."""
    uniq = np.sort(rng.choice(cap, n_seg, replace=False)).astype(np.int32)
    counts = rng.choice([1, 1, 2, 5], n_seg).astype(np.int64)
    if n_seg:
        counts[rng.integers(n_seg)] = 40  # a hot key
    lanes = int(counts.sum())
    assert lanes < width
    cols = _request_cols(rng, n_seg, now)
    algo, beh, hits = cols[0], cols[1] & ~8, np.abs(cols[2])  # the collapse's gate
    seg_of = np.repeat(np.arange(n_seg), counts).astype(np.int32)
    pos = (np.arange(lanes) - np.repeat(np.cumsum(counts) - counts, counts)).astype(np.int32)
    return tk.pack_collapsed_host(width, now, cap, uniq, counts,
                                  (algo, beh, hits) + cols[3:], seg_of, pos)


def _collapsed_fused_one(state, pin):
    slot, vals2, pout = jbk._collapsed_values(state, pin)
    return jbk._scatter_values(state, slot, vals2), pout


@pytest.mark.parametrize("n_sh", [1, 4, 8])
def test_plain_shard_collapsed_step_equals_the_vmapped_reference(n_sh):
    """K12's plain version (`shard_collapsed_step` on the CPU): clears,
    then one collapsed chunk a shard; against the reference's
    `jax.vmap(collapsed_fused_one)` (sharded_engine.py:347)."""
    rng = np.random.default_rng(10 + n_sh)
    cap, width, now = 512, 256, 1_760_000_000_000
    words = _sharded_words(rng, n_sh, cap, now)
    pin = np.stack([_collapsed_pin(rng, cap, now, int(rng.integers(0, 20)) if sh else 20,
                                   width) for sh in range(n_sh)])
    slots_of = [p[1][: int((p[2] > 0).sum())] for p in pin]
    rows = shard_clear_rows(_clear_lists(rng, n_sh, cap, slots_of), cap)
    for p in pin:
        tk.check_collapsed(p)
    ref_state, ref_pout = jax.vmap(_collapsed_fused_one)(
        _ref_clears(_ref_state(words), rows), jnp.asarray(pin))
    state = _port_state(words)
    pout = shard_collapsed_step(state, torch.from_numpy(pin), cap, torch.from_numpy(rows))
    np.testing.assert_array_equal(pout.numpy(), np.asarray(ref_pout))
    _assert_words(state, ref_state, n_sh)


@pytest.mark.parametrize("n_sh,start,window", [(1, 0, 512), (4, 128, 128), (8, 384, 128)])
def test_plain_shard_sweep_equals_the_reference_scan(n_sh, start, window):
    """K13's plain version: one window of every shard, against
    `sweep_window_scan` + `sweep_window_commit` over [n_sh, cap] (counts,
    the compacted freed indices, and the meta words after)."""
    rng = np.random.default_rng(20 + n_sh)
    cap, now = 512, 1_760_000_000_000
    words = _sharded_words(rng, n_sh, cap, now)
    # Expiries at now - 1, now, now + 1 with bit 31 of the low word set.
    now = (now & ~0xFFFFFFFF) | 0x80000005
    exp = now + rng.integers(-1, 2, (n_sh, cap))
    words["hi2"] = (words["hi2"] & ~0x7FF) | (exp >> 32).astype(np.int32)
    words["expire_lo"] = (exp & 0xFFFFFFFF).astype(np.uint32)
    st = _ref_state(words)
    meta_w, order, count = sweep_window_scan(
        st.meta, st.hi2, st.expire_lo, jnp.asarray(now >> 32, jnp.int32),
        jnp.asarray(now & 0xFFFFFFFF, jnp.uint32), jnp.asarray(start, jnp.int32), window=window)
    ref_meta = sweep_window_commit(st.meta, meta_w, jnp.asarray(start, jnp.int32))
    state = _port_state(words)
    out = shard_sweep_window(state.meta, state.hi2, state.expire_lo, n_sh, int(now), start,
                             window).numpy()
    want = shard_sweep_window_reference(*(torch.from_numpy(a.reshape(-1).view(np.int32))
                                          for a in (words["meta"], words["hi2"],
                                                    words["expire_lo"])),
                                        n_sh, int(now), start, window).numpy()
    np.testing.assert_array_equal(out, want)
    count = np.asarray(count)
    np.testing.assert_array_equal(out[:, 0], count)
    assert count.sum() > 0
    for sh in range(n_sh):
        c = int(count[sh])
        np.testing.assert_array_equal(out[sh, 1 : 1 + c], np.asarray(order)[sh, :c])
    np.testing.assert_array_equal(state.meta.numpy().reshape(n_sh, cap), np.asarray(ref_meta))


# ---------------------------------------------------------------------------
# tests/test_sharded_engine.py


@pytest.mark.parametrize("form", FORMS)
def test_sharded_matches_single_device(form):
    """tests/test_sharded_engine.py:30: the same request stream gives the
    same answers as one engine; here against the reference's sharded
    engine (state words too) and the port's single engine."""
    port, ref = _pair(256, form)
    single = DecisionEngine(2048, clock=Clock().freeze_at(T0_NS), device="cpu")
    rng = random.Random(7)
    keys = [f"acct:{i}" for i in range(64)]
    for step in range(30):
        reqs = [RateLimitReq(name="par", unique_key=rng.choice(keys),
                             hits=rng.choice([0, 1, 1, 2, 5]), limit=rng.choice([5, 10, 100]),
                             duration=rng.choice([1000, 9000, 30000]),
                             algorithm=rng.choice([Algorithm.TOKEN_BUCKET,
                                                   Algorithm.LEAKY_BUCKET]))
                for _ in range(rng.randint(1, 12))]
        got = _both(port, ref, reqs)
        assert _answers(got) == _answers(single.get_rate_limits(reqs)), step
        ms = rng.choice([0, 100, 1000, 5000])
        _advance(ms, port, ref, single)
    assert_same_state(port, ref)
    assert_same_tables(port, ref)
    assert (port.requests_total, port.batches_total, port.rounds_total,
            port.over_limit_total) == (ref.requests_total, ref.batches_total, ref.rounds_total,
                                       ref.over_limit_total)


def test_keys_spread_across_shards():
    port, ref = _pair(256)
    touched = set()
    for i in range(200):
        assert port.shard_of(f"key:{i}") == ref.shard_of(f"key:{i}")
        touched.add(port.shard_of(f"key:{i}"))
    assert len(touched) == N_SHARDS


@pytest.mark.parametrize("form", FORMS)
def test_over_limit_aggregation(form):
    port, ref = _pair(256, form)
    reqs = [RateLimitReq(name="over", unique_key=f"k{i}", hits=10, limit=5, duration=9000)
            for i in range(32)]
    resps = _both(port, ref, reqs)
    assert all(r.status == Status.OVER_LIMIT for r in resps)
    assert port.over_limit_total == ref.over_limit_total == 32


def test_duplicate_keys_sequential_on_shard():
    port, ref = _pair(256)
    req = dict(name="dup", unique_key="k", hits=1, limit=3, duration=9000)
    resps = _both(port, ref, [RateLimitReq(**req) for _ in range(5)])
    assert [r.remaining for r in resps] == [2, 1, 0, 0, 0]
    assert port.rounds_total == ref.rounds_total == 1  # one collapsed chunk
    assert_same_state(port, ref)


@pytest.mark.parametrize("form", FORMS)
def test_sharded_sweep_reclaims_expired(form):
    port, ref = _pair(256, form)
    reqs = [RateLimitReq(name="sw", unique_key=f"k{i}", hits=1, limit=5, duration=SECOND)
            for i in range(32)]
    _both(port, ref, reqs)
    assert port.cache_size() == 32
    assert port.sweep() == ref.sweep() == 0
    _advance(2 * SECOND, port, ref)
    assert port.sweep() == ref.sweep() == 32
    assert port.cache_size() == 0
    assert port.sweep_windows_total == 2
    assert_same_state(port, ref)


def test_eviction_and_reuse_within_one_batch_sharded():
    port, ref = _pair(1)
    reqs = [RateLimitReq(name="e", unique_key=f"k{i}", hits=1, limit=10, duration=60_000)
            for i in range(20)]
    resps = _both(port, ref, reqs)
    assert [r.remaining for r in resps] == [9] * 20
    assert_same_state(port, ref)
    assert_same_tables(port, ref)
    assert port.rounds_total == ref.rounds_total


# ---------------------------------------------------------------------------
# tests/test_sharded_columnar.py


@pytest.mark.parametrize("form", FORMS)
def test_sharded_columnar_matches_dataclass(form):
    """tests/test_sharded_columnar.py:26, each path also against the
    reference's same path, state words included."""
    rng = random.Random(11)
    port_a, ref_a = _pair(128, form)
    port_b, ref_b = _pair(128, form)
    for step in range(6):
        reqs = [RateLimitReq(name="shcol", unique_key=f"k{rng.randint(0, 60)}",
                             hits=rng.randint(0, 3), limit=10, duration=60_000,
                             algorithm=rng.choice([Algorithm.TOKEN_BUCKET,
                                                   Algorithm.LEAKY_BUCKET]), burst=10)
                for _ in range(rng.randint(1, 50))]
        resps = _both(port_a, ref_a, reqs)
        st, li, rem, rst = _both_columnar(port_b, ref_b, reqs)
        for i, r in enumerate(resps):
            assert (int(st[i]), int(li[i]), int(rem[i]), int(rst[i])) == (
                int(r.status), r.limit, r.remaining, r.reset_time), f"step {step} item {i}"
        ms = rng.randint(0, 3_000)
        _advance(ms, port_a, ref_a, port_b, ref_b)
    for p, r in ((port_a, ref_a), (port_b, ref_b)):
        assert_same_state(p, r)
        assert (p.requests_total, p.batches_total, p.rounds_total, p.over_limit_total) == (
            r.requests_total, r.batches_total, r.rounds_total, r.over_limit_total)


def test_sharded_columnar_async():
    port, ref = _pair(128)
    reqs = [RateLimitReq(name="a", unique_key=f"x{i}", hits=1, limit=5, duration=60_000)
            for i in range(30)]
    p1 = port.apply_columnar(*_columns(reqs), want_async=True)
    p2 = port.apply_columnar(*_columns(reqs), want_async=True)
    _, _, rem1, _ = p1.get()
    _, _, rem2, _ = p2.get()
    assert rem1.tolist() == [4] * 30
    assert rem2.tolist() == [3] * 30
    for _ in range(2):
        ref.apply_columnar(*_columns(reqs))
    assert_same_state(port, ref)
    assert port.over_limit_total == ref.over_limit_total == 0


def test_answers_equal_the_reference_psum_merge(monkeypatch):
    """tests/test_sharded_columnar.py:56, held as: the port's answers
    equal the reference's psum engine's (its whole-batch rounds merged on
    the device) and its host-merge engine's."""
    port, ref_psum = _pair(128, "shard_map")
    monkeypatch.setenv("GUBER_PSUM_MERGE", "0")
    _p, ref_host = _pair(128, "shard_map")
    assert ref_psum._use_psum_merge and not ref_host._use_psum_merge
    rng = random.Random(5)
    for step in range(4):
        reqs = [RateLimitReq(name="psum", unique_key=f"k{i}", hits=rng.randint(0, 2), limit=8,
                             duration=60_000,
                             algorithm=Algorithm.TOKEN_BUCKET if i % 2 else Algorithm.LEAKY_BUCKET,
                             burst=8)
                for i in range(57)]  # unique keys: round 0, whole batch
        got = port.apply_columnar(*_columns(reqs))
        for ref in (ref_psum, ref_host):
            for x, y in zip(got, ref.apply_columnar(*_columns(reqs))):
                np.testing.assert_array_equal(x, np.asarray(y))
    assert ref_psum._merge_progs
    assert_same_state(port, ref_psum)


def test_multi_round_batches_equal_the_reference_psum_engine():
    """tests/test_sharded_columnar.py:94: a hot key among cold ones (the
    collapse; the psum merge never claims it), exact either way."""
    port, ref = _pair(128, "shard_map")
    keys = [b"hot"] * 30 + [b"cold_%d" % i for i in range(10)]
    n = len(keys)
    cols = (keys, np.zeros(n, np.int32), np.zeros(n, np.int32), np.ones(n, np.int64),
            np.full(n, 100, np.int64), np.full(n, 60_000, np.int64), np.zeros(n, np.int64))
    st, lim, rem, rst = port.apply_columnar(*cols)
    assert list(rem[:30]) == list(range(99, 69, -1))
    for x, y in zip((st, lim, rem, rst), ref.apply_columnar(*cols)):
        np.testing.assert_array_equal(x, np.asarray(y))
    assert_same_state(port, ref)


@pytest.mark.parametrize("shard_capacity", [4, 64])
def test_columnar_stream_equals_the_reference(shard_capacity):
    """A seeded columnar stream (duplicates, evictions at later rounds,
    Gregorian items, RESET_REMAINING, leaky negative hits) through both
    packages' single-program engines: the flat K1 / K3 executors against
    the reference's flat programs, answers, state words and counters."""
    rng = np.random.default_rng(shard_capacity)
    port, ref = _pair(shard_capacity)
    assert port._flat_ok and ref._flat_ok
    for b in range(25):
        n = int(rng.integers(1, 300))
        hot = rng.random() < 0.5
        reqs = []
        for _ in range(n):
            k = int(rng.integers(4)) if hot and rng.random() < 0.6 else int(rng.integers(400))
            beh = int(rng.choice([0, 0, 0, 4, 8])) if not hot else int(rng.choice([0, 0, 4]))
            reqs.append(RateLimitReq(
                name="col", unique_key=f"{k}c", hits=int(rng.choice([0, 1, 1, 3, -1])),
                limit=int(rng.choice([5, 100])), duration=1 if beh == 4 else
                int(rng.choice([1000, 60_000])), algorithm=int(k % 2), behavior=beh,
                burst=int(rng.choice([0, 10]))))
        _both_columnar(port, ref, reqs)
        _advance(int(rng.choice([0, 250, 2000])), port, ref)
    assert_same_state(port, ref)
    assert_same_tables(port, ref)
    assert (port.requests_total, port.batches_total, port.rounds_total,
            port.over_limit_total) == (ref.requests_total, ref.batches_total,
                                       ref.rounds_total, ref.over_limit_total)


def test_columnar_past_int32_takes_the_per_shard_steps(monkeypatch):
    """With the flat layout off (`_flat_ok` false, as past 2^31 slots) the
    columnar path runs K11 / K12 per shard; answers and state words as
    the reference's per-shard programs."""
    port, ref = _pair(16)
    port._flat_ok = ref._flat_ok = False
    rng = random.Random(3)
    for step in range(10):
        reqs = [RateLimitReq(name="nf", unique_key=f"{rng.randint(0, 300)}q",
                             hits=rng.randint(0, 2), limit=9, duration=60_000,
                             algorithm=rng.randint(0, 1), burst=4)
                for _ in range(rng.randint(1, 120))]
        if step % 3 == 0:
            reqs += [reqs[0]] * 5
        _both_columnar(port, ref, reqs)
        _advance(700, port, ref)
    assert_same_state(port, ref)
    assert port.rounds_total == ref.rounds_total


# ---------------------------------------------------------------------------
# tests/test_sweep.py:90 and tests/test_store.py:221


def test_sharded_sweep_windowed():
    """tests/test_sweep.py:90: 4 shards of 512, windows of 128; freed
    counts a call, the cursor, and the state words as the reference's."""
    port, ref = _pair(512, "shard_map", n_shards=4)
    port.SWEEP_WINDOW = ref.SWEEP_WINDOW = 128
    now = T0_NS // 10**6
    reqs = [RateLimitReq(name="shsw", unique_key=f"{i}", hits=1, limit=10, duration=1_000)
            for i in range(300)]
    _both(port, ref, reqs, now_ms=now)
    assert port.sweep(now_ms=now + 500) == ref.sweep(now_ms=now + 500) == 0
    assert port.sweep(now_ms=now + 2_000, max_windows=1) == ref.sweep(
        now_ms=now + 2_000, max_windows=1) > 0
    assert port._sweep_cursor == ref._sweep_cursor == 128
    assert port.sweep(now_ms=now + 2_000) + port.sweep(now_ms=now + 2_000, max_windows=1) \
        == ref.sweep(now_ms=now + 2_000) + ref.sweep(now_ms=now + 2_000, max_windows=1)
    assert port.cache_size() == ref.cache_size() == 0
    assert_same_state(port, ref)
    # Freed slots come back in the reference's order: new keys land alike.
    reqs = [RateLimitReq(name="again", unique_key=f"{i}", hits=2, limit=10, duration=1_000)
            for i in range(100)]
    _both(port, ref, reqs, now_ms=now + 3_000)
    assert_same_state(port, ref)


def _loader_traffic(cls):
    def req(key, hits=1, **kw):
        return cls(name="test_store", unique_key=key, hits=hits, limit=10, duration=60_000, **kw)

    return ([req(f"s{i}", hits=i % 4) for i in range(40)]
            + [req(f"l{i}", hits=2, algorithm=Algorithm.LEAKY_BUCKET, burst=10)
               for i in range(10)])


def test_sharded_loader_round_trip():
    """tests/test_store.py:221: save and load continue buckets exactly."""
    eng1, ref1 = _pair(64)
    _both(eng1, ref1, _loader_traffic(RateLimitReq))
    loader = tstore.MemoryLoader()
    eng1.save(loader)
    assert len(loader.items) == 50
    ref_loader = jstore.MemoryLoader()
    ref1.save(ref_loader)
    assert [dataclasses.asdict(i) for i in loader.items] == [
        dataclasses.asdict(i) for i in ref_loader.items]  # shard-major, as the reference's
    eng2, ref2 = _pair(64)
    assert eng2.load(loader) == ref2.load(ref_loader) == 50
    assert eng2.cache_size() == 50
    r = _both(eng2, ref2, [RateLimitReq(name="test_store", unique_key="s3", hits=0, limit=10,
                                        duration=60_000)])[0]
    assert r.remaining == 10 - 3
    rl = _both(eng2, ref2, [RateLimitReq(name="test_store", unique_key="l0", hits=0, limit=10,
                                         duration=60_000, algorithm=Algorithm.LEAKY_BUCKET,
                                         burst=10)])[0]
    assert rl.remaining == 8
    assert_same_state(eng2, ref2)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_sharded_npz_checkpoint_crosses_packages(tmp_path, direction):
    """An npz written by one package's sharded engine loads in the
    other's; the files are equal byte for byte, and the buckets continue
    as in the engine that never stopped."""
    port1, ref1 = _pair(32)
    rng = np.random.default_rng(4)
    reqs = [RateLimitReq(name="np", unique_key=f"x{int(rng.integers(300))}",
                         hits=int(rng.integers(0, 4)), algorithm=int(rng.integers(0, 2)),
                         burst=int(rng.choice([0, 8])), limit=int(rng.choice([5, 10**6])),
                         duration=int(rng.choice([1000, 60_000]))) for _ in range(400)]
    for lo in range(0, 400, 50):
        _both(port1, ref1, reqs[lo:lo + 50])
        _advance(333, port1, ref1)
    ppath, rpath = os.fspath(tmp_path / "port.npz"), os.fspath(tmp_path / "ref.npz")
    port1.save(NpzFileLoader(ppath))
    ref1.save(RefNpzFileLoader(rpath))
    with np.load(rpath, allow_pickle=True) as a, np.load(ppath, allow_pickle=True) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    port2, ref2 = _pair(32)
    _advance(8 * 333, port2, ref2)
    path = rpath if direction == "jax_to_port" else ppath
    assert port2.load(NpzFileLoader(path)) == ref2.load(RefNpzFileLoader(path)) \
        == port1.cache_size()
    assert_same_state(port2, ref2)
    _advance(500, port1, ref1, port2, ref2)
    a = _both(port1, ref1, reqs[:80])
    b = _both(port2, ref2, reqs[:80])
    assert _answers(a) == _answers(b)
    assert_same_state(port2, ref2)


def test_store_stream_equals_the_reference():
    """A write-through store on both sharded engines, 2 slots a shard for
    60 keys: keys are evicted and brought back from the store within a
    batch, so rounds k > 0 run their clears (K2), restores (K5) and apply
    (K11).  Answers, state words and stores equal."""
    port, ref = _pair(2, store=True)
    rng = np.random.default_rng(2026)
    keys = [f"z{i}" for i in range(60)]
    for b in range(30):
        reqs = [RateLimitReq(name="test_store", unique_key=keys[int(rng.integers(60))],
                             hits=int(rng.choice([0, 1, 1, 2, 5])),
                             algorithm=int(rng.integers(0, 2)), burst=int(rng.choice([0, 6])),
                             limit=int(rng.choice([5, 20])),
                             duration=int(rng.choice([400, 60_000])),
                             behavior=8 if rng.random() < 0.05 else 0)
                for _ in range(int(rng.integers(4, 40)))]
        _both(port, ref, reqs)
        _advance(int(rng.choice([0, 50, 300])), port, ref)
    assert_same_state(port, ref)
    assert_same_tables(port, ref)
    assert (port.store.on_change_calls, port.store.get_calls, port.store.remove_calls) == (
        ref.store.on_change_calls, ref.store.get_calls, ref.store.remove_calls)
    assert {k: dataclasses.asdict(v) for k, v in port.store.data.items()} == {
        k: dataclasses.asdict(v) for k, v in ref.store.data.items()}
    assert sum(t.evictions for t in port.tables) > 0
    with pytest.raises(RuntimeError):
        port.apply_columnar(*_columns(reqs))


# ---------------------------------------------------------------------------
# The service, the h2 front and the daemon over sharded engines.


def _instances(ledger: bool, shard_capacity=64):
    behaviors = BehaviorConfig(global_sync_wait=3600.0, adaptive_windows=False)
    port_eng, ref_eng = _pair(shard_capacity)
    if ledger:
        ref = RefInstance(RefConfig(behaviors=behaviors, ledger=True, ledger_hot_threshold=2,
                                    ledger_settle_interval=0), ref_eng)
        port = V1Instance(port_eng, ledger=True,
                          ledger_opts=dict(hot_threshold=2, settle_interval=0))
    else:
        ref = RefInstance(RefConfig(behaviors=behaviors, ledger=False), ref_eng)
        port = V1Instance(port_eng, ledger=False)
    return port, ref


def _service_stream(rng, n):
    reqs = []
    for i in range(n):
        beh = int(rng.choice([0, 0, 0, 2, 4, 8, 16]))
        hot = rng.random() < 0.3
        reqs.append(RateLimitReq(
            name="api", unique_key=f"h{int(rng.integers(6))}" if hot else
            f"u{int(rng.integers(900))}",
            hits=int(rng.choice([0, 1, 1, 2, 5])), limit=int(rng.choice([5, 100])) if not hot
            else 50, duration=1 if beh == 4 else 60_000, algorithm=0 if hot else
            int(rng.integers(0, 2)), behavior=beh if not hot else 0,
            burst=int(rng.choice([0, 3]))))
    return reqs


@pytest.mark.parametrize("ledger", [False, True])
def test_service_stream_over_sharded_engines(ledger):
    """A seeded stream through `V1Instance` over both packages' sharded
    engines, ledger off or on: dataclass batches (GLOBAL, Gregorian,
    RESET_REMAINING, MULTI_REGION, hot keys) and decoded columnar batches
    through `serve_decoded_local` (route hashes from the decode); answers
    equal, and with the ledger on its counters and, after the settles, the
    state words."""
    port, ref = _instances(ledger)
    rng = np.random.default_rng(99)
    try:
        for b in range(24):
            reqs = _service_stream(rng, int(rng.integers(5, 120)))
            if b % 2:
                got = port.get_rate_limits(reqs)
                want = ref.get_rate_limits([RefReq(**vars(r)) for r in reqs])
                ref.global_mgr.flush_now()
                assert _answers(got) == _answers(want), b
            else:
                plain = [r for r in reqs if not int(r.behavior) & COLUMNAR_DISQUALIFIERS]
                body = pb.GetRateLimitsReq(requests=[
                    pb.RateLimitReq(name=r.name, unique_key=r.unique_key, hits=r.hits,
                                    limit=r.limit, duration=r.duration, algorithm=r.algorithm,
                                    behavior=r.behavior, burst=r.burst)
                    for r in plain]).SerializeToString()
                dec = decode_reqs(body, 1000, COLUMNAR_DISQUALIFIERS)
                if dec is None:
                    continue
                got = port.serve_decoded_local(dec)
                want = ref.serve_decoded_local(dec)
                for x, y in zip(got, want):
                    np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=str(b))
            step = int(rng.choice([0, 100, 1500]))
            _advance(step, port.engine, ref.engine)
        if ledger:
            assert port.ledger.flush_settles() == ref.ledger.flush_settles()
            stats, ref_stats = port.ledger.stats(), ref.ledger.stats()
            stats.pop("settle_lag_ms_mean")
            ref_stats.pop("settle_lag_ms_mean")
            assert ref_stats.pop("readonly_entries") == 0
            assert stats == ref_stats
            assert stats["leases_granted"] > 0
        assert_same_state(port.engine, ref.engine)
        # The GLOBAL read-backs ride in the batch's engine call here and
        # are calls of their own in the reference (ROADMAP C2): the same
        # rows, other batch counts.
        assert port.engine.requests_total == ref.engine.requests_total
    finally:
        port.close()
        ref.close()


def _ref_words_by_shard_slot(eng):
    return {f: np.asarray(getattr(eng._state, f)) for f in eng._state._fields}


def _h2_stream_over_sharded_engines(ledger: bool, feeder: bool):
    port, ref = _instances(ledger)
    ref_front = RefFront(ref, window_s=0.001, native_feeder=feeder)
    front = H2FastFront(port, window_s=0.001, native_feeder=feeder)
    try:
        assert (front.feeder is not None) == feeder
        ref_ch = grpc.insecure_channel(ref_front.address)
        port_ch = grpc.insecure_channel(front.address)
        codes = []
        for i, (body, step) in enumerate(_stream_rpcs(seed=11)):
            _advance(step, port.engine, ref.engine)
            want = _raw_call(ref_ch, body)
            got = _raw_call(port_ch, body)
            assert got == want, i
            codes.append(got[0])
        assert codes.count(12) == 5
        if ledger:
            assert port.ledger.flush_settles() == ref.ledger.flush_settles()
        assert_same_state(port.engine, ref.engine)
        assert sum(t.evictions for t in port.engine.tables) > 0
        st, ref_st = (settled_stats(f, len(codes)) for f in (front, ref_front))
        for k in ("rpcs", "windows", "errors", "feeder_front_rpcs"):
            assert st[k] == ref_st[k], k
        assert (st["feeder_front_rpcs"] > 0) == feeder
    finally:
        front.close()
        ref_front.close()
        ref.close()
        port.close()


@pytest.mark.parametrize("ledger", [False, True])
def test_h2_stream_over_sharded_engines(ledger):
    """The h2 parity stream (tests/test_torch_h2_fast.py) through the
    reference's front over its sharded engine and the port's front over
    the port's, both serving through their columnar feeders, as by
    default: grpc-status and response bytes (the feeders' retry hints
    included) RPC by RPC, the fronts' counters, and the state words at
    the end; 64 slots a shard under a 700-key pool, so evictions run
    too."""
    _h2_stream_over_sharded_engines(ledger, feeder=True)


@pytest.mark.parametrize("ledger", [False, True])
def test_h2_byte_path_over_sharded_engines(ledger):
    """The same stream through both fronts' byte window paths
    (GUBER_NATIVE_FEEDER=0)."""
    _h2_stream_over_sharded_engines(ledger, feeder=False)


def test_fast_front_sharded_daemon():
    """tests/test_h2_fast.py:113: the daemon with device_count=8 builds the
    sharded engine, and its h2 front serves through it."""
    conf = DaemonConfig(http_listen_address="127.0.0.1:0", cache_size=1 << 12,
                        device_count=8, sweep_interval=0.0, h2_fast_address="127.0.0.1:0",
                        h2_fast_window=0.001)
    d = spawn_daemon(conf, device="cpu")
    try:
        eng = d.instance.engine
        assert hasattr(eng, "tables") and eng.n_shards == 8
        assert eng.shard_capacity == (1 << 12) // 8
        body = pb.GetRateLimitsReq(requests=[
            pb.RateLimitReq(name="sh", unique_key=f"{i}k", hits=1, limit=5, duration=60_000)
            for i in range(20)]).SerializeToString()
        code, msg = _raw_call(grpc.insecure_channel(d.h2_fast_address), body)
        assert code == 0
        assert [r.remaining for r in pb.GetRateLimitsResp.FromString(msg).responses] == [4] * 20
    finally:
        d.close()


def test_device_count_from_the_environment(monkeypatch):
    monkeypatch.setenv("GUBER_DEVICE_COUNT", "4")
    assert setup_daemon_config().device_count == 4
    monkeypatch.setenv("GUBER_DEVICE_COUNT", "0")
    assert setup_daemon_config().device_count is None
    monkeypatch.delenv("GUBER_DEVICE_COUNT")
    assert setup_daemon_config().device_count is None
    d = spawn_daemon(DaemonConfig(http_listen_address="127.0.0.1:0", cache_size=100,
                                  sweep_interval=0.0, device_count=1), device="cpu")
    try:
        assert isinstance(d.instance.engine, DecisionEngine)
    finally:
        d.close()


N_THREADS = 8
ROUNDS = 12


def test_sharded_storm_exact_accounting():
    """tests/test_sharded_storm.py: racing columnar callers (decoded wire
    batches through serve_decoded_local, route hashes included) and
    dataclass callers (duplicate keys: the collapse) on the sharded
    engine; every answer decodes with no error, and the shared key
    consumed exactly the sum of all hits."""
    conf = DaemonConfig(http_listen_address="127.0.0.1:0", cache_size=8 * 4096,
                        device_count=8, sweep_interval=0.0)
    d = spawn_daemon(conf, device="cpu")
    inst = d.instance
    errs = []

    def payload(tid, rep):
        reqs = [pb.RateLimitReq(name="storm", unique_key="shared", hits=1, limit=10**9,
                                duration=3_600_000) for _ in range(3)]
        reqs += [pb.RateLimitReq(name="storm", unique_key=f"p{tid}_{rep}_{i}", hits=1,
                                 limit=10**9, duration=3_600_000) for i in range(20)]
        return pb.GetRateLimitsReq(requests=reqs).SerializeToString()

    def wire_worker(tid):
        try:
            for rep in range(ROUNDS):
                dec = decode_reqs(payload(tid, rep), 1000, COLUMNAR_DISQUALIFIERS)
                st, _lim, _rem, _rst = inst.serve_decoded_local(dec)
                assert len(st) == 23 and (np.asarray(st) == int(Status.UNDER_LIMIT)).all()
        except Exception as e:  # noqa: BLE001
            errs.append(e)

    def dataclass_worker(tid):
        try:
            for rep in range(ROUNDS):
                reqs = [RateLimitReq(name="storm", unique_key="shared", hits=1, limit=10**9,
                                     duration=3_600_000)] * 2 + [
                    RateLimitReq(name="storm", unique_key=f"d{tid}_{rep}", hits=1,
                                 limit=10**9, duration=3_600_000)]
                assert all(r.error == "" for r in inst.get_rate_limits(reqs))
        except Exception as e:  # noqa: BLE001
            errs.append(e)

    threads = [threading.Thread(target=wire_worker, args=(t,)) for t in range(N_THREADS // 2)]
    threads += [threading.Thread(target=dataclass_worker, args=(t,))
                for t in range(N_THREADS // 2)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert not errs, errs[:2]
        assert all(not t.is_alive() for t in threads)
        if inst.ledger is not None:
            inst.ledger.flush_settles()
        expected = (N_THREADS // 2) * ROUNDS * 3 + (N_THREADS // 2) * ROUNDS * 2
        probe = inst.get_rate_limits([RateLimitReq(name="storm", unique_key="shared", hits=0,
                                                   limit=10**9, duration=3_600_000)])[0]
        assert 10**9 - probe.remaining == expected
    finally:
        d.close()


def test_engine_rejects_bad_shapes():
    with pytest.raises(ValueError):
        ShardedDecisionEngine(0, n_shards=2, device="cpu")
    with pytest.raises(ValueError):
        ShardedDecisionEngine(8, n_shards=0, device="cpu")
    eng = ShardedDecisionEngine(8, n_shards=2, device="cpu")
    assert eng.state.meta.shape == (2, 8) and eng.capacity == 16
    with pytest.raises(ValueError):
        shard_step(eng._state, torch.zeros((3, 16, 64), dtype=torch.int32), 8,
                   torch.zeros((3, 0), dtype=torch.int32))
    assert shard_clear_rows([[5, 1], []], 8).tolist() == [[1, 5] + list(range(10, 24)),
                                                           list(range(8, 24))]
    assert Behavior.GLOBAL & COLUMNAR_DISQUALIFIERS
