"""K11 over a batch's rounds (ops/sharded_step.py), on the CPU.

K11 runs every round of a batch, every shard, in one launch
(csrc/sharded_step.cu `shard_rounds_kernel`).  The card is needed to run
the kernel; its plain version, the host packing and its ownership plan
are not:

* `sharded_multi_fused_step_reference` (K11's plain version, over a pin
  made by `pack_shard_rounds`) against the JAX package's
  `jax.vmap(_clear_occupied_impl)` then `jax.vmap(_fused_step_core)`
  applied round after round (gubernator_tpu/parallel/sharded_engine.py:338-339),
  at 1, 2, 4 and 8 shards, with slots that recur in every round, clears
  in rounds after the first and padding lanes; each round of the packed
  pin is the reference's own one-round buffer (`pack_batch_host`).
* Streams through `ShardedDecisionEngine` against the reference's sharded
  engine: a write-through `MemoryStore` under eviction pressure, so that
  store restores fall in rounds after the first (K2 and K5 between two
  K11 launches of one batch), and multi-round columnar batches on the
  per-shard path (`_flat_ok` false): answers, state words, the store,
  `rounds_total`, and the launches a batch (one K11 a restore segment).
* A numpy walk of K11's slot-range plan: block (b, sh) owns the slots
  from lane b·S of the widest round to lane (b+1)·S, S = 64 at R = 1 and
  32 above; every lane of every round is run by one block of its shard,
  every slot a launch touches (lanes and clears) by one block only, and
  running the blocks one by one, in any order within a round, gives the
  plain result.

Inputs come from seeded generators; tolerance: bit-equal.
"""

from __future__ import annotations

import dataclasses
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gubernator_tpu.ops.bucket_kernel as jbk
from gubernator_tpu_torch.ops import bucket_kernel as tk
from gubernator_tpu_torch.ops import sharded_step as ss
from gubernator_tpu_torch.types import RateLimitReq
from test_torch_sharded import (
    _advance,
    _assert_words,
    _both,
    _both_columnar,
    _pair,
    _port_state,
    _ref_state,
    _request_cols,
    _sharded_words,
    assert_same_state,
    assert_same_tables,
)

NOW = 1_760_000_000_000
ROUND_THREADS = 64  # csrc/sharded_step.cu kRoundThreads


def round_span(n_rounds: int) -> int:
    """The lanes of the widest round one K11 block owns: all its threads
    at R = 1, half above (csrc/sharded_step.cu `guber_shard_step`)."""
    return ROUND_THREADS if n_rounds == 1 else ROUND_THREADS // 2


def _rounds(rng, n_sh, cap, n_rounds, *, recur=True):
    """A batch's rounds: per round and shard a set of unique slots (some
    recurring in every round), and per round the shards' clears (none in
    round 0 of some calls, lane slots and other slots later).  Returns
    (rnd, shard, slot, clears)."""
    hot = rng.choice(cap, 3, replace=False)  # slots in every round of shard 0
    rnd, shard, slot, clears = [], [], [], []
    for r in range(n_rounds):
        per_round = []
        for sh in range(n_sh):
            m = int(rng.integers(0, 70)) if (r + sh) % 5 else 0
            s = set(rng.choice(cap, m, replace=False).tolist())
            if recur and sh == 0:
                s |= set(hot.tolist())
            s = sorted(s)
            rnd += [r] * len(s)
            shard += [sh] * len(s)
            slot += s
            own = list(rng.choice(s, min(2, len(s)), replace=False)) if s and r else []
            others = [int(x) for x in rng.choice(cap, 3, replace=False)] if r % 2 else []
            per_round.append(sorted({int(x) for x in own} | set(others)))
        clears.append(per_round if any(per_round) else None)
    return (np.asarray(rnd, np.int64), np.asarray(shard, np.int64), np.asarray(slot, np.int64),
            clears)


def _packed(rng, n_sh, cap, n_rounds, **kw):
    rnd, shard, slot, clears = _rounds(rng, n_sh, cap, n_rounds, **kw)
    cols = _request_cols(rng, len(rnd), NOW)
    return ss.pack_shard_rounds(NOW, cap, n_sh, n_rounds, rnd, shard, slot, cols, clears), (
        rnd, shard, slot, cols, clears)


@pytest.mark.parametrize("n_sh", [1, 2, 4, 8])
def test_plain_rounds_equal_the_vmapped_reference_round_after_round(n_sh):
    rng = np.random.default_rng(160 + n_sh)
    cap, n_rounds = 256, 5
    words = _sharded_words(rng, n_sh, cap, NOW)
    packed, (rnd, shard, slot, cols, clears) = _packed(rng, n_sh, cap, n_rounds)
    ro, co = packed.round_off.tolist(), packed.clear_off.tolist()
    assert any(co[r + 1] > co[r] for r in range(1, n_rounds)), "clears after round 0"
    ref = _ref_state(words)
    ref_out = []
    for r in range(n_rounds):
        # Each round of the pin is the reference's one-round buffer.
        seg = packed.pin[:, :, ro[r] : ro[r + 1]]
        for sh in range(n_sh):
            mine = (rnd == r) & (shard == sh)
            order = np.argsort(slot[mine])
            want = tk.pack_batch_host(ro[r + 1] - ro[r], NOW, cap,
                                      slot[mine][order].astype(np.int32),
                                      *(np.asarray(c)[mine][order] for c in cols))
            np.testing.assert_array_equal(seg[sh], want)
        if co[r + 1] > co[r]:
            rows = jnp.asarray(packed.clear_slots[:, co[r] : co[r + 1]])
            ref = ref._replace(meta=jax.vmap(jbk._clear_occupied_impl)(ref.meta, rows))
        ref, out = jax.vmap(jbk._fused_step_core)(ref, jnp.asarray(seg))
        ref_out.append(np.asarray(out))
    state = _port_state(words)
    pout = ss.shard_step(state, torch.from_numpy(packed.pin), cap,
                         torch.from_numpy(packed.clear_slots), torch.from_numpy(packed.round_off),
                         torch.from_numpy(packed.clear_off), widest=packed.widest)
    np.testing.assert_array_equal(pout.numpy(), np.concatenate(ref_out, axis=2))
    _assert_words(state, ref, n_sh)
    # Each request's answer sits at its lane of its shard.
    st, _rem, _rst = ss.unpack_shard_rounds(pout.numpy(), shard, packed.lanes)
    np.testing.assert_array_equal(st, pout.numpy()[shard, 0, packed.lanes])
    assert sorted(zip(shard.tolist(), packed.lanes.tolist())) == sorted(
        set(zip(shard.tolist(), packed.lanes.tolist())))


def test_one_round_call_is_the_case_r_1():
    """`shard_step` with no offsets (the whole pin, its clears first) and
    the R = 1 layout of `pack_shard_rounds` give the same words and
    answers."""
    rng = np.random.default_rng(7)
    n_sh, cap = 4, 512
    words = _sharded_words(rng, n_sh, cap, NOW)
    packed, _ = _packed(rng, n_sh, cap, 1)
    a, b = _port_state(words), _port_state(words)
    pin, rows = torch.from_numpy(packed.pin), torch.from_numpy(packed.clear_slots)
    got = ss.shard_step(a, pin, cap, rows)
    want = ss.shard_step(b, pin, cap, rows, torch.from_numpy(packed.round_off),
                         torch.from_numpy(packed.clear_off), widest=packed.widest)
    assert torch.equal(got, want)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    with pytest.raises(ValueError):
        ss.shard_step(a, pin, cap, rows, torch.from_numpy(packed.round_off))


# ---------------------------------------------------------------------------
# The engine: restores in rounds after the first, one K11 a segment.


class _Events:
    """The order of K11 launches and K5 restores within each batch of a
    port engine."""

    def __init__(self, eng):
        self.batch: list = []
        launch, restore = eng._launch_packed, eng._apply_shard_restores

        def launched(*a, **kw):
            self.batch.append("K11")
            return launch(*a, **kw)

        def restored(*a, **kw):
            self.batch.append("K5")
            return restore(*a, **kw)

        eng._launch_packed, eng._apply_shard_restores = launched, restored


def test_store_restores_after_the_first_round_equal_the_reference():
    """2 slots a shard for 40 keys and batches with repeated keys: evicted
    keys come back from the store in rounds k > 0, so a batch runs K11
    (the rounds before), K2 + K5 (the restore round's clears and
    restores), then K11 again from that round.  Answers, state words,
    store, tables and rounds_total as the reference's."""
    port, ref = _pair(2, store=True, n_shards=4)
    events = _Events(port)
    rng = np.random.default_rng(2027)
    keys = [f"r{i}" for i in range(40)]
    mid_restores = 0
    for b in range(40):
        pool = keys[: int(rng.integers(6, 40))]
        reqs = [RateLimitReq(name="rounds", unique_key=pool[int(rng.integers(len(pool)))],
                             hits=int(rng.choice([0, 1, 1, 2])), algorithm=int(rng.integers(0, 2)),
                             limit=int(rng.choice([5, 20])), burst=int(rng.choice([0, 6])),
                             duration=int(rng.choice([400, 60_000])),
                             behavior=8 if rng.random() < 0.05 else 0)
                for _ in range(int(rng.integers(4, 30)))]
        events.batch = []
        d0 = port.dispatches_total
        _both(port, ref, reqs)
        seq = events.batch
        k11 = seq.count("K11")
        # One K11 a restore segment: a restore after a launch opens another.
        assert k11 == 1 + sum(1 for i, e in enumerate(seq) if e == "K5" and "K11" in seq[:i])
        mid_restores += sum(1 for i, e in enumerate(seq) if e == "K5" and "K11" in seq[:i])
        assert port.dispatches_total - d0 >= k11
        _advance(int(rng.choice([0, 50, 300])), port, ref)
    assert mid_restores > 0, "no batch restored a key in a round after the first"
    assert_same_state(port, ref)
    assert_same_tables(port, ref)
    assert port.rounds_total == ref.rounds_total
    assert {k: dataclasses.asdict(v) for k, v in port.store.data.items()} == {
        k: dataclasses.asdict(v) for k, v in ref.store.data.items()}


def test_dataclass_rounds_take_one_launch_a_batch():
    """No store: a batch of several rounds (keys repeated, evictions at 8
    slots a shard) is one K11 launch, its rounds counted one by one."""
    port, ref = _pair(8, n_shards=4)
    rng = random.Random(5)
    for b in range(25):
        reqs = [RateLimitReq(name="one", unique_key=f"k{rng.randint(0, 60)}",
                             hits=rng.choice([0, 1, 2]), limit=rng.choice([3, 9]),
                             duration=rng.choice([500, 60_000]), algorithm=rng.randint(0, 1),
                             behavior=8 if rng.random() < 0.3 else 0)
                for _ in range(rng.randint(2, 60))]
        d0 = port.dispatches_total
        _both(port, ref, reqs)
        assert port.dispatches_total - d0 == 1
        _advance(rng.choice([0, 100, 2000]), port, ref)
    assert_same_state(port, ref)
    assert port.rounds_total == ref.rounds_total
    assert port.dispatches_total == 25 < port.rounds_total


def test_columnar_per_shard_rounds_take_one_launch_a_batch():
    """The per-shard columnar path (`_flat_ok` false): multi-round batches
    with evictions and a chunked wide round (max_kernel_width 32) run as
    one K11 launch each; answers, words and rounds as the reference's."""
    port, ref = _pair(24, n_shards=4)
    port._flat_ok = ref._flat_ok = False
    port.max_kernel_width = ref.max_kernel_width = 32
    rng = random.Random(9)
    for step in range(12):
        reqs = [RateLimitReq(name="nf", unique_key=f"{rng.randint(0, 200)}c",
                             hits=rng.randint(0, 2), limit=7, duration=60_000,
                             algorithm=rng.randint(0, 1), burst=4,
                             behavior=8 if step % 2 else 0)
                for _ in range(rng.randint(1, 200))]
        # Repeats with other fields: the batch does not collapse.
        reqs += [RateLimitReq(name="nf", unique_key=reqs[0].unique_key, hits=1, limit=7,
                              duration=60_000, burst=4, behavior=8)] * 3
        d0 = port.dispatches_total
        _both_columnar(port, ref, reqs)
        assert port.dispatches_total - d0 == 1
        _advance(300, port, ref)
    assert_same_state(port, ref)
    assert port.rounds_total == ref.rounds_total


# ---------------------------------------------------------------------------
# The numpy walk of K11's slot-range plan.


def slot_range_plan(packed, n_sh: int, cap: int):
    """K11's plan as csrc/sharded_step.cu computes it: per shard, the
    blocks' slot ranges (from the widest round's lanes b·S) and, per round,
    each block's lanes (lower bounds of its range) and in-range clears.
    Returns (blocks, {(sh, b): [(lanes, clear entries) a round]})."""
    ro, co = packed.round_off.astype(np.int64), packed.clear_off.astype(np.int64)
    n_rounds = len(ro) - 1
    widths = np.diff(ro)
    wr = int(np.argmax(widths))  # the first on a tie
    ww = int(widths[wr])
    span = round_span(n_rounds)
    blocks = max(1, -(-packed.widest // span))
    assert ww == packed.widest
    plan = {}
    for sh in range(n_sh):
        slots = packed.pin[sh, 1].astype(np.int64)
        row = packed.clear_slots[sh].astype(np.int64)
        split = lambda k: np.iinfo(np.int64).max if k >= ww else slots[ro[wr] + k]  # noqa: E731
        for b in range(blocks):
            s_lo = np.iinfo(np.int64).min if b == 0 else split(b * span)
            s_hi = np.iinfo(np.int64).max if b == blocks - 1 else split((b + 1) * span)
            per_round = []
            for r in range(n_rounds):
                seg = slots[ro[r] : ro[r + 1]]
                if r == wr:
                    lo = ro[r] + min(b * span, ww)
                    hi = ro[r] + (ww if b == blocks - 1 or (b + 1) * span > ww else (b + 1) * span)
                else:
                    lo = ro[r] + np.searchsorted(seg, s_lo, "left") if b else ro[r]
                    hi = ro[r] + np.searchsorted(seg, s_hi, "left") if b < blocks - 1 else ro[r + 1]
                run = row[co[r] : co[r + 1]]
                mine = run[(run >= s_lo) & (run < s_hi) & (run >= 0) & (run < cap)]
                per_round.append((np.arange(lo, hi), mine))
            plan[(sh, b)] = per_round
    return blocks, plan


@pytest.mark.parametrize("n_sh,n_rounds", [(1, 1), (4, 1), (4, 2), (2, 5), (8, 8), (4, 33)])
def test_slot_range_plan_gives_each_slot_to_one_block(n_sh, n_rounds):
    rng = np.random.default_rng(300 + 10 * n_sh + n_rounds)
    cap = 1024
    words = _sharded_words(rng, n_sh, cap, NOW)
    packed, _ = _packed(rng, n_sh, cap, n_rounds)
    blocks, plan = slot_range_plan(packed, n_sh, cap)
    ro = packed.round_off
    span = round_span(n_rounds)
    for sh in range(n_sh):
        owner = {}  # slot -> block, over every round, lanes and clears
        for r in range(n_rounds):
            taken = np.concatenate([plan[(sh, b)][r][0] for b in range(blocks)])
            np.testing.assert_array_equal(np.sort(taken), np.arange(ro[r], ro[r + 1]))
            for b in range(blocks):
                lanes, clears = plan[(sh, b)][r]
                for s in packed.pin[sh, 1, lanes].tolist() + clears.tolist():
                    if 0 <= s < cap:
                        assert owner.setdefault(s, b) == b, (sh, r, s)
        wr = int(np.argmax(np.diff(ro)))
        assert all(len(plan[(sh, b)][wr][0]) <= span for b in range(blocks))

    # Block by block, in a shuffled order within each round, after each
    # block's clears: the plain result.
    state, want_state = _port_state(words), _port_state(words)
    want = ss.shard_step(want_state, torch.from_numpy(packed.pin), cap,
                         torch.from_numpy(packed.clear_slots), torch.from_numpy(ro),
                         torch.from_numpy(packed.clear_off))
    got = np.zeros_like(want.numpy())
    shards = tk.shard_views(state, cap)
    for r in range(len(ro) - 1):
        order = [(sh, b) for sh in range(n_sh) for b in range(blocks)]
        rng.shuffle(order)
        for sh, b in order:
            lanes, clears = plan[(sh, b)][r]
            tk.clear_occupied_reference(shards[sh].meta, torch.from_numpy(clears.astype(np.int32)))
            if len(lanes):
                now = torch.tensor(NOW, dtype=torch.int64)  # every round's header
                got[sh][:, lanes] = tk._step_lanes(shards[sh],
                                                   torch.from_numpy(packed.pin[sh][:, lanes]), now)
    np.testing.assert_array_equal(got, want.numpy())
    for x, y in zip(state, want_state):
        assert torch.equal(x, y)
