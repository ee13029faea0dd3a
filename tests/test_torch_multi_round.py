"""The port's multi-round step against the JAX package, bit for bit.

`multi_fused_step` runs a batch's R rounds, each after its eviction
clears, over one ragged pin (ops/bucket_kernel.py `pack_rounds_host`).
On CPU tensors it is the plain `multi_fused_step_reference`, held here
against the JAX package on XLA:CPU:

* the JAX `multi_fused_step` (`_multi_fused_core`, a `lax.scan` over
  equal-width rounds) at R in {1, 2, 3, 16};
* the JAX `clear_occupied` then `fused_step` (`_fused_step_core`) per
  round, on ragged rounds with clears in some of them, a slot that recurs
  in every round, and the extreme-value batch;
* the JAX `DecisionEngine` on a 5-round batch with evictions, which the
  port runs as one dispatch.

Inputs are seeded numpy; the tolerance is exact (every word is an
integer).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_engine import _advance, _assert_same_state, _columnar_step, _pair

from gubernator_tpu.ops import bucket_kernel as bk
from gubernator_tpu_torch.ops import bucket_kernel as tk
from gubernator_tpu_torch.ops import fused_step as fs
from gubernator_tpu_torch.types import Behavior

GREG = int(Behavior.DURATION_IS_GREGORIAN)
RESET = int(Behavior.RESET_REMAINING)
HOT = 7  # a slot in every round


def _rand_logical(rng, n, now):
    return dict(
        occupied=rng.random(n) < 0.75,
        algo=rng.integers(0, 2, n),
        status=rng.integers(0, 2, n),
        t0=now - rng.integers(0, 5_000, n),
        invalid=np.where(rng.random(n) < 0.2, now + rng.integers(-50, 50, n), 0),
        expire=now + rng.integers(-100, 2_000, n),
        duration=rng.choice([0, 1, 40, 1000, 30_000], n),
        limit=rng.choice([0, 1, 5, 100, 10**12], n),
        remaining=rng.integers(-5, 200, n),
        remf_hi=rng.integers(-3, 200, n).astype(np.int32),
        remf_lo=rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32),
        burst=rng.choice([0, 0, 5, 20], n),
    )


def _rand_cols(rng, m, now):
    """The 8 request columns (algo … greg_expire) of m lanes."""
    return [
        rng.integers(0, 3, m),
        rng.choice([0, 0, GREG, RESET, GREG | RESET], m),
        rng.choice([-3, 0, 1, 1, 2, 5, 100], m),
        rng.choice([-1, 0, 1, 5, 100, 10**12], m),
        rng.choice([0, 1, 40, 1000, 30_000], m),
        rng.choice([0, 0, 5, 20, -7], m),
        rng.choice([60_000, 3_600_000, 86_400_000], m),
        now + rng.integers(0, 100_000, m),
    ]


def _rand_slots(rng, cap, m):
    """m unique sorted slots of [0, cap), HOT among them."""
    rest = rng.choice(np.setdiff1d(np.arange(cap), [HOT]), m - 1, replace=False)
    return np.sort(np.append(rest, HOT)).astype(np.int32)


def _jax_state(words):
    return bk.BucketState(*(jnp.asarray(words[f]) for f in bk.BucketState._fields))


def _assert_state_equal(jstate, tstate, ctx):
    got = tk.state_to_numpy(tstate)
    for f in bk.BucketState._fields:
        assert np.array_equal(got[f], np.asarray(getattr(jstate, f))), (ctx, f)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _port_step(state, packed):
    return fs.multi_fused_step(state, _t(packed.pin), _t(packed.round_off),
                               _t(packed.clear_off), _t(packed.clear_slots))


@pytest.mark.parametrize("n_rounds", [1, 2, 3, 16])
def test_plain_multi_round_bit_equal_to_jax_multi_fused_core(n_rounds):
    """Equal-width rounds: one port call over the rounds laid along the
    lanes equals the JAX scan over the stacked pins, in pout and all 12
    columns, call after call."""
    rng = np.random.default_rng(100 + n_rounds)
    cap, width, now = 256, 64, 5_000_000
    words = bk.pack_state_host(_rand_logical(rng, cap, now))
    jstate, port = _jax_state(words), tk.state_from_numpy(words, "cpu")
    for it in range(3):
        now += int(rng.integers(0, 400))
        pins = []
        for _ in range(n_rounds):
            m = int(rng.integers(1, width + 1))
            pins.append(tk.pack_batch_host(width, now, cap, _rand_slots(rng, cap, m),
                                           *_rand_cols(rng, m, now)))
        jstate, want = bk.multi_fused_step(jstate, jnp.asarray(np.stack(pins)))
        want = np.concatenate(list(np.asarray(want)), axis=1)  # [R, 5, W] -> [5, R*W]
        round_off = np.arange(n_rounds + 1, dtype=np.int32) * width
        got = fs.multi_fused_step(port, _t(np.concatenate(pins, axis=1)), _t(round_off),
                                  torch.zeros(n_rounds + 1, dtype=torch.int32),
                                  torch.tensor([cap], dtype=torch.int32))
        assert np.array_equal(got.numpy(), want), it
        _assert_state_equal(jstate, port, it)


def _per_round_jax(jstate, packed, cap):
    """The reference's sequence: per round, `clear_occupied` (padded as
    the engine pads it) then `fused_step` on the round's own pin."""
    ro, co = packed.round_off.tolist(), packed.clear_off.tolist()
    outs = []
    for r in range(len(ro) - 1):
        if co[r + 1] > co[r]:
            c = np.arange(cap, cap + 16, dtype=np.int32)
            c[: co[r + 1] - co[r]] = packed.clear_slots[co[r] : co[r + 1]]
            jstate = jstate._replace(meta=bk.clear_occupied(jstate.meta, jnp.asarray(c)))
        seg = packed.pin[:, ro[r] : ro[r + 1]].copy()
        seg[0, :2] = packed.pin[0, :2]
        jstate, out = bk.fused_step(jstate, jnp.asarray(seg))
        outs.append(np.asarray(out))
    return jstate, np.concatenate(outs, axis=1)


def _ragged_case(rng, cap, now):
    """Rounds of 50, 3, 64, 1, 33 and 17 lanes (widths 64, 32, 64, 32, 64,
    32); HOT in every round; clears in rounds 1, 3 and 4, among them
    slots that earlier rounds wrote and that the same round then reuses."""
    counts = [50, 3, 64, 1, 33, 17]
    slots = [_rand_slots(rng, cap, m) for m in counts]
    clears = [[], [int(slots[0][0]), int(slots[0][1])], [], [HOT],
              [int(s) for s in slots[2][:5]] + [cap + 3], []]
    cols = _rand_cols(rng, sum(counts), now)
    return counts, np.concatenate(slots), cols, clears


def _extreme_case(cap, now):
    """The saturation batch of test_torch_bucket_kernel, as three rounds
    over the same 48 slots (24 + 24, then all 48 again after clearing
    four of them)."""
    big = 2**62
    m = 48
    slots = np.arange(m, dtype=np.int32)
    r = lambda vals, dt: np.resize(np.array(vals, dt), m)  # noqa: E731
    cols = [
        r([1, 1, 0, 1, 5], np.int32),
        r([0, RESET, GREG, GREG | RESET, 0, 0, 0], np.int32),
        r([0, 1, -(2**62), 2**62, 2**63 - 1, -(2**63)], np.int64),
        r([big, 2**63 - 1, 1, -(2**63), 3, big], np.int64),
        r([1, 2**63 - 1, -(2**63), 0, 7, 2**43 + 5], np.int64),
        r([0, big, -(2**63), 2**63 - 1, 1], np.int64),
        r([0, 1, 2**63 - 1, 86_400_000], np.int64),
        r([now, 2**63 - 1, -(2**63), now + 1], np.int64),
    ]
    twice = [np.concatenate([c, c]) for c in cols]
    return [24, 24, 48], np.concatenate([slots, slots]), twice, [[], [], [0, 5, 11, 47]]


def _extreme_state(cap, now):
    logical = dict(
        occupied=np.ones(cap, bool), algo=np.ones(cap, np.int64),
        status=np.zeros(cap, np.int64), t0=np.full(cap, 1), invalid=np.zeros(cap, np.int64),
        expire=np.full(cap, now + 10), duration=np.full(cap, 1), limit=np.full(cap, 2**62),
        remaining=np.zeros(cap, np.int64), remf_hi=np.full(cap, 2**31 - 1, np.int32),
        remf_lo=np.full(cap, 2**32 - 1, np.uint32), burst=np.full(cap, 2**62),
    )
    logical["algo"][::4] = 0
    return bk.pack_state_host(logical)


@pytest.mark.parametrize("case", ["ragged", "extreme"])
def test_plain_multi_round_bit_equal_to_per_round_clear_and_step(case):
    rng = np.random.default_rng(7)
    cap, now = 256, 1_700_000_000_000
    words = (bk.pack_state_host(_rand_logical(rng, cap, now)) if case == "ragged"
             else _extreme_state(cap, now))
    jstate, port = _jax_state(words), tk.state_from_numpy(words, "cpu")
    for it in range(3):
        now += int(rng.integers(1, 400))
        counts, slots, cols, clears = (_ragged_case(rng, cap, now) if case == "ragged"
                                       else _extreme_case(cap, now))
        packed = tk.pack_rounds_host(now, cap, counts, slots, cols, clears)
        jstate, want = _per_round_jax(jstate, packed, cap)
        got = _port_step(port, packed)
        assert np.array_equal(got.numpy(), want), it
        _assert_state_equal(jstate, port, it)


def test_pack_rounds_host_layout():
    """R = 1 at a pow2 width is pack_batch_host's buffer; ragged rounds
    are 32-lane aligned, padded with capacity + j, carry their `now`
    header in row 0 of each round's first two lanes, and carry their
    clears in CSR form; the views share one flat buffer."""
    rng = np.random.default_rng(11)
    cap, now = 1000, 1_760_000_000_123
    slots = np.sort(rng.choice(cap, 40, replace=False)).astype(np.int32)
    cols = _rand_cols(rng, 40, now)
    one = tk.pack_rounds_host(now, cap, [40], slots, cols, [[]], align=64)
    assert np.array_equal(one.pin, tk.pack_batch_host(64, now, cap, slots, *cols))
    assert one.widest == 64 and list(one.clear_slots) == [cap]

    counts = [33, 0, 5]
    packed = tk.pack_rounds_host(now, cap, counts, np.concatenate([slots[:33], slots[:5]]),
                                 [np.concatenate([c[:33], c[:5]]) for c in cols],
                                 [[1, 2], [], [3]])
    assert packed.round_off.tolist() == [0, 64, 64, 96]
    assert packed.clear_off.tolist() == [0, 2, 2, 3]
    assert packed.clear_slots.tolist() == [1, 2, 3]
    assert packed.widest == 64
    assert packed.lanes.tolist() == list(range(33)) + list(range(64, 69))
    assert packed.pin[1, 33:64].tolist() == [cap + j for j in range(31)]
    assert packed.pin[1, 69:96].tolist() == [cap + j for j in range(27)]
    header = [now >> 32, np.int64(now).astype(np.int32)]
    assert packed.pin[0, :2].tolist() == packed.pin[0, 64:66].tolist() == header
    assert not np.delete(packed.pin[0], [0, 1, 64, 65]).any()
    views = tk.split_rounds(packed.buf, 96, 3)
    for v, f in zip(views, (packed.pin, packed.round_off, packed.clear_off, packed.clear_slots)):
        assert np.shares_memory(v, packed.buf) and np.array_equal(v, f)


def test_multi_round_reference_rejects_bad_offsets():
    state = tk.make_state(64, "cpu")
    pin = torch.zeros((16, 64), dtype=torch.int32)
    one = torch.tensor([64], dtype=torch.int32)
    zeros = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="round_off"):
        tk.multi_fused_step_reference(state, pin, torch.tensor([0, 32], dtype=torch.int32),
                                      zeros, one)
    with pytest.raises(ValueError, match="clear_off"):
        tk.multi_fused_step_reference(state, pin, torch.tensor([0, 64], dtype=torch.int32),
                                      torch.tensor([0, 2], dtype=torch.int32), one)
    with pytest.raises(ValueError, match="R >= 1"):
        tk.multi_fused_step_reference(state, pin, torch.tensor([0], dtype=torch.int32),
                                      torch.tensor([0], dtype=torch.int32), one)


def test_engine_one_dispatch_per_five_round_batch_with_evictions():
    """A hot key five times in a batch that also evicts (clears in rounds
    0 and 1): the port runs the batch as one dispatch of 5 rounds with its
    71 clears inside, and answers like the JAX engine, word for word."""
    ref, port = _pair(64)
    row = lambda k, hits=1: (k, 0, 0, hits, 5, 60_000, 0)  # noqa: E731
    _columnar_step(ref, port, [row(f"k{i}") for i in range(64)])
    assert (port.dispatches_total, port.rounds_total, port.clears_total) == (1, 1, 0)
    _advance(ref, port, 10)
    new = [row(f"n{i}") for i in range(70)]
    batch = [row("h")] + new[:30] + [row("h")] + new[30:60] + [row("h", 2)] * 3 + new[60:]
    _columnar_step(ref, port, batch)
    assert (port.dispatches_total, port.rounds_total, port.clears_total) == (2, 6, 71)
    assert port.table.evictions == ref.table.evictions == 71
    _advance(ref, port, 10)
    _columnar_step(ref, port, [row("h", 3), row("k0"), row("n0"), row("h")])
    assert port.dispatches_total == 3
    _assert_same_state(ref, port)
