"""The port's dataclass step (`gubernator_tpu_torch.ops.apply_batch`, its
plain version on CPU tensors) against the JAX package's `apply_batch`,
bit for bit.

The same seeded state (packed with `pack_state_host`) and the same
seeded `BatchInput` go through the reference's jitted `apply_batch`
(`_apply_batch_impl`, which co-sorts the batch by slot, clears, applies
and sorts the answers back) and the port's step, which does not sort.
Lanes come in random (unsorted) order, clears hit the batch's own slots
and other slots, padding lanes hold capacity + lane, and the fields
carry Gregorian and extreme values.  The four answer columns and all 12
state words must be equal after every step.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gubernator_tpu.ops import BatchInput as JBatchInput
from gubernator_tpu.ops import apply_batch as japply_batch
from gubernator_tpu.ops import bucket_kernel as bk
from gubernator_tpu_torch import ops as tops
from gubernator_tpu_torch.ops import bucket_kernel as tk
from gubernator_tpu_torch.types import Behavior

GREG = int(Behavior.DURATION_IS_GREGORIAN)
RESET = int(Behavior.RESET_REMAINING)
I64_MIN, I64_MAX = -(2**63), 2**63 - 1


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


def _fields(rng, m, now, extreme: bool):
    """Request fields of m lanes (int64 except algo / behavior)."""
    if extreme:
        pick = lambda vals: rng.choice(np.asarray(vals, dtype=np.int64), m)  # noqa: E731
        return dict(
            algo=pick([0, 1, 5]).astype(np.int32),
            behavior=pick([0, RESET, GREG, GREG | RESET]).astype(np.int32),
            hits=pick([0, 1, -(2**62), 2**62, I64_MAX, I64_MIN]),
            limit=pick([2**62, I64_MAX, 1, I64_MIN, 3]),
            duration=pick([1, I64_MAX, I64_MIN, 0, 7, 2**43 + 5]),
            burst=pick([0, 2**62, I64_MIN, I64_MAX, 1]),
            greg_duration=pick([0, 1, I64_MAX, 86_400_000]),
            greg_expire=np.asarray([now, I64_MAX, I64_MIN, now + 1], np.int64)[
                rng.integers(0, 4, m)],
        )
    return dict(
        algo=rng.integers(0, 3, m).astype(np.int32),
        behavior=rng.choice([0, 0, GREG, RESET, GREG | RESET], m).astype(np.int32),
        hits=rng.choice([-3, 0, 1, 1, 2, 5, 100], m).astype(np.int64),
        limit=rng.choice([-1, 0, 1, 5, 100, 10**12], m).astype(np.int64),
        duration=rng.choice([0, 1, 40, 1000, 30_000], m).astype(np.int64),
        burst=rng.choice([0, 0, 5, 20, -7], m).astype(np.int64),
        greg_duration=rng.choice([60_000, 3_600_000, 86_400_000], m).astype(np.int64),
        greg_expire=(now + rng.integers(0, 100_000, m)).astype(np.int64),
    )


def _batch(rng, cap, width, now, *, extreme=False, padding_share=0.1):
    """A batch of `width` lanes in random order: unique in-range slots,
    padding lanes at cap + lane."""
    n_pad = int(width * padding_share)
    m = width - n_pad
    slot = np.empty(width, np.int32)
    slot[:m] = rng.choice(cap, m, replace=False)
    slot[m:] = cap + np.arange(m, width)
    perm = rng.permutation(width)
    slot = slot[perm]
    pad = slot >= cap
    slot[pad] = cap + np.nonzero(pad)[0]  # padding = capacity + lane, in request order
    f = _fields(rng, width, now, extreme)
    return dict(slot=slot, **f)


def _clears(rng, cap, slot):
    """Clears of some of the batch's own slots and of other slots, padded
    with distinct out-of-range slots, in random order."""
    own = slot[slot < cap]
    hit = rng.choice(own, max(1, len(own) // 8), replace=False)
    others = np.setdiff1d(rng.choice(cap, 24, replace=False), own)
    c = np.concatenate([hit, others, cap + 5000 + np.arange(7)]).astype(np.int32)
    return c[rng.permutation(len(c))]


def _j_state(words):
    return bk.BucketState(*(jnp.asarray(words[f]) for f in bk.BucketState._fields))


def _run_both(words, steps):
    jstate, port = _j_state(words), tk.state_from_numpy(words, "cpu")
    for k, (batch, clears, now) in enumerate(steps):
        jstate, want = japply_batch(
            jstate, JBatchInput(**{f: jnp.asarray(batch[f]) for f in JBatchInput._fields}),
            jnp.asarray(clears), jnp.asarray(np.int64(now)))
        got = tops.apply_batch(
            port, tops.BatchInput(**{f: torch.from_numpy(batch[f].copy())
                                     for f in tops.BatchInput._fields}),
            torch.from_numpy(clears.copy()), now)
        for name in tops.BatchOutput._fields:
            g = getattr(got, name).numpy()
            w = np.asarray(getattr(want, name))
            assert g.dtype == w.dtype, (k, name)
            assert np.array_equal(g, w), (k, name)
        got_words = tk.state_to_numpy(port)
        for f in bk.BucketState._fields:
            w = np.asarray(getattr(jstate, f))
            assert got_words[f].dtype == w.dtype, (k, f)
            assert np.array_equal(got_words[f], w), (k, f)


@pytest.mark.parametrize("width", [64, 1024])
def test_apply_batch_bit_equal_to_jax(width):
    """Random states, unsorted batches with clears on the batch's own
    slots and others, padding, Gregorian lanes: answers and words equal
    the reference's over a few steps."""
    rng = np.random.default_rng(width + 17)
    cap, now = 4096, 5_000_000
    words = bk.pack_state_host(_rand_logical(rng, cap, now))
    steps = []
    for _ in range(4):
        now += int(rng.integers(0, 400))
        b = _batch(rng, cap, width, now)
        steps.append((b, _clears(rng, cap, b["slot"]), now))
    _run_both(words, steps)


@pytest.mark.parametrize("width", [64, 1024])
def test_apply_batch_extreme_values_and_mostly_padding(width):
    """Extreme fields (saturating f64 → int64, int64 wrap, timestamps
    past the 43-bit clamp) on a saturated leaky state, then a batch that
    is 90 % padding."""
    rng = np.random.default_rng(width + 91)
    cap, now = 2048, 1_700_000_000_000
    big = 2**62
    logical = dict(
        occupied=np.ones(cap, bool), algo=np.ones(cap, np.int64), status=np.zeros(cap, np.int64),
        t0=np.full(cap, 1), invalid=np.zeros(cap, np.int64), expire=np.full(cap, now + 10),
        duration=np.full(cap, 1), limit=np.full(cap, big), remaining=np.zeros(cap, np.int64),
        remf_hi=np.full(cap, 2**31 - 1, np.int32), remf_lo=np.full(cap, 2**32 - 1, np.uint32),
        burst=np.full(cap, big),
    )
    logical["algo"][::4] = 0
    words = bk.pack_state_host(logical)
    b1 = _batch(rng, cap, width, now, extreme=True)
    b2 = _batch(rng, cap, width, now + 997, padding_share=0.9)
    _run_both(words, [(b1, _clears(rng, cap, b1["slot"]), now),
                      (b2, np.zeros(0, np.int32), now + 997)])


def test_apply_batch_exports_and_devices():
    """The package exports the reference's five names; the step runs on
    the state's device, and checks its inputs."""
    assert set(tops.__all__) == {"BucketState", "BatchInput", "BatchOutput", "apply_batch",
                                 "make_state"}
    state = tops.make_state(16, "cpu")
    b = _batch(np.random.default_rng(1), 16, 8, 1000)
    batch = tops.BatchInput(**{f: torch.from_numpy(b[f]) for f in tops.BatchInput._fields})
    out = tops.apply_batch(state, batch, torch.zeros(0, dtype=torch.int32), 1000)
    assert out.status.dtype == torch.int32 and out.remaining.dtype == torch.int64
    with pytest.raises(ValueError):
        tops.apply_batch(state, batch._replace(hits=batch.hits.to(torch.int32)),
                         torch.zeros(0, dtype=torch.int32), 1000)
    with pytest.raises(ValueError):
        tops.apply_batch(state, batch, torch.zeros(0, dtype=torch.int64), 1000)
