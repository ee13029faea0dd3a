"""K7's plan (ops/sketch.py `plan_sketch_step`) and a walk of it, on the CPU.

csrc/sketch.cu runs one K7 call in the form the plan gives: the block form
(one launch of one block; thread f takes entry f = (row f // size, lane
f % size); the row estimates, and the estimate each entry reads at its
lane's position, live in the block's shared memory) or the pair form (an
int64 scratch [depth, size] between two launches).  The card is needed to
run the kernel; the plan and the index arithmetic of its phases are not:

* for every size on the pad ladder from 64 to 2^17 and every depth from
  1 to 8, the plan covers each (row, entry) and each lane exactly once
  and stays within the card's limits (1024 threads, 232,448 B of shared
  memory a block, one block: the cluster of one);
* `walk_plan` replays a plan phase by phase with numpy (the block form:
  every thread's phase 1, then every entry's read at its lane's
  position, then every lane's minimum; the pair form: every entry into
  the scratch, then every lane) and must be bit-equal to the JAX
  package's `_sketch_step_impl` (gubernator_tpu/ops/sketch.py:99, through
  `SketchLimiter._step`) in planes and output, in both forms.

Inputs come from seeded numpy generators; tolerance: exact.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gubernator_tpu.ops import sketch as rs
from gubernator_tpu_torch.ops import sketch as ps

I32_MIN, I32_MAX = -(2**31), 2**31 - 1
LADDER = [64 << k for k in range(12)]  # 64 .. 2^17, the packer's sizes


def walk_plan(counts: np.ndarray, pin: np.ndarray, cur: int, plan) -> np.ndarray:
    """One K7 call replayed by `plan`, phase by phase; `counts` updated in
    place.  Returns int32 [2, size]."""
    _, depth, width = counts.shape
    size = pin.shape[1]
    frac = np.int64(pin[0, 2])
    out = np.zeros((2, size), np.int32)

    def estimates(r, idx, add):
        """Row estimates of entries (r, idx, add), the cells updated."""
        est = np.clip(add.astype(np.int64), I32_MIN, I32_MAX)
        ok = (idx >= 0) & (idx < width)
        rr, ii = r[ok], idx[ok]
        v = np.clip(counts[cur, rr, ii].astype(np.int64) + add[ok], I32_MIN, I32_MAX)
        prev = counts[1 - cur, rr, ii].astype(np.int64)
        counts[cur, rr, ii] = v.astype(np.int32)
        est[ok] = (prev * (ps.Q16 - frac)) // ps.Q16 + v  # numpy's // floors
        return est

    def answer(lane, m):
        u = m.astype(np.uint64)
        out[0, lane] = (u >> np.uint64(32)).astype(np.uint32).view(np.int32)
        out[1, lane] = u.astype(np.uint32).view(np.int32)

    if plan.form == "pair":
        t = np.arange(depth * size)  # (a): one thread per (row, entry)
        r, j = t // size, t % size
        row_est = estimates(r, pin[2 + 3 * r, j], pin[3 + 3 * r, j])
        lane = np.arange(size)  # (b): one thread per lane
        m = np.full(size, np.iinfo(np.int64).max)
        for r in range(depth):
            m = np.minimum(m, row_est[r * size + pin[4 + 3 * r, lane]])
        answer(lane, m)
        return out

    assert plan.form == "block"
    f = np.arange(plan.threads)  # one thread an entry
    f = f[f < depth * size]
    r, j = f // size, f % size
    smem = np.zeros(2 * depth * size, np.int64)  # est, then seen
    smem[f] = estimates(r, pin[2 + 3 * r, j], pin[3 + 3 * r, j])
    # __syncthreads(); each entry reads row r's estimate at its lane's position
    smem[depth * size + f] = smem[r * size + pin[4 + 3 * r, j]]
    # __syncthreads(); threads f < size take their lane's minimum over rows
    lane = np.arange(min(size, plan.threads))
    answer(lane, smem[depth * size:].reshape(depth, size)[:, lane].min(axis=0))
    return out


# ---------------------------------------------------------------------------
# the plan


@pytest.mark.parametrize("depth", range(1, 9))
def test_the_plan_covers_every_entry_and_lane_once_within_the_limits(depth):
    for size in LADDER:
        plan = ps.plan_sketch_step(depth, size)
        assert plan == ps.plan_sketch_step(depth, size)  # (depth, size) alone
        if plan.form == "pair":
            assert plan == ps.PAIR_PLAN and depth * size > 1024
            # (a): one thread an entry over whole blocks; (b): one a lane
            t = np.arange(-(-depth * size // plan.threads) * plan.threads)
            t = t[t < depth * size]
            np.testing.assert_array_equal(np.sort((t // size) * size + t % size),
                                          np.arange(depth * size))
            lanes = np.arange(-(-size // plan.threads) * plan.threads)
            np.testing.assert_array_equal(lanes[lanes < size], np.arange(size))
            continue
        assert plan.form == "block"
        assert 32 <= plan.threads <= 1024 and plan.threads % 32 == 0
        assert plan.shared_bytes == 16 * depth * size <= 232_448
        f = np.arange(plan.threads)
        f = f[f < depth * size]
        np.testing.assert_array_equal(np.sort((f // size) * size + f % size),
                                      np.arange(depth * size))
        assert plan.threads >= size  # every lane has its thread for the minimum


def test_the_block_form_serves_every_size_one_block_holds():
    """The threshold: one block of at most 1024 threads, one an entry, and
    nothing larger (the pair form takes over)."""
    for depth in range(1, 9):
        for size in range(1, 2049):
            plan = ps.plan_sketch_step(depth, size)
            assert (plan.form == "block") == (depth * size <= 1024), (depth, size)
            if plan.form == "block":
                assert plan.threads - 32 < depth * size <= plan.threads <= 1024


def test_the_plan_at_the_daemons_depth():
    """Depth 4: pins of up to 256 lanes (batches of up to 256 sketch keys)
    take one launch; the sketch path's 1000-key batches and the zipf
    deployment's take the pair form."""
    assert [ps.plan_sketch_step(4, s).form for s in (64, 128, 256, 512, 1024, 8192)] == \
        ["block"] * 3 + ["pair"] * 3
    assert ps.plan_sketch_step(4, 256) == ps.SketchPlan("block", 1024, 16384)


def test_launch_step_runs_only_on_a_card():
    counts = torch.zeros((2, 2, 64), dtype=torch.int32)
    pin = torch.zeros((ps.pin_rows(2), 64), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        ps.launch_step(counts, pin, 0, ps.plan_sketch_step(2, 64))


# ---------------------------------------------------------------------------
# the walk against the JAX package's step


def _batch(rng, n, n_keys, *, hot_hits=None):
    keys = [b"api_k%d" % k for k in rng.integers(0, n_keys, n)]
    hits = rng.choice([-7, -1, 0, 1, 2, 5, 100], n).astype(np.int64)
    if hot_hits is not None:
        keys[:4] = [b"api_hot"] * 4
        hits[:4] = hot_hits
    return keys, hits


def _case(rng, case, depth, width):
    """(counts, pin, cur): the cases of tests/test_torch_sketch.py's step
    test (random, negative_prev_frac, saturation, padding), the floor
    division case, and an all-padding tail."""
    counts = rng.integers(-1000, 1000, (2, depth, width)).astype(np.int32)
    if case == "negative_prev_frac":
        counts[:] = -rng.integers(1, 2**31, counts.shape).astype(np.int32)
    if case == "saturation":
        counts = np.abs(counts)
        counts[:, :, ::3] = I32_MAX - 5
    if case == "floor_division":
        # -7 in the previous plane at frac 19660 reads -7 * 45876 // 65536 = -5
        counts = np.zeros((2, depth, width), np.int32)
        counts[1] = -7
        pin = np.zeros((ps.pin_rows(depth), 64), np.int32)
        pin[0, 2] = 19660
        for r in range(depth):
            pin[2 + 3 * r] = np.arange(64)
            pin[4 + 3 * r] = np.arange(64)
        return counts, pin, 0
    n = {"random": 700, "negative_prev_frac": 300, "saturation": 64, "padding": 5,
         "padding_tail": 5}[case]
    keys, hits = _batch(rng, n, 50, hot_hits=2**30 if case == "saturation" else None)
    now = {"random": 41_250, "negative_prev_frac": 7_300, "saturation": 9_000,
           "padding": 3_999, "padding_tail": 12_345}[case]
    lim = ps.SketchLimiter(1000, depth, width, device="cpu")
    pin = ps.pack_pin(lim._indexes(keys), hits, now, 1000, width)
    if case in ("padding", "padding_tail"):
        extra = 448 if case == "padding" else 1024 - 64
        pin = np.concatenate([pin, np.zeros((pin.shape[0], extra), np.int32)], axis=1)
        pin[2::3, 64:] = np.arange(width, width + pin.shape[1] - 64)
    return counts, pin, int(rng.integers(0, 2))


CASES = ["random", "negative_prev_frac", "saturation", "padding", "floor_division",
         "padding_tail"]
# "plan": depth 4, the plan's form (the block form at 64 lanes, the pair
# form at 512 and 1024); "block": the same case at depth 1, where every
# case's pin fits one block; "pair": depth 4 in the pair form.
FORMS = ["plan", "block", "pair"]


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("case", CASES)
def test_the_walk_of_a_plan_is_bit_equal_to_the_reference_step(case, form):
    rng = np.random.default_rng(CASES.index(case) * 10 + FORMS.index(form))
    depth = 1 if case == "floor_division" or form == "block" else 4
    width = 64 if case == "floor_division" else 1 << 10
    counts, pin, cur = _case(rng, case, depth, width)
    plan = ps.PAIR_PLAN if form == "pair" else ps.plan_sketch_step(depth, pin.shape[1])
    assert form != "block" or plan.form == "block"
    ref_state = rs.SketchState(jnp.asarray(counts), jnp.asarray(0, dtype=jnp.int64),
                               jnp.asarray(cur, dtype=jnp.int32))
    ref_state, ref_out = rs.SketchLimiter(1000, depth, width)._step(ref_state, jnp.asarray(pin),
                                                                   cur)
    walked = counts.copy()
    out = walk_plan(walked, pin, cur, plan)
    np.testing.assert_array_equal(out, np.asarray(ref_out))
    np.testing.assert_array_equal(walked, np.asarray(ref_state.counts))
    if case == "floor_division":
        est = (out[0].astype(np.int64) << 32) | (out[1].astype(np.int64) & 0xFFFFFFFF)
        assert est.tolist() == [-5] * 64


@pytest.mark.parametrize("depth", range(1, 9))
def test_the_block_walk_at_each_depth_is_bit_equal_to_the_reference_step(depth):
    """The block form at its largest pin for each depth (depth·size up to
    1024), hot key and negative previous counts read at frac != 0."""
    rng = np.random.default_rng(100 + depth)
    width = 1 << 10
    size = 64
    while depth * size * 2 <= 1024:
        size *= 2
    counts = rng.integers(-2**31, 2**31, (2, depth, width)).astype(np.int32)
    keys, hits = _batch(rng, size * 3 // 4, size, hot_hits=2**30)
    lim = ps.SketchLimiter(1000, depth, width, device="cpu")
    pin = ps.pack_pin(lim._indexes(keys), hits, 7_300, 1000, width)
    assert pin.shape[1] == size or (size < 64 and pin.shape[1] == 64)
    plan = ps.plan_sketch_step(depth, pin.shape[1])
    assert plan.form == "block"
    ref_state = rs.SketchState(jnp.asarray(counts), jnp.asarray(0, dtype=jnp.int64),
                               jnp.asarray(1, dtype=jnp.int32))
    ref_state, ref_out = rs.SketchLimiter(1000, depth, width)._step(ref_state, jnp.asarray(pin), 1)
    walked = counts.copy()
    np.testing.assert_array_equal(walk_plan(walked, pin, 1, plan), np.asarray(ref_out))
    np.testing.assert_array_equal(walked, np.asarray(ref_state.counts))
