"""The port's count-min sketch (ops/sketch.py) against the JAX package's
(gubernator_tpu/ops/sketch.py), on the CPU.

Held against the reference: the packed pin of `SketchLimiter.apply`
(:273-303), the jitted step `_sketch_step_impl` (:99, through
`SketchLimiter._step`) and `_rotate` (:63), bit for bit in planes and
output; then whole `apply` streams across window steps.  The seven CPU
tests of tests/test_sketch.py are ported against the port's limiter.
Inputs come from seeded numpy generators; tolerance: exact.
"""

from __future__ import annotations

import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gubernator_tpu import hashing as ref_hashing
from gubernator_tpu.ops import sketch as rs
from gubernator_tpu_torch import hashing
from gubernator_tpu_torch.ops import sketch as ps

I32_MAX = 2**31 - 1


def _ref_limiter(window_ms, depth, width, counts, epoch, cur):
    """A reference limiter started from the given planes, epoch and plane,
    with every pin its step receives recorded in `lim.pins`."""
    lim = rs.SketchLimiter(window_ms, depth, width)
    lim._state = rs.SketchState(jnp.asarray(counts), jnp.asarray(epoch, dtype=jnp.int64),
                                jnp.asarray(cur, dtype=jnp.int32))
    lim._epoch_host, lim._cur_host = epoch, cur
    lim.pins = []
    step = lim._step

    def recorded(state, pin, c):
        lim.pins.append(np.asarray(pin))
        return step(state, pin, c)

    lim._step = recorded
    return lim


def _port_limiter(window_ms, depth, width, counts, epoch, cur):
    lim = ps.SketchLimiter(window_ms, depth, width, device="cpu")
    lim.state = ps.sketch_state_from_numpy(counts, epoch, cur, "cpu")
    return lim


def _random_planes(rng, depth, width):
    return rng.integers(-1000, 1000, (2, depth, width)).astype(np.int32)


def _same_state(port, ref):
    counts, epoch, cur = ps.sketch_state_to_numpy(port.state)
    np.testing.assert_array_equal(counts, np.asarray(ref._state.counts))
    assert (epoch, cur) == (ref._epoch_host, ref._cur_host)
    assert (epoch, cur) == (int(ref._state.epoch), int(ref._state.cur))


def _batch(rng, n, n_keys, *, hot_hits=None):
    keys = [b"api_k%d" % k for k in rng.integers(0, n_keys, n)]
    hits = rng.choice([-7, -1, 0, 1, 2, 5, 100], n).astype(np.int64)
    if hot_hits is not None:
        keys[: 4] = [b"api_hot"] * 4
        hits[: 4] = hot_hits
    return keys, hits, rng.integers(0, 200, n).astype(np.int64)


# ---------------------------------------------------------------------------
# hashing and the packer


def test_fnv1a_matches_the_reference():
    rng = np.random.default_rng(1)
    keys = [bytes(rng.integers(0, 256, int(rng.integers(0, 40)), dtype=np.uint8))
            for _ in range(300)] + [b"", b"api_u1"]
    padded, lengths = hashing.pack_keys(keys)
    want_p, want_l = ref_hashing.pack_keys(keys)
    np.testing.assert_array_equal(padded, want_p)
    np.testing.assert_array_equal(lengths, want_l)
    got = hashing.fnv1a_64_batch(padded, lengths)
    np.testing.assert_array_equal(got, ref_hashing.fnv1a_64_batch(want_p, want_l))
    assert [int(h) for h in got] == [ref_hashing.fnv1a_64(k) for k in keys]


@pytest.mark.parametrize("n", [1, 64, 65, 1000, 4097])
def test_packer_matches_the_reference_apply(n):
    rng = np.random.default_rng(n)
    depth, width, window = 4, 1 << 12, 1000
    zeros = np.zeros((2, depth, width), np.int32)
    ref = _ref_limiter(window, depth, width, zeros, 0, 0)
    port = ps.SketchLimiter(window, depth, width, device="cpu")
    for now in (0, 1_234, 5_999, 2**33 + 7):
        keys, hits, limit = _batch(rng, n, max(2, n // 3), hot_hits=2**30 if n >= 4 else None)
        ref.apply(keys, hits, limit, now)
        pin = ps.pack_pin(port._indexes(keys), hits, now, window, width)
        np.testing.assert_array_equal(pin, ref.pins[-1])
        np.testing.assert_array_equal(port._indexes(keys), ref._indexes(keys))


# ---------------------------------------------------------------------------
# the step and the rotation


def _step_case(rng, case, depth, width):
    """(pin, cur) for one step: a packed batch, then edited per case."""
    n = {"random": 700, "negative_prev_frac": 300, "saturation": 64, "padding": 5}[case]
    keys, hits, _ = _batch(rng, n, 50, hot_hits=2**30 if case == "saturation" else None)
    now = {"random": 41_250, "negative_prev_frac": 7_300, "saturation": 9_000,
           "padding": 3_999}[case]
    lim = ps.SketchLimiter(1000, depth, width, device="cpu")
    pin = ps.pack_pin(lim._indexes(keys), hits, now, 1000, width)
    if case == "padding":
        pin = np.concatenate([pin, np.zeros((pin.shape[0], 448), np.int32)], axis=1)
        pin[2::3, 64:] = np.arange(width, width + pin.shape[1] - 64)
    return pin, int(rng.integers(0, 2))


@pytest.mark.parametrize("case", ["random", "negative_prev_frac", "saturation", "padding"])
def test_sketch_step_reference_bit_equal_to_the_reference_step(case):
    rng = np.random.default_rng(7)
    depth, width = 4, 1 << 10
    counts = _random_planes(rng, depth, width)
    if case == "negative_prev_frac":
        counts[:] = -rng.integers(1, 2**31, counts.shape).astype(np.int32)
    if case == "saturation":
        counts = np.abs(counts)
        counts[:, :, ::3] = I32_MAX - 5
    for _ in range(3):
        pin, cur = _step_case(rng, case, depth, width)
        ref_state = rs.SketchState(jnp.asarray(counts), jnp.asarray(0, dtype=jnp.int64),
                                   jnp.asarray(cur, dtype=jnp.int32))
        ref_lim = rs.SketchLimiter(1000, depth, width)
        ref_state, ref_out = ref_lim._step(ref_state, jnp.asarray(pin), cur)
        port_counts = torch.from_numpy(counts.copy())
        out = ps.sketch_step_reference(port_counts, torch.from_numpy(pin), cur)
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref_out))
        np.testing.assert_array_equal(port_counts.numpy(), np.asarray(ref_state.counts))
        if case == "saturation":  # the hot key's cells hold 2^31 - 1, never a wrapped value
            hot = ps.SketchLimiter(1000, depth, width, device="cpu")._indexes([b"api_hot"])[:, 0]
            assert (port_counts[cur, np.arange(depth), hot] == I32_MAX).all()
        counts = port_counts.numpy()


def test_floor_division_of_a_negative_previous_count():
    """-7 in the previous plane at frac 19660 reads -7 * 45876 // 65536 =
    -5, as in the reference (C's truncating `/` would give -4)."""
    depth, width = 1, 64
    counts = np.zeros((2, depth, width), np.int32)
    counts[1, 0, :] = -7
    pin = np.zeros((ps.pin_rows(depth), 64), np.int32)
    pin[0, 2] = 19660
    pin[2] = np.arange(64)  # every cell once, hits 0, lane j at position j
    pin[4] = np.arange(64)
    ref_lim = rs.SketchLimiter(1000, depth, width)
    _, ref_out = ref_lim._step(rs.SketchState(jnp.asarray(counts), jnp.asarray(0, jnp.int64),
                                              jnp.asarray(0, jnp.int32)), jnp.asarray(pin), 0)
    out = ps.sketch_step_reference(torch.from_numpy(counts), torch.from_numpy(pin), 0)
    est = (out[0].to(torch.int64) << 32) | (out[1].to(torch.int64) & 0xFFFFFFFF)
    assert est.tolist() == [-5] * 64
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref_out))


@pytest.mark.parametrize("cur", [0, 1])
@pytest.mark.parametrize("delta", [-3, 0, 1, 2, 7])
def test_rotate_reference_matches_the_reference_rotate(cur, delta):
    rng = np.random.default_rng(delta + 10 + 100 * cur)
    counts = _random_planes(rng, 3, 100)
    epoch = 40
    ref = rs._rotate(rs.SketchState(jnp.asarray(counts), jnp.asarray(epoch, jnp.int64),
                                    jnp.asarray(cur, jnp.int32)),
                     jnp.asarray(epoch + delta, jnp.int64))
    port = torch.from_numpy(counts.copy())
    new_cur = ps.rotate_reference(port, cur, delta)
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref.counts))
    assert new_cur == int(ref.cur)


def test_wrappers_check_their_inputs():
    counts = torch.zeros((2, 2, 64), dtype=torch.int32)
    pin = torch.zeros((ps.pin_rows(2), 64), dtype=torch.int32)
    with pytest.raises(ValueError):
        ps.sketch_step(counts.to(torch.int64), pin, 0)
    with pytest.raises(ValueError):
        ps.sketch_step(counts, pin[:-1], 0)
    with pytest.raises(ValueError):
        ps.sketch_step(counts, pin, 2)
    with pytest.raises(ValueError):
        ps.sketch_rotate(counts[0], 0, 1)
    with pytest.raises(ValueError):
        ps.sketch_step(counts.to("meta"), pin.to("meta"), 0)


def test_the_limiter_runs_on_the_card_unless_the_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ps.SketchLimiter(1000, 2, 64)
    assert ps.SketchLimiter(1000, 2, 64, device="cpu").state.counts.device.type == "cpu"


@pytest.mark.parametrize("width", [64, 1 << 12])
def test_limiter_stream_matches_the_reference(width):
    """Random planes carried across, then batches whose clock stays in a
    window, steps one window, leaps two or more and goes back: answers,
    planes, epoch and plane index equal after every batch."""
    rng = np.random.default_rng(width)
    depth, window = 3, 1000
    counts = _random_planes(rng, depth, width)
    ref = _ref_limiter(window, depth, width, counts, 5, 1)
    port = _port_limiter(window, depth, width, counts, 5, 1)
    now = 5_300
    for step in (0, 400, 299, 1, 1000, 2500, 17, 999, -3000, 1500, 0):
        now += step
        keys, hits, limit = _batch(rng, int(rng.integers(1, 400)), 120,
                                   hot_hits=2**30 if step == 17 else None)
        want = ref.apply(keys, hits, limit, now)
        got = port.apply(keys, hits, limit, now)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        _same_state(port, ref)


def test_key_hashes_route_like_keys():
    lim = ps.SketchLimiter(1000, 4, 1 << 12, device="cpu")
    keys = [b"a", b"b", b"a"]
    h = hashing.fnv1a_64_batch(*hashing.pack_keys(keys))
    np.testing.assert_array_equal(lim._indexes_hashed(h), lim._indexes(keys))
    _, est = lim.apply(None, np.array([1, 2, 3]), np.full(3, 10), 0, key_hashes=h)
    assert est.tolist() == [4, 2, 4]


# ---------------------------------------------------------------------------
# tests/test_sketch.py, ported (all but the gRPC end-to-end test)


def _apply1(lim, key, hits, limit, now):
    over, est = lim.apply([key], np.asarray([hits]), np.asarray([limit]), now)
    return bool(over[0]), int(est[0])


def _lim(window_ms, depth, width):
    return ps.SketchLimiter(window_ms, depth, width, device="cpu")


def test_single_key_accumulates_and_limits():
    lim = _lim(1_000, 4, 1 << 12)
    now = 10_000
    assert _apply1(lim, b"k1", 3, 5, now) == (False, 3)
    assert _apply1(lim, b"k1", 2, 5, now) == (False, 5)
    assert _apply1(lim, b"k1", 1, 5, now) == (True, 6)


def test_distinct_keys_do_not_interfere():
    lim = _lim(1_000, 4, 1 << 16)
    n = 200
    keys = [b"key_%d" % i for i in range(n)]
    hits = np.arange(1, n + 1, dtype=np.int64)
    over, est = lim.apply(keys, hits, np.full(n, 10_000, dtype=np.int64), 0)
    assert not over.any()
    np.testing.assert_array_equal(est, hits)


def test_duplicates_in_one_batch_sum():
    lim = _lim(1_000, 4, 1 << 12)
    keys = [b"dup"] * 4 + [b"other"]
    hits = np.asarray([1, 2, 3, 4, 7], dtype=np.int64)
    _, est = lim.apply(keys, hits, np.full(5, 100, dtype=np.int64), 0)
    assert est[0] == est[1] == est[2] == est[3] == 10
    assert est[4] == 7


def test_window_rotation_decays_and_expires():
    lim = _lim(1_000, 4, 1 << 12)
    assert _apply1(lim, b"w", 100, 10_000, 0)[1] == 100
    assert 40 <= _apply1(lim, b"w", 0, 10_000, 1_500)[1] <= 60
    assert _apply1(lim, b"w", 0, 10_000, 3_000)[1] == 0


def test_overcount_is_one_sided():
    lim = _lim(1_000, 2, 64)
    n = 300
    keys = [b"c%d" % i for i in range(n)]
    _, est = lim.apply(keys, np.ones(n, dtype=np.int64), np.full(n, 10**9, dtype=np.int64), 0)
    assert (est >= 1).all()


def test_hot_key_saturates_instead_of_wrapping():
    lim = _lim(1_000, 2, 1 << 10)
    keys = [b"hot"] * 4  # combined 4 * 2^30 = 2^32 > int32 max
    hits = np.full(4, 2**30, dtype=np.int64)
    limit = np.full(4, 10**6, dtype=np.int64)
    over, est = lim.apply(keys, hits, limit, 0)
    assert (est == I32_MAX).all() and over.all()
    over, est = lim.apply(keys, hits, limit, 10)
    assert (est >= I32_MAX).all() and over.all()


def test_sketch_concurrent_apply_exact_totals():
    lim = _lim(3_600_000, 2, 1 << 14)
    n_threads, per_thread = 8, 25
    errs = []

    def worker():
        try:
            for _ in range(per_thread):
                lim.apply([b"conc"], np.ones(1, dtype=np.int64),
                          np.full(1, 10**9, dtype=np.int64), 0)
        except Exception as e:  # noqa: BLE001
            errs.append(e)

    ts = [threading.Thread(target=worker) for _ in range(n_threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
    assert not errs, errs
    _, est = lim.apply([b"conc"], np.zeros(1, dtype=np.int64),
                       np.full(1, 10**9, dtype=np.int64), 0)
    assert int(est[0]) == n_threads * per_thread
