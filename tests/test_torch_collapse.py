"""The port's hot-key collapse against the JAX package's.

* `collapsed_step_reference` (the plain version of kernel K3) against the
  JAX `collapsed_step` (`_collapsed_step_core`) on the same packed
  buffers, bit for bit in pout and all 12 state columns: token and leaky
  segments, over-limit boundaries, the sticky OVER, queries, negative
  token hits, Gregorian duplicates; and the `collapsed_step` wrapper's
  clears against the JAX `clear_occupied` run first.
* The port engine against the JAX engine on hot-key streams, through
  `apply_columnar` and `get_rate_limits`, answers and state words.
* The fall-backs to rounds (tests/test_collapse.py:149, :205): duplicates
  with different fields, leaky negative hits, RESET_REMAINING on a
  duplicate, and a slot reused within the batch.
* K3's input contract (`check_collapsed`): the packer's layouts pass,
  broken ones (interleaved segments, positions, counts, padding, slot
  order) are refused, and every collapsed pin the engine builds passes.

Inputs are seeded numpy; the tolerance is exact.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_engine import _advance, _assert_same_state, _columnar_step, _dataclass_step, _pair
from test_torch_multi_round import _assert_state_equal, _jax_state, _rand_logical

from gubernator_tpu.ops import bucket_kernel as bk
from gubernator_tpu_torch.core import engine as engine_mod
from gubernator_tpu_torch.ops import bucket_kernel as tk
from gubernator_tpu_torch.ops.collapsed_step import collapsed_step
from gubernator_tpu_torch.types import Behavior

GREG = int(Behavior.DURATION_IS_GREGORIAN)
RESET = int(Behavior.RESET_REMAINING)


def _segments(rng, cap, n_seg, now, *, max_m=6):
    """n_seg unique sorted slots with 1..max_m lanes each and per-segment
    fields drawn to reach every branch of the closed form."""
    uniq = np.sort(rng.choice(cap, n_seg, replace=False)).astype(np.int32)
    counts = rng.integers(1, max_m + 1, n_seg).astype(np.int64)
    fields = (
        rng.integers(0, 2, n_seg),
        rng.choice([0, 0, 0, GREG], n_seg),
        rng.choice([-3, -1, 0, 1, 1, 2, 3, 5, 2**40], n_seg),
        rng.choice([-1, 0, 1, 4, 7, 10, 100, 10**12], n_seg),
        rng.choice([0, 1, 40, 1000, 60_000], n_seg),
        rng.choice([0, 0, 3, 10, 20, -7], n_seg),
        rng.choice([60_000, 3_600_000, 86_400_000], n_seg),
        now + rng.integers(0, 100_000, n_seg),
    )
    seg = np.repeat(np.arange(n_seg), counts).astype(np.int32)
    pos = (np.arange(len(seg)) - np.repeat(np.cumsum(counts) - counts, counts)).astype(np.int32)
    return uniq, counts, fields, seg, pos


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_plain_collapsed_step_bit_equal_to_jax(seed):
    """Fuzzed segment buffers over a random live state, call after call
    (the state evolves), through the port's packer and the JAX packer."""
    rng = np.random.default_rng(seed)
    cap, now = 256, 1_700_000_000_000
    words = bk.pack_state_host(_rand_logical(rng, cap, now))
    jstate, port = _jax_state(words), tk.state_from_numpy(words, "cpu")
    for it in range(12):
        uniq, counts, fields, seg, pos = _segments(rng, cap, int(rng.integers(1, 40)), now)
        size = tk.ROUND_ALIGN * -(-len(seg) // tk.ROUND_ALIGN) if it % 2 else 1 << max(
            6, (len(seg) - 1).bit_length())
        pin = tk.pack_collapsed_host(size, now, cap, uniq, counts, fields, seg, pos)
        ref_pin = bk.pack_collapsed_host(size, now, cap, uniq, counts,
                                         tuple(np.asarray(f) for f in fields), seg, pos)
        assert np.array_equal(pin, ref_pin)
        jstate, want = bk.collapsed_step(jstate, jnp.asarray(ref_pin))
        got = tk.collapsed_step_reference(port, torch.from_numpy(pin))
        assert np.array_equal(got.numpy(), np.asarray(want)), it
        _assert_state_equal(jstate, port, it)
        now += int(rng.integers(0, 3_000))


def test_plain_collapsed_step_boundaries_and_sticky_over():
    """Hand-made segments on fresh buckets: exact drain (sticky OVER
    only when an extra sees 0), over-limit after a partial consume,
    queries, negative token hits, leaky floor of the 32.32 remaining."""
    cap, now = 64, 5_000_000
    words = tk.state_to_numpy(tk.make_state(cap, "cpu"))
    jstate, port = _jax_state(words), tk.make_state(cap, "cpu")
    cases = [  # (algo, hits, limit, burst, m)
        (0, 1, 4, 0, 5), (0, 1, 4, 0, 4), (0, 2, 7, 0, 20), (0, 0, 3, 0, 3),
        (0, -1, 10, 0, 4), (1, 3, 10, 10, 8), (1, 1, 10, 0, 12), (1, 0, 5, 5, 3),
        (0, 5, 3, 0, 2), (1, 7, 3, 3, 2),
    ]
    for rep in range(2):
        n = len(cases)
        fields = tuple(np.asarray(c) for c in (
            [c[0] for c in cases], [0] * n, [c[1] for c in cases], [c[2] for c in cases],
            [60_000] * n, [c[3] for c in cases], [0] * n, [0] * n))
        counts = np.asarray([c[4] for c in cases], np.int64)
        seg = np.repeat(np.arange(n), counts).astype(np.int32)
        pos = (np.arange(len(seg)) - np.repeat(np.cumsum(counts) - counts, counts)).astype(
            np.int32)
        uniq = np.arange(n, dtype=np.int32) * 3
        pin = tk.pack_collapsed_host(96, now, cap, uniq, counts, fields, seg, pos)
        jstate, want = bk.collapsed_step(jstate, jnp.asarray(pin))
        got = tk.collapsed_step_reference(port, torch.from_numpy(pin))
        assert np.array_equal(got.numpy(), np.asarray(want)), rep
        _assert_state_equal(jstate, port, rep)
        now += 1_000
    st, rem, _ = tk.unpack_out_host(got.numpy(), len(seg))
    first = list(rem[:5])  # segment 0 on its second pass: 4 → already drained to 0
    assert first == [0, 0, 0, 0, 0] and list(st[:5]) == [1] * 5


def test_token_extras_host_matches_the_reference():
    """The host-scalar twin of the token closed form, over remaining,
    hits and extras on both sides of every boundary."""
    for R1 in (-7, -1, 0, 1, 2, 5, 6, 7, 100, 2**40):
        for h in (-3, -1, 0, 1, 2, 3, 7):
            for extras in (0, 1, 2, 5, 50):
                assert tk.token_extras_host(R1, h, extras) == bk.token_extras_host(R1, h, extras)


def test_collapsed_step_wrapper_runs_its_clears_first():
    """The wrapper's clears (on the CPU: the plain clear) then the step
    equal the JAX `clear_occupied` then `collapsed_step`, where a
    cleared slot is a segment's slot."""
    rng = np.random.default_rng(11)
    cap, now = 128, 1_700_000_000_000
    words = bk.pack_state_host(_rand_logical(rng, cap, now))
    jstate, port = _jax_state(words), tk.state_from_numpy(words, "cpu")
    uniq, counts, fields, seg, pos = _segments(rng, cap, 30, now)
    pin = tk.pack_collapsed_host(160, now, cap, uniq, counts, fields, seg, pos)
    clears = np.concatenate([uniq[::3], [cap + 5]]).astype(np.int32)
    c = np.arange(cap, cap + 16, dtype=np.int32)
    c[: len(clears)] = clears
    jstate = jstate._replace(meta=bk.clear_occupied(jstate.meta, jnp.asarray(c)))
    jstate, want = bk.collapsed_step(jstate, jnp.asarray(pin))
    got = collapsed_step(port, torch.from_numpy(pin), torch.from_numpy(clears))
    assert np.array_equal(got.numpy(), np.asarray(want))
    _assert_state_equal(jstate, port, "clears")


def _hot_rows(rng, n, n_keys, *, uniform=True, hits=(0, 4), greg=False):
    """n columnar rows over n_keys keys; with `uniform`, every key keeps
    one config (the collapse precondition)."""
    kidx = rng.integers(0, n_keys, n)
    per = lambda lo, hi: rng.integers(lo, hi, n_keys)  # noqa: E731
    algo, h, lim, burst = per(0, 2), per(*hits), per(1, 12), per(0, 14)
    beh = np.where(rng.random(n_keys) < 0.3, GREG, 0) if greg else np.zeros(n_keys, int)
    dur = np.where(beh == GREG, rng.integers(0, 6, n_keys), 60_000)
    if not uniform:
        return [(f"h{k}", int(rng.integers(0, 2)), 0, int(rng.integers(*hits)),
                 int(rng.integers(1, 12)), 60_000, int(rng.integers(0, 14))) for k in kidx]
    return [(f"h{k}", int(algo[k]), int(beh[k]), int(h[k]), int(lim[k]), int(dur[k]),
             int(burst[k])) for k in kidx]


class _CountK3:
    """Counts the engine's collapsed_step calls (the CPU runs the plain
    version, which the kernel launch counts do not see), and holds each
    call's pin to the layout kernel K3 relies on."""

    def __init__(self, monkeypatch):
        self.calls = 0
        real = engine_mod.collapsed_step

        def counted(state, pin, *a, **k):
            self.calls += 1
            tk.check_collapsed(pin)
            return real(state, pin, *a, **k)

        monkeypatch.setattr(engine_mod, "collapsed_step", counted)


@pytest.mark.parametrize("path", ["columnar", "dataclass"])
@pytest.mark.parametrize("seed", [0, 1])
def test_engine_hot_key_streams_match_jax(monkeypatch, path, seed):
    """Duplicate-heavy batches (6 keys) with negative hits on odd seeds
    and Gregorian keys: the port collapses them (K3's plain version) and
    answers like the JAX engine, word for word in state."""
    k3 = _CountK3(monkeypatch)
    rng = np.random.default_rng(seed)
    ref, port = _pair(256)
    step = _columnar_step if path == "columnar" else _dataclass_step
    hr = (-2, 4) if seed % 2 else (0, 4)
    for _ in range(12):
        step(ref, port, _hot_rows(rng, int(rng.integers(2, 120)), 6, hits=hr, greg=True))
        _advance(ref, port, int(rng.integers(0, 30_000)))
    _assert_same_state(ref, port)
    assert k3.calls > 0


def test_engine_collapse_under_eviction_pressure(monkeypatch):
    """Round-0 clears ride the first collapsed chunk; capacity 16 under 40
    keys forces slot reuse across batches (and within them: rounds)."""
    k3 = _CountK3(monkeypatch)
    rng = np.random.default_rng(9)
    ref, port = _pair(16)
    for _ in range(10):
        _columnar_step(ref, port, _hot_rows(rng, int(rng.integers(2, 60)), 40))
        _advance(ref, port, 1_000)
    _assert_same_state(ref, port)
    assert port.table.evictions == ref.table.evictions > 0
    assert k3.calls > 0 and port.clears_total > 0


def test_engine_collapse_chunks_at_max_kernel_width(monkeypatch):
    """A 300-lane hot batch at max_kernel_width 64: five K3 launches,
    segments split across chunks, same answers as the JAX engine."""
    from gubernator_tpu.clock import Clock as RefClock
    from gubernator_tpu.core.engine import DecisionEngine as RefEngine
    from gubernator_tpu_torch.clock import Clock
    from test_torch_engine import T0_NS

    k3 = _CountK3(monkeypatch)
    ref = RefEngine(capacity=128, clock=RefClock().freeze_at(T0_NS), max_kernel_width=64)
    port = engine_mod.DecisionEngine(128, clock=Clock().freeze_at(T0_NS), device="cpu",
                                     max_kernel_width=64)
    rng = np.random.default_rng(4)
    _columnar_step(ref, port, _hot_rows(rng, 300, 7))
    assert k3.calls == 5 and port.dispatches_total == 5
    _assert_same_state(ref, port)


@pytest.mark.parametrize("case", ["nonuniform", "leaky_negative", "reset", "reuse"])
def test_engine_fall_backs_to_rounds(monkeypatch, case):
    """Batches the closed form cannot serve run as rounds (K1), with the
    answers of the JAX engine and of the reference's own examples."""
    k3 = _CountK3(monkeypatch)
    ref, port = _pair(64 if case != "reuse" else 4)
    if case == "nonuniform":  # tests/test_collapse.py:149
        cols = (np.zeros(3, np.int32), np.zeros(3, np.int32), np.ones(3, np.int64),
                np.array([10, 20, 20]), np.full(3, 60_000), np.zeros(3, np.int64))
        got = port.apply_columnar([b"t_nu"] * 3, *cols)
        want = ref.apply_columnar([b"t_nu"] * 3, *cols)
        # Sequential: 10-1 = 9; the limit change 10 -> 20 adds 10: 18, 17.
        assert got[2].tolist() == want[2].tolist() == [9, 18, 17]
    elif case == "leaky_negative":  # tests/test_collapse.py:205
        _columnar_step(ref, port, [("lneg", 1, 0, 8, 10, 60_000, 0)])
        _columnar_step(ref, port, [("lneg", 1, 0, -3, 10, 60_000, 0)] * 4)
        _columnar_step(ref, port, [("lneg", 1, 0, 0, 10, 60_000, 0)])
    elif case == "reset":
        _columnar_step(ref, port, [("r", 0, 0, 2, 10, 60_000, 0)])
        _columnar_step(ref, port, [("r", 0, RESET, 1, 10, 60_000, 0)] * 3)
    else:  # 6 keys into 4 slots: a slot freed and reused in the batch
        _columnar_step(ref, port, [(k, 0, 0, 1, 5, 60_000, 0) for k in "abcdaaef"])
    assert k3.calls == 0
    assert port.rounds_total > port.batches_total
    _assert_same_state(ref, port)


def test_forced_rounds_engine_equals_collapsing_engine():
    """`engine._try_collapse = lambda *a, **k: None` forces the rounds
    path (as the reference's tests do); both engines answer alike."""
    rng = np.random.default_rng(21)
    _ref, fast = _pair(128)
    _ref2, slow = _pair(128)
    slow._try_collapse = lambda *a, **k: None
    for _ in range(8):
        _columnar_step(fast, slow, _hot_rows(rng, int(rng.integers(2, 100)), 5, hits=(-1, 4)))
        _advance(fast, slow, int(rng.integers(0, 20_000)))
    assert fast.rounds_total < slow.rounds_total


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_check_collapsed_accepts_the_packers_layout(seed):
    """Fuzzed segment buffers, packed at 32-aligned and power-of-two
    widths, mostly padding, and with no padding at all, meet the
    contract."""
    rng = np.random.default_rng(40 + seed)
    cap, now = 4096, 1_700_000_000_000
    for it in range(10):
        uniq, counts, fields, seg, pos = _segments(rng, cap, int(rng.integers(1, 200)), now)
        for size in (len(seg), tk.ROUND_ALIGN * -(-len(seg) // tk.ROUND_ALIGN),
                     1 << (len(seg) + 600).bit_length()):
            tk.check_collapsed(tk.pack_collapsed_host(size, now, cap, uniq, counts, fields,
                                                      seg, pos))
    one = tuple(f[:1] for f in fields)  # one segment of one lane, as a tensor
    tk.check_collapsed(torch.from_numpy(
        tk.pack_collapsed_host(64, now, cap, uniq[:1], np.ones(1, np.int64), one,
                               np.zeros(1, np.int32), np.zeros(1, np.int32))))


@pytest.mark.parametrize("breach", ["interleaved", "position", "count", "padding", "slots"])
def test_check_collapsed_rejects_a_broken_layout(breach):
    """Each breach of K3's layout is refused: interleaved segments (row 17
    falls back), a position that skips, a lane count that row 2 does not
    hold, a padding lane off position 0, segment slots out of order."""
    rng = np.random.default_rng(7)
    cap, now = 4096, 1_700_000_000_000
    uniq, counts, fields, seg, pos = _segments(rng, cap, 30, now, max_m=4)
    counts[:2] = 3
    seg = np.repeat(np.arange(30), counts).astype(np.int32)
    pos = (np.arange(len(seg)) - np.repeat(np.cumsum(counts) - counts, counts)).astype(np.int32)
    pin = tk.pack_collapsed_host(tk.ROUND_ALIGN * -(-len(seg) // tk.ROUND_ALIGN) + 32, now,
                                 cap, uniq, counts, fields, seg, pos)
    tk.check_collapsed(pin)
    bad = pin.copy()
    if breach == "interleaved":  # lanes of segments 0 and 1 alternate
        bad[17, :6] = [0, 1, 0, 1, 0, 1]
        bad[18, :6] = [0, 0, 1, 1, 2, 2]
        match = "interleave"
    elif breach == "position":
        bad[18, 2] = 1
        match = "row 18"
    elif breach == "count":
        bad[2, 0] += 1
        match = "row 2"
    elif breach == "padding":
        bad[18, -1] = 1
        match = "padding"
    else:
        bad[1, [0, 1]] = bad[1, [1, 0]]
        match = "ascend"
    with pytest.raises(ValueError, match=match):
        tk.check_collapsed(bad)


@pytest.mark.parametrize("stream", ["hot", "chunked", "evicting"])
def test_engine_collapsed_pins_meet_the_kernel_contract(monkeypatch, stream):
    """Every collapsed pin the engine builds passes `check_collapsed`: on
    hot-key streams, on chunks cut at a small max_kernel_width (segments
    split across chunks) and under eviction pressure (clears in the first
    chunk)."""
    from gubernator_tpu_torch.clock import Clock

    k3 = _CountK3(monkeypatch)
    rng = np.random.default_rng({"hot": 1, "chunked": 2, "evicting": 3}[stream])
    cap = 16 if stream == "evicting" else 256
    port = engine_mod.DecisionEngine(cap, clock=Clock().freeze_at(1_700_000_000_000_000_000),
                                     device="cpu",
                                     max_kernel_width=64 if stream == "chunked" else 8192)
    for b in range(8):
        rows = _hot_rows(rng, int(rng.integers(40, 300)), 7)
        # evicting: each batch's 7 keys are new, 16 slots hold two batches
        keys = [(r[0] + ("_%d" % b if stream == "evicting" else "")).encode() for r in rows]
        cols = [np.asarray([r[i] for r in rows], np.int64) for i in range(1, 7)]
        port.apply_columnar(keys, cols[0].astype(np.int32), cols[1].astype(np.int32), *cols[2:])
        port.clock.advance(ms=1_000)
    assert k3.calls >= 8
    if stream == "evicting":
        assert port.clears_total > 0
