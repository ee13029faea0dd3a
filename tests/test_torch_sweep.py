"""The port's expiry sweep against the JAX package's, on the CPU.

* `sweep_window_reference` (the plain version of kernel K6) against JAX
  `sweep_window_scan` + `sweep_window_commit`: the count, the freed
  indices in order and the meta words, bit for bit — across the signed /
  unsigned boundary of the expiry's low word and on a clamped tail
  window; `sweep_expired` against the JAX one-shot form; the
  `windowed_sweep` loop's windows, cursor and released slots.
* The port engine's `sweep` against the JAX `DecisionEngine`'s, both on
  frozen clocks: ports of tests/test_sweep.py:30, :42, :54 and :67 (the
  sharded case waits for the port's sharded engine), each run through
  both engines and compared; and the slot reuse order — keys interned
  after a sweep must land on the same slots with the same words.
* `GUBER_SWEEP_INTERVAL`'s parser against the JAX one.

Tolerance: exact everywhere.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gubernator_tpu.clock import Clock as RefClock
from gubernator_tpu.config import parse_duration as ref_parse_duration
from gubernator_tpu.core.engine import DecisionEngine as RefEngine
from gubernator_tpu.ops import expiry as jex
from gubernator_tpu.types import RateLimitReq as RefReq
from gubernator_tpu_torch.clock import Clock
from gubernator_tpu_torch.config import parse_duration, setup_daemon_config
from gubernator_tpu_torch.core.engine import DecisionEngine
from gubernator_tpu_torch.ops import bucket_kernel as tk
from gubernator_tpu_torch.ops import expiry as tex
from gubernator_tpu_torch.types import RateLimitReq, Status

T0_NS = 1_760_000_000_123 * 1_000_000


def _sweep_columns(rng, cap, now):
    """meta / hi2 / expire_lo columns (reference numpy types): occupied
    or not, expiries at now - 1, now, now + 1 and spread around now, low
    words with bit 31 set and clear, hi words below, at and above now's."""
    now_hi, now_lo = now >> 32, now & 0xFFFFFFFF
    kind = rng.integers(0, 6, cap)
    expire = np.where(kind == 0, now - 1, np.where(kind == 1, now, np.where(
        kind == 2, now + 1, now + rng.integers(-2**33, 2**33, cap))))
    # lo words across the signed boundary: same hi word, lo with bit 31 set
    cross = rng.random(cap) < 0.3
    lo = rng.integers(0, 2**32, cap, dtype=np.uint64).astype(np.int64)
    expire = np.where(cross, (now_hi << 32) | lo, expire)
    expire = np.clip(expire, 0, tk.TS_CLAMP_MAX)
    meta = (rng.integers(0, 2**26, cap) & ~1) | (rng.random(cap) < 0.7)
    dur_hi = rng.integers(0, 2**11, cap)
    assert now_lo >= 2**31  # the instants below sit past the boundary
    return (meta.astype(np.int32), ((expire >> 32) | (dur_hi << 11)).astype(np.int32),
            (expire & 0xFFFFFFFF).astype(np.uint32))


def _ref_window(meta, hi2, elo, now, start, window):
    m_w, order, count = jex.sweep_window_scan(
        jnp.asarray(meta), jnp.asarray(hi2), jnp.asarray(elo),
        jnp.asarray(now >> 32, dtype=jnp.int32), jnp.asarray(now & 0xFFFFFFFF, dtype=jnp.uint32),
        jnp.asarray(start, dtype=jnp.int32), window=window)
    new_meta = jex.sweep_window_commit(jnp.asarray(meta), m_w, jnp.asarray(start, jnp.int32))
    c = int(count)
    return c, np.asarray(order)[:c], np.asarray(new_meta)


def _port_window(meta, hi2, elo, now, start, window):
    m = torch.from_numpy(meta.copy())
    out = tex.sweep_window_reference(m, torch.from_numpy(hi2.copy()),
                                     torch.from_numpy(elo.view(np.int32).copy()), now, start,
                                     window)
    return int(out[0]), tex.read_freed([out])[0], m.numpy()


# now's low word has bit 31 set; the second instant sits one ms past a
# hi-word boundary.
NOWS = [1_760_000_000_123 | (1 << 31), ((1_760_000_000_123 >> 32) + 1 << 32) + 1]


@pytest.mark.parametrize("cap,start,window", [
    (1 << 12, 0, 1 << 12),        # one window of the whole capacity
    (5000, 1024, 2048),           # a window inside
    (5000, 5000 - 1536, 1536),    # the clamped tail window
    (777, 0, 777),                # not a multiple of 32
])
@pytest.mark.parametrize("now", NOWS)
def test_sweep_window_reference_matches_jax(cap, start, window, now):
    rng = np.random.default_rng(cap + window + now % 97)
    cols = _sweep_columns(rng, cap, now if now & (1 << 31) else NOWS[0])
    want = _ref_window(*cols, now, start, window)
    got = _port_window(*cols, now, start, window)
    assert got[0] == want[0] > 0
    assert np.array_equal(got[1], want[1])
    assert np.array_equal(got[2], want[2])


def test_sweep_unsigned_low_word():
    """Expiries one below, at and one above `now`, whose low words have
    bit 31 set: only the first is freed (a signed compare would free the
    wrong ones)."""
    now = NOWS[0]
    exp = np.array([now - 1, now, now + 1, now - 2**31, now + 2**31 - 10], np.int64)
    meta = np.ones(5, np.int32)
    hi2 = (exp >> 32).astype(np.int32)
    elo = (exp & 0xFFFFFFFF).astype(np.uint32)
    assert all(int(v) >= 2**31 for v in elo[:3])
    want = _ref_window(meta, hi2, elo, now, 0, 5)
    got = _port_window(meta, hi2, elo, now, 0, 5)
    assert got[0] == want[0] == 2
    assert got[1].tolist() == want[1].tolist() == [0, 3]
    assert np.array_equal(got[2], want[2])


def test_sweep_expired_matches_jax():
    rng = np.random.default_rng(5)
    now = NOWS[0]
    meta, hi2, elo = _sweep_columns(rng, 3000, now)
    r_meta, r_mask = jex.sweep_expired(jnp.asarray(meta), jnp.asarray(hi2), jnp.asarray(elo),
                                       jnp.asarray(now >> 32, jnp.int32),
                                       jnp.asarray(now & 0xFFFFFFFF, jnp.uint32))
    m = torch.from_numpy(meta.copy())
    mask = tex.sweep_expired(m, torch.from_numpy(hi2), torch.from_numpy(elo.view(np.int32)), now)
    assert np.array_equal(mask.numpy(), np.asarray(r_mask))
    assert np.array_equal(m.numpy(), np.asarray(r_meta))


class _Holder:
    """What `windowed_sweep` reads of an engine."""

    def __init__(self, state, window):
        self._state = state
        self._sweep_cursor = 0
        self.SWEEP_WINDOW = window


@pytest.mark.parametrize("cap,window,per_call", [(1000, 256, 1), (1000, 256, 3), (300, 512, 2),
                                                  (5000, 64, None)])
def test_windowed_sweep_loop_matches_jax(cap, window, per_call):
    """Windows, the clamped overlapping tail, the cursor and its wrap, and
    the order of released slots, call by call, as the reference's loop."""
    rng = np.random.default_rng(cap + (per_call or 0))
    now = NOWS[0]
    meta, hi2, elo = _sweep_columns(rng, cap, now)
    words = tk.state_to_numpy(tk.make_state(cap, "cpu"))
    words.update(meta=meta, hi2=hi2, expire_lo=elo)
    import gubernator_tpu.ops.bucket_kernel as jbk

    ref = _Holder(jbk.BucketState(**{f: jnp.asarray(words[f]) for f in words}), window)
    port = _Holder(tk.state_from_numpy(words, "cpu"), window)
    for call in range(5):
        want, got = [], []

        def ref_release(order, count, start):
            want.append((start, (np.asarray(order)[: int(count)] + start).tolist()))
            return int(count)

        def port_release(freed, start):
            got.append((start, (freed + start).tolist()))
            return len(freed)

        n_ref = jex.windowed_sweep(ref, cap, now, per_call, ref_release)
        n_port = tex.windowed_sweep(port, cap, now, per_call, port_release)
        assert (n_port, got, port._sweep_cursor) == (n_ref, want, ref._sweep_cursor), call
        now += 1 << 31
    assert np.array_equal(port._state.meta.numpy(), np.asarray(ref._state.meta))


# ---------------------------------------------------------------------------
# The engine's sweep against the JAX engine's.


def _pair(capacity, window=None):
    ref = RefEngine(capacity=capacity, clock=RefClock().freeze_at(T0_NS))
    port = DecisionEngine(capacity, clock=Clock().freeze_at(T0_NS), device="cpu")
    if window is not None:
        ref.SWEEP_WINDOW = port.SWEEP_WINDOW = window
    return ref, port


def _fill(ref, port, n, duration, now_ms, name="sw"):
    def reqs(cls):
        return [cls(name=name, unique_key=f"{i}", hits=1, limit=10, duration=duration)
                for i in range(n)]

    want = ref.get_rate_limits(reqs(RefReq), now_ms=now_ms)
    got = port.get_rate_limits(reqs(RateLimitReq), now_ms=now_ms)
    for g, w in zip(got, want):
        assert (int(g.status), g.remaining, g.reset_time) == (int(w.status), w.remaining,
                                                               w.reset_time)
    return got


def _assert_identical(ref, port):
    """Same key on every slot, and the same 12 words on every slot."""
    ref._flush_pump()
    assert len(ref.table) == len(port.table)
    for s in range(port.capacity):
        assert port.table.key_for_slot(s) == ref.table.key_for_slot(s), s
    want = {f: np.asarray(getattr(ref._state, f)) for f in ref._state._fields}
    got = tk.state_to_numpy(port.state)
    for f in tk.BucketState._fields:
        assert np.array_equal(got[f], want[f]), f


def test_full_sweep_reclaims_expired_only():
    """tests/test_sweep.py:30, through both engines."""
    ref, port = _pair(1000)
    now = port.clock.now_ms()
    _fill(ref, port, 50, 1_000, now, name="short")
    _fill(ref, port, 30, 1_000_000, now, name="long")
    assert port.cache_size() == ref.cache_size() == 80
    assert port.sweep(now_ms=now + 500) == ref.sweep(now_ms=now + 500) == 0
    assert port.sweep(now_ms=now + 2_000) == ref.sweep(now_ms=now + 2_000) == 50
    assert port.cache_size() == ref.cache_size() == 30
    _assert_identical(ref, port)


def test_windowed_sweep_covers_nonmultiple_capacity():
    """tests/test_sweep.py:42: 1000 = 3 × 256 + 232, the tail window
    clamps and overlaps."""
    ref, port = _pair(1000, window=256)
    now = port.clock.now_ms()
    _fill(ref, port, 900, 1_000, now)
    assert port.sweep(now_ms=now + 2_000) == ref.sweep(now_ms=now + 2_000) == 900
    assert port.cache_size() == ref.cache_size() == 0
    assert port.sweep_windows_total == 4
    _assert_identical(ref, port)


def test_incremental_sweep_cursor():
    """tests/test_sweep.py:54: one window a call, four calls cover 1024."""
    ref, port = _pair(1024, window=256)
    now = port.clock.now_ms()
    _fill(ref, port, 1000, 1_000, now)
    totals = []
    for _ in range(4):
        a = port.sweep(now_ms=now + 2_000, max_windows=1)
        assert a == ref.sweep(now_ms=now + 2_000, max_windows=1)
        assert port._sweep_cursor == ref._sweep_cursor
        totals.append(a)
    assert sum(totals) == 1000
    assert port.cache_size() == ref.cache_size() == 0


def test_swept_slot_is_reusable():
    """tests/test_sweep.py:67: new keys intern into the reclaimed slots
    without eviction, and behave as fresh buckets."""
    ref, port = _pair(64)
    now = port.clock.now_ms()
    _fill(ref, port, 60, 1_000, now)
    port.sweep(now_ms=now + 2_000)
    ref.sweep(now_ms=now + 2_000)
    ev = port.table.evictions
    _fill(ref, port, 60, 1_000, now + 3_000, name="fresh")
    assert port.cache_size() == 60 and port.table.evictions == ev
    r = port.get_rate_limits([RateLimitReq(name="fresh", unique_key="0", hits=1, limit=10,
                                           duration=1_000)], now_ms=now + 3_000)[0]
    w = ref.get_rate_limits([RefReq(name="fresh", unique_key="0", hits=1, limit=10,
                                    duration=1_000)], now_ms=now + 3_000)[0]
    assert (r.status, r.remaining) == (Status.UNDER_LIMIT, 8)
    assert (int(w.status), w.remaining, w.reset_time) == (int(r.status), r.remaining,
                                                          r.reset_time)
    _assert_identical(ref, port)


@pytest.mark.parametrize("seed", [0, 1])
def test_slot_reuse_order_after_partial_sweeps(seed):
    """Which slot a new key gets after a sweep depends on the order the
    freed slots reach the table: ascending within a window, windows in
    cursor order.  Mixed expiries, sweeps of a few windows at a time,
    then new keys: same slots, same words as the reference."""
    rng = np.random.default_rng(seed)
    ref, port = _pair(700, window=128)
    now = port.clock.now_ms()
    for b in range(6):
        n = int(rng.integers(100, 200))
        durs = rng.choice([500, 1_500, 4_000, 60_000], n)
        keys = [f"b{b}_{i}" for i in range(n)]
        for cls, eng in ((RefReq, ref), (RateLimitReq, port)):
            eng.get_rate_limits([cls(name="ro", unique_key=k, hits=1, limit=5, duration=int(d),
                                     algorithm=int(i % 2)) for i, (k, d) in
                                 enumerate(zip(keys, durs))], now_ms=now)
        now += int(rng.integers(300, 2_000))
        w = int(rng.integers(1, 4))
        assert port.sweep(now_ms=now, max_windows=w) == ref.sweep(now_ms=now, max_windows=w)
        _assert_identical(ref, port)


@pytest.mark.parametrize("text", ["30s", "500ms", "1m30s", "250us", "2h", "0.25", "0", "1.5s"])
def test_sweep_interval_parses_like_the_reference(text):
    assert parse_duration(text) == ref_parse_duration(text)
    assert setup_daemon_config({"GUBER_SWEEP_INTERVAL": text}).sweep_interval == parse_duration(
        text)


def test_sweep_interval_default_and_bad_value():
    assert setup_daemon_config({}).sweep_interval == 30.0
    with pytest.raises(ValueError):
        parse_duration("5 parsecs")
