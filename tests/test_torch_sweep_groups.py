"""The expiry sweep's group contract (`gubernator_tpu_torch/ops/expiry.py
sweep_windows`, kernels K6 / K13, and its plain version) against the JAX
package's sequential loop, on the CPU.

* `sweep_windows` on CPU tensors (`sweep_windows_reference`) against
  `sweep_window_scan` + `sweep_window_commit`
  (gubernator_tpu/ops/expiry.py:40, :78) run window after window, as its
  `windowed_sweep` (:89) runs them: a clamped tail inside a group, a tail
  that opens its group after a tick at an earlier instant, a cursor wrap,
  capacities below two windows (300 / 256, 1000 / 256, and 300 / 512,
  where the window is the whole capacity), a window repeated in one
  group, low words with bit 31 set, every slot freed and none, over 1, 4
  and 8 shards.
* `plan_launches`, the rows the kernel gets: each planned launch's rows,
  each freeing only in its owned range against the meta the launch
  started from (what the kernel's blocks read, in any order), give the
  sequential result.
* The grouped `windowed_sweep` through the engines' `sweep` against the
  JAX engines' on the dense, the sharded (4 shards) and the paged engine:
  freed counts, cursors and state words, with windows and groups counted.

Tolerance: exact everywhere (counts, ascending indices, meta words).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gubernator_tpu.clock import Clock as RefClock
from gubernator_tpu.core.engine import DecisionEngine as RefEngine
from gubernator_tpu.ops import expiry as jex
from gubernator_tpu.parallel.mesh import make_mesh
from gubernator_tpu.parallel.sharded_engine import ShardedDecisionEngine as RefSharded
from gubernator_tpu.types import RateLimitReq as RefReq
from gubernator_tpu_torch.clock import Clock
from gubernator_tpu_torch.core.engine import DecisionEngine
from gubernator_tpu_torch.ops import bucket_kernel as tk
from gubernator_tpu_torch.ops import expiry as tex
from gubernator_tpu_torch.parallel.sharded_engine import ShardedDecisionEngine
from gubernator_tpu_torch.types import RateLimitReq

T0_NS = 1_760_000_000_123 * 1_000_000
# now's low word has bit 31 set, as have the low words of the expiries
# around it.
NOW = 1_760_000_000_123 | (1 << 31)


def _columns(rng, rows, now, fill):
    """meta / hi2 / expire_lo (reference numpy types) of `rows` slots:
    "mixed" — occupied or not, expiries at now - 1, now, now + 1 and
    spread over ±2^33 ms, a third with now's hi word and any low word;
    "all" — every slot occupied and expired; "none" — every slot occupied
    and none expired."""
    now_hi = now >> 32
    if fill == "mixed":
        kind = rng.integers(0, 5, rows)
        expire = np.where(kind == 0, now - 1, np.where(kind == 1, now, np.where(
            kind == 2, now + 1, now + rng.integers(-2**33, 2**33, rows))))
        lo = rng.integers(0, 2**32, rows, dtype=np.uint64).astype(np.int64)
        expire = np.where(rng.random(rows) < 0.3, (now_hi << 32) | lo, expire)
        expire = np.clip(expire, 0, tk.TS_CLAMP_MAX)
        occupied = rng.random(rows) < 0.7
    else:
        expire = now - (1 if fill == "all" else -1) * rng.integers(1, 2**31, rows)
        occupied = np.ones(rows, bool)
    meta = (rng.integers(0, 2**26, rows) & ~1) | occupied
    dur_hi = rng.integers(0, 2**11, rows)
    return (meta.astype(np.int32), ((expire >> 32) | (dur_hi << 11)).astype(np.int32),
            (expire & 0xFFFFFFFF).astype(np.uint32))


def _jax_loop(cols, n_sh, calls, window):
    """The JAX package's scan + commit, window after window, over the
    [n_sh, cap] state; returns each call's freed indices ([window][shard])
    and the final meta."""
    meta, hi2, elo = (jnp.asarray(c.reshape(n_sh, -1)) for c in cols)
    got = []
    for now, starts in calls:
        rows = []
        for s in starts:
            start = jnp.asarray(s, jnp.int32)
            m_w, order, count = jex.sweep_window_scan(
                meta, hi2, elo, jnp.asarray(now >> 32, jnp.int32),
                jnp.asarray(now & 0xFFFFFFFF, jnp.uint32), start, window=window)
            meta = jex.sweep_window_commit(meta, m_w, start)
            count, order = np.asarray(count), np.asarray(order)
            rows.append([order[sh, : count[sh]].tolist() for sh in range(n_sh)])
        got.append(rows)
    return got, np.asarray(meta).reshape(-1)


def _tensors(cols):
    meta, hi2, elo = cols
    return (torch.from_numpy(meta.copy()), torch.from_numpy(hi2.copy()),
            torch.from_numpy(elo.view(np.int32).copy()))


def _rows(out):
    """[window][shard] freed lists of a [G, n_sh, window + 1] output."""
    return [[row[1 : 1 + int(row[0])].tolist() for row in win] for win in out]


def _port_loop(cols, n_sh, calls, window, sweep=tex.sweep_windows):
    meta, hi2, elo = _tensors(cols)
    got = []
    for now, starts in calls:
        out = sweep(meta, hi2, elo, now, starts, window, n_sh)
        assert out.shape == (len(starts), n_sh, window + 1)
        got.append(_rows(out))
    return got, meta.numpy()


# (cap, window, calls as [(instant offset, starts)]): the windows
# `windowed_sweep` gives, and two it never gives in one group.
LATER = 1 << 31
GROUPS = {
    "tail inside": (5000, 1024, [(0, [0, 1024, 2048, 3072, 3976])]),
    "tail opens after an earlier tick": (5000, 1024, [(0, [0, 1024, 2048, 3072]),
                                                      (LATER, [3976, 0, 1024])]),
    "cursor wrap": (5000, 1024, [(0, [3072, 3976, 0, 1024, 2048])]),
    "cap 300, window 256": (300, 256, [(0, [0, 44]), (LATER, [44, 0])]),
    "cap 1000, window 256": (1000, 256, [(0, [0, 256, 512, 744]), (LATER, [744, 0, 256])]),
    "cap 300, window 300": (300, 300, [(0, [0]), (LATER, [0])]),
    "a window repeated": (1000, 256, [(0, [512, 744, 512, 600])]),
    "more than 16 windows": (4000, 128, [(0, [i * 128 for i in range(20)] + [3872, 0, 64])]),
}


@pytest.mark.parametrize("n_sh", [1, 4, 8])
@pytest.mark.parametrize("case", list(GROUPS))
def test_sweep_windows_match_the_jax_loop(case, n_sh):
    cap, window, calls = GROUPS[case]
    rng = np.random.default_rng(cap + window + n_sh + len(case))
    cols = _columns(rng, n_sh * cap, NOW, "mixed")
    calls = [(NOW + dt, starts) for dt, starts in calls]
    want, want_meta = _jax_loop(cols, n_sh, calls, window)
    got, got_meta = _port_loop(cols, n_sh, calls, window)
    assert got == want
    assert np.array_equal(got_meta, want_meta)
    assert sum(len(f) for call in want for win in call for f in win) > 0
    for call in got:
        for win in call:
            assert all(f == sorted(f) for f in win)


@pytest.mark.parametrize("n_sh", [1, 4])
@pytest.mark.parametrize("fill", ["all", "none"])
def test_sweep_windows_free_every_slot_or_none(fill, n_sh):
    cap, window, calls = GROUPS["tail inside"]
    cols = _columns(np.random.default_rng(7), n_sh * cap, NOW, fill)
    calls = [(NOW, starts) for _, starts in calls]
    want, want_meta = _jax_loop(cols, n_sh, calls, window)
    got, got_meta = _port_loop(cols, n_sh, calls, window)
    assert got == want
    assert np.array_equal(got_meta, want_meta)
    freed = sum(len(f) for win in got[0] for f in win)
    assert freed == (n_sh * cap if fill == "all" else 0)
    # The tail frees its own slots: the window before it freed the overlap.
    assert all(len(f) == (window - (4096 - 3976) if fill == "all" else 0) for f in got[0][4])


def _launched(meta, hi2, elo, now, starts, window, n_sh=1):
    """What the kernel's launches compute, on the host: every row of a
    planned launch frees, in its owned range, the expired occupied slots
    of the meta the launch started from (rows taken last to first, since
    blocks run in no order)."""
    m, h, e = meta.numpy(), hi2.numpy().astype(np.int64), elo.numpy().astype(np.int64)
    cap = len(m) // n_sh
    out = torch.zeros((len(starts), n_sh, window + 1), dtype=torch.int32)
    now_hi, now_lo = now >> 32, now & 0xFFFFFFFF
    for first, owned in tex.plan_launches(starts, window):
        before = m.copy()
        for r in reversed(range(len(owned))):
            lo, hi = owned[r]
            assert 0 <= lo <= hi <= window
            for sh in range(n_sh):
                idx = np.arange(lo, hi)
                at = sh * cap + starts[first + r] + idx
                ehi, elo_u = h[at] & 0x7FF, e[at] & 0xFFFFFFFF
                freed = idx[((before[at] & 1) != 0)
                            & ((ehi < now_hi) | ((ehi == now_hi) & (elo_u < now_lo)))]
                m[sh * cap + starts[first + r] + freed] &= ~1
                out[first + r, sh, 0] = len(freed)
                out[first + r, sh, 1 : 1 + len(freed)] = torch.from_numpy(freed)
    return out


@pytest.mark.parametrize("n_sh", [1, 4])
@pytest.mark.parametrize("case", list(GROUPS))
def test_planned_launches_give_the_sequential_result(case, n_sh):
    cap, window, calls = GROUPS[case]
    rng = np.random.default_rng(len(case) + 3 * n_sh)
    cols = _columns(rng, n_sh * cap, NOW, "mixed")
    calls = [(NOW + dt, starts) for dt, starts in calls]
    want, want_meta = _port_loop(cols, n_sh, calls, window, tex.sweep_windows_reference)
    got, got_meta = _port_loop(cols, n_sh, calls, window, _launched)
    assert got == want
    assert np.array_equal(got_meta, want_meta)


def test_plan_cuts_only_at_sixteen_windows():
    starts = [i * 128 for i in range(23)] + [2872, 0, 128]
    plan = tex.plan_launches(starts, 128)
    assert [(first, len(owned)) for first, owned in plan] == [(0, 16), (16, 10)]
    # The tail leaves its overlap to the window before it; after the wrap
    # window 0 owns all of itself (the tail's range is [2872, 3000)).
    assert plan[1][1][6:] == [(0, 128), (2944 - 2872, 128), (0, 128), (0, 128)]
    assert tex.plan_launches([0, 0, 5], 10)[0][1] == [(0, 10), (0, 0), (5, 10)]


# ---------------------------------------------------------------------------
# The engines' sweep, grouped, against the JAX engines'.


def _reqs(cls, durations, prefix):
    return [cls(name="grp", unique_key=f"{prefix}{i}", hits=1, limit=5, duration=int(d),
                algorithm=i % 2) for i, d in enumerate(durations)]


def _state_words(eng):
    return {f: w.reshape(-1) for f, w in tk.state_to_numpy(eng.state).items()}


def _ref_words(ref):
    if isinstance(ref, RefEngine):
        ref._flush_pump()
    return {f: np.asarray(getattr(ref._state, f)).reshape(-1) for f in ref._state._fields}


def _drive(port, ref, rng, per_call, n_keys, window, cap):
    """Fill, then sweep at rising instants with `per_call` windows a call;
    returns the windows each call swept."""
    port.SWEEP_WINDOW = ref.SWEEP_WINDOW = window
    now = port.clock.now_ms()
    for b in range(4):
        durations = rng.choice([500, 2_000, 9_000, 600_000], n_keys // 4)
        want = ref.get_rate_limits(_reqs(RefReq, durations, f"b{b}_"), now_ms=now)
        got = port.get_rate_limits(_reqs(RateLimitReq, durations, f"b{b}_"), now_ms=now)
        assert [(int(g.status), g.remaining, g.reset_time) for g in got] == [
            (int(w.status), w.remaining, w.reset_time) for w in want]
        now += 300
    n_windows = -(-cap // min(cap, window))
    swept = []
    for k in per_call:
        now += 1_500
        assert port.sweep(now_ms=now, max_windows=k) == ref.sweep(now_ms=now, max_windows=k)
        assert port._sweep_cursor == ref._sweep_cursor
        swept.append(n_windows if k is None else min(k, n_windows))
    return swept


def _counted(port, swept):
    assert port.sweep_windows_total == sum(swept)
    assert port.sweep_groups_total == sum(-(-w // tex.READBACK_GROUP) for w in swept)
    assert port.sweep_groups_total < port.sweep_windows_total


def test_dense_engine_sweeps_in_groups_like_the_reference():
    """cap 3000 in windows of 128: 23 and a clamped tail at 2872; calls of
    20, all and 5 windows, so groups hold the tail, wrap and resume."""
    rng = np.random.default_rng(11)
    ref = RefEngine(capacity=3000, clock=RefClock().freeze_at(T0_NS))
    port = DecisionEngine(3000, clock=Clock().freeze_at(T0_NS), device="cpu")
    swept = _drive(port, ref, rng, [20, None, 5, 24], 2800, 128, 3000)
    want, got = _ref_words(ref), _state_words(port)
    for f in tk.BucketState._fields:
        assert np.array_equal(got[f], want[f]), f
    assert port.cache_size() == ref.cache_size()
    _counted(port, swept)


def test_sharded_engine_sweeps_in_groups_like_the_reference():
    """4 shards of 1000 in windows of 128: 7 and a clamped tail at 872 of
    every shard."""
    rng = np.random.default_rng(12)
    ref = RefSharded(shard_capacity=1000, mesh=make_mesh(jax.devices()[:4]),
                     clock=RefClock().freeze_at(T0_NS), single_program=True)
    port = ShardedDecisionEngine(1000, n_shards=4, clock=Clock().freeze_at(T0_NS), device="cpu")
    swept = _drive(port, ref, rng, [5, None, 6, 8], 3200, 128, 1000)
    want, got = _ref_words(ref), _state_words(port)
    for f in tk.BucketState._fields:
        assert np.array_equal(got[f], want[f]), f
    assert port.cache_size() == ref.cache_size()
    _counted(port, swept)


def test_paged_engine_sweeps_in_groups_like_the_reference(monkeypatch):
    """Pages of 16, 64 frames (1024 device rows) over 2048 keys: the
    device windows in groups, the cold pages from the host words."""
    for k, v in (("GUBER_FUSED", "xla"), ("GUBER_PUMP", "0"), ("GUBER_PAGED", "1"),
                 ("GUBER_PAGE_SIZE", "16"), ("GUBER_PAGED_RESIDENT", "64")):
        monkeypatch.setenv(k, v)
    rng = np.random.default_rng(13)
    ref = RefEngine(capacity=2048, clock=RefClock().freeze_at(T0_NS))
    port = DecisionEngine(2048, clock=Clock().freeze_at(T0_NS), device="cpu")
    assert port.paging is not None and port.capacity == ref.capacity == 1024
    swept = _drive(port, ref, rng, [3, None, 8], 1600, 96, 1024)
    assert (port.paging.faults, port.paging.spills) == (ref.paging.faults, ref.paging.spills)
    assert np.array_equal(port.paging.host_words, ref.paging.host_words)
    want, got = _ref_words(ref), _state_words(port)
    for f in tk.BucketState._fields:
        assert np.array_equal(got[f], want[f]), f
    assert port.cache_size() == ref.cache_size()
    _counted(port, swept)
