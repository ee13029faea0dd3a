"""The port's plain fused step against the JAX package, bit for bit.

The same seeded state (packed with `pack_state_host`, carried across
with `state_from_numpy`) and the same packed `pin` go through the JAX
package's XLA fused step (`bk.fused_step`), its Pallas kernel in
interpret mode (`pallas_fused_step(..., interpret=True)`) and the port's
`fused_step` on CPU tensors (its plain PyTorch version).  All 12 state
columns and the whole [5, W] output must be equal.  The scalar spec
(`models/spec.py`) is the oracle of the shadow fuzz and the boundary
cases, as in tests/test_fused_parity.py and tests/test_kernel_vs_spec.py.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gubernator_tpu.models.spec import SlotState, SpecInput, apply_spec
from gubernator_tpu.ops import bucket_kernel as bk
from gubernator_tpu.ops.pallas_step import pallas_fused_step
from gubernator_tpu_torch.ops import bucket_kernel as tk
from gubernator_tpu_torch.ops import fused_step as fs
from gubernator_tpu_torch.ops.collapsed_step import collapsed_step
from gubernator_tpu_torch.types import Behavior

GREG = int(Behavior.DURATION_IS_GREGORIAN)
RESET = int(Behavior.RESET_REMAINING)


def _rand_logical(rng, n, now):
    """Logical columns of a random, mostly live state around `now`."""
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


def _rand_round(rng, cap, width, now):
    """A packed round: m ≤ width unique sorted slots, random requests."""
    m = int(rng.integers(1, width + 1))
    slots = np.sort(rng.choice(cap, m, replace=False)).astype(np.int32)
    cols = [
        rng.integers(0, 3, m),  # algo (2 = out-of-enum → leaky)
        rng.choice([0, 0, GREG, RESET, GREG | RESET], m),
        rng.choice([-3, 0, 1, 1, 2, 5, 100], m),
        rng.choice([-1, 0, 1, 5, 100, 10**12], m),
        rng.choice([0, 1, 40, 1000, 30_000], m),
        rng.choice([0, 0, 5, 20, -7], m),
        rng.choice([60_000, 3_600_000, 86_400_000], m),
        now + rng.integers(0, 100_000, m),
    ]
    return tk.pack_batch_host(width, now, cap, slots, *cols)


def _jax_state(words):
    return bk.BucketState(*(jnp.asarray(words[f]) for f in bk.BucketState._fields))


def _assert_state_equal(jstate, tstate, ctx):
    got = tk.state_to_numpy(tstate)
    for f in bk.BucketState._fields:
        want = np.asarray(getattr(jstate, f))
        assert got[f].dtype == want.dtype, (ctx, f)
        assert np.array_equal(got[f], want), (ctx, f)


@pytest.mark.parametrize("width", [64, 256])
def test_plain_step_bit_equal_to_xla_and_pallas(width):
    """Random states and rounds: the port's plain step, the XLA fused
    step and the Pallas kernel (interpret) agree on every word."""
    rng = np.random.default_rng(width)
    cap, now = 1024, 5_000_000
    words = bk.pack_state_host(_rand_logical(rng, cap, now))
    xla, pallas = _jax_state(words), _jax_state(words)
    port = tk.state_from_numpy(words, "cpu")
    for it in range(6):
        now += int(rng.integers(0, 400))
        buf = _rand_round(rng, cap, width, now)
        xla, want = bk.fused_step(xla, jnp.asarray(buf))
        pallas, want_p = pallas_fused_step(pallas, jnp.asarray(buf), interpret=True)
        got = fs.fused_step(port, torch.from_numpy(buf))
        assert np.array_equal(np.asarray(want), np.asarray(want_p)), it
        assert np.array_equal(got.numpy(), np.asarray(want)), it
        _assert_state_equal(xla, port, it)
        _assert_state_equal(pallas, port, it)


def test_extreme_values_saturate_like_the_reference():
    """A leaky bucket with a huge limit and a tiny duration
    drives `elapsed / rate` past 2^63, where XLA:CPU's f64→int64
    conversion saturates (a plain tensor cast does not).  Huge and
    negative limits, bursts and hits, timestamps past the 43-bit clamp
    and int64 wrap of `now + duration` ride along."""
    cap, width, now = 64, 64, 1_700_000_000_000
    big = 2**62
    logical = dict(
        occupied=np.ones(cap, bool),
        algo=np.ones(cap, np.int64),
        status=np.zeros(cap, np.int64),
        t0=np.full(cap, 1),  # elapsed ≈ 1.7e12 ms
        invalid=np.zeros(cap, np.int64),
        expire=np.full(cap, now + 10),
        duration=np.full(cap, 1),
        limit=np.full(cap, big),
        remaining=np.zeros(cap, np.int64),
        remf_hi=np.full(cap, 2**31 - 1, np.int32),
        remf_lo=np.full(cap, 2**32 - 1, np.uint32),
        burst=np.full(cap, big),
    )
    logical["algo"][::4] = 0
    words = bk.pack_state_host(logical)
    m = 48
    slots = np.arange(m, dtype=np.int32)
    hits = np.resize(np.array([0, 1, -(2**62), 2**62, 2**63 - 1, -(2**63)], np.int64), m)
    limit = np.resize(np.array([big, 2**63 - 1, 1, -(2**63), 3, big], np.int64), m)
    dur = np.resize(np.array([1, 2**63 - 1, -(2**63), 0, 7, 2**43 + 5], np.int64), m)
    burst = np.resize(np.array([0, big, -(2**63), 2**63 - 1, 1], np.int64), m)
    algo = np.resize(np.array([1, 1, 0, 1, 5], np.int32), m)
    beh = np.resize(np.array([0, RESET, GREG, GREG | RESET, 0, 0, 0], np.int32), m)
    gdur = np.resize(np.array([0, 1, 2**63 - 1, 86_400_000], np.int64), m)
    gexp = np.resize(np.array([now, 2**63 - 1, -(2**63), now + 1], np.int64), m)
    buf = tk.pack_batch_host(width, now, cap, slots, algo, beh, hits, limit, dur, burst, gdur, gexp)
    xla, port = _jax_state(words), tk.state_from_numpy(words, "cpu")
    pallas = _jax_state(words)
    for step in range(3):
        xla, want = bk.fused_step(xla, jnp.asarray(buf))
        pallas, want_p = pallas_fused_step(pallas, jnp.asarray(buf), interpret=True)
        got = fs.fused_step(port, torch.from_numpy(buf))
        assert np.array_equal(np.asarray(want_p), np.asarray(want)), step
        assert np.array_equal(got.numpy(), np.asarray(want)), step
        _assert_state_equal(xla, port, step)
        buf[0, 1] += 997  # advance `now` (low word) between steps


def test_saturating_conversions_match_xla():
    x = np.array(
        [1e30, -1e30, np.nan, 9.3e18, -9.3e18, 2.0**63, -(2.0**63), 1.5, -1.5, -0.5,
         4294967295.9, 4294967296.0, -1.0, np.inf, -np.inf, 2**31 - 0.5, -(2**31) - 0.5]
    )
    t = torch.from_numpy(x)
    assert np.array_equal(tk.f64_to_i64(t).numpy(), np.asarray(jnp.asarray(x).astype(jnp.int64)))
    assert np.array_equal(tk.f64_to_u32(t).numpy(), np.asarray(jnp.asarray(x).astype(jnp.uint32)))
    assert np.array_equal(tk.f64_to_i32(t).numpy(), np.asarray(jnp.asarray(x).astype(jnp.int32)))


class TorchShadow:
    """Drives the port's fused step directly (CPU): key → slot on the
    host, packed rounds through `fused_step` — the serving layout minus
    the engine (tests/test_fused_parity.py PallasShadow, ported)."""

    def __init__(self, capacity: int = 512, width: int = 64):
        self.capacity = capacity
        self.width = width
        self.state = tk.make_state(capacity, "cpu")
        self.slots: dict[bytes, int] = {}

    def _slot(self, key: bytes) -> int:
        return self.slots.setdefault(key, len(self.slots))

    def apply(self, rows, now_ms: int):
        """rows: [(key, algo, behavior, hits, limit, duration, burst,
        greg_dur, greg_exp)] with unique keys → [(status, limit,
        remaining, reset)] in row order."""
        m = len(rows)
        slot = np.asarray([self._slot(r[0]) for r in rows], np.int32)
        order = np.argsort(slot, kind="stable")
        cols = [np.asarray([r[j] for r in rows], np.int64) for j in range(1, 9)]
        buf = tk.pack_batch_host(
            self.width, now_ms, self.capacity, np.ascontiguousarray(slot[order]),
            *(c[order] for c in cols),
        )
        pout = fs.fused_step(self.state, torch.from_numpy(buf))
        st, rem, rst = tk.unpack_out_host(pout.numpy(), m)
        inv = np.empty(m, np.int64)
        inv[order] = np.arange(m)
        return [
            (int(st[inv[i]]), int(cols[3][i]), int(rem[inv[i]]), int(rst[inv[i]]))
            for i in range(m)
        ]


class SpecShadow:
    def __init__(self):
        self.states: dict[bytes, SlotState] = {}

    def apply(self, rows, now_ms: int):
        out = []
        for key, algo, behavior, hits, limit, duration, burst, gdur, gexp in rows:
            inp = SpecInput(
                hits=int(hits), limit=int(limit), duration=int(duration), burst=int(burst),
                algorithm=int(algo), behavior=int(behavior),
                greg_duration=int(gdur), greg_expire=int(gexp),
            )
            state, resp = apply_spec(self.states.get(key), inp, now_ms)
            if state is None:
                self.states.pop(key, None)
            else:
                self.states[key] = state
            out.append(
                (int(resp.status), int(resp.limit), int(resp.remaining), int(resp.reset_time))
            )
        return out


def _spec_rows(rng, keys, n, now):
    rows, seen = [], set()
    for _ in range(n):
        key = keys[int(rng.integers(len(keys)))]
        if key in seen:  # one lane per key and round (the rounds invariant)
            continue
        seen.add(key)
        behavior, duration, gdur, gexp = 0, int(rng.choice([1, 40, 200, 1000])), 0, 0
        if rng.random() < 0.1:
            behavior |= RESET
        if rng.random() < 0.15:
            behavior |= GREG
            duration = int(rng.integers(0, 6))
            gdur = [60_000, 3_600_000, 86_400_000][duration % 3]
            gexp = now + int(rng.integers(0, gdur))
        rows.append((
            key, int(rng.choice([0, 1])), behavior,
            int(rng.choice([-2, 0, 1, 1, 1, 2, 5, 11])),
            int(rng.choice([0, 1, 3, 10, 50])),
            duration, int(rng.choice([0, 0, 0, 5, 20])), gdur, gexp,
        ))
    return rows


@pytest.mark.parametrize("seed", [11, 12])
def test_shadow_fuzz_bit_equal_to_spec(seed):
    """Token + leaky, RESET_REMAINING, Gregorian and negative hits
    across advancing time (expiries crossed): every response field of
    the port's step equals the scalar spec."""
    rng = np.random.default_rng(seed)
    shadow, oracle = TorchShadow(), SpecShadow()
    keys = [b"fz_%d" % i for i in range(24)]
    now = 1_000_000
    for step in range(120):
        now += int(rng.integers(0, 120))
        rows = _spec_rows(rng, keys, int(rng.integers(1, 16)), now)
        assert shadow.apply(rows, now) == oracle.apply(rows, now), (step, now, rows)


def _row(key, algo, hits, limit, duration):
    return (key, algo, 0, hits, limit, duration, 0, 0, 0)


def test_duration_change_renewal_boundary():
    """The renewal quirk (stored remaining becomes limit, the response
    reports the pre-renewal snapshot) on both sides of `new_expire <= now`."""
    shadow, oracle = TorchShadow(), SpecShadow()
    now, key = 50_000, b"renew"
    for row, dt in [
        (_row(key, 0, 3, 10, 100), 0),
        (_row(key, 0, 1, 10, 100), 40),
        (_row(key, 0, 1, 10, 70), 0),
        (_row(key, 0, 1, 10, 100), 65),
        (_row(key, 0, 1, 10, 30), 0),
        (_row(key, 0, 0, 10, 30), 0),
    ]:
        now += dt
        assert shadow.apply([row], now) == oracle.apply([row], now), (row, now)


def test_expiry_boundary_exact():
    """`expire_at < now` is a strict miss; equality still serves the item."""
    shadow, oracle = TorchShadow(), SpecShadow()
    key, base = b"edge", 10_000
    row = _row(key, 0, 2, 5, 100)
    assert shadow.apply([row], base) == oracle.apply([row], base)
    for now in (base + 100, base + 101):
        row = _row(key, 0, 1, 5, 100)
        assert shadow.apply([row], now) == oracle.apply([row], now), now


def test_leaky_fractional_leak():
    """Fractional leak accrues by leaving t0 untouched; the 32.32 fixed
    point must track the spec's quantization exactly."""
    shadow, oracle = TorchShadow(), SpecShadow()
    key, now = b"leak", 77_000
    row = _row(key, 1, 3, 7, 700)
    assert shadow.apply([row], now) == oracle.apply([row], now)
    for dt in (30, 30, 30, 110, 1, 49, 1000):
        now += dt
        row = _row(key, 1, 1, 7, 700)
        assert shadow.apply([row], now) == oracle.apply([row], now), now


def test_host_helpers_byte_equal_to_reference():
    rng = np.random.default_rng(5)
    n, now = 300, 1_234_567_890_123
    logical = _rand_logical(rng, n, now)
    logical["t0"][:5] = [-1, 0, 2**43, 2**50, 2**43 - 1]  # clamp edges
    a, b = bk.pack_state_host(logical), tk.pack_state_host(logical)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    ua = bk.unpack_state_host(_jax_state(a))
    ub = tk.unpack_state_host(tk.state_from_numpy(b, "cpu"))
    assert ua.keys() == ub.keys()
    for k in ua:
        assert np.asarray(ua[k]).dtype == ub[k].dtype and np.array_equal(ua[k], ub[k]), k

    for m, size in [(1, 64), (64, 64), (100, 256)]:
        slots = np.sort(rng.choice(4096, m, replace=False)).astype(np.int32)
        cols = [rng.integers(-(2**31), 2**31, m).astype(np.int32) for _ in range(2)] + [
            rng.integers(-(2**63), 2**63 - 1, m, dtype=np.int64) for _ in range(6)
        ]
        pa = bk.pack_batch_host(size, now, 4096, slots, *cols)
        pb = tk.pack_batch_host(size, now, 4096, slots, *cols)
        assert pa.dtype == pb.dtype and np.array_equal(pa, pb)
        out = rng.integers(-(2**31), 2**31, (tk.PACKED_OUT_ROWS, size)).astype(np.int32)
        for x, y in zip(bk.unpack_out_host(out, m), tk.unpack_out_host(out, m)):
            assert x.dtype == y.dtype and np.array_equal(x, y)


def test_state_carry_across_round_trip():
    """JAX-typed columns → port state → numpy gives back every word, and
    the uint32 columns travel as their int32 bit patterns."""
    rng = np.random.default_rng(9)
    words = bk.pack_state_host(_rand_logical(rng, 512, 10**12))
    words["rem_lo"][:3] = [0, 2**31, 2**32 - 1]
    state = tk.state_from_numpy(words, "cpu")
    assert all(col.dtype == torch.int32 and col.shape == (512,) for col in state)
    assert state.rem_lo[1].item() == -(2**31) and state.rem_lo[2].item() == -1
    back = tk.state_to_numpy(state)
    for f in bk.BucketState._fields:
        assert back[f].dtype == words[f].dtype and np.array_equal(back[f], words[f]), f
    _assert_state_equal(_jax_state(words), state, "carry")


def test_clear_occupied_matches_reference():
    rng = np.random.default_rng(3)
    cap = 2048
    meta = rng.integers(0, 2**26, cap).astype(np.int32)
    for n in (16, 64, 256):
        k = int(rng.integers(1, n + 1))
        c = np.arange(cap, cap + n, dtype=np.int64).astype(np.int32)
        c[:k] = np.sort(rng.choice(cap, k, replace=False))
        want = np.asarray(bk.clear_occupied(jnp.asarray(meta), jnp.asarray(c)))
        got = torch.from_numpy(meta.copy())
        fs.clear_occupied(got, torch.from_numpy(c))
        assert np.array_equal(got.numpy(), want), n
        meta = want


def test_wrappers_route_cpu_tensors_to_the_plain_version():
    """On CPU tensors the wrappers run the plain versions and count no
    kernel launch; another device type raises."""
    fs.reset_launches()
    state = tk.make_state(128, "cpu")
    buf = tk.pack_batch_host(64, 1000, 128, np.array([3], np.int32), *([np.array([1])] * 8))
    pout = fs.fused_step(state, torch.from_numpy(buf))
    assert pout.shape == (tk.PACKED_OUT_ROWS, 64) and pout.dtype == torch.int32
    assert tk.unpack_state_host(state)["occupied"][3]
    fs.clear_occupied(state.meta, torch.tensor([3] + list(range(128, 143)), dtype=torch.int32))
    assert not tk.unpack_state_host(state)["occupied"][3]
    uni = tk.pack_uniform_rounds_host(1000, 128, [1], np.array([5], np.int32),
                                      (0, 0, 1, 5, 1000, 0), [[]])
    views = [torch.from_numpy(a) for a in (uni.pin, uni.round_off, uni.clear_off,
                                           uni.clear_slots)]
    assert fs.multi_uniform_step(state, *views).shape == (tk.UNIFORM_OUT_ROWS, 32)
    assert tk.unpack_state_host(state)["remaining"][5] == 4
    col = tk.pack_collapsed_host(32, 1000, 128, np.array([7], np.int32), np.array([3]),
                                 tuple(np.array([v]) for v in (0, 0, 1, 5, 1000, 0, 0, 0)),
                                 np.zeros(3, np.int32), np.arange(3, dtype=np.int32))
    pout = collapsed_step(state, torch.from_numpy(col), torch.tensor([], dtype=torch.int32))
    assert tk.unpack_out_host(pout.numpy(), 3)[1].tolist() == [4, 3, 2]
    rec = tk.pack_restore_host(tk.build_restore_record([], 128))
    fs.load_slots(state, torch.from_numpy(rec))
    from gubernator_tpu_torch.ops.expiry import sweep_window

    assert int(sweep_window(state.meta, state.hi2, state.expire_lo, 0, 0, 128)[0]) == 0
    from gubernator_tpu_torch.ops import sketch as ps

    counts = torch.zeros((2, 1, 64), dtype=torch.int32)
    pin = torch.zeros((ps.pin_rows(1), 64), dtype=torch.int32)
    pin[1, 0] = pin[3, 0] = 2
    pin[2] = torch.arange(64)
    assert ps.sketch_step(counts, pin, 0)[1, 0] == 2 and counts[0, 0, 0] == 2
    assert ps.sketch_rotate(counts, 0, 1) == 1 and counts[1].abs().sum() == 0
    from gubernator_tpu_torch.ops import page_words as pw

    starts = torch.tensor([0, 112], dtype=torch.int32)
    block = pw.gather_pages(state, starts, 16)
    assert block.shape == (2, 12, 16) and int(block[0, 0, 3]) == int(state.meta[3])
    pw.load_pages(state, starts.flip(0), block)
    assert int(state.meta[115]) == int(block[0, 0, 3])
    from gubernator_tpu_torch.ops import sharded_step as ss
    from gubernator_tpu_torch.ops.expiry import shard_sweep_window

    spin = np.stack([tk.pack_batch_host(64, 1000, 64, np.array([9], np.int32),
                                        *([np.array([1])] * 8))] * 2)
    rows = torch.from_numpy(ss.shard_clear_rows([[], [9]], 64))
    assert ss.shard_step(state, torch.from_numpy(spin), 64, rows).shape == (2, 5, 64)
    scol = np.stack([tk.pack_collapsed_host(32, 1000, 64, np.array([7], np.int32),
                                            np.array([3]), tuple(np.array([v]) for v in
                                                                 (0, 0, 1, 5, 1000, 0, 0, 0)),
                                            np.zeros(3, np.int32), np.arange(3, dtype=np.int32))]
                    * 2)
    assert ss.shard_collapsed_step(state, torch.from_numpy(scol), 64, rows).shape == (2, 5, 32)
    assert shard_sweep_window(state.meta, state.hi2, state.expire_lo, 2, 0, 0, 64).shape == (2, 65)
    from gubernator_tpu_torch import ops

    batch = ops.BatchInput(*(torch.tensor([9, 64], dtype=dt) for dt in
                             (torch.int32,) * 3 + (torch.int64,) * 6))
    assert ops.apply_batch(state, batch, torch.tensor([9], dtype=torch.int32),
                           1000).status.shape == (2,)
    assert fs.launches == {"fused_step": 0, "clear_occupied": 0, "collapsed_step": 0,
                           "uniform_step": 0, "load_slots": 0, "sweep_window": 0,
                           "sketch_step": 0, "sketch_rotate": 0, "gather_pages": 0,
                           "load_pages": 0, "shard_step": 0, "shard_collapsed": 0,
                           "shard_sweep": 0, "apply_batch": 0}
    meta_state = tk.BucketState(*(torch.empty(8, dtype=torch.int32, device="meta") for _ in range(12)))
    with pytest.raises(ValueError):
        fs.fused_step(meta_state, torch.empty((16, 64), dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError):
        collapsed_step(meta_state, torch.empty((19, 64), dtype=torch.int32, device="meta"),
                       torch.empty(0, dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError):
        fs.multi_uniform_step(meta_state, *(v.to("meta") for v in views))
    with pytest.raises(ValueError):
        fs.fused_step(state, torch.zeros((5, 64), dtype=torch.int32))
