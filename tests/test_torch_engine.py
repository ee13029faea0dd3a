"""The port's DecisionEngine (device="cpu") against the JAX package's.

Both engines run on frozen clocks at the same instant and take the same
seeded request streams, through `get_rate_limits` (dataclasses) and
through `apply_columnar` (numpy columns).  Every response must be equal,
and so must the final state words of every live key.  The JAX engine
collapses hot-key batches and serves one-config batches in its narrow
uniform format; the port runs everything as rounds, so the comparison
also holds the reference's exact-sequential collapse to the rounds path.
"""

from __future__ import annotations

import numpy as np
import pytest

from gubernator_tpu.clock import Clock as RefClock
from gubernator_tpu.core.engine import DecisionEngine as RefEngine
from gubernator_tpu.types import RateLimitReq as RefReq
from gubernator_tpu_torch.clock import Clock
from gubernator_tpu_torch.core.engine import DecisionEngine
from gubernator_tpu_torch.ops import bucket_kernel as tk
from gubernator_tpu_torch.types import Behavior, RateLimitReq

GREG = int(Behavior.DURATION_IS_GREGORIAN)
RESET = int(Behavior.RESET_REMAINING)
T0_NS = 1_760_000_000_123 * 1_000_000


def _pair(capacity):
    ref = RefEngine(capacity=capacity, clock=RefClock().freeze_at(T0_NS))
    port = DecisionEngine(capacity, clock=Clock().freeze_at(T0_NS), device="cpu")
    return ref, port


def _advance(ref, port, ms):
    ref.clock.advance(ms=ms)
    port.clock.advance(ms=ms)


def _rows(rng, keys, n, *, greg=True, invalid_greg=False):
    """n request rows (key, algo, behavior, hits, limit, duration, burst)."""
    rows = []
    for _ in range(n):
        beh, dur = 0, int(rng.choice([0, 1, 5, 100, 1000, 9000, 30_000]))
        if rng.random() < 0.12:
            beh |= RESET
        if greg and rng.random() < 0.15:
            beh |= GREG
            dur = int(rng.integers(0, 7 if invalid_greg else 6))  # 6: invalid
        rows.append((
            keys[int(rng.integers(len(keys)))],
            int(rng.choice([0, 1])),
            beh,
            int(rng.choice([-3, -1, 0, 1, 1, 1, 2, 5, 10, 100])),
            int(rng.choice([0, 1, 2, 5, 10, 100])),
            dur,
            int(rng.choice([0, 0, 0, 5, 20])),
        ))
    return rows


def _dataclass_step(ref, port, rows):
    def make(cls):
        return [
            cls(name="t", unique_key=k, hits=h, limit=lim, duration=d, algorithm=a,
                behavior=b, burst=u)
            for k, a, b, h, lim, d, u in rows
        ]

    want = ref.get_rate_limits(make(RefReq))
    got = port.get_rate_limits(make(RateLimitReq))
    for i, (g, w) in enumerate(zip(got, want)):
        assert (g.error, int(g.status), g.limit, g.remaining, g.reset_time) == (
            w.error, int(w.status), w.limit, w.remaining, w.reset_time
        ), (i, rows[i])


def _columnar_step(ref, port, rows):
    keys = [("t_" + r[0]).encode() for r in rows]
    cols = [
        np.asarray([r[1] for r in rows], np.int32),
        np.asarray([r[2] for r in rows], np.int32),
        *(np.asarray([r[j] for r in rows], np.int64) for j in (3, 4, 5, 6)),
    ]
    want = ref.apply_columnar(list(keys), *(c.copy() for c in cols))
    got = port.apply_columnar(list(keys), *(c.copy() for c in cols))
    for name, g, w in zip(("status", "limit", "remaining", "reset"), got, want):
        assert np.array_equal(np.asarray(g), np.asarray(w)), name


def _assert_same_state(ref, port):
    """Every live key's 12 state words are equal (slots may differ)."""
    ref._flush_pump()
    ref_words = {f: np.asarray(getattr(ref._state, f)) for f in ref._state._fields}
    port_words = tk.state_to_numpy(port.state)
    assert len(ref.table) == len(port.table)
    ref_slot = {}
    for s in range(ref.capacity):
        k = ref.table.key_for_slot(s)
        if k is not None:
            ref_slot[k] = s
    for s in range(port.capacity):
        k = port.table.key_for_slot(s)
        if k is None:
            continue
        r = ref_slot[k]
        for f in tk.BucketState._fields:
            assert port_words[f][s] == ref_words[f][r], (k, f)
    if all(ref_slot.get(port.table.key_for_slot(s)) == s
           for s in range(port.capacity) if port.table.key_for_slot(s) is not None):
        ua, ub = tk.unpack_state_host(ref_words), tk.unpack_state_host(port.state)
        for f in ua:
            assert np.array_equal(ua[f], ub[f]), f


@pytest.mark.parametrize("path", ["dataclass", "columnar"])
def test_engine_parity_token_leaky_duplicates(path):
    """Mixed token/leaky traffic with duplicate keys in a batch
    (rounds), RESET_REMAINING and Gregorian intervals, time advancing
    across expiries."""
    rng = np.random.default_rng(1 if path == "dataclass" else 2)
    ref, port = _pair(512)
    keys = [f"k{i}" for i in range(40)]
    step = _dataclass_step if path == "dataclass" else _columnar_step
    for _ in range(60):
        step(ref, port, _rows(rng, keys, int(rng.integers(1, 48)),
                              invalid_greg=path == "dataclass"))
        _advance(ref, port, int(rng.choice([0, 0, 1, 3, 7, 100, 1000, 40_000])))
    _assert_same_state(ref, port)
    assert port.rounds_total >= port.batches_total  # duplicates made extra rounds


@pytest.mark.parametrize("path", ["dataclass", "columnar"])
def test_engine_parity_eviction_pressure(path):
    """Capacity below the distinct keys: LRU evictions clear slots (the
    port through its clear step) before the reusing key's first round."""
    rng = np.random.default_rng(3 if path == "dataclass" else 4)
    ref, port = _pair(64)
    keys = [f"e{i}" for i in range(200)]
    step = _dataclass_step if path == "dataclass" else _columnar_step
    for _ in range(40):
        step(ref, port, _rows(rng, keys, int(rng.integers(8, 64)), greg=False))
        _advance(ref, port, int(rng.choice([0, 1, 50])))
    assert port.table.evictions == ref.table.evictions > 0
    _assert_same_state(ref, port)


def test_engine_hot_key_batch_matches_collapse():
    """A batch of one key repeated (the reference collapses it into one
    dispatch; the port runs one round per repeat) — same answers."""
    ref, port = _pair(128)
    for algo in (0, 1):
        rows = [("hot%d" % algo, algo, 0, 1, 50, 60_000, 0)] * 70
        _columnar_step(ref, port, rows)
        _dataclass_step(ref, port, rows)
        _advance(ref, port, 7)
    _assert_same_state(ref, port)


def test_engine_gregorian_and_reset_items():
    """DURATION_IS_GREGORIAN (an invalid interval answers that item with
    the reference's error string) and RESET_REMAINING on token buckets."""
    ref, port = _pair(64)
    rows = [
        ("g", 0, GREG, 1, 10, 2, 0),  # days
        ("g", 0, GREG, 3, 10, 2, 0),
        ("bad", 0, GREG, 1, 10, 9, 0),  # not an interval
        ("lg", 1, GREG, 2, 10, 1, 0),  # leaky, hours
        ("r", 0, 0, 4, 10, 1000, 0),
        ("r", 0, RESET, 1, 10, 1000, 0),
        ("r", 0, 0, 1, 10, 1000, 0),
    ]
    _dataclass_step(ref, port, rows)
    resp = port.get_rate_limits([RateLimitReq(name="t", unique_key="bad", duration=9,
                                              behavior=GREG, limit=1, hits=1)])
    assert resp[0].error.startswith("behavior DURATION_IS_GREGORIAN is set")
    _advance(ref, port, 3_600_000)
    _dataclass_step(ref, port, rows)
    _assert_same_state(ref, port)


def test_engine_counters_and_chunking():
    """A round wider than max_kernel_width becomes sub-rounds of the same
    buffer: the batch is still one dispatch (one K1 launch); the counters
    follow (rounds count sub-rounds, clears count eviction clears)."""
    port = DecisionEngine(4096, clock=Clock().freeze_at(T0_NS), device="cpu",
                          max_kernel_width=64)
    keys = [b"c%d" % i for i in range(200)]
    n = len(keys)

    def cols(m):
        return (np.zeros(m, np.int32), np.zeros(m, np.int32), np.ones(m, np.int64),
                np.full(m, 5, np.int64), np.full(m, 1000, np.int64), np.zeros(m, np.int64))

    out = port.apply_columnar(keys, *cols(n))
    assert np.array_equal(out[2], np.full(n, 4))
    assert (port.rounds_total, port.dispatches_total, port.clears_total) == (4, 1, 0)
    assert (port.batches_total, port.requests_total, port.cache_size()) == (1, n, n)
    assert port.fused_mode == "torch-cpu"

    # 200 new keys into 128 slots: 72 keys evict slots used in round 0, so
    # their clears and requests form round 1 — still one dispatch.
    small = DecisionEngine(128, clock=Clock().freeze_at(T0_NS), device="cpu")
    out = small.apply_columnar(keys, *cols(n))
    assert np.array_equal(out[2], np.full(n, 4))
    assert (small.rounds_total, small.dispatches_total, small.clears_total) == (2, 1, 72)
    assert small.table.evictions == 72


def test_engine_refuses_to_run_without_cuda_unless_asked_for_cpu():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DecisionEngine(16)
