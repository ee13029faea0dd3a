"""The port's step pump, asynchronous readback and uniform narrow format
against the JAX package's.

* `multi_uniform_step_reference` (the plain version of kernel K4) against
  the JAX `multi_uniform_step` (`_multi_uniform_core`, a scan over
  stacked pins) and against per-round `clear_occupied` + `uniform_step`
  on ragged rounds with clears; bit for bit in pout and state.
* The uniform gate's accept and reject cases (tests/test_uniform_path.py)
  through the port engine and the JAX engine, pump on.
* `want_async` pipelines against synchronous calls; queued batches join
  one launch; the pump's order holds under interleaved collapse, clears
  and fetches; a failed launch fails every queued ticket closed.
* The port engine against the JAX engine with the pump on and off
  (off: the port's pump launches at submit; the narrow format stays).

GUBER_PUMP is set with monkeypatch before the engines are made (both
packages read it at construction; tests/conftest.py defaults it to 1).
The tolerance is exact.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_engine import (
    T0_NS,
    _advance,
    _assert_same_state,
    _columnar_step,
    _dataclass_step,
    _pair,
    _rows,
)
from test_torch_multi_round import _assert_state_equal, _jax_state, _rand_logical

from gubernator_tpu.ops import bucket_kernel as bk
from gubernator_tpu_torch.clock import Clock
from gubernator_tpu_torch.core import engine as engine_mod
from gubernator_tpu_torch.core.pump import MAX_GROUP
from gubernator_tpu_torch.ops import bucket_kernel as tk
from gubernator_tpu_torch.ops import fused_step as fs


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _uniform_cfg(rng, algo=None):
    return (int(rng.integers(0, 2)) if algo is None else algo, 0, int(rng.integers(-2, 6)),
            int(rng.integers(0, 60)), int(rng.integers(1, 90_000)), int(rng.integers(0, 70)))


@pytest.mark.parametrize("n_rounds", [1, 2, 4])
def test_plain_multi_uniform_step_bit_equal_to_jax_scan(n_rounds):
    """Equal-width rounds, each with its own `now` and config: one port
    call equals the JAX scan over the stacked pins."""
    rng = np.random.default_rng(200 + n_rounds)
    cap, width, now = 256, 64, 5_000_000
    words = bk.pack_state_host(_rand_logical(rng, cap, now))
    jstate, port = _jax_state(words), tk.state_from_numpy(words, "cpu")
    for it in range(3):
        pins = []
        for r in range(n_rounds):
            m = int(rng.integers(1, width + 1))
            slots = np.sort(rng.choice(cap, m, replace=False)).astype(np.int32)
            pins.append(bk.pack_uniform_host(width, now + 7 * r, cap, slots,
                                             *_uniform_cfg(rng)))
        jstate, want = bk.multi_uniform_step(jstate, jnp.asarray(np.stack(pins)))
        want = np.concatenate(list(np.asarray(want)), axis=1)
        got = fs.multi_uniform_step(port, _t(np.concatenate(pins, axis=1)),
                                    _t(np.arange(n_rounds + 1, dtype=np.int32) * width),
                                    torch.zeros(n_rounds + 1, dtype=torch.int32),
                                    torch.tensor([cap], dtype=torch.int32))
        assert np.array_equal(got.numpy(), want), it
        _assert_state_equal(jstate, port, it)
        now += int(rng.integers(0, 40_000))


def test_plain_multi_uniform_step_ragged_rounds_with_clears():
    """Ragged uniform rounds with clears (a slot cleared and reused in one
    round, one recurring in every round) against the reference's per-round
    clear then `uniform_step`."""
    rng = np.random.default_rng(17)
    cap, now = 256, 1_700_000_000_000
    words = bk.pack_state_host(_rand_logical(rng, cap, now))
    jstate, port = _jax_state(words), tk.state_from_numpy(words, "cpu")
    for it in range(4):
        counts = [50, 3, 64, 1, 33]
        slots = [np.sort(np.append(rng.choice(np.arange(1, cap), m - 1, replace=False), 0))
                 .astype(np.int32) for m in counts]
        clears = [[], [int(slots[0][1])], [], [0, cap + 1], [int(s) for s in slots[2][:4]]]
        cfg = _uniform_cfg(rng, algo=it % 2)
        packed = tk.pack_uniform_rounds_host(now, cap, counts, np.concatenate(slots), cfg,
                                             clears)
        outs = []
        for r, m in enumerate(counts):
            if clears[r]:
                c = np.arange(cap, cap + 16, dtype=np.int32)
                c[: len(clears[r])] = clears[r]
                jstate = jstate._replace(meta=bk.clear_occupied(jstate.meta, jnp.asarray(c)))
            lo, hi = packed.round_off[r], packed.round_off[r + 1]
            pin = bk.pack_uniform_host(int(hi - lo), now, cap, slots[r], *cfg)
            assert np.array_equal(pin, packed.pin[:, lo:hi])
            jstate, out = bk.uniform_step(jstate, jnp.asarray(pin))
            outs.append(np.asarray(out))
        got = fs.multi_uniform_step(port, _t(packed.pin), _t(packed.round_off),
                                    _t(packed.clear_off), _t(packed.clear_slots))
        assert np.array_equal(got.numpy(), np.concatenate(outs, axis=1)), it
        _assert_state_equal(jstate, port, it)
        now += 1_000


def _uniform_apply(engine, keys, now, **cfg):
    n = len(keys)
    return engine.apply_columnar(
        list(keys),
        np.full(n, cfg.get("algo", 0), np.int32), np.full(n, cfg.get("behavior", 0), np.int32),
        np.full(n, cfg.get("hits", 1), np.int64), np.full(n, cfg.get("limit", 100), np.int64),
        np.full(n, cfg.get("duration", 60_000), np.int64),
        np.full(n, cfg.get("burst", 0), np.int64), now_ms=now,
    )


class _Formats:
    """Records the format of every submission to the engine's pump."""

    def __init__(self, engine):
        self.uniform = []
        orig = engine._pump.submit

        def spy(packed):
            self.uniform.append(packed.pin.shape[0] == tk.UNIFORM_IN_ROWS)
            return orig(packed)

        engine._pump.submit = spy


def test_uniform_gate_accepts_and_rejects(monkeypatch):
    """The gate's boundaries (tests/test_uniform_path.py): in-range
    single-config batches go narrow, out-of-range values, RESET_REMAINING
    and mixed configs go general; every answer equals the JAX engine's."""
    monkeypatch.setenv("GUBER_PUMP", "1")
    ref, port = _pair(4096)
    fmt = _Formats(port)
    cases = [
        (dict(limit=2**31 - 1), True),  # the largest limit the gate takes
        (dict(limit=2**31 + 5), False),
        (dict(duration=2**31 + 1), False),
        (dict(hits=2**31), False),
        (dict(limit=2**31 - 2, burst=2**30), True),
        (dict(behavior=8), False),  # RESET_REMAINING
        (dict(algo=1, hits=3, limit=10, burst=4), True),
        (dict(duration=0), False),
    ]
    for i, (cfg, narrow) in enumerate(cases):
        keys = [b"g%d_%d" % (i, j) for j in range(10)]
        got = _uniform_apply(port, keys, 7_000_000, **cfg)
        want = _uniform_apply(ref, keys, 7_000_000, **cfg)
        for g, w in zip(got, want):
            assert np.array_equal(np.asarray(g), np.asarray(w)), cfg
        assert fmt.uniform[-1] is narrow, cfg
    # One field differing across the batch: general.
    _columnar_step(ref, port, [("x", 0, 0, 1, 5, 1000, 0), ("y", 0, 0, 2, 5, 1000, 0)])
    assert fmt.uniform[-1] is False
    _assert_same_state(ref, port)


def test_uniform_format_with_queueing_off(monkeypatch):
    """GUBER_PUMP=0 turns off queueing, not the narrow format: a
    single-config batch still goes narrow (K4's plain version here) and
    answers as the JAX engine, whose pump is off, answers in the general
    format."""
    monkeypatch.setenv("GUBER_PUMP", "0")
    ref, port = _pair(4096)
    assert ref._pump is None and not port._pump.queueing
    fmt = _Formats(port)
    for i, cfg in enumerate([dict(), dict(algo=1, hits=3, limit=10, burst=4)]):
        keys = [b"q%d_%d" % (i, j) for j in range(10)]
        got = _uniform_apply(port, keys, 7_000_000 + i, **cfg)
        want = _uniform_apply(ref, keys, 7_000_000 + i, **cfg)
        for g, w in zip(got, want):
            assert np.array_equal(np.asarray(g), np.asarray(w)), cfg
        assert fmt.uniform[-1] is True
    assert port._pump.flushes == port._pump.submitted == 2
    _assert_same_state(ref, port)


def test_uniform_fuzz_matches_jax(monkeypatch):
    """Random single-config batches with duplicates (rounds and
    collapse), RESET_REMAINING mixed in: port engine == JAX engine."""
    monkeypatch.setenv("GUBER_PUMP", "1")
    ref, port = _pair(4096)
    fmt = _Formats(port)
    rng = np.random.default_rng(42)
    for step in range(25):
        b = int(rng.integers(2, 300))
        keys = [b"f%d" % i for i in rng.integers(0, 80, b)]
        cfg = dict(algo=int(rng.integers(0, 2)), behavior=[0, 0, 8, 0][step % 4],
                   hits=int(rng.integers(-2, 6)), limit=int(rng.integers(0, 60)),
                   duration=int(rng.integers(1, 90_000)), burst=int(rng.integers(0, 70)))
        now = 5_000_000 + step * int(rng.integers(0, 40_000))
        got = _uniform_apply(port, keys, now, **cfg)
        want = _uniform_apply(ref, keys, now, **cfg)
        for g, w in zip(got, want):
            assert np.array_equal(np.asarray(g), np.asarray(w)), (step, cfg)
    _assert_same_state(ref, port)
    assert any(fmt.uniform)


def _cols(n, hits=1):
    return (np.zeros(n, np.int32), np.zeros(n, np.int32), np.full(n, hits, np.int64),
            np.full(n, 1000, np.int64), np.full(n, 60_000, np.int64), np.zeros(n, np.int64))


def test_async_batches_join_one_launch_and_match_sync(monkeypatch):
    """Three asynchronous batches (one uniform, two general) then a
    fetch: the queue runs as one launch per run of one format, and the
    answers equal the same batches run synchronously."""
    monkeypatch.setenv("GUBER_PUMP", "1")
    eng = engine_mod.DecisionEngine(2048, clock=Clock().freeze_at(T0_NS), device="cpu")
    sync = engine_mod.DecisionEngine(2048, clock=Clock().freeze_at(T0_NS), device="cpu")
    rng = np.random.default_rng(5)
    batches = []
    for r in range(6):
        keys = [b"s%d" % i for i in rng.integers(0, 30, 25)]
        cols = list(_cols(25, hits=r % 3))
        if r % 3:  # mixed configs: the general format
            cols[3] = rng.integers(1, 50, 25)
        batches.append((keys, cols))
    pend = [eng.apply_columnar(k, *c, want_async=True) for k, c in batches]
    assert eng._pump.flushes == 0 or eng._pump.submitted > eng._pump.flushes
    outs = [p.get() for p in pend]
    for (k, c), got in zip(batches, outs):
        want = sync.apply_columnar(k, *c)
        for g, w in zip(got, want):
            assert np.array_equal(g, w)
    assert eng.dispatches_total < len(batches) <= sync.dispatches_total
    assert eng._pump.fused_rounds >= eng._pump.submitted
    assert eng.over_limit_total == sync.over_limit_total
    for a, b in zip(tk.state_to_numpy(eng.state).values(), tk.state_to_numpy(sync.state).values()):
        assert np.array_equal(a, b)


def test_pump_order_under_collapse_clears_and_fetches(monkeypatch):
    """Async batches on a shared hot key, interleaved with a collapsed
    batch (which flushes the queue first), an evicting batch (clears
    inside the launch) and early fetches: the JAX engine in the same
    order answers alike."""
    monkeypatch.setenv("GUBER_PUMP", "1")
    ref, port = _pair(32)
    rng = np.random.default_rng(8)
    pend_p, pend_r = [], []
    for r in range(40):
        kind = r % 5
        if kind == 3:  # hot: collapse
            keys = [b"hot"] * int(rng.integers(2, 12))
        elif kind == 4:  # many new keys: evictions
            keys = [b"e%d_%d" % (r, i) for i in range(20)]
        else:
            keys = [b"hot"] + [b"k%d" % i for i in rng.integers(0, 20, 8)]
        cols = _cols(len(keys), hits=int(rng.integers(0, 3)))
        pend_p.append(port.apply_columnar(keys, *cols, want_async=True))
        pend_r.append(ref.apply_columnar(keys, *cols, want_async=True))
        if r % 7 == 6:  # fetch something old, not the newest
            k = int(rng.integers(0, len(pend_p)))
            for g, w in zip(pend_p[k].get(), pend_r[k].get()):
                assert np.array_equal(np.asarray(g), np.asarray(w)), (r, k)
    for k in reversed(range(len(pend_p))):
        for g, w in zip(pend_p[k].get(), pend_r[k].get()):
            assert np.array_equal(np.asarray(g), np.asarray(w)), k
    assert port.table.evictions == ref.table.evictions > 0
    assert port.clears_total > 0 and port._pump.flushes < port._pump.submitted
    _assert_same_state(ref, port)


def test_pump_flushes_at_max_group(monkeypatch):
    monkeypatch.setenv("GUBER_PUMP", "1")
    eng = engine_mod.DecisionEngine(4096, clock=Clock().freeze_at(T0_NS), device="cpu")
    pend = [eng.apply_columnar([b"q%d_%d" % (r, i) for i in range(5)], *_cols(5),
                               want_async=True) for r in range(MAX_GROUP + 3)]
    assert (eng._pump.submitted, eng._pump.flushes) == (MAX_GROUP + 3, 1)
    assert all(p.get()[2].tolist() == [999] * 5 for p in pend)
    assert eng._pump.flushes == 2 and eng.dispatches_total == 2


def test_failed_launch_fails_queued_tickets_closed(monkeypatch):
    """A launch that raises fails every queued ticket with the real
    error (reference tests/test_pump.py:24); the engine serves on."""
    monkeypatch.setenv("GUBER_PUMP", "1")
    eng = engine_mod.DecisionEngine(2048, clock=Clock().freeze_at(T0_NS), device="cpu")
    p1 = eng.apply_columnar([b"a%d" % i for i in range(10)], *_cols(10), want_async=True)
    p2 = eng.apply_columnar([b"b%d" % i for i in range(10)], *_cols(10), want_async=True)
    orig = eng._pump._flush_group

    def failing(group):
        raise RuntimeError("injected launch failure")

    eng._pump._flush_group = failing
    with pytest.raises(RuntimeError, match="injected"):
        with eng._lock:
            eng._pump.flush_locked()
    eng._pump._flush_group = orig
    for p in (p1, p2):
        with pytest.raises(RuntimeError, match="injected"):
            p.get()
    out = eng.apply_columnar([b"c%d" % i for i in range(10)], *_cols(10))
    assert (out[2] == 999).all()


@pytest.mark.parametrize("pump", ["1", "0"])
@pytest.mark.parametrize("path", ["columnar", "dataclass"])
def test_engine_parity_pump_on_and_off(monkeypatch, pump, path):
    """test_torch_engine's mixed stream through both engines with the
    pump on and off; with it off the port's pump launches each batch as
    it is submitted."""
    monkeypatch.setenv("GUBER_PUMP", pump)
    rng = np.random.default_rng(30 + int(pump))
    ref, port = _pair(256)
    assert port._pump.queueing == (ref._pump is not None) == (pump == "1")
    keys = [f"p{i}" for i in range(30)]
    step = _columnar_step if path == "columnar" else _dataclass_step
    for _ in range(25):
        step(ref, port, _rows(rng, keys, int(rng.integers(1, 40)),
                              invalid_greg=path == "dataclass"))
        _advance(ref, port, int(rng.choice([0, 1, 7, 1000, 40_000])))
    _assert_same_state(ref, port)


def test_pump_default_is_off_on_the_cpu(monkeypatch):
    """Unset, GUBER_PUMP queues nothing on the CPU: every submission,
    asynchronous too, is launched as it is submitted; "1" queues."""
    monkeypatch.delenv("GUBER_PUMP", raising=False)
    eng = engine_mod.DecisionEngine(16, device="cpu")
    assert not eng._pump.queueing
    st, _, rem, _ = eng.apply_columnar([b"a", b"b"], *_cols(2))
    assert rem.tolist() == [999, 999] and eng.dispatches_total == 1
    pend = eng.apply_columnar([b"c"], *_cols(1), want_async=True)
    assert (eng._pump.submitted, eng._pump.flushes) == (2, 2)
    assert pend.get()[2].tolist() == [999]
    monkeypatch.setenv("GUBER_PUMP", "1")
    eng = engine_mod.DecisionEngine(16, device="cpu")
    assert eng._pump.queueing
    pend = eng.apply_columnar([b"a"], *_cols(1), want_async=True)
    assert (eng._pump.submitted, eng._pump.flushes) == (1, 0)
    assert pend.get()[2].tolist() == [999] and eng._pump.flushes == 1


def test_readback_tickets_one_per_launch(monkeypatch):
    """On the CPU a ticket holds the launch's output itself; every batch
    registers one ticket per launch, and the counters count each batch."""
    from gubernator_tpu_torch.core.readback import ReadbackCombiner

    rc = ReadbackCombiner()
    a = torch.arange(10, dtype=torch.int32).reshape(2, 5)
    t = rc.register(a)
    assert np.array_equal(t.fetch(), a.numpy()) and t.fetch() is t.fetch()
    assert (rc.registered, rc.transfers) == (1, 0)

    monkeypatch.setenv("GUBER_PUMP", "0")
    eng = engine_mod.DecisionEngine(64, clock=Clock().freeze_at(T0_NS), device="cpu")
    eng.apply_columnar([b"x", b"y"], *_cols(2))
    eng.apply_columnar([b"x"], *_cols(1))
    assert (eng.requests_total, eng.batches_total, eng.dispatches_total) == (3, 2, 2)
    assert eng.readback.registered == 2
    st, _, rem, _ = eng.apply_columnar([b"x"], *_cols(1, hits=0))
    assert rem.tolist() == [998]


def test_async_fetches_from_many_threads(monkeypatch):
    """Queued batches fetched from eight threads at once, in any order:
    each gets its own answers (the fetch flushes under the engine lock)."""
    import threading

    monkeypatch.setenv("GUBER_PUMP", "1")
    eng = engine_mod.DecisionEngine(4096, clock=Clock().freeze_at(T0_NS), device="cpu")
    sync = engine_mod.DecisionEngine(4096, clock=Clock().freeze_at(T0_NS), device="cpu")
    rng = np.random.default_rng(3)
    batches = [([b"t%d" % i for i in rng.integers(0, 50, 30)], _cols(30, hits=1))
               for _ in range(12)]
    pend = [eng.apply_columnar(k, *c, want_async=True) for k, c in batches]
    want = [sync.apply_columnar(k, *c) for k, c in batches]
    errors = []

    def fetch(idx):
        try:
            for i in idx:
                for g, w in zip(pend[i].get(), want[i]):
                    assert np.array_equal(g, w), i
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=fetch, args=(list(range(12))[k::8][::-1],))
               for k in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not errors and not any(t.is_alive() for t in threads)
