"""The port's hot-key sketch (gubernator_tpu_torch/utils/hotkeys.py) against
the reference's (gubernator_tpu/utils/hotkeys.py), and its feeds.

* Ports of tests/test_hotkeys.py: every case drives the port's
  `SpaceSaving` and the reference's through the same offers on the same
  injected clock, keeps the reference test's assertions on the port, and
  holds `top`, `top_rates`, `rate` and `stats` of the two equal.
* `from_env`: GUBER_HOTKEYS / _K / _WINDOW read as the reference reads
  them.
* The feeds of `V1Instance`: the dataclass path's per-batch offer
  (reference service.py:604-620), the columnar `serve_decoded_local`
  offer before the ledger (:1009, :1049), and the ledger's credit of a
  native drain when it pulls a lease back (reference core/ledger.py:593),
  each against the reference's instance or ledger fed alike.

Tolerance: exact (counts, errors, rates as floats, params).
"""

from __future__ import annotations

import numpy as np
import pytest
from test_ledger import make_dec

from gubernator_tpu.clock import Clock as RefClock
from gubernator_tpu.config import BehaviorConfig, Config
from gubernator_tpu.core.engine import DecisionEngine as RefEngine
from gubernator_tpu.core.ledger import DecisionLedger as RefLedger
from gubernator_tpu.service import V1Instance as RefInstance
from gubernator_tpu.types import RateLimitReq as RefReq
from gubernator_tpu.utils import hotkeys as ref_hotkeys
from gubernator_tpu_torch.clock import Clock
from gubernator_tpu_torch.core.engine import DecisionEngine
from gubernator_tpu_torch.core.ledger import DecisionLedger
from gubernator_tpu_torch.service import V1Instance
from gubernator_tpu_torch.types import RateLimitReq
from gubernator_tpu_torch.utils import hotkeys

T0_NS = 1_760_000_000_000 * 1_000_000


class _Clock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t


class Both:
    """The port's and the reference's SpaceSaving, one clock; a method call
    runs on both, and the readers must agree."""

    def __init__(self, **kw):
        self.clk = _Clock()
        self.port = hotkeys.SpaceSaving(now=self.clk, **kw)
        self.ref = ref_hotkeys.SpaceSaving(now=self.clk, **kw)

    def __getattr__(self, name):
        def call(*a, **k):
            got = getattr(self.port, name)(*a, **k)
            assert got == getattr(self.ref, name)(*a, **k), name
            return got

        return call


def test_space_saving_counts_and_error_bounds():
    ss = Both(capacity=4)
    for i in range(8):
        ss.offer(f"k{i}".encode(), i + 1)
    top = ss.top(4)
    assert len(top) == 4
    for _key, count, err in top:
        assert count >= 1
        assert err <= count
    assert ss.stats()["tracked"] == 4


def test_rate_reflects_current_window_only():
    ss = Both(capacity=16, window_s=1.0)
    ss.offer(b"hot", 500)
    assert ss.rate(b"hot") == 500.0
    ss.clk.t = 1.5
    assert 0 < ss.rate(b"hot") <= 500.0
    ss.clk.t = 3.0
    assert ss.rate(b"hot") == 0.0
    assert ss.top(1)[0][:2] == (b"hot", 500)


def test_top_rates_tracks_a_moving_zipf_hot_set():
    rng = np.random.default_rng(3)
    ss = Both(capacity=64, window_s=1.0)
    phases = [b"alpha", b"beta", b"gamma"]
    for p, hot in enumerate(phases):
        ss.clk.t = p * 2.0
        for _ in range(200):
            if rng.random() < 0.9:
                ss.offer(hot, 5)
            else:
                ss.offer(b"cold%d" % rng.integers(0, 20), 1)
        rates = ss.top_rates(3)
        assert rates[0][0] == hot, (p, rates)
        for earlier in phases[:p]:
            assert all(k != earlier or r < 1.0 for k, r, _l, _d in rates)
    assert b"alpha" in [k for k, _c, _e in ss.top(5)]


def test_rate_params_carry_last_limit_duration():
    ss = Both(capacity=8, window_s=1.0)
    ss.offer_many_params([(b"k", 10, 1000, 60_000)])
    (key, rate, limit, duration), = ss.top_rates(1)
    assert (key, limit, duration) == (b"k", 1000, 60_000)
    assert rate == 10.0
    ss.offer(b"k", 3)
    (_k, _r, limit, duration), = ss.top_rates(1)
    assert (limit, duration) == (1000, 60_000)


def test_offer_columns_masks_ineligible_params():
    ss = Both(capacity=8, window_s=1.0)
    keys = [b"aaa", b"bbb"]
    buf = np.frombuffer(b"".join(keys), dtype=np.uint8)
    offs = np.array([0, 3, 6], dtype=np.int64)
    ss.offer_columns(
        buf, offs, np.array([4, 4]),
        hashes=np.array([11, 22], dtype=np.uint64),
        limit=np.array([100, 0]), duration=np.array([60_000, 60_000]),
    )
    by_key = {k: (lim, dur) for k, _r, lim, dur in ss.top_rates(4)}
    assert by_key[b"aaa"] == (100, 60_000)
    assert by_key[b"bbb"][0] == 0


def test_eviction_resets_window_counters():
    ss = Both(capacity=2, window_s=1.0)
    ss.offer(b"a", 10)
    ss.offer(b"b", 20)
    ss.offer(b"c", 1)
    top = {k: (c, e) for k, c, e in ss.top(2)}
    assert top[b"c"] == (11, 10)
    assert ss.rate(b"c") == 1.0


@pytest.mark.parametrize("seed", [1, 8])
def test_seeded_offer_stream_matches_the_reference(seed):
    """Every entry point, a capacity small enough to evict, hashed and
    unhashed columns, subsets and time moving across windows."""
    rng = np.random.default_rng(seed)
    ss = Both(capacity=24, window_s=0.5)
    keys = [b"key-%d" % i for i in range(60)]
    for step in range(40):
        ss.clk.t += float(rng.choice([0.0, 0.1, 0.3, 0.7]))
        kind = step % 4
        if kind == 0:
            ss.offer(keys[int(rng.integers(60))], int(rng.integers(1, 9)))
        elif kind == 1:
            ss.offer_many([(keys[int(rng.integers(60))], int(rng.integers(1, 5)))
                           for _ in range(10)])
        elif kind == 2:
            ss.offer_many_params([(keys[int(rng.integers(60))], int(rng.integers(1, 5)),
                                   int(rng.choice([0, 10, 500])), 60_000) for _ in range(10)])
        else:
            picks = [keys[int(k)] for k in rng.zipf(1.3, 30) % 60]
            buf = np.frombuffer(b"".join(picks), dtype=np.uint8)
            offs = np.zeros(len(picks) + 1, np.int64)
            np.cumsum([len(k) for k in picks], out=offs[1:])
            hashes = np.asarray([hash(k) & (2**63 - 1) for k in picks], np.uint64)
            idx = np.arange(0, len(picks), 2) if step % 8 == 3 else None
            ss.offer_columns(buf, offs, rng.integers(0, 4, len(picks)), idx=idx,
                             hashes=hashes if step % 3 else None,
                             limit=rng.integers(0, 100, len(picks)),
                             duration=np.full(len(picks), 1000))
        ss.top(10)
        ss.top_rates(10)
        ss.stats()


def test_from_env_reads_the_knobs_as_the_reference(monkeypatch):
    for env, want in [({}, (1024, 5.0)), ({"GUBER_HOTKEYS_K": "7"}, (7, 5.0)),
                      ({"GUBER_HOTKEYS_K": "x", "GUBER_HOTKEYS_WINDOW": "y"}, (1024, 5.0)),
                      ({"GUBER_HOTKEYS_WINDOW": "0.25"}, (1024, 0.25)),
                      ({"GUBER_HOTKEYS": "off"}, None), ({"GUBER_HOTKEYS": " No "}, None),
                      ({"GUBER_HOTKEYS": "yes"}, (1024, 5.0))]:
        for k in ("GUBER_HOTKEYS", "GUBER_HOTKEYS_K", "GUBER_HOTKEYS_WINDOW"):
            monkeypatch.delenv(k, raising=False)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        got, ref = hotkeys.from_env(), ref_hotkeys.from_env()
        if want is None:
            assert got is None and ref is None
        else:
            assert (got.capacity, got.window_s) == (ref.capacity, ref.window_s) == want


# ---------------------------------------------------------------------------
# The feeds.


@pytest.fixture
def instances(monkeypatch):
    """(reference V1Instance, port V1Instance): frozen engine clocks at T0,
    each sketch on one frozen `now`, the ledger on (the default).  Both
    engines are paged, every page resident: the port builds the sketch
    only where paged state reads it."""
    monkeypatch.setenv("GUBER_PUMP", "0")
    monkeypatch.setenv("GUBER_PAGED", "1")
    monkeypatch.setenv("GUBER_PAGE_SIZE", "64")
    now = _Clock(100.0)
    monkeypatch.setattr(ref_hotkeys, "from_env",
                        lambda: ref_hotkeys.SpaceSaving(capacity=16, window_s=1.0, now=now))
    monkeypatch.setattr(hotkeys, "from_env",
                        lambda: hotkeys.SpaceSaving(capacity=16, window_s=1.0, now=now))
    behaviors = BehaviorConfig(global_sync_wait=3600.0, adaptive_windows=False)
    ref = RefInstance(Config(behaviors=behaviors),
                      RefEngine(4096, clock=RefClock().freeze_at(T0_NS)))
    port = V1Instance(DecisionEngine(4096, clock=Clock().freeze_at(T0_NS), device="cpu"),
                      ledger_opts=dict(settle_interval=0))
    try:
        yield ref, port
    finally:
        port.close()
        ref.close()


def _sketch_view(ss):
    return ss.top(32), ss.top_rates(32), ss.stats()


def test_dataclass_path_feed_matches_the_reference(instances):
    ref, port = instances
    rng = np.random.default_rng(4)
    for _ in range(12):
        reqs = [RateLimitReq(name="api", unique_key=f"u{int(rng.zipf(1.5)) % 40}",
                             hits=int(rng.choice([0, 1, 2, -1])), limit=int(rng.choice([0, 10])),
                             duration=60_000, algorithm=int(rng.integers(0, 2)),
                             behavior=int(rng.choice([0, 8, 32])))
                for _ in range(20)]
        reqs.append(RateLimitReq(name="", unique_key="x", hits=1, limit=1, duration=1))
        ref.get_rate_limits([RefReq(**vars(r)) for r in reqs])
        port.get_rate_limits(reqs)
    assert port.hotkeys.stats()["offered"] > 0
    assert _sketch_view(port.hotkeys) == _sketch_view(ref.hotkeys)


def test_serve_decoded_local_feed_matches_the_reference(instances):
    ref, port = instances
    rng = np.random.default_rng(6)
    for _ in range(10):
        rows = [(b"api_k%d" % (int(rng.zipf(1.4)) % 30), int(rng.integers(0, 2)),
                 int(rng.choice([0, 8])), int(rng.integers(0, 3)), int(rng.choice([0, 20])),
                 60_000, 0) for _ in range(25)]
        dec = make_dec(rows)
        want = ref.serve_decoded_local(dec)
        got = port.serve_decoded_local(dec)
        for a, b in zip(got, want):
            assert np.array_equal(np.asarray(a), np.asarray(b))
    assert _sketch_view(port.hotkeys) == _sketch_view(ref.hotkeys)
    assert port.ledger.hotkeys is port.hotkeys


def test_a_dense_instance_builds_no_sketch(monkeypatch):
    """Over a dense engine the sketch is built as the reference builds it
    (/debug/hotkeys reads it) and the ledger credits it, but no paging
    provider is set: there is no page table to feed.  With GUBER_HOTKEYS=0
    none is built."""
    monkeypatch.delenv("GUBER_PAGED", raising=False)
    monkeypatch.setenv("GUBER_HOTKEYS", "1")
    port = V1Instance(DecisionEngine(64, device="cpu"), ledger_opts=dict(settle_interval=0))
    try:
        assert port.engine.paging is None
        assert port.hotkeys is not None and port.ledger.hotkeys is port.hotkeys
        got = port.get_rate_limits([RateLimitReq(name="a", unique_key="k", hits=1, limit=5,
                                                 duration=60_000)])
        assert got[0].remaining == 4
        assert [k for k, _c, _e in port.hotkeys.top(5)] == [b"a_k"]
    finally:
        port.close()
    monkeypatch.setenv("GUBER_HOTKEYS", "0")
    port = V1Instance(DecisionEngine(64, device="cpu"), ledger_opts=dict(settle_interval=0))
    try:
        assert port.hotkeys is None and port.ledger.hotkeys is None
    finally:
        port.close()


class _FakePlane:
    """A native plane that answered `drained` of a key's lease credit."""

    def __init__(self, drained):
        self.drained = drained

    def pull(self, key):
        return (2, self.drained)

    def clear(self):
        pass

    def set_clock_offset(self, _ms):
        pass


@pytest.mark.parametrize("consumed,drained", [(0, 5), (3, 9), (4, 4), (7, 2)])
def test_native_drain_credit_matches_the_reference(consumed, drained):
    """`_undelegate_locked` offers the drained delta (only when it grew)
    to the sketch, as the reference's does."""
    made = []
    for mod, eng, clock, ss_mod in (
        (DecisionLedger, lambda c: DecisionEngine(64, clock=c, device="cpu"), Clock, hotkeys),
        (RefLedger, lambda c: RefEngine(64, clock=c), RefClock, ref_hotkeys),
    ):
        ledger = mod(eng(clock().freeze_at(T0_NS)), settle_interval=0)
        ledger.hotkeys = ss_mod.SpaceSaving(capacity=8, now=lambda: 1.0)
        ledger._native = _FakePlane(drained)
        entry = type("E", (), {})()
        entry.key, entry.consumed, entry.kind = b"hot", consumed, 3
        ledger._undelegate_locked(entry)
        made.append((ledger, entry))
    (led, e), (rled, re_) = made
    try:
        assert e.consumed == re_.consumed == drained
        assert led.hotkeys.top(4) == rled.hotkeys.top(4)
        assert led.hotkeys.top(4) == ([(b"hot", drained - consumed, 0)]
                                      if drained > consumed else [])
    finally:
        led._native = rled._native = None
        led.close()
        rled.close()
