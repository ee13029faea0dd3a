"""The port's decision ledger (gubernator_tpu_torch/core/ledger.py) over the
port's engine on the CPU, against the reference's ledger over the JAX
engine.

Ports the cases of `tests/test_ledger.py`.  Every deterministic case runs
the same seeded rows through both stacks, each batch through the serving
fronts' partition (plan → engine lane with settles prepended → learn →
merge), and through `models/spec.py` one row at a time: answers must be
equal row for row on all three; at the end, after `flush_settles` on
both ledgers, every live key's state words and the ledger counters must
be equal too.  State words equal the reference's only because the
reference runs its ledger as well: a lease pre-debits its credit.  The
three-way case of `tests/test_fused_parity.py:254` holds the port's
ledger over the plain K1 rounds (collapse and the uniform format off) to
the spec and to the reference's ledger over its Pallas kernel in
interpret mode.  Frozen clocks and `settle_interval=0` throughout, with
two exceptions whose subject is time itself: the concurrent race
(threads, a frozen clock, bounds only) and the small-hot-bucket canary
(the live clock and the settle thread, with the reference's own bound).
"""

from __future__ import annotations

import threading

import numpy as np
import pytest
from test_ledger import SpecOracle, make_dec

from gubernator_tpu.clock import Clock as RefClock
from gubernator_tpu.core.engine import DecisionEngine as RefEngine
from gubernator_tpu.core.engine import PackedKeys as RefPackedKeys
from gubernator_tpu.core.ledger import DecisionLedger as RefLedger
from gubernator_tpu.ops import bucket_kernel as ref_bk
from gubernator_tpu.types import Algorithm, Behavior, Status
from gubernator_tpu_torch.clock import Clock
from gubernator_tpu_torch.core import engine as engine_mod
from gubernator_tpu_torch.core.engine import DecisionEngine, PackedKeys
from gubernator_tpu_torch.core.ledger import DecisionLedger
from gubernator_tpu_torch.ops import bucket_kernel as tk

T0_NS = 1_760_000_000_123 * 1_000_000
# The reference's stats() also carries the mean settle lag, a wall-clock
# reading; every other counter must be equal.
_TIMED = ("settle_lag_ms_mean",)


def _serve(ledger, engine, packed, dec, now):
    """One batch through the fronts' partition (plan → lane → learn →
    merge), the shape of service._serve_decoded_ledger."""
    plan = ledger.plan(dec, now)
    if plan.full:
        return plan.dense_cols()
    lane = plan.build_engine_lane()
    st, lim, rem, rst = engine.apply_columnar(
        packed(lane.key_buf, lane.key_offsets, lane.n), lane.algo, lane.behavior, lane.hits,
        lane.limit, lane.duration, lane.burst, now_ms=now,
    )
    plan.learn(st, lim, rem, rst)
    return plan.merge_outputs(st, rem, rst)


def _view(engine, key, limit, duration):
    """A key's device state through a hits-0 engine query that bypasses
    the ledger (what an outside reader sees)."""
    st, _lim, rem, rst = engine.apply_columnar(
        [key], np.zeros(1, np.int32), np.zeros(1, np.int32), np.zeros(1, np.int64),
        np.asarray([limit], np.int64), np.asarray([duration], np.int64), np.zeros(1, np.int64),
    )
    return int(st[0]), int(rem[0]), int(rst[0])


def _rows_of(cols, n):
    st, lim, rem, rst = cols
    return [(int(st[i]), int(lim[i]), int(rem[i]), int(rst[i])) for i in range(n)]


class Twin:
    """The port's ledger over the port's CPU engine and the reference's
    ledger over the JAX engine, frozen clocks stepped alike, plus the
    scalar spec: `serve` holds all three equal row for row."""

    def __init__(self, capacity=2048, **ledger_kw):
        ledger_kw.setdefault("settle_interval", 0)
        self.clock = Clock().freeze_at(T0_NS)
        self.ref_clock = RefClock().freeze_at(T0_NS)
        self.engine = DecisionEngine(capacity, clock=self.clock, device="cpu")
        self.ledger = DecisionLedger(self.engine, **ledger_kw)
        self.ref_engine = RefEngine(capacity=capacity, clock=self.ref_clock)
        self.ref_ledger = RefLedger(self.ref_engine, **ledger_kw)
        self.oracle = SpecOracle(self.ref_clock)

    def advance(self, ms: int) -> None:
        self.clock.advance(ms=ms)
        self.ref_clock.advance(ms=ms)

    def serve(self, rows, tag=""):
        """One batch through both ledgers and the spec; returns the port's
        answers as (status, limit, remaining, reset) tuples."""
        dec = make_dec(rows)
        now = self.clock.now_ms()
        got = _rows_of(_serve(self.ledger, self.engine, PackedKeys, dec, now), len(rows))
        want = _rows_of(_serve(self.ref_ledger, self.ref_engine, RefPackedKeys, dec, now),
                        len(rows))
        spec = self.oracle.serve(rows)
        for i in range(len(rows)):
            assert got[i] == want[i] == spec[i], (
                f"{tag} row {i} key={rows[i][0]!r} hits={rows[i][3]}: port={got[i]} "
                f"reference={want[i]} spec={spec[i]}"
            )
        return got

    def view(self, key, limit, duration):
        got = _view(self.engine, key, limit, duration)
        assert got == _view(self.ref_engine, key, limit, duration)
        return got

    def stats(self):
        a, b = self.ledger.stats(), self.ref_ledger.stats()
        for k in _TIMED:
            a.pop(k)
            b.pop(k)
        assert a == b
        return a

    def settle_and_compare(self):
        """flush_settles on both ledgers, then equal settle counts, stats
        and state words of every live key."""
        assert self.ledger.flush_settles() == self.ref_ledger.flush_settles()
        self.stats()
        assert _port_words(self.engine) == _ref_words(self.ref_engine)

    def close(self):
        self.ledger.close()
        self.ref_ledger.close()
        self.engine.close()


def _ref_words(eng):
    eng._flush_pump()
    words = {f: np.asarray(getattr(eng._state, f)) for f in eng._state._fields}
    return {k: tuple(int(words[f][s]) for f in eng._state._fields)
            for s in range(eng.capacity) if (k := eng.table.key_for_slot(s)) is not None}


def _port_words(eng):
    words = tk.state_to_numpy(eng.state)
    return {k: tuple(int(words[f][s]) for f in tk.BucketState._fields)
            for s in range(eng.capacity) if (k := eng.table.key_for_slot(s)) is not None}


@pytest.fixture
def twin_of():
    made = []

    def make(**kw):
        t = Twin(**kw)
        made.append(t)
        return t

    yield make
    for t in made:
        t.close()


def _fuzz(twin, seed, n_batches, batch, n_keys, limit_hi=12):
    """tests/test_ledger.py _fuzz: clock steps and jumps, config churn,
    leaky rows, RESET_REMAINING, over-asks and negative hits."""
    rng = np.random.default_rng(seed)
    keys = [b"led_k%d" % i for i in range(n_keys)]
    limits = rng.integers(0, limit_hi, n_keys)
    durations = rng.integers(1, 4, n_keys) * 40
    for b in range(n_batches):
        twin.advance(int(rng.integers(0, 30)))
        if rng.random() < 0.1:
            twin.advance(int(rng.integers(40, 200)))
        if rng.random() < 0.15:
            j = int(rng.integers(0, n_keys))
            if rng.random() < 0.5:
                limits[j] = int(rng.integers(0, limit_hi))
            else:
                durations[j] = int(rng.integers(1, 4)) * 40
        rows = []
        for _ in range(batch):
            j = int(rng.integers(0, n_keys))
            algo = int(Algorithm.LEAKY_BUCKET) if rng.random() < 0.1 else int(
                Algorithm.TOKEN_BUCKET)
            behavior = int(Behavior.RESET_REMAINING) if rng.random() < 0.04 else 0
            hits = int(rng.integers(0, 4))
            if rng.random() < 0.05:
                hits = int(rng.integers(4, 20))
            if rng.random() < 0.03:
                hits = -int(rng.integers(1, 3))
            burst = int(rng.integers(0, 3)) * 7
            rows.append((keys[j], algo, behavior, hits, int(limits[j]), int(durations[j]), burst))
        twin.serve(rows, tag=f"batch {b}")
    twin.settle_and_compare()
    stats = twin.stats()
    assert stats["answered"] > 0
    assert stats["leases_granted"] > 0


@pytest.mark.parametrize("case", ["reference", "leases"])
def test_ledger_fuzz_vs_reference_and_spec(twin_of, case):
    """"reference": tests/test_ledger.py's fast fuzz (seed 7, limits below
    12: mostly sticky OVER, two leases).  "leases": limits up to 400 and a
    10 s TTL, so leases are granted, drained and revoked with return rows
    (the long-TTL soak's shape at the fast fuzz's size)."""
    if case == "reference":
        t = twin_of(lease_size=8, lease_ttl=0.05, hot_threshold=2)
        _fuzz(t, seed=7, n_batches=60, batch=48, n_keys=6)
    else:
        t = twin_of(lease_size=8, lease_ttl=10.0, hot_threshold=2)
        _fuzz(t, seed=11, n_batches=60, batch=48, n_keys=4, limit_hi=400)
        assert t.stats()["settles"] > 0


@pytest.mark.slow
@pytest.mark.parametrize("seed", [1, 2, 3, 4])
def test_ledger_fuzz_soak(twin_of, seed):
    _fuzz(twin_of(lease_size=8, lease_ttl=0.05, hot_threshold=2), seed=seed, n_batches=400,
          batch=96, n_keys=10)


@pytest.mark.slow
def test_ledger_fuzz_long_ttl_soak(twin_of):
    _fuzz(twin_of(lease_size=8, lease_ttl=10.0, hot_threshold=2), seed=11, n_batches=300,
          batch=64, n_keys=4, limit_hi=400)


def _hot_rows(key, n, hits=1, limit=1000, duration=60000):
    return [(key, 0, 0, hits, limit, duration, 0)] * n


def test_sticky_over_limit_boundary_at_reset(twin_of):
    t = twin_of(lease_size=4, hot_threshold=100)
    key = b"svc_sticky"
    rows = [(key, 0, 0, 3, 3, 1000, 0)]
    t.serve(rows)  # consumes to 0
    t.serve(rows)  # OVER through the engine; the entry is learned
    assert t.stats()["over_entries"] == 1
    before = t.engine.rounds_total
    t.serve(rows)  # answered by the ledger
    t.serve([(key, 0, 0, 0, 3, 1000, 0)])  # a query: OVER too
    assert t.engine.rounds_total == before  # no device work
    reset_ms = t.serve(rows)[0][3]
    t.advance(reset_ms - t.clock.now_ms())
    t.serve(rows, tag="at reset")  # the bucket is still live at the reset
    t.advance(1)
    t.serve(rows, tag="past reset")  # a fresh bucket
    assert t.serve([(key, 0, 0, 0, 3, 1000, 0)])[0][0] == int(Status.UNDER_LIMIT)
    t.settle_and_compare()


def test_duration_change_renewal_is_not_sticky(twin_of):
    """A duration change that renews an expired bucket answers (OVER, 0),
    a pre-renewal snapshot, while the stored remaining becomes `limit`:
    that answer must not be learned as sticky OVER."""
    t = twin_of(lease_size=4, hot_threshold=100)
    key = b"svc_renew"
    rows = [(key, 0, 0, 3, 3, 1000, 0)]
    t.serve(rows)
    t.serve(rows)
    assert t.stats()["over_entries"] == 1
    t.advance(500)
    t.serve([(key, 0, 0, 1, 3, 400, 0)], tag="renewing row")
    t.serve([(key, 0, 0, 0, 3, 400, 0)], tag="post-renewal")
    t.serve([(key, 0, 0, 1, 3, 400, 0)], tag="drains again")
    t.settle_and_compare()


def test_reset_remaining_bypasses_and_revokes(twin_of):
    t = twin_of(lease_size=16, hot_threshold=1)
    key = b"svc_reset"
    t.serve(_hot_rows(key, 1, limit=10, duration=5000))
    t.serve(_hot_rows(key, 1, limit=10, duration=5000))
    assert t.stats()["leases_granted"] == 1
    t.serve(_hot_rows(key, 3, limit=10, duration=5000))
    # RESET_REMAINING reaches the engine, the lease's unused credit
    # returned first in the same batch.
    t.serve([(key, 0, int(Behavior.RESET_REMAINING), 1, 10, 5000, 0)], tag="reset-remaining")
    assert t.stats()["settles"] >= 1
    t.serve(_hot_rows(key, 2, limit=10, duration=5000))
    t.settle_and_compare()


def test_lease_expiry_mid_stream_settles(twin_of):
    t = twin_of(lease_size=64, lease_ttl=0.02, hot_threshold=1)
    key = b"svc_ttl"
    for _ in range(4):
        t.serve(_hot_rows(key, 2, limit=100, duration=60000))
    t.advance(25)  # past the lease TTL, inside the bucket window
    t.serve(_hot_rows(key, 2, limit=100, duration=60000), tag="post-ttl")
    assert t.stats()["settles"] >= 1
    t.settle_and_compare()


@pytest.mark.parametrize("flusher", ["by_hand", "thread"])
def test_background_flush_settles_idle_lease(twin_of, flusher):
    """An idle lease's unused credit goes back to the device once its TTL
    passes: through `flush_settles` called by hand, or through the settle
    thread (a 10 ms period here), waited for up to 10 s."""
    import time as _time

    t = twin_of(lease_size=64, lease_ttl=0.02, hot_threshold=1,
                settle_interval=0.01 if flusher == "thread" else 0)
    key = b"svc_idle"
    t.serve(_hot_rows(key, 1, limit=100, duration=60000))
    # 3 engine hits + an acquisition of min(64, (99 - 3) // 2) = 48.
    t.serve(_hot_rows(key, 3, limit=100, duration=60000))
    assert t.stats()["leases_granted"] == 1
    assert t.view(key, 100, 60000)[1] == 100 - 4 - 48
    t.advance(30)  # past the lease TTL: the flush returns the unused credit
    if flusher == "by_hand":
        assert t.ledger.flush_settles() == t.ref_ledger.flush_settles() == 1
    else:
        deadline = _time.monotonic() + 10.0
        while _time.monotonic() < deadline and min(
                led.stats()["settles"] for led in (t.ledger, t.ref_ledger)) < 1:
            _time.sleep(0.01)
    assert t.view(key, 100, 60000)[1] == 96
    t.settle_and_compare()


def test_over_admission_bounded_by_lease_budget(twin_of):
    """A reader of the device mid-lease sees at most `lease_size` fewer
    remaining than the ledger's sequential truth, never more."""
    budget = 16
    t = twin_of(lease_size=budget, lease_ttl=10.0, hot_threshold=1)
    key = b"svc_bound"
    t.serve(_hot_rows(key, 1))
    t.serve(_hot_rows(key, 1))
    for i in range(60):
        # The hits-0 reads below reach the engine outside the ledger, so
        # the spec sees them too (they change nothing).
        st, _lim, rem, _rst = t.serve(_hot_rows(key, 1), tag=f"hit {i}")[0]
        assert st == int(Status.UNDER_LIMIT)
        dev_rem = t.view(key, 1000, 60000)[1]
        t.oracle.serve([(key, 0, 0, 0, 1000, 60000, 0)])
        assert -budget <= dev_rem - rem <= 0, (dev_rem, rem)
    t.settle_and_compare()


def test_concurrent_windows_racing_one_lease():
    """Threads hammer one leased key: the total admitted never exceeds
    limit + lease budget, and the drained bucket ends OVER for all."""
    clock = Clock().freeze_at(T0_NS)
    engine = DecisionEngine(2048, clock=clock, device="cpu")
    budget, limit = 32, 300
    ledger = DecisionLedger(engine, lease_size=budget, lease_ttl=10.0, hot_threshold=1,
                            settle_interval=0)
    key = b"svc_race"
    admitted = []
    lock = threading.Lock()

    def worker():
        mine = 0
        for _ in range(150):
            st = _serve(ledger, engine, PackedKeys, make_dec(_hot_rows(key, 1, limit=limit)),
                        clock.now_ms())[0]
            mine += int(st[0]) == int(Status.UNDER_LIMIT)
        with lock:
            admitted.append(mine)

    threads = [threading.Thread(target=worker) for _ in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert sum(admitted) <= limit + budget, sum(admitted)
    st = _serve(ledger, engine, PackedKeys, make_dec(_hot_rows(key, 1, limit=limit)),
                clock.now_ms())[0]
    assert int(st[0]) == int(Status.OVER_LIMIT)
    ledger.close()
    engine.close()


def test_small_hot_bucket_not_starved_by_lease_churn():
    """Concurrent mixed traffic on the live clock with the settle thread
    running: a small-limit hot key must admit (nearly) its whole limit
    and never more, through lease acquire / expire / return churn
    (reference test_ledger.py, same bound: the slack scales with how far
    the run fell behind its intended sleep)."""
    import time as _time

    clock = Clock()
    engine = DecisionEngine(1024, clock=clock, device="cpu")
    led = DecisionLedger(engine, lease_size=512, lease_ttl=0.2, hot_threshold=8,
                         settle_interval=0.05)
    limit = 150
    key = b"svc_canary"
    lock = threading.Lock()
    admitted = [0]
    intended_sleep = [0.0] * 8

    def worker(tid):
        rng = np.random.default_rng(tid)
        mine = 0
        for _ in range(90):
            rows = []
            for _j in range(int(rng.integers(1, 6))):
                if rng.random() < 0.3:
                    rows.append((key, 0, 0, 1, limit, 3_600_000, 0))
                else:
                    rows.append((b"svc_hot_%d" % rng.integers(8), 0, 0, 1, 10**9, 3_600_000, 0))
            st = _serve(led, engine, PackedKeys, make_dec(rows), clock.now_ms())[0]
            for j, r in enumerate(rows):
                if r[0] == key and int(st[j]) == int(Status.UNDER_LIMIT):
                    mine += 1
            nap = float(rng.uniform(0.002, 0.015))
            intended_sleep[tid] += nap
            _time.sleep(nap)
        with lock:
            admitted[0] += mine

    threads = [threading.Thread(target=worker, args=(t,)) for t in range(8)]
    t0 = _time.monotonic()
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    elapsed = _time.monotonic() - t0
    led.close()
    engine.close()
    assert admitted[0] <= limit, admitted[0]
    dilation = elapsed / max(1e-9, max(intended_sleep))
    slack = min(limit // 3, max(10, int(round(10 * dilation))))
    assert admitted[0] >= limit - slack, (admitted[0], limit, slack, round(dilation, 2))


def test_leaky_rows_never_ledger_answered(twin_of):
    t = twin_of(lease_size=8, hot_threshold=1)
    rows = [(b"svc_leaky", int(Algorithm.LEAKY_BUCKET), 0, 1, 10, 1000, 0)]
    for i in range(6):
        t.advance(30)
        t.serve(rows, tag=f"leaky {i}")
    stats = t.stats()
    assert stats["answered"] == 0 and stats["leases_granted"] == 0
    t.settle_and_compare()


def _leaky(key, hits=1, limit=10, duration=1000):
    return (key, int(Algorithm.LEAKY_BUCKET), 0, hits, limit, duration, 0)


@pytest.mark.parametrize("case", ["fresh", "entry", "pending"])
def test_whole_batch_fall_equals_the_reference(twin_of, case, monkeypatch):
    """A batch of which no row is eligible (leaky, RESET_REMAINING,
    negative hits) and no key has an entry or a pending return falls
    whole, without the per-row pass that the reference's plan runs.  A
    key with an entry ("entry": a live lease, which the leaky row revokes,
    its credit returned ahead of it) or with a pending return ("pending":
    the credit of a lease evicted at max_keys) sends the batch through the
    per-row pass.  Answers, counters and state words equal the
    reference's and the spec's either way."""
    taken = []
    real = DecisionLedger._fall_whole_batch

    def spy(self, plan, hh):
        taken.append(real(self, plan, hh))
        return taken[-1]

    monkeypatch.setattr(DecisionLedger, "_fall_whole_batch", spy)
    t = twin_of(lease_size=16, lease_ttl=10.0, hot_threshold=1,
                max_keys=2 if case == "pending" else 64)
    t.serve([_leaky(b"wb_a"), _leaky(b"wb_b", 2),
             (b"wb_c", 0, int(Behavior.RESET_REMAINING), 1, 5, 1000, 0),
             (b"wb_d", 0, 0, -1, 5, 1000, 0)], tag="fresh keys")
    assert taken == [True]
    if case != "fresh":
        key = b"wb_hot"
        t.serve(_hot_rows(key, 1, limit=100))
        t.serve(_hot_rows(key, 1, limit=100))  # grant
        t.serve(_hot_rows(key, 3, limit=100))  # drain
        assert t.stats()["leases_granted"] == 1
        if case == "pending":
            # Two new keys past max_keys evict the lease, its unused
            # credit queued as a pending return.
            t.serve([(b"wb_x", 0, 0, 1, 100, 60000, 0), (b"wb_y", 0, 0, 1, 100, 60000, 0)])
            assert key not in {e.key for e in t.ledger._items.values()}
            assert t.ledger._pending
        taken.clear()
        t.serve([_leaky(b"wb_a"), _leaky(key, limit=100, duration=60000)], tag=case)
        assert taken == [False]
        assert t.stats()["settles"] >= 1
    t.settle_and_compare()


def test_whole_batch_fall_learns_a_racing_entry(twin_of):
    """A leaky batch falls whole; before its learn, a racing plan makes an
    entry for its key, and the engine runs the token row, then the leaky
    one.  The leaky batch's learn then sees the entry, as the per-row
    learn does, and voids its remaining hint (the leaky row ran after the
    token row's answer): the entry equals the reference's, and later
    answers equal the reference's and the spec's."""
    t = twin_of(lease_size=16, lease_ttl=10.0, hot_threshold=1)
    key = b"wb_race"
    leaky_rows, token_rows = [_leaky(key, limit=100, duration=60000)], _hot_rows(key, 1, limit=100)
    now = t.clock.now_ms()
    entries = []
    for led, eng, packed in ((t.ledger, t.engine, PackedKeys),
                             (t.ref_ledger, t.ref_engine, RefPackedKeys)):
        first = led.plan(make_dec(leaky_rows), now)
        racer = led.plan(make_dec(token_rows), now)
        for plan in (racer, first):
            lane = plan.build_engine_lane()
            plan.learn(*eng.apply_columnar(
                packed(lane.key_buf, lane.key_offsets, lane.n), lane.algo, lane.behavior,
                lane.hits, lane.limit, lane.duration, lane.burst, now_ms=now))
        e = next(e for e in led._items.values() if e.key == key)
        entries.append((e.kind, e.rem_hint, e.limit, e.duration))
    assert t.ledger._items and entries[0] == entries[1] and entries[0][1] == -1
    t.oracle.serve(token_rows)
    t.oracle.serve(leaky_rows)
    for _ in range(3):
        t.serve(_hot_rows(key, 2, limit=100), tag="after the race")
    t.settle_and_compare()


def test_rollback_restores_consumed_credits(twin_of):
    t = twin_of(lease_size=16, lease_ttl=10.0, hot_threshold=1)
    key = b"svc_rb"
    t.serve(_hot_rows(key, 1, limit=100))
    t.serve(_hot_rows(key, 1, limit=100))  # grant (remaining 98)
    now = t.clock.now_ms()
    for led in (t.ledger, t.ref_ledger):
        plan = led.plan(make_dec(_hot_rows(key, 3, limit=100)), now)
        assert len(plan.answered_rows) == 3
        plan.rollback()
    # The three drained hits are back: the next answer is the spec's.
    assert t.serve(_hot_rows(key, 1, limit=100))[0][2] == 97
    t.settle_and_compare()


def test_invalidate_keys_settles_before_dataclass_path(twin_of):
    t = twin_of(lease_size=64, lease_ttl=10.0, hot_threshold=1)
    key = b"svc_inv"
    t.serve(_hot_rows(key, 1, limit=50))
    t.serve(_hot_rows(key, 5, limit=50))  # grant + drain
    t.serve(_hot_rows(key, 5, limit=50))
    t.ledger.invalidate_keys([key, b"svc_absent"])
    t.ref_ledger.invalidate_keys([key, b"svc_absent"])
    # The device now holds every ledger-admitted hit.
    assert t.view(key, 50, 60000)[1] == 50 - 11
    t.oracle.serve([(key, 0, 0, 0, 50, 60000, 0)])
    assert t.stats()["entries"] >= 1  # the counter entry stays
    t.settle_and_compare()


@pytest.mark.parametrize("seed", [3, 19])
def test_ledger_plain_k1_vs_spec_vs_reference_pallas(seed, monkeypatch):
    """tests/test_fused_parity.py:254 with the port as a third party: the
    port's ledger over its plain K1 rounds (collapse and the uniform
    format turned off, so every engine row is a K1 lane), the scalar
    spec, and the reference's ledger over its Pallas kernel in interpret
    mode agree row for row on token and leaky keys across duration
    changes and expiries."""
    monkeypatch.setenv("GUBER_FUSED", "interpret")
    monkeypatch.setenv("GUBER_PUMP", "0")
    rng = np.random.default_rng(seed)
    t = Twin(settle_interval=0, lease_size=4)
    assert t.ref_engine.fused_mode == "pallas-interpret"
    t.engine._try_collapse = lambda *a, **k: None
    t.engine._uniform_params = lambda *a, **k: None
    keys = [b"led_%d" % i for i in range(10)]
    try:
        for step in range(60):
            t.advance(int(rng.integers(0, 60)))
            rows = []
            for _ in range(int(rng.integers(1, 8))):
                key = keys[int(rng.integers(0, len(keys)))]
                rows.append((key, int(key[-1] % 2), 0, int(rng.choice([0, 1, 1, 2, 4])),
                             int(rng.choice([2, 5, 9])), int(rng.choice([40, 90, 400])), 0))
            t.serve(rows, tag=f"seed {seed} step {step}")
        assert t.engine.rounds_total > 0
        t.settle_and_compare()
    finally:
        t.close()


def test_token_extras_host_vs_reference_and_plain_collapsed_step(monkeypatch):
    """The ledger's drain algebra: the port's `token_extras_host` equals
    the reference's, and the answers of the port's plain collapsed step
    (one hot token key, `n` equal hits in one batch) follow it: after the
    first occurrence leaves R1, extra k is admitted iff k < a2, the last
    remaining is rem2, and the stored status is OVER iff sticky."""
    for R1 in range(-3, 40):
        for h in range(-3, 9):
            for extras in range(0, 12):
                assert tk.token_extras_host(R1, h, extras) == ref_bk.token_extras_host(
                    R1, h, extras)
    calls = []
    real = engine_mod.collapsed_step
    monkeypatch.setattr(engine_mod, "collapsed_step",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    rng = np.random.default_rng(5)
    for case in range(12):
        limit = int(rng.integers(1, 60))
        h = int(rng.integers(1, 6))
        n = int(rng.integers(2, 20))
        eng = DecisionEngine(256, clock=Clock().freeze_at(T0_NS), device="cpu")
        key = b"tx_%d" % case
        cols = (np.zeros(n, np.int32), np.zeros(n, np.int32), np.full(n, h, np.int64),
                np.full(n, limit, np.int64), np.full(n, 60_000, np.int64), np.zeros(n, np.int64))
        before = len(calls)
        st, _lim, rem, _rst = eng.apply_columnar([key] * n, *cols)
        assert len(calls) == before + 1
        R1 = limit - h if h <= limit else limit
        a2, rem2, sticky = tk.token_extras_host(R1, h, n - 1)
        if h > limit:  # the first occurrence is rejected and consumes nothing
            assert int(st[0]) == int(Status.OVER_LIMIT)
        for k in range(n - 1):
            want_st = Status.UNDER_LIMIT if k < a2 else Status.OVER_LIMIT
            want_rem = R1 - (k + 1) * h if k < a2 else rem2
            assert (int(st[k + 1]), int(rem[k + 1])) == (int(want_st), want_rem), (case, k)
        st2, rem_after, _rst2 = _view(eng, key, limit, 60_000)
        assert rem_after == rem2
        if sticky:
            assert st2 == int(Status.OVER_LIMIT)
        eng.close()


def test_failed_return_apply_is_counted_and_lag_observed(monkeypatch):
    """A return apply that raises in `flush_settles` is swallowed and
    counted at its site (utils/metrics.py record_swallowed), as the
    reference's is; a return that lands feeds the settle-lag mean."""
    from gubernator_tpu_torch.utils import metrics

    clock = Clock().freeze_at(T0_NS)
    engine = DecisionEngine(256, clock=clock, device="cpu")
    ledger = DecisionLedger(engine, lease_size=16, lease_ttl=0.01, hot_threshold=1,
                            settle_interval=0)
    key = b"svc_fail"
    for _ in range(2):  # a counter, then a grant
        _serve(ledger, engine, PackedKeys, make_dec(_hot_rows(key, 1, limit=100)),
               clock.now_ms())
    assert ledger.stats()["leases_granted"] == 1
    clock.advance(ms=20)  # past the TTL: one return to apply
    before = metrics.swallowed_counts().get("ledger.return_apply", 0)

    def fail(*a, **k):
        raise RuntimeError("device lost")

    monkeypatch.setattr(engine, "apply_columnar", fail)
    assert ledger.flush_settles() == 1
    assert metrics.swallowed_counts()["ledger.return_apply"] == before + 1
    assert ledger.stats()["settles"] == 0
    monkeypatch.undo()
    _serve(ledger, engine, PackedKeys, make_dec(_hot_rows(key, 1, limit=100)), clock.now_ms())
    clock.advance(ms=20)
    assert ledger.flush_settles() == 1 and ledger.stats()["settles"] == 1
    assert ledger.settle_lag.count == 1 and ledger.stats()["settle_lag_ms_mean"] >= 0
    ledger.close()
    engine.close()
