"""The port's native decision plane (gubernator_tpu_torch/core/native_plane.py
over csrc/decision_plane.cpp, built with g++ into the h2 server's
library) on the CPU, against the reference's plane.

Ports the cases of `tests/test_native_plane.py`.  The deterministic cases
serve each RPC the way the h2 connection threads do — `dp_try_serve`
first at an explicit clock, the ledger's plan / learn path on a decline —
through the port's plane, ledger and CPU engine and through the
reference's plane, ledger and JAX engine, with frozen clocks stepped
alike: the plane's response bytes (retry hints on) and the
declines must be equal, every answer must equal `models/spec.py`'s, and
after `flush_settles` the ledger counters, the plane counters and the
live keys' state words must be equal.  A `dp_probe` stream (installs,
probes, pulls, peeks, clock edges) is fed to both planes alone.  The race
cases hold the port's plane to the reference's bounds, and the daemon
cases run the port's daemon on the live clock, where the h2 front
attaches the plane; they assert only timing-free facts (an exact
remaining sequence across h2 → HTTP → h2, counters above zero).
"""

from __future__ import annotations

import json
import re
import threading
import urllib.request
from pathlib import Path

import numpy as np
import pytest
from test_ledger import SpecOracle, make_dec
from test_torch_ledger import Twin, _serve

from gubernator_tpu.core import ledger as ref_ledger_mod
from gubernator_tpu.core import native_plane as ref_native_plane
from gubernator_tpu.core.engine import PackedKeys as RefPackedKeys
from gubernator_tpu.net.grpc_service import V1Stub, dial
from gubernator_tpu.net.pb import gubernator_pb2 as pb
from gubernator_tpu.service import COLUMNAR_DISQUALIFIERS as REF_DISQUALIFIERS
from gubernator_tpu.types import Algorithm, Behavior, Status
from gubernator_tpu_torch.clock import Clock
from gubernator_tpu_torch.config import DaemonConfig
from gubernator_tpu_torch.core import ledger as ledger_mod
from gubernator_tpu_torch.core import native_plane
from gubernator_tpu_torch.core.engine import DecisionEngine, PackedKeys
from gubernator_tpu_torch.core.ledger import DecisionLedger
from gubernator_tpu_torch.daemon import spawn_daemon
from gubernator_tpu_torch.service import COLUMNAR_DISQUALIFIERS

ROOT = Path(__file__).resolve().parent.parent
T0_NS = 1_760_000_000_123 * 1_000_000


def _encode(rows) -> bytes:
    """rows [(key, algo, behavior, hits, limit, duration, burst)] →
    GetRateLimitsReq bytes; keys are b"<name>_<unique>"."""
    reqs = []
    for key, algo, behavior, hits, limit, duration, burst in rows:
        name, _, uk = key.decode().partition("_")
        reqs.append(pb.RateLimitReq(name=name, unique_key=uk, hits=hits, limit=limit,
                                    duration=duration, algorithm=algo, behavior=behavior,
                                    burst=burst))
    return pb.GetRateLimitsReq(requests=reqs).SerializeToString()


def _answers(msg: bytes):
    return [(int(r.status), int(r.limit), int(r.remaining), int(r.reset_time))
            for r in pb.GetRateLimitsResp.FromString(msg).responses]


def test_plane_constants_equal_the_ledger_and_the_reference():
    """Both tiers must decline exactly what the ledger revokes on, and
    dp_pull's kinds must be the ledger's entry kinds."""
    assert native_plane._BREAKERS == ledger_mod._BREAKERS == ref_native_plane._BREAKERS
    assert ledger_mod._BREAKERS == ref_ledger_mod._BREAKERS
    assert COLUMNAR_DISQUALIFIERS == REF_DISQUALIFIERS
    src = (ROOT / "gubernator_tpu_torch/csrc/decision_plane.cpp").read_text()
    m = re.search(r"constexpr int kOver = (\d+), kLease = (\d+);", src)
    assert m and (int(m[1]), int(m[2])) == (ledger_mod._K_OVER, ledger_mod._K_LEASE)
    assert (ledger_mod._K_OVER, ledger_mod._K_LEASE) == (ref_ledger_mod._K_OVER,
                                                         ref_ledger_mod._K_LEASE)


class NativeTwin(Twin):
    """Twin (tests/test_torch_ledger.py) with a plane attached to each
    ledger, hints on, served RPC-shaped as the h2 connection threads do."""

    def __init__(self, **kw):
        super().__init__(**kw)
        self.plane = native_plane.NativeDecisionPlane(disqualify_mask=COLUMNAR_DISQUALIFIERS)
        self.ref_plane = ref_native_plane.NativeDecisionPlane(disqualify_mask=REF_DISQUALIFIERS)
        for plane, led in ((self.plane, self.ledger), (self.ref_plane, self.ref_ledger)):
            plane.set_hints(True)
            led.attach_native(plane)
        self.native_answers = 0

    def serve_rpc(self, rows, tag=""):
        """Native first on both sides (equal bytes, or both declined), the
        ledger path on a decline; every answer equal to the spec's."""
        now = self.clock.now_ms()
        body = _encode(rows)
        got = self.plane.try_serve(body, max_items=len(rows), now_ms=now)
        want = self.ref_plane.try_serve(body, max_items=len(rows), now_ms=now)
        assert got == want, f"{tag}: port plane {got!r}, reference plane {want!r}"
        if got is not None:
            self.native_answers += len(rows)
            ans = _answers(got)
            spec = self.oracle.serve(rows)
            assert ans == spec, f"{tag}: plane {ans} spec {spec}"
            return ans
        return self.serve(rows, tag=tag)

    def settle_and_compare(self):
        super().settle_and_compare()
        assert self.plane.stats() == self.ref_plane.stats()

    def close(self):
        super().close()
        self.plane.close()
        self.ref_plane.close()


@pytest.fixture
def twin_of():
    made = []

    def make(**kw):
        t = NativeTwin(**kw)
        made.append(t)
        return t

    yield make
    for t in made:
        t.close()


def _hot(key, hits=1, limit=1000, duration=60000, behavior=0, algo=0):
    return (key, algo, behavior, hits, limit, duration, 0)


def _fuzz_native(t, seed, n_rpcs, n_keys, limit_hi=12):
    """tests/test_native_plane.py _fuzz_native: mostly single-item RPCs
    (the herd shape), sometimes multi-item ones, with clock jumps,
    config churn, leaky rows, RESET_REMAINING, over-asks, negative hits."""
    rng = np.random.default_rng(seed)
    keys = [b"n_k%d" % i for i in range(n_keys)]
    limits = rng.integers(1, limit_hi, n_keys)
    durations = rng.integers(1, 4, n_keys) * 40
    for b in range(n_rpcs):
        t.advance(int(rng.integers(0, 12)))
        if rng.random() < 0.06:
            t.advance(int(rng.integers(40, 200)))
        if rng.random() < 0.1:
            j = int(rng.integers(0, n_keys))
            if rng.random() < 0.5:
                limits[j] = int(rng.integers(1, limit_hi))
            else:
                durations[j] = int(rng.integers(1, 4)) * 40
        rows = []
        for _ in range(1 if rng.random() < 0.7 else int(rng.integers(2, 5))):
            j = int(rng.integers(0, n_keys))
            algo = int(Algorithm.LEAKY_BUCKET) if rng.random() < 0.08 else int(
                Algorithm.TOKEN_BUCKET)
            behavior = int(Behavior.RESET_REMAINING) if rng.random() < 0.04 else 0
            hits = int(rng.integers(0, 4))
            if rng.random() < 0.05:
                hits = int(rng.integers(4, 20))
            if rng.random() < 0.03:
                hits = -int(rng.integers(1, 3))
            rows.append((keys[j], algo, behavior, hits, int(limits[j]), int(durations[j]),
                         int(rng.integers(0, 3)) * 7))
        t.serve_rpc(rows, tag=f"rpc {b}")
    t.settle_and_compare()
    assert t.native_answers > 0
    assert t.stats()["leases_granted"] > 0


def test_native_parity_fuzz_vs_reference_and_spec(twin_of):
    _fuzz_native(twin_of(lease_size=8, lease_ttl=0.05, hot_threshold=2), seed=13, n_rpcs=300,
                 n_keys=5)


@pytest.mark.slow
@pytest.mark.parametrize("seed", [21, 22, 23])
def test_native_parity_fuzz_soak(twin_of, seed):
    _fuzz_native(twin_of(lease_size=8, lease_ttl=0.05, hot_threshold=2), seed=seed,
                 n_rpcs=1500, n_keys=8)


def test_native_drains_are_sequential_and_exact(twin_of):
    """Grant → delegate → every later single-item RPC answers in C with
    the exact sequential remaining."""
    t = twin_of(lease_size=64, lease_ttl=10.0, hot_threshold=1)
    for i in range(80):
        t.serve_rpc([_hot(b"n_hot", limit=10_000)], tag=f"hit {i}")
    assert t.native_answers >= 60
    assert t.plane.stats()["native_answered"] == t.native_answers
    t.settle_and_compare()


def test_native_sticky_over_boundary_at_reset(twin_of):
    """Sticky OVER answers natively until exactly the reset and declines
    one past it."""
    t = twin_of(lease_size=4, hot_threshold=100)
    key = b"n_sticky"
    rows = [_hot(key, hits=3, limit=3, duration=1000)]
    t.serve_rpc(rows)  # consumes to 0
    t.serve_rpc(rows)  # OVER through the engine; learned
    before = t.native_answers
    t.serve_rpc(rows)  # the plane's sticky answer
    assert t.native_answers == before + 1
    got = t.serve_rpc([_hot(key, hits=0, limit=3, duration=1000)])
    assert got[0][0] == int(Status.OVER_LIMIT)
    t.advance(got[0][3] - t.clock.now_ms())
    before = t.native_answers
    t.serve_rpc(rows, tag="at reset")  # still the plane's OVER
    assert t.native_answers == before + 1
    t.advance(1)
    t.serve_rpc(rows, tag="past reset")  # declined → the engine
    assert t.native_answers == before + 1
    t.settle_and_compare()


def test_native_lease_ttl_expiry_mid_stream(twin_of):
    t = twin_of(lease_size=64, lease_ttl=0.02, hot_threshold=1)
    key = b"n_ttl"
    for _ in range(4):
        t.serve_rpc([_hot(key, hits=2, limit=100)])
    assert t.native_answers > 0
    t.advance(25)  # past the lease TTL, inside the bucket window
    t.serve_rpc([_hot(key, hits=2, limit=100)], tag="post-ttl")
    assert t.stats()["settles"] >= 1
    t.settle_and_compare()


def test_native_declines_out_of_scope_rows(twin_of):
    """Breakers and out-of-scope behaviors are never answered natively."""
    t = twin_of(lease_size=64, lease_ttl=10.0, hot_threshold=1)
    key = b"n_scope"
    for _ in range(3):
        t.serve_rpc([_hot(key, limit=1000)])
    assert t.native_answers > 0
    now = t.clock.now_ms()
    bodies = [_encode([_hot(key, behavior=b, limit=1000)])
              for b in (int(Behavior.RESET_REMAINING), int(Behavior.DURATION_IS_GREGORIAN),
                        int(Behavior.GLOBAL), int(Behavior.SKETCH))]
    bodies += [_encode([_hot(key, algo=int(Algorithm.LEAKY_BUCKET), limit=1000)]),
               _encode([_hot(key, hits=-1, limit=1000)]), _encode([_hot(key, limit=999)])]
    for body in bodies:
        assert t.plane.try_serve(body, now_ms=now) is None
        assert t.ref_plane.try_serve(body, now_ms=now) is None
    t.settle_and_compare()


def test_native_invalidate_keys_pulls_plane(twin_of):
    t = twin_of(lease_size=64, lease_ttl=10.0, hot_threshold=1)
    key = b"n_inv"
    for _ in range(3):
        t.serve_rpc([_hot(key, limit=100)])
    assert t.plane.peek(key) is not None
    t.ledger.invalidate_keys([key])
    t.ref_ledger.invalidate_keys([key])
    assert t.plane.peek(key) is None
    assert t.view(key, 100, 60000)[1] == 100 - 3
    t.oracle.serve([_hot(key, hits=0, limit=100)])
    t.settle_and_compare()


def test_dp_probe_stream_equals_the_reference_plane():
    """The same seeded stream of installs (OVER and leases), probes at
    clock edges (now == reset, now == expiry, one past each), breaker
    rows, config mismatches, peeks, pulls and clears through both planes
    alone: equal answers, equal records and equal dp_stats."""
    rng = np.random.default_rng(31)
    port = native_plane.NativeDecisionPlane(max_keys=6, disqualify_mask=COLUMNAR_DISQUALIFIERS)
    ref = ref_native_plane.NativeDecisionPlane(max_keys=6, disqualify_mask=REF_DISQUALIFIERS)
    keys = [b"p_%d" % i for i in range(9)]
    now = 1_000_000
    try:
        for step in range(1500):
            key = keys[int(rng.integers(0, len(keys)))]
            op = rng.random()
            lim = int(rng.choice([5, 50, 1000]))
            dur = int(rng.choice([1000, 60_000]))
            if op < 0.1:
                args = (key, lim, dur, now + int(rng.integers(-5, 50)))
                assert port.install_over(*args) == ref.install_over(*args), step
            elif op < 0.25:
                credit = int(rng.integers(0, 40))
                args = (key, lim, dur, now + int(rng.integers(-5, 80)), lim - 3, credit,
                        int(rng.integers(0, credit + 1)), now + int(rng.integers(-5, 40)))
                assert port.install_lease(*args) == ref.install_lease(*args), step
            elif op < 0.33:
                assert port.pull(key) == ref.pull(key), step
            elif op < 0.38:
                assert port.peek(key) == ref.peek(key), step
            elif op < 0.39:
                port.clear()
                ref.clear()
            else:
                algo = int(Algorithm.LEAKY_BUCKET) if rng.random() < 0.05 else 0
                beh = int(rng.choice([0, 0, 0, 0, int(Behavior.RESET_REMAINING),
                                      int(Behavior.DURATION_IS_GREGORIAN), int(Behavior.GLOBAL)]))
                hits = int(rng.choice([-1, 0, 1, 1, 2, 7, 30]))
                if rng.random() < 0.1:
                    lim += 1  # a config mismatch
                args = (key, algo, beh, hits, lim, dur, now)
                assert port.probe(*args) == ref.probe(*args), (step, args)
            if rng.random() < 0.2:
                now += int(rng.integers(0, 20))
        for key in keys:
            assert port.peek(key) == ref.peek(key)
        assert port.stats() == ref.stats()
        assert port.stats()["native_answered"] > 0
    finally:
        port.close()
        ref.close()


def test_native_under_admission_race_bound():
    """Lane drains racing a pull: the pulled count equals the admitted
    count exactly, never above the credit."""
    plane = native_plane.NativeDecisionPlane(disqualify_mask=0)
    key = b"n_race"
    credit, now, n_threads = 1000, 1_000_000, 8
    assert plane.install_lease(key, 10**6, 60000, now + 60000, 10**6, credit, 0, now + 10**6)
    admitted = [0] * n_threads
    start = threading.Barrier(n_threads)

    def lane(t):
        start.wait()
        for _ in range(400):
            if plane.probe(key, 0, 0, 1, 10**6, 60000, now) is not None:
                admitted[t] += 1

    threads = [threading.Thread(target=lane, args=(t,)) for t in range(n_threads)]
    for th in threads:
        th.start()
    res = None
    while res is None:
        res = plane.pull(key)
    for th in threads:
        th.join()
    assert sum(admitted) == res[1] <= credit
    plane.close()


def test_native_coherence_race_conserves_credit():
    """try_serve lanes racing the Python plan path (pull → local answer →
    re-delegate): once settled, the device remaining accounts for every
    admitted hit exactly."""
    clock = Clock().freeze_at(T0_NS)
    engine = DecisionEngine(2048, clock=clock, device="cpu")
    ledger = DecisionLedger(engine, lease_size=32, lease_ttl=10.0, hot_threshold=1,
                            settle_interval=0)
    plane = native_plane.NativeDecisionPlane(disqualify_mask=COLUMNAR_DISQUALIFIERS)
    ledger.attach_native(plane)
    key, limit = b"n_cons", 1_000_000
    row = _hot(key, limit=limit)
    body = _encode([row])

    def py_serve():
        return _serve(ledger, engine, PackedKeys, make_dec([row]), clock.now_ms())

    py_serve()
    py_serve()  # grant + delegate
    now = clock.now_ms()
    n_threads, per = 4, 150
    native_admits = [0] * n_threads

    def lane(t):
        for _ in range(per):
            if plane.try_serve(body, now_ms=now) is not None:
                native_admits[t] += 1

    threads = [threading.Thread(target=lane, args=(t,)) for t in range(n_threads)]
    for th in threads:
        th.start()
    py_admits = 0
    for _ in range(30):
        assert int(py_serve()[0][0]) == int(Status.UNDER_LIMIT)
        py_admits += 1
    for th in threads:
        th.join()
    total = sum(native_admits) + py_admits + 2
    ledger.invalidate_keys([key])
    st, _lim, rem, _rst = engine.apply_columnar(
        [key], np.zeros(1, np.int32), np.zeros(1, np.int32), np.zeros(1, np.int64),
        np.asarray([limit], np.int64), np.asarray([60000], np.int64), np.zeros(1, np.int64))
    assert int(rem[0]) == limit - total, (int(rem[0]), total)
    ledger.close()
    plane.close()
    engine.close()


def test_second_plane_takes_back_the_first_planes_leases():
    """A second plane attached to a ledger (a second h2 front on one
    instance) first pulls every delegated lease back from the first plane
    with its drained count, and empties it: the first plane answers
    nothing after the switch, and once settled the device remaining
    accounts for every admitted hit exactly, those drained in the first
    plane included."""
    clock = Clock().freeze_at(T0_NS)
    engine = DecisionEngine(2048, clock=clock, device="cpu")
    ledger = DecisionLedger(engine, lease_size=32, lease_ttl=10.0, hot_threshold=1,
                            settle_interval=0)
    first, second = (native_plane.NativeDecisionPlane(disqualify_mask=COLUMNAR_DISQUALIFIERS)
                     for _ in range(2))
    ledger.attach_native(first)
    key, limit = b"n_two", 1_000_000
    row = _hot(key, limit=limit)
    body = _encode([row])

    def py_serve():
        return _serve(ledger, engine, PackedKeys, make_dec([row]), clock.now_ms())

    py_serve()
    py_serve()  # grant + delegate to the first plane
    now = clock.now_ms()
    drained = sum(first.try_serve(body, now_ms=now) is not None for _ in range(10))
    assert drained == 10
    ledger.attach_native(second)
    assert first.try_serve(body, now_ms=now) is None
    for _ in range(5):
        assert int(py_serve()[0][0]) == int(Status.UNDER_LIMIT)
    assert second.try_serve(body, now_ms=now) is not None  # re-delegated to the second
    ledger.detach_native(first)  # not attached: a no-op
    assert ledger._native is second
    ledger.invalidate_keys([key])
    _st, _lim, rem, _rst = engine.apply_columnar(
        [key], np.zeros(1, np.int32), np.zeros(1, np.int32), np.zeros(1, np.int64),
        np.asarray([limit], np.int64), np.asarray([60000], np.int64), np.zeros(1, np.int64))
    assert int(rem[0]) == limit - (2 + drained + 5 + 1)
    ledger.close()
    first.close()
    second.close()
    engine.close()


def _h2_req(limit):
    return pb.GetRateLimitsReq(requests=[pb.RateLimitReq(
        name="e2e", unique_key="hot", hits=1, limit=limit, duration=3_600_000)])


def _http_remaining(address, limit) -> int:
    body = json.dumps({"requests": [{"name": "e2e", "unique_key": "hot", "hits": 1,
                                     "limit": limit, "duration": 3_600_000}]}).encode()
    with urllib.request.urlopen(urllib.request.Request(
            f"http://{address}/v1/GetRateLimits", data=body, method="POST"), timeout=30) as r:
        return int(json.loads(r.read())["responses"][0]["remaining"])


def _daemon(**kw):
    conf = DaemonConfig(http_listen_address="127.0.0.1:0", cache_size=1 << 12,
                        sweep_interval=0.0, h2_fast_address="127.0.0.1:0", h2_fast_window=0.001,
                        **kw)
    return spawn_daemon(conf, device="cpu")


def test_fast_front_native_plane_end_to_end():
    """The port's daemon on the live clock: the h2 front's connection
    threads answer the hot key in C, and the HTTP gateway (the dataclass
    path, which pulls the lease through invalidate_keys) continues the
    same exact sequence, as does the h2 front after it."""
    d = _daemon(ledger_hot_threshold=2, ledger_lease_ttl=30.0)
    try:
        assert d.h2_fast.plane is not None
        assert d.instance.ledger._native is d.h2_fast.plane
        limit = 10**6
        fast = V1Stub(dial(d.h2_fast_address))
        rems = [fast.GetRateLimits(_h2_req(limit), timeout=10).responses[0].remaining
                for _ in range(60)]
        assert rems == list(range(limit - 1, limit - 61, -1))
        assert d.h2_fast.stats()["native_rpcs"] > 0
        assert _http_remaining(d.http_address, limit) == limit - 61
        assert fast.GetRateLimits(_h2_req(limit), timeout=10).responses[0].remaining == \
            limit - 62
    finally:
        d.close()
    assert d.h2_fast.plane is None


@pytest.mark.parametrize("knob", ["native_ledger", "ledger"])
def test_fast_front_without_the_plane(knob, monkeypatch):
    """GUBER_NATIVE_LEDGER=0 runs the front with no plane, and
    GUBER_LEDGER=0 runs the service with no ledger (so no plane either):
    the window path serves everything."""
    from gubernator_tpu_torch.config import setup_daemon_config

    env = "GUBER_NATIVE_LEDGER" if knob == "native_ledger" else "GUBER_LEDGER"
    monkeypatch.setenv(env, "0")
    assert getattr(setup_daemon_config(), knob) is False
    d = _daemon(**{knob: False})
    try:
        assert d.h2_fast.plane is None
        assert (d.instance.ledger is None) == (knob == "ledger")
        stub = V1Stub(dial(d.h2_fast_address))
        for expect in (4, 3, 2):
            got = stub.GetRateLimits(pb.GetRateLimitsReq(requests=[pb.RateLimitReq(
                name="off", unique_key="k", hits=1, limit=5, duration=60_000)]), timeout=10)
            assert got.responses[0].remaining == expect
        assert d.h2_fast.stats()["native_rpcs"] == 0
    finally:
        d.close()


def test_frozen_clock_gets_no_plane():
    """A frozen clock never attaches the plane, whatever the knob says."""
    d = spawn_daemon(DaemonConfig(http_listen_address="127.0.0.1:0", cache_size=256,
                                  sweep_interval=0.0, h2_fast_address="127.0.0.1:0"),
                     clock=Clock().freeze_at(T0_NS), device="cpu")
    try:
        assert d.instance.ledger is not None and d.h2_fast.plane is None
    finally:
        d.close()


def test_plane_answers_carry_retry_hints():
    """GUBER_RETRY_HINTS: a plane-served OVER answer carries
    retry_after_ms = reset - now; with the hint off, none."""
    for on in (True, False):
        plane = native_plane.NativeDecisionPlane(disqualify_mask=COLUMNAR_DISQUALIFIERS)
        plane.set_hints(on)
        now = 1_000_000
        assert plane.install_over(b"h_k", 5, 60_000, now + 1234)
        msg = plane.try_serve(_encode([_hot(b"h_k", limit=5)]), now_ms=now)
        r = pb.GetRateLimitsResp.FromString(msg).responses[0]
        assert r.status == pb.OVER_LIMIT and r.reset_time == now + 1234
        assert dict(r.metadata) == ({"retry_after_ms": "1234"} if on else {})
        plane.close()
