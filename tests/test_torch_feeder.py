"""The port's columnar feeder (core/native_plane.py NativeColumnarFeeder over
csrc/columnar_feeder.cpp, built with g++ into the h2 server's library) and
the h2 front that serves through it, on the CPU, against the reference's.

Ports the cases of `tests/test_feeder.py` and the feeder parity case of
`tests/test_h2_event_front.py`.  The pack-parity cases pack the same
payloads into the port's feeder and the reference's: the columns each
window hands its callback (key bytes, offsets, every value lane, both FNV
hashes, the per-RPC ranges) must equal the reference feeder's and the
port's `wire_codec.decode_reqs` of each payload, exactly.  The ring's
operational contract is held as the reference's tests hold it: overflow
declines (never blocks, never drops), teardown drains then closes, a
flush accounts for every packed row.  The front cases run the port's
daemon on the CPU: fall-through RPCs ride the feeder (windows == 0),
OVER_LIMIT answers carry a retry_after_ms hint from the engine's clock,
GLOBAL RPCs fall to the byte window path, and GUBER_NATIVE_FEEDER=0 /
GUBER_RETRY_HINTS=0 turn the feeder and the hint off.
"""

from __future__ import annotations

import threading
import time

import grpc
import numpy as np
import pytest

from gubernator_tpu.core.native_plane import NativeColumnarFeeder as RefFeeder
from gubernator_tpu.net import wire_codec as ref_codec
from gubernator_tpu.net.grpc_service import V1Stub, dial
from gubernator_tpu.net.pb import gubernator_pb2 as pb
from gubernator_tpu_torch.config import DaemonConfig
from gubernator_tpu_torch.core import native_plane
from gubernator_tpu_torch.core.engine import DecisionEngine
from gubernator_tpu_torch.core.native_plane import NativeColumnarFeeder
from gubernator_tpu_torch.daemon import spawn_daemon
from gubernator_tpu_torch.net import wire_codec
from gubernator_tpu_torch.net.h2_fast import H2FastFront
from gubernator_tpu_torch.service import COLUMNAR_DISQUALIFIERS, V1Instance
from gubernator_tpu_torch.store import MemoryStore
from gubernator_tpu_torch.types import Behavior, Status

PATH = "/pb.gubernator.V1/GetRateLimits"
LANES = ("algo", "behavior", "hits", "limit", "duration", "burst", "fnv1", "fnv1a")


def _payload(items):
    return pb.GetRateLimitsReq(requests=[pb.RateLimitReq(**kw) for kw in items]).SerializeToString()


def _capture(cls, **kw):
    """A feeder of class `cls` whose window handler snapshots the packed
    columns."""
    captured = []

    def handler(slot, n_rows, n_rpcs, key_bytes):
        got = {"key_buf": slot.key_buf[:key_bytes].copy(),
               "key_offsets": slot.key_offsets[: n_rows + 1].copy(),
               "name_lens": slot.name_lens[:n_rows].copy(),
               "rpc_row": slot.rpc_row[:n_rpcs].copy(),
               "rpc_items": slot.rpc_items[:n_rpcs].copy()}
        got.update({lane: getattr(slot, lane)[:n_rows].copy() for lane in LANES})
        captured.append(got)
        slot.rpc_status[:n_rpcs] = 0
        return 0

    return cls(window_handler=handler, **kw), captured


def _twins(**kw):
    """The port's capturing feeder and the reference's, same arguments."""
    port, got = _capture(NativeColumnarFeeder, **kw)
    ref, want = _capture(RefFeeder, **kw)
    return port, got, ref, want


def _same_windows(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for name in g:
            np.testing.assert_array_equal(g[name], w[name], err_msg=name)


def _same_as_decode(got: dict, body: bytes, row0: int = 0, k=None):
    """Rows [row0, row0 + k) of a captured window equal the port's decode
    of `body` (and the reference's decode equals the port's)."""
    dec = wire_codec.decode_reqs(body, 2048, 0)
    ref = ref_codec.decode_reqs(body, 2048, 0)
    assert dec is not None and ref is not None and dec.n == ref.n
    k = dec.n if k is None else k
    assert k == dec.n
    off0 = int(got["key_offsets"][row0])
    np.testing.assert_array_equal(got["key_offsets"][row0 : row0 + k + 1] - off0, dec.key_offsets)
    np.testing.assert_array_equal(got["key_buf"][off0 : int(got["key_offsets"][row0 + k])],
                                  dec.key_buf)
    np.testing.assert_array_equal(got["name_lens"][row0 : row0 + k], dec.name_len)
    np.testing.assert_array_equal(dec.key_buf, ref.key_buf)
    for lane in LANES:
        np.testing.assert_array_equal(got[lane][row0 : row0 + k], getattr(dec, lane),
                                      err_msg=lane)
        np.testing.assert_array_equal(getattr(ref, lane), getattr(dec, lane), err_msg=lane)


def _fuzz_items(rng, n):
    """Random request rows across algorithms, value widths (32-bit
    boundaries, int64 extremes, negative hits) and key shapes ('_' and
    multi-byte characters in names)."""
    items = []
    for _ in range(n):
        name = rng.choice(["r", "rate_limit", "x" * 60, "a_b_c", "Ω≈ç"]) + str(rng.integers(0, 99))
        key = rng.choice(["k", "user_1234", "z" * 120]) + str(rng.integers(0, 999))
        items.append(dict(
            name=name, unique_key=key,
            hits=int(rng.choice([0, 1, -1, 7, 2**31 - 1, 2**31, -(2**40), 2**62])),
            limit=int(rng.choice([1, 100, 2**32 + 5, 2**62])),
            duration=int(rng.choice([1000, 60_000, 2**40])),
            algorithm=int(rng.choice([0, 1])),
            behavior=int(rng.choice([0, 2, 8, 32])),  # none of them disqualifies here
            burst=int(rng.choice([0, 5, 2**33])),
        ))
    return items


# -- the pack (tests/test_feeder.py) ------------------------------------


def test_pack_parity_fuzz():
    """Single-RPC windows across wire widths and algorithms: the port's
    packed columns equal the reference feeder's and the decode's."""
    port, got, ref, want = _twins(n_slots=2, max_rows=2048)
    rng = np.random.default_rng(7)
    try:
        payloads = [_payload(_fuzz_items(rng, int(rng.integers(1, 40)))) for _ in range(20)]
        for body in payloads:
            assert port.pack(body) == ref.pack(body) > 0
            port.flush()
            ref.flush()
        assert len(got) == len(payloads)
        _same_windows(got, want)
        for body, g in zip(payloads, got):
            assert g["key_offsets"][0] == 0
            _same_as_decode(g, body)
    finally:
        port.close()
        ref.close()


def test_pack_parity_multi_rpc_window():
    """Several RPCs in ONE window: the per-RPC ranges (rpc_row /
    rpc_items) recover each body's own decode exactly, and the joint
    offsets stay gap-free."""
    port, got, ref, want = _twins(n_slots=2, max_rows=2048, window_s=0.5)
    rng = np.random.default_rng(11)
    try:
        bodies = [_payload(_fuzz_items(rng, int(rng.integers(1, 12)))) for _ in range(6)]
        for b in bodies:
            assert port.pack(b) == ref.pack(b) > 0
        port.flush()
        ref.flush()
        assert len(got) == 1
        _same_windows(got, want)
        g = got[0]
        assert len(g["rpc_row"]) == len(bodies) and g["rpc_row"][0] == 0
        np.testing.assert_array_equal(g["rpc_row"][1:], (g["rpc_row"] + g["rpc_items"])[:-1])
        for r, body in enumerate(bodies):
            _same_as_decode(g, body, int(g["rpc_row"][r]), int(g["rpc_items"][r]))
    finally:
        port.close()
        ref.close()


def test_pack_declines_disqualified_and_malformed():
    port, got, ref, want = _twins(disqualify_mask=COLUMNAR_DISQUALIFIERS)
    try:
        body = _payload([dict(name="g", unique_key="k", hits=1, limit=5, duration=1000,
                              behavior=int(Behavior.GLOBAL))])
        for f in (port, ref):
            assert f.pack(body) == -1  # disqualified: the byte path's
            assert f.pack(b"\xff\xff\xff") == -1  # malformed
            assert f.stats()["feeder_declined"] == 2
        assert not got and not want
    finally:
        port.close()
        ref.close()


def test_oversized_claim_declines_without_sealing():
    """An RPC whose key bytes cannot fit even an EMPTY window declines
    (-1) WITHOUT sealing the open window, which keeps its claims open."""
    # key_cap 1 clamps to the 64 KiB floor.
    port, got, ref, want = _twins(n_slots=2, max_rows=2048, key_cap=1, window_s=0.5)
    try:
        small = _payload([dict(name="sm", unique_key="k1xyz", hits=1, limit=9, duration=1000)])
        big = _payload([dict(name="big", unique_key="k" * 80 + str(i), hits=1, limit=9,
                             duration=1000) for i in range(1000)])  # ~80 KB of keys
        for f in (port, ref):
            assert f.pack(small) == 1
            before = f.stats()
            assert f.pack(big, max_items=1000) == -1
            after = f.stats()
            assert after["feeder_declined"] == before["feeder_declined"] + 1
            assert after["feeder_ring_full"] == before["feeder_ring_full"]
            assert f.pack(small) == 1  # the open window still takes rows
            f.flush()
        assert len(got) == 1 and len(got[0]["algo"]) == 2
        _same_windows(got, want)
    finally:
        port.close()
        ref.close()


def test_max_rpcs_clamp_reflected_in_views():
    """The C side clamps max_rpcs to its cursor field's width, and the
    views map the clamped capacity, not the argument."""
    port, _, ref, _ = _twins(n_slots=2, max_rows=64, max_rpcs=100_000)
    try:
        for f in (port, ref):
            assert f.max_rpcs == 8191  # kRpcsMask
            assert len(f.slots[0].rpc_status) == 8191
            assert f.stats()["feeder_max_rpcs"] == 8191
        assert port.stats() == ref.stats()
    finally:
        port.close()
        ref.close()


def test_ring_overflow_backpressure_and_recovery():
    """A blocked serve thread and a tiny ring: cf_pack returns the
    backpressure decline (never blocks, never drops); once the serve
    thread drains, packing works again."""
    release = threading.Event()
    served = []

    def handler(slot, n_rows, n_rpcs, key_bytes):
        release.wait(timeout=10)
        served.append(n_rows)
        slot.rpc_status[:n_rpcs] = 0
        return 0

    feeder = NativeColumnarFeeder(n_slots=2, max_rows=64, max_rpcs=16, flush_rows=8,
                                  window_s=0.001, window_handler=handler)
    try:
        body = _payload([dict(name="bp", unique_key=f"k{i}xyz", hits=1, limit=9, duration=1000)
                         for i in range(8)])
        # Window A seals at flush_rows = 8 and blocks in the handler;
        # window B fills and seals; with two slots nothing is left to
        # rotate to: backpressure.
        deadline = time.monotonic() + 10
        rc = feeder.pack(body)
        while rc > 0 and time.monotonic() < deadline:
            rc = feeder.pack(body)
        assert rc == -2
        assert feeder.stats()["feeder_ring_full"] >= 1
        release.set()
        feeder.flush()
        assert sum(served) == feeder.stats()["feeder_served_rows"]
        deadline = time.monotonic() + 10
        rc = feeder.pack(body)
        while rc == -2 and time.monotonic() < deadline:
            time.sleep(0.005)
            rc = feeder.pack(body)
        assert rc > 0
        feeder.flush()
    finally:
        feeder.close()


def test_teardown_drains_claimed_windows():
    """close() with claimed but unserved windows drains (every packed row
    served) and frees without a crash."""
    hold = threading.Event()
    served = []

    def handler(slot, n_rows, n_rpcs, key_bytes):
        hold.wait(timeout=3)
        served.append(n_rows)
        slot.rpc_status[:n_rpcs] = 0
        return 0

    feeder = NativeColumnarFeeder(n_slots=3, max_rows=64, flush_rows=8, window_s=0.001,
                                  window_handler=handler)
    body = _payload([dict(name="td", unique_key=f"x{i}abc", hits=1, limit=9, duration=1000)
                     for i in range(8)])
    packed = sum(max(0, feeder.pack(body)) for _ in range(3))
    hold.set()
    st = feeder.stats()
    feeder.close()  # stop drains the remaining windows, then frees
    assert packed > 0 and st["feeder_rows"] == packed
    # Windows drained by the stop answer UNAVAILABLE without the handler.
    assert sum(served) <= packed


def test_flush_observes_late_claims_row_conservation():
    """Producers pack while other threads flush; after the last flush,
    with no producer in flight, every packed row has been served."""
    served = [0]
    lock = threading.Lock()

    def handler(slot, n_rows, n_rpcs, key_bytes):
        with lock:
            served[0] += n_rows
        slot.out_status[:n_rows] = 0
        slot.out_limit[:n_rows] = 9
        slot.out_remaining[:n_rows] = 8
        slot.out_reset[:n_rows] = 0
        slot.rpc_status[:n_rpcs] = 0
        return 0

    # Small windows and a tiny group-commit, so seals, rotations and
    # flushes interleave densely.
    feeder = NativeColumnarFeeder(n_slots=3, max_rows=64, flush_rows=8, window_s=0.0005,
                                  window_handler=handler)
    try:
        body = _payload([dict(name="fl", unique_key=f"y{i}abc", hits=1, limit=9, duration=1000)
                         for i in range(4)])
        n_packers, reps = 4, 150
        packed = [0] * n_packers
        stop = threading.Event()

        def packer(t):
            for _ in range(reps):
                rc = feeder.pack(body)
                if rc > 0:
                    packed[t] += rc

        def flusher():
            while not stop.is_set():
                feeder.flush()

        ts = [threading.Thread(target=packer, args=(t,)) for t in range(n_packers)]
        fs = [threading.Thread(target=flusher) for _ in range(2)]
        for t in ts + fs:
            t.start()
        for t in ts:
            t.join()
        stop.set()
        for t in fs:
            t.join()
        feeder.flush()
        st = feeder.stats()
        total = sum(packed)
        assert total > 0
        assert st["feeder_rows"] == total
        assert st["feeder_served_rows"] == total, (st, total)
        assert served[0] == total
    finally:
        feeder.close()


def test_concurrent_pack_parity():
    """Many threads pack at once: every packed row appears exactly once
    across the windows (no loss, no duplicate, offsets gap-free), and
    every row's columns are the decode's."""
    feeder, captured = _capture(NativeColumnarFeeder, n_slots=4, max_rows=4096, window_s=0.002)
    try:
        n_threads, reps = 8, 50
        body = _payload([dict(name="cc", unique_key=f"u{i}qrs", hits=1, limit=9, duration=1000)
                         for i in range(5)])
        dec = wire_codec.decode_reqs(body, 64, 0)
        ok = [0] * n_threads

        def worker(t):
            for _ in range(reps):
                rc = feeder.pack(body)
                if rc > 0:
                    ok[t] += rc

        ts = [threading.Thread(target=worker, args=(t,)) for t in range(n_threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        feeder.flush()
        total = sum(ok)
        assert total > 0
        assert sum(len(c["algo"]) for c in captured) == total
        for c in captured:
            assert c["key_offsets"][0] == 0
            assert int(c["key_offsets"][-1]) == len(c["key_buf"])
            assert (np.diff(c["key_offsets"]) > 0).all()
            n = len(c["algo"])
            assert n % dec.n == 0  # whole RPCs only
            for r in range(len(c["rpc_row"])):
                _same_as_decode(c, body, int(c["rpc_row"][r]), int(c["rpc_items"][r]))
    finally:
        feeder.close()


def test_sink_feeder_bench_pack():
    """A feeder with no window handler (the pack microbench's sink mode):
    C threads pack without entering Python, every window seals and
    recycles unserved (no callback, so no served rows), and each packed
    row is counted once; the same run on the reference's sink feeder
    packs the same rows."""
    body = _payload([dict(name="sink", unique_key=f"s{i}k", hits=1, limit=9, duration=1000)
                     for i in range(7)])
    for cls in (NativeColumnarFeeder, RefFeeder):
        feeder = cls(n_slots=3, max_rows=256, flush_rows=64, window_s=0.0005)
        try:
            assert feeder.bench_pack(body, 64, 40, 4) == 7 * 40 * 4
            st = feeder.stats()
            assert st["feeder_rows"] == 7 * 40 * 4 and st["feeder_served_rows"] == 0
            assert st["feeder_rpcs"] == 40 * 4 and st["feeder_windows"] >= 1
            assert st["feeder_window_errors"] == 0  # no connection: nothing to answer
        finally:
            feeder.close()


def test_encode_resps_hint_parity_and_metadata():
    """The hint encode is the plain encode plus ONLY the metadata entry
    on OVER items, byte-equal to the reference's."""
    status = np.array([int(Status.UNDER_LIMIT), int(Status.OVER_LIMIT)], dtype=np.int32)
    limit = np.array([10, 10], dtype=np.int64)
    remaining = np.array([3, 0], dtype=np.int64)
    reset = np.array([50_000, 60_000], dtype=np.int64)
    plain = pb.GetRateLimitsResp.FromString(wire_codec.encode_resps(status, limit, remaining,
                                                                    reset))
    for now, hint in ((45_000, "15000"), (99_000, "0")):  # a stale reset clamps at 0
        raw = wire_codec.encode_resps_hint(status, limit, remaining, reset,
                                           int(Status.OVER_LIMIT), now)
        assert raw == ref_codec.encode_resps_hint(status, limit, remaining, reset,
                                                  int(Status.OVER_LIMIT), now)
        hinted = pb.GetRateLimitsResp.FromString(raw)
        for a, b in zip(plain.responses, hinted.responses):
            assert (a.status, a.limit, a.remaining, a.reset_time) == (
                b.status, b.limit, b.remaining, b.reset_time)
        assert not dict(hinted.responses[0].metadata)  # UNDER: no hint
        assert dict(hinted.responses[1].metadata) == {"retry_after_ms": hint}


# -- the front (tests/test_feeder.py, tests/test_h2_event_front.py) -----


@pytest.fixture
def spawn():
    made = []

    def make(**over):
        conf = DaemonConfig(http_listen_address="127.0.0.1:0", cache_size=4096,
                            sweep_interval=0.0, h2_fast_address="127.0.0.1:0",
                            h2_fast_window=0.001, **over)
        made.append(spawn_daemon(conf, device="cpu"))
        return made[-1]

    yield make
    for d in made:
        d.close()


def _fast_call(daemon):
    ch = grpc.insecure_channel(daemon.h2_fast_address)
    return ch, ch.unary_unary(PATH)


def _wait_for(fn, want, timeout=10.0):
    """fn() once it equals `want`, or its last value at the deadline: a
    counter bumped after the response is sent may trail the client."""
    deadline = time.monotonic() + timeout
    got = fn()
    while got != want and time.monotonic() < deadline:
        time.sleep(0.005)
        got = fn()
    return got


def test_feeder_e2e_through_front(spawn):
    """With the ledger off every RPC falls through to the feeder ring:
    answers follow the engine, OVER_LIMIT carries the retry hint (from the
    engine's clock, so a fresh 60 s bucket's hint is near 60 s), and the
    byte window path stays idle."""
    d = spawn(ledger=False)
    ch, call = _fast_call(d)
    try:
        payload = _payload([dict(name="fe2e", unique_key=f"k{i}end", hits=1, limit=2,
                                 duration=60_000) for i in range(3)])
        for _ in range(3):
            raw = call(payload)
        resp = pb.GetRateLimitsResp.FromString(raw)
        assert [r.status for r in resp.responses] == [1, 1, 1]  # limit 2, third round: OVER
        for r in resp.responses:
            hint = int(dict(r.metadata)["retry_after_ms"])
            assert 50_000 < hint <= 60_000, hint
        # feeder_front_rpcs is bumped after the send: wait for it.
        assert _wait_for(lambda: d.h2_fast.stats()["feeder_front_rpcs"], 3) == 3
        st = d.h2_fast.stats()
        assert st["feeder_windows"] >= 1 and st["feeder_front_items"] == 9
        assert st["windows"] == 0  # the byte window path never entered
        assert st["errors"] == 0
    finally:
        ch.close()


def test_feeder_front_declines_global_to_byte_path(spawn):
    """A GLOBAL RPC never enters the feeder (the C side's disqualify
    mask): it falls to the byte window path and answers UNIMPLEMENTED as
    before the feeder."""
    d = spawn(ledger=False)
    ch, call = _fast_call(d)
    try:
        payload = _payload([dict(name="g", unique_key="k1end", hits=1, limit=5,
                                 duration=60_000, behavior=int(Behavior.GLOBAL))])
        with pytest.raises(grpc.RpcError) as err:
            call(payload)
        assert err.value.code() == grpc.StatusCode.UNIMPLEMENTED
        st = d.h2_fast.stats()
        assert st["feeder_front_rpcs"] == 0
        assert st["feeder_declined"] >= 1
        assert st["windows"] >= 1  # the byte path answered it
    finally:
        ch.close()


def test_feeder_disabled_restores_byte_path(spawn, monkeypatch):
    monkeypatch.setenv("GUBER_NATIVE_FEEDER", "0")
    d = spawn(ledger=False)
    ch, call = _fast_call(d)
    try:
        assert d.h2_fast.feeder is None
        payload = _payload([dict(name="off", unique_key="k1end", hits=1, limit=5,
                                 duration=60_000)])
        assert pb.GetRateLimitsResp.FromString(call(payload)).responses[0].remaining == 4
        st = d.h2_fast.stats()
        assert st["windows"] >= 1 and st["feeder_front_rpcs"] == 0
        assert "feeder_rpcs" not in st
    finally:
        ch.close()


def test_retry_hints_disabled(spawn, monkeypatch):
    monkeypatch.setenv("GUBER_RETRY_HINTS", "0")
    d = spawn(ledger=False)
    ch, call = _fast_call(d)
    try:
        payload = _payload([dict(name="noh", unique_key="k1end", hits=1, limit=1,
                                 duration=60_000)])
        call(payload)
        resp = pb.GetRateLimitsResp.FromString(call(payload))
        assert resp.responses[0].status == 1  # OVER
        assert not dict(resp.responses[0].metadata)
        assert _wait_for(lambda: d.h2_fast.stats()["feeder_front_rpcs"], 2) == 2
    finally:
        ch.close()


def test_feeder_stats_in_front_stats(spawn):
    d = spawn(ledger=False)
    st = d.h2_fast.stats()
    for k in ("feeder_rpcs", "feeder_rows", "feeder_windows", "feeder_ring_full",
              "feeder_declined", "feeder_front_rpcs", "feeder_front_items"):
        assert k in st
    assert d.h2_fast.feeder is not None


@pytest.mark.parametrize("feeder", [True, False], ids=["feeder", "bytepath"])
def test_event_front_feeder_attach_detach_parity(spawn, feeder):
    """Reactor-packed feeder windows and the byte window path answer
    alike through the event front."""
    d = spawn()
    front = H2FastFront(d.instance, window_s=0.001, native_feeder=feeder, native_ledger=False)
    try:
        assert front.event_front and (front.feeder is not None) == feeder
        stub = V1Stub(dial(front.address))
        name = "fd" + str(int(feeder))
        for want in (99, 98):
            got = stub.GetRateLimits(pb.GetRateLimitsReq(requests=[
                pb.RateLimitReq(name=name, unique_key=f"k{i}", hits=1, limit=100,
                                duration=60_000) for i in range(7)]))
            assert [r.remaining for r in got.responses] == [want] * 7
        st = front.stats()
        assert (st["windows"] == 0) == feeder
        assert _wait_for(lambda: front.stats()["feeder_front_rpcs"], 2 if feeder else 0) == (
            2 if feeder else 0)
    finally:
        front.close()


# -- the port's own contract ----------------------------------------------


def test_feeder_that_cannot_be_created_fails_the_front(monkeypatch):
    """A feeder that is asked for and cannot be created raises: the front
    never falls back quietly to the byte path."""
    inst = V1Instance(DecisionEngine(1024, device="cpu"), ledger=False)

    class Broken:
        def __init__(self, **kw):
            raise RuntimeError("cf_create failed")

    monkeypatch.setattr(native_plane, "NativeColumnarFeeder", Broken)
    try:
        with pytest.raises(RuntimeError, match="cf_create failed"):
            H2FastFront(inst, window_s=0.001)
        front = H2FastFront(inst, window_s=0.001, native_feeder=False)
        assert front.feeder is None
        front.close()
    finally:
        inst.close()


def test_store_engine_gets_no_feeder():
    """An engine with a write-through store can never serve columnar: the
    front builds no feeder, and its RPCs answer UNIMPLEMENTED through
    the byte path's guard."""
    inst = V1Instance(DecisionEngine(1024, device="cpu", store=MemoryStore()), ledger=False)
    front = H2FastFront(inst, window_s=0.001)
    ch = grpc.insecure_channel(front.address)
    try:
        assert front.feeder is None
        body = _payload([dict(name="s", unique_key="k", hits=1, limit=5, duration=60_000)])
        with pytest.raises(grpc.RpcError) as err:
            ch.unary_unary(PATH)(body, timeout=30)
        assert err.value.code() == grpc.StatusCode.UNIMPLEMENTED
    finally:
        ch.close()
        front.close()
        inst.close()


def test_front_close_under_claimed_windows_strands_no_rpc():
    """close() while the feeder's handler holds a window and more RPCs
    are packed behind it: every client gets an answer (OK or
    UNAVAILABLE), none hangs, and the front frees cleanly."""
    inst = V1Instance(DecisionEngine(1024, device="cpu"), ledger=False)
    front = H2FastFront(inst, window_s=0.001)
    entered, release = threading.Event(), threading.Event()
    real = front._feeder_window

    def slow(slot, n_rows, n_rpcs, key_bytes):
        entered.set()
        release.wait(timeout=10)
        return real(slot, n_rows, n_rpcs, key_bytes)

    front.feeder._handler = slow
    codes = []
    lock = threading.Lock()

    def call(i):
        ch = grpc.insecure_channel(front.address)
        try:
            body = _payload([dict(name="td", unique_key=f"k{i}", hits=1, limit=5,
                                  duration=60_000)])
            ch.unary_unary(PATH)(body, timeout=30)
            code = 0
        except grpc.RpcError as e:
            code = e.code().value[0]
        finally:
            ch.close()
        with lock:
            codes.append(code)

    threads = [threading.Thread(target=call, args=(i,)) for i in range(6)]
    try:
        threads[0].start()
        assert entered.wait(timeout=10)
        for t in threads[1:]:
            t.start()
        assert _wait_for(lambda: front.stats()["feeder_front_items"], 6) == 6
        closer = threading.Thread(target=front.close)
        closer.start()
        time.sleep(0.05)
        release.set()
        closer.join(timeout=30)
        assert not closer.is_alive()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
        assert len(codes) == 6 and set(codes) <= {0, 14}, codes
    finally:
        release.set()
        front.close()
        inst.close()
