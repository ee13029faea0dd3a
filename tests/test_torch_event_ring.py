"""The port's native event ring and its collector, against the reference's.

The port's h2 server library links its own copy of the event ring
(csrc/event_ring.cpp) and publishes the reference's stages into it
(csrc/h2_server.cpp: native_serve, window_wait, window_serve and the
event front's reactor_wake / reactor_read / reactor_write;
csrc/columnar_feeder.cpp: feeder_pack, feeder_ring_wait, feeder_serve);
`utils/native_events.NativeEventCollector` drains it.  These are the
reference's tests/test_trace_stitch.py:243-435 (the ring drops and counts
when full and never blocks; concurrent producers never corrupt a record;
the collector's histograms and span stubs; natively answered RPCs give
`native.decide` stubs) and tests/test_h2_event_front.py:324 (the
reactor stages reach the ring), on the port's front, plus the feeder's
and the byte window's stages and the ring's switch.  The ring itself is
run side by side with the reference's library on the same records.
"""

from __future__ import annotations

import ctypes
import threading
import time

import grpc
import numpy as np
import pytest

from gubernator_tpu.net import h2_fast as ref_h2_fast
from gubernator_tpu.net.pb import gubernator_pb2 as pb
from gubernator_tpu.utils import native_events as ref_native_events
from gubernator_tpu.utils import tracing as ref_tracing
from gubernator_tpu_torch.config import DaemonConfig
from gubernator_tpu_torch.daemon import spawn_daemon
from gubernator_tpu_torch.ops import native_build
from gubernator_tpu_torch.utils import native_events
from gubernator_tpu_torch.utils import tracing

PATH = "/pb.gubernator.V1/GetRateLimits"


def _libs():
    """(the reference's h2 library, the port's), both with the ring."""
    ref = ref_h2_fast.load()
    if ref is None:
        pytest.skip("the reference's native h2 server is unavailable")
    return {"ref": ref, "port": native_build.load("h2_server")}


@pytest.fixture
def tracer():
    t = tracing.InMemoryTracer()
    tracing.set_tracer(t)
    yield t
    tracing.set_tracer(None)


def _until(pred, timeout=30.0, interval=0.02):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(interval)
    return False


def _stats(lib, ring):
    st = np.zeros(2, dtype=np.int64)
    lib.evr_stats(ring, st.ctypes.data_as(ctypes.c_void_p))
    return st.tolist()


@pytest.mark.parametrize("which", ["ref", "port"])
def test_event_ring_overflow_drops_counted(which):
    lib = _libs()[which]
    ring = ctypes.c_void_p(lib.evr_create(8))
    t0 = time.monotonic()
    for i in range(1000):
        lib.evr_record(ring, 1, 123456789 + i, 1000, 1)
    assert time.monotonic() - t0 < 1.0  # never blocks
    assert _stats(lib, ring) == [8, 992]
    out = np.zeros(4 * 64, dtype=np.int64)
    assert lib.evr_drain(ring, out.ctypes.data_as(ctypes.c_void_p), 64) == 8
    assert out[:4].tolist() == [1, 123456789, 1000, 1]
    assert lib.evr_record(ring, 2, 1, 2, 3) == 1
    lib.evr_free(ring)


def test_event_ring_drains_as_the_references():
    """The same records through both rings: the same drains, in order,
    and the same counts, with a full ring dropping the same records."""
    libs = _libs()
    rng = np.random.default_rng(4)
    recs = rng.integers(0, 1 << 40, size=(300, 4)).tolist()
    got = {}
    for which, lib in libs.items():
        ring = ctypes.c_void_p(lib.evr_create(100))  # rounds up to 128
        for k, r in enumerate(recs):
            lib.evr_record(ring, *r)
            if k == 150:
                out = np.zeros(4 * 40, dtype=np.int64)
                n = lib.evr_drain(ring, out.ctypes.data_as(ctypes.c_void_p), 40)
                got.setdefault(which, []).append(out[: 4 * n].copy())
        out = np.zeros(4 * 512, dtype=np.int64)
        n = lib.evr_drain(ring, out.ctypes.data_as(ctypes.c_void_p), 512)
        got[which].append(out[: 4 * n].copy())
        got[which].append(np.asarray(_stats(lib, ring)))
        lib.evr_free(ring)
    for a, b in zip(got["port"], got["ref"]):
        assert np.array_equal(a, b)


def test_event_ring_concurrent_producers():
    lib = _libs()["port"]
    ring = ctypes.c_void_p(lib.evr_create(1024))
    per_thread, n_threads = 5000, 4

    def producer(kind):
        for _ in range(per_thread):
            lib.evr_record(ring, kind, 1000 * kind, 10 * kind, kind)

    drained = []
    stop = threading.Event()

    def consumer():
        out = np.zeros(4 * 512, dtype=np.int64)
        while True:
            n = lib.evr_drain(ring, out.ctypes.data_as(ctypes.c_void_p), 512)
            if n:
                drained.append(out[: 4 * n].reshape(n, 4).copy())
            elif stop.is_set():
                return
            else:
                time.sleep(0.001)

    c = threading.Thread(target=consumer)
    c.start()
    threads = [threading.Thread(target=producer, args=(k + 1,)) for k in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    stop.set()
    c.join(timeout=60)
    assert not c.is_alive()
    written, dropped = _stats(lib, ring)
    assert written == sum(len(d) for d in drained)
    assert written + dropped == per_thread * n_threads
    for d in drained:
        for kind, t_ns, dur, items in d.tolist():
            assert kind in (1, 2, 3, 4)
            assert (t_ns, dur, items) == (1000 * kind, 10 * kind, kind)
    lib.evr_free(ring)


class _FakeFront:
    """The collector's view of a front's ring."""

    def __init__(self, records):
        self._records = list(records)

    def drain_events(self, out):
        n = min(len(self._records), len(out) // 4)
        for i in range(n):
            out[4 * i : 4 * i + 4] = self._records.pop(0)
        return n

    def ring_stats(self):
        return {"written": 3, "dropped": 0, "enabled": True}


def _records():
    t_end = time.monotonic_ns()
    return [[1, t_end, 250_000, 2], [2, t_end, 2_000_000, 1], [3, t_end, 1_000_000, 3],
            [5, t_end, 40_000, 7], [8, t_end, 3_000, 512]]


def test_collector_histograms_and_span_stubs(tracer):
    col = native_events.NativeEventCollector(_FakeFront(_records()), interval=10.0)
    try:
        assert col.drain_once() == 5
        counts = {k: v for k, v in col.event_counts().items() if v}
        assert counts == {"native_serve": 1, "window_wait": 1, "window_serve": 1,
                          "feeder_ring_wait": 1, "reactor_read": 1}
        h = col.histograms()["native_serve"]
        assert h.count == 1 and 1e-4 < h.p50() < 1e-3
        stubs = tracer.spans("native.decide")
        assert len(stubs) == 1 and stubs[0].attributes == {"items": 2, "stage": "native_serve"}
        assert stubs[0].end_ns - stubs[0].start_ns == 250_000
        assert col.stats()["stages"]["window_wait"]["count"] == 1
    finally:
        assert col.close()


def test_collector_stats_equal_the_references():
    """The same records drained by both collectors: the same stages,
    counts and per-stage summaries."""
    records = _records()
    ref_tracing.set_tracer(None)
    cols = (native_events.NativeEventCollector(_FakeFront(records), interval=10.0),
            ref_native_events.NativeEventCollector(_FakeFront(records), interval=10.0))
    try:
        for c in cols:
            c.drain_once()
        assert cols[0].stats() == cols[1].stats()
        assert native_events.STAGES == ref_native_events.STAGES
    finally:
        for c in cols:
            c.close()


def _daemon(**conf):
    return spawn_daemon(DaemonConfig(http_listen_address="127.0.0.1:0", cache_size=1 << 12,
                                     sweep_interval=0.0, h2_fast_address="127.0.0.1:0",
                                     h2_fast_window=0.001, **conf), device="cpu")


def _body(name, key, n=1, limit=10**9):
    return pb.GetRateLimitsReq(requests=[
        pb.RateLimitReq(name=name, unique_key=f"{key}{i}", hits=1, limit=limit,
                        duration=3_600_000) for i in range(n)]).SerializeToString()


def test_native_answers_emit_span_stubs(tracer):
    """A hot key answered by the native decision plane yields
    `native.decide` stubs through the ring collector."""
    d = _daemon(ledger_hot_threshold=2)
    try:
        assert d.h2_fast.plane is not None and d.instance.native_events is not None
        call = grpc.insecure_channel(d.h2_fast_address).unary_unary(PATH)
        body = _body("natspan", "hot")

        def stubbed():
            call(body, timeout=30)
            return (d.h2_fast.stats().get("native_rpcs", 0) > 0
                    and tracer.spans("native.decide"))

        assert _until(stubbed), d.h2_fast.stats()
        assert d.instance.native_events.ring_stats()["written"] > 0
        assert d.instance.native_events.event_counts()["native_serve"] > 0
    finally:
        d.close()


@pytest.mark.parametrize("feeder", ["1", "0"])
def test_front_stages_reach_the_ring(monkeypatch, feeder):
    """tests/test_h2_event_front.py:324 on the port's front: the reactor
    stages and, with the feeder, its pack / ring wait / serve, without it
    the byte window's wait and serve, reach the collector, and
    /debug/vars serves them."""
    monkeypatch.setenv("GUBER_NATIVE_FEEDER", feeder)
    d = _daemon(ledger=False)
    try:
        call = grpc.insecure_channel(d.h2_fast_address).unary_unary(PATH)
        for i in range(20):
            call(_body("ring", f"k{i}_", n=4, limit=10**6), timeout=30)
        ev = d.instance.native_events
        want = (("feeder_pack", "feeder_ring_wait", "feeder_serve") if feeder == "1"
                else ("window_wait", "window_serve"))

        def seen():
            ev.drain_once()
            c = ev.event_counts()
            return all(c.get(s, 0) > 0 for s in ("reactor_wake", "reactor_read") + want)

        assert _until(seen), ev.event_counts()
        stats = ev.stats()
        assert set(stats) == {"events", "ring", "stages"}
        assert stats["ring"]["enabled"] and stats["ring"]["written"] > 0
        for s in want:
            assert stats["stages"][s]["count"] > 0
        from gubernator_tpu_torch.net.gateway import debug_vars

        assert debug_vars(d.instance)["native_events"]["stages"]["reactor_wake"]["count"] > 0
    finally:
        d.close()


def test_ring_off_leaves_no_collector(monkeypatch):
    monkeypatch.setenv("GUBER_NATIVE_EVENTS", "0")
    d = _daemon()
    try:
        assert d.h2_fast._ring is None and d.instance.native_events is None
        assert d.h2_fast.ring_stats() == {"written": 0, "dropped": 0, "enabled": False}
        call = grpc.insecure_channel(d.h2_fast_address).unary_unary(PATH)
        call(_body("off", "k", n=3), timeout=30)
    finally:
        d.close()
