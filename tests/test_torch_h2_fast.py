"""The port's native h2 front (net/h2_fast.py, csrc/h2_server.cpp) on the
CPU, against the JAX package's front.

Ports the single-node cases of `tests/test_h2_fast.py` (a stock grpcio
client, multi-item RPCs through the native client, the declines of
non-columnar traffic, window isolation, send-side flow control, early
window credit, zero-item and oversized RPCs), `tests/test_h2_event_front.py`
(the reactor front by default, event-vs-threaded parity, partial and
coalesced frames, short-write back-pressure, idle reaping, teardown
under live load, the connscale client) and `tests/test_h2_client.py`
(the native client against a grpc-python server).  A seeded sequential
stream runs through the reference's front and through the port's (a CPU
engine), both with their columnar feeders off, both with them on and
their retry hints off, and both as by default (feeder and hints on), all
with frozen clocks: every response's grpc-status and message bytes, the
`retry_after_ms` metadata the feeder writes on OVER_LIMIT answers
included, and the state words at the end, must be equal.

Not here, with the ROADMAP A item that brings each: the sharded-engine
case (`test_fast_front_sharded_engine`, item 9), the cluster ownership
gate (`test_fast_front_ownership_gate`, item 11), and the event ring and
conns-gauge cases of test_h2_event_front.py (item 13).  The feeder's own
cases, and test_h2_event_front.py's feeder parity, are in
tests/test_torch_feeder.py.
"""

from __future__ import annotations

import json
import os
import signal
import socket
import struct
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

import grpc
import numpy as np
import pytest

from gubernator_tpu.clock import Clock as RefClock
from gubernator_tpu.config import Config as RefConfig
from gubernator_tpu.config import DaemonConfig as RefDaemonConfig
from gubernator_tpu.core.engine import DecisionEngine as RefEngine
from gubernator_tpu.daemon import spawn_daemon as ref_spawn_daemon
from gubernator_tpu.net.grpc_service import V1Stub, dial
from gubernator_tpu.net.h2_fast import H2FastFront as RefFront
from gubernator_tpu.net.pb import gubernator_pb2 as pb
from gubernator_tpu.service import V1Instance as RefInstance
from gubernator_tpu_torch.clock import Clock
from gubernator_tpu_torch.config import DaemonConfig, setup_daemon_config
from gubernator_tpu_torch.core import h2_client
from gubernator_tpu_torch.core.engine import DecisionEngine
from gubernator_tpu_torch.daemon import spawn_daemon
from gubernator_tpu_torch.net import h2_fast
from gubernator_tpu_torch.net.h2_fast import H2FastFront
from gubernator_tpu_torch.ops import bucket_kernel as tk
from gubernator_tpu_torch.ops import native_build
from gubernator_tpu_torch.service import V1Instance
from gubernator_tpu_torch.store import MemoryStore
from gubernator_tpu_torch.types import Behavior

PATH = "/pb.gubernator.V1/GetRateLimits"
T0_NS = 1_760_000_000_123 * 1_000_000
ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture
def daemon():
    conf = DaemonConfig(http_listen_address="127.0.0.1:0", cache_size=1 << 12,
                        sweep_interval=0.0, h2_fast_address="127.0.0.1:0", h2_fast_window=0.001)
    d = spawn_daemon(conf, device="cpu")
    yield d
    d.close()


def _req(name, key, hits=1, limit=100, n=1, **kw):
    return pb.GetRateLimitsReq(requests=[
        pb.RateLimitReq(name=name, unique_key=f"{key}{i}", hits=hits, limit=limit,
                        duration=60_000, **kw)
        for i in range(n)
    ])


def _raw_call(channel, body: bytes):
    """(grpc status code, response message bytes) of one unary call."""
    try:
        return 0, channel.unary_unary(PATH)(body, timeout=30)
    except grpc.RpcError as e:
        return e.code().value[0], b""


# -- tests/test_h2_fast.py ---------------------------------------------


def test_fast_front_serves_real_grpc_client(daemon):
    """A stock grpc-python client works against the front (it ignores
    request header blocks, it does not need a cooperative client), and
    the front shares its buckets with the daemon's other listener."""
    stub = V1Stub(dial(daemon.h2_fast_address))
    one = pb.RateLimitReq(name="f", unique_key="k", hits=1, limit=5, duration=60_000)
    for expect in (4, 3, 2):
        got = stub.GetRateLimits(pb.GetRateLimitsReq(requests=[one]))
        assert got.responses[0].remaining == expect
    body = json.dumps({"requests": [{"name": "f", "unique_key": "k", "hits": 1, "limit": 5,
                                     "duration": 60_000}]}).encode()
    with urllib.request.urlopen(urllib.request.Request(
            f"http://{daemon.http_address}/v1/GetRateLimits", data=body, method="POST"),
            timeout=30) as r:
        assert json.loads(r.read())["responses"][0]["remaining"] == "1"


def test_fast_front_multi_item_and_native_client(daemon):
    payload = _req("m", "k", n=7).SerializeToString()
    res = h2_client.bench_unary(daemon.h2_fast_address, PATH, payload, 0.4, 2)
    assert res is not None
    rpcs, errors, lats, frame, connected = res
    assert errors == 0 and rpcs > 0 and connected == 2 and len(lats) > 0
    (ln,) = struct.unpack(">I", frame[1:5])
    resp = pb.GetRateLimitsResp.FromString(frame[5 : 5 + ln])
    assert len(resp.responses) == 7
    assert all(0 <= r.remaining < 100 for r in resp.responses)


@pytest.mark.parametrize("case", ["global", "multi_region", "gregorian", "sketch", "empty_key",
                                  "empty_name"])
def test_fast_front_declines_non_columnar(daemon, case):
    """Items outside the front's scope answer UNIMPLEMENTED, never a
    wrong decision (they belong on the full listener)."""
    item = dict(name="g", unique_key="k", hits=1, limit=5, duration=60_000)
    item.update({
        "global": dict(behavior=int(Behavior.GLOBAL)),
        "multi_region": dict(behavior=int(Behavior.MULTI_REGION)),
        "gregorian": dict(behavior=int(Behavior.DURATION_IS_GREGORIAN), duration=1),
        "sketch": dict(behavior=int(Behavior.SKETCH)),
        "empty_key": dict(unique_key=""),
        "empty_name": dict(name=""),
    }[case])
    stub = V1Stub(dial(daemon.h2_fast_address))
    with pytest.raises(grpc.RpcError) as err:
        stub.GetRateLimits(pb.GetRateLimitsReq(requests=[
            pb.RateLimitReq(name="g", unique_key="ok", hits=1, limit=5, duration=60_000),
            pb.RateLimitReq(**item),
        ]))
    assert err.value.code() == grpc.StatusCode.UNIMPLEMENTED
    assert daemon.instance.engine.requests_total == 0  # nothing was applied


def test_fast_front_window_isolation(daemon):
    """One out-of-scope RPC in a window does not fail its window-mates
    (the per-RPC re-serve in H2FastFront._window)."""
    import ctypes

    front = daemon.h2_fast
    plain = _req("iso", "a", limit=9).SerializeToString()
    glob = _req("iso", "b", limit=9, behavior=int(Behavior.GLOBAL)).SerializeToString()
    concat = plain + glob
    buf = ctypes.create_string_buffer(concat, len(concat))
    counts = np.array([1, 1], dtype=np.int64)
    lens = np.array([len(plain), len(glob)], dtype=np.int64)
    cols = np.zeros(8, dtype=np.int64)
    status = np.zeros(2, dtype=np.int64)
    rc = front._window(ctypes.addressof(buf), len(concat), counts.ctypes.data, lens.ctypes.data,
                       2, 2, cols.ctypes.data, status.ctypes.data)
    assert rc == 0
    assert status.tolist() == [0, 12]  # plain served, GLOBAL declined
    assert cols[2 * 2 + 0] == 8  # remaining column, first lane


def _h2_frames(sock, deadline):
    """Yield (type, flags, stream, payload) until timeout or close."""
    buf = b""
    while True:
        while len(buf) < 9:
            sock.settimeout(max(0.05, deadline - time.monotonic()))
            try:
                chunk = sock.recv(65536)
            except (socket.timeout, TimeoutError):
                return
            if not chunk:
                return
            buf += chunk
        flen = (buf[0] << 16) | (buf[1] << 8) | buf[2]
        ftype, flags = buf[3], buf[4]
        stream = struct.unpack(">I", buf[5:9])[0] & 0x7FFFFFFF
        while len(buf) < 9 + flen:
            sock.settimeout(max(0.05, deadline - time.monotonic()))
            try:
                chunk = sock.recv(65536)
            except (socket.timeout, TimeoutError):
                return
            if not chunk:
                return
            buf += chunk
        yield ftype, flags, stream, buf[9 : 9 + flen]
        buf = buf[9 + flen :]


def _frame(ftype, flags, stream, payload=b""):
    return struct.pack(">I", len(payload))[1:] + bytes([ftype, flags]) + struct.pack(">I", stream) + payload


def _grpc_frame(body):
    return b"\x00" + struct.pack(">I", len(body)) + body


PREFACE = b"PRI * HTTP/2.0\r\n\r\nSM\r\n\r\n"


def _settings_window(v):
    return _frame(4, 0, 0, struct.pack(">H", 4) + struct.pack(">I", v))


def _read_responses(sock, want_streams, timeout=5.0):
    """{stream: DATA bytes} and the set of streams that finished."""
    out = {s: b"" for s in want_streams}
    done = set()
    for ftype, flags, stream, payload in _h2_frames(sock, time.monotonic() + timeout):
        if stream not in out:
            continue
        if ftype == 0:
            out[stream] += payload
        elif ftype == 1 and flags & 0x1:
            done.add(stream)
            if done == set(want_streams):
                break
    return out, done


def _decode(data):
    (ln,) = struct.unpack(">I", data[1:5])
    return pb.GetRateLimitsResp.FromString(data[5 : 5 + ln])


def test_fast_front_honors_send_flow_control(daemon):
    """RFC 9113 send-side flow control: with a tiny INITIAL_WINDOW_SIZE,
    response DATA stops at the window and resumes on WINDOW_UPDATE."""
    host, port = daemon.h2_fast_address.rsplit(":", 1)
    n_items = 120
    body = _req("fc", "k", limit=1000, n=n_items).SerializeToString()
    window = 32  # far below the response size
    sock = socket.create_connection((host, int(port)), timeout=5)
    try:
        sock.sendall(PREFACE + _settings_window(window) + _frame(1, 4, 1)
                     + _frame(0, 1, 1, _grpc_frame(body)))
        data = b""
        saw_headers = saw_trailers = False
        for ftype, flags, stream, payload in _h2_frames(sock, time.monotonic() + 3.0):
            if stream != 1:
                continue
            if ftype == 1:
                if not saw_headers:
                    saw_headers = True
                elif flags & 0x1:
                    saw_trailers = True
            elif ftype == 0:
                data += payload
        assert saw_headers
        assert len(data) <= window, f"{len(data)} DATA bytes into a {window}-byte window"
        assert not saw_trailers
        sock.sendall(_frame(8, 0, 1, struct.pack(">I", 1 << 20)))
        for ftype, flags, stream, payload in _h2_frames(sock, time.monotonic() + 5.0):
            if stream != 1:
                continue
            if ftype == 0:
                data += payload
            elif ftype == 1 and flags & 0x1:
                saw_trailers = True
                break
        assert saw_trailers
        resp = _decode(data)
        assert len(resp.responses) == n_items
        assert all(r.remaining == 999 for r in resp.responses)
    finally:
        sock.close()


def test_fast_front_banks_early_window_credit(daemon):
    """WINDOW_UPDATE that arrives before the response is queued is kept:
    with a zero initial window the response would otherwise stall."""
    host, port = daemon.h2_fast_address.rsplit(":", 1)
    body = _req("ec", "k", limit=10, n=40).SerializeToString()
    sock = socket.create_connection((host, int(port)), timeout=5)
    try:
        sock.sendall(PREFACE + _settings_window(0) + _frame(1, 4, 1)
                     + _frame(0, 1, 1, _grpc_frame(body))
                     + _frame(8, 0, 1, struct.pack(">I", 1 << 20)))  # credit at once
        out, done = _read_responses(sock, [1])
        assert done == {1}, "response stalled: early credit was dropped"
        assert len(_decode(out[1]).responses) == 40
    finally:
        sock.close()


def test_fast_front_zero_item_request(daemon):
    """A zero-item GetRateLimitsReq answers empty-OK, not INTERNAL (the
    C side passes a NULL out_ptr for an empty window)."""
    stub = V1Stub(dial(daemon.h2_fast_address))
    assert len(stub.GetRateLimits(pb.GetRateLimitsReq(), timeout=10).responses) == 0


def test_fast_front_oversized_rpc_not_starved(daemon):
    """An RPC with more items than max_batch is admitted and served, and
    later RPCs are not starved behind it."""
    front = H2FastFront(daemon.instance, window_s=0.001, max_batch=4, flush_items=4)
    try:
        stub = V1Stub(dial(front.address))
        got = stub.GetRateLimits(_req("big", "k", n=9), timeout=15)
        assert [r.remaining for r in got.responses] == [99] * 9
        got = stub.GetRateLimits(_req("big", "k"), timeout=15)
        assert got.responses[0].remaining == 98
    finally:
        front.close()


# -- the port's own cases --------------------------------------------


def test_store_attached_engine_declines():
    """A write-through store must not be bypassed: every RPC of such a
    daemon's front answers UNIMPLEMENTED (reference serve_decoded_local)."""
    conf = DaemonConfig(http_listen_address="127.0.0.1:0", cache_size=256, sweep_interval=0.0,
                        h2_fast_address="127.0.0.1:0", h2_fast_window=0.001)
    d = spawn_daemon(conf, device="cpu", store=MemoryStore())
    try:
        code, _ = _raw_call(grpc.insecure_channel(d.h2_fast_address),
                            _req("st", "k").SerializeToString())
        assert code == grpc.StatusCode.UNIMPLEMENTED.value[0]
        assert d.instance.engine.requests_total == 0
    finally:
        d.close()


def test_front_that_cannot_build_fails_the_daemon(monkeypatch):
    """No fallback: when the h2 library does not build, H2FastFront
    raises and the daemon does not start."""
    real = native_build.load

    def broken(name):
        if name == "h2_server":
            raise RuntimeError("build failed for h2_server.cpp + wire_codec.cpp")
        return real(name)

    monkeypatch.setattr(native_build, "load", broken)
    inst = V1Instance(DecisionEngine(64, device="cpu"))
    with pytest.raises(RuntimeError, match="build failed for h2_server"):
        H2FastFront(inst)
    inst.close()
    conf = DaemonConfig(http_listen_address="127.0.0.1:0", cache_size=64, sweep_interval=0.0,
                        h2_fast_address="127.0.0.1:0")
    with pytest.raises(RuntimeError, match="build failed for h2_server"):
        spawn_daemon(conf, device="cpu")


def test_h2_config_from_the_environment(monkeypatch):
    conf = setup_daemon_config({})
    assert (conf.h2_fast_address, conf.h2_fast_window, conf.h2_lanes) == ("", 0.002, 0)
    conf = setup_daemon_config({"GUBER_H2_FAST_ADDRESS": "127.0.0.1:0",
                                "GUBER_H2_FAST_WINDOW": "5ms", "GUBER_H2_LANES": "3"})
    assert (conf.h2_fast_address, conf.h2_fast_window, conf.h2_lanes) == ("127.0.0.1:0", 0.005, 3)
    monkeypatch.setenv("GUBER_H2_LANES", "0")
    assert h2_fast.default_lanes() == max(1, os.cpu_count() or 1)
    monkeypatch.setenv("GUBER_H2_IDLE_TIMEOUT", "1m")
    assert h2_fast.idle_timeout_ms() == 60_000
    monkeypatch.setenv("GUBER_H2_EVENT_FRONT", "off")
    assert not h2_fast.event_front_enabled()


def test_daemon_binary_serves_the_h2_front():
    env = dict(os.environ, GUBER_HTTP_ADDRESS="127.0.0.1:0", GUBER_CACHE_SIZE="256",
               GUBER_H2_FAST_ADDRESS="127.0.0.1:0")
    proc = subprocess.Popen(
        [sys.executable, "-m", "gubernator_tpu_torch.cmd.daemon", "--device", "cpu"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )
    try:
        line = proc.stdout.readline().strip()
        assert line.startswith("listening http=") and " h2=" in line, (line, proc.stderr.read())
        addr = line.split(" h2=", 1)[1]
        got = V1Stub(dial(addr)).GetRateLimits(_req("bin", "k", limit=3), timeout=30)
        assert got.responses[0].remaining == 2
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
        proc.stdout.close()
        proc.stderr.close()


# -- parity with the reference's front ---------------------------------


def _stream_rpcs(seed: int, n_plain: int = 14, items: int = 90):
    """Seeded GetRateLimitsReq bodies: plain RPCs over a 700-key pool (8 %
    on 12 hot keys with a config each, token and leaky mixed,
    RESET_REMAINING on 3 %), with out-of-scope RPCs and a zero-item one
    among them.  Returns [(body, clock step in ms before it)]."""
    rng = np.random.default_rng(seed)
    hot_cfg = [(i % 2, int(rng.choice([5, 10, 100])), int(rng.choice([1000, 60_000])))
               for i in range(12)]
    out = []

    def plain(n):
        reqs = []
        for _ in range(n):
            if rng.random() < 0.08:
                h = int(rng.integers(12))
                algo, limit, dur = hot_cfg[h]
                reqs.append(pb.RateLimitReq(name="api", unique_key=f"hot{h}", hits=1, limit=limit,
                                            duration=dur, algorithm=algo))
            else:
                reqs.append(pb.RateLimitReq(
                    name=str(rng.choice(["api", "a_b"])),
                    unique_key=f"u{int(rng.integers(700))}",
                    hits=int(rng.choice([0, 1, 1, 2, 5, -1])),
                    limit=int(rng.choice([3, 10, 100, 10**6])),
                    duration=int(rng.choice([1000, 60_000, 3_600_000])),
                    algorithm=int(rng.integers(2)),
                    behavior=8 if rng.random() < 0.03 else 0,
                    burst=int(rng.choice([0, 0, 20]))))
        return reqs

    specials = {
        2: dict(behavior=int(Behavior.GLOBAL)),
        4: dict(behavior=int(Behavior.DURATION_IS_GREGORIAN), duration=1),
        6: dict(behavior=int(Behavior.SKETCH)),
        8: dict(unique_key=""),
        10: dict(behavior=int(Behavior.MULTI_REGION)),
    }
    for i in range(n_plain):
        reqs = plain(items)
        if i in specials:
            j = int(rng.integers(items))
            bad = pb.RateLimitReq()
            bad.CopyFrom(reqs[j])
            for k, v in specials[i].items():
                setattr(bad, k, v)
            reqs[j] = bad
        out.append((pb.GetRateLimitsReq(requests=reqs).SerializeToString(),
                    int(rng.choice([0, 0, 250, 1000, 61_000]))))
        if i == 5:
            out.append((b"", 0))  # a zero-item RPC
    return out


def _ref_words_by_key(eng):
    eng._flush_pump()
    words = {f: np.asarray(getattr(eng._state, f)) for f in eng._state._fields}
    out = {}
    for s in range(eng.capacity):
        k = eng.table.key_for_slot(s)
        if k is not None:
            out[k] = tuple(int(words[f][s]) for f in eng._state._fields)
    return out


def _port_words_by_key(eng):
    words = tk.state_to_numpy(eng.state)
    out = {}
    for s in range(eng.capacity):
        k = eng.table.key_for_slot(s)
        if k is not None:
            out[k] = tuple(int(words[f][s]) for f in tk.BucketState._fields)
    return out


def settled_stats(front, n_rpcs: int, timeout: float = 10.0) -> dict:
    """A front's stats once it has counted `n_rpcs` answered RPCs: the C
    side bumps its counters after the response is sent, so a client can
    read its answer before the counter moves."""
    deadline = time.monotonic() + timeout
    st = front.stats()
    while st["rpcs"] + st["errors"] < n_rpcs and time.monotonic() < deadline:
        time.sleep(0.005)
        st = front.stats()
    return st


def _retry_hints(msg: bytes) -> int:
    """The number of items of a response that carry a retry_after_ms
    hint; the hint may sit on OVER_LIMIT items only, and every OVER_LIMIT
    item of a hinted response carries one."""
    resp = pb.GetRateLimitsResp.FromString(msg)
    hinted = [bool(r.metadata) for r in resp.responses]
    for r in resp.responses:
        if r.metadata:
            assert set(r.metadata) == {"retry_after_ms"} and r.status == pb.OVER_LIMIT
            assert int(r.metadata["retry_after_ms"]) == max(0, r.reset_time - T0_NS // 10**6
                                                           - _elapsed_ms[0])
    if any(hinted):
        assert all(h for h, r in zip(hinted, resp.responses) if r.status == pb.OVER_LIMIT)
    return sum(hinted)


_elapsed_ms = [0]  # the frozen clocks' advance since T0, for _retry_hints


# The ledger's knobs when it is on, in each side's spelling: a hot
# threshold of 2 so the stream's hot keys take leases, and no settle thread
# (settles run by hand at the end), as in tests/test_torch_ledger.py.
_REF_LEDGER_ON = dict(ledger=True, ledger_hot_threshold=2, ledger_settle_interval=0)
_PORT_LEDGER_ON = dict(ledger=True, ledger_opts=dict(hot_threshold=2, settle_interval=0))


@pytest.mark.parametrize("mode", ["feeder_off", "feeder_on_no_hints", "feeder_on",
                                  "ledger-feeder_off", "ledger-feeder_on_no_hints",
                                  "ledger-feeder_on"])
def test_stream_equals_the_reference_front(mode, monkeypatch):
    """The same seeded sequential stream through the reference's front
    and the port's (CPU engine), frozen clocks stepped alike:
    grpc-status and response bytes equal RPC by RPC, out-of-scope RPCs
    UNIMPLEMENTED, the zero-item RPC empty OK, and every live key's state
    words equal at the end.  512 slots under a 700-key pool, so evictions
    run too.

    Both fronts take the same ingest path: the byte window path
    (`native_feeder=False`), or the columnar feeder, their default.  The
    feeder's encode also writes a retry_after_ms metadata hint on
    OVER_LIMIT answers (GUBER_RETRY_HINTS, default on), which the byte
    window path never writes: with the feeder on and hints on, the port's
    bytes must carry the same hints as the reference's, so some
    responses must carry one.  The fronts' counters of byte windows and
    of feeder RPCs must be equal too.

    Both sides run with the decision ledger off, or (the `ledger-` modes)
    both with it on: answers are the same either way, but state words
    equal the reference's only when both ledgers hold the same leases.
    With it on, both ledgers' settles are flushed before the words are
    compared, and their counters must be equal and show leases granted
    and revoked.  A frozen clock attaches no decision plane on
    either side."""
    ledger = mode.startswith("ledger-")
    mode = mode.removeprefix("ledger-")
    feeder = mode != "feeder_off"
    if mode == "feeder_on_no_hints":
        monkeypatch.setenv("GUBER_RETRY_HINTS", "0")
    ref_engine = RefEngine(capacity=512, clock=RefClock().freeze_at(T0_NS))
    ref = RefInstance(RefConfig(**_REF_LEDGER_ON) if ledger else RefConfig(ledger=False),
                      ref_engine)
    ref_front = RefFront(ref, window_s=0.001, native_feeder=feeder)
    port = V1Instance(DecisionEngine(512, clock=Clock().freeze_at(T0_NS), device="cpu"),
                      **(_PORT_LEDGER_ON if ledger else dict(ledger=False)))
    front = H2FastFront(port, window_s=0.001, native_feeder=feeder)
    _elapsed_ms[0] = 0
    try:
        ref_ch = grpc.insecure_channel(ref_front.address)
        port_ch = grpc.insecure_channel(front.address)
        codes = []
        hinted = 0
        for i, (body, step) in enumerate(_stream_rpcs(seed=7)):
            ref_engine.clock.advance(ms=step)
            port.engine.clock.advance(ms=step)
            _elapsed_ms[0] += step
            want = _raw_call(ref_ch, body)
            got = _raw_call(port_ch, body)
            assert got == want, i
            if got[1]:
                hinted += _retry_hints(got[1]) > 0
            codes.append(got[0])
            if not body:
                assert got == (0, b"")
        assert codes.count(12) == 5 and codes.count(0) == len(codes) - 5
        st, ref_st = (settled_stats(f, len(codes)) for f in (front, ref_front))
        assert (st["feeder_front_rpcs"] > 0) == feeder
        for k in ("rpcs", "windows", "errors", "feeder_front_rpcs", "feeder_front_items"):
            assert st[k] == ref_st[k], k
        assert (front.feeder is not None) == feeder
        assert (hinted > 0) == (mode == "feeder_on")
        assert st["errors"] == 5
        assert ref_front.plane is None and front.plane is None
        assert (port.ledger is not None) == ledger == (ref.ledger is not None)
        if ledger:
            assert port.ledger.flush_settles() == ref.ledger.flush_settles()
            stats, ref_stats = port.ledger.stats(), ref.ledger.stats()
            stats.pop("settle_lag_ms_mean")
            ref_stats.pop("settle_lag_ms_mean")
            # The reference's read-only tier (the GLOBAL broadcast cache)
            # is filled only by peers.
            assert ref_stats.pop("readonly_entries") == 0
            assert stats == ref_stats
            assert stats["leases_granted"] > 0 and stats["leases_revoked"] > 0
        assert _port_words_by_key(port.engine) == _ref_words_by_key(ref_engine)
        assert port.engine.table.evictions > 0
    finally:
        front.close()
        ref_front.close()
        ref.close()
        port.close()


# -- tests/test_h2_event_front.py --------------------------------------


def test_event_front_is_default_and_serves(daemon):
    cs = daemon.h2_fast.conn_stats()
    assert cs["event_front"] is True
    assert cs["reactors"] >= 1
    stub = V1Stub(dial(daemon.h2_fast_address))
    for expect in (99, 98, 97):
        assert stub.GetRateLimits(_req("ev", "k")).responses[0].remaining == expect


def test_event_vs_threaded_parity(daemon):
    """Both connection planes share one frame machine and one serve
    pipeline: RPCs alternating across an event front and a threaded front
    on one instance hit the same buckets."""
    threaded = H2FastFront(daemon.instance, window_s=0.001, event_front=False)
    try:
        assert threaded.conn_stats()["event_front"] is False
        ev = V1Stub(dial(daemon.h2_fast_address))
        th = V1Stub(dial(threaded.address))
        remaining = [(ev if i % 2 == 0 else th).GetRateLimits(_req("par", "x")).responses[0].remaining
                     for i in range(6)]
        assert remaining == [99, 98, 97, 96, 95, 94]
    finally:
        threaded.close()


def test_partial_frame_delivery(daemon):
    """Edge-triggered reads reassemble a request sent five bytes at a
    time (preface, frame headers and DATA all split)."""
    host, port = daemon.h2_fast_address.rsplit(":", 1)
    body = _req("part", "k", n=3).SerializeToString()
    wire = PREFACE + _frame(1, 0x4, 1) + _frame(0, 0x1, 1, _grpc_frame(body))
    sock = socket.create_connection((host, int(port)), timeout=5)
    try:
        for i in range(0, len(wire), 5):
            sock.sendall(wire[i : i + 5])
            time.sleep(0.002)
        out, done = _read_responses(sock, [1])
        assert done == {1}
        assert [r.remaining for r in _decode(out[1]).responses] == [99] * 3
    finally:
        sock.close()


def test_coalesced_frames_one_read(daemon):
    """Three complete RPCs in one send all answer."""
    host, port = daemon.h2_fast_address.rsplit(":", 1)
    wire = PREFACE
    for sid in (1, 3, 5):
        body = _req("coal", f"s{sid}_").SerializeToString()
        wire += _frame(1, 0x4, sid) + _frame(0, 0x1, sid, _grpc_frame(body))
    sock = socket.create_connection((host, int(port)), timeout=5)
    try:
        sock.sendall(wire)
        out, done = _read_responses(sock, [1, 3, 5])
        assert done == {1, 3, 5}
        for sid in (1, 3, 5):
            assert _decode(out[sid]).responses[0].remaining == 99
    finally:
        sock.close()


def test_writev_short_write_resumption_backpressure(daemon):
    """A client that stops reading parks its response in the egress
    queue without blocking a reactor (a second client stays served), and
    the response completes once it reads again."""
    host, port = daemon.h2_fast_address.rsplit(":", 1)
    n_items = 900
    body = _req("bp", "k", n=n_items).SerializeToString()
    slow = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    slow.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 2048)
    slow.connect((host, int(port)))
    try:
        slow.sendall(PREFACE + _frame(1, 0x4, 1) + _frame(0, 0x1, 1, _grpc_frame(body)))
        time.sleep(0.3)
        fast = V1Stub(dial(daemon.h2_fast_address))
        for expect in (99, 98, 97):
            assert fast.GetRateLimits(_req("bp_fast", "k"), timeout=5).responses[0].remaining == expect
        out, done = _read_responses(slow, [1], timeout=8.0)
        assert done == {1}, "parked response never resumed"
        resp = _decode(out[1])
        assert len(resp.responses) == n_items
        assert all(r.remaining == 99 for r in resp.responses)
    finally:
        slow.close()


def test_idle_connection_reaped(daemon):
    """A connection silent past the idle timeout gets GOAWAY and close."""
    front = H2FastFront(daemon.instance, window_s=0.001, idle_timeout_s=0.3)
    try:
        sock = socket.create_connection(("127.0.0.1", front.port), timeout=5)
        sock.sendall(PREFACE)
        types = [t for t, _f, _s, _p in _h2_frames(sock, time.monotonic() + 3.0)]
        sock.close()
        assert 7 in types, f"no GOAWAY before close (saw {types})"
        cs = front.conn_stats()
        assert cs["conns_idle_reaped"] >= 1
        assert cs["conns_open"] == 0
    finally:
        front.close()


def test_active_connection_not_reaped(daemon):
    """The idle sweep keys on activity, not on connection age."""
    front = H2FastFront(daemon.instance, window_s=0.001, idle_timeout_s=0.4)
    try:
        stub = V1Stub(dial(front.address))
        deadline = time.monotonic() + 1.2
        n = 0
        while time.monotonic() < deadline:
            assert not stub.GetRateLimits(_req("alive", "k", limit=10**6)).responses[0].error
            n += 1
            time.sleep(0.1)
        assert front.conn_stats()["conns_idle_reaped"] == 0
        assert n >= 8
    finally:
        front.close()


def test_teardown_under_live_load(daemon):
    """close() with RPCs in flight drains cleanly (no hang, no crash: the
    stop joins the dispatch thread before the handle is freed), and the
    shared engine keeps serving through another front."""
    front = H2FastFront(daemon.instance, window_s=0.001)
    payload = _req("tear", "k", limit=10**9).SerializeToString()

    def load():
        h2_client.bench_unary(front.address, PATH, payload, 1.5, 4)

    t = threading.Thread(target=load)
    t.start()
    time.sleep(0.4)
    front.close()
    assert front.stats()["rpcs"] == 0  # a closed front reads zeros
    t.join(timeout=20)
    assert not t.is_alive(), "client hung through server teardown"
    front2 = H2FastFront(daemon.instance, window_s=0.001)
    try:
        got = V1Stub(dial(front2.address)).GetRateLimits(_req("tear2", "k"))
        assert got.responses[0].remaining == 99
    finally:
        front2.close()


def test_connscale_client_against_event_front(daemon):
    """The epoll connscale client holds 200 mostly idle connections and a
    closed loop on 8 of them with no errors."""
    payload = _req("cs", "hot", limit=10**12).SerializeToString()
    res = [None]

    def run():
        res[0] = h2_client.connscale(daemon.h2_fast_address, PATH, payload, 1.5, 200, 8, threads=1)

    t = threading.Thread(target=run)
    t.start()
    peak = 0
    deadline = time.monotonic() + 10.0
    while time.monotonic() < deadline and peak < 200:
        peak = max(peak, daemon.h2_fast.conn_stats()["conns_open"])
        time.sleep(0.05)
    t.join(timeout=30)
    assert not t.is_alive()
    assert peak >= 200
    out = res[0]
    assert out is not None
    assert out["connected"] == 200 and out["alive_at_end"] == 200
    assert out["errors"] == 0 and out["rpcs"] > 0


# -- tests/test_h2_client.py -------------------------------------------


def test_h2_client_round_trip_against_grpc_python():
    """The port's native client against a real grpc-python server (the
    reference daemon's gRPC listener): its responses decode as valid
    GetRateLimitsResp messages with the engine's real answer."""
    conf = RefDaemonConfig(grpc_listen_address="127.0.0.1:0", http_listen_address="127.0.0.1:0",
                           cache_size=1 << 12, peer_discovery_type="none", device_count=1,
                           sweep_interval=0.0)
    d = ref_spawn_daemon(conf)
    try:
        payload = pb.GetRateLimitsReq(requests=[pb.RateLimitReq(
            name="h2", unique_key="k", hits=1, limit=100, duration=60_000)]).SerializeToString()
        res = h2_client.bench_unary(d.grpc_address, PATH, payload, 0.5, 2)
        assert res is not None, "native client could not connect"
        rpcs, errors, lats, frame, connected = res
        assert rpcs > 0 and errors == 0 and connected == 2 and len(lats) > 0
        assert frame and frame[0] == 0
        resp = _decode(frame)
        assert len(resp.responses) == 1
        assert resp.responses[0].limit == 100
        assert 0 <= resp.responses[0].remaining < 100
    finally:
        d.close()
