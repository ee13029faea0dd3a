"""The port's gRPC listener (net/grpc_listener.py over csrc/h2_server.cpp's
routing mode) and its unary client (core/h2_client.py UnaryChannel over
csrc/h2_unary.cpp), against grpcio and the JAX package.

- grpcio's `V1Stub` and `PeersV1Stub` call the port's listener; the port's
  client calls a JAX daemon's grpcio server; both answer one request list
  as the JAX package's `V1Instance` does (the columnar route and the full
  decode: Gregorian items, validation errors, NO_BATCHING).
- Every path but the three routes gets UNIMPLEMENTED, the PeersV1 methods
  of ROADMAP A entry 4 included, with the path in the message.
- A passed deadline is DEADLINE_EXCEEDED on both clients, and the port's
  connection stays usable after the cancel.
- A body that is not protobuf gets INTERNAL "Exception deserializing
  request!", a batch of 1001 items OUT_OF_RANGE, as from grpcio's server.
- After a GOAWAY (grpcio's max connection age) the port's client dials
  again and the next call succeeds.
- Many threads share one connection: every answer is right, one dial.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import ThreadPoolExecutor

import grpc
import pytest

import gubernator_tpu.daemon as ref_daemon_mod
from gubernator_tpu.clock import Clock as RefClock
from gubernator_tpu.config import Config as RefConfig
from gubernator_tpu.config import DaemonConfig as RefDaemonConfig
from gubernator_tpu.core.engine import DecisionEngine as RefEngine
from gubernator_tpu.net import serde
from gubernator_tpu.net.grpc_service import PeersV1Stub, V1Stub
from gubernator_tpu.net.pb import gubernator_pb2 as pb
from gubernator_tpu.net.pb import peers_pb2 as peers_pb
from gubernator_tpu.service import V1Instance as RefInstance
from gubernator_tpu_torch.clock import Clock
from gubernator_tpu_torch.core.engine import DecisionEngine
from gubernator_tpu_torch.core.h2_client import StatusCode, UnaryChannel
from gubernator_tpu_torch.net import proto_codec
from gubernator_tpu_torch.net.grpc_listener import GrpcListener
from gubernator_tpu_torch.service import V1Instance

T0_NS = 1_700_000_000_000_000_000
GREG = 4

ENTRY_4 = ["/pb.gubernator.PeersV1/UpdatePeerGlobals", "/pb.gubernator.PeersV1/TransferBuckets",
           "/pb.gubernator.PeersV1/ReplicateKeys", "/pb.gubernator.PeersV1/ObsSnapshot",
           "/pb.gubernator.V1/Nothing", "/grpc.health.v1.Health/Check", "/"]


def _items(tag: str, n: int = 24):
    """Plain items (the columnar route), then a Gregorian one, an
    invalid interval, empty fields and NO_BATCHING (the full decode)."""
    out = [pb.RateLimitReq(name="gl", unique_key=f"{tag}{i % 9}", hits=i % 3, limit=5 + i % 4,
                           duration=60_000, algorithm=i % 2) for i in range(n)]
    out += [pb.RateLimitReq(name="gl", unique_key=f"{tag}g", hits=1, limit=5, duration=2,
                            behavior=GREG),
            pb.RateLimitReq(name="gl", unique_key=f"{tag}b", hits=1, limit=5, duration=9,
                            behavior=GREG),
            pb.RateLimitReq(name="", unique_key=f"{tag}e", hits=1, limit=5),
            pb.RateLimitReq(name="gl", unique_key="", hits=1, limit=5),
            pb.RateLimitReq(name="gl", unique_key=f"{tag}n", hits=2, limit=5, duration=1000,
                            behavior=1)]
    return out


def _ref_instance():
    return RefInstance(RefConfig(cache_size=1 << 12, ledger=False),
                       RefEngine(1 << 12, clock=RefClock().freeze_at(T0_NS)))


@pytest.fixture(scope="module")
def listener():
    inst = V1Instance(DecisionEngine(1 << 12, clock=Clock().freeze_at(T0_NS), device="cpu"),
                      ledger=False)
    lis = GrpcListener(inst, "127.0.0.1:0", workers=4)
    try:
        yield lis
    finally:
        lis.close()
        inst.close()


@pytest.fixture(scope="module")
def ref_daemon():
    """A JAX daemon (grpcio server) on a frozen clock; its warmup, a
    compile-ahead that changes no answer, is skipped."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref_daemon_mod.Daemon, "_warmup", lambda self, engine: None)
        conf = RefDaemonConfig(grpc_listen_address="127.0.0.1:0",
                               http_listen_address="127.0.0.1:0", cache_size=1 << 12,
                               peer_discovery_type="none", device_count=1, ledger=False,
                               sweep_interval=0.0, grpc_max_conn_age_sec=1)
        d = ref_daemon_mod.spawn_daemon(conf, clock=RefClock().freeze_at(T0_NS))
    try:
        yield d
    finally:
        d.close()


def _ref_answers(ref, reqs, peer=False):
    native = [serde.rate_limit_req_from_pb(r) for r in reqs]
    out = ref.get_peer_rate_limits(native) if peer else ref.get_rate_limits(native)
    return [serde.rate_limit_resp_to_pb(r).SerializeToString() for r in out]


def test_grpcio_stubs_on_the_port_listener_answer_as_the_reference(listener):
    ref = _ref_instance()
    channel = grpc.insecure_channel(listener.address)
    try:
        v1, peers = V1Stub(channel), PeersV1Stub(channel)
        for n in range(4):
            reqs = _items(f"s{n % 2}")
            got = v1.GetRateLimits(pb.GetRateLimitsReq(requests=reqs), timeout=10)
            assert [r.SerializeToString() for r in got.responses] == _ref_answers(ref, reqs)
            got = peers.GetPeerRateLimits(peers_pb.GetPeerRateLimitsReq(requests=reqs[:20]),
                                          timeout=10)
            assert [r.SerializeToString() for r in got.rate_limits] == _ref_answers(
                ref, reqs[:20], peer=True)
        hc = v1.HealthCheck(pb.HealthCheckReq(), timeout=10)
        assert (hc.status, hc.message, hc.peer_count) == ("healthy", "", 0)
    finally:
        channel.close()
        ref.close()


def test_port_client_on_a_reference_daemon_answers_as_the_reference(ref_daemon):
    ref = _ref_instance()
    ch = UnaryChannel(ref_daemon.grpc_address)
    try:
        for n in range(3):
            reqs = _items(f"r{n % 2}")
            code, msg, body = ch.call(proto_codec.GET_RATE_LIMITS,
                                      pb.GetRateLimitsReq(requests=reqs).SerializeToString(), 30)
            assert (code, msg) == (StatusCode.OK, "")
            got = pb.GetRateLimitsResp.FromString(body).responses
            assert [r.SerializeToString() for r in got] == _ref_answers(ref, reqs)
        code, msg, body = ch.call(proto_codec.HEALTH_CHECK, b"", 30)
        assert code == StatusCode.OK
        assert proto_codec.decode_health_check_resp(body).status == "healthy"
        code, msg, _ = ch.call("/pb.gubernator.V1/Nothing", b"", 30)
        assert code == StatusCode.UNIMPLEMENTED
        big = proto_codec.encode_get_rate_limits_req(
            [proto_codec.decode_rate_limit_req(r.SerializeToString())
             for r in _items("big", 1001)[:1001]])
        code, msg, _ = ch.call(proto_codec.GET_RATE_LIMITS, big, 30)
        assert code == StatusCode.OUT_OF_RANGE and "list too large" in msg
    finally:
        ch.close()
        ref.close()


@pytest.mark.parametrize("path", ENTRY_4)
def test_other_paths_are_unimplemented(listener, path):
    channel = grpc.insecure_channel(listener.address)
    try:
        call = channel.unary_unary(path, request_serializer=lambda b: b,
                                   response_deserializer=lambda b: b)
        with pytest.raises(grpc.RpcError) as e:
            call(b"", timeout=10)
        assert e.value.code() == grpc.StatusCode.UNIMPLEMENTED
        assert path in e.value.details()
    finally:
        channel.close()
    ch = UnaryChannel(listener.address)
    try:
        code, msg, _ = ch.call(path, b"", 10)
        assert code == StatusCode.UNIMPLEMENTED and path in msg
    finally:
        ch.close()


def test_bad_body_is_internal_and_oversized_batch_out_of_range(listener, ref_daemon):
    body = b"\x0a\xff\xff\xff"  # field 1, a length past the end
    for address in (listener.address, ref_daemon.grpc_address):
        channel = grpc.insecure_channel(address)
        try:
            call = channel.unary_unary(proto_codec.GET_RATE_LIMITS,
                                       request_serializer=lambda b: b,
                                       response_deserializer=lambda b: b)
            with pytest.raises(grpc.RpcError) as e:
                call(body, timeout=30)
            assert e.value.code() == grpc.StatusCode.INTERNAL
            assert e.value.details() == "Exception deserializing request!"
            big = pb.GetRateLimitsReq(requests=[pb.RateLimitReq(
                name="big", unique_key=str(i), hits=1, limit=10, duration=60_000)
                for i in range(1001)])
            with pytest.raises(grpc.RpcError) as e:
                V1Stub(channel).GetRateLimits(big, timeout=30)
            assert e.value.code() == grpc.StatusCode.OUT_OF_RANGE
            assert e.value.details() == (
                "Requests.RateLimits list too large; max size is '1000'")
        finally:
            channel.close()


def test_deadlines_expire_and_the_connection_stays_usable():
    inst = V1Instance(DecisionEngine(1 << 10, clock=Clock().freeze_at(T0_NS), device="cpu"),
                      ledger=False)
    release = threading.Event()
    real = inst.get_rate_limits

    def slow(reqs):
        release.wait(5)
        return real(reqs)

    inst.get_rate_limits = slow
    lis = GrpcListener(inst, "127.0.0.1:0", workers=2)
    greg = [pb.RateLimitReq(name="d", unique_key="k", hits=1, limit=5, duration=2,
                            behavior=GREG)]
    body = pb.GetRateLimitsReq(requests=greg).SerializeToString()
    ch = UnaryChannel(lis.address)
    channel = grpc.insecure_channel(lis.address)
    try:
        t0 = time.monotonic()
        code, msg, _ = ch.call(proto_codec.GET_RATE_LIMITS, body, 0.2)
        assert code == StatusCode.DEADLINE_EXCEEDED and time.monotonic() - t0 < 2
        with pytest.raises(grpc.RpcError) as e:
            V1Stub(channel).GetRateLimits(pb.GetRateLimitsReq(requests=greg), timeout=0.2)
        assert e.value.code() == grpc.StatusCode.DEADLINE_EXCEEDED
        release.set()
        # The late replies go to cancelled streams; the connection lives on.
        # (Another key: an RPC whose deadline passed while it queued for a
        # handler thread is answered without one, so how many of the two
        # hits above landed depends on the host's load.)
        other = pb.GetRateLimitsReq(requests=[pb.RateLimitReq(
            name="d", unique_key="k2", hits=1, limit=5, duration=2, behavior=GREG)])
        code, _, body_out = ch.call(proto_codec.GET_RATE_LIMITS, other.SerializeToString(), 10)
        assert code == StatusCode.OK
        assert pb.GetRateLimitsResp.FromString(body_out).responses[0].remaining == 4
        assert ch.stats()["dials"] == 1
    finally:
        release.set()
        channel.close()
        ch.close()
        lis.close()
        inst.close()


def test_goaway_is_followed_by_a_redial(ref_daemon):
    """grpcio's server sends GOAWAY at its max connection age (1 s here):
    the port's client dials again, and the next call succeeds."""
    body = proto_codec.encode_get_rate_limits_req(
        [proto_codec.decode_rate_limit_req(_items("ga")[0].SerializeToString())])
    ch = UnaryChannel(ref_daemon.grpc_address)
    try:
        assert ch.call(proto_codec.GET_RATE_LIMITS, body, 30)[0] == StatusCode.OK
        time.sleep(2.5)
        assert ch.call(proto_codec.GET_RATE_LIMITS, body, 30)[0] == StatusCode.OK
        assert ch.stats()["dials"] == 2
    finally:
        ch.close()


def test_many_threads_share_one_connection(listener):
    ref = _ref_instance()
    ch = UnaryChannel(listener.address)
    lock = threading.Lock()
    try:
        def one(i):
            reqs = [pb.RateLimitReq(name="mt", unique_key=f"{i}_t", hits=1, limit=100,
                                    duration=60_000)] * 3
            code, _, body = ch.call(proto_codec.GET_RATE_LIMITS,
                                    pb.GetRateLimitsReq(requests=reqs).SerializeToString(), 30)
            assert code == StatusCode.OK
            got = [r.SerializeToString() for r in pb.GetRateLimitsResp.FromString(body).responses]
            with lock:  # the reference instance answers one key's calls in order
                assert got == _ref_answers(ref, reqs)

        with ThreadPoolExecutor(16) as pool:
            list(pool.map(one, range(64)))
        assert ch.stats() == {"dials": 1, "calls": 64, "live": 1}
    finally:
        ch.close()
        ref.close()
