"""The port's hand-written protobuf codec (net/proto_codec.py) against
protobuf's generated classes of the JAX package (net/pb).

Hypothesis makes messages of every type the listener and the peer client
carry: RateLimitReq, RateLimitResp (error and metadata included), the
GetRateLimits and GetPeerRateLimits request and response lists, and
HealthCheckResp.  Each goes both ways: the port's bytes parse in
protobuf to the same message and equal protobuf's deterministic
serialization byte for byte (where a map has at most one entry: the
order of map entries is implementation-defined), and protobuf's bytes decode in the port to
the same fields.  A truncated message fails in both parsers or in
neither; bytes both parse are read alike; unknown fields of every wire
type are skipped.
"""

from __future__ import annotations

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from gubernator_tpu.net.pb import gubernator_pb2 as pb
from gubernator_tpu.net.pb import peers_pb2 as peers_pb
from gubernator_tpu_torch.net import proto_codec as pc
from gubernator_tpu_torch.types import HealthCheckResp, RateLimitReq, RateLimitResp

I64 = st.integers(-(1 << 63), (1 << 63) - 1)
I32 = st.integers(-(1 << 31), (1 << 31) - 1)
TEXT = st.text(max_size=30)

REQS = st.builds(RateLimitReq, name=TEXT, unique_key=TEXT, hits=I64, limit=I64, duration=I64,
                 algorithm=I32, behavior=I32, burst=I64)
RESPS = st.builds(RateLimitResp, status=I32, limit=I64, remaining=I64, reset_time=I64,
                  error=TEXT, metadata=st.dictionaries(TEXT, TEXT, max_size=4))
HEALTH = st.builds(HealthCheckResp, status=TEXT, message=TEXT, peer_count=I32)

REQ_FIELDS = ("name", "unique_key", "hits", "limit", "duration", "algorithm", "behavior",
              "burst")
RESP_FIELDS = ("status", "limit", "remaining", "reset_time", "error")


def _req_pb(r: RateLimitReq) -> pb.RateLimitReq:
    return pb.RateLimitReq(**{f: getattr(r, f) for f in REQ_FIELDS})


def _resp_pb(r: RateLimitResp) -> pb.RateLimitResp:
    return pb.RateLimitResp(metadata=r.metadata, **{f: getattr(r, f) for f in RESP_FIELDS})


def _req_fields(m) -> tuple:
    return tuple(int(getattr(m, f)) if f not in ("name", "unique_key") else getattr(m, f)
                 for f in REQ_FIELDS)


def _resp_fields(m) -> tuple:
    return tuple(int(getattr(m, f)) if f != "error" else m.error
                 for f in RESP_FIELDS) + (dict(m.metadata),)


def _det(m) -> bytes:
    return m.SerializeToString(deterministic=True)


@given(st.lists(REQS, max_size=8))
@settings(max_examples=60, deadline=None, derandomize=True)
def test_requests_both_ways(reqs):
    for cls, enc, dec in ((pb.GetRateLimitsReq, pc.encode_get_rate_limits_req,
                           pc.decode_get_rate_limits_req),
                          (peers_pb.GetPeerRateLimitsReq, pc.encode_get_peer_rate_limits_req,
                           pc.decode_get_peer_rate_limits_req)):
        msg = cls(requests=[_req_pb(r) for r in reqs])
        mine = enc(reqs)
        assert mine == _det(msg)
        assert cls.FromString(mine) == msg
        assert [_req_fields(r) for r in dec(_det(msg))] == [_req_fields(r) for r in reqs]
    for r in reqs:
        assert pc.encode_rate_limit_req(r) == _det(_req_pb(r))
        assert _req_fields(pc.decode_rate_limit_req(_det(_req_pb(r)))) == _req_fields(r)


@given(st.lists(RESPS, max_size=8))
@settings(max_examples=60, deadline=None, derandomize=True)
def test_responses_both_ways(resps):
    for cls, field, enc, dec in (
            (pb.GetRateLimitsResp, "responses", pc.encode_get_rate_limits_resp,
             pc.decode_get_rate_limits_resp),
            (peers_pb.GetPeerRateLimitsResp, "rate_limits", pc.encode_get_peer_rate_limits_resp,
             pc.decode_get_peer_rate_limits_resp)):
        msg = cls(**{field: [_resp_pb(r) for r in resps]})
        mine = enc(resps)
        if all(len(r.metadata) <= 1 for r in resps):
            # The order of a map's entries is the implementation's own,
            # even in protobuf's deterministic mode (upb's differs from
            # C++'s), so bytes compare only where there is one order.
            assert mine == _det(msg)
        assert cls.FromString(mine) == msg
        assert [_resp_fields(r) for r in dec(_det(msg))] == [_resp_fields(r) for r in resps]


@given(HEALTH)
@settings(max_examples=60, deadline=None, derandomize=True)
def test_health_check_both_ways(h):
    msg = pb.HealthCheckResp(status=h.status, message=h.message, peer_count=h.peer_count)
    assert pc.encode_health_check_resp(h) == _det(msg)
    got = pc.decode_health_check_resp(_det(msg))
    assert (got.status, got.message, got.peer_count) == (h.status, h.message, h.peer_count)
    pc.decode_health_check_req(_det(pb.HealthCheckReq()))


def _parse_both(data: bytes, cls, decode):
    try:
        want = cls.FromString(data)
    except Exception:  # noqa: BLE001 — protobuf's DecodeError
        want = None
    try:
        got = decode(data)
    except pc.DecodeError:
        got = None
    return want, got


@given(st.binary(max_size=64))
@settings(max_examples=300, deadline=None, derandomize=True)
def test_arbitrary_bytes_decode_alike_where_both_parse(data):
    """Where protobuf and the port both parse a byte string, they read the
    same fields.  (Which malformed strings each rejects is not compared:
    upb's choices on overlong varints are its own.)"""
    for cls, decode, fields in ((pb.RateLimitReq, pc.decode_rate_limit_req, _req_fields),
                                (pb.RateLimitResp, pc.decode_rate_limit_resp, _resp_fields)):
        want, got = _parse_both(data, cls, decode)
        if want is not None and got is not None:
            assert fields(got) == fields(want)


@given(REQS, RESPS)
@settings(max_examples=60, deadline=None, derandomize=True)
def test_truncated_and_flipped_messages(req, resp):
    """A real message cut short fails in the port exactly where it fails
    in protobuf; with one byte's top bit flipped, the two read the same
    fields wherever both parse (the metadata map aside: upb drops a map
    entry whose bytes hold only an unknown field, where the port, as
    protobuf's C++ parser does, keeps it with an empty key and value)."""
    for data, cls, decode, fields in (
            (_det(_req_pb(req)), pb.RateLimitReq, pc.decode_rate_limit_req, _req_fields),
            (_det(_resp_pb(resp)), pb.RateLimitResp, pc.decode_rate_limit_resp, _resp_fields)):
        for cut in range(len(data)):
            want, got = _parse_both(data[:cut], cls, decode)
            assert (want is None) == (got is None), data[:cut]
            if want is not None:
                assert fields(got) == fields(want)
            flipped = data[:cut] + bytes([data[cut] ^ 0x80]) + data[cut + 1:]
            want, got = _parse_both(flipped, cls, decode)
            if want is not None and got is not None:
                keep = len(REQ_FIELDS) if cls is pb.RateLimitReq else len(RESP_FIELDS)
                assert fields(got)[:keep] == fields(want)[:keep]


@pytest.mark.parametrize("unknown", [
    b"\x48\x05",                      # field 9, varint
    b"\x51" + bytes(8),               # field 10, fixed64
    b"\x5a\x03abc",                   # field 11, length-delimited
    b"\x65" + bytes(4),               # field 12, fixed32
    b"\x6b\x08\x01\x6c",              # field 13, a group holding field 1
    b"\x1a\x01x",                     # field 3 (an int64) sent as bytes: skipped
])
def test_unknown_fields_are_skipped(unknown):
    req = pb.RateLimitReq(name="n", unique_key="k", hits=3, limit=7, duration=9, behavior=8)
    data = unknown + _det(req) + unknown
    assert _req_fields(pc.decode_rate_limit_req(data)) == _req_fields(pb.RateLimitReq.FromString(
        data))
    resp = pb.RateLimitResp(status=1, limit=5, error="e", metadata={"owner": "a:1"})
    data = _det(resp) + unknown
    assert _resp_fields(pc.decode_rate_limit_resp(data)) == _resp_fields(resp)


def test_paths_name_the_services():
    assert pc.GET_RATE_LIMITS == "/pb.gubernator.V1/GetRateLimits"
    assert pc.HEALTH_CHECK == "/pb.gubernator.V1/HealthCheck"
    assert pc.GET_PEER_RATE_LIMITS == "/pb.gubernator.PeersV1/GetPeerRateLimits"
    assert pb.DESCRIPTOR.services_by_name["V1"].full_name == pc.V1_SERVICE
    assert peers_pb.DESCRIPTOR.services_by_name["PeersV1"].full_name == pc.PEERS_SERVICE
