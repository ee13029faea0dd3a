"""The protobuf wire format of the V1 and PeersV1 messages, written by
hand with the stdlib: the port's counterpart of the JAX package's
`net/serde.py` with its generated `net/pb/gubernator_pb2.py` and
`peers_pb2.py`, since the card's machine has no protobuf.

It covers every field of `RateLimitReq` (name, unique_key, hits, limit,
duration, algorithm, behavior, burst; proto/gubernator.proto has no
others), `RateLimitResp` with `error` and the `metadata` map,
`GetRateLimitsReq` / `GetRateLimitsResp`, `GetPeerRateLimitsReq` /
`GetPeerRateLimitsResp` (field for field the same: a repeated message at
field 1, peers.proto:21-28), `HealthCheckReq` and `HealthCheckResp`, and
the methods' paths.  The columnar codec
(`net/wire_codec.py`) stays the fast path; it declines items with an
error or metadata, which forwarded answers carry (`metadata.owner`).

Encoding is proto3's: fields in number order, zero values left out, a
negative int64 or enum as a ten-byte varint, a map entry with both its
key and its value, map entries in key order (as protobuf's deterministic
encoder writes them).  Decoding
follows protobuf's parser: unknown fields, and known fields that arrive
with another wire type, are skipped; a repeated scalar keeps its last
value; enums and int32 keep the low 32 bits, sign-extended; strings must
be UTF-8; a truncated or malformed message raises `DecodeError`.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

from gubernator_tpu_torch.types import HealthCheckResp, RateLimitReq, RateLimitResp

_U64 = (1 << 64) - 1

# The methods' paths (proto/gubernator.proto service V1, peers.proto
# service PeersV1).
V1_SERVICE = "pb.gubernator.V1"
PEERS_SERVICE = "pb.gubernator.PeersV1"
GET_RATE_LIMITS = f"/{V1_SERVICE}/GetRateLimits"
HEALTH_CHECK = f"/{V1_SERVICE}/HealthCheck"
GET_PEER_RATE_LIMITS = f"/{PEERS_SERVICE}/GetPeerRateLimits"


class DecodeError(ValueError):
    """A message that is not valid protobuf for its type."""


def _put_varint(out: bytearray, v: int) -> None:
    v &= _U64
    while v >= 0x80:
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    out.append(v)


def _put_len(out: bytearray, field: int, data: bytes) -> None:
    _put_varint(out, field << 3 | 2)
    _put_varint(out, len(data))
    out += data


def _put_int(out: bytearray, field: int, v: int) -> None:
    if v:
        _put_varint(out, field << 3)
        _put_varint(out, v)


def _put_str(out: bytearray, field: int, s: str) -> None:
    if s:
        _put_len(out, field, s.encode())


def _varint(buf: bytes, pos: int) -> Tuple[int, int]:
    v = shift = 0
    while True:
        if pos >= len(buf) or shift >= 70:
            raise DecodeError("truncated varint")
        b = buf[pos]
        pos += 1
        v |= (b & 0x7F) << shift
        if not b & 0x80:
            return v & _U64, pos
        shift += 7


def _tag(buf: bytes, pos: int) -> Tuple[int, int]:
    """A field's tag: a varint of at most five bytes (a uint32)."""
    key, end = _varint(buf, pos)
    if end - pos > 5:
        raise DecodeError("tag longer than five bytes")
    return key, end


def _int64(v: int) -> int:
    return v - (1 << 64) if v >= 1 << 63 else v


def _int32(v: int) -> int:
    v &= 0xFFFFFFFF
    return v - (1 << 32) if v >= 1 << 31 else v


def _fields(buf: bytes):
    """(field, wire type, value) of each field in `buf`: the varint for
    type 0, the bytes for type 2; other types are skipped."""
    pos, end = 0, len(buf)
    while pos < end:
        key, pos = _tag(buf, pos)
        field, wt = key >> 3, key & 7
        if field == 0:
            raise DecodeError("field number 0")
        if wt == 0:
            v, pos = _varint(buf, pos)
            yield field, wt, v
        elif wt == 2:
            n, pos = _varint(buf, pos)
            if n > end - pos:
                raise DecodeError("truncated length-delimited field")
            yield field, wt, buf[pos:pos + n]
            pos += n
        elif wt == 1:
            if end - pos < 8:
                raise DecodeError("truncated fixed64")
            pos += 8
        elif wt == 5:
            if end - pos < 4:
                raise DecodeError("truncated fixed32")
            pos += 4
        elif wt == 3:
            pos = _skip_group(buf, pos, field)
        else:
            raise DecodeError(f"wire type {wt}")


def _skip_group(buf: bytes, pos: int, field: int) -> int:
    """Skip a group's fields up to its END_GROUP tag."""
    end = len(buf)
    while True:
        if pos >= end:
            raise DecodeError("unterminated group")
        key, pos = _tag(buf, pos)
        f, wt = key >> 3, key & 7
        if wt == 4:
            if f != field:
                raise DecodeError("mismatched end group")
            return pos
        if f == 0:
            raise DecodeError("field number 0")
        if wt == 0:
            _, pos = _varint(buf, pos)
        elif wt == 1:
            pos += 8
        elif wt == 2:
            n, pos = _varint(buf, pos)
            pos += n
        elif wt == 5:
            pos += 4
        elif wt == 3:
            pos = _skip_group(buf, pos, f)
        else:
            raise DecodeError(f"wire type {wt}")
        if pos > end:
            raise DecodeError("truncated group")


def _text(b: bytes) -> str:
    try:
        return b.decode()
    except UnicodeDecodeError as e:
        raise DecodeError("string field is not UTF-8") from e


# -- RateLimitReq ---------------------------------------------------------

def encode_rate_limit_req(r: RateLimitReq) -> bytes:
    out = bytearray()
    _put_str(out, 1, r.name)
    _put_str(out, 2, r.unique_key)
    _put_int(out, 3, r.hits)
    _put_int(out, 4, r.limit)
    _put_int(out, 5, r.duration)
    _put_int(out, 6, int(r.algorithm))
    _put_int(out, 7, int(r.behavior))
    _put_int(out, 8, r.burst)
    return bytes(out)


_REQ_STR = {1: "name", 2: "unique_key"}
_REQ_I64 = {3: "hits", 4: "limit", 5: "duration", 8: "burst"}
_REQ_ENUM = {6: "algorithm", 7: "behavior"}


def decode_rate_limit_req(buf: bytes) -> RateLimitReq:
    kw: Dict[str, object] = {}
    for field, wt, v in _fields(buf):
        if wt == 2 and field in _REQ_STR:
            kw[_REQ_STR[field]] = _text(v)
        elif wt == 0 and field in _REQ_I64:
            kw[_REQ_I64[field]] = _int64(v)
        elif wt == 0 and field in _REQ_ENUM:
            kw[_REQ_ENUM[field]] = _int32(v)
    return RateLimitReq(**kw)


# -- RateLimitResp --------------------------------------------------------

def encode_rate_limit_resp(r: RateLimitResp) -> bytes:
    out = bytearray()
    _put_int(out, 1, int(r.status))
    _put_int(out, 2, r.limit)
    _put_int(out, 3, r.remaining)
    _put_int(out, 4, r.reset_time)
    _put_str(out, 5, r.error)
    for k, v in sorted(r.metadata.items()):
        entry = bytearray()
        _put_len(entry, 1, k.encode())
        _put_len(entry, 2, v.encode())
        _put_len(out, 6, bytes(entry))
    return bytes(out)


_RESP_I64 = {2: "limit", 3: "remaining", 4: "reset_time"}


def _map_entry(buf: bytes) -> Tuple[str, str]:
    k = v = ""
    for field, wt, x in _fields(buf):
        if wt == 2 and field == 1:
            k = _text(x)
        elif wt == 2 and field == 2:
            v = _text(x)
    return k, v


def decode_rate_limit_resp(buf: bytes) -> RateLimitResp:
    kw: Dict[str, object] = {}
    metadata: Dict[str, str] = {}
    for field, wt, v in _fields(buf):
        if wt == 0 and field == 1:
            kw["status"] = _int32(v)
        elif wt == 0 and field in _RESP_I64:
            kw[_RESP_I64[field]] = _int64(v)
        elif wt == 2 and field == 5:
            kw["error"] = _text(v)
        elif wt == 2 and field == 6:
            k, val = _map_entry(v)
            metadata[k] = val
    return RateLimitResp(metadata=metadata, **kw)


# -- the batch messages ---------------------------------------------------

def encode_get_rate_limits_req(reqs: Sequence[RateLimitReq]) -> bytes:
    """GetRateLimitsReq, and GetPeerRateLimitsReq (the same bytes)."""
    out = bytearray()
    for r in reqs:
        _put_len(out, 1, encode_rate_limit_req(r))
    return bytes(out)


def decode_get_rate_limits_req(buf: bytes) -> List[RateLimitReq]:
    return [decode_rate_limit_req(v) for field, wt, v in _fields(buf) if field == 1 and wt == 2]


def encode_get_rate_limits_resp(resps: Sequence[RateLimitResp]) -> bytes:
    """GetRateLimitsResp, and GetPeerRateLimitsResp (the same bytes)."""
    out = bytearray()
    for r in resps:
        _put_len(out, 1, encode_rate_limit_resp(r))
    return bytes(out)


def decode_get_rate_limits_resp(buf: bytes) -> List[RateLimitResp]:
    return [decode_rate_limit_resp(v) for field, wt, v in _fields(buf) if field == 1 and wt == 2]


encode_get_peer_rate_limits_req = encode_get_rate_limits_req
decode_get_peer_rate_limits_req = decode_get_rate_limits_req
encode_get_peer_rate_limits_resp = encode_get_rate_limits_resp
decode_get_peer_rate_limits_resp = decode_get_rate_limits_resp


# -- HealthCheckReq / HealthCheckResp ------------------------------------

def decode_health_check_req(buf: bytes) -> None:
    """HealthCheckReq has no fields: only check that `buf` parses."""
    for _ in _fields(buf):
        pass


def encode_health_check_resp(r: HealthCheckResp) -> bytes:
    out = bytearray()
    _put_str(out, 1, r.status)
    _put_str(out, 2, r.message)
    _put_int(out, 3, r.peer_count)
    return bytes(out)


def decode_health_check_resp(buf: bytes) -> HealthCheckResp:
    kw: Dict[str, object] = {}
    for field, wt, v in _fields(buf):
        if wt == 2 and field == 1:
            kw["status"] = _text(v)
        elif wt == 2 and field == 2:
            kw["message"] = _text(v)
        elif wt == 0 and field == 3:
            kw["peer_count"] = _int32(v)
    return HealthCheckResp(**kw)
