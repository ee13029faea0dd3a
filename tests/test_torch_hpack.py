"""HPACK (RFC 7541) of the port's h2 server and unary client
(gubernator_tpu_torch/csrc/hpack.h), held to the RFC and to grpcio.

- Appendix C: the request examples C.2-C.4 and the response examples
  C.5-C.6 (dynamic table of 256 octets, with evictions), each block
  decoded in sequence on one decoder, the header list and the dynamic
  table (entries, newest first, and size) as the RFC gives them, Huffman
  included; the Huffman code itself by its Kraft sum and C.4.1's string.
- Round trips: the port's encoder (literal without indexing, no Huffman)
  through its decoder, and the Huffman coder, over hypothesis-made
  header lists; malformed input (EOS in a string, bad padding, an index
  past the table, a size update above the limit or after a field) is a
  decode error.
- grpcio's client, whose C-core indexes headers and may Huffman-code
  them, calls the port's gRPC listener several times on one connection
  with metadata values that span every printable byte: each call's
  :path is routed right (V1, PeersV1, an unknown path) and answered
  as a reference V1Instance answers it.
"""

from __future__ import annotations

import ctypes
import struct
from fractions import Fraction

import grpc
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from gubernator_tpu.clock import Clock as RefClock
from gubernator_tpu.config import Config as RefConfig
from gubernator_tpu.core.engine import DecisionEngine as RefEngine
from gubernator_tpu.net import serde
from gubernator_tpu.net.grpc_service import PeersV1Stub, V1Stub
from gubernator_tpu.net.pb import gubernator_pb2 as pb
from gubernator_tpu.net.pb import peers_pb2 as peers_pb
from gubernator_tpu.service import V1Instance as RefInstance
from gubernator_tpu_torch.clock import Clock
from gubernator_tpu_torch.core import h2_client
from gubernator_tpu_torch.core.engine import DecisionEngine
from gubernator_tpu_torch.net.grpc_listener import GrpcListener
from gubernator_tpu_torch.service import V1Instance

T0_NS = 1_700_000_000_000_000_000


@pytest.fixture(scope="module")
def lib():
    return h2_client.load()


def _pack(headers):
    out = b""
    for name, value in headers:
        for s in (name, value):
            s = s.encode() if isinstance(s, str) else s
            out += struct.pack(">I", len(s)) + s
    return out


def _unpack(buf):
    out, pos, vals = [], 0, []
    while pos < len(buf):
        (n,) = struct.unpack_from(">I", buf, pos)
        vals.append(bytes(buf[pos + 4:pos + 4 + n]))
        pos += 4 + n
        if len(vals) == 2:
            out.append(tuple(vals))
            vals = []
    return out


def _call(fn, *args, cap=1 << 16):
    out = np.zeros(cap, dtype=np.uint8)
    n = fn(*args, out.ctypes.data, cap)
    return None if n < 0 else out[:n].tobytes()


class Decoder:
    def __init__(self, lib, limit=4096):
        self.lib = lib
        self.h = lib.hpack_decoder_new(limit)

    def decode(self, block: bytes):
        got = _call(self.lib.hpack_decoder_decode, self.h, block, len(block))
        return None if got is None else [(n.decode(), v.decode()) for n, v in _unpack(got)]

    def table(self):
        size = ctypes.c_int64()
        out = np.zeros(1 << 16, dtype=np.uint8)
        n = self.lib.hpack_decoder_table(self.h, out.ctypes.data, len(out), ctypes.byref(size))
        return [(a.decode(), b.decode()) for a, b in _unpack(out[:n].tobytes())], size.value

    def close(self):
        self.lib.hpack_decoder_free(self.h)


# -- Appendix C ----------------------------------------------------------

def _hex(s: str) -> bytes:
    return bytes.fromhex(s.replace(" ", "").replace("\n", ""))


REQ1 = [(":method", "GET"), (":scheme", "http"), (":path", "/"),
        (":authority", "www.example.com")]
REQ2 = REQ1 + [("cache-control", "no-cache")]
REQ3 = [(":method", "GET"), (":scheme", "https"), (":path", "/index.html"),
        (":authority", "www.example.com"), ("custom-key", "custom-value")]
REQ_TABLES = [
    ([(":authority", "www.example.com")], 57),
    ([("cache-control", "no-cache"), (":authority", "www.example.com")], 110),
    ([("custom-key", "custom-value"), ("cache-control", "no-cache"),
      (":authority", "www.example.com")], 164),
]
DATE1 = "Mon, 21 Oct 2013 20:13:21 GMT"
DATE2 = "Mon, 21 Oct 2013 20:13:22 GMT"
LOC = "https://www.example.com"
COOKIE = "foo=ASDJKHQKBZXOQWEOPIUAXQWEOIU; max-age=3600; version=1"
RESP1 = [(":status", "302"), ("cache-control", "private"), ("date", DATE1), ("location", LOC)]
RESP2 = [(":status", "307"), ("cache-control", "private"), ("date", DATE1), ("location", LOC)]
RESP3 = [(":status", "200"), ("cache-control", "private"), ("date", DATE2), ("location", LOC),
         ("content-encoding", "gzip"), ("set-cookie", COOKIE)]
RESP_TABLES = [
    ([("location", LOC), ("date", DATE1), ("cache-control", "private"), (":status", "302")],
     222),
    ([(":status", "307"), ("location", LOC), ("date", DATE1), ("cache-control", "private")],
     222),
    ([("set-cookie", COOKIE), ("content-encoding", "gzip"), ("date", DATE2)], 215),
]

SEQUENCES = {
    "C.3 requests": (4096, [
        "8286 8441 0f77 7777 2e65 7861 6d70 6c65 2e63 6f6d",
        "8286 84be 5808 6e6f 2d63 6163 6865",
        "8287 85bf 400a 6375 7374 6f6d 2d6b 6579 0c63 7573 746f 6d2d 7661 6c75 65",
    ], [REQ1, REQ2, REQ3], REQ_TABLES),
    "C.4 requests, Huffman": (4096, [
        "8286 8441 8cf1 e3c2 e5f2 3a6b a0ab 90f4 ff",
        "8286 84be 5886 a8eb 1064 9cbf",
        "8287 85bf 4088 25a8 49e9 5ba9 7d7f 8925 a849 e95b b8e8 b4bf",
    ], [REQ1, REQ2, REQ3], REQ_TABLES),
    "C.5 responses": (256, [
        "4803 3330 3258 0770 7269 7661 7465 611d 4d6f 6e2c 2032 3120 4f63 7420 3230 3133"
        " 2032 303a 3133 3a32 3120 474d 546e 1768 7474 7073 3a2f 2f77 7777 2e65 7861 6d70"
        " 6c65 2e63 6f6d",
        "4803 3330 37c1 c0bf",
        "88c1 611d 4d6f 6e2c 2032 3120 4f63 7420 3230 3133 2032 303a 3133 3a32 3220 474d"
        " 54c0 5a04 677a 6970 7738 666f 6f3d 4153 444a 4b48 514b 425a 584f 5157 454f 5049"
        " 5541 5851 5745 4f49 553b 206d 6178 2d61 6765 3d33 3630 303b 2076 6572 7369 6f6e"
        " 3d31",
    ], [RESP1, RESP2, RESP3], RESP_TABLES),
    "C.6 responses, Huffman": (256, [
        "4882 6402 5885 aec3 771a 4b61 96d0 7abe 9410 54d4 44a8 2005 9504 0b81 66e0 82a6"
        " 2d1b ff6e 919d 29ad 1718 63c7 8f0b 97c8 e9ae 82ae 43d3",
        "4883 640e ffc1 c0bf",
        "88c1 6196 d07a be94 1054 d444 a820 0595 040b 8166 e084 a62d 1bff c05a 839b d9ab"
        " 77ad 94e7 821d d7f2 e6c7 b335 dfdf cd5b 3960 d5af 2708 7f36 72c1 ab27 0fb5 291f"
        " 9587 3160 65c0 03ed 4ee5 b106 3d50 07",
    ], [RESP1, RESP2, RESP3], RESP_TABLES),
}


@pytest.mark.parametrize("name", list(SEQUENCES))
def test_appendix_c_sequences(lib, name):
    limit, blocks, headers, tables = SEQUENCES[name]
    dec = Decoder(lib, limit)
    try:
        for block, want, (table, size) in zip(blocks, headers, tables):
            assert dec.decode(_hex(block)) == want
            assert dec.table() == (table, size)
    finally:
        dec.close()


@pytest.mark.parametrize("block,want,table", [
    # C.2.1 literal with indexing, C.2.2 without, C.2.3 never indexed,
    # C.2.4 indexed.
    ("400a 6375 7374 6f6d 2d6b 6579 0d63 7573 746f 6d2d 6865 6164 6572",
     [("custom-key", "custom-header")], ([("custom-key", "custom-header")], 55)),
    ("040c 2f73 616d 706c 652f 7061 7468", [(":path", "/sample/path")], ([], 0)),
    ("1008 7061 7373 776f 7264 0673 6563 7265 74", [("password", "secret")], ([], 0)),
    ("82", [(":method", "GET")], ([], 0)),
])
def test_appendix_c2_representations(lib, block, want, table):
    dec = Decoder(lib)
    try:
        assert dec.decode(_hex(block)) == want
        assert dec.table() == table
    finally:
        dec.close()


def _huffman_code(lib, sym):
    """(code, length) of one symbol: eight copies of it fill exactly
    `length` octets, so no padding hides the code's last bits."""
    enc = _call(lib.hpack_huffman_encode, bytes([sym]) * 8, 8)
    bits = "".join(f"{b:08b}" for b in enc)
    return int(bits[:len(enc)], 2), len(enc)


def test_huffman_code_is_complete_and_canonical(lib):
    """Appendix B: the 256 octets' codes and EOS (30 bits of ones) fill
    the code space exactly (Kraft sum 1), codes of one length run in
    symbol order, spot codes equal the RFC's, and C.4.1's string codes
    to the RFC's bytes."""
    codes = [_huffman_code(lib, s) for s in range(256)]
    assert sum(Fraction(1, 2 ** n) for _, n in codes) + Fraction(1, 2 ** 30) == 1
    order = sorted(range(256), key=lambda s: (codes[s][1], s))
    for a, b in zip(order, order[1:]):
        (ca, la), (cb, lb) = codes[a], codes[b]
        assert cb == (ca + 1) << (lb - la)
    rfc = {0: (0x1FF8, 13), 1: (0x7FFFD8, 23), 10: (0x3FFFFFFC, 30), 13: (0x3FFFFFFD, 30),
           22: (0x3FFFFFFE, 30), ord(" "): (0x14, 6), ord("0"): (0x0, 5), ord("a"): (0x3, 5),
           ord("t"): (0x9, 5), ord("{"): (0x7FFE, 15), ord("|"): (0x7FC, 11),
           ord("~"): (0x1FFD, 13), 255: (0x3FFFFEE, 26)}
    assert {s: codes[s] for s in rfc} == rfc
    assert sorted(chr(s) for s in range(256) if codes[s][1] == 5) == sorted("012aceiost")
    assert _call(lib.hpack_huffman_encode, b"www.example.com", 15) == _hex(
        "f1e3 c2e5 f23a 6ba0 ab90 f4ff")
    assert _call(lib.hpack_huffman_decode, _hex("f1e3 c2e5 f23a 6ba0 ab90 f4ff"), 12) == (
        b"www.example.com")


@given(st.lists(st.tuples(st.binary(max_size=40), st.binary(max_size=300)), max_size=12))
@settings(max_examples=60, deadline=None, derandomize=True)
def test_encoder_round_trips_through_decoder(lib, headers):
    enc = _call(lib.hpack_encode, _pack(headers), len(_pack(headers)))
    h = lib.hpack_decoder_new(4096)
    try:
        got = _call(lib.hpack_decoder_decode, h, enc, len(enc))
        assert got is not None and _unpack(got) == [(n, v) for n, v in headers]
    finally:
        lib.hpack_decoder_free(h)


@given(st.binary(max_size=200))
@settings(max_examples=80, deadline=None, derandomize=True)
def test_huffman_round_trips(lib, data):
    enc = _call(lib.hpack_huffman_encode, data, len(data))
    assert _call(lib.hpack_huffman_decode, enc, len(enc)) == data


@pytest.mark.parametrize("block", [
    "41 81 00",                  # Huffman string ending with zero padding bits
    "41 85 ff ff ff ff ff",      # EOS inside a Huffman string
    "41 82 1f ff",               # more than 7 bits of padding
    "be",                        # index 62 with an empty dynamic table
    "80",                        # index 0
    "3f e2 1f",                  # size update to 4097, above the 4096 limit
    "82 20",                     # size update after a field
    "41 0a 61",                  # string longer than the block
])
def test_malformed_blocks_are_rejected(lib, block):
    dec = Decoder(lib)
    try:
        assert dec.decode(_hex(block)) is None
    finally:
        dec.close()


def test_size_update_evicts_and_limit_holds(lib):
    dec = Decoder(lib)
    try:
        assert dec.decode(_hex("400a 6375 7374 6f6d 2d6b 6579 0d63 7573 746f 6d2d 6865 6164"
                               " 6572")) is not None
        assert dec.table()[1] == 55
        assert dec.decode(_hex("20")) == []  # size 0: evicts everything
        assert dec.table() == ([], 0)
        lib.hpack_decoder_set_limit(dec.h, 64)
        assert dec.decode(_hex("3f 22")) is None  # 64 + 1 > the new limit
        assert dec.decode(_hex("3f 21")) == []  # exactly 64
    finally:
        dec.close()


# -- grpcio's client on the port's listener --------------------------------

PRINTABLE = bytes(range(0x20, 0x7F)).decode()


def _req(key, hits=1, limit=5):
    return pb.RateLimitReq(name="hp", unique_key=key, hits=hits, limit=limit, duration=60_000)


@pytest.fixture(scope="module")
def served():
    port_inst = V1Instance(DecisionEngine(1 << 12, clock=Clock().freeze_at(T0_NS), device="cpu"),
                           ledger=False)
    ref_inst = RefInstance(RefConfig(cache_size=1 << 12),
                           RefEngine(1 << 12, clock=RefClock().freeze_at(T0_NS)))
    listener = GrpcListener(port_inst, "127.0.0.1:0", workers=4)
    try:
        yield listener, ref_inst
    finally:
        listener.close()
        port_inst.close()
        ref_inst.close()


def test_grpcio_metadata_over_one_connection_routes_every_call(served):
    listener, ref = served
    channel = grpc.insecure_channel(listener.address)
    try:
        v1, peers = V1Stub(channel), PeersV1Stub(channel)
        unknown = channel.unary_unary("/pb.gubernator.PeersV1/UpdatePeerGlobals",
                                      request_serializer=lambda b: b,
                                      response_deserializer=lambda b: b)
        for call in range(12):
            # Long values rotating through every printable byte: each
            # call indexes new entries and evicts old ones from the
            # 4096-octet dynamic table.
            md = [(f"x-guber-{i}", (PRINTABLE * 4)[call + i:call + i + 120 + 7 * i])
                  for i in range(6)]
            key = f"k{call % 3}"
            kind = call % 4
            if kind == 0:
                got = v1.GetRateLimits(pb.GetRateLimitsReq(requests=[_req(key)]), metadata=md,
                                       timeout=10)
                want = ref.get_rate_limits([serde.rate_limit_req_from_pb(_req(key))])
                assert [serde.rate_limit_resp_from_pb(r) for r in got.responses] == want
            elif kind == 1:
                got = peers.GetPeerRateLimits(peers_pb.GetPeerRateLimitsReq(
                    requests=[_req(key, hits=2)]), metadata=md, timeout=10)
                want = ref.get_peer_rate_limits([serde.rate_limit_req_from_pb(_req(key, 2))])
                assert [serde.rate_limit_resp_from_pb(r) for r in got.rate_limits] == want
            elif kind == 2:
                got = v1.HealthCheck(pb.HealthCheckReq(), metadata=md, timeout=10)
                assert (got.status, got.peer_count) == ("healthy", 0)
            else:
                with pytest.raises(grpc.RpcError) as e:
                    unknown(b"", metadata=md, timeout=10)
                assert e.value.code() == grpc.StatusCode.UNIMPLEMENTED
                assert "/pb.gubernator.PeersV1/UpdatePeerGlobals" in e.value.details()
        assert listener.stats()["conns_open"] == 1
    finally:
        channel.close()
