"""The port's wire codec (csrc/wire_codec.cpp, net/wire_codec.py) against
protobuf and against the JAX package's codec.

Ports `tests/test_wire_codec.py` (fuzzed decode against the protobuf
library, the declines that send a batch elsewhere, unknown-field
skipping, the encode byte for byte) and holds `decode_reqs` /
`encode_resps` to the reference's on the same seeded inputs: every column
(the key bytes and the FNV-1 / FNV-1a hashes included) and every encoded
byte equal.
"""

from __future__ import annotations

import numpy as np
import pytest

from gubernator_tpu.hashing import fnv1_64, fnv1a_64
from gubernator_tpu.net import wire_codec as ref_codec
from gubernator_tpu.net.pb import gubernator_pb2 as pb
from gubernator_tpu.service import COLUMNAR_DISQUALIFIERS as REF_DISQUALIFIERS
from gubernator_tpu_torch.hashing import fnv1a_64_batch, pack_keys
from gubernator_tpu_torch.net import wire_codec
from gubernator_tpu_torch.ops import native_build
from gubernator_tpu_torch.service import COLUMNAR_DISQUALIFIERS
from gubernator_tpu_torch.types import Behavior


def msg(items):
    return pb.GetRateLimitsReq(requests=[pb.RateLimitReq(**kw) for kw in items]).SerializeToString()


def _keys(dec):
    raw = dec.key_buf.tobytes()
    return [raw[dec.key_offsets[i] : dec.key_offsets[i + 1]] for i in range(dec.n)]


def test_disqualifier_mask_equals_the_reference():
    assert COLUMNAR_DISQUALIFIERS == REF_DISQUALIFIERS
    assert COLUMNAR_DISQUALIFIERS == int(
        Behavior.GLOBAL | Behavior.MULTI_REGION | Behavior.DURATION_IS_GREGORIAN | Behavior.SKETCH
    )


def test_decode_matches_protobuf_fuzz():
    rng = np.random.default_rng(7)
    for trial in range(30):
        n = int(rng.integers(1, 60))
        items = [
            dict(
                name=f"name{trial}",
                unique_key=f"k{i}_{rng.integers(0, 1 << 20)}",
                hits=int(rng.integers(-5, 1 << 40)),
                limit=int(rng.integers(0, 1 << 50)),
                duration=int(rng.integers(0, 1 << 40)),
                algorithm=int(rng.integers(0, 2)),
                behavior=int(rng.choice([0, 1, 8, 9])),  # eligible bits
                burst=int(rng.integers(0, 1 << 30)),
            )
            for i in range(n)
        ]
        raw = msg(items)
        dec = wire_codec.decode_reqs(raw, 1000, COLUMNAR_DISQUALIFIERS)
        assert dec is not None and dec.n == n
        keys = _keys(dec)
        buf, lens = pack_keys(keys)
        assert np.array_equal(dec.fnv1a, fnv1a_64_batch(buf, lens))
        for i, m in enumerate(pb.GetRateLimitsReq.FromString(raw).requests):
            key = f"{m.name}_{m.unique_key}".encode()
            assert keys[i] == key
            assert dec.name_len[i] == len(m.name.encode())
            assert (dec.algo[i], dec.behavior[i], dec.hits[i], dec.limit[i], dec.duration[i],
                    dec.burst[i]) == (m.algorithm, m.behavior, m.hits, m.limit, m.duration, m.burst)
            assert dec.fnv1[i] == fnv1_64(key)
            assert dec.fnv1a[i] == fnv1a_64(key)


@pytest.mark.parametrize("case", [
    "global", "multi_region", "gregorian", "sketch", "empty_name", "empty_key", "over_limit",
    "malformed", "empty",
])
def test_decode_declines_slow_path_batches(case):
    ok = dict(name="a", unique_key="b", hits=1)
    raw, max_items = {
        "global": (msg([ok, dict(ok, behavior=int(Behavior.GLOBAL))]), 1000),
        "multi_region": (msg([dict(ok, behavior=int(Behavior.MULTI_REGION))]), 1000),
        "gregorian": (msg([dict(ok, behavior=int(Behavior.DURATION_IS_GREGORIAN))]), 1000),
        "sketch": (msg([dict(ok, behavior=int(Behavior.SKETCH))]), 1000),
        "empty_name": (msg([dict(ok, name="")]), 1000),
        "empty_key": (msg([ok, dict(ok, unique_key="")]), 1000),
        "over_limit": (msg([dict(ok, unique_key=f"k{i}") for i in range(5)]), 4),
        "malformed": (b"\xff\xff\xff", 10),
        "empty": (b"", 10),
    }[case]
    assert wire_codec.decode_reqs(raw, max_items, COLUMNAR_DISQUALIFIERS) is None
    assert ref_codec.decode_reqs(raw, max_items, REF_DISQUALIFIERS) is None


def test_decode_skips_unknown_fields():
    # A future field (99) must be skipped, not rejected.
    inner = pb.RateLimitReq(name="a", unique_key="b", hits=3).SerializeToString()
    inner += bytes([0x98, 0x06, 42])  # unknown varint field 99 (tag 792)
    raw = bytes([1 << 3 | 2, len(inner)]) + inner
    dec = wire_codec.decode_reqs(raw, 10, 0)
    assert dec is not None and dec.n == 1 and dec.hits[0] == 3


def test_encode_matches_protobuf():
    rng = np.random.default_rng(11)
    for _ in range(20):
        n = int(rng.integers(0, 40))
        status = rng.integers(0, 2, n).astype(np.int32)
        limit = rng.integers(0, 1 << 50, n).astype(np.int64)
        remaining = rng.integers(0, 1 << 50, n).astype(np.int64)
        reset = rng.integers(0, 1 << 45, n).astype(np.int64)
        raw = wire_codec.encode_resps(status, limit, remaining, reset)
        ref = pb.GetRateLimitsResp(responses=[
            pb.RateLimitResp(status=int(status[i]), limit=int(limit[i]),
                             remaining=int(remaining[i]), reset_time=int(reset[i]))
            for i in range(n)
        ]).SerializeToString()
        assert raw == ref


def _seeded_items(rng, n):
    names = ["api", "a_b", "ü名", "x" * 130]  # '_' in a name; UTF-8; a long one
    return [
        dict(
            name=str(rng.choice(names)),
            unique_key=f"u{int(rng.integers(0, 1 << 30))}" + ("_z" * int(rng.integers(0, 3))),
            hits=int(rng.choice([-(1 << 62), -7, 0, 1, 5, 1 << 62])),
            limit=int(rng.choice([0, 1, 10, 1 << 40, (1 << 63) - 1])),
            duration=int(rng.choice([0, 1, 60_000, 1 << 50])),
            algorithm=int(rng.integers(0, 2)),
            behavior=int(rng.choice([0, 1, 8, 9])),
            burst=int(rng.choice([0, 20, -1])),
        )
        for _ in range(n)
    ]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_decode_and_encode_equal_the_reference(seed):
    """Every column and every byte of the port's codec equals the JAX
    package's, on the same seeded inputs (negative and extreme int64s,
    '_' inside names, UTF-8 and 130-byte names, concatenated bodies)."""
    rng = np.random.default_rng(seed)
    raw = b"".join(msg(_seeded_items(rng, int(rng.integers(1, 40)))) for _ in range(3))
    got = wire_codec.decode_reqs(raw, 1000, COLUMNAR_DISQUALIFIERS)
    want = ref_codec.decode_reqs(raw, 1000, REF_DISQUALIFIERS)
    assert got is not None and want is not None and got.n == want.n
    for field in want._fields:
        g, w = getattr(got, field), getattr(want, field)
        if field == "n":
            assert g == w
        else:
            assert g.dtype == w.dtype and np.array_equal(g, w), field
    n = got.n
    cols = (rng.integers(0, 2, n).astype(np.int32),
            rng.choice([0, 1, 1 << 62, -1], n).astype(np.int64),
            rng.integers(-(1 << 40), 1 << 40, n).astype(np.int64),
            rng.integers(0, 1 << 45, n).astype(np.int64))
    assert wire_codec.encode_resps(*cols) == ref_codec.encode_resps(*cols)


def test_codec_symbols_load_in_both_libraries():
    """The codec is a library of its own and is linked into the h2
    server's, with the decision plane and the columnar feeder; both load
    (a missing symbol shows at CDLL load) with every export declared."""
    for name in ("wire_codec", "h2_server"):
        lib = native_build.load(name)
        assert lib.wire_decode_reqs.argtypes and lib.wire_encode_resps.argtypes
        assert lib.wire_encode_resps_hint.argtypes
    lib = native_build.load("h2_server")
    for fn in ("cf_create", "cf_set_hints", "cf_slot_ptrs", "cf_pack", "cf_flush", "cf_stats",
               "cf_stop", "cf_free", "cf_bench_pack", "h2s_attach_feeder", "h2s_feeder_respond",
               "h2s_feeder_release"):
        assert getattr(lib, fn).argtypes, fn
    assert native_build.SOURCES["h2_server"] == ("h2_server.cpp", "wire_codec.cpp",
                                                 "decision_plane.cpp", "columnar_feeder.cpp")
    assert "-pthread" in native_build.GXX_FLAGS


def test_cache_key_covers_every_source(tmp_path, monkeypatch):
    """An edit to any source of a library (the codec linked into the h2
    server included) names a new build; an unchanged tree names the same."""
    for name in native_build.SOURCES["h2_server"]:
        (tmp_path / name).write_bytes((native_build.CSRC / name).read_bytes())
    monkeypatch.setattr(native_build, "CSRC", tmp_path)
    before = native_build._target("h2_server")
    assert native_build._target("h2_server") == before
    (tmp_path / "wire_codec.cpp").write_bytes(b"// edited\n" + (tmp_path / "wire_codec.cpp").read_bytes())
    assert native_build._target("h2_server") != before
    after = native_build._target("h2_server")
    (tmp_path / "decision_plane.cpp").write_bytes(b"// edited\n")
    assert native_build._target("h2_server") != after


@pytest.mark.parametrize("seed", [0, 1])
def test_encode_hint_equals_the_reference(seed):
    """`wire_encode_resps_hint` byte for byte against the reference's
    (core/native/wire_codec.cpp:273): OVER_LIMIT items with a reset carry
    retry_after_ms = max(0, reset - now) (past resets clamp to 0), UNDER
    items and OVER items with reset 0 carry none."""
    rng = np.random.default_rng(seed)
    n = 64
    now = 1_760_000_000_123
    status = rng.integers(0, 2, n).astype(np.int32)
    limit = rng.choice([0, 5, 1000, 1 << 40], n).astype(np.int64)
    remaining = rng.choice([0, 0, 3, 999], n).astype(np.int64)
    reset = (now + rng.choice([-500, 0, 1, 1234, 3_600_000], n)).astype(np.int64)
    reset[::7] = 0
    cols = (status, limit, remaining, reset)
    got = wire_codec.encode_resps_hint(*cols, 1, now)
    assert got == ref_codec.encode_resps_hint(*cols, 1, now)
    for st, rst, r in zip(status, reset, pb.GetRateLimitsResp.FromString(got).responses):
        want = {"retry_after_ms": str(max(0, int(rst) - now))} if st == 1 and rst > 0 else {}
        assert dict(r.metadata) == want
    # Only the OVER items differ from the plain encode: UNDER-only columns
    # encode to the same bytes with and without the hint.
    under = (np.zeros(n, np.int32), limit, remaining, reset)
    assert wire_codec.encode_resps_hint(*under, 1, now) == wire_codec.encode_resps(*under)
