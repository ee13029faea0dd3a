"""ctypes wrapper over the port's wire codec (csrc/wire_codec.cpp).

Port of `gubernator_tpu/net/wire_codec.py` (`DecodedBatch` :32, `load`
:47, `decode_reqs` :254, `encode_resps` :309).  `decode_reqs(raw)` turns
one GetRateLimitsReq payload into engine-ready columns: the concatenated
key buffer and offsets that the native intern table's `schedule_packed`
takes as they are, the request fields, and per-key FNV-1 / FNV-1a
hashes.  `encode_resps(...)` writes the GetRateLimitsResp bytes straight
from the engine's output columns.  No per-item Python object is made on
either side.

`decode_reqs` returns None for any batch the columnar path cannot serve
(a disqualifying behavior bit, an empty name or unique_key, more items
than allowed, malformed bytes); the caller then answers it some other
way.  There is no fallback for the library itself: `load` raises when it
does not build or load.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np

from gubernator_tpu_torch.ops import native_build


class DecodedBatch(NamedTuple):
    n: int
    key_buf: np.ndarray  # uint8 [total_key_bytes]
    key_offsets: np.ndarray  # int64 [n+1]
    algo: np.ndarray  # int32 [n]
    behavior: np.ndarray  # int32 [n]
    hits: np.ndarray  # int64 [n]
    limit: np.ndarray  # int64 [n]
    duration: np.ndarray  # int64 [n]
    burst: np.ndarray  # int64 [n]
    fnv1: np.ndarray  # uint64 [n]
    fnv1a: np.ndarray  # uint64 [n]
    name_len: np.ndarray  # int32 [n] — key_buf item = name + b"_" + key


def load():
    """The codec library, built on first use; raises if it cannot be."""
    return native_build.load("wire_codec")


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


def decode_reqs(raw: bytes, max_items: int, disqualify_mask: int) -> Optional[DecodedBatch]:
    """Decode or decline (None): a disqualifying bit, an empty name or
    key, more than `max_items` items, or malformed bytes."""
    if not raw:
        return None
    lib = load()
    # Each item costs at least 4 wire bytes (outer tag and length, two
    # of content), so len(raw) // 2 bounds the item count.
    max_items = min(max_items, len(raw) // 2 + 1)
    # Key bytes plus one '_' per item fit in len(raw): each item's
    # framing costs more than the separator.
    key_cap = len(raw)
    key_buf = np.empty(key_cap, dtype=np.uint8)
    key_offsets = np.empty(max_items + 1, dtype=np.int64)
    algo = np.empty(max_items, dtype=np.int32)
    behavior = np.empty(max_items, dtype=np.int32)
    hits = np.empty(max_items, dtype=np.int64)
    limit = np.empty(max_items, dtype=np.int64)
    duration = np.empty(max_items, dtype=np.int64)
    burst = np.empty(max_items, dtype=np.int64)
    fnv1 = np.empty(max_items, dtype=np.uint64)
    fnv1a = np.empty(max_items, dtype=np.uint64)
    name_len = np.empty(max_items, dtype=np.int32)
    n = lib.wire_decode_reqs(
        raw, len(raw), max_items, disqualify_mask,
        _ptr(key_buf), key_cap, _ptr(key_offsets), _ptr(algo),
        _ptr(behavior), _ptr(hits), _ptr(limit), _ptr(duration),
        _ptr(burst), _ptr(fnv1), _ptr(fnv1a), _ptr(name_len),
    )
    if n <= 0:
        return None
    return DecodedBatch(
        n=int(n),
        key_buf=key_buf[: key_offsets[n]],
        key_offsets=key_offsets[: n + 1],
        algo=algo[:n],
        behavior=behavior[:n],
        hits=hits[:n],
        limit=limit[:n],
        duration=duration[:n],
        burst=burst[:n],
        fnv1=fnv1[:n],
        fnv1a=fnv1a[:n],
        name_len=name_len[:n],
    )


def encode_resps(status: np.ndarray, limit: np.ndarray, remaining: np.ndarray,
                 reset_time: np.ndarray) -> bytes:
    """Columns → GetRateLimitsResp bytes (proto3: zero fields omitted)."""
    lib = load()
    n = len(status)
    status = np.ascontiguousarray(status, dtype=np.int32)
    limit = np.ascontiguousarray(limit, dtype=np.int64)
    remaining = np.ascontiguousarray(remaining, dtype=np.int64)
    reset_time = np.ascontiguousarray(reset_time, dtype=np.int64)
    # Worst case per item: tag and length (6) + 4 fields × (1 tag + 10 varint).
    out = np.empty(n * 52 + 16, dtype=np.uint8)
    written = lib.wire_encode_resps(
        _ptr(status), _ptr(limit), _ptr(remaining), _ptr(reset_time), n, _ptr(out), len(out),
    )
    if written < 0:
        raise RuntimeError("wire_encode_resps: output buffer too small")
    return out[:written].tobytes()
