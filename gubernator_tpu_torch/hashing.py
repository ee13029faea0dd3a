"""Key hashing: FNV-1 and FNV-1a 64-bit, one key or a batch in numpy.

The port's own copy of `gubernator_tpu/hashing.py` (the port imports
nothing of the JAX package); the same bits.  The sketch limiter
(`ops/sketch.py`) derives its row indexes from one fnv1a-64 per key, the
sharded engine (`parallel/sharded_engine.py`) a key's shard, and the
peer rings (`cluster/hash_ring.py`) a key's owner from fnv1 (their
default) or fnv1a.  The batch forms keep the arithmetic on `np.uint64`
arrays, which wrap modulo 2^64 as the scalar forms' mask does.
"""

from __future__ import annotations

import numpy as np

FNV1_OFFSET = 0xCBF29CE484222325
FNV1_PRIME = 0x100000001B3
_MASK = (1 << 64) - 1


def fnv1_64(data: bytes) -> int:
    """FNV-1 64-bit (multiply, then xor) of one key."""
    h = FNV1_OFFSET
    for b in data:
        h = ((h * FNV1_PRIME) & _MASK) ^ b
    return h


def fnv1a_64(data: bytes) -> int:
    """FNV-1a 64-bit (xor, then multiply) of one key."""
    h = FNV1_OFFSET
    for b in data:
        h = ((h ^ b) * FNV1_PRIME) & _MASK
    return h


def fnv1_64_batch(padded: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """FNV-1 (multiply, then xor) of each row of a [N, max_len] uint8
    matrix of padded keys, `lengths[i]` bytes of row i."""
    n, max_len = padded.shape
    h = np.full(n, FNV1_OFFSET, dtype=np.uint64)
    prime = np.uint64(FNV1_PRIME)
    for col in range(max_len):
        active = lengths > col
        if not active.any():
            break
        nh = (h * prime) ^ padded[:, col].astype(np.uint64)
        h = np.where(active, nh, h)
    return h


def fnv1a_64_batch(padded: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """FNV-1a (xor, then multiply) of each row of a [N, max_len] uint8
    matrix of padded keys, `lengths[i]` bytes of row i: one numpy pass a
    column, updating only the lanes whose key reaches that column."""
    n, max_len = padded.shape
    h = np.full(n, FNV1_OFFSET, dtype=np.uint64)
    prime = np.uint64(FNV1_PRIME)
    for col in range(max_len):
        active = lengths > col
        if not active.any():
            break
        nh = (h ^ padded[:, col].astype(np.uint64)) * prime
        h = np.where(active, nh, h)
    return h


def pack_keys(keys: list[bytes]) -> tuple[np.ndarray, np.ndarray]:
    """Variable-length byte keys as a padded uint8 matrix and lengths."""
    n = len(keys)
    lengths = np.fromiter((len(k) for k in keys), count=n, dtype=np.int64)
    max_len = int(lengths.max()) if n else 0
    padded = np.zeros((n, max_len), dtype=np.uint8)
    for i, k in enumerate(keys):
        padded[i, : len(k)] = np.frombuffer(k, dtype=np.uint8)
    return padded, lengths
