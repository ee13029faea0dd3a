"""Checkpoint and resume: a file-backed Loader for state snapshots.

The port's own copy of `gubernator_tpu/checkpoint.py`.  The Loader
interface (store.py) is the checkpoint system, as in the reference:
`engine.save(loader)` streams a full-fidelity device→host snapshot out,
`engine.load(loader)` streams it back in before serving.
`NpzFileLoader` keeps the stream as one compressed npz of columnar
arrays, with the same keys and dtypes as the JAX package's, so a
checkpoint written by either package loads in the other: that is how a
deployment moves from the TPU build to the GPU build and back.
"""

from __future__ import annotations

import os
from typing import Iterable, Iterator, List

import numpy as np

from gubernator_tpu_torch.store import (
    CacheItem,
    LeakyBucketItem,
    TokenBucketItem,
    words_from_float,
)
from gubernator_tpu_torch.types import Algorithm


class NpzFileLoader:
    """Loader that persists CacheItems to an .npz file."""

    def __init__(self, path: str):
        self.path = path

    def save(self, items: Iterator[CacheItem]) -> None:
        keys: List[str] = []
        algo: List[int] = []
        status: List[int] = []
        limit: List[int] = []
        remaining_i: List[int] = []
        remaining_f: List[float] = []
        remf_hi: List[int] = []
        remf_lo: List[int] = []
        duration: List[int] = []
        t0: List[int] = []
        expire: List[int] = []
        burst: List[int] = []
        invalid: List[int] = []
        for it in items:
            v = it.value
            if v is None:
                continue
            keys.append(it.key)
            algo.append(int(it.algorithm))
            expire.append(it.expire_at)
            invalid.append(it.invalid_at)
            if isinstance(v, TokenBucketItem):
                status.append(v.status)
                limit.append(v.limit)
                remaining_i.append(v.remaining)
                remaining_f.append(0.0)
                remf_hi.append(0)
                remf_lo.append(0)
                duration.append(v.duration)
                t0.append(v.created_at)
                burst.append(0)
            else:
                status.append(0)
                limit.append(v.limit)
                remaining_i.append(0)
                remaining_f.append(v.remaining)
                # The exact 32.32 words when present (the float64 mirror
                # rounds once whole parts pass 2^21); items built from the
                # float alone derive their words from it.
                w = (
                    v.remaining_words
                    if v.remaining_words is not None
                    else words_from_float(v.remaining)
                )
                remf_hi.append(w[0])
                remf_lo.append(w[1])
                duration.append(v.duration)
                t0.append(v.updated_at)
                burst.append(v.burst)
        # An .npz-suffixed temporary name (savez would append the suffix
        # otherwise), swapped in atomically so that a crash mid-save never
        # clobbers the previous checkpoint.
        tmp = self.path + ".tmp.npz"
        np.savez_compressed(
            tmp,
            keys=np.asarray(keys, dtype=object),
            algo=np.asarray(algo, dtype=np.int32),
            status=np.asarray(status, dtype=np.int32),
            limit=np.asarray(limit, dtype=np.int64),
            remaining_i=np.asarray(remaining_i, dtype=np.int64),
            remaining_f=np.asarray(remaining_f, dtype=np.float64),
            remf_hi=np.asarray(remf_hi, dtype=np.int32),
            remf_lo=np.asarray(remf_lo, dtype=np.uint32),
            duration=np.asarray(duration, dtype=np.int64),
            t0=np.asarray(t0, dtype=np.int64),
            expire=np.asarray(expire, dtype=np.int64),
            burst=np.asarray(burst, dtype=np.int64),
            invalid=np.asarray(invalid, dtype=np.int64),
        )
        os.replace(tmp, self.path)

    def load(self) -> Iterable[CacheItem]:
        if not os.path.exists(self.path):
            return
        with np.load(self.path, allow_pickle=True) as z:
            keys = z["keys"]
            algo = z["algo"]
            status = z["status"]
            limit = z["limit"]
            remaining_i = z["remaining_i"]
            remaining_f = z["remaining_f"]
            duration = z["duration"]
            t0 = z["t0"]
            expire = z["expire"]
            burst = z["burst"]
            invalid = z["invalid"]
            remf_hi = z["remf_hi"] if "remf_hi" in z else None
            remf_lo = z["remf_lo"] if "remf_lo" in z else None
            for i in range(len(keys)):
                if algo[i] == int(Algorithm.TOKEN_BUCKET):
                    value = TokenBucketItem(
                        status=int(status[i]),
                        limit=int(limit[i]),
                        duration=int(duration[i]),
                        remaining=int(remaining_i[i]),
                        created_at=int(t0[i]),
                    )
                else:
                    value = LeakyBucketItem(
                        limit=int(limit[i]),
                        duration=int(duration[i]),
                        remaining=float(remaining_f[i]),
                        updated_at=int(t0[i]),
                        burst=int(burst[i]),
                        remaining_words=(
                            (int(remf_hi[i]), int(remf_lo[i]))
                            if remf_hi is not None
                            else None
                        ),
                    )
                yield CacheItem(
                    key=str(keys[i]),
                    value=value,
                    expire_at=int(expire[i]),
                    algorithm=int(algo[i]),
                    invalid_at=int(invalid[i]),
                )
