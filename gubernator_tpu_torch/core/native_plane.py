"""ctypes wrapper over the native decision plane (csrc/decision_plane.cpp).

Port of `load` and `NativeDecisionPlane` of
`gubernator_tpu/core/native_plane.py`.  The plane is the C twin of the
ledger's exact fast path: sticky over-limit records and delegated credit
leases, probed inside the h2 server's connection threads with no Python
frame.  This wrapper is the bridge side: core/ledger.py pushes grants
down (`install_over` / `install_lease`), pulls drained counts back
(`pull`) and peeks, all under the ledger's own lock, so the lock order
is always ledger lock → plane mutex and a lease lives in exactly one
tier at a time.

The library is the h2 server's (ops/native_build.py links
decision_plane.cpp into it): the server calls `dp_try_serve` in-image;
Python talks to the same table through these entries.  The columnar
feeder half of the reference module (`FeederSlot`,
`NativeColumnarFeeder`) comes with ROADMAP A item 11.
"""

from __future__ import annotations

import ctypes
import time
from typing import Optional, Tuple

import numpy as np

# The plane takes the ledger's own breaker set: the two tiers must agree
# on what falls through, or a native answer could cover a row the Python
# ledger would have revoked on.
from gubernator_tpu_torch.core.ledger import _BREAKERS
from gubernator_tpu_torch.ops import native_build
from gubernator_tpu_torch.types import Algorithm, Status


def load() -> ctypes.CDLL:
    """The h2 server library that holds the plane, built on first use;
    raises if it cannot be."""
    return native_build.load("h2_server")


def _out(n: int) -> np.ndarray:
    return np.zeros(n, dtype=np.int64)


class NativeDecisionPlane:
    """One native table, owned by the front / ledger pair that attached it."""

    def __init__(self, *, max_keys: int = 65536, disqualify_mask: int = 0):
        self._lib = load()
        self._handle = self._lib.dp_create(
            max_keys, int(Algorithm.TOKEN_BUCKET), _BREAKERS, disqualify_mask,
            int(Status.OVER_LIMIT), int(Status.UNDER_LIMIT),
        )
        if not self._handle:
            raise RuntimeError("dp_create failed")

    # -- grant / pull bridge (called under the ledger lock) ------------

    def set_clock_offset(self, ledger_now_ms: int) -> None:
        """Anchor the plane's realtime clock to the ledger's domain."""
        self._lib.dp_set_clock_offset(self._handle, int(ledger_now_ms) - int(time.time() * 1000))

    def install_over(self, key: bytes, limit: int, duration: int, reset: int) -> bool:
        return bool(self._lib.dp_install_over(self._handle, key, len(key), limit, duration, reset))

    def install_lease(self, key: bytes, limit: int, duration: int, reset: int, rem: int,
                      credit: int, consumed: int, expiry: int) -> bool:
        return bool(self._lib.dp_install_lease(self._handle, key, len(key), limit, duration,
                                               reset, rem, credit, consumed, expiry))

    def _read(self, fn, key: bytes) -> Optional[Tuple[int, int, int, int, int]]:
        out = _out(4)
        kind = fn(self._handle, key, len(key), out.ctypes.data)
        if kind == 0:
            return None
        return (int(kind), int(out[0]), int(out[1]), int(out[2]), int(out[3]))

    def pull(self, key: bytes) -> Optional[Tuple[int, int, int, int, int]]:
        """Remove the record; returns (kind, consumed, credit, rem, reset)
        or None when absent.  Orders every native answer for the key
        before the caller's next step."""
        return self._read(self._lib.dp_pull, key)

    def peek(self, key: bytes) -> Optional[Tuple[int, int, int, int, int]]:
        """`pull` without the removal."""
        return self._read(self._lib.dp_peek, key)

    def clear(self) -> None:
        self._lib.dp_clear(self._handle)

    def set_hints(self, on: bool) -> None:
        """retry_after_ms metadata on natively answered OVER items
        (GUBER_RETRY_HINTS)."""
        self._lib.dp_set_hints(self._handle, 1 if on else 0)

    # -- serve entries (the tests drive these; the h2 server calls the C
    # -- twin in-image) ------------------------------------------------

    def probe(self, key: bytes, algo: int, behavior: int, hits: int, limit: int, duration: int,
              now_ms: int) -> Optional[Tuple[int, int, int]]:
        """One item against the table at an explicit clock; commits the
        drain.  Returns (status, remaining, reset) or None."""
        out = _out(3)
        if not self._lib.dp_probe(self._handle, key, len(key), algo, behavior, hits, limit,
                                  duration, now_ms, out.ctypes.data):
            return None
        return int(out[0]), int(out[1]), int(out[2])

    def try_serve(self, body: bytes, max_items: int = 1000, now_ms: int = -1) -> Optional[bytes]:
        """Whole-RPC serve of a GetRateLimitsReq payload, the code path the
        h2 connection threads run: the GetRateLimitsResp bytes, or None on
        a decline (which changes nothing)."""
        cap = 96 * max(1, max_items) + 16  # sized for the retry-hint encode
        out = ctypes.create_string_buffer(cap)
        n = self._lib.dp_try_serve(self._handle, body, len(body), max_items, now_ms,
                                   ctypes.addressof(out), cap)
        if n < 0:
            return None
        return out.raw[:n]

    # ------------------------------------------------------------------

    def stats(self) -> dict:
        out = _out(8)
        self._lib.dp_stats(self._handle, out.ctypes.data)
        return {
            "native_answered": int(out[0]),
            "native_rpcs": int(out[1]),
            "native_declined": int(out[2]),
            "native_entries": int(out[3]),
            "native_installs": int(out[4]),
            "native_pulls": int(out[5]),
        }

    @property
    def handle(self) -> int:
        """The raw plane handle, for h2s_attach_plane."""
        return self._handle

    def close(self) -> None:
        if self._handle:
            self._lib.dp_free(self._handle)
            self._handle = None
