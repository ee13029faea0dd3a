"""ctypes wrappers over the native decision plane (csrc/decision_plane.cpp)
and the columnar feeder (csrc/columnar_feeder.cpp).

Port of `gubernator_tpu/core/native_plane.py` (`load`,
`NativeDecisionPlane`, `FeederSlot`, `NativeColumnarFeeder`).  The plane is the C twin of the
ledger's exact fast path: sticky over-limit records and delegated credit
leases, probed inside the h2 server's connection threads with no Python
frame.  This wrapper is the bridge side: core/ledger.py pushes grants
down (`install_over` / `install_lease`), pulls drained counts back
(`pull`) and peeks, all under the ledger's own lock, so the lock order
is always ledger lock → plane mutex and a lease lives in exactly one
tier at a time.

The library is the h2 server's (ops/native_build.py links
decision_plane.cpp into it): the server calls `dp_try_serve` in-image;
Python talks to the same table through these entries.

The feeder is the h2 front's default ingest: the server's connection
threads pack each RPC the plane declines into a ring of pre-allocated
column windows, and the feeder's own serve thread enters Python once a
window through `NativeColumnarFeeder`'s callback, with numpy views over
the window's C columns (mapped once, at creation: no copy, no
allocation per window).  The event ring's hook (`attach_ring`) comes with
ROADMAP A item 13.
"""

from __future__ import annotations

import ctypes
import logging
import time
from typing import Optional, Tuple

import numpy as np

# The plane takes the ledger's own breaker set: the two tiers must agree
# on what falls through, or a native answer could cover a row the Python
# ledger would have revoked on.
from gubernator_tpu_torch.core.ledger import _BREAKERS
from gubernator_tpu_torch.ops import native_build
from gubernator_tpu_torch.types import Algorithm, Status

log = logging.getLogger("gubernator_tpu_torch.native_plane")

INTERNAL = 13  # grpc-status of a window whose handler raised


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


class FeederSlot:
    """Numpy views over one ring window's C column arrays, mapped once at
    feeder creation, so a window costs array slicing, not allocation or
    copying."""

    _DTYPES = (
        ("key_buf", np.uint8), ("key_offsets", np.int64),
        ("algo", np.int32), ("behavior", np.int32),
        ("hits", np.int64), ("limit", np.int64),
        ("duration", np.int64), ("burst", np.int64),
        ("fnv1", np.uint64), ("fnv1a", np.uint64),
        ("name_lens", np.int32), ("out_status", np.int32),
        ("out_limit", np.int64), ("out_remaining", np.int64),
        ("out_reset", np.int64), ("rpc_row", np.int64),
        ("rpc_items", np.int64), ("rpc_status", np.int64),
        ("hint_now_ms", np.int64),
    )
    __slots__ = tuple(name for name, _ in _DTYPES)

    def __init__(self, lib, handle, slot: int, max_rows: int, key_cap: int, max_rpcs: int):
        ptrs = (ctypes.c_void_p * len(self._DTYPES))()
        lib.cf_slot_ptrs(handle, slot, ptrs)
        sizes = {"key_buf": key_cap, "key_offsets": max_rows + 1, "rpc_row": max_rpcs,
                 "rpc_items": max_rpcs, "rpc_status": max_rpcs, "hint_now_ms": 1}
        for i, (name, dtype) in enumerate(self._DTYPES):
            ptr = ctypes.cast(ptrs[i], ctypes.POINTER(np.ctypeslib.as_ctypes_type(dtype)))
            setattr(self, name, np.ctypeslib.as_array(ptr, shape=(sizes.get(name, max_rows),)))


class NativeColumnarFeeder:
    """The columnar feeder ring's bridge side (csrc/columnar_feeder.cpp).

    Owns the ring handle, the per-slot views and the ctypes callback.
    The owner (net/h2_fast.py H2FastFront) gives `window_handler(slot:
    FeederSlot, n_rows, n_rpcs, key_bytes) -> int`: it serves the window
    through the engine's columnar path, writes the verdict lanes and the
    per-RPC status in place, and returns 0 (or a grpc status that fails
    the whole window); the feeder's thread then encodes and sends every
    RPC's response in C.  `window_handler=None` makes a sink feeder
    (tests and the pack microbench: windows seal and recycle in C, with
    no Python a window).  A library that does not build, or a ring that
    cannot be created, raises."""

    def __init__(self, *, n_slots: int = 4, max_rows: int = 8192, key_cap: int = 1 << 20,
                 max_rpcs: int = 4096, disqualify_mask: int = 0, window_s: float = 0.002,
                 flush_rows: int = 4096, hints: bool = True, window_handler=None):
        self._lib = load()
        self._handler = window_handler
        # The ctypes callback object must outlive the ring.
        self._cb = (native_build.FEEDER_CALLBACK(self._window) if window_handler is not None
                    else ctypes.cast(None, native_build.FEEDER_CALLBACK))
        self._handle = self._lib.cf_create(
            n_slots, max_rows, key_cap, max_rpcs, disqualify_mask, int(window_s * 1e6),
            flush_rows, int(Status.OVER_LIMIT), self._cb,
        )
        if not self._handle:
            raise RuntimeError("cf_create failed")
        st = self.stats()
        # The C side clamps every shape to its cursor's field widths: the
        # views map the clamped capacities, never the raw arguments.
        self.n_slots = st["feeder_slots"]
        self.max_rows = st["feeder_max_rows"]
        self.key_cap = st["feeder_key_cap"]
        self.max_rpcs = st["feeder_max_rpcs"]
        self.slots = [FeederSlot(self._lib, self._handle, i, self.max_rows, self.key_cap,
                                 self.max_rpcs) for i in range(self.n_slots)]
        self._lib.cf_set_hints(self._handle, 1 if hints else 0)

    # -- the per-window trampoline (the feeder's serve thread → Python) --

    def _window(self, slot, n_rows, n_rpcs, key_bytes) -> int:
        try:
            return int(self._handler(self.slots[int(slot)], int(n_rows), int(n_rpcs),
                                     int(key_bytes)))
        except Exception:  # noqa: BLE001 — never unwind into C
            log.exception("feeder window failed")
            return INTERNAL

    # -- test and bench entries ----------------------------------------

    def pack(self, body: bytes, max_items: int = 1000, stream: int = 0) -> int:
        """Pack one request body with no connection attached; returns the
        rows packed, -1 for a decline, -2 for ring backpressure."""
        return int(self._lib.cf_pack(self._handle, body, len(body), max_items, None, stream, 0))

    def flush(self) -> None:
        """Seal and serve every claimed window (a bounded wait)."""
        self._lib.cf_flush(self._handle)

    def bench_pack(self, body: bytes, max_items: int, reps: int, threads: int) -> int:
        """C-threaded pack microbench; returns the rows packed."""
        return int(self._lib.cf_bench_pack(self._handle, body, len(body), max_items, reps,
                                           threads))

    # ------------------------------------------------------------------

    def stats(self) -> dict:
        out = _out(16)
        self._lib.cf_stats(self._handle, out.ctypes.data)
        return {
            "feeder_rpcs": int(out[0]),
            "feeder_rows": int(out[1]),
            "feeder_windows": int(out[2]),
            "feeder_served_rows": int(out[3]),
            "feeder_ring_full": int(out[4]),
            "feeder_declined": int(out[5]),
            "feeder_window_errors": int(out[6]),
            "feeder_open_slot": int(out[7]),
            "feeder_open_rows": int(out[8]),
            "feeder_slots": int(out[9]),
            "feeder_max_rows": int(out[10]),
            "feeder_key_cap": int(out[11]),
            "feeder_max_rpcs": int(out[12]),
        }

    @property
    def handle(self) -> int:
        """The raw feeder handle, for h2s_attach_feeder."""
        return self._handle

    def stop(self) -> None:
        """Drain, then stop the serve thread.  The owner detaches the
        feeder from the h2 server first (h2s_attach_feeder(None)) and
        frees it after (close)."""
        if self._handle:
            self._lib.cf_stop(self._handle)

    def close(self) -> None:
        """Stop (cf_stop joins once, so this is idempotent), then free.
        The slot views die with the ring: nothing touches them after."""
        if self._handle:
            self._lib.cf_stop(self._handle)
            self._lib.cf_free(self._handle)
            self._handle = None
            self.slots = []
