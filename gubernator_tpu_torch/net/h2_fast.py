"""Native h2 serving front: one method, zero per-RPC Python.

Port of `gubernator_tpu/net/h2_fast.py H2FastFront` on its byte-window
path.  `H2FastFront` runs the C server (csrc/h2_server.cpp) on a
dedicated cleartext port serving exactly /pb.gubernator.V1/GetRateLimits.
The C side owns accept, framing, the group-commit window and the
response encode; Python is entered ONCE per window with the concatenated
request bodies (protobuf repeated-field semantics make the concatenation
of N GetRateLimitsReq messages one valid GetRateLimitsReq), decodes them
into columns (net/wire_codec.py), runs them through
`V1Instance.serve_decoded_local` → `DecisionEngine.apply_columnar` (the
port's main path: K1, K3 or K4 on the card), and hands the decision
columns back.

Scope, documented for operators: the front answers plain rate-limit
checks — requests that decode on the columnar path and whose responses
carry no error or metadata fields.  An RPC with a behavior the columnar
route declines (GLOBAL, MULTI_REGION, DURATION_IS_GREGORIAN, SKETCH), an
empty name or unique_key, or an engine with a write-through store is
answered with grpc-status UNIMPLEMENTED (12); its window-mates are still
served.  Such traffic belongs on the full listener (the HTTP gateway
here; the gRPC listener of the reference).

Enable with GUBER_H2_FAST_ADDRESS=127.0.0.1:<port> (0 = ephemeral);
GUBER_H2_FAST_WINDOW tunes the C-side group-commit window (default
2 ms).

Event front (GUBER_H2_EVENT_FRONT, default on): the C side multiplexes
all connections over a small pool of epoll reactor threads
(GUBER_H2_REACTORS, default ncpu−1, so one core stays for the Python
serve thread) instead of one thread per connection, with writev-batched
egress and idle-connection reaping (GUBER_H2_IDLE_TIMEOUT; GOAWAY and
close).  GUBER_H2_EVENT_FRONT=0 restores the thread-per-connection
plane, where GUBER_H2_LANES (default: CPU count) shards the listener
across SO_REUSEPORT accept lanes.

Not in this slice (the reference has them): the native decision plane
(GUBER_NATIVE_LEDGER; ROADMAP A item 5), the columnar feeder
(GUBER_NATIVE_FEEDER, the reference's default ingest; item 11) and the
event ring (GUBER_NATIVE_EVENTS; item 11).  Every RPC takes the byte
window path, which answers as the reference's does with
GUBER_NATIVE_FEEDER=0 (tests/test_torch_h2_fast.py holds it to both).

Threads: the window callback runs on the C server's dispatch thread
through a ctypes callback (which takes the interpreter lock).  Its
kernel launches go on that thread's current stream, which, as in every
thread that sets none, is the device's default stream, the one the
gateway's threads and the sweep thread use too.
"""

from __future__ import annotations

import ctypes
import logging
import os
import threading
from typing import Optional

import numpy as np

from gubernator_tpu_torch.ops import native_build

log = logging.getLogger("gubernator_tpu_torch.h2_fast")

UNIMPLEMENTED = 12
INTERNAL = 13


def load() -> ctypes.CDLL:
    """The h2 server library, built on first use; raises if it cannot
    be (there is no fallback front)."""
    return native_build.load("h2_server")


def _off(v: str) -> bool:
    return v.strip().lower() in ("0", "false", "no", "off")


def default_lanes() -> int:
    """GUBER_H2_LANES, defaulting to the CPU count.  0 and malformed
    values mean auto, not one lane."""
    v = os.environ.get("GUBER_H2_LANES", "").strip()
    try:
        n = int(v) if v else 0
    except ValueError:
        log.warning("GUBER_H2_LANES=%r not an integer; using CPU count", v)
        n = 0
    return n if n > 0 else max(1, os.cpu_count() or 1)


def event_front_enabled() -> bool:
    """GUBER_H2_EVENT_FRONT (default on): epoll reactors instead of a
    thread per connection."""
    return not _off(os.environ.get("GUBER_H2_EVENT_FRONT", "1"))


def default_reactors() -> int:
    """GUBER_H2_REACTORS: reactor threads of the event front; 0 (the
    default) lets the C side pick ncpu−1 (at least 1)."""
    v = os.environ.get("GUBER_H2_REACTORS", "").strip()
    try:
        n = int(v) if v else 0
    except ValueError:
        log.warning("GUBER_H2_REACTORS=%r not an integer; using auto", v)
        n = 0
    return max(0, n)


def idle_timeout_ms() -> int:
    """GUBER_H2_IDLE_TIMEOUT (event front): reap connections silent this
    long (a Go duration or float seconds; default 300 s, 0 = never)."""
    raw = os.environ.get("GUBER_H2_IDLE_TIMEOUT", "").strip()
    if not raw:
        return 300_000
    from gubernator_tpu_torch.config import parse_duration

    try:
        return max(0, int(parse_duration(raw) * 1000))
    except ValueError:
        log.warning("GUBER_H2_IDLE_TIMEOUT=%r is not a duration; using 300s", raw)
        return 300_000


def _int64s(ptr, n: int) -> np.ndarray:
    """A numpy view of `n` int64 at a C address."""
    return np.ctypeslib.as_array(ctypes.cast(ptr, ctypes.POINTER(ctypes.c_int64)), shape=(n,))


class H2FastFront:
    """The native front bound to a V1Instance's columnar serve path."""

    def __init__(
        self,
        instance,
        *,
        port: int = 0,
        window_s: float = 0.002,
        max_batch: int = 16384,
        flush_items: int = 4096,  # early flush: an engine batch's worth
        lanes: Optional[int] = None,
        event_front: Optional[bool] = None,
        reactors: Optional[int] = None,
        idle_timeout_s: Optional[float] = None,
    ):
        self._lib = load()
        self.instance = instance
        # Serializes stats() and conn_stats() against close(): the handle
        # must not be freed while a stats call is in flight.
        self._teardown_mu = threading.Lock()
        if event_front is None:
            event_front = event_front_enabled()
        if reactors is None:
            reactors = default_reactors()
        idle_ms = idle_timeout_ms() if idle_timeout_s is None else max(0, int(idle_timeout_s * 1000))
        # The ctypes callback object must outlive the server.
        self._cb = native_build.WINDOW_CALLBACK(self._window)
        self._handle = self._lib.h2s_start(
            port, int(window_s * 1e6), max_batch, flush_items,
            default_lanes() if lanes is None else max(1, int(lanes)),
            1 if event_front else 0, int(reactors), idle_ms, self._cb,
        )
        if not self._handle:
            raise RuntimeError("h2 fast front failed to bind")
        self.port = int(self._lib.h2s_port(self._handle))
        self.address = f"127.0.0.1:{self.port}"
        self.lanes = int(self._lib.h2s_lanes(self._handle))
        self.reactors = int(self._lib.h2s_reactors(self._handle))
        self.event_front = bool(event_front)

    # -- the per-window entry ------------------------------------------

    def _window(self, buf, length, counts_ptr, lens_ptr, n_rpcs, total, out_ptr,
                status_ptr) -> int:
        try:
            n = int(total)
            nr = int(n_rpcs)
            if n == 0:
                # A zero-item window (one empty GetRateLimitsReq) answers
                # empty-OK.  out_ptr (and maybe buf) back empty C vectors
                # whose data() may be NULL: touch nothing but the status.
                if nr > 0 and status_ptr:
                    _int64s(status_ptr, nr)[:] = 0
                return 0
            payload = ctypes.string_at(buf, length)
            cols = _int64s(out_ptr, 4 * n).reshape(4, n)
            rpc_status = _int64s(status_ptr, nr)
            out = self._serve(payload, n)
            if out is not None:
                for row, col in enumerate(out):
                    cols[row] = col
                rpc_status[:] = 0
                return 0
            # The combined window declined (one RPC out of scope must not
            # fail its window-mates): serve each RPC alone and mark only
            # the decliners UNIMPLEMENTED.
            counts = _int64s(counts_ptr, nr)
            lens = _int64s(lens_ptr, nr)
            b_off = i_off = 0
            for r in range(nr):
                k = int(counts[r])
                one = self._serve(payload[b_off : b_off + int(lens[r])], k)
                if one is None:
                    rpc_status[r] = UNIMPLEMENTED
                else:
                    for row, col in enumerate(one):
                        cols[row, i_off : i_off + k] = col
                    rpc_status[r] = 0
                b_off += int(lens[r])
                i_off += k
            return 0
        except Exception:  # noqa: BLE001 — never unwind into C
            log.exception("h2 fast window failed")
            return INTERNAL

    def _engine_columnar_ok(self) -> bool:
        """The engine guard `serve_decoded_local` re-checks, hoisted so
        a window declines before paying a decode: a write-through store
        makes every window UNIMPLEMENTED."""
        return self.instance.engine.store is None

    def _serve(self, payload: bytes, total: int):
        """Columnar decode and engine apply for one byte window; None if
        the batch is out of the front's scope (answered UNIMPLEMENTED)."""
        from gubernator_tpu_torch.net import wire_codec
        from gubernator_tpu_torch.service import COLUMNAR_DISQUALIFIERS

        if not self._engine_columnar_ok():
            return None
        dec = wire_codec.decode_reqs(payload, max(total, 1), COLUMNAR_DISQUALIFIERS)
        if dec is None or dec.n != total:
            return None
        return self.instance.serve_decoded_local(dec)

    # -- lifecycle ------------------------------------------------------

    def _raw_stats(self) -> np.ndarray:
        out = np.zeros(16, dtype=np.int64)
        with self._teardown_mu:
            if self._handle:
                self._lib.h2s_stats(self._handle, out.ctypes.data)
        return out

    @staticmethod
    def _conn_slice(out: np.ndarray) -> dict:
        return {
            "conns_open": int(out[7]),
            "conns_idle_reaped": int(out[8]),
            "reactors": int(out[9]),
            "event_front": bool(out[10]),
        }

    def conn_stats(self) -> dict:
        """The connection plane's slice alone (one FFI call)."""
        return self._conn_slice(self._raw_stats())

    def stats(self) -> dict:
        """RPCs answered OK, windows dispatched, RPCs answered with an
        error status, and the connection plane (zeros once closed)."""
        out = self._raw_stats()
        return {"rpcs": int(out[0]), "windows": int(out[1]), "errors": int(out[2]),
                **self._conn_slice(out), "lanes": self.lanes}

    def close(self) -> None:
        """Stop the server: h2s_stop joins the reactors, the accept
        threads and the dispatch thread (so no window is inside Python
        once it returns) and frees the handle.  The handle is taken under
        `_teardown_mu` first, so a concurrent stats call sees None."""
        with self._teardown_mu:
            handle, self._handle = self._handle, None
        if handle:
            self._lib.h2s_stop(handle)
