"""Native h2 serving front: one method, zero per-RPC Python.

Port of `gubernator_tpu/net/h2_fast.py H2FastFront`.  `H2FastFront` runs
the C server (csrc/h2_server.cpp) on a dedicated cleartext port serving
exactly /pb.gubernator.V1/GetRateLimits.  The C side owns accept,
framing, the group-commit window and the response encode; Python is
entered once per window, and runs the window through
`V1Instance.serve_decoded_local` (the decision ledger, then
`DecisionEngine.apply_columnar`: the port's main path, K1, K3 or K4 on
the card, K9 / K10 on a paged engine's faults, the flat K1 / K3 on the
sharded engine).

Columnar feeder (GUBER_NATIVE_FEEDER, default on): the front creates a
`NativeColumnarFeeder` (core/native_plane.py, csrc/columnar_feeder.cpp)
and attaches it to the C server.  Each connection thread decodes its
RPC once, in C, into the open window of a lock-free ring of column
windows (GUBER_FEEDER_RING_SLOTS / _ROWS / _KEYBYTES); the feeder's own
serve thread enters Python once a window (`_feeder_window`) with numpy
views over the window's columns, writes the verdicts back in place, and
encodes and sends every RPC's response in C.  Its encode adds a
`retry_after_ms` metadata hint on OVER_LIMIT items (GUBER_RETRY_HINTS,
default on), computed from the engine's clock.  An RPC the feeder
declines — slow-path rows (a disqualifying behavior, an empty name or
key, malformed bytes), an RPC too large for an empty window, ring
backpressure, zero items — takes the byte window path, counted
(`feeder_declined`, `feeder_ring_full`).  A feeder that is asked for and
cannot be built or created fails the front; an engine with a
write-through store gets no feeder (every window would decline).

Byte window path (GUBER_NATIVE_FEEDER=0, or what the feeder declines):
Python is entered ONCE per window with the concatenated request bodies
(protobuf repeated-field semantics make the concatenation of N
GetRateLimitsReq messages one valid GetRateLimitsReq), decodes them into
columns (net/wire_codec.py) and hands the decision columns back.  Its
answers carry no retry hint, as on the reference's byte window path.

Native decision plane (`native_ledger`, default on; the daemon passes
GUBER_NATIVE_LEDGER): when the instance runs the decision ledger on the
live SYSTEM_CLOCK, the front creates a `NativeDecisionPlane`
(core/native_plane.py, csrc/decision_plane.cpp), attaches it to the
ledger and to the C server, and every RPC is first probed there, in its
connection thread: an RPC whose every item is a sticky over-limit key
or drains a delegated lease is answered whole in C, with no window, no
Python and no device launch (`stats()["native_rpcs"]`); any other RPC
takes the window path unchanged.  A second front on the same instance
takes the ledger's leases over from the first one's plane
(`DecisionLedger.attach_native`).  A frozen clock never gets a plane
(the plane reads the real time).  Plane-served OVER_LIMIT items carry a
`retry_after_ms` metadata hint too.

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

Not in this slice (the reference has it): the event ring
(GUBER_NATIVE_EVENTS; ROADMAP A item 13).  tests/test_torch_h2_fast.py
holds the front to the reference's, feeder on and off, with the ledger
off and on, byte for byte.

Threads: the byte window callback runs on the C server's dispatch
thread, the feeder's window callback on the feeder's serve thread, each
through a ctypes callback (which takes the interpreter lock); a window
declined to the byte path under ring pressure can put both threads in
`serve_decoded_local` at once, and the engine's lock (and the ledger's)
orders them.  Their kernel launches go on the calling thread's current
stream, which, as in every thread that sets none, is the device's
default stream, the one the gateway's threads and the sweep thread use
too.
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


def retry_hints_enabled() -> bool:
    """GUBER_RETRY_HINTS (default on): retry_after_ms metadata on
    OVER_LIMIT items the plane answers, so herds back off."""
    return not _off(os.environ.get("GUBER_RETRY_HINTS", "1"))


def native_feeder_enabled() -> bool:
    """GUBER_NATIVE_FEEDER (default on): pack the RPCs the plane declines
    into the columnar feeder's ring in the C connection threads instead
    of queueing wire bytes for the byte window path."""
    return not _off(os.environ.get("GUBER_NATIVE_FEEDER", "1"))


def _int_knob(env: str, default: int) -> int:
    v = os.environ.get(env, "").strip()
    try:
        return int(v) if v else default
    except ValueError:
        log.warning("%s=%r not an integer; using %d", env, v, default)
        return default


def _feeder_ring_params() -> dict:
    """GUBER_FEEDER_RING_SLOTS / _ROWS / _KEYBYTES: the ring's window
    count, rows a window and key bytes a window (the C side clamps them
    to its cursor's field widths)."""
    return {
        "n_slots": _int_knob("GUBER_FEEDER_RING_SLOTS", 4),
        "max_rows": _int_knob("GUBER_FEEDER_RING_ROWS", 8192),
        "key_cap": _int_knob("GUBER_FEEDER_RING_KEYBYTES", 1 << 20),
    }


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
        native_ledger: bool = True,
        native_feeder: Optional[bool] = None,
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
        self.plane = None
        self.feeder = None
        try:
            self._attach_plane(native_ledger)
            self._attach_feeder(native_feeder_enabled() if native_feeder is None
                                else native_feeder, window_s, flush_items)
        except BaseException:
            self.close()
            raise

    def _attach_feeder(self, native_feeder: bool, window_s: float, flush_items: int) -> None:
        """Create and attach the columnar feeder (reference
        net/h2_fast.py:304-322), unless it is off or the engine can never
        serve columnar (a write-through store: every ring window would be
        a decode and a decline; the byte path's guard declines first).  A
        feeder that does not build or cannot be created raises: the front
        never falls back quietly to the byte path."""
        if not native_feeder or not self._engine_columnar_ok():
            return
        from gubernator_tpu_torch.core.native_plane import NativeColumnarFeeder
        from gubernator_tpu_torch.service import COLUMNAR_DISQUALIFIERS

        self.feeder = NativeColumnarFeeder(
            disqualify_mask=COLUMNAR_DISQUALIFIERS, window_s=window_s,
            flush_rows=flush_items, hints=retry_hints_enabled(),
            window_handler=self._feeder_window, **_feeder_ring_params(),
        )
        self._lib.h2s_attach_feeder(self._handle, self.feeder.handle)

    def _attach_plane(self, native_ledger: bool) -> None:
        """Create and attach the native decision plane when the ledger
        runs on the live clock and `native_ledger` is on (reference
        net/h2_fast.py:340).  A frozen clock, or any clock but
        SYSTEM_CLOCK, gets none: the plane compares deadlines against
        the real time, and a clock ahead of it would
        let stale leases answer (tests that manage the clock attach with
        `ledger.attach_native` themselves).  A plane that does not build
        fails the front, as the server itself does."""
        ledger = getattr(self.instance, "ledger", None)
        if ledger is None or not native_ledger:
            return
        from gubernator_tpu_torch.clock import SYSTEM_CLOCK

        clock = self.instance.engine.clock
        if clock is not SYSTEM_CLOCK or clock.frozen:
            log.info("native decision plane off: the engine clock is not the live system clock")
            return
        from gubernator_tpu_torch.core.native_plane import NativeDecisionPlane
        from gubernator_tpu_torch.service import COLUMNAR_DISQUALIFIERS

        self.plane = NativeDecisionPlane(max_keys=ledger.max_keys,
                                         disqualify_mask=COLUMNAR_DISQUALIFIERS)
        ledger.attach_native(self.plane)
        self.plane.set_hints(retry_hints_enabled())
        self._lib.h2s_attach_plane(self._handle, self.plane.handle)

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

    # -- the per-window feeder entry (csrc/columnar_feeder.cpp) ----------

    def _feeder_window(self, slot, n_rows: int, n_rpcs: int, key_bytes: int) -> int:
        """Serve one sealed ring window (reference :498-582): a
        DecodedBatch of views over the slot's columns (no decode, no
        copy: the connection threads packed them), the shared columnar
        serve, the verdict lanes written in place.  The feeder's thread
        then encodes and sends the responses in C."""
        from gubernator_tpu_torch.net.wire_codec import DecodedBatch

        # The engine's "now" for the scatter's retry-hint encode: the
        # reset_time verdicts are in the engine's clock, so the hint
        # subtracts that clock's now (a wall clock in C would skew every
        # hint by the engine's offset, frozen test clocks included).
        slot.hint_now_ms[0] = self.instance.engine.clock.now_ms()

        def batch(row0: int, k: int) -> DecodedBatch:
            off0 = int(slot.key_offsets[row0])
            offk = int(slot.key_offsets[row0 + k])
            offsets = slot.key_offsets[row0 : row0 + k + 1]
            return DecodedBatch(
                n=k, key_buf=slot.key_buf[off0:offk],
                key_offsets=offsets - off0 if off0 else offsets,
                algo=slot.algo[row0 : row0 + k], behavior=slot.behavior[row0 : row0 + k],
                hits=slot.hits[row0 : row0 + k], limit=slot.limit[row0 : row0 + k],
                duration=slot.duration[row0 : row0 + k], burst=slot.burst[row0 : row0 + k],
                fnv1=slot.fnv1[row0 : row0 + k], fnv1a=slot.fnv1a[row0 : row0 + k],
                name_len=slot.name_lens[row0 : row0 + k],
            )

        def write(row0: int, k: int, out) -> None:
            st, lim, rem, rst = out
            slot.out_status[row0 : row0 + k] = st
            slot.out_limit[row0 : row0 + k] = lim
            slot.out_remaining[row0 : row0 + k] = rem
            slot.out_reset[row0 : row0 + k] = rst

        out = self.instance.serve_decoded_local(batch(0, n_rows))
        if out is not None:
            write(0, n_rows, out)
            slot.rpc_status[:n_rpcs] = 0
            return 0
        # The combined window declined: one RPC out of scope must not fail
        # its window-mates — serve each RPC alone off the same views and
        # mark only the decliners UNIMPLEMENTED.
        for r in range(n_rpcs):
            row0, k = int(slot.rpc_row[r]), int(slot.rpc_items[r])
            one = self.instance.serve_decoded_local(batch(row0, k))
            if one is None:
                slot.rpc_status[r] = UNIMPLEMENTED
            else:
                write(row0, k, one)
                slot.rpc_status[r] = 0
        return 0

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
        """RPCs answered OK, byte windows dispatched, RPCs answered with
        an error status, RPCs and items the decision plane answered in C,
        RPCs the feeder answered and items it packed, the connection plane
        (zeros once closed), and the plane's and the feeder's own
        counters while they are attached."""
        out = self._raw_stats()
        stats = {"rpcs": int(out[0]), "windows": int(out[1]), "errors": int(out[2]),
                 "native_rpcs": int(out[3]), "native_items": int(out[4]),
                 "feeder_front_rpcs": int(out[5]), "feeder_front_items": int(out[6]),
                 **self._conn_slice(out), "lanes": self.lanes}
        with self._teardown_mu:
            if self.plane is not None:
                stats.update({k: v for k, v in self.plane.stats().items() if k != "native_rpcs"})
            if self.feeder is not None:
                stats.update(self.feeder.stats())
        return stats

    def close(self) -> None:
        """Stop the server (reference :680-702): h2s_stop joins the
        reactors, the accept threads and the dispatch thread (so no byte
        window is inside Python once it returns) and frees the handle.
        The feeder is detached and stopped before it (its serve thread
        drains every claimed window, then joins) and freed after it.  The
        handle is taken under `_teardown_mu` first, so a concurrent stats
        call sees None."""
        with self._teardown_mu:
            handle, self._handle = self._handle, None
        if not handle:
            return
        if self.plane is not None:
            # Detach before the stop: connection threads re-read the
            # pointer per RPC, so no new native serve starts; the stop
            # joins them before the ledger pulls its credit back and the
            # table is freed.
            self._lib.h2s_attach_plane(handle, None)
        if self.feeder is not None:
            # Drain, then close: detach (connection threads stop packing
            # at their next RPC), stop (the serve thread answers every
            # claimed window — UNAVAILABLE, through the still-live
            # connections — then joins); free only after h2s_stop has
            # joined the connection threads too.
            self._lib.h2s_attach_feeder(handle, None)
            self.feeder.stop()
        self._lib.h2s_stop(handle)
        if self.feeder is not None:
            with self._teardown_mu:
                feeder, self.feeder = self.feeder, None
            feeder.close()
        if self.plane is not None:
            # Only this front's plane: another front may have attached
            # its own since.
            self.instance.ledger.detach_native(self.plane)
            with self._teardown_mu:
                plane, self.plane = self.plane, None
            plane.close()
