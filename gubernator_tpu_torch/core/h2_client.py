"""ctypes wrapper for the native h2 gRPC client: the load loops
(csrc/h2_client.cpp) and the unary client (csrc/h2_unary.cpp).

`UnaryChannel(address)` is the transport of the peer planes
(cluster/peer_client.py): one HTTP/2 connection to the peer, shared by
every calling thread, dialed at the first call and again after a GOAWAY
or a reset; `call(path, body, timeout)` sends grpc-timeout, waits at
most `timeout` (then cancels the stream) and returns (grpc status,
grpc-message, response body), transport failures included as the
statuses grpcio gives them (UNAVAILABLE, DEADLINE_EXCEEDED).

Port of `gubernator_tpu/core/h2_client.py`.  `bench_unary` drives a
closed-loop unary load from C threads (the interpreter lock released for
the whole call), so a loopback run measures the SERVER's per-RPC
capacity rather than a Python client's; `connscale` holds many mostly
idle connections from epoll worker threads with a closed loop on a few.
It needs no grpcio, which the card's machine lacks: chip_smoke.py loads
the h2 front through it.  The library builds on first use
(ops/native_build.py); `load` raises if it cannot.
"""

from __future__ import annotations

import ctypes
import enum
import threading
from typing import Optional, Tuple

import numpy as np

from gubernator_tpu_torch.ops import native_build


class StatusCode(enum.IntEnum):
    """gRPC status codes (grpc/status.h)."""

    OK = 0
    CANCELLED = 1
    UNKNOWN = 2
    INVALID_ARGUMENT = 3
    DEADLINE_EXCEEDED = 4
    NOT_FOUND = 5
    ALREADY_EXISTS = 6
    PERMISSION_DENIED = 7
    RESOURCE_EXHAUSTED = 8
    FAILED_PRECONDITION = 9
    ABORTED = 10
    OUT_OF_RANGE = 11
    UNIMPLEMENTED = 12
    INTERNAL = 13
    UNAVAILABLE = 14
    DATA_LOSS = 15
    UNAUTHENTICATED = 16


def load():
    """The client library, built on first use."""
    return native_build.load("h2_client")


def bench_unary(
    address: str,
    path: str,
    payload: bytes,
    seconds: float,
    n_conns: int,
    max_lats: int = 100_000,
) -> Optional[Tuple[int, int, np.ndarray, bytes, int]]:
    """Run the closed loop; returns (rpcs, errors, latencies_s,
    first_response_grpc_frame, threads_connected), or None if it could
    not connect.  `errors` counts
    transport failures AND trailers-only grpc error replies."""
    lib = load()
    host, port = address.rsplit(":", 1)
    lats = np.zeros(max_lats, dtype=np.float64)
    stats = np.zeros(4, dtype=np.int64)
    resp = np.zeros(1 << 20, dtype=np.uint8)
    resp_len = np.zeros(1, dtype=np.int64)
    rc = lib.h2_bench_unary(
        host.encode(),
        int(port),
        path.encode(),
        host.encode(),
        payload,
        len(payload),
        float(seconds),
        int(n_conns),
        lats.ctypes.data,
        max_lats,
        stats.ctypes.data,
        resp.ctypes.data,
        len(resp),
        resp_len.ctypes.data,
    )
    if rc != 0:
        return None
    n_rec = int(stats[2])
    return (
        int(stats[0]),
        int(stats[1]),
        lats[:n_rec],
        resp[: int(resp_len[0])].tobytes(),
        int(stats[3]),
    )


def connscale(
    address: str,
    path: str,
    payload: bytes,
    seconds: float,
    n_conns: int,
    n_active: int,
    threads: int = 1,
    ramp_budget_s: float = 60.0,
    max_lats: int = 100_000,
) -> Optional[dict]:
    """Connection-scale load (PERF.md §26): hold `n_conns` open
    connections from `threads` epoll worker threads, run closed unary
    loops on the first `n_active` — the client-side mirror of the
    server's reactor front, cheap enough per connection to drive the
    C10K→C100K ramp without the generator itself starving the server's
    serve thread (the §25 trap).  The measurement window opens only
    after the connect ramp completes.  Returns a dict, or None when
    nothing connected."""
    lib = load()
    host, port = address.rsplit(":", 1)
    lats = np.zeros(max_lats, dtype=np.float64)
    stats = np.zeros(8, dtype=np.int64)
    rc = lib.h2_connscale_run(
        host.encode(),
        int(port),
        path.encode(),
        host.encode(),
        payload,
        len(payload),
        float(seconds),
        int(n_conns),
        int(n_active),
        int(threads),
        float(ramp_budget_s),
        lats.ctypes.data,
        max_lats,
        stats.ctypes.data,
    )
    if rc != 0:
        return None
    return {
        "rpcs": int(stats[0]),
        "errors": int(stats[1]),
        "lats_s": lats[: int(stats[2])],
        "connected": int(stats[3]),
        "alive_at_end": int(stats[4]),
        "ramp_ms": int(stats[5]),
    }


class UnaryChannel:
    """Unary gRPC calls to one peer over the port's own HTTP/2 client;
    safe to call from many threads at once."""

    def __init__(self, address: str):
        self._lib = load()
        host, _, port = address.rpartition(":")
        self.address = address
        self._handle = self._lib.h2c_channel_new(host.encode(), int(port))
        self._lock = threading.Lock()
        self._active = 0
        self._closed = False
        self._idle = threading.Condition(self._lock)

    def call(self, path: str, body: bytes, timeout: Optional[float]) -> Tuple[int, str, bytes]:
        """One unary call: (grpc status, grpc-message, response body).
        `timeout` in seconds; None or <= 0 waits without a deadline."""
        with self._lock:
            if self._closed:
                return 14, "channel closed", b""
            self._active += 1
        try:
            ms = max(1, int(timeout * 1000)) if timeout and timeout > 0 else 0
            res = self._lib.h2c_call(self._handle, path.encode(), body, len(body), ms)
            try:
                status = int(self._lib.h2c_result_status(res))
                out = []
                for which in (0, 1):
                    n = self._lib.h2c_result_len(res, which)
                    out.append(ctypes.string_at(self._lib.h2c_result_ptr(res, which), n)
                               if n else b"")
            finally:
                self._lib.h2c_result_free(res)
            return status, out[1].decode(errors="replace"), out[0]
        finally:
            with self._lock:
                self._active -= 1
                self._idle.notify_all()

    def stats(self) -> dict:
        """dials, calls, and the connections whose reader still runs."""
        out = np.zeros(3, dtype=np.int64)
        with self._lock:
            if self._closed:
                return {"dials": 0, "calls": 0, "live": 0}
            self._lib.h2c_channel_stats(self._handle, out.ctypes.data)
        return {"dials": int(out[0]), "calls": int(out[1]), "live": int(out[2])}

    def close(self, timeout: float = 5.0) -> None:
        """Wait (bounded) for running calls, then close the connections."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._idle.wait_for(lambda: self._active == 0, timeout)
            if self._active:
                # A call outlived the wait: its thread still uses the
                # channel, so leak it rather than free it under the call.
                return
        self._lib.h2c_channel_free(self._handle)
