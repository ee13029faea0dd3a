"""ctypes wrapper for the native h2 gRPC client load loop
(csrc/h2_client.cpp).

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

from typing import Optional, Tuple

import numpy as np

from gubernator_tpu_torch.ops import native_build


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
