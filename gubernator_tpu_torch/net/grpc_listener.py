"""The port's gRPC listener: V1 and PeersV1/GetPeerRateLimits on one
address, over the port's own HTTP/2 server in routing mode
(csrc/h2_server.cpp `h2s_start_routed`), with no grpcio.

The counterpart of the JAX package's `net/grpc_service.py:75
add_v1_to_server` and `:93 add_peers_v1_to_server` with
`net/server.py:102 GrpcV1Adapter` and `:146 GrpcPeersV1Adapter`.  The C
side decodes each request's header block (HPACK, csrc/hpack.h), routes
its `:path` and calls `_handle` once per RPC on one of `workers` threads
(GUBER_GRPC_WORKERS); a path with no route is answered UNIMPLEMENTED
there, with the path in grpc-message.  That includes the PeersV1 methods
of the GLOBAL, handoff, replication and fleet planes (UpdatePeerGlobals,
TransferBuckets, ReplicateKeys, ObsSnapshot), which this port does not
serve yet (ROADMAP A entry 4).

Each GetRateLimits / GetPeerRateLimits tries the reference's routes in
its order: first the columnar decode (`net/wire_codec.py`) served by
`V1Instance.serve_wire_columnar` when every key is owned here (a
GetPeerRateLimits skips that check: its sender picked this node as the
owner); otherwise the full decode (`net/proto_codec.py`) and
`get_rate_limits` / `get_peer_rate_limits`.  A body that is not a valid
message gets INTERNAL "Exception deserializing request!", as grpcio's
deserializer gives it; a `ServiceError` its code (OUT_OF_RANGE for an
oversized batch).  The reference's group-commit window for wire batches
(`serve_wire_bytes` with `net/wire_window.py`) is not here: it changes
no answer, and comes with the grpcio half of the front (ROADMAP A entry
5).
"""

from __future__ import annotations

import ctypes
import logging
import socket
import threading
from typing import Tuple

import numpy as np

from gubernator_tpu_torch.core.h2_client import StatusCode
from gubernator_tpu_torch.net import proto_codec, wire_codec
from gubernator_tpu_torch.ops import native_build
from gubernator_tpu_torch.service import COLUMNAR_DISQUALIFIERS, ServiceError
from gubernator_tpu_torch.types import MAX_BATCH_SIZE

log = logging.getLogger("gubernator_tpu_torch.grpc")

# The route table, in route-id order.
ROUTES = (proto_codec.GET_RATE_LIMITS, proto_codec.HEALTH_CHECK,
          proto_codec.GET_PEER_RATE_LIMITS)

Reply = Tuple[int, str, bytes]


def _bind_host(host: str) -> str:
    """The IPv4 address the listener binds for a listen address's host:
    "" and "0.0.0.0" every interface, a name its first IPv4 address."""
    if host in ("", "0.0.0.0"):
        return ""
    return socket.gethostbyname(host)


class GrpcListener:
    """V1 and PeersV1/GetPeerRateLimits for one V1Instance at `address`
    ("host:port", port 0 = ephemeral), on one accept lane with a thread a
    connection, and `workers` handler threads."""

    def __init__(self, instance, address: str, workers: int = 32):
        self.instance = instance
        self._lib = native_build.load("h2_server")
        host, _, port = address.rpartition(":")
        self._cb = native_build.ROUTE_CALLBACK(self._handle)
        self._handle_ptr = self._lib.h2s_start_routed(
            _bind_host(host).encode(), int(port or 0), "\n".join(ROUTES).encode(),
            max(1, int(workers)), self._cb,
        )
        if not self._handle_ptr:
            raise OSError(f"failed to bind gRPC on {address}")
        self.port = int(self._lib.h2s_port(self._handle_ptr))
        self.address = f"{host}:{self.port}"
        self._lock = threading.Lock()
        # Handler calls a route (the C side answers other paths itself).
        self._calls = [0] * len(ROUTES)

    # -- the per-RPC entry (the C route threads) ------------------------

    def _handle(self, route, body_ptr, length, timeout_ms, token) -> None:
        with self._lock:
            self._calls[route] += 1
        try:
            body = ctypes.string_at(body_ptr, length) if length else b""
            status, msg, out = self._serve(int(route), body)
        except Exception as e:  # noqa: BLE001 — never unwind into C
            log.exception("gRPC handler failed")
            status, msg, out = StatusCode.UNKNOWN, f"Exception calling application: {e}", b""
        m = msg.encode()
        self._lib.h2s_route_reply(token, int(status), m, len(m), out, len(out))

    def _serve(self, route: int, body: bytes) -> Reply:
        if route == 1:
            try:
                proto_codec.decode_health_check_req(body)
            except proto_codec.DecodeError:
                return StatusCode.INTERNAL, "Exception deserializing request!", b""
            return (StatusCode.OK, "",
                    proto_codec.encode_health_check_resp(self.instance.health_check()))
        peer = route == 2
        out = self._columnar(body, check_ownership=not peer)
        if out is not None:
            return StatusCode.OK, "", out
        try:
            reqs = proto_codec.decode_get_rate_limits_req(body)
        except proto_codec.DecodeError:
            return StatusCode.INTERNAL, "Exception deserializing request!", b""
        try:
            if peer:
                resps = self.instance.get_peer_rate_limits(reqs)
            else:
                resps = self.instance.get_rate_limits(reqs)
        except ServiceError as e:
            return StatusCode[e.code], str(e), b""
        return StatusCode.OK, "", proto_codec.encode_get_rate_limits_resp(resps)

    def _columnar(self, body: bytes, *, check_ownership: bool):
        """The columnar route's response bytes, or None to take the full
        decode (a batch it cannot serve: disqualifying behaviours, empty
        fields, malformed bytes, keys owned elsewhere, a store)."""
        if self.instance.engine.store is not None:
            return None
        dec = wire_codec.decode_reqs(body, MAX_BATCH_SIZE, COLUMNAR_DISQUALIFIERS)
        if dec is None:
            return None
        out = self.instance.serve_wire_columnar(dec, check_ownership=check_ownership)
        if out is None:
            return None
        return wire_codec.encode_resps(*out)

    # -- lifecycle -------------------------------------------------------

    def stats(self) -> dict:
        """RPCs answered OK and with an error status, open connections
        (zeros once closed), and the handler's calls by route path."""
        out = np.zeros(16, dtype=np.int64)
        with self._lock:
            if self._handle_ptr:
                self._lib.h2s_stats(self._handle_ptr, out.ctypes.data)
            calls = dict(zip(ROUTES, self._calls))
        return {"rpcs": int(out[0]), "errors": int(out[2]), "conns_open": int(out[7]),
                "calls": calls}

    def close(self) -> None:
        """Stop: h2s_stop joins the route threads (no handler runs once
        it returns) and the connection threads."""
        with self._lock:
            handle, self._handle_ptr = self._handle_ptr, None
        if handle:
            self._lib.h2s_stop(handle)
