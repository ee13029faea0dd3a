"""HTTP/JSON gateway over the port's V1Instance, stdlib only.

Port of `gubernator_tpu/net/gateway.py`: `POST /v1/GetRateLimits`,
`GET /v1/HealthCheck` and `GET /healthz`.  The JAX package marshals
with protobuf's `json_format`; the port writes the same JSON with the
`json` module, byte for byte what
`json_format.MessageToJson(msg, preserving_proto_field_name=True,
always_print_fields_with_no_presence=True)` prints: two-space indent,
snake_case names, every field present (the set ones first), int64 as
strings, enums by name.
Requests are read as `json_format.Parse(..., ignore_unknown_fields=True)`
reads them: snake_case or lowerCamelCase names, int64 as number or
string, enums as name or number.

Errors keep the grpc-gateway shape `{"code": …, "message": …}`: a body
that does not parse is HTTP 400 / code 3 (INVALID_ARGUMENT), a
ServiceError (an oversized batch) HTTP 400 / code 11 (OUT_OF_RANGE).

The debug routes (reference net/gateway.py:71-80, :139-215), each in the
reference's shape, live and disabled:

* `GET /debug/trace` — the tail flight recorder's dump
  (utils/flight_recorder.py; the daemon attaches one when the in-memory
  tracer runs, GUBER_TRACING=memory), else `{"enabled": false,
  "traces": []}`;
* `GET /debug/hotkeys` — the hot-key sketch's stats and top 50, else
  `{"enabled": false, "top": []}` (GUBER_HOTKEYS=0);
* `GET /debug/vars` — counters, the stage budget (real quantiles), the
  ledger's and the native event ring's stats, and the sections of the
  planes the port lacks (peer health, membership, handoff, replication,
  multi-region, GLOBAL queues), answered as the reference's daemon with
  no peers answers them: idle;
* `GET /debug/slo` — the SLO watchdog's status (obs/slo.py; GUBER_OBS),
  else `{"enabled": false}`.

`/metrics` stays with the gRPC front (prometheus_client), and
`/debug/fleet` with the peer planes.
"""

from __future__ import annotations

import json
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from gubernator_tpu_torch.service import ServiceError, V1Instance
from gubernator_tpu_torch.utils.metrics import DurationStat
from gubernator_tpu_torch.types import (
    Algorithm,
    Behavior,
    HealthCheckResp,
    RateLimitReq,
    RateLimitResp,
    Status,
)

_INT64_MIN, _INT64_MAX = -(1 << 63), (1 << 63) - 1
_INT32_MIN, _INT32_MAX = -(1 << 31), (1 << 31) - 1

# The proto enums by name (net/proto/gubernator.proto).  SKETCH is a
# Behavior bit with no proto name: on the wire it is a number.
_ALGORITHM = {a.name: int(a) for a in Algorithm}
_BEHAVIOR = {b.name: int(b) for b in Behavior if b is not Behavior.SKETCH}
_STATUS_NAME = {int(s): s.name for s in Status}

# RateLimitReq fields: proto name → (JSON camelCase name, kind)
_REQ_FIELDS = {
    "name": ("name", "string"),
    "unique_key": ("uniqueKey", "string"),
    "hits": ("hits", "int64"),
    "limit": ("limit", "int64"),
    "duration": ("duration", "int64"),
    "algorithm": ("algorithm", _ALGORITHM),
    "behavior": ("behavior", _BEHAVIOR),
    "burst": ("burst", "int64"),
}
# Either JSON name → (proto name, kind)
_FIELD_OF = {
    **{proto: (proto, kind) for proto, (_, kind) in _REQ_FIELDS.items()},
    **{camel: (proto, kind) for proto, (camel, kind) in _REQ_FIELDS.items()},
}
_INT_RE = re.compile(r"-?[0-9]+")
_FLOAT_RE = re.compile(r"-?([0-9]+\.?[0-9]*|\.[0-9]+)([eE][+-]?[0-9]+)?")


class ParseError(ValueError):
    """A request body that is not a valid GetRateLimitsReq."""


def _int(value, field: str, lo: int, hi: int) -> int:
    """An integer field: a JSON integer, an integral float, or a string
    of either (json_format's rules)."""
    bad = ParseError(f"Failed to parse {field} field: couldn't parse integer {value!r}")
    if isinstance(value, bool):
        raise bad
    if isinstance(value, str):
        if _INT_RE.fullmatch(value):
            value = int(value)
        elif _FLOAT_RE.fullmatch(value) and float(value).is_integer():
            value = int(float(value))
        else:
            raise bad
    elif isinstance(value, float):
        if not value.is_integer():
            raise bad
        value = int(value)
    elif not isinstance(value, int):
        raise bad
    if not lo <= value <= hi:
        raise ParseError(f"Failed to parse {field} field: value out of range {value}")
    return value


def _enum(value, names: dict, field: str):
    """An enum field: a known name, or any int32 number (proto3 enums are
    open).  An unknown name gives None: ignored, as unknown fields are."""
    if isinstance(value, str):
        if value in names:
            return names[value]
        if not _INT_RE.fullmatch(value):
            return None
    elif not isinstance(value, (int, float)) or value != value or value in (
        float("inf"), float("-inf")
    ):
        raise ParseError(f"Failed to parse {field} field: invalid enum value {value!r}")
    number = int(value)
    if not _INT32_MIN <= number <= _INT32_MAX:
        raise ParseError(f"Failed to parse {field} field: value out of range {number}")
    return number


def _parse_req(obj, where: str) -> RateLimitReq:
    if not isinstance(obj, dict):
        raise ParseError(f"Failed to parse {where}: expected an object, got {obj!r}")
    req = RateLimitReq()
    for key, value in obj.items():  # in body order: a repeated field's last value wins
        spec = _FIELD_OF.get(key)
        if spec is None or value is None:
            continue
        proto, kind = spec
        field = f"{where}.{proto}"
        if kind == "string":
            if not isinstance(value, str):
                raise ParseError(f"Failed to parse {field} field: expected a string")
        elif kind == "int64":
            value = _int(value, field, _INT64_MIN, _INT64_MAX)
        else:
            value = _enum(value, kind, field)
            if value is None:
                continue
        setattr(req, proto, value)
    return req


def parse_get_rate_limits_req(body: bytes) -> list[RateLimitReq]:
    """A GetRateLimitsReq JSON body → its RateLimitReq list."""
    try:
        doc = json.loads(body or b"{}")
    except ValueError as e:
        raise ParseError(f"Failed to load JSON: {e}") from None
    if not isinstance(doc, dict):
        if doc in ("", []):  # json_format reads an empty document as an empty message
            return []
        raise ParseError(f"Failed to parse GetRateLimitsReq: expected an object, got {doc!r}")
    items = doc.get("requests")
    if items is None:
        return []
    if not isinstance(items, list):
        raise ParseError("Failed to parse requests field: repeated field must be a list")
    if any(item is None for item in items):
        raise ParseError(
            "Failed to parse requests field: null is not allowed to be used as an "
            "element in a repeated field"
        )
    return [_parse_req(item, f"GetRateLimitsReq.requests[{k}]") for k, item in enumerate(items)]


def _proto_order(fields) -> dict:
    """A message's JSON object in json_format's key order: the fields
    that hold a non-default value first, then the default-valued ones,
    each group in field-number order.  `fields` = [(name, value,
    is_default)] in field-number order."""
    return {
        name: value
        for group in (False, True)
        for name, value, is_default in fields
        if is_default == group
    }


def _resp_obj(r: RateLimitResp) -> dict:
    st, limit, rem, reset = int(r.status), int(r.limit), int(r.remaining), int(r.reset_time)
    return _proto_order([
        ("status", _STATUS_NAME.get(st, st), st == 0),
        ("limit", str(limit), limit == 0),
        ("remaining", str(rem), rem == 0),
        ("reset_time", str(reset), reset == 0),
        ("error", r.error, not r.error),
        ("metadata", {k: r.metadata[k] for k in sorted(r.metadata)}, not r.metadata),
    ])


def get_rate_limits_resp_json(resps) -> bytes:
    """Responses → the GetRateLimitsResp JSON the JAX gateway prints."""
    return json.dumps({"responses": [_resp_obj(r) for r in resps]}, indent=2).encode()


def health_check_resp_json(h: HealthCheckResp) -> bytes:
    peers = int(h.peer_count)
    return json.dumps(
        _proto_order([
            ("status", h.status, not h.status),
            ("message", h.message, not h.message),
            ("peer_count", peers, peers == 0),
        ]),
        indent=2,
    ).encode()


def _idle_planes(inst: V1Instance) -> dict:
    """The /debug/vars sections of the planes a node with no peers runs
    idle (reference net/gateway.py:180-215 over its daemon with one
    member): no peer to report, one stable membership epoch, no handoff,
    no replica lease (the reference's daemon starts its replication plane
    only with the hot-key sketch), no region, no GLOBAL queue."""
    handoff = {"shipped": 0, "forfeited": 0, "received": 0}
    idle = DurationStat().snapshot_ms()
    out = {
        "peer_health": {},
        "membership": {"epoch": 1, "phase": "stable", "peers": 1,
                       "dual_window_seconds": 0.0, "handoff": dict(handoff)},
        "handoff": dict(handoff),
        "multiregion": {"windows": 0, "region_sends": 0, "region_sends_by": {},
                        "hits_requeued": 0, "hits_dropped": 0, "region_attempts": {},
                        "pending": 0, "pending_retry": 0, "backlog_age_s": 0.0,
                        "region_states": {}, "window_wait": dict(idle),
                        "region_rpc": dict(idle)},
        "global": {"hits_pending": 0, "broadcasts_pending": 0, "async_sends": 0,
                   "broadcasts": 0},
    }
    if inst.hotkeys is not None:
        out["replication"] = {k: 0 for k in (
            "promoted", "demoted", "grants_sent", "grants_failed", "grants_received",
            "revokes_received", "stale_dropped", "expired", "answered", "credit_granted",
            "credit_returned", "credit_forfeited", "promoted_keys", "replica_leases")}
    return out


def debug_trace(inst: V1Instance) -> dict:
    """/debug/trace: the flight recorder's retained tail trees."""
    fr = inst.flight_recorder
    if fr is None:
        return {"enabled": False, "traces": []}
    out = fr.dump()
    out["enabled"] = True
    return out


def debug_hotkeys(inst: V1Instance) -> dict:
    """/debug/hotkeys: the sketch's stats and its top 50 keys."""
    hk = inst.hotkeys
    if hk is None:
        return {"enabled": False, "top": []}
    out = hk.stats()
    out["enabled"] = True
    out["top"] = [{"key": key.decode(errors="replace"), "count": count, "err": err}
                  for key, count, err in hk.top(50)]
    return out


def debug_vars(inst: V1Instance) -> dict:
    """/debug/vars: one snapshot of the node's live internals."""
    out: dict = {"counters": dict(inst.counters),
                 "stage_budget": {stage: stat.snapshot_ms()
                                  for stage, stat in inst.stage_timers.items()}}
    if inst.ledger is not None:
        # The ledger's read-only tier caches GLOBAL broadcasts from peers:
        # empty on a node with no peers, as the reference reports it.
        out["ledger"] = {**inst.ledger.stats(), "readonly_entries": 0}
    if inst.native_events is not None:
        out["native_events"] = inst.native_events.stats()
    out.update(_idle_planes(inst))
    out["cache_size"] = inst.engine.cache_size()
    return out


def debug_slo(inst: V1Instance) -> dict:
    """/debug/slo: the watchdog's SLIs, burns, headroom and breaches."""
    wd = inst.slo_watchdog
    if wd is None:
        return {"enabled": False}
    return wd.status()


_DEBUG_ROUTES = {
    "/debug/trace": debug_trace,
    "/debug/hotkeys": debug_hotkeys,
    "/debug/vars": debug_vars,
    "/debug/slo": debug_slo,
}


class _Handler(BaseHTTPRequestHandler):
    instance: V1Instance  # set by Gateway
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # quiet by default
        pass

    def _reply(self, code: int, body: bytes) -> None:
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _reply_error(self, http_code: int, grpc_code: int, message: str) -> None:
        self._reply(http_code, json.dumps({"code": grpc_code, "message": message}).encode())

    def do_GET(self):  # noqa: N802 (stdlib naming)
        path = self.path.split("?", 1)[0]
        if path in ("/v1/HealthCheck", "/healthz"):
            self._reply(200, health_check_resp_json(self.instance.health_check()))
        elif path in _DEBUG_ROUTES:
            self._reply(200, json.dumps(_DEBUG_ROUTES[path](self.instance)).encode())
        else:
            self._reply_error(404, 5, "not found")

    def do_POST(self):  # noqa: N802
        path = self.path.split("?", 1)[0]
        length = int(self.headers.get("Content-Length", "0"))
        body = self.rfile.read(length)
        if path != "/v1/GetRateLimits":
            self._reply_error(404, 5, "not found")
            return
        try:
            reqs = parse_get_rate_limits_req(body)
            resps = self.instance.get_rate_limits(reqs)
        except ParseError as e:
            self._reply_error(400, 3, str(e))  # INVALID_ARGUMENT
        except ServiceError as e:
            self._reply_error(400, 11, str(e))  # OUT_OF_RANGE
        else:
            self._reply(200, get_rate_limits_resp_json(resps))


class Gateway:
    """The HTTP listener; `address` is host:port (port 0 picks one)."""

    def __init__(self, instance: V1Instance, address: str):
        host, _, port = address.rpartition(":")
        handler = type("BoundHandler", (_Handler,), {"instance": instance})
        self._server = ThreadingHTTPServer((host or "0.0.0.0", int(port)), handler)
        self._server.daemon_threads = True
        self._thread = threading.Thread(
            target=self._server.serve_forever, name=f"guber-gateway-{address}", daemon=True
        )

    @property
    def port(self) -> int:
        return self._server.server_address[1]

    @property
    def address(self) -> str:
        host, port = self._server.server_address[:2]
        return f"{host}:{port}"

    def start(self) -> None:
        self._thread.start()

    def close(self) -> None:
        if self._thread.is_alive():
            self._server.shutdown()  # returns once serve_forever has stopped
            self._thread.join(timeout=5.0)
        self._server.server_close()
