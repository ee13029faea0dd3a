"""The port's HTTP gateway against the JAX package's JSON contract.

The port writes its JSON with the `json` module; the JAX package's
gateway prints `json_format.MessageToJson(serde...to_pb(...),
preserving_proto_field_name=True, always_print_fields_with_no_presence=True)`.
For the same responses the bytes must be equal, and a request body
printed by protobuf must parse to the same requests.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
from google.protobuf import json_format

from gubernator_tpu.net import serde
from gubernator_tpu.net.pb import gubernator_pb2 as pb
from gubernator_tpu.types import HealthCheckResp as RefHealth
from gubernator_tpu.types import RateLimitReq as RefReq
from gubernator_tpu.types import RateLimitResp as RefResp
from gubernator_tpu_torch.clock import Clock
from gubernator_tpu_torch.config import DaemonConfig
from gubernator_tpu_torch.core.engine import DecisionEngine
from gubernator_tpu_torch.daemon import spawn_daemon
from gubernator_tpu_torch.net.gateway import Gateway, ParseError, parse_get_rate_limits_req
from gubernator_tpu_torch.service import V1Instance
from gubernator_tpu_torch.types import MAX_BATCH_SIZE, Behavior, RateLimitReq

T0_NS = 1_760_000_000_000 * 1_000_000
_JSON_OPTS = dict(preserving_proto_field_name=True, always_print_fields_with_no_presence=True)


def _pb_json(msg) -> bytes:
    return json_format.MessageToJson(msg, **_JSON_OPTS).encode()


def _to_ref(resps):
    return [
        RefResp(status=int(r.status), limit=r.limit, remaining=r.remaining,
                reset_time=r.reset_time, error=r.error, metadata=dict(r.metadata))
        for r in resps
    ]


def _post(url, body: bytes):
    req = urllib.request.Request(url, data=body, method="POST",
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _get(url):
    with urllib.request.urlopen(url, timeout=30) as r:
        return r.status, r.read()


@pytest.fixture
def served():
    """A gateway on 127.0.0.1:0 over a CPU engine, plus a twin instance
    (same clock instant) for computing the expected responses."""
    inst = V1Instance(DecisionEngine(4096, clock=Clock().freeze_at(T0_NS), device="cpu"))
    twin = V1Instance(DecisionEngine(4096, clock=Clock().freeze_at(T0_NS), device="cpu"))
    gw = Gateway(inst, "127.0.0.1:0")
    gw.start()
    try:
        yield f"http://127.0.0.1:{gw.port}", twin
    finally:
        gw.close()


def _rand_reqs(rng, n):
    reqs = []
    for i in range(n):
        beh = int(rng.choice([0, 0, 0, int(Behavior.RESET_REMAINING),
                              int(Behavior.DURATION_IS_GREGORIAN), int(Behavior.GLOBAL)]))
        reqs.append(RateLimitReq(
            name="" if i == 3 else "api",
            unique_key="" if i == 5 else f"user-{int(rng.integers(40))}",
            hits=int(rng.choice([-2, 0, 1, 3, 2**40])),
            limit=int(rng.choice([0, 5, 100, 2**62])),
            duration=int(rng.choice([1, 7])) if beh & 4 else int(rng.choice([10, 60_000])),
            algorithm=int(rng.integers(0, 2)),
            behavior=beh,
            burst=int(rng.choice([0, 3])),
        ))
    return reqs


@pytest.mark.parametrize("camel", [False, True])
def test_get_rate_limits_bytes_equal_protobuf_json(served, camel):
    url, twin = served
    rng = np.random.default_rng(7 + camel)
    for _ in range(4):
        reqs = _rand_reqs(rng, 60)
        body = json_format.MessageToJson(
            serde.get_rate_limits_req_to_pb([RefReq(**vars(r)) for r in reqs]),
            preserving_proto_field_name=not camel,
        ).encode()
        code, got = _post(url + "/v1/GetRateLimits", body)
        assert code == 200
        want = _pb_json(serde.get_rate_limits_resp_to_pb(_to_ref(twin.get_rate_limits(reqs))))
        assert got == want
    errors = {r["error"] for r in json.loads(got)["responses"]}
    assert "field 'namespace' cannot be empty" in errors


def test_request_parsing_matches_json_format():
    """Bodies protobuf prints and hand-written variants (int64 as number
    or string, enums by name or number, unknown fields) parse to the
    requests json_format.Parse gives."""
    bodies = [
        b'{"requests": [{"name": "a", "uniqueKey": "k", "hits": "3", "limit": 10,'
        b' "duration": "60000", "algorithm": "LEAKY_BUCKET", "behavior": 12, "burst": 2.0}]}',
        b'{"requests": [{"name": "a", "unique_key": "k", "behavior": "GLOBAL",'
        b' "algorithm": 1, "extra": {"x": [1]}}], "other": 1}',
        b'{"requests": [{"name": "a", "algorithm": "NOT_A_NAME", "hits": "-9223372036854775808"}]}',
        b'{"requests": [{"unique_key": "a", "uniqueKey": "b", "hits": "1e3", "limit": "1.0",'
        b' "algorithm": 1.5, "burst": null, "name": null}, {"algorithm": true, "behavior": "2"}]}',
        b'{}',
        b'',
        b'""',
        b'[]',
        b'{"requests": null}',
    ]
    for body in bodies:
        msg = json_format.Parse(body or b"{}", pb.GetRateLimitsReq(), ignore_unknown_fields=True)
        want = [vars(serde.rate_limit_req_from_pb(m)) for m in msg.requests]
        got = [vars(r) for r in parse_get_rate_limits_req(body)]
        assert [{k: int(v) if isinstance(v, int) else v for k, v in d.items()} for d in got] == [
            {k: int(v) if isinstance(v, int) else v for k, v in d.items()} for d in want
        ], body
    for bad in [b"[", b"null", b"0", b"[1]", b'{"requests": {}}', b'{"requests": "x"}',
                b'{"requests": [null]}', b'{"requests": [1]}',
                b'{"requests": [{"hits": 1.5}]}', b'{"requests": [{"hits": "x"}]}',
                b'{"requests": [{"hits": " 7"}]}', b'{"requests": [{"hits": "1.5"}]}',
                b'{"requests": [{"hits": true}]}', b'{"requests": [{"name": 3}]}',
                b'{"requests": [{"hits": 9223372036854775808}]}',
                b'{"requests": [{"algorithm": 99999999999}]}',
                b'{"requests": [{"algorithm": [1]}]}']:
        with pytest.raises(json_format.ParseError):
            json_format.Parse(bad, pb.GetRateLimitsReq(), ignore_unknown_fields=True)
        with pytest.raises(ParseError):
            parse_get_rate_limits_req(bad)


def test_error_shapes_and_health(served):
    url, _ = served
    code, body = _post(url + "/v1/GetRateLimits", b"{not json")
    assert code == 400 and json.loads(body)["code"] == 3
    big = json.dumps({"requests": [{"name": "a", "unique_key": str(i), "hits": 1}
                                   for i in range(MAX_BATCH_SIZE + 1)]}).encode()
    code, body = _post(url + "/v1/GetRateLimits", big)
    assert code == 400
    assert json.loads(body) == {
        "code": 11,
        "message": f"Requests.RateLimits list too large; max size is '{MAX_BATCH_SIZE}'",
    }
    want = _pb_json(serde.health_check_resp_to_pb(RefHealth(status="healthy")))
    for path in ("/v1/HealthCheck", "/healthz"):
        assert _get(url + path) == (200, want)
    code, body = _post(url + "/v1/Nope", b"{}")
    assert code == 404 and json.loads(body)["code"] == 5


def test_daemon_serves_and_closes():
    d = spawn_daemon(DaemonConfig(http_listen_address="127.0.0.1:0", cache_size=1024),
                     clock=Clock().freeze_at(T0_NS), device="cpu")
    try:
        body = json.dumps({"requests": [{"name": "a", "unique_key": "k", "hits": 2,
                                         "limit": 5, "duration": 1000}]}).encode()
        code, got = _post(f"http://{d.http_address}/v1/GetRateLimits", body)
        assert code == 200
        assert json.loads(got)["responses"][0]["remaining"] == "3"
    finally:
        d.close()
    assert not d.gateway._thread.is_alive()


def test_daemon_binary_exits_cleanly_on_sigterm():
    env = dict(os.environ, GUBER_HTTP_ADDRESS="127.0.0.1:0", GUBER_CACHE_SIZE="256")
    proc = subprocess.Popen(
        [sys.executable, "-m", "gubernator_tpu_torch.cmd.daemon", "--device", "cpu"],
        cwd=Path(__file__).resolve().parent.parent, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )
    try:
        line = proc.stdout.readline()
        assert line.startswith("listening http="), (line, proc.stderr.read())
        addr = line.strip().split("=", 1)[1]
        code, _ = _get(f"http://{addr}/healthz")
        assert code == 200
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
        proc.stdout.close()
        proc.stderr.close()
