"""The port daemon's debug routes against the JAX daemon's.

The reference's tests/test_trace_stitch.py:435-520 (live data; the
disabled shapes) run on the port's daemon (`spawn_daemon` on the CPU) and
on the reference's one-node cluster daemon, and the JSON of each route —
/debug/trace, /debug/hotkeys, /debug/vars, /debug/slo — is held to the
reference's: the same keys at every level that does not depend on the
traffic, the same disabled answers.
"""

from __future__ import annotations

import json
import urllib.request

import pytest

from gubernator_tpu.cluster.harness import ClusterHarness
from gubernator_tpu.types import RateLimitReq as RefReq
from gubernator_tpu.utils import tracing as ref_tracing
from gubernator_tpu_torch.config import DaemonConfig
from gubernator_tpu_torch.daemon import spawn_daemon
from gubernator_tpu_torch.utils import tracing as port_tracing

ROUTES = ("/debug/trace", "/debug/hotkeys", "/debug/vars", "/debug/slo")


def _get(addr: str, path: str) -> dict:
    with urllib.request.urlopen(f"http://{addr}{path}", timeout=10) as r:
        return json.loads(r.read())


def _post(addr: str, items) -> dict:
    body = json.dumps({"requests": items}).encode()
    req = urllib.request.Request(f"http://{addr}/v1/GetRateLimits", data=body, method="POST")
    with urllib.request.urlopen(req, timeout=10) as r:
        return json.loads(r.read())


def _items(n=5):
    return [{"name": "dbg", "unique_key": f"k{i}", "hits": 3, "limit": 100,
             "duration": 60_000} for i in range(n)]


def _reference_routes(live: bool) -> dict:
    """The JAX daemon's four routes after 5 items through its instance."""
    ref_tracing.set_tracer(ref_tracing.InMemoryTracer() if live else None)
    h = ClusterHarness().start(1, cache_size=1024)
    try:
        h.daemon_at(0).instance.get_rate_limits(
            [RefReq(name="dbg", unique_key=f"k{i}", hits=3, limit=100, duration=60_000)
             for i in range(5)])
        addr = h.daemon_at(0).http_address
        return {p: _get(addr, p) for p in ROUTES}
    finally:
        h.stop()
        ref_tracing.set_tracer(None)


def _port_routes(live: bool, **conf) -> dict:
    port_tracing.set_tracer(port_tracing.InMemoryTracer() if live else None)
    d = spawn_daemon(DaemonConfig(http_listen_address="127.0.0.1:0", cache_size=1024,
                                  sweep_interval=0.0, **conf), device="cpu")
    try:
        _post(d.http_address, _items())
        return {p: _get(d.http_address, p) for p in ROUTES}
    finally:
        d.close()
        port_tracing.set_tracer(None)


@pytest.fixture(scope="module")
def live(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    mp.setenv("GUBER_TRACE_TAIL_MIN_MS", "0")
    mp.setenv("GUBER_TRACE_TAIL_FACTOR", "0")
    try:
        yield _reference_routes(True), _port_routes(True)
    finally:
        mp.undo()


@pytest.fixture(scope="module")
def disabled():
    mp = pytest.MonkeyPatch()
    mp.setenv("GUBER_HOTKEYS", "0")
    mp.setenv("GUBER_OBS", "0")
    try:
        yield _reference_routes(False), _port_routes(False)
    finally:
        mp.undo()


def test_debug_vars_live(live):
    ref, port = live
    want, got = ref["/debug/vars"], port["/debug/vars"]
    assert set(got) == set(want)
    assert got["counters"]["local"] >= 5 and set(got["counters"]) == set(want["counters"])
    budget = got["stage_budget"]
    # The port's engine always has its pump; the reference's has one when
    # GUBER_PUMP is on (tests/conftest.py sets it).
    assert set(budget) == set(want["stage_budget"]) | {"device.window_wait"}
    for stage, q in budget.items():
        assert set(q) == {"count", "mean_ms", "p50_ms", "p99_ms", "max_ms"}, stage
    assert budget["device.step"]["count"] >= 1 and budget["device.readback"]["count"] >= 1
    for section in ("ledger", "membership", "handoff", "replication", "multiregion", "global"):
        assert set(got[section]) == set(want[section]), section
    # The planes a node with no peers runs idle answer as the reference's.
    for section in ("peer_health", "membership", "handoff", "replication", "global"):
        assert got[section] == want[section], section
    assert got["cache_size"] == want["cache_size"] == 5


def test_debug_hotkeys_live(live):
    ref, port = live
    want, got = ref["/debug/hotkeys"], port["/debug/hotkeys"]
    assert got["enabled"] and set(got) == set(want)
    assert any(r["key"].startswith("dbg_") for r in got["top"])
    assert all(set(r) == {"key", "count", "err"} for r in got["top"])
    assert sorted(got["top"], key=lambda r: r["key"]) == \
        sorted(want["top"], key=lambda r: r["key"])


def test_debug_trace_live(live):
    ref, port = live
    want, got = ref["/debug/trace"], port["/debug/trace"]
    assert got["enabled"] and set(got) == set(want)
    assert got["recorded"] >= 1 and got["traces"]
    tree = got["traces"][-1]
    assert set(tree) == set(want["traces"][-1])
    assert tree["spans"] and tree["trace_id"]
    names = {s["name"] for s in tree["spans"]}
    assert "service.get_rate_limits" in names
    assert any(n.startswith("engine.") for n in names)
    assert set(tree["spans"][0]) == set(want["traces"][-1]["spans"][0])


def test_debug_slo_live(live):
    ref, port = live
    want, got = ref["/debug/slo"], port["/debug/slo"]
    assert got["enabled"] and set(got) == set(want)
    assert got["slis"] == want["slis"] and got["pairs"] == want["pairs"]


def test_debug_routes_disabled_shapes(disabled):
    ref, port = disabled
    assert port["/debug/trace"] == ref["/debug/trace"] == {"enabled": False, "traces": []}
    assert port["/debug/hotkeys"] == ref["/debug/hotkeys"] == {"enabled": False, "top": []}
    assert port["/debug/slo"] == ref["/debug/slo"] == {"enabled": False}
    assert set(port["/debug/vars"]) == set(ref["/debug/vars"])
    assert "stage_budget" in port["/debug/vars"]


def test_unknown_debug_route_is_not_found():
    d = spawn_daemon(DaemonConfig(http_listen_address="127.0.0.1:0", cache_size=64,
                                  sweep_interval=0.0), device="cpu")
    try:
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(d.http_address, "/debug/fleet")
        assert e.value.code == 404
    finally:
        d.close()
