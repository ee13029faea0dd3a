"""The port's /metrics against the JAX package's.

* The writer (utils/exposition.py) against prometheus_client, byte for
  byte, in both formats, on hypothesis-made families: counters (with and
  without `_total`), gauges, summaries and histograms, with and without
  labels, HELP text with `\\`, newlines and quotes, label values with
  quotes, values among ±Inf, NaN, 0.0, 1e21 and 1e-9, and bucket
  exemplars.
* The parity test: one seeded request stream, over HTTP, into a
  reference daemon and a port daemon (`device="cpu"`), both on a frozen
  clock and with GUBER_METRIC_FLAGS=all; then the port's /metrics text
  against `generate_latest` of the reference's registry.  Every family is
  there, in order, with its HELP, TYPE, label names, label sets and
  values, except what differs by design, each named in `VALUE_EXCEPTIONS`,
  `PORT_ONLY_STAGES`, `time_valued` and the test itself.
* The status listener, the metric flags, `?exemplars=1` and `?fleet=1`,
  and that a scrape launches nothing on the engine.
"""

from __future__ import annotations

import json
import random
import re
import urllib.error
import urllib.request

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from prometheus_client import generate_latest as prom_generate_latest
from prometheus_client.metrics_core import Metric as PromMetric
from prometheus_client.openmetrics.exposition import generate_latest as prom_generate_om
from prometheus_client.samples import Exemplar as PromExemplar
from prometheus_client.utils import floatToGoString

from gubernator_tpu.clock import Clock as RefClock
from gubernator_tpu.config import DaemonConfig as RefConfig
from gubernator_tpu.daemon import spawn_daemon as ref_spawn
from gubernator_tpu_torch.clock import Clock
from gubernator_tpu_torch.config import DaemonConfig
from gubernator_tpu_torch.daemon import spawn_daemon
from gubernator_tpu_torch.ops import fused_step as fs
from gubernator_tpu_torch.utils import exposition as ex
from gubernator_tpu_torch.utils import tracing as port_tracing
from gubernator_tpu_torch.utils.metrics import build_registry

# ---------------------------------------------------------------------
# The writer, byte for byte


class _Listed:
    """A collector over fixed families."""

    def __init__(self, families):
        self.families = families

    def collect(self):
        return list(self.families)


def _registries(families):
    """The same families as a port registry and as prometheus_client
    Metric objects (the writer's input either way)."""
    port = ex.CollectorRegistry()
    port.register(_Listed(families))
    prom = []
    for f in families:
        m = PromMetric(f.name, f.documentation, f.type)
        for s in f.samples:
            e = None if s.exemplar is None else PromExemplar(s.exemplar.labels, s.exemplar.value)
            m.add_sample(s.name, s.labels, s.value, exemplar=e)
        prom.append(m)
    return port, _Listed(prom)


def _assert_same_bytes(families):
    port, prom = _registries(families)
    assert ex.generate_latest(port) == prom_generate_latest(prom)
    assert ex.generate_openmetrics(port) == prom_generate_om(prom)


SPECIAL = [float("inf"), float("-inf"), float("nan"), 0.0, -0.0, 1e21, 1e-9, 1.0, 7, 0.1,
           1234567.0, 12345678.9, 100000.0, 999999.0, 1e6, -1e6, 5e-324, 1.7976931348623157e308,
           2**53, 3.0e-5]
_FLOATS = st.one_of(st.sampled_from(SPECIAL), st.floats(allow_nan=True, allow_infinity=True),
                    st.integers(-2**60, 2**60))
_NAME = st.from_regex(r"[a-zA-Z_:][a-zA-Z0-9_:]{0,16}", fullmatch=True)
_LABEL = st.from_regex(r"[a-zA-Z_][a-zA-Z0-9_]{0,8}", fullmatch=True).filter(lambda s: s != "le")
_TEXT = st.text(st.one_of(st.sampled_from('\\\n"{}=,# '), st.characters(exclude_categories=("Cs",))),
                max_size=24)


@st.composite
def _family(draw):
    kind = draw(st.sampled_from(["counter", "gauge", "summary", "histogram"]))
    name = draw(_NAME)
    if kind == "counter" and draw(st.booleans()):
        name += "_total"
    doc = draw(_TEXT)
    labels = draw(st.lists(_LABEL, max_size=3, unique=True))
    n_series = draw(st.integers(0 if labels else 1, 3))
    cls = {"counter": ex.CounterMetricFamily, "gauge": ex.GaugeMetricFamily,
           "summary": ex.SummaryMetricFamily, "histogram": ex.HistogramMetricFamily}[kind]
    fam = cls(name, doc, labels=labels)
    for _ in range(n_series if labels else 1):
        values = [draw(_TEXT) for _ in labels]
        if kind in ("counter", "gauge"):
            fam.add_metric(values, draw(_FLOATS))
        elif kind == "summary":
            fam.add_metric(values, draw(st.integers(0, 10**9)), draw(_FLOATS))
        else:
            bounds = sorted(draw(st.lists(st.floats(0, 1e6), max_size=5, unique=True)))
            cum, buckets = 0, []
            for le in [f"{b:.9g}" for b in bounds] + ["+Inf"]:
                cum += draw(st.integers(0, 1000))
                if draw(st.booleans()):
                    exemplar = ex.Exemplar({"trace_id": draw(_TEXT)}, draw(_FLOATS))
                    buckets.append((le, float(cum), exemplar))
                else:
                    buckets.append((le, float(cum)))
            fam.add_metric(values, buckets, draw(st.one_of(st.none(), _FLOATS)))
    return fam


@settings(max_examples=200, deadline=None)
@given(families=st.lists(_family(), max_size=5))
def test_writer_equals_prometheus_client_byte_for_byte(families):
    _assert_same_bytes(families)


@pytest.mark.parametrize("value", SPECIAL)
def test_float_format_equals_prometheus_client(value):
    assert ex.float_to_go_string(value) == floatToGoString(value)


def test_counter_total_suffix_and_empty_families():
    c = ex.CounterMetricFamily("reqs_total", "Requests.", labels=["code"])
    c.add_metric(["200"], 3)
    assert c.name == "reqs" and c.samples[0].name == "reqs_total"
    fams = [c, ex.GaugeMetricFamily("g", 'a "quoted"\\help\nline', labels=["a"]),
            ex.SummaryMetricFamily("s", "S.", count_value=2, sum_value=0.5),
            ex.HistogramMetricFamily("h", "H.", buckets=[("1", 1.0), ("+Inf", 2.0)],
                                     sum_value=1.5)]
    _assert_same_bytes(fams)
    port, _ = _registries(fams)
    text = ex.generate_latest(port).decode()
    assert "# TYPE reqs_total counter\nreqs_total{code=\"200\"} 3.0\n" in text
    om = ex.generate_openmetrics(port).decode()
    assert "# TYPE reqs counter\n" in om and om.endswith("# EOF\n")
    assert "_created" not in text + om


# ---------------------------------------------------------------------
# Parity: one stream into a reference daemon and a port daemon

T0 = 1_700_000_000_000_000_000
FLAGS = ["all"]


def _post(addr: str, items) -> dict:
    req = urllib.request.Request(f"http://{addr}/v1/GetRateLimits",
                                 data=json.dumps({"requests": items}).encode(), method="POST")
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def _get(addr: str, path: str):
    with urllib.request.urlopen(f"http://{addr}{path}", timeout=60) as r:
        return r.read(), r.headers["Content-Type"]


def _stream(seed=5):
    """Six batches of 20 over 12 keys: token and leaky buckets, repeats
    within a batch, keys that run over their limit."""
    rng = random.Random(seed)
    return [[{"name": "par", "unique_key": f"k{rng.randrange(12)}", "hits": rng.randrange(1, 6),
              "limit": 10, "duration": 60_000, "algorithm": rng.choice([0, 1])}
             for _ in range(20)] for _ in range(6)]


_SAMPLE_RE = re.compile(r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(.*)\})? (\S+)$')
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def parse(text: str):
    """Prometheus text 0.0.4 → [(family, help, type, [(sample, labels,
    value)])], in order."""
    fams = []
    for line in text.splitlines():
        if line.startswith("# HELP "):
            name, _, doc = line[7:].partition(" ")
            fams.append([name, doc, None, []])
        elif line.startswith("# TYPE "):
            fams[-1][2] = line.split()[3]
        else:
            m = _SAMPLE_RE.match(line)
            assert m, line
            fams[-1][3].append((m.group(1), dict(_LABEL_RE.findall(m.group(2) or "")),
                                m.group(3)))
    return fams


# What differs by design, each by name.  A sample is skipped by value
# (label sets still compared) when its family is in VALUE_EXCEPTIONS or
# `time_valued` says so.
VALUE_EXCEPTIONS = {
    # ROADMAP C notes, C2: the reference's GLOBAL read-back is an engine
    # call of its own; the port's rides in the batch's call.
    "gubernator_engine_batches_total": "batches_total (C2)",
    # XLA compiles; there is no XLA on the port's CUDA path: always 0.
    "gubernator_jit_recompiles_total": "jit_recompiles",
}
# The port's engine always has its pump and so its window-wait stage;
# the reference's has one only while its pump runs.
PORT_ONLY_STAGES = {"device.window_wait"}
STAGE_FAMILIES = {"gubernator_stage_duration", "gubernator_stage_quantile_seconds",
                  "gubernator_stage_seconds"}


def time_valued(family: str, sample: str, labels: dict) -> bool:
    """Samples that hold a time (or count the observations of one on the
    device path, where the reference's daemon adds its warmup ladder's
    launches): compared by presence only."""
    if family.startswith(("process_", "python_")):
        return True  # the process's own values: shape only
    if sample.endswith("_sum"):
        return True  # every summary and histogram here sums seconds
    if family in ("gubernator_stage_quantile_seconds",) or sample.endswith("_bucket"):
        return True
    if sample == "gubernator_engine_round_duration_count":
        return True  # device.step's count, warmup included in the reference
    if family in STAGE_FAMILIES and labels.get("stage", "").startswith("device."):
        return True
    return False


@pytest.fixture(scope="module")
def parity():
    """Both daemons after one stream, scraped once each; the port's
    status listener too."""
    mp = pytest.MonkeyPatch()
    mp.delenv("GUBER_OBS", raising=False)
    stream = _stream()
    ref = ref_spawn(RefConfig(grpc_listen_address="127.0.0.1:0",
                              http_listen_address="127.0.0.1:0", cache_size=1024,
                              sweep_interval=0, metric_flags=FLAGS),
                    clock=RefClock().freeze_at(T0))
    port = None
    try:
        port = spawn_daemon(DaemonConfig(http_listen_address="127.0.0.1:0", cache_size=1024,
                                         sweep_interval=0.0, metric_flags=FLAGS,
                                         http_status_listen_address="127.0.0.1:0"),
                            clock=Clock().freeze_at(T0), device="cpu")
        answers = [(_post(ref.http_address, b), _post(port.http_address, b)) for b in stream]
        want = prom_generate_latest(ref.registry).decode()
        got, ctype = _get(port.http_address, "/metrics")
        status, status_ctype = _get(port.status_gateway.address, "/metrics")
        yield dict(answers=answers, want=want, got=got.decode(), ctype=ctype,
                   status=status.decode(), status_ctype=status_ctype,
                   ref_addr=ref.grpc_address, port_addr=port.http_address)
    finally:
        if port is not None:
            port.close()
        ref.close()
        mp.undo()


def test_parity_stream_answers_alike(parity):
    for want, got in parity["answers"]:
        assert got == want
    assert any(r["status"] == "OVER_LIMIT" for want, _ in parity["answers"]
               for r in want["responses"])


def test_metrics_parity_with_the_reference(parity):
    want, got = parse(parity["want"]), parse(parity["got"])
    assert parity["ctype"] == "text/plain; version=0.0.4; charset=utf-8"
    assert [f[0] for f in got] == [f[0] for f in want]
    gub = [f for f in want if f[0].startswith("gubernator_")]
    assert len(gub) == 57, [f[0] for f in gub]
    compared = skipped = 0
    for (name, doc, typ, w), (_, gdoc, gtyp, g) in zip(want, got):
        assert (gdoc, gtyp) == (doc, typ), name
        if name.startswith("gubernator_grpc_request_"):
            # The reference's spawn_daemon probes its own gRPC health
            # once; no gRPC call reaches the port, which has no server.
            assert g == [] and all("HealthCheck" in s[1]["method"] for s in w), name
            continue
        if name == "gubernator_queue_length":
            # The node itself is its only peer: its own address.
            assert [s[1] for s in w] == [{"peer": parity["ref_addr"]}]
            assert [s[1] for s in g] == [{"peer": parity["port_addr"]}]
            assert [s[2] for s in g] == [s[2] for s in w]
            continue
        if name in STAGE_FAMILIES:
            extra = {s[1]["stage"] for s in g} - {s[1]["stage"] for s in w}
            assert extra <= PORT_ONLY_STAGES, extra
            g = [s for s in g if s[1].get("stage") not in extra]
        if name.startswith("python_gc_"):
            assert [s[1] for s in g] == [s[1] for s in w]
        elif name == "python_info":
            assert g == w
        assert [(s[0], s[1]) for s in g] == [(s[0], s[1]) for s in w], name
        for (sname, labels, wv), (_, _, gv) in zip(w, g):
            if name in VALUE_EXCEPTIONS or time_valued(name, sname, labels):
                skipped += 1
                continue
            compared += 1
            assert gv == wv, (sname, labels, gv, wv)
    assert compared > 80 and skipped > 0
    # The counted values that matter most, by name.
    for line in ("gubernator_check_counter_total 120.0", "gubernator_cache_size 12.0"):
        assert line in parity["got"] and line in parity["want"]
    over = [s for f in got if f[0] == "gubernator_over_limit_counter_total" for s in f[3]]
    assert float(over[0][2]) > 0


def test_status_listener_serves_the_same_families(parity):
    assert parity["status_ctype"] == parity["ctype"]
    assert [(f[0], f[1], f[2]) for f in parse(parity["status"])] == \
        [(f[0], f[1], f[2]) for f in parse(parity["got"])]


def test_writer_equals_prometheus_client_on_the_daemons_families(parity):
    """The port daemon's own families (one collect), through both
    writers: the same bytes in both formats."""
    d = spawn_daemon(DaemonConfig(http_listen_address="127.0.0.1:0", cache_size=256,
                                  sweep_interval=0.0, metric_flags=FLAGS), device="cpu")
    try:
        _post(d.http_address, _stream(7)[0])
        _assert_same_bytes(list(d.registry.collect()))
    finally:
        d.close()


# ---------------------------------------------------------------------
# Flags, exemplars, fleet, the status listener


def _family_names(text: str):
    return [f[0] for f in parse(text)]


@pytest.mark.parametrize("flags,want", [
    ([], set()), (["os"], {"process"}), (["python"], {"python"}), (["golang"], {"python"}),
    (["all"], {"process", "python"}), (["OS", " python "], {"process", "python"})])
def test_metric_flags_add_the_process_families(flags, want):
    from prometheus_client import CollectorRegistry, GCCollector, PlatformCollector, \
        ProcessCollector

    d = spawn_daemon(DaemonConfig(http_listen_address="127.0.0.1:0", cache_size=64,
                                  sweep_interval=0.0, metric_flags=flags), device="cpu")
    try:
        text = _get(d.http_address, "/metrics")[0].decode()
    finally:
        d.close()
    names = _family_names(text)
    extra = [n for n in names if not n.startswith("gubernator_")]
    prom = CollectorRegistry()
    if "process" in want:
        ProcessCollector(registry=prom)
    if "python" in want:
        GCCollector(registry=prom)
        PlatformCollector(registry=prom)
    ref = parse(prom_generate_latest(prom).decode())
    got = [f for f in parse(text) if f[0] in extra]
    # Names, HELP, TYPE, sample names and label names as prometheus_client's.
    assert [(f[0], f[1], f[2]) for f in got] == [(f[0], f[1], f[2]) for f in ref]
    for (_, _, _, g), (_, _, _, w) in zip(got, ref):
        assert [(s[0], sorted(s[1])) for s in g] == [(s[0], sorted(s[1])) for s in w]
    # The families come before the gRPC pair, as the reference registers them.
    assert names[-2:] == ["gubernator_grpc_request_counts_total",
                          "gubernator_grpc_request_duration"]


def test_status_listener_health_and_close():
    d = spawn_daemon(DaemonConfig(http_listen_address="127.0.0.1:0", cache_size=64,
                                  sweep_interval=0.0, http_status_listen_address="127.0.0.1:0"),
                     device="cpu")
    addr = d.status_gateway.address
    try:
        assert json.loads(_get(addr, "/healthz")[0])["status"] == "healthy"
        assert _family_names(_get(addr, "/metrics")[0].decode()) == \
            _family_names(_get(d.http_address, "/metrics")[0].decode())
    finally:
        d.close()
    with pytest.raises(OSError):
        _get(addr, "/healthz")


def test_exemplars_only_in_openmetrics():
    """With the in-memory tracer on, the stage histogram's buckets carry
    trace exemplars in the OpenMetrics text (`?exemplars=1`) and never in
    the classic text."""
    port_tracing.set_tracer(port_tracing.InMemoryTracer())
    d = spawn_daemon(DaemonConfig(http_listen_address="127.0.0.1:0", cache_size=256,
                                  sweep_interval=0.0), device="cpu")
    try:
        for batch in _stream(11):
            _post(d.http_address, batch)
        om, ctype = _get(d.http_address, "/metrics?exemplars=1")
        classic, _ = _get(d.http_address, "/metrics")
    finally:
        d.close()
        port_tracing.set_tracer(None)
    assert ctype == "application/openmetrics-text; version=1.0.0; charset=utf-8"
    om = om.decode()
    assert om.endswith("# EOF\n") and om.count("# EOF") == 1
    ex_lines = [ln for ln in om.splitlines() if ' # {trace_id="' in ln]
    assert ex_lines and all(ln.startswith("gubernator_stage_seconds_bucket{") for ln in ex_lines)
    assert b"trace_id" not in classic
    assert "# TYPE gubernator_check_counter counter" in om


@pytest.mark.parametrize("obs", ["1", "0"])
def test_fleet_appends_the_rollup(monkeypatch, obs):
    monkeypatch.setenv("GUBER_OBS", obs)
    d = spawn_daemon(DaemonConfig(http_listen_address="127.0.0.1:0", cache_size=64,
                                  sweep_interval=0.0), device="cpu")
    try:
        _post(d.http_address, _stream(3)[0])
        plain = _get(d.http_address, "/metrics")[0].decode()
        fleet = _get(d.http_address, "/metrics?fleet=1")[0].decode()
        both = _get(d.http_address, "/metrics?fleet=1&exemplars=1")[0].decode()
        off = _get(d.http_address, "/metrics?fleet=0")[0].decode()
    finally:
        d.close()
    fleet_fams = ["gubernator_fleet_nodes", "gubernator_fleet_counter_total",
                  "gubernator_fleet_gauge", "gubernator_fleet_stage_quantile_seconds",
                  "gubernator_fleet_scrape"]
    assert _family_names(off) == _family_names(plain)
    assert not any(n.startswith("gubernator_fleet_") for n in _family_names(plain))
    if obs == "0":
        # No rollup without GUBER_OBS: nothing appended.
        assert _family_names(fleet) == _family_names(plain)
        assert both.count("# EOF") == 1
        return
    assert _family_names(fleet) == _family_names(plain) + fleet_fams
    assert 'gubernator_fleet_scrape{outcome="ok"} 1.0' in fleet
    assert 'gubernator_fleet_counter_total{counter="checks",region="default"} 20.0' in fleet
    assert both.count("# EOF") == 1 and both.endswith("# EOF\n")
    assert "# TYPE gubernator_fleet_counter counter" in both


def test_a_scrape_launches_nothing():
    """Every value a scrape reads is a host counter: the engine's
    dispatch, round and batch counts, the launch counts and the device
    state's version are the same before and after several scrapes."""
    d = spawn_daemon(DaemonConfig(http_listen_address="127.0.0.1:0", cache_size=256,
                                  sweep_interval=0.0, metric_flags=["all"],
                                  http_status_listen_address="127.0.0.1:0"), device="cpu")
    try:
        _post(d.http_address, _stream(9)[0])
        eng = d.instance.engine

        def counts():
            return (eng.dispatches_total, eng.rounds_total, eng.batches_total,
                    dict(fs.launches), eng._pump.submitted, eng._pump.flushes)

        before = counts()
        for path in ("/metrics", "/metrics?exemplars=1", "/metrics?fleet=1"):
            _get(d.http_address, path)
            _get(d.status_gateway.address, path)
        build_registry(d.instance, ["all"]).collect()
        assert counts() == before
    finally:
        d.close()


def test_gateway_without_a_registry_answers_404():
    from gubernator_tpu_torch.net.gateway import Gateway

    d = spawn_daemon(DaemonConfig(http_listen_address="127.0.0.1:0", cache_size=64,
                                  sweep_interval=0.0), device="cpu")
    gw = Gateway(d.instance, "127.0.0.1:0")
    gw.start()
    try:
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(gw.address, "/metrics")
        assert e.value.code == 404
    finally:
        gw.close()
        d.close()
