"""The port's observability modules against the JAX package's.

The port keeps its own copies of the reference's tracing
(`utils/tracing.py`), flight recorder, duration histograms
(`utils/metrics.py DurationStat`), logging setup, SLO watchdog and
admission watch (`obs/slo.py`) and the local rollup (`obs/fleet.py`).
These are the reference's tests, run on both packages where a test
exercises module code (parametrized `ref` / `port`), and on the port
alone where they read a port object:

* tests/test_tracing.py:38-120 — the no-op tracer, and the engine spans
  (`engine.batch`, `engine.round`, `engine.collapsed`, `engine.columnar`,
  `engine.sweep`) of the dense and the sharded engine, whose span trees
  (names, nesting, attributes) are compared with the JAX engines' on the
  same streams, trace by trace;
* tests/test_trace_stitch.py:77-110 (traceparent codec, parenting) and
  :521-638 (DurationStat quantiles and bucket edges, the flight
  recorder's adaptive threshold, trace ids in log lines);
* tests/test_obs.py:121-460 (exact merges, concurrent observers,
  exemplars, admission watch, watchdog burns, bounds and status; the
  merge of snapshots equal to the reference's);
* tests/test_observability.py:11 and :136 (the no-op span without init;
  GUBER_LOG_LEVEL / GUBER_LOG_FORMAT).
"""

from __future__ import annotations

import json
import logging
import threading
import time

import jax
import numpy as np
import pytest

from gubernator_tpu import obs as _ref_obs_pkg  # noqa: F401 (the reference's obs package)
from gubernator_tpu.clock import Clock as RefClock
from gubernator_tpu.core.engine import DecisionEngine as RefEngine
from gubernator_tpu.obs import fleet as ref_fleet
from gubernator_tpu.obs import slo as ref_slo
from gubernator_tpu.parallel.mesh import make_mesh
from gubernator_tpu.parallel.sharded_engine import ShardedDecisionEngine as RefSharded
from gubernator_tpu.service import V1Instance as RefInstance
from gubernator_tpu.types import RateLimitReq as RefReq
from gubernator_tpu.utils import flight_recorder as ref_fr
from gubernator_tpu.utils import logging_setup as ref_logging
from gubernator_tpu.utils import metrics as ref_metrics
from gubernator_tpu.utils import tracing as ref_tracing
from gubernator_tpu_torch.clock import Clock
from gubernator_tpu_torch.core.engine import DecisionEngine
from gubernator_tpu_torch.obs import fleet as port_fleet
from gubernator_tpu_torch.obs import slo as port_slo
from gubernator_tpu_torch.parallel.sharded_engine import ShardedDecisionEngine
from gubernator_tpu_torch.service import V1Instance
from gubernator_tpu_torch.types import RateLimitReq
from gubernator_tpu_torch.utils import flight_recorder as port_fr
from gubernator_tpu_torch.utils import logging_setup as port_logging
from gubernator_tpu_torch.utils import metrics as port_metrics
from gubernator_tpu_torch.utils import tracing as port_tracing

T0_NS = 1_760_000_000_123 * 1_000_000

PKGS = {
    "ref": dict(tracing=ref_tracing, metrics=ref_metrics, fr=ref_fr, slo=ref_slo,
                fleet=ref_fleet, logging=ref_logging),
    "port": dict(tracing=port_tracing, metrics=port_metrics, fr=port_fr, slo=port_slo,
                 fleet=port_fleet, logging=port_logging),
}


@pytest.fixture(params=["ref", "port"])
def pkg(request):
    """One package's modules, with its tracing disabled around the test."""
    m = PKGS[request.param]
    m["tracing"].set_tracer(None)
    yield m
    m["tracing"].set_tracer(None)


@pytest.fixture
def tracers():
    """An in-memory tracer installed in each package: (ref, port)."""
    ref, port = ref_tracing.InMemoryTracer(), port_tracing.InMemoryTracer()
    ref_tracing.set_tracer(ref)
    port_tracing.set_tracer(port)
    yield ref, port
    ref_tracing.set_tracer(None)
    port_tracing.set_tracer(None)


def _trees(tracer):
    """The finished spans grouped by trace, in order of each trace's first
    span: [[(name, parent name, attributes), ...] a trace]."""
    order, by = [], {}
    for s in tracer.spans():
        if s.trace_id not in by:
            order.append(s.trace_id)
            by[s.trace_id] = []
        by[s.trace_id].append((s.name, s.parent, dict(s.attributes)))
    return [by[t] for t in order]


def _req(cls, key, hits=1, limit=10, duration=60_000, **kw):
    return cls(name="trace", unique_key=key, hits=hits, limit=limit, duration=duration, **kw)


def _engines(capacity=256):
    ref = RefEngine(capacity=capacity, clock=RefClock().freeze_at(T0_NS))
    port = DecisionEngine(capacity, clock=Clock().freeze_at(T0_NS), device="cpu")
    return ref, port


def _cols(n, prefix):
    return ([(prefix + "%d" % i).encode() for i in range(n)], np.zeros(n, np.int32),
            np.zeros(n, np.int32), np.ones(n, np.int64), np.full(n, 10, np.int64),
            np.full(n, 1_000, np.int64), np.zeros(n, np.int64))


# ----------------------------------------------------------------------
# tests/test_tracing.py:38-120 and tests/test_observability.py:11


def test_disabled_tracing_is_noop(pkg):
    tr = pkg["tracing"]
    with tr.span("anything", batch=1) as s:
        assert s is None
    assert tr.current_tracer() is None
    assert tr.current_context() is None and tr.current_trace_id() == ""
    tr.add_event("nothing", k=1)  # no tracer: no effect, no error


def test_engine_batch_and_round_spans(tracers):
    """Rounds forced (no collapse): one engine.batch {batch 4, rounds 2}
    with engine.round children {round, width}, as the JAX engine's."""
    ref_t, port_t = tracers
    ref, port = _engines()
    ref._collapse_dataclass = lambda *a, **k: False
    port._collapse_dataclass = lambda *a, **k: None
    ref.get_rate_limits([_req(RefReq, k) for k in "abac"])
    port.get_rate_limits([_req(RateLimitReq, k) for k in "abac"])
    batches = port_t.spans("engine.batch")
    assert len(batches) == 1 and batches[0].attributes == {"batch": 4, "rounds": 2}
    rounds = port_t.spans("engine.round")
    assert [s.attributes["round"] for s in rounds] == [0, 1]
    assert [s.attributes["width"] for s in rounds] == [3, 1]
    assert all(s.parent == "engine.batch" for s in rounds)
    assert all(s.end_ns >= s.start_ns for s in rounds)
    assert _trees(port_t) == _trees(ref_t)


def test_engine_collapsed_span(tracers):
    ref_t, port_t = tracers
    ref, port = _engines()
    ref.get_rate_limits([_req(RefReq, k) for k in "abac"])
    port.get_rate_limits([_req(RateLimitReq, k) for k in "abac"])
    collapsed = port_t.spans("engine.collapsed")
    assert len(collapsed) == 1 and collapsed[0].attributes == {"width": 4}
    assert collapsed[0].parent == "engine.batch"
    assert _trees(port_t) == _trees(ref_t)


def test_columnar_and_sweep_spans(tracers):
    ref_t, port_t = tracers
    ref, port = _engines()
    n = 8
    ref.apply_columnar(*_cols(n, "col"))
    port.apply_columnar(*_cols(n, "col"))
    cols = port_t.spans("engine.columnar")
    assert len(cols) == 1 and cols[0].attributes["batch"] == n
    for e in (ref, port):
        e.clock.advance(ms=5_000)
    assert ref.sweep() == port.sweep() == n
    sweeps = port_t.spans("engine.sweep")
    assert len(sweeps) == 1 and sweeps[0].attributes["freed"] == n
    assert _trees(port_t) == _trees(ref_t)


def _stream(rng, n_batches, pool, cls):
    """Dataclass batches with repeats (rounds, collapses), config changes
    (collapse declined) and evictions (a pool past capacity)."""
    out = []
    for b in range(n_batches):
        size = int(rng.integers(1, 40))
        keys = rng.integers(0, pool, size)
        if b % 3 == 0:
            keys[: size // 2] = keys[0]  # a hot key
        limits = rng.choice([10, 10, 20], size) if b % 4 == 1 else np.full(size, 10)
        out.append([_req(cls, "k%d" % k, hits=int(rng.integers(0, 3)), limit=int(lim))
                    for k, lim in zip(keys.tolist(), limits.tolist())])
    return out


def test_engine_span_trees_equal_the_jax_engines_on_a_stream(tracers):
    """A mixed stream through both engines: the dataclass batches (rounds,
    collapses, evictions at capacity 64), columnar batches and sweeps give
    the same span trees, trace by trace."""
    ref_t, port_t = tracers
    ref, port = _engines(capacity=64)
    rng = np.random.default_rng(5)
    for b, batch in enumerate(_stream(rng, 24, 150, RefReq)):
        ref.get_rate_limits(batch)
        port.get_rate_limits([RateLimitReq(**{f: getattr(r, f) for f in (
            "name", "unique_key", "hits", "limit", "duration")}) for r in batch])
        if b % 6 == 5:
            for e in (ref, port):
                e.apply_columnar(*_cols(12, "c%d_" % b))
                e.clock.advance(ms=700)
                e.sweep()
    assert len(_trees(port_t)) > 30
    assert _trees(port_t) == _trees(ref_t)


def test_sharded_engine_spans(tracers):
    """The sharded engines (the reference's on 2 virtual devices, the
    port's 2 shards on one device): the same trees for a collapsing batch
    and for the forced rounds path."""
    ref_t, port_t = tracers
    if len(jax.devices()) < 2:
        pytest.skip("needs >=2 virtual devices")
    ref = RefSharded(shard_capacity=128, mesh=make_mesh(jax.devices()[:2]),
                     clock=RefClock().freeze_at(T0_NS))
    port = ShardedDecisionEngine(128, n_shards=2, clock=Clock().freeze_at(T0_NS), device="cpu")
    ref.get_rate_limits([_req(RefReq, k) for k in ("sa", "sb", "sa")])
    port.get_rate_limits([_req(RateLimitReq, k) for k in ("sa", "sb", "sa")])
    batches = port_t.spans("engine.batch")
    assert len(batches) == 1 and batches[0].attributes == {"batch": 3, "rounds": 2}
    assert len(port_t.spans("engine.collapsed")) == 1
    for t in tracers:
        t.clear()
    ref._collapse_dataclass_sharded = lambda *a, **k: False
    port._collapse_dataclass_sharded = lambda *a, **k: False
    ref.get_rate_limits([_req(RefReq, k) for k in ("sa2", "sb2", "sa2")])
    port.get_rate_limits([_req(RateLimitReq, k) for k in ("sa2", "sb2", "sa2")])
    assert len(port_t.spans("engine.round")) == 2
    ref.apply_columnar(*_cols(6, "sc"))
    port.apply_columnar(*_cols(6, "sc"))
    assert _trees(port_t) == _trees(ref_t)


def test_service_span_wraps_the_engine(tracers):
    """service.get_rate_limits {batch} is the root; the engine's spans its
    children, as under the reference's V1Instance."""
    ref_t, port_t = tracers
    from gubernator_tpu.config import BehaviorConfig
    from gubernator_tpu.config import Config as RefConfig

    ref_eng, port_eng = _engines()
    ref = RefInstance(RefConfig(behaviors=BehaviorConfig(global_sync_wait=3600.0,
                                                         adaptive_windows=False)),
                      ref_eng)
    port = V1Instance(port_eng)
    try:
        ref.get_rate_limits([_req(RefReq, k) for k in "xyx"])
        port.get_rate_limits([_req(RateLimitReq, k) for k in "xyx"])
        roots = port_t.spans("service.get_rate_limits")
        assert len(roots) == 1 and roots[0].attributes == {"batch": 3}
        assert port_t.spans("engine.batch")[0].parent == "service.get_rate_limits"
        assert _trees(port_t) == _trees(ref_t)
    finally:
        ref.close()
        port.close()


# ----------------------------------------------------------------------
# tests/test_trace_stitch.py:77-110


def test_traceparent_roundtrip(pkg):
    tr = pkg["tracing"]
    ctx = tr.TraceContext(trace_id="ab" * 16, span_id="cd" * 8, sampled=True)
    tp = tr.format_traceparent(ctx)
    assert tp == f"00-{'ab' * 16}-{'cd' * 8}-01"
    assert tr.parse_traceparent(tp) == ctx


@pytest.mark.parametrize("bad", [
    "", "00-zz-cd-01", "00-abc-def-01", "garbage",
    "00-" + "ab" * 16 + "-" + "cd" * 8,
    "00-" + "gg" * 16 + "-" + "cd" * 8 + "-01",
])
def test_traceparent_rejects_malformed(pkg, bad):
    assert pkg["tracing"].parse_traceparent(bad) is None


def test_remote_parent_and_parent_ctx(pkg):
    tr = pkg["tracing"]
    tr.set_tracer(tr.InMemoryTracer())
    with tr.span("outer.root") as root:
        ctx = tr.current_context()
        assert ctx.trace_id == root.trace_id
    with tr.span("cross.thread", parent_ctx=ctx) as child:
        assert child.trace_id == root.trace_id
        assert child.parent_span_id == root.span_id
        assert not child.remote
    remote = tr.parse_traceparent(tr.format_traceparent(ctx))
    with tr.span("remote.server", remote_parent=remote) as srv:
        assert srv.trace_id == root.trace_id
        assert srv.parent_span_id == root.span_id
        assert srv.remote
    md = (("traceparent", tr.format_traceparent(ctx)),)
    assert tr.remote_parent_from_metadata(md) == remote


# ----------------------------------------------------------------------
# tests/test_trace_stitch.py:521-638: DurationStat, the flight recorder,
# log lines


def test_duration_stat_quantiles(pkg):
    DS = pkg["metrics"].DurationStat
    s = DS()
    assert s.p50() == 0.0 and s.p99() == 0.0
    for _ in range(90):
        s.observe(0.001)
    for _ in range(10):
        s.observe(0.512)
    assert 0.0005 < s.p50() < 0.002
    assert 0.25 < s.p99() < 1.1
    assert s.max == 0.512 and s.count == 100
    m = DS()
    counts = [0] * DS.N_BUCKETS
    counts[DS.bucket_of(0.001)] = 90
    counts[DS.bucket_of(0.512)] = 10
    m.observe_bucket_counts(counts)
    assert m.count == 100
    assert 0.0005 < m.p50() < 0.002
    assert 0.25 < m.p99() < 1.1


def test_duration_stat_bucket_edges(pkg):
    DS = pkg["metrics"].DurationStat
    assert DS.bucket_of(0.0) == 0
    assert DS.bucket_of(1e-9) == 0
    assert DS.bucket_of(1e6) == DS.N_BUCKETS - 1
    prev = -1
    for e in range(-7, 3):
        b = DS.bucket_of(10.0 ** e)
        assert b >= prev
        prev = b


def test_duration_stat_equals_the_reference_observation_for_observation():
    """The same observations give the same snapshot, quantiles and
    buckets in both packages."""
    rng = np.random.default_rng(3)
    obs = np.exp(rng.uniform(np.log(1e-7), np.log(30.0), 2000)).tolist()
    a, b = ref_metrics.DurationStat(), port_metrics.DurationStat()
    for x in obs:
        a.observe(x)
        b.observe(x)
    assert a.bucket_snapshot() == b.bucket_snapshot()
    assert a.snapshot_ms() == b.snapshot_ms()
    for q in (0.0, 0.5, 0.9, 0.99, 1.0):
        assert a.quantile(q) == b.quantile(q)


def test_duration_stat_batch_observe_keeps_count_and_total():
    """The port's `observe(seconds, count)` (paging times a batch of
    faults once): count and total as `count` observations of the mean."""
    s = port_metrics.DurationStat()
    s.observe(0.008, 4)
    assert s.count == 4 and s.total == 0.008 and s.max == 0.002
    assert s.buckets[port_metrics.DurationStat.bucket_of(0.002)] == 4
    s.observe(1.0, 0)
    assert s.count == 4


def test_flight_recorder_adaptive_threshold(pkg):
    tr = pkg["tracing"]
    tracer = tr.InMemoryTracer()
    tr.set_tracer(tracer)
    fr = pkg["fr"].FlightRecorder(tracer, factor=2.0, min_ms=20.0, cap=4)
    for _ in range(5):
        with tr.span("fast.root"):
            pass
    assert fr.dump()["recorded"] == 0
    with tr.span("slow.root"):
        with tr.span("slow.child"):
            time.sleep(0.03)
    dump = fr.dump()
    assert dump["recorded"] == 1
    tree = dump["traces"][0]
    assert {s["name"] for s in tree["spans"]} == {"slow.root", "slow.child"}
    assert tree["duration_ms"] >= 20
    for _ in range(10):
        with tr.span("slow.root2"):
            time.sleep(0.025)
    assert len(fr.dump()["traces"]) <= 4
    assert set(fr.dump()) == set(ref_fr.FlightRecorder(ref_tracing.InMemoryTracer()).dump())
    fr.close()
    assert tracer.on_root_finish is None


def test_flight_recorder_from_env(pkg, monkeypatch):
    monkeypatch.setenv("GUBER_TRACE_TAIL_FACTOR", "0")
    monkeypatch.setenv("GUBER_TRACE_TAIL_MIN_MS", "0")
    monkeypatch.setenv("GUBER_TRACE_TAIL_CAP", "3")
    tr = pkg["tracing"]
    tracer = tr.InMemoryTracer()
    tr.set_tracer(tracer)
    fr = pkg["fr"].FlightRecorder.from_env(tracer)
    for _ in range(5):
        with tr.span("every.root"):
            pass
    d = fr.dump()
    assert d["recorded"] == 5 and len(d["traces"]) == 3 and d["threshold_ms"] == 0.0
    fr.close()


def test_log_lines_carry_trace_id(pkg, capsys, monkeypatch):
    tr = pkg["tracing"]
    tr.set_tracer(tr.InMemoryTracer())
    monkeypatch.setenv("GUBER_LOG_FORMAT", "json")
    try:
        pkg["logging"].configure_logging()
        log = logging.getLogger("stitch.test")
        with tr.span("logged.op") as s:
            log.warning("inside")
            tid = s.trace_id
        log.warning("outside")
        lines = [json.loads(line) for line in capsys.readouterr().err.strip().splitlines()
                 if line]
        inside = next(x for x in lines if x["msg"] == "inside")
        outside = next(x for x in lines if x["msg"] == "outside")
        assert inside["trace_id"] == tid
        assert "trace_id" not in outside
    finally:
        logging.getLogger().handlers[:] = []


# tests/test_observability.py:136


def test_log_level_and_format_env(pkg, capsys, monkeypatch):
    monkeypatch.setenv("GUBER_LOG_FORMAT", "json")
    monkeypatch.setenv("GUBER_LOG_LEVEL", "warn")
    try:
        pkg["logging"].configure_logging()
        log = logging.getLogger("obs.test")
        log.info("hidden")
        log.warning("shown %d", 7)
        lines = [line for line in capsys.readouterr().err.strip().splitlines() if line]
        assert len(lines) == 1
        rec = json.loads(lines[0])
        assert rec["level"] == "warning" and rec["msg"] == "shown 7"
        assert rec["logger"] == "obs.test"
        assert set(rec) == {"time", "level", "logger", "msg"}
    finally:
        logging.getLogger().handlers[:] = []


# ----------------------------------------------------------------------
# tests/test_obs.py:121-460


def _snap(addr, region, counters=None, hists=None, admitted=None):
    return {"v": 1, "addr": addr, "region": region, "counters": counters or {}, "gauges": {},
            "hists": hists or {}, "admitted": admitted or {}}


def _hist_of(metrics, observations):
    d = metrics.DurationStat()
    for x in observations:
        d.observe(x)
    return d.bucket_snapshot()


def test_fleet_merge_sums_counters_and_merges_histograms_as_the_reference(pkg):
    """Counters sum per region and in all; histograms merge bucket for
    bucket (a real p99, not a mean of means); the merged rollup equals
    the reference's on the same snapshots."""
    fast = _hist_of(pkg["metrics"], [0.001] * 99)
    slow = _hist_of(pkg["metrics"], [0.512] * 99)
    snaps = [
        _snap("a:1", "east", {"checks": 10, "check_errors": 1}, {"window_wait": fast},
              {"k": {"admitted": 3, "limit": 10}}),
        _snap("a:2", "east", {"checks": 20}, {"window_wait": slow},
              {"k": {"admitted": 4, "limit": 12}}),
        _snap("b:1", "west", {"checks": 5, "check_errors": 2}),
    ]
    merged = pkg["fleet"].FleetCollector.merge(snaps)
    assert merged["counters"]["checks"] == 35 and merged["counters"]["check_errors"] == 3
    assert merged["regions"]["east"]["nodes"] == 2
    assert merged["regions"]["east"]["counters"]["checks"] == 30
    assert len(merged["nodes"]) == 3
    q = merged["quantiles"]["window_wait"]
    assert q["count"] == 198 and 0.5 < q["p50_ms"] < 2.0 and 250.0 < q["p99_ms"] < 1100.0
    assert merged["admitted"]["k"] == {"admitted": 7, "limit": 12, "nodes": 2}
    assert merged == ref_fleet.FleetCollector.merge(snaps)


def test_duration_stat_merge_snapshot_exact(pkg):
    DS = pkg["metrics"].DurationStat
    a, b = DS(), DS()
    for x in (0.001, 0.002, 0.1):
        a.observe(x)
    for x in (0.0005, 0.25):
        b.observe(x)
    m = DS()
    m.merge_snapshot(a.bucket_snapshot())
    m.merge_snapshot(b.bucket_snapshot())
    assert m.count == 5
    assert m.max == 0.25
    assert abs(m.total - 0.3535) < 1e-12
    assert sum(m.buckets) == 5


def test_observe_bucket_counts_concurrent_observers(pkg):
    DS = pkg["metrics"].DurationStat
    stat = DS()
    n_threads, per_thread = 8, 200
    counts = [0] * DS.N_BUCKETS
    counts[DS.bucket_of(0.004)] = 3
    counts[DS.bucket_of(0.512)] = 2
    barrier = threading.Barrier(n_threads)

    def worker(tid):
        barrier.wait()
        for i in range(per_thread):
            if (tid + i) % 2:
                stat.observe_bucket_counts(counts)
            else:
                stat.observe(0.001)

    threads = [threading.Thread(target=worker, args=(t,)) for t in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    merges = sum(1 for t in range(n_threads) for i in range(per_thread) if (t + i) % 2)
    observes = n_threads * per_thread - merges
    assert stat.count == merges * 5 + observes
    assert sum(stat.buckets) == stat.count
    assert stat.buckets[DS.bucket_of(0.001)] == observes
    assert stat.buckets[DS.bucket_of(0.004)] == merges * 3
    assert stat.buckets[DS.bucket_of(0.512)] == merges * 2


def test_exemplar_capture_requires_active_span(pkg):
    tr, DS = pkg["tracing"], pkg["metrics"].DurationStat
    tracer = tr.InMemoryTracer()
    tr.set_tracer(tracer)
    stat = DS()
    stat.observe(0.002)
    assert stat.exemplar_snapshot() == {}
    with tr.span("obs.test_root"):
        stat.observe(0.002)
    exs = stat.exemplar_snapshot()
    b = DS.bucket_of(0.002)
    tid, val = exs[b]
    assert len(tid) == 32 and val == 0.002
    assert tracer.has_trace(tid)


def test_exemplar_survives_scrape_while_span_open(pkg):
    tr, DS = pkg["tracing"], pkg["metrics"].DurationStat
    tracer = tr.InMemoryTracer()
    tr.set_tracer(tracer)
    stat = DS()
    with tr.span("obs.test_open_root"):
        stat.observe(0.002)
        exs = stat.exemplar_snapshot()
        b = DS.bucket_of(0.002)
        assert b in exs
        assert tracer.has_trace(exs[b][0])
    assert DS.bucket_of(0.002) in stat.exemplar_snapshot()


def test_exemplar_disabled_without_tracer(pkg):
    stat = pkg["metrics"].DurationStat()
    stat.observe(0.002)
    assert stat.exemplars == {}


def test_exemplar_pruned_at_tracer_deque_bound(pkg):
    tr, DS = pkg["tracing"], pkg["metrics"].DurationStat
    t = tr.InMemoryTracer(max_spans=4)
    tr.set_tracer(t)
    stat = DS()
    with tr.span("obs.test_exemplar_root"):
        stat.observe(0.002)
    (tid, _v) = stat.exemplar_snapshot()[DS.bucket_of(0.002)]
    assert t.has_trace(tid)
    for _ in range(4):
        with tr.span("obs.test_filler"):
            pass
    assert not t.has_trace(tid)
    assert stat.exemplar_snapshot() == {}
    assert DS.bucket_of(0.002) not in stat.exemplars


def test_tracer_refcount_survives_clear_and_multi_span(pkg):
    tr = pkg["tracing"]
    tracer = tr.InMemoryTracer()
    tr.set_tracer(tracer)
    with tr.span("obs.test_outer"):
        with tr.span("obs.test_inner"):
            pass
    tid = tracer.spans("obs.test_outer")[0].trace_id
    assert tracer.has_trace(tid)
    tracer.clear()
    assert not tracer.has_trace(tid)


class _R:
    def __init__(self, status, reset_time, error=""):
        self.status = status
        self.reset_time = reset_time
        self.error = error


def test_admission_watch_counts_and_window_reset(pkg):
    aw = pkg["slo"].AdmissionWatch()
    assert not aw.active
    assert aw.watch("t_k1", limit=10)
    assert aw.active
    reqs = [RateLimitReq(name="t", unique_key="k1", hits=3, limit=10, duration=60_000)]
    aw.observe_batch(reqs, [_R(0, 1000)])
    aw.observe_batch(reqs, [_R(0, 1000)])
    aw.observe_batch(reqs, [_R(1, 1000)])
    snap = aw.snapshot()["t_k1"]
    assert snap["admitted"] == 6 and snap["limit"] == 10
    aw.observe_batch(reqs, [_R(0, 61_000)])
    snap = aw.snapshot()["t_k1"]
    assert snap["admitted"] == 3 and snap["reset_time"] == 61_000
    aw.unwatch("t_k1")
    assert not aw.active


def test_admission_watch_columns_route_and_env(pkg, monkeypatch):
    aw = pkg["slo"].AdmissionWatch()
    aw.watch("t_k2")
    aw.observe_columns(["t_k2", "t_other"], np.asarray([4, 9]),
                       (np.asarray([0, 0]), np.asarray([10, 10]), np.asarray([6, 1]),
                        np.asarray([5000, 5000])))
    snap = aw.snapshot()
    assert snap["t_k2"]["admitted"] == 4 and "t_other" not in snap
    monkeypatch.setenv("GUBER_SLO_WATCH_KEYS", "a_b:40, c_d ,")
    aw2 = pkg["slo"].AdmissionWatch()
    pkg["slo"].watch_keys_from_env(aw2)
    assert aw2.snapshot() == {"a_b": {"admitted": 0, "limit": 40, "reset_time": 0},
                              "c_d": {"admitted": 0, "limit": 0, "reset_time": 0}}


def test_service_feeds_the_admission_watch():
    """The port's V1Instance counts a watched key's admitted hits from
    get_rate_limits' answers (reference service.py:751)."""
    inst = V1Instance(DecisionEngine(256, clock=Clock().freeze_at(T0_NS), device="cpu"))
    try:
        inst.admission_watch.watch("w_k", limit=5)
        for _ in range(4):
            inst.get_rate_limits([RateLimitReq(name="w", unique_key="k", hits=2, limit=5,
                                               duration=60_000)])
        assert inst.admission_watch.snapshot()["w_k"]["admitted"] == 4
    finally:
        inst.close()


class _StubFleet:
    def __init__(self, rollups):
        self.rollups = list(rollups)

    def collect(self, peers=True):
        return self.rollups.pop(0)


def _rollup(checks, errors, regions=("",), nodes=1, admitted=None):
    return {
        "nodes": [{"addr": f"n{i}", "region": regions[i % len(regions)]} for i in range(nodes)],
        "regions": {r: {"nodes": 1, "counters": {}} for r in regions},
        "counters": {"checks": checks, "check_errors": errors},
        "gauges": {}, "quantiles": {}, "admitted": admitted or {},
    }


def test_watchdog_burn_and_breach_needs_both_windows(pkg):
    slo = pkg["slo"]
    wd = slo.SLOWatchdog(
        _StubFleet([]), None, interval=0,
        slis=(slo.SLI(name="error_rate", metric="gubernator_check_error_counter",
                      kind="ratio", bad="check_errors", total="checks", objective=0.999),),
        fast_windows=(0.01, 0.02), slow_windows=(0.05, 0.1),
        fast_factor=2.0, slow_factor=1e9,
    )
    try:
        wd.evaluate(_rollup(1000, 0))
        time.sleep(0.03)
        out = wd.evaluate(_rollup(1200, 100))
        assert any(k.startswith("error_rate@fast") and v > 2.0 for k, v in out["slis"].items())
        assert any(b["sli"] == "error_rate" for b in out["breaches"])
        time.sleep(0.03)
        out2 = wd.evaluate(_rollup(2400, 100))
        fast_short = [v for k, v in out2["slis"].items()
                      if k.startswith("error_rate@fast_0.01")][0]
        assert fast_short < 2.0
        assert not any(b["sli"] == "error_rate" for b in out2["breaches"])
    finally:
        wd.close()


def test_watchdog_derives_region_bound_and_headroom(pkg):
    wd = pkg["slo"].SLOWatchdog(_StubFleet([]), None, interval=0)
    try:
        out = wd.evaluate(_rollup(100, 0, regions=("east", "west"), nodes=4, admitted={
            "xr_canary": {"admitted": 70, "limit": 40, "nodes": 2}}))
        hr = out["headroom"]["xr_canary"]
        assert hr["bound"] == "2_regions_x_40" and hr["headroom"] == 10.0
        assert wd.metrics_snapshot()["headroom"][("xr_canary", "2_regions_x_40")] == 10.0
        out = wd.evaluate(_rollup(100, 0, regions=("",), nodes=3, admitted={
            "k": {"admitted": 0, "limit": 10, "nodes": 3}}))
        assert out["headroom"]["k"]["bound"] == "3_nodes_x_10"
    finally:
        wd.close()


def test_watchdog_unwindowed_skips_history_backed_slis(pkg):
    wd = pkg["slo"].SLOWatchdog(_StubFleet([]), None, interval=0,
                                fast_windows=(0.01, 0.02), slow_windows=(0.05, 0.1))
    try:
        wd.evaluate(_rollup(1000, 0))
        fleet_rollup = _rollup(50_000, 5_000, regions=("east", "west"), nodes=4,
                               admitted={"k": {"admitted": 10, "limit": 40, "nodes": 2}})
        fleet_rollup["quantiles"] = {"window_wait": {"count": 10, "p50_ms": 1.0,
                                                     "p99_ms": 9.0}}
        out = wd.evaluate(fleet_rollup, record=False, windowed=False)
        assert not any(k.startswith(("error_rate@", "ring_drops@")) for k in out["slis"])
        assert not out["breaches"]
        assert any(k.startswith("window_wait_p99@") for k in out["slis"])
        assert out["headroom"]["k"]["headroom"] == 70.0
    finally:
        wd.close()


def test_watchdog_status_shape_equals_the_reference():
    """The /debug/slo shape: the port's status has the reference's keys
    and the same declared SLIs, after the same evaluation."""
    got = port_slo.SLOWatchdog(_StubFleet([]), None, interval=0)
    want = ref_slo.SLOWatchdog(_StubFleet([]), None, interval=0)
    try:
        for wd in (got, want):
            wd.evaluate(_rollup(10, 0))
        a, b = got.status(), want.status()
        assert a["enabled"] and set(a) == set(b)
        assert {"pairs", "slis", "burn", "headroom", "breaches", "samples"} <= set(a)
        assert any(s["name"] == "admission_bound" for s in a["slis"])
        assert a["slis"] == b["slis"] and a["pairs"] == b["pairs"] and a["burn"] == b["burn"]
    finally:
        got.close()
        want.close()


def test_watchdog_ticks_over_the_local_rollup():
    """The daemon's wiring: the watchdog's thread evaluates the port's
    local rollup (no peers) on its interval; its samples grow."""
    inst = V1Instance(DecisionEngine(256, clock=Clock().freeze_at(T0_NS), device="cpu"))
    fleet = port_fleet.FleetCollector(inst, addr="127.0.0.1:0")
    wd = port_slo.SLOWatchdog(fleet, inst.admission_watch, interval=0.02)
    try:
        inst.get_rate_limits([RateLimitReq(name="s", unique_key="k", hits=1, limit=5,
                                           duration=60_000)])
        deadline = time.monotonic() + 10
        while wd.status()["samples"] < 2 and time.monotonic() < deadline:
            time.sleep(0.02)
        assert wd.status()["samples"] >= 2
        roll = fleet.collect()
        assert roll["counters"]["checks"] == 1 and roll["scrape"]["ok"] == 1
        assert "device.step" in roll["quantiles"]
    finally:
        wd.close()
        inst.close()


def test_local_snapshot_keys_equal_the_reference_nodes():
    """The rollup's snapshot of a node with no peers: the reference's
    counter, gauge and histogram keys (its planes that a single node
    never starts read absent in both)."""
    from gubernator_tpu.config import BehaviorConfig
    from gubernator_tpu.config import Config as RefConfig

    ref_eng, port_eng = _engines()
    ref = RefInstance(RefConfig(behaviors=BehaviorConfig(global_sync_wait=3600.0,
                                                         adaptive_windows=False)), ref_eng)
    port = V1Instance(port_eng)
    try:
        for inst, cls in ((ref, RefReq), (port, RateLimitReq)):
            inst.get_rate_limits([_req(cls, k) for k in "pqp"])
        a = port_fleet.FleetCollector(port).local_snapshot()
        ref_collector = ref_fleet.FleetCollector(ref)
        b = ref_collector.local_snapshot()
        ref_collector.close()
        assert set(a) == set(b)
        assert set(a["counters"]) >= {"checks", "over_limit", "check_errors", "local",
                                      "sketch", "ledger_answered"}
        assert {k: a["counters"][k] for k in ("checks", "over_limit", "local")} == \
            {k: b["counters"][k] for k in ("checks", "over_limit", "local")}
        assert set(b["hists"]) <= set(a["hists"])
    finally:
        ref.close()
        port.close()
