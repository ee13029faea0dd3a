"""GLOBAL, MULTI_REGION and SKETCH items on a node with no peers: the
port's V1Instance against the JAX package's.

The reference is `V1Instance(Config(behaviors=BehaviorConfig(...)),
DecisionEngine(4096))` with no peers and no regions: an item with the
SKETCH bit goes to its count-min sketch whatever its other bits
(gubernator_tpu/service.py:599), every other valid item to one engine
batch (:695-730, `apply_local_batch` :1652, whose GLOBAL and
MULTI_REGION managers have no one to send to).  The GLOBAL manager still
reads its keys back through the engine (hits 0) before its broadcast, on
its flush thread; the reference here flushes only when the test calls
`global_mgr.flush_now()`, right after each batch, so that the read-back
lands after the batch as the port's does (with the default adaptive
window it can also land before the batch's own engine call).  Both
instances run on frozen clocks at the same instants; status, limit,
remaining, reset, error and metadata must be equal item for item, and
the sketches' planes, epoch and plane index after the stream.  The HTTP
case holds the port's gateway bytes to `json_format`'s printing of the
reference's answers.
"""

from __future__ import annotations

import json
import urllib.request

import numpy as np
import pytest
from google.protobuf import json_format

from gubernator_tpu.clock import Clock as RefClock
from gubernator_tpu.config import BehaviorConfig, Config
from gubernator_tpu.config import setup_daemon_config as ref_setup_daemon_config
from gubernator_tpu.core.engine import DecisionEngine as RefEngine
from gubernator_tpu.net import serde
from gubernator_tpu.service import V1Instance as RefInstance
from gubernator_tpu.types import RateLimitReq as RefReq
from gubernator_tpu_torch.clock import Clock
from gubernator_tpu_torch.config import DaemonConfig, setup_daemon_config
from gubernator_tpu_torch.core.engine import DecisionEngine
from gubernator_tpu_torch.daemon import spawn_daemon
from gubernator_tpu_torch.ops import sketch as ps
from gubernator_tpu_torch.service import V1Instance
from gubernator_tpu_torch.types import RateLimitReq

T0_NS = 1_760_000_000_000 * 1_000_000
SKETCH = dict(sketch_window_ms=1_000, sketch_depth=4, sketch_width=1 << 10)
# plain, GLOBAL, MULTI_REGION, SKETCH, GLOBAL|SKETCH, MULTI_REGION|SKETCH,
# and GLOBAL / MULTI_REGION with RESET_REMAINING or a Gregorian duration
BEHAVIORS = [0, 2, 16, 32, 34, 48, 2 | 8, 16 | 4, 32 | 4]


@pytest.fixture
def pair():
    """(reference instance, port instance), both on frozen clocks at T0."""
    behaviors = BehaviorConfig(global_sync_wait=3600.0, adaptive_windows=False)
    ref = RefInstance(Config(behaviors=behaviors, **SKETCH),
                      RefEngine(4096, clock=RefClock().freeze_at(T0_NS)))
    port = V1Instance(DecisionEngine(4096, clock=Clock().freeze_at(T0_NS), device="cpu"),
                      **SKETCH)
    try:
        yield ref, port
    finally:
        port.close()
        ref.close()


def _advance(ref, port, ms):
    ref.engine.clock.advance(ms=ms)
    port.engine.clock.advance(ms=ms)


def _answers(resps):
    return [(int(r.status), r.limit, r.remaining, r.reset_time, r.error, dict(r.metadata))
            for r in resps]


def _both(ref, port, reqs):
    want = _ref_answers(ref, reqs)
    got = port.get_rate_limits(reqs)
    assert _answers(got) == _answers(want)
    return got


def _ref_answers(ref, reqs):
    want = ref.get_rate_limits([RefReq(**vars(r)) for r in reqs])
    ref.global_mgr.flush_now()
    return want


def _stream_reqs(rng, n):
    reqs = []
    for i in range(n):
        beh = int(rng.choice(BEHAVIORS))
        reqs.append(RateLimitReq(
            name="" if i == 7 else "api",
            unique_key="" if i == 3 else f"u{int(rng.integers(60))}",
            hits=int(rng.choice([-3, 0, 1, 1, 2, 5, 2**30])),
            limit=int(rng.choice([0, 5, 10, 100, 2**40])),
            duration=int(rng.choice([1, 3])) if beh & 4 else int(rng.choice([1_000, 60_000])),
            algorithm=int(rng.integers(0, 2)),
            behavior=beh,
            burst=int(rng.choice([0, 3])),
        ))
    return reqs


@pytest.mark.parametrize("behavior", [2, 16, 32, 34, 48])
def test_one_item_answers_as_the_reference(pair, behavior):
    """The probe that found the fault: one item, GLOBAL (2), MULTI_REGION
    (16), SKETCH (32), GLOBAL|SKETCH (34) and MULTI_REGION|SKETCH (48) —
    once an error in the port, now the reference's answer."""
    ref, port = pair
    req = RateLimitReq(name="api", unique_key="u1", hits=1, limit=10, duration=60_000,
                       behavior=behavior)
    for _ in range(3):
        (got,) = _both(ref, port, [req])
        assert got.error == ""
    window = 1_000 if behavior & 32 else 60_000
    assert (got.remaining, got.reset_time) == (7, T0_NS // 10**6 + window)


def test_global_read_back_runs_after_the_batch(pair):
    """A GLOBAL item with RESET_REMAINING, then a later item of the same
    batch that spends: the GLOBAL owner's read-back (hits 0) refills the
    bucket after the batch, in the reference and in the port, so the
    next batch sees a full bucket.  The engine alone would not."""
    ref, port = pair
    engine_only = DecisionEngine(4096, clock=Clock().freeze_at(T0_NS), device="cpu")
    kw = dict(name="api", unique_key="r1", limit=10, duration=60_000)
    batches = [
        [RateLimitReq(hits=1, behavior=2 | 8, **kw), RateLimitReq(hits=4, **kw)],
        [RateLimitReq(hits=1, **kw)],
    ]
    try:
        for b in batches:
            _advance(ref, port, 100)
            engine_only.clock.advance(ms=100)
            got = _both(ref, port, b)
            alone = engine_only.get_rate_limits(b)
        assert got[0].remaining == 9 and alone[0].remaining == 4
    finally:
        engine_only.close()


def test_global_read_back_rides_in_the_batch_engine_call(pair):
    """The read-back costs no engine call of its own: a batch with GLOBAL
    items (one key twice, its latest GLOBAL item with RESET_REMAINING)
    makes one engine call, answers as the reference, and leaves the
    bucket the read refilled."""
    ref, port = pair
    kw = dict(name="api", limit=10, duration=60_000)
    batch = [RateLimitReq(unique_key="g1", hits=3, behavior=2, **kw),
             RateLimitReq(unique_key="g2", hits=1, behavior=2 | 8, **kw),
             RateLimitReq(unique_key="p1", hits=2, **kw),
             RateLimitReq(unique_key="g1", hits=4, behavior=2, **kw),
             RateLimitReq(unique_key="g2", hits=5, **kw)]
    before = port.engine.batches_total
    got = _both(ref, port, batch)
    assert port.engine.batches_total == before + 1
    assert [r.remaining for r in got] == [7, 9, 8, 3, 4]
    (g1, g2) = _both(ref, port, [RateLimitReq(unique_key=k, hits=0, **kw) for k in ("g1", "g2")])
    assert (g1.remaining, g2.remaining) == (3, 10)


def test_behavior_stream_answers_as_the_reference(pair):
    """A seeded stream with every behavior mix and validation errors,
    across window steps: within a window, by exactly one, by gaps of two
    or more, and back in time."""
    ref, port = pair
    rng = np.random.default_rng(6)
    n_sketch = 0
    for step in (0, 250, 1_000, 10, 2_500, 999, 1, 7_000, -1_500, 300, 1_000, 60_000):
        _advance(ref, port, step)
        reqs = _stream_reqs(rng, int(rng.integers(1, 200)))
        _both(ref, port, reqs)
        n_sketch += sum(1 for r in reqs if r.behavior & 32 and r.name and r.unique_key)
    assert port.counters["sketch"] == ref.counters["sketch"] == n_sketch > 0
    counts, epoch, cur = ps.sketch_state_to_numpy(port.sketch().state)
    rsk = ref.sketch()
    np.testing.assert_array_equal(counts, np.asarray(rsk._state.counts))
    assert (epoch, cur) == (rsk._epoch_host, rsk._cur_host)


def test_sketch_runs_on_the_engines_device(pair):
    _, port = pair
    assert port.sketch().device == port.engine.device
    assert port.sketch() is port.sketch()
    assert (port.sketch().window_ms, port.sketch().depth, port.sketch().width) == (1_000, 4, 1 << 10)


def test_sketch_settings_from_the_environment():
    env = {"GUBER_SKETCH_WINDOW": "250ms", "GUBER_SKETCH_DEPTH": "3",
           "GUBER_SKETCH_WIDTH": "4096"}
    for e in ({}, env, {"GUBER_SKETCH_WINDOW": "2"}):
        got, want = setup_daemon_config(e), ref_setup_daemon_config(env=e)
        assert (got.sketch_window_ms, got.sketch_depth, got.sketch_width) == (
            want.sketch_window_ms, want.sketch_depth, want.sketch_width)
    assert setup_daemon_config(env).sketch_window_ms == 250


def test_sketch_items_over_http_match_the_reference(pair):
    """Sketch items, mixed with GLOBAL and plain ones, through the port
    daemon's gateway: the bodies equal json_format's printing of the
    reference instance's answers."""
    ref, _ = pair
    conf = DaemonConfig(http_listen_address="127.0.0.1:0", cache_size=4096, sweep_interval=0,
                        **SKETCH)
    d = spawn_daemon(conf, clock=Clock().freeze_at(T0_NS), device="cpu")
    try:
        assert d.instance.sketch().width == 1 << 10
        rng = np.random.default_rng(11)
        for step in (0, 400, 700, 3_000):
            d.clock.advance(ms=step)
            ref.engine.clock.advance(ms=step)
            reqs = _stream_reqs(rng, 120)
            body = json.dumps({"requests": [vars(r) for r in reqs]}).encode()
            with urllib.request.urlopen(urllib.request.Request(
                    f"http://{d.http_address}/v1/GetRateLimits", data=body, method="POST"),
                    timeout=30) as r:
                got = r.read()
            want = _ref_answers(ref, reqs)
            assert got == json_format.MessageToJson(
                serde.get_rate_limits_resp_to_pb(want), preserving_proto_field_name=True,
                always_print_fields_with_no_presence=True).encode()
        assert d.instance.counters["sketch"] == ref.counters["sketch"] > 0
    finally:
        d.close()
