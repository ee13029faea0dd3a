"""The port's interval batcher and adaptive window against the JAX
package's.

tests/test_batch_loop.py's 8 cases and the batcher half of
tests/test_adaptive_window.py (its WireWindow half needs
net/wire_window.py, ROADMAP A entry 5) run on both packages (the `pkg`
fixture).  Then one seeded load trace fed to both packages'
`AdaptiveWait` must give the same waits, and one scripted stream through
both `IntervalBatcher`s (held requeues, forced flushes) the same flushes.
"""

from __future__ import annotations

import importlib
import random
import threading
import time

import pytest

from gubernator_tpu.cluster import batch_loop as ref_loop
from gubernator_tpu_torch.cluster import batch_loop as port_loop

PACKAGES = ("gubernator_tpu", "gubernator_tpu_torch")


@pytest.fixture(params=PACKAGES)
def loop(request):
    return importlib.import_module(f"{request.param}.cluster.batch_loop")


def _combine(existing, item):
    return (existing or 0) + item


def _until(pred, timeout=10.0):
    deadline = time.monotonic() + timeout
    while not pred() and time.monotonic() < deadline:
        time.sleep(0.01)
    return pred()


# -- tests/test_batch_loop.py ------------------------------------------


def test_drain_limit_bounds_each_flush(loop):
    sizes = []
    gate = threading.Event()

    def flush(batch, chunks):
        gate.wait(5.0)
        sizes.append(100 * len(chunks))

    b = loop.IntervalBatcher(0.005, 100, _combine, flush, chunked=True, drain_limit=250)
    try:
        for i in range(20):
            b.add_chunk(("chunk", i), 100)
        gate.set()
        assert _until(lambda: b.pending() == 0)
        assert sum(sizes) == 2000
        assert max(sizes) <= 250 + 100, sizes
        assert len(sizes) >= 6, sizes
    finally:
        b.close()


def test_max_pending_blocks_producer(loop):
    release = threading.Event()

    def flush(batch, chunks):
        release.wait(10.0)

    b = loop.IntervalBatcher(0.001, 100, _combine, flush, chunked=True, drain_limit=100,
                             max_pending=300)
    try:
        blocked_at = []

        def producer():
            for i in range(8):
                b.add_chunk(("c", i), 100)
            blocked_at.append(time.monotonic())

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        time.sleep(0.3)
        assert not blocked_at, "producer should be blocked on the cap"
        assert b.pending() <= 300
        release.set()
        t.join(10.0)
        assert blocked_at, "producer must finish once flushes drain"
    finally:
        b.close()


def test_drop_oldest_sheds_and_counts(loop):
    release = threading.Event()

    def flush(batch, chunks):
        release.wait(10.0)

    b = loop.IntervalBatcher(0.001, 100, _combine, flush, chunked=True, drain_limit=100,
                             max_pending=500, overflow="drop_oldest")
    try:
        for i in range(20):
            b.add_chunk(("c", i), 100)
        assert b.pending() <= 500
        assert b.dropped >= 1400
        release.set()
    finally:
        b.close()


def test_backlog_age_tracks_oldest(loop):
    b = loop.IntervalBatcher(10.0, 10_000, _combine, lambda batch, chunks: None, chunked=True,
                             adaptive=False)
    try:
        assert b.backlog_age() == 0.0
        b.add_chunk(("c", 0), 1)
        time.sleep(0.05)
        assert 0.04 <= b.backlog_age() < 5.0
    finally:
        b.close()


def test_backlog_age_reanchors_after_drop_oldest_shed(loop):
    release = threading.Event()

    def flush(batch, chunks):
        release.wait(10.0)

    b = loop.IntervalBatcher(3600.0, 10_000, _combine, flush, chunked=True, adaptive=False,
                             drain_limit=1, max_pending=300, overflow="drop_oldest")
    try:
        b.add_chunk(("old", 0), 100)
        time.sleep(0.3)
        for i in range(3):
            b.add_chunk(("new", i), 100)
        assert b.dropped >= 100
        age = b.backlog_age()
        assert age < 0.25, f"gauge still reports the shed chunk: {age}"
        release.set()
    finally:
        b.close()


def test_deferred_requeue_held_until_due_then_flushes(loop):
    flushes = []
    b = loop.IntervalBatcher(0.001, 100, _combine, lambda batch: flushes.append(dict(batch)))
    try:
        t0 = time.monotonic()
        assert b.requeue_many([("k", 3)], oldest_ts=t0 - 1.0, delay=0.25) == 1
        assert b.pending() == 1
        assert b.backlog_age() >= 0.9
        time.sleep(0.1)
        assert flushes == []
        assert _until(lambda: flushes, 5.0)
        assert flushes == [{"k": 3}]
        assert time.monotonic() - t0 >= 0.24
    finally:
        b.close()


def test_flush_now_force_held_promotes_early(loop):
    flushes = []
    b = loop.IntervalBatcher(0.001, 100, _combine, lambda batch: flushes.append(dict(batch)))
    try:
        b.requeue_many([("k", 7)], delay=30.0)
        b.flush_now()
        assert flushes == []
        b.flush_now(force_held=True)
        assert flushes == [{"k": 7}]
    finally:
        b.close()


def test_close_drains_held_batches(loop):
    flushes = []
    b = loop.IntervalBatcher(0.001, 100, _combine, lambda batch: flushes.append(dict(batch)))
    b.requeue_many([("k", 1)], delay=30.0)
    b.close()
    assert flushes == [{"k": 1}]


# -- tests/test_adaptive_window.py, the batcher half --------------------


def test_adaptive_wait_starts_immediate_grows_with_fill(loop):
    aw = loop.AdaptiveWait(0.5, 1000)
    assert aw.next_wait() == 0.0
    for _ in range(20):
        aw.observe(1000)
    assert aw.next_wait() == pytest.approx(0.5)
    for _ in range(40):
        aw.observe(1)
    assert aw.next_wait() < 0.01


def test_adaptive_wait_zero_cap_stays_zero(loop):
    aw = loop.AdaptiveWait(0.0, 1000)
    aw.observe(1000)
    assert aw.next_wait() == 0.0


def test_idle_interval_batcher_fires_without_cap_wait(loop):
    flushed = threading.Event()
    b = loop.IntervalBatcher(30.0, 1000, _combine, lambda batch: flushed.set())
    try:
        t0 = time.monotonic()
        b.add("k", 1)
        assert flushed.wait(5.0), "idle window never fired"
        assert time.monotonic() - t0 < 2.0
    finally:
        b.close()


def test_interval_batcher_current_wait_gauge(loop):
    b = loop.IntervalBatcher(0.5, 100, _combine, lambda batch: None)
    try:
        assert b.current_wait() == 0.0
    finally:
        b.close()
    fixed = loop.IntervalBatcher(0.5, 100, _combine, lambda batch: None, adaptive=False)
    try:
        assert fixed.current_wait() == 0.5
    finally:
        fixed.close()


# -- the port against the reference -----------------------------------


@pytest.mark.parametrize("cap,limit,seed", [(0.5, 1000, 0), (0.002, 64, 1), (0.0, 10, 2),
                                            (30.0, 1, 3)])
def test_adaptive_wait_same_waits_on_one_load_trace(cap, limit, seed):
    rng = random.Random(seed)
    trace = [rng.choice([0, 1, limit // 3, limit, 5 * limit, rng.randrange(limit + 1)])
             for _ in range(500)]
    waits = []
    for mod in (ref_loop, port_loop):
        aw = mod.AdaptiveWait(cap, limit)
        got = [aw.next_wait()]
        for drained in trace:
            aw.observe(drained)
            got.append(aw.next_wait())
        waits.append(got)
    assert waits[0] == waits[1]
    assert cap == 0.0 or max(waits[0]) > 0.0


def test_scripted_stream_same_flushes():
    """One scripted stream of adds and held requeues, flushed by hand
    (`flush_now`, a sync window no test waits out): both packages'
    batchers deliver the same aggregates in the same order."""
    rng = random.Random(9)
    script = []
    for _ in range(60):
        op = rng.choice(["add", "add", "many", "held", "flush", "force"])
        script.append((op, [(f"k{rng.randrange(6)}", rng.randrange(1, 5))
                            for _ in range(rng.randrange(1, 4))]))
    out = []
    for mod in (ref_loop, port_loop):
        flushes = []
        b = mod.IntervalBatcher(3600.0, 1000, _combine,
                                lambda batch: flushes.append(sorted(batch.items())),
                                adaptive=False)
        try:
            for op, pairs in script:
                if op == "add":
                    b.add(*pairs[0])
                elif op == "many":
                    b.add_many(pairs)
                elif op == "held":
                    b.requeue_many(pairs, delay=3600.0)
                else:
                    b.flush_now(force_held=op == "force")
            pending = b.pending()
        finally:
            b.close()
        out.append((flushes, pending))
    assert out[0] == out[1]
    assert out[0][0]
