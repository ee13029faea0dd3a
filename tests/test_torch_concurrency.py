"""Concurrency storms on the port's engines: the exact-accounting storms of
tests/test_concurrency.py (:30, :65, :242), run on the port's
DecisionEngine.

Each storm runs on four engines: the dense CPU engine with GUBER_PUMP=0
(every batch launched at submit) and with GUBER_PUMP=1 (batches queued
and joined at the flush), a paged CPU engine (pages of 16 rows, 4
resident) and, marked `cuda`, a paged engine on the card, where the pump's
async readback, K1's cooperative launch and the faults' K9 / K10 launches
really overlap.  On the paged engines a roaming thread spreads
hits over 200 keys (13 or more pages of 16, against 4 frames) while the
storm runs, so the storm's own pages are spilled and refilled under it.

What is checked is the reference's: no error and no lost answer, the
shared bucket consumed exactly the sum of every thread's hits, each
private bucket exactly its owner's, and a bounded hot key admitting
exactly its limit; on the paged engines each roaming key consumed exactly
its hits, and pages were faulted.  Tolerance: exact.

This module imports only the port, so its `cuda` cases run on the card
with `python -m pytest tests/test_torch_concurrency.py --noconftest -q`.
"""

from __future__ import annotations

import threading

import numpy as np
import pytest
import torch

from gubernator_tpu_torch.clock import Clock
from gubernator_tpu_torch.core.engine import DecisionEngine
from gubernator_tpu_torch.types import RateLimitReq, Status

N_THREADS = 8
ROUNDS = 20
ROAM_KEYS = 200


def _req(key, hits=1, limit=10**9, duration=3_600_000):
    return RateLimitReq(name="storm", unique_key=key, hits=hits, limit=limit, duration=duration)


@pytest.fixture(params=[
    pytest.param(("cpu", "0", False), id="dense-pump0"),
    pytest.param(("cpu", "1", False), id="dense-pump1"),
    pytest.param(("cpu", "1", True), id="paged"),
    pytest.param(("cuda", None, True), id="paged-cuda", marks=pytest.mark.cuda),
])
def make_engine(request, monkeypatch):
    """A factory of engines of one kind (closed afterwards)."""
    device, pump, paged = request.param
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; the CPU tier runs the plain versions")
    if pump is None:
        monkeypatch.delenv("GUBER_PUMP", raising=False)  # the card's default: queueing on
    else:
        monkeypatch.setenv("GUBER_PUMP", pump)
    if paged:
        monkeypatch.setenv("GUBER_PAGED", "1")
        monkeypatch.setenv("GUBER_PAGE_SIZE", "16")
        monkeypatch.setenv("GUBER_PAGED_RESIDENT", "4")
    else:
        monkeypatch.delenv("GUBER_PAGED", raising=False)
    engines = []

    def make(capacity):
        engine = DecisionEngine(capacity, clock=Clock().freeze(), device=device)
        assert (engine.paging is not None) == paged
        engines.append(engine)
        return engine

    yield make
    for engine in engines:
        engine.close()


class Roamer:
    """On a paged engine, a thread that spreads single hits over
    ROAM_KEYS keys while a storm runs; `check` holds each key to exactly
    its hits.  On a dense engine it does nothing."""

    def __init__(self, engine, errs):
        self.engine, self.errs = engine, errs
        self.hits = {}
        self.thread = None
        self.faults0 = 0

    def __enter__(self):
        if self.engine.paging is not None:
            self.faults0 = self.engine.paging.faults
            self.thread = threading.Thread(target=self._run)
            self.thread.start()
        return self

    def __exit__(self, *exc):
        if self.thread is not None:
            self.thread.join()

    def _run(self):
        try:
            rng = np.random.default_rng(7)
            for _ in range(ROUNDS * 4):
                keys = [f"roam_{int(k)}" for k in rng.integers(0, ROAM_KEYS, 5)]
                for r in self.engine.get_rate_limits([_req(k) for k in keys]):
                    assert r.status == Status.UNDER_LIMIT and r.error == ""
                for k in keys:
                    self.hits[k] = self.hits.get(k, 0) + 1
        except Exception as e:  # noqa: BLE001
            self.errs.append(e)

    def check(self):
        if self.thread is None:
            return
        assert self.engine.paging.faults > self.faults0
        keys = sorted(self.hits)
        for k, r in zip(keys, self.engine.get_rate_limits([_req(k, hits=0) for k in keys])):
            assert r.remaining == 10**9 - self.hits[k], k


def _run_threads(threads):
    for t in threads:
        t.start()
    for t in threads:
        t.join()


def test_engine_storm_exact_accounting(make_engine):
    """:30 — N threads hammer one engine with a shared key (three times a
    batch) and a private key each: the shared bucket consumes exactly the
    sum of all hits, every private bucket exactly its owner's."""
    engine = make_engine(4096)
    limit = 10**9
    errs = []

    def worker(tid):
        try:
            for _ in range(ROUNDS):
                reqs = [_req("shared")] * 3 + [_req(f"private_{tid}")]
                for r in engine.get_rate_limits(reqs):
                    assert r.status == Status.UNDER_LIMIT
                    assert r.error == ""
        except Exception as e:  # noqa: BLE001
            errs.append(e)

    with Roamer(engine, errs) as roamer:
        _run_threads([threading.Thread(target=worker, args=(t,)) for t in range(N_THREADS)])
    assert not errs, errs
    shared = engine.get_rate_limits([_req("shared", hits=0)])[0]
    assert shared.remaining == limit - N_THREADS * ROUNDS * 3
    for tid in range(N_THREADS):
        private = engine.get_rate_limits([_req(f"private_{tid}", hits=0)])[0]
        assert private.remaining == limit - ROUNDS
    roamer.check()


def test_engine_columnar_storm_mixed_with_dataclass(make_engine):
    """:65 — columnar and dataclass callers racing on one key keep exact
    accounting (both paths take the engine lock); the columnar raw key
    b"storm_shared" is the dataclass hash key of ("storm", "shared")."""
    engine = make_engine(4096)
    limit = 10**9
    errs = []

    def columnar_worker():
        try:
            n = 4
            for _ in range(ROUNDS):
                engine.apply_columnar(
                    [b"storm_shared"] * n,
                    np.zeros(n, dtype=np.int32),
                    np.zeros(n, dtype=np.int32),
                    np.ones(n, dtype=np.int64),
                    np.full(n, limit, dtype=np.int64),
                    np.full(n, 3_600_000, dtype=np.int64),
                    np.zeros(n, dtype=np.int64),
                )
        except Exception as e:  # noqa: BLE001
            errs.append(e)

    def dataclass_worker():
        try:
            for _ in range(ROUNDS):
                engine.get_rate_limits([_req("shared", hits=2)])
        except Exception as e:  # noqa: BLE001
            errs.append(e)

    with Roamer(engine, errs) as roamer:
        _run_threads([threading.Thread(target=columnar_worker) for _ in range(4)]
                     + [threading.Thread(target=dataclass_worker) for _ in range(4)])
    assert not errs, errs
    r = engine.get_rate_limits([_req("shared", hits=0)])[0]
    assert r.remaining == limit - (4 * ROUNDS * 4 + 4 * ROUNDS * 2)
    roamer.check()


def test_hot_key_collapse_storm_exact_accounting(make_engine):
    """:242 — threads race columnar hot-key batches (the collapsed path)
    against dataclass batches of the same key; demand equals the limit,
    so every hit is admitted and the bucket ends exactly empty."""
    engine = make_engine(1024)
    errs = []
    admitted = [0] * N_THREADS
    limit = N_THREADS * ROUNDS * 2

    def col_batch(m):
        return dict(
            keys=[b"storm_hot_storm"] * m,
            algo=np.zeros(m, dtype=np.int32),
            behavior=np.zeros(m, dtype=np.int32),
            hits=np.ones(m, dtype=np.int64),
            limit=np.full(m, limit, dtype=np.int64),
            duration=np.full(m, 3_600_000, dtype=np.int64),
            burst=np.zeros(m, dtype=np.int64),
        )

    def worker(tid):
        try:
            count = 0
            for _ in range(ROUNDS):
                if tid % 2 == 0:
                    st, _, _rem, _ = engine.apply_columnar(**col_batch(2))
                    count += int((st == 0).sum())
                else:
                    resps = engine.get_rate_limits([_req("hot_storm", limit=limit)] * 2)
                    count += sum(1 for r in resps if r.status == Status.UNDER_LIMIT)
            admitted[tid] = count
        except Exception as e:  # noqa: BLE001
            errs.append(e)

    with Roamer(engine, errs) as roamer:
        _run_threads([threading.Thread(target=worker, args=(t,)) for t in range(N_THREADS)])
    assert not errs, errs
    assert sum(admitted) == limit
    final = engine.get_rate_limits([_req("hot_storm", hits=0, limit=limit)])[0]
    assert final.remaining == 0
    roamer.check()
