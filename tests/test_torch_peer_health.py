"""The port's peer health plane and fault injector against the JAX
package's.

tests/test_peer_health.py's 19 cases run on both packages (the `pkg`
fixture), every clock injected (`PeerHealth(now=...)`), so nothing waits
on wall time.  Then one seed through both packages' `FaultInjector`s
must give the same event sequence, one scripted failure sequence
through both `PeerHealth`s the same states and open periods, and
`aggregate_region_state` the same fold.
"""

from __future__ import annotations

import importlib
import random
from types import SimpleNamespace

import pytest

from gubernator_tpu.cluster import faults as ref_faults
from gubernator_tpu.cluster import health as ref_health
from gubernator_tpu_torch.cluster import faults as port_faults
from gubernator_tpu_torch.cluster import health as port_health

PACKAGES = ("gubernator_tpu", "gubernator_tpu_torch")


class FakeClock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t

    def advance(self, s):
        self.t += s


@pytest.fixture(params=PACKAGES)
def pkg(request):
    return SimpleNamespace(health=importlib.import_module(f"{request.param}.cluster.health"),
                           faults=importlib.import_module(f"{request.param}.cluster.faults"))


def _health(pkg, threshold=3, backoff=1.0, cap=8.0):
    clock = FakeClock()
    h = pkg.health.PeerHealth("peer:1", failure_threshold=threshold, backoff=backoff,
                              backoff_cap=cap, now=clock)
    return h, clock


# -- transition table (tests/test_peer_health.py) ----------------------


def test_starts_healthy_and_allows(pkg):
    h, _ = _health(pkg)
    assert h.state() == pkg.health.HEALTHY
    assert h.allow()
    assert h.would_allow()


def test_first_failure_moves_to_suspect(pkg):
    h, _ = _health(pkg)
    h.record_failure()
    assert h.state() == pkg.health.SUSPECT
    assert h.allow()


def test_suspect_success_returns_to_healthy(pkg):
    h, _ = _health(pkg)
    h.record_failure()
    h.record_success()
    assert h.state() == pkg.health.HEALTHY


def test_threshold_failures_open_the_circuit(pkg):
    h, _ = _health(pkg, threshold=3)
    for _ in range(3):
        h.record_failure()
    assert h.state() == pkg.health.BROKEN
    assert not h.allow()
    assert not h.would_allow()
    assert h.retry_after() > 0


def test_broken_until_open_period_expires_then_one_probe(pkg):
    h, clock = _health(pkg, threshold=1, backoff=2.0)
    h.record_failure()
    assert h.state() == pkg.health.BROKEN
    assert not h.allow()
    clock.advance(2.01)
    assert h.would_allow()
    assert h.allow()
    assert h.state() == pkg.health.HALF_OPEN
    assert not h.allow()
    assert not h.would_allow()


def test_half_open_success_closes_circuit(pkg):
    h, clock = _health(pkg, threshold=1, backoff=1.0)
    h.record_failure()
    clock.advance(1.01)
    assert h.allow()
    h.record_success()
    assert h.state() == pkg.health.HEALTHY
    assert h.allow()


def test_half_open_failure_reopens_with_doubled_period(pkg):
    h, clock = _health(pkg, threshold=1, backoff=1.0, cap=8.0)
    h.record_failure()
    clock.advance(1.01)
    assert h.allow()
    h.record_failure()
    assert h.state() == pkg.health.BROKEN
    assert h.retry_after() == pytest.approx(2.0, abs=0.01)
    for period in (4.0, 8.0, 8.0):
        clock.advance(h.retry_after() + 0.01)
        assert h.allow()
        h.record_failure()
        assert h.retry_after() == pytest.approx(period, abs=0.01)


def test_recovery_resets_open_period(pkg):
    h, clock = _health(pkg, threshold=1, backoff=1.0, cap=8.0)
    for _ in range(3):
        h.record_failure()
        clock.advance(h.retry_after() + 0.01)
        assert h.allow()
    h.record_success()
    assert h.state() == pkg.health.HEALTHY
    h.record_failure()
    assert h.retry_after() == pytest.approx(1.0, abs=0.01)


def test_failure_while_broken_is_absorbed(pkg):
    h, _ = _health(pkg, threshold=1, backoff=2.0)
    h.record_failure()
    before = h.retry_after()
    h.record_failure()
    assert h.state() == pkg.health.BROKEN
    assert h.retry_after() == pytest.approx(before, abs=0.01)


def test_stale_probe_slot_is_reclaimed(pkg):
    clock = FakeClock()
    h = pkg.health.PeerHealth("peer:1", failure_threshold=1, backoff=1.0, backoff_cap=8.0,
                              probe_timeout=5.0, now=clock)
    h.record_failure()
    clock.advance(1.01)
    assert h.allow()
    assert not h.allow()
    assert not h.would_allow()
    clock.advance(5.01)
    assert h.would_allow()
    assert h.allow()
    h.record_success()
    assert h.state() == pkg.health.HEALTHY


def test_transition_counters(pkg):
    h, clock = _health(pkg, threshold=1, backoff=1.0)
    h.record_failure()
    clock.advance(1.01)
    h.allow()
    h.record_success()
    t = h.transition_counts()
    for state in (pkg.health.SUSPECT, pkg.health.BROKEN, pkg.health.HALF_OPEN,
                  pkg.health.HEALTHY):
        assert t[state] == 1


# -- backoff_delay -----------------------------------------------------


def test_backoff_delay_full_jitter_envelope(pkg):
    rng = random.Random(7)
    for attempt in range(6):
        ceiling = min(0.25, 0.01 * 2**attempt)
        for _ in range(50):
            assert 0.0 <= pkg.health.backoff_delay(attempt, 0.01, 0.25, rng) <= ceiling


def test_backoff_delay_zero_base_disables(pkg):
    assert pkg.health.backoff_delay(3, 0.0, 1.0) == 0.0


def test_backoff_delay_deterministic_with_seed(pkg):
    a = [pkg.health.backoff_delay(i, 0.01, 0.25, random.Random(42)) for i in range(5)]
    b = [pkg.health.backoff_delay(i, 0.01, 0.25, random.Random(42)) for i in range(5)]
    assert a == b


# -- fault injector ----------------------------------------------------


def _fates(faults, seed, n=200, **rates):
    inj = faults.FaultInjector(seed, **rates)
    out = []
    for i in range(n):
        try:
            inj.check(f"n{i % 3}", f"n{(i + 1) % 3}")
            out.append("ok")
        except faults.FaultError as e:
            out.append(e.kind)
    return out, inj.counts()


def test_injector_same_seed_same_fates(pkg):
    assert _fates(pkg.faults, 123, drop_rate=0.3, reset_rate=0.2) == \
        _fates(pkg.faults, 123, drop_rate=0.3, reset_rate=0.2)
    assert _fates(pkg.faults, 123, drop_rate=0.3, reset_rate=0.2)[0] != \
        _fates(pkg.faults, 124, drop_rate=0.3, reset_rate=0.2)[0]


def test_injector_asymmetric_partition(pkg):
    inj = pkg.faults.FaultInjector(0)
    inj.partition("a", "b")
    with pytest.raises(pkg.faults.FaultError):
        inj.check("a", "b")
    inj.check("b", "a")
    inj.heal()
    inj.check("a", "b")


def test_injector_isolate_and_heal(pkg):
    inj = pkg.faults.FaultInjector(0)
    inj.isolate("n1")
    with pytest.raises(pkg.faults.FaultError):
        inj.check("n1", "n2")
    with pytest.raises(pkg.faults.FaultError):
        inj.check("n3", "n1")
    inj.check("n2", "n3")
    inj.heal()
    inj.check("n1", "n2")
    assert inj.counts().get("partition", 0) == 2


def test_injector_targeted_heal_leaves_other_rules(pkg):
    inj = pkg.faults.FaultInjector(0)
    inj.isolate("B")
    inj.partition("A", "C")
    inj.heal("A", None)
    with pytest.raises(pkg.faults.FaultError):
        inj.check("X", "B")
    inj.check("A", "C")
    inj.heal(dst="B")
    with pytest.raises(pkg.faults.FaultError):
        inj.check("B", "X")
    inj.heal()
    inj.check("B", "X")
    inj.check("X", "B")


def test_injector_install_uninstall(pkg):
    assert pkg.faults.active() is None
    inj = pkg.faults.install(pkg.faults.FaultInjector(1))
    try:
        assert pkg.faults.active() is inj
    finally:
        pkg.faults.uninstall()
    assert pkg.faults.active() is None


# -- the port against the reference -----------------------------------


@pytest.mark.parametrize("seed", [0, 7, 123, 2**31 - 1])
def test_one_seed_same_events_in_both_packages(seed, monkeypatch):
    """Drops, resets and latency spikes draw from one seeded stream in a
    fixed order: the same seed, rates and send sequence give the same
    event sequence and counts in both packages (sleeps stubbed out)."""
    monkeypatch.setattr(ref_faults.time, "sleep", lambda s: None)
    monkeypatch.setattr(port_faults.time, "sleep", lambda s: None)
    rates = dict(drop_rate=0.2, reset_rate=0.15, latency_rate=0.25, latency_s=0.5)
    want = _fates(ref_faults, seed, 500, **rates)
    assert _fates(port_faults, seed, 500, **rates) == want
    assert want[1].get("latency", 0) > 0 and want[1].get("drop", 0) > 0


def test_scripted_breaker_and_backoff_match_reference():
    """One scripted sequence of outcomes, probes and clock steps through
    both packages' breakers: the same states, retry_after and counts,
    and the same jittered backoff draws from one seed."""
    rng = random.Random(11)
    script = [rng.choice(["fail", "ok", "allow", "tick", "long"]) for _ in range(400)]
    out = []
    for health in (ref_health, port_health):
        clock = FakeClock()
        h = health.PeerHealth("p", failure_threshold=2, backoff=0.5, backoff_cap=4.0,
                              probe_timeout=3.0, now=clock)
        trace = []
        for op in script:
            if op == "fail":
                h.record_failure()
            elif op == "ok":
                h.record_success()
            elif op == "allow":
                trace.append(h.allow())
            else:
                clock.advance(0.3 if op == "tick" else 5.0)
            trace.append((h.state(), round(h.retry_after(), 9), h.would_allow()))
        trace.append(sorted(h.transition_counts().items()))
        jitter = random.Random(3)
        trace.append([health.backoff_delay(a, 0.01, 0.25, jitter) for a in range(12)])
        out.append(trace)
    assert out[0] == out[1]


def test_aggregate_region_state_matches_reference():
    clock = FakeClock()
    for states in ([], ["ok"], ["ok", "broken"], ["broken", "broken"], ["probe", "broken"],
                   ["probe", "ok"]):
        folds = []
        for health in (ref_health, port_health):
            members = []
            for st in states:
                h = health.PeerHealth("p", failure_threshold=1, backoff=1.0, now=clock)
                if st != "ok":
                    h.record_failure()
                if st == "probe":
                    clock.advance(1.5)
                    h.allow()
                    clock.t -= 1.5
                members.append(h)
            folds.append(health.aggregate_region_state(members))
        assert folds[0] == folds[1], states
