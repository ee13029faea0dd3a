"""The metrics pieces of the reference's metrics module
(gubernator_tpu/utils/metrics.py) that the port's host tier and its
debug routes use: `record_swallowed`, the per-site count of exceptions a
background loop caught and carried on after (:67), and `DurationStat`
(:79), a duration summary with a streaming log2 histogram, real
quantiles, exact merges and trace exemplars (GUBER_METRICS_EXEMPLARS).
No Prometheus export: the port has no /metrics surface yet, so the
numbers are read through `swallowed_counts()`, the stat's own methods
and the gateway's /debug/vars.
"""

from __future__ import annotations

import os
import threading

_OFF_VALUES = ("0", "false", "no", "off")

_exemplars_enabled = None


def exemplars_enabled() -> bool:
    """GUBER_METRICS_EXEMPLARS (default on): retain the last sampled
    trace_id per histogram bucket — the metrics→traces link.  Costs
    nothing while tracing is disabled (the tracing.active() check
    short-circuits first).  Read once and cached: DurationStat.observe
    runs at window rate and must not pay an environment read per
    observation."""
    global _exemplars_enabled
    if _exemplars_enabled is None:
        _exemplars_enabled = os.environ.get(
            "GUBER_METRICS_EXEMPLARS", "1"
        ).strip().lower() not in _OFF_VALUES
    return _exemplars_enabled


_swallowed_lock = threading.Lock()
_swallowed: dict = {}


def record_swallowed(site: str) -> None:
    """Count one exception swallowed at `site`."""
    with _swallowed_lock:
        _swallowed[site] = _swallowed.get(site, 0) + 1


def swallowed_counts() -> dict:
    with _swallowed_lock:
        return dict(_swallowed)


class DurationStat:
    """Duration summary (count + sum + max seconds) PLUS a streaming
    fixed-bucket histogram for real quantiles — a mean-only stat let
    call sites advertise a "p50 budget" while reporting means, which
    hides exactly the tail the flight recorder exists to attribute.
    Buckets are log2-spaced from 1µs: bucket i covers
    [2^i µs, 2^(i+1) µs), 36 buckets reaching ~19h, so one observe is
    a frexp + an increment.  Observations happen on flush/round
    boundaries (ms-scale work), so a tiny lock is fine; the
    per-decision hot path never touches one."""

    __slots__ = ("count", "total", "max", "buckets", "exemplars", "_lock")

    N_BUCKETS = 36
    _BASE = 1e-6  # bucket 0 lower bound: 1µs

    # guberlint: guard count, total, max, buckets, exemplars by _lock

    def __init__(self) -> None:
        self.count = 0
        self.total = 0.0
        self.max = 0.0
        self.buckets = [0] * self.N_BUCKETS
        # bucket index -> (trace_id, seconds): the LAST sampled trace
        # that landed in the bucket (bounded by N_BUCKETS entries by
        # construction; populated only while tracing is live AND
        # GUBER_METRICS_EXEMPLARS is on) — what turns a cluster p99
        # bucket into a link to a flight-recorder trace.
        self.exemplars: dict = {}
        self._lock = threading.Lock()

    @classmethod
    def bucket_of(cls, seconds: float) -> int:
        import math

        if seconds <= cls._BASE:
            return 0
        # frexp is exact and ~3x cheaper than log2 here: for
        # m * 2^e with m in [0.5, 1), floor(log2(x)) == e - 1.
        _m, e = math.frexp(seconds / cls._BASE)
        return min(cls.N_BUCKETS - 1, max(0, e - 1))

    @classmethod
    def bucket_bounds(cls, i: int) -> tuple:
        return (cls._BASE * (1 << i), cls._BASE * (1 << (i + 1)))

    def observe(self, seconds: float, count: int = 1) -> None:
        """Record one duration, or `count` events that took `seconds`
        together (paging times a batch of faults once): each lands in the
        bucket of their mean, and the max is that mean."""
        if count != 1:
            self._observe_many(seconds, count)
            return
        b = self.bucket_of(seconds)
        ex = None
        # Exemplar capture: observations happen at flush/window
        # boundaries (see class docstring), so the context lookup is
        # off the per-decision path; a disabled tracer short-circuits
        # at one global check.
        if exemplars_enabled():
            from gubernator_tpu_torch.utils import tracing

            if tracing.active():
                ctx = tracing.current_context()
                if ctx is not None and ctx.sampled:
                    ex = (ctx.trace_id, seconds)
        with self._lock:
            self.count += 1
            self.total += seconds
            if seconds > self.max:
                self.max = seconds
            self.buckets[b] += 1
            if ex is not None:
                self.exemplars[b] = ex

    def _observe_many(self, seconds: float, count: int) -> None:
        if count <= 0:
            return
        each = seconds / count
        b = self.bucket_of(each)
        with self._lock:
            self.count += count
            self.total += seconds
            if each > self.max:
                self.max = each
            self.buckets[b] += count

    def observe_bucket_counts(self, counts) -> None:
        """Merge pre-bucketed counts (index-aligned with N_BUCKETS) —
        the native event collector drains per-stage C histograms this
        way, one lock per drain instead of one per event."""
        n = total = 0.0
        top = 0.0
        for i, c in enumerate(counts):
            if c:
                n += c
                lo, hi = self.bucket_bounds(i)
                total += c * (lo + hi) / 2.0
                top = (lo * hi) ** 0.5
        if not n:
            return
        with self._lock:
            self.count += int(n)
            self.total += total
            # Max at bucket resolution (the geometric midpoint of the
            # highest occupied bucket) — pre-bucketed merges lose the
            # exact extremum by construction.
            if top > self.max:
                self.max = top
            for i, c in enumerate(counts):
                if c:
                    self.buckets[i] += int(c)

    def bucket_snapshot(self) -> dict:
        """One consistent {count, total, max, buckets} view — the
        wire shape of the fleet rollup (obs/fleet.py): a peer ships
        this and the collector merges it exactly."""
        with self._lock:
            return {
                "count": self.count,
                "total": self.total,
                "max": self.max,
                "buckets": list(self.buckets),
            }

    def merge_snapshot(self, snap: dict) -> None:
        """EXACT merge of another DurationStat's bucket_snapshot():
        counts/totals/max add, buckets add index-aligned — unlike
        observe_bucket_counts there is no midpoint approximation, so
        a fleet-merged mean is the true cluster mean and the merged
        quantiles are real histogram quantiles, not means-of-means."""
        buckets = snap.get("buckets") or []
        with self._lock:
            self.count += int(snap.get("count", 0))
            self.total += float(snap.get("total", 0.0))
            m = float(snap.get("max", 0.0))
            if m > self.max:
                self.max = m
            for i, c in enumerate(buckets[: self.N_BUCKETS]):
                if c:
                    self.buckets[i] += int(c)

    def exemplar_snapshot(self) -> dict:
        """{bucket index: (trace_id, seconds)} of live exemplars.
        Exemplars whose trace the in-memory tracer has fully evicted
        are pruned HERE (from the snapshot and the retained table):
        a metrics→trace link must never point at a trace that no
        longer exists."""
        with self._lock:
            out = dict(self.exemplars)
        if not out:
            return out
        from gubernator_tpu_torch.utils import tracing

        has = getattr(tracing.current_tracer(), "has_trace", None)
        if has is None:
            return out
        for b, (tid, _v) in list(out.items()):
            if not has(tid):
                del out[b]
                with self._lock:
                    cur = self.exemplars.get(b)
                    if cur is not None and cur[0] == tid:
                        del self.exemplars[b]
        return out

    def mean(self) -> float:
        # Under the lock so count/total come from the same observation
        # (a torn pair between two observes skews the scrape).
        with self._lock:
            return self.total / self.count if self.count else 0.0

    def quantile(self, q: float) -> float:
        """Streaming quantile from the histogram (geometric bucket
        midpoint; resolution is a factor of 2 — honest for budget
        attribution, not for micro-benchmarks)."""
        with self._lock:
            n = self.count
            if not n:
                return 0.0
            rank = q * (n - 1)
            seen = 0
            for i, c in enumerate(self.buckets):
                seen += c
                if seen > rank:
                    lo, hi = self.bucket_bounds(i)
                    return (lo * hi) ** 0.5
            return self.max

    def p50(self) -> float:
        return self.quantile(0.50)

    def p99(self) -> float:
        return self.quantile(0.99)

    def snapshot_ms(self, digits: int = 3) -> dict:
        """The canonical {count, mean_ms, p50_ms, p99_ms, max_ms}
        rendering — shared by /debug/vars, the rollup's quantiles and
        the native event collector's stages, so the shape cannot drift
        between them."""
        with self._lock:
            count = self.count
            mean_s = self.total / count if count else 0.0
            max_s = self.max
        # The quantiles take the lock themselves; an observation
        # landing between the reads skews one scrape by one event.
        return {
            "count": count,
            "mean_ms": round(mean_s * 1e3, digits),
            "p50_ms": round(self.p50() * 1e3, digits),
            "p99_ms": round(self.p99() * 1e3, digits),
            "max_ms": round(max_s * 1e3, digits),
        }
