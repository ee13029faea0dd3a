"""The port's copy of the reference's metrics module
(gubernator_tpu/utils/metrics.py), with its Prometheus export written on
the stdlib (utils/exposition.py, no prometheus_client):
`record_swallowed`, the per-site count of exceptions a background loop
caught and carried on after (:67); `DurationStat` (:79), a duration
summary with a streaming log2 histogram, real quantiles, exact merges and
trace exemplars (GUBER_METRICS_EXEMPLARS); `InstanceCollector` (:275),
every family the reference's /metrics emits, in its order, with its HELP,
TYPE and labels; `FleetRollupCollector` / `build_fleet_registry` (:1004)
for `?fleet=1`; and `build_registry` (:1080) with the GUBER_METRIC_FLAGS
collectors (`ProcessCollector`, `GCCollector`, `PlatformCollector`, the
names and labels of prometheus_client's).

The families of planes the port lacks (peer health, membership, handoff,
replication, GLOBAL queues, multi-region, gRPC request stats) carry the
values the reference's node with no peers gives them, as /debug/vars
does; `gubernator_jit_recompiles` counts XLA compiles there and has no
counterpart on CUDA: it reads 0.  A scrape reads host counters only: it
launches no kernel and copies nothing from the device.
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


# ---------------------------------------------------------------------
# Prometheus export (reference utils/metrics.py:275-1101).

from gubernator_tpu_torch.utils.exposition import (  # noqa: E402
    CollectorRegistry,
    CounterMetricFamily,
    Exemplar,
    GaugeMetricFamily,
    HistogramMetricFamily,
    SummaryMetricFamily,
)

# gubernator_replication_events' series, in the reference's order.
_REPLICATION_EVENTS = ("promoted", "demoted", "grants_sent", "grants_failed",
                       "grants_received", "revokes_received", "stale_dropped", "expired")


class InstanceCollector:
    """Exports engine, service and ledger counters (reference
    utils/metrics.py:275; reference: gubernator.go:780-809).  `address`
    is this node's own peer address: the reference's one-node daemon
    lists itself as its only peer, whose queue-length series it emits."""

    def __init__(self, instance, address: str = ""):
        self.instance = instance
        self.address = address

    def collect(self):
        inst = self.instance
        eng = inst.engine
        counters = inst.counters

        def counter(name, doc, value):
            c = CounterMetricFamily(name, doc)
            c.add_metric([], value)
            return c

        def gauge(name, doc, value):
            g = GaugeMetricFamily(name, doc)
            g.add_metric([], value)
            return g

        def labelled(family, name, doc, label, pairs):
            f = family(name, doc, labels=[label])
            for lv, v in pairs:
                f.add_metric([lv], v)
            return f

        yield counter("gubernator_check_counter", "The number of rate limits checked.",
                      eng.requests_total)
        yield counter("gubernator_over_limit_counter",
                      "The number of rate limit checks that are over the limit.",
                      eng.over_limit_total)
        yield counter("gubernator_check_error_counter",
                      "The number of errors while checking rate limits.",
                      counters["check_errors"])
        yield labelled(CounterMetricFamily, "gubernator_getratelimit_counter",
                       "The count of getRateLimit() calls by calltype.", "calltype",
                       [("local", counters["local"]), ("forward", counters["forward"]),
                        ("global", counters["global"]), ("sketch", counters.get("sketch", 0)),
                        ("replicated", counters.get("replicated_local", 0))])
        yield counter(
            "gubernator_global_miss_local",
            "GLOBAL items served by a LOCAL eventually-consistent copy "
            "(status-cache miss on a non-owner) — the source of "
            "GLOBAL's bounded over-admission (<= n_nodes * limit per "
            "broadcast lag window).",
            counters.get("global_miss_local", 0))
        yield counter("gubernator_asyncrequest_retries",
                      "The count of retries in the forward path.", counters["async_retries"])
        yield counter(
            "gubernator_degraded_answers",
            "Requests answered by THIS node's engine because every "
            "owner candidate was circuit-open/unreachable "
            "(GUBER_DEGRADED_LOCAL).  Availability bought with bounded "
            "over-admission: <= N_partitions * limit per key.",
            counters.get("degraded_answers", 0))
        yield counter(
            "gubernator_backoff_retries",
            "Forward retries that waited out a capped-exponential "
            "backoff window before re-picking an owner.",
            counters.get("backoff_retries", 0))
        # Peer health: a node with no peers has none but itself, which
        # is never dialed.
        yield GaugeMetricFamily(
            "gubernator_peer_state",
            "Per-peer circuit state (1 on the current state's series): "
            "healthy | suspect | broken | half-open.",
            labels=["peer", "state"])
        yield CounterMetricFamily("gubernator_circuit_transitions",
                                  "Circuit state transitions per peer, by to-state.",
                                  labels=["peer", "to"])
        # Membership: one stable epoch, no handoff.
        yield gauge(
            "gubernator_membership_epoch",
            "This node's membership epoch (bumps on every observed "
            "view change; equal across nodes once a transition "
            "settles).", 1)
        yield gauge(
            "gubernator_membership_dual",
            "1 while a dual-ring cutover window is open (old + new "
            "rings both valid), else 0.", 0)
        yield counter(
            "gubernator_ring_dual_window_seconds",
            "Cumulative seconds this node has spent inside "
            "dual-ring cutover windows.", 0.0)
        yield labelled(
            CounterMetricFamily, "gubernator_handoff_keys",
            "Ownership-handoff bucket rows by event: shipped to a "
            "new owner, forfeited at the epoch deadline (bounded "
            "over-admission, RESILIENCE.md §10), or received and "
            "restored here.", "event",
            [("shipped", 0), ("forfeited", 0), ("received", 0)])
        if inst.hotkeys is not None:
            # The reference's daemon runs its replication plane with the
            # hot-key sketch; with no peer it replicates nothing.
            yield labelled(
                GaugeMetricFamily, "gubernator_replication_keys",
                "Live hot-key replication state by role: promoted = "
                "keys THIS node (as owner) currently replicates; "
                "replica_leases = remote credit leases held here.", "role",
                [("promoted", 0), ("replica_leases", 0)])
            yield labelled(
                CounterMetricFamily, "gubernator_replication_events",
                "Hot-key replication lifecycle events by kind "
                "(promoted | demoted | grants_sent | grants_failed | "
                "grants_received | revokes_received | stale_dropped | "
                "expired).", "event", [(ev, 0) for ev in _REPLICATION_EVENTS])
            yield counter(
                "gubernator_replication_answered",
                "Peer-owned decisions answered locally from a replica "
                "credit lease (the forward hops replication removed; "
                "natively answered drains fold in at pull time).", 0)
            yield labelled(
                CounterMetricFamily, "gubernator_replication_credit",
                "Replication credit flow in hits, by event: granted "
                "(pre-debited onto replica leases), returned (unused "
                "credit settled back), forfeited (lost to unreachable "
                "replicas — bounded by N_replicas × lease per window).", "event",
                [("granted", 0), ("returned", 0), ("forfeited", 0)])
        yield labelled(
            CounterMetricFamily, "gubernator_hits_requeue",
            "GLOBAL hit-window re-queue traffic toward unreachable "
            "owners, by event (requeued | dropped at the age cap).", "event",
            [("requeued", 0), ("dropped", 0)])
        yield labelled(
            CounterMetricFamily, "gubernator_broadcasts_skipped",
            "Per-peer broadcast pushes skipped, by reason: "
            "circuit_open (the peer is broken) or inflight (its "
            "previous push outlived the fan-out deadline — slow but "
            "healthy).  Supersedable traffic; the peer catches up "
            "from later windows.", "reason", [("circuit_open", 0), ("inflight", 0)])
        yield gauge("gubernator_cache_size", "The number of bucket slots currently interned.",
                    eng.cache_size())
        yield counter("gubernator_global_async_sends",
                      "The count of GLOBAL async hit windows flushed to owners.", 0)
        yield counter("gubernator_global_broadcasts",
                      "The count of GLOBAL broadcast windows pushed to peers.", 0)
        # Multi-region: no remote region.
        yield counter(
            "gubernator_multiregion_windows",
            "Cross-region hit windows flushed (each window fans out "
            "to every remote region under the fan-out barrier).", 0)
        yield CounterMetricFamily("gubernator_multiregion_region_sends",
                                  "Successful per-region delta pushes, by remote region.",
                                  labels=["region"])
        yield counter(
            "gubernator_multiregion_hits_requeued",
            "Cross-region deltas re-queued toward an unreachable "
            "region (bounded, age-capped, delivered after heal).", 0)
        yield counter(
            "gubernator_multiregion_hits_dropped",
            "Cross-region deltas dropped at the requeue age/key cap "
            "or toward a departed region — counted, never silent; the "
            "drift bound covers what they would have reconciled.", 0)
        yield GaugeMetricFamily(
            "gubernator_multiregion_region_state",
            "Aggregate circuit state per remote region (1 on the "
            "current state's series): healthy | degraded | open.",
            labels=["region", "state"])
        yield counter(
            "gubernator_multiregion_degraded_answers",
            "MULTI_REGION answers served while a remote region's "
            "circuit was open (metadata.degraded_region=true; "
            "over-admission bounded at N_regions x limit per window).",
            counters.get("degraded_region_answers", 0))
        yield counter("gubernator_engine_batches", "Engine batches applied (device step groups).",
                      eng.batches_total)
        yield counter(
            "gubernator_engine_rounds",
            "Device kernel rounds executed (≥1 per batch; >1 when a "
            "batch repeats keys).", eng.rounds_total)
        paging = getattr(eng, "paging", None)
        if paging is not None:
            yield gauge(
                "gubernator_paged_pages_resident",
                "Device frames resident (pages the clock hand ranks); "
                "total pages = ceil(logical capacity / page size).", paging.frames)
            yield counter(
                "gubernator_paged_faults",
                "Page faults: batches touching a non-resident key "
                "paid a spill+refill before their round dispatched.", paging.faults)
            yield counter(
                "gubernator_paged_spills",
                "Cold pages spilled to the host store (one d2h gather "
                "of the page's raw words each).", paging.spills)
            yield SummaryMetricFamily(
                "gubernator_paged_refill_wait",
                "Seconds a faulting batch waited for its page refill "
                "scatter (h2d + donated update).",
                count_value=paging.refill_wait.count, sum_value=paging.refill_wait.total)
        # Queue depths: the node itself is its only peer.
        yield labelled(GaugeMetricFamily, "gubernator_queue_length",
                       "Per-peer batch queue depth (requests awaiting a flush).", "peer",
                       [(self.address, 0)])
        yield labelled(GaugeMetricFamily, "gubernator_global_queue_length",
                       "GLOBAL manager queue depths by queue.", "queue",
                       [("hits", 0), ("broadcasts", 0)])
        yield labelled(GaugeMetricFamily, "gubernator_global_backlog_age_seconds",
                       "Age of the oldest queued GLOBAL item by queue.", "queue",
                       [("hits", 0.0), ("broadcasts", 0.0)])
        yield labelled(
            CounterMetricFamily, "gubernator_global_dropped",
            "GLOBAL queue items shed under overload (supersedable "
            "broadcasts only; hits block instead of dropping).", "queue",
            [("hits", 0), ("broadcasts", 0)])
        yield SummaryMetricFamily("gubernator_batch_send_duration",
                                  "Seconds spent flushing peer request batches.",
                                  count_value=0, sum_value=0.0)
        yield SummaryMetricFamily("gubernator_global_send_duration",
                                  "Seconds spent sending GLOBAL hit windows to owners.",
                                  count_value=0, sum_value=0.0)
        yield SummaryMetricFamily("gubernator_broadcast_duration",
                                  "Seconds spent broadcasting GLOBAL statuses to peers.",
                                  count_value=0, sum_value=0.0)
        yield SummaryMetricFamily("gubernator_engine_round_duration",
                                  "Seconds of host-side dispatch per device kernel round.",
                                  count_value=eng.round_duration.count,
                                  sum_value=eng.round_duration.total)
        s = SummaryMetricFamily("gubernator_stage_duration",
                                "Seconds per GLOBAL-path pipeline stage.", labels=["stage"])
        for stage, stat in inst.stage_timers.items():
            s.add_metric([stage], count_value=stat.count, sum_value=stat.total)
        yield s
        g = GaugeMetricFamily(
            "gubernator_stage_quantile_seconds",
            "Streaming per-stage latency quantiles (log2-bucket "
            "histogram; resolution one octave).  Stages: the pipeline "
            "stage timers plus the event-ring stages under their own "
            "names (native_serve / window_wait / window_serve).",
            labels=["stage", "quantile"])
        quantile_stats = dict(inst.stage_timers)
        ev = inst.native_events
        if ev is not None:
            quantile_stats.update(ev.histograms())
        for stage, stat in quantile_stats.items():
            g.add_metric([stage, "0.5"], stat.p50())
            g.add_metric([stage, "0.99"], stat.p99())
        yield g
        h = HistogramMetricFamily(
            "gubernator_stage_seconds",
            "Per-stage latency histogram (36 log2 buckets from 1µs; "
            "the raw counts behind gubernator_stage_quantile_seconds, "
            "mergeable across nodes into real cluster quantiles).",
            labels=["stage"])
        for stage, stat in quantile_stats.items():
            snap = stat.bucket_snapshot()
            exs = stat.exemplar_snapshot()
            cum = 0
            buckets = []
            for i, c in enumerate(snap["buckets"]):
                cum += c
                hi = DurationStat.bucket_bounds(i)[1]
                ex = exs.get(i)
                if ex is not None:
                    buckets.append((f"{hi:.9g}", float(cum),
                                    Exemplar({"trace_id": ex[0]}, float(ex[1]))))
                else:
                    buckets.append((f"{hi:.9g}", float(cum)))
            buckets.append(("+Inf", float(snap["count"])))
            h.add_metric([stage], buckets, sum_value=snap["total"])
        yield h
        wd = inst.slo_watchdog
        if wd is not None:
            snap = wd.metrics_snapshot()
            g = GaugeMetricFamily(
                "gubernator_slo_burn_rate",
                "Error-budget burn rate per declared SLI and window "
                "(>1 = burning budget faster than the SLO allows; "
                "multi-window multi-burn-rate alerting, obs/slo.py).",
                labels=["sli", "window"])
            for (sli, window), v in sorted(snap["burn"].items()):
                g.add_metric([sli, window], v)
            yield g
            g = GaugeMetricFamily(
                "gubernator_invariant_headroom",
                "Per watched finite-limit key: derived admission "
                "bound minus observed admitted hits in the current "
                "window (negative = a RESILIENCE.md invariant was "
                "violated; the bound label names the derivation).",
                labels=["key", "bound"])
            for (key, bound), v in sorted(snap["headroom"].items()):
                g.add_metric([key, bound], v)
            yield g
        if ev is not None:
            c = CounterMetricFamily(
                "gubernator_native_events",
                "Event-ring records drained from the C front, by "
                "stage (native_serve | window_wait | window_serve).",
                labels=["stage"])
            for stage, n in sorted(ev.event_counts().items()):
                c.add_metric([stage], n)
            yield c
            yield counter(
                "gubernator_native_ring_dropped",
                "Event-ring writes dropped because the ring was full "
                "(the C front never blocks on observability).",
                ev.ring_stats().get("dropped", 0))
            s = SummaryMetricFamily("gubernator_native_stage_duration",
                                    "Seconds per native-front stage, from the event ring.",
                                    labels=["stage"])
            for stage, stat in ev.histograms().items():
                s.add_metric([stage], count_value=stat.count, sum_value=stat.total)
            yield s
        front = inst.h2_front
        if front is not None:
            cs = front.conn_stats()
            yield labelled(
                GaugeMetricFamily, "gubernator_h2_conns",
                "Native h2 front connections by state: open = currently "
                "held fds; idle_reaped = cumulative idle-timeout kills "
                "(GUBER_H2_IDLE_TIMEOUT; GOAWAY + close).", "state",
                [("open", float(cs["conns_open"])),
                 ("idle_reaped", float(cs["conns_idle_reaped"]))])
        hk = inst.hotkeys
        if hk is not None:
            yield labelled(
                GaugeMetricFamily, "gubernator_hotkeys",
                "Estimated hits for the top-K decision keys "
                "(space-saving sketch; over-estimate bounded by the "
                "reported error).", "key",
                [(key.decode(errors="replace"), float(count))
                 for key, count, _err in hk.top(10)])
        led = inst.ledger
        if led is not None:
            yield counter(
                "gubernator_ledger_answered",
                "Decisions answered by the host decision ledger "
                "(sticky over-limit + lease credit) with zero device "
                "work.", led.answered)
            yield counter("gubernator_ledger_fallthrough",
                          "Ledger-considered rows that fell through to the engine.",
                          led.fallthrough)
            yield labelled(CounterMetricFamily, "gubernator_ledger_leases",
                           "Lease lifecycle events by kind.", "event",
                           [("granted", led.leases_granted), ("revoked", led.leases_revoked)])
            yield counter(
                "gubernator_ledger_settles",
                "Settle rows applied back to the device (consumed "
                "lease credits reconciled).", led.settles)
            yield SummaryMetricFamily("gubernator_ledger_settle_lag",
                                      "Seconds from lease revocation to the settle apply.",
                                      count_value=led.settle_lag.count,
                                      sum_value=led.settle_lag.total)
        native_answered = led.native_answered() if led else 0
        if led is not None:
            yield counter(
                "gubernator_ledger_native_answered",
                "Decisions answered by the native decision plane "
                "(C-resident ledger fast path: zero GIL, zero Python "
                "frames, zero device work).", native_answered)
        decisions = eng.requests_total + (led.answered + native_answered if led else 0)
        yield gauge("gubernator_dispatches_per_decision",
                    "Engine kernel rounds per rate-limit decision (cumulative ratio).",
                    eng.rounds_total / decisions if decisions else 0.0)
        # The reference's GLOBAL queues and its GLOBAL serve window, idle.
        yield labelled(GaugeMetricFamily, "gubernator_adaptive_window_seconds",
                       "Current load-adaptive batching window by queue.", "queue",
                       [("hits", 0.0), ("broadcasts", 0.0), ("global_serve", 0.0)])
        yield labelled(CounterMetricFamily, "gubernator_swallowed_exceptions",
                       "Exceptions swallowed by catch-and-continue sites, by site.", "site",
                       sorted(swallowed_counts().items()))
        yield counter(
            "gubernator_jit_recompiles",
            "XLA backend compiles observed since process start "
            "(0 when the jax monitoring hook is unavailable).", 0)


class GrpcStatsCollector:
    """`gubernator_grpc_request_counts` / `_duration` (reference
    utils/grpc_stats.py): the port serves no call through a gRPC server
    (the h2 front does not feed them in the reference either), so both
    are empty, as on a reference node no gRPC call has reached."""

    def collect(self):
        yield CounterMetricFamily("gubernator_grpc_request_counts",
                                  "The count of gRPC requests.", labels=["method", "failed"])
        yield SummaryMetricFamily("gubernator_grpc_request_duration",
                                  "Duration of gRPC requests in seconds.", labels=["method"])


class FleetRollupCollector:
    """One merged fleet rollup (obs/fleet.FleetCollector.collect()) as
    gubernator_fleet_* families, for /metrics?fleet=1 (reference
    utils/metrics.py:1004)."""

    def __init__(self, rollup: dict):
        self.rollup = rollup

    def collect(self):
        r = self.rollup
        regions = r.get("regions") or {}
        g = GaugeMetricFamily("gubernator_fleet_nodes",
                              "Nodes merged into this fleet rollup, by region.",
                              labels=["region"])
        for region, sub in sorted(regions.items()):
            g.add_metric([region or "default"], sub.get("nodes", 0))
        yield g
        c = CounterMetricFamily(
            "gubernator_fleet_counter",
            "Fleet-summed node counters by name and region (the "
            "per-region subtotals come from the nodes' DC tags; the "
            "cluster total is the sum over regions).",
            labels=["counter", "region"])
        for region, sub in sorted(regions.items()):
            for name, v in sorted((sub.get("counters") or {}).items()):
                c.add_metric([name, region or "default"], v)
        yield c
        g = GaugeMetricFamily(
            "gubernator_fleet_gauge",
            "Per-node gauges label-joined by peer and region (gauges "
            "do not sum — cache sizes and queue depths are per-node "
            "facts).",
            labels=["gauge", "peer", "region"])
        for name, by_peer in sorted((r.get("gauges") or {}).items()):
            for peer, (region, v) in sorted(by_peer.items()):
                g.add_metric([name, peer, region or "default"], v)
        yield g
        g = GaugeMetricFamily(
            "gubernator_fleet_stage_quantile_seconds",
            "REAL cluster-wide per-stage quantiles from histogram "
            "merge (DurationStat.merge_snapshot over every node's "
            "36-bucket histogram) — not means of per-node quantiles.",
            labels=["stage", "quantile"])
        for stage, q in sorted((r.get("quantiles") or {}).items()):
            g.add_metric([stage, "0.5"], q.get("p50_ms", 0.0) / 1e3)
            g.add_metric([stage, "0.99"], q.get("p99_ms", 0.0) / 1e3)
        yield g
        scrape = r.get("scrape") or {}
        g = GaugeMetricFamily(
            "gubernator_fleet_scrape",
            "The rollup fan-out's own health, by outcome: peers that "
            "answered (ok), failed inside the budget (failed), or "
            "were skipped because their circuit was open (skipped).",
            labels=["outcome"])
        for outcome in ("ok", "failed", "skipped"):
            g.add_metric([outcome], scrape.get(outcome, 0))
        yield g


def build_fleet_registry(rollup: dict) -> CollectorRegistry:
    """Throwaway registry for one /metrics?fleet=1 scrape."""
    reg = CollectorRegistry()
    reg.register(FleetRollupCollector(rollup))
    return reg


class ProcessCollector:
    """process_* from /proc/self (stat, limits, fd), as prometheus_client's
    ProcessCollector reads them; nothing where /proc is missing."""

    def __init__(self, proc: str = "/proc"):
        self._proc = proc
        self._ticks = 100.0
        try:
            self._ticks = os.sysconf("SC_CLK_TCK")
        except (ValueError, TypeError, AttributeError, OSError):
            pass
        try:
            import resource

            self._pagesize = resource.getpagesize()
        except ImportError:
            self._pagesize = 4096
        self._btime = 0.0
        try:
            with open(os.path.join(proc, "stat"), "rb") as f:
                for line in f:
                    if line.startswith(b"btime "):
                        self._btime = float(line.split()[1])
        except OSError:
            pass

    def collect(self):
        if not self._btime:
            return []
        pid = os.path.join(self._proc, "self")
        out = []
        try:
            with open(os.path.join(pid, "stat"), "rb") as f:
                parts = f.read().split(b")")[-1].split()
            out.append(GaugeMetricFamily("process_virtual_memory_bytes",
                                         "Virtual memory size in bytes.", value=float(parts[20])))
            out.append(GaugeMetricFamily("process_resident_memory_bytes",
                                         "Resident memory size in bytes.",
                                         value=float(parts[21]) * self._pagesize))
            out.append(GaugeMetricFamily(
                "process_start_time_seconds",
                "Start time of the process since unix epoch in seconds.",
                value=float(parts[19]) / self._ticks + self._btime))
            out.append(CounterMetricFamily(
                "process_cpu_seconds_total", "Total user and system CPU time spent in seconds.",
                value=float(parts[11]) / self._ticks + float(parts[12]) / self._ticks))
        except OSError:
            pass
        try:
            with open(os.path.join(pid, "limits"), "rb") as f:
                for line in f:
                    if line.startswith(b"Max open file"):
                        max_fds = GaugeMetricFamily("process_max_fds",
                                                    "Maximum number of open file descriptors.",
                                                    value=float(line.split()[3]))
                        break
            out.append(GaugeMetricFamily("process_open_fds", "Number of open file descriptors.",
                                         len(os.listdir(os.path.join(pid, "fd")))))
            out.append(max_fds)
        except OSError:
            pass
        return out


class GCCollector:
    """python_gc_* from gc.get_stats(), per generation."""

    def collect(self):
        import gc

        collected = CounterMetricFamily("python_gc_objects_collected",
                                        "Objects collected during gc", labels=["generation"])
        uncollectable = CounterMetricFamily("python_gc_objects_uncollectable",
                                            "Uncollectable objects found during GC",
                                            labels=["generation"])
        collections = CounterMetricFamily("python_gc_collections",
                                          "Number of times this generation was collected",
                                          labels=["generation"])
        for gen, stat in enumerate(gc.get_stats()):
            collected.add_metric([str(gen)], stat["collected"])
            uncollectable.add_metric([str(gen)], stat["uncollectable"])
            collections.add_metric([str(gen)], stat["collections"])
        return [collected, uncollectable, collections]


class PlatformCollector:
    """python_info from the platform module."""

    def __init__(self):
        import platform

        major, minor, patchlevel = platform.python_version_tuple()
        info = {"version": platform.python_version(),
                "implementation": platform.python_implementation(),
                "major": major, "minor": minor, "patchlevel": patchlevel}
        g = GaugeMetricFamily("python_info", "Python platform information", labels=list(info))
        g.add_metric(list(info.values()), 1)
        self._metrics = [g]

    def collect(self):
        return self._metrics


def build_registry(instance, metric_flags=(), *, address: str = "") -> CollectorRegistry:
    """A daemon's registry (reference utils/metrics.py:1080 and
    daemon.py:249-256): the instance's families, then GUBER_METRIC_FLAGS'
    ("os": process_*; "python" / "golang": python_gc_* and python_info;
    "all": both), then the gRPC request families."""
    import gc
    import platform

    reg = CollectorRegistry()
    reg.register(InstanceCollector(instance, address))
    flags = {f.strip().lower() for f in metric_flags if f.strip()}
    if flags & {"os", "all"}:
        reg.register(ProcessCollector())
    if flags & {"python", "golang", "all"}:
        if hasattr(gc, "get_stats") and platform.python_implementation() == "CPython":
            reg.register(GCCollector())
        reg.register(PlatformCollector())
    reg.register(GrpcStatsCollector())
    return reg
