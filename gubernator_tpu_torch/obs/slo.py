"""SLO/invariant watchdog: declared SLIs, multi-window burn rates,
and the admission-bound invariant as a live gauge.

The port's copy of gubernator_tpu/obs/slo.py.  On the port's node with
no peers it reads the local rollup (`obs.fleet.FleetCollector`), whose
counters and histograms are this node's; the SLIs of planes the port
lacks (regions, GLOBAL requeues) read zero.  The reference's module
docstring follows.

Until this plane, the bounded-drift invariants the resilience tiers
are built on (over-admission ≤ N_partitions / N_replicas / N_regions
× limit — RESILIENCE.md §§10-12) were proven in tests and bench
canaries only; nothing watched them on a live cluster.  This module
turns them, plus the serving SLOs, into continuously evaluated
gauges:

* **SLIs are declared data** (`SLI` rows in `DEFAULT_SLIS`): each
  names the documented metric backing it — guberlint's drift ``slo``
  sub-rule pins the link, so an SLI can never reference a series the
  registry stopped exporting.

* **Multi-window multi-burn-rate** (the SRE-workbook shape): each SLI
  evaluates over a FAST pair (5m / 1h, factor 14.4 — pages) and a
  SLOW pair (6h / 3d, factor 1.0 — tickets); a breach needs BOTH
  windows of a pair over the factor, which kills both blips (short
  window alone) and stale alerts (long window alone).  Window lengths
  shrink via GUBER_SLO_FAST_WINDOWS / GUBER_SLO_SLOW_WINDOWS for the
  test timescale.  Window history is the watchdog's own sample ring;
  windows longer than the retained history evaluate against the
  oldest sample (reported as the actual span).

* **The admission-bound invariant**: watched finite-limit keys
  (AdmissionWatch) count their cluster-wide ADMITTED hits per
  duration window; the watchdog derives the applicable bound
  (N_regions × limit on a federated cluster, N_nodes × limit
  otherwise) and exports ``gubernator_invariant_headroom{key,bound}``
  = bound − admitted.  Negative headroom is a violated RESILIENCE.md
  proof — on a healthy cluster it never goes below zero, and a new
  duration window restores it to the full bound.

Breaches are recorded as span events (``slo_breach`` inside
``slo.evaluate``) and in a bounded breach log served at /debug/slo.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

log = logging.getLogger("gubernator_tpu_torch.obs.slo")

_OFF_VALUES = ("0", "false", "no", "off")


@dataclass(frozen=True)
class SLI:
    """One declared service-level indicator.

    `metric` names the DOCUMENTED metric family backing the SLI (the
    drift ``slo`` sub-rule checks it against utils/metrics.py).  The
    kind selects the evaluation:

    - ``ratio``: burn = (Δ`bad` / Δ`total` over the window) / budget,
      budget = 1 − objective;
    - ``quantile``: burn = merged-histogram p99 of `stage` /
      `threshold_ms` (a cluster tail SLO — the rollup's histogram
      merge makes this a real quantile);
    - ``drops``: like ratio, but `bad` counts shed work (silent-loss
      SLIs: ring drops, requeue age-cap drops);
    - ``invariant``: burn = max over watched keys of admitted/bound
      (the admission-bound SLI; headroom rides its own gauge).
    """

    name: str
    metric: str
    kind: str
    bad: str = ""
    total: str = ""
    stage: str = ""
    threshold_ms: float = 0.0
    objective: float = 0.999


DEFAULT_SLIS: Tuple[SLI, ...] = (
    SLI(
        name="error_rate",
        metric="gubernator_check_error_counter",
        kind="ratio", bad="check_errors", total="checks",
        objective=0.999,
    ),
    SLI(
        name="degraded_fraction",
        metric="gubernator_degraded_answers",
        kind="ratio", bad="degraded_answers", total="checks",
        objective=0.99,
    ),
    SLI(
        name="degraded_region_fraction",
        metric="gubernator_multiregion_degraded_answers",
        kind="ratio", bad="degraded_region_answers", total="checks",
        objective=0.99,
    ),
    SLI(
        name="window_wait_p99",
        metric="gubernator_stage_seconds",
        kind="quantile", stage="window_wait", threshold_ms=50.0,
    ),
    SLI(
        name="feeder_ring_wait_p99",
        metric="gubernator_native_stage_duration",
        kind="quantile", stage="feeder_ring_wait", threshold_ms=25.0,
    ),
    SLI(
        name="reactor_wake_p99",
        metric="gubernator_native_events",
        kind="quantile", stage="reactor_wake", threshold_ms=25.0,
    ),
    SLI(
        name="ring_drops",
        metric="gubernator_native_ring_dropped",
        kind="drops", bad="native_ring_dropped", total="checks",
        objective=0.999,
    ),
    SLI(
        name="requeue_drops",
        metric="gubernator_multiregion_hits_dropped",
        kind="drops", bad="multiregion_hits_dropped", total="checks",
        objective=0.999,
    ),
    SLI(
        name="admission_bound",
        metric="gubernator_invariant_headroom",
        kind="invariant",
    ),
)


class AdmissionWatch:
    """Bounded per-key ADMITTED-hit counters for watched finite-limit
    keys — the local half of the admission-bound invariant.

    Zero steady-state cost: serve paths peek one attribute (`active`)
    and return when nothing is watched.  Counts accrue at the
    CLIENT-FACING boundary only — get_rate_limits' final responses
    (local, forwarded, degraded, GLOBAL-cached and replica-lease
    answers alike) and the client-facing pb-columnar route.  Internal
    re-applies (multiregion delta pushes, GLOBAL hit windows, handoff
    restores) replay hits a client was already answered for and are
    deliberately NOT counted — they would double-bill the N×limit
    bound; the zero-Python raw-wire front under-counts by design
    (safe direction, documented in OBSERVABILITY.md).  A response's
    `reset_time` advancing past the stored one means a NEW duration
    window: the count resets, so headroom recovers once a
    partition-era window expires."""

    _MAX_KEYS = 64

    # guberlint: guard _keys by _lock

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._keys: Dict[str, dict] = {}
        # Lock-free fast-path peek; written only under the lock.
        self.active = False

    def watch(self, key: str, limit: int = 0) -> bool:
        """Start counting `key` (a hash key, "name_uniquekey");
        bounded at _MAX_KEYS — refusals return False, never evict."""
        with self._lock:
            if key not in self._keys and len(self._keys) >= self._MAX_KEYS:
                return False
            self._keys.setdefault(
                key,
                {"admitted": 0, "limit": int(limit), "reset_time": 0},
            )
            self.active = True
            return True

    def unwatch(self, key: str) -> None:
        with self._lock:
            self._keys.pop(key, None)
            self.active = bool(self._keys)

    def _observe_locked(
        self, ent: dict, hits: int, status: int, limit: int, reset: int
    ) -> None:
        if reset > ent["reset_time"]:
            # A new duration window: the bound re-arms.
            ent["reset_time"] = int(reset)
            ent["admitted"] = 0
        if status == 0 and hits > 0:  # UNDER_LIMIT ⇒ the hits landed
            ent["admitted"] += int(hits)
        if limit > 0:
            ent["limit"] = int(limit)

    def observe_batch(self, reqs, resps) -> None:
        """Client-facing dataclass route (get_rate_limits' final
        responses — every answer shape funnels through there)."""
        with self._lock:
            if not self._keys:
                return
            for r, resp in zip(reqs, resps):
                ent = self._keys.get(r.hash_key())
                if ent is None or resp is None or resp.error:
                    continue
                self._observe_locked(
                    ent, int(r.hits), int(resp.status), int(r.limit),
                    int(resp.reset_time),
                )

    def observe_columns(self, keys_str, hits, cols) -> None:
        """pb-columnar serve route (apply_columnar_local): `cols` is
        the engine's (status, limit, remaining, reset_time) tuple."""
        status, limit, _remaining, reset = cols
        with self._lock:
            if not self._keys:
                return
            for i, k in enumerate(keys_str):
                ent = self._keys.get(k)
                if ent is None:
                    continue
                self._observe_locked(
                    ent, int(hits[i]), int(status[i]), int(limit[i]),
                    int(reset[i]),
                )

    def snapshot(self) -> Dict[str, dict]:
        with self._lock:
            return {k: dict(v) for k, v in self._keys.items()}


def watch_keys_from_env(watch: AdmissionWatch) -> None:
    """Seed the admission watch from GUBER_SLO_WATCH_KEYS: comma-
    separated hash keys, each optionally ``key:limit``."""
    raw = os.environ.get("GUBER_SLO_WATCH_KEYS", "")
    for entry in raw.split(","):
        entry = entry.strip()
        if not entry:
            continue
        key, _, lim = entry.rpartition(":")
        if key and lim.isdigit():
            watch.watch(key, int(lim))
        else:
            watch.watch(entry)


def _windows_env(env_key: str, default: str) -> Tuple[float, float]:
    raw = os.environ.get(env_key, "") or default
    try:
        short_s, long_s = (float(x) for x in raw.split(",")[:2])
        if short_s <= 0 or long_s <= 0:
            raise ValueError(raw)
        return (short_s, long_s)
    except (ValueError, TypeError):
        log.warning("%s=%r is not 'short,long' seconds; using %s",
                    env_key, raw, default)
        short_s, long_s = (float(x) for x in default.split(","))
        return (short_s, long_s)


class SLOWatchdog:
    """Evaluates the declared SLIs against fleet rollups on a
    background cadence; /debug/fleet calls `evaluate` on demand.

    Scope: with GUBER_SLO_FLEET=1 each tick scrapes the whole fleet
    (the rollup-node posture — the bench and smoke run this); the
    default ticks evaluate this node's LOCAL slice only, so a large
    cluster is not all-pairs scraping itself every interval, and the
    fleet view stays an on-demand (or single-designated-node)
    fan-out."""

    _HISTORY_CAP = 4096
    _BREACH_CAP = 256

    # guberlint: guard _history, _breaches, _burn, _headroom by _lock

    def __init__(
        self,
        fleet,
        admission: Optional[AdmissionWatch],
        *,
        slis: Tuple[SLI, ...] = DEFAULT_SLIS,
        interval: float = 5.0,
        fleet_scope: bool = False,
        fast_windows: Tuple[float, float] = (300.0, 3600.0),
        slow_windows: Tuple[float, float] = (21600.0, 259200.0),
        fast_factor: float = 14.4,
        slow_factor: float = 1.0,
    ) -> None:
        self._fleet = fleet
        self._admission = admission
        self.slis = slis
        self.interval = interval
        self.fleet_scope = fleet_scope
        # (label, short_s, long_s, factor)
        self.pairs = (
            ("fast", fast_windows[0], fast_windows[1], fast_factor),
            ("slow", slow_windows[0], slow_windows[1], slow_factor),
        )
        self._lock = threading.Lock()
        self._history: deque = deque(maxlen=self._HISTORY_CAP)
        self._breaches: deque = deque(maxlen=self._BREACH_CAP)
        self._burn: Dict[Tuple[str, str], float] = {}
        self._headroom: Dict[Tuple[str, str], float] = {}
        self._paused = False
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        if interval > 0:
            self._thread = threading.Thread(
                target=self._run, name="guber-slo-watchdog", daemon=True
            )
            self._thread.start()

    @classmethod
    def from_env(
        cls, fleet, admission: Optional[AdmissionWatch]
    ) -> "SLOWatchdog":
        from gubernator_tpu_torch.config import parse_duration

        raw = os.environ.get("GUBER_SLO_INTERVAL", "").strip()
        interval = 5.0
        if raw:
            try:
                interval = parse_duration(raw)
            except ValueError:
                log.warning(
                    "GUBER_SLO_INTERVAL=%r is not a duration; using 5s",
                    raw,
                )
        fleet_scope = os.environ.get(
            "GUBER_SLO_FLEET", "0"
        ).strip().lower() not in _OFF_VALUES
        return cls(
            fleet,
            admission,
            interval=interval,
            fleet_scope=fleet_scope,
            fast_windows=_windows_env(
                "GUBER_SLO_FAST_WINDOWS", "300,3600"
            ),
            slow_windows=_windows_env(
                "GUBER_SLO_SLOW_WINDOWS", "21600,259200"
            ),
        )

    # -- the tick loop -------------------------------------------------

    def _run(self) -> None:
        from gubernator_tpu_torch.utils.metrics import record_swallowed

        while not self._stop.wait(self.interval):
            if self._paused:
                continue
            try:
                rollup = self._fleet.collect(peers=self.fleet_scope)
                self.evaluate(rollup)
            except Exception:  # noqa: BLE001 — the watchdog must not die
                record_swallowed("slo.tick")
                log.exception("SLO watchdog tick failed")

    def pause(self) -> None:
        """Stop evaluating without tearing the thread down (the
        fleetobs bench's GUBER_OBS=0 arm)."""
        self._paused = True

    def resume(self) -> None:
        self._paused = False

    # -- evaluation ----------------------------------------------------

    @staticmethod
    def inputs_from_rollup(rollup: dict) -> dict:
        """Flatten one rollup into the counter/quantile/admitted
        inputs the SLI evaluations consume."""
        counters = dict(rollup.get("counters") or {})
        quantiles = {
            stage: q.get("p99_ms", 0.0)
            for stage, q in (rollup.get("quantiles") or {}).items()
        }
        return {
            "counters": counters,
            "p99_ms": quantiles,
            "admitted": dict(rollup.get("admitted") or {}),
            "regions": sorted((rollup.get("regions") or {}).keys()),
            "nodes": len(rollup.get("nodes") or ()) or 1,
        }

    def _sample_at_locked(self, now: float, age_s: float) -> Tuple[float, dict]:
        """The NEWEST history sample at least `age_s` old, else the
        oldest retained one (reported span may be shorter than the
        window — honest, and inevitable right after start)."""
        chosen = None
        for t, inputs in self._history:  # oldest → newest
            if now - t >= age_s:
                chosen = (t, inputs)
            else:
                break
        if chosen is None and self._history:
            chosen = self._history[0]
        return chosen if chosen is not None else (now, {})

    @staticmethod
    def _delta(now_in: dict, then_in: dict, key: str) -> float:
        return float((now_in.get("counters") or {}).get(key, 0.0)) - float(
            (then_in.get("counters") or {}).get(key, 0.0)
        )

    def _burn_for(
        self, sli: SLI, now_in: dict, then_in: dict
    ) -> Optional[float]:
        if sli.kind in ("ratio", "drops"):
            dbad = self._delta(now_in, then_in, sli.bad)
            dtotal = self._delta(now_in, then_in, sli.total)
            budget = max(1e-9, 1.0 - sli.objective)
            if dtotal <= 0:
                return 0.0 if dbad <= 0 else dbad / budget
            return (dbad / dtotal) / budget
        if sli.kind == "quantile":
            p99 = (now_in.get("p99_ms") or {}).get(sli.stage)
            if p99 is None or sli.threshold_ms <= 0:
                return None
            return p99 / sli.threshold_ms
        if sli.kind == "invariant":
            worst = 0.0
            for _key, ent in (now_in.get("admitted") or {}).items():
                bound = ent.get("bound", 0)
                if bound:
                    worst = max(worst, ent.get("admitted", 0) / bound)
            return worst
        return None

    def _derive_bounds(self, inputs: dict) -> None:
        """Attach the derived admission bound to each watched key:
        N_regions × limit on a federated cluster (each region answers
        locally from its own ring — RESILIENCE.md §12), N_nodes ×
        limit otherwise (the degraded-answering partition bound,
        §§5/10)."""
        regions = [r for r in inputs.get("regions") or []]
        n_regions = len(regions)
        n = n_regions if n_regions > 1 else max(1, inputs.get("nodes", 1))
        kind = "regions" if n_regions > 1 else "nodes"
        for _key, ent in (inputs.get("admitted") or {}).items():
            limit = int(ent.get("limit", 0))
            ent["bound"] = n * limit
            ent["bound_label"] = f"{n}_{kind}_x_{limit}"

    def evaluate(
        self, rollup: dict, record: bool = True, windowed: bool = True
    ) -> dict:
        """Evaluate every SLI against `rollup` (+ the retained
        history for windowed burns).  With `record`, the sample joins
        the history, the gauges update, and breaches log; without, it
        is a read-only view (the /debug/fleet on-demand path must not
        pollute the watchdog's periodic sample cadence).  With
        `windowed=False` the history-backed SLIs (ratio/drops) are
        SKIPPED: a caller whose rollup scope differs from the
        recorded samples' scope (a fleet rollup on a local-slice
        watchdog) must not difference across scopes — the "delta"
        would be other nodes' lifetime totals masquerading as window
        traffic, breach-level burn for errors that happened hours
        ago.  Quantile and invariant SLIs need no history and always
        evaluate."""
        from gubernator_tpu_torch.utils import tracing
        from gubernator_tpu_torch.utils.tracing import span

        now = time.monotonic()
        inputs = self.inputs_from_rollup(rollup)
        self._derive_bounds(inputs)
        burn: Dict[Tuple[str, str], float] = {}
        breaches: List[dict] = []
        with self._lock:
            for label, short_s, long_s, factor in self.pairs:
                t_short, in_short = self._sample_at_locked(now, short_s)
                t_long, in_long = self._sample_at_locked(now, long_s)
                for sli in self.slis:
                    if not windowed and sli.kind in ("ratio", "drops"):
                        continue
                    b_short = self._burn_for(sli, inputs, in_short)
                    if b_short is None:
                        continue
                    b_long = self._burn_for(sli, inputs, in_long)
                    burn[(sli.name, f"{label}_{short_s:g}s")] = round(
                        b_short, 4
                    )
                    burn[(sli.name, f"{label}_{long_s:g}s")] = round(
                        b_long if b_long is not None else 0.0, 4
                    )
                    if b_short > factor and (b_long or 0.0) > factor:
                        breaches.append(
                            {
                                "sli": sli.name,
                                "pair": label,
                                "burn_short": round(b_short, 4),
                                "burn_long": round(b_long or 0.0, 4),
                                "factor": factor,
                                "window_actual_s": (
                                    round(now - t_short, 3),
                                    round(now - t_long, 3),
                                ),
                            }
                        )
            headroom = {
                (key, ent.get("bound_label", "")): float(
                    ent.get("bound", 0) - ent.get("admitted", 0)
                )
                for key, ent in (inputs.get("admitted") or {}).items()
            }
            if record:
                self._history.append((now, inputs))
                self._burn = dict(burn)
                self._headroom = dict(headroom)
                for b in breaches:
                    self._breaches.append({"t": round(now, 3), **b})
        if record and breaches and tracing.active():
            with span("slo.evaluate", breaches=len(breaches)):
                for b in breaches:
                    tracing.add_event(
                        "slo_breach", sli=b["sli"], pair=b["pair"],
                        burn=b["burn_short"],
                    )
        return {
            "slis": {
                f"{name}@{window}": v
                for (name, window), v in sorted(burn.items())
            },
            "headroom": {
                key: {"bound": bound, "headroom": v}
                for (key, bound), v in sorted(headroom.items())
            },
            "breaches": breaches,
        }

    # -- read side -----------------------------------------------------

    def metrics_snapshot(self) -> dict:
        """The gauge feed for utils/metrics (gubernator_slo_burn_rate
        + gubernator_invariant_headroom)."""
        with self._lock:
            return {
                "burn": dict(self._burn),
                "headroom": dict(self._headroom),
            }

    def status(self) -> dict:
        """/debug/slo: declared SLIs, current burns, headroom, and
        the bounded breach log."""
        with self._lock:
            burn = dict(self._burn)
            headroom = dict(self._headroom)
            breach_log = list(self._breaches)
            samples = len(self._history)
        return {
            "enabled": True,
            "interval_s": self.interval,
            "fleet_scope": self.fleet_scope,
            "pairs": [
                {
                    "label": label, "short_s": s, "long_s": l,
                    "factor": f,
                }
                for label, s, l, f in self.pairs
            ],
            "slis": [
                {
                    "name": s.name, "metric": s.metric, "kind": s.kind,
                    "objective": s.objective,
                    "threshold_ms": s.threshold_ms or None,
                }
                for s in self.slis
            ],
            "burn": {
                f"{name}@{window}": v
                for (name, window), v in sorted(burn.items())
            },
            "headroom": {
                key: {"bound": bound, "headroom": v}
                for (key, bound), v in sorted(headroom.items())
            },
            "samples": samples,
            "breaches": breach_log,
        }

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
