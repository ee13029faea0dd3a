"""FleetCollector — the local half of the reference's cluster rollup
(gubernator_tpu/obs/fleet.py).

`local_snapshot()` is this node's metric families in the reference's wire
shape: summable counters, per-node gauges, raw 36-bucket histograms (the
service's stage timers and the native event collector's stages) and the
admission watch's counts.  `merge()` folds snapshots as the reference's
does: counters SUM (per region and in all), gauges label-join by node,
`DurationStat` histograms merge bucket for bucket, so merged p50 / p99
are real quantiles.  `collect()` is the rollup the SLO watchdog reads.

The port runs one node with no peers, so the rollup is its own snapshot
alone: `collect(peers=True)` finds no peer to scrape (`scrape.ok` = 1),
as the reference's collector on a node with no peers does.  The peer
fan-out (PeersV1/ObsSnapshot) and /debug/fleet come with the peer planes
(ROADMAP A item 11).  The counters of planes the port lacks (forwarding,
GLOBAL managers, regions, handoff, replication) read as the reference's
node with no peers reads them: 0.
"""

from __future__ import annotations

import time
from typing import Dict, List, Tuple

SNAPSHOT_VERSION = 1

# The reference's per-instance counters (obs/fleet.py local_snapshot);
# the port's V1Instance keeps the same names.
_INSTANCE_COUNTERS = (
    "check_errors", "local", "forward", "global", "sketch",
    "replicated_local", "global_miss_local",
    "degraded_answers", "degraded_region_answers",
    "backoff_retries", "async_retries",
)


class FleetCollector:
    """One node's rollup: its local snapshot, merged."""

    def __init__(self, instance, *, addr: str = "", region: str = "") -> None:
        self.instance = instance
        self.addr = addr
        self.region = region

    def local_snapshot(self) -> dict:
        """This node's metric families in wire shape."""
        inst = self.instance
        eng = inst.engine
        counters: Dict[str, float] = {
            "checks": getattr(eng, "requests_total", 0),
            "over_limit": getattr(eng, "over_limit_total", 0),
        }
        for k in _INSTANCE_COUNTERS:
            counters[k] = inst.counters.get(k, 0)
        led = getattr(inst, "ledger", None)
        if led is not None:
            counters["ledger_answered"] = led.answered
            counters["ledger_native_answered"] = led.native_answered()
        ev = getattr(inst, "native_events", None)
        if ev is not None:
            rs = ev.ring_stats()
            counters["native_ring_dropped"] = rs.get("dropped", 0)
            counters["native_events"] = sum(ev.event_counts().values())

        gauges: Dict[str, float] = {
            "cache_size": eng.cache_size() if hasattr(eng, "cache_size") else 0,
        }
        front = getattr(inst, "h2_front", None)
        if front is not None:
            gauges["h2_conns_open"] = front.conn_stats()["conns_open"]

        hists = {stage: stat.bucket_snapshot() for stage, stat in inst.stage_timers.items()}
        if ev is not None:
            for stage, stat in ev.histograms().items():
                hists[stage] = stat.bucket_snapshot()
        aw = getattr(inst, "admission_watch", None)
        return {
            "v": SNAPSHOT_VERSION,
            "addr": self.addr,
            "region": self.region,
            "counters": counters,
            "gauges": gauges,
            "hists": hists,
            "admitted": aw.snapshot() if aw is not None else {},
        }

    def collect(self, peers: bool = True) -> dict:
        """One rollup: the local snapshot merged (a node with no peers has
        none to scrape, whatever `peers` asks)."""
        t0 = time.monotonic()
        rollup = self.merge([self.local_snapshot()])
        rollup["scrape"] = {"ok": 1, "failed": 0, "skipped": 0,
                            "elapsed_ms": round((time.monotonic() - t0) * 1e3, 3)}
        return rollup

    @staticmethod
    def merge(snaps: List[dict]) -> dict:
        """Merge node snapshots: counters sum (per region + total),
        gauges label-join, histograms merge exactly."""
        from gubernator_tpu_torch.utils.metrics import DurationStat

        nodes = []
        counters: Dict[str, float] = {}
        regions: Dict[str, dict] = {}
        gauges: Dict[str, Dict[str, Tuple[str, float]]] = {}
        hists: Dict[str, DurationStat] = {}
        admitted: Dict[str, dict] = {}
        for snap in snaps:
            addr = snap.get("addr", "")
            region = snap.get("region", "")
            nodes.append({"addr": addr, "region": region})
            sub = regions.setdefault(region, {"nodes": 0, "counters": {}})
            sub["nodes"] += 1
            for name, v in (snap.get("counters") or {}).items():
                counters[name] = counters.get(name, 0) + v
                sub["counters"][name] = sub["counters"].get(name, 0) + v
            for name, v in (snap.get("gauges") or {}).items():
                gauges.setdefault(name, {})[addr] = (region, v)
            for stage, hsnap in (snap.get("hists") or {}).items():
                hists.setdefault(stage, DurationStat()).merge_snapshot(hsnap)
            for key, ent in (snap.get("admitted") or {}).items():
                agg = admitted.setdefault(key, {"admitted": 0, "limit": 0, "nodes": 0})
                agg["admitted"] += int(ent.get("admitted", 0))
                agg["limit"] = max(agg["limit"], int(ent.get("limit", 0)))
                agg["nodes"] += 1
        return {
            "v": SNAPSHOT_VERSION,
            "nodes": nodes,
            "regions": regions,
            "counters": counters,
            "gauges": gauges,
            "quantiles": {stage: h.snapshot_ms() for stage, h in hists.items()},
            "admitted": admitted,
        }
