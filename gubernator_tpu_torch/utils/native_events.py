"""Native event collector: drain the C front's event ring into
histograms, debug vars and span stubs.

The port's copy of gubernator_tpu/utils/native_events.py.  The C h2
front (csrc/h2_server.cpp) and its columnar feeder
(csrc/columnar_feeder.cpp) publish per-stage latency events into a
lock-free ring (csrc/event_ring.cpp) from their connection, reactor,
dispatch and serve threads — zero mutex, zero Py* calls on the serve
side.  This module's ONE background thread drains the ring every
``GUBER_NATIVE_EVENTS_INTERVAL`` seconds and turns the records into:

- per-stage DurationStat histograms (count/sum/max + streaming
  p50/p99), served under ``native_events`` in ``/debug/vars``;
- event counts per stage and the ring's overflow drops;
- when in-memory tracing is active, bounded NATIVE SPAN STUBS
  (``native.decide``) reconstructed from the records' monotonic
  timestamps — spans for decisions that never touch Python.  The fast
  front decodes no headers (the port is the route), so there is no
  traceparent to join: stubs are roots grouped per drain, attributed by
  stage and items.

Stage ids mirror the kEv* constants of csrc/h2_server.cpp and
csrc/columnar_feeder.cpp.
"""

from __future__ import annotations

import logging
import threading
from typing import Dict

from gubernator_tpu_torch.utils.metrics import DurationStat, record_swallowed

log = logging.getLogger("gubernator_tpu_torch.native_events")

# kind -> stage name (h2_server.cpp kEvNativeServe/kEvWindowWait/
# kEvWindowServe; columnar_feeder.cpp kEvFeederPack/kEvFeederRingWait/
# kEvFeederServe).
STAGES = {
    1: "native_serve",
    2: "window_wait",
    3: "window_serve",
    # Columnar feeder plane: per-RPC wire→columns pack (conn thread),
    # pack → window-callback queue wait (the feeder's analog of
    # window_wait), and the per-window columnar serve wall.
    4: "feeder_pack",
    5: "feeder_ring_wait",
    6: "feeder_serve",
    # Event front: one epoll wake's processing wall
    # (items = ready events), one connection's budgeted read drain
    # (items = bytes), and one EPOLLOUT writev resumption (items =
    # bytes moved) — the egress backpressure path, not the common
    # inline flush.
    7: "reactor_wake",
    8: "reactor_read",
    9: "reactor_write",
}

# Span stubs recorded per drain tick, bounded: under a 9k/s native
# herd an unbounded stub stream would evict every interesting span
# from the tracer's deque.
_MAX_STUBS_PER_DRAIN = 32


class NativeEventCollector:
    """One daemon's ring-drain thread + the derived stats."""

    def __init__(
        self,
        front,
        *,
        interval: float = 0.05,
        max_drain: int = 8192,
    ) -> None:
        import numpy as np

        self._front = front
        self.interval = interval
        self._max_drain = max_drain
        self._out = np.zeros(4 * max_drain, dtype=np.int64)
        self._hists: Dict[str, DurationStat] = {
            name: DurationStat() for name in STAGES.values()
        }
        self._counts: Dict[str, int] = {name: 0 for name in STAGES.values()}
        self._lock = threading.Lock()  # guberlint: guards _counts
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name="guber-native-events", daemon=True
        )
        self._thread.start()

    @classmethod
    def from_env(cls, front) -> "NativeEventCollector":
        import os

        raw = os.environ.get("GUBER_NATIVE_EVENTS_INTERVAL", "").strip()
        interval = 0.05
        if raw:
            try:
                # Go-style duration strings ("50ms") or float seconds —
                # the same surface every other GUBER_* duration speaks.
                from gubernator_tpu_torch.config import parse_duration

                interval = parse_duration(raw)
            except ValueError:
                log.warning(
                    "GUBER_NATIVE_EVENTS_INTERVAL=%r is not a duration;"
                    " using 0.05s", raw,
                )
        return cls(front, interval=max(0.005, interval))

    # -- the drain loop ------------------------------------------------

    def _run(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self.drain_once()
            except Exception:  # noqa: BLE001 — the tap must not die
                record_swallowed("native_events.drain")
                log.exception("native event drain failed")
        # Final drain so short-lived runs (benches, tests) keep the
        # tail events published just before close.
        try:
            self.drain_once()
        except Exception:  # noqa: BLE001 — teardown best-effort
            record_swallowed("native_events.drain")

    def drain_once(self) -> int:
        """One ring drain: bin durations into the per-stage histograms
        (vectorized), count events, emit bounded span stubs."""
        import numpy as np

        n = self._front.drain_events(self._out)
        if n <= 0:
            return 0
        rec = self._out[: 4 * n].reshape(n, 4)
        kinds = rec[:, 0]
        dur_s = rec[:, 2].astype(np.float64) / 1e9
        # Vectorized log2 binning, matching DurationStat.bucket_of.
        idx = np.floor(
            np.log2(np.maximum(dur_s, DurationStat._BASE) / DurationStat._BASE)
        ).astype(np.int64)
        np.clip(idx, 0, DurationStat.N_BUCKETS - 1, out=idx)
        for kind, stage in STAGES.items():
            mask = kinds == kind
            m = int(mask.sum())
            if not m:
                continue
            counts = np.bincount(
                idx[mask], minlength=DurationStat.N_BUCKETS
            )
            self._hists[stage].observe_bucket_counts(counts.tolist())
            with self._lock:
                self._counts[stage] += m
        self._emit_stubs(rec)
        return n

    def _emit_stubs(self, rec) -> None:
        from gubernator_tpu_torch.utils import tracing

        tracer = tracing.current_tracer()
        if tracer is None or not hasattr(tracer, "record_span"):
            return
        native = rec[rec[:, 0] == 1][:_MAX_STUBS_PER_DRAIN]
        for kind, t_end, dur, items in native.tolist():
            tracer.record_span(
                "native.decide",
                start_ns=int(t_end - dur),
                end_ns=int(t_end),
                items=int(items),
                stage=STAGES[int(kind)],
            )

    # -- read side (metrics / debug vars / bench artifacts) ------------

    def histograms(self) -> Dict[str, DurationStat]:
        return self._hists

    def event_counts(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counts)

    def ring_stats(self) -> dict:
        return self._front.ring_stats()

    def stats(self) -> dict:
        """Bench-artifact / /debug/vars shape: counts, drops, and
        per-stage latency summaries."""
        out = {"events": self.event_counts(), "ring": self.ring_stats()}
        out["stages"] = {
            stage: h.snapshot_ms(digits=4)
            for stage, h in self._hists.items()
        }
        return out

    def close(self) -> bool:
        """Stop the drain thread; returns False if it outlived the
        join — the caller must then LEAK the ring instead of freeing
        it (H2FastFront.abandon_ring), or the straggler's next
        evr_drain is a native use-after-free."""
        self._stop.set()
        self._thread.join(timeout=5.0)
        return not self._thread.is_alive()
