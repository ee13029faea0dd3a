"""Tail flight recorder: keep full span trees ONLY for tail decisions.

The port's copy of gubernator_tpu/utils/flight_recorder.py; the daemon
hooks it to the in-memory tracer (GUBER_TRACING=memory).

Always-on tracing of every decision would drown the interesting 1% in
the boring 99% (and the InMemoryTracer's bounded deque would shed the
tail spans first under load).  The recorder hooks the tracer's
root-finish callback and retains the COMPLETE span tree of any trace
whose root exceeded an adaptive threshold:

    threshold = max(GUBER_TRACE_TAIL_MIN_MS,
                    rolling_p99(root durations) × GUBER_TRACE_TAIL_FACTOR)

so "tail" self-calibrates to the workload — under a healthy herd the
p99 is ~1ms and a 5ms decision records; under a degraded cluster the
p99 grows and only the genuinely anomalous trees are kept.  Retention
is a bounded ring of GUBER_TRACE_TAIL_CAP trees, dumpable live via the
gateway's ``/debug/trace`` endpoint (`dump` is the shape).

Scope note: a tree is captured when its ROOT finishes; async children
that outlive the root (a broadcast window flushing later) appear in
the tree only if they finished first.  That is the right trade — the
recorder answers "where did THIS request's milliseconds go", and the
async tail has its own spans under the same trace id in the tracer.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Optional

from gubernator_tpu_torch.utils.metrics import DurationStat
from gubernator_tpu_torch.utils.tracing import InMemoryTracer, RecordedSpan


def _span_dict(s: RecordedSpan) -> dict:
    return {
        "name": s.name,
        "span_id": s.span_id,
        "parent_span_id": s.parent_span_id,
        "remote": s.remote,
        "start_ns": s.start_ns,
        "duration_ms": round((s.end_ns - s.start_ns) / 1e6, 3),
        "attributes": dict(s.attributes),
        "events": [
            {"name": name, **attrs} for name, attrs in s.events
        ],
    }


class FlightRecorder:
    """Bounded ring of tail span trees over an InMemoryTracer."""

    def __init__(
        self,
        tracer: InMemoryTracer,
        *,
        factor: float = 4.0,
        min_ms: float = 5.0,
        cap: int = 64,
    ) -> None:
        self._tracer = tracer
        self.factor = factor
        self.min_s = min_ms / 1e3
        self._lock = threading.Lock()
        # guberlint: guard _traces, recorded, considered by _lock
        self._traces = deque(maxlen=max(1, cap))
        self.recorded = 0
        self.considered = 0
        # Rolling root-duration distribution: the adaptive threshold's
        # p99 source (DurationStat's log2-bucket histogram).
        self.root_durations = DurationStat()
        tracer.on_root_finish = self._root_finished

    @classmethod
    def from_env(cls, tracer: InMemoryTracer) -> "FlightRecorder":
        import os

        def _f(name: str, default: float) -> float:
            try:
                return float(os.environ.get(name, "") or default)
            except ValueError:
                return default

        return cls(
            tracer,
            factor=_f("GUBER_TRACE_TAIL_FACTOR", 4.0),
            min_ms=_f("GUBER_TRACE_TAIL_MIN_MS", 5.0),
            cap=int(_f("GUBER_TRACE_TAIL_CAP", 64)),
        )

    # Rolling-p99 warmup: with an empty histogram the adaptive term is
    # zero and the threshold is just the min_ms floor, so a workload
    # whose NORMAL latency exceeds the floor would record every early
    # decision (each capture costs a tracer scan + tree serialization
    # on the request thread).  Until this many roots have calibrated
    # the p99, the adaptive term uses the rolling MAX instead — the
    # first anomalous-looking root still records, but the steady
    # stream right behind it does not.
    WARMUP_ROOTS = 32
    # Capture scans only the newest this-many spans: the trace's spans
    # are the most recent by construction (children finish before the
    # root), and an unbounded filter of the tracer's 100k-span deque
    # under its lock would stall concurrent span finishes.
    MAX_TRACE_SCAN = 4096

    def threshold_s(self) -> float:
        ref = (
            self.root_durations.p99()
            if self.root_durations.count >= self.WARMUP_ROOTS
            else self.root_durations.max
        )
        return max(self.min_s, ref * self.factor)

    def _root_finished(self, root: RecordedSpan) -> None:
        dur_s = (root.end_ns - root.start_ns) / 1e9
        thresh = self.threshold_s()
        self.root_durations.observe(dur_s)
        with self._lock:
            self.considered += 1
        if dur_s < thresh:
            return
        spans = self._tracer.trace(
            root.trace_id, max_scan=self.MAX_TRACE_SCAN
        )
        entry = {
            "trace_id": root.trace_id,
            "root": root.name,
            "captured_at": time.time(),
            "duration_ms": round(dur_s * 1e3, 3),
            "threshold_ms": round(thresh * 1e3, 3),
            "spans": [_span_dict(s) for s in spans],
        }
        with self._lock:
            self.recorded += 1
            self._traces.append(entry)

    def dump(self, limit: Optional[int] = None) -> dict:
        with self._lock:
            traces = list(self._traces)
            recorded, considered = self.recorded, self.considered
        if limit is not None:
            traces = traces[-limit:]
        return {
            "threshold_ms": round(self.threshold_s() * 1e3, 3),
            "factor": self.factor,
            "min_ms": self.min_s * 1e3,
            "considered": considered,
            "recorded": recorded,
            "root_p50_ms": round(self.root_durations.p50() * 1e3, 3),
            "root_p99_ms": round(self.root_durations.p99() * 1e3, 3),
            "traces": traces,
        }

    def close(self) -> None:
        # Bound-method identity: compare the receiver, not the method
        # object (each attribute access builds a fresh bound method).
        hook = self._tracer.on_root_finish
        if getattr(hook, "__self__", None) is self:
            self._tracer.on_root_finish = None
