"""The two pieces of the reference's metrics module the port's host tier
uses (reference gubernator_tpu/utils/metrics.py): `record_swallowed`,
the per-site count of exceptions a background loop caught and carried
on after (:67), and `DurationStat` (:79), a duration summary.  No
Prometheus export: the port has no /metrics surface yet, so the counts
are read through `swallowed_counts()` and the stat's own methods.
"""

from __future__ import annotations

import threading

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
    """Count and sum of observed durations (seconds): the part of the
    reference's DurationStat (:79) the ledger reads, its settle lag's
    mean.  The reference's max, histogram and quantiles come with the
    debug routes that read them (ROADMAP A item 13)."""

    __slots__ = ("count", "total", "_lock")

    def __init__(self) -> None:
        self.count = 0
        self.total = 0.0
        self._lock = threading.Lock()

    def observe(self, seconds: float) -> None:
        with self._lock:
            self.count += 1
            self.total += seconds

    def mean(self) -> float:
        with self._lock:
            return self.total / self.count if self.count else 0.0
