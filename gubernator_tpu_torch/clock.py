"""Injectable millisecond clock with freeze/advance support.

The reference tests freeze and manually advance time
(reference: functional_test.go:160,215; holster/clock).  Everything in
this framework that needs "now" reads it from a `Clock` instance — and
the device kernel takes `now_ms` as an explicit input array (it never
reads time on-device), which is what makes frozen-clock conformance
tests possible (SURVEY.md §4.5).
"""

from __future__ import annotations

import threading
import time


class Clock:
    """Wall clock that can be frozen and advanced manually (test support).

    Mirrors the semantics of holster `clock.Freeze`/`clock.Advance` used
    throughout the reference test-suite (reference: functional_test.go:160).
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._frozen_ns: int | None = None

    def now_ns(self) -> int:
        with self._lock:
            if self._frozen_ns is not None:
                return self._frozen_ns
        return time.time_ns()

    def now_ms(self) -> int:
        """Unix epoch in milliseconds. reference: lrucache.go:107-109."""
        return self.now_ns() // 1_000_000

    def freeze(self) -> "Clock":
        with self._lock:
            self._frozen_ns = time.time_ns() if self._frozen_ns is None else self._frozen_ns
        return self

    def freeze_at(self, ns: int) -> "Clock":
        with self._lock:
            self._frozen_ns = ns
        return self

    @property
    def frozen(self) -> bool:
        """True while the clock is frozen (net/h2_fast.py attaches the
        native decision plane, which reads the real time, only to a clock
        that is not)."""
        with self._lock:
            return self._frozen_ns is not None

    def advance(self, *, ms: int = 0, ns: int = 0) -> None:
        """Advance a frozen clock; raises if the clock is not frozen."""
        with self._lock:
            if self._frozen_ns is None:
                raise RuntimeError("Clock.advance() requires a frozen clock")
            self._frozen_ns += ns + ms * 1_000_000


#: Process-wide default clock (daemon paths); tests inject their own.
SYSTEM_CLOCK = Clock()
