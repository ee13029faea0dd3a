"""Gregorian calendar interval math for DURATION_IS_GREGORIAN.

reference: interval.go:74-148.  When the behavior flag is set, the
request `duration` field is an interval enum (minutes/hours/days/weeks/
months/years) and limits reset at the end of the civil-calendar interval.

All host-side: the device kernel receives the precomputed
(gregorian_duration, gregorian_expiration) per request and never does
calendar math (SURVEY.md §7.1).

Deliberate divergences from the reference, both documented reference
bugs that its own tests never reach:

* `gregorian_duration` for months/years: interval.go:99,105 computes
  ``end.UnixNano() - begin.UnixNano()/1000000`` — an operator-precedence
  bug yielding ~1.7e18.  We return the true interval length in ms.
* Weeks are supported here (ISO weeks ending Sunday 23:59:59.999) rather
  than returning an error (interval.go:92-93 "not yet supported").
"""

from __future__ import annotations

from calendar import monthrange
from datetime import datetime, timedelta

GREGORIAN_MINUTES = 0
GREGORIAN_HOURS = 1
GREGORIAN_DAYS = 2
GREGORIAN_WEEKS = 3
GREGORIAN_MONTHS = 4
GREGORIAN_YEARS = 5

_MS = 1


class GregorianError(ValueError):
    """Raised for a non-Gregorian `duration` under DURATION_IS_GREGORIAN.

    reference: interval.go:107 — the error string is propagated into the
    per-item `RateLimitResp.error` field, not a transport error.
    """


def _to_ms(dt: datetime) -> int:
    return int(dt.timestamp() * 1000)


def dt_from_ms(now_ms: int) -> datetime:
    """Civil UTC time for a unix-ms timestamp.

    The engines derive the Gregorian civil time from the same `now_ms`
    the kernel receives — a second clock read could land in a different
    calendar interval and create buckets already expired relative to
    the kernel's `now` (engine time-source invariant)."""
    from datetime import timezone

    return datetime.fromtimestamp(now_ms / 1000.0, tz=timezone.utc)


def gregorian_duration(now: datetime, d: int) -> int:
    """Total length in ms of the Gregorian interval containing `now`.

    reference: interval.go:83-109 (GregorianDuration), with the
    months/years precedence bug fixed (see module docstring).
    """
    if d == GREGORIAN_MINUTES:
        return 60_000
    if d == GREGORIAN_HOURS:
        return 3_600_000
    if d == GREGORIAN_DAYS:
        return 86_400_000
    if d == GREGORIAN_WEEKS:
        return 7 * 86_400_000
    if d == GREGORIAN_MONTHS:
        days = monthrange(now.year, now.month)[1]
        return days * 86_400_000
    if d == GREGORIAN_YEARS:
        begin = now.replace(month=1, day=1, hour=0, minute=0, second=0, microsecond=0)
        end = begin.replace(year=begin.year + 1)
        return _to_ms(end) - _to_ms(begin)
    raise GregorianError(
        "behavior DURATION_IS_GREGORIAN is set; but `Duration` is not a valid gregorian interval"
    )


def gregorian_expiration(now: datetime, d: int) -> int:
    """End of the current Gregorian interval, unix-ms.

    Returns `start_of_next_interval - 1ms`, matching the reference's
    `boundary - 1ns` truncated to ms (reference: interval.go:117-148).
    """
    if d == GREGORIAN_MINUTES:
        begin = now.replace(second=0, microsecond=0)
        return _to_ms(begin + timedelta(minutes=1)) - _MS
    if d == GREGORIAN_HOURS:
        begin = now.replace(minute=0, second=0, microsecond=0)
        return _to_ms(begin + timedelta(hours=1)) - _MS
    if d == GREGORIAN_DAYS:
        begin = now.replace(hour=0, minute=0, second=0, microsecond=0)
        return _to_ms(begin + timedelta(days=1)) - _MS
    if d == GREGORIAN_WEEKS:
        begin = now.replace(hour=0, minute=0, second=0, microsecond=0)
        # End of the ISO week (Sunday night).
        return _to_ms(begin + timedelta(days=7 - now.weekday())) - _MS
    if d == GREGORIAN_MONTHS:
        begin = now.replace(day=1, hour=0, minute=0, second=0, microsecond=0)
        if begin.month == 12:
            nxt = begin.replace(year=begin.year + 1, month=1)
        else:
            nxt = begin.replace(month=begin.month + 1)
        return _to_ms(nxt) - _MS
    if d == GREGORIAN_YEARS:
        begin = now.replace(month=1, day=1, hour=0, minute=0, second=0, microsecond=0)
        return _to_ms(begin.replace(year=begin.year + 1)) - _MS
    raise GregorianError(
        "behavior DURATION_IS_GREGORIAN is set; but `Duration` is not a valid gregorian interval"
    )
