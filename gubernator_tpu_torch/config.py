"""Daemon configuration from GUBER_* environment variables.

The port's copy of the reads of `gubernator_tpu/config.py` it needs:
GUBER_HTTP_ADDRESS (the gateway's listen address, default
"localhost:80"), GUBER_CACHE_SIZE (bucket slots, default 50000),
GUBER_SWEEP_INTERVAL (the period of the daemon's expiry sweep, a Go
duration such as "30s" or "500ms" or float seconds, default 30 s; 0
turns the sweep off), the count-min sketch of Behavior.SKETCH items
(GUBER_SKETCH_WINDOW, a Go duration or float seconds, default 1 s;
GUBER_SKETCH_DEPTH, default 4; GUBER_SKETCH_WIDTH, default 2^20;
reference config.py:697-701), the native h2 front
(GUBER_H2_FAST_ADDRESS, "" = off, "127.0.0.1:0" binds an ephemeral port;
GUBER_H2_FAST_WINDOW, its group-commit window, a Go duration or float
seconds, default 2 ms; GUBER_H2_LANES, its SO_REUSEPORT accept lanes on
the thread-per-connection plane, 0 = one per CPU; reference
config.py:486-494, :738-740), the decision ledger (GUBER_LEDGER, on
unless "0" / "false" / "no" / "off"; GUBER_LEDGER_LEASE, credit per
lease, default 512; GUBER_LEDGER_LEASE_TTL, default 0.2 s;
GUBER_LEDGER_HOT_THRESHOLD, hits in a 1 s window before a key leases,
default 8; GUBER_LEDGER_KEYS, its entry capacity, default 65536;
GUBER_LEDGER_SETTLE_INTERVAL, its background settle period, default
0.05 s, 0 = none; reference config.py:157-176, :702-712), the native
decision plane in the h2 front (GUBER_NATIVE_LEDGER, on by default;
reference :544-549, :741), and the engine's knobs, which the engine reads
itself: GUBER_PUMP (the step pump's queueing: "1" on, "0" off, unset =
on the card only), GUBER_FUSED (the device step's arm, `env_fused`) and
paged device state (core/paging.py; reference
config.py:280-309): GUBER_PAGED (only "1" turns it on), GUBER_PAGE_SIZE
(rows a page, a power of two >= 16, default 512) and
GUBER_PAGED_RESIDENT (device frames, default 0 = every page resident).
GUBER_DEVICE_COUNT (reference config.py:650) splits the state into that
many shards (parallel/sharded_engine.py; unset, 0 or 1: one engine);
the sharded engine's host tier reads GUBER_MULTI_THREADS itself
(core/native.py, its threads: unset or 0 = one a shard, at most one a
CPU).  The hot-key sketch reads GUBER_HOTKEYS, GUBER_HOTKEYS_K and
GUBER_HOTKEYS_WINDOW itself (utils/hotkeys.py `from_env`).  The h2 front
reads its other knobs itself (net/h2_fast.py), GUBER_RETRY_HINTS among
them.  The ledger's defaults live here and in `DecisionLedger`.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Mapping, Optional


@dataclass
class DaemonConfig:
    http_listen_address: str = "localhost:80"
    cache_size: int = 50_000
    # Shards of the bucket state (GUBER_DEVICE_COUNT; reference
    # config.py:476).  None or 1: one DecisionEngine; n > 1: a
    # ShardedDecisionEngine of n shards of cache_size // n slots, all on
    # the one card (the reference puts one a device).
    device_count: Optional[int] = None
    # Seconds between the daemon's incremental expiry sweeps (0 = none).
    sweep_interval: float = 30.0
    # The approximate limiter of Behavior.SKETCH (ops/sketch.py): window,
    # rows and columns of its two-epoch count-min sketch.
    sketch_window_ms: int = 1_000
    sketch_depth: int = 4
    sketch_width: int = 1 << 20
    # The native h2 front (net/h2_fast.py): "" = off.
    h2_fast_address: str = ""
    h2_fast_window: float = 0.002
    # Its SO_REUSEPORT accept lanes (thread-per-connection plane); 0 =
    # one per CPU.
    h2_lanes: int = 0
    # The host-tier decision ledger (core/ledger.py): sticky over-limit
    # answers and bounded credit leases for hot token keys.
    ledger: bool = True
    ledger_lease: int = 512
    ledger_lease_ttl: float = 0.2
    ledger_hot_threshold: int = 8
    ledger_keys: int = 65536
    ledger_settle_interval: float = 0.05
    # The ledger's C twin in the h2 front's connection threads
    # (core/native_plane.py); only on the live system clock.
    native_ledger: bool = True

    def ledger_opts(self) -> dict:
        """The ledger's settings as `DecisionLedger` keywords."""
        return dict(lease_size=self.ledger_lease, lease_ttl=self.ledger_lease_ttl,
                    hot_threshold=self.ledger_hot_threshold, max_keys=self.ledger_keys,
                    settle_interval=self.ledger_settle_interval)


def _env(d: Mapping[str, str], key: str, default: str = "") -> str:
    return d.get(key, os.environ.get(key, default)) or default


def _env_on(d: Mapping[str, str], key: str) -> bool:
    """A switch that is on unless set to 0 / false / no / off."""
    return _env(d, key, "1").strip().lower() not in ("0", "false", "no", "off")


def _env_int(d: Mapping[str, str], key: str, default: int) -> int:
    v = _env(d, key)
    return int(v) if v else default


_DURATION_UNITS = [
    ("ms", 1e-3),
    ("us", 1e-6),
    ("µs", 1e-6),
    ("ns", 1e-9),
    ("s", 1.0),
    ("m", 60.0),
    ("h", 3600.0),
]


def parse_duration(v: str) -> float:
    """A Go duration string ("500us", "30s", "1m30s") or float seconds,
    in seconds (reference gubernator_tpu/config.py:340)."""
    v = v.strip()
    try:
        return float(v)
    except ValueError:
        pass
    # Compound forms like "1m30s" parse unit by unit.
    total = 0.0
    num = ""
    i = 0
    while i < len(v):
        c = v[i]
        if c.isdigit() or c in ".+-":
            num += c
            i += 1
            continue
        for unit, mult in _DURATION_UNITS:
            if v.startswith(unit, i) and (
                i + len(unit) == len(v) or v[i + len(unit)].isdigit() or v[i + len(unit)] in ".+-"
            ):
                if not num:
                    raise ValueError(f"bad duration {v!r}")
                total += float(num) * mult
                num = ""
                i += len(unit)
                break
        else:
            raise ValueError(f"bad duration {v!r}")
    if num:
        raise ValueError(f"bad duration {v!r}")
    return total


def _env_seconds(d: Mapping[str, str], key: str, default: float) -> float:
    v = _env(d, key)
    return parse_duration(v) if v else default


def setup_daemon_config(env: Optional[Mapping[str, str]] = None) -> DaemonConfig:
    """Read the config; `env` entries win over os.environ."""
    d = env or {}
    return DaemonConfig(
        http_listen_address=_env(d, "GUBER_HTTP_ADDRESS", "localhost:80"),
        cache_size=_env_int(d, "GUBER_CACHE_SIZE", 50_000),
        device_count=_env_int(d, "GUBER_DEVICE_COUNT", 0) or None,
        sweep_interval=_env_seconds(d, "GUBER_SWEEP_INTERVAL", 30.0),
        sketch_window_ms=int(_env_seconds(d, "GUBER_SKETCH_WINDOW", 1.0) * 1000),
        sketch_depth=_env_int(d, "GUBER_SKETCH_DEPTH", 4),
        sketch_width=_env_int(d, "GUBER_SKETCH_WIDTH", 1 << 20),
        h2_fast_address=_env(d, "GUBER_H2_FAST_ADDRESS", ""),
        h2_fast_window=_env_seconds(d, "GUBER_H2_FAST_WINDOW", 0.002),
        h2_lanes=_env_int(d, "GUBER_H2_LANES", 0),
        ledger=_env_on(d, "GUBER_LEDGER"),
        ledger_lease=_env_int(d, "GUBER_LEDGER_LEASE", DaemonConfig.ledger_lease),
        ledger_lease_ttl=_env_seconds(d, "GUBER_LEDGER_LEASE_TTL", DaemonConfig.ledger_lease_ttl),
        ledger_hot_threshold=_env_int(d, "GUBER_LEDGER_HOT_THRESHOLD",
                                      DaemonConfig.ledger_hot_threshold),
        ledger_keys=_env_int(d, "GUBER_LEDGER_KEYS", DaemonConfig.ledger_keys),
        ledger_settle_interval=_env_seconds(d, "GUBER_LEDGER_SETTLE_INTERVAL",
                                            DaemonConfig.ledger_settle_interval),
        native_ledger=_env_on(d, "GUBER_NATIVE_LEDGER"),
    )


def env_pump(device_type: str) -> bool:
    """GUBER_PUMP: the step pump (core/pump.py) queues batches across
    calls by default on the card and not on the CPU; "1" / "0" override
    (reference: core/engine.py, the `want_pump` rule)."""
    v = os.environ.get("GUBER_PUMP", "")
    return v == "1" or (v != "0" and device_type == "cuda")


FUSED_KNOBS = ("auto", "pallas", "interpret", "xla", "split")


def env_fused() -> str:
    """GUBER_FUSED, the device step's arm (reference core/engine.py:398-450):
    "split" is the unfused compute + scatter pair, the A/B control; "auto"
    (also unset or empty), "pallas", "interpret" and "xla" all select the
    fused kernels, since the port has one fused form where the reference
    has a Pallas kernel and an XLA program.  Any other value raises
    ValueError."""
    v = os.environ.get("GUBER_FUSED", "auto").strip().lower() or "auto"
    if v not in FUSED_KNOBS:
        raise ValueError(f"GUBER_FUSED={v!r}: expected {'|'.join(FUSED_KNOBS)}")
    return v


def env_paged() -> bool:
    """GUBER_PAGED: page the device bucket state behind a page table
    with host spill (core/paging.py).  Default off: the dense state."""
    return os.environ.get("GUBER_PAGED", "").strip() == "1"


def env_page_size(default: int = 512) -> int:
    """GUBER_PAGE_SIZE: bucket rows per page, a power of two >= 16
    (slot → (page, row) is a shift and a mask); anything else falls back
    to the default."""
    try:
        v = int(os.environ.get("GUBER_PAGE_SIZE", "") or default)
    except ValueError:
        return default
    if v < 16 or v & (v - 1):
        return default
    return v


def env_paged_resident(default: int = 0) -> int:
    """GUBER_PAGED_RESIDENT: device frames (resident pages).  0 keeps
    every page resident; a negative value reads as 0."""
    try:
        return max(0, int(os.environ.get("GUBER_PAGED_RESIDENT", "") or default))
    except ValueError:
        return default
