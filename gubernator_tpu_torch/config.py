"""Daemon configuration from GUBER_* environment variables.

The port's copy of the reads of `gubernator_tpu/config.py` it needs:
GUBER_HTTP_ADDRESS (the gateway's listen address, default
"localhost:80"), GUBER_CACHE_SIZE (bucket slots, default 50000), and
the engine's GUBER_PUMP (the step pump's queueing: "1" on, "0" off,
unset = on the card only).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Mapping, Optional


@dataclass
class DaemonConfig:
    http_listen_address: str = "localhost:80"
    cache_size: int = 50_000


def _env(d: Mapping[str, str], key: str, default: str = "") -> str:
    return d.get(key, os.environ.get(key, default)) or default


def _env_int(d: Mapping[str, str], key: str, default: int) -> int:
    v = _env(d, key)
    return int(v) if v else default


def setup_daemon_config(env: Optional[Mapping[str, str]] = None) -> DaemonConfig:
    """Read the config; `env` entries win over os.environ."""
    d = env or {}
    return DaemonConfig(
        http_listen_address=_env(d, "GUBER_HTTP_ADDRESS", "localhost:80"),
        cache_size=_env_int(d, "GUBER_CACHE_SIZE", 50_000),
    )


def env_pump(device_type: str) -> bool:
    """GUBER_PUMP: the step pump (core/pump.py) queues batches across
    calls by default on the card and not on the CPU; "1" / "0" override
    (reference: core/engine.py, the `want_pump` rule)."""
    v = os.environ.get("GUBER_PUMP", "")
    return v == "1" or (v != "0" and device_type == "cuda")
