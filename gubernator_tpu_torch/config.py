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

The daemon binary's `-config FILE` is a KEY=VALUE file (`load_env_file`,
reference config.py:374) whose keys win over `env` and the process
environment; GUBER_DEBUG (1 / true / yes) turns on debug logging as
`-debug` does.  The status listener GUBER_STATUS_HTTP_ADDRESS serves
health and /metrics over plain HTTP, and GUBER_METRIC_FLAGS (os, python
or golang, all) adds the process, GC and platform families to /metrics
(reference config.py:745, utils/metrics.py:1080).

The peer planes' settings are read here with the reference's names,
defaults and errors (reference config.py:591-695, :751), for the modules
of `cluster/` and `discovery/`: the gRPC listener GUBER_GRPC_ADDRESS
(default "localhost:81"), GUBER_ADVERTISE_ADDRESS and GUBER_GRPC_WORKERS
(32); the behaviors GUBER_BATCH_TIMEOUT / _WAIT / _LIMIT,
GUBER_ADAPTIVE_WINDOWS, GUBER_CIRCUIT_FAILURES / _BACKOFF / _BACKOFF_CAP,
GUBER_FORWARD_BACKOFF / _CAP and GUBER_DEGRADED_LOCAL; the ring GUBER_PEER_PICKER,
GUBER_PEER_PICKER_HASH (fnv1, or fnv1a when GUBER_PEER_PICKER is set)
and GUBER_REPLICATED_HASH_REPLICAS; discovery GUBER_PEER_DISCOVERY_TYPE,
GUBER_STATIC_PEERS, GUBER_DATA_CENTER, GUBER_MEMBERLIST_*, GUBER_DNS_*
and GUBER_ETCD_* (the k8s backend reads GUBER_K8S_* itself).  The daemon
takes static peers (GUBER_STATIC_PEERS) and refuses a discovery type
other than "none" (daemon.py `check_single_node`, ROADMAP A entry 4).
"""

from __future__ import annotations

import os
import socket
from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional


@dataclass
class BehaviorConfig:
    """The reference's BehaviorConfig fields that the peer planes' ported
    modules read (reference config.py:23-123): peer-forward batching
    (cluster/peer_client.py), load-adaptive batching windows
    (cluster/batch_loop.py AdaptiveWait), the per-peer circuit breaker,
    the forward retry backoff (cluster/health.py) and degraded-mode
    local answers (service.py)."""

    # Peer-forward batching (GUBER_BATCH_TIMEOUT / _WAIT / _LIMIT;
    # reference peer_client.go:380-453): the RPC deadline, the batching
    # window's cap and the items a batch.
    batch_timeout: float = 0.5
    batch_wait: float = 500 * 1e-6
    batch_limit: int = 1000
    # Every batching window's wait is a cap that grows with fill
    # (GUBER_ADAPTIVE_WINDOWS, default on).
    adaptive_windows: bool = True
    # Consecutive failures before a peer's circuit opens, and its open
    # period, doubled a re-open up to the cap (GUBER_CIRCUIT_*).
    circuit_failures: int = 3
    circuit_backoff: float = 0.5
    circuit_backoff_cap: float = 30.0
    # Capped exponential backoff with full jitter between owner re-picks
    # (GUBER_FORWARD_BACKOFF / _CAP).
    forward_backoff: float = 0.01
    forward_backoff_cap: float = 0.25
    # Answer from this node's engine, marked metadata.degraded, when a
    # key's owner cannot be reached; off gives the reference's error
    # strings (GUBER_DEGRADED_LOCAL).
    degraded_local: bool = True


@dataclass
class DaemonConfig:
    # The gRPC listener (net/grpc_listener.py): V1 and
    # PeersV1/GetPeerRateLimits.  GUBER_GRPC_ADDRESS defaults to
    # "localhost:81" as the reference's; a config built in code has none
    # unless it names one ("" = no listener, a node with no peers only).
    grpc_listen_address: str = ""
    # The address peers reach this node at (GUBER_ADVERTISE_ADDRESS; ""
    # = the listener's, with 0.0.0.0 resolved: resolve_advertise_address).
    advertise_address: str = ""
    # The listener's handler threads (GUBER_GRPC_WORKERS).
    grpc_workers: int = 32
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
    # Debug logging (GUBER_DEBUG; the binary's -debug does the same).
    debug: bool = False
    # Plain-HTTP status listener serving health and /metrics ("" = off).
    http_status_listen_address: str = ""
    # Extra /metrics families: "os" (process_*), "python" / "golang"
    # (python_gc_*, python_info), "all" (both).
    metric_flags: List[str] = field(default_factory=list)
    behaviors: BehaviorConfig = field(default_factory=BehaviorConfig)
    # The peer ring: picker, its hash and its virtual points a peer.
    peer_picker: str = "replicated-hash"
    hash_algorithm: str = "fnv1"
    picker_replicas: int = 512
    # Discovery: "none" | "member-list" | "etcd" | "dns" | "k8s".
    peer_discovery_type: str = "none"
    # Fixed membership for discovery "none": peer addresses, this
    # node's own included.
    static_peers: List[str] = field(default_factory=list)
    data_center: str = ""
    member_list_address: str = ""
    known_hosts: List[str] = field(default_factory=list)
    advertise_port: int = 7946
    dns_fqdn: str = ""
    dns_poll_interval: float = 300.0
    etcd_endpoints: List[str] = field(default_factory=list)
    etcd_key_prefix: str = "/gubernator/peers/"
    etcd_dial_timeout: float = 5.0
    etcd_user: str = ""
    etcd_password: str = ""
    etcd_advertise_address: str = ""
    etcd_data_center: str = ""
    etcd_tls_ca: str = ""
    etcd_tls_cert: str = ""
    etcd_tls_key: str = ""
    etcd_tls_skip_verify: bool = False

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


def _env_list(d: Mapping[str, str], key: str) -> List[str]:
    """A comma-separated list, blanks dropped."""
    return [h.strip() for h in _env(d, key).split(",") if h.strip()]


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


def load_env_file(path: str) -> Dict[str, str]:
    """Read a KEY=VALUE config file (reference config.py:374, after
    config.go:556-584): blank lines and lines starting with # are
    skipped, a line without "=" raises ValueError naming path:lineno,
    and the values are exported into os.environ as well as returned."""
    out: Dict[str, str] = {}
    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            if "=" not in line:
                raise ValueError(f"{path}:{lineno}: expected KEY=VALUE")
            k, _, v = line.partition("=")
            out[k.strip()] = v.strip()
    os.environ.update(out)
    return out


DISCOVERY_TYPES = ("none", "member-list", "etcd", "dns", "k8s")


def setup_daemon_config(env: Optional[Mapping[str, str]] = None, *,
                        config_file: Optional[str] = None) -> DaemonConfig:
    """Read the config: `config_file`'s keys win over `env`'s, which win
    over os.environ (reference config.py:554)."""
    d: Dict[str, str] = dict(env or {})
    if config_file:
        d.update(load_env_file(config_file))
    behaviors = BehaviorConfig(
        batch_timeout=_env_seconds(d, "GUBER_BATCH_TIMEOUT", 0.5),
        batch_wait=_env_seconds(d, "GUBER_BATCH_WAIT", 500 * 1e-6),
        batch_limit=_env_int(d, "GUBER_BATCH_LIMIT", 1000),
        adaptive_windows=_env_on(d, "GUBER_ADAPTIVE_WINDOWS"),
        circuit_failures=_env_int(d, "GUBER_CIRCUIT_FAILURES", 3),
        circuit_backoff=_env_seconds(d, "GUBER_CIRCUIT_BACKOFF", 0.5),
        circuit_backoff_cap=_env_seconds(d, "GUBER_CIRCUIT_BACKOFF_CAP", 30.0),
        forward_backoff=_env_seconds(d, "GUBER_FORWARD_BACKOFF", 0.01),
        forward_backoff_cap=_env_seconds(d, "GUBER_FORWARD_BACKOFF_CAP", 0.25),
        degraded_local=_env_on(d, "GUBER_DEGRADED_LOCAL"),
    )
    peer_picker = _env(d, "GUBER_PEER_PICKER", "replicated-hash")
    from gubernator_tpu_torch.cluster.hash_ring import make_picker

    make_picker(peer_picker, "fnv1")  # raises on an unknown picker
    # An explicit picker defaults its hash to fnv1a (reference
    # config.py:619, after config.go:403); otherwise fnv1.
    hash_default = "fnv1a" if _env(d, "GUBER_PEER_PICKER") else "fnv1"
    hash_algorithm = _env(d, "GUBER_PEER_PICKER_HASH", hash_default)
    if hash_algorithm not in ("fnv1", "fnv1a"):
        raise ValueError(f"GUBER_PEER_PICKER_HASH={hash_algorithm!r}: want fnv1 or fnv1a")
    discovery = _env(d, "GUBER_PEER_DISCOVERY_TYPE", "none")
    if discovery not in DISCOVERY_TYPES:
        raise ValueError(
            f"GUBER_PEER_DISCOVERY_TYPE={discovery!r}: want none, member-list, etcd, dns or k8s"
        )
    dc = _env(d, "GUBER_DATA_CENTER")
    return DaemonConfig(
        grpc_listen_address=_env(d, "GUBER_GRPC_ADDRESS", "localhost:81"),
        advertise_address=_env(d, "GUBER_ADVERTISE_ADDRESS", ""),
        grpc_workers=_env_int(d, "GUBER_GRPC_WORKERS", 32),
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
        debug=_env(d, "GUBER_DEBUG") in ("1", "true", "yes"),
        http_status_listen_address=_env(d, "GUBER_STATUS_HTTP_ADDRESS", ""),
        metric_flags=_env_list(d, "GUBER_METRIC_FLAGS"),
        behaviors=behaviors,
        peer_picker=peer_picker,
        hash_algorithm=hash_algorithm,
        picker_replicas=_env_int(d, "GUBER_REPLICATED_HASH_REPLICAS", 512),
        peer_discovery_type=discovery,
        static_peers=_env_list(d, "GUBER_STATIC_PEERS"),
        data_center=dc,
        member_list_address=_env(d, "GUBER_MEMBERLIST_ADDRESS", ""),
        known_hosts=_env_list(d, "GUBER_MEMBERLIST_KNOWN_NODES"),
        advertise_port=_env_int(d, "GUBER_MEMBERLIST_ADVERTISE_PORT", 7946),
        dns_fqdn=_env(d, "GUBER_DNS_FQDN", ""),
        dns_poll_interval=_env_seconds(d, "GUBER_DNS_POLL_INTERVAL", 300.0),
        etcd_endpoints=_env_list(d, "GUBER_ETCD_ENDPOINTS"),
        etcd_key_prefix=_env(d, "GUBER_ETCD_KEY_PREFIX", "/gubernator/peers/"),
        etcd_dial_timeout=_env_seconds(d, "GUBER_ETCD_DIAL_TIMEOUT", 5.0),
        etcd_user=_env(d, "GUBER_ETCD_USER"),
        etcd_password=_env(d, "GUBER_ETCD_PASSWORD"),
        etcd_advertise_address=_env(d, "GUBER_ETCD_ADVERTISE_ADDRESS"),
        etcd_data_center=_env(d, "GUBER_ETCD_DATA_CENTER", dc),
        etcd_tls_ca=_env(d, "GUBER_ETCD_TLS_CA"),
        etcd_tls_cert=_env(d, "GUBER_ETCD_TLS_CERT"),
        etcd_tls_key=_env(d, "GUBER_ETCD_TLS_KEY"),
        etcd_tls_skip_verify=_env(d, "GUBER_ETCD_TLS_SKIP_VERIFY") in ("1", "true", "yes"),
    )


def resolve_advertise_address(listen: str, advertise: str = "") -> str:
    """The address peers dial: `advertise` when set, else the listen
    address with a 0.0.0.0 / :: / empty host replaced by this host's
    address (reference config.py:751, net.go:28-49)."""
    if advertise:
        return advertise
    host, _, port = listen.rpartition(":")
    if host in ("0.0.0.0", "::", ""):
        host = socket.gethostbyname(socket.gethostname())
    return f"{host}:{port}"


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
