"""Daemon — process bootstrap: engine + service + HTTP gateway + h2 front.

Port of `gubernator_tpu/daemon.py` for one node: `spawn_daemon(conf)`
builds the decision engine on the card (or on `device` when given) —
with `conf.device_count` (GUBER_DEVICE_COUNT) n > 1, the sharded engine
of n shards (parallel/sharded_engine.py), all on that one device — with
an optional write-through `store`, restores the cache from an optional
`loader` before it serves, wires the V1 service with its decision
ledger (`conf.ledger*`, GUBER_LEDGER*; reference daemon.py:186-191),
starts the HTTP gateway, then, when `conf.h2_fast_address`
(GUBER_H2_FAST_ADDRESS) is set, the native h2 front (net/h2_fast.py;
reference daemon.py:316-335), which attaches the ledger's native
decision plane when `conf.native_ledger` (GUBER_NATIVE_LEDGER) is on and
the clock is the live one, and its columnar feeder, the default ingest,
unless GUBER_NATIVE_FEEDER=0 (the front reads that knob and the ring's
sizes itself, as the reference's does), and runs the periodic expiry sweep on a
thread of its own (`conf.sweep_interval`, GUBER_SWEEP_INTERVAL;
SWEEP_WINDOWS_PER_TICK windows a tick).  `close` stops the sweeper, then
the h2 front (its dispatch and feeder threads call into the engine; it
pulls the plane's leases back to the ledger), then the gateway, saves the cache to
the loader, and closes the service (the ledger settles, then the engine
closes; reference daemon.py:631-674).  Paged state and the hot-key
sketch need nothing here: the engine reads GUBER_PAGED, GUBER_PAGE_SIZE
and GUBER_PAGED_RESIDENT itself, and the service GUBER_HOTKEYS*, as the
reference's do; with paging on, `conf.cache_size` is the logical key
space and the store, the loader and the sweep thread reach cold pages
through the host store.

Observability (reference daemon.py:228-248, :333-377): when the in-memory
tracer runs (GUBER_TRACING=memory, or a tracer a harness set), the tail
flight recorder (utils/flight_recorder.py; GUBER_TRACE_TAIL_FACTOR /
_MIN_MS / _CAP) hooks it, one recorder a tracer, and /debug/trace serves
its dump; the h2 front's event ring (GUBER_NATIVE_EVENTS) gets a
collector thread (utils/native_events.py; GUBER_NATIVE_EVENTS_INTERVAL)
whose stages /debug/vars serves; and unless GUBER_OBS=0 the local rollup
(obs/fleet.py) and the SLO watchdog (obs/slo.py; GUBER_SLO_INTERVAL,
GUBER_SLO_FLEET, GUBER_SLO_FAST_WINDOWS / _SLOW_WINDOWS,
GUBER_SLO_WATCH_KEYS) run, behind /debug/slo.  `close` stops the watchdog
and the collector (whose thread must end before the ring is freed)
before the front.

Metrics (reference daemon.py:249-256, :379-388): the registry
(utils/metrics.py `build_registry`, with `conf.metric_flags`,
GUBER_METRIC_FLAGS) is served at /metrics on the gateway and, when
`conf.http_status_listen_address` (GUBER_STATUS_HTTP_ADDRESS) is set, on
a plain-HTTP status listener with health and /metrics, started after the
rollup and closed with the gateway.

The gRPC listener and static peers (reference daemon.py:282-288,
:442-478): when `conf.grpc_listen_address` (GUBER_GRPC_ADDRESS) is set,
the daemon serves V1 and PeersV1/GetPeerRateLimits there
(net/grpc_listener.py, `conf.grpc_workers` handler threads), and
`peer_info()` advertises it (GUBER_ADVERTISE_ADDRESS, or the listener's
address with 0.0.0.0 resolved).  With GUBER_STATIC_PEERS the full peer
list goes to the service's ring (`set_peers`, which marks this node and
adds it when the list leaves it out), and keys other nodes own are
forwarded to them; with none the ring stays empty and every key is this
node's.  Discovery and the other cluster planes (GLOBAL, MULTI_REGION,
membership, replication, /debug/fleet) are not ported yet:
`check_single_node` refuses a discovery type other than "none" (ROADMAP
A entry 4), and static peers that name another node with no gRPC
listener to be reached at.
"""

from __future__ import annotations

import logging
import os
import threading

from typing import List, Sequence

from gubernator_tpu_torch.clock import SYSTEM_CLOCK, Clock
from gubernator_tpu_torch.config import DaemonConfig, resolve_advertise_address
from gubernator_tpu_torch.core.engine import DecisionEngine
from gubernator_tpu_torch.net.gateway import Gateway
from gubernator_tpu_torch.service import V1Instance
from gubernator_tpu_torch.types import PeerInfo
from gubernator_tpu_torch.utils.metrics import build_registry

log = logging.getLogger("gubernator_tpu_torch.daemon")


def check_single_node(conf: DaemonConfig) -> None:
    """Refuse a membership the port cannot keep: peer discovery (ROADMAP
    A entry 4), and static peers naming another node when this node has
    no gRPC listener for them to forward to.  Raises ValueError."""
    if conf.peer_discovery_type != "none":
        raise ValueError(
            f"GUBER_PEER_DISCOVERY_TYPE={conf.peer_discovery_type!r}: peer discovery is not "
            "ported yet (ROADMAP A entry 4); use GUBER_STATIC_PEERS"
        )
    own = {conf.grpc_listen_address, conf.http_listen_address, conf.h2_fast_address,
           conf.http_status_listen_address}
    others = [a for a in conf.static_peers if a not in own]
    if others and not conf.grpc_listen_address:
        raise ValueError(
            f"GUBER_STATIC_PEERS names {others}, but this node has no gRPC listener "
            "(GUBER_GRPC_ADDRESS) for its peers to reach it at"
        )


class Daemon:
    """One gubernator_tpu_torch process."""

    # Windows swept per tick: bounds how long a tick holds the engine lock
    # (a full pass at 10^8 slots is 763 windows); the cursor resumes next
    # tick, so the whole capacity is still covered, over several ticks
    # (reference daemon.py:407).
    SWEEP_WINDOWS_PER_TICK = 16

    def __init__(self, conf: DaemonConfig, *, clock: Clock = SYSTEM_CLOCK, device=None,
                 store=None, loader=None):
        self.conf = conf
        self.clock = clock
        self.device = device
        self._store = store
        self._loader = loader
        self.instance: V1Instance | None = None
        self.gateway: Gateway | None = None
        self.status_gateway: Gateway | None = None
        self.registry = None
        self.http_address = conf.http_listen_address
        self.h2_fast = None
        self.h2_fast_address = ""
        self.grpc = None
        self.grpc_address = ""
        self.obs = None
        self.slo = None
        self._sweep_stop: threading.Event | None = None
        self._sweeper: threading.Thread | None = None
        self._serving = False  # start() ran to its end
        self._closed = False

    def start(self) -> None:
        check_single_node(self.conf)
        engine = self._build_engine()
        conf = self.conf
        self.instance = V1Instance(engine, sketch_window_ms=conf.sketch_window_ms,
                                   sketch_depth=conf.sketch_depth,
                                   sketch_width=conf.sketch_width,
                                   ledger=conf.ledger,
                                   ledger_opts=conf.ledger_opts(),
                                   behaviors=conf.behaviors, peer_picker=conf.peer_picker,
                                   hash_algorithm=conf.hash_algorithm,
                                   picker_replicas=conf.picker_replicas,
                                   data_center=conf.data_center)
        if self._loader is not None:
            # Restore persisted buckets before serving (reference:
            # gubernator.go:146-152).
            n = engine.load(self._loader)
            log.info("restored %d buckets from the loader", n)
        self._attach_flight_recorder()
        self.gateway = Gateway(self.instance, self.conf.http_listen_address)
        self.http_address = self.gateway.address
        self.registry = build_registry(self.instance, self.conf.metric_flags,
                                       address=self.http_address)
        self.gateway.registry = self.registry
        self.gateway.start()
        if self.conf.h2_fast_address:
            # One-method native serving with no per-RPC Python; a front
            # that does not build or bind fails the start.
            from gubernator_tpu_torch.net.h2_fast import H2FastFront

            self.h2_fast = H2FastFront(
                self.instance,
                port=int(self.conf.h2_fast_address.rpartition(":")[2] or 0),
                window_s=self.conf.h2_fast_window,
                lanes=self.conf.h2_lanes or None,
                native_ledger=self.conf.native_ledger,
            )
            self.h2_fast_address = self.h2_fast.address
            self.instance.h2_front = self.h2_fast
            if self.h2_fast._ring is not None:
                from gubernator_tpu_torch.utils.native_events import NativeEventCollector

                self.instance.native_events = NativeEventCollector.from_env(self.h2_fast)
        if conf.grpc_listen_address:
            from gubernator_tpu_torch.net.grpc_listener import GrpcListener

            self.grpc = GrpcListener(self.instance, conf.grpc_listen_address,
                                     workers=conf.grpc_workers)
            self.grpc_address = self.grpc.address
        self._start_obs()
        if self.conf.http_status_listen_address:
            self.status_gateway = Gateway(self.instance, self.conf.http_status_listen_address,
                                          self.registry)
            self.status_gateway.start()
        if self.conf.sweep_interval > 0:
            self._sweep_stop = threading.Event()
            self._sweeper = threading.Thread(target=self._sweep_loop, name="guber-sweep",
                                             daemon=True)
            self._sweeper.start()
        self._start_discovery()
        self._serving = True
        log.info(
            "gubernator_tpu_torch listening: grpc=%s http=%s h2=%s device=%s slots=%d keys=%d",
            self.grpc_address or "off", self.http_address, self.h2_fast_address or "off",
            engine.device, engine.capacity, engine.logical_capacity,
        )

    def _start_discovery(self) -> None:
        """Static membership (reference daemon.py:442-466): the full list
        of GUBER_STATIC_PEERS goes to the ring; with no other node named
        the ring stays empty.  Discovery was refused at start."""
        conf = self.conf
        own = {conf.grpc_listen_address, self.grpc_address, conf.http_listen_address,
               self.http_address, conf.h2_fast_address, conf.http_status_listen_address}
        if any(a not in own for a in conf.static_peers):
            self.set_peers([PeerInfo(grpc_address=a, datacenter=conf.data_center)
                            for a in conf.static_peers])

    def peer_info(self) -> PeerInfo:
        """This node as its peers see it (reference daemon.py:468)."""
        return PeerInfo(
            grpc_address=resolve_advertise_address(self.grpc_address,
                                                   self.conf.advertise_address),
            http_address=self.http_address, datacenter=self.conf.data_center)

    def set_peers(self, peers: Sequence[PeerInfo]) -> None:
        """Mark this node in the list (adding it when it is left out),
        then hand the list to the service (reference daemon.py:478,
        daemon.go:370-380)."""
        me = self.peer_info()
        marked: List[PeerInfo] = [
            PeerInfo(grpc_address=p.grpc_address, http_address=p.http_address,
                     datacenter=p.datacenter, is_owner=p.grpc_address == me.grpc_address)
            for p in peers
        ]
        if not any(p.is_owner for p in marked):
            me.is_owner = True
            marked.append(me)
        self.instance.set_peers(marked)

    def _attach_flight_recorder(self) -> None:
        """Hook the tail flight recorder to the in-memory tracer, if one
        runs: one recorder a tracer, so daemons sharing a process share
        it (reference daemon.py:228-248)."""
        from gubernator_tpu_torch.utils import tracing

        tracer = tracing.current_tracer()
        if isinstance(tracer, tracing.InMemoryTracer):
            from gubernator_tpu_torch.utils.flight_recorder import FlightRecorder

            fr = getattr(tracer, "_flight_recorder", None)
            if fr is None:
                fr = FlightRecorder.from_env(tracer)
                tracer._flight_recorder = fr
            self.instance.flight_recorder = fr

    def _start_obs(self) -> None:
        """The local rollup and the SLO watchdog, unless GUBER_OBS is off
        (reference daemon.py:351-377)."""
        if os.environ.get("GUBER_OBS", "1").strip().lower() in ("0", "false", "no", "off"):
            return
        from gubernator_tpu_torch.obs.fleet import FleetCollector
        from gubernator_tpu_torch.obs.slo import SLOWatchdog, watch_keys_from_env

        self.obs = FleetCollector(self.instance, addr=self.http_address,
                                  region=self.conf.data_center)
        self.instance.obs = self.obs
        watch_keys_from_env(self.instance.admission_watch)
        self.slo = SLOWatchdog.from_env(self.obs, self.instance.admission_watch)
        self.instance.slo_watchdog = self.slo

    def _build_engine(self):
        """The engine (reference daemon.py:124-147): with `device_count` n
        > 1, a ShardedDecisionEngine of n shards of cache_size // n slots;
        else one DecisionEngine of cache_size.  The reference puts its n
        shards on its first n devices; here all n live on the one card."""
        n = self.conf.device_count or 1
        if n > 1:
            from gubernator_tpu_torch.parallel.sharded_engine import ShardedDecisionEngine

            return ShardedDecisionEngine(
                shard_capacity=max(1, self.conf.cache_size // n), n_shards=n,
                clock=self.clock, store=self._store, device=self.device,
            )
        return DecisionEngine(self.conf.cache_size, clock=self.clock, device=self.device,
                              store=self._store)

    def _sweep_loop(self) -> None:
        while not self._sweep_stop.wait(self.conf.sweep_interval):
            try:
                self.instance.engine.sweep(max_windows=self.SWEEP_WINDOWS_PER_TICK)
            except Exception:  # noqa: BLE001 — a failed tick must not end the sweeper
                log.exception("expiry sweep failed")

    def close(self) -> None:
        """Graceful stop: the sweeper (joined, since a tick may be inside
        the engine), the h2 front (its stop joins the dispatch and
        feeder threads, which call into the engine), the listener, the final save, then
        the engine."""
        if self._closed:
            return
        self._closed = True
        if self._sweep_stop is not None:
            self._sweep_stop.set()
            self._sweeper.join(timeout=5.0)
        if self.slo is not None:
            self.slo.close()
        if self.instance is not None and self.instance.native_events is not None:
            # The drain thread ends before the front frees the ring (one
            # consumer, never a drain of a freed ring); if it outlived its
            # join, the ring is leaked instead of freed.
            if not self.instance.native_events.close() and self.h2_fast is not None:
                self.h2_fast.abandon_ring()
        if self.h2_fast is not None:
            self.h2_fast.close()
        if self.grpc is not None:
            # Its handler threads call into the service: stop them before
            # the service closes.
            self.grpc.close()
        if self.status_gateway is not None:
            self.status_gateway.close()
        if self.gateway is not None:
            self.gateway.close()
        if self.instance is not None:
            if self._loader is not None and self._serving:
                # Persist the cache on shutdown (reference:
                # gubernator.go:159-192 → Loader.Save); a start that failed
                # (a load that raised) must not overwrite the checkpoint.
                self.instance.engine.save(self._loader)
            self.instance.close()


def spawn_daemon(conf: DaemonConfig, *, clock: Clock = SYSTEM_CLOCK, device=None, store=None,
                 loader=None) -> Daemon:
    """Start a daemon; it is serving when this returns."""
    d = Daemon(conf, clock=clock, device=device, store=store, loader=loader)
    try:
        d.start()
    except BaseException:
        d.close()
        raise
    return d
