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
through the host store.  The gRPC front, peer discovery and the cluster
planes are not in this slice.
"""

from __future__ import annotations

import logging
import threading

from gubernator_tpu_torch.clock import SYSTEM_CLOCK, Clock
from gubernator_tpu_torch.config import DaemonConfig
from gubernator_tpu_torch.core.engine import DecisionEngine
from gubernator_tpu_torch.net.gateway import Gateway
from gubernator_tpu_torch.service import V1Instance

log = logging.getLogger("gubernator_tpu_torch.daemon")


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
        self.http_address = conf.http_listen_address
        self.h2_fast = None
        self.h2_fast_address = ""
        self._sweep_stop: threading.Event | None = None
        self._sweeper: threading.Thread | None = None
        self._serving = False  # start() ran to its end
        self._closed = False

    def start(self) -> None:
        engine = self._build_engine()
        self.instance = V1Instance(engine, sketch_window_ms=self.conf.sketch_window_ms,
                                   sketch_depth=self.conf.sketch_depth,
                                   sketch_width=self.conf.sketch_width,
                                   ledger=self.conf.ledger,
                                   ledger_opts=self.conf.ledger_opts())
        if self._loader is not None:
            # Restore persisted buckets before serving (reference:
            # gubernator.go:146-152).
            n = engine.load(self._loader)
            log.info("restored %d buckets from the loader", n)
        self.gateway = Gateway(self.instance, self.conf.http_listen_address)
        self.http_address = self.gateway.address
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
        if self.conf.sweep_interval > 0:
            self._sweep_stop = threading.Event()
            self._sweeper = threading.Thread(target=self._sweep_loop, name="guber-sweep",
                                             daemon=True)
            self._sweeper.start()
        self._serving = True
        log.info(
            "gubernator_tpu_torch listening: http=%s h2=%s device=%s slots=%d keys=%d",
            self.http_address, self.h2_fast_address or "off", engine.device, engine.capacity,
            engine.logical_capacity,
        )

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
        if self.h2_fast is not None:
            self.h2_fast.close()
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
