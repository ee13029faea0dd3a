"""Daemon — process bootstrap: engine + service + HTTP gateway.

Port of `gubernator_tpu/daemon.py` for one node: `spawn_daemon(conf)`
builds the decision engine on the card (or on `device` when given),
wires the V1 service, and starts the HTTP gateway.  The gRPC front,
peer discovery, the sweep loop and the cluster planes are not in this
slice.
"""

from __future__ import annotations

import logging

from gubernator_tpu_torch.clock import SYSTEM_CLOCK, Clock
from gubernator_tpu_torch.config import DaemonConfig
from gubernator_tpu_torch.core.engine import DecisionEngine
from gubernator_tpu_torch.net.gateway import Gateway
from gubernator_tpu_torch.service import V1Instance

log = logging.getLogger("gubernator_tpu_torch.daemon")


class Daemon:
    """One gubernator_tpu_torch process."""

    def __init__(self, conf: DaemonConfig, *, clock: Clock = SYSTEM_CLOCK, device=None):
        self.conf = conf
        self.clock = clock
        self.device = device
        self.instance: V1Instance | None = None
        self.gateway: Gateway | None = None
        self.http_address = conf.http_listen_address
        self._closed = False

    def start(self) -> None:
        engine = DecisionEngine(self.conf.cache_size, clock=self.clock, device=self.device)
        self.instance = V1Instance(engine)
        self.gateway = Gateway(self.instance, self.conf.http_listen_address)
        self.http_address = self.gateway.address
        self.gateway.start()
        log.info(
            "gubernator_tpu_torch listening: http=%s device=%s slots=%d",
            self.http_address, engine.device, engine.capacity,
        )

    def close(self) -> None:
        """Graceful stop: the listener first, then the engine."""
        if self._closed:
            return
        self._closed = True
        if self.gateway is not None:
            self.gateway.close()
        if self.instance is not None:
            self.instance.close()


def spawn_daemon(conf: DaemonConfig, *, clock: Clock = SYSTEM_CLOCK, device=None) -> Daemon:
    """Start a daemon; it is serving when this returns."""
    d = Daemon(conf, clock=clock, device=device)
    try:
        d.start()
    except BaseException:
        d.close()
        raise
    return d
