"""DNS peer discovery: poll A/AAAA records of an FQDN.

reference: dns.go:34-214 — resolve the FQDN at a TTL-driven interval
(min 300s default) and push the address set as the peer list; ports are
fixed for discovered peers (reference hardcodes :81/:80,
dns.go:155-168).  Uses the stdlib resolver (no raw-DNS dependency in
this image); poll interval comes from config instead of record TTLs.
The port's copy of `gubernator_tpu/discovery/dns.py`.
"""

from __future__ import annotations

import socket
import threading
from typing import TYPE_CHECKING, List

from gubernator_tpu_torch.discovery.base import DiscoveryBase, log
from gubernator_tpu_torch.types import PeerInfo

if TYPE_CHECKING:
    from gubernator_tpu_torch.config import DaemonConfig
    from gubernator_tpu_torch.daemon import Daemon


class DNSPool(DiscoveryBase):
    def __init__(self, conf: "DaemonConfig", daemon: "Daemon"):
        super().__init__(daemon)
        if not conf.dns_fqdn:
            raise ValueError("GUBER_DNS_FQDN is required for dns discovery")
        self.fqdn = conf.dns_fqdn
        self.interval = max(conf.dns_poll_interval, 1.0)
        self.grpc_port = daemon.grpc_address.rpartition(":")[2]
        self.http_port = daemon.http_address.rpartition(":")[2]
        self.datacenter = conf.data_center
        self._thread = threading.Thread(
            target=self._poll_loop, name="guber-dns", daemon=True
        )

    def _resolve(self) -> List[PeerInfo]:
        addrs = set()
        for info in socket.getaddrinfo(self.fqdn, None, proto=socket.IPPROTO_TCP):
            addrs.add(info[4][0])
        return [
            PeerInfo(
                grpc_address=f"{a}:{self.grpc_port}",
                http_address=f"{a}:{self.http_port}",
                datacenter=self.datacenter,
            )
            for a in sorted(addrs)
        ]

    def _poll_loop(self) -> None:
        last: List[PeerInfo] = []
        while not self._closed.wait(0 if not last else self.interval):
            try:
                peers = self._resolve()
            except socket.gaierror as e:
                log.warning("dns resolve %s failed: %s", self.fqdn, e)
                continue
            if peers != last:
                last = peers
                self.on_update(peers)

    def start(self) -> None:
        self._thread.start()

    def close(self) -> None:
        super().close()
        self._thread.join(timeout=2.0)
