"""etcd peer discovery.

reference: etcd.go — lease-TTL registration (30s) with keep-alive and
re-register (etcd.go:222-316), prefix watch with revision resume
(:110-220), delete+revoke on shutdown (:298-311).

The port's copy of `gubernator_tpu/discovery/etcd.py` up to its
transport: `EtcdPool` drives an injected etcd3-shaped client (`lease`,
`put`, `get_prefix`, `add_watch_prefix_callback`, `cancel_watch`,
`delete`).  The JAX package's wire client speaks etcd's gRPC API, which
the port does not carry yet (ROADMAP A entry 5), so with no client given
the pool raises."""

from __future__ import annotations

import json
import threading
from typing import TYPE_CHECKING, Dict

from gubernator_tpu_torch.discovery.base import DiscoveryBase, log
from gubernator_tpu_torch.types import PeerInfo

if TYPE_CHECKING:
    from gubernator_tpu_torch.config import DaemonConfig
    from gubernator_tpu_torch.daemon import Daemon

LEASE_TTL_S = 30  # reference: etcd.go:35 (etcdTTL)


class EtcdPool(DiscoveryBase):
    def __init__(
        self,
        conf: "DaemonConfig",
        daemon: "Daemon",
        *,
        client=None,  # injectable for tests (any etcd3-shaped client)
        keepalive_interval: float = LEASE_TTL_S / 3,
    ):
        super().__init__(daemon)
        if client is None:
            raise RuntimeError(
                "etcd discovery needs an etcd client: the port has no wire client for "
                "etcd's gRPC API yet (ROADMAP A entry 5); pass client= an etcd3-shaped "
                "client"
            )
        self._client = client
        self.keepalive_interval = keepalive_interval
        self.key_prefix = conf.etcd_key_prefix
        # Optional registration overrides (GUBER_ETCD_ADVERTISE_ADDRESS
        # / GUBER_ETCD_DATA_CENTER; reference: config.go:369-370).
        self._advertise_address = getattr(conf, "etcd_advertise_address", "")
        self._advertise_dc = getattr(conf, "etcd_data_center", "")
        self._lease = None
        self._watch_id = None
        self._peers: Dict[str, PeerInfo] = {}
        self._keepalive = threading.Thread(
            target=self._keepalive_loop, name="guber-etcd-lease", daemon=True
        )

    def _advertised(self):
        me = self.daemon.peer_info()
        grpc = self._advertise_address or me.grpc_address
        dc = self._advertise_dc or me.datacenter
        return grpc, me.http_address, dc

    def _my_key(self) -> str:
        return self.key_prefix + self._advertised()[0]

    def _register(self) -> None:
        """reference: etcd.go:222-316 (register + keep-alive loop)."""
        grpc, http, dc = self._advertised()
        self._lease = self._client.lease(LEASE_TTL_S)
        self._client.put(
            self._my_key(),
            json.dumps({"grpc": grpc, "http": http, "dc": dc}),
            lease=self._lease,
        )

    def _keepalive_loop(self) -> None:
        while not self._closed.wait(self.keepalive_interval):
            try:
                if self._lease is not None:
                    self._lease.refresh()
            except Exception:  # noqa: BLE001
                from gubernator_tpu_torch.utils.metrics import record_swallowed

                record_swallowed("discovery.etcd_keepalive")
                log.exception("etcd lease refresh failed; re-registering")
                try:
                    self._register()
                except Exception:  # noqa: BLE001
                    log.exception("etcd re-register failed")

    def _sync(self) -> None:
        peers: Dict[str, PeerInfo] = {}
        for value, meta in self._client.get_prefix(self.key_prefix):
            try:
                obj = json.loads(value)
                peers[obj["grpc"]] = PeerInfo(
                    grpc_address=obj["grpc"],
                    http_address=obj.get("http", ""),
                    datacenter=obj.get("dc", ""),
                )
            except (ValueError, KeyError):
                continue
        # Watch events fire for every keepalive refresh and value
        # rewrite, not just membership changes; only a CHANGED view may
        # reach set_peers — each push rebuilds the consistent-hash
        # rings, and the membership plane treats a changed view as an
        # epoch transition (cluster/membership.py double-checks, but
        # the rebuild cost is saved here).  http_address participates:
        # a node re-registering with a new gateway port must propagate
        # even though its ring identity (grpc, dc) is unchanged.
        changed = {
            (a, p.datacenter, p.http_address) for a, p in peers.items()
        } != {
            (a, p.datacenter, p.http_address)
            for a, p in self._peers.items()
        }
        self._peers = peers
        if changed:
            self.on_update(list(peers.values()))

    def _on_event(self, event) -> None:
        self._sync()

    def start(self) -> None:
        self._register()
        self._sync()
        self._watch_id = self._client.add_watch_prefix_callback(
            self.key_prefix, self._on_event
        )
        self._keepalive.start()

    def close(self) -> None:
        super().close()
        # The keepalive loop wakes on the _closed event; reap it so a
        # lease refresh can't race the deregister below.
        if self._keepalive.is_alive():
            self._keepalive.join(timeout=2.0)
        try:
            if self._watch_id is not None:
                self._client.cancel_watch(self._watch_id)
            # Delete our key + revoke lease (reference: etcd.go:298-311).
            self._client.delete(self._my_key())
            if self._lease is not None:
                self._lease.revoke()
        except Exception:  # noqa: BLE001
            log.exception("etcd deregister failed")
