"""Shared scaffolding for discovery backends (the port's copy of
`gubernator_tpu/discovery/base.py`)."""

from __future__ import annotations

import logging
import threading
from typing import TYPE_CHECKING, List

from gubernator_tpu_torch.types import PeerInfo

if TYPE_CHECKING:
    from gubernator_tpu_torch.daemon import Daemon

log = logging.getLogger("gubernator_tpu_torch.discovery")


class DiscoveryBase:
    """A backend pushes full peer lists to the daemon on change.

    reference: config.go:165 (OnUpdate UpdateFunc) → daemon.SetPeers.
    """

    def __init__(self, daemon: "Daemon"):
        self.daemon = daemon
        self._closed = threading.Event()

    def on_update(self, peers: List[PeerInfo]) -> None:
        if self._closed.is_set():
            return
        try:
            self.daemon.set_peers(peers)
        except Exception:  # noqa: BLE001 — discovery must survive pushes
            from gubernator_tpu_torch.utils.metrics import record_swallowed

            record_swallowed("discovery.set_peers")
            log.exception("SetPeers from discovery failed")

    def start(self) -> None:
        raise NotImplementedError

    def close(self) -> None:
        self._closed.set()
