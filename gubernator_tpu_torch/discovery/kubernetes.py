"""Kubernetes peer discovery (gated on the optional kubernetes client).

reference: kubernetes.go — SharedIndexInformer watch on Endpoints or
Pods selected by label (:48-65,103-188); peers built from ready pod IPs
(:190-244); in-cluster REST config (kubernetesconfig.go).

The `kubernetes` package is not part of this image; the backend raises
a clear error at construction when unavailable and implements a
pod-label watch when it is.  The port's copy of
`gubernator_tpu/discovery/kubernetes.py`.
"""

from __future__ import annotations

import threading
from typing import TYPE_CHECKING

from gubernator_tpu_torch.discovery.base import DiscoveryBase, log
from gubernator_tpu_torch.types import PeerInfo

if TYPE_CHECKING:
    from gubernator_tpu_torch.config import DaemonConfig
    from gubernator_tpu_torch.daemon import Daemon


class K8sPool(DiscoveryBase):
    def __init__(
        self,
        conf: "DaemonConfig",
        daemon: "Daemon",
        *,
        core_api=None,  # injectable for tests (CoreV1Api-shaped)
        watch_factory=None,  # injectable for tests (kubernetes.watch.Watch-shaped)
    ):
        super().__init__(daemon)
        if core_api is None:
            try:
                import kubernetes  # noqa: F401
            except ImportError as e:
                raise RuntimeError(
                    "k8s discovery requires the 'kubernetes' package, which "
                    "is not installed in this environment; use member-list "
                    "or dns discovery instead"
                ) from e
            from kubernetes import client, config as k8s_config

            k8s_config.load_incluster_config()
            core_api = client.CoreV1Api()
        if watch_factory is None:
            # Resolve here, not in the watch thread — an ImportError
            # there would kill the loop silently with no peer pushes.
            try:
                from kubernetes import watch as k8s_watch
            except ImportError as e:
                raise RuntimeError(
                    "k8s discovery requires the 'kubernetes' package "
                    "(watch); inject watch_factory= for tests"
                ) from e
            watch_factory = k8s_watch.Watch
        import os

        self._core = core_api
        self._watch_factory = watch_factory
        self.namespace = os.environ.get("GUBER_K8S_NAMESPACE", "default")
        self.selector = os.environ.get("GUBER_K8S_POD_SELECTOR", "app=gubernator")
        self.grpc_port = daemon.grpc_address.rpartition(":")[2]
        self.http_port = daemon.http_address.rpartition(":")[2]
        self.datacenter = conf.data_center
        self._thread = threading.Thread(
            target=self._watch_loop, name="guber-k8s", daemon=True
        )

    def _list_peers(self):
        pods = self._core.list_namespaced_pod(
            self.namespace, label_selector=self.selector
        )
        peers = []
        for pod in pods.items:
            ip = pod.status.pod_ip
            ready = any(
                c.type == "Ready" and c.status == "True"
                for c in (pod.status.conditions or [])
            )
            if ip and ready:  # reference: kubernetes.go:190-244
                peers.append(
                    PeerInfo(
                        grpc_address=f"{ip}:{self.grpc_port}",
                        http_address=f"{ip}:{self.http_port}",
                        datacenter=self.datacenter,
                    )
                )
        return peers

    def _watch_loop(self) -> None:
        while not self._closed.is_set():
            try:
                self.on_update(self._list_peers())
                w = self._watch_factory()
                for _ in w.stream(
                    self._core.list_namespaced_pod,
                    self.namespace,
                    label_selector=self.selector,
                    timeout_seconds=30,
                ):
                    if self._closed.is_set():
                        return
                    self.on_update(self._list_peers())
            except Exception:  # noqa: BLE001
                from gubernator_tpu_torch.utils.metrics import record_swallowed

                record_swallowed("discovery.k8s_watch")
                log.exception("k8s watch failed; retrying")
                self._closed.wait(2.0)

    def start(self) -> None:
        self._thread.start()

    def close(self) -> None:
        super().close()
        self._thread.join(timeout=2.0)
