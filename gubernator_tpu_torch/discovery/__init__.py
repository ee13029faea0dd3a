"""Peer discovery backends.

The port's copy of `gubernator_tpu/discovery/` less the etcd wire client
(it needs gRPC): each backend watches a membership source and pushes the
full peer list to `daemon.set_peers` (reference: config.go:165,
daemon.go:185-220).  The port's daemon does not start one yet: it
refuses a config that names a discovery type other than "none"
(daemon.py `check_single_node`) until the peer planes land (ROADMAP A
entries 3-4).
"""

from __future__ import annotations

from typing import TYPE_CHECKING

if TYPE_CHECKING:
    from gubernator_tpu_torch.config import DaemonConfig


def create_discovery(conf: "DaemonConfig", daemon):
    """Build the configured backend (reference: daemon.go:185-220)."""
    kind = conf.peer_discovery_type
    if kind == "member-list":
        from gubernator_tpu_torch.discovery.memberlist import MemberListPool

        return MemberListPool(conf, daemon)
    if kind == "dns":
        from gubernator_tpu_torch.discovery.dns import DNSPool

        return DNSPool(conf, daemon)
    if kind == "etcd":
        from gubernator_tpu_torch.discovery.etcd import EtcdPool

        return EtcdPool(conf, daemon)
    if kind == "k8s":
        from gubernator_tpu_torch.discovery.kubernetes import K8sPool

        return K8sPool(conf, daemon)
    raise ValueError(f"unknown peer discovery type {kind!r}")
