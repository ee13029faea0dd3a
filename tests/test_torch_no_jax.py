"""The port loads neither JAX nor any module of the JAX package.

Checked in a fresh interpreter: tests/conftest.py itself imports jax, so
an in-process check would see it whatever the port does.  Note the
prefix: `gubernator_tpu_torch` must not count as `gubernator_tpu`.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

_PROBE = r"""
import importlib, json, pkgutil, sys
import gubernator_tpu_torch as pkg
names = [pkg.__name__] + [
    m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")
]
for name in names:
    importlib.import_module(name)
print(json.dumps({"imported": names, "loaded": sorted(sys.modules)}))
"""


def _is_jax(name: str) -> bool:
    return name in ("jax", "jaxlib") or name.startswith(("jax.", "jaxlib."))


def _is_reference(name: str) -> bool:
    return name == "gubernator_tpu" or name.startswith("gubernator_tpu.")


def test_prefix_rules():
    assert _is_reference("gubernator_tpu") and _is_reference("gubernator_tpu.ops")
    assert not _is_reference("gubernator_tpu_torch")
    assert not _is_reference("gubernator_tpu_torch.ops.bucket_kernel")
    assert _is_jax("jax") and _is_jax("jaxlib.xla_client") and not _is_jax("jaxtyping")


def test_port_modules_import_without_jax_or_the_reference():
    out = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=ROOT, capture_output=True, text=True,
        timeout=120, check=True,
    ).stdout
    got = json.loads(out.strip().splitlines()[-1])
    expected = {
        "gubernator_tpu_torch.ops.bucket_kernel",
        "gubernator_tpu_torch.ops.fused_step",
        "gubernator_tpu_torch.ops.native_build",
        "gubernator_tpu_torch.ops.collapsed_step",
        "gubernator_tpu_torch.ops.expiry",
        "gubernator_tpu_torch.ops.sketch",
        "gubernator_tpu_torch.hashing",
        "gubernator_tpu_torch.core.engine",
        "gubernator_tpu_torch.core.interning",
        "gubernator_tpu_torch.core.native",
        "gubernator_tpu_torch.core.pump",
        "gubernator_tpu_torch.core.readback",
        "gubernator_tpu_torch.service",
        "gubernator_tpu_torch.net.gateway",
        "gubernator_tpu_torch.net.h2_fast",
        "gubernator_tpu_torch.net.wire_codec",
        "gubernator_tpu_torch.core.h2_client",
        "gubernator_tpu_torch.core.ledger",
        "gubernator_tpu_torch.core.native_plane",
        "gubernator_tpu_torch.utils.metrics",
        "gubernator_tpu_torch.daemon",
        "gubernator_tpu_torch.cmd.daemon",
        "gubernator_tpu_torch.config",
        "gubernator_tpu_torch.store",
        "gubernator_tpu_torch.checkpoint",
        "gubernator_tpu_torch.gregorian",
        "gubernator_tpu_torch.clock",
        "gubernator_tpu_torch.types",
    }
    assert expected <= set(got["imported"])
    assert [m for m in got["loaded"] if _is_jax(m)] == []
    assert [m for m in got["loaded"] if _is_reference(m)] == []
