"""The port's CUDA kernels against their plain PyTorch versions, on a GPU.

Marked `cuda`: each test skips where no GPU is present (the CPU tier-1
run).  On a machine with a card and without JAX, run them with

    python -m pytest tests/test_torch_cuda.py --noconftest -q

(`--noconftest`: tests/conftest.py loads the JAX package).  This module
imports only the port, so it runs there.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from gubernator_tpu_torch.clock import Clock
from gubernator_tpu_torch.core.engine import DecisionEngine
from gubernator_tpu_torch.ops import bucket_kernel as tk
from gubernator_tpu_torch.ops import fused_step as fs

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; the CPU tier runs the plain versions")
    return torch.device("cuda")


def _state_words(rng, cap, now):
    return tk.pack_state_host(dict(
        occupied=rng.random(cap) < 0.75, algo=rng.integers(0, 2, cap),
        status=rng.integers(0, 2, cap), t0=now - rng.integers(0, 5_000, cap),
        invalid=np.where(rng.random(cap) < 0.1, now + rng.integers(-50, 50, cap), 0),
        expire=now + rng.integers(-100, 5_000, cap),
        duration=rng.choice([0, 1, 40, 1000, 30_000], cap),
        limit=rng.choice([0, 1, 5, 100, 10**12], cap), remaining=rng.integers(-5, 200, cap),
        remf_hi=rng.integers(-3, 200, cap).astype(np.int32),
        remf_lo=rng.integers(0, 2**32, cap, dtype=np.uint64).astype(np.uint32),
        burst=rng.choice([0, 0, 5, 20], cap),
    ))


@pytest.mark.parametrize("width", [64, 1024])
def test_fused_step_kernel_bit_equal_to_plain(cuda, width):
    rng = np.random.default_rng(width)
    cap, now = 1 << 16, 1_760_000_000_000
    words = _state_words(rng, cap, now)
    kern, plain = tk.state_from_numpy(words, cuda), tk.state_from_numpy(words, cuda)
    fs.reset_launches()
    for it in range(8):
        now += int(rng.integers(0, 300))
        m = width - int(rng.integers(0, width // 4 + 1))
        slots = np.sort(rng.choice(cap, m, replace=False)).astype(np.int32)
        cols = [rng.integers(0, 3, m), rng.choice([0, 4, 8, 12], m),
                rng.choice([-3, 0, 1, 2, 5, 2**40], m), rng.choice([-1, 0, 5, 100, 2**62], m),
                rng.choice([0, 1, 40, 30_000, -5], m), rng.choice([0, 0, 5, -7], m),
                rng.choice([60_000, 86_400_000], m), now + rng.integers(0, 100_000, m)]
        pin = torch.from_numpy(tk.pack_batch_host(width, now, cap, slots, *cols)).to(cuda)
        got = fs.fused_step(kern, pin)
        want = tk.fused_step_reference(plain, pin)
        torch.cuda.synchronize()
        assert torch.equal(got, want), it
        for name, a, b in zip(tk.BucketState._fields, kern, plain):
            assert torch.equal(a, b), (it, name)
    assert fs.launches["fused_step"] == 8


def test_clear_occupied_kernel_bit_equal_to_plain(cuda):
    rng = np.random.default_rng(1)
    cap = 1 << 16
    meta = torch.from_numpy(rng.integers(0, 2**26, cap).astype(np.int32)).to(cuda)
    plain = meta.clone()
    fs.reset_launches()
    for width in (16, 256):
        c = np.arange(cap, cap + width, dtype=np.int64).astype(np.int32)
        c[: width - 3] = np.sort(rng.choice(cap, width - 3, replace=False))
        slots = torch.from_numpy(c).to(cuda)
        fs.clear_occupied(meta, slots)
        tk.clear_occupied_reference(plain, slots)
        torch.cuda.synchronize()
        assert torch.equal(meta, plain), width
    assert fs.launches["clear_occupied"] == 2


def test_engine_on_the_card_matches_the_cpu(cuda):
    rng = np.random.default_rng(2)
    ns = 1_760_000_000_000 * 1_000_000
    gpu = DecisionEngine(512, clock=Clock().freeze_at(ns), device=cuda)
    cpu = DecisionEngine(512, clock=Clock().freeze_at(ns), device="cpu")
    assert gpu.fused_mode == "cuda"
    keys = [b"k%d" % i for i in range(1500)]
    for _ in range(10):
        n = 300
        batch = [keys[int(i)] for i in rng.integers(0, len(keys), n)]
        cols = (rng.integers(0, 2, n).astype(np.int32),
                rng.choice([0, 8], n).astype(np.int32),
                rng.choice([0, 1, 2, 5], n).astype(np.int64),
                rng.choice([5, 100], n).astype(np.int64),
                rng.choice([1000, 60_000], n).astype(np.int64),
                rng.choice([0, 20], n).astype(np.int64))
        for g, w in zip(gpu.apply_columnar(batch, *cols), cpu.apply_columnar(batch, *cols)):
            assert np.array_equal(g, w)
        gpu.clock.advance(ms=100)
        cpu.clock.advance(ms=100)
    got, want = tk.state_to_numpy(gpu.state), tk.state_to_numpy(cpu.state)
    for f in tk.BucketState._fields:
        assert np.array_equal(got[f], want[f]), f
    assert gpu.table.evictions > 0
