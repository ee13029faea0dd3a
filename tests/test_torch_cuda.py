"""The port's CUDA kernels against their plain PyTorch versions, on a GPU.

Marked `cuda`: each test skips where no GPU is present (the CPU tier-1
run).  On a machine with a card and without JAX, run them with

    python -m pytest tests/test_torch_cuda.py --noconftest -q

(`--noconftest`: tests/conftest.py loads the JAX package).  This module
imports only the port, so it runs there.
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from gubernator_tpu_torch.clock import Clock
from gubernator_tpu_torch.core.engine import DecisionEngine
from gubernator_tpu_torch.ops import bucket_kernel as tk
from gubernator_tpu_torch.ops import fused_step as fs
from gubernator_tpu_torch.ops.collapsed_step import collapsed_step

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


def _rand_cols(rng, m, now):
    return [rng.integers(0, 3, m), rng.choice([0, 4, 8, 12], m),
            rng.choice([-3, 0, 1, 2, 5, 2**40], m), rng.choice([-1, 0, 5, 100, 2**62], m),
            rng.choice([0, 1, 40, 30_000, -5], m), rng.choice([0, 0, 5, -7], m),
            rng.choice([60_000, 86_400_000], m), now + rng.integers(0, 100_000, m)]


def _to(packed, dev):
    flat = torch.from_numpy(packed.buf).to(dev)
    return tk.split_rounds(flat, packed.pin.shape[1], len(packed.round_off) - 1)


@pytest.mark.parametrize("n_rounds", [1, 3, 16])
def test_multi_fused_step_kernel_bit_equal_to_plain(cuda, n_rounds):
    """Ragged rounds with clears (in range, recurring and out of range),
    one slot in every round: the cooperative kernel equals the plain
    multi-round step in pout and all 12 columns."""
    rng = np.random.default_rng(30 + n_rounds)
    cap, now = 1 << 16, 1_760_000_000_000
    words = _state_words(rng, cap, now)
    kern, plain = tk.state_from_numpy(words, cuda), tk.state_from_numpy(words, cuda)
    fs.reset_launches()
    calls = 9
    for call in range(calls):
        now += int(rng.integers(0, 300))
        counts = [int(rng.integers(1, 1200)) for _ in range(n_rounds)]
        slots = [np.sort(np.append(rng.choice(np.arange(1, cap), m - 1, replace=False), 0))
                 for m in counts]
        clears = [[] if r % 2 else [int(s) for s in slots[r][:: 7]][:40] + [cap + r]
                  for r in range(n_rounds)]
        packed = tk.pack_rounds_host(now, cap, counts, np.concatenate(slots).astype(np.int32),
                                     _rand_cols(rng, sum(counts), now), clears)
        got = fs.multi_fused_step(kern, *_to(packed, cuda), widest=packed.widest)
        want = tk.multi_fused_step_reference(plain, *_to(packed, cuda))
        torch.cuda.synchronize()
        assert torch.equal(got, want), call
        for name, a, b in zip(tk.BucketState._fields, kern, plain):
            assert torch.equal(a, b), (call, name)
    assert fs.launches["fused_step"] == calls


def test_multi_fused_step_grid_barrier_orders_rounds(cuda):
    """One token bucket hit once in each of 16 rounds of 4096 lanes, its
    lane moving by 256 each round, so a different block owns it every
    round: without the grid barrier a round would read the bucket before
    the previous round's store.  Remaining must fall by one each round."""
    cap, now, width, n_rounds, hot = 1 << 20, 1_760_000_000_000, 4096, 16, 1 << 19
    rng = np.random.default_rng(5)
    kern = tk.make_state(cap, cuda)
    plain = tk.make_state(cap, cuda)
    counts, slots = [width] * n_rounds, []
    for r in range(n_rounds):
        below = rng.choice(hot, 256 * r, replace=False)
        above = rng.choice(np.arange(hot + 1, cap), width - 1 - 256 * r, replace=False)
        slots.append(np.sort(np.concatenate([below, [hot], above])).astype(np.int32))
    n = width * n_rounds
    cols = [np.zeros(n, np.int64), np.zeros(n, np.int64), np.ones(n, np.int64),
            np.full(n, 10**6, np.int64), np.full(n, 3_600_000, np.int64),
            np.zeros(n, np.int64), np.zeros(n, np.int64), np.zeros(n, np.int64)]
    packed = tk.pack_rounds_host(now, cap, counts, np.concatenate(slots), cols,
                                 [[] for _ in range(n_rounds)])
    lanes = [r * width + 256 * r for r in range(n_rounds)]
    for k in range(3):  # the bucket carries over
        got = fs.multi_fused_step(kern, *_to(packed, cuda), widest=width)
        want = tk.multi_fused_step_reference(plain, *_to(packed, cuda))
        torch.cuda.synchronize()
        assert torch.equal(got, want), k
        rem = got[2, lanes].cpu().tolist()
        assert rem == [10**6 - 1 - r - n_rounds * k for r in range(n_rounds)], k
        for name, a, b in zip(tk.BucketState._fields, kern, plain):
            assert torch.equal(a, b), (k, name)


def test_multi_fused_step_rejects_a_bad_launch(cuda):
    """No grid size, or offsets on another device: the wrapper raises
    before any launch."""
    state = tk.make_state(64, cuda)
    pin = torch.zeros((16, 64), dtype=torch.int32, device=cuda)
    off = torch.tensor([0, 64], dtype=torch.int32, device=cuda)
    fs.reset_launches()
    with pytest.raises(ValueError, match="widest"):
        fs.multi_fused_step(state, pin, off, torch.zeros_like(off), off[1:])
    with pytest.raises(ValueError, match="round_off"):
        fs.multi_fused_step(state, pin, off.cpu(), torch.zeros_like(off), off[1:], widest=64)
    assert fs.launches["fused_step"] == 0


def test_engine_hot_key_batch_on_the_card(cuda):
    """A key repeated 200 times with 50 others, each key with a limit of
    its own (so not the uniform format): one K3 launch (the collapse);
    forced onto the rounds path, 200 rounds of 32 lanes in one K1
    launch.  Both answer as the CPU engine does."""
    ns = 1_760_000_000_000 * 1_000_000
    rounds = DecisionEngine(256, clock=Clock().freeze_at(ns), device=cuda)
    rounds._try_collapse = lambda *a, **k: None
    gpu = DecisionEngine(256, clock=Clock().freeze_at(ns), device=cuda)
    cpu = DecisionEngine(256, clock=Clock().freeze_at(ns), device="cpu")
    fs.reset_launches()
    for algo in (0, 1):
        keys = [b"hot%d" % algo] * 200 + [b"k%d" % i for i in range(50)]
        n = len(keys)
        limit = np.concatenate([np.full(200, 150), 151 + np.arange(50)]).astype(np.int64)
        cols = (np.full(n, algo, np.int32), np.zeros(n, np.int32), np.ones(n, np.int64),
                limit, np.full(n, 60_000, np.int64), np.zeros(n, np.int64))
        want = cpu.apply_columnar(keys, *cols)
        for eng in (gpu, rounds):
            for g, w in zip(eng.apply_columnar(keys, *cols), want):
                assert np.array_equal(g, w)
    assert fs.launches["collapsed_step"] == gpu.dispatches_total == 2
    assert fs.launches["fused_step"] == rounds.dispatches_total == 2
    assert rounds.rounds_total == 400
    want = tk.state_to_numpy(cpu.state)
    for eng in (gpu, rounds):
        got = tk.state_to_numpy(eng.state)
        for f in tk.BucketState._fields:
            assert np.array_equal(got[f], want[f]), f


def test_engine_on_the_card_matches_the_cpu(cuda):
    rng = np.random.default_rng(2)
    ns = 1_760_000_000_000 * 1_000_000
    gpu = DecisionEngine(512, clock=Clock().freeze_at(ns), device=cuda)
    cpu = DecisionEngine(512, clock=Clock().freeze_at(ns), device="cpu")
    assert gpu.fused_mode == "cuda"
    fs.reset_launches()
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
    # one launch per batch (K1, or K3 for a batch that collapses), with
    # the clears inside it; no K2 launch
    assert fs.launches["fused_step"] + fs.launches["collapsed_step"] == gpu.dispatches_total
    assert gpu.dispatches_total == 10 < gpu.rounds_total
    assert fs.launches["clear_occupied"] == 0 and gpu.clears_total > 0


def _segments(rng, cap, n_seg, now, max_m=6):
    uniq = np.sort(rng.choice(cap, n_seg, replace=False)).astype(np.int32)
    counts = rng.integers(1, max_m + 1, n_seg).astype(np.int64)
    fields = (rng.integers(0, 3, n_seg), rng.choice([0, 0, 4], n_seg),
              rng.choice([-3, 0, 1, 2, 3, 5, 2**40], n_seg),
              rng.choice([-1, 0, 1, 4, 10, 100, 2**62], n_seg),
              rng.choice([0, 1, 40, 60_000, -5], n_seg), rng.choice([0, 0, 3, 20, -7], n_seg),
              rng.choice([60_000, 86_400_000], n_seg), now + rng.integers(0, 100_000, n_seg))
    seg = np.repeat(np.arange(n_seg), counts).astype(np.int32)
    pos = (np.arange(len(seg)) - np.repeat(np.cumsum(counts) - counts, counts)).astype(np.int32)
    return uniq, counts, fields, seg, pos


@pytest.mark.parametrize("n_seg", [1, 40, 1500])
def test_collapsed_step_kernel_bit_equal_to_plain(cuda, n_seg):
    """K3 against clear + `collapsed_step_reference`: random segments
    (every closed-form branch), clears among the segments' slots, in
    pout and all 12 columns."""
    rng = np.random.default_rng(60 + n_seg)
    cap, now = 1 << 16, 1_760_000_000_000
    words = _state_words(rng, cap, now)
    kern, plain = tk.state_from_numpy(words, cuda), tk.state_from_numpy(words, cuda)
    fs.reset_launches()
    for call in range(6):
        now += int(rng.integers(0, 3_000))
        uniq, counts, fields, seg, pos = _segments(rng, cap, n_seg, now)
        size = 32 * -(-len(seg) // 32)
        pin = torch.from_numpy(tk.pack_collapsed_host(size, now, cap, uniq, counts, fields,
                                                      seg, pos)).to(cuda)
        clears = torch.from_numpy(np.append(uniq[::5], cap + 1).astype(np.int32)).to(cuda)
        if call % 2:
            clears = clears[:0]
        got = collapsed_step(kern, pin, clears)
        tk.clear_occupied_reference(plain.meta, clears)
        want = tk.collapsed_step_reference(plain, pin)
        torch.cuda.synchronize()
        assert torch.equal(got, want), call
        for name, a, b in zip(tk.BucketState._fields, kern, plain):
            assert torch.equal(a, b), (call, name)
    assert fs.launches["collapsed_step"] == 6


def _collapsed_pin(rng, cap, now, lane_slots, size=None):
    """A collapsed chunk over the given lanes' slots (sorted), with
    random per-segment fields; returns (pin, segment slots)."""
    uniq, counts = np.unique(lane_slots, return_counts=True)
    n_seg = len(uniq)
    fields = (rng.integers(0, 3, n_seg), rng.choice([0, 0, 4], n_seg),
              rng.choice([-3, 0, 1, 2, 3, 5, 2**40], n_seg),
              rng.choice([-1, 0, 1, 4, 10, 100, 10**4, 2**62], n_seg),
              rng.choice([0, 1, 40, 60_000, -5], n_seg), rng.choice([0, 0, 3, 20, -7], n_seg),
              rng.choice([60_000, 86_400_000], n_seg), now + rng.integers(0, 100_000, n_seg))
    seg = np.repeat(np.arange(n_seg), counts).astype(np.int32)
    pos = (np.arange(len(seg)) - np.repeat(np.cumsum(counts) - counts, counts)).astype(np.int32)
    size = size or 32 * -(-len(seg) // 32)
    pin = tk.pack_collapsed_host(size, now, cap, uniq.astype(np.int32), counts.astype(np.int64),
                                 fields, seg, pos)
    tk.check_collapsed(pin)
    return pin, uniq


@pytest.mark.parametrize(
    "case", ["one_key", "hot_keys", "foreign_clears", "mostly_padding", "wide_hot_keys"])
def test_collapsed_step_kernel_layouts(cuda, case):
    """K3, with hot segments published to the blocks that hold their
    lanes, against clear + `collapsed_step_reference`, in pout and all 12
    columns: one key over all 8192 lanes; six hot keys of 300-2000 lanes
    among 500 others; clears of in-range slots that are no segment's,
    below, between and above the segments (written by the blocks whose
    slot range holds them) beside segment slots; a chunk of 8192 lanes of
    which 40 segments are real and the rest padding; a chunk of 2^18
    lanes (4096 blocks, more than the card holds at once) with twelve hot
    keys of 2000-18000 lanes among 20000 others, so that blocks wait on
    owners that may have finished long before, or started just before."""
    rng = np.random.default_rng({"one_key": 1, "hot_keys": 6, "foreign_clears": 2,
                                 "mostly_padding": 3, "wide_hot_keys": 8}[case])
    cap, now = 1 << 16, 1_760_000_000_000
    words = _state_words(rng, cap, now)
    kern, plain = tk.state_from_numpy(words, cuda), tk.state_from_numpy(words, cuda)
    fs.reset_launches()
    calls = 6
    for call in range(calls):
        now += int(rng.integers(0, 3_000))
        size = None
        if case == "one_key":
            lanes = np.full(8192, int(rng.integers(0, cap)))
        elif case == "hot_keys":
            keys = rng.choice(cap, 506, replace=False)
            lanes = np.sort(np.concatenate([np.repeat(keys[:6], rng.integers(300, 2000, 6)),
                                            keys[6:]]))
        elif case == "wide_hot_keys":
            keys = rng.choice(cap, 20_012, replace=False)
            lanes = np.sort(np.concatenate(
                [np.repeat(keys[:12], rng.integers(2000, 18_000, 12)), keys[12:]]))
            size = 1 << 18
        elif case == "foreign_clears":
            lanes = np.sort(rng.integers(cap // 4, 3 * cap // 4, 3000))
        else:
            lanes = np.repeat(np.sort(rng.choice(cap, 40, replace=False)), rng.integers(1, 9, 40))
            size = 8192
        pin, uniq = _collapsed_pin(rng, cap, now, lanes, size)
        others = np.setdiff1d(np.arange(cap), uniq)
        clears = np.concatenate([uniq[call % 3::3], rng.choice(others, 400, replace=False),
                                 [cap + 1, others[0], others[-1]]])
        rng.shuffle(clears)
        if call == calls - 1:
            clears = clears[:0]
        dclears = torch.from_numpy(clears.astype(np.int32)).to(cuda)
        dpin = torch.from_numpy(pin).to(cuda)
        got = collapsed_step(kern, dpin, dclears)
        tk.clear_occupied_reference(plain.meta, dclears)
        want = tk.collapsed_step_reference(plain, dpin)
        torch.cuda.synchronize()
        assert torch.equal(got, want), call
        for name, a, b in zip(tk.BucketState._fields, kern, plain):
            assert torch.equal(a, b), (call, name)
    assert fs.launches["collapsed_step"] == calls


_UNPUBLISHED_WAIT = """
import sys
import numpy as np
import torch
from gubernator_tpu_torch.ops import bucket_kernel as tk
from gubernator_tpu_torch.ops.collapsed_step import collapsed_step

cap, now = 1 << 10, 1_760_000_000_000
state = tk.make_state(cap, "cuda")
slots = np.arange(128, dtype=np.int32)
fields = [np.zeros(128, np.int64)] * 2 + [np.ones(128, np.int64), np.full(128, 10, np.int64),
          np.full(128, 60_000, np.int64), np.zeros(128, np.int64),
          np.full(128, 60_000, np.int64), np.full(128, now, np.int64)]
pin = tk.pack_collapsed_host(128, now, cap, slots, np.ones(128, np.int64), fields,
                             np.arange(128, dtype=np.int32), np.zeros(128, np.int32))
ok = collapsed_step(state, torch.from_numpy(pin).cuda(), torch.zeros(0, dtype=torch.int32,
                                                                      device="cuda"))
torch.cuda.synchronize()
# Lane 64 claims to be the 6th lane of lane 59's segment, which has one
# lane, so block 0 publishes nothing for the second block to wait on.
pin[17, 64], pin[18, 64] = 59, 5
try:
    bad = collapsed_step(state, torch.from_numpy(pin).cuda(),
                         torch.zeros(0, dtype=torch.int32, device="cuda"))
    bad.cpu()
except RuntimeError as e:  # torch's CUDA errors are RuntimeErrors
    print("raised:", type(e).__name__, e)
    sys.exit(0)
print("answered:", bad[:, 64:70].tolist())
sys.exit(1)
"""


def test_collapsed_step_unpublished_wait_fails_loudly(cuda):
    """A pin that breaks K3's layout so that a block waits for terms no
    block publishes: the wait gives up and traps, so the caller gets an
    error at the next synchronisation and never an answer from an earlier
    launch's terms.  In a child process, since the trap ends its CUDA
    context."""
    root = Path(__file__).resolve().parent.parent
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(root), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run([sys.executable, "-c", _UNPUBLISHED_WAIT], capture_output=True,
                          text=True, timeout=300, env=env, cwd=root)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.startswith("raised:"), proc.stdout


@pytest.mark.parametrize("n_rounds", [1, 3])
def test_multi_uniform_step_kernel_bit_equal_to_plain(cuda, n_rounds):
    """K4 against `multi_uniform_step_reference`: ragged uniform rounds,
    each with its own config, clears in even rounds."""
    rng = np.random.default_rng(80 + n_rounds)
    cap, now = 1 << 16, 1_760_000_000_000
    words = _state_words(rng, cap, now)
    kern, plain = tk.state_from_numpy(words, cuda), tk.state_from_numpy(words, cuda)
    fs.reset_launches()
    for call in range(6):
        now += int(rng.integers(0, 3_000))
        parts = []
        for r in range(n_rounds):
            m = int(rng.integers(1, 1200))
            slots = np.sort(np.append(rng.choice(np.arange(1, cap), m - 1, replace=False), 0))
            cfg = (int(rng.integers(0, 2)), 0, int(rng.integers(-2, 6)),
                   int(rng.integers(0, 60)), int(rng.integers(1, 90_000)),
                   int(rng.integers(0, 70)))
            clears = [] if r % 2 else [int(x) for x in slots[::7]][:40] + [cap + r]
            parts.append(tk.pack_uniform_rounds_host(now + r, cap, [m], slots.astype(np.int32),
                                                     cfg, [clears]))
        pin = np.concatenate([p.pin for p in parts], axis=1)
        widths = [p.pin.shape[1] for p in parts]
        round_off = np.concatenate([[0], np.cumsum(widths)]).astype(np.int32)
        n_clear = [int(p.clear_off[-1]) for p in parts]
        clear_off = np.concatenate([[0], np.cumsum(n_clear)]).astype(np.int32)
        cs = np.concatenate([p.clear_slots[:k] for p, k in zip(parts, n_clear)] + [[cap]])
        args = [torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(cuda)
                for a in (pin, round_off, clear_off, cs)]
        got = fs.multi_uniform_step(kern, *args, widest=max(widths))
        want = tk.multi_uniform_step_reference(plain, *args)
        torch.cuda.synchronize()
        assert torch.equal(got, want), call
        for name, a, b in zip(tk.BucketState._fields, kern, plain):
            assert torch.equal(a, b), (call, name)
    assert fs.launches["uniform_step"] == 6


def _uniform_launch(rng, cap, now, round_slots, round_clears, dev):
    """One K4 launch of the given rounds (each its own sorted slots, config
    and clears) as device tensors, and the widest round's lanes."""
    parts = []
    for r, (slots, clears) in enumerate(zip(round_slots, round_clears)):
        cfg = (int(rng.integers(0, 2)), 0, int(rng.integers(-2, 6)), int(rng.integers(0, 60)),
               int(rng.integers(1, 90_000)), int(rng.integers(0, 70)))
        parts.append(tk.pack_uniform_rounds_host(now + r, cap, [len(slots)],
                                                 np.asarray(slots, np.int32), cfg,
                                                 [[int(c) for c in clears]]))
    pin = np.concatenate([p.pin for p in parts], axis=1)
    widths = [p.pin.shape[1] for p in parts]
    round_off = np.concatenate([[0], np.cumsum(widths)])
    n_clear = [int(p.clear_off[-1]) for p in parts]
    clear_off = np.concatenate([[0], np.cumsum(n_clear)])
    cs = np.concatenate([p.clear_slots[:k] for p, k in zip(parts, n_clear)] + [[cap]])
    args = [torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(dev)
            for a in (pin, round_off, clear_off, cs)]
    return args, max(widths)


@pytest.mark.parametrize("case", ["sixteen_rounds", "skewed_round", "moving_slot"])
def test_multi_uniform_step_kernel_slot_ranges(cuda, case):
    """K4 against `multi_uniform_step_reference`, in
    pout and all 12 columns.  sixteen_rounds: MAX_GROUP (16) rounds of up
    to 1200 lanes, slot 0 and slot cap - 1 in every round, clears in every
    round (lane slots, in-range slots of no lane, out of range).
    skewed_round: a 1024-lane round whose slots leave a gap of 1500, then
    a 1500-lane round inside the gap -- all of it in one block's slot
    range -- then the first round's slots again, clears in each.
    moving_slot: one slot in 16 rounds at lane 0-60 of its block's range,
    so a different thread (and warp) updates it each round: without the
    barrier between rounds a round would gather before the last one's
    store."""
    rng = np.random.default_rng({"sixteen_rounds": 4, "skewed_round": 5, "moving_slot": 7}[case])
    cap, now = 1 << 16, 1_760_000_000_000
    words = _state_words(rng, cap, now)
    kern, plain = tk.state_from_numpy(words, cuda), tk.state_from_numpy(words, cuda)
    fs.reset_launches()
    calls = 4
    for call in range(calls):
        now += int(rng.integers(0, 3_000))
        if case == "sixteen_rounds":
            rounds = []
            for _ in range(16):
                m = int(rng.integers(2, 1200))
                inner = rng.choice(np.arange(1, cap - 1), m - 2, replace=False)
                rounds.append(np.sort(np.concatenate([[0, cap - 1], inner])))
        elif case == "skewed_round":
            gap = int(rng.integers(1, cap - 3000))
            outside = np.concatenate([np.arange(0, gap), np.arange(gap + 1500, cap)])
            wide = np.sort(rng.choice(outside, 1024, replace=False))
            rounds = [wide, np.arange(gap, gap + 1500), wide]
        else:  # hot slot 1000: 5 slots below it in the widest round, 37r % 61 after
            far = np.arange(20_000, cap)
            rounds = [np.sort(np.concatenate([rng.choice(1000, 5, replace=False), [1000],
                                              rng.choice(far, 1094, replace=False)]))]
            for r in range(1, 16):
                below = rng.choice(1000, 37 * r % 61, replace=False)
                rounds.append(np.sort(np.concatenate(
                    [below, [1000], rng.choice(far, 999 - len(below), replace=False)])))
        clears = []
        for slots in rounds:
            none = rng.integers(0, cap, 20)
            none = none[~np.isin(none, slots)]
            clears.append(np.concatenate([slots[::9], none, [cap + 3]]))
        args, widest = _uniform_launch(rng, cap, now, rounds, clears, cuda)
        got = fs.multi_uniform_step(kern, *args, widest=widest)
        want = tk.multi_uniform_step_reference(plain, *args)
        torch.cuda.synchronize()
        assert torch.equal(got, want), call
        for name, a, b in zip(tk.BucketState._fields, kern, plain):
            assert torch.equal(a, b), (call, name)
    assert fs.launches["uniform_step"] == calls


def test_engine_async_pipeline_on_the_card(cuda):
    """`want_async` batches through the pump on the card (two uniform,
    two general, ...: each queued run of one format joins one launch)
    answer as synchronous batches on the CPU."""
    rng = np.random.default_rng(12)
    ns = 1_760_000_000_000 * 1_000_000
    gpu = DecisionEngine(4096, clock=Clock().freeze_at(ns), device=cuda)
    cpu = DecisionEngine(4096, clock=Clock().freeze_at(ns), device="cpu")
    fs.reset_launches()
    pend, want = [], []
    for b in range(12):
        n = 400
        general = b // 2 % 2
        if general:  # repeats with different configs: rounds (K1)
            keys = [b"a%d" % i for i in rng.integers(0, 3000, n)]
        else:  # distinct keys, one config: the uniform format (K4)
            keys = [b"a%d" % i for i in rng.choice(3000, n, replace=False)]
        cols = [np.zeros(n, np.int32), np.zeros(n, np.int32), np.ones(n, np.int64),
                np.full(n, 50, np.int64), np.full(n, 60_000, np.int64), np.zeros(n, np.int64)]
        if general:
            cols[3] = rng.integers(1, 50, n)
        pend.append(gpu.apply_columnar(keys, *cols, want_async=True))
        want.append(cpu.apply_columnar(keys, *cols))
    for p, w in zip(pend, want):
        for g, x in zip(p.get(), w):
            assert np.array_equal(g, x)
    got, exp = tk.state_to_numpy(gpu.state), tk.state_to_numpy(cpu.state)
    for f in tk.BucketState._fields:
        assert np.array_equal(got[f], exp[f]), f
    assert fs.launches["uniform_step"] > 0 and gpu._pump.flushes < gpu._pump.submitted


def _restore_record(rng, cap, n, size, now):
    """A restore buffer of n sorted unique slots and size - n padding
    lanes, with extreme values: negative and > 2^43 timestamps, leaky
    fraction words >= 2^31, limit and burst >= 2^32, odd algo / status."""
    rec = {k: np.zeros(size, np.int64) for k in tk.RESTORE_FIELDS}
    rec["slot"] = np.arange(cap, cap + size, dtype=np.int64)
    rec["slot"][:n] = np.sort(rng.choice(cap, n, replace=False))
    big = [2**32, 2**40 + 5, 2**62, -(2**35), -7, 0, 10]
    ts = [-5, 0, 2**43 - 1, 2**43, 2**50, now, now + 60_000]
    rec["algo"][:n] = rng.choice([0, 1, 2, -1], n)
    rec["status"][:n] = rng.choice([0, 1, 3, -2], n)
    for k in ("limit", "burst", "remaining"):
        rec[k][:n] = rng.choice(big, n)
    rec["remf_hi"][:n] = rng.integers(-(2**31), 2**31, n)
    rec["remf_lo"][:n] = rng.integers(0, 2**32, n)
    for k in ("t0", "expire_at", "invalid_at", "duration"):
        rec[k][:n] = rng.choice(ts, n) + rng.integers(0, 3, n)
    rec = {k: v.astype(np.int32) if k in ("slot", "algo", "status", "remf_hi") else v
           for k, v in rec.items()}
    rec["remf_lo"] = rec["remf_lo"].astype(np.uint32)
    return tk.pack_restore_host(rec)


@pytest.mark.parametrize("n,size", [(0, 16), (16, 16), (100, 128), (4000, 4096), (4096, 4096)])
def test_load_slots_kernel_bit_equal_to_plain(cuda, n, size):
    """K5 against `load_slots_reference`: every state word bit-equal."""
    rng = np.random.default_rng(n + size)
    cap, now = 1 << 16, 1_760_000_000_000
    words = _state_words(rng, cap, now)
    kern, plain = tk.state_from_numpy(words, cuda), tk.state_from_numpy(words, cuda)
    rec = torch.from_numpy(_restore_record(rng, cap, n, size, now)).to(cuda)
    fs.reset_launches()
    fs.load_slots(kern, rec)
    tk.load_slots_reference(plain, rec)
    torch.cuda.synchronize()
    for name, a, b in zip(tk.BucketState._fields, kern, plain):
        assert torch.equal(a, b), name
    assert fs.launches["load_slots"] == 1


def _sweep_state(rng, cap, now):
    exp = now + rng.choice([-1, 0, 1, -(2**31), 2**31 - 3, -5_000, 5_000], cap)
    words = _state_words(rng, cap, now)
    words["hi2"] = ((exp >> 32) | (words["hi2"] & ~0x7FF)).astype(np.int32)
    words["expire_lo"] = (exp & 0xFFFFFFFF).astype(np.uint32)
    return words


@pytest.mark.parametrize("cap,start,window", [(1 << 17, 0, 1 << 17), (300_000, 300_000 - 131_072,
                                               131_072), (5000, 1234, 777), (1 << 12, 0, 1 << 12)])
def test_sweep_window_kernel_bit_equal_to_plain(cuda, cap, start, window):
    """K6 against `sweep_window_reference`: count, freed indices (ascending)
    and meta bit-equal, with expiries at now - 1, now and now + 1 whose
    low words have bit 31 set."""
    from gubernator_tpu_torch.ops import expiry

    rng = np.random.default_rng(cap + window)
    now = 1_760_000_000_123 | (1 << 31)
    words = _sweep_state(rng, cap, now)
    kern, plain = tk.state_from_numpy(words, cuda), tk.state_from_numpy(words, cuda)
    fs.reset_launches()
    got = expiry.sweep_window(kern.meta, kern.hi2, kern.expire_lo, now, start, window)
    want = expiry.sweep_window_reference(plain.meta, plain.hi2, plain.expire_lo, now, start,
                                         window)
    torch.cuda.synchronize()
    c = int(want[0])
    assert c > 0 and int(got[0]) == c
    assert torch.equal(got[1 : 1 + c], want[1 : 1 + c])
    assert torch.equal(kern.meta, plain.meta)
    assert fs.launches["sweep_window"] == 1
    # a second pass frees nothing
    again = expiry.sweep_window(kern.meta, kern.hi2, kern.expire_lo, now, start, window)
    assert int(again[0]) == 0


def test_store_load_and_sweep_on_the_card_match_the_cpu(cuda, tmp_path):
    """The persistence path on the card against the CPU engine: a store
    with evictions (clears and restores in later rounds: K2, K5, K1), a
    checkpoint saved and loaded, and a sweep (K6) followed by new keys."""
    from gubernator_tpu_torch.checkpoint import NpzFileLoader
    from gubernator_tpu_torch.store import MemoryStore
    from gubernator_tpu_torch.types import RateLimitReq

    rng = np.random.default_rng(9)
    ns = 1_760_000_000_000 * 1_000_000
    gpu = DecisionEngine(64, clock=Clock().freeze_at(ns), device=cuda, store=MemoryStore())
    cpu = DecisionEngine(64, clock=Clock().freeze_at(ns), device="cpu", store=MemoryStore())
    fs.reset_launches()

    def batch(n, pool):
        return [RateLimitReq(name="p", unique_key=f"u{int(rng.integers(pool))}",
                             hits=int(rng.choice([0, 1, 2])), limit=int(rng.choice([5, 50])),
                             duration=int(rng.choice([500, 60_000])),
                             algorithm=int(rng.integers(0, 2)), burst=int(rng.choice([0, 9])))
                for _ in range(n)]

    def same(a, b):
        assert [(r.status, r.remaining, r.reset_time, r.error) for r in a] == [
            (r.status, r.remaining, r.reset_time, r.error) for r in b]

    for _ in range(30):
        reqs = batch(int(rng.integers(10, 90)), 200)
        same(gpu.get_rate_limits(reqs), cpu.get_rate_limits(reqs))
        dt = int(rng.integers(0, 400))
        for e in (gpu, cpu):
            e.clock.advance(ms=dt)
    assert {k: vars(v) for k, v in gpu.store.data.items()} == {
        k: vars(v) for k, v in cpu.store.data.items()}
    path = str(tmp_path / "c.npz")
    gpu.save(NpzFileLoader(path))
    fresh = DecisionEngine(64, clock=Clock().freeze_at(ns), device=cuda)
    fresh.clock.advance(ms=gpu.clock.now_ms() - fresh.clock.now_ms())
    assert fresh.load(NpzFileLoader(path)) == len(gpu.table)
    assert gpu.sweep() == cpu.sweep() > 0
    reqs = batch(40, 400)
    same(gpu.get_rate_limits(reqs), cpu.get_rate_limits(reqs))
    got, want = tk.state_to_numpy(gpu.state), tk.state_to_numpy(cpu.state)
    for f in tk.BucketState._fields:
        assert np.array_equal(got[f], want[f]), f
    for name in ("fused_step", "clear_occupied", "load_slots", "sweep_window"):
        assert fs.launches[name] > 0, name
    assert fs.launches["collapsed_step"] == fs.launches["uniform_step"] == 0


def _sketch_batch(rng, depth, width, n, now, layout):
    """A packed sketch pin of n keys drawn from zipf(1.2) over 10^8 names
    (hits from -7 to 5), edited per layout: "hot" puts a key with 4 x 2^30
    hits first (saturation), "padding" spreads 5 keys over 8192 lanes."""
    from gubernator_tpu_torch import hashing
    from gubernator_tpu_torch.ops import sketch as ps

    if layout == "padding":
        n = 5
    ids = (rng.zipf(1.2, n) - 1) % 100_000_000
    keys = [b"api_%d" % i for i in ids.tolist()]
    hits = rng.choice([-7, -1, 0, 1, 1, 2, 5], n).astype(np.int64)
    if layout == "hot":
        keys[:4] = [b"api_hot"] * 4
        hits[:4] = 2**30
    rows = ps.row_indexes(hashing.fnv1a_64_batch(*hashing.pack_keys(keys)), depth, width)
    pin = ps.pack_pin(rows, hits, now, 1000, width)
    if layout == "padding":
        pad = np.zeros((pin.shape[0], 8192), np.int32)
        pad[:, : pin.shape[1]] = pin
        pad[2::3, pin.shape[1]:] = np.arange(width + pin.shape[1], width + 8192)
        pin = pad
    return pin


@pytest.mark.parametrize("width,n", [(1 << 12, 1000), (1 << 20, 1000), (1 << 20, 8192)])
def test_sketch_step_kernel_bit_equal_to_plain(cuda, width, n):
    """K7 against `sketch_step_reference` on the card, planes and output
    word for word: zipf batches over planes of random counts (negative
    ones included, read at frac != 0: the floor division), a hot key of
    4 x 2^30 hits on cells near 2^31 - 1, and an all-padding tail."""
    from gubernator_tpu_torch.ops import sketch as ps

    rng = np.random.default_rng(width + n)
    depth = 4
    planes = rng.integers(-(2**31), 2**31, (2, depth, width)).astype(np.int32)
    planes[:, :, ::5] = 2**31 - 9
    kern = torch.from_numpy(planes).to(cuda)
    plain = kern.clone()
    fs.reset_launches()
    steps = 0
    for layout in ("zipf", "hot", "padding", "zipf"):
        for now in (41_250, 7_300, 9_999):
            cur = int(rng.integers(0, 2))
            pin = torch.from_numpy(_sketch_batch(rng, depth, width, n, now, layout)).to(cuda)
            got = ps.sketch_step(kern, pin, cur)
            want = ps.sketch_step_reference(plain, pin, cur)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (layout, now)
            assert torch.equal(kern, plain), (layout, now)
            steps += 1
    assert fs.launches["sketch_step"] == steps


@pytest.mark.parametrize("depth,width", [(4, 1 << 20), (3, 1001)])
@pytest.mark.parametrize("cur,delta", [(0, 1), (1, 1), (0, 2), (1, 9), (0, 0)])
def test_sketch_rotate_kernel_bit_equal_to_plain(cuda, depth, width, cur, delta):
    """K8 against `rotate_reference`: one plane (a step) or both (a gap);
    width 1001 puts plane 1 off a 16-byte boundary."""
    from gubernator_tpu_torch.ops import sketch as ps

    rng = np.random.default_rng(depth * width + delta)
    kern = torch.from_numpy(rng.integers(-50, 50, (2, depth, width)).astype(np.int32)).to(cuda)
    plain = kern.clone()
    fs.reset_launches()
    got = ps.sketch_rotate(kern, cur, delta)
    want = ps.rotate_reference(plain, cur, delta)
    torch.cuda.synchronize()
    assert got == want
    assert torch.equal(kern, plain)
    assert fs.launches["sketch_rotate"] == (1 if delta > 0 else 0)


def test_sketch_items_on_the_card_match_the_cpu(cuda):
    """V1Instance on the card against the same on the CPU: SKETCH items
    (some with GLOBAL or MULTI_REGION), GLOBAL and plain items, with the
    clock inside a window, one window on and two or more on."""
    from gubernator_tpu_torch.ops import sketch as ps
    from gubernator_tpu_torch.service import V1Instance
    from gubernator_tpu_torch.types import RateLimitReq

    rng = np.random.default_rng(12)
    ns = 1_760_000_000_000 * 1_000_000
    conf = dict(sketch_window_ms=1_000, sketch_depth=4, sketch_width=1 << 16)
    gpu = V1Instance(DecisionEngine(4096, clock=Clock().freeze_at(ns), device=cuda), **conf)
    cpu = V1Instance(DecisionEngine(4096, clock=Clock().freeze_at(ns), device="cpu"), **conf)
    fs.reset_launches()
    for step in (0, 300, 1_000, 200, 2_500, 10, 999):
        for inst in (gpu, cpu):
            inst.engine.clock.advance(ms=step)
        reqs = [RateLimitReq(name="api", unique_key=f"u{int(rng.integers(300))}",
                             hits=int(rng.choice([-2, 0, 1, 3])), limit=int(rng.choice([5, 50])),
                             duration=60_000,
                             behavior=int(rng.choice([0, 2, 32, 32, 34, 48, 2 | 8])))
                for _ in range(200)]
        got, want = gpu.get_rate_limits(reqs), cpu.get_rate_limits(reqs)
        assert [vars(r) for r in got] == [vars(r) for r in want]
    a, b = ps.sketch_state_to_numpy(gpu.sketch().state), ps.sketch_state_to_numpy(cpu.sketch().state)
    assert np.array_equal(a[0], b[0]) and a[1:] == b[1:]
    assert fs.launches["sketch_step"] == 7 and fs.launches["sketch_rotate"] > 0
    gpu.close()
    cpu.close()


def test_h2_front_on_the_card_matches_the_cpu(cuda):
    """The h2 parity stream (chip_smoke.py `h2_stream`: 1000-item RPCs,
    hot keys, token and leaky, RESET_REMAINING, clock steps, and GLOBAL,
    Gregorian, SKETCH, empty-key and zero-item RPCs) through an
    H2FastFront on a card engine and one on a CPU engine: grpc-status and
    response bytes equal RPC by RPC, state words equal, and every engine
    launch a K1, K3 or K4 launch.  Both instances run the decision ledger
    (the default) with no settle thread, and settle by hand before the
    state words are compared: a thread would return idle leases' credit
    at different moments on the two sides."""
    import sys

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import chip_smoke as cs

    from gubernator_tpu_torch.net.h2_fast import H2FastFront
    from gubernator_tpu_torch.service import V1Instance

    rng = np.random.default_rng(7)
    ns = 1_760_000_000_000 * 1_000_000
    gpu = V1Instance(DecisionEngine(1 << 16, clock=Clock().freeze_at(ns), device=cuda),
                     ledger_opts=dict(settle_interval=0))
    cpu = V1Instance(DecisionEngine(1 << 16, clock=Clock().freeze_at(ns), device="cpu"),
                     ledger_opts=dict(settle_interval=0))
    fronts = [H2FastFront(gpu, window_s=0.001), H2FastFront(cpu, window_s=0.001)]
    clients = [cs.H2Unary(f.address) for f in fronts]
    fs.reset_launches()
    try:
        for body, step, status, n_items in cs.h2_stream(np, rng, n_rpcs=12):
            for inst in (gpu, cpu):
                inst.engine.clock.advance(ms=step)
            got, want = clients[0].call(body), clients[1].call(body)
            assert got == want
            assert got[0] == status
            if status == 0:
                assert len(cs.decode_responses(got[1])) == n_items
        assert gpu.ledger.flush_settles() == cpu.ledger.flush_settles()
        got, exp = tk.state_to_numpy(gpu.engine.state), tk.state_to_numpy(cpu.engine.state)
        for f in tk.BucketState._fields:
            assert np.array_equal(got[f], exp[f]), f
        k = fs.launches
        assert (k["fused_step"] + k["collapsed_step"] + k["uniform_step"]
                == gpu.engine.dispatches_total > 0)
    finally:
        for c in clients:
            c.close()
        for f in fronts:
            f.close()
        gpu.close()
        cpu.close()


def test_h2_feeder_front_on_the_card_matches_the_cpu(cuda):
    """The h2 parity stream through an H2FastFront whose columnar feeder
    serves a card engine and one whose feeder serves a CPU engine, the
    ledger off so every in-scope RPC rides the feeder ring: grpc-status
    and response bytes equal RPC by RPC, the feeders' retry_after_ms
    hints included (every OVER_LIMIT item carries one, reset - now in the
    engine's clock), the byte window path taken by the out-of-scope and
    zero-item RPCs only, and state words equal."""
    import sys

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import chip_smoke as cs

    from gubernator_tpu_torch.net.h2_fast import H2FastFront
    from gubernator_tpu_torch.service import V1Instance

    rng = np.random.default_rng(11)
    ns = 1_760_000_000_000 * 1_000_000
    gpu = V1Instance(DecisionEngine(1 << 16, clock=Clock().freeze_at(ns), device=cuda),
                     ledger=False)
    cpu = V1Instance(DecisionEngine(1 << 16, clock=Clock().freeze_at(ns), device="cpu"),
                     ledger=False)
    fronts = [H2FastFront(gpu, window_s=0.001, native_feeder=True),
              H2FastFront(cpu, window_s=0.001, native_feeder=True)]
    clients = [cs.H2Unary(f.address) for f in fronts]
    fs.reset_launches()
    try:
        stream = cs.h2_stream(np, rng, n_rpcs=12)
        hinted = 0
        for body, step, status, n_items in stream:
            for inst in (gpu, cpu):
                inst.engine.clock.advance(ms=step)
            got, want = clients[0].call(body), clients[1].call(body)
            assert got == want
            assert got[0] == status
            if status == 0 and n_items:
                hinted += cs.retry_hints(got[1], gpu.engine.clock.now_ms())
        assert hinted > 0
        # The C side bumps the counters after the response is sent.
        st = [cs.settled_stats(f, len(stream)) for f in fronts]
        n_byte = sum(1 for _b, _s, status, n in stream if status or not n)
        for x in st:
            assert x["feeder_front_rpcs"] == len(stream) - n_byte
            assert x["windows"] == n_byte
        got, exp = tk.state_to_numpy(gpu.engine.state), tk.state_to_numpy(cpu.engine.state)
        for f in tk.BucketState._fields:
            assert np.array_equal(got[f], exp[f]), f
        k = fs.launches
        assert (k["fused_step"] + k["collapsed_step"] + k["uniform_step"]
                == gpu.engine.dispatches_total > 0)
    finally:
        for c in clients:
            c.close()
        for f in fronts:
            f.close()
        gpu.close()
        cpu.close()


def _page_state(rng, cap, dev):
    """Every bit pattern likely: bit 31 set in the `*_lo` columns."""
    return tk.BucketState(*(torch.from_numpy(
        rng.integers(-(2**31), 2**31, cap, dtype=np.int64).astype(np.int32)).to(dev)
        for _ in tk.BucketState._fields))


@pytest.mark.parametrize("page_size", [16, 64, 512])
@pytest.mark.parametrize("k", [1, 64])
def test_page_kernels_bit_equal_to_plain(cuda, page_size, k):
    """K9 (gather_pages) and K10 (load_pages) against their plain versions,
    starts at row 0 and at the last frame among them."""
    from gubernator_tpu_torch.ops.page_words import gather_pages, load_pages

    rng = np.random.default_rng(page_size + k)
    frames = 128
    cap = frames * page_size
    gpu = _page_state(rng, cap, cuda)
    cpu = tk.BucketState(*(c.cpu() for c in gpu))
    starts = np.sort(rng.choice(frames, k, replace=False)) * page_size
    starts[0], starts[-1] = 0, cap - page_size
    st = torch.from_numpy(starts.astype(np.int32))
    fs.reset_launches()
    got = gather_pages(gpu, st.to(cuda), page_size)
    torch.cuda.synchronize()
    want = tk.gather_page_words_reference(cpu, st, page_size)
    assert torch.equal(got.cpu(), want)
    assert (want[:, 3] < 0).any()
    words = torch.from_numpy(rng.integers(-(2**31), 2**31, (len(starts), 12, page_size),
                                          dtype=np.int64).astype(np.int32))
    load_pages(gpu, st.to(cuda), words.to(cuda))
    torch.cuda.synchronize()
    tk.load_page_words_reference(cpu, st, words)
    for a, b in zip(gpu, cpu):
        assert torch.equal(a.cpu(), b)
    assert fs.launches["gather_pages"] == fs.launches["load_pages"] == 1


def test_page_kernels_reject_a_bad_launch(cuda):
    from gubernator_tpu_torch.ops.page_words import gather_pages, load_pages

    state = _page_state(np.random.default_rng(1), 256, cuda)
    st = torch.zeros(1, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        gather_pages(state, st, 18)  # not a multiple of 4
    with pytest.raises(ValueError):
        gather_pages(state, st.cpu(), 16)
    with pytest.raises(ValueError):
        load_pages(state, st, torch.zeros((2, 12, 16), dtype=torch.int32, device=cuda))


def test_paged_engine_on_the_card_matches_the_cpu(cuda, monkeypatch, tmp_path):
    """A paged engine on the card (K9 / K10 on every fault batch) against
    a paged CPU engine: answers, counters, page table, host store and
    device words; then a checkpoint load with no fault and a host sweep."""
    from gubernator_tpu_torch.checkpoint import NpzFileLoader

    monkeypatch.setenv("GUBER_PAGED", "1")
    monkeypatch.setenv("GUBER_PAGE_SIZE", "16")
    monkeypatch.setenv("GUBER_PAGED_RESIDENT", "8")
    rng = np.random.default_rng(13)
    ns = 1_760_000_000_000 * 1_000_000
    gpu = DecisionEngine(4096, clock=Clock().freeze_at(ns), device=cuda)
    cpu = DecisionEngine(4096, clock=Clock().freeze_at(ns), device="cpu")
    fs.reset_launches()
    for _ in range(40):
        n = int(rng.integers(1, 120))
        keys = [b"pg_%d" % int(k) for k in rng.integers(0, 1500, n)]
        cols = (rng.integers(0, 2, n).astype(np.int32), np.zeros(n, np.int32),
                rng.integers(0, 3, n).astype(np.int64), np.full(n, 20, np.int64),
                rng.choice([500, 60_000], n).astype(np.int64), np.zeros(n, np.int64))
        for a, b in zip(gpu.apply_columnar(keys, *cols), cpu.apply_columnar(keys, *cols)):
            assert np.array_equal(np.asarray(a), np.asarray(b))
        dt = int(rng.integers(0, 100))
        for e in (gpu, cpu):
            e.clock.advance(ms=dt)
    gp, cp = gpu.paging, cpu.paging
    assert gp.faults > 0 and (gp.faults, gp.spills, gp.refills) == (cp.faults, cp.spills,
                                                                     cp.refills)
    for name in ("frame_of", "page_of", "_ref", "_ever_used"):
        assert np.array_equal(getattr(gp, name), getattr(cp, name)), name
    assert np.array_equal(gp.host_words, cp.host_words)
    got, want = tk.state_to_numpy(gpu.state), tk.state_to_numpy(cpu.state)
    for f in tk.BucketState._fields:
        assert np.array_equal(got[f], want[f]), f
    assert fs.launches["gather_pages"] > 0 and fs.launches["load_pages"] == gp.fault_batches
    path = str(tmp_path / "paged.npz")
    gpu.save(NpzFileLoader(path))
    fresh = DecisionEngine(4096, clock=Clock().freeze_at(gpu.clock.now_ms() * 10**6),
                           device=cuda)
    assert fresh.load(NpzFileLoader(path)) == len(gpu.table)
    assert fresh.paging.faults == 0
    for e in (gpu, cpu):
        e.clock.advance(ms=120_000)
    faults = gp.faults
    assert gpu.sweep() == cpu.sweep() > 0
    assert gp.faults == faults


# ---------------------------------------------------------------------------
# K11, K12 and K13: the sharded engine's per-shard steps and sweep.


def _shard_rows(rng, n_sh, cap, lane_slots):
    """Per-shard clears (some lane slots, some other slots, one shard with
    none) as K11 / K12 take them."""
    from gubernator_tpu_torch.ops.sharded_step import shard_clear_rows

    clears = []
    for sh in range(n_sh):
        own = list(rng.choice(lane_slots[sh], min(4, len(lane_slots[sh])), replace=False)) \
            if len(lane_slots[sh]) else []
        other = [int(s) for s in rng.choice(cap, 6, replace=False)]
        clears.append([] if sh == 1 else sorted({int(s) for s in own} | set(other)))
    return shard_clear_rows(clears, cap)


@pytest.mark.parametrize("n_sh", [1, 4, 8])
def test_shard_step_kernel_bit_equal_to_plain(cuda, n_sh):
    """K11 against the shards' clears + `sharded_fused_step_reference`: a
    full shard, padded shards (their `shard_cap + lane` padding would be
    the next shard's first slots if it were global) and an empty one,
    clears of lane slots and of other slots; pout and all 12 columns."""
    from gubernator_tpu_torch.ops.sharded_step import shard_step

    rng = np.random.default_rng(110 + n_sh)
    cap, width, now = 256, 128, 1_760_000_000_000
    words = _state_words(rng, n_sh * cap, now)
    kern, plain = tk.state_from_numpy(words, cuda), tk.state_from_numpy(words, cuda)
    fs.reset_launches()
    for it in range(6):
        now += int(rng.integers(0, 300))
        pins, lane_slots = [], []
        for sh in range(n_sh):
            m = width if sh == 0 else (0 if sh == 2 else int(rng.integers(1, width)))
            slots = np.sort(rng.choice(cap, m, replace=False)).astype(np.int32)
            lane_slots.append(slots)
            pins.append(tk.pack_batch_host(width, now, cap, slots, *_rand_cols(rng, m, now)))
        pin = torch.from_numpy(np.stack(pins)).to(cuda)
        rows = torch.from_numpy(_shard_rows(rng, n_sh, cap, lane_slots)).to(cuda)
        if it % 3 == 2:
            rows = rows[:, :0]
        got = shard_step(kern, pin, cap, rows)
        tk.shard_clears_reference(plain, rows, cap)
        want = tk.sharded_fused_step_reference(plain, pin, cap)
        torch.cuda.synchronize()
        assert torch.equal(got, want), it
        for name, a, b in zip(tk.BucketState._fields, kern, plain):
            assert torch.equal(a, b), (it, name)
    assert fs.launches["shard_step"] == 6


@pytest.mark.parametrize("n_sh", [1, 4, 8])
def test_shard_collapsed_kernel_bit_equal_to_plain(cuda, n_sh):
    """K12 against the shards' clears + `sharded_collapsed_step_reference`:
    each shard its own chunk, a hot key whose segment spans several tiles
    in some shards (each shard's publication chain), short segments,
    padding shards; clears of segment slots and of other slots."""
    from gubernator_tpu_torch.ops.sharded_step import shard_collapsed_step

    rng = np.random.default_rng(120 + n_sh)
    cap, now = 1 << 12, 1_760_000_000_000
    words = _state_words(rng, n_sh * cap, now)
    kern, plain = tk.state_from_numpy(words, cuda), tk.state_from_numpy(words, cuda)
    fs.reset_launches()
    for call in range(6):
        now += int(rng.integers(0, 3_000))
        width = int(rng.choice([64, 512, 1024]))
        pins, seg_slots = [], []
        for sh in range(n_sh):
            if sh == 2:
                lanes = np.zeros(0, np.int32)
            elif sh % 2 == 0:  # one hot key then spread ones
                hot = int(rng.integers(cap))
                spread = rng.choice(cap, width // 4, replace=True)
                lanes = np.concatenate([np.full(width // 2, hot), spread])[: width - 1]
            else:
                lanes = rng.choice(cap, int(rng.integers(1, width)), replace=True)
            if len(lanes):
                pin, uniq = _collapsed_pin(rng, cap, now, np.sort(lanes).astype(np.int32),
                                           size=width)
            else:
                empty = np.zeros(0, np.int64)
                pin = tk.pack_collapsed_host(width, now, cap, np.zeros(0, np.int32), empty,
                                             (empty,) * 8, np.zeros(0, np.int32),
                                             np.zeros(0, np.int32))
                uniq = np.zeros(0, np.int32)
            pins.append(pin)
            seg_slots.append(uniq)
        pin = torch.from_numpy(np.stack(pins)).to(cuda)
        rows = torch.from_numpy(_shard_rows(rng, n_sh, cap, seg_slots)).to(cuda)
        if call % 3 == 2:
            rows = rows[:, :0]
        got = shard_collapsed_step(kern, pin, cap, rows)
        tk.shard_clears_reference(plain, rows, cap)
        want = tk.sharded_collapsed_step_reference(plain, pin, cap)
        torch.cuda.synchronize()
        assert torch.equal(got, want), call
        for name, a, b in zip(tk.BucketState._fields, kern, plain):
            assert torch.equal(a, b), (call, name)
    assert fs.launches["shard_collapsed"] == 6


@pytest.mark.parametrize("n_sh,cap,start,window", [(1, 1 << 17, 0, 1 << 17),
                                                   (4, 300_000, 300_000 - 131_072, 131_072),
                                                   (8, 5000, 1234, 777)])
def test_shard_sweep_kernel_bit_equal_to_plain(cuda, n_sh, cap, start, window):
    """K13 against `shard_sweep_window_reference`: each shard's count,
    freed indices (ascending) and meta words bit-equal, expiries at now -
    1, now and now + 1 with bit 31 of the low word set."""
    from gubernator_tpu_torch.ops import expiry

    rng = np.random.default_rng(n_sh + cap)
    now = 1_760_000_000_123 | (1 << 31)
    words = _sweep_state(rng, n_sh * cap, now)
    kern, plain = tk.state_from_numpy(words, cuda), tk.state_from_numpy(words, cuda)
    fs.reset_launches()
    got = expiry.shard_sweep_window(kern.meta, kern.hi2, kern.expire_lo, n_sh, now, start,
                                    window)
    want = expiry.shard_sweep_window_reference(plain.meta, plain.hi2, plain.expire_lo, n_sh,
                                               now, start, window)
    torch.cuda.synchronize()
    assert got.shape == (n_sh, window + 1)
    for sh in range(n_sh):
        c = int(want[sh, 0])
        assert c > 0 and int(got[sh, 0]) == c, sh
        assert torch.equal(got[sh, 1 : 1 + c], want[sh, 1 : 1 + c]), sh
    assert torch.equal(kern.meta, plain.meta)
    assert fs.launches["shard_sweep"] == 1
    again = expiry.shard_sweep_window(kern.meta, kern.hi2, kern.expire_lo, n_sh, now, start,
                                      window)
    assert int(again[:, 0].sum()) == 0


# Groups of windows (cap, window, [(instant offset, starts)]), as
# tests/test_torch_sweep_groups.py holds them to the JAX loop: a clamped
# tail inside a group, a tail that opens its group after an earlier tick,
# a cursor wrap, caps below two windows, a repeated window, more than 16
# windows (two launches), unaligned starts and strides (cap 5001, starts
# not multiples of 4), one slot, and a window below one tile.
_LATER = 1 << 31
_GROUPS = {
    "tail inside": (5000, 1024, [(0, [0, 1024, 2048, 3072, 3976])]),
    "tail after a tick": (5000, 1024, [(0, [0, 1024, 2048, 3072]), (_LATER, [3976, 0, 1024])]),
    "cursor wrap": (5000, 1024, [(0, [3072, 3976, 0, 1024, 2048])]),
    "cap 300, window 256": (300, 256, [(0, [0, 44]), (_LATER, [44, 0])]),
    "cap 1000, window 256": (1000, 256, [(0, [0, 256, 512, 744]), (_LATER, [744, 0, 256])]),
    "a window repeated": (1000, 256, [(0, [512, 744, 512, 600])]),
    "more than 16 windows": (4000, 128, [(0, [i * 128 for i in range(20)] + [3872, 0, 64])]),
    "unaligned": (5001, 1999, [(0, [0, 1999, 3002, 1, 7]), (_LATER, [3001, 2, 5])]),
    "one slot": (4097, 1, [(0, [0, 4096, 3, 3]), (_LATER, [4095, 1, 2])]),
    "below one tile": (4097, 100, [(0, [0, 100, 3997, 3, 3990]), (_LATER, [3995, 0])]),
}


def _group_state(rng, rows, now, fill="mixed"):
    words = _sweep_state(rng, rows, now)
    if fill != "mixed":
        exp = now + (-1 if fill == "all" else 1) * rng.integers(1, 2**31, rows)
        words["hi2"] = ((exp >> 32) | (words["hi2"] & ~0x7FF)).astype(np.int32)
        words["expire_lo"] = (exp & 0xFFFFFFFF).astype(np.uint32)
        words["meta"] = words["meta"] | 1
    return words


def _same_group(got, want):
    """Counts and the freed prefix of every row equal."""
    assert got.shape == want.shape
    counts = want[:, :, 0]
    assert torch.equal(got[:, :, 0], counts)
    for g, sh in zip(*torch.nonzero(counts, as_tuple=True)):
        c = int(counts[g, sh])
        assert torch.equal(got[g, sh, 1 : 1 + c], want[g, sh, 1 : 1 + c]), (int(g), int(sh))
    return int(counts.sum())


@pytest.mark.parametrize("n_sh", [1, 4, 8])
@pytest.mark.parametrize("case", list(_GROUPS))
def test_sweep_windows_kernel_bit_equal_to_plain(cuda, case, n_sh):
    """The group kernel (K6, K13 with n_sh > 1) against
    `sweep_windows_reference`: counts, ascending freed indices and every
    meta word, call after call; one launch a call of up to 16 windows."""
    from gubernator_tpu_torch.ops import expiry

    cap, window, calls = _GROUPS[case]
    rng = np.random.default_rng(cap + window + n_sh)
    now = 1_760_000_000_123 | (1 << 31)
    words = _group_state(rng, n_sh * cap, now)
    kern, plain = tk.state_from_numpy(words, cuda), tk.state_from_numpy(words, cuda)
    fs.reset_launches()
    freed = 0
    for dt, starts in calls:
        got = expiry.sweep_windows(kern.meta, kern.hi2, kern.expire_lo, now + dt, starts,
                                   window, n_sh)
        want = expiry.sweep_windows_reference(plain.meta, plain.hi2, plain.expire_lo, now + dt,
                                              starts, window, n_sh)
        torch.cuda.synchronize()
        freed += _same_group(got, want)
        assert torch.equal(kern.meta, plain.meta)
    assert freed > 0
    name = "sweep_window" if n_sh == 1 else "shard_sweep"
    assert fs.launches[name] == sum(-(-len(st) // expiry.MAX_WINDOWS) for _, st in calls)


@pytest.mark.parametrize("quads", [1, 2, 4, 8])
@pytest.mark.parametrize("case", ["tail inside", "cursor wrap", "unaligned", "below one tile",
                                  "more than 16 windows"])
def test_sweep_windows_kernel_tile_sizes(cuda, case, quads):
    """Every tile size the wrapper may pick (1, 2, 4 or 8 quads a thread,
    512 to 4096 slots a tile) bit-equal to the plain version over 4
    shards, the launches planned as `sweep_windows` plans them."""
    from gubernator_tpu_torch.ops import expiry

    n_sh, (cap, window, calls) = 4, _GROUPS[case]
    rng = np.random.default_rng(quads + cap)
    now = 1_760_000_000_123 | (1 << 31)
    words = _group_state(rng, n_sh * cap, now)
    kern, plain = tk.state_from_numpy(words, cuda), tk.state_from_numpy(words, cuda)
    freed = 0
    for dt, starts in calls:
        got = torch.empty((len(starts), n_sh, window + 1), dtype=torch.int32, device=cuda)
        for first, owned in expiry.plan_launches(starts, window):
            expiry.launch_group(kern.meta, kern.hi2, kern.expire_lo, n_sh, now + dt,
                                starts[first : first + len(owned)], owned, window,
                                got[first : first + len(owned)], quads=quads)
        want = expiry.sweep_windows_reference(plain.meta, plain.hi2, plain.expire_lo, now + dt,
                                              starts, window, n_sh)
        torch.cuda.synchronize()
        freed += _same_group(got, want)
        assert torch.equal(kern.meta, plain.meta)
    assert freed > 0


@pytest.mark.parametrize("fill", ["all", "none"])
def test_sweep_windows_kernel_frees_every_slot_or_none(cuda, fill):
    from gubernator_tpu_torch.ops import expiry

    n_sh, (cap, window, calls) = 4, _GROUPS["tail inside"]
    words = _group_state(np.random.default_rng(5), n_sh * cap, 1_760_000_000_123, fill)
    kern, plain = tk.state_from_numpy(words, cuda), tk.state_from_numpy(words, cuda)
    starts = calls[0][1]
    got = expiry.sweep_windows(kern.meta, kern.hi2, kern.expire_lo, 1_760_000_000_123, starts,
                               window, n_sh)
    want = expiry.sweep_windows_reference(plain.meta, plain.hi2, plain.expire_lo,
                                          1_760_000_000_123, starts, window, n_sh)
    torch.cuda.synchronize()
    assert _same_group(got, want) == (n_sh * cap if fill == "all" else 0)
    assert torch.equal(kern.meta, plain.meta)


def test_sweep_kernel_whole_capacity_window(cuda):
    """One window of the whole capacity at 10^6 (1954 tiles in one row,
    the look-back's longest walk), and `sweep_expired` over it."""
    from gubernator_tpu_torch.ops import expiry

    cap, now = 10**6, 1_760_000_000_123 | (1 << 31)
    words = _group_state(np.random.default_rng(6), cap, now)
    kern, plain = tk.state_from_numpy(words, cuda), tk.state_from_numpy(words, cuda)
    got = expiry.sweep_windows(kern.meta, kern.hi2, kern.expire_lo, now, [0], cap)
    want = expiry.sweep_windows_reference(plain.meta, plain.hi2, plain.expire_lo, now, [0], cap)
    torch.cuda.synchronize()
    assert _same_group(got, want) > 0
    assert torch.equal(kern.meta, plain.meta)
    kern, plain = tk.state_from_numpy(words, cuda), tk.state_from_numpy(words, "cpu")
    mask = expiry.sweep_expired(kern.meta, kern.hi2, kern.expire_lo, now)
    want_mask = expiry.sweep_expired(plain.meta, plain.hi2, plain.expire_lo, now)
    assert torch.equal(mask.cpu(), want_mask)
    assert torch.equal(kern.meta.cpu(), plain.meta)


def test_sweep_kernel_2000_launches_on_one_buffer(cuda):
    """2000 launches in a row on the stream's one publish buffer, never
    zeroed: each launch's stamp is new, its tickets run on from the last,
    and every launch stays bit-equal to the plain version (the state is
    re-armed every 16 launches so that windows keep freeing)."""
    from gubernator_tpu_torch.ops import expiry

    cap, window, now = 8192, 1024, 1_760_000_000_123 | (1 << 31)
    rng = np.random.default_rng(2000)
    words = _group_state(rng, cap, now)
    kern, plain = tk.state_from_numpy(words, cuda), tk.state_from_numpy(words, cuda)
    got = expiry.sweep_windows(kern.meta, kern.hi2, kern.expire_lo, now, [0], window)
    _same_group(got, expiry.sweep_windows_reference(plain.meta, plain.hi2, plain.expire_lo, now,
                                                    [0], window))
    key = (torch.cuda.current_device(), torch.cuda.current_stream().cuda_stream)
    buf, tickets, stamps = expiry._publish[key]
    for i in range(2000):
        if i % 16 == 0:
            arm = torch.from_numpy((rng.random(cap) < 0.5).astype(np.int32)).to(cuda)
            kern.meta.bitwise_or_(arm)
            plain.meta.bitwise_or_(arm)
        starts = [int(s) for s in rng.integers(0, cap - window + 1, int(rng.integers(1, 4)))]
        got = expiry.sweep_windows(kern.meta, kern.hi2, kern.expire_lo, now, starts, window)
        want = expiry.sweep_windows_reference(plain.meta, plain.hi2, plain.expire_lo, now,
                                              starts, window)
        _same_group(got, want)
    torch.cuda.synchronize()
    assert torch.equal(kern.meta, plain.meta)
    entry = expiry._publish[key]
    assert entry[0] is buf and entry[2] == stamps + 2000 and entry[1] > tickets


def test_sweep_kernel_on_two_streams(cuda):
    """Launches on two streams at once, each with its own publish buffer,
    over two states: both bit-equal to the plain version."""
    from gubernator_tpu_torch.ops import expiry

    cap, window, now = 1 << 16, 1 << 12, 1_760_000_000_123 | (1 << 31)
    rng = np.random.default_rng(22)
    pairs = []
    for _ in range(2):
        words = _group_state(rng, cap, now)
        pairs.append((tk.state_from_numpy(words, cuda), tk.state_from_numpy(words, cuda)))
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    torch.cuda.synchronize()
    outs = [[], []]
    for rep in range(8):
        for k, (st, (kern, _)) in enumerate(zip(streams, pairs)):
            with torch.cuda.stream(st):
                starts = [(rep * 2 + j) * window % cap for j in range(2)]
                outs[k].append((starts, expiry.sweep_windows(kern.meta, kern.hi2,
                                                             kern.expire_lo, now + rep, starts,
                                                             window)))
    torch.cuda.synchronize()
    for k, (_, plain) in enumerate(pairs):
        for rep, (starts, got) in enumerate(outs[k]):
            want = expiry.sweep_windows_reference(plain.meta, plain.hi2, plain.expire_lo,
                                                  now + rep, starts, window)
            _same_group(got, want)
        assert torch.equal(pairs[k][0].meta, plain.meta), k
    keys = {(torch.cuda.current_device(), s.cuda_stream) for s in streams}
    assert keys <= set(expiry._publish)


_SILENT_TILE = """
import sys
import numpy as np
import torch
from gubernator_tpu_torch.ops import bucket_kernel as tk
from gubernator_tpu_torch.ops import expiry

cap, now = 1 << 14, 1_760_000_000_123
state = tk.make_state(cap, "cuda")
state.meta.fill_(1)
window = 4096  # 8 tiles: tile 1 waits on tile 0
out = torch.empty((1, 1, window + 1), dtype=torch.int32, device="cuda")
expiry.launch_group(state.meta, state.hi2, state.expire_lo, 1, now, [0], [(0, window)], window,
                    out)
torch.cuda.synchronize()
try:
    expiry.launch_group(state.meta, state.hi2, state.expire_lo, 1, now, [0], [(0, window)],
                        window, out, silent_tile=0)
    out.cpu()
except RuntimeError as e:  # torch's CUDA errors are RuntimeErrors
    print("raised:", type(e).__name__, e)
    sys.exit(0)
print("answered:", out[0, 0, :4].tolist())
sys.exit(1)
"""


def test_sweep_kernel_unanswered_wait_fails_loudly(cuda):
    """A tile whose predecessor publishes nothing (`silent_tile`): its
    look-back gives up and traps, so the caller gets an error at the next
    synchronisation and never a prefix from an earlier launch.  In a child
    process, since the trap ends its CUDA context."""
    root = Path(__file__).resolve().parent.parent
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(root), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run([sys.executable, "-c", _SILENT_TILE], capture_output=True,
                          text=True, timeout=300, env=env, cwd=root)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.startswith("raised:"), proc.stdout


@pytest.mark.parametrize("n_sh", [1, 4, 8])
def test_sharded_engine_on_the_card_matches_the_cpu(cuda, n_sh, tmp_path):
    """The sharded engine on the card against the same on the CPU: a
    dataclass stream under eviction pressure with hot keys (K11, K12), a
    columnar stream with Gregorian items (the flat K1 / K3), a store
    engine (K2, K5, K11), a checkpoint and sweeps (K13); answers and every
    state word equal."""
    from gubernator_tpu_torch.checkpoint import NpzFileLoader
    from gubernator_tpu_torch.parallel.sharded_engine import ShardedDecisionEngine
    from gubernator_tpu_torch.store import MemoryStore
    from gubernator_tpu_torch.types import RateLimitReq

    rng = np.random.default_rng(130 + n_sh)
    ns = 1_760_000_000_000 * 1_000_000

    def pair(cap, **kw):
        kws = [dict(kw, store=MemoryStore()) if "store" in kw else kw for _ in range(2)]
        return (ShardedDecisionEngine(cap, n_shards=n_sh, clock=Clock().freeze_at(ns),
                                      device=cuda, **kws[0]),
                ShardedDecisionEngine(cap, n_shards=n_sh, clock=Clock().freeze_at(ns),
                                      device="cpu", **kws[1]))

    def batch(n, pool, hot=False):
        """Spread keys (Gregorian minutes on 1 in 10), or with `hot` only
        three hot keys, each with one config (the collapse, K12)."""
        out = []
        for _ in range(n):
            if hot:
                h = int(rng.integers(3))
                out.append(RateLimitReq(name="s", unique_key=f"h{h}", hits=1, limit=40 + h,
                                        duration=60_000, algorithm=h % 2, burst=40))
                continue
            greg = rng.random() < 0.1
            out.append(RateLimitReq(
                name="s", unique_key=f"u{int(rng.integers(pool))}",
                hits=int(rng.choice([0, 1, 2])), limit=int(rng.choice([5, 50])),
                duration=0 if greg else int(rng.choice([500, 60_000])), behavior=4 if greg else 0,
                algorithm=int(rng.integers(0, 2)), burst=int(rng.choice([0, 9]))))
        return out

    def same_words(a, b):
        x, y = tk.state_to_numpy(a.state), tk.state_to_numpy(b.state)
        for f in tk.BucketState._fields:
            assert np.array_equal(x[f], y[f]), f

    def advance(ms, *engines):
        for e in engines:
            e.clock.advance(ms=ms)

    fs.reset_launches()
    gpu, cpu = pair(32)
    for b in range(20):
        reqs = batch(int(rng.integers(10, 200)), 600, hot=b % 4 == 0)
        assert [(r.status, r.remaining, r.reset_time) for r in gpu.get_rate_limits(reqs)] == [
            (r.status, r.remaining, r.reset_time) for r in cpu.get_rate_limits(reqs)]
        keys = [r.hash_key().encode() for r in reqs]
        cols = tuple(np.asarray([getattr(r, f) for r in reqs], t) for f, t in (
            ("algorithm", np.int32), ("behavior", np.int32), ("hits", np.int64),
            ("limit", np.int64), ("duration", np.int64), ("burst", np.int64)))
        for x, y in zip(gpu.apply_columnar(keys, *cols), cpu.apply_columnar(keys, *cols)):
            assert np.array_equal(x, y), b
        advance(int(rng.integers(0, 400)), gpu, cpu)
    same_words(gpu, cpu)
    path = str(tmp_path / "s.npz")
    gpu.save(NpzFileLoader(path))
    fresh, fresh_cpu = pair(32)
    advance(gpu.clock.now_ms() - fresh.clock.now_ms(), fresh, fresh_cpu)
    assert fresh.load(NpzFileLoader(path)) == fresh_cpu.load(NpzFileLoader(path)) \
        == gpu.cache_size()
    same_words(fresh, fresh_cpu)
    advance(120_000, gpu, cpu)
    assert gpu.sweep() == cpu.sweep() > 0
    same_words(gpu, cpu)
    sgpu, scpu = pair(4, store=True)
    for b in range(10):
        reqs = batch(int(rng.integers(5, 60)), 80)
        assert [(r.status, r.remaining, r.reset_time) for r in sgpu.get_rate_limits(reqs)] == [
            (r.status, r.remaining, r.reset_time) for r in scpu.get_rate_limits(reqs)]
    same_words(sgpu, scpu)
    for name in ("shard_step", "shard_collapsed", "shard_sweep", "fused_step",
                 "collapsed_step", "clear_occupied", "load_slots"):
        assert fs.launches[name] > 0, name
