#!/usr/bin/env python3
"""Smoke run of gubernator_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's native code from gubernator_tpu_torch/csrc (the CUDA
kernels K1-K4 and the host intern table, one compiler each, in
parallel), holds each kernel against its plain PyTorch version on the
card at 2^20 and 10^8 slots (K1 over one round and over R ragged rounds
with eviction clears; K3, the collapsed hot-key step, on a zipf batch, a
one-key batch, the extreme-value batch, chunks with clears of segment
slots and of other slots, and a mostly-padding chunk; K4, the uniform
format, over 1, R and 16 ragged rounds with clears and a round that one
block's slot range holds whole; K2), then drives
the port's main path — the decision engine and the HTTP daemon answering
GetRateLimits — over five streams, each against the same engine on the
CPU, answers and state word for word:

* mixed: 2^20 slots, batches of 1000 (BASELINE.json configs[1]), and a
  4096-slot engine under eviction pressure — rounds through K1;
* zipf: the reference's zipf deployment (scripts/bench_all.py "zipf":
  s = 1.2 over 10^8 key names, 2^24 slots, batches of 8192, a limit
  config per key) — collapse through K3;
* uniform: one config across each batch — the pump and K4;
* async: `want_async=True`, two batches in flight — joined launches;
* HTTP: hot keys with a config each, so the dataclass path collapses.

It checks the launch counts of that run (K1, K3 and K4 all launched; K1
at most once per synchronous batch; the pump flushed), holds the zipf
stream's collapsed pins to K3's layout (`check_collapsed`), and times
every kernel on the shapes the main path gave it, beside its bytes bound
and its plain version (K3 also on one-key and spread zipf chunks without
and with clears, K4 also on joined launches of 2 and 16 rounds), and
apply_columnar's decisions/s on each stream.  Any
failed phase exits non-zero before the result lines.  The last three
lines of standard output are the kernels JSON line, the card's
`name, power.limit` from nvidia-smi, and {"ok": true, "device": {...}}.

    python3 chip_smoke.py --tree DIR

runs the same phases on the same seeded inputs against the port of
another checkout (DIR, its root: for instance the parent commit unpacked
with `git archive`), so that two trees are compared in one session on
one card.  A tree from before `check_collapsed` existed runs without
that layout check.

The port imports nothing of JAX; neither does this script.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

SEED = 20261017
CAP_SERVE = 1 << 20  # BASELINE.json configs[1]: 1M keys, batch=1000, single node
CAP_NORTH_STAR = 100_000_000  # BASELINE.json metric: 100M keys (4.8 GB of state)
BATCH = 1000  # MAX_BATCH_SIZE
ZIPF_S = 1.2  # scripts/bench_all.py "zipf": s = 1.2 over 10^8 keys, 2^24 slots, batch 8192
ZIPF_KEYS = 100_000_000
ZIPF_CAP = 1 << 24
ZIPF_BATCH = 8192
HBM_BYTES_PER_S = 3.35e12  # H100 SXM peak memory rate (NVIDIA data sheet)
NOW0 = 1_760_000_000_000  # ms; frozen-clock start of every phase


T_START = time.perf_counter()
TREE: Path | None = None  # --tree: the checkout whose port is driven


def check_layout(tk, pin) -> bool:
    """Hold a K3 pin to `check_collapsed`; False where a `--tree` port
    predates it (this script's own port must have it)."""
    layout = getattr(tk, "check_collapsed", None)
    if layout is None:
        check(TREE is not None, "the port has no check_collapsed")
        return False
    layout(pin)
    return True


def log(msg: str) -> None:
    print(f"{time.perf_counter() - T_START:6.1f}s {msg}", flush=True)


class PhaseError(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


# ---------------------------------------------------------------------------
# Seeded data


def random_state(torch, cap: int, now: int, seed: int):
    """A random valid state of `cap` slots (mixed token / leaky, live and
    expired, some invalidated), drawn on the card with a seeded generator
    from logical columns and packed as `pack_state_host` packs them."""
    from gubernator_tpu_torch.ops.bucket_kernel import TS_CLAMP_MAX, BucketState

    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    i64 = torch.int64
    lo32 = 0xFFFFFFFF

    def ints(lo, hi):
        return torch.randint(lo, hi, (cap,), generator=gen, device="cuda", dtype=i64)

    def pick(vals):
        return torch.tensor(vals, dtype=i64, device="cuda")[ints(0, len(vals))]

    def share(p):
        return torch.rand(cap, generator=gen, device="cuda") < p

    occ, algo, status = share(0.75).to(i64), ints(0, 2), ints(0, 2)
    t0c = (now - ints(0, 5_000)).clamp(0, TS_CLAMP_MAX)
    invc = torch.where(share(0.1), now + ints(-50, 50), 0).clamp(0, TS_CLAMP_MAX)
    expc = (now + ints(-100, 5_000)).clamp(0, TS_CLAMP_MAX)
    durc = pick([0, 1, 40, 1000, 30_000])
    limit = pick([0, 1, 5, 100, 10**12])
    remaining, remf_hi, remf_lo = ints(-5, 200), ints(-3, 200), ints(0, 2**32)
    burst = pick([0, 0, 5, 20])
    leaky = algo == 1
    words = [
        occ | (algo << 1) | ((status & 3) << 2) | ((t0c >> 32) << 4) | ((invc >> 32) << 15),
        (expc >> 32) | ((durc >> 32) << 11),
        t0c & lo32, expc & lo32, invc & lo32, durc & lo32, limit >> 32, limit & lo32,
        torch.where(leaky, remf_hi, remaining >> 32),
        torch.where(leaky, remf_lo, remaining & lo32),
        burst >> 32, burst & lo32,
    ]
    # int64 -> the int32 bit pattern of its low word
    return BucketState(*((((w & lo32) ^ 0x80000000) - 0x80000000).to(torch.int32)
                         for w in words))


def copy_state(state):
    return type(state)(*(c.clone() for c in state))


def random_pin(np, rng, cap: int, width: int, m: int, now: int):
    """A packed round of m unique sorted slots out of [0, cap), padded to
    `width` with out-of-range lanes."""
    from gubernator_tpu_torch.ops.bucket_kernel import pack_batch_host

    slots = np.sort(rng.choice(cap, m, replace=False)).astype(np.int32)
    cols = [
        rng.integers(0, 3, m),
        rng.choice(np.array([0, 0, 4, 8, 12]), m),
        rng.choice(np.array([-3, 0, 1, 1, 2, 5, 100, 2**40]), m),
        rng.choice(np.array([-1, 0, 1, 5, 100, 10**12, 2**62]), m),
        rng.choice(np.array([0, 1, 40, 1000, 30_000, -5]), m),
        rng.choice(np.array([0, 0, 5, 20, -7]), m),
        rng.choice(np.array([60_000, 3_600_000, 86_400_000]), m),
        now + rng.integers(0, 100_000, m),
    ]
    return pack_batch_host(width, now, cap, slots, *cols)


def extreme_cols(np, cap: int, m: int, now: int):
    """The saturation case: leaky buckets with huge limits and tiny
    durations (elapsed / rate past 2^63, where f64 → int64 saturates),
    int64 wrap of now + duration, negative and extreme fields.  Returns
    m sorted slots and the 8 request columns."""
    big = 2**62
    r = lambda vals, dt: np.resize(np.array(vals, dt), m)  # noqa: E731
    return np.arange(m, dtype=np.int32) * (cap // m), [
        r([1, 1, 0, 1, 5], np.int32),
        r([0, 8, 4, 12, 0, 0, 0], np.int32),
        r([0, 1, -(2**62), 2**62, 2**63 - 1, -(2**63)], np.int64),
        r([big, 2**63 - 1, 1, -(2**63), 3, big], np.int64),
        r([1, 2**63 - 1, -(2**63), 0, 7, 2**43 + 5], np.int64),
        r([0, big, -(2**63), 2**63 - 1, 1], np.int64),
        r([0, 1, 2**63 - 1, 86_400_000], np.int64),
        r([now, 2**63 - 1, -(2**63), now + 1], np.int64),
    ]


def extreme_pin(np, cap: int, width: int, now: int):
    from gubernator_tpu_torch.ops.bucket_kernel import pack_batch_host

    slots, cols = extreme_cols(np, cap, min(width, 48), now)
    return pack_batch_host(width, now, cap, slots, *cols)


def extreme_rounds(np, cap: int, now: int):
    """The extreme batch as three rounds over the same 48 slots (24 + 24,
    then all 48 again after clearing four of them)."""
    from gubernator_tpu_torch.ops.bucket_kernel import pack_rounds_host

    slots, cols = extreme_cols(np, cap, 48, now)
    return pack_rounds_host(now, cap, [24, 24, 48], np.concatenate([slots, slots]),
                            [np.concatenate([c, c]) for c in cols],
                            [[], [], [int(slots[i]) for i in (0, 5, 11, 47)]])


def ragged_rounds(np, rng, cap: int, n_rounds: int, now: int, max_lanes: int = 1100):
    """R rounds of 1..max_lanes unique sorted slots each, slot 0 in every
    round; even rounds first clear every 7th of their slots (slot 0
    among them: cleared, then updated in the same round) and one
    out-of-range slot."""
    from gubernator_tpu_torch.ops.bucket_kernel import pack_rounds_host

    counts = [int(rng.integers(1, max_lanes + 1)) for _ in range(n_rounds)]
    slots = [np.sort(np.append(rng.choice(cap - 1, m - 1, replace=False) + 1, 0))
             .astype(np.int32) for m in counts]
    clears = [[] if r % 2 else [int(x) for x in slots[r][::7]] + [cap + r]
              for r in range(n_rounds)]
    n = sum(counts)
    cols = [
        rng.integers(0, 3, n),
        rng.choice(np.array([0, 0, 4, 8, 12]), n),
        rng.choice(np.array([-3, 0, 1, 1, 2, 5, 100, 2**40]), n),
        rng.choice(np.array([-1, 0, 1, 5, 100, 10**12, 2**62]), n),
        rng.choice(np.array([0, 1, 40, 1000, 30_000, -5]), n),
        rng.choice(np.array([0, 0, 5, 20, -7]), n),
        rng.choice(np.array([60_000, 3_600_000, 86_400_000]), n),
        now + rng.integers(0, 100_000, n),
    ]
    return pack_rounds_host(now, cap, counts, np.concatenate(slots), cols, clears)


def on_device(torch, packed):
    """One copy of a PackedRounds buffer to the card → (pin, round_off,
    clear_off, clear_slots) views."""
    from gubernator_tpu_torch.ops.bucket_kernel import split_rounds

    flat = torch.from_numpy(packed.buf).cuda()
    return split_rounds(flat, packed.pin.shape[1], len(packed.round_off) - 1)


def extreme_state_words(np, cap: int, now: int) -> dict:
    """Leaky buckets created at t0 = 1 with limit = burst = 2^62."""
    from gubernator_tpu_torch.ops.bucket_kernel import pack_state_host

    full = lambda v, dt=np.int64: np.full(cap, v, dt)  # noqa: E731
    algo = full(1)
    algo[::4] = 0
    return pack_state_host(dict(
        occupied=np.ones(cap, bool), algo=algo, status=full(0), t0=full(1),
        invalid=full(0), expire=full(now + 10), duration=full(1), limit=full(2**62),
        remaining=full(0), remf_hi=full(2**31 - 1, np.int32),
        remf_lo=full(2**32 - 1, np.uint32), burst=full(2**62),
    ))


def in_range_lanes(pin, cap: int) -> int:
    s = pin[1].astype("int64")
    return int(((s >= 0) & (s < cap)).sum())


def k1_bound_ms(pin, cap: int) -> float:
    """Least time for one K1 round: each input read once (rows 1-15 of
    pin, 60 B/lane, plus the two `now` header words of row 0; 12 state
    words at each in-range slot), each output written once (pout
    20 B/lane, 12 state words per in-range slot), at peak HBM.  The rest
    of row 0 is padding that neither the step nor the kernel reads."""
    width = pin.shape[1]
    n = in_range_lanes(pin, cap)
    return (width * (60 + 20) + 8 + n * 48 * 2) / HBM_BYTES_PER_S * 1e3


def k1_multi_bound_ms(pin, clear_off, clear_slots, cap: int) -> float:
    """Least time for one multi-round K1 launch: over the rounds,
    L_r·80 + n_r·96 B (rows 1-15 of pin and pout per lane, 12 state words
    read and written per in-range lane), plus each round's 8 B `now`
    header, plus 12 B per in-range clear (its slot, one meta word read and
    written), at peak HBM."""
    s = clear_slots[: int(clear_off[-1])].astype("int64")
    n_clear = int(((s >= 0) & (s < cap)).sum())
    n_rounds = len(clear_off) - 1
    return (pin.shape[1] * 80 + in_range_lanes(pin, cap) * 96 + 8 * n_rounds + n_clear * 12) \
        / HBM_BYTES_PER_S * 1e3


def k2_bound_ms(slots, cap: int) -> float:
    """Least time for one K2 launch: slots read once, one meta word read
    and written per in-range slot."""
    s = slots.astype("int64")
    n = int(((s >= 0) & (s < cap)).sum())
    return (len(s) * 4 + n * 8) / HBM_BYTES_PER_S * 1e3


def collapsed_case(np, rng, cap: int, kind: str, now: int, width: int = ZIPF_BATCH):
    """A collapsed chunk as `pack_collapsed_host` lays it out, with its
    clears.  `kind`: "zipf" (`width` lanes, slots (zipf(1.2) - 1) mod cap,
    per-segment fields drawn over every branch of the closed form),
    "one" (every lane one key), "extreme" (48 segments with the
    saturation fields), "clears" (a zipf chunk that first clears every
    fifth segment's slot and one out-of-range slot), "foreign" (those
    clears plus 400 in-range slots of no segment, sorted), "padding"
    (40 segments of 1-8 lanes padded to `width` lanes)."""
    from gubernator_tpu_torch.ops.bucket_kernel import pack_collapsed_host

    if kind == "one":
        lane_slots = np.full(width, int(rng.integers(0, cap)), np.int64)
    elif kind == "extreme":
        base, _ = extreme_cols(np, cap, 48, now)
        lane_slots = np.repeat(base.astype(np.int64), rng.integers(1, 6, 48))
    elif kind == "padding":
        lane_slots = np.repeat(rng.choice(cap, 40, replace=False), rng.integers(1, 9, 40))
    else:
        lane_slots = (rng.zipf(ZIPF_S, width) - 1) % cap
    uniq, counts = np.unique(lane_slots, return_counts=True)
    n_seg = len(uniq)
    if kind == "extreme":
        _, fields = extreme_cols(np, cap, n_seg, now)
    else:
        fields = [
            rng.integers(0, 3, n_seg),
            rng.choice(np.array([0, 0, 0, 4]), n_seg),
            rng.choice(np.array([-3, 0, 1, 1, 2, 3, 5, 2**40]), n_seg),
            rng.choice(np.array([-1, 0, 1, 4, 10, 100, 10**6, 2**62]), n_seg),
            rng.choice(np.array([0, 1, 40, 60_000, 3_600_000, -5]), n_seg),
            rng.choice(np.array([0, 0, 3, 20, 10**6, -7]), n_seg),
            rng.choice(np.array([60_000, 3_600_000, 86_400_000]), n_seg),
            now + rng.integers(0, 100_000, n_seg),
        ]
    seg = np.repeat(np.arange(n_seg), counts).astype(np.int32)
    pos = (np.arange(len(seg)) - np.repeat(np.cumsum(counts) - counts, counts)).astype(np.int32)
    size = width if kind == "padding" else -(-len(seg) // 32) * 32
    pin = pack_collapsed_host(size, now, cap, uniq.astype(np.int32), counts.astype(np.int64),
                              tuple(fields), seg, pos)
    clears = np.empty(0, np.int64)
    if kind in ("clears", "extreme", "foreign"):
        clears = np.append(uniq[::5], cap + 1)
    if kind == "foreign":  # sorted, as the engine sends them
        other = rng.integers(0, cap, 400 + len(uniq))
        clears = np.sort(np.concatenate([clears, other[~np.isin(other, uniq)][:400]]))
    return pin, clears.astype(np.int32)


def uniform_rounds(np, rng, cap: int, n_rounds: int, now: int, max_lanes: int = 1100, *,
                   lanes: int | None = None, every_round: bool = False):
    """R ragged uniform rounds (`lanes` real lanes each, or 1..max_lanes),
    each with its own `now` and config, slot 0 in every round; even rounds
    first clear every 7th of their slots and one out-of-range slot --
    with `every_round`, every round does, and also clears 8 in-range slots
    that none of its lanes holds.  Returns (pin, round_off, clear_off,
    clear_slots, widest) as numpy arrays."""
    rounds = []
    for r in range(n_rounds):
        m = lanes or int(rng.integers(1, max_lanes + 1))
        slots = np.sort(np.append(rng.choice(cap - 1, m - 1, replace=False) + 1, 0))
        clears = []
        if every_round or r % 2 == 0:
            clears = [int(x) for x in slots[::7]] + [cap + r]
        if every_round:
            other = rng.integers(1, cap, 16)
            clears += [int(x) for x in other[~np.isin(other, slots)][:8]]
        rounds.append((slots, clears))
    return join_uniform(np, rng, cap, now, rounds)


def skewed_uniform_rounds(np, rng, cap: int, now: int):
    """Three uniform rounds where one block's slot range holds a whole
    round: 1024 slots that leave a gap of 1500, the 1500 slots of the gap,
    the first round's slots again; each round clears every 9th of its
    slots and a slot of the gap's edge."""
    gap = int(rng.integers(1, cap - 3000))
    outside = np.concatenate([np.arange(0, gap), np.arange(gap + 1500, cap)])
    wide = np.sort(rng.choice(outside, 1024, replace=False))
    rounds = [wide, np.arange(gap, gap + 1500), wide]
    return join_uniform(np, rng, cap, now,
                        [(s, [int(x) for x in s[::9]] + [gap + 1499 * (r % 2)])
                         for r, s in enumerate(rounds)])


def join_uniform(np, rng, cap: int, now: int, rounds):
    """One launch's uniform rounds from (sorted slots, clears) pairs, each
    round with a random config and `now + r`: (pin, round_off, clear_off,
    clear_slots, widest) as numpy arrays, the layout the pump joins."""
    from gubernator_tpu_torch.ops.bucket_kernel import pack_uniform_rounds_host

    parts = []
    for r, (slots, clears) in enumerate(rounds):
        cfg = (int(rng.integers(0, 2)), 0, int(rng.integers(-2, 6)), int(rng.integers(0, 10**6)),
               int(rng.integers(1, 90_000)), int(rng.integers(0, 70)))
        parts.append(pack_uniform_rounds_host(now + r, cap, [len(slots)],
                                              np.asarray(slots, np.int32), cfg, [clears]))
    widths = [p.pin.shape[1] for p in parts]
    n_clear = [int(p.clear_off[-1]) for p in parts]
    return (np.concatenate([p.pin for p in parts], axis=1),
            np.concatenate([[0], np.cumsum(widths)]).astype(np.int32),
            np.concatenate([[0], np.cumsum(n_clear)]).astype(np.int32),
            np.concatenate([p.clear_slots[:k] for p, k in zip(parts, n_clear)]
                           + [[cap]]).astype(np.int32),
            max(widths))


def n_in_range(slots, cap: int) -> int:
    s = slots.astype("int64")
    return int(((s >= 0) & (s < cap)).sum())


def k3_bound_ms(pin, clears, cap: int) -> float:
    """Least time for one K3 launch: the 8 B `now` header; per lane rows
    17-18 read (8 B) and pout written (20 B); per in-range segment rows
    1-16 read (64 B) and 12 state words read and written (96 B); 12 B
    per in-range clear; at peak HBM.  The columns past the segments are
    padding that no lane needs."""
    return (8 + pin.shape[1] * (8 + 20) + n_in_range(pin[1], cap) * (64 + 96)
            + n_in_range(clears, cap) * 12) / HBM_BYTES_PER_S * 1e3


def k4_bound_ms(pin, round_off, clear_off, clear_slots, cap: int) -> float:
    """Least time for one K4 launch: the slot row read (4 B a lane), the
    narrow pout written (8 B a lane), each round's 40 B header, 96 B of
    state per in-range lane, 12 B per in-range clear, at peak HBM."""
    n_clear = n_in_range(clear_slots[: int(clear_off[-1])], cap)
    return (pin.shape[1] * 12 + (len(round_off) - 1) * 40 + n_in_range(pin[1], cap) * 96
            + n_clear * 12) / HBM_BYTES_PER_S * 1e3


# ---------------------------------------------------------------------------
# Phases


def phase_device(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0].strip()
    log(f"[device] {card} | torch {torch.__version__} cuda {torch.version.cuda} | "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    return card


def phase_build():
    from gubernator_tpu_torch.ops import native_build

    t = time.perf_counter()
    libs = native_build.build_all()
    log(f"[build] {len(libs)} libraries built in {time.perf_counter() - t:.1f} s "
        "(one nvcc / g++ each, in parallel)")
    for name, text in native_build.build_logs.items():
        for line in text.splitlines():
            if "entry function" in line or "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")


def compare_states(torch, a, b) -> int:
    """Max |a - b| over all 12 columns (as int64 words); 0 = equal."""
    err = 0
    for x, y in zip(a, b):
        if not torch.equal(x, y):
            err = max(err, int((x.to(torch.int64) - y.to(torch.int64)).abs().max().item()))
    return err


def make_hold(torch, errs):
    def hold(name, got, want, kern, plain, what):
        torch.cuda.synchronize()
        err = max(int((got.long() - want.long()).abs().max().item()),
                  compare_states(torch, kern, plain))
        errs[name] = max(errs[name], err)
        check(err == 0, f"{name} differs from its plain version: {what} err {err}")
    return hold


def phase_kernels(torch, np, rng, errs):
    """K1, K3 and K4 against their plain versions on the card, bit-exact
    in the output and the 12 state columns, at cap 2^20 and 10^8 (one
    random state per cap, shared by the three): K1 over one round at
    W in {64, 1024, 8192} and R in {1, 3, 16} ragged rounds with clears;
    K3 on a zipf batch (s = 1.2, 8192 lanes), a one-key batch, the
    extreme-value batch, a chunk with clears, a chunk whose clears are
    mostly of no segment's slot and a chunk that is mostly padding (each
    pin held to K3's layout, `check_collapsed`); K4 over 1 and 5 ragged
    uniform rounds with clears, 16 rounds with clears in every round
    (slot 0 in each) and a round that one block's slot range holds
    whole.  Then the extreme-value batch for K1 (one round and three
    rounds) and K3 on a state of saturating buckets."""
    from gubernator_tpu_torch.ops import bucket_kernel as tk
    from gubernator_tpu_torch.ops import fused_step as fs
    from gubernator_tpu_torch.ops.collapsed_step import collapsed_step

    hold = make_hold(torch, errs)

    def cuda(a):
        return torch.from_numpy(np.ascontiguousarray(a)).cuda()

    for cap in (CAP_SERVE, CAP_NORTH_STAR):
        kern = random_state(torch, cap, NOW0, int(rng.integers(2**31)))
        plain = copy_state(kern)
        log(f"[kernels] cap {cap}: random state made on the card "
            f"({cap * 48 / 1e9:.2f} GB per copy)")
        now = NOW0
        rounds = 0
        for width in (64, 1024, 8192):
            for _ in range(2):
                now += int(rng.integers(0, 300))
                m = width - int(rng.integers(0, width // 4 + 1))
                pin = cuda(random_pin(np, rng, cap, width, m, now))
                hold("fused_step", fs.fused_step(kern, pin), tk.fused_step_reference(plain, pin),
                     kern, plain, f"cap {cap} one round W {width}")
                rounds += 1
        for n_rounds in (1, 3, 16):
            for _ in range(2):
                now += int(rng.integers(0, 300))
                packed = ragged_rounds(np, rng, cap, n_rounds, now)
                dev = on_device(torch, packed)
                hold("fused_step", fs.multi_fused_step(kern, *dev, widest=packed.widest),
                     tk.multi_fused_step_reference(plain, *dev), kern, plain,
                     f"cap {cap} R {n_rounds}")
                rounds += n_rounds
        log(f"[k1] cap {cap}: {rounds} rounds (one-round calls and multi-round launches at R "
            "in {1, 3, 16} with clears) bit-equal to the plain step (tolerance: exact)")
        for kind in ("zipf", "one", "extreme", "clears", "zipf", "foreign", "padding"):
            now += int(rng.integers(0, 3_000))
            pin, clears = collapsed_case(np, rng, cap, kind, now)
            check_layout(tk, pin)
            dpin, dcl = cuda(pin), cuda(clears)
            got = collapsed_step(kern, dpin, dcl)
            tk.clear_occupied_reference(plain.meta, dcl)
            hold("collapsed_step", got, tk.collapsed_step_reference(plain, dpin), kern, plain,
                 f"cap {cap} {kind} batch")
        log(f"[k3] cap {cap}: zipf (s = {ZIPF_S}, {ZIPF_BATCH} lanes), one-key, extreme-value, "
            "with-clears, foreign-clears and mostly-padding chunks bit-equal to clear + "
            "collapsed_step_reference (exact)")
        for case in (1, 5, 1, 5, 16, "skewed"):
            now += int(rng.integers(0, 3_000))
            if case == "skewed":
                pin, ro, co, cs, widest = skewed_uniform_rounds(np, rng, cap, now)
            else:
                pin, ro, co, cs, widest = uniform_rounds(np, rng, cap, case, now,
                                                         every_round=case == 16)
            args = [cuda(a) for a in (pin, ro, co, cs)]
            hold("uniform_step", fs.multi_uniform_step(kern, *args, widest=widest),
                 tk.multi_uniform_step_reference(plain, *args), kern, plain,
                 f"cap {cap} uniform {case}")
        log(f"[k4] cap {cap}: 1, 5 and 16 ragged uniform rounds with clears (16: in every "
            "round, slots of no lane among them) and a skewed launch bit-equal to "
            "multi_uniform_step_reference (exact)")
        del kern, plain
        torch.cuda.empty_cache()

    cap = 4096
    words = extreme_state_words(np, cap, NOW0)
    kern, plain = tk.state_from_numpy(words, "cuda"), tk.state_from_numpy(words, "cuda")
    buf = extreme_pin(np, cap, 64, NOW0)
    for step in range(3):
        pin = cuda(buf)
        hold("fused_step", fs.fused_step(kern, pin), tk.fused_step_reference(plain, pin), kern,
             plain, f"extreme batch step {step}")
        buf[0, 1] += 997
        packed = extreme_rounds(np, cap, NOW0 + 5000 * (step + 1))
        dev = on_device(torch, packed)
        hold("fused_step", fs.multi_fused_step(kern, *dev, widest=packed.widest),
             tk.multi_fused_step_reference(plain, *dev), kern, plain,
             f"extreme batch in three rounds, step {step}")
        pin, clears = collapsed_case(np, rng, cap, "extreme", NOW0 + 5000 * (step + 1) + 7)
        dpin, dcl = cuda(pin), cuda(clears)
        got = collapsed_step(kern, dpin, dcl)
        tk.clear_occupied_reference(plain.meta, dcl)
        hold("collapsed_step", got, tk.collapsed_step_reference(plain, dpin), kern, plain,
             f"extreme collapsed batch on saturating buckets, step {step}")
    log("[kernels] extreme-value batch bit-equal through K1 (one round, three rounds with "
        "clears) and K3 on saturating buckets (saturating f64->int, int64 wrap)")


def phase_k2(torch, np, rng, errs):
    from gubernator_tpu_torch.ops import bucket_kernel as tk
    from gubernator_tpu_torch.ops import fused_step as fs

    for cap in (CAP_SERVE, CAP_NORTH_STAR):
        meta0 = torch.from_numpy(rng.integers(0, 2**26, cap, dtype=np.int32)).cuda()
        kern, plain = meta0.clone(), meta0.clone()
        del meta0
        for width in (16, 128, 1024):
            k = int(rng.integers(1, width + 1))
            c = np.arange(cap, cap + width, dtype=np.int64).astype(np.int32)
            c[:k] = np.sort(rng.choice(cap, k, replace=False))
            slots = torch.from_numpy(c).cuda()
            fs.clear_occupied(kern, slots)
            tk.clear_occupied_reference(plain, slots)
            torch.cuda.synchronize()
            err = 0 if torch.equal(kern, plain) else int(
                (kern.long() - plain.long()).abs().max().item())
            errs["clear_occupied"] = max(errs["clear_occupied"], err)
            check(err == 0, f"K2 differs from the plain clear: cap {cap} W {width}")
        del kern, plain
        torch.cuda.empty_cache()
        log(f"[k2] cap {cap}: clears of width 16/128/1024 bit-equal to the plain clear "
            "(tolerance: exact)")


def stream_columns(np, rng, keys_pool, hot, n, *, greg_share=0.05):
    """One batch of n requests as columns: mostly uniform keys, a hot
    set that repeats within the batch, mixed token / leaky, some
    RESET_REMAINING and some Gregorian (valid intervals)."""
    pick_hot = rng.random(n) < 0.08
    idx = rng.integers(0, len(keys_pool), n)
    keys = [hot[int(rng.integers(len(hot)))] if h else keys_pool[int(i)]
            for h, i in zip(pick_hot, idx)]
    beh = np.where(rng.random(n) < 0.03, 8, 0).astype(np.int32)
    greg = rng.random(n) < greg_share
    beh = np.where(greg, beh | 4, beh).astype(np.int32)
    dur = np.where(greg, rng.integers(0, 6, n),
                   rng.choice(np.array([1000, 60_000, 3_600_000]), n)).astype(np.int64)
    return keys, (
        rng.integers(0, 2, n).astype(np.int32),
        beh,
        rng.choice(np.array([0, 1, 1, 1, 2, 5, 50]), n).astype(np.int64),
        rng.choice(np.array([10, 100, 1000, 10**6]), n).astype(np.int64),
        dur,
        rng.choice(np.array([0, 0, 0, 20]), n).astype(np.int64),
    )


def zipf_columns(np, rng, n: int = ZIPF_BATCH):
    """One batch of the reference's zipf deployment (bench.py `_run_engine`
    with BENCH_ZIPF=1.2, BENCH_KEYS=10^8): key (zipf(1.2) - 1) mod 10^8,
    the algorithm a property of the key (index parity), hits 1, limit and
    burst 10^6, duration 1 h."""
    idx = (rng.zipf(ZIPF_S, n) - 1) % ZIPF_KEYS
    return [b"bench_k%d" % i for i in idx.tolist()], (
        (idx % 2).astype(np.int32), np.zeros(n, np.int32), np.ones(n, np.int64),
        np.full(n, 10**6, np.int64), np.full(n, 3_600_000, np.int64),
        np.full(n, 10**6, np.int64),
    )


def uniform_columns(np, rng, keys_pool, n: int):
    """n distinct keys sharing one limit config (the narrow format's
    traffic: one client's limit over many keys)."""
    keys = [keys_pool[int(i)] for i in rng.choice(len(keys_pool), n, replace=False)]
    algo, limit = int(rng.integers(0, 2)), int(rng.choice([10, 100, 10**6]))
    return keys, (np.full(n, algo, np.int32), np.zeros(n, np.int32),
                  np.full(n, int(rng.choice([0, 1, 1, 2])), np.int64), np.full(n, limit, np.int64),
                  np.full(n, 60_000, np.int64), np.zeros(n, np.int64))


# Per-key limit configs (algo, behavior, hits, limit, duration, burst) of
# the HTTP stream: a key always sends its own, as a client's limit does.
KEYED_CONFIGS = [(0, 0, 1, 10, 60_000, 0), (1, 0, 1, 10, 60_000, 20), (0, 0, 2, 100, 1000, 0),
                 (1, 4, 1, 50, 2, 0), (0, 4, 1, 5, 1, 0), (1, 0, 5, 1000, 3_600_000, 0),
                 (0, 0, 0, 7, 60_000, 0), (1, 0, 2, 8, 1000, 4)]


def keyed_columns(np, rng, n_pool: int, n_hot: int, n: int, prefix: str = "api"):
    """n requests, 8% of them on `n_hot` hot keys, each key with its
    KEYED_CONFIGS entry (Gregorian ones included), so every batch's
    duplicates can collapse."""
    hot = rng.random(n) < 0.08
    ids = np.where(hot, rng.integers(0, n_hot, n), n_hot + rng.integers(0, n_pool, n))
    keys = [(f"{prefix}_h{i}" if i < n_hot else f"{prefix}_u{i}").encode() for i in ids.tolist()]
    cfg = np.array([KEYED_CONFIGS[i % len(KEYED_CONFIGS)] for i in ids.tolist()], np.int64)
    return keys, (cfg[:, 0].astype(np.int32), cfg[:, 1].astype(np.int32), *cfg[:, 2:].T.copy())


def as_requests(keys, cols):
    from gubernator_tpu_torch.types import RateLimitReq

    algo, beh, hits, limit, dur, burst = cols
    out = []
    for j, k in enumerate(keys):
        name, _, uk = k.decode().partition("_")
        out.append(RateLimitReq(name=name, unique_key=uk, hits=int(hits[j]),
                                limit=int(limit[j]), duration=int(dur[j]),
                                algorithm=int(algo[j]), behavior=int(beh[j]),
                                burst=int(burst[j])))
    return out


class Recorder:
    """Keeps a copy of the inputs of each call of one kernel wrapper that
    an engine on the card makes (for timing the kernel on the main path's
    shapes); the CPU engine's calls are not kept."""

    def __init__(self, name: str):
        from gubernator_tpu_torch.core import engine as engine_mod

        self.mod, self.name = engine_mod, name
        self.real = getattr(engine_mod, name)
        self.calls = []

    @staticmethod
    def on_card(state) -> bool:
        return state.meta.is_cuda

    def __enter__(self):
        def record(state, *args, **kw):
            if self.on_card(state):
                self.calls.append((tuple(a.clone() for a in args), dict(kw)))
            return self.real(state, *args, **kw)

        setattr(self.mod, self.name, record)
        return self

    def __exit__(self, *exc):
        setattr(self.mod, self.name, self.real)


def run_stream(torch, np, rng, cap, batches, tag, *, dataclass_every=0, in_flight=0):
    """The same batches through the engine on the card and on the CPU
    (frozen clocks at one instant): answers and final state words must
    be bit-equal.  With `dataclass_every` = k, every k-th batch goes
    through get_rate_limits; with `in_flight` > 0, the card's batches are
    `want_async` and that many stay in flight before the oldest is read.
    Returns (card engine, the stream's launches by kernel)."""
    from collections import deque

    from gubernator_tpu_torch.clock import Clock
    from gubernator_tpu_torch.core.engine import DecisionEngine
    from gubernator_tpu_torch.ops import bucket_kernel as tk
    from gubernator_tpu_torch.ops import fused_step as fs

    ns = NOW0 * 1_000_000
    width = max(8192, len(batches[0][0]))
    gpu = DecisionEngine(cap, clock=Clock().freeze_at(ns), device="cuda", max_kernel_width=width)
    cpu = DecisionEngine(cap, clock=Clock().freeze_at(ns), device="cpu", max_kernel_width=width)
    before = dict(fs.launches)
    decisions = 0
    pending = deque()

    def compare(b, got, want):
        for name, g, w in zip(("status", "limit", "remaining", "reset"), got, want):
            check(np.array_equal(g, w), f"[{tag}] batch {b}: {name} differs card vs CPU")

    for b, (keys, cols) in enumerate(batches):
        if dataclass_every and b % dataclass_every == dataclass_every - 1:
            reqs = as_requests(keys, cols)
            check(gpu.get_rate_limits(reqs) == cpu.get_rate_limits(reqs),
                  f"[{tag}] batch {b}: get_rate_limits differs card vs CPU")
        elif in_flight:
            pending.append((b, gpu.apply_columnar(keys, *cols, want_async=True),
                            cpu.apply_columnar(keys, *cols)))
            if len(pending) > in_flight:
                pb, pg, pw = pending.popleft()
                compare(pb, pg.get(), pw)
        else:
            compare(b, gpu.apply_columnar(keys, *cols), cpu.apply_columnar(keys, *cols))
        decisions += len(keys)
        dt = int(rng.integers(0, 2_000))
        gpu.clock.advance(ms=dt)
        cpu.clock.advance(ms=dt)
    while pending:
        pb, pg, pw = pending.popleft()
        compare(pb, pg.get(), pw)
    gw, cw = tk.state_to_numpy(gpu.state), tk.state_to_numpy(cpu.state)
    for f in tk.BucketState._fields:
        check(np.array_equal(gw[f], cw[f]), f"[{tag}] final state column {f} differs")
    check(gpu.table.evictions == cpu.table.evictions, f"[{tag}] eviction counts differ")
    launched = {k: fs.launches[k] - before[k] for k in fs.launches}
    pump = gpu._pump
    log(f"[{tag}] {len(batches)} batches ({decisions} decisions, {len(gpu.table)} keys live, "
        f"{gpu.table.evictions} evictions): {gpu.rounds_total} rounds in "
        f"{gpu.dispatches_total} launches {launched}, {gpu.clears_total} clears inside them, "
        f"pump {pump.submitted} submitted / {pump.flushes} flushes / {pump.fused_rounds} "
        f"rounds; answers and all {cap}x12 state words bit-equal "
        f"card vs CPU")
    cpu.close()
    return gpu, launched


def streams(np, rng, n_batches: int):
    """The main path's streams as (tag, cap, batches, run_stream options).
    `n_batches` scales each stream's length."""
    pool = [b"api_k%d" % i for i in range(200_000)]
    hot = [b"api_hot%d" % i for i in range(50)]
    small = [b"api_e%d" % i for i in range(3 * 4096)]
    n = n_batches
    return [
        ("mixed", CAP_SERVE, [stream_columns(np, rng, pool, hot, BATCH) for _ in range(n)],
         dict(dataclass_every=2)),
        ("evict", 4096, [stream_columns(np, rng, small, hot, BATCH) for _ in range(n * 3 // 4)],
         dict(dataclass_every=2)),
        ("zipf", ZIPF_CAP, [zipf_columns(np, rng) for _ in range(max(n * 3 // 8, 2))], {}),
        ("uniform", CAP_SERVE, [uniform_columns(np, rng, pool, BATCH) for _ in range(n * 5 // 8)],
         {}),
        # two uniform batches, two general ones, ...: a queued run of one
        # format is one launch
        ("async", CAP_SERVE,
         [uniform_columns(np, rng, pool, BATCH) if b // 2 % 2 else
          stream_columns(np, rng, pool, hot, BATCH, greg_share=0.0) for b in range(n * 3 // 4)],
         dict(in_flight=2)),
    ]


def phase_engine(torch, np, rng):
    """The five streams, card against CPU; returns (card engines, K3 and
    K4 calls recorded from the zipf and uniform streams)."""
    engines, recorded = [], {}
    for tag, cap, batches, opts in streams(np, rng, 16):
        rec = {"zipf": "collapsed_step", "uniform": "multi_uniform_step"}.get(tag)
        with Recorder(rec) if rec else contextlib.nullcontext() as calls:
            e, launched = run_stream(torch, np, rng, cap, batches, tag, **opts)
        if rec:
            recorded[tag] = calls.calls
        engines.append(e)
        if not opts.get("in_flight"):
            check(launched["fused_step"] <= len(batches), f"[{tag}] more K1 launches than batches")
        if tag == "evict":
            check(e.clears_total > 0, "[evict] the stream must clear evicted slots")
        if tag == "zipf":
            check(launched["collapsed_step"] > 0, "[zipf] the zipf stream must collapse (K3)")
        if tag == "uniform":
            check(launched["uniform_step"] > 0, "[uniform] single-config batches must run K4")
        if tag == "async":
            check(e._pump.flushes < e._pump.submitted, "[async] queued batches must share launches")
    return engines, recorded["zipf"], recorded["uniform"]


def phase_rates(torch, np, rng, card):
    """apply_columnar decisions/s on the card, stream by stream: fresh
    batches through a fresh card engine, the first 4 untimed (warm-up),
    the rest timed end to end (the async stream with two in flight)."""
    from collections import deque

    from gubernator_tpu_torch.clock import Clock
    from gubernator_tpu_torch.core.engine import DecisionEngine

    rates = {}
    for tag, cap, batches, opts in streams(np, rng, 40):
        eng = DecisionEngine(cap, clock=Clock().freeze_at(NOW0 * 1_000_000), device="cuda",
                             max_kernel_width=max(8192, len(batches[0][0])))
        pending = deque()
        t, n = 0.0, 0
        for b, (keys, cols) in enumerate(batches):
            if b == 4:
                while pending:
                    pending.popleft().get()
                torch.cuda.synchronize()
                t, n = time.perf_counter(), 0
            if opts.get("in_flight"):
                pending.append(eng.apply_columnar(keys, *cols, want_async=True))
                if len(pending) > opts["in_flight"]:
                    pending.popleft().get()
            else:
                eng.apply_columnar(keys, *cols)
            n += len(keys) if b >= 4 else 0
            eng.clock.advance(ms=int(rng.integers(0, 2_000)))
        while pending:
            pending.popleft().get()
        rates[tag] = n / (time.perf_counter() - t)
        eng.close()
    log("[time] apply_columnar on the card, decisions/s by stream (warm, the card engine "
        "alone): " + ", ".join(f"{k} {v:.0f}" for k, v in rates.items()) + f" | {card}")
    return rates


def phase_server(torch, np, rng, card_engines):
    """The daemon on the card answers GetRateLimits over HTTP; each body
    must equal the JSON of the same batch through a CPU instance.  Hot
    keys repeat in every batch with one config each, so the batches
    collapse (K3) on the dataclass path."""
    from gubernator_tpu_torch.clock import Clock
    from gubernator_tpu_torch.config import DaemonConfig
    from gubernator_tpu_torch.core.engine import DecisionEngine
    from gubernator_tpu_torch.daemon import spawn_daemon
    from gubernator_tpu_torch.net.gateway import get_rate_limits_resp_json
    from gubernator_tpu_torch.ops import fused_step as fs
    from gubernator_tpu_torch.service import V1Instance

    ns = NOW0 * 1_000_000
    d = spawn_daemon(DaemonConfig(http_listen_address="127.0.0.1:0", cache_size=CAP_SERVE),
                     clock=Clock().freeze_at(ns), device="cuda")
    cpu = V1Instance(DecisionEngine(CAP_SERVE, clock=Clock().freeze_at(ns), device="cpu"))
    k3_before = fs.launches["collapsed_step"]
    try:
        card_engines.append(d.instance.engine)
        url = f"http://{d.http_address}"
        http_s, n_dec = 0.0, 0
        for b in range(12):
            keys, cols = keyed_columns(np, rng, 5_000, 20, BATCH)
            reqs = as_requests(keys, cols)
            reqs[0].behavior |= 2  # GLOBAL: not in this slice → per-item error
            reqs[1].unique_key = ""
            body = json.dumps({"requests": [vars(r) for r in reqs]}).encode()
            t = time.perf_counter()
            with urllib.request.urlopen(urllib.request.Request(
                    url + "/v1/GetRateLimits", data=body, method="POST"), timeout=60) as r:
                got = r.read()
            http_s += time.perf_counter() - t
            n_dec += len(reqs)
            check(got == get_rate_limits_resp_json(cpu.get_rate_limits(reqs)),
                  f"[server] batch {b}: HTTP body differs from the CPU instance's")
            d.clock.advance(ms=250)
            cpu.engine.clock.advance(ms=250)
        with urllib.request.urlopen(url + "/v1/HealthCheck", timeout=30) as r:
            health = json.loads(r.read())
        check(health["status"] == "healthy", f"[server] health: {health}")
        k3 = fs.launches["collapsed_step"] - k3_before
        check(k3 > 0, "[server] hot-key batches must collapse on the dataclass path")
        log(f"[server] 12 POST /v1/GetRateLimits x {BATCH} on the card ({k3} collapsed "
            f"launches): bodies byte-equal to the CPU instance's; HealthCheck {health['status']}")
        return n_dec / http_s
    finally:
        d.close()
        cpu.close()


def phase_daemon_binary():
    """`python -m gubernator_tpu_torch.cmd.daemon` on the card: it binds,
    answers, and exits 0 on SIGTERM."""
    import signal

    env = dict(os.environ, GUBER_HTTP_ADDRESS="127.0.0.1:0", GUBER_CACHE_SIZE=str(CAP_SERVE))
    import gubernator_tpu_torch

    root = Path(gubernator_tpu_torch.__file__).resolve().parent.parent  # the port driven
    proc = subprocess.Popen([sys.executable, "-m", "gubernator_tpu_torch.cmd.daemon"],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
                            cwd=root)
    try:
        line = proc.stdout.readline().strip()
        check(line.startswith("listening http="), f"[daemon] no readiness line: {line!r}")
        addr = line.split("=", 1)[1]
        body = json.dumps({"requests": [{"name": "a", "unique_key": "b", "hits": 1,
                                         "limit": 3, "duration": 1000}]}).encode()
        with urllib.request.urlopen(urllib.request.Request(
                f"http://{addr}/v1/GetRateLimits", data=body, method="POST"), timeout=60) as r:
            resp = json.loads(r.read())["responses"][0]
        check(resp["remaining"] == "2", f"[daemon] answer: {resp}")
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=60)
        check(rc == 0, f"[daemon] exit code {rc} after SIGTERM: {proc.stderr.read()}")
        log("[daemon] python -m gubernator_tpu_torch.cmd.daemon answered on the card, "
            "exited 0 on SIGTERM")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        proc.stdout.close()
        proc.stderr.close()


def device_ms(torch, launch, n: int, windows: int = 7) -> float:
    """Median device time per launch: `n` launches queued behind a spin
    kernel (so host launch overhead does not starve the card), timed
    with CUDA events; the median over `windows`."""
    per = []
    for _ in range(windows):
        torch.cuda._sleep(200_000_000)  # ~0.1 s of spinning: the queue fills meanwhile
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for i in range(n):
            launch(i)
        b.record()
        b.synchronize()
        per.append(a.elapsed_time(b) / n)
    return statistics.median(per)


def host_ms(torch, launch, n: int, windows: int = 5) -> float:
    """Median wall time per call, synchronised (for the plain versions,
    whose boolean indexing synchronises anyway)."""
    per = []
    for _ in range(windows):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for i in range(n):
            launch(i)
        torch.cuda.synchronize()
        per.append((time.perf_counter() - t) * 1e3 / n)
    return statistics.median(per)


def capture_batches(torch, np, rng, n_want: int = 16, r_want: int = 5):
    """Real batches from the engine's stream: batches of 1000 through an
    engine on the card (cap 2^20, 200k keys and 50 hot ones), keeping a
    copy of each K1 call's inputs.  Returns the first `n_want` batches of
    `r_want` rounds as (pin, round_off, clear_off, clear_slots, widest),
    and the number of batches seen at each R."""
    from gubernator_tpu_torch.clock import Clock
    from gubernator_tpu_torch.core.engine import DecisionEngine

    eng = DecisionEngine(CAP_SERVE, clock=Clock().freeze_at(NOW0 * 1_000_000), device="cuda")
    pool = [b"api_k%d" % i for i in range(200_000)]
    hot = [b"api_hot%d" % i for i in range(50)]
    got, by_r = [], {}
    with Recorder("multi_fused_step") as rec:
        for _ in range(400):
            keys, cols = stream_columns(np, rng, pool, hot, BATCH)
            eng.apply_columnar(keys, *cols)
            eng.clock.advance(ms=int(rng.integers(0, 2_000)))
            if not rec.calls:  # the batch collapsed: no K1 launch
                continue
            args, kw = rec.calls.pop()
            n_rounds = args[1].shape[0] - 1
            by_r[n_rounds] = by_r.get(n_rounds, 0) + 1
            if n_rounds == r_want:
                got.append(args + (kw["widest"],))
                if len(got) == n_want:
                    break
    eng.close()
    check(len(got) == n_want, f"only {len(got)} batches of {r_want} rounds in the stream")
    return got, dict(sorted(by_r.items()))


def phase_timing(torch, np, rng, card, k3_calls, k4_calls):
    """Device time per launch (CUDA events) against the bytes bound: K1
    at R = 1 (W = 1024 and 8192), K1 on 16 real 5-round batches (per
    launch and per round), K1 on a hot-key batch, K3 on the zipf
    stream's chunks (8192 lanes, cap 2^24), on one-key chunks and on
    spread zipf chunks without and with clears, K4 on the uniform stream's batches and on
    joined launches of 2 and 16 rounds, K2 over 1000 clears, and K2 over
    16 padding lanes as the launch floor."""
    from gubernator_tpu_torch.ops import bucket_kernel as tk
    from gubernator_tpu_torch.ops import fused_step as fs
    from gubernator_tpu_torch.ops.collapsed_step import collapsed_step

    state = random_state(torch, CAP_SERVE, NOW0, int(rng.integers(2**31)))
    plain_state = copy_state(state)
    out = {}
    for width, m in ((1024, BATCH), (8192, 8192)):
        host_pins = [random_pin(np, rng, CAP_SERVE, width, m, NOW0 + 10 * i) for i in range(16)]
        pins = [torch.from_numpy(p).cuda() for p in host_pins]
        # fused_step's R = 1 call, with its offsets made once
        one = (torch.tensor([0, width], dtype=torch.int32, device="cuda"),
               torch.zeros(2, dtype=torch.int32, device="cuda"),
               torch.tensor([CAP_SERVE], dtype=torch.int32, device="cuda"))
        for i in range(20):  # warm up
            fs.multi_fused_step(state, pins[i % 16], *one, widest=width)
        k_ms = device_ms(torch, lambda i: fs.multi_fused_step(
            state, pins[i % 16], *one, widest=width), 200)
        p_ms = host_ms(torch, lambda i: tk.fused_step_reference(plain_state, pins[i % 16]), 10)
        bound = statistics.median(k1_bound_ms(p, CAP_SERVE) for p in host_pins)
        out[width] = (k_ms, p_ms, bound)
        log(f"[time] K1 R=1 W={width} (m={m}, cap 2^20): {k_ms * 1e3:.2f} us/launch on the "
            f"card, bound {bound * 1e3:.3f} us (bytes), plain {p_ms * 1e3:.1f} us | {card}")

    batches, by_r = capture_batches(torch, np, rng)
    host = [(b[0].cpu().numpy(), b[2].cpu().numpy(), b[3].cpu().numpy()) for b in batches]
    bound = statistics.median(k1_multi_bound_ms(p, co, cs, CAP_SERVE) for p, co, cs in host)
    lanes = statistics.median(p.shape[1] for p, _, _ in host)
    real = statistics.median(in_range_lanes(p, CAP_SERVE) for p, _, _ in host)
    widest = statistics.median(b[4] for b in batches)
    n_clears = sum(int(co[-1]) for _, co, _ in host)
    log(f"[time] captured 16 five-round batches (K1 launches by rounds over the stream: "
        f"{by_r}); median L {lanes} lanes ({real} requests), widest round {widest}, "
        f"{n_clears} clears in all")
    for b in batches[:4]:  # warm up
        fs.multi_fused_step(state, *b[:4], widest=b[4])
    r5_ms = device_ms(torch, lambda i: fs.multi_fused_step(
        state, *batches[i % 16][:4], widest=batches[i % 16][4]), 160)
    log(f"[time] K1 on real 5-round batches: {r5_ms * 1e3:.2f} us/launch, "
        f"{r5_ms / 5 * 1e3:.2f} us/round; bound {bound * 1e3:.3f} us (bytes) | {card}")
    # A hot key alone, 200 times: 200 rounds of one request (32 lanes) in
    # one launch of one block — the per-round floor of barrier + lane chain.
    hot_n = 200
    hot = tk.pack_rounds_host(NOW0, CAP_SERVE, [1] * hot_n, np.full(hot_n, 12345, np.int32),
                              [np.zeros(hot_n, np.int64), np.zeros(hot_n, np.int64),
                               np.ones(hot_n, np.int64), np.full(hot_n, 10**6, np.int64),
                               np.full(hot_n, 60_000, np.int64), np.zeros(hot_n, np.int64),
                               np.zeros(hot_n, np.int64), np.zeros(hot_n, np.int64)],
                              [[] for _ in range(hot_n)])
    hot_dev = on_device(torch, hot)
    hot_ms = device_ms(torch, lambda i: fs.multi_fused_step(
        state, *hot_dev, widest=hot.widest), 20)
    out["hot"] = hot_ms
    log(f"[time] K1 on a hot-key batch forced onto rounds ({hot_n} rounds of 1 request, 1 "
        f"block): {hot_ms * 1e3:.1f} us/launch, {hot_ms / hot_n * 1e3:.2f} us/round | {card}")
    p_ms = host_ms(torch, lambda i: tk.multi_fused_step_reference(
        plain_state, *batches[i % 16][:4]), 16, windows=3)
    out["r5"] = (r5_ms, p_ms, bound)
    log(f"[time] plain multi-round step on the same batches: {p_ms * 1e3:.1f} us/call | {card}")

    meta = state.meta
    host_slots = []
    for i in range(16):
        c = np.arange(CAP_SERVE, CAP_SERVE + 1024, dtype=np.int64).astype(np.int32)
        c[:1000] = np.sort(rng.choice(CAP_SERVE, 1000, replace=False))
        host_slots.append(c)
    slots = [torch.from_numpy(c).cuda() for c in host_slots]
    k2_ms = device_ms(torch, lambda i: fs.clear_occupied(meta, slots[i % 16]), 200)
    k2_plain = host_ms(torch, lambda i: tk.clear_occupied_reference(meta, slots[i % 16]), 20)
    k2_bound = statistics.median(k2_bound_ms(c, CAP_SERVE) for c in host_slots)
    out["k2"] = (k2_ms, k2_plain, k2_bound)
    log(f"[time] K2 W=1024 (1000 clears, cap 2^20): {k2_ms * 1e3:.2f} us/launch, bound "
        f"{k2_bound * 1e3:.4f} us (bytes), plain {k2_plain * 1e3:.1f} us | {card}")
    pad = torch.arange(CAP_SERVE, CAP_SERVE + 16, dtype=torch.int32, device="cuda")
    floor_ms = device_ms(torch, lambda i: fs.clear_occupied(meta, pad), 200)
    out["floor"] = floor_ms
    log(f"[time] launch floor proxy, K2 over 16 padding lanes: {floor_ms * 1e3:.2f} us/launch "
        f"| {card}")
    del state, plain_state
    torch.cuda.empty_cache()

    # K3 on the zipf stream's chunks, over a state of the stream's size.
    zstate, zplain = tk.make_state(ZIPF_CAP, "cuda"), tk.make_state(ZIPF_CAP, "cuda")
    k3 = [args for args, _ in k3_calls]
    if all([check_layout(tk, pin) for pin, _ in k3]):
        log(f"[k3] the zipf stream's {len(k3)} collapsed pins meet K3's layout "
            "(check_collapsed)")
    else:
        log(f"[k3] {TREE} has no check_collapsed: the zipf stream's pins were not checked")
    for a in k3[:2]:
        collapsed_step(zstate, *a)
    k3_ms = device_ms(torch, lambda i: collapsed_step(zstate, *k3[i % len(k3)]), 40)

    def k3_plain(i):
        pin, clears = k3[i % len(k3)]
        tk.clear_occupied_reference(zplain.meta, clears)
        tk.collapsed_step_reference(zplain, pin)

    k3_plain_ms = host_ms(torch, k3_plain, len(k3), windows=3)
    k3_bound = statistics.median(k3_bound_ms(p.cpu().numpy(), c.cpu().numpy(), ZIPF_CAP)
                                 for p, c in k3)
    segs = statistics.median(in_range_lanes(p.cpu().numpy(), ZIPF_CAP) for p, _ in k3)
    out["k3"] = (k3_ms, k3_plain_ms, k3_bound)
    log(f"[time] K3 on {len(k3)} zipf chunks ({k3[0][0].shape[1]} lanes, median {segs} "
        f"segments, cap 2^24): {k3_ms * 1e3:.2f} us/launch, bound {k3_bound * 1e3:.3f} us "
        f"(bytes), plain {k3_plain_ms * 1e3:.1f} us | {card}")
    # K3 on one-key chunks (all 8192 lanes one key), on zipf chunks whose
    # slots spread over all 2^24 (the engine's are dense), and on such
    # chunks with clears (of segment slots and of 400 other slots).
    for kind, what in (("one", "one-key chunks"), ("zipf", "spread zipf chunks"),
                       ("foreign", "spread zipf chunks with clears")):
        cases = [collapsed_case(np, rng, ZIPF_CAP, kind, NOW0 + i) for i in range(8)]
        dev = [(torch.from_numpy(p).cuda(), torch.from_numpy(c).cuda()) for p, c in cases]
        collapsed_step(zstate, *dev[0])
        k_ms = device_ms(torch, lambda i: collapsed_step(zstate, *dev[i % 8]), 40)
        bound = statistics.median(k3_bound_ms(p, c, ZIPF_CAP) for p, c in cases)
        out[f"k3_{kind}"] = (k_ms, bound)
        n_clear = statistics.median(n_in_range(c, ZIPF_CAP) for _, c in cases)
        log(f"[time] K3 on {what} ({cases[0][0].shape[1]} lanes, median "
            f"{statistics.median(in_range_lanes(p, ZIPF_CAP) for p, _ in cases)} segments, "
            f"{n_clear} in-range clears, cap 2^24): {k_ms * 1e3:.2f} us/launch, bound "
            f"{bound * 1e3:.3f} us (bytes) | {card}")
    del zstate, zplain
    torch.cuda.empty_cache()

    # K4 on the uniform stream's batches.
    ustate, uplain = tk.make_state(CAP_SERVE, "cuda"), tk.make_state(CAP_SERVE, "cuda")
    k4 = [(args, kw["widest"]) for args, kw in k4_calls]
    k4_ms = device_ms(torch, lambda i: fs.multi_uniform_step(
        ustate, *k4[i % len(k4)][0], widest=k4[i % len(k4)][1]), 100)
    k4_plain_ms = host_ms(torch, lambda i: tk.multi_uniform_step_reference(
        uplain, *k4[i % len(k4)][0]), len(k4), windows=3)
    k4_bound = statistics.median(k4_bound_ms(*(t.cpu().numpy() for t in a), CAP_SERVE)
                                 for a, _ in k4)
    out["k4"] = (k4_ms, k4_plain_ms, k4_bound)
    log(f"[time] K4 on {len(k4)} uniform batches ({k4[0][0][0].shape[1]} lanes, "
        f"{k4[0][0][1].shape[0] - 1} round(s), cap 2^20): {k4_ms * 1e3:.2f} us/launch, bound "
        f"{k4_bound * 1e3:.3f} us (bytes), plain {k4_plain_ms * 1e3:.1f} us | {card}")
    # K4 on joined launches: R rounds of 1000 requests, slot 0 in every
    # round, clears in every round (lane slots and slots of no lane).
    for n_rounds in (2, 16):
        cases = [uniform_rounds(np, rng, CAP_SERVE, n_rounds, NOW0 + i, lanes=BATCH,
                                every_round=True) for i in range(8)]
        dev = [([torch.from_numpy(a).cuda() for a in c[:4]], c[4]) for c in cases]
        fs.multi_uniform_step(ustate, *dev[0][0], widest=dev[0][1])
        k_ms = device_ms(torch, lambda i: fs.multi_uniform_step(
            ustate, *dev[i % 8][0], widest=dev[i % 8][1]), 40)
        bound = statistics.median(k4_bound_ms(*c[:4], CAP_SERVE) for c in cases)
        out[f"k4_r{n_rounds}"] = (k_ms, bound)
        log(f"[time] K4 on joined launches of {n_rounds} uniform rounds of {BATCH} requests "
            f"(slot 0 in every round, clears in every round, cap 2^20): {k_ms * 1e3:.2f} "
            f"us/launch, {k_ms / n_rounds * 1e3:.2f} us/round, bound {bound * 1e3:.3f} us "
            f"(bytes) | {card}")
    return out


def main() -> int:
    global TREE
    ap = argparse.ArgumentParser(description="Smoke run of gubernator_tpu_torch on one GPU.")
    ap.add_argument("--tree", help="root of another checkout whose port to drive "
                    "(default: this script's own)")
    args = ap.parse_args()
    if args.tree:
        TREE = Path(args.tree).resolve()
        sys.path.insert(0, str(TREE))
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this smoke runs on a GPU", file=sys.stderr)
        return 2
    try:
        import numpy as np

        import gubernator_tpu_torch
        from gubernator_tpu_torch.ops import fused_step as fs
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here ({e}); run from the repo root",
              file=sys.stderr)
        return 2
    pkg = Path(gubernator_tpu_torch.__file__).resolve().parent.parent
    if TREE is not None and pkg != TREE:
        print(f"chip_smoke: imported the port from {pkg}, not from {TREE}", file=sys.stderr)
        return 2
    log(f"[tree] driving the port in {pkg}")
    t_start = time.perf_counter()
    rng = np.random.default_rng(SEED)
    card = phase_device(torch)
    phase_build()
    errs = {k: 0 for k in fs.launches}
    phase_kernels(torch, np, rng, errs)
    phase_k2(torch, np, rng, errs)

    # ---- the main path: counts from 0 just before, read just after.
    fs.reset_launches()
    engines, k3_calls, k4_calls = phase_engine(torch, np, rng)
    http_rate = phase_server(torch, np, rng, engines)
    main_launches = dict(fs.launches)
    rounds = sum(e.rounds_total for e in engines)
    dispatches = sum(e.dispatches_total for e in engines)
    clears = sum(e.clears_total for e in engines)
    flushes = sum(e._pump.flushes for e in engines)
    log(f"[main] launches {main_launches}; engine launches {dispatches}, rounds {rounds}, "
        f"clears {clears}, pump flushes {flushes}")
    check(main_launches["fused_step"] + main_launches["collapsed_step"]
          + main_launches["uniform_step"] == dispatches,
          "every engine launch of the main path must be a K1, K3 or K4 launch")
    for name in ("fused_step", "collapsed_step", "uniform_step"):
        check(main_launches[name] > 0, f"the main path must launch {name}")
    check(main_launches["clear_occupied"] == 0,
          "the main path's clears run inside K1 / K3 / K4, never as K2 launches")
    check(clears > 0, "the main path must clear evicted slots")
    check(flushes > 0, "the main path must run through the pump")
    for e in engines:
        e.close()
    del engines
    torch.cuda.empty_cache()

    phase_daemon_binary()
    times = phase_timing(torch, np, rng, card, k3_calls, k4_calls)
    log(f"[time] HTTP GetRateLimits on the card: {http_rate:.0f} decisions/s | {card}")
    phase_rates(torch, np, rng, card)

    # K1's row: one launch over a real 5-round batch (the engine's typical
    # launch); the R = 1 figures are in the [done] line.
    rows = [
        ("fused_step", "fused_step.cu", "gubernator_tpu/ops/pallas_step.py:67", times["r5"]),
        ("clear_occupied", "clear_occupied.cu", "gubernator_tpu/ops/bucket_kernel.py:329",
         times["k2"]),
        ("collapsed_step", "collapsed_step.cu", "gubernator_tpu/ops/bucket_kernel.py:1417",
         times["k3"]),
        ("uniform_step", "fused_step.cu", "gubernator_tpu/ops/bucket_kernel.py:1161",
         times["k4"]),
    ]
    kernels = {"kernels": [
        {"name": name, "route": "cuda", "source": f"gubernator_tpu_torch/csrc/{src}",
         "replaces": replaces, "launches": main_launches[name], "max_abs_err": errs[name],
         "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "bytes",
         "library_ms": None}
        for name, src, replaces, (ms, plain_ms, bound_ms) in rows
    ]}
    log(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s "
        f"(K1 R=1 W=1024: {times[1024][0] * 1e3:.2f} us, W=8192: {times[8192][0] * 1e3:.2f} us; "
        f"K1 per 5-round batch {times['r5'][0] * 1e3:.2f} us (the kernels line's ms); "
        f"K3 one-key {times['k3_one'][0] * 1e3:.2f} us, spread {times['k3_zipf'][0] * 1e3:.2f} "
        f"us, with clears {times['k3_foreign'][0] * 1e3:.2f} us; K4 joined R=2 {times['k4_r2'][0] * 1e3:.2f} "
        f"us, R=16 {times['k4_r16'][0] * 1e3:.2f} us; "
        f"launch floor {times['floor'] * 1e3:.2f} us)")
    print(json.dumps(kernels))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
