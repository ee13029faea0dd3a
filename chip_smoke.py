#!/usr/bin/env python3
"""Smoke run of gubernator_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's native code from gubernator_tpu_torch/csrc (the CUDA
kernels K1-K17 and the host libraries, one compiler each, in
parallel), holds each kernel against its plain PyTorch version on the
card at 2^20 and 10^8 slots (K1 over one round and over R ragged rounds
with eviction clears; K3, the collapsed hot-key step, on a zipf batch, a
one-key batch, the extreme-value batch, chunks with clears of segment
slots and of other slots, and a mostly-padding chunk; K4, the uniform
format, over 1, R and 16 ragged rounds with clears and a round that one
block's slot range holds whole; K2 alone, and K2 then K5 as a
restoring round launches them (clears {16, 1000} x records {16, 4096},
half the clears on slots the record restores, clears alone and records
alone); K5, the restore, on 16..4096-lane records with padding and
extreme values; K14, K15 and K16, the split arm's compute and scatter
kernels, on mixed batches of 1000 and zipf chunks of 8192; K17, the
dataclass step, on unsorted batches of 64, 1000 (padded to 1024) and
8192 lanes with clears of their own slots and of others, a
mostly-padding batch and the extreme values, also against K1 on the
same lanes sorted (state words equal); K6, the expiry sweep, on one
16-window tick and, at 10^8, a full pass ending in a clamped window,
with expiries at now - 1, now and now + 1 whose low words have bit 31
set; K7, the count-min sketch's step, and K8, its window rotation, at
depth 4 and widths 2^20 and 2^24 on zipf batches of 1000 and 8192 keys
with a saturating hot key, negative counts read at frac != 0 and an
all-padding tail, K8 on one plane and on both, and K7 in each form it can
take (the block form, one launch, and the pair form, two) on pins of 64
to 16384 lanes), then drives
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

A second path, the persistence and expiry path, is driven the same way,
card against CPU: `get_rate_limits` with a write-through MemoryStore on
the mixed stream at 2^20 slots and on a 4096-slot variant whose evicted
keys come back from the store at rounds k > 0 (clear, restore, apply:
K2, K5, K1; one K5 and at most one K2 a restoring round is checked); a checkpoint saved through NpzFileLoader and loaded into a
fresh card engine that continues as the engine that never stopped; a
sweep (K6) with new keys onto the freed slots; and the daemon with a
loader, a store and a 0.2 s sweep interval over HTTP, closed and
respawned from its checkpoint.  Its launches count from 0 apart from
the main path's (K1, K2, K5 and K6 launched, K3 and K4 not).

A third path, the sketch path, counts its launches from 0 too: one
V1Instance on the card and one on the CPU answer 40 batches of 1000
items (about 60 % SKETCH, some of them GLOBAL or MULTI_REGION too, 20 %
GLOBAL, 20 % plain) and six small ones (1 to 300 items) with the clock
stepping inside a window, by exactly one window and by gaps of two or
more (answers, both planes, epoch and plane index compared), and the
daemon, configured by GUBER_SKETCH_*, answers the same kind of batches
over HTTP (bodies compared).  K7 must launch once per apply with sketch
items, in the block form for the small batches and the pair form for the
others (its calls by form, on a port that counts them), K8 at least
once.

A fourth path, the h2 path (the native h2 front, net/h2_fast.py, into
apply_columnar), counts its launches from 0 as well, once for each of
its two runs.  It runs twice: with
the front's columnar feeder (the default ingest: csrc/columnar_feeder.cpp
packs each RPC into a ring of column windows in the connection threads,
and the feeder's own thread serves a window at a time) and with
GUBER_NATIVE_FEEDER=0 (the byte window path).  Each time the port's
daemon on the card (2^20 slots, frozen clock, its front from
GUBER_H2_FAST_ADDRESS's config) and a CPU instance behind its own front,
with the feeder alike, answer the same 30 sequential RPCs of 1000 items
over HTTP/2 (a short stdlib client here, `H2Unary`; the card's machine
has no grpcio): grpc-status and response bytes equal RPC by RPC, the
metadata map included (`decode_responses` reads it: with the feeder
every OVER_LIMIT item carries retry_after_ms = reset - now, without it
none does), a GLOBAL, a Gregorian, a SKETCH and an empty-key RPC
UNIMPLEMENTED, a zero-item RPC empty OK, state words equal, every window
on one thread (the feeder's serve thread, or the C dispatch thread) on
the default stream, and with the feeder every in-scope RPC answered by
it (`feeder_front_rpcs`) and no byte window but the declined RPCs'; 8
plain RPCs and a GLOBAL one sent at once to a 50 ms window (the plain
ones served as a CPU front serves them, in one feeder window or one byte
window, the GLOBAL one UNIMPLEMENTED); the reference's "herdfast" shape
through the port's native client (32 connections of single-item RPCs on
one key for 2 s: no errors, the key's remaining within its bound); and a
1-connection closed loop of one 1000-item leaky-bucket RPC for 3 s, at
the 2 ms window and with none.  In each run its engine launches are all
K1, K3 or K4, and each of them runs.  The daemon binary is also started
with GUBER_H2_FAST_ADDRESS and answers one RPC there.  Since the decision
ledger is on by default, the parity daemon and its CPU twin run it (no
settle thread: both settle by hand before the state words compare), the
herd's daemon attaches its native plane, and the isolation phase turns it
off (the card serves its 9 RPCs as one window, the CPU as 9).

A fifth path, the ledger path (core/ledger.py and the native decision
plane, the reference's default hot-key path), counts its launches from 0
too: (a) a V1Instance on the card and one on the CPU (2^20 slots, frozen
clocks, no settle thread) answer 60 batches — 1000-item ones through
serve_decoded_local, 200-item ones with Gregorian items through
get_rate_limits — 30 % on 64 hot keys whose leases are granted, drained
and revoked (RESET_REMAINING, limit and duration changes, over-asks,
negative hits, TTL expiry) and whose sticky OVER lives across resets:
answers equal row for row, and after flush_settles the return counts,
ledger counters and every slot's state words; (b) the daemon on the live
clock, its h2 front with the plane: 60 single-item RPCs on one key answer
limit-1 .. limit-60 exactly, some in C, an HTTP request continues at
limit-61 and h2 at limit-62; (c) 32 connections on a key whose limit is
below the hits sent, 2 s: UNDER answers at most the limit, and once the
plane is pulled and the key settled the device holds exactly limit -
UNDER; (d) the herd's RPCs/s, p50 / p99 and share answered in C with the
ledger and with GUBER_LEDGER=0.  K1 must launch; every launch is K1, K3
or K4; and K1 is held to its plain version on launches whose lanes begin
with the ledger's negative-hit return rows.

A sixth path, the paged path (GUBER_PAGED, core/paging.py), counts its
launches from 0 too.  (a) Parity, the shape of the reference's zipfpaged
bench (BENCH_r18_cpu_zipfpaged.json: pages of 64, 1024 frames = 65,536
resident rows, 655,360 logical keys): a paged card engine, a paged CPU
engine and a dense card engine at 655,360 take a fill of every key in
batches of 8192, then zipf(1.2) over the keys in a seeded order in
batches of 1024, with the hot-key sketch's provider on the eviction
clock: answers equal (paged against dense too), and the counters, the
page table, the host words of used pages and the device words card
against CPU; then a checkpoint through NpzFileLoader loaded with no
fault (cold pages restored into the host store), and sweeps that free
every expired key, cold pages from the host words, with no fault.  (b)
The full width: pages of 512 (the default), 2^24 resident rows (the zipf
deployment's device size) and 2^25 logical keys, filled in batches of
8192, then zipf(1.2) over the keys in a seeded order in batches of 8192,
each batch answered as a dense card engine at 2^25 answers it: faults
per batch, the mean fault, spill and refill wall a page, the fault wall
split into victim picks, host copies and bookkeeping, and launch-and-wait,
decisions/s, K9 / K10 launches and the device's busy and idle share,
beside the card's pinned-copy rate (64 MiB each way).  (c) K9 and K10 are
held bit-equal to their plain versions at P = 16, 64 and 512 with k = 1
and 64 pages, starts at row 0 and at the last frame, on state with bit 31
set in the `*_lo` words; a fault batch (the staged copy up, K9, the copy
home, K10) is timed at P = 512 beside its PCIe bound, and K9 and K10
beside their bound and one PyTorch call each: torch.stack of the pages'
column slices (K9), torch._foreach_copy_ into them (K10).

A seventh path, the sharded path (parallel/sharded_engine.py, the
reference's single-program sharded engine on one card), counts its
launches from 0 too; K11 (a batch's rounds of every shard in one
launch, or one round), K12 (the per-shard collapsed chunk) and K13 (the
sweep windows of every shard, one window and a group of 16 from the end
of a pass) are held bit-equal to their plain versions first, at 8 shards
x 2^16 and 4 x 2.5 x 10^7 with padding lanes, an empty shard and clears
(K11 also over batches of 1, 2, 4 and 8 rounds with clears in every
round, K12 at 64 to 4096 lanes a shard).  (a) Card against
CPU at 8 shards x 2^16: a fill of 700,000 keys (evictions), zipf(1.1)
columnar batches of 8192 (the flat K1 / K3) and get_rate_limits batches
of 1000 (K11, K12), Gregorian minutes on 1 key in 7, sweeps (K13), a
store engine whose swept keys
come back from the store (K5), and one of 2 slots a shard whose keys
come back in rounds after the first (K11, K2 + K5, K11): answers, state
words and stores equal.  (b) The full size, BASELINE.json configs[3] (the
north star's v5e-4, one shard a chip): 4 shards x 2.5 x 10^7 slots,
10^8 key ranks, half token half leaky, zipf(1.1) and spread batches of
8192 through apply_columnar and of 1000 through V1Instance, each answered
as a dense card engine of 10^8 slots answers it; decisions/s a route,
the launches a route (and the rounds and K11 launches of each V1Instance
batch), the device's idle share; a save / load of the whole state (timed)
and one K13 sweep pass.  (c) The daemon with
GUBER_DEVICE_COUNT=4 answers the h2 parity stream byte for byte as the
same daemon on the CPU.

An eighth path, the split path (GUBER_FUSED=split, the reference's A/B
control), counts its launches from 0 too: a split engine on the card and
one on the CPU answer the mixed (2^20 slots), evict (4096), zipf (2^24,
batches of 8192: K16), store (4096 slots with a MemoryStore: restores)
and paged (pages of 64, 32 frames, 65,536 keys) streams, answers, state
words, stores and page tables equal; every launch is a round's clear
launch, K14, K15 or K16 (or K2 + K5, K9, K10), at least two a round.
After the count the card's fused engine answers the same streams with the
same answers and words, and the split and fused engines' decisions/s and
launches a round on the mixed stream are printed.

A ninth path, the apply_batch path, counts its launches from 0 too: the
public dataclass step `gubernator_tpu_torch.ops.apply_batch` on a 2^20
state on the card and one on the CPU, 24 batches of 1000 (padded to
1024, lanes unsorted, evicted slots cleared and reused in the same
batch): answers and state words equal, one K17 launch a batch and no
other.

A tenth path, the obs path, counts its launches from 0 too: with
GUBER_TRACING=memory (the tail recorder at threshold 0), the native event
ring, the hot-key sketch and the SLO watchdog on, a card daemon and its
CPU twin answer the mixed stream (2^20 slots, batches of 1000) and the
zipf stream (2^24 slots, batches of 8192, in RPCs of 1000: the fronts'
cap) over the h2 front and HTTP:
answers equal, span trees equal trace by trace (names, nesting,
attributes), state words equal; then the card's /debug/vars must show
engine_serve, device.step and device.readback counted with quantiles and
the ring's reactor and feeder stages, /debug/trace trees under
service.get_rate_limits with engine.* children, /debug/hotkeys the zipf
stream's hot keys and /debug/slo its status.  Every launch is K1, K3 or
K4.  After the count, the card daemon's h2 decisions/s on the mixed
stream with each of GUBER_TRACING, GUBER_NATIVE_EVENTS, GUBER_HOTKEYS and
GUBER_OBS off and on (turns off, on, on, off) are printed.

An eleventh path, the metrics path, counts its launches from 0 too: a
card daemon and its CPU twin, each with its status listener
(GUBER_STATUS_HTTP_ADDRESS), GUBER_METRIC_FLAGS=all, GUBER_OBS and the h2
front, answer the mixed stream (2^20 slots, batches of 1000) and the zipf
stream (2^24 slots, batches of 8192 in RPCs of 1000) over h2 and HTTP,
answers equal; then /metrics, /metrics?exemplars=1 (OpenMetrics) and
/metrics?fleet=1 are scraped on both listeners of both: the card's text
equals the twin's in every family, HELP, TYPE, label set and counted
value (the time-valued samples, named in METRICS_TIME_VALUED, by presence
only), the listeners give the same families, and no scrape launches a
kernel.  Every launch is K1, K3 or K4.  The line `[metrics]` gives the
families, the samples and the p50 / p99 of 100 scrapes.  The daemon
binary is started with `-config FILE`, GUBER_DEBUG=true in the file: the
file's status listener answers with its metric flag's families, and the
log shows DEBUG.

A twelfth path, the cluster path, counts its launches from 0 too: two
card daemons with static peers (cluster/harness.py, 2^20 slots each, the
gRPC listener) and a CPU twin cluster take one seeded stream of
1000-item RPCs (mixed, zipf, and one config over distinct keys) sent
alternately to both nodes through the port's unary client, and three
through the HTTP gateways.  Each key's owner answers it; the other node
forwards it as PeersV1/GetPeerRateLimits.  The card's answers equal the
twin's, `metadata.owner` names the node the cluster's ring names, both
nodes forward items and receive GetPeerRateLimits RPCs, and each card
node launches K1, K3 and K4.  `[cluster readings]` times forwarded
1000-item RPCs; `[cluster down]` stops node 1 and sends one of its keys
to node 0: a degraded answer, then the reference's error with degraded
mode off.

After the paths, the san phase runs the port's own native code under
sanitizers.  (a) The host C++ (csrc/*.cpp), built with GUBER_NATIVE_SAN's
flags, in child processes that have the sanitizer's runtime in
LD_PRELOAD, never touch CUDA and never fork once their C threads run,
while this process drives them: under ThreadSanitizer the h2 front on
the thread-per-connection plane and on the reactor plane (a flat window
callback, the columnar feeder with windows of 8 rows, the decision
plane's lease pulled and re-granted, the event ring drained throughout,
loaded for a few seconds by the port's native client over churning
connections), the feeder alone (C and Python producers), the decision
plane alone (serves, grants, pulls, peeks) and git_multi_schedule's
pool against its serial run; under AddressSanitizer the front, the codec
and the plane on malformed bodies (truncated varints, lengths past the
end, huge counts, empty and huge keys, seeded random bytes), each
answered and decoded as this process's plain front and codec do.  Any
report fails the phase.  (b) compute-sanitizer's four tools over K1-K17
at small shapes (`--san kernels`) are left out of the full run: on the
card's machine the tool answers "Error: Device not supported" even for a
plain CUDA program; the kernel cases it would run are held to their
plain versions without it.

It checks the launch counts of the main path (K1, K3 and K4 all launched; K1
at most once per synchronous batch; the pump flushed), holds the zipf
stream's collapsed pins to K3's layout (`check_collapsed`), and times
every kernel on the shapes the main path gave it, beside its bytes bound
and its plain version (K3 also on one-key and spread zipf chunks without
and with clears, K4 also on joined launches of 2 and 16 rounds; K5 per 4096-record restore, its
split (16, 1024 and 4096 random slots at caps 2^20 and 10^8 and 4096
contiguous ones at 10^8, beside an empty kernel, the launch floor) and
K6 per 2^17-slot window and per group of 16 windows (one launch, the
engines' sweep) at 10^8 slots, the wall time of a 16-window sweep tick,
K13 per window and per group of 16 over 4 x 2.5 x 10^7, a save / load
round trip at 2^20; K7 per batch of 48, 192, 1000, 8192 and 32768 keys
(the block form's sizes also in the pair form) and K8 on one plane and
on both at widths 2^20 and 2^24,
beside `zero_()` on the same span), apply_columnar's decisions/s on each stream, and the h2 path's
RPCs/s, p50 and p99 (herd and 1000-item loop, feeder on and off) and
byte windows per RPC.  Any
failed phase exits non-zero before the result lines.  The last three
lines of standard output are the kernels JSON line, the card's
`name, power.limit` from nvidia-smi, and {"ok": true, "device": {...}}.

    python3 chip_smoke.py --tree DIR

runs the same phases on the same seeded inputs against the port of
another checkout (DIR, its root: for instance the parent commit unpacked
with `git archive`), so that two trees are compared in one session on
one card.  A tree from before `check_collapsed` existed runs without
that layout check; one without K5 / K6, K7 / K8, the h2 front, K9 /
K10 or the sharded engine skips the persistence, the sketch, the h2, the
ledger, the paged or the sharded phases; one without K7's plan skips the
holds and timings of its forms.

    python3 chip_smoke.py [--tree DIR] --readings [k2k5|k11]

runs only the readings of a parent / change comparison (turns parent,
change, change, parent), and prints no result lines.  k2k5 (the
default): a restoring round's clears and restores held against clear
then restore and timed as the driven port runs them (K2 then K5) at
clears {16, 1000} x records {16, 4096}, clears alone {16, 1000} and
records alone {16, 4096}, at caps 2^20 and 10^8; K1 (R = 1, W 1024 and 8192) and K3
(one-key and spread zipf chunks) timed; and the walls of the
persistence path's restoring batches and of the sharded restore stream.
k11: K11's and K12's holds and timings (K11 over batches of 1, 2, 4 and
8 rounds at 4 x 2.5 x 10^7 and 8 x 2^16; K12 at 64, 512, 1024 and 4096
lanes a shard) and sharded path (b)'s dataclass route.

    python3 chip_smoke.py --san [host|kernels]

runs only the build and one half of the san phase, and prints no result
lines: host (the default) the host stresses, kernels the four
compute-sanitizer tools, each over a child (`--san-kernels`) that
launches K1-K17 at small shapes between marker lines, and counts the
tool's error records between each kernel's markers.

The port imports nothing of JAX; neither does this script.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import itertools
import json
import os
import statistics
import subprocess
import sys
import tempfile
import threading
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
    """K2 alone (clears of width 16 / 128 / 1024 on the meta column), then
    K2 then K5 as a restoring round launches them (`hold_clear_restore`),
    at 2^20 and 10^8 slots."""
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
        if "load_slots" in fs.launches:
            kern = random_state(torch, cap, NOW0, int(rng.integers(2**31)))
            plain = copy_state(kern)
            hold_clear_restore(torch, np, rng, errs, kern, plain, cap)
            del kern, plain
            torch.cuda.empty_cache()


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


def phase_daemon_binary(has_h2: bool):
    """`python -m gubernator_tpu_torch.cmd.daemon` on the card: it binds,
    answers (a sketch item too, with GUBER_SKETCH_* set; one RPC on its h2
    front too, with GUBER_H2_FAST_ADDRESS set), and exits 0 on SIGTERM.
    On a port with `-config`, its settings come from a KEY=VALUE file
    with GUBER_DEBUG=true: the file's status listener answers health and
    /metrics with GUBER_METRIC_FLAGS=os's families, and the log shows a
    DEBUG record."""
    import signal

    from gubernator_tpu_torch import config as port_config
    from gubernator_tpu_torch.ops import fused_step as fs

    settings = dict(GUBER_HTTP_ADDRESS="127.0.0.1:0", GUBER_CACHE_SIZE=str(CAP_SERVE),
                    GUBER_SKETCH_WINDOW="1m", GUBER_SKETCH_WIDTH=str(1 << 16))
    if has_h2:
        settings["GUBER_H2_FAST_ADDRESS"] = "127.0.0.1:0"
    with_file = hasattr(port_config, "load_env_file")
    tmp = Path(tempfile.mkdtemp(prefix="guber-daemon-"))
    argv = [sys.executable, "-m", "gubernator_tpu_torch.cmd.daemon"]
    env = dict(os.environ)
    if with_file:
        settings.update(GUBER_DEBUG="true", GUBER_STATUS_HTTP_ADDRESS="127.0.0.1:0",
                        GUBER_METRIC_FLAGS="os")
        conf = tmp / "guber.env"
        conf.write_text("# the daemon's settings\n\n"
                        + "".join(f"{k}={v}\n" for k, v in settings.items()))
        argv += ["-config", str(conf)]
        for k in settings:
            env.pop(k, None)
    else:
        env.update(settings)
    import gubernator_tpu_torch

    root = Path(gubernator_tpu_torch.__file__).resolve().parent.parent  # the port driven
    err_path = tmp / "stderr.log"
    err = open(err_path, "w")
    proc = subprocess.Popen(argv, stdout=subprocess.PIPE, stderr=err, text=True, env=env,
                            cwd=root)
    try:
        line = proc.stdout.readline().strip()
        check(line.startswith("listening http="), f"[daemon] no readiness line: {line!r}")
        fields = dict(f.split("=", 1) for f in line.split()[1:])
        addr = fields["http"]
        if has_h2:
            c = H2Unary(fields["h2"])
            try:
                status, msg = c.call(encode_get_rate_limits([("h2", "b", 1, 3, 1000, 0, 0, 0)]))
            finally:
                c.close()
            check(status == 0 and decode_responses(msg)[0][2] == 2,
                  f"[daemon] h2 answer: {status} {msg!r}")
        items = [{"name": "a", "unique_key": "b", "hits": 1, "limit": 3, "duration": 1000}]
        if "sketch_step" in fs.launches:
            items.append({"name": "a", "unique_key": "s", "hits": 2, "limit": 3,
                          "duration": 1000, "behavior": 32})
        body = json.dumps({"requests": items}).encode()
        with urllib.request.urlopen(urllib.request.Request(
                f"http://{addr}/v1/GetRateLimits", data=body, method="POST"), timeout=60) as r:
            resps = json.loads(r.read())["responses"]
        check(resps[0]["remaining"] == "2", f"[daemon] answer: {resps}")
        if len(resps) > 1:  # the sketch item: window 1m from GUBER_SKETCH_WINDOW
            check(resps[1]["remaining"] == "1" and int(resps[1]["reset_time"]) % 60_000 == 0,
                  f"[daemon] sketch answer: {resps}")
        if with_file:
            check("status" in fields, f"[daemon] no status listener in {line!r}")
            health = json.loads(http_json(f"http://{fields['status']}/healthz"))
            text = http_json(f"http://{fields['status']}/metrics").decode()
            check(health.get("status") == "healthy"
                  and "# TYPE process_resident_memory_bytes gauge" in text
                  and "\ngubernator_check_counter_total 0.0\n" not in text
                  and "\ngubernator_check_counter_total " in text
                  and "python_info" not in text,
                  f"[daemon] the -config file's status listener: {health}, "
                  f"{text[:200]!r}")
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=60)
        err.flush()
        log_text = err_path.read_text()
        check(rc == 0, f"[daemon] exit code {rc} after SIGTERM: {log_text[-2000:]}")
        if with_file:
            check(f"DEBUG gubernator_tpu_torch config file {conf} loaded" in log_text,
                  f"[daemon] GUBER_DEBUG=true in the -config file logged no DEBUG record: "
                  f"{log_text[-2000:]}")
        log("[daemon] python -m gubernator_tpu_torch.cmd.daemon"
            + (" -config FILE (GUBER_DEBUG=true: DEBUG records logged; its status listener "
               "served /metrics with the os flag's families)" if with_file else "")
            + " answered on the card"
            + (" over HTTP and its h2 front" if has_h2 else "") + ", exited 0 on SIGTERM")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        proc.stdout.close()
        err.close()
        for f in tmp.iterdir():
            f.unlink()
        tmp.rmdir()


def device_ms(torch, launch, n: int, windows: int = 7, before=None) -> float:
    """Median device time per launch: `n` launches queued behind a spin
    kernel (so host launch overhead does not starve the card), timed
    with CUDA events; the median over `windows`.  `before()`, if given,
    runs ahead of each window's spin, outside the timing."""
    per = []
    for _ in range(windows):
        if before is not None:
            before()
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


# ---------------------------------------------------------------------------
# The persistence and expiry path: K5 (restore) and K6 (sweep), with K1 and K2


class SweepHolder:
    """What `ops.expiry.windowed_sweep` reads of an engine: a state, a
    cursor and the window (the engine's `SWEEP_WINDOW`)."""

    SWEEP_WINDOW = 1 << 17

    def __init__(self, state):
        self._state = state
        self._sweep_cursor = 0


def restore_record(np, rng, cap: int, width: int, now: int, n=None):
    """A restore buffer (`pack_restore_host`) of n sorted unique slots
    (default: 1..width at random) padded to `width` with cap + lane, with
    extreme values: negative and > 2^43 timestamps and durations, leaky
    fraction words >= 2^31, limit and burst >= 2^32, odd algo / status."""
    from gubernator_tpu_torch.ops.bucket_kernel import RESTORE_FIELDS, pack_restore_host

    n = int(rng.integers(1, width + 1)) if n is None else n
    rec = {k: np.zeros(width, np.int64) for k in RESTORE_FIELDS}
    rec["slot"] = np.arange(cap, cap + width, dtype=np.int64)
    rec["slot"][:n] = np.sort(rng.choice(cap, n, replace=False))
    big = np.array([2**32, 2**40 + 5, 2**62, -(2**35), -7, 0, 10, 10**6])
    ts = np.array([-5, 0, 2**43 - 1, 2**43, 2**50, now, now + 60_000, now - 1])
    rec["algo"][:n] = rng.choice(np.array([0, 1, 2, -1]), n)
    rec["status"][:n] = rng.choice(np.array([0, 1, 3, -2]), n)
    for k in ("limit", "burst", "remaining"):
        rec[k][:n] = rng.choice(big, n)
    rec["remf_hi"][:n] = rng.integers(-(2**31), 2**31, n)
    rec["remf_lo"][:n] = rng.integers(0, 2**32, n)
    for k in ("t0", "expire_at", "invalid_at", "duration"):
        rec[k][:n] = rng.choice(ts, n) + rng.integers(0, 3, n)
    for k in ("slot", "algo", "status", "remf_hi"):
        rec[k] = rec[k].astype(np.int32)
    rec["remf_lo"] = rec["remf_lo"].astype(np.uint32)
    return pack_restore_host(rec)


def arm_expiries(torch, state, now: int, seed: int) -> None:
    """A quarter of the slots expire at now - 1, now or now + 1; `now`'s
    low word has bit 31 set, so theirs do too (the unsigned compare)."""
    check((now & 0xFFFFFFFF) >> 31 == 1, "the sweep's instant must have bit 31 set in its low word")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    cap = state.meta.shape[0]
    pick = torch.rand(cap, generator=gen, device="cuda") < 0.25
    exp = now + torch.randint(-1, 2, (cap,), generator=gen, device="cuda", dtype=torch.int64)
    hi2 = state.hi2.to(torch.int64)
    state.hi2.copy_(torch.where(pick, (hi2 & ~0x7FF) | (exp >> 32), hi2).to(torch.int32))
    lo = (((exp & 0xFFFFFFFF) ^ 0x80000000) - 0x80000000).to(torch.int32)
    state.expire_lo.copy_(torch.where(pick, lo, state.expire_lo))


def k5_bound_ms(rec, cap: int) -> float:
    """Least time for one K5 launch: an in-range lane reads its 19 record
    words (76 B) and writes 12 state words (48 B); a padding lane reads
    its slot (4 B)."""
    s = rec[0].astype("int64")
    n = int(((s >= 0) & (s < cap)).sum())
    return (n * (76 + 48) + (len(s) - n) * 4) / HBM_BYTES_PER_S * 1e3


def k6_bound_ms(window: int, freed: int) -> float:
    """Least time for one K6 window: meta, hi2 and expire_lo read once per
    slot (12 B), each freed slot's index and meta word written (8 B), and
    the 4 B count."""
    return (12 * window + 8 * freed + 4) / HBM_BYTES_PER_S * 1e3


def has_sweep_groups() -> bool:
    """Whether the driven port sweeps a group of windows in one launch
    (`ops.expiry.sweep_windows`); a --tree checkout from before launches
    one window at a time."""
    from gubernator_tpu_torch.ops import expiry

    return hasattr(expiry, "sweep_windows")


def sweep_group(meta, hi2, expire_lo, now: int, starts, window: int, n_sh: int = 0):
    """The windows of `starts` swept in order, as the driven port's engines
    sweep a group: one launch (`sweep_windows`, K13 with n_sh), or on an
    older port one launch a window.  Returns [window][shard] outputs;
    n_sh = 0 is the dense state (K6)."""
    from gubernator_tpu_torch.ops import expiry

    if has_sweep_groups():
        out = (expiry.shard_sweep_windows(meta, hi2, expire_lo, n_sh, now, starts, window)
               if n_sh else expiry.sweep_windows(meta, hi2, expire_lo, now, starts, window))
        return list(out)
    if n_sh:
        return [expiry.shard_sweep_window(meta, hi2, expire_lo, n_sh, now, s, window)
                for s in starts]
    return [expiry.sweep_window(meta, hi2, expire_lo, now, s, window)[None] for s in starts]


def sweep_group_plain(meta, hi2, expire_lo, now: int, starts, window: int, n_sh: int = 0):
    """`sweep_group`'s plain version: the windows one after another."""
    from gubernator_tpu_torch.ops import expiry

    return [expiry.shard_sweep_window_reference(meta, hi2, expire_lo, max(n_sh, 1), now, s,
                                                window) for s in starts]


def plain_window_fn():
    """The plain window function `windowed_sweep` takes on the driven port."""
    from gubernator_tpu_torch.ops import expiry

    return (expiry.sweep_windows_reference if has_sweep_groups()
            else expiry.sweep_window_reference)


def same_sweep(torch, got, want) -> int:
    """The largest difference between two `sweep_group` results over each
    row's count and freed prefix (0: equal)."""
    err = 0
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            c = int(b[0])
            err = max(err, int((a[: 1 + c].long() - b[: 1 + c].long()).abs().max().item()))
    return err


def phase_persist_kernels(torch, np, rng, errs):
    """K5 and K6 against their plain versions on the card at 2^20 and 10^8
    slots: restores of 16..4096 lanes with padding and extreme values
    (every state word bit-equal), then one 16-window sweep tick, and at
    10^8 a full pass from the cursor at 0 that ends in a clamped window
    (counts, freed slots in release order and meta bit-equal)."""
    from gubernator_tpu_torch.ops import bucket_kernel as tk
    from gubernator_tpu_torch.ops import expiry
    from gubernator_tpu_torch.ops import fused_step as fs

    for cap in (CAP_SERVE, CAP_NORTH_STAR):
        kern = random_state(torch, cap, NOW0, int(rng.integers(2**31)))
        arm_expiries(torch, kern, NOW0, int(rng.integers(2**31)))
        plain = copy_state(kern)
        for width in (16, 64, 256, 1024, 4096):
            for _ in range(2):
                rec = torch.from_numpy(restore_record(np, rng, cap, width, NOW0)).cuda()
                fs.load_slots(kern, rec)
                tk.load_slots_reference(plain, rec)
        torch.cuda.synchronize()
        err = compare_states(torch, kern, plain)
        errs["load_slots"] = max(errs["load_slots"], err)
        check(err == 0, f"K5 differs from its plain version at cap {cap}: err {err}")
        log(f"[k5] cap {cap}: 10 restores of 16..4096 lanes (padding, extreme values) "
            "bit-equal to the plain restore (tolerance: exact)")
        hk, hp = SweepHolder(kern), SweepHolder(plain)
        passes = [("one tick of 16 windows", 16)]
        if cap == CAP_NORTH_STAR:
            passes.append(("a full pass from window 0", None))
        for what, max_w in passes:
            hk._sweep_cursor = hp._sweep_cursor = 0
            fk, fp = [], []
            nk = expiry.windowed_sweep(hk, cap, NOW0, max_w,
                                       lambda f, st: fk.append(f + st) or len(f))
            npl = expiry.windowed_sweep(hp, cap, NOW0, max_w,
                                        lambda f, st: fp.append(f + st) or len(f),
                                        window_fn=plain_window_fn())
            ak, ap = np.concatenate(fk), np.concatenate(fp)
            err = max(abs(nk - npl), compare_states(torch, (kern.meta,), (plain.meta,)),
                      0 if np.array_equal(ak, ap) else max(1, abs(len(ak) - len(ap))))
            errs["sweep_window"] = max(errs["sweep_window"], err)
            check(err == 0 and (nk > 0 or max_w is None), f"K6 differs from its plain version at cap {cap} "
                  f"({what}): freed {nk} vs {npl}, err {err}")
            n_win = len(fk)
            last = min((n_win - 1) * SweepHolder.SWEEP_WINDOW, cap - SweepHolder.SWEEP_WINDOW)
            log(f"[k6] cap {cap}, {what} ({n_win} windows of 2^17, the last at {last}"
                f"{', clamped' if last % SweepHolder.SWEEP_WINDOW else ''}): {nk} freed; count, "
                "freed slots in order and meta bit-equal to the plain sweep (tolerance: exact)")
        del kern, plain, hk, hp
        torch.cuda.empty_cache()


class StoreTrace:
    """Counts, on a card engine, the restores of a slot that was cleared
    just before them in a batch whose earlier rounds were already
    submitted (the clear → restore → apply order at a round k > 0), and
    the (K2, K5) launches each restoring round made (`per_round`)."""

    def __init__(self, eng):
        from gubernator_tpu_torch.ops import fused_step as fs

        self.events, self.hits, self.per_round = [], 0, []
        submit, clears, restores = eng._pump.submit, eng._apply_clears, eng._apply_restores
        mark = [0]

        def on_submit(packed):
            self.events.append(("submit", set()))
            return submit(packed)

        def on_clears(c):
            self.events.append(("clear", {int(x) for x in c}))
            mark[0] = k2_k5(fs)
            clears(c)

        def on_restores(r):
            ev = self.events[-2:]
            if [e[0] for e in ev] == ["submit", "clear"] and ev[1][1] & {s for s, _ in r}:
                self.hits += 1
            start = mark[0] if self.events and self.events[-1][0] == "clear" else k2_k5(fs)
            self.events.append(("restore", set()))
            restores(r)
            end = k2_k5(fs)
            self.per_round.append((end[0] - start[0], end[1] - start[1]))

        eng._pump.submit, eng._apply_clears, eng._apply_restores = on_submit, on_clears, on_restores


def words_by_key(np, eng):
    """(live keys sorted, their 12 state columns in that order)."""
    from gubernator_tpu_torch.ops.bucket_kernel import state_to_numpy

    w = state_to_numpy(eng.state)
    live = np.nonzero(w["meta"] & 1)[0]
    keys = [eng.table.key_for_slot(int(x)) for x in live]
    order = np.argsort(np.array(keys, dtype=object))
    return [keys[i] for i in order], {f: a[live[order]] for f, a in w.items()}


def same_engines(np, a, b, what: str, *, slots: bool, path: str = "persist") -> None:
    """Live keys' words equal; with `slots`, every slot's words and key.
    `path` and `what` name the case in the failure messages."""
    from gubernator_tpu_torch.ops.bucket_kernel import state_to_numpy

    if slots:
        wa, wb = state_to_numpy(a.state), state_to_numpy(b.state)
        for f in wa:
            check(np.array_equal(wa[f], wb[f]), f"[{path}] {what}: state column {f} differs")
        live = np.nonzero(wa["meta"] & 1)[0]
        check(all(a.table.key_for_slot(int(x)) == b.table.key_for_slot(int(x)) for x in live),
              f"[{path}] {what}: keys differ by slot")
    ka, wa = words_by_key(np, a)
    kb, wb = words_by_key(np, b)
    check(ka == kb, f"[{path}] {what}: live keys differ")
    for f in wa:
        check(np.array_equal(wa[f], wb[f]), f"[{path}] {what}: words of column {f} differ")


def store_stream(torch, np, rng, cap, batches, tag):
    """get_rate_limits batches through a card engine and a CPU engine, each
    with a MemoryStore: answers, state words and stores equal."""
    from gubernator_tpu_torch.clock import Clock
    from gubernator_tpu_torch.core.engine import DecisionEngine
    from gubernator_tpu_torch.store import MemoryStore

    ns = NOW0 * 1_000_000
    gpu = DecisionEngine(cap, clock=Clock().freeze_at(ns), device="cuda", store=MemoryStore())
    cpu = DecisionEngine(cap, clock=Clock().freeze_at(ns), device="cpu", store=MemoryStore())
    trace = StoreTrace(gpu)
    for b, (keys, cols) in enumerate(batches):
        reqs = as_requests(keys, cols)
        check(gpu.get_rate_limits(reqs) == cpu.get_rate_limits(reqs),
              f"[{tag}] batch {b}: answers differ card vs CPU")
        dt = int(rng.integers(0, 2_000))
        gpu.clock.advance(ms=dt)
        cpu.clock.advance(ms=dt)
    same_engines(np, gpu, cpu, tag, slots=True)
    check(gpu.store.data == cpu.store.data, f"[{tag}] the stores differ card vs CPU")
    check(gpu.table.evictions == cpu.table.evictions, f"[{tag}] eviction counts differ")
    by_n = {n: trace.per_round.count(n) for n in sorted(set(trace.per_round))}
    log(f"[{tag}] {len(batches)} get_rate_limits batches of {len(batches[0][0])} with a store "
        f"(cap {cap}, {gpu.table.evictions} evictions, {gpu.store.get_calls} store reads, "
        f"{trace.hits} restores onto a slot cleared in the same later round; restoring rounds "
        f"by (K2, K5) launches {by_n}): answers, state words and stores "
        f"({len(gpu.store.data)} items) bit-equal card vs CPU")
    check(set(trace.per_round) <= {(0, 1), (1, 1)}, f"[{tag}] restoring rounds by (K2, K5) "
          f"launches {by_n}: each must launch one K5 and at most one K2")
    return gpu, cpu, trace


def phase_persist(torch, np, rng, tmp: Path):
    """The persistence path on the card against the CPU: a store on the
    mixed stream at 2^20 slots and on a 4096-slot variant with evictions;
    a checkpoint saved through NpzFileLoader and loaded into a fresh card
    engine that then continues; a sweep with new keys after it; and the
    daemon with a loader, a store and a 0.2 s sweep interval over HTTP,
    closed and respawned.  Returns (card engines, timings)."""
    from gubernator_tpu_torch.checkpoint import NpzFileLoader
    from gubernator_tpu_torch.clock import Clock
    from gubernator_tpu_torch.config import DaemonConfig
    from gubernator_tpu_torch.core.engine import DecisionEngine
    from gubernator_tpu_torch.daemon import spawn_daemon
    from gubernator_tpu_torch.net.gateway import get_rate_limits_resp_json
    from gubernator_tpu_torch.service import V1Instance
    from gubernator_tpu_torch.store import MemoryStore

    pool = [b"api_k%d" % i for i in range(200_000)]
    hot = [b"api_hot%d" % i for i in range(50)]
    small = [b"api_e%d" % i for i in range(3 * 4096)]
    g1, c1, _ = store_stream(torch, np, rng, CAP_SERVE,
                             [stream_columns(np, rng, pool, hot, BATCH) for _ in range(12)],
                             "persist-mixed")
    g2, c2, trace = store_stream(torch, np, rng, 4096,
                                 [stream_columns(np, rng, small, hot, BATCH) for _ in range(12)],
                                 "persist-evict")
    check(trace.hits > 0, "[persist-evict] no restore ran after its round's clear at k > 0")
    out = {}

    # A checkpoint of the 2^20 engine, loaded into a fresh card engine.
    path = str(tmp / "ckpt.npz")
    torch.cuda.synchronize()
    t = time.perf_counter()
    g1.save(NpzFileLoader(path))
    t_save = time.perf_counter() - t
    fresh = DecisionEngine(CAP_SERVE, clock=Clock().freeze_at(g1.clock.now_ns()), device="cuda",
                           store=MemoryStore())
    t = time.perf_counter()
    n_loaded = fresh.load(NpzFileLoader(path))
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t
    out["save_load"] = (t_save, t_load, n_loaded, os.path.getsize(path))
    n_saved = sum(1 for _ in NpzFileLoader(path).load())  # occupied slots only
    check(n_loaded == n_saved > 0, f"[persist] loaded {n_loaded} of {n_saved} buckets")
    same_engines(np, fresh, g1, "after load", slots=False)
    for b in range(4):
        keys, cols = stream_columns(np, rng, pool, hot, BATCH)
        reqs = as_requests(keys, cols)
        want = c1.get_rate_limits(reqs)
        check(g1.get_rate_limits(reqs) == want and fresh.get_rate_limits(reqs) == want,
              f"[persist] continued batch {b}: answers differ")
        for e in (g1, c1, fresh):
            e.clock.advance(ms=500)
    same_engines(np, fresh, g1, "continued after load", slots=False)
    log(f"[persist] save {t_save * 1e3:.1f} ms + load {t_load * 1e3:.1f} ms of {n_loaded} "
        f"buckets at cap 2^20 (npz {os.path.getsize(path)} B); the loaded card engine "
        "answered 4 more batches as the engine that never stopped, words equal by key")

    # The sweep, then new keys onto the freed slots.
    for e in (g1, c1, fresh, g2, c2):
        e.clock.advance(ms=4 * 3_600_000)
    freed = [e.sweep() for e in (g1, c1, fresh, g2, c2)]
    check(freed[0] == freed[1] == freed[2] > 0 and freed[3] == freed[4] > 0,
          f"[persist] freed counts differ: {freed}")
    for gpu, cpu in ((g1, c1), (g2, c2)):  # the same slots freed
        same_engines(np, gpu, cpu, f"after the sweep (cap {gpu.capacity})", slots=True)
        check(len(gpu.table) == len(cpu.table), "[persist] the tables differ after the sweep")
    for gpu, cpu, src in ((g1, c1, pool), (g2, c2, small)):
        for b in range(2):
            keys, cols = stream_columns(np, rng, [k + b"_n" for k in src[:20_000]], hot, BATCH)
            reqs = as_requests(keys, cols)
            check(gpu.get_rate_limits(reqs) == cpu.get_rate_limits(reqs),
                  f"[persist] after the sweep, batch {b}: answers differ")
        same_engines(np, gpu, cpu, f"new keys after the sweep (cap {gpu.capacity})", slots=True)
    log(f"[persist] sweep at +4 h freed {freed[0]} (cap 2^20, the loaded engine too) and "
        f"{freed[3]} (cap 4096) slots as the CPU; new keys then took the same slots with the "
        "same words")

    # The daemon: loader + store + sweep thread, over HTTP, closed and respawned.
    ns = g1.clock.now_ns()
    dpath, dstore = str(tmp / "daemon.npz"), MemoryStore()
    conf = DaemonConfig(http_listen_address="127.0.0.1:0", cache_size=CAP_SERVE,
                        sweep_interval=0.2)
    cpu = V1Instance(DecisionEngine(CAP_SERVE, clock=Clock().freeze_at(ns), device="cpu",
                                    store=MemoryStore()))
    ticks: list = []
    same_stream: list = []
    serving_stream = torch.cuda.current_stream()  # the gateway threads' too
    daemon_engines = []

    def serve(d, n_batches, tag):
        for b in range(n_batches):
            keys, cols = keyed_columns(np, rng, 5_000, 20, BATCH, prefix="pd")
            reqs = as_requests(keys, cols)
            body = json.dumps({"requests": [vars(r) for r in reqs]}).encode()
            with urllib.request.urlopen(urllib.request.Request(
                    f"http://{d.http_address}/v1/GetRateLimits", data=body, method="POST"),
                    timeout=60) as r:
                got = r.read()
            check(got == get_rate_limits_resp_json(cpu.get_rate_limits(reqs)),
                  f"[persist-daemon] {tag} batch {b}: HTTP body differs from the CPU's")

    def timed(eng):
        real = eng.sweep

        def sweep(*a, **k):
            # The sweep thread queues on the stream the serving path uses.
            same_stream.append(torch.cuda.current_stream(eng.device) == serving_stream)
            t0 = time.perf_counter()
            with eng._lock:  # re-entered by the tick: hold and wait apart
                t1 = time.perf_counter()
                n = real(*a, **k)
                t2 = time.perf_counter()
            ticks.append((t2 - t1, n, t1 - t0))
            return n

        eng.sweep = sweep

    d = spawn_daemon(conf, clock=Clock().freeze_at(ns), device="cuda", store=dstore,
                     loader=NpzFileLoader(dpath))
    try:
        eng = d.instance.engine
        daemon_engines.append(eng)
        timed(eng)
        serve(d, 4, "first")
        d.clock.advance(ms=2 * 3_600_000)
        cpu.engine.clock.advance(ms=2 * 3_600_000)
        want = cpu.engine.sweep()
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline and eng.cache_size() != cpu.engine.cache_size():
            time.sleep(0.05)
        check(want > 0 and eng.cache_size() == cpu.engine.cache_size(),
              f"[persist-daemon] the sweep thread left {eng.cache_size()} buckets, the CPU "
              f"{cpu.engine.cache_size()}")
        serve(d, 2, "after the tick")
    finally:
        d.close()
    check(not d._sweeper.is_alive(), "[persist-daemon] the sweep thread outlived close()")
    d2 = spawn_daemon(conf, clock=Clock().freeze_at(cpu.engine.clock.now_ns()), device="cuda",
                      store=dstore, loader=NpzFileLoader(dpath))
    try:
        daemon_engines.append(d2.instance.engine)
        n_saved = sum(1 for _ in NpzFileLoader(dpath).load())
        check(d2.instance.engine.cache_size() == n_saved > 0,
              "[persist-daemon] the respawned daemon did not restore every bucket")
        serve(d2, 2, "respawned")
    finally:
        d2.close()
    check(dstore.data == cpu.engine.store.data, "[persist-daemon] the stores differ")
    check(any(n > 0 for _, n, _ in ticks), "[persist-daemon] no sweep tick freed a slot")
    check(all(same_stream), "[persist-daemon] the sweep thread ran on another stream")
    hold = [t for t, _, _ in ticks]
    out["tick"] = (statistics.median(hold), max(hold), len(ticks),
                   max(w for _, _, w in ticks), min(hold))
    log(f"[persist-daemon] HTTP bodies byte-equal to the CPU instance's before and after a "
        f"sweep tick ({want} freed) and after close + respawn from the npz; {len(ticks)} "
        f"ticks of {conf.sweep_interval} s on the serving stream, the lock held "
        f"{out['tick'][4] * 1e3:.2f} / {out['tick'][0] * 1e3:.2f} / {out['tick'][1] * 1e3:.2f} ms "
        f"(min / median / max) a tick at cap 2^20 (8 windows; "
        f"a tick waited up to {out['tick'][3] * 1e3:.2f} ms for the lock behind a batch)")
    cpu.close()
    for e in (c1, c2):
        e.close()
    return [g1, g2, fresh, *daemon_engines], out


def time_sweep_groups(torch, state, plain, meta0, starts, window: int, n_sh: int, n: int,
                      card: str):
    """K6 (n_sh = 0) or K13 on groups of 16 windows, as the engines sweep
    them (`sweep_group`: one launch a group, or 16 on an older port): the
    clamped tail's group (its last 16 windows) held against the plain
    version word for word, then groups of 16 fresh windows timed, `n` a
    timing window, the state re-armed from `meta0` before each.  Returns
    (device ms per group, plain ms per group, bound ms per group)."""
    tag = "K13" if n_sh else "K6"
    state.meta.copy_(meta0)
    plain.meta.copy_(meta0)
    tail = starts[-16:]
    got = sweep_group(state.meta, state.hi2, state.expire_lo, NOW0, tail, window, n_sh)
    want = sweep_group_plain(plain.meta, plain.hi2, plain.expire_lo, NOW0, tail, window, n_sh)
    torch.cuda.synchronize()
    err = max(same_sweep(torch, got, want), int(not torch.equal(state.meta, plain.meta)))
    check(err == 0, f"[time] {tag} differs from its plain version on the tail's group: err {err}")
    groups = [starts[i : i + 16] for i in range(0, len(starts) - 15, 16)]
    check(len(groups) >= n, f"[time] {tag}: {len(groups)} groups of fresh windows, want {n}")
    nxt = itertools.count()
    outs = []

    def launch(_):
        g = groups[next(nxt) % len(groups)]
        outs.append(sweep_group(state.meta, state.hi2, state.expire_lo, NOW0, g, window, n_sh))

    def rearm():
        state.meta.copy_(meta0)

    rearm()
    ms = device_ms(torch, launch, n, before=rearm)
    fresh = outs[: len(groups)]  # the first timing windows': every group fresh
    freed = [sum(int(row[0]) for o in grp for row in o) for grp in fresh]
    bnd = statistics.median(sum(
        k13_bound_ms(n_sh, window, sum(int(row[0]) for row in o)) if n_sh
        else k6_bound_ms(window, int(o[0][0])) for o in grp) for grp in fresh)
    del outs, fresh
    pnxt = itertools.count()
    plain.meta.copy_(meta0)
    plain_ms = host_ms(torch, lambda i: sweep_group_plain(
        plain.meta, plain.hi2, plain.expire_lo, NOW0, groups[next(pnxt) % len(groups)], window,
        n_sh), 2, windows=3)
    state.meta.copy_(meta0)
    launches = 1 if has_sweep_groups() else 16
    log(f"[time] {tag}, groups of 16 windows of 2^17" + (f" of {n_sh} shards" if n_sh else "")
        + f" (median {statistics.median(freed)} freed a group, {launches} launch"
        + ("es" if launches > 1 else "") + f" a group): {ms * 1e3:.2f} us/group, bound "
        f"{bnd * 1e3:.3f} us (bytes), plain {plain_ms * 1e3:.1f} us; the clamped tail's group "
        f"bit-equal to the plain version (tolerance: exact) | {card}")
    return ms, plain_ms, bnd


def trace_tick(torch, holder, cap: int, card: str, rearm):
    """torch.profiler over one 16-window sweep tick at `cap` from the
    cursor at 0, after `rearm()`: the device operations the tick puts on
    the stream the serving path shares, by name (count, device us).  The
    second of two traced ticks counts (the first trace drops events while
    the profiler starts).  Returns (operations, device ms)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from gubernator_tpu_torch.ops import expiry

    for _ in range(2):
        rearm()
        holder._sweep_cursor = 0
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            expiry.windowed_sweep(holder, cap, NOW0, 16, lambda f, st: len(f))
            torch.cuda.synchronize()
    ops = [(e.key, e.count, e.self_device_time_total) for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    n, us = sum(c for _, c, _ in ops), sum(t for _, _, t in ops)
    log(f"[trace] one 16-window sweep tick at cap 10^8: {n} device operations, {us:.2f} us of "
        "device time: " + "; ".join(f"{k[:48]} x{c} {t:.2f} us" for k, c, t in
                                    sorted(ops, key=lambda o: -o[2])) + f" | {card}")
    return n, us / 1e3


def idle_ticks(torch, np, card: str, n_keys: int = 50_000, n_ticks: int = 20):
    """The daemon's sweep tick (`Daemon.SWEEP_WINDOWS_PER_TICK` windows, 8
    at this capacity) on a card engine of 2^20 slots that no batch
    contends for: how long a tick holds the engine lock, the first one
    freeing `n_keys` expired buckets, the next `n_ticks` finding none.
    Returns (first ms, median ms, min ms)."""
    from gubernator_tpu_torch.clock import Clock
    from gubernator_tpu_torch.core.engine import DecisionEngine
    from gubernator_tpu_torch.daemon import Daemon

    eng = DecisionEngine(CAP_SERVE, clock=Clock().freeze_at(NOW0 * 10**6))
    keys = [b"tick_%d" % i for i in range(n_keys)]
    for i in range(0, n_keys, 5000):
        n = len(keys[i : i + 5000])
        eng.apply_columnar(keys[i : i + 5000], np.zeros(n, np.int32), np.zeros(n, np.int32),
                           np.ones(n, np.int64), np.full(n, 10, np.int64),
                           np.full(n, 60_000, np.int64), np.zeros(n, np.int64))
    eng.clock.advance(ms=120_000)
    holds, freed = [], []
    for _ in range(1 + n_ticks):
        torch.cuda.synchronize()
        with eng._lock:
            t = time.perf_counter()
            freed.append(eng.sweep(max_windows=Daemon.SWEEP_WINDOWS_PER_TICK))
            holds.append(time.perf_counter() - t)
    eng.close()
    check(freed[0] == n_keys and not any(freed[1:]),
          f"[time] the idle ticks freed {freed}, want {n_keys} then none")
    first, med, low = holds[0] * 1e3, statistics.median(holds[1:]) * 1e3, min(holds[1:]) * 1e3
    log(f"[time] the daemon's sweep tick at cap 2^20 on an idle engine (8 windows, the lock "
        f"held): {first:.3f} ms freeing {n_keys}, then {med:.3f} ms median, {low:.3f} ms min "
        f"of {n_ticks} freeing none | {card}")
    return first, med, low


# The K5 split's readings: (cap, lanes, contiguous slots).
K5_SPLIT = ((CAP_SERVE, 16, False), (CAP_SERVE, 1024, False), (CAP_SERVE, 4096, False),
            (CAP_NORTH_STAR, 16, False), (CAP_NORTH_STAR, 1024, False),
            (CAP_NORTH_STAR, 4096, False), (CAP_NORTH_STAR, 4096, True))


def k5_sector_bound_ms(rec, cap: int) -> float:
    """Least time for one K5 launch counted in the 32-byte sectors the
    memory moves: the record's rows of the in-range lanes (19 rows) and the
    slots of the padding lanes, read in whole sectors, and one sector a
    state word stored (12 an in-range lane: random slots share none)."""
    s = rec[0].astype("int64")
    n = int(((s >= 0) & (s < cap)).sum())
    sectors = 19 * -(-n * 4 // 32) + -(-(len(s) - n) * 4 // 32) + 12 * n
    return sectors * 32 / HBM_BYTES_PER_S * 1e3


def time_k5_split(torch, np, card) -> dict:
    """K5 per launch (CUDA events behind the spin kernel) at 16, 1024 and
    4096 random slots at caps 2^20 and 10^8 and at 4096 contiguous slots at
    10^8, beside an empty kernel launched in the same queue
    (`torch.cuda._sleep(0)`, the launch floor), with the bytes and sector
    bounds: what the 4096-record restore's time above the floor is made of
    (the footprint of the slots: 2^20 against 10^8; their scatter: random
    against contiguous; the lanes: 16 against 4096).  It restores into
    zeroed states of its own (the caller's states stay as they were), and
    its records come from a generator of its own.  Returns {reading: (ms,
    bytes bound, sector bound)} and the floor under "floor"."""
    from gubernator_tpu_torch.ops import bucket_kernel as tk
    from gubernator_tpu_torch.ops import fused_step as fs

    rng = np.random.default_rng(SEED + 16)
    states = {cap: tk.BucketState(*(torch.zeros(cap, dtype=torch.int32, device="cuda")
                                    for _ in tk.BucketState._fields))
              for cap in (CAP_SERVE, CAP_NORTH_STAR)}
    out = {"floor": device_ms(torch, lambda i: torch.cuda._sleep(0), 200)}
    for cap, lanes, contiguous in K5_SPLIT:
        state = states[cap]
        host = []
        for _ in range(16):
            rec = restore_record(np, rng, cap, lanes, NOW0, n=lanes)
            if contiguous:
                start = int(rng.integers(0, cap - lanes))
                rec[0] = np.arange(start, start + lanes, dtype=np.int32)
            host.append(rec)
        recs = [torch.from_numpy(r).cuda() for r in host]
        fs.load_slots(state, recs[0])
        ms = device_ms(torch, lambda i: fs.load_slots(state, recs[i % 16]), 200)
        key = f"{lanes} {'contiguous' if contiguous else 'random'}, cap " + (
            "2^20" if cap == CAP_SERVE else "10^8")
        out[key] = (ms, statistics.median(k5_bound_ms(r, cap) for r in host),
                    statistics.median(k5_sector_bound_ms(r, cap) for r in host))
    log("[time] K5 split (us/launch; bytes and 32-byte-sector bounds): empty kernel "
        f"{out['floor'] * 1e3:.2f}; " + "; ".join(
            f"{k} {v[0] * 1e3:.2f} ({v[0] * 1e3 - out['floor'] * 1e3:+.2f} over the floor; "
            f"bounds {v[1] * 1e3:.3f}, {v[2] * 1e3:.3f})" for k, v in out.items() if k != "floor")
        + f" | {card}")
    del states
    torch.cuda.empty_cache()
    return out


def time_k5(torch, np, rng, card, state, plain) -> dict:
    """K5 per 4096-record restore at 10^8 slots (CUDA events) beside its
    plain version and bytes bound, and its split (`time_k5_split`);
    `state` and `plain` are states at 10^8."""
    from gubernator_tpu_torch.ops import bucket_kernel as tk
    from gubernator_tpu_torch.ops import fused_step as fs

    cap = CAP_NORTH_STAR
    host = [restore_record(np, rng, cap, 4096, NOW0, n=4096) for _ in range(16)]
    recs = [torch.from_numpy(r).cuda() for r in host]
    fs.load_slots(state, recs[0])
    k5_ms = device_ms(torch, lambda i: fs.load_slots(state, recs[i % 16]), 200)
    k5_plain = host_ms(torch, lambda i: tk.load_slots_reference(plain, recs[i % 16]), 16,
                       windows=3)
    k5_bound = statistics.median(k5_bound_ms(r, cap) for r in host)
    log(f"[time] K5, 4096-record restores at cap 10^8: {k5_ms * 1e3:.2f} us/launch, bound "
        f"{k5_bound * 1e3:.3f} us (bytes), plain {k5_plain * 1e3:.1f} us | {card}")
    return {"k5": (k5_ms, k5_plain, k5_bound), "k5_split": time_k5_split(torch, np, card)}


def phase_persist_timing(torch, np, rng, card):
    """K5 per 4096-record launch and its split (`time_k5`) and K6 per 2^17
    window at 10^8 slots (CUDA events), beside their plain versions and
    bytes bounds; and the
    wall time of a 16-window sweep tick at 10^8 (windows and readback,
    without the intern table's release); and K6 per group of 16 windows,
    the launch the engines make (`time_sweep_groups`)."""
    from gubernator_tpu_torch.ops import bucket_kernel as tk
    from gubernator_tpu_torch.ops import expiry
    from gubernator_tpu_torch.ops import fused_step as fs

    cap, win = CAP_NORTH_STAR, SweepHolder.SWEEP_WINDOW
    state = random_state(torch, cap, NOW0, int(rng.integers(2**31)))
    arm_expiries(torch, state, NOW0, int(rng.integers(2**31)))
    meta0 = state.meta.clone()
    plain = copy_state(state)
    out = time_k5(torch, np, rng, card, state, plain)

    state.meta.copy_(meta0)
    plain.meta.copy_(meta0)
    n_win = (cap + win - 1) // win
    starts = [min(i * win, cap - win) for i in range(n_win)]
    outs = []
    nxt = itertools.count()

    def k6(_):  # each launch sweeps a window no launch swept before
        st = starts[next(nxt) % n_win]
        outs.append(expiry.sweep_window(state.meta, state.hi2, state.expire_lo, NOW0, st, win))

    k6(0)
    k6_ms = device_ms(torch, k6, 100)
    freed = [int(o[0]) for o in outs]
    check(len(outs) <= n_win and min(freed) > 0, "[time] K6 windows must be fresh and free slots")
    k6_bound = statistics.median(k6_bound_ms(win, f) for f in freed)
    pnxt = itertools.count()
    k6_plain = host_ms(torch, lambda i: expiry.sweep_window_reference(
        plain.meta, plain.hi2, plain.expire_lo, NOW0, starts[next(pnxt) % n_win], win), 10,
        windows=3)
    out["k6"] = (k6_ms, k6_plain, k6_bound)
    log(f"[time] K6, 2^17-slot windows at cap 10^8 (median {statistics.median(freed)} freed a "
        f"window): {k6_ms * 1e3:.2f} us/window, bound {k6_bound * 1e3:.3f} us (bytes), plain "
        f"{k6_plain * 1e3:.1f} us | {card}")
    del outs
    out["k6_group"] = time_sweep_groups(torch, state, plain, meta0, starts, win, 0, 8, card)
    state.meta.copy_(meta0)
    holder = SweepHolder(state)
    tick = []
    for _ in range(5):
        torch.cuda.synchronize()
        t = time.perf_counter()
        expiry.windowed_sweep(holder, cap, NOW0, 16, lambda f, st: len(f))
        tick.append(time.perf_counter() - t)
    out["tick"] = statistics.median(tick)
    log(f"[time] one 16-window sweep tick at cap 10^8 (K6 + count and freed-index readback, "
        f"without the table's release): {out['tick'] * 1e3:.2f} ms (median of 5) | {card}")
    out["tick_trace"] = trace_tick(torch, holder, cap, card, lambda: state.meta.copy_(meta0))
    del holder
    out["idle_tick"] = idle_ticks(torch, np, card)
    del state, plain, meta0
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# The sketch path: K7 (the count-min step) and K8 (the window rotation)

SKETCH_DEPTH = 4  # GUBER_SKETCH_DEPTH default (gubernator_tpu/config.py:700)
SKETCH_WIDTH = 1 << 20  # GUBER_SKETCH_WIDTH default: 32 MiB of planes, inside the 50 MB L2
SKETCH_WIDE = 1 << 24  # 512 MiB of planes: past the L2


def sketch_keys(np, rng, n: int):
    """n key names drawn as the zipf stream draws them: zipf(1.2) over
    10^8 names."""
    ids = (rng.zipf(ZIPF_S, n) - 1) % ZIPF_KEYS
    return [b"sk_%d" % i for i in ids.tolist()]


def sketch_pin(np, rng, width: int, keys, hits, now: int, size=None):
    """The sketch limiter's packed pin for `keys` at `now` (window 1 s),
    widened with padding lanes to `size` when given."""
    from gubernator_tpu_torch import hashing
    from gubernator_tpu_torch.ops import sketch as ps

    rows = ps.row_indexes(hashing.fnv1a_64_batch(*hashing.pack_keys(keys)), SKETCH_DEPTH, width)
    pin = ps.pack_pin(rows, np.asarray(hits, dtype=np.int64), now, 1000, width)
    if size is not None and size > pin.shape[1]:
        wide = np.zeros((pin.shape[0], size), np.int32)
        wide[:, : pin.shape[1]] = pin
        wide[2::3, pin.shape[1]:] = np.arange(width + pin.shape[1], width + size)
        pin = wide
    return pin


def random_planes(torch, width: int, seed: int):
    """Sketch planes made on the card: counts in [-1000, 1000) (negative
    ones read through the floor division), every fifth cell 2^31 - 9."""
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    c = torch.randint(-1000, 1000, (2, SKETCH_DEPTH, width), dtype=torch.int32, device="cuda",
                      generator=g)
    c[:, :, ::5] = 2**31 - 9
    return c


def k7_bound_ms(pin, width: int) -> float:
    """Least time for one K7 call: the pin's rows that K7 reads (the
    3 * depth rows of indexes, hits and positions, and the one word of
    row 0 that holds frac; row 1 is the host's) read once, 12 B per
    valid cell (the current cell read and written, the previous one
    read) and the 8 B estimate of each lane written."""
    rows, size = pin.shape
    idx = pin[2::3][: (rows - 2) // 3].astype("int64")
    valid = int(((idx >= 0) & (idx < width)).sum())
    return ((rows - 2) * size * 4 + 4 + 12 * valid + 8 * size) / HBM_BYTES_PER_S * 1e3


def k8_bound_ms(words: int) -> float:
    """Least time for one K8 call: the zeroed words written once."""
    return words * 4 / HBM_BYTES_PER_S * 1e3


def phase_sketch_kernels(torch, np, rng, errs):
    """K7 and K8 against their plain versions on the card, word for word
    in the planes and the output, at depth 4 and widths 2^20 (the
    daemon's default, 32 MiB) and 2^24 (512 MiB): per batch size (1000
    and 8192 keys from zipf(1.2) over 10^8 names) a zipf step, a hot key
    of 4 x 2^30 hits (saturation), a step of negative hits, a one-window
    rotation (K8 on one plane), the same keys read at frac 0.3 (the
    negative counts now in the previous plane: the floor division), an
    all-padding tail (5 keys in 8192 lanes), a gap rotation (K8 on both
    planes) and a step after it."""
    from gubernator_tpu_torch.ops import sketch as ps

    def hold(name, got, want, kern, plain, what):
        torch.cuda.synchronize()
        err = max(int((got.long() - want.long()).abs().max().item()) if got is not None else 0,
                  int((kern.long() - plain.long()).abs().max().item()))
        errs[name] = max(errs[name], err)
        check(err == 0, f"{name} differs from its plain version: {what} err {err}")

    for width in (SKETCH_WIDTH, SKETCH_WIDE):
        kern = random_planes(torch, width, int(rng.integers(2**31)))
        plain = kern.clone()
        cur, epoch = 0, NOW0 // 1000
        for n in (BATCH, ZIPF_BATCH):
            keys = sketch_keys(np, rng, n)
            neg_keys = sketch_keys(np, rng, n)
            steps = [
                ("zipf", keys, rng.choice([-7, -1, 0, 1, 1, 2, 5], n), 250, None),
                ("hot", [b"sk_hot"] * 4 + keys[4:], [2**30] * 4 + [1] * (n - 4), 250, None),
                ("negative hits", neg_keys, -rng.integers(1, 8, n), 400, None),
                ("rotate one", None, None, None, 1),
                ("negative counts read at frac 0.3", neg_keys, np.zeros(n, np.int64), 300, None),
                ("padding tail", keys[:5], [3] * 5, 999, ZIPF_BATCH),
                ("rotate gap", None, None, None, 3),
                ("after the gap", keys, np.ones(n, np.int64), 10, None),
            ]
            for what, k, hits, ms, extra in steps:
                if k is None:  # a rotation by `extra` windows
                    c_k = ps.sketch_rotate(kern, cur, extra)
                    c_p = ps.rotate_reference(plain, cur, extra)
                    check(c_k == c_p, f"K8 plane index {c_k} vs {c_p}")
                    cur, epoch = c_k, epoch + extra
                    hold("sketch_rotate", None, None, kern, plain, f"width {width}, {what}")
                    continue
                pin = torch.from_numpy(sketch_pin(np, rng, width, k, hits, epoch * 1000 + ms,
                                                  size=extra)).cuda()
                got = ps.sketch_step(kern, pin, cur)
                want = ps.sketch_step_reference(plain, pin, cur)
                hold("sketch_step", got, want, kern, plain, f"width {width}, n {n}, {what}")
        log(f"[k7/k8] width {width}: K7 on batches of {BATCH} and {ZIPF_BATCH} zipf keys "
            "(saturating hot key, negative counts at frac 0.3, all-padding tail) and K8 on one "
            "plane and on both planes, planes and output bit-equal to the plain versions "
            "(tolerance: exact)")
        del kern, plain
        torch.cuda.empty_cache()
    if hasattr(ps, "launch_step"):
        hold_k7_forms(torch, np, errs)


# Pin sizes of the every-form hold: around the plan's boundary at depth 4
# (the block form up to 256 lanes, the pair form past it), the daemon's
# and the zipf deployment's batches, and one past them.
K7_FORM_SIZES = (64, 128, 256, 512, 1024, 8192, 16384)
# Batch sizes K7 is timed at: small batches (the block form on a port that
# has it), the daemon's batch, the zipf deployment's, and one past it.
K7_TIMED_KEYS = (48, 192, BATCH, ZIPF_BATCH, 32768)


def k7_plans(ps, depth: int, size: int) -> list:
    """Every form the driven port's K7 can take at (depth, size): its
    plan's, and the pair form beside a block-form plan."""
    plan = ps.plan_sketch_step(depth, size)
    return [plan] + ([ps.PAIR_PLAN] if plan != ps.PAIR_PLAN else [])


def hold_k7_forms(torch, np, errs):
    """K7 in every form it can take (`k7_plans`) against its plain version,
    planes and output word for word, at depth 4 and widths 2^20 and 2^24,
    on pins of K7_FORM_SIZES lanes (3/4 of them zipf keys with mixed-sign
    hits and a hot key of 4 x 2^30 hits, the rest padding) read at frac
    0.3 over planes with negative counts; and the plan's own form through
    `sketch_step`.  Draws from a generator of its own, so that the phases
    after it see the inputs they see on a port without plans."""
    from gubernator_tpu_torch.ops import sketch as ps

    rng = np.random.default_rng(SEED + 14)
    n_held = 0
    for width in (SKETCH_WIDTH, SKETCH_WIDE):
        base = random_planes(torch, width, int(rng.integers(2**31)))
        for size in K7_FORM_SIZES:
            n = size * 3 // 4
            keys = [b"sk_hot"] * 4 + sketch_keys(np, rng, n - 4)
            hits = np.concatenate([[2**30] * 4, rng.choice([-7, -1, 0, 1, 2, 5], n - 4)])
            cur = int(rng.integers(0, 2))
            pin = torch.from_numpy(sketch_pin(np, rng, width, keys, hits, NOW0 + 300,
                                              size=size)).cuda()
            plain = base.clone()
            want = ps.sketch_step_reference(plain, pin, cur)
            plans = k7_plans(ps, SKETCH_DEPTH, size)
            for plan in plans + [None]:
                kern = base.clone()
                got = (ps.sketch_step(kern, pin, cur) if plan is None
                       else ps.launch_step(kern, pin, cur, plan))
                torch.cuda.synchronize()
                err = max(int((got.long() - want.long()).abs().max().item()),
                          int((kern.long() - plain.long()).abs().max().item()))
                errs["sketch_step"] = max(errs["sketch_step"], err)
                check(err == 0, f"K7 differs from its plain version: width {width}, size {size}, "
                      f"{plan or 'the plan of sketch_step'}: err {err}")
                n_held += 1
                del kern
            del plain
        del base
        torch.cuda.empty_cache()
    log(f"[k7 forms] {n_held} K7 calls bit-equal to the plain step, every form at depth 4 on pins "
        f"of {', '.join(map(str, K7_FORM_SIZES))} lanes at widths 2^20 and 2^24 (plan at each: "
        + "; ".join(f"{s}: {ps.plan_sketch_step(SKETCH_DEPTH, s)}" for s in K7_FORM_SIZES)
        + ") (tolerance: exact)")


def sketch_stream_batch(np, rng, pool, n: int = BATCH):
    """One GetRateLimits batch of the sketch stream: about 60 % SKETCH
    (some with GLOBAL or MULTI_REGION), 20 % GLOBAL (some with
    RESET_REMAINING), 20 % plain; sketch keys from zipf(1.2) over 10^8
    names, the others from a pool of 20,000."""
    from gubernator_tpu_torch.types import RateLimitReq

    beh = rng.choice([32, 32, 32, 32, 34, 48, 2, 2, 2 | 8, 0, 0], n,
                     p=[0.11, 0.11, 0.11, 0.12, 0.08, 0.07, 0.08, 0.08, 0.04, 0.1, 0.1])
    sk = sketch_keys(np, rng, n)
    other = rng.integers(0, len(pool), n)
    hits = rng.choice([-2, 0, 1, 1, 1, 3, 10], n)
    limit = rng.choice([5, 20, 100, 1000], n)
    dur = rng.choice([1000, 60_000], n)
    algo = rng.integers(0, 2, n)
    return [RateLimitReq(name="sk" if b & 32 else "api",
                         unique_key=(sk[j] if b & 32 else pool[other[j]]).decode().partition("_")[2],
                         hits=int(hits[j]), limit=int(limit[j]), duration=int(dur[j]),
                         algorithm=int(algo[j]), behavior=int(b))
            for j, b in enumerate(beh.tolist())]


# Clock steps of the sketch stream (ms): inside a window, exactly one
# window, and gaps of two windows or more.
SKETCH_STEPS = (0, 250, 1000, 333, 2_000, 50, 1000, 5_000, 400)
# Sizes of the sketch stream's small batches (after its 40 of 1000).
SKETCH_SMALL_BATCHES = (1, 2, 10, 40, 100, 300)


def phase_sketch_stream(torch, np, rng):
    """One V1Instance on the card and one on the CPU, frozen clocks, the
    sketch at the daemon's defaults (window 1 s, depth 4, width 2^20): 40
    batches of 1000 (`sketch_stream_batch`), the clock stepping through
    SKETCH_STEPS.  Answers, both planes, epoch and plane index, and the
    engines' state words must be equal, and each batch with engine items
    must make one engine call (the GLOBAL read-back rides in it).
    Returns the number of sketch applies of the card instance."""
    from gubernator_tpu_torch.clock import Clock
    from gubernator_tpu_torch.core.engine import DecisionEngine
    from gubernator_tpu_torch.ops import bucket_kernel as tk
    from gubernator_tpu_torch.ops import sketch as ps
    from gubernator_tpu_torch.service import V1Instance

    ns = NOW0 * 1_000_000
    gpu = V1Instance(DecisionEngine(CAP_SERVE, clock=Clock().freeze_at(ns), device="cuda"))
    cpu = V1Instance(DecisionEngine(CAP_SERVE, clock=Clock().freeze_at(ns), device="cpu"))
    pool = [b"api_g%d" % i for i in range(20_000)]
    applies, engine_batches, kinds = 0, 0, {"one": 0, "gap": 0, "inside": 0}
    # After the 40 batches of 1000, small ones (single-item and short RPCs,
    # the common case of a rate limiter's callers), drawn from a generator
    # of their own so that the phases after this one see the inputs they
    # saw before these existed.
    small_rng = np.random.default_rng(SEED + 17)
    sizes = [BATCH] * 40 + list(SKETCH_SMALL_BATCHES)
    try:
        last_epoch = None
        for b, n in enumerate(sizes):
            step = SKETCH_STEPS[b % len(SKETCH_STEPS)]
            gpu.engine.clock.advance(ms=step)
            cpu.engine.clock.advance(ms=step)
            epoch = gpu.engine.clock.now_ms() // 1000
            if last_epoch is not None:
                d = epoch - last_epoch
                kinds["inside" if d == 0 else "one" if d == 1 else "gap"] += 1
            last_epoch = epoch
            reqs = (sketch_stream_batch(np, rng, pool) if n == BATCH
                    else sketch_stream_batch(np, small_rng, pool, n))
            got, want = gpu.get_rate_limits(reqs), cpu.get_rate_limits(reqs)
            check([vars(r) for r in got] == [vars(r) for r in want],
                  f"[sketch] batch {b}: answers differ card vs CPU")
            applies += any(r.behavior & 32 for r in reqs)
            engine_batches += any(r.name and r.unique_key and not r.behavior & 32 for r in reqs)
        check(gpu.engine.batches_total == engine_batches,
              f"[sketch] {gpu.engine.batches_total} engine calls for {engine_batches} batches "
              "with engine items: one call per batch")
        a = ps.sketch_state_to_numpy(gpu.sketch().state)
        c = ps.sketch_state_to_numpy(cpu.sketch().state)
        check(np.array_equal(a[0], c[0]) and a[1:] == c[1:],
              "[sketch] planes, epoch or plane index differ card vs CPU")
        gw, cw = tk.state_to_numpy(gpu.engine.state), tk.state_to_numpy(cpu.engine.state)
        for f in tk.BucketState._fields:
            check(np.array_equal(gw[f], cw[f]), f"[sketch] engine state column {f} differs")
        check(min(kinds.values()) > 0, f"[sketch] the clock must step every way: {kinds}")
        log(f"[sketch] 40 batches of {BATCH} and {len(SKETCH_SMALL_BATCHES)} of "
            f"{', '.join(map(str, SKETCH_SMALL_BATCHES))} through V1Instance on the card and on the CPU "
            f"({gpu.counters['sketch']} sketch items, window steps {kinds}, "
            f"{engine_batches} engine calls): answers, both planes (epoch {a[1]}, cur {a[2]}) "
            f"and the engines' {CAP_SERVE}x12 state words bit-equal card vs CPU")
        return applies
    finally:
        gpu.close()
        cpu.close()


def phase_sketch_http(torch, np, rng):
    """The daemon on the card, configured by GUBER_SKETCH_* (window 500ms,
    depth 4, width 2^20), answers 12 GetRateLimits of the sketch stream
    over HTTP; each body must equal the JSON of the same batch through a
    CPU instance.  Returns the daemon's sketch applies."""
    from gubernator_tpu_torch.clock import Clock
    from gubernator_tpu_torch.config import setup_daemon_config
    from gubernator_tpu_torch.core.engine import DecisionEngine
    from gubernator_tpu_torch.daemon import spawn_daemon
    from gubernator_tpu_torch.net.gateway import get_rate_limits_resp_json
    from gubernator_tpu_torch.service import V1Instance

    ns = NOW0 * 1_000_000
    # GUBER_GRPC_ADDRESS: the config's default is the reference's
    # localhost:81, which only one daemon of a host can bind.
    conf = setup_daemon_config({
        "GUBER_HTTP_ADDRESS": "127.0.0.1:0", "GUBER_GRPC_ADDRESS": "127.0.0.1:0",
        "GUBER_CACHE_SIZE": str(CAP_SERVE),
        "GUBER_SWEEP_INTERVAL": "0", "GUBER_SKETCH_WINDOW": "500ms",
        "GUBER_SKETCH_DEPTH": str(SKETCH_DEPTH), "GUBER_SKETCH_WIDTH": str(SKETCH_WIDTH)})
    check((conf.sketch_window_ms, conf.sketch_depth, conf.sketch_width)
          == (500, SKETCH_DEPTH, SKETCH_WIDTH), f"[sketch http] GUBER_SKETCH_* read as {conf}")
    d = spawn_daemon(conf, clock=Clock().freeze_at(ns), device="cuda")
    cpu = V1Instance(DecisionEngine(CAP_SERVE, clock=Clock().freeze_at(ns), device="cpu"),
                     sketch_window_ms=500, sketch_depth=SKETCH_DEPTH, sketch_width=SKETCH_WIDTH)
    pool = [b"api_h%d" % i for i in range(5_000)]
    applies = 0
    try:
        url = f"http://{d.http_address}/v1/GetRateLimits"
        for b in range(12):
            reqs = sketch_stream_batch(np, rng, pool)
            reqs[1].unique_key = ""
            body = json.dumps({"requests": [vars(r) for r in reqs]}).encode()
            with urllib.request.urlopen(urllib.request.Request(url, data=body, method="POST"),
                                        timeout=60) as r:
                got = r.read()
            check(got == get_rate_limits_resp_json(cpu.get_rate_limits(reqs)),
                  f"[sketch http] batch {b}: HTTP body differs from the CPU instance's")
            applies += 1
            d.clock.advance(ms=250)
            cpu.engine.clock.advance(ms=250)
        check(d.instance.sketch().state.counts.is_cuda, "[sketch http] the sketch is not on the card")
        check(d.instance.counters["sketch"] == cpu.counters["sketch"] > 0,
              "[sketch http] sketch counts differ")
        log(f"[sketch http] 12 POST /v1/GetRateLimits x {BATCH} (sketch, GLOBAL, "
            f"MULTI_REGION|SKETCH and plain items; {d.instance.counters['sketch']} sketch "
            "answers) on the card: bodies byte-equal to the CPU instance's")
        return applies
    finally:
        d.close()
        cpu.close()


def phase_sketch_timing(torch, np, rng, card):
    """K7 per batch of K7_TIMED_KEYS zipf keys (on a port with K7's plan,
    the block form's sizes also forced into the pair form) and K8 per plane
    and per pair of planes, at widths 2^20 and 2^24 (CUDA events), beside their
    bytes bounds, their plain versions and, for K8, `zero_()` on the same
    span (the one PyTorch call that computes it; the port never calls
    it), timed in turns (K8, zero_(), zero_(), K8), each the mean of its
    two turns."""
    from gubernator_tpu_torch.ops import sketch as ps

    out = {}
    planned = hasattr(ps, "launch_step")
    forms_rng = np.random.default_rng(SEED + 15)
    for width in (SKETCH_WIDTH, SKETCH_WIDE):
        counts = random_planes(torch, width, int(rng.integers(2**31)))
        plain = counts.clone()
        for n in K7_TIMED_KEYS:
            # The sizes besides BATCH and ZIPF_BATCH draw from a generator of
            # their own, so that the readings after them see the inputs they
            # saw before those sizes were timed.
            g = rng if n in (BATCH, ZIPF_BATCH) else forms_rng
            host = [sketch_pin(np, g, width, sketch_keys(np, g, n),
                               g.choice([-1, 1, 1, 2], n), NOW0 + 250 + i) for i in range(8)]
            pins = [torch.from_numpy(p).cuda() for p in host]
            ps.sketch_step(counts, pins[0], 0)
            k_ms = device_ms(torch, lambda i: ps.sketch_step(counts, pins[i % 8], i & 1), 200)
            p_ms = host_ms(torch, lambda i: ps.sketch_step_reference(plain, pins[i % 8], i & 1),
                           20, windows=3)
            bound = statistics.median(k7_bound_ms(p, width) for p in host)
            out[f"k7_{width}_{n}"] = (k_ms, p_ms, bound)
            size = host[0].shape[1]
            form = (ps.plan_sketch_step(SKETCH_DEPTH, size) if planned
                    else "two launches, the pair form")
            log(f"[time] K7, {n} zipf keys (pin {size} lanes) at width {width}: "
                f"{k_ms * 1e3:.2f} us/call ({form}), bound {bound * 1e3:.3f} us (bytes), "
                f"plain {p_ms * 1e3:.1f} us | {card}")
            if planned and form.form != "pair":
                # The pair form on the same pins, beside the plan's block form.
                pair_ms = device_ms(torch, lambda i: ps.launch_step(
                    counts, pins[i % 8], i & 1, ps.PAIR_PLAN), 200)
                out[f"k7_pair_{width}_{n}"] = pair_ms
                log(f"[time] K7, {n} zipf keys at width {width}, the pair form forced: "
                    f"{pair_ms * 1e3:.2f} us/call beside the block form's {k_ms * 1e3:.2f} | {card}")
        words = SKETCH_DEPTH * width
        reads = {}
        for span, delta, n_launch in (("one", 1, 50), ("both", 3, 20)):
            designs = {"K8": lambda i: ps.sketch_rotate(counts, i & 1, delta),
                       "zero_()": (lambda i: counts[i & 1].zero_()) if delta == 1
                       else (lambda i: counts.zero_())}
            got = {k: [] for k in designs}
            for k in ("K8", "zero_()", "zero_()", "K8"):
                got[k].append(device_ms(torch, designs[k], n_launch))
            reads[span] = {k: statistics.mean(v) for k, v in got.items()}
        p_ms = host_ms(torch, lambda i: ps.rotate_reference(plain, i & 1, 1), 20, windows=3)
        one, both = reads["one"], reads["both"]
        out[f"k8_{width}"] = (one["K8"], p_ms, k8_bound_ms(words), one["zero_()"])
        out[f"k8_{width}_both"] = (both["K8"], None, k8_bound_ms(2 * words), both["zero_()"])
        for span, words_n, r in (("one plane", words, one), ("both planes", 2 * words, both)):
            log(f"[time] K8 at width {width}, {span} ({words_n * 4 >> 20} MiB): "
                f"{r['K8'] * 1e3:.2f} us, zero_() {r['zero_()'] * 1e3:.2f} us, bound "
                f"{k8_bound_ms(words_n) * 1e3:.2f} us (bytes)"
                + (f", plain {p_ms * 1e3:.1f} us" if span == "one plane" else "") + f" | {card}")
        del counts, plain
        torch.cuda.empty_cache()
    return out


# ---- the h2 path: the native h2 front (net/h2_fast.py) into apply_columnar

H2_PATH = "/pb.gubernator.V1/GetRateLimits"
H2_PREFACE = b"PRI * HTTP/2.0\r\n\r\nSM\r\n\r\n"
H2_POOL = 1 << 20  # keys of the parity stream: BASELINE.json configs[1]'s 1M keys
UNIMPLEMENTED = 12


def pb_varint(v: int) -> bytes:
    """A protobuf varint (an int64 below 0 as its 10-byte two's complement)."""
    v &= (1 << 64) - 1
    out = bytearray()
    while v >= 0x80:
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    out.append(v)
    return bytes(out)


def encode_get_rate_limits(items) -> bytes:
    """GetRateLimitsReq bytes (proto3, zero fields omitted) from (name,
    unique_key, hits, limit, duration, algorithm, behavior, burst)
    tuples; the card's machine has no protobuf."""
    out = bytearray()
    for name, key, *nums in items:
        m = bytearray()
        for field, s in ((1, name), (2, key)):
            if s:
                b = s.encode()
                m += bytes([field << 3 | 2]) + pb_varint(len(b)) + b
        for field, v in zip((3, 4, 5, 6, 7, 8), nums):
            if v:
                m += bytes([field << 3]) + pb_varint(int(v))
        out += b"\x0a" + pb_varint(len(m)) + m
    return bytes(out)


def decode_responses(msg: bytes) -> list:
    """GetRateLimitsResp bytes → [(status, limit, remaining, reset_time,
    metadata)]: fields 1-4 and the metadata map, field 6, as a dict of
    str (the columnar feeder and the decision plane write a
    retry_after_ms hint there on OVER_LIMIT answers)."""
    def varint(pos):
        v = shift = 0
        while True:
            b = msg[pos]
            pos += 1
            v |= (b & 0x7F) << shift
            shift += 7
            if not b & 0x80:
                return (v - (1 << 64) if v >= 1 << 63 else v), pos

    def text(pos, end, field):
        check(msg[pos] == (field << 3 | 2), f"[h2] unexpected map entry tag {msg[pos]}")
        n, pos = varint(pos + 1)
        check(pos + n <= end, "[h2] truncated map entry")
        return msg[pos : pos + n].decode(), pos + n

    out, pos = [], 0
    while pos < len(msg):
        check(msg[pos] == 0x0A, f"[h2] unexpected tag {msg[pos]} in a response")
        ln, pos = varint(pos + 1)
        end, item, meta = pos + ln, [0, 0, 0, 0], {}
        while pos < end:
            tag = msg[pos]
            if tag == (6 << 3 | 2):
                n, pos = varint(pos + 1)
                entry_end = pos + n
                key, pos = text(pos, entry_end, 1)
                meta[key], pos = text(pos, entry_end, 2)
                check(pos == entry_end, "[h2] malformed metadata entry")
                continue
            check(tag & 7 == 0 and 1 <= tag >> 3 <= 4, f"[h2] unexpected field tag {tag}")
            item[(tag >> 3) - 1], pos = varint(pos + 1)
        check(pos == end, "[h2] truncated response item")
        out.append((*item, meta))
    check(pos == len(msg), "[h2] truncated response")
    return out


def retry_hints(msg: bytes, now_ms: int) -> int:
    """The items of a response that carry a retry_after_ms hint.  The hint
    may sit on OVER_LIMIT items only, must be max(0, reset_time - now_ms),
    and a response with one has it on every OVER_LIMIT item."""
    items = decode_responses(msg)
    hinted = 0
    for status, _lim, _rem, reset, meta in items:
        if meta:
            check(set(meta) == {"retry_after_ms"} and status == 1,
                  f"[h2] metadata {meta} on an item of status {status}")
            check(int(meta["retry_after_ms"]) == max(0, reset - now_ms),
                  f"[h2] retry_after_ms {meta['retry_after_ms']}, reset {reset}, now {now_ms}")
            hinted += 1
    if hinted:
        check(all(meta for status, *_x, meta in items if status == 1),
              "[h2] an OVER_LIMIT item without a retry_after_ms hint")
    return hinted


def h2_frame(ftype: int, flags: int, stream: int, payload: bytes = b"") -> bytes:
    return (len(payload).to_bytes(3, "big") + bytes([ftype, flags]) + stream.to_bytes(4, "big")
            + payload)


class H2Unary:
    """A short stdlib unary h2 client for distinct sequential RPCs (the
    card's machine has no grpcio): prior-knowledge preface, SETTINGS,
    HEADERS in the static-table HPACK form csrc/h2_client.cpp writes, the
    grpc-framed body in DATA frames of at most 16 KiB inside the
    connection's send window, then frames read to END_STREAM, with a
    WINDOW_UPDATE back for every DATA frame."""

    def __init__(self, address: str, timeout: float = 120.0):
        import socket

        host, port = address.rsplit(":", 1)
        self.sock = socket.create_connection((host, int(port)), timeout=timeout)
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self.next_stream = 1
        self.send_window = 65535  # connection level, the server's to grant
        self.buf = bytearray()

        def lit(s: bytes) -> bytes:  # HPACK string literal, no huffman, < 127 bytes
            return bytes([len(s)]) + s

        self.headers = (b"\x83\x86\x04" + lit(H2_PATH.encode()) + b"\x01" + lit(host.encode())
                        + b"\x0f\x10" + lit(b"application/grpc") + b"\x00" + lit(b"te")
                        + lit(b"trailers"))
        # INITIAL_WINDOW_SIZE 2^30: response DATA never waits on a stream window.
        self.sock.sendall(H2_PREFACE + h2_frame(4, 0, 0, (4).to_bytes(2, "big")
                                                + (1 << 30).to_bytes(4, "big")))

    def close(self) -> None:
        self.sock.close()

    def _frame(self):
        while True:
            if len(self.buf) >= 9:
                n = int.from_bytes(self.buf[:3], "big")
                if len(self.buf) >= 9 + n:
                    f = bytes(self.buf[: 9 + n])
                    del self.buf[: 9 + n]
                    return f[3], f[4], int.from_bytes(f[5:9], "big") & 0x7FFFFFFF, f[9:]
            chunk = self.sock.recv(1 << 16)
            if not chunk:
                raise PhaseError("[h2] the server closed the connection")
            self.buf += chunk

    def _step(self, sid: int, got: dict) -> bool:
        """Handle one frame; True once stream `sid` has ended."""
        ftype, flags, stream, payload = self._frame()
        if ftype == 8 and stream == 0:
            self.send_window += int.from_bytes(payload, "big") & 0x7FFFFFFF
        elif ftype == 4 and not flags & 1:
            self.sock.sendall(h2_frame(4, 1, 0))  # SETTINGS ACK
        elif ftype == 7 or (ftype == 3 and stream == sid):
            raise PhaseError(f"[h2] the server sent {'GOAWAY' if ftype == 7 else 'RST_STREAM'}")
        elif stream == sid and ftype == 0:
            got["data"] += payload
            if payload:
                self.sock.sendall(h2_frame(8, 0, 0, len(payload).to_bytes(4, "big")))
        elif stream == sid and ftype == 1 and flags & 1:
            got["trailers"] = payload
            return True
        return False

    def call(self, body: bytes):
        """(grpc-status, response message bytes) of one unary RPC."""
        sid = self.next_stream
        self.next_stream += 2
        data = b"\x00" + len(body).to_bytes(4, "big") + body
        self.sock.sendall(h2_frame(1, 4, sid, self.headers))
        got = {"data": b"", "trailers": b""}
        chunks = [data[i : i + 16384] for i in range(0, len(data), 16384)]
        for j, c in enumerate(chunks):
            while self.send_window < len(c):
                self._step(sid, got)
            self.send_window -= len(c)
            self.sock.sendall(h2_frame(0, 1 if j == len(chunks) - 1 else 0, sid, c))
        while not self._step(sid, got):
            pass
        tr = got["trailers"]
        i = tr.index(b"grpc-status") + len(b"grpc-status")
        status = int(tr[i + 1 : i + 1 + tr[i]])
        d = got["data"]
        if status != 0:
            return status, b""
        check(len(d) >= 5 and d[0] == 0 and int.from_bytes(d[1:5], "big") == len(d) - 5,
              "[h2] malformed grpc message frame")
        return 0, d[5:]


def h2_plain_items(np, rng, n: int, hot_cfg):
    """n plain items: keys drawn from a 2^20-key pool, 8 % on the 50 hot
    keys (each with its own config, so their repeats can collapse), token
    and leaky mixed, RESET_REMAINING on 3 %."""
    hot = rng.random(n) < 0.08
    ids = rng.integers(0, H2_POOL, n)
    hid = rng.integers(0, len(hot_cfg), n)
    algo = rng.integers(0, 2, n)
    beh = np.where(rng.random(n) < 0.03, 8, 0)
    hits = rng.choice(np.array([0, 1, 1, 1, 2, 5, -1]), n)
    limit = rng.choice(np.array([10, 100, 1000, 10**6]), n)
    dur = rng.choice(np.array([1000, 60_000, 3_600_000]), n)
    burst = rng.choice(np.array([0, 0, 0, 20]), n)
    out = []
    for j in range(n):
        if hot[j]:
            h = int(hid[j])
            out.append(("api", f"hot{h}", 1, *hot_cfg[h]))
        else:
            out.append(("api", f"k{int(ids[j])}", int(hits[j]), int(limit[j]), int(dur[j]),
                        int(algo[j]), int(beh[j]), int(burst[j])))
    return out


def h2_stream(np, rng, n_rpcs: int = 30):
    """The parity stream: `n_rpcs` RPCs of 1000 plain items, the clock
    stepped before each, with a GLOBAL, a Gregorian, a SKETCH, an
    empty-unique_key and a zero-item RPC among them.  Returns [(body,
    step ms, expected grpc-status)]."""
    hot_cfg = [(int(rng.choice([10, 100])), 60_000, h % 2, 0, 0) for h in range(50)]
    special = {3: ("global", 2), 8: ("gregorian", 4), 13: ("sketch", 32), 18: ("empty key", 0),
               23: ("zero items", 0)}
    out = []
    for r in range(n_rpcs):
        step = int(rng.choice([0, 0, 250, 1000, 61_000]))
        items = h2_plain_items(np, rng, BATCH, hot_cfg)
        status = 0
        if r in special:
            kind, bit = special[r]
            j = int(rng.integers(BATCH))
            name, key, hits, limit, dur, algo, beh, burst = items[j]
            if kind == "zero items":
                items = []
            elif kind == "empty key":
                items[j] = (name, "", hits, limit, dur, algo, beh, burst)
                status = UNIMPLEMENTED
            else:
                items[j] = (name, key, hits, limit, 1 if bit == 4 else dur, algo, beh | bit, burst)
                status = UNIMPLEMENTED
        out.append((encode_get_rate_limits(items), step, status, len(items)))
    return out


def has_feeder() -> bool:
    """The port's h2 front has the columnar feeder (a --tree checkout from
    before its slice does not)."""
    from gubernator_tpu_torch.net import h2_fast

    return hasattr(h2_fast, "native_feeder_enabled")


def feeder_modes() -> tuple:
    return (True, False) if has_feeder() else (False,)


def feeder_tag(feeder: bool) -> str:
    return "feeder on" if feeder else "GUBER_NATIVE_FEEDER=0"


@contextlib.contextmanager
def feeder_env(feeder: bool):
    """GUBER_NATIVE_FEEDER set for the daemons built inside (each front
    reads it when it is built)."""
    old = os.environ.get("GUBER_NATIVE_FEEDER")
    os.environ["GUBER_NATIVE_FEEDER"] = "1" if feeder else "0"
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("GUBER_NATIVE_FEEDER", None)
        else:
            os.environ["GUBER_NATIVE_FEEDER"] = old


def front_kw(feeder: bool) -> dict:
    return {"native_feeder": feeder} if has_feeder() else {}


def serving_threads(torch, instance, seen: list):
    """Wrap `instance.serve_decoded_local` to note, per window, the
    calling thread, the front's entry that called it (`_feeder_window` on
    the feeder's serve thread, `_serve` on the byte path's dispatch
    thread), its current device and whether its current stream is the
    device's default stream (the one every other serving thread launches
    on)."""
    import threading

    real = instance.serve_decoded_local
    dev = instance.engine.device

    def spy(dec):
        seen.append((threading.get_ident(), sys._getframe(1).f_code.co_name,
                     torch.cuda.current_device(),
                     torch.cuda.current_stream(dev) == torch.cuda.default_stream(dev)))
        return real(dec)

    instance.serve_decoded_local = spy


def settled_stats(front, n_rpcs: int, timeout: float = 10.0) -> dict:
    """A front's stats once it has counted `n_rpcs` answered RPCs: the C
    side bumps its counters after the response is sent (the feeder's
    `feeder_front_rpcs` before `rpcs`), so a client can read its answer
    before they move."""
    deadline = time.perf_counter() + timeout
    st = front.stats()
    while st["rpcs"] + st["errors"] < n_rpcs and time.perf_counter() < deadline:
        time.sleep(0.005)
        st = front.stats()
    return st


def phase_h2_parity(torch, np, rng, feeder: bool):
    """The port's daemon on the card (2^20 slots, frozen clock, its h2
    front from DaemonConfig, its columnar feeder on or off by
    GUBER_NATIVE_FEEDER) and a port instance on the CPU (2^20 slots,
    frozen clock, an H2FastFront with the feeder alike) answer the same 30
    sequential RPCs of 1000 items: grpc-status and response bytes equal
    RPC by RPC, the metadata map included, the out-of-scope RPCs
    UNIMPLEMENTED, the zero-item RPC an empty OK, and the state words
    equal at the end.  With the feeder, every OVER_LIMIT item carries a
    retry_after_ms hint equal to reset - now in the engine's clock, every
    in-scope RPC rides the feeder and only the out-of-scope and zero-item
    RPCs take byte windows; without it, no item carries one.  Every
    window runs on one thread, the feeder's serve thread (from
    `_feeder_window`) or the C server's dispatch thread (from `_serve`),
    on device 0's default stream.  Returns the card daemon (still
    serving)."""
    import threading

    from gubernator_tpu_torch.clock import Clock
    from gubernator_tpu_torch.config import DaemonConfig
    from gubernator_tpu_torch.core.engine import DecisionEngine
    from gubernator_tpu_torch.daemon import spawn_daemon
    from gubernator_tpu_torch.net.h2_fast import H2FastFront
    from gubernator_tpu_torch.service import V1Instance

    tag = f"[h2 parity, {feeder_tag(feeder)}]"
    ns = NOW0 * 1_000_000
    # The ledger's defaults (it is on) but no settle thread: the two sides
    # settle by hand at the end, so their state words compare.
    with feeder_env(feeder):
        d = spawn_daemon(DaemonConfig(http_listen_address="127.0.0.1:0", cache_size=CAP_SERVE,
                                      sweep_interval=0.0, h2_fast_address="127.0.0.1:0",
                                      **ledger_kw(ledger_settle_interval=0.0)),
                         clock=Clock().freeze_at(ns), device="cuda")
    cpu = V1Instance(DecisionEngine(CAP_SERVE, clock=Clock().freeze_at(ns), device="cpu"),
                     **ledger_kw(ledger_opts=dict(settle_interval=0.0)))
    cpu_front = H2FastFront(cpu, **front_kw(feeder))
    card_c = cpu_c = None
    try:
        check(d.instance.engine.state.meta.is_cuda, f"{tag} the daemon's engine is not on the card")
        check((getattr(d.h2_fast, "feeder", None) is not None) == feeder,
              f"{tag} the daemon's front feeder is {getattr(d.h2_fast, 'feeder', None)}")
        seen = []
        serving_threads(torch, d.instance, seen)
        card_c, cpu_c = H2Unary(d.h2_fast_address), H2Unary(cpu_front.address)
        stream = h2_stream(np, rng)
        hinted = 0
        for r, (body, step, status, n_items) in enumerate(stream):
            d.clock.advance(ms=step)
            cpu.engine.clock.advance(ms=step)
            got, want = card_c.call(body), cpu_c.call(body)
            check(got == want, f"{tag} RPC {r}: card {got[0]} / {len(got[1])} bytes, "
                  f"CPU {want[0]} / {len(want[1])} bytes: responses differ")
            check(got[0] == status, f"{tag} RPC {r}: grpc-status {got[0]}, want {status}")
            if status == 0:
                check(len(decode_responses(got[1])) == n_items, f"{tag} RPC {r}: item count")
                hinted += retry_hints(got[1], d.clock.now_ms())
        check((hinted > 0) == feeder, f"{tag} {hinted} items carry a retry_after_ms hint")
        if has_ledger():
            check(d.instance.ledger.flush_settles() == cpu.ledger.flush_settles(),
                  f"{tag} the ledgers settled different row counts")
            check(ledger_stats(d.instance) == ledger_stats(cpu), f"{tag} ledger counters")
        same_engines(np, d.instance.engine, cpu.engine, "parity", slots=True, path="h2")
        main = threading.get_ident()
        entry = "_feeder_window" if feeder else "_serve"
        served = sum(1 for s in stream if s[2] == 0 and s[3])
        check(len(seen) == served and len({t for t, *_x in seen}) == 1 and all(
            t != main and fn == entry and dev == 0 and default for t, fn, dev, default in seen),
              f"{tag} windows must run on one thread from {entry}, device 0, default stream: "
              f"{set(seen)}")
        st = settled_stats(d.h2_fast, len(stream))
        check(st["errors"] == 4 and st["rpcs"] == len(stream) - 4, f"{tag} front stats {st}")
        if feeder:
            check(st["feeder_front_rpcs"] == served and st["windows"] == len(stream) - served
                  and st["feeder_ring_full"] == 0,
                  f"{tag} the feeder must answer every in-scope RPC, the byte path the rest: {st}")
            log(f"{tag} front counters: rpcs {st['rpcs']}, errors {st['errors']}, byte windows "
                f"{st['windows']}, feeder_front_rpcs {st['feeder_front_rpcs']}, "
                f"feeder_front_items {st['feeder_front_items']}; feeder: rpcs "
                f"{st['feeder_rpcs']}, rows {st['feeder_rows']}, windows {st['feeder_windows']}, "
                f"served rows {st['feeder_served_rows']}, declined {st['feeder_declined']}, "
                f"ring full {st['feeder_ring_full']}, window errors "
                f"{st['feeder_window_errors']}")
        log(f"{tag} {len(stream)} RPCs of {BATCH} items (keys from a 2^20 pool, 8 % on 50 "
            "hot keys, token and leaky, RESET_REMAINING 3 %, clock steps) over HTTP/2 to the "
            "daemon on the card and to a CPU instance's front, both with the decision ledger on "
            "(settled by hand at the end): grpc-status and response bytes equal RPC by RPC, the "
            f"metadata map included ({hinted} items with a retry_after_ms hint, each reset - "
            "now), GLOBAL, Gregorian, SKETCH and empty-key RPCs UNIMPLEMENTED, the zero-item RPC "
            f"empty OK; state words of {CAP_SERVE} slots equal; {len(seen)} windows, each on "
            f"one thread from {entry} on device 0's default stream")
        return d
    except BaseException:
        d.close()
        raise
    finally:
        for c in (card_c, cpu_c):
            if c is not None:
                c.close()
        cpu_front.close()
        cpu.close()


def phase_h2_isolation(torch, np, rng, feeder: bool):
    """A front with a 50 ms window on a card engine, its feeder on or off:
    8 plain RPCs and one GLOBAL RPC sent at once.  Without the feeder the
    nine share one byte window; with it the eight share one feeder window
    and the GLOBAL one, declined in C, takes a byte window alone.  The
    plain ones are answered as a CPU front with the feeder alike answers
    the same items one at a time, the GLOBAL one UNIMPLEMENTED, and the
    state words equal the CPU engine's.  Returns the card engine and its
    front's stats."""
    import threading

    from gubernator_tpu_torch.clock import Clock
    from gubernator_tpu_torch.core.engine import DecisionEngine
    from gubernator_tpu_torch.net.h2_fast import H2FastFront
    from gubernator_tpu_torch.service import V1Instance

    tag = f"[h2 isolation, {feeder_tag(feeder)}]"
    ns = NOW0 * 1_000_000
    # No decision ledger: the card serves the 9 RPCs as one window and the
    # CPU as 9, so with the ledger the two would take their leases at
    # different points and hold different pre-debited credit (answers
    # equal, state words not); window isolation is the subject here.
    off = ledger_kw(ledger=False)
    gpu = V1Instance(DecisionEngine(CAP_SERVE, clock=Clock().freeze_at(ns), device="cuda"), **off)
    cpu = V1Instance(DecisionEngine(CAP_SERVE, clock=Clock().freeze_at(ns), device="cpu"), **off)
    front = H2FastFront(gpu, window_s=0.05, **front_kw(feeder))
    cpu_front = H2FastFront(cpu, window_s=0.05, **front_kw(feeder))
    hot_cfg = [(10, 60_000, 0, 0, 0)]
    bodies = []
    for r in range(9):  # 100 items each: 900 queued items stay under the early flush
        items = [(f"iso{r}", key, *rest) for _, key, *rest in h2_plain_items(np, rng, 100, hot_cfg)]
        if r == 4:
            name, key, hits, limit, dur, algo, beh, burst = items[7]
            items[7] = (name, key, hits, limit, dur, algo, beh | 2, burst)  # GLOBAL
        bodies.append(encode_get_rate_limits(items))
    clients = [H2Unary(front.address) for _ in bodies]
    try:
        got = [None] * len(bodies)
        gate = threading.Barrier(len(bodies))

        def send(i):
            gate.wait()
            got[i] = clients[i].call(bodies[i])

        threads = [threading.Thread(target=send, args=(i,)) for i in range(len(bodies))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        check(not any(t.is_alive() for t in threads), f"{tag} a client hung")
        stats = front.stats()
        check(stats["windows"] == 1, f"{tag} the byte path took {stats['windows']} windows")
        if feeder:
            check(stats["feeder_windows"] == 1,
                  f"{tag} the 8 plain RPCs took {stats['feeder_windows']} feeder windows")
        c = H2Unary(cpu_front.address)
        try:
            want = [c.call(b) for b in bodies]  # one at a time: the CPU's own windows
        finally:
            c.close()
        for i, (g, w) in enumerate(zip(got, want)):
            check(g == w, f"{tag} RPC {i}: card {g[0]}, CPU {w[0]}: responses differ")
        check([g[0] for g in got] == [0] * 4 + [UNIMPLEMENTED] + [0] * 4,
              f"{tag} statuses {[g[0] for g in got]}")
        same_engines(np, gpu.engine, cpu.engine, "isolation", slots=False, path="h2")
        log(f"{tag} 8 plain RPCs and 1 GLOBAL RPC at once, 50 ms window, on the card: "
            + ("the 8 in one feeder window, the GLOBAL one alone in a byte window"
               if feeder else "all 9 in one byte window")
            + "; the plain ones answered byte-equal to a CPU front's, the GLOBAL one "
            "UNIMPLEMENTED, live keys' state words equal")
        return gpu.engine, stats
    finally:
        for cl in clients:
            cl.close()
        front.close()
        cpu_front.close()
        cpu.close()


def latency_stats(np, lats) -> tuple:
    lat_ms = np.asarray(lats) * 1e3
    return float(np.percentile(lat_ms, 50)), float(np.percentile(lat_ms, 99))


def phase_h2_load(torch, np, rng, card, feeder: bool):
    """Readings, not claims, on a daemon on the card with a live clock
    (2^20 slots, the default 2 ms window, its feeder on or off by
    GUBER_NATIVE_FEEDER), through the port's native client
    (core/h2_client.py bench_unary): the reference's "herdfast" shape
    (single-item RPCs on one hot key, token bucket, limit 10^9, from 32
    connections for 2 s: no errors, and the key's remaining within
    [limit - rpcs - 32, limit - rpcs], since each connection has at most
    one RPC in flight the client never counted), then a 1-connection
    closed loop of one 1000-item leaky-bucket RPC (BASELINE.json
    configs[1]) for 3 s, at the daemon's 2 ms window and through a second
    front on the same instance with no window (a lone RPC otherwise waits
    the whole group-commit window; the feeder keeps its 2 ms default when
    given 0, as the reference's does).  With the feeder no RPC takes a
    byte window.  Returns (the card daemon, readings)."""
    from gubernator_tpu_torch.config import DaemonConfig
    from gubernator_tpu_torch.core import h2_client
    from gubernator_tpu_torch.daemon import spawn_daemon
    from gubernator_tpu_torch.net.h2_fast import H2FastFront

    mode = feeder_tag(feeder)
    limit = 10**9
    with feeder_env(feeder):
        d = spawn_daemon(DaemonConfig(http_listen_address="127.0.0.1:0", cache_size=CAP_SERVE,
                                      sweep_interval=0.0, h2_fast_address="127.0.0.1:0"),
                         device="cuda")
    try:
        check((getattr(d.h2_fast, "feeder", None) is not None) == feeder,
              f"[h2 herd, {mode}] the front's feeder")
        herd = encode_get_rate_limits([("herd", "hot", 1, limit, 3_600_000, 0, 0, 0)])
        w0 = d.h2_fast.stats()
        res = h2_client.bench_unary(d.h2_fast_address, H2_PATH, herd, 2.0, 32)
        check(res is not None, f"[h2 herd, {mode}] the native client could not connect")
        rpcs, errors, lats, _frame, connected = res
        check(errors == 0 and connected == 32 and rpcs > 0,
              f"[h2 herd, {mode}] rpcs {rpcs}, errors {errors}, connected {connected}")
        w1 = d.h2_fast.stats()
        c = H2Unary(d.h2_fast_address)
        try:
            status, msg = c.call(encode_get_rate_limits(
                [("herd", "hot", 0, limit, 3_600_000, 0, 0, 0)]))
        finally:
            c.close()
        check(status == 0, f"[h2 herd, {mode}] read-back status {status}")
        rem = decode_responses(msg)[0][2]
        check(limit - rpcs - 32 <= rem <= limit - rpcs,
              f"[h2 herd, {mode}] remaining {rem} outside [{limit - rpcs - 32}, {limit - rpcs}]")
        if feeder:
            check(w1["windows"] == w0["windows"], f"[h2 herd, {mode}] byte windows "
                  f"{w1['windows'] - w0['windows']}")
        p50, p99 = latency_stats(np, lats)
        herd_read = dict(rpcs=rpcs, rps=rpcs / 2.0, p50=p50, p99=p99,
                         windows_per_rpc=(w1["windows"] - w0["windows"]) / max(1, w1["rpcs"] - w0["rpcs"]))
        log(f"[h2 herd, {mode}] 32 connections x single-item RPCs on one key, 2 s: {rpcs} RPCs "
            f"({rpcs / 2.0:.0f} RPCs/s), 0 errors, p50 {p50:.3f} ms, p99 {p99:.3f} ms, "
            f"{herd_read['windows_per_rpc']:.4f} byte windows per RPC, "
            f"{w1.get('native_rpcs', 0) - w0.get('native_rpcs', 0)} RPCs answered by the plane, "
            f"{w1.get('feeder_front_rpcs', 0) - w0.get('feeder_front_rpcs', 0)} by the feeder; "
            f"remaining {rem} in [limit - rpcs - 32, limit - rpcs] | {card}")
        pool = rng.choice(H2_POOL, BATCH, replace=False)
        leaky = encode_get_rate_limits([("api", f"k{int(k)}", 1, 1000, 60_000, 1, 0, 0)
                                        for k in pool])
        reads = {}
        # No plane on the second front: the daemon's front keeps its own.
        no_window = H2FastFront(d.instance, window_s=0.0, **ledger_kw(native_ledger=False),
                                **front_kw(feeder))
        try:
            for tag, front in (("2 ms window", d.h2_fast), ("no window", no_window)):
                w0 = front.stats()
                res = h2_client.bench_unary(front.address, H2_PATH, leaky, 3.0, 1)
                check(res is not None and res[1] == 0 and res[0] > 0,
                      f"[h2 1000, {mode}] closed loop failed: {res and res[:2]}")
                rpcs, _, lats, frame, _ = res
                check(len(decode_responses(frame[5:])) == BATCH,
                      f"[h2 1000, {mode}] response item count")
                w1 = front.stats()
                if feeder:
                    check(w1["windows"] == w0["windows"],
                          f"[h2 1000, {mode}] {tag}: byte windows {w1['windows'] - w0['windows']}")
                p50, p99 = latency_stats(np, lats)
                reads[tag] = dict(rpcs=rpcs, rps=rpcs / 3.0, p50=p50, p99=p99,
                                  windows_per_rpc=(w1["windows"] - w0["windows"])
                                  / max(1, w1["rpcs"] - w0["rpcs"]))
                log(f"[h2 1000, {mode}] {tag}: 1 connection, closed loop of one {BATCH}-item "
                    f"leaky-bucket RPC (2^20 slots), 3 s: {rpcs} RPCs ({rpcs / 3.0:.1f} RPCs/s, "
                    f"{rpcs * BATCH / 3.0:.0f} decisions/s), p50 {p50:.3f} ms, p99 {p99:.3f} ms "
                    f"({'under' if p99 < 2.0 else 'over'} the 2 ms limit), "
                    f"{reads[tag]['windows_per_rpc']:.4f} byte windows per RPC | {card}")
        finally:
            no_window.close()
        return d, dict(herd=herd_read, **reads)
    except BaseException:
        d.close()
        raise


def phase_h2(torch, np, rng, card):
    """The h2 path, with the columnar feeder (the default) and with
    GUBER_NATIVE_FEEDER=0: in each mode the parity stream, window
    isolation, the herd and the 1000-item loop, the launch counts from 0
    just before the mode and read just after, its fronts and daemons
    closed.  Returns, by feeder mode, the launch counts, the launches its
    card engines counted and the readings, and the windows and RPCs of
    all the fronts."""
    from gubernator_tpu_torch.ops import fused_step as fs

    launches, disp, readings, windows, rpcs = {}, {}, {}, 0, 0
    for feeder in feeder_modes():
        tag = feeder_tag(feeder)
        fs.reset_launches()
        daemons, engines, stats = [], [], []
        try:
            daemons.append(phase_h2_parity(torch, np, rng, feeder))
            iso, iso_stats = phase_h2_isolation(torch, np, rng, feeder)
            engines.append(iso)
            stats.append(iso_stats)
            load_daemon, readings[tag] = phase_h2_load(torch, np, rng, card, feeder)
            daemons.append(load_daemon)
            stats += [x.h2_fast.stats() for x in daemons]
        finally:
            for x in daemons:
                x.close()
            for e in engines:
                e.close()
        launches[tag] = dict(fs.launches)
        disp[tag] = sum(e.dispatches_total for e in engines + [x.instance.engine for x in daemons])
        windows += sum(st["windows"] for st in stats)
        rpcs += sum(st["rpcs"] + st["errors"] for st in stats)
    return launches, disp, readings, (windows, rpcs)


# ---------------------------------------------------------------- ledger

LEDGER_HOT = 64  # hot keys of the ledger stream, each with its own config
LEDGER_BATCHES = 60


def has_ledger() -> bool:
    """The driven port has the decision ledger (a --tree checkout from
    before it has not)."""
    return importlib.util.find_spec("gubernator_tpu_torch.core.ledger") is not None


def ledger_kw(**kw) -> dict:
    """`kw` for V1Instance / DaemonConfig when the port has the ledger,
    else nothing (an older --tree port takes no ledger arguments)."""
    return kw if has_ledger() else {}


def ledger_stream(np, rng, n_batches: int = LEDGER_BATCHES):
    """The ledger parity stream: [(kind, items, clock step ms)], items as
    (name, unique_key, hits, limit, duration, algorithm, behavior, burst).
    "columnar" batches (1000 items) go through serve_decoded_local, every
    sixth batch is a "dataclass" one (200 items, Gregorian ones among
    them) through get_rate_limits.  30 % of the items fall on LEDGER_HOT
    hot keys (zipf 1.3 over them: a few take most), token buckets with a
    limit of 50 (they run out: sticky OVER), 2000 or 10^6 (leases) and
    durations of 1 s or 1 min, every eighth one leaky (never leased);
    the rest on a 2^20-key pool, token and leaky.  Events on hot keys:
    RESET_REMAINING, a limit change, a duration change, an over-ask of
    600 hits (above the 512-hit lease), negative hits and hits-0 reads;
    clock steps of 0 to 40 ms, 250 ms (past the 0.2 s lease TTL) and,
    every 15th batch, 1.1 s (past the 1 s resets)."""
    cfg = [[int(rng.choice([50, 2000, 10**6])), int(rng.choice([1000, 60_000]))]
           for _ in range(LEDGER_HOT)]

    def hot_item(h, hits=1, behavior=0):
        lim, dur = cfg[h]
        return ("led", f"h{h}", hits, lim, dur, 1 if h % 8 == 7 else 0, behavior, 0)

    out = []
    for b in range(n_batches):
        step = 1100 if b % 15 == 14 else int(rng.choice([0, 0, 3, 10, 40, 250]))
        dataclass = b % 6 == 5
        n = 200 if dataclass else BATCH
        hot = rng.random(n) < 0.3
        items = []
        for j in range(n):
            if hot[j]:
                h = int(rng.zipf(1.3) - 1) % LEDGER_HOT
                items.append(hot_item(h, hits=0 if rng.random() < 0.08 else 1))
            else:
                items.append(("led", f"k{int(rng.integers(H2_POOL))}",
                              int(rng.choice([0, 1, 1, 2, 5])), int(rng.choice([10, 100, 10**6])),
                              int(rng.choice([1000, 60_000])), int(rng.integers(2)), 0, 0))
        events = []
        if rng.random() < 0.3:
            events.append(hot_item(int(rng.integers(4)), behavior=8))  # RESET_REMAINING
        if rng.random() < 0.15:
            h = int(rng.integers(8))
            cfg[h][0] = int(rng.choice([50, 2000, 10**6]))  # a limit change
        if rng.random() < 0.1:
            h = int(rng.integers(8))
            cfg[h][1] = 60_000 if cfg[h][1] == 1000 else 1000  # a duration change
        if rng.random() < 0.2:
            events.append(hot_item(int(rng.integers(4)), hits=600))  # an over-ask
        if rng.random() < 0.1:
            events.append(hot_item(int(rng.integers(4)), hits=-3))  # negative hits
        if dataclass:
            for _ in range(20):  # Gregorian intervals (minutes .. years)
                key = f"h{int(rng.integers(4))}" if rng.random() < 0.3 else \
                    f"g{int(rng.integers(1000))}"
                events.append(("led", key, 1, 100, int(rng.integers(1, 6)), 0, 4, 0))
        for ev in events:
            items.insert(int(rng.integers(len(items) + 1)), ev)
        out.append(("dataclass" if dataclass else "columnar", items, step))
    return out


def ledger_requests(items):
    from gubernator_tpu_torch.types import RateLimitReq

    return [RateLimitReq(name=name, unique_key=key, hits=hits, limit=limit, duration=dur,
                         algorithm=algo, behavior=beh, burst=burst)
            for name, key, hits, limit, dur, algo, beh, burst in items]


def ledger_stats(inst) -> dict:
    """The ledger's counters, less the mean settle lag (a wall-clock
    reading)."""
    st = inst.ledger.stats()
    st.pop("settle_lag_ms_mean")
    return st


def phase_ledger_parity(torch, np, rng):
    """(a) One V1Instance on the card and one on the CPU (2^20 slots each,
    frozen clocks stepped alike, the ledger's defaults but no settle
    thread) answer the ledger stream: columnar batches through
    `serve_decoded_local` (the h2 front's serve: ledger plan, engine lane
    of return rows + fall-through rows + acquisition rows, learn), the
    dataclass ones through `get_rate_limits` (invalidate_keys, then the
    engine).  Answers equal row for row; after `flush_settles` on both,
    equal return counts, ledger counters and state words of every slot.
    Keeps a copy of the inputs (and the state) of K1 launches on the card
    whose pin holds a negative-hit row (a ledger return row), for the hold
    against K1's plain version.  Returns (the card engine, those captures,
    the counters)."""
    from gubernator_tpu_torch.clock import Clock
    from gubernator_tpu_torch.core import engine as engine_mod
    from gubernator_tpu_torch.core.engine import DecisionEngine
    from gubernator_tpu_torch.net import wire_codec
    from gubernator_tpu_torch.service import COLUMNAR_DISQUALIFIERS, V1Instance

    ns = NOW0 * 1_000_000
    card = V1Instance(DecisionEngine(CAP_SERVE, clock=Clock().freeze_at(ns), device="cuda"),
                      ledger_opts=dict(settle_interval=0.0))
    cpu = V1Instance(DecisionEngine(CAP_SERVE, clock=Clock().freeze_at(ns), device="cpu"),
                     ledger_opts=dict(settle_interval=0.0))
    captured = []
    real_k1 = engine_mod.multi_fused_step

    def k1(state, pin, *args, **kw):
        # Row 4 of the general pin is each lane's hits_hi word: below 0
        # only on a return row's negative hits.
        if state.meta.is_cuda and len(captured) < 3 and bool((pin[4] < 0).any()):
            captured.append((copy_state(state), (pin.clone(), *(a.clone() for a in args)),
                             dict(kw)))
        return real_k1(state, pin, *args, **kw)

    engine_mod.multi_fused_step = k1
    try:
        stream = ledger_stream(np, rng)
        for b, (kind, items, step) in enumerate(stream):
            for inst in (card, cpu):
                inst.engine.clock.advance(ms=step)
            if kind == "dataclass":
                reqs = ledger_requests(items)
                got, want = card.get_rate_limits(reqs), cpu.get_rate_limits(reqs)
                check(got == want, f"[ledger parity] dataclass batch {b}: answers differ")
                continue
            dec = wire_codec.decode_reqs(encode_get_rate_limits(items), BATCH + 16,
                                         COLUMNAR_DISQUALIFIERS)
            check(dec is not None and dec.n == len(items), f"[ledger parity] batch {b}: decode")
            got = card.serve_decoded_local(dec)
            want = cpu.serve_decoded_local(dec)
            for col, (g, w) in enumerate(zip(got, want)):
                check(np.array_equal(np.asarray(g, np.int64), np.asarray(w, np.int64)),
                      f"[ledger parity] batch {b}: answer column {col} differs")
    finally:
        engine_mod.multi_fused_step = real_k1
    try:
        n_card, n_cpu = card.ledger.flush_settles(), cpu.ledger.flush_settles()
        check(n_card == n_cpu, f"[ledger parity] settles {n_card} on the card, {n_cpu} on the CPU")
        stats = ledger_stats(card)
        check(stats == ledger_stats(cpu),
              f"[ledger parity] counters: card {stats}, CPU {ledger_stats(cpu)}")
        same_engines(np, card.engine, cpu.engine, "ledger stream", slots=True, path="ledger")
        for k in ("answered", "leases_granted", "leases_revoked", "settles", "over_entries"):
            check(stats[k] > 0, f"[ledger parity] the stream made no {k}: {stats}")
        check(captured and all(bool((args[0][4] < 0).any()) for _s, args, _kw in captured),
              "[ledger parity] no K1 launch on the card held a ledger return row")
        cols = sum(1 for s in stream if s[0] == "columnar")
        log(f"[ledger parity] {cols} columnar batches of {BATCH} items through "
            f"serve_decoded_local and {len(stream) - cols} dataclass batches of ~220 (Gregorian "
            "among them) through get_rate_limits, card vs CPU at 2^20 slots: answers equal row "
            f"for row; after flush_settles ({n_card} return rows each) state words of every "
            f"slot and the ledger counters equal: {stats}")
        return card.engine, captured, stats
    finally:
        card.ledger.close()
        cpu.close()


def hold_ledger_k1(torch, errs, captured) -> None:
    """K1 against its plain version on the captured ledger launches (pins
    that hold negative-hit return rows), output and state words."""
    from gubernator_tpu_torch.ops import bucket_kernel as tk
    from gubernator_tpu_torch.ops import fused_step as fs

    hold = make_hold(torch, errs)
    for state, args, kw in captured:
        plain = copy_state(state)
        hold("fused_step", fs.multi_fused_step(state, *args, **kw),
             tk.multi_fused_step_reference(plain, *args), state, plain,
             "a ledger lane with return rows")
    log(f"[ledger kernels] K1 on {len(captured)} launches of the ledger stream whose pins hold "
        "negative-hit return rows: equal to its plain version, output and state words")


def post_json(address: str, items) -> list:
    body = json.dumps({"requests": [
        {"name": n, "unique_key": k, "hits": h, "limit": lim, "duration": d}
        for n, k, h, lim, d in items]}).encode()
    with urllib.request.urlopen(urllib.request.Request(
            f"http://{address}/v1/GetRateLimits", data=body, method="POST"), timeout=60) as r:
        return json.loads(r.read())["responses"]


def live_daemon(**kw):
    """The port's daemon on the card with the live clock, its h2 front on
    (the default 2 ms window) and the ledger's defaults unless `kw` says
    otherwise."""
    from gubernator_tpu_torch.config import DaemonConfig
    from gubernator_tpu_torch.daemon import spawn_daemon

    return spawn_daemon(DaemonConfig(http_listen_address="127.0.0.1:0", cache_size=CAP_SERVE,
                                     sweep_interval=0.0, h2_fast_address="127.0.0.1:0", **kw),
                        device="cuda")


def phase_ledger_live(torch, np):
    """(b) The daemon on the live clock with its defaults: the h2 front
    attaches the native decision plane.  60 sequential single-item RPCs
    on one key (limit 10^6, 1 h) answer limit-1 .. limit-60 exactly, some
    of them in C (native_rpcs > 0); one HTTP request continues at
    limit-61 (the dataclass path pulls the lease through
    invalidate_keys), one more h2 RPC at limit-62.  Returns the daemon's
    engine."""
    limit = 10**6
    d = live_daemon()
    try:
        check(d.h2_fast.plane is not None, "[ledger live] the h2 front attached no decision plane")
        check(d.instance.ledger._native is d.h2_fast.plane,
              "[ledger live] the plane is not attached to the ledger")
        body = encode_get_rate_limits([("live", "hot", 1, limit, 3_600_000, 0, 0, 0)])
        c = H2Unary(d.h2_fast_address)
        try:
            rems = []
            for _ in range(60):
                status, msg = c.call(body)
                check(status == 0, f"[ledger live] grpc-status {status}")
                rems.append(decode_responses(msg)[0][2])
            check(rems == list(range(limit - 1, limit - 61, -1)),
                  f"[ledger live] remainings {rems}")
            native = d.h2_fast.stats()["native_rpcs"]
            check(native > 0, "[ledger live] no RPC was answered by the plane")
            got = post_json(d.http_address, [("live", "hot", 1, limit, 3_600_000)])
            check(got[0]["remaining"] == str(limit - 61), f"[ledger live] HTTP answer {got}")
            status, msg = c.call(body)
            check(status == 0 and decode_responses(msg)[0][2] == limit - 62,
                  f"[ledger live] h2 after HTTP: {status} {decode_responses(msg)}")
        finally:
            c.close()
        log(f"[ledger live] daemon on the live clock, plane attached: 60 h2 RPCs answered "
            f"limit-1 .. limit-60 exactly ({native} of them in C), HTTP continued at limit-61, "
            "h2 at limit-62")
        return d.instance.engine
    finally:
        d.close()


# The conservation herd: 32 connections of CONSERVE_RPCS single-item RPCs
# each, twice CONSERVE_LIMIT in all, within CONSERVE_DEADLINE_S (at about
# 1,000 RPCs/s, the slowest an H100 host has given, it takes about 6 s).
CONSERVE_LIMIT = 3000
CONSERVE_RPCS = -(-2 * CONSERVE_LIMIT // 32)
CONSERVE_DEADLINE_S = 60.0


def phase_ledger_conserve(torch, np):
    """(c) The herd on a key whose limit is below the hits sent: 32
    connections (Python clients, one thread each) of single-item RPCs on
    the default daemon (plane attached), CONSERVE_RPCS each, twice the
    limit in all.  The herd is counted, not timed: the Python clients'
    rate follows the host's load (2,047 to 7,036 RPCs in 2 s beside one
    H100), and a timed herd can fall short of the limit.  UNDER answers
    never exceed the limit, and once the front is stopped (its plane's
    leases pulled back) and `invalidate_keys` has returned the unused
    credit, the bucket's remaining on the device is exactly limit -
    UNDER.  Returns the daemon's engine."""
    import threading

    limit, each = CONSERVE_LIMIT, CONSERVE_RPCS
    d = live_daemon()
    body = encode_get_rate_limits([("cons", "hot", 1, limit, 3_600_000, 0, 0, 0)])
    under = [0] * 32
    total = [0] * 32
    errors = []
    start = threading.Barrier(33)

    def conn(i):
        c = H2Unary(d.h2_fast_address)
        try:
            start.wait()
            end = time.perf_counter() + CONSERVE_DEADLINE_S
            while total[i] < each and time.perf_counter() < end:
                status, msg = c.call(body)
                if status != 0:
                    errors.append(status)
                    return
                total[i] += 1
                under[i] += decode_responses(msg)[0][0] == 0
        finally:
            c.close()

    try:
        threads = [threading.Thread(target=conn, args=(i,)) for i in range(32)]
        for t in threads:
            t.start()
        start.wait()
        t0 = time.perf_counter()
        for t in threads:
            t.join(timeout=120)
        seconds = time.perf_counter() - t0
        check(not any(t.is_alive() for t in threads) and not errors,
              f"[ledger conserve] clients failed: {errors[:5]}")
        admitted, sent = sum(under), sum(total)
        native = d.h2_fast.stats()["native_rpcs"]
        check(sent > limit, f"[ledger conserve] only {sent} RPCs sent, limit {limit}")
        check(admitted <= limit, f"[ledger conserve] {admitted} admitted, limit {limit}")
        d.h2_fast.close()  # detaches the plane: its leases come back to the ledger
        d.instance.ledger.invalidate_keys([b"cons_hot"])
        st, _lim, rem, _rst = d.instance.engine.apply_columnar(
            [b"cons_hot"], np.zeros(1, np.int32), np.zeros(1, np.int32), np.zeros(1, np.int64),
            np.full(1, limit, np.int64), np.full(1, 3_600_000, np.int64), np.zeros(1, np.int64))
        check(int(rem[0]) == limit - admitted,
              f"[ledger conserve] remaining {int(rem[0])} on the device, limit - admitted = "
              f"{limit - admitted}")
        log(f"[ledger conserve] 32 connections x {each} single-item RPCs on a limit-{limit} key, "
            f"{seconds:.2f} s: {sent} RPCs ({native} answered in C), {admitted} UNDER "
            f"(<= limit); after the plane was pulled and the key settled, remaining "
            f"{int(rem[0])} = limit - admitted")
        return d.instance.engine
    finally:
        d.close()


def herd_reading(np, d, card, tag):
    """The "herdfast" shape through the native client: 32 connections of
    single-item RPCs on one key (limit 10^9, 1 h) for 2 s.  Returns
    (rps, p50 ms, p99 ms, share of RPCs answered in C)."""
    from gubernator_tpu_torch.core import h2_client

    limit = 10**9
    herd = encode_get_rate_limits([("herd", "hot", 1, limit, 3_600_000, 0, 0, 0)])
    s0 = d.h2_fast.stats()
    res = h2_client.bench_unary(d.h2_fast_address, H2_PATH, herd, 2.0, 32)
    check(res is not None, f"[ledger herd] {tag}: the native client could not connect")
    rpcs, errors, lats, _frame, connected = res
    check(errors == 0 and connected == 32 and rpcs > 0,
          f"[ledger herd] {tag}: rpcs {rpcs}, errors {errors}, connected {connected}")
    s1 = d.h2_fast.stats()
    share = (s1.get("native_rpcs", 0) - s0.get("native_rpcs", 0)) / max(1, s1["rpcs"] - s0["rpcs"])
    p50, p99 = latency_stats(np, lats)
    log(f"[ledger herd] {tag}: 32 connections x single-item RPCs on one key, 2 s: {rpcs} RPCs "
        f"({rpcs / 2.0:.0f} RPCs/s), 0 errors, p50 {p50:.3f} ms, p99 {p99:.3f} ms, "
        f"{share:.4f} of RPCs answered in C | {card}")
    return rpcs / 2.0, p50, p99, share


def phase_ledger_readings(torch, np, card):
    """(d) Readings, not claims: the herd on the default daemon (ledger and
    plane on) and on one with GUBER_LEDGER=0 (the path before the ledger),
    back to back.  Returns (their engines, readings)."""
    engines, read = [], {}
    for tag, kw in (("ledger on", {}), ("GUBER_LEDGER=0", {"ledger": False})):
        d = live_daemon(**kw)
        try:
            check((d.h2_fast.plane is not None) == (not kw),
                  f"[ledger herd] {tag}: plane {d.h2_fast.plane}")
            read[tag] = herd_reading(np, d, card, tag)
            engines.append(d.instance.engine)
        finally:
            d.close()
    return engines, read


def phase_ledger(torch, np, rng, card):
    """The ledger path: parity (a), the live plane (b), conservation (c)
    and the herd readings (d).  Returns (its card engines, the K1
    captures, readings)."""
    eng, captured, _stats = phase_ledger_parity(torch, np, rng)
    engines = [eng, phase_ledger_live(torch, np), phase_ledger_conserve(torch, np)]
    more, read = phase_ledger_readings(torch, np, card)
    return engines + more, captured, read


# ---------------------------------------------------------------------------
# The paged path: paged state (core/paging.py) with K9, the page spill, and
# K10, the refill (csrc/page_words.cu)

# (a) the shape of the reference's zipfpaged bench (BENCH_r18_cpu_zipfpaged.json):
# pages of 64 rows, 1024 frames (65,536 resident rows), 655,360 logical keys.
PAGED_A = (64, 1024, 655_360)
# (b) the zipf deployment's device size: pages of 512 (the default), 2^24
# resident rows (32,768 frames, ZIPF_CAP, 800 MB), 2^25 logical keys (a
# 1.6 GB host store, 2x the frames).
PAGED_B = (512, 1 << 15, 1 << 25)
PAGED_FILL = 8192  # fill batches
PAGED_A_BATCH, PAGED_A_BATCHES = 1024, 100  # (a)'s zipf batches
PAGED_B_BATCHES = 48  # (b)'s zipf batches of ZIPF_BATCH
PAGED_DURATION = 3_600_000  # the zipf deployment's 1 h


def has_paging() -> bool:
    from gubernator_tpu_torch.ops import fused_step as fs

    return "gather_pages" in fs.launches


# 64 MiB copied each way between pinned host memory and the card: the
# card's own PCIe rate, which bounds a fault batch's words.
PINNED_COPY_BYTES = 64 << 20


def pinned_copy_rates(torch) -> tuple:
    """(host-to-device, device-to-host) bytes/s of one 64 MiB pinned
    `copy_` each way, the median of 7 (CUDA events)."""
    host = torch.empty(PINNED_COPY_BYTES, dtype=torch.uint8, pin_memory=True)
    dev = torch.empty(PINNED_COPY_BYTES, dtype=torch.uint8, device="cuda")
    up = device_ms(torch, lambda i: dev.copy_(host, non_blocking=True), 4)
    down = device_ms(torch, lambda i: host.copy_(dev, non_blocking=True), 4)
    del host, dev
    return PINNED_COPY_BYTES / (up * 1e-3), PINNED_COPY_BYTES / (down * 1e-3)


def pcie_bound_ms(k: int, ks: int, page: int, rates: tuple) -> float:
    """A fault batch: k pages of 12 x 4 B x page rows up and ks down over
    PCIe, both directions at once, each at the card's pinned-copy rate;
    the frames' HBM reads and writes of the same bytes are far below it."""
    block = 12 * 4 * page
    return max(k * block / rates[0], ks * block / rates[1],
               2 * k * block / HBM_BYTES_PER_S) * 1e3


@contextlib.contextmanager
def engine_env(**values):
    """These GUBER_* variables (None: unset) while engines are built (an
    engine reads them at construction), the environment as it was
    afterwards."""
    old = {k: os.environ.get(k) for k in values}
    for k, v in values.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def paged_env(page: int, frames: int):
    """GUBER_PAGED=1 with these knobs while engines are built."""
    return engine_env(GUBER_PAGED="1", GUBER_PAGE_SIZE=str(page),
                      GUBER_PAGED_RESIDENT=str(frames))


def paged_keys(np, idx):
    """PackedKeys of key indexes, b"pg" and 7 hex digits each: 2^25 keys
    with no Python object per key."""
    from gubernator_tpu_torch.core.engine import PackedKeys

    idx = np.asarray(idx, dtype=np.int64)
    n = len(idx)
    hexd = np.frombuffer(b"0123456789abcdef", np.uint8)
    buf = np.empty((n, 9), np.uint8)
    buf[:, 0], buf[:, 1] = ord("p"), ord("g")
    buf[:, 2:] = hexd[(idx[:, None] >> (4 * np.arange(6, -1, -1))) & 15]
    return PackedKeys(buf.reshape(-1), np.arange(0, 9 * n + 1, 9, dtype=np.int64), n)


def paged_cols(np, idx):
    """The zipf deployment's config: the algorithm a property of the key,
    hits 1, limit and burst 10^6, duration 1 h."""
    n = len(idx)
    return ((np.asarray(idx) % 2).astype(np.int32), np.zeros(n, np.int32), np.ones(n, np.int64),
            np.full(n, 10**6, np.int64), np.full(n, PAGED_DURATION, np.int64),
            np.full(n, 10**6, np.int64))


def paged_zipf(np, rng, perm, n):
    """n key indexes: zipf(1.2) ranks over the keys in the seeded order
    `perm`, so hot keys lie on pages all over the key space."""
    return perm[(rng.zipf(ZIPF_S, n) - 1) % len(perm)]


def same_answers(np, got, want, what: str) -> None:
    for g, w in zip(got, want):
        check(np.array_equal(np.asarray(g), np.asarray(w)), f"{what}: answers differ")


def same_paging(np, tk, a, b, what: str, *, words: bool = False) -> None:
    """Counters and page table of two paged engines; with `words`, the host
    words of used pages and the device words too."""
    pa, pb = a.paging, b.paging
    ca, cb = (pa.faults, pa.spills, pa.refills), (pb.faults, pb.spills, pb.refills)
    check(ca == cb, f"{what}: faults / spills / refills {ca} vs {cb}")
    for name in ("frame_of", "page_of", "_ref", "_ever_used"):
        check(np.array_equal(getattr(pa, name), getattr(pb, name)), f"{what}: {name} differs")
    check(pa._hand == pb._hand, f"{what}: clock hand {pa._hand} vs {pb._hand}")
    if words:
        used = np.nonzero(pa._ever_used)[0]
        check(np.array_equal(pa.host_words[used], pb.host_words[used]), f"{what}: host words")
        wa, wb = tk.state_to_numpy(a.state), tk.state_to_numpy(b.state)
        for f in tk.BucketState._fields:
            check(np.array_equal(wa[f], wb[f]), f"{what}: device words ({f})")


def extreme_page_state(torch, np, rng, cap: int):
    """Every bit pattern likely: bit 31 set in the `*_lo` columns."""
    from gubernator_tpu_torch.ops import bucket_kernel as tk

    return tk.BucketState(*(torch.from_numpy(rng.integers(
        -(2**31), 2**31, cap, dtype=np.int64).astype(np.int32)).cuda()
        for _ in tk.BucketState._fields))


def page_bound_ms(k: int, page: int) -> float:
    """K9 / K10: 12 columns x 4 B x page rows of k pages, read once and
    written once."""
    return 2 * 12 * 4 * page * k / HBM_BYTES_PER_S * 1e3


def phase_paged_kernels(torch, np, rng, errs):
    """(c) K9 and K10 bit-equal to their plain versions at P = 16, 64 and
    512 with k = 1 and 64 pages, starts at row 0 and at the last frame,
    on state with extreme words."""
    from gubernator_tpu_torch.ops import bucket_kernel as tk
    from gubernator_tpu_torch.ops.page_words import gather_pages, load_pages

    frames = 256
    for page in (16, 64, 512):
        cap = frames * page
        state = extreme_page_state(torch, np, rng, cap)
        plain = copy_state(state)
        spread = np.sort(rng.choice(frames, 64, replace=False)) * page
        spread[0], spread[-1] = 0, cap - page
        for starts in ([0], [cap - page], spread):
            k = len(starts)
            st = torch.from_numpy(np.asarray(starts, np.int32)).cuda()
            got = gather_pages(state, st, page)
            want = tk.gather_page_words_reference(plain, st, page)
            torch.cuda.synchronize()
            err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
            errs["gather_pages"] = max(errs["gather_pages"], err)
            check(err == 0, f"K9 differs from its plain version at P={page} k={k}")
            check(bool((want[:, tk.BucketState._fields.index("rem_lo")] < 0).any()),
                  "K9's inputs must set bit 31 of the *_lo words")
            words = torch.from_numpy(rng.integers(-(2**31), 2**31, (k, 12, page),
                                                  dtype=np.int64).astype(np.int32)).cuda()
            load_pages(state, st, words)
            tk.load_page_words_reference(plain, st, words)
            torch.cuda.synchronize()
            err = compare_states(torch, state, plain)
            errs["load_pages"] = max(errs["load_pages"], err)
            check(err == 0, f"K10 differs from its plain version at P={page} k={k}")
        del state, plain
    log("[paged kernels] K9 / K10 bit-equal to their plain versions at P = 16, 64, 512, "
        "k = 1 and 64, starts at row 0 and at the last frame")


def hot_sketch(engine):
    """A frozen-clock hot-key sketch wired into `engine`'s eviction clock as
    the service wires it (V1Instance._hot_slots_provider)."""
    from gubernator_tpu_torch.service import V1Instance
    from gubernator_tpu_torch.utils.hotkeys import SpaceSaving

    sk = SpaceSaving(capacity=1024, window_s=5.0, now=lambda: 1.0)
    engine.paging.hot_slots_provider = V1Instance._hot_slots_provider(engine, sk)
    return sk


def phase_paged_parity(torch, np, rng, tmp: Path):
    """(a) Paged card engine against a paged CPU engine (same knobs) and a
    dense card engine at the logical capacity: the fill, the zipf stream
    with the hot-key provider, a checkpoint load with no fault, and a sweep
    of cold expired rows with no fault.  Returns the card engines."""
    from gubernator_tpu_torch.checkpoint import NpzFileLoader
    from gubernator_tpu_torch.clock import Clock
    from gubernator_tpu_torch.core.engine import DecisionEngine
    from gubernator_tpu_torch.ops import bucket_kernel as tk

    page, frames, n_keys = PAGED_A
    ns = NOW0 * 10**6
    with paged_env(page, frames):
        card = DecisionEngine(n_keys, clock=Clock().freeze_at(ns))
        cpu = DecisionEngine(n_keys, clock=Clock().freeze_at(ns), device="cpu")
    dense = DecisionEngine(n_keys, clock=Clock().freeze_at(ns))
    check(card.capacity == frames * page and dense.paging is None,
          "[paged a] the paged engine must hold the frames only")
    t = time.perf_counter()
    for lo in range(0, n_keys, PAGED_FILL):
        idx = np.arange(lo, min(lo + PAGED_FILL, n_keys))
        keys, cols = paged_keys(np, idx), paged_cols(np, np.zeros_like(idx))
        got = card.apply_columnar(keys, *cols, now_ms=NOW0)
        same_answers(np, got, cpu.apply_columnar(keys, *cols, now_ms=NOW0), "[paged a] fill")
        same_answers(np, got, dense.apply_columnar(keys, *cols, now_ms=NOW0),
                     "[paged a] fill, dense")
        same_paging(np, tk, card, cpu, f"[paged a] fill at {lo}")
    same_paging(np, tk, card, cpu, "[paged a] after the fill", words=True)
    fill_faults = card.paging.faults
    log(f"[paged a] fill of {n_keys} keys in {time.perf_counter() - t:.1f} s: "
        f"{fill_faults} faults, {card.paging.spills} spills, card = CPU = dense")
    perm = rng.permutation(n_keys)
    sketches = [hot_sketch(card), hot_sketch(cpu)]
    now = NOW0
    for b in range(PAGED_A_BATCHES):
        now += 7
        idx = paged_zipf(np, rng, perm, PAGED_A_BATCH)
        keys, cols = paged_keys(np, idx), paged_cols(np, idx)
        for sk in sketches:
            sk.offer_columns(keys.buf, keys.offsets, cols[2], limit=cols[3], duration=cols[4])
        got = card.apply_columnar(keys, *cols, now_ms=now)
        same_answers(np, got, cpu.apply_columnar(keys, *cols, now_ms=now), "[paged a] zipf")
        same_answers(np, got, dense.apply_columnar(keys, *cols, now_ms=now),
                     "[paged a] zipf, dense")
        same_paging(np, tk, card, cpu, f"[paged a] zipf batch {b}", words=b % 25 == 24)
    check(card.paging.faults > fill_faults, "[paged a] the zipf stream must fault")
    check(bool(card.paging._hot_pages) or card.paging._faults_since_hot_refresh > 0,
          "[paged a] the hot-key provider must be read")
    log(f"[paged a] {PAGED_A_BATCHES} zipf batches of {PAGED_A_BATCH}: "
        f"{card.paging.faults - fill_faults} faults in {card.paging.fault_batches} fault "
        f"batches, hot pages {len(card.paging._hot_pages)}; card = CPU = dense, page table, "
        "host words and device words equal")
    dense.close()

    path = str(tmp / "paged.npz")
    t = time.perf_counter()
    card.save(NpzFileLoader(path))
    t_save = time.perf_counter() - t
    with paged_env(page, frames):
        fresh = DecisionEngine(n_keys, clock=Clock().freeze_at(now * 10**6))
    t = time.perf_counter()
    n = fresh.load(NpzFileLoader(path))
    t_load = time.perf_counter() - t
    check(n == len(card.table) and fresh.paging.faults == 0,
          f"[paged a] the load must restore every key with no fault ({n}, "
          f"{fresh.paging.faults} faults)")
    cold = len(fresh.paging.nonresident_used_pages())
    check(cold > 0, "[paged a] the load must restore cold pages into the host store")
    idx = paged_zipf(np, rng, perm, PAGED_A_BATCH)
    keys, cols = paged_keys(np, idx), paged_cols(np, idx)
    got = card.apply_columnar(keys, *cols, now_ms=now + 1)
    same_answers(np, fresh.apply_columnar(keys, *cols, now_ms=now + 1), got,
                 "[paged a] after the checkpoint")
    same_answers(np, cpu.apply_columnar(keys, *cols, now_ms=now + 1), got, "[paged a] zipf")
    log(f"[paged a] checkpoint of {n} keys: save {t_save:.1f} s, load {t_load:.1f} s with no "
        f"fault ({cold} cold pages restored into the host store); a batch answers as the "
        "engine that never stopped")

    faults, freed = card.paging.faults, []
    t_sweep = now + 2 * PAGED_DURATION
    while True:
        a, b = card.sweep(now_ms=t_sweep), cpu.sweep(now_ms=t_sweep)
        check(a == b, f"[paged a] sweep: card freed {a}, CPU {b}")
        if a == 0:
            break
        freed.append(a)
    check(card.paging.faults == faults, "[paged a] the sweep must not fault")
    check(sum(freed) == n_keys and card.cache_size() == cpu.cache_size() == 0,
          f"[paged a] the sweep must free every expired key ({sum(freed)})")
    same_paging(np, tk, card, cpu, "[paged a] after the sweep", words=True)
    log(f"[paged a] sweeps freed {freed} (device windows and cold pages from the host words) "
        "with no fault, as the CPU engine's")
    cpu.close()
    return [card, fresh, dense]


@contextlib.contextmanager
def fault_split(pp):
    """Split the fault wall of `pp`'s fault batches from outside, so that
    any tree can be read the same way: the victim picks (`_pick_victim`),
    the launch and wait (K9 and K10's wrappers as core/paging.py calls
    them, and the wait for the spill's readback), and the rest, the host
    copies (the refill words and their staging, the spill's scatter home)
    and the bookkeeping.  Seconds summed over the batches."""
    from gubernator_tpu_torch.core import paging as paging_mod
    from gubernator_tpu_torch.core import readback as rb

    acc = {"wall": 0.0, "picks": 0.0, "launch": 0.0, "pages": 0}
    in_fault = [False]
    pick, fault, fetch = pp._pick_victim, pp._fault_batch, rb.Ticket.fetch
    kernels = {n: getattr(paging_mod, n) for n in ("gather_pages", "load_pages")}

    def timed(fn, key, only_in_fault=False):
        def call(*a, **kw):
            if only_in_fault and not in_fault[0]:
                return fn(*a, **kw)
            t = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                acc[key] += time.perf_counter() - t
        return call

    def timed_fault(engine, missing, pinned):
        in_fault[0] = True
        acc["pages"] += len(missing)
        try:
            return timed(fault, "wall")(engine, missing, pinned)
        finally:
            in_fault[0] = False

    pp._pick_victim = timed(pick, "picks")
    pp._fault_batch = timed_fault
    for n, fn in kernels.items():
        setattr(paging_mod, n, timed(fn, "launch"))
    rb.Ticket.fetch = timed(fetch, "launch", only_in_fault=True)
    try:
        yield acc
    finally:
        del pp._pick_victim, pp._fault_batch
        for n, fn in kernels.items():
            setattr(paging_mod, n, fn)
        rb.Ticket.fetch = fetch


def phase_paged_full(torch, np, rng, card_name):
    """(b) The full width: pages of 512, 2^24 resident rows, 2^25 keys —
    the fill, then zipf(1.2) over the keys in a seeded order in batches of
    8192, each batch answered as a dense card engine at 2^25 answers it;
    the zipf batches' fault wall split into victim picks, host copies and
    launch-and-wait.  Returns (card engines, fault-batch sizes,
    readings)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from gubernator_tpu_torch.clock import Clock
    from gubernator_tpu_torch.core.engine import DecisionEngine
    from gubernator_tpu_torch.ops import fused_step as fs

    rates = pinned_copy_rates(torch)
    page, frames, n_keys = PAGED_B
    ns = NOW0 * 10**6
    with paged_env(page, frames):
        paged = DecisionEngine(n_keys, clock=Clock().freeze_at(ns))
    dense = DecisionEngine(n_keys, clock=Clock().freeze_at(ns))
    check(paged.capacity == ZIPF_CAP, "[paged b] 2^24 resident rows")
    fill_cols = paged_cols(np, np.zeros(PAGED_FILL, np.int64))
    t = time.perf_counter()
    for lo in range(0, n_keys, PAGED_FILL):
        keys = paged_keys(np, np.arange(lo, lo + PAGED_FILL))
        same_answers(np, paged.apply_columnar(keys, *fill_cols, now_ms=NOW0),
                     dense.apply_columnar(keys, *fill_cols, now_ms=NOW0), "[paged b] fill")
    fill_s = time.perf_counter() - t
    fill_faults = paged.paging.faults
    log(f"[paged b] fill of {n_keys} keys in {fill_s:.1f} s (both engines): {fill_faults} "
        f"faults in {paged.paging.fault_batches} fault batches; pinned copies "
        f"{rates[0] / 1e9:.2f} GB/s up, {rates[1] / 1e9:.2f} GB/s down (64 MiB each) "
        f"| {card_name}")
    perm = rng.permutation(n_keys)
    l0 = dict(fs.launches)
    pp = paged.paging
    st0 = [(s.count, s.total) for s in (pp.fault_duration, pp.spill_duration, pp.refill_wait)]
    per_batch, walls, batches = [], [], []
    for _ in range(PAGED_B_BATCHES):
        idx = paged_zipf(np, rng, perm, ZIPF_BATCH)
        batches.append((paged_keys(np, idx), paged_cols(np, idx)))
    n_prof = 8  # the last batches run under the profiler, the paged engine alone

    def paged_batch(b):
        keys, cols = batches[b]
        f0 = pp.faults
        t = time.perf_counter()
        got = paged.apply_columnar(keys, *cols, now_ms=NOW0 + 7 * (b + 1))
        walls.append(time.perf_counter() - t)
        per_batch.append(pp.faults - f0)
        return got

    def dense_batch(b):
        keys, cols = batches[b]
        return dense.apply_columnar(keys, *cols, now_ms=NOW0 + 7 * (b + 1))

    with fault_split(pp) as split:
        for b in range(PAGED_B_BATCHES - n_prof):
            same_answers(np, paged_batch(b), dense_batch(b), "[paged b] zipf")
        tail = range(PAGED_B_BATCHES - n_prof, PAGED_B_BATCHES)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t = time.perf_counter()
            got = [paged_batch(b) for b in tail]
            torch.cuda.synchronize()
            window_us = (time.perf_counter() - t) * 1e6
    busy_us = sum(e.self_device_time_total for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0)
    for b, g in zip(tail, got):
        same_answers(np, g, dense_batch(b), "[paged b] zipf")
    check(sum(per_batch) > 0 and split["pages"] == sum(per_batch),
          "[paged b] the zipf stream must fault, every fault through a fault batch")
    means = [((s.total - t0) / max(s.count - c0, 1)) * 1e3
             for (c0, t0), s in zip(st0, (pp.fault_duration, pp.spill_duration, pp.refill_wait))]
    launched = {k: fs.launches[k] - l0[k] for k in ("gather_pages", "load_pages")}
    per_page = {k: split[k] / split["pages"] * 1e6 for k in ("wall", "picks", "launch")}
    per_page["copies"] = per_page["wall"] - per_page["picks"] - per_page["launch"]
    read = {"faults_per_batch": statistics.mean(per_batch), "max_faults": max(per_batch),
            "fault_ms": means[0], "spill_ms": means[1], "refill_ms": means[2],
            "decisions_per_s": ZIPF_BATCH * len(walls) / sum(walls), "launched": launched,
            "busy_us": busy_us, "window_us": window_us, "fill_s": fill_s, "split": per_page,
            "rates": rates}
    log(f"[paged b] {PAGED_B_BATCHES} zipf batches of {ZIPF_BATCH} over 2^25 keys: faults per "
        f"batch mean {read['faults_per_batch']:.1f} (max {read['max_faults']}), mean wall a "
        f"faulted page: fault {means[0] * 1e3:.2f} us, spill {means[1] * 1e3:.2f} us, refill "
        f"{means[2] * 1e3:.2f} us; split a faulted page (timed from outside): wall "
        f"{per_page['wall']:.2f} us = victim picks {per_page['picks']:.2f} + host copies and "
        f"bookkeeping {per_page['copies']:.2f} + launch-and-wait {per_page['launch']:.2f}; "
        f"{read['decisions_per_s']:.0f} decisions/s; launches {launched}; profiled window of "
        f"{n_prof} batches: wall {window_us:.1f} us, device busy {busy_us:.1f} us, idle share "
        f"{1 - busy_us / window_us:.4f}; pinned copies {rates[0] / 1e9:.2f} / "
        f"{rates[1] / 1e9:.2f} GB/s; paged = dense at 2^25 | {card_name}")
    return [paged, dense], per_batch, read


def phase_paged_timing(torch, np, rng, card, zipf_k: int, rates: tuple):
    """K9 / K10 at pages of 512 (CUDA events behind the spin kernel) with k
    = 1, k = PAGED_FILL / 512 = 16 (each fill batch's faults on path (b)) and
    k = `zipf_k` (the median zipf fault batch there): first a fault batch
    as `_fault_batch` queues it (the staged copy up of the starts and the
    refill words, K9 on the victims' frames, the copy of K9's block home
    into pinned memory, K10) beside its PCIe bound, then K9 / K10 alone
    beside their bytes bound, their plain versions and, at k <= 16, each
    one's library call: torch.stack of the pages' column slices for K9,
    torch._foreach_copy_ into them for K10 (at the zipf's k their
    thousands of views make the calls host-bound).  The kernels line takes
    k = 16."""
    from gubernator_tpu_torch.ops import bucket_kernel as tk
    from gubernator_tpu_torch.ops.page_words import gather_pages, load_pages

    page, frames = 512, PAGED_B[1]
    cap = frames * page
    state = extreme_page_state(torch, np, rng, cap)
    out = {}
    fill_k = PAGED_FILL // page
    for k in sorted({1, fill_k, min(max(zipf_k, 1), frames)}):
        sets = [torch.from_numpy((np.sort(rng.choice(frames, k, replace=False)) * page)
                                 .astype(np.int32)).cuda() for _ in range(16)]
        host = [s.cpu().tolist() for s in sets]
        words = torch.from_numpy(rng.integers(-(2**31), 2**31, (k, 12, page),
                                              dtype=np.int64).astype(np.int32)).cuda()
        n_starts = -(-(2 * k) // 4) * 4
        buf = torch.zeros(n_starts + k * 12 * page, dtype=torch.int32, pin_memory=True)
        buf[:k] = buf[k : 2 * k] = sets[0].cpu()
        staged = torch.empty_like(buf, device="cuda")
        home = torch.empty((k, 12, page), dtype=torch.int32, pin_memory=True)

        def batch(_i):
            staged.copy_(buf, non_blocking=True)
            home.copy_(gather_pages(state, staged[:k], page), non_blocking=True)
            load_pages(state, staged[k : 2 * k], staged[n_starts:].view(k, 12, page))

        fb = device_ms(torch, batch, 200 if k <= 16 else 40)
        k9 = device_ms(torch, lambda i: gather_pages(state, sets[i % 16], page), 200)
        k9_plain = host_ms(torch, lambda i: tk.gather_page_words_reference(
            state, sets[i % 16], page), 20, windows=3)
        k10 = device_ms(torch, lambda i: load_pages(state, sets[i % 16], words), 200)
        k10_plain = host_ms(torch, lambda i: tk.load_page_words_reference(
            state, sets[i % 16], words), 20, windows=3)
        k9_lib = k10_lib = None
        if k <= fill_k:
            # The library calls on the same 12 * k column slices, their
            # views built ahead so that the host keeps the queue full: one
            # torch.stack of them (K9), one torch._foreach_copy_ from the
            # block's rows into them (K10).  Each is checked once.
            views = [[col[s : s + page] for s in h for col in state] for h in host]
            src = [words[j, c] for j in range(k) for c in range(12)]
            k9_lib = device_ms(torch, lambda i: torch.stack(views[i % 16]), 200)
            k10_lib = device_ms(torch, lambda i: torch._foreach_copy_(views[i % 16], src), 200)
            torch._foreach_copy_(views[0], src)
            block = tk.gather_page_words_reference(state, sets[0], page)
            if not (torch.equal(block, words)
                    and torch.equal(torch.stack(views[0]).view(k, 12, page), block)):
                raise AssertionError("a library call disagrees with the page block")
        bound = page_bound_ms(k, page)
        pcie = pcie_bound_ms(k, k, page, rates)
        out[k] = ((k9, k9_plain, bound, k9_lib), (k10, k10_plain, bound, k10_lib), fb)
        lib = "" if k9_lib is None else (
            f", torch.stack of the {12 * k} column slices {k9_lib * 1e3:.2f} us, "
            f"torch._foreach_copy_ into them {k10_lib * 1e3:.2f} us")
        log(f"[time] fault batch at P=512, k={k}: {fb * 1e3:.2f} us device and copies (copy "
            f"up, K9, copy home, K10), PCIe bound {pcie * 1e3:.2f} us ({k} pages each way at "
            f"{rates[0] / 1e9:.2f} / {rates[1] / 1e9:.2f} GB/s) | {card}")
        log(f"[time] K9 / K10 at P=512, k={k}: {k9 * 1e3:.2f} / {k10 * 1e3:.2f} us/launch, "
            f"bound {bound * 1e3:.4f} us (bytes), plain {k9_plain * 1e3:.1f} / "
            f"{k10_plain * 1e3:.1f} us{lib} | {card}")
    del state
    torch.cuda.empty_cache()
    return {"k9": out[fill_k][0], "k10": out[fill_k][1], "by_k": out}


def phase_paged(torch, np, rng, card):
    """The paged path: (a) parity and (b) the full width.  Returns (card
    engines, fault-batch sizes of (b)'s zipf, readings)."""
    with tempfile.TemporaryDirectory() as tmp:
        engines = phase_paged_parity(torch, np, rng, Path(tmp))
    more, per_batch, read = phase_paged_full(torch, np, rng, card)
    return engines + more, per_batch, read


# ---------------------------------------------------------------------------
# The sharded path: ShardedDecisionEngine (parallel/sharded_engine.py), with
# its per-shard steps K11 / K12 (csrc/sharded_step.cu) and sweep K13
# (csrc/sweep.cu)

SHARD_A = (8, 1 << 16)  # (a) card vs CPU: the reference's 8-device mesh, 2^16 slots a shard
SHARD_A_POOL = 700_000  # (a)'s keys: more than its 524,288 slots, so it evicts
# (b) BASELINE.json configs[3] ("Mixed token+leaky, Zipf-skewed 100M keys,
# DURATION_IS_GREGORIAN resets"; the north star's v5e-4): one shard a chip
# of the four, 10^8 keys in all, 4.8 GB of state on the one card.
SHARD_B = (4, 25_000_000)
CFG3_KEYS = 100_000_000
CFG3_ZIPF = 1.1
CFG3_BATCHES = 12  # (b): columnar batches of 8192 and V1Instance batches of 1000, each


def has_sharding() -> bool:
    """The driven port has the sharded engine (a --tree checkout from
    before it has not)."""
    return importlib.util.find_spec("gubernator_tpu_torch.parallel") is not None


def cfg3_ranks(np, rng, n: int, zipf: bool):
    """n key ranks over 10^8: zipf(1.1), or n distinct uniform ones (a
    batch of spread keys, which runs as one round)."""
    if zipf:
        return (rng.zipf(CFG3_ZIPF, n) - 1) % CFG3_KEYS
    return rng.choice(CFG3_KEYS, n, replace=False)


def cfg3_fields(np, ranks):
    """Each key's configuration, a property of its rank: token or leaky by
    parity, limit (= burst) 10 / 100 / 1000, 1 key in 7 on Gregorian
    minutes (behavior DURATION_IS_GREGORIAN, duration 0 = GregorianMinutes),
    the others 1 min.  Returns (algo, behavior, limit, duration, burst)."""
    r = np.asarray(ranks, dtype=np.int64)
    greg = r % 7 == 0
    limit = np.array([10, 100, 1000], dtype=np.int64)[r % 3]
    return ((r % 2).astype(np.int32), np.where(greg, 4, 0).astype(np.int32), limit,
            np.where(greg, 0, 60_000).astype(np.int64), limit)


def cfg3_keys(np, ranks):
    """PackedKeys of key ranks, b"cfg3_" and 7 hex digits each (the
    `hash_key` of name "cfg3", unique_key the digits)."""
    from gubernator_tpu_torch.core.engine import PackedKeys

    idx = np.asarray(ranks, dtype=np.int64)
    n = len(idx)
    hexd = np.frombuffer(b"0123456789abcdef", np.uint8)
    buf = np.empty((n, 12), np.uint8)
    buf[:, :5] = np.frombuffer(b"cfg3_", np.uint8)
    buf[:, 5:] = hexd[(idx[:, None] >> (4 * np.arange(6, -1, -1))) & 15]
    return PackedKeys(buf.reshape(-1), np.arange(0, 12 * n + 1, 12, dtype=np.int64), n)


def cfg3_columnar(np, ranks, hits):
    """(keys, algo, behavior, hits, limit, duration, burst) for apply_columnar."""
    algo, beh, limit, dur, burst = cfg3_fields(np, ranks)
    return (cfg3_keys(np, ranks), algo, beh, np.asarray(hits, dtype=np.int64), limit, dur, burst)


def cfg3_requests(np, ranks, hits):
    from gubernator_tpu_torch.types import RateLimitReq

    algo, beh, limit, dur, burst = (c.tolist() for c in cfg3_fields(np, ranks))
    return [RateLimitReq(name="cfg3", unique_key=f"{r:07x}", hits=h, limit=lim, duration=d,
                         algorithm=a, behavior=b, burst=u)
            for r, h, a, b, lim, d, u in zip(np.asarray(ranks).tolist(),
                                              np.asarray(hits).tolist(), algo, beh, limit, dur,
                                              burst)]


def shard_state_words(torch, np, a, b) -> bool:
    """Every state word of two engines (card or CPU) equal."""
    return all(torch.equal(x.cpu(), y.cpu()) for x, y in zip(a.state, b.state))


def sharded_pin(np, rng, n_sh: int, cap: int, width: int, now: int, *, collapsed: bool):
    """A K11 (or, `collapsed`, a K12) input of n_sh shards: shard 0 full,
    the others padded (one empty), each packed with the shard's capacity;
    K12's chunks hold a hot key that spans tiles.  Returns (pin, the
    shards' lane or segment slots)."""
    from gubernator_tpu_torch.ops import bucket_kernel as tk

    pins, slots_of = [], []
    for sh in range(n_sh):
        m = width if sh == 0 else (0 if sh == 1 else int(rng.integers(1, width)))
        if not collapsed:
            slots = np.sort(rng.choice(cap, m, replace=False)).astype(np.int32)
            algo, beh, limit, dur, burst = cfg3_fields(np, rng.integers(0, 10**6, m))
            hits = rng.choice([-1, 0, 1, 1, 5], m).astype(np.int64)
            pins.append(tk.pack_batch_host(width, now, cap, slots, algo, beh, hits, limit, dur,
                                           burst, np.where(beh == 4, 60_000, 0),
                                           np.where(beh == 4, now + 30_000, 0)))
            slots_of.append(slots)
            continue
        lanes = np.concatenate([np.full(m // 2, int(rng.integers(cap))),
                                rng.choice(cap, m - m // 2)]).astype(np.int64)
        uniq, counts = np.unique(lanes[: max(m - 1, 0)], return_counts=True)
        algo, beh, limit, dur, burst = cfg3_fields(np, uniq)
        seg = np.repeat(np.arange(len(uniq)), counts).astype(np.int32)
        pos = (np.arange(len(seg)) - np.repeat(np.cumsum(counts) - counts, counts)).astype(np.int32)
        pins.append(tk.pack_collapsed_host(
            width, now, cap, uniq.astype(np.int32), counts.astype(np.int64),
            (algo, beh, np.ones(len(uniq), np.int64), limit, dur, burst,
             np.where(beh == 4, 60_000, 0), np.where(beh == 4, now + 30_000, 0)), seg, pos))
        slots_of.append(uniq.astype(np.int32))
    return np.stack(pins), slots_of


def shard_clears(np, rng, cap: int, slots_of):
    """Each shard's clears (a few of its lanes' slots and other slots, one
    shard with none), as K11 / K12 take them."""
    from gubernator_tpu_torch.ops.sharded_step import shard_clear_rows

    out = []
    for sh, own in enumerate(slots_of):
        pick = list(rng.choice(own, min(4, len(own)), replace=False)) if len(own) else []
        out.append([] if sh == 2 else sorted({int(s) for s in pick}
                                             | {int(s) for s in rng.choice(cap, 8)}))
    return shard_clear_rows(out, cap)


def k11_bound_ms(pin, rows, cap: int, n_rounds: int = 1) -> float:
    """Least time for one K11 launch of `n_rounds` rounds: per shard and
    round the 8 B header, per lane rows 1-15 of pin read (60 B) and pout
    written (20 B), per in-range lane 12 state words read and written
    (96 B), 12 B per in-range clear, at peak HBM."""
    n_sh, _, width = pin.shape
    lanes = sum(n_in_range(p[1], cap) for p in pin)
    clears = sum(n_in_range(r, cap) for r in rows)
    return (n_sh * (8 * n_rounds + width * 80) + lanes * 96 + clears * 12) / HBM_BYTES_PER_S * 1e3


def k12_bound_ms(pin, rows, cap: int) -> float:
    """K3's bound (k3_bound_ms) summed over the shards."""
    return sum(k3_bound_ms(p, r, cap) for p, r in zip(pin, rows))


def k13_bound_ms(n_sh: int, window: int, freed: int) -> float:
    """K6's bound (k6_bound_ms) over the same window of every shard."""
    return (12 * window * n_sh + 8 * freed + 4 * n_sh) / HBM_BYTES_PER_S * 1e3


def phase_shard_kernels(torch, np, rng, errs):
    """K11, K12 and K13 against their plain versions on the card, bit-exact
    in the output and all 12 columns: 8 shards x 2^16 and 4 shards x 2.5 x
    10^7, a full shard, padded shards and an empty one, clears of lane
    slots and of other slots; K13 one 2^17 window of every shard with
    expiries at now - 1, now and now + 1."""
    from gubernator_tpu_torch.ops import bucket_kernel as tk
    from gubernator_tpu_torch.ops import expiry
    from gubernator_tpu_torch.ops.sharded_step import shard_collapsed_step, shard_step

    for n_sh, cap in (SHARD_A, SHARD_B):
        kern = random_state(torch, n_sh * cap, NOW0, int(rng.integers(2**31)))
        arm_expiries(torch, kern, NOW0, int(rng.integers(2**31)))
        plain = copy_state(kern)
        for collapsed, name, width in ((False, "shard_step", 256), (True, "shard_collapsed", 1024)):
            for it in range(4):
                pin_np, slots_of = sharded_pin(np, rng, n_sh, cap, width, NOW0 + it,
                                               collapsed=collapsed)
                rows_np = shard_clears(np, rng, cap, slots_of)
                pin, rows = torch.from_numpy(pin_np).cuda(), torch.from_numpy(rows_np).cuda()
                if collapsed:
                    got = shard_collapsed_step(kern, pin, cap, rows)
                    tk.shard_clears_reference(plain, rows, cap)
                    want = tk.sharded_collapsed_step_reference(plain, pin, cap)
                else:
                    got = shard_step(kern, pin, cap, rows)
                    tk.shard_clears_reference(plain, rows, cap)
                    want = tk.sharded_fused_step_reference(plain, pin, cap)
                torch.cuda.synchronize()
                err = max(int((got.long() - want.long()).abs().max().item()),
                          compare_states(torch, kern, plain))
                errs[name] = max(errs[name], err)
                check(err == 0, f"{name} differs from its plain version: {n_sh} x {cap}, "
                      f"call {it}, err {err}")
        # K11 over batches of 1, 2, 4 and 8 rounds with clears in every round
        # and K12 at the readings' widths.
        hold_k11_rounds(torch, np, rng, errs, kern, plain, n_sh, cap, 512 if n_sh == 4 else 128)
        hold_k12_widths(torch, np, rng, errs, kern, plain, n_sh, cap)
        window = min(cap, 1 << 17)
        for start in sorted({0, cap - window}):
            got = expiry.shard_sweep_window(kern.meta, kern.hi2, kern.expire_lo, n_sh, NOW0,
                                            start, window)
            want = expiry.shard_sweep_window_reference(plain.meta, plain.hi2, plain.expire_lo,
                                                       n_sh, NOW0, start, window)
            torch.cuda.synchronize()
            c = want[:, 0].cpu().tolist()
            err = compare_states(torch, (kern.meta,), (plain.meta,))
            err = max(err, *(int((got[sh, : 1 + n].long() - want[sh, : 1 + n].long()).abs()
                                 .max().item()) for sh, n in enumerate(c)))
            errs["shard_sweep"] = max(errs["shard_sweep"], err)
            check(err == 0 and sum(c) > 0, f"K13 differs from its plain version: {n_sh} x "
                  f"{cap}, window at {start}, err {err}")
        # A group as the engine's cursor gives it at the end of a pass: the
        # windows before the clamped tail, the tail, then window 0 again.
        n_win = -(-cap // window)
        starts = [min(i * window, cap - window) for i in range(n_win)][-15:] + [0]
        got = sweep_group(kern.meta, kern.hi2, kern.expire_lo, NOW0 + 1, starts, window, n_sh)
        want = sweep_group_plain(plain.meta, plain.hi2, plain.expire_lo, NOW0 + 1, starts,
                                 window, n_sh)
        torch.cuda.synchronize()
        err = max(same_sweep(torch, got, want),
                  compare_states(torch, (kern.meta,), (plain.meta,)))
        errs["shard_sweep"] = max(errs["shard_sweep"], err)
        check(err == 0, f"K13 differs from its plain version on a group of {len(starts)} "
              f"windows: {n_sh} x {cap}, err {err}")
        log(f"[shard kernels] {n_sh} x {cap}: K11 (4 one-round calls of 256 lanes a shard, "
            f"then batches of {K11_READ_ROUNDS} rounds with clears in every round) and K12 (4 "
            f"chunks of 1024 lanes a shard, a hot key across tiles, then {K12_READ_WIDTHS} "
            "lanes a shard), with padding, an empty "
            f"shard and clears, and K13 (the first and the last window of {window} of every "
            f"shard, then a group of {len(starts)} from the cursor's end of a pass: the tail, "
            "the window before it, the wrap) bit-equal to their plain versions (tolerance: "
            "exact)")
        del kern, plain
        torch.cuda.empty_cache()


def sharded_pair(cap: int, n_sh: int, ns: int, **kw):
    from gubernator_tpu_torch.clock import Clock
    from gubernator_tpu_torch.parallel.sharded_engine import ShardedDecisionEngine

    return [ShardedDecisionEngine(cap, n_shards=n_sh, clock=Clock().freeze_at(ns), device=dev,
                                  **{k: v() for k, v in kw.items()})
            for dev in ("cuda", "cpu")]


def phase_sharded_parity(torch, np, rng):
    """(a) Card against CPU at 8 shards x 2^16 (both the port): a fill of
    700,000 keys in columnar batches of 8192 (evictions past 524,288
    slots), then batches of 8192 (zipf ranks over the keys: the flat K3)
    and of 1000 through get_rate_limits (spread: K11 with the clears;
    zipf: K12), Gregorian minutes on 1 key in 7, sweeps (K13) with new
    keys onto the freed slots; a store engine
    (write-through MemoryStore) whose swept keys come back from the store
    (K2, K5, K11); and a store engine of 2 slots a shard whose keys come
    back from the store in rounds after the first (K11, then K2 + K5, then
    K11 again from that round).  Answers, every state word and the stores
    equal.  Returns the card engines."""
    from gubernator_tpu_torch.ops import fused_step as fs
    from gubernator_tpu_torch.store import MemoryStore

    n_sh, cap = SHARD_A
    ns = NOW0 * 10**6
    card, cpu = sharded_pair(cap, n_sh, ns)
    t = time.perf_counter()
    now = NOW0
    for lo in range(0, SHARD_A_POOL, ZIPF_BATCH):
        ranks = np.arange(lo, min(lo + ZIPF_BATCH, SHARD_A_POOL))
        cols = cfg3_columnar(np, ranks, np.ones(len(ranks)))
        same_answers(np, card.apply_columnar(*cols, now_ms=now), cpu.apply_columnar(
            *cols, now_ms=now), "[sharded a] fill")
    evictions = sum(tb.evictions for tb in card.tables)
    check(evictions > 0 and evictions == sum(tb.evictions for tb in cpu.tables),
          f"[sharded a] the fill must evict ({evictions})")
    check(shard_state_words(torch, np, card, cpu), "[sharded a] state words after the fill")
    swept = []
    for b in range(24):
        now += int(rng.choice([0, 7, 250, 1500]))
        ranks = (rng.zipf(CFG3_ZIPF, ZIPF_BATCH) - 1) % SHARD_A_POOL
        cols = cfg3_columnar(np, ranks, np.ones(ZIPF_BATCH))
        same_answers(np, card.apply_columnar(*cols, now_ms=now),
                     cpu.apply_columnar(*cols, now_ms=now), f"[sharded a] zipf {b}")
        zipf = b % 2 == 1
        ranks = ((rng.zipf(CFG3_ZIPF, BATCH) - 1) % SHARD_A_POOL if zipf
                 else rng.integers(0, 2 * SHARD_A_POOL, BATCH))
        reqs = cfg3_requests(np, ranks, np.ones(BATCH, np.int64) if zipf
                             else rng.choice([0, 1, 1, 2], BATCH))
        got, want = card.get_rate_limits(reqs, now_ms=now), cpu.get_rate_limits(reqs, now_ms=now)
        check([(r.status, r.remaining, r.reset_time, r.error) for r in got]
              == [(r.status, r.remaining, r.reset_time, r.error) for r in want],
              f"[sharded a] get_rate_limits batch {b}: answers differ")
        if b % 8 == 7:
            now += 61_000
            swept.append(card.sweep(now_ms=now))
            check(swept[-1] == cpu.sweep(now_ms=now) > 0, "[sharded a] sweeps differ")
            check(shard_state_words(torch, np, card, cpu), f"[sharded a] state words, batch {b}")
    check(card.cache_size() == cpu.cache_size(), "[sharded a] key counts differ")
    log(f"[sharded a] {n_sh} shards x {cap}: a fill of {SHARD_A_POOL} keys ({evictions} "
        f"evictions), 24 zipf batches of {ZIPF_BATCH} and 24 get_rate_limits batches of {BATCH} "
        f"(spread and zipf, Gregorian minutes on 1 key in 7), sweeps freeing {swept}; card = "
        f"CPU, answers and every state word ({time.perf_counter() - t:.1f} s)")

    scard, scpu = sharded_pair(cap, n_sh, ns, store=MemoryStore)
    t = time.perf_counter()
    now = NOW0
    for b in range(12):
        ranks = rng.integers(0, 6000, BATCH)
        reqs = cfg3_requests(np, ranks, rng.choice([0, 1, 2], BATCH))
        got, want = scard.get_rate_limits(reqs, now_ms=now), scpu.get_rate_limits(reqs, now_ms=now)
        check([(r.status, r.remaining, r.reset_time, r.error) for r in got]
              == [(r.status, r.remaining, r.reset_time, r.error) for r in want],
              f"[sharded a] store batch {b}: answers differ")
        now += 20_000
        if b % 4 == 3:
            check(scard.sweep(now_ms=now) == scpu.sweep(now_ms=now), "[sharded a] store sweeps")
    check(shard_state_words(torch, np, scard, scpu), "[sharded a] store engine state words")
    check({k: vars(v) for k, v in scard.store.data.items()}
          == {k: vars(v) for k, v in scpu.store.data.items()}, "[sharded a] stores differ")
    log(f"[sharded a] store engine, {n_sh} x {cap}: 12 get_rate_limits batches of {BATCH} over "
        f"6000 keys, swept keys restored from the store ({scard.store.get_calls} store reads); "
        f"card = CPU, answers, state words and store items ({time.perf_counter() - t:.1f} s)")

    # Restores in rounds after the first: 2 slots a shard for 64 keys, so a
    # key evicted earlier in a batch comes back from the store later in it
    # (K11 for the rounds before, K2 + K5, K11 again from that round).
    rcard, rcpu = sharded_pair(2, n_sh, ns, store=MemoryStore)
    seq: list = []
    seq_total = [0]
    if hasattr(rcard, "_launch_packed"):  # a port with one K11 a restore segment
        launch, restore = rcard._launch_packed, rcard._apply_shard_restores

        def launched(*a, **kw):
            seq.append("K11")
            return launch(*a, **kw)

        def restored(*a, **kw):
            seq.append("K5")
            return restore(*a, **kw)

        rcard._launch_packed, rcard._apply_shard_restores = launched, restored
    mid, k11_batches = 0, []
    k2k5 = k2_k5(fs)
    now = NOW0
    for b in range(30):
        n = int(rng.integers(8, 48))
        reqs = cfg3_requests(np, rng.integers(0, int(rng.integers(16, 64)), n),
                             rng.choice([0, 1, 1, 2], n))
        seq_total[0] += seq.count("K5")
        seq.clear()
        k0 = fs.launches["shard_step"]
        got, want = rcard.get_rate_limits(reqs, now_ms=now), rcpu.get_rate_limits(reqs, now_ms=now)
        check([(r.status, r.remaining, r.reset_time, r.error) for r in got]
              == [(r.status, r.remaining, r.reset_time, r.error) for r in want],
              f"[sharded a] restore batch {b}: answers differ")
        k11_batches.append(fs.launches["shard_step"] - k0)
        mid += sum(1 for i, e in enumerate(seq) if e == "K5" and "K11" in seq[:i])
        now += int(rng.choice([0, 40, 400]))
    check(shard_state_words(torch, np, rcard, rcpu), "[sharded a] restore engine state words")
    check({k: vars(v) for k, v in rcard.store.data.items()}
          == {k: vars(v) for k, v in rcpu.store.data.items()}, "[sharded a] restore stores differ")
    check(mid > 0 or not hasattr(rcard, "_launch_packed"),
          "[sharded a] no batch restored a key in a round after the first")
    k2k5 = tuple(b - a for a, b in zip(k2k5, k2_k5(fs)))
    n_restoring = seq_total[0] + seq.count("K5")
    check(k2k5[1] == n_restoring and k2k5[0] <= n_restoring,
          f"[sharded a] (K2, K5) launches {k2k5} for {n_restoring} restoring rounds: each must "
          "launch one K5 and at most one K2")
    log(f"[sharded a] restore engine, {n_sh} x 2: 30 get_rate_limits batches over up to 64 keys, "
        f"{mid} restores in a round after the first, {n_restoring} restoring rounds in "
        f"{k2k5[0]} K2 and {k2k5[1]} K5 launches; K11 launches a batch {k11_batches}; card = CPU, "
        "answers, state words and store items")
    cpu.close()
    scpu.close()
    rcpu.close()
    return [card, scard, rcard]


def phase_sharded_full(torch, np, rng, card_name, tmp: Path):
    """(b) The full size, BASELINE.json configs[3] on one card: 4 shards x
    2.5 x 10^7 slots (10^8 keys, 4.8 GB of state), the traffic half token
    half leaky, zipf(1.1) over 10^8 key ranks, Gregorian minutes on 1 key
    in 7: columnar batches of 8192 (apply_columnar, the flat K1 / K3:
    zipf batches collapse, spread ones run one round) and V1Instance
    batches of 1000 (K11 / K12), each held against a dense card
    DecisionEngine of 10^8 slots, which evicts nothing, so the answers must
    be equal; then a save / load of the whole state, and one sweep pass.
    Returns (card engines, the K11 / K12 inputs of the run, readings)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from gubernator_tpu_torch.checkpoint import NpzFileLoader
    from gubernator_tpu_torch.clock import Clock
    from gubernator_tpu_torch.core.engine import DecisionEngine
    from gubernator_tpu_torch.ops import fused_step as fs
    from gubernator_tpu_torch.parallel import sharded_engine as se
    from gubernator_tpu_torch.parallel.sharded_engine import ShardedDecisionEngine
    from gubernator_tpu_torch.service import V1Instance

    n_sh, cap = SHARD_B
    ns = NOW0 * 10**6
    t = time.perf_counter()
    sharded = ShardedDecisionEngine(cap, n_shards=n_sh, clock=Clock().freeze_at(ns))
    dense = DecisionEngine(CFG3_KEYS, clock=Clock().freeze_at(ns))
    inst, dense_inst = V1Instance(sharded, ledger=False), V1Instance(dense, ledger=False)
    build_s = time.perf_counter() - t
    captured = {"shard_step": [], "shard_collapsed": []}
    real = {"shard_step": se.shard_step, "shard_collapsed": se.shard_collapsed_step}

    def capture(name):
        # (pin, rows, the offsets of a multi-round K11, keywords) a call
        def call(state, pin, shard_cap, rows, *offsets, **kw):
            if len(captured[name]) < 16:
                captured[name].append((pin.clone(), rows.clone(),
                                       tuple(t.clone() for t in offsets), dict(kw)))
            return real[name](state, pin, shard_cap, rows, *offsets, **kw)
        return call

    se.shard_step, se.shard_collapsed_step = capture("shard_step"), capture("shard_collapsed")
    walls = {"columnar": [], "dataclass": []}
    routes = {"columnar": {}, "dataclass": {}}
    per_batch = []  # dataclass route: (rounds, K11 launches) a batch
    n_prof = 4  # the last batches run under the profiler, the sharded engine alone
    busy_us = window_us = 0.0
    try:
        batches = []
        for b in range(CFG3_BATCHES):
            zipf = b % 2 == 0
            ranks = cfg3_ranks(np, rng, ZIPF_BATCH, zipf)
            d_ranks = cfg3_ranks(np, rng, BATCH, zipf)
            batches.append((cfg3_columnar(np, ranks, np.ones(ZIPF_BATCH)),
                            cfg3_requests(np, d_ranks, np.ones(BATCH, np.int64) if zipf
                                          else rng.choice([0, 1, 1, 2], BATCH))))

        def sharded_batch(b, now):
            cols, reqs = batches[b]
            out = []
            for route, call in (("columnar", lambda: sharded.apply_columnar(*cols, now_ms=now)),
                                ("dataclass", lambda: inst.get_rate_limits(reqs))):
                before, rounds0 = dict(fs.launches), sharded.rounds_total
                t0 = time.perf_counter()
                out.append(call())
                walls[route].append(time.perf_counter() - t0)
                for k, v in fs.launches.items():
                    if v > before[k]:
                        routes[route][k] = routes[route].get(k, 0) + v - before[k]
                if route == "dataclass":
                    per_batch.append((sharded.rounds_total - rounds0,
                                      fs.launches["shard_step"] - before["shard_step"]))
            return out

        def check_batch(b, now, got):
            cols, reqs = batches[b]
            same_answers(np, got[0], dense.apply_columnar(*cols, now_ms=now),
                         f"[sharded b] columnar batch {b}")
            want = dense_inst.get_rate_limits(reqs)
            check([(r.status, r.remaining, r.reset_time, r.error) for r in got[1]]
                  == [(r.status, r.remaining, r.reset_time, r.error) for r in want],
                  f"[sharded b] V1Instance batch {b}: answers differ")

        now = NOW0
        for b in range(CFG3_BATCHES - n_prof):
            now += 50
            for e in (sharded, dense):
                e.clock.advance(ms=50)
            check_batch(b, now, sharded_batch(b, now))
        tail = []
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for b in range(CFG3_BATCHES - n_prof, CFG3_BATCHES):
                now += 50
                sharded.clock.advance(ms=50)
                tail.append((b, now, sharded_batch(b, now)))
            torch.cuda.synchronize()
            window_us = (time.perf_counter() - t0) * 1e6
        busy_us = sum(e.self_device_time_total for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0)
        for b, at, got in tail:
            dense.clock.advance(ms=50)
            check_batch(b, at, got)
    finally:
        se.shard_step, se.shard_collapsed_step = real["shard_step"], real["shard_collapsed"]
    for route in ("columnar", "dataclass"):
        log(f"[sharded b] {route} route: launches {routes[route]}")
    log(f"[sharded b] dataclass route, (rounds, K11 launches) a batch: {per_batch} | {card_name}")
    check(routes["columnar"].get("fused_step", 0) > 0 and routes["columnar"].get(
        "collapsed_step", 0) > 0, "[sharded b] the columnar route must launch K1 and K3")
    check(routes["dataclass"].get("shard_step", 0) > 0 and routes["dataclass"].get(
        "shard_collapsed", 0) > 0, "[sharded b] the V1Instance route must launch K11 and K12")
    rates = {r: (ZIPF_BATCH if r == "columnar" else BATCH) * len(w) / sum(w)
             for r, w in walls.items()}
    keys = sharded.cache_size()
    check(keys == dense.cache_size() and sum(tb.evictions for tb in sharded.tables) == 0,
          "[sharded b] the sharded engine holds every key, as the dense one")
    log(f"[sharded b] {n_sh} shards x {cap} ({n_sh * cap} slots, engines built in {build_s:.1f} "
        f"s), {CFG3_BATCHES} columnar batches of {ZIPF_BATCH} and {CFG3_BATCHES} V1Instance "
        f"batches of {BATCH} (zipf(1.1) and spread, alternating) over 10^8 key ranks, {keys} keys "
        f"held: answers equal the dense card engine's at 10^8; decisions/s columnar "
        f"{rates['columnar']:.0f}, V1Instance {rates['dataclass']:.0f}; profiled window of "
        f"{n_prof} batch pairs: wall {window_us:.1f} us, device busy {busy_us:.1f} us, idle "
        f"share {1 - busy_us / window_us:.4f} | {card_name}")

    path = str(tmp / "sharded.npz")
    t0 = time.perf_counter()
    sharded.save(NpzFileLoader(path))
    save_s = time.perf_counter() - t0
    fresh = ShardedDecisionEngine(cap, n_shards=n_sh, clock=Clock().freeze_at(now * 10**6))
    t0 = time.perf_counter()
    n = fresh.load(NpzFileLoader(path))
    load_s = time.perf_counter() - t0
    check(n == keys, f"[sharded b] the load restored {n} of {keys} keys")
    check(all(torch.equal(a, b) for a, b in zip(fresh._state, sharded._state)),
          "[sharded b] the loaded state words differ from the saved engine's")
    fresh.close()
    del fresh
    torch.cuda.empty_cache()
    counts0 = [sweep_counts([e]) for e in (sharded, dense)]
    t0 = time.perf_counter()
    freed = sharded.sweep(now_ms=now + 3 * 60_000)
    sweep_s = time.perf_counter() - t0
    check(freed == dense.sweep(now_ms=now + 3 * 60_000) == keys,
          f"[sharded b] the sweep pass freed {freed} (dense engine: its own count, keys {keys})")
    for e, (w0, g0), c in zip((sharded, dense), counts0, (cap, n_sh * cap)):
        # A full pass: every window once, 16 a launch (one a launch on a
        # port from before the groups).
        n_win = -(-c // e.SWEEP_WINDOW)
        w1, g1 = sweep_counts([e])
        want = -(-n_win // 16) if has_sweep_groups() else n_win
        check((w1 - w0, g1 - g0) == (n_win, want), f"[sharded b] a pass over {c} slots swept "
              f"{w1 - w0} windows in {g1 - g0} launches, want {n_win} in {want}")
    log(f"[sharded b] checkpoint of {keys} keys at 10^8 slots: save {save_s:.1f} s, load "
        f"{load_s:.1f} s (the whole state decoded and encoded on the host, as the reference "
        f"does), the loaded words equal; one sweep pass of {sharded.sweep_windows_total} windows "
        f"(2^17 of each shard) in {sweep_counts([sharded])[1]} K13 launches freed all {freed} "
        f"keys in {sweep_s:.2f} s | {card_name}")
    read = {"rates": rates, "busy_us": busy_us, "window_us": window_us, "save_s": save_s,
            "load_s": load_s, "sweep_s": sweep_s, "keys": keys, "routes": routes}
    inst.close()
    dense_inst.close()
    return [sharded, dense], captured, read


def phase_sharded_daemon(torch, np, rng):
    """(c) The daemon with GUBER_DEVICE_COUNT=4 (the sharded engine, 4 x
    2^18 slots, on the card) and the same daemon on the CPU answer the h2
    parity stream (30 RPCs of 1000 items): grpc-status and response bytes
    equal RPC by RPC; after the ledgers settle, every state word equal.
    Returns the card daemon's engine (the daemon closed)."""
    from gubernator_tpu_torch.clock import Clock
    from gubernator_tpu_torch.config import setup_daemon_config
    from gubernator_tpu_torch.daemon import spawn_daemon

    # GUBER_GRPC_ADDRESS: the config's default is the reference's
    # localhost:81, which only one of the two daemons could bind.
    conf = setup_daemon_config({"GUBER_DEVICE_COUNT": "4", "GUBER_CACHE_SIZE": str(CAP_SERVE),
                                "GUBER_HTTP_ADDRESS": "127.0.0.1:0",
                                "GUBER_GRPC_ADDRESS": "127.0.0.1:0",
                                "GUBER_H2_FAST_ADDRESS": "127.0.0.1:0",
                                "GUBER_SWEEP_INTERVAL": "0", "GUBER_LEDGER_SETTLE_INTERVAL": "0"})
    ns = NOW0 * 10**6
    d = spawn_daemon(conf, clock=Clock().freeze_at(ns), device="cuda")
    dc = spawn_daemon(conf, clock=Clock().freeze_at(ns), device="cpu")
    card_c = cpu_c = None
    try:
        eng = d.instance.engine
        check(getattr(eng, "n_shards", 1) == 4 and eng.shard_capacity == CAP_SERVE // 4
              and eng.state.meta.is_cuda, "[sharded c] GUBER_DEVICE_COUNT=4 must build 4 shards "
              "on the card")
        card_c, cpu_c = H2Unary(d.h2_fast_address), H2Unary(dc.h2_fast_address)
        stream = h2_stream(np, rng)
        for r, (body, step, status, n_items) in enumerate(stream):
            d.clock.advance(ms=step)
            dc.clock.advance(ms=step)
            got, want = card_c.call(body), cpu_c.call(body)
            check(got == want, f"[sharded c] RPC {r}: card {got[0]} / {len(got[1])} bytes, CPU "
                  f"{want[0]} / {len(want[1])} bytes: responses differ")
            check(got[0] == status, f"[sharded c] RPC {r}: grpc-status {got[0]}, want {status}")
        check(d.instance.ledger.flush_settles() == dc.instance.ledger.flush_settles(),
              "[sharded c] the ledgers settled different row counts")
        check(shard_state_words(torch, np, eng, dc.instance.engine),
              "[sharded c] state words differ")
        log(f"[sharded c] the daemon with GUBER_DEVICE_COUNT=4 (4 shards x {CAP_SERVE // 4} on "
            f"the card) and on the CPU: {len(stream)} h2 RPCs of {BATCH} items, grpc-status and "
            "response bytes equal RPC by RPC, state words equal after the ledgers settle")
        return eng
    finally:
        for c in (card_c, cpu_c):
            if c is not None:
                c.close()
        dc.close()
        d.close()


def phase_sharded(torch, np, rng, card):
    """The sharded path: (a) parity, (b) the full size, (c) the daemon.
    Returns (card engines, the K11 / K12 inputs of (b), readings)."""
    engines = phase_sharded_parity(torch, np, rng)
    with tempfile.TemporaryDirectory() as tmp:
        more, captured, read = phase_sharded_full(torch, np, rng, card, Path(tmp))
    engines += more
    engines.append(phase_sharded_daemon(torch, np, rng))
    return engines, captured, read


def phase_sharded_timing(torch, np, rng, card, captured):
    """K11 and K12 on (b)'s own inputs (the median launch of each, a 1000-
    item V1Instance batch over 4 shards) and K13 on one 2^17 window of each
    of 4 shards and on groups of 16 (`time_sweep_groups`), all on a random
    state of 4 x 2.5 x 10^7 slots, each
    checked once against its plain version, then timed (CUDA events
    behind the spin kernel) beside its bytes bound and its plain version.
    No single PyTorch call computes any of them."""
    from gubernator_tpu_torch.ops import bucket_kernel as tk
    from gubernator_tpu_torch.ops import expiry
    from gubernator_tpu_torch.ops.sharded_step import shard_collapsed_step, shard_step

    n_sh, cap = SHARD_B
    state = random_state(torch, n_sh * cap, NOW0, int(rng.integers(2**31)))
    arm_expiries(torch, state, NOW0, int(rng.integers(2**31)))
    meta0 = state.meta.clone()
    out = {}
    for name, kern, plain, bound in (
            ("shard_step", shard_step, tk.sharded_fused_step_reference, k11_bound_ms),
            ("shard_collapsed", shard_collapsed_step, tk.sharded_collapsed_step_reference,
             k12_bound_ms)):
        calls = captured[name]
        check(len(calls) > 0, f"[time] no {name} launch was captured")
        pin, rows, offs, kw = sorted(calls, key=lambda c: c[0].shape[2])[len(calls) // 2]
        n_rounds = offs[0].shape[0] - 1 if offs else 1

        def plain_call(st, pin=pin, rows=rows, offs=offs, plain=plain):
            if offs:  # a multi-round K11: the rounds, each after its clears
                return tk.sharded_multi_fused_step_reference(st, pin, cap, *offs, rows)
            tk.shard_clears_reference(st, rows, cap)
            return plain(st, pin, cap)

        a, b = copy_state(state), copy_state(state)
        got = kern(a, pin, cap, rows, *offs, **kw)
        want = plain_call(b)
        torch.cuda.synchronize()
        check(torch.equal(got, want) and compare_states(torch, a, b) == 0,
              f"[time] {name} differs from its plain version on the path's input")
        del a, b
        ms = device_ms(torch, lambda i: kern(state, pin, cap, rows, *offs, **kw), 200)
        plain_ms = host_ms(torch, lambda i: plain_call(state), 5, windows=3)
        bnd = bound(pin.cpu().numpy(), rows.cpu().numpy(), cap, *((n_rounds,) if offs else ()))
        out[name] = (ms, plain_ms, bnd, None)
        log(f"[time] {name} on the path's median input ({n_sh} shards, {pin.shape[2]} lanes a "
            f"shard in {n_rounds} round(s), {rows.shape[1]} clear entries a shard): "
            f"{ms * 1e3:.2f} us/launch, bound {bnd * 1e3:.4f} us (bytes), plain "
            f"{plain_ms * 1e3:.1f} us | {card}")
    window = 1 << 17
    plain_state = copy_state(state)
    got = expiry.shard_sweep_window(state.meta, state.hi2, state.expire_lo, n_sh, NOW0, 0, window)
    want = expiry.shard_sweep_window_reference(plain_state.meta, plain_state.hi2,
                                               plain_state.expire_lo, n_sh, NOW0, 0, window)
    torch.cuda.synchronize()
    counts = want[:, 0].cpu().tolist()
    check(all(torch.equal(got[sh, : 1 + c], want[sh, : 1 + c]) for sh, c in enumerate(counts))
          and torch.equal(state.meta, plain_state.meta), "[time] K13 differs on the timed window")
    del plain_state
    ms = device_ms(torch, lambda i: expiry.shard_sweep_window(
        state.meta, state.hi2, state.expire_lo, n_sh, NOW0, window * (1 + i % 150), window), 200)
    plain_ms = host_ms(torch, lambda i: expiry.shard_sweep_window_reference(
        state.meta, state.hi2, state.expire_lo, n_sh, NOW0, window * (1 + i % 150), window), 10,
        windows=3)
    bnd = k13_bound_ms(n_sh, window, sum(counts))
    out["shard_sweep"] = (ms, plain_ms, bnd, None)
    log(f"[time] shard_sweep (K13), one 2^17 window of each of {n_sh} shards of {cap}: "
        f"{ms * 1e3:.2f} us, bound {bnd * 1e3:.4f} us (bytes, {sum(counts)} freed in the "
        f"checked window), plain {plain_ms * 1e3:.1f} us | {card}")
    plain_state = copy_state(state)
    n_win = -(-cap // window)
    starts = [min(i * window, cap - window) for i in range(n_win)]
    out["shard_sweep_group"] = (*time_sweep_groups(torch, state, plain_state, meta0, starts,
                                                   window, n_sh, 4, card), None)
    del state, plain_state
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# K11 over a batch's rounds and K12's forms: holds and readings.  Inputs are
# built from one-round pieces (`pack_batch_host`, `shard_clear_rows`), which
# every port with a sharded engine has, so a --tree parent runs the same
# shapes its own way: one K11 launch a round.

K11_READ_ROUNDS = (1, 2, 4, 8)
K11_READ = ((4, 25_000_000, 512), (8, 1 << 16, 128))  # (shards, slots a shard, lanes a shard)
K12_READ_WIDTHS = (64, 512, 1024, 4096)
READ_BATCHES = 24  # path (b) dataclass batches a kind, after 2 warm-up batches


def k11_takes_rounds() -> bool:
    """The driven port's K11 takes a batch's rounds in one launch (a --tree
    checkout from before takes one round a call)."""
    import inspect

    from gubernator_tpu_torch.ops.sharded_step import shard_step

    return "round_off" in inspect.signature(shard_step).parameters


def shard_round_pieces(np, rng, n_sh: int, cap: int, n_rounds: int, lanes: int, now: int, *,
                       later_clears: bool, clears: bool = True, dense: bool = False):
    """A dataclass batch's R rounds as one-round K11 inputs [(pin [n_sh, 16,
    lanes], rows [n_sh, C])]: a shard's keys repeat in every round (round k
    holds each key's k-th hit), shard 0 with `lanes` keys, the others up to
    32 fewer (padding lanes); cfg3's configurations, hits 0 / 1 / 1 / 2;
    round 0's clears 4 lane slots and 8 other slots a shard, the later
    rounds' the same with `later_clears`, else none; no clears at all
    without `clears`.  Slots are drawn from the whole shard, or with
    `dense` from its first 2^15 (an engine's fresh tables hand out slots
    from 0, so path (b)'s 80,000 keys sit in each shard's first ~20,000)."""
    from gubernator_tpu_torch.ops import bucket_kernel as tk
    from gubernator_tpu_torch.ops.sharded_step import shard_clear_rows

    pool = min(cap, 1 << 15) if dense else cap
    base = [np.sort(rng.choice(pool, lanes if sh == 0 else int(rng.integers(lanes - 32, lanes + 1)),
                               replace=False)).astype(np.int32) for sh in range(n_sh)]
    fields = [cfg3_fields(np, rng.integers(0, 10**6, len(b))) for b in base]
    out = []
    for r in range(n_rounds):
        pins, clears = [], []
        for sh, slots in enumerate(base):
            algo, beh, limit, dur, burst = fields[sh]
            hits = rng.choice([0, 1, 1, 2], len(slots)).astype(np.int64)
            pins.append(tk.pack_batch_host(lanes, now, cap, slots, algo, beh, hits, limit, dur,
                                           burst, np.where(beh == 4, 60_000, 0),
                                           np.where(beh == 4, now + 30_000, 0)))
            if clears and (r == 0 or later_clears):
                own = rng.choice(slots, min(4, len(slots)), replace=False)
                clears.append(sorted({int(x) for x in own} | {int(x) for x in rng.choice(cap, 8)}))
            else:
                clears.append([])
        out.append((np.stack(pins), shard_clear_rows(clears, cap)))
    return out


def join_shard_rounds(np, pieces):
    """One-round K11 inputs → one multi-round launch's: (pin [n_sh, 16,
    L], clear_slots [n_sh, C], round_off, clear_off, widest)."""
    widths = [p.shape[2] for p, _ in pieces]
    round_off = np.concatenate([[0], np.cumsum(widths)]).astype(np.int32)
    clear_off = np.concatenate([[0], np.cumsum([c.shape[1] for _, c in pieces])]).astype(np.int32)
    return (np.concatenate([p for p, _ in pieces], axis=2),
            np.concatenate([c for _, c in pieces], axis=1), round_off, clear_off, max(widths))


def k11_batch_runner(torch, np, pieces, cap: int, keep: bool = True):
    """run(state): the rounds as the driven port runs a batch's, one K11
    launch over all of them, or one a round; with `keep` it returns the
    batch's pout [n_sh, 5, L] (the per-round outputs joined), without it
    only the launches run (timings)."""
    from gubernator_tpu_torch.ops.sharded_step import shard_step

    if k11_takes_rounds():
        pin, rows, ro, co, widest = join_shard_rounds(np, pieces)
        dev = [torch.from_numpy(np.ascontiguousarray(a)).cuda() for a in (pin, rows, ro, co)]
        return lambda st: shard_step(st, dev[0], cap, dev[1], dev[2], dev[3], widest=widest)
    dev = [(torch.from_numpy(p).cuda(), torch.from_numpy(c).cuda()) for p, c in pieces]
    if keep:
        return lambda st: torch.cat([shard_step(st, p, cap, c) for p, c in dev], dim=2)
    return lambda st: [shard_step(st, p, cap, c) for p, c in dev]


def k11_batch_plain(torch, state, pieces, cap: int):
    """The plain version of a batch's rounds: each round's clears, then the
    round (`sharded_fused_step_reference`)."""
    from gubernator_tpu_torch.ops import bucket_kernel as tk

    outs = []
    for p, c in pieces:
        tk.shard_clears_reference(state, torch.from_numpy(c).cuda(), cap)
        outs.append(tk.sharded_fused_step_reference(state, torch.from_numpy(p).cuda(), cap))
    return torch.cat(outs, dim=2)


def hold_k11_rounds(torch, np, rng, errs, state, plain, n_sh: int, cap: int, lanes: int,
                    rounds=K11_READ_ROUNDS) -> None:
    """K11 over batches of R rounds, clears in every round, against the
    plain rounds: pout and all 12 columns bit-equal (`state` and `plain`
    advance together)."""
    for n_rounds in rounds:
        pieces = shard_round_pieces(np, rng, n_sh, cap, n_rounds, lanes, NOW0 + n_rounds,
                                    later_clears=True)
        got = k11_batch_runner(torch, np, pieces, cap)(state)
        want = k11_batch_plain(torch, plain, pieces, cap)
        torch.cuda.synchronize()
        err = max(int((got.long() - want.long()).abs().max().item()),
                  compare_states(torch, state, plain))
        errs["shard_step"] = max(errs["shard_step"], err)
        check(err == 0, f"K11 over {n_rounds} rounds of {lanes} lanes a shard, {n_sh} x {cap}, "
              f"differs from the plain rounds: err {err}")


def hold_k12_widths(torch, np, rng, errs, state, plain, n_sh: int, cap: int,
                    widths=K12_READ_WIDTHS) -> None:
    """K12 on zipf chunks (a hot key over half of shard 0) with clears at
    each width, against the plain version: pout and all 12 columns
    bit-equal."""
    from gubernator_tpu_torch.ops import bucket_kernel as tk
    from gubernator_tpu_torch.ops.sharded_step import shard_collapsed_step

    for width in widths:
        pin_np, slots_of = sharded_pin(np, rng, n_sh, cap, width, NOW0 + width, collapsed=True)
        rows_np = shard_clears(np, rng, cap, slots_of)
        pin, rows = torch.from_numpy(pin_np).cuda(), torch.from_numpy(rows_np).cuda()
        got = shard_collapsed_step(state, pin, cap, rows)
        tk.shard_clears_reference(plain, rows, cap)
        want = tk.sharded_collapsed_step_reference(plain, pin, cap)
        torch.cuda.synchronize()
        err = max(int((got.long() - want.long()).abs().max().item()),
                  compare_states(torch, state, plain))
        errs["shard_collapsed"] = max(errs["shard_collapsed"], err)
        check(err == 0, f"K12 at {width} lanes a shard, {n_sh} x {cap}, differs from its plain "
              f"version: err {err}")


def read_k11_k12(torch, np, rng, card, errs) -> None:
    """The device readings: K11 over batches of R = 1, 2, 4, 8 rounds
    (one launch, or one a round on a port from before), over 4 shards of
    2.5 x 10^7 at 512 lanes a shard and over 8 shards of 2^16 at 128, and
    one round with no clears at half and all of those lanes, slots spread
    over the shard and dense; K12 at 64, 512, 1024 and 4096 lanes a shard
    over 4 shards of 2.5 x 10^7.
    Each held against its plain version first; us a batch (CUDA events
    behind the spin kernel, median of 7 windows of n batches, n small
    enough that the host queues a window inside the spin) beside the bytes
    bound."""
    from gubernator_tpu_torch.ops.sharded_step import shard_collapsed_step

    multi = k11_takes_rounds()
    for n_sh, cap, lanes in K11_READ:
        state = random_state(torch, n_sh * cap, NOW0, int(rng.integers(2**31)))
        plain = copy_state(state)
        hold_k11_rounds(torch, np, rng, errs, state, plain, n_sh, cap, lanes)
        if n_sh == 4:
            hold_k12_widths(torch, np, rng, errs, state, plain, n_sh, cap)
        del plain
        for n_rounds in K11_READ_ROUNDS:
            pieces = shard_round_pieces(np, rng, n_sh, cap, n_rounds, lanes, NOW0,
                                        later_clears=False)
            run = k11_batch_runner(torch, np, pieces, cap, keep=False)
            ms = device_ms(torch, lambda i: run(state), max(5, 40 // n_rounds))
            pin, rows, *_ = join_shard_rounds(np, pieces)
            bnd = k11_bound_ms(pin, rows, cap, n_rounds)
            log(f"[readings] K11 R={n_rounds}, {n_sh} x {cap}, {lanes} lanes a shard a round: "
                f"{ms * 1e3:.3f} us a batch ({1 if multi else n_rounds} launch(es)), bound "
                f"{bnd * 1e3:.4f} us | {card}")
        # One round with no clears, the shape of path (b)'s spread batches,
        # 200 launches a window as the full run's timing phase takes them;
        # slots over the whole shard, and dense as an engine's.
        for dense, width in itertools.product((False, True), (lanes // 2, lanes)):
            pieces = shard_round_pieces(np, rng, n_sh, cap, 1, width, NOW0, later_clears=False,
                                        clears=False, dense=dense)
            run = k11_batch_runner(torch, np, pieces, cap, keep=False)
            ms = device_ms(torch, lambda i: run(state), 200)
            pin, rows, *_ = join_shard_rounds(np, pieces)
            log(f"[readings] K11 R=1 without clears, {n_sh} x {cap}, {width} lanes a shard, "
                f"slots {'in the first 2^15' if dense else 'over the shard'}: {ms * 1e3:.3f} us "
                f"a launch, bound {k11_bound_ms(pin, rows, cap) * 1e3:.4f} us | {card}")
        for width in K12_READ_WIDTHS if n_sh == 4 else ():
            pin_np, slots_of = sharded_pin(np, rng, n_sh, cap, width, NOW0, collapsed=True)
            rows_np = shard_clears(np, rng, cap, slots_of)
            pin, rows = torch.from_numpy(pin_np).cuda(), torch.from_numpy(rows_np).cuda()
            bnd = k12_bound_ms(pin_np, rows_np, cap)
            ms = device_ms(torch, lambda i: shard_collapsed_step(state, pin, cap, rows), 40)
            log(f"[readings] K12 W={width}, {n_sh} x {cap}: {ms * 1e3:.3f} us a launch, bound "
                f"{bnd * 1e3:.4f} us | {card}")
        del state
        torch.cuda.empty_cache()


def read_path_b(torch, np, rng, card) -> None:
    """Sharded path (b)'s dataclass route (V1Instance, 4 shards of 2.5 x
    10^7, cfg3's keys and configurations): the full run's two kinds of
    batches (zipf(1.1) with hits 1, which collapse; spread ranks with hits
    0 / 1 / 1 / 2) and zipf batches with hits 0 / 1 / 1 / 2 (a hot key's
    hits differ, so they do not collapse and run as rounds).  A batch's
    rounds (the histogram), its K11 and K12 launches and its wall time,
    READ_BATCHES batches of each kind after two warm-up batches."""
    from gubernator_tpu_torch.clock import Clock
    from gubernator_tpu_torch.ops import fused_step as fs
    from gubernator_tpu_torch.parallel.sharded_engine import ShardedDecisionEngine
    from gubernator_tpu_torch.service import V1Instance

    n_sh, cap = SHARD_B
    t = time.perf_counter()
    eng = ShardedDecisionEngine(cap, n_shards=n_sh, clock=Clock().freeze_at(NOW0 * 10**6))
    inst = V1Instance(eng, ledger=False)
    log(f"[readings] path (b): {n_sh} x {cap} engine built in {time.perf_counter() - t:.1f} s")
    kinds = {
        "zipf, hits 1 (collapses)": lambda: cfg3_requests(
            np, cfg3_ranks(np, rng, BATCH, True), np.ones(BATCH, np.int64)),
        "spread, hits 0-2": lambda: cfg3_requests(
            np, cfg3_ranks(np, rng, BATCH, False), rng.choice([0, 1, 1, 2], BATCH)),
        "zipf, hits 0-2 (rounds)": lambda: cfg3_requests(
            np, cfg3_ranks(np, rng, BATCH, True), rng.choice([0, 1, 1, 2], BATCH)),
    }
    for kind, make in kinds.items():
        rows = []
        for b in range(2 + READ_BATCHES):
            reqs = make()
            eng.clock.advance(ms=50)
            before, r0 = dict(fs.launches), eng.rounds_total
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            inst.get_rate_limits(reqs)
            wall = time.perf_counter() - t0
            if b >= 2:
                rows.append((eng.rounds_total - r0,
                             fs.launches["shard_step"] - before["shard_step"],
                             fs.launches["shard_collapsed"] - before["shard_collapsed"], wall))
        hist = {}
        for r, *_ in rows:
            hist[r] = hist.get(r, 0) + 1
        walls = sorted(w * 1e3 for *_, w in rows)
        log(f"[readings] path (b) dataclass, {kind}: rounds a batch {dict(sorted(hist.items()))} "
            f"(rounds: batches); K11 launches a batch {[k for _, k, _, _ in rows]}; K12 launches "
            f"a batch {[k for _, _, k, _ in rows]}; wall a batch median "
            f"{statistics.median(walls):.3f} ms (range {walls[0]:.3f}-{walls[-1]:.3f}) | {card}")
    inst.close()
    eng.close()
    del eng
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# A restoring round's K2 then K5, and the split arm (K14-K16)


def has_split() -> bool:
    """Whether the driven port has the split arm (K14-K16, GUBER_FUSED)."""
    from gubernator_tpu_torch.ops import fused_step as fs

    return hasattr(fs, "split_launches")


def restore_launches(fs) -> int:
    """K2 and K5 launches so far."""
    return sum(k2_k5(fs))


def k2_k5(fs) -> tuple:
    """(K2 launches, K5 launches) so far."""
    return fs.launches["clear_occupied"], fs.launches["load_slots"]


# A restoring round's readings: (cap, clears, records); records 0 is clears alone,
# clears 0 records alone.
CR_READINGS = ([(cap, c, r) for cap in (CAP_SERVE, CAP_NORTH_STAR) for c in (16, 1000)
                for r in (16, 4096)]
               + [(cap, c, 0) for cap in (CAP_SERVE, CAP_NORTH_STAR) for c in (16, 1000)]
               + [(cap, 0, r) for cap in (CAP_SERVE, CAP_NORTH_STAR) for r in (16, 4096)])


def clear_restore_case(np, rng, cap: int, n_clear: int, n_rec: int, now: int):
    """A restoring round's clears and record: `n_rec` records on random
    slots (padded as `build_restore_record` pads them) and `n_clear`
    unique clears, half of them (at most every record) slots the record
    restores, as evictions whose slot a restored key takes.  Returns
    (clears int64 [n_clear], record int32 [19, size] or None)."""
    from gubernator_tpu_torch.ops.bucket_kernel import pad_size

    rec = None
    restored = np.zeros(0, np.int64)
    if n_rec:
        rec = restore_record(np, rng, cap, pad_size(n_rec, floor=16), now, n=n_rec)
        restored = rec[0, :n_rec].astype(np.int64)
    k = min(n_clear // 2, len(restored)) if n_rec else 0
    other = rng.choice(cap, 2 * n_clear + 64, replace=False)
    other = other[~np.isin(other, restored)][: n_clear - k]
    clears = np.concatenate([rng.choice(restored, k, replace=False), other]).astype(np.int64)
    rng.shuffle(clears)
    return clears, rec


def clear_restore_runner(torch, np, cap: int, clears, rec):
    """The driven port's launches for one restoring round, each input
    staged once: K2 over the clears padded as the engine pads them, then
    K5 over the record.  Returns a function of the state."""
    from gubernator_tpu_torch.ops import bucket_kernel as tk
    from gubernator_tpu_torch.ops import fused_step as fs

    c = np.arange(cap, cap + tk.pad_size(len(clears), floor=16), dtype=np.int64)
    c[: len(clears)] = clears
    cd = torch.from_numpy(c.astype(np.int32)).cuda()
    rd = torch.from_numpy(rec).cuda() if rec is not None else None

    def pair(state):
        if len(clears):
            fs.clear_occupied(state.meta, cd)
        if rd is not None:
            fs.load_slots(state, rd)

    return pair


def clear_restore_plain(torch, np, state, clears, rec) -> None:
    """The plain version: the clear at every slot, then the restore."""
    from gubernator_tpu_torch.ops import bucket_kernel as tk

    tk.clear_occupied_reference(state.meta, torch.from_numpy(
        np.unique(clears).astype(np.int32)).cuda())
    if rec is not None:
        tk.load_slots_reference(state, torch.from_numpy(rec).cuda())


def k2k5_bound_ms(np, clears, rec, cap: int) -> float:
    """Least time for a restoring round's clears and restores: 12 B a
    clear that the record does not overwrite (its slot read, one meta word
    read and written) and K5's bytes (`k5_bound_ms`)."""
    restored = rec[0].astype(np.int64) if rec is not None else np.zeros(0, np.int64)
    n = int((~np.isin(np.unique(clears), restored)).sum())
    return n * 12 / HBM_BYTES_PER_S * 1e3 + (k5_bound_ms(rec, cap) if rec is not None else 0.0)


def hold_clear_restore(torch, np, rng, errs, kern, plain, cap: int) -> None:
    """K2 then K5 against the plain clear then restore at every reading of
    `cap` (the clears half on restored slots), every state word."""
    for c_cap, n_clear, n_rec in CR_READINGS:
        if c_cap != cap:
            continue
        for _ in range(2):
            clears, rec = clear_restore_case(np, rng, cap, n_clear, n_rec, NOW0)
            clear_restore_runner(torch, np, cap, clears, rec)(kern)
            clear_restore_plain(torch, np, plain, clears, rec)
            torch.cuda.synchronize()
            err = compare_states(torch, kern, plain)
            for name in ("clear_occupied",) * (n_clear > 0) + ("load_slots",) * (n_rec > 0):
                errs[name] = max(errs[name], err)
            check(err == 0, f"K2 then K5 differ from the plain clear then restore: cap {cap}, "
                  f"{n_clear} clears, {n_rec} records, err {err}")
    log(f"[k2+k5] cap {cap}: clears {{16, 1000}} x records {{16, 4096}} (half the clears on "
        "restored slots), clears alone {16, 1000} and records alone {16, 4096}, K2 then K5, "
        "bit-equal to clear then restore (tolerance: exact)")


def time_clear_restore(torch, np, rng, card) -> dict:
    """Each restoring-round reading timed as the driven port runs it (K2
    then K5 in one timed sequence), 16 cases a reading behind the spin
    kernel, on a random state, beside its bytes bound."""
    out = {}
    for cap in (CAP_SERVE, CAP_NORTH_STAR):
        state = random_state(torch, cap, NOW0, int(rng.integers(2**31)))
        for c_cap, n_clear, n_rec in CR_READINGS:
            if c_cap != cap:
                continue
            cases = [clear_restore_case(np, rng, cap, n_clear, n_rec, NOW0) for _ in range(16)]
            runs = [clear_restore_runner(torch, np, cap, c, r) for c, r in cases]
            runs[0](state)
            ms = device_ms(torch, lambda i: runs[i % 16](state), 160)
            bound = statistics.median(k2k5_bound_ms(np, c, r, cap) for c, r in cases)
            key = f"{n_clear} clears, {n_rec} records, cap " + (
                "2^20" if cap == CAP_SERVE else "10^8")
            out[key] = (ms, bound)
        del state
        torch.cuda.empty_cache()
    log(f"[time] restoring round (K2 then K5), us a round (bytes bound): " + "; ".join(
        f"{k} {v[0] * 1e3:.3f} ({v[1] * 1e3:.4f})" for k, v in out.items()) + f" | {card}")
    return out


WALL_REPLAYS = 3  # replays of each restore stream in `store_walls`


def store_walls(torch, np, rng, card) -> dict:
    """The restore streams' walls: the wall time of a get_rate_limits
    batch with restores on the persistence path's evicting store engine
    (4096 slots, 24 batches of 1000; the batches with a restoring round),
    and of a batch of the sharded restore stream (8 shards of 2 slots, 30
    batches, keys back from the store in later rounds), each after 2
    untimed batches.  Each stream is replayed WALL_REPLAYS times on fresh
    engines (the same batches and clock steps), a batch's wall is its
    least over the replays (host hiccups drop out), and a stream's reading
    is the median over its batches.  Also the K2 / K5 launches a restoring
    round, and the wall inside the restore calls a restoring round (the
    host and launch work the change touches, with a synchronisation)."""
    from gubernator_tpu_torch.clock import Clock
    from gubernator_tpu_torch.core.engine import DecisionEngine
    from gubernator_tpu_torch.ops import fused_step as fs
    from gubernator_tpu_torch.store import MemoryStore

    ns = NOW0 * 1_000_000
    small = [b"api_e%d" % i for i in range(3 * 4096)]
    hot = [b"api_hot%d" % i for i in range(50)]
    dense = [(as_requests(*stream_columns(np, rng, small, hot, BATCH)),
              int(rng.integers(0, 2_000))) for _ in range(26)]
    sharded = []
    for _ in range(32):
        n = int(rng.integers(8, 48))
        sharded.append((cfg3_requests(np, rng.integers(0, int(rng.integers(16, 64)), n),
                                      rng.choice([0, 1, 1, 2], n)), int(rng.choice([0, 40, 400]))))

    def replay(make, method, batches, dataclass_now):
        eng = make()
        real = getattr(eng, method)
        inside = []

        def counted(r):
            torch.cuda.synchronize()
            t = time.perf_counter()
            real(r)
            torch.cuda.synchronize()
            inside.append(time.perf_counter() - t)

        setattr(eng, method, counted)
        walls, per_round, in_round = [], [], []
        now = NOW0
        for b, (reqs, dt) in enumerate(batches):
            inside.clear()
            l0 = restore_launches(fs)
            torch.cuda.synchronize()
            t = time.perf_counter()
            if dataclass_now:
                eng.get_rate_limits(reqs, now_ms=now)
                now += dt
            else:
                eng.get_rate_limits(reqs)
                eng.clock.advance(ms=dt)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t, bool(inside)) if b >= 2 else None)
            if b >= 2 and inside:
                per_round.append((restore_launches(fs) - l0) / len(inside))
                in_round.extend(inside)
        eng.close()
        return walls, per_round, in_round

    def reading(make, method, batches, dataclass_now, only_restoring):
        runs = [replay(make, method, batches, dataclass_now) for _ in range(WALL_REPLAYS)]
        walls = [min(r[0][b][0] for r in runs) for b in range(2, len(batches))
                 if runs[0][0][b][1] or not only_restoring]
        check(len(walls) > 0, "[walls] no batch of the stream restored an item")
        per_round = [x for r in runs for x in r[1]]
        in_round = [x for r in runs for x in r[2]]
        return (statistics.median(walls), min(walls), max(walls), len(walls),
                statistics.mean(per_round) if per_round else 0.0,
                statistics.median(in_round) if in_round else 0.0)

    out = {
        "persist": reading(lambda: DecisionEngine(4096, clock=Clock().freeze_at(ns), device="cuda",
                                                  store=MemoryStore()),
                           "_apply_restores", dense, False, True),
        "sharded": reading(lambda: sharded_pair(2, SHARD_A[0], ns, store=MemoryStore)[0],
                           "_apply_shard_restores", sharded, True, False),
    }
    for k, v in out.items():
        log(f"[walls] {k} restore stream: {v[0] * 1e3:.3f} ms a batch median ({v[1] * 1e3:.3f}"
            f"-{v[2] * 1e3:.3f}) over {v[3]} batches, each its least of {WALL_REPLAYS} replays; "
            f"{v[4]:.2f} K2 / K5 launches a restoring round; {v[5] * 1e6:.1f} us inside the "
            f"restore call a restoring round (median) | {card}")
    return out


def split_bound_ms(np, kind: str, pin, cap: int) -> float:
    """Least time for one K14, K15 or K16 launch (bytes): K14 per lane 60 B
    of pin, 20 B of pout and 48 B of words, per in-range lane 48 B of state
    read, and the 8 B header; K15 per lane its 4 B slot, per in-range lane
    48 B of words read and 48 B of state written; K16 the 8 B header, per
    lane 8 B of rows 17-18 and 20 B of pout, per in-range segment 64 B of
    pin, 48 B of state read and 48 B of words written."""
    w = pin.shape[1]
    slot = pin[1].astype(np.int64)
    n = int(((slot >= 0) & (slot < cap)).sum())
    if kind == "k14":
        b = 8 + w * (60 + 20 + 48) + n * 48
    elif kind == "k15":
        b = w * 4 + n * 96
    else:
        b = 8 + w * 28 + n * (64 + 96)
    return b / HBM_BYTES_PER_S * 1e3


def phase_split_kernels(torch, np, rng, errs):
    """K14, K15 and K16 against their plain versions on the card at caps
    2^20 and 10^8, on K1's inputs (mixed batches of 1000 in pins of 1024)
    and K3's (zipf chunks of 8192): pout, the words of every in-range lane
    or segment, the state untouched by K14 / K16, and every state word
    after K15."""
    from gubernator_tpu_torch.ops import bucket_kernel as tk
    from gubernator_tpu_torch.ops import split_step as ss

    def hold(name, got, want, what):
        torch.cuda.synchronize()
        err = 0 if torch.equal(got, want) else int((got.long() - want.long()).abs().max().item())
        errs[name] = max(errs[name], err)
        check(err == 0, f"{name} differs from its plain version: {what} err {err}")

    for cap in (CAP_SERVE, CAP_NORTH_STAR):
        kern = random_state(torch, cap, NOW0, int(rng.integers(2**31)))
        plain = copy_state(kern)
        now = NOW0
        for kind in ("k1", "k1", "k1", "k3", "k3"):
            now += int(rng.integers(0, 3_000))
            if kind == "k1":
                host = random_pin(np, rng, cap, 1024, BATCH, now)
                pin = torch.from_numpy(host).cuda()
                slot, w, pout = ss.packed_compute(kern, pin)
                pslot, pw, ppout = tk.packed_compute_reference(plain, pin)
                name = "packed_compute"
            else:
                host, _clears = collapsed_case(np, rng, cap, "zipf", now)
                pin = torch.from_numpy(host).cuda()
                slot, w, pout = ss.collapsed_compute(kern, pin)
                pslot, pw, ppout = tk.collapsed_compute_reference(plain, pin)
                name = "collapsed_compute"
            live = torch.from_numpy((host[1] >= 0) & (host[1].astype(np.int64) < cap)).cuda()
            hold(name, pout, ppout, f"cap {cap} {kind} pout")
            hold(name, w[:, live], pw[:, live], f"cap {cap} {kind} words")
            torch.cuda.synchronize()
            err = compare_states(torch, kern, plain)
            check(err == 0, f"{name} wrote the state at cap {cap}")
            ss.scatter_store(kern, slot, w)
            tk.scatter_store_reference(plain, pslot, pw)
            torch.cuda.synchronize()
            err = compare_states(torch, kern, plain)
            errs["scatter_store"] = max(errs["scatter_store"], err)
            check(err == 0, f"scatter_store differs from its plain version at cap {cap}: err {err}")
        log(f"[k14-k16] cap {cap}: K14 on 3 mixed batches of {BATCH} (W 1024) and K16 on 2 zipf "
            f"chunks of {ZIPF_BATCH}, each then K15: pout, in-range words and every state word "
            "bit-equal to the plain versions (tolerance: exact)")
        del kern, plain
        torch.cuda.empty_cache()


# The split path's streams: (tag, cap, batches of (keys, cols), entry,
# store, paging (page, frames) or None).
SPLIT_PAGED = (64, 32)  # pages of 64, 32 frames: 2048 rows over 65,536 keys


def split_streams(np, rng):
    pool = [b"api_k%d" % i for i in range(200_000)]
    hot = [b"api_hot%d" % i for i in range(50)]
    small = [b"api_e%d" % i for i in range(3 * 4096)]
    perm = rng.permutation(1 << 16)

    def paged_batch(b):  # spread and zipf batches in turn: pages fault in and out
        idx = paged_zipf(np, rng, perm, BATCH) if b % 2 else rng.integers(0, len(perm), BATCH)
        return [b"pg_%d" % i for i in idx.tolist()], paged_cols(np, idx)

    return [
        ("mixed", CAP_SERVE, [stream_columns(np, rng, pool, hot, BATCH) for _ in range(8)],
         "both", False, None),
        ("evict", 4096, [stream_columns(np, rng, small, hot, BATCH) for _ in range(6)],
         "both", False, None),
        ("zipf", ZIPF_CAP, [zipf_columns(np, rng) for _ in range(3)], "columnar", False, None),
        ("store", 4096, [stream_columns(np, rng, small, hot, BATCH) for _ in range(8)],
         "dataclass", True, None),
        ("paged", 1 << 16, [paged_batch(b) for b in range(8)], "both", False, SPLIT_PAGED),
    ]


def split_engines(cap, store, paging, arm, devices):
    """Engines of the arm `arm` ("split" or None, the default fused arm) on
    `devices`, frozen at NOW0, with a MemoryStore each when `store`."""
    from gubernator_tpu_torch.clock import Clock
    from gubernator_tpu_torch.core.engine import DecisionEngine
    from gubernator_tpu_torch.store import MemoryStore

    ctx = paged_env(*paging) if paging else contextlib.nullcontext()
    with ctx, engine_env(GUBER_FUSED=arm):
        return [DecisionEngine(cap, clock=Clock().freeze_at(NOW0 * 1_000_000), device=d,
                               max_kernel_width=ZIPF_BATCH,
                               store=MemoryStore() if store else None) for d in devices]


def drive(engines, np, keys, cols, b, entry):
    """One batch through each engine by the stream's entry point; returns
    the answers as tuples."""
    out = []
    use_dc = entry == "dataclass" or (entry == "both" and b % 2 == 1)
    for e in engines:
        if use_dc:
            out.append([(int(r.status), r.limit, r.remaining, r.reset_time, r.error)
                        for r in e.get_rate_limits(as_requests(keys, cols))])
        else:
            out.append([np.asarray(a).tolist() for a in e.apply_columnar(keys, *cols)])
    return out


def phase_split(torch, np, rng, card):
    """The split path (GUBER_FUSED=split, the reference's A/B control): a
    split engine on the card and one on the CPU over five streams —
    mixed (2^20 slots, batches of 1000, every other batch through
    get_rate_limits), evict (4096 slots), zipf (2^24 slots, batches of
    8192: collapse), store (4096 slots with a MemoryStore: restores in
    later rounds) and paged (pages of 64, 32 frames, 65,536 keys, spread
    and zipf batches in turn) —
    answers, every state word, stores and page tables equal.  Returns
    (card engines, the streams' batches and answers, for `split_vs_fused`)."""
    from gubernator_tpu_torch.ops import bucket_kernel as tk

    engines, record = [], []
    for tag, cap, batches, entry, store, paging in split_streams(np, rng):
        gpu, cpu = split_engines(cap, store, paging, "split", ("cuda", "cpu"))
        check(gpu.fused_mode == cpu.fused_mode == "split", f"[split {tag}] not the split arm")
        answers = []
        for b, (keys, cols) in enumerate(batches):
            got, want = drive((gpu, cpu), np, keys, cols, b, entry)
            check(got == want, f"[split {tag}] batch {b}: answers differ card vs CPU")
            answers.append(got)
            for e in (gpu, cpu):
                e.clock.advance(ms=137 * (b + 1))
        gw, cw = tk.state_to_numpy(gpu.state), tk.state_to_numpy(cpu.state)
        for f in tk.BucketState._fields:
            check(np.array_equal(gw[f], cw[f]), f"[split {tag}] state column {f} differs")
        if store:
            check({k: vars(v) for k, v in gpu.store.data.items()}
                  == {k: vars(v) for k, v in cpu.store.data.items()},
                  f"[split {tag}] the stores differ")
            check(gpu.store.get_calls > 0, f"[split {tag}] no store read")
        if paging:
            same_paging(np, tk, gpu, cpu, f"[split {tag}]", words=True)
            check(gpu.paging.faults > 0, f"[split {tag}] no fault")
        check(gpu.dispatches_total == cpu.dispatches_total
              and gpu.rounds_total == cpu.rounds_total,
              f"[split {tag}] launches or rounds differ card vs CPU")
        check(gpu.dispatches_total >= 2 * gpu.rounds_total,
              f"[split {tag}] fewer than two launches a round")
        log(f"[split {tag}] {len(batches)} batches: {gpu.rounds_total} rounds in "
            f"{gpu.dispatches_total} launches ({gpu.dispatches_total / gpu.rounds_total:.2f} a "
            f"round), {gpu.clears_total} clears, {gpu.table.evictions} evictions; card = CPU, "
            "answers and every state word")
        record.append((tag, cap, batches, entry, store, paging, answers, gw))
        cpu.close()
        engines.append(gpu)
    return engines, record


def split_vs_fused(torch, np, record, card) -> None:
    """The card's fused engine on the split path's streams: the same
    answers and state words as the split engine."""
    from gubernator_tpu_torch.ops import bucket_kernel as tk

    for tag, cap, batches, entry, store, paging, answers, words in record:
        (eng,) = split_engines(cap, store, paging, None, ("cuda",))
        check(eng.fused_mode == "cuda", f"[split {tag}] the fused engine is not the fused arm")
        for b, (keys, cols) in enumerate(batches):
            (got,) = drive((eng,), np, keys, cols, b, entry)
            check(got == answers[b], f"[split {tag}] batch {b}: the fused engine answers "
                  "otherwise")
            eng.clock.advance(ms=137 * (b + 1))
        fw = tk.state_to_numpy(eng.state)
        for f in tk.BucketState._fields:
            check(np.array_equal(fw[f], words[f]), f"[split {tag}] the fused engine's column "
                  f"{f} differs")
        eng.close()
    log(f"[split] the card's fused engine gave the split engine's answers and state words on "
        f"all {len(record)} streams | {card}")


def split_rates(torch, np, rng, card) -> dict:
    """decisions/s and launches a round of the split and the fused engine
    on the card, the mixed stream through apply_columnar (24 batches of
    1000 at 2^20, the first 4 untimed)."""
    pool = [b"api_k%d" % i for i in range(200_000)]
    hot = [b"api_hot%d" % i for i in range(50)]
    batches = [stream_columns(np, rng, pool, hot, BATCH) for _ in range(24)]
    out = {}
    for arm in ("split", None):
        (eng,) = split_engines(CAP_SERVE, False, None, arm, ("cuda",))
        t = n = d0 = r0 = 0
        for b, (keys, cols) in enumerate(batches):
            if b == 4:
                torch.cuda.synchronize()
                t, d0, r0 = time.perf_counter(), eng.dispatches_total, eng.rounds_total
            eng.apply_columnar(keys, *cols)
            n += len(keys) if b >= 4 else 0
            eng.clock.advance(ms=int(rng.integers(0, 2_000)))
        torch.cuda.synchronize()
        out[arm or "fused"] = (n / (time.perf_counter() - t),
                               (eng.dispatches_total - d0) / max(1, eng.rounds_total - r0))
        eng.close()
    log("[split rates] mixed stream, apply_columnar on the card: " + "; ".join(
        f"{k} {v[0]:.0f} decisions/s, {v[1]:.2f} launches a round" for k, v in out.items())
        + f" | {card}")
    return out


def time_split(torch, np, rng, card) -> dict:
    """K14 and K15 on mixed batches of 1000 (pins of 1024 lanes, cap 2^20)
    and K16 on zipf chunks of 8192 (cap 2^24), each then K15 as the split
    engine runs them (CUDA events behind the spin kernel), beside the plain
    versions and the bytes bounds.  No single PyTorch call computes any of
    the three (K15 would need one indexed copy over twelve separate
    columns): library_ms is null."""
    from gubernator_tpu_torch.ops import bucket_kernel as tk
    from gubernator_tpu_torch.ops import split_step as ss

    out = {}
    for cap, kind in ((CAP_SERVE, "k14"), (ZIPF_CAP, "k16")):
        state = random_state(torch, cap, NOW0, int(rng.integers(2**31)))
        plain = copy_state(state)
        if kind == "k14":
            host = [random_pin(np, rng, cap, 1024, BATCH, NOW0 + i) for i in range(16)]
            compute, ref = ss.packed_compute, tk.packed_compute_reference
        else:
            host = [collapsed_case(np, rng, cap, "zipf", NOW0 + i)[0] for i in range(16)]
            compute, ref = ss.collapsed_compute, tk.collapsed_compute_reference
        pins = [torch.from_numpy(p).cuda() for p in host]
        outs = [compute(state, p) for p in pins]
        c_ms = device_ms(torch, lambda i: compute(state, pins[i % 16]), 160)
        s_ms = device_ms(torch, lambda i: ss.scatter_store(state, outs[i % 16][0],
                                                           outs[i % 16][1]), 160)
        c_plain = host_ms(torch, lambda i: ref(plain, pins[i % 16]), 16, windows=3)
        pouts = [ref(plain, p) for p in pins]
        s_plain = host_ms(torch, lambda i: tk.scatter_store_reference(
            plain, pouts[i % 16][0], pouts[i % 16][1]), 16, windows=3)
        c_bound = statistics.median(split_bound_ms(np, kind, p, cap) for p in host)
        s_bound = statistics.median(split_bound_ms(np, "k15", p, cap) for p in host)
        out[kind] = (c_ms, c_plain, c_bound)
        out[f"k15_{kind}"] = (s_ms, s_plain, s_bound)
        log(f"[time] {kind.upper()} on {'mixed batches of 1000 (W 1024), cap 2^20' if kind == 'k14' else 'zipf chunks of 8192, cap 2^24'}: "
            f"{c_ms * 1e3:.2f} us/launch, bound {c_bound * 1e3:.3f} us (bytes), plain "
            f"{c_plain * 1e3:.1f} us; K15 on its words {s_ms * 1e3:.2f} us/launch, bound "
            f"{s_bound * 1e3:.3f} us, plain {s_plain * 1e3:.1f} us | {card}")
        del state, plain, outs, pouts
        torch.cuda.empty_cache()
    return out


def time_k1_k3(torch, np, rng, card) -> dict:
    """K1 at R = 1 (W 1024 and 8192, cap 2^20) and K3 on one-key and spread
    zipf chunks (cap 2^24), as `phase_timing` times them: the kernels whose
    lane and tile the split arm's store policy touched, for a parent /
    change comparison."""
    from gubernator_tpu_torch.ops import fused_step as fs
    from gubernator_tpu_torch.ops.collapsed_step import collapsed_step

    out = {}
    state = random_state(torch, CAP_SERVE, NOW0, int(rng.integers(2**31)))
    for width, m in ((1024, BATCH), (8192, 8192)):
        pins = [torch.from_numpy(random_pin(np, rng, CAP_SERVE, width, m, NOW0 + i)).cuda()
                for i in range(16)]
        # fused_step's R = 1 call, with its offsets made once (as phase_timing)
        one = (torch.tensor([0, width], dtype=torch.int32, device="cuda"),
               torch.zeros(2, dtype=torch.int32, device="cuda"),
               torch.tensor([CAP_SERVE], dtype=torch.int32, device="cuda"))
        for i in range(20):
            fs.multi_fused_step(state, pins[i % 16], *one, widest=width)
        out[f"K1 W={width}"] = device_ms(torch, lambda i: fs.multi_fused_step(
            state, pins[i % 16], *one, widest=width), 200)
    del state
    zstate = random_state(torch, ZIPF_CAP, NOW0, int(rng.integers(2**31)))
    for kind in ("one", "zipf"):
        cases = [collapsed_case(np, rng, ZIPF_CAP, kind, NOW0 + i) for i in range(8)]
        dev = [(torch.from_numpy(p).cuda(), torch.from_numpy(c[:0]).cuda()) for p, c in cases]
        collapsed_step(zstate, *dev[0])
        out[f"K3 {kind}"] = device_ms(torch, lambda i: collapsed_step(zstate, *dev[i % 8]), 40)
    del zstate
    torch.cuda.empty_cache()
    log("[time] K1 / K3 (us a launch): " + "; ".join(f"{k} {v * 1e3:.3f}" for k, v in out.items())
        + f" | {card}")
    return out


def readings_k2k5(torch, np, rng, card, errs) -> int:
    """`--readings` (default): a restoring round's readings for a parent /
    change comparison — K2 then K5 held against the plain clear then
    restore and timed at every reading (`time_clear_restore`), K1 and K3
    timed (`time_k1_k3`), and the restore streams' walls (`store_walls`).
    Exits 0 with no result lines."""
    for cap in (CAP_SERVE, CAP_NORTH_STAR):
        kern = random_state(torch, cap, NOW0, int(rng.integers(2**31)))
        plain = copy_state(kern)
        hold_clear_restore(torch, np, rng, errs, kern, plain, cap)
        del kern, plain
        torch.cuda.empty_cache()
    time_clear_restore(torch, np, rng, card)
    time_k1_k3(torch, np, rng, card)
    store_walls(torch, np, rng, card)
    log(f"[readings] done in {time.perf_counter() - T_START:.1f} s | {card}")
    return 0


def sweep_counts(engines):
    """(windows swept, sweep launches) of a path's card engines: the
    launches are the groups (`sweep_groups_total`), or one a window on a
    port from before the groups."""
    windows = sum(e.sweep_windows_total for e in engines)
    groups = sum(getattr(e, "sweep_groups_total", e.sweep_windows_total) for e in engines)
    return windows, groups


def check_grouped(windows: int, groups: int, path: str, multi: bool = True) -> None:
    """A port with group sweeps launched no more sweeps than it swept
    windows, and, on a path whose sweeps cover several windows (`multi`),
    fewer."""
    if has_sweep_groups():
        check(0 < groups <= windows and (groups < windows or not multi),
              f"the {path} path swept {windows} windows in {groups} launches: one launch must "
              "sweep a group of windows")


def readings(torch, np, rng, card, errs) -> int:
    """`--readings`: K11 over batches of 1, 2, 4 and 8 rounds and K12 at
    four widths, each held against its plain version and timed
    (`read_k11_k12`), then sharded path (b)'s dataclass route
    (`read_path_b`).  Exits 0 with no result lines."""
    read_k11_k12(torch, np, rng, card, errs)
    read_path_b(torch, np, rng, card)
    log(f"[readings] done in {time.perf_counter() - T_START:.1f} s | {card}")
    return 0


# ---------------------------------------------------------------------------
# K17, the dataclass step (ops.apply_batch), and its path


APPLY_WIDTHS = ((64, 58), (1024, 1000), (8192, 7372))  # (lanes, real lanes): 1000 padded to 1024
APPLY_BATCHES = 24  # the apply_batch path's batches of 1000
APPLY_POOL = 200_000  # its keys, on 2^20 slots


def has_apply_batch() -> bool:
    """The driven port has K17 (a --tree checkout from before its slice
    has not)."""
    from gubernator_tpu_torch.ops import fused_step as fs

    return "apply_batch" in fs.launches


def apply_batch_case(np, rng, cap: int, width: int, m: int, now: int, *, extreme=False):
    """A dataclass batch of `width` lanes, `m` of them real: unique slots
    of [0, cap) in random lane order (the reference's contract: no sort
    needed), padding lanes at cap + lane; its clears: an eighth of its own
    slots, 64 slots of no lane and 5 out of range, in random order.  With
    `extreme`, `extreme_cols`' values on the first lanes.  Returns
    (columns in BatchInput order, clears), numpy."""
    slot = np.full(width, -1, np.int64)
    slot[:m] = rng.choice(cap, m, replace=False)
    slot = slot[rng.permutation(width)]
    pad = slot < 0
    slot[pad] = cap + np.nonzero(pad)[0]
    cols = [
        rng.integers(0, 3, width).astype(np.int32),
        rng.choice(np.array([0, 0, 4, 8, 12]), width).astype(np.int32),
        rng.choice(np.array([-3, 0, 1, 1, 2, 5, 100, 2**40]), width).astype(np.int64),
        rng.choice(np.array([-1, 0, 1, 5, 100, 10**12, 2**62]), width).astype(np.int64),
        rng.choice(np.array([0, 1, 40, 1000, 30_000, -5]), width).astype(np.int64),
        rng.choice(np.array([0, 0, 5, 20, -7]), width).astype(np.int64),
        rng.choice(np.array([60_000, 3_600_000, 86_400_000]), width).astype(np.int64),
        (now + rng.integers(0, 100_000, width)).astype(np.int64),
    ]
    if extreme:
        _s, ext = extreme_cols(np, cap, min(48, width), now)
        for c, e in zip(cols, ext):
            c[: len(e)] = e
    own = slot[~pad]
    clears = np.concatenate([rng.choice(own, max(1, len(own) // 8), replace=False),
                             np.setdiff1d(rng.choice(cap, 64, replace=False), own),
                             cap + width + np.arange(5)]).astype(np.int32)
    return [slot.astype(np.int32)] + cols, clears[rng.permutation(len(clears))]


def apply_batch_bound_ms(np, cols, clears, cap: int) -> float:
    """Least time for one K17 launch: per lane its 60 B of fields read and
    28 B of answers written; per in-range lane 48 B of state read and 48 B
    written; per clear its slot read, per in-range clear a meta word read
    and written (12 B)."""
    slot = cols[0].astype(np.int64)
    n = int(((slot >= 0) & (slot < cap)).sum())
    c = clears.astype(np.int64)
    n_clear = int(((c >= 0) & (c < cap)).sum())
    return (len(slot) * 88 + n * 96 + len(c) * 4 + n_clear * 8) / HBM_BYTES_PER_S * 1e3


def batch_on(torch, cols, dev):
    from gubernator_tpu_torch.ops import BatchInput

    return BatchInput(*(torch.from_numpy(np_c).to(dev) for np_c in cols))


def hold_apply_batch(torch, np, errs, kern, plain, k1, cap: int, cols, clears, now: int,
                     what: str) -> None:
    """K17 on `kern` against its plain version on `plain` (answers and the
    12 columns equal), and the same lanes packed, sorted by slot, through
    K1 on `k1` (the clears in its round): its answers for the in-range
    lanes and every state word equal K17's."""
    from gubernator_tpu_torch.ops import apply_batch
    from gubernator_tpu_torch.ops import bucket_kernel as tk
    from gubernator_tpu_torch.ops import fused_step as fs

    batch = batch_on(torch, cols, "cuda")
    dcl = torch.from_numpy(clears).cuda()
    got = apply_batch(kern, batch, dcl, now)
    want = tk.apply_batch_reference(plain, batch, dcl, now)
    torch.cuda.synchronize()
    err = compare_states(torch, kern, plain)
    for a, b in zip(got, want):
        if not torch.equal(a, b):
            err = max(err, int((a.long() - b.long()).abs().max().item()))
    errs["apply_batch"] = max(errs["apply_batch"], err)
    check(err == 0, f"[k17] {what}: K17 differs from its plain version, err {err}")
    slot = cols[0]
    live = np.nonzero(slot < cap)[0]
    order = live[np.argsort(slot[live], kind="stable")]
    packed = tk.pack_rounds_host(now, cap, [len(order)], slot[order], [c[order] for c in cols[1:]],
                                 [clears[(clears >= 0) & (clears < cap)]])
    pout = fs.multi_fused_step(k1, *on_device(torch, packed), widest=packed.widest)
    st, rem, rst = tk.unpack_out_host(pout.cpu().numpy(), len(order))
    g = [t.cpu().numpy()[order] for t in (got.status, got.remaining, got.reset_time)]
    check(np.array_equal(st, g[0]) and np.array_equal(rem, g[1]) and np.array_equal(rst, g[2]),
          f"[k17] {what}: K1 on the same lanes, sorted, answers otherwise")
    check(compare_states(torch, kern, k1) == 0, f"[k17] {what}: K1's state words differ")


def phase_apply_batch_kernels(torch, np, rng, errs):
    """K17 against its plain version and against K1 on the card, at caps
    2^20 and 10^8 (one random state a cap): batches of 64, 1000 (padded to
    1024) and 8192 lanes in random order with clears on their own slots
    and on others, a mostly-padding batch, and the extreme values; then
    the extreme batch on saturating buckets."""
    from gubernator_tpu_torch.ops import bucket_kernel as tk

    for cap in (CAP_SERVE, CAP_NORTH_STAR):
        kern = random_state(torch, cap, NOW0, int(rng.integers(2**31)))
        plain, k1 = copy_state(kern), copy_state(kern)
        now = NOW0
        cases = [(w, m, False) for w, m in APPLY_WIDTHS] + [(1024, 102, False), (1024, 1000, True)]
        for width, m, extreme in cases:
            now += int(rng.integers(0, 3_000))
            cols, clears = apply_batch_case(np, rng, cap, width, m, now, extreme=extreme)
            hold_apply_batch(torch, np, errs, kern, plain, k1, cap, cols, clears, now,
                             f"cap {cap}, {m} of {width} lanes{' (extreme)' if extreme else ''}")
        log(f"[k17] cap {cap}: unsorted batches of 58/64, 1000/1024 and 7372/8192 lanes, a "
            "mostly-padding batch (102 of 1024) and the extreme values, with clears of their own "
            "slots and of others: bit-equal to apply_batch_reference and to K1 on the same lanes "
            "sorted (tolerance: exact)")
        del kern, plain, k1
        torch.cuda.empty_cache()
    cap = 4096
    words = extreme_state_words(np, cap, NOW0)
    kern, plain, k1 = (tk.state_from_numpy(words, "cuda") for _ in range(3))
    for step in range(3):
        now = NOW0 + 997 * step
        cols, clears = apply_batch_case(np, rng, cap, 64, 48, now, extreme=True)
        hold_apply_batch(torch, np, errs, kern, plain, k1, cap, cols, clears, now,
                         f"extreme batch on saturating buckets, step {step}")
    log("[k17] the extreme batch on saturating buckets, three steps: bit-equal")


def apply_batch_stream(np, rng, n: int, now: int):
    """The apply_batch path's batches: 1000 distinct keys of a
    200,000-key pool a batch (padded to 1024), each key on its own slot of
    2^20, and from the fifth batch on a few keys of each batch evicted:
    their slots cleared in the batch that reuses them for new keys.
    Yields (columns, clears, now)."""
    slot_of: dict = {}
    free = list(range(CAP_SERVE - 1, -1, -1))
    for b in range(n):
        keys = rng.choice(APPLY_POOL, BATCH, replace=False).tolist()
        clears = []
        if b >= 4:
            olds = [k for k in list(slot_of)[:200] if k not in keys][:40]
            for k in olds:
                s = slot_of.pop(k)
                clears.append(s)
                free.append(s)
        slots = []
        for k in keys:
            if k not in slot_of:
                slot_of[k] = free.pop()
            slots.append(slot_of[k])
        cols, _c = apply_batch_case(np, rng, CAP_SERVE, 1024, BATCH, now)
        slot = np.full(1024, 0, np.int64)
        real = np.nonzero(cols[0] < CAP_SERVE)[0]
        slot[real] = slots
        pad = np.setdiff1d(np.arange(1024), real)
        slot[pad] = CAP_SERVE + pad
        cols[0] = slot.astype(np.int32)
        yield cols, np.asarray(clears + [CAP_SERVE + 9], np.int32), now
        now += int(rng.integers(0, 2_000))


def phase_apply_batch_path(torch, np, rng):
    """The public dataclass step, `gubernator_tpu_torch.ops.apply_batch`,
    on a 2^20-slot state on the card and one on the CPU: the same
    APPLY_BATCHES batches of 1000 (padded to 1024, lanes unsorted, each
    from the fifth on clearing evicted slots that the batch reuses):
    answers equal batch by batch, state words equal at the end.  Returns
    the card state's batches run."""
    from gubernator_tpu_torch import ops
    from gubernator_tpu_torch.ops import bucket_kernel as tk

    card, cpu = ops.make_state(CAP_SERVE, "cuda"), ops.make_state(CAP_SERVE, "cpu")
    n = 0
    for b, (cols, clears, now) in enumerate(apply_batch_stream(np, rng, APPLY_BATCHES, NOW0)):
        got = ops.apply_batch(card, batch_on(torch, cols, "cuda"),
                              torch.from_numpy(clears).cuda(), now)
        want = ops.apply_batch(cpu, batch_on(torch, cols, "cpu"), torch.from_numpy(clears), now)
        for name, a, w in zip(ops.BatchOutput._fields, got, want):
            check(torch.equal(a.cpu(), w), f"[apply_batch] batch {b}: {name} differs")
        n += 1
    wa, wb = tk.state_to_numpy(card), tk.state_to_numpy(cpu)
    for f in wa:
        check(np.array_equal(wa[f], wb[f]), f"[apply_batch] state column {f} differs")
    log(f"[apply_batch] {n} batches of {BATCH} (padded to 1024, unsorted, evicted slots cleared "
        f"and reused in the same batch) through ops.apply_batch on {CAP_SERVE} slots, card and "
        "CPU: answers and state words equal")
    return n


def time_apply_batch(torch, np, rng, card) -> tuple:
    """K17 on the path's shape (cap 2^20, 1000 lanes padded to 1024, 41
    clears) beside its plain version and its bound: (ms, plain ms, bound
    ms)."""
    from gubernator_tpu_torch.ops import apply_batch
    from gubernator_tpu_torch.ops import bucket_kernel as tk

    state = random_state(torch, CAP_SERVE, NOW0, int(rng.integers(2**31)))
    cases = []
    for k in range(8):
        cols, clears = apply_batch_case(np, rng, CAP_SERVE, 1024, BATCH, NOW0 + k)
        cases.append((batch_on(torch, cols, "cuda"), torch.from_numpy(clears[:41]).cuda(),
                      NOW0 + k, apply_batch_bound_ms(np, cols, clears[:41], CAP_SERVE)))
    ms = device_ms(torch, lambda i: apply_batch(state, *cases[i % 8][:3]), 200)
    plain = host_ms(torch, lambda i: tk.apply_batch_reference(state, *cases[i % 8][:3]), 5)
    bound = statistics.median(c[3] for c in cases)
    log(f"[time] K17 on 1000 lanes (padded to 1024) with 41 clears at 2^20: {ms * 1e3:.2f} us, "
        f"plain {plain:.3f} ms, bound {bound * 1e3:.4f} us | {card}")
    del state
    torch.cuda.empty_cache()
    return ms, plain, bound


# ---------------------------------------------------------------------------
# The obs path: single-node observability on the card


OBS_MIXED_RPCS = 16  # the mixed stream's RPCs of 1000, each way
OBS_ZIPF_RPCS = 4  # the zipf stream's RPCs of 8192
OBS_RATE_RPCS = 200  # timed RPCs a reading of the off / on rates, after 5 untimed
OBS_KNOBS = ("GUBER_TRACING", "GUBER_NATIVE_EVENTS", "GUBER_HOTKEYS", "GUBER_OBS")


def has_obs() -> bool:
    """The driven port has the debug routes and tracing (a --tree
    checkout from before their slice has not)."""
    return importlib.util.find_spec("gubernator_tpu_torch.utils.tracing") is not None


def span_trees(spans) -> list:
    """Finished spans grouped by trace, in order of each trace's first
    span: [[(name, parent name, attributes)] a trace]."""
    order, by = [], {}
    for s in spans:
        if s.trace_id not in by:
            order.append(s.trace_id)
            by[s.trace_id] = []
        by[s.trace_id].append((s.name, s.parent, dict(s.attributes)))
    return [by[t] for t in order]


def obs_items(np, rng, tag: str, n: int) -> list:
    """One batch of the main path's streams as h2 / HTTP items: mixed
    (`stream_columns` over a 200,000-key pool with hot keys, Gregorian
    durations left out: the h2 front declines them) or zipf
    (`zipf_columns`)."""
    if tag == "zipf":
        keys, cols = zipf_columns(np, rng, n)
    else:
        pool = [b"api_k%d" % i for i in range(0, 200_000, 7)]
        hot = [b"api_hot%d" % i for i in range(50)]
        keys, cols = stream_columns(np, rng, pool, hot, n, greg_share=0.0)
    algo, beh, hits, limit, dur, burst = cols
    out = []
    for j, k in enumerate(keys):
        name, _, uk = k.decode().partition("_")
        out.append((name, uk, int(hits[j]), int(limit[j]), int(dur[j]), int(algo[j]),
                    int(beh[j]), int(burst[j])))
    return out


def http_json(url: str, items=None):
    """GET (items None) or POST /v1/GetRateLimits; the body's bytes."""
    if items is None:
        with urllib.request.urlopen(url, timeout=60) as r:
            return r.read()
    body = json.dumps({"requests": [dict(zip(
        ("name", "unique_key", "hits", "limit", "duration", "algorithm", "behavior", "burst"),
        it)) for it in items]}).encode()
    with urllib.request.urlopen(urllib.request.Request(url, data=body, method="POST"),
                                timeout=60) as r:
        return r.read()


def obs_daemon(cap: int, device: str):
    from gubernator_tpu_torch.clock import Clock
    from gubernator_tpu_torch.config import DaemonConfig
    from gubernator_tpu_torch.daemon import spawn_daemon

    return spawn_daemon(DaemonConfig(http_listen_address="127.0.0.1:0", cache_size=cap,
                                     sweep_interval=0.0, h2_fast_address="127.0.0.1:0",
                                     **ledger_kw(ledger_settle_interval=0.0)),
                        clock=Clock().freeze_at(NOW0 * 1_000_000), device=device)


def obs_parity(torch, np, rng, tag: str, cap: int, n_rpcs: int, width: int, tracer):
    """A card daemon and its CPU twin (both with the in-memory tracer,
    the tail recorder at threshold 0, the event ring, the hot-key sketch
    and the SLO watchdog; frozen clocks; the ledger without its settle
    thread) answer the same stream: each batch's 1000-item slices over
    the h2 front and over HTTP (the dataclass path).  Answers
    equal, span trees equal trace by trace, state words equal after both
    settle.  Returns (card daemon, still serving; its stream's items)."""
    d, twin = obs_daemon(cap, "cuda"), obs_daemon(cap, "cpu")
    card_c = twin_c = None
    sent = []
    try:
        card_c, twin_c = H2Unary(d.h2_fast_address), H2Unary(twin.h2_fast_address)
        n_traces = 0
        for r in range(n_rpcs):
            items = obs_items(np, rng, tag, width)
            # The fronts take at most 1000 items an RPC (the reference's
            # cap): a batch goes as its 1000-item slices, each over both.
            for lo in range(0, width, BATCH):
                part = items[lo : lo + BATCH]
                body = encode_get_rate_limits(part)
                sent.extend(part + part)
                for route in ("h2", "HTTP"):
                    outs, trees = [], []
                    for client, daemon in ((card_c, d), (twin_c, twin)):
                        mark = len(tracer.finished)
                        if route == "h2":
                            outs.append(client.call(body))
                        else:
                            outs.append(http_json(
                                f"http://{daemon.http_address}/v1/GetRateLimits", part))
                        trees.append(span_trees(list(tracer.finished)[mark:]))
                    check(outs[0] == outs[1] and (route == "HTTP" or outs[0][0] == 0),
                          f"[obs {tag}] batch {r}, items {lo}- over {route}: the card's answer "
                          "differs from the CPU twin's, or is not OK")
                    check(trees[0] == trees[1], f"[obs {tag}] batch {r}, items {lo}- over "
                          f"{route}: span trees differ: card {trees[0]}, CPU {trees[1]}")
                    check(route == "h2" or trees[0], f"[obs {tag}] batch {r}: no HTTP trace")
                    n_traces += len(trees[0])
            step = int(rng.choice([0, 250, 1000]))
            for x in (d, twin):
                x.clock.advance(ms=step)
        if has_ledger():
            check(d.instance.ledger.flush_settles() == twin.instance.ledger.flush_settles(),
                  f"[obs {tag}] the ledgers settled different row counts")
        same_engines(np, d.instance.engine, twin.instance.engine, "card vs CPU twin",
                     slots=True, path=f"obs {tag}")
        log(f"[obs {tag}] {n_rpcs} batches of {width} (RPCs of {BATCH}) over h2 and HTTP to the "
            f"card daemon and its CPU twin: answers equal, {n_traces} traces with equal span "
            f"trees (names, nesting, attributes), state words of {cap} slots equal")
        return d, sent
    except BaseException:
        d.close()
        raise
    finally:
        for c in (card_c, twin_c):
            if c is not None:
                c.close()
        twin.close()


def check_debug_routes(d, tag: str, items, card) -> dict:
    """The card daemon's routes: /debug/vars with the stage budget
    (engine_serve, device.step, device.readback counted, with quantiles)
    and the event ring's reactor and feeder stages; /debug/trace with
    trees under service.get_rate_limits with engine.* children;
    /debug/hotkeys, whose top 5 hold the zipf stream's 3 hottest keys (by
    the hits sent); /debug/slo's status."""
    url = f"http://{d.http_address}"
    want_stages = ("reactor_wake", "reactor_read", "feeder_pack", "feeder_ring_wait",
                   "feeder_serve")
    deadline = time.perf_counter() + 10
    while True:
        v = json.loads(http_json(url + "/debug/vars"))
        ev = v.get("native_events", {}).get("stages", {})
        if all(ev.get(s, {}).get("count", 0) > 0 for s in want_stages) \
                or time.perf_counter() > deadline:
            break
        time.sleep(0.05)
    budget = v["stage_budget"]
    for stage in ("engine_serve", "device.step", "device.readback"):
        q = budget[stage]
        check(q["count"] >= 1 and {"p50_ms", "p99_ms", "max_ms", "mean_ms"} <= set(q),
              f"[obs {tag}] /debug/vars stage {stage}: {q}")
    for s in want_stages:
        check(ev.get(s, {}).get("count", 0) > 0, f"[obs {tag}] the event ring's {s}: {ev}")
    tr = json.loads(http_json(url + "/debug/trace"))
    trees = [t for t in tr["traces"] if t["root"] == "service.get_rate_limits"
             and any(s["name"].startswith("engine.") for s in t["spans"])]
    check(tr["enabled"] and trees, f"[obs {tag}] /debug/trace has no service tree")
    hk = json.loads(http_json(url + "/debug/hotkeys"))
    counts: dict = {}
    for it in items:
        k = f"{it[0]}_{it[1]}"
        counts[k] = counts.get(k, 0) + max(it[2], 1)
    hottest = sorted(counts, key=counts.get, reverse=True)[:3]
    top = [r["key"] for r in hk["top"][:5]]
    check(hk["enabled"] and (tag != "zipf" or set(hottest) <= set(top)),
          f"[obs {tag}] /debug/hotkeys: top {top}, the stream's hottest {hottest}")
    slo = json.loads(http_json(url + "/debug/slo"))
    check(slo["enabled"] and {"pairs", "slis", "burn", "headroom", "breaches", "samples"}
          <= set(slo), f"[obs {tag}] /debug/slo: {sorted(slo)}")
    log(f"[obs {tag}] /debug/vars: " + "; ".join(
        f"{s} n={budget[s]['count']} p50 {budget[s]['p50_ms']} ms p99 {budget[s]['p99_ms']} ms"
        for s in ("engine_serve", "device.step", "device.readback", "device.window_wait"))
        + "; ring " + ", ".join(f"{s} n={ev[s]['count']} p99 {ev[s]['p99_ms']} ms"
                                for s in want_stages)
        + f" | /debug/trace {tr['recorded']} recorded, {len(trees)} service trees kept; "
        f"/debug/hotkeys top {hk['top'][0]}; /debug/slo {slo['samples']} samples, "
        f"{len(slo['breaches'])} breaches | {card}")
    return v


def phase_obs(torch, np, rng, card):
    """The obs path: GUBER_TRACING=memory with a tail threshold of 0, the
    event ring, the hot-key sketch and the SLO watchdog on; the mixed
    stream (2^20 slots, batches of 1000) and the zipf stream (2^24 slots,
    batches of 8192, in RPCs of 1000) through the daemon's HTTP gateway and
    h2 front, each against a CPU twin; then the debug routes read from the
    card.
    Returns the card engines."""
    from gubernator_tpu_torch.utils import tracing

    engines = []
    with engine_env(GUBER_TRACING="memory", GUBER_TRACE_TAIL_FACTOR="0",
                    GUBER_TRACE_TAIL_MIN_MS="0", GUBER_TRACE_TAIL_CAP="4096",
                    GUBER_NATIVE_EVENTS="1", GUBER_HOTKEYS="1", GUBER_OBS="1",
                    GUBER_SLO_INTERVAL="0.2", GUBER_NATIVE_FEEDER="1"):
        tracing.shutdown_tracing()
        check(tracing.init_tracing(), "[obs] GUBER_TRACING=memory did not start a tracer")
        tracer = tracing.current_tracer()
        try:
            for tag, cap, n, width in (("mixed", CAP_SERVE, OBS_MIXED_RPCS, BATCH),
                                       ("zipf", ZIPF_CAP, OBS_ZIPF_RPCS, ZIPF_BATCH)):
                d, items = obs_parity(torch, np, rng, tag, cap, n, width, tracer)
                try:
                    check_debug_routes(d, tag, items, card)
                    engines.append(d.instance.engine)
                finally:
                    d.close()
        finally:
            tracing.shutdown_tracing()
    return engines


def obs_rates(torch, np, rng, card) -> dict:
    """Decisions/s of the card daemon's h2 front on the mixed stream (RPCs
    of 1000, frozen clock, the ledger on) with each knob off and on, the
    others at the daemon's defaults (tracing off; the ring, the sketch and
    the watchdog on): a fresh daemon a reading, 5 RPCs untimed, then
    OBS_RATE_RPCS timed; turns off, on, on, off.  Tracing on is
    GUBER_TRACING=memory with the recorder's default tail thresholds."""
    from gubernator_tpu_torch.utils import tracing

    stream = [encode_get_rate_limits(obs_items(np, rng, "mixed", BATCH))
              for _ in range(OBS_RATE_RPCS + 5)]
    out = {}
    for knob in OBS_KNOBS:
        vals = {"off": "0", "on": "1"} if knob != "GUBER_TRACING" else {"off": None,
                                                                      "on": "memory"}
        rates = {"off": [], "on": []}
        for turn in ("off", "on", "on", "off"):
            with engine_env(**{knob: vals[turn]}):
                tracing.shutdown_tracing()
                tracing.init_tracing()
                d = obs_daemon(CAP_SERVE, "cuda")
                c = None
                try:
                    c = H2Unary(d.h2_fast_address)
                    for r, body in enumerate(stream):
                        if r == 5:
                            torch.cuda.synchronize()
                            t = time.perf_counter()
                        st, _msg = c.call(body)
                        check(st == 0, f"[obs rates] {knob} {turn}: RPC {r} status {st}")
                        d.clock.advance(ms=250)
                    rates[turn].append(OBS_RATE_RPCS * BATCH / (time.perf_counter() - t))
                finally:
                    if c is not None:
                        c.close()
                    d.close()
                    tracing.shutdown_tracing()
        out[knob] = rates
        log(f"[obs rates] {knob} off / on: "
            f"{' '.join(f'{x:.0f}' for x in rates['off'])} / "
            f"{' '.join(f'{x:.0f}' for x in rates['on'])} decisions/s "
            f"(h2, {OBS_RATE_RPCS} RPCs of {BATCH}, turns off, on, on, off) | {card}")
    return out



# ---------------------------------------------------------------------------
# The metrics path: /metrics and the status listener, card against its CPU
# twin.

METRICS_MIXED_RPCS = 8  # the mixed stream's RPCs of 1000, each way
METRICS_ZIPF_RPCS = 2  # the zipf stream's batches of 8192, in RPCs of 1000
METRICS_SCRAPES = 100  # timed scrapes of /metrics on the card daemon
METRICS_PATHS = ("/metrics", "/metrics?exemplars=1", "/metrics?fleet=1")

# Samples compared by presence only between the card and its twin, each
# by name: what holds a time, or counts observations of a timed stage
# whose grouping follows the host's timing.
#  - every `_sum` (the summaries and the stage histogram sum seconds);
#  - gubernator_stage_quantile_seconds, gubernator_stage_seconds_bucket,
#    gubernator_stage_duration_count, gubernator_stage_seconds_count: the
#    stage timers (the card's pump groups launches, the CPU twin's does
#    not queue; the h2 window's serve count follows arrivals);
#  - gubernator_engine_round_duration_count: device.step's count;
#  - gubernator_native_*, and the rollup's event count
#    (gubernator_fleet_counter_total{counter="native_events"}): the event
#    ring, whose reactor and feeder events follow the host's timing;
#  - gubernator_slo_burn_rate: sampled by the watchdog's own ticks;
#  - gubernator_fleet_stage_quantile_seconds: the merged stage quantiles;
#  - process_* and python_gc_*: the process's own values.
METRICS_TIME_VALUED = (
    "gubernator_stage_quantile_seconds", "gubernator_stage_seconds_bucket",
    "gubernator_stage_duration_count", "gubernator_stage_seconds_count",
    "gubernator_engine_round_duration_count", "gubernator_native_",
    "gubernator_slo_burn_rate", "gubernator_fleet_stage_quantile_seconds", "process_",
    "python_gc_")


def has_metrics() -> bool:
    """The driven port serves /metrics (a --tree checkout from before its
    slice does not)."""
    return importlib.util.find_spec("gubernator_tpu_torch.utils.exposition") is not None


def parse_exposition(text: str) -> list:
    """Prometheus text 0.0.4 or OpenMetrics: [(family, HELP, TYPE,
    [(sample, labels, value, has exemplar)])] in order."""
    import re

    sample_re = re.compile(r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(.*?)\})? (\S+)( # \{.*)?$')
    label_re = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')
    fams = []
    for line in text.splitlines():
        if line.startswith("# HELP "):
            name, _, doc = line[7:].partition(" ")
            fams.append([name, doc, None, []])
        elif line.startswith("# TYPE "):
            fams[-1][2] = line.split()[3]
        elif line and not line.startswith("#"):
            m = sample_re.match(line)
            check(m is not None and fams, f"[metrics] unparsable line {line!r}")
            fams[-1][3].append((m.group(1), tuple(sorted(label_re.findall(m.group(2) or ""))),
                                m.group(3), m.group(4) is not None))
    return fams


def metrics_daemon(cap: int, device: str):
    from gubernator_tpu_torch.clock import Clock
    from gubernator_tpu_torch.config import DaemonConfig
    from gubernator_tpu_torch.daemon import spawn_daemon

    return spawn_daemon(DaemonConfig(http_listen_address="127.0.0.1:0", cache_size=cap,
                                     sweep_interval=0.0, h2_fast_address="127.0.0.1:0",
                                     http_status_listen_address="127.0.0.1:0",
                                     metric_flags=["all"], ledger_settle_interval=0.0),
                        clock=Clock().freeze_at(NOW0 * 1_000_000), device=device)


def scrape(fs, address: str, path: str) -> str:
    """One scrape; the kernel launch counts must read the same after it."""
    before = (dict(fs.launches), dict(getattr(fs, "split_launches", {})))
    body = http_json(f"http://{address}{path}").decode()
    check((dict(fs.launches), dict(getattr(fs, "split_launches", {}))) == before,
          f"[metrics] a scrape of {path} on {address} launched a kernel")
    return body


def same_scrape(card_text: str, twin_text: str, tag: str, addrs) -> int:
    """The card's scrape against its twin's: every family, HELP, TYPE and
    label set equal, and every value but those of METRICS_TIME_VALUED
    (and the node's own address in a peer label).  Returns the samples
    compared by value."""
    got, want = parse_exposition(card_text), parse_exposition(twin_text)
    check([f[:3] for f in got] == [f[:3] for f in want],
          f"[metrics {tag}] families differ: card {[f[0] for f in got]}, "
          f"twin {[f[0] for f in want]}")
    own = {addrs[0]: "self", addrs[1]: "self"}
    compared = 0
    for (name, _, _, g), (_, _, _, w) in zip(got, want):
        g = [(s, tuple((k, own.get(v, v)) for k, v in lab), v, e) for s, lab, v, e in g]
        w = [(s, tuple((k, own.get(v, v)) for k, v in lab), v, e) for s, lab, v, e in w]
        check([x[:2] for x in g] == [x[:2] for x in w],
              f"[metrics {tag}] {name}: label sets differ: card {[x[:2] for x in g]}, "
              f"twin {[x[:2] for x in w]}")
        for (sname, lab, gv, _), (_, _, wv, _) in zip(g, w):
            if sname.endswith("_sum") or sname.startswith(METRICS_TIME_VALUED) \
                    or ("counter", "native_events") in lab:
                continue
            compared += 1
            check(gv == wv, f"[metrics {tag}] {sname}{dict(lab)}: card {gv}, twin {wv}")
    return compared


def phase_metrics(torch, np, rng, card):
    """The metrics path: a card daemon and its CPU twin (status listener
    on 127.0.0.1:0, GUBER_METRIC_FLAGS=all, GUBER_OBS on, the h2 front,
    frozen clocks) answer the mixed stream (2^20 slots, batches of 1000)
    and the zipf stream (2^24 slots, batches of 8192 in RPCs of 1000) over
    HTTP and h2, answers equal; then /metrics, ?exemplars=1 and ?fleet=1
    are scraped on both listeners of both daemons, launching no kernel:
    the card's text equals the twin's (`same_scrape`), both listeners give
    the same families, and the OpenMetrics text ends in one # EOF.  Then
    METRICS_SCRAPES timed scrapes of the card's /metrics.  Returns the
    card engines."""
    from gubernator_tpu_torch.ops import fused_step as fs

    engines, lat = [], []
    families = samples = compared = 0
    t_phase = time.perf_counter()
    with engine_env(GUBER_OBS="1", GUBER_HOTKEYS="1", GUBER_NATIVE_EVENTS="1"):
        for tag, cap, n, width in (("mixed", CAP_SERVE, METRICS_MIXED_RPCS, BATCH),
                                   ("zipf", ZIPF_CAP, METRICS_ZIPF_RPCS, ZIPF_BATCH)):
            d, twin = metrics_daemon(cap, "cuda"), metrics_daemon(cap, "cpu")
            try:
                clients = [H2Unary(d.h2_fast_address), H2Unary(twin.h2_fast_address)]
                try:
                    for r in range(n):
                        items = obs_items(np, rng, tag, width)
                        for lo in range(0, width, BATCH):
                            part = items[lo : lo + BATCH]
                            body = encode_get_rate_limits(part)
                            outs = [c.call(body) for c in clients]
                            check(outs[0] == outs[1] and outs[0][0] == 0,
                                  f"[metrics {tag}] batch {r}, items {lo}- over h2: the card's "
                                  "answer differs from the CPU twin's, or is not OK")
                            outs = [http_json(f"http://{x.http_address}/v1/GetRateLimits", part)
                                    for x in (d, twin)]
                            check(outs[0] == outs[1], f"[metrics {tag}] batch {r}, items {lo}- "
                                  "over HTTP: the card's answer differs from the CPU twin's")
                        step = int(rng.choice([0, 250, 1000]))
                        for x in (d, twin):
                            x.clock.advance(ms=step)
                finally:
                    for c in clients:
                        c.close()
                for x in (d, twin):
                    if x.instance.ledger is not None:
                        x.instance.ledger.flush_settles()
                    # The closed clients' connections leave the open count
                    # (gubernator_h2_conns) before the scrapes.
                    deadline = time.perf_counter() + 10
                    while x.h2_fast.conn_stats()["conns_open"] and \
                            time.perf_counter() < deadline:
                        time.sleep(0.01)
                addrs = (d.http_address, twin.http_address)
                for path in METRICS_PATHS:
                    texts = {}
                    for name, x in (("card", d), ("twin", twin)):
                        for listener, address in (("main", x.http_address),
                                                  ("status", x.status_gateway.address)):
                            texts[name, listener] = scrape(fs, address, path)
                    fams = {k: [f[:3] for f in parse_exposition(v)] for k, v in texts.items()}
                    check(fams["card", "main"] == fams["card", "status"]
                          == fams["twin", "status"], f"[metrics {tag}] {path}: the listeners "
                          "give different families")
                    compared += same_scrape(texts["card", "main"], texts["twin", "main"],
                                            f"{tag} {path}", addrs)
                    if "exemplars" in path:
                        check(texts["card", "main"].endswith("# EOF\n")
                              and texts["card", "main"].count("# EOF") == 1,
                              f"[metrics {tag}] {path}: not one # EOF at the end")
                    if "fleet" in path:
                        check("gubernator_fleet_scrape" in texts["card", "main"],
                              f"[metrics {tag}] {path}: no fleet families")
                    if path == "/metrics":
                        got = parse_exposition(texts["card", "main"])
                        families, samples = len(got), sum(len(f[3]) for f in got)
                        have = {f[0] for f in got}
                        for fam in ("gubernator_check_counter_total", "gubernator_h2_conns",
                                    "gubernator_native_events_total", "gubernator_slo_burn_rate",
                                    "process_resident_memory_bytes", "python_info",
                                    "gubernator_grpc_request_duration"):
                            check(fam in have, f"[metrics {tag}] /metrics lacks {fam}")
                        checks = [s for f in got if f[0] == "gubernator_check_counter_total"
                                  for s in f[3]]
                        check(float(checks[0][2]) > 0,
                              f"[metrics {tag}] gubernator_check_counter_total {checks}")
                if tag == "mixed":
                    for _ in range(METRICS_SCRAPES):
                        t = time.perf_counter()
                        scrape(fs, d.http_address, "/metrics")
                        lat.append(time.perf_counter() - t)
                engines.append(d.instance.engine)
            finally:
                d.close()
                twin.close()
    p50, p99 = latency_stats(np, lat)[:2]
    log(f"[metrics] families {families}, samples {samples} (zipf daemon's /metrics), "
        f"{compared} samples equal card vs CPU twin over {len(METRICS_PATHS)} paths x 2 streams, "
        f"scrape p50 / p99 {p50:.3f} / {p99:.3f} ms ({METRICS_SCRAPES} scrapes of the mixed "
        f"daemon's /metrics), phase wall {time.perf_counter() - t_phase:.1f} s | {card}")
    return engines


# ---------------------------------------------------------------------------
# The cluster path: two port daemons with static peers (cluster/harness.py),
# each key's owner answering it and the other node forwarding to it over the
# port's own gRPC wire (the routing listener and the unary client).

CLUSTER_RPCS = (("mixed", 12), ("zipf", 12), ("uniform", 6))  # RPCs of 1000 a stream
CLUSTER_HTTP_RPCS = 3  # mixed RPCs of 1000 through each cluster's HTTP gateway
CLUSTER_TIMED_RPCS = 60  # timed forwarded RPCs of 1000 (every key the other node's)


def has_cluster() -> bool:
    """The driven port has the cluster harness and the gRPC listener (a
    --tree checkout from before their slice has not)."""
    return importlib.util.find_spec("gubernator_tpu_torch.cluster.harness") is not None


def cluster_items(np, rng, tag: str, n: int = BATCH) -> list:
    """One RPC's items (name, key, hits, limit, duration, algorithm,
    behavior, burst): the mixed stream with its Gregorian items (the
    listener's full decode takes them), the zipf stream, or n distinct
    keys sharing one config (the uniform format, on the owner that a
    forwarded half reaches as one GetPeerRateLimits)."""
    if tag == "zipf":
        keys, cols = zipf_columns(np, rng, n)
    elif tag == "uniform":
        keys, cols = uniform_columns(np, rng, [b"api_u%d" % i for i in range(200_000)], n)
    else:
        pool = [b"api_k%d" % i for i in range(0, 200_000, 7)]
        hot = [b"api_hot%d" % i for i in range(50)]
        keys, cols = stream_columns(np, rng, pool, hot, n)
    algo, beh, hits, limit, dur, burst = cols
    out = []
    for j, k in enumerate(keys):
        name, _, uk = k.decode().partition("_")
        # Three constant bytes after the key's varying digits: the ring's
        # FNV-1 moves little for a change in the last bytes, so keys that
        # differ only there (bench_k0, bench_k1, ...) would share an owner.
        out.append((name, uk + "_cl", int(hits[j]), int(limit[j]), int(dur[j]), int(algo[j]),
                    int(beh[j]), int(burst[j])))
    return out


def count_by_engine(engines):
    """Count the K1 / K3 / K4 calls of each engine (the engine module's
    entry points wrapped: each call of them is one launch on a card
    state).  Returns the counts, one dict an engine, and the undo."""
    import gubernator_tpu_torch.core.engine as em

    counts = [{"fused_step": 0, "collapsed_step": 0, "uniform_step": 0} for _ in engines]
    lock = threading.Lock()

    def wrap(fn, name):
        def call(state, *a, **kw):
            out = fn(state, *a, **kw)
            with lock:
                for i, e in enumerate(engines):
                    if e._state is state:
                        counts[i][name] += 1
            return out
        return call

    saved = {n: getattr(em, n) for n in ("collapsed_step", "multi_fused_step",
                                         "multi_uniform_step")}
    em.collapsed_step = wrap(saved["collapsed_step"], "collapsed_step")
    em.multi_fused_step = wrap(saved["multi_fused_step"], "fused_step")
    em.multi_uniform_step = wrap(saved["multi_uniform_step"], "uniform_step")

    def undo():
        for n, fn in saved.items():
            setattr(em, n, fn)

    return counts, undo


def cluster_answers(resps, owners, receiver: int) -> list:
    """Each answer as (status, limit, remaining, reset, error, metadata
    with the owner's address as its node index)."""
    out = []
    for r in resps:
        md = dict(r.metadata)
        if "owner" in md:
            md["owner"] = owners.index(md["owner"]) if md["owner"] in owners else md["owner"]
        out.append((int(r.status), r.limit, r.remaining, r.reset_time, r.error, md))
    return out


def ring_owner_md(inst, reqs, addrs, receiver: int) -> list:
    """The metadata each answer must carry: the owner's node index where
    the cluster's own ring names another node than the receiver."""
    out = []
    for r in reqs:
        if not (r.name and r.unique_key):
            out.append({})
            continue
        o = addrs.index(inst.get_peer(r.hash_key()).info.grpc_address)
        out.append({} if o == receiver else {"owner": o})
    return out


def phase_cluster(torch, np, rng, card):
    """The cluster path: two card daemons (2^20 slots each, the routing
    listener, frozen clocks) and a CPU twin cluster built the same way
    take one seeded stream of 1000-item RPCs (mixed, zipf, uniform) sent
    alternately to node 0 and node 1 through the port's unary client, and
    a few through each node's HTTP gateway.  The card's answers equal the
    twin's item for item; `metadata.owner` is the node the cluster's own
    ring names.  Forwarded items and GetPeerRateLimits RPCs must be > 0
    on both nodes, and so must K1 / K3 / K4 launches on each card node.
    Then CLUSTER_TIMED_RPCS forwarded RPCs are timed; last, node 1 is
    stopped in both clusters and one of its keys sent to node 0 is
    answered degraded, and with the reference's error once degraded mode
    is off.  Returns the card engines, each node's K1 / K3 / K4 counts
    and the readings."""
    from dataclasses import replace as dc_replace

    from gubernator_tpu_torch.clock import Clock
    from gubernator_tpu_torch.cluster.harness import ClusterHarness
    from gubernator_tpu_torch.core.h2_client import UnaryChannel
    from gubernator_tpu_torch.net import proto_codec as pc
    from gubernator_tpu_torch.types import RateLimitReq

    t_phase = time.perf_counter()
    clusters = {}
    counts = undo = None
    try:
        for dev in ("cuda", "cpu"):
            clusters[dev] = ClusterHarness().start(
                2, clock=Clock().freeze_at(NOW0 * 1_000_000), cache_size=CAP_SERVE,
                device=dev, sweep_interval=0.0, **ledger_kw(ledger_settle_interval=0.0))
        card_c, twin_c = clusters["cuda"], clusters["cpu"]
        engines = [d.instance.engine for d in card_c.daemons]
        counts, undo = count_by_engine(engines)
        addrs = {dev: [d.grpc_address for d in h.daemons] for dev, h in clusters.items()}
        chans = {dev: [UnaryChannel(a) for a in addrs[dev]] for dev in clusters}
        n_items = 0
        try:
            stream = [(tag, i) for tag, n in CLUSTER_RPCS for i in range(n)]
            for r, (tag, i) in enumerate(stream):
                items = cluster_items(np, rng, tag)
                reqs = [RateLimitReq(*it) for it in items]
                body = pc.encode_get_rate_limits_req(reqs)
                node = r % 2
                got = {}
                for dev, h in clusters.items():
                    code, msg, out = chans[dev][node].call(pc.GET_RATE_LIMITS, body, 60.0)
                    check(code == 0, f"[cluster {tag}] RPC {i} to node {node} on {dev}: "
                          f"grpc-status {code} {msg!r}")
                    resps = pc.decode_get_rate_limits_resp(out)
                    got[dev] = cluster_answers(resps, addrs[dev], node)
                    want_md = ring_owner_md(h.daemons[node].instance, reqs, addrs[dev], node)
                    bad = [j for j, (a, m) in enumerate(zip(got[dev], want_md)) if a[5] != m]
                    check(not bad, f"[cluster {tag}] RPC {i} on {dev}: metadata of items "
                          f"{bad[:5]} is not the ring's owner: "
                          f"{[(got[dev][j][5], want_md[j]) for j in bad[:5]]}")
                bad = [j for j, (a, b) in enumerate(zip(got["cuda"], got["cpu"]))
                       if a[:5] != b[:5]]
                check(len(got["cuda"]) == len(reqs) and not bad,
                      f"[cluster {tag}] RPC {i} to node {node}: items {bad[:5]} differ card / "
                      f"CPU twin: {[(got['cuda'][j], got['cpu'][j]) for j in bad[:5]]}")
                n_items += len(reqs)
                step = int(rng.choice([0, 250, 1000]))
                for h in clusters.values():
                    h.daemons[0].clock.advance(ms=step)
            for r in range(CLUSTER_HTTP_RPCS):
                items = cluster_items(np, rng, "mixed")
                node = r % 2
                outs = [json.loads(http_json(
                    f"http://{h.daemons[node].http_address}/v1/GetRateLimits", items))["responses"]
                    for h in clusters.values()]
                for resps in outs:
                    for a in resps:
                        # The owner's address is each cluster's own.
                        check(set(a.pop("metadata", None) or {}) <= {"owner"},
                              f"[cluster http] RPC {r}: unexpected metadata in {a}")
                check(outs[0] == outs[1], f"[cluster http] RPC {r} to node {node}: the card's "
                      "answers differ from the CPU twin's")
                n_items += len(items)
        finally:
            undo()
        launches = [dict(c) for c in counts]
        fwd = [d.instance.counters["forward"] for d in card_c.daemons]
        peer_rpcs = [d.grpc.stats()["calls"][pc.GET_PEER_RATE_LIMITS] for d in card_c.daemons]
        log(f"[cluster] {n_items} items card vs CPU twin equal ({len(stream)} RPCs of 1000 over "
            f"the port's unary client, {CLUSTER_HTTP_RPCS} over HTTP); forwarded items by node "
            f"{fwd}, GetPeerRateLimits RPCs received by node {peer_rpcs}, K1 / K3 / K4 by node "
            f"{launches} | {card}")
        for n in range(2):
            check(fwd[n] > 0 and peer_rpcs[n] > 0,
                  f"[cluster] node {n} must forward items and receive GetPeerRateLimits RPCs")
            for name, v in launches[n].items():
                check(v > 0, f"[cluster] node {n} must launch {name}")

        # Forwarded 1000-item RPCs: every key owned by node 1, sent to node 0.
        inst0 = card_c.daemons[0].instance
        remote = [it for it in cluster_items(np, rng, "mixed", 4 * BATCH)
                  if not inst0.get_peer(f"{it[0]}_{it[1]}").info.is_owner][:BATCH]
        check(len(remote) == BATCH, f"[cluster] only {len(remote)} node-1 keys for the timing")
        body = pc.encode_get_rate_limits_req([RateLimitReq(*it) for it in remote])
        fwd0 = inst0.counters["forward"]
        lats = []
        for _ in range(CLUSTER_TIMED_RPCS + 5):
            t = time.perf_counter()
            code, msg, _ = chans["cuda"][0].call(pc.GET_RATE_LIMITS, body, 60.0)
            lats.append(time.perf_counter() - t)
            check(code == 0, f"[cluster timing] grpc-status {code} {msg!r}")
        lats = lats[5:]
        check(inst0.counters["forward"] - fwd0 == BATCH * (CLUSTER_TIMED_RPCS + 5),
              "[cluster timing] every item of the timed RPCs must be forwarded")
        p50, p99 = latency_stats(np, lats)
        read = {"rps": len(lats) / sum(lats), "p50": p50, "p99": p99}
        log(f"[cluster readings] forwarded 1000-item RPCs (node 0 -> node 1, one client, "
            f"{CLUSTER_TIMED_RPCS} timed): {read['rps']:.1f} RPCs/s, p50 {p50:.3f} ms, p99 "
            f"{p99:.3f} ms | {card}")

        # Owner down: node 1 stopped in both clusters; a key node 1 owns on
        # both rings (each cluster's ring is its own: its nodes' ports
        # differ) sent to node 0.
        key = next(f"{i}_down" for i in range(10_000)
                   if not any(h.daemons[0].instance.get_peer(f"cl_{i}_down").info.is_owner
                              for h in clusters.values()))
        req = pc.encode_get_rate_limits_req([RateLimitReq("cl", key, 1, 5, 60_000)])
        for h in clusters.values():
            h.kill(1)
        down = {}
        for mode in ("degraded", "error"):
            if mode == "error":
                for h in clusters.values():
                    inst = h.daemons[0].instance
                    inst.behaviors = dc_replace(inst.behaviors, degraded_local=False)
            for dev, h in clusters.items():
                code, msg, out = chans[dev][0].call(pc.GET_RATE_LIMITS, req, 60.0)
                check(code == 0, f"[cluster down] {mode} on {dev}: grpc-status {code} {msg!r}")
                down[mode, dev] = pc.decode_get_rate_limits_resp(out)[0]
        want_err = f"GetPeer() keeps returning peers that are not connected for 'cl_{key}'"
        for dev in clusters:
            deg, err = down["degraded", dev], down["error", dev]
            check(deg.error == "" and deg.remaining == 4
                  and deg.metadata == {"degraded": "true", "owner": addrs[dev][1]},
                  f"[cluster down] GUBER_DEGRADED_LOCAL on, {dev}: want a degraded answer "
                  f"from node 0, got {deg}")
            check(err.error == want_err and not err.metadata,
                  f"[cluster down] GUBER_DEGRADED_LOCAL off, {dev}: want {want_err!r}, got {err}")
        for mode in ("degraded", "error"):
            a, b = down[mode, "cuda"], down[mode, "cpu"]
            check((a.status, a.remaining, a.reset_time, a.error) == (
                b.status, b.remaining, b.reset_time, b.error),
                f"[cluster down] {mode}: card {a}, CPU twin {b}")
        deg, err = down["degraded", "cuda"], down["error", "cuda"]
        log(f"[cluster down] node 1 stopped: its key answered degraded by node 0 "
            f"(remaining {deg.remaining}), then {err.error!r} with degraded mode off; "
            f"the CPU twin alike; phase wall {time.perf_counter() - t_phase:.1f} s | {card}")
        for cs in chans.values():
            for c in cs:
                c.close()
        return engines, launches, read
    finally:
        for h in clusters.values():
            h.stop()


# ---------------------------------------------------------------------------
# The san phase: sanitizer runs of the port's own native code.
#
# (a) The host C++ (csrc/*.cpp) built with GUBER_NATIVE_SAN's flags and
# stressed in child processes that have the sanitizer's runtime in
# LD_PRELOAD (`python3 chip_smoke.py --san-host STRESS`): a runtime cannot
# start inside a Python that already runs, so the child is the one that
# loads the sanitized library, and it never forks once its C threads run;
# its parent, unsanitized, builds the libraries and drives the load.
# (b) compute-sanitizer's four tools over every kernel, each run a child
# (`python3 chip_smoke.py --san-kernels`) that launches K1-K17 at small
# shapes and holds each against its plain version.

SAN_SCRIPT = Path(__file__).resolve()
SAN_HOST_LIBS = ("intern_table", "wire_codec", "h2_server", "h2_client")  # the g++ libraries
SAN_STRESSES = ("h2-threaded", "h2-reactor", "feeder", "plane", "multi-schedule")
SAN_HOST_SECONDS = 3.0  # the load a stress runs under, in the san phase
SAN_REPORT = {"thread": "ThreadSanitizer", "address": "AddressSanitizer"}
SAN_HOT_KEY = b"san_hot"  # the key the decision plane holds a lease for
SAN_SUPPRESSIONS = Path("gubernator_tpu_torch") / "csrc" / "tsan_suppressions.txt"


def san_port_root() -> Path:
    import gubernator_tpu_torch

    return Path(gubernator_tpu_torch.__file__).resolve().parent.parent


def san_child_env(mode: str, preload: str) -> dict:
    """A sanitized child's environment: the runtime preloaded, the port's
    libraries sanitized (GUBER_NATIVE_SAN), no CUDA (TSan's shadow memory
    and the CUDA driver's address reservations collide), Python's own
    allocator off (pymalloc recycles ctypes buffers out of the
    sanitizer's sight), and the reference's sanitizer options."""
    env = dict(os.environ, GUBER_NATIVE_SAN=mode, LD_PRELOAD=preload, PYTHONMALLOC="malloc",
               CUDA_VISIBLE_DEVICES="")
    if mode == "thread":
        supp = san_port_root() / SAN_SUPPRESSIONS
        env["TSAN_OPTIONS"] = ("halt_on_error=1 exitcode=66 report_thread_leaks=0 "
                               f"report_mutex_bugs=0 detect_deadlocks=0 suppressions={supp}")
    else:
        # CPython frees nothing at exit: leaks are not reported.
        env["ASAN_OPTIONS"] = "halt_on_error=1 detect_leaks=0"
    return env


def san_item(name: str, key: str, hits: int = 1, limit: int = 100, behavior: int = 0) -> tuple:
    return (name, key, hits, limit, 60_000, 0, behavior, 0)


def san_payloads() -> dict:
    """The front stresses' RPCs: 8 plain items (the feeder packs them), 8
    GLOBAL items (the feeder declines them: the byte window) and one item
    on the leased hot key (the decision plane answers it in C)."""
    return {
        "feeder": encode_get_rate_limits([san_item("san", f"k{i}") for i in range(8)]),
        "byte window": encode_get_rate_limits([san_item("san", f"g{i}", behavior=2)
                                               for i in range(8)]),
        "plane": encode_get_rate_limits([san_item("san", "hot", limit=1 << 40)]),
    }


class SanFront:
    """The h2 server as the host stresses run it: a flat window callback
    (every item UNDER_LIMIT, limit 100, remaining 99), the columnar feeder
    with windows of 8 rows (so windows seal and rotate constantly) and a
    flat handler, the decision plane, and optionally the event ring.  `lib`
    is an h2 server library, `plane_mod` the module of its
    NativeDecisionPlane / NativeColumnarFeeder and `callback_type` its
    window callback's ctypes type, so that the same front is built over
    the port's library (sanitized in a child, or plain) or another
    implementation of the same C interface."""

    def __init__(self, lib, plane_mod, callback_type, disqualify: int, *, event_front: bool,
                 ring: bool):
        import ctypes

        self.lib = lib
        self._cb = callback_type(self._window)
        self.handle = lib.h2s_start(0, 500, 16384, 4096, 2, int(event_front), 2, 0, self._cb)
        check(bool(self.handle), "[san] the h2 server failed to bind")
        self.port = int(lib.h2s_port(self.handle))
        self.plane = plane_mod.NativeDecisionPlane(disqualify_mask=disqualify)
        lib.h2s_attach_plane(self.handle, self.plane.handle)
        self.feeder = plane_mod.NativeColumnarFeeder(
            n_slots=3, max_rows=256, max_rpcs=64, flush_rows=8, window_s=0.0005,
            disqualify_mask=disqualify, window_handler=self._feeder_window)
        lib.h2s_attach_feeder(self.handle, self.feeder.handle)
        self.ring = None
        if ring:
            self.ring = ctypes.c_void_p(lib.evr_create(1024))
            lib.h2s_attach_ring(self.handle, self.ring)
            self.feeder.attach_ring(self.ring)

    @staticmethod
    def _window(buf, length, counts_ptr, lens_ptr, n_rpcs, total, out_ptr, status_ptr):
        import ctypes

        import numpy as np

        n, nr = int(total), int(n_rpcs)
        if nr > 0 and status_ptr:
            np.ctypeslib.as_array(ctypes.cast(status_ptr, ctypes.POINTER(ctypes.c_int64)),
                                  shape=(nr,))[:] = 0
        if n > 0 and out_ptr:
            cols = np.ctypeslib.as_array(ctypes.cast(out_ptr, ctypes.POINTER(ctypes.c_int64)),
                                         shape=(4 * n,))
            cols[:n], cols[n:2 * n], cols[2 * n:3 * n], cols[3 * n:] = 0, 100, 99, 0
        return 0

    @staticmethod
    def _feeder_window(slot, n_rows, n_rpcs, key_bytes):
        slot.out_status[:n_rows] = 0
        slot.out_limit[:n_rows] = 100
        slot.out_remaining[:n_rows] = 99
        slot.out_reset[:n_rows] = 0
        slot.rpc_status[:n_rpcs] = 0
        return 0

    def stop(self) -> dict:
        """Read the stats, then tear down in the front's order (net/h2_fast.py
        close): detach the plane and the feeder, stop the feeder, detach the
        ring, stop the server, free the feeder, the plane, the ring."""
        import numpy as np

        out = np.zeros(16, dtype=np.int64)
        self.lib.h2s_stats(self.handle, out.ctypes.data)
        stats = {"rpcs": int(out[0]), "windows": int(out[1]), "errors": int(out[2]),
                 "native_rpcs": int(out[3]), "feeder_front_rpcs": int(out[5])}
        stats.update(self.feeder.stats())
        self.lib.h2s_attach_plane(self.handle, None)
        self.lib.h2s_attach_feeder(self.handle, None)
        self.feeder.stop()
        if self.ring is not None:
            self.lib.h2s_attach_ring(self.handle, None)
        self.lib.h2s_stop(self.handle)
        self.feeder.close()
        self.plane.close()
        if self.ring is not None:
            self.lib.evr_free(self.ring)
        return stats


def san_decoded(dec) -> dict | None:
    """A decode's columns as JSON values (None: declined)."""
    if dec is None:
        return None
    out = {"n": int(dec.n)}
    for field in dec._fields[1:]:
        a = getattr(dec, field)
        out[field] = a.tobytes().hex() if field == "key_buf" else [int(v) for v in a]
    return out


def malformed_bodies(seed: int) -> list:
    """Request bodies a front must survive, from a seed: every prefix of a
    valid two-item body (truncated varints and lengths), length fields past
    the end, counts far larger than the body (a key length of 2^40, 1001
    items), empty and huge keys (64 KiB and 1 MiB), wire types 1, 3, 4, 5
    and 7, overlong and 10-byte varints, garbage inside a well-framed item,
    and random bytes."""
    import numpy as np

    rng = np.random.default_rng(seed)
    good = encode_get_rate_limits([san_item("api", "u1", hits=3), san_item("api", "u2")])
    item = good[2 : 2 + good[1]]
    bodies = [good[:k] for k in range(1, len(good))]
    bodies += [
        b"\x0a" + pb_varint(1000) + b"abc",
        b"\x0a" + pb_varint(len(item) + 1) + item,
        b"\x0a" + pb_varint(12) + b"\x0a" + pb_varint(1 << 40) + b"api",
        b"\x0a" + pb_varint(1 << 62),
        b"\x0a\x00" * 1001,
        b"\x0a\x00" * 1000,
        encode_get_rate_limits([san_item("", "k")]),
        encode_get_rate_limits([san_item("api", "")]),
        encode_get_rate_limits([san_item("api", "k" * (1 << 16))]),
        encode_get_rate_limits([san_item("api", "k" * (1 << 20))]),
        encode_get_rate_limits([san_item("api" * 5000, "k", hits=-1, limit=-1)]),
        b"\x09" + bytes(8) + good,
        b"\x0d" + bytes(4) + good,
        b"\x0b" + good,
        b"\x0c" + good,
        b"\x0f" + good,
        b"\x18" + b"\xff" * 10 + b"\x01" + good,
        b"\x18" + b"\x80" * 11 + b"\x00",
        b"\x0a" + pb_varint(6) + b"\x18" + b"\xff" * 4 + b"\x7f" + good,
        b"\x0a" + pb_varint(4) + b"\x12\x05ab",
        b"\x0a" + pb_varint(3) + b"\x38\x80\x80",
        good + b"\x0a",
        good * 40,
    ]
    for n in (1, 2, 7, 64, 513, 4096):
        for _ in range(6):
            bodies.append(rng.integers(0, 256, n, dtype=np.uint8).tobytes())
    for _ in range(40):  # a valid body with one byte changed
        b = bytearray(good)
        b[int(rng.integers(0, len(b)))] = int(rng.integers(0, 256))
        bodies.append(bytes(b))
    return bodies


def san_front_answers(address: str, bodies) -> list:
    """(grpc-status, response bytes) of each body sent as one RPC, in order,
    on one connection (`H2Unary`)."""
    client = H2Unary(address)
    try:
        return [client.call(b) for b in bodies]
    finally:
        client.close()


def san_front_load(address: str, seconds: float) -> dict:
    """Load on a stress's front from this process through the port's native
    client (core/h2_client.py), for `seconds`: for each of `san_payloads`
    a thread of closed loops of 0.5 s, each on new connections (4 or 8,
    so connections churn), and one `connscale` run of 64 connections, 8 of
    them busy.  Returns RPCs and errors by load."""
    import threading

    from gubernator_tpu_torch.core import h2_client

    payloads = san_payloads()
    got = {tag: [0, 0] for tag in (*payloads, "connscale")}
    t_end = time.monotonic() + seconds

    def churn(tag: str, n_conns: int) -> None:
        while time.monotonic() < t_end:
            r = h2_client.bench_unary(address, H2_PATH, payloads[tag], 0.5, n_conns,
                                      max_lats=10_000)
            got[tag][0] += r[0] if r else 0
            got[tag][1] += r[1] if r else 1

    def scale() -> None:
        r = h2_client.connscale(address, H2_PATH, payloads["feeder"], seconds, 64, 8, threads=2,
                                ramp_budget_s=60.0, max_lats=10_000)
        got["connscale"] = [r["rpcs"], r["errors"]] if r else [0, 1]

    threads = [threading.Thread(target=churn, args=(tag, 4 + 4 * (k % 2)))
               for k, tag in enumerate(payloads)] + [threading.Thread(target=scale)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return got


def san_host_stress(mode: str, stress: str, seconds: float, *, bodies=None,
                    timeout: float = 600.0) -> dict:
    """One host stress in a child with the `mode` sanitizer ("thread" or
    "address") preloaded; the libraries are built here first.  For a
    front stress (h2-threaded, h2-reactor, malformed) this process drives
    the child's front (`san_front_load`) and, given `bodies`, sends each
    as an RPC and has the child decode each (`malformed`).  Returns the
    child's rc, its "ok" line's values, its stderr, the sanitizer's report
    (None when it wrote none), the load's RPCs and errors, the front's
    answers to `bodies` and the child's decodes of them."""
    from gubernator_tpu_torch.ops import native_build

    preload = native_build.sanitizer_preload(mode)
    check(preload is not None, f"[san] no {mode} sanitizer runtime in this toolchain")
    native_build.build_all(SAN_HOST_LIBS, san=mode)
    front = stress in ("h2-threaded", "h2-reactor", "malformed")
    res = {"mode": mode, "stress": stress, "rc": None, "ok": None, "report": None, "load": {},
           "answers": None, "decoded": None}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        if bodies is not None:
            (tmp / "bodies.json").write_text(json.dumps([b.hex() for b in bodies]))
        err_path = tmp / "stderr.txt"
        with open(err_path, "w") as err:
            child = subprocess.Popen(
                [sys.executable, str(SAN_SCRIPT), "--san-host", stress, "--san-seconds",
                 str(seconds), "--san-dir", str(tmp)],
                cwd=san_port_root(), env=san_child_env(mode, preload), stdin=subprocess.PIPE,
                stdout=subprocess.PIPE, stderr=err, text=True)
            try:
                if front:
                    line = child.stdout.readline()
                    if line.startswith("PORT "):
                        address = f"127.0.0.1:{int(line.split()[1])}"
                        if bodies is not None:
                            res["answers"] = san_front_answers(address, bodies)
                        res["load"] = san_front_load(address, seconds)
                out, _ = child.communicate(input="", timeout=timeout)
            except BaseException:
                child.kill()
                child.wait()
                raise
        res["rc"] = child.returncode
        res["stderr"] = err_path.read_text(errors="replace")
        for line in out.splitlines():
            if line.startswith("[san-host] ok "):
                res["ok"] = json.loads(line[len("[san-host] ok "):])
        if (tmp / "decoded.json").exists():
            res["decoded"] = json.loads((tmp / "decoded.json").read_text())
    if SAN_REPORT[mode] in res["stderr"]:
        res["report"] = res["stderr"]
    res["seconds"] = time.perf_counter() - t0
    return res


def san_expected(bodies, lib, plane_mod, callback_type, disqualify: int, decode) -> tuple:
    """What a front and a decode must answer to `bodies`: a `SanFront`
    over `lib` (an unsanitized h2 server library: the port's here, the
    reference's in the tests) answers each as an RPC, and `decode(body)`
    (a codec's decode at 1000 items and `disqualify`) and the front's
    empty plane decode each.  Returns (answers, decodes) in
    `san_host_stress`'s form."""
    front = SanFront(lib, plane_mod, callback_type, disqualify, event_front=True, ring=False)
    try:
        decoded = [{"codec": san_decoded(decode(b)),
                    "plane": None if (r := front.plane.try_serve(b)) is None else r.hex()}
                   for b in bodies]
        answers = san_front_answers(f"127.0.0.1:{front.port}", bodies)
    finally:
        front.stop()
    return answers, decoded


def san_malformed_failures(res: dict, answers, decoded) -> list:
    """The bodies whose answer through the child's front, or whose decode
    in the child, differs from the expected (`san_expected`)."""
    out = []
    if res["answers"] is None or res["decoded"] is None:
        return ["malformed: the child answered or decoded nothing"]
    for i, (got, want) in enumerate(zip(res["answers"], answers)):
        if tuple(got) != tuple(want):
            out.append(f"malformed body {i}: the front answered {got[0]} {got[1][:40]!r}, "
                       f"expected {want[0]} {want[1][:40]!r}")
    for i, (got, want) in enumerate(zip(res["decoded"], decoded)):
        if got != want:
            out.append(f"malformed body {i}: decoded {str(got)[:200]}, expected {str(want)[:200]}")
    if len(res["answers"]) != len(answers) or len(res["decoded"]) != len(decoded):
        out.append("malformed: not every body was answered and decoded")
    return out


def san_host_failures(res: dict) -> list:
    """What fails a host stress: a sanitizer report, a non-zero rc, no "ok"
    line, a failed RPC of the load, or a load that reached nothing."""
    tag = f"{res['stress']} under {SAN_REPORT[res['mode']]}"
    out = []
    if res["report"] is not None:
        out.append(f"{tag}: report\n{res['report'][-6000:]}")
    if res["rc"] != 0 or res["ok"] is None:
        out.append(f"{tag}: rc {res['rc']}, ok line {res['ok']}\n{res['stderr'][-4000:]}")
    for what, (rpcs, errors) in res["load"].items():
        if errors or not rpcs:
            out.append(f"{tag}: {what} load answered {rpcs} RPCs with {errors} errors")
    return out


# -- the children (each runs with a sanitizer's runtime preloaded) ------------


def san_child_front(stress: str, seconds: float, io_dir: Path) -> None:
    """An h2 front (`SanFront`) over the sanitized library, its event ring
    drained by a Python thread throughout (the collector's one consumer)
    and the plane's lease on the hot key pulled and re-granted by another
    (the ledger's settle thread); prints PORT, serves until its parent
    closes stdin.  For `malformed` it first decodes every body of
    bodies.json through the codec and the plane into decoded.json."""
    import threading

    import numpy as np

    from gubernator_tpu_torch.core import native_plane
    from gubernator_tpu_torch.net import h2_fast, wire_codec
    from gubernator_tpu_torch.ops import native_build
    from gubernator_tpu_torch.service import COLUMNAR_DISQUALIFIERS

    lib = h2_fast.load()
    front = SanFront(lib, native_plane, native_build.WINDOW_CALLBACK, COLUMNAR_DISQUALIFIERS,
                     event_front=stress != "h2-threaded", ring=True)
    if stress == "malformed":
        bodies = [bytes.fromhex(b) for b in json.loads((io_dir / "bodies.json").read_text())]
        decoded = [{"codec": san_decoded(wire_codec.decode_reqs(b, 1000, COLUMNAR_DISQUALIFIERS)),
                    "plane": None if (r := front.plane.try_serve(b)) is None else r.hex()}
                   for b in bodies]
        (io_dir / "decoded.json").write_text(json.dumps(decoded))
    stop = threading.Event()
    drained, grants = [0], [0]

    def drain() -> None:
        out = np.zeros(4 * 256, dtype=np.int64)
        while not stop.is_set():
            drained[0] += int(lib.evr_drain(front.ring, out.ctypes.data, 256))
            time.sleep(0.0002)

    def settle() -> None:
        while not stop.is_set():
            now = int(time.time() * 1000)
            front.plane.pull(SAN_HOT_KEY)
            front.plane.install_lease(SAN_HOT_KEY, 1 << 40, 60_000, now + 60_000, 1 << 40,
                                      1 << 30, 0, now + 60_000)
            grants[0] += 1
            time.sleep(0.005)

    workers = [threading.Thread(target=drain)]
    if stress != "malformed":  # the malformed run's plane holds nothing
        workers.append(threading.Thread(target=settle))
    for t in workers:
        t.start()
    print("PORT", front.port, flush=True)
    sys.stdin.read()
    stop.set()
    for t in workers:
        t.join()
    # The load has ended: every row the feeder packed is served within a
    # window or two, with no flush (a stranded row waits for the stop).
    deadline = time.monotonic() + 2.0
    while time.monotonic() < deadline:
        st = front.feeder.stats()
        if st["feeder_served_rows"] == st["feeder_rows"]:
            break
        time.sleep(0.01)
    stats = front.stop()
    stats.update(drained=drained[0], grants=grants[0])
    check(stats["rpcs"] > 0 and stats["feeder_front_rpcs"] > 0 and stats["windows"] > 0,
          f"[san] the load must reach the feeder and the byte window: {stats}")
    check(stats["feeder_served_rows"] == stats["feeder_rows"],
          f"[san] rows the feeder packed and never served: {stats}")
    if stress != "malformed":
        check(stats["native_rpcs"] > 0 and drained[0] > 0,
              f"[san] the plane must answer and the ring must drain: {stats}")
    print("[san-host] ok " + json.dumps(stats), flush=True)


def san_child_feeder(seconds: float) -> None:
    """The feeder alone (reference tests/test_h2_server_san.py:375): C
    producer threads (`bench_pack`) and Python threads packing and flushing
    race the serve thread's seal, rotate and recycle of windows of 8 rows
    and its Python handler, the ring drained throughout; every packed row
    is served exactly once."""
    import threading

    import numpy as np

    from gubernator_tpu_torch.core import native_plane

    body = encode_get_rate_limits([san_item("san", f"hot{i}xyz") for i in range(4)])
    served = [0]

    def handler(slot, n_rows, n_rpcs, key_bytes):
        served[0] += n_rows
        return SanFront._feeder_window(slot, n_rows, n_rpcs, key_bytes)

    feeder = native_plane.NativeColumnarFeeder(n_slots=3, max_rows=256, max_rpcs=64,
                                               flush_rows=8, window_s=0.0005,
                                               window_handler=handler)
    lib = native_plane.load()
    ring = lib.evr_create(1024)
    feeder.attach_ring(ring)
    stop = threading.Event()

    def drain() -> None:
        out = np.zeros(4 * 256, dtype=np.int64)
        while not stop.is_set():
            lib.evr_drain(ring, out.ctypes.data, 256)
            time.sleep(0.0002)

    py_packed = [0] * 4
    lanes_done = [threading.Event() for _ in range(4)]
    park = threading.Event()  # never set

    def lane(t: int) -> None:
        i = 0
        while not stop.is_set():
            rc = feeder.pack(body)
            if rc > 0:
                py_packed[t] += rc
            if i % 25 == 0:
                feeder.flush()
            i += 1
        lanes_done[t].set()
        park.wait()

    # The Python producers never exit (daemon threads, parked once done):
    # Python detaches its threads, and when one that ran cf_pack exits, its
    # TLS (csrc/columnar_feeder.cpp tls_scratch, destroyed at thread exit)
    # is freed by ld.so in another thread, which ThreadSanitizer cannot
    # order after the exited thread's TLS destructor.  The front's own
    # producers are its joined C++ threads.
    drainer = threading.Thread(target=drain)
    drainer.start()
    for t in range(4):
        threading.Thread(target=lane, args=(t,), daemon=True).start()
    packed, rounds = 0, 0
    t_end = time.monotonic() + seconds
    while rounds < 4 or time.monotonic() < t_end:
        packed += feeder.bench_pack(body, 4, 500, 4)
        feeder.flush()
        rounds += 1
    stop.set()
    drainer.join()
    for done in lanes_done:
        done.wait()
    feeder.flush()
    packed += sum(py_packed)
    st = feeder.stats()
    check(st["feeder_rows"] == packed == st["feeder_served_rows"] == served[0],
          f"[san] feeder rows packed {packed}, served {served[0]}: {st}")
    feeder.attach_ring(None)
    feeder.close()
    lib.evr_free(ring)
    print("[san-host] ok " + json.dumps({"rows": packed, "windows": st["feeder_windows"],
                                         "rounds": rounds}), flush=True)


def san_child_plane(seconds: float) -> None:
    """The decision plane (reference tests/test_h2_server_san.py:426):
    six threads serve an RPC on a leased hot key (`dp_try_serve`, as the
    connection threads do) while another pulls and re-grants the lease and
    installs and pulls an over-limit record (`dp_install_*`, `dp_pull`,
    as the ledger's settle thread does) and a third peeks, probes and
    reads the stats; every admission is counted once: the lanes' total
    equals the pulled consumption plus the final pull."""
    import threading

    from gubernator_tpu_torch.core import native_plane

    plane = native_plane.NativeDecisionPlane(disqualify_mask=0)
    now = NOW0
    body = encode_get_rate_limits([san_item("san", "hot", limit=1 << 40)])
    over_key = b"san_over"

    def grant() -> None:
        plane.install_lease(SAN_HOT_KEY, 1 << 40, 60_000, now + 60_000, 1 << 40, 1 << 30, 0,
                            now + 60_000)

    grant()
    stop = threading.Event()
    admitted = [0] * 6

    def lane(t: int) -> None:
        while not stop.is_set():
            if plane.try_serve(body, max_items=1, now_ms=now) is not None:
                admitted[t] += 1

    def reader() -> None:
        while not stop.is_set():
            plane.peek(SAN_HOT_KEY)
            plane.probe(over_key, 0, 0, 1, 100, 60_000, now)
            plane.stats()

    workers = [threading.Thread(target=lane, args=(t,)) for t in range(6)]
    workers.append(threading.Thread(target=reader))
    for t in workers:
        t.start()
    pulled, cycles = 0, 0
    t_end = time.monotonic() + seconds
    while cycles < 400 or time.monotonic() < t_end:
        res = plane.pull(SAN_HOT_KEY)
        if res is not None:
            pulled += res[1]
        grant()
        plane.install_over(over_key, 100, 60_000, now + 60_000)
        plane.pull(over_key)
        cycles += 1
    stop.set()
    for t in workers:
        t.join()
    res = plane.pull(SAN_HOT_KEY)
    final = res[1] if res is not None else 0
    check(sum(admitted) == pulled + final, f"[san] the plane admitted {sum(admitted)}, "
          f"pulled {pulled} + {final}")
    plane.close()
    print("[san-host] ok " + json.dumps({"admitted": sum(admitted), "cycles": cycles}),
          flush=True)


def san_child_multi_schedule(seconds: float) -> None:
    """`git_multi_schedule`'s pool (reference tests/test_multi_schedule.py:137):
    8 tables of 16 slots, one set scheduled with 1 thread and one with 4
    (then 8), on batches where 30 % of the keys are 4 hot keys (they
    collapse into rounds) and the rest 400 keys (they evict), with expiries
    in the past and the future, hashes given or computed in C: every step's
    rounds, slots, order and counts equal, evictions equal as a multiset."""
    import numpy as np

    from gubernator_tpu_torch.core.native import NativeInternTable, multi_schedule
    from gubernator_tpu_torch.hashing import fnv1a_64_batch, pack_keys

    rng = np.random.default_rng(SEED + 20)
    serial = [NativeInternTable(16) for _ in range(8)]
    threaded = [NativeInternTable(16) for _ in range(8)]
    now, steps = NOW0, 0
    t_end = time.monotonic() + seconds
    while steps < 24 or time.monotonic() < t_end:
        n = int(rng.integers(1, 512))
        ids = np.where(rng.random(n) < 0.3, rng.integers(0, 4, n), 4 + rng.integers(0, 400, n))
        keys = [b"san_%d" % i for i in ids.tolist()]
        lens = np.array([len(k) for k in keys], np.int64)
        off = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
        buf = np.frombuffer(b"".join(keys), dtype=np.uint8)
        hashes = fnv1a_64_batch(*pack_keys(keys)) if steps % 2 else None
        exp = now + rng.integers(-1_000, 60_000, n)
        a = multi_schedule(serial, buf, off, hashes, now, exp, threads=1)
        b = multi_schedule(threaded, buf, off, hashes, now, exp, threads=4 + 4 * (steps % 2))
        check(a[0] == b[0], f"[san] multi_schedule step {steps}: max_round {a[0]} vs {b[0]}")
        for x, y, what in zip(a[1:6], b[1:6], ("shard", "slots", "rounds", "order", "counts")):
            check(np.array_equal(x, y), f"[san] multi_schedule step {steps}: {what} differ")
        check(sorted(zip(a[7].tolist(), a[6].tolist(), a[8].tolist()))
              == sorted(zip(b[7].tolist(), b[6].tolist(), b[8].tolist())),
              f"[san] multi_schedule step {steps}: evictions differ")
        now += int(rng.integers(0, 1_000))
        steps += 1
    evicted = sum(t.evictions for t in serial)
    check(evicted > 0, "[san] the multi_schedule stream must evict")
    print("[san-host] ok " + json.dumps({"steps": steps, "evictions": evicted}), flush=True)


def san_host_child(stress: str, seconds: float, io_dir: Path) -> int:
    """`--san-host STRESS`: run one stress in this (sanitized) process."""
    if stress in ("h2-threaded", "h2-reactor", "malformed"):
        san_child_front(stress, seconds, io_dir)
    elif stress == "feeder":
        san_child_feeder(seconds)
    elif stress == "plane":
        san_child_plane(seconds)
    elif stress == "multi-schedule":
        san_child_multi_schedule(seconds)
    else:
        raise SystemExit(f"unknown stress {stress!r}")
    return 0



# -- (b) compute-sanitizer over every kernel ----------------------------------

SAN_TOOLS = ("memcheck", "racecheck", "synccheck", "initcheck")
# launch-count name → the kernel's number (PERF.md §6)
SAN_KERNELS = {
    "fused_step": "K1", "clear_occupied": "K2", "collapsed_step": "K3", "uniform_step": "K4",
    "load_slots": "K5", "sweep_window": "K6", "sketch_step": "K7", "sketch_rotate": "K8",
    "gather_pages": "K9", "load_pages": "K10", "shard_step": "K11", "shard_collapsed": "K12",
    "shard_sweep": "K13", "packed_compute": "K14", "scatter_store": "K15",
    "collapsed_compute": "K16", "apply_batch": "K17",
}
SAN_CAP = 1 << 14  # slots of the dense states the sanitizer child holds
SAN_MARK = "[san-kernel] "


def san_child_kernels(marks: bool = True) -> int:
    """`--san-kernels` (run under compute-sanitizer): K1-K17 at small shapes
    that still reach every branch, each held bit-equal to its plain
    version.  With `marks`, each launch is bracketed by marker lines, with
    the device synchronised on both sides, so that the tool's reports
    between two markers are that kernel's; inputs are made and plain
    versions run outside them.  The last line gives the launches inside
    the brackets."""
    import numpy as np
    import torch

    from gubernator_tpu_torch.ops import BatchInput, apply_batch
    from gubernator_tpu_torch.ops import bucket_kernel as tk
    from gubernator_tpu_torch.ops import fused_step as fs
    from gubernator_tpu_torch.ops import sketch as ps
    from gubernator_tpu_torch.ops import split_step as ss
    from gubernator_tpu_torch.ops.collapsed_step import collapsed_step
    from gubernator_tpu_torch.ops.page_words import gather_pages, load_pages
    from gubernator_tpu_torch.ops.sharded_step import shard_collapsed_step

    rng = np.random.default_rng(SEED + 21)
    counts = {k: 0 for k in SAN_KERNELS}

    def all_launches() -> dict:
        return {**fs.launches, **fs.split_launches}

    def run(name: str, fn):
        torch.cuda.synchronize()
        before = all_launches()[name]
        if marks:
            print(f"{SAN_MARK}begin {name}", flush=True)
        out = fn()
        torch.cuda.synchronize()
        if marks:
            print(f"{SAN_MARK}end {name}", flush=True)
        counts[name] += all_launches()[name] - before
        return out

    def diff(a, b) -> int:
        return 0 if torch.equal(a, b) else int((a.long() - b.long()).abs().max().item())

    def held(name: str, err: int, what: str) -> None:
        check(err == 0, f"[san] {SAN_KERNELS[name]} ({name}) differs from its plain version: "
              f"{what}, err {err}")

    def cuda(a):
        return torch.from_numpy(np.ascontiguousarray(a)).cuda()

    cap, now = SAN_CAP, NOW0
    kern = random_state(torch, cap, now, int(rng.integers(2**31)))
    plain = copy_state(kern)
    # K1: one round of 1000 lanes in 1024, then a 5-round batch of up to
    # 1024 lanes a round with clears (even rounds), padding lanes at
    # cap + lane.
    pin = cuda(random_pin(np, rng, cap, 1024, BATCH, now))
    got = run("fused_step", lambda: fs.fused_step(kern, pin))
    held("fused_step", max(diff(got, tk.fused_step_reference(plain, pin)),
                           compare_states(torch, kern, plain)), "one round")
    packed = ragged_rounds(np, rng, cap, 5, now + 7, max_lanes=1024)
    dev = on_device(torch, packed)
    got = run("fused_step", lambda: fs.multi_fused_step(kern, *dev, widest=packed.widest))
    held("fused_step", max(diff(got, tk.multi_fused_step_reference(plain, *dev)),
                           compare_states(torch, kern, plain)), "5 rounds")
    # K2 then K5: a restoring round, 40 clears (half on restored slots) and
    # 1000 records padded to 1024 (a partial last block).
    clears, rec = clear_restore_case(np, rng, cap, 40, 1000, now)
    c = np.arange(cap, cap + tk.pad_size(len(clears), floor=16), dtype=np.int64)
    c[: len(clears)] = clears
    cd, rd = cuda(c.astype(np.int32)), cuda(rec)
    run("clear_occupied", lambda: fs.clear_occupied(kern.meta, cd))
    run("load_slots", lambda: fs.load_slots(kern, rd))
    clear_restore_plain(torch, np, plain, clears, rec)
    held("load_slots", compare_states(torch, kern, plain), "a restoring round")
    # K3: zipf chunks of 8192 lanes, with clears, mostly padding, one key.
    for kind in ("zipf", "clears", "padding", "one"):
        now += 11
        host, clears = collapsed_case(np, rng, cap, kind, now)
        dpin, dcl = cuda(host), cuda(clears)
        got = run("collapsed_step", lambda: collapsed_step(kern, dpin, dcl))
        tk.clear_occupied_reference(plain.meta, dcl)
        held("collapsed_step", max(diff(got, tk.collapsed_step_reference(plain, dpin)),
                                   compare_states(torch, kern, plain)), f"{kind} chunk")
    # K4: 5 ragged uniform rounds with clears, and a skewed launch.
    for case in (5, "skewed"):
        now += 13
        if case == "skewed":
            upin, ro, co, cs_, widest = skewed_uniform_rounds(np, rng, cap, now)
        else:
            upin, ro, co, cs_, widest = uniform_rounds(np, rng, cap, case, now)
        args = [cuda(a) for a in (upin, ro, co, cs_)]
        got = run("uniform_step", lambda: fs.multi_uniform_step(kern, *args, widest=widest))
        held("uniform_step", max(diff(got, tk.multi_uniform_step_reference(plain, *args)),
                                 compare_states(torch, kern, plain)), f"uniform {case}")
    # K14 then K15 on a batch of 1000 lanes; K16 then K15 on a zipf chunk.
    for kind in ("k14", "k16"):
        now += 17
        if kind == "k14":
            host = random_pin(np, rng, cap, 1024, BATCH, now)
            name, fn, ref = "packed_compute", ss.packed_compute, tk.packed_compute_reference
        else:
            host, _ = collapsed_case(np, rng, cap, "zipf", now)
            name, fn, ref = ("collapsed_compute", ss.collapsed_compute,
                             tk.collapsed_compute_reference)
        dpin = cuda(host)
        slot, words, pout = run(name, lambda: fn(kern, dpin))
        pslot, pwords, ppout = ref(plain, dpin)
        live = cuda((host[1] >= 0) & (host[1].astype(np.int64) < cap))
        held(name, max(diff(pout, ppout), diff(words[:, live], pwords[:, live]),
                       compare_states(torch, kern, plain)), "pout, live words, state untouched")
        run("scatter_store", lambda: ss.scatter_store(kern, slot, words))
        tk.scatter_store_reference(plain, pslot, pwords)
        held("scatter_store", compare_states(torch, kern, plain), f"after {name}")
    # K17: 1000 lanes padded to 1024, unsorted, with clears; then the
    # extreme values.
    for extreme in (False, True):
        now += 19
        cols, clears = apply_batch_case(np, rng, cap, 1024, BATCH, now, extreme=extreme)
        batch = BatchInput(*(cuda(x) for x in cols))
        dcl = cuda(clears)
        got = run("apply_batch", lambda: apply_batch(kern, batch, dcl, now))
        want = tk.apply_batch_reference(plain, batch, dcl, now)
        held("apply_batch", max(max(diff(a, b) for a, b in zip(got, want)),
                                compare_states(torch, kern, plain)), f"extreme {extreme}")
    del kern, plain
    # K6: a group of 16 windows of 1024 over 16,084 slots, the last window
    # clamped (it overlaps the one before); K13: 16 windows of 256 over 4
    # shards of 3,996 slots.
    for name, n_sh, window in (("sweep_window", 0, 1024), ("shard_sweep", 4, 256)):
        rows = 16 * window - 300
        st = random_state(torch, max(n_sh, 1) * rows, NOW0, int(rng.integers(2**31)))
        arm_expiries(torch, st, NOW0, int(rng.integers(2**31)))
        pl = copy_state(st)
        starts = [min(i * window, rows - window) for i in range(16)]
        got = run(name, lambda: sweep_group(st.meta, st.hi2, st.expire_lo, NOW0, starts, window,
                                            n_sh))
        want = sweep_group_plain(pl.meta, pl.hi2, pl.expire_lo, NOW0, starts, window, n_sh)
        held(name, max(same_sweep(torch, got, want),
                       compare_states(torch, (st.meta,), (pl.meta,))), "a group of 16 windows")
    # K7 in both forms at depth 4: 48 keys (the block form, and the pair
    # form on the same pin) and 1000 keys (the pair form); K8 on one plane.
    width = 1 << 14
    base = random_planes(torch, width, int(rng.integers(2**31)))
    for n in (48, BATCH):
        keys = [b"sk_hot"] * 4 + sketch_keys(np, rng, n - 4)
        hits = np.concatenate([[2**30] * 4, rng.choice([-7, -1, 0, 1, 2, 5], n - 4)])
        spin = cuda(sketch_pin(np, rng, width, keys, hits, NOW0 + 300))
        cur = int(rng.integers(0, 2))
        for plan in k7_plans(ps, SKETCH_DEPTH, spin.shape[1]):
            k_planes, p_planes = base.clone(), base.clone()
            got = run("sketch_step", lambda: ps.launch_step(k_planes, spin, cur, plan))
            want = ps.sketch_step_reference(p_planes, spin, cur)
            held("sketch_step", max(diff(got, want), diff(k_planes, p_planes)),
                 f"{n} keys, {plan}")
    k_planes, p_planes = base.clone(), base.clone()
    c_k = run("sketch_rotate", lambda: ps.sketch_rotate(k_planes, 0, 1))
    c_p = ps.rotate_reference(p_planes, 0, 1)
    held("sketch_rotate", max(abs(c_k - c_p), diff(k_planes, p_planes)), "one plane")
    del base, k_planes, p_planes
    # K9 and K10: 16 pages of 512 (the last frame among them) of a state
    # with bit 31 set in the *_lo words.
    page, frames = 512, 64
    st = extreme_page_state(torch, np, rng, frames * page)
    pl = copy_state(st)
    starts = np.sort(rng.choice(frames - 1, 15, replace=False)) * page
    ds = cuda(np.append(starts, (frames - 1) * page).astype(np.int32))
    got = run("gather_pages", lambda: gather_pages(st, ds, page))
    held("gather_pages", diff(got, tk.gather_page_words_reference(pl, ds, page)), "16 pages")
    words = cuda(rng.integers(-(2**31), 2**31, (16, 12, page), dtype=np.int64).astype(np.int32))
    run("load_pages", lambda: load_pages(st, ds, words))
    tk.load_page_words_reference(pl, ds, words)
    held("load_pages", compare_states(torch, st, pl), "16 pages")
    # K11: 4 shards of 4096, batches of 1 and 8 rounds of 128 lanes with
    # clears in every round; K12: chunks of 256 lanes a shard, a hot key,
    # padding and an empty shard.
    n_sh, scap = 4, 4096
    st = random_state(torch, n_sh * scap, NOW0, int(rng.integers(2**31)))
    pl = copy_state(st)
    for n_rounds in (1, 8):
        pieces = shard_round_pieces(np, rng, n_sh, scap, n_rounds, 128, NOW0 + n_rounds,
                                    later_clears=True)
        runner = k11_batch_runner(torch, np, pieces, scap)
        got = run("shard_step", lambda: runner(st))
        want = k11_batch_plain(torch, pl, pieces, scap)
        held("shard_step", max(diff(got, want), compare_states(torch, st, pl)),
             f"{n_rounds} rounds")
    pin_np, slots_of = sharded_pin(np, rng, n_sh, scap, 256, NOW0 + 5, collapsed=True)
    spin, srows = cuda(pin_np), cuda(shard_clears(np, rng, scap, slots_of))
    got = run("shard_collapsed", lambda: shard_collapsed_step(st, spin, scap, srows))
    tk.shard_clears_reference(pl, srows, scap)
    want = tk.sharded_collapsed_step_reference(pl, spin, scap)
    held("shard_collapsed", max(diff(got, want), compare_states(torch, st, pl)), "256 lanes")
    missing = [SAN_KERNELS[k] for k, n in counts.items() if n == 0]
    check(not missing, f"[san] kernels never launched: {missing}")
    print(f"{SAN_MARK}done " + json.dumps(counts), flush=True)
    return 0


def compute_sanitizer_path() -> str | None:
    """compute-sanitizer, looked up as `native_build.nvcc_path` looks up
    nvcc: $CUDA_HOME/bin, /usr/local/cuda/bin, then PATH."""
    import shutil

    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.path.isfile(os.path.join(home, "bin", "compute-sanitizer")):
            return os.path.join(home, "bin", "compute-sanitizer")
    return shutil.which("compute-sanitizer")


# Lines of compute-sanitizer's own that are no error record.
SAN_TOOL_INFO = ("COMPUTE-SANITIZER", "ERROR SUMMARY", "RACECHECK SUMMARY", "LEAK SUMMARY",
                 "Target application returned an error")


def san_kernel_tool(tool: str, timeout: float = 600.0) -> dict:
    """One compute-sanitizer run of `--san-kernels` under `tool`, each
    allocation a cudaMalloc of its own (PYTORCH_NO_CUDA_MEMORY_CACHING, so
    memcheck sees a read past a tensor's end) and modules loaded lazily.
    Returns the tool's rc, its ERROR SUMMARY count, the error records
    between each kernel's markers (by launch-count name) and outside any,
    their first lines, the child's launches and the wall time."""
    import re

    exe = compute_sanitizer_path()
    check(exe is not None, "[san] compute-sanitizer not found")
    env = dict(os.environ, PYTORCH_NO_CUDA_MEMORY_CACHING="1", CUDA_MODULE_LOADING="LAZY")
    t0 = time.perf_counter()
    with tempfile.TemporaryFile("w+") as out:
        rc = subprocess.run([exe, "--tool", tool, "--error-exitcode", "99", sys.executable,
                             str(SAN_SCRIPT), "--san-kernels"], cwd=san_port_root(), env=env,
                            stdout=out, stderr=subprocess.STDOUT, timeout=timeout).returncode
        out.seek(0)
        text = out.read()
    res = {"tool": tool, "rc": rc, "summary": None, "errors": {k: 0 for k in SAN_KERNELS},
           "outside": 0, "records": [], "launches": None, "seconds": time.perf_counter() - t0,
           "tail": text[-3000:]}
    current = None
    for line in text.splitlines():
        if line.startswith(SAN_MARK):
            word, _, rest = line[len(SAN_MARK):].partition(" ")
            current = rest if word == "begin" else None
            if word == "done":
                res["launches"] = json.loads(rest)
            continue
        m = re.match(r"=+ ERROR SUMMARY: (\d+) error", line)
        if m:
            res["summary"] = int(m.group(1))
        if re.match(r"=+ \S", line) and not any(w in line for w in SAN_TOOL_INFO):
            if current is None:
                res["outside"] += 1
            else:
                res["errors"][current] += 1
            if len(res["records"]) < 40:
                res["records"].append(f"{current or 'outside'}: {line}")
    return res


def san_kernel_failures(res: dict) -> list:
    """What fails a tool's run: an rc but 0, an ERROR SUMMARY above 0 (or
    none), an error record anywhere, or a child that did not finish."""
    out = []
    if res["rc"] != 0 or res["summary"] != 0 or res["outside"] or any(res["errors"].values()):
        out.append(f"{res['tool']}: rc {res['rc']}, ERROR SUMMARY {res['summary']}, by kernel "
                   f"{ {SAN_KERNELS[k]: n for k, n in res['errors'].items() if n} }, outside "
                   f"{res['outside']}\n" + "\n".join(res["records"]) + "\n" + res["tail"])
    elif res["launches"] is None:
        out.append(f"{res['tool']}: the child did not finish\n{res['tail']}")
    return out


def san_host_phase(card: str) -> float:
    """(a): the five stresses under ThreadSanitizer and the malformed bodies
    under AddressSanitizer, all at once, SAN_HOST_SECONDS of load each; the
    malformed bodies' answers and decodes held to this process's plain
    front and codec.  Returns the wall time."""
    from concurrent.futures import ThreadPoolExecutor

    from gubernator_tpu_torch.core import native_plane
    from gubernator_tpu_torch.net import h2_fast, wire_codec
    from gubernator_tpu_torch.ops import native_build
    from gubernator_tpu_torch.service import COLUMNAR_DISQUALIFIERS

    t0 = time.perf_counter()
    for mode in SAN_REPORT:
        check(native_build.sanitizer_preload(mode) is not None,
              f"[san] g++ -print-file-name finds no {SAN_REPORT[mode]} runtime")
    # Built here, once: the stresses below start together in this process,
    # and two builds of one library at once would share a temporary file.
    native_build.build_all(SAN_HOST_LIBS, san="thread")
    native_build.build_all(SAN_HOST_LIBS, san="address")
    bodies = malformed_bodies(SEED)
    answers, decoded = san_expected(
        bodies, h2_fast.load(), native_plane, native_build.WINDOW_CALLBACK, COLUMNAR_DISQUALIFIERS,
        lambda b: wire_codec.decode_reqs(b, 1000, COLUMNAR_DISQUALIFIERS))
    runs = [("thread", s, None) for s in SAN_STRESSES] + [("address", "malformed", bodies)]
    with ThreadPoolExecutor(len(runs)) as pool:
        results = list(pool.map(lambda r: san_host_stress(r[0], r[1], SAN_HOST_SECONDS,
                                                          bodies=r[2]), runs))
    failures = []
    for res in results:
        failures += san_host_failures(res)
        if res["stress"] == "malformed":
            failures += san_malformed_failures(res, answers, decoded)
        load = "; ".join(f"{k} {r} RPCs" for k, (r, _e) in res["load"].items())
        log(f"[san host] {res['stress']} under {SAN_REPORT[res['mode']]}: rc {res['rc']}, "
            f"report {'yes' if res['report'] else 'none'}, {res['seconds']:.1f} s; "
            f"{json.dumps(res['ok'])}{'; load ' + load if load else ''}")
    check(not failures, "[san] host stresses failed:\n" + "\n".join(failures))
    log(f"[san host] 5 stresses under ThreadSanitizer and {len(bodies)} malformed bodies under "
        f"AddressSanitizer (answers and decodes equal to the plain front's and codec's): no "
        f"report, in {time.perf_counter() - t0:.1f} s | {card}")
    return time.perf_counter() - t0


def san_kernel_phase(card: str) -> float:
    """(b): the four tools over the kernel child, all at once.  Returns the
    wall time."""
    from concurrent.futures import ThreadPoolExecutor

    t0 = time.perf_counter()
    exe = compute_sanitizer_path()
    check(exe is not None, "[san] compute-sanitizer not found ($CUDA_HOME/bin, "
          "/usr/local/cuda/bin, PATH)")
    version = subprocess.run([exe, "--version"], capture_output=True, text=True,
                             timeout=60).stdout.strip().splitlines()
    log(f"[san kernels] {exe}: {' '.join(version[-2:])}")
    with ThreadPoolExecutor(len(SAN_TOOLS)) as pool:
        results = list(pool.map(san_kernel_tool, SAN_TOOLS))
    failures = []
    for res in results:
        failures += san_kernel_failures(res)
        log(f"[san kernels] {res['tool']}: rc {res['rc']}, ERROR SUMMARY {res['summary']}, "
            "errors by kernel " + json.dumps({SAN_KERNELS[k]: n for k, n in res["errors"].items()})
            + f", outside any kernel {res['outside']}, launches {json.dumps(res['launches'])}, "
            f"{res['seconds']:.1f} s | {card}")
    check(not failures, "[san] compute-sanitizer reports:\n" + "\n".join(failures))
    return time.perf_counter() - t0


def has_san() -> bool:
    """The driven port builds sanitized host libraries (a --tree checkout
    from before does not)."""
    from gubernator_tpu_torch.ops import native_build

    return hasattr(native_build, "sanitizer_preload")


def phase_san(torch, card: str) -> None:
    """The san phase: (a) the host stresses; then the kernel cases that (b)
    runs under compute-sanitizer (`--san kernels`), here without the tool,
    which refuses the card's machine ("Error: Device not supported"), so
    that they stay ready for a machine where it runs."""
    t0 = time.perf_counter()
    t_host = san_host_phase(card)
    t1 = time.perf_counter()
    san_child_kernels(marks=False)
    torch.cuda.empty_cache()
    log(f"[san kernels] K1-K17 at the compute-sanitizer child's small shapes, each bit-equal to "
        f"its plain version, in {time.perf_counter() - t1:.1f} s (the tools themselves: "
        f"--san kernels)")
    log(f"[san] host stresses {t_host:.1f} s: the san phase took {time.perf_counter() - t0:.1f} s "
        f"| {card}")


def main() -> int:
    global TREE
    ap = argparse.ArgumentParser(description="Smoke run of gubernator_tpu_torch on one GPU.")
    ap.add_argument("--tree", help="root of another checkout whose port to drive "
                    "(default: this script's own)")
    ap.add_argument("--readings", nargs="?", const="k2k5", choices=("k2k5", "k11"),
                    help="only the readings of a parent / change comparison, and no result "
                    "lines: k2k5 (the default) holds and times a restoring round's clears and "
                    "restores at every reading, times K1 and K3, and the restore streams' "
                    "walls; k11 holds and times K11 over 1-8 rounds and K12 at four widths, "
                    "and sharded path (b)'s dataclass route")
    ap.add_argument("--san", nargs="?", const="host", choices=("host", "kernels"),
                    help="only the build and one half of the san phase, and no result lines: "
                    "host (the default) runs the host C++'s stresses under ThreadSanitizer and "
                    "AddressSanitizer; kernels runs compute-sanitizer's memcheck, racecheck, "
                    "synccheck and initcheck over K1-K17")
    ap.add_argument("--san-host", metavar="STRESS", help=argparse.SUPPRESS)
    ap.add_argument("--san-seconds", type=float, default=3.0, help=argparse.SUPPRESS)
    ap.add_argument("--san-dir", help=argparse.SUPPRESS)
    ap.add_argument("--san-kernels", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.san_host:
        return san_host_child(args.san_host, args.san_seconds, Path(args.san_dir))
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
    # The paged and the sharded phases draw from generators of their own,
    # so every other phase sees the inputs it sees on a tree without them
    # (--tree A/B).
    paged_rng = np.random.default_rng(SEED + 9)
    shard_rng = np.random.default_rng(SEED + 10)
    split_rng = np.random.default_rng(SEED + 11)
    ab_rng = np.random.default_rng(SEED + 12)
    obs_rng = np.random.default_rng(SEED + 13)
    metrics_rng = np.random.default_rng(SEED + 14)
    cluster_rng = np.random.default_rng(SEED + 15)
    if args.san_kernels:
        return san_child_kernels()
    card = phase_device(torch)
    phase_build()
    if args.san:
        check(has_san(), "the port has no sanitizer builds")
        (san_host_phase if args.san == "host" else san_kernel_phase)(card)
        return 0
    errs = {k: 0 for k in (*fs.launches, *getattr(fs, "split_launches", {}))}
    if args.readings == "k2k5":
        return readings_k2k5(torch, np, rng, card, errs)
    if args.readings:
        return readings(torch, np, rng, card, errs)
    phase_kernels(torch, np, rng, errs)
    phase_k2(torch, np, rng, errs)
    # A --tree checkout from before the persistence slice has no K5 / K6.
    has_persist = "load_slots" in fs.launches
    if has_persist:
        phase_persist_kernels(torch, np, rng, errs)
    else:
        check(TREE is not None, "the port has no persistence path")
        log(f"[persist] {TREE} has no K5 / K6: the persistence phases are skipped")
    # ... and one from before the sketch slice has no K7 / K8.
    has_sketch = "sketch_step" in fs.launches
    # ... and one from before the h2 slice has no h2 front.
    has_h2 = importlib.util.find_spec("gubernator_tpu_torch.net.h2_fast") is not None
    if has_sketch:
        phase_sketch_kernels(torch, np, rng, errs)
    else:
        check(TREE is not None, "the port has no sketch path")
        log(f"[sketch] {TREE} has no K7 / K8: the sketch phases are skipped")
    # ... and one from before the paged slice has no K9 / K10.
    has_paged = has_paging()
    if has_paged:
        phase_paged_kernels(torch, np, paged_rng, errs)
    else:
        check(TREE is not None, "the port has no paged path")
        log(f"[paged] {TREE} has no K9 / K10: the paged phases are skipped")
    # ... and one from before the sharded slice has no K11-K13.
    has_sharded = has_sharding()
    if has_sharded:
        phase_shard_kernels(torch, np, shard_rng, errs)
    else:
        check(TREE is not None, "the port has no sharded engine")
        log(f"[sharded] {TREE} has no sharded engine: the sharded phases are skipped")
    # ... and one from before the split arm has no K14-K16.
    split = has_split()
    if split:
        phase_split_kernels(torch, np, split_rng, errs)
    else:
        check(TREE is not None, "the port has no split arm")
        log(f"[split] {TREE} has no split arm: the split phases are skipped")
    # ... and one from before K17 has no dataclass step, nor the obs path.
    has_ab, obs = has_apply_batch(), has_obs()
    if has_ab:
        phase_apply_batch_kernels(torch, np, ab_rng, errs)
    else:
        check(TREE is not None, "the port has no dataclass step (K17)")
        log(f"[k17] {TREE} has no K17: the apply_batch phases are skipped")
    check(obs or TREE is not None, "the port has no observability path")

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

    # ---- the persistence path (store, checkpoint, sweep, the daemon's
    # loader and sweep thread): counts from 0 just before, read just after.
    persist_launches = {k: 0 for k in fs.launches}
    if has_persist:
        fs.reset_launches()
        with tempfile.TemporaryDirectory() as tmp:
            p_engines, p_times = phase_persist(torch, np, rng, Path(tmp))
        persist_launches = dict(fs.launches)
        p_disp = sum(e.dispatches_total for e in p_engines)
        p_win, p_groups = sweep_counts(p_engines)
        log(f"[persist] launches {persist_launches}; engine launches {p_disp} + sweep launches "
            f"{p_groups} ({p_win} windows)")
        check(sum(persist_launches.values()) == p_disp + p_groups
              and persist_launches["sweep_window"] == p_groups,
              "every engine launch of the persistence path must be a K1, K2, K5 or K6 launch, "
              "and every K6 launch a sweep group")
        check_grouped(p_win, p_groups, "persistence")
        for name in ("fused_step", "clear_occupied", "load_slots", "sweep_window"):
            check(persist_launches[name] > 0, f"the persistence path must launch {name}")
        check(persist_launches["collapsed_step"] == persist_launches["uniform_step"] == 0,
              "the persistence path (a store attached) neither collapses nor takes the "
              "uniform format")
        for e in p_engines:
            e.close()
        del p_engines
        torch.cuda.empty_cache()

    # ---- the sketch path (V1Instance and the daemon with SKETCH, GLOBAL and
    # MULTI_REGION items): counts from 0 just before, read just after.
    sketch_launches = {k: 0 for k in fs.launches}
    if has_sketch:
        fs.reset_launches()
        applies = phase_sketch_stream(torch, np, rng) + phase_sketch_http(torch, np, rng)
        sketch_launches = dict(fs.launches)
        log(f"[sketch] launches {sketch_launches}; {applies} sketch applies on the card")
        check(sketch_launches["sketch_step"] == applies,
              "the sketch path must launch K7 exactly once per apply with sketch items")
        sketch_forms = getattr(fs, "forms", {}).get("sketch_step")
        if sketch_forms is not None:
            # One device launch a call in the block form, two in the pair form.
            log(f"[sketch] K7 calls by form {sketch_forms}: "
                f"{sketch_forms['block'] + 2 * sketch_forms['pair']} device launches for "
                f"{applies} calls")
            check(sum(sketch_forms.values()) == applies,
                  "every K7 call of the sketch path must count under one form")
            check(sketch_forms["block"] > 0 and sketch_forms["pair"] > 0,
                  "the sketch path's small and 1000-item batches must take K7's block and pair "
                  "forms")
        check(sketch_launches["sketch_rotate"] > 0, "the sketch path must launch K8")
        torch.cuda.empty_cache()

    # ---- the h2 path (the native h2 front into apply_columnar): counts
    # from 0 just before each feeder mode, read just after it; the kernels
    # line sums the modes.
    h2_launches = {k: 0 for k in fs.launches}
    h2_read = None
    if has_h2:
        h2_by_mode, h2_disp, h2_read, (h2_windows, h2_rpcs) = phase_h2(torch, np, rng, card)
        for mode, got in h2_by_mode.items():
            log(f"[h2, {mode}] launches {got}; engine launches {h2_disp[mode]} | {card}")
            check(got["fused_step"] + got["collapsed_step"] + got["uniform_step"]
                  == h2_disp[mode] == sum(got.values()),
                  f"every engine launch of the h2 path, {mode}, must be a K1, K3 or K4 launch")
            for name in ("fused_step", "collapsed_step", "uniform_step"):
                check(got[name] > 0, f"the h2 path, {mode}, must launch {name}")
            for name in h2_launches:
                h2_launches[name] += got[name]
        log(f"[h2] launches {h2_launches}; {h2_windows} byte windows for {h2_rpcs} RPCs "
            f"({h2_windows / h2_rpcs:.4f} byte windows per RPC) | {card}")
        for mode, r in h2_read.items():
            log(f"[h2 readings] {mode}: " + "; ".join(
                f"{tag} {x['rps']:.1f} RPCs/s, p50 {x['p50']:.3f} ms, p99 {x['p99']:.3f} ms"
                for tag, x in (("herd", r["herd"]), ("1000-item, 2 ms window", r["2 ms window"]),
                               ("1000-item, no window", r["no window"]))) + f" | {card}")
        torch.cuda.empty_cache()
    else:
        check(TREE is not None, "the port has no h2 front")
        log(f"[h2] {TREE} has no h2 front: the h2 phases are skipped")

    # ---- the ledger path (the decision ledger and its native plane, the
    # reference's default hot-key path): counts from 0 just before, read
    # just after.
    ledger_launches = {k: 0 for k in fs.launches}
    if has_ledger():
        fs.reset_launches()
        l_engines, l_captured, l_read = phase_ledger(torch, np, rng, card)
        ledger_launches = dict(fs.launches)
        l_disp = sum(e.dispatches_total for e in l_engines)
        log(f"[ledger] launches {ledger_launches}; engine launches {l_disp} | {card}")
        check(ledger_launches["fused_step"] + ledger_launches["collapsed_step"]
              + ledger_launches["uniform_step"] == l_disp == sum(ledger_launches.values()),
              "every engine launch of the ledger path must be a K1, K3 or K4 launch")
        check(ledger_launches["fused_step"] > 0, "the ledger path must launch fused_step")
        for e in l_engines:
            e.close()
        del l_engines
        # Outside the counted run: the hold's own launches do not count.
        hold_ledger_k1(torch, errs, l_captured)
        del l_captured
        on, off = l_read["ledger on"], l_read["GUBER_LEDGER=0"]
        log(f"[ledger herd] ledger on / GUBER_LEDGER=0: {on[0]:.0f} / {off[0]:.0f} RPCs/s, p50 "
            f"{on[1]:.3f} / {off[1]:.3f} ms, p99 {on[2]:.3f} / {off[2]:.3f} ms, answered in C "
            f"{on[3]:.4f} / {off[3]:.4f} | {card}")
        torch.cuda.empty_cache()
    else:
        check(TREE is not None, "the port has no decision ledger")
        log(f"[ledger] {TREE} has no decision ledger: the ledger phases are skipped")

    # ---- the paged path (paged state with the page spill K9 and the refill
    # K10): counts from 0 just before, read just after.
    paged_launches = {k: 0 for k in fs.launches}
    zipf_k = 0
    if has_paged:
        fs.reset_launches()
        pg_engines, pg_per_batch, pg_read = phase_paged(torch, np, paged_rng, card)
        paged_launches = dict(fs.launches)
        pg_disp = sum(e.dispatches_total for e in pg_engines)
        pg_win, pg_groups = sweep_counts(pg_engines)
        log(f"[paged] launches {paged_launches}; engine launches {pg_disp} + sweep launches "
            f"{pg_groups} ({pg_win} windows) | {card}")
        check(sum(paged_launches.values()) == pg_disp + pg_groups
              and paged_launches["sweep_window"] == pg_groups,
              "every launch of the paged path must be an engine launch or a sweep group")
        # The paged sweeps cover one window each (65,536 resident rows).
        check_grouped(pg_win, pg_groups, "paged", multi=False)
        page_kernels = ("gather_pages", "load_pages")
        for name in page_kernels + ("collapsed_step", "uniform_step", "load_slots",
                                    "sweep_window"):
            check(paged_launches[name] > 0, f"the paged path must launch {name}")
        check(all(pg_read["launched"][k] > 0 for k in page_kernels),
              "the full-width zipf stream must spill and refill")
        batches = sum(e.paging.fault_batches for e in pg_engines if e.paging is not None)
        check(paged_launches["load_pages"] == batches,
              f"the paged path must launch one K10 a fault batch ({paged_launches['load_pages']} "
              f"K10 launches, {batches} fault batches)")
        log(f"[paged] {batches} fault batches, page launches "
            f"{ {k: paged_launches[k] for k in page_kernels} } | {card}")
        zipf_k = int(statistics.median([k for k in pg_per_batch if k > 0]))
        for e in pg_engines:
            e.close()
        del pg_engines
        torch.cuda.empty_cache()

    # ---- the sharded path (the sharded engine with its per-shard steps K11
    # / K12 and sweep K13, the flat K1 / K3, the daemon with
    # GUBER_DEVICE_COUNT): counts from 0 just before, read just after.
    shard_launches = {k: 0 for k in fs.launches}
    sh_captured = None
    if has_sharded:
        fs.reset_launches()
        sh_engines, sh_captured, sh_read = phase_sharded(torch, np, shard_rng, card)
        shard_launches = dict(fs.launches)
        sh_disp = sum(e.dispatches_total for e in sh_engines)
        sh_win, sh_groups = sweep_counts(sh_engines)
        log(f"[sharded] launches {shard_launches}; engine launches {sh_disp} + sweep launches "
            f"{sh_groups} ({sh_win} windows) | {card}")
        check(sum(shard_launches.values()) == sh_disp + sh_groups
              and shard_launches["sweep_window"] + shard_launches["shard_sweep"] == sh_groups,
              "every launch of the sharded path must be an engine launch or a sweep group")
        check_grouped(sh_win, sh_groups, "sharded")
        for name in ("shard_step", "shard_collapsed", "shard_sweep", "fused_step",
                     "collapsed_step", "load_slots"):
            check(shard_launches[name] > 0, f"the sharded path must launch {name}")
        for e in sh_engines:
            e.close()
        del sh_engines
        torch.cuda.empty_cache()

    # ---- the split path (GUBER_FUSED=split: a round's clears, K14, K15; a
    # collapsed chunk's K16, K15): counts from 0 just before, read just
    # after; the fused engines it is compared with run after the reading.
    split_path = {k: 0 for k in fs.launches}
    split_counts = {}
    if split:
        fs.reset_launches()
        sp_engines, sp_record = phase_split(torch, np, split_rng, card)
        split_path, split_counts = dict(fs.launches), dict(fs.split_launches)
        sp_disp = sum(e.dispatches_total for e in sp_engines)
        sp_rounds = sum(e.rounds_total for e in sp_engines)
        log(f"[split] launches {split_counts} and {split_path}; engine launches {sp_disp} for "
            f"{sp_rounds} rounds ({sp_disp / sp_rounds:.2f} a round) | {card}")
        check(sum(split_counts.values()) + sum(split_path.values()) == sp_disp,
              "every launch of the split path must be an engine launch")
        check(split_path["fused_step"] == split_path["collapsed_step"]
              == split_path["uniform_step"] == 0, "the split path must launch no fused kernel")
        for name in split_counts:
            check(split_counts[name] > 0, f"the split path must launch {name}")
        check(split_counts["scatter_store"]
              == split_counts["packed_compute"] + split_counts["collapsed_compute"],
              "every K14 and K16 launch of the split path must be followed by one K15")
        for name in ("clear_occupied", "load_slots", "gather_pages", "load_pages"):
            check(split_path[name] > 0, f"the split path must launch {name}")
        for e in sp_engines:
            e.close()
        del sp_engines
        torch.cuda.empty_cache()
        split_vs_fused(torch, np, sp_record, card)
        del sp_record
        split_rates(torch, np, split_rng, card)

    # ---- the apply_batch path (the public dataclass step, K17): counts
    # from 0 just before, read just after.
    ab_path = {k: 0 for k in fs.launches}
    if has_ab:
        fs.reset_launches()
        n_ab = phase_apply_batch_path(torch, np, ab_rng)
        ab_path = dict(fs.launches)
        log(f"[apply_batch] launches {ab_path} | {card}")
        check(ab_path["apply_batch"] == n_ab == sum(ab_path.values()),
              "the apply_batch path must launch K17 once a batch, and nothing else")
        torch.cuda.empty_cache()

    # ---- the obs path (tracing, the tail recorder, the event ring, the
    # hot-key sketch, the SLO watchdog and the debug routes on the daemon's
    # HTTP and h2 fronts): counts from 0 just before, read just after; the
    # off / on rates after the reading.
    obs_path = {k: 0 for k in fs.launches}
    if obs:
        fs.reset_launches()
        o_engines = phase_obs(torch, np, obs_rng, card)
        obs_path = dict(fs.launches)
        o_disp = sum(e.dispatches_total for e in o_engines)
        log(f"[obs] launches {obs_path}; engine launches {o_disp} | {card}")
        check(obs_path["fused_step"] + obs_path["collapsed_step"] + obs_path["uniform_step"]
              == o_disp == sum(obs_path.values()),
              "every engine launch of the obs path must be a K1, K3 or K4 launch")
        for name in ("fused_step", "collapsed_step"):
            check(obs_path[name] > 0, f"the obs path must launch {name}")
        del o_engines
        torch.cuda.empty_cache()
        obs_rates(torch, np, obs_rng, card)

    # ---- the metrics path (/metrics, ?exemplars=1, ?fleet=1 on the gateway
    # and the status listener, after the mixed and the zipf streams over
    # HTTP and h2): counts from 0 just before, read just after; the scrapes
    # themselves launch nothing (checked scrape by scrape).
    metrics_path = {k: 0 for k in fs.launches}
    if has_metrics():
        fs.reset_launches()
        m_engines = phase_metrics(torch, np, metrics_rng, card)
        metrics_path = dict(fs.launches)
        m_disp = sum(e.dispatches_total for e in m_engines)
        log(f"[metrics] launches {metrics_path}; engine launches {m_disp} | {card}")
        check(metrics_path["fused_step"] + metrics_path["collapsed_step"]
              + metrics_path["uniform_step"] == m_disp == sum(metrics_path.values()),
              "every engine launch of the metrics path must be a K1, K3 or K4 launch")
        for name in ("fused_step", "collapsed_step"):
            check(metrics_path[name] > 0, f"the metrics path must launch {name}")
        del m_engines
        torch.cuda.empty_cache()
    else:
        check(TREE is not None, "the port has no /metrics")
        log(f"[metrics] {TREE} has no /metrics: the metrics phase is skipped")

    # ---- the cluster path (two daemons with static peers: owners answer,
    # the other node forwards over the port's gRPC wire): counts from 0
    # just before, read just after; each node's K1 / K3 / K4 counted apart.
    cluster_path = {k: 0 for k in fs.launches}
    if has_cluster():
        fs.reset_launches()
        c_engines, c_by_node, c_read = phase_cluster(torch, np, cluster_rng, card)
        cluster_path = dict(fs.launches)
        c_disp = sum(e.dispatches_total for e in c_engines)
        log(f"[cluster] launches {cluster_path}; engine launches {c_disp} | {card}")
        check(cluster_path["fused_step"] + cluster_path["collapsed_step"]
              + cluster_path["uniform_step"] == c_disp == sum(cluster_path.values()),
              "every engine launch of the cluster path must be a K1, K3 or K4 launch")
        for name in ("fused_step", "collapsed_step", "uniform_step"):
            check(0 < sum(n[name] for n in c_by_node) <= cluster_path[name],
                  f"the cluster path's per-node {name} counts must be within its launches")
        del c_engines
        torch.cuda.empty_cache()
    else:
        check(TREE is not None, "the port has no cluster path")
        log(f"[cluster] {TREE} has no gRPC listener: the cluster phase is skipped")

    phase_daemon_binary(has_h2)
    times = phase_timing(torch, np, rng, card, k3_calls, k4_calls)
    if has_persist:
        times.update({f"p_{k}": v for k, v in phase_persist_timing(torch, np, rng, card).items()})
    if has_sketch:
        times.update({f"s_{k}": v for k, v in phase_sketch_timing(torch, np, rng, card).items()})
    if has_paged:
        times.update({f"pg_{k}": v for k, v in phase_paged_timing(
            torch, np, paged_rng, card, zipf_k, pg_read["rates"]).items()})
    if has_sharded:
        times.update({f"sh_{k}": v for k, v in phase_sharded_timing(torch, np, shard_rng, card,
                                                                   sh_captured).items()})
    if split:
        times.update({f"sp_{k}": v for k, v in time_split(torch, np, split_rng, card).items()})
        times["cr"] = time_clear_restore(torch, np, split_rng, card)
    if has_ab:
        times["ab_k17"] = time_apply_batch(torch, np, ab_rng, card)
    log(f"[time] HTTP GetRateLimits on the card: {http_rate:.0f} decisions/s | {card}")
    phase_rates(torch, np, rng, card)
    # ---- the san phase: sanitizer runs of the port's own native code.
    if has_san():
        phase_san(torch, card)
    else:
        check(TREE is not None, "the port has no sanitizer builds")
        log(f"[san] {TREE} has no sanitizer builds: the san phase is skipped")

    # K1's row: one launch over a real 5-round batch (the engine's typical
    # launch); the R = 1 figures are in the [done] line.
    rows = [
        ("fused_step", "fused_step.cu", "gubernator_tpu/ops/pallas_step.py:67", times["r5"]),
        ("clear_occupied", "clear_occupied.cu",
         "gubernator_tpu/ops/bucket_kernel.py:329", times["k2"]),
        ("collapsed_step", "collapsed_step.cu", "gubernator_tpu/ops/bucket_kernel.py:1417",
         times["k3"]),
        ("uniform_step", "fused_step.cu", "gubernator_tpu/ops/bucket_kernel.py:1161",
         times["k4"]),
    ]
    # K6's and K13's rows: the launch the engines make, a group of 16
    # windows of 2^17 (on a port from before the groups, one window).
    grouped = has_persist and has_sweep_groups()
    if has_persist:
        # K5's row: one 4096-record restore at 10^8 slots; K6's: a group at
        # 10^8 slots.
        rows += [
            ("load_slots", "load_slots.cu", "gubernator_tpu/ops/bucket_kernel.py:1526",
             times["p_k5"]),
            ("sweep_window", "sweep.cu", "gubernator_tpu/ops/expiry.py:40",
             times["p_k6_group" if grouped else "p_k6"]),
        ]
    if has_sketch:
        # K7's row: one call on a 1000-key batch at the daemon's default
        # width 2^20; K8's: one plane at 2^20, beside zero_() on it.
        rows += [
            ("sketch_step", "sketch.cu", "gubernator_tpu/ops/sketch.py:99",
             times[f"s_k7_{SKETCH_WIDTH}_{BATCH}"]),
            ("sketch_rotate", "sketch.cu", "gubernator_tpu/ops/sketch.py:63",
             times[f"s_k8_{SKETCH_WIDTH}"]),
        ]
    if has_paged:
        # K9's and K10's rows: one launch of 16 pages of 512 rows, the faults
        # of each fill batch of the full-width paged stream.
        rows += [
            ("gather_pages", "page_words.cu", "gubernator_tpu/ops/bucket_kernel.py:1596",
             times["pg_k9"]),
            ("load_pages", "page_words.cu", "gubernator_tpu/ops/bucket_kernel.py:1612",
             times["pg_k10"]),
        ]
    if has_sharded:
        # K11's and K12's rows: the median launch of the full-size path's
        # 1000-item V1Instance batches (4 shards of 2.5 x 10^7); K13's: a
        # group over those shards.
        rows += [
            ("shard_step", "sharded_step.cu",
             "gubernator_tpu/parallel/sharded_engine.py:339", times["sh_shard_step"]),
            ("shard_collapsed", "sharded_step.cu",
             "gubernator_tpu/parallel/sharded_engine.py:351", times["sh_shard_collapsed"]),
            ("shard_sweep", "sweep.cu", "gubernator_tpu/parallel/sharded_engine.py:727",
             times["sh_shard_sweep_group" if grouped else "sh_shard_sweep"]),
        ]
    if split:
        # K14's row: one launch on a mixed batch of 1000 at 2^20; K15's: one
        # on K14's words; K16's: one on a zipf chunk of 8192 at 2^24.
        rows += [
            ("packed_compute", "split_step.cu", "gubernator_tpu/ops/bucket_kernel.py:1246",
             times["sp_k14"] + (None,)),
            ("scatter_store", "split_step.cu", "gubernator_tpu/ops/bucket_kernel.py:815",
             times["sp_k15_k14"] + (None,)),
            ("collapsed_compute", "split_step.cu", "gubernator_tpu/ops/bucket_kernel.py:1425",
             times["sp_k16"] + (None,)),
        ]
    if has_ab:
        # K17's row: one launch on the apply_batch path's shape, 1000 lanes
        # padded to 1024 with 41 clears at 2^20; no single PyTorch call
        # computes the step.
        rows.append(("apply_batch", "apply_batch.cu", "gubernator_tpu/ops/bucket_kernel.py:356",
                     times["ab_k17"] + (None,)))
    paths = (main_launches, persist_launches, sketch_launches, h2_launches, ledger_launches,
             paged_launches, shard_launches, split_path, split_counts, ab_path, obs_path,
             metrics_path, cluster_path)

    # launches: the main path's run plus the persistence path's, the
    # sketch path's, the h2 path's, the ledger path's, the paged path's,
    # the sharded path's and the split path's, each counted from 0 (K2 and
    # K5 on the persistence, the paged, the sharded and the split paths,
    # K6 on the second and the paged, K7 and K8 on the third only, K9 and
    # K10 on the paged and the split, K11-K13 on the sharded only, K14-K16
    # on the split only, K17 on the apply_batch path only; the obs, the
    # metrics and the cluster paths launch K1, K3 and K4).
    kernels = {"kernels": [
        {"name": name, "route": "cuda", "source": f"gubernator_tpu_torch/csrc/{src}",
         "replaces": replaces,
         "launches": sum(path.get(name, 0) for path in paths),
         "max_abs_err": errs[name],
         "ms": t[0], "plain_ms": t[1], "bound_ms": t[2], "bound_by": "bytes",
         "library_ms": t[3] if len(t) > 3 else None}
        for name, src, replaces, t in rows
    ]}
    log(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s "
        f"(K1 R=1 W=1024: {times[1024][0] * 1e3:.2f} us, W=8192: {times[8192][0] * 1e3:.2f} us; "
        f"K1 per 5-round batch {times['r5'][0] * 1e3:.2f} us (the kernels line's ms); "
        f"K3 one-key {times['k3_one'][0] * 1e3:.2f} us, spread {times['k3_zipf'][0] * 1e3:.2f} "
        f"us, with clears {times['k3_foreign'][0] * 1e3:.2f} us; K4 joined R=2 {times['k4_r2'][0] * 1e3:.2f} "
        f"us, R=16 {times['k4_r16'][0] * 1e3:.2f} us; "
        f"launch floor {times['floor'] * 1e3:.2f} us"
        + (f"; K5 {times['p_k5'][0] * 1e3:.2f} us per 4096 records, K6 "
           f"{times['p_k6'][0] * 1e3:.2f} us per 2^17 window, "
           f"{times['p_k6_group'][0] * 1e3:.2f} us per group of 16, a 16-window tick at 10^8 "
           f"{times['p_tick'] * 1e3:.2f} ms ({times['p_tick_trace'][0]} device operations, "
           f"{times['p_tick_trace'][1] * 1e3:.2f} us), an idle tick at 2^20 "
           f"{times['p_idle_tick'][1]:.3f} ms" if has_persist else "")
        + (f"; K7 {times[f's_k7_{SKETCH_WIDTH}_{BATCH}'][0] * 1e3:.2f} us per 1000-key batch, "
           f"K8 {times[f's_k8_{SKETCH_WIDTH}'][0] * 1e3:.2f} us per 2^20-wide plane"
           if has_sketch else "")
        + (f"; K9 / K10 {times['pg_k9'][0] * 1e3:.2f} / {times['pg_k10'][0] * 1e3:.2f} us per "
           f"16 pages of 512" if has_paged else "")
        + (f"; K11 / K12 {times['sh_shard_step'][0] * 1e3:.2f} / "
           f"{times['sh_shard_collapsed'][0] * 1e3:.2f} us per 1000-item batch over 4 shards, K13 "
           f"{times['sh_shard_sweep'][0] * 1e3:.2f} us per 2^17 window of 4 shards, "
           f"{times['sh_shard_sweep_group'][0] * 1e3:.2f} us per group of 16"
           if has_sharded else "")
        + (f"; K14 / K15 / K16 {times['sp_k14'][0] * 1e3:.2f} / "
           f"{times['sp_k15_k14'][0] * 1e3:.2f} / {times['sp_k16'][0] * 1e3:.2f} us; a restoring "
           f"round of 1000 clears and 4096 records at 10^8 "
           f"{times['cr']['1000 clears, 4096 records, cap 10^8'][0] * 1e3:.2f} us"
           if split else "")
        + (f"; K17 {times['ab_k17'][0] * 1e3:.2f} us per 1000-lane batch with 41 clears"
           if has_ab else "") + ")")
    print(json.dumps(kernels))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
