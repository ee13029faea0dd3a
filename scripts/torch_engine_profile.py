#!/usr/bin/env python3
"""Where a batch's wall time goes in the port's engine on one GPU.

    python3 scripts/torch_engine_profile.py [--batches N] [--streams h2,...]

Drives three of chip_smoke.py's streams (mixed: 2^20 slots, batches of
1000; zipf: the reference's zipf deployment, 2^24 slots, batches of
8192; uniform: one config per batch of 1000) synchronously through
`DecisionEngine.apply_columnar` on the card, and splits each batch's
wall time by host-tier step:

* schedule — the native intern table's `schedule` call;
* collapse — `_try_collapse`: the duplicate checks, packing, the copy to
  the card and the K3 launch;
* rounds — `_dispatch_rounds`: round split, packing, the pump submit;
* flush — the pump's flush: the copy to the card, the launch of K1 or
  K4 and the readback copy;
* readback — waiting for the output and turning it into numpy;
* rest — the remainder (Gregorian columns, the TTL mirror, unpacking).

A fourth stream, sketch, is chip_smoke.py's sketch stream: batches of
1000 GetRateLimits items (about 60 % SKETCH, 20 % GLOBAL, 20 % plain)
through `V1Instance.get_rate_limits` with the sketch at the daemon's
defaults (window 1 s, depth 4, width 2^20), split as:

* sketch_hash — the keys' fnv1a-64 and row indexes (`_indexes`);
* sketch_pack — the per-row duplicate combine into the pin (`pack_pin`);
* sketch_device — the rest of `SketchLimiter.apply`: the pin's copy to
  the card, K8 when the window moved, K7 and the output's readback;
* engine — the one engine call for the GLOBAL and plain items, the
  GLOBAL owner's read-back items at its tail;
* rest — validation, the request lists and the responses.

A fifth, h2, is chip_smoke.py's h2 loads on a daemon on the card (live
clock, 2^20 slots, its h2 front at the default 2 ms window), driven by
the port's native client (`core/h2_client.py bench_unary`) after a
0.5 s warm-up: the herd (32 connections of single-item RPCs on one key,
2 s), the same herd from one connection and through a second front on
the same instance with no window (and no decision plane: the daemon's
front keeps its own), and the 1000-item loop (one connection, one
1000-item leaky-bucket RPC, 3 s).  Each window's serve
(`H2FastFront._serve`, on the C dispatch thread) is split as:

* decode — the C wire decode (`net/wire_codec.py decode_reqs`);
* plan, lane, learn, merge — the decision ledger's steps, when the
  instance runs it (core/ledger.py: `DecisionLedger.plan`,
  `LedgerPlan.build_engine_lane`, `DecisionLedger._learn`,
  `LedgerPlan.merge_outputs`);
* schedule, collapse, rounds, flush, readback — the engine steps above;
* rest — `serve_decoded_local` and `apply_columnar` around them;

beside the window cycle (run time / windows: the 2 ms group-commit wait,
the serve, and the hand-off to and from the C threads), the RPCs/s and
the client's p50 / p99 latency, with the device's busy time and idle
share over the whole run.  The split is the same on a tree with no
ledger: its four steps then read 0, so one copy of this script times a
parent tree and its child alike.

`--streams` picks a comma-separated subset of mixed, zipf, uniform,
sketch and h2 (default: all five).

The first 4 batches of a stream are warm-up; the next half are timed
as above (medians per batch).  The rest run under `torch.profiler` (CUDA
activity) as one window, timed on the host clock from a synchronised
start to a synchronised end: the device's busy time is the sum of the
device time of every CUDA kernel and copy recorded in that window, and
its idle share is 1 - busy / wall over the same window.  Prints one line
per stream, then one JSON object.  Needs one card; imports nothing of
JAX.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from collections import defaultdict
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

STEPS = ("schedule", "collapse", "rounds", "flush", "readback")
STREAMS = ("mixed", "zipf", "uniform", "sketch", "h2")


def timer(step_s):
    """`timed(obj, name, key)` replaces `obj.name` with a wrapper that adds
    each call's wall time to `step_s[key]`."""

    def timed(obj, name, key):
        fn = getattr(obj, name)

        def wrapper(*a, **k):
            t = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                step_s[key] += time.perf_counter() - t

        setattr(obj, name, wrapper)

    return timed


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batches", type=int, default=40, help="batches per stream (default 40)")
    ap.add_argument("--streams", default=",".join(STREAMS),
                    help="comma-separated subset of " + ", ".join(STREAMS) + " (default: all)")
    args = ap.parse_args()
    streams = set(args.streams.split(","))
    if not streams <= set(STREAMS):
        ap.error(f"unknown streams {sorted(streams - set(STREAMS))}")

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_engine_profile: CUDA is not available", file=sys.stderr)
        return 2
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from gubernator_tpu_torch.clock import Clock
    from gubernator_tpu_torch.core import engine as engine_mod
    from gubernator_tpu_torch.core.readback import Ticket

    card = cs.phase_device(torch)
    step_s = defaultdict(float)
    timed = timer(step_s)
    timed(Ticket, "fetch", "readback")
    rng = np.random.default_rng(cs.SEED)
    report = {"card": card}
    for tag, cap, batches, _opts in cs.streams(np, rng, args.batches):
        if tag not in streams:
            continue
        eng = engine_mod.DecisionEngine(cap, clock=Clock().freeze_at(cs.NOW0 * 1_000_000),
                                        device="cuda", max_kernel_width=8192)
        timed(eng.table, "schedule", "schedule")
        timed(eng, "_try_collapse", "collapse")
        timed(eng, "_dispatch_rounds", "rounds")
        timed(eng._pump, "flush_locked", "flush")

        def run(keys, cols):
            eng.apply_columnar(keys, *cols)
            eng.clock.advance(ms=int(rng.integers(0, 2_000)))

        split = 4 + (len(batches) - 4) // 2
        rows = []
        for b, (keys, cols) in enumerate(batches[:split]):
            step_s.clear()
            torch.cuda.synchronize()
            t = time.perf_counter()
            run(keys, cols)
            wall = time.perf_counter() - t
            if b < 4:
                continue
            row = {k: step_s[k] * 1e6 for k in STEPS}
            row["rest"] = wall * 1e6 - sum(row.values())
            row["wall"] = wall * 1e6
            rows.append(row)
        n_prof = len(batches) - split
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t = time.perf_counter()
            for keys, cols in batches[split:]:
                run(keys, cols)
            torch.cuda.synchronize()
            window_us = (time.perf_counter() - t) * 1e6
        busy = [(e.key, e.self_device_time_total) for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
        busy_us = sum(t for _, t in busy) if busy else float("nan")
        med = {k: statistics.median(r[k] for r in rows) for k in rows[0]}
        med["decisions_per_s"] = len(batches[0][0]) / (med["wall"] * 1e-6)
        med["window"] = {"batches": n_prof, "wall_us": window_us, "busy_us": busy_us,
                         "idle_share": 1 - busy_us / window_us,
                         "busy_by_name_us": dict(busy)}
        report[tag] = med
        print(f"[{tag}] {len(rows)} batches of {len(batches[0][0])}: median per batch "
              + ", ".join(f"{k} {med[k]:.1f} us" for k in (*STEPS, "rest", "wall"))
              + f"; profiled window of {n_prof} batches: wall {window_us:.1f} us, device busy "
              f"{busy_us:.1f} us, idle share {1 - busy_us / window_us:.4f} | {card}",
              flush=True)
        eng.close()
    if "sketch" in streams:
        report["sketch"] = profile_sketch(torch, np, rng, card, args.batches, profile,
                                          ProfilerActivity, DeviceType)
    if "h2" in streams:
        report["h2"] = profile_h2(torch, np, rng, card, profile, ProfilerActivity, DeviceType)
    print(json.dumps(report))
    return 0


SKETCH_STEPS = ("sketch_hash", "sketch_pack", "sketch_device", "engine")


def profile_sketch(torch, np, rng, card, n_batches, profile, ProfilerActivity, DeviceType):
    """The sketch stream's split per batch and its profiled window (see
    the module docstring)."""
    import chip_smoke as cs
    from gubernator_tpu_torch.clock import Clock
    from gubernator_tpu_torch.core.engine import DecisionEngine
    from gubernator_tpu_torch.ops import sketch as ps
    from gubernator_tpu_torch.service import V1Instance

    inst = V1Instance(DecisionEngine(cs.CAP_SERVE, clock=Clock().freeze_at(cs.NOW0 * 1_000_000),
                                     device="cuda"))
    lim = inst.sketch()
    step_s = defaultdict(float)
    timed = timer(step_s)
    timed(lim, "_indexes", "sketch_hash")
    timed(ps, "pack_pin", "sketch_pack")
    timed(lim, "apply", "apply")
    timed(inst.engine, "get_rate_limits", "engine")
    pool = [b"api_g%d" % i for i in range(20_000)]
    batches = [cs.sketch_stream_batch(np, rng, pool) for _ in range(n_batches)]

    def run(b, reqs):
        inst.get_rate_limits(reqs)
        step = cs.SKETCH_STEPS[b % len(cs.SKETCH_STEPS)]
        inst.engine.clock.advance(ms=step)

    split = 4 + (n_batches - 4) // 2
    rows = []
    for b, reqs in enumerate(batches[:split]):
        step_s.clear()
        torch.cuda.synchronize()
        t = time.perf_counter()
        run(b, reqs)
        wall = time.perf_counter() - t
        if b < 4:
            continue
        row = {"sketch_hash": step_s["sketch_hash"], "sketch_pack": step_s["sketch_pack"],
               "sketch_device": step_s["apply"] - step_s["sketch_hash"] - step_s["sketch_pack"],
               "engine": step_s["engine"]}
        row = {k: v * 1e6 for k, v in row.items()}
        row["rest"] = wall * 1e6 - sum(row.values())
        row["wall"] = wall * 1e6
        rows.append(row)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t = time.perf_counter()
        for b, reqs in enumerate(batches[split:], start=split):
            run(b, reqs)
        torch.cuda.synchronize()
        window_us = (time.perf_counter() - t) * 1e6
    busy = [(e.key, e.self_device_time_total) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy_us = sum(t for _, t in busy) if busy else float("nan")
    med = {k: statistics.median(r[k] for r in rows) for k in rows[0]}
    med["decisions_per_s"] = len(batches[0]) / (med["wall"] * 1e-6)
    n_prof = n_batches - split
    med["window"] = {"batches": n_prof, "wall_us": window_us, "busy_us": busy_us,
                     "idle_share": 1 - busy_us / window_us, "busy_by_name_us": dict(busy)}
    print(f"[sketch] {len(rows)} batches of {len(batches[0])}: median per batch "
          + ", ".join(f"{k} {med[k]:.1f} us" for k in (*SKETCH_STEPS, "rest", "wall"))
          + f"; profiled window of {n_prof} batches: wall {window_us:.1f} us, device busy "
          f"{busy_us:.1f} us, idle share {1 - busy_us / window_us:.4f} | {card}", flush=True)
    inst.close()
    return med


H2_STEPS = ("decode", "plan", "lane", "learn", "merge", "schedule", "collapse", "rounds", "flush",
            "readback")


def profile_h2(torch, np, rng, card, profile, ProfilerActivity, DeviceType):
    """The h2 loads' window split and profiled runs (see the module
    docstring)."""
    import chip_smoke as cs
    from gubernator_tpu_torch.config import DaemonConfig
    from gubernator_tpu_torch.core import h2_client
    from gubernator_tpu_torch.core.readback import Ticket
    from gubernator_tpu_torch.daemon import spawn_daemon
    from gubernator_tpu_torch.net import wire_codec
    from gubernator_tpu_torch.net.h2_fast import H2FastFront

    d = spawn_daemon(DaemonConfig(http_listen_address="127.0.0.1:0", cache_size=cs.CAP_SERVE,
                                  sweep_interval=0.0, h2_fast_address="127.0.0.1:0"),
                     device="cuda")
    front, eng = d.h2_fast, d.instance.engine
    step_s = defaultdict(float)
    timed = timer(step_s)
    timed(wire_codec, "decode_reqs", "decode")
    timed(eng.table, "schedule_packed", "schedule")
    timed(eng, "_try_collapse", "collapse")
    timed(eng, "_dispatch_rounds", "rounds")
    timed(eng._pump, "flush_locked", "flush")
    timed(Ticket, "fetch", "readback")
    ledger = getattr(d.instance, "ledger", None)
    if ledger is not None:
        timed(ledger, "plan", "plan")
        timed(ledger, "_learn", "learn")
        from gubernator_tpu_torch.core.ledger import LedgerPlan

        timed(LedgerPlan, "build_engine_lane", "lane")
        timed(LedgerPlan, "merge_outputs", "merge")
    rows = []
    # A tree with the ledger: the second front takes no plane.
    no_window = H2FastFront(d.instance, window_s=0.0,
                            **({} if ledger is None else {"native_ledger": False}))

    def split_serve(f):
        serve = f._serve

        def split(payload, total):
            step_s.clear()
            t = time.perf_counter()
            try:
                return serve(payload, total)
            finally:
                wall = (time.perf_counter() - t) * 1e6
                row = {k: step_s[k] * 1e6 for k in H2_STEPS}
                row["rest"] = wall - sum(row.values())
                row["serve"] = wall
                rows.append(row)

        f._serve = split

    split_serve(front)
    split_serve(no_window)
    keys = rng.choice(cs.H2_POOL, cs.BATCH, replace=False)
    herd = cs.encode_get_rate_limits([("herd", "hot", 1, 10**9, 3_600_000, 0, 0, 0)])
    loads = {
        "herd": (front, herd, 32, 2.0),
        "herd, 1 connection": (front, herd, 1, 2.0),
        "herd, no window": (no_window, herd, 32, 2.0),
        "1000": (front, cs.encode_get_rate_limits([("api", f"k{int(k)}", 1, 1000, 60_000, 1, 0, 0)
                                                   for k in keys]), 1, 3.0),
    }
    out = {}
    try:
        for tag, (front, payload, conns, seconds) in loads.items():
            h2_client.bench_unary(front.address, cs.H2_PATH, payload, 0.5, conns)  # warm-up
            rows.clear()
            w0 = front.stats()["windows"]
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                torch.cuda.synchronize()
                t = time.perf_counter()
                rpcs, errors, lats, _frame, _conns = h2_client.bench_unary(
                    front.address, cs.H2_PATH, payload, seconds, conns)
                torch.cuda.synchronize()
                run_us = (time.perf_counter() - t) * 1e6
            windows = front.stats()["windows"] - w0
            busy = [(e.key, e.self_device_time_total) for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
            busy_us = sum(t for _, t in busy) if busy else float("nan")
            med = {k: statistics.median(r[k] for r in rows) for k in rows[0]}
            lat_ms = np.asarray(lats) * 1e3
            med.update(rpcs=rpcs, errors=errors, windows=windows, rpcs_per_s=rpcs / seconds,
                       cycle_us=run_us / windows, p50_ms=float(np.percentile(lat_ms, 50)),
                       p99_ms=float(np.percentile(lat_ms, 99)),
                       window={"wall_us": run_us, "busy_us": busy_us,
                               "idle_share": 1 - busy_us / run_us,
                               "busy_by_name_us": dict(busy)})
            out[tag] = med
            print(f"[h2 {tag}] {rpcs} RPCs, {errors} errors, {windows} windows in {seconds} s: "
                  f"{rpcs / seconds:.1f} RPCs/s, p50 {med['p50_ms']:.3f} ms, p99 "
                  f"{med['p99_ms']:.3f} ms; window cycle {med['cycle_us']:.1f} us; median serve "
                  "per window " + ", ".join(f"{k} {med[k]:.1f} us"
                                            for k in (*H2_STEPS, "rest", "serve"))
                  + f"; device busy {busy_us:.1f} us of {run_us:.1f} us, idle share "
                  f"{1 - busy_us / run_us:.4f} | {card}", flush=True)
    finally:
        no_window.close()
        d.close()
    return out


if __name__ == "__main__":
    sys.exit(main())
