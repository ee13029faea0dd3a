#!/usr/bin/env python3
"""Smoke run of gubernator_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from gubernator_tpu_torch/csrc, holds each
against its plain PyTorch version on the card (K1 over one round and over
R ragged rounds with eviction clears), drives the port's main path (the
decision engine and the HTTP daemon answering GetRateLimits, one K1
launch per batch) at the state size of BASELINE.json configs[1] (2^20
slots, batches of 1000), checks every answer and state word against the
same engine on the CPU, and times the kernels: K1 at R = 1 and on real
5-round batches taken from the engine's stream, and K2.  Any failed
phase exits non-zero before the result lines.  The last three lines of standard output are the kernels
JSON line, the card's `name, power.limit` from nvidia-smi, and
{"ok": true, "device": {...}}.

The port imports nothing of JAX; neither does this script.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
import urllib.request

SEED = 20261017
CAP_SERVE = 1 << 20  # BASELINE.json configs[1]: 1M keys, batch=1000, single node
CAP_NORTH_STAR = 100_000_000  # BASELINE.json metric: 100M keys (4.8 GB of state)
BATCH = 1000  # MAX_BATCH_SIZE
HBM_BYTES_PER_S = 3.35e12  # H100 SXM peak memory rate (NVIDIA data sheet)
NOW0 = 1_760_000_000_000  # ms; frozen-clock start of every phase


def log(msg: str) -> None:
    print(msg, flush=True)


class PhaseError(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


# ---------------------------------------------------------------------------
# Seeded data


def random_state_words(np, rng, cap: int, now: int) -> dict:
    """Reference-typed column words of a random valid state of `cap`
    slots (mixed token / leaky, live and expired, some invalidated),
    packed with the port's numpy copy of pack_state_host."""
    from gubernator_tpu_torch.ops.bucket_kernel import pack_state_host

    i32 = np.int32
    logical = dict(
        occupied=rng.random(cap, dtype=np.float32) < 0.75,
        algo=rng.integers(0, 2, cap, dtype=i32),
        status=rng.integers(0, 2, cap, dtype=i32),
        t0=now - rng.integers(0, 5_000, cap, dtype=np.int64),
        invalid=np.where(rng.random(cap, dtype=np.float32) < 0.1,
                         now + rng.integers(-50, 50, cap, dtype=np.int64), 0),
        expire=now + rng.integers(-100, 5_000, cap, dtype=np.int64),
        duration=rng.choice(np.array([0, 1, 40, 1000, 30_000]), cap),
        limit=rng.choice(np.array([0, 1, 5, 100, 10**12]), cap),
        remaining=rng.integers(-5, 200, cap, dtype=np.int64),
        remf_hi=rng.integers(-3, 200, cap, dtype=i32),
        remf_lo=rng.integers(0, 2**32, cap, dtype=np.uint32),
        burst=rng.choice(np.array([0, 0, 5, 20]), cap),
    )
    return pack_state_host(logical)


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
    read and written per in-range lane), plus the 8 B `now` header, plus
    12 B per in-range clear (its slot, one meta word read and written),
    at peak HBM."""
    s = clear_slots[: int(clear_off[-1])].astype("int64")
    n_clear = int(((s >= 0) & (s < cap)).sum())
    return (pin.shape[1] * 80 + in_range_lanes(pin, cap) * 96 + 8 + n_clear * 12) \
        / HBM_BYTES_PER_S * 1e3


def k2_bound_ms(slots, cap: int) -> float:
    """Least time for one K2 launch: slots read once, one meta word read
    and written per in-range slot."""
    s = slots.astype("int64")
    n = int(((s >= 0) & (s < cap)).sum())
    return (len(s) * 4 + n * 8) / HBM_BYTES_PER_S * 1e3


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
    log(f"[build] {len(libs)} kernels built in {time.perf_counter() - t:.1f} s (parallel nvcc)")
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


def phase_k1(torch, np, rng, errs):
    """K1 against the plain step on the card, bit-exact in pout and the 12
    state columns, at cap 2^20 and 10^8: one round (`fused_step`) at W in
    {64, 1024, 8192}, and R in {1, 3, 16} ragged rounds with clears
    (`multi_fused_step`); plus the extreme-value batch as one round and as
    three rounds."""
    from gubernator_tpu_torch.ops import bucket_kernel as tk
    from gubernator_tpu_torch.ops import fused_step as fs

    def hold(got, want, kern, plain, what):
        torch.cuda.synchronize()
        err = max(int((got.long() - want.long()).abs().max().item()),
                  compare_states(torch, kern, plain))
        errs["fused_step"] = max(errs["fused_step"], err)
        check(err == 0, f"K1 differs from the plain step: {what} err {err}")

    for cap in (CAP_SERVE, CAP_NORTH_STAR):
        t = time.perf_counter()
        words = random_state_words(np, rng, cap, NOW0)
        kern = tk.state_from_numpy(words, "cuda")
        plain = tk.state_from_numpy(words, "cuda")
        del words
        log(f"[k1] cap {cap}: random state built in {time.perf_counter() - t:.1f} s "
            f"({cap * 48 / 1e9:.2f} GB per copy on the card)")
        now = NOW0
        rounds = 0
        for width in (64, 1024, 8192):
            for _ in range(4):
                now += int(rng.integers(0, 300))
                m = width - int(rng.integers(0, width // 4 + 1))
                pin = torch.from_numpy(random_pin(np, rng, cap, width, m, now)).cuda()
                hold(fs.fused_step(kern, pin), tk.fused_step_reference(plain, pin),
                     kern, plain, f"cap {cap} one round W {width}")
                rounds += 1
        calls = 0
        for n_rounds in (1, 3, 16):
            for _ in range(3):
                now += int(rng.integers(0, 300))
                packed = ragged_rounds(np, rng, cap, n_rounds, now)
                dev = on_device(torch, packed)
                hold(fs.multi_fused_step(kern, *dev, widest=packed.widest),
                     tk.multi_fused_step_reference(plain, *dev), kern, plain,
                     f"cap {cap} R {n_rounds}")
                rounds += n_rounds
                calls += 1
        log(f"[k1] cap {cap}: {rounds} rounds ({calls} multi-round launches at R in "
            "{1, 3, 16} with clears) bit-equal to the plain step (pout and 12 columns; "
            "tolerance: exact, every word is an integer)")
        del kern, plain
        torch.cuda.empty_cache()

    cap = 4096
    words = extreme_state_words(np, cap, NOW0)
    kern, plain = tk.state_from_numpy(words, "cuda"), tk.state_from_numpy(words, "cuda")
    buf = extreme_pin(np, cap, 64, NOW0)
    for step in range(3):
        pin = torch.from_numpy(buf).cuda()
        hold(fs.fused_step(kern, pin), tk.fused_step_reference(plain, pin), kern, plain,
             f"extreme batch step {step}")
        buf[0, 1] += 997
        packed = extreme_rounds(np, cap, NOW0 + 5000 * (step + 1))
        dev = on_device(torch, packed)
        hold(fs.multi_fused_step(kern, *dev, widest=packed.widest),
             tk.multi_fused_step_reference(plain, *dev), kern, plain,
             f"extreme batch in three rounds, step {step}")
    log("[k1] extreme-value batch bit-equal as one round and as three rounds with clears "
        "(saturating f64->int, int64 wrap)")


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


def run_engine_pair(torch, np, rng, cap, n_keys, n_batches, tag):
    """The same seeded stream through the engine on the card and on the
    CPU (frozen clocks at one instant): answers and final state words
    must be bit-equal.  Half the batches go through apply_columnar, half
    through get_rate_limits.  Returns the card engine."""
    from gubernator_tpu_torch.clock import Clock
    from gubernator_tpu_torch.core.engine import DecisionEngine
    from gubernator_tpu_torch.ops import bucket_kernel as tk

    ns = NOW0 * 1_000_000
    gpu = DecisionEngine(cap, clock=Clock().freeze_at(ns), device="cuda")
    cpu = DecisionEngine(cap, clock=Clock().freeze_at(ns), device="cpu")
    pool = [b"api_k%d" % i for i in range(n_keys)]
    hot = [b"api_hot%d" % i for i in range(50)]
    decisions = 0
    for b in range(n_batches):
        keys, cols = stream_columns(np, rng, pool, hot, BATCH)
        if b % 2 == 0:
            got = gpu.apply_columnar(keys, *cols)
            want = cpu.apply_columnar(keys, *cols)
            for name, g, w in zip(("status", "limit", "remaining", "reset"), got, want):
                check(np.array_equal(g, w), f"[{tag}] batch {b}: {name} differs card vs CPU")
        else:
            reqs = as_requests(keys, cols)
            got = gpu.get_rate_limits(reqs)
            want = cpu.get_rate_limits(reqs)
            check(got == want, f"[{tag}] batch {b}: get_rate_limits differs card vs CPU")
        decisions += len(keys)
        dt = int(rng.integers(0, 2_000))
        gpu.clock.advance(ms=dt)
        cpu.clock.advance(ms=dt)
    gw, cw = tk.state_to_numpy(gpu.state), tk.state_to_numpy(cpu.state)
    for f in tk.BucketState._fields:
        check(np.array_equal(gw[f], cw[f]), f"[{tag}] final state column {f} differs")
    check(gpu.table.evictions == cpu.table.evictions, f"[{tag}] eviction counts differ")
    log(f"[{tag}] {n_batches} batches x {BATCH} ({decisions} decisions, {len(gpu.table)} keys "
        f"live, {gpu.table.evictions} evictions, {gpu.rounds_total} rounds in "
        f"{gpu.dispatches_total} launches, {gpu.clears_total} clears inside them): answers "
        f"and all {cap}x12 state words bit-equal card vs CPU")
    return gpu


def phase_engine(torch, np, rng):
    serve = run_engine_pair(torch, np, rng, CAP_SERVE, 200_000, 32, "engine")
    evict = run_engine_pair(torch, np, rng, 4096, 3 * 4096, 16, "evict")
    return [serve, evict]


def phase_server(torch, np, rng, card_engines):
    """The daemon on the card answers GetRateLimits over HTTP; each body
    must equal the JSON of the same batch through a CPU instance."""
    from gubernator_tpu_torch.clock import Clock
    from gubernator_tpu_torch.config import DaemonConfig
    from gubernator_tpu_torch.core.engine import DecisionEngine
    from gubernator_tpu_torch.daemon import spawn_daemon
    from gubernator_tpu_torch.net.gateway import get_rate_limits_resp_json
    from gubernator_tpu_torch.service import V1Instance

    ns = NOW0 * 1_000_000
    d = spawn_daemon(DaemonConfig(http_listen_address="127.0.0.1:0", cache_size=CAP_SERVE),
                     clock=Clock().freeze_at(ns), device="cuda")
    cpu = V1Instance(DecisionEngine(CAP_SERVE, clock=Clock().freeze_at(ns), device="cpu"))
    try:
        card_engines.append(d.instance.engine)
        url = f"http://{d.http_address}"
        pool = [b"api_u%d" % i for i in range(5_000)]
        hot = [b"api_h%d" % i for i in range(20)]
        http_s, n_dec = 0.0, 0
        for b in range(12):
            keys, cols = stream_columns(np, rng, pool, hot, BATCH)
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
        log(f"[server] 12 POST /v1/GetRateLimits x {BATCH} on the card: bodies byte-equal to "
            f"the CPU instance's; HealthCheck {health['status']}")
        return n_dec / http_s
    finally:
        d.close()


def phase_daemon_binary():
    """`python -m gubernator_tpu_torch.cmd.daemon` on the card: it binds,
    answers, and exits 0 on SIGTERM."""
    import os
    import signal

    env = dict(os.environ, GUBER_HTTP_ADDRESS="127.0.0.1:0", GUBER_CACHE_SIZE=str(CAP_SERVE))
    proc = subprocess.Popen([sys.executable, "-m", "gubernator_tpu_torch.cmd.daemon"],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
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
    from gubernator_tpu_torch.core import engine as engine_mod

    real = engine_mod.multi_fused_step
    seen = []

    def recorder(state, *args, **kw):
        seen.append(tuple(t.clone() for t in args) + (kw["widest"],))
        return real(state, *args, **kw)

    eng = engine_mod.DecisionEngine(CAP_SERVE, clock=Clock().freeze_at(NOW0 * 1_000_000),
                                    device="cuda")
    pool = [b"api_k%d" % i for i in range(200_000)]
    hot = [b"api_hot%d" % i for i in range(50)]
    got, by_r = [], {}
    engine_mod.multi_fused_step = recorder
    try:
        for _ in range(400):
            keys, cols = stream_columns(np, rng, pool, hot, BATCH)
            eng.apply_columnar(keys, *cols)
            eng.clock.advance(ms=int(rng.integers(0, 2_000)))
            batch = seen.pop()
            n_rounds = batch[1].shape[0] - 1
            by_r[n_rounds] = by_r.get(n_rounds, 0) + 1
            if n_rounds == r_want:
                got.append(batch)
                if len(got) == n_want:
                    break
    finally:
        engine_mod.multi_fused_step = real
        eng.close()
    check(len(got) == n_want, f"only {len(got)} batches of {r_want} rounds in the stream")
    return got, dict(sorted(by_r.items()))


def phase_timing(torch, np, rng, card):
    """Device time per launch (CUDA events) against the bytes bound: K1
    at R = 1 (W = 1024 and 8192), K1 on 16 real 5-round batches (per
    launch and per round), K1 on a hot-key batch, K2 over 1000 clears,
    and K2 over 16 padding lanes as the launch floor."""
    from gubernator_tpu_torch.ops import bucket_kernel as tk
    from gubernator_tpu_torch.ops import fused_step as fs

    words = random_state_words(np, rng, CAP_SERVE, NOW0)
    state = tk.state_from_numpy(words, "cuda")
    plain_state = tk.state_from_numpy(words, "cuda")
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
    log(f"[time] captured 16 five-round batches (rounds per batch over the stream: {by_r}); "
        f"median L {lanes} lanes ({real} requests), widest round {widest}, {n_clears} clears "
        "in all")
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
    log(f"[time] K1 on a hot-key batch ({hot_n} rounds of 1 request, 1 block): {hot_ms * 1e3:.1f} us/launch, {hot_ms / hot_n * 1e3:.2f} us/round "
        f"| {card}")
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
    return out


def columnar_rate(torch, np, rng, card):
    """Decisions/s through DecisionEngine.apply_columnar on the card
    (cap 2^20, batches of 1000 over 200k keys, host interning included)."""
    from gubernator_tpu_torch.clock import Clock
    from gubernator_tpu_torch.core.engine import DecisionEngine

    eng = DecisionEngine(CAP_SERVE, clock=Clock().freeze_at(NOW0 * 1_000_000), device="cuda")
    pool = [b"api_k%d" % i for i in range(200_000)]
    hot = [b"api_hot%d" % i for i in range(50)]
    batches = [stream_columns(np, rng, pool, hot, BATCH, greg_share=0.0) for _ in range(40)]
    for keys, cols in batches[:5]:
        eng.apply_columnar(keys, *cols)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for keys, cols in batches[5:]:
        eng.apply_columnar(keys, *cols)
    rate = 35 * BATCH / (time.perf_counter() - t)
    log(f"[time] apply_columnar on the card: {rate:.0f} decisions/s "
        f"({eng.rounds_total} rounds in {eng.dispatches_total} launches) | {card}")
    eng.close()
    return rate


def main() -> int:
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

        import gubernator_tpu_torch  # noqa: F401
        from gubernator_tpu_torch.ops import fused_step as fs
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here ({e}); run from the repo root",
              file=sys.stderr)
        return 2

    t_start = time.perf_counter()
    rng = np.random.default_rng(SEED)
    card = phase_device(torch)
    phase_build()
    errs = {"fused_step": 0, "clear_occupied": 0}
    phase_k1(torch, np, rng, errs)
    phase_k2(torch, np, rng, errs)

    # ---- the main path: counts from 0 just before, read just after.
    fs.reset_launches()
    engines = phase_engine(torch, np, rng)
    http_rate = phase_server(torch, np, rng, engines)
    main_launches = dict(fs.launches)
    rounds = sum(e.rounds_total for e in engines)
    dispatches = sum(e.dispatches_total for e in engines)
    clears = sum(e.clears_total for e in engines)
    log(f"[main] launches {main_launches}; engine batches dispatched {dispatches}, "
        f"rounds {rounds}, clears {clears}")
    check(main_launches["fused_step"] == dispatches > 0,
          "every batch of the main path must be one K1 launch")
    check(main_launches["fused_step"] < rounds, "K1 must run several rounds per launch")
    check(main_launches["clear_occupied"] == 0,
          "the main path's clears run inside K1, never as K2 launches")
    check(clears > 0, "the main path must clear evicted slots")
    for e in engines[:2]:
        e.close()
    torch.cuda.empty_cache()

    phase_daemon_binary()
    times = phase_timing(torch, np, rng, card)
    col_rate = columnar_rate(torch, np, rng, card)
    log(f"[time] HTTP GetRateLimits on the card: {http_rate:.0f} decisions/s | {card}")

    # K1's row: one launch over a real 5-round batch (the engine's typical
    # launch); the R = 1 figures are in the [done] line.
    k1_ms, k1_plain, k1_bound = times["r5"]
    k2_ms, k2_plain, k2_bound = times["k2"]
    kernels = {"kernels": [
        {"name": "fused_step", "route": "cuda",
         "source": "gubernator_tpu_torch/csrc/fused_step.cu",
         "replaces": "gubernator_tpu/ops/pallas_step.py:67",
         "launches": main_launches["fused_step"], "max_abs_err": errs["fused_step"],
         "ms": k1_ms, "plain_ms": k1_plain, "bound_ms": k1_bound, "bound_by": "bytes",
         "library_ms": None},
        {"name": "clear_occupied", "route": "cuda",
         "source": "gubernator_tpu_torch/csrc/clear_occupied.cu",
         "replaces": "gubernator_tpu/ops/bucket_kernel.py:329",
         "launches": main_launches["clear_occupied"], "max_abs_err": errs["clear_occupied"],
         "ms": k2_ms, "plain_ms": k2_plain, "bound_ms": k2_bound, "bound_by": "bytes",
         "library_ms": None},
    ]}
    log(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s "
        f"(K1 R=1 W=1024: {times[1024][0] * 1e3:.2f} us, W=8192: {times[8192][0] * 1e3:.2f} us; "
        f"K1 per 5-round batch {k1_ms * 1e3:.2f} us (the kernels line's ms); launch floor {times['floor'] * 1e3:.2f} us; "
        f"apply_columnar {col_rate:.0f} dec/s)")
    print(json.dumps(kernels))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
