#!/usr/bin/env python3
"""A restoring round's eviction clears and restores (K2 and K5) in the
forms tried for them, timed on one GPU in one run.

    python3 scripts/torch_k2_restore.py

Forms (each a restoring round: clear meta bit 0 at the clears, then
write the 12 state words of each record lane at its slot):

* K2, K5 — the port's form: csrc/clear_occupied.cu then
  csrc/load_slots.cu, each a launch of its own from its own host call
  and staged copy (`fs.clear_occupied` over the clears padded as the
  engine pads them, then `fs.load_slots`);
* pair — the same two lane bodies built from the source below, from one
  host call over one staged buffer (the record, then the clears): K2,
  which lets its dependent start at once
  (`griddepcontrol.launch_dependents`), then K5 launched with
  cudaLaunchAttributeProgrammaticStreamSerialization, whose lanes load
  their record words and wait for K2's grid and its stores
  (`griddepcontrol.wait`) before they store;
* one launch — both kinds of lane in one launch, built from the source
  below: the first ceil(C / 128) blocks clear, the rest restore (K5's
  lane).  Its two kinds of lane must touch disjoint slots, so the host
  drops from the clears every slot the record restores (the restore
  writes all 12 words); the clears are padded with -1 (dropped) to a
  multiple of 32 words, so that the record that follows them in the one
  staged buffer starts on a 128-byte line, as in a launch of K5 alone.

Both were tried in the port and not kept: each met the mixed readings of
its keep rule and failed its clears-alone clause, the one launch its wall
clause too (PERF.md §6).

Each form is first held bit-equal to `clear_occupied_reference` then
`load_slots_reference` (every state word, caps 2^20 and 10^8, half the
clears on slots the record restores, extreme record values).  Then every
form is timed with CUDA events behind a spin kernel in four turns (the
list, the list reversed, and both again from its middle; each figure the
median of its turns) at clears {16, 1000} x records {16, 4096} and at
clears alone {16, 1000}, caps 2^20 and 10^8, beside an empty kernel
(`torch.cuda._sleep(0)`), the launch floor, and the bytes bound (12 B a
clear the record does not overwrite, 124 B an in-range record lane, 4 B a
padding lane, at 3.35 TB/s).  Prints one line a reading, fastest first,
then the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

FORMS_CU = r"""
#include <cstdint>
#include <cuda_runtime.h>
#include "lane_math.cuh"

using namespace lane;

namespace {

constexpr int kThreads = 128;
constexpr int kRows = 19;
enum RecRow {
  kSlot = 0, kAlgo = 1, kStatus = 2, kLimit = 3, kRem = 5, kRemfHi = 7, kRemfLo = 8,
  kDur = 9, kT0 = 11, kExp = 13, kBurst = 15, kInv = 17
};

// K5's lane, as csrc/load_slots.cu computes it; kWait: wait for the
// primary grid (the pair's K2) before the stores.
template <bool kWait>
__device__ __forceinline__ void restore_lane(const Cols& st, long long cap,
                                             const int32_t* __restrict__ rec, int n, int i) {
  int32_t q[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) q[r] = __ldg(rec + (size_t)r * n + i);
  const int32_t slot = q[kSlot];
  if (slot < 0 || (long long)slot >= cap) return;
  const int32_t algo = q[kAlgo] != 0 ? 1 : 0;
  const int64_t t0c = clamp_ts(combine(q[kT0], q[kT0 + 1]));
  const int64_t expc = clamp_ts(combine(q[kExp], q[kExp + 1]));
  const int64_t durc = clamp_ts(combine(q[kDur], q[kDur + 1]));
  const int64_t invc = clamp_ts(combine(q[kInv], q[kInv + 1]));
  int32_t w[kCols];
  w[kMeta] = 1 | (algo << 1) | ((q[kStatus] & 3) << 2) | (hi_word(t0c) << 4) |
             (hi_word(invc) << 15);
  w[kHi2] = hi_word(expc) | (hi_word(durc) << 11);
  w[kT0Lo] = lo_word(t0c);
  w[kExpireLo] = lo_word(expc);
  w[kInvalidLo] = lo_word(invc);
  w[kDurationLo] = lo_word(durc);
  w[kLimitHi] = q[kLimit];
  w[kLimitLo] = q[kLimit + 1];
  w[kRemHi] = algo ? q[kRemfHi] : q[kRem];
  w[kRemLo] = algo ? q[kRemfLo] : q[kRem + 1];
  w[kBurstHi] = q[kBurst];
  w[kBurstLo] = q[kBurst + 1];
  if (kWait) asm volatile("griddepcontrol.wait;" ::: "memory");
  store(st, slot, w);
}

__device__ __forceinline__ void clear_lane(int32_t* __restrict__ meta, long long cap,
                                           const int32_t* __restrict__ clears, int i) {
  const int32_t s = __ldg(clears + i);
  if (s >= 0 && (long long)s < cap) meta[s] &= ~1;
}

// The pair: K2, then K5 as its programmatic dependent.
__global__ void __launch_bounds__(kThreads)
pair_clear_kernel(int32_t* __restrict__ meta, long long cap, const int32_t* __restrict__ clears,
                  int n_clear) {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i < n_clear) clear_lane(meta, cap, clears, i);
}

__global__ void __launch_bounds__(kThreads)
pair_restore_kernel(Cols st, long long cap, const int32_t* __restrict__ rec, int n_rec) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i < n_rec) restore_lane<true>(st, cap, rec, n_rec, i);
}

// The first clear_blocks blocks clear, the rest restore; the host passes
// clears that are no slot of the record, so no two lanes touch one slot.
__global__ void __launch_bounds__(kThreads)
clear_restore_kernel(Cols st, long long cap, const int32_t* __restrict__ clears, int n_clear,
                     int clear_blocks, const int32_t* __restrict__ rec, int n_rec) {
  if ((int)blockIdx.x < clear_blocks) {  // uniform across the block
    const int i = blockIdx.x * kThreads + threadIdx.x;
    if (i < n_clear) clear_lane(st.p[kMeta], cap, clears, i);
    return;
  }
  const int i = ((int)blockIdx.x - clear_blocks) * kThreads + threadIdx.x;
  if (i < n_rec) restore_lane<false>(st, cap, rec, n_rec, i);
}

}  // namespace

extern "C" int launch(void* const* cols, long long cap, const void* clears, int n_clear,
                      const void* rec, int n_rec, void* stream) {
  Cols st;
  for (int c = 0; c < kCols; ++c) st.p[c] = static_cast<int32_t*>(cols[c]);
  const int clear_blocks = (n_clear + kThreads - 1) / kThreads;
  const int rec_blocks = (n_rec + kThreads - 1) / kThreads;
  clear_restore_kernel<<<clear_blocks + rec_blocks, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      st, cap, static_cast<const int32_t*>(clears), n_clear, clear_blocks,
      static_cast<const int32_t*>(rec), n_rec);
  return static_cast<int>(cudaGetLastError());
}

// The pair from one host call: K2 over the clears, then K5 over the record
// as its programmatic dependent (either alone when the other is empty).
extern "C" int launch_pair(void* const* cols, long long cap, const void* rec, int n_rec,
                           const void* clears, int n_clear, void* stream) {
  Cols st;
  for (int c = 0; c < kCols; ++c) st.p[c] = static_cast<int32_t*>(cols[c]);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* r = static_cast<const int32_t*>(rec);
  const unsigned rec_blocks = (n_rec + kThreads - 1) / kThreads;
  if (n_clear > 0) {
    pair_clear_kernel<<<(n_clear + kThreads - 1) / kThreads, kThreads, 0, s>>>(
        st.p[kMeta], cap, static_cast<const int32_t*>(clears), n_clear);
    const int rc = static_cast<int>(cudaGetLastError());
    if (rc != 0 || n_rec == 0) return rc;
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr.val.programmaticStreamSerializationAllowed = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(rec_blocks, 1, 1);
    cfg.blockDim = dim3(kThreads, 1, 1);
    cfg.stream = s;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    const cudaError_t e = cudaLaunchKernelEx(&cfg, pair_restore_kernel, st, cap, r, n_rec);
    return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
  }
  pair_restore_kernel<<<rec_blocks, kThreads, 0, s>>>(st, cap, r, n_rec);
  return static_cast<int>(cudaGetLastError());
}
"""

CAP_SERVE = 1 << 20
CAP_NORTH_STAR = 100_000_000
NOW = 1_760_000_000_000
HBM_BYTES_PER_S = 3.35e12
READINGS = ([(c, r) for c in (16, 1000) for r in (16, 4096)] + [(16, 0), (1000, 0)])


def build():
    from gubernator_tpu_torch.ops import native_build as nb

    out = nb.BUILD_DIR / "k2_restore"
    out.mkdir(parents=True, exist_ok=True)
    src, so = out / "k2_restore.cu", out / "libk2_restore.so"
    src.write_text(FORMS_CU)
    r = subprocess.run([nb.nvcc_path(), *nb.NVCC_FLAGS, f"-I{nb.CSRC}", "-o", str(so), str(src)],
                       capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{r.stdout}\n{r.stderr}")
    print(f"[build] {so.name}: " + " | ".join(
        ln.strip() for ln in (r.stdout + r.stderr).splitlines() if "registers" in ln))
    lib = ctypes.CDLL(str(so))
    p = ctypes.c_void_p
    lib.launch.argtypes = [ctypes.POINTER(p), ctypes.c_longlong, p, ctypes.c_int, p,
                           ctypes.c_int, p]
    lib.launch.restype = ctypes.c_int
    lib.launch_pair.argtypes = lib.launch.argtypes
    lib.launch_pair.restype = ctypes.c_int
    return lib


def record(np, rng, cap: int, n: int):
    """A restore buffer of n sorted unique random slots padded to the
    engine's width (`pad_size`, from 16) with cap + lane, extreme values."""
    from gubernator_tpu_torch.ops.bucket_kernel import RESTORE_FIELDS, pack_restore_host, pad_size

    width = pad_size(n, floor=16)
    rec = {k: np.zeros(width, np.int64) for k in RESTORE_FIELDS}
    rec["slot"] = np.arange(cap, cap + width, dtype=np.int64)
    rec["slot"][:n] = np.sort(rng.choice(cap, n, replace=False))
    big = np.array([2**32, 2**40 + 5, 2**62, -(2**35), -7, 0, 10, 10**6])
    ts = np.array([-5, 0, 2**43 - 1, 2**43, 2**50, NOW, NOW + 60_000, NOW - 1])
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


def case(np, rng, cap: int, n_clear: int, n_rec: int):
    """(clears int64 [n_clear], unique, half of them (at most every record)
    slots the record restores; record int32 [19, width] or None)."""
    rec = record(np, rng, cap, n_rec) if n_rec else None
    restored = rec[0, :n_rec].astype(np.int64) if n_rec else np.zeros(0, np.int64)
    k = min(n_clear // 2, n_rec)
    other = rng.choice(cap, 2 * n_clear + 64, replace=False)
    other = other[~np.isin(other, restored)][: n_clear - k]
    clears = np.concatenate([rng.choice(restored, k, replace=False), other]).astype(np.int64)
    rng.shuffle(clears)
    return clears, rec


def one_launch_buffer(np, clears, rec):
    """The one-launch form's staged buffer: the clears less the record's
    slots, padded with -1 to a multiple of 32 words, then the record.
    Returns (buffer, clears counted, record offset, record width)."""
    c = np.asarray(clears, np.int64)
    if rec is not None:
        c = np.setdiff1d(c, rec[0].astype(np.int64))
    pad = -len(c) % 32
    head = np.concatenate([c, np.full(pad, -1)]).astype(np.int32)
    if rec is None:
        return head, len(c), len(head), 0
    return np.concatenate([head, rec.ravel()]), len(c), len(head), rec.shape[1]


def device_ms(torch, fn, n: int = 200, windows: int = 5) -> float:
    per = []
    for _ in range(windows):
        torch.cuda._sleep(100_000_000)
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for i in range(n):
            fn(i)
        b.record()
        b.synchronize()
        per.append(a.elapsed_time(b) / n)
    return statistics.median(per)


def bound_ms(np, clears, rec, cap: int) -> float:
    restored = rec[0].astype(np.int64) if rec is not None else np.zeros(0, np.int64)
    n_clear = int((~np.isin(np.unique(clears), restored)).sum())
    total = n_clear * 12
    if rec is not None:
        s = rec[0].astype(np.int64)
        n = int(((s >= 0) & (s < cap)).sum())
        total += n * (76 + 48) + (len(s) - n) * 4
    return total / HBM_BYTES_PER_S * 1e3


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_k2_restore: needs a CUDA device", file=sys.stderr)
        return 2
    from gubernator_tpu_torch.ops import bucket_kernel as tk
    from gubernator_tpu_torch.ops import fused_step as fs
    from gubernator_tpu_torch.ops.fused_step import state_pointers, stream_of

    lib = build()
    dev = torch.device("cuda", torch.cuda.current_device())
    rng = np.random.default_rng(20261018)
    stream = stream_of(dev)

    def forms(state, cols, cap, clears, rec):
        """name -> a function of the call index that runs the round."""
        # The port: the clears padded to the engine's ladder, the record.
        c2 = np.arange(cap, cap + tk.pad_size(len(clears), floor=16), dtype=np.int64)
        c2[: len(clears)] = clears
        c2 = torch.from_numpy(c2.astype(np.int32)).to(dev)
        r2 = torch.from_numpy(rec).to(dev) if rec is not None else None
        # The pair: one buffer, the record, then the clears.
        n_rec = rec.shape[1] if rec is not None else 0
        flat = np.concatenate([rec.ravel() if rec is not None else np.zeros(0, np.int32),
                               np.asarray(clears, np.int32)])
        flat = torch.from_numpy(flat).to(dev)
        one, n1, off, width = one_launch_buffer(np, clears, rec)
        one = torch.from_numpy(one).to(dev)

        def pair(_i):
            base = flat.data_ptr()
            rc = lib.launch_pair(cols, cap, base if n_rec else None, n_rec,
                                 base + 4 * tk.RESTORE_ROWS * n_rec if len(clears) else None,
                                 len(clears), stream)
            if rc != 0:
                raise RuntimeError(f"pair: launch returned {rc}")

        def plain_launches(_i):
            if len(clears):
                fs.clear_occupied(state.meta, c2)
            if r2 is not None:
                fs.load_slots(state, r2)

        def one_launch(_i):
            base = one.data_ptr()
            rc = lib.launch(cols, cap, base if n1 else None, n1,
                            base + 4 * off if width else None, width, stream)
            if rc != 0:
                raise RuntimeError(f"one launch: launch returned {rc}")

        return {"K2, K5 (port)": plain_launches, "pair": pair, "one launch": one_launch}

    def random_state(cap, seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        return tk.BucketState(*(torch.randint(0, 2**31 - 1, (cap,), generator=g,
                                              dtype=torch.int32, device=dev)
                                for _ in tk.BucketState._fields))

    # Holds: every form bit-equal to the plain clear, then restore.
    for cap in (CAP_SERVE, CAP_NORTH_STAR):
        base = random_state(cap, cap % 997)
        for n_clear, n_rec in READINGS + [(0, 16), (0, 4096)]:
            clears, rec = case(np, rng, cap, n_clear, n_rec)
            plain = tk.BucketState(*(x.clone() for x in base))
            if len(clears):
                tk.clear_occupied_reference(plain.meta,
                                            torch.from_numpy(clears.astype(np.int32)).to(dev))
            if rec is not None:
                tk.load_slots_reference(plain, torch.from_numpy(rec).to(dev))
            for name in ("K2, K5 (port)", "pair", "one launch"):
                kern = tk.BucketState(*(x.clone() for x in base))
                cols, _ = state_pointers(kern, dev)
                forms(kern, cols, cap, clears, rec)[name](0)
                torch.cuda.synchronize()
                bad = [f for f, a, b in zip(tk.BucketState._fields, kern, plain)
                       if not torch.equal(a, b)]
                if bad:
                    print(f"[hold] {name} differs from clear then restore at cap {cap}, "
                          f"{n_clear} clears, {n_rec} records: {bad}")
                    return 1
                del kern, cols
            del plain
        print(f"[hold] cap {cap}: K2 then K5, the pair and the one launch bit-equal to "
              "clear_occupied_reference then load_slots_reference (half the clears on restored "
              "slots; clears alone, records alone; tolerance: exact)")
        del base
        torch.cuda.empty_cache()

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    names = ["empty kernel", "K2, K5 (port)", "pair", "one launch"]
    turns = names + names[::-1]
    half = len(names) // 2
    turns += names[half:] + names[:half] + (names[half:] + names[:half])[::-1]
    for cap in (CAP_SERVE, CAP_NORTH_STAR):
        state = random_state(cap, 7)
        cols, _ = state_pointers(state, dev)
        for n_clear, n_rec in READINGS:
            cases = [case(np, rng, cap, n_clear, n_rec) for _ in range(16)]
            per = [forms(state, cols, cap, c, r) for c, r in cases]
            runs = {"empty kernel": lambda i: torch.cuda._sleep(0)}
            for name in names[1:]:
                runs[name] = (lambda name: lambda i: per[i % 16][name](i))(name)
            got = {k: [] for k in names}
            for k in turns:
                got[k].append(device_ms(torch, runs[k]))
            med = {k: statistics.median(v) for k, v in got.items()}
            bound = statistics.median(bound_ms(np, c, r, cap) for c, r in cases)
            what = f"{n_clear} clears, {n_rec} records, cap {'2^20' if cap == CAP_SERVE else '10^8'}"
            print(f"[time] {what}: " + ", ".join(
                f"{k} {v * 1e3:.3f} us" for k, v in sorted(med.items(), key=lambda kv: kv[1]))
                + f"; bound {bound * 1e3:.4f} us (bytes) | {card}")
        del state, cols
        torch.cuda.empty_cache()
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
