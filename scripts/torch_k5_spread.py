#!/usr/bin/env python3
"""K5 (the restore: write the 12 state words of each record lane at its
slot) beside the designs tried for it and not kept, timed on one GPU in
one run.

    python3 scripts/torch_k5_spread.py

Designs, all built from the source below with the port's nvcc flags and
its `lane_math.cuh` (the words are built exactly as csrc/load_slots.cu
builds them; only the block size and the way the record reaches the
registers differ):

* ldg-T — T threads a block, one lane a thread, the lane's 19 record
  words read at once with `__ldg` (T = 128 is csrc/load_slots.cu's
  design; T = 32, one warp a block, puts a 4096-record restore on 128
  blocks, one an SM, instead of 32);
* bulk-T — the same, with the block's record tile (19 rows of T words)
  staged into shared memory by Hopper's bulk asynchronous copy
  (`cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes`,
  19 copies of 4·T bytes issued by one thread and completed on one
  `mbarrier`), each thread then reading its words from shared memory.
  The copies need a 16-byte aligned record and n % 4 == 0;
* col-T — one block a (T-lane tile, column), the tiles of one column
  before the next column's (grid T-lane tiles x 12), each thread storing
  one word: the blocks resident at once store into few columns' pages.

Each design is first held bit-equal to `load_slots_reference` (every
state word, at caps 2^20 and 10^8, records of 16..4096 lanes with padding
and extreme values).  Then K5 as the port launches it
(`ops.fused_step.load_slots`) and every design are timed with CUDA
events behind a spin kernel in four turns (the list, the list reversed,
and both again from its middle; each figure the median of its turns) at
16, 1024 and 4096 random slots at caps 2^20 and 10^8 and at 4096
contiguous slots at 10^8, beside an empty kernel launched in the same
queue (`torch.cuda._sleep(0)`), the launch floor.  Prints one line per
reading, fastest first, then the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

SPREAD_CU = r"""
#include <cstdint>
#include <cuda_runtime.h>
#include "lane_math.cuh"

using namespace lane;

namespace {

constexpr int kRows = 19;
enum RecRow {
  kSlot = 0, kAlgo = 1, kStatus = 2, kLimit = 3, kRem = 5, kRemfHi = 7, kRemfLo = 8,
  kDur = 9, kT0 = 11, kExp = 13, kBurst = 15, kInv = 17
};

__device__ __forceinline__ void store_lane(const Cols& st, long long cap, const int32_t (&q)[kRows]) {
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
  store(st, slot, w);
}

template <int T>
__global__ void __launch_bounds__(T) ldg_kernel(Cols st, long long cap, const int32_t* __restrict__ rec,
                                                int n) {
  const int i = blockIdx.x * T + threadIdx.x;
  if (i >= n) return;
  int32_t q[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) q[r] = __ldg(rec + (size_t)r * n + i);
  store_lane(st, cap, q);
}

template <int T>
__global__ void __launch_bounds__(T) bulk_kernel(Cols st, long long cap, const int32_t* __restrict__ rec,
                                                 int n) {
  __shared__ __align__(128) int32_t tile[kRows][T];
  __shared__ __align__(8) uint64_t bar;
  const int base = blockIdx.x * T;
  const int m = n - base < T ? n - base : T;
  const uint32_t b = static_cast<uint32_t>(__cvta_generic_to_shared(&bar));
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(b) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    const uint32_t bytes = static_cast<uint32_t>(m) * 4;
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 ::"r"(b), "r"(bytes * kRows) : "memory");
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(&tile[r][0]));
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
          ::"r"(dst), "l"(rec + (size_t)r * n + base), "r"(bytes), "r"(b) : "memory");
    }
  }
  __syncthreads();
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], 0;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(b) : "memory");
  if (threadIdx.x >= m) return;
  int32_t q[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) q[r] = tile[r][threadIdx.x];
  store_lane(st, cap, q);
}

// One block a (32-lane tile, column): blockIdx.x runs over the tiles of
// one column before the next column's, so the blocks resident at once
// store into few columns' pages.
template <int T>
__global__ void __launch_bounds__(T) col_kernel(Cols st, long long cap, const int32_t* __restrict__ rec,
                                                int n) {
  const int i = blockIdx.x * T + threadIdx.x;
  if (i >= n) return;
  int32_t q[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) q[r] = __ldg(rec + (size_t)r * n + i);
  const int32_t slot = q[kSlot];
  if (slot < 0 || (long long)slot >= cap) return;
  const int col = blockIdx.y;
  const int32_t algo = q[kAlgo] != 0 ? 1 : 0;
  const int64_t t0c = clamp_ts(combine(q[kT0], q[kT0 + 1]));
  const int64_t expc = clamp_ts(combine(q[kExp], q[kExp + 1]));
  const int64_t durc = clamp_ts(combine(q[kDur], q[kDur + 1]));
  const int64_t invc = clamp_ts(combine(q[kInv], q[kInv + 1]));
  int32_t w;
  switch (col) {
    case kMeta: w = 1 | (algo << 1) | ((q[kStatus] & 3) << 2) | (hi_word(t0c) << 4) |
                    (hi_word(invc) << 15); break;
    case kHi2: w = hi_word(expc) | (hi_word(durc) << 11); break;
    case kT0Lo: w = lo_word(t0c); break;
    case kExpireLo: w = lo_word(expc); break;
    case kInvalidLo: w = lo_word(invc); break;
    case kDurationLo: w = lo_word(durc); break;
    case kLimitHi: w = q[kLimit]; break;
    case kLimitLo: w = q[kLimit + 1]; break;
    case kRemHi: w = algo ? q[kRemfHi] : q[kRem]; break;
    case kRemLo: w = algo ? q[kRemfLo] : q[kRem + 1]; break;
    case kBurstHi: w = q[kBurst]; break;
    default: w = q[kBurst + 1]; break;
  }
  st.p[col][slot] = w;
}

template <class K>
int go(K kernel, int threads, Cols st, long long cap, const int32_t* rec, int n, cudaStream_t s) {
  kernel<<<(n + threads - 1) / threads, threads, 0, s>>>(st, cap, rec, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// bulk: 0 ldg, 1 bulk copy, 2 a block a column; threads: 32, 64 or 128.  Returns -1 for a
// design not built, else cudaGetLastError() after the launch.
extern "C" int launch(int bulk, int threads, void* const* cols, long long cap, const void* rec,
                      int n, void* stream) {
  Cols st;
  for (int c = 0; c < kCols; ++c) st.p[c] = static_cast<int32_t*>(cols[c]);
  const int32_t* r = static_cast<const int32_t*>(rec);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bulk == 1 && ((reinterpret_cast<uintptr_t>(rec) & 15) != 0 || n % 4 != 0)) return -1;
  switch (bulk * 1000 + threads) {
    case 32: return go(ldg_kernel<32>, 32, st, cap, r, n, s);
    case 64: return go(ldg_kernel<64>, 64, st, cap, r, n, s);
    case 128: return go(ldg_kernel<128>, 128, st, cap, r, n, s);
    case 1032: return go(bulk_kernel<32>, 32, st, cap, r, n, s);
    case 1064: return go(bulk_kernel<64>, 64, st, cap, r, n, s);
    case 1128: return go(bulk_kernel<128>, 128, st, cap, r, n, s);
    case 2032:
      col_kernel<32><<<dim3((n + 31) / 32, kCols), 32, 0, s>>>(st, cap, r, n);
      return static_cast<int>(cudaGetLastError());
    case 2128:
      col_kernel<128><<<dim3((n + 127) / 128, kCols), 128, 0, s>>>(st, cap, r, n);
      return static_cast<int>(cudaGetLastError());
    default: return -1;
  }
}
"""

CAP_SERVE = 1 << 20
CAP_NORTH_STAR = 100_000_000
NOW = 1_760_000_000_000
DESIGNS = {"ldg-128": (0, 128), "ldg-32": (0, 32), "ldg-64": (0, 64), "bulk-32": (1, 32),
           "bulk-64": (1, 64), "col-32": (2, 32), "col-128": (2, 128)}
HBM_BYTES_PER_S = 3.35e12


def build():
    from gubernator_tpu_torch.ops import native_build as nb

    out = nb.BUILD_DIR / "k5_spread"
    out.mkdir(parents=True, exist_ok=True)
    src, so = out / "k5_spread.cu", out / "libk5_spread.so"
    src.write_text(SPREAD_CU)
    r = subprocess.run([nb.nvcc_path(), *nb.NVCC_FLAGS, f"-I{nb.CSRC}", "-o", str(so), str(src)],
                       capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{r.stdout}\n{r.stderr}")
    print(f"[build] {so.name}: " + " | ".join(
        ln.strip() for ln in (r.stdout + r.stderr).splitlines() if "registers" in ln))
    lib = ctypes.CDLL(str(so))
    p = ctypes.c_void_p
    lib.launch.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(p), ctypes.c_longlong, p,
                           ctypes.c_int, p]
    lib.launch.restype = ctypes.c_int
    return lib


def record(np, rng, cap: int, width: int, n: int, contiguous: bool = False, extreme=True):
    """A restore buffer of n sorted unique slots padded to `width` with
    cap + lane; extreme values as chip_smoke.py's `restore_record`."""
    from gubernator_tpu_torch.ops.bucket_kernel import RESTORE_FIELDS, pack_restore_host

    rec = {k: np.zeros(width, np.int64) for k in RESTORE_FIELDS}
    rec["slot"] = np.arange(cap, cap + width, dtype=np.int64)
    if contiguous:
        start = int(rng.integers(0, cap - n))
        rec["slot"][:n] = np.arange(start, start + n)
    else:
        rec["slot"][:n] = np.sort(rng.choice(cap, n, replace=False))
    if extreme:
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


def bound_ms(rec, cap: int) -> tuple:
    """(bytes bound, 32-byte-sector bound) of one restore: an in-range lane
    reads 76 B and writes 48 B (12 scattered stores: 12 sectors of 32 B);
    a padding lane reads its 4 B slot; the record's rows in sectors."""
    s = rec[0].astype("int64")
    n = int(((s >= 0) & (s < cap)).sum())
    width = len(s)
    by_bytes = (n * (76 + 48) + (width - n) * 4) / HBM_BYTES_PER_S * 1e3
    rec_sectors = 19 * -(-n * 4 // 32) + -(-(width - n) * 4 // 32)
    by_sectors = (rec_sectors + 12 * n) * 32 / HBM_BYTES_PER_S * 1e3
    return by_bytes, by_sectors


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_k5_spread: needs a CUDA device", file=sys.stderr)
        return 2
    from gubernator_tpu_torch.ops import bucket_kernel as tk
    from gubernator_tpu_torch.ops import fused_step as fs
    from gubernator_tpu_torch.ops.fused_step import state_pointers, stream_of

    lib = build()
    dev = torch.device("cuda", torch.cuda.current_device())
    rng = np.random.default_rng(20261018)
    stream = stream_of(dev)

    def design(name, state, cols, cap):
        bulk, threads = DESIGNS[name]

        def run(rec):
            rc = lib.launch(bulk, threads, cols, cap, rec.data_ptr(), rec.shape[1], stream)
            if rc != 0:
                raise RuntimeError(f"{name}: launch returned {rc}")
        return run

    def zeros(cap):
        return tk.BucketState(*(torch.zeros(cap, dtype=torch.int32, device=dev)
                                for _ in tk.BucketState._fields))

    # Holds: every design bit-equal to the plain restore.
    for cap in (CAP_SERVE, CAP_NORTH_STAR):
        plain = zeros(cap)
        recs = [torch.from_numpy(record(np, rng, cap, w, int(rng.integers(1, w + 1)))).to(dev)
                for w in (16, 64, 1024, 4096) for _ in range(2)]
        for r in recs:
            tk.load_slots_reference(plain, r)
        for name in ["port"] + list(DESIGNS):
            kern = zeros(cap)
            cols, _ = state_pointers(kern, dev)
            run = (lambda r: fs.load_slots(kern, r)) if name == "port" else design(
                name, kern, cols, cap)
            for r in recs:
                run(r)
            torch.cuda.synchronize()
            bad = [f for f, a, b in zip(tk.BucketState._fields, kern, plain) if not torch.equal(a, b)]
            if bad:
                print(f"[hold] {name} differs from load_slots_reference at cap {cap}: {bad}")
                return 1
            del kern, cols
        print(f"[hold] cap {cap}: K5 and {', '.join(DESIGNS)} bit-equal to load_slots_reference "
              "on 8 records of 16..4096 lanes (tolerance: exact)")
        del plain
        torch.cuda.empty_cache()

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    readings = [(CAP_SERVE, 16, False), (CAP_SERVE, 1024, False), (CAP_SERVE, 4096, False),
                (CAP_NORTH_STAR, 16, False), (CAP_NORTH_STAR, 1024, False),
                (CAP_NORTH_STAR, 4096, False), (CAP_NORTH_STAR, 4096, True)]
    names = ["empty kernel", "K5 (port)"] + list(DESIGNS)
    turns = names + names[::-1]
    half = len(names) // 2
    turns += names[half:] + names[:half] + (names[half:] + names[:half])[::-1]
    for cap in (CAP_SERVE, CAP_NORTH_STAR):
        state = zeros(cap)
        cols, _ = state_pointers(state, dev)
        for rcap, width, contiguous in readings:
            if rcap != cap:
                continue
            host = [record(np, rng, cap, width, width, contiguous, extreme=False)
                    for _ in range(16)]
            recs = [torch.from_numpy(h).to(dev) for h in host]
            runs = {"empty kernel": lambda i: torch.cuda._sleep(0),
                    "K5 (port)": lambda i: fs.load_slots(state, recs[i % 16])}
            for name in DESIGNS:
                run = design(name, state, cols, cap)
                runs[name] = (lambda run: lambda i: run(recs[i % 16]))(run)
            got = {k: [] for k in names}
            for k in turns:
                got[k].append(device_ms(torch, runs[k]))
            med = {k: statistics.median(v) for k, v in got.items()}
            b_bytes, b_sec = (statistics.median(x) for x in zip(*(bound_ms(h, cap) for h in host)))
            what = (f"{width} {'contiguous' if contiguous else 'random'} slots, cap "
                    f"{'2^20' if cap == CAP_SERVE else '10^8'}")
            print(f"[time] {what}: " + ", ".join(
                f"{k} {v * 1e3:.2f} us" for k, v in sorted(med.items(), key=lambda kv: kv[1]))
                + f"; bound {b_bytes * 1e3:.3f} us (bytes), {b_sec * 1e3:.3f} us (32-byte "
                f"sectors) | {card}")
        del state, cols
        torch.cuda.empty_cache()
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
