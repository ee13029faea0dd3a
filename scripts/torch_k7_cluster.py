#!/usr/bin/env python3
"""K7 (the count-min sketch's step) beside the thread-block-cluster design
tried for it and not kept, and beside its two-launch form without
programmatic dependent launch (the design K7 had before), timed on one GPU
in one run.

    python3 scripts/torch_k7_cluster.py

The cluster design: one launch of one cluster of C blocks (C = 2, 4, 8,
or 16, a non-portable size) from `cudaLaunchKernelEx` with a cluster
dimension.  Block k owns lanes [k·L, (k+1)·L), L = size / C, and the same
entries of every row; thread t takes entries f = t + i·T (i < K = 1, 2 or
4).  Phase 1 reads their pin words (index, hits, position), then all
their cells at once, then adds, stores and writes each row estimate to
its block's shared memory; `cluster.sync()`; phase 2: entry (r, j) reads
row r's estimate at lane j's position from the owning block's shared
memory (`map_shared_rank`); `cluster.sync()`; each lane takes its
minimum over rows.  The port keeps the C = 1 case of it, launched as one
plain block (csrc/sketch.cu, the block form), and the pair form with
programmatic dependent launch.

At depth 4 and widths 2^20 and 2^24, on zipf pins of 64, 256, 1024 and
8192 lanes (3/4 of them keys), every cluster shape (each C at the fewest
entries a thread that fits) is first held bit-equal to
`sketch_step_reference`, planes and output; then K7 as the port plans
it (`ops.sketch.sketch_step`), its block and pair forms forced through
`launch_step`, the pair without programmatic dependent launch and the
cluster shapes are timed with CUDA events behind a spin kernel in four
turns (the list, the list reversed, and both again from its middle; each
figure the median of its turns), after empty kernels: a plain one-block
launch and clusters of 2 to 16 blocks that meet at one `cluster.sync()`.
Prints one line per width and size, fastest first, then the card's name
and power limit.  The source below
is built with the port's nvcc flags into gubernator_tpu_torch/csrc/build/.
"""

from __future__ import annotations

import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

CLUSTER_CU = r"""
#include <climits>
#include <cstdint>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr long long kQ16 = 65536;
constexpr int kThreads = 256;
constexpr int kMaxShared = 232448;

__device__ __forceinline__ long long floor_div(long long a, long long b) {
  long long q = a / b;
  if (a % b != 0 && ((a < 0) != (b < 0))) --q;
  return q;
}
__device__ __forceinline__ long long clamp_i32(long long v) {
  return v < INT_MIN ? INT_MIN : (v > INT_MAX ? INT_MAX : v);
}
__device__ __forceinline__ long long row_estimate(long long cur_v, long long prev_v, long long hits,
                                                  long long frac, int32_t* stored) {
  const long long v = clamp_i32(cur_v + hits);
  *stored = static_cast<int32_t>(v);
  return floor_div(prev_v * (kQ16 - frac), kQ16) + v;
}
__device__ __forceinline__ void write_estimate(int32_t* out, int size, int lane, long long est) {
  const unsigned long long u = static_cast<unsigned long long>(est);
  out[lane] = static_cast<int32_t>(static_cast<uint32_t>(u >> 32));
  out[size + lane] = static_cast<int32_t>(static_cast<uint32_t>(u));
}

template <int K>
__global__ void __launch_bounds__(1024)
cluster_kernel(int32_t* __restrict__ counts, int depth, long long width,
               const int32_t* __restrict__ pin, int size, int cur, int32_t* __restrict__ out,
               int lanes, int shift) {
  extern __shared__ long long smem[];
  long long* est = smem;
  long long* seen = smem + depth * lanes;
  cg::cluster_group cluster = cg::this_cluster();
  const int base = static_cast<int>(cluster.block_rank()) * lanes;
  const int n_ent = depth * lanes;
  const int T = blockDim.x;
  const long long plane = static_cast<long long>(depth) * width;
  const long long frac = __ldg(pin + 2);
  int32_t idx[K], add[K], pos[K], c[K], p[K];
#pragma unroll
  for (int i = 0; i < K; ++i) {
    const int f = threadIdx.x + i * T;
    idx[i] = -1;
    add[i] = pos[i] = 0;
    if (f < n_ent) {
      const long long row = static_cast<long long>(2 + 3 * (f >> shift)) * size;
      const int j = base + (f & (lanes - 1));
      idx[i] = __ldg(pin + row + j);
      add[i] = __ldg(pin + row + size + j);
      pos[i] = __ldg(pin + row + 2 * size + j);
    }
  }
#pragma unroll
  for (int i = 0; i < K; ++i) {
    const int f = threadIdx.x + i * T;
    c[i] = p[i] = 0;
    if (f < n_ent && idx[i] >= 0 && idx[i] < width) {
      const long long cell = static_cast<long long>(f >> shift) * width + idx[i];
      c[i] = counts[cur * plane + cell];
      p[i] = counts[(1 - cur) * plane + cell];
    }
  }
#pragma unroll
  for (int i = 0; i < K; ++i) {
    const int f = threadIdx.x + i * T;
    if (f >= n_ent) continue;
    if (idx[i] >= 0 && idx[i] < width) {
      const long long cell = static_cast<long long>(f >> shift) * width + idx[i];
      est[f] = row_estimate(c[i], p[i], add[i], frac, counts + cur * plane + cell);
    } else {
      est[f] = clamp_i32(add[i]);
    }
  }
  cluster.sync();
#pragma unroll
  for (int i = 0; i < K; ++i) {
    const int f = threadIdx.x + i * T;
    if (f >= n_ent) continue;
    const long long* owner = cluster.map_shared_rank(est, pos[i] >> shift);
    seen[f] = owner[((f >> shift) << shift) + (pos[i] & (lanes - 1))];
  }
  cluster.sync();
  for (int j = threadIdx.x; j < lanes; j += T) {
    long long m = LLONG_MAX;
    for (int r = 0; r < depth; ++r) {
      const long long e = seen[(r << shift) + j];
      m = e < m ? e : m;
    }
    write_estimate(out, size, base + j, m);
  }
}

// The two launches K7 had before, the second without programmatic dependent launch.
__global__ void __launch_bounds__(kThreads)
add_kernel(int32_t* __restrict__ counts, int depth, long long width,
           const int32_t* __restrict__ pin, int size, int cur, long long* __restrict__ row_est) {
  const long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= static_cast<long long>(depth) * size) return;
  const int r = static_cast<int>(t / size);
  const int j = static_cast<int>(t - static_cast<long long>(r) * size);
  const int32_t idx = __ldg(pin + static_cast<long long>(2 + 3 * r) * size + j);
  const long long hits = __ldg(pin + static_cast<long long>(3 + 3 * r) * size + j);
  long long est;
  if (idx >= 0 && idx < width) {
    const long long plane = static_cast<long long>(depth) * width;
    const long long cell = static_cast<long long>(r) * width + idx;
    int32_t* cur_cell = counts + cur * plane + cell;
    const long long prev = counts[(1 - cur) * plane + cell];
    est = row_estimate(*cur_cell, prev, hits, __ldg(pin + 2), cur_cell);
  } else {
    est = clamp_i32(hits);
  }
  row_est[t] = est;
}
__global__ void __launch_bounds__(kThreads)
estimate_kernel(const int32_t* __restrict__ pin, int depth, int size,
                const long long* __restrict__ row_est, int32_t* __restrict__ out) {
  const int lane = blockIdx.x * kThreads + threadIdx.x;
  if (lane >= size) return;
  long long est = LLONG_MAX;
  for (int r = 0; r < depth; ++r) {
    const int pos = __ldg(pin + static_cast<long long>(4 + 3 * r) * size + lane);
    const long long e = __ldg(row_est + static_cast<long long>(r) * size + pos);
    est = e < est ? e : est;
  }
  write_estimate(out, size, lane, est);
}

__global__ void empty_kernel() {}
__global__ void empty_cluster_kernel() { cg::this_cluster().sync(); }

using Kernel = void (*)(int32_t*, int, long long, const int32_t*, int, int, int32_t*, int, int);
Kernel pick(int k) {
  return k == 1 ? cluster_kernel<1> : k == 2 ? cluster_kernel<2> : k == 4 ? cluster_kernel<4>
                                                                         : nullptr;
}

}  // namespace

// One call of the cluster design: `cluster` blocks of `threads`, K =
// per_thread, 16 * depth * (size / cluster) bytes of shared memory a
// block.  Returns -1 for a shape it does not take, else the cudaError.
extern "C" int cluster_step(void* counts, int depth, long long width, const void* pin, int size,
                            int cur, void* out, int cluster, int threads, int per_thread,
                            void* stream) {
  const Kernel kern = pick(per_thread);
  const int lanes = size / cluster;
  if (kern == nullptr || cluster < 2 || cluster > 16 || size % cluster || (lanes & (lanes - 1)) ||
      static_cast<long long>(threads) * per_thread < static_cast<long long>(depth) * lanes)
    return -1;
  const int shared = 16 * depth * lanes;
  if (shared > kMaxShared || threads > 1024) return -1;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxShared);
  if (e == cudaSuccess) e = cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return static_cast<int>(e);
  int shift = 0;
  while ((1 << shift) < lanes) ++shift;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = shared;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kern, static_cast<int32_t*>(counts), depth, width,
                         static_cast<const int32_t*>(pin), size, cur, static_cast<int32_t*>(out),
                         lanes, shift);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

// An empty kernel of one block (cluster 0), or an empty cluster of
// `cluster` blocks whose threads meet at one cluster.sync().
extern "C" int empty_step(int cluster, int threads, void* stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster > 0 ? cluster : 1, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = cluster > 0 ? 1 : 0;
  cudaError_t e = cudaFuncSetAttribute(empty_cluster_kernel,
                                       cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e == cudaSuccess)
    e = cluster > 0 ? cudaLaunchKernelEx(&cfg, empty_cluster_kernel)
                    : cudaLaunchKernelEx(&cfg, empty_kernel);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

// The two launches without programmatic dependent launch.
extern "C" int pair_step(void* counts, int depth, long long width, const void* pin, int size,
                         int cur, void* out, void* row_est, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long entries = static_cast<long long>(depth) * size;
  add_kernel<<<static_cast<unsigned>((entries + kThreads - 1) / kThreads), kThreads, 0, s>>>(
      static_cast<int32_t*>(counts), depth, width, static_cast<const int32_t*>(pin), size, cur,
      static_cast<long long*>(row_est));
  const int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  estimate_kernel<<<(size + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      static_cast<const int32_t*>(pin), depth, size, static_cast<const long long*>(row_est),
      static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
"""

DEPTH = 4
SIZES = (64, 256, 1024, 8192)
WIDTHS = (1 << 20, 1 << 24)
CLUSTERS = (2, 4, 8, 16)
PER_THREAD = (1, 2, 4)
NOW = 1_760_000_000_000


def build():
    from gubernator_tpu_torch.ops import native_build as nb

    out = nb.BUILD_DIR / "k7_cluster"
    out.mkdir(parents=True, exist_ok=True)
    src, so = out / "k7_cluster.cu", out / "libk7_cluster.so"
    src.write_text(CLUSTER_CU)
    r = subprocess.run([nb.nvcc_path(), *nb.NVCC_FLAGS, "-o", str(so), str(src)],
                       capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{r.stdout}\n{r.stderr}")
    lib = ctypes.CDLL(str(so))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.cluster_step.argtypes = [p, i, ctypes.c_longlong, p, i, i, p, i, i, i, p]
    lib.cluster_step.restype = i
    lib.pair_step.argtypes = [p, i, ctypes.c_longlong, p, i, i, p, p, p]
    lib.pair_step.restype = i
    lib.empty_step.argtypes = [i, i, p]
    lib.empty_step.restype = i
    return lib


def shapes(size: int) -> list:
    """(C, T, K) of the cluster design at `size` lanes: each C at the fewest
    entries a thread whose block of at most 1024 threads holds them."""
    got = []
    for c in CLUSTERS:
        if size % c or (size // c) & (size // c - 1):
            continue
        entries = DEPTH * (size // c)
        for k in PER_THREAD:
            threads = -(-entries // k)  # ceil
            threads = max(32, -(-threads // 32) * 32)
            if threads <= 1024:
                got.append((c, threads, k))
                break
    return got


def device_ms(torch, fn, n: int = 200, windows: int = 5) -> float:
    per = []
    for _ in range(windows):
        torch.cuda._sleep(100_000_000)
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for k in range(n):
            fn(k)
        b.record()
        b.synchronize()
        per.append(a.elapsed_time(b) / n)
    return statistics.median(per)


def pins_for(np, rng, width: int, size: int, count: int = 8):
    """Zipf pins of `size` lanes, 3/4 of them keys (mixed-sign hits, a hot
    key of 4 x 2^30), read at frac 0.3."""
    from gubernator_tpu_torch import hashing
    from gubernator_tpu_torch.ops import sketch as ps

    out = []
    for k in range(count):
        n = size * 3 // 4
        ids = (rng.zipf(1.2, n - 4) - 1) % 100_000_000
        keys = [b"sk_hot"] * 4 + [b"sk_%d" % x for x in ids.tolist()]
        hits = np.concatenate([[2**30] * 4, rng.choice([-7, -1, 0, 1, 2, 5], n - 4)])
        rows = ps.row_indexes(hashing.fnv1a_64_batch(*hashing.pack_keys(keys)), DEPTH, width)
        pin = ps.pack_pin(rows, hits.astype(np.int64), NOW + 300 + k, 1000, width)
        if pin.shape[1] < size:
            wide = np.zeros((pin.shape[0], size), np.int32)
            wide[:, : pin.shape[1]] = pin
            wide[2::3, pin.shape[1]:] = np.arange(width + pin.shape[1], width + size)
            pin = wide
        out.append(pin)
    return out


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_k7_cluster: needs a CUDA device", file=sys.stderr)
        return 2
    from gubernator_tpu_torch.ops import sketch as ps
    from gubernator_tpu_torch.ops.fused_step import stream_of

    lib = build()
    dev = torch.device("cuda", torch.cuda.current_device())
    stream = stream_of(dev)
    rng = np.random.default_rng(20261018)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()

    def cluster_run(counts, pin, cur, shape):
        c, t, k = shape
        out = torch.empty((2, pin.shape[1]), dtype=torch.int32, device=dev)
        rc = lib.cluster_step(counts.data_ptr(), DEPTH, counts.shape[2], pin.data_ptr(),
                              pin.shape[1], cur, out.data_ptr(), c, t, k, stream)
        if rc != 0:
            raise RuntimeError(f"cluster C={c} T={t} K={k}: rc {rc}")
        return out

    def pair_run(counts, pin, cur):
        out = torch.empty((2, pin.shape[1]), dtype=torch.int32, device=dev)
        est = torch.empty((DEPTH, pin.shape[1]), dtype=torch.int64, device=dev)
        rc = lib.pair_step(counts.data_ptr(), DEPTH, counts.shape[2], pin.data_ptr(),
                           pin.shape[1], cur, out.data_ptr(), est.data_ptr(), stream)
        if rc != 0:
            raise RuntimeError(f"pair without PDL: rc {rc}")
        return out

    empties = {}
    for c, t in ((0, 256), (2, 256), (4, 256), (8, 256), (16, 256), (16, 1024)):
        if lib.empty_step(c, t, stream) != 0:
            raise RuntimeError(f"empty kernel, cluster {c}: launch failed")
        empties[f"C={c} T={t}" if c else f"plain T={t}"] = device_ms(
            torch, lambda n: lib.empty_step(c, t, stream))
    print("[time] empty kernels (a plain one-block launch; clusters of C blocks meeting at one "
          "cluster.sync()), us: " + "; ".join(f"{k} {v * 1e3:.2f}" for k, v in empties.items())
          + f" | {card}", flush=True)
    for width in WIDTHS:
        g = torch.Generator(device=dev)
        g.manual_seed(width)
        base = torch.randint(-1000, 1000, (2, DEPTH, width), dtype=torch.int32, device=dev,
                             generator=g)
        base[:, :, ::5] = 2**31 - 9
        for size in SIZES:
            pins = [torch.from_numpy(p).to(dev) for p in pins_for(np, rng, width, size)]
            designs = {f"C={c} T={t} K={k}": (lambda s: lambda cn, pn, cu: cluster_run(
                cn, pn, cu, s))((c, t, k)) for c, t, k in shapes(size)}
            designs["pair without PDL (the earlier K7)"] = pair_run
            holds = dict(designs)
            plan = ps.plan_sketch_step(DEPTH, size)
            designs[f"K7 ({plan.form} form)"] = lambda cn, pn, cu: ps.sketch_step(cn, pn, cu)
            if plan.form == "block":
                designs["K7 pair form"] = lambda cn, pn, cu: ps.launch_step(cn, pn, cu,
                                                                           ps.PAIR_PLAN)
            plain = base.clone()
            want = ps.sketch_step_reference(plain, pins[0], 1)
            for name, run in holds.items():
                kern = base.clone()
                got = run(kern, pins[0], 1)
                torch.cuda.synchronize()
                if not (torch.equal(got, want) and torch.equal(kern, plain)):
                    print(f"[hold] {name} differs from sketch_step_reference: width {width}, "
                          f"size {size}")
                    return 1
            names = list(designs)
            half = len(names) // 2
            turns = names + names[::-1] + names[half:] + names[:half]
            turns += (names[half:] + names[:half])[::-1]
            counts = base.clone()
            got = {k: [] for k in names}
            for k in turns:
                run = designs[k]
                got[k].append(device_ms(torch, lambda n: run(counts, pins[n % 8], n & 1)))
            med = sorted(((statistics.median(v), k) for k, v in got.items()))
            print(f"[time] width {width}, {size} lanes ({size * 3 // 4} keys; held bit-equal: "
                  f"{', '.join(holds)}), us a call, fastest first: "
                  + "; ".join(f"{k} {t * 1e3:.2f}" for t, k in med) + f" | {card}", flush=True)
        del base
        torch.cuda.empty_cache()
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
