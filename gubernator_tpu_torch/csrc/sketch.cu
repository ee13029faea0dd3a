// K7 and K8: the count-min sketch's step and its window rotation, for
// Hopper (sm_90a).
//
// K7 replaces gubernator_tpu/ops/sketch.py:99 `_sketch_step_impl` (an XLA
// flat gather, scatter and gather over the planes).  State: int32 counts
// [2, depth, width], plane `cur` the current window, plane 1 - cur the
// previous one.  Input: the host-packed pin, int32 [2 + 3*depth, size]:
// pin[0][2] the elapsed fraction of the window in Q16, and for row r the
// row's unique cell indexes (2 + 3r; an index outside [0, width) is
// padding), their summed hits (3 + 3r) and each lane's position among them
// (4 + 3r).  The host has already combined a row's duplicates (int64 sums
// clamped to int32), so no two entries of a row touch one cell and no
// atomics are needed; an atomicAdd per lane would saturate in another
// order for mixed-sign hits and stop being bit-equal.  For each entry:
//   v = clamp_int32((int64)counts[cur][r][idx] + hits), stored back;
//   row_est = floor((int64)counts[prev][r][idx] * (65536 - frac) / 65536) + v
// (a padding entry stores nothing and its row_est is clamp_int32(hits)).
// Then each lane's estimate is the minimum over rows of the row_est at its
// position, written as the hi and lo words of the int64 (out int32
// [2, size]).  The division FLOORS, as the reference's `//` does: C's `/`
// truncates, and -7 * 45876 / 65536 would give -4 where the reference
// gives -5.  The plain PyTorch versions are
// gubernator_tpu_torch/ops/sketch.py `sketch_step_reference` and
// `rotate_reference`.
//
// What bounds K7: bytes, and one launch floor.  The pin's 3*depth rows
// that K7 reads (indexes, hits, positions) at 3*depth*size*4 bytes and
// the 4 B of frac (row 1, the per-lane hits, is the host's), 12 B per
// valid cell (the current cell read and written, the previous one read)
// and 8*size bytes out: for 1000 keys at depth 4 (size 1024) about 0.08
// MB, 0.02-0.03 us at 3.35 TB/s, far below the 1.7 us an empty kernel
// costs on an H100 in a back-to-back queue.  So the aim is as few launch
// floors as the work allows, and few memory latencies after them.
//
// Two forms; `plan_sketch_step(depth, size)` in ops/sketch.py picks one
// from (depth, size) alone, and the launcher refuses a plan it cannot
// launch (no fallback from one form to the other):
//
// * The block form, one launch, while depth * size <= 1024 (pins of up to
//   256 lanes at depth 4): one block, thread f takes entry f = (row
//   f / size, lane f % size).  It reads its index, hits and position (one
//   latency), then its two cells (one more), adds, stores and writes the
//   row estimate to shared memory; __syncthreads(); each entry reads its
//   row's estimate at its lane's position; __syncthreads(); each lane
//   takes its minimum over rows.  No scratch in device memory, no second
//   launch.
// * The pair form, two launches on one stream, above that: (a) one thread
//   per (row, entry) does the add, the store and the previous plane's
//   read and writes its row estimate to an int64 scratch [depth, size]
//   (16 B per entry written and read back, in L2) in place of a grid-wide
//   barrier; (b) one thread per lane takes the minimum over rows at its
//   positions.  (b) is launched with programmatic dependent launch
//   (cudaLaunchAttributeProgrammaticStreamSerialization): (a) signals
//   after its stores (griddepcontrol.launch_dependents, what
//   cudaTriggerProgrammaticLaunchCompletion() compiles to), and (b) reads
//   its first row's positions, then waits for (a)'s grid and its stores
//   (griddepcontrol.wait, cudaGridDependencySynchronize()) before it reads
//   the scratch, so that (b)'s launch overlaps (a).
//
// Measured on an H100 80GB HBM3 at 700 W (CUDA events behind a spin
// kernel, depth 4, width 2^20): the block form 2.62 us at 64 lanes and
// 3.27 at 256, where the pair form takes 3.62 and 3.68; the pair form
// 3.99 us at 1024 lanes, 4.32 at 8192, 6.45 at 32768, where the same two
// launches without programmatic dependent launch took 4.97, 5.26 and
// 8.02.  Above 256 lanes one block loses: its SM alone would issue every
// random cell read.
//
// Tried and not kept: the thread-block cluster.  One launch of one
// cluster of C = 2, 4, 8 or 16 blocks (cudaLaunchKernelEx with a cluster
// dimension; 16 a non-portable size), block k owning lanes [k*L, (k+1)*L)
// and the same entries of every row, the row estimates in each block's
// shared memory, phase 2 reading the owning block's through distributed
// shared memory (cluster.map_shared_rank) between two cluster.sync()s.
// It was slower than the pair form at every size from 128 lanes up (4.51
// us at 1024 lanes for the best shape, C = 16; 12.98 at 8192) and than
// the block form below: an empty cluster kernel that meets at one
// cluster.sync() costs more than an empty plain launch, and the C SMs of
// one cluster issue all the random cell reads (the script times both).
// scripts/torch_k7_cluster.py builds it and times it beside K7.
//
// K8 replaces gubernator_tpu/ops/sketch.py:63 `_rotate`: a window step
// zeroes the previous plane (which becomes current), a gap of two or more
// windows zeroes both.  The host picks the span (one plane or all of
// counts) and keeps `cur`; the kernel is a grid-stride fill with 16-byte
// stores.  Bound: bytes, the span written once: 16 MiB for one plane at
// depth 4 and width 2^20, 5.0 us at 3.35 TB/s.
//
// Tried for K8 and not kept: Hopper's bulk asynchronous copy (TMA,
// `cp.async.bulk.global.shared::cta.bulk_group`) of a zeroed shared-memory
// tile, one elected thread a block, from a persistent grid of one or two
// blocks an SM each owning one contiguous run of the span, and with 16 KiB
// chunks dealt out one a block.  On an H100 it did not beat this fill: the
// persistent grid was no faster at width 2^20 and 14 % slower at 2^24; the
// dealt chunks were 2-3 % faster at 2^24 but 4 % slower on both planes at
// 2^20, the default width.
// scripts/torch_k8_tma.py builds that design and times it beside K8 and
// `zero_()`.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kQ16 = 65536;
constexpr int kMaxFillBlocks = 132 * 16;

// The plan's forms (ops/sketch.py SketchPlan.form) and their limits.
constexpr int kFormPair = 0;
constexpr int kFormBlock = 1;
constexpr int kPlanRefused = -1;  // returned for a plan the launcher cannot launch
constexpr int kMaxBlockThreads = 1024;

// a / b rounded towards minus infinity (C++ `/` rounds towards zero).
__device__ __forceinline__ long long floor_div(long long a, long long b) {
  long long q = a / b;
  if (a % b != 0 && ((a < 0) != (b < 0))) --q;
  return q;
}

__device__ __forceinline__ long long clamp_i32(long long v) {
  return v < INT_MIN ? INT_MIN : (v > INT_MAX ? INT_MAX : v);
}

// The row estimate of one entry whose current and previous cells hold
// `cur_v` and `prev_v`; `*stored` gets the new current count.
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

// The block form: one block, thread f takes entry f = (row f / size, lane
// f % size), f < depth * size <= blockDim.x.
__global__ void __launch_bounds__(kMaxBlockThreads)
sketch_block_kernel(int32_t* __restrict__ counts, int depth, long long width,
                    const int32_t* __restrict__ pin, int size, int cur,
                    int32_t* __restrict__ out) {
  // [depth][size] twice: the row estimates, then the estimate each entry
  // reads at its lane's position.
  extern __shared__ long long smem[];
  long long* est = smem;
  long long* seen = smem + depth * size;
  const int f = threadIdx.x;
  const bool mine = f < depth * size;
  const int r = f / size;
  const int j = f - r * size;
  // The pin words (index, hits, and the position read below), then both
  // cells: one memory latency each.
  int32_t idx = -1, add = 0, pos = 0;
  if (mine) {
    const int32_t* row = pin + static_cast<long long>(2 + 3 * r) * size + j;
    idx = __ldg(row);
    add = __ldg(row + size);
    pos = __ldg(row + 2 * size);
  }
  const long long plane = static_cast<long long>(depth) * width;
  const long long cell = static_cast<long long>(r) * width + idx;
  const bool valid = mine && idx >= 0 && idx < width;
  int32_t c = 0, p = 0;
  if (valid) {
    c = counts[cur * plane + cell];
    p = counts[(1 - cur) * plane + cell];
  }
  if (mine)
    est[f] = valid ? row_estimate(c, p, add, __ldg(pin + 2), counts + cur * plane + cell)
                   : clamp_i32(add);
  __syncthreads();
  if (mine) seen[f] = est[r * size + pos];
  __syncthreads();
  if (f < size) {
    long long m = LLONG_MAX;
    for (int q = 0; q < depth; ++q) {
      const long long e = seen[q * size + f];
      m = e < m ? e : m;
    }
    write_estimate(out, size, f, m);
  }
}

// The pair form, (a): one thread per (row r, entry j), t = r * size + j.
__global__ void __launch_bounds__(kThreads)
sketch_add_kernel(int32_t* __restrict__ counts, int depth, long long width,
                  const int32_t* __restrict__ pin, int size, int cur,
                  long long* __restrict__ row_est) {
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
  // cudaTriggerProgrammaticLaunchCompletion(): (b) may start launching.
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

// The pair form, (b): one thread per lane, the minimum over rows at the
// lane's positions.  Launched as (a)'s programmatic dependent.
__global__ void __launch_bounds__(kThreads)
sketch_estimate_kernel(const int32_t* __restrict__ pin, int depth, int size,
                       const long long* __restrict__ row_est, int32_t* __restrict__ out) {
  const int lane = blockIdx.x * kThreads + threadIdx.x;
  const int pos0 = lane < size ? __ldg(pin + 4LL * size + lane) : 0;
  // cudaGridDependencySynchronize(): (a) has finished and its stores are visible.
  asm volatile("griddepcontrol.wait;" ::: "memory");
  if (lane >= size) return;
  long long est = LLONG_MAX;
  for (int r = 0; r < depth; ++r) {
    const int pos = r == 0 ? pos0 : __ldg(pin + static_cast<long long>(4 + 3 * r) * size + lane);
    const long long e = row_est[static_cast<long long>(r) * size + pos];
    est = e < est ? e : est;
  }
  write_estimate(out, size, lane, est);
}

// Zero n int32 words from p: 16-byte stores when p is 16-byte aligned,
// then the tail (or everything, unaligned) a word at a time.
__global__ void __launch_bounds__(kThreads)
fill_zero_kernel(int32_t* __restrict__ p, long long n) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  long long done = 0;
  if ((reinterpret_cast<uintptr_t>(p) & 15) == 0) {
    int4* v = reinterpret_cast<int4*>(p);
    const long long nv = n / 4;
    for (long long k = i; k < nv; k += stride) v[k] = make_int4(0, 0, 0, 0);
    done = nv * 4;
  }
  for (long long k = done + i; k < n; k += stride) p[k] = 0;
}

// Whether (threads, shared_bytes) is the block form's plan for (depth,
// size), as plan_sketch_step makes it.
bool block_plan_ok(int depth, int size, int threads, int shared_bytes) {
  if (depth < 1 || size < 1) return false;
  const long long entries = static_cast<long long>(depth) * size;
  return threads % 32 == 0 && entries <= threads && threads - 32 < entries &&
         threads <= kMaxBlockThreads && shared_bytes == 16 * entries;
}

}  // namespace

// One K7 call by a plan of ops/sketch.py `plan_sketch_step`.  counts:
// int32 [2, depth, width]; pin: int32 [2 + 3*depth, size] (size >= 1,
// positions in [0, size)); cur: 0 or 1; out: int32 [2, size]; row_est:
// int64 [depth, size] scratch for the pair form (null in the block form);
// form: 0 pair, 1 block; threads, shared_bytes: the plan's block (the
// pair form takes threads = 256, shared_bytes = 0); stream: a
// cudaStream_t.  Returns -1 for a plan it cannot launch, else the first
// nonzero cudaError of the call's launches, else 0.
extern "C" int guber_sketch_step(void* counts, int depth, long long width, const void* pin,
                                 int size, int cur, void* out, void* row_est, int form,
                                 int threads, int shared_bytes, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* p = static_cast<const int32_t*>(pin);
  int32_t* c = static_cast<int32_t*>(counts);
  int32_t* o = static_cast<int32_t*>(out);
  if (form == kFormBlock) {
    if (!block_plan_ok(depth, size, threads, shared_bytes)) return kPlanRefused;
    sketch_block_kernel<<<1, threads, shared_bytes, s>>>(c, depth, width, p, size, cur, o);
    return static_cast<int>(cudaGetLastError());
  }
  if (form != kFormPair || threads != kThreads || shared_bytes != 0 || row_est == nullptr ||
      depth < 1 || size < 1)
    return kPlanRefused;
  long long* est = static_cast<long long*>(row_est);
  const long long entries = static_cast<long long>(depth) * size;
  sketch_add_kernel<<<static_cast<unsigned>((entries + kThreads - 1) / kThreads), kThreads, 0,
                      s>>>(c, depth, width, p, size, cur, est);
  const int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((size + kThreads - 1) / kThreads, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.stream = s;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, sketch_estimate_kernel, p, depth, size,
                                           static_cast<const long long*>(est), o);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

// Zero n int32 words at p (one plane, or both) on `stream`.  Returns
// cudaGetLastError() after the launch.
extern "C" int guber_sketch_rotate(void* p, long long n, void* stream) {
  if (n <= 0) return 0;
  long long blocks = (n / 4 + kThreads - 1) / kThreads;
  blocks = blocks < 1 ? 1 : (blocks > kMaxFillBlocks ? kMaxFillBlocks : blocks);
  fill_zero_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(static_cast<int32_t*>(p), n);
  return static_cast<int>(cudaGetLastError());
}
