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
// K7's design: two launches on one stream.  (a) one thread per (row,
// entry) does the add, the store and the previous plane's read and writes
// its row estimate to an int64 scratch [depth, size]; (b) one thread per
// lane takes the minimum over rows at its positions.  Bound: bytes.  The
// pin's 3*depth rows that K7 reads (indexes, hits, positions) at
// 3*depth*size*4 bytes and the 4 B of frac (row 1, the per-lane hits,
// is the host's), 12 B per valid cell (the current cell read and
// written, the previous one read) and 8*size bytes out: for 1000 keys
// at depth 4 (size 1024) about 0.08 MB, 0.02-0.03 us at 3.35 TB/s.  So
// two launch floors bound K7; the design adds the scratch
// (16 B per entry, written and read back, in L2) to avoid a grid-wide
// barrier between the adds and the minimum, and issues the two cell loads
// of an entry at once so that one memory latency covers both.
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

// a / b rounded towards minus infinity (C++ `/` rounds towards zero).
__device__ __forceinline__ long long floor_div(long long a, long long b) {
  long long q = a / b;
  if (a % b != 0 && ((a < 0) != (b < 0))) --q;
  return q;
}

__device__ __forceinline__ long long clamp_i32(long long v) {
  return v < INT_MIN ? INT_MIN : (v > INT_MAX ? INT_MAX : v);
}

// (a) One thread per (row r, entry j), t = r * size + j.
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
    const long long v = clamp_i32(static_cast<long long>(*cur_cell) + hits);
    *cur_cell = static_cast<int32_t>(v);
    const long long frac = __ldg(pin + 2);
    est = floor_div(prev * (kQ16 - frac), kQ16) + v;
  } else {
    est = clamp_i32(hits);
  }
  row_est[t] = est;
}

// (b) One thread per lane: the minimum over rows at the lane's positions.
__global__ void __launch_bounds__(kThreads)
sketch_estimate_kernel(const int32_t* __restrict__ pin, int depth, int size,
                       const long long* __restrict__ row_est, int32_t* __restrict__ out) {
  const int lane = blockIdx.x * kThreads + threadIdx.x;
  if (lane >= size) return;
  long long est = LLONG_MAX;
  for (int r = 0; r < depth; ++r) {
    const int pos = __ldg(pin + static_cast<long long>(4 + 3 * r) * size + lane);
    const long long e = __ldg(row_est + static_cast<long long>(r) * size + pos);
    est = e < est ? e : est;
  }
  const unsigned long long u = static_cast<unsigned long long>(est);
  out[lane] = static_cast<int32_t>(static_cast<uint32_t>(u >> 32));
  out[size + lane] = static_cast<int32_t>(static_cast<uint32_t>(u));
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

}  // namespace

// counts: int32 [2, depth, width]; pin: int32 [2 + 3*depth, size] (size
// >= 1, positions in [0, size)); cur: 0 or 1; out: int32 [2, size];
// row_est: int64 [depth, size] scratch; stream: a cudaStream_t.  Returns
// the first nonzero cudaGetLastError() of the two launches, else 0.
extern "C" int guber_sketch_step(void* counts, int depth, long long width, const void* pin,
                                 int size, int cur, void* out, void* row_est, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long entries = static_cast<long long>(depth) * size;
  const int32_t* p = static_cast<const int32_t*>(pin);
  long long* est = static_cast<long long*>(row_est);
  sketch_add_kernel<<<static_cast<unsigned>((entries + kThreads - 1) / kThreads), kThreads, 0,
                      s>>>(static_cast<int32_t*>(counts), depth, width, p, size, cur, est);
  const int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  sketch_estimate_kernel<<<(size + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      p, depth, size, est, static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
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
