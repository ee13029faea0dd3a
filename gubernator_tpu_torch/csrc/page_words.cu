// K9 and K10: the page spill and refill of paged state, for Hopper (sm_90a).
//
// Replace gubernator_tpu/ops/bucket_kernel.py:1596 `gather_page_words`
// (K9, the spill) and :1612 `_load_page_words_impl` (K10, the refill; jit
// with the state donated at :1629), the XLA programs behind
// gubernator_tpu/core/paging.py's `_spill` / `_refill`.  The plain PyTorch
// versions are gubernator_tpu_torch/ops/bucket_kernel.py
// `gather_page_words_reference` / `load_page_words_reference`.
//
// A page is the raw words of the 12 state columns at device rows
// [start, start + P): one int32 [12, P] block, a row per column in
// BucketState order.  The reference bitcasts its uint32 columns to int32;
// the port holds them as int32 already, so the block is a plain copy.
//
// The reference moves one page per program.  These kernels take k pages
// a launch (the page starts in an int32 [k] device array), so the faults
// of one batch spill in one K9 and refill in one K10:
//   K9  gather_pages: columns at starts[i] -> block out[i] (int32 [k, 12, P])
//   K10 load_pages:   block words[i] -> columns at starts[i], in place
// A start is taken as the reference's dynamic slice takes it: a negative
// one counts from the end, then it is clamped so that its page lies inside
// [0, cap); the engine's starts are frame * P and never need either.  K10's pages must not overlap (the engine's are
// distinct frames).
//
// Grid: (row chunk, column, page); a thread moves four rows with one
// 16-byte load and one 16-byte store, neighbouring threads on neighbouring
// addresses on both sides.  P is a multiple of 4 and the column and block
// base pointers are 16-byte aligned (the wrapper checks both); a start
// that is not a multiple of 4 takes four 4-byte moves instead.
//
// Bound: bytes.  A page reads 12 * 4 * P bytes and writes as many: at
// P = 512, 2 x 24,576 B, 0.0147 us at 3.35 TB/s; at P = 64, 0.0018 us.  A
// fault batch moves at most a few hundred pages, so the launch (~2 us) is
// the cost at every size the engine uses; the design keeps it to one
// launch per batch and direction.

#include <cstdint>
#include <cuda_runtime.h>

#include "lane_math.cuh"

namespace {

using lane::Cols;
using lane::kCols;

constexpr int kMaxThreads = 256;
constexpr int kMaxPagesInGrid = 65535;  // gridDim.z limit; pages beyond loop

__device__ __forceinline__ long long clamp_start(int32_t s, long long cap, int page) {
  long long v = s < 0 ? s + cap : s;
  if (v > cap - page) v = cap - page;
  return v < 0 ? 0 : v;
}

// kLoad = false: K9 (columns -> blocks); true: K10 (blocks -> columns).
template <bool kLoad>
__device__ __forceinline__ void move_pages(const Cols& st, long long cap,
                                           const int32_t* __restrict__ starts, int k, int page,
                                           int32_t* blocks) {
  const int c = blockIdx.y;
  const int quads = page >> 2;
  for (int pg = blockIdx.z; pg < k; pg += gridDim.z) {
    const long long s = clamp_start(starts[pg], cap, page);
    int32_t* col = st.p[c] + s;
    int32_t* blk = blocks + ((size_t)pg * kCols + c) * page;
    const bool aligned = (s & 3) == 0;
    for (int q = blockIdx.x * blockDim.x + threadIdx.x; q < quads; q += gridDim.x * blockDim.x) {
      if (aligned) {
        if (kLoad) {
          reinterpret_cast<int4*>(col)[q] = reinterpret_cast<const int4*>(blk)[q];
        } else {
          reinterpret_cast<int4*>(blk)[q] = reinterpret_cast<const int4*>(col)[q];
        }
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = 4 * q + j;
          if (kLoad) {
            col[r] = blk[r];
          } else {
            blk[r] = col[r];
          }
        }
      }
    }
  }
}

// K9
__global__ void __launch_bounds__(kMaxThreads)
gather_pages_kernel(Cols st, long long cap, const int32_t* __restrict__ starts, int k, int page,
                    int32_t* out) {
  move_pages<false>(st, cap, starts, k, page, out);
}

// K10
__global__ void __launch_bounds__(kMaxThreads)
load_pages_kernel(Cols st, long long cap, const int32_t* __restrict__ starts, int k, int page,
                  int32_t* words) {
  move_pages<true>(st, cap, starts, k, page, words);
}

template <bool kLoad>
int launch(void* const* cols, long long cap, const void* starts, int k, int page, void* blocks,
           void* stream) {
  Cols st;
  for (int c = 0; c < kCols; ++c) st.p[c] = static_cast<int32_t*>(cols[c]);
  const int quads = page >> 2;
  int threads = quads < kMaxThreads ? quads : kMaxThreads;
  threads = (threads + 31) / 32 * 32;
  const dim3 grid((quads + threads - 1) / threads, kCols,
                  k < kMaxPagesInGrid ? k : kMaxPagesInGrid);
  const auto kernel = kLoad ? load_pages_kernel : gather_pages_kernel;
  kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      st, cap, static_cast<const int32_t*>(starts), k, page, static_cast<int32_t*>(blocks));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// cols: the 12 state columns (int32 [cap] each, BucketState order, 16-byte
// aligned); starts: int32 [k] on the device, k >= 1; page: rows a page, a
// multiple of 4 in [4, cap]; out / words: int32 [k, 12, page], 16-byte
// aligned; stream: a cudaStream_t.  Each returns cudaGetLastError() after
// its launch.
extern "C" int guber_gather_pages(void* const* cols, long long cap, const void* starts, int k,
                                  int page, void* out, void* stream) {
  return launch<false>(cols, cap, starts, k, page, out, stream);
}

extern "C" int guber_load_pages(void* const* cols, long long cap, const void* starts, int k,
                                int page, const void* words, void* stream) {
  return launch<true>(cols, cap, starts, k, page, const_cast<void*>(words), stream);
}
