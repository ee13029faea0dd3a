// K11 and K12: the sharded engine's per-shard steps for Hopper (sm_90a),
// every shard of a round (K11) or of a collapsed chunk (K12) in one
// launch, over bucket state held as [n_sh, shard_cap] on one card.
//
// Replaces the vmapped programs of the reference's single-program sharded
// engine, gubernator_tpu/parallel/sharded_engine.py:323
// `_build_step_single_program`: `jax.vmap(_fused_step_core)` (:339,
// `_packed_fused`) and `jax.vmap(collapsed_fused_one)` (:347-353,
// `_collapsed_fused`), each with the shard's eviction clears that the
// reference runs just before as `jax.vmap(_clear_occupied_impl)` (:338,
// `_apply_shard_clears` :419).  Shard sh sees only its own block of each
// column, `p[c] + sh * shard_cap`, with the shard's own slots and padding:
// a lane is in range iff 0 <= slot < shard_cap, so a shard's padding
// lanes (`shard_cap + lane`, pack_batch_host / pack_collapsed_host with
// the shard's capacity) never reach the next shard's slots.  The plain
// PyTorch versions are gubernator_tpu_torch/ops/bucket_kernel.py
// `sharded_fused_step_reference` / `sharded_collapsed_step_reference`
// (after the shards' `clear_occupied_reference`); the two are bit-equal.
//
// K11 `shard_step_kernel`: pin int32 [n_sh, 16, W], pout [n_sh, 5, W];
// one round a launch (the reference dispatches one program a round).  A
// 2-D grid, (ceil(W / T), n_sh), one thread a lane, runs K1's lane body
// (csrc/general_lane.cuh `General::step`, the same code as K1's).  A
// round updates a slot at most once, so lanes never race and no barrier
// is needed.  Clears: clear_slots int32 [n_sh, C], each shard's row
// sorted ascending, entries outside [0, shard_cap) ignored.  A clear must
// land before the gather of the same slot.  The lane whose slot is in its
// shard's clear row (a binary search of the row) drops the occupied bit
// from its gathered meta word; the thread of a clear entry that is no
// lane's slot (a binary search of the shard's slot row, which the packer
// sorts) clears the word itself, since nothing else in the launch reads
// it.
//
// K12 `shard_collapsed_kernel`: pin int32 [n_sh, 19, W], pout
// [n_sh, 5, W], clear_slots [n_sh, C] in any order; a 2-D grid,
// (ceil(W / T), n_sh), each row K3's blocks over one shard's chunk:
// K3's tile (csrc/collapsed_tile.cuh, the same code as K3's) with the
// shard's columns, pin, clears, output and publish buffer.  Each shard
// has its own publication chain: `pub` holds one [1 + pub_tiles, 16]
// buffer a shard, row 0 its ticket counter, so a hot key's segment is
// published only to the blocks of its own shard and a block waits only
// on earlier tiles of its shard, which took their tickets first and are
// running.  Every shard of a launch takes ceil(W / T) tiles, so one
// `tiles_before` serves them all.
//
// Bound: bytes.  K11: per shard 8 B of header, per lane 60 B of pin and
// 20 B of pout, per in-range lane 48 B of state read and 48 B written,
// 12 B per in-range clear.  K12: K3's bound summed over the shards.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "collapsed_tile.cuh"
#include "general_lane.cuh"
#include "lane_math.cuh"

using namespace lane;

namespace {

constexpr int kStepThreads = 128;  // K11 threads per block
constexpr int kInRows = 16;        // K11 pin rows
constexpr int kCollapsedRows = 19;  // K12 pin rows
constexpr int kOutRows = 5;

// Whether the ascending row `a` [0, n) holds `v`.
__device__ __forceinline__ bool sorted_has(const int32_t* __restrict__ a, int n, int32_t v) {
  int lo = 0, hi = n;  // first index with a[i] >= v
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(a + mid) < v) lo = mid + 1; else hi = mid;
  }
  return lo < n && __ldg(a + lo) == v;
}

__device__ __forceinline__ Cols shard_cols(const Cols& st, long long shard_cap, int sh) {
  Cols c;
#pragma unroll
  for (int k = 0; k < kCols; ++k) c.p[k] = st.p[k] + (size_t)sh * (size_t)shard_cap;
  return c;
}

__global__ void __launch_bounds__(kStepThreads)
shard_step_kernel(Cols st, long long shard_cap, const int32_t* __restrict__ pin, int width,
                  const int32_t* __restrict__ clear_slots, int n_clear,
                  int32_t* __restrict__ pout) {
  const int sh = (int)blockIdx.y;
  const size_t w = (size_t)width;
  const Cols c = shard_cols(st, shard_cap, sh);
  const int32_t* p = pin + (size_t)sh * kInRows * w;
  const int32_t* slots = p + w;  // row 1, ascending
  const int32_t* cl = clear_slots + (size_t)sh * (size_t)n_clear;
  int32_t* o = pout + (size_t)sh * kOutRows * w;
  const int lane = (int)blockIdx.x * kStepThreads + (int)threadIdx.x;

  // Clears of slots no lane holds: nobody else touches them here.
  for (int i = lane; i < n_clear; i += (int)gridDim.x * kStepThreads) {
    const int32_t s = __ldg(cl + i);
    if (s >= 0 && (long long)s < shard_cap && !sorted_has(slots, width, s))
      c.p[kMeta][s] = __ldcg(c.p[kMeta] + s) & ~1;
  }
  if (lane < width) {
    const int32_t slot = __ldg(slots + lane);
    const bool clear = n_clear > 0 && slot >= 0 && (long long)slot < shard_cap &&
                       sorted_has(cl, n_clear, slot);
    General::step(c, shard_cap, General::header(p, 0), slots + lane, width, lane, o, w, clear);
  }
}

__global__ void __launch_bounds__(collapsed::kThreads)
shard_collapsed_kernel(Cols st, long long shard_cap, const int32_t* __restrict__ pin, int width,
                       const int32_t* __restrict__ clear_slots, int n_clear, int64_t* pub,
                       long long pub_rows, int64_t tiles_before, int32_t* __restrict__ pout) {
  const int sh = (int)blockIdx.y;
  const size_t w = (size_t)width;
  collapsed::collapsed_tile(shard_cols(st, shard_cap, sh), shard_cap,
                            pin + (size_t)sh * kCollapsedRows * w, width,
                            clear_slots + (size_t)sh * (size_t)n_clear, n_clear,
                            pub + (size_t)sh * (size_t)pub_rows * collapsed::kPub, tiles_before,
                            pout + (size_t)sh * kOutRows * w);
}

Cols make_cols(void* const* cols) {
  Cols c;
  for (int i = 0; i < kCols; ++i) c.p[i] = static_cast<int32_t*>(cols[i]);
  return c;
}

}  // namespace

// cols: 12 device pointers in BucketState field order, each
// [n_sh * shard_cap] ([n_sh, shard_cap] row-major); pin int32
// [n_sh, 16, width]; clear_slots int32 [n_sh, n_clear] (n_clear may be
// 0), each row ascending; pout int32 [n_sh, 5, width]; stream: a
// cudaStream_t.  Returns 0 once K11 is launched, else the cudaError.
extern "C" int guber_shard_step(void* const* cols, long long shard_cap, int n_sh,
                                const void* pin, int width, const void* clear_slots,
                                int n_clear, void* pout, void* stream) {
  if (width < 1 || n_sh < 1 || n_sh > 65535 || n_clear < 0 || shard_cap < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((width + kStepThreads - 1) / kStepThreads, n_sh);
  shard_step_kernel<<<grid, kStepThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      make_cols(cols), shard_cap, static_cast<const int32_t*>(pin), width,
      static_cast<const int32_t*>(clear_slots), n_clear, static_cast<int32_t*>(pout));
  return static_cast<int>(cudaGetLastError());
}

// cols as guber_shard_step; pin int32 [n_sh, 19, width], each shard's
// chunk laid out as `pack_collapsed_host` lays it out with capacity
// shard_cap; clear_slots int32 [n_sh, n_clear] in any order; pub int64
// [n_sh, 1 + pub_tiles, 16], zeroed when made and then used only by this
// entry point on one stream, with this n_sh; tiles_before: the tiles a
// shard took in the launches made with `pub` so far, sum of
// ceil(width / 64); pout int32 [n_sh, 5, width].  Returns 0 once K12 is
// launched, else the cudaError.
extern "C" int guber_shard_collapsed(void* const* cols, long long shard_cap, int n_sh,
                                     const void* pin, int width, const void* clear_slots,
                                     int n_clear, void* pub, long long pub_tiles,
                                     long long tiles_before, void* pout, void* stream) {
  constexpr int T = collapsed::kThreads;
  if (width < 1 || n_sh < 1 || n_sh > 65535 || n_clear < 0 || shard_cap < 1 ||
      tiles_before < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = (width + T - 1) / T;
  if (tiles > pub_tiles) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(tiles, n_sh);
  shard_collapsed_kernel<<<grid, T, 0, static_cast<cudaStream_t>(stream)>>>(
      make_cols(cols), shard_cap, static_cast<const int32_t*>(pin), width,
      static_cast<const int32_t*>(clear_slots), n_clear, static_cast<int64_t*>(pub),
      1 + pub_tiles, static_cast<int64_t>(tiles_before), static_cast<int32_t*>(pout));
  return static_cast<int>(cudaGetLastError());
}

// Lanes per tile of guber_shard_collapsed, for sizing `pub`.
extern "C" int guber_shard_collapsed_threads() { return collapsed::kThreads; }
