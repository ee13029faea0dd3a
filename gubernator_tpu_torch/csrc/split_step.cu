// K14, K15 and K16: the split arm's kernels for Hopper (sm_90a), the
// unfused compute + scatter pair that GUBER_FUSED=split selects.
//
// Replace the XLA programs of the reference's split arm
// (gubernator_tpu/core/engine.py:674-696 `_dispatch`, two dispatches a
// round, an A/B control beside the fused step):
//  * K14 `packed_compute_kernel`: gubernator_tpu/ops/bucket_kernel.py:1246
//    `_packed_compute_core` (jit `packed_compute` :1269), the update of
//    one packed round with no state write: the slot row, the lane values
//    (`SlotValues` :744) and the packed output.
//  * K15 `scatter_store_kernel`: :815 `_scatter_values` (jit
//    `scatter_store` :846, donated): encode the values
//    (`encode_slot_values` :781) and write them at the slots, dropping the
//    lanes outside [0, cap).
//  * K16 `collapsed_compute_kernel`: :1425 `collapsed_compute`
//    (`_collapsed_values` :1314), the collapsed hot-key closed form
//    without its scatter: segment slots, segment values, lane output.
// The plain PyTorch versions are gubernator_tpu_torch/ops/bucket_kernel.py
// `packed_compute_reference`, `scatter_store_reference` and
// `collapsed_compute_reference`; each pair is bit-equal.
//
// What passes between the halves.  The reference hands `SlotValues` (ten
// fields, an f64 among them) to the scatter, which encodes them.  Here the
// compute kernels encode (the same `encode_vals` as K1 and K3) and hand
// over the twelve state words, int32 [12, W]: the state the scatter leaves
// is the same, and no f64 buffer crosses.  The words of a lane whose slot
// lies outside [0, cap) are not written (the scatter drops that lane).
//
// Design.  The compute kernels are K1's and K3's own code with another
// store policy (csrc/lane_math.cuh `ToWords`): K14 runs
// `General::step` (csrc/general_lane.cuh), K1's lane, one thread a lane
// in blocks of 64, one plain launch a round reading its request straight
// from the pin (a round is one launch here, so K1's cross-round staging
// has nothing to overlap); K16 runs `collapsed::collapsed_tile`
// (csrc/collapsed_tile.cuh), K3's tile, with no clears (the engine runs a
// round's clears first, as the reference does), its publish buffer and
// tickets as K3's.  K15 is one thread a lane in blocks of 128: the
// lane's slot, then its 12 words, stored with K5's store loop
// (`lane::store`).  The slot rows K15 reads are the pins' own: row 1 of a
// packed round (a lane's slot) or of a collapsed pin (a segment's slot).
//
// Bounds (bytes).  K14 as K1 without the state write: per lane 60 B of pin
// and 20 B of pout, 48 B of words written, per in-range lane 48 B of
// state read.  K15: per lane 4 B of slot, per in-range lane 48 B of words
// read and 48 B of state written.  K16 as K3 without the state write: per
// lane 8 B of rows 17-18 and 20 B of pout, per in-range segment 64 B of
// pin, 48 B of state read and 48 B of words written.  All three are far
// under a launch's cost at the widths the engine uses.

#include <cstdint>
#include <cuda_runtime.h>

#include "collapsed_tile.cuh"
#include "general_lane.cuh"
#include "lane_math.cuh"

using namespace lane;

namespace {

constexpr int kComputeThreads = 64;  // K14: K1's block
constexpr int kScatterThreads = 128;  // K15: K5's block

__global__ void __launch_bounds__(kComputeThreads)
packed_compute_kernel(Cols st, long long cap, const int32_t* __restrict__ pin, int width,
                      int32_t* __restrict__ words, int32_t* __restrict__ pout) {
  const int lane = blockIdx.x * kComputeThreads + threadIdx.x;
  if (lane >= width) return;
  const size_t w = (size_t)width;
  const General::Header h = General::header(pin, 0);
  General::step(st, cap, h, pin + w + lane, width, lane, pout, w, ToWords{words, w});
}

__global__ void __launch_bounds__(kScatterThreads)
scatter_store_kernel(Cols st, long long cap, const int32_t* __restrict__ slot,
                     const int32_t* __restrict__ words, int width) {
  const int lane = blockIdx.x * kScatterThreads + threadIdx.x;
  if (lane >= width) return;
  const int32_t s = __ldg(slot + lane);
  if (s < 0 || (long long)s >= cap) return;
  int32_t v[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) v[c] = __ldg(words + (size_t)c * width + lane);
  store(st, s, v);
}

__global__ void __launch_bounds__(collapsed::kThreads)
collapsed_compute_kernel(Cols st, long long cap, const int32_t* __restrict__ pin, int width,
                         int64_t* pub, int64_t tiles_before, int32_t* __restrict__ words,
                         int32_t* __restrict__ pout) {
  collapsed::collapsed_tile(st, cap, pin, width, nullptr, 0, pub, tiles_before, pout,
                            ToWords{words, (size_t)width});
}

Cols make_cols(void* const* cols) {
  Cols c;
  for (int i = 0; i < kCols; ++i) c.p[i] = static_cast<int32_t*>(cols[i]);
  return c;
}

}  // namespace

// K14.  cols: 12 device pointers in BucketState field order (read only);
// pin int32 [16, width], one round (`now` in row 0 of lanes 0-1); words
// int32 [12, width]; pout int32 [5, width]; stream: a cudaStream_t.
// Returns 0 once the kernel is launched, else the cudaError.
extern "C" int guber_packed_compute(void* const* cols, long long cap, const void* pin,
                                    int width, void* words, void* pout, void* stream) {
  if (width < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = (width + kComputeThreads - 1) / kComputeThreads;
  packed_compute_kernel<<<grid, kComputeThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      make_cols(cols), cap, static_cast<const int32_t*>(pin), width,
      static_cast<int32_t*>(words), static_cast<int32_t*>(pout));
  return static_cast<int>(cudaGetLastError());
}

// K15.  slot int32 [width] (unique among the in-range lanes); words int32
// [12, width].
extern "C" int guber_scatter_store(void* const* cols, long long cap, const void* slot,
                                   const void* words, int width, void* stream) {
  if (width < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = (width + kScatterThreads - 1) / kScatterThreads;
  scatter_store_kernel<<<grid, kScatterThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      make_cols(cols), cap, static_cast<const int32_t*>(slot),
      static_cast<const int32_t*>(words), width);
  return static_cast<int>(cudaGetLastError());
}

// K16.  pin int32 [19, width] as K3 takes it; pub / pub_tiles /
// tiles_before as guber_collapsed_step's (csrc/collapsed_step.cu: the
// same publish buffer serves both on one stream); words int32 [12,
// width], written at the columns of the segments whose slot is in range;
// pout int32 [5, width].
extern "C" int guber_collapsed_compute(void* const* cols, long long cap, const void* pin,
                                       int width, void* pub, long long pub_tiles,
                                       long long tiles_before, void* words, void* pout,
                                       void* stream) {
  if (width < 1 || tiles_before < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = (width + collapsed::kThreads - 1) / collapsed::kThreads;
  if (grid > pub_tiles) return static_cast<int>(cudaErrorInvalidValue);
  collapsed_compute_kernel<<<grid, collapsed::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      make_cols(cols), cap, static_cast<const int32_t*>(pin), width,
      static_cast<int64_t*>(pub), static_cast<int64_t>(tiles_before),
      static_cast<int32_t*>(words), static_cast<int32_t*>(pout));
  return static_cast<int>(cudaGetLastError());
}

// Lanes per tile of guber_collapsed_compute, for sizing `pub`.
extern "C" int guber_collapsed_compute_threads() { return collapsed::kThreads; }
