// K5: the restore step for Hopper (sm_90a).
//
// Replaces gubernator_tpu/ops/bucket_kernel.py:1526 `_load_slots_impl`
// (the XLA program behind `load_slots`, :1575): hydrate persisted bucket
// values (a Store's read-through items, a Loader's snapshot) into their
// slots.  The plain PyTorch version is
// gubernator_tpu_torch/ops/bucket_kernel.py `load_slots_reference`.
//
// Input: the record as one int32 buffer [19, n] (layout in
// ops/bucket_kernel.py, `RESTORE_FIELDS`): row 0 the slot, sorted and
// unique, padding lanes at cap + lane; the int64 fields as (hi, lo) rows.
// One thread per lane: read the lane's 19 words, compute the slot's 12
// state words, store them.  Unique slots mean no two lanes write one
// slot, so the lanes need no ordering; lanes outside [0, cap) are dropped.
//
// The words, as the reference computes them: t0, expire_at, invalid_at
// and duration clamp to [0, 2^43) (`lane::clamp_ts`) and fold their hi
// words into meta / hi2; a nonzero algo is leaky; the occupied bit is
// set; the leaky remaining is the record's 32.32 words verbatim, the
// token remaining, limit and burst their int64 words.  `lane::encode_vals`
// does not serve here (it stores invalid_at as 0 and re-quantizes the
// leaky remaining from a double), so the words are built below from the
// shared helpers.
//
// Bound: bytes.  An in-range lane reads its 76 B of record and writes
// 48 B of state; a padding lane reads its 4 B slot.  The kernel reads all
// 19 words of a padding lane too (72 B the bound does not count), so that
// every load of a lane issues at once.  A 4096-lane restore moves about
// 0.5 MB, so the launch latency is the cost at every width the engine uses
// (one launch per restoring round, at most 4096 lanes a launch when
// loading).

#include <cstdint>
#include <cuda_runtime.h>

#include "lane_math.cuh"

namespace {

using namespace lane;

constexpr int kThreads = 128;
constexpr int kRows = 19;  // RESTORE_ROWS

// Rows of the record (ops/bucket_kernel.py R_*).
enum RecRow {
  kSlot = 0, kAlgo = 1, kStatus = 2, kLimit = 3, kRem = 5, kRemfHi = 7, kRemfLo = 8,
  kDur = 9, kT0 = 11, kExp = 13, kBurst = 15, kInv = 17
};

__global__ void __launch_bounds__(kThreads)
load_slots_kernel(Cols st, long long cap, const int32_t* __restrict__ rec, int n) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  // All 19 words at once (coalesced across the warp), so that one memory
  // latency covers the lane; the range check waits on the slot word only.
  int32_t q[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) q[r] = __ldg(rec + (size_t)r * n + i);
  const int32_t slot = q[kSlot];
  if (slot < 0 || (long long)slot >= cap) return;
  auto row = [&](int r) { return q[r]; };
  auto wide = [&](int r) { return combine(q[r], q[r + 1]); };

  const int32_t algo = row(kAlgo) != 0 ? 1 : 0;
  const int64_t t0c = clamp_ts(wide(kT0));
  const int64_t expc = clamp_ts(wide(kExp));
  const int64_t durc = clamp_ts(wide(kDur));
  const int64_t invc = clamp_ts(wide(kInv));
  int32_t w[kCols];
  w[kMeta] = 1 | (algo << 1) | ((row(kStatus) & 3) << 2) | (hi_word(t0c) << 4) |
             (hi_word(invc) << 15);
  w[kHi2] = hi_word(expc) | (hi_word(durc) << 11);
  w[kT0Lo] = lo_word(t0c);
  w[kExpireLo] = lo_word(expc);
  w[kInvalidLo] = lo_word(invc);
  w[kDurationLo] = lo_word(durc);
  w[kLimitHi] = row(kLimit);
  w[kLimitLo] = row(kLimit + 1);
  w[kRemHi] = algo ? row(kRemfHi) : row(kRem);
  w[kRemLo] = algo ? row(kRemfLo) : row(kRem + 1);
  w[kBurstHi] = row(kBurst);
  w[kBurstLo] = row(kBurst + 1);
  store(st, slot, w);
}

}  // namespace

// cols: the 12 state columns (int32 [cap] each, BucketState order); rec:
// int32 [19, n] on the device, n >= 1; stream: a cudaStream_t.  Returns
// cudaGetLastError() after the launch.
extern "C" int guber_load_slots(void* const* cols, long long cap, const void* rec, int n,
                                void* stream) {
  Cols st;
  for (int c = 0; c < kCols; ++c) st.p[c] = static_cast<int32_t*>(cols[c]);
  const int blocks = (n + kThreads - 1) / kThreads;
  load_slots_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      st, cap, static_cast<const int32_t*>(rec), n);
  return static_cast<int>(cudaGetLastError());
}
