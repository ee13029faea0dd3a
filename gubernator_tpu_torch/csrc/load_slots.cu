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
// 48 B of state; a padding lane reads its 4 B slot: 0.152 us for a
// 4096-record restore at 3.35 TB/s.  Counted in the 32-byte sectors that
// the memory really moves (the record's rows, and one sector for each
// scattered 4-byte store: 49,152 of them at 4096 random slots) it is
// 0.562 us.  Either way a launch costs more (an empty kernel takes 1.69
// us on an H100 80GB HBM3 at 700 W) at every width the engine uses: one
// launch per restoring round, at most 4096 lanes a launch when loading.
//
// The design: one thread per lane in blocks of 128, every load of a lane
// issued at once (the kernel also reads the 72 B of a padding lane's other
// words, not in the bound, so the range check waits on the slot word
// only); the 12 stores go column by column.  What the time above the
// launch floor is made of (CUDA events, the same card): at cap 10^8 a
// 4096-record restore takes 6.0 us, 4.3 above the floor; 4096 contiguous
// slots take 2.33 (the lanes' own loads and stores), 4096 random slots at
// cap 2^20 4.71 (the scatter of the stores over the state); the last 1.3
// come with the footprint at 10^8, where 4096 random slots touch about
// 2,300 distinct 2-MiB pages of the 12 columns of 400 MB: address
// translation, the likely cost (not measured apart), which no block shape
// tried changed.
// Tried and not kept (it lost, by 0.01-0.04 us, where the translation or
// the launch bound it): one warp a block, 128 blocks for 4096 lanes (2.70
// against 3.76 us at 1024 random slots, 4.34 against 4.71 at 4096 at
// 2^20); the record tile staged into shared memory by Hopper's bulk
// asynchronous copy (slower at every size); one block a column.
// scripts/torch_k5_spread.py builds them and times them beside K5.

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
