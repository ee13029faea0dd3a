// K17: the dataclass decision step for Hopper (sm_90a), one launch a
// call.
//
// Replaces gubernator_tpu/ops/bucket_kernel.py:356 `_apply_batch_impl`
// (jit `apply_batch` :848, the state donated), the step that
// `gubernator_tpu/ops/__init__.py` exports: clear meta bit 0 at the
// in-range `clear_slots` (`_clear_occupied_impl` :329), then per lane
// gather the slot's 12 words (zero outside [0, cap)), update the bucket
// (`update_lanes` :514), encode and store the new words where the slot
// is in range (`_apply_core` :420), and answer (status, limit, remaining,
// reset_time) at the lane's own index.  The plain PyTorch version is
// gubernator_tpu_torch/ops/bucket_kernel.py `apply_batch_reference`; the
// two are bit-equal.
//
// The contract (the reference's `BatchInput` docstring, :101-104): the
// in-range slots of a batch are unique; padding lanes hold out-of-range
// slots (capacity + lane).  Under it no lane reads or writes another
// lane's slot, so a lane's update does not depend on the order of the
// lanes.
//
// No sort, on purpose.  The reference co-sorts the batch by slot before
// its gather and sorts the answers back by lane after its scatter (:377,
// :406) only because a TPU gather or scatter is serial unless its indices
// are declared sorted and unique (its comment at :367-375).  A Hopper
// thread gathers and stores its own lane's slot at no such cost, so each
// lane reads its own fields, runs K1's lane (csrc/general_lane.cuh
// `General::update`, input policy `FromBatch`, store policy `ToState`),
// and writes its four answers at its own index: what the reference has
// after its second sort.
//
// Design.  What must hold: every clear lands before any lane gathers (a
// slot cleared in a batch is often one a lane of the same batch reads).
// One cooperative launch (csrc/coop_launch.cuh, as K1's): a grid of
// min(ceil(max(B, C) / 64), co-resident blocks) blocks of 64 threads
// grid-strides over the clears, `grid.sync()` (only when there are
// clears: the count is known to every block), then grid-strides over the
// lanes, so any B and C are taken in one launch.  Blocks of 64, as K1's,
// so a batch of 1000 spreads over 16 SMs.  The gathers go through L2
// (`__ldcg`, lane_math.cuh `gather`), so a meta word another SM cleared
// is never read from a stale L1 line.  `BatchOutput.limit` echoes the
// request's limit.
//
// Bound (bytes).  Per lane 60 B of request fields (slot, algo, behavior
// int32; six int64), 28 B of answers (status int32, three int64), and per
// in-range lane 48 B of state read and 48 B written; per in-range clear
// 12 B (slot, meta read, meta written).  A batch of 1024 in-range lanes
// is ~188 KB, ~0.056 us at 3.35 TB/s: far under a launch's cost, as for
// K1.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include "coop_launch.cuh"
#include "general_lane.cuh"
#include "lane_math.cuh"

namespace cg = cooperative_groups;
using namespace lane;

namespace {

constexpr int kThreads = 64;

// The answer columns (the reference's `BatchOutput`, :121), [B] each.
struct BatchAnswers {
  int32_t* status;
  int64_t* limit;
  int64_t* remaining;
  int64_t* reset_time;
};

__global__ void __launch_bounds__(kThreads)
apply_batch_kernel(Cols st, long long cap, BatchCols in, int width,
                   const int32_t* __restrict__ clear_slots, int n_clear, long long now,
                   BatchAnswers out) {
  cg::grid_group grid = cg::this_grid();
  const int first = (int)blockIdx.x * kThreads + (int)threadIdx.x;
  const int stride = (int)gridDim.x * kThreads;
  if (n_clear > 0) {  // uniform across the grid
    for (int i = first; i < n_clear; i += stride) {
      const int32_t s = __ldg(clear_slots + i);
      if (s >= 0 && (long long)s < cap) st.p[kMeta][s] = __ldcg(st.p[kMeta] + s) & ~1;
    }
    grid.sync();  // every clear before any gather
  }
  for (int lane = first; lane < width; lane += stride) {
    const Resp r = General::update(st, cap, (int64_t)now, FromBatch{in, lane}, lane, ToState{});
    out.status[lane] = r.status;
    out.limit[lane] = __ldg(in.limit + lane);
    out.remaining[lane] = r.rem;
    out.reset_time[lane] = r.reset;
  }
}

coop::ResidentCache resident;

}  // namespace

// cols: 12 device pointers in BucketState field order; in_cols: 9 device
// pointers in BatchInput field order (slot, algo, behavior int32 [width];
// hits, limit, duration, burst, greg_duration, greg_expire int64
// [width]); clear_slots int32 [n_clear] (may be null when n_clear is 0);
// out_cols: 4 device pointers (status int32, limit, remaining,
// reset_time int64, [width] each); stream: a cudaStream_t.  Returns 0
// once the kernel is launched, else the cudaError (a refused launch is not
// retried in another form).
extern "C" int guber_apply_batch(void* const* cols, long long cap, void* const* in_cols,
                                 int width, const void* clear_slots, int n_clear,
                                 long long now, void* const* out_cols, void* stream) {
  if (width < 0 || n_clear < 0 || (width == 0 && n_clear == 0))
    return static_cast<int>(cudaErrorInvalidValue);
  Cols c;
  for (int i = 0; i < kCols; ++i) c.p[i] = static_cast<int32_t*>(cols[i]);
  BatchCols in{static_cast<const int32_t*>(in_cols[0]), static_cast<const int32_t*>(in_cols[1]),
               static_cast<const int32_t*>(in_cols[2]), static_cast<const int64_t*>(in_cols[3]),
               static_cast<const int64_t*>(in_cols[4]), static_cast<const int64_t*>(in_cols[5]),
               static_cast<const int64_t*>(in_cols[6]), static_cast<const int64_t*>(in_cols[7]),
               static_cast<const int64_t*>(in_cols[8])};
  BatchAnswers out{static_cast<int32_t*>(out_cols[0]), static_cast<int64_t*>(out_cols[1]),
                   static_cast<int64_t*>(out_cols[2]), static_cast<int64_t*>(out_cols[3])};
  const int32_t* clears = static_cast<const int32_t*>(clear_slots);
  void* args[] = {&c, &cap, &in, &width, &clears, &n_clear, &now, &out};
  const int lanes = width > n_clear ? width : n_clear;
  return coop::launch(apply_batch_kernel, kThreads, resident, lanes, args, stream);
}
