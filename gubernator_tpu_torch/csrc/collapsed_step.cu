// K3: the collapsed hot-key step for Hopper (sm_90a), one plain launch
// per chunk of a hot-key batch, with no grid-wide barrier.
//
// Replaces the XLA program gubernator_tpu/ops/bucket_kernel.py:1417
// `_collapsed_step_core` (`_collapsed_values` :1314, then
// `_scatter_values` :815), with the chunk's eviction clears
// (`_clear_occupied_impl` :329; the reference engine runs them just
// before, core/engine.py:1359-1361).  The plain PyTorch version is
// gubernator_tpu_torch/ops/bucket_kernel.py `collapsed_step_reference`
// (after `clear_occupied_reference`); the two are bit-equal.
//
// Input.  pin int32 [19, W] as `pack_collapsed_host` lays it out: row 0
// `now`; rows 1-16 one segment per column (slot, m, algo, behavior, then
// hits, limit, duration, burst, greg_dur, greg_exp as hi/lo pairs);
// row 17 each request lane's segment, row 18 its position in the
// segment.  clear_slots int32 [n_clear] (any order).  Output pout int32
// [5, W], in request-lane order.  The kernel relies on the layout every
// producer gives (`ops/bucket_kernel.py check_collapsed` asserts it):
//  * row 17 never decreases along the lanes;
//  * segment s's lanes are contiguous, row 18 running 0 .. m_s - 1, and
//    row 2 holds m_s; segment slots (row 1) are unique and ascending;
//  * padding lanes come last and point at column W - 1 (m = 0, a slot
//    outside [0, cap)), at position 0.
//
// Bound.  8 B of header; per lane rows 17-18 read (8 B) and 5 pout words
// written (20 B); per in-range segment rows 1-16 read (64 B), 48 B of
// state read and 48 B written; 12 B per in-range clear: about 0.18 us
// for a zipf chunk of 8192 lanes.  What costs is latency: a lane's
// answer waits on its segment's chain of dependent loads (rows 17-18,
// the segment's column, its 12 state words) and the f64 update.
//
// Design.  Each block owns whole segments, so nothing crosses blocks:
//  * The owner of a segment is the thread whose lane has position 0.  It
//    gathers the slot's 12 words (through L2, `__ldcg`: this launch
//    writes them), runs the full update (csrc/lane_math.cuh, shared with
//    K1 and K4), applies the closed form for the m - 1 extras (token:
//    a2 = clip(R1 // h, 0, m - 1), the sticky OVER only at exactly 0;
//    leaky over the floor of the 32.32 remaining), stores the segment's
//    final words and writes the terms its lanes answer from to shared
//    memory, at its own index.  Each padding lane owns itself: m = 0,
//    slot out of range, no store -- the answer the reference's gather
//    gives it.  No padding column is visited.
//  * After one __syncthreads the block answers its own lanes whose owner
//    lane (lane - position) lies in the block.
//  * A hot key's segment runs past its block's end.  Its owner publishes
//    the segment's terms (8 words) to `pub`, under a stamp no earlier
//    launch used with that buffer (st.release), and each later block
//    whose first lanes belong to it waits for the stamp (ld.acquire) and
//    answers those lanes itself: a one-key chunk's 8192 lanes are
//    answered by all its blocks, one lane a thread.
//  * Waiting on another block is safe because a block waits only on a
//    tile that a running block holds.  A block does not take the lanes
//    of its blockIdx: its thread 0 takes a ticket from a counter in
//    `pub` (atomicAdd), and ticket k is lane tile k.  Tile k's holder
//    waits only on tiles below k, whose holders took their tickets
//    before it, so they are running and finish without waiting on a
//    later tile: no assumption on the order in which the hardware
//    dispatches blocks, or on how many are resident at once (other
//    streams may hold SMs).  The wait is bounded all the same: a pin that
//    breaks the layout (a block that starts inside a segment whose owner
//    publishes nothing) traps, so the launch fails loudly at the next
//    synchronisation instead of answering from an earlier launch's
//    terms.  A ticket outside [0, grid) (the wrapper's count of tiles
//    and the buffer's disagree) traps too.
//  * Clears without a grid barrier.  A clear must precede the gather of
//    the same slot.  A segment's slot is touched by its owner alone, so
//    the owner clears meta bit 0 in registers after its gather, and its
//    store writes the whole word.  Any other in-range slot is read by
//    nobody in the launch, so its clear may land at any time: its meta
//    word is read after the block's last barrier before the update and
//    written at the end.  Block b takes the clears in its slot range
//    [f(b·T), f((b+1)·T)), f(lane) = the lane's segment slot (+1 when
//    the lane is not its segment's first): each thread loads its first
//    eight entries of the clear list while the gathers are in flight,
//    and tells the two kinds apart by a binary search over the block's
//    lanes' segment slots (row 1 at row 17) in shared memory -- variant
//    (b), row 1, searched where it is on chip.  Any order of the clear
//    list is right; the engine sorts it, so that a block's entries sit
//    side by side and a warp's searches run together.  A launch with no
//    clears skips all of it.
//  * A plain <<<ceil(W / T), T>>> launch: no cooperative launch, no grid
//    barrier, no int64 scratch for every segment's terms.  T = 64
//    (kThreads; PERF.md, PR 4, has the measurement behind it).
//
// The kernel's body, one block's tile, is `collapsed_tile` in
// csrc/collapsed_tile.cuh, which K12 (csrc/sharded_step.cu) runs on each
// shard's chunk.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "collapsed_tile.cuh"
#include "lane_math.cuh"

using namespace lane;

namespace {

using namespace lane::collapsed;

__global__ void __launch_bounds__(kThreads)
collapsed_step_kernel(Cols st, long long cap, const int32_t* __restrict__ pin, int width,
                      const int32_t* __restrict__ clear_slots, int n_clear,
                      int64_t* pub, int64_t tiles_before, int32_t* __restrict__ pout) {
  collapsed_tile(st, cap, pin, width, clear_slots, n_clear, pub, tiles_before, pout);
}

}  // namespace

// cols: 12 device pointers in BucketState field order; pin int32
// [19, width]; clear_slots int32 [n_clear] (n_clear may be 0); pub int64
// [1 + pub_tiles, 16], zeroed when made and then used only by this entry
// point on one stream: row 0 word 0 counts the tiles launched with it,
// row 1 + k holds what tile k publishes; tiles_before: the tiles of the
// launches made with `pub` so far, sum of ceil(width / 64); pout int32
// [5, width]; stream: a cudaStream_t.  The launch is ceil(width / 64)
// tiles (guber_collapsed_threads() lanes each).
// Returns 0 once the kernel is launched, else the cudaError (a refused
// launch is not retried in another form).
extern "C" int guber_collapsed_step(void* const* cols, long long cap, const void* pin,
                                    int width, const void* clear_slots, int n_clear,
                                    void* pub, long long pub_tiles, long long tiles_before,
                                    void* pout, void* stream) {
  if (width < 1 || n_clear < 0 || tiles_before < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = (width + kThreads - 1) / kThreads;
  if (grid > pub_tiles) return static_cast<int>(cudaErrorInvalidValue);
  Cols c;
  for (int i = 0; i < kCols; ++i) c.p[i] = static_cast<int32_t*>(cols[i]);
  collapsed_step_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      c, cap, static_cast<const int32_t*>(pin), width, static_cast<const int32_t*>(clear_slots),
      n_clear, static_cast<int64_t*>(pub), static_cast<int64_t>(tiles_before),
      static_cast<int32_t*>(pout));
  return static_cast<int>(cudaGetLastError());
}

// Lanes per tile of guber_collapsed_step (T), for sizing `pub`.
extern "C" int guber_collapsed_threads() { return kThreads; }
