// K1 and K4: the fused bucket decision step for Hopper (sm_90a), all of a
// launch's rounds in one launch, in two formats: K1 the general one (a
// lane carries its request), K4 the uniform narrow one (a round's lanes
// share one config from its header).
//
// Replaces gubernator_tpu/ops/pallas_step.py:67 `_fused_kernel` (the
// Pallas kernel, reached through `pallas_fused_step` :158), whose XLA
// twin is gubernator_tpu/ops/bucket_kernel.py:1044 `_fused_step_core`,
// together with its multi-round form `_multi_fused_core` (:1071) and the
// engine's per-round eviction clear `_clear_occupied_impl` (:329; the
// reference engine runs it just before the round, core/engine.py:1185).
// Per round r: clear meta bit 0 at round r's in-range clear slots; then
// per lane, gather the slot's 12 state words (zero when the slot is
// outside [0, cap)), run the token / leaky update (`update_lanes` :514),
// encode the new words (`encode_slot_values` :781), store them in place
// where the slot is in range, and emit the lane's 5 pout words.  The
// plain PyTorch version is gubernator_tpu_torch/ops/bucket_kernel.py
// `multi_fused_step_reference`; the two are bit-equal.
//
// K4 replaces the uniform format's `_uniform_step_core` (:1161) and
// `_multi_uniform_core` (:1198): the same update with the header's config
// broadcast to every lane, and the narrow 2-row output.  Its plain
// version is `multi_uniform_step_reference`.  The two formats share the
// lane math (csrc/lane_math.cuh, with K3) and the format structs (the
// general one, `General`, in csrc/general_lane.cuh, whose header K11
// reads too; `Uniform`
// below);
// each has a round loop of its own: K1 `rounds_kernel` (a cooperative
// grid with a grid barrier between rounds), K4 `slot_range_kernel` (a
// plain launch, no grid barrier).
//
// Input.  pin int32 [16, L] (K1) or [2, L] (K4) holds the R rounds one
// after another along the lanes; round r owns lanes [round_off[r],
// round_off[r+1]), sorted by slot, each slot at most once; row 0 of a
// round's first lanes is its header (K1: `now`; K4: `now` and the
// config), so the rounds of several batches can share a launch.  Clears
// come in CSR form: round r's are clear_slots[clear_off[r] ..
// clear_off[r+1]).
//
// K1's design.  What costs at serving widths is the fixed cost of a
// launch and of the host round trip around it, paid once per round when
// each round was its own launch; the bytes are ~0.05 us of a 1000-lane
// round.  So:
//  * One launch per batch.  A persistent cooperative grid
//    (cudaLaunchCooperativeKernel), sized min(ceil(widest round / T),
//    co-resident blocks), runs every round in order; its blocks
//    grid-stride over each round's lanes.  grid.sync() orders round r's
//    stores before round r+1's gathers (a slot may recur in every round),
//    and a round's clears before its gathers; clear_off is known to every
//    block, so the extra barrier of a round with clears is uniform.
//  * Small blocks (T = 64 threads), so a 1000-lane round spreads over 16
//    SMs, not 8.  T = 32 and 128 were measured too: 64 was fastest on
//    the engine's typical batch of several rounds.
//  * The next round's request words are on chip before the barrier
//    ends.  While a block computes one chunk of lanes, each thread copies
//    its lane of the next chunk (the block's next lanes, usually in the
//    next round) -- the 15 request rows, slot first -- into a
//    double-buffered shared-memory tile with `cp.async` (4 B a thread a
//    row: a warp moves one aligned 128 B line a row, since rounds are
//    padded to 32 lanes).  Each thread reads only its own column of the
//    tile, so the copy needs a per-thread `cp.async.wait_group` and no
//    block barrier.  After grid.sync() the lane's slot is in shared
//    memory and its 12 state gathers issue at once.
//  * State gathers go through L2 only (`__ldcg`): words written by other
//    SMs in an earlier round are never read from a stale L1 line.
//
// K4's design: fixed slot ranges, so that rounds need no grid barrier.
//  * Block b owns the slots [split_b, split_{b+1}), split_b the slot of
//    lane b·S of the launch's widest round, S = T / 2 (the first range
//    open below, the last open above): every access to a slot in the
//    launch, in any round, is made by one block, so __syncthreads orders
//    the rounds and a round's clears before its gathers.  A plain launch
//    of ceil(widest / S) blocks (no co-residency cap, no cooperative
//    launch).  A block has twice the threads of its share of the widest
//    round, so another round whose slots fall unevenly (a block's share
//    of a random round is S ± sqrt(S)) still takes one pass, not two.
//  * A round, per block: the round's clears that fall in the block's
//    range (each thread loads its entries together, then their meta
//    words together), __syncthreads, its lanes of the round.  In the
//    widest round -- the only round of a single batch, which is the whole
//    pin -- those are lanes [b·S, (b+1)·S); in another round the block
//    finds them by two lower bounds of its splits over the round's sorted
//    slot row, all rounds' searches at the start: each warp runs up to
//    eight at once, every step probing 32 evenly spaced lanes of each
//    range (an 8192-lane round: three steps of loads).
//  * The next round's first slot and header load before the barrier that
//    ends a round; at R = 1 nothing waits on the offsets.  No `cp.async`
//    staging: nothing would overlap it.

// Bound.  Per lane the step must move 60 B of pin (rows 1-15) and 20 B of
// pout, and per in-range lane 48 B of state read and 48 B written; plus
// the 8 B `now` header per round and 12 B per in-range clear (slot, meta
// read, meta written).  A 1000-lane round is about 176 KB, ~53 ns at
// 3.35 TB/s.  K4 moves 4 B of pin and 8 B of pout per lane, 40 B of
// header per round, and the same state words.
// The random 4 B state accesses touch a 32 B sector per column (768 B a
// lane of real traffic); what a round costs is the lane's dependent
// chain (slot, 12 gathers, the f64 update) and, in K1, a grid barrier.

#include <cooperative_groups.h>
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "coop_launch.cuh"
#include "general_lane.cuh"
#include "lane_math.cuh"

namespace cg = cooperative_groups;
using namespace lane;

namespace {

constexpr int kThreads = 64;  // threads per block (T)

__device__ __forceinline__ void cp_async4(int32_t* smem, const int32_t* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most one of this thread's copy groups is still in flight.
__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The uniform narrow format (K4): pin int32 [2, L], row 1 the slot; the
// round header in row 0 of the round's first ten lanes holds `now` and
// the config every lane of the round shares, [now_hi, now_lo, algo,
// behavior, hits_hi, hits_lo, limit, duration_lo, burst, duration_hi];
// pout int32 [2, L]: (status << 31) | (remaining & 0x7FFFFFFF), and
// reset_time - now, each cut to its low 32 bits.
struct Uniform {
  static constexpr int kReqRows = 1;  // pin row 1: the slot
  struct Header {
    int64_t now;
    Req q;
  };
  static __device__ __forceinline__ Header header(const int32_t* __restrict__ pin, int lo) {
    const int32_t* hd = pin + lo;
    Header h;
    h.now = combine(__ldg(hd), __ldg(hd + 1));
    h.q = Req{__ldg(hd + 2), __ldg(hd + 3), combine(__ldg(hd + 4), __ldg(hd + 5)),
              (int64_t)__ldg(hd + 6), combine(__ldg(hd + 9), __ldg(hd + 7)),
              (int64_t)__ldg(hd + 8), 0, 0};
    return h;
  }
  static __device__ __forceinline__ void step(const Cols& st, long long cap, const Header& h,
                                              const int32_t* req, int stride, int lane,
                                              int32_t* __restrict__ pout, size_t w) {
    (void)stride;
    const int32_t slot = req[0];
    const bool valid = slot >= 0 && (long long)slot < cap;
    int32_t g[kCols];
    gather(st, slot, valid, g);
    Vals v;
    Resp out;
    int64_t lk_rate_i;
    update_lane(g, valid, h.q, h.now, v, out, lk_rate_i);
    if (valid) {
      int32_t words[kCols];
      encode_vals(v, words);
      store(st, slot, words);
    }
    const uint64_t packed = ((uint64_t)(int64_t)out.status << 31) |
                            ((uint64_t)out.rem & 0x7FFFFFFFull);
    pout[lane] = lo_word((int64_t)packed);
    pout[w + lane] = lo_word(sub64(out.reset, h.now));
  }
};

// The lanes [lo, hi) of round r that one block handles in one pass.
struct Chunk {
  int r, lo, hi;
};

// K1's round loop: every round of the launch in order, each after its
// clears, with a grid barrier between rounds; format F says how a lane's
// request is read and its answer written.
template <class F>
__global__ void __launch_bounds__(kThreads)
rounds_kernel(Cols st, long long cap, const int32_t* __restrict__ pin, int width,
              const int32_t* __restrict__ round_off, int n_rounds,
              const int32_t* __restrict__ clear_off, const int32_t* __restrict__ clear_slots,
              int n_clear, int32_t* __restrict__ pout) {
  constexpr int T = kThreads;
  constexpr int kRows = F::kReqRows;
  __shared__ int32_t tile[2][kRows][T];
  cg::grid_group grid = cg::this_grid();
  const size_t w = (size_t)width;
  const int tid = threadIdx.x;
  const int stride = (int)gridDim.x * T;
  // Offsets are clamped, so a malformed call cannot reach past pin/pout.
  auto roff = [&](int r) {
    const int v = __ldg(round_off + r);
    return v < 0 ? 0 : (v > width ? width : v);
  };
  auto coff = [&](int r) {
    const int v = __ldg(clear_off + r);
    return v < 0 ? 0 : (v > n_clear ? n_clear : v);
  };
  // This block's first chunk in round r or later ({n_rounds, ...}: none).
  auto first_from = [&](int r) -> Chunk {
    for (; r < n_rounds; ++r) {
      const int lo = roff(r) + (int)blockIdx.x * T;
      const int hi = roff(r + 1);
      if (lo < hi) return {r, lo, hi};
    }
    return {n_rounds, 0, 0};
  };
  auto next_of = [&](const Chunk& c) -> Chunk {
    return c.lo + stride < c.hi ? Chunk{c.r, c.lo + stride, c.hi} : first_from(c.r + 1);
  };
  // Copy this thread's lane of chunk c (the request rows) into tile[buf].
  auto prefetch = [&](const Chunk& c, int buf) {
    const int lane = c.lo + tid;
    if (c.r < n_rounds && lane < c.hi) {
#pragma unroll
      for (int k = 0; k < kRows; ++k)
        cp_async4(&tile[buf][k][tid], pin + (size_t)(k + 1) * w + lane);
    }
    cp_async_commit();
  };

  // The first offsets load ahead of the copies; each later round's clear
  // bound loads before the barrier it follows.
  int c_lo = coff(0), c_hi = coff(1);
  Chunk cur = first_from(0);
  prefetch(cur, 0);
  int buf = 0;
  for (int r = 0; r < n_rounds; ++r) {
    if (c_hi > c_lo) {  // uniform across the grid
      for (int i = c_lo + (int)blockIdx.x * T + tid; i < c_hi; i += stride) {
        const int32_t s = __ldg(clear_slots + i);
        if (s >= 0 && (long long)s < cap) st.p[kMeta][s] = __ldcg(st.p[kMeta] + s) & ~1;
      }
      grid.sync();
    }
    if (cur.r == r) {  // this block has lanes in round r: read its header
      const typename F::Header hdr = F::header(pin, roff(r));
      while (cur.r == r) {
        const Chunk nxt = next_of(cur);
        prefetch(nxt, buf ^ 1);
        cp_async_wait_prior();  // this thread's copy of `cur` has landed
        const int lane = cur.lo + tid;
        if (lane < cur.hi) F::step(st, cap, hdr, &tile[buf][0][tid], T, lane, pout, w);
        cur = nxt;
        buf ^= 1;
      }
    }
    if (r + 1 < n_rounds) {
      c_lo = c_hi;
      c_hi = coff(r + 2);
      grid.sync();
    }
  }
  cp_async_wait_all();
}

template <class F>
int launch_rounds(void* const* cols, long long cap, const void* pin, int width,
                  const void* round_off, int n_rounds, const void* clear_off,
                  const void* clear_slots, int n_clear, void* pout, int widest, void* stream) {
  static coop::ResidentCache resident;  // one per format
  if (width < 1 || n_rounds < 1) return static_cast<int>(cudaErrorInvalidValue);
  Cols c;
  for (int i = 0; i < kCols; ++i) c.p[i] = static_cast<int32_t*>(cols[i]);
  void* args[] = {&c, &cap, &pin, &width, &round_off, &n_rounds,
                  &clear_off, &clear_slots, &n_clear, &pout};
  return coop::launch(rounds_kernel<F>, kThreads, resident, widest, args, stream);
}

// K4's threads per block (T; PERF.md, PR 4, has the measurement behind
// it).
constexpr int kRangeThreads = 64;
// Searches a warp of K4's prologue runs at once.
constexpr int kProbes = 8;
// Clear entries a thread of K4 loads at once.
constexpr int kClearBatch = 4;

// K4's round loop: block b owns the slot range [split_b, split_{b+1})
// in every round (see the note at the top); T threads a block, S = T / 2
// lanes of the widest round a block, so that a block takes up to twice
// its share of another round's lanes in one pass.  Format F reads a
// lane's request from its slot alone.
template <class F>
__global__ void __launch_bounds__(kRangeThreads)
slot_range_kernel(Cols st, long long cap, const int32_t* __restrict__ pin, int width,
                  const int32_t* __restrict__ round_off, int n_rounds,
                  const int32_t* __restrict__ clear_off, const int32_t* __restrict__ clear_slots,
                  int n_clear, int32_t* __restrict__ pout) {
  static_assert(F::kReqRows == 1, "the slot-range loop reads a lane's slot row alone");
  constexpr int T = kRangeThreads;
  constexpr int S = T / 2;
  constexpr int kWarps = T / 32;
  extern __shared__ int32_t lane_lo[];  // R > 1: [2R], this block's lanes of round r are
  int32_t* lane_hi = lane_lo + n_rounds;  // [lane_lo[r], lane_hi[r])
  const size_t w = (size_t)width;
  const int tid = threadIdx.x, warp = tid >> 5, ln = tid & 31;
  const int b = (int)blockIdx.x;
  const bool first_blk = b == 0, last_blk = b == (int)gridDim.x - 1;
  const int32_t* slots = pin + w;  // row 1
  // Offsets are clamped, so a malformed call cannot reach past pin/pout.
  auto roff = [&](int r) {
    const int v = __ldg(round_off + r);
    return v < 0 ? 0 : (v > width ? width : v);
  };
  auto coff = [&](int r) {
    const int v = __ldg(clear_off + r);
    return v < 0 ? 0 : (v > n_clear ? n_clear : v);
  };

  // The widest round (the first, on a tie), found by every warp alike; at
  // R = 1 the whole pin (the layout's round_off is [0, W]), so nothing
  // waits on the offsets.
  int wr = 0, w0 = 0, ww = width;
  if (n_rounds > 1) {
    ww = -1;
    for (int r = ln; r < n_rounds; r += 32) {
      const int x = roff(r + 1) - roff(r);
      if (x > ww) {
        ww = x;
        wr = r;
      }
    }
    for (int d = 16; d > 0; d >>= 1) {
      const int ow = __shfl_xor_sync(0xffffffffu, ww, d);
      const int orr = __shfl_xor_sync(0xffffffffu, wr, d);
      if (ow > ww || (ow == ww && orr < wr)) {
        ww = ow;
        wr = orr;
      }
    }
    w0 = roff(wr);
  }
  // The block's slot range, from the widest round's lanes b·S and (b+1)·S.
  auto split = [&](int k) { return k >= ww ? INT64_MAX : (int64_t)__ldg(slots + w0 + k); };
  const int64_t s_lo = first_blk ? INT64_MIN : split(b * S);
  const int64_t s_hi = last_blk ? INT64_MAX : split((b + 1) * S);
  auto own_range = [&](int r, int& lo, int& hi) {
    if (r == wr) {  // the widest round: lanes b·S .. (b+1)·S, no search
      lo = w0 + (b * S < ww ? b * S : ww);
      hi = w0 + (last_blk || (b + 1) * S > ww ? ww : (b + 1) * S);
    } else {
      lo = lane_lo[r];
      hi = lane_hi[r];
    }
  };

  if (n_rounds > 1) {
    // Search j (of 2R) finds round j/2's lane_lo (j even: the first lane
    // with slot >= s_lo) or lane_hi (j odd: >= s_hi).
    for (int j0 = warp; j0 < 2 * n_rounds; j0 += kWarps * kProbes) {
      int lo[kProbes], hi[kProbes];
      int64_t key[kProbes];
#pragma unroll
      for (int k = 0; k < kProbes; ++k) {
        const int j = j0 + k * kWarps;
        lo[k] = hi[k] = 0;
        key[k] = 0;
        if (j < 2 * n_rounds && (j >> 1) != wr) {
          const int r = j >> 1, up = j & 1;
          const int a = roff(r), e = roff(r + 1) > a ? roff(r + 1) : a;
          if (up ? last_blk : first_blk) {
            lo[k] = hi[k] = up ? e : a;
          } else {
            lo[k] = a;
            hi[k] = e;
            key[k] = up ? s_hi : s_lo;
          }
        }
      }
      for (;;) {  // the answer of search k lies in [lo[k], hi[k]]
        bool open = false;
        int step[kProbes];
        bool below[kProbes];
#pragma unroll
        for (int k = 0; k < kProbes; ++k) {
          const int len = hi[k] - lo[k];
          step[k] = (len + 31) >> 5;
          const int idx = lo[k] + ln * step[k];
          below[k] = len > 0 && idx < hi[k] && (int64_t)__ldg(slots + idx) < key[k];
          open |= len > 0;
        }
        if (!open) break;  // uniform across the warp
#pragma unroll
        for (int k = 0; k < kProbes; ++k) {
          const int cnt = __popc(__ballot_sync(0xffffffffu, below[k]));
          const int len = hi[k] - lo[k];
          if (len > 0) {
            const int probes = (len + step[k] - 1) / step[k];
            const int nlo = cnt > 0 ? lo[k] + (cnt - 1) * step[k] + 1 : lo[k];
            if (cnt < probes) hi[k] = lo[k] + cnt * step[k];
            lo[k] = nlo;
          }
        }
      }
      if (ln == 0) {
#pragma unroll
        for (int k = 0; k < kProbes; ++k) {
          const int j = j0 + k * kWarps;
          if (j < 2 * n_rounds && (j >> 1) != wr) (j & 1 ? lane_hi : lane_lo)[j >> 1] = lo[k];
        }
      }
    }
    __syncthreads();
  }

  // A round's first clear entries, first slot and header load before the
  // barrier that ends the round before it; its gathers and meta reads wait.
  int64_t c_next[kClearBatch];
  auto load_clears = [&](int r, int64_t (&c)[kClearBatch]) {
    const int c_lo = coff(r), c_hi = coff(r + 1);
#pragma unroll
    for (int k = 0; k < kClearBatch; ++k) {
      const int i = c_lo + tid + k * T;
      c[k] = i < c_hi ? __ldg(clear_slots + i) : -1;
    }
  };
  // Clear the meta bit at this block's entries of `c` (loaded together).
  auto clear_batch = [&](int64_t (&c)[kClearBatch]) {
    int32_t old[kClearBatch];
#pragma unroll
    for (int k = 0; k < kClearBatch; ++k) {
      if (c[k] >= s_lo && c[k] < s_hi && c[k] >= 0 && c[k] < cap) {
        old[k] = __ldcg(st.p[kMeta] + c[k]);
      } else {
        c[k] = -1;
      }
    }
#pragma unroll
    for (int k = 0; k < kClearBatch; ++k)
      if (c[k] >= 0) st.p[kMeta][c[k]] = old[k] & ~1;
  };
  int lo, hi;
  own_range(0, lo, hi);
  int32_t slot_next = lo + tid < hi ? __ldg(slots + lo + tid) : 0;
  typename F::Header hdr{};
  if (lo < hi) hdr = F::header(pin, roff(0));
  load_clears(0, c_next);
  for (int r = 0; r < n_rounds; ++r) {
    const int c_lo = coff(r), c_hi = coff(r + 1);
    if (c_hi > c_lo) {  // uniform across the block: the round's clears in this range
      clear_batch(c_next);
      for (int i0 = c_lo + tid + kClearBatch * T; i0 < c_hi; i0 += kClearBatch * T) {
        int64_t c[kClearBatch];
#pragma unroll
        for (int k = 0; k < kClearBatch; ++k) {
          const int i = i0 + k * T;
          c[k] = i < c_hi ? __ldg(clear_slots + i) : -1;
        }
        clear_batch(c);
      }
      __syncthreads();
    }
    int32_t slot = slot_next;
    for (int lane = lo + tid; lane < hi; lane += T) {
      if (lane != lo + tid) slot = __ldg(slots + lane);
      F::step(st, cap, hdr, &slot, 0, lane, pout, w);
    }
    if (r + 1 < n_rounds) {
      own_range(r + 1, lo, hi);
      slot_next = lo + tid < hi ? __ldg(slots + lo + tid) : 0;
      if (lo < hi) hdr = F::header(pin, roff(r + 1));
      load_clears(r + 1, c_next);
      __syncthreads();  // round r's stores before round r+1's clears and gathers
    }
  }
}

}  // namespace

// cols: 12 device pointers in BucketState field order; pin int32
// [16, width] (K1) or [2, width] (K4); round_off / clear_off int32
// [n_rounds + 1]; clear_slots int32 [n_clear]; pout int32 [5, width] (K1)
// or [2, width] (K4); widest: the widest round's lanes; stream: a
// cudaStream_t.  Returns 0 once the kernel is launched, else the
// cudaError (a refused launch is not retried in another form).
// K1's grid is min(ceil(widest / 64), co-resident blocks), at least 1,
// launched cooperatively.
extern "C" int guber_multi_fused_step(void* const* cols, long long cap, const void* pin,
                                      int width, const void* round_off, int n_rounds,
                                      const void* clear_off, const void* clear_slots,
                                      int n_clear, void* pout, int widest, void* stream) {
  return launch_rounds<General>(cols, cap, pin, width, round_off, n_rounds, clear_off,
                                clear_slots, n_clear, pout, widest, stream);
}

// K4's grid is ceil(widest / 32) blocks of 64, at least 1, a plain
// launch.
extern "C" int guber_multi_uniform_step(void* const* cols, long long cap, const void* pin,
                                        int width, const void* round_off, int n_rounds,
                                        const void* clear_off, const void* clear_slots,
                                        int n_clear, void* pout, int widest, void* stream) {
  constexpr int S = kRangeThreads / 2;
  if (width < 1 || n_rounds < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = n_rounds > 1 ? 2 * (size_t)n_rounds * sizeof(int32_t) : 0;
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  Cols c;
  for (int i = 0; i < kCols; ++i) c.p[i] = static_cast<int32_t*>(cols[i]);
  const int grid = widest > S ? (widest + S - 1) / S : 1;
  slot_range_kernel<Uniform><<<grid, kRangeThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      c, cap, static_cast<const int32_t*>(pin), width, static_cast<const int32_t*>(round_off),
      n_rounds, static_cast<const int32_t*>(clear_off),
      static_cast<const int32_t*>(clear_slots), n_clear, static_cast<int32_t*>(pout));
  return static_cast<int>(cudaGetLastError());
}
