// K1 and K4: the fused bucket decision step for Hopper (sm_90a), all of a
// launch's rounds in one cooperative launch, in two formats: K1 the
// general one (a lane carries its request), K4 the uniform narrow one (a
// round's lanes share one config from its header).
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
// version is `multi_uniform_step_reference`.  Both formats are one
// template, `rounds_kernel<F>`, over the round loop below; the lane math
// is csrc/lane_math.cuh, shared with K3.
//
// Input.  pin int32 [16, L] (K1) or [2, L] (K4) holds the R rounds one
// after another along the lanes; round r owns lanes [round_off[r],
// round_off[r+1]), sorted by slot, each slot at most once; row 0 of a
// round's first lanes is its header (K1: `now`; K4: `now` and the
// config), so the rounds of several batches can share a launch.  Clears
// come in CSR form: round r's are clear_slots[clear_off[r] ..
// clear_off[r+1]).
//
// Design.  What costs at serving widths is the fixed cost of a launch and
// of the host round trip around it, paid once per round when each round
// was its own launch; the bytes are ~0.05 us of a 1000-lane round.  So:
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
//    next round) -- the 15 request rows, slot first (K4: the slot row
//    alone) -- into a double-buffered shared-memory tile with `cp.async`
//    (4 B a thread a row: a warp moves one aligned 128 B line a row,
//    since rounds are padded to 32 lanes).  Each thread reads only its
//    own column of the tile, so the copy needs a per-thread
//    `cp.async.wait_group` and no block barrier.  After grid.sync() the
//    lane's slot is in shared memory and its 12 state gathers issue at
//    once.
//  * State gathers go through L2 only (`__ldcg`): words written by other
//    SMs in an earlier round are never read from a stale L1 line.
// The lane math (csrc/lane_math.cuh) is the reference's branch-free
// select chain, transcribed term for term, with its exactness rules.
//
// Bound.  Per lane the step must move 60 B of pin (rows 1-15) and 20 B of
// pout, and per in-range lane 48 B of state read and 48 B written; plus
// the 8 B `now` header per round and 12 B per in-range clear (slot, meta
// read, meta written).  A 1000-lane round is about 176 KB, ~53 ns at
// 3.35 TB/s.  K4 moves 4 B of pin and 8 B of pout per lane, 40 B of
// header per round, and the same state words.
// The random 4 B state accesses touch a 32 B sector per column (768 B a
// lane of real traffic), and each round adds a grid barrier.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include "coop_launch.cuh"
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

// The general format (K1): pin int32 [16, L], one lane's request in rows
// 1-15; the round header is `now` in row 0 of the round's first two
// lanes; pout int32 [5, L].
struct General {
  static constexpr int kReqRows = 15;  // pin rows 1-15: slot and the request fields
  struct Header {
    int64_t now;
  };
  static __device__ __forceinline__ Header header(const int32_t* __restrict__ pin, int lo) {
    return {combine(__ldg(pin + lo), __ldg(pin + lo + 1))};
  }
  // `req` is the lane's column of the request tile (pin rows 1-15,
  // `stride` words apart).
  static __device__ __forceinline__ void step(const Cols& st, long long cap, const Header& h,
                                              const int32_t* req, int stride, int lane,
                                              int32_t* __restrict__ pout, size_t w) {
    auto row = [&](int r) { return req[(r - 1) * stride]; };
    auto row64 = [&](int hr, int lr) { return combine(row(hr), row(lr)); };
    const int32_t slot = row(1);
    const bool valid = slot >= 0 && (long long)slot < cap;
    int32_t g[kCols];
    gather(st, slot, valid, g);
    const Req q{row(2), row(3), row64(4, 5), row64(6, 7),
                row64(8, 9), row64(10, 11), row64(12, 13), row64(14, 15)};
    Vals v;
    Resp out;
    int64_t lk_rate_i;
    update_lane(g, valid, q, h.now, v, out, lk_rate_i);
    if (valid) {
      int32_t words[kCols];
      encode_vals(v, words);
      store(st, slot, words);
    }
    pout[lane] = out.status;
    pout[w + lane] = hi_word(out.rem);
    pout[2 * w + lane] = lo_word(out.rem);
    pout[3 * w + lane] = hi_word(out.reset);
    pout[4 * w + lane] = lo_word(out.reset);
  }
};

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

// The round loop of K1 and K4: every round of the launch in order, each
// after its clears, with a grid barrier between rounds; format F says
// how a lane's request is read and its answer written.
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

}  // namespace

// cols: 12 device pointers in BucketState field order; pin int32
// [16, width] (K1) or [2, width] (K4); round_off / clear_off int32
// [n_rounds + 1]; clear_slots int32 [n_clear]; pout int32 [5, width] (K1)
// or [2, width] (K4); widest: the widest round's lanes; stream: a
// cudaStream_t.  The grid is min(ceil(widest / T), co-resident blocks),
// at least 1.
// Returns 0 once the cooperative kernel is launched, else the cudaError
// (a refused launch is not retried in another form).
extern "C" int guber_multi_fused_step(void* const* cols, long long cap, const void* pin,
                                      int width, const void* round_off, int n_rounds,
                                      const void* clear_off, const void* clear_slots,
                                      int n_clear, void* pout, int widest, void* stream) {
  return launch_rounds<General>(cols, cap, pin, width, round_off, n_rounds, clear_off,
                                clear_slots, n_clear, pout, widest, stream);
}

extern "C" int guber_multi_uniform_step(void* const* cols, long long cap, const void* pin,
                                        int width, const void* round_off, int n_rounds,
                                        const void* clear_off, const void* clear_slots,
                                        int n_clear, void* pout, int widest, void* stream) {
  return launch_rounds<Uniform>(cols, cap, pin, width, round_off, n_rounds, clear_off,
                                clear_slots, n_clear, pout, widest, stream);
}
