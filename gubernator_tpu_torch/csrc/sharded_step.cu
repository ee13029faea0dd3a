// K11 and K12: the sharded engine's per-shard steps for Hopper (sm_90a),
// every shard of a batch's rounds (K11) or of a collapsed chunk (K12) in
// one launch, over bucket state held as [n_sh, shard_cap] on one card.
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
// lanes (`shard_cap + lane`) never reach the next shard's slots.  The
// plain PyTorch versions are gubernator_tpu_torch/ops/bucket_kernel.py
// `sharded_multi_fused_step_reference` (the rounds, each after its
// clears) and `sharded_collapsed_step_reference` (after the shards'
// `clear_occupied_reference`); each pair is bit-equal.
//
// K11 `shard_rounds_kernel`: every round of a batch, every shard, one
// launch.  pin int32 [n_sh, 16, L] holds the R rounds one after another
// along the lanes, round r at lanes [round_off[r], round_off[r+1]) of
// every shard (one round_off [R+1] for all shards: each round is padded to
// its widest shard), each shard's lanes of a round sorted by slot, each
// slot at most once a round, `now` in row 0 of the round's first two
// lanes; clears in CSR form, round r's at columns [clear_off[r],
// clear_off[r+1]) of clear_slots int32 [n_sh, C], each shard's run of a
// round ascending (padded with out-of-range slots); pout [n_sh, 5, L].
// R = 1 is the layout of one round: round_off [0, L], clear_off [0, C].
//
// K11's design.  The cost at the engine's widths is the fixed cost of a
// launch and of the host round trip around it, paid once a round when
// each round was its own launch (3.42 us a 1000-item batch over 4 shards,
// an empty kernel 1.69, the bytes 0.08).  So one launch takes every
// round, and rounds need an order between them without a grid barrier
// (K1's costs ~3 us a round): K4's slot-range ownership
// (csrc/fused_step.cu `slot_range_kernel`) with a shard axis.
//  * A 2-D grid (ceil(widest / S), n_sh).  Block (b, sh) owns the slots
//    [split_b, split_{b+1}) of shard sh, split_b the slot of lane b·S of
//    the launch's widest round (the first range open below, the last open
//    above): every access to a slot of the shard, in any round, is made by
//    one block, so __syncthreads orders round r's stores before round
//    r+1's gathers.  S = T at R = 1 (one lane a thread), T / 2 above, so
//    that a block's uneven share of another round still takes one pass.
//  * The block finds its lanes of each other round by two lower bounds
//    of its splits over the round's sorted slot row (K4's search: a warp
//    runs up to eight at once, each step probing 32 evenly spaced lanes);
//    at R = 1 nothing is searched and nothing waits on the offsets.  A
//    lane reads its 15 request rows by its lane index, as K1's lane body.
//  * Clears with no barrier of their own.  A clear of round r must land
//    before round r's gather of the same slot.  The lane whose slot is in
//    its round's clear run drops the occupied bit from its gathered meta
//    word (a binary search of the run, while its gathers are in flight);
//    a clear entry in the block's range that is no lane's slot of the
//    round (a binary search of the block's lanes) is written at once: no
//    lane of the round touches it, and the rounds before and after are
//    on the other side of a barrier.
//
// K12 `shard_collapsed_kernel`: pin int32 [n_sh, 19, W], pout
// [n_sh, 5, W], clear_slots [n_sh, C] in any order; a 2-D grid
// (ceil(W / T), n_sh), each row K3's blocks over one shard's chunk:
// K3's tile (csrc/collapsed_tile.cuh, the same code as K3's) with the
// shard's columns, pin, clears, output and publish buffer.  Each shard
// has its own publication chain: `pub` holds one [1 + pub_tiles, 16]
// buffer a shard, row 0 its ticket counter, so a hot key's segment is
// published only to the blocks of its own shard and a block waits only
// on earlier tiles of its shard, which took their tickets first and are
// running.  Every shard of a launch takes ceil(W / T) tiles, so one
// `tiles_before` serves them all.  One block a shard's whole chunk (no
// ticket, no publication) was tried and lost from 512 lanes a shard up:
// one SM then issues every segment's random state reads
// (scripts/torch_k12_block.py, PERF.md §6).
//
// Bound: bytes.  K11: per shard and round 8 B of header, per lane 60 B of
// pin and 20 B of pout, per in-range lane 48 B of state read and 48 B
// written, 12 B per in-range clear.  K12: K3's bound summed over the
// shards.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "collapsed_tile.cuh"
#include "general_lane.cuh"
#include "lane_math.cuh"

using namespace lane;

namespace {

constexpr int kRoundThreads = 64;  // K11 threads per block (T)
constexpr int kProbes = 8;         // searches a warp of K11's prologue runs at once
constexpr int kClearBatch = 4;     // clear entries a thread of K11 loads at once
constexpr int kInRows = 16;        // K11 pin rows
constexpr int kCollapsedRows = 19;  // K12 pin rows
constexpr int kOutRows = 5;

// Whether the ascending run `a` [0, n) holds `v`.
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

// One K11 lane: its slot's words gathered first, then (while they are in
// flight) whether the slot is in its round's clear run `rc` [0, nc),
// then K1's update of the lane (csrc/general_lane.cuh's body, with the
// clear's bit dropped from the gathered meta word).
__device__ __forceinline__ void shard_lane(const Cols& c, long long cap, int64_t now,
                                           const int32_t* __restrict__ p, size_t w, int lane,
                                           const int32_t* __restrict__ rc, int nc,
                                           int32_t* __restrict__ o) {
  auto row = [&](int r) { return __ldg(p + (size_t)r * w + lane); };
  auto row64 = [&](int hr, int lr) { return combine(row(hr), row(lr)); };
  const int32_t slot = row(1);
  const bool valid = slot >= 0 && (long long)slot < cap;
  int32_t g[kCols];
  gather(c, slot, valid, g);
  const Req q{row(2), row(3), row64(4, 5), row64(6, 7),
              row64(8, 9), row64(10, 11), row64(12, 13), row64(14, 15)};
  if (nc > 0 && valid && sorted_has(rc, nc, slot)) g[kMeta] &= ~1;
  Vals v;
  Resp out;
  int64_t lk_rate_i;
  update_lane(g, valid, q, now, v, out, lk_rate_i);
  if (valid) {
    int32_t words[kCols];
    encode_vals(v, words);
    store(c, slot, words);
  }
  o[lane] = out.status;
  o[w + lane] = hi_word(out.rem);
  o[2 * w + lane] = lo_word(out.rem);
  o[3 * w + lane] = hi_word(out.reset);
  o[4 * w + lane] = lo_word(out.reset);
}

// K11: block (b, sh) runs its slot range of shard sh in every round (see
// the note at the top); `span` lanes of the widest round a block.
__global__ void __launch_bounds__(kRoundThreads)
shard_rounds_kernel(Cols st, long long shard_cap, const int32_t* __restrict__ pin, int width,
                    const int32_t* __restrict__ round_off, int n_rounds,
                    const int32_t* __restrict__ clear_off,
                    const int32_t* __restrict__ clear_slots, int n_clear, int span,
                    int32_t* __restrict__ pout) {
  constexpr int T = kRoundThreads;
  constexpr int kWarps = T / 32;
  extern __shared__ int32_t lane_lo[];  // R > 1: [2R], this block's lanes of round r are
  int32_t* lane_hi = lane_lo + n_rounds;  // [lane_lo[r], lane_hi[r])
  const int sh = (int)blockIdx.y;
  const size_t w = (size_t)width;
  const Cols c = shard_cols(st, shard_cap, sh);
  const int32_t* p = pin + (size_t)sh * kInRows * w;
  const int32_t* slots = p + w;  // row 1
  const int32_t* cl = clear_slots + (size_t)sh * (size_t)n_clear;
  int32_t* o = pout + (size_t)sh * kOutRows * w;
  const int tid = threadIdx.x, warp = tid >> 5, ln = tid & 31;
  const int b = (int)blockIdx.x;
  const bool first_blk = b == 0, last_blk = b == (int)gridDim.x - 1;
  // Offsets are clamped, so a malformed call cannot reach past pin/pout;
  // at R = 1 they are [0, W] and [0, C] and are not read.
  auto roff = [&](int r) {
    if (n_rounds == 1) return r == 0 ? 0 : width;
    const int v = __ldg(round_off + r);
    return v < 0 ? 0 : (v > width ? width : v);
  };
  auto coff = [&](int r) {
    if (n_rounds == 1) return r == 0 ? 0 : n_clear;
    const int v = __ldg(clear_off + r);
    return v < 0 ? 0 : (v > n_clear ? n_clear : v);
  };

  // The widest round (the first, on a tie), found by every warp alike.
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
  // The block's slot range, from the widest round's lanes b·span and
  // (b+1)·span.
  auto split = [&](int k) { return k >= ww ? INT64_MAX : (int64_t)__ldg(slots + w0 + k); };
  const int64_t s_lo = first_blk ? INT64_MIN : split(b * span);
  const int64_t s_hi = last_blk ? INT64_MAX : split((b + 1) * span);
  auto own_range = [&](int r, int& lo, int& hi) {
    if (r == wr) {  // the widest round: lanes b·span .. (b+1)·span, no search
      lo = w0 + (b * span < ww ? b * span : ww);
      hi = w0 + (last_blk || (b + 1) * span > ww ? ww : (b + 1) * span);
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

  for (int r = 0; r < n_rounds; ++r) {
    int lo, hi;
    own_range(r, lo, hi);
    const int c_lo = coff(r), c_hi = coff(r + 1);
    const int32_t* rc = cl + c_lo;  // the round's clear run of this shard, ascending
    const int nc = c_hi > c_lo ? c_hi - c_lo : 0;
    if (lo < hi) {
      const int64_t now = General::header(p, roff(r)).now;
      for (int lane = lo + tid; lane < hi; lane += T)
        shard_lane(c, shard_cap, now, p, w, lane, rc, nc, o);
    }
    // The round's clears in this block's range that are no lane's slot of
    // the round: loaded kClearBatch at a time, written at once.
    for (int i0 = tid; i0 < nc; i0 += kClearBatch * T) {
      int32_t e[kClearBatch];
#pragma unroll
      for (int k = 0; k < kClearBatch; ++k) {
        const int i = i0 + k * T;
        e[k] = i < nc ? __ldg(rc + i) : -1;
      }
#pragma unroll
      for (int k = 0; k < kClearBatch; ++k) {
        const int32_t s = e[k];
        if (s >= 0 && (long long)s < shard_cap && s >= s_lo && s < s_hi &&
            !sorted_has(slots + lo, hi > lo ? hi - lo : 0, s))
          c.p[kMeta][s] = __ldcg(c.p[kMeta] + s) & ~1;
      }
    }
    if (r + 1 < n_rounds) __syncthreads();  // round r's stores before round r+1's gathers
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
// [n_sh, 16, width]; round_off / clear_off int32 [n_rounds + 1] (not read
// when n_rounds is 1); clear_slots int32 [n_sh, n_clear] (n_clear may be
// 0), each row's run of a round ascending; pout int32 [n_sh, 5, width];
// widest: the widest round's lanes; stream: a cudaStream_t.  The grid is
// (ceil(widest / S), n_sh), S = 64 at R = 1 and 32 above.  Returns 0 once
// K11 is launched, else the cudaError.
extern "C" int guber_shard_step(void* const* cols, long long shard_cap, int n_sh,
                                const void* pin, int width, const void* round_off, int n_rounds,
                                const void* clear_off, const void* clear_slots, int n_clear,
                                int widest, void* pout, void* stream) {
  constexpr int T = kRoundThreads;
  if (width < 1 || n_sh < 1 || n_sh > 65535 || n_clear < 0 || shard_cap < 1 || n_rounds < 1 ||
      widest < 0 || widest > width)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = n_rounds > 1 ? 2 * (size_t)n_rounds * sizeof(int32_t) : 0;
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  const int span = n_rounds == 1 ? T : T / 2;
  const dim3 grid(widest > span ? (widest + span - 1) / span : 1, n_sh);
  shard_rounds_kernel<<<grid, T, smem, static_cast<cudaStream_t>(stream)>>>(
      make_cols(cols), shard_cap, static_cast<const int32_t*>(pin), width,
      static_cast<const int32_t*>(round_off), n_rounds, static_cast<const int32_t*>(clear_off),
      static_cast<const int32_t*>(clear_slots), n_clear, span, static_cast<int32_t*>(pout));
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
