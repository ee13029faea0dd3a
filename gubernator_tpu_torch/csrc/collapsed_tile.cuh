// The collapsed hot-key step's tile, shared by K3 (collapsed_step.cu,
// one chunk) and K12 (sharded_step.cu `shard_collapsed_kernel`, one
// chunk a shard): the design is in the note at the top of
// collapsed_step.cu.  A launch is ceil(W / kThreads) blocks of kThreads
// threads (a 2-D grid in K12, one row a shard); `pub` is the launch's
// publish buffer (one a shard in K12).  K16 (split_step.cu
// `collapsed_compute_kernel`) runs the same tile with no clears and the
// `ToWords` store policy: each segment's final words go to a words
// buffer at the segment's column instead of the state.

#pragma once

#include <climits>
#include <cstdint>

#include "lane_math.cuh"

namespace lane {
namespace collapsed {

constexpr int kThreads = 64;  // threads per block (T), lanes per tile
constexpr int kPre = 8;       // clear entries a thread loads at once
// int64 words of a row of `pub`: row 0 holds the ticket counter (word
// 0); row 1 + k tile k's published segment, 8 terms then the stamp.
constexpr int kPub = 16;
// Polls of a published stamp before the wait traps (each an L2 round
// trip and a 64 ns sleep: far longer than any owner takes to publish).
constexpr int kSpinLimit = 1 << 20;

// What the lanes after a segment's first answer from (the closed form's
// terms for the m - 1 extras).
struct Extra {
  int64_t base;     // R1 (token) or floor(W1) (leaky)
  int64_t a2;       // extras admitted
  int64_t h;        // hits
  int64_t after;    // base - a2 * h: a rejected extra's remaining
  int64_t reset;    // token: the expiry; leaky: the limit
  int64_t lk_rate;  // leaky reset slope
  int64_t acc_status, tok;  // an admitted extra's status; token bucket
};

// The answer of the extra at position p >= 1 of a segment.
__device__ __forceinline__ void answer_extra(const Extra& e, int64_t p, int64_t now,
                                             int32_t& status, int64_t& rem, int64_t& reset) {
  const bool acc = p - 1 < e.a2;
  rem = acc ? sub64(e.base, mul64(p, e.h)) : e.after;
  status = acc ? (int32_t)e.acc_status : kOver;
  reset = e.tok ? e.reset : add64(now, mul64(sub64(e.reset, rem), e.lk_rate));
}

__device__ __forceinline__ void store_release(int64_t* p, int64_t v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}
__device__ __forceinline__ int64_t load_acquire(const int64_t* p) {
  int64_t v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

// One block's tile of a collapsed launch over the state `st` of `cap`
// slots: K3's whole kernel body (see the note at the top of
// collapsed_step.cu), and K12's for one shard.  Called by every thread of
// a block of kThreads.  `out_words` is where a segment's final words go
// (lane_math.cuh's store policies; the column passed is the segment's).
template <class Out = ToState>
__device__ __forceinline__ void collapsed_tile(Cols st, long long cap,
                                               const int32_t* __restrict__ pin, int width,
                                               const int32_t* __restrict__ clear_slots,
                                               int n_clear, int64_t* pub, int64_t tiles_before,
                                               int32_t* __restrict__ pout,
                                               const Out& out_words = Out{}) {
  constexpr int T = kThreads;
  __shared__ Extra ext[T];        // owner index -> its segment's extras terms
  __shared__ int64_t rem1[T], rst1[T];  // owner index -> the first application's answer
  __shared__ int32_t st1[T];      // ... its status
  __shared__ int64_t seg_slot[T];  // each lane's segment slot (clears only)
  __shared__ int32_t cleared[T];   // owner index -> its slot is in the clear list
  __shared__ int64_t range_hi;     // f((b+1)T), the end of the block's slot range
  __shared__ int32_t edge_pos;     // position of the block's first lane
  __shared__ int32_t tile;         // the block's ticket: its lanes [tile·T, (tile+1)·T)
  __shared__ Extra head;           // the incoming segment's terms

  const size_t w = (size_t)width;
  const int tid = threadIdx.x;
  // `tiles_before` tiles were taken from this counter by earlier launches,
  // so this launch's tickets run from there (see the note at the top of collapsed_step.cu);
  // the stamp is unique per launch for the same reason.
  const int64_t stamp = tiles_before + 1;
  if (tid == 0) {
    const unsigned long long k =
        atomicAdd(reinterpret_cast<unsigned long long*>(pub), 1ULL) - (unsigned long long)tiles_before;
    if (k >= gridDim.x) __trap();
    tile = (int)k;
  }
  __syncthreads();
  const int blk = tile;
  const int base = blk * T;
  const int lane = base + tid;
  const int last = (width - base < T ? width - base : T) - 1;  // the block's last lane
  const bool has_lane = tid <= last;
  const int64_t now = combine(__ldg(pin), __ldg(pin + 1));
  auto at = [&](int r, int i) { return __ldg(pin + (size_t)r * w + i); };
  auto at64 = [&](int hr, int i) { return combine(at(hr, i), at(hr + 1, i)); };
  auto seg_of = [&](int i) {
    const int32_t s = at(17, i);
    return s < 0 ? 0 : (s >= width ? width - 1 : s);
  };

  // Loads go out in dependency order, each level together (no thread's
  // load waits behind another branch's): the lane's segment and position,
  // then the segment's slot, then (owners) its 12 state words.
  const bool clears = n_clear > 0;
  const int nxt = base + T;  // the next block's first lane (clears only)
  const bool at_edge = clears && tid == T - 1 && nxt < width;
  int32_t sg = 0, pos = 0, nxt_sg = 0, nxt_pos = 0;
  if (has_lane) {
    sg = seg_of(lane);
    pos = at(18, lane);
  }
  if (at_edge) {
    nxt_sg = seg_of(nxt);
    nxt_pos = at(18, nxt);
  }
  const bool owner = has_lane && pos == 0;
  if (tid == 0) edge_pos = pos;
  const int32_t slot = has_lane ? at(1, sg) : 0;
  const int32_t nxt_slot = at_edge ? at(1, nxt_sg) : 0;

  // The owner's segment: its request and the slot's 12 words.
  const bool valid = owner && slot >= 0 && (long long)slot < cap;
  int32_t m = 0;
  Req q{};
  int32_t g[kCols];
  if (owner) {
    m = at(2, sg);
    q = Req{at(3, sg), at(4, sg), at64(5, sg), at64(7, sg),
            at64(9, sg), at64(11, sg), at64(13, sg), at64(15, sg)};
    gather(st, slot, valid, g);
  }
  // The first clear entries, behind the chain's loads and under the
  // gathers' latency.
  int32_t cl[kPre];
  if (clears) {
#pragma unroll
    for (int k = 0; k < kPre; ++k) {
      const int i = tid + k * T;
      cl[k] = i < n_clear ? __ldg(clear_slots + i) : -1;
    }
  }

  // Clears.  A segment's slot: its owner clears the bit in registers.
  // Another in-range slot of the block's range: nobody reads it in this
  // launch, so its meta word is read after the last barrier before the
  // update and written at the end.
  unsigned foreign = 0;  // bit k: cl[k] is such a slot
  int32_t meta_old[kPre];
  if (clears) {  // uniform across the grid
    seg_slot[tid] = has_lane ? slot : INT64_MAX;
    cleared[tid] = 0;
    if (tid == T - 1) range_hi = at_edge ? (int64_t)nxt_slot + (nxt_pos != 0 ? 1 : 0) : INT64_MAX;
    __syncthreads();
    // The block's slot range [lo, hi): every slot of a segment it owns,
    // and no slot of another block's segment.
    const int64_t lo = blk == 0 ? INT64_MIN : seg_slot[0] + (edge_pos != 0 ? 1 : 0);
    const int64_t hi = range_hi;
    // -1: not this block's; -2: an in-range slot of no segment; else the
    // owner index of the segment whose slot it is.
    auto classify = [&](int64_t c) -> int {
      if (c < lo || c >= hi || c < 0 || c >= cap) return -1;
      int a = 0, b = T;  // first index with seg_slot >= c
      while (a < b) {
        const int mid = (a + b) >> 1;
        if (seg_slot[mid] < c) a = mid + 1; else b = mid;
      }
      return a < T && seg_slot[a] == c ? a : -2;
    };
#pragma unroll
    for (int k = 0; k < kPre; ++k) {
      const int a = classify(cl[k]);
      if (a >= 0) cleared[a] = 1;
      if (a == -2) foreign |= 1u << k;
    }
    // Entries past the first kPre·T: kPre at a time, loads together, their
    // other slots cleared at once.
    for (int i0 = tid + kPre * T; i0 < n_clear; i0 += kPre * T) {
      int32_t c[kPre];
      int32_t old[kPre];
#pragma unroll
      for (int k = 0; k < kPre; ++k) {
        const int i = i0 + k * T;
        c[k] = i < n_clear ? __ldg(clear_slots + i) : -1;
      }
#pragma unroll
      for (int k = 0; k < kPre; ++k) {
        const int a = classify(c[k]);
        if (a >= 0) cleared[a] = 1;
        if (a == -2) old[k] = __ldcg(st.p[kMeta] + c[k]); else c[k] = -1;
      }
#pragma unroll
      for (int k = 0; k < kPre; ++k)
        if (c[k] >= 0) st.p[kMeta][c[k]] = old[k] & ~1;
    }
    __syncthreads();
    if (owner && cleared[tid]) g[kMeta] &= ~1;
    // Read now (a barrier would wait for the reads), written at the end.
#pragma unroll
    for (int k = 0; k < kPre; ++k)
      if (foreign >> k & 1u) meta_old[k] = __ldcg(st.p[kMeta] + cl[k]);
  }

  if (owner) {
    Vals v;
    Resp r1;
    int64_t lk_rate_i;
    update_lane(g, valid, q, now, v, r1, lk_rate_i);

    const int64_t extras = m - 1 > 0 ? m - 1 : 0;
    const int64_t h = q.hits;
    const int64_t h_safe = h > 1 ? h : 1;
    const bool is_tok = q.algo == 0;
    auto clip = [&](int64_t x) { return x < 0 ? 0 : (x > extras ? extras : x); };
    // Token extras over R1; leaky extras over the floor of the
    // fixed-point remaining.
    const double W1f = v.rem_f;
    Extra e;
    e.base = is_tok ? v.rem : f2i64(W1f);
    e.a2 = h > 0 ? clip(floordiv_pos(e.base, h_safe)) : extras;
    e.h = h;
    e.after = sub64(e.base, mul64(e.a2, h));
    e.reset = is_tok ? v.exp : q.limit;
    e.lk_rate = lk_rate_i;
    e.acc_status = is_tok ? v.status : kUnder;
    e.tok = is_tok;
    ext[tid] = e;
    rem1[tid] = r1.rem;
    rst1[tid] = r1.reset;
    st1[tid] = r1.status;
    if (tid + (m > 1 ? m : 1) > T) {  // the block's last segment goes on: publish it
      int64_t* out = pub + (size_t)(1 + blk) * kPub;
      out[0] = e.base;
      out[1] = e.a2;
      out[2] = e.h;
      out[3] = e.after;
      out[4] = e.reset;
      out[5] = e.lk_rate;
      out[6] = e.acc_status;
      out[7] = e.tok;
      store_release(out + 8, stamp);
    }

    if (valid) {  // the segment's final values
      if (is_tok) {
        v.rem = e.after;
        if (h > 0 && e.after == 0 && e.a2 < extras) v.status = kOver;  // the sticky OVER
      } else {
        v.rem_f = W1f - (double)mul64(e.a2, h);
      }
      int32_t words[kCols];
      encode_vals(v, words);
      out_words.put(st, slot, sg, words);
    }
  }
  __syncthreads();

  auto emit = [&](int ln, int32_t status, int64_t rem, int64_t reset) {
    pout[ln] = status;
    pout[w + ln] = hi_word(rem);
    pout[2 * w + ln] = lo_word(rem);
    pout[3 * w + ln] = hi_word(reset);
    pout[4 * w + ln] = lo_word(reset);
  };
  int32_t status;
  int64_t rem, reset;
  // This block's lanes whose owner is in the block.
  if (has_lane && pos >= 0 && pos <= tid) {
    const int o = tid - pos;
    if (pos == 0) {
      emit(lane, st1[o], rem1[o], rst1[o]);
    } else {
      answer_extra(ext[o], pos, now, status, rem, reset);
      emit(lane, status, rem, reset);
    }
  }
  // The block's first lanes belong to a segment owned by an earlier tile:
  // wait for its terms (its holder is running, see the note at the top of collapsed_step.cu),
  // then answer them here.
  const int64_t first = base - (int64_t)edge_pos;
  if (edge_pos > 0 && first >= 0) {  // uniform across the block
    if (tid == 0) {
      const int64_t* in = pub + (size_t)(1 + first / T) * kPub;
      for (int spin = 0; load_acquire(in + 8) != stamp; ++spin) {
        if (spin == kSpinLimit) __trap();  // no owner published: fail, never answer stale terms
        __nanosleep(64);
      }
      auto word = [&](int k) {
        return (int64_t)__ldcg(reinterpret_cast<const long long*>(in + k));
      };
      head = Extra{word(0), word(1), word(2), word(3), word(4), word(5), word(6), word(7)};
    }
    __syncthreads();
    if (has_lane && pos > tid) {
      answer_extra(head, pos, now, status, rem, reset);
      emit(lane, status, rem, reset);
    }
  }

#pragma unroll
  for (int k = 0; k < kPre; ++k)
    if (foreign >> k & 1u) st.p[kMeta][cl[k]] = meta_old[k] & ~1;
}


}  // namespace collapsed
}  // namespace lane
