// K3: the collapsed hot-key step for Hopper (sm_90a), one cooperative
// launch per chunk of a hot-key batch.
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
// `now`; rows 1-16 one segment per lane (slot, m, algo, behavior, then
// hits, limit, duration, burst, greg_dur, greg_exp as hi/lo pairs);
// row 17 each request lane's segment, row 18 its position in the
// segment.  Segment slots are unique.  clear_slots int32 [n_clear].
// Output pout int32 [5, W], in request-lane order.
//
// Design.  One launch, three steps with a grid barrier between each:
//  0. the clears (only when n_clear > 0; uniform across the grid);
//  A. one thread per segment lane: gather the slot's 12 words, run the
//     full update (csrc/lane_math.cuh, shared with K1 and K4), apply the
//     closed form for the segment's m-1 extras (token: a2 = clip(R1 //
//     h, 0, m-1), the sticky OVER only at exactly 0; leaky over the
//     floor of the 32.32 remaining), store the segment's final words, and
//     write the terms every lane of the segment answers from to an int64
//     scratch [kTerms, W] the wrapper allocates;
//  B. one thread per request lane: read its segment's terms (through L2:
//     other SMs wrote them) and write its 5 pout words.
// Padding segments (m = 0, slot out of range: the columns past the
// chunk's segments) skip A, except the last column: the packer points
// every padding request lane at it, so those lanes answer exactly what
// the reference's gather gives them.  No other lane reads a padding
// segment's terms.
//
// Bound.  8 B of header; per lane rows 17-18 read (8 B) and 5 pout
// words written (20 B); per in-range segment rows 1-16 read (64 B), 48 B
// of state read and 48 B written; 12 B per in-range clear.  The scratch
// (88 B a segment, written once and read once per lane) is the design's
// own traffic, not the function's.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include "coop_launch.cuh"
#include "lane_math.cuh"

namespace cg = cooperative_groups;
using namespace lane;

namespace {

constexpr int kThreads = 64;

// The per-segment terms phase B reads (rows of the int64 scratch).
enum Term {
  tSt1, tRem1, tRst1,  // the first application's answer
  tR1, tA2Tok, tRem2Tok, tStatus, tExpire,  // token extras
  tW1, tA2Lk, tLkRate,  // leaky extras
  kTerms
};

__global__ void __launch_bounds__(kThreads)
collapsed_step_kernel(Cols st, long long cap, const int32_t* __restrict__ pin, int width,
                      const int32_t* __restrict__ clear_slots, int n_clear,
                      int64_t* __restrict__ scratch, int32_t* __restrict__ pout) {
  cg::grid_group grid = cg::this_grid();
  const size_t w = (size_t)width;
  const int stride = (int)gridDim.x * kThreads;
  const int first = (int)blockIdx.x * kThreads + (int)threadIdx.x;
  const int64_t now = combine(__ldg(pin), __ldg(pin + 1));
  auto at = [&](int r, int i) { return __ldg(pin + (size_t)r * w + i); };
  auto at64 = [&](int hr, int i) { return combine(at(hr, i), at(hr + 1, i)); };
  auto term = [&](Term t, int s) -> int64_t* { return scratch + (size_t)t * w + s; };

  if (n_clear > 0) {  // uniform across the grid
    for (int i = first; i < n_clear; i += stride) {
      const int32_t s = __ldg(clear_slots + i);
      if (s >= 0 && (long long)s < cap) st.p[kMeta][s] = __ldcg(st.p[kMeta] + s) & ~1;
    }
    grid.sync();
  }

  // A: one thread per segment.
  for (int s = first; s < width; s += stride) {
    const int32_t slot = at(1, s);
    const bool valid = slot >= 0 && (long long)slot < cap;
    const int64_t m = at(2, s);
    if (!valid && m == 0 && s != width - 1) continue;  // padding: no lane reads it
    int32_t g[kCols];
    gather(st, slot, valid, g);
    const Req q{at(3, s), at(4, s), at64(5, s), at64(7, s),
                at64(9, s), at64(11, s), at64(13, s), at64(15, s)};
    Vals v;
    Resp r1;
    int64_t lk_rate_i;
    update_lane(g, valid, q, now, v, r1, lk_rate_i);

    const int64_t extras = m - 1 > 0 ? m - 1 : 0;
    const int64_t h = q.hits;
    const int64_t h_safe = h > 1 ? h : 1;
    const bool is_tok = q.algo == 0;
    auto clip = [&](int64_t x) { return x < 0 ? 0 : (x > extras ? extras : x); };

    // Token extras.
    const int64_t R1 = v.rem;
    const int64_t a2_tok = h > 0 ? clip(floordiv_pos(R1, h_safe)) : extras;
    const int64_t rem2_tok = sub64(R1, mul64(a2_tok, h));
    const bool sticky_over = h > 0 && rem2_tok == 0 && a2_tok < extras;
    // Leaky extras, over the floor of the fixed-point remaining.
    const double W1f = v.rem_f;
    const int64_t W1 = f2i64(W1f);
    const int64_t a2_lk = h > 0 ? clip(floordiv_pos(W1, h_safe)) : extras;

    *term(tSt1, s) = r1.status;
    *term(tRem1, s) = r1.rem;
    *term(tRst1, s) = r1.reset;
    *term(tR1, s) = R1;
    *term(tA2Tok, s) = a2_tok;
    *term(tRem2Tok, s) = rem2_tok;
    *term(tStatus, s) = v.status;
    *term(tExpire, s) = v.exp;
    *term(tW1, s) = W1;
    *term(tA2Lk, s) = a2_lk;
    *term(tLkRate, s) = lk_rate_i;

    if (valid) {  // the segment's final values
      Vals v2 = v;
      if (is_tok) {
        v2.rem = rem2_tok;
      } else {
        v2.rem_f = W1f - (double)mul64(a2_lk, h);
      }
      if (sticky_over && is_tok) v2.status = kOver;
      int32_t words[kCols];
      encode_vals(v2, words);
      store(st, slot, words);
    }
  }
  grid.sync();

  // B: one thread per request lane.
  for (int i = first; i < width; i += stride) {
    int32_t sg = at(17, i);
    sg = sg < 0 ? 0 : (sg >= width ? width - 1 : sg);
    const int64_t pos = at(18, i);
    const int64_t p = pos - 1 > 0 ? pos - 1 : 0;
    auto get = [&](Term t) {
      return (int64_t)__ldcg(reinterpret_cast<const long long*>(term(t, sg)));
    };
    int32_t status;
    int64_t rem, reset;
    if (pos == 0) {
      status = (int32_t)get(tSt1);
      rem = get(tRem1);
      reset = get(tRst1);
    } else {
      const int64_t h = at64(5, sg);
      if (at(3, sg) == 0) {  // token
        const bool acc = p < get(tA2Tok);
        rem = acc ? sub64(get(tR1), mul64(p + 1, h)) : get(tRem2Tok);
        status = acc ? (int32_t)get(tStatus) : kOver;
        reset = get(tExpire);
      } else {  // leaky
        const int64_t W1 = get(tW1);
        const int64_t a2 = get(tA2Lk);
        const bool acc = p < a2;
        rem = acc ? sub64(W1, mul64(p + 1, h)) : sub64(W1, mul64(a2, h));
        status = acc ? kUnder : kOver;
        reset = add64(now, mul64(sub64(at64(7, sg), rem), get(tLkRate)));
      }
    }
    pout[i] = status;
    pout[w + i] = hi_word(rem);
    pout[2 * w + i] = lo_word(rem);
    pout[3 * w + i] = hi_word(reset);
    pout[4 * w + i] = lo_word(reset);
  }
}

coop::ResidentCache g_resident;

}  // namespace

// cols: 12 device pointers in BucketState field order; pin int32
// [19, width]; clear_slots int32 [n_clear] (n_clear may be 0); scratch
// int64 [11, width]; pout int32 [5, width]; stream: a cudaStream_t.  The
// grid is min(ceil(width / T), co-resident blocks).
// Returns 0 once the cooperative kernel is launched, else the cudaError.
extern "C" int guber_collapsed_step(void* const* cols, long long cap, const void* pin,
                                    int width, const void* clear_slots, int n_clear,
                                    void* scratch, void* pout, void* stream) {
  if (width < 1 || n_clear < 0) return static_cast<int>(cudaErrorInvalidValue);
  Cols c;
  for (int i = 0; i < kCols; ++i) c.p[i] = static_cast<int32_t*>(cols[i]);
  void* args[] = {&c, &cap, &pin, &width, &clear_slots, &n_clear, &scratch, &pout};
  return coop::launch(collapsed_step_kernel, kThreads, g_resident, width, args, stream);
}
