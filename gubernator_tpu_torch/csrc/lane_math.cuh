// The bucket update of one lane, shared by the port's kernels: K1 and K4
// (fused_step.cu, the general and uniform formats), K3
// (collapsed_step.cu), K11 and K12 (sharded_step.cu), and K14 and K16
// (split_step.cu).  One copy of the f64 chain, as the reference keeps
// one `update_lanes` for its Pallas kernel and its XLA programs.
//
// `update_lane` transcribes gubernator_tpu/ops/bucket_kernel.py:514
// `update_lanes` term for term: the reference's branch-free select chain,
// every path computed and the lane's path picking, so padding lanes (zero
// words, zero request) compute exactly what the reference computes for
// them.  `encode_vals` is its `encode_slot_values` (:781).  The plain
// PyTorch version of both is gubernator_tpu_torch/ops/bucket_kernel.py
// `_update_lanes` / `_encode_values`.
//
// Exactness against the reference (XLA:CPU):
//  * f64 division is IEEE `/`; the kernels build with -fmad=false, so no
//    multiply-add is contracted.
//  * f64 -> int conversions use __double2ll_rz / __double2int_rz /
//    __double2uint_rz: truncate toward zero, saturate, NaN -> 0, which is
//    what XLA:CPU does (a plain C++ cast is undefined out of range).
//  * int64 arithmetic that may overflow (now + duration, the reset
//    products) runs in uint64_t and is cast back: two's complement wrap,
//    as in the reference.

#pragma once

#include <cmath>
#include <cstdint>

namespace lane {

constexpr int kCols = 12;
constexpr int64_t kTsClampMax = (int64_t(1) << 43) - 1;
constexpr int32_t kHi11 = 0x7FF;
constexpr int32_t kOver = 1;
constexpr int32_t kUnder = 0;
constexpr int32_t kGreg = 4;    // Behavior.DURATION_IS_GREGORIAN
constexpr int32_t kReset = 8;   // Behavior.RESET_REMAINING

// The 12 state columns, in BucketState field order.
struct Cols {
  int32_t* p[kCols];
};

enum Col {
  kMeta, kHi2, kT0Lo, kExpireLo, kInvalidLo, kDurationLo,
  kLimitHi, kLimitLo, kRemHi, kRemLo, kBurstHi, kBurstLo
};

__device__ __forceinline__ int64_t add64(int64_t a, int64_t b) {
  return (int64_t)((uint64_t)a + (uint64_t)b);
}
__device__ __forceinline__ int64_t sub64(int64_t a, int64_t b) {
  return (int64_t)((uint64_t)a - (uint64_t)b);
}
__device__ __forceinline__ int64_t mul64(int64_t a, int64_t b) {
  return (int64_t)((uint64_t)a * (uint64_t)b);
}
// (hi int32, lo uint32 bits) -> int64
__device__ __forceinline__ int64_t combine(int32_t hi, int32_t lo) {
  return (int64_t)(((uint64_t)(uint32_t)hi << 32) | (uint64_t)(uint32_t)lo);
}
__device__ __forceinline__ int32_t hi_word(int64_t v) { return (int32_t)(v >> 32); }
__device__ __forceinline__ int32_t lo_word(int64_t v) { return (int32_t)(uint32_t)(uint64_t)v; }
__device__ __forceinline__ int64_t clamp_ts(int64_t v) {
  return v < 0 ? 0 : (v > kTsClampMax ? kTsClampMax : v);
}
__device__ __forceinline__ int64_t f2i64(double x) { return __double2ll_rz(x); }
// Floor division by b >= 1 (numpy / XLA `//` on int64).
__device__ __forceinline__ int64_t floordiv_pos(int64_t a, int64_t b) {
  const int64_t q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

// One lane's request fields; `algo` as sent (any nonzero is leaky).
struct Req {
  int32_t algo, beh;
  int64_t hits, limit, dur, burst, gdur, gexp;
};

// The values an update stores (reference `SlotValues` :744).
struct Vals {
  int32_t occ, algo, status;
  int64_t limit, rem;
  double rem_f;
  int64_t dur, t0, exp, burst;
};

// The lane's answer.
struct Resp {
  int32_t status;
  int64_t rem, reset;
};

// Update one lane: `g` its slot's 12 words (zero outside [0, cap)),
// `valid` whether the slot is in range.  Writes the values to store, the
// answer, and the leaky reset slope (`lk_rate_i`, which the collapsed
// step reuses).
__device__ __forceinline__ void update_lane(const int32_t (&g)[kCols], bool valid,
                                            const Req& q, int64_t now, Vals& v, Resp& out,
                                            int64_t& lk_rate_i_out) {
  const int32_t r_algo = q.algo != 0 ? 1 : 0;
  const int32_t r_beh = q.beh;
  const int64_t r_hits = q.hits;
  const int64_t r_limit = q.limit;
  const int64_t r_dur = q.dur;
  const int64_t r_burst = q.burst;
  const int64_t r_gdur = q.gdur;
  const int64_t r_gexp = q.gexp;

  // ---- decode the slot
  const int32_t meta = g[kMeta];
  const bool s_occ = (meta & 1) != 0 && valid;
  const int32_t s_algo = (meta >> 1) & 1;
  const int32_t s_status = (meta >> 2) & 3;
  const int64_t s_t0 = combine((meta >> 4) & kHi11, g[kT0Lo]);
  const int64_t s_inv = combine((meta >> 15) & kHi11, g[kInvalidLo]);
  const int64_t s_exp = combine(g[kHi2] & kHi11, g[kExpireLo]);
  const int64_t s_dur = combine((g[kHi2] >> 11) & kHi11, g[kDurationLo]);
  const int64_t s_limit = combine(g[kLimitHi], g[kLimitLo]);
  const int64_t s_rem = combine(g[kRemHi], g[kRemLo]);
  const double s_rem_f = (double)g[kRemHi] + (double)(uint32_t)g[kRemLo] * 0x1p-32;
  const int64_t s_burst = combine(g[kBurstHi], g[kBurstLo]);

  const bool greg = (r_beh & kGreg) != 0;
  const bool rst = (r_beh & kReset) != 0;

  const bool live = s_occ && !(s_inv != 0 && s_inv < now) && s_exp >= now;
  const bool same = live && s_algo == r_algo;
  const bool is_tok = r_algo == 0;
  const bool p_tok_reset = same && is_tok && rst;
  const bool p_tok_ex = same && is_tok && !rst;
  const bool p_leak_ex = same && !is_tok;
  const bool p_tok_new = !same && is_tok;

  // ---- token bucket, existing item
  int64_t te_rem0 = s_rem;
  if (s_limit != r_limit) {
    const int64_t d = add64(s_rem, sub64(r_limit, s_limit));
    te_rem0 = d > 0 ? d : 0;
  }
  const bool dur_changed = s_dur != r_dur;
  const int64_t te_new_exp = greg ? r_gexp : add64(s_t0, r_dur);
  const bool te_renew = dur_changed && te_new_exp <= now;
  const int64_t te_exp =
      dur_changed ? (te_renew ? add64(now, r_dur) : te_new_exp) : s_exp;
  const int64_t te_created = te_renew ? now : s_t0;
  const int64_t te_rem_store = te_renew ? r_limit : te_rem0;
  const bool te_q = r_hits == 0;
  const bool te_e = te_rem0 == 0 && r_hits > 0;
  const bool te_x = te_rem_store == r_hits;
  const bool te_o = r_hits > te_rem_store;
  int64_t te_rem_out = sub64(te_rem_store, r_hits);
  if (te_o) te_rem_out = te_rem_store;
  if (te_x) te_rem_out = 0;
  if (te_e) te_rem_out = te_rem_store;
  if (te_q) te_rem_out = te_rem_store;
  int64_t te_resp_rem = sub64(te_rem_store, r_hits);
  if (te_o) te_resp_rem = te_rem0;
  if (te_x) te_resp_rem = 0;
  if (te_e) te_resp_rem = te_rem0;
  if (te_q) te_resp_rem = te_rem0;
  const int32_t te_resp_status =
      te_q ? s_status : ((te_e || (!te_x && te_o)) ? kOver : s_status);
  const int32_t te_status_store = (te_e && !te_q) ? kOver : s_status;

  // ---- token bucket, new item
  const int64_t tn_exp = greg ? r_gexp : add64(now, r_dur);
  const bool tn_over = r_hits > r_limit;
  const int64_t tn_rem = tn_over ? r_limit : sub64(r_limit, r_hits);
  const int32_t tn_resp_status = tn_over ? kOver : kUnder;

  // ---- leaky bucket, shared
  const int64_t burst_eff = r_burst == 0 ? r_limit : r_burst;
  const double burst_f = (double)burst_eff;
  const bool limit_pos = r_limit > 0;
  const int64_t lk_d = greg ? r_gdur : r_dur;
  const bool rate_zero = limit_pos && lk_d == 0;
  double lk_rate = (double)lk_d / (double)(limit_pos ? r_limit : 1);
  if (!limit_pos) lk_rate = 0.0;
  const int64_t lk_rate_i = f2i64(lk_rate);
  lk_rate_i_out = lk_rate_i;

  // ---- leaky bucket, existing item
  double le_rem = rst ? burst_f : s_rem_f;
  if (s_burst != burst_eff && burst_eff > f2i64(le_rem)) le_rem = burst_f;
  const int64_t le_eff_dur = greg ? sub64(r_gexp, now) : r_dur;
  const int64_t le_exp = r_hits != 0 ? add64(now, le_eff_dur) : s_exp;
  const double elapsed = (double)sub64(now, s_t0);
  const bool rate_pos = limit_pos && !rate_zero;
  double le_leak = elapsed / (rate_pos ? lk_rate : 1.0);
  if (!rate_pos) le_leak = 0.0;
  const bool leak_inf = rate_zero && elapsed > 0;
  const bool leak_applies = f2i64(le_leak) > 0 || leak_inf;
  if (leak_applies) le_rem = le_rem + le_leak;
  if (leak_inf) le_rem = burst_f;
  const int64_t le_t0 = leak_applies ? now : s_t0;
  if (f2i64(le_rem) > burst_eff) le_rem = burst_f;
  const int64_t le_rem_i = f2i64(le_rem);
  const int64_t le_reset0 = add64(now, mul64(sub64(r_limit, le_rem_i), lk_rate_i));
  const bool le_e = le_rem_i == 0 && r_hits > 0;
  const bool le_x = le_rem_i == r_hits;
  const bool le_o = r_hits > le_rem_i;
  const bool le_q = r_hits == 0;
  const double le_consume = le_rem - (double)r_hits;
  double le_rem_out = le_consume;
  if (le_q) le_rem_out = le_rem;
  if (le_o) le_rem_out = le_rem;
  if (le_x) le_rem_out = le_consume;
  if (le_e) le_rem_out = le_rem;
  const int64_t le_consume_i = f2i64(le_consume);
  int64_t le_resp_rem = le_consume_i;
  if (le_q) le_resp_rem = le_rem_i;
  if (le_o) le_resp_rem = le_rem_i;
  if (le_x) le_resp_rem = 0;
  if (le_e) le_resp_rem = le_rem_i;
  const int32_t le_resp_status = (le_e || (!le_x && le_o)) ? kOver : kUnder;
  int64_t le_reset = add64(now, mul64(sub64(r_limit, le_consume_i), lk_rate_i));
  if (le_q) le_reset = le_reset0;
  if (le_o) le_reset = le_reset0;
  if (le_x) le_reset = add64(now, mul64(r_limit, lk_rate_i));
  if (le_e) le_reset = le_reset0;

  // ---- leaky bucket, new item
  const int64_t ln_dur = greg ? sub64(r_gexp, now) : r_dur;
  const bool ln_over = r_hits > burst_eff;
  const int64_t ln_rem = sub64(burst_eff, r_hits);
  const int64_t ln_resp_rem = ln_over ? 0 : ln_rem;
  const double ln_rem_f = ln_over ? 0.0 : (double)ln_rem;
  const int32_t ln_resp_status = ln_over ? kOver : kUnder;
  const int64_t ln_reset = add64(now, mul64(sub64(r_limit, ln_resp_rem), lk_rate_i));

  // ---- the lane's path picks the answer and the stored values (the
  // reference's `pick`; exactly one path holds).
  v.occ = p_tok_reset ? 0 : 1;
  v.algo = r_algo;
  v.limit = r_limit;
  v.dur = r_dur;
  if (p_tok_reset) {
    out.status = kUnder; out.rem = r_limit; out.reset = 0;
    v.rem = 0; v.rem_f = 0.0; v.t0 = 0; v.exp = 0; v.burst = 0; v.status = kUnder;
  } else if (p_tok_ex) {
    out.status = te_resp_status; out.rem = te_resp_rem; out.reset = te_exp;
    v.rem = te_rem_out; v.rem_f = 0.0; v.t0 = te_created; v.exp = te_exp; v.burst = 0;
    v.status = te_status_store;
  } else if (p_tok_new) {
    out.status = tn_resp_status; out.rem = tn_rem; out.reset = tn_exp;
    v.rem = tn_rem; v.rem_f = 0.0; v.t0 = now; v.exp = tn_exp; v.burst = 0;
    v.status = kUnder;
  } else if (p_leak_ex) {
    out.status = le_resp_status; out.rem = le_resp_rem; out.reset = le_reset;
    v.rem = 0; v.rem_f = le_rem_out; v.t0 = le_t0; v.exp = le_exp; v.burst = burst_eff;
    v.status = kUnder;
  } else {  // leaky, new item (stores the Gregorian remainder as duration)
    out.status = ln_resp_status; out.rem = ln_resp_rem; out.reset = ln_reset;
    v.rem = 0; v.rem_f = ln_rem_f; v.dur = ln_dur; v.t0 = now; v.exp = add64(now, ln_dur);
    v.burst = burst_eff; v.status = kUnder;
  }
}

// The 12 words an update stores (an update always clears invalid_at).
__device__ __forceinline__ void encode_vals(const Vals& v, int32_t (&words)[kCols]) {
  const int64_t t0c = clamp_ts(v.t0);
  const int64_t expc = clamp_ts(v.exp);
  const int64_t durc = clamp_ts(v.dur);
  words[kMeta] = v.occ | (v.algo << 1) | ((v.status & 3) << 2) | (hi_word(t0c) << 4);
  words[kHi2] = hi_word(expc) | (hi_word(durc) << 11);
  words[kT0Lo] = lo_word(t0c);
  words[kExpireLo] = lo_word(expc);
  words[kInvalidLo] = 0;
  words[kDurationLo] = lo_word(durc);
  words[kLimitHi] = hi_word(v.limit);
  words[kLimitLo] = lo_word(v.limit);
  if (v.algo == 1) {  // leaky: 32.32 fixed point, floor quantization
    const double fl = floor(v.rem_f);
    words[kRemHi] = __double2int_rz(fl);  // == clip to int32, then convert
    words[kRemLo] = (int32_t)__double2uint_rz((v.rem_f - fl) * 0x1p32);
  } else {
    words[kRemHi] = hi_word(v.rem);
    words[kRemLo] = lo_word(v.rem);
  }
  words[kBurstHi] = hi_word(v.burst);
  words[kBurstLo] = lo_word(v.burst);
}

// Gather one slot's 12 words through L2 only (`__ldcg`: words that
// other SMs wrote earlier in the launch are never read from a stale L1
// line); zero outside [0, cap).
__device__ __forceinline__ void gather(const Cols& st, int32_t slot, bool valid,
                                       int32_t (&g)[kCols]) {
#pragma unroll
  for (int c = 0; c < kCols; ++c) g[c] = valid ? __ldcg(st.p[c] + slot) : 0;
}

__device__ __forceinline__ void store(const Cols& st, int32_t slot, const int32_t (&w)[kCols]) {
#pragma unroll
  for (int c = 0; c < kCols; ++c) st.p[c][slot] = w[c];
}

// Where an update's new words go: the store policy of a lane.  The fused
// kernels (K1 and K4, fused_step.cu; K3, collapsed_step.cu; K12,
// sharded_step.cu) store them in the state at the slot (`ToState`); the
// split arm's compute kernels (K14 and K16, split_step.cu) write them to
// an int32 [12, W] words buffer at the lane, or at the segment's column,
// and leave the state alone (`ToWords`), and K15 scatters that buffer.
// A policy is called only for a slot in [0, cap).
struct ToState {
  __device__ __forceinline__ void put(const Cols& st, int32_t slot, int /*lane*/,
                                      const int32_t (&w)[kCols]) const {
    store(st, slot, w);
  }
};

struct ToWords {
  int32_t* __restrict__ words;  // [kCols, width]
  size_t width;
  __device__ __forceinline__ void put(const Cols& /*st*/, int32_t /*slot*/, int lane,
                                      const int32_t (&w)[kCols]) const {
#pragma unroll
    for (int c = 0; c < kCols; ++c) words[c * width + lane] = w[c];
  }
};

}  // namespace lane
