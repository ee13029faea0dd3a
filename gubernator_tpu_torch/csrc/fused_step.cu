// K1: the fused bucket decision step for Hopper (sm_90a).
//
// Replaces gubernator_tpu/ops/pallas_step.py:67 `_fused_kernel` (the
// Pallas kernel, reached through `pallas_fused_step` :158), whose XLA
// twin is gubernator_tpu/ops/bucket_kernel.py:1044 `_fused_step_core`.
// One launch runs a whole packed round: per lane, gather the slot's 12
// state words (zero when the slot is outside [0, cap)), run the token /
// leaky update (`update_lanes` :514), encode the new words
// (`encode_slot_values` :781), store them in place where the slot is in
// range, and emit the [5, W] status / remaining / reset words.  The
// plain PyTorch version is gubernator_tpu_torch/ops/bucket_kernel.py
// `fused_step_reference`; the two are bit-equal.
//
// Design.  One thread per lane, ceil(W / 128) blocks.  The host's rounds
// put each slot in a round at most once, so a lane's read-modify-write of
// its 12 words races with no other lane and no sort is needed on the
// device.  The lane math is the reference's branch-free select chain,
// transcribed term for term: every path is computed and the lane's path
// picks, so padding lanes (zero words, zero request) compute exactly
// what the reference computes for them.
//
// Exactness against the reference (XLA:CPU):
//  * f64 division is IEEE `/`; built with -fmad=false, so no multiply-add
//    is contracted.
//  * f64 -> int conversions use __double2ll_rz / __double2int_rz /
//    __double2uint_rz: truncate toward zero, saturate, NaN -> 0, which is
//    what XLA:CPU does (a plain C++ cast is undefined out of range).
//  * int64 arithmetic that may overflow (now + duration, the reset
//    products) runs in uint64_t and is cast back: two's complement wrap,
//    as in the reference.
//
// Bound.  Per lane the step must move 60 B of pin (rows 1-15; row 0 is
// only the 8 B `now` header), 48 B of state read, 48 B of state written
// and 20 B of pout: 176 B, about 176 KB for a W = 1000 round, about 53 ns
// at 3.35 TB/s.  At serving widths the launch itself
// (a few microseconds) is the cost; the random 4 B state accesses also
// touch a 32 B sector per column (768 B/lane of real traffic).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kCols = 12;
constexpr int kThreads = 128;
constexpr int64_t kTsClampMax = (int64_t(1) << 43) - 1;
constexpr int32_t kHi11 = 0x7FF;
constexpr int32_t kOver = 1;
constexpr int32_t kUnder = 0;
constexpr int32_t kGreg = 4;    // Behavior.DURATION_IS_GREGORIAN
constexpr int32_t kReset = 8;   // Behavior.RESET_REMAINING

struct Cols {
  int32_t* p[kCols];  // BucketState field order
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

__global__ void __launch_bounds__(kThreads)
fused_step_kernel(Cols st, long long cap, const int32_t* __restrict__ pin,
                  int32_t* __restrict__ pout, int width) {
  const int lane = blockIdx.x * kThreads + threadIdx.x;
  if (lane >= width) return;
  const size_t w = (size_t)width;
  auto row = [&](int r) { return __ldg(pin + (size_t)r * w + lane); };
  auto row64 = [&](int hr, int lr) { return combine(row(hr), row(lr)); };

  // `now` is header data: row 0, lanes 0-1.
  const int64_t now = combine(__ldg(pin), __ldg(pin + 1));
  const int32_t slot = row(1);
  const bool valid = slot >= 0 && (long long)slot < cap;

  // ---- gather (fill 0 outside [0, cap))
  int32_t g[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) g[c] = valid ? st.p[c][slot] : 0;

  const int32_t r_algo = row(2) != 0 ? 1 : 0;
  const int32_t r_beh = row(3);
  const int64_t r_hits = row64(4, 5);
  const int64_t r_limit = row64(6, 7);
  const int64_t r_dur = row64(8, 9);
  const int64_t r_burst = row64(10, 11);
  const int64_t r_gdur = row64(12, 13);
  const int64_t r_gexp = row64(14, 15);

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
    const int64_t v = add64(s_rem, sub64(r_limit, s_limit));
    te_rem0 = v > 0 ? v : 0;
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

  // ---- the lane's path picks responses and stored values (the
  // reference's `pick`; exactly one path holds).
  int32_t resp_status, n_status;
  int64_t resp_rem, resp_reset, n_rem, n_dur, n_t0, n_exp, n_burst;
  double n_rem_f;
  if (p_tok_reset) {
    resp_status = kUnder; resp_rem = r_limit; resp_reset = 0;
    n_rem = 0; n_rem_f = 0.0; n_dur = r_dur; n_t0 = 0; n_exp = 0; n_burst = 0;
    n_status = kUnder;
  } else if (p_tok_ex) {
    resp_status = te_resp_status; resp_rem = te_resp_rem; resp_reset = te_exp;
    n_rem = te_rem_out; n_rem_f = 0.0; n_dur = r_dur; n_t0 = te_created;
    n_exp = te_exp; n_burst = 0; n_status = te_status_store;
  } else if (p_tok_new) {
    resp_status = tn_resp_status; resp_rem = tn_rem; resp_reset = tn_exp;
    n_rem = tn_rem; n_rem_f = 0.0; n_dur = r_dur; n_t0 = now; n_exp = tn_exp;
    n_burst = 0; n_status = kUnder;
  } else if (p_leak_ex) {
    resp_status = le_resp_status; resp_rem = le_resp_rem; resp_reset = le_reset;
    n_rem = 0; n_rem_f = le_rem_out; n_dur = r_dur; n_t0 = le_t0; n_exp = le_exp;
    n_burst = burst_eff; n_status = kUnder;
  } else {  // leaky, new item (stores the Gregorian remainder as duration)
    resp_status = ln_resp_status; resp_rem = ln_resp_rem; resp_reset = ln_reset;
    n_rem = 0; n_rem_f = ln_rem_f; n_dur = ln_dur; n_t0 = now;
    n_exp = add64(now, ln_dur); n_burst = burst_eff; n_status = kUnder;
  }

  // ---- encode and store (an update always clears invalid_at)
  if (valid) {
    const int64_t t0c = clamp_ts(n_t0);
    const int64_t expc = clamp_ts(n_exp);
    const int64_t durc = clamp_ts(n_dur);
    int32_t words[kCols];
    words[kMeta] = (p_tok_reset ? 0 : 1) | (r_algo << 1) | ((n_status & 3) << 2) |
                   (hi_word(t0c) << 4);
    words[kHi2] = hi_word(expc) | (hi_word(durc) << 11);
    words[kT0Lo] = lo_word(t0c);
    words[kExpireLo] = lo_word(expc);
    words[kInvalidLo] = 0;
    words[kDurationLo] = lo_word(durc);
    words[kLimitHi] = hi_word(r_limit);
    words[kLimitLo] = lo_word(r_limit);
    if (r_algo == 1) {  // leaky: 32.32 fixed point, floor quantization
      const double fl = floor(n_rem_f);
      words[kRemHi] = __double2int_rz(fl);  // == clip to int32, then convert
      words[kRemLo] = (int32_t)__double2uint_rz((n_rem_f - fl) * 0x1p32);
    } else {
      words[kRemHi] = hi_word(n_rem);
      words[kRemLo] = lo_word(n_rem);
    }
    words[kBurstHi] = hi_word(n_burst);
    words[kBurstLo] = lo_word(n_burst);
#pragma unroll
    for (int c = 0; c < kCols; ++c) st.p[c][slot] = words[c];
  }

  pout[lane] = resp_status;
  pout[w + lane] = hi_word(resp_rem);
  pout[2 * w + lane] = lo_word(resp_rem);
  pout[3 * w + lane] = hi_word(resp_reset);
  pout[4 * w + lane] = lo_word(resp_reset);
}

}  // namespace

// cols: 12 device pointers in BucketState field order; pin int32
// [16, width]; pout int32 [5, width]; stream: a cudaStream_t.  Returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int guber_fused_step(void* const* cols, long long cap, const void* pin,
                                void* pout, int width, void* stream) {
  Cols c;
  for (int i = 0; i < kCols; ++i) c.p[i] = static_cast<int32_t*>(cols[i]);
  const int blocks = (width + kThreads - 1) / kThreads;
  fused_step_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      c, cap, static_cast<const int32_t*>(pin), static_cast<int32_t*>(pout), width);
  return static_cast<int>(cudaGetLastError());
}
