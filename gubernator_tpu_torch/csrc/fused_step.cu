// K1: the fused bucket decision step for Hopper (sm_90a), all of a
// batch's rounds in one cooperative launch.
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
// Input.  pin int32 [16, L] holds the R rounds one after another along
// the lanes; round r owns lanes [round_off[r], round_off[r+1]), sorted by
// slot, each slot at most once; the `now` header is row 0, lanes 0-1.
// Clears come in CSR form: round r's are clear_slots[clear_off[r] ..
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
//    next round) -- the 15 request rows, slot first -- into a
//    double-buffered shared-memory tile with `cp.async` (4 B a thread a
//    row: a warp moves one aligned 128 B line a row, since rounds are
//    padded to 32 lanes).  Each thread reads only its own column of the
//    tile, so the copy needs a per-thread `cp.async.wait_group` and no
//    block barrier.  After grid.sync() the lane's slot is in shared memory
//    and its 12 state gathers issue at once.
//  * State gathers go through L2 only (`__ldcg`): words written by other
//    SMs in an earlier round are never read from a stale L1 line.
// The lane math is the reference's branch-free select chain, transcribed
// term for term: every path is computed and the lane's path picks, so
// padding lanes (zero words, zero request) compute exactly what the
// reference computes for them, write pout, and store nothing.
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
// Bound.  Per lane the step must move 60 B of pin (rows 1-15) and 20 B of
// pout, and per in-range lane 48 B of state read and 48 B written; plus
// the 8 B `now` header once and 12 B per in-range clear (slot, meta read,
// meta written).  A 1000-lane round is about 176 KB, ~53 ns at 3.35 TB/s.
// The random 4 B state accesses touch a 32 B sector per column (768 B a
// lane of real traffic), and each round adds a grid barrier.

#include <atomic>
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kCols = 12;
constexpr int kReqRows = 15;  // pin rows 1-15: slot and the request fields
constexpr int kThreads = 64;  // threads per block (T)
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

// One lane of one round: `req` is the lane's column of the request tile
// (pin rows 1-15, `stride` words apart); writes the lane's pout words and,
// for an in-range slot, its 12 state words.
__device__ __forceinline__ void step_lane(const Cols& st, long long cap, int64_t now,
                                          const int32_t* req, int stride, int lane,
                                          int32_t* __restrict__ pout, size_t w) {
  auto row = [&](int r) { return req[(r - 1) * stride]; };
  auto row64 = [&](int hr, int lr) { return combine(row(hr), row(lr)); };

  const int32_t slot = row(1);
  const bool valid = slot >= 0 && (long long)slot < cap;

  // ---- gather (fill 0 outside [0, cap)), through L2 only
  int32_t g[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) g[c] = valid ? __ldcg(st.p[c] + slot) : 0;

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

// The lanes [lo, hi) of round r that one block handles in one pass.
struct Chunk {
  int r, lo, hi;
};

__global__ void __launch_bounds__(kThreads)
multi_fused_step_kernel(Cols st, long long cap, const int32_t* __restrict__ pin, int width,
                        const int32_t* __restrict__ round_off, int n_rounds,
                        const int32_t* __restrict__ clear_off,
                        const int32_t* __restrict__ clear_slots, int n_clear,
                        int32_t* __restrict__ pout) {
  constexpr int T = kThreads;
  __shared__ int32_t tile[2][kReqRows][T];
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
  // Copy this thread's lane of chunk c (rows 1-15) into tile[buf].
  auto prefetch = [&](const Chunk& c, int buf) {
    const int lane = c.lo + tid;
    if (c.r < n_rounds && lane < c.hi) {
#pragma unroll
      for (int k = 0; k < kReqRows; ++k)
        cp_async4(&tile[buf][k][tid], pin + (size_t)(k + 1) * w + lane);
    }
    cp_async_commit();
  };

  // The header and the first offsets load together, ahead of the copies;
  // each later round's clear bound loads before the barrier it follows.
  const int64_t now = combine(__ldg(pin), __ldg(pin + 1));
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
    while (cur.r == r) {
      const Chunk nxt = next_of(cur);
      prefetch(nxt, buf ^ 1);
      cp_async_wait_prior();  // this thread's copy of `cur` has landed
      const int lane = cur.lo + tid;
      if (lane < cur.hi) step_lane(st, cap, now, &tile[buf][0][tid], T, lane, pout, w);
      cur = nxt;
      buf ^= 1;
    }
    if (r + 1 < n_rounds) {
      c_lo = c_hi;
      c_hi = coff(r + 2);
      grid.sync();
    }
  }
  cp_async_wait_all();
}

// Blocks of K1 that fit on device `dev` at once, read once per device
// (0: not read yet); cooperative launch support is checked with it.
std::atomic<int> g_resident[64];

cudaError_t resident_blocks(int* out) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  int n = g_resident[dev].load(std::memory_order_relaxed);
  if (n == 0) {
    int coop = 0, sms = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    if (e != cudaSuccess) return e;
    if (!coop) return cudaErrorNotSupported;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, multi_fused_step_kernel,
                                                        kThreads, 0);
    if (e != cudaSuccess) return e;
    n = per_sm * sms;
    if (n < 1) return cudaErrorCooperativeLaunchTooLarge;
    g_resident[dev].store(n, std::memory_order_relaxed);
  }
  *out = n;
  return cudaSuccess;
}

}  // namespace

// cols: 12 device pointers in BucketState field order; pin int32
// [16, width]; round_off / clear_off int32 [n_rounds + 1]; clear_slots int32
// [n_clear]; pout int32 [5, width]; widest: the widest round's lanes;
// stream: a cudaStream_t.  The grid is min(ceil(widest / T), co-resident
// blocks), at least 1.
// Returns 0 once the cooperative kernel is launched, else the cudaError
// (a refused launch is not retried in another form).
extern "C" int guber_multi_fused_step(void* const* cols, long long cap, const void* pin,
                                      int width, const void* round_off, int n_rounds,
                                      const void* clear_off, const void* clear_slots,
                                      int n_clear, void* pout, int widest, void* stream) {
  if (width < 1 || n_rounds < 1) return static_cast<int>(cudaErrorInvalidValue);
  int resident = 0;
  cudaError_t e = resident_blocks(&resident);
  if (e != cudaSuccess) return static_cast<int>(e);
  int grid = (widest + kThreads - 1) / kThreads;
  if (grid > resident) grid = resident;
  if (grid < 1) grid = 1;
  Cols c;
  for (int i = 0; i < kCols; ++i) c.p[i] = static_cast<int32_t*>(cols[i]);
  void* args[] = {&c, &cap, &pin, &width, &round_off, &n_rounds,
                  &clear_off, &clear_slots, &n_clear, &pout};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(&multi_fused_step_kernel),
                                  dim3(grid), dim3(kThreads), args, 0,
                                  static_cast<cudaStream_t>(stream));
  if (e == cudaSuccess) e = cudaGetLastError();
  return static_cast<int>(e);
}
