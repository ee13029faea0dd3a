// The general packed format's lane, K1's (fused_step.cu
// `rounds_kernel<General>`): one lane's request read from its pin column,
// the slot's 12 words gathered, the bucket updated (csrc/lane_math.cuh),
// the new words stored where the slot is in range, and the lane's 5
// pout words written.  Where the words go is the store policy `out`
// (csrc/lane_math.cuh): the state at the slot for K1, a words buffer at
// the lane for K14 (split_step.cu `packed_compute_kernel`), so both
// compute from this one source.  K11 (sharded_step.cu `shard_lane`) reads
// the round header with `General::header` and runs the same steps in its
// own order.

#pragma once

#include <cstdint>

#include "lane_math.cuh"

namespace lane {

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
  // `req` is the lane's column of pin rows 1-15, `stride` words apart (a
  // shared-memory tile in K1, the pin itself in K14).
  template <class Out = ToState>
  static __device__ __forceinline__ void step(const Cols& st, long long cap, const Header& h,
                                              const int32_t* req, int stride, int lane,
                                              int32_t* __restrict__ pout, size_t w,
                                              const Out& out_words = Out{}) {
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
      out_words.put(st, slot, lane, words);
    }
    pout[lane] = out.status;
    pout[w + lane] = hi_word(out.rem);
    pout[2 * w + lane] = lo_word(out.rem);
    pout[3 * w + lane] = hi_word(out.reset);
    pout[4 * w + lane] = lo_word(out.reset);
  }
};

}  // namespace lane
