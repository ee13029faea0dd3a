// The general packed format's lane, K1's (fused_step.cu
// `rounds_kernel<General>`): one lane's request read, the slot's 12 words
// gathered, the bucket updated (csrc/lane_math.cuh), the new words stored
// where the slot is in range, and the lane's answer returned.  Two
// policies make the one source serve three kernels:
//  * the input policy says where the request comes from: the lane's
//    column of pin rows 1-15 (`FromPin`: K1, and K14 in split_step.cu
//    `packed_compute_kernel`), or the `BatchInput` columns of the
//    dataclass step (`FromBatch`: K17, apply_batch.cu);
//  * the store policy `out` (csrc/lane_math.cuh) says where the words go:
//    the state at the slot (K1, K17), or a words buffer at the lane (K14).
// `General::step` is the pin format's lane: `FromPin`, then the 5 pout
// words.  K11 (sharded_step.cu `shard_lane`) reads the round header with
// `General::header` and runs the same steps in its own order.

#pragma once

#include <cstdint>

#include "lane_math.cuh"

namespace lane {

// Input policy of the packed format: the lane's column of pin rows 1-15,
// `stride` words apart (a shared-memory tile in K1, the pin itself in
// K14).
struct FromPin {
  const int32_t* req;
  int stride;
  __device__ __forceinline__ int32_t row(int r) const { return req[(r - 1) * stride]; }
  __device__ __forceinline__ int32_t slot() const { return row(1); }
  __device__ __forceinline__ Req request() const {
    auto row64 = [&](int hr, int lr) { return combine(row(hr), row(lr)); };
    return Req{row(2), row(3), row64(4, 5), row64(6, 7),
               row64(8, 9), row64(10, 11), row64(12, 13), row64(14, 15)};
  }
};

// The dataclass step's request columns (the reference's `BatchInput`,
// gubernator_tpu/ops/bucket_kernel.py:98), [B] each.
struct BatchCols {
  const int32_t* slot;
  const int32_t* algo;
  const int32_t* behavior;
  const int64_t* hits;
  const int64_t* limit;
  const int64_t* duration;
  const int64_t* burst;
  const int64_t* greg_duration;
  const int64_t* greg_expire;
};

// Input policy of the dataclass step (K17): lane `lane` of the columns.
struct FromBatch {
  BatchCols b;
  int lane;
  __device__ __forceinline__ int32_t slot() const { return __ldg(b.slot + lane); }
  __device__ __forceinline__ Req request() const {
    return Req{__ldg(b.algo + lane), __ldg(b.behavior + lane), __ldg(b.hits + lane),
               __ldg(b.limit + lane), __ldg(b.duration + lane), __ldg(b.burst + lane),
               __ldg(b.greg_duration + lane), __ldg(b.greg_expire + lane)};
  }
};

// The general format (K1): pin int32 [16, L], one lane's request in rows
// 1-15; the round header is `now` in row 0 of the round's first two
// lanes; pout int32 [5, L].
struct General {
  static constexpr int kReqRows = 15;  // pin rows 1-15: the slot and the request fields
  struct Header {
    int64_t now;
  };
  static __device__ __forceinline__ Header header(const int32_t* __restrict__ pin, int lo) {
    return {combine(__ldg(pin + lo), __ldg(pin + lo + 1))};
  }
  // One lane at `now`: its request from `in`, its words to `out_words`
  // where the slot is in range; returns the answer.
  template <class In, class Out>
  static __device__ __forceinline__ Resp update(const Cols& st, long long cap, int64_t now,
                                                const In& in, int lane, const Out& out_words) {
    const int32_t slot = in.slot();
    const bool valid = slot >= 0 && (long long)slot < cap;
    int32_t g[kCols];
    gather(st, slot, valid, g);
    const Req q = in.request();
    Vals v;
    Resp out;
    int64_t lk_rate_i;
    update_lane(g, valid, q, now, v, out, lk_rate_i);
    if (valid) {
      int32_t words[kCols];
      encode_vals(v, words);
      out_words.put(st, slot, lane, words);
    }
    return out;
  }
  // The pin format's lane: `req` is the lane's column of pin rows 1-15,
  // `stride` words apart; the answer goes to pout's 5 rows at `lane`.
  template <class Out = ToState>
  static __device__ __forceinline__ void step(const Cols& st, long long cap, const Header& h,
                                              const int32_t* req, int stride, int lane,
                                              int32_t* __restrict__ pout, size_t w,
                                              const Out& out_words = Out{}) {
    const Resp out = update(st, cap, h.now, FromPin{req, stride}, lane, out_words);
    pout[lane] = out.status;
    pout[w + lane] = hi_word(out.rem);
    pout[2 * w + lane] = lo_word(out.rem);
    pout[3 * w + lane] = hi_word(out.reset);
    pout[4 * w + lane] = lo_word(out.reset);
  }
};

}  // namespace lane
