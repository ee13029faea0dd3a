// The port's wire codec: GetRateLimitsReq bytes -> engine-ready columns,
// and decision columns -> GetRateLimitsResp bytes.
//
// A copy of the two functions of gubernator_tpu/core/native/wire_codec.cpp
// that the h2 front's byte-window path calls, with their helpers:
// `wire_decode_reqs` (reference :105) and `wire_encode_resps` (:228).
// The hint, owner, peer-request and globals encoders/decoders wait for
// the planes that call them (ROADMAP A items 5 and 11).  The decode's
// key bytes ("name_unique-key") and its FNV-1 / FNV-1a columns are
// bit-equal to the reference's (tests/test_torch_wire_codec.py).
//
// Hand-rolled proto3 for exactly these schemas (the reference's
// proto/gubernator.proto):
//
//   GetRateLimitsReq  { repeated RateLimitReq requests = 1; }
//   RateLimitReq      { string name = 1; string unique_key = 2;
//                       int64 hits = 3; int64 limit = 4;
//                       int64 duration = 5; Algorithm algorithm = 6;
//                       Behavior behavior = 7; int64 burst = 8; }
//   GetRateLimitsResp { repeated RateLimitResp responses = 1; }
//   RateLimitResp     { Status status = 1; int64 limit = 2;
//                       int64 remaining = 3; int64 reset_time = 4; }
//
// Unknown fields are skipped per proto rules.  Anything the columnar
// path cannot serve (disqualifying behavior bits, empty name or
// unique_key, more items than the caller allows) makes the decoder
// return a negative sentinel; it never guesses.
//
// Plain C ABI, loaded with ctypes (gubernator_tpu_torch/net/wire_codec.py);
// built by ops/native_build.py both as its own library and inside the
// h2 server's.

#include <cstdint>
#include <cstring>

namespace {

constexpr uint64_t kFnvOffset = 14695981039346656037ULL;
constexpr uint64_t kFnvPrime = 1099511628211ULL;

struct Cursor {
  const uint8_t* p;
  const uint8_t* end;
  bool ok = true;

  uint64_t varint() {
    uint64_t v = 0;
    int shift = 0;
    while (p < end && shift < 64) {
      uint8_t b = *p++;
      v |= (uint64_t)(b & 0x7F) << shift;
      if (!(b & 0x80)) return v;
      shift += 7;
    }
    ok = false;
    return 0;
  }

  bool skip(uint32_t wire_type) {
    switch (wire_type) {
      case 0:  // varint
        varint();
        return ok;
      case 1:  // fixed64
        if (end - p < 8) return ok = false;
        p += 8;
        return true;
      case 2: {  // length-delimited
        uint64_t len = varint();
        if (!ok || (uint64_t)(end - p) < len) return ok = false;
        p += len;
        return true;
      }
      case 5:  // fixed32
        if (end - p < 4) return ok = false;
        p += 4;
        return true;
      default:  // groups / reserved
        return ok = false;
    }
  }
};

}  // namespace

extern "C" {

// Decode one GetRateLimitsReq / GetPeerRateLimitsReq payload.
//
// Outputs (caller-allocated, capacity max_items):
//   key_buf[key_cap]        concatenated "name_unique-key" bytes
//   key_offsets[max+1]      per-item [start, end) into key_buf
//   algo/behavior int32, hits/limit/duration/burst int64
//   fnv1/fnv1a uint64       per-key ring hashes
//
// Returns item count n >= 0, or:
//   -1 malformed protobuf    -2 more than max_items items
//   -3 key_buf overflow      -4 item needs the slow path
//      (disqualifying behavior bits or empty name/unique_key)
// guberlint: gil-free
// guberlint: wire GetRateLimitsReq requests=1:len
// guberlint: wire RateLimitReq name=1:len unique_key=2:len hits=3:varint limit=4:varint duration=5:varint algorithm=6:varint behavior=7:varint burst=8:varint
int64_t wire_decode_reqs(const uint8_t* buf, int64_t len,
                         int64_t max_items, int64_t disqualify_mask,
                         uint8_t* key_buf, int64_t key_cap,
                         int64_t* key_offsets, int32_t* algo,
                         int32_t* behavior, int64_t* hits, int64_t* limit,
                         int64_t* duration, int64_t* burst,
                         uint64_t* fnv1, uint64_t* fnv1a,
                         int32_t* name_lens) {
  Cursor c{buf, buf + len};
  int64_t n = 0;
  int64_t koff = 0;
  key_offsets[0] = 0;
  while (c.p < c.end) {
    uint64_t tag = c.varint();
    if (!c.ok) return -1;
    if ((tag >> 3) != 1 || (tag & 7) != 2) {  // not `requests`
      if (!c.skip(tag & 7)) return -1;
      continue;
    }
    uint64_t mlen = c.varint();
    if (!c.ok || (uint64_t)(c.end - c.p) < mlen) return -1;
    if (n >= max_items) return -2;
    Cursor m{c.p, c.p + mlen};
    c.p += mlen;

    const uint8_t* name = nullptr;
    uint64_t name_len = 0;
    const uint8_t* ukey = nullptr;
    uint64_t ukey_len = 0;
    int64_t f_hits = 0, f_limit = 0, f_duration = 0, f_burst = 0;
    int64_t f_algo = 0, f_behavior = 0;
    while (m.p < m.end) {
      uint64_t t = m.varint();
      if (!m.ok) return -1;
      uint32_t field = (uint32_t)(t >> 3);
      uint32_t wt = (uint32_t)(t & 7);
      if ((field == 1 || field == 2) && wt == 2) {
        uint64_t slen = m.varint();
        if (!m.ok || (uint64_t)(m.end - m.p) < slen) return -1;
        if (field == 1) {
          name = m.p;
          name_len = slen;
        } else {
          ukey = m.p;
          ukey_len = slen;
        }
        m.p += slen;
      } else if (field >= 3 && field <= 8 && wt == 0) {
        int64_t v = (int64_t)m.varint();
        if (!m.ok) return -1;
        switch (field) {
          case 3: f_hits = v; break;
          case 4: f_limit = v; break;
          case 5: f_duration = v; break;
          case 6: f_algo = v; break;
          case 7: f_behavior = v; break;
          case 8: f_burst = v; break;
        }
      } else {
        if (!m.skip(wt)) return -1;
      }
    }
    if (name_len == 0 || ukey_len == 0) return -4;
    if (f_behavior & disqualify_mask) return -4;
    int64_t klen = (int64_t)name_len + 1 + (int64_t)ukey_len;
    if (koff + klen > key_cap) return -3;
    std::memcpy(key_buf + koff, name, name_len);
    key_buf[koff + name_len] = '_';
    std::memcpy(key_buf + koff + name_len + 1, ukey, ukey_len);
    // Ring hashes over the canonical key, in the same pass.
    uint64_t h1 = kFnvOffset, h1a = kFnvOffset;
    for (int64_t i = 0; i < klen; ++i) {
      uint8_t b = key_buf[koff + i];
      h1 = (h1 * kFnvPrime) ^ b;   // FNV-1: multiply then xor
      h1a = (h1a ^ b) * kFnvPrime; // FNV-1a: xor then multiply
    }
    koff += klen;
    key_offsets[n + 1] = koff;
    // The joined key is name + '_' + unique_key; name_lens lets
    // forwarding paths split it back exactly (names may contain '_').
    name_lens[n] = (int32_t)name_len;
    algo[n] = (int32_t)f_algo;
    behavior[n] = (int32_t)f_behavior;
    hits[n] = f_hits;
    limit[n] = f_limit;
    duration[n] = f_duration;
    burst[n] = f_burst;
    fnv1[n] = h1;
    fnv1a[n] = h1a;
    ++n;
  }
  return n;
}

namespace {

inline uint8_t* put_varint(uint8_t* p, uint64_t v) {
  while (v >= 0x80) {
    *p++ = (uint8_t)(v | 0x80);
    v >>= 7;
  }
  *p++ = (uint8_t)v;
  return p;
}

inline int varint_size(uint64_t v) {
  int s = 1;
  while (v >= 0x80) {
    v >>= 7;
    ++s;
  }
  return s;
}

}  // namespace

// Assemble GetRateLimitsResp / GetPeerRateLimitsResp bytes from
// columns.  Proto3 semantics: zero-valued fields are omitted.  The
// caller provides `out` of capacity out_cap; returns bytes written or
// -1 if out_cap is too small.
// guberlint: gil-free
// guberlint: wire GetRateLimitsResp responses=1:len
// guberlint: wire RateLimitResp status=1:varint limit=2:varint remaining=3:varint reset_time=4:varint
int64_t wire_encode_resps(const int32_t* status, const int64_t* limit,
                          const int64_t* remaining, const int64_t* reset_time,
                          int64_t n, uint8_t* out, int64_t out_cap) {
  uint8_t* p = out;
  uint8_t* end = out + out_cap;
  for (int64_t i = 0; i < n; ++i) {
    // Field sizes first (each message is length-prefixed).
    int msize = 0;
    uint64_t st = (uint64_t)(uint32_t)status[i];
    if (st) msize += 1 + varint_size(st);
    if (limit[i]) msize += 1 + varint_size((uint64_t)limit[i]);
    if (remaining[i]) msize += 1 + varint_size((uint64_t)remaining[i]);
    if (reset_time[i]) msize += 1 + varint_size((uint64_t)reset_time[i]);
    if (end - p < 2 + varint_size(msize) + msize) return -1;
    *p++ = (1 << 3) | 2;  // responses/rate_limits = 1, len-delimited
    p = put_varint(p, (uint64_t)msize);
    if (st) {
      *p++ = (1 << 3) | 0;
      p = put_varint(p, st);
    }
    if (limit[i]) {
      *p++ = (2 << 3) | 0;
      p = put_varint(p, (uint64_t)limit[i]);
    }
    if (remaining[i]) {
      *p++ = (3 << 3) | 0;
      p = put_varint(p, (uint64_t)remaining[i]);
    }
    if (reset_time[i]) {
      *p++ = (4 << 3) | 0;
      p = put_varint(p, (uint64_t)reset_time[i]);
    }
  }
  return p - out;
}

}  // extern "C"
