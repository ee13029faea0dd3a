// Native decision plane: the decision ledger's exact fast path in C.
//
// Port of gubernator_tpu/core/native/decision_plane.cpp.  Even a ledger
// hit on the h2 front's window path pays the C -> Python -> C round trip
// of the window callback and the interpreter lock.  This table holds the
// ledger's two exact answer forms, sticky over-limit and the closed-form
// drain of a credit lease (ops/bucket_kernel.py token_extras_host), next
// to the h2 server, so a hot-key RPC's whole life (frame -> decode ->
// probe -> drain -> encode) ends in the calling C thread, with no
// Python frame and no device launch.  The caller is a connection thread
// (threaded plane) or an epoll reactor (event front); dp_try_serve
// allocates nothing per thread and never blocks on anything but the
// plane's own mutex.
//
// Coherence protocol (core/ledger.py is the authority):
//   * Python GRANTS: on an engine-confirmed lease (or a sticky-OVER
//     insert) the ledger pushes the record down with dp_install_* and
//     marks its own entry delegated.
//   * Python PULLS: any Python-path touch of a delegated key (a plan's
//     fall-through, invalidation, TTL flush, eviction, close) calls
//     dp_pull, which atomically removes the record and returns the
//     drained count; the unused remainder rides back to the engine as
//     the usual negative-hit settle row.  A lease lives in exactly ONE
//     tier at a time, so a double drain cannot happen, and the pull
//     orders every native answer before the engine lane that follows.
//   * The plane only DECLINES outside its preconditions (non-token rows,
//     breaker behaviors, a config mismatch, expiry, exhaustion, unknown
//     keys): a decline falls to the Python window path unchanged.
//
// Clock: entries carry absolute ms deadlines in the ledger's clock
// domain; probes compare against CLOCK_REALTIME ms + an offset the
// Python side sets at attach and grant time.  Frozen clocks must not
// attach a plane (net/h2_fast.py allows only the live SYSTEM_CLOCK): a
// clock running AHEAD of realtime would let stale leases answer.  The
// test entries (dp_probe / dp_try_serve with now_ms >= 0) take an
// explicit clock.
//
// Plain C ABI, loaded with ctypes (core/native_plane.py); linked into the
// h2 server's library with wire_codec.cpp, whose wire_decode_reqs /
// wire_encode_resps(_hint) parse the body and write the response.

#include <atomic>
#include <chrono>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <string>
#include <unordered_map>
#include <vector>

// From wire_codec.cpp (same .so).
extern "C" int64_t wire_decode_reqs(
    const uint8_t* buf, int64_t len, int64_t max_items,
    int64_t disqualify_mask, uint8_t* key_buf, int64_t key_cap,
    int64_t* key_offsets, int32_t* algo, int32_t* behavior, int64_t* hits,
    int64_t* limit, int64_t* duration, int64_t* burst, uint64_t* fnv1,
    uint64_t* fnv1a, int32_t* name_lens);
extern "C" int64_t wire_encode_resps(
    const int32_t* status, const int64_t* limit, const int64_t* remaining,
    const int64_t* reset_time, int64_t n, uint8_t* out, int64_t out_cap);
extern "C" int64_t wire_encode_resps_hint(
    const int32_t* status, const int64_t* limit, const int64_t* remaining,
    const int64_t* reset_time, int64_t n, int32_t over_status,
    int64_t now_ms, uint8_t* out, int64_t out_cap);

namespace {

constexpr int kOver = 1, kLease = 2;

struct DpEntry {
  int kind = 0;
  int64_t limit = 0, duration = 0, reset = 0;
  // Lease state, mirroring core/ledger._Entry: `rem` is the logical
  // remaining at grant; answers report rem - consumed.
  int64_t rem = 0, credit = 0, consumed = 0, expiry = 0;
};

struct Plane {
  std::mutex mu;
  std::unordered_map<std::string, DpEntry> items;  // guarded by mu
  int64_t max_keys;
  // Ledger eligibility constants, injected from Python (types.py is the
  // source of truth; hardcoding them here would let the tiers drift).
  int64_t token_algo, breakers_mask, disqualify_mask;
  int32_t over_status, under_status;
  std::atomic<int64_t> clock_offset_ms{0};
  // retry_after_ms metadata on OVER answers (dp_set_hints).
  std::atomic<int64_t> hints{0};
  // Stats, guarded by mu (not atomics: the serve path already holds the
  // mutex, and with every counter write inside it the last action of
  // any thread touching the plane is a mutex release, which orders
  // teardown after all use).
  int64_t answered = 0;   // items answered natively
  int64_t rpcs = 0;       // whole RPCs answered
  int64_t declined = 0;   // RPC-level declines
  int64_t installs = 0, pulls = 0;
};

int64_t real_now_ms() {
  return std::chrono::duration_cast<std::chrono::milliseconds>(
             std::chrono::system_clock::now().time_since_epoch())
      .count();
}

// One item's probe against the table, staging (not committing) lease
// drains.  Returns true when the item is answerable; fills
// (status, remaining, reset).  `staged` maps entry → drain staged so
// far within this RPC, so duplicate keys see sequential credit.
bool probe_locked(Plane* p, const std::string& key, int32_t algo,
                  int32_t behavior, int64_t hits, int64_t limit,
                  int64_t duration, int64_t now,
                  std::vector<std::pair<DpEntry*, int64_t>>& staged,
                  int32_t* st, int64_t* rem_out, int64_t* rst) {
  const bool elig = algo == p->token_algo &&
                    (behavior & p->breakers_mask) == 0 && hits >= 0 &&
                    limit > 0;
  if (!elig) return false;
  auto it = p->items.find(key);
  if (it == p->items.end()) return false;
  DpEntry& e = it->second;
  if (now > e.reset || limit != e.limit || duration != e.duration)
    return false;
  if (e.kind == kOver) {
    *st = p->over_status;
    *rem_out = 0;
    *rst = e.reset;
    return true;
  }
  // LEASE (same case order as core/ledger.plan).
  if (now > e.expiry) return false;
  int64_t pending = 0;
  for (auto& s : staged)
    if (s.first == &e) pending += s.second;
  const int64_t consumed = e.consumed + pending;
  if (hits == 0) {
    *st = p->under_status;
    *rem_out = e.rem - consumed;
    *rst = e.reset;
    return true;
  }
  // token_extras_host(avail, hits, 1): admitted iff avail >= hits.
  if (e.credit - consumed < hits) return false;  // exhausted / over-ask
  staged.emplace_back(&e, hits);
  *st = p->under_status;
  *rem_out = e.rem - consumed - hits;
  *rst = e.reset;
  return true;
}

}  // namespace

extern "C" {

void* dp_create(int64_t max_keys, int64_t token_algo, int64_t breakers_mask,
                int64_t disqualify_mask, int32_t over_status,
                int32_t under_status) {
  auto* p = new Plane();
  p->max_keys = max_keys > 0 ? max_keys : 65536;
  p->token_algo = token_algo;
  p->breakers_mask = breakers_mask;
  p->disqualify_mask = disqualify_mask;
  p->over_status = over_status;
  p->under_status = under_status;
  return p;
}

void dp_free(void* handle) { delete static_cast<Plane*>(handle); }

void dp_set_clock_offset(void* handle, int64_t offset_ms) {
  static_cast<Plane*>(handle)->clock_offset_ms.store(offset_ms);
}

// Toggle retry_after_ms metadata on natively answered OVER items
// (reset_time-derived herd back-off; GUBER_RETRY_HINTS).
void dp_set_hints(void* handle, int64_t on) {
  static_cast<Plane*>(handle)->hints.store(on);
}

// Install a sticky over-limit record (exact until `reset` passes).
// Returns 1, or 0 when the table is full (the Python tier keeps it).
int64_t dp_install_over(void* handle, const uint8_t* key, int64_t klen,
                        int64_t limit, int64_t duration, int64_t reset) {
  auto* p = static_cast<Plane*>(handle);
  std::string k(reinterpret_cast<const char*>(key), klen);
  std::lock_guard<std::mutex> lock(p->mu);
  auto it = p->items.find(k);
  if (it == p->items.end() &&
      static_cast<int64_t>(p->items.size()) >= p->max_keys)
    return 0;
  DpEntry& e = (it == p->items.end()) ? p->items[std::move(k)] : it->second;
  e.kind = kOver;
  e.limit = limit;
  e.duration = duration;
  e.reset = reset;
  e.rem = e.credit = e.consumed = e.expiry = 0;
  ++p->installs;
  return 1;
}

// Delegate a lease: the plane becomes the ONLY drain point until
// dp_pull.  `consumed` carries drains already made on the Python tier
// (re-delegation after a mixed-path touch).
int64_t dp_install_lease(void* handle, const uint8_t* key, int64_t klen,
                         int64_t limit, int64_t duration, int64_t reset,
                         int64_t rem, int64_t credit, int64_t consumed,
                         int64_t expiry) {
  auto* p = static_cast<Plane*>(handle);
  std::string k(reinterpret_cast<const char*>(key), klen);
  std::lock_guard<std::mutex> lock(p->mu);
  auto it = p->items.find(k);
  if (it == p->items.end() &&
      static_cast<int64_t>(p->items.size()) >= p->max_keys)
    return 0;
  DpEntry& e = (it == p->items.end()) ? p->items[std::move(k)] : it->second;
  e.kind = kLease;
  e.limit = limit;
  e.duration = duration;
  e.reset = reset;
  e.rem = rem;
  e.credit = credit;
  e.consumed = consumed;
  e.expiry = expiry;
  ++p->installs;
  return 1;
}

// Atomically remove a record, returning its kind (0 = absent) and —
// for leases — out4 = {consumed, credit, rem, reset}.  Every native
// answer for the key happens-before the return (same mutex), so the
// caller's settle row reflects the exact drained count.
int64_t dp_pull(void* handle, const uint8_t* key, int64_t klen,
                int64_t* out4) {
  auto* p = static_cast<Plane*>(handle);
  std::string k(reinterpret_cast<const char*>(key), klen);
  std::lock_guard<std::mutex> lock(p->mu);
  auto it = p->items.find(k);
  if (it == p->items.end()) return 0;
  const DpEntry e = it->second;
  p->items.erase(it);
  ++p->pulls;
  if (out4) {
    out4[0] = e.consumed;
    out4[1] = e.credit;
    out4[2] = e.rem;
    out4[3] = e.reset;
  }
  return e.kind;
}

// Non-destructive read (read-only overlays / stats).
int64_t dp_peek(void* handle, const uint8_t* key, int64_t klen,
                int64_t* out4) {
  auto* p = static_cast<Plane*>(handle);
  std::string k(reinterpret_cast<const char*>(key), klen);
  std::lock_guard<std::mutex> lock(p->mu);
  auto it = p->items.find(k);
  if (it == p->items.end()) return 0;
  const DpEntry& e = it->second;
  if (out4) {
    out4[0] = e.consumed;
    out4[1] = e.credit;
    out4[2] = e.rem;
    out4[3] = e.reset;
  }
  return e.kind;
}

void dp_clear(void* handle) {
  auto* p = static_cast<Plane*>(handle);
  std::lock_guard<std::mutex> lock(p->mu);
  p->items.clear();
}

// Single-item probe with an explicit clock — the parity-fuzz entry.
// Commits the drain.  out3 = {status, remaining, reset}; returns 1
// answered / 0 declined.
int64_t dp_probe(void* handle, const uint8_t* key, int64_t klen,
                 int32_t algo, int32_t behavior, int64_t hits,
                 int64_t limit, int64_t duration, int64_t now_ms,
                 int64_t* out3) {
  auto* p = static_cast<Plane*>(handle);
  std::string k(reinterpret_cast<const char*>(key), klen);
  std::vector<std::pair<DpEntry*, int64_t>> staged;
  int32_t st = 0;
  int64_t rem = 0, rst = 0;
  std::lock_guard<std::mutex> lock(p->mu);
  if (!probe_locked(p, k, algo, behavior, hits, limit, duration, now_ms,
                    staged, &st, &rem, &rst))
    return 0;
  for (auto& s : staged) s.first->consumed += s.second;
  ++p->answered;
  out3[0] = st;
  out3[1] = rem;
  out3[2] = rst;
  return 1;
}

// Whole-RPC serve: decode a GetRateLimitsReq body, answer EVERY item
// from the table (all-or-nothing — a partial answer would need the
// Python merge path anyway), and assemble the GetRateLimitsResp bytes.
// Drains commit only when the whole RPC answers; a decline mutates
// nothing.  now_ms = -1 uses the plane clock (realtime + offset).
// Returns response byte count, or -1 to decline.
int64_t dp_try_serve(void* handle, const uint8_t* body, int64_t len,
                     int64_t max_items, int64_t now_ms, uint8_t* out,
                     int64_t out_cap) {
  auto* p = static_cast<Plane*>(handle);
  if (max_items <= 0 || max_items > 4096) {
    std::lock_guard<std::mutex> lock(p->mu);
    ++p->declined;
    return -1;
  }
  std::vector<uint8_t> key_buf(static_cast<size_t>(len) + max_items + 1);
  std::vector<int64_t> key_offsets(max_items + 1);
  std::vector<int32_t> algo(max_items), behavior(max_items),
      name_lens(max_items), status(max_items);
  std::vector<int64_t> hits(max_items), limit(max_items),
      duration(max_items), burst(max_items), remaining(max_items),
      reset(max_items);
  std::vector<uint64_t> fnv1(max_items), fnv1a(max_items);
  const int64_t n = wire_decode_reqs(
      body, len, max_items, p->disqualify_mask, key_buf.data(),
      static_cast<int64_t>(key_buf.size()), key_offsets.data(), algo.data(),
      behavior.data(), hits.data(), limit.data(), duration.data(),
      burst.data(), fnv1.data(), fnv1a.data(), name_lens.data());
  if (n <= 0) {  // malformed / out-of-scope / empty: Python's call
    std::lock_guard<std::mutex> lock(p->mu);
    ++p->declined;
    return -1;
  }
  const int64_t now =
      now_ms >= 0 ? now_ms : real_now_ms() + p->clock_offset_ms.load();
  int64_t written;
  {
    std::vector<std::pair<DpEntry*, int64_t>> staged;
    std::lock_guard<std::mutex> lock(p->mu);
    for (int64_t i = 0; i < n; ++i) {
      std::string key(
          reinterpret_cast<const char*>(key_buf.data()) + key_offsets[i],
          static_cast<size_t>(key_offsets[i + 1] - key_offsets[i]));
      int32_t st = 0;
      int64_t rem = 0, rst = 0;
      if (!probe_locked(p, key, algo[i], behavior[i], hits[i], limit[i],
                        duration[i], now, staged, &st, &rem, &rst)) {
        ++p->declined;
        return -1;  // nothing committed
      }
      status[i] = st;
      remaining[i] = rem;
      reset[i] = rst;
    }
    // Encode BEFORE committing: a decline (even out_cap too small,
    // which sized callers never hit) must leave the table untouched —
    // the Python path re-serves the same rows, and a committed drain
    // here would double-count them.
    written = p->hints.load()
                  ? wire_encode_resps_hint(status.data(), limit.data(),
                                           remaining.data(), reset.data(),
                                           n, p->over_status, now, out,
                                           out_cap)
                  : wire_encode_resps(status.data(), limit.data(),
                                      remaining.data(), reset.data(), n,
                                      out, out_cap);
    if (written < 0) {
      ++p->declined;
      return -1;
    }
    for (auto& s : staged) s.first->consumed += s.second;
    p->answered += n;
    ++p->rpcs;
  }
  return written;
}

void dp_stats(void* handle, int64_t* out8) {
  auto* p = static_cast<Plane*>(handle);
  std::lock_guard<std::mutex> lock(p->mu);
  out8[0] = p->answered;
  out8[1] = p->rpcs;
  out8[2] = p->declined;
  out8[3] = static_cast<int64_t>(p->items.size());
  out8[4] = p->installs;
  out8[5] = p->pulls;
  out8[6] = 0;
  out8[7] = 0;
}

}  // extern "C"
