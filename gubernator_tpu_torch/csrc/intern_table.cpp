// Native interning and round-scheduling table of the port.
//
// The port's own copy of gubernator_tpu/core/native/intern_table.cpp
// (the JAX package's table), cut to what the single-node engine calls:
// git_new / git_free / git_len, git_schedule_idx, git_set_expiry,
// git_remove, git_release, git_key_for_slot and git_contains, with the
// hit / miss / eviction statistics, and git_multi_schedule, the sharded
// engine's whole host tier in one call (parallel/sharded_engine.py).
//
// It maps a batch of key strings to dense device-slot indices (LRU
// eviction, TTL bookkeeping) and assigns each request its serialization
// round: the k-th occurrence of a slot within the batch goes to round k,
// so each device round updates a slot at most once.  An evicted slot's
// clear is scheduled at the slot's current round (after the evicted
// key's last request, before the reusing key's first).
//
// Design: open-addressing hash table (linear probing, tombstones,
// fnv1a-64) sized 2*capacity rounded up to a power of two; key bytes
// owned per slot; LRU as intrusive prev/next arrays over slots; per-
// batch round counters use epoch stamping, so no O(capacity) clearing
// per call.  A table is single-threaded by design: the engine serializes
// batches under its lock (git_multi_schedule gives each table to one
// thread).  The Python InternTable (core/interning.py) is the
// plain version; the two agree on slots, rounds, evictions and
// statistics (tests/test_torch_native_table.py).
//
// C ABI only (loaded through ctypes); built with g++ -O2 -shared -fPIC
// by ops/native_build.py.

#include <algorithm>
#include <array>
#include <cstdint>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

constexpr uint64_t kFnvOffset = 0xCBF29CE484222325ull;
constexpr uint64_t kFnvPrime = 0x100000001B3ull;

inline uint64_t fnv1a(const uint8_t* data, int64_t len) {
  uint64_t h = kFnvOffset;
  for (int64_t i = 0; i < len; ++i) h = (h ^ data[i]) * kFnvPrime;
  return h;
}

constexpr int32_t kEmpty = -1;
constexpr int32_t kTombstone = -2;

struct Table {
  int64_t capacity;
  // Open-addressing index: bucket -> slot (kEmpty / kTombstone markers).
  std::vector<int32_t> buckets;
  std::vector<uint64_t> bucket_hash;  // valid when buckets[i] >= 0
  uint64_t mask;
  int64_t used = 0;        // live entries
  int64_t tombstones = 0;

  // Per-slot data.
  std::vector<std::string> keys;    // key bytes (empty = unassigned)
  std::vector<uint64_t> hashes;     // key hash per slot
  std::vector<int64_t> expire;      // TTL mirror (ms)
  std::vector<int32_t> lru_prev, lru_next;  // intrusive LRU list
  int32_t lru_head = -1, lru_tail = -1;     // head = most recent
  std::vector<int32_t> free_slots;

  // Per-batch round counters with epoch stamping.
  std::vector<int32_t> seq;
  std::vector<uint64_t> seq_epoch;
  uint64_t epoch = 0;

  // Metrics (reference: lrucache.go:48-59).
  int64_t hits = 0, misses = 0, evictions = 0, unexpired_evictions = 0;

  explicit Table(int64_t cap) : capacity(cap) {
    uint64_t n = 16;
    while (n < static_cast<uint64_t>(cap) * 2) n <<= 1;
    buckets.assign(n, kEmpty);
    bucket_hash.assign(n, 0);
    mask = n - 1;
    keys.resize(cap);
    hashes.assign(cap, 0);
    expire.assign(cap, 0);
    lru_prev.assign(cap, -1);
    lru_next.assign(cap, -1);
    free_slots.reserve(cap);
    for (int64_t s = cap - 1; s >= 0; --s)
      free_slots.push_back(static_cast<int32_t>(s));
    seq.assign(cap, 0);
    seq_epoch.assign(cap, 0);
  }

  // -- LRU list ------------------------------------------------------

  void lru_unlink(int32_t s) {
    int32_t p = lru_prev[s], n = lru_next[s];
    if (p >= 0) lru_next[p] = n; else if (lru_head == s) lru_head = n;
    if (n >= 0) lru_prev[n] = p; else if (lru_tail == s) lru_tail = p;
    lru_prev[s] = lru_next[s] = -1;
  }

  void lru_push_front(int32_t s) {
    lru_prev[s] = -1;
    lru_next[s] = lru_head;
    if (lru_head >= 0) lru_prev[lru_head] = s;
    lru_head = s;
    if (lru_tail < 0) lru_tail = s;
  }

  void lru_touch(int32_t s) {
    if (lru_head == s) return;
    lru_unlink(s);
    lru_push_front(s);
  }

  // -- hash index ----------------------------------------------------

  // Find the bucket holding `key`, or the first insertable bucket.
  // Returns slot >= 0 on hit, -1 on miss (insert_at set).
  int32_t find(uint64_t h, const uint8_t* key, int64_t len,
               uint64_t* insert_at) {
    uint64_t i = h & mask;
    int64_t first_tomb = -1;
    for (;;) {
      int32_t b = buckets[i];
      if (b == kEmpty) {
        *insert_at = (first_tomb >= 0) ? static_cast<uint64_t>(first_tomb) : i;
        return -1;
      }
      if (b == kTombstone) {
        if (first_tomb < 0) first_tomb = static_cast<int64_t>(i);
      } else if (bucket_hash[i] == h) {
        const std::string& k = keys[b];
        if (static_cast<int64_t>(k.size()) == len &&
            std::memcmp(k.data(), key, len) == 0) {
          *insert_at = i;
          return b;
        }
      }
      i = (i + 1) & mask;
    }
  }

  void index_insert(uint64_t bucket, uint64_t h, int32_t slot) {
    if (buckets[bucket] == kTombstone) --tombstones;
    buckets[bucket] = slot;
    bucket_hash[bucket] = h;
    ++used;
  }

  void index_erase(uint64_t h, const uint8_t* key, int64_t len) {
    uint64_t i = h & mask;
    for (;;) {
      int32_t b = buckets[i];
      if (b == kEmpty) return;  // not present
      if (b >= 0 && bucket_hash[i] == h) {
        const std::string& k = keys[b];
        if (static_cast<int64_t>(k.size()) == len &&
            std::memcmp(k.data(), key, len) == 0) {
          buckets[i] = kTombstone;
          ++tombstones;
          --used;
          maybe_rehash();
          return;
        }
      }
      i = (i + 1) & mask;
    }
  }

  void maybe_rehash() {
    if (tombstones * 4 < static_cast<int64_t>(mask + 1)) return;
    std::vector<int32_t> old_buckets(std::move(buckets));
    std::vector<uint64_t> old_hash(std::move(bucket_hash));
    buckets.assign(mask + 1, kEmpty);
    bucket_hash.assign(mask + 1, 0);
    tombstones = 0;
    for (uint64_t i = 0; i <= mask; ++i) {
      int32_t b = old_buckets[i];
      if (b < 0) continue;
      uint64_t j = old_hash[i] & mask;
      while (buckets[j] != kEmpty) j = (j + 1) & mask;
      buckets[j] = b;
      bucket_hash[j] = old_hash[i];
    }
  }

  // -- batch round counters ------------------------------------------

  int32_t next_round(int32_t slot) {
    if (seq_epoch[slot] != epoch) {
      seq_epoch[slot] = epoch;
      seq[slot] = 0;
    }
    return seq[slot]++;
  }

  int32_t current_round(int32_t slot) const {
    return (seq_epoch[slot] == epoch) ? seq[slot] : 0;
  }
};

// Intern ONE key (hash precomputed) into `t`: hit → LRU touch; miss →
// free slot or LRU eviction.  Returns the slot; *evicted_slot is the
// slot cleared by this call (-1 if none) and *evict_round the batch
// round its device-side clear must run in.  The round counter for the
// returned slot is NOT advanced here — callers do that so they control
// output ordering.
inline int32_t schedule_one(Table& t, const uint8_t* key, int64_t len,
                            uint64_t h, int64_t now_ms,
                            int32_t* evicted_slot, int32_t* evict_round) {
  *evicted_slot = -1;
  uint64_t at;
  int32_t slot = t.find(h, key, len, &at);
  if (slot >= 0) {
    ++t.hits;
    t.lru_touch(slot);
    return slot;
  }
  ++t.misses;
  if (!t.free_slots.empty()) {
    slot = t.free_slots.back();
    t.free_slots.pop_back();
  } else {
    // Evict the least-recently-used slot (reference: lrucache.go:148-159).
    slot = t.lru_tail;
    t.lru_unlink(slot);
    const std::string& old = t.keys[slot];
    t.index_erase(t.hashes[slot],
                  reinterpret_cast<const uint8_t*>(old.data()),
                  static_cast<int64_t>(old.size()));
    ++t.evictions;
    if (t.expire[slot] > now_ms) ++t.unexpired_evictions;
    *evicted_slot = slot;
    *evict_round = t.current_round(slot);
    // find() must be re-run: index_erase may have rehashed.
    int32_t dup = t.find(h, key, len, &at);
    (void)dup;
  }
  t.keys[slot].assign(reinterpret_cast<const char*>(key),
                      static_cast<size_t>(len));
  t.hashes[slot] = h;
  t.expire[slot] = 0;
  t.index_insert(at, h, slot);
  t.lru_push_front(slot);
  return slot;
}

}  // namespace

extern "C" {

void* git_new(int64_t capacity) { return new Table(capacity); }

void git_free(void* t) { delete static_cast<Table*>(t); }

int64_t git_len(void* t) { return static_cast<Table*>(t)->used; }

// Schedule one batch: intern every key, assign rounds, record
// evictions (each with the round its clear must run in).
// keys are packed in `buf` with `offsets[n+1]` boundaries.
// out_slots[n], out_rounds[n]; out_evicted/out_evict_rounds sized n.
// Returns the number of evictions.  stats_out[4]: hits, misses,
// evictions, unexpired_evictions (cumulative totals).
// `idx`: optional indirection — schedule items buf[offsets[idx[j]]..]
// for j in [0, n) (nullptr = identity).
int64_t git_schedule_idx(void* tp, const uint8_t* buf, const int64_t* offsets,
                         const int64_t* idx, int64_t n, int64_t now_ms,
                         int32_t* out_slots, int32_t* out_rounds,
                         int32_t* out_evicted, int32_t* out_evict_rounds,
                         int64_t* stats_out) {
  Table& t = *static_cast<Table*>(tp);
  ++t.epoch;
  int64_t n_evicted = 0;
  // Hash-ahead window: at large capacities the probe is cache-miss
  // bound (~300ns/key measured at 8M slots), so hashes are computed
  // one window ahead and the first bucket line of each is prefetched.
  // Prefetching is only a hint — inserts/rehashes during the batch
  // can move buckets, which merely wastes the hint.
  constexpr int64_t kAhead = 16;
  uint64_t hwin[kAhead];
  auto hash_of = [&](int64_t j2) {
    const int64_t it = idx ? idx[j2] : j2;
    return fnv1a(buf + offsets[it], offsets[it + 1] - offsets[it]);
  };
  const int64_t warm = n < kAhead ? n : kAhead;
  for (int64_t j = 0; j < warm; ++j) {
    hwin[j] = hash_of(j);
    __builtin_prefetch(&t.buckets[hwin[j] & t.mask]);
    __builtin_prefetch(&t.bucket_hash[hwin[j] & t.mask]);
  }
  for (int64_t j = 0; j < n; ++j) {
    const int64_t item = idx ? idx[j] : j;
    const uint8_t* key = buf + offsets[item];
    const int64_t len = offsets[item + 1] - offsets[item];
    const uint64_t h = hwin[j % kAhead];
    if (j + kAhead < n) {
      const uint64_t hn = hash_of(j + kAhead);
      hwin[(j + kAhead) % kAhead] = hn;
      __builtin_prefetch(&t.buckets[hn & t.mask]);
      __builtin_prefetch(&t.bucket_hash[hn & t.mask]);
    }
    int32_t ev_slot, ev_round;
    int32_t slot = schedule_one(t, key, len, h, now_ms, &ev_slot, &ev_round);
    if (ev_slot >= 0) {
      out_evicted[n_evicted] = ev_slot;
      out_evict_rounds[n_evicted] = ev_round;
      ++n_evicted;
    }
    out_slots[j] = slot;
    out_rounds[j] = t.next_round(slot);
  }
  stats_out[0] = t.hits;
  stats_out[1] = t.misses;
  stats_out[2] = t.evictions;
  stats_out[3] = t.unexpired_evictions;
  return n_evicted;
}

// Schedule one batch across n_sh shard tables in ONE call (the
// sharded engine's whole host tier for a batch): shard routing
// (hash % n_sh), per-table interning + LRU + eviction, round
// assignment, TTL mirror writes, and the dispatch ordering the packers
// need, where a Python loop would make per-shard nonzero / schedule /
// set_expiry / argsort calls.
//
//   tables[n_sh]      Table* per shard
//   hashes[n]         fnv1a-64 per key (nullable → computed here);
//                     must be the canonical-key fnv1a (the wire
//                     codec's dec.fnv1a is bit-identical)
//   expires[n]        per-item TTL mirror write (nullable)
//   out_shard/slots/rounds[n]   per-item results
//   out_order[n]      permutation of [0,n): grouped by shard, sorted
//                     by (slot, round) within each shard — round-0
//                     dispatch and the hot-key collapse both consume
//                     this ordering directly
//   out_shard_counts[n_sh]      group sizes of out_order
//   out_evicted/out_evict_shard/out_evict_rounds[n], *out_n_evicted
//   stats_out[4*n_sh] cumulative per-table (hits, misses, evictions,
//                     unexpired_evictions)
// Returns max_round (>= 0).
int64_t git_multi_schedule(
    void** tables, int64_t n_sh, const uint8_t* buf, const int64_t* offsets,
    const uint64_t* hashes, int64_t n, int64_t now_ms, const int64_t* expires,
    int32_t* out_shard, int32_t* out_slots, int32_t* out_rounds,
    int64_t* out_order, int64_t* out_shard_counts, int32_t* out_evicted,
    int32_t* out_evict_shard, int32_t* out_evict_rounds,
    int64_t* out_n_evicted, int64_t* stats_out, int64_t n_threads) {
  for (int64_t sh = 0; sh < n_sh; ++sh)
    ++static_cast<Table*>(tables[sh])->epoch;
  const uint64_t ns = static_cast<uint64_t>(n_sh);

  // Pass 1 (serial): hash + shard per item, then a counting sort that
  // leaves out_order grouped by shard in ARRIVAL order — the layout
  // the per-shard workers consume.
  std::vector<uint64_t> h_local;
  const uint64_t* h_all = hashes;
  if (!h_all) {
    h_local.resize(static_cast<size_t>(n));
    for (int64_t j = 0; j < n; ++j)
      h_local[j] = fnv1a(buf + offsets[j], offsets[j + 1] - offsets[j]);
    h_all = h_local.data();
  }
  std::vector<int64_t> start(static_cast<size_t>(n_sh) + 1, 0);
  for (int64_t j = 0; j < n; ++j) {
    const int64_t sh = static_cast<int64_t>(h_all[j] % ns);
    out_shard[j] = static_cast<int32_t>(sh);
    ++start[sh + 1];
  }
  for (int64_t sh = 0; sh < n_sh; ++sh) {
    out_shard_counts[sh] = start[sh + 1];
    start[sh + 1] += start[sh];
  }
  {
    std::vector<int64_t> cursor(start.begin(), start.end() - 1);
    for (int64_t j = 0; j < n; ++j) out_order[cursor[out_shard[j]]++] = j;
  }

  // Pass 2: per-shard scheduling — tables are independent, so shards
  // run CONCURRENTLY on multi-core hosts (the ctypes caller released
  // the GIL; n_threads <= 1 runs inline).  Each worker schedules its
  // shard's items in arrival order, defers its TTL writes to after
  // its loop (same-batch evictions must read pre-batch expire — the
  // deferred git_set_expiry semantics), sorts its out_order segment
  // by (slot, round), and publishes per-table stats.
  std::vector<std::vector<std::array<int32_t, 2>>> evs(
      static_cast<size_t>(n_sh));
  std::vector<int32_t> shard_max(static_cast<size_t>(n_sh), 0);

  auto work_shard = [&](int64_t sh) {
    Table& t = *static_cast<Table*>(tables[sh]);
    const int64_t lo = start[sh], hi = start[sh + 1];
    auto& ev = evs[static_cast<size_t>(sh)];
    int32_t local_max = 0;
    constexpr int64_t kAhead = 8;
    for (int64_t k = lo; k < hi; ++k) {
      if (k + kAhead < hi) {
        const uint64_t hn = h_all[out_order[k + kAhead]];
        __builtin_prefetch(&t.buckets[hn & t.mask]);
        __builtin_prefetch(&t.bucket_hash[hn & t.mask]);
      }
      const int64_t j = out_order[k];
      int32_t ev_slot, ev_round;
      const int32_t slot = schedule_one(
          t, buf + offsets[j], offsets[j + 1] - offsets[j], h_all[j],
          now_ms, &ev_slot, &ev_round);
      if (ev_slot >= 0) ev.push_back({ev_slot, ev_round});
      const int32_t round = t.next_round(slot);
      if (round > local_max) local_max = round;
      out_slots[j] = slot;
      out_rounds[j] = round;
    }
    if (expires) {
      for (int64_t k = lo; k < hi; ++k) {
        const int64_t j = out_order[k];
        t.expire[out_slots[j]] = expires[j];
      }
    }
    // (slot, round) sort: pairs are unique within a shard — round k
    // IS the k-th occurrence of the slot — so the sort is total and,
    // for duplicate slots, round order equals arrival order (what
    // the hot-key collapse requires).
    std::sort(out_order + lo, out_order + hi,
              [&](int64_t a, int64_t b) {
                if (out_slots[a] != out_slots[b])
                  return out_slots[a] < out_slots[b];
                return out_rounds[a] < out_rounds[b];
              });
    shard_max[static_cast<size_t>(sh)] = local_max;
    stats_out[4 * sh + 0] = t.hits;
    stats_out[4 * sh + 1] = t.misses;
    stats_out[4 * sh + 2] = t.evictions;
    stats_out[4 * sh + 3] = t.unexpired_evictions;
  };

  int64_t k_threads = n_threads;
  if (k_threads > n_sh) k_threads = n_sh;
  if (k_threads <= 1) {
    for (int64_t sh = 0; sh < n_sh; ++sh) work_shard(sh);
  } else {
    std::vector<std::thread> pool;
    pool.reserve(static_cast<size_t>(k_threads));
    for (int64_t w = 0; w < k_threads; ++w)
      pool.emplace_back([&, w]() {
        for (int64_t sh = w; sh < n_sh; sh += k_threads) work_shard(sh);
      });
    for (auto& th : pool) th.join();
  }

  // Merge evictions (shard-grouped; consumers bucket by (round,
  // shard), so inter-shard order is irrelevant).
  int64_t n_evicted = 0;
  int64_t max_round = 0;
  for (int64_t sh = 0; sh < n_sh; ++sh) {
    if (shard_max[static_cast<size_t>(sh)] > max_round)
      max_round = shard_max[static_cast<size_t>(sh)];
    for (const auto& e : evs[static_cast<size_t>(sh)]) {
      out_evicted[n_evicted] = e[0];
      out_evict_shard[n_evicted] = static_cast<int32_t>(sh);
      out_evict_rounds[n_evicted] = e[1];
      ++n_evicted;
    }
  }
  *out_n_evicted = n_evicted;
  return max_round;
}

void git_set_expiry(void* tp, const int32_t* slots, const int64_t* expires,
                    int64_t n) {
  Table& t = *static_cast<Table*>(tp);
  for (int64_t i = 0; i < n; ++i) t.expire[slots[i]] = expires[i];
}

// Remove a key; returns its slot or -1.
int32_t git_remove(void* tp, const uint8_t* key, int64_t len) {
  Table& t = *static_cast<Table*>(tp);
  const uint64_t h = fnv1a(key, len);
  uint64_t at;
  int32_t slot = t.find(h, key, len, &at);
  if (slot < 0) return -1;
  t.index_erase(h, key, len);
  t.lru_unlink(slot);
  t.keys[slot].clear();
  t.expire[slot] = 0;
  t.free_slots.push_back(slot);
  return slot;
}

// Free slots reclaimed by the device expiry sweep.
void git_release(void* tp, const int32_t* slots, int64_t n) {
  Table& t = *static_cast<Table*>(tp);
  for (int64_t i = 0; i < n; ++i) {
    int32_t s = slots[i];
    if (t.keys[s].empty()) continue;
    t.index_erase(t.hashes[s],
                  reinterpret_cast<const uint8_t*>(t.keys[s].data()),
                  static_cast<int64_t>(t.keys[s].size()));
    t.lru_unlink(s);
    t.keys[s].clear();
    t.expire[s] = 0;
    t.free_slots.push_back(s);
  }
}

// Copy the key of `slot` into out (cap bytes); returns length, or -1
// if the slot is unassigned, or the required length if cap is small.
int64_t git_key_for_slot(void* tp, int32_t slot, uint8_t* out, int64_t cap) {
  Table& t = *static_cast<Table*>(tp);
  const std::string& k = t.keys[slot];
  if (k.empty()) return -1;
  const int64_t len = static_cast<int64_t>(k.size());
  if (len <= cap) std::memcpy(out, k.data(), static_cast<size_t>(len));
  return len;
}

int64_t git_contains(void* tp, const uint8_t* key, int64_t len) {
  Table& t = *static_cast<Table*>(tp);
  uint64_t at;
  return t.find(fnv1a(key, len), key, len, &at) >= 0 ? 1 : 0;
}

}  // extern "C"
