// Native columnar feeder plane: wire bytes → device-ready columns with
// zero Python frames on the ingest path.
//
// Why: the byte window path feeds the device through the Python window
// callback — the per-window ctypes body copy, the decode FFI round trip
// and fresh numpy columns per window, all serialized on ONE dispatch
// thread, and the RPCs that miss the native decision plane queue behind
// those windows.
//
// This plane moves the whole pack below Python and spreads it across
// the connection threads: each conn thread decodes its RPC body ONCE
// (wire_codec.cpp — fnv1/fnv1a key hashes computed in the same pass)
// and appends the rows into the OPEN window of a lock-free ring of
// pre-allocated column buffers (key_hash / limit / duration / hits /
// algorithm / behavior lanes — the same lane set bucket_kernel's
// pack_batch_host consumes, so the Python side's only remaining work
// is the intern-table schedule + the packed-round submit the engine's
// step pump ingests).  Python is entered exactly once per WINDOW through the
// columnar callback, with ZERO-COPY numpy views over the ring slot —
// no bytes cross the boundary at all, in either direction: verdict
// columns are written back in place and the feeder thread encodes +
// scatters the per-RPC responses through the C connection plane.
//
// Concurrency design (Vyukov-school, as the reference's event ring):
//   * One OPEN window at a time.  Producers claim (rpc, rows, key
//     bytes) jointly with one CAS on a packed 64-bit cursor, then copy
//     their decoded columns into the claimed ranges and publish with a
//     fetch_add on `committed_rows`.  No mutex anywhere on the pack
//     path; the wake condvar is touched only on first-claim/seal.
//   * The claim cursor carries a 6-bit GENERATION tag so a producer
//     stalled across a whole window lifecycle cannot ABA-claim into a
//     recycled slot.
//   * Sealing is a fetch_or of the cursor's CLOSED bit — the returned
//     value IS the final claim set, so the sealer knows exactly how
//     many committed rows to wait for.  Producers that claimed before
//     the seal finish their copies; claims after it fail and fall
//     back to the byte-window path (bounded, counted backpressure —
//     ring pressure degrades to the byte window path, never drops
//     RPCs).
//   * Only the feeder thread advances the open-window index and
//     resets served slots, so slot lifecycle is single-writer.
//
// All atomics in this file use the DEFAULT seq_cst order: the pack
// path is memcpy-bound, x86 turns seq_cst loads into plain loads, and
// the stronger order keeps the proof obligations (and the guberlint
// atomics audit) trivial.
//
// Offsets convention: key_offsets[0] = 0 at reset; a producer whose
// claim starts at row r with rows n writes offsets[r+1 .. r+n] (the
// END of each of its rows).  Claims are jointly contiguous in rows
// AND bytes, so offsets[r] — the END of row r-1, written by the
// previous claimant — is exactly this claim's byte base: every entry
// is written by exactly one thread, no gaps, no write-write races.
//
// This file is the port's copy of
// gubernator_tpu/core/native/columnar_feeder.cpp: the ring of windows,
// the packed claim cursor, the pack, the serve loop, the scatter and the
// C ABI are the reference's, unchanged.  Plain C ABI + ctypes
// (core/native_plane.py NativeColumnarFeeder); linked into the h2 server
// library (ops/native_build.py SOURCES["h2_server"]) so the response
// bridge (h2s_feeder_respond / h2s_feeder_release) is an ordinary
// in-image call.  The event ring's stages (event_ring.cpp, attached with
// `cf_attach_ring`) are the reference's too: the pack in the connection
// thread, each RPC's wait from its enqueue stamp (which h2_server.cpp
// passes to `cf_pack`) to the window callback, and the callback's wall.

#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>

// From wire_codec.cpp (same library).
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
// From event_ring.cpp (same library).
extern "C" int64_t evr_record(void* handle, int64_t kind, int64_t t_end_ns,
                              int64_t dur_ns, int64_t items);
extern "C" int64_t evr_now_ns();

// Event kinds (gubernator_tpu_torch/utils/native_events.py names them;
// 1-3 and 7-9 are the h2 front's).
constexpr int64_t kEvFeederPack = 4;      // conn thread: decode+pack
constexpr int64_t kEvFeederRingWait = 5;  // pack → window callback
constexpr int64_t kEvFeederServe = 6;     // columnar callback wall

// From h2_server.cpp (same library): the response scatter bridge.  A
// conn_token is opaque to this file; respond consumes it, release
// frees it without sending (teardown).  Both tolerate nullptr tokens
// (the bench/test packer passes none).
extern "C" void h2s_feeder_respond(void* conn_token, int64_t stream,
                                   const uint8_t* payload, int64_t len,
                                   int32_t grpc_status);
extern "C" void h2s_feeder_release(void* conn_token);
namespace {

// Claim-cursor bit layout (single 64-bit atomic per window):
//   bits  0..29  key bytes claimed   (≤ 1 GiB per window)
//   bits 30..43  rows claimed        (≤ 16383)
//   bits 44..56  rpcs claimed        (≤ 8191)
//   bits 57..62  generation tag      (ABA guard, mod 64)
//   bit  63      CLOSED
constexpr uint64_t kBytesMask = (1ULL << 30) - 1;
constexpr int kRowsShift = 30;
constexpr uint64_t kRowsMask = (1ULL << 14) - 1;
constexpr int kRpcsShift = 44;
constexpr uint64_t kRpcsMask = (1ULL << 13) - 1;
constexpr int kGenShift = 57;
constexpr uint64_t kGenMask = (1ULL << 6) - 1;
constexpr uint64_t kClosedBit = 1ULL << 63;

inline uint64_t cur_bytes(uint64_t c) { return c & kBytesMask; }
inline uint64_t cur_rows(uint64_t c) { return (c >> kRowsShift) & kRowsMask; }
inline uint64_t cur_rpcs(uint64_t c) { return (c >> kRpcsShift) & kRpcsMask; }
inline uint64_t cur_gen(uint64_t c) { return (c >> kGenShift) & kGenMask; }

// Columnar window callback: Python receives the slot index and the
// sealed window's row/rpc/key-byte counts, serves through the engine
// columnar path using the PRE-MAPPED zero-copy views of the slot's
// column arrays, writes the verdict columns + per-RPC status in
// place, and returns 0 (or a grpc status failing the whole window).
typedef int64_t (*ColumnarCallback)(int64_t slot, int64_t n_rows,
                                    int64_t n_rpcs, int64_t key_bytes);

struct CfWindow {
  // One pre-allocated window: request columns (filled by producers),
  // verdict columns (filled by the Python callback), and the per-RPC
  // scatter table.  All fixed-capacity; lifecycle is OPEN → CLOSED →
  // (served) → reset, with `cursor` the single source of truth.
  std::atomic<uint64_t> cursor{0};
  std::atomic<int64_t> committed_rows{0};

  std::vector<uint8_t> key_buf;
  std::vector<int64_t> key_offsets;  // [max_rows + 1]; [0] stays 0
  std::vector<int32_t> algo, behavior, name_lens;
  std::vector<int64_t> hits, limit, duration, burst;
  std::vector<uint64_t> fnv1, fnv1a;
  // Verdict lanes (Python writes; the scatter encodes from them).
  std::vector<int32_t> out_status;
  std::vector<int64_t> out_limit, out_remaining, out_reset;
  // Per-RPC scatter table.  rpc_status is written by Python (0 =
  // encode from the verdict columns; nonzero = fail that RPC with the
  // given grpc status).
  std::vector<void*> rpc_token;
  std::vector<int64_t> rpc_stream, rpc_row, rpc_items, rpc_enq_ns,
      rpc_status;
  // Engine-domain "now" for the retry-hint encode, written by the
  // Python callback during the serve (reset_time columns live in the
  // ENGINE clock domain — raw system_clock here would skew every
  // hint by the engine/host clock offset).  0 = fall back to
  // system_clock (sink mode / handler crash).
  std::vector<int64_t> hint_now_ms;
};

struct Feeder {
  // guberlint: guard callback by mu
  int64_t n_slots, max_rows, key_cap, max_rpcs;
  int64_t disqualify_mask;
  int64_t window_us = 2000;
  int64_t flush_rows = 4096;
  int32_t over_status = 0;   // retry-hint encode: the OVER_LIMIT value
  std::atomic<int64_t> hints{0};  // retry_after_ms metadata on/off
  std::vector<CfWindow> slots;
  // Open-window index: written ONLY by the feeder thread; producers
  // read it to find the current claim target.
  std::atomic<int64_t> open{0};
  std::atomic<bool> closing{false};
  std::atomic<void*> ring{nullptr};  // optional event ring
  // Python window callback; cf_stop nulls it (drain windows answer
  // UNAVAILABLE), so reads and the write serialize on mu.
  ColumnarCallback callback = nullptr;  // guarded by mu
  std::thread serve_thread;
  std::mutex mu;
  std::condition_variable cv;
  // Wake hint for the serve loop.  Atomic (not mu-guarded) although
  // every WRITE happens with mu held: gcc-10's libtsan mistracks the
  // condvar-wait mutex re-acquisition and reports phantom races on
  // plain flags touched around cv.wait — the atomic keeps TSan
  // meaningful for the rest of this file without a suppression.
  std::atomic<bool> kick{false};
  // Stats (lock-free path: monotonic atomics, same contract as the
  // h2 server's counters).
  std::atomic<int64_t> packed_rpcs{0}, packed_rows{0}, windows{0};
  std::atomic<int64_t> served_rows{0}, ring_full{0}, declined{0};
  std::atomic<int64_t> window_errors{0};
};

// Thread-local decode scratch: the two-phase pack (decode here, then
// claim EXACT sizes and copy) is what keeps the claim protocol
// gap-free.  Sized on first use per CALLING thread — on the
// thread-per-conn plane that is one scratch per connection; under
// the event front the callers are the epoll reactors, so the
// whole C100K fleet shares ncpu−1 scratches (per-reactor, not
// per-connection) and the high-water sizing amortizes across every
// connection on the lane.
struct PackScratch {
  std::vector<uint8_t> key_buf;
  std::vector<int64_t> key_offsets;
  std::vector<int32_t> algo, behavior, name_lens;
  std::vector<int64_t> hits, limit, duration, burst;
  std::vector<uint64_t> fnv1, fnv1a;
  void ensure(int64_t items, int64_t body_len) {
    if (static_cast<int64_t>(key_buf.size()) < body_len + items + 1)
      key_buf.resize(static_cast<size_t>(body_len + items + 1));
    if (static_cast<int64_t>(algo.size()) < items) {
      key_offsets.resize(static_cast<size_t>(items) + 1);
      algo.resize(items);
      behavior.resize(items);
      name_lens.resize(items);
      hits.resize(items);
      limit.resize(items);
      duration.resize(items);
      burst.resize(items);
      fnv1.resize(items);
      fnv1a.resize(items);
    }
  }
};

thread_local PackScratch tls_scratch;

void wake_serve(Feeder* f) {
  // The mutex is still taken (lost-wakeup safety against the serve
  // loop's predicate-check→wait gap); the flag itself is atomic — see
  // the Feeder::kick comment.
  std::lock_guard<std::mutex> lock(f->mu);
  f->kick.store(true);
  f->cv.notify_one();
}

// Copy one decoded RPC from scratch into its claimed window ranges.
// guberlint: gil-free
void copy_into(CfWindow& w, PackScratch& s, int64_t row0, int64_t byte0,
               int64_t n, int64_t rpc_idx, void* conn_token,
               int64_t stream, int64_t t_enq_ns) {
  const int64_t kbytes = s.key_offsets[n];
  std::memcpy(w.key_buf.data() + byte0, s.key_buf.data(),
              static_cast<size_t>(kbytes));
  // offsets[row0] == byte0 was written by the previous claimant (or
  // is the reset 0); this claim writes the END offset of each of its
  // own rows — see the offsets convention in the header comment.
  for (int64_t i = 0; i < n; ++i)
    w.key_offsets[row0 + 1 + i] = byte0 + s.key_offsets[i + 1];
  std::memcpy(w.algo.data() + row0, s.algo.data(), n * sizeof(int32_t));
  std::memcpy(w.behavior.data() + row0, s.behavior.data(),
              n * sizeof(int32_t));
  std::memcpy(w.name_lens.data() + row0, s.name_lens.data(),
              n * sizeof(int32_t));
  std::memcpy(w.hits.data() + row0, s.hits.data(), n * sizeof(int64_t));
  std::memcpy(w.limit.data() + row0, s.limit.data(), n * sizeof(int64_t));
  std::memcpy(w.duration.data() + row0, s.duration.data(),
              n * sizeof(int64_t));
  std::memcpy(w.burst.data() + row0, s.burst.data(), n * sizeof(int64_t));
  std::memcpy(w.fnv1.data() + row0, s.fnv1.data(), n * sizeof(uint64_t));
  std::memcpy(w.fnv1a.data() + row0, s.fnv1a.data(), n * sizeof(uint64_t));
  w.rpc_token[rpc_idx] = conn_token;
  w.rpc_stream[rpc_idx] = stream;
  w.rpc_row[rpc_idx] = row0;
  w.rpc_items[rpc_idx] = n;
  w.rpc_enq_ns[rpc_idx] = t_enq_ns;
}

// Encode + send every RPC of a served window from its verdict
// columns, honoring the per-RPC status lane.  rc != 0 fails the whole
// window (callback crash / sink teardown).
void scatter_window(Feeder* f, CfWindow& w, uint64_t sealed, int64_t rc) {
  const int64_t n_rpcs = static_cast<int64_t>(cur_rpcs(sealed));
  const int64_t hints = f->hints.load();
  int64_t now_ms = 0;
  if (hints) {
    now_ms = w.hint_now_ms[0];
    if (now_ms == 0)
      now_ms = std::chrono::duration_cast<std::chrono::milliseconds>(
                   std::chrono::system_clock::now().time_since_epoch())
                   .count();
  }
  std::vector<uint8_t> enc;
  for (int64_t r = 0; r < n_rpcs; ++r) {
    void* token = w.rpc_token[r];
    w.rpc_token[r] = nullptr;
    const int64_t st = (rc != 0) ? rc : w.rpc_status[r];
    if (token == nullptr) continue;  // bench/test rows: nothing to send
    if (st != 0) {
      h2s_feeder_respond(token, w.rpc_stream[r], nullptr, 0,
                         static_cast<int32_t>(st));
      f->window_errors.fetch_add(1);
      continue;
    }
    const int64_t row0 = w.rpc_row[r];
    const int64_t k = w.rpc_items[r];
    // Worst case per item: tag+len (6) + 4 varint fields (11 each) +
    // the retry-hint metadata entry (~40).
    const int64_t cap = k * 96 + 16;
    if (static_cast<int64_t>(enc.size()) < cap)
      enc.resize(static_cast<size_t>(cap));
    const int64_t len =
        hints ? wire_encode_resps_hint(
                    w.out_status.data() + row0, w.out_limit.data() + row0,
                    w.out_remaining.data() + row0,
                    w.out_reset.data() + row0, k, f->over_status, now_ms,
                    enc.data(), cap)
              : wire_encode_resps(
                    w.out_status.data() + row0, w.out_limit.data() + row0,
                    w.out_remaining.data() + row0,
                    w.out_reset.data() + row0, k, enc.data(), cap);
    if (len < 0) {  // sized-out encode: fail the RPC, not the window
      h2s_feeder_respond(token, w.rpc_stream[r], nullptr, 0, 13);
      f->window_errors.fetch_add(1);
      continue;
    }
    h2s_feeder_respond(token, w.rpc_stream[r], enc.data(), len, 0);
  }
}

// Seal `w` (idempotent), wait for in-flight producer copies, serve it
// through the Python columnar callback, scatter the responses, and
// recycle the slot.  Only the feeder thread calls this.
void serve_window(Feeder* f, int64_t idx) {
  CfWindow& w = f->slots[idx];
  const uint64_t sealed = w.cursor.fetch_or(kClosedBit);
  const int64_t rows = static_cast<int64_t>(cur_rows(sealed));
  if (rows == 0) {
    // Nothing claimed since reset: reopen (gen unchanged — no claim
    // ever observed this window, so no ABA exposure).
    w.cursor.store(sealed & (kGenMask << kGenShift));
    return;
  }
  // Producers that claimed before the seal are mid-copy at most; the
  // gap between claim and commit is a bounded memcpy, so a spin-yield
  // wait is the right tool (no condvar on the pack path).
  while (w.committed_rows.load() != rows) std::this_thread::yield();
  void* ring = f->ring.load();
  const int64_t n_rpcs = static_cast<int64_t>(cur_rpcs(sealed));
  ColumnarCallback cb;
  {
    std::lock_guard<std::mutex> lock(f->mu);
    cb = f->callback;
  }
  int64_t rc = 0;
  if (cb != nullptr) {
    const int64_t t_cb = ring ? evr_now_ns() : 0;
    if (ring) {
      for (int64_t r = 0; r < n_rpcs; ++r)
        if (w.rpc_enq_ns[r])
          evr_record(ring, kEvFeederRingWait, t_cb,
                     t_cb - w.rpc_enq_ns[r], w.rpc_items[r]);
    }
    rc = cb(idx, rows, n_rpcs, static_cast<int64_t>(cur_bytes(sealed)));
    if (ring) {
      const int64_t t1 = evr_now_ns();
      evr_record(ring, kEvFeederServe, t1, t1 - t_cb, rows);
    }
    f->served_rows.fetch_add(rows);
  } else {
    rc = 14;  // sink mode (bench) / teardown: UNAVAILABLE
  }
  f->windows.fetch_add(1);
  scatter_window(f, w, sealed, rc);
  // Recycle: bump the generation, zero the claims, reopen.
  w.committed_rows.store(0);
  const uint64_t next_gen = (cur_gen(sealed) + 1) & kGenMask;
  w.cursor.store(next_gen << kGenShift);
}

void serve_loop(Feeder* f) {
  while (true) {
    {
      std::unique_lock<std::mutex> lock(f->mu);
      f->cv.wait(lock, [&] {
        if (f->closing.load() || f->kick.load()) return true;
        if (cur_rows(f->slots[f->open.load()].cursor.load()) != 0)
          return true;
        // A sealed NON-open window must also wake the loop: a flush
        // racing the rotation (seal lands just after `open` moved
        // past the slot) or a consumed kick would otherwise strand
        // its rows until the next pack (the teardown row-conservation
        // race).
        for (int64_t i = 0; i < f->n_slots; ++i)
          if (f->slots[i].cursor.load() & kClosedBit) return true;
        return false;
      });
      f->kick.store(false);
    }
    if (f->closing.load()) break;
    // Group-commit window: wait up to window_us for concurrent
    // arrivals unless a producer already sealed (flush threshold).
    {
      const int64_t idx = f->open.load();
      CfWindow& w = f->slots[idx];
      if (!(w.cursor.load() & kClosedBit) &&
          cur_rows(w.cursor.load()) != 0) {
        std::unique_lock<std::mutex> lock(f->mu);
        const auto deadline = std::chrono::steady_clock::now() +
                              std::chrono::microseconds(f->window_us);
        f->cv.wait_until(lock, deadline, [&] {
          return f->closing.load() ||
                 (w.cursor.load() & kClosedBit) != 0;
        });
        f->kick.store(false);
      }
      if (f->closing.load()) break;
      // Rotate FIRST, then serve: producers keep packing into the
      // next slot while Python serves this one (the double-buffered
      // ingest the ring exists for).  If the next slot has not been
      // recycled yet (possible only with in-flight windows ≥
      // n_slots), the open window stays sealed and packs fall back to
      // the byte path until a slot frees.
      const int64_t next = (idx + 1) % f->n_slots;
      CfWindow& nw = f->slots[next];
      const uint64_t ncur = nw.cursor.load();
      if (!(ncur & kClosedBit) && cur_rows(ncur) == 0 && next != idx)
        f->open.store(next);
      serve_window(f, idx);
      // Sweep sealed windows the open cursor already rotated past
      // (a flush can seal ANY slot with claims, not just the open
      // one) — serving is single-consumer, so serving them out of
      // ring order is safe, and without the sweep they would wait on
      // the next wake instead of draining now.
      for (int64_t i = 0; i < f->n_slots; ++i)
        if (i != idx && (f->slots[i].cursor.load() & kClosedBit))
          serve_window(f, i);
    }
  }
  // Drain-then-close: serve every window that still has claims so no
  // RPC strands mid-ring and every conn token is released.  The
  // Python side has already detached the callback path by contract
  // (cf_stop nulls it first), so these answer UNAVAILABLE.
  for (int64_t i = 0; i < f->n_slots; ++i) serve_window(f, i);
}

}  // namespace

extern "C" {

// Create a feeder ring: n_slots windows of max_rows rows / key_cap
// key bytes / max_rpcs RPCs each.  `callback` may be nullptr (sink
// mode: windows seal and recycle without entering Python — the
// microbench and overflow tests run the pure pack path).
void* cf_create(int64_t n_slots, int64_t max_rows, int64_t key_cap,
                int64_t max_rpcs, int64_t disqualify_mask,
                int64_t window_us, int64_t flush_rows,
                int32_t over_status, ColumnarCallback callback) {
  if (n_slots < 2) n_slots = 2;
  if (max_rows < 64) max_rows = 64;
  if (max_rows > static_cast<int64_t>(kRowsMask)) max_rows = kRowsMask;
  if (max_rpcs < 16) max_rpcs = 16;
  if (max_rpcs > static_cast<int64_t>(kRpcsMask)) max_rpcs = kRpcsMask;
  if (key_cap < (1 << 16)) key_cap = 1 << 16;
  if (key_cap > static_cast<int64_t>(kBytesMask)) key_cap = kBytesMask;
  auto* f = new Feeder();
  f->n_slots = n_slots;
  f->max_rows = max_rows;
  f->key_cap = key_cap;
  f->max_rpcs = max_rpcs;
  f->disqualify_mask = disqualify_mask;
  if (window_us > 0) f->window_us = window_us;
  if (flush_rows > 0) f->flush_rows = flush_rows;
  f->over_status = over_status;
  // guberlint: ok native — pre-publication init: the serve thread
  // that reads callback under mu is created two statements below.
  f->callback = callback;
  f->slots = std::vector<CfWindow>(n_slots);
  for (auto& w : f->slots) {
    w.key_buf.resize(key_cap);
    w.key_offsets.assign(max_rows + 1, 0);
    w.algo.resize(max_rows);
    w.behavior.resize(max_rows);
    w.name_lens.resize(max_rows);
    w.hits.resize(max_rows);
    w.limit.resize(max_rows);
    w.duration.resize(max_rows);
    w.burst.resize(max_rows);
    w.fnv1.resize(max_rows);
    w.fnv1a.resize(max_rows);
    w.out_status.assign(max_rows, 0);
    w.out_limit.assign(max_rows, 0);
    w.out_remaining.assign(max_rows, 0);
    w.out_reset.assign(max_rows, 0);
    w.rpc_token.assign(max_rpcs, nullptr);
    w.rpc_stream.assign(max_rpcs, 0);
    w.rpc_row.assign(max_rpcs, 0);
    w.rpc_items.assign(max_rpcs, 0);
    w.rpc_enq_ns.assign(max_rpcs, 0);
    w.rpc_status.assign(max_rpcs, 0);
    w.hint_now_ms.assign(1, 0);
  }
  f->serve_thread = std::thread(serve_loop, f);
  return f;
}

void cf_attach_ring(void* handle, void* ring) {
  static_cast<Feeder*>(handle)->ring.store(ring);
}

// retry_after_ms metadata on native OVER_LIMIT answers (the
// herd-backoff hint; "When Two is Worse Than One").
void cf_set_hints(void* handle, int64_t on) {
  static_cast<Feeder*>(handle)->hints.store(on);
}

// Export one slot's column/table base pointers for the Python side's
// zero-copy numpy views (fixed allocations: map once at startup).
// Layout (19 pointers): key_buf, key_offsets, algo, behavior, hits,
// limit, duration, burst, fnv1, fnv1a, name_lens, out_status,
// out_limit, out_remaining, out_reset, rpc_row, rpc_items,
// rpc_status, hint_now_ms.
void cf_slot_ptrs(void* handle, int64_t slot, void** out18) {
  auto* f = static_cast<Feeder*>(handle);
  CfWindow& w = f->slots[slot];
  out18[18] = w.hint_now_ms.data();
  out18[0] = w.key_buf.data();
  out18[1] = w.key_offsets.data();
  out18[2] = w.algo.data();
  out18[3] = w.behavior.data();
  out18[4] = w.hits.data();
  out18[5] = w.limit.data();
  out18[6] = w.duration.data();
  out18[7] = w.burst.data();
  out18[8] = w.fnv1.data();
  out18[9] = w.fnv1a.data();
  out18[10] = w.name_lens.data();
  out18[11] = w.out_status.data();
  out18[12] = w.out_limit.data();
  out18[13] = w.out_remaining.data();
  out18[14] = w.out_reset.data();
  out18[15] = w.rpc_row.data();
  out18[16] = w.rpc_items.data();
  out18[17] = w.rpc_status.data();
}

// Pack one RPC body into the open window.  Returns the packed row
// count (> 0), -1 decode decline (malformed / slow-path rows — the
// caller's byte window path owns it), -2 ring backpressure (window
// closed and the next slot not yet recycled — same fallback).
// `conn_token` may be nullptr (bench/tests); on failure the CALLER
// keeps token ownership.
// guberlint: gil-free
int64_t cf_pack(void* handle, const uint8_t* body, int64_t len,
                int64_t max_items, void* conn_token, int64_t stream,
                int64_t t_enq_ns) {
  auto* f = static_cast<Feeder*>(handle);
  if (f->closing.load()) return -2;
  void* ring = f->ring.load();
  const int64_t t0 = ring ? evr_now_ns() : 0;
  PackScratch& s = tls_scratch;
  if (max_items > f->max_rows) max_items = f->max_rows;
  s.ensure(max_items, len);
  const int64_t n = wire_decode_reqs(
      body, len, max_items, f->disqualify_mask, s.key_buf.data(),
      static_cast<int64_t>(s.key_buf.size()), s.key_offsets.data(),
      s.algo.data(), s.behavior.data(), s.hits.data(), s.limit.data(),
      s.duration.data(), s.burst.data(), s.fnv1.data(), s.fnv1a.data(),
      s.name_lens.data());
  if (n <= 0) {
    f->declined.fetch_add(1);
    return -1;
  }
  const int64_t kbytes = s.key_offsets[n];
  if (kbytes > f->key_cap || n > f->max_rows) {
    // Can never fit even an EMPTY window: decline to the byte path
    // WITHOUT sealing — otherwise every oversized RPC would
    // force-flush co-producers' freshly started windows (4 seals per
    // call) and collapse group-commit batching.
    f->declined.fetch_add(1);
    return -1;
  }
  // Claim (1 rpc, n rows, kbytes bytes) with one CAS on the open
  // window's cursor.  A full/closed window tries the (possibly
  // rotated) open index a few times, seals on capacity, then falls
  // back — bounded work, never a wait.
  for (int attempt = 0; attempt < 4; ++attempt) {
    const int64_t idx = f->open.load();
    CfWindow& w = f->slots[idx];
    uint64_t cur = w.cursor.load();
    bool sealed_here = false;
    for (;;) {
      if (cur & kClosedBit) break;  // sealed: reload open, retry
      const int64_t rows = static_cast<int64_t>(cur_rows(cur));
      const int64_t bytes = static_cast<int64_t>(cur_bytes(cur));
      const int64_t rpcs = static_cast<int64_t>(cur_rpcs(cur));
      if (rows + n > f->max_rows || bytes + kbytes > f->key_cap ||
          rpcs + 1 > f->max_rpcs) {
        // This claim does not fit: seal so the feeder serves what is
        // there, and retry into the rotated slot.
        w.cursor.fetch_or(kClosedBit);
        sealed_here = true;
        break;
      }
      const uint64_t next =
          cur + (1ULL << kRpcsShift) +
          (static_cast<uint64_t>(n) << kRowsShift) +
          static_cast<uint64_t>(kbytes);
      if (w.cursor.compare_exchange_weak(cur, next)) {
        copy_into(w, s, rows, bytes, n, rpcs, conn_token, stream,
                  t_enq_ns);
        const bool first = rows == 0;
        const bool full = rows + n >= f->flush_rows;
        w.committed_rows.fetch_add(n);
        if (full) w.cursor.fetch_or(kClosedBit);
        if (first || full) wake_serve(f);
        if (ring) {
          const int64_t t1 = evr_now_ns();
          evr_record(ring, kEvFeederPack, t1, t1 - t0, n);
        }
        // Stat RMWs LAST: every cf_pack exit path ends in a seq_cst
        // RMW on a feeder counter, which is what lets cf_free's
        // quiesce loads order the delete after every producer access
        // (see cf_free).
        f->packed_rpcs.fetch_add(1);
        f->packed_rows.fetch_add(n);
        return n;
      }
      // CAS lost: `cur` was reloaded by compare_exchange; loop.
    }
    if (sealed_here) wake_serve(f);
    // Brief pause before re-reading the open index: the feeder's
    // rotation is a couple of loads away.
    std::this_thread::yield();
  }
  f->ring_full.fetch_add(1);
  return -2;
}

// Force-seal the open window and wait until every sealed window has
// been served and recycled (tests/bench; NOT part of the serve path).
void cf_flush(void* handle) {
  auto* f = static_cast<Feeder*>(handle);
  // Bounded wait (~5 s): a wedged Python callback must not hang the
  // caller forever; tests assert on the stats either way.  The
  // seal scan repeats INSIDE the wait loop: a producer whose claim
  // landed after one scan (the cf_pack CAS racing the scan's load)
  // is observed and sealed by the next pass, so at quiesce — the
  // teardown contract — no RPC can remain packed-but-unserved.  The
  // serve thread is re-woken every iteration too: a kick consumed by
  // an earlier pass must not strand a window this flush just sealed.
  for (int spins = 0; spins < 5000 && !f->closing.load(); ++spins) {
    bool busy = false;
    for (int64_t i = 0; i < f->n_slots; ++i) {
      CfWindow& w = f->slots[i];
      const uint64_t cur = w.cursor.load();
      if (!(cur & kClosedBit) && cur_rows(cur) != 0) {
        w.cursor.fetch_or(kClosedBit);
        busy = true;
      } else if (cur & kClosedBit) {
        busy = true;
      }
    }
    if (!busy) return;
    wake_serve(f);
    std::this_thread::sleep_for(std::chrono::milliseconds(1));
  }
}

// out13: packed_rpcs, packed_rows, windows, served_rows, ring_full,
// declined, window_errors, open_idx, open_rows, n_slots, max_rows,
// key_cap, max_rpcs (callers may pass a larger zeroed buffer).  The
// clamped shapes are exported so the Python view layer maps EXACTLY
// the allocated capacities (a caller-supplied max_rpcs above the
// cursor field width is clamped here, and a view sized off the raw
// argument would extend past the C allocation).
void cf_stats(void* handle, int64_t* out13) {
  auto* f = static_cast<Feeder*>(handle);
  out13[0] = f->packed_rpcs.load();
  out13[1] = f->packed_rows.load();
  out13[2] = f->windows.load();
  out13[3] = f->served_rows.load();
  out13[4] = f->ring_full.load();
  out13[5] = f->declined.load();
  out13[6] = f->window_errors.load();
  const int64_t open = f->open.load();
  out13[7] = open;
  out13[8] = static_cast<int64_t>(cur_rows(f->slots[open].cursor.load()));
  out13[9] = f->n_slots;
  out13[10] = f->max_rows;
  out13[11] = f->key_cap;
  out13[12] = f->max_rpcs;
}

// Stop the serve thread (drains every claimed window first — pending
// RPCs answer UNAVAILABLE and their tokens are released, so no conn
// leaks and no use-after-free).  The caller must have detached the
// feeder from the h2 server BEFORE stopping (conn threads re-read the
// feeder pointer per RPC), and frees with cf_free AFTER.
void cf_stop(void* handle) {
  auto* f = static_cast<Feeder*>(handle);
  {
    std::lock_guard<std::mutex> lock(f->mu);
    f->callback = nullptr;  // serve-after-stop answers UNAVAILABLE
    f->closing.store(true);
    f->kick.store(true);
    f->cv.notify_all();
  }
  if (f->serve_thread.joinable()) f->serve_thread.join();
}

void cf_free(void* handle) {
  auto* f = static_cast<Feeder*>(handle);
  // Quiesce barrier: every cf_pack exit path ends in a seq_cst RMW on
  // one of these counters, so loading them here synchronizes-with
  // each producer's LAST feeder access — the delete below
  // happens-after all of it.  The caller has already stopped the
  // producers (detach + h2s_stop joins the conn threads); this makes
  // that ordering visible to the memory model (and to TSan) rather
  // than implied through uninstrumented Python joins.
  (void)(f->packed_rpcs.load() + f->packed_rows.load() +
         f->ring_full.load() + f->declined.load());
  // Belt-and-braces: release any token a crashed path left behind.
  for (auto& w : f->slots)
    for (auto& t : w.rpc_token)
      if (t != nullptr) {
        h2s_feeder_release(t);
        t = nullptr;
      }
  delete f;
}

// Microbench entry: `threads` C threads each pack `reps` copies of
// one body — the pure wire→columns line with zero Python anywhere
// (sink mode consumes the windows).  Returns rows successfully
// packed; the ring_full/declined stats separate the fallbacks.
int64_t cf_bench_pack(void* handle, const uint8_t* body, int64_t len,
                      int64_t max_items, int64_t reps, int64_t threads) {
  auto* f = static_cast<Feeder*>(handle);
  if (threads < 1) threads = 1;
  std::atomic<int64_t> packed{0};
  std::vector<std::thread> ts;
  ts.reserve(threads);
  for (int64_t t = 0; t < threads; ++t)
    ts.emplace_back([&, t]() {
      int64_t mine = 0;
      for (int64_t i = 0; i < reps; ++i) {
        int64_t rc = cf_pack(f, body, len, max_items, nullptr, 0, 0);
        while (rc == -2) {
          // Backpressure: in the real front this falls back to the
          // byte path; the bench retries so the number measures pack
          // throughput, not fallback policy.
          std::this_thread::yield();
          rc = cf_pack(f, body, len, max_items, nullptr, 0, 0);
        }
        if (rc > 0) mine += rc;
      }
      packed.fetch_add(mine);
    });
  for (auto& t : ts) t.join();
  cf_flush(f);
  return packed.load();
}

}  // extern "C"
