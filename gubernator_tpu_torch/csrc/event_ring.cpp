// Lock-free fixed-record event ring: the native plane's observability
// tap.  The port's copy of gubernator_tpu/core/native/event_ring.cpp,
// unchanged but for this header; linked into the h2 server library
// (ops/native_build.py SOURCES["h2_server"]).
//
// The C h2 front answers hot-key decisions with zero Python frames (the
// native decision plane) and packs the others into the columnar feeder
// in its connection threads, which made both an observability blind
// spot.  This ring lets the connection, reactor, dispatch and feeder
// threads publish per-stage latency events with NO mutex, NO allocation
// and NO Py* calls, drained by one Python collector thread
// (gubernator_tpu_torch/utils/native_events.py) into histograms and span
// stubs.
//
// Design: a bounded power-of-two ring of 32-byte records with
// per-slot sequence numbers (Vyukov's bounded queue).  Producers are
// the per-connection threads (multi-producer: a CAS claims a slot);
// the consumer is the single Python collector thread.  A full ring
// DROPS the event and counts it — observability must never block or
// backpressure the serve path.  Record publication is a release store
// of the slot sequence; the consumer's acquire load of the same
// sequence is the happens-before edge that makes the record fields'
// relaxed writes visible.

#include <atomic>
#include <chrono>
#include <cstdint>
#include <new>

namespace {

struct EvRecord {
  int64_t kind = 0;    // stage id (gubernator_tpu_torch/utils/native_events.py names them)
  int64_t t_end_ns = 0;  // CLOCK_MONOTONIC ns at event end
  int64_t dur_ns = 0;
  int64_t items = 0;
};

struct EvSlot {
  std::atomic<uint64_t> seq;
  EvRecord rec;
};

struct EvRing {
  uint64_t mask = 0;
  EvSlot* slots = nullptr;
  // Producer claim cursor (multi-producer CAS) and the single
  // consumer's private cursor — the consumer is one Python thread by
  // contract, so `tail` needs no atomicity against other consumers.
  std::atomic<uint64_t> head{0};
  uint64_t tail = 0;
  std::atomic<int64_t> dropped{0};
  std::atomic<int64_t> written{0};
};

}  // namespace

extern "C" {

// Capacity is rounded up to a power of two (min 8).
void* evr_create(int64_t capacity) {
  uint64_t cap = 8;
  while (cap < static_cast<uint64_t>(capacity) && cap < (1u << 24)) cap <<= 1;
  auto* r = new EvRing();
  r->slots = new (std::nothrow) EvSlot[cap];
  if (r->slots == nullptr) {
    delete r;
    return nullptr;
  }
  r->mask = cap - 1;
  for (uint64_t i = 0; i < cap; ++i)
    // guberlint: ok native — pre-publication init; the ring handle is
    // not visible to any producer until evr_create returns.
    r->slots[i].seq.store(i, std::memory_order_relaxed);
  return r;
}

void evr_free(void* handle) {
  auto* r = static_cast<EvRing*>(handle);
  delete[] r->slots;
  delete r;
}

int64_t evr_now_ns() {
  return std::chrono::duration_cast<std::chrono::nanoseconds>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}

// Publish one event; returns 1 written, 0 dropped (ring full).  Never
// blocks, never allocates, never calls Python — callable from the
// conn_loop gil-free root.
// guberlint: gil-free
int64_t evr_record(void* handle, int64_t kind, int64_t t_end_ns,
                   int64_t dur_ns, int64_t items) {
  auto* r = static_cast<EvRing*>(handle);
  // guberlint: ok native — claim cursor: the CAS below is the only
  // synchronizing step producers need; slot visibility rides the
  // seq release/acquire pair, not this load.
  uint64_t head = r->head.load(std::memory_order_relaxed);
  for (;;) {
    EvSlot& s = r->slots[head & r->mask];
    // guberlint: ok native — acquire pairs with the consumer's seq
    // release: observing seq == head proves the slot's previous
    // record was fully consumed before we overwrite it.
    const uint64_t seq = s.seq.load(std::memory_order_acquire);
    const int64_t dif =
        static_cast<int64_t>(seq) - static_cast<int64_t>(head);
    if (dif == 0) {
      // Relaxed CAS: slot ownership, not data publication; the record
      // bytes become visible via the seq release store below.
      if (r->head.compare_exchange_weak(
              head, head + 1,
              std::memory_order_relaxed)) {  // guberlint: ok native — CAS claims the slot; data publication rides the seq release/acquire pair
        s.rec.kind = kind;
        s.rec.t_end_ns = t_end_ns;
        s.rec.dur_ns = dur_ns;
        s.rec.items = items;
        // guberlint: ok native — release publish: pairs with the
        // consumer's acquire load of seq; everything stored to
        // s.rec above happens-before the consumer reading it.
        s.seq.store(head + 1, std::memory_order_release);
        // guberlint: ok native — monotonic stat counter; read by the
        // collector after a drain, ordering irrelevant.
        r->written.fetch_add(1, std::memory_order_relaxed);
        return 1;
      }
    } else if (dif < 0) {
      // Ring full: drop, never block (observability must not
      // backpressure serving).
      // guberlint: ok native — monotonic stat counter, no ordering
      // required.
      r->dropped.fetch_add(1, std::memory_order_relaxed);
      return 0;
    } else {
      // guberlint: ok native — another producer advanced the cursor;
      // reload and retry (same claim-cursor argument as above).
      head = r->head.load(std::memory_order_relaxed);
    }
  }
}

// Drain up to max_records into out (4 int64 per record: kind,
// t_end_ns, dur_ns, items); returns records written.  SINGLE consumer
// by contract (the Python collector thread).
int64_t evr_drain(void* handle, int64_t* out, int64_t max_records) {
  auto* r = static_cast<EvRing*>(handle);
  int64_t n = 0;
  while (n < max_records) {
    EvSlot& s = r->slots[r->tail & r->mask];
    // guberlint: ok native — acquire pairs with the producer's
    // release publish of seq: seeing seq == tail+1 makes the record
    // fields' writes visible to this thread.
    const uint64_t seq = s.seq.load(std::memory_order_acquire);
    if (static_cast<int64_t>(seq) -
            static_cast<int64_t>(r->tail + 1) != 0)
      break;  // slot not yet published
    out[4 * n + 0] = s.rec.kind;
    out[4 * n + 1] = s.rec.t_end_ns;
    out[4 * n + 2] = s.rec.dur_ns;
    out[4 * n + 3] = s.rec.items;
    // guberlint: ok native — release hand-back: pairs with the
    // producer's acquire load; the slot's record reads above
    // happen-before any producer overwrite.
    s.seq.store(r->tail + r->mask + 1, std::memory_order_release);
    ++r->tail;
    ++n;
  }
  return n;
}

// out2 = {written, dropped} (cumulative).
void evr_stats(void* handle, int64_t* out2) {
  auto* r = static_cast<EvRing*>(handle);
  // guberlint: ok native — monotonic stat counters; a torn pair
  // between two scrapes is one event of skew.
  out2[0] = r->written.load(std::memory_order_relaxed);
  // guberlint: ok native — same stat-counter argument as above.
  out2[1] = r->dropped.load(std::memory_order_relaxed);
}

}  // extern "C"
