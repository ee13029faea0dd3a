// Native HTTP/2 gRPC serving front for ONE method: GetRateLimits.
//
// Why: grpc-python costs ~160µs of framework Python per RPC on this
// host (PERF.md §13) — the measured wall for the thundering-herd
// config once the engine work is window-amortized.  This front moves
// everything EXCEPT the engine step out of Python: h2 framing, grpc
// message framing, group-commit windowing, and response encoding run
// in C threads; Python is entered exactly once per WINDOW through a
// ctypes callback that receives the window's concatenated request
// bodies and returns decision columns.
//
// Two connection planes share one frame state machine (PERF.md §26):
//
// - EVENT FRONT (default): a small fixed pool of epoll reactor
//   threads — one per SO_REUSEPORT listener lane, default ncpu−1 so
//   one core stays reserved for the serve/dispatch plane — owns every
//   connection fd through edge-triggered nonblocking I/O.  Per-
//   connection ReadState machines replace per-connection stacks, so
//   the front holds C100K connections in a handful of threads instead
//   of a hundred thousand; egress batches through writev across the
//   queued responses and resumes on EPOLLOUT after short writes.
//   Reads are budgeted per wake (kReadBudget) so one firehose
//   connection cannot monopolize its reactor, and — the §25
//   starvation fix — conn-side CPU load is bounded by the reactor
//   count, so the one Python serve thread can no longer be starved by
//   connection handling.  Idle connections are reaped (GOAWAY +
//   close) after idle_timeout_ms of silence.
//
// - THREAD-PER-CONN (event_front=0): the pre-§26 plane, one detached
//   C thread per connection with blocking reads/writes — kept as the
//   A/B arm and for hosts without epoll.
//
// Scope (deliberate, documented in net/h2_fast.py): a dedicated
// cleartext listener that serves exactly one unary method, so request
// HEADERS need no HPACK decoding at all — header blocks are skipped
// wholesale (the port IS the route), which is what makes the front
// small instead of an HPACK/huffman implementation.  Responses
// use static-table + literal HPACK (no dynamic table, no huffman),
// which every conformant peer accepts.  Requests whose decisions
// cannot be expressed as plain (status, limit, remaining, reset)
// columns are answered UNIMPLEMENTED by the Python callback contract
// and belong on the full gRPC listener.
//
// This file is the port's copy of gubernator_tpu/core/native/h2_server.cpp
// (gubernator_tpu_torch/net/h2_fast.py loads it).  Both connection planes,
// the group-commit window, the early flush at flush_items, the oversized-
// RPC admission, flow control, GOAWAY and the response encode are the
// reference's, unchanged, and so is the native decision plane's probe
// at the top of `serve_rpc` (`dp_try_serve`, decision_plane.cpp, linked
// into the same library; attached with `h2s_attach_plane`): a hot-key
// RPC the plane answers whole never reaches the window queue.  So are
// the columnar feeder's hooks (columnar_feeder.cpp, linked into the same
// library; attached with `h2s_attach_feeder`): an RPC the plane declines
// is packed by `cf_pack` into the feeder's ring of column windows from
// the connection thread, carried by a `FeederToken` and answered by the
// feeder's serve thread through `h2s_feeder_respond`; only an RPC the
// feeder declines (slow-path rows, ring pressure, no feeder attached)
// takes the byte window queue.  `h2s_stats` slots 5 / 6 count the
// feeder's RPCs and items, as the reference's do.  So are the event
// ring's per-stage latency records (event_ring.cpp, linked into the same
// library; attached with `h2s_attach_ring`): the native serve, each RPC's
// window wait, the window callback's wall, and the event front's wake,
// read and write stages, recorded at the reference's sites.
//
// Concatenation trick: protobuf repeated-field semantics mean the
// byte-concatenation of N serialized GetRateLimitsReq messages IS one
// valid GetRateLimitsReq whose `requests` repeat across the inputs —
// so the window's bodies concatenate into ONE decode + ONE engine
// batch with zero per-RPC Python (reference wire contract:
// proto/gubernator.proto).

#include <arpa/inet.h>
#include <fcntl.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <pthread.h>
#include <sched.h>
#include <sys/epoll.h>
#include <sys/eventfd.h>
#include <sys/socket.h>
#include <sys/uio.h>
#include <unistd.h>

#include <algorithm>
#include <atomic>
#include <cerrno>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

#include "hpack.h"

// Native decision plane (decision_plane.cpp, same library): whole-RPC
// hot-key serve inside the connection thread — no interpreter lock, no
// Python frame, no device launch.
extern "C" int64_t dp_try_serve(void* handle, const uint8_t* body,
                                int64_t len, int64_t max_items,
                                int64_t now_ms, uint8_t* out,
                                int64_t out_cap);
// Event ring (event_ring.cpp, same library): lock-free per-stage latency
// tap the connection, reactor and dispatch threads publish into — no
// mutex, no allocation, no Python.
extern "C" int64_t evr_record(void* handle, int64_t kind, int64_t t_end_ns,
                              int64_t dur_ns, int64_t items);
extern "C" int64_t evr_now_ns();
// Columnar feeder plane (columnar_feeder.cpp, same library): wire bytes →
// device-ready columns inside the CALLING thread (a connection thread on
// the threaded plane, a reactor on the event plane — the pack scratch is
// thread_local, so the event plane pays one scratch per reactor instead
// of one per connection); returns packed rows (> 0) or a decline, and
// the byte window path takes over.
extern "C" int64_t cf_pack(void* handle, const uint8_t* body, int64_t len,
                           int64_t max_items, void* conn_token,
                           int64_t stream, int64_t t_enq_ns);

namespace {

constexpr uint8_t kData = 0x0, kHeaders = 0x1, kRst = 0x3, kSettings = 0x4,
                  kPing = 0x6, kGoaway = 0x7, kWindowUpdate = 0x8,
                  kContinuation = 0x9;
constexpr uint8_t kFlagEndStream = 0x1, kFlagAck = 0x1, kFlagEndHeaders = 0x4,
                  kFlagPadded = 0x8;

// Event kinds (gubernator_tpu_torch/utils/native_events.py names them).
constexpr int64_t kEvNativeServe = 1;  // conn/reactor: decode→probe→send
constexpr int64_t kEvWindowWait = 2;   // enqueue → dispatch pickup
constexpr int64_t kEvWindowServe = 3;  // window callback (Python) wall
// 4..6 are the columnar feeder's (columnar_feeder.cpp).
constexpr int64_t kEvReactorWake = 7;   // one epoll wake's processing wall
constexpr int64_t kEvReactorRead = 8;   // one conn's read drain (items=bytes)
constexpr int64_t kEvReactorWrite = 9;  // one writev flush (items=bytes)

// Event-front tuning.  kReadBudget bounds one connection's read drain
// per epoll wake (a firehose client yields the reactor to its lane
// mates and resumes next iteration); kMaxOutBytes bounds the egress
// queue of a client that stops reading (beyond it the conn is dead —
// flow control already bounds DATA, this bounds a peer that granted
// huge windows and then parked); kMaxIov is the writev batch width.
constexpr size_t kReadBudget = 256 * 1024;
constexpr size_t kMaxOutBytes = 8u << 20;
constexpr int kMaxIov = 64;

void put_u24(uint8_t* p, uint32_t v) {
  p[0] = (v >> 16) & 0xff;
  p[1] = (v >> 8) & 0xff;
  p[2] = v & 0xff;
}
void put_u32(uint8_t* p, uint32_t v) {
  p[0] = (v >> 24) & 0xff;
  p[1] = (v >> 16) & 0xff;
  p[2] = (v >> 8) & 0xff;
  p[3] = v & 0xff;
}
uint32_t get_u32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
         (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}
void frame_header(std::string& out, uint32_t len, uint8_t type, uint8_t flags,
                  uint32_t stream) {
  uint8_t h[9];
  put_u24(h, len);
  h[3] = type;
  h[4] = flags;
  put_u32(h + 5, stream);
  out.append(reinterpret_cast<char*>(h), 9);
}

// Protobuf unsigned varint (int64 negatives = 10-byte two's complement).
void put_varint(std::string& out, uint64_t v) {
  while (v >= 0x80) {
    out.push_back(static_cast<char>((v & 0x7f) | 0x80));
    v >>= 7;
  }
  out.push_back(static_cast<char>(v));
}

// Bounded varint read: false on truncation or >64-bit overflow.  The
// length checks below compare against the REMAINING byte count, never
// via pointer arithmetic on attacker-controlled lengths (p + len can
// wrap — a remote-segfault class).
bool read_varint(const uint8_t*& p, const uint8_t* end, uint64_t* out) {
  uint64_t v = 0;
  int shift = 0;
  while (p < end) {
    const uint8_t b = *p++;
    if (shift >= 64) return false;
    v |= uint64_t(b & 0x7f) << shift;
    if (!(b & 0x80)) {
      *out = v;
      return true;
    }
    shift += 7;
  }
  return false;
}

// Count top-level `requests` (field 1, wire type 2) entries in a
// GetRateLimitsReq body; -1 on malformed input.
// guberlint: gil-free
// guberlint: wire GetRateLimitsReq requests=1:len
int64_t count_items(const uint8_t* p, const uint8_t* end) {
  int64_t n = 0;
  while (p < end) {
    uint64_t tag = 0;
    if (!read_varint(p, end, &tag)) return -1;
    const uint32_t field = tag >> 3, wt = tag & 7;
    if (wt == 2) {
      uint64_t len = 0;
      if (!read_varint(p, end, &len)) return -1;
      if (len > static_cast<uint64_t>(end - p)) return -1;
      if (field == 1) ++n;
      p += len;
    } else if (wt == 0) {
      uint64_t skip = 0;
      if (!read_varint(p, end, &skip)) return -1;
    } else if (wt == 5) {
      if (end - p < 4) return -1;
      p += 4;
    } else if (wt == 1) {
      if (end - p < 8) return -1;
      p += 8;
    } else {
      return -1;
    }
  }
  return n;
}

// window callback: Python fills out_cols[4 * total_items] (blocked:
// status | limit | remaining | reset) and out_rpc_status[n_rpcs]
// (0 = serve from the columns; nonzero = answer that RPC with the
// given grpc status, its column lanes ignored — one out-of-scope RPC
// must not fail its window-mates).  body_lens[n_rpcs] gives each
// RPC's byte length within `concat` so Python can re-serve RPCs
// individually when the combined decode declines.  Returns 0, or a
// grpc status code to fail the WHOLE window with (callback crash).
typedef int64_t (*WindowCallback)(const uint8_t* concat, int64_t concat_len,
                                  const int64_t* item_counts,
                                  const int64_t* body_lens, int64_t n_rpcs,
                                  int64_t total_items, int64_t* out_cols,
                                  int64_t* out_rpc_status);

struct Conn;

struct PendingRpc {
  std::shared_ptr<Conn> conn;
  uint32_t stream;
  std::string body;       // grpc-deframed protobuf payload
  int64_t items;
  int64_t t_enq_ns;       // event-ring window-wait anchor (0 = no ring)
};

// Routing mode (h2s_start_routed): one RPC's handler call.  The handler
// answers through h2s_route_reply(token, ...) before it returns; `route`
// is the index of the RPC's :path in the server's route table and
// timeout_ms what is left of its grpc-timeout (0 = none).
typedef void (*RouteCallback)(int64_t route, const uint8_t* body,
                              int64_t len, int64_t timeout_ms, void* token);

struct RoutedRpc {
  std::shared_ptr<Conn> conn;
  uint32_t stream;
  int route;
  std::string body;     // grpc-deframed protobuf payload
  int64_t deadline_ns;  // steady clock; 0 = no grpc-timeout
};

struct Reactor;

// Hand a write-side-killed event-plane conn back to its reactor (a
// parked peer generates no epoll event, so nothing else would ever
// reap it).  Defined after Reactor.
void notify_conn_dead(Conn* c);

struct Server {
  // guberlint: guard queue, queued_items by q_mu
  // guberlint: guard conns by conns_mu
  // SO_REUSEPORT listener lanes: one listen fd per lane, all bound to
  // the same port, so the kernel spreads incoming connections (and
  // therefore framing/decide work) across cores instead of
  // serializing on one accept queue.  On the threaded plane each lane
  // gets an accept thread; on the event plane each lane IS one
  // reactor's accept source.
  std::vector<int> listen_fds;
  int port = 0;
  WindowCallback callback = nullptr;
  int64_t window_us = 2000;
  int64_t max_batch = 16384;
  // Early-flush threshold: dispatch before the window elapses once
  // this many items are queued (an engine-batch-worth; the window
  // exists to amortize tiny RPCs, not to delay full batches).
  int64_t flush_items = 4096;
  int64_t queued_items = 0;  // guarded by q_mu
  std::atomic<bool> closing{false};
  // Event front (PERF.md §26): reactor pool instead of conn threads.
  bool event_front = false;
  int64_t idle_timeout_ms = 0;  // 0 = no idle reaping
  std::vector<std::unique_ptr<Reactor>> reactors;
  std::vector<std::thread> reactor_threads;
  std::vector<std::thread> accept_threads;
  std::thread dispatch_thread;
  std::mutex q_mu;
  std::condition_variable q_cv;
  std::deque<PendingRpc> queue;
  // Optional native decision plane (decision_plane.cpp).  The Python
  // side attaches and detaches it; connection threads load it per RPC,
  // so a detach takes effect at the next request.
  std::atomic<void*> plane{nullptr};
  // Optional event ring (event_ring.cpp), attached like the plane;
  // nullptr = observability off, and the serve paths skip even the
  // clock reads.
  std::atomic<void*> ring{nullptr};
  // Optional columnar feeder plane (columnar_feeder.cpp), attached like
  // the plane; connection threads re-read it per RPC, so a detach takes
  // effect at the next request.
  std::atomic<void*> feeder{nullptr};
  // Stats.
  std::atomic<int64_t> rpcs{0}, windows{0}, errors{0};
  std::atomic<int64_t> native_rpcs{0}, native_items{0};
  std::atomic<int64_t> feeder_rpcs{0}, feeder_items{0};
  std::atomic<int64_t> conns_open{0}, idle_reaped{0};
  // Threaded plane only: shutdown coordinates through the live-conn
  // registry + an active counter (a bounded wait), then joins the
  // connection threads.  They are joinable, not detached: a thread still
  // runs this library's code after its loop ends (the feeder's
  // thread-local scratch is destroyed at thread exit), so only a join
  // orders that exit before h2s_stop returns and before the thread's
  // stack and TLS are reused.  The accept loop joins finished threads
  // before it starts the next one, so a long-lived daemon keeps no
  // unjoined handles across connection churn.  Event-plane conns are
  // owned (and torn down) by their reactor's joinable thread.
  std::atomic<int64_t> active_conns{0};
  std::mutex conns_mu;
  std::condition_variable conns_cv;
  std::vector<std::weak_ptr<Conn>> conns;
  struct ConnThread {
    std::thread thread;
    std::shared_ptr<std::atomic<bool>> done;  // set under conns_mu
  };
  std::vector<ConnThread> conn_threads;  // guarded by conns_mu
  // Routing mode: request headers are decoded (hpack.h), `:path` picks a
  // route, and `route_threads` call the route's handler once per RPC; a
  // path not in `routes` is answered UNIMPLEMENTED here.  The window
  // path (dispatch thread, plane, feeder) is not used in this mode.
  // guberlint: guard rq by rq_mu
  bool routing = false;
  RouteCallback route_cb = nullptr;
  std::vector<std::string> routes;
  std::mutex rq_mu;
  std::condition_variable rq_cv;
  std::deque<RoutedRpc> rq;
  std::vector<std::thread> route_threads;
};

// One response whose DATA is (partially) blocked on the peer's
// send-side flow-control windows (RFC 9113 §5.2): DATA queues here
// until WINDOW_UPDATE / SETTINGS opens the window, trailers follow the
// last DATA chunk.
struct PendingSend {
  uint32_t stream;
  std::string data;     // full DATA payload (grpc-framed message)
  size_t off = 0;       // bytes already sent
  int64_t stream_window;
  std::string trailers;  // pre-framed trailer HEADERS
};

// Per-connection frame-parse state: on the threaded plane this lived
// on the conn thread's stack; the event plane replaces the stack with
// this struct so one reactor can hold thousands of connections
// mid-frame.  Touched ONLY by the owning thread (the conn thread, or
// the one reactor that owns the fd) — never concurrently.
struct ReadState {
  std::vector<uint8_t> buf;
  size_t len = 0;
  size_t preface_seen = 0;
  // Stream table as a flat vector — ids are few and short-lived.
  std::vector<std::pair<uint32_t, std::string>> streams;  // id → body
  // Routing mode only: the connection's HPACK decoder (its dynamic table
  // follows every header block in order), the header block being
  // assembled from HEADERS + CONTINUATION, and each open stream's route
  // (-1 = no such path) and deadline.
  hpack::Decoder hpack;
  std::string hblock;
  uint32_t hstream = 0;
  bool hend_stream = false;
  struct Route {
    uint32_t id;
    int route;
    int64_t deadline_ns;
    std::string path;
  };
  std::vector<Route> routes;
};

struct Conn : std::enable_shared_from_this<Conn> {
  // guberlint: guard conn_send_window, initial_stream_window, blocked, early_credits by write_mu
  // guberlint: guard outq, outq_off, outq_bytes, want_out by write_mu
  int fd;
  // Event plane: the owning reactor's epoll fd (−1 = threaded plane).
  // Set once before the fd is published to the reactor; read by the
  // write path (any thread) to pick nonblocking egress + EPOLLOUT
  // arming over blocking sends.
  int epfd = -1;
  Reactor* rx = nullptr;  // owning reactor (death notification)
  std::mutex write_mu;
  std::atomic<bool> dead{false};
  int64_t recv_since_update = 0;
  // Idle-reaping clock (event plane): monotonic ns of the last read
  // activity.  Written by the owning reactor, read by its sweep.
  std::atomic<int64_t> last_activity_ns{0};
  ReadState rs;
  // Peer's receive allowance for OUR sends (guarded by write_mu):
  // connection-level window plus the initial per-stream window from
  // the peer's SETTINGS.  Responses only move inside these.
  int64_t conn_send_window = 65535;
  int64_t initial_stream_window = 65535;
  std::deque<PendingSend> blocked;
  // Event-plane egress queue: wire bytes accepted by the framing
  // layer but not yet by the socket.  Flushed via writev (batched
  // across queued responses); a short write leaves the tail here and
  // arms EPOLLOUT for resumption.
  std::deque<std::string> outq;
  size_t outq_off = 0;    // bytes of outq.front() already written
  size_t outq_bytes = 0;  // total queued (backpressure cap)
  bool want_out = false;  // EPOLLOUT armed
  // WINDOW_UPDATE credit that arrived BEFORE the stream's response was
  // queued (the client may grant window while the request is still in
  // the dispatch queue) — it must not be dropped or the response can
  // stall forever under a zero initial window.  Bounded: streams are
  // short-lived; oldest entries are shed past the cap.
  std::vector<std::pair<uint32_t, int64_t>> early_credits;
  static constexpr size_t kMaxEarlyCredits = 128;

  int64_t take_early_credit(uint32_t stream) {  // guberlint: holds write_mu
    for (size_t i = 0; i < early_credits.size(); ++i)
      if (early_credits[i].first == stream) {
        const int64_t c = early_credits[i].second;
        early_credits.erase(early_credits.begin() + i);
        return c;
      }
    return 0;
  }

  explicit Conn(int f) : fd(f) {}
  ~Conn() {
    if (fd >= 0) ::close(fd);
  }

  // Threaded-plane write-through: loop until the socket took it all.
  bool send_blocking_locked(const std::string& buf) {
    const uint8_t* p = reinterpret_cast<const uint8_t*>(buf.data());
    size_t n = buf.size();
    while (n) {
      // guberlint: ok native — threaded-plane branch only (epfd < 0
      // gates it out of every reactor path): the write path
      // serializes on write_mu by design (responses must not
      // interleave frames); the send is bounded by the socket buffer,
      // and a stalled peer flips `dead` so the conn tears down
      // instead of convoying its server threads.
      ssize_t w = ::send(fd, p, n, MSG_NOSIGNAL);
      if (w <= 0) {
        dead.store(true);
        return false;
      }
      p += w;
      n -= static_cast<size_t>(w);
    }
    return true;
  }

  // Arm/disarm EPOLLOUT on the owning reactor.  epoll_ctl is
  // thread-safe, so the dispatch/feeder threads can arm from their
  // own context; a conn already removed from the epoll set fails
  // ENOENT harmlessly (its fd stays open until the last shared_ptr
  // drops, so the fd cannot be reused out from under a late MOD).
  void arm_out_locked() {  // guberlint: holds write_mu
    if (want_out || epfd < 0) return;
    epoll_event ev{};
    ev.events = EPOLLIN | EPOLLOUT | EPOLLET | EPOLLRDHUP;
    ev.data.fd = fd;
    if (epoll_ctl(epfd, EPOLL_CTL_MOD, fd, &ev) == 0) want_out = true;
  }
  void disarm_out_locked() {  // guberlint: holds write_mu
    if (!want_out || epfd < 0) return;
    epoll_event ev{};
    ev.events = EPOLLIN | EPOLLET | EPOLLRDHUP;
    ev.data.fd = fd;
    epoll_ctl(epfd, EPOLL_CTL_MOD, fd, &ev);
    want_out = false;
  }

  // Event-plane egress: writev as much of outq as the socket takes,
  // batched across queued responses; EAGAIN leaves the tail queued
  // and arms EPOLLOUT.  Returns false only when the conn died.
  bool flush_out_locked() {  // guberlint: holds write_mu
    while (!outq.empty()) {
      struct iovec iov[kMaxIov];
      int niov = 0;
      size_t off = outq_off;
      for (auto it = outq.begin(); it != outq.end() && niov < kMaxIov;
           ++it) {
        iov[niov].iov_base = const_cast<char*>(it->data()) + off;
        iov[niov].iov_len = it->size() - off;
        off = 0;
        ++niov;
      }
      const ssize_t w = ::writev(fd, iov, niov);
      if (w < 0) {
        if (errno == EINTR) continue;
        if (errno == EAGAIN || errno == EWOULDBLOCK) {
          arm_out_locked();
          break;
        }
        dead.store(true);
        notify_conn_dead(this);
        return false;
      }
      size_t left = static_cast<size_t>(w);
      outq_bytes -= left;
      while (left) {
        const size_t head = outq.front().size() - outq_off;
        if (left >= head) {
          left -= head;
          outq.pop_front();
          outq_off = 0;
        } else {
          outq_off += left;
          left = 0;
        }
      }
    }
    if (outq.empty()) disarm_out_locked();
    return true;
  }

  // By value: rvalue call sites (framed temporaries — the common
  // case) MOVE into the egress queue instead of deep-copying every
  // response's wire bytes per send.
  bool send_locked(std::string buf) {  // guberlint: holds write_mu
    if (epfd < 0) return send_blocking_locked(buf);
    if (outq_bytes + buf.size() > kMaxOutBytes) {
      // Backpressure kill: the peer granted window but stopped
      // reading — unbounded queueing would let one parked client
      // hold the server's memory.  The reactor must be TOLD (a
      // parked peer fires no epoll event) or the fd + 8MB of queue
      // would sit until the idle sweep, or forever with reaping off.
      dead.store(true);
      notify_conn_dead(this);
      return false;
    }
    outq_bytes += buf.size();
    outq.push_back(std::move(buf));
    return flush_out_locked();
  }

  bool send_all(std::string buf) {
    std::lock_guard<std::mutex> lock(write_mu);
    return send_locked(std::move(buf));
  }

  // Drain blocked responses in FIFO preference as far as the windows
  // allow — but a stream whose OWN window is exhausted must not
  // head-of-line block later streams that still have credit (streams
  // are independent; only the connection window is shared).  DATA is
  // chunked to the default max frame size; a response's trailers go
  // out only once its DATA fully drained.
  void pump_locked() {
    for (auto it = blocked.begin(); it != blocked.end() && !dead.load();) {
      PendingSend& p = *it;
      bool stream_blocked = false;
      while (p.off < p.data.size()) {
        if (conn_send_window <= 0) return;  // shared window: stop all
        const int64_t allow = std::min(conn_send_window, p.stream_window);
        if (allow <= 0) {  // this stream only: try the next one
          stream_blocked = true;
          break;
        }
        size_t chunk = std::min(
            {static_cast<size_t>(allow), p.data.size() - p.off,
             static_cast<size_t>(16384)});
        std::string out;
        frame_header(out, static_cast<uint32_t>(chunk), kData, 0,
                     p.stream);
        out.append(p.data, p.off, chunk);
        if (!send_locked(std::move(out))) return;
        conn_send_window -= static_cast<int64_t>(chunk);
        p.stream_window -= static_cast<int64_t>(chunk);
        p.off += chunk;
      }
      if (stream_blocked) {
        ++it;
        continue;
      }
      send_locked(std::move(p.trailers));  // entry erased next
      it = blocked.erase(it);
    }
  }

  // Full response path: HEADERS immediately (not flow-controlled),
  // DATA+trailers through the window-aware queue.
  bool send_response(uint32_t stream, const std::string& hdr,
                     std::string data, const std::string& trailers) {
    std::lock_guard<std::mutex> lock(write_mu);
    if (!send_locked(hdr)) return false;
    PendingSend p;
    p.stream = stream;
    p.data = std::move(data);
    p.stream_window = initial_stream_window + take_early_credit(stream);
    p.trailers = trailers;
    blocked.push_back(std::move(p));
    pump_locked();
    return !dead.load();
  }

  void window_update(uint32_t stream, uint32_t inc) {
    std::lock_guard<std::mutex> lock(write_mu);
    if (stream == 0) {
      conn_send_window += inc;
    } else {
      bool found = false;
      for (auto& p : blocked)
        if (p.stream == stream) {
          p.stream_window += inc;
          found = true;
        }
      if (!found) {
        // The response is not queued yet: bank the credit.
        for (auto& ec : early_credits)
          if (ec.first == stream) {
            ec.second += inc;
            found = true;
            break;
          }
        if (!found) {
          if (early_credits.size() >= kMaxEarlyCredits)
            early_credits.erase(early_credits.begin());
          early_credits.emplace_back(stream, inc);
        }
      }
    }
    pump_locked();
  }

  void set_initial_window(int64_t v) {
    std::lock_guard<std::mutex> lock(write_mu);
    const int64_t delta = v - initial_stream_window;
    initial_stream_window = v;
    // RFC 9113 §6.9.2: a SETTINGS change adjusts all open streams.
    for (auto& p : blocked) p.stream_window += delta;
    pump_locked();
  }

  void drop_stream_sends(uint32_t stream) {
    std::lock_guard<std::mutex> lock(write_mu);
    for (auto it = blocked.begin(); it != blocked.end();)
      it = (it->stream == stream) ? blocked.erase(it) : it + 1;
    take_early_credit(stream);
  }
};

// Response header block: :status 200 (static 8) + content-type
// application/grpc (literal w/o indexing, static name 31).
std::string resp_headers_block() {
  std::string b;
  b.push_back(static_cast<char>(0x88));
  b.push_back(static_cast<char>(0x0f));
  b.push_back(static_cast<char>(0x10));
  b.push_back(static_cast<char>(16));
  b.append("application/grpc");
  return b;
}

// Trailer block: grpc-status (literal name) = given code.
std::string trailers_block(int code) {
  std::string b;
  b.push_back(static_cast<char>(0x00));
  b.push_back(static_cast<char>(11));
  b.append("grpc-status");
  const std::string v = std::to_string(code);
  b.push_back(static_cast<char>(v.size()));
  b.append(v);
  return b;
}

// The grpc-framed message payload of a success response (the DATA
// frame's payload; framing happens window-chunked in Conn::pump_locked).
// guberlint: gil-free
// guberlint: wire GetRateLimitsResp responses=1:len
// guberlint: wire RateLimitResp status=1:varint limit=2:varint remaining=3:varint reset_time=4:varint
std::string build_data_payload(const int64_t* cols, int64_t offset,
                               int64_t k, int64_t total) {
  // GetRateLimitsResp{ repeated RateLimitResp responses = 1 }
  std::string pb;
  for (int64_t i = 0; i < k; ++i) {
    std::string item;
    const int64_t st = cols[0 * total + offset + i];
    const int64_t li = cols[1 * total + offset + i];
    const int64_t re = cols[2 * total + offset + i];
    const int64_t rt = cols[3 * total + offset + i];
    if (st) {
      item.push_back(0x08);
      put_varint(item, static_cast<uint64_t>(st));
    }
    if (li) {
      item.push_back(0x10);
      put_varint(item, static_cast<uint64_t>(li));
    }
    if (re) {
      item.push_back(0x18);
      put_varint(item, static_cast<uint64_t>(re));
    }
    if (rt) {
      item.push_back(0x20);
      put_varint(item, static_cast<uint64_t>(rt));
    }
    pb.push_back(0x0a);
    put_varint(pb, item.size());
    pb += item;
  }
  std::string data;
  data.push_back(0);  // uncompressed
  uint8_t len4[4];
  put_u32(len4, static_cast<uint32_t>(pb.size()));
  data.append(reinterpret_cast<char*>(len4), 4);
  data += pb;
  return data;
}

// One RPC's full response from a pre-built grpc-framed DATA payload:
// HEADERS immediately, then DATA under the peer's send-side
// flow-control windows, trailers after the DATA.
void send_rpc_payload(const std::shared_ptr<Conn>& conn, uint32_t stream,
                      std::string data, int grpc_status) {
  static const std::string kHdr = resp_headers_block();
  std::string hdr;
  frame_header(hdr, static_cast<uint32_t>(kHdr.size()), kHeaders,
               kFlagEndHeaders, stream);
  hdr += kHdr;
  const std::string tr_block = trailers_block(grpc_status);
  std::string tr;
  frame_header(tr, static_cast<uint32_t>(tr_block.size()), kHeaders,
               kFlagEndHeaders | kFlagEndStream, stream);
  tr += tr_block;
  if (grpc_status == 0) {
    conn->send_response(stream, hdr, std::move(data), tr);
  } else {
    // Error replies carry no DATA — headers-only frames are exempt
    // from flow control.
    conn->send_all(hdr + tr);
  }
}

void send_rpc_response(const std::shared_ptr<Conn>& conn, uint32_t stream,
                       const int64_t* cols, int64_t offset, int64_t k,
                       int64_t total, int grpc_status) {
  send_rpc_payload(conn, stream,
                   grpc_status == 0
                       ? build_data_payload(cols, offset, k, total)
                       : std::string(),
                   grpc_status);
}

static const char kPreface[] = "PRI * HTTP/2.0\r\n\r\nSM\r\n\r\n";

std::string& stream_body(ReadState& rs, uint32_t id) {
  for (auto& kv : rs.streams)
    if (kv.first == id) return kv.second;
  rs.streams.emplace_back(id, std::string());
  return rs.streams.back().second;
}
void drop_stream(ReadState& rs, uint32_t id) {
  for (size_t i = 0; i < rs.streams.size(); ++i)
    if (rs.streams[i].first == id) {
      rs.streams.erase(rs.streams.begin() + i);
      return;
    }
}

int64_t steady_ns() {
  return std::chrono::duration_cast<std::chrono::nanoseconds>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}

// Routing mode's reply: a success is HEADERS, the message in DATA under
// the peer's flow-control windows, then trailers with grpc-status 0; an
// error is one trailers-only HEADERS frame with grpc-status and
// grpc-message (percent-encoded, cut to 4 KiB so the block fits a frame).
void send_routed(const std::shared_ptr<Conn>& conn, uint32_t stream,
                 int status, const std::string& msg, const uint8_t* body,
                 size_t len) {
  static const std::string kHdr = resp_headers_block();
  std::string tb;
  hpack::encode_header(tb, "grpc-status", std::to_string(status));
  if (!msg.empty())
    hpack::encode_header(tb, "grpc-message",
                         hpack::percent_encode(msg.substr(0, 4096)));
  if (status != 0) {
    const std::string block = kHdr + tb;
    std::string f;
    frame_header(f, static_cast<uint32_t>(block.size()), kHeaders,
                 kFlagEndHeaders | kFlagEndStream, stream);
    f += block;
    conn->send_all(std::move(f));
    return;
  }
  std::string hdr;
  frame_header(hdr, static_cast<uint32_t>(kHdr.size()), kHeaders,
               kFlagEndHeaders, stream);
  hdr += kHdr;
  std::string tr;
  frame_header(tr, static_cast<uint32_t>(tb.size()), kHeaders,
               kFlagEndHeaders | kFlagEndStream, stream);
  tr += tb;
  std::string data;
  data.push_back(0);  // uncompressed
  uint8_t len4[4];
  put_u32(len4, static_cast<uint32_t>(len));
  data.append(reinterpret_cast<char*>(len4), 4);
  data.append(reinterpret_cast<const char*>(body), len);
  conn->send_response(stream, hdr, std::move(data), tr);
}

ReadState::Route* find_route(ReadState& rs, uint32_t id) {
  for (auto& r : rs.routes)
    if (r.id == id) return &r;
  return nullptr;
}

void drop_route(ReadState& rs, uint32_t id) {
  for (size_t i = 0; i < rs.routes.size(); ++i)
    if (rs.routes[i].id == id) {
      rs.routes.erase(rs.routes.begin() + i);
      return;
    }
}

// A complete header block of stream `id` (routing mode): the first one
// names the route and the deadline; a later one (request trailers) is
// decoded only to keep the dynamic table in step.  false is a
// COMPRESSION_ERROR.
bool on_request_headers(Server* srv, ReadState& rs, uint32_t id) {
  std::vector<hpack::Header> hs;
  if (!rs.hpack.decode(reinterpret_cast<const uint8_t*>(rs.hblock.data()),
                       rs.hblock.size(), &hs))
    return false;
  if (find_route(rs, id) != nullptr) return true;
  ReadState::Route r{id, -1, 0, std::string()};
  for (const auto& h : hs) {
    if (h.name == ":path") {
      r.path = h.value;
    } else if (h.name == "grpc-timeout") {
      const int64_t ns = hpack::parse_grpc_timeout(h.value);
      if (ns > 0) r.deadline_ns = steady_ns() + ns;
    }
  }
  for (size_t i = 0; i < srv->routes.size(); ++i)
    if (srv->routes[i] == r.path) r.route = static_cast<int>(i);
  rs.routes.push_back(std::move(r));
  return true;
}

// A request's end (routing mode): queue it for its handler, or answer it
// here — UNIMPLEMENTED for a path with no route, INTERNAL for a body
// that is not one uncompressed grpc message.
// guberlint: gil-free
void route_rpc(Server* srv, const std::shared_ptr<Conn>& conn,
               uint32_t stream, const std::string& body) {
  ReadState& rs = conn->rs;
  ReadState::Route* r = find_route(rs, stream);
  if (r == nullptr || r->route < 0) {
    send_routed(conn, stream, 12,
                "Method not found: " + (r ? r->path : std::string()),
                nullptr, 0);
    srv->errors.fetch_add(1);
  } else if (body.size() < 5 || body[0] != 0 ||
             5 + static_cast<size_t>(get_u32(
                     reinterpret_cast<const uint8_t*>(body.data()) + 1)) !=
                 body.size()) {
    send_routed(conn, stream, 13, "malformed grpc message frame", nullptr,
                0);
    srv->errors.fetch_add(1);
  } else {
    std::lock_guard<std::mutex> lock(srv->rq_mu);
    srv->rq.push_back(
        RoutedRpc{conn, stream, r->route, body.substr(5), r->deadline_ns});
    srv->rq_cv.notify_one();
  }
  drop_route(rs, stream);
}

// HEADERS / CONTINUATION in routing mode: assemble the block, decode it
// at END_HEADERS, and end the request when the block carries END_STREAM.
// false is a connection error.
bool route_header_frame(Server* srv, const std::shared_ptr<Conn>& conn,
                        uint8_t type, uint8_t flags, uint32_t stream,
                        const uint8_t* p, uint32_t len) {
  ReadState& rs = conn->rs;
  if (type == kHeaders) {
    if (rs.hstream != 0 || stream == 0) return false;
    uint32_t off = 0, pad = 0;
    if (flags & kFlagPadded) {
      if (len < 1) return false;
      pad = p[0];
      off = 1;
    }
    if (flags & 0x20) off += 5;  // PRIORITY
    if (off + pad > len) return false;
    rs.hblock.assign(reinterpret_cast<const char*>(p + off), len - off - pad);
    rs.hstream = stream;
    rs.hend_stream = (flags & kFlagEndStream) != 0;
  } else {
    if (rs.hstream == 0 || stream != rs.hstream ||
        rs.hblock.size() + len > (1u << 20))
      return false;
    rs.hblock.append(reinterpret_cast<const char*>(p), len);
  }
  if (!(flags & kFlagEndHeaders)) return true;
  const uint32_t id = rs.hstream;
  rs.hstream = 0;
  const bool ok = on_request_headers(srv, rs, id);
  rs.hblock.clear();
  if (!ok) return false;
  std::string& body = stream_body(rs, id);
  if (rs.hend_stream) {
    route_rpc(srv, conn, id, body);
    drop_stream(rs, id);
  }
  return true;
}

// Opaque per-RPC handle the columnar feeder carries from pack to
// response scatter: keeps the Conn alive (shared_ptr) and remembers the
// server for stats.  Allocated here on a successful pack, consumed by
// h2s_feeder_respond / h2s_feeder_release.
struct FeederToken {
  std::shared_ptr<Conn> conn;
  Server* srv;
};

// One fully-deframed RPC body: native-plane probe → feeder pack → byte
// window queue, in that order of preference — the per-RPC pipeline both
// connection planes share.  Runs on the conn thread (threaded plane) or
// the owning reactor (event plane); never touches Python.
// guberlint: gil-free
void serve_rpc(Server* srv, const std::shared_ptr<Conn>& conn,
               uint32_t stream, std::string body, int64_t items) {
  // Native decision plane: hot-key RPCs answer right here, in this
  // thread — no queue, no window wait, no Python.  Any decline (cold
  // key, fall-through row, out-of-scope behavior) goes on to the feeder.
  void* ring = srv->ring.load();
  const int64_t t0 = ring ? evr_now_ns() : 0;
  void* plane = srv->plane.load();
  if (plane != nullptr && items > 0) {
    std::string resp;
    // Sized for the retry-hint encode (dp_set_hints): 4 varint fields
    // + one metadata entry per item.
    resp.resize(static_cast<size_t>(items) * 96 + 16);
    const int64_t m = dp_try_serve(
        plane, reinterpret_cast<const uint8_t*>(body.data()),
        static_cast<int64_t>(body.size()), items, -1,
        reinterpret_cast<uint8_t*>(&resp[0]),
        static_cast<int64_t>(resp.size()));
    if (m >= 0) {
      resp.resize(static_cast<size_t>(m));
      std::string data;
      data.push_back(0);  // uncompressed grpc frame
      uint8_t len4[4];
      put_u32(len4, static_cast<uint32_t>(resp.size()));
      data.append(reinterpret_cast<char*>(len4), 4);
      data += resp;
      send_rpc_payload(conn, stream, std::move(data), 0);
      srv->rpcs.fetch_add(1);
      srv->native_rpcs.fetch_add(1);
      srv->native_items.fetch_add(items);
      if (ring) {
        const int64_t t1 = evr_now_ns();
        evr_record(ring, kEvNativeServe, t1, t1 - t0, items);
      }
      return;
    }
  }
  // Columnar feeder: the RPC packs straight into the device-ready
  // window ring from THIS thread — the decode, the key hashes and the
  // column append run here, in parallel across lanes, instead of
  // serially in the dispatch thread.  Any decline (slow-path rows, ring
  // backpressure) drops to the byte window path unchanged.
  if (items > 0) {
    void* feeder = srv->feeder.load();
    if (feeder != nullptr) {
      auto* token = new FeederToken{conn, srv};
      const int64_t fr = cf_pack(
          feeder, reinterpret_cast<const uint8_t*>(body.data()),
          static_cast<int64_t>(body.size()), items, token, stream,
          ring ? (t0 ? t0 : evr_now_ns()) : 0);
      if (fr > 0) {
        srv->feeder_items.fetch_add(fr);
        return;  // the feeder's serve thread answers it
      }
      delete token;  // on a decline the token stays the caller's
    }
  }
  std::lock_guard<std::mutex> lock(srv->q_mu);
  srv->queue.push_back(PendingRpc{conn, stream, std::move(body), items, t0});
  srv->queued_items += items;
  srv->q_cv.notify_one();
}

// The shared frame machine: consume complete preface bytes + frames
// from conn->rs, route deframed RPCs through serve_rpc, and leave any
// partial frame buffered for the next read.  Both connection planes
// feed it — blocking recv loops on the threaded plane, budgeted
// nonblocking drains on the reactors — so partial and coalesced reads
// hit identical code.
// guberlint: gil-free
void process_input(Server* srv, const std::shared_ptr<Conn>& conn) {
  ReadState& rs = conn->rs;
  size_t pos = 0;
  // Preface bytes first.
  while (rs.preface_seen < 24 && pos < rs.len) {
    if (static_cast<char>(rs.buf[pos]) != kPreface[rs.preface_seen]) {
      conn->dead.store(true);
      return;
    }
    ++pos;
    ++rs.preface_seen;
  }
  // Frames.
  for (;;) {
    if (conn->dead.load()) break;
    if (rs.len - pos < 9) break;
    const uint8_t* f = rs.buf.data() + pos;
    const uint32_t flen =
        (uint32_t(f[0]) << 16) | (uint32_t(f[1]) << 8) | f[2];
    if (flen > (1u << 20)) {  // far beyond our advertised 16KB max
      conn->dead.store(true);
      break;
    }
    if (rs.len - pos < 9 + flen) break;
    const uint8_t type = f[3], flags = f[4];
    const uint32_t stream = get_u32(f + 5) & 0x7fffffff;
    const uint8_t* payload = f + 9;
    if (srv->routing && rs.hstream != 0 && type != kContinuation) {
      conn->dead.store(true);  // a header block must not be interleaved
      break;
    }
    switch (type) {
      case kSettings:
        if (!(flags & kFlagAck)) {
          // Honor the peer's send-side windows: INITIAL_WINDOW_SIZE
          // (id 4) caps how much response DATA each stream may carry
          // before a WINDOW_UPDATE (RFC 9113 §6.5.2, §6.9.2).
          for (uint32_t off = 0; off + 6 <= flen; off += 6) {
            const uint16_t id =
                (uint16_t(payload[off]) << 8) | payload[off + 1];
            const uint32_t val = get_u32(payload + off + 2);
            if (id == 0x4) {
              if (val > 0x7fffffffu) {  // FLOW_CONTROL_ERROR
                conn->dead.store(true);
                break;
              }
              conn->set_initial_window(static_cast<int64_t>(val));
            }
          }
          if (conn->dead.load()) break;
          std::string s;
          frame_header(s, 0, kSettings, kFlagAck, 0);
          conn->send_all(s);
        }
        break;
      case kPing:
        if (!(flags & kFlagAck) && flen == 8) {
          std::string s;
          frame_header(s, 8, kPing, kFlagAck, 0);
          s.append(reinterpret_cast<const char*>(payload), 8);
          conn->send_all(s);
        }
        break;
      case kHeaders:
      case kContinuation: {
        if (srv->routing) {
          if (!route_header_frame(srv, conn, type, flags, stream, payload,
                                  flen))
            conn->dead.store(true);
          break;
        }
        // Single-method port: header CONTENT is irrelevant (the
        // port is the route); only END_STREAM matters (a request
        // with no body ends here — answer UNIMPLEMENTED).
        stream_body(rs, stream);
        if (flags & kFlagEndStream) {
          send_rpc_response(conn, stream, nullptr, 0, 0, 0, 12);
          drop_stream(rs, stream);
        }
        break;
      }
      case kData: {
        // PADDED flag: first payload byte is the pad length, pad
        // bytes trail — both must be stripped or they corrupt the
        // grpc message body.
        const uint8_t* dp = payload;
        uint32_t dlen = flen;
        if (flags & kFlagPadded) {
          if (dlen < 1) {
            conn->dead.store(true);
            break;
          }
          const uint8_t pad = dp[0];
          ++dp;
          --dlen;
          if (pad > dlen) {
            conn->dead.store(true);
            break;
          }
          dlen -= pad;
        }
        std::string& st_body = stream_body(rs, stream);
        if (st_body.size() + dlen > (4u << 20)) {
          // No legitimate rate-limit request is megabytes long —
          // cap per-stream buffering (DoS guard) and drop the conn.
          conn->dead.store(true);
          break;
        }
        st_body.append(reinterpret_cast<const char*>(dp), dlen);
        conn->recv_since_update += flen;  // flow control counts raw
        if ((flags & kFlagEndStream) && srv->routing) {
          route_rpc(srv, conn, stream, st_body);
          drop_stream(rs, stream);
        } else if (flags & kFlagEndStream) {
          // grpc frame: 1-byte compressed flag + u32 length + body.
          if (st_body.size() < 5 || st_body[0] != 0) {
            send_rpc_response(conn, stream, nullptr, 0, 0, 0, 13);
          } else {
            const uint32_t mlen = get_u32(
                reinterpret_cast<const uint8_t*>(st_body.data()) + 1);
            if (5 + mlen > st_body.size()) {
              send_rpc_response(conn, stream, nullptr, 0, 0, 0, 13);
            } else {
              std::string body = st_body.substr(5, mlen);
              const int64_t items = count_items(
                  reinterpret_cast<const uint8_t*>(body.data()),
                  reinterpret_cast<const uint8_t*>(body.data()) +
                      body.size());
              if (items < 0 || items > 1000) {
                send_rpc_response(conn, stream, nullptr, 0, 0, 0, 13);
              } else {
                serve_rpc(srv, conn, stream, std::move(body), items);
              }
            }
          }
          drop_stream(rs, stream);
        }
        // Replenish the connection-level receive window.
        if (conn->recv_since_update >= 1 << 14) {
          std::string s;
          frame_header(s, 4, kWindowUpdate, 0, 0);
          uint8_t inc[4];
          put_u32(inc, static_cast<uint32_t>(conn->recv_since_update));
          s.append(reinterpret_cast<char*>(inc), 4);
          conn->send_all(s);
          conn->recv_since_update = 0;
        }
        break;
      }
      case kRst:
        drop_stream(rs, stream);
        if (srv->routing) drop_route(rs, stream);
        conn->drop_stream_sends(stream);
        break;
      case kGoaway:
        conn->dead.store(true);
        break;
      case kWindowUpdate: {
        if (flen != 4) {
          conn->dead.store(true);
          break;
        }
        const uint32_t inc = get_u32(payload) & 0x7fffffff;
        if (inc == 0) {  // PROTOCOL_ERROR per RFC 9113 §6.9
          conn->dead.store(true);
          break;
        }
        conn->window_update(stream, inc);
        break;
      }
      default:
        break;
    }
    pos += 9 + flen;
  }
  if (pos) {
    std::memmove(rs.buf.data(), rs.buf.data() + pos, rs.len - pos);
    rs.len -= pos;
  }
}

// The initial server SETTINGS: INITIAL_WINDOW_SIZE 4MB so request
// bodies up to the body cap never stall on per-stream flow control
// (we do not send per-stream WINDOW_UPDATEs), MAX_FRAME_SIZE stays
// default 16KB.
std::string initial_settings() {
  std::string s;
  frame_header(s, 6, kSettings, 0, 0);
  uint8_t entry[6] = {0x00, 0x04, 0x00, 0x40, 0x00, 0x00};  // id=4, 4MiB
  s.append(reinterpret_cast<char*>(entry), 6);
  return s;
}

// The threaded-plane per-connection serve loop: blocking recv into
// the conn's ReadState, frames through the shared machine.  The
// zero-GIL guarantee of the native fast path (PERF.md §20) is checked
// here: nothing reachable from this loop may call Python C-API or the
// window callback trampoline — queueing to the dispatch thread (which
// DOES re-enter Python) is the only bridge, and it is data, not a
// call.
// guberlint: gil-free
void conn_loop(Server* srv, std::shared_ptr<Conn> conn) {
  ReadState& rs = conn->rs;
  rs.buf.resize(1 << 16);
  if (!conn->send_all(initial_settings())) return;
  while (!srv->closing.load() && !conn->dead.load()) {
    if (rs.len == rs.buf.size()) rs.buf.resize(rs.buf.size() * 2);
    ssize_t r = ::recv(conn->fd, rs.buf.data() + rs.len,
                       rs.buf.size() - rs.len, 0);
    if (r <= 0) break;
    rs.len += static_cast<size_t>(r);
    process_input(srv, conn);
  }
  conn->dead.store(true);
}

void dispatch_loop(Server* srv) {
  while (!srv->closing.load()) {
    std::vector<PendingRpc> batch;
    {
      std::unique_lock<std::mutex> lock(srv->q_mu);
      srv->q_cv.wait(lock, [&] {
        return srv->closing.load() || !srv->queue.empty();
      });
      if (srv->closing.load()) return;
      // Group-commit window with EARLY FLUSH: wait up to window_us for
      // concurrent arrivals, but dispatch as soon as an engine-batch-
      // worth of items is queued — large-batch RPCs should not pay
      // the window that exists to amortize tiny ones.  The running
      // counter keeps the predicate O(1) per producer notify.
      if (srv->queued_items < srv->flush_items) {
        const auto deadline = std::chrono::steady_clock::now() +
                              std::chrono::microseconds(srv->window_us);
        srv->q_cv.wait_until(lock, deadline, [&] {
          return srv->closing.load() ||
                 srv->queued_items >= srv->flush_items;
        });
        if (srv->closing.load()) return;
      }
    }
    int64_t total = 0;
    {
      std::lock_guard<std::mutex> lock(srv->q_mu);
      // Always admit the FIRST queued RPC even when it alone exceeds
      // max_batch: leaving it at the queue head would never drain it,
      // starving every later RPC and busy-spinning this thread
      // (reachable whenever max_batch is configured below the
      // 1000-item per-RPC cap).
      while (!srv->queue.empty() &&
             (batch.empty() ||
              total + srv->queue.front().items <= srv->max_batch)) {
        total += srv->queue.front().items;
        srv->queued_items -= srv->queue.front().items;
        batch.push_back(std::move(srv->queue.front()));
        srv->queue.pop_front();
      }
    }
    if (batch.empty()) continue;
    std::string concat;
    std::vector<int64_t> counts;
    counts.reserve(batch.size());
    for (auto& rpc : batch) {
      concat += rpc.body;
      counts.push_back(rpc.items);
    }
    std::vector<int64_t> cols(static_cast<size_t>(4 * total), 0);
    std::vector<int64_t> rpc_status(batch.size(), 0);
    std::vector<int64_t> body_lens;
    body_lens.reserve(batch.size());
    for (auto& rpc : batch)
      body_lens.push_back(static_cast<int64_t>(rpc.body.size()));
    void* ring = srv->ring.load();
    const int64_t t_cb = ring ? evr_now_ns() : 0;
    if (ring) {
      // One window-wait event per RPC: enqueue → dispatch pickup is the
      // group-commit wait a fall-through decision pays.
      for (auto& rpc : batch)
        if (rpc.t_enq_ns)
          evr_record(ring, kEvWindowWait, t_cb, t_cb - rpc.t_enq_ns,
                     rpc.items);
    }
    const int64_t rc = srv->callback(
        reinterpret_cast<const uint8_t*>(concat.data()),
        static_cast<int64_t>(concat.size()), counts.data(),
        body_lens.data(), static_cast<int64_t>(batch.size()), total,
        cols.data(), rpc_status.data());
    if (ring) {
      const int64_t t1 = evr_now_ns();
      evr_record(ring, kEvWindowServe, t1, t1 - t_cb, total);
    }
    srv->windows.fetch_add(1);
    int64_t offset = 0;
    size_t ridx = 0;
    for (auto& rpc : batch) {
      const int64_t st = (rc != 0) ? rc : rpc_status[ridx++];
      if (rpc.conn->dead.load()) {
        offset += rpc.items;
        continue;
      }
      if (st == 0) {
        send_rpc_response(rpc.conn, rpc.stream, cols.data(), offset,
                          rpc.items, total, 0);
        srv->rpcs.fetch_add(1);
      } else {
        send_rpc_response(rpc.conn, rpc.stream, nullptr, 0, 0, 0,
                          static_cast<int>(st));
        srv->errors.fetch_add(1);
      }
      offset += rpc.items;
    }
  }
}

void accept_loop(Server* srv, int listen_fd) {
  while (!srv->closing.load()) {
    sockaddr_in peer{};
    socklen_t plen = sizeof(peer);
    int fd = ::accept(listen_fd, reinterpret_cast<sockaddr*>(&peer),
                      &plen);
    if (fd < 0) {
      if (srv->closing.load()) return;
      continue;
    }
    int one = 1;
    setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
    auto conn = std::make_shared<Conn>(fd);
    {
      std::lock_guard<std::mutex> lock(srv->conns_mu);
      // Prune registry entries for connections long gone.
      srv->conns.erase(
          std::remove_if(srv->conns.begin(), srv->conns.end(),
                         [](const std::weak_ptr<Conn>& w) {
                           return w.expired();
                         }),
          srv->conns.end());
      srv->conns.push_back(conn);
    }
    srv->active_conns.fetch_add(1);
    srv->conns_open.fetch_add(1);
    auto done = std::make_shared<std::atomic<bool>>(false);
    std::thread t([srv, conn, done]() {
      conn_loop(srv, conn);
      srv->conns_open.fetch_sub(1);
      srv->active_conns.fetch_sub(1);
      std::lock_guard<std::mutex> lock(srv->conns_mu);
      done->store(true);
      srv->conns_cv.notify_all();
    });
    std::vector<std::thread> finished;
    {
      std::lock_guard<std::mutex> lock(srv->conns_mu);
      auto& threads = srv->conn_threads;
      for (auto& ct : threads)
        if (ct.done->load()) finished.push_back(std::move(ct.thread));
      threads.erase(std::remove_if(threads.begin(), threads.end(),
                                   [](const Server::ConnThread& ct) {
                                     return !ct.thread.joinable();
                                   }),
                    threads.end());
      threads.push_back({std::move(t), std::move(done)});
    }
    // Their loops have ended: each join waits only for the thread's exit.
    for (auto& f : finished) f.join();
  }
}

// ---------------------------------------------------------------------
// Event front (PERF.md §26).

struct Reactor {
  // guberlint: guard dead_fds by dead_mu
  int epfd = -1;
  int wake_fd = -1;   // eventfd: h2s_stop (and the write-side death
                      // notifier) kick a parked epoll_wait
  int listen_fd = -1;
  // Accept pause (EMFILE/ENFILE backoff): the listen fd is level-
  // triggered, so an un-accepted pending connection would otherwise
  // re-fire every wake and busy-spin the reactor exactly when fds
  // run out.  Paused = removed from the epoll set until the deadline.
  int64_t accept_paused_until_ns = 0;
  // Connections killed by the WRITE side (backpressure cap, writev
  // failure) from the dispatch/feeder threads: a parked peer
  // generates no epoll event, so the killer enqueues the fd here and
  // kicks wake_fd; the owning reactor drops them next wake.
  std::mutex dead_mu;
  std::vector<int> dead_fds;
  // The destructor owns epfd/wake_fd: a partial h2s_start failure
  // (fd exhaustion on a later lane) or h2s_stop's delete both
  // release them through ~Reactor — no separate close bookkeeping
  // to miss.  listen_fd belongs to srv->listen_fds.
  ~Reactor() {
    if (epfd >= 0) ::close(epfd);
    if (wake_fd >= 0) ::close(wake_fd);
  }
  // Owned connections, keyed by fd.  Reactor-thread-only: every
  // insert/lookup/erase happens on the owning reactor, so the map
  // needs no lock (cross-thread writers touch only Conn's mutex-
  // guarded write side and arm EPOLLOUT via the thread-safe
  // epoll_ctl).  Named `owned`, not `conns`: Server.conns is the
  // mutex-guarded registry and the native pass matches receivers
  // textually.
  std::unordered_map<int, std::shared_ptr<Conn>> owned;
  // Read-budget carryover: conns whose socket still held data when
  // their per-wake budget ran out; re-drained before the next
  // epoll_wait so edge-triggered reads never stall.
  std::vector<std::shared_ptr<Conn>> pending;
  int64_t last_sweep_ns = 0;
};

void notify_conn_dead(Conn* c) {
  Reactor* rx = c->rx;
  if (rx == nullptr) return;
  {
    std::lock_guard<std::mutex> lock(rx->dead_mu);
    rx->dead_fds.push_back(c->fd);
  }
  uint64_t one = 1;
  const ssize_t r = ::write(rx->wake_fd, &one, sizeof(one));
  (void)r;
}

void reactor_drop(Server* srv, Reactor* rx, int fd) {
  auto it = rx->owned.find(fd);
  if (it == rx->owned.end()) return;
  it->second->dead.store(true);
  epoll_ctl(rx->epfd, EPOLL_CTL_DEL, fd, nullptr);
  // Off the open count before the peer can see the close.
  srv->conns_open.fetch_sub(1);
  // shutdown (not close): the fd must stay allocated until the last
  // shared_ptr drops — the dispatch/feeder threads may still hold
  // this conn, and a recycled fd number under a late EPOLLOUT arm
  // would hit a stranger's socket.  ~Conn closes it.
  ::shutdown(fd, SHUT_RDWR);
  rx->owned.erase(it);
}

// Accept every pending connection on this reactor's lane (edge-
// triggered listen fd: drain until EAGAIN).  Sockets are born
// nonblocking (SOCK_NONBLOCK) — the reactor never blocks in recv/
// send/writev on them.
void reactor_accept(Server* srv, Reactor* rx) {
  for (;;) {
    int fd = ::accept4(rx->listen_fd, nullptr, nullptr, SOCK_NONBLOCK);
    if (fd < 0) {
      if (errno == EINTR || errno == ECONNABORTED) continue;
      if (errno == EMFILE || errno == ENFILE || errno == ENOBUFS ||
          errno == ENOMEM) {
        // fd exhaustion: the pending connection was NOT consumed and
        // the listen fd is level-triggered, so leaving it in the
        // epoll set would re-fire every wake and busy-spin this
        // reactor at exactly the moment the box is out of fds.
        // Pause: deregister and retry after a beat.
        epoll_ctl(rx->epfd, EPOLL_CTL_DEL, rx->listen_fd, nullptr);
        rx->accept_paused_until_ns = evr_now_ns() + 100000000;
      }
      return;  // EAGAIN (drained) or closing
    }
    int one = 1;
    setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
    auto conn = std::make_shared<Conn>(fd);
    conn->epfd = rx->epfd;
    conn->rx = rx;
    conn->last_activity_ns.store(evr_now_ns());
    // Small initial parse buffer: C100K idle connections must not
    // cost 64KB each (the threaded plane's sizing); it grows on
    // demand and shrinks when drained.
    conn->rs.buf.resize(4096);
    {
      std::lock_guard<std::mutex> lock(srv->conns_mu);
      // Prune only when the registry has clearly outgrown the live
      // set — a per-accept full prune is O(conns) and would make a
      // 10k-connection ramp quadratic.
      if (srv->conns.size() >
          static_cast<size_t>(srv->conns_open.load()) * 2 + 64) {
        srv->conns.erase(
            std::remove_if(srv->conns.begin(), srv->conns.end(),
                           [](const std::weak_ptr<Conn>& w) {
                             return w.expired();
                           }),
            srv->conns.end());
      }
      srv->conns.push_back(conn);
    }
    srv->conns_open.fetch_add(1);
    rx->owned[fd] = conn;
    epoll_event ev{};
    ev.events = EPOLLIN | EPOLLET | EPOLLRDHUP;
    ev.data.fd = fd;
    if (epoll_ctl(rx->epfd, EPOLL_CTL_ADD, fd, &ev) != 0) {
      reactor_drop(srv, rx, fd);
      continue;
    }
    conn->send_all(initial_settings());
  }
}

// Budgeted edge-triggered read drain: pull bytes until EAGAIN or the
// per-wake budget is spent, running the frame machine after every
// chunk so responses start before the drain finishes.  A budget-
// exhausted conn goes on the carryover list — the reactor services
// its lane mates first, then returns, so a firehose cannot starve
// the lane (or, transitively, the serve plane).
void reactor_read(Server* srv, Reactor* rx,
                  const std::shared_ptr<Conn>& conn) {
  void* ring = srv->ring.load();
  const int64_t t0 = ring ? evr_now_ns() : 0;
  ReadState& rs = conn->rs;
  size_t budget = kReadBudget;
  int64_t got = 0;
  bool more = false;
  while (!conn->dead.load()) {
    if (rs.len == rs.buf.size())
      rs.buf.resize(std::max<size_t>(4096, rs.buf.size() * 2));
    const ssize_t r = ::recv(conn->fd, rs.buf.data() + rs.len,
                             rs.buf.size() - rs.len, MSG_DONTWAIT);
    if (r > 0) {
      rs.len += static_cast<size_t>(r);
      got += r;
      process_input(srv, conn);
      if (budget <= static_cast<size_t>(r)) {
        more = true;  // budget spent; resume after lane mates
        break;
      }
      budget -= static_cast<size_t>(r);
      continue;
    }
    if (r == 0) {
      conn->dead.store(true);
    } else if (errno != EAGAIN && errno != EWOULDBLOCK &&
               errno != EINTR) {
      conn->dead.store(true);
    }
    break;  // EAGAIN: drained
  }
  if (got > 0) {
    conn->last_activity_ns.store(evr_now_ns());
    if (ring) {
      const int64_t t1 = evr_now_ns();
      evr_record(ring, kEvReactorRead, t1, t1 - t0, got);
    }
    // Shrink a drained burst buffer: idle connections must not pin
    // the high-water mark.
    if (rs.len == 0 && rs.buf.size() > (64u << 10)) {
      rs.buf.resize(4096);
      rs.buf.shrink_to_fit();
    }
  }
  if (more && !conn->dead.load()) rx->pending.push_back(conn);
}

// EPOLLOUT: resume the writev flush a short write parked, then let
// flow control queue whatever the freed socket room now admits.
// Recorded as the reactor.write stage (items = bytes moved this
// resumption) — the backpressure path, not the common inline flush.
void reactor_flush(Server* srv, const std::shared_ptr<Conn>& conn) {
  void* ring = srv->ring.load();
  const int64_t t0 = ring ? evr_now_ns() : 0;
  int64_t moved = 0;
  {
    std::lock_guard<std::mutex> lock(conn->write_mu);
    const size_t before = conn->outq_bytes;
    if (conn->flush_out_locked()) conn->pump_locked();
    moved = static_cast<int64_t>(before) -
            static_cast<int64_t>(conn->outq_bytes);
  }
  if (ring) {
    const int64_t t1 = evr_now_ns();
    evr_record(ring, kEvReactorWrite, t1, t1 - t0, moved);
  }
}

// Idle reaping: connections silent past idle_timeout_ms get a GOAWAY
// and the axe.  The pre-§26 front held dead client connections
// forever (nothing ever read EOF on a silent socket); at C100K that
// is a slow fd leak.
void reactor_sweep_idle(Server* srv, Reactor* rx, int64_t now_ns) {
  const int64_t cutoff = now_ns - srv->idle_timeout_ms * 1000000;
  std::vector<int> doomed;
  for (auto& kv : rx->owned)
    if (kv.second->last_activity_ns.load() < cutoff)
      doomed.push_back(kv.first);
  for (int fd : doomed) {
    auto it = rx->owned.find(fd);
    if (it == rx->owned.end()) continue;
    // Counted before the GOAWAY goes out: a client that reads it and
    // the close finds the reap (and the open count) already booked.
    srv->idle_reaped.fetch_add(1);
    std::string g;
    frame_header(g, 8, kGoaway, 0, 0);
    g.append(8, '\0');  // last-stream-id 0, NO_ERROR
    it->second->send_all(g);
    reactor_drop(srv, rx, fd);
  }
}

// The reactor loop: one epoll owns this lane's listen fd plus every
// connection accepted from it.  Everything the threaded plane did per
// connection — deframe, native-plane probe, feeder pack, byte-window
// queue, response framing — runs here through the same shared frame
// machine, across ALL the lane's connections, in one thread.
// guberlint: gil-free
// guberlint: epoll-root
void reactor_loop(Server* srv, Reactor* rx) {
  epoll_event evs[256];
  while (!srv->closing.load()) {
    // Carryover work pending ⇒ poll without sleeping; otherwise park
    // briefly (bounded so `closing` and the idle sweep stay live).
    const int timeout_ms = rx->pending.empty() ? 200 : 0;
    const int n = epoll_wait(rx->epfd, evs, 256, timeout_ms);
    if (n < 0) {
      if (errno == EINTR) continue;
      break;
    }
    void* ring = srv->ring.load();
    const int64_t t0 = ring ? evr_now_ns() : 0;
    for (int i = 0; i < n; ++i) {
      const int fd = evs[i].data.fd;
      if (fd == rx->listen_fd) {
        reactor_accept(srv, rx);
        continue;
      }
      if (fd == rx->wake_fd) {
        uint64_t junk;
        const ssize_t r = ::read(rx->wake_fd, &junk, sizeof(junk));
        (void)r;
        continue;
      }
      auto it = rx->owned.find(fd);
      if (it == rx->owned.end()) continue;  // dropped earlier this wake
      std::shared_ptr<Conn> conn = it->second;
      if (evs[i].events & (EPOLLHUP | EPOLLERR)) conn->dead.store(true);
      if (!conn->dead.load() && (evs[i].events & EPOLLOUT))
        reactor_flush(srv, conn);
      if (!conn->dead.load() &&
          (evs[i].events & (EPOLLIN | EPOLLRDHUP)))
        reactor_read(srv, rx, conn);
      if (conn->dead.load()) reactor_drop(srv, rx, fd);
    }
    if (!rx->pending.empty()) {
      std::vector<std::shared_ptr<Conn>> again;
      again.swap(rx->pending);
      for (auto& conn : again) {
        if (!conn->dead.load()) reactor_read(srv, rx, conn);
        if (conn->dead.load()) reactor_drop(srv, rx, conn->fd);
      }
    }
    {
      // Write-side deaths (backpressure cap / writev failure from
      // the dispatch or feeder threads): a parked peer fires no
      // epoll event, so the killers queue the fd and kick wake_fd.
      std::vector<int> doomed;
      {
        std::lock_guard<std::mutex> lock(rx->dead_mu);
        doomed.swap(rx->dead_fds);
      }
      for (int fd : doomed) reactor_drop(srv, rx, fd);
    }
    const int64_t t_now = evr_now_ns();
    if (rx->accept_paused_until_ns != 0 &&
        t_now >= rx->accept_paused_until_ns) {
      rx->accept_paused_until_ns = 0;
      epoll_event ev{};
      ev.events = EPOLLIN;
      ev.data.fd = rx->listen_fd;
      epoll_ctl(rx->epfd, EPOLL_CTL_ADD, rx->listen_fd, &ev);
      reactor_accept(srv, rx);  // drain whatever queued while paused
    }
    if (srv->idle_timeout_ms > 0 &&
        t_now - rx->last_sweep_ns >
            std::min<int64_t>(srv->idle_timeout_ms * 250000,
                              1000000000)) {
      rx->last_sweep_ns = t_now;
      reactor_sweep_idle(srv, rx, t_now);
    }
    if (ring && n > 0) {
      const int64_t t1 = evr_now_ns();
      evr_record(ring, kEvReactorWake, t1, t1 - t0, n);
    }
  }
  // Teardown: this thread owns every conn it accepted — drop them
  // all before joining (no detached-thread drain needed on this
  // plane).
  std::vector<int> fds;
  fds.reserve(rx->owned.size());
  for (auto& kv : rx->owned) fds.push_back(kv.first);
  for (int fd : fds) reactor_drop(srv, rx, fd);
}

// Routing mode's handler pool: each thread takes one queued RPC at a
// time and calls its route's handler, which replies through
// h2s_route_reply; an RPC whose grpc-timeout passed while it queued is
// answered DEADLINE_EXCEEDED without a call, and a handler that returns
// without replying gets INTERNAL.
struct RouteToken {
  std::shared_ptr<Conn> conn;
  uint32_t stream;
  Server* srv;
  bool replied;
};

void route_loop(Server* srv) {
  for (;;) {
    RoutedRpc rpc;
    {
      std::unique_lock<std::mutex> lock(srv->rq_mu);
      srv->rq_cv.wait(lock, [&] {
        return srv->closing.load() || !srv->rq.empty();
      });
      if (srv->closing.load()) return;
      rpc = std::move(srv->rq.front());
      srv->rq.pop_front();
    }
    if (rpc.conn->dead.load()) continue;
    int64_t timeout_ms = 0;
    if (rpc.deadline_ns != 0) {
      const int64_t left = rpc.deadline_ns - steady_ns();
      if (left <= 0) {
        send_routed(rpc.conn, rpc.stream, 4, "Deadline Exceeded", nullptr, 0);
        srv->errors.fetch_add(1);
        continue;
      }
      timeout_ms = std::max<int64_t>(1, left / 1000000);
    }
    RouteToken token{rpc.conn, rpc.stream, srv, false};
    srv->route_cb(rpc.route, reinterpret_cast<const uint8_t*>(rpc.body.data()),
                  static_cast<int64_t>(rpc.body.size()), timeout_ms, &token);
    if (!token.replied) {
      send_routed(rpc.conn, rpc.stream, 13, "handler sent no reply", nullptr,
                  0);
      srv->errors.fetch_add(1);
    }
  }
}

// Bind `lanes` listeners on host:port (0 = ephemeral) and start the
// connection plane: reactors (event_front) or accept threads.  false
// when nothing could be bound; the caller deletes the server then.
bool start_listeners(Server* srv, in_addr host, int32_t port, int32_t lanes,
                     int32_t reactors) {
  const long ncpu = sysconf(_SC_NPROCESSORS_ONLN);
  if (srv->event_front) {
    if (reactors <= 0)
      reactors = static_cast<int32_t>(std::max(1L, ncpu - 1));
    lanes = reactors;
  }
  if (lanes < 1) lanes = 1;
  int bind_port = port;
  if (lanes > 1 && port != 0) {
    // SO_REUSEPORT lets ANOTHER daemon of the same uid silently share
    // a fixed port (the kernel would split traffic across two
    // independent engines — over-admission with no error anywhere).
    // Probe-bind without it first so a foreign listener still fails
    // loudly with EADDRINUSE; ephemeral binds can't collide.
    int probe = ::socket(AF_INET, SOCK_STREAM, 0);
    if (probe < 0) return false;
    int one = 1;
    setsockopt(probe, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
    sockaddr_in addr{};
    addr.sin_family = AF_INET;
    addr.sin_port = htons(static_cast<uint16_t>(port));
    addr.sin_addr = host;
    const bool free_port =
        ::bind(probe, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) == 0;
    ::close(probe);
    if (!free_port) return false;
  }
  for (int32_t lane = 0; lane < lanes; ++lane) {
    int fd = ::socket(AF_INET, SOCK_STREAM, 0);
    if (fd < 0) break;
    int one = 1;
    setsockopt(fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
    if (lanes > 1)
      setsockopt(fd, SOL_SOCKET, SO_REUSEPORT, &one, sizeof(one));
    sockaddr_in addr{};
    addr.sin_family = AF_INET;
    addr.sin_port = htons(static_cast<uint16_t>(bind_port));
    addr.sin_addr = host;
    if (::bind(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) != 0 ||
        ::listen(fd, 1024) != 0) {
      ::close(fd);
      break;
    }
    if (lane == 0) {
      // Ephemeral binds learn the port from lane 0; the remaining
      // lanes bind it explicitly.
      socklen_t alen = sizeof(addr);
      getsockname(fd, reinterpret_cast<sockaddr*>(&addr), &alen);
      srv->port = ntohs(addr.sin_port);
      bind_port = srv->port;
    }
    srv->listen_fds.push_back(fd);
  }
  if (srv->listen_fds.empty()) return false;
  if (srv->event_front) {
    for (int fd : srv->listen_fds) {
      // The reactors accept-until-EAGAIN; the listen fds must be
      // nonblocking or a spurious wake parks the whole lane.
      const int fl = fcntl(fd, F_GETFL, 0);
      fcntl(fd, F_SETFL, fl | O_NONBLOCK);
      auto rx = std::make_unique<Reactor>();
      rx->listen_fd = fd;
      rx->epfd = epoll_create1(0);
      rx->wake_fd = eventfd(0, EFD_NONBLOCK);
      if (rx->epfd < 0 || rx->wake_fd < 0) {
        // ~Reactor releases rx's and every earlier lane's epfd/
        // wake_fd (delete srv destroys srv->reactors).
        for (int lf : srv->listen_fds) ::close(lf);
        return false;
      }
      epoll_event ev{};
      ev.events = EPOLLIN;
      ev.data.fd = fd;
      epoll_ctl(rx->epfd, EPOLL_CTL_ADD, fd, &ev);
      ev.events = EPOLLIN;
      ev.data.fd = rx->wake_fd;
      epoll_ctl(rx->epfd, EPOLL_CTL_ADD, rx->wake_fd, &ev);
      srv->reactors.push_back(std::move(rx));
    }
    for (auto& rx : srv->reactors)
      srv->reactor_threads.emplace_back(reactor_loop, srv, rx.get());
    if (ncpu > 1 &&
        static_cast<long>(srv->reactor_threads.size()) <= ncpu - 1) {
      // Reserved serve core (best-effort — gVisor/containers may
      // refuse affinity): reactors live on cpus 1..n−1, leaving cpu0
      // for the dispatch/Python serve plane so conn-side load cannot
      // starve the window path (the §25 tail).
      cpu_set_t set;
      CPU_ZERO(&set);
      for (long c = 1; c < ncpu; ++c) CPU_SET(c, &set);
      for (auto& t : srv->reactor_threads)
        pthread_setaffinity_np(t.native_handle(), sizeof(set), &set);
    }
  } else {
    for (int fd : srv->listen_fds)
      srv->accept_threads.emplace_back(accept_loop, srv, fd);
  }
  return true;
}

}  // namespace

extern "C" {

// Start the front on 127.0.0.1:port (0 = ephemeral).
//
// event_front != 0 (the default plane, PERF.md §26): `reactors`
// epoll reactor threads (0 = ncpu−1, min 1), one per SO_REUSEPORT
// listener lane, own all connection fds; `lanes` is ignored (lanes ≡
// reactors there).  idle_timeout_ms > 0 reaps connections silent
// that long (GOAWAY + close).  When ncpu > 1 the reactor threads are
// pinned off cpu0 (best-effort) so the serve/dispatch plane keeps a
// reserved core — the §25 starvation fix.
//
// event_front == 0: the thread-per-connection plane with `lanes`
// SO_REUSEPORT accept lanes (degrades to fewer if a lane fails to
// bind; at least one always exists).
//
// Returns an opaque handle, or nullptr on bind failure.
void* h2s_start(int32_t port, int64_t window_us, int64_t max_batch,
                int64_t flush_items, int32_t lanes, int32_t event_front,
                int32_t reactors, int64_t idle_timeout_ms,
                WindowCallback callback) {
  auto* srv = new Server();
  srv->callback = callback;
  srv->window_us = window_us;
  srv->max_batch = max_batch;
  if (flush_items > 0) srv->flush_items = flush_items;
  srv->event_front = event_front != 0;
  if (idle_timeout_ms > 0) srv->idle_timeout_ms = idle_timeout_ms;
  in_addr loopback{};
  inet_pton(AF_INET, "127.0.0.1", &loopback);
  if (!start_listeners(srv, loopback, port, lanes, reactors)) {
    delete srv;
    return nullptr;
  }
  srv->dispatch_thread = std::thread(dispatch_loop, srv);
  return srv;
}

// Start the routing mode on host:port (0 = ephemeral; host an IPv4
// address, "" or "0.0.0.0" every interface).  `routes` is the
// newline-separated route table: an RPC whose :path is line i goes to
// `callback` with route i on one of `workers` handler threads.  The
// connections take h2s_start's threaded plane, one accept lane (a node's
// peers and clients hold few, long-lived connections).  Returns nullptr
// on a bind failure.
void* h2s_start_routed(const char* host, int32_t port, const char* routes,
                       int32_t workers, RouteCallback callback) {
  in_addr addr{};
  const std::string h = host;
  if (h.empty()) {
    addr.s_addr = htonl(INADDR_ANY);
  } else if (inet_pton(AF_INET, h.c_str(), &addr) != 1) {
    return nullptr;
  }
  auto* srv = new Server();
  srv->routing = true;
  srv->route_cb = callback;
  const std::string table = routes;
  for (size_t pos = 0; pos <= table.size();) {
    const size_t nl = std::min(table.find('\n', pos), table.size());
    if (nl > pos) srv->routes.push_back(table.substr(pos, nl - pos));
    pos = nl + 1;
  }
  srv->event_front = false;
  if (!start_listeners(srv, addr, port, 1, 0)) {
    delete srv;
    return nullptr;
  }
  for (int32_t i = 0; i < std::max<int32_t>(1, workers); ++i)
    srv->route_threads.emplace_back(route_loop, srv);
  return srv;
}

// A handler's reply (routing mode), once per RPC from inside the
// handler call: grpc status 0 sends `body` as the response message, any
// other status the trailers-only error with `msg` as grpc-message.
void h2s_route_reply(void* token, int32_t status, const char* msg,
                     int64_t msg_len, const uint8_t* body, int64_t len) {
  auto* t = static_cast<RouteToken*>(token);
  if (t->replied) return;
  t->replied = true;
  if (t->conn->dead.load()) return;
  send_routed(t->conn, t->stream, status,
              std::string(msg, static_cast<size_t>(msg_len)), body,
              static_cast<size_t>(len));
  (status == 0 ? t->srv->rpcs : t->srv->errors).fetch_add(1);
}

int32_t h2s_lanes(void* handle) {
  return static_cast<int32_t>(
      static_cast<Server*>(handle)->listen_fds.size());
}

int32_t h2s_reactors(void* handle) {
  return static_cast<int32_t>(
      static_cast<Server*>(handle)->reactors.size());
}

int32_t h2s_port(void* handle) {
  return static_cast<Server*>(handle)->port;
}

// out: [0] rpcs, [1] windows, [2] errors, [3] native_rpcs,
// [4] native_items, [5] feeder_rpcs, [6] feeder_items,
// [7] conns_open, [8] idle_reaped, [9] reactors, [10] event_front
// (callers may pass a larger zeroed buffer; only the first eleven
// slots are written).
void h2s_stats(void* handle, int64_t* out) {
  auto* srv = static_cast<Server*>(handle);
  out[0] = srv->rpcs.load();
  out[1] = srv->windows.load();
  out[2] = srv->errors.load();
  out[3] = srv->native_rpcs.load();
  out[4] = srv->native_items.load();
  out[5] = srv->feeder_rpcs.load();
  out[6] = srv->feeder_items.load();
  out[7] = srv->conns_open.load();
  out[8] = srv->idle_reaped.load();
  out[9] = static_cast<int64_t>(srv->reactors.size());
  out[10] = srv->event_front ? 1 : 0;
}

// Attach (or detach with nullptr) a decision plane created by
// dp_create.  The plane must outlive the server's connection threads:
// the Python side detaches before h2s_stop and frees after it.
void h2s_attach_plane(void* handle, void* plane) {
  static_cast<Server*>(handle)->plane.store(plane);
}

// Attach (or detach with nullptr) an event ring created by evr_create.
// Same lifetime contract as the plane: the ring must outlive the
// server's threads; the Python side detaches before h2s_stop and frees
// after it.
void h2s_attach_ring(void* handle, void* ring) {
  static_cast<Server*>(handle)->ring.store(ring);
}

// Attach (or detach with nullptr) a columnar feeder created by
// cf_create.  Lifetime contract: detach here FIRST, then cf_stop
// (drains in-flight windows, releasing their conn tokens), then
// h2s_stop, then cf_free — conn threads re-read the pointer per RPC, so
// a detach takes effect at the next request.
void h2s_attach_feeder(void* handle, void* feeder) {
  static_cast<Server*>(handle)->feeder.store(feeder);
}

// Response scatter bridge (called by the feeder's serve thread): wrap
// one RPC's protobuf payload in a grpc frame and send it through the
// connection's flow-control-aware write path; consumes the token.
void h2s_feeder_respond(void* conn_token, int64_t stream,
                        const uint8_t* payload, int64_t len,
                        int32_t grpc_status) {
  auto* token = static_cast<FeederToken*>(conn_token);
  if (token == nullptr) return;
  // The counters follow the byte window path's (dispatch_loop): a dead
  // connection counts nothing, an error counts only into `errors`, a
  // success only into `rpcs` — so errors / rpcs means the same with the
  // feeder on and off.
  if (!token->conn->dead.load()) {
    std::string data;
    if (grpc_status == 0) {
      data.push_back(0);  // uncompressed grpc frame
      uint8_t len4[4];
      put_u32(len4, static_cast<uint32_t>(len));
      data.append(reinterpret_cast<char*>(len4), 4);
      data.append(reinterpret_cast<const char*>(payload),
                  static_cast<size_t>(len));
    }
    send_rpc_payload(token->conn, static_cast<uint32_t>(stream),
                     std::move(data), grpc_status);
    if (grpc_status == 0) {
      // feeder_rpcs first: a reader that has seen `rpcs` reach a count
      // sees every feeder RPC in it.
      token->srv->feeder_rpcs.fetch_add(1);
      token->srv->rpcs.fetch_add(1);
    } else {
      token->srv->errors.fetch_add(1);
    }
  }
  delete token;
}

// Teardown-side token release: free without sending (the feeder was
// stopped with windows still claimed — cf_free walks them).
void h2s_feeder_release(void* conn_token) {
  delete static_cast<FeederToken*>(conn_token);
}

void h2s_stop(void* handle) {
  auto* srv = static_cast<Server*>(handle);
  srv->closing.store(true);
  srv->plane.store(nullptr);
  srv->ring.store(nullptr);
  srv->feeder.store(nullptr);
  for (int fd : srv->listen_fds) {
    ::shutdown(fd, SHUT_RDWR);
    ::close(fd);
  }
  // Kick parked reactors; each drops its owned conns on loop exit and
  // its thread is joinable — the event plane needs no detached-thread
  // drain.
  for (auto& rx : srv->reactors) {
    uint64_t one = 1;
    const ssize_t r = ::write(rx->wake_fd, &one, sizeof(one));
    (void)r;
  }
  for (auto& t : srv->reactor_threads)
    if (t.joinable()) t.join();
  {
    std::lock_guard<std::mutex> lock(srv->q_mu);
    srv->q_cv.notify_all();
  }
  {
    std::lock_guard<std::mutex> lock(srv->rq_mu);
    srv->rq_cv.notify_all();
  }
  for (auto& t : srv->route_threads)
    if (t.joinable()) t.join();
  for (auto& t : srv->accept_threads)
    if (t.joinable()) t.join();
  if (srv->dispatch_thread.joinable()) srv->dispatch_thread.join();
  std::vector<Server::ConnThread> conn_threads;
  {
    // Threaded-plane conn threads block in recv(); shut their sockets
    // down, then wait (bounded) for their loops to end.
    std::unique_lock<std::mutex> lock(srv->conns_mu);
    for (auto& w : srv->conns)
      if (auto c = w.lock()) {
        c->dead.store(true);
        ::shutdown(c->fd, SHUT_RDWR);
      }
    srv->conns_cv.wait_for(lock, std::chrono::seconds(5), [&] {
      return srv->active_conns.load() == 0;
    });
    // The accept threads are joined: nothing adds to the list now.
    if (srv->active_conns.load() != 0) {
      // Leak over use-after-free: the stragglers keep the server.
      for (auto& ct : srv->conn_threads) ct.thread.detach();
      return;
    }
    conn_threads.swap(srv->conn_threads);
  }
  for (auto& ct : conn_threads) ct.thread.join();
  delete srv;
}

}  // extern "C"
