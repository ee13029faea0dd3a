// The port's copy of gubernator_tpu/core/native/h2_client.cpp, unchanged
// below this note: the closed-loop unary h2 load client
// (gubernator_tpu_torch/core/h2_client.py), which drives the h2 front
// where no grpcio client exists.
//
// Minimal HTTP/2 gRPC *client* load loop.
//
// Purpose: measure the SERVER's per-RPC capacity without charging the
// measurement for grpc-python client overhead.  On this one-core host
// client and server share the CPU; a grpc-python closed loop costs
// ~250µs/RPC of client-side Python per call, which caps any herd
// measurement near the combined floor no matter how fast the server
// is.  This loop plays the wrk/ghz role (the reference benchmarks its
// server with Go clients that cost ~nothing relative to Python:
// reference README.md:97-104): a closed-loop unary gRPC client in
// ~500 lines of plain sockets + hand-rolled h2 framing.
//
// Scope (deliberate): unary RPCs over cleartext h2 on loopback, one
// in-flight stream per connection, tiny payloads, static-table-only
// HPACK on the request side, zero HPACK decoding on the response side
// (only frame boundaries and END_STREAM matter to the loop).  PING,
// SETTINGS, GOAWAY and both flow-control windows are handled; anything
// else unexpected closes and reconnects.
//
// C ABI via ctypes like the sibling files (no pybind11 in the image).

#include <arpa/inet.h>
#include <netdb.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/epoll.h>
#include <sys/socket.h>
#include <unistd.h>

#include <atomic>
#include <cerrno>
#include <chrono>
#include <cstdint>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

using Clock = std::chrono::steady_clock;

constexpr uint8_t kFrameData = 0x0;
constexpr uint8_t kFrameHeaders = 0x1;
constexpr uint8_t kFrameRst = 0x3;
constexpr uint8_t kFrameSettings = 0x4;
constexpr uint8_t kFramePing = 0x6;
constexpr uint8_t kFrameGoaway = 0x7;
constexpr uint8_t kFrameWindowUpdate = 0x8;
constexpr uint8_t kFlagEndStream = 0x1;
constexpr uint8_t kFlagAck = 0x1;
constexpr uint8_t kFlagEndHeaders = 0x4;

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

void frame_header(uint8_t* p, uint32_t len, uint8_t type, uint8_t flags,
                  uint32_t stream) {
  put_u24(p, len);
  p[3] = type;
  p[4] = flags;
  put_u32(p + 5, stream);
}

// HPACK string literal, no huffman.  The length is a 7-bit-prefix
// integer (RFC 7541 §5.1): values >= 127 continue in 7-bit groups.
void hpack_str(std::string& out, const char* s, size_t n) {
  if (n < 127) {
    out.push_back(static_cast<char>(n));
  } else {
    out.push_back(static_cast<char>(127));
    size_t v = n - 127;
    while (v >= 128) {
      out.push_back(static_cast<char>((v & 0x7f) | 0x80));
      v >>= 7;
    }
    out.push_back(static_cast<char>(v));
  }
  out.append(s, n);
}

// The request header block: static-table indexes + literals without
// indexing (RFC 7541 §6.2.2) — stateless, so one precomputed block
// serves every request on the connection.
std::string build_header_block(const std::string& path,
                               const std::string& authority) {
  std::string b;
  b.push_back(static_cast<char>(0x83));  // :method: POST  (static 3)
  b.push_back(static_cast<char>(0x86));  // :scheme: http  (static 6)
  b.push_back(static_cast<char>(0x04));  // :path, literal value
  hpack_str(b, path.data(), path.size());
  b.push_back(static_cast<char>(0x01));  // :authority, literal value
  hpack_str(b, authority.data(), authority.size());
  // content-type: application/grpc — static name 31 = 15 + varint 16.
  b.push_back(static_cast<char>(0x0f));
  b.push_back(static_cast<char>(0x10));
  hpack_str(b, "application/grpc", 16);
  // te: trailers — literal name (gRPC requires it).
  b.push_back(static_cast<char>(0x00));
  hpack_str(b, "te", 2);
  hpack_str(b, "trailers", 8);
  return b;
}

struct Conn {
  int fd = -1;
  std::vector<uint8_t> rbuf;
  size_t rlen = 0;
  uint32_t next_stream = 1;
  // Flow control.
  int64_t send_window = 65535;       // connection-level, theirs to grant
  int64_t recv_since_update = 0;     // connection-level, ours to grant
  bool saw_settings = false;

  ~Conn() { close_fd(); }

  void close_fd() {
    if (fd >= 0) ::close(fd);
    fd = -1;
  }

  bool connect_to(const char* host, int port) {
    close_fd();
    fd = ::socket(AF_INET, SOCK_STREAM, 0);
    if (fd < 0) return false;
    int one = 1;
    setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
    // Bound every recv(): a wedged server must soft-fail the RPC, not
    // hang the thread past the bench deadline (the deadline is only
    // checked between RPCs).
    timeval tv{5, 0};
    setsockopt(fd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof(tv));
    sockaddr_in addr{};
    addr.sin_family = AF_INET;
    addr.sin_port = htons(static_cast<uint16_t>(port));
    if (inet_pton(AF_INET, host, &addr.sin_addr) != 1) {
      // Hostname (e.g. DaemonConfig's default "localhost:…"): resolve.
      addrinfo hints{};
      hints.ai_family = AF_INET;
      hints.ai_socktype = SOCK_STREAM;
      addrinfo* res = nullptr;
      if (getaddrinfo(host, nullptr, &hints, &res) != 0 || !res)
        return false;
      addr.sin_addr = reinterpret_cast<sockaddr_in*>(res->ai_addr)->sin_addr;
      freeaddrinfo(res);
    }
    if (::connect(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) != 0)
      return false;
    next_stream = 1;
    send_window = 65535;
    recv_since_update = 0;
    rlen = 0;
    rbuf.resize(1 << 16);
    // Client preface + empty SETTINGS.
    static const char kPreface[] = "PRI * HTTP/2.0\r\n\r\nSM\r\n\r\n";
    uint8_t settings[9];
    frame_header(settings, 0, kFrameSettings, 0, 0);
    if (!send_full(reinterpret_cast<const uint8_t*>(kPreface), 24)) return false;
    return send_full(settings, 9);
  }

  bool send_full(const uint8_t* p, size_t n) {
    while (n) {
      ssize_t w = ::send(fd, p, n, MSG_NOSIGNAL);
      if (w <= 0) return false;
      p += w;
      n -= static_cast<size_t>(w);
    }
    return true;
  }

  // Read more bytes into rbuf; returns false on EOF/error.
  bool fill() {
    if (rlen == rbuf.size()) rbuf.resize(rbuf.size() * 2);
    ssize_t r = ::recv(fd, rbuf.data() + rlen, rbuf.size() - rlen, 0);
    if (r <= 0) return false;
    rlen += static_cast<size_t>(r);
    return true;
  }

  void consume(size_t n) {
    std::memmove(rbuf.data(), rbuf.data() + n, rlen - n);
    rlen -= n;
  }

  // Run one unary RPC: headers+data up, read frames until our stream
  // carries END_STREAM.  Returns 1 ok, 0 soft-fail (reconnect), 2
  // grpc-level error (trailers-only reply, no DATA — e.g.
  // RESOURCE_EXHAUSTED/UNAVAILABLE; connection stays usable), and
  // fills resp with the first DATA payload (grpc-framed) if wanted.
  int unary(const std::string& header_block, const uint8_t* body,
            size_t body_len, std::string* resp) {
    const uint32_t sid = next_stream;
    next_stream += 2;
    // grpc DATA payload: 5-byte message prefix + protobuf body.
    const size_t data_len = 5 + body_len;
    if (send_window < static_cast<int64_t>(data_len)) {
      // Wait for WINDOW_UPDATE before sending (tiny payloads: rare).
      if (!pump_until_window(static_cast<int64_t>(data_len))) return 0;
    }
    std::vector<uint8_t> out(9 + header_block.size() + 9 + data_len);
    uint8_t* p = out.data();
    frame_header(p, static_cast<uint32_t>(header_block.size()),
                 kFrameHeaders, kFlagEndHeaders, sid);
    std::memcpy(p + 9, header_block.data(), header_block.size());
    p += 9 + header_block.size();
    frame_header(p, static_cast<uint32_t>(data_len), kFrameData,
                 kFlagEndStream, sid);
    p[9] = 0;  // uncompressed
    put_u32(p + 10, static_cast<uint32_t>(body_len));
    std::memcpy(p + 14, body, body_len);
    if (!send_full(out.data(), out.size())) return 0;
    send_window -= static_cast<int64_t>(data_len);

    // Read until END_STREAM on sid.
    bool data_seen = false;
    for (;;) {
      while (rlen < 9) {
        if (!fill()) return 0;
      }
      const uint32_t flen = (uint32_t(rbuf[0]) << 16) |
                            (uint32_t(rbuf[1]) << 8) | rbuf[2];
      const uint8_t type = rbuf[3];
      const uint8_t flags = rbuf[4];
      const uint32_t stream = get_u32(rbuf.data() + 5) & 0x7fffffff;
      while (rlen < 9 + flen) {
        if (!fill()) return 0;
      }
      const uint8_t* payload = rbuf.data() + 9;
      bool done = false;
      switch (type) {
        case kFrameData:
          recv_since_update += flen;
          if (stream == sid) {
            if (flen > 0) data_seen = true;
            if (resp && resp->empty() && flen > 0)
              resp->assign(reinterpret_cast<const char*>(payload), flen);
            if (flags & kFlagEndStream) done = true;
          }
          break;
        case kFrameHeaders:
          if (stream == sid && (flags & kFlagEndStream)) done = true;
          break;
        case kFrameSettings:
          if (!(flags & kFlagAck)) {
            saw_settings = true;
            uint8_t ack[9];
            frame_header(ack, 0, kFrameSettings, kFlagAck, 0);
            if (!send_full(ack, 9)) return 0;
          }
          break;
        case kFramePing:
          if (!(flags & kFlagAck)) {
            uint8_t pong[17];
            frame_header(pong, 8, kFramePing, kFlagAck, 0);
            std::memcpy(pong + 9, payload, 8);
            if (!send_full(pong, 17)) return 0;
          }
          break;
        case kFrameWindowUpdate:
          if (stream == 0) send_window += get_u32(payload) & 0x7fffffff;
          break;
        case kFrameRst:
          if (stream == sid) {
            consume(9 + flen);
            return 0;
          }
          break;
        case kFrameGoaway:
          return 0;
        default:
          break;  // CONTINUATION/PUSH/etc: skip (END_HEADERS-only
                  // header blocks from grpc servers fit one frame)
      }
      consume(9 + flen);
      if (done) {
        // Replenish the connection-level receive window.
        if (recv_since_update > 0) {
          uint8_t wu[13];
          frame_header(wu, 4, kFrameWindowUpdate, 0, 0);
          put_u32(wu + 9, static_cast<uint32_t>(recv_since_update));
          if (!send_full(wu, 13)) return 0;
          recv_since_update = 0;
        }
        // Trailers-only reply (no DATA) = grpc error status: a real
        // response always carries a DATA frame with the message.
        return data_seen ? 1 : 2;
      }
    }
  }

  bool pump_until_window(int64_t need) {
    // Degenerate path (never hit with tiny payloads): read frames
    // until the peer grants window.
    for (int spins = 0; spins < 1000 && send_window < need; ++spins) {
      while (rlen < 9) {
        if (!fill()) return false;
      }
      const uint32_t flen = (uint32_t(rbuf[0]) << 16) |
                            (uint32_t(rbuf[1]) << 8) | rbuf[2];
      while (rlen < 9 + flen) {
        if (!fill()) return false;
      }
      if (rbuf[3] == kFrameWindowUpdate &&
          (get_u32(rbuf.data() + 5) & 0x7fffffff) == 0)
        send_window += get_u32(rbuf.data() + 9) & 0x7fffffff;
      consume(9 + flen);
    }
    return send_window >= need;
  }
};

}  // namespace

extern "C" {

// Closed-loop unary gRPC load against host:port.
//   path/payload: method path and ONE serialized request protobuf.
//   seconds: measurement window.  n_conns: concurrent connections
//   (one OS thread each; they release the GIL for the whole call).
//   out_lats[max_lats]: per-RPC seconds, ring-overwritten so the
//   sample reflects steady state.  out_stats[4]: rpcs, errors
//   (transport failures AND trailers-only grpc error replies),
//   lats_recorded, threads_connected.  out_resp/resp_cap/
//   out_resp_len: first grpc-framed response payload (callers verify
//   it decodes correctly).
// Returns 0, or -1 if no connection could be established.
// guberlint: gil-free
int64_t h2_bench_unary(const char* host, int32_t port, const char* path,
                       const char* authority, const uint8_t* payload,
                       int64_t payload_len, double seconds, int32_t n_conns,
                       double* out_lats, int64_t max_lats, int64_t* out_stats,
                       uint8_t* out_resp, int64_t resp_cap,
                       int64_t* out_resp_len) {
  const std::string header_block = build_header_block(path, authority);
  std::atomic<int64_t> total{0}, errors{0};
  std::atomic<bool> ok_any{false};
  *out_resp_len = 0;
  std::atomic<int64_t> lat_cursor{0};
  const auto deadline =
      Clock::now() + std::chrono::duration<double>(seconds);
  std::vector<std::thread> threads;
  std::atomic<bool> first_resp_taken{false};
  std::atomic<int64_t> connected{0};
  for (int t = 0; t < n_conns; ++t) {
    threads.emplace_back([&, t]() {
      Conn c;
      // Retry the initial connect like the in-loop path: a burst of
      // SYNs against a just-started server can overflow the backlog,
      // and a silently missing generator would misstate the load.
      bool up = false;
      for (int tries = 0; tries < 5 && !up; ++tries) {
        up = c.connect_to(host, port);
        if (!up) std::this_thread::sleep_for(std::chrono::milliseconds(10));
      }
      if (!up) return;
      ok_any.store(true);
      connected.fetch_add(1);
      std::string resp;
      bool want_resp = !first_resp_taken.exchange(true);
      while (Clock::now() < deadline) {
        const auto t0 = Clock::now();
        std::string* rp = want_resp ? &resp : nullptr;
        const int r = c.unary(header_block, payload,
                              static_cast<size_t>(payload_len), rp);
        if (r == 1) {
          const double dt =
              std::chrono::duration<double>(Clock::now() - t0).count();
          // guberlint: ok native — bench counters: the only reads are
          // after the thread joins below, which publish everything.
          total.fetch_add(1, std::memory_order_relaxed);
          const int64_t i =
              lat_cursor.fetch_add(1, std::memory_order_relaxed);  // guberlint: ok native — same join-publishes argument
          if (max_lats > 0) out_lats[i % max_lats] = dt;
          if (want_resp && !resp.empty()) {
            const int64_t n = std::min<int64_t>(
                static_cast<int64_t>(resp.size()), resp_cap);
            std::memcpy(out_resp, resp.data(), static_cast<size_t>(n));
            *out_resp_len = n;
            want_resp = false;
          }
        } else if (r == 2) {
          // grpc error status; the connection is still healthy.
          errors.fetch_add(1, std::memory_order_relaxed);  // guberlint: ok native — bench counter, read after join
        } else {
          errors.fetch_add(1, std::memory_order_relaxed);  // guberlint: ok native — bench counter, read after join
          if (!c.connect_to(host, port)) {
            std::this_thread::sleep_for(std::chrono::milliseconds(10));
            if (!c.connect_to(host, port)) return;
          }
        }
      }
    });
  }
  for (auto& th : threads) th.join();
  out_stats[0] = total.load();
  out_stats[1] = errors.load();
  out_stats[2] = std::min<int64_t>(lat_cursor.load(), max_lats);
  out_stats[3] = connected.load();
  return ok_any.load() ? 0 : -1;
}

}  // extern "C"

// ---------------------------------------------------------------------
// Connection-scale epoll client (BENCH_MODE=connscale, PERF.md §26).
//
// Holds n_conns connections open against one address from a HANDFUL
// of epoll threads — the client-side mirror of the server's reactor
// front, and the load shape that lets the C10K→C100K ramp be driven
// at all (one client thread per connection would melt the box before
// the server noticed).  The first n_active connections run a closed
// unary loop (one in-flight RPC each); the rest sit established and
// idle, answering SETTINGS/PING, exactly like a parked client fleet.
// Crucially for the §25 starvation analysis: the whole generator
// burns `threads` CPUs (default 1), so the measurement no longer
// starves the server's one Python serve thread under its own load.

namespace {

struct CsConn {
  int fd = -1;
  bool connecting = false;   // nonblocking connect() in flight
  bool established = false;  // preface + SETTINGS written
  bool active = false;       // runs the closed unary loop
  bool dead = false;
  int retries = 0;
  std::vector<uint8_t> rbuf;
  size_t rlen = 0;
  std::string wbuf;          // pending output (short-write carry)
  size_t woff = 0;
  uint32_t next_stream = 1;
  uint32_t inflight = 0;     // stream awaiting END_STREAM (0 = idle)
  bool data_seen = false;
  int64_t send_window = 65535;
  int64_t recv_since_update = 0;
  Clock::time_point t0;      // in-flight RPC start
};

struct CsShared {
  const char* host;
  int port;
  sockaddr_in addr{};
  std::string header_block;
  const uint8_t* payload;
  size_t payload_len;
  double seconds;
  std::atomic<int64_t> rpcs{0}, errors{0}, connected{0}, alive{0};
  std::atomic<int64_t> lat_cursor{0};
  double* out_lats = nullptr;
  int64_t max_lats = 0;
};

// Per-connection epoll interest: EPOLLIN always; EPOLLOUT only while
// a connect or short write is pending (level-triggered — with tens of
// thousands of mostly-idle fds, LT costs nothing and removes the
// drain-to-EAGAIN obligations edge mode carries).
void cs_interest(int epfd, CsConn* c, int op) {
  epoll_event ev{};
  ev.events = EPOLLIN |
              ((c->connecting || c->woff < c->wbuf.size()) ? EPOLLOUT : 0);
  ev.data.ptr = c;
  epoll_ctl(epfd, op, c->fd, &ev);
}

void cs_close(CsShared& sh, int epfd, CsConn* c, bool established_was) {
  if (c->fd >= 0) {
    epoll_ctl(epfd, EPOLL_CTL_DEL, c->fd, nullptr);
    ::close(c->fd);
    c->fd = -1;
  }
  c->dead = true;
  if (established_was) sh.alive.fetch_sub(1);
}

bool cs_flush(CsShared& sh, int epfd, CsConn* c) {
  while (c->woff < c->wbuf.size()) {
    ssize_t w = ::send(c->fd, c->wbuf.data() + c->woff,
                       c->wbuf.size() - c->woff,
                       MSG_NOSIGNAL | MSG_DONTWAIT);
    if (w > 0) {
      c->woff += static_cast<size_t>(w);
      continue;
    }
    if (w < 0 && (errno == EAGAIN || errno == EWOULDBLOCK)) {
      cs_interest(epfd, c, EPOLL_CTL_MOD);
      return true;
    }
    if (w < 0 && errno == EINTR) continue;
    return false;  // peer gone
  }
  if (c->woff) {
    c->wbuf.clear();
    c->woff = 0;
    cs_interest(epfd, c, EPOLL_CTL_MOD);
  }
  return true;
}

bool cs_start_connect(CsShared& sh, int epfd, CsConn* c) {
  c->fd = ::socket(AF_INET, SOCK_STREAM | SOCK_NONBLOCK, 0);
  if (c->fd < 0) return false;
  int one = 1;
  setsockopt(c->fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
  const int rc = ::connect(
      c->fd, reinterpret_cast<const sockaddr*>(&sh.addr), sizeof(sh.addr));
  if (rc != 0 && errno != EINPROGRESS) {
    ::close(c->fd);
    c->fd = -1;
    return false;
  }
  c->connecting = true;
  cs_interest(epfd, c, EPOLL_CTL_ADD);
  return true;
}

void cs_establish(CsShared& sh, int epfd, CsConn* c) {
  c->connecting = false;
  c->established = true;
  c->rbuf.resize(2048);
  static const char kPreface[] = "PRI * HTTP/2.0\r\n\r\nSM\r\n\r\n";
  c->wbuf.append(kPreface, 24);
  uint8_t settings[9];
  frame_header(settings, 0, kFrameSettings, 0, 0);
  c->wbuf.append(reinterpret_cast<char*>(settings), 9);
  sh.connected.fetch_add(1);
  sh.alive.fetch_add(1);
  if (!cs_flush(sh, epfd, c)) cs_close(sh, epfd, c, true);
}

void cs_start_rpc(CsShared& sh, int epfd, CsConn* c) {
  const uint32_t sid = c->next_stream;
  c->next_stream += 2;
  const size_t data_len = 5 + sh.payload_len;
  if (c->send_window < static_cast<int64_t>(data_len)) {
    // Parked on window credit: resume when WINDOW_UPDATE arrives
    // (tiny payloads — the server replenishes every 16KB).
    c->inflight = 0;
    return;
  }
  uint8_t fh[9];
  frame_header(fh, static_cast<uint32_t>(sh.header_block.size()),
               kFrameHeaders, kFlagEndHeaders, sid);
  c->wbuf.append(reinterpret_cast<char*>(fh), 9);
  c->wbuf += sh.header_block;
  frame_header(fh, static_cast<uint32_t>(data_len), kFrameData,
               kFlagEndStream, sid);
  c->wbuf.append(reinterpret_cast<char*>(fh), 9);
  c->wbuf.push_back(0);  // uncompressed
  uint8_t len4[4];
  put_u32(len4, static_cast<uint32_t>(sh.payload_len));
  c->wbuf.append(reinterpret_cast<char*>(len4), 4);
  c->wbuf.append(reinterpret_cast<const char*>(sh.payload),
                 sh.payload_len);
  c->send_window -= static_cast<int64_t>(data_len);
  c->inflight = sid;
  c->data_seen = false;
  c->t0 = Clock::now();
  if (!cs_flush(sh, epfd, c)) cs_close(sh, epfd, c, true);
}

// One RPC finished (END_STREAM on the in-flight stream): book it and
// start the next while the measurement window is open.
void cs_rpc_done(CsShared& sh, int epfd, CsConn* c, bool ok,
                 const Clock::time_point& deadline) {
  c->inflight = 0;
  if (ok) {
    sh.rpcs.fetch_add(1, std::memory_order_relaxed);  // guberlint: ok native — bench counter, read after join
    const double dt =
        std::chrono::duration<double>(Clock::now() - c->t0).count();
    const int64_t i =
        sh.lat_cursor.fetch_add(1, std::memory_order_relaxed);  // guberlint: ok native — same join-publishes argument
    if (sh.max_lats > 0) sh.out_lats[i % sh.max_lats] = dt;
  } else {
    sh.errors.fetch_add(1, std::memory_order_relaxed);  // guberlint: ok native — bench counter, read after join
  }
  // Replenish the server's view of our receive window in bulk.
  if (c->recv_since_update >= 4096) {
    uint8_t wu[13];
    frame_header(wu, 4, kFrameWindowUpdate, 0, 0);
    put_u32(wu + 9, static_cast<uint32_t>(c->recv_since_update));
    c->wbuf.append(reinterpret_cast<char*>(wu), 13);
    c->recv_since_update = 0;
  }
  if (c->active && Clock::now() < deadline) cs_start_rpc(sh, epfd, c);
}

// Drain and parse whatever the socket holds; LT epoll re-arms any
// leftover.
void cs_read(CsShared& sh, int epfd, CsConn* c,
             const Clock::time_point& deadline) {
  for (;;) {
    if (c->rlen == c->rbuf.size())
      c->rbuf.resize(std::max<size_t>(2048, c->rbuf.size() * 2));
    const ssize_t r = ::recv(c->fd, c->rbuf.data() + c->rlen,
                             c->rbuf.size() - c->rlen, MSG_DONTWAIT);
    if (r > 0) {
      c->rlen += static_cast<size_t>(r);
      continue;
    }
    if (r < 0 && (errno == EAGAIN || errno == EWOULDBLOCK)) break;
    if (r < 0 && errno == EINTR) continue;
    cs_close(sh, epfd, c, c->established);
    if (c->inflight)
      sh.errors.fetch_add(1, std::memory_order_relaxed);  // guberlint: ok native — bench counter, read after join
    return;
  }
  size_t pos = 0;
  while (c->rlen - pos >= 9) {
    const uint8_t* f = c->rbuf.data() + pos;
    const uint32_t flen =
        (uint32_t(f[0]) << 16) | (uint32_t(f[1]) << 8) | f[2];
    if (c->rlen - pos < 9 + flen) break;
    const uint8_t type = f[3], flags = f[4];
    const uint32_t stream = get_u32(f + 5) & 0x7fffffff;
    const uint8_t* payload = f + 9;
    switch (type) {
      case kFrameData:
        c->recv_since_update += flen;
        if (stream == c->inflight) {
          if (flen > 0) c->data_seen = true;
          if (flags & kFlagEndStream)
            cs_rpc_done(sh, epfd, c, c->data_seen, deadline);
        }
        break;
      case kFrameHeaders:
        if (stream == c->inflight && (flags & kFlagEndStream))
          cs_rpc_done(sh, epfd, c, c->data_seen, deadline);
        break;
      case kFrameSettings:
        if (!(flags & kFlagAck)) {
          uint8_t ack[9];
          frame_header(ack, 0, kFrameSettings, kFlagAck, 0);
          c->wbuf.append(reinterpret_cast<char*>(ack), 9);
        }
        break;
      case kFramePing:
        if (!(flags & kFlagAck) && flen == 8) {
          uint8_t pong[17];
          frame_header(pong, 8, kFramePing, kFlagAck, 0);
          std::memcpy(pong + 9, payload, 8);
          c->wbuf.append(reinterpret_cast<char*>(pong), 17);
        }
        break;
      case kFrameWindowUpdate:
        if (stream == 0) {
          const bool was_parked =
              c->active && c->inflight == 0 && c->established;
          c->send_window += get_u32(payload) & 0x7fffffff;
          if (was_parked && Clock::now() < deadline)
            cs_start_rpc(sh, epfd, c);
        }
        break;
      case kFrameRst:
        if (stream == c->inflight)
          cs_rpc_done(sh, epfd, c, false, deadline);
        break;
      case kFrameGoaway:
        cs_close(sh, epfd, c, c->established);
        if (c->inflight)
          sh.errors.fetch_add(1, std::memory_order_relaxed);  // guberlint: ok native — bench counter, read after join
        return;
      default:
        break;
    }
    pos += 9 + flen;
    if (c->dead) return;
  }
  if (pos) {
    std::memmove(c->rbuf.data(), c->rbuf.data() + pos, c->rlen - pos);
    c->rlen -= pos;
  }
  if (!c->wbuf.empty() && !c->dead) {
    if (!cs_flush(sh, epfd, c)) cs_close(sh, epfd, c, c->established);
  }
  // Shrink a burst buffer so 100k idle conns stay cheap.
  if (c->rlen == 0 && c->rbuf.size() > (32u << 10)) {
    c->rbuf.resize(2048);
    c->rbuf.shrink_to_fit();
  }
}

// One worker: ramp its connection range (bounded connect batches),
// then run the closed loops on its active conns until the deadline.
// guberlint: gil-free
// guberlint: epoll-root
void cs_worker(CsShared& sh, std::vector<CsConn>& conns, size_t lo,
               size_t hi, size_t active_below,
               std::atomic<int64_t>& ramped,
               const std::atomic<bool>& go, double ramp_budget_s) {
  const int epfd = epoll_create1(0);
  if (epfd < 0) {
    ramped.fetch_add(1);  // never strand the main thread's barrier
    return;
  }
  constexpr size_t kConnectBatch = 256;
  size_t next = lo, inflight_connects = 0;
  const auto ramp_deadline =
      Clock::now() + std::chrono::duration_cast<Clock::duration>(
                         std::chrono::duration<double>(ramp_budget_s));
  epoll_event evs[512];
  // Phase 1: establish everything (connect ramp).
  while (Clock::now() < ramp_deadline) {
    while (inflight_connects < kConnectBatch && next < hi) {
      CsConn* c = &conns[next];
      c->active = next < active_below;
      ++next;
      if (cs_start_connect(sh, epfd, c)) {
        ++inflight_connects;
      } else if (c->retries++ < 3) {
        --next;  // retry the same slot
      } else {
        sh.errors.fetch_add(1, std::memory_order_relaxed);  // guberlint: ok native — bench counter, read after join
        c->dead = true;
      }
    }
    bool all_done = next >= hi && inflight_connects == 0;
    if (all_done) break;
    const int n = epoll_wait(epfd, evs, 512, 50);
    for (int i = 0; i < n; ++i) {
      auto* c = static_cast<CsConn*>(evs[i].data.ptr);
      if (c->dead) continue;
      if (c->connecting) {
        int err = 0;
        socklen_t elen = sizeof(err);
        getsockopt(c->fd, SOL_SOCKET, SO_ERROR, &err, &elen);
        if ((evs[i].events & (EPOLLERR | EPOLLHUP)) || err != 0) {
          --inflight_connects;
          ::close(c->fd);
          c->fd = -1;
          c->connecting = false;
          if (c->retries++ < 3) {
            if (cs_start_connect(sh, epfd, c)) ++inflight_connects;
          } else {
            sh.errors.fetch_add(1, std::memory_order_relaxed);  // guberlint: ok native — bench counter, read after join
            c->dead = true;
          }
          continue;
        }
        --inflight_connects;
        cs_establish(sh, epfd, c);
        continue;
      }
      // Early server frames (SETTINGS) during ramp.
      if (evs[i].events & EPOLLIN) cs_read(sh, epfd, c, ramp_deadline);
      if (!c->dead && (evs[i].events & EPOLLOUT)) {
        if (!cs_flush(sh, epfd, c)) cs_close(sh, epfd, c, c->established);
      }
    }
  }
  ramped.fetch_add(1);
  while (!go.load()) std::this_thread::sleep_for(std::chrono::milliseconds(1));
  // Connects still in flight when the ramp budget expired never
  // established: close and count them — left in the loop they would
  // spin on level-triggered EPOLLOUT and then be silently destroyed
  // by a zero-length misread, under-reporting the held count.
  for (size_t i = lo; i < hi; ++i) {
    CsConn* c = &conns[i];
    if (!c->dead && c->fd >= 0 && c->connecting) {
      sh.errors.fetch_add(1, std::memory_order_relaxed);  // guberlint: ok native — bench counter, read after join
      cs_close(sh, epfd, c, false);
    }
  }
  // Phase 2: measured closed loops.
  const auto deadline =
      Clock::now() + std::chrono::duration_cast<Clock::duration>(
                         std::chrono::duration<double>(sh.seconds));
  for (size_t i = lo; i < hi && i < active_below; ++i)
    if (!conns[i].dead && conns[i].established)
      cs_start_rpc(sh, epfd, &conns[i]);
  while (Clock::now() < deadline) {
    const int n = epoll_wait(epfd, evs, 512, 50);
    for (int i = 0; i < n; ++i) {
      auto* c = static_cast<CsConn*>(evs[i].data.ptr);
      if (c->dead) continue;
      if (evs[i].events & (EPOLLERR | EPOLLHUP)) {
        cs_close(sh, epfd, c, c->established);
        if (c->inflight)
          sh.errors.fetch_add(1, std::memory_order_relaxed);  // guberlint: ok native — bench counter, read after join
        continue;
      }
      if (evs[i].events & EPOLLIN) cs_read(sh, epfd, c, deadline);
      if (!c->dead && (evs[i].events & EPOLLOUT)) {
        if (!cs_flush(sh, epfd, c)) cs_close(sh, epfd, c, c->established);
      }
    }
  }
  // Harness teardown, not connection death: leave sh.alive at its
  // deadline value (it is the conns_alive_at_end stat).
  for (size_t i = lo; i < hi; ++i)
    if (conns[i].fd >= 0) cs_close(sh, epfd, &conns[i], false);
  ::close(epfd);
}

}  // namespace

extern "C" {

// Connection-scale load: hold `n_conns` open connections, run closed
// unary loops on the first `n_active` of them from `threads` epoll
// worker threads.  out_stats: [0] rpcs, [1] errors (transport +
// trailers-only grpc errors + conns that never connected), [2] lats
// recorded, [3] conns that completed the h2 preface, [4] conns still
// alive at the deadline, [5] ramp wall, ms.  Latencies ring-overwrite
// out_lats like h2_bench_unary.  Returns 0, or -1 when nothing
// connected.
// guberlint: gil-free
int64_t h2_connscale_run(const char* host, int32_t port, const char* path,
                         const char* authority, const uint8_t* payload,
                         int64_t payload_len, double seconds,
                         int64_t n_conns, int64_t n_active, int32_t threads,
                         double ramp_budget_s, double* out_lats,
                         int64_t max_lats, int64_t* out_stats) {
  CsShared sh;
  sh.host = host;
  sh.port = port;
  sh.header_block = build_header_block(path, authority);
  sh.payload = payload;
  sh.payload_len = static_cast<size_t>(payload_len);
  sh.seconds = seconds;
  sh.out_lats = out_lats;
  sh.max_lats = max_lats;
  sh.addr.sin_family = AF_INET;
  sh.addr.sin_port = htons(static_cast<uint16_t>(port));
  if (inet_pton(AF_INET, host, &sh.addr.sin_addr) != 1) {
    addrinfo hints{};
    hints.ai_family = AF_INET;
    hints.ai_socktype = SOCK_STREAM;
    addrinfo* res = nullptr;
    if (getaddrinfo(host, nullptr, &hints, &res) != 0 || !res) return -1;
    sh.addr.sin_addr =
        reinterpret_cast<sockaddr_in*>(res->ai_addr)->sin_addr;
    freeaddrinfo(res);
  }
  if (threads < 1) threads = 1;
  if (n_active > n_conns) n_active = n_conns;
  std::vector<CsConn> conns(static_cast<size_t>(n_conns));
  std::atomic<int64_t> ramped{0};
  std::atomic<bool> go{false};
  const auto t_ramp0 = Clock::now();
  std::vector<std::thread> workers;
  const size_t per = (static_cast<size_t>(n_conns) + threads - 1) / threads;
  for (int32_t t = 0; t < threads; ++t) {
    const size_t lo = static_cast<size_t>(t) * per;
    const size_t hi =
        std::min(static_cast<size_t>(n_conns), lo + per);
    if (lo >= hi) break;
    workers.emplace_back([&, lo, hi]() {
      cs_worker(sh, conns, lo, hi, static_cast<size_t>(n_active),
                ramped, go, ramp_budget_s);
    });
  }
  // Open the measurement window only once every worker finished (or
  // timed out) its ramp: throughput must not average in connect time.
  while (ramped.load() < static_cast<int64_t>(workers.size()))
    std::this_thread::sleep_for(std::chrono::milliseconds(5));
  const int64_t ramp_ms =
      std::chrono::duration_cast<std::chrono::milliseconds>(
          Clock::now() - t_ramp0)
          .count();
  go.store(true);
  for (auto& th : workers) th.join();
  out_stats[0] = sh.rpcs.load();
  out_stats[1] = sh.errors.load();
  out_stats[2] = std::min<int64_t>(sh.lat_cursor.load(), max_lats);
  out_stats[3] = sh.connected.load();
  out_stats[4] = sh.alive.load();
  out_stats[5] = ramp_ms;
  return sh.connected.load() > 0 ? 0 : -1;
}

}  // extern "C"
