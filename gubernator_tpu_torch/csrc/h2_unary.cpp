// The port's unary gRPC client over cleartext HTTP/2 (linked into the
// h2_client library beside the bench loops of h2_client.cpp): what
// cluster/peer_client.py calls in place of a grpc channel, since the
// card's machine has no grpcio.
//
// A channel holds one connection to its peer and multiplexes every
// caller's stream on it; any number of threads may call at once (ctypes
// releases the interpreter lock for the whole call).  A call sends
// grpc-timeout and waits at most that long: past its deadline it sends
// RST_STREAM CANCEL and answers DEADLINE_EXCEEDED.  One reader thread a
// connection deframes the peer's frames and decodes every header block
// with hpack.h, in order (the dynamic table is connection state), so the
// call returns (grpc-status, grpc-message, message body) from the
// response's headers and trailers.  A connection that got GOAWAY or was
// reset is never used again: the next call dials a new one, and a call
// the GOAWAY refused (its stream above last-stream-id, never processed)
// goes once more on the new connection, as gRPC's transparent retry does.
//
// Flow control: the client advertises a 16 MiB stream window and opens
// the connection window to 1 GiB, topping it up every MiB read, so
// responses never wait on it; request DATA is sent within the peer's
// connection and stream windows and its MAX_FRAME_SIZE.
//
// Transport failures come back as gRPC statuses, as grpcio reports them:
// a refused or timed-out dial and a reset connection are UNAVAILABLE
// (14), a passed deadline DEADLINE_EXCEEDED (4).

#include <arpa/inet.h>
#include <fcntl.h>
#include <netdb.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <poll.h>
#include <sys/socket.h>
#include <unistd.h>

#include <algorithm>
#include <atomic>
#include <cerrno>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

#include "hpack.h"

namespace {

using Clock = std::chrono::steady_clock;

constexpr uint8_t kData = 0x0, kHeaders = 0x1, kRst = 0x3, kSettings = 0x4,
                  kPing = 0x6, kGoaway = 0x7, kWindowUpdate = 0x8,
                  kContinuation = 0x9;
constexpr uint8_t kEndStream = 0x1, kAck = 0x1, kEndHeaders = 0x4,
                  kPadded = 0x8, kPriority = 0x20;
constexpr int kOk = 0, kCancelled = 1, kUnknown = 2, kDeadline = 4,
              kInternal = 13, kUnavailable = 14;
constexpr int64_t kStreamWindow = 1 << 24;
constexpr int64_t kConnWindow = 1 << 30;

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

void frame(std::string& out, uint32_t len, uint8_t type, uint8_t flags,
           uint32_t stream) {
  uint8_t h[9];
  h[0] = (len >> 16) & 0xff;
  h[1] = (len >> 8) & 0xff;
  h[2] = len & 0xff;
  h[3] = type;
  h[4] = flags;
  put_u32(h + 5, stream);
  out.append(reinterpret_cast<char*>(h), 9);
}

struct Result {
  int status = kUnknown;
  std::string message;
  std::string body;
};

struct Call {
  uint32_t sid = 0;
  bool done = false;
  bool refused = false;  // above a GOAWAY's last-stream-id: not processed
  int64_t send_window = 0;
  std::vector<hpack::Header> headers;  // response headers, then trailers
  std::string data;                    // grpc-framed response bytes
  Result result;
};

struct Connection {
  // guberlint: guard calls, next_sid, dead, goaway, conn_window, peer_window, peer_frame by mu
  int fd = -1;
  std::mutex mu;
  std::condition_variable cv;
  std::mutex write_mu;  // frames go out whole and in stream order
  std::unordered_map<uint32_t, std::shared_ptr<Call>> calls;
  uint32_t next_sid = 1;
  bool dead = false;
  bool goaway = false;
  int64_t conn_window = 65535;
  int64_t peer_window = 65535;  // the peer's SETTINGS_INITIAL_WINDOW_SIZE
  uint32_t peer_frame = 16384;  // the peer's SETTINGS_MAX_FRAME_SIZE
  std::thread reader;
  std::atomic<bool> reader_done{false};
  // Reader-thread state.
  hpack::Decoder dec;
  std::string hblock;
  uint32_t hstream = 0;
  uint8_t hflags = 0;
  int64_t recv_since_update = 0;

  ~Connection() {
    if (fd >= 0) ::close(fd);
  }

  bool usable() {
    std::lock_guard<std::mutex> lock(mu);
    return !dead && !goaway && next_sid < 0x7fff0000u;
  }

  bool send_raw(const std::string& buf) {
    std::lock_guard<std::mutex> lock(write_mu);
    return send_locked(buf);
  }

  bool send_locked(const std::string& buf) {  // guberlint: holds write_mu
    const char* p = buf.data();
    size_t n = buf.size();
    while (n) {
      const ssize_t w = ::send(fd, p, n, MSG_NOSIGNAL);
      if (w <= 0) {
        if (w < 0 && errno == EINTR) continue;
        ::shutdown(fd, SHUT_RDWR);  // the reader sees EOF and fails calls
        return false;
      }
      p += w;
      n -= static_cast<size_t>(w);
    }
    return true;
  }

  void finish_locked(Call& c, int status, const std::string& msg) {  // guberlint: holds mu
    if (c.done) return;
    c.done = true;
    c.result.status = status;
    c.result.message = msg;
  }

  // Headers and trailers both in: the status is the trailers' (or the
  // trailers-only response's) grpc-status.
  void complete_locked(Call& c) {  // guberlint: holds mu
    int status = -1;
    std::string msg;
    for (const auto& h : c.headers) {
      if (h.name == "grpc-status") {
        status = 0;
        for (char ch : h.value) {
          if (ch < '0' || ch > '9') {
            status = -1;
            break;
          }
          status = status * 10 + (ch - '0');
        }
      } else if (h.name == "grpc-message") {
        msg = hpack::percent_decode(h.value);
      }
    }
    if (status < 0) {
      finish_locked(c, kInternal, "response carried no grpc-status");
      return;
    }
    if (status == kOk) {
      const std::string& d = c.data;
      if (d.size() < 5 || d[0] != 0 ||
          get_u32(reinterpret_cast<const uint8_t*>(d.data()) + 1) !=
              d.size() - 5) {
        finish_locked(c, kInternal, "malformed grpc message frame");
        return;
      }
      c.result.body.assign(d, 5, std::string::npos);
    }
    finish_locked(c, status, msg);
  }

  void fail_all_locked(int status, const std::string& msg) {  // guberlint: holds mu
    for (auto& kv : calls) finish_locked(*kv.second, status, msg);
    cv.notify_all();
  }

  // One complete header block (HEADERS + CONTINUATIONs).
  bool on_header_block() {
    std::vector<hpack::Header> hs;
    if (!dec.decode(reinterpret_cast<const uint8_t*>(hblock.data()),
                    hblock.size(), &hs))
      return false;  // COMPRESSION_ERROR: the connection is lost
    std::lock_guard<std::mutex> lock(mu);
    auto it = calls.find(hstream);
    if (it == calls.end()) return true;
    Call& c = *it->second;
    for (auto& h : hs) c.headers.push_back(std::move(h));
    if (hflags & kEndStream) {
      complete_locked(c);
      cv.notify_all();
    }
    return true;
  }

  // Process one frame; control replies are appended to `out`.  false
  // ends the connection.
  bool on_frame(uint8_t type, uint8_t flags, uint32_t sid, const uint8_t* p,
                uint32_t len, std::string* out) {
    if (!hblock.empty() || hstream != 0) {
      // Inside a header block only its CONTINUATIONs may come.
      if (type != kContinuation || sid != hstream) return false;
    }
    switch (type) {
      case kHeaders: {
        uint32_t off = 0, pad = 0;
        if (flags & kPadded) {
          if (len < 1) return false;
          pad = p[0];
          off = 1;
        }
        if (flags & kPriority) off += 5;
        if (off + pad > len) return false;
        hblock.assign(reinterpret_cast<const char*>(p + off), len - off - pad);
        hstream = sid;
        hflags = flags;
        if (flags & kEndHeaders) {
          const bool ok = on_header_block();
          hblock.clear();
          hstream = 0;
          return ok;
        }
        return true;
      }
      case kContinuation:
        if (hstream == 0 || sid != hstream) return false;
        hblock.append(reinterpret_cast<const char*>(p), len);
        if (flags & kEndHeaders) {
          const bool ok = on_header_block();
          hblock.clear();
          hstream = 0;
          return ok;
        }
        return true;
      case kData: {
        uint32_t off = 0, pad = 0;
        if (flags & kPadded) {
          if (len < 1) return false;
          pad = p[0];
          off = 1;
        }
        if (off + pad > len) return false;
        recv_since_update += len;
        if (recv_since_update >= (1 << 20)) {
          frame(*out, 4, kWindowUpdate, 0, 0);
          uint8_t inc[4];
          put_u32(inc, static_cast<uint32_t>(recv_since_update));
          out->append(reinterpret_cast<char*>(inc), 4);
          recv_since_update = 0;
        }
        std::lock_guard<std::mutex> lock(mu);
        auto it = calls.find(sid);
        if (it == calls.end()) return true;
        Call& c = *it->second;
        c.data.append(reinterpret_cast<const char*>(p + off), len - off - pad);
        if (c.data.size() > (64u << 20)) {
          finish_locked(c, kInternal, "response larger than 64 MiB");
          cv.notify_all();
        } else if (flags & kEndStream) {
          // A response must end with trailers.
          finish_locked(c, kInternal, "stream ended without trailers");
          cv.notify_all();
        }
        return true;
      }
      case kRst: {
        if (len != 4) return false;
        const uint32_t code = get_u32(p);
        std::lock_guard<std::mutex> lock(mu);
        auto it = calls.find(sid);
        if (it != calls.end()) {
          // REFUSED_STREAM: not processed, safe to send again.
          if (code == 0x7) it->second->refused = true;
          finish_locked(*it->second,
                        code == 0x7   ? kUnavailable
                        : code == 0x8 ? kCancelled
                                      : kInternal,
                        "stream reset by the peer (h2 error " +
                            std::to_string(code) + ")");
          cv.notify_all();
        }
        return true;
      }
      case kSettings: {
        if (flags & kAck) return true;
        if (len % 6) return false;
        std::lock_guard<std::mutex> lock(mu);
        for (uint32_t off = 0; off < len; off += 6) {
          const uint16_t id = (uint16_t(p[off]) << 8) | p[off + 1];
          const uint32_t v = get_u32(p + off + 2);
          if (id == 0x4) {
            if (v > 0x7fffffffu) return false;
            const int64_t delta = static_cast<int64_t>(v) - peer_window;
            peer_window = v;
            for (auto& kv : calls) kv.second->send_window += delta;
          } else if (id == 0x5) {
            if (v < 16384 || v > 16777215) return false;
            peer_frame = v;
          }
          // HEADER_TABLE_SIZE bounds the peer's decoder table; this
          // encoder never indexes, so it needs nothing.
        }
        cv.notify_all();
        frame(*out, 0, kSettings, kAck, 0);
        return true;
      }
      case kPing:
        if (!(flags & kAck) && len == 8) {
          frame(*out, 8, kPing, kAck, 0);
          out->append(reinterpret_cast<const char*>(p), 8);
        }
        return true;
      case kGoaway: {
        if (len < 8) return false;
        const uint32_t last = get_u32(p) & 0x7fffffff;
        std::lock_guard<std::mutex> lock(mu);
        goaway = true;
        for (auto& kv : calls)
          if (kv.first > last) {
            kv.second->refused = true;
            finish_locked(*kv.second, kUnavailable,
                          "stream refused by GOAWAY");
          }
        cv.notify_all();
        return true;
      }
      case kWindowUpdate: {
        if (len != 4) return false;
        const uint32_t inc = get_u32(p) & 0x7fffffff;
        std::lock_guard<std::mutex> lock(mu);
        if (sid == 0) {
          conn_window += inc;
        } else {
          auto it = calls.find(sid);
          if (it != calls.end()) it->second->send_window += inc;
        }
        cv.notify_all();
        return true;
      }
      default:
        return true;  // PRIORITY, PUSH_PROMISE (push is off), unknown
    }
  }

  void read_loop() {
    std::vector<uint8_t> buf(1 << 16);
    size_t have = 0;
    std::string err = "connection closed by the peer";
    for (;;) {
      if (have == buf.size()) buf.resize(buf.size() * 2);
      const ssize_t r = ::recv(fd, buf.data() + have, buf.size() - have, 0);
      if (r <= 0) {
        if (r < 0 && errno == EINTR) continue;
        if (r < 0) err = std::string("connection reset: ") + strerror(errno);
        break;
      }
      have += static_cast<size_t>(r);
      size_t pos = 0;
      std::string out;
      bool ok = true;
      while (have - pos >= 9) {
        const uint8_t* f = buf.data() + pos;
        const uint32_t flen =
            (uint32_t(f[0]) << 16) | (uint32_t(f[1]) << 8) | f[2];
        if (flen > (1u << 24)) {
          ok = false;
          break;
        }
        if (have - pos < 9 + flen) break;
        if (!on_frame(f[3], f[4], get_u32(f + 5) & 0x7fffffff, f + 9, flen,
                      &out)) {
          ok = false;
          break;
        }
        pos += 9 + flen;
      }
      if (pos) {
        std::memmove(buf.data(), buf.data() + pos, have - pos);
        have -= pos;
      }
      if (!out.empty() && !send_raw(out)) ok = false;
      if (!ok) {
        err = "connection lost: protocol error";
        break;
      }
    }
    ::shutdown(fd, SHUT_RDWR);
    {
      std::lock_guard<std::mutex> lock(mu);
      dead = true;
      fail_all_locked(kUnavailable, err);
    }
    reader_done.store(true);
  }
};

bool resolve(const std::string& host, in_addr* out) {
  const std::string h = host.empty() ? "127.0.0.1" : host;
  if (inet_pton(AF_INET, h.c_str(), out) == 1) return true;
  addrinfo hints{};
  hints.ai_family = AF_INET;
  hints.ai_socktype = SOCK_STREAM;
  addrinfo* res = nullptr;
  if (getaddrinfo(h.c_str(), nullptr, &hints, &res) != 0 || !res) return false;
  *out = reinterpret_cast<sockaddr_in*>(res->ai_addr)->sin_addr;
  freeaddrinfo(res);
  return true;
}

// A connected socket, or -1 with `err` set; waits at most until
// `deadline` for the TCP handshake.
int dial(const std::string& host, int port, Clock::time_point deadline,
         std::string* err) {
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_port = htons(static_cast<uint16_t>(port));
  if (!resolve(host, &addr.sin_addr)) {
    *err = "cannot resolve " + host;
    return -1;
  }
  const int fd = ::socket(AF_INET, SOCK_STREAM, 0);
  if (fd < 0) {
    *err = std::string("socket: ") + strerror(errno);
    return -1;
  }
  const int fl = fcntl(fd, F_GETFL, 0);
  fcntl(fd, F_SETFL, fl | O_NONBLOCK);
  int rc = ::connect(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr));
  if (rc != 0 && errno == EINPROGRESS) {
    const int64_t ms = std::chrono::duration_cast<std::chrono::milliseconds>(
                           deadline - Clock::now())
                           .count();
    pollfd pfd{fd, POLLOUT, 0};
    rc = ::poll(&pfd, 1, static_cast<int>(std::max<int64_t>(ms, 0)));
    if (rc <= 0) {
      ::close(fd);
      *err = "connect timed out";
      return -1;
    }
    int soerr = 0;
    socklen_t sl = sizeof(soerr);
    getsockopt(fd, SOL_SOCKET, SO_ERROR, &soerr, &sl);
    if (soerr != 0) {
      ::close(fd);
      *err = std::string("connect: ") + strerror(soerr);
      return -1;
    }
  } else if (rc != 0) {
    *err = std::string("connect: ") + strerror(errno);
    ::close(fd);
    return -1;
  }
  fcntl(fd, F_SETFL, fl);
  int one = 1;
  setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
  // A peer that stops reading must not block a sender forever.
  timeval tv{5, 0};
  setsockopt(fd, SOL_SOCKET, SO_SNDTIMEO, &tv, sizeof(tv));
  return fd;
}

struct Channel {
  // guberlint: guard current, all by mu
  std::string host;
  int port = 0;
  std::string authority;
  std::mutex mu;
  std::shared_ptr<Connection> current;
  std::vector<std::shared_ptr<Connection>> all;  // readers to join
  std::atomic<int64_t> dials{0}, calls{0};

  // Join the readers of connections that are gone.
  void prune_locked() {  // guberlint: holds mu
    for (auto it = all.begin(); it != all.end();) {
      if ((*it)->reader_done.load()) {
        if ((*it)->reader.joinable()) (*it)->reader.join();
        it = all.erase(it);
      } else {
        ++it;
      }
    }
  }

  std::shared_ptr<Connection> get(Clock::time_point deadline,
                                  std::string* err) {
    std::lock_guard<std::mutex> lock(mu);
    if (current && current->usable()) return current;
    prune_locked();
    current.reset();
    const int fd = dial(host, port, deadline, err);
    if (fd < 0) return nullptr;
    dials.fetch_add(1);
    auto c = std::make_shared<Connection>();
    c->fd = fd;
    std::string hello("PRI * HTTP/2.0\r\n\r\nSM\r\n\r\n");
    frame(hello, 12, kSettings, 0, 0);
    const uint8_t settings[12] = {0, 2, 0, 0, 0, 0,  // ENABLE_PUSH 0
                                  0, 4, 0, 0, 0, 0};  // INITIAL_WINDOW_SIZE
    hello.append(reinterpret_cast<const char*>(settings), 12);
    put_u32(reinterpret_cast<uint8_t*>(&hello[hello.size() - 4]),
            static_cast<uint32_t>(kStreamWindow));
    frame(hello, 4, kWindowUpdate, 0, 0);
    uint8_t inc[4];
    put_u32(inc, static_cast<uint32_t>(kConnWindow - 65535));
    hello.append(reinterpret_cast<char*>(inc), 4);
    if (!c->send_raw(hello)) {
      *err = "connection reset during the handshake";
      return nullptr;
    }
    Connection* raw = c.get();
    c->reader = std::thread([raw] { raw->read_loop(); });
    all.push_back(c);
    current = c;
    return c;
  }

  void close_all() {
    std::vector<std::shared_ptr<Connection>> conns;
    {
      std::lock_guard<std::mutex> lock(mu);
      conns.swap(all);
      current.reset();
    }
    for (auto& c : conns) {
      ::shutdown(c->fd, SHUT_RDWR);
      if (c->reader.joinable()) c->reader.join();
    }
  }
};

std::string request_block(const std::string& path,
                          const std::string& authority, int64_t timeout_ms) {
  std::string b;
  hpack::encode_header(b, ":method", "POST");
  hpack::encode_header(b, ":scheme", "http");
  hpack::encode_header(b, ":path", path);
  hpack::encode_header(b, ":authority", authority);
  hpack::encode_header(b, "content-type", "application/grpc");
  hpack::encode_header(b, "te", "trailers");
  if (timeout_ms > 0)
    hpack::encode_header(b, "grpc-timeout", std::to_string(timeout_ms) + "m");
  return b;
}

// One attempt on one connection.  `retry` is set when the call never
// reached the peer's application (GOAWAY, REFUSED_STREAM, or the
// connection died before any of its frames went out).
Result attempt(Channel* ch, const std::string& path, const uint8_t* body,
               int64_t len, int64_t timeout_ms, Clock::time_point deadline,
               bool* retry) {
  *retry = false;
  Result res;
  std::string err;
  auto conn = ch->get(deadline, &err);
  if (!conn) {
    res.status = Clock::now() >= deadline ? kDeadline : kUnavailable;
    res.message = res.status == kDeadline ? "Deadline Exceeded"
                                          : "failed to connect to " + ch->host +
                                                ":" + std::to_string(ch->port) +
                                                ": " + err;
    return res;
  }
  const std::string block = request_block(path, ch->authority, timeout_ms);
  auto call = std::make_shared<Call>();
  {
    // Stream ids go out in the order they are taken: take and send
    // under the write lock.
    std::lock_guard<std::mutex> wl(conn->write_mu);
    uint32_t frame_max;
    {
      std::lock_guard<std::mutex> lock(conn->mu);
      if (conn->dead || conn->goaway) {
        *retry = true;
        res.status = kUnavailable;
        res.message = "connection closing";
        return res;
      }
      call->sid = conn->next_sid;
      conn->next_sid += 2;
      call->send_window = conn->peer_window;
      conn->calls[call->sid] = call;
      frame_max = conn->peer_frame;
    }
    std::string out;
    size_t off = 0;
    do {
      const size_t n = std::min<size_t>(block.size() - off, frame_max);
      const bool first = off == 0, last = off + n == block.size();
      frame(out, static_cast<uint32_t>(n), first ? kHeaders : kContinuation,
            last ? kEndHeaders : 0, call->sid);
      out.append(block, off, n);
      off += n;
    } while (off < block.size());
    if (!conn->send_locked(out)) *retry = true;
  }
  std::string msg(5, '\0');
  put_u32(reinterpret_cast<uint8_t*>(&msg[1]), static_cast<uint32_t>(len));
  msg.append(reinterpret_cast<const char*>(body), static_cast<size_t>(len));
  size_t sent = 0;
  bool timed_out = false;
  while (!*retry) {
    size_t chunk = 0;
    {
      std::unique_lock<std::mutex> lock(conn->mu);
      conn->cv.wait_until(lock, deadline, [&] {
        return call->done || conn->dead ||
               (conn->conn_window > 0 && call->send_window > 0);
      });
      if (call->done || conn->dead) break;
      if (Clock::now() >= deadline) {
        timed_out = true;
        break;
      }
      chunk = static_cast<size_t>(std::min<int64_t>(
          {conn->conn_window, call->send_window,
           static_cast<int64_t>(conn->peer_frame),
           static_cast<int64_t>(msg.size() - sent)}));
      conn->conn_window -= static_cast<int64_t>(chunk);
      call->send_window -= static_cast<int64_t>(chunk);
    }
    std::string out;
    const bool last = sent + chunk == msg.size();
    frame(out, static_cast<uint32_t>(chunk), kData, last ? kEndStream : 0,
          call->sid);
    out.append(msg, sent, chunk);
    if (!conn->send_raw(out)) break;  // the reader fails the call
    sent += chunk;
    if (last) break;
  }
  const bool unsent = sent < msg.size();  // END_STREAM never went out
  {
    std::unique_lock<std::mutex> lock(conn->mu);
    if (!timed_out && !*retry)
      conn->cv.wait_until(lock, deadline, [&] { return call->done; });
    if (!call->done) {
      if (*retry) {
        res.status = kUnavailable;
        res.message = "connection reset";
      } else {
        timed_out = true;
      }
    } else {
      res = call->result;
      // The peer cannot have served a request whose END_STREAM it never
      // got: a connection lost before then is safe to dial again.
      *retry = call->refused || (unsent && res.status == kUnavailable);
    }
    conn->calls.erase(call->sid);
  }
  if (!timed_out && unsent && !*retry) {
    // Answered before the request's end (an early error reply): close
    // our half of the stream.
    std::string rst;
    frame(rst, 4, kRst, 0, call->sid);
    rst.append(4, '\0');  // NO_ERROR
    conn->send_raw(rst);
  }
  if (timed_out) {
    std::string rst;
    frame(rst, 4, kRst, 0, call->sid);
    uint8_t code[4];
    put_u32(code, 0x8);  // CANCEL
    rst.append(reinterpret_cast<char*>(code), 4);
    conn->send_raw(rst);
    res.status = kDeadline;
    res.message = "Deadline Exceeded";
    *retry = false;
  }
  return res;
}

void write_headers(const std::vector<hpack::Header>& hs, std::string* out) {
  for (const auto& h : hs) {
    uint8_t n[4];
    put_u32(n, static_cast<uint32_t>(h.name.size()));
    out->append(reinterpret_cast<char*>(n), 4);
    out->append(h.name);
    put_u32(n, static_cast<uint32_t>(h.value.size()));
    out->append(reinterpret_cast<char*>(n), 4);
    out->append(h.value);
  }
}

bool read_headers(const uint8_t* p, int64_t len,
                  std::vector<hpack::Header>* out) {
  const uint8_t* end = p + len;
  while (p < end) {
    hpack::Header h;
    for (std::string* s : {&h.name, &h.value}) {
      if (end - p < 4) return false;
      const uint32_t n = get_u32(p);
      p += 4;
      if (static_cast<int64_t>(n) > end - p) return false;
      s->assign(reinterpret_cast<const char*>(p), n);
      p += n;
    }
    out->push_back(std::move(h));
  }
  return true;
}

int64_t copy_out(const std::string& s, uint8_t* out, int64_t cap) {
  if (static_cast<int64_t>(s.size()) > cap) return -2;
  std::memcpy(out, s.data(), s.size());
  return static_cast<int64_t>(s.size());
}

}  // namespace

extern "C" {

// A channel to host:port; nothing is dialed until the first call.
void* h2c_channel_new(const char* host, int32_t port) {
  auto* ch = new Channel();
  ch->host = host;
  ch->port = port;
  ch->authority = ch->host + ":" + std::to_string(port);
  return ch;
}

// Close every connection (their pending calls fail UNAVAILABLE) and
// free the channel; no call may be running.
void h2c_channel_free(void* handle) {
  auto* ch = static_cast<Channel*>(handle);
  ch->close_all();
  delete ch;
}

// out: [0] dials, [1] calls, [2] connections whose reader runs.
void h2c_channel_stats(void* handle, int64_t* out) {
  auto* ch = static_cast<Channel*>(handle);
  out[0] = ch->dials.load();
  out[1] = ch->calls.load();
  std::lock_guard<std::mutex> lock(ch->mu);
  int64_t live = 0;
  for (auto& c : ch->all) live += c->reader_done.load() ? 0 : 1;
  out[2] = live;
}

// One unary call; timeout_ms <= 0 waits without a deadline (a day).
// Returns a result handle (never null) for h2c_result_* and
// h2c_result_free.
// guberlint: gil-free
void* h2c_call(void* handle, const char* path, const uint8_t* body,
               int64_t len, int64_t timeout_ms) {
  auto* ch = static_cast<Channel*>(handle);
  ch->calls.fetch_add(1);
  const auto deadline =
      Clock::now() + std::chrono::milliseconds(
                         timeout_ms > 0 ? timeout_ms : 86400LL * 1000);
  bool retry = false;
  Result r = attempt(ch, path, body, len, timeout_ms, deadline, &retry);
  if (retry && Clock::now() < deadline)
    r = attempt(ch, path, body, len, timeout_ms, deadline, &retry);
  return new Result(std::move(r));
}

int32_t h2c_result_status(void* res) {
  return static_cast<Result*>(res)->status;
}

// which: 0 the response message body, 1 the grpc-message.
int64_t h2c_result_len(void* res, int32_t which) {
  auto* r = static_cast<Result*>(res);
  return static_cast<int64_t>(which == 0 ? r->body.size() : r->message.size());
}

const uint8_t* h2c_result_ptr(void* res, int32_t which) {
  auto* r = static_cast<Result*>(res);
  return reinterpret_cast<const uint8_t*>(which == 0 ? r->body.data()
                                                     : r->message.data());
}

void h2c_result_free(void* res) { delete static_cast<Result*>(res); }

// HPACK entry points for the tests.  A header list crosses as
// (u32 name length, name, u32 value length, value) records.
void* hpack_decoder_new(int64_t limit) {
  return new hpack::Decoder(static_cast<size_t>(limit));
}

void hpack_decoder_free(void* d) { delete static_cast<hpack::Decoder*>(d); }

void hpack_decoder_set_limit(void* d, int64_t limit) {
  static_cast<hpack::Decoder*>(d)->set_limit(static_cast<size_t>(limit));
}

// Decode one block: bytes written, -1 on a COMPRESSION_ERROR, -2 when
// `out` is too small.
int64_t hpack_decoder_decode(void* d, const uint8_t* block, int64_t len,
                             uint8_t* out, int64_t cap) {
  std::vector<hpack::Header> hs;
  if (!static_cast<hpack::Decoder*>(d)->decode(block, static_cast<size_t>(len),
                                               &hs))
    return -1;
  std::string s;
  write_headers(hs, &s);
  return copy_out(s, out, cap);
}

// The dynamic table, newest first; `size_out` gets its size in octets.
int64_t hpack_decoder_table(void* d, uint8_t* out, int64_t cap,
                            int64_t* size_out) {
  auto* dec = static_cast<hpack::Decoder*>(d);
  std::vector<hpack::Header> hs;
  for (size_t i = 0; i < dec->entries(); ++i) hs.push_back(dec->entry(i));
  *size_out = static_cast<int64_t>(dec->size());
  std::string s;
  write_headers(hs, &s);
  return copy_out(s, out, cap);
}

// The encoder over a header list: bytes written, -1 on a malformed
// list, -2 when `out` is too small.
int64_t hpack_encode(const uint8_t* in, int64_t len, uint8_t* out,
                     int64_t cap) {
  std::vector<hpack::Header> hs;
  if (!read_headers(in, len, &hs)) return -1;
  std::string s;
  for (const auto& h : hs) hpack::encode_header(s, h.name, h.value);
  return copy_out(s, out, cap);
}

int64_t hpack_huffman_encode(const uint8_t* in, int64_t len, uint8_t* out,
                             int64_t cap) {
  return copy_out(
      hpack::huff_encode(std::string(reinterpret_cast<const char*>(in),
                                     static_cast<size_t>(len))),
      out, cap);
}

// -1 on an invalid code (EOS inside, bad padding).
int64_t hpack_huffman_decode(const uint8_t* in, int64_t len, uint8_t* out,
                             int64_t cap) {
  std::string s;
  if (!hpack::huff_decode(in, static_cast<size_t>(len), &s)) return -1;
  return copy_out(s, out, cap);
}

}  // extern "C"
