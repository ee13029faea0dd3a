// HPACK (RFC 7541) for the port's h2 server (routing mode) and its
// unary client: the static table (Appendix A), the dynamic table with
// its size updates and the SETTINGS_HEADER_TABLE_SIZE limit, integer and
// string literals, and the Huffman code (Appendix B).  The decoder takes
// every representation a peer may send: grpcio's C-core indexes headers
// into the dynamic table and may Huffman-code them, so the second RPC on
// a connection can name its :path by a dynamic index alone.  The encoder
// is the small one: static-table indexes and literals without indexing,
// no Huffman, so it never touches the peer's dynamic table.
//
// The Huffman code is canonical: codes of one length are consecutive and
// ordered by symbol, so the table below is only each symbol's code
// length (Appendix B); its Kraft sum is exactly 1, and the Appendix C
// vectors pin it (tests/test_torch_hpack.py).
#pragma once

#include <cstddef>
#include <cstdint>
#include <deque>
#include <string>
#include <vector>

namespace hpack {

struct Header {
  std::string name;
  std::string value;
};

// Appendix A, indexes 1..61.
inline const char* const kStatic[61][2] = {
    {":authority", ""}, {":method", "GET"}, {":method", "POST"},
    {":path", "/"}, {":path", "/index.html"}, {":scheme", "http"},
    {":scheme", "https"}, {":status", "200"}, {":status", "204"},
    {":status", "206"}, {":status", "304"}, {":status", "400"},
    {":status", "404"}, {":status", "500"}, {"accept-charset", ""},
    {"accept-encoding", "gzip, deflate"}, {"accept-language", ""},
    {"accept-ranges", ""}, {"accept", ""},
    {"access-control-allow-origin", ""}, {"age", ""}, {"allow", ""},
    {"authorization", ""}, {"cache-control", ""},
    {"content-disposition", ""}, {"content-encoding", ""},
    {"content-language", ""}, {"content-length", ""},
    {"content-location", ""}, {"content-range", ""}, {"content-type", ""},
    {"cookie", ""}, {"date", ""}, {"etag", ""}, {"expect", ""},
    {"expires", ""}, {"from", ""}, {"host", ""}, {"if-match", ""},
    {"if-modified-since", ""}, {"if-none-match", ""}, {"if-range", ""},
    {"if-unmodified-since", ""}, {"last-modified", ""}, {"link", ""},
    {"location", ""}, {"max-forwards", ""}, {"proxy-authenticate", ""},
    {"proxy-authorization", ""}, {"range", ""}, {"referer", ""},
    {"refresh", ""}, {"retry-after", ""}, {"server", ""},
    {"set-cookie", ""}, {"strict-transport-security", ""},
    {"transfer-encoding", ""}, {"user-agent", ""}, {"vary", ""},
    {"via", ""}, {"www-authenticate", ""},
};
constexpr size_t kStaticCount = 61;

// Appendix B: the code length of each symbol 0..255 and of EOS (256).
inline const uint8_t kHuffLen[257] = {
    13, 23, 28, 28, 28, 28, 28, 28, 28, 24, 30, 28, 28, 30, 28, 28, 28, 28,
    28, 28, 28, 28, 30, 28, 28, 28, 28, 28, 28, 28, 28, 28, 6,  10, 10, 12,
    13, 6,  8,  11, 10, 10, 8,  11, 8,  6,  6,  6,  5,  5,  5,  6,  6,  6,
    6,  6,  6,  6,  7,  8,  15, 6,  12, 10, 13, 6,  7,  7,  7,  7,  7,  7,
    7,  7,  7,  7,  7,  7,  7,  7,  7,  7,  7,  7,  7,  7,  7,  7,  8,  7,
    8,  13, 19, 13, 14, 6,  15, 5,  6,  5,  6,  5,  6,  6,  6,  5,  7,  7,
    6,  6,  6,  5,  6,  7,  6,  5,  5,  6,  7,  7,  7,  7,  7,  15, 11, 14,
    13, 28, 20, 22, 20, 20, 22, 22, 22, 23, 22, 23, 23, 23, 23, 23, 24, 23,
    24, 24, 22, 23, 24, 23, 23, 23, 23, 21, 22, 23, 22, 23, 23, 24, 22, 21,
    20, 22, 22, 23, 23, 21, 23, 22, 22, 24, 21, 22, 23, 23, 21, 21, 22, 21,
    23, 22, 23, 23, 20, 22, 22, 22, 23, 22, 22, 23, 26, 26, 20, 19, 22, 23,
    22, 25, 26, 26, 26, 27, 27, 26, 24, 25, 19, 21, 26, 27, 27, 26, 27, 24,
    21, 21, 26, 26, 28, 27, 27, 27, 20, 24, 20, 21, 22, 21, 21, 23, 22, 22,
    25, 25, 24, 24, 26, 23, 26, 27, 26, 26, 27, 27, 27, 27, 27, 28, 27, 27,
    27, 27, 27, 26, 30,
};
constexpr int kHuffMaxLen = 30;
constexpr int kEos = 256;

// The canonical code, built once: symbols sorted by (length, symbol),
// the count of codes of each length, and each symbol's code.
struct HuffTable {
  uint16_t sorted[257];
  uint16_t count[kHuffMaxLen + 1];
  uint32_t code[257];

  HuffTable() {
    for (int l = 0; l <= kHuffMaxLen; ++l) count[l] = 0;
    for (int s = 0; s < 257; ++s) ++count[kHuffLen[s]];
    int n = 0;
    for (int l = 1; l <= kHuffMaxLen; ++l)
      for (int s = 0; s < 257; ++s)
        if (kHuffLen[s] == l) sorted[n++] = static_cast<uint16_t>(s);
    uint32_t c = 0;
    int prev = 0;
    for (int i = 0; i < 257; ++i) {
      const int s = sorted[i];
      c <<= (kHuffLen[s] - prev);
      prev = kHuffLen[s];
      code[s] = c++;
    }
  }
};

inline const HuffTable& huff_table() {
  static const HuffTable t;
  return t;
}

// Decode a Huffman-coded string (RFC 7541 §5.2): false on an EOS symbol,
// on padding longer than 7 bits, or on padding that is not the EOS
// prefix (all ones).
inline bool huff_decode(const uint8_t* p, size_t n, std::string* out) {
  const HuffTable& t = huff_table();
  uint32_t code = 0, first = 0;
  int len = 0, index = 0;
  bool all_ones = true;
  for (size_t i = 0; i < n; ++i) {
    for (int b = 7; b >= 0; --b) {
      const uint32_t bit = (p[i] >> b) & 1;
      code |= bit;
      all_ones = all_ones && bit;
      ++len;
      const uint32_t cnt = t.count[len];
      if (code - first < cnt) {
        const int sym = t.sorted[index + static_cast<int>(code - first)];
        if (sym == kEos) return false;
        out->push_back(static_cast<char>(sym));
        code = first = 0;
        len = index = 0;
        all_ones = true;
        continue;
      }
      if (len == kHuffMaxLen) return false;
      index += static_cast<int>(cnt);
      first = (first + cnt) << 1;
      code <<= 1;
    }
  }
  return len <= 7 && all_ones;
}

// Huffman-encode (tests use it; the encoder below does not).
inline std::string huff_encode(const std::string& s) {
  const HuffTable& t = huff_table();
  std::string out;
  uint64_t acc = 0;
  int bits = 0;
  for (unsigned char ch : s) {
    acc = (acc << kHuffLen[ch]) | t.code[ch];
    bits += kHuffLen[ch];
    while (bits >= 8) {
      bits -= 8;
      out.push_back(static_cast<char>((acc >> bits) & 0xff));
    }
  }
  if (bits > 0)
    out.push_back(
        static_cast<char>(((acc << (8 - bits)) | ((1u << (8 - bits)) - 1)) &
                          0xff));
  return out;
}

// An integer with an N-bit prefix (§5.1); `first` carries the
// representation's flag bits above the prefix.
inline void encode_int(std::string& out, uint64_t v, int prefix,
                       uint8_t first) {
  const uint64_t max = (1u << prefix) - 1;
  if (v < max) {
    out.push_back(static_cast<char>(first | v));
    return;
  }
  out.push_back(static_cast<char>(first | max));
  v -= max;
  while (v >= 128) {
    out.push_back(static_cast<char>((v & 0x7f) | 0x80));
    v >>= 7;
  }
  out.push_back(static_cast<char>(v));
}

// false on truncation or a value past 2^32 (no header is that long).
inline bool decode_int(const uint8_t*& p, const uint8_t* end, int prefix,
                       uint64_t* out) {
  if (p >= end) return false;
  const uint64_t max = (1u << prefix) - 1;
  uint64_t v = *p++ & max;
  if (v < max) {
    *out = v;
    return true;
  }
  for (int shift = 0; shift <= 28; shift += 7) {
    if (p >= end) return false;
    const uint8_t b = *p++;
    v += static_cast<uint64_t>(b & 0x7f) << shift;
    if (!(b & 0x80)) {
      if (v > 0xffffffffull) return false;
      *out = v;
      return true;
    }
  }
  return false;
}

inline void encode_str(std::string& out, const std::string& s) {
  encode_int(out, s.size(), 7, 0x00);
  out += s;
}

inline bool decode_str(const uint8_t*& p, const uint8_t* end,
                       std::string* out) {
  if (p >= end) return false;
  const bool huff = (*p & 0x80) != 0;
  uint64_t n;
  if (!decode_int(p, end, 7, &n)) return false;
  if (n > static_cast<uint64_t>(end - p)) return false;
  out->clear();
  if (huff) {
    if (!huff_decode(p, static_cast<size_t>(n), out)) return false;
  } else {
    out->assign(reinterpret_cast<const char*>(p), static_cast<size_t>(n));
  }
  p += n;
  return true;
}

// One field, stateless: an exact static match is indexed, a static name
// is referenced by index, anything else goes as a literal name; always
// "without indexing", never Huffman.
inline void encode_header(std::string& out, const std::string& name,
                          const std::string& value) {
  size_t name_idx = 0;
  for (size_t i = 0; i < kStaticCount; ++i) {
    if (name != kStatic[i][0]) continue;
    if (value == kStatic[i][1]) {
      encode_int(out, i + 1, 7, 0x80);
      return;
    }
    if (name_idx == 0) name_idx = i + 1;
  }
  encode_int(out, name_idx, 4, 0x00);
  if (name_idx == 0) encode_str(out, name);
  encode_str(out, value);
}

class Decoder {
 public:
  // `limit` is the SETTINGS_HEADER_TABLE_SIZE this side advertised
  // (4096 unless it sent another): the peer's size updates may not
  // exceed it.
  explicit Decoder(size_t limit = 4096) : limit_(limit), max_(limit) {}

  void set_limit(size_t limit) {
    limit_ = limit;
    if (max_ > limit_) resize(limit_);
  }
  size_t size() const { return size_; }
  size_t max_size() const { return max_; }
  size_t entries() const { return table_.size(); }
  const Header& entry(size_t i) const { return table_[i]; }

  // Decode one complete header block; false is a COMPRESSION_ERROR (the
  // connection is lost: the table is no longer in step with the peer's).
  bool decode(const uint8_t* p, size_t n, std::vector<Header>* out) {
    const uint8_t* end = p + n;
    bool fields_seen = false;
    while (p < end) {
      const uint8_t b = *p;
      if (b & 0x80) {  // indexed field
        uint64_t idx;
        if (!decode_int(p, end, 7, &idx)) return false;
        const Header* h = lookup(idx);
        if (h == nullptr) return false;
        out->push_back(*h);
        fields_seen = true;
      } else if ((b & 0xe0) == 0x20) {  // dynamic table size update
        uint64_t v;
        if (fields_seen || !decode_int(p, end, 5, &v) || v > limit_)
          return false;
        resize(static_cast<size_t>(v));
      } else {
        // 01 literal with incremental indexing (6-bit name index);
        // 0000 without indexing, 0001 never indexed (4-bit).
        const bool index = (b & 0xc0) == 0x40;
        uint64_t name_idx;
        if (!decode_int(p, end, index ? 6 : 4, &name_idx)) return false;
        Header h;
        if (name_idx == 0) {
          if (!decode_str(p, end, &h.name)) return false;
        } else {
          const Header* nh = lookup(name_idx);
          if (nh == nullptr) return false;
          h.name = nh->name;
        }
        if (!decode_str(p, end, &h.value)) return false;
        if (index) add(h);
        out->push_back(std::move(h));
        fields_seen = true;
      }
    }
    return true;
  }

 private:
  const Header* lookup(uint64_t idx) {
    if (idx == 0) return nullptr;
    if (idx <= kStaticCount) {
      scratch_.name = kStatic[idx - 1][0];
      scratch_.value = kStatic[idx - 1][1];
      return &scratch_;
    }
    const uint64_t d = idx - kStaticCount - 1;
    if (d >= table_.size()) return nullptr;
    return &table_[static_cast<size_t>(d)];
  }

  static size_t entry_size(const Header& h) {
    return h.name.size() + h.value.size() + 32;
  }

  void evict_to(size_t cap) {
    while (size_ > cap && !table_.empty()) {
      size_ -= entry_size(table_.back());
      table_.pop_back();
    }
  }

  void resize(size_t v) {
    max_ = v;
    evict_to(max_);
  }

  // §4.4: an entry larger than the table empties it and is not added.
  void add(const Header& h) {
    const size_t s = entry_size(h);
    if (s > max_) {
      evict_to(0);
      return;
    }
    evict_to(max_ - s);
    table_.push_front(h);
    size_ += s;
  }

  size_t limit_;
  size_t max_;
  size_t size_ = 0;
  std::deque<Header> table_;  // newest first: index 62 is table_[0]
  Header scratch_;
};

// grpc-timeout (gRPC over HTTP/2): 1-8 digits and a unit H M S m u n;
// nanoseconds, or -1 when malformed.
inline int64_t parse_grpc_timeout(const std::string& v) {
  if (v.size() < 2 || v.size() > 9) return -1;
  int64_t n = 0;
  for (size_t i = 0; i + 1 < v.size(); ++i) {
    if (v[i] < '0' || v[i] > '9') return -1;
    n = n * 10 + (v[i] - '0');
  }
  switch (v.back()) {
    case 'H': return n * 3600LL * 1000000000LL;
    case 'M': return n * 60LL * 1000000000LL;
    case 'S': return n * 1000000000LL;
    case 'm': return n * 1000000LL;
    case 'u': return n * 1000LL;
    case 'n': return n;
    default: return -1;
  }
}

// grpc-message percent-encoding: bytes outside 0x20..0x7e, and '%'.
inline std::string percent_encode(const std::string& s) {
  static const char kHex[] = "0123456789ABCDEF";
  std::string out;
  for (unsigned char c : s) {
    if (c < 0x20 || c > 0x7e || c == '%') {
      out.push_back('%');
      out.push_back(kHex[c >> 4]);
      out.push_back(kHex[c & 15]);
    } else {
      out.push_back(static_cast<char>(c));
    }
  }
  return out;
}

inline std::string percent_decode(const std::string& s) {
  auto hex = [](char c) -> int {
    if (c >= '0' && c <= '9') return c - '0';
    if (c >= 'a' && c <= 'f') return c - 'a' + 10;
    if (c >= 'A' && c <= 'F') return c - 'A' + 10;
    return -1;
  };
  std::string out;
  for (size_t i = 0; i < s.size(); ++i) {
    if (s[i] == '%' && i + 2 < s.size() && hex(s[i + 1]) >= 0 &&
        hex(s[i + 2]) >= 0) {
      out.push_back(static_cast<char>(hex(s[i + 1]) * 16 + hex(s[i + 2])));
      i += 2;
    } else {
      out.push_back(s[i]);
    }
  }
  return out;
}

}  // namespace hpack
