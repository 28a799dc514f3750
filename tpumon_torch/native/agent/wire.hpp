// wire.hpp — minimal protobuf-convention writer/reader for the binary
// sweep_frame op.  Counterpart of tpumon_torch/wire.py (write_varint /
// iter_fields): same varint semantics (64-bit mask, canonical emission,
// 10-byte read cap), same framing conventions.  Keep the three in sync:
// this header, tpumon_torch/sweepframe.py, agent/protocol.md.

#pragma once

#include <cstdint>
#include <cstring>
#include <string>

namespace tpumon {
namespace wire {

inline void put_varint(std::string* out, unsigned long long v) {
  while (v >= 0x80) {
    out->push_back(static_cast<char>((v & 0x7F) | 0x80));
    v >>= 7;
  }
  out->push_back(static_cast<char>(v));
}

inline void put_tag(std::string* out, int field, int wt) {
  put_varint(out, (static_cast<unsigned long long>(field) << 3) |
                      static_cast<unsigned long long>(wt));
}

inline void put_varint_field(std::string* out, int field,
                             unsigned long long v) {
  put_tag(out, field, 0);
  put_varint(out, v);
}

// proto sint64 zigzag: negative ints must not cost 10 varint bytes
inline unsigned long long zigzag(long long v) {
  return (static_cast<unsigned long long>(v) << 1) ^
         static_cast<unsigned long long>(v >> 63);
}

inline void put_double_field(std::string* out, int field, double v) {
  put_tag(out, field, 1);
  uint64_t bits;
  memcpy(&bits, &v, sizeof(bits));
  for (int i = 0; i < 8; i++)
    out->push_back(static_cast<char>((bits >> (8 * i)) & 0xFF));
}

inline void put_len_field(std::string* out, int field,
                          const std::string& payload) {
  put_tag(out, field, 2);
  put_varint(out, payload.size());
  out->append(payload);
}

// ---- reader (for the binary sweep request) ----------------------------------
// Mirrors tpumon_torch/wire.py's walker semantics: varints masked to 64 bits,
// capped at 10 bytes; truncation / unknown wire types flip ok to false
// (the caller answers a malformed-request error, never crashes).

class Reader {
 public:
  Reader(const uint8_t* data, size_t n) : p_(data), n_(n) {}

  bool ok() const { return ok_; }
  bool done() const { return pos_ >= n_ || !ok_; }

  unsigned long long varint() {
    unsigned long long v = 0;
    int shift = 0;
    size_t start = pos_;
    while (true) {
      if (pos_ >= n_ || pos_ - start >= 10) {
        ok_ = false;
        return 0;
      }
      uint8_t b = p_[pos_++];
      v |= static_cast<unsigned long long>(b & 0x7F) << shift;
      if (!(b & 0x80)) return v;  // natural 64-bit wraparound == mask
      shift += 7;
    }
  }

  // next field key -> (field, wt); false at clean end of buffer
  bool next_key(int* field, int* wt) {
    if (done()) return false;
    unsigned long long key = varint();
    if (!ok_) return false;
    *field = static_cast<int>(key >> 3);
    *wt = static_cast<int>(key & 0x07);
    return true;
  }

  // wire-type-2 payload -> (ptr, len).  Bounds check is phrased as
  // "length > remaining" — `pos_ + l > n_` would wrap size_t for a
  // hostile 2^64-ish varint length and accept an out-of-bounds range.
  bool bytes_field(const uint8_t** data, size_t* len) {
    unsigned long long l = varint();
    if (!ok_ || l > static_cast<unsigned long long>(n_ - pos_)) {
      ok_ = false;
      return false;
    }
    *data = p_ + pos_;
    *len = static_cast<size_t>(l);
    pos_ += l;
    return true;
  }

  bool fixed64(unsigned long long* v) {
    if (pos_ + 8 > n_) {
      ok_ = false;
      return false;
    }
    unsigned long long out = 0;
    for (int i = 0; i < 8; i++)
      out |= static_cast<unsigned long long>(p_[pos_ + i]) << (8 * i);
    pos_ += 8;
    *v = out;
    return true;
  }

  // skip one value of wire type wt (for forward-compatible fields)
  bool skip(int wt) {
    if (wt == 0) {
      varint();
    } else if (wt == 1) {
      unsigned long long v;
      fixed64(&v);
    } else if (wt == 2) {
      const uint8_t* d;
      size_t l;
      bytes_field(&d, &l);
    } else {
      ok_ = false;
    }
    return ok_;
  }

 private:
  const uint8_t* p_;
  size_t n_;
  size_t pos_ = 0;
  bool ok_ = true;
};

}  // namespace wire
}  // namespace tpumon
