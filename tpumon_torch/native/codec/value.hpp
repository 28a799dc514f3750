// value.hpp — the native value model of the shared codec core.
//
// One NValue mirrors one Python FieldValue as the sweep-frame codec
// sees it: None / bool / int / float / str / list-of-scalars, with
// EXACT (type, value) identity semantics — the delta compare the
// Python reference (tpumon_torch/sweepframe.py `_unchanged` and the inlined
// encode_frame compare) performs:
//
//   * kinds must match exactly (bool is NOT int, int is NOT float —
//     `1` / `1.0` / `True` are == in Python but different wire values);
//   * floats compare IEEE == (NaN never equals itself, so a NaN value
//     re-emits every frame exactly like the reference; -0.0 == 0.0);
//   * vectors compare by length, element kind and element value;
//   * ints beyond the 64-bit range (kBigInt) carry only their masked
//     zigzag — the binding layer performs the exact Python == against
//     the cached table object before ever reaching this compare.
//
// Keep this header pure C++ (no Python API): the TSan smoke harness
// (testlib/codec_smoke_main.cc) drives the core from raw
// threads, and the bindings (codec/module.cc) stay the only
// layer that knows about PyObject.

#pragma once

#include <cmath>
#include <cstdint>
#include <string>
#include <vector>

namespace tpumon {
namespace codec {

struct NValue {
  enum Kind : uint8_t {
    kBlank = 0,   // Python None
    kBool = 1,    // Python bool (wire: zigzag int, table: bool)
    kInt = 2,     // Python int fitting int64
    kBigInt = 3,  // Python int beyond int64: zig holds the masked zigzag
    kFloat = 4,   // Python float (non-finite serializes as blank)
    kStr = 5,     // Python str as its UTF-8 bytes
    kVec = 6,     // Python list of scalars
  };

  struct Elem {
    uint8_t kind = kBlank;  // kBlank / kBool / kInt / kBigInt / kFloat
    long long i = 0;                 // kBool / kInt
    unsigned long long zig = 0;      // kBigInt (masked zigzag payload)
    double d = 0;                    // kFloat
    // encoder-side identity cookie (an owned PyObject* managed by the
    // binding): Python's list == short-circuits on ELEMENT identity
    // before calling __eq__, so [nan_obj] == [nan_obj] is True for the
    // same object — the value alone cannot reproduce that
    void* cookie = nullptr;
  };

  Kind kind = kBlank;
  long long i = 0;
  unsigned long long zig = 0;  // kBigInt only
  double d = 0;
  std::string s;               // kStr only (UTF-8)
  std::vector<Elem> vec;       // kVec only

  static bool elem_eq(const Elem& a, const Elem& b) {
    // Python list ==: `x is y or x == y` per element (same object ⇒
    // same class, so the separate class pass agrees)
    if (a.cookie != nullptr && a.cookie == b.cookie) return true;
    if (a.kind != b.kind) return false;
    switch (a.kind) {
      case kBlank: return true;
      case kBool:
      case kInt: return a.i == b.i;
      // masked-zigzag equality: exact for every int the wire can
      // distinguish (the binding never stores kBigInt elements for
      // values that fit int64)
      case kBigInt: return a.zig == b.zig;
      case kFloat: return a.d == b.d;  // IEEE: NaN != NaN
      default: return false;
    }
  }

  // (type, value) identity — Python `prev.__class__ is v.__class__ and
  // prev == v` with per-element class checks for vectors.  kBigInt
  // scalars are NEVER compared here (the binding resolves them with a
  // real Python ==); returning false re-emits, which is the
  // conservative direction.
  bool equals(const NValue& o) const {
    if (kind != o.kind) return false;
    switch (kind) {
      case kBlank: return true;
      case kBool:
      case kInt: return i == o.i;
      case kBigInt: return false;
      case kFloat: return d == o.d;  // IEEE: NaN != NaN
      case kStr: return s == o.s;
      case kVec: {
        if (vec.size() != o.vec.size()) return false;
        for (size_t k = 0; k < vec.size(); k++)
          if (!elem_eq(vec[k], o.vec[k])) return false;
        return true;
      }
    }
    return false;
  }
};

inline bool is_finite(double v) { return std::isfinite(v); }

}  // namespace codec
}  // namespace tpumon
