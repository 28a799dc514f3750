// core.hpp — the shared native codec core: encoder delta table, decoder
// mirror, burst accumulator.  Pure C++ (no Python API) so the TSan
// smoke harness (testlib/codec_smoke_main.cc) can drive it from
// raw threads; codec/module.cc is the CPython binding.
//
// EXECUTABLE SPEC: tpumon_torch/sweepframe.py (PySweepFrameEncoder /
// PySweepFrameDecoder) and tpumon_torch/burst.py (PyBurstAccumulator).  Every
// byte this core emits and every mirror mutation it performs must be
// identical to the Python reference — the backend-parametrized
// differential fuzz (tests/test_torch_codec_native.py) pins the two,
// frame for frame.  That includes
// the reference's error strings (callers and tests match on them) and
// its exact bounds-checking quirks (nested varints are bounded by the
// WHOLE payload, fixed64/strings by their submessage end — see
// tpumon_torch/wire.py read_varint and the inlined SweepFrameDecoder.apply).
//
// Cookie contract: each encoder cell / decoder mirror cell carries one
// opaque `void*` the binding layer owns (a borrowed-then-owned
// PyObject* used for identity fast-paths and materialize caching).
// The core NEVER dereferences a cookie; every cookie it drops is
// appended to the caller's `released` vector so the binding can
// DECREF after it holds the GIL again.  This is what lets encode /
// decode run entirely outside the GIL.

#pragma once

#include <cstdint>
#include <cstring>
#include <memory>
#include <string>
#include <unordered_map>
#include <unordered_set>
#include <vector>

#include "value.hpp"

namespace tpumon {
namespace codec {

// ---- wire constants (the facades in tpumon_torch/sweepframe.py and
// tpumon_torch/burst.py refuse a build whose values differ) ------------------

constexpr int kSweepReqMagic = 0xA6;    // SWEEP_REQ_MAGIC
constexpr int kSweepFrameMagic = 0xA9;  // SWEEP_FRAME_MAGIC
constexpr double kNumIntLimit = 9.0e15;  // NUM_INT_LIMIT
constexpr int kBurstIdBase = 2000;       // fields.BURST_ID_BASE

// frame payload fields (agent/protocol.md)
constexpr int kFrameFieldIndex = 1;
constexpr int kFrameFieldChip = 2;
constexpr int kFrameFieldRemoved = 3;
constexpr int kFrameFieldEvent = 4;
// value entry fields
constexpr int kValueFieldId = 1;
constexpr int kValueFieldInt = 2;
constexpr int kValueFieldVec = 3;
constexpr int kValueFieldBlank = 4;
constexpr int kValueFieldStr = 5;
constexpr int kValueFieldDouble = 6;

// ---- wire write helpers (tpumon_torch/wire.py writer twin) ------------------

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

inline void put_double(std::string* out, double v) {
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

inline unsigned long long zigzag(long long v) {
  return (static_cast<unsigned long long>(v) << 1) ^
         static_cast<unsigned long long>(v >> 63);
}

// ---- wire read helpers (tpumon_torch/wire.py read_varint twin: 64-bit mask,
// 10-byte cap, the reference's exact error strings) ---------------------------

struct ParseState {
  const uint8_t* data;
  size_t n;     // whole-payload bound (varints are bounded by THIS,
                // not by any enclosing submessage — reference quirk)
  size_t pos = 0;
  std::string error;  // empty = ok

  bool fail(const char* msg) {
    if (error.empty()) error = msg;
    return false;
  }

  // one varint; on error sets `error` and returns 0
  unsigned long long varint() {
    unsigned long long result = 0;
    int shift = 0;
    size_t start = pos;
    while (true) {
      if (pos >= n) {
        fail("truncated varint");
        return 0;
      }
      uint8_t b = data[pos];
      pos++;
      if (shift < 64)
        result |= static_cast<unsigned long long>(b & 0x7F) << shift;
      if (!(b & 0x80)) return result;  // natural wraparound == & MASK64
      shift += 7;
      if (pos - start >= 10) {
        fail("varint too long");
        return 0;
      }
    }
  }
};

// ---- encoder ----------------------------------------------------------------

struct EncCell {
  NValue v;
  void* cookie = nullptr;
};

// queue every binding-owned ref a value carries (vector element
// cookies) for the post-GIL decref drain
inline void release_value_refs(const NValue& v,
                               std::vector<void*>* released) {
  if (v.kind != NValue::kVec) return;
  for (const NValue::Elem& e : v.vec)
    if (e.cookie != nullptr) released->push_back(e.cookie);
}

struct EncChip {
  long long idx = 0;
  bool dead = false;
  std::unordered_map<long long, EncCell> cells;
};

// one converted (chip, fid, value) the binding found NOT identity-equal
// to the table; the core decides changed-vs-unchanged by value
struct PendEntry {
  long long fid = 0;
  NValue v;
  void* cookie = nullptr;  // owned ref the binding took; core stores it
                           // on change or returns it via `released`
                           // when unchanged
};

// one input chip (in input order) with its pending entries as a range
// into the flat entry arena — flat so the binding can reuse capacity
// across calls
struct PendChip {
  long long idx;
  size_t begin;
  size_t end;
};

class EncoderCore {
 public:
  explicit EncoderCore(long long start_index) : frame_index_(start_index) {}

  EncChip* find_chip(long long idx) {
    auto it = chip_ix_.find(idx);
    if (it == chip_ix_.end()) return nullptr;
    EncChip* c = chips_[it->second].get();
    return c->dead ? nullptr : c;
  }

  long long frame_index() const { return frame_index_; }

  size_t table_entries() const {
    size_t n = 0;
    for (const auto& c : chips_)
      if (!c->dead) n += c->cells.size();
    return n;
  }

  // Encode one frame from the pending walk.  `pending` holds EVERY
  // input chip in input order (possibly with zero entries — a new chip
  // emits its empty block, and presence shields a chip from the purge
  // pass); entries live in the flat `arena`.  `events_blob` is the
  // pre-encoded field-4 event records (encoded by the binding with the
  // GIL — events are rare).  Dropped cookies land in `released`.
  void encode(std::vector<PendChip>* pending,
              std::vector<PendEntry>* arena, bool partial,
              const std::string& events_blob, std::string* out,
              std::vector<void*>* released) {
    std::string body;
    put_varint_field(&body, kFrameFieldIndex,
                     static_cast<unsigned long long>(frame_index_));
    frame_index_++;
    std::string sub, entry, vecbuf;
    for (PendChip& pc : *pending) {
      EncChip* chip = find_chip(pc.idx);
      bool is_new = chip == nullptr;
      if (is_new) chip = add_chip(pc.idx);
      sub.clear();
      bool have_sub = false;
      if (is_new) {
        put_varint_field(&sub, kValueFieldId,
                         static_cast<unsigned long long>(pc.idx));
        have_sub = true;
      }
      for (size_t ei = pc.begin; ei < pc.end; ei++) {
        PendEntry& e = (*arena)[ei];
        auto it = chip->cells.find(e.fid);
        EncCell* cell = it == chip->cells.end() ? nullptr : &it->second;
        if (cell != nullptr && cell->v.equals(e.v)) {
          // unchanged by value: the reference keeps the OLD object in
          // its table, so the new refs are dropped
          if (e.cookie != nullptr) released->push_back(e.cookie);
          release_value_refs(e.v, released);
          continue;
        }
        if (!have_sub) {
          put_varint_field(&sub, kValueFieldId,
                           static_cast<unsigned long long>(pc.idx));
          have_sub = true;
        }
        serialize_entry(e.fid, e.v, &sub, &entry, &vecbuf);
        if (cell != nullptr) {
          if (cell->cookie != nullptr) released->push_back(cell->cookie);
          release_value_refs(cell->v, released);
          cell->v = std::move(e.v);
          cell->cookie = e.cookie;
        } else {
          EncCell fresh;
          fresh.v = std::move(e.v);
          fresh.cookie = e.cookie;
          chip->cells.emplace(e.fid, std::move(fresh));
        }
      }
      if (have_sub) put_len_field(&body, kFrameFieldChip, sub);
    }
    if (!partial) {
      // purge pass: table chips absent from the input, in table
      // insertion order (the reference iterates its dict)
      std::unordered_set<long long> present;
      present.reserve(pending->size() * 2);
      for (const PendChip& pc : *pending) present.insert(pc.idx);
      for (auto& cp : chips_) {
        if (cp->dead) continue;
        if (present.count(cp->idx)) continue;
        for (auto& kv : cp->cells) {
          if (kv.second.cookie != nullptr)
            released->push_back(kv.second.cookie);
          release_value_refs(kv.second.v, released);
        }
        cp->cells.clear();
        cp->dead = true;
        chip_ix_.erase(cp->idx);
        tombstones_++;
        put_varint_field(&body, kFrameFieldRemoved,
                         static_cast<unsigned long long>(cp->idx));
      }
      if (tombstones_ > 16 && tombstones_ * 2 > chips_.size()) compact();
    }
    body += events_blob;
    out->clear();
    out->push_back(static_cast<char>(kSweepFrameMagic));
    put_varint(out, body.size());
    out->append(body);
  }

  void encode_index_only(std::string* out) {
    std::string body;
    put_varint_field(&body, kFrameFieldIndex,
                     static_cast<unsigned long long>(frame_index_));
    frame_index_++;
    out->clear();
    out->push_back(static_cast<char>(kSweepFrameMagic));
    put_varint(out, body.size());
    out->append(body);
  }

  void release_all(std::vector<void*>* released) {
    for (auto& cp : chips_)
      for (auto& kv : cp->cells) {
        if (kv.second.cookie != nullptr)
          released->push_back(kv.second.cookie);
        release_value_refs(kv.second.v, released);
      }
    chips_.clear();
    chip_ix_.clear();
    tombstones_ = 0;
  }

 private:
  EncChip* add_chip(long long idx) {
    chips_.emplace_back(new EncChip());
    EncChip* c = chips_.back().get();
    c->idx = idx;
    chip_ix_[idx] = chips_.size() - 1;
    return c;
  }

  void compact() {
    std::vector<std::unique_ptr<EncChip>> live;
    live.reserve(chips_.size() - tombstones_);
    for (auto& cp : chips_)
      if (!cp->dead) live.push_back(std::move(cp));
    chips_.swap(live);
    chip_ix_.clear();
    for (size_t i = 0; i < chips_.size(); i++) chip_ix_[chips_[i]->idx] = i;
    tombstones_ = 0;
  }

  // one value entry, byte-identical to the reference's inlined scalar
  // paths and `_append_value` fallback
  static void serialize_entry(long long fid, const NValue& v,
                              std::string* sub, std::string* entry,
                              std::string* vecbuf) {
    entry->clear();
    put_varint_field(entry, kValueFieldId,
                     static_cast<unsigned long long>(fid));
    switch (v.kind) {
      case NValue::kBlank:
        entry->append("\x20\x01", 2);
        break;
      case NValue::kFloat:
        if (!is_finite(v.d)) {
          entry->append("\x20\x01", 2);  // non-finite: blank
        } else {
          entry->push_back('\x31');  // field 6, fixed64
          put_double(entry, v.d);
        }
        break;
      case NValue::kInt:
      case NValue::kBool:  // int(True) == 1: bools travel as ints
        entry->push_back('\x10');  // field 2, varint
        put_varint(entry, zigzag(v.i));
        break;
      case NValue::kBigInt:
        entry->push_back('\x10');
        put_varint(entry, v.zig);
        break;
      case NValue::kStr:
        put_len_field(entry, kValueFieldStr, v.s);
        break;
      case NValue::kVec: {
        vecbuf->clear();
        for (const NValue::Elem& e : v.vec) {
          switch (e.kind) {
            case NValue::kBlank:
              put_varint_field(vecbuf, 3, 1);
              break;
            case NValue::kFloat:
              if (!is_finite(e.d)) {
                put_varint_field(vecbuf, 3, 1);
              } else {
                put_tag(vecbuf, 2, 1);
                put_double(vecbuf, e.d);
              }
              break;
            case NValue::kBigInt:
              put_varint_field(vecbuf, 1, e.zig);
              break;
            default:  // kInt / kBool
              put_varint_field(vecbuf, 1, zigzag(e.i));
              break;
          }
        }
        put_len_field(entry, kValueFieldVec, *vecbuf);
        break;
      }
    }
    put_len_field(sub, kFrameFieldChip, *entry);
  }

  std::vector<std::unique_ptr<EncChip>> chips_;  // insertion order
  std::unordered_map<long long, size_t> chip_ix_;
  size_t tombstones_ = 0;
  long long frame_index_;
};

// ---- decoder ----------------------------------------------------------------

struct MirCell {
  NValue v;
  void* cookie = nullptr;  // cached materialized PyObject (binding-owned)
  bool dirty = true;       // value changed since the cookie was built
};

struct MirChip {
  unsigned long long idx = 0;
  bool dead = false;
  // binding-owned template dict (PyObject*) caching the fully
  // materialized chip — refreshed for `stale` fids only, then
  // bulk-copied per materialize call (the reference's dict(chip_m)
  // speed, with O(changes) refresh)
  void* tmpl = nullptr;
  std::vector<unsigned long long> stale;
  // per-chip fid insertion order (the reference mirror is a dict) —
  // materialize's whole-chip fast path copies in THIS order
  std::vector<std::pair<unsigned long long, MirCell>> cells;
  std::unordered_map<unsigned long long, size_t> ix;

  MirCell* find(unsigned long long fid) {
    auto it = ix.find(fid);
    return it == ix.end() ? nullptr : &cells[it->second].second;
  }

  MirCell* upsert(unsigned long long fid) {
    auto it = ix.find(fid);
    if (it != ix.end()) return &cells[it->second].second;
    cells.emplace_back(fid, MirCell());
    ix[fid] = cells.size() - 1;
    return &cells.back().second;
  }
};

struct ApplyResult {
  std::string error;  // empty = ok (maps to ValueError)
  long long changes = 0;
  // (offset, length) of each field-4 event submessage in the payload
  std::vector<std::pair<size_t, size_t>> events;
};

// fleetpoll.aggregate_host_sample's numeric core (see module.cc /
// tpumon_torch/fleetpoll.py); `overflow` => the binding must fall back to the
// exact Python path (a value did not fit the native number model)
struct AggResult {
  bool overflow = false;
  bool nan_error = false;  // Python would raise int(nan) ValueError
  bool inf_error = false;  // Python would raise int(inf) OverflowError
  long long live_fields = 0;
  long long dead_chips = 0;
  double power_w = 0;
  bool has_temp = false;
  long long max_temp = 0;
  double tc_sum = 0;
  long long tc_n = 0;
  double hbm_sum = 0;
  long long hbm_n = 0;
  long long hbm_used = 0;
  long long hbm_total = 0;
  long long links_up = 0;
};

class DecoderCore {
 public:
  explicit DecoderCore(bool adopt_first_index)
      : next_frame_index_(adopt_first_index ? -1 : 0) {}

  long long next_frame_index() const { return next_frame_index_; }
  long long last_changes() const { return last_changes_; }

  size_t mirror_entries() const {
    size_t n = 0;
    for (const auto& c : chips_)
      if (!c->dead) n += c->cells.size();
    return n;
  }

  MirChip* find_chip(unsigned long long idx) {
    auto it = chip_ix_.find(idx);
    if (it == chip_ix_.end()) return nullptr;
    MirChip* c = chips_[it->second].get();
    return c->dead ? nullptr : c;
  }

  // live chips in insertion order (mirror_snapshot / iteration)
  template <typename Fn>
  void each_chip(Fn fn) {
    for (auto& cp : chips_)
      if (!cp->dead) fn(cp.get());
  }

  // Fold one frame payload into the mirror — the exact parse of the
  // reference's inlined SweepFrameDecoder.apply, including its error
  // strings and bounds quirks.  Mirror mutations before a parse error
  // stick, exactly like the reference (the caller tears the
  // connection down and discards the decoder).
  ApplyResult apply(const uint8_t* data, size_t n,
                    std::vector<void*>* released) {
    ApplyResult res;
    ParseState st{data, n, 0, {}};
    long long frame_index = -1;
    bool have_index = false;
    while (st.pos < n && st.error.empty()) {
      unsigned long long key;
      uint8_t b = data[st.pos];
      if (b < 0x80) {
        key = b;
        st.pos++;
      } else {
        key = st.varint();
        if (!st.error.empty()) break;
      }
      unsigned long long fno = key >> 3;
      int wt = static_cast<int>(key & 0x07);
      if (fno == 2 && wt == 2) {  // chip delta block
        unsigned long long blen = st.varint();
        if (!st.error.empty()) break;
        size_t end = st.pos + static_cast<size_t>(blen);
        if (blen > n || end > n) {
          st.fail("truncated sweep frame chip block");
          break;
        }
        MirChip* chip = nullptr;
        while (st.pos < end && st.error.empty()) {
          unsigned long long k2;
          b = data[st.pos];
          if (b < 0x80) {
            k2 = b;
            st.pos++;
          } else {
            k2 = st.varint();
            if (!st.error.empty()) break;
          }
          unsigned long long f2 = k2 >> 3;
          int w2 = static_cast<int>(k2 & 0x07);
          if (f2 == 2 && w2 == 2) {  // value entry
            unsigned long long elen = st.varint();
            if (!st.error.empty()) break;
            size_t e_end = st.pos + static_cast<size_t>(elen);
            if (elen > n || e_end > end) {
              st.fail("truncated sweep frame value entry");
              break;
            }
            if (chip == nullptr) {
              st.fail("sweep frame chip delta without an index");
              break;
            }
            if (!parse_value_entry(&st, e_end, chip, &res, released))
              break;
          } else if (f2 == 1 && w2 == 0) {  // chip index
            unsigned long long idx = st.varint();
            if (!st.error.empty()) break;
            chip = find_chip(idx);
            if (chip == nullptr) {
              chip = add_chip(idx);
              res.changes++;  // chip appeared
            }
          } else {
            std::string msg = "unknown chip delta field ";
            msg += std::to_string(f2);
            st.error = msg;
            break;
          }
        }
      } else if (fno == 1 && wt == 0) {
        unsigned long long fi = st.varint();
        if (!st.error.empty()) break;
        frame_index = static_cast<long long>(fi);
        have_index = true;
      } else if (fno == 3 && wt == 0) {
        unsigned long long gone = st.varint();
        if (!st.error.empty()) break;
        auto it = chip_ix_.find(gone);
        if (it != chip_ix_.end()) {
          MirChip* c = chips_[it->second].get();
          for (auto& kv : c->cells)
            if (kv.second.cookie != nullptr)
              released->push_back(kv.second.cookie);
          if (c->tmpl != nullptr) {
            released->push_back(c->tmpl);
            c->tmpl = nullptr;
          }
          c->stale.clear();
          c->cells.clear();
          c->ix.clear();
          c->dead = true;
          chip_ix_.erase(it);
          tombstones_++;
          res.changes++;
        }
      } else if (fno == 4 && wt == 2) {
        unsigned long long elen = st.varint();
        if (!st.error.empty()) break;
        if (elen > n || st.pos + static_cast<size_t>(elen) > n) {
          st.fail("truncated sweep frame event");
          break;
        }
        res.events.emplace_back(st.pos, static_cast<size_t>(elen));
        st.pos += static_cast<size_t>(elen);
      } else {
        std::string msg = "unknown sweep frame field ";
        msg += std::to_string(fno);
        msg += "/";
        msg += std::to_string(wt);
        st.error = msg;
        break;
      }
    }
    if (!st.error.empty()) {
      res.error = st.error;
      return res;
    }
    (void)have_index;
    if (frame_index != next_frame_index_ &&
        !(next_frame_index_ < 0 && frame_index >= 0)) {
      std::string msg = "sweep frame index ";
      msg += std::to_string(frame_index);
      msg += " != expected ";
      msg += std::to_string(next_frame_index_);
      msg += " (delta stream desynchronized)";
      res.error = msg;
      return res;
    }
    next_frame_index_ = frame_index + 1;
    last_changes_ = res.changes;
    if (tombstones_ > 16 && tombstones_ * 2 > chips_.size()) compact();
    return res;
  }

  // aggregate_host_sample's numeric pass over the mirror, filtered to
  // the request exactly like materialize (whole-chip fast path when the
  // entry counts match, per-fid filter otherwise)
  AggResult aggregate(
      const std::vector<std::pair<unsigned long long,
                                  const std::vector<unsigned long long>*>>&
          reqs,
      long long chip_count, long long f_power, long long f_temp,
      long long f_tc, long long f_hbm_bw, long long f_used,
      long long f_total, long long f_links) {
    AggResult r;
    for (long long c = 0; c < chip_count; c++) {
      // requests are almost always [(0, fids), (1, fids), ...] — try
      // the positional slot first, then fall back to a scan
      const std::vector<unsigned long long>* fids = nullptr;
      if (c >= 0 && static_cast<size_t>(c) < reqs.size() &&
          static_cast<long long>(reqs[static_cast<size_t>(c)].first) == c) {
        fids = reqs[static_cast<size_t>(c)].second;
      } else {
        for (const auto& rq : reqs) {
          if (static_cast<long long>(rq.first) == c) {
            fids = rq.second;
            break;
          }
        }
      }
      MirChip* chip =
          fids == nullptr ? nullptr
                          : find_chip(static_cast<unsigned long long>(c));
      long long live = 0;
      bool full = chip != nullptr && chip->cells.size() == fids->size();
      if (chip != nullptr) {
        if (full) {
          for (auto& kv : chip->cells)
            if (kv.second.v.kind != NValue::kBlank) live++;
        } else {
          for (unsigned long long f : *fids) {
            MirCell* cell = chip->find(f);
            if (cell != nullptr && cell->v.kind != NValue::kBlank) live++;
          }
        }
      }
      r.live_fields += live;
      if (live == 0) {
        r.dead_chips++;
        continue;
      }
      // numeric lookups: a fid outside the request must not resurrect
      // from the mirror (materialize's filter), except on the
      // whole-chip fast path where the reference copies the mirror
      // as-is
      MirCell* cell;
      if ((cell = agg_find(chip, fids, full, f_power)) != nullptr)
        if (!add_double(cell->v, &r.power_w, &r)) return r;
      if ((cell = agg_find(chip, fids, full, f_temp)) != nullptr) {
        long long ti;
        if (!to_int(cell->v, &ti, &r)) {
          if (r.overflow || r.nan_error || r.inf_error) return r;
        } else if (!r.has_temp || ti > r.max_temp) {
          r.has_temp = true;
          r.max_temp = ti;
        }
      }
      if ((cell = agg_find(chip, fids, full, f_tc)) != nullptr)
        if (numeric(cell->v)) {
          if (!add_double(cell->v, &r.tc_sum, &r)) return r;
          r.tc_n++;
        }
      if ((cell = agg_find(chip, fids, full, f_hbm_bw)) != nullptr)
        if (numeric(cell->v)) {
          if (!add_double(cell->v, &r.hbm_sum, &r)) return r;
          r.hbm_n++;
        }
      if ((cell = agg_find(chip, fids, full, f_used)) != nullptr) {
        long long vi;
        if (!to_int(cell->v, &vi, &r)) {
          if (r.overflow || r.nan_error || r.inf_error) return r;
        } else {
          r.hbm_used += vi;
        }
      }
      if ((cell = agg_find(chip, fids, full, f_total)) != nullptr) {
        long long vi;
        if (!to_int(cell->v, &vi, &r)) {
          if (r.overflow || r.nan_error || r.inf_error) return r;
        } else {
          r.hbm_total += vi;
        }
      }
      if ((cell = agg_find(chip, fids, full, f_links)) != nullptr) {
        long long vi;
        if (!to_int(cell->v, &vi, &r)) {
          if (r.overflow || r.nan_error || r.inf_error) return r;
        } else {
          r.links_up += vi;
        }
      }
    }
    return r;
  }

  void release_all(std::vector<void*>* released) {
    for (auto& cp : chips_) {
      for (auto& kv : cp->cells)
        if (kv.second.cookie != nullptr)
          released->push_back(kv.second.cookie);
      if (cp->tmpl != nullptr) released->push_back(cp->tmpl);
    }
    chips_.clear();
    chip_ix_.clear();
    tombstones_ = 0;
  }

 private:
  static bool numeric(const NValue& v) {
    return v.kind == NValue::kInt || v.kind == NValue::kBool ||
           v.kind == NValue::kFloat || v.kind == NValue::kBigInt;
  }

  MirCell* agg_find(MirChip* chip, const std::vector<unsigned long long>* fids,
                    bool full, long long fid) {
    if (fid < 0) return nullptr;
    unsigned long long f = static_cast<unsigned long long>(fid);
    if (!full) {
      bool requested = false;
      for (unsigned long long q : *fids) {
        if (q == f) {
          requested = true;
          break;
        }
      }
      if (!requested) return nullptr;
    }
    MirCell* cell = chip->find(f);
    if (cell == nullptr || cell->v.kind == NValue::kBlank) return nullptr;
    // non-numeric values are skipped by the reference's isinstance
    // narrowing
    return numeric(cell->v) ? cell : nullptr;
  }

  static bool add_double(const NValue& v, double* acc, AggResult* r) {
    if (v.kind == NValue::kBigInt) {
      r->overflow = true;  // exact float(bigint) needs the Python path
      return false;
    }
    *acc += v.kind == NValue::kFloat ? v.d : static_cast<double>(v.i);
    return true;
  }

  // Python int(x): truncation toward zero; NaN raises ValueError, inf
  // raises OverflowError, out-of-int64 floats fall back to Python
  static bool to_int(const NValue& v, long long* out, AggResult* r) {
    if (v.kind == NValue::kInt || v.kind == NValue::kBool) {
      *out = v.i;
      return true;
    }
    if (v.kind == NValue::kBigInt) {
      r->overflow = true;
      return false;
    }
    double d = v.d;
    if (d != d) {
      r->nan_error = true;
      return false;
    }
    if (d == HUGE_VAL || d == -HUGE_VAL) {
      r->inf_error = true;
      return false;
    }
    if (d >= 9.223372036854775808e18 || d <= -9.223372036854775808e18) {
      r->overflow = true;  // Python int() would make a big int
      return false;
    }
    *out = static_cast<long long>(d);
    return true;
  }

  MirChip* add_chip(unsigned long long idx) {
    chips_.emplace_back(new MirChip());
    MirChip* c = chips_.back().get();
    c->idx = idx;
    chip_ix_[idx] = chips_.size() - 1;
    return c;
  }

  void compact() {
    std::vector<std::unique_ptr<MirChip>> live;
    live.reserve(chips_.size() - tombstones_);
    for (auto& cp : chips_)
      if (!cp->dead) live.push_back(std::move(cp));
    chips_.swap(live);
    chip_ix_.clear();
    for (size_t i = 0; i < chips_.size(); i++) chip_ix_[chips_[i]->idx] = i;
    tombstones_ = 0;
  }

  // one value entry body in [st->pos, e_end); the enclosing tag/length
  // are already consumed
  // (the released out-list is part of the apply-helper signature shape
  // but only row removal frees pends — value entries never do)
  bool parse_value_entry(ParseState* st, size_t e_end, MirChip* chip,
                         ApplyResult* res, std::vector<void*>* /*released*/) {
    const uint8_t* data = st->data;
    long long fid = -1;
    unsigned long long ufid = 0;
    NValue val;  // default kBlank — matches the reference's `val = None`
    while (st->pos < e_end && st->error.empty()) {
      unsigned long long k3;
      uint8_t b = data[st->pos];
      if (b < 0x80) {
        k3 = b;
        st->pos++;
      } else {
        k3 = st->varint();
        if (!st->error.empty()) return false;
      }
      unsigned long long f3 = k3 >> 3;
      int w3 = static_cast<int>(k3 & 0x07);
      if (f3 == 1 && w3 == 0) {
        ufid = st->varint();
        if (!st->error.empty()) return false;
        fid = 0;  // found (the reference's `fid` turns non-negative)
      } else if (f3 == 2 && w3 == 0) {  // zigzag int
        unsigned long long v3 = st->varint();
        if (!st->error.empty()) return false;
        val = NValue();
        val.kind = NValue::kInt;
        val.i = static_cast<long long>(v3 >> 1) ^
                -static_cast<long long>(v3 & 1);
      } else if (f3 == 6 && w3 == 1) {  // double bits
        if (st->pos + 8 > e_end) {
          st->fail("truncated fixed64");
          return false;
        }
        uint64_t bits = 0;
        for (int i = 0; i < 8; i++)
          bits |= static_cast<uint64_t>(data[st->pos + i]) << (8 * i);
        st->pos += 8;
        val = NValue();
        val.kind = NValue::kFloat;
        memcpy(&val.d, &bits, sizeof(val.d));
      } else if (f3 == 4 && w3 == 0) {  // blank
        st->varint();
        if (!st->error.empty()) return false;
        val = NValue();  // kBlank
      } else if (f3 == 5 && w3 == 2) {  // string
        unsigned long long slen = st->varint();
        if (!st->error.empty()) return false;
        if (slen > e_end || st->pos + static_cast<size_t>(slen) > e_end) {
          st->fail("truncated string");
          return false;
        }
        val = NValue();
        val.kind = NValue::kStr;
        val.s.assign(reinterpret_cast<const char*>(data + st->pos),
                     static_cast<size_t>(slen));
        st->pos += static_cast<size_t>(slen);
      } else if (f3 == 3 && w3 == 2) {  // vector
        unsigned long long vlen = st->varint();
        if (!st->error.empty()) return false;
        size_t v_end = st->pos + static_cast<size_t>(vlen);
        if (vlen > e_end || v_end > e_end) {
          st->fail("truncated vector");
          return false;
        }
        val = NValue();
        val.kind = NValue::kVec;
        while (st->pos < v_end && st->error.empty()) {
          unsigned long long k4 = st->varint();
          if (!st->error.empty()) return false;
          unsigned long long f4 = k4 >> 3;
          int w4 = static_cast<int>(k4 & 0x07);
          NValue::Elem e;
          if (f4 == 1 && w4 == 0) {
            unsigned long long v4 = st->varint();
            if (!st->error.empty()) return false;
            e.kind = NValue::kInt;
            e.i = static_cast<long long>(v4 >> 1) ^
                  -static_cast<long long>(v4 & 1);
          } else if (f4 == 2 && w4 == 1) {
            if (st->pos + 8 > v_end) {
              st->fail("truncated fixed64");
              return false;
            }
            uint64_t bits = 0;
            for (int i = 0; i < 8; i++)
              bits |= static_cast<uint64_t>(data[st->pos + i]) << (8 * i);
            st->pos += 8;
            e.kind = NValue::kFloat;
            memcpy(&e.d, &bits, sizeof(e.d));
          } else if (f4 == 3 && w4 == 0) {
            st->varint();
            if (!st->error.empty()) return false;
            e.kind = NValue::kBlank;
          } else {
            st->fail("unknown vector element field");
            return false;
          }
          val.vec.push_back(e);
        }
      } else {
        std::string msg = "unknown value entry field ";
        msg += std::to_string(f3);
        st->error = msg;
        return false;
      }
    }
    if (!st->error.empty()) return false;
    if (fid < 0) {
      st->fail("sweep frame value entry without a field id");
      return false;
    }
    MirCell* cell = chip->upsert(ufid);
    cell->v = std::move(val);
    cell->dirty = true;
    chip->stale.push_back(ufid);  // template refresh list (binding)
    res->changes++;
    return true;
  }

  std::vector<std::unique_ptr<MirChip>> chips_;  // insertion order
  std::unordered_map<unsigned long long, size_t> chip_ix_;
  size_t tombstones_ = 0;
  long long next_frame_index_;
  long long last_changes_ = 0;
};

// ---- burst accumulator ------------------------------------------------------
//
// Mirror of tpumon_torch/burst.py PyBurstAccumulator: per-(chip, field)
// min/max/mean/time-integral fold, doubles in arrival order, non-finite
// samples discarded entirely, reset-on-harvest with a persistent
// integration anchor.  Same arithmetic as agent/sampler.hpp's
// burst_fold_value (the daemon twin) minus its seqlock cells — the
// Python-plane facade serializes access (plus a binding-level mutex for
// the GIL-released fold window).

struct BurstWindow {
  long long count = 0;
  double vmin = 0, vmax = 0, vsum = 0, integral = 0;
  bool has_anchor = false;
  double anchor_t = 0, anchor_v = 0;
};

struct BurstSample {
  double t = 0;
  double v = 0;
  bool skip = false;  // None / str / list sample: discarded
};

struct BurstHarvestEntry {
  long long chip;
  long long fid;
  double vmin, vmax, mean, integral;
};

class BurstCore {
 public:
  size_t entries() const { return windows_.size(); }

  void fold(long long chip, long long fid, double t, double v) {
    if (!is_finite(v)) return;  // no window creation, like the reference
    BurstWindow* w = upsert(chip, fid);
    fold_one(w, t, v);
  }

  // the reference's fold_series: the window is created even when every
  // sample is skipped
  void fold_series(long long chip, long long fid,
                   const std::vector<BurstSample>& samples) {
    BurstWindow* w = upsert(chip, fid);
    for (const BurstSample& s : samples) {
      if (s.skip || !is_finite(s.v)) continue;
      fold_one(w, s.t, s.v);
    }
  }

  // reset-on-harvest, anchors persist; entries in window insertion
  // order (the reference iterates its dict)
  void harvest(std::vector<BurstHarvestEntry>* out) {
    for (auto& kv : windows_) {
      BurstWindow& w = kv.second;
      if (w.count == 0) continue;
      BurstHarvestEntry e;
      e.chip = kv.first.first;
      e.fid = kv.first.second;
      e.vmin = w.vmin;
      e.vmax = w.vmax;
      e.mean = w.vsum / static_cast<double>(w.count);
      e.integral = w.integral;
      out->push_back(e);
      w.count = 0;
      w.vmin = w.vmax = w.vsum = w.integral = 0;
    }
  }

  void adopt_anchors(const BurstCore& other) {
    for (const auto& kv : other.windows_) {
      if (!kv.second.has_anchor) continue;
      BurstWindow* mine = upsert(kv.first.first, kv.first.second);
      if (!mine->has_anchor) {
        mine->has_anchor = true;
        mine->anchor_t = kv.second.anchor_t;
        mine->anchor_v = kv.second.anchor_v;
      }
    }
  }

 private:
  static void fold_one(BurstWindow* w, double t, double v) {
    if (w->has_anchor && t > w->anchor_t)
      w->integral += w->anchor_v * (t - w->anchor_t);
    w->has_anchor = true;
    w->anchor_t = t;
    w->anchor_v = v;
    if (w->count) {
      if (v < w->vmin) w->vmin = v;
      if (v > w->vmax) w->vmax = v;
    } else {
      w->vmin = w->vmax = v;
    }
    w->vsum += v;
    w->count++;
  }

  struct KeyHash {
    size_t operator()(const std::pair<long long, long long>& k) const {
      return std::hash<long long>()(k.first * 1000003LL + k.second);
    }
  };

  BurstWindow* upsert(long long chip, long long fid) {
    auto key = std::make_pair(chip, fid);
    auto it = index_.find(key);
    if (it != index_.end()) return &windows_[it->second].second;
    windows_.emplace_back(key, BurstWindow());
    index_[key] = windows_.size() - 1;
    return &windows_.back().second;
  }

  // insertion order (harvest output order == the reference's dict)
  std::vector<std::pair<std::pair<long long, long long>, BurstWindow>>
      windows_;
  std::unordered_map<std::pair<long long, long long>, size_t, KeyHash>
      index_;
};

// the integral-dump predicate of the wire number convention
// (sampler.hpp burst_dumps_as_int twin; NUM_INT_LIMIT)
inline bool dumps_as_int(double v) {
  return v == std::floor(v) && std::fabs(v) < kNumIntLimit;
}

}  // namespace codec
}  // namespace tpumon
