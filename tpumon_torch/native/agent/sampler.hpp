// sampler.hpp — agent-side watches: the daemon owns the sampling loop.
//
// DCGM parity: dcgmWatchFields lives in the hostengine, not the client
// (reference bindings/go/dcgm/fields.go:42-60 — updateFreq/maxKeepAge are
// daemon-side state).  One background thread samples the union of watched
// fields across all chips at the fastest requested frequency into
// age-bounded ring buffers; any number of clients then read cached values
// ("latest"/"samples" ops) without touching the device — chips are sampled
// once no matter how many monitors attach.

#pragma once

#include <time.h>
#include <unistd.h>

#include <atomic>
#include <chrono>
#include <algorithm>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <deque>
#include <iterator>
#include <map>
#include <memory>
#include <mutex>
#include <set>
#include <thread>
#include <vector>

#include "source.hpp"

namespace tpumon {

class Sampler {
 public:
  struct Sample {
    double ts;
    double value;
  };

  explicit Sampler(MetricSource* source) : source_(source) {}

  ~Sampler() { stop(); }

  long long add_watch(const std::vector<int>& fields, long long freq_us,
                      double keep_age_s) {
    std::lock_guard<std::mutex> lock(mu_);
    Watch w;
    w.id = next_id_++;
    w.fields = fields;
    w.freq_us = freq_us < 10000 ? 10000 : freq_us;  // 10 ms floor
    w.keep_age_s = keep_age_s > 0 ? keep_age_s : 300.0;
    watches_[w.id] = w;
    ensure_thread_locked();
    cv_.notify_all();
    return w.id;
  }

  bool remove_watch(long long id) {
    std::lock_guard<std::mutex> lock(mu_);
    if (watches_.erase(id) == 0) return false;
    // purge series no remaining watch covers — age-pruning only runs on
    // new pushes, so without this an unwatched field's last value would
    // sit in the cache (and be served by latest()) forever
    std::set<int> covered;
    for (const auto& [wid, w] : watches_)
      covered.insert(w.fields.begin(), w.fields.end());
    for (auto it = series_.begin(); it != series_.end();)
      it = covered.count(it->first.second) ? std::next(it) : series_.erase(it);
    return true;
  }

  // latest cached value; returns false (blank) when never sampled or when
  // the newest sample has outlived the series' retention (stalled sampler)
  bool latest(int chip, int field, double* value, double* ts) {
    // tpumon: effect-ok(bounded map probe under the sampler's own mu_ — the sampler thread holds it only for the per-tick append, never across I/O, so a sweep waits one insertion at worst)
    std::lock_guard<std::mutex> lock(mu_);
    auto it = series_.find({chip, field});
    if (it == series_.end() || it->second.samples.empty()) return false;
    const Sample& s = it->second.samples.back();
    if (s.ts < FakeSource::now() - it->second.fresh_s) return false;
    *value = s.value;
    *ts = s.ts;
    return true;
  }

  std::vector<Sample> samples_since(int chip, int field, double since) {
    std::lock_guard<std::mutex> lock(mu_);
    std::vector<Sample> out;
    auto it = series_.find({chip, field});
    if (it == series_.end()) return out;
    for (const auto& s : it->second.samples)
      if (s.ts > since) out.push_back(s);
    return out;
  }

  long long total_samples() const { return total_samples_.load(); }

  void stop() {
    {
      std::lock_guard<std::mutex> lock(mu_);
      stopping_ = true;
    }
    cv_.notify_all();
    if (thread_.joinable()) thread_.join();
  }

 private:
  struct Watch {
    long long id = 0;
    std::vector<int> fields;
    long long freq_us = 1000000;
    double keep_age_s = 300.0;
    double last_sweep = 0;
  };

  struct Series {
    std::deque<Sample> samples;
    double keep_age_s = 300.0;
    // freshness bound for latest(): the max of retention and 2x the
    // slowest covering watch period.  Serving values up to keep-age old
    // is DCGM maxKeepAge parity; the 2x-period term keeps a healthy
    // low-rate watch with a short keep-age from being blanked between
    // sweeps.  A stalled sampler therefore serves its last value for up
    // to fresh_s (which can exceed keep_age_s for slow watches) before
    // latest() starts blanking; callers needing a tighter bound pass
    // max_age_s on read_fields_bulk.
    double fresh_s = 300.0;
  };

  void ensure_thread_locked() {
    if (!thread_.joinable()) {
      stopping_ = false;
      thread_ = std::thread([this] { run(); });
    }
  }

  void run() {
    std::unique_lock<std::mutex> lock(mu_);
    while (!stopping_) {
      if (watches_.empty()) {
        // nothing to sample: sleep until a watch arrives or stop()
        cv_.wait(lock);
        continue;
      }
      double now = FakeSource::now();
      // union of fields due this tick; retention per field = max over the
      // ACTIVE watches covering it (no global floor — a 5 s watch keeps
      // ~5 s of samples, and retention shrinks when big watches go away)
      std::set<int> due;
      std::map<int, double> keep_by_field;
      std::map<int, double> fresh_by_field;
      long long min_freq = 1000000;
      for (auto& [id, w] : watches_) {
        min_freq = std::min(min_freq, w.freq_us);
        for (int f : w.fields) {
          double& keep = keep_by_field[f];
          keep = std::max(keep, w.keep_age_s);
          double& fresh = fresh_by_field[f];
          fresh = std::max({fresh, w.keep_age_s, 2e-6 * w.freq_us});
        }
        if ((now - w.last_sweep) * 1e6 >= static_cast<double>(w.freq_us)) {
          due.insert(w.fields.begin(), w.fields.end());
          w.last_sweep = now;
        }
      }
      if (!due.empty()) {
        int chips = source_->chip_count();
        lock.unlock();  // device reads happen outside the cache lock
        // one read of the due fields per chip (a source may answer them
        // in one device request); numbers only are samples
        std::vector<int> fids(due.begin(), due.end());
        std::vector<std::tuple<int, int, double>> fresh;
        std::vector<FieldValue> vals;
        for (int c = 0; c < chips; c++) {
          if (source_->read_fields_at(c, fids, now, &vals) != TPUMON_SHIM_OK)
            continue;
          for (size_t i = 0; i < fids.size(); i++)
            if (vals[i].kind == FieldValue::kNum)
              fresh.emplace_back(c, fids[i], vals[i].num);
        }
        lock.lock();
        // a watch may have been removed (and its series purged) while the
        // device reads ran unlocked; pushing its sample would resurrect
        // the series with no covering watch, so re-check coverage
        std::set<int> covered;
        for (const auto& [wid, w] : watches_)
          covered.insert(w.fields.begin(), w.fields.end());
        for (const auto& [c, f, v] : fresh) {
          if (!covered.count(f)) continue;
          Series& s = series_[{c, f}];
          s.keep_age_s = keep_by_field.count(f) ? keep_by_field[f] : 300.0;
          s.fresh_s = fresh_by_field.count(f) ? fresh_by_field[f]
                                              : s.keep_age_s;
          s.samples.push_back({now, v});
          while (!s.samples.empty() &&
                 s.samples.front().ts < now - s.keep_age_s)
            s.samples.pop_front();
          total_samples_++;
        }
      }
      // sleep until the next watch falls due (a wake-up at a fixed
      // fraction of the period costs host CPU for nothing); add_watch
      // and stop() wake it early
      double next = 1e300;
      for (const auto& [id, w] : watches_)
        next = std::min(next, w.last_sweep + 1e-6 * w.freq_us);
      double wait_s = std::min(next - FakeSource::now(), 1e-6 * min_freq);
      cv_.wait_for(lock, std::chrono::microseconds(static_cast<long long>(
                             std::max(wait_s, 1e-3) * 1e6)));
    }
  }

  MetricSource* source_;
  std::mutex mu_;
  std::condition_variable cv_;
  std::thread thread_;
  bool stopping_ = false;
  long long next_id_ = 1;
  std::map<long long, Watch> watches_;
  std::map<std::pair<int, int>, Series> series_;
  std::atomic<long long> total_samples_{0};
};

// ---- sweep_frame delta state (per connection) -------------------------------
//
// The binary sweep op sends only (chip, field) values that changed since
// the last frame ON THIS CONNECTION; the table below is the server half
// of that contract (the Python client keeps the mirror).  It lives in
// the connection handler and dies with the socket, which is what resets
// both tables on reconnect.  Executable spec: tpumon_torch/sweepframe.py
// (SweepFrameEncoder); wire layout: agent/protocol.md.

// a value as the sweep sends it: the JSON-dump conventions applied up
// front (a non-finite scalar is blank, a non-finite vector element the
// NaN blank-element sentinel)
using SweepValue = FieldValue;

struct SweepDelta {
  //: (chip, field) -> last value sent on this connection
  std::map<std::pair<int, int>, SweepValue> last;
  //: chips the client's mirror knows about (a chip block is emitted the
  //: first time a chip appears, even with no values yet)
  std::set<int> chips;
  long long frame_index = 0;

  size_t table_entries() const { return last.size(); }
};

// ---- burst sampling (--burst-hz): windowed accumulators ---------------------
//
// 1 Hz polling aliases away sub-second transients; burst mode samples
// the declared cheap-counter subset (kBurstSourceFields, generated into
// catalog.inc from tpumon_torch/fields.py) at 50-100 Hz into per-(chip,
// field) min/max/mean/time-integral cells, harvested once per second by
// the sweep thread and folded into the normal sweep as derived fields
// (id = kBurstIdBase + source_id * 4 + agg).  Executable spec:
// tpumon_torch/burst.py (BurstAccumulator) — keep the fold arithmetic
// below an EXACT mirror; tests/test_torch_native_agent.py pins the two
// byte-for-byte
// through the sweep_frame codec via testlib/burst_fold_main.cc.
//
// Handoff contract (the perf point — never a mutex in the inner loop):
// each cell is a per-entry seqlock with a single writer (the inner
// thread); the harvester does a seq-validated copy and never writes a
// cell.  Reset-on-harvest is LAZY via a window epoch: harvest bumps
// the epoch, and the producer zeroes a cell's stats on its first fold
// of the new epoch.  Samples folded between the harvester's copy and
// the epoch bump land in the closed window's cells and are discarded
// at their lazy reset — at most one fold burst per harvest is lost,
// never torn (same bound as the Python accumulator-swap handoff).

// Cell data members are RELAXED atomics (the Boehm seqlock idiom):
// the seq counter orders the producer's publication, but the data
// words themselves must also be atomic objects or the harvester's
// validated copy is formally a C++ data race (and ThreadSanitizer —
// which gates the reference daemon — reports it).
// Relaxed loads/stores compile to plain moves on x86/arm64, so the
// inner loop pays nothing; there is exactly ONE writer per cell.
struct BurstCell {
  std::atomic<uint32_t> seq{0};   // odd = producer mid-fold
  std::atomic<uint64_t> epoch{0};  // window id the stats belong to
  std::atomic<long long> count{0};
  std::atomic<double> vmin{0}, vmax{0}, vsum{0}, integral{0};
  // integration anchor: persists across windows so per-window
  // integrals tile the total integral (left-rectangle rule)
  std::atomic<bool> has_anchor{false};
  std::atomic<double> anchor_t{0}, anchor_v{0};
};

// a harvester's seq-validated plain copy of one cell's stats
struct BurstStats {
  uint64_t epoch = 0;
  long long count = 0;
  double vmin = 0, vmax = 0, vsum = 0, integral = 0;
};

// the fold arithmetic — single source for the live sampler and the
// differential-oracle binary (testlib/burst_fold_main.cc); EXACT
// mirror of tpumon_torch/burst.py BurstAccumulator.fold (doubles, in sample
// order, non-finite samples discarded entirely).  Single-writer: all
// loads/stores relaxed, ordered by the caller's seq transitions.
inline void burst_fold_value(BurstCell* c, double t, double v) {
  constexpr auto rx = std::memory_order_relaxed;
  if (!std::isfinite(v)) return;
  double at = c->anchor_t.load(rx);
  if (c->has_anchor.load(rx) && t > at)
    c->integral.store(c->integral.load(rx) +
                      c->anchor_v.load(rx) * (t - at), rx);
  c->has_anchor.store(true, rx);
  c->anchor_t.store(t, rx);
  c->anchor_v.store(v, rx);
  if (c->count.load(rx)) {
    if (v < c->vmin.load(rx)) c->vmin.store(v, rx);
    if (v > c->vmax.load(rx)) c->vmax.store(v, rx);
  } else {
    c->vmin.store(v, rx);
    c->vmax.store(v, rx);
  }
  c->vsum.store(c->vsum.load(rx) + v, rx);
  c->count.store(c->count.load(rx) + 1, rx);
}

// reset-on-harvest: stats only — the anchor persists (mirror of
// BurstAccumulator.harvest)
inline void burst_reset_cell(BurstCell* c) {
  constexpr auto rx = std::memory_order_relaxed;
  c->count.store(0, rx);
  c->vmin.store(0, rx);
  c->vmax.store(0, rx);
  c->vsum.store(0, rx);
  c->integral.store(0, rx);
}

// THE integral-dump predicate of the binary wire (json.hpp's dump
// applies the same rule textually): main.cc's append_sweep_number and
// the differential-oracle binary both emit through this one function,
// so the number convention cannot fork between them.  The 9.0e15
// literal is NUM_INT_LIMIT (tpumon_torch/sweepframe.py); tools/
// tpumon_check.py pins the C++ side carries a matching literal.
inline bool burst_dumps_as_int(double v) {
  return v == std::floor(v) && std::fabs(v) < 9.0e15;
}

class BurstSampler {
 public:
  // id_base / fields come from the generated catalog constants
  // (catalog.inc: kBurstIdBase / kBurstSourceFields) so the C++ field
  // set can never drift ahead of tpumon_torch/fields.py; a test pins
  // the generated constants against the Python declaration too.
  BurstSampler(MetricSource* source, int hz, int id_base,
               std::vector<int> fields, double window_s = 1.0)
      : source_(source), hz_(hz < 1 ? 1 : hz), id_base_(id_base),
        fields_(std::move(fields)), window_s_(window_s) {}

  ~BurstSampler() { stop(); }

  void start() {
    if (thread_.joinable()) return;
    chips_ = source_->chip_count();
    cells_.reset(new BurstCell[static_cast<size_t>(chips_) *
                               fields_.size()]);
    stopping_ = false;
    thread_ = std::thread([this] { run(); });
  }

  void stop() {
    stopping_ = true;
    if (thread_.joinable()) thread_.join();
  }

  int hz() const { return hz_; }
  long long overruns() const { return overruns_.load(); }
  long long samples() const { return samples_.load(); }

  // Sweep-thread side: close the window at most once per window_s_
  // (many consumers see ONE consistent host-level per-second window),
  // refreshing the served harvest map.  harvest_mu_ is consumer-side
  // only — the inner loop never touches it.
  void harvest_if_due(double now_mono) {
    // tpumon: effect-ok(consumer-side window close under harvest_mu_ at most once per window_s_ — the 50-100 Hz fold publishes through the seqlock cells and never touches this mutex)
    std::lock_guard<std::mutex> g(harvest_mu_);
    if (cells_ == nullptr) return;
    if (last_harvest_t_ >= 0 && now_mono - last_harvest_t_ < window_s_)
      return;
    last_harvest_t_ = now_mono;
    uint64_t e = epoch_.load(std::memory_order_acquire);
    std::map<std::pair<int, int>, double> fresh;
    size_t nf = fields_.size();
    for (int c = 0; c < chips_; c++) {
      for (size_t f = 0; f < nf; f++) {
        BurstStats snap;
        if (!read_cell(&cells_[c * nf + f], &snap)) continue;
        if (snap.epoch != e || snap.count == 0) continue;
        int base = id_base_ + fields_[f] * 4;
        fresh[{c, base + 0}] = snap.vmin;
        fresh[{c, base + 1}] = snap.vmax;
        fresh[{c, base + 2}] = snap.vsum / static_cast<double>(snap.count);
        fresh[{c, base + 3}] = snap.integral;
      }
    }
    // open the new window AFTER the copy: producers lazily reset on
    // their first fold of the new epoch (late folds into the closed
    // window are the documented one-burst loss)
    epoch_.fetch_add(1, std::memory_order_acq_rel);
    harvest_.swap(fresh);
  }

  // serve one harvested derived value (sweep/scrape threads)
  bool lookup(int chip, int derived_fid, double* out) {
    // tpumon: effect-ok(bounded harvest-map probe under harvest_mu_ — contended only between sweep/scrape consumers; the inner fold never takes this lock)
    std::lock_guard<std::mutex> g(harvest_mu_);
    auto it = harvest_.find({chip, derived_fid});
    if (it == harvest_.end()) return false;
    *out = it->second;
    return true;
  }

  bool covers(int derived_fid) const {
    int off = derived_fid - id_base_;
    if (off < 0) return false;
    int src = off / 4;
    for (int f : fields_)
      if (f == src) return true;
    return false;
  }

 private:
  // seq-validated copy; never writes the cell.  A writer wedged
  // mid-fold (can't happen without a stuck producer thread) just
  // skips the cell this harvest.
  static bool read_cell(BurstCell* c, BurstStats* out) {
    constexpr auto rx = std::memory_order_relaxed;
    for (int tries = 0; tries < 1000; tries++) {
      uint32_t s0 = c->seq.load(std::memory_order_acquire);
      if (s0 & 1) continue;
      out->epoch = c->epoch.load(rx);
      out->count = c->count.load(rx);
      out->vmin = c->vmin.load(rx);
      out->vmax = c->vmax.load(rx);
      out->vsum = c->vsum.load(rx);
      out->integral = c->integral.load(rx);
      std::atomic_thread_fence(std::memory_order_acquire);
      if (c->seq.load(std::memory_order_relaxed) == s0) return true;
    }
    return false;
  }

  void fold_cell(BurstCell* c, uint64_t e, double t, double v) {
    c->seq.fetch_add(1, std::memory_order_acq_rel);   // odd: mid-fold
    if (c->epoch.load(std::memory_order_relaxed) != e) {
      burst_reset_cell(c);  // lazy reset-on-harvest (anchor persists)
      c->epoch.store(e, std::memory_order_relaxed);
    }
    burst_fold_value(c, t, v);
    c->seq.fetch_add(1, std::memory_order_release);   // even: published
  }

  static double mono_s() {
    struct timespec ts;
    clock_gettime(CLOCK_MONOTONIC, &ts);
    return static_cast<double>(ts.tv_sec) +
           static_cast<double>(ts.tv_nsec) / 1e9;
  }

  void run() {
    const double period = 1.0 / static_cast<double>(hz_);
    const size_t nf = fields_.size();
    std::vector<FieldValue> vals;
    double deadline = mono_s() + period;
    while (!stopping_.load(std::memory_order_relaxed)) {
      uint64_t e = epoch_.load(std::memory_order_acquire);
      // wall-clock sample stamp like the watch sampler: only dt enters
      // the integral, and wall aligns burst windows with sweep stamps
      double t = FakeSource::now();
      for (int c = 0; c < chips_; c++) {
        // one burst read per chip (the source's cheap counters)
        if (source_->read_burst_at(c, fields_, t, &vals) != TPUMON_SHIM_OK)
          continue;
        for (size_t f = 0; f < nf; f++) {
          if (vals[f].kind == FieldValue::kNum) {
            fold_cell(&cells_[c * nf + f], e, t, vals[f].num);
            samples_.fetch_add(1, std::memory_order_relaxed);
          }
        }
      }
      double now = mono_s();
      if (now > deadline + period) {
        // missed whole period(s): count every missed slot and
        // re-anchor, so a consistently-slow source is VISIBLE
        // (hello burst_overruns -> tpumon_agent_burst_overruns_total)
        // instead of silently sampling at a lower effective rate
        long long missed =
            static_cast<long long>((now - deadline) / period);
        overruns_.fetch_add(missed, std::memory_order_relaxed);
        deadline += static_cast<double>(missed) * period;
      }
      double wait = deadline - now;
      deadline += period;
      if (wait > 0)
        usleep(static_cast<useconds_t>(wait * 1e6));
    }
  }

  MetricSource* source_;
  int hz_;
  int id_base_;
  std::vector<int> fields_;
  double window_s_;
  int chips_ = 0;
  std::unique_ptr<BurstCell[]> cells_;
  std::atomic<uint64_t> epoch_{1};
  std::atomic<long long> overruns_{0};
  std::atomic<long long> samples_{0};
  std::atomic<bool> stopping_{false};
  std::thread thread_;
  // consumer-side only (sweep/scrape threads); the inner loop never
  // takes a lock
  std::mutex harvest_mu_;
  std::map<std::pair<int, int>, double> harvest_;
  double last_harvest_t_ = -1;
};

}  // namespace tpumon
