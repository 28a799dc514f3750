// source.hpp — metric sources for the gpu-hostengine agent.
//
// The agent's analog of the Python Backend seam
// (tpumon_torch/backends/base.py): NvmlSource (nvml_source.hpp) reads the
// host's GPUs through NVML, and FakeSource is the reference agent's
// deterministic fake, kept as it is so the daemon and its wire protocol
// are testable on CPU-only hosts (--fake / TPUMON_AGENT_FAKE=1) and
// answer like the reference agent's --fake.

#pragma once

#include <dirent.h>
#include <unistd.h>

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <ctime>
#include <map>
#include <mutex>
#include <optional>
#include <string>
#include <vector>

#include "tpumon_shim.h"

namespace tpumon {

struct AgentEvent {
  int etype = 0;
  double timestamp = 0;
  long long seq = 0;
  int chip_index = -1;
  std::string uuid;
  std::string message;
};

// one field's reading: blank, a number, a per-link vector (a NaN element
// is a blank element) or a string (the identity fields)
struct FieldValue {
  enum Kind : uint8_t { kBlank = 0, kNum = 1, kVec = 2, kStr = 3 };
  Kind kind = kBlank;
  double num = 0;
  std::vector<double> vec;
  std::string str;

  bool operator==(const FieldValue& o) const {
    if (kind != o.kind) return false;
    if (kind == kNum) return num == o.num;
    if (kind == kStr) return str == o.str;
    if (kind == kVec) {
      if (vec.size() != o.vec.size()) return false;
      for (size_t i = 0; i < vec.size(); i++) {
        bool an = std::isnan(vec[i]), bn = std::isnan(o.vec[i]);
        if (an != bn || (!an && vec[i] != o.vec[i])) return false;
      }
    }
    return true;
  }
  bool operator!=(const FieldValue& o) const { return !(*this == o); }
};

// one holder of a device node
struct DeviceHolder {
  long long pid = 0;
  std::string name;
};

// PIDs with an open fd on ``dev_path``, name-annotated, pid-ordered (the
// walk of /proc/<pid>/fd that tpumon_torch/procscan.py holders_of makes;
// other users' fds are skipped where they cannot be read)
inline std::vector<DeviceHolder> scan_device_holders(
    const std::string& dev_path) {
  std::vector<DeviceHolder> out;
  if (dev_path.empty()) return out;
  DIR* proc = opendir("/proc");
  if (!proc) return out;
  std::vector<long long> pids;
  struct dirent* e;
  while ((e = readdir(proc)) != nullptr) {
    const char* n = e->d_name;
    if (!*n || strspn(n, "0123456789") != strlen(n)) continue;
    pids.push_back(atoll(n));
  }
  closedir(proc);
  std::sort(pids.begin(), pids.end());
  for (long long pid : pids) {
    char fd_dir[64];
    snprintf(fd_dir, sizeof(fd_dir), "/proc/%lld/fd", pid);
    DIR* fds = opendir(fd_dir);
    if (!fds) continue;
    bool holds = false;
    struct dirent* fe;
    while (!holds && (fe = readdir(fds)) != nullptr) {
      if (fe->d_name[0] == '.') continue;
      char link[384], target[512];
      snprintf(link, sizeof(link), "%s/%s", fd_dir, fe->d_name);
      ssize_t len = readlink(link, target, sizeof(target) - 1);
      if (len > 0) {
        target[len] = 0;
        holds = dev_path == target;
      }
    }
    closedir(fds);
    if (!holds) continue;
    DeviceHolder h;
    h.pid = pid;
    char comm_path[64];
    snprintf(comm_path, sizeof(comm_path), "/proc/%lld/comm", pid);
    if (FILE* cf = fopen(comm_path, "re")) {
      char comm[256] = "";
      size_t got = fread(comm, 1, sizeof(comm) - 1, cf);
      fclose(cf);
      comm[got] = 0;
      h.name = comm;
      size_t a = h.name.find_first_not_of(" \t\r\n\v\f");
      size_t b = h.name.find_last_not_of(" \t\r\n\v\f");
      h.name = a == std::string::npos ? "" : h.name.substr(a, b - a + 1);
    }
    out.push_back(std::move(h));
  }
  return out;
}

// one device's place among the host's devices (the topology op's reply)
struct TopologyLink {
  int chip;
  std::string bus_id;
  int link;  // tpumon_torch.types.P2PLinkType
  int hops;
};

struct Topology {
  int x = 0, y = 0, z = 0;
  int numa_node = -1;  // <0: unknown
  std::string cpu_affinity;
  std::vector<int> mesh_shape;
  std::vector<bool> wrap;
  std::vector<TopologyLink> links;
};

class MetricSource {
 public:
  virtual ~MetricSource() = default;
  virtual int chip_count() = 0;
  // returns TPUMON_SHIM_* status
  virtual int chip_info(int chip, tpumon_chip_info_t* out) = 0;
  virtual int read_field(int chip, int field_id, double* out) = 0;
  // read evaluated AT a caller-supplied wall time: the sampler stamps a
  // whole sweep with one timestamp, and the stored value must correspond
  // to that exact instant (the cross-language golden test demands it).
  // Real sources can only read "now" and ignore the hint.
  virtual int read_field_at(int chip, int field_id, double t_wall,
                            double* out) {
    (void)t_wall;
    return read_field(chip, field_id, out);
  }
  // vector (per-link) fields; returns false when the field is not a vector
  // or unsupported on this source
  virtual bool read_vector(int chip, int field_id,
                           std::vector<double>* out) {
    (void)chip; (void)field_id; (void)out;
    return false;
  }
  // every field of one chip read at one stamp (a sweep, a live request):
  // TPUMON_SHIM_ERR_NO_CHIP when the chip is absent or lost, else OK with
  // one value per field.  The default asks read_vector, then
  // read_field_at, field by field; a source whose device answers many
  // fields in one request overrides it.
  virtual int read_fields_at(int chip, const std::vector<int>& fids,
                             double t_wall, std::vector<FieldValue>* out) {
    out->assign(fids.size(), FieldValue());
    if (chip < 0 || chip >= chip_count()) return TPUMON_SHIM_ERR_NO_CHIP;
    for (size_t i = 0; i < fids.size(); i++) {
      FieldValue& fv = (*out)[i];
      if (read_vector(chip, fids[i], &fv.vec)) {
        fv.kind = FieldValue::kVec;
        continue;
      }
      fv.vec.clear();
      if (read_field_at(chip, fids[i], t_wall, &fv.num) == TPUMON_SHIM_OK)
        fv.kind = FieldValue::kNum;
    }
    return TPUMON_SHIM_OK;
  }
  // the burst loop's read of its cheap counters (a source may serve one
  // from another reading at this rate: NVML's instantaneous power)
  virtual int read_burst_at(int chip, const std::vector<int>& fids,
                            double t_wall, std::vector<FieldValue>* out) {
    return read_fields_at(chip, fids, t_wall, out);
  }
  // holders of the device's node; TPUMON_SHIM_ERR_NO_CHIP for no device
  virtual int processes(int chip, std::vector<DeviceHolder>* out) {
    tpumon_chip_info_t info;
    if (chip_info(chip, &info) != TPUMON_SHIM_OK)
      return TPUMON_SHIM_ERR_NO_CHIP;
    *out = scan_device_holders(info.dev_path);
    return TPUMON_SHIM_OK;
  }
  // the reference agent's rule: a mesh from the chips' coordinates,
  // torus distance in hops, the CPUs split evenly across chips
  virtual int topology(int chip, Topology* out) {
    int n = chip_count();
    if (chip < 0 || chip >= n) return TPUMON_SHIM_ERR_NO_CHIP;
    std::vector<tpumon_chip_info_t> all(static_cast<size_t>(n));
    int mx = 1, my = 1;
    for (int i = 0; i < n; i++) {
      if (chip_info(i, &all[i]) != TPUMON_SHIM_OK)
        return TPUMON_SHIM_ERR_INTERNAL;
      mx = std::max(mx, all[i].coord_x + 1);
      my = std::max(my, all[i].coord_y + 1);
    }
    const tpumon_chip_info_t& me = all[chip];
    *out = Topology();
    for (int i = 0; i < n; i++) {
      if (i == chip) continue;
      int dx = std::abs(me.coord_x - all[i].coord_x);
      dx = std::min(dx, mx - dx);
      int dy = std::abs(me.coord_y - all[i].coord_y);
      dy = std::min(dy, my - dy);
      int hops = dx + dy;
      // ICI_NEIGHBOR : ICI_SAME_SLICE
      out->links.push_back({i, all[i].pci_bus_id, hops == 1 ? 2 : 3, hops});
    }
    out->x = me.coord_x;
    out->y = me.coord_y;
    out->z = me.coord_z;
    out->numa_node = me.numa_node;
    long ncpu = sysconf(_SC_NPROCESSORS_ONLN);
    int per = static_cast<int>((ncpu > 0 ? ncpu : 8) / (n > 0 ? n : 1));
    out->cpu_affinity = std::to_string(chip * per) + "-" +
                        std::to_string((chip + 1) * per - 1);
    out->mesh_shape = {mx, my};
    out->wrap = {mx > 2, my > 2};
    return TPUMON_SHIM_OK;
  }
  virtual std::string driver_version() = 0;
  // hello's "runtime": the driver's version unless the source has none
  virtual std::string runtime_version() { return driver_version(); }
  virtual std::vector<AgentEvent> events_since(long long seq) = 0;
  virtual long long current_event_seq() = 0;
  virtual bool inject_event(int chip, int etype, const std::string& msg) {
    (void)chip; (void)etype; (void)msg;
    return false;  // real sources cannot inject
  }
  // externally-observed real event (kernel-log tailer, vendor callback):
  // unlike inject_event this is NOT a test hook and works on every source
  virtual void external_event(int chip, int etype, double ts,
                              const std::string& msg) {
    (void)chip; (void)etype; (void)ts; (void)msg;
  }

  // bounded retention shared by the sources: a chatty kernel log must
  // not grow daemon memory forever; consumers >kMaxEvents behind lose the
  // oldest records (drop-oldest, the bcast-queue contract)
  static void trim_events_locked(std::vector<AgentEvent>* events) {
    static const size_t kMaxEvents = 4096;
    if (events->size() > kMaxEvents)
      events->erase(events->begin(),
                    events->begin() +
                        static_cast<long>(events->size() - kMaxEvents));
  }
};

// ---- deterministic fake source ---------------------------------------------

class FakeSource : public MetricSource {
 public:
  // t0 <= 0 means "now".  A pinned epoch (--fake-epoch) makes the
  // waveforms reproducible across processes: the reference's
  // cross-language golden test evaluates tpumon/backends/fake.py at the
  // agent's own sample timestamps and demands equal values.
  explicit FakeSource(int chips = 4, double t0 = 0)
      : chips_(chips), t0_(t0 > 0 ? t0 : now()) {}

  static double now() {
    struct timespec ts;
    clock_gettime(CLOCK_REALTIME, &ts);
    return static_cast<double>(ts.tv_sec) +
           static_cast<double>(ts.tv_nsec) / 1e9;
  }

  int chip_count() override { return chips_; }

  int chip_info(int chip, tpumon_chip_info_t* out) override {
    if (chip < 0 || chip >= chips_) return TPUMON_SHIM_ERR_NO_CHIP;
    std::memset(out, 0, sizeof(*out));
    out->index = chip;
    snprintf(out->uuid, sizeof(out->uuid), "TPU-agentfake-%02d", chip);
    snprintf(out->name, sizeof(out->name), "TPU v5e");
    snprintf(out->serial, sizeof(out->serial), "AGENTFAKE%04d", chip);
    snprintf(out->dev_path, sizeof(out->dev_path), "/dev/accel%d", chip);
    snprintf(out->firmware, sizeof(out->firmware), "v5e-fw-agent-1");
    out->hbm_total_mib = 16 * 1024;
    out->tc_clock_mhz = 940;
    out->hbm_clock_mhz = 1600;
    out->power_limit_mw = 130000;
    out->numa_node = chip / 2;
    snprintf(out->pci_bus_id, sizeof(out->pci_bus_id), "0000:%02x:00.0",
             0x40 + chip);
    out->coord_x = chip % 2;
    out->coord_y = chip / 2;
    return TPUMON_SHIM_OK;
  }

  int read_field(int chip, int field_id, double* out) override {
    return read_field_at(chip, field_id, now(), out);
  }

  int read_field_at(int chip, int field_id, double t_wall,
                    double* out) override {
    if (chip < 0 || chip >= chips_) return TPUMON_SHIM_ERR_NO_CHIP;
    // clamp like the python fake's _elapsed (fake.py:171-173): a future
    // epoch or backward clock step must not emit negative counters
    double t = std::max(0.0, t_wall - t0_);
    double load = 0.55 + 0.35 * std::sin(2.0 * M_PI * t / 120.0 + 0.7 * chip);
    switch (field_id) {
      // formulas are EXACT mirrors of tpumon/backends/fake.py::_value
      // (v5e params: idle 40 W, peak 115 W, tc 940 MHz); the
      // cross-language golden test (test_agent.py) compares both at the
      // same pinned epoch and fails on any drift
      case 100: *out = std::floor(940.0 * (0.6 + 0.4 * load)); return 0;
      case 101: *out = 1600; return 0;
      case 140:
        *out = std::floor(38 + 28 * load + 2 * std::sin(t / 9.0 + chip));
        return 0;
      case 150:
        *out = std::floor(34 + 32 * load + 2 * std::sin(t / 7.0 + chip));
        return 0;
      case 155: *out = 40.0 + 75.0 * load; return 0;
      case 156: {  // energy mJ: analytic integral, monotone
        double a = 40.0 + 75.0 * 0.55, b = 75.0 * 0.35;
        double w = 2.0 * M_PI / 120.0, phi = 0.7 * chip;
        *out = std::floor((a * t - (b / w) * (std::cos(w * t + phi) -
                                              std::cos(phi))) * 1000.0);
        return 0;
      }
      case 200: *out = std::floor(900000 * load); return 0;
      case 201: *out = std::floor(300000 * load); return 0;
      case 202: *out = std::floor(t / 3600.0); return 0;
      case 203: *out = std::floor(100 * load); return 0;
      case 204: *out = std::floor(85 * load); return 0;
      case 206: *out = std::floor(18 * load); return 0;
      case 207: *out = std::floor(7 * load); return 0;
      case 208:
        *out = load > 0.1 ? 0 : std::floor(std::fmod(t, 600.0));
        return 0;
      case 230: case 231: return read_counter(chip, field_id, out);
      case 240: case 241: {  // power/thermal throttling accrues near peak
        double over = std::max(0.0, load - 0.92);
        *out = std::floor(over * t * 1e6 / 8.0);
        return 0;
      }
      case 242: case 243: case 244: case 245:
        *out = 0; return 0;
      case 250: *out = 16 * 1024; return 0;
      case 251: *out = std::floor(16 * 1024 * (0.12 + 0.75 * load)); return 0;
      case 252: *out = 16 * 1024 - std::floor(16 * 1024 * (0.12 + 0.75 * load));
        return 0;
      case 253: {  // HBM high-water: closed-form max of load over [0,t]
        // (EXACT mirror of fake.py::_load_max's default-profile branch)
        double w = 2.0 * M_PI / 120.0;
        double x0 = 0.7 * chip, x1 = w * t + x0;
        double m;
        if (x1 - x0 >= 2.0 * M_PI) {
          m = 1.0;
        } else {
          m = std::max(std::sin(x0), std::sin(x1));
          double k = std::ceil((x0 - M_PI / 2.0) / (2.0 * M_PI));
          if (M_PI / 2.0 + 2.0 * M_PI * k <= x1) m = 1.0;
        }
        double lm = std::min(1.0, std::max(0.0, 0.55 + 0.35 * m));
        *out = std::floor(16 * 1024 * (0.12 + 0.75 * lm));
        return 0;
      }
      case 310: case 312:
        *out = (chip % 3 == 0) ? std::floor(t / 1800.0) : 0; return 0;
      case 311: case 313: case 390: case 391: case 392: *out = 0; return 0;
      case 409: *out = std::floor(t / 7200.0); return 0;
      case 419: case 429: *out = 0; return 0;
      case 439: case 449: *out = std::floor(45000 * load * 4); return 0;
      case 450: *out = 4; return 0;
      case 1001: *out = load; return 0;
      case 1002: *out = 0.9 * load; return 0;
      case 1003: *out = 0.8 * load; return 0;
      case 1004: *out = 0.5 * load; return 0;
      case 1005: *out = 0.85 * load; return 0;
      case 1006: *out = 0.06 * (1 - load); return 0;
      case 1007: *out = 0.02 * (1 - load); return 0;
      case 1008: *out = 0.08 * load; return 0;
      case 1009: *out = std::floor(1e6 / (2.0 + 8.0 * load)); return 0;
      case 1010: *out = load; return 0;
      case 1011: *out = 197.0 * 0.45 * load; return 0;  // v5e peak bf16 TF/s
      case 1012: *out = 0.45 * load; return 0;
      case 1013: *out = 819.0 * 0.60 * load; return 0;  // v5e HBM GB/s
      case 1014: *out = 819.0 * 0.25 * load; return 0;
      default: return TPUMON_SHIM_ERR_UNSUPPORTED;
    }
  }

  bool read_vector(int chip, int field_id,
                   std::vector<double>* out) override {
    if (chip < 0 || chip >= chips_) return false;
    const int links = 4;
    double t = now() - t0_;
    double load = 0.55 + 0.35 * std::sin(2.0 * M_PI * t / 120.0 + 0.7 * chip);
    out->clear();
    switch (field_id) {
      case 460: case 461: {  // per-link tx/rx MB/s
        double total = 45000.0 * load * links;
        const double share[4] = {0.35, 0.30, 0.20, 0.15};
        double norm = share[0] + share[1] + share[2] + share[3];
        for (int l = 0; l < links; l++)
          out->push_back(std::floor(total * share[l] / norm));
        return true;
      }
      case 462:  // per-link CRC errors: only link 0 accumulates
        for (int l = 0; l < links; l++)
          out->push_back(l == 0 ? std::floor(t / 7200.0) : 0.0);
        return true;
      case 463:  // link state
        for (int l = 0; l < links; l++) out->push_back(1.0);
        return true;
      default:
        return false;
    }
  }

  std::string driver_version() override {
    return "tpu-hostengine-fake 1.0.0";
  }

  std::vector<AgentEvent> events_since(long long seq) override {
    // tpumon: effect-ok(bounded event-ring scan under the fake source's mu_ — inject_event holds it only to append; the fake is the bench/test source)
    std::lock_guard<std::mutex> lock(mu_);
    std::vector<AgentEvent> out;
    for (const auto& e : events_)
      if (e.seq > seq) out.push_back(e);
    return out;
  }

  long long current_event_seq() override {
    std::lock_guard<std::mutex> lock(mu_);
    return events_.empty() ? 0 : events_.back().seq;
  }

  void external_event(int chip, int etype, double ts,
                      const std::string& msg) override {
    (void)ts;  // fake keeps its own clock for deterministic ordering
    inject_event(chip, etype, msg);
  }

  bool inject_event(int chip, int etype, const std::string& msg) override {
    std::lock_guard<std::mutex> lock(mu_);
    AgentEvent e;
    e.etype = etype;
    e.timestamp = now();
    e.seq = ++next_seq_;
    e.chip_index = chip;
    char buf[32];
    snprintf(buf, sizeof(buf), "TPU-agentfake-%02d", chip);
    e.uuid = buf;
    e.message = msg;
    events_.push_back(std::move(e));
    trim_events_locked(&events_);
    if (etype == 1) reset_counts_[chip]++;       // CHIP_RESET
    if (etype == 2) restart_counts_[chip]++;     // RUNTIME_RESTART
    return true;
  }

 private:
  int read_counter(int chip, int field_id, double* out) {
    // tpumon: effect-ok(bounded counter-map probe under the fake source's mu_ — only inject paths write these maps; the fake is the bench/test source)
    std::lock_guard<std::mutex> lock(mu_);
    if (field_id == 230) *out = reset_counts_.count(chip) ? reset_counts_[chip] : 0;
    else *out = restart_counts_.count(chip) ? restart_counts_[chip] : 0;
    return 0;
  }

  int chips_;
  double t0_;
  std::mutex mu_;
  std::vector<AgentEvent> events_;
  long long next_seq_ = 0;
  std::map<int, long long> reset_counts_;
  std::map<int, long long> restart_counts_;
};

}  // namespace tpumon
