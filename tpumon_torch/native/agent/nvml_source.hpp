// nvml_source.hpp — the agent's GPU source: NVML, reached by dlopen.
//
// The C++ counterpart of tpumon_torch/backends/nvml.py NvmlBackend, read
// for read: the same entry points, the same conversions to the catalog's
// units (mW -> W, B -> MiB, ns -> us, KiB counters -> MB/s), the same
// blanks (a missing symbol, NOT_SUPPORTED or NO_PERMISSION leave a field
// blank, never 0), the same derived values, so the Python agent over
// NvmlBackend and this agent answer alike (tests/test_torch_native_agent.py
// holds them op for op over the fake NVML).
//
// * open() loads $TPUMON_NVML_PATH or libnvidia-ml.so.1 and calls
//   nvmlInit_v2.  It never creates a CUDA context: libcuda is NVML's own.
// * A read asks every field value it needs in ONE nvmlDeviceGetFieldValues
//   request per device (violation counters, memory temperature, energy,
//   each NVLink's state and data counters); a (field, scope) NVML answers
//   NOT_SUPPORTED is not asked again, nor is any call so answered.
// * The burst loop's power is NVML_FI_DEV_POWER_INSTANT (on the H100
//   nvmlDeviceGetPowerUsage is a 1 s average).
// * Xid events come from a thread waiting on an NVML event set, and from
//   the kernel log (kmsg.hpp) for devices the event set does not cover.
//
// Every NVML type and constant comes from tpumon_torch/testlib/nvml.h,
// whose layouts chip_smoke.py holds to the toolkit's nvml.h.

#pragma once

#include <dlfcn.h>
#include <unistd.h>

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <fstream>
#include <map>
#include <memory>
#include <mutex>
#include <set>
#include <string>
#include <thread>
#include <utility>
#include <vector>

#include "kmsg.hpp"
#include "nvml.h"
#include "source.hpp"

namespace tpumon {

class NvmlSource : public MetricSource {
 public:
  // how open() ended: OK, no library at all (merge-only mode may serve),
  // or a library that loads and fails (never masked)
  enum OpenResult { kOpened = 0, kAbsent = 1, kFailed = 2 };

  // the event thread's wait, ms: each wait is an NVML call, one a second
  static const unsigned kEventWaitMs = 1000;

  explicit NvmlSource(std::string kmsg_path)
      : kmsg_path_(std::move(kmsg_path)) {}

  ~NvmlSource() override { close(); }

  const std::string& open_error() const { return error_; }

  OpenResult open() {
    const char* env = getenv("TPUMON_NVML_PATH");
    std::string path = env && *env ? env : "libnvidia-ml.so.1";
    lib_ = dlopen(path.c_str(), RTLD_NOW | RTLD_LOCAL);
    if (!lib_) {
      const char* why = dlerror();
      error_ = "cannot load NVML (" + path + "): " + (why ? why : "");
      return kAbsent;
    }
    resolve();
    if (!fn_.init || !fn_.shutdown || !fn_.count || !fn_.handle) {
      error_ = path + " is not NVML";
      dlclose(lib_);
      lib_ = nullptr;
      return kFailed;
    }
    int rc = fn_.init();
    if (rc != NVML_SUCCESS) {
      error_ = "nvmlInit_v2 failed: rc=" + std::to_string(rc);
      return kFailed;
    }
    unsigned count = 0;
    rc = fn_.count(&count);
    if (rc != NVML_SUCCESS) {
      error_ = "nvmlDeviceGetCount_v2 failed: rc=" + std::to_string(rc);
      fn_.shutdown();
      return kFailed;
    }
    for (unsigned i = 0; i < count; i++) {
      nvmlDevice_t h = nullptr;
      rc = fn_.handle(i, &h);
      if (rc != NVML_SUCCESS) {
        error_ = "nvmlDeviceGetHandleByIndex_v2(" + std::to_string(i) +
                 ") failed: rc=" + std::to_string(rc);
        fn_.shutdown();
        devices_.clear();
        return kFailed;
      }
      devices_.emplace_back(new Device(static_cast<int>(i), h));
    }
    opened_ = true;
    char buf[NVML_SYSTEM_DRIVER_VERSION_BUFFER_SIZE];
    driver_ = string_call(fn_.driver_version, "nvmlSystemGetDriverVersion",
                          buf, sizeof(buf));
    start_event_sources();
    return kOpened;
  }

  void close() {
    if (kmsg_) {
      kmsg_->stop();
      kmsg_.reset();
    }
    event_stop_ = true;
    if (event_thread_.joinable()) event_thread_.join();
    if (opened_) {
      if (event_set_ && fn_.event_free) fn_.event_free(event_set_);
      fn_.shutdown();
    }
    event_set_ = nullptr;
    opened_ = false;
  }

  // -- inventory --------------------------------------------------------------

  int chip_count() override { return static_cast<int>(devices_.size()); }

  int chip_info(int chip, tpumon_chip_info_t* out) override {
    try {
      const Info& info = info_of(device(chip));
      std::memset(out, 0, sizeof(*out));
      out->index = chip;
      copy(out->uuid, sizeof(out->uuid), info.uuid);
      copy(out->name, sizeof(out->name), info.name);
      copy(out->serial, sizeof(out->serial), info.serial);
      copy(out->dev_path, sizeof(out->dev_path), info.dev_path);
      copy(out->firmware, sizeof(out->firmware), info.firmware);
      copy(out->pci_bus_id, sizeof(out->pci_bus_id), info.bus_id);
      out->hbm_total_mib = info.hbm_total_mib;
      out->tc_clock_mhz = info.sm_max_mhz;
      out->hbm_clock_mhz = info.mem_max_mhz;
      out->power_limit_mw = info.power_limit_mw;
      out->numa_node = info.numa_node;
      out->coord_x = chip;
      return TPUMON_SHIM_OK;
    } catch (const Lost&) {
      return TPUMON_SHIM_ERR_NO_CHIP;
    }
  }

  std::string driver_version() override { return driver_; }
  // NVML knows no runtime (NvmlBackend.versions: runtime "")
  std::string runtime_version() override { return ""; }

  // each device's PCI bus key -> its index (for kmsg lines)
  BusMap bus_index() {
    BusMap out;
    for (auto& d : devices_) {
      try {
        BusKey key;
        if (kmsg_bus_key(info_of(*d).bus_id, &key)) out[key] = d->index;
      } catch (const Lost&) {
      }
    }
    return out;
  }

  // holders of /dev/nvidia<minor>, by the /proc fd scan
  int processes(int chip, std::vector<DeviceHolder>* out) override {
    try {
      *out = scan_device_holders(info_of(device(chip)).dev_path);
      return TPUMON_SHIM_OK;
    } catch (const Lost&) {
      return TPUMON_SHIM_ERR_NO_CHIP;
    }
  }

  // Other GPUs reached over an active NVLink (directly, or through an
  // NVSwitch both reach) are ICI_NEIGHBOR, the rest SAME_HOST_PCIE; CPU
  // affinity from NVML, else the PCI device's local_cpulist
  int topology(int chip, Topology* out) override {
    try {
      Device& d = device(chip);
      const Info& me = info_of(d);
      std::set<BusKey> peers;
      bool switched = nvlink_peers(d, &peers);
      *out = Topology();
      out->x = chip;
      out->numa_node = me.numa_node;
      out->cpu_affinity = affinity(d);
      out->mesh_shape = {chip_count()};
      for (auto& other : devices_) {
        if (other->index == chip) continue;
        const Info& oi = info_of(*other);
        BusKey key;
        bool near = kmsg_bus_key(oi.bus_id, &key) && peers.count(key);
        if (!near && switched) {
          std::set<BusKey> unused;
          near = nvlink_peers(*other, &unused);
        }
        out->links.push_back({other->index, oi.bus_id, near ? 2 : 1, 1});
      }
      return TPUMON_SHIM_OK;
    } catch (const Lost&) {
      return TPUMON_SHIM_ERR_NO_CHIP;
    }
  }

  // -- events -----------------------------------------------------------------

  std::vector<AgentEvent> events_since(long long seq) override {
    // tpumon: effect-ok(bounded event-ring scan under events_mu_ — the Xid event thread and the kmsg watcher hold it only to append one event, never across an NVML call)
    std::lock_guard<std::mutex> lock(events_mu_);
    std::vector<AgentEvent> out;
    for (const auto& e : events_)
      if (e.seq > seq) out.push_back(e);
    return out;
  }

  long long current_event_seq() override {
    std::lock_guard<std::mutex> lock(events_mu_);
    return events_.empty() ? 0 : events_.back().seq;
  }

  // -- metrics ----------------------------------------------------------------

  // one scalar (the agent reads by read_fields_at; this is the
  // interface's single-field form)
  int read_field(int chip, int field_id, double* out) override {
    std::vector<FieldValue> vals;
    int rc = read_fields_at(chip, {field_id}, 0, &vals);
    if (rc != TPUMON_SHIM_OK) return rc;
    if (vals[0].kind != FieldValue::kNum) return TPUMON_SHIM_ERR_UNSUPPORTED;
    *out = vals[0].num;
    return TPUMON_SHIM_OK;
  }

  int read_fields_at(int chip, const std::vector<int>& fids, double t_wall,
                     std::vector<FieldValue>* out) override {
    (void)t_wall;  // NVML reads now
    out->assign(fids.size(), FieldValue());
    try {
      Device& d = device(chip);
      read(d, fids, {}, out, nullptr);
      return TPUMON_SHIM_OK;
    } catch (const Lost&) {
      out->assign(fids.size(), FieldValue());
      return TPUMON_SHIM_ERR_NO_CHIP;
    }
  }

  // NvmlBackend.read_burst_fields: power (155) from the instantaneous
  // reading in the same field-values request as the rest, where the
  // driver serves it (else, once refused, nvmlDeviceGetPowerUsage)
  int read_burst_at(int chip, const std::vector<int>& fids, double t_wall,
                    std::vector<FieldValue>* out) override {
    (void)t_wall;
    out->assign(fids.size(), FieldValue());
    try {
      Device& d = device(chip);
      std::vector<int> rest;
      bool power = false;
      for (int f : fids) {
        if (f == kPower) power = true;
        else rest.push_back(f);
      }
      std::vector<FieldValue> vals(rest.size());
      FieldValues fv;
      read(d, rest, power ? Ask{{NVML_FI_DEV_POWER_INSTANT, 0}} : Ask{},
           &vals, &fv);
      FieldValue pw;
      if (power) {
        double mw = 0;
        if (value_of(fv, NVML_FI_DEV_POWER_INSTANT, 0, &mw)) {
          pw.kind = FieldValue::kNum;
          pw.num = mw / 1000.0;
        } else {
          std::vector<FieldValue> one(1);
          read(d, {kPower}, {}, &one, nullptr);
          pw = one[0];
        }
      }
      size_t k = 0;
      for (size_t i = 0; i < fids.size(); i++)
        (*out)[i] = fids[i] == kPower ? pw : vals[k++];
      return TPUMON_SHIM_OK;
    } catch (const Lost&) {
      out->assign(fids.size(), FieldValue());
      return TPUMON_SHIM_ERR_NO_CHIP;
    }
  }

 private:
  // a device NVML reports lost (NVML_ERROR_GPU_IS_LOST) or an index out of
  // range: the chip is absent for this call
  struct Lost {};

  // catalog field ids (tpumon_torch/fields.py F)
  enum : int {
    kName = 51, kUuid = 52, kFirmware = 55,
    kTcClock = 100, kHbmClock = 101, kHbmTemp = 140, kCoreTemp = 150,
    kPower = 155, kEnergy = 156, kPcieTx = 200, kPcieRx = 201,
    kPcieReplay = 202, kTcUtil = 203, kHbmBwUtil = 204,
    kPowerViol = 240, kReliabilityViol = 245,
    kHbmTotal = 250, kHbmUsed = 251, kHbmFree = 252,
    kEccSbeTotal = 310, kEccDbeTotal = 311, kEccSbeVol = 312,
    kEccDbeVol = 313, kRemapSbe = 390, kRemapDbe = 391, kRemapPending = 392,
    kLinkCrcTotal = 409, kLinkRecoveryTotal = 419, kLinkReplayTotal = 429,
    kLinkTxTotal = 439, kLinkRxTotal = 449, kLinksUp = 450,
    kLinkTx = 460, kLinkRx = 461, kLinkCrc = 462, kLinkState = 463,
  };

  using Ask = std::vector<std::pair<unsigned, unsigned>>;  // (field, scope)
  using FieldValues = std::map<std::pair<unsigned, unsigned>,
                               nvmlFieldValue_t>;

  struct Info {
    std::string uuid, name, serial, dev_path, firmware, bus_id;
    long long hbm_total_mib = 0;
    int sm_max_mhz = 0, mem_max_mhz = 0;
    long long power_limit_mw = 0;
    int numa_node = -1;
  };

  struct Device {
    Device(int i, nvmlDevice_t h) : index(i), handle(h) {}
    int index;
    nvmlDevice_t handle;
    std::unique_ptr<Info> info;  // built once (state_mu_)
    // the NVLinks that report a state, probed once (state_mu_)
    bool links_known = false;
    std::vector<unsigned> link_ids;
    // (link, NVML field) -> (KiB counter, its timestamp in us)
    std::map<std::pair<unsigned, unsigned>,
             std::pair<unsigned long long, long long>> link_counters;
  };

  // the entry points, each resolved on its own (a missing one blanks its
  // fields and never fails the open)
  struct Fns {
    int (*init)() = nullptr;
    int (*shutdown)() = nullptr;
    int (*count)(unsigned*) = nullptr;
    int (*handle)(unsigned, nvmlDevice_t*) = nullptr;
    int (*driver_version)(char*, unsigned) = nullptr;
    int (*name)(nvmlDevice_t, char*, unsigned) = nullptr;
    int (*uuid)(nvmlDevice_t, char*, unsigned) = nullptr;
    int (*serial)(nvmlDevice_t, char*, unsigned) = nullptr;
    int (*vbios)(nvmlDevice_t, char*, unsigned) = nullptr;
    int (*minor)(nvmlDevice_t, unsigned*) = nullptr;
    int (*pci)(nvmlDevice_t, nvmlPciInfo_t*) = nullptr;
    int (*max_clock)(nvmlDevice_t, int, unsigned*) = nullptr;
    int (*clock)(nvmlDevice_t, int, unsigned*) = nullptr;
    int (*power_limit)(nvmlDevice_t, unsigned*) = nullptr;
    int (*power)(nvmlDevice_t, unsigned*) = nullptr;
    int (*energy)(nvmlDevice_t, unsigned long long*) = nullptr;
    int (*memory)(nvmlDevice_t, nvmlMemory_v2_t*) = nullptr;
    int (*temperature)(nvmlDevice_t, int, unsigned*) = nullptr;
    int (*field_values)(nvmlDevice_t, int, nvmlFieldValue_t*) = nullptr;
    int (*pcie_throughput)(nvmlDevice_t, int, unsigned*) = nullptr;
    int (*pcie_replay)(nvmlDevice_t, unsigned*) = nullptr;
    int (*utilization)(nvmlDevice_t, nvmlUtilization_t*) = nullptr;
    int (*ecc)(nvmlDevice_t, int, int, unsigned long long*) = nullptr;
    int (*remapped)(nvmlDevice_t, unsigned*, unsigned*, unsigned*,
                    unsigned*) = nullptr;
    int (*link_state)(nvmlDevice_t, unsigned, int*) = nullptr;
    int (*link_error)(nvmlDevice_t, unsigned, int,
                      unsigned long long*) = nullptr;
    int (*link_remote_pci)(nvmlDevice_t, unsigned, nvmlPciInfo_t*) = nullptr;
    int (*link_remote_type)(nvmlDevice_t, unsigned, int*) = nullptr;
    int (*cpu_affinity)(nvmlDevice_t, unsigned, unsigned long*) = nullptr;
    int (*event_create)(nvmlEventSet_t*) = nullptr;
    int (*event_register)(nvmlDevice_t, unsigned long long,
                          nvmlEventSet_t) = nullptr;
    int (*event_wait)(nvmlEventSet_t, nvmlEventData_t*, unsigned) = nullptr;
    int (*event_free)(nvmlEventSet_t) = nullptr;
  };

  template <typename F>
  void sym(F* out, const char* name) {
    *out = reinterpret_cast<F>(dlsym(lib_, name));
  }

  void resolve() {
    sym(&fn_.init, "nvmlInit_v2");
    sym(&fn_.shutdown, "nvmlShutdown");
    sym(&fn_.count, "nvmlDeviceGetCount_v2");
    sym(&fn_.handle, "nvmlDeviceGetHandleByIndex_v2");
    sym(&fn_.driver_version, "nvmlSystemGetDriverVersion");
    sym(&fn_.name, "nvmlDeviceGetName");
    sym(&fn_.uuid, "nvmlDeviceGetUUID");
    sym(&fn_.serial, "nvmlDeviceGetSerial");
    sym(&fn_.vbios, "nvmlDeviceGetVbiosVersion");
    sym(&fn_.minor, "nvmlDeviceGetMinorNumber");
    sym(&fn_.pci, "nvmlDeviceGetPciInfo_v3");
    sym(&fn_.max_clock, "nvmlDeviceGetMaxClockInfo");
    sym(&fn_.clock, "nvmlDeviceGetClockInfo");
    sym(&fn_.power_limit, "nvmlDeviceGetEnforcedPowerLimit");
    sym(&fn_.power, "nvmlDeviceGetPowerUsage");
    sym(&fn_.energy, "nvmlDeviceGetTotalEnergyConsumption");
    sym(&fn_.memory, "nvmlDeviceGetMemoryInfo_v2");
    sym(&fn_.temperature, "nvmlDeviceGetTemperature");
    sym(&fn_.field_values, "nvmlDeviceGetFieldValues");
    sym(&fn_.pcie_throughput, "nvmlDeviceGetPcieThroughput");
    sym(&fn_.pcie_replay, "nvmlDeviceGetPcieReplayCounter");
    sym(&fn_.utilization, "nvmlDeviceGetUtilizationRates");
    sym(&fn_.ecc, "nvmlDeviceGetTotalEccErrors");
    sym(&fn_.remapped, "nvmlDeviceGetRemappedRows");
    sym(&fn_.link_state, "nvmlDeviceGetNvLinkState");
    sym(&fn_.link_error, "nvmlDeviceGetNvLinkErrorCounter");
    sym(&fn_.link_remote_pci, "nvmlDeviceGetNvLinkRemotePciInfo_v2");
    sym(&fn_.link_remote_type, "nvmlDeviceGetNvLinkRemoteDeviceType");
    sym(&fn_.cpu_affinity, "nvmlDeviceGetCpuAffinity");
    sym(&fn_.event_create, "nvmlEventSetCreate");
    sym(&fn_.event_register, "nvmlDeviceRegisterEvents");
    sym(&fn_.event_wait, "nvmlEventSetWait_v2");
    sym(&fn_.event_free, "nvmlEventSetFree");
  }

  // -- the call discipline (NvmlBackend._call) --------------------------------

  // the key of one call: its name and integer arguments (a call NVML
  // answered NOT_SUPPORTED is the device's and driver's for good)
  static std::string key(const char* name, const void* h, long long a = -1,
                         long long b = -1, long long c = -1) {
    char buf[160];
    snprintf(buf, sizeof(buf), "%s|%p|%lld|%lld|%lld", name, h, a, b, c);
    return buf;
  }

  bool refused(const std::string& k) {
    // tpumon: effect-ok(bounded memo lock — state_mu_ guards only the memo tables: the NOT_SUPPORTED set, the per-device info and link caches, the link counters; each hold is one container lookup or insert, never an NVML call, I/O or wait, so a serve thread waits at most for another thread's single container operation)
    std::lock_guard<std::mutex> g(state_mu_);
    return unsupported_.count(k) != 0;
  }

  // false when the entry point is missing or refuses; a lost GPU throws
  bool check(int rc, const std::string& k) {
    if (rc == NVML_ERROR_GPU_IS_LOST) throw Lost();
    if (rc == NVML_ERROR_NOT_SUPPORTED) {
      // tpumon: effect-ok(bounded memo lock — state_mu_ guards only the memo tables: the NOT_SUPPORTED set, the per-device info and link caches, the link counters; each hold is one container lookup or insert, never an NVML call, I/O or wait, so a serve thread waits at most for another thread's single container operation)
      std::lock_guard<std::mutex> g(state_mu_);
      unsupported_.insert(k);
    }
    return rc == NVML_SUCCESS;
  }

  template <typename Fn, typename... Args>
  bool call(Fn fn, const std::string& k, Args... args) {
    if (fn == nullptr || refused(k)) return false;
    return check(fn(args...), k);
  }

  std::string string_call(int (*fn)(char*, unsigned), const char* name,
                          char* buf, unsigned size) {
    buf[0] = 0;
    return call(fn, key(name, nullptr, size), buf, size) ? std::string(buf)
                                                         : std::string();
  }

  std::string dev_string(int (*fn)(nvmlDevice_t, char*, unsigned),
                         const char* name, nvmlDevice_t h, unsigned size) {
    std::vector<char> buf(size + 1, 0);
    return call(fn, key(name, h, size), h, buf.data(), size)
               ? std::string(buf.data())
               : std::string();
  }

  bool uint_call(int (*fn)(nvmlDevice_t, unsigned*), const char* name,
                 nvmlDevice_t h, double* out) {
    unsigned v = 0;
    if (!call(fn, key(name, h), h, &v)) return false;
    *out = v;
    return true;
  }

  bool uint_call(int (*fn)(nvmlDevice_t, int, unsigned*), const char* name,
                 nvmlDevice_t h, int arg, double* out) {
    unsigned v = 0;
    if (!call(fn, key(name, h, arg), h, arg, &v)) return false;
    *out = v;
    return true;
  }

  Device& device(int chip) {
    if (!opened_ || chip < 0 || chip >= chip_count()) throw Lost();
    return *devices_[static_cast<size_t>(chip)];
  }

  static void copy(char* dst, size_t cap, const std::string& s) {
    snprintf(dst, cap, "%s", s.c_str());
  }

  // an attribute of the GPU's PCI device in sysfs ($TPUMON_NVML_SYSFS_ROOT
  // prefixes the tree, the tests' hook); false if unreadable
  static bool sysfs_attr(const std::string& bus_id, const char* attr,
                         std::string* out) {
    BusKey k;
    if (!kmsg_bus_key(bus_id, &k)) return false;
    const char* root = getenv("TPUMON_NVML_SYSFS_ROOT");
    char path[512];
    snprintf(path, sizeof(path), "%s/sys/bus/pci/devices/%04llx:%02x:%02x.0/%s",
             root ? root : "", std::get<0>(k), std::get<1>(k), std::get<2>(k),
             attr);
    std::ifstream f(path);
    if (!f) return false;
    std::string text((std::istreambuf_iterator<char>(f)),
                     std::istreambuf_iterator<char>());
    size_t a = text.find_first_not_of(" \t\r\n\v\f");
    size_t b = text.find_last_not_of(" \t\r\n\v\f");
    *out = a == std::string::npos ? "" : text.substr(a, b - a + 1);
    return true;
  }

  // the device's static record, read once (NvmlBackend.chip_info)
  const Info& info_of(Device& d) {
    {
      // tpumon: effect-ok(bounded memo lock — state_mu_ guards only the memo tables: the NOT_SUPPORTED set, the per-device info and link caches, the link counters; each hold is one container lookup or insert, never an NVML call, I/O or wait, so a serve thread waits at most for another thread's single container operation)
      std::lock_guard<std::mutex> g(state_mu_);
      if (d.info) return *d.info;
    }
    std::unique_ptr<Info> info(new Info);
    nvmlDevice_t h = d.handle;
    double v = 0;
    if (uint_call(fn_.minor, "nvmlDeviceGetMinorNumber", h, &v))
      info->dev_path = "/dev/nvidia" + std::to_string(
                                           static_cast<unsigned>(v));
    nvmlPciInfo_t pci;
    std::memset(&pci, 0, sizeof(pci));
    if (call(fn_.pci, key("nvmlDeviceGetPciInfo_v3", h), h, &pci)) {
      pci.busId[sizeof(pci.busId) - 1] = 0;
      info->bus_id = pci.busId;
    }
    if (uint_call(fn_.power_limit, "nvmlDeviceGetEnforcedPowerLimit", h, &v))
      info->power_limit_mw = static_cast<long long>(v);
    nvmlMemory_v2_t mem;
    if (memory(h, &mem))
      info->hbm_total_mib = static_cast<long long>(mem.total / kMiB);
    std::string numa;
    if (sysfs_attr(info->bus_id, "numa_node", &numa)) {
      std::string digits = numa;
      digits.erase(0, digits.find_first_not_of('-'));
      if (!digits.empty() &&
          digits.find_first_not_of("0123456789") == std::string::npos) {
        long long n = std::strtoll(numa.c_str(), nullptr, 10);
        if (n >= 0) info->numa_node = static_cast<int>(n);
      }
    }
    info->uuid = dev_string(fn_.uuid, "nvmlDeviceGetUUID", h,
                            NVML_DEVICE_UUID_V2_BUFFER_SIZE);
    info->name = dev_string(fn_.name, "nvmlDeviceGetName", h,
                            NVML_DEVICE_NAME_V2_BUFFER_SIZE);
    if (info->name.empty()) info->name = "GPU";
    info->serial = dev_string(fn_.serial, "nvmlDeviceGetSerial", h,
                              NVML_DEVICE_SERIAL_BUFFER_SIZE);
    info->firmware = dev_string(fn_.vbios, "nvmlDeviceGetVbiosVersion", h,
                                NVML_DEVICE_VBIOS_VERSION_BUFFER_SIZE);
    if (uint_call(fn_.max_clock, "nvmlDeviceGetMaxClockInfo", h,
                  NVML_CLOCK_SM, &v))
      info->sm_max_mhz = static_cast<int>(v);
    if (uint_call(fn_.max_clock, "nvmlDeviceGetMaxClockInfo", h,
                  NVML_CLOCK_MEM, &v))
      info->mem_max_mhz = static_cast<int>(v);
    // tpumon: effect-ok(bounded memo lock — state_mu_ guards only the memo tables: the NOT_SUPPORTED set, the per-device info and link caches, the link counters; each hold is one container lookup or insert, never an NVML call, I/O or wait, so a serve thread waits at most for another thread's single container operation)
    std::lock_guard<std::mutex> g(state_mu_);
    if (!d.info) d.info = std::move(info);
    return *d.info;
  }

  bool memory(nvmlDevice_t h, nvmlMemory_v2_t* mem) {
    std::memset(mem, 0, sizeof(*mem));
    mem->version = nvmlMemory_v2;
    return call(fn_.memory, key("nvmlDeviceGetMemoryInfo_v2", h), h, mem);
  }

  // -- NVLink -----------------------------------------------------------------

  std::vector<unsigned> probe_links(Device& d) {
    // tpumon: effect-ok(bounded memo lock — state_mu_ guards only the memo tables: the NOT_SUPPORTED set, the per-device info and link caches, the link counters; each hold is one container lookup or insert, never an NVML call, I/O or wait, so a serve thread waits at most for another thread's single container operation)
    std::lock_guard<std::mutex> g(state_mu_);
    if (d.links_known) return d.link_ids;
    std::vector<unsigned> all;
    for (unsigned l = 0; l < NVML_NVLINK_MAX_LINKS; l++) all.push_back(l);
    return all;
  }

  void learn_links(Device& d, const std::vector<unsigned>& ids) {
    // tpumon: effect-ok(bounded memo lock — state_mu_ guards only the memo tables: the NOT_SUPPORTED set, the per-device info and link caches, the link counters; each hold is one container lookup or insert, never an NVML call, I/O or wait, so a serve thread waits at most for another thread's single container operation)
    std::lock_guard<std::mutex> g(state_mu_);
    if (!d.links_known) {
      d.links_known = true;
      d.link_ids = ids;
    }
  }

  // (link, active) for each NVLink the device reports a state for, by the
  // per-link entry point (NvmlBackend._links)
  std::vector<std::pair<unsigned, bool>> links(Device& d) {
    std::vector<std::pair<unsigned, bool>> out;
    for (unsigned link : probe_links(d)) {
      int state = 0;
      if (call(fn_.link_state, key("nvmlDeviceGetNvLinkState", d.handle, link),
               d.handle, link, &state))
        out.emplace_back(link, state == NVML_FEATURE_ENABLED);
    }
    std::vector<unsigned> ids;
    for (auto& l : out) ids.push_back(l.first);
    learn_links(d, ids);
    return out;
  }

  // bus keys at the far end of the active links; true if one of them is
  // an NVSwitch (NvmlBackend._nvlink_peers)
  bool nvlink_peers(Device& d, std::set<BusKey>* peers) {
    bool switched = false;
    for (auto& [link, active] : links(d)) {
      if (!active) continue;
      int kind = 0;
      if (call(fn_.link_remote_type,
               key("nvmlDeviceGetNvLinkRemoteDeviceType", d.handle, link),
               d.handle, link, &kind) &&
          kind == NVML_NVLINK_DEVICE_TYPE_SWITCH) {
        switched = true;
        continue;
      }
      nvmlPciInfo_t pci;
      std::memset(&pci, 0, sizeof(pci));
      if (call(fn_.link_remote_pci,
               key("nvmlDeviceGetNvLinkRemotePciInfo_v2", d.handle, link),
               d.handle, link, &pci)) {
        pci.busId[sizeof(pci.busId) - 1] = 0;
        BusKey k;
        if (kmsg_bus_key(pci.busId, &k)) peers->insert(k);
      }
    }
    return switched;
  }

  // a CPU bitmask (64 bits a word, least significant first) as a kernel
  // cpulist such as 0-47,96-143 (nvml.py cpulist)
  static std::string cpulist(const std::vector<unsigned long>& words) {
    const int bits = 8 * static_cast<int>(sizeof(unsigned long));
    std::string out;
    long first = -1, last = -2;
    auto flush = [&]() {
      if (first < 0) return;
      if (!out.empty()) out += ",";
      out += std::to_string(first);
      if (last != first) out += "-" + std::to_string(last);
    };
    for (size_t w = 0; w < words.size(); w++)
      for (int b = 0; b < bits; b++) {
        if (!(words[w] >> b & 1UL)) continue;
        long c = static_cast<long>(w) * bits + b;
        if (c == last + 1) {
          last = c;
        } else {
          flush();
          first = last = c;
        }
      }
    flush();
    return out;
  }

  std::string affinity(Device& d) {
    const long bits = 8 * static_cast<long>(sizeof(unsigned long));
    long ncpu = sysconf(_SC_NPROCESSORS_ONLN);
    unsigned n = static_cast<unsigned>((ncpu > 0 ? ncpu : 1) / bits + 1);
    std::vector<unsigned long> words(n, 0);
    if (call(fn_.cpu_affinity, key("nvmlDeviceGetCpuAffinity", d.handle, n),
             d.handle, n, words.data())) {
      std::string text = cpulist(words);
      if (!text.empty()) return text;
    }
    std::string text;
    return sysfs_attr(info_of(d).bus_id, "local_cpulist", &text) ? text : "";
  }

  // -- field values -----------------------------------------------------------

  // the (field, scope) pairs a read of ``fids`` asks in its one request
  // (nvml.py _field_request): violation counters, memory temperature and
  // energy (scope 0), each NVLink's state and data counters (scope = link)
  Ask field_request(Device& d, const std::vector<int>& fids) {
    Ask ask;
    std::set<int> want(fids.begin(), fids.end());
    for (int f : fids)
      if (f >= kPowerViol && f <= kReliabilityViol)
        ask.emplace_back(violation_field(f), 0);
    if (want.count(kHbmTemp)) ask.emplace_back(NVML_FI_DEV_MEMORY_TEMP, 0);
    if (want.count(kEnergy))
      ask.emplace_back(NVML_FI_DEV_TOTAL_ENERGY_CONSUMPTION, 0);
    bool link_fields = false;
    std::set<unsigned> rates;
    for (int f : want) {
      if (is_link_field(f)) link_fields = true;
      if (unsigned r = rate_field(f)) rates.insert(r);
    }
    if (link_fields) {
      std::vector<unsigned> ids = probe_links(d);
      std::vector<unsigned> order = {NVML_FI_DEV_NVLINK_GET_STATE};
      order.insert(order.end(), rates.begin(), rates.end());
      for (unsigned f : order)
        for (unsigned link : ids) ask.emplace_back(f, link);
    }
    return ask;
  }

  static unsigned violation_field(int f) {
    return NVML_FI_DEV_PERF_POLICY_POWER + static_cast<unsigned>(f - kPowerViol);
  }

  static unsigned rate_field(int f) {
    if (f == kLinkTx || f == kLinkTxTotal)
      return NVML_FI_DEV_NVLINK_THROUGHPUT_DATA_TX;
    if (f == kLinkRx || f == kLinkRxTotal)
      return NVML_FI_DEV_NVLINK_THROUGHPUT_DATA_RX;
    return 0;
  }

  static bool is_link_field(int f) {
    return f == kLinkCrcTotal || f == kLinkRecoveryTotal ||
           f == kLinkReplayTotal || rate_field(f) != 0 || f == kLinkCrc ||
           f == kLinksUp || f == kLinkState;
  }

  // one nvmlDeviceGetFieldValues call for ``ask`` (duplicates and pairs
  // once refused dropped): the samples NVML served
  FieldValues field_values(Device& d, const Ask& ask_in) {
    FieldValues out;
    Ask ask;
    {
      std::set<std::pair<unsigned, unsigned>> seen;
      // tpumon: effect-ok(bounded memo lock — state_mu_ guards only the memo tables: the NOT_SUPPORTED set, the per-device info and link caches, the link counters; each hold is one container lookup or insert, never an NVML call, I/O or wait, so a serve thread waits at most for another thread's single container operation)
      std::lock_guard<std::mutex> g(state_mu_);
      for (auto& k : ask_in)
        if (seen.insert(k).second &&
            !unsupported_.count(key("field", d.handle, k.first, k.second)))
          ask.push_back(k);
    }
    if (ask.empty()) return out;
    std::vector<nvmlFieldValue_t> arr(ask.size());
    std::memset(arr.data(), 0, arr.size() * sizeof(arr[0]));
    for (size_t i = 0; i < ask.size(); i++) {
      arr[i].fieldId = ask[i].first;
      arr[i].scopeId = ask[i].second;
    }
    int n = static_cast<int>(ask.size());
    if (!call(fn_.field_values,
              key("nvmlDeviceGetFieldValues", d.handle, n), d.handle, n,
              arr.data()))
      return out;
    for (size_t i = 0; i < ask.size(); i++) {
      int rc = arr[i].nvmlReturn;
      if (rc == NVML_ERROR_GPU_IS_LOST) throw Lost();
      if (rc == NVML_ERROR_NOT_SUPPORTED) {
        // tpumon: effect-ok(bounded memo lock — state_mu_ guards only the memo tables: the NOT_SUPPORTED set, the per-device info and link caches, the link counters; each hold is one container lookup or insert, never an NVML call, I/O or wait, so a serve thread waits at most for another thread's single container operation)
        std::lock_guard<std::mutex> g(state_mu_);
        unsupported_.insert(key("field", d.handle, ask[i].first,
                                ask[i].second));
      } else if (rc == NVML_SUCCESS) {
        out[ask[i]] = arr[i];
      }
    }
    return out;
  }

  // a sample's number by its value type; false for none.  Integral types
  // stay exact in ``*exact`` (the KiB counters).
  static bool value_of(const nvmlFieldValue_t& fv, double* out,
                       unsigned long long* exact = nullptr) {
    unsigned long long u = 0;
    switch (fv.valueType) {
      case NVML_VALUE_TYPE_DOUBLE: *out = fv.value.dVal; u = 0; break;
      case NVML_VALUE_TYPE_UNSIGNED_INT: u = fv.value.uiVal; *out = u; break;
      case NVML_VALUE_TYPE_UNSIGNED_LONG: u = fv.value.ulVal; *out = u; break;
      case NVML_VALUE_TYPE_UNSIGNED_LONG_LONG:
        u = fv.value.ullVal;
        *out = static_cast<double>(u);
        break;
      case NVML_VALUE_TYPE_SIGNED_LONG_LONG:
        *out = static_cast<double>(fv.value.sllVal);
        u = static_cast<unsigned long long>(fv.value.sllVal);
        break;
      case NVML_VALUE_TYPE_SIGNED_INT:
        *out = fv.value.siVal;
        u = static_cast<unsigned long long>(fv.value.siVal);
        break;
      default: return false;
    }
    if (exact) *exact = u;
    return true;
  }

  static bool value_of(const FieldValues& fv, unsigned f, unsigned scope,
                       double* out) {
    auto it = fv.find({f, scope});
    return it != fv.end() && value_of(it->second, out);
  }

  // MB/s of one link's KiB data counter since the last read: KiB x 1024 B
  // over microseconds is B/us, which is MB/s.  Blank (NaN) on the first
  // read and when the counter went back (NvmlBackend._link_rate).
  double link_rate(Device& d, unsigned link, unsigned f,
                   const FieldValues& fv) {
    auto it = fv.find({f, link});
    double kib_d = 0;
    unsigned long long kib = 0;
    if (it == fv.end() || !value_of(it->second, &kib_d, &kib)) return NAN;
    if (it->second.valueType == NVML_VALUE_TYPE_DOUBLE)
      kib = static_cast<unsigned long long>(kib_d);
    long long ts = it->second.timestamp;
    std::pair<unsigned long long, long long> prev;
    bool had;
    {
      // tpumon: effect-ok(bounded memo lock — state_mu_ guards only the memo tables: the NOT_SUPPORTED set, the per-device info and link caches, the link counters; each hold is one container lookup or insert, never an NVML call, I/O or wait, so a serve thread waits at most for another thread's single container operation)
      std::lock_guard<std::mutex> g(state_mu_);
      auto p = d.link_counters.find({link, f});
      had = p != d.link_counters.end();
      if (had) prev = p->second;
      d.link_counters[{link, f}] = {kib, ts};
    }
    if (!had || ts <= prev.second || kib < prev.first) return NAN;
    return std::nearbyint(static_cast<double>(kib - prev.first) * 1024.0 /
                          static_cast<double>(ts - prev.second));
  }

  static void set_num(FieldValue* v, double x) {
    v->kind = FieldValue::kNum;
    v->num = x;
  }

  // per link, a vector blank unless some element is not (link_vector);
  // ``total`` sums the elements that are not blank (total)
  static void set_links(FieldValue* v, const std::vector<double>& vals,
                        bool total) {
    bool any = false;
    double sum = 0;
    for (double x : vals)
      if (!std::isnan(x)) {
        any = true;
        sum += x;
      }
    if (!any) return;
    if (total) {
      set_num(v, sum);
    } else {
      v->kind = FieldValue::kVec;
      v->vec = vals;
    }
  }

  // one device's read of ``fids`` into ``out`` (NvmlBackend.read_fields),
  // with ``extra`` asked in the same field-values request, whose samples
  // land in ``fv_out``
  void read(Device& d, const std::vector<int>& fids, const Ask& extra,
            std::vector<FieldValue>* out, FieldValues* fv_out) {
    nvmlDevice_t h = d.handle;
    Ask ask = field_request(d, fids);
    ask.insert(ask.end(), extra.begin(), extra.end());
    FieldValues fv = field_values(d, ask);
    // memos of one read
    bool have_util = false, util_ok = false;
    nvmlUtilization_t util;
    bool have_mem = false, mem_ok = false;
    nvmlMemory_v2_t mem;
    bool have_rows = false, rows_ok = false;
    unsigned rows[4] = {0, 0, 0, 0};
    bool have_links = false;
    std::vector<std::pair<unsigned, bool>> lk;
    std::map<std::pair<unsigned, int>, double> link_err;
    std::map<std::pair<unsigned, unsigned>, double> rate_memo;

    auto get_links = [&]() -> const std::vector<std::pair<unsigned, bool>>& {
      if (!have_links) {
        have_links = true;
        for (auto& [k, s] : fv) {
          if (k.first != NVML_FI_DEV_NVLINK_GET_STATE) continue;
          double st = 0;
          bool ok = value_of(s, &st);
          lk.emplace_back(k.second, ok && st == NVML_FEATURE_ENABLED);
        }
        if (lk.empty()) {
          lk = links(d);
        } else {
          std::vector<unsigned> ids;
          for (auto& l : lk) ids.push_back(l.first);
          learn_links(d, ids);
        }
      }
      return lk;
    };
    auto error_of = [&](unsigned link, int counter) {
      auto k = std::make_pair(link, counter);
      auto it = link_err.find(k);
      if (it != link_err.end()) return it->second;
      unsigned long long n = 0;
      double v = call(fn_.link_error,
                      key("nvmlDeviceGetNvLinkErrorCounter", h, link, counter),
                      h, link, counter, &n)
                     ? static_cast<double>(n)
                     : NAN;
      link_err[k] = v;
      return v;
    };
    auto rate_of = [&](unsigned link, unsigned f) {
      auto k = std::make_pair(link, f);
      auto it = rate_memo.find(k);
      if (it != rate_memo.end()) return it->second;
      double v = link_rate(d, link, f, fv);
      rate_memo[k] = v;
      return v;
    };
    auto ull_call = [&](auto fn, const std::string& k, auto... args) {
      unsigned long long n = 0;
      return call(fn, k, h, args..., &n) ? static_cast<double>(n) : NAN;
    };

    for (size_t i = 0; i < fids.size(); i++) {
      int fid = fids[i];
      FieldValue* v = &(*out)[i];
      double x = 0;
      if (fid == kTcClock) {
        if (uint_call(fn_.clock, "nvmlDeviceGetClockInfo", h, NVML_CLOCK_SM,
                      &x))
          set_num(v, x);
      } else if (fid == kHbmClock) {
        if (uint_call(fn_.clock, "nvmlDeviceGetClockInfo", h,
                      NVML_CLOCK_MEM, &x))
          set_num(v, x);
      } else if (fid == kHbmTemp) {
        if (value_of(fv, NVML_FI_DEV_MEMORY_TEMP, 0, &x))
          set_num(v, std::trunc(x));
      } else if (fid == kCoreTemp) {
        if (uint_call(fn_.temperature, "nvmlDeviceGetTemperature", h,
                      NVML_TEMPERATURE_GPU, &x))
          set_num(v, x);
      } else if (fid == kPower) {
        if (uint_call(fn_.power, "nvmlDeviceGetPowerUsage", h, &x))
          set_num(v, x / 1000.0);
      } else if (fid == kEnergy) {
        // field 83; where the request did not serve it, the old entry
        // point (NOT_SUPPORTED there is asked once too)
        if (value_of(fv, NVML_FI_DEV_TOTAL_ENERGY_CONSUMPTION, 0, &x)) {
          set_num(v, std::trunc(x));
        } else {
          x = ull_call(fn_.energy,
                       key("nvmlDeviceGetTotalEnergyConsumption", h));
          if (!std::isnan(x)) set_num(v, x);
        }
      } else if (fid == kPcieTx || fid == kPcieRx) {
        if (uint_call(fn_.pcie_throughput, "nvmlDeviceGetPcieThroughput", h,
                      fid == kPcieTx ? NVML_PCIE_UTIL_TX_BYTES
                                     : NVML_PCIE_UTIL_RX_BYTES,
                      &x))
          set_num(v, x);
      } else if (fid == kPcieReplay) {
        if (uint_call(fn_.pcie_replay, "nvmlDeviceGetPcieReplayCounter", h,
                      &x))
          set_num(v, x);
      } else if (fid == kTcUtil || fid == kHbmBwUtil) {
        if (!have_util) {
          have_util = true;
          std::memset(&util, 0, sizeof(util));
          util_ok = call(fn_.utilization,
                         key("nvmlDeviceGetUtilizationRates", h), h, &util);
        }
        if (util_ok) set_num(v, fid == kTcUtil ? util.gpu : util.memory);
      } else if (fid >= kPowerViol && fid <= kReliabilityViol) {
        if (value_of(fv, violation_field(fid), 0, &x)) {
          long long ns = static_cast<long long>(x);
          long long us = ns / 1000 - ((ns % 1000 != 0 && ns < 0) ? 1 : 0);
          set_num(v, static_cast<double>(us));
        }
      } else if (fid == kHbmTotal || fid == kHbmUsed || fid == kHbmFree) {
        if (!have_mem) {
          have_mem = true;
          mem_ok = memory(h, &mem);
        }
        if (mem_ok) {
          unsigned long long b = fid == kHbmTotal  ? mem.total
                                 : fid == kHbmUsed ? mem.used
                                                   : mem.free;
          set_num(v, static_cast<double>(b / kMiB));
        }
      } else if (fid >= kEccSbeTotal && fid <= kEccDbeVol) {
        int err = (fid == kEccSbeTotal || fid == kEccSbeVol)
                      ? NVML_MEMORY_ERROR_TYPE_CORRECTED
                      : NVML_MEMORY_ERROR_TYPE_UNCORRECTED;
        int counter = fid <= kEccDbeTotal ? NVML_AGGREGATE_ECC
                                          : NVML_VOLATILE_ECC;
        x = ull_call(fn_.ecc, key("nvmlDeviceGetTotalEccErrors", h, err,
                                  counter),
                     err, counter);
        if (!std::isnan(x)) set_num(v, x);
      } else if (fid >= kRemapSbe && fid <= kRemapPending) {
        if (!have_rows) {
          have_rows = true;
          rows_ok = call(fn_.remapped, key("nvmlDeviceGetRemappedRows", h),
                         h, &rows[0], &rows[1], &rows[2], &rows[3]);
        }
        if (rows_ok) set_num(v, rows[fid - kRemapSbe]);
      } else if (fid == kLinkCrcTotal || fid == kLinkRecoveryTotal ||
                 fid == kLinkReplayTotal || fid == kLinkCrc) {
        int counter = fid == kLinkRecoveryTotal  ? NVML_NVLINK_ERROR_DL_RECOVERY
                      : fid == kLinkReplayTotal ? NVML_NVLINK_ERROR_DL_REPLAY
                                                : NVML_NVLINK_ERROR_DL_CRC_FLIT;
        std::vector<double> per;
        for (auto& l : get_links()) per.push_back(error_of(l.first, counter));
        set_links(v, per, fid != kLinkCrc);
      } else if (fid == kLinksUp) {
        const auto& ls = get_links();
        if (!ls.empty()) {
          double up = 0;
          for (auto& l : ls) up += l.second ? 1 : 0;
          set_num(v, up);
        }
      } else if (fid == kLinkState) {
        const auto& ls = get_links();
        if (!ls.empty()) {
          v->kind = FieldValue::kVec;
          for (auto& l : ls) v->vec.push_back(l.second ? 1 : 0);
        }
      } else if (unsigned rf = rate_field(fid)) {
        std::vector<double> per;
        for (auto& l : get_links()) per.push_back(rate_of(l.first, rf));
        set_links(v, per, fid == kLinkTxTotal || fid == kLinkRxTotal);
      } else if (fid == kName || fid == kUuid || fid == kFirmware) {
        const Info& info = info_of(d);
        const std::string& s = fid == kName   ? info.name
                               : fid == kUuid ? info.uuid
                                              : info.firmware;
        if (!s.empty()) {
          v->kind = FieldValue::kStr;
          v->str = s;
        }
      }
      // anything unmatched stays blank (nil convention)
    }
    if (fv_out) *fv_out = std::move(fv);
  }

  // -- events -----------------------------------------------------------------

  void start_event_sources() {
    std::set<int> covered;
    nvmlEventSet_t es = nullptr;
    if (fn_.event_wait &&
        call(fn_.event_create, key("nvmlEventSetCreate", nullptr), &es)) {
      event_set_ = es;
      for (auto& d : devices_)
        if (call(fn_.event_register,
                 key("nvmlDeviceRegisterEvents", d->handle,
                     static_cast<long long>(nvmlEventTypeXidCriticalError)),
                 d->handle,
                 static_cast<unsigned long long>(nvmlEventTypeXidCriticalError),
                 es))
          covered.insert(d->index);
    }
    xid_covered_ = covered;
    event_stop_ = false;
    if (!covered.empty())
      event_thread_ = std::thread([this] { event_loop(); });
    kmsg_.reset(new KmsgTailer(
        [this](int chip, int etype, double ts, const std::string& msg) {
          // the event set delivers an Xid of a device it covers
          if (xid_covered_.count(chip) && kmsg_is_xid_line(msg)) return;
          append_event(chip, etype, ts, msg);
        },
        kmsg_path_, bus_index()));
    if (!kmsg_->start()) kmsg_.reset();  // no kernel log: the event set only
  }

  void event_loop() {
    std::map<nvmlDevice_t, int> by_handle;
    for (auto& d : devices_) by_handle[d->handle] = d->index;
    while (!event_stop_) {
      nvmlEventData_t data;
      std::memset(&data, 0, sizeof(data));
      int rc = fn_.event_wait(event_set_, &data, kEventWaitMs);
      if (rc == NVML_ERROR_TIMEOUT) continue;
      if (rc != NVML_SUCCESS) {
        for (int i = 0; i < 50 && !event_stop_; i++) usleep(20 * 1000);
        continue;
      }
      if (!(data.eventType & nvmlEventTypeXidCriticalError)) continue;
      int etype = xid_event_type(data.eventData);
      if (etype == 0) continue;
      auto it = by_handle.find(data.device);
      append_event(it == by_handle.end() ? -1 : it->second, etype,
                   FakeSource::now(),
                   "Xid " + std::to_string(data.eventData));
    }
  }

  void append_event(int chip, int etype, double ts, const std::string& msg) {
    std::lock_guard<std::mutex> lock(events_mu_);
    AgentEvent e;
    e.etype = etype;
    e.timestamp = ts;
    e.seq = ++next_seq_;
    e.chip_index = chip;
    e.message = msg;
    events_.push_back(std::move(e));
    trim_events_locked(&events_);
  }

  static constexpr unsigned long long kMiB = 1024ULL * 1024ULL;

  std::string kmsg_path_;
  std::string error_;
  void* lib_ = nullptr;
  Fns fn_;
  bool opened_ = false;
  std::string driver_;
  std::vector<std::unique_ptr<Device>> devices_;
  // calls and (field, scope) pairs NVML answered NOT_SUPPORTED, device
  // records, link ids and counters
  std::mutex state_mu_;
  std::set<std::string> unsupported_;
  // events
  std::mutex events_mu_;
  std::vector<AgentEvent> events_;
  long long next_seq_ = 0;
  nvmlEventSet_t event_set_ = nullptr;
  std::set<int> xid_covered_;
  std::atomic<bool> event_stop_{false};
  std::thread event_thread_;
  std::unique_ptr<KmsgTailer> kmsg_;
};

}  // namespace tpumon
