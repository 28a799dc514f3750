// kmsg.hpp — kernel-log event tailer for the gpu-hostengine daemon.
//
// C++ sibling of tpumon_torch/kmsg.py (one classifier, one record
// format; tests/test_torch_native_agent.py pins the two to one corpus
// through testlib/kmsg_classify_main.cc): tails /dev/kmsg (or a fixture
// via --kmsg / TPUMON_KMSG_PATH) and feeds the NVIDIA driver's Xid lines,
// and AER/PCIe error lines about a GPU's bus, to the NVML source's event
// stream.
//
// The reference agent's tailer, with the classifier of the port: an Xid
// line is classified by its code alone, by the table of codes NVIDIA's
// Xid catalog gives a clear meaning (kmsg.py XID_EVENTS); an unknown code
// is no event, never a guess.  The patterns are kmsg.py's regular
// expressions, unchanged.

#pragma once

#include <errno.h>
#include <fcntl.h>
#include <unistd.h>

#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdlib>
#include <functional>
#include <map>
#include <mutex>
#include <regex>
#include <string>
#include <thread>
#include <tuple>

namespace tpumon {

// event type values mirror tpumon_torch/events.py EventType
enum KmsgEventType {
  kKmsgChipReset = 1,
  kKmsgEccDbe = 3,
  kKmsgEccSbeStorm = 4,
  kKmsgHbmRemap = 5,
  kKmsgPcieError = 8,
  kKmsgIciError = 9,
};

// Xid code -> event type (kmsg.py XID_EVENTS): 48 DBE ECC error; 63, 64
// row remapping recorded / failed; 74 NVLink error; 79 fallen off the
// bus; 92 high single-bit ECC error rate.  0 = no event.
inline int xid_event_type(unsigned long long xid) {
  switch (xid) {
    case 48: return kKmsgEccDbe;
    case 63: case 64: return kKmsgHbmRemap;
    case 74: return kKmsgIciError;
    case 79: return kKmsgChipReset;
    case 92: return kKmsgEccSbeStorm;
    default: return 0;
  }
}

// (PCI domain, bus, device) of a GPU: what a kmsg line's bus id and
// NVML's busId both reduce to
using BusKey = std::tuple<long long, int, int>;
using BusMap = std::map<BusKey, int>;

namespace kmsg_detail {

inline const std::regex& xid_re() {
  static const std::regex re(
      "NVRM: Xid \\(PCI:([0-9a-fA-F]+:[0-9a-fA-F]+:[0-9a-fA-F]+)[^)]*\\): "
      "(\\d+)");
  return re;
}
inline const std::regex& pcie_re() {
  static const std::regex re("AER|PCIe.{0,24}(error|replay|timeout)",
                             std::regex::icase);
  return re;
}
inline const std::regex& bus_re() {
  static const std::regex re(
      "\\b([0-9a-fA-F]{4,8}):([0-9a-fA-F]{2}):([0-9a-fA-F]{2})"
      "(?:\\.[0-7])?\\b");
  return re;
}
inline const std::regex& nvidia_dev_re() {
  static const std::regex re(
      "\\bnvidia ([0-9a-fA-F]{4,8}:[0-9a-fA-F]{2}:[0-9a-fA-F]{2})");
  return re;
}

inline BusKey key_of(const std::smatch& m) {
  return BusKey(std::strtoll(m.str(1).c_str(), nullptr, 16),
                static_cast<int>(std::strtol(m.str(2).c_str(), nullptr, 16)),
                static_cast<int>(std::strtol(m.str(3).c_str(), nullptr, 16)));
}

}  // namespace kmsg_detail

// the bus key of a PCI bus id such as 0000:3b:00, 0000:3b:00.0 or NVML's
// 00000000:3B:00.0; false if the text holds none (kmsg.py bus_key)
inline bool kmsg_bus_key(const std::string& bus_id, BusKey* out) {
  std::smatch m;
  if (!std::regex_search(bus_id, m, kmsg_detail::bus_re())) return false;
  *out = kmsg_detail::key_of(m);
  return true;
}

inline bool kmsg_is_xid_line(const std::string& message) {
  return std::regex_search(message, kmsg_detail::xid_re());
}

// message text of one kmsg record ("prio,seq,usec,flags;message");
// empty string for continuation/garbage lines
inline std::string kmsg_record_message(const std::string& line) {
  if (line.empty() || line[0] == ' ') return "";
  size_t semi = line.find(';');
  if (semi == std::string::npos) return "";
  return line.substr(semi + 1);
}

// classify a message (kmsg.py classify_line): returns the event type
// (>0) and sets *chip to the index ``buses`` gives its bus, or -1; 0 when
// the line is no event
inline int kmsg_classify(const std::string& message, const BusMap& buses,
                         int* chip) {
  *chip = -1;
  std::smatch m;
  if (std::regex_search(message, m, kmsg_detail::xid_re())) {
    const std::string code = m.str(2);
    // a code too long for the table's range is no code of the table
    unsigned long long xid = code.size() > 9
                                 ? 0
                                 : std::strtoull(code.c_str(), nullptr, 10);
    int etype = xid_event_type(xid);
    if (etype == 0) return 0;
    BusKey key;
    if (kmsg_bus_key(m.str(1), &key)) {
      auto it = buses.find(key);
      if (it != buses.end()) *chip = it->second;
    }
    return etype;
  }
  if (!std::regex_search(message, kmsg_detail::pcie_re())) return 0;
  for (std::sregex_iterator it(message.begin(), message.end(),
                               kmsg_detail::bus_re()),
       end;
       it != end; ++it) {
    auto hit = buses.find(kmsg_detail::key_of(*it));
    if (hit != buses.end()) {
      *chip = hit->second;
      return kKmsgPcieError;
    }
  }
  if (std::regex_search(message, kmsg_detail::nvidia_dev_re()))
    return kKmsgPcieError;
  return 0;
}

class KmsgTailer {
 public:
  using Sink = std::function<void(int chip, int etype, double ts,
                                  const std::string& msg)>;

  KmsgTailer(Sink sink, std::string path, BusMap buses)
      : sink_(std::move(sink)), path_(std::move(path)),
        buses_(std::move(buses)) {}

  ~KmsgTailer() { stop(); }

  // false when the path cannot be read (the tailer stays off).  Returns
  // once the first open has seeked to the end (or after 2 s), so a record
  // appended after start() is never raced past by that seek.
  bool start() {
    int fd = open(path_.c_str(), O_RDONLY | O_NONBLOCK);
    if (fd < 0) return false;
    close(fd);
    running_ = true;
    thread_ = std::thread([this]() { run(); });
    std::unique_lock<std::mutex> lk(ready_mu_);
    ready_cv_.wait_for(lk, std::chrono::seconds(2), [this] { return ready_; });
    return true;
  }

  void stop() {
    running_ = false;
    if (thread_.joinable()) thread_.join();
  }

 private:
  static double now_s() {
    struct timespec ts;
    clock_gettime(CLOCK_REALTIME, &ts);
    return static_cast<double>(ts.tv_sec) +
           static_cast<double>(ts.tv_nsec) / 1e9;
  }

  void run() {
    while (running_) {
      int fd = open(path_.c_str(), O_RDONLY | O_NONBLOCK);
      if (fd < 0) {
        for (int i = 0; i < 50 && running_; i++) usleep(20 * 1000);
        continue;
      }
      // every open (first and error-triggered re-open) starts at the end:
      // replaying history would duplicate delivered events and stamp
      // boot-time records with now_s(), falsely tripping health/policy
      lseek(fd, 0, SEEK_END);
      {
        std::lock_guard<std::mutex> g(ready_mu_);
        ready_ = true;
      }
      ready_cv_.notify_all();
      pump(fd);
      close(fd);
      usleep(50 * 1000);
    }
  }

  void pump(int fd) {
    std::string buf;
    char chunk[4096];
    while (running_) {
      ssize_t n = read(fd, chunk, sizeof(chunk));
      if (n < 0) {
        if (errno == EPIPE) continue;  // ring overrun: records lost, go on
        if (errno == EAGAIN) {
          idle();
          continue;
        }
        return;  // unexpected: reopen from run()
      }
      if (n == 0) {  // EOF (fixture file): poll for appends
        idle();
        continue;
      }
      buf.append(chunk, static_cast<size_t>(n));
      size_t nl;
      while ((nl = buf.find('\n')) != std::string::npos) {
        handle(buf.substr(0, nl));
        buf.erase(0, nl + 1);
      }
    }
  }

  // the wait between empty reads: kmsg.py's poll interval (0.2 s; one
  // wake-up, which costs host CPU, a wait)
  void idle() { usleep(200 * 1000); }

  void handle(const std::string& line) {
    std::string msg = kmsg_record_message(line);
    if (msg.empty()) return;
    int chip = -1;
    int etype = kmsg_classify(msg, buses_, &chip);
    if (etype == 0) return;
    sink_(chip, etype, now_s(), msg);
  }

  Sink sink_;
  std::string path_;
  BusMap buses_;
  std::atomic<bool> running_{false};
  std::thread thread_;
  std::mutex ready_mu_;
  std::condition_variable ready_cv_;
  bool ready_ = false;
};

}  // namespace tpumon
