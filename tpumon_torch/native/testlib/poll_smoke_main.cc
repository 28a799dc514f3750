// poll_smoke_main.cc — threaded smoke of the native poll plane
// (poll/engine.hpp) for the sanitizer gate.
//
// The binding releases the GIL for the whole fleet tick, so the
// engine genuinely runs concurrently with (a) the agent processes at
// the far end of every socket and (b) other Python threads that may
// touch the SAME PollEngine between ticks (metrics scrapes calling
// host_tick_bytes, raw_snapshots calling materialize).  This harness
// reproduces that shape without Python:
//
//   * four fake-agent threads serve the real wire protocol (hello
//     line, sweep_frame probe, binary frames built with the shared
//     EncoderCore, a JSON-only oracle agent) over AF_UNIX sockets,
//     with mid-frame split writes and kill-after-reply faults so the
//     engine's reassembly and in-tick retry paths run under TSan;
//   * the engine thread drives ticks under the binding's discipline —
//     a mutex standing in for the GIL, held around the control-plane
//     push/drain sections and RELEASED around tick();
//   * a control thread plays the second Python thread: under the
//     mutex it honours the busy flag (exactly what the binding's
//     RuntimeError enforces) and otherwise reads host_connected /
//     host_tick_bytes / host_decoder()->mirror_entries() between
//     ticks.
//
// Built plain and, with -fsanitize=thread, on request
// (tests/test_torch_fleet_native.py, TPUMON_RUN_SANITIZERS=1); any hidden
// shared state is a report, and a report is a failing exit.

#include <sys/socket.h>
#include <sys/un.h>
#include <unistd.h>

#include <atomic>
#include <cstdio>
#include <cstring>
#include <map>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include "core.hpp"
#include "engine.hpp"

namespace nc = tpumon::codec;
namespace np = tpumon::poll;

namespace {

constexpr int kAgents = 4;
constexpr int kChips = 4;
constexpr int kTicks = 60;
constexpr long long kFids[7] = {100, 101, 102, 103, 104, 105, 106};

std::atomic<bool> g_done{false};

// the GIL stand-in: held around every control-plane engine call,
// released around tick() — the exact hand-off the binding performs
std::mutex g_gil;
bool g_busy = false;  // guarded by g_gil (the binding's busy flag)

unsigned next_rng(unsigned* rng) {
  *rng = *rng * 1103515245u + 12345u;
  return (*rng >> 16) & 0x7FFF;
}

bool send_all(int fd, const char* p, size_t n) {
  while (n > 0) {
    ssize_t w = send(fd, p, n, MSG_NOSIGNAL);
    if (w <= 0) return false;
    p += w;
    n -= static_cast<size_t>(w);
  }
  return true;
}

// one fake agent: values model persists across reconnects (like a
// real daemon), the encoder is per-connection (fresh delta tables on
// both sides after a dial, mirroring the engine's fresh DecoderCore)
struct FakeAgent {
  int listen_fd = -1;
  bool json_only = false;
  std::map<long long, std::map<long long, long long>> values;
  unsigned rng = 1;
  int step = 0;

  void init_values() {
    for (long long c = 0; c < kChips; c++)
      for (long long f : kFids) values[c][f] = next_rng(&rng);
  }

  bool reply_frame(int fd, nc::EncoderCore* enc, int* failures) {
    step++;
    if (step % 3 != 0) {
      long long c = next_rng(&rng) % kChips;
      long long f = kFids[next_rng(&rng) % 7];
      values[c][f] = next_rng(&rng);
    }
    std::vector<nc::PendChip> pending;
    std::vector<nc::PendEntry> arena;
    for (auto& [cidx, fields] : values) {
      nc::PendChip pc;
      pc.idx = cidx;
      pc.begin = arena.size();
      for (auto& [fid, v] : fields) {
        arena.emplace_back();
        nc::PendEntry& e = arena.back();
        e.fid = fid;
        e.v.kind = nc::NValue::kInt;
        e.v.i = v;
      }
      pc.end = arena.size();
      pending.push_back(pc);
    }
    std::string frame;
    std::vector<void*> released;
    enc->encode(&pending, &arena, false, std::string(), &frame, &released);
    if (!released.empty()) {
      // no binding above us: cookies are never set, nothing may queue
      *failures += 1;
      return false;
    }
    if (step % 5 == 0 && frame.size() > 8) {
      // mid-frame split: the engine must reassemble across reads
      size_t half = frame.size() / 2;
      if (!send_all(fd, frame.data(), half)) return false;
      usleep(2000);
      return send_all(fd, frame.data() + half, frame.size() - half);
    }
    return send_all(fd, frame.data(), frame.size());
  }

  // returns message length consumed from buf, 0 if incomplete,
  // negative on protocol error
  long parse_msg(const std::string& buf, std::string* line,
                 bool* binary_req) {
    *binary_req = false;
    unsigned char lead = static_cast<unsigned char>(buf[0]);
    if (lead == 0xA6) {  // pre-encoded sweep request from the poller
      unsigned long long len = 0;
      int shift = 0;
      size_t pos = 1;
      while (true) {
        if (pos >= buf.size()) return 0;
        unsigned char b = static_cast<unsigned char>(buf[pos]);
        pos++;
        len |= static_cast<unsigned long long>(b & 0x7F) << shift;
        if (!(b & 0x80)) break;
        shift += 7;
        if (shift > 63) return -1;
      }
      if (pos + len > buf.size()) return 0;
      *binary_req = true;
      return static_cast<long>(pos + len);
    }
    if (lead == '{') {
      size_t nl = buf.find('\n');
      if (nl == std::string::npos) return 0;
      line->assign(buf, 0, nl + 1);
      return static_cast<long>(nl + 1);
    }
    return -1;
  }

  void serve_conn(int fd, int* failures) {
    nc::EncoderCore enc(0);
    std::string buf;
    char tmp[4096];
    char num[64];
    for (;;) {
      while (!buf.empty()) {
        std::string line;
        bool binary_req = false;
        long used = parse_msg(buf, &line, &binary_req);
        if (used < 0) {
          *failures += 1;
          return;
        }
        if (used == 0) break;
        buf.erase(0, static_cast<size_t>(used));
        if (binary_req ||
            line.find("\"op\":\"sweep_frame\"") != std::string::npos) {
          if (json_only) {
            const char* r = "{\"ok\":false,\"error\":\"unknown op\"}\n";
            if (!send_all(fd, r, strlen(r))) return;
          } else if (!reply_frame(fd, &enc, failures)) {
            return;
          }
        } else if (line.find("\"op\":\"hello\"") != std::string::npos) {
          snprintf(num, sizeof(num),
                   "{\"ok\":true,\"chip_count\":%d}\n", kChips);
          if (!send_all(fd, num, strlen(num))) return;
        } else if (line.find("\"op\":\"read_fields_bulk\"") !=
                   std::string::npos) {
          const char* r =
              "{\"ok\":true,\"chips\":{\"0\":{\"100\":1},\"1\":{\"100\":2}"
              ",\"2\":{\"100\":3},\"3\":{\"100\":4}}}\n";
          if (!send_all(fd, r, strlen(r))) return;
        } else {
          *failures += 1;
          return;
        }
        if (step > 0 && step % 9 == 0) {
          // kill-after-reply: the engine's next sweep on this kept
          // connection hits EOF and must retry with a fresh dial
          step++;
          return;
        }
      }
      ssize_t n = recv(fd, tmp, sizeof(tmp), 0);
      if (n <= 0) return;
      buf.append(tmp, static_cast<size_t>(n));
    }
  }

  void run(int* failures) {
    for (;;) {
      int fd = accept(listen_fd, nullptr, nullptr);
      if (fd < 0) return;  // listen socket closed: shutdown
      serve_conn(fd, failures);
      close(fd);
    }
  }
};

void engine_thread(np::Engine* eng, size_t nhosts, const std::string& req,
                   int* failures, long long* records, long long* hellos) {
  for (int t = 0; t < kTicks; t++) {
    std::vector<uint8_t> skip(nhosts, 0);
    {
      std::lock_guard<std::mutex> g(g_gil);
      for (size_t i = 0; i < nhosts; i++) {
        eng->set_events_since(i, 0);
        eng->set_request(i, req.data(), req.size());
      }
      if (t % 7 == 3) skip[static_cast<size_t>(t) % nhosts] = 1;
      g_busy = true;
    }
    eng->tick(2.0, skip);  // the GIL-released region
    {
      std::lock_guard<std::mutex> g(g_gil);
      g_busy = false;
      for (const auto& r : eng->results()) {
        if (r.stage >= np::ERR_CONNECT) {
          fprintf(stderr, "tick %d host %d stage %d err %d detail %s\n", t,
                  r.host, r.stage, r.err, r.detail.c_str());
          *failures += 1;
        }
        *records += 1;
      }
      *hellos += eng->hello_count();
      if (!eng->released().empty()) *failures += 1;  // no cookies here
    }
    usleep(1000);  // the poll interval: the window control calls get
  }
}

void control_thread(np::Engine* eng, size_t nhosts, long long* reads) {
  // the second Python thread: only touches the engine under the GIL
  // stand-in AND only when the busy flag says no tick is in flight —
  // the binding turns the busy case into a RuntimeError, never a race
  while (!g_done.load(std::memory_order_acquire)) {
    {
      std::lock_guard<std::mutex> g(g_gil);
      if (!g_busy) {
        for (size_t i = 0; i < nhosts; i++) {
          if (eng->host_connected(i)) *reads += eng->host_tick_bytes(i);
          nc::DecoderCore* d = eng->host_decoder(i);
          if (d != nullptr)
            *reads += static_cast<long long>(d->mirror_entries());
        }
      }
    }
    usleep(500);
  }
}

}  // namespace

int main() {
  std::string path[kAgents];
  FakeAgent agents[kAgents];
  for (int i = 0; i < kAgents; i++) {
    path[i] = "/tmp/tpumon-poll-smoke-" +
              std::to_string(static_cast<int>(getpid())) + "-" +
              std::to_string(i) + ".sock";
    unlink(path[i].c_str());
    int fd = socket(AF_UNIX, SOCK_STREAM | SOCK_CLOEXEC, 0);
    if (fd < 0) {
      perror("socket");
      return 2;
    }
    sockaddr_un sa;
    memset(&sa, 0, sizeof(sa));
    sa.sun_family = AF_UNIX;
    if (path[i].size() + 1 > sizeof(sa.sun_path)) return 2;
    memcpy(sa.sun_path, path[i].c_str(), path[i].size() + 1);
    if (bind(fd, reinterpret_cast<sockaddr*>(&sa), sizeof(sa)) != 0 ||
        listen(fd, 8) != 0) {
      perror("bind/listen");
      return 2;
    }
    agents[i].listen_fd = fd;
    agents[i].json_only = (i == kAgents - 1);  // one old JSON-only agent
    agents[i].rng = static_cast<unsigned>(i + 1);
    agents[i].init_values();
  }

  std::string frag = "\"fields\":[100,101,102,103,104,105,106]";
  std::vector<unsigned long long> fields;
  for (long long f : kFids) fields.push_back(static_cast<unsigned long long>(f));
  np::Engine eng(
      "{\"op\":\"hello\",\"client\":\"poll-smoke\",\"version\":\"0.1.0\"}\n",
      frag, fields, kFids, /*lazy=*/true);
  if (!eng.ok()) {
    fprintf(stderr, "epoll_create1 failed\n");
    return 2;
  }
  for (int i = 0; i < kAgents; i++) eng.add_unix(path[i]);

  // a dummy pre-encoded sweep request (0xA6 + varint length + body):
  // the engine treats Python's req_bytes as opaque, the fake agents
  // parse the same framing
  std::string req;
  req.push_back(static_cast<char>(0xA6));
  req.push_back(static_cast<char>(9));
  req += "sweep-req";

  int agent_failures[kAgents] = {0};
  int eng_failures = 0;
  long long records = 0;
  long long hellos = 0;
  long long control_reads = 0;

  std::vector<std::thread> threads;
  for (int i = 0; i < kAgents; i++)
    threads.emplace_back([&, i] { agents[i].run(&agent_failures[i]); });
  std::thread ctl(control_thread, &eng, static_cast<size_t>(kAgents),
                  &control_reads);
  std::thread drv(engine_thread, &eng, static_cast<size_t>(kAgents), req,
                  &eng_failures, &records, &hellos);

  drv.join();
  g_done.store(true, std::memory_order_release);
  ctl.join();
  {
    std::lock_guard<std::mutex> g(g_gil);
    eng.close_all();
  }
  for (int i = 0; i < kAgents; i++) {
    shutdown(agents[i].listen_fd, SHUT_RDWR);
    close(agents[i].listen_fd);
  }
  for (int i = 0; i < kAgents; i++) threads[i].join();
  for (int i = 0; i < kAgents; i++) unlink(path[i].c_str());

  int failures = eng_failures;
  for (int i = 0; i < kAgents; i++) failures += agent_failures[i];
  // every tick must have produced activity: hellos on dial, OK
  // records on churn ticks, JSON records from the pinned agent
  if (hellos == 0 || records < kTicks || control_reads == 0) {
    fprintf(stderr, "thin run: hellos=%lld records=%lld reads=%lld\n",
            hellos, records, control_reads);
    failures += 1;
  }
  if (failures != 0) {
    fprintf(stderr, "FAIL: %d failures (records=%lld hellos=%lld)\n",
            failures, records, hellos);
    return 1;
  }
  printf("OK records=%lld hellos=%lld control_reads=%lld\n", records, hellos,
         control_reads);
  return 0;
}
