// gpu-hostengine — native per-host GPU metrics agent.
//
// The nv-hostengine analog (reference bindings/go/dcgm/admin.go:26-30 run
// modes; exporters talk to the daemon, never the devices): one daemon per
// GPU host owns discovery + metric reads and serves any number of monitor
// clients over a unix domain socket or TCP, so cards are observed once no
// matter how many consumers attach.  The port of the reference's
// tpu-hostengine, flag for flag and op for op; the Python agent
// (python -m tpumon_torch.hostengine) answers alike.
//
// Wire protocol: newline-delimited JSON and binary sweep frames (see
// protocol.md and the Python client tpumon_torch/backends/agent.py).  One
// request per line, one response per line, thread per connection.
//
// Sources: NVML (nvml_source.hpp) or the reference agent's deterministic
// fake (--fake / TPUMON_AGENT_FAKE=1), so the whole standalone mode is
// testable on CPU-only hosts.  Without NVML's library on the host the
// agent serves --merge-textfile drop files alone (merge-only mode), or
// exits 3; an NVML that loads and fails, or sees no device, exits 3.

#include <arpa/inet.h>
#include <dirent.h>
#include <fcntl.h>
#include <glob.h>
#include <netinet/in.h>
#include <poll.h>
#include <signal.h>
#include <sys/socket.h>
#include <sys/stat.h>
#include <sys/un.h>
#include <unistd.h>

#include <algorithm>
#include <array>
#include <atomic>
#include <charconv>
#include <condition_variable>
#include <cstdarg>
#include <cstdio>
#include <cstring>
#include <map>
#include <memory>
#include <mutex>
#include <set>
#include <string>
#include <thread>
#include <vector>

#include <climits>

#include "json.hpp"
#include "kmsg.hpp"
#include "kubelet.hpp"
#include "nvml_source.hpp"
#include "sampler.hpp"
#include "source.hpp"
#include "wire.hpp"

namespace tpumon {

#include "catalog.inc"

static const char* kAgentVersion = "gpu-hostengine 0.1.0";
static std::atomic<bool> g_shutdown{false};
// the shutdown wake-up: one byte written (never read) makes this pipe
// readable for every listener blocked in poll(2), so no accept loop
// polls on a timer (each timed wake-up costs host CPU at idle)
static int g_wake[2] = {-1, -1};

static void request_shutdown() {
  g_shutdown = true;
  if (g_wake[1] >= 0) (void)!write(g_wake[1], "x", 1);
}

// block until ``fd`` is readable (true) or shutdown was requested
static bool wait_readable(int fd) {
  while (!g_shutdown) {
    struct pollfd p[2] = {{fd, POLLIN, 0}, {g_wake[0], POLLIN, 0}};
    int n = poll(p, 2, -1);
    if (n < 0 && errno != EINTR) return false;
    if (n > 0 && (p[1].revents & POLLIN)) return false;
    if (n > 0 && (p[0].revents & (POLLIN | POLLERR | POLLHUP))) return true;
  }
  return false;
}
static std::atomic<long long> g_requests{0};
static std::string g_socket_path;

// binary sweep_frame framing (keep in sync with tpumon_torch/sweepframe.py):
// lead bytes chosen to never collide with '{', so the connection loop
// can frame-switch between JSON lines and binary frames on byte one
static const uint8_t kSweepReqMagic = 0xA6;
static const uint8_t kSweepFrameMagic = 0xA9;

// ---- introspection (hostengine_status.go analog) ---------------------------

static bool read_self_stat(double* cpu_s, double* rss_kb) {
  FILE* f = fopen("/proc/self/stat", "re");
  if (!f) return false;
  char buf[1024];
  size_t n = fread(buf, 1, sizeof(buf) - 1, f);
  fclose(f);
  buf[n] = 0;
  const char* p = strrchr(buf, ')');
  if (!p) return false;
  p += 2;
  long long vals[22] = {0};
  int idx = 0;
  const char* q = p;
  while (idx < 22 && *q) {
    char* end = nullptr;
    long long v = strtoll(q, &end, 10);
    if (end == q) {  // non-numeric field (state char etc.)
      while (*q && *q != ' ') q++;
    } else {
      vals[idx] = v;
      q = end;
    }
    while (*q == ' ') q++;
    idx++;
  }
  long hz = sysconf(_SC_CLK_TCK);
  long page = sysconf(_SC_PAGE_SIZE);
  *cpu_s = static_cast<double>(vals[11] + vals[12]) / (hz > 0 ? hz : 100);
  *rss_kb = static_cast<double>(vals[21]) * (page > 0 ? page : 4096) / 1024.0;
  return true;
}

// ---- request dispatch ------------------------------------------------------

// glog-analog verbosity-gated logging (the reference pod exporter's -v
// levels, src/main.go:18-33).  --v N / TPUMON_AGENT_VERBOSITY=N; level 0
// lines are operational milestones, level 1 per-connection, level 2+
// per-request chatter.  Format: "I0730 05:43:12 gpu-hostengine] msg".
static int g_verbosity = 0;
static void vlogf(int level, char sev, const char* fmt, ...)
    __attribute__((format(printf, 3, 4)));
static void vlogf(int level, char sev, const char* fmt, ...) {
  if (g_verbosity < level) return;
  struct timespec ts;
  clock_gettime(CLOCK_REALTIME, &ts);
  struct tm tm;
  localtime_r(&ts.tv_sec, &tm);
  char prefix[64];
  snprintf(prefix, sizeof(prefix), "%c%02d%02d %02d:%02d:%02d gpu-hostengine] ",
           sev, tm.tm_mon + 1, tm.tm_mday, tm.tm_hour, tm.tm_min, tm.tm_sec);
  char body[512];
  va_list ap;
  va_start(ap, fmt);
  vsnprintf(body, sizeof(body), fmt, ap);
  va_end(ap);
  fprintf(stderr, "%s%s\n", prefix, body);
}

// CLOCK_MONOTONIC sibling of FakeSource::now() (which is intentionally
// wall-clock: sample timestamps are part of the wire protocol).  Intervals
// measured for internal policy (cache TTLs) must not be NTP-steppable.
static double mono_now() {
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return static_cast<double>(ts.tv_sec) +
         static_cast<double>(ts.tv_nsec) / 1e9;
}

// the --prom-port scrape's phase gauges, in the order they are served
// (tpumon_torch/hostengine.py SCRAPE_PHASES, line for line)
struct ScrapePhase {
  const char* name;
  const char* help;
};
static constexpr std::array<ScrapePhase, 5> kScrapePhases = {{
    {"tpumon_agent_scrape_wait_ms",
     "Accepted to the scrape lock taken, this scrape."},
    {"tpumon_agent_scrape_collect_ms",
     "Burst harvest, watch cache and live reads of this scrape."},
    {"tpumon_agent_scrape_render_ms",
     "Catalog+self formatting time of this scrape, the collect excluded."},
    {"tpumon_agent_scrape_merge_ms", "Drop-file merge time of this scrape."},
    {"tpumon_agent_scrape_write_ms",
     "Socket write of the previous /metrics response."},
}};

// ---- Prometheus numbers ------------------------------------------------------
// A sample's value as the port's renderer prints it
// (tpumon_torch/exporter/promtext.py format_value over the agent's number
// convention): an integral value below 9e15 as an integer, any other as
// Python's repr of the double (shortest round-trip digits, fixed notation
// for a decimal point between 1e-4 and 1e16, else d.ddde+XX).

static std::string py_repr(double v) {
  if (std::isnan(v)) return "nan";
  if (std::isinf(v)) return v < 0 ? "-inf" : "inf";
  char buf[64];
  auto r = std::to_chars(buf, buf + sizeof(buf), v,
                         std::chars_format::scientific);
  std::string s(buf, r.ptr);
  bool neg = s[0] == '-';
  if (neg) s.erase(0, 1);
  size_t e = s.find('e');
  int exp = atoi(s.c_str() + e + 1);
  std::string digits;
  for (size_t i = 0; i < e; i++)
    if (s[i] != '.') digits += s[i];
  int decpt = exp + 1;
  int nd = static_cast<int>(digits.size());
  std::string out;
  if (decpt > -4 && decpt <= 16) {
    if (decpt <= 0)
      out = "0." + std::string(static_cast<size_t>(-decpt), '0') + digits;
    else if (decpt >= nd)
      out = digits + std::string(static_cast<size_t>(decpt - nd), '0') + ".0";
    else
      out = digits.substr(0, static_cast<size_t>(decpt)) + "." +
            digits.substr(static_cast<size_t>(decpt));
  } else {
    out = digits.substr(0, 1);
    if (nd > 1) out += "." + digits.substr(1);
    char eb[16];
    snprintf(eb, sizeof(eb), "e%c%02d", exp < 0 ? '-' : '+',
             exp < 0 ? -exp : exp);
    out += eb;
  }
  return neg ? "-" + out : out;
}

static std::string prom_number(double v) {
  if (burst_dumps_as_int(v))
    return std::to_string(static_cast<long long>(v));
  return py_repr(v);
}

// ---- textfile merge (node-exporter textfile-collector role) ----------------
// Mirror of tpumon_torch/exporter/textmerge.py (TextfileMerge): fresh .prom
// files (a workload's embedded self-monitor output) merge into the
// scrape so measured in-process telemetry rides the zero-Python data
// plane too.  Per-line validation keeps a torn (non-atomic) write from
// poisoning the whole exposition.

// Validate one exposition sample line and extract its series identity
// (name + label set).  Quote-aware: label VALUES may legally contain
// '{'/'}'/spaces (only backslash, quote, newline are escaped), so the
// label set ends at the first UNQUOTED '}'.
static bool prom_parse_sample(const std::string& ln, std::string* sid) {
  size_t i = 0, n = ln.size();
  auto name_start = [](unsigned char c) {
    return isalpha(c) || c == '_' || c == ':';
  };
  auto name_char = [](unsigned char c) {
    return isalnum(c) || c == '_' || c == ':';
  };
  if (i >= n || !name_start(ln[i])) return false;
  while (i < n && name_char(ln[i])) i++;
  size_t sid_end = i;
  if (i < n && ln[i] == '{') {
    i++;
    bool in_q = false, esc = false;
    while (i < n) {
      char c = ln[i];
      if (esc) esc = false;
      else if (c == '\\') esc = true;
      else if (c == '"') in_q = !in_q;
      else if (c == '}' && !in_q) break;
      i++;
    }
    if (i >= n) return false;  // unterminated label set (torn write)
    i++;
    sid_end = i;
  }
  if (i >= n || (ln[i] != ' ' && ln[i] != '\t')) return false;
  while (i < n && (ln[i] == ' ' || ln[i] == '\t')) i++;
  if (i >= n) return false;
  size_t vstart = i;
  if (ln[i] == '+' || ln[i] == '-') i++;
  if (ln.compare(i, 3, "Inf") == 0 || ln.compare(i, 3, "NaN") == 0) {
    i += 3;
  } else {
    const char* s = ln.c_str() + vstart;
    char* end = nullptr;
    strtod(s, &end);
    if (end == s) return false;
    i = vstart + static_cast<size_t>(end - s);
  }
  if (i < n && ln[i] != ' ' && ln[i] != '\t') return false;
  while (i < n && (ln[i] == ' ' || ln[i] == '\t')) i++;
  if (i < n) {  // optional integer timestamp
    if (ln[i] == '+' || ln[i] == '-') i++;
    size_t d0 = i;
    while (i < n && isdigit(static_cast<unsigned char>(ln[i]))) i++;
    if (i == d0) return false;
    while (i < n && (ln[i] == ' ' || ln[i] == '\t')) i++;
    if (i < n) return false;
  }
  *sid = ln.substr(0, sid_end);
  return true;
}

class Server {
 public:
  Server(std::unique_ptr<MetricSource> source, bool allow_inject)
      : source_(std::move(source)), allow_inject_(allow_inject),
        sampler_(source_.get()), start_time_(FakeSource::now()) {}

  void set_merge(std::vector<std::string> globs, double max_age_s) {
    merge_globs_ = std::move(globs);
    merge_max_age_ = max_age_s;
  }

  // ``conn_watches``: watch ids created on this connection — removed when
  // the client disconnects so exporter restarts never orphan daemon watches
  Json handle(const Json& req, std::vector<long long>* conn_watches) {
    g_requests++;
    const std::string& op = req["op"].as_str();
    if (op == "hello") return hello();
    if (op == "chip_info") return chip_info(req);
    if (op == "read_fields") return read_fields(req);
    if (op == "read_fields_bulk") return read_fields_bulk(req);
    if (op == "watch") return watch(req, conn_watches);
    if (op == "unwatch") return unwatch(req, conn_watches);
    if (op == "latest") return latest(req);
    if (op == "samples") return samples(req);
    if (op == "topology") return topology(req);
    if (op == "processes") return processes(req);
    if (op == "events") return events(req);
    if (op == "introspect") return introspect();
    if (op == "inject") return inject(req);
    if (op == "term") {
      request_shutdown();
      return ok();
    }
    return err("unknown op: " + op);
  }

  void shutdown_sampler() {
    sampler_.stop();
    if (burst_) burst_->stop();
  }

  // --burst-hz: start the windowed-accumulator inner loop (sampler.hpp
  // BurstSampler) over the generated cheap-counter subset; the sweep
  // and scrape paths then serve the derived fields from its 1 s
  // harvests (ids kBurstIdBase + source*4 + agg)
  void enable_burst(int hz) {
    burst_.reset(new BurstSampler(
        source_.get(), hz, kBurstIdBase,
        std::vector<int>(kBurstSourceFields,
                         kBurstSourceFields + kNumBurstSourceFields)));
    burst_->start();
  }

  // /healthz substance: a frozen or lost metric source must fail the
  // probe (k8s liveness restarts the pod), not keep answering 200 while
  // /metrics serves nothing — one cheap device-path read proves the
  // source is still alive
  bool health_ok() {
    if (source_->chip_count() < 1) return false;
    tpumon_chip_info_t info;
    return source_->chip_info(0, &info) == TPUMON_SHIM_OK;
  }

  void drop_connection_watches(const std::vector<long long>& ids) {
    for (long long id : ids) sampler_.remove_watch(id);
  }

  // Prometheus exposition straight from the daemon (no Python in the
  // data plane): every scrape family from the generated catalog, values
  // from the sampler cache when watched, live-read otherwise, plus the
  // agent self-metrics the exporter would have re-exported.  Byte
  // contract matches promtext.py: HELP/TYPE once per family, {chip,
  // uuid,model} labels, blank (unsupported) values omitted.
  //
  // ``t_accept``: when the acceptor thread took the connection
  // (mono_now); the scrape's wait runs from it to the lock.
  std::string render_prom(double t_accept) {
    std::string out;
    out.reserve(1 << 16);
    char line[768];
    int n_chips = source_->chip_count();
    // one scrape at a time: guards the label cache and keeps concurrent
    // scrapes from doubling live-read load on the device path
    std::lock_guard<std::mutex> g(prom_mu_);
    // phase clock starts AFTER the lock: time spent queued behind a
    // concurrent scrape is the wait phase, not render cost, and must not
    // skew the phase split the soak attributes tails with
    double t_begin = mono_now();
    {
      // rebuild on count change OR on a TTL: a chip replaced/re-enumerated
      // at the same index (uuid/model change after a reset) must not be
      // served under stale labels for the daemon's lifetime.  Monotonic
      // clock: a backward NTP step on CLOCK_REALTIME would silently
      // suspend rebuilds until wall time re-passed the stored stamp.
      double now = mono_now();
      bool stale = now - prom_labels_built_ > 10.0;
      if (static_cast<int>(prom_labels_.size()) != n_chips || stale) {
        prom_labels_built_ = now;
        // promtext.py escapes backslash/quote/newline in label values;
        // real-hardware uuid/model strings get the same treatment here
        auto esc = [](const char* s) {
          std::string out;
          for (; *s; s++) {
            if (*s == '\\') out += "\\\\";
            else if (*s == '"') out += "\\\"";
            else if (*s == '\n') out += "\\n";
            else out += *s;
          }
          return out;
        };
        prom_labels_.clear();
        for (int c = 0; c < n_chips; c++) {
          tpumon_chip_info_t info;
          std::string lbl = "chip=\"" + std::to_string(c) + "\"";
          std::string uuid;
          if (source_->chip_info(c, &info) == TPUMON_SHIM_OK) {
            uuid = info.uuid;
            lbl += ",uuid=\"" + esc(info.uuid) + "\",model=\"" +
                   esc(info.name) + "\"";
          }
          if (const PodLabels* pl = pod_lookup(uuid, c)) {
            // spliced pod labels (device_pod.go:109-113 analog) — the
            // attributed metrics ride the native data plane directly
            lbl += ",pod_name=\"" + esc(pl->pod.c_str()) +
                   "\",pod_namespace=\"" + esc(pl->ns.c_str()) +
                   "\",container_name=\"" + esc(pl->container.c_str()) +
                   "\"";
          }
          prom_labels_.push_back(std::move(lbl));
        }
      }
    }
    // the collect phase: the burst harvest, the watch cache and the live
    // reads of every chip
    double t_collect = mono_now();
    if (burst_) burst_->harvest_if_due(t_collect);
    // the families this scrape serves, and each chip's values of them in
    // one read (the burst harvest, the watch cache, then one live read)
    std::vector<const PromFamily*> fams;
    std::vector<int> fids;
    for (const auto& fam : kPromCatalog) {
      if (fam.set == 0) continue;  // api-only fields are not scraped
      if ((fam.set & 8) && !burst_) continue;  // burst mode off
      fams.push_back(&fam);
      fids.push_back(fam.id);
    }
    double now = FakeSource::now();
    std::vector<std::vector<FieldValue>> vals;
    for (int c = 0; c < n_chips; c++)
      vals.push_back(chip_values(c, fids, true, -1.0, now));
    double collect_s = mono_now() - t_collect;
    for (size_t k = 0; k < fams.size(); k++) {
      const PromFamily& fam = *fams[k];
      const bool vec_fam = fam.vector_label[0] != 0;
      bool wrote_header = false;
      for (int c = 0; c < n_chips; c++) {
        const FieldValue& v = vals[static_cast<size_t>(c)][k];
        // numbers only: a blank, a string or a non-finite value omits the
        // sample, a vector only serves a vector family (one sample a
        // non-blank element)
        std::string samples;
        if (v.kind == FieldValue::kVec) {
          if (!vec_fam) continue;
          for (size_t i = 0; i < v.vec.size(); i++) {
            if (!std::isfinite(v.vec[i])) continue;
            samples += std::string(fam.name) + "{" + prom_labels_[c] + "," +
                       fam.vector_label + "=\"" + std::to_string(i) +
                       "\"} " + prom_number(v.vec[i]) + "\n";
          }
        } else if (v.kind == FieldValue::kNum && std::isfinite(v.num)) {
          samples = std::string(fam.name) + "{" + prom_labels_[c] + "} " +
                    prom_number(v.num) + "\n";
        }
        if (samples.empty()) continue;
        if (!wrote_header) {
          snprintf(line, sizeof(line), "# HELP %s %s\n# TYPE %s %s\n",
                   fam.name, fam.help, fam.name, fam.ptype);
          out += line;
          wrote_header = true;
        }
        out += samples;
      }
    }
    double cpu_s = 0, rss_kb = 0;
    if (read_self_stat(&cpu_s, &rss_kb)) {
      double up = FakeSource::now() - start_time_;
      double pct = up > 0 ? 100.0 * cpu_s / up : 0.0;
      snprintf(line, sizeof(line),
               "# HELP tpumon_agent_cpu_percent Daemon lifetime-average "
               "CPU percent.\n# TYPE tpumon_agent_cpu_percent gauge\n"
               "tpumon_agent_cpu_percent %.3f\n"
               "# HELP tpumon_agent_memory_kb Daemon RSS in KB.\n"
               "# TYPE tpumon_agent_memory_kb gauge\n"
               "tpumon_agent_memory_kb %.0f\n"
               "# HELP tpumon_agent_uptime_seconds Daemon uptime.\n"
               "# TYPE tpumon_agent_uptime_seconds gauge\n"
               "tpumon_agent_uptime_seconds %.1f\n",
               pct, rss_kb, up);
      out += line;
    }
    double t_rendered = mono_now();
    if (!merge_globs_.empty()) append_merged(&out);
    // per-scrape phase split, measured around THIS response: lets a
    // soak attribute a slow scrape to its wait, the collect, the
    // formatting or the drop-file merge from the body alone instead of
    // guessing (wait + collect + render + merge fit in the scrape's
    // wall; the rest is the socket and the client).  The write is the
    // previous scrape's: this one's is not done yet.  Families are
    // pre-registered in append_merged's dedup sets like the merged-
    // stats gauges, so an echoed capture cannot duplicate them.
    double t_merged = mono_now();
    const double phase_ms[] = {
        (t_begin - t_accept) * 1e3, collect_s * 1e3,
        (t_rendered - t_begin - collect_s) * 1e3,
        (t_merged - t_rendered) * 1e3, prom_write_ms_.load()};
    for (size_t k = 0; k < kScrapePhases.size(); k++) {
      snprintf(line, sizeof(line), "# HELP %s %s\n# TYPE %s gauge\n%s %.3f\n",
               kScrapePhases[k].name, kScrapePhases[k].help,
               kScrapePhases[k].name, kScrapePhases[k].name, phase_ms[k]);
      out += line;
    }
    return out;
  }

  // the socket write of a /metrics response, served by the next scrape
  void note_prom_write(double ms) { prom_write_ms_.store(ms); }

  // merge fresh .prom drop files into the scrape (see the free helpers
  // above for the validation/series-id pieces this shares with the
  // python exporter's behavior)
  void append_merged(std::string* out) {
    std::set<std::string> series;
    std::set<std::string> decl;  // families declared OR sampled already
    // the merged-stats gauges are appended AFTER this scan — register
    // their families AND series up front so a drop file echoing them
    // (e.g. a captured scrape) cannot duplicate their HELP/TYPE (which
    // would abort the exposition) or inject a stale sample under the
    // live series' identity
    decl.insert("tpumon_agent_merged_files");
    decl.insert("tpumon_agent_merged_series");
    series.insert("tpumon_agent_merged_files");
    series.insert("tpumon_agent_merged_series");
    for (const auto& ph : kScrapePhases) {
      decl.insert(ph.name);
      series.insert(ph.name);
    }
    {
      size_t pos = 0;
      while (pos < out->size()) {
        size_t eol = out->find('\n', pos);
        if (eol == std::string::npos) eol = out->size();
        std::string ln = out->substr(pos, eol - pos);
        pos = eol + 1;
        if (ln.empty()) continue;
        if (ln[0] == '#') {
          char kind[8], fam[256];
          if (sscanf(ln.c_str(), "# %7s %255s", kind, fam) == 2 &&
              (strcmp(kind, "HELP") == 0 || strcmp(kind, "TYPE") == 0))
            decl.insert(fam);
          continue;
        }
        std::string sid;
        if (!prom_parse_sample(ln, &sid)) continue;  // own output: valid
        series.insert(sid);
        decl.insert(sid.substr(0, sid.find('{')));
      }
    }
    std::string merged;
    std::map<std::string, std::string> by_family;  // joins a base family
    std::set<std::string> seen_meta;  // "KIND fam" across merged files
    int files = 0, added = 0, dropped = 0;
    time_t wall = time(nullptr);
    // per-file byte cap: the drop dir is workload-writable, so a
    // multi-GB file must not be slurped whole into the privileged
    // daemon's /metrics thread (mirrors exporter.py MERGE_MAX_BYTES)
    const size_t kMergeMaxBytes = 4u << 20;
    for (const auto& pattern : merge_globs_) {
      glob_t g;
      if (::glob(pattern.c_str(), 0, nullptr, &g) != 0) continue;
      for (size_t p = 0; p < g.gl_pathc; p++) {
        // hostile-content discipline (workload-writable dir): O_NONBLOCK
        // so a dropped FIFO cannot park this thread in open(2) forever,
        // O_NOFOLLOW + S_ISREG so symlinks/devices/FIFOs are skipped
        int fd = ::open(g.gl_pathv[p],
                        O_RDONLY | O_NONBLOCK | O_NOFOLLOW | O_CLOEXEC);
        if (fd < 0) continue;
        struct stat st;
        if (fstat(fd, &st) != 0 || !S_ISREG(st.st_mode) ||
            difftime(wall, st.st_mtime) > merge_max_age_) {
          ::close(fd);
          continue;
        }
        files++;
        // whole-file read (capped), then split on '\n': a line-sized
        // fgets buffer would split long lines into fragments and
        // misparse them (the python twin handles arbitrary line lengths)
        std::string content;
        char buf[65536];
        ssize_t got;
        while (content.size() <= kMergeMaxBytes &&
               (got = ::read(fd, buf,
                             std::min(sizeof(buf), kMergeMaxBytes + 1 -
                                                       content.size()))) > 0)
          content.append(buf, static_cast<size_t>(got));
        ::close(fd);
        if (content.size() > kMergeMaxBytes) {
          // cut at a line boundary so the tail isn't misparsed as torn
          // (pos is cap-1: rfind's pos is inclusive, and the python twin
          // searches [0, cap) — the twins must keep the same line set)
          size_t cut = content.rfind('\n', kMergeMaxBytes - 1);
          content.resize(cut == std::string::npos ? 0 : cut + 1);
          double now = mono_now();
          if (now - merge_warned_ > 60.0) {
            merge_warned_ = now;
            vlogf(0, 'W', "merge textfile %s exceeds %zu bytes; truncated",
                  g.gl_pathv[p], kMergeMaxBytes);
          }
        }
        size_t pos = 0;
        while (pos < content.size()) {
          size_t eol = content.find('\n', pos);
          if (eol == std::string::npos) eol = content.size();
          std::string ln = content.substr(pos, eol - pos);
          pos = eol + 1;
          while (!ln.empty() && ln.back() == '\r') ln.pop_back();
          if (ln.empty()) continue;
          if (ln[0] == '#') {
            char kind[8], fam[256];
            if (sscanf(ln.c_str(), "# %7s %255s", kind, fam) == 2 &&
                (strcmp(kind, "HELP") == 0 || strcmp(kind, "TYPE") == 0)) {
              std::string key = std::string(kind) + " " + fam;
              if (decl.count(fam) || seen_meta.count(key)) continue;
              seen_meta.insert(key);
            }
            merged += ln + "\n";
            continue;
          }
          std::string sid;
          if (!prom_parse_sample(ln, &sid)) {
            dropped++;
            continue;
          }
          if (series.count(sid)) continue;  // daemon's own sample wins
          series.insert(sid);
          added++;
          std::string fam = sid.substr(0, sid.find('{'));
          if (decl.count(fam)) {
            // joins a family the daemon already emits: must land INSIDE
            // that family's block (OpenMetrics-strict consumers reject
            // split sample groups) — spliced below
            by_family[fam] += ln + "\n";
          } else {
            merged += ln + "\n";
          }
        }
      }
      globfree(&g);
    }
    if (dropped > 0) {
      double now = mono_now();
      if (now - merge_warned_ > 60.0) {
        merge_warned_ = now;
        vlogf(0, 'W',
              "%d malformed merge line(s) dropped (non-atomic writer?)",
              dropped);
      }
    }
    // the self-gauge block must be IN the exposition before the splice
    // runs: a drop-file sample spoofing these families (with labels, so
    // the series pre-registration doesn't catch it) is routed through
    // by_family and must land adjacent to the real block, never before
    // its HELP/TYPE
    char line[512];
    snprintf(line, sizeof(line),
             "# HELP tpumon_agent_merged_files Fresh textfiles merged into "
             "this scrape.\n# TYPE tpumon_agent_merged_files gauge\n"
             "tpumon_agent_merged_files %d\n"
             "# HELP tpumon_agent_merged_series Sample series merged from "
             "textfiles.\n# TYPE tpumon_agent_merged_series gauge\n"
             "tpumon_agent_merged_series %d\n",
             files, added);
    *out += line;
    if (!by_family.empty()) splice_by_family(out, &by_family);
    *out += merged;
  }

  // Insert merged samples at the end of their family's block in the
  // rendered exposition, keeping each sample group contiguous (the
  // python twin's _splice_by_family)
  static void splice_by_family(std::string* out,
                               std::map<std::string, std::string>* byf) {
    // (insert offset, text), recorded in increasing offset order
    std::vector<std::pair<size_t, std::string>> inserts;
    std::string cur;
    size_t cur_end = 0;
    auto close_family = [&]() {
      if (cur.empty()) return;
      auto it = byf->find(cur);
      if (it != byf->end()) {
        inserts.emplace_back(cur_end, it->second);
        byf->erase(it);
      }
      cur.clear();
    };
    size_t pos = 0;
    while (pos < out->size()) {
      size_t eol = out->find('\n', pos);
      if (eol == std::string::npos) eol = out->size();
      std::string ln = out->substr(pos, eol - pos);
      std::string fam;
      if (!ln.empty() && ln[0] == '#') {
        char kind[8], f[256];
        if (sscanf(ln.c_str(), "# %7s %255s", kind, f) == 2 &&
            (strcmp(kind, "HELP") == 0 || strcmp(kind, "TYPE") == 0))
          fam = f;
      } else if (!ln.empty()) {
        size_t e = ln.find_first_of("{ \t");
        fam = e == std::string::npos ? ln : ln.substr(0, e);
      }
      if (!fam.empty() && fam != cur) {
        close_family();
        cur = fam;
      }
      pos = eol < out->size() ? eol + 1 : out->size();
      if (!fam.empty()) cur_end = pos;
    }
    close_family();
    // back-to-front so earlier offsets stay valid
    for (auto it = inserts.rbegin(); it != inserts.rend(); ++it)
      out->insert(it->first, it->second);
    // declared-but-unsampled leftovers append at the end
    for (const auto& kv : *byf) *out += kv.second;
  }

 private:
  static Json ok() {
    Json r;
    r.set("ok", Json(true));
    return r;
  }
  static Json err(const std::string& msg) {
    Json r;
    r.set("ok", Json(false));
    r.set("error", Json(msg));
    return r;
  }

  Json hello() {
    Json r = ok();
    r.set("chip_count", Json(source_->chip_count()));
    r.set("driver", Json(source_->driver_version()));
    r.set("runtime", Json(source_->runtime_version()));
    r.set("agent_version", Json(std::string(kAgentVersion)));
    if (burst_) {
      // burst-loop health rides the hello so the exporter can surface
      // a silently-degraded inner loop (tpumon_agent_burst_* gauges)
      r.set("burst_hz", Json(static_cast<long long>(burst_->hz())));
      r.set("burst_overruns", Json(burst_->overruns()));
    }
    return r;
  }

  Json chip_info(const Json& req) {
    int idx = static_cast<int>(req["index"].as_int(-1));
    tpumon_chip_info_t info;
    int rc = source_->chip_info(idx, &info);
    if (rc == TPUMON_SHIM_ERR_NO_CHIP) return err("no such chip");
    if (rc != TPUMON_SHIM_OK) return err("chip_info failed");
    JsonObject d;
    d["uuid"] = Json(std::string(info.uuid));
    d["name"] = Json(std::string(info.name));
    d["arch"] = Json(arch_of(info.name));
    d["serial"] = Json(std::string(info.serial));
    d["dev_path"] = Json(std::string(info.dev_path));
    d["firmware"] = Json(std::string(info.firmware));
    d["driver_version"] = Json(source_->driver_version());
    if (info.hbm_total_mib > 0) d["hbm_total_mib"] = Json(info.hbm_total_mib);
    if (info.tc_clock_mhz > 0) d["tc_clock_mhz"] = Json(info.tc_clock_mhz);
    if (info.hbm_clock_mhz > 0) d["hbm_clock_mhz"] = Json(info.hbm_clock_mhz);
    if (info.power_limit_mw > 0)
      d["power_limit_w"] = Json(static_cast<double>(info.power_limit_mw) / 1000.0);
    if (info.numa_node >= 0) d["numa_node"] = Json(info.numa_node);
    d["pci_bus_id"] = Json(std::string(info.pci_bus_id));
    d["x"] = Json(info.coord_x);
    d["y"] = Json(info.coord_y);
    d["z"] = Json(info.coord_z);
    char host[256] = "";
    gethostname(host, sizeof(host));
    d["host"] = Json(std::string(host));
    Json r = ok();
    r.set("info", Json(std::move(d)));
    return r;
  }

  static std::string arch_of(const char* name) {
    std::string n(name);
    for (auto& c : n) c = static_cast<char>(tolower(c));
    for (const char* a : {"v5e", "v5p", "v6e", "v4"})
      if (n.find(a) != std::string::npos) return a;
    return "unknown";
  }

  // the values of one chip's fields: the burst-derived ones from the 1 s
  // harvest (closed ONCE per request by the caller's harvest_if_due),
  // with ``use_cache`` the watched ones from the sampler cache when no
  // older than ``max_age`` (<0: any retention-fresh value), and the rest
  // in ONE live read of the source.  Each live-read field bumps the
  // served-samples counter (samples_ counts request-driven device reads;
  // sampler-cache hits were counted by the sampler when it took them).
  std::vector<FieldValue> chip_values(int idx, const std::vector<int>& fids,
                                      bool use_cache, double max_age,
                                      double now) {
    std::vector<FieldValue> out(fids.size());
    std::vector<int> live;
    std::vector<size_t> at;
    for (size_t i = 0; i < fids.size(); i++) {
      int fid = fids[i];
      double v = 0, ts = 0;
      if (burst_ && burst_->covers(fid)) {
        if (burst_->lookup(idx, fid, &v)) {
          out[i].kind = FieldValue::kNum;
          out[i].num = v;
        }
      } else if (use_cache && sampler_.latest(idx, fid, &v, &ts) &&
                 (max_age < 0 || now - ts <= max_age)) {
        out[i].kind = FieldValue::kNum;
        out[i].num = v;
      } else {
        live.push_back(fid);
        at.push_back(i);
      }
    }
    if (!live.empty()) {
      samples_ += static_cast<long long>(live.size());
      std::vector<FieldValue> got;
      // a lost chip reads blank: healthy chips keep their sweep
      source_->read_fields_at(idx, live, FakeSource::now(), &got);
      for (size_t k = 0; k < at.size() && k < got.size(); k++)
        out[at[k]] = std::move(got[k]);
    }
    return out;
  }

  // one value under the JSON wire conventions: vector -> array (a blank
  // element null), string as is, blank or non-finite -> null
  static Json to_json(const FieldValue& v) {
    switch (v.kind) {
      case FieldValue::kNum: return Json(v.num);
      case FieldValue::kStr: return Json(v.str);
      case FieldValue::kVec: {
        JsonArray arr;
        for (double e : v.vec) arr.push_back(Json(e));
        return Json(std::move(arr));
      }
      default: return Json(nullptr);
    }
  }

  static std::vector<int> field_ids(const Json& fields) {
    std::vector<int> out;
    for (const auto& f : fields.as_arr())
      out.push_back(static_cast<int>(f.as_int(-1)));
    return out;
  }

  Json read_fields(const Json& req) {
    int idx = static_cast<int>(req["index"].as_int(-1));
    if (idx < 0 || idx >= source_->chip_count()) return err("no such chip");
    // the collect phase: the burst harvest, the watch cache and the live
    // reads of every chip
    double t_collect = mono_now();
    if (burst_) burst_->harvest_if_due(t_collect);
    std::vector<int> fids = field_ids(req["fields"]);
    std::vector<FieldValue> vals =
        chip_values(idx, fids, false, -1.0, FakeSource::now());
    JsonObject values;
    for (size_t i = 0; i < fids.size(); i++)
      values[std::to_string(fids[i])] = to_json(vals[i]);
    Json r = ok();
    r.set("values", Json(std::move(values)));
    return r;
  }

  // One round trip for a whole-host sweep: each (chip, field) is served
  // from the sampler cache when an agent-side watch keeps it fresh, else
  // live-read — the merge the Python client used to do per chip.
  Json read_fields_bulk(const Json& req) {
    // The sampler cache is shared across connections (hostengine
    // semantics: chips are sampled once no matter how many monitors
    // attach), so a caller states how stale a cached value it accepts
    // via max_age_s; anything older is live-read.  Absent = any
    // retention-fresh value.
    double max_age = req["max_age_s"].as_num(-1.0);
    double now = FakeSource::now();
    // close the burst window at most once per REQUEST, not per value:
    // chip_values then serves lookups from the harvest
    // the collect phase: the burst harvest, the watch cache and the live
    // reads of every chip
    double t_collect = mono_now();
    if (burst_) burst_->harvest_if_due(t_collect);
    JsonObject chips;
    JsonObject errors;
    for (const auto& r : req["reqs"].as_arr()) {
      int idx = static_cast<int>(r["index"].as_int(-1));
      if (idx < 0 || idx >= source_->chip_count()) {
        // a lost chip must not sink the whole-host sweep: healthy chips
        // still get fresh samples; the bad index is reported on the side
        errors[std::to_string(idx)] = Json(std::string("no such chip"));
        continue;
      }
      std::vector<int> fids = field_ids(r["fields"]);
      std::vector<FieldValue> vals = chip_values(idx, fids, true, max_age,
                                                 now);
      JsonObject values;
      for (size_t i = 0; i < fids.size(); i++)
        values[std::to_string(fids[i])] = to_json(vals[i]);
      chips[std::to_string(idx)] = Json(std::move(values));
    }
    Json r = ok();
    r.set("chips", Json(std::move(chips)));
    if (!errors.empty()) r.set("errors", Json(std::move(errors)));
    // optional piggybacked event drain: one RPC per sweep instead of
    // two (the 1 Hz hot path polls events after every field sweep)
    const Json& es = req["events_since"];
    if (!es.is_null()) append_events(r, es.as_int(0));
    return r;
  }

  // ---- binary delta sweep frames (sweep_frame op) ---------------------------
  // Per-connection delta encoding of the read_fields_bulk sweep: only
  // (chip, field) values whose identity changed since the last frame on
  // this connection go on the wire, plus removed-chip markers and the
  // piggybacked event drain.  The JSON op above stays byte-for-byte as
  // the differential oracle; the Python twin of this encoder is
  // tpumon_torch/sweepframe.py (SweepFrameEncoder), layout in protocol.md.

 private:
  // a value with the JSON-dump conventions applied up front: non-finite
  // scalars are blank (Json::dump prints them as null), non-finite vector
  // elements become the NaN blank-element sentinel
  static SweepValue sweep_value(FieldValue v) {
    if (v.kind == FieldValue::kNum && !std::isfinite(v.num)) return {};
    if (v.kind == FieldValue::kVec)
      for (double& e : v.vec)
        if (!std::isfinite(e)) e = std::nan("");
    return v;
  }

  // scalar emission under json.hpp's integral-dump rule, so the binary
  // path materializes the same Python int/float the JSON path would
  // (burst_dumps_as_int, sampler.hpp, is the one predicate: the burst
  // differential oracle emits through it too)
  static void append_sweep_number(std::string* out, int int_field,
                                  int dbl_field, double v) {
    if (burst_dumps_as_int(v))
      wire::put_varint_field(out, int_field,
                             wire::zigzag(static_cast<long long>(v)));
    else
      wire::put_double_field(out, dbl_field, v);
  }

 public:
  // one delta frame (magic + varint length + payload) for one request
  std::string sweep_frame(
      const std::vector<std::pair<int, std::vector<int>>>& reqs,
      double max_age, bool want_events, long long events_since,
      SweepDelta* delta) {
    g_requests++;
    double now = FakeSource::now();
    if (burst_) burst_->harvest_if_due(mono_now());  // once per sweep
    std::string body;
    wire::put_varint_field(
        &body, 1, static_cast<unsigned long long>(delta->frame_index++));
    std::set<int> present;
    int n_chips = source_->chip_count();
    for (const auto& cr : reqs) {
      int idx = cr.first;
      if (idx < 0 || idx >= n_chips) continue;  // lost chip: purged below
      present.insert(idx);
      std::string sub;
      if (!delta->chips.count(idx)) {
        // a NEW chip emits its (possibly empty) block so the client
        // mirror learns the chip exists even before any value lands
        delta->chips.insert(idx);
        wire::put_varint_field(&sub, 1,
                               static_cast<unsigned long long>(idx));
      }
      std::vector<FieldValue> vals =
          chip_values(idx, cr.second, true, max_age, now);
      for (size_t i = 0; i < cr.second.size(); i++) {
        int fid = cr.second[i];
        SweepValue sv = sweep_value(std::move(vals[i]));
        auto key = std::make_pair(idx, fid);
        auto it = delta->last.find(key);
        if (it != delta->last.end() && it->second == sv) continue;
        if (sub.empty())
          wire::put_varint_field(&sub, 1,
                                 static_cast<unsigned long long>(idx));
        std::string entry;
        wire::put_varint_field(&entry, 1,
                               static_cast<unsigned long long>(fid));
        switch (sv.kind) {
          case SweepValue::kBlank:
            wire::put_varint_field(&entry, 4, 1);
            break;
          case SweepValue::kNum:
            append_sweep_number(&entry, 2, 6, sv.num);
            break;
          case SweepValue::kStr:
            wire::put_len_field(&entry, 5, sv.str);
            break;
          case SweepValue::kVec: {
            std::string vecb;
            for (double e : sv.vec) {
              if (std::isnan(e))
                wire::put_varint_field(&vecb, 3, 1);
              else
                append_sweep_number(&vecb, 1, 2, e);
            }
            wire::put_len_field(&entry, 3, vecb);
            break;
          }
        }
        wire::put_len_field(&sub, 2, entry);
        if (it != delta->last.end())
          it->second = std::move(sv);
        else
          delta->last.emplace(key, std::move(sv));
      }
      if (!sub.empty()) wire::put_len_field(&body, 2, sub);
    }
    // chips that produced no value set this frame (lost, or dropped
    // from the request) purge on both sides: a reappearance is a clean
    // full re-send, never a stale delta base
    for (auto it = delta->chips.begin(); it != delta->chips.end();) {
      if (present.count(*it)) {
        ++it;
        continue;
      }
      int gone = *it;
      it = delta->chips.erase(it);
      delta->last.erase(delta->last.lower_bound({gone, INT_MIN}),
                        delta->last.upper_bound({gone, INT_MAX}));
      wire::put_varint_field(&body, 3,
                             static_cast<unsigned long long>(gone));
    }
    if (want_events) {
      for (const auto& e : source_->events_since(events_since)) {
        std::string ev;
        wire::put_varint_field(&ev, 1,
                               static_cast<unsigned long long>(e.etype));
        wire::put_varint_field(&ev, 2,
                               static_cast<unsigned long long>(e.seq));
        wire::put_varint_field(
            &ev, 3, static_cast<unsigned long long>(e.chip_index + 1));
        wire::put_double_field(&ev, 4, e.timestamp);
        wire::put_len_field(&ev, 5, e.uuid);
        wire::put_len_field(&ev, 6, e.message);
        wire::put_len_field(&body, 4, ev);
      }
    }
    std::string out;
    out.push_back(static_cast<char>(kSweepFrameMagic));
    wire::put_varint(&out, body.size());
    out += body;
    return out;
  }

  // the JSON-framed probe form of the op (first request of a
  // connection; an old agent answers it with "unknown op")
  std::string sweep_frame_json(const Json& req, SweepDelta* delta) {
    std::vector<std::pair<int, std::vector<int>>> reqs;
    for (const auto& r : req["reqs"].as_arr()) {
      std::vector<int> fids;
      for (const auto& f : r["fields"].as_arr())
        fids.push_back(static_cast<int>(f.as_int(-1)));
      reqs.emplace_back(static_cast<int>(r["index"].as_int(-1)),
                        std::move(fids));
    }
    double max_age = req["max_age_s"].as_num(-1.0);
    const Json& es = req["events_since"];
    return sweep_frame(reqs, max_age, !es.is_null(), es.as_int(0), delta);
  }

  // the varint-framed binary request (steady state); false = malformed
  bool sweep_frame_bin(const uint8_t* data, size_t n, SweepDelta* delta,
                       std::string* out) {
    wire::Reader r(data, n);
    double max_age = -1.0;
    bool want_events = false;
    long long events_since = 0;
    std::vector<std::pair<int, std::vector<int>>> reqs;
    std::vector<int> shared;
    std::vector<int> shared_chips;
    int field = 0, wt = 0;
    while (r.next_key(&field, &wt)) {
      if (field == 1 && wt == 1) {
        unsigned long long bits = 0;
        if (!r.fixed64(&bits)) return false;
        double d;
        memcpy(&d, &bits, sizeof(d));
        max_age = d;
      } else if (field == 2 && wt == 0) {
        events_since = static_cast<long long>(r.varint());
        want_events = r.ok();
      } else if (field == 3 && wt == 2) {
        const uint8_t* sub = nullptr;
        size_t sn = 0;
        if (!r.bytes_field(&sub, &sn)) return false;
        wire::Reader rs(sub, sn);
        int f2 = 0, w2 = 0, idx = -1;
        std::vector<int> fids;
        while (rs.next_key(&f2, &w2)) {
          if (f2 == 1 && w2 == 0) {
            idx = static_cast<int>(rs.varint());
          } else if (f2 == 2 && w2 == 2) {
            const uint8_t* pk = nullptr;
            size_t pn = 0;
            if (!rs.bytes_field(&pk, &pn)) return false;
            wire::Reader rp(pk, pn);
            while (!rp.done())
              fids.push_back(static_cast<int>(rp.varint()));
            if (!rp.ok()) return false;
          } else if (!rs.skip(w2)) {
            return false;
          }
        }
        if (!rs.ok()) return false;
        reqs.emplace_back(idx, std::move(fids));
      } else if (field == 4 && wt == 2) {
        const uint8_t* pk = nullptr;
        size_t pn = 0;
        if (!r.bytes_field(&pk, &pn)) return false;
        wire::Reader rp(pk, pn);
        while (!rp.done()) shared.push_back(static_cast<int>(rp.varint()));
        if (!rp.ok()) return false;
      } else if (field == 5 && wt == 2) {
        const uint8_t* pk = nullptr;
        size_t pn = 0;
        if (!r.bytes_field(&pk, &pn)) return false;
        wire::Reader rp(pk, pn);
        while (!rp.done())
          shared_chips.push_back(static_cast<int>(rp.varint()));
        if (!rp.ok()) return false;
      } else if (!r.skip(wt)) {
        return false;
      }
    }
    if (!r.ok()) return false;
    for (int c : shared_chips) reqs.emplace_back(c, shared);
    *out = sweep_frame(reqs, max_age, want_events, events_since, delta);
    return true;
  }

 private:
  // ---- agent-side watches (dcgmWatchFields-in-hostengine parity) ----------

  Json watch(const Json& req, std::vector<long long>* conn_watches) {
    std::vector<int> fields;
    for (const auto& f : req["fields"].as_arr())
      fields.push_back(static_cast<int>(f.as_int(-1)));
    if (fields.empty()) return err("watch requires fields");
    long long id = sampler_.add_watch(
        fields, req["freq_us"].as_int(1000000),
        req["keep_age_s"].as_num(300.0));
    if (conn_watches) conn_watches->push_back(id);
    Json r = ok();
    r.set("watch_id", Json(id));
    return r;
  }

  Json unwatch(const Json& req, std::vector<long long>* conn_watches) {
    long long id = req["watch_id"].as_int(-1);
    if (!sampler_.remove_watch(id)) return err("no such watch");
    if (conn_watches) {
      conn_watches->erase(
          std::remove(conn_watches->begin(), conn_watches->end(), id),
          conn_watches->end());
    }
    return ok();
  }

  Json latest(const Json& req) {
    int idx = static_cast<int>(req["index"].as_int(-1));
    if (idx < 0 || idx >= source_->chip_count()) return err("no such chip");
    JsonObject values;
    double newest_ts = 0;
    for (const auto& f : req["fields"].as_arr()) {
      int fid = static_cast<int>(f.as_int(-1));
      double v = 0, ts = 0;
      if (sampler_.latest(idx, fid, &v, &ts)) {
        values[std::to_string(fid)] = Json(v);
        newest_ts = std::max(newest_ts, ts);
      } else {
        values[std::to_string(fid)] = Json(nullptr);
      }
    }
    Json r = ok();
    r.set("values", Json(std::move(values)));
    r.set("ts", Json(newest_ts));
    return r;
  }

  Json samples(const Json& req) {
    int idx = static_cast<int>(req["index"].as_int(-1));
    if (idx < 0 || idx >= source_->chip_count()) return err("no such chip");
    int fid = static_cast<int>(req["field"].as_int(-1));
    JsonArray out;
    for (const auto& s : sampler_.samples_since(
             idx, fid, req["since"].as_num(0.0))) {
      out.push_back(Json(JsonArray{Json(s.ts), Json(s.value)}));
    }
    Json r = ok();
    r.set("samples", Json(std::move(out)));
    return r;
  }

  Json topology(const Json& req) {
    int idx = static_cast<int>(req["index"].as_int(-1));
    if (idx < 0 || idx >= source_->chip_count()) return err("no such chip");
    Topology topo;
    int rc = source_->topology(idx, &topo);
    if (rc == TPUMON_SHIM_ERR_NO_CHIP) return err("no such chip");
    if (rc != TPUMON_SHIM_OK) return err("chip_info failed");
    JsonArray links;
    for (const auto& link : topo.links) {
      JsonObject l;
      l["chip"] = Json(link.chip);
      l["bus_id"] = Json(link.bus_id);
      l["link"] = Json(link.link);
      l["hops"] = Json(link.hops);
      links.push_back(Json(std::move(l)));
    }
    JsonArray mesh, wrap;
    for (int m : topo.mesh_shape) mesh.push_back(Json(m));
    for (bool w : topo.wrap) wrap.push_back(Json(w));
    JsonObject t;
    t["x"] = Json(topo.x);
    t["y"] = Json(topo.y);
    t["z"] = Json(topo.z);
    if (topo.numa_node >= 0) t["numa_node"] = Json(topo.numa_node);
    t["cpu_affinity"] = Json(topo.cpu_affinity);
    t["mesh_shape"] = Json(std::move(mesh));
    t["wrap"] = Json(std::move(wrap));
    t["links"] = Json(std::move(links));
    Json r = ok();
    r.set("topo", Json(std::move(t)));
    return r;
  }

  // holders of the device's node (who holds /dev/nvidia<minor>?)
  Json processes(const Json& req) {
    int idx = static_cast<int>(req["index"].as_int(-1));
    std::vector<DeviceHolder> holders;
    if (source_->processes(idx, &holders) != TPUMON_SHIM_OK)
      return err("no such chip");
    JsonArray procs;
    for (const auto& h : holders) {
      JsonObject p;
      p["pid"] = Json(h.pid);
      p["name"] = Json(h.name);
      procs.push_back(Json(std::move(p)));
    }
    Json r = ok();
    r.set("processes", Json(std::move(procs)));
    return r;
  }

  void append_events(Json& r, long long since) {
    JsonArray evs;
    for (const auto& e : source_->events_since(since)) {
      JsonObject o;
      o["etype"] = Json(e.etype);
      o["timestamp"] = Json(e.timestamp);
      o["seq"] = Json(e.seq);
      o["chip_index"] = Json(e.chip_index);
      o["uuid"] = Json(e.uuid);
      o["message"] = Json(e.message);
      evs.push_back(Json(std::move(o)));
    }
    r.set("events", Json(std::move(evs)));
  }

  Json events(const Json& req) {
    long long since = req["since_seq"].as_int(0);
    Json r = ok();
    r.set("last_seq", Json(source_->current_event_seq()));
    if (req["peek"].as_bool(false)) return r;
    append_events(r, since);
    return r;
  }

  Json introspect() {
    double cpu_s = 0, rss_kb = 0;
    read_self_stat(&cpu_s, &rss_kb);
    double uptime = FakeSource::now() - start_time_;
    Json r = ok();
    r.set("memory_kb", Json(rss_kb));
    r.set("cpu_percent",
          Json(uptime > 0 ? 100.0 * cpu_s / uptime : 0.0));
    r.set("pid", Json(static_cast<long long>(getpid())));
    r.set("uptime_s", Json(uptime));
    r.set("requests", Json(g_requests.load()));
    r.set("samples", Json(samples_.load() + sampler_.total_samples() +
                          (burst_ ? burst_->samples() : 0)));
    return r;
  }

  Json inject(const Json& req) {
    if (!allow_inject_) return err("event injection disabled");
    bool done = source_->inject_event(
        static_cast<int>(req["chip"].as_int(0)),
        static_cast<int>(req["etype"].as_int(0)), req["message"].as_str());
    return done ? ok() : err("source does not support injection");
  }

  std::unique_ptr<MetricSource> source_;
  bool allow_inject_;
  Sampler sampler_;
  // declared after source_: members destroy in reverse order, so the
  // burst thread joins before the source it reads is torn down
  std::unique_ptr<BurstSampler> burst_;
  double start_time_;
  std::atomic<long long> samples_{0};
  std::mutex prom_mu_;
  std::vector<std::string> prom_labels_;  // static per-chip label strings
  double prom_labels_built_ = -1e18;      // forces build on first render
  std::vector<std::string> merge_globs_;  // textfile-collector drop files
  double merge_max_age_ = 60.0;
  double merge_warned_ = -1e18;
  std::atomic<double> prom_write_ms_{0.0};  // the last /metrics write

  // pod attribution (kubelet pod-resources; device_pod.go analog) — the
  // round-1 gap: attribution was Python-only, so the zero-Python data
  // plane could not serve k8s-attributed metrics.  The kubelet RPC runs
  // on its OWN thread: a slow/hung kubelet (10 s socket timeouts) must
  // never stall a /metrics scrape, so render only ever reads the latest
  // swapped-in map under prom_mu_.
  std::string kubelet_socket_;            // empty = attribution off
  std::string pod_resource_ = "nvidia.com/gpu";
  std::map<std::string, PodLabels> pod_map_;
  std::thread pod_thread_;
  std::mutex pod_cv_mu_;
  std::condition_variable pod_cv_;
  bool pod_stop_ = false;

 public:
  void set_pod_attribution(const std::string& socket_path,
                           const std::string& resource) {
    kubelet_socket_ = socket_path;
    if (!resource.empty()) pod_resource_ = resource;
    pod_thread_ = std::thread([this]() {
      while (true) {
        std::map<std::string, PodLabels> fresh;
        std::string err;
        bool got = kubelet_list_pod_resources(kubelet_socket_,
                                              pod_resource_, &fresh, &err);
        {
          std::lock_guard<std::mutex> g(prom_mu_);
          if (got && fresh != pod_map_) {
            pod_map_ = std::move(fresh);
            prom_labels_built_ = -1e18;  // re-splice labels next render
          }
          // on failure the previous map keeps serving (kubelet restarts
          // must not strip labels mid-flight)
        }
        std::unique_lock<std::mutex> lk(pod_cv_mu_);
        if (pod_cv_.wait_for(lk, std::chrono::seconds(30),
                             [this]() { return pod_stop_; }))
          return;
      }
    });
  }

  void stop_pod_refresher() {
    {
      std::lock_guard<std::mutex> g(pod_cv_mu_);
      pod_stop_ = true;
    }
    pod_cv_.notify_all();
    if (pod_thread_.joinable()) pod_thread_.join();
  }

  ~Server() { stop_pod_refresher(); }

 private:
  // device-plugin ID conventions, mirroring PodAttributor._lookup;
  // caller holds prom_mu_
  const PodLabels* pod_lookup(const std::string& uuid, int chip) {
    if (kubelet_socket_.empty()) return nullptr;
    auto it = pod_map_.find(uuid);
    if (it != pod_map_.end()) return &it->second;
    char key[32];
    snprintf(key, sizeof(key), "nvidia%d", chip);
    if ((it = pod_map_.find(key)) != pod_map_.end()) return &it->second;
    snprintf(key, sizeof(key), "%d", chip);
    if ((it = pod_map_.find(key)) != pod_map_.end()) return &it->second;
    return nullptr;
  }
};

// ---- connection handling ---------------------------------------------------

// one request line may not exceed this (the kubelet pod-resources channel
// uses a 16 MB cap for the same reason, kubelet_server.go:16-18): a client
// that never sends a newline must not grow the daemon's buffer unboundedly
static const size_t kMaxRequestBytes = 1 << 20;

// JSON-RPC connection accounting, mirroring the /metrics path: shutdown
// must be able to force every handler off its socket and then wait for
// ALL of them — a detached thread still inside Server::handle while main
// destroys the Server is a use-after-free (ThreadSanitizer found exactly
// this on the inject path; tests/test_sanitizers.py keeps it found).
static std::atomic<int> g_rpc_inflight{0};
static std::mutex g_rpc_fds_mu;
static std::set<int> g_rpc_fds;

static void rpc_client_done(int fd) {
  {
    // erase before close: the fd number may be reused by a concurrent
    // accept the instant it is closed
    std::lock_guard<std::mutex> g(g_rpc_fds_mu);
    g_rpc_fds.erase(fd);
  }
  close(fd);
  g_rpc_inflight--;
}

// write a whole reply (JSON line or binary frame); false = peer gone
static bool write_all(int fd, const std::string& out) {
  size_t off = 0;
  while (off < out.size()) {
    ssize_t w = write(fd, out.data() + off, out.size() - off);
    if (w <= 0) return false;
    off += static_cast<size_t>(w);
  }
  return true;
}

static void serve_client(int fd, Server* server) {
  std::string buf;
  char chunk[4096];
  std::vector<long long> conn_watches;
  // per-connection sweep_frame delta table: dies with the socket, which
  // is what resets the client's mirror and this table together
  SweepDelta sweep_delta;
  while (!g_shutdown) {
    ssize_t n = read(fd, chunk, sizeof(chunk));
    if (n <= 0) break;
    buf.append(chunk, static_cast<size_t>(n));
    // drain complete messages: binary sweep requests are framed by
    // magic + varint length (they may legally contain '\n'), JSON
    // requests by newline — dispatch on the buffer's first byte
    for (;;) {
      if (!buf.empty() &&
          static_cast<uint8_t>(buf[0]) == kSweepReqMagic) {
        size_t pos = 1;
        unsigned long long len = 0;
        int shift = 0;
        bool have_len = false, malformed = false;
        while (pos < buf.size()) {
          uint8_t b = static_cast<uint8_t>(buf[pos++]);
          len |= static_cast<unsigned long long>(b & 0x7F) << shift;
          if (!(b & 0x80)) {
            have_len = true;
            break;
          }
          shift += 7;
          if (shift > 63) {
            malformed = true;
            break;
          }
        }
        if (malformed || (have_len && len > kMaxRequestBytes)) {
          const char* err =
              "{\"ok\":false,\"error\":\"request exceeds 1 MiB "
              "line limit\"}\n";
          (void)!write(fd, err, strlen(err));
          server->drop_connection_watches(conn_watches);
          rpc_client_done(fd);
          return;
        }
        if (!have_len || buf.size() - pos < len) break;  // need more
        std::string payload = buf.substr(pos, len);
        buf.erase(0, pos + len);
        std::string out;
        if (!server->sweep_frame_bin(
                reinterpret_cast<const uint8_t*>(payload.data()),
                payload.size(), &sweep_delta, &out)) {
          g_requests++;
          out = "{\"ok\":false,\"error\":\"malformed sweep_frame "
                "request\"}\n";
        }
        if (!write_all(fd, out)) {
          server->drop_connection_watches(conn_watches);
          rpc_client_done(fd);
          return;
        }
        continue;
      }
      size_t pos = buf.find('\n');
      if (pos == std::string::npos) break;
      std::string line = buf.substr(0, pos);
      buf.erase(0, pos + 1);
      if (line.empty()) continue;
      std::string out;
      auto req = Json::parse(line);
      if (!req) {
        Json resp;
        resp.set("ok", Json(false));
        resp.set("error", Json("malformed JSON request"));
        out = resp.dump() + "\n";
      } else if ((*req)["op"].as_str() == "sweep_frame") {
        // the JSON-framed probe form: answered with a binary frame
        // (an agent without the op would answer "unknown op" here —
        // that reply is what pins the client to JSON forever)
        out = server->sweep_frame_json(*req, &sweep_delta);
      } else {
        out = server->handle(*req, &conn_watches).dump() + "\n";
      }
      if (!write_all(fd, out)) {
        server->drop_connection_watches(conn_watches);
        rpc_client_done(fd);
        return;
      }
    }
    if (buf.size() > kMaxRequestBytes &&
        static_cast<uint8_t>(buf[0]) != kSweepReqMagic &&
        buf.find('\n') == std::string::npos) {
      const char* err =
          "{\"ok\":false,\"error\":\"request exceeds 1 MiB line limit\"}\n";
      (void)!write(fd, err, strlen(err));
      break;
    }
  }
  server->drop_connection_watches(conn_watches);
  rpc_client_done(fd);
}

static void on_signal(int) { request_shutdown(); }

// ---- Prometheus HTTP endpoint (--prom-port) --------------------------------

static std::atomic<int> g_prom_inflight{0};
// live client sockets, so shutdown can shutdown(2) them and unblock any
// handler sitting in a read/write — the drain below must be able to wait
// for ALL handlers (they hold a Server* into main's stack), and it can
// only afford to wait unbounded if blocked I/O is forced to fail first
static std::mutex g_prom_fds_mu;
static std::set<int> g_prom_fds;

// "GET /metrics HTTP/1.1" matches "/metrics" but "GET /metricsfoo" must not:
// the path ends at a space, '?', or the end of the request line
static bool path_is(const std::string& req, const char* path) {
  std::string want = std::string("GET ") + path;
  if (req.rfind(want, 0) != 0) return false;
  if (req.size() == want.size()) return true;
  char next = req[want.size()];
  return next == ' ' || next == '?' || next == '\r' || next == '\n';
}

static void serve_prom_client(int fd, Server* server, double t_accept) {
  // NOTE: g_prom_inflight was incremented by the acceptor *before* this
  // thread was spawned — incrementing here would leave a window where a
  // just-accepted connection is invisible to the shutdown drain.
  // an idle/slow client must not pin this thread (or wedge shutdown):
  // bound both directions
  struct timeval tv = {5, 0};
  setsockopt(fd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof(tv));
  setsockopt(fd, SOL_SOCKET, SO_SNDTIMEO, &tv, sizeof(tv));
  std::string req;
  char chunk[1024];
  while (req.find("\r\n\r\n") == std::string::npos && req.size() < 8192) {
    ssize_t n = read(fd, chunk, sizeof(chunk));
    if (n <= 0) break;
    req.append(chunk, static_cast<size_t>(n));
  }
  std::string status = "200 OK", body;
  bool metrics = path_is(req, "/metrics");
  if (metrics) {
    body = server->render_prom(t_accept);
  } else if (path_is(req, "/healthz")) {
    if (server->health_ok()) {
      body = "ok\n";
    } else {
      status = "503 Service Unavailable";
      body = "metric source unhealthy\n";
    }
  } else {
    status = "404 Not Found";
    body = "not found\n";
  }
  char hdr[256];
  snprintf(hdr, sizeof(hdr),
           "HTTP/1.0 %s\r\n"
           "Content-Type: text/plain; version=0.0.4; charset=utf-8\r\n"
           "Content-Length: %zu\r\nConnection: close\r\n\r\n",
           status.c_str(), body.size());
  std::string out = hdr + body;
  size_t off = 0;
  double t_write = mono_now();
  while (off < out.size()) {
    ssize_t w = write(fd, out.data() + off, out.size() - off);
    if (w <= 0) break;
    off += static_cast<size_t>(w);
  }
  if (metrics) server->note_prom_write((mono_now() - t_write) * 1e3);
  {
    // erase before close: the fd number may be reused by a concurrent
    // accept the instant it is closed
    std::lock_guard<std::mutex> g(g_prom_fds_mu);
    g_prom_fds.erase(fd);
  }
  close(fd);
  g_prom_inflight--;
}

// returns the bound port (differs from the request when it was 0), or -1
static int start_prom_listener(int port, Server* server,
                               std::thread* out_thread) {
  int fd = socket(AF_INET, SOCK_STREAM, 0);
  if (fd < 0) return -1;
  int one = 1;
  setsockopt(fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  struct sockaddr_in addr;
  memset(&addr, 0, sizeof(addr));
  addr.sin_family = AF_INET;
  addr.sin_addr.s_addr = htonl(INADDR_ANY);  // scraped from off-host
  addr.sin_port = htons(static_cast<uint16_t>(port));
  if (bind(fd, reinterpret_cast<struct sockaddr*>(&addr),
           sizeof(addr)) != 0 || listen(fd, 16) != 0) {
    close(fd);
    return -1;
  }
  socklen_t alen = sizeof(addr);
  getsockname(fd, reinterpret_cast<struct sockaddr*>(&addr), &alen);
  int bound = ntohs(addr.sin_port);
  fcntl(fd, F_SETFL, O_NONBLOCK);
  *out_thread = std::thread([fd, server]() {
    while (wait_readable(fd)) {
      int cfd = accept(fd, nullptr, nullptr);
      if (cfd < 0) continue;  // EAGAIN: another wake-up took it
      double t_accept = mono_now();
      // detached (a per-scrape thread held until shutdown would leak
      // its stack for the daemon's lifetime); the drain below keeps
      // them from outliving the Server they reference.  Account the
      // connection BEFORE spawning so the drain can never miss it.
      g_prom_inflight++;
      {
        std::lock_guard<std::mutex> g(g_prom_fds_mu);
        g_prom_fds.insert(cfd);
      }
      try {
        std::thread(serve_prom_client, cfd, server, t_accept).detach();
      } catch (const std::system_error&) {
        {
          std::lock_guard<std::mutex> g(g_prom_fds_mu);
          g_prom_fds.erase(cfd);
        }
        close(cfd);
        g_prom_inflight--;
      }
    }
    close(fd);
    // in-flight handlers hold a Server pointer into main's stack: wait
    // for ALL of them, not a fixed grace.  First force any handler off
    // its socket (a slow scraper can otherwise hold serve_prom_client
    // for many 5 s I/O timeouts); after shutdown(2) the remaining work
    // is a render — normally milliseconds, but it can sit in a live
    // device read.  If a wedged driver call keeps a handler pinned past
    // the bound, _exit: skipping destruction cannot use-after-free, and
    // a daemon that can't shut down cleanly must still honor SIGTERM.
    {
      std::lock_guard<std::mutex> g(g_prom_fds_mu);
      for (int cfd : g_prom_fds) shutdown(cfd, SHUT_RDWR);
    }
    for (int i = 0; i < 2000 && g_prom_inflight > 0; i++)
      usleep(5 * 1000);
    if (g_prom_inflight > 0) {
      fprintf(stderr,
              "gpu-hostengine: %d scrape handler(s) wedged in a device "
              "read at shutdown; exiting without teardown\n",
              g_prom_inflight.load());
      _exit(0);
    }
  });
  return bound;
}

}  // namespace tpumon

int main(int argc, char** argv) {
  using namespace tpumon;

  std::string socket_path;
  int port = 0;
  int prom_port = -1;
  bool fake = getenv("TPUMON_AGENT_FAKE") &&
              std::string(getenv("TPUMON_AGENT_FAKE")) == "1";
  // env first, argv second: an explicit --v (including --v 0) beats the
  // fleet-wide TPUMON_AGENT_VERBOSITY
  if (const char* env_v = getenv("TPUMON_AGENT_VERBOSITY"))
    g_verbosity = atoi(env_v);
  bool allow_inject = false;
  int fake_chips = 4;
  double fake_epoch = 0;  // 0 = start time; pinned for reproducibility
  std::string kmsg_path =
      getenv("TPUMON_KMSG_PATH") ? getenv("TPUMON_KMSG_PATH") : "/dev/kmsg";
  std::string kubelet_socket;  // empty = pod attribution off
  std::string pod_resource;
  std::vector<std::string> merge_globs;
  double merge_max_age = 60.0;
  int burst_hz = 0;  // 0 = burst sampling off

  for (int i = 1; i < argc; i++) {
    std::string a = argv[i];
    if (a == "--domain-socket" && i + 1 < argc) socket_path = argv[++i];
    else if (a == "--port" && i + 1 < argc) port = atoi(argv[++i]);
    else if (a == "--burst-hz" && i + 1 < argc) burst_hz = atoi(argv[++i]);
    else if (a == "--fake") fake = true;
    else if (a == "--fake-chips" && i + 1 < argc) fake_chips = atoi(argv[++i]);
    else if (a == "--fake-epoch" && i + 1 < argc) fake_epoch = atof(argv[++i]);
    else if (a == "--allow-inject") allow_inject = true;
    else if (a == "--prom-port" && i + 1 < argc) prom_port = atoi(argv[++i]);
    else if (a == "--v" && i + 1 < argc) g_verbosity = atoi(argv[++i]);
    else if (a == "--kmsg" && i + 1 < argc) kmsg_path = argv[++i];
    else if (a == "--kubelet-socket" && i + 1 < argc)
      kubelet_socket = argv[++i];
    else if (a == "--pod-resource" && i + 1 < argc)
      pod_resource = argv[++i];
    else if (a == "--merge-textfile" && i + 1 < argc)
      merge_globs.push_back(argv[++i]);
    else if (a == "--merge-max-age" && i + 1 < argc)
      merge_max_age = atof(argv[++i]);
    else if (a == "--help") {
      printf("usage: gpu-hostengine [--domain-socket PATH | --port N] "
             "[--prom-port N] [--fake] [--fake-chips N] [--allow-inject] "
             "[--v N]\n"
             "  --v N           log verbosity (glog-style; or "
             "TPUMON_AGENT_VERBOSITY)\n"
             "  --kmsg PATH     kernel-log stream of the NVML source's Xid "
             "watcher (default /dev/kmsg)\n"
             "  --kubelet-socket PATH   enable pod attribution via the "
             "kubelet pod-resources API\n"
             "  --pod-resource NAME     device-plugin resource to match "
             "(default nvidia.com/gpu)\n"
             "  --prom-port N   serve Prometheus /metrics + /healthz over "
             "HTTP (0 = kernel-assigned,\n                  printed to "
             "stderr) straight from the daemon — no Python data plane\n"
             "  --merge-textfile GLOB   merge fresh .prom drop files "
             "(e.g. a workload's embedded\n                  self-monitor "
             "output) into every scrape; repeatable\n"
             "  --merge-max-age S       skip merge files older than S "
             "seconds (default 60)\n"
             "  --burst-hz N    sample the cheap-counter subset at N Hz "
             "(50-100 typical; 0 = off)\n                  into 1 s "
             "min/max/mean/integral accumulators served as derived "
             "fields\n");
      return 0;
    }
  }
  if (socket_path.empty() && port == 0)
    socket_path = "/tmp/tpumon-hostengine.sock";

  // pick the metric source: the fake when asked for, else NVML, which
  // must load and see at least one device
  std::unique_ptr<MetricSource> source;
  if (fake) {
    source = std::make_unique<FakeSource>(fake_chips, fake_epoch);
    vlogf(0, 'I', "metric source: fake (%d chips)", fake_chips);
  } else {
    auto nvml = std::make_unique<NvmlSource>(kmsg_path);
    NvmlSource::OpenResult opened = nvml->open();
    std::string why = nvml->open_error();
    if (opened == NvmlSource::kOpened && nvml->chip_count() < 1) {
      nvml->close();
      opened = NvmlSource::kFailed;
      why = "NVML sees no device on this host";
    }
    if (opened == NvmlSource::kOpened) {
      source = std::move(nvml);
      vlogf(0, 'I', "metric source: nvml (%d device(s), driver %s)",
            source->chip_count(), source->driver_version().c_str());
    } else if (opened == NvmlSource::kAbsent && !merge_globs.empty()) {
      // merge-only mode: no NVML on this host, but the daemon still has
      // a job — serve workload drop files (embedded self-monitor
      // output) plus its own self-metrics.  Gated on the library's
      // absence: a host whose NVML loads and fails must keep
      // crash-looping visibly, not start "healthy" with its device
      // telemetry silently gone.
      source = std::make_unique<FakeSource>(0, fake_epoch);
      vlogf(0, 'I', "metric source: none (%s; merge-only: serving drop "
            "files)", why.c_str());
    } else {
      fprintf(stderr, "gpu-hostengine: no metric source: %s%s\n",
              why.c_str(),
              opened == NvmlSource::kAbsent
                  ? "; use --fake for the simulated source, or "
                    "--merge-textfile for merge-only mode"
                  : "");
      return 3;
    }
  }

  Server server(std::move(source), allow_inject);
  if (!merge_globs.empty()) {
    server.set_merge(merge_globs, merge_max_age);
    vlogf(0, 'I', "merging textfiles from %zu glob(s) into /metrics",
          merge_globs.size());
  }
  if (!kubelet_socket.empty()) {
    server.set_pod_attribution(kubelet_socket, pod_resource);
    vlogf(0, 'I', "pod attribution via %s (%s)", kubelet_socket.c_str(),
          pod_resource.empty() ? "nvidia.com/gpu" : pod_resource.c_str());
  }
  if (burst_hz > 0) {
    server.enable_burst(burst_hz);
    vlogf(0, 'I', "burst sampling at %d Hz over %d cheap counter(s)",
          burst_hz, kNumBurstSourceFields);
  }

  if (pipe2(g_wake, O_CLOEXEC | O_NONBLOCK) != 0) {
    perror("pipe2");
    return 1;
  }
  signal(SIGTERM, on_signal);
  signal(SIGINT, on_signal);
  signal(SIGPIPE, SIG_IGN);

  int listen_fd;
  if (!socket_path.empty()) {
    listen_fd = socket(AF_UNIX, SOCK_STREAM, 0);
    struct sockaddr_un addr;
    memset(&addr, 0, sizeof(addr));
    addr.sun_family = AF_UNIX;
    snprintf(addr.sun_path, sizeof(addr.sun_path), "%s", socket_path.c_str());
    unlink(socket_path.c_str());
    if (bind(listen_fd, reinterpret_cast<struct sockaddr*>(&addr),
             sizeof(addr)) != 0) {
      perror("bind");
      ::close(listen_fd);
      return 1;
    }
    g_socket_path = socket_path;
  } else {
    listen_fd = socket(AF_INET, SOCK_STREAM, 0);
    int one = 1;
    setsockopt(listen_fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
    struct sockaddr_in addr;
    memset(&addr, 0, sizeof(addr));
    addr.sin_family = AF_INET;
    addr.sin_addr.s_addr = htonl(INADDR_LOOPBACK);
    addr.sin_port = htons(static_cast<uint16_t>(port));
    if (bind(listen_fd, reinterpret_cast<struct sockaddr*>(&addr),
             sizeof(addr)) != 0) {
      perror("bind");
      ::close(listen_fd);
      return 1;
    }
  }
  if (listen(listen_fd, 16) != 0) {
    perror("listen");
    ::close(listen_fd);
    return 1;
  }

  // started only after the main listener is up: an early `return 1`
  // with a joinable std::thread would std::terminate
  std::thread prom_thread;
  if (prom_port >= 0) {
    int bound = start_prom_listener(prom_port, &server, &prom_thread);
    if (bound < 0) {
      perror("prom-port bind");
      ::close(listen_fd);
      return 1;
    }
    fprintf(stderr, "gpu-hostengine: serving /metrics on port %d\n", bound);
  }

  // accept loop, blocked in poll(2) until a client or the shutdown
  // wake-up (SIGTERM, SIGINT, the term op) arrives
  fcntl(listen_fd, F_SETFL, O_NONBLOCK);
  while (wait_readable(listen_fd)) {
    int fd = accept(listen_fd, nullptr, nullptr);
    if (fd < 0) continue;
    vlogf(1, 'I', "client connected (fd %d)", fd);
    g_rpc_inflight++;
    {
      std::lock_guard<std::mutex> g(g_rpc_fds_mu);
      g_rpc_fds.insert(fd);
    }
    try {
      // detached like the /metrics handlers: a joinable thread kept
      // until shutdown would pin its stack for the daemon's lifetime
      // per connection; lifetime is bounded by the inflight drain below
      std::thread(serve_client, fd, &server).detach();
    } catch (const std::system_error&) {
      rpc_client_done(fd);
    }
  }
  vlogf(0, 'I', "shutdown signal received; draining");

  close(listen_fd);
  if (!g_socket_path.empty()) unlink(g_socket_path.c_str());
  // force in-flight RPC handlers off their sockets, then wait for ALL of
  // them before Server (and its source) is destroyed; a handler wedged in
  // a device read past the bound forfeits clean teardown via _exit — the
  // same contract as the /metrics drain above
  {
    std::lock_guard<std::mutex> g(g_rpc_fds_mu);
    for (int cfd : g_rpc_fds) shutdown(cfd, SHUT_RDWR);
  }
  for (int i = 0; i < 2000 && g_rpc_inflight > 0; i++)
    usleep(5 * 1000);
  if (g_rpc_inflight > 0) {
    fprintf(stderr,
            "gpu-hostengine: %d rpc handler(s) wedged at shutdown; "
            "exiting without teardown\n", g_rpc_inflight.load());
    _exit(0);
  }
  if (prom_thread.joinable()) prom_thread.join();
  return 0;
}
