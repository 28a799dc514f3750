// tpumon_client.cc — C client library for the gpu-hostengine agent.
//
// Implements the newline-delimited JSON protocol of agent/protocol.md
// over a unix-domain or loopback TCP socket, exposed through a plain C API
// (tpumon_client.h) so non-Python consumers get the same daemon access the
// reference's Go bindings gave Go programs (bindings/go/dcgm/admin.go
// Standalone mode).

#include "tpumon_client.h"

#include <arpa/inet.h>
#include <errno.h>
#include <netdb.h>
#include <netinet/in.h>
#include <string.h>
#include <sys/socket.h>
#include <sys/un.h>
#include <unistd.h>

#include <mutex>
#include <optional>
#include <string>

#include "json.hpp"

namespace {

using tpumon::Json;
using tpumon::JsonArray;

constexpr const char *kDefaultAddress = "unix:/tmp/tpumon-hostengine.sock";

void copy_err(char *errbuf, int errlen, const std::string &msg) {
  if (errbuf && errlen > 0) {
    snprintf(errbuf, static_cast<size_t>(errlen), "%s", msg.c_str());
  }
}

void copy_field(char *dst, size_t cap, const Json &v) {
  snprintf(dst, cap, "%s", v.as_str().c_str());
}

}  // namespace

struct tpumon_client {
  int fd = -1;
  std::mutex mu;
  std::string rdbuf;
  std::string last_error;   // written under mu
  std::string err_snapshot;  // stable copy handed out by last_error()

  bool last_error_contains(const char *needle) {
    std::lock_guard<std::mutex> lock(mu);
    return last_error.find(needle) != std::string::npos;
  }

  // A mid-stream I/O failure leaves request/response pairing unknowable
  // (the reply may still land in the kernel buffer and would be paired
  // with the NEXT request), so the connection is poisoned: closed and
  // unusable, never resynced.  Caller holds mu.
  void poison_locked(const std::string &why) {
    last_error = why;
    if (fd >= 0) close(fd);
    fd = -1;
    rdbuf.clear();
  }

  // one request / one response line, under mu
  std::optional<Json> request(Json req) {
    std::lock_guard<std::mutex> lock(mu);
    if (fd < 0) {
      if (last_error.empty()) last_error = "client is closed";
      return std::nullopt;
    }
    std::string line = req.dump();
    line += '\n';
    size_t off = 0;
    while (off < line.size()) {
      ssize_t w = write(fd, line.data() + off, line.size() - off);
      if (w < 0 && errno == EINTR) continue;
      if (w <= 0) {
        poison_locked("write failed (agent gone?)");
        return std::nullopt;
      }
      off += static_cast<size_t>(w);
    }
    for (;;) {
      size_t pos = rdbuf.find('\n');
      if (pos != std::string::npos) {
        std::string one = rdbuf.substr(0, pos);
        rdbuf.erase(0, pos + 1);
        auto resp = Json::parse(one);
        if (!resp) {
          poison_locked("malformed response from agent");
          return std::nullopt;
        }
        if (!(*resp)["ok"].as_bool(false)) {
          last_error = (*resp)["error"].as_str();
          if (last_error.empty()) last_error = "agent error";
          return std::nullopt;
        }
        return resp;
      }
      char chunk[4096];
      ssize_t n = read(fd, chunk, sizeof(chunk));
      if (n < 0 && errno == EINTR) continue;
      if (n <= 0) {
        poison_locked("connection closed by agent");
        return std::nullopt;
      }
      rdbuf.append(chunk, static_cast<size_t>(n));
    }
  }
};

extern "C" {

tpumon_client_t *tpumon_client_connect(const char *address, char *errbuf,
                                       int errlen) {
  std::string addr = address && *address ? address : kDefaultAddress;
  int fd = -1;
  if (addr.rfind("unix:", 0) == 0) {
    std::string path = addr.substr(5);
    fd = socket(AF_UNIX, SOCK_STREAM, 0);
    if (fd < 0) {
      copy_err(errbuf, errlen, "socket() failed");
      return nullptr;
    }
    struct sockaddr_un sa;
    memset(&sa, 0, sizeof(sa));
    sa.sun_family = AF_UNIX;
    snprintf(sa.sun_path, sizeof(sa.sun_path), "%s", path.c_str());
    if (connect(fd, reinterpret_cast<struct sockaddr *>(&sa),
                sizeof(sa)) != 0) {
      copy_err(errbuf, errlen,
               "cannot connect to gpu-hostengine at " + addr + ": " +
                   strerror(errno));
      close(fd);
      return nullptr;
    }
  } else {
    // host:port (default port 5555, the nv-hostengine convention)
    std::string host = addr;
    std::string port = "5555";
    size_t colon = addr.rfind(':');
    if (colon != std::string::npos) {
      host = addr.substr(0, colon);
      port = addr.substr(colon + 1);
    }
    struct addrinfo hints;
    memset(&hints, 0, sizeof(hints));
    hints.ai_family = AF_UNSPEC;
    hints.ai_socktype = SOCK_STREAM;
    struct addrinfo *res = nullptr;
    int rc = getaddrinfo(host.c_str(), port.c_str(), &hints, &res);
    if (rc != 0 || !res) {
      copy_err(errbuf, errlen,
               "cannot resolve " + addr + ": " + gai_strerror(rc));
      return nullptr;
    }
    for (struct addrinfo *ai = res; ai; ai = ai->ai_next) {
      fd = socket(ai->ai_family, ai->ai_socktype, ai->ai_protocol);
      if (fd < 0) continue;
      if (connect(fd, ai->ai_addr, ai->ai_addrlen) == 0) break;
      close(fd);
      fd = -1;
    }
    freeaddrinfo(res);
    if (fd < 0) {
      copy_err(errbuf, errlen,
               "cannot connect to gpu-hostengine at " + addr);
      return nullptr;
    }
  }

  auto *c = new tpumon_client();
  c->fd = fd;
  Json hello;
  hello.set("op", Json(std::string("hello")));
  hello.set("client", Json(std::string("tpumon-c-client")));
  if (!c->request(std::move(hello))) {
    copy_err(errbuf, errlen, "agent handshake failed: " + c->last_error);
    tpumon_client_close(c);
    return nullptr;
  }
  return c;
}

void tpumon_client_close(tpumon_client_t *c) {
  if (!c) return;
  {
    std::lock_guard<std::mutex> lock(c->mu);
    if (c->fd >= 0) close(c->fd);
    c->fd = -1;
  }
  delete c;
}

const char *tpumon_client_last_error(tpumon_client_t *c) {
  if (!c) return "";
  // copy under the lock; the returned pointer stays valid until the next
  // tpumon_client_last_error call on this client
  std::lock_guard<std::mutex> lock(c->mu);
  c->err_snapshot = c->last_error;
  return c->err_snapshot.c_str();
}

int tpumon_client_chip_count(tpumon_client_t *c) {
  if (!c) return -1;
  Json req;
  req.set("op", Json(std::string("hello")));
  auto resp = c->request(std::move(req));
  if (!resp) return -1;
  return static_cast<int>((*resp)["chip_count"].as_int(-1));
}

int tpumon_client_chip_info(tpumon_client_t *c, int chip,
                            tpumon_chip_info_t *out) {
  if (!c || !out) return TPUMON_SHIM_ERR_INTERNAL;
  Json req;
  req.set("op", Json(std::string("chip_info")));
  req.set("index", Json(static_cast<long long>(chip)));
  auto resp = c->request(std::move(req));
  if (!resp) {
    return c->last_error_contains("no such chip")
               ? TPUMON_SHIM_ERR_NO_CHIP
               : TPUMON_SHIM_ERR_INTERNAL;
  }
  const Json &d = (*resp)["info"];
  memset(out, 0, sizeof(*out));
  out->index = chip;
  copy_field(out->uuid, sizeof(out->uuid), d["uuid"]);
  copy_field(out->name, sizeof(out->name), d["name"]);
  copy_field(out->serial, sizeof(out->serial), d["serial"]);
  copy_field(out->dev_path, sizeof(out->dev_path), d["dev_path"]);
  copy_field(out->firmware, sizeof(out->firmware), d["firmware"]);
  copy_field(out->pci_bus_id, sizeof(out->pci_bus_id), d["pci_bus_id"]);
  out->hbm_total_mib = d["hbm_total_mib"].as_int(0);
  out->tc_clock_mhz = static_cast<int>(d["tc_clock_mhz"].as_int(0));
  out->hbm_clock_mhz = static_cast<int>(d["hbm_clock_mhz"].as_int(0));
  // wire carries watts; the shim struct carries milliwatts
  double limit_w = d["power_limit_w"].as_num(0);
  out->power_limit_mw = static_cast<long long>(limit_w * 1000.0);
  out->numa_node = static_cast<int>(d["numa_node"].as_int(-1));
  out->coord_x = static_cast<int>(d["x"].as_int(0));
  out->coord_y = static_cast<int>(d["y"].as_int(0));
  out->coord_z = static_cast<int>(d["z"].as_int(0));
  return TPUMON_SHIM_OK;
}

int tpumon_client_read_fields(tpumon_client_t *c, int chip,
                              const int *field_ids, int n, double *values,
                              unsigned char *blanks) {
  if (!c || !field_ids || !values || n <= 0) return TPUMON_SHIM_ERR_INTERNAL;
  Json req;
  req.set("op", Json(std::string("read_fields")));
  req.set("index", Json(static_cast<long long>(chip)));
  JsonArray arr;
  for (int i = 0; i < n; i++)
    arr.push_back(Json(static_cast<long long>(field_ids[i])));
  req.set("fields", Json(std::move(arr)));
  auto resp = c->request(std::move(req));
  if (!resp) {
    return c->last_error_contains("no such chip")
               ? TPUMON_SHIM_ERR_NO_CHIP
               : TPUMON_SHIM_ERR_INTERNAL;
  }
  const Json &vals = (*resp)["values"];
  for (int i = 0; i < n; i++) {
    const Json &v = vals[std::to_string(field_ids[i])];
    bool scalar = v.type() == Json::Type::Number;
    values[i] = scalar ? v.as_num(0) : 0.0;
    if (blanks) blanks[i] = scalar ? 0 : 1;
  }
  return TPUMON_SHIM_OK;
}

int tpumon_client_read_vector(tpumon_client_t *c, int chip, int field_id,
                              double *values, int *inout_len) {
  if (!c || !values || !inout_len || *inout_len <= 0)
    return TPUMON_SHIM_ERR_INTERNAL;
  Json req;
  req.set("op", Json(std::string("read_fields")));
  req.set("index", Json(static_cast<long long>(chip)));
  JsonArray arr;
  arr.push_back(Json(static_cast<long long>(field_id)));
  req.set("fields", Json(std::move(arr)));
  auto resp = c->request(std::move(req));
  if (!resp) {
    return c->last_error_contains("no such chip")
               ? TPUMON_SHIM_ERR_NO_CHIP
               : TPUMON_SHIM_ERR_INTERNAL;
  }
  const Json &v = (*resp)["values"][std::to_string(field_id)];
  if (v.type() != Json::Type::Array) return TPUMON_SHIM_ERR_UNSUPPORTED;
  const JsonArray &ja = v.as_arr();
  int n = static_cast<int>(ja.size());
  if (n > *inout_len) n = *inout_len;
  for (int i = 0; i < n; i++) values[i] = ja[(size_t)i].as_num(0);
  *inout_len = n;
  return TPUMON_SHIM_OK;
}

long long tpumon_client_watch(tpumon_client_t *c, const int *field_ids,
                              int n, long long freq_us, double keep_age_s) {
  if (!c || !field_ids || n <= 0) return -1;
  Json req;
  req.set("op", Json(std::string("watch")));
  JsonArray arr;
  for (int i = 0; i < n; i++)
    arr.push_back(Json(static_cast<long long>(field_ids[i])));
  req.set("fields", Json(std::move(arr)));
  req.set("freq_us", Json(freq_us));
  req.set("keep_age_s", Json(keep_age_s));
  auto resp = c->request(std::move(req));
  if (!resp) return -1;
  return (*resp)["watch_id"].as_int(-1);
}

int tpumon_client_unwatch(tpumon_client_t *c, long long watch_id) {
  if (!c) return TPUMON_SHIM_ERR_INTERNAL;
  Json req;
  req.set("op", Json(std::string("unwatch")));
  req.set("watch_id", Json(watch_id));
  return c->request(std::move(req)) ? TPUMON_SHIM_OK
                                    : TPUMON_SHIM_ERR_INTERNAL;
}

int tpumon_client_introspect(tpumon_client_t *c, double *cpu_percent,
                             double *memory_kb, long long *requests) {
  if (!c) return TPUMON_SHIM_ERR_INTERNAL;
  Json req;
  req.set("op", Json(std::string("introspect")));
  auto resp = c->request(std::move(req));
  if (!resp) return TPUMON_SHIM_ERR_INTERNAL;
  if (cpu_percent) *cpu_percent = (*resp)["cpu_percent"].as_num(0);
  if (memory_kb) *memory_kb = (*resp)["memory_kb"].as_num(0);
  if (requests) *requests = (*resp)["requests"].as_int(0);
  return TPUMON_SHIM_OK;
}

int tpumon_client_poll_events(tpumon_client_t *c, long long since_seq,
                              tpumon_client_event_t *out, int max_events,
                              long long *last_seq) {
  // NEGATED error codes: a positive return is a fill count, and
  // TPUMON_SHIM_ERR_* constants are positive — returning one raw would
  // be indistinguishable from "that many events delivered"
  if (!c || (max_events > 0 && !out)) return -TPUMON_SHIM_ERR_INTERNAL;
  Json req;
  req.set("op", Json(std::string("events")));
  req.set("since_seq", Json(since_seq));
  auto resp = c->request(std::move(req));
  if (!resp) return -TPUMON_SHIM_ERR_INTERNAL;
  if (last_seq) *last_seq = (*resp)["last_seq"].as_int(0);
  const JsonArray &evs = (*resp)["events"].as_arr();
  int filled = 0;
  for (size_t i = 0; i < evs.size() && filled < max_events; i++) {
    const Json &e = evs[i];
    tpumon_client_event_t *d = &out[filled++];
    d->etype = static_cast<int>(e["etype"].as_int(0));
    d->chip_index = static_cast<int>(e["chip_index"].as_int(-1));
    d->timestamp = e["timestamp"].as_num(0);
    d->seq = e["seq"].as_int(0);
    copy_field(d->uuid, sizeof(d->uuid), e["uuid"]);
    copy_field(d->message, sizeof(d->message), e["message"]);
  }
  return filled;
}

}  // extern "C"
