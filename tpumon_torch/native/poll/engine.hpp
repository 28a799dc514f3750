// engine.hpp — the native poll plane: an epoll-driven connection
// engine owning the FleetPoller inner loop (sockets, non-blocking
// connect, hello/sweep_frame negotiation, frame reassembly and the
// per-connection delta tables) for one fleet tick at a time.
//
// Division of labour (docs/incremental_pipeline.md "native poll
// plane"):
//
//   * Python (tpumon_torch/fleetpoll.py NativeFleetPoller) stays the policy
//     plane: backoff schedule, reconnect budgets, error-string
//     formatting, sample construction, blackbox/stream/anomaly tees.
//     It decides per tick which hosts to SKIP (backoff / budget /
//     unresolvable) and pushes the pre-encoded binary sweep request
//     whenever (chip_count, events_since) moved.
//   * This engine is the mechanism plane: it drives every
//     non-skipped connection through the exact state machine of the
//     reference FleetPoller — the executable spec — and surfaces one
//     compact record per host WITH ACTIVITY (changed sweep, JSON
//     reply, error).  A steady host (index-only delta frame, no
//     events) produces NO record at all: its absence is the signal.
//
// Wire bytes are byte-identical to the reference: the hello line is
// pre-dumped by Python, binary sweep requests are pre-encoded by
// Python, and the two JSON request forms the engine must build
// mid-tick (the sweep_frame probe and the read_fields_bulk oracle)
// are assembled from a Python-pre-dumped `"fields":[...]` fragment in
// json.dumps' exact shape.  Reply JSON is parsed natively only far
// enough to make the reference's control-flow DECISIONS (ok truthy?
// "unknown op"? chip_count parseable?); the raw line rides along in
// the record so Python re-derives the exact reference error strings.
//
// The engine is single-threaded and lock-free by construction; the
// binding's busy flag (GIL-serialized) turns concurrent entry into a
// loud RuntimeError, as for every other native handle.  PyObject
// cookies dropped by frame applies while the GIL is released are
// accumulated in `released` and drained by the binding afterwards —
// the engine itself never touches Python.

#pragma once

#ifdef __linux__

#include <arpa/inet.h>
#include <fcntl.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/epoll.h>
#include <sys/socket.h>
#include <sys/un.h>
#include <unistd.h>

#include <cctype>
#include <cerrno>
#include <cstddef>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <ctime>
#include <memory>
#include <string>
#include <vector>

#include "core.hpp"
#include "json.hpp"

namespace tpumon {
namespace poll {

// record stages surfaced to Python (exported as module constants —
// tpumon_torch/fleetpoll.py matches on these)
enum Stage {
  OK_FRAME = 1,   // binary sweep applied, something changed
  OK_JSON = 2,    // read_fields_bulk reply line (raw JSON surfaced)
  IDLE_EOF = 3,   // kept connection reaped while idle/done (no error)
  ERR_CONNECT = 10,      // connect failed; err = errno
  ERR_SETUP = 11,        // socket()/setsockopt failed; err = errno
  ERR_SEND = 12,         // send failed; err = errno
  ERR_RECV = 13,         // recv failed; err = errno
  ERR_EOF = 14,          // "connection closed by agent"
  ERR_FRAME_DECODE = 15,  // detail = decoder core's error string
  ERR_BAD_JSON = 16,     // unparseable reply; detail = raw line
  ERR_NON_OBJECT = 17,   // JSON but not an object; detail = raw line
  ERR_DESYNC = 18,       // err = unexpected lead byte
  ERR_HELLO = 19,        // hello app error; detail = raw line
  ERR_HELLO_CHIPS = 20,  // hello missing chip_count; detail = raw line
  ERR_PROBE = 21,        // probe app error; detail = raw line
  ERR_JSON_APP = 22,     // read_fields_bulk app error; detail = raw line
  ERR_BINARY_WHERE_JSON = 23,  // binary frame while a JSON reply was due
  ERR_IDLE_JSON = 24,    // JSON reply while no reply was awaited
  ERR_DEADLINE = 25,     // tick deadline exceeded mid-sweep
};

struct Result {
  int host = -1;
  int stage = 0;
  int err = 0;             // errno (ERR_CONNECT/SETUP/SEND/RECV), lead byte
  long long changes = 0;   // OK_FRAME: decoder last_changes
  bool have_agg = false;   // OK_FRAME: native aggregate computed (no flags)
  codec::AggResult agg;
  std::string detail;      // error detail or raw reply line
  std::string hello;       // raw hello line, when hello landed this tick
  std::vector<std::string> events;  // raw piggybacked event submessages
  long long chip_count = 0;  // OK records: the connection's hello count
};

class Engine {
 public:
  // per-connection / per-tick states — the reference's module constants
  enum State { DOWN = 0, CONNECTING = 1, CONNECTED = 2 };
  enum Awaiting { AW_NONE = 0, AW_HELLO, AW_PROBE, AW_FRAME, AW_JSON };

  struct Conn {
    // immutable target
    int idx = -1;  // position in conns_ (epoll event cookie)
    bool is_unix = false;
    bool addr_ok = false;       // false => Python never unskips this host
    sockaddr_storage addr = {};
    socklen_t addr_len = 0;
    // connection state
    int fd = -1;
    int state = DOWN;
    uint32_t interest = 0;      // current epoll registration (0 = none)
    std::vector<uint8_t> in;    // capacity buffer; logical length below
    size_t in_off = 0;          // consumed prefix
    size_t in_len = 0;
    std::vector<uint8_t> out;   // pending output; [out_off, out_len)
    size_t out_off = 0;
    size_t out_len = 0;
    int awaiting = AW_NONE;
    std::unique_ptr<codec::DecoderCore> decoder;
    bool negotiated = false;    // per connection
    bool json_pinned = false;   // per HOST, forever
    bool have_hello = false;
    bool hello_fresh = false;   // hello accepted THIS tick
    std::string hello_line;
    long long chip_count = 0;
    std::string req_bytes;      // Python-pushed binary sweep request
    long long events_since = 0;  // Python-pushed event cursor
    bool has_steady = false;    // a sweep completed on this connection
    // per-tick
    bool done = true;
    bool retried = false;
    bool reused_conn = false;
    long long tick_bytes = 0;
    int sys_errno = 0;          // errno stash for dispatch return codes
  };

  Engine(std::string hello_bytes, std::string fields_frag,
         std::vector<unsigned long long> fields,
         const long long agg_fids[7], bool lazy)
      : hello_bytes_(std::move(hello_bytes)),
        fields_frag_(std::move(fields_frag)),
        fields_(std::move(fields)),
        lazy_(lazy) {
    for (int i = 0; i < 7; i++) agg_fids_[i] = agg_fids[i];
    // tpumon: close-ok(epfd_ is a member, not a local — ownership lands in the engine at assignment; the destructor and close_all both release it, binding dealloc included)
    epfd_ = epoll_create1(EPOLL_CLOEXEC);
  }

  ~Engine() { close_all(); }

  Engine(const Engine&) = delete;
  Engine& operator=(const Engine&) = delete;

  bool ok() const { return epfd_ >= 0; }

  // -- host registration (construction time, Python target order) ----------

  int add_unix(const std::string& path) {
    auto c = std::make_unique<Conn>();
    c->is_unix = true;
    auto* sa = reinterpret_cast<sockaddr_un*>(&c->addr);
    if (!path.empty() && path.size() <= sizeof(sa->sun_path)) {
      // CPython's getsockaddrarg accepts up to sizeof(sun_path) bytes
      // and passes a non-NUL-terminated name at exactly that length;
      // match it so the facade's too-long pre-check (> the limit) is
      // the only divergence gate
      sa->sun_family = AF_UNIX;
      std::memcpy(sa->sun_path, path.c_str(), path.size());
      socklen_t nul = path.size() < sizeof(sa->sun_path) ? 1 : 0;
      c->addr_len = static_cast<socklen_t>(
          offsetof(sockaddr_un, sun_path) + path.size() + nul);
      c->addr_ok = true;
    }
    c->idx = static_cast<int>(conns_.size());
    conns_.push_back(std::move(c));
    return static_cast<int>(conns_.size()) - 1;
  }

  int add_tcp(const std::string& ip, int port) {
    auto c = std::make_unique<Conn>();
    auto* sa = reinterpret_cast<sockaddr_in*>(&c->addr);
    sa->sin_family = AF_INET;
    sa->sin_port = htons(static_cast<uint16_t>(port));
    if (inet_pton(AF_INET, ip.c_str(), &sa->sin_addr) == 1) {
      c->addr_len = sizeof(sockaddr_in);
      c->addr_ok = true;
    }
    c->idx = static_cast<int>(conns_.size());
    conns_.push_back(std::move(c));
    return static_cast<int>(conns_.size()) - 1;
  }

  size_t host_count() const { return conns_.size(); }

  // -- Python-pushed per-host inputs ----------------------------------------

  void set_request(size_t i, const char* data, size_t n) {
    conns_[i]->req_bytes.assign(data, n);
  }

  void set_events_since(size_t i, long long es) {
    conns_[i]->events_since = es;
  }

  bool host_connected(size_t i) const {
    return conns_[i]->state == CONNECTED;
  }

  long long host_tick_bytes(size_t i) const {
    return conns_[i]->tick_bytes;
  }

  codec::DecoderCore* host_decoder(size_t i) const {
    Conn& c = *conns_[i];
    return (c.negotiated && c.decoder) ? c.decoder.get() : nullptr;
  }

  long long host_chip_count(size_t i) const { return conns_[i]->chip_count; }

  const std::vector<unsigned long long>& fields() const { return fields_; }

  // PyObject cookies dropped while the GIL was released; the binding
  // drains this (Py_DECREF) after every engine entry
  std::vector<void*>& released() { return released_; }

  const std::vector<Result>& results() const { return results_; }
  long long bytes_sent() const { return bytes_sent_; }
  long long bytes_recv() const { return bytes_recv_; }
  long long hello_count() const { return hello_count_; }

  // -- one fleet tick -------------------------------------------------------

  // skip[i] != 0 => host i does not participate this tick (Python owns
  // the decision: backoff, budget, unresolvable address)
  void tick(double timeout_s, const std::vector<uint8_t>& skip) {
    results_.clear();
    bytes_sent_ = 0;
    bytes_recv_ = 0;
    hello_count_ = 0;
    pending_ = 0;
    double now = mono();
    deadline_ = now + timeout_s;
    for (size_t i = 0; i < conns_.size(); i++) {
      Conn& c = *conns_[i];
      c.tick_bytes = 0;
      c.retried = false;
      c.hello_fresh = false;
      if (i < skip.size() && skip[i]) {
        c.done = true;
        continue;
      }
      c.done = false;
      pending_++;
      if (c.state == CONNECTED) {
        c.reused_conn = true;
        if (c.in_len > c.in_off) {
          // stray bytes arrived between ticks: desynchronized —
          // reconnect rather than misread (reused_conn stays true, so
          // a failed fresh dial still gets the one in-tick retry)
          teardown(c);
          begin_connect(c, static_cast<int>(i));
        } else {
          send_sweep(c, static_cast<int>(i));
        }
        continue;
      }
      c.reused_conn = false;
      begin_connect(c, static_cast<int>(i));
    }
    // the event loop: one shared monotonic deadline, exactly like the
    // reference (no per-host timers, no per-call socket timeouts)
    epoll_event evs[512];
    while (pending_ > 0) {
      now = mono();
      double wait = deadline_ - now;
      if (wait <= 0) break;
      int ms = static_cast<int>(wait * 1000.0) + 1;
      int n = epoll_wait(epfd_, evs, 512, ms);
      if (n < 0) {
        if (errno == EINTR) continue;
        break;
      }
      for (int e = 0; e < n; e++) {
        int idx = static_cast<int>(evs[e].data.u64);
        Conn& c = *conns_[static_cast<size_t>(idx)];
        if (c.done) {
          // level-triggered socket on a finished host: the event MUST
          // be consumed or epoll_wait spins at 100% until the deadline
          drain_idle(c, idx);
          continue;
        }
        handle_event(c, idx, evs[e].events);
      }
    }
    if (pending_ > 0) {
      for (size_t i = 0; i < conns_.size(); i++) {
        Conn& c = *conns_[i];
        if (!c.done) {
          teardown(c);
          finish(c, static_cast<int>(i), ERR_DEADLINE, 0);
        }
      }
    }
  }

  void close_all() {
    for (auto& cp : conns_) teardown(*cp);
    if (epfd_ >= 0) {
      ::close(epfd_);
      epfd_ = -1;
    }
  }

 private:
  // -- time -----------------------------------------------------------------

  static double mono() {
    timespec ts;
    clock_gettime(CLOCK_MONOTONIC, &ts);
    return static_cast<double>(ts.tv_sec) +
           static_cast<double>(ts.tv_nsec) * 1e-9;
  }

  // -- dispatch return codes ------------------------------------------------

  enum Act {
    ACT_NONE = 0,   // nothing further to do this event
    ACT_MSG,        // a complete message sits at the buffer head
    ACT_GROW,       // receive buffer full: grow and re-enter
    ACT_EOF,        // orderly shutdown from the agent
    ACT_RECV_ERR,   // recv failed; conn.sys_errno
    ACT_SEND_ERR,   // send failed; conn.sys_errno
    ACT_BAD_LEN,    // malformed sweep frame length varint
  };

  // The steady-tick dispatch path: one readiness event on an
  // established connection — flush pending output, pull bytes into
  // the preallocated buffer, scan for one complete message.  This is
  // the per-event engine shell the effect budget pins: no heap
  // allocation and no locking here; buffer growth and message
  // processing are routed back to the (unbudgeted) caller via the
  // Act code.
  int dispatch(Conn& c, bool readable, bool writable) {
    if (writable) {
      if (c.out_len > c.out_off) {
        ssize_t s = ::send(c.fd, c.out.data() + c.out_off,
                           c.out_len - c.out_off, MSG_NOSIGNAL);
        if (s < 0) {
          if (errno != EAGAIN && errno != EWOULDBLOCK && errno != EINTR) {
            c.sys_errno = errno;
            return ACT_SEND_ERR;
          }
        } else {
          bytes_sent_ += s;
          c.tick_bytes += s;
          c.out_off += static_cast<size_t>(s);
        }
      }
      if (c.out_off >= c.out_len) {
        c.out_off = 0;
        c.out_len = 0;
      }
      uint32_t want = c.state == CONNECTED ? EPOLLIN : 0u;
      if (c.out_len > c.out_off) want |= EPOLLOUT;
      set_interest(c, want);
    }
    if (readable) {
      while (true) {
        size_t room = c.in.size() - c.in_len;
        if (room == 0) return ACT_GROW;
        ssize_t n = ::recv(c.fd, c.in.data() + c.in_len, room, 0);
        if (n < 0) {
          if (errno == EAGAIN || errno == EWOULDBLOCK || errno == EINTR)
            break;
          c.sys_errno = errno;
          return ACT_RECV_ERR;
        }
        if (n == 0) return ACT_EOF;
        bytes_recv_ += n;
        c.tick_bytes += n;
        c.in_len += static_cast<size_t>(n);
        if (static_cast<size_t>(n) < room) break;  // short read: drained
      }
      return scan(c);
    }
    return ACT_NONE;
  }

  // Does [in_off, in_len) hold one complete message?  Framing only —
  // no state transitions, no allocation.
  int scan(Conn& c) {
    size_t avail = c.in_len - c.in_off;
    if (avail == 0) return ACT_NONE;
    const uint8_t* p = c.in.data() + c.in_off;
    uint8_t lead = p[0];
    if (lead == 0xA9) {  // SWEEP_FRAME_MAGIC
      unsigned long long length = 0;
      int shift = 0;
      size_t pos = 1;
      while (true) {
        if (pos >= avail) return ACT_NONE;
        uint8_t b = p[pos];
        pos++;
        length |= static_cast<unsigned long long>(b & 0x7F) << shift;
        if (!(b & 0x80)) break;
        shift += 7;
        if (shift > 63) return ACT_BAD_LEN;
      }
      if (length > avail || pos + static_cast<size_t>(length) > avail)
        return ACT_NONE;
      return ACT_MSG;
    }
    if (lead == '{') {
      const void* nl = std::memchr(p, '\n', avail);
      return nl != nullptr ? ACT_MSG : ACT_NONE;
    }
    return ACT_MSG;  // desynchronized lead byte: let processing report it
  }

  // -- event handling (unbudgeted: allocation allowed) ----------------------

  void handle_event(Conn& c, int idx, uint32_t ev) {
    bool readable = (ev & (EPOLLIN | EPOLLERR | EPOLLHUP)) != 0;
    bool writable = (ev & (EPOLLOUT | EPOLLERR | EPOLLHUP)) != 0;
    if (writable && c.state == CONNECTING) {
      int err = 0;
      socklen_t el = sizeof(err);
      getsockopt(c.fd, SOL_SOCKET, SO_ERROR, &err, &el);
      if (err != 0) {
        double now = mono();
        teardown(c);
        io_error(c, idx, ERR_CONNECT, err, now);
        return;
      }
      c.state = CONNECTED;
      c.interest = EPOLLOUT;  // still registered from the dial
      on_connected(c, idx);
      return;  // like the reference: the read edge is the next event
    }
    int act = dispatch(c, readable && !c.done, writable);
    while (act == ACT_GROW) {
      c.in.resize(c.in.size() < 4096 ? 8192 : c.in.size() * 2);
      act = dispatch(c, true, false);
    }
    switch (act) {
      case ACT_MSG:
        process_inbuf(c, idx);
        break;
      case ACT_EOF:
        io_error(c, idx, ERR_EOF, 0, mono());
        break;
      case ACT_RECV_ERR:
        io_error(c, idx, ERR_RECV, c.sys_errno, mono());
        break;
      case ACT_SEND_ERR:
        io_error(c, idx, ERR_SEND, c.sys_errno, mono());
        break;
      case ACT_BAD_LEN:
        io_error(c, idx, ERR_FRAME_DECODE, 0, mono(),
                 "malformed sweep frame length");
        break;
      default:
        break;
    }
  }

  void drain_idle(Conn& c, int idx) {
    // activity on a host whose tick already finished: EOF tears the
    // connection down now (next tick dials fresh), stray bytes are
    // kept for the tick-start desync check — the reference's
    // _drain_idle, plus an IDLE_EOF record so Python's
    // connected-mirror stays exact
    if (c.fd < 0) return;
    if (c.in_len == c.in.size())
      c.in.resize(c.in.size() < 4096 ? 8192 : c.in.size() * 2);
    ssize_t n = ::recv(c.fd, c.in.data() + c.in_len,
                       c.in.size() - c.in_len, 0);
    if (n < 0) {
      if (errno == EAGAIN || errno == EWOULDBLOCK || errno == EINTR) return;
      teardown(c);
      push_result(idx, IDLE_EOF, 0);
      return;
    }
    if (n == 0) {
      teardown(c);
      push_result(idx, IDLE_EOF, 0);
      return;
    }
    bytes_recv_ += n;
    c.tick_bytes += n;
    c.in_len += static_cast<size_t>(n);
  }

  // -- connection lifecycle -------------------------------------------------

  void begin_connect(Conn& c, int idx) {
    // unresolved/unaddressable hosts never reach the engine: Python
    // keeps them in the skip set and renders the resolver error itself
    int fd = ::socket(c.is_unix ? AF_UNIX : AF_INET,
                      SOCK_STREAM | SOCK_NONBLOCK | SOCK_CLOEXEC, 0);
    if (fd < 0) {
      io_error(c, idx, ERR_SETUP, errno, mono());
      return;
    }
    c.fd = fd;
    if (!c.is_unix) {
      int one = 1;
      if (setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one)) != 0) {
        int e = errno;
        teardown(c);
        io_error(c, idx, ERR_SETUP, e, mono());
        return;
      }
    }
    int rc = ::connect(fd, reinterpret_cast<sockaddr*>(&c.addr), c.addr_len);
    if (rc == 0) {
      c.state = CONNECTED;
      on_connected(c, idx);
      return;
    }
    int e = errno;
    if (e == EISCONN) {
      c.state = CONNECTED;
      on_connected(c, idx);
    } else if (e == EINPROGRESS || e == EAGAIN || e == EWOULDBLOCK ||
               e == EALREADY || e == EINTR) {
      c.state = CONNECTING;
      set_interest(c, EPOLLOUT);
    } else {
      teardown(c);
      io_error(c, idx, ERR_CONNECT, e, mono());
    }
  }

  void on_connected(Conn& c, int idx) {
    // fresh connection -> fresh delta tables on BOTH sides, fresh hello
    if (c.decoder) {
      c.decoder->release_all(&released_);
      c.decoder.reset();
    }
    c.negotiated = false;
    c.have_hello = false;
    c.hello_fresh = false;
    c.hello_line.clear();
    c.has_steady = false;
    c.in_off = 0;
    c.in_len = 0;
    c.out_off = 0;
    c.out_len = 0;
    if (c.in.empty()) c.in.resize(4096);
    c.awaiting = AW_HELLO;
    hello_count_++;
    queue_send(c, idx, hello_bytes_.data(), hello_bytes_.size());
  }

  void teardown(Conn& c) {
    if (c.fd >= 0) {
      if (c.interest != 0) epoll_ctl(epfd_, EPOLL_CTL_DEL, c.fd, nullptr);
      ::close(c.fd);
      c.fd = -1;
    }
    c.interest = 0;
    c.state = DOWN;
    c.awaiting = AW_NONE;
    if (c.decoder) {
      c.decoder->release_all(&released_);
      c.decoder.reset();
    }
    c.negotiated = false;
    c.have_hello = false;
    c.hello_line.clear();
    c.has_steady = false;
    c.in_off = 0;
    c.in_len = 0;
    c.out_off = 0;
    c.out_len = 0;
  }

  void set_interest(Conn& c, uint32_t events) {
    if (events == c.interest || c.fd < 0) return;
    epoll_event ev;
    std::memset(&ev, 0, sizeof(ev));
    ev.events = events;
    ev.data.u64 = static_cast<uint64_t>(c.idx);
    if (c.interest == 0) {
      epoll_ctl(epfd_, EPOLL_CTL_ADD, c.fd, &ev);
    } else if (events == 0) {
      epoll_ctl(epfd_, EPOLL_CTL_DEL, c.fd, nullptr);
    } else {
      epoll_ctl(epfd_, EPOLL_CTL_MOD, c.fd, &ev);
    }
    c.interest = events;
  }

  void queue_send(Conn& c, int idx, const char* data, size_t n) {
    if (c.fd >= 0 && c.out_len == c.out_off) {
      // fast path (every steady tick's request): straight to the
      // socket, buffer only the unsent remainder
      ssize_t sent = ::send(c.fd, data, n, MSG_NOSIGNAL);
      if (sent < 0) {
        if (errno == EAGAIN || errno == EWOULDBLOCK || errno == EINTR) {
          sent = 0;
        } else {
          io_error(c, idx, ERR_SEND, errno, mono());
          return;
        }
      }
      bytes_sent_ += sent;
      c.tick_bytes += sent;
      if (static_cast<size_t>(sent) == n) {
        if (c.interest != EPOLLIN && c.state == CONNECTED)
          set_interest(c, EPOLLIN);
        return;
      }
      c.out_off = 0;
      c.out_len = 0;
      out_append(c, data + sent, n - static_cast<size_t>(sent));
      uint32_t want = c.state == CONNECTED ? EPOLLIN : 0u;
      set_interest(c, want | EPOLLOUT);
      return;
    }
    out_append(c, data, n);
    flush(c, idx);
  }

  void out_append(Conn& c, const char* data, size_t n) {
    if (c.out_off > 0 && c.out_off == c.out_len) {
      c.out_off = 0;
      c.out_len = 0;
    }
    if (c.out_len + n > c.out.size()) c.out.resize(c.out_len + n);
    std::memcpy(c.out.data() + c.out_len, data, n);
    c.out_len += n;
  }

  void flush(Conn& c, int idx) {
    if (c.fd >= 0 && c.out_len > c.out_off) {
      ssize_t sent = ::send(c.fd, c.out.data() + c.out_off,
                            c.out_len - c.out_off, MSG_NOSIGNAL);
      if (sent < 0) {
        if (errno != EAGAIN && errno != EWOULDBLOCK && errno != EINTR) {
          io_error(c, idx, ERR_SEND, errno, mono());
          return;
        }
      } else {
        bytes_sent_ += sent;
        c.tick_bytes += sent;
        c.out_off += static_cast<size_t>(sent);
      }
    }
    uint32_t want = c.state == CONNECTED ? EPOLLIN : 0u;
    if (c.state == CONNECTING || c.out_len > c.out_off) want |= EPOLLOUT;
    set_interest(c, want);
  }

  // -- tick protocol --------------------------------------------------------

  void send_sweep(Conn& c, int idx) {
    if (c.json_pinned) {
      // JSON oracle fallback for old agents, byte-for-byte
      c.awaiting = AW_JSON;
      build_json_req(c, "read_fields_bulk");
      queue_send(c, idx, scratch_.data(), scratch_.size());
    } else if (c.negotiated) {
      c.awaiting = AW_FRAME;
      queue_send(c, idx, c.req_bytes.data(), c.req_bytes.size());
    } else {
      // first sweep of the connection: JSON probe, so an older agent
      // can answer a parseable "unknown op"
      c.awaiting = AW_PROBE;
      build_json_req(c, "sweep_frame");
      queue_send(c, idx, scratch_.data(), scratch_.size());
    }
  }

  // json.dumps(..., separators=(",", ":")) byte-exact: insertion order
  // op, reqs, events_since; each req {"index":c,<fields_frag>}
  void build_json_req(Conn& c, const char* op) {
    scratch_.clear();
    scratch_ += "{\"op\":\"";
    scratch_ += op;
    scratch_ += "\",\"reqs\":[";
    char num[32];
    for (long long i = 0; i < c.chip_count; i++) {
      if (i > 0) scratch_ += ',';
      scratch_ += "{\"index\":";
      snprintf(num, sizeof(num), "%lld", i);
      scratch_ += num;
      scratch_ += ',';
      scratch_ += fields_frag_;
      scratch_ += '}';
    }
    scratch_ += "],\"events_since\":";
    snprintf(num, sizeof(num), "%lld", c.events_since);
    scratch_ += num;
    scratch_ += "}\n";
  }

  void process_inbuf(Conn& c, int idx) {
    while (c.in_len > c.in_off && !c.done && c.awaiting != AW_NONE) {
      const uint8_t* p = c.in.data() + c.in_off;
      size_t avail = c.in_len - c.in_off;
      uint8_t lead = p[0];
      if (lead == 0xA9) {
        if (c.awaiting != AW_FRAME && c.awaiting != AW_PROBE) {
          io_error(c, idx, ERR_BINARY_WHERE_JSON, 0, mono());
          return;
        }
        // try_split_frame's exact framing, including its error string
        unsigned long long length = 0;
        int shift = 0;
        size_t pos = 1;
        bool incomplete = false;
        bool badlen = false;
        while (true) {
          if (pos >= avail) {
            incomplete = true;
            break;
          }
          uint8_t b = p[pos];
          pos++;
          length |= static_cast<unsigned long long>(b & 0x7F) << shift;
          if (!(b & 0x80)) break;
          shift += 7;
          if (shift > 63) {
            badlen = true;
            break;
          }
        }
        if (badlen) {
          io_error(c, idx, ERR_FRAME_DECODE, 0, mono(),
                   "malformed sweep frame length");
          return;
        }
        if (incomplete || length > avail ||
            pos + static_cast<size_t>(length) > avail) {
          compact(c);
          return;  // mid-frame: wait for more bytes (or the deadline)
        }
        if (!c.decoder)
          c.decoder = std::make_unique<codec::DecoderCore>(false);
        const uint8_t* payload = p + pos;
        size_t plen = static_cast<size_t>(length);
        codec::ApplyResult res = c.decoder->apply(payload, plen, &released_);
        if (!res.error.empty()) {
          io_error(c, idx, ERR_FRAME_DECODE, 0, mono(), res.error);
          return;
        }
        c.negotiated = true;
        bool has_events = !res.events.empty();
        if (res.changes == 0 && !has_events && c.has_steady) {
          // index-only steady frame: nothing moved since last tick —
          // NO record; Python reuses the cached sample (its absence
          // from the results IS the summary)
          c.in_off += pos + plen;
          c.awaiting = AW_NONE;
          finish_ok_silent(c);
          continue;
        }
        Result r;
        r.host = idx;
        r.stage = OK_FRAME;
        r.changes = res.changes;
        r.chip_count = c.chip_count;
        if (c.hello_fresh) {
          r.hello = c.hello_line;
          c.hello_fresh = false;
        }
        r.events.reserve(res.events.size());
        for (const auto& ev : res.events)
          r.events.emplace_back(
              reinterpret_cast<const char*>(payload) + ev.first, ev.second);
        c.in_off += pos + plen;
        if (lazy_) {
          // native mirror aggregate: no snapshot dicts at all on the
          // steady fleet path; any fallback flag routes Python to the
          // exact materialize + aggregate_host_sample path
          agg_reqs_.clear();
          agg_reqs_.reserve(static_cast<size_t>(c.chip_count));
          for (long long ch = 0; ch < c.chip_count; ch++)
            agg_reqs_.emplace_back(
                static_cast<unsigned long long>(ch), &fields_);
          codec::AggResult a = c.decoder->aggregate(
              agg_reqs_, c.chip_count, agg_fids_[0], agg_fids_[1],
              agg_fids_[2], agg_fids_[3], agg_fids_[4], agg_fids_[5],
              agg_fids_[6]);
          if (!a.overflow && !a.nan_error && !a.inf_error) {
            r.have_agg = true;
            r.agg = a;
          }
        }
        results_.push_back(std::move(r));
        c.awaiting = AW_NONE;
        c.has_steady = true;
        finish_ok_silent(c);
        continue;
      }
      if (lead == '{') {
        const void* nlp = std::memchr(p, '\n', avail);
        if (nlp == nullptr) {
          compact(c);
          return;  // mid-line: wait for more bytes (or the deadline)
        }
        size_t linelen =
            static_cast<size_t>(static_cast<const uint8_t*>(nlp) - p) + 1;
        std::string line(reinterpret_cast<const char*>(p), linelen);
        c.in_off += linelen;
        dispatch_json(c, idx, line);
        continue;
      }
      io_error(c, idx, ERR_DESYNC, lead, mono());
      return;
    }
    compact(c);
  }

  void compact(Conn& c) {
    if (c.in_off == 0) return;
    if (c.in_off == c.in_len) {
      c.in_off = 0;
      c.in_len = 0;
      return;
    }
    std::memmove(c.in.data(), c.in.data() + c.in_off, c.in_len - c.in_off);
    c.in_len -= c.in_off;
    c.in_off = 0;
  }

  // minimal truthiness of a parsed JSON value — Python bool(x) for
  // the types the wire can carry
  static bool truthy(const Json& v) {
    switch (v.type()) {
      case Json::Type::Null:
        return false;
      case Json::Type::Bool:
        return v.as_bool();
      case Json::Type::Number:
        return v.as_num() != 0.0;
      case Json::Type::String:
        return !v.as_str().empty();
      case Json::Type::Array:
        return !v.as_arr().empty();
      case Json::Type::Object:
        return !v.as_obj().empty();
    }
    return false;
  }

  // Python int(resp["chip_count"]) — number truncates toward zero,
  // strings parse strictly (whitespace-trimmed base-10), bools count
  // as 0/1; anything else is the reference's KeyError/TypeError path
  static bool parse_chip_count(const Json& v, long long* out) {
    switch (v.type()) {
      case Json::Type::Number:
        *out = static_cast<long long>(v.as_num());
        return true;
      case Json::Type::Bool:
        *out = v.as_bool() ? 1 : 0;
        return true;
      case Json::Type::String: {
        const std::string& s = v.as_str();
        size_t b = 0;
        size_t e = s.size();
        while (b < e && std::isspace(static_cast<unsigned char>(s[b]))) b++;
        while (e > b && std::isspace(static_cast<unsigned char>(s[e - 1])))
          e--;
        if (b >= e) return false;
        bool neg = false;
        if (s[b] == '+' || s[b] == '-') {
          neg = s[b] == '-';
          b++;
        }
        if (b >= e) return false;
        long long acc = 0;
        for (size_t i = b; i < e; i++) {
          if (s[i] < '0' || s[i] > '9') return false;
          acc = acc * 10 + (s[i] - '0');
        }
        *out = neg ? -acc : acc;
        return true;
      }
      default:
        return false;
    }
  }

  void dispatch_json(Conn& c, int idx, const std::string& line) {
    auto parsed = Json::parse(line);
    if (!parsed) {
      io_error(c, idx, ERR_BAD_JSON, 0, mono(), line);
      return;
    }
    if (parsed->type() != Json::Type::Object) {
      io_error(c, idx, ERR_NON_OBJECT, 0, mono(), line);
      return;
    }
    const Json& resp = *parsed;
    if (c.awaiting == AW_HELLO) {
      if (!truthy(resp["ok"])) {
        app_error(c, idx, ERR_HELLO, line);
        return;
      }
      long long cc = 0;
      if (!parse_chip_count(resp["chip_count"], &cc)) {
        app_error(c, idx, ERR_HELLO_CHIPS, line);
        return;
      }
      c.chip_count = cc;
      c.have_hello = true;
      c.hello_line = line;
      c.hello_fresh = true;
      send_sweep(c, idx);
      return;
    }
    if (c.awaiting == AW_PROBE) {
      const Json& err = resp["error"];
      if (!truthy(resp["ok"]) && err.type() == Json::Type::String &&
          err.as_str().find("unknown op") != std::string::npos) {
        // an old JSON-only agent: pin the oracle path for this HOST
        // forever, exactly like the reference
        c.json_pinned = true;
        send_sweep(c, idx);
        return;
      }
      app_error(c, idx, ERR_PROBE, line);
      return;
    }
    if (c.awaiting == AW_JSON) {
      if (!truthy(resp["ok"])) {
        app_error(c, idx, ERR_JSON_APP, line);
        return;
      }
      Result r;
      r.host = idx;
      r.stage = OK_JSON;
      r.detail = line;  // Python decodes chips/events from the raw line
      r.chip_count = c.chip_count;
      if (c.hello_fresh) {
        r.hello = c.hello_line;
        c.hello_fresh = false;
      }
      results_.push_back(std::move(r));
      c.awaiting = AW_NONE;
      c.has_steady = true;
      finish_ok_silent(c);
      return;
    }
    io_error(c, idx, ERR_IDLE_JSON, 0, mono());
  }

  // -- failure handling -----------------------------------------------------

  void io_error(Conn& c, int idx, int stage, int err, double now,
                std::string detail = std::string()) {
    teardown(c);
    if (c.done) return;
    if (c.reused_conn && !c.retried && now + 0.01 < deadline_) {
      // the kept socket died between ticks (agent restart, idle
      // reap): one fresh-connection retry within the tick, charged
      // against the SAME deadline
      c.retried = true;
      c.reused_conn = false;
      begin_connect(c, idx);
      return;
    }
    finish(c, idx, stage, err, std::move(detail));
  }

  void app_error(Conn& c, int idx, int stage, const std::string& line) {
    // the agent answered, but with an application error: no retry —
    // its protocol state is not one the tick machine can resume from
    teardown(c);
    finish(c, idx, stage, 0, line);
  }

  void finish(Conn& c, int idx, int stage, int err,
              std::string detail = std::string()) {
    Result r;
    r.host = idx;
    r.stage = stage;
    r.err = err;
    r.detail = std::move(detail);
    results_.push_back(std::move(r));
    finish_ok_silent(c);
  }

  void finish_ok_silent(Conn& c) {
    if (!c.done) {
      c.done = true;
      pending_--;
    }
  }

  void push_result(int idx, int stage, int err) {
    Result r;
    r.host = idx;
    r.stage = stage;
    r.err = err;
    results_.push_back(std::move(r));
  }

  // -- members --------------------------------------------------------------

  std::string hello_bytes_;
  std::string fields_frag_;
  std::vector<unsigned long long> fields_;
  long long agg_fids_[7] = {0, 0, 0, 0, 0, 0, 0};
  bool lazy_ = false;
  int epfd_ = -1;
  double deadline_ = 0;
  long long pending_ = 0;
  long long bytes_sent_ = 0;
  long long bytes_recv_ = 0;
  long long hello_count_ = 0;
  std::vector<std::unique_ptr<Conn>> conns_;
  std::vector<Result> results_;
  std::vector<void*> released_;
  std::string scratch_;
  std::vector<std::pair<unsigned long long,
                        const std::vector<unsigned long long>*>>
      agg_reqs_;
};

}  // namespace poll
}  // namespace tpumon

#endif  // __linux__
