"""The live streaming plane: a reusable serve loop and the subscription
plane on it.

The port's copy of ``tpumon/frameserver.py``, imports renamed.  The
exporter daemon (``python -m tpumon_torch.exporter.main --stream-port P``)
owns one :class:`FrameServer` and one :class:`StreamPublisher`, and its
sweep tees every snapshot into it right after the flight recorder:

* :class:`FrameServer` — a selector-driven, non-blocking server for the
  agent wire protocol's framing (binary ``0xA6`` requests, JSON line
  ops, plain text request lines); one loop thread owns every socket.
* :class:`StreamPublisher` — one logical stream of sweeps.  The owner
  calls :meth:`~StreamPublisher.publish` once per sweep; the sweep is
  encoded into a delta frame **once** (the
  :class:`~tpumon_torch.sweepframe.SweepFrameEncoder` codec the flight
  recorder uses) and the already-encoded bytes are teed to every
  subscriber.  One encode, N sends.
* :class:`StreamHub` — the :class:`FrameServer` handler exposing the
  attach surface: a JSON line op ``{"op": "stream"}`` or a plain
  ``GET /stream`` HTTP request (length-prefixed frames over HTTP —
  ``curl`` works), answered with the record stream below.
* :class:`StreamDecoder` — the incremental client half (``python -m
  tpumon_torch.cli.stream``, tests).

Wire format: the stream IS a live flight-recorder segment
(:mod:`tpumon_torch.blackbox` record framing) — ``0xB0`` stream header,
then per sweep a ``0xB1`` tick record followed by a ``0xA9``
:class:`~tpumon_torch.sweepframe.SweepFrameEncoder` frame, and the
anomaly plane's ``0xB3`` findings between them.  A subscriber that
attaches mid-run gets a **keyframe**: a full-snapshot frame built from
the publisher's last published state, carrying the shared stream's
current frame index so the live delta frames that follow apply without a
discontinuity (``SweepFrameDecoder``'s ``adopt_first_index`` mode).
``python -m tpumon_torch.cli.replay --follow`` is the file-based twin of
this stream.

Backpressure: every subscriber has a bounded send buffer
(``max_buffer_bytes``).  A subscriber too slow to drain it is marked
**stale**: publishes stop being queued for it (never unbounded
buffering, never a sweep-path stall), and once its buffer drains the
next publish resyncs it with a fresh keyframe.  Events published
while a subscriber is stale are not replayed to it — the stream is a
live view, not a durable log (that is the flight recorder's job).

Threading model: the :class:`FrameServer` loop thread owns every
socket, connection buffer and subscriber table.  ``publish()`` runs
on the caller's thread and touches only publisher-owned encoder
state; the fan-out itself is posted to the loop thread, so the sweep
path never blocks on subscriber sockets.  The relay side of the
publisher (:meth:`StreamPublisher.forward`, ``forward_heartbeat``) serves
the relay tree (:mod:`tpumon_torch.relay`); the port's agent
(:mod:`tpumon_torch.hostengine`) serves its op set on a
:class:`FrameServer` too.
"""

from __future__ import annotations

import collections
import errno
import json
import os
import selectors
import socket
import tempfile
import threading
import time
from typing import (Any, Callable, Deque, Dict, List, Optional, Set,
                    Tuple, Union)

from . import log
from .backends.base import FieldValue
from .blackbox import (ANOMALY_MAGIC, FORMAT_VERSION, KMSG_MAGIC,
                       SEG_HEADER_MAGIC, TICK_MAGIC, _TICK_KEYFRAME,
                       _TICK_STALE, _decode_finding, _decode_header,
                       _decode_tick, _frame_record, AnomalyRecord,
                       ReplayTick)
from .events import Event
from .sweepframe import (SWEEP_FRAME_MAGIC, SWEEP_REQ_MAGIC,
                         SweepFrameDecoder, SweepFrameEncoder,
                         try_split_frame)
from .wire import write_bytes_field, write_double_field, write_varint_field

#: default per-subscriber send-buffer bound.  At 256 chips a
#: full-churn frame is ~60 KB, so the default absorbs ~16 worst-case
#: sweeps (or thousands of steady ticks) before a subscriber is
#: declared stale and dropped to keyframe.
DEFAULT_SUB_BUFFER = 1 << 20

#: per-connection inbound buffer cap.  Every legitimate request on
#: either surface (binary sweep req, JSON op line, HTTP attach) is
#: tiny; a client that streams more unframed bytes than this — e.g. a
#: binary header declaring a huge length — is dropped instead of
#: growing server memory without bound.
MAX_INBUF_BYTES = 1 << 18

#: HTTP attach path served by :class:`StreamHub`
STREAM_PATH = "/stream"

_HTTP_OK = (b"HTTP/1.1 200 OK\r\n"
            b"Content-Type: application/x-tpumon-framestream\r\n"
            b"Cache-Control: no-store\r\n"
            b"\r\n")


def _tick_record(ts: float, keyframe: bool, stale: bool = False) -> bytes:
    """One ``0xB1`` tick record (the blackbox format, live).

    ``stale`` sets flags bit 1 — a relay serving its last-known mirror
    while its upstream is unreachable (docs/streaming.md)."""

    body = bytearray()
    write_double_field(body, 1, ts)
    flags = (_TICK_KEYFRAME if keyframe else 0) | \
        (_TICK_STALE if stale else 0)
    write_varint_field(body, 2, flags)
    return _frame_record(TICK_MAGIC, body)


class FrameConn:
    """One accepted connection (loop-thread-owned)."""

    def __init__(self, sock: socket.socket, handler: "ConnHandler",
                 address: str) -> None:
        self.sock = sock
        self.handler = handler
        #: the listener address this connection arrived on
        self.address = address
        self.inbuf = bytearray()
        #: pending sends: [due_monotonic, data, offset, close_after]
        self.outq: Deque[List[Any]] = collections.deque()
        self.want_write = False
        #: total unsent payload bytes across the queue — the
        #: backpressure meter the subscription plane bounds
        self.queued_bytes = 0
        #: set by a handler that has seen everything it needs (HTTP
        #: subscribers send headers we never parse): inbound bytes are
        #: discarded instead of framed
        self.discard_input = False
        #: handler scratch (per-connection protocol state)
        self.data: Dict[str, Any] = {}


class ConnHandler:
    """Per-listener protocol callbacks, invoked on the loop thread.

    The default for every inbound message is to close the connection:
    a listener serves exactly the surface its handler overrides."""

    def on_json(self, server: "FrameServer", conn: FrameConn,
                req: Dict[str, Any]) -> None:
        server.close_conn(conn)

    def on_binary(self, server: "FrameServer", conn: FrameConn,
                  payload: bytes) -> None:
        server.close_conn(conn)

    def on_text(self, server: "FrameServer", conn: FrameConn,
                line: str) -> None:
        server.close_conn(conn)

    def on_close(self, server: "FrameServer", conn: FrameConn) -> None:
        pass

    def on_malformed(self, server: "FrameServer", conn: FrameConn,
                     line: bytes) -> None:
        """A request line that starts with ``{`` but is not a JSON
        object.  Default: close the connection."""

        server.close_conn(conn)


class FrameServer:
    """Selector-driven, non-blocking server for the agent wire
    protocol's framing: binary ``0xA6`` requests, JSON line ops, and
    (for the streaming plane) plain text request lines.  One loop
    thread hosts any number of listeners; per-listener
    :class:`ConnHandler` objects implement the actual protocol
    (the reference's ``AgentFarm`` for the agent surface,
    :class:`StreamHub` for the subscription plane).

    Scheduling: sends may carry a delay and a drip (slow-loris) plan —
    the fault knobs the simulated farm scripts — and are pumped by the
    loop thread with per-item due times.  ``send``/``close_conn``/
    ``run_on_loop`` are safe from any thread; everything else is
    loop-thread-only.
    """

    def __init__(self) -> None:
        self._sel = selectors.DefaultSelector()
        self._listeners: Dict[socket.socket, Tuple[ConnHandler, str]] = {}
        self._conns: Dict[socket.socket, FrameConn] = {}
        #: conns with bytes waiting to leave
        self._queued: Set[FrameConn] = set()
        self._paths: List[str] = []
        # partial-constructor discipline: the selector and the
        # doorbell pair are the OS resources here — a raise between
        # acquiring them (fd exhaustion is exactly when it happens)
        # must release what was already acquired
        try:
            self._cmd_r, self._cmd_w = socket.socketpair()
        except BaseException:
            self._sel.close()
            raise
        try:
            self._cmd_r.setblocking(False)
            self._sel.register(self._cmd_r, selectors.EVENT_READ, "cmd")
        except BaseException:
            self._cmd_r.close()
            self._cmd_w.close()
            self._sel.close()
            raise
        self._cmds: List[Callable[[], None]] = []
        self._cmd_lock = threading.Lock()
        self._stop = False
        self._thread: Optional[threading.Thread] = None
        self._loop_ident = -1
        self.bytes_in = 0
        self.bytes_out = 0

    # -- setup / control (any thread) -----------------------------------------

    def add_unix_listener(self, handler: ConnHandler,
                          path: Optional[str] = None) -> str:
        """Listen on a unix socket; returns the ``unix:...`` address.
        Callable before :meth:`start` (registered inline) or on a live
        server (registration posted to the loop thread — how a healed
        partition re-serves the endpoint ``close_listener`` dropped)."""

        path = path or tempfile.mktemp(prefix="tpumon-frames-",
                                       suffix=".sock")
        srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        try:
            srv.bind(path)
            srv.listen(128)
            srv.setblocking(False)
        except OSError:
            # bind/listen failure must not leak the listener fd — nor
            # the socket FILE a successful bind() already created
            srv.close()
            try:
                os.unlink(path)
            except OSError:
                pass
            raise
        address = f"unix:{path}"
        self._paths.append(path)
        self._install_listener(srv, handler, address)
        return address

    def add_tcp_listener(self, handler: ConnHandler,
                         host: str = "127.0.0.1", port: int = 0) -> str:
        """Listen on TCP; returns the bound ``host:port`` address
        (``port=0`` = kernel-assigned).  Callable before :meth:`start`
        or on a live server (see :meth:`add_unix_listener`)."""

        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        try:
            srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            srv.bind((host, port))
            srv.listen(128)
            srv.setblocking(False)
        except OSError:
            srv.close()
            raise
        bound = srv.getsockname()
        address = f"{bound[0]}:{bound[1]}"
        self._install_listener(srv, handler, address)
        return address

    def _install_listener(self, srv: socket.socket, handler: ConnHandler,
                          address: str) -> None:
        # the listener tables and the selector belong to the loop
        # thread once it runs; a post-start add must hand the
        # registration over instead of racing the live select()
        def _install() -> None:
            self._listeners[srv] = (handler, address)
            self._sel.register(srv, selectors.EVENT_READ, "accept")

        if self._thread is not None:
            self.run_on_loop(_install)
        else:
            _install()

    def start(self) -> None:
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="tpumon-frameserver")
        self._thread.start()

    def run_on_loop(self, fn: Callable[[], None]) -> None:
        """Run ``fn`` on the loop thread at the next loop turn (the
        cross-thread entry point — fan-outs, kills, stop)."""

        with self._cmd_lock:
            self._cmds.append(fn)
        try:
            # tpumon: thread-ok(the socketpair write end is the designed cross-thread doorbell: one-byte sends are atomic and only the loop thread reads the other end)
            self._cmd_w.send(b"x")
        except OSError:
            pass

    def send(self, conn: FrameConn, data: bytes, *,
             delay_s: float = 0.0, drip_chunk: int = 0,
             drip_interval_s: float = 0.0,
             close_after: bool = False) -> None:
        """Queue ``data`` on ``conn`` (any thread).  ``data`` is held
        by reference — a broadcast enqueues ONE bytes object on N
        connections with zero copies."""

        if threading.get_ident() == self._loop_ident:
            self._enqueue(conn, data, delay_s, drip_chunk,
                          drip_interval_s, close_after)
        else:
            self.run_on_loop(lambda: self._enqueue(
                conn, data, delay_s, drip_chunk, drip_interval_s,
                close_after))

    def close_conn(self, conn: FrameConn) -> None:
        """Close one connection (any thread)."""

        if threading.get_ident() == self._loop_ident:
            self._drop(conn)
        else:
            self.run_on_loop(lambda: self._drop(conn))

    def kill_connections(self, address: str) -> None:
        """Close every live connection accepted on ``address`` (an
        agent restart in the sim: the next connection starts fresh
        server-side state)."""

        def _kill() -> None:
            for conn in list(self._conns.values()):
                if conn.address == address:
                    self._drop(conn)

        self.run_on_loop(_kill)

    def close_listener(self, address: str) -> None:
        """Stop accepting on ``address`` and drop its live connections
        (the chaos harness's lost-endpoint fault: subsequent connects
        fail outright, unlike :meth:`kill_connections` where the next
        dial succeeds).  Safe from any thread; the listener is gone for
        good — re-serving means a new listener."""

        def _close() -> None:
            for srv, (_h, addr) in list(self._listeners.items()):
                if addr != address:
                    continue
                del self._listeners[srv]
                try:
                    self._sel.unregister(srv)
                except (KeyError, ValueError):
                    pass
                try:
                    srv.close()
                except OSError:
                    pass
                if addr.startswith("unix:"):
                    path = addr[5:]
                    try:
                        os.unlink(path)
                    except OSError:
                        pass
                    if path in self._paths:
                        self._paths.remove(path)
            for conn in list(self._conns.values()):
                if conn.address == address:
                    self._drop(conn)

        self.run_on_loop(_close)

    def close(self) -> None:
        def _stop() -> None:
            self._stop = True

        if self._thread is not None:
            self.run_on_loop(_stop)
            self._thread.join(timeout=10.0)
            self._thread = None
        else:
            # never started: tear down inline (same teardown the loop
            # runs on exit)
            self._teardown()
        for path in self._paths:
            try:
                os.unlink(path)
            except OSError:
                pass

    # -- event loop (loop thread) ---------------------------------------------

    def _loop(self) -> None:
        self._loop_ident = threading.get_ident()
        while not self._stop:
            now = time.monotonic()
            timeout = self._next_due(now)
            events = self._sel.select(timeout)
            for key, mask in events:
                if key.data == "cmd":
                    self._drain_commands()
                elif key.data == "accept":
                    self._accept(key.fileobj)  # type: ignore[arg-type]
                else:
                    conn = self._conns.get(key.fileobj)  # type: ignore[arg-type]
                    if conn is None:
                        continue
                    if mask & selectors.EVENT_READ:
                        self._read(conn)
                    if (mask & selectors.EVENT_WRITE
                            and conn.sock in self._conns):
                        self._pump(conn, time.monotonic())
            if self._queued:
                now = time.monotonic()
                for conn in list(self._queued):
                    if (not conn.want_write and conn.outq
                            and conn.outq[0][0] <= now):
                        self._pump(conn, now)
        self._teardown()

    def _teardown(self) -> None:
        for conn in list(self._conns.values()):
            self._drop(conn)
        for srv in list(self._listeners):
            try:
                self._sel.unregister(srv)
            except (KeyError, ValueError):
                pass
            srv.close()
        self._listeners.clear()
        try:
            self._sel.unregister(self._cmd_r)
        except (KeyError, ValueError):
            pass
        self._cmd_r.close()
        self._cmd_w.close()
        self._sel.close()

    def _next_due(self, now: float) -> Optional[float]:
        due = None
        for conn in self._queued:
            if conn.want_write:
                # blocked on an unwritable socket: EVENT_WRITE wakes
                # the loop — a zero timeout here would busy-spin on a
                # wedged subscriber until its buffer drained
                continue
            if conn.outq:
                d = conn.outq[0][0] - now
                if due is None or d < due:
                    due = d
        if due is None:
            return None
        return max(0.0, due)

    def _drain_commands(self) -> None:
        try:
            while self._cmd_r.recv(4096):
                pass
        except OSError:
            pass
        with self._cmd_lock:
            cmds, self._cmds = self._cmds, []
        for fn in cmds:
            try:
                fn()
            except Exception as e:  # noqa: BLE001 — one bad command
                # must not kill the loop thread that every listener,
                # subscriber and publisher depends on
                log.warn_every("frameserver.cmd", 30.0,
                               "loop command failed: %r", e)

    def _accept(self, srv: socket.socket) -> None:
        handler, address = self._listeners[srv]
        while True:
            try:
                # the listener is non-blocking: accept never waits, it
                # returns EWOULDBLOCK when the backlog is drained
                sock, _ = srv.accept()  # tpumon-lint: disable=blocking-socket-in-fleetpoll
            except (BlockingIOError, InterruptedError):
                return
            except OSError:
                return
            sock.setblocking(False)
            if sock.family == socket.AF_INET:
                try:
                    sock.setsockopt(socket.IPPROTO_TCP,
                                    socket.TCP_NODELAY, 1)
                except OSError:
                    pass
            conn = FrameConn(sock, handler, address)
            self._conns[sock] = conn
            self._sel.register(sock, selectors.EVENT_READ, "conn")

    def _drop(self, conn: FrameConn) -> None:
        self._queued.discard(conn)
        if self._conns.pop(conn.sock, None) is None:
            return  # already dropped
        try:
            self._sel.unregister(conn.sock)
        except (KeyError, ValueError):
            pass
        try:
            conn.sock.close()
        except OSError:
            pass
        conn.outq.clear()
        conn.queued_bytes = 0
        try:
            conn.handler.on_close(self, conn)
        except Exception as e:  # noqa: BLE001 — teardown callbacks
            # must not take the loop down with them
            log.warn_every("frameserver.onclose", 30.0,
                           "handler on_close failed: %r", e)

    def _set_events(self, conn: FrameConn, want_write: bool) -> None:
        if conn.want_write == want_write or conn.sock not in self._conns:
            return
        conn.want_write = want_write
        events = selectors.EVENT_READ
        if want_write:
            events |= selectors.EVENT_WRITE
        self._sel.modify(conn.sock, events, "conn")

    # -- reading / framing ----------------------------------------------------

    def _read(self, conn: FrameConn) -> None:
        try:
            chunk = conn.sock.recv(65536)
        except (BlockingIOError, InterruptedError):
            return
        except OSError:
            self._drop(conn)
            return
        if not chunk:
            self._drop(conn)
            return
        self.bytes_in += len(chunk)
        if conn.discard_input:
            return  # a subscribed HTTP client's header tail: noise
        conn.inbuf += chunk
        try:
            self._parse(conn)
        except Exception as e:  # noqa: BLE001 — a malformed frame or
            # a raising handler is one bad CLIENT; it must never take
            # down the loop thread every listener and subscriber share
            log.warn_every("frameserver.parse", 30.0,
                           "dropping connection on parse/handler "
                           "error: %r", e)
            self._drop(conn)
            return
        if len(conn.inbuf) > MAX_INBUF_BYTES:
            log.warn_every("frameserver.inbuf", 30.0,
                           "dropping connection: %d unframed inbound "
                           "bytes (cap %d)", len(conn.inbuf),
                           MAX_INBUF_BYTES)
            self._drop(conn)

    def _parse(self, conn: FrameConn) -> None:
        handler = conn.handler
        while conn.inbuf and conn.sock in self._conns:
            if conn.discard_input:
                conn.inbuf.clear()
                return
            if conn.inbuf[0] == SWEEP_REQ_MAGIC:
                parsed = try_split_frame(conn.inbuf)
                if parsed is None:
                    return  # incomplete binary request: need more bytes
                payload, used = parsed
                del conn.inbuf[:used]
                handler.on_binary(self, conn, payload)
                continue
            nl = conn.inbuf.find(b"\n")
            if nl < 0:
                return
            line = bytes(conn.inbuf[:nl])
            del conn.inbuf[:nl + 1]
            if not line.strip():
                continue
            if line.lstrip().startswith(b"{"):
                try:
                    req = json.loads(line)  # tpumon-lint: disable=json-in-sweep-path
                    # (op parse, once per request line — the steady
                    # tee path is binary records only)
                except ValueError:
                    req = None
                if not isinstance(req, dict):
                    handler.on_malformed(self, conn, line)
                    continue
                handler.on_json(self, conn, req)
            else:
                handler.on_text(self, conn,
                                line.decode("utf-8",
                                            "replace").rstrip("\r"))

    # -- writing (loop thread) ------------------------------------------------

    def _enqueue(self, conn: FrameConn, data: bytes, delay_s: float,
                 drip_chunk: int, drip_interval_s: float,
                 close_after: bool) -> None:
        if conn.sock not in self._conns:
            return  # died before the send landed
        now = time.monotonic()
        due = now + delay_s
        if drip_chunk > 0:
            chunks = [data[i:i + drip_chunk]
                      for i in range(0, len(data), drip_chunk)]
            for i, chunk in enumerate(chunks):
                conn.outq.append([due + i * drip_interval_s, chunk, 0,
                                  close_after and i == len(chunks) - 1])
        else:
            conn.outq.append([due, data, 0, close_after])
        conn.queued_bytes += len(data)
        self._queued.add(conn)
        self._pump(conn, now)

    def _pump(self, conn: FrameConn, now: float) -> None:
        while conn.outq and conn.outq[0][0] <= now:
            item = conn.outq[0]
            data, off = item[1], item[2]
            try:
                # a shared broadcast buffer is never mutated: each
                # connection tracks its own offset and sends a
                # zero-copy view of the tail
                sent = conn.sock.send(
                    memoryview(data)[off:] if off else data)
            except (BlockingIOError, InterruptedError):
                self._set_events(conn, True)
                return
            except OSError:
                self._drop(conn)
                return
            self.bytes_out += sent
            conn.queued_bytes -= sent
            item[2] = off + sent
            if item[2] < len(data):
                self._set_events(conn, True)
                return
            conn.outq.popleft()
            if item[3]:
                self._drop(conn)
                return
        if not conn.outq:
            self._queued.discard(conn)
        self._set_events(conn, False)


# -- subscription plane --------------------------------------------------------


class _SubState:
    """Per-subscriber fan-out state (loop-thread-owned)."""

    __slots__ = ("stale", "next_index")

    def __init__(self) -> None:
        #: waiting for a keyframe: either freshly attached before the
        #: first publish, or dropped after a send-buffer overflow
        self.stale = False
        #: frame index this subscriber expects next — attach/resync
        #: keyframes cover the frame they were built from, so the
        #: fan-out skips frames the keyframe already contains
        self.next_index = 0


class StreamPublisher:
    """One logical stream of sweeps, teed to N subscribers.

    The OWNER thread (exporter sweep loop, fleet poller) calls
    :meth:`publish` once per sweep; encoder state (`the` shared delta
    table) is owner-thread-only.  Subscriber state lives on the
    :class:`FrameServer` loop thread; publish posts the already-encoded
    bytes there.  The publish cost is one delta-table pass per sweep —
    the same bill the flight-recorder tee pays — independent of the
    subscriber count.
    """

    def __init__(self, server: FrameServer, name: str = "",
                 max_buffer_bytes: int = DEFAULT_SUB_BUFFER) -> None:
        self._server = server
        self.name = name
        self.max_buffer_bytes = int(max_buffer_bytes)
        self._enc = SweepFrameEncoder()
        self._index = -1          # last published frame index
        #: (chips, index, wall_ts) of the last publish — written by the
        #: owner thread as one atomic reference swap, read by the loop
        #: thread to build attach keyframes.  The chips dict is held
        #: under the pipeline's read-only snapshot contract.
        self._capture: Optional[
            Tuple[Dict[int, Dict[int, FieldValue]], int, float]] = None
        self._subs: Dict[FrameConn, _SubState] = {}   # loop thread
        #: owner-thread-written staleness bit: a relay sets it while
        #: its upstream is unreachable, so attach keyframes built on
        #: the loop thread carry the stale tick flag.  Single-writer
        #: bool read without the loop — a racing attach at the exact
        #: transition mislabels at most one keyframe's flag, which the
        #: next tick (stale heartbeat or live frame) corrects.
        # tpumon: thread-ok(single-writer owner-thread bool; a stale attach at the transition instant mislabels one keyframe flag which the next forwarded tick corrects)
        self.stale_flag = False
        # -- self-metric counters (tpumon_stream_*) --
        self.subscribers_total = 0
        self.frames_sent_total = 0
        self.keyframes_total = 0
        self.bytes_sent_total = 0
        self.dropped_frames_total = 0
        self.overflows_total = 0
        self.resyncs_total = 0
        self.heartbeats_total = 0

    @property
    def subscribers(self) -> int:
        return len(self._subs)

    @staticmethod
    def _keyframe_bytes(chips: Dict[int, Dict[int, FieldValue]],
                        index: int, ts: float, *, stale: bool,
                        events: Optional[List[Event]] = None) -> bytes:
        """The ONE definition of a synthesized keyframe: a keyframe
        (+optionally stale) flagged tick, then a full-snapshot frame
        carrying the stream's current ``index`` so the delta frames
        that follow apply without a discontinuity.  Every attach and
        resync path (publish, forward, heartbeat, attach) builds its
        keyframe here — the stale-flag semantics cannot drift between
        them."""

        kfe = SweepFrameEncoder(start_index=index)
        return _tick_record(ts, True, stale) + kfe.encode_frame(chips,
                                                                events)

    # tpumon: thread-ok(every counter has a single writer — the loop thread — so increments never tear; scrape-side readers take a stale-but-consistent int snapshot, asserted monotone by test_concurrency.py)
    def stats(self) -> Dict[str, int]:
        """Counter snapshot for the ``tpumon_stream_*`` families."""

        return {
            "subscribers": len(self._subs),
            "subscribers_total": self.subscribers_total,
            "frames_sent_total": self.frames_sent_total,
            "keyframes_total": self.keyframes_total,
            "bytes_sent_total": self.bytes_sent_total,
            "dropped_frames_total": self.dropped_frames_total,
            "overflows_total": self.overflows_total,
            "resyncs_total": self.resyncs_total,
            "heartbeats_total": self.heartbeats_total,
        }

    # -- owner thread ---------------------------------------------------------

    # tpumon: thread-ok(owner-thread contract: each publisher instance is driven by exactly ONE sweep-role thread — the exporter loop or the fleet poller, never both; the _subs emptiness probe is the documented benign race whose only miss is one skipped fan-out already covered by the attach keyframe)
    def publish(self, chips: Dict[int, Dict[int, FieldValue]],
                events: Optional[List[Event]] = None,
                now: Optional[float] = None,
                unchanged: bool = False) -> None:
        """Tee one sweep to every subscriber.

        ``unchanged=True`` (the fleet poller's index-only shortcut)
        skips the delta-table compare and ships a frame-index-only
        frame; only pass it when the sweep is KNOWN identical to the
        previous one.  ``now`` is the sweep's wall timestamp — the
        same correlation key the flight recorder stamps."""

        if now is None:
            # wall clock on purpose: stream ticks carry the same
            # replay-correlation timestamps the black box records
            now = time.time()  # tpumon-lint: disable=wallclock-in-sampling
        if unchanged and not events:
            frame = self._enc.encode_index_only_frame()
        else:
            frame = self._enc.encode_frame(chips, events)
        self._index += 1
        idx = self._index
        payload = _tick_record(now, False) + frame
        # capture BEFORE posting the fan-out: a subscriber attaching in
        # between gets a keyframe covering this frame, and the fan-out
        # skips it via next_index — either order is consistent
        self._capture = (chips, idx, now)
        if not self._subs:
            # nobody attached: the delta table and capture stay
            # current (a mid-publish attach gets its keyframe from the
            # capture above), but skip the per-tick cross-thread
            # wakeup — 256 idle fleet streams must cost the loop
            # thread nothing.  Benign race: _subs is loop-owned and
            # read here without the loop; the only miss is one skipped
            # fan-out for a subscriber whose attach is still in flight,
            # which its attach keyframe already covers.
            return
        ev = list(events) if events else None

        def make_keyframe() -> bytes:
            return self._keyframe_bytes(chips, idx, now, stale=False,
                                        events=ev)

        self._server.run_on_loop(
            lambda: self._fanout(idx, payload, make_keyframe))

    # tpumon: thread-ok(owner-thread contract like publish: the _subs emptiness probe is the same documented benign race — the only miss is one skipped record for a subscriber whose attach is still in flight, which rejoins at its attach keyframe)
    def publish_record(self, data: bytes) -> None:
        """Tee one already-framed auxiliary record (an ``0xB3``
        anomaly/incident finding from :func:`tpumon_torch.blackbox.
        encode_finding`) to every subscriber — the stream IS a live
        blackbox segment, so the record rides between frames exactly
        as it sits between them on disk.  Owner thread, like
        :meth:`publish`; findings are edge-gated and rare, so this is
        never steady-state work."""

        if not self._subs:
            # same benign race as publish(): an attach still in
            # flight misses only this record
            return
        self._server.run_on_loop(lambda: self._fanout_record(data))

    # tpumon: thread-ok(owner-thread contract like publish: the relay thread is the one owner driving forward; _capture is one atomic reference swap and the _subs emptiness probe is the same documented benign race)
    def forward(self, payload: bytes,
                chips: Dict[int, Dict[int, FieldValue]],
                index: int, ts: float, *, keyframe: bool = False,
                stale: bool = False) -> None:
        """Fan out an ALREADY-FRAMED upstream tick+frame pair verbatim
        (the relay plane): the bytes a ``StreamRelay`` received are the bytes its
        subscribers get — zero re-encode on the steady path, so a leaf
        is byte-identical to the origin by construction.

        ``chips``/``index``/``ts`` describe the state the payload's
        frame left behind (the relay's decoder mirror and the frame
        index it carried): attach and resync keyframes are synthesized
        from them at exactly that index, so forwarded delta frames
        apply after a local keyframe without a discontinuity.
        ``keyframe=True`` (the upstream frame IS a keyframe — the
        relay just reconnected or was itself resynced) re-sends the
        payload to EVERY subscriber regardless of position: that is
        the whole-subtree resync, paid downstream only."""

        self._index = index
        self._capture = (chips, index, ts)
        self.stale_flag = stale
        if not self._subs:
            return

        def make_keyframe() -> bytes:
            return self._keyframe_bytes(chips, index, ts, stale=stale)

        self._server.run_on_loop(
            lambda: self._fanout(index, payload, make_keyframe,
                                 resync=keyframe))

    # tpumon: thread-ok(owner-thread contract like publish/forward; the _subs emptiness probe is the same documented benign race — a missed heartbeat is corrected by the next one)
    def forward_heartbeat(self, ts: float,
                          payload: Optional[bytes] = None) -> None:
        """Fan out one frameless STALE tick record (flags bit 1, no
        frame): the relay's "alive but my upstream is not" heartbeat.
        Carries no frame index, so it never perturbs the delta
        stream — live frames resume exactly where they left off (or
        via the reconnect keyframe).  ``ts`` is the wall stamp of the
        last real upstream tick: subscribers read their staleness as
        ``now - tick.timestamp``.  ``payload`` forwards an upstream
        relay's own heartbeat bytes verbatim instead of rebuilding
        them."""

        self.stale_flag = True
        data = payload if payload is not None \
            else _tick_record(ts, False, True)
        if not self._subs:
            return
        self._server.run_on_loop(
            lambda: self._fanout_heartbeat(data))

    # -- loop thread ----------------------------------------------------------

    def _fanout_heartbeat(self, payload: bytes) -> None:
        cap = self._capture
        kf: Optional[bytes] = None
        kf_next = 0
        for conn, sub in list(self._subs.items()):
            if sub.stale:
                if conn.queued_bytes == 0 and cap is not None:
                    # drained mid-degradation: resync from the capture
                    # (stale-flagged keyframe) so the subscriber at
                    # least holds the last-known state
                    if kf is None:
                        chips, idx, ts = cap
                        kf = self._keyframe_bytes(chips, idx, ts,
                                                  stale=True)
                        kf_next = idx + 1
                    sub.stale = False
                    sub.next_index = kf_next
                    self._server.send(conn, kf)
                    self.resyncs_total += 1
                    self.keyframes_total += 1
                    self.frames_sent_total += 1
                    self.bytes_sent_total += len(kf)
                elif conn.queued_bytes == 0:
                    # no capture exists (nothing was ever known): the
                    # frameless heartbeat is self-contained, so even a
                    # keyframe-less subscriber hears "alive, but
                    # nothing to serve" instead of silence
                    self._server.send(conn, payload)
                    self.heartbeats_total += 1
                    self.bytes_sent_total += len(payload)
                continue
            if conn.queued_bytes + len(payload) > self.max_buffer_bytes:
                sub.stale = True
                self.overflows_total += 1
                continue
            self._server.send(conn, payload)
            self.heartbeats_total += 1
            self.bytes_sent_total += len(payload)

    def _fanout_record(self, data: bytes) -> None:
        for conn, sub in list(self._subs.items()):
            if sub.stale:
                # resyncing subscriber: it rejoins at a keyframe; a
                # finding record queued mid-drain would precede it
                self.dropped_frames_total += 1
                continue
            if conn.queued_bytes + len(data) > self.max_buffer_bytes:
                sub.stale = True
                self.overflows_total += 1
                self.dropped_frames_total += 1
                continue
            self._server.send(conn, data)
            self.bytes_sent_total += len(data)

    def _fanout(self, idx: int, payload: bytes,
                make_keyframe: Callable[[], bytes],
                resync: bool = False) -> None:
        """``resync=True``: the payload itself is a keyframe (a relay
        forwarding its fresh upstream keyframe) — every subscriber
        gets it regardless of position; their decoders re-adopt the
        index, so the whole subtree rebases in one fan-out."""

        kf: Optional[bytes] = None
        server = self._server
        for conn, sub in list(self._subs.items()):
            if sub.stale:
                if conn.queued_bytes == 0:
                    # drained: resync with a fresh keyframe carrying
                    # THIS sweep's full state at THIS frame's index —
                    # built at most once per publish however many
                    # subscribers resync on it (when the payload is
                    # itself a keyframe it IS that resync)
                    if resync:
                        kf = payload
                    elif kf is None:
                        kf = make_keyframe()
                    sub.stale = False
                    sub.next_index = idx + 1
                    server.send(conn, kf)
                    self.resyncs_total += 1
                    self.keyframes_total += 1
                    self.frames_sent_total += 1
                    self.bytes_sent_total += len(kf)
                else:
                    self.dropped_frames_total += 1
                continue
            if not resync and sub.next_index > idx:
                continue  # the attach keyframe already covers this frame
            if conn.queued_bytes + len(payload) > self.max_buffer_bytes:
                # too slow: stop queuing (bounded buffer), resync with
                # a keyframe once the backlog drains
                sub.stale = True
                self.overflows_total += 1
                self.dropped_frames_total += 1
                continue
            sub.next_index = idx + 1
            server.send(conn, payload)
            self.frames_sent_total += 1
            if resync:
                self.keyframes_total += 1
            self.bytes_sent_total += len(payload)

    def _attach(self, conn: FrameConn, head: bytes) -> None:
        """Subscribe ``conn``: stream header + (when state exists) an
        immediate keyframe.  Loop thread only (hub callback)."""

        old = conn.data.get("stream_pub")
        if old is not None:
            # re-subscribe on a live connection switches streams: the
            # old publisher stops feeding this socket BEFORE the new
            # header/keyframe is queued, so the client decoder sees a
            # clean segment boundary (and the old stream's subscriber
            # gauge does not leak a dead entry)
            old._detach(conn)
        sub = _SubState()
        self._subs[conn] = sub
        conn.data["stream_pub"] = self
        self.subscribers_total += 1
        cap = self._capture
        hdr = bytearray()
        write_varint_field(hdr, 1, FORMAT_VERSION)
        write_double_field(hdr, 2, cap[2] if cap is not None else 0.0)
        # once per ATTACH, never on the per-sweep tee path
        write_bytes_field(hdr, 3,
                          self.name.encode("utf-8"))  # tpumon-lint: disable=encode-in-hot-path
        out = bytearray(head)
        out += _frame_record(SEG_HEADER_MAGIC, hdr)
        if cap is not None:
            chips, idx, ts = cap
            out += self._keyframe_bytes(chips, idx, ts,
                                        stale=self.stale_flag)
            sub.next_index = idx + 1
            self.keyframes_total += 1
            self.frames_sent_total += 1
        else:
            # nothing published yet: the first publish resyncs this
            # subscriber with a keyframe
            sub.stale = True
        self.bytes_sent_total += len(out)
        self._server.send(conn, bytes(out))

    def _detach(self, conn: FrameConn) -> None:
        self._subs.pop(conn, None)


class StreamHub(ConnHandler):
    """The attach surface: a :class:`FrameServer` handler mapping
    subscribe requests onto named :class:`StreamPublisher` objects.

    One hub serves any number of streams: the exporter registers one
    (the default ``""``), the fleet poller one per host (named by the
    host address).  Subscribe with a JSON line op::

        {"op": "stream", "stream": "<name>"}

    or plain HTTP (``GET /stream?stream=<name>``) — either way the
    reply is the binary record stream (header / tick / frame records);
    an unknown stream gets a JSON error line (or an HTTP 404) naming
    the streams that exist, then the connection closes.
    """

    def __init__(self, server: FrameServer) -> None:
        self._server = server
        self._lock = threading.Lock()
        self._streams: Dict[str, StreamPublisher] = {}

    def publisher(self, name: str = "", *,
                  max_buffer_bytes: int = DEFAULT_SUB_BUFFER,
                  ) -> StreamPublisher:
        """Get-or-create the named stream (any thread)."""

        with self._lock:
            pub = self._streams.get(name)
            if pub is None:
                pub = self._streams[name] = StreamPublisher(
                    self._server, name, max_buffer_bytes)
            return pub

    def stream_names(self) -> List[str]:
        with self._lock:
            return sorted(self._streams)

    def stats(self) -> Dict[str, int]:
        """Aggregate counter snapshot across every stream."""

        with self._lock:
            pubs = list(self._streams.values())
        out: Dict[str, int] = {}
        for pub in pubs:
            for k, v in pub.stats().items():
                out[k] = out.get(k, 0) + v
        return out

    # -- handler callbacks (loop thread) --------------------------------------

    def on_json(self, server: FrameServer, conn: FrameConn,
                req: Dict[str, Any]) -> None:
        op = req.get("op")
        if op == "stream":
            name = str(req.get("stream", "") or "")
            self._subscribe(server, conn, name, http=False)
            return
        self._error(server, conn, f"unknown op: {op}", http=False)

    def on_text(self, server: FrameServer, conn: FrameConn,
                line: str) -> None:
        parts = line.split()
        if len(parts) >= 2 and parts[0] == "GET":
            path, _, query = parts[1].partition("?")
            name = ""
            for kv in query.split("&"):
                k, _, v = kv.partition("=")
                if k in ("stream", "host") and v:
                    name = v
            if path == STREAM_PATH:
                # the client's remaining header lines carry nothing we
                # dispatch on — discard instead of framing them
                conn.discard_input = True
                conn.inbuf.clear()
                self._subscribe(server, conn, name, http=True)
                return
            self._error(server, conn, f"no such path: {path}", http=True)
            return
        server.close_conn(conn)

    def on_close(self, server: FrameServer, conn: FrameConn) -> None:
        pub = conn.data.get("stream_pub")
        if pub is not None:
            pub._detach(conn)

    # -- internals ------------------------------------------------------------

    def _subscribe(self, server: FrameServer, conn: FrameConn,
                   name: str, http: bool) -> None:
        with self._lock:
            pub = self._streams.get(name)
        if pub is None:
            streams = ", ".join(self.stream_names()) or "<none>"
            self._error(server, conn,
                        f"unknown stream {name!r} (streams: {streams})",
                        http=http)
            return
        pub._attach(conn, _HTTP_OK if http else b"")

    def _error(self, server: FrameServer, conn: FrameConn, msg: str,
               http: bool) -> None:
        # once per failed subscribe, never on the tee path
        if http:
            body = (msg + "\n").encode("utf-8")  # tpumon-lint: disable=encode-in-hot-path
            head = ("HTTP/1.1 404 Not Found\r\n"
                    "Content-Type: text/plain\r\n"
                    f"Content-Length: {len(body)}\r\n"
                    "\r\n").encode("utf-8")  # tpumon-lint: disable=encode-in-hot-path
            server.send(conn, head + body, close_after=True)
            return
        line = json.dumps(  # tpumon-lint: disable=json-in-sweep-path
            {"ok": False, "error": msg}, separators=(",", ":"))
        server.send(conn, line.encode("utf-8") + b"\n",  # tpumon-lint: disable=encode-in-hot-path
                    close_after=True)


# -- client half ---------------------------------------------------------------


class StreamDecoder:
    """Incremental client half of the record stream.

    Feed raw socket bytes; get back :class:`~tpumon_torch.blackbox.
    ReplayTick` items (full decoded snapshots, exactly what replaying
    a flight-recorder segment yields).  A tick record flagged as a
    keyframe starts a fresh :class:`~tpumon_torch.sweepframe.
    SweepFrameDecoder` in index-adoption mode — that is how both the
    initial attach and every drop-to-keyframe resync land without a
    frame-index discontinuity."""

    def __init__(self) -> None:
        self._buf = bytearray()
        self._dec: Optional[SweepFrameDecoder] = None
        self._pending: Optional[Tuple[float, int]] = None
        #: (version, wall_ts, stream name) from the stream header
        self.header: Optional[Tuple[int, float, str]] = None
        self.ticks = 0
        self.keyframes = 0
        #: frameless stale heartbeats received (a relay upstream is
        #: down; the emitted ticks carry the last-known snapshot)
        self.stale_ticks = 0

    def feed(self, data: bytes
             ) -> List[Union[ReplayTick, AnomalyRecord]]:
        """Consume ``data``; return every complete item it finished
        (ticks, plus any anomaly/incident finding records riding the
        stream).  Raises ``ValueError`` on a desynchronized/malformed
        stream — the caller must drop the connection and re-attach."""

        self._buf += data
        out: List[Union[ReplayTick, AnomalyRecord]] = []
        while self._buf:
            lead = self._buf[0]
            if lead not in (SEG_HEADER_MAGIC, TICK_MAGIC,
                            SWEEP_FRAME_MAGIC, KMSG_MAGIC,
                            ANOMALY_MAGIC):
                raise ValueError(
                    f"desynchronized stream (lead byte {lead:#x})")
            parsed = try_split_frame(self._buf)
            if parsed is None:
                return out  # mid-record: wait for more bytes
            payload, used = parsed
            del self._buf[:used]
            if lead == SEG_HEADER_MAGIC:
                self.header = _decode_header(payload)
            elif lead == TICK_MAGIC:
                tick = _decode_tick(payload)
                if tick[1] & _TICK_STALE and \
                        not tick[1] & _TICK_KEYFRAME:
                    # frameless stale heartbeat: the serving relay has
                    # lost its upstream and is keeping us warm with
                    # "alive, but this is as fresh as it gets" — no
                    # frame follows (and no frame index is consumed),
                    # surface the last-known snapshot flagged stale
                    self.stale_ticks += 1
                    dec = self._dec
                    out.append(ReplayTick(
                        timestamp=tick[0],
                        snapshot=dec.mirror_snapshot()
                        if dec is not None else {},
                        events=[],
                        keyframe=False,
                        changes=0,
                        stale=True))
                else:
                    self._pending = tick
            elif lead == SWEEP_FRAME_MAGIC:
                if self._pending is None:
                    raise ValueError("frame without a tick record")
                ts, flags = self._pending
                self._pending = None
                keyframe = bool(flags & _TICK_KEYFRAME)
                if keyframe:
                    self._dec = SweepFrameDecoder(adopt_first_index=True)
                    self.keyframes += 1
                dec = self._dec
                if dec is None:
                    raise ValueError("frame before the first keyframe")
                events = dec.apply(payload)
                self.ticks += 1
                out.append(ReplayTick(
                    timestamp=ts,
                    snapshot=dec.mirror_snapshot(),
                    events=events,
                    keyframe=keyframe,
                    changes=dec.last_changes,
                    stale=bool(flags & _TICK_STALE)))
            elif lead == ANOMALY_MAGIC:
                # the detection plane's verdicts ride the stream as
                # the same 0xB3 records the black box persists
                out.append(_decode_finding(payload))
            # KMSG records are not part of the live stream today;
            # tolerated (skipped) so the format can grow them later
        return out
