"""In-process simulated agent farm (wire-protocol twin).

The port's copy of ``tpumon/agentsim.py``, imports renamed.  A fleet of
the size the fleet plane is built for does not fit on one GPU host, and
the fleet multiplexer's failure-matrix tests need scriptable agents
(slow-loris drip, death mid-frame, old JSON-only agents).  Hundreds of
real agents — or hundreds of threaded fakes — would drown the numbers in
thread-scheduling noise, so the farm is ONE selector thread hosting N
simulated agents with the agent's protocol surface: JSON line ops
(``hello``, ``read_fields_bulk`` with the piggybacked event drain, the
``sweep_frame`` probe) plus the binary varint-framed ``sweep_frame``
request/reply with a per-connection :class:`SweepFrameEncoder` delta
table — so a reconnect resets the server half of the delta state exactly
like a real agent.  The selector loop is
:class:`tpumon_torch.frameserver.FrameServer`; this module keeps the
simulated-agent op handling and fault scripting on top of it.

Fault injection is per-:class:`SimAgent`:

* ``reply_delay_s`` — every reply is held for this long before the
  first byte goes out (models per-RPC service + network latency; a
  loopback farm would otherwise hide the wave-serialization cost of
  blocking clients).
* ``drip_chunk`` / ``drip_interval_s`` — slow-loris: the reply leaves
  in chunks of ``drip_chunk`` bytes every ``drip_interval_s``.
* ``kill_mid_frame_once`` — the next binary frame is cut in half and
  the connection closed (the mid-frame death the client must never
  desynchronize on).
* ``support_sweep_frame=False`` — an old agent: the probe gets
  ``"unknown op"`` and only the JSON path works.
* ``burst_churn_ticks`` — every field of every chip mutates before
  each served sweep while armed (worst-case frame-size regime).

The subscriber side of the streaming plane is simulated here too:
:class:`SubscriberFarm` hosts N :class:`SimSubscriber` clients on one
selector thread, with the **reader-side** fault knobs the backpressure
matrix needs — drip-read (``read_chunk`` every ``read_interval_s``) and a
stop-reading stall (``stall_after_bytes``/``stall``), resumable so
drop-to-keyframe recovery is exercisable under the same harness as the
fleet faults.

``python -m tpumon_torch.agentsim --hosts N [--procs P]`` runs a farm in
its own process(es) (below).  This is simulation infrastructure like
:mod:`tpumon_torch.backends.fake`, not a production server.
"""

from __future__ import annotations

import json
import os
import selectors
import socket
import threading
import time
from typing import (Any, Dict, List, Optional, TYPE_CHECKING, Tuple,
                    Union)

if TYPE_CHECKING:
    from .burst import BurstAccumulator

from . import log
from .backends.base import FieldValue
from .blackbox import TICK_MAGIC, _TICK_KEYFRAME, _decode_tick, ReplayTick
from .events import Event
from .frameserver import (ConnHandler, FrameConn, FrameServer,
                          StreamDecoder)
from .sweepframe import (SWEEP_FRAME_MAGIC, SweepFrameEncoder,
                         decode_sweep_request, try_split_frame)


class SimAgent:
    """One simulated per-host agent: mutable values/events + fault
    knobs + served-RPC counters.  Mutate freely from the test thread
    (dict/list ops are GIL-atomic; the farm thread only reads)."""

    def __init__(self, support_sweep_frame: bool = True) -> None:
        self.values: Dict[int, Dict[int, FieldValue]] = {}
        self.events: List[Event] = []
        self.driver = "sim 1.0"
        self.support_sweep_frame = support_sweep_frame
        self.reply_delay_s = 0.0
        self.drip_chunk = 0
        self.drip_interval_s = 0.0
        self.kill_mid_frame_once = False
        #: preempted/dead agent: while True, every request closes the
        #: connection without a reply (connects still accept — the
        #: listener is the node, the agent process is gone).  The
        #: preemption-wave knob; clear to "reschedule".
        self.dead = False
        #: burst churn: while > 0, EVERY field of EVERY chip mutates
        #: before each served sweep (binary or JSON), decrementing per
        #: sweep — the worst-case frame-size regime (a full-churn delta
        #: frame carries every entry) that flight-recorder tests and
        #: measurements must exercise.  Mutations preserve value types.
        self.burst_churn_ticks = 0
        #: burst-sampling mode (the --burst-hz twin): advertised in the
        #: hello reply so the exporter's tpumon_agent_burst_* gauges
        #: have a simulated source too; derived-field VALUES are folded
        #: into ``values`` via :meth:`burst_fold`/:meth:`burst_harvest`
        #: so they ride the fleet/stream/blackbox planes like any field
        self.burst_hz = 0
        self.burst_overruns = 0
        self._burst_acc: Optional["BurstAccumulator"] = None
        # counters
        self.hello_served = 0
        self.sweep_frame_probes = 0
        self.binary_requests = 0
        self.json_sweeps = 0
        self.events_rpcs = 0
        self.address = ""  # set by the farm

    # -- burst scripting (test thread) ----------------------------------------

    def burst_fold(self, chip: int, fid: int,
                   samples: "List[Tuple[float, float]]") -> None:
        """Fold a scripted inner-rate sample stream ``[(t, v), ...]``
        for one (chip, source-field) through the shared executable
        spec (:class:`tpumon_torch.burst.BurstAccumulator`)."""

        from .burst import BurstAccumulator

        if self._burst_acc is None:
            self._burst_acc = BurstAccumulator()
        self._burst_acc.fold_series(chip, fid,
                                    [t for t, _ in samples],
                                    [v for _, v in samples])

    def burst_harvest(self) -> None:
        """Close the window: fold the harvested derived fields into
        ``values`` so the next served sweep carries them end to end
        (fleet poller -> stream/blackbox planes).  Call from the test
        thread between sweeps, like any other value mutation."""

        if self._burst_acc is None:
            return
        for chip, vals in self._burst_acc.harvest().items():
            cur = self.values.get(chip)
            if cur is None:
                if chip in self.values:
                    continue  # lost-chip marker: do not resurrect it
                cur = self.values[chip] = {}
            cur.update(vals)


class _SimAgentHandler(ConnHandler):
    """The agent op surface, one instance per :class:`SimAgent`
    listener; runs on the :class:`FrameServer` loop thread."""

    def __init__(self, sim: SimAgent) -> None:
        self.sim = sim

    # -- framing callbacks ----------------------------------------------------

    def on_binary(self, server: FrameServer, conn: FrameConn,
                  payload: bytes) -> None:
        sim = self.sim
        if sim.dead:
            server.close_conn(conn)
            return
        sim.binary_requests += 1
        # steady-state fast path: a fleet client's binary request is
        # byte-identical every tick (it caches the encoded form), so
        # the sim caches its decode per connection too — the farm must
        # not charge request parsing to the client under measurement
        if payload == conn.data.get("last_req"):
            reqs, events_since = conn.data["last_req_parsed"]
        else:
            reqs, _max_age, events_since = decode_sweep_request(payload)
            conn.data["last_req"] = payload
            conn.data["last_req_parsed"] = (reqs, events_since)
        self._reply_frame(server, conn, reqs, events_since)

    def on_json(self, server: FrameServer, conn: FrameConn,
                req: Dict[str, Any]) -> None:
        sim = self.sim
        if sim.dead:
            server.close_conn(conn)
            return
        op = req.get("op")
        if op == "hello":
            sim.hello_served += 1
            hello: Dict[str, Any] = {
                "ok": True, "chip_count": len(sim.values),
                "driver": sim.driver, "runtime": "sim",
                "agent_version": "tpumon-agentsim"}
            if sim.burst_hz > 0:
                # burst-loop health rides the hello like a real agent's
                hello["burst_hz"] = sim.burst_hz
                hello["burst_overruns"] = sim.burst_overruns
            self._reply_json(server, conn, hello)
        elif op == "sweep_frame":
            sim.sweep_frame_probes += 1
            if not sim.support_sweep_frame:
                self._reply_json(server, conn, {
                    "ok": False, "error": "unknown op: sweep_frame"})
                return
            reqs = [(r["index"], r["fields"])
                    for r in req.get("reqs", [])]
            self._reply_frame(server, conn, reqs, req.get("events_since"))
        elif op == "read_fields_bulk":
            sim.json_sweeps += 1
            _burst_churn(sim)
            reqs = [(r["index"], r["fields"])
                    for r in req.get("reqs", [])]
            resp: Dict[str, Any] = {
                "ok": True,
                "chips": {str(c): {str(f): v for f, v in vals.items()}
                          for c, vals in
                          _sweep_chips(sim, reqs).items()}}
            if "events_since" in req:
                resp["events"] = [
                    {"etype": int(e.etype), "timestamp": e.timestamp,
                     "seq": e.seq, "chip_index": e.chip_index,
                     "uuid": e.uuid, "message": e.message}
                    for e in _drain_events(
                        sim, int(req["events_since"]))]
            self._reply_json(server, conn, resp)
        elif op == "events":
            sim.events_rpcs += 1
            last = max((e.seq for e in sim.events), default=0)
            if req.get("peek"):
                self._reply_json(server, conn,
                                 {"ok": True, "last_seq": last,
                                  "events": []})
            else:
                since = int(req.get("since_seq", 0))
                self._reply_json(server, conn, {
                    "ok": True, "last_seq": last,
                    "events": [
                        {"etype": int(e.etype),
                         "timestamp": e.timestamp, "seq": e.seq,
                         "chip_index": e.chip_index, "uuid": e.uuid,
                         "message": e.message}
                        for e in _drain_events(sim, since)]})
        else:
            self._reply_json(server, conn,
                             {"ok": False,
                              "error": f"unknown op: {op}"})

    # -- replies (fault knobs applied here) -----------------------------------

    def _reply_json(self, server: FrameServer, conn: FrameConn,
                    obj: Dict[str, Any]) -> None:
        self._schedule(server, conn, json.dumps(
            obj, separators=(",", ":")).encode() + b"\n")

    def _reply_frame(self, server: FrameServer, conn: FrameConn,
                     reqs: List[Tuple[int, List[int]]],
                     events_since: Optional[int]) -> None:
        sim = self.sim
        _burst_churn(sim)
        events = (_drain_events(sim, int(events_since))
                  if events_since is not None else None)
        enc = conn.data.get("enc")
        if enc is None:
            enc = conn.data["enc"] = SweepFrameEncoder()
        frame = enc.encode_frame(_sweep_chips(sim, reqs), events)
        if sim.kill_mid_frame_once and len(frame) > 2:
            sim.kill_mid_frame_once = False
            self._schedule(server, conn, frame[:max(1, len(frame) // 2)],
                           close_after=True)
            return
        self._schedule(server, conn, frame)

    def _schedule(self, server: FrameServer, conn: FrameConn,
                  data: bytes, close_after: bool = False) -> None:
        sim = self.sim
        server.send(conn, data, delay_s=sim.reply_delay_s,
                    drip_chunk=sim.drip_chunk,
                    drip_interval_s=sim.drip_interval_s,
                    close_after=close_after)


def _burst_churn(sim: SimAgent) -> None:
    """One burst-churn step: mutate every live field, type-stably
    (ints step, finite floats nudge, strings toggle a suffix, list
    elements mutate elementwise, blanks stay blank).  Runs on the
    serve thread right before a sweep is served while the knob is
    armed — per-entry dict stores are GIL-atomic, like the test
    thread's own mutations."""

    if sim.burst_churn_ticks <= 0:
        return
    sim.burst_churn_ticks -= 1

    def bump(v: FieldValue) -> FieldValue:
        if isinstance(v, bool) or v is None:
            return v
        if isinstance(v, int):
            return v + 1
        if isinstance(v, float):
            if v != v or v in (float("inf"), float("-inf")):
                return v
            return round(v + 0.001, 6) if abs(v) < 1e12 else v * (1 + 1e-9)
        if isinstance(v, str):
            return v[:-1] if v.endswith("~") else v + "~"
        if isinstance(v, list):
            return [bump(e) for e in v]
        return v

    for vals in sim.values.values():
        if vals is None:
            continue  # lost chip marker
        for f, v in vals.items():
            vals[f] = bump(v)


def _sweep_chips(sim: SimAgent,
                 reqs: List[Tuple[int, List[int]]],
                 ) -> Dict[int, Dict[int, FieldValue]]:
    chips: Dict[int, Dict[int, FieldValue]] = {}
    for idx, fids in reqs:
        vals = sim.values.get(idx)
        if vals is None:
            continue  # lost chip: omitted, not failing the sweep
        chips[idx] = {f: vals.get(f) for f in fids}
    return chips


def _drain_events(sim: SimAgent, since: int) -> List[Event]:
    return [e for e in sim.events if e.seq > since]


class AgentFarm:
    """N simulated agents on one :class:`FrameServer` loop thread.

    Usage::

        farm = AgentFarm()
        sims = [SimAgent() for _ in range(64)]
        addrs = [farm.add(s) for s in sims]
        farm.start()
        ...
        farm.close()
    """

    def __init__(self) -> None:
        self._server = FrameServer()

    @property
    def server(self) -> FrameServer:
        """The underlying server (e.g. to co-host a stream hub)."""

        return self._server

    @property
    def bytes_in(self) -> int:
        return self._server.bytes_in

    @property
    def bytes_out(self) -> int:
        return self._server.bytes_out

    def add(self, sim: SimAgent, path: Optional[str] = None) -> str:
        """Register one agent on a fresh unix socket (or on ``path``
        when given — a caller can pick names whose hash partition is
        deterministic); returns its ``unix:...``
        address.  Call before :meth:`start`."""

        address = self._server.add_unix_listener(_SimAgentHandler(sim),
                                                 path)
        sim.address = address
        return address

    def start(self) -> None:
        self._server.start()

    def kill_connections(self, address: str) -> None:
        """Close every live connection of one agent (an agent restart:
        the next connection starts a fresh server-side delta table)."""

        self._server.kill_connections(address)

    def close(self) -> None:
        self._server.close()


# -- simulated stream subscribers ----------------------------------------------


class SimSubscriber:
    """One simulated stream subscriber: counters + reader-side fault
    knobs.  The server-side backpressure matrix (drop-to-keyframe,
    bounded buffers, healthy-subscriber isolation) is exercised by
    scripting HOW this client reads:

    * ``read_chunk`` / ``read_interval_s`` — drip-read: at most
      ``read_chunk`` bytes every ``read_interval_s`` (a slow consumer
      that still makes progress).
    * ``stall_after_bytes`` — stop reading entirely after that many
      bytes (a wedged consumer; kernel + server buffers fill until the
      publisher drops it to stale).  ``resume()`` un-wedges it so
      keyframe resync is observable.
    * ``decode=True`` — run the real :class:`~tpumon_torch.frameserver.
      StreamDecoder` (differential tests); otherwise ticks are counted
      by record framing only (cheap enough for 1000 subscribers).
    """

    def __init__(self, stream: str = "", *, read_chunk: int = 65536,
                 read_interval_s: float = 0.0,
                 stall_after_bytes: Optional[int] = None,
                 decode: bool = False) -> None:
        self.stream = stream
        self.read_chunk = int(read_chunk)
        self.read_interval_s = float(read_interval_s)
        self.stall_after_bytes = stall_after_bytes
        self.decoder = StreamDecoder() if decode else None
        # live state / counters (farm thread writes, any thread reads)
        self.bytes_in = 0
        self.ticks = 0
        self.keyframes = 0
        self.stalled = False
        self.closed = False
        self.error = ""
        #: last decoded snapshot (``decode=True`` only)
        self.last_snapshot: Optional[
            Dict[int, Dict[int, FieldValue]]] = None
        self.last_tick: Optional[ReplayTick] = None
        #: anomaly/incident records seen on the stream (decode=True)
        self.findings: List[object] = []


class _SubConn:
    def __init__(self, sock: socket.socket, sub: SimSubscriber) -> None:
        self.sock = sock
        self.sub = sub
        self.buf = bytearray()   # framing-count buffer (decode=False)
        self.due = 0.0           # next read time (drip-read)
        self.registered = False


class SubscriberFarm:
    """N simulated stream subscribers on one selector thread.

    Usage::

        farm = SubscriberFarm()
        subs = [farm.add(addr) for _ in range(1000)]
        farm.start()
        ...
        farm.close()
    """

    def __init__(self) -> None:
        self._sel = selectors.DefaultSelector()
        self._conns: List[_SubConn] = []
        # partial-constructor discipline (same as FrameServer): a
        # raise while wiring the doorbell releases what was acquired
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
        self._cmds: List[Tuple[str, Optional[SimSubscriber]]] = []
        self._cmd_lock = threading.Lock()
        self._stop = False
        self._thread: Optional[threading.Thread] = None
        self.bytes_in = 0

    # -- control (any thread) -------------------------------------------------

    def add(self, address: str, stream: str = "",
            **knobs: Any) -> SimSubscriber:
        """Connect one subscriber to ``address`` (``unix:/path`` or
        ``host:port``) and send its subscribe op.  Call before
        :meth:`start` (setup is blocking on purpose — it is not part
        of anything a bench measures)."""

        sub = SimSubscriber(stream, **knobs)
        target: Union[str, Tuple[str, int]]
        if address.startswith("unix:"):
            family, target = socket.AF_UNIX, address[5:]
        else:
            host, _, port = address.rpartition(":")
            family, target = socket.AF_INET, (host, int(port))
        sock = socket.socket(family, socket.SOCK_STREAM)
        try:
            sock.connect(target)
            sock.sendall(json.dumps(
                {"op": "stream", "stream": stream},
                separators=(",", ":")).encode() + b"\n")
            sock.setblocking(False)
        except BaseException:
            # a refused/dying endpoint must not leak the socket: at
            # farm scale one leaked fd per failed attach exhausts the
            # process fd table long before the bench ends
            sock.close()
            raise
        conn = _SubConn(sock, sub)
        self._conns.append(conn)
        self._register(conn)
        return sub

    def start(self) -> None:
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="tpumon-subfarm")
        self._thread.start()

    def resume(self, sub: SimSubscriber) -> None:
        """Un-wedge a stalled subscriber: it reads (and drains the
        server's backlog) again, triggering the keyframe resync."""

        self._command(("resume", sub))

    def close(self) -> None:
        if self._thread is not None:
            self._command(("stop", None))
            self._thread.join(timeout=10.0)
            self._thread = None
        else:
            # never started: tear down inline (same teardown the loop
            # runs on exit) so eagerly-connected subscriber sockets,
            # the selector and the command pair do not leak
            self._teardown()

    def _command(self, cmd: Tuple[str, Optional[SimSubscriber]]) -> None:
        with self._cmd_lock:
            self._cmds.append(cmd)
        try:
            self._cmd_w.send(b"x")
        except OSError:
            pass

    # -- event loop (farm thread) ---------------------------------------------

    def _register(self, conn: _SubConn) -> None:
        if not conn.registered and not conn.sub.closed:
            self._sel.register(conn.sock, selectors.EVENT_READ, conn)
            conn.registered = True

    def _unregister(self, conn: _SubConn) -> None:
        if conn.registered:
            try:
                self._sel.unregister(conn.sock)
            except (KeyError, ValueError):
                pass
            conn.registered = False

    def _loop(self) -> None:
        while not self._stop:
            now = time.monotonic()
            timeout = None
            for conn in self._conns:
                if (not conn.registered and not conn.sub.closed
                        and not conn.sub.stalled):
                    wait = conn.due - now
                    if wait <= 0:
                        self._register(conn)
                    elif timeout is None or wait < timeout:
                        timeout = wait
            for key, _mask in self._sel.select(timeout):
                if key.data == "cmd":
                    self._drain_commands()
                else:
                    self._read(key.data)
        self._teardown()

    def _teardown(self) -> None:
        for conn in self._conns:
            self._unregister(conn)
            try:
                conn.sock.close()
            except OSError:
                pass
        try:
            self._sel.unregister(self._cmd_r)
        except (KeyError, ValueError):
            pass
        self._cmd_r.close()
        self._cmd_w.close()
        self._sel.close()

    def _drain_commands(self) -> None:
        try:
            while self._cmd_r.recv(4096):
                pass
        except OSError:
            pass
        with self._cmd_lock:
            cmds, self._cmds = self._cmds, []
        for op, sub in cmds:
            if op == "stop":
                self._stop = True
            elif op == "resume" and sub is not None:
                sub.stall_after_bytes = None
                sub.stalled = False
                for conn in self._conns:
                    if conn.sub is sub and not sub.closed:
                        self._register(conn)

    def _drop(self, conn: _SubConn, error: str = "") -> None:
        self._unregister(conn)
        conn.sub.closed = True
        if error:
            conn.sub.error = error
        try:
            conn.sock.close()
        except OSError:
            pass

    def _read(self, conn: _SubConn) -> None:
        sub = conn.sub
        try:
            chunk = conn.sock.recv(max(1, sub.read_chunk))
        except (BlockingIOError, InterruptedError):
            return
        except OSError as e:
            self._drop(conn, str(e))
            return
        if not chunk:
            self._drop(conn)
            return
        self.bytes_in += len(chunk)
        sub.bytes_in += len(chunk)
        try:
            self._consume(conn, chunk)
        except ValueError as e:
            # a desynchronized stream is a client-fatal protocol error:
            # record it — differential tests assert it never happens
            self._drop(conn, str(e))
            return
        if (sub.stall_after_bytes is not None
                and sub.bytes_in >= sub.stall_after_bytes):
            # wedged consumer: stop reading; kernel + server buffers
            # absorb until the publisher marks it stale
            sub.stalled = True
            self._unregister(conn)
            return
        if sub.read_interval_s > 0.0:
            # drip-read: next read no sooner than the interval
            conn.due = time.monotonic() + sub.read_interval_s
            self._unregister(conn)

    def _consume(self, conn: _SubConn, chunk: bytes) -> None:
        sub = conn.sub
        if sub.decoder is not None:
            for item in sub.decoder.feed(chunk):
                if isinstance(item, ReplayTick):
                    sub.last_tick = item
                    sub.last_snapshot = item.snapshot
                else:
                    # detection-plane records riding the stream
                    sub.findings.append(item)
            sub.ticks = sub.decoder.ticks
            sub.keyframes = sub.decoder.keyframes
            return
        # cheap path: record framing only (1000 subscribers)
        conn.buf += chunk
        while conn.buf:
            parsed = try_split_frame(conn.buf)
            if parsed is None:
                return
            payload, used = parsed
            lead = conn.buf[0]
            del conn.buf[:used]
            if lead == TICK_MAGIC:
                _ts, flags = _decode_tick(payload)
                if flags & _TICK_KEYFRAME:
                    sub.keyframes += 1
            elif lead == SWEEP_FRAME_MAGIC:  # one frame per tick
                sub.ticks += 1


# -- standalone farm process ---------------------------------------------------
#
# `python -m tpumon_torch.agentsim --hosts N ...` runs one farm in its OWN
# process with a JSON-line control protocol on stdio.  An in-process farm
# shares the measured process's GIL, so part of every "fleet tick"
# number would be the simulator's own Python; several farm processes
# spread the simulation across cores and leave the measured process's
# GIL to the plane under test.
#
# Control ops (one JSON object per line on stdin, one reply per line
# on stdout):
#   {"op": "churn", "ticks": N}  arm burst_churn_ticks on every sim
#   {"op": "bytes"}              farm socket accounting
#   {"op": "reply_delay", "s": X}
#   {"op": "quit"}
# The first stdout line is {"ok": true, "addrs": [...]}.


def _bench_host_values(seed: int, chips: int,
                       fields: List[int]) -> Dict[int, Dict[int, FieldValue]]:
    """The farm's per-host value profile: a deterministic mix of
    floats and ints keyed on the host seed."""

    import random as _random
    rng = _random.Random(seed)
    return {c: {f: (round(rng.uniform(0.0, 500.0), 3)
                    if (f + c) % 3 else rng.randrange(1, 10_000))
                for f in fields} for c in range(chips)}


#: fds one simulated host costs at steady state: its unix listener
#: plus one live poller connection (reconnect churn briefly doubles a
#: host, hence the slack below, not a bigger multiplier)
_FDS_PER_HOST = 2
#: process overhead: stdio, the selector, the wakeup pipe, imports
#: that keep fds open, plus reconnect-churn headroom
_FD_SLACK = 64


def ensure_fd_budget(hosts: int, *, cap: bool = False) -> int:
    """Probe ``RLIMIT_NOFILE`` BEFORE building a farm of ``hosts``
    listeners.  Raises the soft limit toward the hard limit when that
    is enough; otherwise fails loudly (or, with ``cap=True``, returns
    how many hosts actually fit).  Dying mid-attach on EMFILE looks
    like an agent fault from the client side — at 100k hosts the
    default 1024-fd soft limit is exhausted before host 500.

    Returns the host count to build (== ``hosts`` unless capped);
    raises :class:`RuntimeError` with the exact numbers otherwise."""

    import resource

    need = hosts * _FDS_PER_HOST + _FD_SLACK
    soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
    ceiling = need if hard == resource.RLIM_INFINITY else hard
    if soft < need:
        # raise the soft limit as far as the hard limit allows —
        # even a partial raise turns a hard failure into a bigger cap
        try:
            resource.setrlimit(resource.RLIMIT_NOFILE,
                               (min(need, ceiling), hard))
            soft = min(need, ceiling)
        except (ValueError, OSError):
            pass  # fall through to the fit check below
    if soft >= need:
        return hosts
    fit = max(0, (soft - _FD_SLACK) // _FDS_PER_HOST)
    if cap:
        log.warning("agentsim: RLIMIT_NOFILE soft limit %d fits %d of "
                    "the requested %d hosts (%d fds needed) — capping "
                    "the farm", soft, fit, hosts, need)
        return fit
    raise RuntimeError(
        f"agentsim: {hosts} hosts need ~{need} fds "
        f"({_FDS_PER_HOST}/host + {_FD_SLACK} slack) but "
        f"RLIMIT_NOFILE is soft={soft} hard="
        f"{'unlimited' if hard == resource.RLIM_INFINITY else hard} "
        f"— raise it (ulimit -n), pass --cap-to-rlimit to build the "
        f"{fit} hosts that fit, or split the farm across more "
        f"processes")


def main(argv: Optional[List[str]] = None) -> int:
    import argparse
    import sys

    ap = argparse.ArgumentParser(
        prog="python -m tpumon_torch.agentsim",
        description="standalone simulated-agent farm (stdio-controlled)")
    ap.add_argument("--hosts", type=int, required=True)
    ap.add_argument("--chips", type=int, default=4)
    ap.add_argument("--fields", default="",
                    help="comma-separated field ids (default: the fleet "
                         "CLI's sweep set)")
    ap.add_argument("--seed-base", type=int, default=0,
                    help="host i gets value seed seed-base + i")
    ap.add_argument("--unix-dir", default=None,
                    help="directory for the unix listener sockets")
    ap.add_argument("--cap-to-rlimit", action="store_true",
                    help="build only as many hosts as RLIMIT_NOFILE "
                         "fits instead of failing (the first reply's "
                         "addrs list says how many)")
    ap.add_argument("--procs", type=int, default=1,
                    help="partition the hosts across N child farm "
                         "processes (one selector thread each) — at "
                         "fleet scale a single farm's Python selector "
                         "is the bottleneck, not the poller under test")
    args = ap.parse_args(argv)
    if args.fields:
        fields = [int(f) for f in args.fields.split(",") if f]
    else:
        from .cli.fleet import _FIELDS
        fields = list(_FIELDS)
    if args.procs > 1:
        return _coordinate(args, fields)
    try:
        hosts = ensure_fd_budget(args.hosts, cap=args.cap_to_rlimit)
    except RuntimeError as e:
        print(str(e), file=sys.stderr)
        return 2
    farm = AgentFarm()
    sims = [SimAgent() for _ in range(hosts)]
    addrs: List[str] = []
    for i, sim in enumerate(sims):
        sim.values = _bench_host_values(args.seed_base + i, args.chips,
                                        fields)
        path = None
        if args.unix_dir:
            path = os.path.join(args.unix_dir,
                                f"sim-{args.seed_base + i}.sock")
        addrs.append(farm.add(sim, path))
    farm.start()
    out = sys.stdout
    out.write(json.dumps({"ok": True, "addrs": addrs}) + "\n")
    out.flush()
    try:
        for line in sys.stdin:
            line = line.strip()
            if not line:
                continue
            try:
                cmd = json.loads(line)
                op = cmd.get("op")
            except ValueError:
                out.write(json.dumps({"ok": False,
                                      "error": "bad json"}) + "\n")
                out.flush()
                continue
            if op == "quit":
                out.write(json.dumps({"ok": True}) + "\n")
                out.flush()
                break
            if op == "churn":
                n = int(cmd.get("ticks", 1))
                for sim in sims:
                    sim.burst_churn_ticks = n
                out.write(json.dumps({"ok": True}) + "\n")
            elif op == "bytes":
                # barrier the loop thread first: a poller's sweep
                # returns when the CLIENT holds its reply, which can
                # beat this farm's own byte accounting by a GIL slice
                # — unsettled meters leak one tick's replies into the
                # caller's measured window
                settled = threading.Event()
                farm.server.run_on_loop(settled.set)
                settled.wait(2.0)
                out.write(json.dumps({"ok": True,
                                      "bytes_in": farm.bytes_in,
                                      "bytes_out": farm.bytes_out})
                          + "\n")
            elif op == "reply_delay":
                for sim in sims:
                    sim.reply_delay_s = float(cmd.get("s", 0.0))
                out.write(json.dumps({"ok": True}) + "\n")
            elif op == "hellos":
                # hello-RPC accounting for external farms: a
                # no-per-tick-hello check needs the server side of the
                # count once the poller's own counter is the thing under
                # test
                out.write(json.dumps(
                    {"ok": True,
                     "hellos": sum(s.hello_served for s in sims)})
                    + "\n")
            else:
                out.write(json.dumps({"ok": False,
                                      "error": f"unknown op {op!r}"})
                          + "\n")
            out.flush()
    finally:
        farm.close()
    return 0


#: the directory holding the ``tpumon_torch`` package, put on the child
#: farms' ``PYTHONPATH`` so ``-m tpumon_torch.agentsim`` resolves from any
#: working directory
_PACKAGE_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _child_env() -> Dict[str, str]:
    env = dict(os.environ)
    path = env.get("PYTHONPATH")
    env["PYTHONPATH"] = (_PACKAGE_ROOT + os.pathsep + path if path
                         else _PACKAGE_ROOT)
    return env


def _coordinate(args: Any, fields: List[int]) -> int:
    """``--procs N`` mode: partition the hosts across N child farms
    (this same module, ``--procs 1``) and speak the SAME stdio
    protocol upward — the first reply concatenates the children's
    listener addresses in host order, every op fans out to all
    children, and counter replies (``bytes``/``hellos``) merge by
    summing.  The coordinator owns only pipes: each child runs its own
    selector thread and fd budget, so a 100k-host farm is N selector
    threads instead of one saturated one."""

    import subprocess
    import sys

    per = (args.hosts + args.procs - 1) // args.procs
    children: List[subprocess.Popen] = []
    base = 0
    while base < args.hosts:
        n = min(per, args.hosts - base)
        argv = [sys.executable, "-m", "tpumon_torch.agentsim",
                "--hosts", str(n), "--chips", str(args.chips),
                "--fields", ",".join(str(f) for f in fields),
                "--seed-base", str(args.seed_base + base)]
        if args.unix_dir:
            argv += ["--unix-dir", args.unix_dir]
        if args.cap_to_rlimit:
            argv.append("--cap-to-rlimit")
        children.append(subprocess.Popen(
            argv, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            text=True, env=_child_env()))
        base += n
    out = sys.stdout
    try:
        addrs: List[str] = []
        ok = True
        for c in children:
            first = json.loads(c.stdout.readline() or "{}")
            ok = ok and bool(first.get("ok"))
            addrs.extend(first.get("addrs", []))
        out.write(json.dumps({"ok": ok, "addrs": addrs,
                              "procs": len(children)}) + "\n")
        out.flush()
        for line in sys.stdin:
            line = line.strip()
            if not line:
                continue
            try:
                op = json.loads(line).get("op")
            except ValueError:
                out.write(json.dumps({"ok": False,
                                      "error": "bad json"}) + "\n")
                out.flush()
                continue
            for c in children:
                c.stdin.write(line + "\n")
                c.stdin.flush()
            replies = [json.loads(c.stdout.readline() or "{}")
                       for c in children]
            merged: Dict[str, Any] = {
                "ok": all(r.get("ok") for r in replies)}
            for k in ("bytes_in", "bytes_out", "hellos"):
                if any(k in r for r in replies):
                    merged[k] = sum(int(r.get(k, 0)) for r in replies)
            errs = [r["error"] for r in replies if r.get("error")]
            if errs:
                merged["error"] = errs[0]
            out.write(json.dumps(merged) + "\n")
            out.flush()
            if op == "quit":
                break
    finally:
        for c in children:
            try:
                c.stdin.close()
            except OSError:
                pass
        for c in children:
            try:
                c.wait(timeout=10)
            except Exception:  # noqa: BLE001 — teardown best-effort
                c.kill()
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
