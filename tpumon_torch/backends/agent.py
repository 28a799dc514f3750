"""Client of the metrics agent, and the agent run modes.

The port's copy of ``tpumon/backends/agent.py``.  The agent is the
nv-hostengine analog: one daemon per host owning discovery and sampling,
serving many monitor clients so the devices are observed once.  The
port's agent is :mod:`tpumon_torch.hostengine` (over NVML, or over the
fake with ``--fake``); the client speaks the same protocol as the
reference's native ``tpu-hostengine`` (``native/agent/protocol.md``) and
works against either.  This module implements the other two run modes of
the reference's ``admin.go:26-30``:

* **Standalone** — connect to a running agent (``dcgmConnect_v2`` analog,
  ``admin.go:109-134``); address is ``unix:/path/to.sock`` or ``host:port``.
* **StartHostengine** — start a local agent bound to a private unix
  socket, connect, then terminate it on shutdown with escalating
  term->kill, mirroring ``admin.go:149-209``.

Wire protocol: newline-delimited JSON request/response over the socket,
plus the negotiated binary ``sweep_frame`` op for the 1 Hz hot path
(varint-framed delta frames; see :mod:`tpumon_torch.sweepframe`).  One
request in flight per connection; the client serializes calls with a lock
and reconnects transparently, replaying its watches.
"""

from __future__ import annotations

import json
import os
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ..events import Event, EventType
from ..sweepframe import (SWEEP_FRAME_MAGIC, SweepFrameDecoder,
                          encode_sweep_request)
from ..types import (
    ChipArch, ChipCoords, ChipInfo, ClockInfo, DeviceProcess, HbmInfo,
    P2PLink, P2PLinkType, PciInfo, TopologyInfo, VersionInfo,
)
from .base import Backend, BackendError, ChipNotFound, FieldValue, LibraryNotFound

DEFAULT_SOCKET = "/tmp/tpumon-hostengine.sock"
DEFAULT_TCP_PORT = 5555  # same default port role as nv-hostengine


class _SweepFrameUnknownOp(Exception):
    """The peer answered the ``sweep_frame`` probe with "unknown op" —
    an older agent.  Internal negotiation signal, never user-visible."""


def _parse_address(address: Optional[str]) -> Tuple[str, Any]:
    addr = address or f"unix:{DEFAULT_SOCKET}"
    if addr.startswith("unix:"):
        return "unix", addr[len("unix:"):]
    if ":" in addr:
        host, port = addr.rsplit(":", 1)
        return "tcp", (host, int(port))
    return "tcp", (addr, DEFAULT_TCP_PORT)


class AgentBackend(Backend):
    name = "agent"

    def __init__(self, address: Optional[str] = None,
                 timeout_s: float = 10.0,
                 connect_retry_s: float = 0.0) -> None:
        self.address = address or f"unix:{DEFAULT_SOCKET}"
        self.timeout_s = timeout_s
        self.connect_retry_s = connect_retry_s
        self._connected_once = False
        self._sock: Optional[socket.socket] = None
        self._file = None
        self._lock = threading.Lock()
        self._opened = False
        # client watch id -> spec; the cached-read fast path covers the
        # union of the field sets.  Daemon watches are connection-scoped,
        # so on reconnect every spec is replayed and the (possibly new)
        # server-side id is tracked in the spec's "server_id".
        self._watches: Dict[int, Dict[str, Any]] = {}
        self._bulk_unsupported = False
        # sweep_frame negotiation: one "unknown op" reply pins the JSON
        # path FOREVER on this backend (unlike _bulk_unsupported it does
        # not re-probe on reconnect: an old agent in a reconnect loop
        # must not pay a failed probe per connection).  The decoder and
        # the negotiated flag are per-connection — a reconnect resets
        # both, which is what resets the delta tables on both sides.
        self._sweep_frame_unsupported = False
        self._frame_negotiated = False
        self._frame_decoder: Optional[SweepFrameDecoder] = None
        #: cumulative sweep-RPC wire statistics, surfaced by the
        #: exporter self-metrics (tpumon_exporter_sweep_rpc_bytes /
        #: sweep_decode_seconds).  Mutated under self._lock; covers the
        #: binary AND the JSON-oracle path so the wire win is visible
        #: on the same dashboard either way.
        self._wire_stats: Dict[str, float] = {
            "rpc_bytes_total": 0.0, "decode_seconds_total": 0.0,
            "last_rpc_bytes": 0.0, "last_decode_seconds": 0.0,
            "binary_frames_total": 0.0, "json_sweeps_total": 0.0,
        }
        self._last_line_io = (0, 0.0)  # (resp bytes, json parse seconds)

    # -- connection management ------------------------------------------------

    def _connect(  # tpumon-check: disable=blocking-while-locked
            self) -> None:  # tpumon-lint: disable=lock-discipline
        # (callers hold self._lock — or are single-threaded during the
        # startup probe — so the connection-state writes cannot race;
        # connect/makefile/retry-sleep run under that lock BY DESIGN:
        # the lock is the per-connection RPC serializer, and every
        # caller of an agent RPC expects to wait its turn)
        kind, target = _parse_address(self.address)
        # connect_retry_s > 0 tolerates a still-starting agent: the socket
        # file exists from bind() a moment before listen() is live, so a
        # client racing startup can see ECONNREFUSED (or ENOENT) on a
        # socket that will accept microseconds later.  Callers that just
        # spawned the agent opt in; the default (0) fails fast.  The
        # window applies only until the agent has been seen alive once —
        # a transparent reconnect after it dies must not stall every RPC
        # for the window while holding the call lock.
        retry_s = 0.0 if self._connected_once else self.connect_retry_s
        deadline = time.monotonic() + retry_s
        while True:
            if kind == "unix":
                s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            else:
                s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
                # 1 Hz small request/reply traffic is the textbook
                # Nagle victim: without TCP_NODELAY every sub-MSS sweep
                # request can sit behind the previous reply's delayed
                # ACK (~40 ms), which at fleet scale dwarfs the RPC
                s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            s.settimeout(self.timeout_s)
            try:
                s.connect(target)
                break
            except OSError as e:
                s.close()
                # within the opt-in window any connect failure is treated
                # as transient (refused/ENOENT before listen(), EAGAIN or
                # timeout under load) — the deadline bounds the wait, and
                # the fail-fast default keeps reconnects instant
                if time.monotonic() >= deadline:
                    raise LibraryNotFound(
                        f"cannot connect to the agent at "
                        f"{self.address}: {e}")
                time.sleep(0.05)
        self._sock = s
        self._file = s.makefile("rwb")
        self._connected_once = True
        # the peer may have been upgraded since the last connection; let
        # the bulk fast path re-probe instead of latching the fallback
        self._bulk_unsupported = False
        # fresh connection -> fresh delta tables on BOTH sides (the
        # server's table is connection-scoped) and a new negotiation
        # round trip for the binary framing
        self._frame_negotiated = False
        self._frame_decoder = None
        self._replay_watches()

    def _raw_request(  # tpumon-check: disable=blocking-while-locked,hot-encode
            self, req: Dict[str, Any]) -> Dict[str, Any]:
        """One request/response on the current connection; caller holds
        the lock (or is single-threaded during connect) — the write/
        flush/readline under it ARE the serialized RPC, and the one
        request-line encode is the JSON codec for negotiation and
        non-sweep ops (the sweep hot path is binary frames).

        Any short/garbled read raises ``OSError`` so the caller tears
        the connection down and reconnects — a desynchronized stream
        (half a response left on the socket after a timeout) must never
        be read as the NEXT call's reply.  JSON here is the negotiation
        + non-sweep-op + oracle-fallback codec; the sweep hot path is
        the binary ``sweep_frame`` op."""

        self._file.write(
            json.dumps(  # tpumon-lint: disable=json-in-sweep-path
                req, separators=(",", ":")).encode() + b"\n")
        self._file.flush()
        line = self._file.readline()
        if not line:
            raise OSError("connection closed by agent")
        if not line.endswith(b"\n"):
            # EOF/timeout mid-line: the framing is lost, not just this
            # reply — fail as a connection error so the caller reconnects
            raise OSError(f"short read from agent "
                          f"({len(line)} bytes, no newline)")
        t0 = time.monotonic()
        try:
            resp = json.loads(line)  # tpumon-lint: disable=json-in-sweep-path
        except ValueError as e:
            raise OSError(f"malformed JSON from agent: {e}")
        self._last_line_io = (len(line), time.monotonic() - t0)
        if not isinstance(resp, dict):
            raise OSError("non-object JSON from agent")
        return resp

    def _replay_watches(self) -> None:
        """Re-register client watches on a fresh connection.

        The daemon scopes watches to the connection that created them
        (so exporter restarts never orphan daemon watches); a transparent
        reconnect must therefore replay every live spec or the sampler
        stops and ``agent_latest`` would serve frozen values forever.
        """

        for wid, spec in list(self._watches.items()):
            resp = self._raw_request({
                "op": "watch",
                "fields": sorted(spec["fields"]),
                "freq_us": spec["freq_us"],
                "keep_age_s": spec["keep_age_s"],
            })
            if resp.get("ok"):
                spec["server_id"] = int(resp["watch_id"])
            else:
                # agent no longer accepts the watch: drop it from the
                # cache union so read_fields falls back to live reads
                del self._watches[wid]

    def _call(self, op: str, _want_io: bool = False,
              **params) -> Any:
        """One RPC.  ``_want_io=True`` additionally returns the
        response's (bytes, json-parse seconds), captured while the
        connection lock is still held — reading ``_last_line_io`` after
        release would let a concurrent RPC from another thread (REST,
        policy) clobber it and misattribute its reply to this call."""

        req = dict(params)
        req["op"] = op
        with self._lock:
            for attempt in (0, 1):
                try:
                    if self._file is None:
                        self._connect()
                    resp = self._raw_request(req)
                    io = self._last_line_io
                    break
                except OSError as e:
                    self._teardown()
                    if attempt == 1:
                        raise BackendError(f"agent RPC {op} failed: {e}")
        if not resp.get("ok"):
            err = resp.get("error", "unknown agent error")
            if "no such chip" in err:
                raise ChipNotFound(err)
            raise BackendError(f"agent {op}: {err}")
        return (resp, io) if _want_io else resp

    def _teardown(self) -> None:
        if self._file is not None:
            try:
                self._file.close()
            except OSError:
                pass
            self._file = None
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    # -- Backend interface ----------------------------------------------------

    def open(self) -> None:
        with self._lock:
            if not self._opened:
                self._connect()
                self._opened = True
        self._call("hello", client="tpumon-python", version="0.1.0")

    def close(self) -> None:
        with self._lock:
            self._teardown()
            self._opened = False
            # an explicit reopen is a user-initiated (re)start, not the
            # per-RPC transparent reconnect the retry suppression is for —
            # let it ride out agent startup again if the caller opted in
            self._connected_once = False

    def chip_count(self) -> int:
        return int(self._call("hello")["chip_count"])

    def chip_info(self, index: int) -> ChipInfo:
        d = self._call("chip_info", index=index)["info"]
        return ChipInfo(
            index=index,
            uuid=d.get("uuid", ""),
            name=d.get("name", "TPU"),
            arch=ChipArch(d["arch"]) if d.get("arch") in
            [a.value for a in ChipArch] else ChipArch.UNKNOWN,
            serial=d.get("serial", ""),
            dev_path=d.get("dev_path", ""),
            firmware=d.get("firmware", ""),
            driver_version=d.get("driver_version", ""),
            cores_per_chip=int(d.get("cores_per_chip", 1)),
            power_limit_w=d.get("power_limit_w"),
            hbm=HbmInfo(total=d.get("hbm_total_mib")),
            clocks_max=ClockInfo(tensorcore=d.get("tc_clock_mhz"),
                                 hbm=d.get("hbm_clock_mhz")),
            pci=PciInfo(bus_id=d.get("pci_bus_id", ""),
                        bandwidth_mb_s=d.get("pci_bw_mb_s")),
            coords=ChipCoords(x=int(d.get("x", 0)), y=int(d.get("y", 0)),
                              z=int(d.get("z", 0)),
                              slice_index=int(d.get("slice", 0))),
            numa_node=d.get("numa_node"),
            host=d.get("host", ""),
        )

    def versions(self) -> VersionInfo:
        d = self._call("hello")
        return VersionInfo(driver=d.get("driver", ""),
                           runtime=d.get("runtime", ""),
                           framework=d.get("agent_version", "tpu-hostengine"))

    def ensure_watch(self, field_ids: Sequence[int],
                     freq_us: int = 1_000_000,
                     keep_age_s: float = 300.0) -> int:
        """Create an agent-side watch (dcgmWatchFields-in-hostengine).

        After this, ``read_fields`` covering only watched fields is served
        from the daemon's sample cache — the device is sampled once by the
        agent regardless of how many monitor clients attach.
        """

        resp = self._call("watch", fields=[int(f) for f in field_ids],
                          freq_us=int(freq_us), keep_age_s=float(keep_age_s))
        wid = int(resp["watch_id"])
        with self._lock:
            self._watches[wid] = {
                "fields": {int(f) for f in field_ids},
                "freq_us": int(freq_us),
                "keep_age_s": float(keep_age_s),
                "server_id": wid,
            }
        return wid

    def unwatch(self, watch_id: int) -> None:
        with self._lock:
            spec = self._watches.pop(int(watch_id), None)
        server_id = spec["server_id"] if spec else int(watch_id)
        try:
            self._call("unwatch", watch_id=int(server_id))
        except BackendError as e:
            # if the connection dropped mid-unwatch, the daemon already
            # removed the connection-scoped watch; a "no such watch" from
            # the replacement connection means the teardown succeeded
            if spec is None or "no such watch" not in str(e):
                raise

    def agent_latest(self, index: int,
                     field_ids: Sequence[int]) -> Dict[int, FieldValue]:
        resp = self._call("latest", index=index,
                          fields=[int(f) for f in field_ids])
        return {int(k): v for k, v in resp.get("values", {}).items()}

    def agent_samples(self, index: int, field_id: int,
                      since: float = 0.0) -> List[Tuple[float, float]]:
        resp = self._call("samples", index=index, field=int(field_id),
                          since=float(since))
        return [(float(ts), float(v)) for ts, v in resp.get("samples", [])]

    def read_fields(self, index: int, field_ids: Sequence[int],
                    now: Optional[float] = None) -> Dict[int, FieldValue]:
        field_ids = [int(f) for f in field_ids]
        with self._lock:
            union: set = set()
            for spec in self._watches.values():
                union |= spec["fields"]
        watched = [f for f in field_ids if f in union]
        out: Dict[int, FieldValue] = {}
        if watched:
            out.update(self.agent_latest(index, watched))
        # live-read everything the cache couldn't serve: unwatched fields,
        # vector fields the sampler doesn't cache, and watched fields before
        # the sampler's first sweep
        missing = [f for f in field_ids if out.get(f) is None]
        if missing:
            resp = self._call("read_fields", index=index, fields=missing)
            out.update({int(k): v
                        for k, v in resp.get("values", {}).items()})
        return out

    def read_fields_bulk(
            self, requests: Sequence[Tuple[int, Sequence[int]]],
            now: Optional[float] = None,
            max_age_s: Optional[float] = None,
    ) -> Dict[int, Dict[int, FieldValue]]:
        """One RPC for a whole-host sweep.

        The daemon serves each (chip, field) from its sampler cache — which
        is shared across ALL connections, hostengine-style — when the cached
        sample is no older than ``max_age_s``, else live-reads it.  Pass the
        caller's own freshness requirement (the watch layer sends 2x its
        fastest due period) or ``None`` to accept any retention-fresh value.
        Falls back per chip against an older agent that does not know the op.

        A lost chip does not sink the sweep: the daemon omits it from the
        response (reporting it under ``errors``), so healthy chips keep
        getting fresh samples and the lost chip's series simply goes blank.
        """

        return self.sweep_fields_bulk(requests, now=now,
                                      max_age_s=max_age_s)[0]

    def sweep_fields_bulk(
            self, requests: Sequence[Tuple[int, Sequence[int]]],
            now: Optional[float] = None,
            max_age_s: Optional[float] = None,
            events_since: Optional[int] = None,
    ) -> Tuple[Dict[int, Dict[int, FieldValue]], Optional[List[Event]]]:
        """Whole-host sweep + piggybacked event drain in ONE RPC.

        Hot path: the binary ``sweep_frame`` op — per-connection delta
        frames carrying only the (chip, field) values whose (type,
        value) identity changed since the last frame, decoded into a
        client-side mirror and materialized as a full snapshot.  An
        agent that does not know the op answers one "unknown op" and
        the client pins the JSON ``read_fields_bulk`` path forever (the
        differential oracle; byte-for-byte the pre-binary protocol).
        An agent that predates even the combined JSON op ignores
        ``events_since`` and returns no ``events`` key; ``None`` events
        tells the caller to poll separately.
        """

        if self._bulk_unsupported:
            return (super(AgentBackend, self).read_fields_bulk(
                requests, now=now), None)
        if not requests:
            return ({}, None)
        if not self._sweep_frame_unsupported:
            try:
                return self._sweep_frame_call(requests, max_age_s,
                                              events_since)
            except _SweepFrameUnknownOp:
                self._sweep_frame_unsupported = True  # JSON forever
        reqs = [{"index": int(idx), "fields": [int(f) for f in fids]}
                for idx, fids in requests]
        params: Dict[str, Any] = {"reqs": reqs}
        if max_age_s is not None:
            params["max_age_s"] = float(max_age_s)
        if events_since is not None:
            params["events_since"] = int(events_since)
        try:
            resp, (nbytes, parse_s) = self._call(
                "read_fields_bulk", _want_io=True, **params)
        except BackendError as e:
            if "unknown op" in str(e):
                self._bulk_unsupported = True
                return (super(AgentBackend, self).read_fields_bulk(
                    requests, now=now), None)
            raise
        t0 = time.monotonic()
        chips = {int(idx): {int(k): v for k, v in vals.items()}
                 for idx, vals in resp.get("chips", {}).items()}
        decode_s = parse_s + (time.monotonic() - t0)
        with self._lock:
            self._account_sweep(nbytes, decode_s, binary=False)
        events = None
        if events_since is not None and "events" in resp:
            events = self._decode_events(resp["events"])
        return (chips, events)

    # -- binary sweep frames (tpumon_torch/sweepframe.py codec) ---------------------

    def _sweep_frame_call(
            self, requests: Sequence[Tuple[int, Sequence[int]]],
            max_age_s: Optional[float],
            events_since: Optional[int],
    ) -> Tuple[Dict[int, Dict[int, FieldValue]], Optional[List[Event]]]:
        """Lock/teardown/retry shell around one sweep_frame exchange —
        the `_call` contract, with binary framing."""

        with self._lock:
            for attempt in (0, 1):
                try:
                    if self._file is None:
                        self._connect()
                    return self._sweep_frame_io(requests, max_age_s,
                                                events_since)
                except OSError as e:
                    # covers timeouts and short reads mid-frame: the
                    # stream position is unknowable, so tear down and
                    # reconnect rather than desynchronize
                    self._teardown()
                    if attempt == 1:
                        raise BackendError(
                            f"agent RPC sweep_frame failed: {e}")
        raise AssertionError("unreachable")

    def _account_sweep(self, nbytes: int, decode_s: float,
                       binary: bool) -> None:
        # caller holds self._lock
        ws = self._wire_stats
        ws["rpc_bytes_total"] += nbytes
        ws["decode_seconds_total"] += decode_s
        ws["last_rpc_bytes"] = float(nbytes)
        ws["last_decode_seconds"] = decode_s
        ws["binary_frames_total" if binary else "json_sweeps_total"] += 1.0

    def sweep_wire_stats(self) -> Dict[str, float]:
        """Sweep-RPC wire counters for the exporter self-metrics."""

        with self._lock:
            return dict(self._wire_stats)

    def _sweep_frame_io(  # tpumon-check: disable=blocking-while-locked,hot-encode
            self, requests: Sequence[Tuple[int, Sequence[int]]],
            max_age_s: Optional[float],
            events_since: Optional[int],
    ) -> Tuple[Dict[int, Dict[int, FieldValue]], Optional[List[Event]]]:
        """One sweep_frame exchange; caller holds the lock (the lock
        is the RPC serializer — the flush/read under it are the call;
        the probe-line encode runs once per connection).

        The first request of a connection goes as a JSON line so an
        older agent can answer a parseable "unknown op" (a binary frame
        would sit in its line buffer forever); once the agent has
        answered with a binary frame, subsequent requests use the
        compact varint-framed form.  Raises ``OSError`` on ANY short or
        out-of-frame read — the caller must tear down, which resets the
        delta tables on both sides.
        """

        if self._frame_negotiated:
            self._file.write(encode_sweep_request(
                requests, max_age_s, events_since))
        else:
            probe: Dict[str, Any] = {
                "op": "sweep_frame",
                "reqs": [{"index": int(idx),
                          "fields": [int(f) for f in fids]}
                         for idx, fids in requests]}
            if max_age_s is not None:
                probe["max_age_s"] = float(max_age_s)
            if events_since is not None:
                probe["events_since"] = int(events_since)
            self._file.write(
                json.dumps(  # tpumon-lint: disable=json-in-sweep-path
                    probe, separators=(",", ":")).encode() + b"\n")
        self._file.flush()
        lead = self._file.read(1)
        if not lead:
            raise OSError("connection closed by agent")
        if lead[0] != SWEEP_FRAME_MAGIC:
            return self._sweep_frame_json_reply(lead)
        # varint length, then exactly that many payload bytes; a
        # buffered read returning short means EOF mid-frame
        length = 0
        shift = 0
        header = 1
        while True:
            b = self._file.read(1)
            if not b:
                raise OSError("short read in sweep frame header")
            header += 1
            length |= (b[0] & 0x7F) << shift
            if not b[0] & 0x80:
                break
            shift += 7
            if shift > 63:
                raise OSError("malformed sweep frame length")
        payload = self._file.read(length)
        if len(payload) < length:
            raise OSError(f"short read in sweep frame: "
                          f"{len(payload)}/{length} bytes")
        self._frame_negotiated = True
        decoder = self._frame_decoder
        if decoder is None:
            decoder = self._frame_decoder = SweepFrameDecoder()
        t0 = time.monotonic()
        try:
            events = decoder.apply(payload)
            chips = decoder.materialize(requests)
        except ValueError as e:
            # frame-index discontinuity or malformed frame: the delta
            # stream is unusable — reconnect resets both tables
            raise OSError(f"sweep frame decode failed: {e}")
        self._account_sweep(header + length,
                            time.monotonic() - t0, binary=True)
        return (chips, events if events_since is not None else None)

    def _sweep_frame_json_reply(  # tpumon-check: disable=blocking-while-locked
            self, lead: bytes) -> Tuple[Dict[int, Dict[int, FieldValue]],
                                        Optional[List[Event]]]:
        """A JSON line where a binary frame was expected: either the
        old-agent negotiation reply ("unknown op") or an error.
        Caller holds the RPC lock; the readline is the reply."""

        if lead != b"{":
            raise OSError(f"desynchronized agent stream "
                          f"(unexpected lead byte {lead!r})")
        line = lead + self._file.readline()
        if not line.endswith(b"\n"):
            raise OSError("short read in agent response line")
        try:
            resp = json.loads(line)  # tpumon-lint: disable=json-in-sweep-path
        except ValueError as e:
            raise OSError(f"malformed JSON from agent: {e}")
        err = str(resp.get("error", ""))
        if not resp.get("ok") and "unknown op" in err:
            raise _SweepFrameUnknownOp(err)
        raise BackendError(
            f"agent sweep_frame: {err or 'unexpected JSON reply'}")

    def processes(self, index: int) -> List[DeviceProcess]:
        resp = self._call("processes", index=index)
        return [DeviceProcess(pid=int(p["pid"]), name=p.get("name", ""),
                              hbm_used_mib=p.get("hbm_used_mib"))
                for p in resp.get("processes", [])]

    def topology(self, index: int) -> TopologyInfo:
        t = self._call("topology", index=index)["topo"]
        return TopologyInfo(
            coords=ChipCoords(x=int(t.get("x", 0)), y=int(t.get("y", 0)),
                              z=int(t.get("z", 0)),
                              slice_index=int(t.get("slice", 0))),
            cpu_affinity=t.get("cpu_affinity", ""),
            numa_node=t.get("numa_node"),
            links=[P2PLink(chip_index=int(l["chip"]),
                           bus_id=l.get("bus_id", ""),
                           link=P2PLinkType(int(l.get("link", 0))),
                           hops=int(l.get("hops", 0)))
                   for l in t.get("links", [])],
            mesh_shape=tuple(t.get("mesh_shape", ())),
            wrap=tuple(bool(w) for w in t.get("wrap", ())),
        )

    @staticmethod
    def _decode_events(raw: List[Dict[str, Any]]) -> List[Event]:
        out: List[Event] = []
        for e in raw:
            try:
                et = EventType(int(e.get("etype", 0)))
            except ValueError:
                et = EventType.NONE
            out.append(Event(etype=et, timestamp=float(e["timestamp"]),
                             seq=int(e.get("seq", 0)),
                             chip_index=int(e.get("chip_index", -1)),
                             uuid=e.get("uuid", ""),
                             data=e.get("data", {}) or {},
                             message=e.get("message", "")))
        return out

    def poll_events(self, since_seq: int) -> List[Event]:
        resp = self._call("events", since_seq=int(since_seq))
        return self._decode_events(resp.get("events", []))

    def current_event_seq(self) -> int:
        return int(self._call("events", since_seq=-1, peek=True)
                   .get("last_seq", 0))

    def agent_introspect(self) -> Dict[str, Any]:
        """Daemon self-metrics (hostengine_status.go analog)."""

        return self._call("introspect")

    def burst_stats(self) -> Optional[Dict[str, float]]:
        """Burst-loop health from the agent hello (``--burst-hz``
        daemons advertise ``burst_hz``/``burst_overruns`` there);
        ``None`` when the agent runs no burst loop.  One cheap RPC —
        the exporter refreshes it on its 1 Hz introspect throttle, so
        a silently-degraded inner loop (overruns climbing) is visible
        from the scrape instead of stale."""

        d = self._call("hello")
        if "burst_hz" not in d:
            return None
        try:
            return {"burst_hz": float(d["burst_hz"]),
                    "burst_overruns": float(d.get("burst_overruns", 0))}
        except (TypeError, ValueError):
            return None


# -- StartHostengine mode (admin.go:149-209 analog) ----------------------------

AGENT_BIN_ENV = "TPUMON_AGENT_BIN"

#: the directory holding the ``tpumon_torch`` package, put on the spawned
#: agent's ``PYTHONPATH`` so ``-m tpumon_torch.hostengine`` resolves from
#: any working directory
_PACKAGE_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _agent_command() -> List[str]:
    """The agent to start: ``$TPUMON_AGENT_BIN`` when set, else the port's
    own hostengine under this interpreter."""

    env = os.environ.get(AGENT_BIN_ENV)
    if env:
        return [env]
    return [sys.executable, "-m", "tpumon_torch.hostengine"]


def _agent_env() -> Dict[str, str]:
    env = dict(os.environ)
    path = env.get("PYTHONPATH")
    env["PYTHONPATH"] = (_PACKAGE_ROOT + os.pathsep + path if path
                         else _PACKAGE_ROOT)
    return env


def start_agent(  # tpumon-check: disable=blocking-while-locked
        address: Optional[str] = None,
        extra_args: Optional[List[str]] = None,
        wait_s: float = 10.0) -> Tuple[subprocess.Popen, str]:
    """Start a local agent on a private socket; returns (proc, address).

    Mirrors admin.go:149-194: private ``--domain-socket /tmp/tpumonXXX``,
    then poll until connectable.  ``tpumon_torch.init()`` calls this under
    its handle lock by design — handle creation is serialized, slow, and
    happens once per process, so the spawn/poll wait is the point, not a
    stall.
    """

    if address is None:
        fd, sock_path = tempfile.mkstemp(prefix="tpumon", suffix=".sock")
        os.close(fd)
        os.unlink(sock_path)
        address = f"unix:{sock_path}"
    kind, target = _parse_address(address)
    args = _agent_command()
    if kind == "unix":
        args += ["--domain-socket", target]
    else:
        args += ["--port", str(target[1])]
    args += extra_args or []
    proc = subprocess.Popen(args, stdout=subprocess.DEVNULL,
                            stderr=subprocess.DEVNULL, env=_agent_env())
    deadline = time.monotonic() + wait_s
    last_err: Optional[Exception] = None
    while time.monotonic() < deadline:
        if proc.poll() is not None:
            raise BackendError(
                f"the agent exited rc={proc.returncode} during startup")
        probe = AgentBackend(address=address, timeout_s=1.0)
        try:
            try:
                probe._connect()
            finally:
                # close on BOTH outcomes: the old success-only close
                # leaked one probe socket per 50 ms retry while the
                # daemon was still starting
                probe.close()
            return proc, address
        except LibraryNotFound as e:
            last_err = e
            time.sleep(0.05)
    proc.kill()
    try:
        # reap: the caller may be PID 1 (container) retrying forever, and
        # an unwaited child is a zombie per failed attempt
        proc.wait(timeout=2.0)
    except subprocess.TimeoutExpired:
        pass
    raise BackendError(f"the agent did not come up: {last_err}")


def stop_agent(proc: subprocess.Popen, term_wait_s: float = 5.0) -> None:
    """Escalating teardown: SIGTERM, wait, SIGKILL (admin.go:195-209)."""

    if proc.poll() is not None:
        return
    proc.send_signal(signal.SIGTERM)
    try:
        proc.wait(timeout=term_wait_s)
    except subprocess.TimeoutExpired:
        proc.kill()
        try:
            proc.wait(timeout=2.0)
        except subprocess.TimeoutExpired:
            pass
