"""Hierarchical fleet plane: shard the poller, re-serve each shard as
an agent — fleet-of-fleets with no new protocol.

The port's copy of ``tpumon/fleetshard.py``, imports renamed.  One
:class:`~tpumon_torch.fleetpoll.FleetPoller` is one selector thread; this
module makes the fleet plane *recursive* instead of faster-in-place:

* :class:`FleetShard` runs a private poller over a hash-partitioned
  subset of the hosts and re-serves its aggregate as an
  **agent-compatible** endpoint on a
  :class:`~tpumon_torch.frameserver.FrameServer` listener.  Host rows
  become synthetic chip rows — a stable host → chip-index table fixed at
  construction, with the host address carried as a string field
  (:data:`SF_ADDRESS`) so a remote consumer needs no side channel — and
  the shard answers the exact ``hello`` / JSON-probe /
  ``read_fields_bulk`` / binary ``sweep_frame`` surface an agent
  answers, per-connection delta tables included.
* :class:`ShardedFleet` runs N shard threads and consumes them with a
  plain top-level ``FleetPoller`` speaking the SAME codec and negotiation
  it uses against agents.  The per-host
  :class:`~tpumon_torch.fleetpoll.HostSample` rows are rebuilt from the
  synthetic chips, in the original target order, so callers cannot tell
  the two-level plane from a flat poller.  The process-per-shard form is
  :mod:`tpumon_torch.supervisor` (``--shards N --supervise``).

Incrementality rides BOTH directions of the tree.  Downstream, each
shard's poller keeps its index-only steady shortcut; the shard feed
consumes :meth:`~tpumon_torch.fleetpoll.FleetPoller.last_changed_flags`
and rebuilds only rows whose sweep actually moved (a rebuilt row is
version-bumped only when its content differs, so a JSON-pinned host
with static values still deltas to nothing).  Upstream, each serve
connection keeps a row-version cursor: a steady tick answers with an
index-only frame, a partly-changed tick encodes just the dirty rows
(``SweepFrameEncoder.encode_frame(..., partial=True)``), and only a
fresh connection pays a full keyframe.

Threading: each shard owns its poller on one shard thread; the serve
callbacks run on the FrameServer loop thread; row table, versions and
tick stats are shared between the two under ``FleetShard._lock``.  Tick
driving is pull-based: :meth:`FleetShard.tick` (and
:meth:`ShardedFleet.poll`, which fans it out) triggers one downstream
sweep and waits for it, so the caller stays the single pacemaker at
every level.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple
from zlib import crc32

from . import _codec, log
from .backends.base import FieldValue
from .events import Event
from .fleetpoll import (FleetPoller, HostSample,
                        create_fleet_poller,
                        poll_native_selected)
from .frameserver import ConnHandler, FrameConn, FrameServer
from .sweepframe import SweepFrameEncoder, decode_sweep_request

# -- synthetic chip rows -------------------------------------------------------
#
# One synthetic field id per HostSample column, in a reserved range far
# above the device catalog (fields.py tops out near 1014).  The
# ids are DATA, not protocol: they travel inside the existing
# sweep_frame request/value entries exactly like catalog ids do.

SF_ADDRESS = 9000      # str   — the host's agent address (the label)
SF_UP = 9001           # int   — 1 up / 0 down
SF_CHIPS = 9002        # int   — chip count from the host's hello
SF_DRIVER = 9003       # str   — driver string from the host's hello
SF_POWER_W = 9004      # float — summed board power
SF_MAX_TEMP_C = 9005   # int   — hottest core temp (blank: no reading)
SF_MEAN_TC = 9006      # float — mean TensorCore util (blank: none)
SF_MEAN_HBM = 9007     # float — mean HBM bandwidth util (blank: none)
SF_HBM_USED = 9008     # int   — summed HBM used MiB
SF_HBM_TOTAL = 9009    # int   — summed HBM total MiB
SF_LINKS_UP = 9010     # int   — summed ICI links up
SF_EVENTS = 9011       # int   — the host's cumulative event cursor
SF_LIVE_FIELDS = 9012  # int   — non-blank values across the bulk sweep
SF_DEAD_CHIPS = 9013   # int   — chips whose sweep returned no values
SF_ERROR = 9014        # str   — DOWN reason ("" when up)

#: the full synthetic request set, what a top-level poller asks for
SHARD_FIELDS: List[int] = [
    SF_ADDRESS, SF_UP, SF_CHIPS, SF_DRIVER, SF_POWER_W, SF_MAX_TEMP_C,
    SF_MEAN_TC, SF_MEAN_HBM, SF_HBM_USED, SF_HBM_TOTAL, SF_LINKS_UP,
    SF_EVENTS, SF_LIVE_FIELDS, SF_DEAD_CHIPS, SF_ERROR,
]


def sample_to_row(s: HostSample) -> Dict[int, FieldValue]:
    """One HostSample as a synthetic chip row — types chosen so the
    delta codec round-trips them exactly (ints stay ints, floats stay
    floats, ``None`` travels as a blank)."""

    return {
        SF_ADDRESS: s.address,
        SF_UP: 1 if s.up else 0,
        SF_CHIPS: s.chips,
        SF_DRIVER: s.driver,
        SF_POWER_W: float(s.power_w),
        SF_MAX_TEMP_C: s.max_temp_c,
        SF_MEAN_TC: s.mean_tc_util,
        SF_MEAN_HBM: s.mean_hbm_util,
        SF_HBM_USED: s.hbm_used_mib,
        SF_HBM_TOTAL: s.hbm_total_mib,
        SF_LINKS_UP: s.links_up,
        SF_EVENTS: s.events,
        SF_LIVE_FIELDS: s.live_fields,
        SF_DEAD_CHIPS: s.dead_chips,
        SF_ERROR: s.error,
    }


def _row_int(v: FieldValue) -> int:
    return int(v) if isinstance(v, (int, float)) else 0


def _row_float(v: FieldValue) -> float:
    return float(v) if isinstance(v, (int, float)) else 0.0


def _row_opt(v: FieldValue) -> Any:
    return v if isinstance(v, (int, float)) else None


def _row_str(v: FieldValue) -> str:
    return v if isinstance(v, str) else ""


def row_to_sample(row: Dict[int, FieldValue],
                  address: str = "") -> HostSample:
    """Inverse of :func:`sample_to_row` — the top level rebuilds the
    per-host rows a flat poller would have produced.  ``address`` is
    the partition table's fallback for a row that never delivered its
    :data:`SF_ADDRESS` field (a host two shards restarts deep).

    Module-level coercion helpers on purpose: this runs once per
    CHANGED host per tick (4096 times per full-churn tick at pod
    scale), and per-call closure construction was a measurable slice
    of the rebuild."""

    g = row.get
    return HostSample(
        address=_row_str(g(SF_ADDRESS)) or address,
        up=bool(g(SF_UP)),
        chips=_row_int(g(SF_CHIPS)),
        driver=_row_str(g(SF_DRIVER)),
        power_w=_row_float(g(SF_POWER_W)),
        max_temp_c=_row_opt(g(SF_MAX_TEMP_C)),
        mean_tc_util=_row_opt(g(SF_MEAN_TC)),
        mean_hbm_util=_row_opt(g(SF_MEAN_HBM)),
        hbm_used_mib=_row_int(g(SF_HBM_USED)),
        hbm_total_mib=_row_int(g(SF_HBM_TOTAL)),
        links_up=_row_int(g(SF_LINKS_UP)),
        events=_row_int(g(SF_EVENTS)),
        live_fields=_row_int(g(SF_LIVE_FIELDS)),
        dead_chips=_row_int(g(SF_DEAD_CHIPS)),
        error=_row_str(g(SF_ERROR)),
    )


def partition_targets(targets: Sequence[str],
                      shards: int) -> List[List[int]]:
    """Hash-partition target INDICES over ``shards`` buckets —
    ``crc32`` of the address, so the layout is stable across restarts
    and across processes (Python's ``hash`` is salted).  Duplicate
    addresses land in the same bucket but keep distinct rows, exactly
    like a flat poller keeps distinct rows for duplicate targets."""

    out: List[List[int]] = [[] for _ in range(max(1, int(shards)))]
    for i, t in enumerate(targets):
        out[crc32(t.encode("utf-8")) % len(out)].append(i)
    return out


class ShardAggregateView:
    """Rebuilds per-host :class:`HostSample` rows, in the ORIGINAL
    target order, from a top-level poller's decoded per-shard
    snapshots — the consume half of the shard tree, shared by the
    in-process :class:`ShardedFleet` and the process-per-shard
    :class:`~tpumon_torch.supervisor.ShardSupervisor` (one rebuild
    implementation, however the shards are hosted).

    Single-owner like the poller that feeds it: call :meth:`rebuild`
    from the thread that drives ``top.poll()``.  The per-shard
    reconstruction cache keys on the raw snapshot dict's IDENTITY —
    the top poller's index-only shortcut returns the same object for
    an unchanged shard, so a steady tick rebuilds nothing."""

    def __init__(self, targets: Sequence[str],
                 chip_origin: Sequence[Sequence[int]]) -> None:
        self.targets = list(targets)
        #: shard index -> [original target index per synthetic chip]
        self._chip_origin = [list(o) for o in chip_origin]
        #: per-shard reconstruction cache: (raw dict identity, samples)
        self._recon: List[Tuple[Optional[Dict[int, Dict[int,
                                FieldValue]]], List[HostSample]]] = [
            (None, []) for _ in self._chip_origin]

    def rebuild(self, addresses: Sequence[str],
                top_samples: Sequence[HostSample],
                raw: Dict[str, Optional[Dict[int, Dict[int,
                          FieldValue]]]]) -> List[HostSample]:
        """One tick's per-host rows: ``addresses`` are the shard
        endpoints in shard order, ``top_samples``/``raw`` the
        top-level poller's samples and decoded snapshots for them.  A
        shard that is down (dead child, parked, unreachable) degrades
        to DOWN rows for ITS hosts only — sibling shards' rows are
        untouched (graceful degradation, never a full-fleet stall)."""

        out: List[Optional[HostSample]] = [None] * len(self.targets)
        for i, address in enumerate(addresses):
            rows = raw.get(address)
            top = top_samples[i] if i < len(top_samples) else None
            origin = self._chip_origin[i]
            if top is None or not top.up or rows is None:
                err = top.error if top is not None else "no sample"
                for j in origin:
                    out[j] = HostSample(
                        address=self.targets[j], up=False,
                        error=f"shard {i} unreachable: {err}")
                self._recon[i] = (None, [])
                continue
            cached_raw, cached = self._recon[i]
            if rows is cached_raw:
                # top-level index-only shortcut fired: the snapshot
                # object is LAST tick's — so are the rebuilt samples
                samples = cached
            else:
                samples = [
                    row_to_sample(rows.get(c, {}), self.targets[j])
                    for c, j in enumerate(origin)]
                self._recon[i] = (rows, samples)
            for c, j in enumerate(origin):
                out[j] = samples[c]
        return [s if s is not None else
                HostSample(address=self.targets[k], up=False,
                           error="missing from shard aggregate")
                for k, s in enumerate(out)]

    def changed_flags(self, addresses: Sequence[str],
                      raw: Dict[str, Optional[Dict[int, Dict[int,
                                FieldValue]]]],
                      top_changed: Sequence[bool]) -> List[bool]:
        """Per-host changed flags in original target order — ``False``
        exactly for hosts whose shard hit the top-level index-only
        shortcut (drop-in for ``FleetPoller.last_changed_flags``)."""

        flags = [True] * len(self.targets)
        for i, address in enumerate(addresses):
            if (raw.get(address) is not None
                    and i < len(top_changed) and not top_changed[i]):
                for j in self._chip_origin[i]:
                    flags[j] = False
        return flags


class _ShardHandler(ConnHandler):
    """The agent op surface of one shard (FrameServer loop thread):
    the same ``hello`` / ``sweep_frame`` probe / binary request /
    ``read_fields_bulk`` dispatch the agents and the simulated farm
    answer, backed by the shard's synthetic row table."""

    def __init__(self, shard: "FleetShard") -> None:
        self._shard = shard

    def on_binary(self, server: FrameServer, conn: FrameConn,
                  payload: bytes) -> None:
        # steady-state fast path mirrors agentsim: the fleet client's
        # binary request is byte-identical every tick, so its decode
        # is cached per connection
        if payload == conn.data.get("last_req"):
            reqs = conn.data["last_req_parsed"]
            events_since = conn.data["last_req_events_since"]
        else:
            reqs, _max_age, events_since = decode_sweep_request(payload)
            conn.data["last_req"] = payload
            conn.data["last_req_parsed"] = reqs
            conn.data["last_req_events_since"] = events_since
        server.send(conn, self._shard._serve_frame(conn, reqs,
                                                   events_since))

    def on_json(self, server: FrameServer, conn: FrameConn,
                req: Dict[str, Any]) -> None:
        shard = self._shard
        op = req.get("op")
        if op == "hello":
            self._reply_json(server, conn, shard._hello())
        elif op == "sweep_frame":
            # the negotiation probe: a shard always speaks frames
            reqs = [(int(r["index"]), [int(f) for f in r["fields"]])
                    for r in req.get("reqs", [])]
            es = req.get("events_since")
            server.send(conn, shard._serve_frame(
                conn, reqs, int(es) if es is not None else None))
        elif op == "read_fields_bulk":
            # the JSON oracle path (old clients, differential tests):
            # byte-compatible with the agent's reply shape
            reqs = [(int(r["index"]), [int(f) for f in r["fields"]])
                    for r in req.get("reqs", [])]
            resp: Dict[str, Any] = {
                "ok": True,
                "chips": {str(c): {str(f): v for f, v in vals.items()}
                          for c, vals in
                          shard._request_rows(reqs).items()}}
            if "events_since" in req:
                # the shard's own event stream: the detection plane's
                # findings, re-served in the agent's JSON event shape
                resp["events"] = [
                    {"etype": int(e.etype), "timestamp": e.timestamp,
                     "seq": e.seq, "chip_index": e.chip_index,
                     "uuid": e.uuid, "message": e.message}
                    for e in shard._pending_events(
                        int(req.get("events_since", 0)))]
            self._reply_json(server, conn, resp)
        elif op == "events":
            self._reply_json(server, conn,
                             {"ok": True, "last_seq": 0, "events": []})
        else:
            self._reply_json(server, conn,
                             {"ok": False, "error": f"unknown op: {op}"})

    def _reply_json(self, server: FrameServer, conn: FrameConn,
                    obj: Dict[str, Any]) -> None:
        # once per connection (hello) or on the explicit JSON oracle
        # path — the steady tee upstream is binary frames only
        data = json.dumps(  # tpumon-lint: disable=json-in-sweep-path
            obj, separators=(",", ":"))
        server.send(conn, data.encode("utf-8") + b"\n")  # tpumon-lint: disable=encode-in-hot-path


class FleetShard:
    """One poller shard: sweeps its host subset, serves the aggregate
    as synthetic chip rows on an agent-compatible endpoint.

    The shard thread (started by :meth:`start`) waits for tick
    requests, runs one downstream :meth:`~tpumon_torch.fleetpoll.
    FleetPoller.poll`, folds changed hosts into the row table, and
    signals completion; :meth:`tick` is the caller-side
    trigger-and-wait.  Serving is passive — the upstream poller PULLS
    a frame per tick through the normal request path, so a shard with
    no upstream consumer costs nothing upstream.
    """

    def __init__(self, shard_id: int, targets: Sequence[str],
                 field_ids: Sequence[int],
                 timeout_s: float = 3.0,
                 blackbox_dir: Optional[str] = None,
                 blackbox_max_bytes: Optional[int] = None,
                 stream_hub: Optional[Any] = None,
                 rules: Optional[Any] = None,
                 **poller_kwargs: Any) -> None:
        """``rules`` (a :class:`tpumon_torch.anomaly.Rules`) arms the
        shard's private poller with per-host streaming detectors;
        the findings it fires are re-served UPSTREAM as piggybacked
        events on the agent wire (``EventType.ANOMALY``/``INCIDENT``),
        so a top-level consumer sees the detection plane's verdicts
        through the ordinary event drain — no new protocol."""

        self.shard_id = int(shard_id)
        self.targets = list(targets)
        self._handler = _ShardHandler(self)
        self.address = ""  # set by serve_on()
        #: guards the row table, versions, last samples and tick stats
        #: (shard thread writes, FrameServer loop + metrics read)
        self._lock = threading.Lock()
        self._rows: Dict[int, Dict[int, FieldValue]] = {}
        self._row_ver: List[int] = [0] * len(self.targets)
        self._ver = 0
        self._samples: List[HostSample] = []
        self.ticks_total = 0
        self.last_tick_seconds = 0.0
        self.last_hosts_down = 0
        # tick driving: generation-counted, not a bare Event pair — a
        # timed-out tick's LATE completion must not satisfy the NEXT
        # tick's wait (that would flip the wedged-shard gauge back to
        # up while serving data a full tick behind)
        self._cv = threading.Condition()
        self._want_seq = 0   # caller-side trigger generation
        self._done_seq = 0   # last generation the shard completed
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        #: did the last :meth:`tick` complete within its deadline?
        #: (caller-thread state, like the tick() drive itself)
        self.last_tick_fresh = True
        #: detection-plane findings re-served upstream as piggybacked
        #: events (bounded ring; guarded by self._lock like the rows)
        self._events: List[Event] = []
        self._event_seq = 0
        self._max_events = 256
        #: the same findings as records, for the owner-side drain
        #: (ShardedFleet.take_findings -> the fleet CLI's '!' lines);
        #: guarded by self._lock — the shard thread appends, the
        #: consuming thread drains
        self._findings_buf: List[Tuple[str, Any]] = []
        # the private poller (it owns a selector, and recorders when
        # blackbox_dir is set) is acquired LAST: everything above is
        # passive state, so a raising constructor leaks nothing
        self._poller = create_fleet_poller(
            self.targets, field_ids, timeout_s=timeout_s,
            client_name=f"tpumon-fleetshard-{shard_id}",
            blackbox_dir=blackbox_dir,
            blackbox_max_bytes=blackbox_max_bytes,
            stream_hub=stream_hub, rules=rules, **poller_kwargs)

    # -- serve side (any thread for registration; callbacks on loop) ----------

    def handler(self) -> ConnHandler:
        return self._handler

    def serve_on(self, server: FrameServer, *,
                 path: Optional[str] = None,
                 tcp_port: Optional[int] = None,
                 tcp_host: str = "") -> str:
        """Register this shard's listener (unix by default, TCP when
        ``tcp_port`` is given) and remember the address.  Call before
        ``server.start()``."""

        if tcp_port is not None:
            self.address = server.add_tcp_listener(
                self._handler, host=tcp_host, port=tcp_port)
        else:
            self.address = server.add_unix_listener(self._handler, path)
        return self.address

    def _hello(self) -> Dict[str, Any]:
        # the hello carries the shard's own health next to the
        # inventory: ticks_total is the supervisor's staleness signal
        # (a wedged shard answers hello from the serve thread while
        # its poller thread is stuck — the tick counter not advancing
        # is what gives it away), the way an agent's hello
        # carries burst-loop health
        st = self.stats()
        return {"ok": True, "chip_count": len(self.targets),
                "driver": f"tpumon-fleetshard {self.shard_id}",
                "runtime": "fleetshard",
                "agent_version": "tpumon-fleetshard",
                "shard": {"id": self.shard_id,
                          "hosts": st["hosts"],
                          "ticks_total": st["ticks_total"],
                          "tick_seconds": st["tick_seconds"],
                          "hosts_down": st["hosts_down"],
                          "fresh": bool(self.last_tick_fresh)}}

    def _request_rows(self, reqs: Sequence[Tuple[int, Sequence[int]]],
                      only: Optional[Sequence[int]] = None,
                      ) -> Dict[int, Dict[int, FieldValue]]:
        """Rows filtered to the request (and to ``only`` when given) —
        the exact chips/fields contract ``materialize`` documents.
        Caller holds no lock; row dicts are replaced wholesale on
        update, never mutated, so a grabbed reference stays coherent."""

        with self._lock:
            rows = dict(self._rows) if only is None else {
                c: self._rows[c] for c in only if c in self._rows}
        out: Dict[int, Dict[int, FieldValue]] = {}
        for idx, fids in reqs:
            row = rows.get(idx)
            if row is None:
                continue
            if list(fids) == SHARD_FIELDS:
                # whole-row fast path (the standard serve: the request
                # IS the SF field set the feed built the row with) —
                # one C-speed dict copy instead of a per-fid rebuild.
                # Exact-list compare, not a length heuristic: a
                # same-size request for OTHER fids must take the
                # filtered path and read blank, not be served SF keys
                # it never asked for
                out[idx] = dict(row)
            else:
                out[idx] = {f: row.get(f) for f in fids}
        return out

    def _pending_events(self, events_since: int) -> List[Event]:
        """Detection-plane events newer than the consumer's cursor
        (any thread; the ring is lock-guarded)."""

        with self._lock:
            return [e for e in self._events if e.seq > events_since]

    def take_findings(self) -> List[Tuple[str, Any]]:
        """Drain this shard's detection-plane findings as
        ``(address, AnomalyRecord)`` — the owner-side view of what
        the serve side piggybacks upstream (any thread; the buffer is
        lock-guarded)."""

        with self._lock:
            out, self._findings_buf = self._findings_buf, []
            return out

    def _serve_frame(self, conn: FrameConn,
                     reqs: Sequence[Tuple[int, Sequence[int]]],
                     events_since: Optional[int] = None) -> bytes:
        """One delta frame for this connection: full on the first
        frame, index-only when nothing moved since the connection's
        cursor, dirty-rows-only otherwise.  Detection-plane findings
        newer than the consumer's ``events_since`` cursor piggyback
        as wire events, exactly like an agent's drain — an
        index-only frame upgrades to an (empty, partial) delta frame
        when events are pending, because index-only frames cannot
        carry them.  Loop thread only."""

        enc: Optional[SweepFrameEncoder] = conn.data.get("enc")
        pending: List[Event] = []
        with self._lock:
            ver = self._ver
            if enc is None:
                dirty: Optional[List[int]] = None  # full keyframe
            elif conn.data["ver"] == ver:
                dirty = []
            else:
                seen = conn.data["ver"]
                rv = self._row_ver
                dirty = [c for c in range(len(rv)) if rv[c] > seen]
            if events_since is not None and self._events:
                pending = [e for e in self._events
                           if e.seq > events_since]
        conn.data["ver"] = ver
        if enc is None:
            enc = conn.data["enc"] = SweepFrameEncoder()
            return enc.encode_frame(self._request_rows(reqs),
                                    events=pending or None)
        if not dirty and not pending:
            return enc.encode_index_only_frame()
        return enc.encode_frame(
            self._request_rows(reqs, only=dirty or []),
            events=pending or None, partial=True)

    # -- feed side (shard thread) ---------------------------------------------

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._run, daemon=True,
            name=f"tpumon-fleetshard-{self.shard_id}")
        self._thread.start()

    def trigger(self) -> int:
        """Request one downstream tick (returns immediately) —
        returns the tick's generation for :meth:`wait`."""

        with self._cv:
            self._want_seq += 1
            want = self._want_seq
            self._cv.notify_all()
        return want

    def wait(self, timeout_s: float, want: Optional[int] = None) -> bool:
        """Wait for generation ``want`` (default: the latest
        triggered) to COMPLETE; ``False`` means the shard is wedged —
        its last rows keep serving, its ``up`` gauge drops, and a
        previous tick finishing late cannot fake this one done."""

        with self._cv:
            target = self._want_seq if want is None else want
            return self._cv.wait_for(
                lambda: self._done_seq >= target, timeout_s)

    def tick(self, timeout_s: float) -> List[HostSample]:
        """Trigger one tick, wait for it, return the per-host samples
        (the shard's own fleet view, in shard-local target order).
        A wedged tick sets :attr:`last_tick_fresh` False and returns
        the PREVIOUS samples — callers that render must say so (the
        ``--shard-serve`` loop prints a staleness warning)."""

        want = self.trigger()
        self.last_tick_fresh = self.wait(timeout_s, want)
        return self.last_samples()

    def last_samples(self) -> List[HostSample]:
        with self._lock:
            return list(self._samples)

    def stats(self) -> Dict[str, Any]:
        """Per-shard gauges for the ``tpumon_fleet_shard_*`` families."""

        alive = self._thread is not None and self._thread.is_alive()
        with self._lock:
            return {"shard": self.shard_id,
                    "hosts": len(self.targets),
                    "up": 1 if alive else 0,
                    "ticks_total": self.ticks_total,
                    "tick_seconds": self.last_tick_seconds,
                    "hosts_down": self.last_hosts_down}

    def _run(self) -> None:
        while True:
            with self._cv:
                self._cv.wait_for(
                    lambda: self._stop.is_set()
                    or self._done_seq < self._want_seq, 0.2)
                if self._stop.is_set():
                    return
                if self._done_seq >= self._want_seq:
                    continue
                # coalescing on purpose: however many triggers queued
                # up while a slow tick ran, ONE fresh sweep satisfies
                # them all (each waiter wants "a tick completed at or
                # after my trigger")
                target = self._want_seq
            try:
                t0 = time.monotonic()
                samples = self._poller.poll()
                changed = self._poller.last_changed_flags()
                self._feed(samples, changed,
                           time.monotonic() - t0,
                           self._poller.take_findings())
            except Exception as e:  # noqa: BLE001 — one bad tick must
                # not kill the shard thread (the poller renders
                # failures as DOWN rows; this guards the feed itself)
                log.warn_every(f"fleetshard.{self.shard_id}", 30.0,
                               "shard %d tick failed: %r",
                               self.shard_id, e)
            with self._cv:
                self._done_seq = target
                self._cv.notify_all()

    def _feed(self, samples: List[HostSample], changed: List[bool],
              tick_seconds: float,
              findings: Optional[List[Tuple[str, Any]]] = None,
              ) -> None:
        """Fold one downstream tick into the row table.  Only hosts
        whose sweep moved are rebuilt, and a rebuilt row is
        version-bumped only when its content actually differs — so the
        serve side's dirty scan stays empty through steady state even
        for JSON-pinned hosts that re-aggregate every tick.

        ``findings`` (``(address, AnomalyRecord)`` pairs from the
        shard's detection plane) become piggybacked events the serve
        side drains upstream — ``chip_index`` is the shard-local ROW
        of the host that fired, so the consumer can attribute the
        verdict without a side channel."""

        if findings:
            from .anomaly import finding_to_event
            addr_row = {t: i for i, t in enumerate(self.targets)}
        with self._lock:
            for addr, rec in findings or ():
                self._event_seq += 1
                self._events.append(finding_to_event(
                    rec, self._event_seq,
                    chip_index=addr_row.get(addr, -1),
                    prefix=f"{addr} "))
            if findings:
                self._findings_buf.extend(findings)
                if len(self._events) > self._max_events:
                    del self._events[:-self._max_events]
                if len(self._findings_buf) > 1024:
                    # an owner that never drains must not grow this
                    del self._findings_buf[:-1024]
            first = not self._rows
            for c, (s, moved) in enumerate(zip(samples, changed)):
                if not moved and not first:
                    continue
                row = sample_to_row(s)
                if self._rows.get(c) != row:
                    self._rows[c] = row
                    self._row_ver[c] = self._ver + 1
            if any(v == self._ver + 1 for v in self._row_ver) or first:
                self._ver += 1
            self._samples = samples
            self.ticks_total += 1
            self.last_tick_seconds = tick_seconds
            self.last_hosts_down = sum(1 for s in samples if not s.up)

    # -- teardown -------------------------------------------------------------

    def close(self) -> None:
        self._stop.set()
        with self._cv:
            self._cv.notify_all()  # wake the run loop's wait
        t, self._thread = self._thread, None
        if t is not None:
            # tpumon: close-ok(join on a live Thread handle raises only for join-current or not-started — both impossible here; the deliberate wedged-thread policy is the return branch below)
            t.join(timeout=10.0)
            if t.is_alive():
                # a wedged shard thread may still be INSIDE poll():
                # closing the single-owner poller under it would rip
                # the selector out of a live select/recv loop — leak
                # it deliberately (the daemon thread dies with the
                # process) and say so
                log.warn_every("fleetshard.close", 30.0,
                               "shard %d thread did not stop in 10s; "
                               "leaking its poller", self.shard_id)
                return
        # the poller is closed HERE, on the caller's thread, never on
        # the shard thread — its selector/socket ownership ends with
        # the thread that drove it (and only once that thread is gone)
        self._poller.close()


class ShardedFleet:
    """Two-level fleet: N :class:`FleetShard` threads under one
    top-level :class:`~tpumon_torch.fleetpoll.FleetPoller` that consumes
    them as agents.  :meth:`poll` is drop-in for ``FleetPoller.poll``
    — per-host samples in the original target order.

    ``blackbox_dir`` / ``stream_hub`` tee at the HOST level (each
    shard's poller records/streams its hosts exactly like a flat
    poller would — same directory layout, same stream names);
    ``top_blackbox_dir`` / ``top_stream_hub`` tee the shard-aggregate
    level (one stream of synthetic rows per shard) for operators who
    want the tree's upper tier durable too.
    """

    def __init__(self, targets: Sequence[str],
                 field_ids: Sequence[int],
                 shards: int = 4,
                 timeout_s: float = 3.0,
                 shard_timeout_s: Optional[float] = None,
                 blackbox_dir: Optional[str] = None,
                 blackbox_max_bytes: Optional[int] = None,
                 stream_hub: Optional[Any] = None,
                 top_blackbox_dir: Optional[str] = None,
                 top_stream_hub: Optional[Any] = None,
                 rules: Optional[Any] = None,
                 top_rules: Optional[Any] = None,
                 **poller_kwargs: Any) -> None:
        """``poller_kwargs`` (reconnect backoff, budget, jitter...)
        reach the per-shard pollers AND the top-level poller (tighter
        backoff at every level makes recovery follow the caller's
        cadence, not the default dial-retry's).

        ``rules`` arms each shard's poller with per-host chip-level
        detectors (findings re-served upstream as piggybacked
        events); ``top_rules`` arms the TOP-level poller, whose
        "chips" are the shards' synthetic host rows (``SF_*``
        fields) — the fleet-view rule set."""

        self.targets = list(targets)
        self._timeout_s = float(timeout_s)
        self._shard_timeout_s = float(shard_timeout_s
                                      if shard_timeout_s is not None
                                      else timeout_s * 2.0)
        self._partition = partition_targets(self.targets, shards)
        self._sockdir = tempfile.mkdtemp(prefix="tpumon-shards-")
        self._server = FrameServer()
        self.shards: List[FleetShard] = []
        #: shard index -> [original target index per synthetic chip]
        self._chip_origin: List[List[int]] = []
        # partial-constructor discipline: shard N's ctor raising (fd
        # exhaustion at scale is exactly when) must close the N-1
        # shards, the frame server and the socket dir already built —
        # each shard is appended BEFORE serve_on so the release path
        # below always sees it
        try:
            for i, idxs in enumerate(self._partition):
                shard = FleetShard(
                    i, [self.targets[j] for j in idxs], field_ids,
                    timeout_s=timeout_s, blackbox_dir=blackbox_dir,
                    blackbox_max_bytes=blackbox_max_bytes,
                    stream_hub=stream_hub, rules=rules,
                    **poller_kwargs)
                self.shards.append(shard)
                shard.serve_on(self._server, path=os.path.join(
                    self._sockdir, f"shard-{i}.sock"))
                self._chip_origin.append(list(idxs))
            self._server.start()
            for shard in self.shards:
                shard.start()
            self._top = create_fleet_poller(
                [s.address for s in self.shards], SHARD_FIELDS,
                timeout_s=timeout_s, client_name="tpumon-fleet-top",
                blackbox_dir=top_blackbox_dir,
                stream_hub=top_stream_hub, rules=top_rules,
                **poller_kwargs)
            # still inside the release scope: a raise past this point
            # (however unlikely) must close the shards/server/top the
            # lines above acquired
            #: the consume-half rebuild (shared with the supervisor)
            self._view = ShardAggregateView(self.targets,
                                            self._chip_origin)
        except BaseException:
            for s in self.shards:
                try:
                    s.close()
                except Exception as e:
                    log.warn_every("fleetshard.init", 30.0,
                                   "shard close after failed init: "
                                   "%r", e)
            # the release path aggregates like close() below: a
            # raising close must not skip the remaining releases
            # or replace the original wiring error
            top = getattr(self, "_top", None)
            if top is not None:
                try:
                    top.close()
                except Exception as e:
                    log.warn_every("fleetshard.init", 30.0,
                                   "top close after failed init: %r",
                                   e)
            try:
                self._server.close()
            except Exception as e:
                log.warn_every("fleetshard.init", 30.0,
                               "server close after failed init: %r", e)
            finally:
                shutil.rmtree(self._sockdir, ignore_errors=True)
            raise
        #: written by the polling thread only; read by metrics
        self._shard_fresh: List[bool] = [True] * len(self.shards)
        #: per-level timing of the last poll
        self.last_shard_wait_s = 0.0
        self.last_top_tick_s = 0.0

    @property
    def server(self) -> FrameServer:
        return self._server

    @property
    def top(self) -> FleetPoller:
        return self._top

    def poll(self) -> List[HostSample]:
        """One two-level tick: fan a downstream tick out to every
        shard in parallel, wait, sweep the shards through the
        top-level poller, and rebuild per-host rows in the original
        target order."""

        t0 = time.monotonic()
        wants = [shard.trigger() for shard in self.shards]
        # ONE shared deadline across every shard wait — the flat
        # poller's bounded-tick property must survive the tree: N
        # wedged shards may not stack N full timeouts onto one poll
        deadline = t0 + self._shard_timeout_s
        self._shard_fresh = [
            shard.wait(max(0.0, deadline - time.monotonic()), want)
            for shard, want in zip(self.shards, wants)]
        t1 = time.monotonic()
        top_samples = self._top.poll()
        self.last_top_tick_s = time.monotonic() - t1
        self.last_shard_wait_s = t1 - t0
        return self._view.rebuild([s.address for s in self.shards],
                                  top_samples,
                                  self._top.raw_snapshots())

    def last_changed_flags(self) -> List[bool]:
        """Drop-in for the flat poller's method (callers that tee the
        two-level plane into a further level)."""

        return self._view.changed_flags(
            [s.address for s in self.shards],
            self._top.raw_snapshots(),
            self._top.last_changed_flags())

    def take_findings(self) -> List[Tuple[str, Any]]:
        """Drain every level's detection-plane findings: shard-level
        engines (``rules`` — chip-level, per host; they ALSO
        piggyback upstream as events) first, then the top-level
        engine (``top_rules`` — over the synthetic shard rows)."""

        out: List[Tuple[str, Any]] = []
        for s in self.shards:
            out += s.take_findings()
        return out + self._top.take_findings()

    def anomaly_stats(self) -> Optional[Dict[str, Any]]:
        return self._top.anomaly_stats()

    def shard_stats(self) -> List[Dict[str, Any]]:
        stats = [s.stats() for s in self.shards]
        for st, fresh in zip(stats, self._shard_fresh):
            if not fresh:
                st["up"] = 0
        return stats

    def self_metric_lines(self) -> List[str]:
        return shard_metric_lines(self.shard_stats())

    def close(self) -> None:
        for shard in self.shards:
            try:
                shard.close()
            except Exception as e:  # noqa: BLE001 — one wedged shard
                # must not leak the rest of the tree
                log.warn_every("fleetshard.close", 30.0,
                               "shard close failed: %r", e)
        # same aggregation below the shard loop: a raising top-level
        # poller close must not leak the frame server or the sockdir
        try:
            self._top.close()
        finally:
            try:
                self._server.close()
            finally:
                shutil.rmtree(self._sockdir, ignore_errors=True)


def shard_metric_lines(stats: Sequence[Dict[str, Any]]) -> List[str]:
    """The ``tpumon_fleet_shard_*`` promtext families: one sample per
    shard, labeled by shard id — a wedged or dead shard shows as
    ``up 0`` with its last tick time frozen, instead of silently
    vanishing from the aggregates."""

    from .exporter.promtext import render_family_samples

    fams = (
        ("tpumon_fleet_shard_up", "gauge",
         "1 when the shard thread is alive and its last tick "
         "completed within the deadline.", "up", "d"),
        ("tpumon_fleet_shard_tick_seconds", "gauge",
         "Wall time of the shard's last downstream sweep.",
         "tick_seconds", ".6f"),
        ("tpumon_fleet_shard_hosts_down", "gauge",
         "Hosts the shard's last sweep rendered DOWN.",
         "hosts_down", "d"),
        ("tpumon_fleet_shard_hosts", "gauge",
         "Hosts assigned to the shard by the hash partition.",
         "hosts", "d"),
        ("tpumon_fleet_shard_ticks_total", "counter",
         "Downstream sweeps completed by the shard.",
         "ticks_total", "d"),
    )
    lines: List[str] = []
    for fam, ptype, help_txt, key, fmt in fams:
        lines += render_family_samples(
            fam, ptype, help_txt,
            [(f'shard="{st["shard"]}"', st[key]) for st in stats],
            fmt)
    # which codec backend this fleet process runs (the exporter serves
    # the same gauge host-side)
    lines += render_family_samples(
        "tpumon_codec_native", "gauge",
        "1 when the native codec extension backs the sweep-frame/"
        "burst codecs, 0 on the pure-Python reference.",
        [("", 1 if _codec.active() else 0)], "d")
    # ...and which POLL plane: the native epoll engine or the
    # pure-Python selector loop
    lines += render_family_samples(
        "tpumon_poll_native", "gauge",
        "1 when the native epoll engine backs the fleet poller, 0 on "
        "the pure-Python selector loop.",
        [("", 1 if poll_native_selected() else 0)], "d")
    return lines
