"""Selector-based fleet multiplexer: one event loop sweeping many hosts.

The port's copy of ``tpumon/fleetpoll.py``, imports renamed.
:class:`FleetPoller` drives N non-blocking agent connections (the port's
``python -m tpumon_torch.hostengine`` on each GPU host, a simulated farm,
or fleet shards) from ONE thread through per-connection state machines:

* **connect** — non-blocking ``connect_ex``; completion detected via
  the selector (write-readiness + ``SO_ERROR``).  TCP connections set
  ``TCP_NODELAY``: 1 Hz small request/reply traffic is the textbook
  Nagle victim.
* **hello, once per connection** — driver/versions/chip count are
  cached for the connection's lifetime (they can only change across an
  agent restart, which forces a reconnect and a fresh hello anyway).
  Chip liveness within a connection comes from the sweep snapshot
  itself (the delta frames carry appear/removed-chip markers).
* **negotiated sweep per tick** — the same wire contract as
  ``AgentBackend.sweep_fields_bulk``: the first sweep of a connection
  is a JSON ``sweep_frame`` probe; a binary frame reply pins the
  varint-framed delta path (:mod:`tpumon_torch.sweepframe`), one
  "unknown op" pins the JSON ``read_fields_bulk`` oracle for the HOST
  forever (an old agent in a reconnect loop must not pay a failed probe
  per connection).  Short/mid-frame reads and frame-index
  discontinuities tear the connection down, which resets the delta
  tables on both sides.  Events ride piggybacked on the sweep
  (``events_since`` cursor per host) — no separate events RPC either.

Deadlines come from a single monotonic clock in the loop: every host
gets ``tick_start + timeout_s``, the selector sleeps until the nearest
one, and a host that misses it is torn down without stalling anyone
else (no per-call ``settimeout`` anywhere).  A host that fails gets
exponential backoff, and reconnect attempts for previously-failed
hosts are capped per tick (``reconnect_budget``) so one flapping rack
cannot starve the sweep.  A REUSED connection that fails mid-tick gets
one fresh-connection retry charged against the same deadline (the
agent may simply have restarted between ticks — a healthy host must
not render DOWN for that).

The inner loop has a native twin, as in the reference:
:class:`NativeFleetPoller` moves the connection machinery into the port's
epoll engine (:mod:`tpumon_torch._poll`, ``native/poll/``) and keeps this
module's policy, and :func:`create_fleet_poller` picks it when the engine
is built (``TPUMON_NATIVE``: ``0`` never, ``1`` strict, unset when
built).  The pure-Python :class:`FleetPoller` stays the executable spec;
``tests/test_torch_fleet_native.py`` holds the two, and the JAX package's
poller, row for row and byte for byte.  Old agents
that predate even the JSON ``read_fields_bulk`` op are served by the
``HostConn`` compat shim in :mod:`tpumon_torch.cli.fleet`.
"""

from __future__ import annotations

import errno
import json
import os
import random
import re
import selectors
import socket
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from . import _poll, log
from .backends.agent import AgentBackend, _parse_address
from .backends.base import FieldValue
from .events import Event
from .sweepframe import (SWEEP_FRAME_MAGIC, SweepFrameDecoder,
                         _decode_event, encode_sweep_request)
from . import fields as FF

F = FF.F

#: connect_ex return codes that mean "in progress, wait for writability"
_INPROGRESS = frozenset({errno.EINPROGRESS, errno.EWOULDBLOCK,
                         errno.EAGAIN, errno.EALREADY, errno.EINTR})


@dataclass
class HostSample:
    """One host's aggregated sweep (a row of the fleet table)."""

    address: str
    up: bool
    chips: int = 0
    driver: str = ""
    power_w: float = 0.0
    max_temp_c: Optional[int] = None
    mean_tc_util: Optional[float] = None
    mean_hbm_util: Optional[float] = None
    hbm_used_mib: int = 0
    hbm_total_mib: int = 0
    links_up: int = 0
    events: int = 0
    live_fields: int = 0     # non-blank values across the bulk sweep
    dead_chips: int = 0      # chips whose sweep returned no values at all
    error: str = ""


def aggregate_host_sample(address: str, chip_count: int, driver: str,
                          per_chip: Dict[int, Dict[int, FieldValue]],
                          event_seq: int) -> HostSample:
    """Fold one host's per-chip sweep into a :class:`HostSample` row.

    Single-sourced: the multiplexer and the ``HostConn`` compat shim
    both aggregate through here, so the fleet table reads identically
    whichever plane sampled it.  A chip the agent omitted (lost before
    the sweep) counts as dead, exactly like the thread-pool path did.
    """

    s = HostSample(address=address, up=True, chips=chip_count,
                   driver=driver)
    # single flat pass, locals for the field ids: this runs once per
    # host per tick on the poller's one thread, so at 256 hosts its
    # constant factor is a direct slice of the tick budget
    f_power = int(F.POWER_USAGE)
    f_temp = int(F.CORE_TEMP)
    f_tc = int(F.TENSORCORE_UTIL)
    f_hbm_bw = int(F.HBM_BW_UTIL)
    f_used = int(F.HBM_USED)
    f_total = int(F.HBM_TOTAL)
    f_links = int(F.ICI_LINKS_UP)
    max_temp: Optional[int] = None
    tc_sum = 0.0
    tc_n = 0
    hbm_sum = 0.0
    hbm_n = 0
    empty: Dict[int, FieldValue] = {}
    for c in range(chip_count):
        vals = per_chip.get(c)
        if vals is None:
            vals = empty
        live = 0
        for v in vals.values():
            if v is not None:
                live += 1
        s.live_fields += live
        if live == 0:
            s.dead_chips += 1
            continue
        # isinstance narrowing, not blind float()/int() coercion: the
        # aggregate fields are numeric by catalog contract, and a
        # non-numeric surprise (version-skewed agent) must blank the
        # cell, not throw mid-aggregation (also what lets this body
        # type-check under mypy --strict)
        p = vals.get(f_power)
        if isinstance(p, (int, float)):
            s.power_w += p
        t = vals.get(f_temp)
        if isinstance(t, (int, float)):
            ti = int(t)
            if max_temp is None or ti > max_temp:
                max_temp = ti
        u = vals.get(f_tc)
        if isinstance(u, (int, float)):
            tc_sum += u
            tc_n += 1
        hb = vals.get(f_hbm_bw)
        if isinstance(hb, (int, float)):
            hbm_sum += hb
            hbm_n += 1
        used = vals.get(f_used)
        if isinstance(used, (int, float)):
            s.hbm_used_mib += int(used)
        total = vals.get(f_total)
        if isinstance(total, (int, float)):
            s.hbm_total_mib += int(total)
        links = vals.get(f_links)
        if isinstance(links, (int, float)):
            s.links_up += int(links)
    s.max_temp_c = max_temp
    s.mean_tc_util = tc_sum / tc_n if tc_n else None
    s.mean_hbm_util = hbm_sum / hbm_n if hbm_n else None
    s.events = event_seq
    return s


# per-connection / per-tick states
_DOWN = 0          # no socket; may be in backoff
_CONNECTING = 1    # connect_ex in flight, waiting for writability
_CONNECTED = 2     # socket up (hello may or may not be done)


class _HostState:
    """One target's connection + protocol state (poller-private)."""

    def __init__(self, address: str) -> None:
        self.address = address
        self.kind, self.target = _parse_address(address)
        self.resolve_error = ""
        if self.kind == "tcp":
            # resolve ONCE, at construction, BEFORE the event loop
            # exists: connect_ex on a hostname does a synchronous
            # getaddrinfo inside the loop, which would stall every
            # host's sweep for the resolver timeout — the exact
            # blocking pathology the poller exists to remove.  A host
            # whose name does not resolve renders DOWN with the
            # resolver's error (fix DNS and restart the fleet view);
            # numeric addresses resolve locally and never fail here.
            host, port = self.target
            try:
                info = socket.getaddrinfo(host, port, socket.AF_INET,
                                          socket.SOCK_STREAM)
                self.target = info[0][4]
            except OSError as e:
                self.resolve_error = f"resolve {host}: {e}"
        self.sock: Optional[socket.socket] = None
        self.state = _DOWN
        self.interest = 0    # current selector registration (0 = none)
        self.inbuf = bytearray()
        self.outbuf = bytearray()
        # protocol
        self.awaiting: Optional[str] = None  # hello|probe|frame|json
        self.decoder: Optional[SweepFrameDecoder] = None
        self.negotiated = False      # per connection
        self.json_pinned = False     # per HOST, forever (like AgentBackend)
        self.hello: Optional[Dict[str, Any]] = None   # cached per connection
        self.chip_count = 0
        self.requests: List[Tuple[int, Sequence[int]]] = []
        self.req_bytes = b""         # cached binary request
        self.req_event_seq = -1      # events_since the cache was built with
        self.event_seq = 0           # cumulative event cursor per host
        # failure handling
        self.backoff_s = 0.0
        self.backoff_until = 0.0
        self.ever_failed = False
        self.last_error = ""
        # transition logging state: log once per up->down and
        # down->up edge, never per backoff attempt — a host flapping
        # at 1 Hz must cost two log lines per flap, not one per tick
        self.logged_down = False
        self.down_since = 0.0
        self.down_ticks = 0
        self.was_up = False
        # per-tick
        self.done = True
        self.sample: Optional[HostSample] = None
        #: bytes this host moved (both directions) during the current
        #: tick (a sibling shard's death must not change a healthy
        #: shard's steady bytes/tick)
        self.tick_bytes = 0
        #: did this tick's sweep change anything since the previous
        #: tick?  False exactly when the index-only shortcut fired
        #: (decoder.last_changes == 0, no events) — the signal the
        #: hierarchical shard feed uses to touch only moved rows
        self.tick_changed = True
        self.deadline = 0.0
        self.reused_conn = False
        self.retried = False
        self.last_per_chip: Optional[Dict[int, Dict[int, FieldValue]]] = None
        # steady-state cache: an index-only delta frame proves the
        # mirror (and so the snapshot and its aggregate) is identical
        # to last tick's — reuse both instead of re-materializing and
        # re-aggregating N chips x M fields per host per tick
        self.steady_per_chip: Optional[
            Dict[int, Dict[int, FieldValue]]] = None
        self.steady_sample: Optional[HostSample] = None


class FleetPoller:
    """Single-threaded multiplexer sweeping ``targets`` once per
    :meth:`poll` call.  Not thread-safe — one owner drives it, which is
    the point."""

    def __init__(self, targets: Sequence[str],
                 field_ids: Sequence[int],
                 timeout_s: float = 3.0,
                 backoff_base_s: float = 0.5,
                 backoff_max_s: float = 30.0,
                 reconnect_budget: int = 32,
                 client_name: str = "tpumon-fleet",
                 backoff_jitter: Optional[Callable[[], float]] = None,
                 blackbox_dir: Optional[str] = None,
                 blackbox_max_bytes: Optional[int] = None,
                 stream_hub: Optional[Any] = None,
                 rules: Optional[Any] = None) -> None:
        """``backoff_jitter``: multiplier source for reconnect backoff
        delays, defaulting to ``uniform(0.5, 1.0)`` — a fleet-wide
        agent restart fails every host at the same instant, and
        un-jittered exponential backoff would re-dial them all in
        synchronized storms forever after (tests inject a
        deterministic source).

        ``blackbox_dir``: tee every host's decoded sweeps into
        per-host flight-recorder segment directories
        (``<dir>/<sanitized-address>/``), budgeted per HOST by
        ``blackbox_max_bytes`` — the fleet-side durable history the
        exporter's ``--blackbox-dir`` records host-side.

        ``stream_hub``: a :class:`tpumon_torch.frameserver.StreamHub` — each
        host's decoded sweeps are re-published as one live stream per
        host (stream name == target address), so N dashboards follow a
        host through the fleet poller instead of N scrape/poll loops.
        Publishers are registered here, at construction, so a
        subscriber attaching before the first tick sees the stream
        exists (it resyncs with a keyframe at that first tick).

        ``rules``: a :class:`tpumon_torch.anomaly.Rules` rule set — one
        streaming :class:`~tpumon_torch.anomaly.AnomalyEngine` per host
        scores each decoded sweep (changed values only; an index-only
        steady tick scores zero series).  Findings are recorded as
        0xB3 records beside that host's frames (with ``blackbox_dir``),
        pushed to the host's live stream (with ``stream_hub``), and
        drained by :meth:`take_findings`.  When the targets are fleet
        shards, the "chips" the engine sees are the synthetic host
        rows (``SF_*`` fields) — rules address them by name the same
        way."""

        self._fields = [int(f) for f in field_ids]
        self._timeout_s = float(timeout_s)
        self._backoff_base_s = float(backoff_base_s)
        self._backoff_max_s = float(backoff_max_s)
        self._reconnect_budget = int(reconnect_budget)
        self._client_name = client_name
        self._backoff_jitter = backoff_jitter or (
            lambda: random.uniform(0.5, 1.0))
        self._blackbox_dir = blackbox_dir
        self._blackbox_max_bytes = blackbox_max_bytes
        self._recorders: Dict[str, Any] = {}  # address -> BlackBoxWriter
        #: address -> StreamPublisher (eagerly registered: the target
        #: set is fixed for the poller's lifetime)
        self._stream_pubs: Dict[str, Any] = {}
        if stream_hub is not None:
            for t in targets:
                self._stream_pubs[t] = stream_hub.publisher(t)
        #: anomaly detection plane: one engine per host, created
        #: lazily like the recorders (address -> AnomalyEngine)
        self._rules = rules
        self._engines: Dict[str, Any] = {}
        #: findings accumulated since the last take_findings() drain,
        #: as (address, AnomalyRecord) in firing order
        self._findings: List[Tuple[str, Any]] = []
        #: the seven aggregate field ids the native mirror aggregate
        #: needs, in aggregate_host_sample's lookup order
        self._agg_fids = (int(F.POWER_USAGE), int(F.CORE_TEMP),
                          int(F.TENSORCORE_UTIL), int(F.HBM_BW_UTIL),
                          int(F.HBM_USED), int(F.HBM_TOTAL),
                          int(F.ICI_LINKS_UP))
        self._hosts = [_HostState(t) for t in targets]
        self._pending = 0    # hosts not yet finished this tick
        #: no tee wants decoded snapshots: the binary path can skip
        #: materialize entirely (native mirror aggregate; snapshots
        #: rebuilt on demand by raw_snapshots()).  The anomaly engine
        #: is a snapshot consumer like the tees.
        self._lazy_per_chip = (blackbox_dir is None
                               and stream_hub is None and rules is None)
        #: wire accounting (bytes on the wire, both directions)
        self.tick_bytes_sent = 0
        self.tick_bytes_recv = 0
        self.total_bytes = 0
        self.hello_rpcs_total = 0
        self.ticks_total = 0
        # the selector is the one OS resource this constructor owns —
        # acquired LAST, so a raise anywhere above leaks nothing (the
        # half-built poller is never returned, so nothing could close
        # it)
        self._sel = selectors.DefaultSelector()

    # -- public API -----------------------------------------------------------

    def poll(self) -> List[HostSample]:
        """One fleet tick: sweep every target, return one sample per
        target in input order.  Wall time is bounded by ``timeout_s``
        (plus scheduling noise), however many hosts are down."""

        now = time.monotonic()
        self.tick_bytes_sent = 0
        self.tick_bytes_recv = 0
        self.ticks_total += 1
        budget = self._reconnect_budget
        deadline = now + self._timeout_s
        self._pending = len(self._hosts)
        for h in self._hosts:
            h.done = False
            h.sample = None
            h.retried = False
            h.last_per_chip = None
            h.tick_bytes = 0
            h.deadline = deadline
            if h.state == _CONNECTED:
                h.reused_conn = True
                if h.inbuf:
                    # stray bytes arrived between ticks: the stream is
                    # desynchronized — reconnect rather than misread
                    self._teardown(h)
                    self._begin_connect(h, now)
                else:
                    self._send_sweep(h)
                continue
            h.reused_conn = False
            if h.ever_failed and now < h.backoff_until:
                wait = h.backoff_until - now
                # a DOWN tick is always a change: a host whose kept
                # connection died between ticks (EOF reaped by
                # _drain_idle) can land here with tick_changed still
                # False from its last steady sweep, and a consumer of
                # last_changed_flags() would keep serving the stale
                # UP row
                h.tick_changed = True
                self._finish(h, HostSample(
                    address=h.address, up=False,
                    error=f"backoff {wait:.1f}s after: {h.last_error}"))
            elif h.ever_failed and budget <= 0:
                # budget exhausted: stay DOWN this tick WITHOUT bumping
                # the backoff (the host was never actually tried)
                h.tick_changed = True
                self._finish(h, HostSample(
                    address=h.address, up=False,
                    error=f"reconnect budget exhausted this tick "
                          f"(after: {h.last_error})"))
            else:
                if h.ever_failed:
                    budget -= 1
                self._begin_connect(h, now)

        # the event loop: every host shares the tick's single
        # monotonic deadline, so the selector sleeps straight to it —
        # no per-host timer bookkeeping, no per-call settimeout
        while self._pending:
            now = time.monotonic()
            wait = deadline - now
            if wait <= 0:
                break
            for key, mask in self._sel.select(wait):
                h = key.data
                if h.done:
                    # a host whose tick already finished: the event
                    # MUST still be consumed — skipping a readable
                    # level-triggered socket would make select() spin
                    # at 100% CPU until the deadline
                    self._drain_idle(h)
                    continue
                if mask & selectors.EVENT_WRITE:
                    self._on_writable(h)
                if mask & selectors.EVENT_READ and not h.done:
                    self._on_readable(h)
        if self._pending:
            now = time.monotonic()
            for h in self._hosts:
                if not h.done:
                    self._teardown(h)
                    self._mark_down(
                        h, f"deadline exceeded "
                           f"({self._timeout_s:.1f}s)", now)
        self.total_bytes += self.tick_bytes_sent + self.tick_bytes_recv
        return [h.sample for h in self._hosts
                if h.sample is not None]

    def raw_snapshots(self) -> Dict[str, Optional[
            Dict[int, Dict[int, FieldValue]]]]:
        """Last tick's decoded per-chip snapshots keyed by address
        (``None`` for hosts that were down) — the differential-test
        surface: these must be byte-identical in value AND type to what
        ``AgentBackend.read_fields_bulk`` decodes for the same
        schedule.  An unchanged host returns the SAME dict object as
        last tick (the index-only shortcut re-serves it): consumers key
        reconstruction caches on that identity
        (:class:`~tpumon_torch.fleetshard.ShardAggregateView`).

        On the native-aggregate fast path the per-tick materialize is
        skipped (no tee consumed it); the snapshot is rebuilt here from
        the live mirror — same contents, same types (the mirror always
        holds the last successfully applied frame: every failed apply
        tears the connection, and the decoder, down)."""

        out: Dict[str, Optional[Dict[int, Dict[int, FieldValue]]]] = {}
        for h in self._hosts:
            if h.last_per_chip is None and h.decoder is not None \
                    and h.negotiated:
                # cache the rebuilt snapshot as the steady object too,
                # so an unchanged host keeps returning the SAME dict
                # here, exactly like the eager path
                h.last_per_chip = h.steady_per_chip = \
                    h.decoder.materialize(h.requests)
            out[h.address] = h.last_per_chip
        return out

    def last_changed_flags(self) -> List[bool]:
        """Per-host "did last tick change anything" flags in target
        order — ``False`` exactly for hosts whose sweep hit the
        index-only steady shortcut (``SweepFrameDecoder.last_changes
        == 0``, no events), so the mirror, sample and aggregate are
        bit-identical to the previous tick's.  The hierarchical fleet
        shard (:mod:`tpumon_torch.fleetshard`) feeds its synthetic-row table
        from this: a steady upstream tick touches only changed hosts."""

        return [h.tick_changed for h in self._hosts]

    def per_host_tick_bytes(self) -> Dict[str, int]:
        """Bytes each host moved (both directions) during the LAST
        tick, keyed by address — the isolation gauge: a healthy
        shard's steady tick must cost the same few dozen
        bytes whether or not a sibling shard is dying next to it."""

        return {h.address: h.tick_bytes for h in self._hosts}

    def reset_backoff(self, address: str) -> None:
        """Forget a host's failure backoff so the next tick redials it
        immediately.  The supervisor calls this (via its tick thread)
        right after respawning a shard child: the replacement process
        is known-fresh, and waiting out the exponential backoff earned
        by its dead predecessor would only delay re-admission.  Must
        be called from the thread that drives :meth:`poll` — the
        poller is single-owner by design.

        Clearing ``ever_failed`` also waives the per-tick reconnect
        budget charge: a respawned shard must be re-dialed on the very
        next tick even when a flapping rack has the budget exhausted —
        the supervisor vouched for it, so it dials like a host that
        never failed instead of queueing behind strangers."""

        for h in self._hosts:
            if h.address == address:
                h.backoff_s = 0.0
                h.backoff_until = 0.0
                h.ever_failed = False

    def close(self) -> None:
        for h in self._hosts:
            self._teardown(h)
        for w in self._recorders.values():
            try:
                w.close()
            except Exception as e:
                # one recorder failing to close (dead filesystem) must
                # not leak the remaining recorders or the selector
                log.warn_every("fleetpoll.bbclose", 30.0,
                               "flight recorder close failed: %r", e)
        self._recorders.clear()
        self._sel.close()

    # -- live stream tee ------------------------------------------------------

    def _stream_sweep(self, h: "_HostState",
                      per_chip: Dict[int, Dict[int, FieldValue]],
                      events: Optional[List[Event]] = None,
                      unchanged: bool = False,
                      now: Optional[float] = None) -> None:
        """Tee one host's decoded sweep to its live stream.  Publisher
        trouble degrades streaming only — same contract as the flight
        recorder tee: the tick result is untouched."""

        pub = self._stream_pubs.get(h.address)
        if pub is None:
            return
        try:
            pub.publish(per_chip, events, now=now, unchanged=unchanged)
        except Exception as e:  # noqa: BLE001 — a broken stream
            # plane must never cost the fleet tick
            log.warn_every(f"fleetpoll.stream.{h.address}", 30.0,
                           "stream tee failed for %s: %r", h.address, e)

    # -- anomaly detection plane ----------------------------------------------

    def _observe(self, h: "_HostState",
                 per_chip: Dict[int, Dict[int, FieldValue]],
                 events: Optional[List[Event]], now: float,
                 unchanged: bool = False) -> None:
        """Score one host's sweep through its streaming engine and
        route the findings: the drain buffer (take_findings), that
        host's flight recorder (0xB3 records beside the frames the
        engine scored), and its live stream.  Engine trouble degrades
        detection only — the tick result is untouched."""

        if self._rules is None:
            return
        try:
            eng = self._engines.get(h.address)
            if eng is None:
                from .anomaly import AnomalyEngine
                eng = self._engines[h.address] = AnomalyEngine(
                    self._rules)
            findings = eng.observe(per_chip, now=now, events=events,
                                   unchanged=unchanged)
        except Exception as e:  # noqa: BLE001 — a broken detector
            # must never cost the fleet tick
            log.warn_every("fleetpoll.anomaly", 30.0,
                           "anomaly engine failed for %s: %r",
                           h.address, e)
            return
        if not findings:
            return
        for rec in findings:
            self._findings.append((h.address, rec))
        if len(self._findings) > 4096:
            # a caller that never drains must not grow the buffer
            # without bound; the recorder keeps the full history
            del self._findings[:-4096]
        w = self._recorders.get(h.address)
        pub = self._stream_pubs.get(h.address)
        try:
            from .blackbox import encode_finding
            for rec in findings:
                if w is not None:
                    w.record_finding(rec)
                if pub is not None:
                    pub.publish_record(encode_finding(rec))
        except Exception as e:  # noqa: BLE001 — same tee contract
            log.warn_every("fleetpoll.anomaly.tee", 30.0,
                           "finding tee failed for %s: %r",
                           h.address, e)

    def take_findings(self) -> List[Tuple[str, Any]]:
        """Drain the findings fired since the last call, as
        ``(address, AnomalyRecord)`` in firing order — the fleet CLI
        prints these per tick.  Caller thread, like poll()."""

        out, self._findings = self._findings, []
        return out

    def anomaly_stats(self) -> Optional[Dict[str, Any]]:
        """Aggregated engine counters across hosts (None when no
        rules are loaded)."""

        if self._rules is None:
            return None
        agg: Dict[str, Any] = {
            "hosts": len(self._engines), "findings_total": {},
            "incidents_total": {}, "active": {}, "scored_total": 0,
            "series_tracked": 0}
        for eng in self._engines.values():
            st = eng.stats()
            for key in ("findings_total", "incidents_total", "active"):
                for rule, n in st[key].items():
                    agg[key][rule] = agg[key].get(rule, 0) + n
            agg["scored_total"] += st["scored_total"]
            agg["series_tracked"] += st["series_tracked"]
        return agg

    # -- flight recorder tee --------------------------------------------------

    def _record_sweep(self, h: _HostState,
                      per_chip: Dict[int, Dict[int, FieldValue]],
                      events: Optional[List[Event]],
                      unchanged: bool = False,
                      now: Optional[float] = None) -> None:
        """Tee one host's decoded sweep (plus its piggybacked events)
        into that host's segment directory.  Recorder trouble (full
        disk) degrades recording only — the writer logs and drops its
        segment, the tick result is untouched."""

        try:
            w = self._recorders.get(h.address)
            if w is None:
                from .blackbox import DEFAULT_MAX_BYTES, BlackBoxWriter
                assert self._blackbox_dir is not None
                sub = re.sub(r"[^A-Za-z0-9._-]", "_", h.address)
                w = BlackBoxWriter(
                    os.path.join(self._blackbox_dir, sub),
                    host=h.address,
                    max_bytes=self._blackbox_max_bytes
                    or DEFAULT_MAX_BYTES)
                self._recorders[h.address] = w
            w.record_sweep(per_chip, events, now=now,
                           unchanged=unchanged)
        except Exception as e:
            # an uncreatable recorder directory (or any tee surprise)
            # must never cost the fleet tick — the writer's own write
            # failures already degrade internally, this guard covers
            # writer CREATION too.  Rate-limited: this can fire per
            # host per tick while the path stays broken.
            log.warn_every("fleetpoll.blackbox", 30.0,
                           "flight recorder tee for %s failed: %r",
                           h.address, e)

    # -- connection lifecycle -------------------------------------------------

    def _begin_connect(self, h: _HostState, now: float) -> None:
        if h.resolve_error:
            # name never resolved: fail without touching the resolver
            # from the event loop (getaddrinfo has no deadline)
            self._io_error(h, h.resolve_error, now)
            return
        s: Optional[socket.socket] = None
        try:
            if h.kind == "unix":
                s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            else:
                s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
                # 1 Hz small request/reply traffic is the textbook Nagle
                # victim: without this, every sub-MSS sweep request waits
                # on the previous tick's delayed ACK
                s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            s.setblocking(False)
            h.sock = s
            # connect_ex itself can RAISE (not return an errno) for
            # sockaddr conversion failures, e.g. an AF_UNIX path over
            # the kernel's 107-byte limit — same guard, same outcome
            rc = s.connect_ex(h.target)
        except OSError as e:
            # socket()/setsockopt/connect_ex can fail outright (fd
            # exhaustion, a proto the kernel refuses, an overlong unix
            # path): the host renders DOWN and the half-made socket is
            # closed — before this guard the error propagated out of
            # poll(), killing the WHOLE fleet tick and leaking the fd
            h.sock = None
            if s is not None:
                try:
                    s.close()
                except OSError:
                    pass
            self._io_error(h, f"socket setup for {h.address}: {e}", now)
            return
        if rc == 0 or rc == errno.EISCONN:
            h.state = _CONNECTED
            self._on_connected(h)
        elif rc in _INPROGRESS:
            h.state = _CONNECTING
            self._set_interest(h, selectors.EVENT_WRITE)
        else:
            h.sock = None
            try:
                s.close()
            except OSError:
                pass
            self._io_error(h, f"connect to {h.address}: "
                              f"{errno.errorcode.get(rc, rc)}", now)

    def _on_connected(self, h: _HostState) -> None:
        # fresh connection -> fresh delta tables on BOTH sides (the
        # server's table is connection-scoped) and a fresh hello
        if h.decoder is not None:
            h.decoder.close()  # free the native mirror now, not at GC
        h.decoder = None
        h.negotiated = False
        h.hello = None
        h.inbuf.clear()
        h.outbuf.clear()
        h.awaiting = "hello"
        self.hello_rpcs_total += 1
        self._queue(h, json.dumps(  # tpumon-lint: disable=json-in-sweep-path
            {"op": "hello", "client": self._client_name,
             "version": "0.1.0"},
            separators=(",", ":")).encode() + b"\n")

    def _teardown(self, h: _HostState) -> None:
        if h.interest and h.sock is not None:
            try:
                self._sel.unregister(h.sock)
            except (KeyError, ValueError):
                pass
        h.interest = 0
        if h.sock is not None:
            try:
                h.sock.close()
            except OSError:
                pass
            h.sock = None
        h.state = _DOWN
        h.awaiting = None
        if h.decoder is not None:
            h.decoder.close()  # free the native mirror now, not at GC
        h.decoder = None
        h.negotiated = False
        h.hello = None
        h.steady_per_chip = None
        h.steady_sample = None
        h.inbuf.clear()
        h.outbuf.clear()

    def _set_interest(self, h: _HostState, events: int) -> None:
        """Selector registration with change tracking: a CONNECTED
        socket stays registered for READ for the connection's whole
        life (two epoll_ctl per host-TICK was a measurable slice of
        the 256-host tick), and WRITE interest appears only while a
        send is actually backed up."""

        if events == h.interest or h.sock is None:
            return
        if h.interest == 0:
            self._sel.register(h.sock, events, h)
        elif events == 0:
            try:
                self._sel.unregister(h.sock)
            except (KeyError, ValueError):
                pass
        else:
            self._sel.modify(h.sock, events, h)
        h.interest = events

    def _queue(self, h: _HostState, data: bytes) -> None:
        if h.sock is not None and not h.outbuf:
            # fast path (every steady tick's request send): write the
            # bytes straight to the socket — no bytearray splice, no
            # del — and fall back to the buffered path only for the
            # unsent remainder
            try:
                sent = h.sock.send(data)
            except (BlockingIOError, InterruptedError):
                sent = 0
            except OSError as e:
                self._io_error(h, f"send: {e}", time.monotonic())
                return
            self.tick_bytes_sent += sent
            h.tick_bytes += sent
            if sent == len(data):
                if h.interest != selectors.EVENT_READ \
                        and h.state == _CONNECTED:
                    self._set_interest(h, selectors.EVENT_READ)
                return
            h.outbuf += data[sent:] if sent else data
            want = selectors.EVENT_READ if h.state == _CONNECTED else 0
            self._set_interest(h, want | selectors.EVENT_WRITE)
            return
        h.outbuf += data
        self._flush(h)

    def _flush(self, h: _HostState) -> None:
        if h.sock is not None and h.outbuf:
            try:
                sent = h.sock.send(h.outbuf)
                self.tick_bytes_sent += sent
                h.tick_bytes += sent
                del h.outbuf[:sent]
            except (BlockingIOError, InterruptedError):
                pass
            except OSError as e:
                self._io_error(h, f"send: {e}", time.monotonic())
                return
        want = selectors.EVENT_READ if h.state == _CONNECTED else 0
        if h.state == _CONNECTING or h.outbuf:
            want |= selectors.EVENT_WRITE
        self._set_interest(h, want)

    # -- tick protocol --------------------------------------------------------

    def _send_sweep(self, h: _HostState) -> None:
        es = h.event_seq
        if h.json_pinned:
            # JSON oracle fallback for old agents: byte-for-byte the
            # pre-binary protocol, one line per tick
            h.awaiting = "json"
            self._queue(h, json.dumps(  # tpumon-lint: disable=json-in-sweep-path
                {"op": "read_fields_bulk",
                 "reqs": [{"index": c, "fields": self._fields}
                          for c in range(h.chip_count)],
                 "events_since": es},
                separators=(",", ":")).encode() + b"\n")
        elif h.negotiated:
            h.awaiting = "frame"
            if h.req_event_seq != es:
                h.req_bytes = encode_sweep_request(h.requests, None, es)
                h.req_event_seq = es
            self._queue(h, h.req_bytes)
        else:
            # first sweep of the connection: JSON probe, so an older
            # agent can answer a parseable "unknown op"
            h.awaiting = "probe"
            self._queue(h, json.dumps(  # tpumon-lint: disable=json-in-sweep-path
                {"op": "sweep_frame",
                 "reqs": [{"index": c, "fields": self._fields}
                          for c in range(h.chip_count)],
                 "events_since": es},
                separators=(",", ":")).encode() + b"\n")

    def _on_writable(self, h: _HostState) -> None:
        if h.state == _CONNECTING:
            assert h.sock is not None
            err = h.sock.getsockopt(socket.SOL_SOCKET, socket.SO_ERROR)
            if err:
                now = time.monotonic()
                self._teardown(h)
                self._io_error(h, f"connect to {h.address}: "
                                  f"{errno.errorcode.get(err, err)}", now)
                return
            h.state = _CONNECTED
            h.interest = selectors.EVENT_WRITE  # still registered
            self._on_connected(h)
            return
        self._flush(h)

    def _drain_idle(self, h: _HostState) -> None:
        """Socket activity on a host that already finished its tick:
        the agent closed (EOF — tear down now so the next tick starts
        with a clean reconnect instead of a doomed send) or pushed
        stray bytes (kept for the tick-start desync check).  Either
        way the event is consumed, never skipped."""

        if h.sock is None:
            return
        try:
            chunk = h.sock.recv(65536)
        except (BlockingIOError, InterruptedError):
            return
        except OSError:
            self._teardown(h)
            return
        if not chunk:
            self._teardown(h)
            return
        self.tick_bytes_recv += len(chunk)
        h.tick_bytes += len(chunk)
        h.inbuf += chunk

    def _on_readable(self, h: _HostState) -> None:
        assert h.sock is not None
        while True:
            try:
                chunk = h.sock.recv(65536)
            except (BlockingIOError, InterruptedError):
                break
            except OSError as e:
                self._io_error(h, f"recv: {e}", time.monotonic())
                return
            if not chunk:
                self._io_error(h, "connection closed by agent",
                               time.monotonic())
                return
            self.tick_bytes_recv += len(chunk)
            h.tick_bytes += len(chunk)
            h.inbuf += chunk
            if len(chunk) < 65536:
                break
        self._process_inbuf(h)

    def _process_inbuf(self, h: _HostState) -> None:
        while h.inbuf and not h.done and h.awaiting is not None:
            lead = h.inbuf[0]
            if lead == SWEEP_FRAME_MAGIC:
                if h.awaiting not in ("frame", "probe"):
                    self._io_error(h, "binary frame where a JSON reply "
                                      "was expected", time.monotonic())
                    return
                decoder = h.decoder
                if decoder is None:
                    decoder = h.decoder = SweepFrameDecoder()
                try:
                    # fused split + decode: one codec call per frame,
                    # parsing the receive buffer in place (no payload
                    # slice copy on the 1 Hz hot path)
                    parsed = decoder.try_apply(h.inbuf)
                    if parsed is None:
                        # mid-frame: wait for more bytes (or deadline)
                        return
                    used, events = parsed
                    del h.inbuf[:used]
                    h.negotiated = True
                    if (decoder.last_changes == 0 and not events
                            and h.steady_sample is not None):
                        # index-only frame: nothing moved since last
                        # tick, so last tick's snapshot and aggregate
                        # are still exact — the whole materialize +
                        # aggregate pass is skipped.  The returned
                        # HostSample may be the SAME object as the
                        # previous tick's (read-only contract).
                        h.awaiting = None
                        h.backoff_s = 0.0
                        h.tick_changed = False
                        h.last_per_chip = h.steady_per_chip
                        # one wall stamp shared by recorder, stream
                        # and detector: replayed timestamps must be
                        # the exact stamps the live engine scored at
                        now_w: Optional[float] = None
                        if (self._blackbox_dir is not None
                                or self._rules is not None):
                            # wall clock on purpose: the recorded/
                            # scored timestamp is the replay
                            # correlation key, not an interval source
                            now_w = time.time()  # tpumon-lint: disable=wallclock-in-sampling
                        if self._blackbox_dir is not None:
                            # index-only tee: the recorder skips its own
                            # delta compare too (a few µs, not a full
                            # table pass per steady host per tick)
                            self._record_sweep(h, h.steady_per_chip or {},
                                               None, unchanged=True,
                                               now=now_w)
                        # same index-only shortcut for the live
                        # stream: subscribers get a ~17 B tick
                        self._stream_sweep(h, h.steady_per_chip or {},
                                           unchanged=True, now=now_w)
                        if now_w is not None:
                            # index-only scoring: ZERO series re-score;
                            # only due flatline
                            # deadlines can fire
                            self._observe(h, h.steady_per_chip or {},
                                          None, now_w, unchanged=True)
                        self._finish(h, h.steady_sample)
                        continue
                except ValueError as e:
                    # frame-index discontinuity / malformed frame: the
                    # delta stream is unusable — reconnect resets both
                    # tables
                    self._io_error(h, f"sweep frame decode failed: {e}",
                                   time.monotonic())
                    return
                if self._lazy_per_chip:
                    # native fleet fast path: the per-host aggregate is
                    # computed directly off the native mirror — no
                    # snapshot dicts are built at all on the 1 Hz path
                    # (None on the pure-Python backend; OverflowError
                    # when a value needs exact Python arithmetic)
                    try:
                        agg = decoder.host_aggregate(
                            h.requests, h.chip_count, self._agg_fids)
                    except OverflowError:
                        agg = None
                    if agg is not None:
                        self._sweep_done_native(h, agg, events)
                        continue
                per_chip = decoder.materialize(h.requests)
                self._sweep_done(h, per_chip, events)
            elif lead == ord("{"):
                nl = h.inbuf.find(b"\n")
                if nl < 0:
                    return  # mid-line: wait for more bytes (or deadline)
                line = bytes(h.inbuf[:nl + 1])
                del h.inbuf[:nl + 1]
                try:
                    resp = json.loads(  # tpumon-lint: disable=json-in-sweep-path
                        line)
                except ValueError as e:
                    self._io_error(h, f"malformed JSON from agent: {e}",
                                   time.monotonic())
                    return
                if not isinstance(resp, dict):
                    self._io_error(h, "non-object JSON from agent",
                                   time.monotonic())
                    return
                self._dispatch_json(h, resp)
            else:
                self._io_error(h, f"desynchronized agent stream "
                                  f"(unexpected lead byte {lead!r})",
                               time.monotonic())
                return

    def _dispatch_json(self, h: _HostState, resp: Dict[str, Any]) -> None:
        err = str(resp.get("error", ""))
        if h.awaiting == "hello":
            if not resp.get("ok"):
                self._app_error(h, f"hello: {err or 'agent error'}")
                return
            h.hello = resp
            try:
                h.chip_count = int(resp["chip_count"])
            except (KeyError, TypeError, ValueError):
                self._app_error(h, "hello reply missing chip_count")
                return
            h.requests = [(c, self._fields) for c in range(h.chip_count)]
            h.req_event_seq = -1
            self._send_sweep(h)
            return
        if h.awaiting == "probe":
            if not resp.get("ok") and "unknown op" in err:
                # an old JSON-only agent: pin the oracle path for this
                # HOST forever (reconnects must not re-pay the probe)
                h.json_pinned = True
                self._send_sweep(h)
                return
            self._app_error(
                h, f"sweep_frame: {err or 'unexpected JSON reply'}")
            return
        if h.awaiting == "json":
            if not resp.get("ok"):
                self._app_error(h, f"read_fields_bulk: "
                                   f"{err or 'agent error'}")
                return
            per_chip = {int(idx): {int(k): v for k, v in vals.items()}
                        for idx, vals in resp.get("chips", {}).items()}
            events: Optional[List[Event]] = None
            if "events" in resp:
                events = AgentBackend._decode_events(resp["events"])
            self._sweep_done(h, per_chip, events)
            return
        self._io_error(h, "JSON reply while idle", time.monotonic())

    def _sweep_done(self, h: _HostState,
                    per_chip: Dict[int, Dict[int, FieldValue]],
                    events: Optional[List[Event]]) -> None:
        h.awaiting = None
        h.backoff_s = 0.0
        h.tick_changed = True
        h.last_error = ""
        self._log_transition(h, up=True)
        if events:
            h.event_seq = max(h.event_seq,
                              max(e.seq for e in events))
        h.last_per_chip = per_chip
        # one wall stamp shared by recorder, stream and detector so
        # backtest re-derives the live verdicts exactly
        now_w: Optional[float] = None
        if self._blackbox_dir is not None or self._rules is not None:
            # wall clock on purpose: replay-correlation key
            now_w = time.time()  # tpumon-lint: disable=wallclock-in-sampling
        if self._blackbox_dir is not None:
            self._record_sweep(h, per_chip, events, now=now_w)
        # live-stream tee: ONE delta encode against the stream's
        # table, fanned out as bytes by the frameserver loop — a
        # slow subscriber can never stall this tick (bounded
        # buffers, drop-to-keyframe)
        self._stream_sweep(h, per_chip, events, now=now_w)
        if now_w is not None:
            # detection plane: changed values only (the engine keeps
            # its own identity table over the ruled fields)
            self._observe(h, per_chip, events, now_w)
        hello = h.hello or {}
        sample = aggregate_host_sample(
            h.address, h.chip_count, str(hello.get("driver", "")),
            per_chip, h.event_seq)
        h.steady_per_chip = per_chip
        h.steady_sample = sample
        self._finish(h, sample)
        # the socket stays registered for READ across ticks: an agent
        # closing between ticks is discovered at the next poll

    def _sweep_done_native(self, h: _HostState,
                           agg: Tuple[int, int, float, Optional[int],
                                      Optional[float], Optional[float],
                                      int, int, int],
                           events: Optional[List[Event]]) -> None:
        """The native-aggregate twin of :meth:`_sweep_done`: same row,
        built from the mirror aggregate tuple instead of a materialized
        snapshot (which is never built — ``raw_snapshots()`` rebuilds
        one on demand from the live mirror)."""

        h.awaiting = None
        h.backoff_s = 0.0
        h.tick_changed = True
        h.last_error = ""
        self._log_transition(h, up=True)
        if events:
            h.event_seq = max(h.event_seq,
                              max(e.seq for e in events))
        (live, dead, power_w, max_temp, mean_tc, mean_hbm,
         hbm_used, hbm_total, links_up) = agg
        hello = h.hello or {}
        sample = HostSample(
            address=h.address, up=True, chips=h.chip_count,
            driver=str(hello.get("driver", "")), power_w=power_w,
            max_temp_c=max_temp, mean_tc_util=mean_tc,
            mean_hbm_util=mean_hbm, hbm_used_mib=hbm_used,
            hbm_total_mib=hbm_total, links_up=links_up,
            events=h.event_seq, live_fields=live, dead_chips=dead)
        h.last_per_chip = None   # lazy: rebuilt by raw_snapshots()
        h.steady_per_chip = None
        h.steady_sample = sample
        self._finish(h, sample)

    # -- failure handling -----------------------------------------------------

    # -- failure handling -----------------------------------------------------

    def _finish(self, h: _HostState, sample: HostSample) -> None:
        h.sample = sample
        if not h.done:
            h.done = True
            self._pending -= 1

    def _io_error(self, h: _HostState, msg: str, now: float) -> None:
        self._teardown(h)
        if h.done:
            return
        if (h.reused_conn and not h.retried
                and now + 0.01 < h.deadline):
            # the kept socket died between ticks (agent restart, idle
            # reap): one fresh-connection retry within the tick,
            # charged against the SAME deadline
            h.retried = True
            h.reused_conn = False
            self._begin_connect(h, now)
            return
        self._mark_down(h, msg, now)

    def _app_error(self, h: _HostState, msg: str) -> None:
        """The agent answered, but with an application error (bad
        hello, unexpected probe reply, a sweep op it does not know):
        report the host DOWN with the agent's words and drop the
        connection — its protocol state is not one the tick machine
        can resume from."""

        self._teardown(h)
        self._mark_down(h, msg, time.monotonic())

    def _mark_down(self, h: _HostState, msg: str, now: float) -> None:
        h.ever_failed = True
        h.tick_changed = True
        h.last_error = msg
        self._log_transition(h, up=False, now=now)
        self._bump_backoff(h, now)
        self._finish(h, HostSample(address=h.address, up=False,
                                   error=msg))

    def _log_transition(self, h: _HostState, up: bool,
                        now: float = 0.0) -> None:
        """Edge-triggered host state logging: exactly one line per
        up->down edge (with the first failure's reason) and one per
        down->up edge (with the outage duration) — never a line per
        backoff attempt or per DOWN tick, so a flapping rack costs two
        log lines per flap however long the flap lasts.  The index-only
        steady shortcut bypasses :meth:`_sweep_done`, so a steady host
        never reaches here at all."""

        if up:
            if h.logged_down:
                h.logged_down = False
                log.info("fleet host %s back up after %.1fs (%d failed "
                         "attempts)", h.address,
                         time.monotonic() - h.down_since, h.down_ticks)
            h.was_up = True
        else:
            h.down_ticks += 1
            if not h.logged_down:
                h.logged_down = True
                h.down_ticks = 1
                h.down_since = now or time.monotonic()
                log.warning("fleet host %s down%s: %s", h.address,
                            "" if h.was_up else " (never seen up)",
                            h.last_error)

    def _bump_backoff(self, h: _HostState, now: float) -> None:
        h.backoff_s = min(max(self._backoff_base_s, h.backoff_s * 2.0),
                          self._backoff_max_s)
        # jittered wait: a fleet-wide agent restart fails every host in
        # the same tick, and identical exponential delays would re-dial
        # them all at the same instant every round after (synchronized
        # reconnect storms, budget-capped into starvation).  The factor
        # never exceeds 1.0, so backoff_s stays the documented ceiling.
        h.backoff_until = now + h.backoff_s * self._backoff_jitter()


# ---------------------------------------------------------------------------
# Native poll plane: the epoll engine behind the same policy
# ---------------------------------------------------------------------------

def poll_native_available() -> bool:
    """True when the native poll engine can back the fleet poller (the
    ``_tpumon_torch_poll`` extension is loaded AND exports the engine —
    Linux only: the engine is epoll-based, and the extension builds
    elsewhere as a stub without ``PollEngine``)."""

    return _poll.lib is not None and hasattr(_poll.lib, "PollEngine")


class NativeFleetPoller(FleetPoller):
    """:class:`FleetPoller` with the per-host connection machinery —
    sockets, non-blocking connect, hello/probe negotiation, frame
    reassembly, delta tables — moved into the native epoll engine
    (``native/poll/``, extension ``_tpumon_torch_poll``, built next to
    the codec extension by :mod:`tpumon_torch._build`).

    Division of labour per tick:

    * **Python (policy)** decides which hosts may dial (backoff
      schedule, per-tick reconnect budget, resolver failures), pushes
      the per-host ``events_since`` cursor and the cached binary
      request bytes, then makes ONE ``tick()`` call.
    * **Engine (mechanism)** runs the whole event loop with the GIL
      released and returns only activity records: a host with no
      record had an index-only steady frame (nothing moved).
    * **Python (policy)** replays the records through the SAME
      ``_sweep_done`` / ``_mark_down`` / tee methods the pure poller
      uses, so samples, error strings, backoff state, blackbox/stream/
      anomaly tees and counters stay byte-identical with the spec.

    The pure-Python :class:`FleetPoller` remains the executable spec;
    this class must never change observable behaviour, only cost.
    """

    def __init__(self, targets: Sequence[str],
                 field_ids: Sequence[int], **kwargs: Any) -> None:
        super().__init__(targets, field_ids, **kwargs)
        if not poll_native_available():
            raise ImportError(
                "native poll engine unavailable: "
                + (_poll.error or "extension lacks PollEngine "
                   "(rebuild: python -m tpumon_torch._build --native)"))
        lib = _poll.lib
        # pre-dumped wire fragments: the engine must emit exactly the
        # bytes json.dumps would, so Python dumps them once here
        hello = json.dumps(  # tpumon-lint: disable=json-in-sweep-path
            {"op": "hello", "client": self._client_name,
             "version": "0.1.0"},
            separators=(",", ":")).encode("utf-8") + b"\n"
        fields_frag = '"fields":' + json.dumps(  # tpumon-lint: disable=json-in-sweep-path
            self._fields, separators=(",", ":"))
        eng = lib.PollEngine(hello, fields_frag, tuple(self._fields),
                             self._agg_fids, bool(self._lazy_per_chip))
        # slots whose address can never convert to a sockaddr render
        # the spec's "socket setup" failure from Python every dial
        # (index -> the message str(OSError) carries)
        self._setup_errors: Dict[int, str] = {}
        for i, h in enumerate(self._hosts):
            if h.kind == "unix":
                if len(os.fsencode(h.target)) > 108:
                    # CPython getsockaddrarg's sizeof(sun_path) bound:
                    # connect_ex raises before any syscall, so the
                    # engine (whose add_unix mirrors the same limit)
                    # must never dial this slot
                    self._setup_errors[i] = "AF_UNIX path too long"
                eng.add_unix(h.target)
            elif h.resolve_error:
                # placeholder slot: the host renders DOWN from Python
                # with the resolver's error and is always skipped
                eng.add_tcp("", 0)
            else:
                ip, port = h.target
                eng.add_tcp(str(ip), int(port))
        self._eng: Optional[Any] = eng
        self._S_OK_FRAME = lib.POLL_OK_FRAME
        self._S_OK_JSON = lib.POLL_OK_JSON
        self._S_IDLE_EOF = lib.POLL_IDLE_EOF
        self._S_ERR_CONNECT = lib.POLL_ERR_CONNECT
        self._S_ERR_SETUP = lib.POLL_ERR_SETUP
        self._S_ERR_SEND = lib.POLL_ERR_SEND
        self._S_ERR_RECV = lib.POLL_ERR_RECV
        self._S_ERR_EOF = lib.POLL_ERR_EOF
        self._S_ERR_FRAME_DECODE = lib.POLL_ERR_FRAME_DECODE
        self._S_ERR_BAD_JSON = lib.POLL_ERR_BAD_JSON
        self._S_ERR_NON_OBJECT = lib.POLL_ERR_NON_OBJECT
        self._S_ERR_DESYNC = lib.POLL_ERR_DESYNC
        self._S_ERR_HELLO = lib.POLL_ERR_HELLO
        self._S_ERR_HELLO_CHIPS = lib.POLL_ERR_HELLO_CHIPS
        self._S_ERR_PROBE = lib.POLL_ERR_PROBE
        self._S_ERR_JSON_APP = lib.POLL_ERR_JSON_APP
        self._S_ERR_BINARY = lib.POLL_ERR_BINARY_WHERE_JSON
        self._S_ERR_IDLE_JSON = lib.POLL_ERR_IDLE_JSON
        self._S_ERR_DEADLINE = lib.POLL_ERR_DEADLINE

    # -- tick -----------------------------------------------------------------

    def poll(self) -> List[HostSample]:
        eng = self._eng
        if eng is None:                      # closed: spec behaviour is
            return super().poll()            # a pure-Python dead tick
        now = time.monotonic()
        self.tick_bytes_sent = 0
        self.tick_bytes_recv = 0
        self.ticks_total += 1
        budget = self._reconnect_budget
        deadline = now + self._timeout_s
        hosts = self._hosts
        self._pending = len(hosts)
        skip = bytearray(len(hosts))
        for i, h in enumerate(hosts):
            h.done = False
            h.sample = None
            h.retried = False
            h.last_per_chip = None
            h.tick_bytes = 0
            h.deadline = deadline
            if h.state == _CONNECTED:
                # the engine holds the live socket; Python only pushes
                # the request bytes / events cursor the spec would
                # send.  The cursor is pushed even on the binary path:
                # the engine's in-tick retry (agent restarted between
                # ticks) re-probes on a fresh connection, and that
                # probe must carry the CURRENT cursor, not the one from
                # the last disconnected dial
                h.reused_conn = True
                es = h.event_seq
                eng.set_events_since(i, es)
                if h.negotiated and not h.json_pinned:
                    if h.req_event_seq != es:
                        h.req_bytes = encode_sweep_request(
                            h.requests, None, es)
                        h.req_event_seq = es
                    eng.set_request(i, h.req_bytes)
                continue
            h.reused_conn = False
            if h.ever_failed and now < h.backoff_until:
                wait = h.backoff_until - now
                h.tick_changed = True
                skip[i] = 1
                self._finish(h, HostSample(
                    address=h.address, up=False,
                    error=f"backoff {wait:.1f}s after: {h.last_error}"))
            elif h.ever_failed and budget <= 0:
                h.tick_changed = True
                skip[i] = 1
                self._finish(h, HostSample(
                    address=h.address, up=False,
                    error=("reconnect budget exhausted this tick "
                           f"(after: {h.last_error})")))
            else:
                if h.ever_failed:
                    budget -= 1
                if h.resolve_error:
                    skip[i] = 1
                    self._mark_down(h, h.resolve_error, now)
                elif i in self._setup_errors:
                    # the address can never become a sockaddr (e.g.
                    # AF_UNIX path over the kernel limit): replay the
                    # spec's per-dial setup failure without handing
                    # the slot to the engine
                    skip[i] = 1
                    self._mark_down(h, f"socket setup for {h.address}: "
                                    f"{self._setup_errors[i]}", now)
                else:
                    # fresh dial: the engine connects + hellos; the
                    # first sweep is always the JSON probe (or the
                    # pinned oracle), both built off this cursor
                    eng.set_events_since(i, h.event_seq)
        sent, recvd, hellos, records = eng.tick(self._timeout_s,
                                                bytes(skip))
        self.tick_bytes_sent += sent
        self.tick_bytes_recv += recvd
        self.hello_rpcs_total += hellos
        now = time.monotonic()
        # records arrive in engine-completion order; replaying them in
        # that order keeps the Python connection mirror exact (a host's
        # LAST record decides its end-of-tick up/down state)
        for (i, stage, err, changes, agg, detail, hello_b,
             events_b, chip_count) in records:
            h = hosts[i]
            if hello_b is not None:
                # fresh hello on this connection: cache it exactly like
                # _dispatch_json does (chip_count already validated and
                # int()-converted by the engine)
                h.hello = json.loads(  # tpumon-lint: disable=json-in-sweep-path
                    hello_b)
                h.chip_count = int(chip_count)
                h.requests = [(c, self._fields)
                              for c in range(h.chip_count)]
                h.req_event_seq = -1
            if stage == self._S_OK_FRAME:
                h.state = _CONNECTED
                h.negotiated = True
                events: Optional[List[Event]] = None
                if events_b:
                    events = [_decode_event(b) for b in events_b]
                if agg is not None:
                    self._sweep_done_native(h, agg, events)
                else:
                    # non-lazy mode (tees need the snapshot), or the
                    # aggregate hit overflow/NaN/Inf: materialize off
                    # the engine-owned mirror and take the spec path
                    self._sweep_done(h, eng.materialize(i) or {},
                                     events)
            elif stage == self._S_OK_JSON:
                h.state = _CONNECTED
                h.json_pinned = True
                resp = json.loads(  # tpumon-lint: disable=json-in-sweep-path
                    detail)
                per_chip = {int(idx): {int(k): v
                                       for k, v in vals.items()}
                            for idx, vals in
                            resp.get("chips", {}).items()}
                events = None
                if "events" in resp:
                    events = AgentBackend._decode_events(resp["events"])
                self._sweep_done(h, per_chip, events)
            elif stage == self._S_IDLE_EOF:
                # agent closed (or idle-babbled) between ticks on an
                # already-finished host: connection dropped silently,
                # exactly like _drain_idle
                self._mirror_teardown(h)
            else:
                self._mirror_teardown(h)
                self._mark_down(h, self._format_error(h, stage, err,
                                                      detail), now)
        for h in hosts:
            if h.done:
                continue
            self._steady_finish(h)
        self.total_bytes += self.tick_bytes_sent + self.tick_bytes_recv
        return [h.sample for h in hosts if h.sample is not None]

    def _steady_finish(self, h: _HostState) -> None:
        """No record from the engine == index-only steady frame: replay
        the spec's steady shortcut (same tees, same reused sample)."""

        h.awaiting = None
        h.backoff_s = 0.0
        h.tick_changed = False
        h.last_per_chip = h.steady_per_chip
        if (self._blackbox_dir is None and self._rules is None
                and not self._stream_pubs):
            # bare poller (no recorder/rules/stream tees): the steady
            # replay is pure bookkeeping, and with 100k hosts ticking
            # steady this runs once per host per tick — keep it
            # call-free (this IS _finish(h, h.steady_sample))
            h.sample = h.steady_sample
            if not h.done:
                h.done = True
                self._pending -= 1
            return
        now_w: Optional[float] = None
        if self._blackbox_dir is not None or self._rules is not None:
            # wall clock on purpose: replay-correlation key
            now_w = time.time()  # tpumon-lint: disable=wallclock-in-sampling
        if self._blackbox_dir is not None:
            self._record_sweep(h, h.steady_per_chip or {}, None,
                               unchanged=True, now=now_w)
        self._stream_sweep(h, h.steady_per_chip or {}, unchanged=True,
                           now=now_w)
        if now_w is not None:
            self._observe(h, h.steady_per_chip or {}, None, now_w,
                          unchanged=True)
        self._finish(h, h.steady_sample)

    def _mirror_teardown(self, h: _HostState) -> None:
        """Mirror the engine's connection teardown into the Python
        bookkeeping :meth:`_teardown` would have cleared (there is no
        Python-side socket, selector key or decoder to close)."""

        h.state = _DOWN
        h.interest = 0
        h.awaiting = None
        h.negotiated = False
        h.hello = None
        h.steady_per_chip = None
        h.steady_sample = None

    def _format_error(self, h: _HostState, stage: int, err: int,
                      detail: Optional[bytes]) -> str:
        """Reconstruct the exact error string the spec poller builds at
        each failure site, from the engine's (stage, errno, raw-bytes)
        record."""

        if stage == self._S_ERR_CONNECT:
            return (f"connect to {h.address}: "
                    f"{errno.errorcode.get(err, err)}")
        if stage == self._S_ERR_SETUP:
            return (f"socket setup for {h.address}: "
                    f"{OSError(err, os.strerror(err))}")
        if stage == self._S_ERR_SEND:
            return f"send: {OSError(err, os.strerror(err))}"
        if stage == self._S_ERR_RECV:
            return f"recv: {OSError(err, os.strerror(err))}"
        if stage == self._S_ERR_EOF:
            return "connection closed by agent"
        if stage == self._S_ERR_FRAME_DECODE:
            return ("sweep frame decode failed: "
                    + bytes(detail or b"").decode("utf-8", "replace"))
        if stage == self._S_ERR_BAD_JSON:
            # re-parse the surfaced line so the message carries
            # json.loads's own words (position and all)
            try:
                json.loads(  # tpumon-lint: disable=json-in-sweep-path
                    bytes(detail or b""))
            except ValueError as e:
                return f"malformed JSON from agent: {e}"
            return "malformed JSON from agent: unparseable reply"
        if stage == self._S_ERR_NON_OBJECT:
            return "non-object JSON from agent"
        if stage == self._S_ERR_DESYNC:
            return (f"desynchronized agent stream "
                    f"(unexpected lead byte {err!r})")
        if stage in (self._S_ERR_HELLO, self._S_ERR_PROBE,
                     self._S_ERR_JSON_APP):
            err_s = ""
            try:
                resp = json.loads(  # tpumon-lint: disable=json-in-sweep-path
                    bytes(detail or b"{}"))
                if isinstance(resp, dict):
                    err_s = str(resp.get("error", ""))
            except ValueError:
                pass
            if stage == self._S_ERR_HELLO:
                return f"hello: {err_s or 'agent error'}"
            if stage == self._S_ERR_PROBE:
                return f"sweep_frame: {err_s or 'unexpected JSON reply'}"
            return f"read_fields_bulk: {err_s or 'agent error'}"
        if stage == self._S_ERR_HELLO_CHIPS:
            return "hello reply missing chip_count"
        if stage == self._S_ERR_BINARY:
            return "binary frame where a JSON reply was expected"
        if stage == self._S_ERR_IDLE_JSON:
            return "JSON reply while idle"
        if stage == self._S_ERR_DEADLINE:
            return f"deadline exceeded ({self._timeout_s:.1f}s)"
        return f"native engine failure (stage {stage}, errno {err})"

    # -- read-side contracts --------------------------------------------------

    def raw_snapshots(self) -> Dict[
            str, Optional[Dict[int, Dict[int, FieldValue]]]]:
        eng = self._eng
        out: Dict[str, Optional[Dict[int, Dict[int, FieldValue]]]] = {}
        for i, h in enumerate(self._hosts):
            if (h.last_per_chip is None and eng is not None
                    and h.state == _CONNECTED and h.negotiated):
                snap = eng.materialize(i)
                if snap is not None:
                    # identity contract: cache so an unchanged host
                    # returns the SAME dict next call
                    h.last_per_chip = h.steady_per_chip = snap
            out[h.address] = h.last_per_chip
        return out

    def per_host_tick_bytes(self) -> Dict[str, int]:
        eng = self._eng
        if eng is None:
            return super().per_host_tick_bytes()
        return {h.address: eng.tick_bytes(i)
                for i, h in enumerate(self._hosts)}

    def close(self) -> None:
        eng, self._eng = self._eng, None
        try:
            if eng is not None:
                eng.close()
        finally:
            # the spec teardown (selector, kept sockets, recorders,
            # stream servers) must run even if the engine close raises
            super().close()


def poll_native_selected() -> bool:
    """True when :func:`create_fleet_poller` (environment-driven)
    selects the native engine — the value the ``tpumon_poll_native``
    self-metric gauge reports."""

    if os.environ.get("TPUMON_NATIVE", "").strip() == "0":
        return False
    return poll_native_available()


def create_fleet_poller(targets: Sequence[str],
                        field_ids: Sequence[int],
                        native: Optional[bool] = None,
                        **kwargs: Any) -> FleetPoller:
    """Build the fleet poller, on the native engine when available.

    ``native=None`` honours ``TPUMON_NATIVE``: ``0`` never, unset/other
    auto, ``1`` strict — the ``_poll`` loader already raised at import
    when the extension is absent, and a loaded stub without the engine
    (non-Linux build: the engine is epoll-only) raises here.  A forced
    fleet must fail loudly, never silently poll at spec speed.
    Explicit ``native=True`` is strict the same way and
    ``native=False`` pins the spec poller — the differential harness
    and tests pin both planes this way.
    """

    if native is None:
        forced = os.environ.get("TPUMON_NATIVE", "").strip()
        if forced == "0":
            native = False
        elif forced == "1":
            if not poll_native_available():
                raise ImportError(
                    "TPUMON_NATIVE=1 but the native poll engine is "
                    "unavailable: "
                    + (_poll.error or "extension lacks PollEngine — rebuild: "
                       "python -m tpumon_torch._build --native"))
            native = True
        else:
            native = poll_native_available()
    if native:
        return NativeFleetPoller(targets, field_ids, **kwargs)
    return FleetPoller(targets, field_ids, **kwargs)
