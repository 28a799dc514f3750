"""Self-healing stream relay tree: fan-out that survives relay death,
partitions and attach storms.

The port's copy of ``tpumon/relay.py``, imports renamed.  A
:class:`StreamRelay` subscribes once to an upstream stream (the exporter
daemon's ``--stream-port``, or another relay: trees compose) and
re-serves it to N downstream subscribers on its own
:class:`~tpumon_torch.frameserver.FrameServer` /
:class:`~tpumon_torch.frameserver.StreamHub`.  A k-deep, f-wide relay
tree serves f^k subscribers with the origin paying for f sends.

**Zero re-encode, byte-identical leaves.**  The steady path forwards the
upstream tick+frame bytes verbatim
(:meth:`~tpumon_torch.frameserver.StreamPublisher.forward`): the relay's
cost per tick is one record parse plus one mirror apply, and a leaf
decodes exactly the bytes the origin encoded.

**Attach storms never touch the origin.**  The relay keeps its own
:class:`~tpumon_torch.sweepframe.SweepFrameDecoder` mirror; keyframes for
attaches and drop-to-keyframe resyncs are built locally at the upstream
frame index, so forwarded delta frames apply after a local keyframe
without a discontinuity.

**Backpressure stays per hop.**  A slow relay is a slow subscriber to its
parent: bounded buffer, drop-to-keyframe, nothing upstream notices.

**Upstream loss degrades, never stalls.**  EOF, a mid-frame tear, a
refused reconnect or a desynchronized stream put the relay in DEGRADED:
it keeps serving its last-known mirror (attaches still get keyframes),
shows the staleness downstream as frameless ``0xB1`` heartbeat ticks with
the STALE flag, and reconnects under jittered exponential backoff with a
circuit breaker: a flapping upstream parks the relay
(``tpumon_relay_parked 1``) until :meth:`StreamRelay.unpark`.  On
reconnect the upstream's attach keyframe is forwarded to every downstream
subscriber, so the whole subtree resyncs in one fan-out.

``python -m tpumon_torch.cli.relay`` is the deployable form;
:class:`RelayTree` builds k-deep, f-wide in-process trees for tests.
"""

from __future__ import annotations

import collections
import json
import os
import random
import socket
import threading
import time
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

from . import log
from .backends.base import FieldValue
from .blackbox import (ANOMALY_MAGIC, KMSG_MAGIC, SEG_HEADER_MAGIC,
                       TICK_MAGIC, _TICK_KEYFRAME, _TICK_STALE,
                       _decode_header, _decode_tick)
from .frameserver import DEFAULT_SUB_BUFFER, FrameServer, StreamHub
from .sweepframe import (SWEEP_FRAME_MAGIC, SweepFrameDecoder,
                         try_split_frame)

#: relay states (single-writer: the relay thread)
CONNECTING = "connecting"
LIVE = "live"
DEGRADED = "degraded"
PARKED = "parked"

#: self-metric families served by ``python -m tpumon_torch.cli.relay
#: --metrics-port`` — the single registration :func:`relay_metric_lines`
#: emits from (the ``tpumon_torch.anomaly.METRIC_FAMILIES`` idiom)
METRIC_FAMILIES: List[Tuple[str, str, str]] = [
    ("tpumon_relay_up", "gauge",
     "1 while the relay is attached to its upstream and forwarding."),
    ("tpumon_relay_stale_seconds", "gauge",
     "Seconds since the last upstream tick was forwarded (0 when "
     "live and fresh); grows while DEGRADED/PARKED."),
    ("tpumon_relay_parked", "gauge",
     "1 when the reconnect circuit breaker is open (flapping "
     "upstream); unpark() or a restart resets it."),
    ("tpumon_relay_reconnects_total", "counter",
     "Upstream re-attachments after a loss since start."),
    ("tpumon_relay_upstream_ticks_total", "counter",
     "Upstream tick+frame pairs forwarded since start."),
    ("tpumon_relay_upstream_bytes_total", "counter",
     "Bytes received from the upstream since start."),
    ("tpumon_relay_subtree_resyncs_total", "counter",
     "Upstream keyframes forwarded to the whole subtree (reconnect "
     "or parent-initiated resync) since start."),
    ("tpumon_relay_heartbeats_total", "counter",
     "Frameless stale heartbeat ticks emitted downstream since "
     "start."),
]


class StreamRelay:
    """One relay: subscribe upstream, re-serve downstream.

    The relay thread owns the upstream socket and the decoder mirror; the embedded
    :class:`~tpumon_torch.frameserver.FrameServer`'s loop thread owns every
    downstream subscriber.  All counters are single-writer (relay
    thread); :meth:`stats` takes a stale-but-consistent snapshot for
    the metrics scrape.
    """

    def __init__(self, upstream: str, stream: str = "", *,
                 serve_as: Optional[str] = None,
                 listen_unix: Optional[str] = None,
                 listen_host: str = "127.0.0.1",
                 listen_port: Optional[int] = None,
                 connect_timeout_s: float = 5.0,
                 backoff_base_s: float = 0.5,
                 backoff_max_s: float = 30.0,
                 reconnect_budget: int = 10,
                 budget_window_s: float = 60.0,
                 stale_tick_interval_s: float = 1.0,
                 stale_after_s: float = 2.0,
                 max_buffer_bytes: int = DEFAULT_SUB_BUFFER,
                 backoff_jitter: Optional[Callable[[], float]] = None,
                 ) -> None:
        """``listen_unix``/``listen_port`` pick the downstream serve
        surface (default: a temp unix socket).  A pre-existing socket
        FILE at ``listen_unix`` is unlinked first — a SIGKILLed
        predecessor leaves one behind, and rebinding the same path is
        the restart contract (children reconnect to the same address,
        exactly like supervised shards).  ``reconnect_budget``
        successful upstream attachments inside ``budget_window_s``
        open the circuit breaker (``<= 0`` disables it);
        ``backoff_jitter`` is the backoff multiplier source,
        defaulting to ``uniform(0.5, 1.0)`` like every other backoff
        in the repo."""

        self.upstream = upstream
        # fail fast on a malformed address: deferring this to the
        # relay thread's first dial would kill that thread with an
        # unhandled ValueError and leave a zombie relay that accepts
        # subscribers while looking merely "connecting"
        _parse_upstream(upstream)
        self.stream = stream
        self.connect_timeout_s = float(connect_timeout_s)
        self.backoff_base_s = float(backoff_base_s)
        self.backoff_max_s = float(backoff_max_s)
        self.reconnect_budget = int(reconnect_budget)
        self.budget_window_s = float(budget_window_s)
        self.stale_tick_interval_s = float(stale_tick_interval_s)
        self.stale_after_s = float(stale_after_s)
        self._jitter = backoff_jitter or (
            lambda: random.uniform(0.5, 1.0))
        # -- relay-thread state --
        self._dec: Optional[SweepFrameDecoder] = None
        self._buf = bytearray()
        self._pending: Optional[Tuple[float, int, bytes]] = None
        #: last mirror snapshot handed to the publisher — reused while
        #: frames apply zero changes, so a steady index-only tick
        #: costs no O(table) copy (the incremental-pipeline contract)
        self._snap: Optional[Dict[int, Dict[int, FieldValue]]] = None
        self._backoff_s = 0.0
        self._connects: Deque[float] = collections.deque()
        self._had_connection = False
        self._down_since_mono = 0.0
        self._last_data_mono = 0.0
        self._next_hb_mono = 0.0
        #: upstream segment header, as last received
        self.upstream_header: Optional[Tuple[int, float, str]] = None
        # -- observable state / counters (single-writer relay thread) --
        self.state = CONNECTING
        self.parked = False
        self.last_error = ""
        self.last_tick_ts = 0.0
        self.upstream_connects_total = 0
        self.reconnects_total = 0
        self.upstream_ticks_total = 0
        self.upstream_bytes_total = 0
        self.upstream_records_total = 0
        self.subtree_resyncs_total = 0
        self.heartbeats_total = 0
        self._stop_ev = threading.Event()
        self._wake_ev = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # OS resources LAST (partial-init discipline): the frame
        # server owns the selector/doorbell/listener fds
        self.server = FrameServer()
        try:
            self.hub = StreamHub(self.server)
            if listen_unix is not None:
                if os.path.exists(listen_unix):
                    # dead-predecessor rebind contract (see docstring)
                    os.unlink(listen_unix)
                self.address = self.server.add_unix_listener(
                    self.hub, listen_unix)
            else:
                self.address = self.server.add_tcp_listener(
                    self.hub, host=listen_host, port=listen_port or 0)
            self.publisher = self.hub.publisher(
                serve_as if serve_as is not None else stream,
                max_buffer_bytes=max_buffer_bytes)
        except BaseException:
            self.server.close()
            raise

    # -- control (any thread) --------------------------------------------------

    def start(self) -> None:
        self.server.start()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="tpumon-relay")
        self._thread.start()

    def unpark(self) -> None:
        """Operator reset of the reconnect circuit breaker."""

        self._connects.clear()
        self.parked = False
        self._wake_ev.set()

    def close(self) -> None:
        self._stop_ev.set()
        self._wake_ev.set()
        t, self._thread = self._thread, None
        # aggregate teardown: a raising member must not skip the rest
        if t is not None:
            try:
                t.join(timeout=10.0)
            except Exception as e:  # noqa: BLE001 — teardown
                # aggregates past a raising join
                log.warn_every("relay.close", 30.0,
                               "relay thread join failed: %r", e)
        try:
            self.server.close()
        except Exception as e:  # noqa: BLE001 — teardown aggregates
            log.warn_every("relay.close", 30.0,
                           "relay server close failed: %r", e)
        dec, self._dec = self._dec, None
        if dec is not None:
            dec.close()

    # tpumon: thread-ok(every counter has a single writer — the relay thread — so increments never tear; this scrape-side reader takes a stale-but-consistent snapshot like StreamPublisher.stats)
    def stats(self) -> Dict[str, float]:
        """Counter snapshot for the ``tpumon_relay_*`` families."""

        live = self.state == LIVE
        # _last_data_mono anchors at connection-established, then at
        # each forwarded frame — a live connection is "fresh" only
        # within the grace of one of those
        if live and time.monotonic() - self._last_data_mono \
                <= self.stale_after_s:
            stale_s = 0.0
        else:
            anchor = self._last_data_mono or self._down_since_mono
            stale_s = (time.monotonic() - anchor) if anchor else 0.0
        return {
            "up": 1.0 if live else 0.0,
            "stale_seconds": max(0.0, stale_s),
            "parked": 1.0 if self.parked else 0.0,
            "reconnects_total": float(self.reconnects_total),
            "upstream_ticks_total": float(self.upstream_ticks_total),
            "upstream_bytes_total": float(self.upstream_bytes_total),
            "subtree_resyncs_total": float(self.subtree_resyncs_total),
            "heartbeats_total": float(self.heartbeats_total),
        }

    # -- relay thread ----------------------------------------------------------

    def _run(self) -> None:
        try:
            while not self._stop_ev.is_set():
                if self.parked:
                    self.state = PARKED
                    self._idle_wait(self.stale_tick_interval_s)
                    continue
                if self._breaker_open():
                    self.parked = True
                    log.warning(
                        "relay: upstream %s flapping (%d connects in "
                        "%.0fs) — parked; unpark() to resume",
                        self.upstream, len(self._connects),
                        self.budget_window_s)
                    continue
                sock = self._dial()
                if sock is None:
                    self._enter_degraded(self.last_error)
                    self._backoff_wait()
                    continue
                self._serve_upstream(sock)
                if not self._stop_ev.is_set():
                    # backoff applies after LOSING a connection too —
                    # a dead-but-accepting upstream (connect succeeds,
                    # EOF before a frame) must never redial in a hot
                    # loop; frames reset the backoff to base
                    self._backoff_wait()
        finally:
            dec, self._dec = self._dec, None
            if dec is not None:
                dec.close()

    def _breaker_open(self) -> bool:
        if self.reconnect_budget <= 0:
            return False
        now = time.monotonic()
        while self._connects and \
                self._connects[0] < now - self.budget_window_s:
            self._connects.popleft()
        return len(self._connects) >= self.reconnect_budget

    def _dial(self) -> Optional[socket.socket]:
        kind, target = _parse_upstream(self.upstream)
        if kind == "unix":
            sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        else:
            sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        try:
            sock.settimeout(self.connect_timeout_s)
            sock.connect(target)
            if sock.family == socket.AF_INET:
                sock.setsockopt(socket.IPPROTO_TCP,
                                socket.TCP_NODELAY, 1)
            # one subscribe op per CONNECTION — never per tick
            sock.sendall(json.dumps(  # tpumon-lint: disable=json-in-sweep-path
                {"op": "stream", "stream": self.stream},
                separators=(",", ":")).encode(  # tpumon-lint: disable=encode-in-hot-path
                    "utf-8") + b"\n")
            # bounded reads from here on: the timeout is the heartbeat
            # cadence, so a silent upstream never wedges the thread
            sock.settimeout(self.stale_tick_interval_s)
        except OSError as e:
            self.last_error = f"connect {self.upstream}: {e}"
            sock.close()
            return None
        return sock

    def _serve_upstream(self, sock: socket.socket) -> None:
        self._connects.append(time.monotonic())
        self.upstream_connects_total += 1
        was_down = self._had_connection
        if was_down:
            self.reconnects_total += 1
            outage = (time.monotonic() - self._down_since_mono
                      if self._down_since_mono else 0.0)
            log.info("relay: reconnected to %s after %.1fs "
                     "(subtree resyncs on the keyframe)",
                     self.upstream, outage)
        self._had_connection = True
        self.state = LIVE
        # the freshness anchor starts at connection-established: an
        # upstream that accepts but never sends a frame must still be
        # flagged stale after the grace (stats() and the heartbeat
        # trigger both read this), not look fresh forever
        self._last_data_mono = time.monotonic()
        self._buf.clear()
        self._pending = None
        reason = "EOF"
        try:
            while not self._stop_ev.is_set():
                try:
                    chunk = sock.recv(65536)
                except socket.timeout:
                    # silent upstream: surface staleness downstream
                    # once the grace elapses, then heartbeat on cadence
                    if self._last_data_mono and \
                            time.monotonic() - self._last_data_mono \
                            >= self.stale_after_s:
                        self._maybe_heartbeat()
                    continue
                except OSError as e:
                    reason = f"recv: {e}"
                    return
                if not chunk:
                    reason = "EOF"
                    return
                self.upstream_bytes_total += len(chunk)
                self._buf += chunk
                try:
                    self._handle_records()
                except ValueError as e:
                    # mid-frame tear / desync / refused subscribe: the
                    # connection is unusable — reconnect resyncs
                    reason = str(e)
                    return
        finally:
            try:
                sock.close()
            except OSError:
                pass
            if not self._stop_ev.is_set():
                self._enter_degraded(reason)

    def _enter_degraded(self, reason: str) -> None:
        first = self.state != DEGRADED
        self.state = DEGRADED
        self.last_error = reason
        self._down_since_mono = self._down_since_mono or time.monotonic()
        if first:
            # edge-triggered like the fleet poller's DOWN logging: one
            # warn per down-edge, never one per backoff attempt
            log.warning("relay: upstream %s lost (%s) — serving "
                        "last-known state, reconnecting with backoff",
                        self.upstream, reason)
            self._emit_heartbeat()

    def _backoff_wait(self) -> None:
        if self._backoff_s <= 0.0:
            self._backoff_s = self.backoff_base_s
        else:
            self._backoff_s = min(self._backoff_s * 2.0,
                                  self.backoff_max_s)
        self._idle_wait(self._backoff_s * self._jitter())

    def _idle_wait(self, duration_s: float) -> None:
        """Wait out a backoff/parked period in heartbeat-sized slices
        so downstream staleness stays fresh and stop()/unpark() are
        prompt."""

        deadline = time.monotonic() + duration_s
        while not self._stop_ev.is_set():
            self._maybe_heartbeat()
            remaining = deadline - time.monotonic()
            if remaining <= 0.0:
                return
            if self._wake_ev.wait(
                    min(remaining, self.stale_tick_interval_s)):
                self._wake_ev.clear()
                if not self.parked:
                    return

    def _maybe_heartbeat(self) -> None:
        now = time.monotonic()
        if now >= self._next_hb_mono:
            self._emit_heartbeat()

    def _emit_heartbeat(self) -> None:
        self._next_hb_mono = time.monotonic() + self.stale_tick_interval_s
        self.heartbeats_total += 1
        self.publisher.forward_heartbeat(self.last_tick_ts)

    # -- the per-record hot path (relay thread) --------------------------------

    def _handle_records(self) -> None:
        """Parse every complete record in the inbound buffer and
        forward it.  Raises ``ValueError`` on a desynchronized or
        refused stream — the caller drops the connection."""

        buf = self._buf
        while buf:
            lead = buf[0]
            if lead == 0x7B:  # '{' — the hub's JSON error line
                nl = buf.find(b"\n")
                if nl < 0:
                    return
                raise ValueError(
                    "subscribe refused: "
                    + bytes(buf[:nl]).decode("utf-8", "replace"))
            if lead not in (SEG_HEADER_MAGIC, TICK_MAGIC,
                            SWEEP_FRAME_MAGIC, KMSG_MAGIC,
                            ANOMALY_MAGIC):
                raise ValueError(
                    f"desynchronized stream (lead byte {lead:#x})")
            parsed = try_split_frame(buf)
            if parsed is None:
                return  # mid-record: wait for more bytes
            payload, used = parsed
            raw = bytes(buf[:used])
            del buf[:used]
            self.upstream_records_total += 1
            if lead == SEG_HEADER_MAGIC:
                # the upstream's identity — recorded, never forwarded:
                # this relay's hub writes its own header per attach
                self.upstream_header = _decode_header(payload)
            elif lead == TICK_MAGIC:
                ts, flags = _decode_tick(payload)
                if flags & _TICK_STALE and not flags & _TICK_KEYFRAME:
                    # the PARENT relay's frameless heartbeat: cascade
                    # it verbatim — staleness anywhere up the chain is
                    # visible at every leaf
                    self._pending = None
                    self.heartbeats_total += 1
                    self.publisher.forward_heartbeat(ts, payload=raw)
                else:
                    self._pending = (ts, flags, raw)
            elif lead == SWEEP_FRAME_MAGIC:
                pending = self._pending
                if pending is None:
                    raise ValueError("frame without a tick record")
                ts, flags, tick_raw = pending
                self._pending = None
                keyframe = bool(flags & _TICK_KEYFRAME)
                if keyframe:
                    old, self._dec = self._dec, SweepFrameDecoder(
                        adopt_first_index=True)
                    self._snap = None
                    if old is not None:
                        old.close()
                        self.subtree_resyncs_total += 1
                dec = self._dec
                if dec is None:
                    raise ValueError("frame before the first keyframe")
                dec.apply(payload)
                idx = dec._next_frame_index - 1
                stale = bool(flags & _TICK_STALE)
                self.upstream_ticks_total += 1
                self.last_tick_ts = ts
                self._last_data_mono = time.monotonic()
                self._down_since_mono = 0.0
                self._backoff_s = 0.0
                # forward the upstream bytes VERBATIM; the mirror
                # snapshot + index let the loop thread synthesize
                # attach/resync keyframes locally at exactly this
                # point.  A zero-change frame (the steady index-only
                # shortcut) reuses the previous snapshot — the mirror
                # provably did not mutate, so a steady tick pays no
                # O(table) copy
                snap = self._snap
                if snap is None or dec.last_changes != 0:
                    snap = dec.mirror_snapshot()
                    self._snap = snap
                self.publisher.forward(
                    tick_raw + raw, snap, idx, ts,
                    keyframe=keyframe, stale=stale)
            else:  # KMSG / ANOMALY: auxiliary records ride verbatim
                self.publisher.publish_record(raw)


def _parse_upstream(address: str) -> Tuple[str, Any]:
    """``unix:/path`` or ``host:port`` — the agent-protocol address
    convention (:func:`tpumon_torch.backends.agent._parse_address` without
    importing the backend stack into the relay plane)."""

    if address.startswith("unix:"):
        return "unix", address[5:]
    host, _, port = address.rpartition(":")
    if not host or not port.isdigit():
        raise ValueError(f"bad upstream address {address!r} "
                         f"(want unix:/path or host:port)")
    return "tcp", (host, int(port))


def relay_metric_lines(relay: StreamRelay) -> List[str]:
    """The ``tpumon_relay_*`` + ``tpumon_stream_*`` scrape for
    ``tpumon-relay --metrics-port``, emitted from the single
    :data:`METRIC_FAMILIES` registration."""

    from .exporter.promtext import render_family_samples

    st = relay.stats()
    lbl = f'upstream="{relay.upstream}",stream="{relay.stream}"'
    lines: List[str] = []
    for fam, ptype, help_txt in METRIC_FAMILIES:
        key = fam[len("tpumon_relay_"):]
        lines += render_family_samples(fam, ptype, help_txt,
                                       [(lbl, st[key])], fmt=".0f"
                                       if key != "stale_seconds"
                                       else ".3f")
    ss = relay.publisher.stats()
    for key, ptype, help_txt in (
            ("subscribers", "gauge", "Downstream subscribers "
             "currently attached to this relay."),
            ("subscribers_total", "counter", "Downstream subscribers "
             "ever attached since start."),
            ("frames_sent_total", "counter", "Frames (forwards + "
             "keyframes) queued downstream since start."),
            ("bytes_sent_total", "counter", "Bytes queued downstream "
             "since start."),
            ("keyframes_total", "counter", "Locally-synthesized and "
             "forwarded keyframes sent since start."),
            ("dropped_frames_total", "counter", "Frames not queued to "
             "stale (overflowed) downstream subscribers since "
             "start."),
            ("resyncs_total", "counter", "Drop-to-keyframe "
             "recoveries of slow downstream subscribers since "
             "start.")):
        lines += render_family_samples(f"tpumon_stream_{key}", ptype,
                                       help_txt, [(lbl, float(ss[key]))],
                                       fmt=".0f")
    return lines


class RelayTree:
    """A k-deep, f-wide in-process relay tree over one upstream — the
    test harness of ``tests/test_torch_relay.py``.

    Level d holds ``fanout**d`` relays; each connects to a level-(d-1)
    relay (level 1 connects to the origin), children spread
    round-robin.  ``leaf_addresses()`` is where leaf subscribers
    attach."""

    def __init__(self, upstream: str, stream: str = "", *,
                 depth: int = 2, fanout: int = 2,
                 **relay_kwargs: Any) -> None:
        if depth < 1 or fanout < 1:
            raise ValueError("depth and fanout must be >= 1")
        self.levels: List[List[StreamRelay]] = []
        try:
            parents = [upstream]
            for d in range(depth):
                level: List[StreamRelay] = []
                for i in range(fanout ** (d + 1)):
                    r = StreamRelay(parents[i % len(parents)], stream,
                                    **relay_kwargs)
                    level.append(r)
                    r.start()
                self.levels.append(level)
                parents = [r.address for r in level]
        except BaseException:
            self.close()
            raise

    def leaves(self) -> List[StreamRelay]:
        return self.levels[-1]

    def leaf_addresses(self) -> List[str]:
        return [r.address for r in self.levels[-1]]

    def all_relays(self) -> List[StreamRelay]:
        return [r for level in self.levels for r in level]

    def close(self) -> None:
        # leaves first so parents never log a storm of child EOFs as
        # subscriber churn during teardown; aggregate either way
        for level in reversed(self.levels):
            for r in level:
                try:
                    r.close()
                except Exception as e:  # noqa: BLE001 — teardown
                    # must aggregate past one wedged relay
                    log.warn_every("relaytree.close", 30.0,
                                   "relay close failed: %r", e)
        self.levels = []
