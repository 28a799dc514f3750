"""Black-box flight recorder: durable sweep history on disk.

The port's copy of ``tpumon/blackbox.py``, with imports renamed; the
exporter daemon tees every sweep into it (``--blackbox-dir``) and
``python -m tpumon_torch.cli.replay`` reads it back.  A crash-safe,
bounded-disk, append-only recorder whose file format **is** the
``sweep_frame`` delta codec (:mod:`tpumon_torch.sweepframe`) — one encode
per sweep, a handful of bytes per steady-state tick, and a reader that
replays any time window back into full decoded snapshots.  The port's
segments are byte-identical to the reference's on the same inputs
(``tests/test_torch_blackbox.py``), so either reader reads either
writer's files.

Segment file format (``bb-<start_ms>-<seq>.seg``), a flat sequence of
varint-framed records — every record is ``lead byte + varint length +
payload`` exactly like a wire sweep frame, so one incremental splitter
(:func:`tpumon_torch.sweepframe.try_split_frame`) reads them all:

* ``0xB0`` **segment header** (first record of every segment):
  ``{1: format version, 2: wall start double bits, 3: host utf-8}``.
* ``0xB1`` **tick**: ``{1: wall timestamp double bits, 2: flags}``
  (bit 0: keyframe).  Announces the sweep frame that follows.
* ``0xA9`` **sweep frame** — byte-for-byte a
  :class:`~tpumon_torch.sweepframe.SweepFrameEncoder` frame, piggybacked
  events included.  The writer keeps its own per-*segment* delta
  table: at each rotation the table resets, so the first frame of a
  segment is a full snapshot (the keyframe) and **every segment is
  self-contained** — replay never needs an earlier file.
* ``0xB2`` **kmsg line**: ``{1: wall timestamp double bits,
  2: line utf-8}`` — raw kernel-log evidence recorded next to the
  values it explains.
* ``0xB3`` **anomaly/incident finding**: one verdict from the
  streaming detection plane (:mod:`tpumon_torch.anomaly`) recorded
  beside the sweep that produced it.

Durability model: appends go through a buffered file, flushed on a
*time* policy (default 1 s) — never per sweep, and never fsync'd in
the hot path.  After ``kill -9`` the tail of the last segment may be
torn mid-record; :class:`BlackBoxReader` recovers every record before
the tear and never raises on garbage bytes.  A restarted writer always
opens a NEW segment, so a torn tail can only ever exist at the very end
of a dead writer's last segment.

Retention: a byte budget per directory (default 64 MiB).  After each
rotation the oldest closed segments are reclaimed until the directory
fits.
"""

from __future__ import annotations

import io
import os
import struct
import threading
import time
from dataclasses import dataclass, field as dc_field
from typing import Dict, Iterator, List, Optional, Sequence, Tuple, Union

from . import log
from .backends.base import FieldValue
from .events import Event
from .sweepframe import (SWEEP_FRAME_MAGIC, SweepFrameDecoder,
                         SweepFrameEncoder, try_split_frame)
from .wire import (read_varint, write_bytes_field, write_double_field,
                   write_varint, write_varint_field)

#: record lead bytes (disjoint from the wire protocol's request magic
#: and from ``{`` so a segment can never be confused with a JSON log)
SEG_HEADER_MAGIC = 0xB0
TICK_MAGIC = 0xB1
KMSG_MAGIC = 0xB2
ANOMALY_MAGIC = 0xB3

FORMAT_VERSION = 1

_TICK_KEYFRAME = 1  # flags bit 0
#: flags bit 1: the tick's snapshot is STALE — a relay serving its
#: last-known mirror while its upstream is unreachable (the staleness
#: contract of docs/streaming.md).  Recorded segments never set it
#: today; readers pass it through so a recorded relay stream would
#: replay with its staleness intact.
_TICK_STALE = 2

#: default disk budget per recorder directory
DEFAULT_MAX_BYTES = 64 << 20


def _frame_record(magic: int, body: Union[bytes, bytearray]) -> bytes:
    head = bytearray((magic,))
    write_varint(head, len(body))
    return bytes(head + body)


def segment_name(start_ts: float, seq: int) -> str:
    """Time-indexed segment file name: lexicographic order == time
    order (13-digit ms covers wall clocks through year 2286)."""

    return f"bb-{int(start_ts * 1000.0):013d}-{seq:06d}.seg"


_NAME_LEN = len(segment_name(0.0, 0))


def _parse_segment_name(name: str) -> Optional[float]:
    """Start wall time from a segment file name, or None."""

    if (len(name) != _NAME_LEN or not name.startswith("bb-")
            or not name.endswith(".seg")):
        return None
    try:
        return int(name[3:16]) / 1000.0
    except ValueError:
        return None


class BlackBoxWriter:
    """Append-only recorder for one host's sweep stream.

    One writer per recorded host; ``record_sweep`` is called from the
    exporter's sweep loop, ``record_kmsg`` may be called from a
    :class:`~tpumon_torch.kmsg.KmsgWatcher` thread — a lock serializes
    the two.  The encode cost is the codec's delta-table pass; a caller
    that *knows* the sweep is unchanged passes ``unchanged=True`` and
    pays a few microseconds for the index-only frame instead.
    """

    def __init__(self, directory: str, *,
                 host: str = "",
                 max_bytes: int = DEFAULT_MAX_BYTES,
                 segment_seconds: float = 60.0,
                 max_segment_bytes: int = 8 << 20,
                 flush_interval_s: float = 1.0) -> None:
        """``segment_seconds`` is the keyframe cadence: every rotation
        starts a self-contained segment with a full-snapshot frame.
        ``max_segment_bytes`` bounds a single segment under event
        storms (full-churn frames at 256 chips are ~60 KB each)."""

        self.directory = directory
        self.host = host or os.uname().nodename
        self.max_bytes = int(max_bytes)
        self.segment_seconds = float(segment_seconds)
        self.max_segment_bytes = int(max_segment_bytes)
        self.flush_interval_s = float(flush_interval_s)
        os.makedirs(directory, exist_ok=True)
        self._lock = threading.Lock()
        self._file: Optional[io.BufferedWriter] = None
        self._seg_path = ""
        self._seg_bytes = 0
        self._seg_seq = 0
        self._seg_started_mono = 0.0
        self._last_flush_mono = 0.0
        self._pending_kf = True  # next frame must be a keyframe
        # -- self-metric counters (tpumon_blackbox_*) --
        self.bytes_written_total = 0
        self.frames_total = 0
        self.keyframes_total = 0
        self.events_total = 0
        self.kmsg_total = 0
        self.findings_total = 0
        self.segments_created_total = 0
        self.segments_reclaimed_total = 0
        self.write_errors_total = 0
        self.records_dropped_total = 0
        #: after an IO failure, do not touch the disk again before this
        #: monotonic deadline — records arriving earlier are COUNTED
        #: drops, so a persistently full disk costs the sweep thread a
        #: counter increment per record, not a failing open()+write()
        #: per record.  The retry cadence is the timed-flush interval:
        #: the same "at most once per flush_interval_s" policy the hot
        #: path already runs on.
        self._retry_open_mono = 0.0
        #: live on-disk segment count, tracked incrementally — stats()
        #: runs per /metrics scrape under the writer lock, and a
        #: listdir there would put disk metadata latency on the very
        #: lock the sweep thread's record path needs
        self.segments_live = len(self._list_segments())
        # the per-segment delta table
        self._enc = SweepFrameEncoder()

    # -- recording ------------------------------------------------------------

    def record_sweep(self, chips: Dict[int, Dict[int, FieldValue]],
                     events: Optional[Sequence[Event]] = None,
                     now: Optional[float] = None,
                     unchanged: bool = False) -> None:
        """Tee one sweep: a tick record + a delta frame against the
        writer's own per-segment table.  ``now`` is the sweep's wall
        timestamp (defaults to the current wall clock — timestamps are
        the replay correlation key, not an interval measurement).
        ``unchanged=True`` skips the delta-table compare pass and
        emits an index-only frame; only pass it when the sweep is
        KNOWN identical to the previous one (same chips, same values,
        no events)."""

        if now is None:
            # wall clock on purpose: recorded timestamps are what the
            # operator replays against ("what did chip 3 report at
            # 03:00:17"), not a duration source
            now = time.time()  # tpumon-lint: disable=wallclock-in-sampling
        with self._lock:
            if self._dropping():
                return
            try:
                self._rotate_if_due(now)
                keyframe = self._pending_kf
                if keyframe:
                    # rotation reset the table: this frame is a full
                    # snapshot, whatever the caller thought it knew
                    unchanged = False
                tick = bytearray()
                write_double_field(tick, 1, now)
                write_varint_field(tick, 2, _TICK_KEYFRAME if keyframe
                                   else 0)
                if unchanged and not events:
                    frame = self._enc.encode_index_only_frame()
                else:
                    frame = self._enc.encode_frame(chips, events)
                self._append(_frame_record(TICK_MAGIC, tick))
                self._append(frame)
                self._pending_kf = False
                self.frames_total += 1
                if keyframe:
                    self.keyframes_total += 1
                if events:
                    self.events_total += len(events)
                self._maybe_flush()
            except (OSError, ValueError) as e:
                # ValueError covers "write to closed file" — same
                # failure class as any other dead segment handle
                self._io_failed("sweep", e)

    def record_kmsg(self, line: str, now: Optional[float] = None) -> None:
        """Record one raw kernel-log line next to the sweep stream
        (the :class:`~tpumon_torch.kmsg.KmsgWatcher` sink adapter)."""

        if now is None:
            # wall clock: same correlation-key rationale as record_sweep
            now = time.time()  # tpumon-lint: disable=wallclock-in-sampling
        with self._lock:
            if self._dropping():
                return
            try:
                self._rotate_if_due(now)
                body = bytearray()
                write_double_field(body, 1, now)
                # kmsg-event-gated: one encode per classified kernel
                # line (rare), never steady-state — the sweep thread
                # reaches here only when the detection plane's drain
                # hands it a queued line
                write_bytes_field(body, 2,
                                  line.encode("utf-8"))  # tpumon-check: disable=hot-encode
                self._append(_frame_record(KMSG_MAGIC, body))
                self.kmsg_total += 1
                self._maybe_flush()
            except (OSError, ValueError) as e:
                self._io_failed("kmsg", e)

    def record_finding(self, rec: "AnomalyRecord") -> None:
        """Record one detection-plane verdict (0xB3) beside the sweep
        that produced it.  The record carries its own timestamp (the
        sweep's wall stamp the engine scored at), so replay lines the
        finding up with the exact values that fired it."""

        with self._lock:
            if self._dropping():
                return
            try:
                self._rotate_if_due(rec.timestamp)
                self._append(encode_finding(rec))
                self.findings_total += 1
                self._maybe_flush()
            except (OSError, ValueError) as e:
                self._io_failed("finding", e)

    def stats(self) -> Dict[str, int]:
        """Counter snapshot for the ``tpumon_blackbox_*`` self-metric
        families (plus the live on-disk segment count)."""

        with self._lock:
            return {
                "bytes_written_total": self.bytes_written_total,
                "frames_total": self.frames_total,
                "keyframes_total": self.keyframes_total,
                "events_total": self.events_total,
                "kmsg_total": self.kmsg_total,
                "findings_total": self.findings_total,
                "segments_created_total": self.segments_created_total,
                "segments_reclaimed_total": self.segments_reclaimed_total,
                "write_errors_total": self.write_errors_total,
                "records_dropped_total": self.records_dropped_total,
                "segments": self.segments_live,
            }

    def flush(self) -> None:
        """Force buffered records to the OS now (tests, clean stop)."""

        with self._lock:
            if self._file is not None:
                try:
                    # explicit caller-requested durability point, not a
                    # per-sweep append; holding the lock over it is the
                    # point — the caller wants the buffer down before
                    # the next record can interleave
                    self._file.flush()  # tpumon-lint: disable=fsync-in-hot-path  # tpumon-check: disable=blocking-while-locked
                except (OSError, ValueError) as e:
                    self._io_failed("flush", e,
                                    record_in_flight=False)

    def close(self) -> None:
        with self._lock:
            self._close_segment()

    # -- internals (caller holds self._lock) ----------------------------------

    def _append(self, data: bytes) -> None:  # tpumon-lint: disable=lock-discipline
        # caller holds self._lock
        assert self._file is not None
        self._file.write(data)
        self._seg_bytes += len(data)
        self.bytes_written_total += len(data)

    def _maybe_flush(self) -> None:  # tpumon-lint: disable=lock-discipline
        # caller holds self._lock.  TIME-based flush policy: at most one
        # buffered flush per flush_interval_s, never per sweep, and no
        # fsync anywhere near the hot path — a crash loses at most the
        # last interval's records, which torn-tail recovery tolerates
        now_mono = time.monotonic()
        if now_mono - self._last_flush_mono >= self.flush_interval_s:
            self._last_flush_mono = now_mono
            if self._file is not None:
                # at most one buffered flush per interval, under the
                # writer lock by design: the lock serializes the sweep
                # and kmsg writers, and the flush is a bounded memcpy
                # into the page cache (never an fsync)
                self._file.flush()  # tpumon-lint: disable=fsync-in-hot-path  # tpumon-check: disable=blocking-while-locked

    def _dropping(self) -> bool:  # tpumon-lint: disable=lock-discipline
        # caller holds self._lock.  True while a recent IO failure has
        # the writer degraded to counted drops: the record is lost (and
        # counted), the disk untouched until the retry deadline passes
        if self._file is None and \
                time.monotonic() < self._retry_open_mono:
            self.records_dropped_total += 1
            return True
        return False

    def _io_failed(self, what: str, e: Exception,
                   record_in_flight: bool = True) -> None:  # tpumon-lint: disable=lock-discipline
        # caller holds self._lock.  A full/unwritable disk must degrade
        # the RECORDER, never the sweep: drop the segment, count the
        # record that was being written as dropped, and retry a fresh
        # segment open only at the next timed-flush boundary — a
        # persistently failing disk costs counter increments, not a
        # per-record open()+write() storm on the sweep thread.
        # ``record_in_flight=False`` (the explicit flush() path) fails
        # with no record being written — nothing to count as dropped.
        self.write_errors_total += 1
        if record_in_flight:
            self.records_dropped_total += 1
        self._retry_open_mono = (time.monotonic()
                                 + max(self.flush_interval_s, 0.0))
        log.warn_every("blackbox.write", 30.0,
                       "flight recorder %s write failed (%r); "
                       "dropping current segment, retrying in %.1fs",
                       what, e, self.flush_interval_s)
        try:
            self._close_segment()
        except (OSError, ValueError):
            pass

    def _rotate_if_due(self, now: float) -> None:  # tpumon-lint: disable=lock-discipline
        # caller holds self._lock
        if self._file is not None:
            age = time.monotonic() - self._seg_started_mono
            if (age < self.segment_seconds
                    and self._seg_bytes < self.max_segment_bytes):
                return
        self._close_segment()
        # fresh segment => fresh delta table => the next frame is a
        # full-snapshot keyframe, making the segment self-contained
        self._enc = SweepFrameEncoder()
        self._pending_kf = True
        path = os.path.join(self.directory, segment_name(now, self._seg_seq))
        while os.path.exists(path):  # restart within the same ms
            self._seg_seq += 1
            path = os.path.join(self.directory,
                                segment_name(now, self._seg_seq))
        f = open(path, "ab", buffering=1 << 16)
        self._file = f
        self._seg_path = path
        self._seg_bytes = 0
        self._seg_seq += 1
        self._seg_started_mono = time.monotonic()
        self.segments_created_total += 1
        self.segments_live += 1
        header = bytearray()
        write_varint_field(header, 1, FORMAT_VERSION)
        write_double_field(header, 2, now)
        # once per segment ROTATION (default 60 s), not per sweep
        write_bytes_field(header, 3,
                          self.host.encode(  # tpumon-check: disable=hot-encode
                              "utf-8"))
        self._append(_frame_record(SEG_HEADER_MAGIC, header))
        self._reclaim()

    def _close_segment(self) -> None:  # tpumon-lint: disable=lock-discipline
        # caller holds self._lock
        f, self._file = self._file, None
        self._seg_path = ""
        self._seg_bytes = 0
        if f is not None:
            try:
                f.close()
            except OSError as e:
                log.warn_every("blackbox.close", 30.0,
                               "flight recorder segment close failed: "
                               "%r", e)

    def _list_segments(self) -> List[str]:  # tpumon-lint: disable=lock-discipline
        # caller holds self._lock (read-only helper; sorted names ==
        # time order by construction)
        try:
            return sorted(n for n in os.listdir(self.directory)
                          if _parse_segment_name(n) is not None)
        except OSError:
            return []

    def _reclaim(self) -> None:  # tpumon-lint: disable=lock-discipline
        # caller holds self._lock.  Oldest-first reclamation down to the
        # byte budget; the active segment is never a candidate
        names = self._list_segments()
        active = os.path.basename(self._seg_path)
        sizes: Dict[str, int] = {}
        total = 0
        for n in names:
            try:
                sizes[n] = os.stat(os.path.join(self.directory, n)).st_size
            except OSError:
                sizes[n] = 0
            total += sizes[n]
        for n in names:
            if total <= self.max_bytes:
                break
            if n == active:
                # never reclaim the active segment — and keep walking:
                # a backwards wall-clock step can name the active file
                # BEFORE older on-disk segments, and stopping here
                # would make the budget unenforceable for as long as
                # the skew persists
                continue
            try:
                os.unlink(os.path.join(self.directory, n))
            except OSError as e:
                log.warn_every("blackbox.reclaim", 30.0,
                               "flight recorder reclaim of %s failed: "
                               "%r", n, e)
                continue
            total -= sizes[n]
            self.segments_reclaimed_total += 1
            self.segments_live = max(0, self.segments_live - 1)


# -- reader --------------------------------------------------------------------


@dataclass(frozen=True)
class SegmentInfo:
    """One on-disk segment, as listed (header parsed, body unscanned)."""

    path: str
    name: str
    start_ts: float          # wall time of the first record
    size: int
    host: str = ""
    version: int = FORMAT_VERSION


@dataclass
class ReplayTick:
    """One reconstructed sweep: the full snapshot as of ``timestamp``."""

    timestamp: float
    snapshot: Dict[int, Dict[int, FieldValue]]
    events: List[Event] = dc_field(default_factory=list)
    keyframe: bool = False
    changes: int = 0         # mirror mutations this frame applied
    #: the serving relay had lost its upstream when it emitted this
    #: tick: ``snapshot`` is the last-known state as of ``timestamp``,
    #: not a fresh sweep (tick flags bit 1 — see docs/streaming.md)
    stale: bool = False


@dataclass(frozen=True)
class KmsgRecord:
    """One recorded kernel-log line."""

    timestamp: float
    line: str


#: severity wire codes for :class:`AnomalyRecord` (varint field 4)
_SEVERITIES = ("info", "warning", "critical")


@dataclass(frozen=True)
class AnomalyRecord:
    """One detection-plane verdict (the 0xB3 record).

    The streaming detector (:mod:`tpumon_torch.anomaly`) emits these live;
    ``tpumon-replay --backtest`` re-derives them from recorded history
    through the SAME engine — the differential contract is that the
    two sequences are identical (timestamps, evidence, order), which
    is why the record is a frozen value type with a stable ``repr``.
    """

    timestamp: float
    kind: str                       # "anomaly" | "incident"
    rule: str
    severity: str = "warning"       # "info" | "warning" | "critical"
    state: str = "firing"           # "firing" | "cleared"
    chip: int = -1                  # -1 = host/fleet-level
    field: int = -1                 # -1 = no single source field
    value: Optional[float] = None   # the observed value (scalar rules)
    score: Optional[float] = None   # detector score (z, rate, ...)
    message: str = ""
    evidence: Tuple[str, ...] = ()  # "anomaly:rule@ts" / "event:T@ts" / ...


def encode_finding(rec: AnomalyRecord) -> bytes:
    """One framed 0xB3 record (lead byte + varint length + payload) —
    shared by the recorder tee and the live stream plane, so the two
    surfaces can never drift.  Findings are rare (emission is
    edge-gated by the detectors), so the encodes here are never
    steady-state work."""

    body = bytearray()
    write_double_field(body, 1, rec.timestamp)
    write_varint_field(body, 2, 1 if rec.kind == "incident" else 0)
    write_bytes_field(body, 3,
                      rec.rule.encode("utf-8"))  # tpumon-check: disable=hot-encode
    sev = _SEVERITIES.index(rec.severity) if rec.severity in _SEVERITIES \
        else 1
    write_varint_field(body, 4, sev)
    write_varint_field(body, 5, 1 if rec.state == "firing" else 0)
    write_varint_field(body, 6, rec.chip + 1)
    write_varint_field(body, 7, rec.field + 1)
    if rec.value is not None:
        write_double_field(body, 8, float(rec.value))
    if rec.score is not None:
        write_double_field(body, 9, float(rec.score))
    if rec.message:
        write_bytes_field(body, 10,
                          rec.message.encode("utf-8"))  # tpumon-check: disable=hot-encode
    for ev in rec.evidence:
        write_bytes_field(body, 11,
                          ev.encode("utf-8"))  # tpumon-check: disable=hot-encode
    return _frame_record(ANOMALY_MAGIC, body)


def _decode_finding(body: bytes) -> AnomalyRecord:
    ts = 0.0
    kind = 0
    rule = ""
    sev = 1
    state = 1
    chip = -1
    fid = -1
    value: Optional[float] = None
    score: Optional[float] = None
    message = ""
    evidence: List[str] = []
    pos = 0
    n = len(body)
    while pos < n:
        key, pos = read_varint(body, pos)
        fno, wt = key >> 3, key & 0x07
        if fno == 1 and wt == 1:
            ts, pos = _decode_double(body, pos)
        elif fno == 2 and wt == 0:
            kind, pos = read_varint(body, pos)
        elif fno == 4 and wt == 0:
            sev, pos = read_varint(body, pos)
        elif fno == 5 and wt == 0:
            state, pos = read_varint(body, pos)
        elif fno == 6 and wt == 0:
            c1, pos = read_varint(body, pos)
            chip = c1 - 1
        elif fno == 7 and wt == 0:
            f1, pos = read_varint(body, pos)
            fid = f1 - 1
        elif fno == 8 and wt == 1:
            value, pos = _decode_double(body, pos)
        elif fno == 9 and wt == 1:
            score, pos = _decode_double(body, pos)
        elif fno in (3, 10, 11) and wt == 2:
            ln, pos = read_varint(body, pos)
            if pos + ln > n:
                raise ValueError("truncated finding string")
            text = body[pos:pos + ln].decode("utf-8", "replace")
            pos += ln
            if fno == 3:
                rule = text
            elif fno == 10:
                message = text
            else:
                evidence.append(text)
        else:
            raise ValueError(f"unknown finding field {fno}/{wt}")
    return AnomalyRecord(
        timestamp=ts, kind="incident" if kind else "anomaly", rule=rule,
        severity=_SEVERITIES[sev] if 0 <= sev < len(_SEVERITIES)
        else "warning",
        state="firing" if state else "cleared", chip=chip, field=fid,
        value=value, score=score, message=message,
        evidence=tuple(evidence))


def _decode_double(body: bytes, pos: int) -> Tuple[float, int]:
    if pos + 8 > len(body):
        raise ValueError("truncated double")
    return struct.unpack("<d", body[pos:pos + 8])[0], pos + 8


def _decode_tick(body: bytes) -> Tuple[float, int]:
    ts = 0.0
    flags = 0
    pos = 0
    n = len(body)
    while pos < n:
        key, pos = read_varint(body, pos)
        fno, wt = key >> 3, key & 0x07
        if fno == 1 and wt == 1:
            ts, pos = _decode_double(body, pos)
        elif fno == 2 and wt == 0:
            flags, pos = read_varint(body, pos)
        else:
            raise ValueError(f"unknown tick field {fno}/{wt}")
    return ts, flags


def _decode_kmsg(body: bytes) -> KmsgRecord:
    ts = 0.0
    line = ""
    pos = 0
    n = len(body)
    while pos < n:
        key, pos = read_varint(body, pos)
        fno, wt = key >> 3, key & 0x07
        if fno == 1 and wt == 1:
            ts, pos = _decode_double(body, pos)
        elif fno == 2 and wt == 2:
            ln, pos = read_varint(body, pos)
            if pos + ln > n:
                raise ValueError("truncated kmsg line")
            line = body[pos:pos + ln].decode("utf-8", "replace")
            pos += ln
        else:
            raise ValueError(f"unknown kmsg field {fno}/{wt}")
    return KmsgRecord(timestamp=ts, line=line)


def _decode_header(body: bytes) -> Tuple[int, float, str]:
    version = 0
    ts = 0.0
    host = ""
    pos = 0
    n = len(body)
    while pos < n:
        key, pos = read_varint(body, pos)
        fno, wt = key >> 3, key & 0x07
        if fno == 1 and wt == 0:
            version, pos = read_varint(body, pos)
        elif fno == 2 and wt == 1:
            ts, pos = _decode_double(body, pos)
        elif fno == 3 and wt == 2:
            ln, pos = read_varint(body, pos)
            if pos + ln > n:
                raise ValueError("truncated header host")
            host = body[pos:pos + ln].decode("utf-8", "replace")
            pos += ln
        else:
            raise ValueError(f"unknown header field {fno}/{wt}")
    return version, ts, host


class BlackBoxReader:
    """Replays recorded history back into decoded snapshots.

    Tolerant by construction: a segment that ends mid-record (the torn
    tail after ``kill -9``), or whose tail is garbage, yields every
    record before the damage and stops — replay NEVER raises for bad
    bytes, it only under-delivers and counts the damage in
    ``last_torn_segments``.  Each segment decodes with a fresh
    :class:`~tpumon_torch.sweepframe.SweepFrameDecoder` (segments are
    self-contained), so damage never leaks across files.
    """

    def __init__(self, directory: str) -> None:
        self.directory = directory
        #: segments whose tail was torn/garbage in the last replay()
        self.last_torn_segments = 0
        #: segments listed but GONE by the time replay opened them —
        #: retention reclaimed them under the reader (normal for a
        #: follower on a tiny byte budget, so counted apart from torn:
        #: a reclaimed segment is bounded history loss by POLICY, a
        #: torn one is damage)
        self.last_missing_segments = 0
        #: records recovered in the last replay() (pre-filter)
        self.last_records = 0

    def segments(self) -> List[SegmentInfo]:
        """All segments, oldest first (header parsed for host/version;
        an unreadable or headerless file still lists, by name)."""

        out: List[SegmentInfo] = []
        try:
            names = sorted(os.listdir(self.directory))
        except OSError:
            return []
        for name in names:
            start = _parse_segment_name(name)
            if start is None:
                continue
            path = os.path.join(self.directory, name)
            try:
                size = os.stat(path).st_size
            except OSError:
                continue
            host = ""
            version = 0
            try:
                with open(path, "rb") as f:
                    head = f.read(256)
                if head and head[0] == SEG_HEADER_MAGIC:
                    parsed = try_split_frame(head)
                    if parsed is not None:
                        version, start, host = _decode_header(parsed[0])
            except (OSError, ValueError):
                pass  # listed by name; replay will count the damage
            out.append(SegmentInfo(path=path, name=name, start_ts=start,
                                   size=size, host=host, version=version))
        return out

    def replay(self, start_ts: Optional[float] = None,
               end_ts: Optional[float] = None,
               ) -> Iterator[Union[ReplayTick, KmsgRecord, AnomalyRecord]]:
        """Reconstruct the window ``[start_ts, end_ts]`` (None = open
        end) as a time-ordered stream of :class:`ReplayTick` and
        :class:`KmsgRecord` items.

        Frames before ``start_ts`` inside the first relevant segment
        are applied silently (they build the mirror state the first
        yielded snapshot needs); ticks after ``end_ts`` stop the scan.
        """

        self.last_torn_segments = 0
        self.last_missing_segments = 0
        self.last_records = 0
        segs = self.segments()
        if not segs:
            return
        picked: List[SegmentInfo] = []
        for i, seg in enumerate(segs):
            nxt = segs[i + 1].start_ts if i + 1 < len(segs) else None
            if end_ts is not None and seg.start_ts > end_ts:
                continue
            if (start_ts is not None and nxt is not None
                    and nxt <= start_ts):
                continue  # fully before the window, superseded
            picked.append(seg)
        for seg in picked:
            for item in self._replay_segment(seg, start_ts, end_ts):
                yield item

    def _replay_segment(self, seg: SegmentInfo,
                        start_ts: Optional[float],
                        end_ts: Optional[float],
                        ) -> Iterator[Union[ReplayTick, KmsgRecord, AnomalyRecord]]:
        try:
            with open(seg.path, "rb") as f:
                data = f.read()
        except FileNotFoundError:
            # reclaimed between listing and open: retention ran under
            # the reader (a follower on a small-budget recorder hits
            # this constantly) — skip to the segments that still
            # exist; the newest one always does, the writer never
            # reclaims its active file
            self.last_missing_segments += 1
            log.vlog(1, "flight recorder segment %s reclaimed under "
                        "replay", seg.name)
            return
        except OSError as e:
            log.warn_every("blackbox.read", 30.0,
                           "flight recorder segment %s unreadable: %r",
                           seg.name, e)
            self.last_torn_segments += 1
            return
        yield from self._walk_segment(data, SweepFrameDecoder(),
                                      start_ts, end_ts)

    def _walk_segment(self, data: bytes, decoder: SweepFrameDecoder,
                      start_ts: Optional[float], end_ts: Optional[float],
                      ) -> Iterator[Union[ReplayTick, KmsgRecord, AnomalyRecord]]:
        pos = 0
        n = len(data)
        tick_ts: Optional[float] = None
        tick_flags = 0
        while pos < n:
            lead = data[pos]
            # inline record split (same framing rules as
            # sweepframe.try_split_frame, without slicing the remaining
            # buffer per record — a 1 h segment walks in one pass)
            p = pos + 1
            length = 0
            shift = 0
            while True:
                if p >= n:
                    # incomplete final record — torn tail after kill -9
                    self.last_torn_segments += 1
                    return
                b = data[p]
                p += 1
                length |= (b & 0x7F) << shift
                if not b & 0x80:
                    break
                shift += 7
                if shift > 63:
                    self.last_torn_segments += 1
                    return  # malformed length: the rest is noise
            if p + length > n:
                self.last_torn_segments += 1
                return  # record extends past EOF: torn tail
            payload = data[p:p + length]
            pos = p + length
            try:
                if lead == TICK_MAGIC:
                    tick_ts, tick_flags = _decode_tick(payload)
                elif lead == SWEEP_FRAME_MAGIC:
                    if tick_ts is None:
                        raise ValueError("frame without a tick record")
                    events = decoder.apply(payload)
                    self.last_records += 1
                    ts = tick_ts
                    tick_ts = None
                    if end_ts is not None and ts > end_ts:
                        return
                    if start_ts is not None and ts < start_ts:
                        continue  # state applied, snapshot not wanted
                    yield ReplayTick(
                        timestamp=ts,
                        snapshot=decoder.mirror_snapshot(),
                        events=events,
                        keyframe=bool(tick_flags & _TICK_KEYFRAME),
                        changes=decoder.last_changes,
                        stale=bool(tick_flags & _TICK_STALE))
                elif lead == KMSG_MAGIC:
                    rec = _decode_kmsg(payload)
                    self.last_records += 1
                    if end_ts is not None and rec.timestamp > end_ts:
                        # skip, do NOT stop: the kmsg thread's stamp
                        # can run ahead of the next tick's (taken at
                        # sweep START, written after collect) — only
                        # tick timestamps are monotone per writer and
                        # may terminate the scan
                        continue
                    if (start_ts is not None
                            and rec.timestamp < start_ts):
                        continue
                    yield rec
                elif lead == ANOMALY_MAGIC:
                    frec = _decode_finding(payload)
                    self.last_records += 1
                    # same window rules as kmsg: finding stamps share
                    # the tick's clock but are not the monotone cursor
                    if end_ts is not None and frec.timestamp > end_ts:
                        continue
                    if (start_ts is not None
                            and frec.timestamp < start_ts):
                        continue
                    yield frec
                elif lead == SEG_HEADER_MAGIC:
                    _decode_header(payload)  # validated, nothing kept
                else:
                    raise ValueError(f"unknown record magic {lead:#x}")
            except ValueError:
                # a record that framed but does not decode: bit rot or
                # a tear that landed on a length boundary — stop this
                # segment, never raise
                self.last_torn_segments += 1
                return
