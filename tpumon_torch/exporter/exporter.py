"""The exporter daemon's engine: the sweep, its planes, the textfile
merge, pod attribution, the run loop and the HTTP ``/metrics`` server.

Counterpart of ``tpumon/exporter/exporter.py``: field and label setup,
one watch over the selected chips, the sweep (collect -> anomaly ->
record -> render -> merge -> publish) with exporter-side not-idle
tracking, the atomic textfile publish, the in-memory body served over
HTTP (``/metrics``, ``/tpu/metrics``, ``/healthz``; gzip compressed at
most once per sweep), the textfile-collector merge of fresh ``*.prom``
drop files, label-level pod attribution, and the ``tpumon_exporter_*``
self-metrics.  Families keep their ``tpu_*`` names.

The planes, wired into one sweep in the reference's order: the burst
inner loop's 1 s harvest (``burst_hz``, :mod:`tpumon_torch.burst`) is
laid over the snapshot first; then the anomaly engine (``rules``,
:mod:`tpumon_torch.anomaly`) scores it, draining the kernel-log lines
:meth:`TpuExporter.anomaly_kmsg` queued; then the flight recorder
(``blackbox_dir``, :mod:`tpumon_torch.blackbox`) tees the snapshot and
its findings; then the live stream (:meth:`TpuExporter.
set_stream_publisher`, :mod:`tpumon_torch.frameserver`) tees the same
snapshot and findings to its subscribers.  A plane that cannot start
fails the constructor.

Not ported yet, and refused when asked for: the modeled per-link ICI
split (ROADMAP.md, Queue 1, item 7).  There is no native codec: the
render is the pure-Python path (``tpumon_codec_native 0``).

Importing this module, and running the daemon over the NVML backend,
never imports ``torch``.
"""

from __future__ import annotations

import gzip
import os
import queue
import re
import stat
import threading
import time
from typing import (Any, Callable, Dict, List, Mapping, Optional, Sequence,
                    Set, Tuple)

from .. import fields as FF
from .. import log
from ..backends.base import FieldValue
from ..httputil import TextHTTPServer, accepts_gzip
from ..introspect import SelfMonitor
from .promtext import (SweepRenderer, atomic_write, render_family,
                       render_family_samples)

F = FF.F

DEFAULT_OUTPUT = "/run/prometheus/tpu.prom"
DEFAULT_PORT = 9400
#: the reference floors its interval at 100 ms (dcgm-exporter:32); one
#: process and one read per sweep leave 10x headroom
MIN_INTERVAL_MS = 10


def select_chips(all_chips: Sequence[int],
                 node_name: Optional[str] = None,
                 env: Optional[Mapping[str, str]] = None) -> List[int]:
    """Per-node chip-index selection (dcgm-exporter:52-78 semantics).

    Order of precedence: ``TPUMON_CHIPS_<NODE>`` (NODE = NODE_NAME with
    non-alphanumerics mapped to ``_``, uppercased), then ``TPUMON_CHIPS``,
    else all chips.  Value: comma-separated indices.
    """

    env = env if env is not None else os.environ
    node = node_name if node_name is not None else env.get("NODE_NAME", "")
    keys = []
    if node:
        keys.append("TPUMON_CHIPS_" + re.sub(r"[^A-Za-z0-9]", "_", node).upper())
    keys.append("TPUMON_CHIPS")
    for key in keys:
        raw = env.get(key)
        if raw is None or raw.strip() == "":
            continue
        picked = []
        dropped = []
        for part in raw.split(","):
            part = part.strip()
            if not part:
                continue  # stray comma, not a typo
            if part.isdigit() and int(part) in all_chips:
                picked.append(int(part))
            else:
                dropped.append(part)
        if dropped:
            log.warn_every(
                "exporter.chips", 30.0,
                "%s entries %s dropped (not known chip indices; "
                "known: %s)", key, dropped, sorted(all_chips))
        return picked
    return list(all_chips)


#: the modeled per-link ICI split waits for NCCL attribution
MODELED_LINKS_ITEM = "ROADMAP.md, Queue 1, item 7"


class TpuExporter:
    """Owns the watch, the sweep loop, and the rendered output."""

    def __init__(self, handle, *,
                 interval_ms: int = 1000,
                 profiling: bool = False,
                 dcn: bool = False,
                 field_ids: Optional[Sequence[int]] = None,
                 output_path: Optional[str] = DEFAULT_OUTPUT,
                 chips: Optional[Sequence[int]] = None,
                 clock: Optional[Callable[[], float]] = None,
                 merge_globs: Optional[Sequence[str]] = None,
                 merge_max_age_s: float = 60.0,
                 burst: bool = False,
                 burst_hz: int = 0,
                 ici_per_link_modeled: bool = False,
                 blackbox_dir: Optional[str] = None,
                 blackbox_max_bytes: Optional[int] = None,
                 rules: Optional[Any] = None) -> None:
        """``field_ids`` overrides the canned family sets entirely (the
        ``dcgmi dmon -e`` analog).  ``output_path``: textfile to publish
        every sweep to (atomic rename), or None.

        ``merge_globs``: textfile-collector role — merge fresh ``*.prom``
        files (a workload's embedded self-monitor output) into every
        sweep, so the out-of-band daemon serves the workload's measured
        in-process families without touching the device.  Files older
        than ``merge_max_age_s`` are skipped, and series/HELP duplicates
        resolve in favor of the exporter's own output.

        ``burst``/``burst_hz``: the burst-derived 1 s min/max/mean/
        integral families; ``burst_hz > 0`` starts the inner loop
        (:class:`tpumon_torch.burst.BurstSampler`) over the backend.
        ``blackbox_dir``: tee every sweep into the flight recorder there
        (``blackbox_max_bytes`` its disk budget).  ``rules`` (a
        :class:`tpumon_torch.anomaly.Rules`): score every sweep's
        changed values on the sweep thread; findings surface as the
        ``tpumon_anomaly_*``/``tpumon_incident_*`` families and as 0xB3
        records in the recorder."""

        if ici_per_link_modeled:
            raise NotImplementedError(
                "exporter option 'ici_per_link_modeled' is not ported to "
                f"tpumon_torch yet ({MODELED_LINKS_ITEM})")
        if interval_ms < MIN_INTERVAL_MS:
            raise ValueError(
                f"interval {interval_ms} ms below the {MIN_INTERVAL_MS} ms "
                f"floor (dcgm-exporter:32 contract)")
        self.handle = handle
        self.interval_ms = interval_ms
        self.output_path = output_path
        self._clock = clock or time.time

        if field_ids is not None:
            unknown = [f for f in field_ids if int(f) not in FF.CATALOG]
            if unknown:
                raise ValueError(f"unknown field ids: {unknown}")
            field_ids = [int(f) for f in field_ids]
        else:
            field_ids = list(FF.EXPORTER_BASE_FIELDS)
            if profiling:
                field_ids += FF.EXPORTER_PROFILING_FIELDS
            if dcn:
                field_ids += FF.EXPORTER_DCN_FIELDS
            if burst or burst_hz > 0:
                # burst add-on: the derived 1 s min/max/mean/integral
                # families ride the normal sweep
                field_ids += FF.EXPORTER_BURST_FIELDS
        self.field_ids = field_ids
        self._fid_set = frozenset(int(f) for f in field_ids)

        all_chips = handle.supported_chips()
        self.chips = list(chips) if chips is not None else select_chips(all_chips)
        self.renderer = SweepRenderer(field_ids)

        # static labels gathered once (the uuid map of byUuids.go:13-29)
        self._labels: Dict[int, Dict[str, str]] = {}
        for c in self.chips:
            info = handle.chip_info(c)
            self._labels[c] = {"chip": str(c), "uuid": info.uuid,
                               "model": info.name}

        self._fg = handle.watches.create_field_group(field_ids, "exporter")
        self._cg = handle.watches.create_chip_group(self.chips, "exporter")
        # the exporter only renders the latest sample: cap each series at
        # 2 (latest + one predecessor) instead of age-bounded history
        handle.watches.watch_fields(self._cg, self._fg,
                                    update_freq_us=interval_ms * 1000,
                                    max_keep_samples=2)

        # flight recorder: tee every sweep's delta frame to bounded
        # on-disk segments
        self.blackbox = None  # acquired at the END of __init__
        # burst sampling: a 50-100 Hz thread folding the cheap-counter
        # subset into windowed accumulators, harvested once per second
        # by the sweep and laid over the snapshot (so the derived fields
        # ride the renderer and recorder tees like any field)
        self._burst_sampler = None  # acquired at the END of __init__
        # streaming subscription plane: when a publisher is installed,
        # every sweep's delta frame is teed to N live subscribers — one
        # encode, N sends (set_stream_publisher)
        self._stream = None
        self._burst_stats: Optional[Dict[str, float]] = None
        self._burst_stats_ts = 0.0
        # streaming anomaly detection: scored on the sweep thread
        # (single-owner engine); kmsg lines arrive from the watcher
        # thread via a Queue and are drained HERE, so no engine state is
        # ever touched cross-thread
        self.anomaly = None
        self._anomaly_kmsg_q: "queue.Queue[Tuple[str, float]]" = \
            queue.Queue(maxsize=1024)
        self.last_findings: List[Any] = []
        if rules is not None:
            from ..anomaly import AnomalyEngine
            # the backend's GPU bus map: kmsg evidence names the card
            self.anomaly = AnomalyEngine(rules, handle.backend.bus_index())

        self._merge_globs = list(merge_globs or [])
        self._merge_max_age = merge_max_age_s
        self._merge_files = 0
        self._merge_series = 0
        self._merged_families: Set[str] = set()
        self._self_mon = SelfMonitor()
        self._host_label = f'host="{os.uname().nodename}"'
        self._not_idle_since: Dict[int, Optional[float]] = {}
        #: drop-file parse cache: path -> ((mtime_ns, size, inode),
        #: parsed entries) — an unchanged workload drop file costs a
        #: stat per sweep, not a re-parse
        self._merge_cache: Dict[str, Tuple[Tuple[int, int, int],
                                           List[tuple]]] = {}
        self._lock = threading.Lock()
        self._last_bytes = b""
        #: gzip variant of the published body, compressed at most once
        #: per sweep, lazily on the first Accept-Encoding: gzip scrape
        self._last_gzip: Optional[bytes] = None
        self._gzip_bytes = 0
        self._gzip_compress_lock = threading.Lock()
        self._sweep_count = 0
        self._last_success_monotonic: Optional[float] = None
        self._last_sweep_duration = 0.0
        #: previous sweep's per-phase wall seconds
        self._last_phases: Dict[str, float] = {}
        self._enricher: Optional[Callable[[str], str]] = None
        self._attributor = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

        # the two OS resources this constructor owns — the flight
        # recorder's open segment and the burst inner-loop thread — are
        # acquired LAST: everything above is passive state, and a raise
        # in the burst wiring releases the already-open recorder
        if blackbox_dir:
            from ..blackbox import DEFAULT_MAX_BYTES, BlackBoxWriter
            try:
                self.blackbox = BlackBoxWriter(
                    blackbox_dir,
                    max_bytes=blackbox_max_bytes or DEFAULT_MAX_BYTES)
            except OSError as e:
                # an operator asking for a black box must not silently
                # run without one
                raise ValueError(
                    f"blackbox dir {blackbox_dir!r} unusable: {e}"
                ) from e
        try:
            if burst_hz > 0:
                self._start_burst(handle, burst_hz)
        except BaseException:
            bb, self.blackbox = self.blackbox, None
            if bb is not None:
                bb.close()
            raise

    def _start_burst(self, handle, burst_hz: int) -> None:
        """Start the inner loop (:class:`tpumon_torch.burst.BurstSampler`)
        over the backend's ``read_burst_fields``.  Its first read runs
        here, so a backend that refuses the loop (one whose read would
        multiply its device work by the inner rate) fails the start."""

        from ..burst import BurstSampler

        read = handle.backend.read_burst_fields
        burst_reqs = [(c, list(FF.BURST_SOURCE_FIELDS)) for c in self.chips]
        read(burst_reqs)

        def _burst_sample() -> Dict[int, Dict[int, FieldValue]]:
            return dict(read(burst_reqs))

        self._burst_sampler = BurstSampler(_burst_sample, burst_hz)
        self._burst_sampler.start()

    # -- pod-attribution hook (exporter/pod_attrib.py) -----------------------

    def set_enricher(self, fn: Optional[Callable[[str], str]]) -> None:
        """Install a text transformer applied to each sweep (label
        splicing).  Escape hatch for arbitrary rewrites; for pod
        attribution prefer :meth:`set_pod_attributor`, which splices at
        the label level so the renderer's per-chip label caches keep
        working."""

        self._enricher = fn

    def set_pod_attributor(self, attributor) -> None:
        """Label-level pod attribution: merge ``{pod_name, pod_namespace,
        container_name}`` into each chip's label set per sweep.  The
        attributor's device map is cached for ``attributor.refresh_s``;
        the renderer's label caches are invalidated only when a chip's
        pod mapping actually changes."""

        self._attributor = attributor

    def set_stream_publisher(self, publisher) -> None:
        """Install a live-stream publisher (:class:`tpumon_torch.
        frameserver.StreamPublisher`): every sweep is teed to its
        subscribers as already-encoded ``sweep_frame`` delta bytes —
        keyframe on attach, bounded per-subscriber buffers,
        drop-to-keyframe on slow readers.  The tee costs one delta-table
        pass per sweep (the flight recorder's bill), independent of the
        subscriber count."""

        self._stream = publisher

    def anomaly_kmsg(self, line: str, ts: float) -> bool:
        """Queue one kernel-log line for the detection plane (any
        thread — the KmsgWatcher sink calls this from the tailer
        thread; the sweep thread drains the queue).

        Returns True when the line was queued: the sweep thread then
        owns BOTH scoring and recording it, so the black box's record
        order matches the live engine's processing order exactly (what
        lets a backtest re-derive identical verdicts).  False (engine
        off, or a full queue) means the caller should record the line
        itself."""

        if self.anomaly is None:
            return False
        try:
            self._anomaly_kmsg_q.put_nowait((line, ts))
            return True
        except queue.Full:
            log.warn_every("exporter.anomaly.kmsgq", 60.0,
                           "anomaly kmsg queue full; line dropped")
            return False

    def _apply_pod_labels(self) -> None:
        attributor = self._attributor
        if attributor is None:
            return
        try:
            mapping = attributor.device_map()
        except Exception as e:
            log.warn_every("exporter.podmap", 30.0,
                           "pod device map refresh failed: %r", e)
            return
        for c in self.chips:
            base = self._labels[c]
            info = attributor.lookup(mapping, base.get("uuid", ""),
                                     str(c)) if mapping else None
            want_keys = ("pod_name", "pod_namespace", "container_name")
            if info is None:
                if any(k in base for k in want_keys):
                    for k in want_keys:
                        base.pop(k, None)
                continue
            new = {"pod_name": info.pod, "pod_namespace": info.namespace,
                   "container_name": info.container}
            if any(base.get(k) != v for k, v in new.items()):
                base.update(new)

    # -- one sweep ------------------------------------------------------------

    def sweep(self, now: Optional[float] = None) -> str:
        """One sweep; returns the rendered exposition as ``str`` (tests,
        ``--oneshot``).  The sweep loop and the serve path use
        :meth:`sweep_bytes` / :meth:`payload` and never pay this
        decode."""

        return self.sweep_bytes(now).decode("utf-8")

    def sweep_bytes(self, now: Optional[float] = None) -> bytes:
        t0 = time.monotonic()
        t = now if now is not None else self._clock()
        snapshot = self.handle.watches.update_all(wait=True, now=now)
        phases = {}  # phase name -> seconds, published with one-sweep lag

        per_chip: Dict[int, Mapping[int, FieldValue]] = {}
        fid_set = self._fid_set
        nit = int(F.NOT_IDLE_TIME)
        for c in self.chips:
            snap = snapshot.get(c)
            if snap is not None and fid_set.issubset(snap.keys()):
                vals = snap
            else:
                # partial or missing chip: fall back to the series cache,
                # which retains the last known value per field
                vals = self.handle.watches.latest_values(
                    c, self.field_ids)
            # awk-style notIdleTimes state when the backend lacks field
            # 208 — copy-on-write, the common case costs no copy
            if nit in vals and vals[nit] is None:
                util = vals.get(int(F.TENSORCORE_UTIL))
                last = self._not_idle_since.get(c)
                if util is not None and util > 0:
                    self._not_idle_since[c] = t
                    vals = dict(vals)
                    vals[nit] = 0
                elif last is not None:
                    vals = dict(vals)
                    vals[nit] = int(t - last)
            per_chip[c] = vals

        if self._burst_sampler is not None:
            # lay the 1 s burst harvest over the snapshot BEFORE the
            # tees so the derived fields ride every downstream plane;
            # copy-on-write per chip (the snapshot is read-only).  The
            # window gate uses the injected clock.
            for c, bvals in self._burst_sampler.harvest_if_due(
                    now=t).items():
                base = per_chip.get(c)
                if base is not None:
                    merged = dict(base)
                    merged.update(bvals)
                    per_chip[c] = merged
        # refreshed at most 1 Hz, on the injected clock
        if t - self._burst_stats_ts >= 1.0:
            self._burst_stats = (self._burst_sampler.stats()
                                 if self._burst_sampler is not None
                                 else None)
            self._burst_stats_ts = t
        # inside the timed region: a kubelet refresh stalling the sweep
        # must show in scrape_duration
        self._apply_pod_labels()
        t1 = time.monotonic()
        phases["collect"] = t1 - t0
        findings: List[Any] = []
        if self.anomaly is not None:
            # detection BEFORE the tee: this sweep's findings ride this
            # sweep's recorder segment.  Kmsg lines queued by the
            # watcher thread drain here, on the sweep thread.
            try:
                while True:
                    try:
                        line, k_ts = self._anomaly_kmsg_q.get_nowait()
                    except queue.Empty:
                        break
                    if self.blackbox is not None:
                        # recorded HERE, in drain order, so the on-disk
                        # sequence is exactly the sequence the live
                        # engine scored (backtest identity)
                        self.blackbox.record_kmsg(line, now=k_ts)
                    findings += self.anomaly.observe_kmsg(line, k_ts)
                findings += self.anomaly.observe(per_chip, now=t)
            except Exception as e:
                # a broken detector must never cost the metric stream
                log.warn_every("exporter.anomaly", 30.0,
                               "anomaly engine failed: %r", e)
            if findings:
                self.last_findings = findings
            t1a = time.monotonic()
            phases["anomaly"] = t1a - t1
            t1 = t1a
        if self.blackbox is not None:
            # tee the sweep into the flight recorder, stamped with the
            # sweep's wall time so replay lines up with Prometheus.
            # Failure degrades the RECORDER, never the metric stream.
            try:
                self.blackbox.record_sweep(per_chip, now=t)
                for rec in findings:
                    # 0xB3 verdicts beside the frame they scored
                    self.blackbox.record_finding(rec)
            except Exception as e:
                log.warn_every("exporter.blackbox", 30.0,
                               "flight recorder tee failed: %r", e)
            t1b = time.monotonic()
            phases["record"] = t1b - t1
            t1 = t1b
        if self._stream is not None:
            # tee the sweep to live subscribers: the frame is encoded
            # ONCE against the publisher's delta table and fanned out
            # as bytes; a slow subscriber is the frameserver's problem
            # (bounded buffer, drop-to-keyframe), never this loop's
            try:
                self._stream.publish(per_chip, now=t)
                if findings:
                    from ..blackbox import encode_finding
                    for rec in findings:
                        self._stream.publish_record(
                            encode_finding(rec))
            except Exception as e:
                log.warn_every("exporter.stream", 30.0,
                               "stream tee failed: %r", e)
            t1s = time.monotonic()
            phases["stream"] = t1s - t1
            t1 = t1s

        extra = self._self_metrics()
        if self._enricher is None:
            # hot path: delta-aware bytes render; the merge works from
            # the renderer's series index instead of re-parsing the text
            parts = self.renderer.render_parts(per_chip, self._labels)
            if self._merge_globs:
                t2 = time.monotonic()
                phases["render"] = t2 - t1
                body = self._merge_textfiles_parts(parts, extra, t)
            else:
                # body assembly is render work: compose is booked under
                # the render phase
                body = self.renderer.compose(parts, extra)
                t2 = time.monotonic()
                phases["render"] = t2 - t1
        else:
            # enricher escape hatch (arbitrary text rewrites): the
            # renderer's incremental index cannot survive a text-level
            # transform, so this path runs the full oracle renderer
            text = self.renderer.render(per_chip, self._labels,
                                        extra_lines=extra)
            try:
                text = self._enricher(text)
            except Exception as e:
                # attribution failure must not break the metric stream
                log.warn_every("exporter.enrich", 30.0,
                               "pod attribution failed; serving "
                               "unenriched metrics: %r", e)
            t2 = time.monotonic()
            phases["render"] = t2 - t1
            if self._merge_globs:
                text = self._merge_textfiles(text, t)
            body = text.encode("utf-8")
        t3 = time.monotonic()
        phases["merge"] = t3 - t2
        if self.output_path:
            atomic_write(self.output_path, body)
        with self._lock:
            self._last_bytes = body
            self._last_gzip = None  # next gzip scrape recompresses once
            self._gzip_bytes = 0    # gauge covers THIS sweep's variant
            self._sweep_count += 1
            self._last_success_monotonic = time.monotonic()
        phases["publish"] = time.monotonic() - t3
        # full-pipeline duration, served with one-sweep lag: a slow merge
        # or a stalling output filesystem shows in the very self-metric
        # operators alert on, so the capture happens last
        self._last_sweep_duration = time.monotonic() - t0
        self._last_phases = phases
        return body

    # -- textfile merge (node-exporter textfile-collector role) ---------------

    _VALUE_RE = re.compile(
        r"^[+-]?(?:Inf|NaN|[0-9]*\.?[0-9]+(?:[eE][+-]?[0-9]+)?)$")
    _TS_RE = re.compile(r"^[+-]?[0-9]+$")

    @classmethod
    def _parse_sample(cls, ln: str) -> Optional[str]:
        """Validate one exposition sample line -> its series identity
        (name + label set), or None if malformed.

        Quote-aware: label values may legally contain ``{``/``}``/spaces,
        so the label section ends at the first unquoted ``}``.  Torn
        writes and garbage return None and are dropped per line — one
        bad file must not poison the whole scrape."""

        n = len(ln)
        if not n or not (ln[0].isalpha() or ln[0] in "_:"):
            return None
        i = 1
        while i < n and (ln[i].isalnum() or ln[i] in "_:"):
            i += 1
        sid_end = i
        if i < n and ln[i] == "{":
            i += 1
            in_q = False
            esc = False
            while i < n:
                c = ln[i]
                if esc:
                    esc = False
                elif c == "\\":
                    esc = True
                elif c == '"':
                    in_q = not in_q
                elif c == "}" and not in_q:
                    break
                i += 1
            if i >= n:
                return None  # unterminated label set (torn write)
            i += 1
            sid_end = i
        if i >= n or ln[i] not in " \t":
            return None
        parts = ln[i:].split()
        if not parts or len(parts) > 2:
            return None
        if not cls._VALUE_RE.match(parts[0]):
            return None
        if len(parts) == 2 and not cls._TS_RE.match(parts[1]):
            return None
        return ln[:sid_end]

    @classmethod
    def _series_id(cls, line: str) -> str:
        """Series identity of a known-good sample line (base text)."""

        sid = cls._parse_sample(line)
        if sid is not None:
            return sid
        brace = line.find("}")
        if brace >= 0:
            return line[:brace + 1]
        return line.split(None, 1)[0]

    #: per-file byte cap for merged textfiles: the drop dir is
    #: workload-writable, and a multi-GB file must not be slurped whole
    #: into the sweep loop
    MERGE_MAX_BYTES = 4 << 20

    def _read_merge_file(self, path: str) -> Optional[str]:
        """Bounded, non-blocking read of one workload drop file.

        O_NONBLOCK so a FIFO cannot park the sweep loop in open(2),
        O_NOFOLLOW + S_ISREG so a symlink (to /dev/zero, say) is skipped,
        and a hard byte cap with the truncated tail cut at a line
        boundary.  Returns None when the file should be skipped."""

        flags = os.O_RDONLY | getattr(os, "O_NONBLOCK", 0) | \
            getattr(os, "O_NOFOLLOW", 0)
        fd = os.open(path, flags)
        try:
            st = os.fstat(fd)
            if not stat.S_ISREG(st.st_mode):
                log.warn_every("exporter.merge.notreg", 60.0,
                               "merge path %s is not a regular file "
                               "(mode %o); skipped", path, st.st_mode)
                return None
            chunks: List[bytes] = []
            remaining = self.MERGE_MAX_BYTES + 1
            while remaining > 0:
                chunk = os.read(fd, min(remaining, 1 << 20))
                if not chunk:
                    break
                chunks.append(chunk)
                remaining -= len(chunk)
            data = b"".join(chunks)
        finally:
            os.close(fd)
        if len(data) > self.MERGE_MAX_BYTES:
            cut = data.rfind(b"\n", 0, self.MERGE_MAX_BYTES)
            data = data[:cut + 1 if cut >= 0 else 0]
            log.warn_every("exporter.merge.truncated", 60.0,
                           "merge textfile %s exceeds %d bytes; "
                           "truncated", path, self.MERGE_MAX_BYTES)
        return data.decode("utf-8", "replace")

    @classmethod
    def _parse_merge_content(cls, content: str) -> List[tuple]:
        """Classify one drop file's lines once; the result is cached on
        the file's stat signature.

        Entry shapes: ``("m", kind, family, line)`` HELP/TYPE metadata,
        ``("c", line)`` other comment, ``("s", sid, family, line)``
        valid sample, ``("x",)`` malformed (counted as dropped when
        applied)."""

        entries: List[tuple] = []
        for ln in content.splitlines():
            if ln.startswith("#"):
                parts = ln.split(None, 3)
                if len(parts) >= 3 and parts[1] in ("HELP", "TYPE"):
                    entries.append(("m", parts[1], parts[2], ln))
                else:
                    entries.append(("c", ln))
                continue
            if not ln.strip():
                continue
            sid = cls._parse_sample(ln)
            if sid is None:
                entries.append(("x",))
                continue
            entries.append(("s", sid, sid.split("{", 1)[0], ln))
        return entries

    def _load_merge_files(self, now: float) -> Tuple[int, List[List[tuple]]]:
        """Fresh drop files' parsed entries, with the parse cached on
        ``(path, mtime_ns, size, inode)``."""

        import glob as _glob

        files = 0
        out: List[List[tuple]] = []
        seen_paths: Set[str] = set()
        for pattern in self._merge_globs:
            for path in sorted(_glob.glob(pattern)):
                if self.output_path and \
                        os.path.abspath(path) == os.path.abspath(
                            self.output_path):
                    continue  # never merge our own output back in
                try:
                    st = os.stat(path, follow_symlinks=False)
                    if not stat.S_ISREG(st.st_mode):
                        # FIFO/symlink planted in the workload-writable
                        # drop dir: never even open it
                        log.warn_every("exporter.merge.notreg", 60.0,
                                       "merge path %s is not a regular "
                                       "file (mode %o); skipped",
                                       path, st.st_mode)
                        continue
                    age = now - st.st_mtime
                    if age > self._merge_max_age:
                        log.warn_every("exporter.merge.stale", 60.0,
                                       "stale textfile %s (%.0fs old) "
                                       "skipped", path, age)
                        continue
                    sig = (st.st_mtime_ns, st.st_size, st.st_ino)
                    cached = self._merge_cache.get(path)
                    if cached is not None and cached[0] == sig:
                        entries = cached[1]
                    else:
                        content = self._read_merge_file(path)
                        if content is None:
                            continue
                        entries = self._parse_merge_content(content)
                        self._merge_cache[path] = (sig, entries)
                except OSError as e:
                    log.warn_every("exporter.merge.read", 60.0,
                                   "merge textfile %s unreadable: %r",
                                   path, e)
                    continue
                seen_paths.add(path)
                files += 1
                out.append(entries)
        # evict entries whose file left the glob (pod churn names drop
        # files by pod UID — the cache must not grow without bound)
        for path in [p for p in self._merge_cache if p not in seen_paths]:
            del self._merge_cache[path]
        return files, out

    def _apply_merge(self, series: Set[str], decl: Set[str],
                     files_entries: List[List[tuple]],
                     ) -> Tuple[Dict[str, List[str]], List[str]]:
        """Dedup parsed drop-file entries against the base exposition's
        series/family index.  Returns ``(by_family, tail_lines)``:
        merged samples joining a family the base already emits land
        inside that family's block; everything else appends."""

        by_family: Dict[str, List[str]] = {}
        tail_lines: List[str] = []
        seen_meta: Set[Tuple[str, str]] = set()  # (kind, family)
        merged_fams: Set[str] = set()
        merged = 0
        dropped = 0
        for entries in files_entries:
            for e in entries:
                kind = e[0]
                if kind == "s":
                    _, sid, fam, ln = e
                    if sid in series:
                        continue  # exporter's own sample wins
                    series.add(sid)
                    merged += 1
                    merged_fams.add(fam)
                    if fam in decl:
                        by_family.setdefault(fam, []).append(ln)
                    else:
                        tail_lines.append(ln)
                elif kind == "m":
                    # a family the base text already declared or sampled
                    # keeps ITS metadata; across merged files the first
                    # (kind, family) wins
                    _, mkind, fam, ln = e
                    key = (mkind, fam)
                    if fam in decl or key in seen_meta:
                        continue
                    seen_meta.add(key)
                    tail_lines.append(ln)
                elif kind == "c":
                    tail_lines.append(e[1])
                else:
                    dropped += 1
        if dropped:
            log.warn_every("exporter.merge.malformed", 60.0,
                           "%d malformed merge line(s) dropped "
                           "(non-atomic writer?)", dropped)
        self._merge_series = merged
        self._merged_families = merged_fams
        return by_family, tail_lines

    def _merge_textfiles(self, text: str, now: float) -> str:
        """Full-text merge (enricher fallback): the base index is
        re-parsed from the rendered text because an enricher may have
        rewritten it arbitrarily."""

        series: Set[str] = set()
        decl: Set[str] = set()  # families declared OR sampled by base
        for ln in text.splitlines():
            if ln.startswith("#"):
                parts = ln.split(None, 3)
                if len(parts) >= 3 and parts[1] in ("HELP", "TYPE"):
                    decl.add(parts[2])
            elif ln.strip():
                sid = self._series_id(ln)
                series.add(sid)
                decl.add(sid.split("{", 1)[0])
        files, fe = self._load_merge_files(now)
        by_family, tail_lines = self._apply_merge(series, decl, fe)
        # reported via self-metrics with one-sweep lag
        self._merge_files = files
        if not by_family and not tail_lines:
            return text
        out = self._splice_by_family(text, by_family) if by_family else text
        if tail_lines:
            out = out + "\n".join(tail_lines) + "\n"
        return out

    def _merge_textfiles_parts(self, parts: List[Tuple[str, bytes]],
                               extra_lines: Sequence[str],
                               now: float) -> bytes:
        """Merge against the renderer's incremental series index — no
        re-parse of the exporter's own exposition; only the per-sweep
        extra-line block is indexed by line walk."""

        files, fe = self._load_merge_files(now)
        if not fe:
            # quiet drop dir: merge nothing, pay no index copy
            self._merge_files, self._merge_series = files, 0
            self._merged_families = set()
            return self.renderer.compose(parts, extra_lines)
        series = set(self.renderer.series_set)
        decl = {fam for fam, _ in parts}
        for ln in extra_lines:
            if ln.startswith("#"):
                p = ln.split(None, 3)
                if len(p) >= 3 and p[1] in ("HELP", "TYPE"):
                    decl.add(p[2])
            elif ln.strip():
                sid = self._series_id(ln)
                series.add(sid)
                decl.add(sid.split("{", 1)[0])
        by_family, tail_lines = self._apply_merge(series, decl, fe)
        self._merge_files = files
        if not by_family and not tail_lines:
            return self.renderer.compose(parts, extra_lines)
        segs: List[bytes] = []
        for fam, block in parts:
            segs.append(block)
            joined = by_family.pop(fam, None)
            if joined:
                segs.append("\n".join(joined).encode("utf-8"))
        # merged samples joining an extra-line family (plus families
        # declared but never sampled) splice inside the extra block,
        # exactly where the full-text walk would put them
        extra_out = list(extra_lines)
        if by_family:
            extra_out = self._splice_lines(extra_out, by_family)
        if extra_out:
            segs.append("\n".join(extra_out).encode("utf-8"))
        if tail_lines:
            segs.append("\n".join(tail_lines).encode("utf-8"))
        return b"\n".join(segs) + b"\n"

    def _splice_lines(self, lines: List[str],
                      by_family: Dict[str, List[str]]) -> List[str]:
        """Insert merged samples at the close of their family's block in
        a line list, keeping each sample group contiguous; families the
        base declared but never sampled this sweep append at the end.
        Consumes ``by_family``."""

        out: List[str] = []
        cur_fam: Optional[str] = None

        def close_family() -> None:
            nonlocal cur_fam
            if cur_fam is not None and cur_fam in by_family:
                out.extend(by_family.pop(cur_fam))
            cur_fam = None

        for ln in lines:
            fam: Optional[str] = None
            if ln.startswith("#"):
                parts = ln.split(None, 3)
                if len(parts) >= 3 and parts[1] in ("HELP", "TYPE"):
                    fam = parts[2]
            elif ln.strip():
                fam = self._series_id(ln).split("{", 1)[0]
            if fam is not None and fam != cur_fam:
                close_family()
                cur_fam = fam
            out.append(ln)
        close_family()
        for rest in by_family.values():
            out.extend(rest)
        by_family.clear()
        return out

    def _splice_by_family(self, text: str,
                          by_family: Dict[str, List[str]]) -> str:
        """Full-text splice (enricher fallback path)."""

        return "\n".join(self._splice_lines(text.splitlines(),
                                            by_family)) + "\n"

    def _self_metrics(self) -> List[str]:
        st = self._self_mon.status()
        lbl = self._host_label
        rf = render_family
        lines: List[str] = []
        # backend-provided self families, under the same host label;
        # failure must not cost the sweep
        hook = getattr(self.handle.backend, "self_metric_lines", None)
        if callable(hook):
            try:
                lines += list(hook(lbl))
            except Exception as e:
                log.warn_every("exporter.selfhook", 60.0,
                               "backend self-metrics hook failed: %r", e)
        lines += rf("tpumon_exporter_scrape_duration_seconds", "gauge",
                    "Wall time of the previous full sweep "
                    "(collect+render+merge+publish).",
                    lbl, self._last_sweep_duration, fmt=".6f")
        if self._last_phases:
            lines.append("# HELP tpumon_exporter_sweep_phase_seconds Wall "
                         "time of each phase of the previous sweep.")
            lines.append("# TYPE tpumon_exporter_sweep_phase_seconds gauge")
            for ph in ("collect", "anomaly", "record", "stream",
                       "render", "merge", "publish"):
                if ph in self._last_phases:
                    lines.append(
                        "tpumon_exporter_sweep_phase_seconds{%s,phase=\"%s\"}"
                        " %.6f" % (lbl, ph, self._last_phases[ph]))
        lines += rf("tpumon_exporter_cpu_percent", "gauge",
                    "Exporter process CPU percent over the last window.",
                    lbl, st.cpu_percent)
        lines += rf("tpumon_exporter_memory_kb", "gauge",
                    "Exporter process RSS in KB.",
                    lbl, st.memory_kb, fmt=".0f")
        lines += rf("tpumon_exporter_sweeps_total", "counter",
                    "Sweeps completed since start.",
                    lbl, self._sweep_count, fmt=".0f")
        lines += rf("tpumon_exporter_metrics_per_chip", "gauge",
                    "Metric families emitted per chip.",
                    lbl, len(self.renderer.field_ids), fmt=".0f")
        lines += rf("tpumon_codec_native", "gauge",
                    "1 when the native codec extension backs the "
                    "sweep-frame/burst codecs, 0 on the pure-Python "
                    "reference.",
                    lbl, 0.0, fmt=".0f")
        ratio = self.renderer.last_hit_ratio
        if ratio is not None:
            lines += rf("tpumon_exporter_render_cache_hit_ratio", "gauge",
                        "Fraction of sample lines reused from the "
                        "render line cache in the previous sweep "
                        "(1.0 = no value changed).",
                        lbl, ratio, fmt=".4f")
        # the flight recorder's write/retention counters: is the black
        # box recording, and how fast is it burning its budget
        if self.blackbox is not None:
            bb = self.blackbox.stats()
            lines += rf("tpumon_blackbox_bytes_written_total", "counter",
                        "Bytes appended to flight-recorder segments "
                        "since start.",
                        lbl, bb["bytes_written_total"], fmt=".0f")
            lines += rf("tpumon_blackbox_frames_total", "counter",
                        "Sweep frames recorded since start.",
                        lbl, bb["frames_total"], fmt=".0f")
            lines += rf("tpumon_blackbox_segments", "gauge",
                        "Flight-recorder segment files currently on "
                        "disk.",
                        lbl, bb["segments"], fmt=".0f")
            lines += rf("tpumon_blackbox_segments_reclaimed_total",
                        "counter",
                        "Oldest-first segment reclamations under the "
                        "disk budget since start.",
                        lbl, bb["segments_reclaimed_total"], fmt=".0f")
            lines += rf("tpumon_blackbox_write_errors_total", "counter",
                        "Recorder write failures (segment dropped, "
                        "recording continued) since start.",
                        lbl, bb["write_errors_total"], fmt=".0f")
            lines += rf("tpumon_blackbox_records_dropped_total",
                        "counter",
                        "Records dropped while the recorder was "
                        "degraded by a failing disk (counted, never "
                        "raised into the sweep) since start.",
                        lbl, bb["records_dropped_total"], fmt=".0f")
        # detection-plane families, emitted from the one registration
        # (anomaly.METRIC_FAMILIES)
        if self.anomaly is not None:
            from ..anomaly import METRIC_FAMILIES
            st_a = self.anomaly.stats()
            per_rule: Dict[str, Dict[str, int]] = {
                "tpumon_anomaly_findings_total": st_a["findings_total"],
                "tpumon_anomaly_cleared_total": st_a["cleared_total"],
                "tpumon_anomaly_active": st_a["active"],
                "tpumon_incident_findings_total":
                    st_a["incidents_total"],
                "tpumon_incident_suppressed_total":
                    st_a["suppressed_total"],
            }
            scalar = {
                "tpumon_anomaly_series_tracked": st_a["series_tracked"],
                "tpumon_anomaly_scored_total": st_a["scored_total"],
            }
            for fam, ptype, help_txt in METRIC_FAMILIES:
                rules_map = per_rule.get(fam)
                if rules_map is not None:
                    samples = [(f'{lbl},rule="{r}"', float(n))
                               for r, n in sorted(rules_map.items())]
                    if samples:
                        lines += render_family_samples(
                            fam, ptype, help_txt, samples, fmt=".0f")
                else:
                    lines += render_family(fam, ptype, help_txt, lbl,
                                           float(scalar[fam]),
                                           fmt=".0f")
        # fan-out-plane twin of the blackbox block: is anyone attached
        # to the live stream, how much is the tee pushing, and is
        # backpressure biting (drops/resyncs) — answerable from the
        # same scrape that shows the render cache and the recorder
        if self._stream is not None:
            ss = self._stream.stats()
            lines += rf("tpumon_stream_subscribers", "gauge",
                        "Live stream subscribers currently attached.",
                        lbl, ss["subscribers"], fmt=".0f")
            lines += rf("tpumon_stream_subscribers_total", "counter",
                        "Stream subscribers ever attached since start.",
                        lbl, ss["subscribers_total"], fmt=".0f")
            lines += rf("tpumon_stream_frames_sent_total", "counter",
                        "Stream frames (deltas + keyframes) queued to "
                        "subscribers since start.",
                        lbl, ss["frames_sent_total"], fmt=".0f")
            lines += rf("tpumon_stream_bytes_sent_total", "counter",
                        "Stream bytes queued to subscribers since "
                        "start.",
                        lbl, ss["bytes_sent_total"], fmt=".0f")
            lines += rf("tpumon_stream_keyframes_total", "counter",
                        "Keyframes sent (attaches + resyncs) since "
                        "start.",
                        lbl, ss["keyframes_total"], fmt=".0f")
            lines += rf("tpumon_stream_dropped_frames_total", "counter",
                        "Frames not queued to a stale (overflowed) "
                        "subscriber since start.",
                        lbl, ss["dropped_frames_total"], fmt=".0f")
            lines += rf("tpumon_stream_resyncs_total", "counter",
                        "Drop-to-keyframe recoveries of slow "
                        "subscribers since start.",
                        lbl, ss["resyncs_total"], fmt=".0f")
        # burst-loop health: overruns climbing because the source is
        # slower than the period show on the scrape
        if self._burst_stats:
            bs = self._burst_stats
            lines += rf("tpumon_agent_burst_rate_hz", "gauge",
                        "Configured burst inner-loop sampling rate.",
                        lbl, bs.get("burst_hz", 0.0), fmt=".0f")
            lines += rf("tpumon_agent_burst_overruns_total", "counter",
                        "Burst inner-loop periods missed (sampling "
                        "slower than the configured rate) since start.",
                        lbl, bs.get("burst_overruns", 0.0), fmt=".0f")
        with self._lock:
            nbytes = len(self._last_bytes)
            gzbytes = self._gzip_bytes
        if nbytes:
            lines += rf("tpumon_exporter_scrape_bytes", "gauge",
                        "Size of the previous sweep's exposition in "
                        "bytes (the buffer /metrics serves).",
                        lbl, nbytes, fmt=".0f")
            lines += rf("tpumon_exporter_scrape_gzip_bytes", "gauge",
                        "Size of the gzip variant served to "
                        "Accept-Encoding: gzip scrapers (0 until one "
                        "asks; compressed once per sweep).",
                        lbl, gzbytes, fmt=".0f")
        if self._merge_globs:
            lines += rf("tpumon_exporter_merged_files", "gauge",
                        "Fresh textfiles merged into the previous sweep.",
                        lbl, self._merge_files, fmt=".0f")
            lines += rf("tpumon_exporter_merged_series", "gauge",
                        "Sample series merged from textfiles in the "
                        "previous sweep.",
                        lbl, self._merge_series, fmt=".0f")
        return lines

    # -- loop -----------------------------------------------------------------

    def run_forever(self) -> None:
        interval = self.interval_ms / 1000.0
        while not self._stop.is_set():
            start = time.monotonic()
            try:
                self.sweep_bytes()
            except Exception as e:
                # transient source/filesystem failure: keep the cadence;
                # healthy() surfaces a persistent one, and the log says
                # what is failing (rate-limited)
                log.warn_every("exporter.sweep", 30.0,
                               "sweep failed: %r", e)
            elapsed = time.monotonic() - start
            self._stop.wait(max(0.0, interval - elapsed))

    def start(self) -> None:
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(target=self.run_forever,
                                            name="prometheus-tpu-sweep",
                                            daemon=True)
            self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        th, self._thread = self._thread, None
        # one raising member stop must not leak the members after it
        try:
            if th is not None:
                th.join(timeout=5.0)
        finally:
            if self._burst_sampler is not None:
                try:
                    self._burst_sampler.stop()
                except Exception as e:
                    log.warn_every("exporter.stop", 30.0,
                                   "burst sampler stop failed: %r", e)
            if self.blackbox is not None:
                try:
                    self.blackbox.close()
                except Exception as e:
                    log.warn_every("exporter.stop", 30.0,
                                   "flight recorder close failed: %r",
                                   e)

    # -- accessors ------------------------------------------------------------

    @property
    def last_text(self) -> str:
        """Last exposition as ``str`` (the serve path uses
        :meth:`payload` and never decodes)."""

        with self._lock:
            body = self._last_bytes
        return body.decode("utf-8")

    def payload(self, accept_gzip: bool = False,
                ) -> Tuple[bytes, Optional[str]]:
        """``(body, content_encoding)`` for ``/metrics`` — the published
        per-sweep buffer served as-is.  With ``accept_gzip`` the gzip
        variant is compressed lazily, at most once per sweep, and cached
        until the next publish."""

        with self._lock:
            body = self._last_bytes
            gz = self._last_gzip
            gen = self._sweep_count
        if not accept_gzip or not body:
            return body, None
        if gz is None:
            # serialize compressors so N concurrent first-gzip scrapes
            # cost one compress; the sweep lock is not held across it
            with self._gzip_compress_lock:
                with self._lock:
                    gz = self._last_gzip
                    body = self._last_bytes
                    gen = self._sweep_count
                if gz is None:
                    gz = gzip.compress(body, 6)
                    with self._lock:
                        if self._sweep_count == gen:
                            # a sweep that published mid-compress wins
                            self._last_gzip = gz
                            self._gzip_bytes = len(gz)
        return gz, "gzip"

    @property
    def sweep_count(self) -> int:
        with self._lock:
            return self._sweep_count

    def healthy(self) -> Tuple[bool, str]:
        """Readiness: at least one sweep, and the latest succeeded
        recently (a persistently failing sweep loop must not look
        healthy, or the DaemonSet never restarts a frozen exporter)."""

        with self._lock:
            count = self._sweep_count
            last = self._last_success_monotonic
        if count == 0 or last is None:
            return False, "no sweep yet"
        age = time.monotonic() - last
        if age > max(3.0 * self.interval_ms / 1000.0, 3.0):
            return False, f"last successful sweep {age:.1f}s ago"
        return True, "ok"


class MetricsHTTPServer(TextHTTPServer):
    """The /metrics endpoint: the exporter's published per-sweep buffer
    served directly, and a gzip variant (compressed once per sweep) when
    the scraper advertises ``Accept-Encoding: gzip``."""

    def __init__(self, exporter: TpuExporter, port: int = DEFAULT_PORT,
                 bind: str = "") -> None:
        def dispatch(path: str, headers: Mapping[str, str]):
            if path in ("/metrics", "/tpu/metrics"):
                ae = headers.get("Accept-Encoding", "") if headers else ""
                body, enc = exporter.payload(
                    accept_gzip=accepts_gzip(ae))
                extra = {"Vary": "Accept-Encoding"}
                if enc:
                    extra["Content-Encoding"] = enc
                return 200, "text/plain; version=0.0.4", body, extra
            if path == "/healthz":
                ok, reason = exporter.healthy()
                return (200 if ok else 503), "text/plain", reason
            return 404, "text/plain", "not found\n"

        super().__init__(dispatch, port=port, bind=bind)
