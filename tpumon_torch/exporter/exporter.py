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

``ici_per_link_modeled`` splits the measured NVLink aggregate (the
collective attribution) evenly over the card's NVLink peers, labeled
``source="modeled"``.  ``tpumon_codec_native`` says whether the port's
native codec extension backs the sweep-frame and burst codecs
(:mod:`tpumon_torch._codec`).

Importing this module, and running the daemon over the NVML backend,
never imports ``torch``.
"""

from __future__ import annotations

import gzip
import os
import queue
import re
import threading
import time
from typing import (Any, Callable, Dict, List, Mapping, Optional, Sequence,
                    Tuple)

from .. import _codec
from .. import fields as FF
from .. import log
from .. import spans
from ..backends.base import FieldValue
from ..httputil import TextHTTPServer, accepts_gzip
from ..introspect import SelfMonitor
from .promtext import (SweepRenderer, atomic_write, render_family,
                       render_family_samples)
from .textmerge import TextfileMerge, index_lines, splice_lines

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


#: the sweep's phases, in their order, as ``tpumon_exporter_sweep_phase_
#: seconds`` serves them: each a child span of the ``sweep`` root
SWEEP_PHASES = ("collect", "anomaly", "record", "stream", "render", "merge",
                "publish")
#: a served request's phases (:class:`MetricsHTTPServer`): each a child
#: span of its ``request`` root
REQUEST_PHASES = ("wait", "payload", "write")
#: the exporter's timing self-families: (type, help), by family name
SELF_FAMILIES = {
    "tpumon_exporter_sweep_phase_seconds": (
        "gauge", "Wall time of each phase of the previous sweep."),
    "tpumon_exporter_request_phase_seconds": (
        "gauge", "Wall time of each phase of the last /metrics request "
        "completed before the sweep that rendered this body: wait "
        "(accepted to handled: the thread, the interpreter lock, the "
        "headers), payload (the body, any gzip included), write (headers "
        "and body to the socket)."),
    "tpumon_exporter_requests_total": (
        "counter", "/metrics requests served since start."),
}


def phase_lines(family: str, lbl: str, secs: Mapping[str, float],
                phases: Sequence[str], prefix: str = "") -> List[str]:
    """A phase family's lines: one sample a phase present in ``secs``
    (keyed ``prefix + phase``), none at all without one."""

    present = [ph for ph in phases if prefix + ph in secs]
    if not present:
        return []
    ptype, help_txt = SELF_FAMILIES[family]
    return [f"# HELP {family} {help_txt}", f"# TYPE {family} {ptype}"] + [
        "%s{%s,phase=\"%s\"} %.6f" % (family, lbl, ph, secs[prefix + ph])
        for ph in present]


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

        # modeled split requires the per-link fields to be IN the sweep:
        # otherwise "real source exists but wasn't collected" would be
        # indistinguishable from "collected and blank", and synthesis
        # could shadow genuine hardware counters
        self._ici_modeled = bool(ici_per_link_modeled) and \
            {int(F.ICI_LINK_TX), int(F.ICI_LINK_RX)} <= self._fid_set
        #: chip -> NVLink peer count, gathered once (topology is static);
        #: 0/missing disables the modeled split for that chip
        self._neighbor_links: Dict[int, int] = {}
        if self._ici_modeled:
            from ..types import P2PLinkType
            for c in self.chips:
                try:
                    topo = handle.topology(c)
                    self._neighbor_links[c] = sum(
                        1 for l in topo.links
                        if l.link is P2PLinkType.ICI_NEIGHBOR)
                except Exception:  # noqa: BLE001 — no topology: no model
                    self._neighbor_links[c] = 0

        self._fg = handle.watches.create_field_group(field_ids, "exporter")
        self._cg = handle.watches.create_chip_group(self.chips, "exporter")
        # the exporter only renders the latest sample: cap each series at
        # 2 (latest + one predecessor) instead of age-bounded history
        handle.watches.watch_fields(self._cg, self._fg,
                                    update_freq_us=interval_ms * 1000,
                                    max_keep_samples=2)
        # push the watch into the agent when one is serving us: the
        # daemon samples the devices once for all clients (hostengine
        # parity).  Vector fields are left out (the agent's sampler caches
        # scalars only) and so are burst-derived fields (served from the
        # burst harvest, not the sampler cache)
        self._agent_watch_id: Optional[int] = None
        ensure = getattr(handle.backend, "ensure_watch", None)
        if callable(ensure):
            scalar_ids = [f for f in field_ids
                          if not FF.CATALOG[int(f)].vector_label
                          and FF.burst_source(int(f)) is None]
            if scalar_ids:
                try:
                    self._agent_watch_id = ensure(scalar_ids,
                                                  freq_us=interval_ms * 1000)
                except Exception as e:
                    # an agent without watch support: live reads work
                    log.warning("agent-side watch setup failed, falling "
                                "back to live reads: %r", e)

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
        #: latched after the first None probe: an agent's --burst-hz is
        #: fixed at its start, so a burst-less agent must not cost one
        #: hello RPC a second forever
        self._burst_stats_off = False
        self._agent_introspect_data: Optional[Dict[str, float]] = None
        self._agent_introspect_ts = 0.0
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

        #: the drop-file merge (:mod:`.textmerge`); its glob may match
        #: this exporter's own output, which is never merged back in
        self._merge = TextfileMerge(merge_globs or [], merge_max_age_s,
                                    exclude=output_path)
        self._self_mon = SelfMonitor()
        self._host_label = f'host="{os.uname().nodename}"'
        self._not_idle_since: Dict[int, Optional[float]] = {}
        self._lock = threading.Lock()
        self._last_bytes = b""
        #: gzip variant of the published body, compressed at most once
        #: per sweep, lazily on the first Accept-Encoding: gzip scrape
        self._last_gzip: Optional[bytes] = None
        self._gzip_bytes = 0
        self._gzip_compress_lock = threading.Lock()
        self._sweep_count = 0
        self._last_success_monotonic: Optional[float] = None
        #: the sweep's spans (a ``sweep`` root, a child per phase, the
        #: backend's reads under ``collect``) and the served requests'
        #: (:class:`MetricsHTTPServer`)
        self.spans = spans.Recorder()
        #: the last sweep that returned, served one sweep late
        self._last_sweep: Tuple[spans.Span, ...] = ()
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
        multiply its device work by the inner rate) fails the start.
        Over an agent the loop is the agent's (``--burst-hz`` there): the
        flag is ignored with a warning, as in the reference."""

        from ..burst import BurstSampler

        native = getattr(handle.backend, "burst_stats", None)
        has_native = False
        if callable(native):
            try:
                has_native = native() is not None
            except Exception:
                has_native = False
        if has_native:
            log.warning(
                "backend already runs a burst engine; --burst-hz %d "
                "ignored (derived fields come from the backend)", burst_hz)
            return
        if getattr(handle.backend, "name", "") == "agent":
            # 50-100 socket round trips a second on the shared connection
            # is the request-rate blow-up the agent's own loop avoids
            log.warning(
                "--burst-hz %d ignored: the agent runs no burst loop, and "
                "sampling it over the RPC socket would multiply the "
                "request rate by the inner rate — start the agent with "
                "--burst-hz instead", burst_hz)
            return

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

    def _modeled_link_lines(self, per_chip) -> List[str]:
        """Opt-in per-link split of the measured NVLink aggregate
        (``tpumon/exporter/exporter.py`` ``_modeled_link_lines``).

        Emitted only for cards whose backend left the per-link fields
        BLANK while serving an aggregate (embedded mode); every sample
        carries ``source="modeled"``.  The split is even across the card's
        NVLink peers, the balanced-ring assumption the attributed
        collectives make.  If any card has a real per-link source this
        sweep, synthesis is skipped entirely, and so it is when per-link
        series arrive in a merged drop file (one sweep late: the merge
        runs after the render)."""

        from .promtext import _escape_label

        link_tx, link_rx = int(F.ICI_LINK_TX), int(F.ICI_LINK_RX)
        agg_by_fid = {link_tx: int(F.ICI_TX_THROUGHPUT),
                      link_rx: int(F.ICI_RX_THROUGHPUT)}
        if any(per_chip.get(c, {}).get(f) is not None
               for c in self.chips for f in (link_tx, link_rx)):
            return []
        if {FF.CATALOG[link_tx].prom_name,
                FF.CATALOG[link_rx].prom_name} & self._merge.families:
            return []
        out: List[str] = []
        for fid, agg_fid in agg_by_fid.items():
            meta = FF.CATALOG[fid]
            wrote_header = False
            for c in self.chips:
                agg = per_chip.get(c, {}).get(agg_fid)
                links = self._neighbor_links.get(c, 0)
                if agg is None or links <= 0:
                    continue
                if not wrote_header:
                    out.append(f"# HELP {meta.prom_name} {meta.help} "
                               f"(source=modeled: even split of the "
                               f"measured aggregate)")
                    out.append(f"# TYPE {meta.prom_name} "
                               f"{meta.ftype.value}")
                    wrote_header = True
                labels = ",".join(
                    f'{k}="{_escape_label(str(v))}"'
                    for k, v in self._labels[c].items())
                share = float(agg) / links
                for i in range(links):
                    out.append(
                        f'{meta.prom_name}{{{labels},'
                        f'{meta.vector_label}="{i}",source="modeled"}} '
                        f"{share:.3f}")
        return out

    # -- one sweep ------------------------------------------------------------

    def sweep(self, now: Optional[float] = None) -> str:
        """One sweep; returns the rendered exposition as ``str`` (tests,
        ``--oneshot``).  The sweep loop and the serve path use
        :meth:`sweep_bytes` / :meth:`payload` and never pay this
        decode."""

        return self.sweep_bytes(now).decode("utf-8")

    def sweep_bytes(self, now: Optional[float] = None) -> bytes:
        with self.spans.root("sweep"):
            body = self._sweep(now)
        # served with one-sweep lag: a slow merge or a stalling output
        # filesystem shows in the very self-metric operators alert on
        self._last_sweep = self.spans.last("sweep")
        return body

    def _sweep(self, now: Optional[float]) -> bytes:
        """One sweep inside its ``sweep`` span, a child span a phase."""

        with spans.span("collect"):
            t = now if now is not None else self._clock()
            per_chip = self._collect(t, now)
        findings: List[Any] = []
        if self.anomaly is not None:
            with spans.span("anomaly"):
                findings = self._detect(per_chip, t)
        if self.blackbox is not None:
            # tee the sweep into the flight recorder, stamped with the
            # sweep's wall time so replay lines up with Prometheus.
            # Failure degrades the RECORDER, never the metric stream.
            with spans.span("record"):
                try:
                    self.blackbox.record_sweep(per_chip, now=t)
                    for rec in findings:
                        # 0xB3 verdicts beside the frame they scored
                        self.blackbox.record_finding(rec)
                except Exception as e:
                    log.warn_every("exporter.blackbox", 30.0,
                                   "flight recorder tee failed: %r", e)
        if self._stream is not None:
            # tee the sweep to live subscribers: the frame is encoded
            # ONCE against the publisher's delta table and fanned out
            # as bytes; a slow subscriber is the frameserver's problem
            # (bounded buffer, drop-to-keyframe), never this loop's
            with spans.span("stream"):
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

        with spans.span("render"):
            extra = self._self_metrics()
            if self._ici_modeled:
                extra = list(extra) + self._modeled_link_lines(per_chip)
            if self._enricher is None:
                # hot path: delta-aware bytes render; the merge works
                # from the renderer's series index instead of re-parsing
                # the text.  Body assembly without a merge is render
                # work: compose is booked under the render phase
                parts = self.renderer.render_parts(per_chip, self._labels)
                if not self._merge.globs:
                    body = self.renderer.compose(parts, extra)
            else:
                # enricher escape hatch (arbitrary text rewrites): the
                # renderer's incremental index cannot survive a
                # text-level transform, so this path runs the full
                # oracle renderer
                text = self.renderer.render(per_chip, self._labels,
                                            extra_lines=extra)
                try:
                    text = self._enricher(text)
                except Exception as e:
                    # attribution failure must not break the metric stream
                    log.warn_every("exporter.enrich", 30.0,
                                   "pod attribution failed; serving "
                                   "unenriched metrics: %r", e)
        with spans.span("merge"):
            if self._enricher is None:
                if self._merge.globs:
                    body = self._merge_textfiles_parts(parts, extra, t)
            else:
                if self._merge.globs:
                    text = self._merge.merge_text(text, t)
                body = text.encode(  # tpumon-lint: disable=encode-in-hot-path
                    "utf-8")  # (oracle fallback only — never the hot loop)
        with spans.span("publish"):
            if self.output_path:
                atomic_write(self.output_path, body)
            with self._lock:
                self._last_bytes = body
                self._last_gzip = None  # next gzip scrape recompresses once
                self._gzip_bytes = 0    # gauge covers THIS sweep's variant
                self._sweep_count += 1
                self._last_success_monotonic = time.monotonic()
        return body

    def _collect(self, t: float, now: Optional[float]
                 ) -> Dict[int, Mapping[int, FieldValue]]:
        """The sweep's values a chip: the watch's snapshot (the backend's
        reads), the burst harvest over it, the agent's introspection and
        the pod labels."""

        snapshot = self.handle.watches.update_all(wait=True, now=now)
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
        # fetched inside the timed region so scrape_duration sees its
        # cost; refreshed at most 1 Hz, on the injected clock
        if t - self._agent_introspect_ts >= 1.0:
            self._agent_introspect_data = self._fetch_agent_introspect()
            self._burst_stats = self._fetch_burst_stats()
            self._agent_introspect_ts = t
        # inside the timed region: a kubelet refresh stalling the sweep
        # must show in scrape_duration
        self._apply_pod_labels()
        return per_chip

    def _detect(self, per_chip, t: float) -> List[Any]:
        """Detection BEFORE the tee: this sweep's findings ride this
        sweep's recorder segment.  Kmsg lines queued by the watcher
        thread drain here, on the sweep thread."""

        findings: List[Any] = []
        try:
            while True:
                try:
                    line, k_ts = self._anomaly_kmsg_q.get_nowait()
                except queue.Empty:
                    break
                if self.blackbox is not None:
                    # recorded HERE, in drain order, so the on-disk
                    # sequence is exactly the sequence the live engine
                    # scored (backtest identity)
                    self.blackbox.record_kmsg(line, now=k_ts)
                findings += self.anomaly.observe_kmsg(line, k_ts)
            findings += self.anomaly.observe(per_chip, now=t)
        except Exception as e:
            # a broken detector must never cost the metric stream
            log.warn_every("exporter.anomaly", 30.0,
                           "anomaly engine failed: %r", e)
        if findings:
            self.last_findings = findings
        return findings

    def sweep_phases(self) -> Dict[str, float]:
        """Seconds of each phase of the last sweep that returned."""

        return {name.split(".", 1)[1]: s
                for name, s in spans.seconds(self._last_sweep).items()
                if name.count(".") == 1}

    # -- textfile merge (node-exporter textfile-collector role) ---------------

    def _merge_textfiles_parts(self, parts: List[Tuple[str, bytes]],
                               extra_lines: Sequence[str],
                               now: float) -> bytes:
        """Merge against the renderer's incremental series index — no
        re-parse of the exporter's own exposition; only the per-sweep
        extra-line block is indexed by line walk."""

        merge = self._merge
        fe = merge.load(now)
        if not fe:
            # quiet drop dir: merge nothing, pay no index copy
            return self.renderer.compose(parts, extra_lines)
        series = set(self.renderer.series_set)
        decl = {fam for fam, _ in parts}
        index_lines(extra_lines, series, decl)
        by_family, tail_lines = merge.apply(series, decl, fe)
        if not by_family and not tail_lines:
            return self.renderer.compose(parts, extra_lines)
        # the encodes below cover merged/tail/extra lines only — a small
        # minority of the exposition by design (the catalog blocks stay
        # cached bytes)
        segs: List[bytes] = []
        for fam, block in parts:
            segs.append(block)
            joined = by_family.pop(fam, None)
            if joined:
                segs.append("\n".join(joined).encode(
                    "utf-8"))  # tpumon-lint: disable=encode-in-hot-path
        # merged samples joining an extra-line family (plus families
        # declared but never sampled) splice inside the extra block,
        # exactly where the full-text walk would put them
        extra_out = list(extra_lines)
        if by_family:
            extra_out = splice_lines(extra_out, by_family)
        if extra_out:
            segs.append("\n".join(extra_out).encode(
                "utf-8"))  # tpumon-lint: disable=encode-in-hot-path
        if tail_lines:
            segs.append("\n".join(tail_lines).encode(
                "utf-8"))  # tpumon-lint: disable=encode-in-hot-path
        return b"\n".join(segs) + b"\n"

    def _self_metrics(self) -> List[str]:
        st = self._self_mon.status()
        lbl = self._host_label
        rf = render_family
        lines: List[str] = self._agent_metrics(lbl)
        # backend-provided self families, under the same host label;
        # failure must not cost the sweep
        hook = getattr(self.handle.backend, "self_metric_lines", None)
        if callable(hook):
            try:
                lines += list(hook(lbl))
            except Exception as e:
                log.warn_every("exporter.selfhook", 60.0,
                               "backend self-metrics hook failed: %r", e)
        last = self._last_sweep
        lines += rf("tpumon_exporter_scrape_duration_seconds", "gauge",
                    "Wall time of the previous full sweep "
                    "(collect+render+merge+publish).",
                    lbl, last[-1].ns / 1e9 if last else 0.0, fmt=".6f")
        lines += phase_lines("tpumon_exporter_sweep_phase_seconds", lbl,
                             self.sweep_phases(), SWEEP_PHASES)
        served, req = self.spans.latest("request")
        if req:
            lines += phase_lines("tpumon_exporter_request_phase_seconds",
                                 lbl, spans.seconds(req), REQUEST_PHASES,
                                 prefix="request.")
            lines += rf("tpumon_exporter_requests_total", "counter",
                        SELF_FAMILIES["tpumon_exporter_requests_total"][1],
                        lbl, served, fmt=".0f")
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
                    lbl, 1.0 if _codec.active() else 0.0, fmt=".0f")
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
        # sweep-RPC bytes and decode time (binary delta frames vs the
        # JSON path), from the agent client's wire counters
        wire = getattr(self.handle.backend, "sweep_wire_stats", None)
        if callable(wire):
            try:
                ws = wire()
            except Exception as e:
                log.warn_every("exporter.wirestats", 60.0,
                               "sweep wire stats fetch failed: %r", e)
                ws = None
            if ws:
                lines += rf("tpumon_exporter_sweep_rpc_bytes", "counter",
                            "Cumulative sweep-RPC response bytes "
                            "received from the agent.",
                            lbl, ws.get("rpc_bytes_total", 0.0), fmt=".0f")
                lines += rf("tpumon_exporter_sweep_decode_seconds",
                            "counter",
                            "Cumulative wall time decoding sweep-RPC "
                            "responses (frame/JSON decode + snapshot "
                            "materialization).",
                            lbl, ws.get("decode_seconds_total", 0.0),
                            fmt=".6f")
                lines += rf("tpumon_exporter_sweep_last_rpc_bytes",
                            "gauge",
                            "Sweep-RPC response bytes of the most "
                            "recent sweep.",
                            lbl, ws.get("last_rpc_bytes", 0.0), fmt=".0f")
                lines += rf("tpumon_exporter_sweep_last_decode_seconds",
                            "gauge",
                            "Decode wall time of the most recent "
                            "sweep's RPC response.",
                            lbl, ws.get("last_decode_seconds", 0.0),
                            fmt=".6f")
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
        if self._merge.globs:
            lines += rf("tpumon_exporter_merged_files", "gauge",
                        "Fresh textfiles merged into the previous sweep.",
                        lbl, self._merge.files, fmt=".0f")
            lines += rf("tpumon_exporter_merged_series", "gauge",
                        "Sample series merged from textfiles in the "
                        "previous sweep.",
                        lbl, self._merge.series, fmt=".0f")
        return lines

    def _fetch_agent_introspect(self) -> Optional[Dict[str, float]]:
        """The agent's self-metrics (standalone mode only), as floats.
        Any failure drops the families, never the sweep."""

        introspect = getattr(self.handle.backend, "agent_introspect", None)
        if not callable(introspect):
            return None
        try:
            d = introspect()
            return {k: float(d[k]) for k in
                    ("cpu_percent", "memory_kb", "uptime_s") if k in d}
        except Exception as e:
            log.warn_every("exporter.introspect", 60.0,
                           "agent introspection failed: %r", e)
            return None

    def _fetch_burst_stats(self) -> Optional[Dict[str, float]]:
        """Burst-loop health: the local sampler's own counters, else the
        backend's (the agent's hello).  The first ``None`` from the
        backend latches the probe off; a failure drops the gauges, never
        the sweep."""

        if self._burst_sampler is not None:
            return self._burst_sampler.stats()
        if self._burst_stats_off:
            return None
        stats = getattr(self.handle.backend, "burst_stats", None)
        if not callable(stats):
            self._burst_stats_off = True
            return None
        try:
            out = stats()
        except Exception as e:
            log.warn_every("exporter.burststats", 60.0,
                           "burst stats probe failed: %r", e)
            return None
        if out is None:
            self._burst_stats_off = True
        return out

    def _agent_metrics(self, lbl: str) -> List[str]:
        d = self._agent_introspect_data
        if not d:
            return []
        out: List[str] = []
        for key, fam, help_txt in (
                ("cpu_percent", "tpumon_agent_cpu_percent",
                 "tpu-hostengine process CPU percent since start."),
                ("memory_kb", "tpumon_agent_memory_kb",
                 "tpu-hostengine process RSS in KB."),
                ("uptime_s", "tpumon_agent_uptime_seconds",
                 "tpu-hostengine uptime in seconds.")):
            if key not in d:
                continue
            out += render_family(fam, "gauge", help_txt, lbl, d[key])
        return out

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
            # release the agent-side watch (the agent also drops it with
            # the connection, but a clean stop should not rely on that)
            if self._agent_watch_id is not None:
                try:
                    self.handle.backend.unwatch(self._agent_watch_id)
                except Exception as e:
                    log.vlog(1, "agent watch release failed on stop "
                                "(%r); the agent drops it with the "
                                "connection", e)
                self._agent_watch_id = None

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

        super().__init__(dispatch, port=port, bind=bind,
                         spans=exporter.spans)
