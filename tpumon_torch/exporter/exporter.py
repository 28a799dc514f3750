"""The exporter's sweep core.

Counterpart of ``tpumon/exporter/exporter.py``'s :class:`TpuExporter`:
field and label setup, one watch over the selected chips, the sweep
(collect -> render -> publish) with exporter-side not-idle tracking, the
atomic textfile publish, and the ``tpumon_exporter_*`` self-metrics.
Families keep their ``tpu_*`` names.

Not ported yet, and refused when asked for: the anomaly, flight-recorder
(blackbox), burst, stream, textfile-merge and pod-attribution planes, the
modeled per-link ICI split, and the HTTP server.  There is no native
codec: the render is the pure-Python path.
"""

from __future__ import annotations

import os
import re
import threading
import time
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence

from .. import fields as FF
from .. import log
from ..backends.base import FieldValue
from ..introspect import SelfMonitor
from .promtext import SweepRenderer, atomic_write, render_family

F = FF.F

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


#: constructor options of the reference exporter whose planes this port
#: does not carry yet, with the value that leaves each plane off
_NOT_PORTED = {"burst": False, "burst_hz": 0, "merge_globs": None,
               "ici_per_link_modeled": False, "blackbox_dir": None,
               "blackbox_max_bytes": None, "rules": None}


class TpuExporter:
    """Owns the watch, the sweep, and the rendered output."""

    def __init__(self, handle, *,
                 interval_ms: int = 1000,
                 profiling: bool = False,
                 dcn: bool = False,
                 field_ids: Optional[Sequence[int]] = None,
                 output_path: Optional[str] = None,
                 chips: Optional[Sequence[int]] = None,
                 clock: Optional[Callable[[], float]] = None,
                 **planes: Any) -> None:
        """``field_ids`` overrides the canned family sets entirely (the
        ``dcgmi dmon -e`` analog).  ``output_path``: textfile to publish
        every sweep to (atomic rename), or None."""

        for opt, value in planes.items():
            if opt not in _NOT_PORTED:
                raise TypeError(f"unexpected option {opt!r}")
            if value != _NOT_PORTED[opt]:
                raise NotImplementedError(
                    f"exporter option {opt!r} belongs to a plane not "
                    f"ported to tpumon_torch yet")
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

        self._self_mon = SelfMonitor()
        self._host_label = f'host="{os.uname().nodename}"'
        self._not_idle_since: Dict[int, Optional[float]] = {}
        self._lock = threading.Lock()
        self._last_bytes = b""
        self._sweep_count = 0
        self._last_sweep_duration = 0.0
        #: previous sweep's per-phase wall seconds
        self._last_phases: Dict[str, float] = {}

    def set_enricher(self, fn) -> None:
        raise NotImplementedError("text enrichment is not ported yet")

    def set_pod_attributor(self, attributor) -> None:
        raise NotImplementedError("pod attribution is not ported yet")

    def set_stream_publisher(self, publisher) -> None:
        raise NotImplementedError("the stream plane is not ported yet")

    def anomaly_kmsg(self, line: str, ts: float) -> bool:
        raise NotImplementedError("the anomaly plane is not ported yet")

    # -- one sweep ------------------------------------------------------------

    def sweep(self, now: Optional[float] = None) -> str:
        """One sweep; returns the rendered exposition as ``str``."""

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
        t1 = time.monotonic()
        phases["collect"] = t1 - t0

        extra = self._self_metrics()
        parts = self.renderer.render_parts(per_chip, self._labels)
        body = self.renderer.compose(parts, extra)
        t2 = time.monotonic()
        phases["render"] = t2 - t1
        if self.output_path:
            atomic_write(self.output_path, body)
        with self._lock:
            self._last_bytes = body
            self._sweep_count += 1
        phases["publish"] = time.monotonic() - t2
        self._last_sweep_duration = time.monotonic() - t0
        self._last_phases = phases
        return body

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
                    "(collect+render+publish).",
                    lbl, self._last_sweep_duration, fmt=".6f")
        if self._last_phases:
            lines.append("# HELP tpumon_exporter_sweep_phase_seconds Wall "
                         "time of each phase of the previous sweep.")
            lines.append("# TYPE tpumon_exporter_sweep_phase_seconds gauge")
            for ph in ("collect", "render", "publish"):
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
        with self._lock:
            nbytes = len(self._last_bytes)
        if nbytes:
            lines += rf("tpumon_exporter_scrape_bytes", "gauge",
                        "Size of the previous sweep's exposition in "
                        "bytes.",
                        lbl, nbytes, fmt=".0f")
        return lines
