"""Prometheus text-format rendering and the atomic textfile contract.

Byte-level sibling of the reference's gawk emitter
(``exporters/prometheus-dcgm/dcgm-exporter/dcgm-exporter:96-194``):

* HELP/TYPE headers once per family per sweep (``:99-102``),
* one sample line per chip with ``{chip,uuid}`` labels (the reference's
  ``{gpu,uuid}``; third parties parse these files, so the label scheme is
  position-compatible with a ``gpu->chip`` rename),
* optional spliced pod labels (``pod_name,pod_namespace,container_name``,
  matching ``device_pod.go:109-113``),
* atomic publish: write ``<out>.swp`` then rename over ``<out>``, mode 0644
  (``dcgm-exporter:189-193``, ``file_utils.go:10-23``) so the node-exporter
  textfile collector never reads a torn file.
"""

from __future__ import annotations

import os
import tempfile
import threading
from typing import (Dict, Iterable, List, Mapping, Optional, Sequence, Set,
                    Tuple, Union)

from .. import fields as FF
from ..backends.base import FieldValue


def _escape_label(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def format_value(v: FieldValue) -> str:
    # exact-type checks, most-common first: this runs once per sample
    # line per sweep (type() is-checks also keep bool, an int subclass,
    # out of the int path)
    t = type(v)
    if t is float:
        # shortest faithful representation, matching prometheus conventions
        return repr(v)
    if t is int:
        return str(v)
    if t is bool:
        return "1" if v else "0"
    if isinstance(v, float):
        # float subclasses (e.g. numpy scalars): go through float() so
        # numpy>=2's repr (``np.float64(1.5)``) can't leak into the wire
        # format — prometheus needs a bare number
        return repr(float(v))
    return str(v)


class SweepRenderer:
    """Renders one sweep (all chips x all families) to Prometheus text.

    Two pipelines share the per-chip label / prefix caches:

    * :meth:`render` — the full string renderer, rebuilt from scratch
      every call.  It is the *differential oracle*: simple enough to
      audit by eye, and the incremental path below is pinned to it
      byte-for-byte by ``tests/test_promtext_differential.py``.
    * :meth:`render_parts` + :meth:`compose` — the delta-aware bytes
      pipeline the exporter hot loop uses.  A persistent per-(field,
      chip) table holds each sample line pre-encoded; a sweep only
      re-formats values whose (type, value) identity changed since the
      previous sweep, re-splices family blocks from cached segments,
      and returns ``bytes`` ready to serve.  Hit/miss counters make the
      steady-state win observable from the scrape itself
      (``tpumon_exporter_render_cache_hit_ratio``).
    """

    def __init__(self, field_ids: Sequence[int]) -> None:
        # LABEL-type fields are identity, not samples; filter them out
        self.field_ids = [f for f in field_ids
                          if FF.CATALOG[int(f)].ftype is not FF.FieldType.LABEL]
        self._metas = [(int(f), FF.meta(f)) for f in self.field_ids]
        # cross-sweep caches: chip labels, HELP/TYPE headers, and full
        # 'family{labels} ' sample-line prefixes are static, so escaping/
        # formatting them once (not per family per sweep) keeps the 1 Hz
        # render loop out of the exporter's CPU budget
        self._label_cache: Dict[int, Tuple[Tuple[Tuple[str, str], ...],
                                           str]] = {}
        self._header_cache: Dict[int, Tuple[str, str]] = {}
        self._prefix_cache: Dict[Tuple[int, int], str] = {}
        # incremental pipeline state: per-field {chip: (type, value_key,
        # chunk, series_ids)} encoded sample chunks (nested int-keyed
        # dicts: the steady-state hit check is one dict get + a type
        # identity check + one equality, no tuple allocation), per-family
        # spliced block bytes, and the series index the merge layer uses
        # instead of re-parsing the rendered text
        self._line_cache: Dict[int, Dict[int, Tuple[type, object,
                                                    Optional[bytes],
                                                    Tuple[str, ...]]]] = {}
        self._header_bytes: Dict[int, bytes] = {}
        self._fam_blocks: Dict[int, bytes] = {}
        self._fam_dirty: Set[int] = {fid for fid, _ in self._metas}
        self._chips_key: Optional[Tuple[int, ...]] = None
        self._series_set: Set[str] = set()
        #: cumulative line-cache counters + the previous render's ratio
        self.line_cache_hits = 0
        self.line_cache_misses = 0
        self.last_hit_ratio: Optional[float] = None

    # tpumon: thread-ok(one owner per renderer — the exporter's renderer is driven only by its sweep thread, and the Python agent builds a fresh one for each scrape under Engine._prom_lock; the caches are per instance, and the call graph joins the instances of one class)
    def _labels_str(self, chip: int, label_map: Mapping[str, str]) -> str:
        items = tuple(label_map.items())
        cached = self._label_cache.get(chip)
        if cached is not None and cached[0] == items:
            return cached[1]
        joined = ",".join(f'{k}="{_escape_label(str(v))}"' for k, v in items)
        self._label_cache[chip] = (items, joined)
        # label change (e.g. pod attribution rotated) invalidates the
        # per-(field, chip) sample-line prefixes and cached encoded lines
        for key in [k for k in self._prefix_cache if k[1] == chip]:
            del self._prefix_cache[key]
        self._evict_chip_lines((chip,))
        return joined

    # tpumon: thread-ok(one owner per renderer — the exporter's renderer is driven only by its sweep thread, and the Python agent builds a fresh one for each scrape under Engine._prom_lock; the caches are per instance, and the call graph joins the instances of one class)
    def _headers(self, fid: int, meta: "FF.FieldMeta") -> Tuple[str, str]:
        cached = self._header_cache.get(fid)
        if cached is None:
            cached = (f"# HELP {meta.prom_name} {meta.help}",
                      f"# TYPE {meta.prom_name} {meta.ftype.value}")
            self._header_cache[fid] = cached
        return cached

    # tpumon: thread-ok(one owner per renderer — the exporter's renderer is driven only by its sweep thread, and the Python agent builds a fresh one for each scrape under Engine._prom_lock; the caches are per instance, and the call graph joins the instances of one class)
    def render(self,
               per_chip: Mapping[int, Mapping[int, FieldValue]],
               labels_per_chip: Mapping[int, Mapping[str, str]],
               extra_lines: Optional[Iterable[str]] = None) -> str:
        """``per_chip``: chip -> field -> value (None = blank, skipped).

        ``labels_per_chip``: chip -> ordered label map; must include at
        least ``chip`` and ``uuid``.
        """

        out: List[str] = []
        chips = sorted(per_chip.keys())
        # lazy per-render label resolution: a chip whose values are all
        # None (e.g. lost mid-sweep) need not appear in labels_per_chip
        labels_by_chip: Dict[int, str] = {}
        prefixes = self._prefix_cache
        for fid, meta in self._metas:
            wrote_header = False
            for chip in chips:
                v = per_chip[chip].get(fid)
                if v is None:
                    continue  # blank -> omit sample (nil convention)
                labels = labels_by_chip.get(chip)
                if labels is None:
                    labels = labels_by_chip[chip] = self._labels_str(
                        chip, labels_per_chip[chip])
                samples: Sequence[Tuple[str, FieldValue]]
                if meta.vector_label and isinstance(v, (list, tuple)):
                    # vector field: one sample per element, extra label
                    samples = [
                        (f'{meta.prom_name}{{{labels},'
                         f'{meta.vector_label}="{i}"}} ', ev)
                        for i, ev in enumerate(v) if ev is not None]
                elif isinstance(v, (list, tuple)):
                    continue  # vector value for a scalar family: drop
                else:
                    prefix = prefixes.get((fid, chip))
                    if prefix is None:
                        prefix = prefixes[(fid, chip)] = (
                            f"{meta.prom_name}{{{labels}}} ")
                    samples = ((prefix, v),)
                if not samples:
                    continue
                if not wrote_header:
                    # HELP/TYPE once per family per sweep (dcgm-exporter:99-102)
                    out.extend(self._headers(fid, meta))
                    wrote_header = True
                for prefix, val in samples:
                    out.append(prefix + format_value(val))
        if extra_lines:
            out.extend(extra_lines)
        return "\n".join(out) + "\n"

    # -- incremental bytes pipeline -------------------------------------------

    # tpumon: thread-ok(one owner per renderer — the exporter's renderer is driven only by its sweep thread, and the Python agent builds a fresh one for each scrape under Engine._prom_lock; the caches are per instance, and the call graph joins the instances of one class)
    def _evict_chip_lines(self, chips: Iterable[int]) -> None:
        """Drop cached lines (and their series-index entries) for chips
        whose labels rotated or that left the sweep."""

        for fid, chipmap in self._line_cache.items():
            for chip in chips:
                entry = chipmap.pop(chip, None)
                if entry is not None:
                    self._series_set.difference_update(entry[3])
                    self._fam_dirty.add(fid)

    def _headers_bytes(self, fid: int, meta: "FF.FieldMeta") -> bytes:
        b = self._header_bytes.get(fid)
        if b is None:
            help_ln, type_ln = self._headers(fid, meta)
            b = self._header_bytes[fid] = \
                (help_ln + "\n" + type_ln).encode(  # once per family,
                    "utf-8")  # cached  # tpumon-lint: disable=encode-in-hot-path
        return b

    # tpumon: thread-ok(one owner per renderer — the exporter's renderer is driven only by its sweep thread, and the Python agent builds a fresh one for each scrape under Engine._prom_lock; the caches are per instance, and the call graph joins the instances of one class)
    def _render_chunk(  # tpumon-lint: disable=encode-in-hot-path
            self, fid: int, meta: "FF.FieldMeta", chip: int,
            v: FieldValue,
            labels_per_chip: Mapping[int, Mapping[str, str]],
            ) -> Tuple[Optional[bytes], Tuple[str, ...]]:
        """One chip's sample line(s) for one family, encoded, plus their
        series ids.  Runs only on a line-cache miss — this is the ONLY
        place the incremental pipeline formats or encodes sample text."""

        if v is None:
            return None, ()
        cached = self._label_cache.get(chip)
        labels = cached[1] if cached is not None else \
            self._labels_str(chip, labels_per_chip[chip])
        if meta.vector_label and isinstance(v, (list, tuple)):
            lines: List[str] = []
            sids: List[str] = []
            for i, ev in enumerate(v):
                if ev is None:
                    continue
                sid = (f'{meta.prom_name}{{{labels},'
                       f'{meta.vector_label}="{i}"}}')
                lines.append(sid + " " + format_value(ev))
                sids.append(sid)
            if not lines:
                return None, ()
            return "\n".join(lines).encode("utf-8"), tuple(sids)
        if isinstance(v, (list, tuple)):
            return None, ()  # vector value for a scalar family: drop
        prefix = self._prefix_cache.get((fid, chip))
        if prefix is None:
            prefix = self._prefix_cache[(fid, chip)] = \
                f"{meta.prom_name}{{{labels}}} "
        return (prefix + format_value(v)).encode("utf-8"), (prefix[:-1],)

    # tpumon: thread-ok(one owner per renderer — the exporter's renderer is driven only by its sweep thread, and the Python agent builds a fresh one for each scrape under Engine._prom_lock; the caches are per instance, and the call graph joins the instances of one class)
    def render_parts(self,
                     per_chip: Mapping[int, Mapping[int, FieldValue]],
                     labels_per_chip: Mapping[int, Mapping[str, str]],
                     ) -> List[Tuple[str, bytes]]:
        """Delta-aware render: ``[(family, block_bytes), ...]`` in catalog
        order, omitting families with no samples this sweep.

        Semantics match :meth:`render` line-for-line; only values whose
        identity changed since the previous call are re-formatted, and a
        family block is re-spliced only when one of its lines (or the
        chip set / a chip's labels) changed.  ``self._series_set`` holds
        the series ids of every line currently in the output — the merge
        layer's index, maintained incrementally so no caller ever
        re-parses the rendered text."""

        chips = sorted(per_chip.keys())
        chips_t = tuple(chips)
        if chips_t != self._chips_key:
            gone = set(self._chips_key or ()) - set(chips_t)
            if gone:
                self._evict_chip_lines(gone)
            self._chips_key = chips_t
            self._fam_dirty.update(fid for fid, _ in self._metas)
        # eager label refresh: a rotated label set (pod attribution)
        # evicts that chip's cached lines before any could be reused
        for chip in chips:
            lm = labels_per_chip.get(chip)
            if lm is not None:
                self._labels_str(chip, lm)
        hits = 0
        misses = 0
        cache = self._line_cache
        dirty_set = self._fam_dirty
        series = self._series_set
        rows = [per_chip[c] for c in chips]
        parts: List[Tuple[str, bytes]] = []
        for fid, meta in self._metas:
            chipmap = cache.get(fid)
            if chipmap is None:
                chipmap = cache[fid] = {}
            cget = chipmap.get
            vector = bool(meta.vector_label)
            dirty = fid in dirty_set
            chunks: List[bytes] = []
            for i, chip in enumerate(chips):
                v = rows[i].get(fid)
                entry = cget(chip)
                t = type(v)
                if vector and isinstance(v, (list, tuple)):
                    # vectors snapshot element-wise with element types:
                    # the backend may mutate its list in place, and
                    # 1 == 1.0 == True while formatting differently
                    vk: object = tuple(
                        (float, repr(e)) if (not e and isinstance(e, float))
                        else (type(e), e) for e in v)
                else:
                    # ±0.0 are == with different reprs — key float zeros
                    # on their repr so a sign flip re-renders (the only
                    # equal-and-type-equal values that format apart)
                    vk = repr(v) if (not v and isinstance(v, float)) else v
                if entry is not None and entry[0] is t and entry[1] == vk:
                    hits += 1
                    chunk = entry[2]
                else:
                    misses += 1
                    chunk, sids = self._render_chunk(
                        fid, meta, chip, v, labels_per_chip)
                    if entry is not None:
                        old_sids = entry[3]
                        if sids != old_sids:  # value churn keeps its sid
                            series.difference_update(old_sids)
                            series.update(sids)
                    elif sids:
                        series.update(sids)
                    chipmap[chip] = (t, vk, chunk, sids)
                    dirty = True
                if chunk is not None:
                    chunks.append(chunk)
            if dirty:
                if chunks:
                    block = (self._headers_bytes(fid, meta) + b"\n"
                             + b"\n".join(chunks))
                else:
                    block = b""
                self._fam_blocks[fid] = block
                dirty_set.discard(fid)
            else:
                block = self._fam_blocks.get(fid, b"")
            if block:
                parts.append((meta.prom_name, block))
        total = hits + misses
        self.line_cache_hits += hits
        self.line_cache_misses += misses
        self.last_hit_ratio = (hits / total) if total else None
        return parts

    @property
    def series_set(self) -> Set[str]:
        """Live series index of the last :meth:`render_parts` output
        (catalog families only).  Callers copy before mutating."""

        return self._series_set

    @staticmethod
    def compose(parts: Sequence[Tuple[str, bytes]],
                extra_lines: Optional[Sequence[str]] = None) -> bytes:
        """Splice family blocks (+ the small per-sweep extra-line block)
        into the final exposition bytes — byte-identical to
        :meth:`render` on the same inputs."""

        segs = [block for _, block in parts]
        if extra_lines:
            # the only per-sweep encode: the ~60-line self-metric block,
            # which changes every sweep by construction
            segs.append("\n".join(extra_lines).encode(
                "utf-8"))  # tpumon-lint: disable=encode-in-hot-path
        return b"\n".join(segs) + b"\n"


_NOFOLLOW = getattr(os, "O_NOFOLLOW", 0)


def render_family_samples(fam: str, ptype: str, help_txt: str,
                          samples: Sequence[Tuple[str, float]],
                          fmt: str = ".3f") -> List[str]:
    """One self-metric family as [HELP, TYPE, sample...] lines — one
    sample per ``(label, value)`` pair (the fleet-shard gauges emit
    one series per shard under a single HELP/TYPE header).

    The single emission helper for ad-hoc (non-catalog) families —
    exporter self-metrics, agent self-metrics, backend hooks, shard
    gauges — so the HELP/TYPE/label shape cannot drift between call
    sites."""

    lines = [f"# HELP {fam} {help_txt}", f"# TYPE {fam} {ptype}"]
    for label, value in samples:
        lines.append(f"{fam}{{{label}}} {value:{fmt}}" if label
                     else f"{fam} {value:{fmt}}")
    return lines


def render_family(fam: str, ptype: str, help_txt: str, label: str,
                  value: float, fmt: str = ".3f") -> List[str]:
    """Single-sample shorthand for :func:`render_family_samples`."""

    return render_family_samples(fam, ptype, help_txt,
                                 [(label, value)], fmt)


def atomic_write(path: str, content: Union[str, bytes],
                 mode: int = 0o644) -> None:
    """swp + rename publish (dcgm-exporter:189-193, file_utils.go:10-23).

    Uses a pid+thread-suffixed ``<out>.<pid>.<tid>.swp`` sibling —
    deterministic (no mkstemp probing, which matters at the 100 ms sweep
    floor) yet unique per writer *thread*, so concurrent writers sharing
    an output path (across or within a process) each publish complete
    files instead of interleaving one temp file.  O_EXCL+O_NOFOLLOW
    refuse symlinks planted at the predictable name; if the name is
    nevertheless taken (stale leftover from a crashed run with the same
    pid+tid), fall back to an unpredictable mkstemp name rather than
    unlinking — unlink-and-reuse would let writer B delete writer A's
    in-progress temp and A then publish B's half-written file."""

    path = os.path.abspath(path)
    d = os.path.dirname(path)
    os.makedirs(d, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.swp"
    flags = os.O_WRONLY | os.O_CREAT | os.O_EXCL | _NOFOLLOW
    # binary publish: the sweep loop hands pre-encoded bytes straight
    # through; str callers (tools, tests) pay one utf-8 encode here —
    # computed BEFORE the fd exists so a raise here cannot leak it
    data = content if isinstance(content, bytes) else \
        content.encode("utf-8")  # tpumon-lint: disable=encode-in-hot-path
    try:
        fd = os.open(tmp, flags, mode)
    except FileExistsError:
        fd, tmp = tempfile.mkstemp(prefix=os.path.basename(path) + ".",
                                   suffix=".swp", dir=d)
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
        os.chmod(tmp, mode)  # O_CREAT mode is masked by umask; force it
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def parse_families(text: str) -> Dict[str, int]:  # tpumon-lint: disable=encode-in-hot-path
    """Count samples per family in a rendered sweep (test helper —
    never on the sweep path)."""

    counts: Dict[str, int] = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        name = line.split("{", 1)[0].split(" ", 1)[0]
        counts[name] = counts.get(name, 0) + 1
    return counts
