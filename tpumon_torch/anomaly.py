"""Streaming anomaly detection over the incremental sweep path.

The port's copy of ``tpumon/anomaly.py``, with imports renamed: the
in-process detection plane of the exporter daemon (``--rules``).
Per-(chip, field) streaming detectors ride the sweep's change stream,
cross-signal incident rules join value anomalies with kernel-log
evidence, and one code path serves live detection and recorded-history
backtesting (``python -m tpumon_torch.cli.replay --backtest``).

Design constraints, in order:

* **Changed values only.**  :meth:`AnomalyEngine.observe` keeps the
  same (type, value) identity table the delta codec keeps, restricted
  to the fields rules actually name — a value that did not change is
  never re-scored, and ``unchanged=True`` scores **zero** series.
* **One code path, live and replayed.**  The engine never reads a
  clock: every ``observe``/``observe_kmsg`` call carries the sweep's
  wall timestamp — the same stamp the flight recorder writes — so a
  backtest feeding recorded ticks through the SAME engine produces the
  identical verdict sequence (timestamps, evidence, order) the live
  engine emitted.
* **Declarative, versioned rules.**  ``rules.yaml`` (parsed by
  :mod:`tpumon_torch.simple_yaml`) declares per-series detectors —
  ``threshold``, ``ewma_z`` (EWMA mean/variance z-score),
  ``rate_of_change``, ``flatline`` (stuck-at) — and cross-signal
  ``incidents`` whose requirements (named anomalies, kmsg-classified
  event types, raw kmsg substrings) must co-occur inside a time window.

What differs from the reference: kernel-log lines are classified by the
port's ``NVRM: Xid`` table (:func:`tpumon_torch.kmsg.classify_line`)
with the GPU bus map the engine is given (``buses``), so event evidence
names the card (``#chip0``); and the fleet shard's synthetic ``SF_*``
fields are not known (the port has no fleet plane).

Findings are :class:`~tpumon_torch.blackbox.AnomalyRecord` values — the
exact record type the black box persists (0xB3).
"""

from __future__ import annotations

import heapq
import math
from dataclasses import dataclass
from typing import (Any, Dict, Iterable, List, Mapping, Optional,
                    Sequence, Set, Tuple, Union)

from . import fields as FF
from .backends.base import FieldValue
from .blackbox import AnomalyRecord, _SEVERITIES
from .events import Event, EventType
from .kmsg import BusKey, classify_line

RULES_VERSION = 1

#: detector types the rules schema accepts
DETECTOR_TYPES = ("threshold", "ewma_z", "rate_of_change", "flatline")
# _SEVERITIES comes from the blackbox module — the tuple also defines the
# 0xB3 wire codes, and a drifted copy here would validate severities
# the codec silently records as "warning"

#: the ``tpumon_anomaly_*`` / ``tpumon_incident_*`` self-metric
#: families — the single registration the exporter emits from
METRIC_FAMILIES: List[Tuple[str, str, str]] = [
    ("tpumon_anomaly_findings_total", "counter",
     "Anomaly firings per detector rule since start (label: rule)."),
    ("tpumon_anomaly_cleared_total", "counter",
     "Anomaly clear transitions per detector rule since start "
     "(label: rule)."),
    ("tpumon_anomaly_active", "gauge",
     "Series currently in the firing state per detector rule "
     "(label: rule)."),
    ("tpumon_anomaly_series_tracked", "gauge",
     "Distinct (chip, field) series the detection plane tracks."),
    ("tpumon_anomaly_scored_total", "counter",
     "Series scorings performed since start (changed values only — "
     "an index-only steady tick scores zero)."),
    ("tpumon_incident_findings_total", "counter",
     "Cross-signal incident firings per incident rule since start "
     "(label: rule)."),
    ("tpumon_incident_suppressed_total", "counter",
     "Incident firings suppressed by the per-rule cooldown since "
     "start (label: rule)."),
]


def resolve_field(spec: Union[int, str]) -> int:
    """Field id from a rules-file spec: a plain int, an ``F`` member
    name (``HBM_BW_UTIL``), or a catalog short/Prometheus name
    (``hbmbw`` / ``tpu_hbm_bw_utilization``)."""

    if isinstance(spec, int):
        return spec
    s = str(spec).strip()
    try:
        return int(s, 0)
    except ValueError:
        pass
    try:
        return int(FF.F[s])
    except KeyError:
        pass
    m = FF.by_name(s)
    if m is not None:
        return m.field_id
    raise ValueError(f"unknown field {spec!r} in rules")


def field_name(fid: int) -> str:
    """Display name for a field id (catalog short name, else the
    number)."""

    meta = FF.CATALOG.get(fid)
    if meta is not None:
        return meta.name
    return str(fid)


@dataclass(frozen=True)
class DetectorRule:
    """One per-series detector, as declared in ``rules.yaml``."""

    name: str
    fid: int
    dtype: str                       # one of DETECTOR_TYPES
    severity: str = "warning"
    # threshold
    above: Optional[float] = None
    below: Optional[float] = None
    # ewma_z
    z: float = 4.0
    alpha: float = 0.3
    min_samples: int = 5
    # rate_of_change: per-second forms divide by the wall time since
    # the series LAST changed (right for fields that churn every
    # sweep); absolute forms bound the step itself, however long the
    # value sat still first (right for delta streams, where a cliff
    # after a quiet hour is still a cliff)
    max_rise_per_s: Optional[float] = None
    max_drop_per_s: Optional[float] = None
    max_rise: Optional[float] = None
    max_drop: Optional[float] = None
    # flatline
    for_s: float = 10.0

    #: every key the schema accepts — an unknown key is a typo'd
    #: tuning knob that would otherwise run silently on defaults
    #: (manifest typos fail fast, the tpumon-check convention)
    _KEYS = frozenset({
        "name", "field", "type", "severity", "above", "below", "z",
        "alpha", "min_samples", "max_rise_per_s", "max_drop_per_s",
        "max_rise", "max_drop", "for_s"})

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "DetectorRule":
        name = str(d.get("name") or "")
        if not name:
            raise ValueError("detector without a name")
        unknown = sorted(set(d) - cls._KEYS)
        if unknown:
            raise ValueError(
                f"detector {name!r}: unknown key(s) {unknown} — a "
                f"misspelled knob would silently run on defaults")
        dtype = str(d.get("type") or "")
        if dtype not in DETECTOR_TYPES:
            raise ValueError(
                f"detector {name!r}: unknown type {dtype!r} "
                f"(one of {', '.join(DETECTOR_TYPES)})")
        if "field" not in d:
            raise ValueError(f"detector {name!r}: missing field")
        severity = str(d.get("severity", "warning"))
        if severity not in _SEVERITIES:
            raise ValueError(
                f"detector {name!r}: unknown severity {severity!r}")
        rule = cls(
            name=name, fid=resolve_field(d["field"]), dtype=dtype,
            severity=severity,
            above=_opt_float(d.get("above")),
            below=_opt_float(d.get("below")),
            z=float(d.get("z", 4.0)),
            alpha=float(d.get("alpha", 0.3)),
            min_samples=int(d.get("min_samples", 5)),
            max_rise_per_s=_opt_float(d.get("max_rise_per_s")),
            max_drop_per_s=_opt_float(d.get("max_drop_per_s")),
            max_rise=_opt_float(d.get("max_rise")),
            max_drop=_opt_float(d.get("max_drop")),
            for_s=float(d.get("for_s", 10.0)))
        if dtype == "threshold" and rule.above is None \
                and rule.below is None:
            raise ValueError(
                f"detector {name!r}: threshold needs above/below")
        if dtype == "rate_of_change" and rule.max_rise_per_s is None \
                and rule.max_drop_per_s is None \
                and rule.max_rise is None and rule.max_drop is None:
            raise ValueError(
                f"detector {name!r}: rate_of_change needs one of "
                f"max_rise[_per_s]/max_drop[_per_s]")
        if dtype == "ewma_z" and not 0.0 < rule.alpha < 1.0:
            # alpha=1 would zero the EW variance identically — a rule
            # that validates but can never fire is worse than an error
            raise ValueError(f"detector {name!r}: alpha out of (0, 1)")
        if dtype == "flatline" and rule.for_s <= 0.0:
            raise ValueError(f"detector {name!r}: for_s must be > 0")
        return rule


#: requirement kinds an incident rule may join on
_REQ_KINDS = ("anomaly", "event", "kmsg")


@dataclass(frozen=True)
class IncidentRule:
    """One cross-signal rule: every requirement seen within
    ``window_s`` of each other ⇒ one incident with the evidence."""

    name: str
    require: Tuple[Tuple[str, str], ...]   # (kind, key) pairs
    window_s: float = 5.0
    cooldown_s: float = 0.0                # 0 -> window_s
    severity: str = "critical"

    _KEYS = frozenset({"name", "require", "window_s", "cooldown_s",
                       "severity"})

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "IncidentRule":
        name = str(d.get("name") or "")
        if not name:
            raise ValueError("incident without a name")
        unknown = sorted(set(d) - cls._KEYS)
        if unknown:
            raise ValueError(
                f"incident {name!r}: unknown key(s) {unknown} — a "
                f"misspelled knob would silently run on defaults")
        raw = d.get("require")
        if not isinstance(raw, list) or not raw:
            raise ValueError(f"incident {name!r}: require must be a "
                             f"non-empty list")
        reqs: List[Tuple[str, str]] = []
        for item in raw:
            if not isinstance(item, Mapping) or len(item) != 1:
                raise ValueError(
                    f"incident {name!r}: each require entry is one "
                    f"'{'|'.join(_REQ_KINDS)}: key' mapping")
            kind = str(next(iter(item)))
            key = item[kind]
            if kind not in _REQ_KINDS:
                raise ValueError(
                    f"incident {name!r}: unknown require kind "
                    f"{kind!r}")
            if kind == "event" and str(key) not in \
                    EventType.__members__:
                raise ValueError(
                    f"incident {name!r}: unknown event type {key!r}")
            reqs.append((str(kind), str(key)))
        severity = str(d.get("severity", "critical"))
        if severity not in _SEVERITIES:
            raise ValueError(
                f"incident {name!r}: unknown severity {severity!r}")
        window = float(d.get("window_s", 5.0))
        if window <= 0.0:
            raise ValueError(f"incident {name!r}: window_s must be > 0")
        cooldown = float(d.get("cooldown_s", 0.0))
        if cooldown < 0.0:
            # a negative cooldown would be truthy and disable
            # suppression entirely — every evidence arrival would
            # fire a fresh incident
            raise ValueError(f"incident {name!r}: cooldown_s must "
                             f"be >= 0")
        return cls(name=name, require=tuple(reqs), window_s=window,
                   cooldown_s=cooldown, severity=severity)


def _opt_float(v: Any) -> Optional[float]:
    return None if v is None else float(v)


@dataclass(frozen=True)
class Rules:
    """One parsed, versioned rule set."""

    detectors: Tuple[DetectorRule, ...]
    incidents: Tuple[IncidentRule, ...]
    version: int = RULES_VERSION

    @classmethod
    def from_dict(cls, data: Mapping[str, Any]) -> "Rules":
        unknown = sorted(set(data) - {"version", "detectors",
                                      "incidents"})
        if unknown:
            raise ValueError(f"unknown top-level key(s) {unknown}")
        version = data.get("version")
        if version != RULES_VERSION:
            raise ValueError(
                f"rules version {version!r} unsupported (this build "
                f"speaks version {RULES_VERSION}; the field is "
                f"mandatory so a future schema can never be silently "
                f"misread)")
        detectors = tuple(DetectorRule.from_dict(d)
                          for d in list(data.get("detectors") or []))
        incidents = tuple(IncidentRule.from_dict(d)
                          for d in list(data.get("incidents") or []))
        if not detectors and not incidents:
            raise ValueError("rules declare no detectors and no "
                             "incidents")
        seen: Set[str] = set()
        for r in detectors:
            if r.name in seen:
                raise ValueError(f"duplicate rule name {r.name!r}")
            seen.add(r.name)
        for i in incidents:
            if i.name in seen:
                raise ValueError(f"duplicate rule name {i.name!r}")
            seen.add(i.name)
            for kind, key in i.require:
                if kind == "anomaly" and key not in {
                        r.name for r in detectors}:
                    raise ValueError(
                        f"incident {i.name!r} requires unknown "
                        f"anomaly {key!r}")
        return cls(detectors=detectors, incidents=incidents,
                   version=RULES_VERSION)


def load_rules(path: str) -> Rules:
    """Parse one ``rules.yaml`` (the YAML-subset loader — plain YAML,
    no YAML package needed)."""

    from .simple_yaml import parse_simple_yaml

    with open(path) as f:
        data = parse_simple_yaml(f.read())
    if not isinstance(data, dict):
        raise ValueError(f"{path}: rules must be a mapping")
    try:
        return Rules.from_dict(data)
    except ValueError as e:
        raise ValueError(f"{path}: {e}") from None


# -- engine --------------------------------------------------------------------


class _Series:
    """Per-(chip, fid, detector) streaming state."""

    __slots__ = ("active", "n", "mean", "var", "prev", "prev_ts",
                 "armed")

    def __init__(self) -> None:
        self.active = False
        self.n = 0            # ewma_z samples folded
        self.mean = 0.0
        self.var = 0.0
        self.prev: Optional[float] = None   # last numeric value
        self.prev_ts = 0.0                  # its timestamp
        self.armed = False    # flatline: a heap deadline is queued


class _IncidentState:
    __slots__ = ("seen", "last_fire")

    def __init__(self) -> None:
        #: require index -> (timestamp, evidence string) of the most
        #: recent matching signal
        self.seen: Dict[int, Tuple[float, str]] = {}
        self.last_fire = -math.inf


_MISSING = object()


class AnomalyEngine:
    """The streaming detection plane: one engine per monitored stream
    (one exporter, one replayed recording).

    Single-owner by design: every call carries the sweep's wall
    timestamp, state lives in plain dicts, and the score path takes no
    lock and makes no syscall.  Callers on multi-threaded planes queue
    into the owner thread (the exporter drains its kmsg queue on the
    sweep thread).

    ``buses`` maps a GPU's PCI bus key to the index its backend serves
    (the NVML backend's ``bus_index()``): kmsg lines classified through
    it name the card in their evidence, and a backtest given the same
    map re-derives the same evidence.
    """

    def __init__(self, rules: Rules,
                 buses: Optional[Mapping[BusKey, int]] = None) -> None:
        self.rules = rules
        self._buses = dict(buses or {})
        #: fid -> [(detector index, rule)] — the only fields the
        #: change scan ever looks at
        self._by_fid: Dict[int, List[Tuple[int, DetectorRule]]] = {}
        for di, r in enumerate(rules.detectors):
            self._by_fid.setdefault(r.fid, []).append((di, r))
        #: (chip, fid) -> last (type, value) identity seen — the
        #: engine's own delta table, restricted to ruled fields
        self._last: Dict[Tuple[int, int], FieldValue] = {}
        #: (chip, fid) -> wall ts of the last identity change
        self._last_change: Dict[Tuple[int, int], float] = {}
        #: (chip, fid, detector index) -> streaming state
        self._series: Dict[Tuple[int, int, int], _Series] = {}
        #: armed flatline deadlines: (deadline, chip, fid, det index)
        self._flat_heap: List[Tuple[float, int, int, int]] = []
        #: incident rule index -> join state
        self._inc_state = [_IncidentState() for _ in rules.incidents]
        #: evidence routing: key -> [(incident idx, require idx)]
        self._ev_anomaly: Dict[str, List[Tuple[int, int]]] = {}
        self._ev_event: Dict[str, List[Tuple[int, int]]] = {}
        #: kmsg substring requires, scanned per kmsg line only
        self._ev_kmsg: List[Tuple[str, int, int]] = []
        for ii, inc in enumerate(rules.incidents):
            for ri, (kind, key) in enumerate(inc.require):
                if kind == "anomaly":
                    self._ev_anomaly.setdefault(key, []).append((ii, ri))
                elif kind == "event":
                    self._ev_event.setdefault(key, []).append((ii, ri))
                else:
                    self._ev_kmsg.append((key, ii, ri))
        # -- counters (the tpumon_anomaly_*/tpumon_incident_* families)
        self.findings_total: Dict[str, int] = {
            r.name: 0 for r in rules.detectors}
        self.cleared_total: Dict[str, int] = {
            r.name: 0 for r in rules.detectors}
        self.incidents_total: Dict[str, int] = {
            i.name: 0 for i in rules.incidents}
        self.suppressed_total: Dict[str, int] = {
            i.name: 0 for i in rules.incidents}
        self.active: Dict[str, int] = {
            r.name: 0 for r in rules.detectors}
        self.scored_total = 0
        #: series scored by the LAST observe() call — the bench gate:
        #: exactly 0 on an index-only tick
        self.last_scored = 0
        self.ticks_total = 0

    # -- the hot path ---------------------------------------------------------

    def observe(self, chips: Mapping[int, Mapping[int, FieldValue]],
                now: float,
                events: Optional[Sequence[Event]] = None,
                unchanged: bool = False) -> List[AnomalyRecord]:
        """Score one sweep; returns the findings it fired (often
        empty).  ``now`` is the sweep's wall timestamp — the exact
        stamp the flight recorder writes, so backtest re-derives
        identical verdicts.  ``unchanged=True`` (the index-only
        steady shortcut) skips the change scan entirely: zero series
        are re-scored, only due flatline deadlines and the event
        drain run."""

        out: List[AnomalyRecord] = []
        scored = 0
        self.ticks_total += 1
        if not unchanged:
            by_fid = self._by_fid
            last = self._last
            last_change = self._last_change
            for chip, vals in chips.items():
                for fid, rules_for in by_fid.items():
                    if fid not in vals:
                        continue
                    v = vals[fid]
                    key = (chip, fid)
                    prev = last.get(key, _MISSING)
                    if prev is not _MISSING and _same_identity(prev, v):
                        continue
                    # changed (or first) value: this is the ONLY point
                    # a series is ever scored
                    last[key] = v
                    last_change[key] = now
                    for di, rule in rules_for:
                        scored += 1
                        self._score(chip, fid, di, rule, v, now, out)
        self.last_scored = scored
        self.scored_total += scored
        if self._flat_heap:
            self._pop_flatlines(now, out)
        for e in events or ():
            routes = self._ev_event.get(e.etype.name)
            if routes:
                self._evidence(
                    routes, e.timestamp,
                    f"event:{e.etype.name}@{e.timestamp:.3f}"
                    + (f"#chip{e.chip_index}" if e.chip_index >= 0
                       else ""),
                    now, out)
        return out

    def observe_kmsg(self, line: str, now: float) -> List[AnomalyRecord]:
        """Feed one raw kernel-log line: classified through the SAME
        pattern table the kmsg watcher uses (:func:`tpumon_torch.kmsg.
        classify_line`, with the engine's bus map) into event evidence,
        plus any raw-substring requirements.  ``now`` is the line's
        recorded/observed wall stamp."""

        out: List[AnomalyRecord] = []
        classified = classify_line(line, self._buses)
        if classified is not None:
            etype, chip = classified
            routes = self._ev_event.get(etype.name)
            if routes:
                self._evidence(
                    routes, now,
                    f"event:{etype.name}@{now:.3f}"
                    + (f"#chip{chip}" if chip >= 0 else ""),
                    now, out)
        for sub, ii, ri in self._ev_kmsg:
            if sub in line:
                self._evidence([(ii, ri)], now,
                               f"kmsg:{sub}@{now:.3f}", now, out)
        return out

    # -- detectors ------------------------------------------------------------

    def _score(self, chip: int, fid: int, di: int, rule: DetectorRule,
               v: FieldValue, now: float,
               out: List[AnomalyRecord]) -> None:
        key = (chip, fid, di)
        s = self._series.get(key)
        if s is None:
            s = self._series[key] = _Series()
        dtype = rule.dtype
        if dtype == "flatline":
            # a change CLEARS a flatline; at most ONE deadline per
            # series lives in the heap (a churning series must not
            # queue one tuple per change — a stale pop re-arms from
            # the true last-change time instead)
            if s.active:
                s.active = False
                self._emit(rule, chip, fid, None, None, now, out,
                           state="cleared",
                           message=f"{field_name(fid)} moving again")
            if not s.armed:
                s.armed = True
                heapq.heappush(self._flat_heap,
                               (now + rule.for_s, chip, fid, di))
            return
        num = v if isinstance(v, (int, float)) \
            and not isinstance(v, bool) else None
        if num is None or num != num:
            # blank / non-numeric / NaN: not scoreable — treat as a
            # clear (the series left the regime the rule reasons about)
            if s.active:
                s.active = False
                self._emit(rule, chip, fid, None, None, now, out,
                           state="cleared",
                           message=f"{field_name(fid)} went blank")
            s.prev = None
            return
        val = float(num)
        firing = False
        score: Optional[float] = None
        message = ""
        if dtype == "threshold":
            if rule.above is not None and val > rule.above:
                firing = True
                message = (f"{field_name(fid)}={_fmt(val)} above "
                           f"{_fmt(rule.above)}")
            elif rule.below is not None and val < rule.below:
                firing = True
                message = (f"{field_name(fid)}={_fmt(val)} below "
                           f"{_fmt(rule.below)}")
        elif dtype == "ewma_z":
            if s.n >= rule.min_samples and s.var > 0.0:
                score = (val - s.mean) / math.sqrt(s.var)
                if abs(score) >= rule.z:
                    firing = True
                    message = (f"{field_name(fid)}={_fmt(val)} is "
                               f"{score:+.1f} sigma from EWMA "
                               f"{_fmt(s.mean)}")
            # fold AFTER scoring: a spike must not dilute itself
            d = val - s.mean
            incr = rule.alpha * d
            s.mean += incr
            s.var = (1.0 - rule.alpha) * (s.var + d * incr)
            s.n += 1
        elif dtype == "rate_of_change":
            if s.prev is not None and now > s.prev_ts:
                delta = val - s.prev
                rate = delta / (now - s.prev_ts)
                score = rate
                if rule.max_rise_per_s is not None \
                        and rate > rule.max_rise_per_s:
                    firing = True
                    message = (f"{field_name(fid)} rose "
                               f"{_fmt(rate)}/s (limit "
                               f"{_fmt(rule.max_rise_per_s)}/s)")
                elif rule.max_drop_per_s is not None \
                        and -rate > rule.max_drop_per_s:
                    firing = True
                    message = (f"{field_name(fid)} dropped "
                               f"{_fmt(-rate)}/s (limit "
                               f"{_fmt(rule.max_drop_per_s)}/s)")
                elif rule.max_rise is not None \
                        and delta > rule.max_rise:
                    firing = True
                    score = delta
                    message = (f"{field_name(fid)} jumped "
                               f"+{_fmt(delta)} (limit "
                               f"{_fmt(rule.max_rise)})")
                elif rule.max_drop is not None \
                        and -delta > rule.max_drop:
                    firing = True
                    score = delta
                    message = (f"{field_name(fid)} fell "
                               f"{_fmt(delta)} (limit "
                               f"{_fmt(rule.max_drop)})")
            s.prev = val
            s.prev_ts = now
        if firing and not s.active:
            s.active = True
            self._emit(rule, chip, fid, val, score, now, out,
                       state="firing", message=message)
        elif not firing and s.active:
            s.active = False
            self._emit(rule, chip, fid, val, score, now, out,
                       state="cleared",
                       message=f"{field_name(fid)}={_fmt(val)} back "
                               f"in range")

    def _pop_flatlines(self, now: float,
                       out: List[AnomalyRecord]) -> None:
        heap = self._flat_heap
        while heap and heap[0][0] <= now:
            _deadline, chip, fid, di = heapq.heappop(heap)
            rule = self.rules.detectors[di]
            s = self._series.get((chip, fid, di))
            if s is not None:
                s.armed = False
            changed_at = self._last_change.get((chip, fid))
            if changed_at is None or s is None:
                continue
            if now - changed_at < rule.for_s:
                # the series moved since this deadline was queued:
                # re-arm from the TRUE last-change time (still the
                # one live entry for this series)
                s.armed = True
                heapq.heappush(heap,
                               (changed_at + rule.for_s, chip, fid, di))
                continue
            if s.active:
                continue
            s.active = True
            self._emit(rule, chip, fid, None, now - changed_at, now,
                       out, state="firing",
                       message=f"{field_name(fid)} stuck for "
                               f"{now - changed_at:.1f}s")

    # -- emission + incident join ---------------------------------------------

    def _emit(self, rule: DetectorRule, chip: int, fid: int,
              value: Optional[float], score: Optional[float],
              now: float, out: List[AnomalyRecord], *, state: str,
              message: str) -> None:
        rec = AnomalyRecord(
            timestamp=now, kind="anomaly", rule=rule.name,
            severity=rule.severity, state=state, chip=chip, field=fid,
            value=value, score=score, message=message)
        out.append(rec)
        if state == "firing":
            self.findings_total[rule.name] += 1
            self.active[rule.name] += 1
            routes = self._ev_anomaly.get(rule.name)
            if routes:
                self._evidence(
                    routes, now,
                    f"anomaly:{rule.name}@{now:.3f}#chip{chip}",
                    now, out)
        else:
            self.cleared_total[rule.name] += 1
            if self.active[rule.name] > 0:
                self.active[rule.name] -= 1

    def _evidence(self, routes: Iterable[Tuple[int, int]], ev_ts: float,
                  ev_str: str, now: float,
                  out: List[AnomalyRecord]) -> None:
        """One signal landed: update the incident joins it feeds and
        fire any rule whose whole requirement set now co-occurs
        within its window."""

        for ii, ri in routes:
            inc = self.rules.incidents[ii]
            st = self._inc_state[ii]
            st.seen[ri] = (ev_ts, ev_str)
            if len(st.seen) < len(inc.require):
                continue
            stamps = [t for t, _ in st.seen.values()]
            if max(stamps) - min(stamps) > inc.window_s:
                continue
            cooldown = inc.cooldown_s or inc.window_s
            if now - st.last_fire < cooldown:
                self.suppressed_total[inc.name] += 1
                continue
            st.last_fire = now
            self.incidents_total[inc.name] += 1
            evidence = tuple(s for _, s in sorted(
                st.seen.values()))
            out.append(AnomalyRecord(
                timestamp=now, kind="incident", rule=inc.name,
                severity=inc.severity, state="firing",
                message=f"{len(inc.require)} signals within "
                        f"{inc.window_s:g}s",
                evidence=evidence))

    # -- introspection --------------------------------------------------------

    def stats(self) -> Dict[str, Any]:
        """Counter snapshot for the metric families and the CLIs."""

        return {
            "findings_total": dict(self.findings_total),
            "cleared_total": dict(self.cleared_total),
            "incidents_total": dict(self.incidents_total),
            "suppressed_total": dict(self.suppressed_total),
            "active": dict(self.active),
            "series_tracked": len(self._series),
            "scored_total": self.scored_total,
            "last_scored": self.last_scored,
            "ticks_total": self.ticks_total,
        }


def _same_identity(prev: object, v: FieldValue) -> bool:
    """The codec's (type, value) identity convention (``1`` vs ``1.0``
    are different wire values; lists compare by contents AND element
    types, never object identity)."""

    if prev is v:
        return True
    if prev.__class__ is not v.__class__:
        return False
    if isinstance(v, list) and isinstance(prev, list):
        return prev == v and all(a.__class__ is b.__class__
                                 for a, b in zip(prev, v))
    return bool(prev == v)


def _fmt(v: float) -> str:
    return f"{v:g}"


# -- backtest ------------------------------------------------------------------


@dataclass
class BacktestResult:
    """One backtest run's verdicts + the engine that produced them."""

    verdicts: List[AnomalyRecord]
    ticks: int
    kmsg_lines: int
    engine: AnomalyEngine

    def summary(self) -> Dict[str, Any]:
        st = self.engine.stats()
        fired = {r: n for r, n in st["findings_total"].items() if n}
        incidents = {r: n for r, n in st["incidents_total"].items()
                     if n}
        silent = sorted(
            [r for r, n in st["findings_total"].items() if not n]
            + [r for r, n in st["incidents_total"].items() if not n])
        return {
            "ticks": self.ticks,
            "kmsg_lines": self.kmsg_lines,
            "verdicts": len(self.verdicts),
            "fired": fired,
            "incidents": incidents,
            "suppressed": {r: n for r, n in
                           st["suppressed_total"].items() if n},
            "silent_rules": silent,
        }


def backtest(reader: Any, rules: Rules,
             since: Optional[float] = None,
             until: Optional[float] = None,
             buses: Optional[Mapping[BusKey, int]] = None,
             ) -> BacktestResult:
    """Replay a recorded window through a fresh engine — the SAME code
    path live detection runs, fed the recorded timestamps, so the
    verdict sequence is what the live engine would have emitted (and
    did emit, if it was running: recorded 0xB3 findings are skipped
    here, not re-fed — the backtest re-derives them).

    ``reader`` is a :class:`~tpumon_torch.blackbox.BlackBoxReader`
    (typed loosely so test doubles can stand in); ``buses`` is the live
    engine's bus map."""

    from .blackbox import KmsgRecord, ReplayTick

    engine = AnomalyEngine(rules, buses)
    verdicts: List[AnomalyRecord] = []
    ticks = 0
    kmsg_lines = 0
    for item in reader.replay(since, until):
        if isinstance(item, ReplayTick):
            ticks += 1
            verdicts += engine.observe(
                item.snapshot, now=item.timestamp, events=item.events,
                unchanged=item.changes == 0 and not item.events)
        elif isinstance(item, KmsgRecord):
            kmsg_lines += 1
            verdicts += engine.observe_kmsg(item.line,
                                            now=item.timestamp)
        # AnomalyRecord items are the LIVE engine's recorded verdicts:
        # deliberately not re-fed — this run re-derives its own
    return BacktestResult(verdicts=verdicts, ticks=ticks,
                          kmsg_lines=kmsg_lines, engine=engine)
