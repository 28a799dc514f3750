"""Watch / field-group sampling layer.

This re-creates DCGM's core abstraction (reference
``bindings/go/dcgm/fields.go``, ``gpu_group.go``): a *field group* names a set
of metric IDs, a *chip group* names a set of chips, and a *watch* samples the
cross product at a fixed frequency, retaining samples for a bounded age
(``dcgmWatchFields(updateFreq=1e6us, maxKeepAge=300s)``, ``fields.go:12-16,42-60``).

Deliberate departures from the reference:

* **Long-lived watches.** The reference creates and destroys groups per call
  with random names (``device_status.go:115-121``) — noted in SURVEY §3.2 as a
  wart.  Here watches persist and are shared; a second watcher of the same
  (chip, field) pair reuses the stream.
* **Batched reads.** One backend call per sweep covering every due
  (chip, field) pair — against the agent that is a single RPC for the whole
  host, vs the reference's one daemon round trip per field group per call.
* **Integrated event pump.** The same sweep thread polls backend events and
  fans them out to listeners (policy layer), replacing DCGM's internal
  callback thread (``policy.go:164-249``).
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import (Callable, Deque, Dict, List, NamedTuple, Optional,
                    Sequence, Set, Tuple)

from . import log
from .backends.base import Backend, FieldValue
from .events import Event

#: defaults mirroring fields.go:12-16
DEFAULT_UPDATE_FREQ_US = 1_000_000       # 1 Hz
DEFAULT_MAX_KEEP_AGE_S = 300.0           # 5 min retention
DEFAULT_MAX_KEEP_SAMPLES = 0             # 0 = unlimited (age-bounded only)


class Sample(NamedTuple):
    # NamedTuple, not dataclass: one is constructed per (chip, field) per
    # sweep, which makes construction cost part of the 1 Hz CPU budget
    timestamp: float
    value: FieldValue


class FieldGroup:
    """Named set of field IDs (dcgmFieldGroupCreate analog)."""

    _ids = itertools.count(1)

    def __init__(self, field_ids: Sequence[int], name: str = "") -> None:
        self.id = next(FieldGroup._ids)
        self.name = name or f"fieldgroup-{self.id}"
        self.field_ids: Tuple[int, ...] = tuple(int(f) for f in field_ids)


class ChipGroup:
    """Named set of chip indices (dcgmGroupCreate analog)."""

    _ids = itertools.count(1)

    def __init__(self, chip_indices: Sequence[int], name: str = "") -> None:
        self.id = next(ChipGroup._ids)
        self.name = name or f"chipgroup-{self.id}"
        self.chip_indices: Tuple[int, ...] = tuple(int(c) for c in chip_indices)


class _Series:
    """Ring buffer of samples for one (chip, field) key."""

    __slots__ = ("samples", "max_age", "max_samples", "period")

    def __init__(self, max_age: float, max_samples: int,
                 period: float = 0.0) -> None:
        self.samples: Deque[Sample] = deque()
        self.max_age = max_age
        self.max_samples = max_samples
        #: the slowest covering watch's period, s (``latest(fresh=True)``)
        self.period = period

    def add(self, s: Sample) -> None:
        self.samples.append(s)
        if self.max_samples and len(self.samples) > self.max_samples:
            self.samples.popleft()
        cutoff = s.timestamp - self.max_age
        while self.samples and self.samples[0].timestamp < cutoff:
            self.samples.popleft()

    def latest(self) -> Optional[Sample]:
        return self.samples[-1] if self.samples else None

    def since(self, ts: float) -> List[Sample]:
        """Samples with ``timestamp > ts``, oldest first.

        Scans from the RIGHT: callers ask for recent windows (policy
        rate checks, REST tails), so on a 300 s ring this is O(result),
        not O(retained) — a full linear scan per call at the 100 ms
        sweep floor was measurable.  Timestamps are monotone
        non-decreasing within a series (single sweep writer), so the
        first from-the-right sample at or before ``ts`` ends the scan.
        """

        samples = self.samples
        if not samples or samples[0].timestamp > ts:
            return list(samples)  # whole ring qualifies: one C-level copy
        out: List[Sample] = []
        for s in reversed(samples):
            if s.timestamp <= ts:
                break
            out.append(s)
        out.reverse()
        return out


@dataclass
class _Watch:
    chip_group: ChipGroup
    field_group: FieldGroup
    update_freq_us: int
    max_keep_age_s: float
    max_keep_samples: int
    last_sweep: float = 0.0
    active: bool = True


class WatchManager:
    """Owns watches, the sample cache, and the optional sweep thread."""

    def __init__(self, backend: Backend,
                 clock: Optional[Callable[[], float]] = None) -> None:
        self._backend = backend
        self._clock = clock or time.time
        self._lock = threading.RLock()
        self._watches: Dict[int, _Watch] = {}
        self._watch_ids = itertools.count(1)
        self._series: Dict[Tuple[int, int], _Series] = {}
        self._event_listeners: List[Callable[[Event], None]] = []
        self._sweep_listeners: List[Callable[[float], None]] = []
        self._last_event_seq = backend.current_event_seq()
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._sweep_count = 0
        self._sweep_wall_s = 0.0   # cumulative time spent sweeping (introspection)
        # (reqs, watches, min_freq, per-chip series maps) for the
        # wait=True everything-due sweep, rebuilt only when the watch set
        # changes — the exporter hot loop calls update_all(wait=True)
        # every 100 ms with a stable watch set
        self._all_due_cache: Optional[
            Tuple[List[Tuple[int, List[int]]], List["_Watch"], int,
                  Dict[int, Dict[int, _Series]]]] = None

    # -- group management -----------------------------------------------------

    def create_field_group(self, field_ids: Sequence[int],
                           name: str = "") -> FieldGroup:
        return FieldGroup(field_ids, name)

    def create_chip_group(self, chip_indices: Sequence[int],
                          name: str = "") -> ChipGroup:
        return ChipGroup(chip_indices, name)

    def all_chips_group(self, name: str = "all") -> ChipGroup:
        return ChipGroup(self._backend.supported_chips(), name)

    # -- watches --------------------------------------------------------------

    def watch_fields(self, chip_group: ChipGroup, field_group: FieldGroup,
                     update_freq_us: int = DEFAULT_UPDATE_FREQ_US,
                     max_keep_age_s: float = DEFAULT_MAX_KEEP_AGE_S,
                     max_keep_samples: int = DEFAULT_MAX_KEEP_SAMPLES) -> int:
        """Register a watch; returns a watch id (dcgmWatchFields analog)."""

        with self._lock:
            wid = next(self._watch_ids)
            self._watches[wid] = _Watch(chip_group, field_group,
                                        update_freq_us, max_keep_age_s,
                                        max_keep_samples)
            self._all_due_cache = None
            for c in chip_group.chip_indices:
                for f in field_group.field_ids:
                    key = (c, f)
                    if key not in self._series:
                        self._series[key] = _Series(
                            max_keep_age_s, max_keep_samples,
                            update_freq_us / 1e6)
                    else:
                        # widen retention if the new watch wants more
                        # (0 samples = unlimited, so it wins outright)
                        s = self._series[key]
                        s.max_age = max(s.max_age, max_keep_age_s)
                        s.period = max(s.period, update_freq_us / 1e6)
                        if s.max_samples and (
                                not max_keep_samples
                                or max_keep_samples > s.max_samples):
                            s.max_samples = max_keep_samples
            return wid

    def unwatch(self, watch_id: int, purge: bool = False) -> bool:
        """Remove a watch; False when there was none.  With ``purge``, the
        series no remaining watch covers go (their last value is never
        served again) and the rest keep the remaining watches' retention
        and period (the agent's ``unwatch``, ``sampler.hpp``)."""

        with self._lock:
            if self._watches.pop(watch_id, None) is None:
                return False
            self._all_due_cache = None
            if purge:
                bounds: Dict[Tuple[int, int], Tuple[float, float]] = {}
                for w in self._watches.values():
                    for c in w.chip_group.chip_indices:
                        for f in w.field_group.field_ids:
                            age, period = bounds.get((c, f), (0.0, 0.0))
                            bounds[(c, f)] = (
                                max(age, w.max_keep_age_s),
                                max(period, w.update_freq_us / 1e6))
                for key in list(self._series):
                    if key not in bounds:
                        del self._series[key]
                    else:
                        s = self._series[key]
                        s.max_age, s.period = bounds[key]
            return True

    # -- sampling -------------------------------------------------------------

    def update_all(self, wait: bool = True,
                   now: Optional[float] = None,
                   ) -> Dict[int, Dict[int, FieldValue]]:
        """Synchronous sweep of every due watch (dcgmUpdateAllFields analog).

        ``wait=True`` forces all watches due regardless of frequency — the
        sync round-trip semantics of ``fields.go:62-66``.

        Returns the freshly-read snapshot (chip -> field -> value), the
        same values just appended to the series — callers that render
        whole sweeps (the exporter) use it directly instead of re-reading
        every series through :meth:`latest_values`.

        Ownership: the snapshot's per-chip dicts are freshly built per
        call by the backend and never touched again by the watch layer,
        so the caller may keep references across its own render without
        copying (the exporter's per-chip copy-on-write relies on this);
        a caller that mutates them must copy first.
        """

        t = now if now is not None else self._clock()
        t_wall0 = time.monotonic()
        with self._lock:
            cache = self._all_due_cache if wait else None
            if cache is not None:
                reqs, due_watches, min_freq_us, smap = cache
            else:
                # group due reads per chip: one backend call covers all fields
                per_chip: Dict[int, Set[int]] = {}
                due_watches = []
                for w in self._watches.values():
                    if not w.active:
                        continue
                    period = w.update_freq_us / 1e6
                    if wait or t - w.last_sweep >= period:
                        due_watches.append(w)
                        for c in w.chip_group.chip_indices:
                            per_chip.setdefault(c, set()).update(
                                w.field_group.field_ids)
                reqs = [(c, sorted(fids)) for c, fids in per_chip.items()]
                min_freq_us = (min(w.update_freq_us for w in due_watches)
                               if due_watches else 0)
                # per-chip {fid: series} maps: int-keyed gets in the hot
                # loop instead of a tuple alloc + hash per value
                smap = {c: {f: s for f in fids
                            if (s := self._series.get((c, f))) is not None}
                        for c, fids in reqs}
                if wait:
                    self._all_due_cache = (reqs, due_watches, min_freq_us,
                                           smap)
            # accept cached values up to 2x the fastest due period old —
            # fresh enough for every due watch, without live-reading what
            # the agent's own sampler refreshed an instant ago
            max_age = (2.0 * min_freq_us / 1e6 if due_watches else None)
            # events piggyback on the sweep RPC where the backend supports
            # it (events=None means it didn't; poll separately below) —
            # the cursor advance shares the lock with _pump_events so the
            # two paths never double-deliver
            snapshot, events = self._backend.sweep_fields_bulk(
                reqs, now=t, max_age_s=max_age,
                events_since=self._last_event_seq)
            empty: Dict[int, _Series] = {}
            for c, vals in snapshot.items():
                chip_series = smap.get(c, empty)
                cget = chip_series.get
                for fid, v in vals.items():
                    series = cget(fid)
                    if series is not None:
                        series.add(Sample(t, v))
            for w in due_watches:
                w.last_sweep = t
            self._sweep_count += 1
            self._sweep_wall_s += time.monotonic() - t_wall0
            if events:
                self._last_event_seq = max(e.seq for e in events)
                listeners = list(self._event_listeners)
        if events is None:
            self._pump_events()
        elif events:
            for ev in events:
                for fn in listeners:
                    fn(ev)
        for fn in list(self._sweep_listeners):
            fn(t)
        return snapshot

    def _pump_events(self) -> None:
        # claim the cursor range under the lock so concurrent sweeps (user
        # thread + background thread) never deliver the same event twice
        with self._lock:
            events = self._backend.poll_events(self._last_event_seq)
            if not events:
                return
            self._last_event_seq = max(e.seq for e in events)
            listeners = list(self._event_listeners)
        for ev in events:
            for fn in listeners:
                fn(ev)

    # -- queries --------------------------------------------------------------

    def latest(self, chip_index: int, field_id: int,
               fresh: bool = False) -> Optional[Sample]:
        """The newest sample, or None.  With ``fresh``, also None when it
        is older than its retention or twice the slowest covering watch's
        period, whichever is longer (a stalled sweep blanks)."""

        with self._lock:
            s = self._series.get((chip_index, int(field_id)))
            last = s.latest() if s else None
            if fresh and last is not None and last.timestamp < \
                    self._clock() - max(s.max_age, 2.0 * s.period):
                return None
            return last

    def latest_values(self, chip_index: int,
                      field_ids: Sequence[int]) -> Dict[int, FieldValue]:
        """dcgmGetLatestValuesForFields analog: {field_id: value-or-None}."""

        with self._lock:
            out: Dict[int, FieldValue] = {}
            for fid in field_ids:
                s = self._series.get((chip_index, int(fid)))
                latest = s.latest() if s else None
                out[int(fid)] = latest.value if latest else None
            return out

    def samples_since(self, chip_index: int, field_id: int,
                      since: float) -> List[Sample]:
        with self._lock:
            s = self._series.get((chip_index, int(field_id)))
            return s.since(since) if s else []

    # -- event listeners ------------------------------------------------------

    def add_event_listener(self, fn: Callable[[Event], None]) -> None:
        with self._lock:
            self._event_listeners.append(fn)

    def remove_event_listener(self, fn: Callable[[Event], None]) -> None:
        with self._lock:
            if fn in self._event_listeners:
                self._event_listeners.remove(fn)

    def add_sweep_listener(self, fn: Callable[[float], None]) -> None:
        """Called with the sweep timestamp after every update_all round —
        hook for per-sweep evaluation (e.g. policy thresholds)."""

        with self._lock:
            self._sweep_listeners.append(fn)

    # -- background sweep thread ----------------------------------------------

    def start(self, tick_s: Optional[float] = 0.1) -> None:
        """Start the background sweep thread (agent/exporter mode): a
        sweep every ``tick_s``, or with None every quarter of the fastest
        watch's period (0.2 s while there is none)."""

        with self._lock:
            if self._thread is not None:
                return
            self._stop.clear()
            self._thread = threading.Thread(target=self._run,
                                            args=(tick_s,),
                                            name="tpumon-sweep", daemon=True)
            self._thread.start()

    def stop(self) -> None:
        with self._lock:
            th = self._thread
            self._thread = None
        if th is not None:
            self._stop.set()
            th.join(timeout=5.0)

    def _tick(self) -> float:
        with self._lock:
            periods = [w.update_freq_us for w in self._watches.values()
                       if w.active]
        return min(periods) / 4e6 if periods else 0.2

    def _run(self, tick_s: Optional[float]) -> None:
        while not self._stop.wait(tick_s if tick_s is not None
                                  else self._tick()):
            try:
                self.update_all(wait=False)
            except Exception as e:
                # keep the sweep alive on transient errors, but a backend
                # failing every tick must be visible (glog src/main.go:18-33
                # analog), at a bounded rate
                log.warn_every("watch.sweep", 30.0,
                               "watch sweep failed: %r", e)

    # -- introspection --------------------------------------------------------

    def stats(self) -> Dict[str, float]:
        with self._lock:
            return {
                "watches": float(len(self._watches)),
                "series": float(len(self._series)),
                "sweeps": float(self._sweep_count),
                "sweep_wall_s": self._sweep_wall_s,
            }
