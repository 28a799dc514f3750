"""High-rate burst sampling: windowed accumulators folded into the 1 Hz sweep.

The port's copy of ``tpumon/burst.py``, with imports renamed.  1 Hz
polling aliases away sub-second power and utilization transients.  Burst
mode samples a declared cheap-counter subset (``fields.BURST_SOURCE_FIELDS``:
power 155, utilization 203, memory utilization 204, 206) at 50-100 Hz
into per-(chip, field) min/max/mean/time-integral accumulators and folds
the result into the normal 1 Hz sweep as derived fields
(``fields.burst_id``), so the wire format is untouched and unchanged
accumulator values delta away for free.

Fold semantics (the reference's, unchanged):

* every sample is folded as a double, in arrival order;
* non-finite samples (NaN/inf) are discarded entirely — no stat update,
  no anchor update;
* the time integral is left-rectangle: each sample adds
  ``prev_value * (t - prev_t)``; the anchor ``(prev_t, prev_value)``
  persists across harvests so consecutive windows' integrals sum to the
  total integral (the first sample ever contributes no area);
* ``harvest`` resets count/min/max/sum/integral and keeps the anchor;
  a window with zero samples yields nothing for that (chip, field);
* emitted values follow the wire number convention
  (:func:`wire_number`): a finite integral double below
  ``NUM_INT_LIMIT`` materializes as ``int``.

:class:`BurstAccumulator` is a facade, as in the reference: the port's
native codec extension (:mod:`tpumon_torch._codec`, ``native/codec/``
``BurstCore``) backs it when loaded, the pure-Python
:class:`PyBurstAccumulator` otherwise.  ``tests/test_torch_burst.py``
holds the Python fold byte-identical to the JAX package's through the
sweep-frame codec, ``tests/test_torch_codec_native.py`` the native one.

:class:`BurstSampler` is the inner-loop thread the exporter starts over
the NVML backend (``--burst-hz``).  Handoff contract: the inner loop
folds lock-free into the current accumulator, holding a burst-scoped
seqlock (``_fold_seq`` odd while folding); ``harvest_if_due`` (sweep
thread) swaps a fresh accumulator in, waits out the one in-flight fold
burst (seq even = the swapped-out accumulator is quiescent — any later
burst reads the new one), then harvests tear-free.  A wedged producer
forfeits the window (the previous harvest is served) rather than risking
a torn one.
"""

from __future__ import annotations

import math
import threading
import time
from typing import (Any, Callable, Dict, Optional, Sequence, Tuple, Union,
                    cast)

from . import _codec
from . import fields as FF
from .backends.base import FieldValue
from .sweepframe import NUM_INT_LIMIT

_INF = float("inf")
_NEG_INF = float("-inf")


def wire_number(v: float) -> Union[int, float]:
    """The shared number convention (``sweepframe.NUM_INT_LIMIT``): a
    finite integral double below the limit materializes as ``int``,
    everything else stays ``float``.  Non-finite values pass through as
    floats — samples are individually finite, but a sum/integral can
    still overflow to inf (and inf-inf to NaN); the codec blanks
    non-finite floats on the wire."""


    if v != v or v == _INF or v == _NEG_INF:
        return v
    if v == math.floor(v) and abs(v) < NUM_INT_LIMIT:
        return int(v)
    return v


class BurstWindow:
    """One (chip, field) accumulator cell.  Plain attributes, no locks:
    the single producer folds, the harvester reads-and-resets — see the
    module docstring for the handoff contract."""

    __slots__ = ("count", "vmin", "vmax", "vsum", "integral",
                 "anchor_t", "anchor_v")

    def __init__(self) -> None:
        self.count = 0
        self.vmin = 0.0
        self.vmax = 0.0
        self.vsum = 0.0
        self.integral = 0.0
        #: integration anchor — persists across harvests so window
        #: integrals tile the total integral
        self.anchor_t: Optional[float] = None
        self.anchor_v = 0.0




class PyBurstAccumulator:
    """Per-(chip, field) windowed min/max/mean/time-integral fold (the
    reference's pure-Python accumulator)."""

    def __init__(self) -> None:
        self._windows: Dict[Tuple[int, int], BurstWindow] = {}

    # tpumon: thread-ok(accumulator handoff — a sampler's live accumulator is folded only by its producer thread and harvested only after the swap, once BurstSampler.harvest_if_due has waited out the in-flight fold; the consumer touches the fresh one only to seed anchors of cells the producer has not folded, and every other instance is local to one call)
    def fold(self, chip: int, fid: int, t: float, v: float) -> None:
        """Fold one sample — semantically ``fold_series`` with one
        element, kept separate so the live sampler thread pays no
        batch setup per inner tick."""

        v = float(v)
        if v != v or v == _INF or v == _NEG_INF:
            return
        w = self._windows.get((chip, fid))
        if w is None:
            w = self._windows[(chip, fid)] = BurstWindow()
        at = w.anchor_t
        if at is not None and t > at:
            w.integral += w.anchor_v * (t - at)
        w.anchor_t = t
        w.anchor_v = v
        if w.count:
            if v < w.vmin:
                w.vmin = v
            if v > w.vmax:
                w.vmax = v
        else:
            w.vmin = w.vmax = v
        w.vsum += v
        w.count += 1

    # tpumon: thread-ok(accumulator handoff — a sampler's live accumulator is folded only by its producer thread and harvested only after the swap, once BurstSampler.harvest_if_due has waited out the in-flight fold; the consumer touches the fresh one only to seed anchors of cells the producer has not folded, and every other instance is local to one call)
    def fold_series(self, chip: int, fid: int, ts: Sequence[float],
                    vs: Sequence[FieldValue]) -> None:
        """Fold a batch of samples for one (chip, field) — the
        optimized inner loop (locals only, one dict lookup per batch);
        semantics identical to calling :meth:`fold` per sample."""

        w = self._windows.get((chip, fid))
        if w is None:
            w = self._windows[(chip, fid)] = BurstWindow()
        count = w.count
        vmin = w.vmin
        vmax = w.vmax
        vsum = w.vsum
        integral = w.integral
        at = w.anchor_t
        av = w.anchor_v
        for t, raw in zip(ts, vs):
            if raw is None or isinstance(raw, (str, list)):
                continue  # non-numeric sample: discarded like non-finite
            v = float(raw)
            if v != v or v == _INF or v == _NEG_INF:
                continue
            if at is not None and t > at:
                integral += av * (t - at)
            at = t
            av = v
            if count:
                if v < vmin:
                    vmin = v
                if v > vmax:
                    vmax = v
            else:
                vmin = vmax = v
            vsum += v
            count += 1
        w.count = count
        w.vmin = vmin
        w.vmax = vmax
        w.vsum = vsum
        w.integral = integral
        w.anchor_t = at
        w.anchor_v = av

    def entries(self) -> int:
        return len(self._windows)

    # tpumon: thread-ok(accumulator handoff — a sampler's live accumulator is folded only by its producer thread and harvested only after the swap, once BurstSampler.harvest_if_due has waited out the in-flight fold; the consumer touches the fresh one only to seed anchors of cells the producer has not folded, and every other instance is local to one call)
    def harvest(self) -> Dict[int, Dict[int, FieldValue]]:
        """Close the window: derived values for every cell that saw at
        least one sample, as ``{chip: {derived_fid: value}}`` ready to
        fold into a sweep.  Resets the stats and KEEPS the cells with
        their anchors — so
        window integrals tile the total integral even across empty
        windows.  Cardinality is bounded by the distinct (chip, field)
        pairs ever folded."""

        out: Dict[int, Dict[int, FieldValue]] = {}
        burst_id = FF.burst_id
        for key, w in self._windows.items():
            count = w.count
            if not count:
                continue
            chip, fid = key
            vals = out.get(chip)
            if vals is None:
                vals = out[chip] = {}
            vals[burst_id(fid, 0)] = wire_number(w.vmin)
            vals[burst_id(fid, 1)] = wire_number(w.vmax)
            vals[burst_id(fid, 2)] = wire_number(w.vsum / count)
            vals[burst_id(fid, 3)] = wire_number(w.integral)
            w.count = 0
            w.vmin = w.vmax = w.vsum = w.integral = 0.0
        return out

    # tpumon: thread-ok(accumulator handoff — a sampler's live accumulator is folded only by its producer thread and harvested only after the swap, once BurstSampler.harvest_if_due has waited out the in-flight fold; the consumer touches the fresh one only to seed anchors of cells the producer has not folded, and every other instance is local to one call)
    def adopt_anchors(self, other: "PyBurstAccumulator") -> None:
        """Carry ``other``'s integration anchors into this (fresh)
        accumulator — the swap-handoff's half of anchor persistence:
        without it, every swapped-in window's first sample would
        contribute no area and the integral would undercount by one
        sample interval per window.  A cell the producer already
        folded into keeps its own (newer) anchor."""

        for key, w in other._windows.items():
            if w.anchor_t is None:
                continue
            mine = self._windows.get(key)
            if mine is None:
                mine = self._windows[key] = BurstWindow()
            if mine.anchor_t is None:
                mine.anchor_t = w.anchor_t
                mine.anchor_v = w.anchor_v


if _codec.lib is not None and int(_codec.lib.BURST_ID_BASE) != FF.BURST_ID_BASE:
    # a stale extension must degrade to the reference, never emit
    # derived fields under drifted ids
    _codec.reject("native codec BURST_ID_BASE disagrees with "
                  "tpumon_torch/fields.py (rebuild: python -m "
                  "tpumon_torch._build --native)")


class BurstAccumulator:
    """The shared burst accumulator (native-backed facade).

    Same fold/harvest/anchor contract as :class:`PyBurstAccumulator`
    (the fallback and executable spec).  The native backend owns the
    window table and releases the GIL around large ``fold_series``
    batches and every ``harvest`` — an internal mutex makes the
    GIL-released window safe against the accumulator-swap handoff
    (:class:`BurstSampler`), which already serializes access by
    protocol."""

    __slots__ = ("_nat", "_py")

    def __init__(self) -> None:
        lib = _codec.lib
        if lib is not None:
            self._nat: Optional[Any] = lib.Burst()
            self._py: Optional[PyBurstAccumulator] = None
        else:
            self._nat = None
            self._py = PyBurstAccumulator()

    def fold(self, chip: int, fid: int, t: float, v: float) -> None:
        nat = self._nat
        if nat is not None:
            # the reference's float() coercion (and its errors) before
            # the native double fold
            nat.fold(chip, fid, t, float(v))
            return
        py = self._py
        assert py is not None
        py.fold(chip, fid, t, v)  # tpumon: codec-ok(facade fallback: the extension is absent, the reference IS the product here)

    def fold_series(self, chip: int, fid: int, ts: Sequence[float],
                    vs: Sequence[FieldValue]) -> None:
        nat = self._nat
        if nat is not None:
            nat.fold_series(chip, fid, ts, vs)
            return
        py = self._py
        assert py is not None
        py.fold_series(chip, fid, ts, vs)  # tpumon: codec-ok(facade fallback: the extension is absent, the reference IS the product here)

    def entries(self) -> int:
        nat = self._nat
        if nat is not None:
            entries = nat.entries()
            return int(entries)
        py = self._py
        assert py is not None
        return py.entries()

    def harvest(self) -> Dict[int, Dict[int, FieldValue]]:
        nat = self._nat
        if nat is not None:
            return cast("Dict[int, Dict[int, FieldValue]]",
                        nat.harvest())
        py = self._py
        assert py is not None
        return py.harvest()

    def adopt_anchors(self, other: "BurstAccumulator") -> None:
        nat = self._nat
        if nat is not None:
            if other._nat is None:
                raise TypeError("cannot adopt anchors across codec "
                                "backends")
            nat.adopt_anchors(other._nat)
            return
        py = self._py
        other_py = other._py
        assert py is not None and other_py is not None
        py.adopt_anchors(other_py)


#: sample_fn contract: one inner sweep of the cheap-counter subset —
#: ``{chip: {source_fid: value}}`` (blanks/None allowed; discarded)
SampleFn = Callable[[], Dict[int, Dict[int, FieldValue]]]


class BurstSampler:
    """Inner-loop thread: samples ``sample_fn`` at ``hz`` into a
    :class:`BurstAccumulator`, harvested at 1 Hz by the sweep thread
    (the exporter's ``--burst-hz``)."""

    def __init__(self, sample_fn: SampleFn, hz: int,
                 window_s: float = 1.0) -> None:
        if hz <= 0:
            raise ValueError(f"burst hz must be positive, got {hz}")
        self.hz = int(hz)
        self.window_s = float(window_s)
        self._sample_fn = sample_fn
        # swapped by harvest_if_due (sweep thread), read by the inner
        # loop: the handoff is the accumulator-swap documented in the
        # module docstring.  _fold_seq is a seqlock at burst
        # granularity: the producer holds it ODD for
        # the duration of one fold burst, and the harvester waits for
        # EVEN after the swap — the swapped-out accumulator is then
        # quiescent (a burst that starts after the swap reads the new
        # accumulator), so harvest never reads torn stats and never
        # iterates a dict the producer is growing.
        self._acc = BurstAccumulator()
        self._fold_seq = 0
        self._overruns = 0
        self._stop = threading.Event()
        #: set once the loop's first burst has folded (see :meth:`start`)
        self._first = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._last_harvest_t: Optional[float] = None
        self._last_harvest: Dict[int, Dict[int, FieldValue]] = {}

    # -- control (sweep thread) -----------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="tpumon-burst")
        self._thread.start()
        # the first burst folds before the caller's first harvest: a sweep
        # right after the start (``--oneshot``) reads that sample instead
        # of racing the thread for it (bounded: a wedged source only
        # delays the start)
        self._first.wait(max(1.0, 2.0 / self.hz))

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)
            self._thread = None

    def stats(self) -> Dict[str, float]:
        """Self-metric counters (``tpumon_agent_burst_*`` twins)."""

        # tpumon: thread-ok(single-writer counter — only the inner loop increments _overruns; this scrape-side read takes a stale-but-consistent int under the GIL, the frameserver loop-counter contract)
        overruns = float(self._overruns)
        return {"burst_hz": float(self.hz), "burst_overruns": overruns}

    # tpumon: thread-ok(one consumer at a time per sampler — the exporter harvests on its sweep thread; the Python agent's serve and scrape threads harvest under Engine._harvest_lock; the call graph joins the instances)
    def harvest_if_due(self, now: Optional[float] = None,
                       ) -> Dict[int, Dict[int, FieldValue]]:
        """Close the window when ``window_s`` has elapsed since the
        last harvest, else return the previous harvest unchanged — so
        every 1 Hz sweep folds in a consistent per-second window and a
        sub-second sweep cadence never fragments it.  Runs on the
        sweep thread; see the module docstring for the swap handoff."""

        t = now if now is not None else time.monotonic()
        last = self._last_harvest_t
        if last is not None and t - last < self.window_s:
            return self._last_harvest
        self._last_harvest_t = t
        fresh = BurstAccumulator()
        old, self._acc = self._acc, fresh
        # wait out the producer's in-flight fold burst: once _fold_seq
        # is even, any later burst reads the freshly-swapped-in
        # accumulator, so `old` is quiescent and the harvest below is
        # tear-free.  The wait is one burst (<1 period); the bounded
        # deadline covers a wedged producer, in which case the PREVIOUS
        # harvest is served rather than risking a torn one.
        deadline = time.monotonic() + 0.2
        # tpumon: thread-ok(seqlock read — the single producer flips _fold_seq around each fold burst; this spin only needs an eventually-consistent view of the low bit)
        while self._fold_seq & 1:
            if time.monotonic() > deadline:
                return self._last_harvest
            # GIL yield so the producer can finish its burst; runs on
            # the sweep thread, normally sub-millisecond and hard-
            # bounded by the deadline above — never the inner loop
            time.sleep(0)  # tpumon-lint: disable=blocking-socket-in-fleetpoll  # tpumon-check: disable=blocking-while-locked
        self._last_harvest = old.harvest()
        # anchor adoption into the live accumulator: a cell the
        # producer already folded into keeps its own (newer) anchor
        fresh.adopt_anchors(old)
        return self._last_harvest

    # -- inner loop (burst thread) --------------------------------------------

    def _run(self) -> None:
        period = 1.0 / self.hz
        sample_fn = self._sample_fn
        stop_wait = self._stop.wait
        deadline = time.monotonic() + period
        first = False
        while not self._stop.is_set():
            t = time.monotonic()
            try:
                sweep = sample_fn()
            except Exception:
                # a failing source degrades this window, never the
                # thread; the overrun counter below surfaces a source
                # that is consistently slower than the period
                sweep = {}
            # seqlock the burst: odd while folding — the harvester's
            # post-swap quiescence wait keys on this (the ODD store
            # must precede the accumulator read, so a swap observed
            # as "seq even" can only mean this burst uses the NEW one)
            self._fold_seq += 1
            acc = self._acc  # re-read each burst: harvest swaps it
            fold = acc.fold
            for chip, vals in sweep.items():
                for fid, v in vals.items():
                    # blanks and non-numeric values are discarded like
                    # non-finite samples (burst sources are declared
                    # scalar-numeric; a misdeclared one must degrade,
                    # not kill the thread)
                    if isinstance(v, (int, float)):
                        fold(chip, fid, t, v)
            self._fold_seq += 1
            if not first:
                self._first.set()
                first = True
            now = time.monotonic()
            if now > deadline + period:
                # missed at least one whole period: count every missed
                # slot and re-anchor, so a slow source is VISIBLE
                # (tpumon_agent_burst_overruns_total), not silently
                # sampling at a lower effective rate
                missed = int((now - deadline) / period)
                self._overruns += missed
                deadline += missed * period
            wait = deadline - now
            deadline += period
            if wait > 0 and stop_wait(wait):
                break
