"""What the monitor costs the workload on the card: the paired bench
protocol.

    python -m tpumon_torch.loadgen.bench_gpu [--pattern P] [--pairs 6]
        [--seconds 5] [--capture-cost N] [--tier-1hz S] [--json]

Counterpart of ``bench.py:2362-2747`` (``bench_real_tpu``,
``bench_capture_step_cost``, ``bench_real_tier_1hz``), with its verdict
copied rule for rule:

* **Pairs.**  Interleaved bare and monitored windows of ``--seconds``,
  their order alternating from pair to pair, after one bare warm-up
  window (the train step's graph capture comes before it).  The pairs run
  as windows of ONE process (:func:`..run.run_window`), not as a process
  per leg as the reference's do: the card's host drifts more from process
  to process than the monitor costs.  A monitored window runs the
  runner's self-monitor -- ``TpuExporter`` over ``CudaBackend``, started
  for the window and shut down after it; ``monitor_env`` adds variables
  to the monitored windows only (``TPUMON_CUDA_TRACE=0``: the monitor
  without its trace engine).  A window that made no progress drops its
  pair; no new pair starts once ``budget_s`` is spent (two always run).
* **The verdict** (:func:`verdict`): the stall rule
  (:func:`exclude_stalls`), then the one-sided sign test
  (:func:`sign_test_p`) at ``SIGN_TEST_ALPHA``: a point estimate, the
  monitored side consistently faster, within noise, underpowered, or too
  few pairs.
* **Capture cost** (:func:`capture_cost`): monitored windows with the
  duty cap off and a short cadence; the median of the runner's
  in-window ``capture_step_cost_pct`` and its sign test.
* **The 1 Hz tier** (:func:`tier_1hz`): the exporter's fields swept
  through the NVML backend at 1 Hz, and the process's CPU share
  (:class:`tpumon_torch.introspect.SelfMonitor`): the north star's "<1%
  host CPU".

Cells: ``train`` (the bench train step as a CUDA graph) and the patterns
``mxu``, ``hbm``, ``mixed``, ``flash`` and ``conv``; all six unless
``--pattern`` names one.  Prints each cell's record as it completes,
then one JSON record on the last line: the card's name and power limit
(``nvidia-smi``), each cell's record (every ``OVERHEAD_RECORD_KEYS``
key), and the capture-cost and 1 Hz records when asked for.  Needs a CUDA
device; the verdict, the aggregates and the tier run anywhere.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import subprocess
import sys
import time
from math import comb
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

#: one-sided sign-test significance bar for a point estimate, in the
#: pre-registered direction overhead > 0 (a monitor can only cost; the
#: monitored side running faster is a bias symptom, flagged apart): 4/4
#: positive pairs clear it at exactly p = 1/16
SIGN_TEST_ALPHA = 0.0625

#: the stall rule: a completed pair is a stall artifact -- excluded from
#: the verdict, kept in the record -- when (a) its magnitude exceeds the
#: absolute floor AND ``STALL_K`` x the median magnitude of the
#: below-floor pairs, and (b) one of its legs stepped at under
#: ``STALL_LEG_FRAC`` of the median rate of its kind across all pairs (a
#: bare leg at 45 steps/s against a 100 median once minted a -210.8%
#: pair that flipped four ~+4% pairs into "within noise").  The leg-rate
#: conjunct keeps a genuine heavy overhead (consistent 25% pairs with
#: healthy leg rates) in the verdict
STALL_ABS_FLOOR_PCT = 20.0
STALL_K = 5.0
STALL_LEG_FRAC = 0.6

#: verdict keys every overhead record carries
OVERHEAD_RECORD_KEYS = (
    "real_tpu", "monitor_overhead_percent",
    "overhead_pairs_percent", "overhead_spread_percent",
    "overhead_within_noise", "overhead_median_percent",
    "overhead_sign_pairs", "overhead_sign_test_p",
    "overhead_underpowered", "overhead_pairs_excluded_percent",
    "pairs_completed", "monitor_cost")

#: the cells: the train step and each single-device pattern
CELLS = ("train", "mxu", "hbm", "mixed", "flash", "conv")

#: the capture-cost windows' trace knobs: the duty cap off and a short
#: cadence, so several captures land in each window
CAPTURE_COST_ENV = {"TPUMON_CUDA_TRACE_DUTY": "0",
                    "TPUMON_CUDA_TRACE_INTERVAL": "3"}
#: seconds of each capture-cost window (the estimator wants at least ten
#: sync blocks and half a second both in and out of captures)
CAPTURE_SECONDS = 20.0


def log(msg: str) -> None:
    print(f"bench_gpu: {msg}", file=sys.stderr, flush=True)


# -- the verdict ---------------------------------------------------------------

def sign_test_p(n_pos: int, n_neg: int) -> float:
    """One-sided binomial tail P(X >= n_pos) under p = 0.5: the chance of
    at least the observed count of positive (overhead-direction) pairs if
    the monitor cost nothing.  The direction is fixed a priori."""

    n = n_pos + n_neg
    return sum(comb(n, j) for j in range(n_pos, n + 1)) / 2.0 ** n


def exclude_stalls(pairs: Sequence[Tuple[float, float]],
                   overheads: Sequence[float]) -> tuple:
    """(surviving, excluded) overhead percents by the stall rule.  The
    magnitude scale comes from the below-floor pairs; with no pair below
    the floor nothing is excluded (all pairs wild: stalls cannot be told
    from signal, and the sign test reports the mess)."""

    calm = [abs(x) for x in overheads if abs(x) <= STALL_ABS_FLOOR_PCT]
    if not calm:
        return list(overheads), []
    cut = max(STALL_ABS_FLOOR_PCT, STALL_K * statistics.median(calm))
    med_bare = statistics.median([b for b, _ in pairs])
    med_mon = statistics.median([m for _, m in pairs])
    surviving, excluded = [], []
    for (b, m), x in zip(pairs, overheads):
        leg_stalled = (b < STALL_LEG_FRAC * med_bare
                       or m < STALL_LEG_FRAC * med_mon)
        if abs(x) > cut and leg_stalled:
            excluded.append(x)
        else:
            surviving.append(x)
    return surviving, excluded


def verdict(legs: Sequence[Tuple[dict, dict]]) -> dict:
    """The overhead record of paired windows, ``legs`` their (bare,
    monitored) runner results in the order they ran.

    A pair with a window that made no progress is dropped; the record
    starts from the last completed pair's monitored result (a dropped
    pair's progressing one when none completed).  The verdict is a
    one-sided sign test over the pairs that survive the stall rule:
    p <= ``SIGN_TEST_ALPHA`` prints ``monitor_overhead_percent`` (their
    median); a significant negative majority is flagged
    ``overhead_monitored_faster`` and claims no overhead; mixed signs or
    exact-zero ties report ``overhead_within_noise``; a sign-consistent
    set too small to clear the bar (2-3 pairs) reports
    ``overhead_underpowered``; fewer than two surviving pairs report
    ``overhead_insufficient_pairs``.  ``real_tpu`` is the reference's key:
    the monitored windows ran on a device, not the CPU."""

    pairs = []
    mon_result = None
    for bare, mon in legs:
        if not bare.get("steps_per_sec") or not mon.get("steps_per_sec"):
            # a 0-steps window cannot anchor a ratio, on either side
            if mon_result is None and mon.get("steps_per_sec"):
                mon_result = mon
            continue
        mon_result = mon
        pairs.append((bare["steps_per_sec"], mon["steps_per_sec"]))
    if mon_result is None:
        return {"real_tpu": False, "reason": "no completed pair"}

    d = dict(mon_result)
    d["real_tpu"] = "cpu" not in d.get("device", "cpu").lower()
    d["pairs_completed"] = len(pairs)
    if not pairs:
        d["monitor_overhead_percent"] = None
        d["overhead_within_noise"] = None
        d["overhead_insufficient_pairs"] = True
        return d
    overheads = [round(100.0 * (1.0 - m / b), 1) for b, m in pairs]
    d["overhead_pairs_percent"] = overheads
    d["unmonitored_steps_per_sec"] = round(
        sum(b for b, _ in pairs) / len(pairs), 3)
    d["overhead_spread_percent"] = [min(overheads), max(overheads)]
    d["overhead_mean_percent"] = round(sum(overheads) / len(overheads), 1)
    surviving, excluded = exclude_stalls(pairs, overheads)
    if excluded:
        d["overhead_pairs_excluded_percent"] = excluded
        d["overhead_stall_rule"] = (
            f"|x| > max({STALL_ABS_FLOOR_PCT:.0f}%, {STALL_K:.0f}x "
            f"median|below-floor pairs|) and a leg < "
            f"{STALL_LEG_FRAC:.1f}x its kind's median rate")
    d["overhead_median_percent"] = round(
        statistics.median(surviving), 1) if surviving else None
    # exact-0.0 pairs are ties: the sign test drops them from the counts
    n_pos = sum(1 for x in surviving if x > 0)
    n_neg = sum(1 for x in surviving if x < 0)
    n_tie = len(surviving) - n_pos - n_neg
    if len(surviving) < 2:
        d["monitor_overhead_percent"] = None
        d["overhead_within_noise"] = None
        d["overhead_insufficient_pairs"] = True
        return d
    p = sign_test_p(n_pos, n_neg)
    d["overhead_sign_pairs"] = [n_pos, n_neg]
    if n_tie:
        d["overhead_sign_ties"] = n_tie
    d["overhead_sign_test_p"] = round(p, 4)
    if p <= SIGN_TEST_ALPHA:
        d["monitor_overhead_percent"] = d["overhead_median_percent"]
        d["overhead_within_noise"] = False
    elif sign_test_p(n_neg, n_pos) <= SIGN_TEST_ALPHA:
        # the monitored side consistently faster: a bias symptom, never
        # a negative cost
        d["monitor_overhead_percent"] = None
        d["overhead_within_noise"] = True
        d["overhead_monitored_faster"] = True
    elif (n_pos and n_neg) or n_tie:
        d["monitor_overhead_percent"] = None
        d["overhead_within_noise"] = True
    else:
        d["monitor_overhead_percent"] = None
        d["overhead_within_noise"] = None
        d["overhead_underpowered"] = True
    return d


def capture_cost(results: Sequence[Optional[dict]], env: Dict[str, str],
                 seconds: float) -> dict:
    """The capture-cost record of monitored windows run with ``env`` (the
    duty cap off, a short cadence): each window's in-window
    ``capture_step_cost_pct`` (a window without capture overlap is
    skipped, a failed one is None), their median and a one-sided sign
    test (capture slows > 0)."""

    samples = []
    for r in results:
        if r is None:
            continue
        mc = r.get("monitor_cost") or {}
        pct = mc.get("capture_step_cost_pct")
        if pct is None:
            continue
        samples.append({"cost_pct": pct,
                        "overlap_s": mc.get("capture_overlap_s"),
                        "captures": mc.get("captures_in_window")})
    out: dict = {"runs": samples, "config": dict(env),
                 "seconds_per_run": seconds}
    vals = [s["cost_pct"] for s in samples]
    if len(vals) >= 2:
        out["median_pct"] = round(statistics.median(vals), 1)
        n_pos = sum(1 for v in vals if v > 0)
        n_neg = sum(1 for v in vals if v < 0)
        out["sign_runs"] = [n_pos, n_neg]
        out["sign_test_p"] = round(sign_test_p(n_pos, n_neg), 4)
    return out


# -- the windows ---------------------------------------------------------------

@contextlib.contextmanager
def environment(extra: Optional[Dict[str, str]]) -> Iterator[None]:
    """``extra`` set in ``os.environ`` for the block, the old values back
    after it."""

    saved = {k: os.environ.get(k) for k in (extra or {})}
    os.environ.update(extra or {})
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def paired(work, n_pairs: int, seconds: float, monitor_env=None,
           budget_s: float = 900.0, device_name: str = "cpu") -> dict:
    """``n_pairs`` bare/monitored pairs of ``seconds`` windows of ``work``
    (a :class:`..run.Workload`, warmed up), in one process, their order
    alternating; the :func:`verdict` record with every
    ``OVERHEAD_RECORD_KEYS`` key, the windows' steps/s and the protocol's
    settings."""

    from .run import run_window

    legs: List[Tuple[dict, dict]] = []
    budget_hit = False
    t_start = time.monotonic()
    for i in range(n_pairs):
        if i >= 2 and time.monotonic() - t_start > budget_s:
            budget_hit = True
            log(f"pair budget ({budget_s:.0f}s) spent after {i} pairs")
            break
        got = {}
        for monitored in ((False, True) if i % 2 == 0 else (True, False)):
            with environment(monitor_env if monitored else None):
                got[monitored] = run_window(work, seconds,
                                            self_monitor=monitored,
                                            device_name=device_name,
                                            final_capture=False)
        legs.append((got[False], got[True]))
        log(f"{work.pattern} pair {i}: bare {got[False]['steps_per_sec']} "
            f"vs monitored {got[True]['steps_per_sec']} steps/s")
    d = verdict(legs)
    # every verdict key in the record, None where the verdict's branch
    # sets none (the reference records only those set)
    for key in OVERHEAD_RECORD_KEYS:
        d.setdefault(key, None)
    d["pair_seconds"] = seconds
    d["bare_steps_per_sec"] = [b["steps_per_sec"] for b, _ in legs]
    d["monitored_steps_per_sec"] = [m["steps_per_sec"] for _, m in legs]
    if monitor_env:
        d["monitor_env"] = dict(monitor_env)
    if budget_hit:
        d["pair_budget_exhausted"] = True
    return d


def warm_workload(pattern: str, device, warmup_s: float = 3.0):
    """The cell's :class:`..run.Workload` on ``device`` (the train step's
    graph captured and, for the trace engine, its program recorded), then
    one bare warm-up window, after all set-up."""

    from .run import Workload, run_window

    work = Workload(pattern, device=device)
    if work.graph is not None:
        work.graph.describe()
    run_window(work, warmup_s)
    return work


def run_capture_cost(work, n_runs: int, seconds: float,
                     device_name: str = "cpu") -> dict:
    """:func:`capture_cost` of ``n_runs`` monitored windows of ``work``."""

    from .run import run_window

    results = []
    with environment(CAPTURE_COST_ENV):
        for i in range(n_runs):
            r = run_window(work, seconds, self_monitor=True,
                           device_name=device_name)
            mc = r.get("monitor_cost") or {}
            log(f"capture-cost run {i}: {mc.get('capture_step_cost_pct')}% "
                f"during {mc.get('capture_overlap_s')}s of capture")
            results.append(r)
    return capture_cost(results, CAPTURE_COST_ENV, seconds)


# -- the 1 Hz tier -------------------------------------------------------------

def tier_1hz(backend, index: int, field_ids: Sequence[int],
             seconds: float, interval_s: float = 1.0) -> dict:
    """Sweep ``field_ids`` of device ``index`` through ``backend`` (opened;
    NVML out of band) at one sweep per ``interval_s`` for ``seconds``, as
    ``tpumon_torch.cli.dmon`` runs it (the watch layer's ``update_all``),
    on an otherwise idle process.  Returns each sweep's wall ms, the
    process's CPU share over the run from
    :class:`tpumon_torch.introspect.SelfMonitor` (every thread counted,
    ``cpu_percent_1hz``), and ``call_ms``: the wall ms a sweep spends in
    each NVML entry point and its calls a sweep (a clock read around each
    call: an NVML call is an ioctl, and its wall time is the CPU it
    holds), and the field-values entries a sweep asks."""

    import tpumon_torch
    from tpumon_torch.cli.common import ticker
    from tpumon_torch.introspect import SelfMonitor

    spent: Dict[str, float] = {}
    calls: Dict[str, int] = {}
    entries = [0]  # field-values entries asked
    originals = _timed_calls(backend, time.perf_counter, spent, calls,
                             entries)
    h = tpumon_torch.init(backend=backend)
    try:
        fg = h.watches.create_field_group(list(field_ids), "tier_1hz")
        cg = h.watches.create_chip_group([index], "tier_1hz")
        h.watches.watch_fields(cg, fg,
                               update_freq_us=int(interval_s * 1e6))
        wall_ms = []
        mon = SelfMonitor()
        t0 = time.monotonic()
        for _ in ticker(interval_s, max(1, round(seconds / interval_s))):
            s0 = time.monotonic()
            h.watches.update_all(wait=True)
            wall_ms.append((time.monotonic() - s0) * 1e3)
        wall_s = time.monotonic() - t0
        cpu_pct = mon.status().cpu_percent
        vals = h.watches.latest_values(index, fg.field_ids)
    finally:
        tpumon_torch.shutdown()
        getattr(backend, "_fn", {}).update(originals)
    n = len(wall_ms)
    ranked = sorted(wall_ms)
    return {"tier": getattr(backend, "name", "?"), "index": index,
            "sweeps": n, "fields": len(fg.field_ids),
            "nonblank": sum(v is not None for v in vals.values()),
            "sweep_ms": wall_ms, "sweep_ms_median": ranked[n // 2],
            "sweep_ms_max": ranked[-1], "wall_s": wall_s,
            "cpu_percent_1hz": cpu_pct, "cpu_under_1pct": cpu_pct < 1.0,
            "field_values_entries": entries[0] / n,
            "call_ms": {k: [round(v / n * 1e3, 3), calls[k] // n]
                        for k, v in sorted(spent.items(),
                                           key=lambda kv: -kv[1])}}


def _timed_calls(backend, clock, spent: Dict[str, float],
                 calls: Dict[str, int],
                 entries: Optional[List[int]] = None) -> Dict[str, object]:
    """Wrap each NVML entry point of ``backend`` (its ``_fn`` table, none
    for another backend) to add ``clock()`` around every call to
    ``spent[name]`` and count it, and the field-values entries asked to
    ``entries[0]``; returns the originals, for ``backend._fn.update`` to
    restore."""

    fn = getattr(backend, "_fn", {})
    originals = dict(fn)
    for name, f in originals.items():
        if f is None or name == "nvmlEventSetWait_v2":
            continue

        def timed(*args, _f=f, _name=name):
            if entries is not None and _name == "nvmlDeviceGetFieldValues":
                entries[0] += args[1]
            t = clock()
            try:
                return _f(*args)
            finally:
                spent[_name] = spent.get(_name, 0.0) + clock() - t
                calls[_name] = calls.get(_name, 0) + 1
        fn[name] = timed
    return originals


def burst_cpu_split(backend, index: int, hz: int, seconds: float,
                    agent: bool = False) -> dict:
    """The burst inner loop's thread CPU, by part, measured from outside
    the loop: :class:`tpumon_torch.burst.BurstSampler` over
    ``backend.read_burst_fields`` runs alone in this process for
    ``seconds`` at ``hz`` as the exporter daemon runs it, or with
    ``agent`` as the agent's :class:`tpumon_torch.hostengine.Engine` runs
    it.  The read is wrapped: the thread's CPU (``time.thread_time``) at
    each read's entry and exit, and around every NVML call in it.  The
    fold is timed by folding the recorded sweeps again after the loop
    stops.  Returns microseconds a tick: ``read`` (of which
    ``nvml_calls``, the foreign calls themselves, and ``marshalling``, the
    rest: ctypes structures, conversions, the backend's Python),
    ``fold``, and ``wait``: the thread's CPU between reads less the fold,
    the sleep's wake-up and the loop's bookkeeping; the thread's share of
    one CPU; the process's; ticks and overruns."""

    from tpumon_torch import fields as FF
    from tpumon_torch.burst import BurstAccumulator, BurstSampler
    from tpumon_torch.introspect import SelfMonitor

    spent: Dict[str, float] = {}
    calls: Dict[str, int] = {}
    originals = _timed_calls(backend, time.thread_time, spent, calls)
    marks: List[Tuple[float, float]] = []  # thread CPU at entry, exit
    sweeps = []
    read = backend.read_burst_fields

    def timed_read(reqs):
        t = time.monotonic()
        c0 = time.thread_time()
        try:
            out = read(reqs)
            sweeps.append((t, out))
            return out
        finally:
            marks.append((c0, time.thread_time()))

    backend.read_burst_fields = timed_read
    reqs = [(index, list(FF.BURST_SOURCE_FIELDS))]
    engine = None
    mon = SelfMonitor()
    try:
        if agent:
            from tpumon_torch.hostengine import Engine

            engine = Engine(backend, burst_hz=hz)
            sampler = engine.burst
        else:
            sampler = BurstSampler(lambda: backend.read_burst_fields(reqs),
                                   hz)
            sampler.start()
        time.sleep(seconds)
        proc_pct = mon.status().cpu_percent
    finally:
        if engine is not None:
            engine.close()
        else:
            sampler.stop()
        del backend.read_burst_fields
        getattr(backend, "_fn", {}).update(originals)
    n = max(1, len(marks) - 1)  # ticks from the first read to the last
    thread_s = marks[-1][0] - marks[0][0] if len(marks) > 1 else 0.0
    read_s = sum(c1 - c0 for c0, c1 in marks[:-1])
    acc = BurstAccumulator()
    t0 = time.perf_counter()
    for t, sweep in sweeps[:-1]:
        for chip, vals in sweep.items():
            for fid, v in vals.items():
                if isinstance(v, (int, float)):
                    acc.fold(chip, fid, t, v)
    fold_s = time.perf_counter() - t0
    wall = sweeps[-1][0] - sweeps[0][0] if len(sweeps) > 1 else seconds
    us = {"read": read_s, "nvml_calls": sum(spent.values()),
          "fold": fold_s, "wait": thread_s - read_s - fold_s}
    us = {k: round(v / n * 1e6, 2) for k, v in us.items()}
    us["marshalling"] = round(us["read"] - us["nvml_calls"], 2)
    return {"hz": hz, "loop": "agent" if agent else "exporter",
            "seconds": round(wall, 3), "ticks": n,
            "overruns": int(sampler.stats()["burst_overruns"]),
            "us_per_tick": us,
            "calls_per_tick": {k: round(v / len(marks), 2)
                               for k, v in calls.items()},
            "thread_cpu_percent": round(100.0 * thread_s / wall, 3)
            if wall > 0 else None,
            "process_cpu_percent": round(proc_pct, 3)}


def tail_ms(xs: Sequence[float]) -> dict:
    """p50, max and n of ``xs``; p99 only from 100 values or more."""

    xs = sorted(xs)
    if not xs:
        return {"n": 0, "p50": None, "p99": None, "max": None}
    return {"n": len(xs), "p50": round(xs[len(xs) // 2], 3),
            "p99": (round(xs[int(0.99 * len(xs))], 3) if len(xs) >= 100
                    else None),
            "max": round(xs[-1], 3)}


def agent_collect(backend, index: int, field_ids: Sequence[int],
                  seconds: float, hz: float = 1.0) -> dict:
    """The agent's collect: its watches (a :class:`tpumon_torch.watch.
    WatchManager` over :class:`tpumon_torch.hostengine.WatchSource`, as
    the agent runs them) on ``field_ids`` at ``hz`` over ``backend`` in
    this process for ``seconds``.  Returns each sweep's wall ms and, by
    NVML entry point, the wall ms a sweep spends in it and its calls a
    sweep (``call_ms``); each as :func:`tail_ms`."""

    from tpumon_torch.hostengine import WatchSource
    from tpumon_torch.watch import WatchManager

    spent: Dict[str, float] = {}
    calls: Dict[str, int] = {}
    originals = _timed_calls(backend, time.perf_counter, spent, calls)
    sweeps: List[Tuple[float, Dict[str, float], Dict[str, int]]] = []
    read = backend.read_fields_bulk

    def timed_read(reqs, now=None, max_age_s=None):
        spent.clear()
        calls.clear()
        t = time.perf_counter()
        try:
            return read([r for r in reqs if r[0] == index], now=now)
        finally:
            sweeps.append(((time.perf_counter() - t) * 1e3, dict(spent),
                           dict(calls)))

    backend.read_fields_bulk = timed_read
    wm = WatchManager(WatchSource(backend))
    try:
        wm.watch_fields(wm.all_chips_group(),
                        wm.create_field_group(field_ids),
                        int(1e6 / hz), 5.0)
        wm.start(tick_s=None)
        time.sleep(seconds)
    finally:
        wm.stop()
        del backend.read_fields_bulk
        getattr(backend, "_fn", {}).update(originals)
    names = sorted({k for _, sp, _ in sweeps for k in sp},
                   key=lambda k: -sum(sp.get(k, 0.0) for _, sp, _ in sweeps))
    return {"hz": hz, "sweep_ms": tail_ms([w for w, _, _ in sweeps]),
            "call_ms": {k: dict(tail_ms([sp.get(k, 0.0) * 1e3
                                         for _, sp, _ in sweeps]),
                                calls=max(c.get(k, 0)
                                          for _, _, c in sweeps))
                        for k in names}}


def exporter_fields() -> List[int]:
    """The exporter's families (``fields.EXPORTER_*``), one id each."""

    from tpumon_torch import fields

    return sorted({int(f) for f in (fields.EXPORTER_BASE_FIELDS
                                    + fields.EXPORTER_PROFILING_FIELDS
                                    + fields.EXPORTER_DCN_FIELDS)})


def nvml_index(backend) -> int:
    """The NVML index of the device torch calls ``cuda:0`` (matched by
    UUID: NVML orders by PCI bus and ignores ``CUDA_VISIBLE_DEVICES``)."""

    import torch

    uuid = "GPU-" + str(torch.cuda.get_device_properties(0).uuid)
    for i in range(backend.chip_count()):
        if backend.chip_info(i).uuid.lower() == uuid.lower():
            return i
    raise RuntimeError(f"no NVML device has torch's cuda:0 UUID {uuid}")


def run_tier_1hz(seconds: float) -> dict:
    """:func:`tier_1hz` over the NVML backend on torch's ``cuda:0``; the
    recorded absence where the host exposes no NVML."""

    from tpumon_torch.backends import LibraryNotFound
    from tpumon_torch.backends.nvml import NvmlBackend

    b = NvmlBackend()
    try:
        b.open()
    except LibraryNotFound as e:
        return {"tier": "none_exposed", "reason": str(e)}
    try:
        return tier_1hz(b, nvml_index(b), exporter_fields(), seconds)
    finally:
        b.close()


# -- the CLI -------------------------------------------------------------------

def card() -> dict:
    """The card's name and power limit as ``nvidia-smi`` gives them."""

    import torch

    line = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True
                          ).stdout.strip().splitlines()[0]
    return {"nvidia_smi": line, "name": torch.cuda.get_device_name(0)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="tpumon-torch-bench-gpu",
                                description=__doc__)
    p.add_argument("--pattern", choices=CELLS, default=None,
                   help="one cell (default: all six)")
    p.add_argument("--pairs", type=int, default=6)
    p.add_argument("--seconds", type=float, default=5.0,
                   help="seconds a window")
    p.add_argument("--monitor-env", action="append", default=[],
                   metavar="K=V", help="set in the monitored windows only")
    p.add_argument("--capture-cost", type=int, default=0, metavar="N",
                   help="N capture-cost windows of the train step")
    p.add_argument("--tier-1hz", type=float, default=0.0, metavar="S",
                   help="sweep the NVML backend at 1 Hz for S seconds")
    p.add_argument("--json", action="store_true",
                   help="print each record as one JSON line")
    args = p.parse_args(argv)
    monitor_env = dict(kv.split("=", 1) for kv in args.monitor_env) or None

    import torch

    from .run import device_name, resolve_device

    device = resolve_device("cuda")
    name = device_name(device)
    out: dict = {"card": card(), "cells": {}}
    for pattern in ([args.pattern] if args.pattern else CELLS):
        work = warm_workload(pattern, device)
        rec = paired(work, args.pairs, args.seconds, monitor_env,
                     device_name=name)
        out["cells"][pattern] = rec
        print(json.dumps({"cell": pattern, **rec}) if args.json else
              f"{pattern}: bare {rec.get('bare_steps_per_sec')} monitored "
              f"{rec.get('monitored_steps_per_sec')} overhead "
              f"{rec.get('monitor_overhead_percent')}% (within noise "
              f"{rec.get('overhead_within_noise')})", flush=True)
        if pattern == "train" and args.capture_cost:
            out["capture_cost"] = run_capture_cost(
                work, args.capture_cost, CAPTURE_SECONDS, name)
        del work
        torch.cuda.empty_cache()
    if args.capture_cost and "capture_cost" not in out:
        work = warm_workload("train", device)
        out["capture_cost"] = run_capture_cost(
            work, args.capture_cost, CAPTURE_SECONDS, name)
        del work
    if args.tier_1hz:
        out["tier_1hz"] = run_tier_1hz(args.tier_1hz)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
