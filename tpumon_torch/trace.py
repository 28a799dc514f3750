"""Profiler traces: MEASURED device utilization on a CUDA device.

Counterpart of ``tpumon/xplane.py``.  ``torch.profiler`` (Kineto over
CUPTI) records every kernel, memory copy and memset the device ran, on the
device's own clock, and each aten op with the FLOPs of the products it
computes.  A short periodic capture gives the monitor:

* **duty cycle** — the union of the device's kernel, memcpy and memset
  intervals over the capture window (the reference's ops-line fallback,
  ``xplane.py:773-775``: a GPU has no module line);
* **category fractions** — the same intervals split into mxu, vector,
  data, infeed, outfeed and collective time by :func:`categorize`, with
  leaf attribution so overlapping streams never count twice;
* **achieved TFLOP/s** — the window's op FLOPs (``with_flops``) over the
  window, all ops and the mxu-category ones apart.

The profiler counts no bytes per op, so the achieved HBM rates stay None
and the HBM families stay on the probes, as the reference does for a trace
without byte stats.  A trace carries no capability stats either: the peaks
come from the port's table (:func:`tpumon_torch.types.gpu_caps`).

**CUDA graphs.**  A graph's replay runs no aten op, so its kernels come
with no launching op and no FLOPs.  :func:`record_graph_program` runs the
graph's work once eagerly and once as a replay in one session and
records which op launches each record of a replay, and the ops' FLOPs
(:class:`GraphProgram`); :func:`kineto_records` then reads each graph
launch whose records match a recorded program by it.

* **collective wire bytes** — the bytes the window's collectives moved
  (:mod:`tpumon_torch.collectives`, read from the process group backend's
  own events), split ICI (NVLink) and DCN by the group each ran over, with
  the reference's two gates (``xplane.py:782-972``; :func:`wire_fields`):
  the physics ceiling (the card's NVLink total from the capability table)
  and the timeline (the bytes at that ceiling must fit in the collective
  time the same capture saw).

Not ported: the XSpace protobuf parser and the profiler options of
``xplane.py:62-530`` and ``:1362-1430`` — Kineto hands its events over in
process (:func:`kineto_records`) or as a Chrome trace
(:func:`analyze_kineto_file`, which carries no shapes, so its wire-byte
fields stay None).

**The session's thread.**  ``torch.profiler`` attaches its op callbacks to
the thread that opens the session (autograd's worker threads inherit
them); ops of other threads come without FLOPs and without a link to the
kernels they launch, while the device records come from CUPTI for the
whole process.  So :class:`TraceEngine` opens its session on the caller's
thread without blocking — the workload's own sweep, or its step callback
— and the first :meth:`TraceEngine.sample` or :meth:`TraceEngine.poll` on
that thread after the window has elapsed closes it; the events are parsed
on a daemon thread.  Every profiler session the port opens holds
:data:`PROFILER_LOCK`: a nested session does not raise, it silently ends
the outer one.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Dict, Iterator, List, NamedTuple, Optional, Tuple

from . import log
from .collectives import CommRecord, comm_records, split_bytes
from .types import gpu_caps

# -- categories ----------------------------------------------------------------

#: the port's own kernels, by name (they launch through ctypes, so no aten
#: op encloses them)
_PORT_MXU_RE = re.compile(r"\b(flash_\w+_kernel|mxu_kernel)\b")
_PORT_VECTOR_RE = re.compile(r"\bstream_kernel\b")
#: conv(?!ert): convolution/cudnn_convolution yes, a dtype cast no
_CONV_RE = re.compile(r"conv(?!ert)")
_MXU_OPS = frozenset({"mm", "addmm", "bmm", "baddbmm", "addbmm", "matmul",
                      "linear", "mv", "addmv", "dot", "einsum",
                      "_scaled_mm"})
_DATA_OPS = frozenset({"copy_", "_to_copy", "to", "cat", "clone",
                       "contiguous", "stack", "constant_pad_nd",
                       "narrow_copy", "_copy_from",
                       "_copy_from_and_resize"})
_DATA_OP_PREFIXES = ("index", "_index", "scatter", "gather")
_MXU_KERNEL_RE = re.compile(r"gemm|nvjet|xmma|cutlass|wgmma")


def op_category(op_name: str) -> str:
    """Category of the work an aten op launches: matmuls, convolutions and
    attention are mxu; copies, casts, concatenation and indexing data;
    c10d/NCCL collective; every other op vector."""

    low = op_name.lower()
    if (low.startswith("c10d::") or "nccl" in low
            or low == "record_param_comms"):
        return "collective"
    base = op_name.rsplit("::", 1)[-1]
    if base in _MXU_OPS or _CONV_RE.search(base) or "attention" in base:
        return "mxu"
    if base in _DATA_OPS or base.startswith(_DATA_OP_PREFIXES):
        return "data"
    return "vector"


def _route(kernel_name: str, op_name: Optional[str] = None
           ) -> Tuple[str, bool]:
    """(category, exact) of one device record.  Exact routes: the port's
    kernels by name, a memcpy or memset by the direction CUPTI records for
    it, and the aten op that launched the kernel; then the kernel's own
    name, a lower bound; then vector."""

    if _PORT_MXU_RE.search(kernel_name):
        return "mxu", True
    if _PORT_VECTOR_RE.search(kernel_name):
        return "vector", True
    # a copy's direction before its op: a host-to-device copy runs under
    # aten::copy_ and a scalar read under aten::_local_scalar_dense, and
    # the op would hide the transfers the infeed/outfeed families show
    if kernel_name.startswith("Memcpy"):
        if "HtoD" in kernel_name:
            return "infeed", True
        if "DtoH" in kernel_name:
            return "outfeed", True
        return "data", True
    if kernel_name.startswith("Memset"):
        return "data", True
    if op_name:
        return op_category(op_name), True
    low = kernel_name.lower()
    if _MXU_KERNEL_RE.search(low) or ("cudnn" in low and _CONV_RE.search(low)):
        return "mxu", False
    if "nccl" in low:
        return "collective", False
    return "vector", False


def categorize(kernel_name: str, op_name: Optional[str] = None) -> str:
    """Device record -> {mxu, vector, data, collective, infeed, outfeed}
    (the counterpart of ``xplane.categorize``), by the first route that
    applies: the port's own kernels by name (``flash_*_kernel`` and
    ``mxu_kernel`` mxu, ``stream_kernel`` vector); a memcpy or memset by
    its direction (HtoD infeed, DtoH outfeed, the rest data); the aten op
    that launched the kernel (:func:`op_category`); the kernel's own name
    (cuBLAS/CUTLASS/cuDNN convolution kernels mxu, NCCL collective);
    otherwise vector."""

    return _route(kernel_name, op_name)[0]


def union_ps(intervals: List[Tuple[int, int]]) -> int:
    """Total covered picoseconds of (start, end) intervals (events on one
    timeline may still overlap across streams; double counting would
    report duty > 1)."""

    if not intervals:
        return 0
    intervals = sorted(intervals)
    total = 0
    cur_s, cur_e = intervals[0]
    for s, e in intervals[1:]:
        if s > cur_e:
            total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    total += cur_e - cur_s
    return total


def leaf_attribution(
        intervals: List[Tuple[int, int, str]]) -> Dict[str, int]:
    """Attribute each covered instant to the INNERMOST event covering it.

    Summing raw durations double-counts every level of nested or
    overlapping events; flame-style leaf attribution keeps category
    fractions a partition of busy time.

    ``intervals``: (start_ps, end_ps, category).  Events on one timeline
    nest or are disjoint; partial overlap (concurrent streams) degrades
    gracefully — later-starting events win the overlap.
    """

    out: Dict[str, int] = {}
    evs = sorted(intervals, key=lambda t: (t[0], -t[1]))
    stack: List[Tuple[int, str]] = []  # (end_ps, category)
    cursor = 0

    def credit(upto: int) -> None:
        nonlocal cursor
        if stack and upto > cursor:
            cat = stack[-1][1]
            out[cat] = out.get(cat, 0) + upto - cursor
        cursor = max(cursor, upto)

    for s, e, cat in evs:
        while stack and stack[-1][0] <= s:
            credit(stack[-1][0])  # close the inner event first...
            stack.pop()           # ...then resume crediting its parent
        credit(s)
        if not stack:
            cursor = s
        stack.append((e, cat))
    while stack:
        credit(stack[-1][0])
        stack.pop()
    return out


@dataclass
class TraceSample:
    """Measured utilization for one device over one capture window."""

    ts: float                      # monotonic at capture end
    window_s: float                # host wall window of the capture
    duty: float                    # 0..1, device busy running work
    busy_s: float                  # absolute busy seconds in the window
    mxu_frac: float                # of WINDOW: time in MXU-category work
    vector_frac: float
    data_frac: float
    infeed_stall: float
    outfeed_stall: float
    collective_stall: float
    achieved_tflops: Optional[float] = None
    #: None here: the profiler counts no bytes per op
    achieved_hbm_gbps: Optional[float] = None
    achieved_rd_gbps: Optional[float] = None
    achieved_wr_gbps: Optional[float] = None
    peak_tflops: Optional[float] = None
    peak_hbm_gbps: Optional[float] = None
    device_type: Optional[str] = None
    n_ops: int = 0
    #: achieved TFLOP/s from MXU-category ops only
    mxu_tflops: Optional[float] = None
    #: True when >=95% of leaf-attributed busy time came from exact routes
    #: (the port's kernels, copies by direction, the launching aten op) —
    #: the category split is then exact, not a name-match lower bound
    exact_categories: bool = False
    #: the wire-byte attribution's fields (:func:`wire_fields`): None
    #: where the capture was not attributed
    ici_bytes_per_s: Optional[float] = None
    dcn_bytes_per_s: Optional[float] = None
    ici_ceiling_gbps: Optional[float] = None
    attribution_consistency: Optional[float] = None
    attribution_suspect: bool = False
    dcn_op_latency_us: Optional[float] = None
    gate_eligible_bytes: Optional[int] = None
    #: the backend's collective events the attribution read
    collective_events: Optional[int] = None


# -- analysis ------------------------------------------------------------------


class TraceRecord(NamedTuple):
    """One event of a capture, neutral to where it was read from."""

    #: "device" (a kernel, memcpy or memset the device ran) or "op" (an
    #: aten op on the host)
    kind: str
    #: device ordinal; for an op, the device its kernels ran on (None when
    #: it launched none)
    device: Optional[int]
    start_ns: int
    end_ns: int
    name: str
    #: the aten op that launched a device record, when known
    op: Optional[str] = None
    #: an op's FLOPs (``with_flops``)
    flops: int = 0


#: slack of the timeline gate for skew between host and device clocks
#: (the reference's, ``xplane.py:731``)
ATTRIBUTION_MARGIN = 1.25


def wire_fields(comms: List[CommRecord], busy: List[Tuple[int, int]],
                window_s: float, ceiling_gbps: Optional[float],
                slices: bool) -> Dict[str, object]:
    """The wire-byte fields of a :class:`TraceSample` from one capture's
    collectives (``xplane.py:888-972``).

    ``busy``: (start_ns, end_ns) of the collective time the capture saw
    (the backend events' host spans, and the collective kernels on the
    device).  ``slices``: the job registered a slice axis, so the bytes
    of groups that cross slices are the DCN share (else every byte is
    ICI and the DCN fields are blank, the nil rule).  Two gates, as the
    reference's: physics (the ICI rate above the card's NVLink ceiling)
    and timeline (the wire-seconds the bytes need at that ceiling, over
    the collective time observed, above :data:`ATTRIBUTION_MARGIN`; zero
    observed time with bytes is the extreme over-count).  Every event is
    a whole synchronous execution inside the window, so all its bytes are
    gate-eligible.  No ceiling (an unknown card, or one without NVLink):
    neither gate runs."""

    if slices:
        ici, dcn = split_bytes(comms)
    else:  # no slice axis: nothing classifies as DCN
        ici, dcn = sum(c.wire for c in comms), 0
    gate_bytes = ici + dcn
    dcn_spans = [c.end_ns - c.start_ns for c in comms
                 if c.dcn and slices]
    consistency = None
    suspect = False
    if ceiling_gbps and gate_bytes > 0:
        ceiling_bps = ceiling_gbps * 1e9
        coll_s = union_ps([(s * 1000, e * 1000) for s, e in busy]) / 1e12
        consistency = (gate_bytes / ceiling_bps) / max(coll_s, 1e-9)
        # the physics gate is ICI-only: DCN bytes ride no NVLink
        suspect = (ici / window_s > ceiling_bps or
                   consistency > ATTRIBUTION_MARGIN)
    return dict(
        ici_bytes_per_s=ici / window_s,
        dcn_bytes_per_s=(dcn / window_s) if slices else None,
        ici_ceiling_gbps=ceiling_gbps or None,
        attribution_consistency=consistency,
        attribution_suspect=suspect,
        dcn_op_latency_us=((sum(dcn_spans) / len(dcn_spans)) / 1e3
                           if dcn_spans else None),
        gate_eligible_bytes=gate_bytes,
        collective_events=len(comms))


def _device_sample(recs: List[TraceRecord], window_s: float,
                   flops: Optional[List[int]], name: Optional[str],
                   ts: float, comms: Optional[List[CommRecord]] = None,
                   slices: bool = False) -> TraceSample:
    window_ps = max(window_s, 1e-9) * 1e12
    ivals = [(r.start_ns * 1000, r.end_ns * 1000) for r in recs]
    busy = union_ps(ivals)
    tagged: List[Tuple[int, int, str]] = []
    exactness: List[Tuple[int, int, str]] = []
    for r, (s, e) in zip(recs, ivals):
        cat, exact = _route(r.name, r.op)
        tagged.append((s, e, cat))
        exactness.append((s, e, "y" if exact else "n"))
    cat_ps = leaf_attribution(tagged)
    cy = leaf_attribution(exactness)
    cat_total = cy.get("y", 0) + cy.get("n", 0)
    exact_cats = cat_total > 0 and cy.get("y", 0) / cat_total >= 0.95

    def frac(cat: str) -> float:
        return min(1.0, cat_ps.get(cat, 0) / window_ps)

    caps = gpu_caps(name) if name else None
    wire: Dict[str, object] = {}
    if comms is not None:
        coll = [(c.start_ns, c.end_ns) for c in comms]
        coll += [(r.start_ns, r.end_ns) for r, (_, _, cat)
                 in zip(recs, tagged) if cat == "collective"]
        wire = wire_fields(comms, coll, max(window_s, 1e-9),
                           caps.nvlink_gbps if caps else None, slices)
    return TraceSample(
        ts=ts,
        window_s=window_s,
        duty=min(1.0, busy / window_ps),
        busy_s=busy / 1e12,
        mxu_frac=frac("mxu"),
        vector_frac=frac("vector"),
        data_frac=frac("data"),
        infeed_stall=frac("infeed"),
        outfeed_stall=frac("outfeed"),
        collective_stall=frac("collective"),
        achieved_tflops=(flops[0] / window_s / 1e12) if flops else None,
        mxu_tflops=(flops[1] / window_s / 1e12) if flops else None,
        exact_categories=exact_cats,
        peak_tflops=caps.bf16_tflops if caps else None,
        peak_hbm_gbps=caps.hbm_gbps if caps else None,
        device_type=name,
        n_ops=len(recs),
        **wire,
    )


def analyze(records: List[TraceRecord], window_s: float,
            devices: Dict[int, str],
            comms: Optional[List[CommRecord]] = None,
            comm_device: int = 0, slices: bool = False
            ) -> Dict[int, TraceSample]:
    """Records of one capture -> {device ordinal: sample}.

    ``devices``: the name of each device the capture covered (peaks come
    from the capability table by name).  A capture that covered devices
    but recorded no device work at all reads duty 0 on each of them —
    idle, not missing data (the counterpart of the reference's ``#ChipN``
    rule, and like it only for the all-idle capture).

    ``comms``: the capture's collectives (:func:`tpumon_torch.collectives.
    comm_records`), run on ``comm_device`` (this process's card; its
    other cards moved nothing of this process's); None leaves the
    wire-byte fields blank.  ``slices``: see :func:`wire_fields`.
    """

    now = time.monotonic()
    by_dev: Dict[int, List[TraceRecord]] = {}
    flops: Dict[int, List[int]] = {}  # device -> [all, mxu]
    for r in records:
        if r.device is None:
            continue
        if r.kind == "op":
            if r.flops > 0:
                acc = flops.setdefault(r.device, [0, 0])
                acc[0] += r.flops
                if op_category(r.name) == "mxu":
                    acc[1] += r.flops
        else:
            by_dev.setdefault(r.device, []).append(r)
    def mine(d: int) -> Optional[List[CommRecord]]:
        if comms is None:
            return None
        return comms if d == comm_device else []

    if not by_dev:
        return {d: _device_sample([], window_s, None, name, now, mine(d),
                                  slices)
                for d, name in devices.items()}
    return {d: _device_sample(recs, window_s, flops.get(d), devices.get(d),
                              now, mine(d), slices)
            for d, recs in by_dev.items()}


def _propagate_devices(ops) -> None:
    """An op's device is that of the kernels it launched, else that of the
    ops nested in it on its thread (``aten::conv2d`` carries the FLOPs,
    its inner ``aten::cudnn_convolution`` launches the kernels).  ``ops``:
    [name, thread, start, end, flops, device] lists, updated in place."""

    by_thread: Dict[int, list] = {}
    for o in ops:
        by_thread.setdefault(o[1], []).append(o)
    for lst in by_thread.values():
        lst.sort(key=lambda o: (o[2], -o[3]))
        stack: list = []

        def pop() -> None:
            child = stack.pop()
            if stack and stack[-1][5] is None:
                stack[-1][5] = child[5]

        for o in lst:
            while stack and stack[-1][3] <= o[2]:
                pop()
            stack.append(o)
        while stack:
            pop()


#: the profiler's own host events, besides CUDA runtime and driver calls:
#: their correlation ids count in CUPTI's id space, which can collide with
#: an op's (kernels of the first launches have been seen "linked" to them)
_PROFILER_EVENTS = frozenset({"Activity Buffer Request",
                              "Lazy Function Loading"})


def _is_op(name: str) -> bool:
    return not (name.startswith("cu") or name in _PROFILER_EVENTS)


#: a capture whose kernel launches lack their kernel records beyond this
#: share (and beyond one: CUPTI has dropped single records) lost them —
#: CUPTI has dropped every kernel record of a capture on the card while
#: keeping its copies: it fails rather than under-read
LOST_KERNELS_LIMIT = 0.01
#: launches this close to the session's edges may have their kernels
#: outside the recording; see :func:`kineto_records`
EDGE_NS = 5_000_000


class LostRecords(RuntimeError):
    """The profiler recorded kernel launches whose kernels it lost."""


#: the runtime call that launches a CUDA graph (``cudaGraphLaunch`` and its
#: versioned names)
GRAPH_LAUNCH = "cudaGraphLaunch"


class _Parsed(NamedTuple):
    """One live session's events, sorted by kind (see :func:`_parse`)."""

    #: device records: (device, start, end, name, correlation id, linked
    #: correlation id)
    dev: List[Tuple[int, int, int, str, int, int]]
    #: aten ops by correlation id: [name, thread, start, end, flops, device]
    ops: Dict[int, list]
    #: host kernel and graph launches: (start, correlation id)
    launches: List[Tuple[int, int]]
    #: correlation ids of graph launches
    graph_launches: frozenset
    t_first: Optional[int]
    t_sync: Optional[int]


def _parse(events) -> _Parsed:
    from torch.autograd import DeviceType

    cuda = DeviceType.CUDA
    ops: Dict[int, list] = {}
    dev: List[Tuple[int, int, int, str, int, int]] = []
    launches: List[Tuple[int, int]] = []
    graphs = set()
    t_first: Optional[int] = None  # the session's first host event
    t_sync: Optional[int] = None   # its last device synchronize
    for e in events:
        start = e.start_ns()
        end = start + e.duration_ns()
        name = e.name()
        if e.device_type() == cuda:
            dev.append((e.device_index(), start, end, name,
                        e.correlation_id(), e.linked_correlation_id()))
            continue
        t_first = start if t_first is None else min(t_first, start)
        if "LaunchKernel" in name or name.startswith(GRAPH_LAUNCH):
            launches.append((start, e.correlation_id()))
            if name.startswith(GRAPH_LAUNCH):
                graphs.add(e.correlation_id())
        elif name == "cudaDeviceSynchronize":
            t_sync = start if t_sync is None else max(t_sync, start)
        elif e.linked_correlation_id() == 0 and _is_op(name):
            ops[e.correlation_id()] = [name, e.start_thread_id(), start,
                                       end, e.flops(), None]
    return _Parsed(dev, ops, launches, frozenset(graphs), t_first, t_sync)


def _by_graph_launch(p: _Parsed) -> Dict[int, list]:
    """Device records of each graph launch (they share its correlation
    id), in the order they ran."""

    out: Dict[int, list] = {}
    for r in p.dev:
        if r[4] in p.graph_launches:
            out.setdefault(r[4], []).append(r)
    for recs in out.values():
        recs.sort(key=lambda r: r[1])
    return out


def kineto_records(events) -> List[TraceRecord]:
    """Records from the ``KinetoEvent`` list of a live session: every
    device record with the aten op that launched it (a kernel's linked
    correlation id is that op's correlation id), and every op with FLOPs
    with the device it ran on.

    A CUDA graph's replay runs no op: the device records of one graph
    launch (they share its correlation id) whose names are those of a
    recorded :class:`GraphProgram` take their ops from it, and the
    program's op FLOPs count once for each such launch.  Other graph
    records keep no op.

    Each kernel or graph launch the session recorded on the host must
    have its device records (they share a correlation id):
    :class:`LostRecords` when more than one and more than
    ``LOST_KERNELS_LIMIT`` of them do not.  Only the edges are exempt:
    launches within ``EDGE_NS`` of the session's first host event, and
    those after the start of its last ``cudaDeviceSynchronize`` (less
    ``EDGE_NS``) -- closing a session synchronizes the device and then
    stops the recording, so another thread's launches during the
    synchronize can run after it.  Without a recorded synchronize the last
    launch stands for it."""

    p = _parse(events)
    kernels = {r[4] for r in p.dev if not r[3].startswith(("Memcpy",
                                                             "Memset"))}
    if p.launches:
        t_close = (p.t_sync if p.t_sync is not None
                   else max(t for t, _ in p.launches))
        due = [c for t, c in p.launches
               if p.t_first + EDGE_NS <= t < t_close - EDGE_NS]
    else:
        due = []
    lost = sum(1 for c in due if c not in kernels)
    if lost > max(1, LOST_KERNELS_LIMIT * len(due)):
        raise LostRecords(f"the profiler lost {lost} of {len(due)} kernel "
                          f"records (of {len(p.launches)} launches; device "
                          f"synchronize recorded: {p.t_sync is not None})")
    graph_op: Dict[Tuple[int, int, int], str] = {}
    graph_flops: List[TraceRecord] = []
    for recs in _by_graph_launch(p).values():
        prog = _GRAPH_PROGRAMS.get(program_key(r[3] for r in recs))
        if prog is None:
            continue
        for r, op in zip(recs, prog.ops):
            if op is not None:
                graph_op[r[:3]] = op
        d, s, t = recs[0][0], recs[0][1], recs[-1][2]
        graph_flops += [TraceRecord("op", d, s, t, op, None, fl)
                        for op, fl in prog.flops]
    out: List[TraceRecord] = []
    for d, s, t, name, corr, linked in p.dev:
        if corr in p.graph_launches:
            out.append(TraceRecord("device", d, s, t, name,
                                   graph_op.get((d, s, t))))
            continue
        op = p.ops.get(linked) if linked else None
        if op is not None and op[5] is None:
            op[5] = d
        out.append(TraceRecord("device", d, s, t, name,
                               op[0] if op is not None else None))
    _propagate_devices(list(p.ops.values()))
    out += [TraceRecord("op", o[5], o[2], o[3], o[0], None, o[4])
            for o in p.ops.values() if o[4] > 0]
    return out + graph_flops


#: Chrome-trace categories of device records
_DEVICE_CATS = frozenset({"kernel", "gpu_memcpy", "gpu_memset"})


def load_kineto_file(path: str
                     ) -> Tuple[List[TraceRecord], Dict[int, str]]:
    """A saved Chrome trace (``export_chrome_trace``) -> (records, the name
    of each device in its ``deviceProperties``).  Kernels link to their op
    through ``External id``.  The file carries no FLOPs."""

    with open(path, encoding="utf-8") as f:
        trace = json.load(f)
    devices = {int(p["id"]): str(p.get("name", ""))
               for p in trace.get("deviceProperties", [])}
    ops: Dict[object, str] = {}
    dev = []
    for ev in trace.get("traceEvents", []):
        if ev.get("ph") != "X":
            continue
        cat = ev.get("cat")
        args = ev.get("args") or {}
        if cat == "cpu_op" and "External id" in args:
            ops[args["External id"]] = ev["name"]
        elif cat in _DEVICE_CATS:
            start = round(float(ev["ts"]) * 1000)
            dev.append((int(args.get("device", 0)), start,
                        start + round(float(ev.get("dur", 0)) * 1000),
                        ev["name"], args.get("External id")))
    return ([TraceRecord("device", d, s, e, name, ops.get(ext))
             for d, s, e, name, ext in dev], devices)


def analyze_kineto_file(path: str, window_s: float
                        ) -> Dict[int, TraceSample]:
    """Parse a saved Chrome trace -> {device ordinal: sample}.  The TFLOP/s
    stay None: the file carries no FLOPs."""

    records, devices = load_kineto_file(path)
    return analyze(records, window_s, devices)


# -- CUDA graphs ---------------------------------------------------------------

class GraphProgram(NamedTuple):
    """What one launch of a CUDA graph runs, for :func:`kineto_records`."""

    #: the names of its device records, in the order they run
    names: Tuple[str, ...]
    #: the aten op that launches each in an eager run of the same work
    #: (None where the two did not line up)
    ops: Tuple[Optional[str], ...]
    #: (op, FLOPs) of each op of the eager run with FLOPs
    flops: Tuple[Tuple[str, int], ...]

    @property
    def matched(self) -> float:
        """Share of the launch's records that took an op."""

        return sum(op is not None for op in self.ops) / max(len(self.ops), 1)


#: recorded graph programs by :func:`program_key` (a replay that ran the
#: same records reads as the program)
_GRAPH_PROGRAMS: Dict[Tuple[str, ...], GraphProgram] = {}


def program_key(names) -> Tuple[str, ...]:
    """The record names of a graph launch as programs are looked up by,
    a copy's or fill's reduced to its kind: from one session of a process
    to the next, CUPTI reports a graph's copy node as ``Memcpy DtoD
    (Device -> Device)`` or as the kernel that runs it (``memcpy128``,
    ``memcpy32_post``), and names a fill by what it knows of the memory
    (``Memset (Unknown)``, ``Memset (Device)``)."""

    return tuple(n[:6].capitalize() if n[:6].lower() in ("memcpy", "memset")
                 else n for n in names)


def graph_program(events) -> GraphProgram:
    """The program of a graph from one session's ``events`` that ran its
    work twice: once eagerly (ops linked to their kernels) and once as
    one launch of the graph.  The two record sequences line up by
    :func:`program_key` (``difflib``: the same ops launch the same kernels
    in the same order), and by position where a run differs at the same
    length; each record of the launch takes the op of its eager twin."""

    import difflib

    p = _parse(events)
    launches = list(_by_graph_launch(p).values())
    if len(launches) != 1:
        raise ValueError(f"{len(launches)} graph launches recorded, want 1")
    eager = kineto_records([e for e in events
                            if e.correlation_id() not in p.graph_launches])
    dev = sorted((r for r in eager if r.kind == "device"),
                 key=lambda r: r.start_ns)
    names = tuple(r[3] for r in launches[0])
    ops: List[Optional[str]] = [None] * len(names)
    sm = difflib.SequenceMatcher(None, program_key(r.name for r in dev),
                                 program_key(names), autojunk=False)
    for tag, a0, a1, b0, b1 in sm.get_opcodes():
        # equal runs, and runs of the same length between them
        if tag == "equal" or (tag == "replace" and a1 - a0 == b1 - b0):
            for i in range(b1 - b0):
                ops[b0 + i] = dev[a0 + i].op
    return GraphProgram(names, tuple(ops),
                        tuple((r.name, r.flops) for r in eager
                              if r.kind == "op"))


def record_graph_program(eager, replay) -> GraphProgram:
    """Run ``eager()`` (the graph's work, run eagerly) and then ``replay()``
    (one launch of the graph) in one profiler session on the calling
    thread, closed as the engine closes its sessions; record and return
    their :class:`GraphProgram`."""

    import torch
    from torch.profiler import ProfilerActivity, profile

    with profiler_session():
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA], with_flops=True)
        prof.start()
        try:
            eager()
            torch.cuda.synchronize()
            replay()
            torch.cuda.synchronize()
        finally:
            result = close_session(prof)
    prog = graph_program(list(result.events()))
    _GRAPH_PROGRAMS[program_key(prog.names)] = prog
    return prog


# -- periodic capture engine ---------------------------------------------------

#: Kineto's switch: "1" tears CUPTI down when a session closes, "0" keeps
#: it up (torch 2.11 on the card keeps it up unless told)
TEARDOWN_ENV = "TEARDOWN_CUPTI"
#: how long after a torn-down close Kineto's teardown thread may still be
#: arming the finalize (a 50 ms wait was once too short on the card)
TEARDOWN_ARM_S = 0.5
#: how long the closing thread keeps making CUDA calls after a torn-down
#: close, so that the finalize lands there, long before any next session
CLOSE_SETTLE_S = 0.05
#: monotonic time of the last close that tore CUPTI down and has not been
#: settled (guarded by PROFILER_LOCK: every session opens and closes
#: under it)
_torn_at: Optional[float] = None


def mark_teardown() -> None:
    """Record a close that tore CUPTI down (caller holds PROFILER_LOCK)."""

    global _torn_at
    _torn_at = time.monotonic()


def _synchronize_until(deadline: float) -> None:
    """Synchronize the device at least once, and until ``deadline``."""

    import torch

    while True:
        torch.cuda.synchronize()
        if time.monotonic() >= deadline:
            return
        time.sleep(0.005)


def settle_teardown() -> None:
    """Let the last torn-down close land before a session opens (caller
    holds PROFILER_LOCK).  Kineto tears CUPTI down on a thread of its own,
    which arms a finalize that runs in the exit callback of the process's
    next CUDA runtime or driver call; a session opened before that call
    has its recording ended by the finalize and keeps no device records
    (``python -m tpumon_torch.loadgen.capture_effect --teardown-pairs``).
    So once ``TEARDOWN_ARM_S`` has passed since the close, one device
    synchronize makes that call; a workload stepping in between has
    made it long before, and then this costs one synchronize."""

    global _torn_at
    if _torn_at is None:
        return
    import torch

    if torch.cuda.is_initialized():  # no CUDA context, no CUPTI
        _synchronize_until(_torn_at + TEARDOWN_ARM_S)
    _torn_at = None


#: held by every profiler session the port opens: the engine's captures
#: (never waiting: a capture that finds it taken fails and backs off) and
#: any other session (:func:`profiler_session`)
PROFILER_LOCK = threading.Lock()


@contextlib.contextmanager
def profiler_session(timeout_s: float = 60.0) -> Iterator[None]:
    """Hold :data:`PROFILER_LOCK` around a profiler session opened outside
    the engine; raises when it stays taken for ``timeout_s``."""

    if not PROFILER_LOCK.acquire(timeout=timeout_s):
        raise RuntimeError("another profiler session of this process stayed "
                           f"open for {timeout_s} s")
    try:
        settle_teardown()
        yield
        if os.environ.get(TEARDOWN_ENV) == "1":
            mark_teardown()
    finally:
        PROFILER_LOCK.release()


def close_session(prof):
    """Close a profiler session on its thread (synchronizing the device,
    so the window's kernels are all recorded) -> its Kineto result.

    CUPTI is torn down at the close (:data:`TEARDOWN_ENV`), unless the
    environment sets the switch itself (torch sets it to 0 for inductor's
    CUDA graphs before CUDA 12.6; the port's graph replays run torn-down
    captures on CUDA 12.8, ``chip_smoke.py``).  Left up, CUPTI costs the eager bench step
    a tenth to a fifth of its rate for the rest of the process,
    whatever the session recorded (``python -m
    tpumon_torch.loadgen.capture_effect``); torn down, the next
    session must not open before the teardown has landed
    (:func:`settle_teardown`)."""

    explicit = os.environ.get(TEARDOWN_ENV)
    if explicit is None:
        os.environ[TEARDOWN_ENV] = "1"
    try:
        prof.stop()
    finally:
        if explicit is None:
            os.environ.pop(TEARDOWN_ENV, None)
    from torch.profiler import ProfilerActivity

    # a session without the CUDA activity never brought CUPTI up
    if ((explicit or "1") == "1" and
            ProfilerActivity.CUDA in prof.activities):
        mark_teardown()
        _synchronize_until(time.monotonic() + CLOSE_SETTLE_S)
    return prof.profiler.kineto_results


class _Session:
    """One open profiler session of the engine."""

    __slots__ = ("prof", "thread", "t_open", "t0", "want_s", "forced",
                 "init_s", "background")

    def __init__(self, prof, t_open: float, want_s: float, forced: bool,
                 init_s: float, background: bool) -> None:
        self.prof = prof
        self.thread = threading.get_ident()
        self.t_open = t_open
        self.t0 = time.monotonic()
        self.want_s = want_s
        self.forced = forced
        #: the profiler's one-time initialization inside this session's open
        self.init_s = init_s
        self.background = background


class TraceEngine:
    """Periodic short profiler captures -> cached per-device TraceSamples.

    The counterpart of ``xplane.TraceEngine``, with its controls: the
    cadence (``min_interval_s``) and staleness, the single-flight claim,
    the DUTY CAP (the effective cadence stretches to measured capture
    cost / ``duty_cap``), the ADAPTIVE WINDOW (a capture costing more than
    ``cost_target_s`` shrinks the window toward ``WINDOW_FLOOR_MS``),
    forced captures at the configured ceiling window that skip both
    controllers, the failure backoff and an atexit quiesce.  Tune with
    ``TPUMON_CUDA_TRACE_MS`` / ``_INTERVAL`` / ``_DUTY`` /
    ``_COST_TARGET``; ``TPUMON_CUDA_TRACE=0`` turns the backend's engine
    off.

    Unlike the reference's background capture, a session belongs to the
    thread that opened it (module docstring): :meth:`sample` opens one on
    the calling thread and returns; the first :meth:`sample` or
    :meth:`poll` on that thread after the window closes it, and a daemon
    thread parses it.  ``sample(wait=True)`` and :meth:`capture_now` run
    the whole capture on the calling thread (``capture_now(step=...)``
    steps the workload inside the window).  A capture that finds
    :data:`PROFILER_LOCK` taken, or a session already open on its thread
    (the workload's own profiler wins), fails and backs off; so does one
    where CUDA is not available (it never records the host alone).
    """

    MAX_CONSECUTIVE_FAILURES = 3
    #: adaptive-window floor: at bench step rates a 50 ms window still
    #: holds a step or more, below which duty/category fractions get too
    #: grainy to trust
    WINDOW_FLOOR_MS = 50.0

    def __init__(self, capture_ms: Optional[float] = None,
                 min_interval_s: Optional[float] = None) -> None:
        def _env_f(name: str, default: float) -> float:
            try:
                return float(os.environ.get(name, "") or default)
            except ValueError:
                return default

        self.capture_ms = capture_ms if capture_ms is not None else \
            _env_f("TPUMON_CUDA_TRACE_MS", 250.0)
        self.min_interval = min_interval_s if min_interval_s is not None \
            else _env_f("TPUMON_CUDA_TRACE_INTERVAL", 15.0)
        #: perturbation-duty cap (0 pins the configured cadence)
        self.duty_cap = _env_f("TPUMON_CUDA_TRACE_DUTY", 0.02)
        #: per-capture cost target of the adaptive window (0 disables it)
        self.cost_target_s = _env_f("TPUMON_CUDA_TRACE_COST_TARGET", 0.5)
        #: current adaptive window (ms), never above ``capture_ms``
        self._window_ms = self.capture_ms
        #: EWMA of measured per-capture cost (all but the window itself)
        self._cost_ewma_s: Optional[float] = None
        self._lock = threading.Lock()
        self._samples: Dict[int, TraceSample] = {}
        self._last_attempt = -1e18
        self._failures = 0
        self._disabled_until = 0.0
        #: single-flight claim, held from open to the end of the parse
        self._capturing = False
        self._captures_ok = 0
        self._captures_failed = 0
        #: wall seconds with the session open, host seconds parsing
        self._capture_wall_s = 0.0
        self._capture_parse_s = 0.0
        #: (t_open, t_done) of recent captures, for the runner's
        #: within-run capture-step-cost estimator
        self._capture_spans: deque = deque(maxlen=256)
        #: open time of the capture in flight (None outside one)
        self._open_since: Optional[float] = None
        #: the open session; read without the lock on the hot path (one
        #: attribute load), written only by the thread that holds the claim
        self._session: Optional[_Session] = None
        #: name of each device a CUDA capture covers, read at the first one
        self._devices: Optional[Dict[int, str]] = None
        #: the card this process's collectives run on (read at each open)
        self._comm_device = 0
        #: the job's slice count (:meth:`set_slices`)
        self.slices = 1
        self._atexit_registered = False
        #: a session has been opened (see _open)
        self._started = False
        #: terminal no-more-captures state (see quiesce)
        self._quiesced = False
        #: why the latest failed capture failed (None: none failed yet)
        self.last_error: Optional[str] = None

    def _effective_interval(self) -> float:
        """Capture cadence honoring the duty cap; ``min_interval <= 0``
        means on-demand capture and is never stretched."""

        if (self.min_interval <= 0 or self.duty_cap <= 0
                or not self._cost_ewma_s):
            return self.min_interval
        return max(self.min_interval, self._cost_ewma_s / self.duty_cap)

    @property
    def stale_after_s(self) -> float:
        """Serve a sample only this long; scales with the effective
        cadence so a duty-stretched engine keeps serving between captures."""

        return max(3 * self._effective_interval(), 45.0)

    # -- public ----------------------------------------------------------------

    def peek(self, index: int) -> Optional[TraceSample]:
        """The fresh sample :meth:`sample` would serve, after closing an
        elapsed session this thread holds; opens no session."""

        self.poll()
        with self._lock:
            s = self._samples.get(index)
            if s is not None and time.monotonic() - s.ts < self.stale_after_s:
                return s
            return None

    def sample(self, index: int, wait: bool = False) -> Optional[TraceSample]:
        self.poll()
        now = time.monotonic()
        with self._lock:
            s = self._samples.get(index)
            fresh = s is not None and now - s.ts < self.stale_after_s
            due = (now - self._last_attempt >= self._effective_interval()
                   and now >= self._disabled_until
                   and not self._quiesced)
            claim = due and not self._capturing
            if claim:
                self._capturing = True
                self._last_attempt = now
        if claim:
            if wait:
                self._capture(window_ms=None, forced=False)
            else:
                if not self._atexit_registered:
                    import atexit

                    atexit.register(self.quiesce)
                    self._atexit_registered = True
                self._open(window_ms=None, forced=False, background=True)
        if wait:
            with self._lock:
                s = self._samples.get(index)
                if (s is not None and
                        time.monotonic() - s.ts < self.stale_after_s):
                    return s
                return None
        return s if fresh else None

    def poll(self, force: bool = False) -> None:
        """Close the session the calling thread holds once its window has
        elapsed (at once with ``force``, or once quiesced).  Cheap enough
        for every workload step."""

        sess = self._session
        if sess is None or sess.thread != threading.get_ident():
            return
        if not (force or self._quiesced
                or time.monotonic() - sess.t0 >= sess.want_s):
            return
        self._session = None
        self._close(sess)

    def latest(self) -> Dict[int, TraceSample]:
        with self._lock:
            return dict(self._samples)

    def capture_spans(self) -> List[Tuple[float, float]]:
        """Recent capture intervals (monotonic open→done, success and
        failure alike); a capture in flight contributes (open, now)."""

        with self._lock:
            out = list(self._capture_spans)
            if self._capturing and self._open_since is not None:
                out.append((self._open_since, time.monotonic()))
            return out

    def quiesce(self, timeout_s: float = 5.0) -> bool:
        """Stop scheduling new captures, close a session this thread holds
        and wait out the capture in flight.  Terminal (its own flag: the
        failure backoff rewrites ``_disabled_until``).  A session held by
        another thread closes at that thread's next :meth:`poll`; False
        when the capture outlived ``timeout_s``."""

        with self._lock:
            self._quiesced = True
        self.poll()
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            with self._lock:
                if not self._capturing:
                    return True
            time.sleep(0.05)
        return False

    def capture_now(self, timeout_s: float = 30.0, step=None) -> bool:
        """Force one capture at the configured ceiling window on the calling
        thread, ignoring the cadence but not the single-flight claim: a
        capture in flight is waited out — one this thread holds runs out
        its window first.  ``step``, when given, is called in a loop
        inside the windows (the workload stepping on the session's
        thread); otherwise they are slept.  The controllers skip the forced
        capture's cost.  True when this capture landed."""

        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            sess = self._session
            if sess is not None and sess.thread == threading.get_ident():
                if step is not None:
                    step()
                else:
                    time.sleep(max(0.0, sess.t0 + sess.want_s
                                   - time.monotonic()))
                self.poll()
                continue
            with self._lock:
                if self._quiesced:
                    return False
                claimed = not self._capturing
                before_ok = self._captures_ok
                if claimed:
                    self._capturing = True
                    self._last_attempt = time.monotonic()
            if claimed:
                self._capture(window_ms=self.capture_ms, forced=True,
                              step=step)
                with self._lock:
                    return self._captures_ok > before_ok
            time.sleep(0.05)
        return False

    def stats(self) -> Dict[str, float]:
        """Engine health for self-metrics (the reference's keys)."""

        with self._lock:
            samples = list(self._samples.values())
            ages = [time.monotonic() - s.ts for s in samples]
            cons = [s.attribution_consistency for s in samples
                    if s.attribution_consistency is not None]
            return {
                "captures_ok": float(self._captures_ok),
                "captures_failed": float(self._captures_failed),
                "capture_wall_s": self._capture_wall_s,
                "capture_parse_s": self._capture_parse_s,
                "capture_cost_ewma_s": (-1.0 if self._cost_ewma_s is None
                                        else self._cost_ewma_s),
                "capture_window_ms": self._window_ms,
                "effective_interval_s": self._effective_interval(),
                "capturing": float(self._capturing),
                "disabled": float(time.monotonic() < self._disabled_until),
                "sample_age_s": min(ages) if ages else -1.0,
                "attribution_suspect": float(
                    any(s.attribution_suspect for s in samples)),
                "attribution_consistency": max(cons) if cons else -1.0,
            }

    # -- capture ---------------------------------------------------------------

    def _start_profiler(self):
        """Open a torch.profiler session on the calling thread."""

        import torch
        from torch.profiler import ProfilerActivity, profile

        if torch.autograd._profiler_enabled():
            raise RuntimeError("profiler busy: this thread already holds a "
                               "session")
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available")
        if self._devices is None:
            self._devices = {i: torch.cuda.get_device_name(i)
                             for i in range(torch.cuda.device_count())}
        self._comm_device = torch.cuda.current_device()
        # the collectives' sizes are their recorded shapes; a process with
        # no process group runs none, and records no shapes
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA], with_flops=True,
                       record_shapes=torch.distributed.is_available()
                       and torch.distributed.is_initialized())
        prof.start()
        return prof

    _stop_profiler = staticmethod(close_session)

    def set_slices(self, n_slices: int) -> None:
        """Register the job's slice count: with more than one, the DCN
        share of the attribution is served (:func:`wire_fields`)."""

        self.slices = int(n_slices)

    def _collect(self, result, window_s: float) -> Dict[int, TraceSample]:
        events = result.events()
        return analyze(kineto_records(events), window_s,
                       self._devices or {}, comm_records(events),
                       self._comm_device, self.slices > 1)

    def _capture(self, window_ms: Optional[float], forced: bool,
                 step=None) -> None:
        """One whole capture on the calling thread, which holds the claim:
        open, step or sleep through the window, close, parse."""

        if not self._open(window_ms, forced, background=False):
            return
        sess = self._session
        try:
            while self._session is sess:
                if step is not None:
                    step()
                else:
                    time.sleep(max(0.0, sess.t0 + sess.want_s
                                   - time.monotonic()))
                self.poll()
        finally:
            self.poll(force=True)

    def _open(self, window_ms: Optional[float], forced: bool,
              background: bool) -> bool:
        """Open a session on the calling thread (the claim is held).  A
        failure is accounted, releases the claim and returns False."""

        want_ms = window_ms if window_ms is not None else self._window_ms
        t_open = time.monotonic()
        with self._lock:
            self._last_attempt = t_open
            self._open_since = t_open
        try:
            if not PROFILER_LOCK.acquire(blocking=False):
                raise RuntimeError("profiler busy: another session of this "
                                   "process is open")
            try:
                settle_teardown()
                prof = self._start_profiler()
            except BaseException:
                PROFILER_LOCK.release()
                raise
        except Exception:
            self._fail(t_open, None, 0.0, forced)
            return False
        # the first session's open carries the profiler's one-time
        # initialization (seconds on the card): no capture cost, or it
        # would stretch the duty-capped cadence to minutes
        init_s = 0.0 if self._started else time.monotonic() - t_open
        self._started = True
        self._session = _Session(prof, t_open, want_ms / 1000.0, forced,
                                 init_s, background)
        return True

    def _close(self, sess: _Session) -> None:
        window = time.monotonic() - sess.t0
        try:
            try:
                result = self._stop_profiler(sess.prof)
            finally:
                PROFILER_LOCK.release()
        except Exception:
            self._fail(sess.t_open, None, window + sess.init_s,
                       sess.forced)
            return
        t_closed = time.monotonic()
        if sess.background:
            threading.Thread(target=self._parse,
                             args=(sess, result, window, t_closed),
                             daemon=True, name="tpumon-trace-parse").start()
        else:
            self._parse(sess, result, window, t_closed)

    def _parse(self, sess: _Session, result, window: float,
               t_closed: float) -> None:
        try:
            samples = self._collect(result, window)
        except Exception:
            self._fail(sess.t_open, t_closed, window + sess.init_s,
                       sess.forced)
            return
        t_parsed = time.monotonic()
        with self._lock:
            self._samples.update(samples)
            self._failures = 0
            self._captures_ok += 1
            self._account_cost(sess.t_open, t_closed, t_parsed, t_parsed,
                               window + sess.init_s, sess.forced)
            self._capturing = False

    def _fail(self, t_open: float, t_closed: Optional[float], window: float,
              forced: bool) -> None:
        """Account a failed capture, back off after repeated failures and
        release the claim."""

        import sys

        now = time.monotonic()
        with self._lock:
            self.last_error = repr(sys.exc_info()[1])
            self._failures += 1
            self._captures_failed += 1
            self._account_cost(t_open, t_closed if t_closed is not None
                               else now, now if t_closed is not None
                               else None, now, window, forced)
            if self._failures >= self.MAX_CONSECUTIVE_FAILURES:
                self._disabled_until = (
                    time.monotonic() + 10 * max(self.min_interval, 1.0))
                self._failures = 0
            self._capturing = False
        log.warn_every("trace.capture", 60.0,
                       "profiler capture failed: %r", sys.exc_info()[1])

    def _account_cost(self, t_open: float, wall_end: float,
                      parse_end: Optional[float], now: float, window: float,
                      forced: bool) -> None:
        # caller holds self._lock.  Cost accrues on failed captures too,
        # and is everything but ``window`` (the window itself and the
        # profiler's one-time initialization): opening, closing (the
        # device sync and the profiler's own post-processing, on the
        # workload's thread) and the parse.  A forced capture skips the
        # EWMA and the controller: its window is not the periodic one.
        self._capture_wall_s += max(0.0, wall_end - t_open)
        if parse_end is not None:
            self._capture_parse_s += max(0.0, parse_end - wall_end)
        if not forced:
            cost = max(0.0, (now - t_open) - window)
            self._cost_ewma_s = cost if self._cost_ewma_s is None \
                else 0.5 * cost + 0.5 * self._cost_ewma_s
            if self.cost_target_s > 0 and self._cost_ewma_s > 0:
                # proportional controller, halfway per capture, clamped
                # to [floor, configured ceiling]
                want = min(self.capture_ms,
                           max(self.WINDOW_FLOOR_MS,
                               self._window_ms *
                               self.cost_target_s / self._cost_ewma_s))
                self._window_ms = 0.5 * self._window_ms + 0.5 * want
        self._capture_spans.append((t_open, now))
        self._open_since = None
