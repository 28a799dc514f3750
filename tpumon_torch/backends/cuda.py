"""In-process CUDA backend — real telemetry for a monitor embedded in the
workload.

Counterpart of ``tpumon/backends/pjrt.py``: the workload process samples
its own device through the runtime it already holds (the NVML-in-process
idiom), so monitoring costs no second client on the card.

Sources, per field:

* PyTorch's caching allocator — HBM used (``memory_allocated``, the
  counterpart of PJRT's ``bytes_in_use``) and peak
  (``max_memory_allocated``); the device's total from
  ``mem_get_info``.
* periodic profiler traces (:mod:`tpumon_torch.trace`) — MEASURED device
  timelines from short ``torch.profiler`` captures: duty cycle, the
  mxu/vector/data/infeed/outfeed/collective split, achieved TFLOP/s and
  MFU.  The preferred source wherever it has a value; off with
  ``TPUMON_CUDA_TRACE=0``.
* active probes (:mod:`.probes`) — measured queue-delay / matmul /
  memory-stream estimators, at most once a second: the fallback where no
  trace sample is fresh, and the only source of the HBM-activity
  families (the profiler counts no bytes).
* the capability table (:func:`tpumon_torch.types.gpu_caps`) — the peak
  TFLOP/s behind MFU and MXU occupancy, and HBM total where
  ``mem_get_info`` fails.
* ``note_step()`` — the workload feeds its own step boundaries; then
  ``PROF_STEP_TIME`` is the real step-time EWMA, and the trace engine
  closes a capture the stepping thread holds as soon as its window ends.

* the collective attribution (:mod:`tpumon_torch.collectives`, read by
  the trace engine) — ``tpu_ici_tx/rx_throughput`` (ICI is NVLink here):
  the bytes the window's collectives moved, a measured 0 when it held
  none, clamped to the card's NVLink ceiling; the DCN families once the
  workload registers a slice axis (:meth:`CudaBackend.set_slice_axis`).

The per-link NVLink and the HBM read/write families stay blank under the
nil convention: the profiler counts neither.

``torch`` is imported lazily at ``open()``.
"""

from __future__ import annotations

import os
import sys
import threading
import time
from typing import Dict, List, Optional, Sequence

from .. import fields as FF
from .. import spans
from ..types import (
    ChipArch, ChipCoords, ChipInfo, ClockInfo, HbmInfo,
    P2PLink, P2PLinkType, PciInfo, TopologyInfo, VersionInfo, gpu_caps,
)
from .base import Backend, ChipNotFound, FieldValue, LibraryNotFound

F = FF.F

MIB = 1024 * 1024


class _StepTracker:
    """EWMA of workload-reported step times."""

    def __init__(self, alpha: float = 0.2) -> None:
        self._lock = threading.Lock()
        self._alpha = alpha
        self._last_ts: Optional[float] = None
        self.ewma_us: Optional[float] = None

    def note(self, now: Optional[float] = None) -> None:
        now = time.monotonic() if now is None else now
        with self._lock:
            if self._last_ts is not None:
                dt_us = (now - self._last_ts) * 1e6
                if self.ewma_us is None:
                    self.ewma_us = dt_us
                else:
                    a = self._alpha
                    self.ewma_us = a * dt_us + (1 - a) * self.ewma_us
            self._last_ts = now


#: fields served from the trace and the probes
_UTIL_FIELDS = frozenset(int(f) for f in (
    F.TENSORCORE_UTIL, F.HBM_BW_UTIL, F.NOT_IDLE_TIME, F.INFEED_UTIL,
    F.OUTFEED_UTIL, F.PROF_TENSORCORE_ACTIVE, F.PROF_MXU_ACTIVE,
    F.PROF_MXU_OCCUPANCY, F.PROF_VECTOR_ACTIVE, F.PROF_INFEED_STALL,
    F.PROF_OUTFEED_STALL, F.PROF_COLLECTIVE_STALL, F.PROF_HBM_ACTIVE,
    F.PROF_DUTY_CYCLE_1S, F.PROF_STEP_TIME, F.PROF_ACHIEVED_TFLOPS,
    F.PROF_MFU, F.PROF_HBM_RD_GBPS, F.PROF_HBM_WR_GBPS,
    F.ICI_TX_THROUGHPUT, F.ICI_RX_THROUGHPUT, F.DCN_TX_THROUGHPUT,
    F.DCN_RX_THROUGHPUT, F.DCN_TRANSFER_LATENCY))

_DUTY_FIELDS = frozenset(int(f) for f in (
    F.TENSORCORE_UTIL, F.PROF_DUTY_CYCLE_1S, F.PROF_TENSORCORE_ACTIVE))


class CudaBackend(Backend):
    name = "cuda"

    #: duty estimate above which the chip counts as "not idle" (field 208)
    NOT_IDLE_THRESHOLD = 0.05
    #: probes re-measure at most this often (1 Hz, the exporter's cadence)
    PROBE_INTERVAL_S = 1.0

    def __init__(self) -> None:
        self._devices: List[int] = []
        self._opened = False
        self._probes: Dict[int, "object"] = {}
        self._props: Dict[int, object] = {}
        #: False blanks the probe-served fields (a test seam)
        self._probes_enabled = True
        self._steps = _StepTracker()
        self._last_not_idle: Dict[int, float] = {}
        self._trace_enabled = os.environ.get("TPUMON_CUDA_TRACE", "1") != "0"
        self._trace = None
        self._trace_lock = threading.Lock()
        #: guards the lazily filled per-device caches (``_props``,
        #: ``_probes``, ``_last_not_idle``): the sweep thread and the
        #: workload's own thread (``warmup_probes``, ``note_step``) both
        #: reach them
        self._cache_lock = threading.Lock()

    def open(self) -> None:
        if self._opened:
            return
        try:
            import torch
        except ImportError as e:
            raise LibraryNotFound(f"torch not importable: {e}")
        if not torch.cuda.is_available():
            raise LibraryNotFound("no CUDA device visible to torch")
        self._devices = list(range(torch.cuda.device_count()))
        self._opened = True

    def close(self) -> None:
        self._devices = []
        # a warmup thread mid-calibration must stop at its next phase
        # boundary: its calibration is dead work now
        with self._cache_lock:
            probes, self._probes = self._probes, {}
        for eng in probes.values():
            if eng is not None:
                eng.abandon()
        # no profiler session may outlive the backend (it would end under
        # the next one the process opens): close a session this thread
        # holds and wait out the capture in flight
        tr = self._trace
        if tr is not None:
            tr.quiesce()
        with self._trace_lock:
            self._trace = None
        self._opened = False

    def _dev(self, index: int) -> int:
        if not self._opened:
            raise LibraryNotFound("cuda backend not opened")
        if not 0 <= index < len(self._devices):
            raise ChipNotFound(f"device {index} not present")
        return self._devices[index]

    def _properties(self, index: int):
        with self._cache_lock:
            props = self._props.get(index)
            if props is None:
                import torch
                props = self._props[index] = \
                    torch.cuda.get_device_properties(self._dev(index))
        return props

    def _uuid(self, index: int) -> str:
        uuid = getattr(self._properties(index), "uuid", None)
        return f"GPU-{uuid}" if uuid is not None else f"GPU-cuda-{index}"

    # -- workload self-instrumentation ----------------------------------------

    def note_step(self) -> None:
        """Record a workload step boundary; feeds PROF_STEP_TIME and closes
        a trace capture this thread holds once its window has elapsed."""

        self._steps.note()
        if self._trace is not None:
            self._trace.poll()

    # -- inventory ------------------------------------------------------------

    def chip_count(self) -> int:
        return len(self._devices)

    def _hbm_stats(self, index: int) -> Dict[str, int]:
        """Allocator accounting of this process, which in the embedded
        model is the workload's footprint, plus the device's total."""

        import torch
        d = self._dev(index)
        try:
            total = int(torch.cuda.mem_get_info(d)[1])
        except RuntimeError:
            total = 0
        return {"used": int(torch.cuda.memory_allocated(d)),
                "peak": int(torch.cuda.max_memory_allocated(d)),
                "total": total}

    def chip_info(self, index: int) -> ChipInfo:
        props = self._properties(index)
        total_b = self._hbm_stats(index).get("total") or 0
        return ChipInfo(
            index=index,
            uuid=self._uuid(index),
            name=props.name,
            arch=ChipArch.UNKNOWN,
            dev_path="",
            driver_version=self.versions().runtime,
            cores_per_chip=props.multi_processor_count,
            hbm=HbmInfo(total=total_b // MIB if total_b else None),
            clocks_max=ClockInfo(),
            pci=PciInfo(),
            coords=ChipCoords(x=index),
            host=os.uname().nodename,
        )

    def topology(self, index: int) -> TopologyInfo:
        """Host-local view: one link to every other visible device.  The
        link kind (NVLink or PCIe) needs NVML, which is not ported yet,
        so it reads UNKNOWN rather than a guess."""

        self._dev(index)
        links = [P2PLink(chip_index=other, bus_id="",
                         link=P2PLinkType.UNKNOWN, hops=1)
                 for other in range(len(self._devices)) if other != index]
        return TopologyInfo(coords=ChipCoords(x=index), links=links,
                            mesh_shape=(len(self._devices),), wrap=())

    def versions(self) -> VersionInfo:
        try:
            import torch
            runtime = f"torch {torch.__version__}; cuda {torch.version.cuda}"
            return VersionInfo(driver="", runtime=runtime,
                               framework="tpumon_torch")
        except ImportError:
            return VersionInfo(framework="tpumon_torch")

    # -- probes ---------------------------------------------------------------

    def _probe(self, index: int):
        if not self._probes_enabled:
            return None
        with self._cache_lock:
            eng = self._probes.get(index)
            if eng is None:
                from .probes import ProbeEngine
                eng = self._probes[index] = ProbeEngine(
                    f"cuda:{self._dev(index)}",
                    min_interval_s=self.PROBE_INTERVAL_S)
        return eng

    def warmup_probes(self, index: int = 0) -> None:
        """Blocking probe calibration — call during the workload's own
        warmup so the first monitored sweep doesn't pay it."""

        eng = self._probe(index)
        if eng is not None:
            eng.warmup()

    def _probe_sample(self, index: int):
        eng = self._probe(index)
        if eng is None:
            return None
        try:
            # never block a sweep on the one-time calibration: utilization
            # fields stay blank until the background warmup finishes
            return eng.sample(wait=False)
        except Exception:
            # a failing probe degrades its fields to blank, never the sweep
            from .. import log
            log.warn_every(f"cuda.probe.{index}", 60.0,
                           "device probe failed: %r", sys.exc_info()[1])
            return None

    # -- profiler traces -------------------------------------------------------

    def _engine(self):
        if self._trace is None:
            # locked: two concurrent sweeps must not create two engines
            with self._trace_lock:
                if self._trace is None:
                    from ..trace import TraceEngine
                    self._trace = TraceEngine()
        return self._trace

    def _trace_sample(self, index: int):
        """Latest measured :class:`tpumon_torch.trace.TraceSample` for a
        device, or None (engine off / no capture yet / stale).  Closes an
        elapsed session this thread holds; opens none (see
        :meth:`_trace_schedule`)."""

        if not self._trace_enabled:
            return None
        try:
            return self._engine().peek(index)
        except Exception:
            from .. import log
            log.warn_every("cuda.trace", 60.0,
                           "trace sampling failed: %r", sys.exc_info()[1])
            return None

    def _trace_schedule(self, index: int) -> None:
        """Open the engine's next capture on this thread when one is due.
        A sweep calls it after its probe: inside a session the probe's
        launches and readbacks run under the profiler's recording, slower
        than at calibration, so that an idle card reads busy; and the
        capture would record the probe's kernels."""

        if not self._trace_enabled:
            return
        try:
            self._engine().sample(index, wait=False)
        except Exception:
            from .. import log
            log.warn_every("cuda.trace", 60.0,
                           "trace sampling failed: %r", sys.exc_info()[1])

    def force_trace_capture(self, timeout_s: float = 30.0,
                            step=None) -> bool:
        """Run one capture now on the calling thread, ``step`` called in a
        loop inside its window (bench/report path: a deterministic family
        count needs a fresh sample).  False when tracing is off or the
        capture did not land."""

        if not self._trace_enabled:
            return False
        return self._engine().capture_now(timeout_s, step=step)

    def trace_last_error(self) -> Optional[str]:
        """Why the engine's latest failed capture was refused (a
        ``LostRecords``, say), or None."""

        return self._trace.last_error if self._trace is not None else None

    def trace_cost_stats(self) -> Optional[Dict[str, float]]:
        """Capture-cost counters for overhead attribution, or None before
        the engine exists."""

        if self._trace is None:
            return None
        st = self._trace.stats()
        return {k: st[k] for k in ("captures_ok", "captures_failed",
                                   "capture_wall_s", "capture_close_s",
                                   "capture_parse_s",
                                   "capture_cost_ewma_s",
                                   "capture_window_ms",
                                   "effective_interval_s", "capturing")}

    def trace_capture_spans(self):
        """Recent capture (open→done) monotonic intervals, or []."""

        if self._trace is None:
            return []
        return self._trace.capture_spans()

    def set_slice_axis(self, n_slices: int) -> None:
        """Register the job's slice count (the counterpart of the
        reference's ``set_participant_slices``): with more than one, the
        bytes of the groups that cross slices are served as DCN."""

        self._engine().set_slices(n_slices)

    def attribution_stats(self) -> Optional[Dict[str, object]]:
        """Latest wire-byte-attribution cross-check per device (the
        reference's keys, and the collective events read and bytes
        attributed): None before any trace sample exists."""

        if self._trace is None:
            return None
        latest = self._trace.latest()
        if not latest:
            return None
        out: Dict[str, object] = {}
        for idx, s in sorted(latest.items()):
            eligible = s.gate_eligible_bytes
            # a window with no collective bytes checks nothing: "not
            # exercised", never a pass; bytes under an unknown ceiling ran
            # neither gate
            gate = ("suspect" if s.attribution_suspect
                    else "not_exercised" if not eligible
                    else "clean" if s.attribution_consistency is not None
                    else "unavailable")
            out[str(idx)] = {
                "ici_mb_per_s": (round(s.ici_bytes_per_s / 1e6, 1)
                                 if s.ici_bytes_per_s is not None else None),
                "dcn_mb_per_s": (round(s.dcn_bytes_per_s / 1e6, 1)
                                 if s.dcn_bytes_per_s is not None else None),
                "ici_ceiling_gbps": s.ici_ceiling_gbps,
                "consistency": (round(s.attribution_consistency, 4)
                                if s.attribution_consistency is not None
                                else None),
                "suspect": s.attribution_suspect,
                "gate_eligible_bytes": eligible,
                "gate": gate,
                "collective_events": s.collective_events,
                "ici_bytes": (round(s.ici_bytes_per_s * s.window_s)
                              if s.ici_bytes_per_s is not None else None),
            }
        return out

    def self_metric_lines(self, label: str = "") -> List[str]:
        """Exporter hook: trace-engine health as scrape families (the
        reference's ``tpumon_trace_*``): when captures stop landing, the
        utilization families fall back to the probes, visibly."""

        if self._trace is None:
            return []
        from ..exporter.promtext import render_family

        st = self._trace.stats()
        out: List[str] = []
        for key, fam, ptype, help_txt in (
                ("captures_ok", "tpumon_trace_captures_total", "counter",
                 "Successful profiler captures since start."),
                ("captures_failed", "tpumon_trace_capture_failures_total",
                 "counter", "Failed profiler captures since start."),
                ("disabled", "tpumon_trace_disabled", "gauge",
                 "1 while capture backoff is active (probe fallback)."),
                ("sample_age_s", "tpumon_trace_sample_age_seconds", "gauge",
                 "Age of the freshest trace sample (-1 = none yet)."),
                ("capture_window_ms", "tpumon_trace_capture_window_ms",
                 "gauge",
                 "Adaptive trace-window length: shrinks below the "
                 "configured ceiling when a capture's measured cost "
                 "(transfer + parse) exceeds its target."),
                ("attribution_suspect", "tpumon_trace_attribution_suspect",
                 "gauge",
                 "1 when the ICI/DCN wire-byte attribution failed its "
                 "physics-ceiling or timeline consistency gate."),
                ("attribution_consistency",
                 "tpumon_trace_attribution_consistency", "gauge",
                 "Implied wire-seconds over observed collective-op "
                 "seconds, worst device (<=1 self-consistent; -1 "
                 "unknown).")):
            out += render_family(fam, ptype, help_txt, label, st[key])
        return out

    # -- metrics --------------------------------------------------------------

    def read_burst_fields(self, requests):
        # a read of utilization (203) runs a device probe or opens a
        # trace session (read_fields), so a 50-100 Hz loop over it would
        # launch device work at its rate
        raise ValueError(
            "the burst inner loop is refused over the cuda backend: a read "
            "of the burst fields runs a device probe or opens a trace "
            "session, so the loop would launch device work at its rate; "
            "run the exporter daemon over NVML")

    def read_fields(self, index: int, field_ids: Sequence[int],
                    now: Optional[float] = None) -> Dict[int, FieldValue]:
        self._dev(index)
        field_ids = [int(f) for f in field_ids]

        with spans.span("hbm_stats"):
            stats = self._hbm_stats(index)
        used_b = stats.get("used")
        total_b = stats.get("total") or 0
        caps = gpu_caps(self._properties(index).name)
        total_mib = total_b // MIB if total_b else \
            (caps.hbm_mib if caps else None)
        # the allocator keeps its own high-water mark, so unlike PJRT no
        # monitor-side peak tracking is needed
        peak_b = stats.get("peak")

        want_util = bool(_UTIL_FIELDS & set(field_ids))
        # measured trace sample (preferred source) — None until the first
        # capture lands; the probes then carry the fields
        tr = None
        if want_util:
            with spans.span("trace"), spans.span("peek"):
                tr = self._trace_sample(index)
        # with a fresh, non-empty, exact trace sample the probe dispatch
        # (device work competing with the workload) is skipped, unless a
        # requested field has no other source: step time for a workload
        # that never note_step()s, and the HBM activity families (the
        # profiler counts no bytes)
        tr_full = tr is not None and tr.exact_categories and tr.n_ops > 0
        probe_only_wanted = (
            (int(F.PROF_STEP_TIME) in field_ids and
             self._steps.ewma_us is None) or
            int(F.PROF_HBM_ACTIVE) in field_ids or
            int(F.HBM_BW_UTIL) in field_ids)
        need_probe = want_util and (not tr_full or probe_only_wanted)
        sample = None
        if need_probe:
            with spans.span("probe"):
                sample = self._probe_sample(index)
        if want_util:
            with spans.span("trace"), spans.span("schedule"):
                self._trace_schedule(index)
        # a capture that saw no device work while the probe reads busy
        # missed it: distrust the trace for this sweep, never report idle
        if (tr is not None and tr.n_ops == 0 and sample is not None
                and sample.duty_est > self.NOT_IDLE_THRESHOLD):
            tr = None
        mono = time.monotonic()
        if ((sample is not None and
             sample.duty_est > self.NOT_IDLE_THRESHOLD) or
                (tr is not None and tr.duty > self.NOT_IDLE_THRESHOLD)):
            with self._cache_lock:
                self._last_not_idle[index] = mono
        peak_tf = ((tr.peak_tflops if tr is not None and tr.peak_tflops
                    else None) or (caps.bf16_tflops if caps else None))

        out: Dict[int, FieldValue] = {}
        for fid in field_ids:
            v: FieldValue = None
            if fid == int(F.HBM_TOTAL) and total_mib:
                v = int(total_mib)
            elif fid == int(F.HBM_USED) and used_b is not None:
                v = int(used_b) // MIB
            elif fid == int(F.HBM_FREE) and used_b is not None and total_mib:
                v = max(0, int(total_mib) - int(used_b) // MIB)
            elif fid == int(F.HBM_PEAK_USED) and peak_b is not None:
                v = int(peak_b) // MIB
            elif fid == int(F.CHIP_UUID):
                v = self._uuid(index)
            elif fid == int(F.CHIP_NAME):
                v = self._properties(index).name
            elif fid in _DUTY_FIELDS:
                # measured trace duty beats the queue-delay estimate
                duty = (tr.duty if tr is not None
                        else sample.duty_est if sample is not None else None)
                if duty is not None:
                    v = (int(round(duty * 100))
                         if fid == int(F.TENSORCORE_UTIL) else duty)
            elif fid == int(F.PROF_MXU_ACTIVE):
                if tr is not None and tr.exact_categories:
                    v = tr.mxu_frac
                else:
                    # both are lower bounds: the probe's dead-banded
                    # headroom estimate, and a trace whose kernels were
                    # named, not linked to their ops — take the tighter
                    cands = [x for x in
                             ((sample.mxu_active_est if sample is not None
                               else None),
                              (tr.mxu_frac if tr is not None else None))
                             if x is not None]
                    v = max(cands) if cands else None
            elif fid == int(F.PROF_MXU_OCCUPANCY):
                # achieved MXU FLOP rate over peak, per unit of MXU time
                # (exact categories only: a lower-bound mxu_frac inflates it)
                if (tr is not None and tr.exact_categories and
                        tr.mxu_tflops is not None and peak_tf and
                        tr.mxu_frac > 0.01):
                    v = min(1.0, (tr.mxu_tflops / peak_tf) / tr.mxu_frac)
            elif fid == int(F.PROF_ACHIEVED_TFLOPS):
                if tr is not None and tr.achieved_tflops is not None:
                    v = tr.achieved_tflops
            elif fid == int(F.PROF_MFU):
                if (tr is not None and tr.achieved_tflops is not None
                        and peak_tf):
                    v = min(1.0, tr.achieved_tflops / peak_tf)
            elif fid in (int(F.ICI_TX_THROUGHPUT),
                         int(F.ICI_RX_THROUGHPUT)):
                # the window's collective bytes (ring traffic is symmetric,
                # tx == rx), a measured 0 without collectives, clamped to
                # the NVLink ceiling: a rate no link could carry is an
                # attribution fault (tpumon_trace_attribution_suspect)
                if tr is not None and tr.ici_bytes_per_s is not None:
                    v = int(round(tr.ici_bytes_per_s / 1e6))
                    if tr.ici_ceiling_gbps:
                        v = min(v, int(tr.ici_ceiling_gbps * 1000))
            elif fid in (int(F.DCN_TX_THROUGHPUT),
                         int(F.DCN_RX_THROUGHPUT)):
                if tr is not None and tr.dcn_bytes_per_s is not None:
                    v = int(round(tr.dcn_bytes_per_s / 1e6))
            elif fid == int(F.DCN_TRANSFER_LATENCY):
                # the mean host span of the window's cross-slice
                # collectives (field 502 is integer microseconds)
                if tr is not None and tr.dcn_op_latency_us is not None:
                    v = int(round(tr.dcn_op_latency_us))
            elif fid == int(F.PROF_VECTOR_ACTIVE) and tr is not None:
                v = tr.vector_frac       # trace-only: probes can't see it
            elif fid == int(F.PROF_INFEED_STALL) and tr is not None:
                v = tr.infeed_stall
            elif fid == int(F.PROF_OUTFEED_STALL) and tr is not None:
                v = tr.outfeed_stall
            elif fid == int(F.INFEED_UTIL) and tr is not None:
                v = int(round(tr.infeed_stall * 100))
            elif fid == int(F.OUTFEED_UTIL) and tr is not None:
                v = int(round(tr.outfeed_stall * 100))
            elif fid == int(F.PROF_COLLECTIVE_STALL) and tr is not None:
                v = tr.collective_stall
            elif fid == int(F.PROF_HBM_ACTIVE) and sample is not None:
                v = sample.hbm_active_est
            elif fid == int(F.HBM_BW_UTIL) and sample is not None:
                v = int(round(sample.hbm_active_est * 100))
            elif fid == int(F.NOT_IDLE_TIME):
                if sample is not None or tr is not None:
                    with self._cache_lock:
                        last = self._last_not_idle.get(index)
                    v = int(mono - last) if last is not None else None
            elif fid == int(F.PROF_STEP_TIME):
                # real workload steps beat the probe latency
                if self._steps.ewma_us is not None:
                    v = self._steps.ewma_us
                elif sample is not None:
                    v = sample.latency_us
            out[fid] = v  # anything unmatched stays blank (nil convention)
        return out
