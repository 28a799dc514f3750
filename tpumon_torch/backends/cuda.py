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
* active probes (:mod:`.probes`) — measured queue-delay / matmul /
  memory-stream estimators for the utilization fields, at most once a
  second.
* ``note_step()`` — the workload feeds its own step boundaries; then
  ``PROF_STEP_TIME`` is the real step-time EWMA.

The profiler-trace engine is not ported yet: the trace-only fields
(vector/infeed/outfeed/collective stalls, achieved TFLOP/s, MFU, HBM
read/write rates, ICI/DCN traffic) stay blank under the nil convention,
as the reference does with ``TPUMON_PJRT_XPLANE=0``.

``torch`` is imported lazily at ``open()``.
"""

from __future__ import annotations

import os
import sys
import threading
import time
from typing import Dict, List, Optional, Sequence

from .. import fields as FF
from ..types import (
    ChipArch, ChipCoords, ChipInfo, ClockInfo, HbmInfo,
    P2PLink, P2PLinkType, PciInfo, TopologyInfo, VersionInfo,
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


#: fields served from the probes (and, in the reference, the trace)
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
        for eng in self._probes.values():
            if eng is not None:
                eng.abandon()
        self._probes = {}
        self._opened = False

    def _dev(self, index: int) -> int:
        if not self._opened:
            raise LibraryNotFound("cuda backend not opened")
        if not 0 <= index < len(self._devices):
            raise ChipNotFound(f"device {index} not present")
        return self._devices[index]

    def _properties(self, index: int):
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
        """Record a workload step boundary; feeds PROF_STEP_TIME."""

        self._steps.note()

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

    # -- trace hooks (no trace engine yet) -------------------------------------

    def force_trace_capture(self, timeout_s: float = 30.0) -> bool:
        """No profiler-trace engine in this backend yet: never captures."""

        del timeout_s
        return False

    def trace_cost_stats(self) -> Optional[Dict[str, float]]:
        return None

    def trace_capture_spans(self):
        return []

    def attribution_stats(self) -> Optional[Dict[str, object]]:
        return None

    # -- metrics --------------------------------------------------------------

    def read_fields(self, index: int, field_ids: Sequence[int],
                    now: Optional[float] = None) -> Dict[int, FieldValue]:
        self._dev(index)
        field_ids = [int(f) for f in field_ids]

        stats = self._hbm_stats(index)
        used_b = stats.get("used")
        total_b = stats.get("total") or 0
        total_mib = total_b // MIB if total_b else None
        # the allocator keeps its own high-water mark, so unlike PJRT no
        # monitor-side peak tracking is needed
        peak_b = stats.get("peak")

        want_util = bool(_UTIL_FIELDS & set(field_ids))
        sample = self._probe_sample(index) if want_util else None
        mono = time.monotonic()
        if sample is not None and sample.duty_est > self.NOT_IDLE_THRESHOLD:
            self._last_not_idle[index] = mono

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
            elif sample is None:
                pass  # every field below is probe-served
            elif fid in _DUTY_FIELDS:
                duty = sample.duty_est
                v = (int(round(duty * 100))
                     if fid == int(F.TENSORCORE_UTIL) else duty)
            elif fid == int(F.PROF_MXU_ACTIVE):
                v = sample.mxu_active_est
            elif fid == int(F.PROF_HBM_ACTIVE):
                v = sample.hbm_active_est
            elif fid == int(F.HBM_BW_UTIL):
                v = int(round(sample.hbm_active_est * 100))
            elif fid == int(F.NOT_IDLE_TIME):
                last = self._last_not_idle.get(index)
                v = int(mono - last) if last is not None else None
            if fid == int(F.PROF_STEP_TIME):
                # real workload steps beat the probe latency
                if self._steps.ewma_us is not None:
                    v = self._steps.ewma_us
                elif sample is not None:
                    v = sample.latency_us
            out[fid] = v  # anything unmatched stays blank (nil convention)
        return out
