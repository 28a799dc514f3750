"""Device-level API: ``Chip`` objects with static info + live status.

A copy of ``tpumon/device.py``, imports renamed: the port's status
snapshot for the sample CLIs and the diag.

TPU-native analog of the nvml package's public surface
(reference ``bindings/go/nvml/nvml.go``): ``NewDevice`` gathers the full
static record once (``nvml.go:328-396``), ``Device.Status()`` is the hot-loop
snapshot (``nvml.go:433-512``).  Here both are built from the backend's
field-read primitive so the same code path serves fake/libtpu/agent sources.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from . import fields as FF
from .backends.base import Backend, FieldValue, scalar_float, scalar_int
from .types import (
    ChipInfo, ChipStatus, ClockInfo, DeviceProcess, EccCounters,
    HostLinkThroughput, IciThroughput, MemoryInfo, ThrottleReason,
    UtilizationInfo,
)

F = FF.F


def _i(vals: Dict[int, FieldValue], fid: int) -> Optional[int]:
    return scalar_int(vals.get(int(fid)))


def _fl(vals: Dict[int, FieldValue], fid: int) -> Optional[float]:
    return scalar_float(vals.get(int(fid)))


#: fields needed to assemble one ChipStatus (cf. the 13 cgo calls per tick in
#: nvml.go:433-512 -- here it is ONE batched backend read)
_STATUS_READ_FIELDS: List[int] = FF.STATUS_FIELDS + [
    int(F.THERMAL_VIOLATION),
    int(F.PCIE_REPLAY_COUNTER),
    int(F.ICI_TX_THROUGHPUT), int(F.ICI_RX_THROUGHPUT),
    int(F.ICI_CRC_ERRORS), int(F.ICI_RECOVERY_ERRORS),
    int(F.ICI_REPLAY_ERRORS), int(F.ICI_LINKS_UP),
]


def _host_link(vals: Dict[int, FieldValue]) -> HostLinkThroughput:
    # KB/s -> MB/s normalization at the boundary (nvml.go:506-509)
    tx = _i(vals, F.PCIE_TX_THROUGHPUT)
    rx = _i(vals, F.PCIE_RX_THROUGHPUT)
    return HostLinkThroughput(
        tx=None if tx is None else tx // 1000,
        rx=None if rx is None else rx // 1000,
        replays=_i(vals, F.PCIE_REPLAY_COUNTER),
    )


def status_from_fields(vals: Dict[int, FieldValue],
                       processes: Optional[List[DeviceProcess]] = None,
                       prev: Optional[Dict[int, FieldValue]] = None,
                       ) -> ChipStatus:
    """Assemble a ChipStatus from one batched field read.

    ``prev`` is the previous read of the same fields (held by :class:`Chip`):
    violation counters are monotone since-boot totals, so throttle state must
    come from their *delta* over the window, never the absolute value.
    Without ``prev`` (first read) no throttle is inferred from counters.
    """

    power = _fl(vals, F.POWER_USAGE)
    tc_util = _i(vals, F.TENSORCORE_UTIL)

    def viol_delta(fid: int) -> Optional[int]:
        cur = _i(vals, fid)
        if cur is None or prev is None:
            return None
        return cur - (_i(prev, fid) or 0)

    # throttle-reason synthesis (nvml throttle-reason field analog): growth of
    # a violation counter over the window implies the active constraint
    throttle = ThrottleReason.NONE
    if viol_delta(F.THERMAL_VIOLATION):
        throttle = ThrottleReason.THERMAL
    elif viol_delta(F.POWER_VIOLATION):
        throttle = ThrottleReason.POWER_CAP
    elif tc_util is not None and tc_util == 0:
        throttle = ThrottleReason.IDLE

    # performance state 0 (max) .. 15 (idle), derived from clock ratio like
    # NVML pstates
    pstate: Optional[int] = None
    if tc_util is not None:
        pstate = max(0, min(15, int((100 - tc_util) * 15 / 100)))

    return ChipStatus(
        power_w=power,
        core_temp_c=_i(vals, F.CORE_TEMP),
        hbm_temp_c=_i(vals, F.HBM_TEMP),
        utilization=UtilizationInfo(
            tensorcore=tc_util,
            hbm_bw=_i(vals, F.HBM_BW_UTIL),
            infeed=_i(vals, F.INFEED_UTIL),
            outfeed=_i(vals, F.OUTFEED_UTIL),
        ),
        memory=MemoryInfo(
            total=_i(vals, F.HBM_TOTAL),
            used=_i(vals, F.HBM_USED),
            free=_i(vals, F.HBM_FREE),
        ),
        clocks=ClockInfo(
            tensorcore=_i(vals, F.TENSORCORE_CLOCK),
            hbm=_i(vals, F.HBM_CLOCK),
        ),
        ecc=EccCounters(
            sbe_volatile=_i(vals, F.ECC_SBE_VOLATILE),
            dbe_volatile=_i(vals, F.ECC_DBE_VOLATILE),
        ),
        host_link=_host_link(vals),
        ici=IciThroughput(
            tx=_i(vals, F.ICI_TX_THROUGHPUT),
            rx=_i(vals, F.ICI_RX_THROUGHPUT),
            crc_errors=_i(vals, F.ICI_CRC_ERRORS),
            recovery_errors=_i(vals, F.ICI_RECOVERY_ERRORS),
            replay_errors=_i(vals, F.ICI_REPLAY_ERRORS),
            links_up=_i(vals, F.ICI_LINKS_UP),
        ),
        throttle=throttle,
        performance_state=pstate,
        processes=list(processes or []),
    )


class Chip:
    """Handle to one TPU chip (nvml ``Device`` analog)."""

    def __init__(self, backend: Backend, index: int) -> None:
        self._backend = backend
        self.index = index
        self.info: ChipInfo = backend.chip_info(index)
        self._prev_vals: Optional[Dict[int, FieldValue]] = None

    @property
    def uuid(self) -> str:
        return self.info.uuid

    def status(self, now: Optional[float] = None) -> ChipStatus:
        """Live snapshot — the 1 Hz hot-loop read."""

        vals = self._backend.read_fields(self.index, _STATUS_READ_FIELDS, now=now)
        st = status_from_fields(vals, self._backend.processes(self.index),
                                prev=self._prev_vals)
        self._prev_vals = vals
        return st

    def __repr__(self) -> str:
        return f"Chip(index={self.index}, uuid={self.uuid!r})"
