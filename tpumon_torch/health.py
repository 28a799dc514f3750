"""Health watch subsystem.

The port's copy of ``tpumon/health.py``, imports renamed.  Over the NVML
backend: ICI reads the NVLink error counters, FIRMWARE the VBIOS
version, and DCN has no source on a GPU, so it stays blank; a counter
NVML answers NOT_SUPPORTED is blank and gives no incident.

Analog of dcgm's health API (reference ``bindings/go/dcgm/health.go``):
``dcgmHealthSet(group, DCGM_HEALTH_WATCH_ALL)`` + ``dcgmHealthCheck`` decoding
per-subsystem incidents.  Subsystem mapping (SURVEY §5):

    PCIe -> PCIE, NVLink -> ICI, Mem -> HBM, SM -> TENSORCORE,
    Thermal -> THERMAL, Power -> POWER, Driver -> RUNTIME, Inforom -> FIRMWARE,
    plus DCN (multi-slice network health, no NVLink-era analog).
    The reference's PMU/MCU watches have no TPU analog and are not invented.

A check combines (a) instantaneous field reads against limits and (b) recent
backend events within the check window — the two observation paths the
reference's health engine merges internally.  The FIRMWARE check is
fleet-skew detection: a chip whose firmware version differs from its host
majority is flagged (the Inforom-checksum role, re-thought for TPU pods
where mixed firmware after a partial rollout is the real failure mode).
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional

from . import fields as FF
from .backends.base import Backend, scalar_float, scalar_int
from .events import Event, EventType
from .types import (
    HealthIncident, HealthResult, HealthStatus, HealthSystem,
)

F = FF.F

#: events attributed to each subsystem for incident decoding
_EVENT_SYSTEM: Dict[EventType, HealthSystem] = {
    EventType.PCIE_ERROR: HealthSystem.PCIE,
    EventType.ICI_ERROR: HealthSystem.ICI,
    EventType.ECC_DBE: HealthSystem.HBM,
    EventType.ECC_SBE_STORM: HealthSystem.HBM,
    EventType.HBM_REMAP: HealthSystem.HBM,
    EventType.THERMAL: HealthSystem.THERMAL,
    EventType.POWER: HealthSystem.POWER,
    EventType.CHIP_RESET: HealthSystem.RUNTIME,
    EventType.RUNTIME_RESTART: HealthSystem.RUNTIME,
    EventType.DCN_DEGRADED: HealthSystem.DCN,
    EventType.CLOCK_CHANGE: HealthSystem.TENSORCORE,
}

_FAIL_EVENTS = {EventType.ECC_DBE, EventType.CHIP_RESET}

#: fields read during a check, per subsystem
_CHECK_FIELDS: List[int] = [
    int(F.CORE_TEMP), int(F.HBM_TEMP), int(F.POWER_USAGE),
    int(F.ECC_DBE_VOLATILE), int(F.ECC_SBE_VOLATILE),
    int(F.HBM_REMAP_PENDING), int(F.HBM_REMAPPED_DBE),
    int(F.ICI_CRC_ERRORS), int(F.ICI_REPLAY_ERRORS),
    int(F.ICI_RECOVERY_ERRORS), int(F.ICI_LINKS_UP),
    int(F.PCIE_REPLAY_COUNTER),
    int(F.THERMAL_VIOLATION), int(F.POWER_VIOLATION),
]

#: default limits (cf. dcgm policy defaults policy.go:113-160)
THERMAL_WARN_C = 90
THERMAL_FAIL_C = 100
SBE_WARN = 100


class HealthMonitor:
    """Per-handle health watch state (dcgm healthSet/healthCheck analog)."""

    def __init__(self, backend: Backend,
                 clock: Optional[Callable[[], float]] = None) -> None:
        self._backend = backend
        self._clock = clock or time.time
        # chip index -> watched systems
        self._watched: Dict[int, HealthSystem] = {}
        # chip index -> event-seq cursor: events at or before this are
        # consumed; advanced by every check so a transient event produces ONE
        # incident, not one per future check
        self._event_cursor: Dict[int, int] = {}
        # baselines captured at watch-set so pre-existing counters don't
        # immediately trip incidents
        self._baseline: Dict[int, Dict[int, Optional[int]]] = {}
        # host firmware inventory for the skew check; firmware changes at
        # reboot cadence, so a 60 s cache keeps checks at one RPC
        self._fw_cache: Optional[Dict[int, Optional[str]]] = None
        self._fw_cache_ts = 0.0

    def set_watch(self, chip_index: int,
                  systems: HealthSystem = HealthSystem.ALL) -> None:
        """dcgmHealthSet analog; re-setting resets the baseline."""

        now = self._clock()
        self._watched[chip_index] = systems
        self._event_cursor[chip_index] = self._backend.current_event_seq()
        vals = self._backend.read_fields(chip_index, _CHECK_FIELDS, now=now)
        baseline: Dict[int, Optional[int]] = {}
        for k, v in vals.items():
            if v is None:
                baseline[k] = None
            else:
                n = scalar_int(v)
                if n is not None:
                    baseline[k] = n
        self._baseline[chip_index] = baseline

    def get_watch(self, chip_index: int) -> HealthSystem:
        return self._watched.get(chip_index, HealthSystem.NONE)

    def check(self, chip_index: int) -> HealthResult:
        """dcgmHealthCheck analog: classify each watched subsystem."""

        systems = self._watched.get(chip_index, HealthSystem.ALL)
        if chip_index not in self._watched:
            # implicit watch-all on first check (convenience the samples rely on)
            self.set_watch(chip_index, HealthSystem.ALL)
            systems = HealthSystem.ALL

        now = self._clock()
        vals = self._backend.read_fields(chip_index, _CHECK_FIELDS, now=now)
        base = self._baseline.get(chip_index, {})
        incidents: List[HealthIncident] = []

        def delta(fid: int) -> Optional[int]:
            cur = scalar_int(vals.get(int(fid)))
            if cur is None:
                return None
            b = base.get(int(fid)) or 0
            return cur - int(b)

        info = self._backend.chip_info(chip_index)

        if systems & HealthSystem.THERMAL:
            temp = scalar_int(vals.get(int(F.CORE_TEMP)))
            if temp is not None:
                if temp >= THERMAL_FAIL_C:
                    incidents.append(HealthIncident(
                        HealthSystem.THERMAL, HealthStatus.FAIL,
                        f"core temperature {temp}C >= {THERMAL_FAIL_C}C limit"))
                elif temp >= THERMAL_WARN_C:
                    incidents.append(HealthIncident(
                        HealthSystem.THERMAL, HealthStatus.WARN,
                        f"core temperature {temp}C approaching limit"))

        if systems & HealthSystem.POWER:
            power = scalar_float(vals.get(int(F.POWER_USAGE)))
            limit = info.power_limit_w
            if power is not None and limit is not None and power > limit:
                incidents.append(HealthIncident(
                    HealthSystem.POWER, HealthStatus.WARN,
                    f"power draw {power}W exceeds limit {limit}W"))

        if systems & HealthSystem.HBM:
            dbe = delta(int(F.ECC_DBE_VOLATILE))
            if dbe:
                incidents.append(HealthIncident(
                    HealthSystem.HBM, HealthStatus.FAIL,
                    f"{dbe} new double-bit ECC error(s)"))
            sbe = delta(int(F.ECC_SBE_VOLATILE))
            if sbe and sbe > SBE_WARN:
                incidents.append(HealthIncident(
                    HealthSystem.HBM, HealthStatus.WARN,
                    f"{sbe} new single-bit ECC errors"))
            pend = scalar_int(vals.get(int(F.HBM_REMAP_PENDING)))
            if pend:
                incidents.append(HealthIncident(
                    HealthSystem.HBM, HealthStatus.WARN,
                    f"{pend} HBM row remap(s) pending chip reset"))

        if systems & HealthSystem.ICI:
            for fid, label in ((F.ICI_CRC_ERRORS, "CRC"),
                               (F.ICI_REPLAY_ERRORS, "replay"),
                               (F.ICI_RECOVERY_ERRORS, "recovery")):
                d = delta(int(fid))
                if d:
                    incidents.append(HealthIncident(
                        HealthSystem.ICI, HealthStatus.WARN,
                        f"{d} new ICI {label} error(s)"))
            links = scalar_int(vals.get(int(F.ICI_LINKS_UP)))
            expected = base.get(int(F.ICI_LINKS_UP))
            if links is not None and expected and links < int(expected):
                incidents.append(HealthIncident(
                    HealthSystem.ICI, HealthStatus.FAIL,
                    f"ICI links down: {links}/{expected} up"))

        if systems & HealthSystem.PCIE:
            d = delta(int(F.PCIE_REPLAY_COUNTER))
            if d:
                incidents.append(HealthIncident(
                    HealthSystem.PCIE, HealthStatus.WARN,
                    f"{d} new PCIe replay(s)"))

        if systems & HealthSystem.FIRMWARE:
            fw_by_chip = self._firmware_inventory(now)
            mine = fw_by_chip.get(chip_index)
            versions = [v for v in fw_by_chip.values() if v]
            if mine and len(set(versions)) > 1:
                # deterministic tie-break: on an even split prefer the
                # lexicographically larger version (rollouts move forward),
                # so the same half of the host warns across restarts
                majority = max(sorted(set(versions)),
                               key=lambda v: (versions.count(v), v))
                if mine != majority:
                    incidents.append(HealthIncident(
                        HealthSystem.FIRMWARE, HealthStatus.WARN,
                        f"firmware {mine} differs from host majority "
                        f"{majority} (partial rollout?)"))

        # event-sourced incidents since the previous check (cursor advances
        # so one transient event is reported exactly once)
        cursor = self._event_cursor.get(chip_index, 0)
        events = self._backend.poll_events(cursor)
        if events:
            self._event_cursor[chip_index] = max(e.seq for e in events)
        for ev in events:
            if ev.chip_index not in (-1, chip_index):
                continue
            system = _EVENT_SYSTEM.get(ev.etype)
            if system is None or not (systems & system):
                continue
            status = (HealthStatus.FAIL if ev.etype in _FAIL_EVENTS
                      else HealthStatus.WARN)
            incidents.append(HealthIncident(
                system, status,
                ev.message or f"{ev.etype.name.lower()} event"))

        overall = HealthStatus.PASS
        for inc in incidents:
            if inc.status.value > overall.value:
                overall = inc.status
        return HealthResult(chip_index=chip_index, status=overall,
                            incidents=incidents)

    def _firmware_inventory(self, now: float) -> Dict[int, Optional[str]]:
        if (self._fw_cache is not None
                and now - self._fw_cache_ts < 60.0):
            return self._fw_cache
        fid = int(F.FIRMWARE_VERSION)
        # one bulk RPC for the whole host; a lost chip is omitted by the
        # backend rather than failing every other chip's health check
        reqs = [(c, [fid]) for c in self._backend.supported_chips()]
        inv: Dict[int, Optional[str]] = {}
        for c, vals in self._backend.read_fields_bulk(reqs, now=now).items():
            v = vals.get(fid)
            inv[c] = str(v) if v is not None else None
        self._fw_cache = inv
        self._fw_cache_ts = now
        return inv
