"""Event types for the async (push) data path.

The reference has two push mechanisms we unify here: NVML event sets with
``XidCriticalError`` (``bindings/go/nvml/bindings.go:26,68-146``) and DCGM
policy-violation callbacks (``bindings/go/dcgm/policy.go``).  A backend
produces a time-ordered stream of ``Event`` records; the policy layer
(:mod:`tpumon.policy`) filters/decodes them into ``PolicyViolation`` values
delivered on per-subscriber queues.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple


class EventType(enum.IntEnum):
    """Raw backend event kinds (superset of the policy conditions)."""

    NONE = 0
    CHIP_RESET = 1          # XID-critical analog: chip reset / lost
    RUNTIME_RESTART = 2     # TPU runtime process restarted
    ECC_DBE = 3             # double-bit ECC error detected
    ECC_SBE_STORM = 4       # single-bit error rate above threshold
    HBM_REMAP = 5           # HBM row remapped (retired-page analog)
    THERMAL = 6             # temperature above threshold
    POWER = 7               # power draw above threshold
    PCIE_ERROR = 8          # host-link replay/error
    ICI_ERROR = 9           # ICI link CRC/replay/recovery (NVLink analog)
    DCN_DEGRADED = 10       # multi-slice network degradation
    HEALTH_CHANGE = 11      # health watch status transition
    CLOCK_CHANGE = 12       # throttle state change
    ANOMALY = 13            # streaming-detector finding (tpumon.anomaly)
    INCIDENT = 14           # cross-signal incident (tpumon.anomaly)


@dataclass(frozen=True)
class Event:
    """One raw event from a backend.

    ``seq`` is a per-backend monotone sequence number — the consumer cursor.
    Timestamps are for display/correlation only; cursoring on them would drop
    events that share a timestamp (coarse clocks, frozen test clocks).
    """

    etype: EventType
    timestamp: float               # unix seconds
    seq: int = 0                   # backend-assigned, monotone from 1
    chip_index: int = -1           # -1 = host-level event
    uuid: str = ""
    data: Dict[str, Any] = field(default_factory=dict)
    message: str = ""


class PolicyCondition(enum.IntFlag):
    """User-facing policy conditions (dcgm policy.go DbePolicy... analog)."""

    NONE = 0
    ECC_DBE = enum.auto()        # <- DbePolicy
    PCIE = enum.auto()           # <- PciPolicy
    HBM_REMAP = enum.auto()      # <- MaxRtPgPolicy (retired pages)
    THERMAL = enum.auto()        # <- ThermalPolicy
    POWER = enum.auto()          # <- PowerPolicy
    ICI = enum.auto()            # <- NvlinkPolicy
    CHIP_RESET = enum.auto()     # <- XidPolicy
    ALL = ECC_DBE | PCIE | HBM_REMAP | THERMAL | POWER | ICI | CHIP_RESET


#: default thresholds (dcgm policy.go:113-160 analog: 10 pages, 100 C, 250 W)
DEFAULT_THRESHOLDS: Dict[PolicyCondition, float] = {
    PolicyCondition.HBM_REMAP: 10,     # max remapped rows
    PolicyCondition.THERMAL: 100,      # deg C
    PolicyCondition.POWER: 250,        # W
}

#: which raw event types satisfy each policy condition
CONDITION_EVENT_TYPES: Dict[PolicyCondition, Tuple[EventType, ...]] = {
    PolicyCondition.ECC_DBE: (EventType.ECC_DBE,),
    PolicyCondition.PCIE: (EventType.PCIE_ERROR,),
    PolicyCondition.HBM_REMAP: (EventType.HBM_REMAP,),
    PolicyCondition.THERMAL: (EventType.THERMAL,),
    PolicyCondition.POWER: (EventType.POWER,),
    PolicyCondition.ICI: (EventType.ICI_ERROR,),
    PolicyCondition.CHIP_RESET: (EventType.CHIP_RESET, EventType.RUNTIME_RESTART),
}


@dataclass(frozen=True)
class PolicyViolation:
    """Decoded violation delivered to policy subscribers.

    Mirrors the shape of dcgm's ``PolicyViolation`` (condition + timestamp +
    per-condition payload, ``policy.go:164-249``).
    """

    condition: PolicyCondition
    timestamp: float
    chip_index: int
    data: Dict[str, Any] = field(default_factory=dict)
    message: str = ""


def violation_from_event(ev: Event) -> Optional[PolicyViolation]:
    """Map a raw event to the policy condition it violates, if any."""

    for cond, etypes in CONDITION_EVENT_TYPES.items():
        if ev.etype in etypes:
            return PolicyViolation(
                condition=cond,
                timestamp=ev.timestamp,
                chip_index=ev.chip_index,
                data=dict(ev.data),
                message=ev.message,
            )
    return None
