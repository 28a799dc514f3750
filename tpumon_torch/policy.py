"""Policy engine: threshold registration + async violation stream.

The port's copy of ``tpumon/policy.py``, imports renamed.  The default
thresholds are the reference's DCGM ones (250 W, 100 C), a real
operating point on an H100, whose power reading is NVML's 1 s average.

Analog of dcgm's policy pipeline (reference ``bindings/go/dcgm/policy.go`` +
``callback.c``): the user registers conditions (with optional thresholds) for
a chip and receives a queue of :class:`~tpumon_torch.events.PolicyViolation`.

Reference flow (SURVEY §3.3): DCGM thread -> C trampoline -> exported Go fn ->
per-condition channel -> fan-in -> publisher -> merged user channel.

Here the producer is the watch sweep (:class:`tpumon_torch.watch.WatchManager`
event pump + per-sweep threshold evaluation); the fan-out is
:class:`tpumon_torch.bcast.Publisher`.  Two violation sources are merged:

* **event-sourced** — discrete backend events (ECC DBE, chip reset, ICI/PCIe
  errors) mapped through :func:`tpumon_torch.events.violation_from_event`;
* **threshold-sourced** — sampled fields (temp, power, remapped rows) crossing
  registered thresholds, edge-triggered so a sustained breach emits once
  (re-armed when the value drops below threshold).
"""

from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

from . import fields as FF
from .backends.base import Backend
from .bcast import Publisher
from .events import (
    DEFAULT_THRESHOLDS, Event, PolicyCondition, PolicyViolation,
    violation_from_event,
)

F = FF.F

#: threshold-sourced conditions: condition -> (field id, default threshold)
_THRESHOLD_FIELDS: Dict[PolicyCondition, Tuple[int, float]] = {
    PolicyCondition.THERMAL: (int(F.CORE_TEMP),
                              DEFAULT_THRESHOLDS[PolicyCondition.THERMAL]),
    PolicyCondition.POWER: (int(F.POWER_USAGE),
                            DEFAULT_THRESHOLDS[PolicyCondition.POWER]),
    PolicyCondition.HBM_REMAP: (int(F.HBM_REMAPPED_DBE),
                                DEFAULT_THRESHOLDS[PolicyCondition.HBM_REMAP]),
}


@dataclass
class _Registration:
    chip_index: int
    conditions: PolicyCondition
    thresholds: Dict[PolicyCondition, float]
    # edge-trigger state for threshold conditions
    armed: Dict[PolicyCondition, bool]


class PolicyManager:
    """Owns registrations and the merged violation stream.

    Singleton-per-handle like dcgm's (``policy.go:88-98`` sync.Once); the
    public API is :meth:`register` returning a subscriber queue — the
    ``Policy(gpuId, conds...) (<-chan PolicyViolation, error)`` shape of
    ``api.go:91-93``.
    """

    def __init__(self, backend: Backend,
                 clock: Optional[Callable[[], float]] = None) -> None:
        self._backend = backend
        self._clock = clock or time.time
        self._lock = threading.Lock()
        self._regs: List[_Registration] = []
        self._publisher = Publisher()

    # -- registration ---------------------------------------------------------

    def register(self, chip_index: int,
                 conditions: PolicyCondition = PolicyCondition.ALL,
                 thresholds: Optional[Dict[PolicyCondition, float]] = None,
                 ) -> "queue.Queue[PolicyViolation]":
        """Register conditions for a chip; returns the violation queue."""

        th = dict(DEFAULT_THRESHOLDS)
        if thresholds:
            th.update(thresholds)
        reg = _Registration(
            chip_index=chip_index,
            conditions=conditions,
            thresholds=th,
            armed={c: True for c in _THRESHOLD_FIELDS},
        )
        with self._lock:
            self._regs.append(reg)
        return self._publisher.subscribe()

    def unregister_all(self) -> None:
        with self._lock:
            self._regs.clear()

    def subscribe(self) -> "queue.Queue[PolicyViolation]":
        """Extra subscriber on the merged stream (bcast.go analog)."""

        return self._publisher.subscribe()

    def unsubscribe(self, q: "queue.Queue[PolicyViolation]") -> None:
        self._publisher.unsubscribe(q)

    # -- producers ------------------------------------------------------------

    def on_event(self, ev: Event) -> None:
        """Event-pump callback (wired to WatchManager.add_event_listener)."""

        v = violation_from_event(ev)
        if v is None:
            return
        with self._lock:
            regs = list(self._regs)
        for reg in regs:
            if reg.chip_index not in (-1, v.chip_index):
                continue
            if reg.conditions & v.condition:
                self._publisher.broadcast(v)
                break  # one delivery per violation; queue fan-out handles subs

    def evaluate(self, now: Optional[float] = None) -> List[PolicyViolation]:
        """Threshold sweep: called after each watch sweep (or manually).

        Returns violations emitted this round (also broadcast to queues).
        """

        t = now if now is not None else self._clock()
        emitted: List[PolicyViolation] = []
        with self._lock:
            regs = list(self._regs)
        for reg in regs:
            fids = [fid for c, (fid, _) in _THRESHOLD_FIELDS.items()
                    if reg.conditions & c]
            if not fids:
                continue
            vals = self._backend.read_fields(reg.chip_index, fids, now=t)
            for cond, (fid, _default) in _THRESHOLD_FIELDS.items():
                if not (reg.conditions & cond):
                    continue
                val = vals.get(fid)
                if not isinstance(val, (int, float)):
                    continue  # blank or non-scalar: nothing to compare
                limit = reg.thresholds.get(cond, _default)
                breached = float(val) >= float(limit)
                if breached and reg.armed.get(cond, True):
                    reg.armed[cond] = False
                    v = PolicyViolation(
                        condition=cond, timestamp=t,
                        chip_index=reg.chip_index,
                        data={"value": val, "threshold": limit},
                        message=(f"{cond.name} threshold breached: "
                                 f"{val} >= {limit}"),
                    )
                    self._publisher.broadcast(v)
                    emitted.append(v)
                elif not breached:
                    reg.armed[cond] = True  # re-arm after recovery
        return emitted
