"""NVML-style event sets: register interest, block for the next event.

The port's copy of ``tpumon/event_set.py``, imports renamed; over the
NVML backend the events are its Xid critical errors (the event set the
backend waits on, and kernel-log lines), mapped by ``kmsg.XID_EVENTS``.

Analog of the reference's NVML event subsystem
(``bindings/go/nvml/bindings.go:68-146``): ``NewEventSet`` ->
``RegisterEventForDevice(XidCriticalError, ...)`` -> ``WaitForEvent(timeout)``.
The XID-critical analog here is :class:`~tpumon_torch.events.EventType.CHIP_RESET`
(+ RUNTIME_RESTART); any event type can be registered.

Events are pumped by the watch layer's sweep (background thread or manual
``update_all``), identical to how the policy stream is fed.
"""

from __future__ import annotations

import queue
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .events import Event, EventType
from .watch import WatchManager

#: the XidCriticalError analog set (bindings.go:26)
CRITICAL_EVENTS = (EventType.CHIP_RESET, EventType.RUNTIME_RESTART)


class EventSet:
    """One registration scope + delivery queue (nvml EventSet analog)."""

    def __init__(self, watches: WatchManager) -> None:
        self._watches = watches
        self._queue: "queue.Queue[Event]" = queue.Queue(maxsize=4096)
        # (chip_index, etype); chip -1 = all chips
        self._registrations: Set[Tuple[int, EventType]] = set()
        self._closed = False
        watches.add_event_listener(self._on_event)

    def register_event(self, etypes: Sequence[EventType] = CRITICAL_EVENTS,
                       chip_index: int = -1) -> None:
        """RegisterEvent/RegisterEventForDevice analog (chip -1 = all)."""

        for et in etypes:
            self._registrations.add((chip_index, EventType(et)))

    def _on_event(self, ev: Event) -> None:
        if ((ev.chip_index, ev.etype) in self._registrations
                or (-1, ev.etype) in self._registrations):
            try:
                self._queue.put_nowait(ev)
            except queue.Full:
                try:  # drop-oldest, never block the pump
                    self._queue.get_nowait()
                    self._queue.put_nowait(ev)
                except queue.Empty:
                    pass

    def wait(self, timeout_s: Optional[float] = None) -> Optional[Event]:
        """WaitForEvent analog: next matching event, or None on timeout."""

        try:
            return self._queue.get(timeout=timeout_s)
        except queue.Empty:
            return None

    def close(self) -> None:
        """DeleteEventSet analog."""

        if not self._closed:
            self._watches.remove_event_listener(self._on_event)
            self._closed = True

    def __enter__(self) -> "EventSet":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
