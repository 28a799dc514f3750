"""Generic publisher/subscriber fan-out.

The port's copy of ``tpumon/bcast.py``, imports renamed.

Analog of the reference's channel broadcaster (``bindings/go/dcgm/bcast.go``)
used by the policy violation stream.  Queues replace Go channels; a bounded
queue with drop-oldest policy fixes the reference's known wart where a slow
consumer could block the producer thread (SURVEY §5: buffer-1 channels,
``policy.go:103-109``).
"""

from __future__ import annotations

import queue
import threading
from typing import Any, List


class Publisher:
    """Thread-safe fan-out of values to subscriber queues."""

    def __init__(self, maxsize: int = 1024) -> None:
        self._lock = threading.Lock()
        self._subs: List["queue.Queue[Any]"] = []
        self._maxsize = maxsize

    def subscribe(self) -> "queue.Queue[Any]":
        q: "queue.Queue[Any]" = queue.Queue(maxsize=self._maxsize)
        with self._lock:
            self._subs.append(q)
        return q

    def unsubscribe(self, q: "queue.Queue[Any]") -> None:
        with self._lock:
            if q in self._subs:
                self._subs.remove(q)

    def broadcast(self, value: Any) -> None:
        with self._lock:
            subs = list(self._subs)
        for q in subs:
            try:
                q.put_nowait(value)
            except queue.Full:
                # drop-oldest instead of blocking the producer
                try:
                    q.get_nowait()
                except queue.Empty:
                    pass
                try:
                    q.put_nowait(value)
                except queue.Full:
                    pass

    def subscriber_count(self) -> int:
        with self._lock:
            return len(self._subs)
