"""Self-observability: the monitor measures its own footprint.

Analog of dcgm hostengine introspection (reference
``bindings/go/dcgm/hostengine_status.go:18-49``: daemon RSS + CPU%).  This is
how the north-star "<1% host CPU overhead" target is self-measured
(BASELINE.md).  Reads come from procfs — no psutil dependency.
"""

from __future__ import annotations

import os
import time
from typing import Optional, Tuple

from .types import EngineStatus

_CLK_TCK = os.sysconf("SC_CLK_TCK") if hasattr(os, "sysconf") else 100
_PAGE = os.sysconf("SC_PAGE_SIZE") if hasattr(os, "sysconf") else 4096


def _read_proc_stat(pid: int) -> Tuple[float, float]:
    """Return (cpu_seconds_total, rss_kb) for a PID from /proc.

    Returns (0, 0) on hosts without procfs (macOS/Windows) so construction
    of a Handle never fails there — self-metrics just read as zero.
    """

    try:
        with open(f"/proc/{pid}/stat", "rb") as f:
            data = f.read().decode("ascii", "replace")
        # comm may contain spaces; fields start after the closing paren
        rest = data[data.rfind(")") + 2:].split()
        utime, stime = int(rest[11]), int(rest[12])   # fields 14,15 (1-based)
        rss_pages = int(rest[21])                      # field 24
        return (utime + stime) / _CLK_TCK, rss_pages * _PAGE / 1024.0
    except (OSError, ValueError, IndexError):
        return 0.0, 0.0


class SelfMonitor:
    """Tracks the calling process's CPU%/RSS over time."""

    def __init__(self, pid: Optional[int] = None) -> None:
        self.pid = pid or os.getpid()
        self._start_wall = time.monotonic()
        cpu, _ = _read_proc_stat(self.pid)
        self._start_cpu = cpu
        self._last_wall = self._start_wall
        self._last_cpu = cpu

    def status(self, samples_per_second: float = 0.0) -> EngineStatus:
        cpu_total, rss_kb = _read_proc_stat(self.pid)
        now = time.monotonic()
        # CPU% over the window since the previous status() call; falls back
        # to lifetime average on the first call
        dt = now - self._last_wall
        dcpu = cpu_total - self._last_cpu
        if dt < 0.05:
            dt = max(1e-9, now - self._start_wall)
            dcpu = cpu_total - self._start_cpu
        self._last_wall, self._last_cpu = now, cpu_total
        return EngineStatus(
            memory_kb=rss_kb,
            cpu_percent=100.0 * dcpu / max(dt, 1e-9),
            pid=self.pid,
            uptime_s=now - self._start_wall,
            samples_per_second=samples_per_second,
        )
