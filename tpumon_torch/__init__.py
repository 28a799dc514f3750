"""tpumon_torch — the PyTorch/CUDA port of tpumon.

A second package beside ``tpumon`` (the JAX reference, which it never
imports).  It carries the monitored training path onto an NVIDIA H100:
the bench transformer (:mod:`.loadgen.model`) with its attention on
hand-written CUDA flash kernels (:mod:`.loadgen.kernels`,
``csrc/flash_attn.cu``), the in-process CUDA backend
(:mod:`.backends.cuda`) and the exporter's sweep, driven by ``python -m
tpumon_torch.loadgen.run``; and the out-of-band side: the NVML backend
(:mod:`.backends.nvml`) under the exporter daemon (``python -m
tpumon_torch.exporter.main``), whose import path never imports torch.

This module is the trimmed façade: a refcounted :func:`init` /
:func:`shutdown` pair guarding one process-wide :class:`Handle` that
carries what the exporter, the runner and the sample CLIs use (backend,
watches, inventory, status, topology, versions, per-process accounting,
introspection).  The default backend is ``auto``: the out-of-band NVML
source (:mod:`.backends.nvml`).
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

from .backends import (Backend, BackendError, ChipNotFound, LibraryNotFound,
                       make_backend)
from .device import Chip
from .introspect import SelfMonitor
from .process_info import WATCH_WARMUP_S, ProcessWatcher
from .types import (ChipInfo, ChipStatus, EngineStatus, ProcessInfo,
                    TopologyInfo, VersionInfo)
from .watch import WatchManager

__version__ = "0.1.0"


class Handle:
    """One initialized monitoring session over a backend."""

    def __init__(self, backend: Backend, *, own_backend: bool = True,
                 clock=None) -> None:
        self.backend = backend
        self._own_backend = own_backend
        self.watches = WatchManager(backend, clock=clock)
        self._clock = clock
        self._chips: Dict[int, Chip] = {}
        self._processes: Optional[ProcessWatcher] = None
        self.self_monitor = SelfMonitor()

    def chip_count(self) -> int:
        return self.backend.chip_count()

    def supported_chips(self) -> List[int]:
        return self.backend.supported_chips()

    def chip_info(self, index: int) -> ChipInfo:
        return self.backend.chip_info(index)

    def chip_status(self, index: int) -> ChipStatus:
        # one Chip per index, so its throttle state reads counter deltas
        c = self._chips.get(index)
        if c is None:
            c = self._chips[index] = Chip(self.backend, index)
        return c.status()

    @property
    def processes(self) -> ProcessWatcher:
        if self._processes is None:
            self._processes = ProcessWatcher(self.backend, self.watches,
                                             clock=self._clock)
        return self._processes

    def watch_pid_fields(self, pids: Optional[List[int]] = None) -> None:
        self.processes.watch_pid_fields(pids)

    def get_process_info(self, pid: int) -> ProcessInfo:
        return self.processes.get_process_info(pid)

    def introspect(self) -> EngineStatus:
        stats = self.watches.stats()
        st = self.self_monitor.status()
        sps = (stats.get("sweeps", 0.0) * len(self.supported_chips())
               / max(st.uptime_s, 1e-9))
        return EngineStatus(memory_kb=st.memory_kb,
                            cpu_percent=st.cpu_percent, pid=st.pid,
                            uptime_s=st.uptime_s, samples_per_second=sps)

    def versions(self) -> VersionInfo:
        return self.backend.versions()

    def topology(self, index: int) -> TopologyInfo:
        return self.backend.topology(index)

    def close(self) -> None:
        # a raising watch stop must not leak the backend
        try:
            self.watches.stop()
        finally:
            if self._own_backend:
                self.backend.close()


_lock = threading.Lock()
_handle: Optional[Handle] = None
_refcount = 0


def init(*, backend: Optional[Backend] = None,
         backend_name: Optional[str] = None, clock=None) -> Handle:
    """Initialize (refcounted).  Repeated calls share one Handle.  Raises
    :class:`LibraryNotFound` when the backend has no device to open."""

    global _handle, _refcount
    with _lock:
        if _handle is None:
            b = backend or make_backend(backend_name)
            try:
                b.open()
                h = Handle(b, own_backend=backend is None, clock=clock)
            except BaseException:
                if backend is None:
                    try:
                        b.close()
                    except Exception:
                        pass  # the open error is the one to report
                raise
            _handle = h
        _refcount += 1
        return _handle


def shutdown() -> None:
    """Release one reference; closes the Handle at zero."""

    global _handle, _refcount
    with _lock:
        if _refcount == 0:
            raise BackendError("shutdown() without matching init()")
        _refcount -= 1
        if _refcount == 0 and _handle is not None:
            _handle.close()
            _handle = None


__all__ = [
    "__version__", "init", "shutdown", "Handle", "WATCH_WARMUP_S",
    "ProcessInfo",
    "Backend", "BackendError", "ChipNotFound", "LibraryNotFound",
    "make_backend",
]
