"""tpumon_torch — the PyTorch/CUDA port of tpumon.

A second package beside ``tpumon`` (the JAX reference, which it never
imports).  It carries the monitored training path onto an NVIDIA H100:
the bench transformer (:mod:`.loadgen.model`) with its attention on
hand-written CUDA flash kernels (:mod:`.loadgen.kernels`,
``csrc/flash_attn.cu``), the in-process CUDA backend
(:mod:`.backends.cuda`) and the exporter's sweep, driven by ``python -m
tpumon_torch.loadgen.run``; and the out-of-band side: the NVML backend
(:mod:`.backends.nvml`) under the exporter daemon (``python -m
tpumon_torch.exporter.main``), the REST API (``python -m
tpumon_torch.restapi.main``) and the sample CLIs, whose import paths never
import torch.

This module is the thread-safe public façade, the counterpart of
``tpumon/__init__.py``: a refcounted :func:`init` / :func:`shutdown` pair
guarding one process-wide :class:`Handle` (backend, watches, inventory,
status, topology, versions, per-process accounting, health watches, the
policy violation stream, event sets, introspection).  The default
backend is ``auto``: the out-of-band NVML source (:mod:`.backends.nvml`).

Three run modes, the reference's (``admin.go:26-30``):

* ``RunMode.EMBEDDED``    — read metrics in-process,
* ``RunMode.STANDALONE``  — connect to a running agent
  (the port's native ``gpu-hostengine``, :mod:`tpumon_torch.hostengine`,
  or the reference's native ``tpu-hostengine``) over a unix or TCP socket,
* ``RunMode.START_AGENT`` — start a local ``gpu-hostengine`` (built at
  first use), connect, and stop it on shutdown.
"""

from __future__ import annotations

import enum
import queue
import threading
from typing import Dict, List, Optional

from . import fields
from .backends import (Backend, BackendError, ChipNotFound, LibraryNotFound,
                       make_backend)
from .device import Chip, status_from_fields
from .event_set import CRITICAL_EVENTS, EventSet
from .events import Event, EventType, PolicyCondition, PolicyViolation
from .health import HealthMonitor
from .introspect import SelfMonitor
from .policy import PolicyManager
from .process_info import WATCH_WARMUP_S, ProcessWatcher
from .types import (ChipInfo, ChipMode, ChipStatus, EngineStatus,
                    HealthResult, HealthStatus, HealthSystem, ProcessInfo,
                    TopologyInfo, VersionInfo)
from .watch import (DEFAULT_MAX_KEEP_AGE_S, DEFAULT_UPDATE_FREQ_US,
                    ChipGroup, FieldGroup, WatchManager)

__version__ = "0.1.0"


class RunMode(enum.Enum):
    EMBEDDED = "embedded"
    STANDALONE = "standalone"
    START_AGENT = "start_agent"


class Handle:
    """One initialized monitoring session over a backend."""

    # tpumon: close-ok(members are passive containers until watches.start  — no thread, socket or file exists while __init__ runs, so a failed constructor has nothing to release)
    def __init__(self, backend: Backend, *, own_backend: bool = True,
                 clock=None) -> None:
        self.backend = backend
        self._own_backend = own_backend
        self.watches = WatchManager(backend, clock=clock)
        self._clock = clock
        self.health = HealthMonitor(backend, clock=clock)
        self.policy = PolicyManager(backend, clock=clock)
        self._chips: Dict[int, Chip] = {}
        self._processes: Optional[ProcessWatcher] = None
        self.self_monitor = SelfMonitor()
        self.watches.add_event_listener(self.policy.on_event)
        # threshold policies are evaluated on every sweep, so background
        # sweeping (watches.start()) drives the violation stream end to end
        self.watches.add_sweep_listener(lambda now: self.policy.evaluate(now))
        self._agent_proc = None  # set by START_AGENT mode

    # -- inventory ------------------------------------------------------------

    def chip_count(self) -> int:
        return self.backend.chip_count()

    def supported_chips(self) -> List[int]:
        return self.backend.supported_chips()

    def chip(self, index: int) -> Chip:
        # one Chip per index, so its throttle state reads counter deltas
        c = self._chips.get(index)
        if c is None:
            c = self._chips[index] = Chip(self.backend, index)
        return c

    def chip_info(self, index: int) -> ChipInfo:
        return self.backend.chip_info(index)

    def chip_status(self, index: int) -> ChipStatus:
        return self.chip(index).status()

    def chip_by_uuid(self, uuid: str) -> Optional[Chip]:
        for i in self.backend.supported_chips():
            c = self.chip(i)
            if c.uuid == uuid:
                return c
        return None

    def chip_mode(self, index: int) -> ChipMode:
        """Occupancy/accounting state (GetDeviceMode analog,
        nvml.go:582-604)."""

        pids = tuple(p.pid for p in self.backend.processes(index))
        return ChipMode(held=bool(pids), holder_pids=pids,
                        accounting=self.processes.is_accounting(pids))

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

    # -- health ---------------------------------------------------------------

    def health_set(self, chip_index: int,
                   systems: HealthSystem = HealthSystem.ALL) -> None:
        self.health.set_watch(chip_index, systems)

    def health_check(self, chip_index: int) -> HealthResult:
        return self.health.check(chip_index)

    # -- policy ---------------------------------------------------------------

    def register_policy(self, chip_index: int,
                        conditions: PolicyCondition = PolicyCondition.ALL,
                        thresholds: Optional[Dict[PolicyCondition, float]] = None,
                        ) -> "queue.Queue[PolicyViolation]":
        """``Policy(gpuId, conds...) (<-chan, error)`` analog (api.go:91-93)."""

        return self.policy.register(chip_index, conditions, thresholds)

    # -- event sets (nvml NewEventSet analog) ---------------------------------

    def new_event_set(self) -> EventSet:
        return EventSet(self.watches)

    # -- introspection --------------------------------------------------------

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
        # teardown aggregates: a raising watch stop must not leak the
        # spawned agent process or the backend
        try:
            self.watches.stop()
        finally:
            try:
                if self._agent_proc is not None:
                    from .backends.agent import stop_agent
                    stop_agent(self._agent_proc)
                    self._agent_proc = None
            finally:
                if self._own_backend:
                    self.backend.close()


_lock = threading.Lock()
_handle: Optional[Handle] = None
_refcount = 0


def _close_quietly(b: Backend) -> None:
    """Best-effort release on a failed init: the init error is the one
    the caller must see."""

    try:
        b.close()
    except Exception:
        pass  # already failing: the init error is the one that matters


def init(mode: RunMode = RunMode.EMBEDDED, *,
         backend: Optional[Backend] = None,
         backend_name: Optional[str] = None,
         address: Optional[str] = None,
         connect_retry_s: float = 0.0, clock=None) -> Handle:
    """Initialize (refcounted).  Repeated calls share one Handle.  Raises
    :class:`LibraryNotFound` when the backend has no device to open, or
    no agent answers at ``address``.

    ``connect_retry_s`` (STANDALONE only) rides out an agent that is still
    starting: refused or missing-socket connects are retried for that many
    seconds before failing.  Default 0 = fail fast."""

    global _handle, _refcount
    with _lock:
        if _handle is None:
            # each branch releases what it acquired when a later step
            # raises (a caller-provided backend stays the caller's)
            if mode is RunMode.EMBEDDED:
                b = backend or make_backend(backend_name)
                try:
                    b.open()
                    h = Handle(b, own_backend=backend is None, clock=clock)
                except BaseException:
                    if backend is None:
                        _close_quietly(b)
                    raise
            elif mode is RunMode.STANDALONE:
                from .backends.agent import AgentBackend
                b = AgentBackend(address=address,
                                 connect_retry_s=connect_retry_s)
                try:
                    b.open()
                    h = Handle(b, clock=clock)
                except BaseException:
                    _close_quietly(b)
                    raise
            elif mode is RunMode.START_AGENT:
                from .backends.agent import (AgentBackend, start_agent,
                                             stop_agent)
                proc, addr = start_agent(address)
                b = None
                try:
                    b = AgentBackend(address=addr)
                    b.open()
                    h = Handle(b, clock=clock)
                except BaseException:
                    if b is not None:
                        _close_quietly(b)
                    stop_agent(proc)
                    raise
                h._agent_proc = proc
            else:
                raise BackendError(f"unknown mode {mode}")
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


def get_handle() -> Handle:
    with _lock:
        if _handle is None:
            raise BackendError("tpumon_torch not initialized; call "
                               "tpumon_torch.init()")
        return _handle


__all__ = [
    "__version__",
    # façade
    "init", "shutdown", "get_handle", "Handle", "RunMode",
    # backends
    "Backend", "BackendError", "ChipNotFound", "LibraryNotFound",
    "make_backend",
    # device layer
    "Chip", "status_from_fields",
    # types
    "ChipInfo", "ChipMode", "ChipStatus", "EngineStatus", "HealthResult",
    "HealthStatus", "HealthSystem", "ProcessInfo", "TopologyInfo",
    "VersionInfo",
    # events / policy
    "Event", "EventType", "PolicyCondition", "PolicyViolation",
    "EventSet", "CRITICAL_EVENTS",
    # watches
    "ChipGroup", "FieldGroup", "WatchManager",
    "DEFAULT_UPDATE_FREQ_US", "DEFAULT_MAX_KEEP_AGE_S", "WATCH_WARMUP_S",
    # field catalog
    "fields",
]
