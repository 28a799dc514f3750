"""Per-process accounting (dcgm WatchPidFields / GetPidInfo analog).

A copy of ``tpumon/process_info.py``, imports renamed: per-PID
accounting for ``tpumon_torch.cli.processinfo``.

Reference semantics (``bindings/go/dcgm/process_info.go``): the caller first
enables PID watches (``dcgmWatchPidFields``), waits for samples to accumulate
(the 3 s warm-up baked into the REST handler, ``handlers/dcgm.go:127-129``),
then queries per-PID energy / utilization / health stats.

Here the watch records a baseline of per-chip counters at watch time; a query
aggregates utilization samples from the watch cache between watch-start and
now and attributes counter deltas to the PIDs holding each chip.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence

from . import fields as FF
from .backends.base import Backend
from .types import ProcessInfo, ProcessUtilSample
from .watch import WatchManager

F = FF.F

#: counters snapshotted at watch start for delta attribution
_BASELINE_FIELDS = [int(F.TOTAL_ENERGY), int(F.CHIP_RESET_COUNT),
                    int(F.RUNTIME_RESTART_COUNT)]

#: warm-up recommended before querying stats (restApi/handlers/dcgm.go:129)
WATCH_WARMUP_S = 3.0


@dataclass
class _PidWatch:
    start_ts: float
    start_event_seq: int
    # chip index -> {field: baseline}
    baselines: Dict[int, Dict[int, Optional[int]]]


class ProcessWatcher:
    def __init__(self, backend: Backend, watches: WatchManager,
                 clock: Optional[Callable[[], float]] = None) -> None:
        self._backend = backend
        self._watches = watches
        self._clock = clock or time.time
        self._pid_watches: Dict[int, _PidWatch] = {}
        # ensure util fields are being sampled for aggregation
        self._fg = watches.create_field_group(
            [int(F.TENSORCORE_UTIL), int(F.HBM_BW_UTIL),
             int(F.PCIE_TX_THROUGHPUT), int(F.PCIE_RX_THROUGHPUT),
             int(F.HBM_USED)],
            name="pid-watch-fields")
        self._watch_id: Optional[int] = None

    def is_accounting(self, pids: Sequence[int]) -> bool:
        """True when per-PID accounting covers EVERY pid in ``pids`` (an
        all-PID watch counts) — feeds ChipMode.accounting (GetDeviceMode
        analog).  Empty ``pids`` reports False: nothing is accounted."""

        if not pids:
            return False
        if -1 in self._pid_watches:
            return True
        return all(int(p) in self._pid_watches for p in pids)

    def watch_pid_fields(self, pids: Optional[List[int]] = None) -> None:
        """Begin accounting (dcgmWatchPidFields analog).

        ``pids=None`` watches all current and future chip-holding processes.
        """

        now = self._clock()
        if self._watch_id is None:
            cg = self._watches.all_chips_group("pid-watch-chips")
            self._watch_id = self._watches.watch_fields(cg, self._fg)
            self._watches.update_all(wait=True, now=now)

        baselines: Dict[int, Dict[int, Optional[int]]] = {}
        for c in self._backend.supported_chips():
            vals = self._backend.read_fields(c, _BASELINE_FIELDS, now=now)
            baselines[c] = {k: (None if v is None else int(v))
                            for k, v in vals.items()}
        watch = _PidWatch(start_ts=now,
                          start_event_seq=self._backend.current_event_seq(),
                          baselines=baselines)
        for pid in (pids if pids is not None else [-1]):
            self._pid_watches[pid] = watch

    def get_process_info(self, pid: int) -> ProcessInfo:
        """Query accumulated stats for one PID (dcgmGetPidInfo analog)."""

        watch = self._pid_watches.get(pid) or self._pid_watches.get(-1)
        now = self._clock()
        start = watch.start_ts if watch else now

        # which chips does this PID hold?
        chips: List[int] = []
        name = ""
        hbm_mib: Optional[int] = None
        for c in self._backend.supported_chips():
            for proc in self._backend.processes(c):
                if proc.pid == pid:
                    chips.append(c)
                    name = proc.name or name
                    if proc.hbm_used_mib is not None:
                        hbm_mib = (hbm_mib or 0) + proc.hbm_used_mib

        energy = 0
        have_energy = False
        resets = 0
        tc_samples: List[int] = []
        hbm_samples: List[int] = []
        tx_last: Optional[int] = None
        rx_last: Optional[int] = None
        for c in chips:
            # counter deltas need the watch-time baseline: without a watch,
            # attributing since-boot totals to this PID would be wrong, so
            # energy/resets stay blank (WatchPidFields-first contract,
            # process_info.go semantics)
            if watch is not None:
                cur = self._backend.read_fields(c, _BASELINE_FIELDS, now=now)
                base = watch.baselines.get(c, {})
                e = cur.get(int(F.TOTAL_ENERGY))
                if e is not None:
                    energy += int(e) - int(base.get(int(F.TOTAL_ENERGY)) or 0)
                    have_energy = True
                r = cur.get(int(F.CHIP_RESET_COUNT))
                if r is not None:
                    resets += int(r) - int(base.get(int(F.CHIP_RESET_COUNT)) or 0)
            for s in self._watches.samples_since(c, int(F.TENSORCORE_UTIL), start - 1e-9):
                if s.value is not None:
                    tc_samples.append(int(s.value))
            for s in self._watches.samples_since(c, int(F.HBM_BW_UTIL), start - 1e-9):
                if s.value is not None:
                    hbm_samples.append(int(s.value))
            latest_tx = self._watches.latest(c, int(F.PCIE_TX_THROUGHPUT))
            latest_rx = self._watches.latest(c, int(F.PCIE_RX_THROUGHPUT))
            if latest_tx and latest_tx.value is not None:
                tx_last = (tx_last or 0) + int(latest_tx.value) // 1000
            if latest_rx and latest_rx.value is not None:
                rx_last = (rx_last or 0) + int(latest_rx.value) // 1000

        def agg(samples: List[int]) -> ProcessUtilSample:
            if not samples:
                return ProcessUtilSample()
            return ProcessUtilSample(avg=sum(samples) // len(samples),
                                     max=max(samples))

        return ProcessInfo(
            pid=pid,
            name=name,
            chip_indices=chips,
            start_time_us=int(start * 1e6) if watch else None,
            end_time_us=None,
            energy_mj=energy if have_energy else None,
            tensorcore_util=agg(tc_samples),
            hbm_util=agg(hbm_samples),
            max_hbm_used_mib=hbm_mib,
            pcie_tx_mb_s=tx_last,
            pcie_rx_mb_s=rx_last,
            health_event_count=len([
                e for e in self._backend.poll_events(
                    watch.start_event_seq if watch else
                    self._backend.current_event_seq())
                if e.chip_index in chips]),
            num_resets=resets,
        )
