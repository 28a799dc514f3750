"""Deterministic fake backend — the hermetic test substrate.

The port's copy of ``tpumon/backends/fake.py``, values verbatim (the
chips are named "TPU v5e" and so on, as in the reference), so it is held
exactly to the reference's ``FakeBackend`` and, at the golden
tolerances, to the native agent's ``FakeSource``
(``tests/test_torch_fake.py``).  ``make_backend("fake")`` builds it, with
``TPUMON_FAKE_PRESET`` naming a topology preset; ``auto`` never picks it.
The port's hostengine serves it with ``--fake``
(:mod:`tpumon_torch.hostengine`).

Determinism contract: every dynamic field is a pure function of
``(chip_index, field_id, t)`` — closed-form sinusoids for gauges and
analytically-integrated counters — so two reads at the same ``t`` agree
exactly, and counters are monotone without any hidden state.

Fault injection mirrors the failure modes the reference watches for
(``health.go``, ``policy.go``, XID events): ``inject_event`` for discrete
faults, ``set_override`` to pin any field (e.g. drive a temperature above a
policy threshold), ``set_load_profile`` to shape utilization.
"""

from __future__ import annotations

import math
import threading
import time
from dataclasses import dataclass
from typing import (
    Any, Callable, Dict, Iterable, List, Optional, Sequence, Set, Tuple,
)

from .. import fields as FF
from ..events import Event, EventType
from ..types import (
    ChipArch, ChipCoords, ChipInfo, ClockInfo, DeviceProcess, HbmInfo,
    P2PLink, P2PLinkType, PciInfo, TopologyInfo, VersionInfo,
)
from .base import Backend, ChipNotFound, FieldValue

F = FF.F

#: per-arch static parameters: (hbm MiB, tc clock MHz, hbm clock MHz, power limit W,
#:  idle W, peak W, ici links per chip)
_ARCH_PARAMS: Dict[ChipArch, Tuple[int, int, int, float, float, float,
                                   int]] = {
    ChipArch.V4: (32 * 1024, 1050, 1200, 192.0, 55.0, 170.0, 6),
    ChipArch.V5E: (16 * 1024, 940, 1600, 130.0, 40.0, 115.0, 4),
    ChipArch.V5P: (96 * 1024, 1750, 2200, 350.0, 90.0, 320.0, 6),
    ChipArch.V6E: (32 * 1024, 940, 1800, 170.0, 45.0, 150.0, 4),
}

#: the reference's per-generation capability table (``tpumon/types.py``
#: ``ARCH_CAPS``: HBM MiB, HBM GB/s, peak bf16 TFLOP/s), which scales the
#: fake's bandwidth and TFLOP/s waveforms; the port's own ``types`` holds
#: GPU figures instead
_ARCH_CAPS: Dict[ChipArch, Tuple[int, float, float]] = {
    ChipArch.V4: (32 * 1024, 1228.0, 275.0),
    ChipArch.V5E: (16 * 1024, 819.0, 197.0),
    ChipArch.V5P: (95 * 1024, 2765.0, 459.0),
    ChipArch.V6E: (32 * 1024, 1638.0, 918.0),
}
_PEAK_TFLOPS = {arch: caps[2] for arch, caps in _ARCH_CAPS.items()}
_ARCH_HBM_GBPS = {arch: caps[1] for arch, caps in _ARCH_CAPS.items()}


def default_load_profile(chip: int, t: float) -> float:
    """Default synthetic load in [0,1]: a slow sinusoid phase-shifted per chip."""

    return 0.55 + 0.35 * math.sin(2.0 * math.pi * t / 120.0 + 0.7 * chip)


@dataclass
class FakeSliceConfig:
    """Shape of the simulated deployment."""

    num_chips: int = 4                      # chips on THIS host
    arch: ChipArch = ChipArch.V5E
    mesh_shape: Tuple[int, int] = (2, 2)    # ICI torus of the whole slice
    host: str = "fake-host-0"
    host_index: int = 0                     # this host's position in the slice
    slice_index: int = 0
    num_slices: int = 1                     # >1 enables DCN fields
    driver_version: str = "fake-tpu-driver 1.0.0"
    runtime_version: str = "fake-tpu-runtime 2.7.0"

    @classmethod
    def v4_8(cls) -> "FakeSliceConfig":
        return cls(num_chips=4, arch=ChipArch.V4, mesh_shape=(2, 2), host="v4-host-0")

    @classmethod
    def v5e_8(cls) -> "FakeSliceConfig":
        return cls(num_chips=8, arch=ChipArch.V5E, mesh_shape=(2, 4))

    @classmethod
    def v5e_16(cls) -> "FakeSliceConfig":
        # one host of a 16-chip slice (4 hosts x 4 chips)
        return cls(num_chips=4, arch=ChipArch.V5E, mesh_shape=(4, 4))

    @classmethod
    def v5e_256_multislice(cls, num_slices: int = 2) -> "FakeSliceConfig":
        return cls(num_chips=8, arch=ChipArch.V5E, mesh_shape=(16, 16),
                   num_slices=num_slices)


class FakeBackend(Backend):
    name = "fake"

    def __init__(self, config: Optional[FakeSliceConfig] = None,
                 clock: Optional[Callable[[], float]] = None) -> None:
        self.config = config or FakeSliceConfig()
        self._clock = clock or time.time
        self._t0: Optional[float] = None
        self._opened = False
        self._lock = threading.Lock()
        self._events: List[Event] = []
        self._overrides: Dict[Tuple[int, int], FieldValue] = {}
        self._load_profile: Callable[[int, float], float] = default_load_profile
        #: per-chip observed load high-water for custom profiles (the
        #: default sinusoid uses a closed form instead)
        self._load_max_seen: Dict[int, float] = {}
        self._processes: Dict[int, List[DeviceProcess]] = {}
        # counter baselines so injected resets bump the counters
        self._reset_counts: Dict[int, int] = {}
        self._restart_counts: Dict[int, int] = {}
        #: fields forced to read blank (see :meth:`set_blank_fields`)
        self._blank_fields: Set[int] = set()
        #: burst mode (see :meth:`set_burst_hz`): inner sampling rate;
        #: 0 = off (derived fields read blank)
        self._burst_hz = 0
        #: scripted transients: (chip, fid, start_t, end_t, value) —
        #: the field reads ``value`` for t in [start_t, end_t)
        self._transients: List[Tuple[int, int, float, float,
                                     FieldValue]] = []
        #: chip -> (inner-grid index, derived values) — one burst-window
        #: fold per (chip, inner tick), not per derived-field read
        self._burst_cache: Dict[int, Tuple[int, Dict[int, FieldValue]]] = {}

    # -- lifecycle ------------------------------------------------------------

    def open(self) -> None:
        with self._lock:
            if not self._opened:
                self._t0 = self._clock()
                self._opened = True

    def close(self) -> None:
        with self._lock:
            self._opened = False

    # -- inventory ------------------------------------------------------------

    def chip_count(self) -> int:
        return self.config.num_chips

    def _check(self, index: int) -> None:
        if not 0 <= index < self.config.num_chips:
            raise ChipNotFound(f"chip {index} not in [0,{self.config.num_chips})")

    def chip_info(self, index: int) -> ChipInfo:
        self._check(index)
        cfg = self.config
        hbm, tcclk, hbmclk, plimit, _, _, _ = _ARCH_PARAMS[cfg.arch]
        return ChipInfo(
            index=index,
            uuid=self._uuid(index),
            name=f"TPU {cfg.arch.value}",
            arch=cfg.arch,
            serial=f"FAKE{cfg.slice_index:02d}{cfg.host_index:02d}{index:04d}",
            dev_path=f"/dev/accel{index}",
            firmware=f"{cfg.arch.value}-fw-7.3.1",
            driver_version=cfg.driver_version,
            cores_per_chip=1 if cfg.arch in (ChipArch.V5E, ChipArch.V6E) else 2,
            power_limit_w=plimit,
            hbm=HbmInfo(total=hbm),
            clocks_max=ClockInfo(tensorcore=tcclk, hbm=hbmclk),
            pci=PciInfo(bus_id=f"0000:{0x40 + index:02x}:00.0",
                        bandwidth_mb_s=32 * 1024),
            coords=self._coords(index),
            numa_node=index // max(1, cfg.num_chips // 2),
            host=cfg.host,
        )

    def _uuid(self, index: int) -> str:
        cfg = self.config
        return (f"TPU-{cfg.arch.value}-{cfg.slice_index:02d}-"
                f"{cfg.host_index:02d}-{index:02d}")

    def _coords(self, index: int) -> ChipCoords:
        cfg = self.config
        mx, my = cfg.mesh_shape
        flat = cfg.host_index * cfg.num_chips + index
        return ChipCoords(x=flat % mx, y=(flat // mx) % my, z=0,
                          slice_index=cfg.slice_index)

    def versions(self) -> VersionInfo:
        return VersionInfo(driver=self.config.driver_version,
                           runtime=self.config.runtime_version,
                           framework="tpumon")

    # -- deterministic signal generators --------------------------------------

    def _elapsed(self, now: Optional[float]) -> float:
        t0 = self._t0 if self._t0 is not None else 0.0
        return max(0.0, (now if now is not None else self._clock()) - t0)

    def _load(self, chip: int, t: float) -> float:
        return min(1.0, max(0.0, self._load_profile(chip, t)))

    def _load_max(self, chip: int, t: float) -> float:
        """max of the load over [0, t] — closed form for the default
        sinusoid (keeps the HBM high-water field analytic and exactly
        mirrorable in the C++ FakeSource), sampled for custom profiles."""

        if self._load_profile is default_load_profile:
            w = 2.0 * math.pi / 120.0
            x0 = 0.7 * chip
            x1 = w * t + x0
            if x1 - x0 >= 2.0 * math.pi:
                m = 1.0
            else:
                m = max(math.sin(x0), math.sin(x1))
                k = math.ceil((x0 - math.pi / 2.0) / (2.0 * math.pi))
                if math.pi / 2.0 + 2.0 * math.pi * k <= x1:
                    m = 1.0
            return min(1.0, max(0.0, 0.55 + 0.35 * m))
        # custom profile: observed running high-water (a shifting sample
        # grid over [0, t] could MISS a narrow pulse it caught earlier,
        # making the gauge non-monotone; the running max never decreases).
        # Locked around BOTH the profile sample and the read-modify-write:
        # concurrent read_fields calls race the max update, and a reader
        # of the OLD curve must not write back after set_load_profile's
        # clear (profiles are pure functions, safe to call under lock).
        with self._lock:
            seen = max(self._load_max_seen.get(chip, 0.0),
                       self._load(chip, t))
            self._load_max_seen[chip] = seen
        return seen

    def _energy_mj(self, chip: int, t: float) -> int:
        """Closed-form integral of the default power curve so the counter is
        exact and monotone (no hidden accumulator state)."""

        _, _, _, _, idle, peak, _ = _ARCH_PARAMS[self.config.arch]
        a = idle + (peak - idle) * 0.55
        b = (peak - idle) * 0.35
        w = 2.0 * math.pi / 120.0
        phi = 0.7 * chip
        integral = a * t - (b / w) * (math.cos(w * t + phi) - math.cos(phi))
        return int(integral * 1000.0)  # J -> mJ

    def _value(self, chip: int, fid: int, t: float) -> FieldValue:
        # blank > transient > override > waveform, all applied HERE
        # (not only in read_fields) so the burst inner samples see the
        # same pinned/blanked field the 1 Hz path does: a blanked
        # source yields an empty window and blank derived fields,
        # exactly like the real daemon when the source read fails
        if self._blank_fields and fid in self._blank_fields:
            return None
        for tc, tf, t0, t1, tv in self._transients:
            if tc == chip and tf == fid and t0 <= t < t1:
                return tv
        if self._overrides and (chip, fid) in self._overrides:
            return self._overrides[(chip, fid)]
        if fid >= FF.BURST_ID_BASE and self._burst_hz > 0 \
                and FF.burst_source(fid) is not None:
            return self._burst_value(chip, fid, t)
        cfg = self.config
        hbm_total, tcclk, hbmclk, _, idle_w, peak_w, ici_links = _ARCH_PARAMS[cfg.arch]
        load = self._load(chip, t)

        if fid == F.DRIVER_VERSION:
            return cfg.driver_version
        if fid == F.CHIP_NAME:
            return f"TPU {cfg.arch.value}"
        if fid == F.CHIP_UUID:
            return self._uuid(chip)
        if fid == F.SERIAL:
            return f"FAKE{cfg.slice_index:02d}{cfg.host_index:02d}{chip:04d}"
        if fid == F.DEV_PATH:
            return f"/dev/accel{chip}"
        if fid == F.FIRMWARE_VERSION:
            return f"{cfg.arch.value}-fw-7.3.1"

        if fid == F.TENSORCORE_CLOCK:
            return int(tcclk * (0.6 + 0.4 * load))
        if fid == F.HBM_CLOCK:
            return hbmclk

        if fid == F.CORE_TEMP:
            return int(34 + 32 * load + 2 * math.sin(t / 7.0 + chip))
        if fid == F.HBM_TEMP:
            return int(38 + 28 * load + 2 * math.sin(t / 9.0 + chip))

        if fid == F.POWER_USAGE:
            return round(idle_w + (peak_w - idle_w) * load, 1)
        if fid == F.TOTAL_ENERGY:
            return self._energy_mj(chip, t)

        if fid == F.PCIE_TX_THROUGHPUT:
            return int(900_000 * load)           # KB/s
        if fid == F.PCIE_RX_THROUGHPUT:
            return int(300_000 * load)
        if fid == F.PCIE_REPLAY_COUNTER:
            return int(t // 3600)                # ~1 replay/hour

        if fid == F.TENSORCORE_UTIL:
            return int(100 * load)
        if fid == F.HBM_BW_UTIL:
            return int(85 * load)
        if fid == F.INFEED_UTIL:
            return int(18 * load)
        if fid == F.OUTFEED_UTIL:
            return int(7 * load)
        if fid == F.NOT_IDLE_TIME:
            return 0 if load > 0.1 else int(t % 600)

        if fid == F.CHIP_RESET_COUNT:
            return self._reset_counts.get(chip, 0)
        if fid == F.RUNTIME_RESTART_COUNT:
            return self._restart_counts.get(chip, 0)
        if fid == F.LAST_HEALTH_EVENT:
            with self._lock:
                for ev in reversed(self._events):
                    if ev.chip_index == chip:
                        return int(ev.etype)
            return 0

        if fid in (F.POWER_VIOLATION, F.THERMAL_VIOLATION):
            # throttling accrues only near full load
            over = max(0.0, load - 0.92)
            return int(over * t * 1e6 / 8.0)
        if fid in (F.SYNC_BOOST_VIOLATION, F.BOARD_LIMIT_VIOLATION,
                   F.LOW_UTIL_VIOLATION, F.RELIABILITY_VIOLATION):
            return 0

        if fid == F.HBM_TOTAL:
            return hbm_total
        if fid == F.HBM_USED:
            return int(hbm_total * (0.12 + 0.75 * load))
        if fid == F.HBM_FREE:
            return hbm_total - int(hbm_total * (0.12 + 0.75 * load))
        if fid == F.HBM_PEAK_USED:
            return int(hbm_total * (0.12 + 0.75 * self._load_max(chip, t)))

        if fid in (F.ECC_SBE_TOTAL, F.ECC_SBE_VOLATILE):
            return int(t // 1800) * (1 if chip % 3 == 0 else 0)
        if fid in (F.ECC_DBE_TOTAL, F.ECC_DBE_VOLATILE):
            return 0
        if fid in (F.HBM_REMAPPED_SBE, F.HBM_REMAPPED_DBE, F.HBM_REMAP_PENDING):
            return 0

        if fid == F.ICI_CRC_ERRORS:
            return int(t // 7200)
        if fid in (F.ICI_RECOVERY_ERRORS, F.ICI_REPLAY_ERRORS):
            return 0
        if fid == F.ICI_TX_THROUGHPUT:
            return int(45_000 * load * ici_links)   # MB/s aggregate
        if fid == F.ICI_RX_THROUGHPUT:
            return int(45_000 * load * ici_links)
        if fid == F.ICI_LINKS_UP:
            return ici_links
        if fid in (F.ICI_LINK_TX, F.ICI_LINK_RX):
            # per-link split: traffic skews along the torus axes
            total = 45_000 * load * ici_links
            share = [0.35, 0.30, 0.20, 0.15, 0.12, 0.08][:ici_links]
            norm = sum(share)
            return [int(total * s / norm) for s in share]
        if fid == F.ICI_LINK_CRC_ERRORS:
            return [int(t // 7200) if l == 0 else 0 for l in range(ici_links)]
        if fid == F.ICI_LINK_STATE:
            return [1] * ici_links

        if fid in (F.DCN_TX_THROUGHPUT, F.DCN_RX_THROUGHPUT, F.DCN_TRANSFER_LATENCY):
            if cfg.num_slices <= 1:
                return None                         # blank on single slice
            if fid == F.DCN_TRANSFER_LATENCY:
                return int(90 + 40 * load)
            return int(12_000 * load)

        if fid == F.PROF_TENSORCORE_ACTIVE:
            return round(load, 4)
        if fid == F.PROF_MXU_ACTIVE:
            return round(0.9 * load, 4)
        if fid == F.PROF_MXU_OCCUPANCY:
            return round(0.8 * load, 4)
        if fid == F.PROF_VECTOR_ACTIVE:
            return round(0.5 * load, 4)
        if fid == F.PROF_HBM_ACTIVE:
            return round(0.85 * load, 4)
        if fid == F.PROF_INFEED_STALL:
            return round(0.06 * (1.0 - load), 4)
        if fid == F.PROF_OUTFEED_STALL:
            return round(0.02 * (1.0 - load), 4)
        if fid == F.PROF_COLLECTIVE_STALL:
            return round(0.08 * load, 4)
        if fid == F.PROF_STEP_TIME:
            return int(1e6 / (2.0 + 8.0 * load))    # 100-500ms steps
        if fid == F.PROF_DUTY_CYCLE_1S:
            return round(load, 4)
        if fid == F.PROF_ACHIEVED_TFLOPS:
            return round(_PEAK_TFLOPS[cfg.arch] * 0.45 * load, 4)
        if fid == F.PROF_MFU:
            return round(0.45 * load, 4)
        if fid == F.PROF_HBM_RD_GBPS:
            # rd + wr == hbm_active (0.85*load) x peak bw: consistent
            return round(_ARCH_HBM_GBPS[cfg.arch] * 0.60 * load, 4)
        if fid == F.PROF_HBM_WR_GBPS:
            return round(_ARCH_HBM_GBPS[cfg.arch] * 0.25 * load, 4)

        return None

    # -- burst mode (high-rate windowed accumulators) -------------------------

    def _burst_value(self, chip: int, fid: int, t: float) -> FieldValue:
        """Derived burst field at time ``t``: the trailing 1 s of the
        inner sample grid (``j / hz`` for the ``hz`` ticks up to ``t``)
        folded through the SAME executable spec the production twins
        use (:class:`tpumon_torch.burst.BurstAccumulator`), with the window
        anchor seeded production-style from the previous grid point.
        A pure function of ``t`` — two reads at the same instant agree
        exactly, which is what lets tests script a sub-second transient
        and assert the 1 Hz path provably misses it."""

        from ..burst import BurstAccumulator

        hz = self._burst_hz
        j1 = int(math.floor(t * hz))
        # tpumon: thread-ok(memo of a pure function of t — the entry is built off to the side and published by one GIL-atomic dict store, so a racing reader sees the old or the new entry, both correct for their grid point)
        cached = self._burst_cache.get(chip)
        if cached is None or cached[0] != j1:
            acc = BurstAccumulator()
            j0 = j1 - hz
            srcs = FF.BURST_SOURCE_FIELDS
            if j0 >= 0:
                # anchor seed: the grid point just before the window,
                # folded then harvested away — stats reset, anchor
                # kept — so the window integral spans exactly 1 s
                # (production anchors persist across harvests the
                # same way)
                t0 = j0 / hz
                for s in srcs:
                    v0 = self._value(chip, s, t0)
                    if v0 is not None and not isinstance(v0, (str, list)):
                        acc.fold(chip, s, t0, float(v0))
                acc.harvest()
            ts = [j / hz for j in range(max(0, j0 + 1), j1 + 1)]
            for s in srcs:
                acc.fold_series(chip, s, ts,
                                [self._value(chip, s, tj) for tj in ts])
            vals = acc.harvest().get(chip, {})
            cached = (j1, vals)
            # tpumon: thread-ok(memo of a pure function of t — the entry is built off to the side and published by one GIL-atomic dict store, so a racing reader sees the old or the new entry, both correct for their grid point)
            self._burst_cache[chip] = cached
        return cached[1].get(fid)

    def set_burst_hz(self, hz: int) -> None:
        """Enable burst mode: derived fields (``fields.burst_id``) read
        as 1 s min/max/mean/integral windows over the inner sample grid
        at ``hz``; 0 disables (derived fields read blank)."""

        self._burst_hz = int(hz)
        self._burst_cache.clear()

    def set_transient(self, chip_index: int, field_id: int,
                      start_t: float, duration_s: float,
                      value: FieldValue) -> None:
        """Script a square transient: the field reads ``value`` for
        ``t`` in ``[start_t, start_t + duration_s)`` (elapsed seconds,
        the same domain as the waveforms).  A sub-second transient
        placed between whole-second sweep instants is invisible to the
        1 Hz path but lands in the burst window — the aliasing case
        burst mode exists for."""

        self._transients.append((chip_index, int(field_id),
                                 float(start_t),
                                 float(start_t) + float(duration_s),
                                 value))
        self._burst_cache.clear()

    def burst_stats(self) -> Optional[Dict[str, float]]:
        """Burst-loop health counters (the agent-hello twin); ``None``
        when burst mode is off.  The fake's simulated loop never misses
        a period."""

        if self._burst_hz <= 0:
            return None
        return {"burst_hz": float(self._burst_hz), "burst_overruns": 0.0}

    # -- dynamic reads --------------------------------------------------------

    def read_fields(self, index: int, field_ids: Sequence[int],
                    now: Optional[float] = None) -> Dict[int, FieldValue]:
        self._check(index)
        t = self._elapsed(now)
        out: Dict[int, FieldValue] = {}
        for fid in field_ids:
            # blanks, transients and overrides are all applied inside
            # _value so the burst inner samples see them too
            out[int(fid)] = self._value(index, int(fid), t)
        return out

    def processes(self, index: int) -> List[DeviceProcess]:
        self._check(index)
        return list(self._processes.get(index, []))

    # -- topology -------------------------------------------------------------

    def topology(self, index: int) -> TopologyInfo:
        self._check(index)
        cfg = self.config
        mx, my = cfg.mesh_shape
        me = self._coords(index)
        links: List[P2PLink] = []
        for other in range(cfg.num_chips):
            if other == index:
                continue
            oc = self._coords(other)
            dx = min(abs(me.x - oc.x), mx - abs(me.x - oc.x))  # torus distance
            dy = min(abs(me.y - oc.y), my - abs(me.y - oc.y))
            hops = dx + dy
            ltype = P2PLinkType.ICI_NEIGHBOR if hops == 1 else P2PLinkType.ICI_SAME_SLICE
            links.append(P2PLink(
                chip_index=other,
                bus_id=f"0000:{0x40 + other:02x}:00.0",
                link=ltype,
                hops=hops,
            ))
        ncpus = 96
        per = ncpus // max(1, cfg.num_chips)
        return TopologyInfo(
            coords=me,
            cpu_affinity=f"{index * per}-{(index + 1) * per - 1}",
            numa_node=index // max(1, cfg.num_chips // 2),
            links=links,
            mesh_shape=(mx, my),
            wrap=(mx > 2, my > 2),
        )

    # -- events ---------------------------------------------------------------

    def poll_events(self, since_seq: int) -> List[Event]:
        with self._lock:
            return [e for e in self._events if e.seq > since_seq]

    def current_event_seq(self) -> int:
        with self._lock:
            return self._events[-1].seq if self._events else 0

    # -- fault injection / test control ---------------------------------------

    def inject_event(self, etype: EventType, chip_index: int = 0,
                     message: str = "", **data: Any) -> Event:
        """Inject a discrete fault event (and bump the matching counters)."""

        with self._lock:
            ev = Event(etype=etype, timestamp=self._clock(),
                       seq=len(self._events) + 1, chip_index=chip_index,
                       uuid=self._uuid(chip_index) if chip_index >= 0 else "",
                       data=data, message=message)
            self._events.append(ev)
            if etype == EventType.CHIP_RESET:
                self._reset_counts[chip_index] = self._reset_counts.get(chip_index, 0) + 1
            elif etype == EventType.RUNTIME_RESTART:
                self._restart_counts[chip_index] = self._restart_counts.get(chip_index, 0) + 1
        return ev

    def set_override(self, chip_index: int, field_id: int,
                     value: FieldValue) -> None:
        """Pin a field to a fixed value (e.g. drive temp over a threshold)."""

        self._overrides[(chip_index, int(field_id))] = value
        self._burst_cache.clear()  # pins are visible to burst windows

    def clear_override(self, chip_index: int, field_id: int) -> None:
        self._overrides.pop((chip_index, int(field_id)), None)
        self._burst_cache.clear()

    def set_blank_fields(self, field_ids: Iterable[int]) -> None:
        """Force the given fields to read blank (None) — simulates a
        backend tier that has no source for them (e.g. embedded mode's
        per-link ICI gap).  Callers pass ``fields.PER_LINK_ICI_FIELDS``
        to simulate that gap — the one shared list, so the simulations
        cannot drift."""

        self._blank_fields = {int(f) for f in field_ids}
        self._burst_cache.clear()  # blanked sources empty their windows

    def set_load_profile(self, fn: Callable[[int, float], float]) -> None:
        """Replace the synthetic load curve; fn(chip, t) -> [0,1]."""

        # swap + clear under the same lock _load_max updates with: an
        # in-flight reader of the OLD curve must not write its stale
        # high-water back into the freshly-cleared dict
        with self._lock:
            self._load_profile = fn
            self._load_max_seen.clear()  # the old curve's high-water is
            # not this curve's history
        self._burst_cache.clear()  # burst windows sample the new curve

    def set_processes(self, chip_index: int,
                      procs: List[DeviceProcess]) -> None:
        self._processes[chip_index] = list(procs)


class FakeClock:
    """Manually-advanced clock for deterministic tests."""

    def __init__(self, start: float = 1_000_000.0) -> None:
        self._t = start
        self._lock = threading.Lock()

    def __call__(self) -> float:
        with self._lock:
            return self._t

    def advance(self, dt: float) -> float:
        with self._lock:
            self._t += dt
            return self._t
