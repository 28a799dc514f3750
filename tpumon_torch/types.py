"""Core data types for the TPU monitoring framework.

These are the TPU-native analogs of the reference's public structs:

* ``ChipInfo``   <- nvml ``Device`` static info (reference ``bindings/go/nvml/nvml.go:328-396``)
                    + dcgm ``Device`` (``bindings/go/dcgm/device_info.go``)
* ``ChipStatus`` <- nvml ``DeviceStatus`` (``nvml.go:433-512``) /
                    dcgm ``DeviceStatus`` (``device_status.go``)
* ``P2PLink`` / ``IciLink`` <- ``GetP2PLink``/``GetNVLink`` (``nvml.go:514-568``)
* ``ProcessInfo``  <- dcgm ``ProcessInfo`` (``process_info.go:96-189``)
* ``HealthResult`` <- dcgm health check (``health.go:26-124``)
* ``EngineStatus`` <- hostengine introspection (``hostengine_status.go:18-49``)

Conventions kept from the reference: every dynamic quantity is Optional and
``None`` means "not supported / blank" (NVML nil-on-NOT_SUPPORTED,
``bindings.go:222-224``); unit normalization happens at the API boundary
(mW->W ``nvml.go:390``, B->MiB ``bindings.go:428``, KB/s->MB/s ``nvml.go:506-509``)
so consumers never see raw device units.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Dict, List, NamedTuple, Optional, Tuple


class ChipArch(enum.Enum):
    """TPU chip generations (the CUDA-compute-capability analog)."""

    V4 = "v4"
    V5E = "v5e"
    V5P = "v5p"
    V6E = "v6e"
    UNKNOWN = "unknown"


class GpuCaps(NamedTuple):
    """Public capability figures of one GPU model (the counterpart of the
    reference's per-generation ``ARCH_CAPS`` entry)."""

    hbm_mib: int
    hbm_gbps: float
    #: dense bf16 tensor-core peak (no sparsity)
    bf16_tflops: float
    #: total NVLink bandwidth in GB/s, the collective attribution's
    #: physics ceiling (the counterpart of ``ARCH_ICI_CAPS``); None where
    #: the card has no NVLink, and the gate is off there
    nvlink_gbps: Optional[float] = None


#: NVIDIA's public H100 data sheet, keyed on the name CUDA reports
#: (``torch.cuda.get_device_name``): data-sheet figures, not
#: measurements.  A profiler trace carries no capability stats, so the
#: trace engine's peaks come from here; an unknown card gets None and the
#: fields needing a peak stay blank.  NVLink: 900 GB/s on the SXM5 part,
#: the 600 GB/s bridge on the NVL; the PCIe card has none unless bridged.
GPU_CAPS: Dict[str, GpuCaps] = {
    "NVIDIA H100 80GB HBM3": GpuCaps(80 * 1024, 3350.0, 989.0, 900.0),
    "NVIDIA H100 PCIe": GpuCaps(80 * 1024, 2000.0, 756.0, None),
    "NVIDIA H100 NVL": GpuCaps(94 * 1024, 3900.0, 835.0, 600.0),
}


def gpu_caps(name: str) -> Optional[GpuCaps]:
    return GPU_CAPS.get(name)


@dataclass(frozen=True)
class ClockInfo:
    """Max clocks in MHz (nvml.go ClockInfo analog)."""

    tensorcore: Optional[int] = None
    hbm: Optional[int] = None


@dataclass(frozen=True)
class HbmInfo:
    """HBM capacity in MiB."""

    total: Optional[int] = None


@dataclass(frozen=True)
class PciInfo:
    """Host-link identity/throughput ceiling (nvml.go PCI analog)."""

    bus_id: str = ""
    bandwidth_mb_s: Optional[int] = None  # max host-link bandwidth, MB/s


@dataclass(frozen=True)
class ChipCoords:
    """Position of the chip in its pod slice (no NVML analog; TPU-native).

    ``slice_index`` distinguishes slices in a multi-slice deployment
    (BASELINE config 5); x/y/z are ICI torus coordinates.
    """

    x: int = 0
    y: int = 0
    z: int = 0
    slice_index: int = 0


@dataclass(frozen=True)
class ChipInfo:
    """Static per-chip information, gathered once at discovery."""

    index: int
    uuid: str
    name: str                      # e.g. "TPU v5e"
    arch: ChipArch
    serial: str = ""
    dev_path: str = ""             # /dev/accel<N> (cf. /dev/nvidia%d nvml.go:363)
    firmware: str = ""
    driver_version: str = ""
    cores_per_chip: int = 1
    power_limit_w: Optional[float] = None
    hbm: HbmInfo = field(default_factory=HbmInfo)
    clocks_max: ClockInfo = field(default_factory=ClockInfo)
    pci: PciInfo = field(default_factory=PciInfo)
    coords: ChipCoords = field(default_factory=ChipCoords)
    numa_node: Optional[int] = None  # host NUMA affinity (nvml.go:294-312)
    host: str = ""                   # hostname serving this chip


@dataclass(frozen=True)
class UtilizationInfo:
    tensorcore: Optional[int] = None   # duty cycle %
    hbm_bw: Optional[int] = None       # HBM bandwidth %
    infeed: Optional[int] = None       # %
    outfeed: Optional[int] = None      # %


@dataclass(frozen=True)
class MemoryInfo:
    """MiB at the API boundary."""

    total: Optional[int] = None
    used: Optional[int] = None
    free: Optional[int] = None


@dataclass(frozen=True)
class ChipMode:
    """Occupancy/accounting state — the ``GetDeviceMode`` analog
    (reference ``nvml.go:582-604``).

    NVML reports display/persistence/accounting flags; on TPU the questions
    a scheduler actually asks map to: ``held`` — whether any process
    currently holds the chip (TPU access is exclusive, so this is the
    availability bit), ``holder_pids`` — who, and ``accounting`` — whether
    per-PID accounting (``watch_pid_fields``) covers the holders.
    """

    held: bool
    holder_pids: Tuple[int, ...] = ()
    accounting: bool = False


@dataclass(frozen=True)
class EccCounters:
    sbe_aggregate: Optional[int] = None
    dbe_aggregate: Optional[int] = None
    sbe_volatile: Optional[int] = None
    dbe_volatile: Optional[int] = None


@dataclass(frozen=True)
class HostLinkThroughput:
    """MB/s at the API boundary (KB/s->MB/s normalization, nvml.go:506-509)."""

    tx: Optional[int] = None
    rx: Optional[int] = None
    replays: Optional[int] = None


@dataclass(frozen=True)
class IciThroughput:
    tx: Optional[int] = None           # MB/s aggregate
    rx: Optional[int] = None
    crc_errors: Optional[int] = None
    recovery_errors: Optional[int] = None
    replay_errors: Optional[int] = None
    links_up: Optional[int] = None


class ThrottleReason(enum.IntEnum):
    """Why the chip is running below max clocks (nvml throttle-reason analog)."""

    NONE = 0
    IDLE = 1
    POWER_CAP = 2
    THERMAL = 3
    RELIABILITY = 4
    BOARD_LIMIT = 5
    UNKNOWN = 99


@dataclass(frozen=True)
class ChipStatus:
    """Live snapshot, one read per tick (nvml DeviceStatus analog)."""

    power_w: Optional[float] = None
    core_temp_c: Optional[int] = None
    hbm_temp_c: Optional[int] = None
    utilization: UtilizationInfo = field(default_factory=UtilizationInfo)
    memory: MemoryInfo = field(default_factory=MemoryInfo)
    clocks: ClockInfo = field(default_factory=ClockInfo)
    ecc: EccCounters = field(default_factory=EccCounters)
    host_link: HostLinkThroughput = field(default_factory=HostLinkThroughput)
    ici: IciThroughput = field(default_factory=IciThroughput)
    throttle: ThrottleReason = ThrottleReason.NONE
    performance_state: Optional[int] = None
    processes: List["DeviceProcess"] = field(default_factory=list)


@dataclass(frozen=True)
class DeviceProcess:
    """A process holding the chip (nvml ProcessInfo analog, bindings.go:527-582)."""

    pid: int
    name: str
    hbm_used_mib: Optional[int] = None


class P2PLinkType(enum.IntEnum):
    """Topology link classification (dcgm topology.go P2PLinkType analog)."""

    UNKNOWN = 0
    SAME_HOST_PCIE = 1      # chips on one host, PCIe only
    ICI_NEIGHBOR = 2        # directly connected over ICI
    ICI_SAME_SLICE = 3      # same slice, >1 ICI hop
    DCN = 4                 # different slices, data-center network


@dataclass(frozen=True)
class P2PLink:
    """Directed link descriptor returned by topology queries."""

    chip_index: int
    bus_id: str
    link: P2PLinkType
    hops: int = 0


@dataclass(frozen=True)
class TopologyInfo:
    """Per-chip view of the pod-slice topology."""

    coords: ChipCoords
    cpu_affinity: str = ""                 # e.g. "0-47" (topology.go:90-96 analog)
    numa_node: Optional[int] = None
    links: List[P2PLink] = field(default_factory=list)
    mesh_shape: Tuple[int, ...] = ()       # ICI torus shape, e.g. (16, 16)
    wrap: Tuple[bool, ...] = ()            # torus wraparound per axis


@dataclass(frozen=True)
class ProcessUtilSample:
    avg: Optional[int] = None
    max: Optional[int] = None


@dataclass(frozen=True)
class ProcessInfo:
    """Per-PID accounting (dcgm GetProcessInfo analog, process_info.go:96-189)."""

    pid: int
    name: str = ""
    chip_indices: List[int] = field(default_factory=list)
    start_time_us: Optional[int] = None
    end_time_us: Optional[int] = None      # None while running
    energy_mj: Optional[int] = None
    tensorcore_util: ProcessUtilSample = field(default_factory=ProcessUtilSample)
    hbm_util: ProcessUtilSample = field(default_factory=ProcessUtilSample)
    max_hbm_used_mib: Optional[int] = None
    pcie_tx_mb_s: Optional[int] = None
    pcie_rx_mb_s: Optional[int] = None
    health_event_count: int = 0
    num_resets: int = 0


class HealthSystem(enum.Flag):
    """Watchable subsystems (dcgm DCGM_HEALTH_WATCH_* analog, health.go)."""

    NONE = 0
    PCIE = enum.auto()
    ICI = enum.auto()         # <- NVLINK
    HBM = enum.auto()         # <- MEM
    TENSORCORE = enum.auto()  # <- SM
    THERMAL = enum.auto()
    POWER = enum.auto()
    RUNTIME = enum.auto()     # <- DRIVER (TPU runtime process health)
    FIRMWARE = enum.auto()    # <- INFOROM
    DCN = enum.auto()         # multi-slice network (no NVLink-era analog)
    ALL = (PCIE | ICI | HBM | TENSORCORE | THERMAL | POWER | RUNTIME
           | FIRMWARE | DCN)


class HealthStatus(enum.IntEnum):
    PASS = 0
    WARN = 10
    FAIL = 20


@dataclass(frozen=True)
class HealthIncident:
    system: HealthSystem
    status: HealthStatus
    message: str


@dataclass(frozen=True)
class HealthResult:
    chip_index: int
    status: HealthStatus
    incidents: List[HealthIncident] = field(default_factory=list)


@dataclass(frozen=True)
class EngineStatus:
    """Self-metrics of the monitoring agent (hostengine_status.go analog).

    This is how the <1% host CPU north-star target is self-measured.
    """

    memory_kb: float
    cpu_percent: float
    pid: int = 0
    uptime_s: float = 0.0
    samples_per_second: float = 0.0


@dataclass(frozen=True)
class VersionInfo:
    driver: str = ""
    runtime: str = ""
    framework: str = ""


def mib(nbytes: Optional[int]) -> Optional[int]:
    """B -> MiB normalization helper (bindings.go:428 analog)."""

    if nbytes is None:
        return None
    return int(nbytes // (1024 * 1024))
