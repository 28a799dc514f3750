"""TPU metric field catalog.

This is the TPU-native analog of DCGM's field-ID registry (the ``-e 54,100,...``
field lists consumed by ``dcgmi dmon``; cf. reference
``exporters/prometheus-dcgm/dcgm-exporter/dcgm-exporter:85-95`` and
``bindings/go/dcgm/fields.go:20-32``).  Every observable quantity has a stable
numeric field ID, a short name, a Prometheus family name, a type
(gauge/counter), a unit, and a value kind (int/float).

ID blocks deliberately mirror the DCGM numbering scheme so that operators
migrating dashboards can map families 1:1 (``dcgm_gpu_temp`` -> ``tpu_core_temp``):

    50-99    identifiers / static info
    100-149  clocks
    140-169  thermals
    150-159  power / energy
    200-229  host interconnect (PCIe)
    203-229  utilization
    230-239  health events (XID analog: chip resets / runtime restarts)
    240-249  violation counters
    250-259  HBM memory
    310-399  ECC / retired resources
    400-499  ICI links (NVLink analog)
    500-549  DCN (multi-slice data-center network)
    1001-1010 profiling (DCP analog: per-unit duty cycles)

Blank values: a backend returns ``None`` for a field it cannot produce
(the analog of NVML's NOT_SUPPORTED -> nil convention, reference
``bindings/go/nvml/bindings.go:222-224``, and of DCGM's 0x7ffffff0 blank
sentinels, ``bindings/go/dcgm/utils.go:15-18,99-125``).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple


class FieldType(enum.Enum):
    GAUGE = "gauge"
    COUNTER = "counter"
    LABEL = "label"  # static/identifier fields (exported as labels, not samples)


class ValueKind(enum.Enum):
    INT = "int"
    FLOAT = "float"
    STRING = "string"


@dataclass(frozen=True)
class FieldMeta:
    field_id: int
    name: str                 # short name used in CLI headers (dmon columns)
    prom_name: str            # Prometheus family name (tpu_ prefix)
    ftype: FieldType
    kind: ValueKind
    unit: str
    help: str
    #: non-empty -> vector field: backends return a list, one element per
    #: <vector_label> (e.g. per ICI link), rendered as one sample per
    #: element with this extra label
    vector_label: str = ""


class F(enum.IntEnum):
    """Stable field IDs."""

    # --- identifiers / static ------------------------------------------------
    DRIVER_VERSION = 50
    CHIP_NAME = 51
    CHIP_UUID = 52
    SERIAL = 53
    DEV_PATH = 54
    FIRMWARE_VERSION = 55

    # --- clocks --------------------------------------------------------------
    TENSORCORE_CLOCK = 100      # DCGM 100 (sm clock)
    HBM_CLOCK = 101             # DCGM 101 (mem clock)

    # --- thermals ------------------------------------------------------------
    HBM_TEMP = 140              # DCGM 140 (memory temp)
    CORE_TEMP = 150             # DCGM 150 (gpu temp)

    # --- power / energy ------------------------------------------------------
    POWER_USAGE = 155           # DCGM 155
    TOTAL_ENERGY = 156          # DCGM 156 (mJ since boot)

    # --- host link (PCIe) ----------------------------------------------------
    PCIE_TX_THROUGHPUT = 200    # DCGM 200 (KB/s)
    PCIE_RX_THROUGHPUT = 201    # DCGM 201 (KB/s)
    PCIE_REPLAY_COUNTER = 202   # DCGM 202

    # --- utilization ---------------------------------------------------------
    TENSORCORE_UTIL = 203       # DCGM 203 (gpu util) -> TensorCore duty cycle %
    HBM_BW_UTIL = 204           # DCGM 204 (mem copy util) -> HBM bandwidth %
    INFEED_UTIL = 206           # DCGM 206 (enc util) -> host->chip infeed %
    OUTFEED_UTIL = 207          # DCGM 207 (dec util) -> chip->host outfeed %
    NOT_IDLE_TIME = 208         # run.ai addition: secs since chip last non-idle
                                # (dcgm-exporter:104-111 awk-side state)

    # --- health events (XID analog) ------------------------------------------
    CHIP_RESET_COUNT = 230      # DCGM 230 (xid_errors) -> chip resets observed
    RUNTIME_RESTART_COUNT = 231 # TPU runtime restarts observed
    LAST_HEALTH_EVENT = 232     # code of most recent health event (0 = none)

    # --- violation counters (DCGM 240-245) ------------------------------------
    POWER_VIOLATION = 240       # usecs throttled below application clocks: power
    THERMAL_VIOLATION = 241     # usecs throttled: thermal
    SYNC_BOOST_VIOLATION = 242  # API parity only — NOT exported: sync-boost is
                                # an NVIDIA multi-GPU clock-sync concept with no
                                # TPU source; a permanently-blank scrape family
                                # would pad the count
    BOARD_LIMIT_VIOLATION = 243
    LOW_UTIL_VIOLATION = 244
    RELIABILITY_VIOLATION = 245

    # --- HBM memory (DCGM 250-252 fb_*) ---------------------------------------
    HBM_TOTAL = 250             # MiB
    HBM_USED = 251              # MiB
    HBM_FREE = 252              # MiB
    HBM_PEAK_USED = 253         # MiB, high-water mark since runtime start

    # --- ECC (DCGM 310-313) ----------------------------------------------------
    ECC_SBE_TOTAL = 310         # single-bit errors, aggregate
    ECC_DBE_TOTAL = 311         # double-bit errors, aggregate
    ECC_SBE_VOLATILE = 312      # since runtime start
    ECC_DBE_VOLATILE = 313

    # --- retired / remapped resources (DCGM 390-392) ---------------------------
    HBM_REMAPPED_SBE = 390      # rows remapped due to single-bit errors
    HBM_REMAPPED_DBE = 391
    HBM_REMAP_PENDING = 392

    # --- ICI links (NVLink analog, DCGM 409-449) -------------------------------
    ICI_CRC_ERRORS = 409        # DCGM 409 nvlink_flit_crc_error_count_total
    ICI_RECOVERY_ERRORS = 419   # DCGM 419
    ICI_REPLAY_ERRORS = 429     # DCGM 429
    ICI_TX_THROUGHPUT = 439     # DCGM 439 nvlink bandwidth -> MB/s aggregate tx
    ICI_RX_THROUGHPUT = 449     # DCGM 449 -> MB/s aggregate rx
    ICI_LINKS_UP = 450          # active ICI lanes (GetNVLink analog)
    # per-link families (finer than the reference's per-GPU NVLink totals;
    # SURVEY §2.9 "per-link bw/error counters")
    ICI_LINK_TX = 460           # MB/s, one sample per link
    ICI_LINK_RX = 461
    ICI_LINK_CRC_ERRORS = 462
    ICI_LINK_STATE = 463        # 1=up 0=down, per link

    # --- DCN, multi-slice (no DCGM analog; BASELINE config 5) ------------------
    DCN_TX_THROUGHPUT = 500     # MB/s
    DCN_RX_THROUGHPUT = 501     # MB/s
    DCN_TRANSFER_LATENCY = 502  # usec (embedded: mean cross-slice op window)

    # --- profiling (DCP analog, DCGM 1001-1005) --------------------------------
    PROF_TENSORCORE_ACTIVE = 1001  # DCGM 1001 graphics_engine_active
    PROF_MXU_ACTIVE = 1002         # DCGM 1002 sm_active -> MXU issue cycle %
    PROF_MXU_OCCUPANCY = 1003      # DCGM 1003 sm_occupancy
    PROF_VECTOR_ACTIVE = 1004      # DCGM 1004 tensor pipe -> VPU active %
    PROF_HBM_ACTIVE = 1005         # DCGM 1005 dram_active -> HBM active %
    PROF_INFEED_STALL = 1006       # % cycles stalled on host infeed
    PROF_OUTFEED_STALL = 1007      # % cycles stalled on outfeed
    PROF_COLLECTIVE_STALL = 1008   # % cycles stalled on ICI collectives
    PROF_STEP_TIME = 1009          # usec, EWMA of workload step time
    PROF_DUTY_CYCLE_1S = 1010      # TensorCore duty cycle over last 1s window
    PROF_ACHIEVED_TFLOPS = 1011    # measured TFLOP/s (trace cost stats)
    PROF_MFU = 1012                # achieved / peak TFLOP/s (MFU)
    PROF_HBM_RD_GBPS = 1013        # measured read GB/s (trace breakdown)
    PROF_HBM_WR_GBPS = 1014        # measured write GB/s


def _f(fid: F, name: str, prom: str, ftype: FieldType, kind: ValueKind,
       unit: str, help_: str) -> Tuple[int, FieldMeta]:
    return int(fid), FieldMeta(int(fid), name, prom, ftype, kind, unit, help_)


G, C, L = FieldType.GAUGE, FieldType.COUNTER, FieldType.LABEL
I, FL, S = ValueKind.INT, ValueKind.FLOAT, ValueKind.STRING

CATALOG: Dict[int, FieldMeta] = dict([
    _f(F.DRIVER_VERSION, "driver", "tpu_driver_version", L, S, "", "TPU driver/runtime version string."),
    _f(F.CHIP_NAME, "name", "tpu_chip_name", L, S, "", "Chip model name (e.g. v5e)."),
    _f(F.CHIP_UUID, "uuid", "tpu_chip_uuid", L, S, "", "Stable chip UUID."),
    _f(F.SERIAL, "serial", "tpu_chip_serial", L, S, "", "Board serial number."),
    _f(F.DEV_PATH, "path", "tpu_dev_path", L, S, "", "Device node path (/dev/accel*)."),
    _f(F.FIRMWARE_VERSION, "fw", "tpu_firmware_version", L, S, "", "Chip firmware version."),

    _f(F.TENSORCORE_CLOCK, "tcclk", "tpu_tensorcore_clock", G, I, "MHz", "TensorCore clock frequency in MHz."),
    _f(F.HBM_CLOCK, "hbmclk", "tpu_hbm_clock", G, I, "MHz", "HBM clock frequency in MHz."),

    _f(F.HBM_TEMP, "hbmtemp", "tpu_hbm_temp", G, I, "C", "HBM stack temperature in degrees Celsius."),
    _f(F.CORE_TEMP, "temp", "tpu_core_temp", G, I, "C", "Chip core temperature in degrees Celsius."),

    _f(F.POWER_USAGE, "power", "tpu_power_usage", G, FL, "W", "Chip power draw in watts."),
    _f(F.TOTAL_ENERGY, "energy", "tpu_total_energy_consumption", C, I, "mJ", "Total energy consumption since boot in mJ."),

    _f(F.PCIE_TX_THROUGHPUT, "pcietx", "tpu_pcie_tx_throughput", G, I, "KB/s", "PCIe host-to-chip throughput in KB/s."),
    _f(F.PCIE_RX_THROUGHPUT, "pcierx", "tpu_pcie_rx_throughput", G, I, "KB/s", "PCIe chip-to-host throughput in KB/s."),
    _f(F.PCIE_REPLAY_COUNTER, "pciereplay", "tpu_pcie_replay_counter", C, I, "", "Total PCIe retries."),

    _f(F.TENSORCORE_UTIL, "tcutil", "tpu_tensorcore_utilization", G, I, "%", "TensorCore duty cycle (percent)."),
    _f(F.HBM_BW_UTIL, "hbmbw", "tpu_hbm_bw_utilization", G, I, "%", "HBM bandwidth utilization (percent)."),
    _f(F.INFEED_UTIL, "infeed", "tpu_infeed_utilization", G, I, "%", "Host-to-chip infeed utilization (percent)."),
    _f(F.OUTFEED_UTIL, "outfeed", "tpu_outfeed_utilization", G, I, "%", "Chip-to-host outfeed utilization (percent)."),
    _f(F.NOT_IDLE_TIME, "notidle", "tpu_last_not_idle_time", G, I, "s", "Seconds since the chip was last non-idle."),

    _f(F.CHIP_RESET_COUNT, "resets", "tpu_chip_reset_errors", C, I, "", "Chip resets observed (XID-critical analog)."),
    _f(F.RUNTIME_RESTART_COUNT, "rtrestarts", "tpu_runtime_restarts", C, I, "", "TPU runtime restarts observed."),
    _f(F.LAST_HEALTH_EVENT, "lasthealth", "tpu_last_health_event", G, I, "", "Code of most recent health event (0=none)."),

    _f(F.POWER_VIOLATION, "pviol", "tpu_power_violation", C, I, "us", "Throttling duration due to power constraint (us)."),
    _f(F.THERMAL_VIOLATION, "tviol", "tpu_thermal_violation", C, I, "us", "Throttling duration due to thermal constraint (us)."),
    _f(F.SYNC_BOOST_VIOLATION, "sbviol", "tpu_sync_boost_violation", C, I, "us", "Throttling duration due to sync-boost constraint (us)."),
    _f(F.BOARD_LIMIT_VIOLATION, "blviol", "tpu_board_limit_violation", C, I, "us", "Throttling duration due to board limit (us)."),
    _f(F.LOW_UTIL_VIOLATION, "luviol", "tpu_low_util_violation", C, I, "us", "Throttling duration due to low utilization (us)."),
    _f(F.RELIABILITY_VIOLATION, "rviol", "tpu_reliability_violation", C, I, "us", "Throttling duration due to reliability constraint (us)."),

    _f(F.HBM_TOTAL, "hbmtotal", "tpu_hbm_total", G, I, "MiB", "Total HBM capacity in MiB."),
    _f(F.HBM_USED, "hbmused", "tpu_hbm_used", G, I, "MiB", "Used HBM in MiB."),
    _f(F.HBM_FREE, "hbmfree", "tpu_hbm_free", G, I, "MiB", "Free HBM in MiB."),
    _f(F.HBM_PEAK_USED, "hbmpeak", "tpu_hbm_peak_used", G, I, "MiB", "Peak used HBM since runtime start in MiB (high-water mark)."),

    _f(F.ECC_SBE_TOTAL, "eccsbe", "tpu_ecc_sbe_aggregate_total", C, I, "", "Total aggregate single-bit ECC errors."),
    _f(F.ECC_DBE_TOTAL, "eccdbe", "tpu_ecc_dbe_aggregate_total", C, I, "", "Total aggregate double-bit ECC errors."),
    _f(F.ECC_SBE_VOLATILE, "eccsbev", "tpu_ecc_sbe_volatile_total", C, I, "", "Single-bit ECC errors since runtime start."),
    _f(F.ECC_DBE_VOLATILE, "eccdbev", "tpu_ecc_dbe_volatile_total", C, I, "", "Double-bit ECC errors since runtime start."),

    _f(F.HBM_REMAPPED_SBE, "remapsbe", "tpu_hbm_remapped_rows_sbe", C, I, "", "HBM rows remapped due to single-bit errors."),
    _f(F.HBM_REMAPPED_DBE, "remapdbe", "tpu_hbm_remapped_rows_dbe", C, I, "", "HBM rows remapped due to double-bit errors."),
    _f(F.HBM_REMAP_PENDING, "remappend", "tpu_hbm_remap_pending", G, I, "", "HBM row remappings pending chip reset."),

    _f(F.ICI_CRC_ERRORS, "icicrc", "tpu_ici_crc_error_count_total", C, I, "", "Total ICI link CRC errors across lanes."),
    _f(F.ICI_RECOVERY_ERRORS, "icirec", "tpu_ici_recovery_error_count_total", C, I, "", "Total ICI link recovery events across lanes."),
    _f(F.ICI_REPLAY_ERRORS, "icireplay", "tpu_ici_replay_error_count_total", C, I, "", "Total ICI link replays across lanes."),
    _f(F.ICI_TX_THROUGHPUT, "icitx", "tpu_ici_tx_throughput", G, I, "MB/s", "Aggregate ICI transmit bandwidth in MB/s."),
    _f(F.ICI_RX_THROUGHPUT, "icirx", "tpu_ici_rx_throughput", G, I, "MB/s", "Aggregate ICI receive bandwidth in MB/s."),
    _f(F.ICI_LINKS_UP, "icilinks", "tpu_ici_links_up", G, I, "", "Number of ICI lanes currently up."),
    (int(F.ICI_LINK_TX), FieldMeta(int(F.ICI_LINK_TX), "linktx", "tpu_ici_link_tx_throughput", G, I, "MB/s", "Per-link ICI transmit bandwidth in MB/s.", vector_label="link")),
    (int(F.ICI_LINK_RX), FieldMeta(int(F.ICI_LINK_RX), "linkrx", "tpu_ici_link_rx_throughput", G, I, "MB/s", "Per-link ICI receive bandwidth in MB/s.", vector_label="link")),
    (int(F.ICI_LINK_CRC_ERRORS), FieldMeta(int(F.ICI_LINK_CRC_ERRORS), "linkcrc", "tpu_ici_link_crc_errors", C, I, "", "Per-link ICI CRC error count.", vector_label="link")),
    (int(F.ICI_LINK_STATE), FieldMeta(int(F.ICI_LINK_STATE), "linkstate", "tpu_ici_link_state", G, I, "", "Per-link ICI state (1=up, 0=down).", vector_label="link")),

    _f(F.DCN_TX_THROUGHPUT, "dcntx", "tpu_dcn_tx_throughput", G, I, "MB/s", "Data-center-network transmit bandwidth in MB/s (multi-slice)."),
    _f(F.DCN_RX_THROUGHPUT, "dcnrx", "tpu_dcn_rx_throughput", G, I, "MB/s", "Data-center-network receive bandwidth in MB/s (multi-slice)."),
    _f(F.DCN_TRANSFER_LATENCY, "dcnlat", "tpu_dcn_transfer_latency", G, I, "us", "DCN collective transfer latency in us (embedded: mean cross-slice op window per capture)."),

    _f(F.PROF_TENSORCORE_ACTIVE, "tcact", "tpu_tensorcore_active", G, FL, "ratio", "Ratio of cycles the TensorCore was active."),
    _f(F.PROF_MXU_ACTIVE, "mxuact", "tpu_mxu_active", G, FL, "ratio", "Ratio of cycles an MXU was issuing."),
    _f(F.PROF_MXU_OCCUPANCY, "mxuocc", "tpu_mxu_occupancy", G, FL, "ratio", "Ratio of MXU capacity occupied."),
    _f(F.PROF_VECTOR_ACTIVE, "vpuact", "tpu_vector_active", G, FL, "ratio", "Ratio of cycles the VPU was active."),
    _f(F.PROF_HBM_ACTIVE, "hbmact", "tpu_hbm_active", G, FL, "ratio", "Ratio of cycles HBM interface was active."),
    _f(F.PROF_INFEED_STALL, "install", "tpu_infeed_stall", G, FL, "ratio", "Ratio of cycles stalled waiting on infeed."),
    _f(F.PROF_OUTFEED_STALL, "outstall", "tpu_outfeed_stall", G, FL, "ratio", "Ratio of cycles stalled waiting on outfeed."),
    _f(F.PROF_COLLECTIVE_STALL, "collstall", "tpu_collective_stall", G, FL, "ratio", "Ratio of cycles stalled on ICI collectives."),
    _f(F.PROF_STEP_TIME, "steptime", "tpu_step_time", G, I, "us", "EWMA of workload step time in us."),
    _f(F.PROF_DUTY_CYCLE_1S, "duty1s", "tpu_duty_cycle_1s", G, FL, "ratio", "TensorCore duty cycle over the trailing 1s window."),
    _f(F.PROF_ACHIEVED_TFLOPS, "achtflops", "tpu_achieved_tflops", G, FL, "TFLOP/s", "Measured achieved TFLOP/s over the last trace window (compiler cost stats)."),
    _f(F.PROF_MFU, "mfu", "tpu_mfu", G, FL, "ratio", "Model FLOPs utilization: achieved TFLOP/s over the chip's peak."),
    _f(F.PROF_HBM_RD_GBPS, "hbmrd", "tpu_hbm_rd_throughput", G, FL, "GB/s", "Measured memory read bandwidth over the last trace window (GB/s)."),
    _f(F.PROF_HBM_WR_GBPS, "hbmwr", "tpu_hbm_wr_throughput", G, FL, "GB/s", "Measured memory write bandwidth over the last trace window (GB/s)."),
])


# Field sets mirroring the reference's canned lists ---------------------------

#: the 17-field live status snapshot (cf. dcgm device_status.go:96-113)
STATUS_FIELDS: List[int] = [
    int(F.POWER_USAGE), int(F.CORE_TEMP), int(F.HBM_TEMP),
    int(F.TENSORCORE_UTIL), int(F.HBM_BW_UTIL), int(F.INFEED_UTIL),
    int(F.OUTFEED_UTIL), int(F.HBM_TOTAL), int(F.HBM_USED), int(F.HBM_FREE),
    int(F.TENSORCORE_CLOCK), int(F.HBM_CLOCK), int(F.ECC_SBE_VOLATILE),
    int(F.ECC_DBE_VOLATILE), int(F.PCIE_TX_THROUGHPUT),
    int(F.PCIE_RX_THROUGHPUT), int(F.POWER_VIOLATION),
]

#: the dmon column set (cf. samples/dcgm/dmon/main.go:19-20 field list)
DMON_FIELDS: List[int] = [
    int(F.POWER_USAGE), int(F.CORE_TEMP), int(F.TENSORCORE_UTIL),
    int(F.HBM_BW_UTIL), int(F.INFEED_UTIL), int(F.OUTFEED_UTIL),
    int(F.TENSORCORE_CLOCK), int(F.HBM_CLOCK),
]

#: base exporter family set (36 families, cf. dcgm-exporter:121-187)
EXPORTER_BASE_FIELDS: List[int] = [
    int(F.TENSORCORE_CLOCK), int(F.HBM_CLOCK),
    int(F.HBM_TEMP), int(F.CORE_TEMP),
    int(F.POWER_USAGE), int(F.TOTAL_ENERGY),
    int(F.PCIE_TX_THROUGHPUT), int(F.PCIE_RX_THROUGHPUT), int(F.PCIE_REPLAY_COUNTER),
    int(F.TENSORCORE_UTIL), int(F.HBM_BW_UTIL), int(F.INFEED_UTIL),
    int(F.OUTFEED_UTIL), int(F.NOT_IDLE_TIME),
    int(F.CHIP_RESET_COUNT), int(F.RUNTIME_RESTART_COUNT),
    # SYNC_BOOST_VIOLATION is deliberately absent: no TPU source exists,
    # and a permanently-blank family pads the count;
    # the field stays in the CATALOG for DCGM-numbering API parity only
    int(F.POWER_VIOLATION), int(F.THERMAL_VIOLATION),
    int(F.BOARD_LIMIT_VIOLATION), int(F.LOW_UTIL_VIOLATION), int(F.RELIABILITY_VIOLATION),
    int(F.HBM_TOTAL), int(F.HBM_USED), int(F.HBM_FREE), int(F.HBM_PEAK_USED),
    int(F.ECC_SBE_TOTAL), int(F.ECC_DBE_TOTAL), int(F.ECC_SBE_VOLATILE), int(F.ECC_DBE_VOLATILE),
    int(F.HBM_REMAPPED_SBE), int(F.HBM_REMAPPED_DBE), int(F.HBM_REMAP_PENDING),
    int(F.ICI_CRC_ERRORS), int(F.ICI_RECOVERY_ERRORS), int(F.ICI_REPLAY_ERRORS),
    int(F.ICI_TX_THROUGHPUT), int(F.ICI_RX_THROUGHPUT), int(F.ICI_LINKS_UP),
    int(F.ICI_LINK_TX), int(F.ICI_LINK_RX), int(F.ICI_LINK_CRC_ERRORS),
    int(F.ICI_LINK_STATE),
]

#: profiling add-on (-p flag; cf. dcgm-exporter:179-187 DCP fields 1001-1005)
EXPORTER_PROFILING_FIELDS: List[int] = [
    int(F.PROF_TENSORCORE_ACTIVE), int(F.PROF_MXU_ACTIVE),
    int(F.PROF_MXU_OCCUPANCY), int(F.PROF_VECTOR_ACTIVE), int(F.PROF_HBM_ACTIVE),
    int(F.PROF_INFEED_STALL), int(F.PROF_OUTFEED_STALL),
    int(F.PROF_COLLECTIVE_STALL), int(F.PROF_STEP_TIME), int(F.PROF_DUTY_CYCLE_1S),
    int(F.PROF_ACHIEVED_TFLOPS), int(F.PROF_MFU),
    int(F.PROF_HBM_RD_GBPS), int(F.PROF_HBM_WR_GBPS),
]

#: multi-slice add-on (BASELINE config 5)
EXPORTER_DCN_FIELDS: List[int] = [
    int(F.DCN_TX_THROUGHPUT), int(F.DCN_RX_THROUGHPUT), int(F.DCN_TRANSFER_LATENCY),
]

#: the per-link ICI families that have no host-visible source in
#: embedded mode (PARITY.md known gap) — the ONE list the test doubles
#: and the dryrun blank to simulate that gap, so "what embedded mode
#: leaves blank" can never drift between its simulations
PER_LINK_ICI_FIELDS: List[int] = [
    int(F.ICI_LINK_TX), int(F.ICI_LINK_RX),
    int(F.ICI_LINK_CRC_ERRORS), int(F.ICI_LINK_STATE),
]


# -- burst-derived fields (high-rate windowed accumulators) -------------------
#
# 1 Hz polling aliases away sub-second transients entirely (PAPERS.md:
# *Part-time Power Measurements*).  Burst mode samples a declared
# cheap-counter subset at 50-100 Hz into per-(chip, field)
# min/max/mean/time-integral accumulators (tpumon/burst.py is the
# executable spec; native/agent/sampler.hpp the production twin) and
# folds them into the normal 1 Hz sweep as DERIVED fields with ids from
# a dedicated arithmetic range:
#
#     derived_id = BURST_ID_BASE + source_id * 4 + agg
#
# (agg: 0=min 1=max 2=mean 3=integral).  The mapping is arithmetic on
# purpose — adding a source field never renumbers existing derived ids,
# and the C++ twin mirrors the formula from the generated catalog
# constants (tools/gen_catalog_header.py; tools/tpumon_check.py pins
# C++ ⊆ Python).  Range check: source ids are < 1100, so derived ids
# live in [2200, 6403] — clear of the catalog (≤1014) and of the fleet
# shard's synthetic rows (9000+).

BURST_ID_BASE = 2000

#: the declared cheap-counter subset burst mode samples at the inner
#: rate.  Plain ints ON PURPOSE: the wire-constant-sync pass in
#: tools/tpumon_check.py parses this list textually to pin the C++
#: twin's field set against it.  Scalar, lock-free-readable gauges
#: only — the inner loop must never take a lock or a vector read.
BURST_SOURCE_FIELDS: List[int] = [155, 203, 204, 206]

#: aggregate suffixes in wire order (index == the agg offset above)
BURST_AGGS: Tuple[str, str, str, str] = ("min", "max", "mean", "integral")


def burst_id(source_fid: int, agg: int) -> int:
    """Derived field id for ``(source, agg)``; agg indexes BURST_AGGS."""

    return BURST_ID_BASE + int(source_fid) * 4 + int(agg)


def burst_source(derived_fid: int) -> Optional[Tuple[int, int]]:
    """Inverse of :func:`burst_id`: ``(source_fid, agg)`` when
    ``derived_fid`` is in the burst range and its source is a declared
    burst field, else ``None``."""

    off = int(derived_fid) - BURST_ID_BASE
    if off < 0:
        return None
    src, agg = divmod(off, 4)
    if src not in BURST_SOURCE_FIELDS:
        return None
    return src, agg


assert all(int(f) in (int(m) for m in F) for f in BURST_SOURCE_FIELDS), \
    "BURST_SOURCE_FIELDS must name declared F field ids"
assert all(not CATALOG[f].vector_label and CATALOG[f].kind is not
           ValueKind.STRING for f in BURST_SOURCE_FIELDS), \
    "burst sources must be scalar numeric fields"

_BURST_AGG_HELP = {
    "min": "Minimum of {src} over the trailing 1 s burst window.",
    "max": "Maximum of {src} over the trailing 1 s burst window.",
    "mean": "Mean of {src} samples over the trailing 1 s burst window.",
    "integral": "Time integral of {src} over the trailing 1 s burst "
                "window (value x seconds).",
}

for _src in BURST_SOURCE_FIELDS:
    _m = CATALOG[_src]
    for _agg, _suffix in enumerate(BURST_AGGS):
        _fid = burst_id(_src, _agg)
        CATALOG[_fid] = FieldMeta(
            _fid, f"{_m.name}_1s_{_suffix}",
            f"{_m.prom_name}_1s_{_suffix}", FieldType.GAUGE,
            ValueKind.FLOAT,
            (_m.unit + "*s" if _suffix == "integral" else _m.unit),
            _BURST_AGG_HELP[_suffix].format(src=_m.prom_name))
del _src, _m, _agg, _suffix, _fid

#: burst add-on (--burst / --burst-hz): all derived families, in
#: (source, agg) order — what an exporter sweep requests when burst
#: mode is on
EXPORTER_BURST_FIELDS: List[int] = [
    burst_id(s, a) for s in BURST_SOURCE_FIELDS
    for a in range(len(BURST_AGGS))]


def meta(field_id: int) -> FieldMeta:
    return CATALOG[int(field_id)]


def by_name(name: str) -> Optional[FieldMeta]:
    for m in CATALOG.values():
        if m.name == name or m.prom_name == name:
            return m
    return None
