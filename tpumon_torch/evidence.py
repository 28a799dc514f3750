"""Host evidence kit: one command that proves what THIS host exposes.

The port's copy of ``tpumon/evidence.py``, on an NVIDIA host: one JSON
report of

* the kernel surface — the ``/dev/nvidia*`` nodes, and per NVIDIA PCI
  device (vendor 0x10de, display class) its sysfs identity (PCI ids,
  NUMA node, CPU list, link speed and width) and any hwmon sensors;
* the driver — ``/proc/driver/nvidia/version``;
* the library — whether NVML resolves here (``TPUMON_NVML_PATH``, then the
  loader's search path), presence only: loading it is the backend's job;
* per-family provenance — for every exporter family, whether the active
  backend served a live value this instant or blank (plus the backend
  name);
* an NVLink counter scan — a bounded walk of the NVIDIA devices' sysfs
  trees and debugfs for files named like NVLink/NVSwitch/lane counters, and a
  grep of /proc/interrupts.  The scan never invents: an empty list is
  itself evidence.

Relocatable through ``TPUMON_NVML_SYSFS_ROOT`` (``/sys`` and ``/proc``)
and ``TPUMON_NVML_DEV_ROOT`` (``/dev``), so the hermetic tests run the
same code against a fixture tree.

Run it: ``python -m tpumon_torch.cli.diag --evidence > evidence.json``.
"""

from __future__ import annotations

import glob
import json
import os
import re
import time
from typing import Dict, List, Optional

SCHEMA = "tpumon_torch-evidence/1"

#: filename patterns that could plausibly be per-link NVLink counters
#: (not "link": every PCI device has PCIe link_speed/link_width files)
_LINK_RE = re.compile(r"nvlink|nvswitch|lane", re.I)
#: never descend into these (huge/recursive sysfs subtrees)
_SKIP_DIRS = frozenset({"firmware_node", "subsystem", "driver", "of_node",
                        "physfn", "virtfn0", "iommu", "iommu_group"})
_MAX_CANDIDATES = 200
_MAX_DEPTH = 6
#: NVIDIA's PCI vendor id
NVIDIA_VENDOR = "0x10de"


def _read1(path: str) -> Optional[str]:
    try:
        with open(path) as f:
            return f.read(256).strip()
    except OSError:
        return None


def _sysfs_root() -> str:
    return os.environ.get("TPUMON_NVML_SYSFS_ROOT", "")


def _dev_root() -> str:
    return os.environ.get("TPUMON_NVML_DEV_ROOT", "")


def _host_info() -> Dict[str, object]:
    u = os.uname()
    return {"hostname": u.nodename, "kernel": u.release,
            "machine": u.machine, "time_unix": int(time.time())}


def _device_nodes() -> List[str]:
    droot = _dev_root()
    out = sorted(glob.glob(f"{droot}/dev/nvidia*"))
    return [p[len(droot):] if droot else p for p in out]


def _gpu_pci_devices() -> List[str]:
    """sysfs directories of the NVIDIA display-class PCI devices."""

    sroot = _sysfs_root()
    return [d for d in sorted(glob.glob(f"{sroot}/sys/bus/pci/devices/*"))
            if _read1(os.path.join(d, "vendor")) == NVIDIA_VENDOR
            and (_read1(os.path.join(d, "class")) or "").startswith("0x03")]


def _chip_sysfs() -> List[Dict[str, object]]:
    """Per-GPU kernel identity + hwmon sample (nvml.go:294-312 role)."""

    sroot = _sysfs_root()
    chips: List[Dict[str, object]] = []
    for dev in _gpu_pci_devices():
        entry: Dict[str, object] = {
            "sysfs": dev[len(sroot):] if sroot else dev,
            "pci_bus_id": os.path.basename(dev),
        }
        for attr in ("vendor", "device", "class", "numa_node",
                     "local_cpulist", "current_link_speed",
                     "current_link_width", "max_link_speed",
                     "max_link_width"):
            entry[attr] = _read1(os.path.join(dev, attr))
        hw: Dict[str, object] = {"present": False}
        for hwdir in sorted(glob.glob(os.path.join(dev, "hwmon/hwmon*"))):
            hw["present"] = True
            for f in sorted(os.listdir(hwdir)):
                if f.endswith("_input") or f.endswith("_label"):
                    hw[f] = _read1(os.path.join(hwdir, f))
        entry["hwmon"] = hw
        chips.append(entry)
    return chips


def _driver_version() -> Optional[str]:
    """The kernel module's version line, or None without the driver."""

    try:
        with open(f"{_sysfs_root()}/proc/driver/nvidia/version") as f:
            return f.readline().strip() or None
    except OSError:
        return None


def _nvml_presence() -> Dict[str, object]:
    """Does NVML resolve here?  (Presence only — the diag observes; the
    backend loads.)"""

    explicit = os.environ.get("TPUMON_NVML_PATH")
    if explicit and os.path.exists(explicit):
        return {"found": True, "path": explicit}
    # loader search path (resolves without dlopen-ing the library).
    # find_library returns a SONAME, not a filesystem path — reported
    # under its own key so consumers never stat it
    try:
        import ctypes.util
        hit = ctypes.util.find_library("nvidia-ml")
        if hit:
            return {"found": True, "path": None, "soname": hit}
    except Exception:  # noqa: BLE001 — probe only
        pass
    return {"found": False, "path": None}


def _link_counter_scan() -> Dict[str, object]:
    """Bounded search for candidate per-link NVLink kernel counters.

    Roots walked (filename filter ``nvlink|nvswitch|lane``): the NVIDIA PCI
    devices and debugfs, and a grep of /proc/interrupts.  Records path +
    readability + a sample read for each candidate."""

    sroot = _sysfs_root()
    roots = _gpu_pci_devices() + [f"{sroot}/sys/kernel/debug"]
    candidates: List[Dict[str, object]] = []
    searched: List[str] = []
    full_up = False
    for root in roots:
        if full_up:
            break  # hard cap: stop walking entirely, roots included
        searched.append(root[len(sroot):] if sroot else root)
        if not os.path.isdir(root) or not os.access(root, os.R_OK):
            continue
        base_depth = root.rstrip("/").count("/")
        for dirpath, dirnames, filenames in os.walk(root,
                                                    followlinks=False):
            if full_up:
                dirnames[:] = []
                break
            if dirpath.count("/") - base_depth >= _MAX_DEPTH:
                dirnames[:] = []
                continue
            dirnames[:] = [d for d in dirnames if d not in _SKIP_DIRS]
            for fn in filenames:
                if len(candidates) >= _MAX_CANDIDATES:
                    full_up = True
                    break
                if not _LINK_RE.search(fn):
                    continue
                full = os.path.join(dirpath, fn)
                val = _read1(full)
                candidates.append({
                    "path": full[len(sroot):] if sroot else full,
                    "readable": val is not None,
                    "sample": val,
                })
    # interrupt lines often name the interconnect queues.  Full read —
    # the 256-byte attribute helper would stop inside the CPU-column
    # header on any many-core host and report a false "no matches"
    irq_hits: List[str] = []
    try:
        with open(f"{sroot}/proc/interrupts") as f:
            irq = f.read(1 << 20)
        irq_hits = [ln.strip() for ln in irq.splitlines()
                    if _LINK_RE.search(ln)][:20]
    except OSError:
        pass
    return {"searched_roots": searched, "candidates": candidates,
            "truncated": full_up,
            "proc_interrupts_matches": irq_hits}


def _family_provenance(h) -> Dict[str, object]:
    """Live per-family evidence from the active backend: which exporter
    families carry a value RIGHT NOW on chip 0, which are blank — the
    reproducible form of the non-blank-family headline."""

    from . import fields as FF

    fids = sorted({int(f) for f in (
        list(FF.EXPORTER_BASE_FIELDS) + list(FF.EXPORTER_PROFILING_FIELDS)
        + list(FF.EXPORTER_DCN_FIELDS))})
    try:
        vals = h.backend.read_fields(0, fids)
    except Exception as e:  # noqa: BLE001 — report, don't die
        return {"error": repr(e)}
    fams: List[Dict[str, object]] = []
    live = 0
    for fid in fids:
        v = vals.get(fid)
        is_live = v is not None
        live += int(is_live)
        fams.append({"id": fid, "family": FF.CATALOG[fid].prom_name,
                     "live": is_live,
                     "kind": type(v).__name__ if is_live else None})
    return {"backend": h.backend.name, "chip": 0,
            "live_count": live, "total": len(fids), "fields": fams}


def collect(h=None) -> Dict[str, object]:
    """The full evidence report (pure observation, no side effects)."""

    report: Dict[str, object] = {
        "schema": SCHEMA,
        "host": _host_info(),
        "roots": {"sysfs": _sysfs_root() or "/",
                  "dev": _dev_root() or "/"},
        "device_nodes": _device_nodes(),
        "chips_sysfs": _chip_sysfs(),
        "driver": _driver_version(),
        "nvml": _nvml_presence(),
        "nvlink_scan": _link_counter_scan(),
    }
    if h is not None:
        report["families"] = _family_provenance(h)
        try:
            v = h.versions()
            report["versions"] = {"driver": v.driver, "runtime": v.runtime,
                                  "framework": v.framework}
        except Exception as e:  # noqa: BLE001
            report["versions"] = {"error": repr(e)}
    return report


def render(h=None) -> str:
    return json.dumps(collect(h), indent=2)
