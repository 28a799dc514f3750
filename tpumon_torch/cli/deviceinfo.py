"""tpumon-deviceinfo — static per-chip inventory.

The port's copy of ``tpumon/cli/deviceinfo.py`` (``python -m
tpumon_torch.cli.deviceinfo``): the NVML backend fills the template's
fields; the slice coordinates are the device's index.

Analog of the reference's deviceInfo samples (nvidia-smi -q style template
rendering, ``samples/nvml/deviceInfo/main.go`` and
``samples/dcgm/deviceInfo/main.go:13-34``; expected output documented in
``samples/dcgm/README.md:39-80``).
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence

import tpumon_torch

from .common import add_connection_flags, die, fmt, init_from_args

TEMPLATE = """\
Driver Version         : {driver}
Runtime Version        : {runtime}

==================== Chip {index} ====================
Model                  : {name}
UUID                   : {uuid}
Serial                 : {serial}
Device Path            : {dev_path}
Firmware               : {firmware}
Cores Per Chip         : {cores}
Power Limit (W)        : {power_limit}
HBM Total (MiB)        : {hbm_total}
Max TensorCore Clock   : {tc_clock} MHz
Max HBM Clock          : {hbm_clock} MHz
PCI BusID              : {bus_id}
Slice Coordinates      : ({x},{y},{z}) slice {slice}
NUMA Affinity          : {numa}
Host                   : {host}
"""


def render(h: "tpumon_torch.Handle", index: int) -> str:
    info = h.chip_info(index)
    v = h.versions()
    return TEMPLATE.format(
        driver=v.driver or "-", runtime=v.runtime or "-",
        index=info.index, name=info.name, uuid=info.uuid,
        serial=fmt(info.serial or None), dev_path=fmt(info.dev_path or None),
        firmware=fmt(info.firmware or None), cores=info.cores_per_chip,
        power_limit=fmt(info.power_limit_w), hbm_total=fmt(info.hbm.total),
        tc_clock=fmt(info.clocks_max.tensorcore),
        hbm_clock=fmt(info.clocks_max.hbm),
        bus_id=fmt(info.pci.bus_id or None),
        x=info.coords.x, y=info.coords.y, z=info.coords.z,
        slice=info.coords.slice_index,
        numa=fmt(info.numa_node), host=fmt(info.host or None),
    )


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(prog="tpumon-deviceinfo",
                                description=__doc__)
    add_connection_flags(p)
    p.add_argument("--chip", type=int, default=None,
                   help="chip index (default: all)")
    args = p.parse_args(argv)

    try:
        h = init_from_args(args)
    except tpumon_torch.BackendError as e:
        die(str(e))
    try:
        chips = ([args.chip] if args.chip is not None
                 else h.supported_chips())
        for i in chips:
            try:
                sys.stdout.write(render(h, i))
            except tpumon_torch.ChipNotFound:
                die(f"no such chip: {i}", 2)
    finally:
        tpumon_torch.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
