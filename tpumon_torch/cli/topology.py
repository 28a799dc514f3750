"""tpumon-topology — the host's GPU interconnect.

The port's copy of ``tpumon/cli/topology.py``, the analog of
``samples/dcgm/topology/main.go`` (dcgmi topo style matrix; link classes
from ``topology.go:64-88``): ``NVL`` for GPUs joined by NVLink (directly
or through an NVSwitch), ``PCIE`` for the rest, with each GPU's CPU
affinity and NUMA node.
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence

import tpumon_torch
from tpumon_torch.types import P2PLinkType

from .common import add_connection_flags, die, fmt, init_from_args

_LINK_LABEL = {
    P2PLinkType.UNKNOWN: "???",
    P2PLinkType.SAME_HOST_PCIE: "PCIE",
    P2PLinkType.ICI_NEIGHBOR: "NVL",
    P2PLinkType.ICI_SAME_SLICE: "ICIn",
    P2PLinkType.DCN: "DCN",
}


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(prog="tpumon-topology", description=__doc__)
    add_connection_flags(p)
    args = p.parse_args(argv)

    try:
        h = init_from_args(args)
    except tpumon_torch.BackendError as e:
        die(str(e))
    try:
        chips = h.supported_chips()
        if not chips:
            print("No GPUs found.")
            return 0
        t0 = h.topology(chips[0])
        if t0.mesh_shape:
            shape = "x".join(map(str, t0.mesh_shape))
            wrap = ",".join("wrap" if w else "open" for w in t0.wrap)
            print(f"GPUs: {shape} ({wrap})")
        # header
        print("      " + "".join(f"  chip{c:<3d}" for c in chips) +
              "  coords    cpu_affinity  numa")
        for c in chips:
            topo = h.topology(c)
            by_index = {l.chip_index: l for l in topo.links}
            cells = []
            for other in chips:
                if other == c:
                    cells.append("   X    ")
                else:
                    l = by_index.get(other)
                    label = _LINK_LABEL.get(l.link, "???") if l else "  - "
                    hops = f"/{l.hops}" if l else ""
                    cells.append(f" {label}{hops}".ljust(8))
            coords = f"({topo.coords.x},{topo.coords.y},{topo.coords.z})"
            print(f"chip{c:<2d}" + "".join(cells) +
                  f"  {coords:<9s} {topo.cpu_affinity:<13s} "
                  f"{fmt(topo.numa_node)}")
    finally:
        tpumon_torch.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
