"""tpumon-processinfo — per-PID accounting.

The port's copy of ``tpumon/cli/processinfo.py``: holders of
``/dev/nvidia<minor>`` by the /proc fd scan, accounted from NVML's
utilization, energy and PCIe counters.

Analog of ``samples/dcgm/processInfo/main.go`` (watch PID fields, 3 s
warm-up at ``processInfo/main.go:72``, then render per-PID stats; expected
output in ``samples/dcgm/README.md:120-160``).
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Optional, Sequence

import tpumon_torch

from .common import add_connection_flags, die, fmt, init_from_args

TEMPLATE = """\
---------- Process {pid} ----------
Name                   : {name}
Chips                  : {chips}
Start Time             : {start}
Energy Consumed (J)    : {energy}
TensorCore Util avg/max: {tc_avg} / {tc_max} %
HBM BW Util avg/max    : {hbm_avg} / {hbm_max} %
Max HBM Used (MiB)     : {hbm_used}
PCIe tx/rx (MB/s)      : {tx} / {rx}
Health Events          : {health}
Chip Resets            : {resets}
"""


def render(info: "tpumon_torch.ProcessInfo") -> str:
    start = "-"
    if info.start_time_us:
        start = time.strftime("%Y-%m-%d %H:%M:%S",
                              time.localtime(info.start_time_us / 1e6))
    return TEMPLATE.format(
        pid=info.pid, name=fmt(info.name or None),
        chips=",".join(map(str, info.chip_indices)) or "-",
        start=start,
        energy=fmt(info.energy_mj / 1000.0 if info.energy_mj is not None
                   else None),
        tc_avg=fmt(info.tensorcore_util.avg),
        tc_max=fmt(info.tensorcore_util.max),
        hbm_avg=fmt(info.hbm_util.avg), hbm_max=fmt(info.hbm_util.max),
        hbm_used=fmt(info.max_hbm_used_mib),
        tx=fmt(info.pcie_tx_mb_s), rx=fmt(info.pcie_rx_mb_s),
        health=info.health_event_count, resets=info.num_resets,
    )


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(prog="tpumon-processinfo",
                                description=__doc__)
    add_connection_flags(p)
    p.add_argument("--pid", type=int, action="append", default=None,
                   help="PID to account (repeatable; default: all holders)")
    p.add_argument("--warmup", type=float, default=tpumon_torch.WATCH_WARMUP_S,
                   help="seconds of samples to gather before reporting "
                        "(default 3, the reference's warm-up)")
    args = p.parse_args(argv)

    try:
        h = init_from_args(args)
    except tpumon_torch.BackendError as e:
        die(str(e))
    try:
        h.watch_pid_fields(args.pid)
        # accumulate samples (restApi/handlers/dcgm.go:127-129 semantics)
        deadline = time.monotonic() + args.warmup
        while time.monotonic() < deadline:
            h.watches.update_all(wait=True)
            time.sleep(0.2)

        pids = args.pid
        if pids is None:
            # enumerate holders through the public status API, not the
            # backend (the samples-use-only-L3 layering rule)
            pids = sorted({pr.pid for c in h.supported_chips()
                           for pr in h.chip_status(c).processes})
            if not pids:
                print("No processes currently hold a GPU.")
                return 0
        for pid in pids:
            sys.stdout.write(render(h.get_process_info(pid)))
    finally:
        tpumon_torch.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
