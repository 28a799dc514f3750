"""tpumon-policy — register violation policies and stream violations.

The port's copy of ``tpumon/cli/policy.py`` (``python -m
tpumon_torch.cli.policy``), over the NVML backend by default: power and
temperature thresholds are evaluated on a 0.2 s sweep, Xid events arrive
through the backend's event buffer.

Analog of ``samples/dcgm/policy/main.go`` (registers conditions, blocks on
the violation channel printing each event; ``policy/main.go:44`` ``pe := <-c``).
"""

from __future__ import annotations

import argparse
import queue
import sys
import time
from typing import Optional, Sequence

import tpumon_torch
from tpumon_torch.events import PolicyCondition

from .common import add_connection_flags, die, init_from_args

_COND_NAMES = {
    "dbe": PolicyCondition.ECC_DBE,
    "pcie": PolicyCondition.PCIE,
    "remap": PolicyCondition.HBM_REMAP,
    "thermal": PolicyCondition.THERMAL,
    "power": PolicyCondition.POWER,
    "ici": PolicyCondition.ICI,
    "reset": PolicyCondition.CHIP_RESET,
    "all": PolicyCondition.ALL,
}


def _run(argv=None) -> int:
    p = argparse.ArgumentParser(prog="tpumon-policy", description=__doc__)
    add_connection_flags(p)
    p.add_argument("--chip", type=int, default=0, help="chip index")
    p.add_argument("--conditions", default="all",
                   help="comma list: dbe,pcie,remap,thermal,power,ici,reset "
                        "(default all)")
    p.add_argument("--thermal-limit", type=float, default=None, metavar="C")
    p.add_argument("--power-limit", type=float, default=None, metavar="W")
    p.add_argument("--duration", type=float, default=None, metavar="SEC",
                   help="exit after SEC seconds (default: run forever)")
    args = p.parse_args(argv)

    conds = PolicyCondition.NONE
    for name in args.conditions.split(","):
        c = _COND_NAMES.get(name.strip().lower())
        if c is None:
            die(f"unknown condition {name!r}; choose from "
                f"{','.join(_COND_NAMES)}")
        conds |= c

    thresholds = {}
    if args.thermal_limit is not None:
        thresholds[PolicyCondition.THERMAL] = args.thermal_limit
    if args.power_limit is not None:
        thresholds[PolicyCondition.POWER] = args.power_limit

    try:
        h = init_from_args(args)
    except tpumon_torch.BackendError as e:
        die(str(e))
    try:
        if args.chip not in h.supported_chips():
            die(f"no such chip: {args.chip}", 2)
        violations = h.register_policy(args.chip, conds, thresholds or None)
        h.watches.start(tick_s=0.2)  # sweeps drive the violation stream
        print(f"Listening for policy violations on chip {args.chip} "
              f"({args.conditions})...")
        sys.stdout.flush()
        deadline = (time.monotonic() + args.duration
                    if args.duration else None)
        while deadline is None or time.monotonic() < deadline:
            try:
                v = violations.get(timeout=0.2)
            except queue.Empty:
                continue
            ts = time.strftime("%H:%M:%S", time.localtime(v.timestamp))
            print(f"{ts} chip {v.chip_index} {v.condition.name}: "
                  f"{v.message or v.data}")
            sys.stdout.flush()
    except KeyboardInterrupt:
        pass
    finally:
        tpumon_torch.shutdown()
    return 0


def main(argv: Optional[Sequence[str]] = None) -> int:
    from .common import epipe_safe
    return epipe_safe(lambda: _run(argv))


if __name__ == "__main__":
    sys.exit(main())
