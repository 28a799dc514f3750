"""tpumon-dmon — streaming per-chip metrics table.

The port's copy of ``tpumon/cli/dmon.py``: on the GPU the columns read
NVML (power, temperature, SM and memory utilization, clocks); the
infeed/outfeed columns have no NVML source and print ``-``.  Run it as
``python -m tpumon_torch.cli.dmon -c 3``.

Analog of the reference's dmon samples (``samples/nvml/dmon/main.go:43-59``
ticker loop; ``samples/dcgm/dmon/main.go:19-20`` maps to ``dcgmi dmon -e
155,150,203,204,206,207,100,101`` — exactly the DMON_FIELDS set).
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence

import tpumon_torch
from tpumon_torch import fields as FF

from .common import add_connection_flags, die, fmt, init_from_args

HEADER = ("# chip   pwr  temp  tcutil  hbmbw  infeed  outfeed  tcclk  hbmclk\n"
          "# Idx      W     C       %      %       %        %    MHz     MHz")


def row(index: int, vals) -> str:
    F = FF.F
    return (f"  {index:4d}"
            f"  {fmt(vals.get(int(F.POWER_USAGE)), 4)}"
            f"  {fmt(vals.get(int(F.CORE_TEMP)), 4)}"
            f"  {fmt(vals.get(int(F.TENSORCORE_UTIL)), 6)}"
            f"  {fmt(vals.get(int(F.HBM_BW_UTIL)), 5)}"
            f"  {fmt(vals.get(int(F.INFEED_UTIL)), 6)}"
            f"  {fmt(vals.get(int(F.OUTFEED_UTIL)), 7)}"
            f"  {fmt(vals.get(int(F.TENSORCORE_CLOCK)), 5)}"
            f"  {fmt(vals.get(int(F.HBM_CLOCK)), 6)}")


def _run(argv=None) -> int:
    p = argparse.ArgumentParser(prog="tpumon-dmon", description=__doc__)
    add_connection_flags(p)
    p.add_argument("-d", "--delay", type=float, default=1.0,
                   help="sampling interval seconds (default 1, min 0.1)")
    p.add_argument("-c", "--count", type=int, default=None,
                   help="number of sweeps, default: until interrupted")
    p.add_argument("--chips", default=None,
                   help="comma-separated chip indices (default: all)")
    args = p.parse_args(argv)
    if args.delay < 0.1:
        die("minimum delay is 0.1s (matching the reference's 100 ms floor)")

    try:
        h = init_from_args(args)
    except tpumon_torch.BackendError as e:
        die(str(e))
    try:
        supported = h.supported_chips()
        if args.chips:
            parts = [c.strip() for c in args.chips.split(",")]
            bad_syntax = [c for c in parts if not c.isdigit()]
            if bad_syntax:
                die(f"invalid chip index: {bad_syntax[0]!r}")
            chips = [int(c) for c in parts]
        else:
            chips = list(supported)
        bad = [c for c in chips if c not in set(supported)]
        if bad:
            die(f"no such chip: {bad[0]}", 2)

        # long-lived watch at the requested frequency
        fg = h.watches.create_field_group(FF.DMON_FIELDS, "dmon")
        cg = h.watches.create_chip_group(chips, "dmon")
        h.watches.watch_fields(cg, fg,
                               update_freq_us=int(args.delay * 1e6))

        from .common import ticker
        for tick in ticker(args.delay, args.count):
            h.watches.update_all(wait=True)
            if tick % 20 == 0:
                print(HEADER)
            for c in chips:
                print(row(c, h.watches.latest_values(c, fg.field_ids)))
            sys.stdout.flush()
    finally:
        tpumon_torch.shutdown()
    return 0


def main(argv: Optional[Sequence[str]] = None) -> int:
    from .common import epipe_safe
    return epipe_safe(lambda: _run(argv))


if __name__ == "__main__":
    sys.exit(main())
