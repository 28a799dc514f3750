"""tpumon-health — subsystem health watch + check.

The port's copy of ``tpumon/cli/health.py`` (``python -m
tpumon_torch.cli.health``), over the NVML backend by default.

Analog of ``samples/dcgm/health/main.go`` (dcgmi health -g 1 -c style;
expected output in ``samples/dcgm/README.md:82-104``).
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence

import tpumon_torch

from .common import add_connection_flags, die, init_from_args, ticker


def print_result(res: "tpumon_torch.HealthResult") -> None:
    print(f"Chip {res.chip_index} overall health: {res.status.name}")
    for inc in res.incidents:
        print(f"  [{inc.status.name}] {inc.system.name}: {inc.message}")


def _run(argv=None) -> int:
    p = argparse.ArgumentParser(prog="tpumon-health", description=__doc__)
    add_connection_flags(p)
    p.add_argument("--chip", type=int, default=None,
                   help="chip index (default: all)")
    p.add_argument("-w", "--watch", type=float, default=None, metavar="SEC",
                   help="re-check every SEC seconds until interrupted")
    args = p.parse_args(argv)

    try:
        h = init_from_args(args)
    except tpumon_torch.BackendError as e:
        die(str(e))
    rc = 0
    try:
        supported = set(h.supported_chips())
        chips = ([args.chip] if args.chip is not None
                 else sorted(supported))
        for c in chips:
            if c not in supported:
                die(f"no such chip: {c}", 2)
            h.health_set(c, tpumon_torch.HealthSystem.ALL)

        if args.watch:
            for _ in ticker(args.watch):
                for c in chips:
                    print_result(h.health_check(c))
                sys.stdout.flush()
        else:
            for c in chips:
                res = h.health_check(c)
                print_result(res)
                if res.status != tpumon_torch.HealthStatus.PASS:
                    rc = 1
    finally:
        tpumon_torch.shutdown()
    return rc


def main(argv: Optional[Sequence[str]] = None) -> int:
    from .common import epipe_safe
    return epipe_safe(lambda: _run(argv))


if __name__ == "__main__":
    sys.exit(main())
