"""Steps/s of the bench train step, bare against self-monitored.

    python -m tpumon_torch.loadgen.pairs [--pairs 3] [--seconds 10]

Runs ``python -m tpumon_torch.loadgen.run --size bench --json`` as one
process per leg, without and with ``--self-monitor``, in pairs whose
order alternates (bare then monitored, monitored then bare, ...) so that
a drift across the run falls on both sides alike.  Prints each leg's
JSON result line, then one summary line: the steps/s of every leg, the
median of each side, the monitored median over the bare one, and each
side's spread ((max - min) / median).  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys


def leg(seconds: float, monitored: bool) -> dict:
    cmd = [sys.executable, "-m", "tpumon_torch.loadgen.run", "--size",
           "bench", "--seconds", str(seconds), "--json"]
    if monitored:
        cmd.append("--self-monitor")
    out = subprocess.run(cmd, capture_output=True, text=True, check=True,
                         timeout=seconds + 300)
    return json.loads(out.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="tpumon-torch-pairs",
                                description=__doc__)
    p.add_argument("--pairs", type=int, default=3)
    p.add_argument("--seconds", type=float, default=10.0)
    args = p.parse_args(argv)

    rates = {"bare": [], "monitored": []}
    for i in range(args.pairs):
        for monitored in ((False, True) if i % 2 == 0 else (True, False)):
            result = leg(args.seconds, monitored)
            print(json.dumps(result), flush=True)
            rates["monitored" if monitored else "bare"].append(
                result["steps_per_sec"])
    med = {side: statistics.median(r) for side, r in rates.items()}
    print(json.dumps({
        "steps_per_sec": rates,
        "median": med,
        "monitored_over_bare": med["monitored"] / med["bare"],
        "spread": {side: (max(r) - min(r)) / med[side]
                   for side, r in rates.items()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
