"""Steps/s of the bench train step: bare, self-monitored, and
self-monitored with the trace engine off.

    python -m tpumon_torch.loadgen.pairs [--pairs 3] [--seconds 10]

Runs ``python -m tpumon_torch.loadgen.run --size bench --json`` as one
process per leg: without ``--self-monitor`` (``bare``), with it
(``monitored``), and with it under ``TPUMON_CUDA_TRACE=0``
(``monitored_no_trace``).  Each round runs the three once, in an order
that rotates from round to round, so that a drift across the run falls on
every side alike.  Prints each leg's JSON result line, then one summary
line: the steps/s of every leg, the median of each side, each monitored
median over the bare one, and each side's spread ((max - min) / median).
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

#: leg -> (self-monitored, environment added to the leg's)
LEGS = {"bare": (False, {}),
        "monitored": (True, {}),
        "monitored_no_trace": (True, {"TPUMON_CUDA_TRACE": "0"})}


def leg(seconds: float, monitored: bool, env: dict) -> dict:
    cmd = [sys.executable, "-m", "tpumon_torch.loadgen.run", "--size",
           "bench", "--seconds", str(seconds), "--json"]
    if monitored:
        cmd.append("--self-monitor")
    out = subprocess.run(cmd, capture_output=True, text=True, check=True,
                         timeout=seconds + 300, env={**os.environ, **env})
    return json.loads(out.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="tpumon-torch-pairs",
                                description=__doc__)
    p.add_argument("--pairs", type=int, default=3,
                   help="rounds of the three legs")
    p.add_argument("--seconds", type=float, default=10.0)
    args = p.parse_args(argv)

    names = list(LEGS)
    rates = {name: [] for name in names}
    for i in range(args.pairs):
        for name in names[i % 3:] + names[:i % 3]:
            result = leg(args.seconds, *LEGS[name])
            print(json.dumps(dict(result, leg=name)), flush=True)
            rates[name].append(result["steps_per_sec"])
    med = {side: statistics.median(r) for side, r in rates.items()}
    print(json.dumps({
        "steps_per_sec": rates,
        "median": med,
        "monitored_over_bare": med["monitored"] / med["bare"],
        "monitored_no_trace_over_bare":
            med["monitored_no_trace"] / med["bare"],
        "spread": {side: (max(r) - min(r)) / med[side]
                   for side, r in rates.items()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
