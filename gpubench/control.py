"""Readings that the limits of ``correct`` are set from, on the chip, at
the cell's own size: the program's numbers over many seeds and the
control's over the same seeds, in one process.

    python3 -m gpubench.control --workload <cell> --seeds 1,2,3 \\
        [--seconds 10]

For each seed it runs the cell once (``run.run_cell``, a short window at
the cell's own load) and prints the numbers compared (with ``--fault``,
those of the program with that fault planted); then the control:
the reference in fp8 put in the program's place (its kind's ``control``:
the train step's first steps from the seed's weights, or a pattern step
from the seed's input),
and the window's scrapes with every merged value rounded to float32 in
place of what the node served.  One JSON line a seed.  The benchmark's
own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np


def f32_body(body):
    """A parsed body with every value rounded to float32."""

    return {k: repr(float(np.float32(float(v)))) for k, v in body.items()}


def control_numbers(run) -> dict:
    """The cell's numbers with the control in the program's place: its
    kind's (``kinds/<kind>.py`` ``control``), and the window's scrapes
    with every served value rounded to float32."""

    from . import check, kinds

    out = kinds.load(run.traffic["workload"]["kind"]).control(run)
    mon, _ = check.monitor_numbers(run.scrapes, run.own_series, run.uuid,
                                   run.config["min_card_families"], run.due,
                                   run.hbm_total_mib, alter=f32_body)
    out.update(mon)
    return out


def main(argv=None) -> int:
    from .run import CACHES, ROOT, load_json, run_cell

    p = argparse.ArgumentParser(prog="gpubench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--fault", default=None,
                   help="plant a fault in the timed path instead "
                        "(the kind's FAULTS): the faulted program's "
                        "numbers, no control")
    args = p.parse_args(argv)
    for var, rel in CACHES.items():
        os.environ[var] = str(ROOT / rel)
    bench = load_json(ROOT / "BENCHMARK.json")
    for seed in (int(s) for s in args.seeds.split(",")):
        keep = {}
        result = run_cell(bench, args.workload, seed, args.seconds, 0,
                          fault=args.fault, keep=keep)
        program = {k: c["value"] for k, c in result["compared"].items()}
        control = None if args.fault else control_numbers(keep["run"])
        print(json.dumps({"seed": seed, "fault": args.fault,
                          "correct": result["correct"],
                          "failed": result["failed"],
                          "program": program, "control": control,
                          "metrics": {k: m["value"] for k, m in
                                      result["metrics"].items()}}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
