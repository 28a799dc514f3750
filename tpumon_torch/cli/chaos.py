"""tpumon-chaos — run scripted fault-injection scenarios.

The port's copy of ``tpumon/cli/chaos.py``.  The incident scenario corpus
(``tests/data/torch_scenarios/*.yaml``) made executable: each scenario
drives the simulated agent farm and — when its topology says so — real
supervised shard child processes and relay processes through a
deterministic fault timeline (ECC storms and NVLink flaps as NVIDIA Xid
kernel lines, preemption waves, thermal throttles, SIGKILL/SIGSTOP of
shard children and relays, killed listeners, wedged subscribers), then
judges the recovery invariants: K-tick byte-identical convergence
against a flat reference poller, healthy-shard bytes/tick isolation
during a sibling's death, no fd/thread leaks, and a blackbox trace that
replays the fault window.  See :mod:`tpumon_torch.chaos`.

Usage::

    python -m tpumon_torch.cli.chaos run \
        tests/data/torch_scenarios/shard-kill-mid-frame.yaml \
        --out /tmp/chaos-artifacts
    python -m tpumon_torch.cli.chaos validate tests/data/torch_scenarios/*.yaml

``run`` exits non-zero when any invariant is violated; the recorded
trace and ``report.json`` land under ``--out/<scenario-name>/`` either
way, so a red run's flight recording is inspectable without a rerun.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
from typing import List, Optional, Sequence

from ..chaos import Scenario, load_scenario_file, run_scenario
from .common import die, epipe_safe


def _load(paths: Sequence[str]) -> List[Scenario]:
    out: List[Scenario] = []
    for p in paths:
        try:
            out.append(load_scenario_file(p))
        except (OSError, ValueError) as e:
            die(f"{p}: {e}")
    return out


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="tpumon-chaos", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="command", required=True)
    runp = sub.add_parser("run", help="execute scenarios and judge "
                                      "their recovery invariants")
    runp.add_argument("scenarios", nargs="+", metavar="SCENARIO.yaml")
    runp.add_argument("--out", default=None, metavar="DIR",
                      help="artifact root: per-scenario trace + "
                           "report.json (default: a temp dir)")
    runp.add_argument("--json", action="store_true",
                      help="emit one JSON report per scenario on "
                           "stdout instead of the summary lines")
    valp = sub.add_parser("validate",
                          help="parse + schema-check scenarios "
                               "without running them")
    valp.add_argument("scenarios", nargs="+", metavar="SCENARIO.yaml")
    args = p.parse_args(argv)

    def body() -> int:
        scenarios = _load(args.scenarios)
        if args.command == "validate":
            for s in scenarios:
                print(f"{s.name}: ok ({len(s.actions)} actions, "
                      f"{s.ticks} ticks, hosts={s.hosts} "
                      f"shards={s.shards}"
                      f"{' supervised' if s.supervise else ''})")
            return 0
        out_root = args.out or tempfile.mkdtemp(prefix="tpumon-chaos-")
        failed = 0
        for s in scenarios:
            report = run_scenario(s, os.path.join(out_root, s.name))
            if args.json:
                print(json.dumps(report.to_json(), sort_keys=True),
                      flush=True)
            else:
                verdict = "PASS" if report.ok else "FAIL"
                ttc = (f"{report.ticks_to_converge} ticks to converge"
                       if report.ticks_to_converge is not None
                       else "no faults" if report.fault_end_tick is None
                       else "never converged")
                print(f"[{verdict}] {s.name}: {ttc}, "
                      f"{report.restarts_total} restart(s), "
                      f"fdΔ={report.fd_delta} "
                      f"thrΔ={report.thread_delta} "
                      f"trace={report.trace_dir}", flush=True)
                for v in report.violations:
                    print(f"         - {v}", flush=True)
            failed += 0 if report.ok else 1
        print(f"{len(scenarios) - failed}/{len(scenarios)} "
              f"scenario(s) passed; artifacts under {out_root}",
              file=sys.stderr, flush=True)
        return 1 if failed else 0

    return epipe_safe(body)


if __name__ == "__main__":
    sys.exit(main())
