"""What a monitor span costs the thread that records it.

    python -m tpumon_torch.loadgen.span_cost [--spans 200000] [--rounds 5]

Times, per span, in one process (:mod:`tpumon_torch.spans`):

* ``off_root_ns`` — :func:`~tpumon_torch.spans.span` outside any root (the
  backend's phases read outside a sweep): a thread-local read;
* ``span_ns`` — a span of a sweep-sized tree (a root and ``TREE - 1``
  children) with no profiler session: two clock reads and the
  aggregates;
* ``span_in_session_ns`` — the same inside a ``torch.profiler`` session
  (CPU activity, and CUDA where a card is present) marked as the trace
  engine marks its own, where each span enters and exits a
  ``record_function`` range besides.

Each is the median over ``--rounds`` of the mean over ``--spans`` spans
(a twentieth of them inside the session, whose profiler buffers every
range).  Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

#: spans of a sweep-sized tree (a root and its phases)
TREE = 16


def _per_span_ns(fn, n: int, rounds: int) -> float:
    out = []
    for _ in range(rounds):
        t0 = time.perf_counter_ns()
        fn(n)
        out.append((time.perf_counter_ns() - t0) / n)
    return statistics.median(out)


def measure(n: int, rounds: int) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from tpumon_torch import spans, trace

    rec = spans.Recorder()

    def off_root(k: int) -> None:
        for _ in range(k):
            with spans.span("probe"):
                pass

    def trees(k: int) -> None:
        for _ in range(k // TREE):
            with rec.root("sweep"):
                for _ in range(TREE - 1):
                    with spans.span("probe"):
                        pass

    out = {"off_root_ns": _per_span_ns(off_root, n, rounds),
           "span_ns": _per_span_ns(trees, n, rounds)}
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    n_in = max(TREE, n // 20)
    with trace.profiler_session():
        prof = profile(activities=acts)
        prof.start()
        spans.mirroring = True          # as the engine's own session
        try:
            out["span_in_session_ns"] = _per_span_ns(trees, n_in, rounds)
        finally:
            spans.mirroring = False
            trace.close_session(prof)
    out["spans_in_session"] = n_in
    out["cuda"] = torch.cuda.is_available()
    if out["cuda"]:
        out["device"] = torch.cuda.get_device_name(0)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m tpumon_torch.loadgen.span_cost", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--spans", type=int, default=200_000)
    p.add_argument("--rounds", type=int, default=5)
    args = p.parse_args(argv)
    print(json.dumps(measure(args.spans, args.rounds)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
