"""Does a closed profiler session leave the process slower, and which part
of the session leaves it so?

    python -m tpumon_torch.loadgen.capture_effect [--rounds 10]
        [--seconds 2] [--legs engine,torn,...] [--teardown-pairs 0]

In ONE process, the bench train step as the runner steps it on the card
(a CUDA graph, :class:`.graph.GraphStep`; batch 8, a scalar read every 32
steps) is timed in windows of ``--seconds``: three windows before any
profiler session of the process has opened (``never``); then, after one
capture that pays the profiler's one-time initialization, ``--rounds``
rounds of the legs, their order rotating from round to round.  Every leg
starts from the same state: a capture closed with CUPTI torn down
(``TEARDOWN_CUPTI=1``), then half a second of steps; then the leg's own
session, closed; then the timed window.  The legs (:data:`LEGS`):

* ``torn`` — the engine's session (CPU and CUDA activities,
  ``with_flops``), CUPTI torn down at the close: the yardstick;
* ``engine`` — the engine's session closed as :class:`TraceEngine` closes
  it (:data:`tpumon_torch.trace.TEARDOWN_ENV` unset: the engine tears
  CUPTI down, and its next session waits for the teardown to land);
* ``kept`` — the engine's session, CUPTI kept up (``TEARDOWN_CUPTI=0``);
* ``cuda_only`` — a session of the CUDA activity alone, no FLOPs or
  shapes, CUPTI kept up;
* ``no_flops`` — CPU and CUDA activities without ``with_flops`` and
  ``record_shapes``, CUPTI kept up;
* ``cpu_only`` — the CPU activity alone with ``with_flops`` (no CUPTI
  activity at all: the profiler's op callbacks only);
* ``empty`` — the engine's session opened and closed with no step inside,
  CUPTI kept up.

After the rounds, one more torn-down capture and three windows
(``late``): the rate after every session of the process has closed
torn down, against ``never``.

Each leg's session also reports the device records it kept
(``records``): a session that records none next to its steps is the
failure a torn-down close risks.  ``--teardown-pairs N`` adds N pairs of
sessions (CPU and CUDA, ``with_flops``, steps inside) closed with CUPTI
torn down and taken back to back, the second opened right after the first
closed (``immediate``) or once :func:`tpumon_torch.trace.settle_teardown`
has let the teardown land (``settled``, as every session of the port
opens), and reports the records of each second session.

Prints one JSON line: the card, each leg's steps/s and median, per leg
the per-round ratio to ``torn``, its median and the rounds the leg was the
slower in, and each session's records.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import sys
import time

#: leg -> (TEARDOWN_CUPTI at the close, session: "engine" or
#: (activities, with_flops), steps inside the session)
LEGS = {
    "torn": ("1", "engine", True),
    "engine": (None, "engine", True),
    "kept": ("0", "engine", True),
    "cuda_only": ("0", (("CUDA",), False), True),
    "no_flops": ("0", (("CPU", "CUDA"), False), True),
    "cpu_only": ("0", (("CPU",), True), True),
    "empty": ("0", "engine", False),
}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="tpumon-torch-capture-effect",
                                description=__doc__)
    p.add_argument("--rounds", type=int, default=10)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--legs", default=",".join(LEGS),
                   help=f"comma-separated legs (default: {','.join(LEGS)})")
    p.add_argument("--teardown-pairs", type=int, default=0)
    args = p.parse_args(argv)
    legs = [leg for leg in args.legs.split(",") if leg]
    unknown = [leg for leg in legs if leg not in LEGS]
    if unknown or "torn" not in legs:
        raise SystemExit(f"legs must include torn and come from {list(LEGS)}")

    import torch
    from torch.profiler import ProfilerActivity, profile

    from ..trace import (PROFILER_LOCK, TEARDOWN_ENV, TraceEngine,
                         mark_teardown, profiler_session)
    from .graph import GraphStep
    from .run import DEFAULT_BATCH, resolve_device, workload

    if TEARDOWN_ENV in os.environ:
        raise SystemExit(f"{TEARDOWN_ENV} is set: the legs set it themselves")
    graph = GraphStep(*workload("bench", DEFAULT_BATCH,
                                resolve_device("cuda")))
    state = {"loss": None, "n": 0}

    def step() -> None:
        _, state["loss"] = graph.step()
        state["n"] += 1
        if state["n"] % 32 == 0:
            state["loss"].item()

    def steps_for(seconds: float) -> None:
        t0 = time.monotonic()
        while time.monotonic() - t0 < seconds:
            step()
        state["loss"].item()

    def window() -> float:
        n0, t0 = state["n"], time.monotonic()
        steps_for(args.seconds)
        return (state["n"] - n0) / (time.monotonic() - t0)

    def engine_capture(stepping: bool) -> int:
        eng = TraceEngine()
        if not eng.capture_now(step=step if stepping else None):
            raise RuntimeError(f"capture failed: {eng.last_error}")
        eng.quiesce()
        samples = eng.latest()
        return sum(s.n_ops for s in samples.values())

    @contextlib.contextmanager
    def unsettled():
        # profiler_session() without its settle: the race it closes
        with PROFILER_LOCK:
            yield
            if os.environ.get(TEARDOWN_ENV) == "1":
                mark_teardown()

    def own_capture(activities, flops: bool, settle: bool = True) -> int:
        acts = [getattr(ProfilerActivity, a) for a in activities]
        with (profiler_session() if settle else unsettled()):
            prof = profile(activities=acts, with_flops=flops,
                           record_shapes=flops)
            prof.start()
            try:
                steps_for(0.25)
            finally:
                prof.stop()
        cuda = torch.autograd.DeviceType.CUDA
        return sum(1 for e in prof.profiler.kineto_results.events()
                   if e.device_type() == cuda)

    def capture(leg: str) -> int:
        teardown, session, stepping = LEGS[leg]
        if teardown is not None:
            os.environ[TEARDOWN_ENV] = teardown
        try:
            if session == "engine":
                return engine_capture(stepping)
            return own_capture(*session)
        finally:
            os.environ.pop(TEARDOWN_ENV, None)

    for _ in range(32):
        step()
    state["loss"].item()
    rates = {"never": [window() for _ in range(3)]}
    records = {leg: [] for leg in legs}
    rates.update({leg: [] for leg in legs})
    capture("torn")
    for i in range(args.rounds):
        for leg in legs[i % len(legs):] + legs[:i % len(legs)]:
            capture("torn")
            steps_for(0.5)
            records[leg].append(capture(leg))
            rates[leg].append(window())
    capture("torn")
    rates["late"] = [window() for _ in range(3)]
    out = {"device": torch.cuda.get_device_name(0), "steps_per_sec": rates,
           "median": {leg: statistics.median(r) for leg, r in rates.items()},
           "records": records}
    for leg in legs:
        if leg == "torn":
            continue
        ratio = [a / t for a, t in zip(rates[leg], rates["torn"])]
        out[f"{leg}_over_torn"] = ratio
        out[f"{leg}_over_torn_median"] = statistics.median(ratio)
        out[f"{leg}_slower_rounds"] = sum(r < 1.0 for r in ratio)
    out["late_over_never_median"] = (out["median"]["late"]
                                     / out["median"]["never"])
    if args.teardown_pairs:
        pairs = {"immediate": [], "settled": []}
        for i in range(args.teardown_pairs):
            for mode in ("immediate", "settled"):
                os.environ[TEARDOWN_ENV] = "1"
                try:
                    own_capture(("CPU", "CUDA"), True)
                    pairs[mode].append(own_capture(
                        ("CPU", "CUDA"), True, settle=mode == "settled"))
                finally:
                    os.environ.pop(TEARDOWN_ENV, None)
                steps_for(0.5)
        out["teardown_pairs_records"] = pairs
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
