"""Does a closed trace capture leave the process slower?

    python -m tpumon_torch.loadgen.capture_effect [--rounds 10] [--seconds 2]

In ONE process, the bench train step (batch 8, a scalar read every 32
steps) is timed in windows of ``--seconds``: three windows before any
profiler session of the process has opened (``never``); then, after one
capture that pays the profiler's one-time initialization, ``--rounds``
rounds of three legs, each one trace capture with the workload stepping
in it (``TraceEngine.capture_now``, as the runner's) followed by a window.
The legs differ in how Kineto closes the capture: ``engine``, as the
engine closes it (the environment unset); ``kept``, with
``TEARDOWN_CUPTI=0`` (CUPTI kept up); ``torn``, with
``TEARDOWN_CUPTI=1`` (CUPTI torn down, which the engine does not do: a
later session can then record no device activity).  Their order rotates
from round to round.  Prints one JSON line: each leg's steps/s
and median, and for ``engine`` and ``kept`` the per-round ratio to
``torn``, its median and the rounds that leg was the slower in.  Needs a
CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="tpumon-torch-capture-effect",
                                description=__doc__)
    p.add_argument("--rounds", type=int, default=10)
    p.add_argument("--seconds", type=float, default=2.0)
    args = p.parse_args(argv)

    import torch

    from ..trace import TraceEngine
    from . import model as M
    from .run import DEFAULT_BATCH, resolve_device, workload

    cfg, params, tokens = workload("bench", DEFAULT_BATCH,
                                   resolve_device("cuda"))
    state = {"params": params, "loss": None, "n": 0}

    def step() -> None:
        state["params"], state["loss"] = M.train_step(cfg, state["params"],
                                                      tokens)
        state["n"] += 1
        if state["n"] % 32 == 0:
            state["loss"].item()

    def window() -> float:
        n0, t0 = state["n"], time.monotonic()
        while time.monotonic() - t0 < args.seconds:
            step()
        state["loss"].item()
        return (state["n"] - n0) / (time.monotonic() - t0)

    def capture(teardown) -> None:
        if teardown is not None:
            os.environ["TEARDOWN_CUPTI"] = teardown
        try:
            eng = TraceEngine()
            if not eng.capture_now(step=step):
                raise RuntimeError(f"capture failed: {eng.last_error}")
            eng.quiesce()
        finally:
            os.environ.pop("TEARDOWN_CUPTI", None)
        state["loss"].item()

    legs = {"engine": None, "kept": "0", "torn": "1"}
    if "TEARDOWN_CUPTI" in os.environ:
        raise SystemExit("TEARDOWN_CUPTI is set: the legs set it themselves")
    for _ in range(32):
        step()
    state["loss"].item()
    rates = {"never": [window() for _ in range(3)]}
    rates.update({leg: [] for leg in legs})
    capture(None)
    names = list(legs)
    for i in range(args.rounds):
        for leg in names[i % 3:] + names[:i % 3]:
            capture(legs[leg])
            rates[leg].append(window())
    out = {"device": torch.cuda.get_device_name(0), "steps_per_sec": rates,
           "median": {leg: statistics.median(r) for leg, r in rates.items()}}
    for leg in ("engine", "kept"):
        ratio = [a / t for a, t in zip(rates[leg], rates["torn"])]
        out[f"{leg}_over_torn"] = ratio
        out[f"{leg}_over_torn_median"] = statistics.median(ratio)
        out[f"{leg}_slower_rounds"] = sum(r < 1.0 for r in ratio)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
