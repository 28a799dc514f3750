"""Where a train step's time goes on the card: the eager step beside the
CUDA graph step, in one process.

    python -m tpumon_torch.loadgen.profile [--steps 50] [--trace PATH]

For each of the eager bench train step (:func:`.model.train_step`) and
its CUDA graph (:class:`.graph.GraphStep`), each on its own copy of the
runner's workload (batch 8, :func:`..run.workload`): 20 warm-up steps,
``--steps`` steps timed on the host clock around synchronized work (a
scalar read every 32 steps, as the runner's), then as many again under
``torch.profiler`` (CUDA activity, closed with CUPTI torn down as the
trace engine closes), timed the same way.  Prints each step's device
records by total device time, then one JSON line with, for ``eager`` and
``graph``: the step's wall time unprofiled and profiled, the device time
of its kernels, memory copies and fills, the flash kernels' share of
it, the records a step and the device's idle share twice:

* ``device_idle_share``: 1 - device time / wall time, both over the
  profiled steps.  The profiler's own host cost lengthens a host-bound
  step, so this share overstates the idle time of an unprofiled run;
* ``device_idle_share_unprofiled``: 1 - device time per step / wall time
  per step of the unprofiled steps.  Kernel durations do not depend on
  the host's pace, so this is the unprofiled run's share, as long as the
  two windows run the same steps.

Neither is clamped: a negative share means a wrong count.  ``--trace``
also writes the graph window's Chrome trace.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

#: enough warm-up steps for the caching allocator and the matmul
#: heuristics to settle
WARMUP_STEPS = 20
#: a scalar read every this many steps, as the runner's
SYNC_EVERY = 32


def device_us(evt) -> float:
    """Self device time (µs) of one profiler event average, under either
    of the names torch has given it."""

    for attr in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(evt, attr, None)
        if v is not None:
            return float(v)
    return 0.0


def measure(step, steps: int, trace_path=None) -> dict:
    """Warm ``step`` (returns (params, loss)) up, time ``steps`` steps
    bare and ``steps`` under the profiler; the line's entry for it."""

    import torch
    from torch.profiler import ProfilerActivity, profile

    from ..trace import close_session, profiler_session

    def run() -> float:
        t0 = time.perf_counter()
        for i in range(steps):
            _, loss = step()
            if i % SYNC_EVERY == SYNC_EVERY - 1:
                loss.item()
        loss.item()
        return time.perf_counter() - t0

    for _ in range(WARMUP_STEPS):
        _, loss = step()
    loss.item()
    wall_s = run()
    with profiler_session():
        prof = profile(activities=[ProfilerActivity.CUDA])
        prof.start()
        try:
            prof_wall_s = run()
        finally:
            result = close_session(prof)
    if trace_path:
        prof.export_chrome_trace(trace_path)
    cuda = torch.autograd.DeviceType.CUDA
    records = {}
    for e in result.events():
        if e.device_type() == cuda:
            us, n = records.get(e.name(), (0.0, 0))
            records[e.name()] = (us + e.duration_ns() / 1e3, n + 1)
    busy_us = sum(us for us, _ in records.values())
    flash_us = sum(us for name, (us, _) in records.items()
                   if "flash_" in name and "_kernel" in name)
    rows = sorted(records.items(), key=lambda kv: -kv[1][0])
    for name, (us, count) in rows[:15]:
        print(f"{us / steps:10.1f} us/step  {count / steps:6.2f}/step"
              f"  {name[:90]}")
    return {
        "step_ms": wall_s * 1e3 / steps,
        "profiled_step_ms": prof_wall_s * 1e3 / steps,
        "device_busy_ms_per_step": busy_us / 1e3 / steps,
        "device_idle_share": 1.0 - busy_us / 1e6 / prof_wall_s,
        "device_idle_share_unprofiled": 1.0 - busy_us / 1e6 / wall_s,
        "flash_ms_per_step": flash_us / 1e3 / steps,
        "flash_share_of_device": flash_us / busy_us if busy_us else None,
        "kernels_per_step": sum(c for _, c in records.values()) / steps,
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="tpumon-torch-profile",
                                description=__doc__)
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--trace", default=None,
                   help="write the Chrome trace of the graph window here")
    args = p.parse_args(argv)

    import torch

    from . import model as M
    from .graph import GraphStep
    from .run import DEFAULT_BATCH, resolve_device, workload

    device = resolve_device("cuda")
    cfg, params, tokens = workload("bench", DEFAULT_BATCH, device)
    out = {"batch": DEFAULT_BATCH, "steps": args.steps,
           "device": torch.cuda.get_device_name(device),
           "nvidia_smi": subprocess.run(
               ["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"], capture_output=True, text=True,
               timeout=60).stdout.strip()}
    print("eager:")
    out["eager"] = measure(lambda: M.train_step(cfg, params, tokens),
                           args.steps)
    cfg, params, tokens = workload("bench", DEFAULT_BATCH, device)
    g = GraphStep(cfg, params, tokens)
    print("graph:")
    out["graph"] = measure(g.step, args.steps, args.trace)
    flops = M.train_step_dot_flops(cfg, DEFAULT_BATCH)
    for side in ("eager", "graph"):
        out[side]["matmul_tflops_per_s"] = (
            flops / (out[side]["step_ms"] / 1e3) / 1e12)
    out["graph_over_eager_step"] = (out["graph"]["step_ms"]
                                    / out["eager"]["step_ms"])
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
