"""Where a train step's time goes on the card.

    python -m tpumon_torch.loadgen.profile [--steps 50] [--trace PATH]

Runs 20 warm-up steps of the runner's bench train step (batch 8, the
runner's own :func:`..run.workload`), times ``--steps`` steps on the host
clock around synchronized work, then runs as many again under
``torch.profiler`` (CUDA activity), timed the same way.  Prints the device
kernels by total device time, then one JSON line: the step's wall time
unprofiled and profiled, the device time of the step's kernels, the
flash kernels' share of it, and the device's idle share twice:

* ``device_idle_share``: 1 - device time / wall time, both over the
  profiled steps.  The profiler's own host cost (a callback on each of
  about 300 launches a step) lengthens the host-bound step, so this
  share overstates the idle time of an unprofiled run;
* ``device_idle_share_unprofiled``: 1 - device time per step / wall time
  per step of the unprofiled steps.  Kernel durations do not depend on
  the host's pace, so this is the unprofiled run's share, as long as the
  two windows run the same steps.

Neither is clamped: a negative share means a wrong count.  ``--trace``
also writes the Chrome trace.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

#: enough warm-up steps for the caching allocator and the matmul
#: heuristics to settle
WARMUP_STEPS = 20


def device_us(evt) -> float:
    """Self device time (µs) of one profiler event average, under either
    of the names torch has given it."""

    for attr in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(evt, attr, None)
        if v is not None:
            return float(v)
    return 0.0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="tpumon-torch-profile",
                                description=__doc__)
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--trace", default=None,
                   help="write the Chrome trace of the window here")
    args = p.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    from ..trace import profiler_session
    from . import model as M
    from .run import DEFAULT_BATCH, resolve_device, workload

    device = resolve_device("cuda")
    cfg, params, tokens = workload("bench", DEFAULT_BATCH, device)
    for _ in range(WARMUP_STEPS):
        params, loss = M.train_step(cfg, params, tokens)
    loss.item()

    t0 = time.perf_counter()
    for _ in range(args.steps):
        params, loss = M.train_step(cfg, params, tokens)
    loss.item()
    wall_s = time.perf_counter() - t0
    with profiler_session(), \
            profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            params, loss = M.train_step(cfg, params, tokens)
        loss.item()
        prof_wall_s = time.perf_counter() - t0
    if args.trace:
        prof.export_chrome_trace(args.trace)

    kernels = {}
    for evt in prof.key_averages():
        us = device_us(evt)
        if us > 0 and evt.device_type == torch.autograd.DeviceType.CUDA:
            kernels[evt.key] = (us, evt.count)
    busy_us = sum(us for us, _ in kernels.values())
    flash_us = sum(us for name, (us, _) in kernels.items()
                   if "flash_" in name and "_kernel" in name)
    rows = sorted(kernels.items(), key=lambda kv: -kv[1][0])
    for name, (us, count) in rows[:15]:
        print(f"{us / args.steps:10.1f} us/step  {count // args.steps:4d}/step"
              f"  {name[:90]}")
    step_ms = wall_s * 1e3 / args.steps
    print(json.dumps({
        "batch": DEFAULT_BATCH,
        "steps": args.steps,
        "device": torch.cuda.get_device_name(device),
        "step_ms": step_ms,
        "profiled_step_ms": prof_wall_s * 1e3 / args.steps,
        "device_busy_ms_per_step": busy_us / 1e3 / args.steps,
        "device_idle_share": 1.0 - busy_us / 1e6 / prof_wall_s,
        "device_idle_share_unprofiled": 1.0 - busy_us / 1e6 / wall_s,
        "flash_ms_per_step": flash_us / 1e3 / args.steps,
        "flash_share_of_device": flash_us / busy_us if busy_us else None,
        "kernels_per_step": sum(c for _, c in kernels.values()) / args.steps,
        "matmul_tflops_per_s": (M.train_step_dot_flops(cfg, DEFAULT_BATCH)
                                / (step_ms / 1e3) / 1e12),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
