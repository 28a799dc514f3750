"""Load-generator runner: step the model on the card while being monitored.

Counterpart of ``tpumon/loadgen/run.py``, every pattern of it: the train
step, the single-device shapes (``mxu``, ``hbm``, ``mixed``, ``flash``,
``conv``) and the multi-device ones over ``torch.distributed``
(``ringattn``, ``allreduce``, ``dcn``, ``pp``, ``moe``):

* generate device load (``python -m tpumon_torch.loadgen.run --seconds 30
  [--pattern P]``);
* demonstrate the *embedded* monitoring mode — with ``--self-monitor`` the
  workload process samples its own CUDA device through the port's backend
  and exporter at 1 Hz, optionally writing a textfile
  (``--monitor-output``) another process can consume.

Runs on ``cuda`` unless ``--device cpu`` is given; without CUDA and
without ``--device cpu`` it fails rather than run on the CPU.  A
multi-device pattern joins a process group first: with ``--coordinator
HOST:PORT --num-processes N --process-id R`` one process per rank (NCCL
on ``cuda``, one card a rank; gloo on the CPU), else a 1-rank group in
this process, where every neighbour hop is the identity.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

#: the bench run's batch
DEFAULT_BATCH = 8

#: load shapes of the reference runner
PATTERNS = ("train", "mxu", "hbm", "mixed", "flash", "conv", "ringattn",
            "allreduce", "dcn", "pp", "moe")
#: the ones that run over a process group
MULTI = PATTERNS[6:]


def capture_step_cost(blocks, spans, t0: float, t1: float):
    """Within-run direct estimator of the profiler-capture step cost.

    ``blocks``: (start, end, n_steps) intervals of EXECUTED work, one per
    ``--sync-every`` barrier.  ``spans``: capture (open, done) intervals.
    Each block's steps are apportioned to capture/non-capture time by
    overlap fraction, then the two step rates are compared within the
    SAME process.  Returns (cost_pct, overlap_s): cost_pct is
    100*(1 - rate_in/rate_out), None when the window contains no usable
    capture overlap.
    """

    clipped = [(max(s, t0), min(e, t1)) for s, e in spans
               if e > t0 and s < t1]
    overlap = sum(e - s for s, e in clipped)
    total = t1 - t0
    out_time = total - overlap
    # an estimate needs enough of BOTH regimes to rate (floors keep a
    # 50 ms sliver from minting a wild ratio)
    if overlap < 0.5 or out_time < 0.5:
        return None, round(overlap, 3)
    steps_in = 0.0
    steps_total = 0.0
    n_blocks = 0
    for bs, be, n in blocks:
        bs, be = max(bs, t0), min(be, t1)
        if be <= bs or n <= 0:
            continue
        ov = sum(max(0.0, min(be, e) - max(bs, s)) for s, e in clipped)
        steps_in += n * (ov / (be - bs))
        steps_total += n
        n_blocks += 1
    # granularity floor: apportioning a handful of coarse blocks makes
    # rate_in converge on rate_out by construction and would mint a
    # confident 0% — no estimate beats a fabricated one
    if steps_total < 10 or n_blocks < 10:
        return None, round(overlap, 3)
    rate_in = steps_in / overlap
    rate_out = (steps_total - steps_in) / out_time
    if rate_out <= 0:
        return None, round(overlap, 3)
    return round(100.0 * (1.0 - rate_in / rate_out), 1), round(overlap, 3)


def monitor_cost(cost0: dict, cost1: dict, sweep_s: float, elapsed: float,
                 blocks, spans, t0: float) -> dict:
    """The runner's ``monitor_cost`` entry: what the monitor cost the
    measured window, from the trace engine's cost counters at its start
    (``cost0``) and end (``cost1``), the inline sweeps' wall time and the
    executed-work ``blocks`` against the capture ``spans``."""

    cost_pct, overlap_s = capture_step_cost(blocks, spans, t0, t0 + elapsed)
    return {
        # inline sweep wall time subtracts 1:1 from stepping
        "sweep_s": round(sweep_s, 3),
        "sweep_pct_of_window": round(100.0 * sweep_s / max(elapsed, 1e-9),
                                     2),
        "captures_in_window": int(
            cost1.get("captures_ok", 0.0) + cost1.get("captures_failed", 0.0)
            - cost0.get("captures_ok", 0.0)
            - cost0.get("captures_failed", 0.0)),
        "capture_wall_s": round(cost1.get("capture_wall_s", 0.0)
                                - cost0.get("capture_wall_s", 0.0), 3),
        "capture_parse_s": round(cost1.get("capture_parse_s", 0.0)
                                 - cost0.get("capture_parse_s", 0.0), 3),
        # the duty-capped steady state: per-capture cost over the
        # stretched cadence, whether or not a capture landed in the window
        "steady_capture_duty_pct": (round(
            100.0 * cost1["capture_cost_ewma_s"]
            / cost1["effective_interval_s"], 2)
            if cost1.get("capture_cost_ewma_s", -1.0) > 0 and
            cost1.get("effective_interval_s", 0.0) > 0 else None),
        # where the adaptive window settled
        "capture_window_ms": round(cost1.get("capture_window_ms", 0.0), 1)
        or None,
        # a warm-up capture still in flight books its cost in the window
        "capture_inflight_at_window_start": bool(cost0.get("capturing")),
        # step rate inside capture spans against outside, same process
        "capture_step_cost_pct": cost_pct,
        "capture_overlap_s": overlap_s,
    }


def resolve_device(name: str):
    """``cuda`` (or ``cuda:N``) or ``cpu``; CUDA must exist when asked
    for — the runner never carries on quietly on the CPU."""

    import torch

    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass --device cpu to run "
                           "on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise RuntimeError(f"unsupported device {name!r} (cuda or cpu)")
    return dev


def workload(size: str, batch: int, device):
    """The model config, its seeded parameters and one fixed token batch
    on ``device``: what every step of the run trains on."""

    import torch

    from . import model as M

    cfg = M.ModelConfig.tiny() if size == "tiny" else M.ModelConfig.bench()
    params = M.init_params(torch.Generator(device).manual_seed(0), cfg)
    tokens = torch.randint(0, cfg.vocab, (batch, cfg.seq_len),
                           generator=torch.Generator(device).manual_seed(1),
                           device=device)
    return cfg, params, tokens


def tensor_leaves(state):
    """The tensors of a pattern's state: a tensor, or tuples of tensors
    and plain values (the ``mixed`` pattern's step counter)."""

    import torch

    if isinstance(state, torch.Tensor):
        yield state
    elif isinstance(state, (tuple, list)):
        for part in state:
            yield from tensor_leaves(part)


def multi_pattern(pattern: str, device, slices: int = 2):
    """(step_fn, state, slice count) of a multi-device pattern over the
    process group this process has joined (the reference runner's
    dispatch, ``tpumon/loadgen/run.py:140-162``); ``slices`` is the
    ``dcn`` pattern's slice count, cut to the ranks there are (1 for the
    other patterns)."""

    import torch.distributed as dist

    from . import parallel as PP
    from . import ring as R

    if pattern == "pp":
        return (*PP.pipeline_load(device=device), 1)
    if pattern == "moe":
        return (*PP.moe_alltoall_load(device=device), 1)
    if pattern == "ringattn":
        return (*R.make_ring_attention_pattern(device=device), 1)
    if pattern == "dcn":
        n_dev = dist.get_world_size()
        n_slices = max(1, min(slices, n_dev))
        ms = R.make_multislice_mesh(n_slices)
        used = n_slices * ms.chips
        if used < n_dev:
            print(f"warning: {n_dev} ranks not divisible by {n_slices} "
                  f"slices; {n_dev - used} ranks idle", file=sys.stderr)
        return (*R.dcn_allreduce_load(ms, device=device), n_slices)
    if pattern == "allreduce":
        return (*R.ring_allreduce_load(R.make_seq_mesh(axis="data"),
                                       device=device), 1)
    raise ValueError(f"unknown multi-device pattern {pattern!r}")


class Workload:
    """What the runner steps: the bench train step (a
    :class:`.graph.GraphStep` on a CUDA device, :func:`.model.train_step`
    on the CPU) or a load pattern (:func:`.kernels.make_pattern`,
    :func:`multi_pattern`), with a barrier that drains the steps in
    flight."""

    def __init__(self, pattern: str, size: str = "bench",
                 batch: int = DEFAULT_BATCH, device=None,
                 slices: int = 2) -> None:
        from . import kernels as K

        self.pattern = pattern
        self.device = device
        self.loss = None
        #: the train step's CUDA graph (None eager or for a pattern)
        self.graph = None
        #: the job's slice count (the ``dcn`` pattern's; 1 otherwise)
        self.slices = 1
        if pattern in MULTI:
            self._step, self.state, self.slices = multi_pattern(
                pattern, device, slices)
        elif pattern == "train":
            from . import model as M
            from .graph import GraphStep

            cfg, params, tokens = workload(size, batch, device)
            if tokens.device.type == "cuda":
                self.graph = GraphStep(cfg, params, tokens)
                self._train = self.graph.step
            else:
                self._train = lambda: M.train_step(cfg, params, tokens)
        else:
            self._step, self.state = K.make_pattern(pattern, device=device)

    def step(self) -> None:
        if self.pattern == "train":
            _, self.loss = self._train()
        else:
            self.state = self._step(self.state)

    def sync(self) -> None:
        """A host-visible barrier.  Train: a scalar read of the loss, whose
        step N depends on every prior step's parameters; a pattern: one
        scalar read from each tensor of the state (the mixed pattern
        writes its two tensors in turn)."""

        if self.pattern == "train":
            self.loss.item()
        else:
            for leaf in tensor_leaves(self.state):
                leaf.reshape(-1)[0].item()

    def final_loss(self):
        return self.loss.item() if self.loss is not None else None


def _group_size() -> int:
    """Ranks of the process group this process has joined (1 without
    one)."""

    import torch.distributed as dist

    return dist.get_world_size() if dist.is_initialized() else 1


def _agree(flag: bool, device) -> bool:
    """True on every rank once any rank's ``flag`` is True (an all-reduce
    of the largest)."""

    import torch
    import torch.distributed as dist

    from .. import collectives as C

    t = torch.tensor([float(flag)], device=device)
    with C.group_scope(dist.get_world_size()):
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


def run_window(work: Workload, seconds: float, sync_every: int = 32,
               self_monitor: bool = False, monitor_output=None,
               device_name: str = "cpu", final_capture: bool = True
               ) -> dict:
    """Step ``work`` for ``seconds`` and return the runner's JSON result.
    With ``self_monitor`` the process samples its own CUDA device through
    the port's backend and exporter at 1 Hz while stepping, started for
    this window (after a warm-up of its own: probe calibration, a sweep, a
    forced trace capture) and shut down after it, after a last sweep
    whose non-blank families the result counts; ``final_capture`` forces
    a fresh capture before that sweep, so the count does not depend on
    whether a capture landed in the window (the paired bench's windows
    skip it: the warm-up's sample is still fresh, and only the window's
    steps/s are compared).  A job of more than one slice registers its
    slice axis with the backend, so the DCN families are measured.

    In a process group of more ranks, every rank must step the same
    count, or one waits forever in a collective its peers never call: the
    window then ends where the ranks agree (an all-reduce of "my time is
    up" at each sync point), and the forced captures, which step each
    rank until its own window closes, are skipped."""

    lockstep = _group_size() > 1
    if lockstep:
        final_capture = False
    exporter = None
    h = None
    monitor_samples = 0
    note_step = lambda: None  # noqa: E731
    if self_monitor:
        import tpumon_torch
        from tpumon_torch.exporter.exporter import TpuExporter
        if (work.graph is not None and
                os.environ.get("TPUMON_CUDA_TRACE", "1") != "0"):
            # what a replay runs, for the trace engine (once a process)
            work.graph.describe()
        h = tpumon_torch.init(backend_name="cuda")
        if work.slices > 1:
            h.backend.set_slice_axis(work.slices)
        # profiling=True: the utilization/step-time families are what the
        # embedded path measures; dcn=True reads blank on one host and the
        # renderer omits blank families
        exporter = TpuExporter(h, interval_ms=1000, profiling=True,
                               dcn=True, output_path=monitor_output)
        # feed real step boundaries to the backend: PROF_STEP_TIME then
        # reports the workload's own EWMA, not a probe proxy
        backend_note = getattr(h.backend, "note_step", None)
        if callable(backend_note):
            note_step = backend_note

    def capture_while_stepping() -> bool:
        """One forced trace capture while THIS thread keeps stepping: the
        session records the ops of the thread that opens it, so the
        capture opens here and the steps run inside its window."""

        extra = 0

        def one_step() -> None:
            nonlocal extra
            work.step()
            note_step()
            extra += 1
            if sync_every > 0 and extra % sync_every == 0:
                work.sync()

        if lockstep:
            return False
        ok = h.backend.force_trace_capture(timeout_s=30.0, step=one_step)
        work.sync()
        return ok

    def time_is_up(now: float) -> bool:
        if not lockstep:
            return now - t0 >= seconds
        return _agree(now - t0 >= seconds, work.device)

    # first step outside the timed loop; the probes calibrate here too,
    # so the measured window pays sweep cost, not set-up cost
    work.step()
    work.sync()
    if exporter is not None:
        warmup = getattr(h.backend, "warmup_probes", None)
        if callable(warmup):
            warmup(0)
        exporter.sweep()
        # absorb the FIRST trace capture into warm-up: it pays the
        # profiler's one-time initialization, and the window should
        # measure the steady state (in-window captures stay recorded in
        # monitor_cost)
        capture_while_stepping()

    def trace_cost():
        return (h.backend.trace_cost_stats() or {}) \
            if exporter is not None else {}

    steps = 0
    sweep_s = 0.0          # wall spent inside inline sweeps (hot loop)
    blocks = []            # (start, end, n_steps) executed-work blocks
    #                        between sync barriers, for the within-run
    #                        capture-step-cost estimator
    cost0 = trace_cost()   # capture-cost counters at window start
    t0 = time.monotonic()
    next_sample = t0
    block_start, block_steps = t0, 0
    check_every = max(1, sync_every) if lockstep else 1
    while steps % check_every or not time_is_up(time.monotonic()):
        work.step()
        note_step()
        steps += 1
        block_steps += 1
        if sync_every > 0 and steps % sync_every == 0:
            work.sync()
            if exporter is not None:
                now = time.monotonic()
                blocks.append((block_start, now, block_steps))
                block_start, block_steps = now, 0
        if exporter is not None and time.monotonic() >= next_sample:
            s0 = time.monotonic()
            exporter.sweep()
            sweep_s += time.monotonic() - s0
            monitor_samples += 1
            next_sample += 1.0
    work.sync()  # drain the (bounded) in-flight tail before timing stops
    elapsed = time.monotonic() - t0
    if exporter is not None and block_steps:
        blocks.append((block_start, time.monotonic(), block_steps))
    # snapshot BEFORE the forced end-of-run capture: only in-window cost
    # may be attributed to the measured steps/sec
    cost1 = trace_cost()
    win_spans = (h.backend.trace_capture_spans()
                 if exporter is not None else [])

    family_stats = None
    if exporter is not None:
        import tpumon_torch
        from tpumon_torch.exporter.promtext import parse_families
        try:
            # one FRESH forced capture while load still runs, so the
            # non-blank family count does not depend on whether a
            # periodic capture landed in the window
            captured = capture_while_stepping() if final_capture else None
            # one final sweep: which families carry REAL (non-blank)
            # samples on this device?
            counts = parse_families(exporter.sweep())
            # every capture of the run, the warm-up's and the final one
            # included: landed, and refused (a lost-records capture)
            run_cost = trace_cost()
            capture_error = h.backend.trace_last_error()
            attribution = h.backend.attribution_stats()
        finally:
            tpumon_torch.shutdown()
        nonblank = sorted(k for k, v in counts.items()
                          if k.startswith("tpu_") and v > 0)
        family_stats = {"families_nonblank": len(nonblank),
                        "families": nonblank,
                        "capture_forced": captured,
                        "captures_ok": int(run_cost.get("captures_ok", 0)),
                        "captures_failed": int(
                            run_cost.get("captures_failed", 0)),
                        "capture_last_error": capture_error,
                        "attribution": attribution,
                        "monitor_cost": monitor_cost(
                            cost0, cost1, sweep_s, elapsed, blocks,
                            win_spans, t0)}

    result = {
        "pattern": work.pattern,
        "steps": steps,
        "seconds": round(elapsed, 3),
        "steps_per_sec": round(steps / max(elapsed, 1e-9), 3),
        "final_loss": work.final_loss(),
        "monitor_sweeps": monitor_samples,
        "device": device_name,
    }
    if family_stats is not None:
        result.update(family_stats)
    return result


def device_name(device) -> str:
    import torch

    return (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="tpumon-torch-loadgen",
                                description=__doc__)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--size", choices=("tiny", "bench"), default="bench")
    p.add_argument("--batch", type=int, default=DEFAULT_BATCH)
    p.add_argument("--pattern", choices=PATTERNS, default="train",
                   help="load shape: transformer training steps; a kernel "
                        "pinning tensor-core duty / device-memory bandwidth "
                        "/ the two alternating; causal flash attention "
                        "forward; a CNN forward (conv2d); ring attention "
                        "(sequence-parallel K/V rotation by P2P); a "
                        "sustained all-reduce; hierarchical multi-slice "
                        "gradient sync (reduce-scatter, all-reduce across "
                        "slices, all-gather); a GPipe-style stage pipeline "
                        "(a neighbour hop a tick); or MoE expert "
                        "dispatch/combine (all-to-all)")
    p.add_argument("--slices", type=int, default=2,
                   help="slice count for --pattern dcn (outer group axis)")
    p.add_argument("--sync-every", type=int, default=32,
                   help="force a host-visible sync every N steps; bounds "
                        "the async launch backlog and makes steps/sec an "
                        "executed-work rate, not an enqueue rate")
    p.add_argument("--self-monitor", action="store_true",
                   help="sample own CUDA metrics at 1 Hz while stepping")
    p.add_argument("--monitor-output", default=None,
                   help="textfile path for self-monitor sweeps")
    p.add_argument("--json", action="store_true",
                   help="print a JSON result line at the end")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda; cpu only "
                        "when asked for)")
    p.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                   help="process-group rendezvous: run one loadgen process "
                        "per rank (one card a rank; gloo ranks with "
                        "--device cpu) and the multi-device patterns span "
                        "all of them")
    p.add_argument("--num-processes", type=int, default=None,
                   help="total loadgen processes (with --coordinator)")
    p.add_argument("--process-id", type=int, default=None,
                   help="this process's rank (with --coordinator)")
    args = p.parse_args(argv)
    if args.coordinator and (args.num_processes is None
                             or args.process_id is None):
        p.error("--coordinator requires --num-processes and --process-id")
    grouped = args.pattern in MULTI
    if args.coordinator and not grouped:
        p.error(f"--coordinator: --pattern {args.pattern} runs on one "
                f"device (the multi-device patterns: {', '.join(MULTI)})")

    device = resolve_device(args.device)
    if grouped:
        import torch.distributed as dist

        from .ring import init_process_group
        device = init_process_group(device, args.coordinator,
                                    args.num_processes, args.process_id)
    try:
        work = Workload(args.pattern, args.size, args.batch, device,
                        args.slices)
        result = run_window(work, args.seconds, args.sync_every,
                            args.self_monitor, args.monitor_output,
                            device_name(device))
    finally:
        if grouped:
            dist.destroy_process_group()
    from . import kernels as K
    # the process's kernel launches (its graph's replays counted): what a
    # caller in another process reads to see the path ran the kernels
    result["launches"] = dict(K.LAUNCHES)
    if args.json:
        print(json.dumps(result))
    else:
        final_loss = result["final_loss"]
        loss_txt = (f", loss {final_loss:.3f}"
                    if final_loss is not None and math.isfinite(final_loss)
                    else "")
        print(f"[{args.pattern}] {result['steps']} steps in "
              f"{result['seconds']:.1f}s ({result['steps_per_sec']:.2f}/s)"
              f"{loss_txt}, {result['monitor_sweeps']} monitor sweeps on "
              f"{result['device']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
