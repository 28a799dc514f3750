#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

1. Prints the card's name and power limit (``nvidia-smi``) and builds the
   port's CUDA kernels from ``tpumon_torch/csrc`` (one ``nvcc`` per source,
   all started together, at first use), and beside them with ``g++`` the
   native agent, its C client, and the codec and poll engine extensions
   (``_build.native()``; their paths and build seconds printed).
   The port's analysis planes start first and run beside the builds,
   each in a process of its own on this tree: ``python -m
   tpumon_torch.tools.tpumon_lint`` and ``python -m
   tpumon_torch.tools.tpumon_check --baseline
   tpumon_torch/tools/check_baseline.json``.  The ``analysis:`` line gives
   each tool's exit code, findings, pragmas and seconds, the built codec
   extension's exported constants held to the Python declarations
   (``codec_pins``), and the card's name and power limit; a finding, a
   baseline drift or a drifted constant fails the smoke.
   Then the out-of-band NVML source (``tpumon_torch.backends.nvml``), one
   line each: ``nvml abi`` compiles the backend's ABI probe against the
   toolkit's ``nvml.h`` and holds every mirrored struct's size and field
   offsets and every constant to the ctypes mirrors'; ``nvml check``
   opens the backend on the device torch calls ``cuda:0`` (matched by
   UUID) and holds it to one ``nvidia-smi -i <uuid>`` row (strings equal,
   power limit within 1 W, temperature within 2 C, clocks within 5%,
   memory total equal and used within 64 MiB, power draw within
   max(15 W, 10%)), and counts the exporter's families one sweep fills
   (at least 20); ``nvml cost`` is ``loadgen.bench_gpu``'s 1 Hz tier: the
   exporter's field list swept at 1 Hz for 20 s on the idle card (each
   sweep's wall ms, the process's CPU share, the wall ms a sweep spends
   in each NVML entry point); ``nvml load`` reads utilization under the ``mxu`` pattern
   (>= 50, and <= 20 idle) beside the trace engine's duty, a 1 GiB
   allocation in HBM used (>= 900 MiB more) and the energy counter's
   mean power against the power reads' mean (within 15%).
2. Holds each flash-attention kernel (forward, dQ, dK/dV) against its
   plain PyTorch version at the bench shapes (B*H=64, D=128, bf16): causal
   at S=255 padded to 256, as the model's loss runs it, and non-causal at
   S=256.  Tolerance (``kernels.plain_excess``): every element within 2%
   of its own magnitude plus 16 bf16 epsilons of the output's RMS (the
   kernels round p and dS to bf16 between their two tile products; the
   plain versions stay in f32).  The same check must fail planted faults
   built from the kernels' outputs (the last key tile skipped).  Times the
   kernel, the plain version and ``scaled_dot_product_attention``
   (forward, and backward for the two gradient kernels) as the library
   yardstick, which the port never calls.  The forward kernel's wrapper is
   held and timed again at the ``flash`` pattern's card shape and at the
   reference's (B*H=4, S=1024, causal); the dQ and dK/dV kernels at
   (B*H=64, S=1024, D=128, causal), whose loops run up to 16 tiles where
   the bench shape's run 4, beside SDPA's backward there.
3. Holds the load-shaping kernels against their plain versions at the
   patterns' shapes: ``hbm_stream`` bit for bit (f32, and a planted
   (256, 1024) block left unwritten must fail), at the card's ``hbm``
   shape and at the reference's (2048, 4096); ``mxu_burn`` (T=256,
   iters=64, the pattern's number of tiles) on bounded inputs, x random
   normal and w a random orthogonal matrix, within ``kernels.mxu_excess``
   (every element within one bf16 ulp of itself plus 8 * sqrt(iters) bf16
   unit roundoffs of the output's RMS: the two chains sum in different
   orders and part by rounding flips that later steps carry), which the
   chain run one step short must fail.  Library yardsticks: one call of
   the stream's function, ``torch.add(c, x, alpha=1.0001)`` (``copy_`` of
   the same bytes beside it), and the chained bf16 ``torch.matmul``.
4. Holds ``flash_attention`` forward and backward, the model's entry to
   the kernels, against dense f32 attention at the bench shape (same
   tolerance), and one bench train step with flash against one of the
   dense model: the q, k, v and o projections' updates (relative
   Frobenius error at most ``UPDATE_RTOL``) and the loss (rtol 2e-2, the
   JAX package's own check).  ``graph check``: the bench train step as a
   CUDA graph (``loadgen.graph.GraphStep``, what the runner steps on the
   card) against the eager step from the same parameters, 5 steps each
   after the graph's warm-up: every loss within rtol 2e-2, the q, k, v
   and o updates within ``UPDATE_RTOL``, no growth of allocated memory
   over the replays; each step's wall ms beside the other's.  The graph
   step's fused update (``sgd_update``, ``tpumon_torch/csrc/sgd_update.cu``,
   the port's own kernel) is held bit for bit to its plain version and to
   the unfused update (``model._sgd``, then the cast) at the bench model's
   leaves, a planted stale element must fail, and it is timed beside its
   byte bound and the five-op chain it replaced.
5. Drives each main path in-process with the launch counts set to 0 just
   before it and read just after: ``tpumon_torch.loadgen.run --size bench
   --self-monitor --seconds 3`` (the graph step; fails unless the loss is
   finite) and ``--pattern P --self-monitor --seconds 2`` for each of mxu, hbm, mixed,
   flash and conv, then ``--seconds 6`` for each multi-device pattern
   (ringattn, allreduce, dcn, pp, moe) in a 1-rank NCCL group.  Each fails
   unless steps ran, the HBM families (used and total) were non-blank,
   the path's kernels launched and the runner's forced trace capture
   landed; the train run also unless the trace-only families (achieved
   TFLOP/s, MFU, vector active) were non-blank; a multi-device one also
   unless its final capture read NCCL's events (allreduce, dcn, moe; at
   one rank ringattn's and pp's hops are the identity and call none) and
   attributed 0 ICI bytes to them, served as ``tpu_ici_tx_throughput``.
   ``multi``: those runs' steps/s, collective events and ICI bytes; ring
   attention at the ringattn pattern's shape against the dense oracle on
   the card (``RING_BF16_TOL``, and ``RING_F32_TOL`` in f32); the NCCL
   version; and whether NCCL takes two ranks on the one card (two
   processes, one all-reduce: it refuses a duplicate GPU).
   ``sharded``: the bench config's dp x tp train step
   (``model.sharded_train_step``) over a 1-rank NCCL group, driven as a
   main path (the launch counts set to 0 just before its first step and
   read just after), against ``train_step`` from the same parameters and
   tokens, both eager: the loss within rtol 2e-2, the q, k, v and o
   updates within ``UPDATE_RTOL``, B1-B3 launched; each eager step's
   wall ms beside the other's and the NCCL version.  Then the harness
   entry points (``tpumon_torch.entry``): ``entry()``'s logits finite
   and (4, 32, 128) on the card, ``dryrun_multichip(1)`` passing on the
   card (one NCCL rank process) and ``dryrun_multichip(2)`` refused (one
   card: NCCL runs one rank a card).
6. The metric-semantics check (the reference's
   ``tests/test_real_tpu_semantics.py``) on the port's ``CudaBackend``,
   with the ``mxu`` pattern as the load on a worker thread and the trace
   engine at a 0.5 s cadence (``TPUMON_CUDA_TRACE_INTERVAL``, the duty
   cap off) serving duty: idle utilization (the least of three reads, as after the load)
   <= 20, busy >= 50 and more than idle + 30, a 1 GiB allocation seen as
   >= 900 MiB more HBM used, the not-idle clock <= 5 s under load,
   utilization after the load (the least of three reads) <= 25, read
   once a trace capture opened after the device went quiet has landed
   (at most 20 reads; the wait is printed as ``settle_s``).  Only the
   ordering is asserted.
7. The trace check (the reference's ``:108-186``, ``:213-357``): 800 ms
   captures of an on-demand ``TraceEngine``, each taken once.  Idle duty
   <= 0.05; under the ``mxu`` pattern on a worker thread duty >= 0.8,
   mxu share >= 0.9 of it, records counted and the capability table's
   peak; under ``hbm`` duty >= 0.8 and an mxu share <= 0.1, at least 0.5
   below the ``mxu`` one; under ``conv`` (stepped on the session's
   thread) duty > 0.15 and mxu above vector; the bench train step's
   graph replayed on the session's thread (its program recorded by
   ``GraphStep.describe``) with exact categories, an mxu share above 0.05
   of the window (the reference's bar) and its measured mxu-category
   FLOPs per step within [0.5, 1.6] of ``train_step_dot_flops`` (the
   attention products run in the port's kernels, which count no FLOPs:
   about 0.95); 0 failed captures; then 10 captures of 100 ms over the
   replays, each by a new engine, each closed with CUPTI torn down: every
   one must land and read the replays exactly.  ``bench gpu``: the paired
   protocol (``loadgen.bench_gpu``), 4 pairs on the train cell (2 s
   windows) and on the ``mxu`` pattern (1 s): the verdict records, with
   every ``OVERHEAD_RECORD_KEYS`` key.
8. ``daemon``: the exporter daemon as the DaemonSet deploys it
   (``python -m tpumon_torch.exporter.main -d 1000 --port P --pod-labels
   --merge-textfile``, over NVML, pod labels from a map file keyed by the
   card's NVML UUID) beside the self-monitored bench train run in its own
   process, which publishes its drop file to tmpfs; 30 scrapes at 1 Hz,
   plain and gzip in turn, each held to the exposition's rules (every
   line valid, no series twice, the drop file's own families served, at
   least 20 NVML families with the pod's labels), ``/healthz`` 200 from
   the first sweep on, no CUDA context in the daemon, SIGTERM to a whole
   textfile; then its footprint at ``-d 100`` and ``-d 1000`` and the
   split layout's pod daemon (``daemon_phase`` says each check).  The
   train kernels' launches on this path are the workload process's own
   counts, which start at 0 with it and which it prints at its end.
9. ``planes``: the exporter daemon with its burst, flight-recorder and
   anomaly planes on (``-d 1000 --burst-hz 100 --blackbox-dir D --rules
   R``) over NVML, in a leg of its own, while this process drives B4 (the
   ``mxu`` pattern) idle 4 s, as a 250/250 ms square wave for 8 s, steady
   for 5 s and idle 5 s, and appends an ``NVRM: Xid`` line to the kmsg
   fixture the daemon reads.  Scraped at 1 Hz, the recording replayed
   through ``tpumon_torch.cli.replay`` after SIGTERM, then a second
   daemon on the same directory killed with SIGKILL (``planes_phase``
   says each check).  Prints the daemon's CPU share with the 100 Hz loop
   in the idle tail, where this process's own 100 Hz sampler is stopped,
   and per load phase, beside the ``daemon`` phase's; the inner loop's
   NVML read per tick,
   each power reading's and utilization's spread per 1 s window by load
   phase, the recorder's bytes per tick and the anomaly and record
   phases.  The daemon runs with ``TPUMON_NATIVE=1`` (the native codec;
   every scrape must read ``tpumon_codec_native 1``).  B4's launches join
   the kernels line as path ``planes``.
10. ``watches``: the façade's health, policy and event-set watches over
   NVML while this process drives B4 idle 4 s, steady 6 s, idle 4 s,
   steady 6 s: the policy CLI at the reference's 250 W (one POWER
   violation a steady stretch, none idle), an in-process THERMAL watch
   held to the crossings of its limit, ``health_check`` not FAIL, the
   critical event set silent, and the REST API (``python -m
   tpumon_torch.restapi.main``) on every route of the card, agreeing
   with the handle, without a CUDA context (``watches_phase`` says each
   check).  B4's launches join the kernels line as path ``watches``.
11. ``stream``: the exporter daemon with ``--stream-port`` and
   ``--blackbox-dir`` beside the train workload, 10 s with no
   subscriber, then 20 s with 16 decoders, a ``GET /stream``
   subscriber, the stream CLI and a late decoder: every subscriber's
   sweeps are the recorder's (``stream_phase`` says each check).  The
   workload's B1-B3 launches join the kernels line as path ``stream``.
   ``relay`` and ``agent`` beside one train workload: the relay tree, the
   agent run modes (``agent_phase``) and the agent serving ``/metrics``
   itself with ``--prom-port 0 --merge-textfile`` (``agent_prom_phase``:
   30 scrapes at 1 Hz, each held to NVML reads, the drop file merged,
   ``/healthz`` 200; scrape wall ms, the agent's CPU and RSS).  Then
   ``fleet`` beside the same workload (``fleet_phase``): the port's agent
   over NVML for the card's host among 255 simulated hosts x 8 chips
   (``python -m tpumon_torch.agentsim --procs 4``); the flat poller at
   1 Hz for 20 ticks in its own process, once on each poll plane: the
   Python ``FleetPoller`` (``TPUMON_NATIVE=0``), then the native engine's
   ``NativeFleetPoller`` (``TPUMON_NATIVE=1``) (every host up every tick,
   every simulated row its farm's values and the two planes' tables
   alike, the card's row within the ``nvml check`` tolerances of this
   process's NVML reads in the same second; per plane, side by side:
   tick wall, the poller thread's CPU a tick, the process's CPU share and
   RSS, bytes a host-tick); then, on the native engine, ``python -m
   tpumon_torch.cli.fleet --targets-file F --shards 4 --supervise
   --metrics-port P`` with one shard child SIGKILLed (its view the flat
   one again within 20 s, the restart counted; ticks and seconds to
   converge, the ``/metrics`` scrape, which must read
   ``tpumon_poll_native 1`` and ``tpumon_codec_native 1``);
   ``ShardSupervisor`` over the same targets in a process of its own for
   20 ticks at 1 Hz (every host up; the health watch's CPU over the
   process's, from the supervisor's own counter); ``--connect <agent>
   --once --check --expect-chips 1`` exit 0.
   ``chaos`` beside the same workload (``chaos_phase``): ``python -m
   tpumon_torch.cli.chaos run tests/data/torch_scenarios/*.yaml --json``
   in its own process with ``TPUMON_NATIVE=1`` (the system under test on
   the native engine, the harness's reference poller on Python), every
   one of the eight scenarios green (each one's
   ticks to converge, restarts and seconds; the process's CPU share with
   its children), and a scenario whose replay invariant must go red
   (CHAOS_RED) exiting non-zero.  ``deploy`` (``deploy_phase``):
   ``deploy/gpu/k8s/tpumon-daemonset.yaml`` read with the port's YAML
   loader, its agent and exporter containers' commands and args started
   here (and ``tpumon-agent-daemonset.yaml``'s agent with
   ``--prom-port``), hostPaths under a temp dir and ports free ones, the
   workload's drop file where the manifest mounts the drop directory,
   10 s at the manifest's ``-d``: the agents' sockets answer, ``/healthz``
   200, at least 20 NVML families for the card on ``/metrics``, each
   process's RSS and CPU share under its container's limits, and the
   families the reused dashboard and alert rules query either served or
   listed in ``deploy/gpu/README.md`` as blank on the H100 (exactly).
   No fleet, chaos or deploy process may import ``tpumon``, ``jax`` or
   ``torch``: they run with an import guard on their ``PYTHONPATH`` that
   refuses and logs it.  The workload's B1-B3 launches join the kernels
   line as path ``relay+agent+fleet+chaos+deploy``; its steps/s is
   printed on the ``fleet:`` line.
12. Prints each load pattern's busy share (its kernel's device time over
   its self-monitored step), the card's name and power limit again, then
   one ``{"kernels": [...], "backward":
   {...}}`` line.  ``backward`` is the port's whole backward pass, the dQ
   and dK/dV kernels' device times summed, beside SDPA's backward (dQ, dK
   and dV in one call) at the bench shape and at S=1024.  ``kernels`` has
   a row for each kernel: ``ms`` is one call through the port's wrapper
   as the main path makes it and ``kernel_ms`` the kernel's C entry called
   directly (CUDA events over back-to-back calls, so the wrapper's host
   work shows in ``ms`` only where it outlasts the kernel); ``device_ms``
   and ``library_device_ms`` are the sums of the device kernels that the
   kernel's entry and the library call launch, as torch.profiler records
   them, so the host's pace between launches counts in neither
   (``library_kernels`` names them; each fails unless the profiler kept
   every launch of the timed calls); then, last, the ``{"ok": true,
   "device": {...}}`` line.  The smoke's total seconds so far are printed
   (``total:``) before the card's name.

Exits non-zero, printing no result, on any failure, when CUDA is not
available, or when the ``tpumon_torch`` package is not beside it.
"""

from __future__ import annotations

import contextlib
import gc
import io
import json
import math
import os
import re
import shutil
import subprocess
import sys
import threading
import time

HERE = os.path.dirname(os.path.abspath(__file__))

#: NVIDIA H100 SXM data-sheet peaks (dense bf16 tensor-core rate, HBM3
#: bandwidth) for the roofline bound
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
#: flash vs dense train step: relative Frobenius error of the update of
#: each attention projection (q, k, v, o).  bf16 activations through two
#: layers part the two models' updates by about 1% (1.2% at most with the
#: plain flash version on the CPU); there, a dK/dV that skipped the last
#: key tile moved the k projection's update by 18%, and a dQ whose last
#: 64 rows were scaled by 0.9 moved the q projection's by 5%.
UPDATE_RTOL = 3e-2
#: profiler captures a device time may take: CUPTI has dropped one kernel
#: record of 200 short back-to-back launches, which the launch count
#: catches
PROFILE_CAPTURES = 3

BH, HEADS, D = 64, 8, 128
FLASH_KERNELS = (
    ("flash_fwd", "_flash_kernel", "tpumon/loadgen/kernels.py:122"),
    ("flash_bwd_dq", "_flash_bwd_dq_kernel", "tpumon/loadgen/kernels.py:192"),
    ("flash_bwd_dkv", "_flash_bwd_dkv_kernel",
     "tpumon/loadgen/kernels.py:219"),
)
LOAD_KERNELS = (
    ("mxu_burn", "_mxu_kernel", "tpumon/loadgen/kernels.py:34"),
    ("hbm_stream", "_stream_kernel", "tpumon/loadgen/kernels.py:59"),
)
#: the port's own kernel: the reference's jitted step leaves its update to
#: XLA's fusion, so it replaces no Pallas kernel
UPDATE_KERNELS = (("sgd_update", None, None),)
KERNELS = FLASH_KERNELS + LOAD_KERNELS + UPDATE_KERNELS
#: each main path's run, and the kernels it must launch
PATHS = {
    "train": ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "sgd_update"),
    "mxu": ("mxu_burn",),
    "hbm": ("hbm_stream",),
    "mixed": ("mxu_burn", "hbm_stream"),
    "flash": ("flash_fwd",),
    "conv": (),
    "ringattn": (),
    "allreduce": (),
    "dcn": (),
    "pp": (),
    "moe": (),
}
#: the multi-device patterns (``multi`` leg), each run this long, s, in a
#: 1-rank NCCL group; the ones whose step calls NCCL at one rank (the
#: others' hops are the identity there)
MULTI_PATHS = ("ringattn", "allreduce", "dcn", "pp", "moe")
MULTI_S = 6.0
MULTI_NCCL = ("allreduce", "dcn", "moe")


#: the port's analysis planes as the smoke runs them, each in a process of
#: its own on the tree it drives (``--json`` appended to the check's)
ANALYSIS = {
    "lint": ("tpumon_torch.tools.tpumon_lint",),
    "check": ("tpumon_torch.tools.tpumon_check", "--baseline",
              "tpumon_torch/tools/check_baseline.json"),
}


def analysis_start(work: str) -> dict:
    """Start both analyzers (they run beside the builds) -> name ->
    (process, its waiter thread, output path, {"s": its wall seconds})."""

    procs = {}
    for name, args in ANALYSIS.items():
        out = os.path.join(work, f"{name}.out")
        argv = [sys.executable, "-m", *args]
        if name == "check":
            argv += ["--json", os.path.join(work, "check.json")]
        with open(out, "w") as f:
            proc = subprocess.Popen(argv, cwd=HERE, stdout=f,
                                    stderr=subprocess.STDOUT)
        timing = {}

        def wait(proc=proc, timing=timing, t0=time.monotonic()):
            proc.wait()
            timing["s"] = round(time.monotonic() - t0, 2)

        waiter = threading.Thread(target=wait, daemon=True)
        waiter.start()
        procs[name] = (proc, waiter, out, timing)
    return procs


def analysis_phase(procs: dict, work: str, card: str) -> dict:
    """Both analyzers' findings, pragmas and seconds, and the built codec
    extension's exported constants held to the Python declarations (pass
    4's pin, on the build the native legs load).  Any finding or baseline
    drift fails the smoke."""

    res = {}
    for name, (proc, waiter, out, timing) in procs.items():
        rc = proc.wait(timeout=600)
        waiter.join()
        text = open(out).read()
        res[name] = {"rc": rc, "s": timing["s"]}
        summary = [ln for ln in text.splitlines()
                   if ln.startswith(f"tpumon-{name}: ")
                   and " finding" in ln]
        m = re.search(r"(\d+) findings?", summary[-1] if summary else "")
        res[name]["findings"] = int(m.group(1)) if m else None
        if name == "check":
            res[name]["drift"] = sum(1 for ln in text.splitlines()
                                     if "baseline drift" in ln)
        if rc != 0 or res[name]["findings"] != 0 or res[name].get("drift"):
            raise RuntimeError(f"tpumon-{name} failed (rc {rc}):\n"
                               + text[-4000:])
    with open(os.path.join(work, "check.json")) as f:
        report = json.load(f)
    kinds: dict = {}
    for supp in report["suppressions"]:
        kinds[supp["kind"]] = kinds.get(supp["kind"], 0) + 1
    res["lint"]["suppressions"] = kinds.get("lint-disable", 0)
    res["check"]["suppressions"] = sum(kinds.values())
    res["check"]["by_kind"] = kinds
    res["check"]["functions"] = report["stats"]["functions"]
    res["check"]["tool_s"] = report["stats"]["seconds"]
    from tpumon_torch.tools import tpumon_check as TC

    built = TC.built_codec_constants(HERE)
    if not built:
        raise RuntimeError("the built codec extension did not load for "
                           "the constant pins")
    pins = TC.check_protocol_sync(HERE, codec_constants=built)
    if pins:
        raise RuntimeError("codec constant pins: "
                           + "; ".join(f.render() for f in pins))
    res["codec_pins"] = {"constants": len(built), "findings": 0}
    res["card"] = card
    return res


def fail(msg: str) -> int:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    return 1


def time_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls (CUDA
    events), after one warm-up call."""

    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int, per_call=None, names=None) -> float:
    """Mean device time of one call of ``fn``: the sum of the device
    kernels it launches, as torch.profiler (CUPTI) records them, over
    ``iters`` calls after one warm-up call.  Unlike :func:`time_ms`, the
    host's pace between launches does not count.  Only a profiler
    capture that kept every launch counts: ``per_call`` kernels a call
    where it is given (the port's C entries launch one), else the same
    number in every call.  A capture that lost a record, or all of them,
    is taken again, up to PROFILE_CAPTURES in all, and then this fails.
    The kernels' names are appended to ``names`` when it is given."""

    import torch
    from torch.profiler import ProfilerActivity, profile
    from tpumon_torch.loadgen.profile import device_us
    from tpumon_torch.trace import profiler_session

    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILE_CAPTURES):
        with profiler_session(), \
                profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and device_us(e) > 0]
        us = sum(device_us(e) for e in events)
        n = sum(e.count for e in events)
        if us > 0 and not (n % iters or (per_call is not None and
                                         n != per_call * iters)):
            if names is not None:
                names.extend(e.key for e in events)
            return us / 1e3 / iters
    raise AssertionError(f"the profiler kept {n} device kernels over "
                         f"{iters} calls"
                         + (f" of {per_call}" if per_call else "")
                         + f" in each of {PROFILE_CAPTURES} captures")


def max_err(got, want) -> float:
    return (got.float() - want.float()).abs().max().item()


def check_close(K, name: str, got, want) -> float:
    """Fails unless ``got`` is within the kernels' elementwise tolerance
    of ``want``; returns the largest error over its limit (<= 1)."""

    excess = K.plain_excess(got, want)
    if not excess <= 1.0:
        raise AssertionError(f"{name}: |kernel - plain| reaches {excess:.3g}x "
                             f"its elementwise limit (max abs err "
                             f"{max_err(got, want):.3e})")
    return excess


def planted_faults(K, q, k, v, outs, wants) -> dict:
    """The check must fail what a kernel that skipped its last key tile
    would give: O's last 64 rows over the keys before that tile only,
    and zero dK and dV for its keys.  Returns each fault's excess."""

    last = q.shape[1] - 64
    o = outs["o"].clone()
    s = q[:, last:].float() @ k[:, :last].float().mT * D ** -0.5
    o[:, last:] = (s.softmax(-1) @ v[:, :last].float()).to(o.dtype)
    faults = {"o": o}
    for name in ("dk", "dv"):
        faults[name] = outs[name].clone()
        faults[name][:, last:] = 0
    excess = {name: K.plain_excess(t, wants[name])
              for name, t in faults.items()}
    for name, x in excess.items():
        if not x > 1.0:
            raise AssertionError(f"the check passes a planted fault in "
                                 f"{name} (excess {x:.3g})")
    return excess


def bench_inputs(causal: bool):
    """Folded (BH, S, D) bf16 q, k, v, dO as the main path hands them to
    the kernels: causal at S=255 zero-padded to 256 by the public
    ``flash_attention`` contract, non-causal at S=256."""

    import torch
    import torch.nn.functional as F

    g = torch.Generator("cuda").manual_seed(7 if causal else 8)
    S = 255 if causal else 256
    x = [torch.randn((BH // HEADS, S, HEADS, D), generator=g, device="cuda")
         .to(torch.bfloat16) for _ in range(4)]
    if causal:
        x = [F.pad(t, (0, 0, 0, 0, 0, 1)) for t in x]
    return [t.transpose(1, 2).reshape(BH, 256, D).contiguous() for t in x]


def kernel_cases(K, lib):
    """Compare, time and bound the three kernels.  Returns the rows of
    the kernels line (without the launch counts)."""

    import torch
    import torch.nn.functional as F
    from tpumon_torch import _build

    rows = {}
    for causal in (True, False):
        q, k, v, do = bench_inputs(causal)
        S = q.shape[1]
        blk = 128
        o, lse = K.flash_fwd(q, k, v, causal, blk, blk)
        torch.cuda.synchronize()
        o_p, lse_p = K.flash_fwd_plain(q, k, v, causal, blk, blk)
        delta = (do.float() * o_p.float()).sum(-1)
        dq = K.flash_bwd_dq(q, k, v, do, lse_p, delta, causal, blk, blk)
        torch.cuda.synchronize()
        dk, dv = K.flash_bwd_dkv(q, k, v, do, lse_p, delta, causal, blk, blk)
        torch.cuda.synchronize()
        dq_p = K.flash_bwd_dq_plain(q, k, v, do, lse_p, delta, causal, blk,
                                    blk)
        dk_p, dv_p = K.flash_bwd_dkv_plain(q, k, v, do, lse_p, delta, causal,
                                           blk, blk)
        outs = {"o": o, "dq": dq, "dk": dk, "dv": dv}
        wants = {"o": o_p, "dq": dq_p, "dk": dk_p, "dv": dv_p}
        excess = {n: check_close(K, f"{n} ({'' if causal else 'non-'}causal)",
                                 outs[n], wants[n]) for n in outs}
        if max_err(lse, lse_p) > 1e-2:
            raise AssertionError(f"flash_fwd lse off by {max_err(lse, lse_p)}")
        # (max abs error, tolerance excess) of each kernel's outputs
        errs = {name: (max(max_err(outs[n], wants[n]) for n in ns),
                       max(excess[n] for n in ns))
                for name, ns in (("flash_fwd", ("o",)),
                                 ("flash_bwd_dq", ("dq",)),
                                 ("flash_bwd_dkv", ("dk", "dv")))}
        if not causal:
            for name, (err, exc) in errs.items():
                rows[name]["max_abs_err_noncausal"] = err
                rows[name]["tol_excess_noncausal"] = exc
            continue
        print("planted faults rejected, excess: " + json.dumps(
            planted_faults(K, q, k, v, outs, wants)))

        # timings at the main path's (causal, padded) shape
        ptr = [t.data_ptr() for t in (q, k, v, do)]
        scale = D ** -0.5
        stream = torch.cuda.current_stream().cuda_stream
        o_b, lse_b = torch.empty_like(q), torch.empty((BH, S), device="cuda")
        dq_b, dk_b, dv_b = (torch.empty_like(q) for _ in range(3))
        # the kernels alone: their C entry points called back to back,
        # so the host's per-call Python work never gaps the device
        raw = {
            "flash_fwd": lambda: _build.check(lib.tpumon_flash_fwd(
                *ptr[:3], o_b.data_ptr(), lse_b.data_ptr(), BH, S, D, 1,
                scale, stream), "flash_fwd"),
            "flash_bwd_dq": lambda: _build.check(lib.tpumon_flash_bwd_dq(
                *ptr, lse_p.data_ptr(), delta.data_ptr(), dq_b.data_ptr(),
                BH, S, D, 1, scale, stream), "flash_bwd_dq"),
            "flash_bwd_dkv": lambda: _build.check(lib.tpumon_flash_bwd_dkv(
                *ptr, lse_p.data_ptr(), delta.data_ptr(), dk_b.data_ptr(),
                dv_b.data_ptr(), BH, S, D, 1, scale, stream),
                "flash_bwd_dkv"),
        }
        wrapped = {
            "flash_fwd": lambda: K.flash_fwd(q, k, v, True, blk, blk),
            "flash_bwd_dq": lambda: K.flash_bwd_dq(
                q, k, v, do, lse_p, delta, True, blk, blk),
            "flash_bwd_dkv": lambda: K.flash_bwd_dkv(
                q, k, v, do, lse_p, delta, True, blk, blk),
        }
        plain = {
            "flash_fwd": lambda: K.flash_fwd_plain(q, k, v, True, blk, blk),
            "flash_bwd_dq": lambda: K.flash_bwd_dq_plain(
                q, k, v, do, lse_p, delta, True, blk, blk),
            "flash_bwd_dkv": lambda: K.flash_bwd_dkv_plain(
                q, k, v, do, lse_p, delta, True, blk, blk),
        }
        # library yardstick: SDPA on the same (B, H, S, D) data
        q4, k4, v4, do4 = (t.reshape(BH // HEADS, HEADS, S, D)
                           for t in (q, k, v, do))
        qg, kg, vg = (t.detach().clone().requires_grad_() for t in (q4, k4, v4))
        out4 = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
        lib_calls = {
            "fwd": lambda: F.scaled_dot_product_attention(
                q4, k4, v4, is_causal=True),
            "bwd": lambda: torch.autograd.grad(
                out4, (qg, kg, vg), do4, retain_graph=True),
        }
        lib_ms = {n: time_ms(fn, 200) for n, fn in lib_calls.items()}
        lib_kernels = {n: [] for n in lib_calls}
        lib_dev = {n: device_ms(fn, 200, names=lib_kernels[n])
                   for n, fn in lib_calls.items()}

        work = flash_work(BH, S, D)
        for name, tpu_kernel, replaces in FLASH_KERNELS:
            lib_key = "fwd" if name == "flash_fwd" else "bwd"
            rows[name] = {
                "name": name,
                "route": "cuda",
                "source": "tpumon_torch/csrc/flash_attn.cu",
                "replaces": f"{replaces} ({tpu_kernel})",
                "max_abs_err": errs[name][0],
                "tol_excess": errs[name][1],
                "ms": time_ms(wrapped[name], 200),
                "kernel_ms": time_ms(raw[name], 200),
                "device_ms": device_ms(raw[name], 200, per_call=1),
                "plain_ms": time_ms(plain[name], 20),
                **bound(*work[name]),
                "library_ms": lib_ms[lib_key],
                "library_device_ms": lib_dev[lib_key],
                "library_kernels": [k[:100] for k in lib_kernels[lib_key]],
                "library_call": ("scaled_dot_product_attention forward"
                                 if name == "flash_fwd" else
                                 "scaled_dot_product_attention backward "
                                 "(dQ, dK and dV together)"),
            }
    return rows


def flash_work(bh: int, S: int, Dh: int) -> dict:
    """(bytes, FLOPs) of each flash kernel, causal, on this shape: each
    input read once and each output written once; tensor-core FLOPs over
    the (i, j) pairs the causal mask keeps."""

    half = bh * S * Dh * 2
    rowvec = bh * S * 4
    pairs = bh * S * (S + 1) // 2
    return {
        "flash_fwd": (3 * half + half + rowvec, 2 * 2 * Dh * pairs),
        "flash_bwd_dq": (4 * half + 2 * rowvec + half, 3 * 2 * Dh * pairs),
        "flash_bwd_dkv": (4 * half + 2 * rowvec + 2 * half,
                          4 * 2 * Dh * pairs),
    }


#: a longer causal sequence for the two backward kernels: up to 16 tiles
#: a loop, where the bench shape's 4 hardly exercise the ring
LONG_BWD_SHAPE = (64, 1024, 128)


def long_backward_case(K, lib) -> dict:
    """The dQ and dK/dV kernels at LONG_BWD_SHAPE, causal, through their
    wrappers against their plain versions with the kernels' tolerance,
    then timed from their C entries beside their bounds and SDPA's
    backward on the same data.  Returns a row for each kernel."""

    import torch
    import torch.nn.functional as F
    from tpumon_torch import _build

    bh, S, Dh = LONG_BWD_SHAPE
    g = torch.Generator("cuda").manual_seed(12)
    q, k, v, do = (torch.randn((bh, S, Dh), generator=g, device="cuda")
                   .to(torch.bfloat16) for _ in range(4))
    o_p, lse = K.flash_fwd_plain(q, k, v, True, 128, 128)
    delta = (do.float() * o_p.float()).sum(-1)
    dq = K.flash_bwd_dq(q, k, v, do, lse, delta, True, 128, 128)
    dk, dv = K.flash_bwd_dkv(q, k, v, do, lse, delta, True, 128, 128)
    torch.cuda.synchronize()
    dq_p = K.flash_bwd_dq_plain(q, k, v, do, lse, delta, True, 128, 128)
    dk_p, dv_p = K.flash_bwd_dkv_plain(q, k, v, do, lse, delta, True, 128,
                                       128)
    pairs = {"flash_bwd_dq": [(dq, dq_p)],
             "flash_bwd_dkv": [(dk, dk_p), (dv, dv_p)]}
    ptr = [t.data_ptr() for t in (q, k, v, do, lse, delta)]
    out = [torch.empty_like(q) for _ in range(3)]
    scale = Dh ** -0.5
    stream = torch.cuda.current_stream().cuda_stream
    raw = {
        "flash_bwd_dq": lambda: _build.check(lib.tpumon_flash_bwd_dq(
            *ptr, out[0].data_ptr(), bh, S, Dh, 1, scale, stream),
            "flash_bwd_dq"),
        "flash_bwd_dkv": lambda: _build.check(lib.tpumon_flash_bwd_dkv(
            *ptr, out[1].data_ptr(), out[2].data_ptr(), bh, S, Dh, 1, scale,
            stream), "flash_bwd_dkv"),
    }
    work = flash_work(bh, S, Dh)
    rows = {}
    for name, outs in pairs.items():
        rows[name] = {
            "shape": list(LONG_BWD_SHAPE),
            "max_abs_err": max(max_err(a, b) for a, b in outs),
            "tol_excess": max(check_close(K, f"{name} at {[bh, S, Dh]}", a, b)
                              for a, b in outs),
            "kernel_ms": time_ms(raw[name], 100),
            "device_ms": device_ms(raw[name], 100, per_call=1),
            **bound(*work[name]),
        }
    q4, k4, v4, do4 = (t.reshape(bh // HEADS, HEADS, S, Dh)
                       for t in (q, k, v, do))
    qg, kg, vg = (t.detach().clone().requires_grad_() for t in (q4, k4, v4))
    out4 = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
    sdpa_bwd = lambda: torch.autograd.grad(out4, (qg, kg, vg), do4,
                                           retain_graph=True)
    lib_times = {"library_ms": time_ms(sdpa_bwd, 100),
                 "library_device_ms": device_ms(sdpa_bwd, 100)}
    for row in rows.values():
        row.update(lib_times)
    return rows


def backward_table(rows) -> dict:
    """The port's whole backward pass, the dQ and dK/dV kernels' device
    times summed, beside SDPA's backward (one call for dQ, dK and dV), at
    the bench shape and at LONG_BWD_SHAPE."""

    dq, dkv = rows["flash_bwd_dq"], rows["flash_bwd_dkv"]

    def entry(a, b, lib_device_ms, shape):
        port = a["device_ms"] + b["device_ms"]
        return {"shape": shape, "dq_device_ms": a["device_ms"],
                "dkv_device_ms": b["device_ms"], "device_ms": port,
                "library_device_ms": lib_device_ms,
                "vs_library": port / lib_device_ms}

    return {"bench": entry(dq, dkv, dq["library_device_ms"], [BH, 256, D]),
            "long": entry(dq["at_long_sequence"], dkv["at_long_sequence"],
                          dq["at_long_sequence"]["library_device_ms"],
                          list(LONG_BWD_SHAPE)),
            "library_call": "scaled_dot_product_attention backward "
                            "(dQ, dK and dV together)"}


def bound(nbytes: float, flops: float) -> dict:
    """The least time the card could take for work that must move
    ``nbytes`` (each input read once, each output written once) and do
    ``flops`` bf16 tensor-core operations, and which of the two bounds
    it."""

    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


#: the reference's ``flash`` pattern shape (B, S, H, D), which the card's
#: pattern outgrew in heads: the forward kernel's row is timed here too, to
#: stay comparable with earlier runs
FLASH_SHAPE_REFERENCE = (1, 1024, 4, 128)


def flash_pattern_case(K, lib, shape) -> dict:
    """The forward kernel at a ``flash`` pattern shape (B, S, H, D),
    causal, through its wrapper as the main path calls it, against its
    plain version with the kernels' tolerance, timed beside its bound and
    SDPA."""

    import torch
    import torch.nn.functional as F
    from tpumon_torch import _build

    B, S, H, Dp = shape
    bh = B * H
    g = torch.Generator("cuda").manual_seed(11)
    q, k, v = (torch.randn((bh, S, Dp), generator=g, device="cuda")
               .to(torch.bfloat16) for _ in range(3))
    o, lse = K.flash_fwd(q, k, v, True, 128, 128)
    torch.cuda.synchronize()
    o_p, lse_p = K.flash_fwd_plain(q, k, v, True, 128, 128)
    excess = check_close(K, f"flash_fwd at {list(shape)}", o, o_p)
    if max_err(lse, lse_p) > 1e-2:
        raise AssertionError(f"flash_fwd lse off by {max_err(lse, lse_p)} "
                             f"at {list(shape)}")
    o_b, lse_b = torch.empty_like(q), torch.empty((bh, S), device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    raw = lambda: _build.check(lib.tpumon_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o_b.data_ptr(),
        lse_b.data_ptr(), bh, S, Dp, 1, Dp ** -0.5, stream), "flash_fwd")
    half = bh * S * Dp * 2
    q4, k4, v4 = (t.reshape(B, H, S, Dp) for t in (q, k, v))
    sdpa = lambda: F.scaled_dot_product_attention(q4, k4, v4, is_causal=True)
    return {
        "shape": [bh, S, Dp],
        "max_abs_err": max_err(o, o_p),
        "tol_excess": excess,
        "ms": time_ms(lambda: K.flash_fwd(q, k, v, True, 128, 128), 200),
        "kernel_ms": time_ms(raw, 200),
        "device_ms": device_ms(raw, 200, per_call=1),
        "plain_ms": time_ms(lambda: K.flash_fwd_plain(q, k, v, True, 128,
                                                      128), 20),
        **bound(4 * half + bh * S * 4, 2 * 2 * Dp * bh * S * (S + 1) // 2),
        "library_ms": time_ms(sdpa, 200),
        "library_device_ms": device_ms(sdpa, 200),
    }


def step_ms(fn, x, iters: int) -> float:
    """Host-clock time per step of the chain ``x = fn(x)``, as a pattern
    steps, over ``iters`` steps ending in a synchronise: the device's
    time where it is busy throughout, the host's where the host cannot
    keep it fed."""

    import torch

    y = fn(x)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        y = fn(y)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters * 1e3


def stream_case(K, lib, shape) -> dict:
    """``hbm_stream`` at ``shape`` (f32): the kernel bit for bit equal to
    its plain version, a planted unwritten (256, 1024) block rejected, and
    its times; ``gbps`` is the bytes the pass must move over the kernel's
    time, ``step_ms`` the chained pattern step on the host clock.  The
    library yardstick is one call of the same function,
    ``torch.add(c, x, alpha=1.0001)`` with ``c`` a 0-dim device tensor of
    0.25; ``copy_`` of the same bytes is timed beside it."""

    import torch
    from tpumon_torch import _build

    x = torch.randn(shape, device="cuda",
                    generator=torch.Generator("cuda").manual_seed(5))
    got = K.hbm_stream(x)
    torch.cuda.synchronize()
    want = K.hbm_stream_plain(x)
    if not torch.equal(got, want):
        raise AssertionError(f"hbm_stream {shape}: kernel differs from its "
                             f"plain version (max abs err "
                             f"{max_err(got, want):.3e})")
    fault = got.clone()
    fault[256:512, 1024:2048] = 0.0
    if torch.equal(fault, want):
        raise AssertionError("the hbm_stream check passes a block left "
                             "unwritten")
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream().cuda_stream
    nbytes = 2 * x.numel() * 4
    c = torch.tensor(0.25, device="cuda")
    same = lambda: torch.add(c, x, alpha=1.0001)
    raw = lambda: _build.check(lib.tpumon_hbm_stream(
        x.data_ptr(), out.data_ptr(), x.numel(), stream), "hbm_stream")
    kernel_ms = time_ms(raw, 200)
    return {
        "shape": list(shape),
        "max_abs_err": max_err(got, want),
        "bitwise": True,
        "ms": time_ms(lambda: K.hbm_stream(x), 200),
        "kernel_ms": kernel_ms,
        "device_ms": device_ms(raw, 200, per_call=1),
        "gbps": nbytes / kernel_ms / 1e6,
        "step_ms": step_ms(K.hbm_stream, x, 500),
        "plain_ms": time_ms(lambda: K.hbm_stream_plain(x), 200),
        **bound(nbytes, 0),
        "library_ms": time_ms(same, 200),
        "library_device_ms": device_ms(same, 200),
        "library_max_abs_err": max_err(same(), want),
        "library_call": "torch.add(c, x, alpha=1.0001), c a 0-dim device "
                        "tensor of 0.25",
        "copy_ms": time_ms(lambda: out.copy_(x), 200),
        "copy_device_ms": device_ms(lambda: out.copy_(x), 200),
    }


def mxu_case(K, lib) -> dict:
    """``mxu_burn`` at the pattern's depth and number of tiles on bounded
    inputs (x random normal, w random orthogonal), within its tolerance of
    the plain chain; the chain one step short must fail it."""

    import numpy as np
    import torch
    from tpumon_torch import _build

    T, iters, n = K.MXU_TILE, 64, K.mxu_tiles("cuda")
    x = torch.randn((n, T, T), device="cuda",
                    generator=torch.Generator("cuda").manual_seed(3)
                    ).to(torch.bfloat16)
    qr, _ = np.linalg.qr(np.random.default_rng(4).standard_normal((T, T)))
    w = torch.from_numpy(qr.astype(np.float32)).to("cuda", torch.bfloat16)
    got = K.mxu_burn(x, w, iters=iters)
    short = K.mxu_burn(x, w, iters=iters - 1)
    torch.cuda.synchronize()
    want = K.mxu_burn_plain(x, w, iters=iters)
    excess = K.mxu_excess(got, want, iters)
    if not excess <= 1.0:
        raise AssertionError(f"mxu_burn: |kernel - plain| reaches "
                             f"{excess:.3g}x its elementwise limit")
    fault = K.mxu_excess(short, want, iters)
    if not fault > 1.0:
        raise AssertionError(f"the mxu_burn check passes a chain one step "
                             f"short (excess {fault:.3g})")
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream().cuda_stream

    def library():
        acc = x
        for _ in range(iters):
            acc = torch.matmul(acc, w)
        return acc

    flops = n * iters * 2 * T ** 3
    raw = lambda: _build.check(lib.tpumon_mxu_burn(
        x.data_ptr(), w.data_ptr(), out.data_ptr(), n, iters, stream),
        "mxu_burn")
    kernel_ms = time_ms(raw, 50)
    return {
        "shape": [n, T, T],
        "iters": iters,
        "max_abs_err": max_err(got, want),
        "tol_excess": excess,
        "planted_fault_excess": fault,
        "ms": time_ms(lambda: K.mxu_burn(x, w, iters=iters), 50),
        "kernel_ms": kernel_ms,
        "device_ms": device_ms(raw, 50, per_call=1),
        "tflops": flops / kernel_ms / 1e9,
        "plain_ms": time_ms(lambda: K.mxu_burn_plain(x, w, iters=iters), 5),
        **bound((2 * n + 1) * T * T * 2, flops),
        "library_ms": time_ms(library, 20),
        "library_device_ms": device_ms(library, 20),
        "library_call": f"torch.matmul bf16 (n, T, T) @ (T, T), f32 "
                        f"accumulate, bf16 out: {iters} chained calls",
    }


def load_kernel_cases(K, lib) -> dict:
    """Rows of the kernels line for the two load-shaping kernels, at the
    card's pattern shapes; the stream also at the reference's (2048, 4096)
    f32, whose 64 MiB of traffic the 50 MB L2 can partly serve."""

    stream = stream_case(K, lib, K.HBM_SHAPE["cuda"])
    stream["at_reference_shape"] = stream_case(K, lib, (2048, 4096))
    rows = {"mxu_burn": mxu_case(K, lib), "hbm_stream": stream}
    for name, tpu_kernel, replaces in LOAD_KERNELS:
        rows[name] = {"name": name, "route": "cuda",
                      "source": "tpumon_torch/csrc/load_kernels.cu",
                      "replaces": f"{replaces} ({tpu_kernel})", **rows[name]}
    return rows


def update_inputs(M, seed: int = 6):
    """The bench model's float leaves as the graph step updates them: f32
    masters (the seeded init), bf16 gradients of a size that lr * g moves
    them, and the masters' bf16 working copies."""

    import torch

    params = M.init_params(torch.Generator("cuda").manual_seed(seed),
                           M.ModelConfig.bench())
    masters = [t for t in M.tree_leaves(params) if t.is_floating_point()]
    g = torch.Generator("cuda").manual_seed(seed + 1)
    grads = [torch.randn(t.shape, generator=g, device="cuda")
             .to(torch.bfloat16) for t in masters]
    return masters, grads, [t.to(torch.bfloat16) for t in masters]


def update_case(K, M, lib) -> dict:
    """``sgd_update`` at the bench model's leaves: the kernel bit for bit
    equal to its plain version (on CPU copies) and to the unfused update
    on the card (``model._sgd``, then the cast), a planted last element
    left stale rejected, and its times beside its bound.  The library
    yardstick is the five-op chain the kernel replaced in the graph step,
    every leaf: the forward's f32 -> bf16 cast, the gradient's bf16 -> f32
    cast, ``lr * g``, ``t - lr * g`` and ``t.copy_``."""

    import ctypes

    import torch
    from tpumon_torch import _build

    lr = 1e-3
    masters, grads, works = update_inputs(M)
    cpu = [[t.cpu() for t in ts] for ts in (masters, grads, works)]
    stale = cpu[0][-1].view(-1)[-1].item()
    want = [t.clone() for t in masters]
    M._sgd(want, grads, lr)
    K.sgd_update(masters, grads, works, lr)
    torch.cuda.synchronize()
    K.sgd_update_plain(*cpu, lr)
    for i, (t, w) in enumerate(zip(masters, works)):
        if not (torch.equal(t.cpu(), cpu[0][i]) and torch.equal(t, want[i])
                and torch.equal(w.cpu(), cpu[2][i])
                and torch.equal(w, want[i].to(torch.bfloat16))):
            raise AssertionError(f"sgd_update leaf {i}: kernel differs from "
                                 f"its plain version or the unfused update "
                                 f"(max abs err {max_err(t, want[i]):.3e})")
    fault = masters[-1].clone()
    fault.view(-1)[-1] = stale
    if torch.equal(fault, want[-1]):
        raise AssertionError("the sgd_update check passes a stale element")
    n = len(masters)
    ptrs = [(ctypes.c_void_p * n)(*(t.data_ptr() for t in ts))
            for ts in (masters, grads, works)]
    sizes = (ctypes.c_longlong * n)(*(t.numel() for t in masters))
    stream = torch.cuda.current_stream().cuda_stream
    raw = lambda: _build.check(lib.tpumon_sgd_update(
        *(ctypes.addressof(p) for p in ptrs), ctypes.addressof(sizes), n, lr,
        stream), "sgd_update")

    def library():
        for t, g in zip(masters, grads):
            t.to(torch.bfloat16)
            t.copy_(t - lr * g.to(torch.float32))

    elements = sum(t.numel() for t in masters)
    nbytes = 12 * elements
    kernel_ms = time_ms(raw, 200)
    return {
        "name": "sgd_update", "route": "cuda",
        "source": "tpumon_torch/csrc/sgd_update.cu",
        "replaces": "none: XLA fuses the update into the reference's "
                    "jitted train step",
        "leaves": n, "elements": elements, "bitwise": True,
        "ms": time_ms(lambda: K.sgd_update(masters, grads, works, lr), 200),
        "kernel_ms": kernel_ms,
        "device_ms": device_ms(raw, 200, per_call=1),
        "gbps": nbytes / kernel_ms / 1e6,
        "plain_ms": time_ms(lambda: K.sgd_update_plain(masters, grads, works,
                                                       lr), 50),
        **bound(nbytes, 0),
        "library_ms": time_ms(library, 50),
        "library_device_ms": device_ms(library, 50),
        "library_call": "every leaf: t.to(bf16), g.to(f32), lr * g, "
                        "t - lr * g, t.copy_",
    }


def attention_check(K) -> dict:
    """``flash_attention`` forward and backward, as the model calls it
    (B=8, S=255 padded to 256, 8 heads of 128, causal, bf16), against
    dense f32 attention on the same inputs, element by element with the
    kernels' tolerance.  The dense backward takes delta = rowsum(dO * O)
    from O rounded to bf16, as the flash backward does from the output
    its forward returned: from an f32 O, delta parts from it by the
    rounding of O, which the early rows' dQ and dK (few keys, dP - delta
    nearly cancelling) magnify past the tolerance.  Returns each
    output's excess."""

    import torch

    g = torch.Generator("cuda").manual_seed(9)
    q, k, v, do = (torch.randn((BH // HEADS, 255, HEADS, D), generator=g,
                               device="cuda").to(torch.bfloat16)
                   for _ in range(4))
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
    out = K.flash_attention(qg, kg, vg, causal=True)
    out.backward(do)

    qr, kr, vr, dor = (t.float().transpose(1, 2) for t in (q, k, v, do))
    keep = torch.ones((255, 255), dtype=torch.bool, device="cuda").tril()
    p = (qr @ kr.mT * D ** -0.5).masked_fill(~keep, float("-inf")
                                              ).softmax(-1)
    o = (p @ vr).to(torch.bfloat16)
    delta = (dor * o.float()).sum(-1, keepdim=True)
    ds = p * (dor @ vr.mT - delta) * D ** -0.5
    pairs = {"o": (out, o), "dq": (qg.grad, ds @ kr),
             "dk": (kg.grad, ds.mT @ qr), "dv": (vg.grad, p.mT @ dor)}
    return {name: check_close(K, f"flash_attention {name} vs dense", got,
                              want.to(torch.bfloat16).transpose(1, 2))
            for name, (got, want) in pairs.items()}


def model_check(M) -> dict:
    """One bench train step with flash attention against one of the dense
    model from the same parameters and tokens: the update of each
    attention projection (q, k and v columns of ``wqkv``, and ``wo``)
    within UPDATE_RTOL (relative Frobenius error), the loss within rtol
    2e-2 (the JAX package's own check), and finite bf16 logits of the
    expected shape."""

    import dataclasses

    import torch

    tokens = torch.randint(0, 2048, (8, 256), device="cuda",
                           generator=torch.Generator("cuda").manual_seed(1))
    updates, losses = {}, {}
    for flash in (True, False):
        cfg = dataclasses.replace(M.ModelConfig.bench(), flash=flash)
        params = M.init_params(torch.Generator("cuda").manual_seed(0), cfg)
        if flash:
            with torch.no_grad():
                logits = M.forward(cfg, params, tokens)
        before = {n: params["layers"][n].clone() for n in ("wqkv", "wo")}
        params, loss = M.train_step(cfg, params, tokens)
        up = {n: params["layers"][n] - before[n] for n in before}
        wq, wk, wv = up["wqkv"].chunk(3, dim=-1)
        updates[flash] = {"wq": wq, "wk": wk, "wv": wv, "wo": up["wo"]}
        losses[flash] = loss.item()
    if logits.shape != (8, 256, 2048):
        raise AssertionError(f"logits shape {tuple(logits.shape)}")
    if not torch.isfinite(logits.float()).all():
        raise AssertionError("non-finite logits")
    if not math.isclose(losses[True], losses[False], rel_tol=2e-2):
        raise AssertionError(f"flash loss {losses[True]} vs dense "
                             f"{losses[False]}")
    rel = {n: ((updates[True][n] - b).norm() / b.norm()).item()
           for n, b in updates[False].items()}
    if not max(rel.values()) <= UPDATE_RTOL:
        raise AssertionError(f"flash train step's updates part from the "
                             f"dense model's: {rel}")
    return {"loss_flash": losses[True], "loss_dense": losses[False],
            "update_rel_err": rel}


def pattern_table(rows, rates) -> dict:
    """Each load pattern's self-monitored step (1 / steps/s) beside its
    kernel's device time at the pattern's shape, and their ratio, the
    card's busy share of a step (``mixed``: the mean of its two kernels;
    ``conv`` runs cuDNN, no kernel of the port).  A share well below 1
    means the host sets the pace, and the step is the host's time."""

    kernel = {
        "mxu": rows["mxu_burn"]["device_ms"],
        "hbm": rows["hbm_stream"]["device_ms"],
        "mixed": (rows["mxu_burn"]["device_ms"]
                  + rows["hbm_stream"]["device_ms"]) / 2,
        "flash": rows["flash_fwd"]["at_flash_pattern"]["device_ms"],
        "conv": None,
    }
    table = {}
    for path, ms in kernel.items():
        step = 1e3 / rates[path]
        table[path] = {"steps_per_sec": rates[path], "step_ms": step,
                       "kernel_device_ms": ms,
                       "busy_share": ms / step if ms is not None else None}
    return table


#: families only a trace fills, which the train run must serve
TRACE_FAMILIES = ("PROF_ACHIEVED_TFLOPS", "PROF_MFU", "PROF_VECTOR_ACTIVE")


def drive_path(K, R, fields, path: str) -> tuple:
    """One main path in-process, self-monitored: the bench train run for
    ``train``, else ``--pattern <path>``.  The launch counts are set to 0
    just before it and read just after; fails unless steps ran, the HBM
    families were non-blank, the runner's forced trace capture landed,
    the loss (train) is finite, the trace-only families (train) were
    non-blank and every kernel of the path launched.  Returns (its JSON
    result, the counts)."""

    args = (["--size", "bench", "--seconds", "3"] if path == "train"
            else ["--pattern", path, "--seconds",
                  str(MULTI_S if path in MULTI_PATHS else 2)])
    for name in K.LAUNCHES:
        K.LAUNCHES[name] = 0
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = R.main([*args, "--self-monitor", "--json"])
    launches = dict(K.LAUNCHES)
    out = buf.getvalue().strip().splitlines()
    if rc != 0 or not out:
        raise AssertionError(f"main path {path} exited {rc}")
    result = json.loads(out[-1])
    F = fields.F
    hbm = {fields.CATALOG[int(F.HBM_USED)].prom_name,
           fields.CATALOG[int(F.HBM_TOTAL)].prom_name}
    if path == "train":
        loss = result.get("final_loss")
        if loss is None or not math.isfinite(loss):
            raise AssertionError(f"final loss {loss}")
    if result.get("steps", 0) <= 0:
        raise AssertionError(f"no steps ran on main path {path}")
    if result.get("families_nonblank", 0) <= 0:
        raise AssertionError(f"no non-blank metric families ({path})")
    if not hbm <= set(result.get("families", [])):
        raise AssertionError(f"HBM families {sorted(hbm)} blank ({path})")
    if result.get("capture_forced") is not True:
        raise AssertionError(f"the forced trace capture failed ({path})")
    traced = {fields.CATALOG[int(getattr(F, n))].prom_name
              for n in TRACE_FAMILIES}
    if path == "train" and not traced <= set(result.get("families", [])):
        raise AssertionError(f"trace families {sorted(traced)} blank")
    for name in PATHS[path]:
        if launches.get(name, 0) <= 0:
            raise AssertionError(f"kernel {name} never launched on main "
                                 f"path {path}")
    if path in MULTI_PATHS:
        # the final forced capture's attribution: the NCCL calls it saw,
        # and the bytes they moved at one rank (none)
        att = (result.get("attribution") or {}).get("0") or {}
        events = att.get("collective_events")
        if events is None or (events > 0) != (path in MULTI_NCCL):
            raise AssertionError(f"{path}: {events} collective events in "
                                 f"the capture: {att}")
        if att.get("ici_bytes") != 0 or att.get("suspect"):
            raise AssertionError(f"{path}: ICI bytes at one rank: {att}")
        if "tpu_ici_tx_throughput" not in result.get("families", []):
            raise AssertionError(f"{path}: tpu_ici_tx_throughput blank")
    return result, launches


#: the ring attention check at the pattern's shape: bf16 in and out, both
#: sides summing in f32 and rounding the output once, so within one bf16
#: ulp (rtol 2**-7) and 1e-3; in f32 the reference's own 2e-5
RING_BF16_TOL = (2.0 ** -7, 1e-3)
RING_F32_TOL = 2e-5

#: the two-ranks-on-one-card probe: two NCCL ranks on cuda:0, one
#: all-reduce; NCCL refuses them (a duplicate GPU), or the pair times out
DUP_PROBE = r"""
import os, sys, torch, torch.distributed as dist
rank = int(sys.argv[1])
torch.cuda.set_device(0)
dist.init_process_group("nccl", init_method="tcp://127.0.0.1:" + sys.argv[2],
                        rank=rank, world_size=2)
x = torch.ones(1, device="cuda")
dist.all_reduce(x)
print("sum", x.item(), flush=True)
dist.destroy_process_group()
"""
DUP_PROBE_S = 60.0


def two_ranks_probe_start():
    """Start the two-ranks-on-one-card probe: two processes."""

    port = str(free_port())
    return [subprocess.Popen([sys.executable, "-c", DUP_PROBE, str(r), port],
                             cwd=HERE, stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True)
            for r in range(2)]


def two_ranks_probe_end(procs) -> dict:
    """The probe's outcome: ``refused`` with NCCL's message, ``accepted``
    with the sums, or ``timeout`` (both killed)."""

    outs, timed_out = [], False
    deadline = time.monotonic() + DUP_PROBE_S
    for p in procs:
        try:
            out, err = p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            p.kill()
            out, err = p.communicate()
            timed_out = True
        outs.append((p.returncode, out, err))
    if all(rc == 0 for rc, _, _ in outs):
        return {"outcome": "accepted",
                "sums": [o.strip() for _, o, _ in outs]}
    lines = [ln for _, _, err in outs for ln in err.splitlines()
             if re.search(r"(?i)nccl|duplicate|error", ln)]
    msg = next((ln for ln in lines if "uplicate" in ln), None) or \
        (lines[-1] if lines else "")
    return {"outcome": "timeout" if timed_out else "refused",
            "returncodes": [rc for rc, _, _ in outs], "message": msg[-400:]}


def ring_check() -> dict:
    """Ring attention at the ``ringattn`` pattern's full shape (seq 512 a
    rank, batch 1, 4 heads of 128, bf16) in a 1-rank NCCL group against
    ``ring_attention_reference`` on the card (``RING_BF16_TOL``), and the
    same inputs in f32 (``RING_F32_TOL``)."""

    import torch
    import torch.distributed as dist
    from tpumon_torch.loadgen import ring as RG

    RG.init_process_group(torch.device("cuda"))
    try:
        mesh = RG.make_seq_mesh()
        _, (q, k, v) = RG.make_ring_attention_pattern(mesh, device="cuda")
        out = {"shape": list(q.shape)}
        rtol, atol = RING_BF16_TOL
        got = RG.ring_attention(q, k, v, mesh).float()
        want = RG.ring_attention_reference(q, k, v).float()
        excess = ((got - want).abs() / (atol + rtol * want.abs())).max()
        out["bf16_max_abs_err"] = (got - want).abs().max().item()
        out["bf16_excess"] = excess.item()
        qf, kf, vf = (t.float() for t in (q, k, v))
        err = (RG.ring_attention(qf, kf, vf, mesh)
               - RG.ring_attention_reference(qf, kf, vf)).abs().max().item()
        out["f32_max_abs_err"] = err
        out["nccl_version"] = ".".join(map(str, torch.cuda.nccl.version()))
        if not excess.item() <= 1.0 or not err <= RING_F32_TOL:
            raise AssertionError(f"ring attention against dense: {out}")
        return out
    finally:
        dist.destroy_process_group()


def multi_summary(results, probe, ring) -> dict:
    """The ``multi`` line: each multi-device pattern's steps/s, the
    collective events its final capture read and their ICI bytes, the
    ring check, the NCCL version and the two-ranks probe."""

    rows = {}
    for path in MULTI_PATHS:
        att = (results[path].get("attribution") or {}).get("0") or {}
        rows[path] = {"steps_per_sec": results[path]["steps_per_sec"],
                      "steps": results[path]["steps"],
                      "collective_events": att.get("collective_events"),
                      "ici_bytes": att.get("ici_bytes"),
                      "ici_mb_per_s": att.get("ici_mb_per_s"),
                      "gate": att.get("gate"),
                      "captures_ok": results[path].get("captures_ok")}
    return {"world": 1, "patterns": rows, "ring_check": ring,
            "two_ranks_one_card": probe}


#: eager steps timed for each of the sharded and the plain train step
SHARDED_STEPS = 10
#: back-to-back one-rank all-reduces timed for their host price
NCCL_CALLS = 200


def sharded_check(K, M) -> tuple:
    """The ``sharded`` line: the bench config's sharded train step
    (``model.sharded_train_step`` over ``make_mesh(1)``) in a 1-rank NCCL
    group, against ``train_step`` from the same parameters and tokens,
    both eager: the loss within rtol 2e-2, each attention projection's
    update within UPDATE_RTOL (relative Frobenius error, as in
    ``model_check``), B1-B3 launched on the sharded step (the counts set
    to 0 just before it and read just after); then ``entry()`` on the card
    (finite (4, 32, 128) logits), ``dryrun_multichip(1)`` on the card
    (passes) and ``dryrun_multichip(2)`` (refused: one card).  Returns the
    line and the sharded step's launches."""

    import functools

    import torch
    import torch.distributed as dist
    from tpumon_torch import entry as E
    from tpumon_torch.loadgen import ring as RG

    RG.init_process_group(torch.device("cuda"))
    try:
        cfg = M.ModelConfig.bench()
        mesh = M.make_mesh(1)
        tokens = torch.randint(0, cfg.vocab, (8, cfg.seq_len), device="cuda",
                               generator=torch.Generator("cuda").manual_seed(1))
        steps = {"sharded": M.sharded_train_step(cfg, mesh),
                 "train": functools.partial(M.train_step, cfg)}
        updates, losses, ms = {}, {}, {}
        for name, step in steps.items():
            params = M.init_params(torch.Generator("cuda").manual_seed(0),
                                   cfg)
            if name == "sharded":
                params = M.shard_params(params, mesh)
            before = {n: params["layers"][n].clone() for n in ("wqkv", "wo")}
            torch.cuda.synchronize()
            if name == "sharded":
                for k in K.LAUNCHES:
                    K.LAUNCHES[k] = 0
            params, loss = step(params, tokens)
            torch.cuda.synchronize()
            if name == "sharded":
                launches = {k: K.LAUNCHES[k] for k, _, _ in FLASH_KERNELS}
            up = {n: params["layers"][n].detach() - before[n]
                  for n in before}
            wq, wk, wv = up["wqkv"].chunk(3, dim=-1)
            updates[name] = {"wq": wq, "wk": wk, "wv": wv, "wo": up["wo"]}
            losses[name] = loss.item()
            t0 = time.perf_counter()
            for _ in range(SHARDED_STEPS):
                params, loss = step(params, tokens)
            torch.cuda.synchronize()
            ms[name] = (time.perf_counter() - t0) / SHARDED_STEPS * 1e3
        rel = {n: ((updates["sharded"][n] - b).norm() / b.norm()).item()
               for n, b in updates["train"].items()}
        # the host's price of one of the step's one-rank collectives
        x = torch.ones((1,), dtype=torch.bfloat16, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(NCCL_CALLS):
            with mesh.data.scope():
                dist.all_reduce(x, group=mesh.data.group)
        torch.cuda.synchronize()
        call_ms = (time.perf_counter() - t0) / NCCL_CALLS * 1e3
        out = {"world": 1, "mesh": list(mesh.shape),
               "loss_sharded": losses["sharded"],
               "loss_train": losses["train"],
               "loss_diff": losses["sharded"] - losses["train"],
               "update_rel_err_max": max(rel.values()),
               "update_rel_err": rel, "step_ms_sharded_eager": ms["sharded"],
               "step_ms_train_eager": ms["train"],
               "steps_timed": SHARDED_STEPS, "launches": launches,
               # forward: the embedding's gather, 3 a layer, the logits'
               # reduce; backward: 3 a layer, the logits' gather; the
               # gradient bucket and the loss
               "collectives_per_step": 6 * cfg.n_layers + 5,
               "nccl_allreduce_call_ms": call_ms,
               "nccl_version": ".".join(map(str, torch.cuda.nccl.version()))}
        if not math.isclose(losses["sharded"], losses["train"],
                            rel_tol=2e-2):
            raise AssertionError(f"sharded loss against train_step's: {out}")
        if not max(rel.values()) <= UPDATE_RTOL:
            raise AssertionError(f"sharded updates part from train_step's: "
                                 f"{out}")
        if min(launches.values()) <= 0:
            raise AssertionError(f"a flash kernel never launched on the "
                                 f"sharded step: {launches}")
    finally:
        dist.destroy_process_group()

    fn, args = E.entry()
    with torch.no_grad():
        logits = fn(*args)
    out["entry_logits"] = list(logits.shape)
    if tuple(logits.shape) != (4, 32, 128) or \
            not torch.isfinite(logits.float()).all():
        raise AssertionError(f"entry() logits {tuple(logits.shape)}, "
                             f"finite: {torch.isfinite(logits.float()).all()}")
    t0 = time.monotonic()
    E.dryrun_multichip(1)
    out["dryrun_1_s"] = time.monotonic() - t0
    try:
        E.dryrun_multichip(2)
    except RuntimeError as e:
        out["dryrun_2_refused"] = str(e)
    else:
        raise AssertionError("dryrun_multichip(2) ran on one card")
    return out, launches


@contextlib.contextmanager
def worker_load(K, pattern: str):
    """The ``pattern`` load stepping on a worker thread for the duration of
    the block: batches of 32 steps, each drained by a scalar read, so the
    backlog stays bounded.  Fails if the worker failed."""

    step, state = K.make_pattern(pattern, device="cuda")
    drain(step(state))  # built and launched once first
    stop = threading.Event()
    errors = []

    def worker():
        s = state
        try:
            while not stop.is_set():
                for _ in range(32):
                    s = step(s)
                drain(s)
        except Exception as e:  # surfaced below, after the join
            errors.append(e)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        yield
    finally:
        stop.set()
        t.join(timeout=60)
    if t.is_alive() or errors:
        raise AssertionError(f"{pattern} load thread failed: {errors}")


def drain(state) -> None:
    """One scalar read from each tensor of a pattern's state."""

    from tpumon_torch.loadgen.run import tensor_leaves

    for leaf in tensor_leaves(state):
        leaf.reshape(-1)[0].item()


#: the semantics check's trace knobs: a 0.5 s cadence, not stretched by
#: the duty cap, so that captures follow its phases (its probes run at
#: 0.2 s)
SEMANTICS_TRACE_ENV = {"TPUMON_CUDA_TRACE_INTERVAL": "0.5",
                       "TPUMON_CUDA_TRACE_DUTY": "0"}


#: how long the semantics check waits for the card to go idle before its
#: idle reads, s; how many NVML utilization reads in a row must be 0, and
#: how far apart
IDLE_WAIT_S = 30.0
IDLE_ZEROS = 5
IDLE_POLL_S = 0.2


def compute_apps(uuid: str) -> list:
    """(pid, process name, used MiB) of every compute process nvidia-smi
    lists on the card."""

    r = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid,process_name,"
         "used_gpu_memory,gpu_uuid", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60)
    out = []
    for row in r.stdout.strip().splitlines():
        vals = [v.strip() for v in row.split(",")]
        if len(vals) == 4 and vals[3] == uuid and vals[0].isdigit():
            out.append((int(vals[0]), vals[1], vals[2]))
    return out


def card_others(uuid: str) -> tuple:
    """(what else is on the card, all of nvidia-smi's list): every listed
    compute process but this one, and every process here but this one
    that holds /dev/nvidia-uvm (a CUDA context; NVML alone opens the
    card's node, not that one).  Where nvidia-smi cannot see this PID
    namespace it lists this process under another pid (a container
    runtime's own, pid 1): where this pid is not listed, one listed
    process is taken for this one."""

    from tpumon_torch.procscan import holders_of

    me = os.getpid()
    apps = compute_apps(uuid)
    others = [a for a in apps if a[0] != me]
    if len(others) == len(apps):
        others = others[1:]
    seen = {a[0] for a in others}
    for p in holders_of("/dev/nvidia-uvm"):
        if p.pid != me and p.pid not in seen:
            others.append((p.pid, p.name, None))
    return others, apps


def wait_card_idle(fields) -> dict:
    """Wait, at most IDLE_WAIT_S, until nothing but this process is on the
    card (``card_others``) and NVML's utilization (field 203) has read 0
    IDLE_ZEROS times in a row, IDLE_POLL_S apart.  Returns how long that
    took, what was on the card meanwhile and the reads; raises, naming
    what held the card, if it never went idle."""

    UTIL = int(fields.F.TENSORCORE_UTIL)
    b, i = nvml_open(fields)
    t0 = time.monotonic()
    held, utils, zeros, listed = {}, [], 0, []
    try:
        info = b.chip_info(i)
        while True:
            others, listed = card_others(info.uuid)
            for pid, name, mib in others:
                held[pid] = {"name": name, "used_mib": mib}
            u = b.read_fields(i, [UTIL])[UTIL]
            utils.append(u)
            zeros = zeros + 1 if (u == 0 and not others) else 0
            if zeros >= IDLE_ZEROS:
                break
            if time.monotonic() - t0 > IDLE_WAIT_S:
                raise AssertionError(
                    f"the card never went idle in {IDLE_WAIT_S} s: still "
                    f"on it {others} (nvidia-smi lists {listed}), held "
                    f"meanwhile by {held}, NVML utilization {utils[-12:]}")
            time.sleep(IDLE_POLL_S)
    finally:
        b.close()
    return {"wait_s": round(time.monotonic() - t0, 3), "held_by": held,
            "utils": utils, "this_pid": os.getpid(), "listed": listed}


def semantics_check(K, fields) -> dict:
    """The reference's metric-semantics check on a real device, on the
    port's CudaBackend: the ``mxu`` pattern on a worker thread must drive
    utilization up, a 1 GiB allocation must show in HBM used, and an idle
    device must decay back.  The trace engine serves duty.  Its sample
    lags the device by a capture: a capture opens at one read, closes at
    a later one and is parsed before it is served.  So before the three
    decay reads the check reads on until two captures have landed since
    the device went quiet (the second opened after it), and prints how
    long that took.  Only the ordering is asserted.

    Before it opens its backend it waits for the card to go idle
    (``wait_card_idle``: no other compute process, NVML's utilization 0
    several reads in a row) and prints how long that took and what held
    the card: the earlier legs' processes (the sharded leg's ranks) must
    not be read as this check's idle device."""

    import torch
    from tpumon_torch.backends.cuda import CudaBackend

    idle_wait = wait_card_idle(fields)
    print("semantics idle wait: " + json.dumps(idle_wait), flush=True)

    F = fields.F
    UTIL, HBM_USED, NOT_IDLE = (int(F.TENSORCORE_UTIL), int(F.HBM_USED),
                                int(F.NOT_IDLE_TIME))
    saved = {k: os.environ.get(k) for k in SEMANTICS_TRACE_ENV}
    os.environ.update(SEMANTICS_TRACE_ENV)
    b = CudaBackend()
    b.PROBE_INTERVAL_S = 0.2
    b.open()
    try:
        def read(fid):
            return b.read_fields(0, [fid])[fid]

        def captures():
            return (b.trace_cost_stats() or {}).get("captures_ok", 0.0)

        b.warmup_probes(0)
        read(UTIL)
        # the least of three reads, as after the load: one read can catch
        # a host stall, which the latency probe counts as queueing
        idle = []
        for _ in range(3):
            time.sleep(0.3)
            idle.append(read(UTIL))

        with worker_load(K, "mxu"):
            time.sleep(1.0)
            busy = []
            for _ in range(4):
                busy.append(read(UTIL))
                time.sleep(0.3)
            not_idle_at_busy = read(NOT_IDLE)

        # HBM used is the allocator's live bytes: free the earlier phases'
        # cyclic garbage first, or a collection during the allocation
        # below offsets it
        gc.collect()
        before = read(HBM_USED)
        buf = torch.ones((256, 1024, 1024), device="cuda")  # 1 GiB
        torch.cuda.synchronize()
        after = read(HBM_USED)
        del buf
        quiet, landed = time.monotonic(), captures()

        time.sleep(1.5)
        settle = []
        while captures() < landed + 2:
            if len(settle) >= 20:
                raise AssertionError(f"no trace capture of the idle device "
                                     f"landed in {len(settle)} reads: "
                                     f"{b.trace_cost_stats()}")
            time.sleep(0.3)
            settle.append(read(UTIL))
        settle_s = time.monotonic() - quiet
        decay = []
        for _ in range(3):
            time.sleep(0.3)
            decay.append(read(UTIL))
        trace = b.trace_cost_stats() or {}
    finally:
        b.close()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v
    m = {"idle_util": min(idle), "idle_utils": idle, "busy_utils": busy,
         "busy_util": max(busy), "idle_after": min(decay),
         "idle_after_utils": decay, "settle_utils": settle,
         "settle_s": settle_s,
         "hbm_before": before, "hbm_after": after,
         "not_idle_at_busy": not_idle_at_busy,
         "trace_captures": trace.get("captures_ok"),
         "trace_captures_failed": trace.get("captures_failed"),
         "idle_wait_s": idle_wait["wait_s"]}
    ok = (m["busy_util"] >= 50 and m["idle_util"] <= 20
          and m["idle_after"] <= 25
          and m["busy_util"] > m["idle_util"] + 30
          and m["hbm_after"] - m["hbm_before"] >= 900
          and m["not_idle_at_busy"] is not None
          and m["not_idle_at_busy"] <= 5
          and m["trace_captures"] >= 3)
    if not ok:
        raise AssertionError(f"metric semantics out of order: {m}")
    return m


#: the trace check's capture window, as the reference's scripts use
TRACE_WINDOW_MS = 800.0


def trace_check(K, M, R, train_result) -> dict:
    """Phase 7 of the module docstring: the trace engine's measurements on
    loads whose shape is known.  Returns the trace check's line."""

    import torch
    from tpumon_torch.loadgen.graph import GraphStep
    from tpumon_torch.trace import TraceEngine
    from tpumon_torch.types import gpu_caps

    eng = TraceEngine(capture_ms=TRACE_WINDOW_MS, min_interval_s=0.0)
    caps = gpu_caps(torch.cuda.get_device_name(0))
    steps = [0]  # steps inside the capture in flight

    def capture(step=None):
        steps[0] = 0
        if eng.capture_now(timeout_s=120.0, step=step):
            return eng.latest()[0]
        raise AssertionError(f"a trace capture failed: {eng.last_error}, "
                             f"{eng.stats()}")

    def row(s):
        return {"duty": s.duty, "mxu_frac": s.mxu_frac,
                "vector_frac": s.vector_frac, "data_frac": s.data_frac,
                "infeed": s.infeed_stall, "outfeed": s.outfeed_stall,
                "n_ops": s.n_ops, "exact": s.exact_categories,
                "achieved_tflops": s.achieved_tflops,
                "mxu_tflops": s.mxu_tflops, "window_s": s.window_s}

    try:
        out = {"idle": row(capture())}
        peak = None
        for pattern in ("mxu", "hbm"):
            with worker_load(K, pattern):
                time.sleep(0.5)
                s = capture()
            out[pattern] = row(s)
            peak = peak or s.peak_tflops
        out["mxu"]["peak_tflops"] = peak

        # conv on the session's thread: its ops name the kernels
        step, state = K.make_pattern("conv", device="cuda")
        drain(step(state))
        conv = [state]

        def conv_step():
            conv[0] = step(conv[0])
            steps[0] += 1
            if steps[0] % 32 == 0:
                drain(conv[0])

        out["conv"] = dict(row(capture(conv_step)), steps=steps[0])
        drain(conv[0])

        cfg, params, tokens = R.workload("bench", R.DEFAULT_BATCH,
                                         torch.device("cuda"))
        graph = GraphStep(cfg, params, tokens)
        prog = graph.describe()

        def train():
            # the runner's step: a replay, drained every 32 steps
            _, loss = graph.step()
            steps[0] += 1
            if steps[0] % 32 == 0:
                loss.item()

        tr = capture(train)
        graph.loss.item()
        mxu_flops = tr.mxu_tflops * tr.window_s * 1e12 \
            if tr.mxu_tflops is not None else 0.0
        want = M.train_step_dot_flops(cfg, R.DEFAULT_BATCH)
        per_step = mxu_flops / max(steps[0], 1)
        out["train"] = dict(row(tr), steps=steps[0],
                            mxu_flops_per_step=per_step,
                            dot_flops_per_step=want,
                            flop_ratio=per_step / want,
                            graph_records=len(prog.names),
                            graph_records_matched=prog.matched)
        st = eng.stats()
    finally:
        eng.quiesce()
    out["torn_down_captures"] = torn_captures(graph, steps)
    out["captures_ok"] = st["captures_ok"]
    out["captures_failed"] = st["captures_failed"]
    out["capture_wall_s"] = st["capture_wall_s"]
    out["capture_parse_s"] = st["capture_parse_s"]
    out["families_nonblank"] = train_result["families_nonblank"]
    idle, mxu, hbm, conv, train = (out[k] for k in
                                   ("idle", "mxu", "hbm", "conv", "train"))
    bars = {
        "idle duty <= 0.05": idle["duty"] <= 0.05,
        "mxu duty >= 0.8": mxu["duty"] >= 0.8,
        "mxu share >= 0.9 duty": mxu["mxu_frac"] >= 0.9 * mxu["duty"],
        "mxu records": mxu["n_ops"] > 0,
        "peak from the table": (caps is not None and
                                mxu["peak_tflops"] == caps.bf16_tflops),
        "hbm duty >= 0.8": hbm["duty"] >= 0.8,
        "hbm mxu share <= 0.1": hbm["mxu_frac"] <= 0.1,
        "mxu - hbm >= 0.5": mxu["mxu_frac"] - hbm["mxu_frac"] >= 0.5,
        "conv duty > 0.15": conv["duty"] > 0.15,
        "conv mxu > vector": conv["mxu_frac"] > conv["vector_frac"],
        "train exact": train["exact"] is True,
        "train flop ratio in [0.5, 1.6]": 0.5 <= train["flop_ratio"] <= 1.6,
        "train mxu > 0.05 of the window": train["mxu_frac"] > 0.05,
        "0 failed captures": out["captures_failed"] == 0,
        f">= {TORN_CAPTURES} torn-down captures over replays":
            out["torn_down_captures"]["landed"] >= TORN_CAPTURES,
    }
    out["bars"] = bars
    failed = [k for k, ok in bars.items() if not ok]
    if failed:
        raise AssertionError(f"trace check failed {failed}: {out}")
    return out


#: torn-down captures the trace check takes over the graph's replays, and
#: their window (about 50 replays each)
TORN_CAPTURES = 10
TORN_WINDOW_MS = 100.0


def torn_captures(graph, steps) -> dict:
    """TORN_CAPTURES captures of TORN_WINDOW_MS, each by a new
    ``TraceEngine`` over the graph's replays (each engine closes with
    CUPTI torn down, and the next session opens after the teardown has
    landed): every one must land, record the replays and read them
    exactly.  Returns their count and each capture's duty, mxu share and
    records."""

    from tpumon_torch.trace import TraceEngine

    def step():
        _, loss = graph.step()
        steps[0] += 1
        if steps[0] % 32 == 0:
            loss.item()

    rows = []
    for _ in range(TORN_CAPTURES):
        eng = TraceEngine(capture_ms=TORN_WINDOW_MS, min_interval_s=0.0)
        steps[0] = 0
        try:
            ok = eng.capture_now(timeout_s=60.0, step=step)
        finally:
            eng.quiesce()
        s = eng.latest().get(0)
        if not (ok and s is not None and s.n_ops > 0
                and s.exact_categories):
            raise AssertionError(f"torn-down capture {len(rows)} over graph "
                                 f"replays: landed {ok}, {eng.last_error}, "
                                 f"{s}")
        rows.append({"duty": s.duty, "mxu_frac": s.mxu_frac,
                     "n_ops": s.n_ops, "steps": steps[0]})
    graph.loss.item()
    return {"landed": len(rows), "captures": rows}


def graph_check(M, R) -> dict:
    """The bench train step as a CUDA graph against the eager step from
    the same parameters and tokens: after the graph's warm-up steps (the
    eager side takes as many), 5 steps each; every step's loss within
    rtol 2e-2 (the JAX package's own check), the q, k, v and o
    projections' updates over the 5 steps within UPDATE_RTOL (relative
    Frobenius error), and no growth of allocated memory over the
    replays.  Also the wall ms a step of each (50 steps, a scalar read
    every 32)."""

    import torch
    from tpumon_torch.loadgen.graph import GraphStep

    cfg, params, tokens = R.workload("bench", R.DEFAULT_BATCH,
                                     torch.device("cuda"))
    eager = M.tree_map(lambda t: t.clone(), params)
    graph = GraphStep(cfg, params, tokens)
    for _ in range(graph.steps):
        eager, _ = M.train_step(cfg, eager, tokens)
    names = ("wqkv", "wo")
    start = {side: {n: p["layers"][n].detach().clone() for n in names}
             for side, p in (("graph", graph.params), ("eager", eager))}
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    losses = {"graph": [], "eager": []}
    for _ in range(5):
        losses["graph"].append(graph.step()[1].item())
        eager, loss = M.train_step(cfg, eager, tokens)
        losses["eager"].append(loss.item())
    torch.cuda.synchronize()
    mem1 = torch.cuda.memory_allocated()
    updates = {}
    for side, p in (("graph", graph.params), ("eager", eager)):
        up = {n: p["layers"][n].detach() - start[side][n] for n in names}
        wq, wk, wv = up["wqkv"].chunk(3, dim=-1)
        updates[side] = {"wq": wq, "wk": wk, "wv": wv, "wo": up["wo"]}
    rel = {n: ((updates["graph"][n] - b).norm() / b.norm()).item()
           for n, b in updates["eager"].items()}

    def wall_ms(step) -> float:
        t0 = time.perf_counter()
        for i in range(50):
            _, loss = step()
            if i % 32 == 31:
                loss.item()
        loss.item()
        return (time.perf_counter() - t0) / 50 * 1e3

    out = {"losses": losses, "update_rel_err": rel,
           "allocated_growth_bytes": mem1 - mem0,
           "graph_launches_a_step": graph.launches,
           "eager_step_ms": wall_ms(
               lambda: M.train_step(cfg, eager, tokens)),
           "graph_step_ms": wall_ms(graph.step)}
    if not all(math.isclose(g, e, rel_tol=2e-2)
               for g, e in zip(losses["graph"], losses["eager"])):
        raise AssertionError(f"graph losses part from eager ones: {out}")
    if not max(rel.values()) <= UPDATE_RTOL:
        raise AssertionError(f"graph updates part from eager ones: {out}")
    if mem1 > mem0:
        raise AssertionError(f"replays grew allocated memory: {out}")
    return out


#: the smoke's short paired runs, cell -> seconds a window: the train
#: cell and one pattern, each BENCH_PAIRS pairs
BENCH_CELLS = {"train": 2.0, "mxu": 1.0}
BENCH_PAIRS = 4


def bench_gpu_check() -> dict:
    """``bench gpu``: the paired protocol (``loadgen.bench_gpu``) on the
    train cell and one pattern, each record with every
    ``OVERHEAD_RECORD_KEYS`` key from BENCH_PAIRS completed pairs."""

    import torch
    from tpumon_torch.loadgen import bench_gpu as B
    from tpumon_torch.loadgen.run import device_name

    out = {}
    dev = torch.device("cuda")
    for cell, seconds in BENCH_CELLS.items():
        work = B.warm_workload(cell, dev, warmup_s=1.0)
        rec = B.paired(work, BENCH_PAIRS, seconds,
                       device_name=device_name(dev))
        del work
        missing = [k for k in B.OVERHEAD_RECORD_KEYS if k not in rec]
        if missing or rec["pairs_completed"] != BENCH_PAIRS:
            raise AssertionError(f"bench gpu {cell}: keys {missing} missing "
                                 f"or pairs short: {rec}")
        out[cell] = {k: rec.get(k) for k in (
            *B.OVERHEAD_RECORD_KEYS, "bare_steps_per_sec",
            "monitored_steps_per_sec", "overhead_monitored_faster",
            "overhead_underpowered", "overhead_insufficient_pairs",
            "families_nonblank")}
    return out


# -- the out-of-band NVML source ---------------------------------------------

#: where the CUDA toolkit's headers are (nvml.h ships with it)
CUDA_INCLUDE = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                            "include")
#: what ``nvml check`` queries, in this order
SMI_QUERY = ("name,uuid,pci.bus_id,driver_version,power.limit,power.draw,"
             "temperature.gpu,clocks.sm,clocks.mem,memory.used,memory.total")
#: symbol groups each NVML phase reads through
NVML_GROUPS = ("identity", "pci", "clocks", "power", "memory", "thermal",
               "utilization", "field_values")


def nvml_abi() -> dict:
    """``nvml abi``: compile the port's ABI probe
    (``backends.nvml.abi_probe_source``) against the toolkit's ``nvml.h``
    with ``cc`` (``nvcc`` where there is none) into ``build/``, run it,
    and hold every ``sizeof``, field offset and constant it prints to the
    ctypes mirrors'."""

    import shutil
    from tpumon_torch.backends import nvml as N

    header = os.path.join(CUDA_INCLUDE, "nvml.h")
    if not os.path.exists(header):
        raise AssertionError(f"no nvml.h at {header}")
    out_dir = os.path.join(HERE, "build", "nvml_abi")
    os.makedirs(out_dir, exist_ok=True)
    src = os.path.join(out_dir, "nvml_abi.c")
    exe = os.path.join(out_dir, "nvml_abi")
    with open(src, "w") as f:
        f.write(N.abi_probe_source())
    cc = shutil.which("cc") or shutil.which("gcc") or "nvcc"
    subprocess.run([cc, "-I", CUDA_INCLUDE, "-o", exe, src], check=True,
                   capture_output=True, text=True, timeout=120)
    got = N.parse_abi_probe(subprocess.run(
        [exe], check=True, capture_output=True, text=True,
        timeout=60).stdout)
    want = N.abi_expected()
    diff = {k: (got.get(k), v) for k, v in want.items() if got.get(k) != v}
    if diff:
        raise AssertionError(f"nvml.h (got) and the ctypes mirrors (want) "
                             f"differ: {diff}")
    return {"header": header, "compiler": os.path.basename(cc),
            "checked": len(want)}


def nvml_open(fields):
    """The NVML backend, and the NVML index of the device torch calls
    ``cuda:0``, matched by UUID (NVML orders by PCI bus and ignores
    ``CUDA_VISIBLE_DEVICES``)."""

    from tpumon_torch.backends.nvml import NvmlBackend
    from tpumon_torch.loadgen.bench_gpu import nvml_index

    b = NvmlBackend()
    b.open()
    try:
        missing = [g for g in NVML_GROUPS if g not in b.capabilities()]
        if missing:
            raise AssertionError(f"NVML symbol groups unresolved: {missing}")
        return b, nvml_index(b)
    except BaseException:
        b.close()
        raise


def smi(uuid: str) -> dict:
    """One ``nvidia-smi -i <uuid> --query-gpu=SMI_QUERY`` row; a value it
    does not show ("[N/A]", "[Not Supported]") is None."""

    row = subprocess.run(
        ["nvidia-smi", "-i", uuid, f"--query-gpu={SMI_QUERY}",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    vals = [v.strip() for v in row.split(",")]
    return {k: (None if v.startswith("[") else v)
            for k, v in zip(SMI_QUERY.split(","), vals)}


def nvml_check(fields, b, i) -> dict:
    """``nvml check``: the NVML backend against one ``nvidia-smi`` row of
    the same device, read between two NVML reads of the dynamic fields
    (each value must agree with one of them): strings equal, power limit
    within 1 W, temperature within 2 C, clocks within 5%, memory total
    equal and used within 64 MiB, power draw within max(15 W, 10%).  A
    value nvidia-smi does not show is not compared.  Also one sweep over
    the whole catalog: ``families_nonblank`` counts the exporter's
    families with a value (at least 20)."""

    F = fields.F
    info = b.chip_info(i)
    dyn = [int(F.POWER_USAGE), int(F.CORE_TEMP), int(F.TENSORCORE_CLOCK),
           int(F.HBM_CLOCK), int(F.HBM_USED), int(F.HBM_TOTAL)]
    before = b.read_fields(i, dyn)
    row = smi(info.uuid)
    after = b.read_fields(i, dyn)

    def near(key, fid, tol):
        if row[key] is None:
            return True
        want = float(row[key])
        reads = [r[fid] for r in (before, after)]
        return any(v is not None and abs(v - want) <= tol(want)
                   for v in reads)

    checks = {
        "name": row["name"] is None or row["name"] == info.name,
        "uuid": row["uuid"] is None or row["uuid"] == info.uuid,
        "pci.bus_id": (row["pci.bus_id"] is None or
                       row["pci.bus_id"].lower() == info.pci.bus_id.lower()),
        "driver_version": (row["driver_version"] is None or
                           row["driver_version"] == b.versions().driver),
        "power.limit": (row["power.limit"] is None or (
            info.power_limit_w is not None and
            abs(float(row["power.limit"]) - info.power_limit_w) <= 1.0)),
        "temperature.gpu": near("temperature.gpu", int(F.CORE_TEMP),
                                lambda w: 2.0),
        "clocks.sm": near("clocks.sm", int(F.TENSORCORE_CLOCK),
                          lambda w: 0.05 * w),
        "clocks.mem": near("clocks.mem", int(F.HBM_CLOCK),
                           lambda w: 0.05 * w),
        "memory.total": near("memory.total", int(F.HBM_TOTAL),
                             lambda w: 0.0),
        "memory.used": near("memory.used", int(F.HBM_USED),
                            lambda w: 64.0),
        "power.draw": near("power.draw", int(F.POWER_USAGE),
                           lambda w: max(15.0, 0.1 * w)),
    }
    sweep = b.read_fields(i, sorted(f for f in fields.CATALOG
                                    if f < fields.BURST_ID_BASE))
    from tpumon_torch.loadgen.bench_gpu import exporter_fields

    families = exporter_fields()
    nonblank = [fields.CATALOG[f].prom_name for f in families
                if sweep.get(f) is not None]
    out = {"nvml_index": i, "smi": row, "nvml_before": before,
           "nvml_after": after, "checks": checks,
           "capabilities": b.capabilities(),
           "families_nonblank": len(nonblank), "families": nonblank,
           "fields_nonblank": sum(v is not None for v in sweep.values()),
           "sweep": sweep}
    failed = [k for k, ok in checks.items() if not ok]
    if failed or len(nonblank) < 20:
        raise AssertionError(f"nvml check failed {failed} (families "
                             f"non-blank {len(nonblank)}): {out}")
    return out


def nvml_load(K, fields, b, i) -> dict:
    """``nvml load``: under the ``mxu`` pattern on a worker thread, NVML's
    utilization (203) reads >= 50, and <= 20 idle (the least of three
    reads); a 1 GiB allocation raises HBM used (251) by >= 900 MiB; the
    energy counter's (156) rise over a window, over the window, lies
    within 15% of the mean of the power reads (155) in it; and the trace
    engine's duty of a capture in the same window is printed beside
    203."""

    import torch
    from tpumon_torch.trace import TraceEngine

    F = fields.F
    UTIL, USED, POWER, ENERGY = (int(F.TENSORCORE_UTIL), int(F.HBM_USED),
                                 int(F.POWER_USAGE), int(F.TOTAL_ENERGY))

    def read(fid):
        v = b.read_fields(i, [fid])[fid]
        if v is None:
            raise AssertionError(f"NVML field {fid} blank")
        return v

    idle = []
    for _ in range(3):
        time.sleep(0.4)
        idle.append(read(UTIL))
    eng = TraceEngine(capture_ms=800.0, min_interval_s=0.0)
    try:
        with worker_load(K, "mxu"):
            time.sleep(1.0)
            t0, e0 = time.monotonic(), read(ENERGY)
            power, busy = [], []
            while time.monotonic() - t0 < 4.0:
                power.append(read(POWER))
                busy.append(read(UTIL))
                time.sleep(0.1)
            e1, t1 = read(ENERGY), time.monotonic()
            if not eng.capture_now(timeout_s=120.0):
                raise AssertionError(f"trace capture failed: "
                                     f"{eng.last_error}")
            duty = max(s.duty for s in eng.latest().values())
    finally:
        eng.quiesce()
    gc.collect()
    torch.cuda.empty_cache()  # the allocation below must reach the driver
    torch.cuda.synchronize()
    before = read(USED)
    buf = torch.ones((256, 1024, 1024), device="cuda")  # 1 GiB
    torch.cuda.synchronize()
    after = read(USED)
    del buf
    torch.cuda.empty_cache()
    energy_w = (e1 - e0) / 1000.0 / (t1 - t0)
    mean_w = sum(power) / len(power)
    m = {"idle_util": min(idle), "idle_utils": idle,
         "busy_util": max(busy), "busy_utils": busy,
         "trace_duty": duty, "hbm_used_before": before,
         "hbm_used_after": after, "energy_w": energy_w,
         "power_mean_w": mean_w, "power_reads": len(power),
         "energy_over_power": energy_w / mean_w}
    ok = (m["busy_util"] >= 50 and m["idle_util"] <= 20
          and after - before >= 900
          and abs(energy_w - mean_w) <= 0.15 * mean_w)
    if not ok:
        raise AssertionError(f"nvml load out of order: {m}")
    return m


#: ``nvml cost``: sweeps at 1 Hz for this many seconds
COST_SECONDS = 20


def nvml_cost(fields, b, i) -> dict:
    """``nvml cost``: ``loadgen.bench_gpu.tier_1hz``, the exporter's field
    list swept through the NVML backend at 1 Hz for ``COST_SECONDS`` s on
    an otherwise idle card: each sweep's wall ms, the process's CPU share
    over the run, and the wall ms a sweep spends in each NVML entry
    point (``call_ms``)."""

    from tpumon_torch.loadgen.bench_gpu import exporter_fields, tier_1hz

    return tier_1hz(b, i, exporter_fields(), COST_SECONDS)


def nvml_phases(K, fields) -> None:
    """The four NVML phases, each printed on its own line."""

    print("nvml abi: " + json.dumps(nvml_abi()))
    b, i = nvml_open(fields)
    try:
        print("nvml check: " + json.dumps(nvml_check(fields, b, i)))
        print("nvml cost: " + json.dumps(nvml_cost(fields, b, i)))
        print("nvml load: " + json.dumps(nvml_load(K, fields, b, i)))
    finally:
        b.close()


# -- the exporter daemon ------------------------------------------------------

#: the daemon phase's windows, s: the 1 Hz scrape window, the workload's
#: stepping window around it, and each footprint run after a 2 s settle
DAEMON_SCRAPE_S = 30
DAEMON_WORKLOAD_S = 38
FOOTPRINT_S = 8
#: the node-exporter budget the reference's ``bench_footprint`` holds the
#: exporter to (``bench.py:2352-2358``): RSS KiB and CPU percent
FOOTPRINT_BUDGET = {"rss_kib": 50 * 1024, "cpu_percent": 20.0}
#: the pod the map file gives the card
POD = {"pod": "train-smoke", "namespace": "ml", "container": "worker"}
POD_LABELS = {"pod_name": POD["pod"], "pod_namespace": POD["namespace"],
              "container_name": POD["container"]}
LABEL_RE = re.compile(r'(\w+)="((?:[^"\\]|\\.)*)"')


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def http_get(port: int, path: str, gz: bool = False):
    """(status, headers, body bytes, wall ms) of one GET on localhost."""

    import http.client

    t0 = time.monotonic()
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    try:
        conn.request("GET", path,
                     headers={"Accept-Encoding": "gzip"} if gz else {})
        r = conn.getresponse()
        body = r.read()
        return (r.status, dict(r.getheaders()), body,
                1000.0 * (time.monotonic() - t0))
    finally:
        conn.close()


def proc_stat(pid: int) -> dict:
    """A process's CPU seconds (user + system), RSS KiB and thread count
    from ``/proc``."""

    with open(f"/proc/{pid}/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    status = {}
    with open(f"/proc/{pid}/status") as f:
        for line in f:
            k, _, v = line.partition(":")
            status[k] = v.strip()
    return {"cpu_s": (int(fields[11]) + int(fields[12])) /
            os.sysconf("SC_CLK_TCK"),
            "rss_kib": int(status["VmRSS"].split()[0]),
            "threads": int(status["Threads"])}


def samples(text: str) -> list:
    """(series id, family, labels, value, valid) of every sample line; a
    line the exporter's merge would drop as malformed has valid False."""

    from tpumon_torch.exporter.textmerge import parse_sample

    out = []
    for ln in text.splitlines():
        if not ln or ln.startswith("#"):
            continue
        sid = parse_sample(ln)
        if sid is None:
            out.append((ln, ln.split("{", 1)[0], {}, None, False))
            continue
        labels = dict(LABEL_RE.findall(sid[len(sid.split("{", 1)[0]):]))
        out.append((sid, sid.split("{", 1)[0], labels,
                    ln[len(sid):].split()[0], True))
    return out


def read_drop(path: str):
    """The drop file's (families with a sample, series ids, malformed
    lines, mtime), or None before it exists."""

    try:
        with open(path) as f:
            text = f.read()
        mtime = os.stat(path).st_mtime
    except FileNotFoundError:
        return None
    rows = samples(text)
    return ({r[1] for r in rows if r[4]}, {r[0] for r in rows if r[4]},
            sum(not r[4] for r in rows), mtime, rows)


def spawn(args, env, log_path, stdout=subprocess.DEVNULL):
    """A ``python -m`` child of this checkout, its stderr to a file."""

    return spawn_argv([sys.executable, "-m", *args], env, log_path, stdout)


def spawn_argv(argv, env, log_path, stdout=subprocess.DEVNULL):
    """A child of this checkout by its whole argv, its stderr to a file."""

    err = open(log_path, "w")
    try:
        return subprocess.Popen(list(argv), cwd=HERE, env=env, stdout=stdout,
                                stderr=err, text=True)
    finally:
        err.close()


def agent_argv(native: bool) -> list:
    """The command of an agent: the port's native ``gpu-hostengine`` built
    from this checkout (``_build.native``), or its Python agent."""

    if native:
        from tpumon_torch import _build

        return [str(_build.native("gpu-hostengine"))]
    return [sys.executable, "-m", "tpumon_torch.hostengine"]


def stop_proc(proc, sig=None, timeout: float = 5.0):
    """Signal a child (SIGTERM by default) and reap it; kill it past the
    timeout.  Returns (exit code, seconds to exit), code None if killed."""

    import signal

    if proc.poll() is not None:
        return proc.returncode, 0.0
    t0 = time.monotonic()
    proc.send_signal(sig or signal.SIGTERM)
    try:
        rc = proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        rc = None
    return rc, time.monotonic() - t0


#: libraries a process with a CUDA context maps (the runtime, and the
#: frameworks that create one) besides libcuda itself
CONTEXT_LIBS = ("libcudart", "libtorch", "libc10_cuda", "libjax",
                "libcublas")


def cuda_context_marks(pid: int) -> dict:
    """What a process's ``/proc/<pid>/maps`` says about a CUDA context:
    the runtime libraries it maps (CONTEXT_LIBS), whether it maps
    ``/dev/nvidia-uvm`` (a context's unified memory), and whether it maps
    ``libcuda``."""

    with open(f"/proc/{pid}/maps") as f:
        paths = {ln.split()[-1] for ln in f if len(ln.split()) >= 6}
    return {"libs": sorted({lib for lib in CONTEXT_LIBS for p in paths
                            if lib in os.path.basename(p)}),
            "uvm_mapped": [p for p in sorted(paths)
                           if p.startswith("/dev/nvidia-uvm")],
            "libcuda": any(os.path.basename(p).startswith("libcuda.")
                           for p in paths)}


#: a process that only loads NVML and initializes it (``nvmlInit_v2``,
#: or ``nvmlInitWithFlags`` with the flags given), then prints what its
#: maps say and its RSS before and after the init: the control for the
#: daemon's maps and footprint
NVML_INIT_ALONE = """
import ctypes, json, os, sys
sys.path.insert(0, sys.argv[1])
from chip_smoke import cuda_context_marks, proc_stat
lib = ctypes.CDLL(os.environ.get("TPUMON_NVML_PATH") or "libnvidia-ml.so.1")
before = proc_stat(os.getpid())["rss_kib"]
if sys.argv[2] == "v2":
    rc = lib.nvmlInit_v2()
else:
    rc = lib.nvmlInitWithFlags(ctypes.c_uint(int(sys.argv[2])))
marks = cuda_context_marks(os.getpid())
after = proc_stat(os.getpid())["rss_kib"]
lib.nvmlShutdown()
print(json.dumps(dict(marks, init=sys.argv[2], rc=rc, rss_kib_before=before,
                      rss_kib_after=after)))
"""
#: NVML_INIT_FLAG_NO_GPUS: initialize without attaching any GPU
NVML_INIT_FLAG_NO_GPUS = 1


def nvml_init_marks(env, init: str = "v2") -> dict:
    r = subprocess.run([sys.executable, "-c", NVML_INIT_ALONE, HERE, init],
                       env=env, capture_output=True, text=True, timeout=60,
                       check=True)
    return json.loads(r.stdout.strip().splitlines()[-1])


def quantile(xs, q: float):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(q * len(xs)))] if xs else None


def footprint(env, work: str, delay_ms: int) -> dict:
    """``bench_footprint``'s exporter leg on the port: the daemon with
    pod labels and no HTTP port at ``delay_ms``, its RSS and CPU share
    over FOOTPRINT_S after a 2 s settle, against the budget."""

    proc = spawn(["tpumon_torch.exporter.main", "-o",
                  os.path.join(work, f"foot{delay_ms}.prom"), "-d",
                  str(delay_ms), "--pod-labels", "--port", "0",
                  "--wait-for-tpu", "30"], env,
                 os.path.join(work, f"foot{delay_ms}.err"))
    try:
        time.sleep(2.0)
        s0, t0 = proc_stat(proc.pid), time.monotonic()
        time.sleep(FOOTPRINT_S)
        s1, t1 = proc_stat(proc.pid), time.monotonic()
    finally:
        rc, _ = stop_proc(proc)
    out = {"delay_ms": delay_ms, "rss_kib": s1["rss_kib"],
           "cpu_percent": round(100.0 * (s1["cpu_s"] - s0["cpu_s"]) /
                                (t1 - t0), 3),
           "seconds": round(t1 - t0, 3), "exit": rc}
    out["within_budget"] = (out["rss_kib"] <= FOOTPRINT_BUDGET["rss_kib"] and
                            out["cpu_percent"] <=
                            FOOTPRINT_BUDGET["cpu_percent"])
    if rc != 0:
        raise AssertionError(f"footprint daemon exited {rc}: {out}")
    return out


def pod_daemon(env, work: str, inp: str, map_file: str) -> dict:
    """The standalone pod-attribution daemon over a textfile of the split
    layout (the exporter without ``--pod-labels``): ``/gpu/metrics`` must
    serve the pod labels, and the output file, ``/gpu/metrics`` and
    ``/tpu/metrics`` must all equal the enriched input."""

    import signal
    from tpumon_torch.exporter.pod_attrib import PodAttributor

    with open(inp) as f:
        want = PodAttributor(map_file=map_file).enrich(f.read())
    outp = os.path.join(work, "gpu-pod.prom")
    port = free_port()
    proc = spawn(["tpumon_torch.exporter.pod_main", "--input", inp,
                  "--output", outp, "--port", str(port), "--poll", "0.2"],
                 env, os.path.join(work, "pod.err"))
    try:
        body = b""
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline and b"pod_name=" not in body:
            try:
                body = http_get(port, "/gpu/metrics")[2]
            except OSError:
                time.sleep(0.2)
        tpu = http_get(port, "/tpu/metrics")
        with open(outp) as f:
            published = f.read()
    finally:
        rc, _ = stop_proc(proc, signal.SIGINT)
    checks = {"gpu_metrics_pod_labels": b'pod_name="train-smoke"' in body,
              "gpu_metrics_is_enriched_input": body.decode() == want,
              "tpu_metrics_is_enriched_input": tpu[2].decode() == want,
              "output_file_is_enriched_input": published == want,
              "exit_0_on_sigint": rc == 0}
    out = {"checks": checks, "bytes": len(want),
           "labeled_samples": want.count("pod_name=")}
    if not all(checks.values()):
        raise AssertionError(f"pod daemon check failed: {out}")
    return out


def daemon_phase(fields) -> dict:
    """``daemon``: the port's exporter daemon over NVML beside the bench
    train workload, as the DaemonSet deploys it (the counterpart of the
    reference's ``bench_deployment_soak`` and ``bench_footprint``).

    A. The workload, ``python -m tpumon_torch.loadgen.run --size bench
       --self-monitor --monitor-output <tmpfs>/drop/embed.prom`` (the CUDA
       graph step, B1-B3), in its own process, whose launch counts start
       at 0 and are read from its JSON line at its end.
    B. The daemon, ``python -m tpumon_torch.exporter.main -o gpu.prom -d
       1000 --port P --pod-labels --merge-textfile '<tmpfs>/drop/*.prom'
       --wait-for-tpu 30``, with ``TPUMON_POD_MAP_FILE`` taking the card's
       NVML UUID to a pod.
    C. Scrapes at 1 Hz for DAEMON_SCRAPE_S, plain and gzip in turn, and
       ``/healthz`` each second; fails unless every scrape is 200 and every
       sample line valid, ``/healthz`` 200 from the first sweep on, at
       least 20 of the daemon's own NVML families per card carry the map's
       pod labels (and every sample of those families for the card does,
       or is the drop file's own series), every family of the drop file
       the daemon does not serve itself is served, no series appears
       twice, the drop file names the card with NVML's ``uuid`` and
       ``model``, a gzip body equals the plain body of the same sweep, the
       daemon holds no CUDA context (its maps show no CUDA runtime, torch
       or JAX library and no ``/dev/nvidia-uvm`` mapping, where the
       workload's show both; ``libcuda`` only where ``nvmlInit_v2`` alone
       maps it too, as NVML 580's does; and it is not among the
       card's compute processes that NVML lists), and SIGTERM ends it
       with exit 0 within 5 s, its textfile whole.
    D. Printed: scrape wall p50/p99, the daemon's sweep wall and phases,
       its CPU share over the window from ``/proc`` beside its own
       ``tpumon_exporter_cpu_percent``, its RSS, the drop file's age at
       each scrape, malformed drop lines, the workload's steps/s and
       captures landed and refused.
    E. ``footprint``: the daemon at ``-d 100`` and at ``-d 1000`` with pod
       labels, RSS and CPU share against the node-exporter budget.
    F. ``pod daemon``: ``tpumon_torch.exporter.pod_main`` over the split
       layout's textfile (the daemon without ``--pod-labels``)."""

    import gzip
    import shutil
    import tempfile
    import torch
    from tpumon_torch.exporter.promtext import parse_families

    b, i = nvml_open(fields)
    try:
        info = b.chip_info(i)
    finally:
        b.close()
    props = torch.cuda.get_device_properties(0)
    labels_of_card = {
        "nvml_uuid": info.uuid, "nvml_model": info.name,
        "torch_uuid": "GPU-" + str(getattr(props, "uuid", "")),
        "torch_model": props.name}
    shm = "/dev/shm" if os.access("/dev/shm", os.W_OK) else None
    work = tempfile.mkdtemp(prefix="tpumon-daemon-", dir=shm)
    drop_dir = os.path.join(work, "drop")
    os.makedirs(drop_dir)
    drop = os.path.join(drop_dir, "embed.prom")
    map_file = os.path.join(work, "pods.json")
    with open(map_file, "w") as f:
        json.dump({info.uuid: POD}, f)
    env = dict(os.environ, PYTHONPATH=HERE, TPUMON_POD_MAP_FILE=map_file)
    for k in ("TPUMON_BACKEND", "TPUMON_CHIPS"):
        env.pop(k, None)
    out = {"tmpfs": shm is not None, "card": labels_of_card}
    daemon = workload = None
    try:
        # the split layout's exporter, once: the daemon's own families
        # (no merge), and phase F's input
        split = os.path.join(work, "split.prom")
        r = subprocess.run(
            [sys.executable, "-m", "tpumon_torch.exporter.main",
             "--oneshot", "-o", split, "--wait-for-tpu", "30"], cwd=HERE,
            env=env, capture_output=True, text=True, timeout=120)
        if r.returncode != 0:
            raise AssertionError(f"daemon --oneshot exited {r.returncode}: "
                                 f"{r.stderr[-2000:]}")
        own = {f for f, n in parse_families(r.stdout).items() if n > 0}
        own_tpu = {f for f in own if f.startswith("tpu_")}
        out["oneshot_families"] = len(own_tpu)

        port = free_port()
        daemon = spawn(["tpumon_torch.exporter.main", "-o",
                        os.path.join(work, "gpu.prom"), "-d", "1000",
                        "--port", str(port), "--pod-labels",
                        "--merge-textfile", os.path.join(drop_dir, "*.prom"),
                        "--wait-for-tpu", "30"], env,
                       os.path.join(work, "daemon.err"))
        workload = spawn(["tpumon_torch.loadgen.run", "--size", "bench",
                          "--self-monitor", "--monitor-output", drop,
                          "--seconds", str(DAEMON_WORKLOAD_S), "--json"],
                         env, os.path.join(work, "workload.err"),
                         stdout=subprocess.PIPE)
        t_start = time.monotonic()
        while True:  # the daemon's first sweep
            try:
                if http_get(port, "/healthz")[0] == 200:
                    break
            except OSError:
                pass
            if daemon.poll() is not None or \
                    time.monotonic() - t_start > 60:
                raise AssertionError("the daemon never answered /healthz "
                                     "200")
            time.sleep(0.1)
        out["first_sweep_s"] = round(time.monotonic() - t_start, 3)
        failures = []
        healthz_wait = []  # /healthz while the workload sets up
        while read_drop(drop) is None:
            if workload.poll() is not None or \
                    time.monotonic() - t_start > 180:
                raise AssertionError("the workload's drop file never "
                                     "landed")
            healthz_wait.append(http_get(port, "/healthz")[0])
            time.sleep(0.2)
        out["drop_landed_s"] = round(time.monotonic() - t_start, 3)
        time.sleep(1.0)  # one daemon sweep past the landing
        if any(h != 200 for h in healthz_wait):
            failures.append(f"/healthz during set-up: {healthz_wait}")
        scrape_ms, ages, healthz, cpu_self = [], [], [], []
        sweep_ms, phases = [], {}
        drop_only, shared, pod_fams = set(), set(), []
        malformed_drop = 0
        gz_checked = 0
        prev = read_drop(drop)
        first = prev[4]
        card = [r for r in first if r[4] and r[1].startswith("tpu_")
                and r[2].get("chip") == "0"]
        if not card:
            raise AssertionError("the drop file has no per-chip sample")
        drop_labels = {"uuid": card[0][2].get("uuid"),
                       "model": card[0][2].get("model")}
        out["drop_labels"] = drop_labels
        if drop_labels != {"uuid": info.uuid, "model": info.name}:
            failures.append(f"drop file names the card {drop_labels}, NVML "
                            f"{info.uuid!r} {info.name!r}")
        s0, t0 = proc_stat(daemon.pid), time.monotonic()
        threads0 = s0["threads"]
        for k in range(DAEMON_SCRAPE_S):
            tick = time.monotonic()
            gz = k % 2 == 1
            plain_before = http_get(port, "/metrics")[2] if gz else None
            status, hdrs, body, ms = http_get(port, "/metrics", gz=gz)
            if gz:
                plain_after = http_get(port, "/metrics")[2]
                if hdrs.get("Content-Encoding") != "gzip":
                    failures.append(f"scrape {k}: no gzip body")
                else:
                    body = gzip.decompress(body)
                    if plain_before == plain_after:
                        gz_checked += 1
                        if body != plain_before:
                            failures.append(f"scrape {k}: gzip body is not "
                                            f"the plain body")
            now = read_drop(drop)
            ages.append(time.time() - now[3])
            malformed_drop += now[2]
            scrape_ms.append(ms)
            hz = http_get(port, "/healthz")[0]
            healthz.append(hz)
            if status != 200 or hz != 200:
                failures.append(f"scrape {k}: /metrics {status}, /healthz "
                                f"{hz}")
            rows = samples(body.decode())
            bad = [r[0] for r in rows if not r[4]]
            if bad:
                failures.append(f"scrape {k}: malformed lines {bad[:3]}")
            sids = [r[0] for r in rows]
            dups = {x for x in sids if sids.count(x) > 1}
            if dups:
                failures.append(f"scrape {k}: series twice {sorted(dups)[:3]}")
            fams = {r[1] for r in rows}
            # what the daemon serves itself: its NVML families (those
            # with pod labels) and its self families
            served = own | {r[1] for r in rows if "pod_name" in r[2] or
                            r[1].startswith("tpumon_exporter_")}
            need = (prev[0] & now[0]) - served
            drop_only |= need
            if need - fams:
                failures.append(f"scrape {k}: drop families missing "
                                f"{sorted(need - fams)}")
            labeled, unlabeled = set(), set()
            for sid, fam, lab, val, ok in rows:
                if fam not in own_tpu or lab.get("uuid") != info.uuid:
                    continue
                if "pod_name" in lab:
                    labeled.add(fam)
                    if any(lab.get(a) != v for a, v in POD_LABELS.items()):
                        failures.append(f"scrape {k}: wrong pod labels {sid}")
                else:
                    unlabeled.add(fam)
                    if sid not in prev[1] | now[1]:
                        failures.append(f"scrape {k}: daemon series without "
                                        f"pod labels {sid}")
            shared |= labeled & unlabeled
            pod_fams.append(len(labeled))
            if len(labeled) < 20:
                failures.append(f"scrape {k}: {len(labeled)} NVML families "
                                f"with pod labels")
            for sid, fam, lab, val, ok in rows:
                if fam == "tpumon_exporter_cpu_percent":
                    cpu_self.append(float(val))
                elif fam == "tpumon_exporter_scrape_duration_seconds":
                    sweep_ms.append(1000.0 * float(val))
                elif fam == "tpumon_exporter_sweep_phase_seconds":
                    phases.setdefault(lab["phase"], []).append(
                        1000.0 * float(val))
            prev = now
            time.sleep(max(0.0, 1.0 - (time.monotonic() - tick)))
        s1, t1 = proc_stat(daemon.pid), time.monotonic()
        context = {"daemon": cuda_context_marks(daemon.pid),
                   "workload": cuda_context_marks(workload.pid),
                   "nvml_init_alone": nvml_init_marks(env),
                   "nvml_init_no_gpus": nvml_init_marks(
                       env, str(NVML_INIT_FLAG_NO_GPUS))}
        maps = context["daemon"]
        mapped = maps["libs"] + maps["uvm_mapped"]
        apps = subprocess.run(
            ["nvidia-smi", "--query-compute-apps=pid,process_name",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.split("\n")
        app_pids = {int(a.split(",")[0]) for a in apps
                    if a.split(",")[0].strip().isdigit()}
        # a CUDA context maps the runtime (libcudart, torch's libraries)
        # and /dev/nvidia-uvm; the workload's maps must show it, or the
        # check tells nothing.  libcuda alone is NVML's where nvmlInit_v2
        # by itself maps it (NVML 580's does)
        if mapped:
            failures.append(f"the daemon maps {mapped}")
        if maps["libcuda"] and not context["nvml_init_alone"]["libcuda"]:
            failures.append("the daemon maps libcuda, nvmlInit_v2 alone "
                            "does not")
        wl_marks = context["workload"]
        if not (wl_marks["uvm_mapped"] and wl_marks["libs"]):
            failures.append(f"the workload's maps show no CUDA context: "
                            f"{wl_marks}")
        # NVML's compute processes, where its pids are this namespace's
        # (the workload's among them); else the maps check stands alone
        apps_usable = workload.pid in app_pids
        if daemon.pid in app_pids:
            failures.append(f"compute processes {sorted(app_pids)} hold "
                            f"the daemon {daemon.pid}")
        if gz_checked == 0:
            failures.append("no gzip scrape was bracketed by one sweep")
        rc, exit_s = stop_proc(daemon)
        with open(os.path.join(work, "gpu.prom")) as f:
            final = f.read()
        final_rows = samples(final)
        whole = (final.endswith("\n") and final_rows and
                 all(r[4] for r in final_rows) and
                 not [n for n in os.listdir(work) if n.endswith(".swp")])
        if rc != 0 or exit_s > 5.0 or not whole:
            failures.append(f"SIGTERM: exit {rc} in {exit_s:.2f} s, "
                            f"textfile whole {whole}")
        with open(os.path.join(work, "daemon.err")) as f:
            daemon_err = f.read()
        try:
            wl_out, _ = workload.communicate(timeout=180)
        except subprocess.TimeoutExpired:
            workload.kill()
            wl_out, _ = workload.communicate()
        if workload.returncode != 0:
            with open(os.path.join(work, "workload.err")) as f:
                raise AssertionError(f"workload exited {workload.returncode}"
                                     f": {f.read()[-2000:]}")
        wl = json.loads(wl_out.strip().splitlines()[-1])
        loss = wl.get("final_loss")
        if loss is None or not math.isfinite(loss):
            failures.append(f"workload final loss {loss}")
        window = t1 - t0
        out.update({
            "scrapes": len(scrape_ms), "gzip_checked": gz_checked,
            "healthz_200": sum(h == 200 for h in healthz),
            "healthz_during_setup": len(healthz_wait),
            "nvml_families_with_pod_labels_min": min(pod_fams),
            "drop_only_families": sorted(drop_only),
            "shared_families_twice": sorted(shared),
            "scrape_ms_p50": quantile(scrape_ms, 0.5),
            "scrape_ms_p99": quantile(scrape_ms, 0.99),
            "sweep_ms_p50": quantile(sweep_ms, 0.5),
            "sweep_ms_max": max(sweep_ms) if sweep_ms else None,
            "sweep_phase_ms_p50": {ph: quantile(v, 0.5)
                                   for ph, v in phases.items()},
            "cpu_percent": round(100.0 * (s1["cpu_s"] - s0["cpu_s"]) /
                                 window, 3),
            "cpu_percent_self_metric_p50": quantile(cpu_self, 0.5),
            "rss_kib": s1["rss_kib"],
            "rss_budget_kib": FOOTPRINT_BUDGET["rss_kib"],
            "threads": [threads0, s1["threads"]],
            "window_s": round(window, 3),
            "drop_age_s_p50": quantile(ages, 0.5),
            "drop_age_s_max": max(ages),
            "drop_malformed_lines": malformed_drop,
            "merge_malformed_warnings": daemon_err.count("malformed merge"),
            "cuda_context_marks": context,
            "compute_apps": sorted(app_pids),
            "compute_apps_name_this_namespace": apps_usable,
            "daemon_pid": daemon.pid, "workload_pid": workload.pid,
            "sigterm_exit": rc, "sigterm_s": round(exit_s, 3),
            "workload": {k: wl.get(k) for k in (
                "steps_per_sec", "steps", "seconds", "final_loss",
                "captures_ok", "captures_failed", "capture_last_error",
                "capture_forced",
                "families_nonblank", "launches")},
        })
        if failures:
            raise AssertionError(f"daemon check failed: {failures[:10]} "
                                 f"{out}")
        out["footprint"] = [footprint(env, work, d) for d in (100, 1000)]
        out["pod_daemon"] = pod_daemon(env, work, split, map_file)
        return out
    finally:
        for proc in (daemon, workload):
            if proc is not None and proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(work, ignore_errors=True)


# -- the planes: burst, flight recorder, anomaly ------------------------------

#: the planes phase's B4 timeline, (name, seconds): the square wave steps
#: the ``mxu`` pattern for SQUARE_HALF_S, then idles as long
PLANES_TIMELINE = (("idle", 4.0), ("square", 8.0), ("steady", 5.0),
                   ("idle_tail", 5.0))
#: the phase the smoke's own 100 Hz sampler stays out of: the daemon's
#: CPU and overruns there are its own
CLEAN_PHASE = "idle_tail"
SQUARE_HALF_S = 0.25
PLANES_HZ = 100
#: the burst sources a card must serve and the one it must leave blank
#: (206: NVML has no source for it)
BURST_SERVED = (155, 203, 204)
BURST_BLANK = (206,)
#: a threshold on utilization, and an incident joining it with an Xid
#: line (the kmsg fixture the phase appends to during the steady load)
PLANES_RULES = """version: 1
detectors:
  - name: gpu_busy
    field: TENSORCORE_UTIL
    type: threshold
    above: 80
incidents:
  - name: busy_gpu_fell_off_the_bus
    require:
      - anomaly: gpu_busy
      - event: CHIP_RESET
    window_s: 30
"""
#: the bounds the phase holds: overruns per 100 Hz tick, the power
#: integrals over the energy counter's delta, the record phase's share of
#: the sweep (the reference's acceptance, ``bench.py:1341-1344``)
OVERRUN_SHARE_MAX = 0.05
ENERGY_RATIO_TOL = 0.10
RECORD_SHARE_MAX = 0.05
#: decision (a) held: under the square wave the instant power's window
#: spread is at least this many times nvmlDeviceGetPowerUsage's
INSTANT_OVER_USAGE_MIN = 4.0


def replay_cli(env, *args) -> str:
    r = subprocess.run([sys.executable, "-m", "tpumon_torch.cli.replay",
                        *args], cwd=HERE, env=env, capture_output=True,
                       text=True, timeout=120)
    if r.returncode != 0:
        raise AssertionError(f"replay {' '.join(args)} exited "
                             f"{r.returncode}: {r.stderr[-2000:]}")
    return r.stdout


def segment_records(path: str) -> list:
    """(lead byte, record bytes) of every whole record of a segment file,
    walked by the framing alone (lead byte, varint length, payload), up
    to a torn tail."""

    with open(path, "rb") as f:
        data = f.read()
    out, pos = [], 0
    while pos < len(data):
        p, length, shift = pos + 1, 0, 0
        while p < len(data):
            b = data[p]
            p += 1
            length |= (b & 0x7F) << shift
            shift += 7
            if not b & 0x80:
                break
        else:
            break
        if p + length > len(data):
            break
        out.append((data[pos], p + length - pos))
        pos = p + length
    return out


def spreads(series, bounds) -> dict:
    """Per timeline phase, the median over its whole 1 s windows of each
    reading's max - min: ``series`` is [(wall ts, {reading: value})]."""

    out = {}
    for name, a, b in bounds:
        per = {}
        w = a
        while w + 1.0 <= b:
            win = [v for t, v in series if w <= t < w + 1.0]
            for key in (win[0] if win else {}):
                vals = [x[key] for x in win if x.get(key) is not None]
                if len(vals) >= 2:
                    per.setdefault(key, []).append(max(vals) - min(vals))
            w += 1.0
        out[name] = {k: quantile(v, 0.5) for k, v in per.items()}
    return out


#: a burst window's mean may stand this far (relative) outside its min
#: and max: a few float64 roundings of sum / n, no more
MEAN_ULPS = 1e-12


def planes_phase(K, fields, daemon_cpu_percent=None) -> dict:
    """``planes``: the exporter daemon with its three planes on, over
    NVML, while this process drives B4 (the ``mxu`` pattern) through
    PLANES_TIMELINE: ``python -m tpumon_torch.exporter.main -d 1000 --port
    P --burst-hz 100 --blackbox-dir D --rules R``, with the kernel log read
    from a fixture file (``TPUMON_KMSG_PATH``) to which the phase appends
    one ``NVRM: Xid`` line of the card during the steady load.  Scraped at
    1 Hz throughout; until CLEAN_PHASE this process samples both NVML
    power readings at 100 Hz beside it (decision (a), PERF.md) and times
    the inner loop's read, and the daemon's CPU share is taken per phase,
    CLEAN_PHASE's being its own.  Fails unless:

    * burst: from the first whole window on, every scrape serves the 12
      derived families of 155, 203 and 204 for the card and none of
      206's; every recorded window has min <= mean <= max; overruns are at
      most OVERRUN_SHARE_MAX of the ticks; the power integrals of the
      recorded windows between the first and last scrape are within
      ENERGY_RATIO_TOL of the energy counter's delta over them; under
      the square wave the instant power's window spread is at least
      INSTANT_OVER_USAGE_MIN times ``nvmlDeviceGetPowerUsage``'s;
    * recorder: after SIGTERM ``tpumon_torch.cli.replay --list`` shows
      the segment, ``--format json`` has one tick per sweep with rising
      stamps (the first a keyframe), the snapshot replayed at the last
      scraped sweep and rendered ``--format promtext`` equals that
      scrape's catalog samples, the ``record`` phase is under
      RECORD_SHARE_MAX of the sweep; a second daemon on the same
      directory opens a new segment and, killed with SIGKILL mid-run,
      leaves one whose every whole record the reader recovers, raising
      nothing;
    * anomaly: ``gpu_busy`` fired and stayed active through the steady
      load (every scrape from 2 s into it), and was cleared
      after the idle tail (``tpumon_anomaly_active`` 0), the incident
      joined the Xid line naming the card (``#chip<i>``), the findings
      are the recording's 0xB3 records, and ``replay --backtest`` (with
      the card's bus) re-derives exactly them;
    * the daemon holds no CUDA context (as in ``daemon_phase``);
    * native: the daemon, the second one and the replay CLI run with
      ``TPUMON_NATIVE=1`` (the native codec folds the burst windows and
      writes and reads the recording; a missing extension fails the
      start), and every scrape reads ``tpumon_codec_native 1``.

    B4's launches are this process's, counted over the timeline."""

    import shutil
    import signal
    import tempfile
    from tpumon_torch import blackbox as BB
    from tpumon_torch.kmsg import bus_key

    b, i = nvml_open(fields)
    out = {"kmsg_device_readable": os.access("/dev/kmsg", os.R_OK)}
    shm = "/dev/shm" if os.access("/dev/shm", os.W_OK) else None
    work = tempfile.mkdtemp(prefix="tpumon-planes-", dir=shm)
    bb_dir = os.path.join(work, "bb")
    rules = os.path.join(work, "rules.yaml")
    kmsg = os.path.join(work, "kmsg")
    with open(rules, "w") as f:
        f.write(PLANES_RULES)
    open(kmsg, "w").close()
    # the card's PCI bus as NVML gives it, else as CUDA does (the card's
    # sandbox answers NVML's PCI info NOT_SUPPORTED); the daemon's engine
    # maps it to the card only where its NVML bus map holds it
    key = bus_key(b.chip_info(i).pci.bus_id)
    if key is None:
        import torch
        props = torch.cuda.get_device_properties(0)
        key = tuple(getattr(props, f"pci_{k}_id", 0)
                    for k in ("domain", "bus", "device"))
    pci = "%04x:%02x:%02x" % key
    bus_map = {"%04x:%02x:%02x" % k: v for k, v in b.bus_index().items()}
    out["bus_map"] = bus_map
    # the native codec backs the daemon's burst fold and recorder (a
    # missing extension fails the daemon's start)
    env = dict(os.environ, PYTHONPATH=HERE, TPUMON_KMSG_PATH=kmsg,
               TPUMON_NATIVE="1")
    for k in ("TPUMON_BACKEND", "TPUMON_CHIPS"):
        env.pop(k, None)
    daemon = second = None
    stop, scrape_stop = threading.Event(), threading.Event()
    threads = []
    samples_ = []
    errors = []
    burst_fids = list(fields.BURST_SOURCE_FIELDS)

    def sampler():
        """The 1 Hz family's power reading (nvmlDeviceGetPowerUsage) beside
        the inner loop's own read (power from the instant field), 100 Hz;
        the latter timed."""
        period = 1.0 / PLANES_HZ
        nxt = time.monotonic()
        try:
            while not stop.is_set():
                usage = b.read_fields(i, [155])[155]
                t0 = time.monotonic()
                tick = b.read_burst_fields([(i, burst_fids)])[i]
                wall = time.monotonic() - t0
                samples_.append((time.time(), {
                    "power_instant": tick.get(155), "power_usage": usage,
                    "util": tick.get(203), "tick_ms": 1000.0 * wall}))
                nxt += period
                stop.wait(max(0.0, nxt - time.monotonic()))
        except Exception as e:  # surfaced after the join
            errors.append(e)

    args = ["tpumon_torch.exporter.main", "-o", os.path.join(work, "g.prom"),
            "-d", "1000", "--burst-hz", str(PLANES_HZ), "--blackbox-dir",
            bb_dir, "--rules", rules, "--wait-for-tpu", "30"]
    failures = []
    try:
        step, state = K.make_pattern("mxu", device="cuda")
        drain(step(state))
        port = free_port()
        daemon = spawn([*args, "--port", str(port)], env,
                       os.path.join(work, "daemon.err"))
        t_start = time.monotonic()
        while True:
            try:
                if http_get(port, "/healthz")[0] == 200:
                    break
            except OSError:
                pass
            if daemon.poll() is not None or time.monotonic() - t_start > 60:
                with open(os.path.join(work, "daemon.err")) as f:
                    raise AssertionError("the planes daemon never answered "
                                         f"/healthz 200: {f.read()[-2000:]}")
            time.sleep(0.1)
        time.sleep(1.0)
        scrapes = []  # (wall ts, monotonic, rows)

        def scraper():
            try:
                while not scrape_stop.is_set():
                    tick = time.monotonic()
                    status, _, body, _ = http_get(port, "/metrics")
                    if status != 200:
                        raise AssertionError(f"/metrics {status}")
                    scrapes.append((time.time(), tick,
                                    samples(body.decode())))
                    scrape_stop.wait(max(0.0, 1.0 - (time.monotonic()
                                                     - tick)))
            except Exception as e:
                errors.append(e)

        threads = [threading.Thread(target=fn, daemon=True)
                   for fn in (sampler, scraper)]
        for th in threads:
            th.start()
        # the daemon's CPU at each timeline boundary: the smoke's sampler
        # shares the NVML proxy with it, so the tail, sampled by nothing
        # but the daemon, gives the clean figure
        marks = [(proc_stat(daemon.pid), time.monotonic())]
        for name in K.LAUNCHES:
            K.LAUNCHES[name] = 0
        bounds, xid_ts = [], None
        s = state
        for name, secs in PLANES_TIMELINE:
            if name == CLEAN_PHASE:
                stop.set()
                threads[0].join(timeout=30)
            a = time.time()
            end = time.monotonic() + secs
            if name == "square":
                while time.monotonic() < end:
                    on = time.monotonic() + SQUARE_HALF_S
                    while time.monotonic() < on:
                        for _ in range(8):
                            s = step(s)
                        drain(s)
                    time.sleep(max(0.0, min(end, on + SQUARE_HALF_S)
                                   - time.monotonic()))
            elif name == "steady":
                while time.monotonic() < end:
                    for _ in range(32):
                        s = step(s)
                    drain(s)
                    if xid_ts is None and time.monotonic() > end - secs / 2:
                        xid_ts = time.time()
                        with open(kmsg, "a") as f:
                            f.write(f"3,9001,{int(xid_ts * 1e6)},-;NVRM: "
                                    f"Xid (PCI:{pci}): 79, pid=4242, "
                                    f"name=chip_smoke, GPU has fallen off "
                                    f"the bus.\n")
            else:
                time.sleep(secs)
            bounds.append((name, a, time.time()))
            if name != CLEAN_PHASE:
                marks.append((proc_stat(daemon.pid), time.monotonic()))
        launches = K.LAUNCHES["mxu_burn"]
        time.sleep(1.5)  # the idle tail's last window reaches a scrape
        marks.append((proc_stat(daemon.pid), time.monotonic()))
        scrape_stop.set()
        stop.set()
        for th in threads:
            th.join(timeout=30)
        if errors:
            raise AssertionError(f"planes sampler/scraper failed: {errors}")
        context = {"daemon": cuda_context_marks(daemon.pid),
                   "nvml_init_alone": nvml_init_marks(env)}
        rc, exit_s = stop_proc(daemon)
        with open(os.path.join(work, "daemon.err")) as f:
            daemon_err = f.read()
        out["kmsg_watcher"] = ("fixture" if "feeding kmsg lines" in
                               daemon_err else "off")
        maps = context["daemon"]
        if maps["libs"] or maps["uvm_mapped"]:
            failures.append(f"the daemon maps {maps}")
        if maps["libcuda"] and not context["nvml_init_alone"]["libcuda"]:
            failures.append("the daemon maps libcuda, nvmlInit_v2 alone "
                            "does not")
        if rc != 0 or exit_s > 5.0:
            failures.append(f"SIGTERM: exit {rc} in {exit_s:.2f} s")

        # -- burst, from the scrapes ------------------------------------
        card = str(i)
        cat = fields.CATALOG
        want_fams = {cat[fields.burst_id(s_, a_)].prom_name
                     for s_ in BURST_SERVED for a_ in range(4)}
        blank_fams = {cat[fields.burst_id(s_, a_)].prom_name
                      for s_ in BURST_BLANK for a_ in range(4)}

        def val(rows, fam, **lab):
            for sid, f_, lb, v, ok in rows:
                if f_ == fam and all(lb.get(k) == x for k, x in lab.items()):
                    return float(v)
            return None

        codec = sorted({val(rows, "tpumon_codec_native")
                        for _, _, rows in scrapes}, key=str)
        out["codec_native"] = codec
        if codec != [1.0]:
            failures.append(f"tpumon_codec_native read {codec}, not 1")
        first_whole = None
        for k, (ts, mono, rows) in enumerate(scrapes):
            fams = {r[1] for r in rows if r[2].get("chip") == card}
            if first_whole is None and want_fams <= fams:
                first_whole = k
            if first_whole is not None:
                if want_fams - fams:
                    failures.append(f"scrape {k}: burst families missing "
                                    f"{sorted(want_fams - fams)}")
            if blank_fams & fams:
                failures.append(f"scrape {k}: 206's families served "
                                f"{sorted(blank_fams & fams)}")
        if first_whole is None or first_whole > 2:
            failures.append(f"first whole burst window at scrape "
                            f"{first_whole}")
        first, last = scrapes[first_whole or 0], scrapes[-1]

        def overruns(a, b_):
            """(overruns, 100 Hz ticks) between two scrapes."""
            return ((val(b_[2], "tpumon_agent_burst_overruns_total") or 0) -
                    (val(a[2], "tpumon_agent_burst_overruns_total") or 0),
                    PLANES_HZ * (b_[1] - a[1]))

        over, ticks_run = overruns(first, last)
        # the clean window's scrapes serve sweeps taken after the
        # sampler stopped
        clean_a = [x for x in bounds if x[0] == CLEAN_PHASE][0][1]
        clean = [x for x in scrapes if x[0] >= clean_a + 1.0]
        over_clean, ticks_clean = (overruns(clean[0], clean[-1])
                                   if len(clean) > 1 else (None, 0))
        phase_ms = {}
        sweep_ms = []
        for ts, mono, rows in scrapes:
            for sid, f_, lb, v, ok in rows:
                if f_ == "tpumon_exporter_sweep_phase_seconds":
                    phase_ms.setdefault(lb["phase"], []).append(
                        1000.0 * float(v))
                elif f_ == "tpumon_exporter_scrape_duration_seconds":
                    sweep_ms.append(1000.0 * float(v))

        # -- the recording --------------------------------------------
        reader = BB.BlackBoxReader(bb_dir)
        items = list(reader.replay())
        ticks = [x for x in items if isinstance(x, BB.ReplayTick)]
        recorded = [x for x in items if isinstance(x, BB.AnomalyRecord)]
        ci = int(card)
        pw, E = 155, int(fields.F.TOTAL_ENERGY)
        for tk in ticks:
            vals = tk.snapshot.get(ci, {})
            for src in BURST_SERVED:
                lo, hi, mean = (vals.get(fields.burst_id(src, a_))
                                for a_ in range(3))
                # the mean of a window of equal samples may round an ulp
                # past them (sum / n in floating point)
                ulps = MEAN_ULPS * max(abs(lo or 0.0), abs(hi or 0.0), 1.0)
                if None not in (lo, hi, mean) and \
                        not lo - ulps <= mean <= hi + ulps:
                    failures.append(f"tick {tk.timestamp}: window of "
                                    f"{src}: {lo} <= {mean} <= {hi} fails")
        span = [tk for tk in ticks if first[0] - 1.0 <= tk.timestamp
                <= last[0]]
        integral = sum(tk.snapshot[ci].get(fields.burst_id(pw, 3)) or 0.0
                       for tk in span[1:])
        energy_j = (span[-1].snapshot[ci][E] - span[0].snapshot[ci][E]) \
            / 1000.0 if len(span) > 1 else 0.0
        ratio = integral / energy_j if energy_j else None
        if ratio is None or abs(ratio - 1.0) > ENERGY_RATIO_TOL:
            failures.append(f"burst power integral / energy delta {ratio}")

        # recorder bytes per tick by timeline phase
        seg = reader.segments()
        recs = segment_records(seg[0].path)
        per_tick, cur = [], None
        for lead, n in recs:
            if lead == BB.TICK_MAGIC:
                cur = n
            elif lead == 0xA9 and cur is not None:
                per_tick.append(cur + n)
                cur = None
        byte_phase = {}
        for tk, nbytes in zip(ticks, per_tick):
            for name, a, b_ in bounds:
                if a <= tk.timestamp - 0.5 < b_:
                    byte_phase.setdefault(name, []).append(nbytes)

        # -- replay CLI ------------------------------------------------
        listing = replay_cli(env, "--dir", bb_dir, "--list")
        if seg[0].name not in listing:
            failures.append(f"--list does not show {seg[0].name}")
        objs = [json.loads(ln) for ln in replay_cli(
            env, "--dir", bb_dir, "--format", "json").splitlines()]
        jt = [o for o in objs if o["kind"] == "tick"]
        stamps = [o["ts"] for o in jt]
        frames_last = val(last[2], "tpumon_blackbox_frames_total")
        if not (jt and jt[0]["keyframe"] and
                all(b_ > a for a, b_ in zip(stamps, stamps[1:])) and
                all(0.5 < b_ - a < 2.0 for a, b_ in zip(stamps, stamps[1:]))
                and frames_last is not None
                and frames_last <= len(jt) <= frames_last + 4):
            failures.append(f"replay json: {len(jt)} ticks, keyframe "
                            f"{jt[0]['keyframe'] if jt else None}, frames "
                            f"at the last scrape {frames_last}")
        at = jt[int(frames_last) - 1]["ts"] if frames_last else None
        prom = replay_cli(env, "--dir", bb_dir, "--format", "promtext",
                          "--at", repr(at))
        replayed = {(r[1], r[2].get("chip")): r[3] for r in samples(prom)}
        catalog = {m.prom_name for m in cat.values()}
        scraped = {(r[1], r[2].get("chip")): r[3] for r in last[2]
                   if r[1] in catalog}
        if replayed != scraped:
            diff = sorted(set(replayed.items()) ^ set(scraped.items()))
            failures.append(f"replayed promtext != the last scrape: "
                            f"{diff[:6]}")
        findings = [o for o in objs if o["kind"] in ("anomaly", "incident")]
        bt = [json.loads(ln) for ln in replay_cli(
            env, "--dir", bb_dir, "--backtest", rules, "--format", "json",
            *[a for k, v in bus_map.items() for a in ("--bus", f"{k}={v}")]
        ).splitlines()]
        summary = bt[-1]
        if bt[:-1] != findings or summary.get("kind") != "backtest_summary":
            failures.append(f"backtest {bt[:-1][:4]} != recorded "
                            f"{findings[:4]}")

        # -- anomaly, from the scrapes ---------------------------------
        steady = [x for x in bounds if x[0] == "steady"][0]
        fired = [val(r, "tpumon_anomaly_findings_total", rule="gpu_busy")
                 for ts, _, r in scrapes if steady[1] <= ts <= steady[2] + 1]
        # a scrape serves the sweep before it, whose reading may reach
        # back into the square wave: from 2 s into the steady load on,
        # every sweep scores it firing (the threshold has no hysteresis)
        active_steady = [val(r, "tpumon_anomaly_active", rule="gpu_busy")
                         for ts, _, r in scrapes
                         if steady[1] + 2.0 <= ts <= steady[2] + 0.5]
        active_end = val(last[2], "tpumon_anomaly_active", rule="gpu_busy")
        cleared = val(last[2], "tpumon_anomaly_cleared_total",
                      rule="gpu_busy")
        incidents = [f_ for f_ in findings if f_["kind"] == "incident"]
        if not fired or max(x or 0 for x in fired) < 1:
            failures.append(f"gpu_busy never fired in the steady load: "
                            f"{fired}")
        if len(active_steady) < 2 or not all(active_steady):
            failures.append(f"gpu_busy not active through the steady "
                            f"load: {active_steady}")
        if active_end != 0 or not cleared or cleared < 1:
            failures.append(f"gpu_busy active {active_end}, cleared "
                            f"{cleared} after the idle tail")
        if len(recorded) != len(findings) or not findings:
            failures.append(f"{len(recorded)} 0xB3 records, "
                            f"{len(findings)} findings in the json")
        # the Xid line joins the incident, naming the card where the bus
        # map holds its bus
        named = f"#chip{i}" if pci in bus_map else ""
        if not any(e.startswith("event:CHIP_RESET@") and e.endswith(named)
                   and ("#chip" in e) == bool(named)
                   for f_ in incidents for e in f_["evidence"]):
            failures.append(f"no incident joins the Xid line "
                            f"({named or 'no bus map'}): {incidents}")

        # -- a second daemon: new segment, then SIGKILL ------------------
        port2 = free_port()
        second = spawn([*args, "--port", str(port2)], env,
                       os.path.join(work, "second.err"))
        t2 = time.monotonic()
        while time.monotonic() - t2 < 60:
            try:
                if http_get(port2, "/healthz")[0] == 200:
                    break
            except OSError:
                pass
            time.sleep(0.1)
        time.sleep(3.3)
        second.send_signal(signal.SIGKILL)
        second.wait()
        segs = BB.BlackBoxReader(bb_dir).segments()
        r2 = BB.BlackBoxReader(bb_dir)
        try:
            after = list(r2.replay())
        except Exception as e:  # the reader must never raise
            failures.append(f"reader raised after SIGKILL: {e!r}")
            after = []
        whole = sum(1 for lead, _ in segment_records(segs[-1].path)
                    if lead == 0xA9) if len(segs) == 2 else None
        got = sum(1 for x in after if isinstance(x, BB.ReplayTick)
                  and x.timestamp >= segs[-1].start_ts) \
            if len(segs) == 2 else None
        if len(segs) != 2 or whole != got or not got:
            failures.append(f"after SIGKILL: {len(segs)} segments, "
                            f"{whole} whole frames, {got} recovered")

        def cpu_percent(m0, m1):
            return round(100.0 * (m1[0]["cpu_s"] - m0[0]["cpu_s"])
                         / (m1[1] - m0[1]), 3)

        cpu_by_phase = {name: cpu_percent(m0, m1) for (name, _), m0, m1 in
                        zip(PLANES_TIMELINE, marks, marks[1:])}
        series = [(t, {k: v for k, v in x.items() if k != "tick_ms"})
                  for t, x in samples_]
        spread = spreads(series, bounds)
        sq = spread.get("square", {})
        inst_over_usage = (sq["power_instant"] / sq["power_usage"]
                           if sq.get("power_usage") else None)
        win_spread = {}
        for tk in ticks:
            v = tk.snapshot.get(ci, {})
            for name, a, b_ in bounds:
                if a + 1.0 <= tk.timestamp <= b_:
                    for src, key in ((155, "power"), (203, "util")):
                        lo = v.get(fields.burst_id(src, 0))
                        hi = v.get(fields.burst_id(src, 1))
                        if lo is not None and hi is not None:
                            win_spread.setdefault(name, {}).setdefault(
                                key, []).append(hi - lo)
        tick_ms = [x["tick_ms"] for _, x in samples_]
        out.update({
            "kmsg_fixture_xid_at": xid_ts, "card_pci": pci,
            "scrapes": len(scrapes), "first_whole_window_scrape": first_whole,
            "families_nonblank": len({r[1] for r in last[2]
                                      if r[1].startswith("tpu_")
                                      and r[2].get("chip") == card}),
            "overruns": over, "ticks": round(ticks_run, 1),
            "overrun_share": round(over / ticks_run, 5) if ticks_run else None,
            "overruns_clean": over_clean, "ticks_clean": round(ticks_clean, 1),
            "energy_ratio": ratio, "energy_j": energy_j,
            "power_integral_j": integral,
            "cpu_percent_burst_100hz": cpu_by_phase[CLEAN_PHASE],
            "cpu_percent_by_phase": cpu_by_phase,
            "cpu_percent_beside_smoke_sampler": cpu_percent(
                marks[0], marks[len(PLANES_TIMELINE) - 1]),
            "cpu_percent_daemon_phase_1hz": daemon_cpu_percent,
            "inner_read_ms_p50": quantile(tick_ms, 0.5),
            "inner_read_ms_p99": quantile(tick_ms, 0.99),
            "inner_read_ms_mean": (sum(tick_ms) / len(tick_ms)
                                   if tick_ms else None),
            "smoke_samples": len(samples_),
            "spread_smoke_100hz": spread,
            "square_spread_instant_over_usage": inst_over_usage,
            "spread_daemon_windows": {k: {kk: quantile(vv, 0.5)
                                          for kk, vv in d.items()}
                                      for k, d in win_spread.items()},
            "recorder_bytes_per_tick": {k: sum(v) / len(v)
                                        for k, v in byte_phase.items()},
            "sweep_ms_p50": quantile(sweep_ms, 0.5),
            "phase_ms_p50": {k: quantile(v, 0.5) for k, v in
                             phase_ms.items()},
            "record_share": (quantile(phase_ms.get("record", []), 0.5) or 0)
            / (quantile(sweep_ms, 0.5) or 1),
            "ticks_recorded": len(jt), "frames_at_last_scrape": frames_last,
            "findings": [(f_["kind"], f_["rule"], f_["state"], f_["ts"])
                         for f_ in findings],
            "incident_evidence": [f_["evidence"] for f_ in incidents],
            "backtest_summary": summary,
            "segments_after_restart": len(segs),
            "sigkill_whole_frames": whole, "sigkill_recovered": got,
            "torn_segments": r2.last_torn_segments,
            "sigterm_exit": rc, "launches": {"mxu_burn": launches},
            "cuda_context_marks": context,
        })
        if out["record_share"] >= RECORD_SHARE_MAX:
            failures.append(f"record phase {out['record_share']:.4f} of "
                            f"the sweep")
        if out["overrun_share"] is None or \
                out["overrun_share"] > OVERRUN_SHARE_MAX:
            failures.append(f"overruns {over} of {ticks_run:.0f} ticks")
        if launches <= 0:
            failures.append("B4 never launched on the planes path")
        if inst_over_usage is None or \
                inst_over_usage < INSTANT_OVER_USAGE_MIN:
            failures.append(f"decision (a): under the square wave the "
                            f"instant power's spread is {inst_over_usage} "
                            f"times the usage call's")
        if failures:
            raise AssertionError(f"planes check failed: {failures[:10]} "
                                 f"{out}")
        return out
    finally:
        stop.set()
        scrape_stop.set()
        for th in threads:
            th.join(timeout=30)
        for proc in (daemon, second):
            if proc is not None and proc.poll() is None:
                proc.kill()
                proc.wait()
        b.close()
        shutil.rmtree(work, ignore_errors=True)


# -- the watches: health, policy, event sets, the REST API --------------------

#: the watches phase's B4 timeline, (name, seconds)
WATCHES_TIMELINE = (("idle", 4.0), ("steady", 6.0), ("idle2", 4.0),
                    ("steady2", 6.0))
#: the reference's default power limit (DCGM's 250 W, ``tpumon/events.py``)
POLICY_POWER_W = 250.0
#: a POWER violation must arrive within this long of its load's start
POWER_LAG_MAX_S = 2.0
#: the thermal limit is this far over the idle core temperature
THERMAL_MARGIN_C = 3
VIOLATION_RE = re.compile(r"chip (\d+) (\w+): \w+ threshold breached: "
                          r"([-\d.]+) >= ([-\d.]+)$")


def get_json(port: int, path: str):
    """(status, body text, parsed JSON or None, wall ms) of one GET."""

    status, _, body, ms = http_get(port, path)
    text = body.decode()
    try:
        parsed = json.loads(text) if "/json" in path else None
    except ValueError:
        parsed = None
    return status, text, parsed, ms


def watches_phase(K, fields) -> dict:
    """``watches``: the façade's health, policy and event-set watches
    over NVML on the card, and the REST API on them, while this process
    drives B4 (the ``mxu`` pattern) through WATCHES_TIMELINE.

    * Policy CLI: ``python -m tpumon_torch.cli.policy --conditions
      power,thermal --thermal-limit <idle core temp + THERMAL_MARGIN_C>
      --duration 22``, its lines stamped as they arrive.  Fails unless no
      POWER violation arrives in an idle stretch, exactly one in each
      steady one, within POWER_LAG_MAX_S of its start, each at least
      POLICY_POWER_W.
    * Thermal: an in-process ``Handle`` (``tpumon_torch.init``, NVML)
      with the same limit registered and its watch sweeping every 0.2 s;
      every temperature its evaluations read is recorded, and the
      violations must be exactly the crossings of the limit (edge
      triggered, re-armed below it).  The highest reading is printed.
    * Health: ``health_set`` at idle, ``health_check`` after the second
      steady stretch; fails on FAIL.  Each system's status and
      incidents, and which ``_CHECK_FIELDS`` read non-blank, are printed.
    * Event set: ``CRITICAL_EVENTS`` registered for the card; fails if
      it returns anything in the run.
    * REST API: ``python -m tpumon_torch.restapi.main -p P`` over NVML;
      every route of the card and its ``/json`` twin, by index and UUID,
      the process route for this process, and ``/tpu/status``.  Fails
      unless each is 200 (the JSON ones parse), a bad id is 400 and an
      unknown id and UUID 404, ``/tpu/health/json/<i>`` agrees with the
      handle's ``health_check``, and the REST process holds no CUDA
      context (as in ``daemon_phase``).

    B4's launches are this process's, counted over the timeline."""

    import queue
    import shutil
    import tempfile
    import tpumon_torch
    from tpumon_torch import health as H
    from tpumon_torch.event_set import CRITICAL_EVENTS
    from tpumon_torch.events import PolicyCondition
    from tpumon_torch.loadgen.bench_gpu import nvml_index

    F = fields.F
    T = int(F.CORE_TEMP)
    work = tempfile.mkdtemp(prefix="tpumon-watches-")
    env = dict(os.environ, PYTHONPATH=HERE)
    for k in ("TPUMON_BACKEND", "TPUMON_CHIPS"):
        env.pop(k, None)
    out, failures = {}, []
    lines = []  # (monotonic, line) of the policy CLI
    policy = rest = None
    h = tpumon_torch.init(backend_name="nvml")
    try:
        if h.backend.name != "nvml":
            raise AssertionError(f"the façade opened {h.backend.name}")
        i = nvml_index(h.backend)
        read = h.backend.read_fields
        idle_temp = read(i, [T])[T]
        limit = idle_temp + THERMAL_MARGIN_C
        readings = []  # what the handle's thermal evaluations read

        def recording_read(index, fids, now=None):
            vals = read(index, fids, now=now)
            if index == i and list(fids) == [T]:
                readings.append(vals.get(T))
            return vals

        h.backend.read_fields = recording_read
        h.health_set(i)
        events = h.new_event_set()
        events.register_event(CRITICAL_EVENTS, chip_index=i)
        thermal = h.register_policy(i, PolicyCondition.THERMAL,
                                    {PolicyCondition.THERMAL: limit})
        policy = subprocess.Popen(
            [sys.executable, "-m", "tpumon_torch.cli.policy", "--chip",
             str(i), "--conditions", "power,thermal", "--thermal-limit",
             str(limit), "--duration", "22"], cwd=HERE, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

        def reader():
            for ln in policy.stdout:
                lines.append((time.monotonic(), ln.rstrip("\n")))

        rth = threading.Thread(target=reader, daemon=True)
        rth.start()
        t0 = time.monotonic()
        while not lines:
            if policy.poll() is not None or time.monotonic() - t0 > 60:
                raise AssertionError(f"the policy CLI never listened: "
                                     f"{policy.stderr.read()[-2000:]}")
            time.sleep(0.05)
        step, state = K.make_pattern("mxu", device="cuda")
        drain(step(state))
        time.sleep(0.6)  # its first sweeps read the idle card
        h.watches.start(tick_s=0.2)
        for name in K.LAUNCHES:
            K.LAUNCHES[name] = 0
        bounds, s = [], state
        for name, secs in WATCHES_TIMELINE:
            a = time.monotonic()
            end = a + secs
            if name.startswith("steady"):
                while time.monotonic() < end:
                    for _ in range(32):
                        s = step(s)
                    drain(s)
            else:
                time.sleep(secs)
            bounds.append((name, a, time.monotonic()))
        launches = K.LAUNCHES["mxu_burn"]
        result = h.health_check(i)
        h.watches.stop()
        quiet = events.wait(0.0)
        try:
            rc = policy.wait(timeout=30)
        except subprocess.TimeoutExpired:
            policy.kill()
            rc = None
        rth.join(timeout=10)

        # -- policy CLI: POWER at each steady stretch's start -------------
        by_stretch = {name: [] for name, _ in WATCHES_TIMELINE}
        cli_thermal = []
        for mono, ln in lines[1:]:
            m = VIOLATION_RE.search(ln)
            if m is None:
                failures.append(f"policy CLI line {ln!r}")
                continue
            cond, value = m.group(2), float(m.group(3))
            if cond == "THERMAL":
                cli_thermal.append(value)
                continue
            where = [(name, a) for name, a, b_ in bounds if a <= mono < b_]
            name, a = where[0] if where else ("after", bounds[-1][2])
            by_stretch.setdefault(name, []).append(
                {"value": value, "lag_s": round(mono - a, 3)})
        for name, got in by_stretch.items():
            want = 1 if name.startswith("steady") else 0
            if len(got) != want:
                failures.append(f"{len(got)} POWER violations in {name}: "
                                f"{got}")
            for v in got:
                if v["lag_s"] > POWER_LAG_MAX_S or \
                        v["value"] < POLICY_POWER_W:
                    failures.append(f"POWER violation in {name}: {v}")
        if rc != 0:
            failures.append(f"policy CLI exited {rc}")

        # -- thermal: violations exactly at the crossings -----------------
        crossings, armed = [], True
        for v in readings:
            if v is None:
                continue
            if v >= limit and armed:
                armed = False
                crossings.append(v)
            elif v < limit:
                armed = True
        fired = []
        while True:
            try:
                fired.append(thermal.get_nowait().data["value"])
            except queue.Empty:
                break
        if fired != crossings:
            failures.append(f"THERMAL violations {fired}, crossings "
                            f"{crossings}")
        temps = [v for v in readings if v is not None]

        # -- health ---------------------------------------------------------
        systems = {}  # each system's worst incident
        for inc in result.incidents:
            cur = systems.get(inc.system.name)
            if cur is None or inc.status.value > cur.value:
                systems[inc.system.name] = inc.status
        if result.status.name == "FAIL":
            failures.append(f"health FAIL: {result.incidents}")
        inputs = read(i, H._CHECK_FIELDS)
        if quiet is not None:
            failures.append(f"the critical event set returned {quiet}")

        # -- the REST API ---------------------------------------------------
        port = free_port()
        rest = spawn(["tpumon_torch.restapi.main", "-p", str(port),
                      "--process-warmup", "1"], env,
                     os.path.join(work, "rest.err"))
        t0 = time.monotonic()
        while True:
            try:
                http_get(port, "/tpu/status")
                break
            except OSError:
                if rest.poll() is not None or time.monotonic() - t0 > 60:
                    with open(os.path.join(work, "rest.err")) as f:
                        raise AssertionError(f"the REST API never served: "
                                             f"{f.read()[-2000:]}")
                time.sleep(0.1)
        uuid = h.chip_info(i).uuid
        paths = ["/tpu/status", "/tpu/status/json"]
        for kind in ("device/info", "device/status", "health"):
            paths += [f"/tpu/{kind}/{i}", f"/tpu/{kind}/json/{i}",
                      f"/tpu/{kind}/uuid/{uuid}",
                      f"/tpu/{kind}/json/uuid/{uuid}"]
        paths += [f"/tpu/device/topology/{i}",
                  f"/tpu/device/topology/json/{i}",
                  f"/tpu/process/info/pid/{os.getpid()}",
                  f"/tpu/process/info/json/pid/{os.getpid()}"]
        answers = {p: get_json(port, p) for p in paths}
        for p, (code, text, parsed, _) in answers.items():
            if code != 200 or ("/json" in p and parsed is None):
                failures.append(f"GET {p}: {code} {text[:200]!r}")
        bad = {"/tpu/device/info/x": 400, "/tpu/device/status/json/99": 404,
               "/tpu/health/uuid/GPU-nope": 404}
        bad_got = {p: get_json(port, p)[0] for p in bad}
        if bad_got != bad:
            failures.append(f"validation answers {bad_got}")
        rest_health = get_json(port, f"/tpu/health/json/{i}")[2]
        mine = h.health_check(i)
        health_pair = {
            "rest": rest_health and (rest_health["status"], [
                (x["system"], x["status"], x["message"])
                for x in rest_health["incidents"]]),
            "handle": (mine.status.name, [
                (x.system.name, x.status.name, x.message)
                for x in mine.incidents])}
        if health_pair["rest"] is None or \
                tuple(health_pair["rest"]) != health_pair["handle"]:
            failures.append(f"REST health != the handle's: {health_pair}")
        context = {"rest": cuda_context_marks(rest.pid),
                   "nvml_init_alone": nvml_init_marks(env)}
        maps = context["rest"]
        if maps["libs"] or maps["uvm_mapped"]:
            failures.append(f"the REST process maps {maps}")
        if maps["libcuda"] and not context["nvml_init_alone"]["libcuda"]:
            failures.append("the REST process maps libcuda, nvmlInit_v2 "
                            "alone does not")
        rest_rc, _ = stop_proc(rest)
        if rest_rc != 0:
            failures.append(f"REST API exit {rest_rc} on SIGTERM")
        # the process route sweeps for its warm-up (``--process-warmup``)
        ms = [a[3] for p, a in answers.items() if "/process/" not in p]
        out.update({
            "card": i, "idle_core_temp_c": idle_temp, "thermal_limit_c": limit,
            "power_limit_w": POLICY_POWER_W,
            "power_violations": by_stretch,
            "thermal_readings": len(temps),
            "thermal_max_c": max(temps) if temps else None,
            "thermal_violations": fired, "thermal_crossings": crossings,
            "policy_cli_thermal": cli_thermal,
            "health": {"status": result.status.name,
                       "systems": {k: v.name for k, v in systems.items()},
                       "incidents": [(x.system.name, x.status.name,
                                      x.message) for x in result.incidents]},
            "check_fields_nonblank": sorted(
                fields.CATALOG[f].prom_name for f, v in inputs.items()
                if v is not None),
            "check_fields_blank": sorted(
                fields.CATALOG[f].prom_name for f, v in inputs.items()
                if v is None),
            "event_set_quiet": quiet is None,
            "rest_routes": len(answers), "rest_ms_p50": quantile(ms, 0.5),
            "rest_ms_max": max(ms),
            "rest_process_route": answers[paths[-1]][0],
            "rest_process_route_ms": answers[paths[-1]][3],
            "rest_health_vs_handle": health_pair,
            "cuda_context_marks": context,
            "launches": {"mxu_burn": launches},
        })
        if launches <= 0:
            failures.append("B4 never launched on the watches path")
        if failures:
            raise AssertionError(f"watches check failed: {failures[:10]} "
                                 f"{out}")
        return out
    finally:
        h.watches.stop()
        for proc in (policy, rest):
            if proc is not None and proc.poll() is None:
                proc.kill()
                proc.wait()
        tpumon_torch.shutdown()
        shutil.rmtree(work, ignore_errors=True)


# -- the stream plane ------------------------------------------------------------

#: in-process decoders attached from the start of the subscribed stretch
STREAM_DECODERS = 16
#: the stretch with no subscriber, then the subscribed one; the late
#: decoder attaches this far into the latter
STREAM_QUIET_S = 10.0
STREAM_SUBSCRIBED_S = 20.0
STREAM_LATE_S = 10.0


class Subscribers:
    """The phase's in-process stream subscribers on one selector thread:
    each socket's bytes fed to its own ``StreamDecoder``; an HTTP one's
    reply head is held apart first."""

    def __init__(self, port: int) -> None:
        import selectors

        self.port = port
        self.sel = selectors.DefaultSelector()
        self.subs = {}  # name -> state
        self.errors = []
        self.stop = threading.Event()
        self.lock = threading.Lock()
        self.thread = threading.Thread(target=self._loop, daemon=True)
        self.thread.start()

    def attach(self, name: str, http: bool = False) -> None:
        import selectors
        import socket
        from tpumon_torch.frameserver import StreamDecoder

        s = socket.create_connection(("127.0.0.1", self.port), timeout=10)
        s.sendall(b"GET /stream HTTP/1.1\r\nHost: smoke\r\n\r\n" if http
                  else b'{"op": "stream"}\n')
        s.setblocking(False)
        st = {"sock": s, "dec": StreamDecoder(), "items": [], "bytes": 0,
              "head": bytearray() if http else None, "http": http,
              "attached": time.time()}
        with self.lock:
            self.subs[name] = st
            self.sel.register(s, selectors.EVENT_READ, name)

    def _loop(self) -> None:
        while not self.stop.is_set():
            with self.lock:
                ready = self.sel.select(0.05) if self.subs else []
            if not ready:
                time.sleep(0.01)
            for key, _ in ready:
                st = self.subs[key.data]
                try:
                    chunk = st["sock"].recv(1 << 16)
                    if not chunk:
                        raise EOFError(f"{key.data}: stream closed")
                    st["bytes"] += len(chunk)
                    if st["head"] is not None:
                        st["head"] += chunk
                        end = st["head"].find(b"\r\n\r\n")
                        if end < 0:
                            continue
                        chunk = bytes(st["head"][end + 4:])
                        st["head"] = bytes(st["head"][:end + 4])
                        if not st["head"].startswith(b"HTTP/1.1 200 OK"):
                            raise AssertionError(f"{key.data}: {st['head']}")
                    st["items"].extend(st["dec"].feed(chunk))
                except Exception as e:  # surfaced after close
                    self.errors.append(repr(e))
                    with self.lock:
                        self.sel.unregister(st["sock"])

    def close(self) -> None:
        if self.stop.is_set():
            return
        self.stop.set()
        self.thread.join(timeout=10)
        for st in self.subs.values():
            st["sock"].close()
        self.sel.close()


def stream_phase(fields) -> dict:
    """``stream``: the exporter daemon with its stream plane on, over NVML,
    beside the bench train workload (B1-B3, as in ``daemon_phase``):
    ``python -m tpumon_torch.exporter.main -o none -d 1000 --port P
    --stream-port S --blackbox-dir D``.  STREAM_QUIET_S with no
    subscriber, then STREAM_SUBSCRIBED_S with STREAM_DECODERS in-process
    ``StreamDecoder`` subscribers (JSON op), one ``GET /stream`` one, one
    ``python -m tpumon_torch.cli.stream --connect 127.0.0.1:S --format
    json`` process, and a decoder attaching STREAM_LATE_S in.  Scraped at
    1 Hz throughout.  Fails unless every subscriber's decoded sweeps are
    the flight recorder's for the same sweep stamps (read back with the
    port's ``BlackBoxReader``), each a run of consecutive recorded sweeps
    opened by a keyframe (the late one's equal to the recorder's sweep at
    its stamp), the CLI's JSON lines equal a decoder's for the same
    sweeps, and the daemon holds no CUDA context and maps no torch.
    Printed: the ``stream`` phase ms a sweep and the sweep wall, p50/p99
    in each stretch, ``tpumon_stream_*`` bytes a subscriber a tick, and
    the daemon's CPU share in each stretch.  The train kernels' launches
    are the workload's own counts, from its JSON line."""

    import shutil
    import tempfile
    from tpumon_torch import blackbox as BB
    from tpumon_torch.cli.replay import _item_objs

    shm = "/dev/shm" if os.access("/dev/shm", os.W_OK) else None
    work = tempfile.mkdtemp(prefix="tpumon-stream-", dir=shm)
    bb_dir = os.path.join(work, "bb")
    drop = os.path.join(work, "embed.prom")
    env = dict(os.environ, PYTHONPATH=HERE)
    for k in ("TPUMON_BACKEND", "TPUMON_CHIPS"):
        env.pop(k, None)
    port, sport = free_port(), free_port()
    daemon = workload = cli = subs = None
    out, failures = {}, []
    try:
        daemon = spawn(["tpumon_torch.exporter.main", "-o", "none", "-d",
                        "1000", "--port", str(port), "--stream-port",
                        str(sport), "--blackbox-dir", bb_dir,
                        "--wait-for-tpu", "30"], env,
                       os.path.join(work, "daemon.err"))
        workload = spawn(["tpumon_torch.loadgen.run", "--size", "bench",
                          "--self-monitor", "--monitor-output", drop,
                          "--seconds", str(STREAM_QUIET_S +
                                           STREAM_SUBSCRIBED_S + 25),
                          "--json"], env, os.path.join(work, "workload.err"),
                         stdout=subprocess.PIPE)
        t0 = time.monotonic()
        while True:
            try:
                if http_get(port, "/healthz")[0] == 200:
                    break
            except OSError:
                pass
            if daemon.poll() is not None or time.monotonic() - t0 > 60:
                with open(os.path.join(work, "daemon.err")) as f:
                    raise AssertionError(f"the stream daemon never "
                                         f"answered /healthz 200: "
                                         f"{f.read()[-2000:]}")
            time.sleep(0.1)
        while not os.path.exists(drop):  # the workload is stepping
            if workload.poll() is not None or time.monotonic() - t0 > 180:
                with open(os.path.join(work, "workload.err")) as f:
                    raise AssertionError(f"the workload never stepped: "
                                         f"{f.read()[-2000:]}")
            time.sleep(0.2)

        def scrape_for(seconds, at=None):
            """1 Hz scrapes: [(wall, rows)], and the daemon's CPU % over
            the stretch; ``at`` = (seconds in, fn) runs once."""
            rows, m0 = [], (proc_stat(daemon.pid), time.monotonic())
            end = time.monotonic() + seconds
            while time.monotonic() < end:
                tick = time.monotonic()
                if at is not None and tick - m0[1] >= at[0]:
                    at[1]()
                    at = None
                status, _, body, _ = http_get(port, "/metrics")
                if status != 200:
                    raise AssertionError(f"/metrics {status}")
                rows.append((time.time(), samples(body.decode())))
                time.sleep(max(0.0, 1.0 - (time.monotonic() - tick)))
            m1 = (proc_stat(daemon.pid), time.monotonic())
            return rows, round(100.0 * (m1[0]["cpu_s"] - m0[0]["cpu_s"])
                               / (m1[1] - m0[1]), 3)

        quiet_rows, quiet_cpu = scrape_for(STREAM_QUIET_S)
        subs = Subscribers(sport)
        for k in range(STREAM_DECODERS):
            subs.attach(f"decoder{k}")
        subs.attach("http", http=True)
        cli_out = open(os.path.join(work, "cli.jsonl"), "w")
        try:
            cli = subprocess.Popen(
                [sys.executable, "-m", "tpumon_torch.cli.stream",
                 "--connect", f"127.0.0.1:{sport}", "--format", "json"],
                cwd=HERE, env=env, stdout=cli_out,
                stderr=open(os.path.join(work, "cli.err"), "w"))
        finally:
            cli_out.close()
        sub_rows, sub_cpu = scrape_for(
            STREAM_SUBSCRIBED_S, at=(STREAM_LATE_S,
                                     lambda: subs.attach("late")))
        cli_rc, _ = stop_proc(cli)
        subs.close()
        context = {"daemon": cuda_context_marks(daemon.pid),
                   "nvml_init_alone": nvml_init_marks(env)}
        rc, exit_s = stop_proc(daemon)
        try:
            wl_out, _ = workload.communicate(timeout=180)
        except subprocess.TimeoutExpired:
            workload.kill()
            wl_out, _ = workload.communicate()
        if workload.returncode != 0:
            with open(os.path.join(work, "workload.err")) as f:
                raise AssertionError(f"workload exited {workload.returncode}"
                                     f": {f.read()[-2000:]}")
        wl = json.loads(wl_out.strip().splitlines()[-1])
        if subs.errors:
            failures.append(f"subscribers: {subs.errors[:4]}")
        if rc != 0 or exit_s > 5.0:
            failures.append(f"SIGTERM: exit {rc} in {exit_s:.2f} s")
        maps = context["daemon"]
        if maps["libs"] or maps["uvm_mapped"]:
            failures.append(f"the daemon maps {maps}")
        if maps["libcuda"] and not context["nvml_init_alone"]["libcuda"]:
            failures.append("the daemon maps libcuda, nvmlInit_v2 alone "
                            "does not")

        # -- every subscriber's sweeps are the recorder's ---------------
        recorded = [x for x in BB.BlackBoxReader(bb_dir).replay()
                    if isinstance(x, BB.ReplayTick)]
        at_ts = {tk.timestamp: k for k, tk in enumerate(recorded)}

        def events(tk):
            return [(e.etype.name, e.chip_index, e.seq, e.message)
                    for e in tk.events]

        ticks_by = {}
        for name, st in subs.subs.items():
            ticks = [x for x in st["items"] if isinstance(x, BB.ReplayTick)]
            ticks_by[name] = ticks
            idx = [at_ts.get(tk.timestamp) for tk in ticks]
            if not ticks or None in idx or \
                    idx != list(range(idx[0], idx[0] + len(idx))):
                failures.append(f"{name}: {len(ticks)} ticks, recorder "
                                f"indices {idx[:3]}...{idx[-3:]}")
                continue
            if not ticks[0].keyframe or any(tk.keyframe for tk in ticks[1:]):
                failures.append(f"{name}: keyframes at "
                                f"{[k for k, t in enumerate(ticks) if t.keyframe]}")
            for tk, k in zip(ticks, idx):
                if tk.snapshot != recorded[k].snapshot or \
                        (not tk.keyframe and events(tk) !=
                         events(recorded[k])):
                    failures.append(f"{name}: sweep {tk.timestamp} differs "
                                    f"from the recorder's")
                    break
        late = ticks_by.get("late") or []
        first = ticks_by.get("decoder0") or []
        if not late or len(late) > len(first) - STREAM_LATE_S / 2:
            failures.append(f"the late decoder got {len(late)} ticks, "
                            f"decoder0 {len(first)}")
        # -- the CLI's lines are a decoder's ----------------------------
        with open(os.path.join(work, "cli.jsonl")) as f:
            cli_objs = [json.loads(ln) for ln in f if ln.strip()]
        cli_ticks = [o for o in cli_objs if o["kind"] == "tick"]
        dec_lines = {tk.timestamp: [json.dumps(o, sort_keys=True)
                                    for o in _item_objs(tk)]
                     for tk in first}
        groups, cur = {}, None
        for o in cli_objs:
            if o["kind"] == "tick":
                cur = o["ts"]
                groups[cur] = []
            if cur is not None:
                groups[cur].append(json.dumps(o, sort_keys=True))
        compared = 0
        for o in cli_ticks[1:]:
            if o["ts"] in dec_lines:
                compared += 1
                if groups[o["ts"]] != dec_lines[o["ts"]]:
                    failures.append(f"CLI tick {o['ts']}: "
                                    f"{groups[o['ts']]} != "
                                    f"{dec_lines[o['ts']]}")
                    break
        if compared < STREAM_SUBSCRIBED_S - 5 or not cli_ticks[0]["keyframe"]:
            failures.append(f"CLI: {len(cli_ticks)} ticks, {compared} "
                            f"compared with decoder0")

        # -- the figures -------------------------------------------------
        def phase(rows, name):
            return [1000.0 * float(v) for _, rs in rows
                    for _, f_, lb, v, _ in rs
                    if f_ == "tpumon_exporter_sweep_phase_seconds"
                    and lb.get("phase") == name]

        def family(rows, fam):
            return [float(v) for _, rs in rows for _, f_, _, v, _ in rs
                    if f_ == fam]

        def p(xs):
            return {"p50": quantile(xs, 0.5), "p99": quantile(xs, 0.99),
                    "n": len(xs)}

        # the subscribed stretch's scrapes serve sweeps with every
        # subscriber attached from its second second on
        steady = sub_rows[2:]
        sent = family(steady, "tpumon_stream_bytes_sent_total")
        frames = family(steady, "tpumon_exporter_sweeps_total")
        nsubs = family(steady, "tpumon_stream_subscribers")
        per_sub_tick = ((sent[-1] - sent[0]) / (frames[-1] - frames[0])
                        / nsubs[-1]) if len(sent) > 1 and \
            frames[-1] > frames[0] and nsubs[-1] else None
        client = subs.subs["decoder0"]
        out.update({
            "subscribers": {"decoders": STREAM_DECODERS, "http": 1,
                            "cli": 1, "late": 1},
            "stream_phase_ms": {"quiet": p(phase(quiet_rows, "stream")),
                                "subscribed": p(phase(sub_rows, "stream"))},
            "sweep_phase_ms": {
                stretch: {ph: p(phase(rows, ph)) for ph in (
                    "collect", "record", "stream", "render", "publish")}
                for stretch, rows in (("quiet", quiet_rows),
                                      ("subscribed", sub_rows))},
            "sweep_ms": {
                "quiet": p([1000.0 * x for x in family(
                    quiet_rows, "tpumon_exporter_scrape_duration_seconds")]),
                "subscribed": p([1000.0 * x for x in family(
                    sub_rows, "tpumon_exporter_scrape_duration_seconds")])},
            "cpu_percent": {"quiet": quiet_cpu, "subscribed": sub_cpu},
            "bytes_per_subscriber_tick": per_sub_tick,
            "decoder0_bytes_per_tick": client["bytes"] / max(1, len(first)),
            "subscribers_gauge_max": max(nsubs) if nsubs else None,
            "stream_totals": {f: family(sub_rows[-1:], f)[0] for f in (
                "tpumon_stream_subscribers_total",
                "tpumon_stream_frames_sent_total",
                "tpumon_stream_keyframes_total",
                "tpumon_stream_dropped_frames_total",
                "tpumon_stream_resyncs_total")},
            "ticks": {"recorded": len(recorded), "decoder0": len(first),
                      "late": len(late), "http": len(ticks_by.get("http",
                                                                   [])),
                      "cli": len(cli_ticks), "cli_compared": compared},
            "cli_exit": cli_rc, "sigterm_exit": rc,
            "cuda_context_marks": context,
            "workload": {k: wl.get(k) for k in (
                "steps_per_sec", "steps", "final_loss", "captures_ok",
                "captures_failed", "launches")},
        })
        if failures:
            raise AssertionError(f"stream check failed: {failures[:10]} "
                                 f"{out}")
        return out
    finally:
        if subs is not None:
            subs.close()
        for proc in (cli, daemon, workload):
            if proc is not None and proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(work, ignore_errors=True)


# -- the relay tree and the agent run modes ---------------------------------

#: the relay leg: leaves on the relay, subscribers directly on the origin,
#: and its stretches, s: live, the origin killed, after its restart
RELAY_LEAVES = 16
RELAY_DIRECT = 1
RELAY_LIVE_S = 12.0
RELAY_DARK_S = 4.0
RELAY_BACK_S = 8.0
#: the agent leg's 1 Hz stretch and its burst stretch (B4's square wave,
#: then idle), s
AGENT_SCRAPE_S = 12.0
AGENT_BURST_S = 8.0
AGENT_BURST_IDLE_S = 3.0
AGENT_HZ = 100
#: the in-process measurements after the legs: the burst loop's CPU split
#: (the exporter's loop, then the agent's), s each, and the agent's collect
#: by NVML entry point, its watches at COLLECT_HZ for COLLECT_S: enough
#: sweeps for a p99 (``bench_gpu.tail_ms`` gives none under 100)
SPLIT_S = 6.0
COLLECT_HZ = 10.0
COLLECT_S = 12.0
#: the families the agent's exporter is held to the in-process read with,
#: and each one's tolerance (the ``nvml check`` rules)
AGENT_HELD = {"tpu_power_usage": lambda w: max(15.0, 0.1 * w),
              "tpu_core_temp": lambda w: 2.0,
              "tpu_tensorcore_clock": lambda w: 0.05 * w,
              "tpu_hbm_clock": lambda w: 0.05 * w,
              "tpu_hbm_total": lambda w: 0.0,
              "tpu_hbm_used": lambda w: 64.0}


def wait_for(cond, timeout: float, what: str, interval: float = 0.1):
    deadline = time.monotonic() + timeout
    while True:
        got = cond()
        if got:
            return got
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(interval)


def metrics_of(port: int) -> dict:
    """One scrape as {family: [(labels, float value)]}; {} while nothing
    listens."""

    try:
        return _metrics_of(port)
    except OSError:
        return {}


def _metrics_of(port: int) -> dict:
    status, _, body, _ = http_get(port, "/metrics")
    if status != 200:
        raise AssertionError(f"/metrics on {port}: {status}")
    out = {}
    for _, fam, labels, v, ok in samples(body.decode()):
        if ok:
            out.setdefault(fam, []).append((labels, float(v)))
    return out


def one(m: dict, fam: str):
    vals = m.get(fam)
    return vals[0][1] if vals else None


def cpu_share(a: dict, b: dict, dt: float) -> float:
    return round(100.0 * (b["cpu_s"] - a["cpu_s"]) / dt, 3)


def relay_phase(env, work) -> dict:
    """``relay``: the exporter daemon with ``--stream-port`` and
    ``--blackbox-dir`` over NVML, ``python -m tpumon_torch.cli.relay`` on
    its stream (``--metrics-port``), RELAY_LEAVES in-process decoders on
    the relay and RELAY_DIRECT on the origin, beside the train workload.
    RELAY_LIVE_S live, then ``kill -9`` of the daemon for RELAY_DARK_S,
    then the daemon again (same ports, a second recorder directory) for
    RELAY_BACK_S after the relay is up again.  Fails unless every leaf's
    sweeps before the kill are the first recorder's for the same stamps (a
    run of consecutive sweeps opened by the attach keyframe), the leaves
    get stale heartbeats carrying the last live stamp while the relay
    reports ``tpumon_relay_up`` 0 and a growing
    ``tpumon_relay_stale_seconds``, and after the restart every leaf gets
    exactly one mid-stream keyframe followed by deltas, each sweep the
    second recorder's.  Printed: the origin's ``stream`` phase ms (p50,
    max and n: one value a scrape, too few for a p99) with the relay and
    the direct subscriber on it, the relay's CPU share and RSS, bytes a
    leaf a tick, and the staleness at reconnect."""

    from tpumon_torch import blackbox as BB
    from tpumon_torch.loadgen.bench_gpu import tail_ms

    port, sport, rport, mport = (free_port() for _ in range(4))
    bb1, bb2 = os.path.join(work, "bb1"), os.path.join(work, "bb2")
    daemon_args = ["tpumon_torch.exporter.main", "-o", "none", "-d", "1000",
                   "--port", str(port), "--stream-port", str(sport),
                   "--wait-for-tpu", "30", "--blackbox-dir"]
    daemon = relay = leaves = direct = None
    failures, out = [], {}

    def healthy():
        try:
            return http_get(port, "/healthz")[0] == 200
        except OSError:
            return False

    def relay_metrics():
        return metrics_of(mport)

    try:
        daemon = spawn(daemon_args + [bb1], env,
                       os.path.join(work, "daemon1.err"))
        wait_for(healthy, 60, "the stream daemon's /healthz")
        relay = spawn(["tpumon_torch.cli.relay", "--connect",
                       f"127.0.0.1:{sport}", "--listen-port", str(rport),
                       "--listen-host", "127.0.0.1", "--metrics-port",
                       str(mport), "--backoff-base", "0.3", "--backoff-max",
                       "1.0", "--stale-tick-interval", "0.5",
                       "--stale-after", "1.5"], env,
                      os.path.join(work, "relay.err"))
        wait_for(lambda: one(relay_metrics(), "tpumon_relay_up") == 1.0,
                 30, "the relay's upstream")
        leaves, direct = Subscribers(rport), Subscribers(sport)
        for k in range(RELAY_LEAVES):
            leaves.attach(f"leaf{k}")
        for k in range(RELAY_DIRECT):
            direct.attach(f"direct{k}")
        # live: the origin scraped at 1 Hz, the relay measured
        origin_rows, relay_rows = [], []
        r0, t0 = proc_stat(relay.pid), time.monotonic()
        end = t0 + RELAY_LIVE_S
        while time.monotonic() < end:
            tick = time.monotonic()
            origin_rows.append(metrics_of(port))
            relay_rows.append(relay_metrics())
            time.sleep(max(0.0, 1.0 - (time.monotonic() - tick)))
        r1, t1 = proc_stat(relay.pid), time.monotonic()
        # dark: the origin killed
        t_kill = time.time()
        daemon.kill()
        daemon.wait()
        dark = []
        end = time.monotonic() + RELAY_DARK_S
        while time.monotonic() < end:
            m = relay_metrics()
            dark.append((one(m, "tpumon_relay_up"),
                         one(m, "tpumon_relay_stale_seconds")))
            time.sleep(0.5)
        # back: a second daemon on the same ports
        daemon = spawn(daemon_args + [bb2], env,
                       os.path.join(work, "daemon2.err"))
        t_back = time.monotonic()
        wait_for(lambda: one(relay_metrics(), "tpumon_relay_up") == 1.0,
                 60, "the relay's reconnect", interval=0.2)
        reconnect_s = time.monotonic() - t_back
        time.sleep(RELAY_BACK_S)
        final = relay_metrics()
        leaves.close()
        direct.close()
        rc, _ = stop_proc(relay)
        stop_proc(daemon)
        if leaves.errors:
            failures.append(f"leaves: {leaves.errors[:3]}")

        # -- the leaves against the two recorders -----------------------
        def ticks_of(d):
            return [x for x in BB.BlackBoxReader(d).replay()
                    if isinstance(x, BB.ReplayTick)]

        rec1, rec2 = ticks_of(bb1), ticks_of(bb2)
        at1 = {tk.timestamp: k for k, tk in enumerate(rec1)}
        at2 = {tk.timestamp: k for k, tk in enumerate(rec2)}

        def run_of(name, ticks, at, rec, opened_by_keyframe):
            idx = [at.get(tk.timestamp) for tk in ticks]
            if not ticks or None in idx or \
                    idx != list(range(idx[0], idx[0] + len(idx))):
                failures.append(f"{name}: {len(ticks)} ticks, recorder "
                                f"indices {idx[:3]}...{idx[-3:]}")
                return
            kf = [k for k, tk in enumerate(ticks) if tk.keyframe]
            if kf != ([0] if opened_by_keyframe else []):
                failures.append(f"{name}: keyframes at {kf}")
            for tk, k in zip(ticks, idx):
                if tk.snapshot != rec[k].snapshot:
                    failures.append(f"{name}: sweep {tk.timestamp} is not "
                                    f"the recorder's")
                    return

        heartbeats, gaps = [], []
        for name, st in list(leaves.subs.items()) + list(
                direct.subs.items()):
            items = [x for x in st["items"] if isinstance(x, BB.ReplayTick)]
            first_stale = next((k for k, x in enumerate(items) if x.stale),
                               len(items))
            live = items[:first_stale]
            # the kill may cut the recorder's last sweep: the live run is
            # the recorder's but for its last tick
            before = [x for x in live if x.timestamp in at1]
            if len(before) < len(live) - 1:
                failures.append(f"{name}: {len(live) - len(before)} live "
                                f"ticks not recorded")
            run_of(f"{name} (live)", before, at1, rec1, True)
            if name.startswith("direct"):
                continue
            stale = [x for x in items if x.stale]
            after = [x for x in items[first_stale:] if not x.stale]
            heartbeats.append(len(stale))
            if not stale or not live or any(
                    x.timestamp != live[-1].timestamp for x in stale):
                failures.append(f"{name}: stale heartbeats "
                                f"{[x.timestamp for x in stale][:4]}")
            if any(x.timestamp not in at2 for x in after):
                failures.append(f"{name}: ticks after the restart not in "
                                f"the second recorder")
            run_of(f"{name} (after restart)", after, at2, rec2, True)
            if live and after:
                gaps.append(after[0].timestamp - live[-1].timestamp)
        ups = [u for u, _ in dark if u is not None]
        stale_s = [v for _, v in dark if v is not None]
        if not ups or any(u != 0.0 for u in ups[1:]):
            failures.append(f"relay up while the origin is dead: {dark}")
        if len(stale_s) < 3 or not stale_s[-1] > stale_s[1]:
            failures.append(f"stale seconds not growing: {stale_s}")
        if one(final, "tpumon_relay_reconnects_total") != 1.0 or \
                (one(final, "tpumon_relay_subtree_resyncs_total") or 0) < 1:
            failures.append(f"relay counters {final}")

        def phase(rows, name):
            return [1000.0 * v for m in rows for lb, v in
                    m.get("tpumon_exporter_sweep_phase_seconds", [])
                    if lb.get("phase") == name]

        steady = relay_rows[2:]
        ticks = [one(m, "tpumon_relay_upstream_ticks_total") for m in steady]
        sent = [one(m, "tpumon_stream_bytes_sent_total") for m in steady]
        per_leaf_tick = ((sent[-1] - sent[0]) / (ticks[-1] - ticks[0])
                         / RELAY_LEAVES) if len(steady) > 1 and \
            ticks[-1] > ticks[0] else None
        out.update({
            "leaves": RELAY_LEAVES, "direct": RELAY_DIRECT,
            "origin_stream_phase_ms": tail_ms(phase(origin_rows, "stream")),
            "origin_subscribers": one(origin_rows[-1],
                                      "tpumon_stream_subscribers"),
            "relay_cpu_percent": cpu_share(r0, r1, t1 - t0),
            "relay_rss_kib": r1["rss_kib"],
            "bytes_per_leaf_tick": per_leaf_tick,
            "dark": {"up": ups, "stale_seconds": stale_s},
            "reconnect_s": round(reconnect_s, 3),
            "stale_gap_s": {"min": min(gaps) if gaps else None,
                            "max": max(gaps) if gaps else None},
            "heartbeats_per_leaf": {"min": min(heartbeats or [0]),
                                    "max": max(heartbeats or [0])},
            "recorded": {"before": len(rec1), "after": len(rec2)},
            "relay_totals": {k: one(final, f"tpumon_relay_{k}") for k in (
                "reconnects_total", "subtree_resyncs_total",
                "upstream_ticks_total", "heartbeats_total")},
            "relay_exit": rc, "killed_at": t_kill})
        if failures:
            raise AssertionError(f"relay check failed: {failures[:10]} {out}")
        return out
    finally:
        for subs in (leaves, direct):
            if subs is not None:
                subs.close()
        for proc in (relay, daemon):
            if proc is not None and proc.poll() is None:
                proc.kill()
                proc.wait()


def hostengines() -> list:
    """The pids of every running agent: ``tpumon_torch.hostengine`` and
    the native ``gpu-hostengine``."""

    out = []
    for pid in os.listdir("/proc"):
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                argv = f.read().split(b"\0")
        except (OSError, ValueError):
            continue
        if b"tpumon_torch.hostengine" in argv or (
                argv and os.path.basename(argv[0]).startswith(
                    b"gpu-hostengine")):
            out.append(int(pid))
    return out


def agent_phase(K, fields, env, work, native: bool = False) -> dict:
    """``agent``: ``python -m tpumon_torch.hostengine --domain-socket S``
    (with ``native``, the ``native agent:`` leg: ``gpu-hostengine
    --domain-socket S``, built from this checkout; ``tpumon-cdemo`` must
    then also exit 0 against it and print the card)
    over NVML beside the train workload, and its clients: the exporter
    daemon ``--connect unix:S`` (scraped at 1 Hz for AGENT_SCRAPE_S), the
    REST API ``--connect``, ``cli.dmon --connect`` and
    ``cli.hostenginestatus --connect``.  Fails unless the exporter serves
    at least 20 NVML families for the card, each AGENT_HELD value of every
    scrape within its tolerance of one of this process's own NVML reads
    just before and just after that scrape (as ``nvml check`` holds
    nvidia-smi between two reads); the
    exporter's sweeps went over binary ``sweep_frame`` (this process's
    client negotiates it too: binary frames, no JSON sweep); the REST API
    names the remote engine; neither the agent nor the exporter holds a
    CUDA context; after ``kill -9`` of the agent and a restart the
    exporter reconnects and its watch is replayed (the new agent's
    sampler serves it); ``cli.dmon --start-agent`` starts an agent, prints
    its rows and leaves no agent behind.  Then, with the exporter and the
    REST API stopped, the agent again with
    ``--burst-hz AGENT_HZ`` under B4's square wave for AGENT_BURST_S (this
    process's launches) and AGENT_BURST_IDLE_S idle: overruns at most
    OVERRUN_SHARE_MAX of the ticks, and the power integrals of the 1 s
    windows within ENERGY_RATIO_TOL of the energy counter's delta.
    Printed: the agent's and the exporter's CPU share at 1 Hz, the
    agent's at AGENT_HZ, bytes a sweep on the wire after the first
    keyframe, and the CLIs' outputs."""

    from tpumon_torch.backends.agent import AgentBackend

    F = fields.F
    tag = "native" if native else "agent"
    sock = os.path.join(work, f"{tag}.sock")
    addr = f"unix:{sock}"
    port, rport = free_port(), free_port()
    b, i = nvml_open(fields)
    agent = exporter = rest = None
    failures, out = [], {}

    def start_agent(*extra):
        proc = spawn_argv(agent_argv(native) + ["--domain-socket", sock,
                                                *extra],
                          env, os.path.join(work, f"{tag}.err"))
        probe = AgentBackend(address=addr, connect_retry_s=60.0)
        probe.open()
        return proc, probe

    def cli(*args):
        r = subprocess.run([sys.executable, "-m", *args], cwd=HERE, env=env,
                           capture_output=True, text=True, timeout=120)
        if r.returncode != 0:
            failures.append(f"{args[0]} exited {r.returncode}: "
                            f"{r.stderr[-500:]}")
        return r.stdout

    try:
        agent, client = start_agent()
        exporter = spawn(["tpumon_torch.exporter.main", "--connect", addr,
                          "-o", "none", "-d", "1000", "--port", str(port)],
                         env, os.path.join(work, f"{tag}-exporter.err"))
        rest = spawn(["tpumon_torch.restapi.main", "--connect", addr, "-p",
                      str(rport)], env, os.path.join(work, f"{tag}-rest.err"))
        wait_for(lambda: "tpumon_agent_cpu_percent" in metrics_of(port)
                 or exporter.poll() is not None, 60,
                 "the exporter through the agent")
        if exporter.poll() is not None:
            with open(os.path.join(work, f"{tag}-exporter.err")) as f:
                raise AssertionError(f"the exporter exited: "
                                     f"{f.read()[-2000:]}")

        def rest_up():
            try:
                return get_json(rport, "/tpu/status/json")[0] == 200
            except OSError:
                return False

        wait_for(rest_up, 30, "the REST API")
        # the 1 Hz stretch: scrapes, with this process's own NVML read in
        # the same second, and the CLIs beside it
        a0, e0, t0 = proc_stat(agent.pid), proc_stat(exporter.pid), \
            time.monotonic()
        rows, held = [], []
        dmon_out = cli("tpumon_torch.cli.dmon", "--connect", addr, "-c", "3")
        status_out = cli("tpumon_torch.cli.hostenginestatus", "--connect",
                         addr)
        engine = (get_json(rport, "/tpu/status/json")[2] or {}).get("engine")
        held_ids = [fields.by_name(fam).field_id for fam in AGENT_HELD]
        while time.monotonic() < t0 + AGENT_SCRAPE_S:
            tick = time.monotonic()
            before = b.read_fields(i, held_ids)
            m = metrics_of(port)
            after = b.read_fields(i, held_ids)
            rows.append(m)
            held.append((m, (before, after)))
            time.sleep(max(0.0, 1.0 - (time.monotonic() - tick)))
        a1, e1, t1 = proc_stat(agent.pid), proc_stat(exporter.pid), \
            time.monotonic()
        for _ in range(3):
            client.sweep_fields_bulk([(i, [int(F.POWER_USAGE),
                                           int(F.CORE_TEMP)])])
        wire = client.sweep_wire_stats()
        context = {"agent": cuda_context_marks(agent.pid),
                   "exporter": cuda_context_marks(exporter.pid)}
        ids = {fam: fields.by_name(fam).field_id for fam in AGENT_HELD}
        misses = []
        for m, own in held[1:]:
            for fam, tol in AGENT_HELD.items():
                got = [v for lb, v in m.get(fam, [])
                       if lb.get("chip") == str(i)]
                wants = [r.get(ids[fam]) for r in own]
                if not got or not any(
                        w is not None and
                        abs(got[0] - float(w)) <= tol(float(w))
                        for w in wants):
                    misses.append((fam, got[:1], wants))
        served = sorted(f for f, v in rows[-1].items() if f.startswith("tpu_")
                        and any(lb.get("chip") == str(i) for lb, _ in v))
        sweeps = [one(m, "tpumon_exporter_sweeps_total") for m in rows[1:]]
        rpc = [one(m, "tpumon_exporter_sweep_rpc_bytes") for m in rows[1:]]
        per_sweep = ((rpc[-1] - rpc[0]) / (sweeps[-1] - sweeps[0])
                     if len(rows) > 2 and sweeps[-1] > sweeps[0] else None)
        if misses:
            failures.append(f"exporter via the agent vs NVML: {misses[:6]}")
        if len(served) < 20:
            failures.append(f"{len(served)} NVML families served")
        if not wire["binary_frames_total"] or wire["json_sweeps_total"]:
            failures.append(f"sweep_frame not negotiated: {wire}")
        if per_sweep is None or per_sweep > 2000:
            failures.append(f"bytes a sweep {per_sweep}: not delta frames")
        if engine != "tpu-hostengine (remote)":
            failures.append(f"REST engine {engine!r}")
        for k, marks in context.items():
            if marks["libs"] or marks["uvm_mapped"]:
                failures.append(f"the {k} maps {marks}")
        cards = client.chip_count()
        if len([ln for ln in dmon_out.splitlines()
                if ln and not ln.startswith("#")]) != 3 * cards:
            failures.append(f"dmon --connect printed {dmon_out!r}")
        if not status_out.startswith("Engine       : tpu-hostengine"):
            failures.append(f"hostenginestatus printed {status_out!r}")
        cdemo = None
        if native:
            # the C client's demo against the agent: the card and its rows
            from tpumon_torch import _build

            r = subprocess.run([str(_build.native("tpumon-cdemo")), addr,
                                "2"], capture_output=True, text=True,
                               timeout=60)
            card = b.chip_info(i)
            cdemo = r.stdout.splitlines()[:2] + r.stdout.splitlines()[-2:]
            if r.returncode != 0 or card.uuid not in r.stdout or \
                    card.name not in r.stdout:
                failures.append(f"tpumon-cdemo exited {r.returncode}: "
                                f"{r.stdout[-600:]} {r.stderr[-300:]}")

        # kill -9, restart: the exporter reconnects, its watch replayed
        uptime0 = one(rows[-1], "tpumon_agent_uptime_seconds")
        agent.kill()
        agent.wait()
        client.close()
        t_kill = time.monotonic()
        agent, client = start_agent()
        watched = wait_for(
            lambda: client.agent_latest(i, [int(F.CORE_TEMP)]).get(
                int(F.CORE_TEMP)) is not None, 30,
            "the exporter's watch on the restarted agent")
        wait_for(lambda: (one(metrics_of(port),
                              "tpumon_agent_uptime_seconds") or 1e9)
                 < (uptime0 or 0), 30, "the exporter's reconnect")
        replay_s = time.monotonic() - t_kill

        # --start-agent: an agent of its own, gone when the CLI exits
        before = set(hostengines())
        started_out = cli("tpumon_torch.cli.dmon", "--start-agent", "-c", "2")
        left = sorted(set(hostengines()) - before)
        if left or len([ln for ln in started_out.splitlines()
                        if ln and not ln.startswith("#")]) != 2 * cards:
            failures.append(f"--start-agent left {left}: {started_out!r}")

        # the burst stretch: the agent at AGENT_HZ under B4's square wave.
        # The agent closes its one shared 1 s window on any consumer's
        # request, so the exporter's 1 Hz sweeps would close windows
        # between this client's reads and the summed integrals would skip
        # one; this client is the only consumer of the stretch.
        stop_proc(exporter)
        stop_proc(rest)
        stop_proc(agent)
        client.close()
        agent, client = start_agent("--burst-hz", str(AGENT_HZ))
        integral_id = fields.burst_id(int(F.POWER_USAGE), 3)
        E = int(F.TOTAL_ENERGY)
        step, state = K.make_pattern("mxu", device="cuda")
        drain(step(state))
        for name in K.LAUNCHES:
            K.LAUNCHES[name] = 0
        reads, s = [], state
        h0 = client._call("hello")
        b0, tb0 = proc_stat(agent.pid), time.monotonic()
        end = tb0 + AGENT_BURST_S
        nxt = tb0
        while time.monotonic() < end + AGENT_BURST_IDLE_S:
            now = time.monotonic()
            if now >= nxt:
                # each read closes the burst window (over 1 s old)
                reads.append(client.read_fields(i, [E, integral_id]))
                nxt = now + 1.05
            if now < end and (now - tb0) % (2 * SQUARE_HALF_S) < \
                    SQUARE_HALF_S:
                for _ in range(8):
                    s = step(s)
                drain(s)
            else:
                time.sleep(0.01)
        b1, tb1 = proc_stat(agent.pid), time.monotonic()
        launches = K.LAUNCHES["mxu_burn"]
        h1 = client._call("hello")
        ticks_run = AGENT_HZ * (tb1 - tb0)
        over = h1["burst_overruns"] - h0["burst_overruns"]
        integral = sum(r.get(integral_id) or 0.0 for r in reads[2:])
        energy_j = (reads[-1][E] - reads[1][E]) / 1000.0 \
            if len(reads) > 2 else 0.0
        ratio = integral / energy_j if energy_j else None
        if over > OVERRUN_SHARE_MAX * ticks_run:
            failures.append(f"burst overruns {over} of {ticks_run:.0f}")
        if ratio is None or abs(ratio - 1.0) > ENERGY_RATIO_TOL:
            failures.append(f"burst power integral / energy delta {ratio}")
        if launches <= 0:
            failures.append("B4 never launched in the burst stretch")
        out.update({
            "families_served": len(served),
            "held_misses": len(misses), "held_reads": len(held) - 1,
            "cpu_percent_1hz": {"agent": cpu_share(a0, a1, t1 - t0),
                                "exporter": cpu_share(e0, e1, t1 - t0)},
            "rss_kib": {"agent": a1["rss_kib"], "exporter": e1["rss_kib"]},
            "cpu_percent_burst": cpu_share(b0, b1, tb1 - tb0),
            "burst_overruns": over,
            "burst_ticks": round(ticks_run, 1),
            "energy_ratio": ratio, "energy_j": energy_j,
            "power_integral_j": integral,
            "bytes_per_sweep": per_sweep, "client_wire": wire,
            "rest_engine": engine, "cuda_context_marks": context,
            "reconnect_replay_s": round(replay_s, 3),
            "watch_replayed": bool(watched),
            "dmon_connect": dmon_out.splitlines()[-1:],
            "hostenginestatus": status_out.splitlines()[:3],
            "agent_version": h1.get("agent_version"),
            "launches": {"mxu_burn": launches}})
        if native:
            out["cdemo"] = cdemo
        client.close()
        if failures:
            raise AssertionError(f"{tag} check failed: {failures[:10]} "
                                 f"{out}")
        return out
    finally:
        b.close()
        for proc in (rest, exporter, agent):
            if proc is not None and proc.poll() is None:
                proc.kill()
                proc.wait()


#: the agent's own /metrics (--prom-port): scrapes at 1 Hz (the native
#: agent's; the Python agent's leg takes PY_PROM_SCRAPES, its checks the
#: same)
AGENT_PROM_SCRAPES = 30
PY_PROM_SCRAPES = 15


def agent_prom_phase(fields, env, work, drop, native: bool = False,
                     n_scrapes: int = AGENT_PROM_SCRAPES) -> dict:
    """``agent`` with ``--prom-port``: ``python -m tpumon_torch.hostengine
    --prom-port 0 --merge-textfile <drop>`` (with ``native``,
    ``gpu-hostengine``) over NVML beside the train
    workload, its ``/metrics`` scraped at 1 Hz ``n_scrapes`` times,
    no exporter process.  Fails unless every scrape is 200 and holds each
    AGENT_HELD family within its tolerance of one of this process's NVML
    reads just before and just after it (no miss), at least 20 families
    that NVML fills are served for the card, every family of the
    workload's drop file is merged (one file, its series counted), and
    ``/healthz`` is 200.  Printed: scrape wall ms p50 and max with n, the
    agent's CPU share and RSS over the stretch, families served and
    merged."""

    from tpumon_torch.hostengine import SCRAPE_FIELDS

    tag = "native" if native else "agent"
    sock = os.path.join(work, f"{tag}-prom.sock")
    log_path = os.path.join(work, f"{tag}-prom.err")
    b, i = nvml_open(fields)
    agent = None
    failures = []
    try:
        agent = spawn_argv(agent_argv(native) + [
            "--domain-socket", sock, "--prom-port", "0", "--merge-textfile",
            drop], env, log_path)

        def announced():
            with open(log_path) as f:
                m = re.search(r"/metrics on port (\d+)", f.read())
            if m:
                return int(m.group(1))
            return -1 if agent.poll() is not None else None

        port = wait_for(announced, 60, "the agent's prom port")
        if port < 0:
            with open(log_path) as f:
                raise AssertionError(f"the agent exited: {f.read()[-2000:]}")
        nvml_fams = {fields.CATALOG[f].prom_name
                     for f, v in b.read_fields(i, SCRAPE_FIELDS).items()
                     if v is not None}
        held_ids = {fam: fields.by_name(fam).field_id for fam in AGENT_HELD}
        a0, t0 = proc_stat(agent.pid), time.monotonic()
        walls, misses, scrapes = [], [], []
        for _ in range(n_scrapes):
            tick = time.monotonic()
            before = b.read_fields(i, list(held_ids.values()))
            status, _, body, wall = http_get(port, "/metrics")
            after = b.read_fields(i, list(held_ids.values()))
            walls.append(wall)
            if status != 200:
                failures.append(f"/metrics {status}")
                continue
            m = {}
            for _, fam, labels, v, ok in samples(body.decode()):
                if ok:
                    m.setdefault(fam, []).append((labels, float(v)))
            scrapes.append(m)
            for fam, tol in AGENT_HELD.items():
                got = [v for lb, v in m.get(fam, [])
                       if lb.get("chip") == str(i)]
                wants = [r.get(held_ids[fam]) for r in (before, after)]
                if not got or not any(
                        w is not None and
                        abs(got[0] - float(w)) <= tol(float(w))
                        for w in wants):
                    misses.append((fam, got[:1], wants))
            time.sleep(max(0.0, 1.0 - (time.monotonic() - tick)))
        a1, t1 = proc_stat(agent.pid), time.monotonic()
        healthz = http_get(port, "/healthz")[0]
        last = scrapes[-1] if scrapes else {}
        served = sorted(f for f, v in last.items()
                        if any(lb.get("chip") == str(i) for lb, _ in v))
        nvml_served = sorted(set(served) & nvml_fams)
        dropped = read_drop(drop)
        drop_fams = sorted(dropped[0]) if dropped else []
        missing = [f for f in drop_fams if f not in last]
        merged_files = one(last, "tpumon_agent_merged_files")
        merged_series = one(last, "tpumon_agent_merged_series")
        if misses:
            failures.append(f"agent /metrics vs NVML: {misses[:6]}")
        if len(nvml_served) < 20:
            failures.append(f"{len(nvml_served)} NVML families served")
        if not drop_fams or missing or merged_files != 1 or \
                not merged_series:
            failures.append(f"drop file not merged: missing {missing}, "
                            f"files {merged_files}, series {merged_series}")
        if healthz != 200:
            failures.append(f"/healthz {healthz}")
        out = {"scrapes": len(walls),
               "scrape_wall_ms": {"p50": quantile(walls, 0.5),
                                  "max": max(walls) if walls else None,
                                  "n": len(walls)},
               "cpu_percent_1hz": cpu_share(a0, a1, t1 - t0),
               "rss_kib": a1["rss_kib"],
               "families_served": len(served),
               "nvml_families_served": len(nvml_served),
               "drop_families_merged": len(drop_fams) - len(missing),
               "merged_series": merged_series, "held_misses": len(misses),
               "healthz": healthz}
        if failures:
            raise AssertionError(f"{tag} --prom-port check failed: "
                                 f"{failures[:10]} {out}")
        return out
    finally:
        b.close()
        if agent is not None:
            stop_proc(agent)


#: both agents side by side, s a stretch: at 1 Hz, then at --burst-hz
SIDE_S = 12.0


def agents_side_by_side(fields, env, work) -> dict:
    """The Python agent and ``gpu-hostengine`` at once, beside the train
    workload, over the same stretches: each serves this process's sweep
    of the exporter's families at 1 Hz (one ``sweep_frame`` a second, no
    watch: a live NVML read each) for SIDE_S, then both again with
    ``--burst-hz AGENT_HZ`` for SIDE_S.  Returns each agent's CPU share
    and RSS at the end of each stretch (and the burst loop's overruns);
    this records, it does not gate."""

    from tpumon_torch.backends.agent import AgentBackend
    from tpumon_torch.loadgen.bench_gpu import exporter_fields

    b, i = nvml_open(fields)
    b.close()
    fids = exporter_fields()
    out = {}
    for stretch, extra in (("1hz", []),
                           (f"{AGENT_HZ}hz", ["--burst-hz", str(AGENT_HZ)])):
        procs, clients = {}, {}
        try:
            for name, native in (("python", False), ("native", True)):
                sock = os.path.join(work, f"side-{name}.sock")
                procs[name] = spawn_argv(
                    agent_argv(native) + ["--domain-socket", sock, *extra],
                    env, os.path.join(work, f"side-{name}.err"))
                clients[name] = c = AgentBackend(address=f"unix:{sock}",
                                                 connect_retry_s=60.0)
                c.open()
            for c in clients.values():
                c.sweep_fields_bulk([(i, fids)])
            h0 = {n: c._call("hello") for n, c in clients.items()}
            s0, t0 = {n: proc_stat(p.pid) for n, p in procs.items()}, \
                time.monotonic()
            while time.monotonic() < t0 + SIDE_S:
                tick = time.monotonic()
                for c in clients.values():
                    c.sweep_fields_bulk([(i, fids)])
                time.sleep(max(0.0, 1.0 - (time.monotonic() - tick)))
            s1, t1 = {n: proc_stat(p.pid) for n, p in procs.items()}, \
                time.monotonic()
            h1 = {n: c._call("hello") for n, c in clients.items()}
            rec = {}
            for n in procs:
                rec[n] = {"cpu_percent": cpu_share(s0[n], s1[n], t1 - t0),
                          "rss_kib": s1[n]["rss_kib"],
                          "threads": s1[n]["threads"]}
                if extra:
                    rec[n]["burst_overruns"] = (h1[n]["burst_overruns"]
                                                - h0[n]["burst_overruns"])
            rec["seconds"] = round(t1 - t0, 3)
            out[stretch] = rec
        finally:
            for c in clients.values():
                c.close()
            for p in procs.values():
                stop_proc(p)
    return out


#: the ``fleet`` leg: simulated hosts beside the card's own agent (256
#: hosts in all), chips each (a DGX H100 node's count), the farm's
#: processes, the flat poller's measured ticks at 1 Hz, the supervised
#: CLI's shards, how long its view may take to be the flat one's again
#: after a SIGKILL (the reference's ``bench_supervisor`` budget), s, the
#: steady stretch its tables are held to the flat view over, s, and the
#: supervisor process's measured ticks at 1 Hz
FLEET_SIM_HOSTS = 255
FLEET_CHIPS = 8
FLEET_FARM_PROCS = 4
FLEET_TICKS = 20
FLEET_SHARDS = 4
FLEET_RECOVER_S = 20.0
FLEET_STEADY_S = 10.0
FLEET_SUP_TICKS = 20
#: the fleet leg's poll planes, as ``TPUMON_NATIVE`` selects them: 1 makes
#: a process without the native engine fail instead of polling on Python
FLEET_PLANES = {"python": "0", "native": "1"}
#: what no fleet process (agent, farms, pollers, shard children) may
#: import; ``sitecustomize`` on their PYTHONPATH refuses it and logs it
FLEET_REFUSED = ("tpumon", "jax", "jaxlib", "torch")
FLEET_GUARD = """\
import os
import sys


class _Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in {refused!r}:
            with open(os.environ["FLEET_IMPORT_LOG"], "a") as f:
                f.write(f"{{os.getpid()}} {{name}}\\n")
            raise ImportError(f"{{name}} refused in a fleet process")
        return None


sys.meta_path.insert(0, _Refuse())
""".format(refused=FLEET_REFUSED)
#: the flat poller's process: the poller ``create_fleet_poller`` picks
#: (``TPUMON_NATIVE``: 0 the Python ``FleetPoller``, 1 the native
#: engine's ``NativeFleetPoller``) over the targets file at 1 Hz, one warm
#: tick then ``ticks`` measured ones (wall and the thread's CPU clock
#: around each ``poll``: the engine runs the tick on that thread, bytes,
#: hosts up, the first target's row with the tick's wall-clock span),
#: then its CPU share and RSS over the stretch, every simulated row against
#: its farm's values (``_bench_host_values`` of its seed, aggregated), the
#: last table and the poller's class
FLEET_FLAT = r"""
import json, sys, time
from tpumon_torch.agentsim import _bench_host_values
from tpumon_torch.cli.fleet import _FIELDS, render
from tpumon_torch.fleetpoll import aggregate_host_sample, create_fleet_poller

path, ticks, chips = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
targets = [ln.strip() for ln in open(path) if ln.strip()]
poller = create_fleet_poller(targets, _FIELDS, timeout_s=3.0)
poller.poll()
out, kept = [], []
cpu0, t_start = time.process_time(), time.monotonic()
for k in range(ticks):
    time.sleep(max(0.0, t_start + k - time.monotonic()))
    w0, t0 = time.time(), time.monotonic()
    c0 = time.clock_gettime(time.CLOCK_THREAD_CPUTIME_ID)
    samples = poller.poll()
    c1 = time.clock_gettime(time.CLOCK_THREAD_CPUTIME_ID)
    t1, w1 = time.monotonic(), time.time()
    card = samples[0]
    out.append({"wall_ms": 1e3 * (t1 - t0), "cpu_ms": 1e3 * (c1 - c0),
                "bytes": poller.tick_bytes_sent + poller.tick_bytes_recv,
                "up": sum(s.up for s in samples), "span": [w0, w1],
                "card": {f: getattr(card, f) for f in (
                    "up", "chips", "driver", "power_w", "max_temp_c",
                    "mean_tc_util", "mean_hbm_util", "hbm_used_mib",
                    "hbm_total_mib", "links_up", "dead_chips", "error")}})
    kept.append(samples)
wall, cpu = time.monotonic() - t_start, time.process_time() - cpu0
with open("/proc/self/status") as f:
    rss = [int(ln.split()[1]) for ln in f if ln.startswith("VmRSS")][0]
want = [aggregate_host_sample(t, chips, "sim 1.0",
                              _bench_host_values(i, chips, _FIELDS), 0)
        for i, t in enumerate(targets[1:])]
mismatched = sorted({i for samples in kept
                     for i, (got, w) in enumerate(zip(samples[1:], want))
                     if repr(got) != repr(w)})
poller.close()
print(json.dumps({"ticks": out, "cpu_s": cpu, "wall_s": wall,
                  "rss_kib": rss, "mismatched": mismatched[:8],
                  "n_mismatched": len(mismatched),
                  "table": render(kept[-1]).splitlines(),
                  "poller": type(poller).__name__}))
"""
#: the supervisor's cost, as the reference's ``bench_supervisor`` reads
#: it: ``ShardSupervisor`` over the targets file as the CLI builds it with
#: ``-d 1``, every host up, then ``ticks`` ticks of ``poll`` at 1 Hz; the
#: health watch's own CPU counter (``health_cpu_s_total``, its thread's
#: clock) and passes over the process's CPU in the same stretch
FLEET_SUPERVISE = r"""
import json, sys, time
from tpumon_torch.cli.fleet import _FIELDS
from tpumon_torch.supervisor import ShardSupervisor

path, shards, ticks = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
targets = [ln.strip() for ln in open(path) if ln.strip()]
t_spawn = time.monotonic()
sup = ShardSupervisor(targets, _FIELDS, shards=shards, delay_s=1.0,
                      timeout_s=3.0)
sup.start()
try:
    while not all(s.up for s in sup.poll()):
        if time.monotonic() > t_spawn + 60.0:
            raise SystemExit("the supervised shards never had every host up")
        time.sleep(1.0)
    up_s = time.monotonic() - t_spawn
    cpu0, t_start = time.process_time(), time.monotonic()
    hc0, hp0 = sup.health_cpu_s_total, sup.health_passes_total
    up = []
    for k in range(ticks):
        time.sleep(max(0.0, t_start + k - time.monotonic()))
        up.append(sum(s.up for s in sup.poll()))
    wall, cpu = time.monotonic() - t_start, time.process_time() - cpu0
    hcpu = sup.health_cpu_s_total - hc0
    passes = sup.health_passes_total - hp0
finally:
    sup.close()
print(json.dumps({"all_up_s": up_s, "up": up, "wall_s": wall,
                  "cpu_s": cpu, "health_cpu_s": hcpu,
                  "health_passes": passes}))
"""


class FleetTables:
    """The supervised CLI's tables as they arrive on its stdout: (arrival
    monotonic s, {first token: row line}) each, read on a thread."""

    def __init__(self, proc) -> None:
        self.tables = []
        self._t = threading.Thread(target=self._read, args=(proc,),
                                   daemon=True)
        self._t.start()

    def _read(self, proc) -> None:
        rows = {}
        for line in proc.stdout:
            line = line.rstrip("\n")
            if line.startswith("SLICE ("):
                self.tables.append((time.monotonic(), rows))
                rows = {}
            elif line and not line.startswith(("host ", "-")):
                rows[line.split()[0]] = line


def fleet_view(rows: dict, flat: dict, card: str) -> bool:
    """A table is the flat view: every simulated host's row the flat
    poller's line for line, and the card's host up (its values move
    between two reads; the flat leg holds them to NVML)."""

    line = rows.get(card)
    return (line is not None and line.split()[1] != "DOWN"
            and all(rows.get(a) == ln for a, ln in flat.items()))


def children_of(pid: int) -> list:
    """(pid, argv) of a process's children."""

    out = []
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open(f"/proc/{d}/stat") as f:
                ppid = int(f.read().rsplit(")", 1)[1].split()[1])
            with open(f"/proc/{d}/cmdline", "rb") as f:
                argv = [a.decode() for a in f.read().split(b"\0") if a]
        except (OSError, ValueError, IndexError):
            continue
        if ppid == pid:
            out.append((int(d), argv))
    return out


def fleet_phase(fields, env, work) -> dict:
    """``fleet``: the fleet plane over the card's host among a simulated
    fleet, beside the train workload.  The port's agent over NVML
    (``python -m tpumon_torch.hostengine``) and FLEET_SIM_HOSTS simulated
    hosts x FLEET_CHIPS chips in FLEET_FARM_PROCS farm processes
    (``python -m tpumon_torch.agentsim --procs``): 256 targets with
    ``cli.fleet._FIELDS``.  Every fleet process runs under FLEET_GUARD.

    * flat, on each poll plane (FLEET_PLANES): the poller
      ``create_fleet_poller`` picks in its own process (FLEET_FLAT), 1
      Hz, FLEET_TICKS ticks after a warm one: ``FleetPoller`` with
      ``TPUMON_NATIVE=0``, then ``NativeFleetPoller`` with
      ``TPUMON_NATIVE=1`` (a missing engine fails the run).  Fails if the
      poller is not the plane's, a tick has a host DOWN, a simulated row
      differs from its farm's values, the card's row (chips, power,
      hottest temperature, HBM used and total, links) is off from every
      one of this process's NVML reads within a second of the tick by
      more than the ``nvml check`` tolerances, or the two planes' tables
      differ in a simulated row.  Both planes' tick wall, poller CPU,
      process CPU share, RSS and bytes a host-tick are printed side by
      side (``planes_side_by_side``).
    * supervised, as operators run it, on the native engine: ``python -m
      tpumon_torch.cli.fleet --targets-file F --shards FLEET_SHARDS
      --supervise --metrics-port P -d 1``.  Its tables must become the
      flat view (:func:`fleet_view`) and stay it over a FLEET_STEADY_S
      stretch; its ``/metrics`` is scraped and must read
      ``tpumon_poll_native 1`` and ``tpumon_codec_native 1``; one shard
      child is SIGKILLed and its view must be the flat one again, with
      the restart counted, within FLEET_RECOVER_S.
    * the supervisor's cost: ``ShardSupervisor`` in its own process
      (FLEET_SUPERVISE, native), FLEET_SUP_TICKS ticks at 1 Hz with every
      host up; the health watch's CPU over the process's.
    * once: ``--connect <agent> --once --check --expect-chips <cards>``
      (native) exits 0 with a PASS line naming the agent and NVML's
      driver.
    * no process of them imported a refused module."""

    import signal as _signal

    from tpumon_torch.cli.fleet import _FIELDS
    from tpumon_torch.fleetpoll import aggregate_host_sample

    fenv, refused_log = guarded_env(env, work, "fleet")

    sock = os.path.join(work, "fleet-agent.sock")
    agent_addr = f"unix:{sock}"
    farm_dir = os.path.join(work, "farm")
    os.makedirs(farm_dir, exist_ok=True)
    targets_file = os.path.join(work, "fleet.targets")
    b, i = nvml_open(fields)
    cards = b.chip_count()
    driver = b.versions().driver
    agent = farm = cli = None
    failures, out = [], {}
    t_leg = time.monotonic()
    try:
        from tpumon_torch.backends.agent import AgentBackend

        agent = spawn(["tpumon_torch.hostengine", "--domain-socket", sock],
                      fenv, os.path.join(work, "fleet-agent.err"))
        hello = AgentBackend(address=agent_addr, connect_retry_s=60.0)
        hello.open()
        hello.close()
        farm = subprocess.Popen(
            [sys.executable, "-m", "tpumon_torch.agentsim", "--hosts",
             str(FLEET_SIM_HOSTS), "--chips", str(FLEET_CHIPS), "--procs",
             str(FLEET_FARM_PROCS), "--unix-dir", farm_dir], cwd=HERE,
            env=fenv, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=open(os.path.join(work, "farm.err"), "w"), text=True)
        first = json.loads(farm.stdout.readline() or "{}")
        sims = first.get("addrs", [])
        if not first.get("ok") or len(sims) != FLEET_SIM_HOSTS:
            raise AssertionError(f"the farm did not start: {first}")
        farm_kids = children_of(farm.pid)
        targets = [agent_addr] + sims
        with open(targets_file, "w") as f:
            f.write("\n".join(targets) + "\n")
        out["hosts"], out["chips_per_sim"] = len(targets), FLEET_CHIPS
        out["setup_s"] = round(time.monotonic() - t_leg, 3)

        # -- flat, each plane, with this process's NVML reads beside it ----
        def flat_leg(plane: str, want: str):
            """One FLEET_FLAT run on ``plane`` (TPUMON_NATIVE 0 or 1);
            its gates' failures are prefixed with the plane.  -> (the
            printed summary, {simulated address: its table row})."""

            nv_reads, stop = [], threading.Event()

            def sample_nvml():
                while not stop.is_set():
                    per = {c: b.read_fields(c, list(_FIELDS))
                           for c in range(cards)}
                    nv_reads.append((time.time(), aggregate_host_sample(
                        agent_addr, cards, driver, per, 0)))
                    stop.wait(0.25)

            sampler = threading.Thread(target=sample_nvml, daemon=True)
            sampler.start()
            try:
                flat_proc = subprocess.run(
                    [sys.executable, "-c", FLEET_FLAT, targets_file,
                     str(FLEET_TICKS), str(FLEET_CHIPS)], cwd=HERE,
                    env=dict(fenv, TPUMON_NATIVE=FLEET_PLANES[plane]),
                    capture_output=True, text=True,
                    timeout=FLEET_TICKS + 60)
            finally:
                stop.set()
                sampler.join()
            if flat_proc.returncode != 0:
                raise AssertionError(f"the {plane} flat poller exited "
                                     f"{flat_proc.returncode}: "
                                     f"{flat_proc.stderr[-2000:]}")
            flat = json.loads(flat_proc.stdout.strip().splitlines()[-1])
            ticks = flat["ticks"]
            walls = [t["wall_ms"] for t in ticks]
            down = [t["up"] for t in ticks if t["up"] != len(targets)]
            if flat["poller"] != want:
                failures.append(f"{plane}: the poller is {flat['poller']}, "
                                f"not {want}")
            if down:
                failures.append(f"{plane}: flat ticks with a host down: "
                                f"up {down}")
            if flat["n_mismatched"]:
                failures.append(f"{plane}: simulated rows off their farm's "
                                f"values: {flat['n_mismatched']} "
                                f"({flat['mismatched']})")
            held = {"power_w": lambda w: max(15.0 * cards, 0.1 * w),
                    "max_temp_c": lambda w: 2.0,
                    "hbm_total_mib": lambda w: 0.0,
                    "hbm_used_mib": lambda w: 64.0 * cards,
                    "links_up": lambda w: 0.0,
                    "chips": lambda w: 0.0}
            card_misses, card_err = [], {k: 0.0 for k in held}
            for t in ticks:
                row = t["card"]
                near = [s for w, s in nv_reads
                        if t["span"][0] - 1.0 <= w <= t["span"][1] + 1.0]
                best = None
                for s in near:
                    errs = {k: (abs(float(row[k]) - float(getattr(s, k)))
                                if row[k] is not None
                                and getattr(s, k) is not None else math.inf)
                            for k in held}
                    if all(errs[k] <= tol(float(getattr(s, k) or 0.0))
                           for k, tol in held.items()):
                        best = errs
                        break
                if best is None or not row["up"] or row["dead_chips"]:
                    card_misses.append((row, [s.__dict__
                                              for _, s in near][:2]))
                else:
                    card_err = {k: max(card_err[k], v)
                                for k, v in best.items()}
            if card_misses:
                failures.append(f"{plane}: the card's row vs NVML: "
                                f"{len(card_misses)} of {len(ticks)} ticks, "
                                f"{card_misses[:2]}")
            host_ticks = len(targets) * len(ticks)
            summary = {
                "poller": flat["poller"], "ticks": len(ticks),
                "tick_wall_ms": {"p50": quantile(walls, 0.5),
                                 "p99": quantile(walls, 0.99),
                                 "n": len(walls), "max": max(walls)},
                "poller_cpu_ms_per_tick": sum(t["cpu_ms"] for t in ticks) /
                len(ticks),
                "process_cpu_percent": 100.0 * flat["cpu_s"] /
                flat["wall_s"],
                "rss_kib": flat["rss_kib"],
                "bytes_per_host_tick": sum(t["bytes"] for t in ticks) /
                host_ticks,
                "hosts_up_per_tick": sorted({t["up"] for t in ticks}),
                "card_row_max_err": card_err, "nvml_reads": len(nv_reads),
                "card_row_last": ticks[-1]["card"]}
            rows = {}
            for line in flat["table"]:
                key = line.split()[0] if line.strip() else ""
                if key in sims:
                    rows[key] = line
            if len(rows) != len(sims):
                failures.append(f"{plane}: the flat table has {len(rows)} "
                                f"simulated rows")
            return summary, rows

        out["flat"], flat_rows = flat_leg("python", "FleetPoller")
        out["flat_native"], native_rows = flat_leg("native",
                                                   "NativeFleetPoller")
        if native_rows != flat_rows:
            failures.append("the native flat table's simulated rows are not "
                            "the Python one's")
        out["planes_side_by_side"] = {
            plane: {k: out[key][k] for k in (
                "tick_wall_ms", "poller_cpu_ms_per_tick",
                "process_cpu_percent", "rss_kib", "bytes_per_host_tick")}
            for plane, key in (("python", "flat"), ("native", "flat_native"))}

        # -- supervised, as operators run it, on the native engine ----------
        nenv = dict(fenv, TPUMON_NATIVE=FLEET_PLANES["native"])
        mport = free_port()
        t_sup = time.monotonic()
        cli = subprocess.Popen(
            [sys.executable, "-m", "tpumon_torch.cli.fleet",
             "--targets-file", targets_file, "--shards", str(FLEET_SHARDS),
             "--supervise", "--metrics-port", str(mport), "-d", "1"],
            cwd=HERE, env=nenv, stdout=subprocess.PIPE,
            stderr=open(os.path.join(work, "fleet-cli.err"), "w"),
            text=True)
        tables = FleetTables(cli)

        def converged_after(t0):
            for at, rows in tables.tables:
                if at > t0 and fleet_view(rows, flat_rows, agent_addr):
                    return at
            if cli.poll() is not None:
                raise AssertionError(f"the supervised CLI exited "
                                     f"{cli.returncode}")
            return None

        first_at = wait_for(lambda: converged_after(t_sup), 90,
                            "the supervised view")
        sup = {"first_converge_s": round(first_at - t_sup, 3)}

        def health():
            status, _, body, wall = http_get(mport, "/metrics")
            m = {}
            for _, fam, labels, v, ok in samples(body.decode()):
                if ok:
                    m.setdefault(fam, []).append((labels, float(v)))
            return status, m, wall

        wait_for(lambda: all(v == 1.0 for _, v in health()[1].get(
            "tpumon_fleet_shard_up", [({}, 0.0)])), 30,
            "every shard up on /metrics")
        c0, s0 = proc_stat(cli.pid), time.monotonic()
        n0 = len(tables.tables)
        time.sleep(FLEET_STEADY_S)
        st1, m1, scrape_ms = health()
        planes = {fam: [v for _, v in m1.get(fam, [])] for fam in (
            "tpumon_poll_native", "tpumon_codec_native")}
        if any(v != [1.0] for v in planes.values()):
            failures.append(f"the supervised /metrics reads {planes}")
        c1, s1 = proc_stat(cli.pid), time.monotonic()
        steady = tables.tables[n0:]
        if not steady or not all(fleet_view(rows, flat_rows, agent_addr)
                                 for _, rows in steady):
            failures.append("a steady supervised table is not the flat view")
        pcpu = c1["cpu_s"] - c0["cpu_s"]
        kids = [(pid, argv) for pid, argv in children_of(cli.pid)
                if "--shard-serve-unix" in argv]
        bad_argv = [argv[:3] for _, argv in kids
                    if argv[1:3] != ["-m", "tpumon_torch.cli.fleet"]]
        if len(kids) != FLEET_SHARDS or bad_argv:
            failures.append(f"shard children {len(kids)}, argv {bad_argv}")
        sup.update({
            "steady_tables": len(steady),
            "process_cpu_percent": round(100.0 * pcpu / (s1 - s0), 3),
            "process_cpu_ms_per_tick": round(1e3 * pcpu / max(1, len(
                steady)), 3),
            "rss_kib": c1["rss_kib"],
            "metrics_scrape_ms": round(scrape_ms, 3),
            "metrics_status": st1, "native_gauges": planes,
            "shard_children_rss_kib": sorted(
                proc_stat(pid)["rss_kib"] for pid, _ in kids)})
        # SIGKILL one shard child mid-run
        vpid, vargv = kids[0]
        vid = vargv[vargv.index("--shard-id") + 1]
        n_kill = len(tables.tables)
        t_kill = time.monotonic()
        os.kill(vpid, _signal.SIGKILL)
        try:
            back = wait_for(lambda: converged_after(t_kill),
                            FLEET_RECOVER_S, "the view after the SIGKILL")
        except AssertionError:
            back = None
            failures.append(f"the supervised view was not the flat one "
                            f"{FLEET_RECOVER_S} s after the SIGKILL")
        if back is not None:
            after = [at for at, _ in tables.tables[n_kill:] if at <= back]
            st2, m2, _ = health()
            restarts = [v for lb, v in m2.get(
                "tpumon_fleet_shard_restarts_total", [])
                if lb.get("shard") == vid]
            respawned = [pid for pid, argv in children_of(cli.pid)
                         if "--shard-serve-unix" in argv
                         and argv[argv.index("--shard-id") + 1] == vid]
            if restarts != [1.0] or not respawned or vpid in respawned:
                failures.append(f"restart not counted: {restarts}, "
                                f"{respawned} after killing {vpid}")
            # ticks: the tables printed after the kill up to the first
            # that is the flat view again, that one included
            sup["recovery"] = {"shard": int(vid),
                               "ticks_to_converge": len(after),
                               "tables_not_flat": len(after) - 1,
                               "s_to_converge": round(back - t_kill, 3),
                               "budget_s": FLEET_RECOVER_S}
        alive = [pid for pid, _ in children_of(cli.pid)]
        rc, _ = stop_proc(cli, timeout=20.0)
        left = [pid for pid in alive if os.path.exists(f"/proc/{pid}")]
        if rc != 0 or left:
            failures.append(f"the supervised CLI exited {rc} on SIGTERM, "
                            f"children left {left}")
        out["supervised"] = sup

        # -- the supervisor's cost, from its own counter ---------------------
        sv = subprocess.run(
            [sys.executable, "-c", FLEET_SUPERVISE, targets_file,
             str(FLEET_SHARDS), str(FLEET_SUP_TICKS)], cwd=HERE, env=nenv,
            capture_output=True, text=True, timeout=FLEET_SUP_TICKS + 90)
        if sv.returncode != 0:
            raise AssertionError(f"the supervisor process exited "
                                 f"{sv.returncode}: {sv.stderr[-2000:]}")
        sv = json.loads(sv.stdout.strip().splitlines()[-1])
        if any(u != len(targets) for u in sv["up"]):
            failures.append(f"supervised ticks with a host down: up "
                            f"{sv['up']}")
        sup["health"] = {
            "ticks": len(sv["up"]), "all_up_s": round(sv["all_up_s"], 3),
            "process_cpu_percent": round(
                100.0 * sv["cpu_s"] / sv["wall_s"], 3),
            "process_cpu_ms_per_tick": round(
                1e3 * sv["cpu_s"] / len(sv["up"]), 3),
            "health_cpu_ms_per_tick": round(
                1e3 * sv["health_cpu_s"] / len(sv["up"]), 4),
            "health_passes": sv["health_passes"],
            "health_share_of_tick_cpu": round(
                sv["health_cpu_s"] / max(1e-9, sv["cpu_s"]), 4)}

        # -- once: the readiness gate on the card's host ---------------------
        once = subprocess.run(
            [sys.executable, "-m", "tpumon_torch.cli.fleet", "--connect",
             agent_addr, "--once", "--check", "--expect-chips", str(cards)],
            cwd=HERE, env=nenv, capture_output=True, text=True, timeout=60)
        line = next((ln for ln in once.stdout.splitlines()
                     if "[PASS]" in ln or "[FAIL]" in ln), "")
        if once.returncode != 0 or agent_addr not in line or \
                f"[PASS] {cards} chips" not in line or driver not in line:
            failures.append(f"--once --check exited {once.returncode}: "
                            f"{once.stdout[-500:]}")
        out["once"] = {"rc": once.returncode, "line": line.strip()}
        with open(refused_log) as f:
            refused = f.read().split("\n")
        refused = [r for r in refused if r]
        if refused:
            failures.append(f"fleet processes imported {refused[:6]}")
        out["processes"] = {"farm": 1 + len(farm_kids), "shards":
                            FLEET_SHARDS, "refused_imports": len(refused)}
        out["leg_s"] = round(time.monotonic() - t_leg, 3)
        if failures:
            raise AssertionError(f"fleet check failed: {failures[:8]} {out}")
        return out
    finally:
        b.close()
        if cli is not None and cli.poll() is None:
            stop_proc(cli, timeout=20.0)
        if farm is not None:
            try:
                farm.stdin.write(json.dumps({"op": "quit"}) + "\n")
                farm.stdin.flush()
                farm.wait(timeout=20)
            except (OSError, subprocess.TimeoutExpired):
                farm.kill()
                farm.wait()
        if agent is not None:
            stop_proc(agent)


def guarded_env(env, work, name):
    """``env`` with FLEET_GUARD on its ``PYTHONPATH`` (a ``sitecustomize``
    in ``<work>/<name>-guard`` that refuses and logs ``tpumon``, ``jax``
    and ``torch``) -> (that env, the log of refused imports).  Fails
    unless a child asking for torch is refused."""

    guard = os.path.join(work, f"{name}-guard")
    os.makedirs(guard, exist_ok=True)
    with open(os.path.join(guard, "sitecustomize.py"), "w") as f:
        f.write(FLEET_GUARD)
    refused_log = os.path.join(work, f"{name}-refused.log")
    open(refused_log, "w").close()
    genv = dict(env, PYTHONPATH=guard + os.pathsep + env["PYTHONPATH"],
                FLEET_IMPORT_LOG=refused_log)
    probe = subprocess.run([sys.executable, "-c", "import torch"],
                           env=genv, capture_output=True, text=True,
                           timeout=60)
    if probe.returncode == 0 or "torch refused" not in probe.stderr:
        raise AssertionError(f"the import guard does not hold: "
                             f"{probe.stderr[-500:]}")
    open(refused_log, "w").close()
    return genv, refused_log


def refused_imports(log_path: str) -> list:
    with open(log_path) as f:
        return sorted({ln.split()[1] for ln in f if ln.strip()})


#: the ``chaos`` leg: the port's scenario corpus, how many it holds, the
#: most the CLI may take over it (s), and the positive control: a
#: scenario whose replay invariant must go red (an ECC_DBE marker that no
#: action injects; ``tests/test_chaos.py::test_failed_invariant_fails_the_run``)
CHAOS_CORPUS = os.path.join("tests", "data", "torch_scenarios")
CHAOS_SCENARIOS = 8
CHAOS_TIMEOUT_S = 240.0
CHAOS_RED = """\
name: goes-red
seed: 3
topology:
  hosts: 2
  chips: 1
ticks: 6
tick_interval_s: 0.05
actions:
  - at: 2
    do: churn
    mutations: 2
invariants:
  replay_fault_window: true
expect:
  window: [2, 4]
  markers: ["event:ECC_DBE"]
"""


def chaos_run(paths, env, out_dir, log_path) -> dict:
    """``python -m tpumon_torch.cli.chaos run PATHS --out OUT --json`` as a
    process of its own: its exit code, each report with the seconds from
    the start to its line, and its CPU (its own and its reaped children's,
    ``wait4``) over its wall time."""

    t0 = time.monotonic()
    with open(log_path, "w") as err:
        proc = subprocess.Popen(
            [sys.executable, "-m", "tpumon_torch.cli.chaos", "run", *paths,
             "--out", out_dir, "--json"], cwd=HERE, env=env,
            stdout=subprocess.PIPE, stderr=err, text=True)
    killer = threading.Timer(CHAOS_TIMEOUT_S, proc.kill)
    killer.start()
    try:
        reports = [(time.monotonic() - t0, json.loads(line))
                   for line in proc.stdout if line.strip()]
        _, status, usage = os.wait4(proc.pid, 0)
    finally:
        killer.cancel()
    proc.returncode = os.waitstatus_to_exitcode(status)
    wall = time.monotonic() - t0
    cpu = usage.ru_utime + usage.ru_stime
    return {"rc": proc.returncode, "reports": reports, "wall_s": wall,
            "cpu_s": cpu, "cpu_percent": round(100.0 * cpu / wall, 3)}


def chaos_phase(env, work) -> dict:
    """``chaos``: the port's chaos harness over its whole corpus
    (CHAOS_CORPUS) in one CLI process under the import guard, beside the
    train workload, with ``TPUMON_NATIVE=1``: the system under test polls
    on the native engine (a missing engine fails the run), the harness's
    reference poller stays the Python ``FleetPoller``.  Fails unless the
    CLI exits 0 with CHAOS_SCENARIOS reports, each green, and the positive
    control (CHAOS_RED, its own CLI process) exits non-zero with one red
    report; or if a process of either imported ``tpumon``, ``jax`` or
    ``torch``.  Printed: each scenario's
    verdict, ticks to converge, restarts and wall seconds, the CLI's CPU
    share (with its children) over its wall."""

    import glob

    genv, refused_log = guarded_env(env, work, "chaos")
    genv["TPUMON_NATIVE"] = FLEET_PLANES["native"]
    paths = sorted(glob.glob(os.path.join(HERE, CHAOS_CORPUS, "*.yaml")))
    run = chaos_run(paths, genv, os.path.join(work, "chaos"),
                    os.path.join(work, "chaos.err"))
    scenarios, prev = {}, 0.0
    for at, rep in run["reports"]:
        scenarios[rep["scenario"]] = {
            "ok": rep["ok"], "ticks_to_converge": rep["ticks_to_converge"],
            "restarts": rep["restarts_total"],
            "wall_s": round(at - prev, 3), "violations": rep["violations"]}
        prev = at
    red_yaml = os.path.join(work, "goes-red.yaml")
    with open(red_yaml, "w") as f:
        f.write(CHAOS_RED)
    red = chaos_run([red_yaml], genv, os.path.join(work, "chaos-red"),
                    os.path.join(work, "chaos-red.err"))
    out = {"scenarios": scenarios, "sut_plane": "native",
           "green": sum(s["ok"] for s in scenarios.values()),
           "rc": run["rc"], "wall_s": round(run["wall_s"], 3),
           "cpu_s": round(run["cpu_s"], 3),
           "cpu_percent": run["cpu_percent"],
           "red_control": {"rc": red["rc"], "ok": [
               r["ok"] for _, r in red["reports"]]},
           "refused_imports": refused_imports(refused_log)}
    failures = []
    if run["rc"] != 0 or len(scenarios) != CHAOS_SCENARIOS or \
            out["green"] != CHAOS_SCENARIOS:
        with open(os.path.join(work, "chaos.err")) as f:
            tail = f.read()[-1500:]
        failures.append(f"corpus not green: rc {run['rc']}, "
                        f"{out['green']}/{len(scenarios)}: {tail}")
    if red["rc"] == 0 or out["red_control"]["ok"] != [False]:
        failures.append(f"the red control passed: {out['red_control']}")
    if out["refused_imports"]:
        failures.append(f"refused imports {out['refused_imports']}")
    if failures:
        raise AssertionError(f"chaos check failed: {failures} {out}")
    return out


#: the ``deploy`` leg: the manifests started as deployed, the seconds they
#: run at the manifest's ``-d``, and the families the reused dashboard and
#: alert rules name (their ``expr`` fields)
DEPLOY_MANIFESTS = (os.path.join("deploy", "gpu", "k8s",
                                 "tpumon-daemonset.yaml"),
                    os.path.join("deploy", "gpu", "k8s",
                                 "tpumon-agent-daemonset.yaml"))
DEPLOY_S = 10.0
DEPLOY_DASHBOARD = os.path.join("deploy", "grafana", "tpumon-dashboard.json")
DEPLOY_RULES = os.path.join("deploy", "k8s", "prometheus",
                            "tpumon-alert-rules.yaml")
DEPLOY_README = os.path.join("deploy", "gpu", "README.md")
FAMILY_RE = re.compile(r"\btpu(?:mon)?_[a-z0-9_]+")


def named_families() -> set:
    """The metric families the reused Grafana dashboard and alert rules
    query: the names in their ``expr`` fields."""

    names = set()

    def walk(o):
        if isinstance(o, dict):
            for k, v in o.items():
                if k == "expr" and isinstance(v, str):
                    names.update(FAMILY_RE.findall(v))
                else:
                    walk(v)
        elif isinstance(o, list):
            for v in o:
                walk(v)

    with open(os.path.join(HERE, DEPLOY_DASHBOARD)) as f:
        walk(json.load(f))
    with open(os.path.join(HERE, DEPLOY_RULES)) as f:
        for line in f:
            if line.strip().startswith("expr:"):
                names.update(FAMILY_RE.findall(line))
    return names


def readme_families(heading: str) -> set:
    """The families ``deploy/gpu/README.md`` lists under ``### heading``
    (its ``- `tpu_...``` items): "Blank on the H100" and "Served by the
    workload's self-monitor"."""

    with open(os.path.join(HERE, DEPLOY_README)) as f:
        text = f.read()
    section = text.split("### " + heading + "\n", 1)[1].split("\n#", 1)[0]
    return set(re.findall(r"^- `(tpu(?:mon)?_[a-z0-9_]+)`", section, re.M))


def k8s_quantity(q: str, cpu: bool) -> float:
    """A resource quantity as cores (``cpu``) or KiB."""

    q = str(q)
    if cpu:
        return float(q[:-1]) / 1000.0 if q.endswith("m") else float(q)
    units = {"Ki": 1, "Mi": 1024, "Gi": 1024 * 1024}
    return float(q[:-2]) * units[q[-2:]]


def manifest_containers(rel: str) -> list:
    """Every container of every workload in a manifest, read by the
    port's YAML loader (``tpumon_torch.simple_yaml``)."""

    from tpumon_torch.simple_yaml import parse_simple_yaml

    with open(os.path.join(HERE, rel)) as f:
        docs = [parse_simple_yaml(d) for d in f.read().split("\n---\n")]
    out = []
    for doc in docs:
        pod = (doc.get("spec") or {}).get("template", {}).get("spec")
        for c in (pod or {}).get("containers", []):
            out.append(c)
    return out


def container_process(c, root: str, moved: dict, env) -> tuple:
    """(argv, env, ports) to start a container's command and args here:
    ``python`` is this interpreter, ``gpu-hostengine`` the native agent
    built from this checkout, each volume's mount path a directory
    under ``root`` (or ``moved[volume name]``), each declared container
    port a free one, ``$(VAR)`` the container's env."""

    mounts = {}
    for m in c.get("volumeMounts", []):
        host = moved.get(m["name"]) or os.path.join(root, m["name"])
        os.makedirs(host, exist_ok=True)
        mounts[m["mountPath"]] = host
    ports = {str(p["containerPort"]): free_port()
             for p in c.get("ports", [])}
    cenv = dict(env)
    for e in c.get("env", []):
        if "value" in e:
            cenv[e["name"]] = str(e["value"])
        elif e.get("valueFrom", {}).get("fieldRef", {}).get(
                "fieldPath") == "spec.nodeName":
            cenv[e["name"]] = os.uname().nodename

    def move(arg: str) -> str:
        arg = re.sub(r"\$\((\w+)\)", lambda m: cenv.get(m.group(1), ""),
                     str(arg))
        if arg in ports:
            return str(ports[arg])
        for mp in sorted(mounts, key=len, reverse=True):
            arg = re.sub(r"(^|[:=])" + re.escape(mp) + r"(?=/|$)",
                         lambda m: m.group(1) + mounts[mp], arg)
        return arg

    argv = [move(a) for a in c.get("command", []) + c.get("args", [])]
    if argv[0] in ("python", "python3"):
        argv[0] = sys.executable
    elif argv[0] == "gpu-hostengine":
        argv[0] = agent_argv(True)[0]
    return argv, cenv, ports


def container_module(argv) -> str:
    """What a container runs: its ``python -m`` module, or the native
    agent's name."""

    if argv[1:2] == ["-m"]:
        return argv[2]
    name = os.path.basename(argv[0])
    return "gpu-hostengine" if name.startswith("gpu-hostengine") else name


def deploy_phase(fields, env, work, drop, check_readme=True) -> dict:
    """``deploy``: the GPU DaemonSets as deployed, beside the train
    workload.  DEPLOY_MANIFESTS are read with the port's loader and each
    container's command and args started here under the import guard
    (the images install no torch; both agents are the native
    ``gpu-hostengine``): ``tpumon-daemonset.yaml``'s agent and
    exporter (through the agent's socket, ``--pod-labels`` from a map file
    keyed by the card's UUID, the workload's drop file where the manifest
    mounts ``/run/tpumon-drop``) and ``tpumon-agent-daemonset.yaml``'s
    agent with ``--prom-port``; hostPaths under a temp dir, ports free
    ones.  After they are ready, DEPLOY_S seconds at the manifest's
    ``-d``.  Fails unless the agent sockets answer ``hello``, the
    exporter's and the agent's ``/healthz`` are 200, the exporter's
    ``/metrics`` carries at least 20 families that NVML fills for the
    card, each process's RSS and CPU share stay under its container's
    limits, and no process imported ``tpumon``, ``jax`` or ``torch``.
    With ``check_readme``, also unless the families the reused dashboard
    and alert rules query that are blank are exactly those
    ``deploy/gpu/README.md`` lists as blank on the H100, and those it
    lists as the workload's are in the workload's drop file.  Printed:
    each container's RSS, CPU share and limits, families served, the
    named ones blank."""

    from tpumon_torch.hostengine import SCRAPE_FIELDS
    from tpumon_torch.supervisor import hello_probe

    genv, refused_log = guarded_env(env, work, "deploy")
    b, i = nvml_open(fields)
    uuid = b.chip_info(i).uuid
    nvml_fams = {fields.CATALOG[f].prom_name
                 for f, v in b.read_fields(i, SCRAPE_FIELDS).items()
                 if v is not None}
    b.close()
    map_file = os.path.join(work, "deploy-pods.json")
    with open(map_file, "w") as f:
        json.dump({uuid: POD}, f)
    genv["TPUMON_POD_MAP_FILE"] = map_file
    root = os.path.join(work, "d")   # short: socket paths stay < 108 B
    moved = {"workload-drop": os.path.dirname(drop)}
    procs, failures, out = [], [], {}
    try:
        for k, rel in enumerate(DEPLOY_MANIFESTS):
            for c in manifest_containers(rel):
                argv, cenv, ports = container_process(
                    c, os.path.join(root, str(k)), moved, genv)
                if container_module(argv) != "gpu-hostengine" and not \
                        container_module(argv).startswith("tpumon_torch."):
                    raise AssertionError(f"{rel}: {c['name']} runs {argv}")
                log_path = os.path.join(work, f"deploy-{c['name']}-"
                                              f"{len(procs)}.err")
                with open(log_path, "w") as err:
                    p = subprocess.Popen(argv, cwd=HERE, env=cenv,
                                         stdout=subprocess.DEVNULL,
                                         stderr=err, text=True)
                procs.append({"rel": rel, "c": c, "argv": argv,
                              "ports": ports, "proc": p, "log": log_path})
        t_start = time.monotonic()
        for d in procs:
            argv, p = d["argv"], d["proc"]
            if "--domain-socket" in argv:
                addr = "unix:" + argv[argv.index("--domain-socket") + 1]
                d["hello"] = wait_for(
                    lambda: hello_probe(addr, 2.0) or p.poll() is not None,
                    60, f"{d['c']['name']}'s socket", interval=0.2)
            port = (d["c"].get("readinessProbe") or {}).get(
                "httpGet", {}).get("port")
            if port is not None and p.poll() is None:
                d["port"] = local = d["ports"][str(port)]
                wait_for(lambda: _healthz(local) or p.poll() is not None, 90,
                         f"{d['c']['name']}'s /healthz", interval=0.25)
            if p.poll() is not None:
                with open(d["log"]) as f:
                    raise AssertionError(f"{d['c']['name']} exited: "
                                         f"{f.read()[-1500:]}")
        out["ready_s"] = round(time.monotonic() - t_start, 3)
        stats0 = [proc_stat(d["proc"].pid) for d in procs]
        t0 = time.monotonic()
        rss_max = [s["rss_kib"] for s in stats0]
        while time.monotonic() - t0 < DEPLOY_S:
            time.sleep(1.0)
            for k, d in enumerate(procs):
                rss_max[k] = max(rss_max[k],
                                 proc_stat(d["proc"].pid)["rss_kib"])
        stats1 = [proc_stat(d["proc"].pid) for d in procs]
        dt = time.monotonic() - t0
        scrapes = {}
        for d in procs:
            if "port" in d:
                d["healthz"] = http_get(d["port"], "/healthz")[0]
                scrapes[d["c"]["name"] + ":" + os.path.basename(d["rel"])] \
                    = _metrics_of(d["port"])
        containers = []
        for k, d in enumerate(procs):
            lim = (d["c"].get("resources") or {}).get("limits", {})
            rec = {"manifest": os.path.basename(d["rel"]),
                   "container": d["c"]["name"],
                   "module": container_module(d["argv"]),
                   "rss_kib_max": rss_max[k],
                   "rss_limit_kib": k8s_quantity(lim["memory"], False),
                   "cpu_percent": cpu_share(stats0[k], stats1[k], dt),
                   "cpu_limit_percent": 100.0 * k8s_quantity(lim["cpu"],
                                                             True),
                   "healthz": d.get("healthz"),
                   "hello": bool(d.get("hello"))}
            containers.append(rec)
            if rec["rss_kib_max"] >= rec["rss_limit_kib"]:
                failures.append(f"{rec['container']} RSS {rss_max[k]} KiB "
                                f"over its limit {lim['memory']}")
            if rec["cpu_percent"] >= rec["cpu_limit_percent"]:
                failures.append(f"{rec['container']} CPU "
                                f"{rec['cpu_percent']}% over its limit "
                                f"{lim['cpu']}")
            if "port" in d and rec["healthz"] != 200:
                failures.append(f"{rec['container']} /healthz "
                                f"{rec['healthz']}")
            if "--domain-socket" in d["argv"] and not rec["hello"]:
                failures.append(f"{rec['container']}'s socket is silent")
        out["containers"] = containers
        exp = scrapes["prometheus-tpu:tpumon-daemonset.yaml"]
        card = {f for f, v in exp.items()
                if any(lb.get("uuid") == uuid for lb, _ in v)}
        out["exporter_families"] = len(exp)
        out["nvml_families"] = len(card & nvml_fams)
        out["pod_labeled"] = sum(
            1 for f in card & nvml_fams
            if all(lb.get("pod_name") == POD["pod"]
                   for lb, _ in exp[f] if lb.get("uuid") == uuid))
        if out["nvml_families"] < 20:
            failures.append(f"{out['nvml_families']} NVML families served")
        served = set().union(*(set(m) for m in scrapes.values()))
        named = named_families()
        out["named_families"] = len(named)
        out["named_served"] = sorted(named & served)
        out["named_blank"] = sorted(named - served)
        if check_readme:
            listed = readme_families("Blank on the H100")
            if set(out["named_blank"]) != listed:
                failures.append(f"blank named families {out['named_blank']}"
                                f", the README lists {sorted(listed)}")
            dropped = read_drop(drop)
            own = readme_families("Served by the workload's self-monitor")
            if not own or not own <= served & (dropped[0] if dropped
                                               else set()):
                failures.append(f"the README's workload families {own} are "
                                f"not all served from the drop file")
        out["refused_imports"] = refused_imports(refused_log)
        if out["refused_imports"]:
            failures.append(f"refused imports {out['refused_imports']}")
        for d in procs:
            if d["proc"].poll() is not None:
                failures.append(f"{d['c']['name']} exited "
                                f"{d['proc'].returncode}")
        if failures:
            raise AssertionError(f"deploy check failed: {failures} {out}")
        return out
    finally:
        for d in reversed(procs):
            stop_proc(d["proc"])


def _healthz(port: int):
    try:
        return http_get(port, "/healthz")[0] == 200
    except OSError:
        return False


def relay_agent_phases(K, fields) -> tuple:
    """The ``relay``, ``agent``, ``native agent``, ``fleet``, ``chaos`` and
    ``deploy`` legs (and both agents side by side) beside one train
    workload (``python -m tpumon_torch.loadgen.run --size bench
    --self-monitor --monitor-output <drop> --json``, B1-B3 in its own
    process, its launch counts from its JSON line), then, while it ends,
    in this process: the burst loop's CPU split as the exporter daemon
    runs it and as the agent runs it, and the agent's collect by NVML
    entry point (``loadgen.bench_gpu.burst_cpu_split``,
    ``agent_collect``).  Returns the five legs' records and the
    workload's."""

    import shutil
    import tempfile
    from tpumon_torch.loadgen.bench_gpu import (agent_collect,
                                                burst_cpu_split,
                                                exporter_fields)

    shm = "/dev/shm" if os.access("/dev/shm", os.W_OK) else None
    work = tempfile.mkdtemp(prefix="tpumon-relay-agent-", dir=shm)
    drop = os.path.join(work, "embed.prom")
    env = dict(os.environ, PYTHONPATH=HERE)
    for k in ("TPUMON_BACKEND", "TPUMON_CHIPS"):
        env.pop(k, None)
    # the legs' stretches and their start-ups, kills and restarts; the
    # fleet leg's flat ticks (on both poll planes), steady stretch,
    # recovery budget and
    # supervisor ticks and its processes' start-ups; the chaos corpus
    # (about 50 s of ticks) and its red control; the deploy leg's
    # stretch and its processes' start-ups
    # both agents' legs (the Python agent's, then the native's) and
    # their side-by-side stretches
    seconds = RELAY_LIVE_S + RELAY_DARK_S + RELAY_BACK_S + 2 * (
        AGENT_SCRAPE_S + AGENT_BURST_S + AGENT_BURST_IDLE_S + 40) + \
        AGENT_PROM_SCRAPES + PY_PROM_SCRAPES + 2 * SIDE_S + 10 + \
        2 * FLEET_TICKS + FLEET_STEADY_S + FLEET_RECOVER_S + \
        FLEET_SUP_TICKS + 40 + 65 + DEPLOY_S + 20
    workload = None
    try:
        workload = spawn(["tpumon_torch.loadgen.run", "--size", "bench",
                          "--self-monitor", "--monitor-output", drop,
                          "--seconds", str(seconds), "--json"], env,
                         os.path.join(work, "workload.err"),
                         stdout=subprocess.PIPE)
        wait_for(lambda: os.path.exists(drop) or workload.poll() is not None,
                 180, "the workload's first step")
        relay = relay_phase(env, work)
        agent = agent_phase(K, fields, env, work)
        agent["prom"] = agent_prom_phase(fields, env, work, drop,
                                         n_scrapes=PY_PROM_SCRAPES)
        native = agent_phase(K, fields, env, work, native=True)
        native["prom"] = agent_prom_phase(fields, env, work, drop,
                                          native=True)
        print("native agent: " + json.dumps(native), flush=True)
        agent["side_by_side"] = agents_side_by_side(fields, env, work)
        print("agents side by side: " + json.dumps(agent["side_by_side"]),
              flush=True)
        fleet = fleet_phase(fields, env, work)
        chaos = chaos_phase(env, work)
        deploy = deploy_phase(fields, env, work, drop)
        # while the workload finishes its window
        b, i = nvml_open(fields)
        try:
            fids = [f for f in exporter_fields()
                    if not fields.CATALOG[f].vector_label]
            agent["burst_split_in_process"] = [
                burst_cpu_split(b, i, AGENT_HZ, SPLIT_S, agent=a)
                for a in (False, True)]
            agent["collect"] = agent_collect(b, i, fids, COLLECT_S,
                                             hz=COLLECT_HZ)
        finally:
            b.close()
        try:
            wl_out, _ = workload.communicate(timeout=180)
        except subprocess.TimeoutExpired:
            workload.kill()
            wl_out, _ = workload.communicate()
        if workload.returncode != 0:
            with open(os.path.join(work, "workload.err")) as f:
                raise AssertionError(f"workload exited {workload.returncode}"
                                     f": {f.read()[-2000:]}")
        wl = json.loads(wl_out.strip().splitlines()[-1])
        return relay, agent, fleet, chaos, deploy, {k: wl.get(k) for k in (
            "steps_per_sec", "steps", "final_loss", "captures_ok",
            "captures_failed", "launches")}
    finally:
        if workload is not None and workload.poll() is None:
            workload.kill()
            workload.wait()
        shutil.rmtree(work, ignore_errors=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is false")
    sys.path.insert(0, HERE)
    try:
        import tpumon_torch
        from tpumon_torch import _build, fields
        from tpumon_torch.loadgen import kernels as K
        from tpumon_torch.loadgen import model as M
        from tpumon_torch.loadgen import run as R
    except ImportError as e:
        return fail(f"tpumon_torch not found beside chip_smoke.py: {e}")
    if os.path.dirname(os.path.dirname(
            os.path.abspath(tpumon_torch.__file__))) != HERE:
        return fail(f"imported tpumon_torch from {tpumon_torch.__file__}, "
                    f"not from this checkout")

    t_smoke = time.monotonic()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0])

    import tempfile

    # the analysis planes run first, beside the builds (CPU only)
    analysis_work = tempfile.mkdtemp(prefix="tpumon-analysis-")
    analysis = analysis_start(analysis_work)
    try:
        t0 = time.monotonic()
        # the native agent, client, codec and poll engine build (g++) while
        # the kernels do (nvcc)
        native_build = {}

        def build_native():
            try:
                native_build["paths"] = _build.native()
            except BaseException as e:  # raised below
                native_build["error"] = e
            native_build["s"] = time.monotonic() - t0

        nb = threading.Thread(target=build_native)
        nb.start()
        lib = _build.load()
        print(f"build: {time.monotonic() - t0:.1f} s")
        nb.join()
        if "error" in native_build:
            return fail(f"the native agent did not build: "
                        f"{native_build['error']}")
        print(f"native build: {native_build['s']:.1f} s, "
              + ", ".join(sorted(os.path.basename(str(p))
                                 for p in native_build["paths"].values())))
        # the codec and poll extensions the native legs load
        # (TPUMON_NATIVE=1)
        print("native extensions: " + json.dumps({
            name: os.path.relpath(native_build["paths"][name], HERE)
            for name in ("_tpumon_torch_codec", "_tpumon_torch_poll")}))
        for line in _build.build_log().splitlines():
            if any(w in line for w in ("registers", "spill",
                                       "Compiling entry", "wgmma",
                                       "warning")):
                print("  " + line.strip()[:160])
        try:
            checked = analysis_phase(analysis, analysis_work,
                                     smi.stdout.strip().splitlines()[0])
        except RuntimeError as e:
            return fail(f"analysis: {e}")
        print("analysis: " + json.dumps(checked), flush=True)
    finally:
        for proc, _, _, _ in analysis.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(analysis_work, ignore_errors=True)

    nvml_phases(K, fields)

    rows = kernel_cases(K, lib)
    fwd = rows["flash_fwd"]
    fwd["at_flash_pattern"] = flash_pattern_case(K, lib, K.FLASH_SHAPE["cuda"])
    if tuple(K.FLASH_SHAPE["cuda"]) != FLASH_SHAPE_REFERENCE:
        fwd["at_reference_flash_shape"] = flash_pattern_case(
            K, lib, FLASH_SHAPE_REFERENCE)
    for name, row in long_backward_case(K, lib).items():
        rows[name]["at_long_sequence"] = row
    backward = backward_table(rows)
    rows.update(load_kernel_cases(K, lib))
    rows["sgd_update"] = update_case(K, M, lib)
    print("attention check, excess: " + json.dumps(attention_check(K)))
    print("model check: " + json.dumps(model_check(M)))
    print("graph check: " + json.dumps(graph_check(M, R)))

    for name, _, _ in KERNELS:
        rows[name]["launches"] = 0
        rows[name]["launches_by_path"] = {}
    rates, results = {}, {}
    for path in PATHS:
        result, launches = drive_path(K, R, fields, path)
        print(f"main path {path}: " + json.dumps(result))
        rates[path], results[path] = result["steps_per_sec"], result
        for name in PATHS[path]:
            rows[name]["launches"] += launches[name]
            rows[name]["launches_by_path"][path] = launches[name]
    print("patterns: " + json.dumps(pattern_table(rows, rates)))
    # NCCL's answer to two ranks on one card, while the ring check runs
    probe = two_ranks_probe_start()
    ring = ring_check()
    print("multi: " + json.dumps(multi_summary(
        results, two_ranks_probe_end(probe), ring)))

    sharded, launches = sharded_check(K, M)
    for name, n in launches.items():
        rows[name]["launches"] += n
        rows[name]["launches_by_path"]["sharded"] = n
    print("sharded: " + json.dumps(sharded))

    print("semantics check: " + json.dumps(semantics_check(K, fields)))
    print("trace check: " + json.dumps(trace_check(K, M, R,
                                                   results["train"])))
    print("bench gpu: " + json.dumps(bench_gpu_check()))

    daemon = daemon_phase(fields)
    for name in PATHS["train"]:
        n = daemon["workload"]["launches"].get(name, 0)
        if n <= 0:
            return fail(f"kernel {name} never launched on the daemon "
                        f"path's workload")
        rows[name]["launches"] += n
        rows[name]["launches_by_path"]["daemon"] = n
    print("daemon: " + json.dumps(daemon))

    planes = planes_phase(K, fields, daemon["cpu_percent"])
    n = planes["launches"]["mxu_burn"]
    rows["mxu_burn"]["launches"] += n
    rows["mxu_burn"]["launches_by_path"]["planes"] = n
    print("planes: " + json.dumps(planes))

    watches = watches_phase(K, fields)
    n = watches["launches"]["mxu_burn"]
    rows["mxu_burn"]["launches"] += n
    rows["mxu_burn"]["launches_by_path"]["watches"] = n
    print("watches: " + json.dumps(watches))

    stream = stream_phase(fields)
    for name in PATHS["train"]:
        n = (stream["workload"]["launches"] or {}).get(name, 0)
        if n <= 0:
            return fail(f"kernel {name} never launched on the stream "
                        f"path's workload")
        rows[name]["launches"] += n
        rows[name]["launches_by_path"]["stream"] = n
    print("stream: " + json.dumps(stream))

    relay, agent, fleet, chaos, deploy, workload = relay_agent_phases(
        K, fields)
    for name in PATHS["train"]:
        n = (workload["launches"] or {}).get(name, 0)
        if n <= 0:
            return fail(f"kernel {name} never launched on the relay, agent, "
                        f"fleet, chaos and deploy paths' workload")
        rows[name]["launches"] += n
        rows[name]["launches_by_path"]["relay+agent+fleet+chaos+deploy"] = n
    n = agent["launches"]["mxu_burn"]
    rows["mxu_burn"]["launches"] += n
    rows["mxu_burn"]["launches_by_path"]["agent"] = n
    print("relay: " + json.dumps(relay))
    print("agent: " + json.dumps(dict(agent, workload=workload)))
    print("fleet: " + json.dumps(dict(
        fleet, workload_steps_per_sec=workload["steps_per_sec"])))
    print("chaos: " + json.dumps(chaos))
    print("deploy: " + json.dumps(deploy))
    print(f"total: {time.monotonic() - t_smoke:.1f} s")

    # the card again, where a tail of the output keeps it
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps({"kernels": [rows[n] for n, _, _ in KERNELS],
                      "backward": backward}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
