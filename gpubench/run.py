"""Run one cell of the benchmark once and print its result line.

    python3 -m gpubench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

A cell is an entry of ``BENCHMARK.json``'s ``workloads``: a configuration
(``configs/<name>.json``: the monitor's processes as its manifest runs
them) under a traffic mix (``traffic/<name>.json``: the monitored job and
the node's scrapers).  Metrics are readers, ``metrics/<name>.py``, each
``read(run) -> value or None``; ``--trace 0`` reports the cell's
end-to-end metrics, ``--trace 1`` its per-layer ones.

One run, in this process unless said otherwise:

1. builds the program's kernels and native agent (into ``build/`` of this
   checkout), makes the CUDA context;
2. starts the configuration's processes (``deploy.Node``) under
   ``TMPDIR``, builds the job from the seed (``workloads.Job``) and runs
   its set-up steps;
3. starts the scrapers' process (``scrape.py``), then drives
   ``tpumon_torch.loadgen.run.run_window`` with the embedded self-monitor
   writing the drop file; the window opens at the monitor's first sweep
   in it, which also starts the scrapers' clock;
4. stops the processes, reads the device's memory peak, frees the job,
   compares what the timed path produced with the references
   (``check.py``) and runs the readers.

Standard error carries the set-up's parts, the card's clocks and power
around the window and, last, each number compared beside its limit;
standard output ends with one JSON line.  Without CUDA, or with fewer
cards than the cell asks, it exits 3 and prints no result; a process
that loaded ``jax``, ``jaxlib``, ``flax`` or ``tpumon`` makes it exit 4.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
REFUSED = ("jax", "jaxlib", "flax", "tpumon")
#: readers printed on standard error in every run: the node's scrape
#: latency and CPU bill, which spread too widely run to run to be bounded
UNBOUNDED = ("scrape_p50_ms", "scrape_p95_ms", "monitor_cpu_pct")
#: the program's compile caches, at fixed paths inside the checkout
CACHES = {"TRITON_CACHE_DIR": "build/triton",
          "TORCH_EXTENSIONS_DIR": "build/torch_extensions",
          "CUDA_CACHE_PATH": "build/cuda_cache"}


def process_start() -> float:
    """This process's start on the monotonic clock (``/proc/self/stat``
    starttime against the boot clock)."""

    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    age = time.clock_gettime(time.CLOCK_BOOTTIME) - \
        start_ticks / os.sysconf("SC_CLK_TCK")
    return time.monotonic() - age


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def cell_spec(bench: Dict, name: str):
    """(cell, configuration entry, configuration file, traffic mix) of a
    cell name."""

    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    return (cell, entry, load_json(ROOT / entry["file"]),
            load_json(HERE / "traffic" / f"{cell['traffic']}.json"))


def metric_specs(bench: Dict, cell: Dict, trace: int) -> List[Dict]:
    """The metrics a run of ``cell`` reports: the end-to-end ones without
    tracing, the per-layer ones with it; each where it names the cell, or
    everywhere when it names none."""

    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group
            if "workloads" not in m or cell["name"] in m["workloads"]]


def reader(name: str):
    return importlib.import_module(f"gpubench.metrics.{name}").read


def nvidia_smi() -> str:
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
             "clocks.mem,power.draw,temperature.gpu",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20)
        return r.stdout.strip().replace("\n", " | ") or r.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e!r}"


def hbm_total_mib(uuid: str) -> Optional[int]:
    """The card's memory total by ``nvidia-smi`` (NVML's), MiB; None where
    it cannot be read."""

    try:
        r = subprocess.run(
            ["nvidia-smi", f"--id={uuid}", "--query-gpu=memory.total",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=20)
        return int(r.stdout.split()[0])
    except (OSError, subprocess.TimeoutExpired, ValueError, IndexError):
        return None


def refused_here() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(REFUSED))


class Scrapers:
    """The scrapers' process: started with its settings, told when the
    window opens, read when it has written its file."""

    def __init__(self, settings: Dict, env: Dict[str, str]) -> None:
        self.out = settings["out"]
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "gpubench.scrape"], cwd=str(ROOT),
            env=env, stdin=subprocess.PIPE, text=True)
        self.proc.stdin.write(json.dumps(settings) + "\n")
        self.proc.stdin.flush()

    def go(self, t0: float) -> None:
        self.proc.stdin.write(f"go {t0!r}\n")
        self.proc.stdin.flush()

    def finish(self, timeout_s: float) -> Dict:
        try:
            self.proc.stdin.close()
            self.proc.wait(timeout=timeout_s)
        finally:
            self.kill()
        if self.proc.returncode != 0:
            raise RuntimeError(f"scrapers exited {self.proc.returncode}")
        return load_json(Path(self.out))

    def kill(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()


class Run:
    """What one run saw, for the readers."""

    def __init__(self, **kw) -> None:
        self.__dict__.update(kw)

    def latencies_ms(self) -> List[float]:
        from .stats import scrape_latencies_ms

        return scrape_latencies_ms(self.scrapes["records"],
                                   self.traffic["scrape"]["timeout_s"])

    def window_rate(self) -> Optional[float]:
        """The job's steps a second by this benchmark's clock: from the
        window's first sweep to the first sync at or past its end."""

        t0, n0 = self.window_start, self.window_calls
        end = [(t, n) for t, n in self.job.syncs if t >= t0 + self.seconds]
        if not end:
            return None
        t1, n1 = end[0]
        return (n1 - n0) / (t1 - t0)

    def _named(self, role: str) -> List[str]:
        return [p["name"] for p in self.config["processes"]
                if p.get("role") == role]

    def cpu_pct_of(self, name: str) -> float:
        """CPU time of the monitor process ``name`` over the window, in %
        of one core."""

        c0, c1 = self.scrapes["cpu_window"]
        return 100.0 * self.scrapes["cpu_s"][name] / (c1 - c0)

    def cpu_pct(self, role: str) -> Optional[float]:
        """CPU time of the configuration's processes of ``role`` over the
        window, in % of one core; None where it has none."""

        names = self._named(role)
        return sum(map(self.cpu_pct_of, names)) if names else None

    def rss_mib(self, role: str) -> Optional[float]:
        """The largest resident set of the processes of ``role`` over the
        window, summed, MiB; None where it has none."""

        names = self._named(role)
        if not names:
            return None
        return sum(self.scrapes["rss_peak_kib"][n] for n in names) / 1024.0


def run_cell(bench: Dict, name: str, seed: int, seconds: float, trace: int,
             fault: Optional[str] = None, t_start: Optional[float] = None,
             keep: Optional[Dict] = None) -> Dict:
    """One run of cell ``name``: its result dict (the printed line's
    keys).  ``fault``: a test's planted fault (its kind's ``FAULTS``);
    ``keep``: a dict that receives the run (``Run``) under ``"run"``."""

    import torch

    from tpumon_torch import _build
    from tpumon_torch.exporter.exporter import TpuExporter
    from tpumon_torch.loadgen.run import run_window

    from . import check, devtrace
    from .deploy import Node, OwnSeries, guarded_env
    from .stats import scrapes_due
    from .workloads import Job, Stretch

    t_start = process_start() if t_start is None else t_start
    cell, _, config, traffic = cell_spec(bench, name)
    specs = metric_specs(bench, cell, trace)
    parts: Dict[str, float] = {}
    run_dir = tempfile.mkdtemp(prefix="gb")
    drop_dir = os.path.join(run_dir, "drop")
    os.makedirs(drop_dir)
    drop = os.path.join(drop_dir, "embed.prom")

    t = time.monotonic()
    with ThreadPoolExecutor(2) as pool:
        kernels = pool.submit(_build.load)
        native = pool.submit(_build.native)
        kernels.result()
        native_paths = native.result()
    parts["compile_s"] = time.monotonic() - t
    t = time.monotonic()
    dev = torch.device("cuda", 0)
    torch.zeros(1, device=dev)
    torch.cuda.synchronize(dev)
    parts["cuda_context_s"] = time.monotonic() - t
    device_name = torch.cuda.get_device_name(dev)
    uuid = "GPU-" + str(torch.cuda.get_device_properties(dev).uuid)

    node = Node(config, run_dir, drop_dir, uuid, native_paths)
    scrapers = None
    hook = {"sweeps": [], "trace_cost": None}
    orig_sweep = TpuExporter.sweep
    try:
        node.start()
        t = time.monotonic()
        stretch = Stretch(**traffic["trace"]["stretch"]) if trace else None
        job = Job(traffic, seconds, seed, dev, fault=fault, stretch=stretch)
        job.setup(traffic["check"])
        torch.cuda.synchronize(dev)
        parts["job_build_s"] = time.monotonic() - t
        node.wait_ready()
        for pname, s in node.ready_s.items():
            parts[f"{pname}_ready_s"] = s
        scrape = traffic["scrape"]
        own = OwnSeries(node.port, scrape["path"], drop)
        t = time.monotonic()
        own.start()
        own.wait()
        parts["node_settle_s"] = time.monotonic() - t
        scrapers = Scrapers(
            {"port": node.port, "path": scrape["path"],
             "scrapers": scrape["scrapers"], "hz": scrape["hz"],
             "timeout_s": scrape["timeout_s"], "seconds": seconds,
             "seed": seed,
             "pids": node.pids(), "drop": drop,
             "out": os.path.join(run_dir, "scrapes.json"),
             "fault": fault, "own": sorted(own.series)},
            guarded_env(dict(os.environ), node.guard_log))
        smi_before = nvidia_smi()
        hbm_total = hbm_total_mib(uuid)

        def sweep(self, *a, **k):
            t_call = time.monotonic()
            if len(hook["sweeps"]) == 1:
                hook["window"] = (t_call, job.calls)
                scrapers.go(t_call)
                if stretch is not None:
                    stretch.arm(t_call)
            out = orig_sweep(self, *a, **k)
            hook["sweeps"].append((t_call, time.monotonic()))
            hook["trace_cost"] = self.handle.backend.trace_cost_stats()
            return out

        TpuExporter.sweep = sweep
        t_window_call = time.monotonic()
        window = run_window(job, seconds, traffic["sync_every"],
                            self_monitor=True, monitor_output=drop,
                            device_name=device_name)
        TpuExporter.sweep = orig_sweep
        own.stop.set()
        own.join()
        smi_after = nvidia_smi()
        scraped = scrapers.finish(seconds + scrape["timeout_s"] + 30.0)
        alive = node.alive()
    finally:
        TpuExporter.sweep = orig_sweep
        if scrapers is not None:
            scrapers.kill()
        codes = node.stop()
    t_ws, calls_ws = hook["window"]
    parts["embedded_warmup_s"] = t_ws - t_window_call
    setup_s = t_ws - t_start
    memory_peak = torch.cuda.max_memory_allocated(dev)
    job.free()
    torch.cuda.empty_cache()

    stretch_out = None
    if stretch is not None and stretch.events is not None:
        stretch_out = devtrace.from_events(stretch.events)
    job_numbers = check.job_numbers(job, traffic, dev)
    due = scrapes_due(scrape["scrapers"], scrape["hz"], seconds)
    mon_numbers, failed = check.monitor_numbers(
        scraped, own.series, uuid, config["min_card_families"], due,
        hbm_total)
    compared = {}
    for key, value in list(job_numbers.items()) + list(mon_numbers.items()):
        if key in traffic["limits"]:
            compared[key] = {"value": value, "limit": traffic["limits"][key]}
    correct = all(c["value"] is not None and c["value"] <= c["limit"]
                  for c in compared.values()) and \
        set(alive) == set(node.procs)

    run = Run(cell=cell, config=config, traffic=traffic, seconds=seconds,
              seed=seed, device=dev, device_name=device_name, job=job,
              window=window, window_start=t_ws, window_calls=calls_ws,
              sweeps=hook["sweeps"], trace_cost=hook["trace_cost"],
              scrapes=scraped, setup_s=setup_s, stretch=stretch_out,
              memory_peak=memory_peak, own_series=own.series, uuid=uuid,
              due=due, hbm_total_mib=hbm_total)
    if keep is not None:
        keep["run"] = run
    metrics = {}
    for m in specs:
        value = reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    if scraped["drops"]:
        parts["first_drop_before_window_s"] = t_ws - scraped["drops"][0]["t"]
    lines = [
        "setup: total_s=%r %s" % (setup_s, " ".join(
            f"{k}={v!r}" for k, v in parts.items())),
        f"card before window: {smi_before}",
        f"card after window: {smi_after}",
        f"window: steps_per_s_program={window.get('steps_per_sec')} "
        f"sweeps={window.get('monitor_sweeps')} "
        f"captures_ok={window.get('captures_ok')} "
        f"captures_failed={window.get('captures_failed')} "
        f"monitor_cost={json.dumps(window.get('monitor_cost'))}",
        "node, not bounded: " + " ".join(
            f"{n}={reader(n)(run)!r}" for n in UNBOUNDED),
        "monitor processes: " + " ".join(
            f"{n} cpu_pct={run.cpu_pct_of(n)!r} "
            f"rss_peak_kib={scraped['rss_peak_kib'][n]}" for n in node.procs),
        f"monitor: exit codes {codes}, alive through the window {alive}, "
        f"own series {len(own.series)} from {own.bodies} scrapes, "
        f"drop versions {len(scraped['drops'])}, scrapes due {due}, "
        f"card memory total by nvidia-smi {hbm_total} MiB, refused imports "
        f"{node.refused_imports() + scraped['refused_modules']}",
    ]
    lines += [f"check {key} {c['value']!r} limit {c['limit']!r}"
              for key, c in compared.items()]
    print("\n".join(lines), file=sys.stderr)

    result = {
        "correct": bool(correct),
        "attempted": max(due, len(scraped.get("records", []))),
        "failed": failed,
        "metrics": metrics,
        "device": {"platform": "gpu", "kind": device_name, "count": 1,
                   "memory_peak_bytes": int(memory_peak)},
    }
    if trace:
        if stretch_out is not None:
            result["device"]["busy_s"] = stretch_out["busy_s"]
            result["device"]["window_s"] = stretch_out["window_s"]
            result["breakdown"] = {"device_ops": stretch_out["device_ops"],
                                   "idle_gaps": stretch_out["idle_gaps"]}
    result["compared"] = compared
    result["_refused"] = node.refused_imports() + scraped["refused_modules"]
    shutil.rmtree(run_dir, ignore_errors=True)
    return result


def main(argv=None) -> int:
    t_start = process_start()
    p = argparse.ArgumentParser(prog="gpubench.run", description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    for var, rel in CACHES.items():
        os.environ[var] = str(ROOT / rel)
    bench = load_json(ROOT / "BENCHMARK.json")
    cell = cell_spec(bench, args.workload)[0]

    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        count = torch.cuda.device_count() if torch.cuda.is_available() \
            else 0
        print(f"gpubench: the cell needs {cell['chips']} CUDA device(s); "
              f"this machine has {count}", file=sys.stderr)
        return 3
    result = run_cell(bench, args.workload, args.seed, args.seconds,
                      args.trace, t_start=t_start)
    refused = sorted(set(result.pop("_refused")) | set(refused_here()))
    if refused:
        print(f"gpubench: refused modules loaded: {refused}",
              file=sys.stderr)
        return 4
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
