"""The port's paired bench protocol (``tpumon_torch.loadgen.bench_gpu``)
and the train step's CUDA graph on a host without a GPU.

* The verdict, its helpers and the capture-cost aggregate against
  ``bench.py``'s on the same legs: the reference runs with its subprocess
  runner (``bench._run_loadgen``) replaced by canned legs, the port's pure
  functions take the same (bare, monitored) results.  The records must
  agree key for key (the reference's per-process timeout bound aside).
* The 1 Hz tier, the burst loop's CPU split and the agent's collect over
  the fake NVML (``tpumon_torch/testlib/fake_nvml.c``).
* The runner on the CPU steps eagerly with the same result as
  ``model.train_step``; the graph step refuses the CPU.
* The trace engine's reading of graph replays (``trace.graph_program``,
  ``kineto_records``) on synthetic profiler events.
"""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
import bench  # noqa: E402

from tpumon_torch import trace as T  # noqa: E402
from tpumon_torch.loadgen import bench_gpu as B  # noqa: E402
from tpumon_torch.loadgen import model as M  # noqa: E402
from tpumon_torch.loadgen import run as R  # noqa: E402
from tpumon_torch.loadgen.graph import GraphStep  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CARD = "NVIDIA H100 80GB HBM3"


# ---- the verdict against bench.bench_real_tpu ---------------------------------

def _legs(pairs):
    """Canned runner results of each (bare, monitored) steps/s pair."""

    out = []
    for i, (b, m) in enumerate(pairs):
        bare = {"steps_per_sec": b, "device": CARD, "monitor_sweeps": 0}
        mon = {"steps_per_sec": m, "device": CARD, "monitor_sweeps": 5,
               "families_nonblank": 21 + i, "capture_forced": True,
               "monitor_cost": {"sweep_s": 0.01 * (i + 1),
                                "capture_step_cost_pct": None}}
        out.append((bare, mon))
    return out


def _reference(monkeypatch, legs):
    """bench_real_tpu over ``legs``, its runner replaced: a warm-up leg,
    then the pairs' legs in the order the reference asks for them."""

    bares = [b for b, _ in legs]
    mons = [m for _, m in legs]
    calls = []

    def run(seconds, self_monitor, timeout_s=360.0, env_extra=None):
        if not calls:
            calls.append("warm")
            return {"steps_per_sec": 1.0, "device": CARD}
        calls.append(self_monitor)
        return dict((mons if self_monitor else bares).pop(0))

    monkeypatch.setattr(bench, "_run_loadgen", run)
    monkeypatch.setattr(bench, "log", lambda msg: None)
    return bench.bench_real_tpu(pair_seconds=5.0, n_pairs=len(legs),
                                budget_s=1e9)


#: the reference's per-process bound, which the one-process protocol has
#: no counterpart of
PROCESS_ONLY = {"pair_seconds", "pair_wall_worst_case_s"}

VERDICT_CASES = {
    "four_of_four_positive": [(100, 96), (100, 95), (100, 97), (100, 96)],
    "mixed_signs": [(100, 98), (100, 103), (100, 97), (100, 101),
                    (100, 99), (100, 102)],
    "exact_zero_ties": [(100, 100), (100, 100), (100, 98)],
    "monitored_consistently_faster": [(100, 104), (100, 105), (100, 103),
                                      (100, 106)],
    "three_sign_consistent": [(100, 97), (100, 96), (100, 95)],
    "two_sign_consistent": [(100, 97), (100, 96)],
    "single_surviving_pair": [(100, 95)],
    "recorded_stall": [(100, 96), (100, 95), (45, 96), (100, 97),
                       (100, 96)],
    "all_pairs_wild": [(100, 60), (100, 150), (100, 40), (100, 170)],
    "zero_progress_each_side": [(100, 96), (0, 95), (100, 0), (100, 97),
                                (100, 96), (100, 95)],
    "every_pair_dropped": [(0, 95), (100, 0)],
}


@pytest.mark.parametrize("case", list(VERDICT_CASES))
def test_verdict_matches_the_reference(monkeypatch, case):
    legs = _legs(VERDICT_CASES[case])
    want = _reference(monkeypatch, legs)
    got = B.verdict(legs)
    strip = lambda d: {k: v for k, v in d.items()  # noqa: E731
                       if k not in PROCESS_ONLY}
    assert strip(got) == strip(want)
    for key in B.OVERHEAD_RECORD_KEYS:
        assert (key in got) == (key in want), key
    flags = ("overhead_within_noise", "overhead_monitored_faster",
             "overhead_underpowered", "overhead_insufficient_pairs")
    assert [got.get(f) for f in flags] == [want.get(f) for f in flags]


def test_verdict_of_no_completed_pair():
    legs = _legs([(0, 0)])
    assert B.verdict(legs) == {"real_tpu": False,
                               "reason": "no completed pair"}


def test_constants_are_the_reference_s():
    for name in ("SIGN_TEST_ALPHA", "STALL_ABS_FLOOR_PCT", "STALL_K",
                 "STALL_LEG_FRAC", "OVERHEAD_RECORD_KEYS"):
        assert getattr(B, name) == getattr(bench, name), name


@pytest.mark.parametrize("seed", range(5))
def test_helpers_match_the_reference(seed):
    rng = np.random.default_rng(seed)
    for _ in range(20):
        n_pos, n_neg = (int(x) for x in rng.integers(0, 12, 2))
        assert B.sign_test_p(n_pos, n_neg) == \
            bench._sign_test_p(n_pos, n_neg)
    for _ in range(20):
        n = int(rng.integers(1, 10))
        bare = rng.normal(100, 5, n)
        mon = bare * (1 - rng.normal(0.03, 0.02, n))
        stalls = rng.random(n) < 0.2
        bare = np.where(stalls, bare * rng.uniform(0.3, 0.6, n), bare)
        pairs = [(float(b), float(m)) for b, m in zip(bare, mon)]
        over = [round(100.0 * (1.0 - m / b), 1) for b, m in pairs]
        assert B.exclude_stalls(pairs, over) == \
            bench._exclude_stalls(pairs, over)


def test_capture_cost_matches_the_reference(monkeypatch):
    results = [
        {"monitor_cost": {"capture_step_cost_pct": 12.5,
                          "capture_overlap_s": 2.1, "captures_in_window": 3}},
        None,                                     # a failed run
        {"monitor_cost": {"capture_step_cost_pct": None}},  # no overlap
        {"monitor_cost": {"capture_step_cost_pct": -1.5,
                          "capture_overlap_s": 1.0, "captures_in_window": 2}},
        {"monitor_cost": {"capture_step_cost_pct": 30.0,
                          "capture_overlap_s": 3.3, "captures_in_window": 4}},
        {},
    ]
    queue = list(results)
    monkeypatch.setattr(bench, "_run_loadgen",
                        lambda *a, **k: queue.pop(0))
    monkeypatch.setattr(bench, "log", lambda msg: None)
    want = bench.bench_capture_step_cost(n_runs=len(results), seconds=20.0)
    got = B.capture_cost(results, B.CAPTURE_COST_ENV, 20.0)
    assert got.pop("config") == B.CAPTURE_COST_ENV
    want.pop("config")
    assert got == want
    assert got["median_pct"] == 12.5 and got["sign_runs"] == [2, 1]
    # one usable run: no aggregate, as the reference
    assert "median_pct" not in B.capture_cost(results[:2], {}, 1.0)


def test_paired_alternates_and_drops_a_stalled_pair(monkeypatch):
    """The one-process protocol: windows alternate bare-first and
    monitored-first, the monitored ones see ``monitor_env`` alone, and a
    0-steps window drops its pair."""

    seen = []
    rates = iter([(100, 96), (100, 95), (0, 97), (100, 96), (100, 97)])
    current = {}

    def window(work, seconds, sync_every=32, self_monitor=False,
               monitor_output=None, device_name="cpu", final_capture=True):
        assert not final_capture
        if not current:
            current.update(zip((False, True), next(rates)))
        seen.append((self_monitor, os.environ.get("TPUMON_CUDA_TRACE")))
        sps = current.pop(self_monitor)
        return {"steps_per_sec": sps, "device": CARD,
                "monitor_cost": {"sweep_s": 0.0}}

    monkeypatch.setattr(R, "run_window", window)
    monkeypatch.delenv("TPUMON_CUDA_TRACE", raising=False)

    class Work:
        pattern = "train"

    rec = B.paired(Work(), 5, 1.0, {"TPUMON_CUDA_TRACE": "0"},
                   device_name=CARD)
    assert [m for m, _ in seen] == [False, True, True, False, False, True,
                                    True, False, False, True]
    assert all((env == "0") == m for m, env in seen)
    assert "TPUMON_CUDA_TRACE" not in os.environ
    assert rec["pairs_completed"] == 4
    assert rec["bare_steps_per_sec"] == [100, 100, 0, 100, 100]
    assert rec["monitor_env"] == {"TPUMON_CUDA_TRACE": "0"}
    assert rec["overhead_pairs_percent"] == [4.0, 5.0, 4.0, 3.0]
    assert rec["monitor_overhead_percent"] == 4.0  # 4/4 positive
    # every verdict key is in the record, None where its branch sets none
    assert set(B.OVERHEAD_RECORD_KEYS) <= set(rec)
    assert rec["overhead_underpowered"] is None
    assert rec["overhead_pairs_excluded_percent"] is None


# ---- the 1 Hz tier on the fake NVML --------------------------------------------

@pytest.fixture(scope="module")
def fake_nvml(tmp_path_factory):
    cc = shutil.which("cc") or shutil.which("gcc")
    if cc is None:
        pytest.skip("no C compiler on this host")
    out = str(tmp_path_factory.mktemp("nvml") / "libfake_nvml.so")
    testlib = os.path.join(REPO, "tpumon_torch", "testlib")
    subprocess.run([cc, "-shared", "-fPIC", "-I", testlib, "-o", out,
                    os.path.join(testlib, "fake_nvml.c"), "-lpthread"],
                   check=True, capture_output=True, timeout=120)
    return out


def test_tier_1hz_over_the_fake_nvml(fake_nvml, monkeypatch):
    from tpumon_torch.backends.nvml import NvmlBackend

    monkeypatch.setenv("TPUMON_NVML_PATH", fake_nvml)
    monkeypatch.setenv("TPUMON_KMSG_PATH", "/nonexistent")
    monkeypatch.setattr(NvmlBackend, "EVENT_WAIT_MS", 20)
    b = NvmlBackend()
    b.open()
    try:
        fields = B.exporter_fields()
        got = B.tier_1hz(b, 1, fields, seconds=0.6, interval_s=0.2)
        # the backend's own entry points are back after the run
        assert all(not getattr(f, "__name__", "") == "timed"
                   for f in b._fn.values())
        assert b.read_fields(1, [fields[0]])
    finally:
        b.close()
    assert got["tier"] == "nvml" and got["index"] == 1
    assert got["sweeps"] == 3 and len(got["sweep_ms"]) == 3
    assert got["fields"] == len(fields) and got["nonblank"] >= 20
    assert got["cpu_percent_1hz"] >= 0.0
    assert got["cpu_under_1pct"] == (got["cpu_percent_1hz"] < 1.0)
    # one field-values request a sweep: violations, memory temperature,
    # energy and the NVLink states together
    assert got["call_ms"]["nvmlDeviceGetFieldValues"][1] == 1
    assert "nvmlDeviceGetTotalEnergyConsumption" not in got["call_ms"]
    assert "nvmlDeviceGetNvLinkState" not in got["call_ms"]


@pytest.mark.parametrize("agent", [False, True])
def test_burst_cpu_split_over_the_fake_nvml(fake_nvml, monkeypatch, agent):
    """The split is taken from outside the loop: the parts are there, the
    NVML calls are part of the read, and the backend is restored."""

    from tpumon_torch.backends.nvml import NvmlBackend

    monkeypatch.setenv("TPUMON_NVML_PATH", fake_nvml)
    monkeypatch.setenv("TPUMON_KMSG_PATH", "/nonexistent")
    monkeypatch.setattr(NvmlBackend, "EVENT_WAIT_MS", 20)
    b = NvmlBackend()
    b.open()
    try:
        got = B.burst_cpu_split(b, 0, 100, 0.4, agent=agent)
        assert "read_burst_fields" not in vars(b)
        assert all(not getattr(f, "__name__", "") == "timed"
                   for f in b._fn.values())
    finally:
        b.close()
    us = got["us_per_tick"]
    assert got["loop"] == ("agent" if agent else "exporter")
    assert got["ticks"] >= 10 and got["overruns"] >= 0
    assert set(us) == {"read", "nvml_calls", "marshalling", "fold", "wait"}
    assert us["read"] >= us["nvml_calls"] >= 0.0 and us["fold"] > 0.0
    assert us["marshalling"] == round(us["read"] - us["nvml_calls"], 2)
    assert got["calls_per_tick"] and got["thread_cpu_percent"] > 0.0


def test_agent_collect_over_the_fake_nvml(fake_nvml, monkeypatch):
    """The agent's watches sweep the card at the asked rate; a tail has
    no p99 under 100 sweeps, and has one from 100."""

    from tpumon_torch.backends.nvml import NvmlBackend

    monkeypatch.setenv("TPUMON_NVML_PATH", fake_nvml)
    monkeypatch.setenv("TPUMON_KMSG_PATH", "/nonexistent")
    monkeypatch.setattr(NvmlBackend, "EVENT_WAIT_MS", 20)
    b = NvmlBackend()
    b.open()
    try:
        got = B.agent_collect(b, 1, B.exporter_fields(), 0.5, hz=20.0)
        assert "read_fields_bulk" not in vars(b)
    finally:
        b.close()
    assert 5 <= got["sweep_ms"]["n"] < 100 and got["sweep_ms"]["p99"] is None
    assert got["sweep_ms"]["max"] >= got["sweep_ms"]["p50"] > 0.0
    assert got["call_ms"]["nvmlDeviceGetFieldValues"]["calls"] == 1
    assert B.tail_ms([float(x) for x in range(100)]) == {
        "n": 100, "p50": 50.0, "p99": 99.0, "max": 99.0}
    assert B.tail_ms([]) == {"n": 0, "p50": None, "p99": None, "max": None}


def test_tier_1hz_where_no_nvml_is_exposed(monkeypatch):
    monkeypatch.setenv("TPUMON_NVML_PATH", "/nonexistent/libnvidia-ml.so.1")
    got = B.run_tier_1hz(1.0)
    assert got["tier"] == "none_exposed" and "nvml" in got["reason"].lower()


# ---- F2 on the CPU: the runner steps eagerly, the graph refuses ---------------

def test_runner_on_the_cpu_steps_eagerly_with_the_same_result():
    cpu = torch.device("cpu")
    work = R.Workload("train", "tiny", 2, cpu)
    assert work.graph is None
    for _ in range(3):
        work.step()
    work.sync()
    cfg, params, tokens = R.workload("tiny", 2, cpu)
    for _ in range(3):
        params, loss = M.train_step(cfg, params, tokens)
    assert work.final_loss() == loss.item()
    got = dict(zip(range(100), M.tree_leaves(work._train()[0])))
    # one more step on each side, leaf for leaf equal
    params, _ = M.train_step(cfg, params, tokens)
    for i, leaf in enumerate(M.tree_leaves(params)):
        assert torch.equal(got[i], leaf)


def test_runner_window_on_the_cpu_is_unchanged():
    work = R.Workload("train", "tiny", 2, torch.device("cpu"))
    res = R.run_window(work, 0.2, device_name="cpu")
    assert set(res) == {"pattern", "steps", "seconds", "steps_per_sec",
                        "final_loss", "monitor_sweeps", "device"}
    assert res["pattern"] == "train" and res["steps"] >= 1
    assert res["device"] == "cpu" and res["monitor_sweeps"] == 0
    work = R.Workload("hbm", device=torch.device("cpu"))
    assert R.run_window(work, 0.1)["final_loss"] is None


def test_graph_step_refuses_the_cpu():
    cfg, params, tokens = R.workload("tiny", 2, torch.device("cpu"))
    with pytest.raises(ValueError, match="needs a CUDA device"):
        GraphStep(cfg, params, tokens)


def test_bench_gpu_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        B.main(["--pattern", "hbm", "--pairs", "2"])


# ---- the trace engine on graph replays ----------------------------------------

class Ev:
    """The part of ``torch.autograd._KinetoEvent`` the loaders read."""

    def __init__(self, name, start, dur, *, dev=False, corr=0, linked=0,
                 flops=0):
        self.v = (name, start, dur, dev, corr, linked, flops)

    def name(self):
        return self.v[0]

    def start_ns(self):
        return self.v[1]

    def duration_ns(self):
        return self.v[2]

    def device_type(self):
        from torch.autograd import DeviceType
        return DeviceType.CUDA if self.v[3] else DeviceType.CPU

    def device_index(self):
        return 0

    def correlation_id(self):
        return self.v[4]

    def linked_correlation_id(self):
        return self.v[5]

    def start_thread_id(self):
        return 1

    def flops(self):
        return self.v[6]


#: one step's work: (op, FLOPs, its device records)
STEP = [("aten::mm", 4000, ["nvjet_gemm"]),
        ("aten::copy_", 0, ["Memcpy DtoD (Device -> Device)"]),
        ("aten::add", 0, ["elementwise_kernel"]),
        ("aten::zero_", 0, ["Memset (Device)"])]
#: the same step's records in a graph: the copy runs as a kernel
GRAPH = ["nvjet_gemm", "memcpy128", "elementwise_kernel", "Memset (Unknown)"]


def eager_events(t0=0, corr0=100):
    ev, t, c = [], t0, corr0
    for op, flops, recs in STEP:
        ev.append(Ev(op, t, 50, corr=c, flops=flops))
        for i, name in enumerate(recs):
            ev.append(Ev("cudaLaunchKernel", t + 5, 5, corr=c + 1))
            ev.append(Ev(name, t + 20, 10, dev=True, corr=c + 1, linked=c))
        t, c = t + 100, c + 10
    return ev


def graph_launch(t0, corr, names=GRAPH):
    ev = [Ev("cudaGraphLaunch", t0, 5, corr=corr)]
    ev += [Ev(n, t0 + 20 + 30 * i, 20, dev=True, corr=corr)
           for i, n in enumerate(names)]
    return ev


@pytest.fixture
def programs(monkeypatch):
    monkeypatch.setattr(T, "_GRAPH_PROGRAMS", {})
    return T._GRAPH_PROGRAMS


def test_graph_program_lines_replays_up_with_the_eager_step(programs):
    prog = T.graph_program(eager_events() + graph_launch(10_000, 900))
    assert prog.names == tuple(GRAPH)
    assert prog.ops == ("aten::mm", "aten::copy_", "aten::add",
                        "aten::zero_")
    assert prog.matched == 1.0
    assert prog.flops == (("aten::mm", 4000),)
    with pytest.raises(ValueError, match="2 graph launches"):
        T.graph_program(eager_events() + graph_launch(10_000, 900)
                        + graph_launch(20_000, 901))


def test_replays_read_by_their_program(programs):
    prog = T.graph_program(eager_events() + graph_launch(10_000, 900))
    ev = graph_launch(0, 5) + graph_launch(10_000_000, 6)
    before = T.kineto_records(ev)
    assert all(r.op is None for r in before if r.kind == "device")
    assert not [r for r in before if r.kind == "op"]
    programs[T.program_key(prog.names)] = prog
    recs = T.kineto_records(ev)
    dev = [r for r in recs if r.kind == "device"]
    assert [r.op for r in dev] == list(prog.ops) * 2
    ops = [r for r in recs if r.kind == "op"]
    assert [(r.name, r.flops, r.device) for r in ops] == \
        [("aten::mm", 4000, 0)] * 2
    s = T.analyze(recs, 1e-3, {0: CARD})[0]
    assert s.exact_categories
    assert s.mxu_tflops == pytest.approx(8000 / 1e-3 / 1e12)
    # the copy kernel reads as the data its op moves, not as vector work
    assert s.data_frac == pytest.approx(2 * (20 + 20) / 1e6)
    # a launch of other names is not the program
    other = T.kineto_records(graph_launch(0, 7, GRAPH[:2]))
    assert all(r.op is None for r in other)
    # CUPTI names a graph's copy node by its kind or by the kernel that
    # runs it, and a fill by the memory kind it knows, differently from
    # session to session of one process: the same program all the same
    renamed = ["nvjet_gemm", "Memcpy DtoD (Device -> Device)",
               "elementwise_kernel", "Memset (Device)"]
    recs = T.kineto_records(graph_launch(0, 8, renamed))
    assert [r.op for r in recs if r.kind == "device"] == list(prog.ops)
    assert [r.name for r in recs if r.kind == "device"] == renamed
    assert T.program_key(renamed) == T.program_key(GRAPH) == (
        "nvjet_gemm", "Memcpy", "elementwise_kernel", "Memset")
    assert T.program_key(["memcpy32_post"]) == ("Memcpy",)


def test_lost_graph_records_fail_the_capture(programs):
    """A graph launch must have its records, as a kernel launch must."""

    ev = [Ev("aten::empty", 0, 10, corr=1)]
    for i in range(300):
        ev += graph_launch(100_000 * i, 1000 + i)
    assert len(T.kineto_records(ev)) == 1200
    kept = [e for e in ev if not (e.v[3] and 1100 <= e.v[4] < 1200)]
    with pytest.raises(T.LostRecords, match="lost 100 of"):
        T.kineto_records(kept)
