"""The benchmark's harness on the CPU: cells, configurations, mixes and
readers found by name; the yardstick's counts; the tail and the open
loop; the result line; the comparison's parts; the import guards."""

from __future__ import annotations

import ast
import http.server
import json
import os
import shutil
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest
import torch

from gpubench import check, devtrace, flops, run, stats
from gpubench.kinds import train as KT
from gpubench.reference import model as RM
from gpubench.reference import promtext as RP

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


# ---- found by name --------------------------------------------------------


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_gpubench_every_cell_resolves(cell):
    c, entry, config, traffic = run.cell_spec(BENCH, cell)
    assert config["name"] == c["config"] == entry["name"]
    assert traffic["name"] == c["traffic"]
    assert set(config["reduced"]) == set(entry["reduced"])
    for key in entry["reduced"]:
        assert key in config["published"]
    for trace in (0, 1):
        for m in run.metric_specs(BENCH, c, trace):
            assert callable(run.reader(m["name"]))
    e2e = [m["name"] for m in run.metric_specs(BENCH, c, 0)]
    assert e2e == [m["name"] for m in BENCH["end_to_end"]
                   if cell in m.get("workloads", [cell])]
    assert "setup_s" in e2e and len(e2e) >= 2
    # every per-layer metric of the cell moves one it reports
    assert {m["moves"] for m in run.metric_specs(BENCH, c, 1)} <= set(e2e)


def test_gpubench_each_metric_names_cells_that_report_what_it_moves():
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= cells


def test_gpubench_a_cell_added_as_files_is_found(tmp_path):
    """A throwaway cell, configuration, mix and reader added as new files
    in a copy of the benchmark, with no file that was there edited."""

    shutil.copytree(ROOT / "gpubench", tmp_path / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    cfg = json.loads((ROOT / "gpubench/configs/agent-prom.json").read_text())
    cfg["name"] = "agent-extra"
    (tmp_path / "gpubench/configs/agent-extra.json").write_text(
        json.dumps(cfg))
    mix = json.loads((ROOT / "gpubench/traffic/train.json").read_text())
    mix["name"] = "train-extra"
    (tmp_path / "gpubench/traffic/train-extra.json").write_text(
        json.dumps(mix))
    (tmp_path / "gpubench/metrics/extra_metric.py").write_text(
        "def read(run):\n    return 42.0\n")
    bench["configs"].append({"name": "agent-extra", "source": "x",
                             "file": "gpubench/configs/agent-extra.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "extra.cell", "config": "agent-extra",
                               "traffic": "train-extra", "chips": 1,
                               "why": "x"})
    bench["per_layer"].append({"name": "extra_metric", "unit": "%",
                               "better": "lower", "source": "host_clock",
                               "layer": "x", "moves": "setup_s",
                               "workloads": ["extra.cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = ("import json\nfrom gpubench import run\n"
            "b = json.load(open('BENCHMARK.json'))\n"
            "c, e, cfg, t = run.cell_spec(b, 'extra.cell')\n"
            "names = [m['name'] for m in run.metric_specs(b, c, 1)]\n"
            "print(cfg['name'], t['name'], names,"
            " run.reader('extra_metric')(None))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[:2] == ["agent-extra", "train-extra"]
    assert "'extra_metric'" in out.stdout and out.stdout.endswith("42.0\n")


TOY_KIND = """
import torch
from gpubench.kinds import draw_steps, pattern_numbers
FAULTS = ("unchanged",)
draws = draw_steps
def build(job, w, seed, device):
    job.pattern = "toy"
    job._step = lambda s: s * w["scale"]
    job.state = torch.full((w["n"],), 1.0 + seed % 3, device=device)
    job.shapes = {"n": w["n"]}
def hold(job):
    pass
def error(job, before, after, fp8=False):
    return (after - 2.0 * before).abs().max().item()
def numbers(job, w, check, device):
    return pattern_numbers(job, error)
def control(run):
    return {"step_err_rms": 1.0}
def mxu_burn_call(shapes):
    return 1, shapes["n"], 1
def step_flops(w, shapes):
    return 2 * shapes["n"]
"""


def test_gpubench_a_kind_added_as_files_is_found(tmp_path):
    """A throwaway kind of job and a mix of it, added as new files in a
    copy of the benchmark: the job is built, stepped, checked and
    counted through the kind's module, with no file that was there
    edited."""

    shutil.copytree(ROOT / "gpubench", tmp_path / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (tmp_path / "gpubench").rglob("*")
              if p.is_file()}
    (tmp_path / "gpubench/kinds/toy.py").write_text(TOY_KIND)
    mix = json.loads((ROOT / "gpubench/traffic/mxu.json").read_text())
    mix.update(name="toy", workload={"kind": "toy", "n": 4, "scale": 2.0},
               check={"samples": 3, "steps_lower_per_s": 8})
    (tmp_path / "gpubench/traffic/toy.json").write_text(json.dumps(mix))
    code = ("import json\n"
            "from gpubench import check, kinds\n"
            "from gpubench.workloads import Job\n"
            "from gpubench.metrics import mxu_burn_roofline as r\n"
            "mix = json.load(open('gpubench/traffic/toy.json'))\n"
            "job = Job(mix, 1.0, 2 ** 31 + 5, 'cpu')\n"
            "for _ in range(8):\n"
            "    job.step()\n"
            "job.sync()\n"
            "kind = kinds.load(job.kind)\n"
            "print(json.dumps([check.job_numbers(job, mix, 'cpu'),\n"
            "    kind.step_flops(mix['workload'], job.shapes),\n"
            "    kind.mxu_burn_call(job.shapes), job.calls]))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert out.returncode == 0, out.stderr
    nums, ops, call, calls = json.loads(out.stdout.splitlines()[-1])
    assert nums == {"step_err_rms": 0.0, "steps_compared": 3.0}
    assert ops == 8 and call == [1, 4, 1] and calls == 8
    for path, data in before.items():
        assert path.read_bytes() == data


# ---- the yardstick's counts -----------------------------------------------


def test_gpubench_attention_counts_by_hand():
    # causal pairs over 4 positions: 4 + 3 + 2 + 1
    assert flops.causal_pairs(4) == 10
    # forward: Q K^T and P V, 2 * d flops a pair each
    assert flops.attention_fwd_flops(1, 1, 4, 8) == 2 * 2 * 8 * 10
    assert flops.attention_bwd_flops(2, 3, 4, 8) == 4 * 2 * 8 * 10 * 6
    assert flops.attention_bytes(1, 2, 4, 8, backward=False) == 4 * 64 * 2
    assert flops.attention_bytes(1, 2, 4, 8, backward=True) == 8 * 64 * 2


def test_gpubench_train_step_count_by_hand():
    m = {"batch": 2, "seq_len": 5, "d_model": 4, "d_ff": 8, "vocab": 16,
         "n_heads": 2, "n_layers": 1}
    rows = 2 * 4
    gemm = 2 * rows * (3 * 16 + 16 + 2 * 4 * 8) + 2 * rows * 4 * 16
    attn = (2 + 4) * 2 * 2 * flops.causal_pairs(4) * 2 * 2
    assert flops.train_step_flops(m) == 3 * gemm + attn
    bench = json.loads((ROOT / "gpubench/traffic/train.json").read_text())
    assert flops.train_step_flops(bench["workload"]["model"]) == \
        237_439_549_440


def test_gpubench_mxu_counts_and_roofline():
    assert flops.mxu_burn_flops(66, 256, 64) == 66 * 64 * 2 * 256 ** 3
    assert flops.mxu_burn_bytes(2, 4) == 5 * 16 * 2
    ops = 989e12 * 1e-3                       # a millisecond at peak
    assert flops.roofline_pct(ops, 0, 2e-3, "NVIDIA H100 80GB HBM3") == \
        pytest.approx(50.0)
    nbytes = 3.35e12 * 1e-3                   # bound by bytes instead
    assert flops.roofline_pct(1.0, nbytes, 4e-3, "NVIDIA H100 PCIe") == \
        pytest.approx(25.0)
    with pytest.raises(KeyError):
        flops.peaks("cpu")


# ---- the tail and the open loop -------------------------------------------


def test_gpubench_tail_over_all_scrapes_failures_at_timeout():
    recs = [{"ok": True, "due": 0.0, "end": 0.001 * (i + 1)}
            for i in range(95)]
    recs += [{"ok": False, "due": 0.0, "end": 0.0}] * 5
    lat = stats.scrape_latencies_ms(recs, timeout_s=10.0)
    assert len(lat) == 100 and lat.count(10000.0) == 5
    p95 = stats.percentile(lat, 95)
    assert 95.0 < p95 <= 10000.0
    # without the failures the tail is a few ms
    assert stats.percentile(lat[:95], 95) < 96.0
    assert stats.percentile([1.0], 95) is None


class _Slow(http.server.BaseHTTPRequestHandler):
    stall = {"left": 1}

    def do_GET(self):
        if self.stall["left"]:
            self.stall["left"] -= 1
            time.sleep(0.35)
        body = b"ok 1\n"
        self.send_response(200)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *a):
        pass


def test_gpubench_open_loop_times_from_due():
    """One client at 10 Hz: its first scrape stalls 0.35 s, so the next
    ones are sent late, and each is timed from when it was due."""

    from gpubench import scrape

    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), _Slow)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    try:
        out = []
        t0 = time.monotonic() + 0.05
        scrape.scraper({"hz": 10.0, "scrapers": 1, "seconds": 1.0,
                        "port": srv.server_address[1], "path": "/",
                        "timeout_s": 5.0, "seed": 2 ** 31 + 3}, t0, 0,
                       out, [])
    finally:
        srv.shutdown()
    assert len(out) == 10 and all(r["ok"] for r in out)
    # one due in each tenth of the second
    assert [int((r["due"] - t0) * 10) for r in out] == list(range(10))
    lat = [r["end"] - r["due"] for r in out]
    assert lat[0] >= 0.35
    # the second was due within 0.2 s, sent after the stall
    assert out[1]["sent"] >= out[0]["end"]
    assert lat[1] >= out[0]["end"] - out[1]["due"] > 0.1
    assert lat[-1] < 0.1


def test_gpubench_scrape_times_repeat_by_seed():
    from gpubench import scrape

    def dues(seed):
        out = []
        cfg = {"hz": 1.0, "scrapers": 2, "seconds": 3.0, "port": 1,
               "path": "/", "timeout_s": 0.01, "seed": seed}
        t0 = time.monotonic() - 10.0
        scrape.scraper(cfg, t0, 1, out, [])
        return [r["due"] - t0 for r in out]

    assert dues(7) == dues(7) != dues(8)


# ---- the result line ------------------------------------------------------


def test_gpubench_no_card_exits_without_a_result(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", "daemonset.train", "--seed",
                     str(2 ** 31 + 7), "--seconds", "1"]) == 3
    assert capsys.readouterr().out == ""


def _fake_result(refused=()):
    return {"correct": True, "attempted": 240, "failed": 0,
            "metrics": {"setup_s": {"value": 1.5, "unit": "s"}},
            "device": {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
                       "count": 1, "memory_peak_bytes": 1},
            "compared": {"loss_gap": {"value": 1e-5, "limit": 1e-3}},
            "_refused": list(refused)}


def test_gpubench_last_line_keys(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(run, "run_cell", lambda *a, **k: _fake_result())
    assert run.main(["--workload", "daemonset.train", "--seed", "5",
                     "--seconds", "1", "--trace", "0"]) == 0
    line = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "compared"]
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}


def test_gpubench_refused_module_fails_the_run(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(run, "run_cell",
                        lambda *a, **k: _fake_result(["tpumon"]))
    assert run.main(["--workload", "daemonset.train", "--seed", "5",
                     "--seconds", "1"]) == 4
    assert capsys.readouterr().out == ""


def test_gpubench_refused_here_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "tpumon_torch_x", object())
    assert run.refused_here() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert run.refused_here() == ["jax"]


def test_gpubench_fails_where_only_the_benchmark_is(tmp_path):
    shutil.copytree(ROOT / "gpubench", tmp_path / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    out = subprocess.run(
        [sys.executable, "-m", "gpubench.run", "--workload",
         "daemonset.train", "--seed", "1", "--seconds", "1"],
        cwd=tmp_path, capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=""))
    assert out.returncode != 0 and out.stdout == ""


# ---- the comparison's parts -----------------------------------------------


UUID = "GPU-1"


def _body(extra=""):
    return (f'tpu_power{{uuid="{UUID}",pod_name="p"}} 100\n'
            f'tpumon_exporter_sweeps_total{{host="h"}} 7\n' + extra)


def test_gpubench_merge_served_exactly():
    drop = RP.samples(f'tpu_mfu{{uuid="{UUID}"}} 0.25\n'
                      'tpumon_exporter_sweeps_total{host="h"} 3\n')
    own = set(RP.samples(_body()))
    body = RP.samples(_body(f'tpu_mfu{{uuid="{UUID}"}} 0.25\n'))
    # the node's own series wins the collision in its own family
    assert RP.merge_mismatches(body, [drop], own) == (0, 0)
    altered = RP.samples(_body(f'tpu_mfu{{uuid="{UUID}"}} 0.26\n'))
    assert RP.merge_mismatches(altered, [drop], own)[0] == 1
    missing = RP.samples(_body())
    assert RP.merge_mismatches(missing, [drop], own)[0] == 1
    # a series of a family the node serves, but not the node's own series
    other = RP.samples(f'tpu_power{{uuid="{UUID}"}} 5\n')
    served = RP.samples(_body(f'tpu_power{{uuid="{UUID}"}} 6\n'))
    assert RP.merge_mismatches(served, [other], own)[0] == 1


def test_gpubench_merge_matches_the_version_served():
    versions = [RP.samples(f'tpu_mfu{{uuid="{UUID}"}} {v}\n'
                           f'tpu_duty{{uuid="{UUID}"}} {v}\n')
                for v in (1, 2, 3)]
    body = RP.samples(_body(f'tpu_mfu{{uuid="{UUID}"}} 2\n'
                            f'tpu_duty{{uuid="{UUID}"}} 2\n'))
    assert RP.merge_mismatches(body, versions, set()) == (0, 1)


def _scrapes(value="0.5", total="81559"):
    fams = "".join(f'tpu_f{i}{{uuid="{UUID}"}} 1\n' for i in range(20))
    own = f'tpu_hbm_total{{uuid="{UUID}",pod_name="p"}} {total}\n'
    return fams + own + f'tpu_mfu{{uuid="{UUID}"}} {value}\n', \
        set(RP.samples(fams + own))


def test_gpubench_monitor_numbers_count_failures():
    body, own = _scrapes()
    scrapes = {"drops": [{"text": f'tpu_mfu{{uuid="{UUID}"}} 0.5\n'}],
               "records": [
                   {"ok": True, "body": body},
                   {"ok": True, "body": "tpu_f0 1\n"},     # no card families
                   {"ok": False}]}
    nums, failed = check.monitor_numbers(scrapes, own, UUID, 20, 4, 81559)
    # the second and third failed, and the fourth due was never made
    assert failed == 3
    assert nums == {"merge_mismatches": 0.0, "hbm_total_mismatches": 0.0,
                    "scrapes_not_served": 3.0, "scrapes_compared": 1.0}
    from gpubench.control import f32_body
    body, own = _scrapes("0.1")
    scrapes["drops"] = [{"text": f'tpu_mfu{{uuid="{UUID}"}} 0.1\n'}]
    scrapes["records"] = [{"ok": True, "body": body}]
    assert check.monitor_numbers(scrapes, own, UUID, 20, 1, 81559)[0][
        "merge_mismatches"] == 0.0
    got = check.monitor_numbers(scrapes, own, UUID, 20, 1, 81559,
                                alter=f32_body)[0]
    assert got["merge_mismatches"] == 1.0 and got["scrapes_not_served"] == 0


@pytest.mark.parametrize("total,bad", [("81559", 0.0), ("81558", 1.0),
                                       (None, 1.0)])
def test_gpubench_card_memory_total_held_to_nvidia_smi(total, bad):
    body, own = _scrapes(total=total or "1")
    if total is None:                       # the node serves no total
        body = "".join(ln + "\n" for ln in body.splitlines()
                       if not ln.startswith("tpu_hbm_total"))
    scrapes = {"drops": [{"text": f'tpu_mfu{{uuid="{UUID}"}} 0.5\n'}],
               "records": [{"ok": True, "body": body}]}
    nums, failed = check.monitor_numbers(scrapes, own, UUID, 20, 1, 81559)
    assert nums["hbm_total_mismatches"] == bad and failed == 0
    assert check.monitor_numbers(scrapes, own, UUID, 20, 1, None)[0][
        "hbm_total_mismatches"] is None


def test_gpubench_a_node_that_serves_nothing_is_not_correct():
    """The planted ``silent`` fault: every scrape answered, none with the
    card's families; every due scrape counts as not served."""

    from gpubench.scrape import silent

    body, own = _scrapes()
    scrapes = {"drops": [{"text": f'tpu_mfu{{uuid="{UUID}"}} 0.5\n'}],
               "records": [{"ok": True, "body": silent(body)}] * 3}
    assert "tpu_" not in silent(body)
    nums, failed = check.monitor_numbers(scrapes, own, UUID, 20, 3, 81559)
    limits = json.loads((ROOT / "gpubench/traffic/train.json").read_text())[
        "limits"]
    assert failed == 3 and nums["scrapes_not_served"] > \
        limits["scrapes_not_served"]
    # every scrape failing leaves nothing to compare, and is not correct
    assert nums["merge_mismatches"] == 0.0 and nums["scrapes_compared"] == 0


def test_gpubench_scrapes_due():
    assert stats.scrapes_due(1, 1.0, 51) == 51
    assert stats.scrapes_due(8, 1.0, 51) == 408
    assert stats.scrapes_due(1, 10.0, 1.0) == 10
    assert stats.scrapes_due(2, 1.0, 2.5) == 6


def test_gpubench_exporter_sweep_reader():
    from gpubench.metrics import exporter_sweep_ms

    def body(n, *phases):
        lines = [f'tpumon_exporter_sweeps_total{{host="h"}} {n}']
        lines += [f'tpumon_exporter_sweep_phase_seconds{{host="h",'
                  f'phase="p{i}"}} {v}' for i, v in enumerate(phases)]
        return "\n".join(lines) + "\n"

    recs = [{"ok": True, "body": body(1, 0.001, 0.002)},
            {"ok": True, "body": body(1, 0.001, 0.002)},   # same sweep
            {"ok": True, "body": body(2, 0.004, 0.006)},
            {"ok": True, "body": body(3, 0.020, 0.0)},
            {"ok": False}]

    class R:
        scrapes = {"records": recs}

    assert exporter_sweep_ms.read(R) == pytest.approx(10.0)
    R.scrapes = {"records": [{"ok": True, "body": "tpu_x 1\n"}]}
    assert exporter_sweep_ms.read(R) is None


def test_gpubench_planted_answer_fault():
    """The ``altered`` fault changes a drop sample that the node does not
    serve itself: one it serves itself under the same labels wins the
    merge, so altering it would go unseen."""

    from gpubench.scrape import alter

    drop = [{"text": f'tpu_clock{{uuid="{UUID}"}} 1980\n'
                     f'tpu_mfu{{uuid="{UUID}"}} 0.5\n'}]
    body = _body(f'tpu_clock{{uuid="{UUID}"}} 1980\n'
                 f'tpu_mfu{{uuid="{UUID}"}} 0.5\n')
    own = {("tpu_clock", (("uuid", UUID),))}
    served = RP.samples(alter(body, drop, own))
    assert served[("tpu_mfu", (("uuid", UUID),))] == "1.5"
    assert served[("tpu_clock", (("uuid", UUID),))] == "1980"
    drops = [RP.samples(d["text"]) for d in drop]
    assert RP.merge_mismatches(served, drops, own)[0] == 1
    # without ``own`` the first drop line, the node's own, is altered
    # and the merge rule lets it pass
    blind = RP.samples(alter(body, drop))
    assert RP.merge_mismatches(blind, drops, own)[0] == 0


def test_gpubench_devtrace_busy_gaps_and_kernels():
    dev = [(0, 100, "k1"), (50, 150, "k2"), (300, 400, "k1")]
    host = [(0, 500, "step"), (160, 290, "cudaGraphLaunch")]
    out = devtrace.reduce(dev, host)
    assert out["busy_s"] == pytest.approx(250e-9)
    assert out["window_s"] == pytest.approx(500e-9)
    assert out["idle_gaps"][0] == ["cudaGraphLaunch", pytest.approx(150e-9)]
    assert out["kernels"]["k1"] == (2, pytest.approx(200e-9))
    assert devtrace.mean_call_s(out, "k1") == pytest.approx(100e-9)
    assert devtrace.mean_call_s(out, "absent") is None
    assert devtrace.reduce([], host) is None


TINY = {"vocab": 128, "d_model": 128, "n_heads": 2, "n_layers": 2,
        "d_ff": 256, "seq_len": 32, "flash": False, "batch": 4, "lr": 1e-3}


def _program_steps(seed, fault=None):
    """The program's eager train step on the CPU at a tiny size: three
    steps before, three compared (``fault``: ``unchanged`` skips them,
    ``half_batch`` trains on half the rows)."""

    from tpumon_torch.loadgen import model as M
    params, tokens = KT.train_inputs(TINY, seed, "cpu")
    p0 = M.tree_map(lambda t: t.clone(), params)
    cfg = M.ModelConfig(**{k: TINY[k] for k in (
        "vocab", "d_model", "n_heads", "n_layers", "d_ff", "seq_len")})
    feed = tokens[:2] if fault == "half_batch" else tokens
    for _ in range(3):
        M.train_step(cfg, params, feed, lr=TINY["lr"])
    snaps = [M.tree_map(lambda t: t.detach().clone(), params)]
    losses = []
    for _ in range(3):
        if fault == "unchanged":
            losses.append(losses[-1] if losses else 0.0)
        else:
            losses.append(M.train_step(cfg, params, feed,
                                       lr=TINY["lr"])[1].item())
        snaps.append(M.tree_map(lambda t: t.detach().clone(), params))
    return p0, tokens, losses, snaps


@pytest.mark.parametrize("seed", [1, 2 ** 31 + 11])
def test_gpubench_train_comparison_separates_the_control(seed):
    p0, tokens, losses, snaps = _program_steps(seed)
    prog = KT.train_numbers(TINY, TINY["lr"], p0, tokens, 3, losses,
                               snaps, "cpu")
    ctrl = KT.train_numbers(TINY, TINY["lr"], p0, tokens, 3, losses,
                               snaps, "cpu", fp8=True)
    assert prog["grad_rel_err"] < 0.05 and prog["loss_gap"] < 1e-3
    assert ctrl["grad_rel_err"] > 3 * prog["grad_rel_err"]


@pytest.mark.parametrize("fault,number", [("unchanged", "change_norm_gap"),
                                          ("half_batch", "grad_rel_err")])
def test_gpubench_train_faults_read_high(fault, number):
    p0, tokens, losses, snaps = _program_steps(3, fault)
    sound = KT.train_numbers(TINY, TINY["lr"], *_program_steps(3)[:1],
                                tokens, 3, *_program_steps(3)[2:], "cpu")
    got = KT.train_numbers(TINY, TINY["lr"], p0, tokens, 3, losses,
                              snaps, "cpu")
    assert got[number] > 10 * sound[number]


def test_gpubench_pattern_references_on_the_cpu():
    from gpubench.reference import kernels as RK
    from gpubench.kinds.mxu import chain_weight, hadamard

    w = hadamard(16, "cpu")
    assert torch.allclose(w @ w.T, torch.eye(16), atol=1e-6)
    c = chain_weight(256, "cpu").double()
    assert torch.allclose(c @ c.T, torch.eye(256, dtype=torch.float64))
    assert torch.equal(c.to(torch.bfloat16).double(), c)
    power = torch.eye(256, dtype=torch.float64)
    for _ in range(64):
        power = power @ c
        assert (power - torch.eye(256)).norm() > 16.0
    x = torch.randn(2, 16, 16).to(torch.bfloat16)
    want = RK.mxu_chain(x, w.to(torch.bfloat16), 4)
    assert RK.max_rms_error(RK.mxu_chain(x, w.to(torch.bfloat16), 4),
                            want) == 0.0
    assert RK.max_rms_error(RK.mxu_chain(x, w.to(torch.bfloat16), 4,
                                         fp8=True), want) > 0.01
    q, k, v = (torch.randn(1, 8, 3, 4) for _ in range(3))
    out = RK.causal_attention(q, k, v, heads_per_block=2)
    dense = torch.nn.functional.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        is_causal=True).transpose(1, 2)
    assert torch.allclose(out, dense, atol=1e-5)


# ---- import guards --------------------------------------------------------


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(
    (ROOT / "gpubench/reference").glob("*.py")), ids=lambda p: p.name)
def test_gpubench_reference_imports_no_program(path):
    got = set(_imports(path))
    assert not got & {"jax", "jaxlib", "flax", "tpumon", "tpumon_torch"}


@pytest.mark.parametrize("path", sorted(
    p for p in (ROOT / "gpubench").rglob("*.py")
    if "tests" not in p.parts), ids=lambda p: str(p.relative_to(ROOT)))
def test_gpubench_imports_neither_jax_nor_tpumon(path):
    assert not set(_imports(path)) & {"jax", "jaxlib", "flax", "tpumon"}


def test_gpubench_guard_refuses_in_a_child(tmp_path):
    log = tmp_path / "refused.log"
    env = dict(os.environ,
               PYTHONPATH=f"{ROOT / 'gpubench/guard'}{os.pathsep}{ROOT}",
               GPUBENCH_IMPORT_LOG=str(log))
    ok = subprocess.run([sys.executable, "-c", "import tpumon_torch"],
                        env=env, capture_output=True, text=True, timeout=60)
    assert ok.returncode == 0, ok.stderr
    bad = subprocess.run([sys.executable, "-c", "import tpumon"], env=env,
                         capture_output=True, text=True, timeout=60)
    assert bad.returncode != 0 and "refused" in bad.stderr
    assert log.read_text().split()[1] == "tpumon"


def test_gpubench_reference_moving_leaves_rule():
    g = {k: torch.ones(4) for k in RM.LEAVES}
    g["ln_f"] = torch.full((4,), 1e-9)
    assert "ln_f" not in RM.moving_leaves(g)
    assert len(RM.moving_leaves(g)) == len(RM.LEAVES) - 1
