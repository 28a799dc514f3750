"""The port's scenario corpus (``tests/data/torch_scenarios/``) run by the
port's chaos harness, on the CPU: each scenario runs once.

* Every scenario green: the reference's acceptance gate
  (``tests/test_chaos.py::test_scenario_runs_green``, run on the port by
  :func:`test_torch_fleet.run_on_port`): post-fault convergence to the
  flat reference within K ticks, healthy-shard byte isolation, no fd or
  thread leaks, a recorded trace that replays the fault window, the
  artifacts on disk.
* From the same runs:
  - ``healthy``: the recorded fleet-view trace byte-identical to the one
    the reference harness (``tpumon.chaos``) records for the same file in
    the same directory;
  - ``shard-kill-mid-frame``: the reference's evidence case (the killed
    child restarted, the one healthy shard's bytes judged and pinned, every
    tick replayed);
  - ``ecc-storm``: each ECC_DBE event on the GPU whose bus its Xid 48 line
    names (storms on GPU 0 and GPU 1), and every line a driver Xid line;
  - ``ici-link-flap``: ICI_ERROR from an Xid 74 line;
  - ``thermal-throttle``: THERMAL raised with no kernel line.
"""

import glob
import json
import os
import shutil

import pytest

import test_chaos as REF_CHAOS
from test_torch_chaos import PORT_CORPUS, PORT_NAMES
from test_torch_fleet import run_on_port
from tpumon import chaos as JC
from tpumon_torch import chaos as TC
from tpumon_torch.blackbox import BlackBoxReader, KmsgRecord, ReplayTick


def _replay(report):
    """(tick events, kmsg lines) of a run's recorded trace."""

    events, lines = [], []
    for item in BlackBoxReader(os.path.join(report.trace_dir,
                                            "fleetview")).replay():
        if isinstance(item, ReplayTick):
            events += item.events
        elif isinstance(item, KmsgRecord):
            lines.append(item.line)
    return events, lines


def _segments(trace_dir):
    d = os.path.join(trace_dir, "fleetview")
    out = {}
    for name in sorted(os.listdir(d)):
        with open(os.path.join(d, name), "rb") as f:
            out[name] = f.read()
    return out


def _check_healthy(report, scenario, tmp_path):
    port = _segments(report.trace_dir)
    # the reference harness in the same directory: the host addresses in
    # the rows are socket paths under it
    run = str(tmp_path / scenario.name)
    shutil.rmtree(run)
    ref = JC.run_scenario(JC.load_scenario_file(
        os.path.join(PORT_NAMES["SCENARIO_DIR"], "healthy.yaml")), run)
    assert ref.ok, ref.violations
    assert port and _segments(ref.trace_dir) == port


def _check_shard_kill(report, scenario, tmp_path):
    assert report.restarts_total >= 1
    iso = report.details["isolation"]
    assert len(iso) == 1  # exactly the one healthy shard
    for rec in iso.values():
        assert rec["worst_in_window"] <= rec["baseline"]
    assert report.details["replay_ticks"] == scenario.ticks


def _check_ecc_storm(report, scenario, tmp_path):
    events, lines = _replay(report)
    dbe = [e for e in events if e.etype.name == "ECC_DBE"]
    assert sorted(e.chip_index for e in dbe) == [0] * 5 + [1] * 3
    xid = [ln for ln in lines if ln.startswith("NVRM: Xid")]
    assert len(xid) == 8
    assert all(": 48, " in ln for ln in xid)
    assert {e.message for e in dbe} == set(xid)


def _check_ici_flap(report, scenario, tmp_path):
    events, lines = _replay(report)
    assert [(e.etype.name, e.chip_index) for e in events] == [
        ("ICI_ERROR", 0)]
    assert [ln for ln in lines if ln.startswith("NVRM: Xid")] == [
        events[0].message]
    assert ": 74, " in events[0].message


def _check_thermal(report, scenario, tmp_path):
    events, lines = _replay(report)
    assert [(e.etype.name, e.chip_index) for e in events] == [
        ("THERMAL", 0)]
    assert not [ln for ln in lines if not ln.startswith("tpumon-chaos:")]


EVIDENCE = {"healthy": _check_healthy,
            "shard-kill-mid-frame": _check_shard_kill,
            "ecc-storm": _check_ecc_storm,
            "ici-link-flap": _check_ici_flap,
            "thermal-throttle": _check_thermal}


@pytest.mark.parametrize("path", PORT_CORPUS,
                         ids=[os.path.basename(p) for p in PORT_CORPUS])
def test_port_scenario_runs_green(path, tmp_path, monkeypatch):
    run_on_port(REF_CHAOS, "test_scenario_runs_green", monkeypatch,
                names=PORT_NAMES, path=path, tmp_path=tmp_path)
    scenario = TC.load_scenario_file(path)
    with open(tmp_path / scenario.name / "report.json") as f:
        report = TC.ChaosReport(**json.load(f))
    check = EVIDENCE.get(scenario.name)
    if check is not None:
        check(report, scenario, tmp_path)


def test_every_scenario_is_run():
    assert len(PORT_CORPUS) == 8
    assert set(EVIDENCE) <= {os.path.basename(p)[:-5] for p in glob.glob(
        os.path.join(PORT_NAMES["SCENARIO_DIR"], "*.yaml"))}
