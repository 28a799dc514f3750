"""The port's chaos harness (``tpumon_torch.chaos``, ``tpumon_torch.cli.chaos``)
against the JAX package's, on the CPU.

* The reference's own cases (``tests/test_chaos.py``: parser scalars,
  nesting and refusals, the corpus reading identically under PyYAML,
  ``validate`` over the corpus, bad scenarios refused with the same
  messages, ``samples_equal``, deterministic trace timestamps, the
  SIGKILLed recording fleet process, a failed invariant failing the run,
  the relay invariant red on an unhealed partition, the CLI) run case for
  case on the port (:func:`test_torch_fleet.run_on_port`), over the port's
  corpus ``tests/data/torch_scenarios/``.  Their bars hold unchanged.  The
  corpus scenarios themselves run in ``test_torch_chaos_corpus.py``.
* The corpus: five files byte-identical to the reference's, three that
  differ only in comments, ``description`` and ``expect.markers``.
* The kernel-log faults: the reference's ``ecc-storm.yaml`` goes red under
  the port on its TPU marker alone (the port's Xid 48 lines still classify
  ``ECC_DBE``), which is why the port's corpus differs.
* The CLI exits non-zero on a red scenario, in its own process.
* Imports: ``tpumon_torch.chaos`` and ``tpumon_torch.cli.chaos`` load no
  ``tpumon``, ``jax`` or ``torch``.
"""

import glob
import os
import subprocess
import sys

import pytest

import test_chaos as REF_CHAOS
from test_torch_agent import agent_env
from test_torch_fleet import reference_cases, run_on_port
from test_torch_fleetshard import import_guard
from tpumon_torch import chaos as TC
from tpumon_torch.simple_yaml import _strip_comment

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_DIR = os.path.join(REPO, "tests", "data", "scenarios")
PORT_DIR = os.path.join(REPO, "tests", "data", "torch_scenarios")
PORT_CORPUS = sorted(glob.glob(os.path.join(PORT_DIR, "*.yaml")))
#: the scenarios with no kernel-log action: the same file in both corpora
SHARED = ("healthy.yaml", "preemption-wave.yaml", "relay-kill.yaml",
          "relay-partition.yaml", "shard-kill-mid-frame.yaml")
#: the scenarios whose kernel lines are the NVIDIA driver's in the port
XID = ("ecc-storm.yaml", "ici-link-flap.yaml", "thermal-throttle.yaml")

#: the reference's cases that run the corpus, in the corpus file
CORPUS_CASES = ("test_scenario_runs_green",
                "test_shard_kill_scenario_actually_restarts_and_isolates")
CASES = reference_cases(REF_CHAOS, CORPUS_CASES)
#: the reference module's globals that name its corpus -> the port's
PORT_NAMES = {"SCENARIO_DIR": PORT_DIR, "CORPUS": PORT_CORPUS}


@pytest.mark.parametrize("case", [c for c in CASES if c !=
                                  "test_corpus_parses_identically_under_pyyaml"])
def test_reference_chaos_case_holds_on_the_port(case, tmp_path, capsys,
                                                monkeypatch):
    run_on_port(REF_CHAOS, case, monkeypatch, names=PORT_NAMES,
                tmp_path=tmp_path, capsys=capsys)


@pytest.mark.parametrize("path", PORT_CORPUS,
                         ids=[os.path.basename(p) for p in PORT_CORPUS])
def test_port_corpus_parses_identically_under_pyyaml(path, monkeypatch):
    run_on_port(REF_CHAOS, "test_corpus_parses_identically_under_pyyaml",
                monkeypatch, names=PORT_NAMES, path=path)


# -- the corpus ----------------------------------------------------------------

def test_corpus_is_the_reference_s_with_the_driver_s_kernel_lines():
    assert sorted(os.path.basename(p) for p in PORT_CORPUS) == sorted(
        os.path.basename(p) for p in glob.glob(os.path.join(REF_DIR,
                                                            "*.yaml")))
    assert sorted(SHARED + XID) == [os.path.basename(p) for p in PORT_CORPUS]
    for name in SHARED:
        with open(os.path.join(REF_DIR, name), "rb") as a, \
                open(os.path.join(PORT_DIR, name), "rb") as b:
            assert a.read() == b.read(), name

    def kept(path):
        """The file's lines without comments, ``description`` and
        ``markers``, and its tree without those two keys."""

        with open(path) as f:
            text = f.read()
        lines = [_strip_comment(ln) for ln in text.splitlines()]
        lines = [ln for ln in lines if ln.strip() and not ln.lstrip()
                 .startswith(("description:", "markers:"))]
        tree = TC.parse_simple_yaml(text)
        tree.pop("description")
        tree["expect"].pop("markers")
        return lines, tree

    for name in XID:
        ref, port = (kept(os.path.join(d, name)) for d in (REF_DIR, PORT_DIR))
        assert ref == port, name
        assert (TC.load_scenario_file(os.path.join(PORT_DIR, name))
                .expect_markers != TC.load_scenario_file(
                    os.path.join(REF_DIR, name)).expect_markers), name


def test_port_markers_name_no_tpu_kernel_line():
    markers = {os.path.basename(p): TC.load_scenario_file(p).expect_markers
               for p in PORT_CORPUS}
    assert markers["ecc-storm.yaml"] == [
        "kmsg:DBE (Double Bit Error) ECC Error", "event:ECC_DBE"]
    assert markers["ici-link-flap.yaml"] == ["kmsg:NVLink Error",
                                             "event:ICI_ERROR"]
    assert markers["thermal-throttle.yaml"] == ["event:THERMAL"]


def test_reference_ecc_storm_is_red_on_its_tpu_marker_only(tmp_path):
    """The reference's file under the port: the Xid 48 lines classify
    ECC_DBE (that marker holds), and only the TPU driver's prose
    (``kmsg:Uncorrectable``) is absent."""

    scenario = TC.load_scenario_file(os.path.join(REF_DIR, "ecc-storm.yaml"))
    report = TC.run_scenario(scenario, str(tmp_path / "run"))
    assert not report.ok
    assert report.violations == [
        "replay: marker 'kmsg:Uncorrectable' absent from the fault window"]


# -- the CLI in its own process -----------------------------------------------

RED = """\
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


def test_cli_exits_nonzero_on_a_red_scenario(tmp_path):
    path = tmp_path / "goes-red.yaml"
    path.write_text(RED)
    r = subprocess.run(
        [sys.executable, "-m", "tpumon_torch.cli.chaos", "run", str(path),
         "--out", str(tmp_path / "art"), "--json"],
        capture_output=True, text=True, cwd=REPO, timeout=120,
        env=agent_env())
    assert r.returncode == 1, r.stderr[-2000:]
    assert '"ok": false' in r.stdout
    assert "0/1 scenario(s) passed" in r.stderr


def test_chaos_modules_import_neither_tpumon_jax_nor_torch():
    r = subprocess.run(
        [sys.executable, "-c",
         "import sys, tpumon_torch.chaos, tpumon_torch.cli.chaos; "
         "print(sorted(m for m in sys.modules "
         "if m.split('.')[0] in ('tpumon', 'jax', 'jaxlib', 'torch')))"],
        capture_output=True, text=True, cwd=REPO, timeout=60,
        env=agent_env())
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[]"


def test_spawned_children_run_the_port_under_an_import_guard(tmp_path,
                                                            monkeypatch):
    """The relay chain and the recording fleet process are the port's
    modules: they run under a guard that refuses ``tpumon``, ``jax`` and
    ``torch``, and the scenario is green with nothing refused."""

    refused = import_guard(tmp_path, monkeypatch)
    scenario = TC.Scenario.from_dict({
        "name": "children", "seed": 11,
        "topology": {"hosts": 2, "chips": 1, "relays": 1,
                     "subscribers": 1},
        "ticks": 10, "tick_interval_s": 0.1, "converge_within": 6,
        "actions": [{"at": 1, "do": "spawn_recorder", "delay_s": 0.05},
                    {"at": 3, "do": "churn", "mutations": 2},
                    {"at": 5, "do": "kill_relay", "relay": 0},
                    {"at": 6, "do": "restart_relay", "relay": 0},
                    {"at": 7, "do": "kill_recorder"}],
        "invariants": {"replay_fault_window": False},
    })
    harness_argv = []
    real = TC.spawn_logged_child

    def spawn(argv, log_path):
        harness_argv.append(list(argv))
        return real(argv, log_path)

    monkeypatch.setattr(TC, "spawn_logged_child", spawn)
    report = TC.run_scenario(scenario, str(tmp_path / "run"))
    assert report.ok, report.violations
    assert [a[2] for a in harness_argv] == [
        "tpumon_torch.cli.relay", "tpumon_torch.cli.fleet",
        "tpumon_torch.cli.relay"]
    assert refused.read_text() == ""
    assert os.listdir(tmp_path / "run" / "recorder-bb")
