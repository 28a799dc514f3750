"""The port's whole-program check, ``python -m
tpumon_torch.tools.tpumon_check`` (passes 1-6 here, pass 7 in
``test_torch_native_check.py``).

* Every case of the JAX package's ``tests/test_check.py`` runs on the
  port's tool (:func:`test_torch_lint.port_reference`): each rule fires on
  its positive fixture and stays quiet on its negative one, and the
  repo-level cases hold the port's tree clean, its manifests resolved and
  ``tpumon_torch/tools/check_baseline.json`` current.  The legacy-scope
  parity case runs against the port's own list of legacy-only sites
  (:data:`PORT_LEGACY_ONLY_SITES`).  :data:`NOT_PORTED` names the cases
  the port replaces, each with its reason and its twin below.
* The port's own: every thread the port spawns is declared, every
  manifest root resolves, seeded regressions on copies of real port files,
  the built codec's constant pins, the disable-pragma inventory, and the
  two faults the check found and this tree repairs — ``NvmlBackend.close``
  stops and joins its event thread and shuts NVML down even when the kmsg
  watcher's stop raises, and the agent's ``open_source`` closes the NVML
  backend it opened when the device count raises — both over the fake
  NVML.

The port's graph is built once for this module (:func:`port_graph`), and
``build_graph`` hands it to every case that asks for the repo's.
"""

from __future__ import annotations

import json
import os
import shutil
import sys
import time

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from test_torch_lint import (port_reference, reference_cases,  # noqa: E402
                             run_case)
from test_torch_nvml import (_short_event_waits, fake, fake_lib,  # noqa: E402,F401
                             kmsg)
from tpumon_torch.backends import nvml as N  # noqa: E402
from tpumon_torch.tools import tpumon_check as TC  # noqa: E402

REF = port_reference("test_check")
#: the graph builder itself, whatever a test patches in its place
BUILD_GRAPH = TC.build_graph

NOT_PORTED = {
    # a wall-clock budget fails under the 6-worker run; the port measures
    # process time instead (test_full_run_process_time_budget)
    "test_repo_runtime_budget": "wall-clock runtime budget",
    # pins the JAX package's golden file byte for byte (its paths and
    # documentation link); twin: test_sarif_matches_the_reference_golden
    "test_sarif_golden": "the reference's SARIF golden bytes",
}

#: the port's legacy-rule sites that no hot root reaches, each the twin of
#: an entry of the reference's list (the retained legacy scope covers
#: them), plus the NVML event thread's Xid timestamp — a wall-clock event
#: timestamp on the ``nvmlevent`` thread, which no hot root calls into
PORT_LEGACY_ONLY_SITES = {
    "hot-wallclock": {("tpumon_torch/backends/base.py", 211),
                      ("tpumon_torch/backends/nvml.py", 784),
                      ("tpumon_torch/cli/replay.py", 253),
                      ("tpumon_torch/cli/replay.py", 435),
                      ("tpumon_torch/kmsg.py", 287)},
    "hot-encode": {("tpumon_torch/exporter/promtext.py", 439),
                   ("tpumon_torch/frameserver.py", 988),
                   ("tpumon_torch/frameserver.py", 1112),
                   ("tpumon_torch/frameserver.py", 1113),
                   ("tpumon_torch/frameserver.py", 1121),
                   ("tpumon_torch/relay.py", 316)},
    "hot-json": {("tpumon_torch/frameserver.py", 579),
                 ("tpumon_torch/frameserver.py", 1119),
                 ("tpumon_torch/relay.py", 316),
                 ("tpumon_torch/fleetpoll.py", 1269),
                 ("tpumon_torch/fleetpoll.py", 1273)},
    "hot-fsync": {("tpumon_torch/blackbox.py", 304)},
    "hot-blocking-socket": {("tpumon_torch/frameserver.py", 476)},
}


@pytest.fixture(scope="module")
def port_graph():
    return TC.build_graph(REPO)


@pytest.fixture(autouse=True)
def _one_graph(port_graph, monkeypatch):
    """Every ``build_graph`` of the repo in this module returns the one
    graph the module built (the passes only read it)."""

    def cached(repo):
        if os.path.realpath(repo) == os.path.realpath(REPO):
            return port_graph
        return BUILD_GRAPH(repo)

    monkeypatch.setattr(TC, "build_graph", cached)


@pytest.mark.parametrize("case", reference_cases(REF, NOT_PORTED))
def test_reference_check_case_holds_on_the_port(case, tmp_path, monkeypatch):
    monkeypatch.setattr(REF, "_LEGACY_ONLY_SITES", PORT_LEGACY_ONLY_SITES)
    run_case(REF, case, tmp_path=tmp_path, monkeypatch=monkeypatch)


def test_sarif_matches_the_reference_golden():
    """The port's SARIF is the reference's document: the reference's
    golden file with the paths moved to the port's tree and the port's
    rule table and documentation link."""

    findings = [
        TC.Finding("tpumon_torch/a.py", 7, "hot-json",
                   "json.dumps() in the hot path (reachable from "
                   "tpumon_torch/a.py::Poller.poll): use the wire codec"),
        TC.Finding("tpumon_torch/native/agent/protocol.md", 0,
                   "wire-constant-sync",
                   "daemon dispatches op 'probe' but the protocol "
                   "table does not document it"),
    ]
    with open(os.path.join(REPO, "tests", "data",
                           "check_sarif_golden.sarif")) as f:
        golden = json.load(f)
    run = golden["runs"][0]
    for res in run["results"]:
        loc = res["locations"][0]["physicalLocation"]["artifactLocation"]
        loc["uri"] = ("tpumon_torch/native/" + loc["uri"][len("native/"):]
                      if loc["uri"].startswith("native/")
                      else "tpumon_torch/" + loc["uri"][len("tpumon/"):])
        res["message"]["text"] = res["message"]["text"].replace(
            "tpumon/a.py", "tpumon_torch/a.py")
    driver = run["tool"]["driver"]
    assert [r["id"] for r in driver["rules"]] == sorted(TC.RULES)
    driver["rules"] = [{"id": k, "shortDescription": {"text": v}}
                       for k, v in sorted(TC.RULES.items())]
    driver["informationUri"] = driver["informationUri"].replace(
        "/main/docs/", "/main/tpumon_torch/docs/")
    assert TC.to_sarif(findings) == golden


def test_full_run_process_time_budget():
    """A cold whole run (graph, all seven passes, inventory) costs at most
    60 s of this process's CPU time: about ten times the 5-6 s it takes
    on one current x86 core, so a slower runner passes and a pass gone
    quadratic does not."""

    t0 = time.process_time()
    g = BUILD_GRAPH(REPO)
    assert TC.run_repo(REPO, graph=g) == []
    TC.suppression_inventory(g)
    assert time.process_time() - t0 < 60.0


# -- the port's threads and manifests -------------------------------------------

def test_every_port_thread_spawn_is_declared(port_graph):
    declared = {r for roots in TC.THREAD_ROOTS.values() for r in roots}
    spawns = [(q, line, targets) for q, fi in port_graph.funcs.items()
              for line, targets in fi.thread_spawns]
    # every Thread(target=<port function>) of the port, the port's own
    # threads among them
    targets = {t for _, _, ts in spawns for t in ts}
    for own in ("tpumon_torch/backends/nvml.py::NvmlBackend._event_loop",
                "tpumon_torch/trace.py::TraceEngine._parse",
                "tpumon_torch/burst.py::BurstSampler._run",
                "tpumon_torch/watch.py::WatchManager._run"):
        assert own in targets, own
    undeclared = [(q, line) for q, line, ts in spawns
                  if not set(ts) & declared]
    assert undeclared == []
    assert not [f for f in TC.check_threads(port_graph)
                if f.rule.startswith("thread-root")]


def test_every_manifest_root_resolves(port_graph):
    for manifest in (TC.HOT_ROOTS, TC.THREAD_ROOTS):
        for group, roots in manifest.items():
            for r in roots:
                assert r in port_graph.funcs, (group, r)
    for name, spec in TC.EFFECT_BUDGETS.items():
        for r in spec["roots"]:
            assert r in port_graph.funcs, (name, r)
    idx = TC.build_native_index(REPO)
    for name, spec in TC.NATIVE_EFFECT_BUDGETS.items():
        for r in spec["roots"]:
            assert TC._cc_resolve_root(idx, r), (name, r)
    # the port's roots, not the reference's renamed
    assert "loadcap" in TC.THREAD_ROOTS and "xplane" not in TC.THREAD_ROOTS
    assert TC.THREAD_ROOTS["trace"] == [
        "tpumon_torch/trace.py::TraceEngine._parse"]


# -- seeded regressions on copies of real port files ----------------------------

def _copy(tmp_path, *rels):
    for rel in rels:
        dst = tmp_path / rel
        dst.parent.mkdir(parents=True, exist_ok=True)
        shutil.copy(os.path.join(REPO, rel), dst)
    (tmp_path / "tpumon_torch" / "__init__.py").touch()
    return str(tmp_path)


def test_seeded_non_aggregating_nvml_close_fires(tmp_path):
    repo = _copy(tmp_path, "tpumon_torch/backends/nvml.py")
    assert [f for f in TC.run_repo(repo, passes=("lifetime",), manifest={})
            if f.rule == "close-not-aggregating"] == []
    path = tmp_path / "tpumon_torch" / "backends" / "nvml.py"
    src = path.read_text()
    start = src.index("    def close(self) -> None:")
    end = src.index("        self._event_set = None", start)
    path.write_text(src[:start] + '''    def close(self) -> None:
        if self._kmsg is not None:
            self._kmsg.stop()
            self._kmsg = None
        self._event_stop.set()
        th = self._event_thread
        if th is not None:
            th.join(timeout=5.0)
            self._event_thread = None
        if self._opened:
            self._fn["nvmlShutdown"]()
''' + src[end:])
    out = [f for f in TC.run_repo(repo, passes=("lifetime",), manifest={})
           if f.rule == "close-not-aggregating"]
    assert [(f.path, f.rule) for f in out] == [
        ("tpumon_torch/backends/nvml.py", "close-not-aggregating")]
    assert "self._kmsg.stop()" in out[0].message


def test_seeded_undeclared_thread_in_a_port_file_fires(tmp_path):
    repo = _copy(tmp_path, "tpumon_torch/kmsg.py")
    path = tmp_path / "tpumon_torch" / "kmsg.py"
    path.write_text(path.read_text() + '''

class _Seeded:
    def start(self):
        threading.Thread(target=self._work, daemon=True).start()

    def _work(self):
        pass
''')
    out = TC.run_repo(repo, passes=("threads",))
    assert [(f.path, f.rule) for f in out
            if f.rule == "thread-root-undeclared"] == [
        ("tpumon_torch/kmsg.py", "thread-root-undeclared")]


def test_seeded_sleep_under_the_agent_harvest_lock_fires(tmp_path):
    repo = _copy(tmp_path, "tpumon_torch/hostengine.py")
    path = tmp_path / "tpumon_torch" / "hostengine.py"
    src = path.read_text()
    anchor = "            with self._harvest_lock:\n"
    assert anchor in src
    path.write_text(src.replace(
        anchor, anchor + "                time.sleep(0.5)\n", 1))
    out = [f for f in TC.run_repo(repo, passes=("locks",), manifest={})
           if f.rule == "blocking-while-locked"]
    assert [(f.path, "_harvest_lock" in f.message) for f in out] == [
        ("tpumon_torch/hostengine.py", True)]


# -- pass 4: the built codec's exported constants -------------------------------

def _declared_codec_constants():
    from tpumon_torch import fields as FF
    from tpumon_torch import sweepframe as SF

    consts = {"SWEEP_REQ_MAGIC": SF.SWEEP_REQ_MAGIC,
              "SWEEP_FRAME_MAGIC": SF.SWEEP_FRAME_MAGIC,
              "BURST_ID_BASE": FF.BURST_ID_BASE,
              "NUM_INT_LIMIT": SF.NUM_INT_LIMIT}
    consts.update({f"{k.upper()}_FIELD_{n.upper()}": v
                   for (k, n), v in TC._CODEC_FIELD_LAYOUT.items()})
    return consts


def test_built_codec_constants_agree():
    assert TC.check_protocol_sync(
        REPO, codec_constants=_declared_codec_constants()) == []
    built = TC.built_codec_constants(REPO)
    if built is not None:       # this checkout has the extension built
        assert TC.check_protocol_sync(REPO, codec_constants=built) == []


@pytest.mark.parametrize("name,value", [("SWEEP_FRAME_MAGIC", 0xAA),
                                        ("BURST_ID_BASE", 3000),
                                        ("VALUE_FIELD_VEC", 9)])
def test_built_codec_constant_drift_fires(name, value):
    consts = _declared_codec_constants()
    consts[name] = value
    out = TC.check_protocol_sync(REPO, codec_constants=consts)
    assert [(f.path, f.rule) for f in out] == [
        ("tpumon_torch/native/codec/module.cc", "wire-constant-sync")]
    assert name in out[0].message


def test_seeded_varint_cap_drift_fires(tmp_path):
    """Pass 4 holds the agent's request reader (wire.hpp) to the Python
    walker (wire.py): a cap raised on one side is drift."""

    shutil.copytree(os.path.join(REPO, "tpumon_torch"),
                    tmp_path / "tpumon_torch",
                    ignore=shutil.ignore_patterns("__pycache__", "csrc"))
    repo = str(tmp_path)
    assert TC.check_protocol_sync(repo, codec_constants={}) == []
    hpp = tmp_path / "tpumon_torch" / "native" / "agent" / "wire.hpp"
    src = hpp.read_text()
    assert src.count("pos_ - start >= 10") == 1
    hpp.write_text(src.replace("pos_ - start >= 10", "pos_ - start >= 12"))
    out = TC.check_protocol_sync(repo, codec_constants={})
    assert [(f.path, f.rule) for f in out] == [
        ("tpumon_torch/native/agent/wire.hpp", "wire-constant-sync")]
    assert "12 bytes" in out[0].message and "wire.py at 10" in out[0].message


# -- the pragma inventory --------------------------------------------------------

def test_disable_pragmas_are_inventoried_and_counted(tmp_path):
    repo = _copy(tmp_path, "tpumon_torch/_build.py")
    g = BUILD_GRAPH(repo)
    inv = TC.suppression_inventory(g)
    mine = [s for s in inv if s["path"] == "tpumon_torch/_build.py"
            and s["kind"] == "check-disable"]
    assert [s["reason"] for s in mine] == ["blocking-while-locked"]
    base = {"findings": [], "suppressions": inv}
    assert TC.baseline_diff([], inv, base) == []
    # a copy-pasted disable pragma is drift, like a reasoned one
    doubled = inv + [dict(mine[0], line=1)]
    diffs = TC.baseline_diff([], doubled, base)
    assert diffs == ["new check-disable suppression not in baseline: "
                     "tpumon_torch/_build.py: (blocking-while-locked)"]


def test_port_baseline_counts_every_kind():
    with open(os.path.join(REPO, "tpumon_torch", "tools",
                           "check_baseline.json")) as f:
        base = json.load(f)
    assert base["findings"] == []
    kinds = {s["kind"] for s in base["suppressions"]}
    assert kinds == set(TC.INVENTORY_KINDS)
    assert all(s["path"].startswith("tpumon_torch/")
               for s in base["suppressions"])
    assert all(s["reason"] for s in base["suppressions"])


# -- the repaired faults, over the fake NVML -------------------------------------

def test_nvml_close_stops_the_event_thread_when_kmsg_stop_raises(fake):
    b = N.NvmlBackend()
    b.open()
    th, watcher = b._event_thread, b._kmsg
    assert th is not None and th.is_alive() and watcher is not None
    stop = watcher.stop

    def failing_stop():
        stop()
        raise RuntimeError("kmsg watcher stop failed")

    watcher.stop = failing_stop
    shutdowns = fake.fake_nvml_shutdowns()
    with pytest.raises(RuntimeError, match="kmsg watcher stop failed"):
        b.close()
    assert not th.is_alive()
    assert b._event_thread is None and b._kmsg is None
    assert fake.fake_nvml_shutdowns() == shutdowns + 1
    b.close()   # idempotent after a failed close


def test_agent_open_source_closes_nvml_when_the_count_raises(fake,
                                                             monkeypatch):
    from tpumon_torch import hostengine
    from tpumon_torch.backends.base import ChipNotFound

    opened = []
    real_open = N.NvmlBackend.open

    def spy_open(self):
        opened.append(self)
        real_open(self)

    def lost(self):
        raise ChipNotFound("device 0 lost while counting")

    monkeypatch.setattr(N.NvmlBackend, "open", spy_open)
    monkeypatch.setattr(N.NvmlBackend, "chip_count", lost)
    shutdowns = fake.fake_nvml_shutdowns()
    with pytest.raises(ChipNotFound):
        hostengine.open_source(False)
    (b,) = opened
    assert b._event_thread is None and b._kmsg is None
    assert fake.fake_nvml_shutdowns() == shutdowns + 1
