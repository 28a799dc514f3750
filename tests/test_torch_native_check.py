"""The port's native analysis plane: ``python -m
tpumon_torch.tools.tpumon_check`` pass 7 over ``tpumon_torch/native/``.

* Every case of the JAX package's ``tests/test_native_check.py`` runs on
  the port's tool (:func:`test_torch_lint.port_reference`): one positive
  and one clean fixture per native rule family, the op-handler table and
  the GIL-region census of the port's codec extension.
* The port's twins of the repo-level cases: the native plane is clean,
  and exactly the port's reasoned pragmas keep it so (``gpu-hostengine``'s
  NVML source, the burst sampler, the poll engine's ``epfd_``), all of
  them in the baseline.
* Seeded regressions on copies of the real port files: a
  ``std::lock_guard`` added to the copied ``nvml_source.hpp`` sweep path
  fires ``native-effect-budget``, the ``engine.hpp`` pragma removed fires
  ``raii-lifetime``, and a lock in the codec core's encode fires the
  ``native-codec-steady`` budget.
"""

from __future__ import annotations

import collections
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
from tpumon_torch.tools import tpumon_check as TC  # noqa: E402

REF = port_reference("test_native_check")

NOT_PORTED = {
    # pin the reference's own pragma census (paths and counts of
    # native/agent/source.hpp's shim source, which the port has not);
    # twins: test_port_native_plane_is_clean, test_port_baseline_counts_
    # native_pragmas
    "test_real_repo_native_plane_is_clean": "the reference's pragma census",
    "test_baseline_counts_native_effect_ok_pragmas":
        "the reference's pragma census",
    # a wall-clock budget; twin: test_native_pass_process_time_budget
    "test_native_pass_runtime_budget": "wall-clock runtime budget",
}

NATIVE = "tpumon_torch/native/"


@pytest.fixture(scope="module")
def port_graph():
    return TC.build_graph(REPO)


@pytest.mark.parametrize("case", reference_cases(REF, NOT_PORTED))
def test_reference_native_case_holds_on_the_port(case, tmp_path):
    run_case(REF, case, tmp_path=tmp_path)


def test_port_native_plane_is_clean():
    assert TC.check_native(REPO) == []
    raw = TC.check_native(REPO, ignore_suppressions=True)
    by = collections.Counter((f.rule, f.path) for f in raw)
    assert set(by) == {
        ("native-effect-budget", NATIVE + "agent/nvml_source.hpp"),
        ("native-effect-budget", NATIVE + "agent/sampler.hpp"),
        ("native-effect-budget", NATIVE + "agent/source.hpp"),
        ("raii-lifetime", NATIVE + "poll/engine.hpp")}
    # the NVML source's sweep-path locks, each reached from both the
    # encode and the serve budget; none from the codec or poll budgets
    nvml = [f for f in raw if f.path.endswith("nvml_source.hpp")]
    assert {("native-sweep-encode" in f.message
             or "native-sweep-serve" in f.message) for f in nvml} == {True}
    assert not [f for f in raw if "native-codec-steady" in f.message
                or "native-poll-dispatch" in f.message]
    (lifetime,) = [f for f in raw if f.rule == "raii-lifetime"]
    assert "epfd_" in lifetime.message


def test_port_baseline_counts_native_pragmas(port_graph):
    with open(os.path.join(REPO, "tpumon_torch", "tools",
                           "check_baseline.json")) as f:
        base = json.load(f)
    native = [s for s in base["suppressions"]
              if str(s["path"]).startswith(NATIVE)]
    kinds = collections.Counter((s["path"][len(NATIVE):], s["kind"])
                                for s in native)
    assert kinds == {("agent/nvml_source.hpp", "effect-ok"): 10,
                     ("agent/sampler.hpp", "effect-ok"): 3,
                     ("agent/source.hpp", "effect-ok"): 2,
                     ("poll/engine.hpp", "close-ok"): 1}
    inv = TC.suppression_inventory(port_graph)
    assert TC.baseline_diff([], inv, base) == []
    pruned = {"findings": base["findings"],
              "suppressions": [s for s in base["suppressions"]
                               if not str(s["path"]).endswith(
                                   "nvml_source.hpp")]}
    diffs = TC.baseline_diff([], inv, pruned)
    assert any("new effect-ok suppression" in d and "nvml_source.hpp" in d
               for d in diffs)


def test_native_pass_process_time_budget():
    """A cold native index and all four rule families cost at most 10 s of
    CPU time: about thirty times the 0.3 s they take on one current x86
    core."""

    TC._NATIVE_INDEX_CACHE.clear()
    t0 = time.process_time()
    TC.check_native(REPO)
    assert time.process_time() - t0 < 10.0


# -- seeded regressions on copies of real port files ----------------------------

def _native_copy(tmp_path):
    shutil.copytree(os.path.join(REPO, "tpumon_torch", "native"),
                    tmp_path / "tpumon_torch" / "native",
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    return str(tmp_path)


def test_copied_native_tree_is_clean(tmp_path):
    assert TC.check_native(_native_copy(tmp_path)) == []


def test_seeded_lock_on_the_nvml_sweep_path_fires(tmp_path):
    repo = _native_copy(tmp_path)
    path = tmp_path / "tpumon_torch" / "native" / "agent" / "nvml_source.hpp"
    src = path.read_text()
    # the sweep reads every field through read_fields_at: a lock there is
    # on gpu-hostengine's serve and encode path
    sig = src.index("  int read_fields_at(")
    body = src.index("{\n", sig) + 2
    path.write_text(src[:body]
                    + "    std::lock_guard<std::mutex> seeded(state_mu_);\n"
                    + src[body:])
    line = src[:body].count("\n") + 1
    out = TC.check_native(repo)
    assert {(f.path, f.line, f.rule) for f in out} == {
        (NATIVE + "agent/nvml_source.hpp", line, "native-effect-budget")}
    assert {m for f in out for m in ("native-sweep-encode",
                                     "native-sweep-serve")
            if m in f.message} == {"native-sweep-encode",
                                   "native-sweep-serve"}


def test_seeded_engine_pragma_removal_fires_raii_lifetime(tmp_path):
    repo = _native_copy(tmp_path)
    path = tmp_path / "tpumon_torch" / "native" / "poll" / "engine.hpp"
    src = path.read_text()
    lines = [ln for ln in src.split("\n") if "tpumon: close-ok(epfd_" in ln]
    assert len(lines) == 1
    path.write_text(src.replace(lines[0] + "\n", ""))
    out = TC.check_native(repo)
    assert [(f.path, f.rule) for f in out] == [
        (NATIVE + "poll/engine.hpp", "raii-lifetime")]
    assert "epfd_" in out[0].message


def test_seeded_lock_in_the_codec_encode_fires(tmp_path):
    repo = _native_copy(tmp_path)
    path = tmp_path / "tpumon_torch" / "native" / "codec" / "core.hpp"
    src = path.read_text()
    enc = src.index("  void encode(", src.index("class EncoderCore"))
    body = src.index("{\n", enc) + 2
    path.write_text(src[:body]
                    + "    std::lock_guard<std::mutex> seeded(mu_);\n"
                    + src[body:])
    out = TC.check_native(repo)
    assert [(f.path, f.rule) for f in out] == [
        (NATIVE + "codec/core.hpp", "native-effect-budget")]
    assert "native-codec-steady" in out[0].message


def test_seeded_lock_reason_needs_a_reason(tmp_path):
    """An empty effect-ok pragma suppresses nothing: the budget still
    fires at the NVML source's lock."""

    repo = _native_copy(tmp_path)
    path = tmp_path / "tpumon_torch" / "native" / "agent" / "nvml_source.hpp"
    src = path.read_text()
    first = next(ln for ln in src.split("\n")
                 if "tpumon: effect-ok(bounded memo lock" in ln)
    path.write_text(src.replace(first, first[:first.index("effect-ok(")]
                                + "effect-ok()", 1))
    out = TC.check_native(repo)
    assert out and {(f.path, f.rule) for f in out} == {
        (NATIVE + "agent/nvml_source.hpp", "native-effect-budget")}
