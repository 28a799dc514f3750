"""The port's lexical lint, ``python -m tpumon_torch.tools.tpumon_lint``.

* Every case of the JAX package's ``tests/test_lint.py`` runs on the
  port's tool (:func:`port_reference`): the reference module's source with
  its paths moved to the port's tree (``tpumon/`` -> ``tpumon_torch/``,
  ``native/`` -> ``tpumon_torch/native/``, ``tools.tpumon_lint`` ->
  ``tpumon_torch.tools.tpumon_lint``), executed as a module of its own, so
  each rule fires on its positive fixture and stays quiet on its negative
  one, and the repo-level cases (``test_repo_is_lint_clean``, the CLI
  cases) hold the port's tree.  A new reference case is picked up by
  itself; :data:`NOT_PORTED` names the few that pin what the port does
  differently, each with its reason and its port twin below.
* The port's own ``entrypoint-resolves`` (the ``python -m tpumon_torch.X``
  commands of ``deploy/gpu/`` and the README), the generated metrics doc,
  and the tools' own import discipline.
"""

from __future__ import annotations

import ast
import inspect
import os
import re
import subprocess
import sys
import types

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.join(REPO, "tests")
sys.path.insert(0, REPO)

from tpumon_torch.tools import gen_metrics_doc  # noqa: E402
from tpumon_torch.tools import tpumon_lint as TL  # noqa: E402

#: (pattern, replacement) applied in order to a reference test module's
#: source: the JAX package's tree becomes the port's
_TO_PORT = (
    (re.compile(r"\bfrom tools import\b"), "from tpumon_torch.tools import"),
    (re.compile(r"(?<![\w./-])tools([./])tpumon_"),
     r"tpumon_torch\1tools\1tpumon_"),
    (re.compile(r'\(REPO, "tools"'), '(REPO, "tpumon_torch", "tools"'),
    (re.compile(r"(?<![\w./-])native/"), "tpumon_torch/native/"),
    (re.compile(r"(?<![\w./-])docs/"), "tpumon_torch/docs/"),
    (re.compile(r'"tpumon"'), '"tpumon_torch"'),
    (re.compile(r"(?<![\w-])tpumon(?=[./])"), "tpumon_torch"),
)


def to_port(src: str) -> str:
    """A reference test module's source, pointed at the port's tree."""

    for pat, repl in _TO_PORT:
        src = pat.sub(repl, src)
    return src


_PORTED: dict = {}


def port_reference(name: str) -> types.ModuleType:
    """The JAX package's test module ``tests/<name>.py`` rewritten by
    :func:`to_port` and executed as a module of its own (once a process):
    its cases then call the port's tools on the port's tree."""

    if name not in _PORTED:
        path = os.path.join(TESTS, name + ".py")
        with open(path, encoding="utf-8") as f:
            src = to_port(f.read())
        mod = types.ModuleType("port_" + name)
        mod.__file__ = path
        exec(compile(src, path, "exec"), mod.__dict__)
        _PORTED[name] = mod
    return _PORTED[name]


def reference_cases(mod: types.ModuleType, not_ported: dict) -> list:
    names = sorted(n for n, v in vars(mod).items()
                   if n.startswith("test_") and callable(v))
    assert set(not_ported) <= set(names), set(not_ported) - set(names)
    return [n for n in names if n not in not_ported]


def run_case(mod: types.ModuleType, case: str, **fixtures) -> None:
    fn = getattr(mod, case)
    kwargs = {p: fixtures[p] for p in inspect.signature(fn).parameters}
    fn(**kwargs)


REF = port_reference("test_lint")

#: reference cases the port does not run, and why (each has a port twin)
NOT_PORTED = {
    # the port declares no console scripts: its entry points are the
    # ``python -m`` commands of deploy/gpu/ and the README (twins below)
    "test_entrypoint_positive_missing_module_and_missing_attr":
        "pyproject [project.scripts] entries",
    "test_entrypoint_negative_def_assign_import":
        "pyproject [project.scripts] entries",
    "test_repo_entrypoints_resolve": "pyproject [project.scripts] entries",
    # the types plane waits for mypy, on neither machine (ROADMAP.md)
    "test_mypy_strict_core_passes": "mypy --strict over the typed core",
}


@pytest.mark.parametrize("case", reference_cases(REF, NOT_PORTED))
def test_reference_lint_case_holds_on_the_port(case, tmp_path, monkeypatch,
                                                capsys):
    run_case(REF, case, tmp_path=tmp_path, monkeypatch=monkeypatch,
             capsys=capsys)


# -- entrypoint-resolves over the port's commands -------------------------------

def _entry_tree(tmp_path, files):
    for rel, text in files.items():
        p = tmp_path / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(text)
    return str(tmp_path)


_MAIN = "def main():\n    return 0\n\n\nif __name__ == \"__main__\":\n    main()\n"


def test_entrypoint_parses_shell_yaml_and_exec_forms():
    text = ("python -m tpumon_torch.cli.dmon -c 3\n"
            "args:\n  - -m\n  - tpumon_torch.exporter.main\n"
            'CMD ["python3", "-m", "tpumon_torch.cli.relay"]\n'
            "--metrics-port 9 -m 0755 tpumon_torch.not.a.command\n"
            "python -m tpumon_torch.<module>\n")
    assert TL.parse_module_commands(text) == [
        (1, "tpumon_torch.cli.dmon"), (4, "tpumon_torch.exporter.main"),
        (5, "tpumon_torch.cli.relay")]


def test_entrypoint_positive_missing_module_and_no_main(tmp_path):
    repo = _entry_tree(tmp_path, {
        "README.md": "python -m tpumon_torch.cli.gone\n",
        "deploy/gpu/k8s/a.yaml": "      args:\n        - -m\n"
                                 "        - tpumon_torch.cli.quiet\n",
        "tpumon_torch/__init__.py": "",
        "tpumon_torch/cli/__init__.py": "",
        "tpumon_torch/cli/quiet.py": "def main():\n    return 0\n"})
    out = TL.check_entrypoints(repo)
    assert [(f.path, f.line, f.rule) for f in out] == [
        ("README.md", 1, "entrypoint-resolves"),
        ("deploy/gpu/k8s/a.yaml", 3, "entrypoint-resolves")]
    assert "tpumon_torch.cli.gone" in out[0].message
    assert "__main__" in out[1].message


def test_entrypoint_negative_guard_and_package_main(tmp_path):
    repo = _entry_tree(tmp_path, {
        "README.md": "python -m tpumon_torch.cli.dmon\n"
                     "python -m tpumon_torch.tool\n",
        "deploy/gpu/bare-metal/x.service":
            "ExecStart=/usr/bin/python3 -m tpumon_torch.cli.dmon -c 1\n",
        "tpumon_torch/__init__.py": "",
        "tpumon_torch/cli/__init__.py": "",
        "tpumon_torch/cli/dmon.py": _MAIN,
        "tpumon_torch/tool/__init__.py": "",
        "tpumon_torch/tool/__main__.py": "print('ran')\n"})
    assert TL.check_entrypoints(repo) == []


def test_repo_entrypoints_resolve_on_the_port():
    assert TL.check_entrypoints(REPO) == []
    seen = {m for rel in TL.iter_entrypoint_docs(REPO)
            for _, m in TL.parse_module_commands(
                open(os.path.join(REPO, rel), encoding="utf-8",
                     errors="replace").read())}
    # the parser saw the deployment's and the README's commands
    for mod in ("tpumon_torch.exporter.main", "tpumon_torch.cli.relay",
                "tpumon_torch.exporter.pod_main",
                "tpumon_torch.tools.tpumon_lint",
                "tpumon_torch.tools.tpumon_check"):
        assert mod in seen, mod


# -- the port's own artifacts ---------------------------------------------------

def test_metrics_doc_is_generated_from_the_catalog():
    with open(os.path.join(REPO, TL.METRICS_DOC), encoding="utf-8") as f:
        assert f.read() == gen_metrics_doc.render()


def test_catalog_doc_sync_fires_on_a_stale_doc_row():
    snap = TL.load_catalog_snapshot(REPO)
    doc = gen_metrics_doc.render().replace("`tpu_core_temp`",
                                           "`tpu_core_temperature`", 1)
    out = TL.check_catalog_doc_sync(snap, doc)
    assert {f.rule for f in out} == {"catalog-doc-sync"}
    assert all(f.path == "tpumon_torch/docs/metrics.md" for f in out)


def test_file_walk_is_the_port_without_its_tools():
    files = list(TL.iter_python_files(REPO))
    assert "tpumon_torch/backends/nvml.py" in files
    assert "tpumon_torch/hostengine.py" in files
    assert not [f for f in files if not f.startswith("tpumon_torch/")]
    assert not [f for f in files if f.startswith("tpumon_torch/tools/")]


def _imports(path):
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and not node.level:
            yield node.module or ""


def test_tools_import_nothing_of_the_jax_package():
    tools = os.path.join(REPO, "tpumon_torch", "tools")
    names = [os.path.join(tools, f) for f in sorted(os.listdir(tools))
             if f.endswith(".py")]
    assert len(names) >= 4
    bad = [(os.path.basename(p), m) for p in names for m in _imports(p)
           if m.split(".")[0] in ("tpumon", "tools", "jax", "jaxlib")]
    assert bad == []


def test_cli_help_names_the_port_docs():
    r = subprocess.run([sys.executable, "-m", "tpumon_torch.tools.tpumon_lint",
                        "--help"], cwd=REPO, capture_output=True, text=True,
                       timeout=60)
    assert r.returncode == 0
    assert "tpumon_torch/docs/lint.md" in r.stdout
    assert os.path.isfile(os.path.join(REPO, "tpumon_torch", "docs",
                                       "lint.md"))
