"""The port's deployment files (``deploy/gpu/``) on the CPU.

For every file under ``deploy/gpu/``:

* each YAML document reads alike under the port's loader
  (``tpumon_torch.simple_yaml``) and PyYAML, in block style only (the
  card's machine has no PyYAML; ``simple_yaml`` reads a flow mapping as a
  string);
* each container, service, image and unit command is ``python -m`` a
  ``tpumon_torch`` module with a ``main``, whose argument parser accepts
  the command's arguments (parsed only: ``main`` stops there), or the
  port's native agent ``gpu-hostengine``, whose usage names every flag
  its arguments give;
* no container requests ``nvidia.com/gpu``; no image or install
  installs a package by pip or builds CUDA code, and the only native
  code built is ``gpu-hostengine`` from the port's sources (by
  ``python -m tpumon_torch._build --native``), in the images' build
  stages and the bare-metal install;
* each memory limit is at or above the RSS measured on the card for what
  the command runs (MEASURED_RSS_MIB), and every process that opens NVML
  has a limit of at least 256 MiB.

And the families: ``tpumon-daemonset.yaml``'s agent and exporter and
``tpumon-agent-daemonset.yaml``'s agent, started as the smoke's ``deploy``
leg starts them (``chip_smoke.deploy_phase``) over the fake NVML, serve
every family that the reused dashboard and alert rules query, except those
``deploy/gpu/README.md`` lists as served by the workload's self-monitor or
as blank on the H100 (the smoke pins both lists on the card).
"""

import argparse
import glob
import importlib
import importlib.util
import json
import os
import re
import shlex
import shutil
import subprocess
import tempfile
import threading
import time

import pytest

from test_torch_nvml import _build
from tpumon_torch.simple_yaml import parse_simple_yaml

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEPLOY = os.path.join(REPO, "deploy", "gpu")
FILES = sorted(p for p in glob.glob(os.path.join(DEPLOY, "**", "*"),
                                    recursive=True) if os.path.isfile(p))
YAML_FILES = [p for p in FILES if p.endswith((".yaml", ".yml"))]
IDS = {p: os.path.relpath(p, DEPLOY) for p in FILES}

#: the most RSS measured on an NVIDIA H100 80GB HBM3 at 700 W for each
#: process a command runs, MiB (PERF.md: the smoke's agent:, native
#: agent:, daemon:, relay: and deploy: legs); an exporter's entry is by
#: its source: NVML itself, the agent it connects to, or the agent it
#: starts (``gpu-hostengine``: both processes then)
MEASURED_RSS_MIB = {
    "tpumon_torch.hostengine": 152.0,
    "gpu-hostengine": 128.9,
    "tpumon_torch.exporter.main nvml": 157.0,
    "tpumon_torch.exporter.main --connect": 39.7,
    "tpumon_torch.exporter.main --start-agent": 128.9 + 39.7,
    "tpumon_torch.cli.relay": 41.3,
}
#: what opens NVML, and the least limit it gets
NVML_OPENERS = ("tpumon_torch.hostengine", "gpu-hostengine",
                "tpumon_torch.exporter.main nvml",
                "tpumon_torch.exporter.main --start-agent")
NVML_MIN_MIB = 256.0


def _smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SMOKE = _smoke()


def _docs(path):
    with open(path) as f:
        return f.read().split("\n---\n")


def _dockerfile(name):
    """(ENTRYPOINT, CMD) of one of ``deploy/gpu/docker``'s Dockerfiles."""

    out = {"ENTRYPOINT": [], "CMD": []}
    with open(os.path.join(DEPLOY, "docker", name)) as f:
        for line in f:
            word, _, rest = line.strip().partition(" ")
            if word in out:
                out[word] = json.loads(rest)
    return out["ENTRYPOINT"], out["CMD"]


def _expand(args, env):
    return [re.sub(r"\$\((\w+)\)", lambda m: env[m.group(1)], str(a))
            for a in args]


def commands(path):
    """(where, argv, memory limit MiB or None) of every process a file
    starts."""

    name = os.path.basename(path)
    out = []
    if name == "docker-compose.yml":
        (doc,) = [parse_simple_yaml(d) for d in _docs(path)]
        for svc, spec in doc["services"].items():
            build = spec.get("build")
            if not build:
                continue
            entry, cmd = _dockerfile(os.path.basename(build["dockerfile"]))
            lim = spec.get("mem_limit")
            out.append((svc, entry + list(spec.get("command", cmd)),
                        float(lim[:-1]) if lim else None))
    elif path.endswith((".yaml", ".yml")):
        for doc in (parse_simple_yaml(d) for d in _docs(path)):
            pod = doc.get("spec", {}).get("template", {}).get("spec", {})
            for c in pod.get("containers", []):
                env = {e["name"]: e.get("value", "") for e in c.get("env", [])}
                lim = c.get("resources", {}).get("limits", {}).get("memory")
                out.append((c["name"], _expand(
                    c.get("command", []) + c.get("args", []), env),
                    SMOKE.k8s_quantity(lim, False) / 1024 if lim else None))
    elif name.startswith("Dockerfile"):
        entry, cmd = _dockerfile(name)
        out.append((name, entry + cmd, None))
    elif name.endswith(".service"):
        lim = None
        with open(path) as f:
            for line in f:
                key, _, val = line.strip().partition("=")
                if key == "ExecStart":
                    argv = shlex.split(val)
                elif key == "MemoryMax":
                    assert val.endswith("M"), val
                    lim = float(val[:-1])
        out.append((name, argv, lim))
    return out


COMMAND_FILES = [p for p in FILES if commands(p)]


def kind(argv):
    """MEASURED_RSS_MIB's key for what a command runs."""

    if os.path.basename(argv[0]) == "gpu-hostengine":
        return "gpu-hostengine"
    mod = argv[2]
    if mod != "tpumon_torch.exporter.main":
        return mod
    for flag in ("--connect", "--start-agent"):
        if any(a == flag or a.startswith(flag + "=") for a in argv):
            return f"{mod} {flag}"
    return f"{mod} nvml"


# -- loaders ---------------------------------------------------------------------

@pytest.mark.parametrize("path", YAML_FILES, ids=[IDS[p] for p in YAML_FILES])
def test_yaml_reads_alike_under_both_loaders(path):
    yaml = pytest.importorskip("yaml")
    docs = _docs(path)
    assert docs
    for text in docs:
        assert parse_simple_yaml(text) == yaml.safe_load(text)
    for no, line in enumerate(open(path), 1):
        code = line.split("#", 1)[0]
        assert "{" not in code and not code.rstrip().endswith(("|", ">")), \
            f"{IDS[path]}:{no}: not block style: {line!r}"


# -- commands --------------------------------------------------------------------

class _Parsed(Exception):
    pass


@pytest.mark.parametrize("path", COMMAND_FILES,
                         ids=[IDS[p] for p in COMMAND_FILES])
def test_commands_run_a_port_module_that_accepts_their_args(path,
                                                            monkeypatch):
    real = argparse.ArgumentParser.parse_args

    def parse_only(self, args=None, namespace=None):
        real(self, args, namespace)
        raise _Parsed

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", parse_only)
    for where, argv, _ in commands(path):
        if argv[0] == "gpu-hostengine":
            # the native agent: its usage names every flag given, and it
            # exits 0 on --help
            from tpumon_torch import _build

            r = subprocess.run([str(_build.native("gpu-hostengine")),
                                "--help"], capture_output=True, text=True,
                               timeout=60)
            assert r.returncode == 0, r.stderr
            flags = [a for a in argv[1:] if a.startswith("--")]
            assert flags, where
            for flag in flags:
                assert re.search(re.escape(flag) + r"\b", r.stdout), \
                    (where, flag)
            assert "--no-such-flag" not in r.stdout
            continue
        assert os.path.basename(argv[0]) in ("python", "python3"), where
        assert argv[1] == "-m" and argv[2].startswith("tpumon_torch."), \
            (where, argv)
        main = importlib.import_module(argv[2]).main
        with pytest.raises(_Parsed):
            main(argv[3:])
        # a flag the module does not have is refused, so the check bites
        with pytest.raises(SystemExit):
            main(argv[3:] + ["--no-such-flag"])


def test_every_command_file_is_checked():
    names = {IDS[p] for p in COMMAND_FILES}
    assert names == {
        "k8s/tpumon-daemonset.yaml", "k8s/tpumon-agent-daemonset.yaml",
        "k8s/tpumon-split-daemonsets.yaml", "k8s/tpumon-relay-deployment.yaml",
        "docker/docker-compose.yml", "docker/Dockerfile.exporter",
        "docker/Dockerfile.hostengine", "docker/Dockerfile.podexporter",
        "bare-metal/tpumon.service"}
    assert {IDS[p] for p in FILES} - names == {"README.md",
                                               "bare-metal/Makefile"}


# -- resources -------------------------------------------------------------------

def _keys(o):
    if isinstance(o, dict):
        for k, v in o.items():
            yield k, v
            yield from _keys(v)
    elif isinstance(o, list):
        for v in o:
            yield from _keys(v)


@pytest.mark.parametrize("path", YAML_FILES, ids=[IDS[p] for p in YAML_FILES])
def test_no_container_requests_a_gpu(path):
    for doc in (parse_simple_yaml(d) for d in _docs(path)):
        for k, v in _keys(doc):
            assert k != "nvidia.com/gpu", IDS[path]
            assert k not in ("gpus", "devices"), IDS[path]


#: the files that build the native agent, and the one command that does
BUILDERS = ("docker/Dockerfile.hostengine", "docker/Dockerfile.exporter",
            "bare-metal/Makefile")
NATIVE_BUILD = "python{v} -m tpumon_torch._build --native"


def test_nothing_is_built_or_installed():
    for p in FILES:
        name = os.path.basename(p)
        if name == "README.md":
            continue
        with open(p) as f:
            text = f.read()
        for word in ("pip", "gcc", "nvcc", "setup.py", "make "):
            assert word not in text, (IDS[p], word)
        # nothing of the reference's native tree (the port's is
        # tpumon_torch/native/)
        assert not re.search(r"(?<!tpumon_torch/)\bnative/", text), IDS[p]
        builds = IDS[p] in BUILDERS
        for word in ("g++", "_build"):
            assert (word in text) == builds, (IDS[p], word)
        # apt installs g++ in an image's build stage alone
        assert ("apt-get" in text) == (builds and name.startswith(
            "Dockerfile")), IDS[p]
        if builds:
            # the agent alone, from the port's sources, by the port's
            # build (the reference's flags; tpumon_torch/_build.py)
            assert (NATIVE_BUILD.format(v="") in text
                    or NATIVE_BUILD.format(v="3") in text), IDS[p]
            assert "install -D -m 0755" in text, IDS[p]
        if name.startswith("Dockerfile"):
            lines = [ln for ln in text.splitlines()
                     if ln and not ln.startswith("#") and not ln[0].isspace()]
            runs = [ln for ln in lines if ln.split()[0] == "RUN"]
            froms = [ln for ln in lines if ln.split()[0] == "FROM"]
            copies = [ln for ln in lines if ln.startswith("COPY")]
            if not builds:
                assert not runs and copies == [
                    "COPY tpumon_torch /opt/tpumon/tpumon_torch"], name
                continue
            # a build stage (apt's g++, then the build), and a final stage
            # that copies the binary alone out of it
            assert froms[0].endswith(" AS build") and len(froms) == 2, name
            assert len(runs) == 2 and runs[0].startswith(
                "RUN apt-get update && apt-get install -y "
                "--no-install-recommends g++"), name
            assert copies[0] == "COPY tpumon_torch /opt/tpumon/tpumon_torch"
            assert "COPY --from=build /out/gpu-hostengine " \
                "/usr/local/bin/gpu-hostengine" in copies, name


#: the files that deploy (an image sets no limit; its deployment does)
DEPLOYING = [p for p in COMMAND_FILES
             if not os.path.basename(p).startswith("Dockerfile")]


@pytest.mark.parametrize("path", DEPLOYING, ids=[IDS[p] for p in DEPLOYING])
def test_memory_limits_cover_the_measured_rss(path):
    for where, argv, limit in commands(path):
        k = kind(argv)
        if k in NVML_OPENERS:
            assert limit is not None and limit >= NVML_MIN_MIB, (where, limit)
        if limit is not None:
            assert k in MEASURED_RSS_MIB, (where, k)
            assert limit >= MEASURED_RSS_MIB[k], (where, limit)


# -- families --------------------------------------------------------------------

@pytest.fixture(scope="module")
def fake_lib(tmp_path_factory):
    return _build(tmp_path_factory.mktemp("nvml"), "libfake_nvml.so")


def test_named_families_are_served_or_listed(fake_lib, tmp_path,
                                             monkeypatch):
    from tpumon_torch import fields
    from tpumon_torch.backends.nvml import NvmlBackend

    monkeypatch.setenv("TPUMON_NVML_PATH", fake_lib)
    monkeypatch.setenv("TPUMON_KMSG_PATH", str(tmp_path / "no-kmsg"))
    for k in ("TPUMON_BACKEND", "TPUMON_POD_MAP_FILE", "TPUMON_CHIPS"):
        monkeypatch.delenv(k, raising=False)

    def nvml_open(_fields):
        b = NvmlBackend()
        b.open()
        return b, 0

    monkeypatch.setattr(SMOKE, "nvml_open", nvml_open)
    monkeypatch.setattr(SMOKE, "DEPLOY_S", 2.0)
    drop = tmp_path / "embed.prom"
    stop = threading.Event()

    def workload():  # a stand-in drop file: the CPU has no self-monitor
        while not stop.is_set():
            drop.with_suffix(".tmp").write_text(
                '# TYPE tpu_mfu gauge\ntpu_mfu{chip="0"} 0.4\n')
            os.replace(drop.with_suffix(".tmp"), drop)
            time.sleep(0.2)

    # a short work dir: the agents' unix socket paths live under it
    work = tempfile.mkdtemp(prefix="dpl-")
    t = threading.Thread(target=workload)
    t.start()
    try:
        out = SMOKE.deploy_phase(fields, dict(os.environ, PYTHONPATH=REPO),
                                 work, str(drop), check_readme=False)
    finally:
        stop.set()
        t.join()
        shutil.rmtree(work, ignore_errors=True)
    assert out["nvml_families"] >= 20
    assert [c["hello"] for c in out["containers"]] == [True, False, True]
    assert out["refused_imports"] == []
    own = SMOKE.readme_families("Served by the workload's self-monitor")
    blank = SMOKE.readme_families("Blank on the H100")
    named = SMOKE.named_families()
    assert len(named) >= 40 and own and not own & blank
    assert set(out["named_served"]) | set(out["named_blank"]) == named
    assert set(out["named_blank"]) <= own | blank, \
        set(out["named_blank"]) - own - blank
    # the self-monitor's families are the port's trace engine's
    with open(os.path.join(REPO, "tpumon_torch", "backends",
                           "cuda.py")) as f:
        cuda = f.read()
    for fam in own:
        assert (f'"{fam}"' in cuda or fields.by_name(fam).field_id
                in _cuda_fields()), fam


def _cuda_fields():
    from tpumon_torch.backends import cuda

    return cuda._UTIL_FIELDS
