"""The port's native agent, ``gpu-hostengine`` (``tpumon_torch/native/``),
against the port's Python agent (``python -m tpumon_torch.hostengine``) and
the reference's native ``tpu-hostengine``, on the CPU.

* Over NVML (the tests' fake NVML library, ``TPUMON_NVML_PATH``), op for
  op: ``hello`` (but ``agent_version``), ``chip_info``, ``read_fields``
  and ``read_fields_bulk`` over every catalog field, ``topology``,
  ``processes`` and the Xid events queued in the fake
  (``FAKE_NVML_XIDS``, through ``fake_nvml_inject_xid``) are equal to the
  Python agent's; so are the decoded ``sweep_frame`` mirrors.  Tolerance:
  none; event timestamps within 5 s.
* ``/metrics`` over NVML: the bodies are byte-equal but for the values of
  the agent's self families, with and without a hostile drop directory.
* The reference's own protocol cases (``tests/test_agent.py``: the fuzz,
  oversized and malformed requests, and every other case that drives a
  ``--fake`` agent) run against the port's binary (``run_on_port``).
* The kmsg classifier and the burst fold through the two test binaries
  (``kmsg-classify``, ``burst-fold``) against ``tpumon_torch.kmsg`` and
  ``tpumon_torch.burst`` on one corpus and randomized streams.
* The generated ``catalog.inc`` is fresh, and no port C/C++ source
  includes a path of the reference's tree or a CUDA header.
"""

import importlib
import inspect
import json
import os
import random
import re
import subprocess
import sys
import time

import pytest

import test_agent as REF_AGENT
import test_burst as REF_BURST
from test_torch_agent import (AGENT_SELF, PORT_AGENT, Raw, agent_env,
                              build_fake_nvml, catalog_fields, http_get,
                              prom_agent, spawn_agent, stop_agent)
from test_torch_fleet import run_on_port

import tpumon_torch.kmsg as PK
from tpumon_torch import _build

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE = os.path.join(REPO, "tpumon_torch", "native")
#: the fake NVML's two cards: bus 0000:18:00 is card 0, 0000:28:00 card 1
BUSES = {(0, 0x18, 0): 0, (0, 0x28, 0): 1}
#: Xids the fake queues at init: two mapped (79, 48), one unmapped (13)
XIDS = "1:79,0:13,0:48"


def gpu_agent():
    return [str(_build.native("gpu-hostengine"))]


@pytest.fixture(scope="module")
def nvml_env(tmp_path_factory):
    lib = build_fake_nvml(tmp_path_factory.mktemp("nvml"))
    return agent_env(TPUMON_NVML_PATH=lib, TPUMON_KMSG_PATH="/nonexistent",
                     FAKE_NVML_XIDS=XIDS)


@pytest.fixture(scope="module")
def nvml_agents(nvml_env, tmp_path_factory):
    """Both agents over the fake NVML: {"gpu": socket, "py": socket}."""

    d = tmp_path_factory.mktemp("agents")
    socks = {"gpu": str(d / "g.sock"), "py": str(d / "p.sock")}
    procs = [spawn_agent(gpu_agent(), socks["gpu"], env=nvml_env),
             spawn_agent(PORT_AGENT, socks["py"], env=nvml_env)]
    yield socks
    for p in procs:
        stop_agent(p)


def _strip(reply, path=()):
    """A reply without what may differ: the agent's version and the
    events' wall-clock stamps (kept aside, compared within 5 s)."""

    if isinstance(reply, dict):
        return {k: _strip(v, path + (k,)) for k, v in reply.items()
                if k not in ("agent_version", "timestamp")}
    if isinstance(reply, list):
        return [_strip(v, path) for v in reply]
    return reply


def _stamps(reply):
    return [e["timestamp"] for e in reply.get("events", [])]


NVML_OPS = {
    "hello": [{"op": "hello", "client": "t"}],
    "chip_info": [{"op": "chip_info", "index": i} for i in (0, 1, 2, -1)],
    "read_fields": [{"op": "read_fields", "index": i, "fields": "CATALOG"}
                    for i in (0, 1)]
    + [{"op": "read_fields", "index": 2, "fields": [155]}],
    "read_fields_bulk": [
        {"op": "read_fields_bulk",
         "reqs": [{"index": i, "fields": "CATALOG"} for i in (0, 1, 7)]},
        {"op": "read_fields_bulk", "reqs": [{"index": 1, "fields": [155,
                                                                    463]}],
         "max_age_s": 0.5}],
    "topology": [{"op": "topology", "index": i} for i in (0, 1, 2)],
    "processes": [{"op": "processes", "index": i} for i in (0, 1, 2)],
    "latest": [{"op": "latest", "index": 0, "fields": [203, 99]}],
    "unknown": [{"op": "bogus"}, {"x": 1}],
}


def _expand(req):
    if req.get("fields") == "CATALOG":
        req = dict(req, fields=catalog_fields())
    if isinstance(req.get("reqs"), list):
        req = dict(req, reqs=[dict(r, fields=catalog_fields())
                              if r["fields"] == "CATALOG" else r
                              for r in req["reqs"]])
    return req


@pytest.mark.parametrize("op", sorted(NVML_OPS))
def test_every_op_answers_like_the_python_agent_over_nvml(nvml_agents, op):
    conns = {k: Raw(v) for k, v in nvml_agents.items()}
    try:
        for req in NVML_OPS[op]:
            req = _expand(req)
            got = {k: c.ask(req) for k, c in conns.items()}
            assert _strip(got["gpu"]) == _strip(got["py"]), (req, got)
        if op == "hello":
            assert got["gpu"]["agent_version"] == "gpu-hostengine 0.1.0"
            assert got["gpu"]["chip_count"] == 2
    finally:
        for c in conns.values():
            c.close()


def test_read_fields_serve_the_fake_nvml_values(nvml_agents):
    """The values are NVML's, converted by the catalog's units: not merely
    equal between the agents but the fake's (mW -> W, B -> MiB, ns ->
    us, the NVLink counters per link), strings for the identity fields."""

    c = Raw(nvml_agents["gpu"])
    try:
        v = c.ask({"op": "read_fields", "index": 1,
                   "fields": [51, 52, 55, 100, 140, 150, 155, 156, 203,
                              204, 240, 241, 250, 251, 310, 390, 409, 450,
                              462, 463, 253]})["values"]
    finally:
        c.close()
    assert v["51"] == "NVIDIA H100 80GB HBM3"
    assert v["52"] == "GPU-00000000-1111-2222-3333-000000000001"
    assert v["55"] == "96.00.74.00.01"
    assert (v["100"], v["140"], v["150"]) == (1756, 53, 42)
    assert v["155"] == 124.456 and v["156"] == 987654322
    assert (v["203"], v["204"]) == (87, 45)
    assert (v["240"], v["241"]) == (1000, 2000)
    assert (v["250"], v["251"]) == (81559, 1234)
    assert (v["310"], v["390"]) == (11, 4)
    assert v["409"] == 1 + 11 + 21 + 31 and v["450"] == 2
    assert v["462"] == [1, 11, 21, 31] and v["463"] == [1, 1, 0, 0]
    assert v["253"] is None


def test_xid_events_like_the_python_agent_over_nvml(nvml_agents):
    """The Xids queued in the fake NVML arrive by the event set: the two
    mapped codes, in order, naming their cards; the unmapped 13 is none."""

    conns = {k: Raw(v) for k, v in nvml_agents.items()}
    try:
        deadline = time.monotonic() + 10.0
        got = {}
        for k, c in conns.items():
            while True:
                got[k] = c.ask({"op": "events", "since_seq": 0})
                if len(got[k]["events"]) >= 2 or time.monotonic() > deadline:
                    break
                time.sleep(0.05)
        peek = {k: c.ask({"op": "events", "since_seq": 0, "peek": True})
                for k, c in conns.items()}
        bulk = {k: c.ask({"op": "read_fields_bulk", "events_since": 1,
                          "reqs": [{"index": 0, "fields": [150]}]})
                for k, c in conns.items()}
    finally:
        for c in conns.values():
            c.close()
    assert _strip(got["gpu"]) == _strip(got["py"])
    assert [(e["etype"], e["chip_index"], e["message"], e["seq"])
            for e in got["gpu"]["events"]] == [(1, 1, "Xid 79", 1),
                                               (3, 0, "Xid 48", 2)]
    for a, b in zip(_stamps(got["gpu"]), _stamps(got["py"])):
        assert abs(a - b) < 5.0
    assert peek["gpu"] == peek["py"] == {"ok": True, "last_seq": 2}
    assert _strip(bulk["gpu"]) == _strip(bulk["py"])


def test_sweep_frames_decode_like_the_python_agent_over_nvml(nvml_agents):
    """JSON probe, then binary requests: the decoded mirrors (strings of
    the identity fields included) and events are equal frame for frame;
    a steady frame carries the index alone."""

    from tpumon_torch.sweepframe import (SweepFrameDecoder,
                                         encode_sweep_request)

    fids = catalog_fields()
    probe = (b'{"op": "sweep_frame", "reqs": [{"index": 0, "fields": '
             + json.dumps(fids).encode() + b'}, {"index": 1, "fields": '
             b'[155, 51]}], "events_since": 0}\n')
    steps = [probe,
             encode_sweep_request([(0, fids), (1, [155, 51])], None, 0),
             encode_sweep_request([(0, fids)], 0.5, None),
             encode_sweep_request([(0, [155]), (1, [463, 203]), (9, [1])],
                                  None, 10 ** 6)]
    decoded, sizes = {}, {}
    for k, sock in nvml_agents.items():
        c = Raw(sock)
        dec = SweepFrameDecoder()
        out, n = [], []
        try:
            for req in steps:
                frame = c.frame(req)
                assert frame[:1] == b"\xa9", frame[:200]
                payload = frame[1:]
                while payload[0] & 0x80:
                    payload = payload[1:]
                events = dec.apply(payload[1:])
                out.append((dec.mirror_snapshot(),
                            [(int(e.etype), e.seq, e.chip_index, e.message)
                             for e in events or []]))
                n.append(len(frame))
        finally:
            c.close()
        decoded[k], sizes[k] = out, n
    assert decoded["gpu"] == decoded["py"]
    assert decoded["gpu"][0][0][1][51] == "NVIDIA H100 80GB HBM3"
    assert sizes["gpu"][2] == sizes["py"][2] <= 6, sizes


def _scrape(cmd, sock, env, *args):
    proc, port = prom_agent(cmd, sock, *args, env=env)
    try:
        status, body = http_get(port, "/metrics")
        health = http_get(port, "/healthz")
    finally:
        stop_agent(proc)
    assert status == 200
    return body, health


def _without_self_values(body):
    """The body's lines, a self family's sample cut to its series name."""

    out = []
    for ln in body.splitlines():
        if not ln.startswith("#") and ln.split("{")[0].split(" ")[0] in \
                AGENT_SELF:
            ln = ln.rsplit(" ", 1)[0]
        out.append(ln)
    return out


@pytest.mark.parametrize("drop", [False, True], ids=["catalog", "merged"])
def test_prom_scrape_is_the_python_agents_over_nvml(nvml_env, tmp_path,
                                                    drop):
    from test_torch_agent import _hostile_drop_dir

    args = ()
    if drop:
        d = tmp_path / "drop"
        d.mkdir()
        _hostile_drop_dir(d)
        args = ("--merge-textfile", str(d / "*.prom"))
    gpu, gh = _scrape(gpu_agent(), str(tmp_path / "g.sock"), nvml_env, *args)
    py, ph = _scrape(PORT_AGENT, str(tmp_path / "p.sock"), nvml_env, *args)
    assert _without_self_values(gpu) == _without_self_values(py)
    assert gh == ph == (200, "ok\n")
    assert 'tpu_power_usage{chip="1",uuid="GPU-00000000-1111-2222-3333-' \
           '000000000001",model="NVIDIA H100 80GB HBM3"} 124.456' in gpu
    assert 'tpu_ici_link_state{chip="0",uuid="GPU-00000000-1111-2222-3333-' \
           '000000000000",model="NVIDIA H100 80GB HBM3",link="3"} 0' in gpu
    if drop:
        assert 'tpu_workload_step_time{chip="0",uuid="GPU-0"} 8432.5' in gpu


def test_burst_serves_instant_power_over_nvml(nvml_env, tmp_path):
    """``--burst-hz`` over NVML: the loop reads power from
    NVML_FI_DEV_POWER_INSTANT (the fake's 151.25 W on card 1, apart from
    the 1 s average's 124.456), as the Python agent does."""

    from tpumon_torch import fields as FF

    got = {}
    for k, cmd in (("gpu", gpu_agent()), ("py", PORT_AGENT)):
        sock = str(tmp_path / f"{k}.sock")
        proc = spawn_agent(cmd, sock, "--burst-hz", "50", env=nvml_env)
        c = Raw(sock)
        try:
            ids = [FF.burst_id(155, a) for a in range(3)] + [
                FF.burst_id(203, 1)]
            deadline = time.monotonic() + 10.0
            while True:
                v = c.ask({"op": "read_fields", "index": 1,
                           "fields": ids})["values"]
                if v[str(ids[0])] is not None or \
                        time.monotonic() > deadline:
                    break
                time.sleep(0.1)
            hello = c.ask({"op": "hello"})
        finally:
            c.close()
            stop_agent(proc)
        got[k] = v
        assert hello["burst_hz"] == 50
    assert got["gpu"] == got["py"] == {
        str(ids[0]): 151.25, str(ids[1]): 151.25, str(ids[2]): 151.25,
        str(ids[3]): 87}


def test_exit_codes_like_the_python_agent(tmp_path):
    """No NVML library: exit 3 naming merge-only mode; with a merge glob,
    merge-only (zero devices, healthz 503).  A library that loads and is
    not NVML: exit 3 even with the glob."""

    glob_args = ("--merge-textfile", str(tmp_path / "*.prom"))
    cases = [({"TPUMON_NVML_PATH": str(tmp_path / "none.so")}, (), 3,
              "merge-only"),
             ({"TPUMON_NVML_PATH": "libc.so.6"}, glob_args, 3,
              "no metric source")]
    for extra, args, rc, text in cases:
        for cmd in (gpu_agent(), PORT_AGENT):
            r = subprocess.run(cmd + ["--domain-socket",
                                      str(tmp_path / "x.sock"), *args],
                               env=agent_env(**extra), cwd=REPO,
                               capture_output=True, text=True, timeout=60)
            assert r.returncode == rc and text in r.stderr, (cmd, r.stderr)
    proc, port = prom_agent(gpu_agent(), str(tmp_path / "m.sock"),
                            *glob_args,
                            env=agent_env(TPUMON_NVML_PATH=str(
                                tmp_path / "none.so")))
    try:
        assert http_get(port, "/healthz")[0] == 503
        assert "tpumon_agent_merged_files 0" in http_get(port, "/metrics")[1]
    finally:
        stop_agent(proc)


def test_kmsg_flag_feeds_the_nvml_source(tmp_path):
    """``--kmsg FILE`` over a fake NVML without the event set: an Xid line
    appended while the agent runs is one event naming the card on that
    bus, as the Python agent's (``test_torch_agent.py``)."""

    import shutil

    cc = shutil.which("cc") or shutil.which("gcc")
    lib = str(tmp_path / "libfake_nvml_noevents.so")
    testlib = os.path.join(REPO, "tpumon_torch", "testlib")
    subprocess.run([cc, "-shared", "-fPIC", "-DOMIT_EVENTS", "-I", testlib,
                    "-o", lib, os.path.join(testlib, "fake_nvml.c"),
                    "-lpthread"], check=True, capture_output=True,
                   timeout=120)
    kmsg = tmp_path / "kmsg"
    kmsg.write_text("")
    env = agent_env(TPUMON_NVML_PATH=lib,
                    TPUMON_KMSG_PATH=str(tmp_path / "not-this-one"))
    sock = str(tmp_path / "k.sock")
    proc = spawn_agent(gpu_agent(), sock, "--kmsg", str(kmsg), env=env)
    try:
        with open(kmsg, "a") as f:
            f.write("3,1,1,-;NVRM: Xid (PCI:0000:28:00): 79, pid=1, GPU "
                    "has fallen off the bus.\n"
                    "3,2,2,-;NVRM: Xid (PCI:0000:18:00): 13, pid=1, x\n")
        c = Raw(sock)
        try:
            deadline = time.monotonic() + 20.0
            while True:
                ev = c.ask({"op": "events", "since_seq": 0})["events"]
                if ev or time.monotonic() > deadline:
                    break
                time.sleep(0.1)
            time.sleep(0.3)
            ev = c.ask({"op": "events", "since_seq": 0})["events"]
        finally:
            c.close()
    finally:
        stop_agent(proc)
    assert [(e["etype"], e["chip_index"]) for e in ev] == [(1, 1)]
    assert "Xid (PCI:0000:28:00): 79" in ev[0]["message"]


def test_agent_creates_no_cuda_context_and_loads_no_torch():
    """The binary links neither CUDA's runtime nor its driver library:
    libcuda can only arrive through NVML's own init."""

    r = subprocess.run(["ldd", gpu_agent()[0]], capture_output=True,
                       text=True, timeout=30)
    libs = r.stdout
    assert "libcuda" not in libs and "libcudart" not in libs
    assert "libtorch" not in libs and "libpython" not in libs


# ---- the reference's own agent cases against the port's binary ----------------

#: reference cases not run on the port's binary, with the reason
REF_SKIP = {
    # the reference's façade (tpumon.init) and exporter: JAX-package
    # modules, not the agent's protocol
    "test_full_facade_through_agent": "drives tpumon.init",
    "test_exporter_emits_agent_self_metrics": "drives tpumon's exporter",
    "test_exporter_through_agent_watch": "drives tpumon's exporter",
    "test_exporter_sweep_wire_self_metrics": "drives tpumon's exporter",
    "test_start_agent_mode": "starts the reference's agent by tpumon.init",
    "test_watchmanager_uses_piggybacked_events": "tpumon's WatchManager",
    # merge-only mode is keyed to libtpu's absence there, NVML's here
    # (tests/test_torch_agent.py holds it like the native's)
    "test_merge_only_mode_without_chips": "libtpu's absence",
    # asserts the version string names tpu-hostengine; the port's agent is
    # gpu-hostengine (test_every_op_answers_like_the_python_agent_over_nvml)
    "test_inventory_and_reads": "the agent's name in its version",
}
REF_CASES = sorted(n for n, v in vars(REF_AGENT).items()
                   if n.startswith("test_") and callable(v)
                   and n not in REF_SKIP)
assert set(REF_SKIP) <= set(vars(REF_AGENT))
assert {"test_protocol_fuzz_survives", "test_oversized_request_rejected",
        "test_malformed_request_survives"} <= set(REF_CASES)


@pytest.fixture
def port_agent_proc(tmp_path):
    sock = str(tmp_path / "a.sock")
    proc = spawn_agent(gpu_agent(), sock, "--fake", "--allow-inject")
    yield proc, f"unix:{sock}"
    stop_agent(proc)


#: reference cases that hold the scrape's whole family set: they read the
#: port's body without the scrape phases the reference's agent does not
#: serve (``PORT_SELF``, held by ``tests/test_torch_agent.py``)
REF_FAMILY_SET_CASES = {"test_prom_endpoint_serves_catalog_families"}


def _without_port_phases(monkeypatch):
    """``urllib.request.urlopen`` reading bodies without the lines of the
    port's own scrape-phase families."""

    import urllib.request

    from test_torch_agent import PORT_SELF, family_of

    urlopen = urllib.request.urlopen

    class Response:
        def __init__(self, r):
            self._r, self.status = r, r.status

        def read(self):
            text = self._r.read().decode()
            return "".join(ln + "\n" for ln in text.splitlines()
                           if family_of(ln) not in PORT_SELF).encode()

        def __getattr__(self, name):
            return getattr(self._r, name)

    monkeypatch.setattr(urllib.request, "urlopen",
                        lambda *a, **k: Response(urlopen(*a, **k)))


@pytest.mark.parametrize("case", REF_CASES)
def test_reference_agent_case_holds_on_the_port(case, tmp_path,
                                                monkeypatch):
    kwargs = {"tmp_path": tmp_path}
    if case in REF_FAMILY_SET_CASES:
        _without_port_phases(monkeypatch)
    fn = getattr(REF_AGENT, case)
    if "agent_proc" in inspect.signature(fn).parameters:
        sock = str(tmp_path / "a.sock")
        proc = spawn_agent(gpu_agent(), sock, "--fake", "--allow-inject")
        kwargs["agent_proc"] = (proc, f"unix:{sock}")
    else:
        proc = None
    # the case's own imports of these resolve to the port's too
    for name in ("backends.base", "fields", "types"):
        monkeypatch.setitem(sys.modules, "tpumon." + name,
                            importlib.import_module("tpumon_torch." + name))
    try:
        run_on_port(REF_AGENT, case, monkeypatch,
                    names={"AGENT": gpu_agent()[0]}, **kwargs)
    finally:
        if proc is not None:
            stop_agent(proc)


# ---- the two test binaries -----------------------------------------------------

#: lines for the classifiers: the NVIDIA driver's, the reference's
#: unrelated and TPU lines, and the near misses
KMSG_CORPUS = [
    "NVRM: Xid (PCI:0000:18:00): 79, pid=1, GPU has fallen off the bus.",
    "NVRM: Xid (PCI:0000:28:00): 48, pid='<unknown>', name=<unknown>, "
    "An uncorrectable double bit error",
    "NVRM: Xid (PCI:0000:28:00): 63, pid=1, Row Remapper: New row marked",
    "NVRM: Xid (PCI:0000:28:00): 64, pid=1, Row Remapper failure",
    "NVRM: Xid (PCI:0000:28:00): 74, pid=1, NVLink: fatal error detected",
    "NVRM: Xid (PCI:0000:28:00 GPU-I:01): 79, pid=1, fell off",
    "NVRM: Xid (PCI:0000:3b:00): 92, pid=1, High single-bit ECC error rate",
    "NVRM: Xid (PCI:0000:18:00): 13, pid=1, Graphics Exception",
    "NVRM: Xid (PCI:0000:18:00): 99999999999999999999, pid=1",
    "NVRM: Xid (PCI:0000:18:00): 79",
    "NVRM: Xid (PCI:18:00): 79, short bus id",
    "NVRM: loading NVIDIA UNIX x86_64 Kernel Module  550.54.15",
    "pcieport 0000:17:00.0: AER: Corrected error received: 0000:18:00.0",
    "pcieport 0000:27:00.0: AER: Uncorrected (Fatal) error received: "
    "0000:28:00.0",
    "nvidia 0000:3b:00.0: PCIe Bus Error: severity=Corrected",
    "nvidia 00000000:28:00.0: PCIe link replay timeout",
    "pcieport 0000:00:01.0: AER: Multiple Corrected error received",
    "PCIE BUS ERROR on 0000:28:00",
    "aer something about caerleon 0000:18:00.1",
    "usb 1-1: reset high-speed USB device",
    "e1000e: eth0 link is down, fatal",
    "accel accel0: routine sweep complete",
    "accel accel2: ICI link 3 CRC error count exceeded",
    "tpu_runtime: runtime crashed, restart scheduled",
    "",
    "NVRM: GPU at PCI:0000:18:00: GPU-00000000-1111-2222-3333-000000000000",
    "NVRM: Xid (PCI:0000:18:00): 48 AER",
]


def _fuzz_lines(n, seed=11):
    rng = random.Random(seed)
    parts = ["NVRM: Xid (PCI:", "0000:18:00", "0000:28:00", "0000:3b:00",
             "00000000:28:00.0", "): ", "79", "48", "63", "13", ", pid=1",
             " AER ", "PCIe", " error", " replay", " timeout", "nvidia ",
             "GPU-I:01", ")", "x" * 30, " ", ".7", ".9", "-", ":"]
    return ["".join(rng.choice(parts) for _ in range(rng.randrange(1, 9)))
            for _ in range(n)]


@pytest.mark.parametrize("buses", [BUSES, {}, {(0, 0x3b, 0): 4}],
                         ids=["fake", "none", "other"])
def test_kmsg_classifier_matches_the_python_one(buses):
    lines = KMSG_CORPUS + _fuzz_lines(400)
    args = [f"{d:04x}:{b:02x}:{v:02x}={i}" for (d, b, v), i in buses.items()]
    r = subprocess.run([str(_build.native("kmsg-classify")), *args],
                       input="\n".join(lines) + "\n", capture_output=True,
                       text=True, timeout=60)
    assert r.returncode == 0, r.stderr
    got = [tuple(map(int, ln.split())) for ln in r.stdout.splitlines()]
    want = []
    for line in lines:
        hit = PK.classify_line(line, buses)
        want.append((0, -1) if hit is None else (int(hit[0]), hit[1]))
    assert len(got) == len(lines)
    bad = [(l, g, w) for l, g, w in zip(lines, got, want) if g != w]
    assert not bad, bad[:5]
    assert sum(1 for g in got if g[0]) >= 8


def test_burst_fold_matches_the_python_accumulator(monkeypatch):
    """The reference's fold differential (``tests/test_burst.py``), run
    with the port's accumulator and codec over the port's oracle."""

    run_on_port(REF_BURST, "test_cc_fold_differential_fuzz", monkeypatch,
                names={"ORACLE": str(_build.native("burst-fold"))})


# ---- the sources themselves ---------------------------------------------------

def test_generated_catalog_is_fresh():
    from tpumon_torch.native import gen_catalog_header as G

    with open(G.OUT, encoding="utf-8") as f:
        assert f.read() == G.render(), (
            "stale: python -m tpumon_torch.native.gen_catalog_header")


def _sources():
    out = []
    for root, _, files in os.walk(NATIVE):
        out += [os.path.join(root, f) for f in files
                if f.endswith((".cc", ".hpp", ".h", ".c", ".inc"))]
    return sorted(out)


def test_no_port_source_includes_the_reference_or_cuda():
    srcs = _sources()
    assert len(srcs) >= 14
    bad = []
    for path in srcs:
        with open(path, encoding="utf-8") as f:
            for n, line in enumerate(f, 1):
                m = re.match(r'\s*#\s*include\s*([<"])([^>"]+)', line)
                if not m:
                    continue
                inc = m.group(2)
                if ("native/" in inc or "tpumon/" in inc or ".." in inc
                        or inc.startswith(("cuda", "nvml", "cupti"))
                        and m.group(1) == "<"):
                    bad.append(f"{path}:{n}: {line.strip()}")
                # a quoted include resolves beside the source or in one of
                # the build's include directories (the port's own)
                if m.group(1) == '"' and not any(
                        os.path.exists(os.path.join(d, inc)) for d in
                        (os.path.dirname(path), *_build.INCLUDES[1::2])):
                    bad.append(f"{path}:{n}: {line.strip()}")
    assert not bad, bad
    # and the build's include path holds the port's directories alone
    for flag in _build.INCLUDES[1::2]:
        assert flag.startswith(os.path.join(REPO, "tpumon_torch")), flag


def test_native_builds_are_named_by_their_sources():
    paths = _build.native()
    assert set(paths) == set(_build.NATIVE_TARGETS)
    for name, path in paths.items():
        t = _build.NATIVE_TARGETS[name]
        assert path.exists() and path.parent == _build.BUILD_DIR
        after = paths.get(t.after) if t.after else None
        assert path == _build.native_path(t, _build.native_digest(t, after))
