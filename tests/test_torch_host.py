"""The port's host surfaces against the reference's, on the same inputs.

``tpumon_torch.procscan`` and ``tpumon_torch.kmsg`` are copies of
``tpumon``'s with the classifier rewritten for NVIDIA's Xid lines: both
device-holder scans on the same pipe, both kernel-log watchers on the same
fixture file (EOF start, continuation lines, an EPIPE re-seek), both
classifiers on the reference's unrelated lines, and for each event type
the reference's classifier emits the port's Xid (or AER) line for it.
The sample CLIs' rows are held byte for byte to the reference's on the
same values; the diag load's seam runs on the CPU; the evidence kit reads
a fixture tree.
"""

import errno
import json
import os
import threading
import time
import types

import pytest

import tpumon.kmsg as RK
import tpumon.procscan as RP
import tpumon_torch.kmsg as PK
import tpumon_torch.procscan as PP
from tpumon.events import EventType as REventType
from tpumon_torch.events import EventType

#: the port's bus map of the fixtures: GPU 0 at 0000:18:00, GPU 1 at 28
BUSES = {(0, 0x18, 0): 0, (0, 0x28, 0): 1}


# ---- procscan ----------------------------------------------------------------

def test_holders_of_matches_reference_on_a_pipe():
    r, w = os.pipe()
    try:
        target = os.readlink(f"/proc/self/fd/{r}")
        ref, port = RP.holders_of(target), PP.holders_of(target)
        assert [(p.pid, p.name, p.hbm_used_mib) for p in port] == \
            [(p.pid, p.name, p.hbm_used_mib) for p in ref]
        assert os.getpid() in [p.pid for p in port]
        assert PP.holders_of("") == RP.holders_of("") == []
        assert PP.comm_of(os.getpid()) == RP.comm_of(os.getpid())
    finally:
        os.close(r)
        os.close(w)


# ---- classifiers --------------------------------------------------------------

#: the reference's unrelated lines: no event in either classifier
UNRELATED = [
    "usb 1-1: reset high-speed USB device",
    "e1000e: eth0 link is down, fatal",
    "usb 2-1: reset (must be ignored)",
    "accel accel0: routine sweep complete",
    "NVRM: loading NVIDIA UNIX x86_64 Kernel Module  550.54.15",
    "NVRM: Xid (PCI:0000:18:00): 13, pid=1, Graphics Exception",
    "pcieport 0000:00:03.0: AER: Corrected error received: 0000:00:03.0",
]


@pytest.mark.parametrize("line", UNRELATED)
def test_unrelated_lines_classify_as_none(line):
    assert PK.classify_line(line, BUSES) is None
    if "accel" not in line and "NVRM" not in line and "AER" not in line:
        assert RK.classify_line(line) is None


#: every type the reference's classifier emits -> a line of the reference
#: and the NVIDIA driver's line for the same event (None: no Xid exists)
EMITTED = {
    REventType.ECC_DBE: ("accel accel1: uncorrectable memory error",
                         "NVRM: Xid (PCI:0000:28:00): 48, pid='<unknown>', "
                         "An uncorrectable double bit error (DBE) has been "
                         "detected on GPU in the framebuffer"),
    REventType.HBM_REMAP: ("accel accel1: HBM row remapped (bank 3)",
                           "NVRM: Xid (PCI:0000:28:00): 63, pid=1, Row "
                           "Remapper: New row marked for remapping"),
    REventType.PCIE_ERROR: ("accel accel1: PCIe link error detected",
                            "pcieport 0000:00:03.0: AER: Uncorrected "
                            "error received: 0000:28:00.0"),
    REventType.ICI_ERROR: ("tpu: ICI link 2 down on accel1",
                           "NVRM: Xid (PCI:0000:28:00): 74, pid=1, NVLink: "
                           "fatal error detected on link 2"),
    REventType.CHIP_RESET: ("accel accel1: device reset requested",
                            "NVRM: Xid (PCI:0000:28:00 GPU-I:01): 79, "
                            "pid=1, GPU has fallen off the bus."),
    REventType.THERMAL: ("accel accel1: thermal limit reached", None),
    REventType.RUNTIME_RESTART: ("tpu runtime crashed, respawning", None),
}


def test_emitted_types_are_the_reference_tables():
    assert set(EMITTED) == {etype for _, etype in RK._PATTERNS}


@pytest.mark.parametrize("etype", list(EMITTED), ids=lambda e: e.name)
def test_each_reference_event_type_from_an_nvidia_line(etype):
    ref_line, port_line = EMITTED[etype]
    assert RK.classify_line(ref_line)[0] is etype
    if port_line is None:
        # NVIDIA's Xid catalog has no code for it: the port never guesses,
        # not even from the reference's own phrasing behind the NVRM tag
        assert PK.classify_line(f"NVRM: {ref_line}", BUSES) is None
        assert int(etype) not in {int(t) for t in PK.XID_EVENTS.values()}
        return
    assert PK.classify_line(port_line, BUSES) == (EventType(int(etype)), 1)
    # without the bus map an Xid line still classifies, to no device; an
    # AER line is then about no known GPU
    assert PK.classify_line(port_line) == (
        None if etype is REventType.PCIE_ERROR
        else (EventType(int(etype)), -1))


@pytest.mark.parametrize("code", range(0, 160))
def test_xid_codes_map_only_the_catalog(code):
    line = f"NVRM: Xid (PCI:0000:18:00): {code}, pid=1, something"
    want = PK.XID_EVENTS.get(code)
    assert PK.classify_line(line, BUSES) == (
        None if want is None else (want, 0))


def test_aer_line_of_the_nvidia_driver_without_a_bus_map():
    line = "nvidia 0000:3b:00.0: AER: PCIe Bus Error: severity=Corrected"
    assert PK.classify_line(line) == (EventType.PCIE_ERROR, -1)
    assert PK.classify_line(line, {(0, 0x3b, 0): 4}) == \
        (EventType.PCIE_ERROR, 4)


@pytest.mark.parametrize("text,key", [
    ("0000:3b:00", (0, 0x3b, 0)),
    ("00000000:3B:00.0", (0, 0x3b, 0)),
    ("0001:c1:1f.7", (1, 0xc1, 0x1f)),
    ("no bus here", None),
])
def test_bus_key(text, key):
    assert PK.bus_key(text) == key


def test_parse_kmsg_record_matches_reference():
    for line in ("6,1234,5678,-;NVRM: Xid (PCI:0000:18:00): 79, x",
                 " SUBSYSTEM=pci", "no-semicolon line", "", "3,1,2,-;"):
        assert PK.parse_kmsg_record(line) == RK.parse_kmsg_record(line)


# ---- the watchers on one fixture file ----------------------------------------

def _record(path, message, seq=[500]):  # noqa: B006 — shared counter
    seq[0] += 1
    with open(path, "a") as f:
        f.write(f"3,{seq[0]},{seq[0] * 1000},-;{message}\n")


def _start_both(path):
    got = {"ref": [], "port": []}
    ref = RK.KmsgWatcher(lambda c, e, ts, m: got["ref"].append((c, e)),
                         path=str(path), poll_interval_s=0.02)
    port = PK.KmsgWatcher(lambda c, e, ts, m: got["port"].append((c, e)),
                          path=str(path), poll_interval_s=0.02,
                          buses=BUSES)
    assert ref.start() and port.start()
    return ref, port, got


def _wait(got, n, timeout=5.0):
    deadline = time.monotonic() + timeout
    while (len(got["ref"]) < n or len(got["port"]) < n) and \
            time.monotonic() < deadline:
        time.sleep(0.02)


def test_watchers_agree_on_one_fixture(tmp_path):
    """EOF start, continuation and garbage lines, each device's event: the
    reference's lines and the port's for the same events, interleaved in
    one file, give both watchers the same (chip, type) sequence."""

    path = tmp_path / "kmsg"
    path.write_text("4,1,1000,-;accel accel0: device reset requested\n"
                    "4,2,1001,-;NVRM: Xid (PCI:0000:18:00): 79, old\n")
    ref, port, got = _start_both(path)
    try:
        time.sleep(0.1)
        assert got == {"ref": [], "port": []}  # history skipped
        for etype in (REventType.ECC_DBE, REventType.CHIP_RESET,
                      REventType.ICI_ERROR, REventType.PCIE_ERROR):
            ref_line, port_line = EMITTED[etype]
            _record(path, ref_line)
            _record(path, port_line)
            _record(path, " SUBSYSTEM=pci")       # continuation
            _record(path, "usb 1-1: reset high-speed USB device")
        with open(path, "a") as f:
            f.write("garbage without a separator\n")
        _wait(got, 4)
        time.sleep(0.1)
    finally:
        ref.stop()
        port.stop()
    assert got["port"] == got["ref"]
    assert [e for _, e in got["port"]] == [
        int(EventType.ECC_DBE), int(EventType.CHIP_RESET),
        int(EventType.ICI_ERROR), int(EventType.PCIE_ERROR)]
    assert {c for c, _ in got["port"]} == {1}


@pytest.mark.parametrize("mod", [RK, PK], ids=["reference", "port"])
def test_watcher_reseeks_after_epipe(mod, tmp_path, monkeypatch):
    """A read overtaken by the ring buffer (EPIPE) is retried, never the
    end of the tailer: the next record still arrives, in both packages."""

    path = tmp_path / "kmsg"
    path.write_text("")
    lines = {RK: "accel accel1: device reset requested",
             PK: "NVRM: Xid (PCI:0000:28:00): 79, pid=1, fell off"}
    real_read, failed = os.read, []

    def read(fd, n):
        if not failed and os.fstat(fd).st_size > 0:
            failed.append(fd)
            raise OSError(errno.EPIPE, "overrun")
        return real_read(fd, n)

    got = []
    kw = {"buses": BUSES} if mod is PK else {}
    w = mod.KmsgWatcher(lambda c, e, ts, m: got.append((c, e)),
                        path=str(path), poll_interval_s=0.02, **kw)
    monkeypatch.setattr(os, "read", read)
    assert w.start()
    try:
        _record(path, lines[mod])
        deadline = time.monotonic() + 5
        while not got and time.monotonic() < deadline:
            time.sleep(0.02)
    finally:
        w.stop()
    assert failed, "the EPIPE was never raised"
    assert got == [(1, int(EventType.CHIP_RESET))]


def test_port_watcher_stop_and_restart_like_reference(tmp_path):
    path = tmp_path / "kmsg"
    path.write_text("")
    w = PK.KmsgWatcher(lambda *a: None, path=str(path),
                       poll_interval_s=0.02)
    assert w.start()
    th = w._thread
    w.stop()
    assert not th.is_alive() and w._thread is None
    assert not PK.KmsgWatcher(lambda *a: None,
                              path=str(tmp_path / "none")).start()


# ---- the sample CLIs' rows against the reference's ----------------------------

def _vals(F, values):
    return dict(zip([int(F.POWER_USAGE), int(F.CORE_TEMP),
                     int(F.TENSORCORE_UTIL), int(F.HBM_BW_UTIL),
                     int(F.INFEED_UTIL), int(F.OUTFEED_UTIL),
                     int(F.TENSORCORE_CLOCK), int(F.HBM_CLOCK)], values))


@pytest.mark.parametrize("values", [
    (123.456, 41, 87, 45, None, None, 1755, 2619),
    (None, None, None, None, None, None, None, None),
    (700.0, 85, 100, 0, 3, 2, 1980, 2619),
    (0.04, 0, 0, 0, 0, 0, 0, 0),
])
@pytest.mark.parametrize("index", [0, 7, 123])
def test_dmon_row_matches_reference(values, index):
    from tpumon import fields as RF
    from tpumon.cli import dmon as RD
    from tpumon_torch import fields as PF
    from tpumon_torch.cli import dmon as PD

    assert PD.HEADER == RD.HEADER
    assert PD.row(index, _vals(PF.F, values)) == \
        RD.row(index, _vals(RF.F, values))


def _handle(types_mod, name, power, total, bus, numa, driver):
    info = types_mod.ChipInfo(
        index=1, uuid="GPU-00000000-1111-2222-3333-000000000001", name=name,
        arch=types_mod.ChipArch.UNKNOWN, serial="1650000001",
        dev_path="/dev/nvidia1", firmware="96.00.74.00.01",
        driver_version=driver, power_limit_w=power,
        hbm=types_mod.HbmInfo(total=total),
        clocks_max=types_mod.ClockInfo(tensorcore=1980, hbm=2619),
        pci=types_mod.PciInfo(bus_id=bus),
        coords=types_mod.ChipCoords(x=1), numa_node=numa, host="host-a")
    versions = types_mod.VersionInfo(driver=driver, runtime="",
                                     framework="x")
    return types.SimpleNamespace(chip_info=lambda i: info,
                                 versions=lambda: versions)


@pytest.mark.parametrize("args", [
    ("NVIDIA H100 80GB HBM3", 700.0, 81559, "00000000:18:00.0", 1,
     "550.54.15"),
    ("GPU", None, None, "", None, ""),
])
def test_deviceinfo_render_matches_reference(args):
    import tpumon.types as RT
    import tpumon_torch.types as PT
    from tpumon.cli import deviceinfo as RD
    from tpumon_torch.cli import deviceinfo as PD

    assert PD.render(_handle(PT, *args), 1) == \
        RD.render(_handle(RT, *args), 1)


# ---- agent run modes: each CLI over --connect and --start-agent --------------

#: each CLI's arguments for one deterministic run
CLI_ARGS = {"dmon": ["-c", "1", "-d", "0.1"], "deviceinfo": [],
            "topology": [], "processinfo": ["--warmup", "0"],
            "diag": ["-r", "3", "--json"], "health": [],
            "policy": ["--duration", "0.3"]}
#: the port's GPU wording where the reference's names TPU parts
PORT_WORDS = (("GPUs:", "ICI mesh:"), ("NVL/", "ICI1/"), ("NVL ", "ICI1 "),
              ("a GPU", "a TPU chip"))


@pytest.fixture(scope="module")
def run_mode_agents(tmp_path_factory):
    """The native and the port's ``--fake`` agents at one frozen epoch,
    and the port's agent over the fake NVML library."""

    from test_torch_agent import (FROZEN, PORT_AGENT, agent_env,
                                  build_fake_nvml, spawn_agent, stop_agent)
    from test_torch_fake import native_agent

    native = native_agent()
    d = tmp_path_factory.mktemp("runmodes")
    lib = build_fake_nvml(d)
    nvml_env = {"TPUMON_NVML_PATH": lib,
                "TPUMON_KMSG_PATH": str(d / "no-kmsg")}
    fake = ("--fake", "--fake-epoch", repr(FROZEN), "--allow-inject")
    socks = {k: str(d / f"{k}.sock") for k in ("native", "port", "nvml")}
    procs = [spawn_agent([native], socks["native"], *fake),
             spawn_agent(PORT_AGENT, socks["port"], *fake),
             spawn_agent(PORT_AGENT, socks["nvml"],
                         env=agent_env(**nvml_env))]
    yield socks, nvml_env
    for p in procs:
        stop_agent(p)


def _cli_output(pkg, cli, argv, capsys):
    import importlib

    mod = importlib.import_module(f"{pkg}.cli.{cli}")
    try:
        rc = mod.main(argv)
    except SystemExit as e:
        rc = e.code
    out = capsys.readouterr().out
    if cli == "diag":  # details carry this process's RSS and CPU
        out = [(d["check"], d["status"]) for d in map(json.loads,
                                                       out.splitlines())]
    elif pkg == "tpumon_torch":
        for port, ref in PORT_WORDS:
            out = out.replace(port, ref)
    if cli == "topology":  # the port's link labels are narrower
        out = [ln.split() for ln in out.splitlines()]
    return rc, out


@pytest.mark.parametrize("cli", ["dmon", "deviceinfo", "topology",
                                 "processinfo", "diag", "health", "policy"])
@pytest.mark.parametrize("flag", [["--connect", "unix:/tmp/agent.sock"],
                                  ["--start-agent"]])
def test_agent_run_modes_exit_naming_the_item(cli, flag, run_mode_agents,
                                              capsys, monkeypatch):
    """Each CLI's agent run modes round-trip.  ``--connect``: the port's
    CLI on the port's ``--fake`` agent prints what the reference's CLI
    prints on the native ``--fake`` agent at the same (frozen) epoch.
    ``--start-agent``: the port's CLI starts the port's agent over NVML
    (the fake NVML library) and prints what the reference's CLI prints
    connected to such an agent; no agent process is left behind."""

    from test_torch_agent import agent_children

    socks, nvml_env = run_mode_agents
    args = CLI_ARGS[cli]
    if flag[0] == "--connect":
        port = _cli_output("tpumon_torch", cli,
                           ["--connect", f"unix:{socks['port']}", *args],
                           capsys)
        ref = _cli_output("tpumon", cli,
                          ["--connect", f"unix:{socks['native']}", *args],
                          capsys)
    else:
        for k, v in nvml_env.items():
            monkeypatch.setenv(k, v)
        before = set(agent_children())
        port = _cli_output("tpumon_torch", cli, ["--start-agent", *args],
                           capsys)
        assert set(agent_children()) - before == set()
        ref = _cli_output("tpumon", cli,
                          ["--connect", f"unix:{socks['nvml']}", *args],
                          capsys)
    assert port == ref
    assert port[1]


# ---- the diag load ------------------------------------------------------------

def test_diag_load_chain_on_the_cpu():
    """The seam's workload: the reference's 8-deep chain of 512x512 bf16
    products (x @ x / 32), on the CPU.  An all-c matrix goes to 16 c^2
    per product, exactly in bf16: 1/16 is the chain's fixed point."""

    import torch
    from tpumon_torch.cli import diag as D

    h = types.SimpleNamespace(backend=types.SimpleNamespace())
    step, x, sync = D._EvidenceLoad(h, 1.0, device="cpu")._make_workload()
    assert x.shape == (512, 512) and x.dtype == torch.bfloat16
    assert x.device.type == "cpu"
    y = step(torch.full((512, 512), 1 / 16, dtype=torch.bfloat16))
    assert torch.equal(y, torch.full_like(y, 1 / 16))
    sync(y)


def test_diag_load_thread_lifecycle(monkeypatch):
    """stop() joins the stepping thread; the stepping calls the backend's
    note_step when it has one (the reference's lifecycle test, with the
    torch workload)."""

    from tpumon_torch.cli import diag as D

    steps = []
    h = types.SimpleNamespace(backend=types.SimpleNamespace(
        note_step=lambda: steps.append(1)))
    load = D._EvidenceLoad(h, seconds=30.0, device="cpu")
    monkeypatch.setattr(D._EvidenceLoad, "_make_workload",
                        lambda self: (lambda y: y, 0, lambda y: None))
    load.start()
    th = load._thread
    assert th is not None and th.is_alive()
    deadline = time.monotonic() + 5
    while not steps and time.monotonic() < deadline:
        time.sleep(0.01)
    load.stop()
    assert not th.is_alive() and steps
    load.stop()  # idempotent

    def boom(_chip):
        raise RuntimeError("warmup exploded")

    h2 = types.SimpleNamespace(backend=types.SimpleNamespace(
        warmup_probes=boom))
    load2 = D._EvidenceLoad(h2, seconds=30.0, device="cpu")
    with pytest.raises(RuntimeError):
        load2.start()
    assert load2._thread is None or not load2._thread.is_alive()
    assert threading.active_count() >= 1


# ---- the evidence kit --------------------------------------------------------

def test_evidence_reads_an_nvidia_fixture_tree(tmp_path, monkeypatch):
    from tpumon_torch import evidence

    root = tmp_path / "root"
    gpu = root / "sys/bus/pci/devices/0000:18:00.0"
    nic = root / "sys/bus/pci/devices/0000:03:00.0"
    for d, vendor, cls in ((gpu, "0x10de", "0x030200"),
                           (nic, "0x8086", "0x020000")):
        d.mkdir(parents=True)
        (d / "vendor").write_text(vendor + "\n")
        (d / "class").write_text(cls + "\n")
    (gpu / "numa_node").write_text("1\n")
    (gpu / "local_cpulist").write_text("0-47\n")
    (gpu / "nvlink_errors").write_text("0\n")
    (nic / "nvlink_errors").write_text("0\n")   # not a GPU: not scanned
    proc = root / "proc/driver/nvidia"
    proc.mkdir(parents=True)
    (proc / "version").write_text(
        "NVRM version: NVIDIA UNIX x86_64 Kernel Module  550.54.15\n"
        "GCC version:  gcc version 12\n")
    dev = tmp_path / "dev_root"
    (dev / "dev").mkdir(parents=True)
    for n in ("nvidia0", "nvidiactl", "accel0"):
        (dev / "dev" / n).write_text("")
    lib = tmp_path / "libnvidia-ml.so.1"
    lib.write_text("")
    monkeypatch.setenv("TPUMON_NVML_SYSFS_ROOT", str(root))
    monkeypatch.setenv("TPUMON_NVML_DEV_ROOT", str(dev))
    monkeypatch.setenv("TPUMON_NVML_PATH", str(lib))

    rep = json.loads(evidence.render(None))
    assert rep["schema"] == evidence.SCHEMA
    assert rep["device_nodes"] == ["/dev/nvidia0", "/dev/nvidiactl"]
    assert [c["pci_bus_id"] for c in rep["chips_sysfs"]] == ["0000:18:00.0"]
    chip = rep["chips_sysfs"][0]
    assert (chip["numa_node"], chip["local_cpulist"]) == ("1", "0-47")
    assert chip["hwmon"] == {"present": False}
    assert rep["driver"].endswith("Kernel Module  550.54.15")
    assert rep["nvml"] == {"found": True, "path": str(lib)}
    scan = rep["nvlink_scan"]
    assert [c["path"] for c in scan["candidates"]] == [
        "/sys/bus/pci/devices/0000:18:00.0/nvlink_errors"]
    assert "families" not in rep


def test_evidence_without_nvidia_surfaces(tmp_path, monkeypatch):
    from tpumon_torch import evidence

    monkeypatch.setenv("TPUMON_NVML_SYSFS_ROOT", str(tmp_path))
    monkeypatch.setenv("TPUMON_NVML_DEV_ROOT", str(tmp_path))
    monkeypatch.setenv("TPUMON_NVML_PATH", str(tmp_path / "absent.so"))
    monkeypatch.setattr("ctypes.util.find_library", lambda name: None)
    rep = evidence.collect()
    assert rep["device_nodes"] == [] and rep["chips_sysfs"] == []
    assert rep["driver"] is None
    assert rep["nvml"] == {"found": False, "path": None}
