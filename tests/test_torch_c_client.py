"""The port's C client (``tpumon_torch/native/client/``: ``libtpumon_client.so``
and ``tpumon-cdemo``) against the port's native agent, on the CPU.

* The reference's own C-client cases (``tests/test_c_client.py``) run
  with the port's library, demo and agent (``run_on_port``): inventory
  and reads, vectors, watches, the connect failure, the demo, events,
  and the C client agreeing with the port's ``AgentBackend``.
* Over NVML (the tests' fake NVML): the C client's record of each card
  equals ``AgentBackend``'s, its reads equal the agent's JSON, and the
  demo prints the card and its rows.
"""

import ctypes
import importlib
import inspect
import subprocess
import sys

import pytest

import test_c_client as REF
from test_torch_agent import (PORT_AGENT, agent_env, build_fake_nvml,
                              spawn_agent, stop_agent)
from test_torch_fleet import run_on_port

from tpumon_torch import _build


def _paths():
    n = _build.native()
    return {"AGENT": str(n["gpu-hostengine"]),
            "CLIENT_SO": str(n["libtpumon_client.so"]),
            "CDEMO": str(n["tpumon-cdemo"])}


REF_CASES = sorted(n for n, v in vars(REF).items()
                   if n.startswith("test_") and callable(v))


@pytest.mark.parametrize("case", REF_CASES)
def test_reference_c_client_case_holds_on_the_port(case, tmp_path,
                                                   monkeypatch):
    names = _paths()
    kwargs = {}
    proc = None
    if "agent_proc" in inspect.signature(getattr(REF, case)).parameters:
        sock = str(tmp_path / "c.sock")
        proc = spawn_agent([names["AGENT"]], sock, "--fake")
        kwargs["agent_proc"] = f"unix:{sock}"
    for name in ("backends.base", "fields", "types"):
        monkeypatch.setitem(sys.modules, "tpumon." + name,
                            importlib.import_module("tpumon_torch." + name))
    try:
        run_on_port(REF, case, monkeypatch, names=names, **kwargs)
    finally:
        if proc is not None:
            stop_agent(proc)


@pytest.fixture(scope="module")
def nvml_agent(tmp_path_factory):
    d = tmp_path_factory.mktemp("cnvml")
    env = agent_env(TPUMON_NVML_PATH=build_fake_nvml(d),
                    TPUMON_KMSG_PATH="/nonexistent", FAKE_NVML_XIDS="0:79")
    sock = str(d / "g.sock")
    proc = spawn_agent([_paths()["AGENT"]], sock, env=env)
    yield f"unix:{sock}"
    stop_agent(proc)


def test_c_client_agrees_with_agent_backend_over_nvml(nvml_agent):
    from tpumon_torch.backends.agent import AgentBackend

    lib = ctypes.CDLL(_paths()["CLIENT_SO"])
    for fn, res, args in (
            ("tpumon_client_connect", ctypes.c_void_p,
             [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int]),
            ("tpumon_client_close", None, [ctypes.c_void_p]),
            ("tpumon_client_chip_count", ctypes.c_int, [ctypes.c_void_p]),
            ("tpumon_client_chip_info", ctypes.c_int,
             [ctypes.c_void_p, ctypes.c_int,
              ctypes.POINTER(REF.ChipInfoStruct)]),
            ("tpumon_client_read_fields", ctypes.c_int,
             [ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int),
              ctypes.c_int, ctypes.POINTER(ctypes.c_double),
              ctypes.POINTER(ctypes.c_ubyte)]),
            ("tpumon_client_read_vector", ctypes.c_int,
             [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
              ctypes.POINTER(ctypes.c_double),
              ctypes.POINTER(ctypes.c_int)])):
        getattr(lib, fn).restype = res
        getattr(lib, fn).argtypes = args
    err = ctypes.create_string_buffer(256)
    c = lib.tpumon_client_connect(nvml_agent.encode(), err, 256)
    assert c, err.value
    py = AgentBackend(address=nvml_agent, connect_retry_s=5.0)
    py.open()
    try:
        assert lib.tpumon_client_chip_count(c) == py.chip_count() == 2
        for i in range(2):
            info = REF.ChipInfoStruct()
            assert lib.tpumon_client_chip_info(c, i, ctypes.byref(info)) == 0
            p = py.chip_info(i)
            assert info.uuid.decode() == p.uuid
            assert info.uuid.decode().startswith("GPU-")
            assert info.name.decode() == p.name == "NVIDIA H100 80GB HBM3"
            assert info.dev_path.decode() == p.dev_path == f"/dev/nvidia{i}"
            assert info.pci_bus_id.decode() == p.pci.bus_id
            assert info.hbm_total_mib == p.hbm.total == 81559
            assert info.power_limit_mw == 700000
            assert info.coord_x == p.coords.x == i
        fids = [150, 155, 203, 251, 51, 463, 253]
        arr = (ctypes.c_int * len(fids))(*fids)
        vals = (ctypes.c_double * len(fids))()
        blanks = (ctypes.c_ubyte * len(fids))()
        assert lib.tpumon_client_read_fields(c, 1, arr, len(fids), vals,
                                             blanks) == 0
        want = py.read_fields(1, fids)
        for k, f in enumerate(fids):
            w = want[f]
            if isinstance(w, (int, float)):
                assert not blanks[k] and vals[k] == w, (f, vals[k], w)
            else:
                assert blanks[k], f  # strings, vectors and blanks
        vec = (ctypes.c_double * 32)()
        n = ctypes.c_int(32)
        assert lib.tpumon_client_read_vector(c, 0, 463, vec,
                                             ctypes.byref(n)) == 0
        assert [vec[i] for i in range(n.value)] == want[463]
    finally:
        py.close()
        lib.tpumon_client_close(c)


def test_cdemo_prints_the_card_over_nvml(nvml_agent):
    r = subprocess.run([_paths()["CDEMO"], nvml_agent, "1"],
                       capture_output=True, text=True, timeout=30)
    assert r.returncode == 0, r.stderr
    out = r.stdout
    assert "chips: 2" in out
    assert ("chip 1: NVIDIA H100 80GB HBM3 "
            "uuid=GPU-00000000-1111-2222-3333-000000000001 hbm=81559 MiB"
            in out)
    rows = [ln.split() for ln in out.splitlines()
            if ln.strip() and ln.strip()[0].isdigit()]
    assert [r[:3] for r in rows] == [["0", "123.5", "41.0"],
                                    ["1", "124.5", "42.0"]]
    assert "seq=1 chip=0 etype=1 Xid 79" in out


def test_python_agent_serves_the_c_client_alike(tmp_path):
    """The port's Python agent answers the C client as the native one
    does: the demo's output over each is the same."""

    env = agent_env(TPUMON_NVML_PATH=build_fake_nvml(tmp_path),
                    TPUMON_KMSG_PATH="/nonexistent")
    outs = []
    for cmd, name in (([_paths()["AGENT"]], "g"), (PORT_AGENT, "p")):
        sock = str(tmp_path / f"{name}.sock")
        proc = spawn_agent(cmd, sock, env=env)
        try:
            r = subprocess.run([_paths()["CDEMO"], f"unix:{sock}", "1"],
                               capture_output=True, text=True, timeout=30)
        finally:
            stop_agent(proc)
        assert r.returncode == 0, r.stderr
        outs.append(r.stdout)
    assert outs[0] == outs[1]
