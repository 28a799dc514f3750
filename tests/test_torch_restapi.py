"""The port's REST API (``tpumon_torch.restapi``) against the JAX
package's, and as a process over the fake NVML.

Both ``RestApi`` objects stand over the scripted backend of
``test_torch_health`` (the same seeded values and events, each package's
own types) and answer the same request sequence; every route and its
``/json`` twin, by index and by UUID, and the 400/404 answers must be
equal byte for byte: status, content type and body.  The monitor's own
process figures (PID, RSS, CPU, uptime) are pinned in both, since they
are this test process's.  ``python -m tpumon_torch.restapi.main`` then
serves the same routes over the fake NVML, importing no torch.
"""

import http.client
import json
import os
import subprocess
import sys
import time
import types

import pytest

import tpumon
import tpumon_torch
from tpumon.restapi.server import RestApi as JaxRestApi
from tpumon_torch.restapi.server import RestApi, RestApiServer

from test_torch_health import CHIPS, STEPS, T0, pair
from test_torch_nvml import _build

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _Mon:
    def status(self):
        return types.SimpleNamespace(memory_kb=20480.0, cpu_percent=1.5,
                                     pid=4242, uptime_s=12.5)


def _apis(seed=0):
    b, jb = pair(seed)
    h = tpumon_torch.Handle(b, clock=lambda: T0)
    jh = tpumon.Handle(jb, clock=lambda: T0)
    h.self_monitor = jh.self_monitor = _Mon()
    return (RestApi(h, process_warmup_s=0.0),
            JaxRestApi(jh, process_warmup_s=0.0), (b, jb))


def routes():
    out = ["/tpu/status", "/tpu/status/json", "/tpu/status/"]
    for c in range(CHIPS):
        uuid = f"GPU-scripted-{c}"
        for kind in ("device/info", "device/status", "health"):
            out += [f"/tpu/{kind}/{c}", f"/tpu/{kind}/json/{c}",
                    f"/tpu/{kind}/uuid/{uuid}", f"/tpu/{kind}/json/uuid/{uuid}"]
        out += [f"/tpu/device/topology/{c}", f"/tpu/device/topology/json/{c}"]
    return out


#: the 400s and 404s: bad ids, unknown ids and uuids, unknown routes
BAD = ["/tpu/device/info/x", "/tpu/device/info/json/-1",
       "/tpu/device/status/7", "/tpu/device/status/json/uuid/GPU-nope",
       "/tpu/health/1x", "/tpu/health/uuid/nope", "/tpu/device/topology/9",
       "/tpu/process/info/pid/abc", "/tpu/process/info/json/pid/4x",
       "/tpu/process/info/pid/1", "/tpu/process/info/json/pid/1",
       "/tpu/nope", "/", "/tpu/device/info/0/extra"]


def test_every_route_equals_the_reference_bytes():
    ours, ref, backends = _apis()
    assert ours.uuid_map == ref.uuid_map
    for step in range(STEPS - 1):
        for b in backends:
            b.advance()
        for path in routes() + BAD:
            got, want = ours.dispatch(path), ref.dispatch(path)
            assert got == want, (step, path)
            if path.startswith("/tpu/") and "/json" in path and \
                    got[0] == 200:
                json.loads(got[2])


@pytest.mark.parametrize("path,code", [
    ("/tpu/device/info/x", 400), ("/tpu/device/status/7", 404),
    ("/tpu/health/uuid/nope", 404), ("/tpu/process/info/pid/abc", 400),
    ("/tpu/process/info/pid/1", 404), ("/tpu/nope", 404)])
def test_validation_answers(path, code):
    ours, ref, _ = _apis()
    got = ours.dispatch(path)
    assert got == ref.dispatch(path)
    assert got[0] == code and got[1] == "text/plain; charset=utf-8"


def test_health_json_agrees_with_the_handle():
    ours, _, (b, _) = _apis(2)
    h = ours.h
    for _ in range(STEPS - 1):
        b.advance()
    for c in range(CHIPS):
        h.health_set(c)
    b.step = 3  # the thermal FAIL step, checked by the API then the handle
    body = json.loads(ours.dispatch("/tpu/health/json/0")[2])
    assert body["status"] == "FAIL"
    res = h.health_check(0)
    assert body["status"] == res.status.name
    assert [(i["system"], i["status"], i["message"])
            for i in body["incidents"]] == [
        (i.system.name, i.status.name, i.message) for i in res.incidents]


def _get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    try:
        conn.request("GET", path)
        r = conn.getresponse()
        return r.status, r.getheader("Content-Type"), r.read().decode()
    finally:
        conn.close()


def test_server_serves_the_dispatch_over_http():
    ours, ref, _ = _apis()
    srv = RestApiServer(ours, port=0, bind="127.0.0.1")
    srv.start()
    try:
        for path in ["/tpu/status/json", "/tpu/device/info/1",
                     "/tpu/device/status/json/2", "/tpu/device/info/x",
                     "/tpu/nope?x=1"]:
            assert _get(srv.port, path) == ref.dispatch(path.split("?")[0])
    finally:
        srv.stop()


# ---- the service over the fake NVML -------------------------------------------

@pytest.fixture(scope="module")
def fake_lib(tmp_path_factory):
    return _build(tmp_path_factory.mktemp("nvml_rest"), "libfake_nvml.so")


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_restapi_main_over_nvml(fake_lib, tmp_path):
    env = dict(os.environ, TPUMON_NVML_PATH=fake_lib,
               TPUMON_KMSG_PATH=str(tmp_path / "no-kmsg"), PYTHONPATH=REPO)
    env.pop("TPUMON_BACKEND", None)
    port = _free_port()
    probe = ("import runpy, sys, threading, time\n"
             "def report():\n"
             "    time.sleep(1.5)\n"
             "    print('torch' in sys.modules, 'jax' in sys.modules,"
             " flush=True)\n"
             "threading.Thread(target=report, daemon=True).start()\n"
             "sys.argv = ['tpumon-restapi', '-p', sys.argv[1],"
             " '--process-warmup', '0.2']\n"
             "runpy.run_module('tpumon_torch.restapi.main',"
             " run_name='__main__')\n")
    proc = subprocess.Popen([sys.executable, "-c", probe, str(port)],
                            cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        assert proc.stdout.readline().startswith(
            "tpumon-restapi listening on :")
        got = {}
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            try:
                got["status"] = _get(port, "/tpu/status/json")
                break
            except OSError:
                time.sleep(0.1)
        for path in ["/tpu/device/info/0", "/tpu/device/info/json/1",
                     "/tpu/device/status/json/0", "/tpu/device/topology/0",
                     "/tpu/health/json/1", "/tpu/health/0",
                     "/tpu/process/info/json/pid/1", "/tpu/device/info/x",
                     "/tpu/device/status/5"]:
            got[path] = _get(port, path)
        assert proc.stdout.readline().split() == ["False", "False"]
    finally:
        proc.terminate()
        out, err = proc.communicate(timeout=30)
    assert proc.returncode == 0, err
    st = json.loads(got["status"][2])
    assert st["engine"] == "embedded" and st["chips"] == 2
    assert "Model                  : NVIDIA H100 80GB HBM3" in \
        got["/tpu/device/info/0"][2]
    info = json.loads(got["/tpu/device/info/json/1"][2])
    assert info["uuid"].startswith("GPU-") and info["index"] == 1
    assert json.loads(got["/tpu/device/status/json/0"][2])["power_w"] == \
        123.456
    assert json.loads(got["/tpu/health/json/1"][2]) == {
        "chip_index": 1, "status": "PASS", "incidents": []}
    assert got["/tpu/health/0"][2].startswith(
        "---------- Chip 0 Health ----------\nOverall                : WARN")
    assert got["/tpu/process/info/json/pid/1"][0] == 404
    assert got["/tpu/device/info/x"][0] == 400
    assert got["/tpu/device/status/5"] == (404, "text/plain; charset=utf-8",
                                           "no such chip: 5\n")
