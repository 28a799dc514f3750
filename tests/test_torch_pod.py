"""The port's pod attribution on the CPU: the kubelet pod-resources codec
and transport, the device lookup, the label splice and the standalone
pod-attribution daemon, held to ``tpumon.exporter``'s on the same inputs.

What differs is the device: the port looks a GPU up by NVML's ``GPU-…``
UUID, then by ``nvidia<i>`` and ``<i>``; the reference by its chip UUID,
then by ``tpu-<i>``, ``tpu<i>`` and ``<i>``.  The kubelet filter defaults
to ``nvidia.com/gpu``.
"""

import http.client
import json
import os
import signal
import subprocess
import sys
import tempfile
import time
from concurrent import futures

import pytest

from tpumon.exporter import pod_attrib as JA
from tpumon.exporter import podresources as JR
from tpumon_torch.exporter import pod_attrib as TA
from tpumon_torch.exporter import podresources as TR

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
UUID0 = "GPU-5a3c2f7e-0b1d-4e62-9f1a-0c7d2e4b8a10"
UUID1 = "GPU-5a3c2f7e-0b1d-4e62-9f1a-0c7d2e4b8a11"
SAMPLE_TEXT = f"""\
# HELP tpu_power_usage Chip power draw in watts.
# TYPE tpu_power_usage gauge
tpu_power_usage{{chip="0",uuid="{UUID0}",model="NVIDIA H100 80GB HBM3"}} 81.5
tpu_power_usage{{chip="1",uuid="{UUID1}",model="NVIDIA H100 80GB HBM3"}} 92.1
tpumon_exporter_sweeps_total{{host="h"}} 3
"""
PODS = [
    ("train-abc", "ml", [("worker", "nvidia.com/gpu", [UUID0, UUID1]),
                         ("side", "example.com/nic", ["nic-0"])]),
    ("other", "default", [("c", "google.com/tpu", ["tpu-0"])]),
    ("ünïcode", "ns-é", [("c", "nvidia.com/gpu", ["GPU-" + "f" * 36])]),
]


def _map_file(tmp_path, mapping, name="map.json"):
    path = tmp_path / name
    path.write_text(json.dumps(
        {k: {"pod": p, "namespace": n, "container": c}
         for k, (p, n, c) in mapping.items()}))
    return str(path)


# ---- the protobuf codec ------------------------------------------------------

def test_codec_bytes_and_parse_match_reference():
    ours, ref = TR.encode_pod_resources(PODS), JR.encode_pod_resources(PODS)
    assert ours == ref
    got_dev, got_res = TR.parse_list_response(ours)
    want_dev, want_res = JR.parse_list_response(ref)
    assert {k: tuple(vars(v).values()) for k, v in got_dev.items()} == \
        {k: tuple(vars(v).values()) for k, v in want_dev.items()}
    assert got_res == want_res
    assert got_dev[UUID1] == TR.PodInfo("train-abc", "ml", "worker")
    assert got_res["tpu-0"] == "google.com/tpu"


def test_truncated_response_raises_like_reference():
    data = TR.encode_pod_resources(PODS)
    for cut in (1, 7, len(data) // 2, len(data) - 1):
        with pytest.raises(ValueError):
            JR.parse_list_response(data[:cut])
        with pytest.raises(ValueError):
            TR.parse_list_response(data[:cut])


def test_default_resource_is_nvidias_and_env_overrides(monkeypatch):
    assert TR.DEFAULT_RESOURCE == "nvidia.com/gpu"
    assert JR.DEFAULT_RESOURCE == "google.com/tpu"
    monkeypatch.delenv("TPUMON_POD_RESOURCE", raising=False)
    assert TA.PodAttributor(map_file="/x").resource == "nvidia.com/gpu"
    monkeypatch.setenv("TPUMON_POD_RESOURCE", "nvidia.com/mig-1g.10gb")
    assert TA.PodAttributor(map_file="/x").resource == \
        "nvidia.com/mig-1g.10gb"


# ---- the kubelet transport ---------------------------------------------------

def _fake_kubelet(payload):
    grpc = pytest.importorskip("grpc")

    class FakeKubelet(grpc.GenericRpcHandler):
        def service(self, handler_call_details):
            if handler_call_details.method == "/v1alpha1.PodResources/List":
                return grpc.unary_unary_rpc_method_handler(
                    lambda req, ctx: payload,
                    request_deserializer=lambda b: b,
                    response_serializer=lambda b: b)
            return None

    sock = tempfile.mktemp(prefix="kubelet-test-", suffix=".sock")
    server = grpc.server(futures.ThreadPoolExecutor(max_workers=2))
    server.add_generic_rpc_handlers((FakeKubelet(),))
    server.add_insecure_port(f"unix://{sock}")
    server.start()
    return server, sock


@pytest.mark.parametrize("transport", ["minimal", "grpcio"])
def test_kubelet_round_trip_matches_reference(transport, monkeypatch):
    """The port's and the reference's client against one fake kubelet,
    over the stdlib HTTP/2 client and over the grpc package."""

    server, sock = _fake_kubelet(TR.encode_pod_resources(PODS))
    if transport == "grpcio":
        monkeypatch.setenv("TPUMON_GRPC_TRANSPORT", "grpcio")
    else:
        monkeypatch.delenv("TPUMON_GRPC_TRANSPORT", raising=False)
    try:
        got_dev, got_res = TR.list_pod_resources(sock, timeout_s=5.0)
        want_dev, want_res = JR.list_pod_resources(sock, timeout_s=5.0)
    finally:
        server.stop(0)
    assert got_res == want_res
    assert {k: (v.pod, v.namespace, v.container)
            for k, v in got_dev.items()} == \
        {k: (v.pod, v.namespace, v.container) for k, v in want_dev.items()}
    assert got_dev[UUID0] == TR.PodInfo("train-abc", "ml", "worker")


def test_minimal_transport_carries_a_large_response():
    pods = [(f"pod-{i:05d}", "ml",
             [(f"worker-{i}", "nvidia.com/gpu",
               [f"GPU-{i:08d}-{j}" for j in range(4)])])
            for i in range(4000)]
    payload = TR.encode_pod_resources(pods)
    assert len(payload) > 256 * 1024
    server, sock = _fake_kubelet(payload)
    try:
        devices, resources = TR.list_pod_resources(sock, timeout_s=30.0)
    finally:
        server.stop(0)
    assert len(devices) == 16000
    assert devices["GPU-00000123-2"].pod == "pod-00123"
    assert resources["GPU-00003999-3"] == "nvidia.com/gpu"


def test_minimal_transport_unreachable_socket_raises():
    from tpumon_torch.exporter.grpc_min import unary_call

    with pytest.raises(OSError):
        unary_call("/nonexistent/kubelet.sock",
                   "/v1alpha1.PodResources/List", b"", timeout_s=1.0)


def test_kubelet_map_filters_to_gpus_and_survives_a_restart(monkeypatch):
    server, sock = _fake_kubelet(TR.encode_pod_resources(PODS))
    monkeypatch.delenv("TPUMON_POD_RESOURCE", raising=False)
    monkeypatch.delenv("TPUMON_POD_MAP_FILE", raising=False)
    att = TA.PodAttributor(socket_path=sock, refresh_s=0.0)
    try:
        first = att.device_map()
    finally:
        server.stop(0)
    assert set(first) == {UUID0, UUID1, "GPU-" + "f" * 36}
    # kubelet gone: the previous map stays, labels must not flap
    assert att.device_map() == first


# ---- lookup and enrich -------------------------------------------------------

@pytest.mark.parametrize("key,chip,want", [
    (UUID0, "0", True), ("nvidia0", "0", True), ("0", "0", True),
    ("nvidia1", "0", False), ("tpu-0", "0", False), ("tpu0", "0", False),
    (UUID1, "0", False)])
def test_lookup_by_uuid_then_index_conventions(tmp_path, key, chip, want):
    att = TA.PodAttributor(map_file=_map_file(
        tmp_path, {key: ("p", "n", "c")}))
    info = att.lookup(att.device_map(), UUID0, chip)
    assert (info == TA.PodInfo("p", "n", "c")) if want else info is None


def test_uuid_wins_over_index(tmp_path):
    att = TA.PodAttributor(map_file=_map_file(
        tmp_path, {"0": ("by-index", "n", "c"), UUID0: ("by-uuid", "n", "c")}))
    assert att.lookup(att.device_map(), UUID0, "0").pod == "by-uuid"


def test_enrich_by_uuid_matches_reference(tmp_path):
    mf = _map_file(tmp_path, {UUID0: ("train-abc", "ml", "worker")})
    ours = TA.PodAttributor(map_file=mf).enrich(SAMPLE_TEXT)
    assert ours == JA.PodAttributor(map_file=mf).enrich(SAMPLE_TEXT)
    assert (f'tpu_power_usage{{chip="0",uuid="{UUID0}",model="NVIDIA H100 '
            '80GB HBM3",pod_name="train-abc",pod_namespace="ml",'
            'container_name="worker"} 81.5') in ours
    assert f'chip="1",uuid="{UUID1}",model="NVIDIA H100 80GB HBM3"}} 92.1' \
        in ours
    assert 'tpumon_exporter_sweeps_total{host="h"} 3' in ours


def test_enrich_by_index_conventions(tmp_path):
    mf = _map_file(tmp_path, {"nvidia1": ("p1", "n", "c"),
                              "0": ("p0", "n", "c")})
    out = TA.PodAttributor(map_file=mf).enrich(SAMPLE_TEXT)
    assert 'chip="0",uuid="' + UUID0 + '",model="NVIDIA H100 80GB HBM3",' \
        'pod_name="p0"' in out
    assert 'pod_name="p1"' in out.splitlines()[3]


def test_the_index_keys_are_the_devices(tmp_path):
    """The reference's ``tpu-<i>`` key attributes nothing in the port, and
    the port's ``nvidia<i>`` nothing in the reference: the one difference
    between the two lookups is the device's naming."""

    tpu = _map_file(tmp_path, {"tpu-1": ("p", "n", "c")}, "tpu.json")
    gpu = _map_file(tmp_path, {"nvidia1": ("p", "n", "c")}, "gpu.json")
    assert TA.PodAttributor(map_file=tpu).enrich(SAMPLE_TEXT) == SAMPLE_TEXT
    assert JA.PodAttributor(map_file=gpu).enrich(SAMPLE_TEXT) == SAMPLE_TEXT
    assert 'pod_name="p"' in JA.PodAttributor(map_file=tpu).enrich(
        SAMPLE_TEXT)
    assert 'pod_name="p"' in TA.PodAttributor(map_file=gpu).enrich(
        SAMPLE_TEXT)


@pytest.mark.parametrize("payload", ['{"nvidia0": "pod-a"}', '["x"]', "42",
                                     '{"nvidia0": {"pod": ', ""])
def test_map_file_failure_keeps_the_previous_map(tmp_path, payload):
    mf = _map_file(tmp_path, {UUID0: ("train-abc", "ml", "worker")})
    att = TA.PodAttributor(map_file=mf, refresh_s=0.0)
    ref = JA.PodAttributor(map_file=mf, refresh_s=0.0)
    good = att.enrich(SAMPLE_TEXT)
    assert 'pod_name="train-abc"' in good and ref.enrich(SAMPLE_TEXT) == good
    with open(mf, "w") as f:
        f.write(payload)
    assert att.enrich(SAMPLE_TEXT) == good == ref.enrich(SAMPLE_TEXT)
    # a fresh attributor has no previous map: unenriched, not a crash
    assert TA.PodAttributor(map_file=mf).enrich(SAMPLE_TEXT) == SAMPLE_TEXT


def test_empty_map_is_identity(tmp_path):
    att = TA.PodAttributor(map_file=str(tmp_path / "missing.json"))
    assert att.enrich(SAMPLE_TEXT) == SAMPLE_TEXT


# ---- the standalone pod-attribution daemon -----------------------------------

def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=2)
    try:
        conn.request("GET", path)
        r = conn.getresponse()
        return r.status, r.read().decode()
    finally:
        conn.close()


def _pod_main(args, env):
    return subprocess.Popen(
        [sys.executable, "-m", "tpumon_torch.exporter.pod_main", *args],
        cwd=REPO, env=env, stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE, text=True)


def test_pod_daemon_publishes_serves_and_follows_renames(tmp_path):
    inp, outp = tmp_path / "gpu.prom", tmp_path / "gpu-pod.prom"
    mf = _map_file(tmp_path, {UUID0: ("pd", "ns", "ct")})
    inp.write_text(SAMPLE_TEXT)
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=REPO, TPUMON_POD_MAP_FILE=mf)
    proc = _pod_main(["--input", str(inp), "--output", str(outp),
                      "--port", str(port), "--poll", "0.05"], env)
    try:
        deadline = time.monotonic() + 20
        body = ""
        while time.monotonic() < deadline and 'pod_name="pd"' not in body:
            try:
                body = _get(port, "/gpu/metrics")[1]
            except OSError:
                time.sleep(0.1)
        want = TA.PodAttributor(map_file=mf).enrich(SAMPLE_TEXT)
        assert body == want == outp.read_text()
        assert _get(port, "/tpu/metrics") == (200, want)
        assert _get(port, "/metrics") == (200, want)
        assert _get(port, "/nope")[0] == 404
        # a producer's atomic rename flows through
        tmp = tmp_path / "gpu.prom.tmp"
        tmp.write_text(SAMPLE_TEXT.replace("81.5", "99.9"))
        os.replace(tmp, inp)
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and "99.9" not in body:
            body = _get(port, "/gpu/metrics")[1]
            time.sleep(0.05)
        assert "99.9" in body and 'pod_name="pd"' in body
        assert outp.read_text() == body
        proc.send_signal(signal.SIGINT)
        assert proc.wait(timeout=10) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def test_pod_daemon_watchdog_exits_without_input(tmp_path):
    inp = tmp_path / "gpu.prom"
    inp.write_text(SAMPLE_TEXT)
    env = dict(os.environ, PYTHONPATH=REPO,
               TPUMON_POD_MAP_FILE=str(tmp_path / "none.json"))
    proc = _pod_main(["--input", str(inp), "--output",
                      str(tmp_path / "out.prom"), "--port", str(_free_port()),
                      "--poll", "0.05", "--watchdog", "0.5"], env)
    try:
        assert proc.wait(timeout=20) == 1
        assert "no metric updates" in proc.stderr.read()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def test_pod_daemon_oneshot(tmp_path):
    inp = tmp_path / "in.prom"
    inp.write_text(SAMPLE_TEXT)
    mf = _map_file(tmp_path, {"nvidia0": ("p0", "n", "c")})
    env = dict(os.environ, PYTHONPATH=REPO, TPUMON_POD_MAP_FILE=mf)
    r = subprocess.run(
        [sys.executable, "-m", "tpumon_torch.exporter.pod_main",
         "--input", str(inp), "--output", str(tmp_path / "out.prom"),
         "--oneshot"], capture_output=True, text=True, env=env, cwd=REPO,
        timeout=60)
    assert r.returncode == 0, r.stderr
    assert r.stdout == (tmp_path / "out.prom").read_text()
    assert 'pod_name="p0"' in r.stdout.splitlines()[2]
    bad = subprocess.run(
        [sys.executable, "-m", "tpumon_torch.exporter.pod_main",
         "--input", str(tmp_path / "missing.prom"), "--output",
         str(tmp_path / "o.prom"), "--oneshot"], capture_output=True,
        text=True, env=env, cwd=REPO, timeout=60)
    assert bad.returncode == 1 and "cannot read" in bad.stderr
