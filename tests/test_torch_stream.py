"""The port's live stream plane (``tpumon_torch.frameserver``, the
exporter's tee, ``--stream-port`` and ``tpumon_torch.cli.stream``)
against the JAX package's.

Both ``StreamPublisher``s are driven through the same seeded sweep
sequence (``test_torch_blackbox._sweeps``: churning values, blanks, a
chip lost for a while, Xid events, anomaly findings) on a loop stand-in
that runs the fan-out inline and lets a subscriber be wedged (its sends
queue as unsent bytes) and drained; each subscriber's bytes must be
identical between the packages — one attached from the start, one that
attaches late (its first item a keyframe), and one that wedges past a
small ``max_buffer_bytes``, goes stale, and resyncs on a keyframe once
drained — and the counters too.  Over real sockets the same bytes reach
a JSON-op subscriber and a ``GET /stream`` one, and the reference's and
the port's stream CLIs print the same lines.  The exporter's tee is held
to the reference's on the same sweeps, and the daemon serves
``--stream-port`` over the fake NVML without importing torch.
"""

import json
import os
import socket
import subprocess
import sys
import threading
import time

import pytest

import tpumon
import tpumon_torch
from tpumon import blackbox as JBB
from tpumon import events as JEV
from tpumon import frameserver as JFS
from tpumon import types as JT
from tpumon.backends.base import Backend as JaxBackend
from tpumon.exporter import exporter as JE
from tpumon_torch import blackbox as TBB
from tpumon_torch import events as TEV
from tpumon_torch import frameserver as TFS
from tpumon_torch import _codec as TC
from tpumon_torch import types as TT
from tpumon_torch.backends.base import Backend
from tpumon_torch.exporter import exporter as TE

from test_torch_blackbox import T0, _events, _finding, _sweeps
from test_torch_exporter import without_timings
from test_torch_monitor import _stub_backend, _values
from test_torch_nvml import _build


@pytest.fixture(autouse=True)
def _python_codec(monkeypatch):
    """Both packages' renders on their Python codecs: the
    ``tpumon_codec_native`` gauge reads which codec is loaded, and the
    port's native one (``tests/test_torch_codec_native.py``) may be."""

    monkeypatch.setattr(TC, "lib", None)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def value(text, family):
    """The value of a family's one sample in an exposition."""

    for ln in text.splitlines():
        if ln.split("{", 1)[0] == family:
            return float(ln.rsplit(" ", 1)[1])
    return None


def without_sizes(text):
    """The exposition without the timing families and the body's own
    size, whose digits follow the timings'."""

    return "\n".join(ln for ln in without_timings(text).split("\n")
                     if "tpumon_exporter_scrape_bytes" not in ln)
#: the wedged subscriber's buffer: two or three steady frames
WEDGE_BUFFER = 600


class LoopStub:
    """The publisher's loop-thread surface, inline: ``run_on_loop`` runs
    at once, and ``send`` delivers to the connection's ``out`` unless it
    is wedged, where the bytes queue as unsent (``queued_bytes``)."""

    def run_on_loop(self, fn):
        fn()

    def send(self, conn, data, close_after=False):
        if conn.data.get("wedged"):
            conn.data["pending"].append(data)
            conn.queued_bytes += len(data)
        else:
            conn.data["out"] += data

    @staticmethod
    def drain(conn):
        conn.data["out"] += b"".join(conn.data["pending"])
        conn.data["pending"].clear()
        conn.queued_bytes = 0
        conn.data["wedged"] = False


def _conn(fs):
    c = fs.FrameConn(None, None, "stub")
    c.data.update(out=bytearray(), pending=[], wedged=False)
    return c


def drive(fs, bb, ev, seed):
    """One package's publishers through the scenario; each subscriber's
    bytes and the counters."""

    stub = LoopStub()
    pub = fs.StreamPublisher(stub, "", max_buffer_bytes=1 << 20)
    tight = fs.StreamPublisher(stub, "tight", max_buffer_bytes=WEDGE_BUFFER)
    early, late, wedge = _conn(fs), _conn(fs), _conn(fs)
    pub._attach(early, b"")
    tight._attach(wedge, b"")
    for k, (ts, snap) in enumerate(_sweeps(seed, n=24)):
        if k == 9:
            pub._attach(late, fs._HTTP_OK)
        if k == 4:
            wedge.data["wedged"] = True
        if k == 15:
            stub.drain(wedge)
        for p in (pub, tight):
            p.publish(snap, events=_events(ev, k), now=ts)
            if k % 6 == 5:
                p.publish_record(bb.encode_finding(_finding(bb, k)))
    return ({"early": bytes(early.data["out"]),
             "late": bytes(late.data["out"]),
             "wedge": bytes(wedge.data["out"])},
            pub.stats(), tight.stats())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_publisher_bytes_equal_the_reference(seed):
    got = drive(TFS, TBB, TEV, seed)
    want = drive(JFS, JBB, JEV, seed)
    assert got == want
    subs, stats, tight = got
    assert stats["subscribers"] == 2 and stats["keyframes_total"] == 2
    # the wedge: stale, frames dropped, one resync on a keyframe
    assert tight["overflows_total"] >= 1 and tight["resyncs_total"] == 2
    assert tight["dropped_frames_total"] > 0


def decode(data):
    dec = TFS.StreamDecoder()
    items = dec.feed(data)
    return dec, items


def test_decoded_streams_are_the_published_sweeps():
    subs, _, _ = drive(TFS, TBB, TEV, 4)
    sweeps = _sweeps(4, n=24)
    dec, items = decode(subs["early"])
    ticks = [i for i in items if isinstance(i, TBB.ReplayTick)]
    assert dec.header == (1, 0.0, "")
    assert [(t.timestamp, t.snapshot) for t in ticks] == sweeps
    assert [t.keyframe for t in ticks] == [True] + [False] * 23
    assert [t.events[0].message for t in ticks if t.events] == [
        f"Xid 79 at {k}" for k in range(24) if k % 7 == 3]
    assert [i.timestamp for i in items
            if isinstance(i, TBB.AnomalyRecord)] == [T0 + 5, T0 + 11,
                                                     T0 + 17, T0 + 23]
    # the late subscriber: HTTP head, then its first tick is a keyframe
    # equal to the sweep it attached after
    head = TFS._HTTP_OK
    assert subs["late"].startswith(head)
    dec, items = decode(subs["late"][len(head):])
    ticks = [i for i in items if isinstance(i, TBB.ReplayTick)]
    assert ticks[0].keyframe and (ticks[0].timestamp,
                                  ticks[0].snapshot) == sweeps[8]
    assert [(t.timestamp, t.snapshot) for t in ticks[1:]] == sweeps[9:]
    # the wedged one: ticks until it filled, then a keyframe resync
    # after the drain, then every sweep again
    dec, items = decode(subs["wedge"])
    ticks = [i for i in items if isinstance(i, TBB.ReplayTick)]
    kf = [k for k, t in enumerate(ticks) if t.keyframe]
    assert len(kf) == 2 and dec.keyframes == 2
    after = ticks[kf[1]:]
    assert [(t.timestamp, t.snapshot) for t in after] == \
        sweeps[len(sweeps) - len(after):]
    assert len(ticks) < len(sweeps)  # frames were dropped while stale


# ---- over sockets ----------------------------------------------------------------

def _server(fs):
    srv = fs.FrameServer()
    hub = fs.StreamHub(srv)
    addr = srv.add_tcp_listener(hub, host="127.0.0.1", port=0)
    pub = hub.publisher("")
    srv.start()
    return srv, hub, pub, int(addr.rsplit(":", 1)[1])


def barrier(srv):
    done = threading.Event()
    srv.run_on_loop(done.set)
    assert done.wait(5.0)


def _recv_all(sock):
    sock.settimeout(5.0)
    out = bytearray()
    while True:
        chunk = sock.recv(65536)
        if not chunk:
            return bytes(out)
        out += chunk


def wait_subscribers(pub, n, timeout=10.0):
    deadline = time.monotonic() + timeout
    while pub.subscribers < n:
        assert time.monotonic() < deadline, pub.subscribers
        time.sleep(0.01)


def test_socket_subscribers_get_the_publisher_bytes():
    srv, hub, pub, port = _server(TFS)
    try:
        op = socket.create_connection(("127.0.0.1", port))
        op.sendall(b'{"op": "stream"}\n')
        http = socket.create_connection(("127.0.0.1", port))
        http.sendall(b"GET /stream HTTP/1.1\r\nHost: x\r\n\r\n")
        wait_subscribers(pub, 2)
        for k, (ts, snap) in enumerate(_sweeps(5, n=12)):
            pub.publish(snap, events=_events(TEV, k), now=ts)
            barrier(srv)
        bad = socket.create_connection(("127.0.0.1", port))
        bad.sendall(b"GET /nope HTTP/1.1\r\n\r\n")
        bad_reply = _recv_all(bad)
        unknown = socket.create_connection(("127.0.0.1", port))
        unknown.sendall(b'{"op": "stream", "stream": "x"}\n')
        unknown_reply = _recv_all(unknown)
    finally:
        srv.close()
    got_op, got_http = _recv_all(op), _recv_all(http)
    for s in (op, http, bad, unknown):
        s.close()
    want = drive_plain(TFS, 5, 12)
    assert got_op == want
    assert got_http == TFS._HTTP_OK + want
    assert bad_reply.startswith(b"HTTP/1.1 404 Not Found\r\n")
    assert json.loads(unknown_reply) == {
        "ok": False, "error": "unknown stream 'x' (streams: <none>)"}


def drive_plain(fs, seed, n, record_at=None):
    """The bytes one subscriber attached from the start gets, through the
    loop stand-in (a finding after sweep ``record_at``)."""

    stub = LoopStub()
    pub = fs.StreamPublisher(stub, "")
    c = _conn(fs)
    pub._attach(c, b"")
    for k, (ts, snap) in enumerate(_sweeps(seed, n=n)):
        pub.publish(snap, events=_events(TEV if fs is TFS else JEV, k),
                    now=ts)
        if k == record_at:
            pub.publish_record(TBB.encode_finding(_finding(TBB, k)))
    return bytes(c.data["out"])


@pytest.mark.parametrize("fmt", ["json", "table", "promtext"])
def test_stream_cli_output_equals_the_reference(fmt):
    """Both CLIs attached from the start print the same lines for the
    same stream, up to the server's close."""

    srv, hub, pub, port = _server(TFS)
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    procs = [subprocess.Popen(
        [sys.executable, "-m", f"{pkg}.cli.stream", "--connect",
         f"127.0.0.1:{port}", "--format", fmt],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for pkg in ("tpumon", "tpumon_torch")]
    try:
        wait_subscribers(pub, 2, timeout=60.0)
        for k, (ts, snap) in enumerate(_sweeps(6, n=8)):
            pub.publish(snap, events=_events(TEV, k), now=ts)
            if k == 5:
                pub.publish_record(TBB.encode_finding(_finding(TBB, k)))
            barrier(srv)
        srv.close()
        outs = [p.communicate(timeout=60) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        srv.close()
    assert [p.returncode for p in procs] == [0, 0], outs
    assert outs[1] == outs[0]
    assert outs[1][1] == "# stream closed by server\n"
    marker = {"json": '"kind": "tick"', "table": "# snapshot at",
              "promtext": "# TYPE tpu_core_temp gauge"}[fmt]
    assert outs[1][0].count(marker) == 8


class _OneSend(threading.Thread):
    """A server that answers one subscriber with the whole of ``data`` in
    one send, so every frame reaches the client in one chunk."""

    def __init__(self, data):
        super().__init__(daemon=True)
        self.data = data
        self.sock = socket.socket()
        self.sock.bind(("127.0.0.1", 0))
        self.sock.listen(1)
        self.port = self.sock.getsockname()[1]

    def run(self):
        conn, _ = self.sock.accept()
        with conn:
            conn.recv(4096)
            conn.sendall(self.data)
            time.sleep(1.0)
        self.sock.close()


@pytest.mark.parametrize("count", [1, 3, 8])
def test_stream_cli_count_is_ticks_printed(count):
    """``--count N`` prints N ticks when the frames arrive together (one
    chunk): the finding record between them is printed and not counted."""

    data = drive_plain(TFS, 8, 10, record_at=1)
    srv = _OneSend(data)
    srv.start()
    r = subprocess.run([sys.executable, "-m", "tpumon_torch.cli.stream",
                        "--connect", f"127.0.0.1:{srv.port}", "--format",
                        "json", "--count", str(count)], cwd=REPO,
                       capture_output=True, text=True, timeout=60,
                       env=dict(os.environ, PYTHONPATH=REPO))
    srv.join(5)
    assert r.returncode == 0, r.stderr
    kinds = [json.loads(ln)["kind"] for ln in r.stdout.splitlines()]
    assert kinds.count("tick") == count
    assert ("anomaly" in kinds) == (count > 2)


def test_stream_cli_refuses_an_unknown_stream():
    srv, hub, pub, port = _server(TFS)
    try:
        r = subprocess.run([sys.executable, "-m", "tpumon_torch.cli.stream",
                            "--connect", f"127.0.0.1:{port}", "--stream",
                            "nope", "--count", "1"], cwd=REPO,
                           capture_output=True, text=True, timeout=60,
                           env=dict(os.environ, PYTHONPATH=REPO))
    finally:
        srv.close()
    assert r.returncode == 1 and "unknown stream 'nope'" in r.stderr


# ---- the exporter's tee ----------------------------------------------------------

RULES = {"version": 1, "detectors": [
    {"name": "busy", "field": 203, "type": "threshold", "above": -1}]}


def test_exporter_tee_equals_the_reference(tmp_path):
    """The sweep tees snapshot and findings to the publisher right after
    the recorder, as the reference's does: the subscriber's bytes, the
    ``stream`` phase and the ``tpumon_stream_*`` families."""

    from tpumon import anomaly as JA
    from tpumon_torch import anomaly as TA

    out = {}
    for name, pkg, base, types_, fs, an, exp_mod in (
            ("ours", tpumon_torch, Backend, TT, TFS, TA, TE),
            ("ref", tpumon, JaxBackend, JT, JFS, JA, JE)):
        values = {c: _values(c) for c in range(2)}
        h = pkg.Handle(_stub_backend(base, types_, values))
        exp = exp_mod.TpuExporter(
            h, output_path=None, rules=an.Rules.from_dict(RULES),
            blackbox_dir=str(tmp_path / name))
        stub = LoopStub()
        pub = fs.StreamPublisher(stub, "")
        c = _conn(fs)
        pub._attach(c, b"")
        exp.set_stream_publisher(pub)
        texts = []
        try:
            for k in range(3):
                for ch in range(2):
                    values[ch].update(_values(ch + k))
                texts.append(exp.sweep(now=T0 + k))
                phases = (exp.sweep_phases() if name == "ours"
                          else exp._last_phases)
                assert "stream" in phases
        finally:
            exp.stop()
        out[name] = (bytes(c.data["out"]), [without_sizes(t)
                                             for t in texts])
    assert out["ours"] == out["ref"]
    last = out["ours"][1][-1]
    assert value(last, "tpumon_stream_subscribers") == 1
    assert value(last, "tpumon_stream_frames_sent_total") == 3
    assert value(last, "tpumon_stream_keyframes_total") == 1
    dec, items = decode(out["ours"][0])
    assert [type(i).__name__ for i in items] == [
        "ReplayTick", "AnomalyRecord", "AnomalyRecord", "ReplayTick",
        "ReplayTick"]


# ---- the daemon with --stream-port over the fake NVML ------------------------------

@pytest.fixture(scope="module")
def fake_lib(tmp_path_factory):
    return _build(tmp_path_factory.mktemp("nvml_stream"), "libfake_nvml.so")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _wait_port(port, timeout=30.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            socket.create_connection(("127.0.0.1", port), timeout=1).close()
            return
        except OSError:
            time.sleep(0.1)
    raise AssertionError(f"nothing listens on {port}")


def test_daemon_streams_over_nvml(fake_lib, tmp_path):
    env = dict(os.environ, TPUMON_NVML_PATH=fake_lib,
               TPUMON_KMSG_PATH=str(tmp_path / "no-kmsg"), PYTHONPATH=REPO)
    env.pop("TPUMON_BACKEND", None)
    port, sport = _free_port(), _free_port()
    probe = ("import runpy, sys, threading, time\n"
             "def report():\n"
             "    time.sleep(2.0)\n"
             "    print('torch' in sys.modules, flush=True)\n"
             "threading.Thread(target=report, daemon=True).start()\n"
             "sys.argv = ['prometheus-tpu'] + sys.argv[1:]\n"
             "runpy.run_module('tpumon_torch.exporter.main',"
             " run_name='__main__')\n")
    daemon = subprocess.Popen(
        [sys.executable, "-c", probe, "-o", "none", "-d", "100", "--port",
         str(port), "--stream-port", str(sport), "--blackbox-dir",
         str(tmp_path / "bb")], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        _wait_port(sport)
        r = subprocess.run([sys.executable, "-m", "tpumon_torch.cli.stream",
                            "--connect", f"127.0.0.1:{sport}", "--format",
                            "json", "--count", "3"], cwd=REPO, env=env,
                           capture_output=True, text=True, timeout=60)
        assert r.returncode == 0, r.stderr
        ticks = [json.loads(ln) for ln in r.stdout.splitlines()]
        assert [t["kind"] for t in ticks] == ["tick"] * 3
        assert ticks[0]["keyframe"] and ticks[0]["chips"] == 2
        with socket.create_connection(("127.0.0.1", sport)) as s:
            s.sendall(b"GET /stream HTTP/1.1\r\n\r\n")
            s.settimeout(10)
            head = b""
            while b"\r\n\r\n" not in head:
                head += s.recv(4096)
            assert head.startswith(b"HTTP/1.1 200 OK\r\n")
            import http.client
            deadline = time.monotonic() + 20
            while True:  # a sweep after the attach renders its counters
                conn = http.client.HTTPConnection("127.0.0.1", port,
                                                  timeout=10)
                conn.request("GET", "/metrics")
                body = conn.getresponse().read().decode()
                conn.close()
                if value(body, "tpumon_stream_subscribers_total") == 2 or \
                        time.monotonic() > deadline:
                    break
                time.sleep(0.1)
        assert value(body, "tpumon_stream_subscribers_total") == 2
        assert value(body, "tpumon_stream_subscribers") == 1
        assert value(body, "tpumon_stream_bytes_sent_total") > 0
        assert 'phase="stream"' in body
        assert daemon.stdout.readline().strip() == "False"  # no torch
    finally:
        daemon.terminate()
        out, err = daemon.communicate(timeout=30)
    assert daemon.returncode == 0, err
    # a stream port that cannot be bound fails the start
    with socket.socket() as taken:
        taken.bind(("", 0))
        taken.listen(1)
        busy = taken.getsockname()[1]
        r = subprocess.run([sys.executable, "-m", "tpumon_torch.exporter.main",
                            "-o", "none", "--stream-port", str(busy)],
                           cwd=REPO, env=env, capture_output=True, text=True,
                           timeout=60)
    assert r.returncode != 0 and "Address already in use" in r.stderr


# ---- the agent's request codec ---------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_sweep_request_codec_equals_the_reference(seed):
    """``encode_sweep_request``/``decode_sweep_request``: the frame server
    frames on the request's magic; both packages' bytes and decodes."""

    import numpy as np

    from tpumon import sweepframe as JS
    from tpumon_torch import sweepframe as TS

    rng = np.random.default_rng(seed)
    shared = [int(f) for f in rng.choice(300, size=12, replace=False)]
    reqs = [(c, shared) for c in range(int(rng.integers(1, 9)))]
    reqs += [(9 + c, [int(f) for f in rng.choice(300, size=3)])
             for c in range(int(rng.integers(0, 3)))]
    for max_age, since in ((None, None), (0.25, 7), (float(seed), 0)):
        got = TS.encode_sweep_request(reqs, max_age, since)
        assert got == JS.encode_sweep_request(reqs, max_age, since)
        assert got[0] == TS.SWEEP_REQ_MAGIC
        payload, used = TS.split_frame(got)
        assert used == len(got)
        dec = TS.decode_sweep_request(payload)
        assert dec == JS.decode_sweep_request(payload)
        assert sorted(dec[0]) == sorted((c, list(f)) for c, f in reqs)
        assert dec[1:] == (max_age, since)
