"""The port's agent (``python -m tpumon_torch.hostengine``) and its client
(``tpumon_torch.backends.agent.AgentBackend``) against the reference's
native ``tpu-hostengine`` and ``tpumon.backends.agent.AgentBackend``.

* Reply for reply: the port's agent ``--fake --fake-epoch E`` and the
  native one with the same epoch answer the same request sequence alike,
  for every op of ``native/agent/protocol.md``.  The epoch lies in the
  future, so both fakes read at t = 0 and every waveform is fixed; values
  agree within the golden tolerances of the reference's cross-language
  test (155 and the profiling gauges by the Python fake's declared
  rounding, every other field exactly).  Exempt: ``introspect``'s
  ``pid``/``memory_kb``/``cpu_percent``/``uptime_s``, ``agent_version``,
  and the wall-clock stamps of samples and events (within 5 s).
* ``sweep_frame`` replies, JSON probe then binary requests, decode to the
  same mirrors, chip removals and piggybacked events included.
* Both clients crossed against both agents give the same results.
* Watch replay after the agent is killed and restarted, the client's
  ``connect_retry_s``, ``start_agent``/``stop_agent`` leaving no child,
  the burst ids in ``hello`` with ``--burst-hz``, and the no-fallback
  rules: no NVML means exit 3, never fake values.
"""

import math
import os
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import time

import pytest

from test_torch_fake import GOLDEN, native_agent

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_AGENT = [sys.executable, "-m", "tpumon_torch.hostengine"]
TESTLIB = os.path.join(REPO, "tpumon_torch", "testlib")
#: per-link vectors: the native ``FakeSource.read_vector`` reads the
#: wall clock without the elapsed-time clamp, so at a future epoch its
#: values are not the frozen t = 0 ones; compared by shape and type only
SHAPE_ONLY = {460, 461, 462}


# ---- shared helpers (``tests/test_torch_host.py`` uses them too) --------------

def agent_env(**extra) -> dict:
    env = dict(os.environ, PYTHONPATH=REPO, **extra)
    env.pop("TPUMON_BACKEND", None)
    return env


def spawn_agent(cmd, sock, *args, env=None, wait=True):
    """Start an agent on unix socket ``sock``; with ``wait``, return once
    it answers ``hello``."""

    proc = subprocess.Popen(list(cmd) + ["--domain-socket", sock, *args],
                            cwd=REPO, env=env or agent_env(),
                            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
    deadline = time.monotonic() + 20.0
    while wait:
        if proc.poll() is not None:
            raise AssertionError(f"agent exited {proc.returncode}: "
                                 f"{proc.stderr.read().decode()[-2000:]}")
        try:
            with socket.socket(socket.AF_UNIX) as s:
                s.settimeout(2.0)
                s.connect(sock)
                s.sendall(b'{"op":"hello"}\n')
                if s.makefile("rb").readline():
                    break
        except OSError:
            pass
        assert time.monotonic() < deadline, "agent did not come up"
        time.sleep(0.02)
    return proc


def stop_agent(proc) -> None:
    if proc.poll() is None:
        proc.terminate()
        try:
            proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    if proc.stderr is not None:
        proc.stderr.close()


def build_fake_nvml(tmp_dir) -> str:
    cc = shutil.which("cc") or shutil.which("gcc")
    if cc is None:
        pytest.skip("no C compiler on this host")
    out = os.path.join(str(tmp_dir), "libfake_nvml.so")
    subprocess.run([cc, "-shared", "-fPIC", "-I", TESTLIB, "-o", out,
                    os.path.join(TESTLIB, "fake_nvml.c"), "-lpthread"],
                   check=True, capture_output=True, timeout=120)
    return out


def agent_children() -> list:
    """This process's child processes running an agent."""

    out = []
    for pid in os.listdir("/proc"):
        if not pid.isdigit():
            continue
        try:
            with open(f"/proc/{pid}/stat") as f:
                ppid = int(f.read().rsplit(")", 1)[1].split()[1])
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                cmd = f.read()
        except (OSError, ValueError, IndexError):
            continue
        if ppid == os.getpid() and (b"hostengine" in cmd):
            out.append(int(pid))
    return out


class Raw:
    """One raw protocol connection: JSON ops and binary sweep frames."""

    def __init__(self, sock: str) -> None:
        self.s = socket.socket(socket.AF_UNIX)
        self.s.settimeout(10.0)
        self.s.connect(sock)
        self.f = self.s.makefile("rwb")

    def ask(self, req) -> dict:
        import json

        self.f.write(json.dumps(req).encode() + b"\n")
        self.f.flush()
        return json.loads(self.f.readline())

    def line(self, data: bytes) -> bytes:
        self.f.write(data)
        self.f.flush()
        return self.f.readline()

    def frame(self, data: bytes) -> bytes:
        """Send a request (JSON probe line or binary), read one frame."""

        self.f.write(data)
        self.f.flush()
        lead = self.f.read(1)
        if lead != b"\xa9":
            return lead + self.f.readline()
        length, shift, head = 0, 0, b""
        while True:
            b = self.f.read(1)
            head += b
            length |= (b[0] & 0x7F) << shift
            if not b[0] & 0x80:
                break
            shift += 7
        return lead + head + self.f.read(length)

    def close(self) -> None:
        self.f.close()
        self.s.close()


# ---- fixtures ------------------------------------------------------------------

FROZEN = time.time() + 36000.0  # a future epoch: both fakes read t = 0


@pytest.fixture(scope="module")
def agents(tmp_path_factory):
    """The native and the port's ``--fake`` agents at one frozen epoch."""

    native = native_agent()
    d = tmp_path_factory.mktemp("agents")
    args = ("--fake", "--fake-chips", "4", "--fake-epoch", repr(FROZEN),
            "--allow-inject")
    socks = {"native": str(d / "n.sock"), "port": str(d / "p.sock")}
    procs = [spawn_agent([native], socks["native"], *args),
             spawn_agent(PORT_AGENT, socks["port"], *args)]
    yield socks
    for p in procs:
        stop_agent(p)


def same(native, port, path=()):
    """Replies equal: same keys and shapes, numbers exact unless a field
    id on the path has a golden tolerance."""

    exempt = {"pid", "memory_kb", "cpu_percent", "uptime_s",
              "agent_version", "timestamp", "ts"}
    if isinstance(native, dict):
        assert isinstance(port, dict), (path, native, port)
        assert set(native) - exempt == set(port) - exempt, (path, native,
                                                            port)
        for k in native:
            if k in exempt and k in port:
                if k in ("timestamp", "ts"):
                    assert abs(native[k] - port[k]) < 5.0, (path, k)
                continue
            same(native[k], port[k], path + (k,))
        return
    if isinstance(native, list):
        assert isinstance(port, list) and len(native) == len(port), \
            (path, native, port)
        for a, b in zip(native, port):
            same(a, b, path)
        return
    if isinstance(native, (int, float)) and not isinstance(native, bool):
        assert isinstance(port, (int, float)), (path, native, port)
        fid = next((int(p) for p in reversed(path)
                    if isinstance(p, str) and p.isdigit()), None)
        if fid in SHAPE_ONLY:
            assert type(native) is type(port), (path, native, port)
            return
        tol = GOLDEN.get(fid, 0)
        assert math.isclose(float(native), float(port), abs_tol=tol or 0.0,
                            rel_tol=0.0), (path, native, port)
        if not tol:
            assert type(native) is type(port), (path, native, port)
        return
    assert native == port, (path, native, port)


def catalog_fields():
    from tpumon_torch import fields as FF

    return sorted(FF.CATALOG) + [99999]


OPS = {
    "hello": [{"op": "hello", "client": "t"}],
    "chip_info": [{"op": "chip_info", "index": i} for i in (0, 3, 4, -1)],
    "read_fields": [{"op": "read_fields", "index": i,
                     "fields": "CATALOG"} for i in range(4)]
    + [{"op": "read_fields", "index": 9, "fields": [155]}],
    "read_fields_bulk": [
        {"op": "read_fields_bulk",
         "reqs": [{"index": i, "fields": "CATALOG"} for i in (0, 2, 7)]},
        {"op": "read_fields_bulk", "reqs": [{"index": 1, "fields": [155,
                                                                    460]}],
         "max_age_s": 0.5, "events_since": 0}],
    "watch": [{"op": "watch", "fields": []},
              {"op": "watch", "fields": [155, 203], "freq_us": 20000,
               "keep_age_s": 5.0}],
    "unwatch": [{"op": "unwatch", "watch_id": 424242}],
    "latest": [{"op": "latest", "index": 0, "fields": [203, 99]},
               {"op": "latest", "index": 8, "fields": [203]}],
    "samples": [{"op": "samples", "index": 1, "field": 4242},
                {"op": "samples", "index": 5, "field": 155}],
    "topology": [{"op": "topology", "index": i} for i in (0, 1, 2, 3, 4)],
    "processes": [{"op": "processes", "index": i} for i in (0, 4)],
    "events": [{"op": "events", "since_seq": 0, "peek": True},
               {"op": "events", "since_seq": 0}],
    "inject": [{"op": "inject", "chip": 2, "etype": 1, "message": "m"},
               {"op": "events", "since_seq": 0},
               {"op": "read_fields", "index": 2, "fields": [230, 231]}],
    "introspect": [{"op": "introspect"}],
    "unknown": [{"op": "bogus"}, {"x": 1}],
}


@pytest.mark.parametrize("op", sorted(OPS))
def test_every_op_answers_like_the_native_agent(agents, op):
    conns = {k: Raw(v) for k, v in agents.items()}
    try:
        for req in OPS[op]:
            if req.get("fields") == "CATALOG":
                req = dict(req, fields=catalog_fields())
            if isinstance(req.get("reqs"), list):
                req = dict(req, reqs=[
                    dict(r, fields=catalog_fields())
                    if r["fields"] == "CATALOG" else r
                    for r in req["reqs"]])
            replies = {k: c.ask(req) for k, c in conns.items()}
            if op == "introspect":
                # both count their own requests and reads: equal only
                # on fresh agents (test_introspect_counts_like_native)
                assert set(replies["native"]) == set(replies["port"])
                continue
            if op == "inject" and req.get("op") == "events":
                # the module's agents share injected events across
                # tests: compare the newest one
                for r in replies.values():
                    r["events"] = r["events"][-1:]
                    r["last_seq"] = None
            same(replies["native"], replies["port"], (op,))
    finally:
        for c in conns.values():
            c.close()


def test_malformed_requests_answer_like_the_native_agent(agents):
    for data in (b"garbage\n", b"[1, 2]\n", b"{\"op\": \n",
                 b"\xa6\x03\xff\xff\xff"):
        got = {}
        for k, v in agents.items():
            c = Raw(v)
            try:
                got[k] = c.line(data)
            finally:
                c.close()
        import json
        assert json.loads(got["native"]) == json.loads(got["port"]), data


def test_watch_latest_samples_like_the_native_agent(agents):
    """A watch's sampler: once both have sampled, ``latest`` and the last
    of ``samples`` give the same frozen values; ``unwatch`` purges."""

    conns = {k: Raw(v) for k, v in agents.items()}
    try:
        wids = {k: c.ask({"op": "watch", "fields": [150, 155, 203],
                          "freq_us": 20000, "keep_age_s": 5.0})
                for k, c in conns.items()}
        assert all(r["ok"] for r in wids.values())
        deadline = time.monotonic() + 10.0
        for k, c in conns.items():
            while not c.ask({"op": "samples", "index": 3, "field": 155,
                             "since": 0})["samples"]:
                assert time.monotonic() < deadline
                time.sleep(0.02)
        got = {k: (c.ask({"op": "latest", "index": 3,
                          "fields": [150, 155, 203, 204]}),
                   c.ask({"op": "samples", "index": 3, "field": 203,
                          "since": 0})["samples"][-1:])
               for k, c in conns.items()}
        same(got["native"][0], got["port"][0], ("latest",))
        assert got["native"][1][0][1] == got["port"][1][0][1]
        for k, c in conns.items():
            assert c.ask({"op": "unwatch",
                          "watch_id": wids[k]["watch_id"]}) == {"ok": True}
        got = {k: c.ask({"op": "latest", "index": 3, "fields": [155]})
               for k, c in conns.items()}
        same(got["native"], got["port"], ("latest",))
        assert got["port"]["values"] == {"155": None}
    finally:
        for c in conns.values():
            c.close()


def test_agent_watches_keep_numbers_blank_when_stale_and_purge():
    """The agent's watches (a ``WatchManager`` over ``WatchSource``) at an
    injected clock: numbers only, counted; ``latest(fresh=True)`` blanks
    past the longer of retention and twice the period (``sampler.hpp``);
    ``unwatch(purge=True)`` drops what no watch covers."""

    from tpumon_torch.hostengine import AgentFakeBackend, WatchSource
    from tpumon_torch.watch import WatchManager

    now = [FROZEN]
    b = AgentFakeBackend(chips=2, epoch=FROZEN)
    b.open()
    src = WatchSource(b)
    wm = WatchManager(src, clock=lambda: now[0])
    g = wm.all_chips_group()
    slow = wm.watch_fields(g, wm.create_field_group([155, 460, 1]),
                           1_000_000, 0.5)
    fast = wm.watch_fields(g, wm.create_field_group([150]), 100_000, 10.0)
    wm.update_all(wait=False)
    assert wm.latest(1, 155, fresh=True).timestamp == FROZEN
    assert wm.latest(1, 460) is None and wm.latest(1, 1) is None
    assert src.samples == 2 * 2
    now[0] = FROZEN + 1.9
    assert wm.latest(1, 155, fresh=True) is not None
    now[0] = FROZEN + 2.1
    assert wm.latest(1, 155, fresh=True) is None
    assert wm.latest(1, 155) is not None  # the library's own read: kept
    assert wm.latest(1, 150, fresh=True) is not None
    assert wm.unwatch(slow, purge=True) and not wm.unwatch(slow, purge=True)
    assert wm.latest(1, 155) is None and wm.latest(1, 150) is not None
    assert wm.unwatch(fast) and wm.latest(1, 150) is not None


def test_sweep_frames_decode_like_the_native_agent(agents):
    """JSON probe, then binary requests on one connection: the decoded
    mirrors are equal frame for frame (a chip dropped from the request is
    purged, events ride along), and a steady frame carries nothing."""

    from tpumon_torch.sweepframe import (SweepFrameDecoder,
                                         encode_sweep_request)

    fids = catalog_fields()
    probe = (b'{"op": "sweep_frame", "reqs": [{"index": 0, "fields": '
             + str(fids).encode() + b'}, {"index": 1, "fields": [155]}], '
             b'"events_since": 0}\n')
    steps = [probe,
             encode_sweep_request([(0, fids), (1, [155])], None, 0),
             encode_sweep_request([(0, fids)], 0.5, None),
             encode_sweep_request([(0, [155]), (3, [460, 203]),
                                   (9, [1])], None, 10 ** 6)]
    decoded, sizes = {}, {}
    for k, sock in agents.items():
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
                            [(int(e.etype), e.seq, e.chip_index, e.uuid)
                             for e in events or []]))
                n.append(len(frame))
        finally:
            c.close()
        decoded[k], sizes[k] = out, n
    for a, b in zip(decoded["native"], decoded["port"]):
        same({str(c): {str(f): v for f, v in vals.items()}
              for c, vals in a[0].items()},
             {str(c): {str(f): v for f, v in vals.items()}
              for c, vals in b[0].items()}, ("sweep_frame",))
        assert a[1] == b[1]
    # the port's steady frame (same request, frozen values) carries the
    # index alone (the native one re-sends its clock-driven vectors)
    assert sizes["port"][2] <= 6, sizes


def test_introspect_counts_like_the_native_agent(tmp_path):
    """Fresh agents, the same requests: ``requests`` and ``samples`` (the
    device reads) are equal."""

    procs, got = [], {}
    try:
        for k, cmd in (("native", [native_agent()]), ("port", PORT_AGENT)):
            sock = str(tmp_path / f"{k}.sock")
            procs.append(spawn_agent(cmd, sock, "--fake", "--fake-epoch",
                                     repr(FROZEN)))
            c = Raw(sock)
            try:
                for req in ({"op": "read_fields", "index": 0,
                             "fields": [155, 460, 99999]},
                            {"op": "read_fields_bulk",
                             "reqs": [{"index": 1, "fields": [150]},
                                      {"index": 6, "fields": [1]}]},
                            {"op": "nope"}):
                    c.ask(req)
                c.frame(b'{"op": "sweep_frame", "reqs": [{"index": 2, '
                        b'"fields": [203, 204]}]}\n')
                got[k] = c.ask({"op": "introspect"})
            finally:
                c.close()
    finally:
        for p in procs:
            stop_agent(p)
    # one hello each from spawn_agent's readiness probe
    for k in got:
        assert got[k]["requests"] == 6 and got[k]["samples"] == 6, got
    same(got["native"], got["port"], ("introspect",))


def test_term_stops_the_agent(tmp_path):
    sock = str(tmp_path / "t.sock")
    proc = spawn_agent(PORT_AGENT, sock, "--fake")
    c = Raw(sock)
    try:
        assert c.ask({"op": "term"}) == {"ok": True}
        assert proc.wait(timeout=10) == 0
        assert not os.path.exists(sock)
    finally:
        c.close()
        stop_agent(proc)


def test_port_agent_samples_equal_the_reference_fake(tmp_path):
    """The port's agent stamps each sampler sweep with one wall time and
    reads the fake at it: every sample equals the reference's
    ``FakeBackend`` at that stamp, within the golden tolerances (the
    port's agent serves the Python fake's rounding, so 0 here for all)."""

    from tpumon.backends.fake import FakeBackend, FakeSliceConfig
    from tpumon_torch.backends.agent import AgentBackend

    epoch = time.time() - 37.5
    sock = str(tmp_path / "g.sock")
    proc = spawn_agent(PORT_AGENT, sock, "--fake", "--fake-epoch",
                       repr(epoch))
    b = AgentBackend(address=f"unix:{sock}")
    try:
        b.open()
        fids = [100, 140, 150, 155, 156, 203, 253, 1001, 1011]
        b.ensure_watch(fids, freq_us=50_000, keep_age_s=30.0)
        ref = FakeBackend(FakeSliceConfig(num_chips=4), clock=lambda: epoch)
        ref.open()
        deadline = time.monotonic() + 10.0
        compared = 0
        for chip in range(4):
            for fid in fids:
                got = b.agent_samples(chip, fid)
                while len(got) < 2 and time.monotonic() < deadline:
                    time.sleep(0.05)
                    got = b.agent_samples(chip, fid)
                for ts, v in got[-2:]:
                    want = ref.read_fields(chip, [fid], now=ts)[fid]
                    assert float(v) == float(want), (chip, fid, v, want)
                    compared += 1
        assert compared >= 2 * 4 * len(fids)
    finally:
        b.close()
        stop_agent(proc)


# ---- clients crossed against agents ---------------------------------------------

def _client_view(mod, address):
    """What one client reads from one agent, as plain values."""

    from tpumon_torch import fields as FF

    b = mod.AgentBackend(address=address)
    b.open()
    try:
        info = b.chip_info(1)
        topo = b.topology(2)
        vals = b.read_fields(0, list(FF.DMON_FIELDS) + [460, 99999])
        chips, events = b.sweep_fields_bulk([(0, [155, 203]), (3, [253])],
                                            events_since=10 ** 6)
        wid = b.ensure_watch([150, 203], freq_us=20_000)
        deadline = time.monotonic() + 10.0
        while b.agent_latest(2, [150])[150] is None:
            assert time.monotonic() < deadline
            time.sleep(0.02)
        latest = b.agent_latest(2, [150, 203])
        b.unwatch(wid)
        ws = b.sweep_wire_stats()
        return {
            "count": b.chip_count(), "driver": b.versions().driver,
            "info": (info.uuid, info.name, info.arch.value, info.serial,
                     info.hbm.total, info.power_limit_w, info.numa_node,
                     info.pci.bus_id, info.coords.x, info.coords.y),
            "topo": (topo.mesh_shape, topo.wrap, topo.cpu_affinity,
                     [(l.chip_index, int(l.link), l.hops) for l in
                      topo.links]),
            "vals": {str(k): v for k, v in vals.items()},
            "chips": {str(c): {str(f): v for f, v in x.items()}
                      for c, x in chips.items()},
            "events": events, "latest": {str(k): v for k, v in
                                         latest.items()},
            "burst": b.burst_stats(),
            "binary": ws["binary_frames_total"] > 0
            and ws["json_sweeps_total"] == 0}
    finally:
        b.close()


def test_clients_crossed_against_both_agents(agents):
    import tpumon.backends.agent as RA
    import tpumon_torch.backends.agent as PA

    views = {(c, a): _client_view(mod, f"unix:{agents[a]}")
             for c, mod in (("reference", RA), ("port", PA))
             for a in ("native", "port")}
    base = views[("reference", "native")]
    assert base["binary"] and base["events"] == [] and base["burst"] is None
    for key, view in views.items():
        same(base, view, key)


# ---- the run modes and their failures ---------------------------------------

def test_watches_replay_after_the_agent_restarts(tmp_path):
    """``kill -9`` of the agent, then a restart on the same socket: the
    next call reconnects and re-registers the client's watch, so the new
    agent's sampler serves it."""

    from tpumon_torch.backends.agent import AgentBackend

    sock = str(tmp_path / "r.sock")
    args = ("--fake", "--fake-epoch", repr(FROZEN))
    proc = spawn_agent(PORT_AGENT, sock, *args)
    b = AgentBackend(address=f"unix:{sock}")
    try:
        b.open()
        b.ensure_watch([155, 203], freq_us=20_000)
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=10)
        stop_agent(proc)
        proc = spawn_agent(PORT_AGENT, sock, *args)
        assert b.read_fields(0, [203])[203] is not None  # reconnects
        c = Raw(sock)
        try:
            deadline = time.monotonic() + 10.0
            while c.ask({"op": "latest", "index": 0,
                         "fields": [155]})["values"]["155"] is None:
                assert time.monotonic() < deadline, "watch not replayed"
                time.sleep(0.02)
        finally:
            c.close()
    finally:
        b.close()
        stop_agent(proc)


def test_connect_retry_rides_out_a_late_agent(tmp_path):
    """``connect_retry_s`` waits for an agent that starts after the
    client; the default fails fast with LibraryNotFound."""

    import threading

    from tpumon_torch.backends.agent import AgentBackend
    from tpumon_torch.backends.base import LibraryNotFound

    sock = str(tmp_path / "late.sock")
    t0 = time.monotonic()
    with pytest.raises(LibraryNotFound):
        AgentBackend(address=f"unix:{sock}").open()
    assert time.monotonic() - t0 < 1.0
    procs = []

    def late():
        time.sleep(0.3)
        procs.append(spawn_agent(PORT_AGENT, sock, "--fake", wait=False))

    t = threading.Thread(target=late)
    t.start()
    try:
        b = AgentBackend(address=f"unix:{sock}", connect_retry_s=20.0)
        b.open()
        assert b.chip_count() == 4
        b.close()
    finally:
        t.join()
        for p in procs:
            stop_agent(p)


def test_start_agent_mode_leaves_no_process(tmp_path, monkeypatch):
    """``RunMode.START_AGENT`` starts the port's agent over NVML (here the
    fake NVML library), reads through it, and stops it on shutdown."""

    import tpumon_torch

    monkeypatch.setenv("TPUMON_NVML_PATH", build_fake_nvml(tmp_path))
    monkeypatch.setenv("TPUMON_KMSG_PATH", str(tmp_path / "no-kmsg"))
    before = set(agent_children())
    h = tpumon_torch.init(tpumon_torch.RunMode.START_AGENT)
    try:
        assert h.backend.name == "agent"
        assert h.chip_count() == 2
        assert h.chip_info(1).uuid.startswith("GPU-")
        assert len(set(agent_children()) - before) == 1
    finally:
        tpumon_torch.shutdown()
    assert set(agent_children()) - before == set()


@pytest.mark.parametrize("agent", ["native", "port"])
def test_burst_ids_in_hello(agent, tmp_path):
    """With ``--burst-hz``, ``hello`` carries ``burst_hz`` and
    ``burst_overruns``, and the derived fields serve a 1 s window."""

    from tpumon_torch import fields as FF

    cmd = [native_agent()] if agent == "native" else PORT_AGENT
    sock = str(tmp_path / "b.sock")
    proc = spawn_agent(cmd, sock, "--fake", "--burst-hz", "50")
    c = Raw(sock)
    try:
        hello = c.ask({"op": "hello"})
        assert hello["burst_hz"] == 50
        assert isinstance(hello["burst_overruns"], int)
        mean = FF.burst_id(155, 2)
        deadline = time.monotonic() + 10.0
        while c.ask({"op": "read_fields", "index": 0, "fields": [mean]}
                    )["values"][str(mean)] is None:
            assert time.monotonic() < deadline
            time.sleep(0.1)
    finally:
        c.close()
        stop_agent(proc)


def test_agent_without_nvml_exits_and_serves_nothing(tmp_path):
    """No NVML on the host and no ``--fake``: exit 3, socket never
    bound — the fake is never served in its place."""

    sock = str(tmp_path / "n.sock")
    env = agent_env(TPUMON_NVML_PATH=str(tmp_path / "no-nvml.so"))
    r = subprocess.run(PORT_AGENT + ["--domain-socket", sock], cwd=REPO,
                       env=env, capture_output=True, text=True, timeout=60)
    assert r.returncode == 3
    assert "no metric source" in r.stderr
    assert not os.path.exists(sock)


def test_connect_to_a_dead_address_exits_1(capsys):
    from tpumon_torch.cli import dmon

    with pytest.raises(SystemExit) as e:
        dmon.main(["--connect", f"unix:{tempfile.mktemp()}", "-c", "1"])
    assert e.value.code == 1
    assert "cannot connect to the agent" in capsys.readouterr().err


def test_the_agent_imports_no_torch():
    r = subprocess.run(
        [sys.executable, "-c",
         "import sys, tpumon_torch.hostengine, tpumon_torch.backends.agent, "
         "tpumon_torch.relay, tpumon_torch.cli.relay; "
         "print(sorted(m for m in sys.modules "
         "if m.split('.')[0] in ('torch', 'jax', 'tpumon')))"],
        cwd=REPO, env=agent_env(), capture_output=True, text=True,
        timeout=60)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[]"


def test_status_cli_and_rest_name_the_remote_engine(agents, capsys):
    """``cli.hostenginestatus --connect`` prints the agent's introspection
    as the reference's does over the native agent, and the REST API over
    an agent names the remote engine."""

    import tpumon_torch
    from tpumon.cli import hostenginestatus as RS
    from tpumon_torch.cli import hostenginestatus as PS
    from tpumon_torch.restapi.server import RestApi

    heads = []
    for mod, sock in ((RS, agents["native"]), (PS, agents["port"])):
        assert mod.main(["--connect", f"unix:{sock}"]) == 0
        heads.append([ln.split(":")[0] for ln in
                      capsys.readouterr().out.splitlines()])
    assert heads[0] == heads[1] and heads[0][0].startswith("Engine")
    h = tpumon_torch.init(tpumon_torch.RunMode.STANDALONE,
                          address=f"unix:{agents['port']}")
    try:
        status, _, body = RestApi(h).dispatch("/tpu/status/json")
        assert status == 200
        import json
        assert json.loads(body)["engine"] == "tpu-hostengine (remote)"
    finally:
        tpumon_torch.shutdown()


# ---- the --prom-port plane against the native agent's -------------------------
# tests/test_agent.py:315, :878, :944, :993, :1028, each run against both
# agents at one frozen epoch; the two bodies must be equal line for line
# (:func:`same_scrape`)

#: self families whose values are timings or process stats
AGENT_SELF = ("tpumon_agent_cpu_percent", "tpumon_agent_memory_kb",
              "tpumon_agent_uptime_seconds", "tpumon_agent_scrape_render_ms",
              "tpumon_agent_scrape_merge_ms")


def prom_agent(cmd, sock, *args, env=None):
    """Start an agent with ``--prom-port 0``; return (process, port) once
    it has announced the port on stderr."""

    import re

    proc = subprocess.Popen(list(cmd) + ["--domain-socket", sock,
                                         "--prom-port", "0", *args],
                            cwd=REPO, env=env or agent_env(),
                            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
                            text=True)
    deadline = time.monotonic() + 30.0
    while time.monotonic() < deadline:
        line = proc.stderr.readline()
        m = re.search(r"/metrics on port (\d+)", line or "")
        if m:
            return proc, int(m.group(1))
        if not line and proc.poll() is not None:
            break
    stop_agent(proc)
    raise AssertionError("the agent never announced its prom port")


def http_get(port, path, timeout=30):
    """(status, body) of one GET."""

    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=timeout) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def same_scrape(native: str, port: str) -> None:
    """The port's scrape equals the native agent's: the same lines in the
    same order, HELP/TYPE and series identities exactly, values equal
    within the fakes' golden tolerances (the native renders ``%.10g``, the
    port the shortest repr; its fake rounds 155 and the profiling gauges)
    but for the self families' timings and process stats and the native
    fake's clock-driven link vectors (``SHAPE_ONLY``)."""

    from tpumon_torch import fields as FF
    from tpumon_torch.exporter.textmerge import parse_sample

    fid_of = {m.prom_name: fid for fid, m in FF.CATALOG.items()}
    a, b = native.splitlines(), port.splitlines()
    assert len(a) == len(b), (len(a), len(b))
    for x, y in zip(a, b):
        if x.startswith("#"):
            assert x == y
            continue
        sx, sy = parse_sample(x), parse_sample(y)
        assert sx == sy and sx is not None, (x, y)
        fam = sx.split("{", 1)[0]
        fid = fid_of.get(fam)
        if fam in AGENT_SELF or fid in SHAPE_ONLY:
            continue
        vx, vy = float(x[len(sx):]), float(y[len(sy):])
        assert math.isclose(vx, vy, rel_tol=1e-9,
                            abs_tol=GOLDEN.get(fid, 0) or 0.0), (x, y)


def scrape_both(tmp_path, *args, chips="2", env=None, path="/metrics",
                ready=None):
    """(native body, port body) of one scrape of each ``--fake`` agent at
    one frozen epoch, with the same extra arguments; with ``ready``, each
    agent is scraped again (for up to 10 s) until ``ready(body)``."""

    out = {}
    for side, cmd in (("native", [native_agent()]), ("port", PORT_AGENT)):
        proc, port = prom_agent(cmd, str(tmp_path / f"{side}.sock"),
                                "--fake", "--fake-chips", chips,
                                "--fake-epoch", repr(FROZEN), *args, env=env)
        try:
            deadline = time.monotonic() + 10.0
            while True:
                status, out[side] = http_get(port, path)
                assert status == 200, (side, status)
                if ready is None or ready(out[side]) or \
                        time.monotonic() > deadline:
                    break
                time.sleep(0.2)
        finally:
            stop_agent(proc)
    return out["native"], out["port"]


def test_prom_scrape_serves_the_catalog_like_the_native_agent(tmp_path):
    import re

    from tpumon_torch import fields as FF

    native, body = scrape_both(tmp_path)
    same_scrape(native, body)
    served = {ln.split("{", 1)[0].split(" ", 1)[0]
              for ln in body.splitlines() if ln and not ln.startswith("#")}
    scrape = {FF.CATALOG[f].prom_name for f in
              set(map(int, FF.EXPORTER_BASE_FIELDS))
              | set(map(int, FF.EXPORTER_PROFILING_FIELDS))
              | set(map(int, FF.EXPORTER_DCN_FIELDS))}
    dcn = {FF.CATALOG[int(f)].prom_name for f in FF.EXPORTER_DCN_FIELDS}
    assert served - scrape - set(AGENT_SELF) == set()
    assert (scrape - dcn) - served == set()
    assert set(AGENT_SELF) <= served
    m = re.search(r"tpumon_agent_scrape_merge_ms ([0-9.]+)", body)
    assert m and float(m.group(1)) == pytest.approx(0.0, abs=1.0)
    assert re.search(r'tpu_ici_link_tx_throughput\{.*link="0"\} ', body)
    # health, exact path matching, 404
    proc, port = prom_agent(PORT_AGENT, str(tmp_path / "p2.sock"), "--fake")
    try:
        assert http_get(port, "/healthz") == (200, "ok\n")
        for path in ("/nope", "/metricsfoo", "/healthzz"):
            assert http_get(port, path)[0] == 404, path
        assert http_get(port, "/metrics?x=1")[0] == 200
    finally:
        stop_agent(proc)


def _hostile_drop_dir(d):
    drop = d / "workload.prom"
    drop.write_text(
        "# HELP tpu_workload_step_time Embedded workload step time.\n"
        "# TYPE tpu_workload_step_time gauge\n"
        'tpu_workload_step_time{chip="0",uuid="GPU-0"} 8432.5\n'
        "tpu_workload_torn_li\n"
        "# HELP tpu_power_usage duplicate help\n"
        'tpu_power_usage{chip="0"} 9999.9\n'
        'tpumon_agent_merged_files{evil="1"} 7\n')
    stale = d / "dead.prom"
    stale.write_text('tpu_workload_dead{chip="0"} 1\n')
    os.utime(stale, (time.time() - 600, time.time() - 600))
    os.mkfifo(str(d / "trap.prom"))
    os.symlink("/dev/zero", str(d / "link.prom"))


def test_prom_scrape_merges_textfiles_like_the_native_agent(tmp_path):
    import re

    d = tmp_path / "drop"
    d.mkdir()
    _hostile_drop_dir(d)
    native, body = scrape_both(tmp_path, "--merge-textfile",
                               str(d / "*.prom"))
    same_scrape(native, body)
    assert 'tpu_workload_step_time{chip="0",uuid="GPU-0"} 8432.5' in body
    assert "tpu_workload_torn_li\n" not in body
    assert "duplicate help" not in body and "tpu_workload_dead" not in body
    assert 'tpu_power_usage{chip="0"} 9999.9' in body
    lines = body.splitlines()
    fam = [i for i, ln in enumerate(lines) if ln.startswith("tpu_power_usage{")]
    assert fam == list(range(fam[0], fam[0] + len(fam)))
    assert re.search(r"tpumon_agent_merged_files 1\b", body)
    assert re.search(r"tpumon_agent_merged_series 3\b", body)
    assert body.index("# HELP tpumon_agent_merged_files") < \
        body.index('tpumon_agent_merged_files{evil="1"}')


def test_prom_scrape_survives_an_echoed_scrape_like_the_native(tmp_path):
    import re

    _, captured = scrape_both(tmp_path)
    d = tmp_path / "drop"
    d.mkdir()
    (d / "echo.prom").write_text(
        captured + "# TYPE tpumon_agent_merged_files gauge\n"
        "tpumon_agent_merged_files 42\n")
    native, body = scrape_both(tmp_path, "--merge-textfile",
                               str(d / "*.prom"))
    same_scrape(native, body)
    metas = {}
    for ln in body.splitlines():
        parts = ln.split(None, 3)
        if ln.startswith("# ") and len(parts) >= 3:
            metas[(parts[1], parts[2])] = metas.get((parts[1], parts[2]),
                                                    0) + 1
    assert not {k: v for k, v in metas.items() if v > 1}
    assert "tpumon_agent_merged_files 42" not in body
    assert re.search(r"tpumon_agent_merged_files 1\b", body)


def test_prom_scrape_truncates_an_oversized_drop_like_the_native(tmp_path):
    import re

    d = tmp_path / "drop"
    d.mkdir()
    with open(d / "big.prom", "w") as f:
        for i in range(200_000):               # ~5.3 MiB of samples
            f.write(f'tpu_workload_big{{i="{i}"}} {i}\n')
    native, body = scrape_both(tmp_path, "--merge-textfile",
                               str(d / "*.prom"), "--kmsg", "/nonexistent",
                               chips="1")
    same_scrape(native, body)
    kept = [ln for ln in body.splitlines()
            if ln.startswith("tpu_workload_big")]
    assert kept and len(kept) < 200_000
    pat = re.compile(r'tpu_workload_big\{i="\d+"\} \d+$')
    assert all(pat.match(ln) for ln in kept), kept[-1]
    assert sum(len(ln) + 1 for ln in kept) <= (4 << 20)


def test_merge_only_mode_without_nvml_like_the_native(tmp_path):
    """No device library on the host and a merge glob: zero devices, the
    drop file and the self families (the native agent without libtpu);
    without the glob both exit 3 naming merge-only mode.  An NVML library
    that loads and fails is never masked: exit 3 even with the glob."""

    d = tmp_path / "drop"
    d.mkdir()
    (d / "embed.prom").write_text(
        "# HELP tpu_step_time Embedded step time.\n"
        "# TYPE tpu_step_time gauge\n"
        'tpu_step_time{chip="0",uuid="GPU-0"} 1234.5\n')
    env = agent_env(TPUMON_LIBTPU_PATH="/nonexistent/libtpu.so",
                    TPUMON_SHIM_SYSFS_ROOT=str(tmp_path),
                    TPUMON_SHIM_DEV_ROOT=str(tmp_path),
                    TPUMON_NVML_PATH=str(tmp_path / "no-nvml.so"))
    bodies = {}
    for side, cmd in (("native", [native_agent()]), ("port", PORT_AGENT)):
        proc, port = prom_agent(cmd, str(tmp_path / f"{side}.sock"),
                                "--merge-textfile", str(d / "*.prom"),
                                "--kmsg", "/nonexistent", env=env)
        try:
            status, bodies[side] = http_get(port, "/metrics")
            assert status == 200
            # no device: the liveness probe fails, as the native's does
            assert http_get(port, "/healthz")[0] == 503
        finally:
            stop_agent(proc)
        r = subprocess.run(cmd + ["--domain-socket",
                                  str(tmp_path / f"{side}2.sock"),
                                  "--kmsg", "/nonexistent"],
                           capture_output=True, text=True, timeout=60,
                           env=env, cwd=REPO)
        assert r.returncode == 3 and "merge-only" in r.stderr, side
    same_scrape(bodies["native"], bodies["port"])
    body = bodies["port"]
    assert 'tpu_step_time{chip="0",uuid="GPU-0"} 1234.5' in body
    assert "tpumon_agent_merged_files 1" in body
    assert "tpu_power_usage" not in body
    # a library that loads but is not NVML: still exit 3
    r = subprocess.run(PORT_AGENT + [
        "--domain-socket", str(tmp_path / "p3.sock"), "--merge-textfile",
        str(d / "*.prom")], capture_output=True, text=True, timeout=60,
        env=agent_env(TPUMON_NVML_PATH="libc.so.6"), cwd=REPO)
    assert r.returncode == 3 and "no metric source" in r.stderr


def test_prom_scrape_splices_pod_labels_like_the_native(tmp_path):
    """``--kubelet-socket`` over the port's fake kubelet
    (``tests/test_torch_pod.py``): both agents label card 1 by its uuid
    with the pod of the resource asked for, and no other card."""

    from test_torch_pod import _fake_kubelet
    from tpumon_torch.exporter import podresources as TR

    server, sock = _fake_kubelet(TR.encode_pod_resources([
        ("train-abc", "ml", [("worker", "example.com/gpu",
                              ["TPU-agentfake-01"])]),
        ("other", "default", [("c", "nvidia.com/gpu",
                               ["TPU-agentfake-00"])])]))
    try:
        # the native agent reads the kubelet on a thread of its own: its
        # first scrapes may come before the first answer
        native, body = scrape_both(tmp_path, "--kubelet-socket", sock,
                                   "--pod-resource", "example.com/gpu",
                                   ready=lambda b: "pod_name=" in b)
    finally:
        server.stop(0)
    same_scrape(native, body)
    labeled = [ln for ln in body.splitlines() if 'pod_name="' in ln]
    assert labeled and all(
        'chip="1",uuid="TPU-agentfake-01",model="TPU v5e",'
        'pod_name="train-abc",pod_namespace="ml",container_name="worker"'
        in ln for ln in labeled)
    assert 'pod_name="other"' not in body


def test_kmsg_flag_feeds_the_nvml_source(tmp_path):
    """``--kmsg FILE`` over the fake NVML built without the event set: an
    ``NVRM: Xid 79`` line
    appended while the agent runs gives one event, naming the fake's card
    on that bus; an unreadable path leaves the watcher silently off."""

    # an NVML without the event set (a VM that refuses it): Xids arrive
    # by the kernel log alone, which the NVML source then reads
    cc = shutil.which("cc") or shutil.which("gcc")
    if cc is None:
        pytest.skip("no C compiler on this host")
    lib = str(tmp_path / "libfake_nvml_noevents.so")
    subprocess.run([cc, "-shared", "-fPIC", "-DOMIT_EVENTS", "-I", TESTLIB,
                    "-o", lib, os.path.join(TESTLIB, "fake_nvml.c"),
                    "-lpthread"], check=True, capture_output=True,
                   timeout=120)
    kmsg = tmp_path / "kmsg"
    kmsg.write_text("")
    env = agent_env(TPUMON_NVML_PATH=lib,
                    TPUMON_KMSG_PATH=str(tmp_path / "not-this-one"))
    sock = str(tmp_path / "k.sock")
    proc = spawn_agent(PORT_AGENT, sock, "--kmsg", str(kmsg), env=env)
    try:
        with open(kmsg, "a") as f:
            f.write("3,1,1,-;NVRM: Xid (PCI:0000:28:00): 79, pid=1, GPU "
                    "has fallen off the bus.\n")
        c = Raw(sock)
        try:
            deadline = time.monotonic() + 20.0
            while True:
                ev = c.ask({"op": "events", "since_seq": 0})["events"]
                if ev or time.monotonic() > deadline:
                    break
                time.sleep(0.1)
        finally:
            c.close()
    finally:
        stop_agent(proc)
    assert len(ev) == 1 and ev[0]["chip_index"] == 1
    assert "Xid" in ev[0]["message"]
    proc = spawn_agent(PORT_AGENT, str(tmp_path / "k2.sock"), "--kmsg",
                       str(tmp_path / "missing"), env=env)
    stop_agent(proc)
