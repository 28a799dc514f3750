"""The port's simulated agent farm (``tpumon_torch.agentsim``) against the
JAX package's (``tpumon.agentsim``), on the CPU.

* ``_bench_host_values``: equal, value types included.
* ``SimAgent`` replies: one scripted client conversation (hello, the
  ``sweep_frame`` probe, binary requests steady and after a change, the
  JSON oracle with the event drain, ``events``, an unknown op, burst churn,
  the burst fold, an old JSON-only agent, a mid-frame death) against a
  reference farm and a port farm holding the same values: every reply
  byte-equal.  Tolerance: none.
* ``SubscriberFarm``: the port's and the reference's decoding subscribers
  on one port stream read the same snapshots.
* The farm process: ``python -m tpumon_torch.agentsim --procs 2`` speaks
  the reference's stdio protocol, its children are the port's module, it
  serves ``_bench_host_values`` to a poller, and no farm process imports
  ``tpumon``, ``jax`` or ``torch`` (the import guard of
  ``tests/test_torch_fleetshard.py``).
"""

import dataclasses
import json
import os
import socket
import subprocess
import sys
import time

import pytest

from test_torch_fleet import FIDS
from test_torch_fleetshard import import_guard
from tpumon import agentsim as JS
from tpumon import events as JE
from tpumon import fleetpoll as JP
from tpumon_torch import agentsim as TS
from tpumon_torch import events as TE
from tpumon_torch import fleetpoll as TP
from tpumon_torch import frameserver as TFS
from tpumon_torch.sweepframe import (SWEEP_FRAME_MAGIC, encode_sweep_request,
                                     try_split_frame)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("chips", [1, 4, 8])
def test_bench_host_values_equal_the_reference(chips):
    fields = FIDS + [50, 52, 1001]
    for seed in range(20):
        a = JS._bench_host_values(seed, chips, fields)
        b = TS._bench_host_values(seed, chips, fields)
        assert repr(a) == repr(b)


def test_fd_budget_equals_the_reference():
    for hosts in (0, 1, 64, 256):
        assert TS.ensure_fd_budget(hosts) == JS.ensure_fd_budget(hosts) \
            == hosts


# -- one scripted conversation against both farms ------------------------------------

class _Client:
    def __init__(self, address):
        self.sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self.sock.settimeout(5.0)
        self.sock.connect(address[len("unix:"):])
        self.buf = bytearray()

    def _fill(self):
        chunk = self.sock.recv(65536)
        if not chunk:
            raise EOFError
        self.buf += chunk

    def ask(self, data):
        """Send ``data`` -> the one reply (a JSON line or a frame), or
        ``b"EOF:" + what came`` when the agent closed first."""

        self.sock.sendall(data)
        try:
            while True:
                if self.buf and self.buf[0] == SWEEP_FRAME_MAGIC:
                    parsed = try_split_frame(self.buf)
                    if parsed is not None:
                        used = parsed[1]
                        break
                elif b"\n" in self.buf:
                    used = self.buf.index(b"\n") + 1
                    break
                self._fill()
        except (EOFError, OSError):
            out, self.buf = b"EOF:" + bytes(self.buf), bytearray()
            return out
        out = bytes(self.buf[:used])
        del self.buf[:used]
        return out

    def close(self):
        self.sock.close()


def _line(obj):
    return json.dumps(obj, separators=(",", ":")).encode() + b"\n"


def _conversation(S, E, farm):
    """Replies to the script, from ``farm`` (``S``'s classes)."""

    sim = S.SimAgent()
    sim.values = S._bench_host_values(7, 4, FIDS)
    sim.values[2][FIDS[1]] = None                      # one blank
    old = S.SimAgent(support_sweep_frame=False)
    old.values = S._bench_host_values(8, 2, FIDS)
    addr, old_addr = farm.add(sim), farm.add(old)
    farm.start()
    reqs = [{"index": c, "fields": FIDS} for c in range(5)]  # 4 is absent
    binary = encode_sweep_request([(c, FIDS) for c in range(5)], None, 0)
    out = []
    c = _Client(addr)
    try:
        out.append(c.ask(_line({"op": "hello", "client": "t",
                                "version": "0.1.0"})))
        out.append(c.ask(_line({"op": "sweep_frame", "reqs": reqs,
                                "events_since": 0})))
        out.append(c.ask(binary))                      # index-only
        sim.values[1][FIDS[0]] = 4321.5
        sim.values[3] = None                           # chip lost
        sim.events = [E.Event(etype=E.EventType.THERMAL, timestamp=2.5,
                              seq=1, chip_index=0, uuid="u0",
                              message="hot")]
        out.append(c.ask(binary))                      # delta + event
        out.append(c.ask(_line({"op": "read_fields_bulk", "reqs": reqs,
                                "events_since": 0})))
        out.append(c.ask(_line({"op": "events", "since_seq": 0})))
        out.append(c.ask(_line({"op": "events", "peek": True})))
        out.append(c.ask(_line({"op": "no_such_op"})))
        sim.burst_churn_ticks = 1
        out.append(c.ask(binary))                      # full churn
        sim.burst_fold(0, 155, [(0.0, 100.0), (0.25, 300.0),
                                (0.5, 200.0), (1.0, 250.0)])
        sim.burst_harvest()
        sim.burst_hz = 100
        out.append(c.ask(binary))                      # burst fields
        out.append(c.ask(_line({"op": "hello"})))      # burst health
        sim.kill_mid_frame_once = True
        sim.values[0][FIDS[2]] = 1.25
        out.append(c.ask(binary))                      # cut, then EOF
    finally:
        c.close()
    c = _Client(old_addr)
    try:
        out.append(c.ask(_line({"op": "hello"})))
        out.append(c.ask(_line({"op": "sweep_frame", "reqs": reqs[:2],
                                "events_since": 0})))
        out.append(c.ask(_line({"op": "read_fields_bulk",
                                "reqs": reqs[:2]})))
    finally:
        c.close()
    counters = [(s.hello_served, s.sweep_frame_probes, s.binary_requests,
                 s.json_sweeps, s.events_rpcs) for s in (sim, old)]
    return out, counters, repr(sim.values)


def test_sim_agent_replies_equal_the_reference():
    fj, ft = JS.AgentFarm(), TS.AgentFarm()
    try:
        want = _conversation(JS, JE, fj)
        got = _conversation(TS, TE, ft)
    finally:
        fj.close()
        ft.close()
    for i, (a, b) in enumerate(zip(want[0], got[0])):
        assert a == b, (i, a, b)
    assert len(want[0]) == len(got[0]) == 15
    assert want[0][11].startswith(b"EOF:")               # cut mid-frame
    assert b"unknown op: sweep_frame" in want[0][13]
    assert want[1:] == got[1:]
    fj_bytes = (fj.bytes_in, fj.bytes_out)
    assert fj_bytes == (ft.bytes_in, ft.bytes_out) and fj_bytes[1] > 0


# -- stream subscribers ------------------------------------------------------------

def test_subscriber_farms_read_one_stream_alike():
    server = TFS.FrameServer()
    hub = TFS.StreamHub(server)
    addr = server.add_unix_listener(hub)
    server.start()
    pub = hub.publisher("h")
    subs = {}
    farms = {}
    try:
        for name, S in (("ref", JS), ("port", TS)):
            farms[name] = S.SubscriberFarm()
            subs[name] = (farms[name].add(addr, "h", decode=True),
                          farms[name].add(addr, "h"))
            farms[name].start()
        time.sleep(0.2)  # the subscribes land before the first tick
        snap = TS._bench_host_values(3, 4, FIDS)
        for tick in range(4):
            snap[tick % 4][FIDS[0]] = float(tick)
            pub.publish({c: dict(v) for c, v in snap.items()},
                        now=1000.0 + tick)
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline and not all(
                s.ticks >= 4 for pair in subs.values() for s in pair):
            time.sleep(0.02)
        (rd, rc), (pd, pc) = subs["ref"], subs["port"]
        assert pd.ticks == rd.ticks == pc.ticks == rc.ticks == 4
        assert pd.keyframes == rd.keyframes >= 1
        assert pc.keyframes == rc.keyframes == pd.keyframes
        assert repr(pd.last_snapshot) == repr(rd.last_snapshot) == \
            repr(snap)
        assert pd.last_tick.timestamp == rd.last_tick.timestamp == 1003.0
        assert pd.bytes_in == rd.bytes_in and pc.bytes_in == rc.bytes_in
        assert not (pd.error or rd.error)
    finally:
        for f in farms.values():
            f.close()
        server.close()


# -- the farm process ------------------------------------------------------------------

def _farm(pkg, hosts, chips, procs, env):
    p = subprocess.Popen(
        [sys.executable, "-m", f"{pkg}.agentsim", "--hosts", str(hosts),
         "--chips", str(chips), "--procs", str(procs)],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True, cwd=REPO,
        env=env)
    first = json.loads(p.stdout.readline())
    return p, first


def _ask(p, op):
    p.stdin.write(json.dumps(op) + "\n")
    p.stdin.flush()
    return json.loads(p.stdout.readline())


def _children(pid):
    out = []
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open(f"/proc/{d}/stat") as f:
                ppid = int(f.read().rsplit(")", 1)[1].split()[1])
            with open(f"/proc/{d}/cmdline", "rb") as f:
                cmd = f.read().split(b"\0")
        except (OSError, ValueError, IndexError):
            continue
        if ppid == pid:
            out.append(cmd)
    return out


def test_farm_process_speaks_the_reference_protocol(tmp_path, monkeypatch):
    refused = import_guard(tmp_path, monkeypatch)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.environ["PYTHONPATH"], REPO]))
    port, pfirst = _farm("tpumon_torch", 6, 2, 2, env)
    env_ref = dict(os.environ, PYTHONPATH=REPO)
    env_ref.pop("FLEET_IMPORT_LOG")
    ref, rfirst = _farm("tpumon", 6, 2, 2, env_ref)
    try:
        assert pfirst["ok"] and rfirst["ok"]
        assert pfirst["procs"] == rfirst["procs"] == 2
        assert len(pfirst["addrs"]) == len(rfirst["addrs"]) == 6
        kids = _children(port.pid)
        assert len(kids) == 2
        for cmd in kids:
            assert cmd[1:3] == [b"-m", b"tpumon_torch.agentsim"], cmd
        pt = TP.FleetPoller(pfirst["addrs"], FIDS, timeout_s=5.0)
        pj = JP.FleetPoller(rfirst["addrs"], FIDS, timeout_s=5.0)
        try:
            for _ in range(2):
                a, b = pt.poll(), pj.poll()
                assert all(s.up for s in a)
                for i, (x, y) in enumerate(zip(a, b)):
                    want = TP.aggregate_host_sample(
                        x.address, 2, "sim 1.0",
                        TS._bench_host_values(i, 2, FIDS), 0)
                    assert repr(x) == repr(want)
                    assert repr(dataclasses.replace(x, address="")) == \
                        repr(dataclasses.replace(y, address=""))
        finally:
            pt.close()
            pj.close()
        for op in ({"op": "bytes"}, {"op": "hellos"},
                   {"op": "reply_delay", "s": 0.0}, {"op": "churn",
                                                     "ticks": 1},
                   {"op": "nope"}):
            assert _ask(port, op) == _ask(ref, op), op
        assert _ask(port, {"op": "quit"}) == _ask(ref, {"op": "quit"}) == \
            {"ok": True}
        assert port.wait(timeout=20) == 0 and ref.wait(timeout=20) == 0
    finally:
        for p in (port, ref):
            if p.poll() is None:
                p.kill()
                p.wait()
    assert refused.read_text() == ""
