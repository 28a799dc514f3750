"""The port's shard tree and supervisor (``tpumon_torch.fleetshard``,
``tpumon_torch.supervisor``) against the JAX package's, on the CPU.

* ``ShardedFleet`` at 2 and 4 shards over the port's farm equals the flat
  poller of both packages, every tick of a churn schedule (``HostSample``
  rows by ``repr``, types included).  Tolerance: none.
* ``sample_to_row``/``row_to_sample``, ``partition_targets``,
  ``shard_metric_lines`` and ``supervisor_metric_lines``: equal to the
  reference's, rows with their value types, lines byte for byte.
* The reference's own cases (``tests/test_fleetshard.py`` and the quick
  ones of ``tests/test_supervisor.py``) run case for case on the port
  (:func:`test_torch_fleet.run_on_port`).
* One supervised SIGKILL: 8 hosts, 2 shard children (``python -m
  tpumon_torch.cli.fleet --shard-serve-unix``), a child killed, the view
  identical to the flat poller's again within 20 s.  The children run
  under an import guard that refuses ``tpumon``, ``jax`` and ``torch``.
* The anomaly plane resolves the shard's ``SF_*`` fields as the reference
  does.
* The smoke's fleet processes: its import guard, and its supervisor
  script reading the health watch's CPU counter.
"""

import importlib.util
import json
import os
import random
import signal
import subprocess
import sys
import time

import pytest

import test_fleetshard as REF_SHARD
import test_supervisor as REF_SUP
from test_torch_fleet import FIDS, run_on_port, reference_cases
from tpumon import _codec as JC
from tpumon import _poll as JPL
from tpumon import anomaly as JA
from tpumon import fleetpoll as JP
from tpumon import fleetshard as JF
from tpumon import supervisor as JSUP
from tpumon_torch import _codec as TC
from tpumon_torch import _poll as TPL
from tpumon_torch import agentsim as TS
from tpumon_torch import anomaly as TA
from tpumon_torch import fleetpoll as TP
from tpumon_torch import fleetshard as TF
from tpumon_torch import supervisor as TSUP

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _smoke_module():
    """``chip_smoke.py``, for its fleet processes' import guard (one
    source for the smoke and these tests; importing it starts nothing)."""

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


#: ``sitecustomize`` for the fleet processes: every import of ``tpumon``,
#: ``jax`` or ``torch`` is logged to ``$FLEET_IMPORT_LOG`` and fails
GUARD = _smoke_module().FLEET_GUARD


def import_guard(tmp_path, monkeypatch):
    """Put the guard on this process's ``PYTHONPATH`` (children inherit
    it) -> the log file refused imports land in."""

    d = tmp_path / "guard"
    d.mkdir()
    (d / "sitecustomize.py").write_text(GUARD)
    log = tmp_path / "refused.log"
    log.write_text("")
    path = os.environ.get("PYTHONPATH")
    monkeypatch.setenv("PYTHONPATH",
                       str(d) + (os.pathsep + path if path else ""))
    monkeypatch.setenv("FLEET_IMPORT_LOG", str(log))
    # the guard works: a child asking for one of them fails, and says so
    r = subprocess.run([sys.executable, "-c", "import json, jax"],
                       capture_output=True, text=True, timeout=60)
    assert r.returncode != 0 and "jax refused" in r.stderr, r.stderr
    assert log.read_text().split()[1:] == ["jax"]
    log.write_text("")
    return log


@pytest.fixture
def port_farm():
    f = TS.AgentFarm()
    yield f
    f.close()


def _fill(sim, chips, seed):
    sim.values = TS._bench_host_values(seed, chips, FIDS)


def _balanced(farm, tmp_path, hosts, shards, chips=2):
    """``hosts`` simulated agents on ``farm`` under socket names whose hash
    partition gives every one of ``shards`` shards the same number (the
    partition hashes the address; a shard with no host is a child with no
    targets, which exits) -> their addresses."""

    addrs, per = [], [0] * shards
    i = 0
    while len(addrs) < hosts:
        path = str(tmp_path / f"h{i}.sock")
        i += 1
        (b,) = [k for k, idx in enumerate(TF.partition_targets(
            [f"unix:{path}"], shards)) if idx]
        if per[b] < hosts // shards:
            per[b] += 1
            sim = TS.SimAgent()
            _fill(sim, chips, len(addrs))
            addrs.append(farm.add(sim, path))
    return addrs


def _same(a, b, ctx=""):
    assert [repr(s) for s in a] == [repr(s) for s in b], ctx


# -- the tree equals the flat view ------------------------------------------------

@pytest.mark.parametrize("shards", [2, 4])
def test_sharded_equals_flat(port_farm, shards):
    rng = random.Random(shards)
    sims = [TS.SimAgent(support_sweep_frame=(i != 3)) for i in range(12)]
    for i, s in enumerate(sims):
        _fill(s, 2, i)
    addrs = [port_farm.add(s) for s in sims]
    port_farm.start()
    flat_t = TP.FleetPoller(addrs, FIDS, timeout_s=5.0)
    flat_j = JP.FleetPoller(addrs, FIDS, timeout_s=5.0)
    tree = TF.ShardedFleet(addrs, FIDS, shards=shards, timeout_s=5.0)
    try:
        for step in range(6):
            for sim in sims:
                for _ in range(rng.randrange(0, 3)):
                    c = rng.randrange(2)
                    if sim.values.get(c) is not None:
                        sim.values[c][rng.choice(FIDS)] = rng.choice(
                            [None, rng.randrange(0, 999),
                             round(rng.uniform(0, 500), 3)])
            if step == 2:
                sims[5].values[1] = None               # chip lost
            if step == 4:
                tree.server.kill_connections(tree.shards[0].address)
                time.sleep(0.05)                       # a level-2 restart
            a, b, c = flat_t.poll(), flat_j.poll(), tree.poll()
            assert all(s.up for s in a), (step, a)
            _same(a, b, f"flat step={step}")
            _same(a, c, f"tree step={step}")
        assert len(tree.shard_stats()) == shards
    finally:
        tree.close()
        flat_t.close()
        flat_j.close()


# -- the mapping primitives and the metric lines equal the reference's ------------

def _random_sample(P, rng, i):
    if rng.random() < 0.2:
        return P.HostSample(address=f"unix:/h{i}.sock", up=False,
                            error=rng.choice(["", "connect: ENOENT"]))
    return P.HostSample(
        address=f"10.1.{i}.7:5555", up=True, chips=rng.randrange(0, 9),
        driver=rng.choice(["", "580.159.03"]),
        power_w=rng.choice([0.0, round(rng.uniform(0, 6000), 3)]),
        max_temp_c=rng.choice([None, rng.randrange(20, 99)]),
        mean_tc_util=rng.choice([None, rng.uniform(0, 100)]),
        mean_hbm_util=rng.choice([None, rng.uniform(0, 100)]),
        hbm_used_mib=rng.randrange(0, 1 << 20),
        hbm_total_mib=rng.randrange(0, 1 << 20),
        links_up=rng.randrange(0, 144), events=rng.randrange(0, 9),
        live_fields=rng.randrange(0, 99), dead_chips=rng.randrange(0, 3))


@pytest.mark.parametrize("seed", range(3))
def test_rows_and_partition_equal_the_reference(seed):
    rng = random.Random(seed)
    for i in range(40):
        state = rng.getstate()
        a = _random_sample(JP, rng, i)
        rng.setstate(state)
        b = _random_sample(TP, rng, i)
        ra, rb = JF.sample_to_row(a), TF.sample_to_row(b)
        assert repr(ra) == repr(rb)
        assert repr(TF.row_to_sample(rb)) == repr(JF.row_to_sample(ra)) \
            == repr(a)
        partial = {k: v for k, v in rb.items() if rng.random() < 0.5}
        assert repr(TF.row_to_sample(partial, "fallback")) == \
            repr(JF.row_to_sample(partial, "fallback"))
    targets = [f"host-{rng.randrange(1000)}:{rng.randrange(9000, 9100)}"
               for _ in range(rng.randrange(1, 300))]
    for shards in (0, 1, 2, 3, 4, 7, 16):
        assert TF.partition_targets(targets, shards) == \
            JF.partition_targets(targets, shards)
    assert TF.SHARD_FIELDS == JF.SHARD_FIELDS
    assert {k: v for k, v in vars(TF).items() if k.startswith("SF_")} == \
        {k: v for k, v in vars(JF).items() if k.startswith("SF_")}


@pytest.mark.parametrize("seed", range(3))
def test_metric_lines_equal_the_reference(seed, monkeypatch):
    # both packages on their Python planes: the codec and poll gauges read
    # which plane is loaded (the port's native ones are read in
    # tests/test_torch_codec_native.py and test_torch_fleet_native.py)
    for mod in (JC, JPL, TC, TPL):
        monkeypatch.setattr(mod, "lib", None)
    rng = random.Random(seed)
    stats = [{"shard": i, "hosts": rng.randrange(0, 4096),
              "up": rng.randrange(2), "ticks_total": rng.randrange(10**6),
              "tick_seconds": rng.uniform(0, 3),
              "hosts_down": rng.randrange(0, 9),
              "restarts_total": rng.randrange(0, 5),
              "parked": rng.randrange(2)} for i in range(rng.randrange(1, 9))]
    assert TF.shard_metric_lines(stats) == JF.shard_metric_lines(stats)
    assert TSUP.supervisor_metric_lines(stats) == \
        JSUP.supervisor_metric_lines(stats)
    assert TF.shard_metric_lines([]) == JF.shard_metric_lines([])


# -- the reference's own cases on the port ------------------------------------------

#: every case of ``tests/test_fleetshard.py``
SHARD_CASES = reference_cases(REF_SHARD, set())
#: the quick cases of ``tests/test_supervisor.py``; the two spawning whole
#: trees are held by :func:`test_supervised_sigkill_reconverges` below (the
#: reference's own SIGKILL case is one of the JAX package's known timing
#: failures under the parallel run, and its SIGSTOP case takes 12 s)
SUP_CASES = reference_cases(REF_SUP, {
    "test_supervised_tree_matches_flat_and_survives_sigkill",
    "test_sigstop_wedge_detected_by_tick_staleness_and_restarted"})


@pytest.mark.parametrize("case", SHARD_CASES)
def test_reference_shard_case_holds_on_the_port(case, port_farm, tmp_path,
                                                monkeypatch):
    run_on_port(REF_SHARD, case, monkeypatch, farm=port_farm,
                tmp_path=tmp_path)


@pytest.mark.parametrize("case", SUP_CASES)
def test_reference_supervisor_case_holds_on_the_port(case, port_farm,
                                                     tmp_path, monkeypatch):
    run_on_port(REF_SUP, case, monkeypatch, farm=port_farm,
                tmp_path=tmp_path)


# -- supervision --------------------------------------------------------------------

def _await(pred, deadline, msg):
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.05)
    raise AssertionError(f"not within the deadline: {msg}")


def test_supervised_sigkill_reconverges(port_farm, tmp_path, monkeypatch):
    refused = import_guard(tmp_path, monkeypatch)
    addrs = _balanced(port_farm, tmp_path, 8, 2)
    port_farm.start()
    flat = TP.FleetPoller(addrs, FIDS, timeout_s=2.0)
    sup = TSUP.ShardSupervisor(
        addrs, FIDS, shards=2, delay_s=0.05, timeout_s=2.0,
        health_interval_s=0.1, backoff_base_s=0.1, backoff_max_s=0.5,
        poller_backoff_base_s=0.1, poller_backoff_max_s=0.5)
    sup.start()
    deadline = time.monotonic() + 20.0

    def converged():
        a, b = flat.poll(), sup.poll()
        return repr(a) == repr(b) and all(s.up for s in b)

    try:
        _await(converged, deadline, "first converge")
        for c in sup.children:
            with open(f"/proc/{c.proc.pid}/cmdline", "rb") as f:
                argv = f.read().split(b"\0")
            assert argv[1:3] == [b"-m", b"tpumon_torch.cli.fleet"], argv
        victim = sup.children[1]
        os.kill(victim.proc.pid, signal.SIGKILL)
        _await(lambda: victim.restarts_total == 1, deadline, "respawn")
        _await(converged, deadline, "converge after the SIGKILL")
        lines = TSUP.supervisor_metric_lines(sup.shard_stats())
        assert 'tpumon_fleet_shard_restarts_total{shard="1"} 1' in lines
        assert 'tpumon_fleet_shard_restarts_total{shard="0"} 0' in lines
    finally:
        sup.close()
        flat.close()
    assert all(c.proc is None for c in sup.children)
    assert refused.read_text() == ""


def test_smoke_supervisor_script_reads_the_health_watch(port_farm, tmp_path,
                                                        monkeypatch):
    """The smoke's supervisor process (``FLEET_SUPERVISE``) over 8 hosts
    and 2 shards: every host up each tick, and the health watch's own CPU
    counter and passes read beside the process's CPU."""

    refused = import_guard(tmp_path, monkeypatch)
    addrs = _balanced(port_farm, tmp_path, 8, 2)
    port_farm.start()
    targets = tmp_path / "fleet.targets"
    targets.write_text("\n".join(addrs) + "\n")
    r = subprocess.run(
        [sys.executable, "-c", _smoke_module().FLEET_SUPERVISE,
         str(targets), "2", "2"], cwd=REPO, capture_output=True, text=True,
        timeout=90)
    assert r.returncode == 0, r.stderr[-2000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["up"] == [8, 8]
    assert out["health_passes"] >= 1
    assert 0.0 <= out["health_cpu_s"] <= out["cpu_s"]
    assert refused.read_text() == ""


def test_spawn_argv_names_the_port(tmp_path):
    """The children are the port's CLI with the reference's flags."""

    kw = dict(shards=2, delay_s=0.5, timeout_s=1.5,
              blackbox_dir=str(tmp_path / "bb"), blackbox_max_bytes=4096,
              poller_backoff_base_s=0.2, poller_backoff_max_s=3.0,
              spawn_fn=lambda c: subprocess.Popen(
                  [sys.executable, "-c", "import time; time.sleep(60)"]))
    port = TSUP.ShardSupervisor(["unix:/a.sock", "unix:/b.sock"], FIDS,
                                run_dir=str(tmp_path / "t"), **kw)
    ref = JSUP.ShardSupervisor(["unix:/a.sock", "unix:/b.sock"], FIDS,
                               run_dir=str(tmp_path / "t"), **kw)
    try:
        for c in port.children:
            got = port._spawn_argv(c)
            want = ref._spawn_argv(c)
            assert got[:3] == [sys.executable, "-m", "tpumon_torch.cli.fleet"]
            assert want[:3] == [sys.executable, "-m", "tpumon.cli.fleet"]
            assert got[3:] == want[3:]
            assert "--shard-serve-unix" in got and "--blackbox-dir" in got
    finally:
        port.close()
        ref.close()


# -- the anomaly plane knows the shard's fields ----------------------------------------

def test_rules_on_shard_fields_load_alike(tmp_path):
    rules = tmp_path / "fleet.yaml"
    rules.write_text(
        "version: 1\n"
        "detectors:\n"
        "  - name: host-down\n"
        "    type: threshold\n"
        "    field: SF_UP\n"
        "    below: 1\n"
        "    severity: critical\n")
    a, b = JA.load_rules(str(rules)), TA.load_rules(str(rules))
    assert repr(b) == repr(a)
    assert [d.fid for d in b.detectors] == [TF.SF_UP]
    assert TA.field_name(TF.SF_UP) == JA.field_name(JF.SF_UP) == "SF_UP"


def test_supervised_cli_serves_the_merged_metrics(port_farm, tmp_path,
                                                  monkeypatch):
    """``python -m tpumon_torch.cli.fleet --shards 2 --supervise
    --metrics-port P``, as operators run it: its tables come, and its
    ``/metrics`` carries the reference's merged shard families for both
    shards, and no other family."""

    import http.client
    import socket
    import threading

    refused = import_guard(tmp_path, monkeypatch)
    addrs = _balanced(port_farm, tmp_path, 4, 2)
    port_farm.start()
    targets = tmp_path / "targets"
    targets.write_text("\n".join(addrs) + "\n")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    err = tmp_path / "cli.err"
    with open(err, "w") as ef:
        cli = subprocess.Popen(
            [sys.executable, "-m", "tpumon_torch.cli.fleet",
             "--targets-file", str(targets), "--shards", "2", "--supervise",
             "--metrics-port", str(port), "-d", "0.2", "--backoff-base",
             "0.1"],
            stdout=subprocess.PIPE, stderr=ef, text=True, cwd=REPO)
    lines = []
    reader = threading.Thread(target=lambda: lines.extend(cli.stdout),
                              daemon=True)
    reader.start()
    try:
        deadline = time.monotonic() + 30.0

        def scrape():
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=5)
            try:
                conn.request("GET", "/metrics")
                return conn.getresponse().read().decode()
            except OSError:
                return ""
            finally:
                conn.close()

        body = ""
        while 'tpumon_fleet_shard_up{shard="1"} 1' not in body or \
                'tpumon_fleet_shard_up{shard="0"} 1' not in body:
            assert time.monotonic() < deadline, body
            time.sleep(0.1)
            body = scrape()
        names = {ln.split()[2] for ln in body.splitlines()
                 if ln.startswith("# TYPE")}
        want = {ln.split()[2] for ln in JSUP.supervisor_metric_lines(
            [{"shard": 0, "hosts": 0, "up": 0, "ticks_total": 0,
              "tick_seconds": 0.0, "hosts_down": 0}])
                if ln.startswith("# TYPE")}
        assert names == want
        while not any(ln.startswith("SLICE (4/4 up)") for ln in lines):
            assert time.monotonic() < deadline, lines[-12:]
            time.sleep(0.05)
    finally:
        cli.terminate()
        cli.wait(timeout=30)
        reader.join(timeout=10)
    assert cli.returncode == 0, err.read_text()[-2000:]
    assert refused.read_text() == ""
